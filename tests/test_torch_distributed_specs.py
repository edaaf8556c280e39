"""The port's sharding rules and specs against the JAX package's, with no
process group: every leaf of all ten archs' full-size parameters and AdamW
state (float32 and int8), their batches and caches, on the (16, 16) and
(2, 16, 16) production meshes under the baseline, ``ep`` and ``tpattn``
overrides; the rule table, the elastic plan, the microbatch pick and the
analysis formulas.  Every comparison is exact."""
import ast
from pathlib import Path

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro.configs import registry as jreg
from repro.distributed import fault as jfault
from repro.distributed import sharding as jsh
from repro.distributed import specs as jspecs
from repro.launch import analysis as janalysis
from repro.models import model as JM
from repro.train import optimizer as jopt
from repro_torch.configs import registry as treg
from repro_torch.distributed import fault as tfault
from repro_torch.distributed import sharding as tsh
from repro_torch.distributed import specs as tspecs
from repro_torch.launch import analysis as tanalysis
from repro_torch.launch import dryrun as tdryrun
from repro_torch.models import model as TM
from repro_torch.train import optimizer as topt

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
PROFILES = ("baseline", "ep", "tpattn")


def overrides(profile: str, multi_pod: bool) -> dict:
    """The rule overrides ``dryrun.build_cell`` sets for ``profile``
    (the batch override is the shape's and is tested with the batches)."""
    out = {}
    if multi_pod:
        out["long_seq"] = ("pod", "data", "model")
    if profile == "ep":
        out.update(experts="data", fsdp=None)
    if profile == "tpattn":
        out["heads"] = "model"
    return out


def jax_mesh(name):
    return AbstractMesh(*MESHES[name])


def port_mesh(name):
    shape, axes = MESHES[name]
    return dict(zip(axes, shape))


def jax_by_port_name(tree, stacks: dict):
    """A JAX spec tree flattened to the port's names: a leaf under a
    stack's ``groups[pos]`` gives each of its layers ``g * p_len + pos``
    the spec without its leading (group) entry; ``rem[i]`` is layer
    ``n_groups * p_len + i``; int8 moments' 'q' and 's' join the name."""
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
    )[0]:
        keys = [getattr(e, "key", getattr(e, "idx", None)) for e in path]
        if keys and keys[0] in stacks:
            stack, kind, i, rest = keys[0], keys[1], keys[2], keys[3:]
            n_layers, p_len = stacks[stack]
            n_groups = n_layers // p_len
            rest = ".".join(str(k) for k in rest)
            if kind == "groups":
                for g in range(n_groups):
                    out[f"{stack}.{g * p_len + i}.{rest}"] = tuple(spec)[1:]
            else:
                out[f"{stack}.{n_groups * p_len + i}.{rest}"] = tuple(spec)
        else:
            out[".".join(str(k) for k in keys)] = tuple(spec)
    return out


def port_flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(port_flat(v, name + "."))
        else:
            out[name] = tuple(v)
    return out


def stacks_of(cfg):
    out = {"decoder": (cfg.num_layers, cfg.pattern_len)}
    if cfg.is_encdec:
        out["encoder"] = (cfg.num_encoder_layers,
                          len(TM.ENCODER_PATTERN))
    return out


OPT_CONFIGS = {"float32": {}, "int8": dict(moments_dtype="int8",
                                           master=False)}


@pytest.mark.parametrize("arch", jreg.ARCHS)
def test_param_and_optimizer_specs_match_jax(arch):
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    jparams = JM.abstract_params(jcfg)
    tparams = TM.abstract_params(tcfg)
    jstate = {k: jopt.abstract_init(jparams, jopt.AdamWConfig(**kw))
              for k, kw in OPT_CONFIGS.items()}
    tstate = {k: topt.abstract_init(tparams, topt.AdamWConfig(**kw))
              for k, kw in OPT_CONFIGS.items()}
    stacks = stacks_of(tcfg)
    leaves = 0
    for mesh_name in MESHES:
        for profile in PROFILES:
            ov = overrides(profile, mesh_name == "pod2x16x16")
            jm, tm = jax_mesh(mesh_name), port_mesh(mesh_name)
            with jsh.use_mesh(jm, **ov) as jr, tsh.use_mesh(tm, **ov) as tr:
                assert tr == jr
                want = jax_by_port_name(
                    jspecs.param_specs(jparams, jm, jr), stacks)
                got = port_flat(tspecs.param_specs(tparams, tm, tr))
                assert got == want, (mesh_name, profile)
                leaves += len(got)
                for kind in OPT_CONFIGS:
                    js = jspecs.param_specs(jstate[kind], jm, jr)
                    ts = tspecs.param_specs(tstate[kind], tm, tr)
                    assert ts.step == tuple(js.step) == ()
                    for field in ("mu", "nu", "master"):
                        jf, tf = getattr(js, field), getattr(ts, field)
                        if jf is None:
                            assert tf is None
                            continue
                        assert port_flat(tf) == jax_by_port_name(
                            jf, stacks), (mesh_name, profile, kind, field)
    assert leaves > 0


def test_ep_param_specs_shard_experts():
    """The port's copy of ``test_ep_param_specs_shard_experts``: under the
    ep profile the expert tensors shard E over data, the shared expert
    and the dense weights keep no fsdp."""
    cfg = treg.get_config("mixtral-8x7b")
    mesh = {"data": 8, "model": 2}
    with tsh.use_mesh(mesh, experts="data", fsdp=None) as rules:
        specs = tspecs.param_specs(TM.abstract_params(cfg), mesh, rules)
    wg = specs["decoder.0.moe.w_gate"]
    assert wg == ("data", None, "model")
    assert specs["decoder.0.moe.w_down"] == ("data", "model", None)
    assert specs["decoder.0.attn.wq"][0] is None
    assert specs["decoder.0.moe.router"] == (None, None)


@pytest.mark.parametrize("mesh_name", MESHES)
def test_batch_and_cache_specs_match_jax(mesh_name):
    jm, tm = jax_mesh(mesh_name), port_mesh(mesh_name)
    multi_pod = mesh_name == "pod2x16x16"
    dp = tm.get("pod", 1) * tm["data"]
    checked = 0
    for arch in jreg.ARCHS:
        jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
        for shape, info in jreg.SHAPES.items():
            if not jreg.shape_supported(arch, shape)[0]:
                continue
            ov = overrides("baseline", multi_pod)
            if info["batch"] < dp:
                ov["batch"] = None
            with jsh.use_mesh(jm, **ov) as jr, tsh.use_mesh(tm, **ov) as tr:
                if info["kind"] != "decode":
                    jb = jreg.input_specs(jcfg, shape)["batch"]
                    tb = treg.input_specs(tcfg, shape)["batch"]
                    want = {k: tuple(v) for k, v in
                            jspecs.batch_specs(jb, jm, jr).items()}
                    assert tspecs.batch_specs(tb, tm, tr) == want
                    checked += 1
                    continue
                b, s = info["batch"], info["seq"]
                tc = TM.abstract_cache(tcfg, b, s)
                # JAX's cache specs of the port's per-layer leaves: the
                # JAX tree stacks a group's caches (5-D), which its rule
                # never shards (ROADMAP queue 3)
                jc = [{n: jax.ShapeDtypeStruct(tuple(t.shape), np.float32)
                       for n, t in layer.items()} for layer in tc]
                for long_ctx in (False, True):
                    want = jspecs.cache_specs(jc, jm, jr,
                                              long_context=long_ctx)
                    got = tspecs.cache_specs(tc, tm, tr,
                                             long_context=long_ctx)
                    assert got == [{n: tuple(p) for n, p in layer.items()}
                                   for layer in want]
                    checked += 1
    assert checked > 0


def test_default_rules_match_jax():
    for name in MESHES:
        assert tsh.default_rules(port_mesh(name)) == jsh.default_rules(
            jax_mesh(name))
    assert tsh.default_rules(None) == jsh.default_rules(None) == {}
    with tsh.use_mesh({"data": 4, "model": 2}, heads="model") as r, \
            jsh.use_mesh(AbstractMesh((4, 2), ("data", "model")),
                         heads="model"):
        got = tsh.spec("batch", None, "heads")
        assert got == tuple(jsh.spec("batch", None, "heads")) == (
            "data", None, "model")
        assert r["heads"] == "model"
    assert tsh.current() == (None, {})


@pytest.mark.parametrize("old,new,batch", [
    ({"data": 4, "model": 2}, {"data": 2, "model": 2}, 8),
    ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}, 256),
    ({"data": 16, "model": 16}, {"data": 12, "model": 16}, 256),
    ({"data": 8}, {"model": 4}, 3),
])
def test_remesh_plan_matches_jax(old, new, batch):
    assert tfault.remesh_plan(old, new, batch) == jfault.remesh_plan(
        old, new, batch)


def jax_function(path: Path, name: str):
    """A function of a JAX package module, compiled from its source alone:
    ``repro.launch.dryrun`` sets XLA_FLAGS when imported, which this
    process must not."""
    tree = ast.parse(path.read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == name)
    scope = {"np": np}
    exec(compile(ast.Module([fn], []), str(path), "exec"), scope)
    return scope[name]


jax_pick = jax_function(ROOT / "src" / "repro" / "launch" / "dryrun.py",
                        "pick_microbatches")


def test_pick_microbatches_matches_jax():
    for arch in jreg.ARCHS:
        jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
        for name in MESHES:
            jm, tm = jax_mesh(name), port_mesh(name)
            for seq, gb in ((4096, 256), (32768, 32), (4096, 8)):
                for budget in (2e9, 2e8):
                    assert tdryrun.pick_microbatches(
                        tcfg, seq, gb, tm, tsh.default_rules(tm), budget) \
                        == jax_pick(jcfg, seq, gb, jm, jsh.default_rules(jm),
                                    budget)


def test_model_flops_and_bytes_match_jax():
    for arch in jreg.ARCHS:
        jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
        for kind in ("train", "prefill", "decode"):
            for seq, gb in ((4096, 256), (32768, 128)):
                assert tanalysis.model_flops(tcfg, kind, seq, gb) == \
                    janalysis.model_flops(jcfg, kind, seq, gb)
                kw = dict(params_bytes=3.5e9, opt_bytes=1.25e10,
                          cache_bytes=7.0e8)
                assert tanalysis.model_bytes(tcfg, kind, seq, gb, **kw) == \
                    janalysis.model_bytes(jcfg, kind, seq, gb, **kw)


def test_roofline_terms_match_jax_at_the_ports_peaks(monkeypatch):
    """The formula alone: JAX's module constants set to the port's."""
    monkeypatch.setattr(janalysis, "PEAK_FLOPS", tanalysis.PEAK_FLOPS)
    monkeypatch.setattr(janalysis, "HBM_BW", tanalysis.HBM_BW)
    monkeypatch.setattr(janalysis, "ICI_BW", tanalysis.LINK_BW)
    for args in ((1e18, 1e15, 1e12, 256), (1e12, 1e15, 0.0, 8),
                 (0.0, 0.0, 0.0, 1), (3e15, 2e12, 9e13, 512)):
        assert tanalysis.roofline_terms(*args) == janalysis.roofline_terms(
            *args)
    assert tanalysis.PEAK_FLOPS != 197e12 and tanalysis.HBM_BW != 819e9


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard
    mesh = {"pod": 2, "data": 16, "model": 16}
    assert tsh.placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert tsh.placements((), mesh) == (Replicate(),) * 3
    assert tsh.placements((None, "data"), {"data": 4, "model": 2}) == (
        Shard(1), Replicate())
    assert tspecs.local_shape((256, 4096, 32), (("pod", "data"), None,
                                                 "model"), mesh) == (8, 4096,
                                                                     2)
