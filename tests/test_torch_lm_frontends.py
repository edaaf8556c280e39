"""Parity of the port's frontend archs with the JAX package at their smoke
configs — phi-3-vision (patch embeddings prepended) and seamless-m4t (the
audio frames through the encoder, cross-attention in every decoder
layer) — an attention layer at head dim 96 (phi-3-vision's), the abstract
shapes of every arch at full size, and the serve launcher on every arch."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _lm_parity as lp
from repro.configs import registry as jreg
from repro.kernels.flash_attention import ops as jfa
from repro.models import attention as jattn
from repro.models import model as JM
from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.kernels.flash_attention import ops as tfa
from repro_torch.launch import serve
from repro_torch.models import attention as tattn
from repro_torch.models import model as TM

ARCHS = ("phi-3-vision-4.2b", "seamless-m4t-medium")


@pytest.fixture(scope="module", params=ARCHS)
def run(request):
    return lp.run_arch(jreg.smoke_config(request.param),
                       treg.smoke_config(request.param))


def test_params_carry_over_exactly(run):
    lp.check_params(run)


def test_forward_matches_jax(run):
    lp.check_forward(run)


def test_loss_matches_jax(run):
    lp.check_loss(run)


def test_prefill_then_two_decode_steps_match_jax(run):
    lp.check_prefill_and_decode(run)


def test_decode_continues_the_ports_forward(run):
    lp.check_decode_continues_forward(run)


def test_frontend_positions_and_cross_caches(run):
    """Vision: the patches take the first positions, prefill's lengths
    count them and the loss slices them off; seamless: every decoder
    layer caches the encoder's K/V, which decode reads and never writes."""
    cfg, p = run.tcfg, run.port_out
    if cfg.frontend == "vision":
        assert run.n_front == cfg.frontend_tokens
        assert p["forward"].shape[1] == lp.S + lp.EXTRA + run.n_front
    else:
        assert run.n_front == 0 and cfg.cross_attention
        with torch.no_grad():
            _, caches, _ = TM.prefill(run.tp, {
                "tokens": run.batch["tokens"][:, :lp.S],
                "frames": run.batch["frames"]}, cfg, s_max=lp.S + 4)
        shape = (lp.B, cfg.num_kv_heads, lp.S + lp.EXTRA, cfg.head_dim)
        assert all(tuple(c["ck"].shape) == shape for c in caches)
        before = [c["ck"].clone() for c in caches]
        TM.decode_step(run.tp, run.batch["tokens"][:, lp.S], caches,
                       torch.full((lp.B,), lp.S + 1, dtype=torch.int32),
                       cfg, enc_lengths=torch.full((lp.B,), lp.S + lp.EXTRA,
                                                   dtype=torch.int32))
        assert all(torch.equal(b, c["ck"]) for b, c in zip(before, caches))


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_matches_concrete(arch):
    tcfg = treg.smoke_config(arch)
    ab, cache = lp.check_abstract(jreg.smoke_config(arch), tcfg)
    concrete = TM.init_params(tcfg, seed=1, device="cpu")
    assert lp.port_specs(dict(ab.named_parameters())) == lp.port_specs(
        dict(concrete.named_parameters()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_layer_at_head_dim_96(dtype):
    """phi-3-vision's head dim through an attention layer, prefill then a
    decode step, against JAX; and the flash kernel's plain version at
    D 96 against the Pallas kernel in interpret mode."""
    base = dataclasses.replace(treg.smoke_config("phi-3-vision-4.2b"),
                               head_dim=96)
    jcfg = dataclasses.replace(base, dtype=dtype)
    jp = jattn.init_attention(jax.random.PRNGKey(4), jcfg)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp)
    tdt = getattr(torch, dtype)
    tl = tattn.Attention(jcfg, "cpu")
    with torch.no_grad():
        for name, t in tl.named_parameters():
            t.copy_(torch.from_numpy(np.array(tree[name])).to(tdt))
    rng = np.random.RandomState(8)
    x = rng.randn(2, 11, base.d_model).astype(np.float32)
    jx = jnp.asarray(x, jcfg.dtype)
    tx = torch.from_numpy(np.array(jx, np.float32)).to(tdt)
    tol = 2e-5 if dtype == "float32" else 2e-2
    jo, jc = jattn.apply_attention(jp, jx[:, :10], jcfg, "global",
                                   return_cache=True, s_max=16)
    to, tc = tattn.apply_attention(tl, tx[:, :10], jcfg, "global",
                                   return_cache=True, s_max=16)
    assert tc["k"].shape == (2, base.num_kv_heads, 16, 96)
    lp.close(to, jo, tol, "prefill out")
    lp.close(tc["k"], jc["k"], tol, "cache k")
    lengths = np.asarray([11, 6], np.int32)
    jo, jc = jattn.apply_attention_decode(jp, jx[:, 10:], jcfg, "global", jc,
                                          lengths=jnp.asarray(lengths))
    to, tc = tattn.apply_attention_decode(tl, tx[:, 10:], jcfg, "global", tc,
                                          lengths=torch.from_numpy(lengths))
    lp.close(to, jo, tol, "decode out")
    lp.close(tc["v"], jc["v"], tol, "cache v after decode")
    q, k, v = (rng.randn(1, 4, 256, 96).astype(np.float32) for _ in range(3))
    want = jfa.flash_attention(
        *(jnp.asarray(a, jcfg.dtype) for a in (q, k, v)), impl="interpret",
        block_q=128, block_k=128)
    got = tfa.flash_attention(*(torch.from_numpy(a).to(tdt)
                                for a in (q, k, v)))
    lp.close(got, want, tol, "flash at D 96")
    # on the card bf16 takes the tensor-core kernel at D 96, float32 the
    # CUDA-core one
    assert tfa.variant(torch.bfloat16, 96) == "wgmma"
    assert tfa.variant(torch.float32, 96) == "fma"


def _spec(x):
    return tuple(x.shape), str(np.dtype(x.dtype)) if not isinstance(
        x, torch.Tensor) else str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", jreg.ARCHS)
def test_abstract_shapes_at_full_size(arch):
    """Every arch at its published size on the meta device: the parameters
    as the JAX package's ``abstract_params`` lays them out, and each
    cell's ``input_specs`` (decode caches included) as the JAX package's,
    with no storage."""
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    ab = TM.abstract_params(tcfg)
    views = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape),
        JM.abstract_params(jcfg))
    want = {k: _spec(v) for k, v in convert.lm_param_leaves(
        views, tcfg).items()}
    assert lp.port_specs(dict(ab.named_parameters())) == want
    assert all(t.is_meta for t in ab.parameters())
    for shape in jreg.SHAPES:
        js, ts = jreg.input_specs(jcfg, shape), treg.input_specs(tcfg, shape)
        assert js.keys() == ts.keys()
        for key in js:
            if key == "batch":
                assert {k: _spec(v) for k, v in ts[key].items()} == {
                    k: _spec(v) for k, v in js[key].items()}
            elif key == "caches":
                assert [lp.port_specs(c) for c in ts[key]] == \
                    lp.jax_layer_specs(js[key], tcfg.num_layers,
                                       tcfg.pattern_len)
                assert all(t.is_meta for c in ts[key] for t in c.values())
            elif js[key] is None or isinstance(js[key], (int, str)):
                assert ts[key] == js[key], key
            else:
                assert _spec(ts[key]) == _spec(js[key]), key


@pytest.mark.parametrize("arch", jreg.ARCHS)
def test_serve_launcher_runs_every_arch(arch, capsys):
    eng = serve.main(["--arch", arch, "--steps", "2", "--slots", "2"],
                     device="cpu")
    assert eng.stats["steps"] == 2 and eng.stats["tokens"] == 4
    assert (eng.enc_lengths is not None) == eng.cfg.is_encdec
    assert "[serve]" in capsys.readouterr().out
