"""Helpers for the LM parity tests between the JAX package and the port:
one model's parameters carried across by ``convert``, the same seeded
batch (``make_lm_batch`` of each package) through both, and every entry
point's results kept as numpy for the tests to compare.  The JAX entry
points are jitted once per process (the configs are static), so each
arch traces once."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.data import pipeline as jpipe
from repro.models import model as JM
from repro_torch import convert
from repro_torch.data import pipeline as tpipe
from repro_torch.models import model as TM

LOGIT_TOL = 2e-3     # the float32 tolerance of test_system.py
LOSS_TOL = 2e-4
TOL = 2e-5           # caches (float32)
B, S, EXTRA = 2, 12, 2   # batch, prompt, decode steps

jit_init = jax.jit(JM.init_params, static_argnums=(1,))
jit_forward = jax.jit(JM.forward, static_argnums=(2,))
jit_loss = jax.jit(JM.loss_fn, static_argnums=(2,))
jit_prefill = jax.jit(JM.prefill, static_argnums=(2, 3))
jit_decode = jax.jit(JM.decode_step, static_argnums=(4,))


def close(got, want, tol, what=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=what)


def leaves(caches, cfg):
    """The port's caches as the JAX layout's leaves, in its order (copies:
    decode writes the caches in place)."""
    return [np.array(x) for x in jax.tree_util.tree_leaves(
        convert.lm_cache_to_numpy(caches, cfg))]


def carried(jcfg, tcfg, seed=0):
    """JAX parameters from ``seed``, as numpy, and the port's copy."""
    jp = jit_init(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jp, tree, convert.lm_params_from_numpy(tree, tcfg, "cpu")


@dataclasses.dataclass
class Run:
    """One arch through both packages: forward and loss over S + EXTRA
    tokens, prefill of the first S, then EXTRA decode steps of the rest
    (the JAX and the port's results, numpy; the port's own forward rows
    at the decoded positions)."""
    jcfg: object
    tcfg: object
    tree: dict
    tp: object
    batch: dict
    n_front: int
    jax_out: dict
    port_out: dict


def run_arch(jcfg, tcfg, seed=0) -> Run:
    jp, tree, tp = carried(jcfg, tcfg, seed)
    jb = jpipe.make_lm_batch(jcfg, B, S + EXTRA, seed)
    tb = tpipe.make_lm_batch(tcfg, B, S + EXTRA, seed, device="cpu")
    n_front = jcfg.frontend_tokens if "patches" in jb else 0
    s_max = S + EXTRA + n_front + 2
    jprompt = {k: v for k, v in jb.items() if k in ("patches", "frames")}
    tprompt = {k: v for k, v in tb.items() if k in ("patches", "frames")}
    jprompt["tokens"], tprompt["tokens"] = jb["tokens"][:, :S], \
        tb["tokens"][:, :S]
    enc = S + EXTRA if jcfg.is_encdec else None

    jo = {}
    logits, _, aux = jit_forward(jp, jb, jcfg)
    jo["forward"], jo["forward_aux"] = np.asarray(logits), float(aux)
    loss, m = jit_loss(jp, jb, jcfg)
    jo["loss"], jo["ce"], jo["aux"] = float(loss), float(m["ce"]), \
        float(m["aux"])
    last, caches, lengths = jit_prefill(jp, jprompt, jcfg, s_max)
    jo["prefill"], jo["lengths"] = np.asarray(last), np.asarray(lengths)
    jo["caches"] = [np.asarray(x) for x in jax.tree_util.tree_leaves(caches)]
    jenc = None if enc is None else jnp.full((B,), enc, jnp.int32)
    jo["decoded"], jo["decode_caches"] = [], []
    for i in range(EXTRA):
        lengths = lengths + 1
        lg, caches = jit_decode(jp, jb["tokens"][:, S + i], caches, lengths,
                                jcfg, jenc)
        jo["decoded"].append(np.asarray(lg))
        jo["decode_caches"].append(
            [np.asarray(x) for x in jax.tree_util.tree_leaves(caches)])

    po = {}
    with torch.no_grad():
        logits, _, aux = TM.forward(tp, tb, tcfg)
        po["forward"], po["forward_aux"] = logits.numpy(), float(aux)
        loss, m = TM.loss_fn(tp, tb, tcfg)
        po["loss"], po["ce"], po["aux"] = float(loss), float(m["ce"]), \
            float(m["aux"])
        last, caches, lengths = TM.prefill(tp, tprompt, tcfg, s_max)
        po["prefill"], po["lengths"] = last.numpy(), lengths.numpy()
        po["caches"] = leaves(caches, tcfg)
        tenc = None if enc is None else torch.full((B,), enc,
                                                   dtype=torch.int32)
        po["decoded"], po["decode_caches"] = [], []
        for i in range(EXTRA):
            lengths = lengths + 1
            lg, caches = TM.decode_step(tp, tb["tokens"][:, S + i], caches,
                                        lengths, tcfg, enc_lengths=tenc)
            po["decoded"].append(lg.numpy().copy())
            po["decode_caches"].append(leaves(caches, tcfg))
    return Run(jcfg, tcfg, tree, tp, tb, n_front, jo, po)


# --- the per-arch checks each parity file parametrises -----------------------

def check_params(run: Run):
    """Every JAX leaf carried to its port parameter exactly."""
    named = dict(run.tp.named_parameters())
    flat = convert.lm_param_leaves(run.tree, run.tcfg)
    assert set(flat) == set(named)
    for name, a in flat.items():
        assert tuple(named[name].shape) == np.shape(a), name
        np.testing.assert_array_equal(named[name].numpy(),
                                      np.asarray(a, np.float32), name)


def check_forward(run: Run):
    j, p = run.jax_out, run.port_out
    b, s = run.batch["tokens"].shape
    assert p["forward"].shape == (b, s + run.n_front, run.tcfg.padded_vocab)
    assert np.isfinite(p["forward"]).all()
    close(p["forward"], j["forward"], LOGIT_TOL, "forward logits")
    close(p["forward_aux"], j["forward_aux"], LOSS_TOL, "forward aux")


def check_loss(run: Run):
    j, p = run.jax_out, run.port_out
    for key in ("ce", "aux", "loss"):
        close(p[key], j[key], LOSS_TOL, key)
    assert p["ce"] > 0 and (p["aux"] > 0) == run.tcfg.is_moe


def check_prefill_and_decode(run: Run):
    j, p = run.jax_out, run.port_out
    close(p["prefill"], j["prefill"], LOGIT_TOL, "prefill last logits")
    assert np.array_equal(p["lengths"], j["lengths"])
    assert p["lengths"][0] == S + run.n_front
    for a, b in zip(p["caches"], j["caches"], strict=True):
        assert a.shape == b.shape
        close(a, b, TOL, "prefill caches")
    for i in range(EXTRA):
        close(p["decoded"][i], j["decoded"][i], LOGIT_TOL,
              f"decode step {i}")
        for a, b in zip(p["decode_caches"][i], j["decode_caches"][i],
                        strict=True):
            close(a, b, TOL, f"caches after decode step {i}")


def check_decode_continues_forward(run: Run):
    """The port's prefill then decode gives its own forward's rows."""
    p = run.port_out
    for i in range(EXTRA):
        close(p["decoded"][i], p["forward"][:, run.n_front + S + i],
              LOGIT_TOL, f"decode step {i} vs the port's forward")


def jax_layer_specs(stack, n_layers: int, p_len: int):
    """Each layer's {leaf: (shape, dtype)} of a JAX ``{"groups", "rem"}``
    tree of arrays or ShapeDtypeStructs (the groups' leading axis
    dropped)."""
    out = [None] * n_layers
    n_groups = n_layers // p_len

    def spec(x, stacked):
        shape = tuple(x.shape[1:] if stacked else x.shape)
        return shape, str(np.dtype(x.dtype))

    for pos, tree in enumerate(stack["groups"] or []):
        for g in range(n_groups):
            out[g * p_len + pos] = {k: spec(v, True) for k, v in tree.items()}
    for i, tree in enumerate(stack["rem"]):
        out[n_groups * p_len + i] = {k: spec(v, False)
                                     for k, v in tree.items()}
    return out


def port_specs(tensors: dict) -> dict:
    return {k: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for k, t in tensors.items()}


def check_abstract(jcfg, tcfg, batch: int = 3, s_max: int = 16):
    """The port's meta-device parameters and cache against its concrete
    ones and against the JAX package's abstract trees, shapes and dtypes,
    at ``tcfg``'s size."""
    ab = TM.abstract_params(tcfg)
    assert all(t.device.type == "meta" for t in ab.parameters())
    want = {k: (tuple(np.shape(v)), str(np.asarray(v).dtype))
            for k, v in convert.lm_param_leaves(
                jax.tree_util.tree_map(
                    lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape),
                    JM.abstract_params(jcfg)), tcfg).items()}
    assert port_specs(dict(ab.named_parameters())) == want
    cache = TM.abstract_cache(tcfg, batch, s_max)
    jc = JM.abstract_cache(jcfg, batch, s_max)
    assert [port_specs(c) for c in cache] == jax_layer_specs(
        jc, tcfg.num_layers, tcfg.pattern_len)
    return ab, cache
