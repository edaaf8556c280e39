"""Parity of the port's attention cache arms with the JAX package: the
rolling window cache (``window_cache``: a local layer keeps ``window``
slots, position p at slot p % window) and the int8 cache (``kv_quant``:
int8 K/V with float32 per-(b, h, position) scales).  The four tests of
``tests/test_optimizations.py`` on these arms, each held to JAX as well,
and gemma3-1b's smoke config with both arms on."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _lm_parity as lp
from repro.configs import registry as jreg
from repro.models import attention as jattn
from repro_torch.configs import registry as treg
from repro_torch.models import attention as tattn
from repro_torch.models import model as TM

# where the float32 projections differ in their last bits, an entry on a
# rounding edge of the int8 grid lands one step apart
INT8_OFF_BY_ONE_MAX = 0.002


def int8_close(got, want, what):
    """int8 leaves equal but for entries one step apart, at most
    INT8_OFF_BY_ONE_MAX of them; returns their count."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype == np.int8, what
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1, what
    n = int((diff == 1).sum())
    assert n <= INT8_OFF_BY_ONE_MAX * diff.size, (what, n, diff.size)
    return n


def caches_close(got, want, what):
    """Leaves of two caches: int8 as ``int8_close``, the rest to TOL."""
    for a, b in zip(got, want, strict=True):
        assert a.shape == b.shape and a.dtype == b.dtype, what
        if a.dtype == np.int8:
            int8_close(a, b, what)
        else:
            lp.close(a, b, lp.TOL, what)


def prefill_decode(jp, tp, jcfg, tcfg, toks, s, n_extra, s_max):
    """Prefill s tokens then decode n_extra in both packages: the decoded
    logits (B, n_extra, V) and the caches' leaves after the prefill and
    at the end."""
    last, jc, jl = lp.jit_prefill(jp, {"tokens": jnp.asarray(toks[:, :s])},
                                  jcfg, s_max)
    jcaches = [jax.tree_util.tree_leaves(jc)]
    with torch.no_grad():
        _, tc, tl = TM.prefill(tp, {"tokens": torch.from_numpy(
            toks[:, :s])}, tcfg, s_max)
        tcaches = [lp.leaves(tc, tcfg)]
        jout, tout = [], []
        for i in range(n_extra):
            jl, tl = jl + 1, tl + 1
            lg, jc = lp.jit_decode(jp, jnp.asarray(toks[:, s + i]), jc, jl,
                                   jcfg, None)
            jout.append(np.asarray(lg))
            lg, tc = TM.decode_step(tp, torch.from_numpy(toks[:, s + i]), tc,
                                    tl, tcfg)
            tout.append(lg.numpy().copy())
    jcaches.append(jax.tree_util.tree_leaves(jc))
    tcaches.append(lp.leaves(tc, tcfg))
    return (np.stack(jout, 1), np.stack(tout, 1),
            [[np.asarray(x) for x in c] for c in jcaches], tcaches, tc)


@pytest.fixture(scope="module")
def mixtral8():
    base = dataclasses.replace(jreg.smoke_config("mixtral-8x7b"), window=8)
    jp, _, tp = lp.carried(base, base)
    return base, jp, tp


def test_window_cache_decode_matches_full_cache(mixtral8):
    """The rolling cache reproduces the full cache's decode logits after
    the buffer wraps, in the port and against JAX's rolling decode."""
    base, jp, tp = mixtral8
    rng = np.random.RandomState(3)
    b, s, n_extra = 2, 12, 6
    toks = rng.randint(1, base.vocab_size, (b, s + n_extra)).astype(
        np.int32)
    outs = {}
    for wincache in (False, True):
        cfg = dataclasses.replace(base, window_cache=wincache)
        jout, tout, jc, tc, caches = prefill_decode(
            jp, tp, cfg, cfg, toks, s, n_extra, s + n_extra + 2)
        lp.close(tout, jout, lp.LOGIT_TOL, f"decode, window_cache "
                 f"{wincache}")
        for when in (0, 1):
            caches_close(tc[when], jc[when], f"caches {when}")
        if wincache:
            assert all(c["k"].shape[2] == cfg.window for c in caches)
        outs[wincache] = tout
    lp.close(outs[True], outs[False], lp.LOGIT_TOL, "rolling vs full")


def test_window_cache_matches_parallel_forward(mixtral8):
    base, jp, tp = mixtral8
    cfg = dataclasses.replace(base, window_cache=True)
    rng = np.random.RandomState(5)
    b, s = 2, 14
    toks = rng.randint(1, cfg.vocab_size, (b, s + 2)).astype(np.int32)
    jout, tout, *_ = prefill_decode(jp, tp, cfg, cfg, toks, s, 2, s + 4)
    full, _, _ = TM.forward(tp, {"tokens": torch.from_numpy(toks)}, cfg)
    lp.close(tout[:, -1], full[:, -1], lp.LOGIT_TOL, "vs the port's forward")
    lp.close(tout, jout, lp.LOGIT_TOL, "vs JAX")


def test_quantize_kv_matches_jax_op_for_op():
    """Equal float inputs give equal int8 and scales, ties on the grid
    (x / scale = k + 0.5) rounding half to even in both."""
    rng = np.random.RandomState(9)
    x = rng.randn(3, 2, 7, 32).astype(np.float32)
    x[0, 0, 0, :4] = [127.0, 0.5, 1.5, -2.5]        # scale 1: exact halves
    x[1, 1, 2] = 0.0                               # an all-zero row
    jq, js = jattn._quantize_kv(jnp.asarray(x))
    tq, ts = tattn.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq[0, 0, 0, :4].tolist() == [127, 0, 2, -2]
    np.testing.assert_array_equal(
        tattn.dequantize_kv(tq, ts, torch.float32).numpy(),
        np.asarray(jattn._dequantize_kv(jq, js, jnp.float32)))


def test_kv_quant_attention_layer_exactness():
    """The int8 cache at the attention layer: ~1% cache error, decode
    output within 0.01 of full precision, and the int8 cache, its scales
    and the decode output as JAX's."""
    cfg = treg.smoke_config("qwen3-1.7b")
    jp = jattn.init_attention(jax.random.PRNGKey(0), cfg)
    tl = tattn.Attention(cfg, "cpu")
    with torch.no_grad():
        for name, t in tl.named_parameters():
            t.copy_(torch.from_numpy(np.array(jp[name])))
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 10, cfg.d_model) * 0.3).astype(np.float32)
    x1 = (rng.randn(2, 1, cfg.d_model) * 0.3).astype(np.float32)
    lengths = np.full((2,), 11, np.int32)
    outs, caches = {}, {}
    for quant in (False, True):
        c = dataclasses.replace(cfg, kv_quant=quant)
        _, jc = jattn.apply_attention(jp, jnp.asarray(x), c, "global",
                                      return_cache=True, s_max=12)
        jo, jc = jattn.apply_attention_decode(
            jp, jnp.asarray(x1), c, "global", jc,
            lengths=jnp.asarray(lengths))
        _, tc = tattn.apply_attention(tl, torch.from_numpy(x), c, "global",
                                      return_cache=True, s_max=12)
        to, tc = tattn.apply_attention_decode(
            tl, torch.from_numpy(x1), c, "global", tc,
            lengths=torch.from_numpy(lengths))
        lp.close(to, jo, lp.TOL, f"decode out, kv_quant {quant}")
        assert sorted(tc) == sorted(jc)
        for name in tc:
            if tc[name].dtype == torch.int8:
                int8_close(tc[name].numpy(), jc[name], name)
            else:
                lp.close(tc[name], jc[name], lp.TOL, name)
        outs[quant], caches[quant] = to.numpy(), tc
    assert caches[True]["k"].dtype == torch.int8
    assert caches[True]["ks"].shape == (2, cfg.num_kv_heads, 12, 1)
    deq = caches[True]["k"].float() * caches[True]["ks"]
    assert float((deq - caches[False]["k"]).abs().max()) < 0.05
    np.testing.assert_allclose(outs[True], outs[False], atol=0.01)


def test_kv_quant_full_model_shallow():
    """2 layers: the int8 decode logits track full precision, and JAX's."""
    cfg = dataclasses.replace(jreg.smoke_config("qwen3-1.7b"), num_layers=2)
    jp, _, tp = lp.carried(cfg, cfg)
    rng = np.random.RandomState(7)
    b, s = 2, 12
    toks = rng.randint(1, cfg.vocab_size, (b, s + 3)).astype(np.int32)
    outs = {}
    for quant in (False, True):
        c = dataclasses.replace(cfg, kv_quant=quant)
        jout, tout, jc, tc, _ = prefill_decode(jp, tp, c, c, toks, s, 3,
                                               s + 4)
        lp.close(tout, jout, lp.LOGIT_TOL, f"decode, kv_quant {quant}")
        for when in (0, 1):
            caches_close(tc[when], jc[when], f"caches {when}")
        outs[quant] = tout[:, -1]
    corr = np.corrcoef(outs[True].ravel(), outs[False].ravel())[0, 1]
    assert corr > 0.98, corr
    np.testing.assert_allclose(outs[True], outs[False], atol=0.05)


@pytest.mark.parametrize("s", [5, 30])
def test_gemma3_rolling_int8_caches_match_jax(s):
    """gemma3-1b's smoke config (window 16) with both arms: its local
    layers keep 16 int8 slots, a prompt shorter and longer than the window,
    four decode steps past it, against JAX and the port's forward."""
    cfg = dataclasses.replace(jreg.smoke_config("gemma3-1b"),
                              window_cache=True, kv_quant=True)
    jp, _, tp = lp.carried(cfg, cfg, seed=2)
    toks = np.random.RandomState(s).randint(
        1, cfg.vocab_size, (2, s + 4)).astype(np.int32)
    s_max = s + 24
    jout, tout, jc, tc, caches = prefill_decode(jp, tp, cfg, cfg, toks, s, 4,
                                                s_max)
    lp.close(tout, jout, lp.LOGIT_TOL, "decoded logits")
    for when in (0, 1):
        caches_close(tc[when], jc[when], f"caches {when}")
    for i, c in enumerate(caches):
        local = cfg.layer_type(i) == "local"
        assert c["k"].shape[2] == (cfg.window if local else s_max)
        assert c["k"].dtype == torch.int8 and c["ks"].dtype == torch.float32
    full, _, _ = TM.forward(tp, {"tokens": torch.from_numpy(toks)}, cfg)
    # int8 caches: decode tracks the float forward as in the shallow test
    np.testing.assert_allclose(tout[:, -1], full[:, -1].numpy(), atol=0.05)
