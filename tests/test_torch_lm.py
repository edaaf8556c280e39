"""Parity of the port's LM stack with the JAX package at
``smoke_config("qwen3-1.7b")`` (2 layers, d 128, float32): the JAX
parameters carried across by ``convert``, the same seeded tokens through
both, module by module and for the whole prefill + decode path."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as JM
from repro.models import transformer as jtrans
from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model as TM
from repro_torch.models import transformer as ttrans

ARCH = "qwen3-1.7b"
LOGIT_TOL = 2e-3     # the float32 tolerance of test_system.py
TOL = 2e-5           # caches and per-module outputs (float32)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = jreg.smoke_config(ARCH), treg.smoke_config(ARCH)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tp = convert.lm_params_from_numpy(tree, tcfg, "cpu")
    rng = np.random.RandomState(2)
    toks = rng.randint(1, tcfg.vocab_size, (2, 12)).astype(np.int32)
    x = rng.randn(2, 12, tcfg.d_model).astype(np.float32)
    return jcfg, tcfg, jp, tree, tp, toks, x


def close(got, want, tol=TOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol,
                               err_msg=what)


def layer0(jp):
    """Layer 0's JAX params (group 0 of the stacked pattern position 0)."""
    return jax.tree_util.tree_map(lambda a: a[0], jp["decoder"]["groups"][0])


def test_configs_are_copies(setup):
    jcfg, tcfg = setup[:2]
    for name in jreg.ARCHS:
        assert vars(jreg.get_config(name)) == vars(treg.get_config(name))
        assert vars(jreg.smoke_config(name)) == vars(treg.smoke_config(name))
    assert treg.ARCHS == jreg.ARCHS and treg.SHAPES == jreg.SHAPES
    assert tcfg.total_params == jcfg.total_params


def test_params_carry_over_exactly(setup):
    *_, tree, tp, _, _ = setup
    close(tp.embed.embedding, tree["embed"]["embedding"], 0)
    for i, blk in enumerate(tp.decoder):
        g = tree["decoder"]["groups"][0]
        close(blk.attn.wq, g["attn"]["wq"][i], 0)
        close(blk.attn.k_norm, g["attn"]["k_norm"][i], 0)
        close(blk.ffn.w_down, g["ffn"]["w_down"][i], 0)


def test_rms_norm_rope_and_ffn(setup):
    jcfg, tcfg, jp, _, tp, _, x = setup
    gamma = np.random.RandomState(4).randn(tcfg.d_model).astype(np.float32)
    close(tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(gamma)),
          jlayers.rms_norm(jnp.asarray(x), jnp.asarray(gamma)))
    pos = np.asarray([[0, 5, 2047], [3, 4, 100]], np.int32)
    js, jc = jlayers.make_rope(jnp.asarray(pos), 32, 1e6)
    ts, tc = tlayers.make_rope(torch.from_numpy(pos), 32, 1e6)
    close(ts, js)
    close(tc, jc)
    h = np.random.RandomState(5).randn(2, 3, 4, 32).astype(np.float32)
    close(tlayers.apply_rope(torch.from_numpy(h), ts, tc),
          jlayers.apply_rope(jnp.asarray(h), js, jc))
    close(tlayers.apply_ffn(tp.decoder[0].ffn, torch.from_numpy(x), tcfg),
          jlayers.apply_ffn(layer0(jp)["ffn"], jnp.asarray(x), jcfg))


def test_attention_layer_prefill_and_decode(setup):
    jcfg, tcfg, jp, _, tp, _, x = setup
    jl = layer0(jp)["attn"]
    tl = tp.decoder[0].attn
    jo, jc = jattn.apply_attention(jl, jnp.asarray(x[:, :10]), jcfg,
                                   "global", return_cache=True, s_max=16)
    to, tc = tattn.apply_attention(tl, torch.from_numpy(x[:, :10]), tcfg,
                                   "global", return_cache=True, s_max=16)
    close(to, jo, what="prefill out")
    close(tc["k"], jc["k"], what="cache k")
    close(tc["v"], jc["v"], what="cache v")
    # decode the 11th position of row 0; row 1 is an idle slot (length 0)
    lengths = np.asarray([11, 0], np.int32)
    jo, jc = jattn.apply_attention_decode(
        jl, jnp.asarray(x[:, 10:11]), jcfg, "global", jc,
        lengths=jnp.asarray(lengths))
    to, tc = tattn.apply_attention_decode(
        tl, torch.from_numpy(x[:, 10:11]), tcfg, "global", tc,
        lengths=torch.from_numpy(lengths))
    close(to, jo, what="decode out")
    close(tc["k"], jc["k"], what="cache k after decode")
    close(tc["v"], jc["v"], what="cache v after decode")


def test_block(setup):
    jcfg, tcfg, jp, _, tp, _, x = setup
    jx, jc, _ = jtrans.apply_block(layer0(jp), jnp.asarray(x), jcfg,
                                   "global", return_cache=True, s_max=12)
    tx, tc, _ = ttrans.apply_block(tp.decoder[0], torch.from_numpy(x), tcfg,
                                   return_cache=True, s_max=12)
    close(tx, jx)
    close(tc["k"], jc["k"])


def test_forward_prefill_and_two_decode_steps(setup):
    jcfg, tcfg, jp, _, tp, toks, _ = setup
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks)
    jlog, _, _ = JM.forward(jp, {"tokens": jt}, jcfg)
    tlog, _, _ = TM.forward(tp, {"tokens": tt}, tcfg)
    close(tlog, jlog, LOGIT_TOL, "forward logits")

    jlast, jc, jlen = JM.prefill(jp, {"tokens": jt[:, :10]}, jcfg, s_max=16)
    tlast, tc, tlen = TM.prefill(tp, {"tokens": tt[:, :10]}, tcfg, s_max=16)
    close(tlast, jlast, LOGIT_TOL, "prefill last logits")
    assert np.array_equal(tlen.numpy(), np.asarray(jlen))

    def caches_close(what):
        got = convert.lm_cache_to_numpy(tc, tcfg)
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(jc), strict=True):
            close(a, b, what=what)

    caches_close("prefill caches")
    for i in (10, 11):
        jlen, tlen = jlen + 1, tlen + 1
        jlg, jc = JM.decode_step(jp, jt[:, i], jc, jlen, jcfg)
        tlg, tc = TM.decode_step(tp, tt[:, i], tc, tlen, tcfg)
        close(tlg, jlg, LOGIT_TOL, f"decode logits at {i}")
        caches_close(f"caches after decoding {i}")
        # prefill then decode continues the forward over the whole sequence
        close(tlg, tlog[:, i].numpy(), LOGIT_TOL, f"vs forward at {i}")


def test_cache_round_trip_is_exact(setup):
    jcfg, tcfg, jp, _, _, toks, _ = setup
    _, jc, _ = JM.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, s_max=16)
    tree = jax.tree_util.tree_map(np.asarray, jc)
    caches = convert.lm_cache_from_numpy(tree, tcfg, "cpu")
    assert len(caches) == tcfg.num_layers
    back = convert.lm_cache_to_numpy(caches, tcfg)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree), strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b)
