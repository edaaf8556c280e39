"""The recurrent serving paths on both packages: rwkv6-7b and
recurrentgemma-9b at ``smoke_config`` (float32), the JAX parameters
carried across by ``convert``, the same seeded tokens through ``forward``,
``prefill`` and two ``decode_step``s (the port's caches round-tripped
through ``convert`` first), and ``ServeEngine`` ticks through a host
crash, token by token.  RWKV6 is also held against JAX's scan path
(``attn_impl="scan"``) beside its default chunked one."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import model as JM
from repro.serve import ServeEngine as JaxEngine
from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.kernels.rglru import ops as trg_ops
from repro_torch.kernels.rwkv6 import ops as twkv_ops
from repro_torch.launch import serve as tlaunch
from repro_torch.models import model as TM
from repro_torch.serve import ServeEngine as TorchEngine

ARCHS = ("rwkv6-7b", "recurrentgemma-9b")
LOGIT_TOL = 2e-3     # the float32 tolerance of test_system.py
TOL = 2e-5           # caches (float32)


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    arch = request.param
    jcfg, tcfg = jreg.smoke_config(arch), treg.smoke_config(arch)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tp = convert.lm_params_from_numpy(tree, tcfg, "cpu")
    rng = np.random.RandomState(2)
    toks = rng.randint(1, tcfg.vocab_size, (2, 12)).astype(np.int32)
    return arch, jcfg, tcfg, jp, tp, toks


def close(got, want, tol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol,
                               err_msg=what)


def round_trip(caches, cfg):
    """The caches through ``convert`` and back: exact, dtypes kept."""
    back = convert.lm_cache_from_numpy(convert.lm_cache_to_numpy(caches, cfg),
                                       cfg, "cpu")
    for a, b in zip(caches, back, strict=True):
        assert list(a) == list(b)
        for name in a:
            assert b[name].dtype == a[name].dtype, name
            assert torch.equal(a[name], b[name]), name
    return back


def jax_configs(arch, jcfg):
    if arch == "rwkv6-7b":
        return {"chunked": jcfg,
                "scan": dataclasses.replace(jcfg, attn_impl="scan")}
    return {"chunked": jcfg}


def test_forward_prefill_and_two_decode_steps(setup):
    arch, jcfg, tcfg, jp, tp, toks = setup
    tt = torch.from_numpy(toks)
    tlog, _, _ = TM.forward(tp, {"tokens": tt}, tcfg)
    tlast, tc, tlen = TM.prefill(tp, {"tokens": tt[:, :10]}, tcfg, s_max=16)
    tc = round_trip(tc, tcfg)
    tsteps = []
    for i in (10, 11):
        tlen = tlen + 1
        tlg, tc = TM.decode_step(tp, tt[:, i], tc, tlen, tcfg)
        tsteps.append((tlg, convert.lm_cache_to_numpy(tc, tcfg)))
        # prefill then decode continues the forward over the whole sequence
        close(tlg, tlog[:, i].numpy(), LOGIT_TOL, f"vs forward at {i}")
        tc = round_trip(tc, tcfg)

    jt = jnp.asarray(toks)
    for impl, cfg in jax_configs(arch, jcfg).items():
        jlog, _, _ = JM.forward(jp, {"tokens": jt}, cfg)
        close(tlog, jlog, LOGIT_TOL, f"forward logits ({impl})")
        jlast, jc, jlen = JM.prefill(jp, {"tokens": jt[:, :10]}, cfg,
                                     s_max=16)
        close(tlast, jlast, LOGIT_TOL, f"prefill last logits ({impl})")
        assert np.array_equal(tlen.numpy() - 2, np.asarray(jlen))
        for i, (tlg, tcache) in zip((10, 11), tsteps):
            jlen = jlen + 1
            jlg, jc = JM.decode_step(jp, jt[:, i], jc, jlen, cfg)
            close(tlg, jlg, LOGIT_TOL, f"decode logits at {i} ({impl})")
            for a, b in zip(jax.tree_util.tree_leaves(tcache),
                            jax.tree_util.tree_leaves(jc), strict=True):
                close(a, b, TOL, f"caches after decoding {i} ({impl})")


def test_init_cache_matches_jax_abstract_cache(setup):
    _, jcfg, tcfg, *_ = setup
    want = JM.abstract_cache(jcfg, 3, 16)
    got = convert.lm_cache_to_numpy(TM.init_cache(tcfg, 3, 16, "cpu"), tcfg)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want), strict=True):
        assert a.shape == b.shape and not a.any()
    # in a bfloat16 model the recurrent states stay float32
    bf = dataclasses.replace(tcfg, dtype="bfloat16")
    for layer in TM.init_cache(bf, 2, 8, "cpu"):
        for name, t in layer.items():
            want_dt = torch.float32 if name in ("state", "h") else \
                torch.bfloat16
            assert t.dtype == want_dt, name


def test_cache_round_trip_is_exact(setup):
    """JAX's prefill caches through the port and back, bit for bit; and a
    bfloat16 model's caches through numpy and back, each leaf in its own
    dtype."""
    _, jcfg, tcfg, jp, _, toks = setup
    _, jc, _ = JM.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, s_max=16)
    tree = jax.tree_util.tree_map(np.asarray, jc)
    caches = convert.lm_cache_from_numpy(tree, tcfg, "cpu")
    assert len(caches) == tcfg.num_layers
    back = convert.lm_cache_to_numpy(caches, tcfg)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree), strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    bf = dataclasses.replace(tcfg, dtype="bfloat16")
    gen = torch.Generator().manual_seed(0)
    caches = TM.init_cache(bf, 2, 8, "cpu")
    for layer in caches:
        for t in layer.values():
            t.copy_(torch.randn(t.shape, generator=gen))
    round_trip(caches, bf)


# --- bfloat16, as the card serves ------------------------------------------
# The decode and forward paths run the same CPU kernels on each row, so in
# bf16 the port's decoded logits equal its forward's (0.0 for both archs
# here); a float32 recurrent state carried in bf16 between the steps, one
# rounding a step, moves them by more than twice the limit (the control).
BF16_STEP_TOL = 1e-2
# Against JAX the bf16 logits agree only to the bf16 rounding floor: the two
# round sigmoid, silu and gelu, and the recurrences' prefill paths,
# differently.  Both are held against float32 ``forward`` of the same
# weights: the port within WITNESS_K times JAX's own distance from it
# (chip_smoke.py's bf16 decode witness; read: 0.67 and 0.65 of it).
WITNESS_K = 2.0


@pytest.fixture(scope="module", params=ARCHS)
def bf16_setup(request):
    arch = request.param
    jcfg = dataclasses.replace(jreg.smoke_config(arch), dtype="bfloat16")
    tcfg = dataclasses.replace(treg.smoke_config(arch), dtype="bfloat16")
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tp = convert.lm_params_from_numpy(tree, tcfg, "cpu")
    fcfg = dataclasses.replace(tcfg, dtype="float32")
    tp32 = convert.lm_params_from_numpy(tree, fcfg, "cpu")
    rng = np.random.RandomState(2)
    toks = rng.randint(1, tcfg.vocab_size, (2, 16)).astype(np.int32)
    truth, _, _ = TM.forward(tp32, {"tokens": torch.from_numpy(toks)}, fcfg)
    return jcfg, tcfg, jp, tp, toks, truth.numpy()


def served_logits(model, params, toks, cfg, prompt, to_numpy):
    """The prefill's last logits, then those of each decode step over the
    rest of ``toks``: (B, S - prompt + 1, V) float32."""
    last, caches, lengths = model.prefill(params, {"tokens": toks[:, :prompt]},
                                          cfg, s_max=32)
    out = [last]
    for i in range(prompt, toks.shape[1] - 1):
        lengths = lengths + 1
        logits, caches = model.decode_step(params, toks[:, i], caches,
                                           lengths, cfg)
        out.append(logits)
    return np.stack([to_numpy(x) for x in out], 1)


def as_f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def test_bf16_decode_continues_forward(bf16_setup, monkeypatch):
    _, tcfg, _, tp, toks, _ = bf16_setup
    tt = torch.from_numpy(toks)
    full, _, _ = TM.forward(tp, {"tokens": tt}, tcfg)
    want = full[:, 9:15].float().numpy()
    got = served_logits(TM, tp, tt, tcfg, 10, lambda x: x.float().numpy())
    close(got, want, BF16_STEP_TOL, "bf16 prefill and decode vs bf16 forward")
    # the control: the recurrent state carried in bf16 between the steps
    for mod, name in ((twkv_ops, "wkv6_decode_step"),
                      (trg_ops, "rglru_decode_step")):
        def step(*args, fn=getattr(mod, name)):
            out, new = fn(*args)
            return out, new.bfloat16().float()
        monkeypatch.setattr(mod, name, step)
    bad = served_logits(TM, tp, tt, tcfg, 10, lambda x: x.float().numpy())
    assert np.abs(bad - want).max() > 2 * BF16_STEP_TOL


def test_bf16_prefill_and_decode_track_jax(bf16_setup):
    jcfg, tcfg, jp, tp, toks, truth = bf16_setup
    port = served_logits(TM, tp, torch.from_numpy(toks), tcfg, 10,
                         lambda x: x.float().numpy())
    jax_ = served_logits(JM, jp, jnp.asarray(toks), jcfg, 10, as_f32)
    truth = truth[:, 9:15]
    floor = np.abs(jax_ - truth).max()      # JAX's own bf16 rounding
    assert floor > 0
    assert np.abs(port - truth).max() <= WITNESS_K * floor
    assert np.abs(port - jax_).max() <= WITNESS_K * floor


def recording(engine, log, to_numpy):
    """Wrap the engine's serve step so that each tick's logits are kept."""
    serve = engine._serve

    def step(*args):
        logits, caches = serve(*args)
        log.append(to_numpy(logits))
        return logits, caches
    engine._serve = step


def test_serve_engines_agree_through_a_host_crash(setup):
    """Two requests in four slots, eight ticks, the host driver crashed at
    tick 4.  Every slot is stepped every tick (idle ones too, whose
    recurrent state advances as in the JAX engine)."""
    _, jcfg, tcfg, jp, tp, _ = setup
    kw = dict(s_max=48, n_slots=4, n_clients=2, rate_per_us=0.1, burst=3.0)
    je = JaxEngine(jcfg, jp, **kw)
    te = TorchEngine(tcfg, tp, device="cpu", **kw)
    jlog, tlog = [], []
    recording(je, jlog, np.asarray)
    recording(te, tlog, lambda t: t.numpy().copy())
    assert te.admit([0, 0, 1]) == je.admit([0, 0, 1]) == [True] * 3
    for eng in (je, te):
        eng.add_request(0, 0, 3)
        eng.add_request(1, 1, 5)
    for i in range(8):
        if i == 4:
            je.crash_host_driver()
            te.crash_host_driver()
        jt, tt = je.step(), te.step()
        assert tt.tolist() == jt.tolist(), f"tick {i}"
        np.testing.assert_allclose(tlog[-1], jlog[-1], atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL, err_msg=f"tick {i}")
    assert not te.host_alive() and te.stats == je.stats
    assert te.stats == dict(steps=8, tokens=16, throttled=0)
    assert np.array_equal(te.lengths.numpy(), np.asarray(je.lengths))
    for a, b in zip(jax.tree_util.tree_leaves(
            convert.lm_cache_to_numpy(te.caches, tcfg)),
            jax.tree_util.tree_leaves(je.caches), strict=True):
        close(a, b, TOL, "engine caches")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_on_the_cpu(arch, capsys):
    eng = tlaunch.main(["--arch", arch, "--steps", "4", "--slots", "2",
                        "--crash-host"], device="cpu")
    assert "host driver crashed at step 2" in capsys.readouterr().out
    assert eng.stats == dict(steps=4, tokens=8, throttled=0)
    assert not eng.host_alive()
