"""Parity of the port's recurrences with the JAX package: the WKV6 and RG-LRU
wrappers (their plain scans on the CPU) against the JAX reference scans,
its Pallas kernels in interpret mode and its chunked forms, the one-token
decode steps chained over T, and the RWKV6 and Griffin layers module by
module at ``smoke_config`` of rwkv6-7b and recurrentgemma-9b (float32,
the JAX parameters carried across by ``convert``); Griffin's gates also in
bf16, against JAX and against an emulation of the port's roundings.

Tolerances: the recurrences at test_kernels.py's 5e-5 (float32), the
chained decode steps at its 1e-5, the modules at 2e-5 (test_torch_lm.py's
for qwen3's modules)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.kernels.rglru import ops as jrg_ops
from repro.kernels.rglru import ref as jrg_ref
from repro.kernels.rwkv6 import ops as jwkv_ops
from repro.kernels.rwkv6 import ref as jwkv_ref
from repro.models import griffin as jgriffin
from repro.models import model as JM
from repro.models import rwkv as jrwkv
from repro.models import transformer as jtrans
from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.kernels.rglru import ops as trg_ops
from repro_torch.kernels.rwkv6 import ops as twkv_ops
from repro_torch.models import griffin as tgriffin
from repro_torch.models import rwkv as trwkv
from repro_torch.models import transformer as ttrans

REC_TOL = 5e-5       # test_kernels.py's float32 tolerance
STEP_TOL = 1e-5      # test_kernels.py's chained decode steps
TOL = 2e-5           # per-module outputs (float32)


def close(got, want, tol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=tol,
                               rtol=tol, err_msg=what)


def t(a):
    return torch.from_numpy(np.asarray(a))


def wkv_inputs(seed, b, h, tt, n, w_lo, w_hi=0.999):
    rng = np.random.RandomState(seed)
    r, k, v = (0.5 * rng.randn(b, h, tt, n).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(w_lo, w_hi, (b, h, tt, n)).astype(np.float32)
    u = (0.5 * rng.randn(h, n)).astype(np.float32)
    return r, k, v, w, u


# --- WKV6 -------------------------------------------------------------------

@pytest.mark.parametrize("b,h,tt,n", [(2, 2, 64, 32), (1, 3, 20, 64)])
def test_wkv6_matches_jax_scan_kernel_and_chunked(b, h, tt, n):
    args = wkv_inputs(0, b, h, tt, n, 0.6)     # test_kernels.py's decays
    o, s = twkv_ops.wkv6(*(t(a) for a in args))
    assert o.dtype == torch.float32 and s.shape == (b, h, n, n)
    jargs = [jnp.asarray(a) for a in args]
    wants = {"scan": jwkv_ref.wkv6_reference(*jargs)}
    for impl in ("interpret", "chunked"):
        wants[impl] = jwkv_ops.wkv6(*jargs, impl=impl)
    for impl, (jo, js) in wants.items():
        close(o, jo, REC_TOL, f"o vs {impl}")
        close(s, js, REC_TOL, f"S vs {impl}")


def test_wkv6_matches_jax_scan_at_small_decays():
    # decays down to 0.01: the JAX chunked form's range ends near 0.115
    args = wkv_inputs(1, 2, 2, 70, 32, 0.01)
    o, s = twkv_ops.wkv6(*(t(a) for a in args))
    jo, js = jwkv_ref.wkv6_reference(*(jnp.asarray(a) for a in args))
    close(o, jo, REC_TOL, "o")
    close(s, js, REC_TOL, "S")


def test_wkv6_state0_and_decode_steps_continue_the_scan():
    r, k, v, w, u = (t(a) for a in wkv_inputs(2, 1, 2, 16, 32, 0.6))
    want_o, want_s = twkv_ops.wkv6(r, k, v, w, u)
    st = torch.zeros((1, 2, 32, 32))
    outs = []
    for i in range(16):
        o1, st = twkv_ops.wkv6_decode_step(r[:, :, i], k[:, :, i],
                                           v[:, :, i], w[:, :, i], u, st)
        outs.append(o1)
    close(torch.stack(outs, 2), want_o, STEP_TOL, "chained o")
    close(st, want_s, STEP_TOL, "chained S")
    # the scan from a carried state continues the first half's scan
    o_a, s_a = twkv_ops.wkv6(*(x[:, :, :9] for x in (r, k, v, w)), u)
    o_b, s_b = twkv_ops.wkv6_reference(*(x[:, :, 9:] for x in (r, k, v, w)),
                                       u, state0=s_a)
    close(torch.cat([o_a, o_b], 2), want_o, STEP_TOL, "split o")
    close(s_b, want_s, STEP_TOL, "split S")
    jo, js = jwkv_ref.wkv6_reference(
        *(jnp.asarray(x[:, :, 9:].numpy()) for x in (r, k, v, w)),
        jnp.asarray(u.numpy()), state0=jnp.asarray(s_a.numpy()))
    close(o_b, jo, REC_TOL, "state0 o vs JAX")
    close(s_b, js, REC_TOL, "state0 S vs JAX")


def test_reference_chunked_wkv6_fault_at_small_decay():
    """The JAX chunked WKV6 form (its Pallas kernel and its ``chunked``
    path) clamps a chunk's cumulative decay at 1e-30: one channel with
    w = 0.05 over a 32-step chunk (32 |log w| = 96 > 69) loses its
    k_t / W_t ratios and k_C v_C from the carried state.  The port computes
    the scan."""
    rng = np.random.RandomState(3)
    b, h, tt, n = 1, 1, 32, 32
    r, k, v = (rng.randn(b, h, tt, n).astype(np.float32) for _ in range(3))
    w = rng.uniform(0.6, 0.999, (b, h, tt, n)).astype(np.float32)
    w[..., 5] = 0.05
    u = (0.5 * rng.randn(h, n)).astype(np.float32)
    args = (r, k, v, w, u)
    jargs = [jnp.asarray(a) for a in args]
    want_o, want_s = jwkv_ref.wkv6_reference(*jargs)
    for impl in ("chunked", "interpret"):
        jo, js = jwkv_ops.wkv6(*jargs, impl=impl)
        assert np.abs(np.asarray(jo) - np.asarray(want_o)).max() > 1e-2, impl
        assert np.abs(np.asarray(js) - np.asarray(want_s)).max() > 1e-2, impl
    o, s = twkv_ops.wkv6(*(t(a) for a in args))
    close(o, want_o, REC_TOL, "port o")
    close(s, want_s, REC_TOL, "port S")


def test_reference_chunked_wkv6_fault_at_model_decays():
    """The same fault on decays drawn as ``init_rwkv`` draws them
    (w = exp(-exp(w0)), w0 ~ N(-0.5, 0.5) per channel, a small per-token
    change on top), against a float64 scan: a few of the 1,024 channels
    fall below the chunked form's range and its error is of the size of
    the outputs; the port's float32 scan stays within 5e-5."""
    rng = np.random.RandomState(8)
    b, h, tt, n = 1, 16, 128, 64
    r, k, v = (rng.randn(b, h, tt, n).astype(np.float32) for _ in range(3))
    w0 = rng.normal(-0.5, 0.5, (1, h, 1, n))
    w = np.exp(-np.exp(w0 + 0.05 * rng.randn(b, h, tt, n))).astype(
        np.float32)
    u = (0.3 * rng.randn(h, n)).astype(np.float32)
    assert (32 * np.abs(np.log(w)) > 69).any(axis=(0, 2)).sum() >= 3
    args = [t(a) for a in (r, k, v, w, u)]
    want_o, want_s = twkv_ops.wkv6_reference(*(a.double() for a in args))
    jo, js = jwkv_ops.wkv6(*(jnp.asarray(a) for a in (r, k, v, w, u)),
                           impl="chunked")
    assert np.abs(np.asarray(jo) - want_o.numpy()).max() > 0.1
    assert np.abs(np.asarray(js) - want_s.numpy()).max() > 0.1
    o, s = twkv_ops.wkv6(*args)
    close(o, want_o, REC_TOL, "port o vs float64")
    close(s, want_s, REC_TOL, "port S vs float64")


# --- RG-LRU -----------------------------------------------------------------

@pytest.mark.parametrize("b,tt,d", [(2, 64, 48), (1, 96, 130), (3, 20, 5)])
def test_rglru_matches_jax_scan_kernel_chunked_and_assoc(b, tt, d):
    rng = np.random.RandomState(4)
    a = rng.uniform(0.4, 0.999, (b, tt, d)).astype(np.float32)
    u = (0.5 * rng.randn(b, tt, d)).astype(np.float32)
    h, h_last = trg_ops.rglru(t(a), t(u))
    assert h.dtype == torch.float32 and h_last.shape == (b, d)
    ja, ju = jnp.asarray(a), jnp.asarray(u)
    wants = {"scan": jrg_ref.rglru_reference(ja, ju)}
    impls = ("interpret", "chunked", "assoc") if tt % 32 == 0 or tt <= 32 \
        else ("assoc",)
    for impl in impls:
        wants[impl] = jrg_ops.rglru(ja, ju, impl=impl)
    for impl, (jh, jl) in wants.items():
        close(h, jh, REC_TOL, f"h vs {impl}")
        close(h_last, jl, REC_TOL, f"final h vs {impl}")


def test_rglru_variant_table():
    # a row of D elements in whole 16-byte units goes to the ring kernel
    for d in (4, 64, 4096, 4100):
        assert trg_ops.variant(torch.float32, d) == "ring"
    for d in (8, 64, 4096):
        assert trg_ops.variant(torch.bfloat16, d) == "ring"
    for dtype, d in ((torch.float32, 1), (torch.float32, 4099),
                     (torch.bfloat16, 4100), (torch.bfloat16, 7)):
        assert trg_ops.variant(dtype, d) == "direct"
    # the recurrentgemma-9b prefill: float32 a and u at D 4,096
    cfg = treg.get_config("recurrentgemma-9b")
    assert trg_ops.variant(torch.float32, cfg.lru_width) == "ring"
    with pytest.raises(ValueError, match="no RG-LRU kernel"):
        trg_ops.variant(torch.float16, 64)
    # a CPU tensor takes the plain scan and counts no launch
    before = dict(trg_ops.launches)
    trg_ops.rglru(torch.rand(1, 3, 8), torch.rand(1, 3, 8))
    assert trg_ops.launches == before


def test_rglru_h0_and_decode_steps_continue_the_scan():
    rng = np.random.RandomState(5)
    a = t(rng.uniform(0.4, 0.999, (2, 16, 24)).astype(np.float32))
    u = t((0.5 * rng.randn(2, 16, 24)).astype(np.float32))
    want_h, want_last = trg_ops.rglru(a, u)
    h = torch.zeros((2, 24))
    outs = []
    for i in range(16):
        o1, h = trg_ops.rglru_decode_step(a[:, i], u[:, i], h)
        outs.append(o1)
    close(torch.stack(outs, 1), want_h, STEP_TOL, "chained h")
    close(h, want_last, STEP_TOL, "chained final h")
    h_a, last_a = trg_ops.rglru(a[:, :7], u[:, :7])
    h_b, last_b = trg_ops.rglru_reference(a[:, 7:], u[:, 7:], h0=last_a)
    close(torch.cat([h_a, h_b], 1), want_h, STEP_TOL, "split h")
    jh, jl = jrg_ref.rglru_reference(jnp.asarray(a[:, 7:].numpy()),
                                     jnp.asarray(u[:, 7:].numpy()),
                                     h0=jnp.asarray(last_a.numpy()))
    close(h_b, jh, REC_TOL, "h0 h vs JAX")
    close(last_b, jl, REC_TOL, "h0 final vs JAX")


# --- the layers -------------------------------------------------------------

def _setup(arch):
    jcfg, tcfg = jreg.smoke_config(arch), treg.smoke_config(arch)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                      tcfg, "cpu")
    rng = np.random.RandomState(6)
    x = rng.randn(2, 12, tcfg.d_model).astype(np.float32)
    return jcfg, tcfg, jp, tp, x, rng


@pytest.fixture(scope="module")
def rwkv_setup():
    return _setup("rwkv6-7b")


@pytest.fixture(scope="module")
def griffin_setup():
    return _setup("recurrentgemma-9b")


def layer(jp, pos=0):
    """Group 0's JAX params at pattern position ``pos``."""
    return jax.tree_util.tree_map(lambda a: a[0],
                                  jp["decoder"]["groups"][pos])


def test_time_mix_and_its_decode(rwkv_setup):
    jcfg, tcfg, jp, tp, x, rng = rwkv_setup
    jl, tl = layer(jp)["mix"], tp.decoder[0].mix
    jo, (js, jx) = jrwkv.time_mix(jl, jnp.asarray(x), jcfg)
    to, (ts, tx) = trwkv.time_mix(tl, t(x), tcfg)
    close(to, jo, TOL, "time_mix out")
    close(ts, js, TOL, "time_mix state")
    close(tx, jx, 0, "time_mix x_prev")
    h, n = tcfg.d_model // tcfg.rwkv_head_dim, tcfg.rwkv_head_dim
    state = rng.randn(2, h, n, n).astype(np.float32)
    x1, prev = x[:, :1], x[:, 5:6]
    jo, (js, jx) = jrwkv.time_mix_decode(jl, jnp.asarray(x1), jcfg,
                                         jnp.asarray(state),
                                         jnp.asarray(prev))
    to, (ts, tx) = trwkv.time_mix_decode(tl, t(x1), tcfg, t(state), t(prev))
    close(to, jo, TOL, "time_mix_decode out")
    close(ts, js, TOL, "time_mix_decode state")
    close(tx, jx, 0, "time_mix_decode x_prev")


def test_time_mix_bf16_states_match_jax():
    """In a bf16 model the WKV6 state stays float32: from the same bf16
    projections the port's prefill and decode states agree with JAX's at
    the float32 tolerance (a decay or a state rounded to bf16 is ~2^-9 of
    the state off); the bf16 outputs at test_kernels.py's 2e-2."""
    jcfg, tcfg = (dataclasses.replace(c.smoke_config("rwkv6-7b"),
                                      dtype="bfloat16") for c in (jreg, treg))
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                      tcfg, "cpu")
    jl, tl = layer(jp)["mix"], tp.decoder[0].mix
    rng = np.random.RandomState(6)
    x = rng.randn(2, 12, tcfg.d_model).astype(np.float32)
    jx, tx = jnp.asarray(x, jnp.bfloat16), t(x).bfloat16()
    jo, (js, _) = jrwkv.time_mix(jl, jx, jcfg)
    to, (ts, _) = trwkv.time_mix(tl, tx, tcfg)
    assert to.dtype == torch.bfloat16 and ts.dtype == torch.float32
    close(to.float(), np.asarray(jo, np.float32), 2e-2, "bf16 time_mix out")
    close(ts, js, TOL, "bf16 time_mix state")
    h, n = tcfg.d_model // tcfg.rwkv_head_dim, tcfg.rwkv_head_dim
    state = rng.randn(2, h, n, n).astype(np.float32)
    jo, (js, _) = jrwkv.time_mix_decode(jl, jx[:, :1], jcfg,
                                        jnp.asarray(state), jx[:, 5:6])
    to, (ts, _) = trwkv.time_mix_decode(tl, tx[:, :1], tcfg, t(state),
                                        tx[:, 5:6])
    assert to.dtype == torch.bfloat16 and ts.dtype == torch.float32
    close(to.float(), np.asarray(jo, np.float32), 2e-2,
          "bf16 time_mix_decode out")
    close(ts, js, TOL, "bf16 time_mix_decode state")


def test_channel_mix(rwkv_setup):
    jcfg, tcfg, jp, tp, x, _ = rwkv_setup
    jl, tl = layer(jp)["mix"], tp.decoder[0].mix
    jo, jx = jrwkv.channel_mix(jl, jnp.asarray(x), jcfg)
    to, tx = trwkv.channel_mix(tl, t(x), tcfg)
    close(to, jo, TOL, "channel_mix")
    close(tx, jx, 0, "channel_mix x_prev")
    jo, _ = jrwkv.channel_mix(jl, jnp.asarray(x[:, :1]), jcfg,
                              x_prev=jnp.asarray(x[:, 3:4]), decode=True)
    to, _ = trwkv.channel_mix(tl, t(x[:, :1]), tcfg, x_prev=t(x[:, 3:4]),
                              decode=True)
    close(to, jo, TOL, "channel_mix decode")


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_causal_conv(griffin_setup, dtype):
    jcfg, tcfg, jp, tp, x, rng = griffin_setup
    w = tcfg.lru_width
    xb = rng.randn(2, 7, w).astype(np.float32)
    conv = (0.1 * rng.randn(4, w)).astype(np.float32)
    state = rng.randn(2, 3, w).astype(np.float32)
    jdt = jnp.float32 if dtype is np.float32 else jnp.bfloat16
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    for st in (None, state):
        jo, jst = jgriffin._causal_conv(
            jnp.asarray(xb, jdt), jnp.asarray(conv, jdt),
            None if st is None else jnp.asarray(st, jdt))
        to, tst = tgriffin._causal_conv(
            t(xb).to(tdt), t(conv).to(tdt),
            None if st is None else t(st).to(tdt))
        assert to.dtype == tdt and tst.dtype == tdt
        close(to.float(), np.asarray(jo, np.float32), TOL, "conv out")
        close(tst.float(), np.asarray(jst, np.float32), 0, "conv state")


def test_gates(griffin_setup):
    jcfg, tcfg, jp, tp, x, rng = griffin_setup
    jl, tl = layer(jp)["rec"], tp.decoder[0].rec
    xc = rng.randn(2, 9, tcfg.lru_width).astype(np.float32)
    ja, ju = jgriffin._gates(jl, jnp.asarray(xc))
    ta, tu = tgriffin._gates(tl, t(xc))
    assert ta.dtype == tu.dtype == torch.float32
    close(ta, ja, TOL, "a")
    close(tu, ju, TOL, "u")
    assert float(ta.min()) > 0.86         # lam ~ U(-6, -4)


# --- Griffin's gates in bf16 -------------------------------------------------
#
# In a bf16 model the gates round twice: i and r, the sigmoids of the bf16
# matmuls, are bf16; log_a, a, mult and u are float32.  JAX evaluates the
# bf16 sigmoid with roundings of its own, so its i and r lie up to
# GATE_STEPS representable bf16 numbers from the port's (2 on these inputs);
# its a and u must then lie where the port's float32 formulas take i and r
# moved that far, give or take GATE_F32_SLACK for the float32 evaluation
# (exp, softplus, products: a few float32 ulps).  A fault of one more bf16
# rounding of log_a or of mult stays inside that band, so the port is also
# held, bit for bit, to an emulation of the roundings it means to make.

GATE_STEPS = 2
GATE_F32_SLACK = 4 * 2.0 ** -23


@dataclasses.dataclass
class _GateParams:
    """What ``_gates`` reads of a recurrent layer."""
    w_i: torch.Tensor
    w_r: torch.Tensor
    lam: torch.Tensor


def _bf16_gate_inputs(griffin_setup):
    """(JAX params, port params, JAX xc, port xc): layer 0's w_i and w_r
    cast to bf16 as a bf16 model holds them, lam float32, xc bf16."""
    jcfg, tcfg, jp, tp, x, rng = griffin_setup
    jl, tl = layer(jp)["rec"], tp.decoder[0].rec
    xc = rng.randn(3, 17, tcfg.lru_width).astype(np.float32)
    jparams = {"w_i": jl["w_i"].astype(jnp.bfloat16),
               "w_r": jl["w_r"].astype(jnp.bfloat16), "lam": jl["lam"]}
    tparams = _GateParams(w_i=tl.w_i.bfloat16(), w_r=tl.w_r.bfloat16(),
                          lam=tl.lam)
    return jparams, tparams, jnp.asarray(xc, jnp.bfloat16), \
        t(xc).bfloat16()


def _recorded(monkeypatch, module, name):
    """Calls of ``module.name`` from here on append their results to the
    returned list."""
    calls, fn = [], getattr(module, name)

    def record(*args):
        calls.append(fn(*args))
        return calls[-1]
    monkeypatch.setattr(module, name, record)
    return calls


def _bf16_steps(a, b):
    """How many representable bf16 numbers apart a and b (positive) are."""
    return (a.view(torch.int16).int() - b.view(torch.int16).int()).abs()


def _gates_after(p, i, r, xc):
    """The port's float32 part of the gates from bf16 i and r."""
    log_a = -8.0 * torch.nn.functional.softplus(p.lam.float()) * r.float()
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return torch.exp(log_a), mult * i.float() * xc.float()


def gates_emulation(p, xc):
    """The bf16 gates with the port's roundings made explicit: the port's
    own bf16 matmul outputs, their sigmoids evaluated in float32 and each
    rounded to bf16 once, then float32 arithmetic alone."""
    i = torch.sigmoid((xc @ p.w_i).float()).bfloat16()
    r = torch.sigmoid((xc @ p.w_r).float()).bfloat16()
    return _gates_after(p, i, r, xc)


def test_gates_bf16_match_jax_within_steps_of_i_and_r(griffin_setup,
                                                      monkeypatch):
    jparams, tparams, jxc, txc = _bf16_gate_inputs(griffin_setup)
    jsig = _recorded(monkeypatch, jax.nn, "sigmoid")
    ja, ju = jgriffin._gates(jparams, jxc)
    tsig = _recorded(monkeypatch, torch, "sigmoid")
    ta, tu = tgriffin._gates(tparams, txc)
    assert len(jsig) == len(tsig) == 2
    assert all(x.dtype == jnp.bfloat16 for x in jsig)
    assert all(x.dtype == torch.bfloat16 for x in tsig)
    assert ta.dtype == tu.dtype == torch.float32
    (ti, tr), (ji, jr) = tsig, (t(np.asarray(x, np.float32)).bfloat16()
                                for x in jsig)
    for name, got, want in (("i", ti, ji), ("r", tr, jr)):
        steps = _bf16_steps(got, want)
        assert int(steps.max()) <= GATE_STEPS, name
        assert float((steps > 0).float().mean()) > 0.05, name  # they differ
    # JAX's a and u inside the port's, evaluated with i and r moved up to
    # GATE_STEPS bf16 numbers either way (a falls in r; mult rises in r)
    monkeypatch.undo()
    corners = [_gates_after(tparams, (ti.view(torch.int16) + di).view(
        torch.bfloat16), (tr.view(torch.int16) + dr).view(torch.bfloat16),
        txc) for di in (-GATE_STEPS, GATE_STEPS)
        for dr in (-GATE_STEPS, GATE_STEPS)]
    for k, want in ((0, ja), (1, ju)):
        vals = torch.stack([c[k] for c in corners])
        lo, hi = vals.amin(0), vals.amax(0)
        slack = GATE_F32_SLACK * torch.maximum(lo.abs(), hi.abs())
        want = t(np.array(want))
        assert bool(((want >= lo - slack) & (want <= hi + slack)).all()), k


@pytest.mark.parametrize("fault", [None, "log_a", "mult"])
def test_gates_bf16_round_only_where_meant(griffin_setup, monkeypatch,
                                           fault):
    """The port's bf16 gates equal the emulation bit for bit; with one more
    bf16 rounding of log_a or of mult planted, the check rejects them."""
    _, tparams, _, txc = _bf16_gate_inputs(griffin_setup)
    want = gates_emulation(tparams, txc)
    exp, sqrt = torch.exp, torch.sqrt
    if fault == "log_a":      # log_a (and 2 log_a) rounded before exp
        monkeypatch.setattr(torch, "exp",
                            lambda x: exp(x.bfloat16().float()))
    elif fault == "mult":
        monkeypatch.setattr(torch, "sqrt",
                            lambda x: sqrt(x).bfloat16().float())
    got = tgriffin._gates(tparams, txc)
    monkeypatch.undo()
    same = [torch.equal(g, w) for g, w in zip(got, want, strict=True)]
    if fault is None:
        assert same == [True, True]
    else:                      # rejected: log_a feeds a and u, mult only u
        assert same == ([False, False] if fault == "log_a"
                        else [True, False])


def test_apply_recurrent_and_its_decode(griffin_setup):
    jcfg, tcfg, jp, tp, x, rng = griffin_setup
    jl, tl = layer(jp)["rec"], tp.decoder[0].rec
    jo, (jc, jh) = jgriffin.apply_recurrent(jl, jnp.asarray(x), jcfg)
    to, (tc, th) = tgriffin.apply_recurrent(tl, t(x), tcfg)
    close(to, jo, TOL, "out")
    close(tc, jc, TOL, "conv state")
    close(th, jh, TOL, "h")
    assert th.dtype == torch.float32
    conv = rng.randn(2, 3, tcfg.lru_width).astype(np.float32)
    h0 = rng.randn(2, tcfg.lru_width).astype(np.float32)
    jo, (jc, jh) = jgriffin.apply_recurrent_decode(
        jl, jnp.asarray(x[:, :1]), jcfg, jnp.asarray(conv), jnp.asarray(h0))
    to, (tc, th) = tgriffin.apply_recurrent_decode(tl, t(x[:, :1]), tcfg,
                                                   t(conv), t(h0))
    close(to, jo, TOL, "decode out")
    close(tc, jc, TOL, "decode conv state")
    close(th, jh, TOL, "decode h")


@pytest.mark.parametrize("arch,pos", [("rwkv6-7b", 0),
                                      ("recurrentgemma-9b", 0),
                                      ("recurrentgemma-9b", 2)])
def test_blocks_prefill_and_decode(rwkv_setup, griffin_setup, arch, pos):
    jcfg, tcfg, jp, tp, x, _ = (rwkv_setup if arch == "rwkv6-7b"
                                else griffin_setup)
    kind = tcfg.layer_type(pos)
    jl, tl = layer(jp, pos), tp.decoder[pos]
    assert tl.kind == kind
    jx, jc, _ = jtrans.apply_block(jl, jnp.asarray(x[:, :10]), jcfg, kind,
                                   return_cache=True, s_max=16)
    tx, tc, _ = ttrans.apply_block(tl, t(x[:, :10]), tcfg,
                                   return_cache=True, s_max=16)
    close(tx, jx, TOL, f"{kind} block")
    assert list(tc) == list(jc)
    for name in jc:
        close(tc[name], jc[name], TOL, f"{kind} cache {name}")
    lengths = np.asarray([11, 0], np.int32)    # row 1: an idle slot
    jx, jc = jtrans.apply_block_decode(jl, jnp.asarray(x[:, 10:11]), jcfg,
                                       kind, jc, lengths=jnp.asarray(lengths))
    tx, tc = ttrans.apply_block_decode(tl, t(x[:, 10:11]), tcfg, tc,
                                       lengths=t(lengths))
    close(tx, jx, TOL, f"{kind} block decode")
    for name in jc:
        close(tc[name], jc[name], TOL, f"{kind} decode cache {name}")
