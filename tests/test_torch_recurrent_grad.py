"""The recurrences' backward on the CPU: the port's plain backwards
(``wkv6_backward_reference``, ``rglru_backward_reference``), the plain
versions of the backward kernels, against ``jax.vjp`` of the JAX
package's wrappers on the same numpy inputs, and the autograd Functions
that join forward and backward (``WKV6Fn``, ``RGLRUFn``) by gradcheck.

Against the JAX scans (``impl="scan"``) each gradient is held within 1e-5
of its largest magnitude, at decays down to 0.01; against the chunked
forms, which the JAX model trains through, within 1e-4 at model-range
decays.  Below a decay of ~0.115 the chunked WKV6 form is wrong (ROADMAP
queue 3), so there the plain backward is held against autograd of the
float64 scan instead."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru import ops as jrg_ops
from repro.kernels.rwkv6 import ops as jwkv_ops
from repro_torch.kernels.rglru import ops as trg_ops
from repro_torch.kernels.rglru import ref as trg_ref
from repro_torch.kernels.rwkv6 import ops as twkv_ops
from repro_torch.kernels.rwkv6 import ref as twkv_ref

SCAN_REL = 1e-5
CHUNKED_REL = 1e-4
WKV_NAMES = ("dr", "dk", "dv", "dw", "du")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def scaled_close(got, want, rel, what):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()),
                               err_msg=what)


def wkv_case(seed, b, h, tt, n, w_lo, w_hi=0.999, with_ds=False):
    rng = np.random.RandomState(seed)
    r, k, v, do = (0.5 * rng.randn(b, h, tt, n).astype(np.float32)
                   for _ in range(4))
    w = rng.uniform(w_lo, w_hi, (b, h, tt, n)).astype(np.float32)
    u = (0.5 * rng.randn(h, n)).astype(np.float32)
    ds = (0.5 * rng.randn(b, h, n, n).astype(np.float32) if with_ds
          else None)
    return (r, k, v, w, u), do, ds


def jax_wkv_grads(args, do, ds, impl):
    def f(*xs):
        return jwkv_ops.wkv6(*xs, impl=impl)
    (_, s), vjp = jax.vjp(f, *(jnp.asarray(a) for a in args))
    ct = (jnp.asarray(do),
          jnp.zeros_like(s) if ds is None else jnp.asarray(ds))
    return [np.asarray(g) for g in vjp(ct)]


def port_wkv_grads(args, do, ds):
    t = [torch.from_numpy(a) for a in args]
    return twkv_ref.wkv6_backward_reference(
        *t, torch.from_numpy(do), None if ds is None else torch.from_numpy(ds))


WKV_SHAPES = [(2, 2, 64, 32), (1, 2, 64, 64), (2, 2, 1, 32)]


@pytest.mark.parametrize("with_ds", [False, True])
@pytest.mark.parametrize("shape", WKV_SHAPES)
def test_wkv6_backward_matches_jax_scan_at_every_decay(shape, with_ds):
    args, do, ds = wkv_case(sum(shape) + with_ds, *shape, w_lo=0.01,
                            with_ds=with_ds)
    got = port_wkv_grads(args, do, ds)
    want = jax_wkv_grads(args, do, ds, "scan")
    for name, g, w in zip(WKV_NAMES, got, want):
        assert g.dtype == torch.float32
        scaled_close(g, w, SCAN_REL, f"{name} {shape} ds={with_ds}")


@pytest.mark.parametrize("with_ds", [False, True])
@pytest.mark.parametrize("shape", WKV_SHAPES[:2])
def test_wkv6_backward_matches_jax_chunked_at_model_decays(shape, with_ds):
    """The form the JAX model trains through, at test_kernels.py's decays
    (0.6, 0.999).  (At T = 1, held against the scan above, dw is exactly
    0 and the chunked form's is its rounding, ~1e-7.)"""
    args, do, ds = wkv_case(7 + sum(shape) + with_ds, *shape, w_lo=0.6,
                            with_ds=with_ds)
    got = port_wkv_grads(args, do, ds)
    want = jax_wkv_grads(args, do, ds, "chunked")
    for name, g, w in zip(WKV_NAMES, got, want):
        scaled_close(g, w, CHUNKED_REL, f"{name} {shape} ds={with_ds}")


@pytest.mark.parametrize("with_ds", [False, True])
@pytest.mark.parametrize("shape", [(2, 2, 64, 32), (1, 2, 70, 64)])
def test_wkv6_backward_below_the_chunked_range_matches_float64_scan(
        shape, with_ds):
    """Decays in [0.01, 0.115], where the chunked form fails: the plain
    backward on float32 inputs against autograd of the float64 scan."""
    args, do, ds = wkv_case(11 + sum(shape), *shape, w_lo=0.01, w_hi=0.115,
                            with_ds=with_ds)
    got = port_wkv_grads(args, do, ds)
    xs = [torch.from_numpy(a).double().requires_grad_(True) for a in args]
    o, s = twkv_ref.wkv6_reference(*xs)
    loss = (o * torch.from_numpy(do).double()).sum()
    if ds is not None:
        loss = loss + (s * torch.from_numpy(ds).double()).sum()
    want = torch.autograd.grad(loss, xs)
    for name, g, w in zip(WKV_NAMES, got, want):
        scaled_close(g, w.numpy(), SCAN_REL, f"{name} {shape} ds={with_ds}")


def rglru_case(seed, b, tt, d, with_last):
    rng = np.random.RandomState(seed)
    a = rng.uniform(0.5, 0.999, (b, tt, d)).astype(np.float32)
    u, dh = (rng.randn(b, tt, d).astype(np.float32) for _ in range(2))
    last = rng.randn(b, d).astype(np.float32) if with_last else None
    return a, u, dh, last


# T = 1 against the scan only: there da is exactly 0 (h_0 = 0) and the
# chunked form's is its rounding, ~3e-7
@pytest.mark.parametrize("shape,impl,rel", [
    ((2, 64, 40), "scan", SCAN_REL), ((3, 1, 16), "scan", SCAN_REL),
    ((2, 64, 40), "chunked", CHUNKED_REL), ((2, 96, 24), "chunked",
                                            CHUNKED_REL)])
@pytest.mark.parametrize("with_last", [False, True])
def test_rglru_backward_matches_jax(shape, with_last, impl, rel):
    a, u, dh, last = rglru_case(sum(shape) + with_last, *shape, with_last)
    (_, hl), vjp = jax.vjp(lambda x, y: jrg_ops.rglru(x, y, impl=impl),
                           jnp.asarray(a), jnp.asarray(u))
    want = vjp((jnp.asarray(dh), jnp.zeros_like(hl) if last is None
                else jnp.asarray(last)))
    ta, tu = torch.from_numpy(a), torch.from_numpy(u)
    h, _ = trg_ref.rglru_reference(ta, tu)
    got = trg_ref.rglru_backward_reference(
        ta, h, torch.from_numpy(dh),
        None if last is None else torch.from_numpy(last))
    for name, g, w in zip(("da", "du"), got, want):
        assert g.dtype == torch.float32
        scaled_close(g, np.asarray(w), rel, f"{name} {shape} {impl}")


def test_wkv6_fn_passes_gradcheck():
    gen = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float64)
    r, k, v = (rnd(1, 2, 5, 4).requires_grad_(True) for _ in range(3))
    w = (0.01 + 0.98 * torch.rand((1, 2, 5, 4), generator=gen,
                                  dtype=torch.float64)).requires_grad_(True)
    u = rnd(2, 4).requires_grad_(True)
    assert torch.autograd.gradcheck(twkv_ops.WKV6Fn.apply, (r, k, v, w, u))
    # the output alone, and the final state alone
    assert torch.autograd.gradcheck(
        lambda *x: twkv_ops.wkv6(*x)[0], (r, k, v, w, u))
    assert torch.autograd.gradcheck(
        lambda *x: twkv_ops.wkv6(*x)[1], (r, k, v, w, u))


def test_rglru_fn_passes_gradcheck():
    gen = torch.Generator().manual_seed(1)
    a = (0.3 + 0.69 * torch.rand((2, 6, 3), generator=gen,
                                 dtype=torch.float64)).requires_grad_(True)
    u = torch.randn((2, 6, 3), generator=gen,
                    dtype=torch.float64).requires_grad_(True)
    assert torch.autograd.gradcheck(trg_ops.RGLRUFn.apply, (a, u))
    assert torch.autograd.gradcheck(lambda *x: trg_ops.rglru(*x)[0], (a, u))
    assert torch.autograd.gradcheck(lambda *x: trg_ops.rglru(*x)[1], (a, u))


def test_the_wrappers_save_nothing_without_grad():
    """Without a gradient to take, the wrappers run the forward alone
    (no autograd node); with one, they go through the Functions."""
    args, _, _ = wkv_case(3, 1, 2, 8, 32, 0.5)
    t = [torch.from_numpy(a) for a in args]
    o, s = twkv_ops.wkv6(*t)
    assert o.grad_fn is None and s.grad_fn is None
    t[0].requires_grad_(True)
    with torch.no_grad():
        assert twkv_ops.wkv6(*t)[0].grad_fn is None
    assert type(twkv_ops.wkv6(*t)[0].grad_fn).__name__ == "WKV6FnBackward"
    a, u, _, _ = rglru_case(4, 1, 8, 16, False)
    a, u = torch.from_numpy(a), torch.from_numpy(u)
    assert trg_ops.rglru(a, u)[0].grad_fn is None
    u.requires_grad_(True)
    assert type(trg_ops.rglru(a, u)[0].grad_fn).__name__ == "RGLRUFnBackward"


def test_rglru_backward_reads_the_rounded_h_in_bf16():
    """A bf16 a: the backward reads the forward's h as it was rounded to
    bf16, and its float32 arithmetic on it is what the kernel repeats."""
    a, u, dh, last = rglru_case(5, 2, 9, 8, True)
    ta, tu = (torch.from_numpy(x).bfloat16() for x in (a, u))
    h, _ = trg_ref.rglru_reference(ta, tu)
    assert h.dtype == torch.bfloat16
    da, du = trg_ref.rglru_backward_reference(ta, h, torch.from_numpy(dh),
                                              torch.from_numpy(last))
    assert da.dtype == du.dtype == torch.bfloat16
    g = torch.from_numpy(last)
    want_da, want_du = [], []
    for i in reversed(range(9)):
        g = torch.from_numpy(dh[:, i]) + (ta[:, i + 1].float() * g
                                          if i < 8 else g)
        want_du.append(g)
        want_da.append(g * (h[:, i - 1].float() if i else 0.0))
    assert torch.equal(du, torch.stack(want_du[::-1], 1).bfloat16())
    assert torch.equal(da, torch.stack(want_da[::-1], 1).bfloat16())
