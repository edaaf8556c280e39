"""The WKV6 backward's dw at every decay, on the CPU.

``wkv6_backward_reference`` gives dw_t = sum_m G_t S_{t-1} directly
(pass B recomputes each chunk's states from the one pass A kept), so it
holds where w dw = q - b, the identity it used before, cancelled: at
decays below ~1e-11 the identity's dw was off by 2.8e-5 of its scale, and
at decays in [1e-30, 1e-20] by orders of magnitude more.  Here it is held
against ``jax.vjp`` of the JAX package's scan at such decays, mixed with
channels in [0.9, 0.999], within 1e-5 of each gradient's largest
magnitude.

``wkv6_backward_chunked`` renders the backward kernel's chunk algebra in
plain PyTorch; it is held against the plain backward at chunks of 16 and
32 steps, T 1, a ragged last chunk and the same tiny decays: within 1e-5
of each gradient's scale in float32 (the sums of a chunk run in another
order than the step form's), 1e-12 in float64."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6 import ops as jwkv_ops
from repro_torch.kernels.rwkv6 import ref as twkv_ref

SCAN_REL = 1e-5
CHUNKED_REL = {torch.float32: 1e-5, torch.float64: 1e-12}
WKV_NAMES = ("dr", "dk", "dv", "dw", "du")
# the other half of the channels' decays: (lo, hi), drawn log-uniform
TINY = {"1e-12": (1e-12, 1e-10), "1e-30": (1e-30, 1e-20)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_case(seed, shape, tiny, with_ds):
    """Seeded float32 inputs: half the channels decay in [0.9, 0.999], the
    other half in ``tiny`` (log-uniform)."""
    rng = np.random.RandomState(seed)
    b, h, t, n = shape
    r, k, v, do = (0.5 * rng.randn(*shape).astype(np.float32)
                   for _ in range(4))
    w = rng.uniform(0.9, 0.999, shape)
    lo, hi = tiny
    w[..., n // 2:] = np.exp(rng.uniform(np.log(lo), np.log(hi),
                                         (b, h, t, n - n // 2)))
    u = (0.5 * rng.randn(h, n)).astype(np.float32)
    ds = (0.5 * rng.randn(b, h, n, n).astype(np.float32) if with_ds
          else None)
    return (r, k, v, w.astype(np.float32), u), do, ds


def scaled_err(got, want) -> float:
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    # dw at T 1 is 0 everywhere (S_0 = 0): any value there is an error
    scale = max(float(np.abs(want).max()), 1e-300)
    return float(np.abs(got - want).max()) / scale


def plain(args, do, ds, dtype=torch.float32):
    t = [torch.from_numpy(a).to(dtype) for a in args]
    return twkv_ref.wkv6_backward_reference(
        *t, torch.from_numpy(do).to(dtype),
        None if ds is None else torch.from_numpy(ds).to(dtype))


@pytest.mark.parametrize("with_ds", [False, True])
@pytest.mark.parametrize("tiny", sorted(TINY))
def test_plain_backward_holds_dw_at_tiny_decays(tiny, with_ds):
    args, do, ds = tiny_case(3 + with_ds, (1, 2, 40, 32), TINY[tiny],
                             with_ds)
    (_, s), vjp = jax.vjp(lambda *x: jwkv_ops.wkv6(*x, impl="scan"),
                          *(jnp.asarray(a) for a in args))
    want = vjp((jnp.asarray(do),
                jnp.zeros_like(s) if ds is None else jnp.asarray(ds)))
    got = plain(args, do, ds)
    for name, g, w in zip(WKV_NAMES, got, want):
        assert g.dtype == torch.float32
        err = scaled_err(g, w)
        assert err <= SCAN_REL, (name, tiny, with_ds, err)
    assert float(got[3][:, :, 0].abs().max()) == 0.0     # S_0 = 0


# (shape, the other channels' decays, with ds)
CHUNK_CASES = {
    "tiny_1e-12": ((1, 2, 40, 32), "1e-12", True),
    "tiny_1e-30": ((1, 2, 40, 32), "1e-30", False),
    "ragged": ((2, 1, 37, 64), "1e-30", True),
    "T1": ((2, 2, 1, 32), "1e-12", True),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_chunk_algebra_matches_the_plain_backward(case, chunk, dtype):
    shape, tiny, with_ds = CHUNK_CASES[case]
    args, do, ds = tiny_case(chunk + shape[2], shape, TINY[tiny], with_ds)
    want = plain(args, do, ds, torch.float64)
    t = [torch.from_numpy(a).to(dtype) for a in args]
    got = twkv_ref.wkv6_backward_chunked(
        *t, torch.from_numpy(do).to(dtype),
        None if ds is None else torch.from_numpy(ds).to(dtype), chunk=chunk)
    for name, g, w in zip(WKV_NAMES, got, want):
        assert g.dtype == dtype
        err = scaled_err(g, w.numpy())
        assert err <= CHUNKED_REL[dtype], (name, case, chunk, dtype, err)
    assert float(got[3][:, :, 0].abs().max()) == 0.0     # S_0 = 0
