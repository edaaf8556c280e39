"""Why the WKV6 backward takes dw directly: dw by the identity w_t dw_t =
q_t - b_t against dw_t = sum_m G_t S_{t-1}, both against the exact
gradient.

The identity (which the port's backward used until the chunked kernel)
cancels where a decay is small: q and b are of the size of G_t S_t, their
difference w_t times that.  This script runs the identity's two passes
with the states, row sums and q in float32 and in float64, and the direct
forms, ``kernels/rwkv6/ref.py::wkv6_backward_reference`` (float64 states)
and ``wkv6_backward_chunked`` (the kernel's chunk algebra, in float32), on
seeded inputs at the parity tests' shapes: decays uniform in [0.01, 0.999]
and in [0.01, 0.115], and half the channels in [0.9, 0.999] with the other
half log-uniform in [1e-12, 1e-10] or in [1e-30, 1e-20].  It prints each
one's worst dw error against autograd of the float64 scan, as a share of
dw's largest magnitude (the tests' measure; they hold the plain backward
within 1e-5 of it).  CPU only:

    PYTHONPATH=src python tools/wkv6_dw_precision.py
"""
from __future__ import annotations

import math
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.kernels.rwkv6 import ref  # noqa: E402

SHAPES = ((2, 2, 64, 32), (1, 2, 64, 64))
# (lowest, highest) decay: uniform, or (tiny) on half the channels,
# log-uniform, the rest in [0.9, 0.999]
DECAYS = ((0.01, 0.999, False), (0.01, 0.115, False),
          (1e-12, 1e-10, True), (1e-30, 1e-20, True))


def dw_by_identity(r, k, v, w, do, dtype):
    """dw of the identity's two passes with every state and sum in
    ``dtype``."""
    r, k, v, w, do = (x.to(dtype) for x in (r, k, v, w, do))
    b, h, t, n = r.shape
    s = torch.zeros((b, h, n, n), dtype=dtype)
    a = []
    for i in range(t):
        a.append(r[:, :, i] * (s * do[:, :, i, None, :]).sum(-1))
        s = w[:, :, i, :, None] * s + k[:, :, i, :, None] * v[:, :, i, None, :]
    g = torch.zeros_like(s)
    q = (g * s).sum(-1)
    dw = torch.zeros_like(w)
    for i in reversed(range(t)):
        bt = k[:, :, i] * (g * v[:, :, i, None, :]).sum(-1)
        if i:
            dw[:, :, i] = (q - bt) / w[:, :, i]
        q = q + a[i] - bt
        g = w[:, :, i, :, None] * g + r[:, :, i, :, None] * do[:, :, i,
                                                               None, :]
    return dw.double()


def decays(gen, shape, lo, hi, tiny):
    x = torch.rand(shape, generator=gen, dtype=torch.float64)
    if not tiny:
        return lo + (hi - lo) * x
    n = shape[-1]
    w = 0.9 + 0.099 * x
    w[..., n // 2:] = torch.exp(math.log(lo) + (math.log(hi) - math.log(lo))
                                * x[..., n // 2:])
    return w


def main() -> int:
    kinds = ("identity float32", "identity float64", "direct float64",
             "chunked float32")
    for shape in SHAPES:
        for lo, hi, tiny in DECAYS:
            worst = dict.fromkeys(kinds, 0.0)
            for seed in range(6):
                gen = torch.Generator().manual_seed(seed)
                r, k, v, do = (0.5 * torch.randn(shape, generator=gen,
                                                 dtype=torch.float64)
                               for _ in range(4))
                w = decays(gen, shape, lo, hi, tiny)
                u = 0.5 * torch.randn(shape[1], shape[3], generator=gen,
                                      dtype=torch.float64)
                xs = [x.clone().requires_grad_(True) for x in (r, k, v, w,
                                                               u)]
                o, _ = ref.wkv6_reference(*xs)
                want = torch.autograd.grad((o * do).sum(), xs[3])[0]
                scale = float(want.abs().max())
                got = {
                    kinds[0]: dw_by_identity(r, k, v, w, do, torch.float32),
                    kinds[1]: dw_by_identity(r, k, v, w, do, torch.float64),
                    kinds[2]: ref.wkv6_backward_reference(
                        r, k, v, w, u, do)[3],
                    kinds[3]: ref.wkv6_backward_chunked(
                        *(x.float() for x in (r, k, v, w, u, do)))[3]}
                for kind, dw in got.items():
                    err = float((dw.double() - want).abs().max()) / scale
                    worst[kind] = max(worst[kind], err)
            where = (f"half the channels in [{lo}, {hi}]" if tiny
                     else f"[{lo}, {hi}]")
            print(f"shape {shape}, decays {where}: worst dw error, of its "
                  f"largest magnitude, over 6 seeds: " + ", ".join(
                      f"{kind} {e:.3e}" for kind, e in worst.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
