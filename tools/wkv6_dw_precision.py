"""Why the WKV6 backward carries its states in float64: dw by the
identity w_t dw_t = q_t - b_t in float32 against the exact gradient.

``kernels/rwkv6/ref.py::wkv6_backward_reference`` (and the kernel
``csrc/wkv6_bwd.cu``) get dw from the identity, which cancels where a
decay is small.  This script runs the same two passes with the states,
row sums and q in float32 and in float64 on seeded inputs at the parity
tests' shapes, decays uniform in [0.01, 0.999] and in [0.01, 0.115], and
prints each one's worst dw error against autograd of the float64 scan,
as a share of dw's largest magnitude (the tests' measure; they hold the
plain backward within 1e-5 of it).  CPU only:

    PYTHONPATH=src python tools/wkv6_dw_precision.py
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.kernels.rwkv6 import ref  # noqa: E402

SHAPES = ((2, 2, 64, 32), (1, 2, 64, 64))
DECAYS = ((0.01, 0.999), (0.01, 0.115))


def dw_by_identity(r, k, v, w, do, dtype):
    """dw of the two passes with every state and sum in ``dtype``."""
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


def main() -> int:
    for shape in SHAPES:
        for lo, hi in DECAYS:
            worst = {torch.float32: 0.0, torch.float64: 0.0}
            for seed in range(6):
                gen = torch.Generator().manual_seed(seed)
                r, k, v, do = (0.5 * torch.randn(shape, generator=gen,
                                                 dtype=torch.float64)
                               for _ in range(4))
                w = lo + (hi - lo) * torch.rand(shape, generator=gen,
                                                dtype=torch.float64)
                u = 0.5 * torch.randn(shape[1], shape[3], generator=gen,
                                      dtype=torch.float64)
                xs = [x.clone().requires_grad_(True) for x in (r, k, v, w,
                                                               u)]
                o, _ = ref.wkv6_reference(*xs)
                want = torch.autograd.grad((o * do).sum(), xs[3])[0]
                scale = float(want.abs().max())
                for dtype in worst:
                    err = float((dw_by_identity(r, k, v, w, do, dtype)
                                 - want).abs().max()) / scale
                    worst[dtype] = max(worst[dtype], err)
            print(f"shape {shape}, decays [{lo}, {hi}]: worst dw error, of "
                  f"its largest magnitude, over 6 seeds: float32 "
                  f"{worst[torch.float32]:.3e}, float64 "
                  f"{worst[torch.float64]:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
