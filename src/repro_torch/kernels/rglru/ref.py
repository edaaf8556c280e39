"""Plain PyTorch RG-LRU recurrence: the plain version of the RG-LRU kernel,
the scan the JAX package's ``rglru/ref.py`` computes, and the one-token
decode step of its ``rglru/ops.py``.

    h_t = a_t . h_{t-1} + u_t

a (B, T, D) in (0, 1) and u (B, T, D) (the layer's gated input).  Returns
h (B, T, D) in a's dtype and the final state (B, D).  The scan runs in
float32, or in float64 when a is float64.
"""
from __future__ import annotations

import torch


def rglru_reference(a, u, h0=None):
    b, t, d = a.shape
    ct = torch.float64 if a.dtype == torch.float64 else torch.float32
    af, uf = a.to(ct), u.to(ct)
    h = (torch.zeros((b, d), dtype=ct, device=a.device) if h0 is None
         else h0.to(ct))
    hs = []
    for i in range(t):
        h = af[:, i] * h + uf[:, i]
        hs.append(h)
    out = (torch.stack(hs, dim=1) if hs else
           torch.zeros((b, 0, d), dtype=ct, device=a.device))
    return out.to(a.dtype), h


def rglru_decode_step(a1, u1, h):
    """Single-token decode: a1, u1, h (B, D).  Returns (h in a1's dtype,
    h float32)."""
    h = a1.float() * h + u1.float()
    return h.to(a1.dtype), h
