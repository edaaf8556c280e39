"""Plain PyTorch RG-LRU recurrence: the plain version of the RG-LRU kernel,
the scan the JAX package's ``rglru/ref.py`` computes, and the one-token
decode step of its ``rglru/ops.py``.

    h_t = a_t . h_{t-1} + u_t

a (B, T, D) in (0, 1) and u (B, T, D) (the layer's gated input).  Returns
h (B, T, D) in a's dtype and the final state (B, D).  The scan runs in
float32, or in float64 when a is float64.

``rglru_backward_reference`` is the plain version of the RG-LRU backward
kernel (``csrc/rglru_bwd.cu``).
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


def rglru_backward_reference(a, h, dh, dh_last=None):
    """The gradients of :func:`rglru_reference` (from h_0 = 0) given the
    forward's output ``h`` (in a's dtype, as the forward returned it),
    dh = dL/dh (B, T, D) and optionally dh_last = dL/dh_T (B, D).  Walking
    time in reverse:
        g_T = dh_T + dh_last,  g_t = dh_t + a_{t+1} g_{t+1},
        du_t = g_t,  da_t = g_t h_{t-1}  (h_0 = 0),
    each multiply and add rounded on its own, as the kernel rounds them.
    Returns (da, du) in a's dtype; float32 arithmetic, or float64 when a
    is float64."""
    b, t, d = a.shape
    ct = torch.float64 if a.dtype == torch.float64 else torch.float32
    af, hf, dhf = a.to(ct), h.to(ct), dh.to(ct)
    carry = (torch.zeros((b, d), dtype=ct, device=a.device)
             if dh_last is None else dh_last.to(ct))
    da, du = torch.empty_like(af), torch.empty_like(af)
    for i in reversed(range(t)):
        g = dhf[:, i] + carry
        du[:, i] = g
        da[:, i] = g * hf[:, i - 1] if i else torch.zeros_like(g)
        carry = af[:, i] * g
    return da.to(a.dtype), du.to(a.dtype)
