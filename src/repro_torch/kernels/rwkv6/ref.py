"""Plain PyTorch WKV6 recurrence: the plain version of the WKV6 kernel, the
scan the JAX package's ``rwkv6/ref.py`` computes, and the one-token decode
step of its ``rwkv6/ops.py``.

Per head with key dim N and value dim M:
    o_t = r_t @ (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
r, k, w: (B, H, T, N); v: (B, H, T, M); u: (H, N); w in (0, 1).
Returns o: (B, H, T, M) in r's dtype and the final state (B, H, N, M).
The scan runs in float32, or in float64 when r is float64 (a
higher-precision oracle for the kernel).
"""
from __future__ import annotations

import torch


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def wkv6_reference(r, k, v, w, u, state0=None):
    b, h, t, n = r.shape
    m = v.shape[-1]
    ct = _compute_dtype(r)
    rf, kf, vf, wf = (x.to(ct) for x in (r, k, v, w))
    uf = u.to(ct)
    s = (torch.zeros((b, h, n, m), dtype=ct, device=r.device)
         if state0 is None else state0.to(ct))
    outs = []
    for i in range(t):
        kv = kf[:, :, i, :, None] * vf[:, :, i, None, :]   # (B, H, N, M)
        att = s + uf[None, :, :, None] * kv
        outs.append(torch.einsum("bhn,bhnm->bhm", rf[:, :, i], att))
        s = wf[:, :, i, :, None] * s + kv
    o = (torch.stack(outs, dim=2) if outs else
         torch.zeros((b, h, 0, m), dtype=ct, device=r.device))
    return o.to(r.dtype), s


def wkv6_decode_step(r1, k1, v1, w1, u, state):
    """Single-token decode: r1, k1, w1 (B, H, N); v1 (B, H, M); state
    (B, H, N, M) float32.  Returns (o (B, H, M) in r1's dtype, new
    state)."""
    rf, kf, vf, wf = (x.float() for x in (r1, k1, v1, w1))
    uf = u.float()
    kv = kf[..., :, None] * vf[..., None, :]
    att = state + uf[None, :, :, None] * kv
    o = torch.einsum("bhn,bhnm->bhm", rf, att)
    new_state = wf[..., :, None] * state + kv
    return o.to(r1.dtype), new_state
