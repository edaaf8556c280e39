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

``wkv6_backward_reference`` is the plain version of the WKV6 backward
kernel (``csrc/wkv6_bwd.cu``): the same two passes and the same identity
for dw, step by step.
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


def wkv6_backward_reference(r, k, v, w, u, do, ds=None):
    """The gradients of :func:`wkv6_reference` (from a zero state) given
    do = dL/do (B, H, T, M) and optionally ds = dL/dS_T (B, H, N, M).

    Two passes.  Pass A runs forward in time, recomputes S and gives
        dr_t = S_{t-1} do_t + u . k_t (v_t . do_t),
        a_t = r_t . (S_{t-1} do_t).
    Pass B runs backward in time with G_t = dL/dS_t (G_T = ds, else 0),
    G_{t-1} = diag(w_t) G_t + r_t^T do_t, and gives
        dk_t = G_t v_t + u . r_t (v_t . do_t),   b_t = k_t . (G_t v_t),
        dv_t = G_t^T k_t + (sum_n r_t u k_t) do_t,
        du = sum_{b,t} r_t . k_t (v_t . do_t).
    dw_t = sum_m G_t[:, m] S_{t-1}[:, m] would need S and G at one step;
    with q_t = sum_m G_t . S_t, carried as q_{t-1} = q_t - b_t + a_t from
    q_T = sum_m ds . S_T, it is w_t dw_t = q_t - b_t, which needs only the
    per-step vectors a_t and b_t (and dw_1 = 0, as S_0 = 0).

    w dw = q - b cancels where w is small (q and b are of the size of
    S_t G_t, their difference of w times that), and the rounding of the
    states enters both: in float32, decays down to 0.01 lose 2e-5 to 3e-5
    of dw's scale (``tools/wkv6_dw_precision.py``).  So the passes carry
    S, G, a, b and q in float64 whatever the inputs' type, as the kernel
    does.  Returns (dr, dk, dv in r's dtype, dw in w's dtype, du (H, N) in
    u's dtype)."""
    b, h, t, n = r.shape
    ct = torch.float64
    rf, kf, vf, wf, dof = (x.to(ct) for x in (r, k, v, w, do))
    uf = u.to(ct)[None]                                   # (1, H, N)
    vdo = (vf * dof).sum(-1)                              # (B, H, T)
    ruk = (rf * uf[:, :, None] * kf).sum(-1)              # (B, H, T)
    s = torch.zeros((b, h, n, n), dtype=ct, device=r.device)
    dr, a = torch.empty_like(rf), torch.empty_like(rf)
    for i in range(t):                                    # pass A
        sdo = (s * dof[:, :, i, None, :]).sum(-1)
        dr[:, :, i] = sdo + uf * kf[:, :, i] * vdo[:, :, i, None]
        a[:, :, i] = rf[:, :, i] * sdo
        s = wf[:, :, i, :, None] * s + kf[:, :, i, :, None] * vf[:, :, i,
                                                                None, :]
    g = (torch.zeros_like(s) if ds is None else ds.to(ct))
    q = (g * s).sum(-1)
    dk, dv, dw = (torch.empty_like(rf) for _ in range(3))
    for i in reversed(range(t)):                          # pass B
        gv = (g * vf[:, :, i, None, :]).sum(-1)
        dk[:, :, i] = gv + uf * rf[:, :, i] * vdo[:, :, i, None]
        dv[:, :, i] = ((g * kf[:, :, i, :, None]).sum(-2)
                       + ruk[:, :, i, None] * dof[:, :, i])
        bt = kf[:, :, i] * gv
        # S_0 = 0, so dw_1 is 0 exactly, where the identity would leave
        # the rounding of q - b
        dw[:, :, i] = (q - bt) / wf[:, :, i] if i else 0.0
        q = q + a[:, :, i] - bt
        g = wf[:, :, i, :, None] * g + rf[:, :, i, :, None] * dof[:, :, i,
                                                                  None, :]
    du = (rf * kf * vdo[..., None]).sum((0, 2))
    return (dr.to(r.dtype), dk.to(r.dtype), dv.to(r.dtype), dw.to(w.dtype),
            du.to(u.dtype))
