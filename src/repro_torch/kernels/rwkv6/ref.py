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

``wkv6_backward_reference`` is the plain backward, step by step, and
``wkv6_backward_chunked`` the plain version of the WKV6 backward kernel
(``csrc/wkv6_bwd.cu``): the same gradients from the chunk algebra the
kernel computes.
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


# the steps between the states pass A of wkv6_backward_reference keeps
REF_CHUNK = 16


def wkv6_backward_reference(r, k, v, w, u, do, ds=None):
    """The gradients of :func:`wkv6_reference` (from a zero state) given
    do = dL/do (B, H, T, M) and optionally ds = dL/dS_T (B, H, N, M).

    Two passes, step by step.  Pass A runs forward in time, recomputes S,
    keeps it at the start of every REF_CHUNK steps and gives
        dr_t = S_{t-1} do_t + u . k_t (v_t . do_t).
    Pass B runs backward in time with G_t = dL/dS_t (G_T = ds, else 0),
    G_{t-1} = diag(w_t) G_t + r_t^T do_t.  For each run of REF_CHUNK
    steps, last first, it recomputes the run's states from the one kept
    and gives
        dk_t = G_t v_t + u . r_t (v_t . do_t),
        dv_t = G_t^T k_t + (sum_n r_t u k_t) do_t,
        dw_t = sum_m G_t[:, m] S_{t-1}[:, m]   (0 at t = 1: S_0 = 0),
        du = sum_{b,t} r_t . k_t (v_t . do_t).
    dw is the product itself, with no division by w, so it holds at any
    decay.  The passes carry S and G in float64 whatever the inputs'
    type: the oracle of the kernel.  Returns (dr, dk, dv in r's dtype, dw
    in w's dtype, du (H, N) in u's dtype)."""
    b, h, t, n = r.shape
    ct = torch.float64
    rf, kf, vf, wf, dof = (x.to(ct) for x in (r, k, v, w, do))
    uf = u.to(ct)[None]                                   # (1, H, N)
    vdo = (vf * dof).sum(-1)                              # (B, H, T)
    ruk = (rf * uf[:, :, None] * kf).sum(-1)              # (B, H, T)

    def step(s, i):
        return wf[:, :, i, :, None] * s + kf[:, :, i, :, None] * vf[:, :, i,
                                                                    None, :]
    s = torch.zeros((b, h, n, n), dtype=ct, device=r.device)
    kept, dr = [], torch.empty_like(rf)
    for i in range(t):                                    # pass A
        if i % REF_CHUNK == 0:
            kept.append(s)
        sdo = (s * dof[:, :, i, None, :]).sum(-1)
        dr[:, :, i] = sdo + uf * kf[:, :, i] * vdo[:, :, i, None]
        s = step(s, i)
    g = (torch.zeros_like(s) if ds is None else ds.to(ct))
    dk, dv, dw = (torch.empty_like(rf) for _ in range(3))
    for c in reversed(range(len(kept))):                  # pass B
        t0 = c * REF_CHUNK
        prev = [kept[c]]                                  # S_{i-1}
        for i in range(t0, min(t0 + REF_CHUNK, t) - 1):
            prev.append(step(prev[-1], i))
        for i in reversed(range(t0, t0 + len(prev))):
            gv = (g * vf[:, :, i, None, :]).sum(-1)
            dk[:, :, i] = gv + uf * rf[:, :, i] * vdo[:, :, i, None]
            dv[:, :, i] = ((g * kf[:, :, i, :, None]).sum(-2)
                           + ruk[:, :, i, None] * dof[:, :, i])
            dw[:, :, i] = (g * prev[i - t0]).sum(-1)
            g = wf[:, :, i, :, None] * g + rf[:, :, i, :, None] * dof[
                :, :, i, None, :]
    du = (rf * kf * vdo[..., None]).sum((0, 2))
    return (dr.to(r.dtype), dk.to(r.dtype), dv.to(r.dtype), dw.to(w.dtype),
            du.to(u.dtype))


def wkv6_backward_chunked(r, k, v, w, u, do, ds=None, chunk=16):
    """The gradients of :func:`wkv6_reference`, as
    :func:`wkv6_backward_reference` gives them, from the chunk algebra of
    the backward kernel, chunk by chunk in its order and in float32 (or
    float64 when r is float64).  For the tests, and to read the kernel by.

    Per (b, h) and channel n, over a chunk of C steps from t0, with
    Hd_t = prod_{t0<=j<t} w_j (e^{L_{t-1}}), Tl_t = prod_{t<j<t0+C} w_j
    (e^{L_end - L_t}), b(x, t) = prod_{t<j<x} w_j (t < x), S_prev the
    state before the chunk and G_end dL/dS at its last step:

        P_t = S_prev do_t,  Q_t = G_end v_t,  A[s][x] = v_s . do_x,
        Gamma = sum_m G_end . S_prev,  Zv_t = G_end^T (Tl_t k_t),
        Y_t[x] = sum_{s<t} b(t, s) k_s A[s][x]   (Y_{t+1} = w_t Y_t + k_t A_t),
        yq_t = sum_{s<t} b(t, s) k_s Q_s         (likewise),
        dr_t = Hd_t P_t + Y_t[t] + u k_t A[t][t],
        dk_t = Tl_t Q_t + sum_{x>t} b(x, t) r_x A[t][x] + u r_t A[t][t],
        dw_t = Hd_t Tl_t Gamma + Hd_t sum_{x>t} b(x, t) r_x P_x
               + Tl_t yq_t + sum_{x>t} b(x, t) r_x Y_t[x],
        M[t][x] = sum_n b(x, t) r_x k_t          (x > t),
        dv_t = Zv_t + sum_{x>t} M[t][x] do_x + (sum_n r_t u k_t) do_t,
        G_{t0-1} = Hd_{t0+C} G_end + sum_x (Hd_x r_x) do_x^T,
        S_next = Hd_{t0+C} S_prev + sum_s (Tl_s k_s) v_s^T.

    Every factor is a product of decays, none above 1, and no step
    divides by one, so dw holds at any decay (and is 0 at the first step,
    as S_0 = 0).  Pass A keeps S_prev of every chunk; pass B walks the
    chunks last first.  Returns what :func:`wkv6_backward_reference`
    returns."""
    b, h, t, n = r.shape
    ct = torch.float64 if r.dtype == torch.float64 else torch.float32
    rf, kf, vf, wf, dof = (x.to(ct) for x in (r, k, v, w, do))
    uf = u.to(ct)[None, :, None]                          # (1, H, 1, N)
    starts = range(0, t, chunk)

    def factors(c0):
        """Hd (B, H, C + 1, N) and Tl (B, H, C, N) of the chunk at c0."""
        ws = wf[:, :, c0:c0 + chunk]
        hd = [torch.ones_like(ws[:, :, 0])]
        for i in range(ws.shape[2]):
            hd.append(hd[-1] * ws[:, :, i])
        tl = [torch.ones_like(ws[:, :, 0])]
        for i in reversed(range(1, ws.shape[2])):
            tl.append(tl[-1] * ws[:, :, i])
        return torch.stack(hd, 2), torch.stack(tl[::-1], 2)

    s = torch.zeros((b, h, n, n), dtype=ct, device=r.device)
    kept = []
    for c0 in starts:                                     # pass A
        kept.append(s)
        hd, tl = factors(c0)
        s = hd[:, :, -1, :, None] * s + torch.einsum(
            "bhsn,bhsm->bhnm", tl * kf[:, :, c0:c0 + chunk],
            vf[:, :, c0:c0 + chunk])
    g = torch.zeros_like(s) if ds is None else ds.to(ct)
    dr, dk, dv, dw = (torch.empty_like(rf) for _ in range(4))
    du = torch.zeros_like(rf[:, :, 0])
    for c, c0 in reversed(list(enumerate(starts))):       # pass B
        sl = slice(c0, c0 + chunk)
        rc, kc, vc, wc, dc = (x[:, :, sl] for x in (rf, kf, vf, wf, dof))
        steps = rc.shape[2]
        hd, tl = factors(c0)
        sp = kept[c]
        p = torch.einsum("bhnm,bhtm->bhtn", sp, dc)
        q = torch.einsum("bhnm,bhtm->bhtn", g, vc)
        a = torch.einsum("bhsm,bhxm->bhsx", vc, dc)
        gamma = (g * sp).sum(-1)
        zv = torch.einsum("bhnm,bhtn->bhtm", g, tl * kc)
        ruk = (rc * uf * kc).sum(-1)
        y = torch.zeros_like(rc)                          # (B, H, C, N)
        yq = torch.zeros_like(gamma)
        m = torch.zeros((b, h, steps, steps), dtype=ct, device=r.device)
        for i in range(steps):
            diag = a[:, :, i, i, None]
            bx, dki, t2, t4 = (torch.ones_like(yq), torch.zeros_like(yq),
                               torch.zeros_like(yq), torch.zeros_like(yq))
            for x in range(i + 1, steps):
                tmp = bx * rc[:, :, x]
                dki = dki + tmp * a[:, :, i, x, None]
                t2 = t2 + tmp * p[:, :, x]
                t4 = t4 + tmp * y[:, :, x]
                m[:, :, i, x] = (tmp * kc[:, :, i]).sum(-1)
                bx = bx * wc[:, :, x]
            hdi, tli = hd[:, :, i], tl[:, :, i]
            dr[:, :, c0 + i] = (hdi * p[:, :, i] + y[:, :, i]
                                + uf[:, :, 0] * kc[:, :, i] * diag)
            dk[:, :, c0 + i] = (tli * q[:, :, i] + dki
                                + uf[:, :, 0] * rc[:, :, i] * diag)
            dw[:, :, c0 + i] = (hdi * tli * gamma + hdi * t2 + tli * yq
                                + t4)
            du = du + rc[:, :, i] * kc[:, :, i] * diag
            y[:, :, i + 1:] = (wc[:, :, i, None] * y[:, :, i + 1:]
                               + kc[:, :, i, None] * a[:, :, i, i + 1:, None])
            yq = wc[:, :, i] * yq + kc[:, :, i] * q[:, :, i]
        dv[:, :, sl] = (zv + torch.einsum("bhtx,bhxm->bhtm", m, dc)
                        + ruk[..., None] * dc)
        g = hd[:, :, -1, :, None] * g + torch.einsum(
            "bhxn,bhxm->bhnm", hd[:, :, :-1] * rc, dc)
    return (dr.to(r.dtype), dk.to(r.dtype), dv.to(r.dtype), dw.to(w.dtype),
            du.sum(0).to(u.dtype))
