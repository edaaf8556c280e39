"""RWKV6 (Finch) block: time-mix with data-dependent decay, and
channel-mix.

The prefill's WKV recurrence runs the WKV6 kernel (its plain scan on the
CPU); decode runs the plain one-token step, as the JAX package does.  A
layer's decode cache is {'state' (B, H, N, N) float32, 'xtm' and 'xcm'
(B, 1, D)}: the O(1) "KV cache" of an attention-free arch.  Parameters
keep the JAX package's names, shapes, dtypes and init distributions.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed.sharding import shard
from ..kernels.rwkv6 import ops as wkv_ops
from . import layers

_DECAY_LORA = 64


class RWKV(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        d, n = cfg.d_model, cfg.rwkv_head_dim
        h = d // n
        dt = layers.dtype_of(cfg)
        f32 = torch.float32
        # token-shift mixing coefficients (r, k, v, w, g)
        self.mu = layers.param((5, d), dt, device)
        self.wr = layers.param((d, d), dt, device)
        self.wk = layers.param((d, d), dt, device)
        self.wv = layers.param((d, d), dt, device)
        self.wg = layers.param((d, d), dt, device)
        self.wo = layers.param((d, d), dt, device)
        # data-dependent decay: w = exp(-exp(w0 + tanh(x A) B))
        self.w0 = layers.param((d,), f32, device)
        self.wA = layers.param((d, _DECAY_LORA), dt, device)
        self.wB = layers.param((_DECAY_LORA, d), dt, device)
        self.u = layers.param((h, n), f32, device)
        self.ln_x = layers.param((d,), f32, device)
        # channel-mix
        self.mu_cm = layers.param((2, d), dt, device)
        self.ck = layers.param((d, cfg.d_ff), dt, device)
        self.cv = layers.param((cfg.d_ff, d), dt, device)
        self.cr = layers.param((d, d), dt, device)


def init_rwkv(p: RWKV, cfg, gen: torch.Generator) -> None:
    """The JAX package's ``init_rwkv`` distributions: mu ~ U(0.25, 0.75),
    w0 ~ N(-0.5, 0.5), wB ~ N(0, 0.01), u ~ N(0, 0.3), ln_x = 0, dense
    weights N(0, 1/d_in) (cv: 1/d_ff)."""
    layers.init_uniform(p.mu, gen, 0.25, 0.75)
    for w in (p.wr, p.wk, p.wv, p.wg, p.wo):
        layers.init_dense(w, gen)
    layers.init_normal(p.w0, gen, 0.5, -0.5)
    layers.init_dense(p.wA, gen)
    layers.init_normal(p.wB, gen, 0.01)
    layers.init_normal(p.u, gen, 0.3)
    p.ln_x.zero_()
    layers.init_uniform(p.mu_cm, gen, 0.25, 0.75)
    layers.init_dense(p.ck, gen)
    layers.init_dense(p.cv, gen, scale=cfg.d_ff ** -0.5)
    layers.init_dense(p.cr, gen)


def _shift(x, x_prev: Optional[torch.Tensor]):
    """Token shift: x_{t-1} (zeros, or the carried x_prev, at t = 0)."""
    if x_prev is None:
        x_prev = torch.zeros_like(x[:, :1])
    return torch.cat([x_prev, x[:, :-1]], dim=1)


def _decay(p: RWKV, xw):
    """exp(-exp(w0 + tanh(xw A) B)): the LoRA in the model dtype, then
    float32 from the add of w0 on."""
    lora = (torch.tanh(xw @ p.wA) @ p.wB).float()
    return torch.exp(-torch.exp(p.w0.float() + lora))


def _mix(x, xx, mu):
    return x * mu + xx * (1 - mu)


def time_mix_inputs(p: RWKV, x, cfg, x_prev=None):
    """What ``time_mix`` hands the WKV6 recurrence, r, k, v, w as (B, H,
    T, N) (w float32), and its output gate g (B, T, D)."""
    b, t, d = x.shape
    n = cfg.rwkv_head_dim
    h = d // n
    xx = _shift(x, x_prev)
    xr, xk, xv, xw, xg = (_mix(x, xx, p.mu[i]) for i in range(5))

    def heads(z):
        return z.reshape(b, t, h, n).transpose(1, 2)
    r, k, v = heads(xr @ p.wr), heads(xk @ p.wk), heads(xv @ p.wv)
    return r, k, v, heads(_decay(p, xw)), F.silu(xg @ p.wg)


def time_mix(p: RWKV, x, cfg, state=None, x_prev=None):
    """x: (B, T, D).  Returns (out, (new_state, new_x_prev)).  As in the
    JAX package, ``state`` is not read: the recurrence starts from zero."""
    b, t, d = x.shape
    r, k, v, w, g = time_mix_inputs(p, x, cfg, x_prev)
    r, k, v, w = (shard(z, "batch", "heads", None, None)
                  for z in (r, k, v, w))
    o, new_state = wkv_ops.wkv6(r, k, v, w, p.u)
    o = o.transpose(1, 2).reshape(b, t, d)
    o = layers.rms_norm(o, p.ln_x, cfg.norm_eps) * g
    return o @ p.wo, (new_state, x[:, -1:])


def time_mix_decode(p: RWKV, x, cfg, state, x_prev):
    """x: (B, 1, D); state: (B, H, N, N) float32; x_prev: (B, 1, D)."""
    b, _, d = x.shape
    n = cfg.rwkv_head_dim
    h = d // n
    xr, xk, xv, xw, xg = (_mix(x, x_prev, p.mu[i]) for i in range(5))
    r = (xr @ p.wr).reshape(b, h, n)
    k = (xk @ p.wk).reshape(b, h, n)
    v = (xv @ p.wv).reshape(b, h, n)
    w = _decay(p, xw).reshape(b, h, n)
    g = F.silu(xg @ p.wg)
    o, new_state = wkv_ops.wkv6_decode_step(r, k, v, w, p.u, state)
    o = o.reshape(b, 1, d)
    o = layers.rms_norm(o, p.ln_x, cfg.norm_eps) * g
    return (o @ p.wo).to(x.dtype), (new_state, x)


def channel_mix(p: RWKV, x, cfg, x_prev=None, decode: bool = False):
    """Returns (out, new_x_prev)."""
    xx = x_prev if decode else _shift(x, x_prev)
    xk = _mix(x, xx, p.mu_cm[0])
    xr = _mix(x, xx, p.mu_cm[1])
    kk = torch.square(torch.relu(xk @ p.ck))
    kk = shard(kk, "batch", None, "ff")
    out = torch.sigmoid(xr @ p.cr) * (kk @ p.cv)
    return out, x[:, -1:]
