"""Griffin / RecurrentGemma recurrent block: a gated branch, a causal
depthwise conv1d (width 4) and the RG-LRU, interleaved with local
attention in the stack.

The prefill's recurrence runs the RG-LRU kernel (its plain scan on the
CPU); decode runs the plain one-token step, as the JAX package does.  A
layer's decode cache is {'conv' (B, 3, W) in the model dtype, 'h' (B, W)
float32}.  Parameters keep the JAX package's names, shapes, dtypes and
init distributions.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..kernels.rglru import ops as rg_ops
from . import layers

_CONV_WIDTH = 4
_LRU_C = 8.0


class Recurrent(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        d, w = cfg.d_model, cfg.lru_width or cfg.d_model
        dt = layers.dtype_of(cfg)
        self.w_x = layers.param((d, w), dt, device)
        self.w_gate = layers.param((d, w), dt, device)
        self.conv = layers.param((_CONV_WIDTH, w), dt, device)
        self.lam = layers.param((w,), torch.float32, device)
        self.w_i = layers.param((w, w), dt, device)
        self.w_r = layers.param((w, w), dt, device)
        self.w_out = layers.param((w, d), dt, device)


def init_recurrent(p: Recurrent, cfg, gen: torch.Generator) -> None:
    """The JAX package's ``init_recurrent`` distributions: lam ~ U(-6, -4)
    (so a = exp(-8 softplus(lam) r) stays above ~0.86), conv ~ N(0, 0.1),
    w_i and w_r N(0, 0.02^2), w_out N(0, 1/W), w_x and w_gate N(0, 1/d)."""
    layers.init_uniform(p.lam, gen, -6.0, -4.0)
    layers.init_dense(p.w_x, gen)
    layers.init_dense(p.w_gate, gen)
    layers.init_normal(p.conv, gen, 0.1)
    layers.init_dense(p.w_i, gen, scale=0.02)
    layers.init_dense(p.w_r, gen, scale=0.02)
    layers.init_dense(p.w_out, gen, scale=p.lam.shape[0] ** -0.5)


def _causal_conv(x, conv, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d (width 4). x: (B, T, W); state: (B, 3, W).
    The four products are summed in the model dtype, in order, from 0, as
    the JAX package sums them.  Returns (out, new_state)."""
    if state is None:
        state = torch.zeros((x.shape[0], _CONV_WIDTH - 1, x.shape[2]),
                            dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=1)
    t = x.shape[1]
    out = 0
    for i in range(_CONV_WIDTH):
        out = out + xp[:, i:i + t] * conv[i][None, None, :]
    return out, xp[:, -(_CONV_WIDTH - 1):]


def _gates(p: Recurrent, xc):
    """(a, u), float32: a = exp(-8 softplus(lam) r), u = sqrt(1 - a^2) i x."""
    i = torch.sigmoid(xc @ p.w_i)
    r = torch.sigmoid(xc @ p.w_r)
    log_a = -_LRU_C * torch.nn.functional.softplus(p.lam.float()) * r.float()
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    u = mult * i.float() * xc.float()
    return a, u


def apply_recurrent(p: Recurrent, x, cfg, conv_state=None, h_state=None):
    """x: (B, T, D) -> (out, (conv_state, h_state)).  As in the JAX
    package, the given states are not read: the prefill starts from
    zero."""
    gate = layers.act_fn("gelu")(x @ p.w_gate)
    xb = x @ p.w_x
    xc, new_conv = _causal_conv(xb, p.conv)
    a, u = _gates(p, xc)
    h, h_last = rg_ops.rglru(a.float(), u)
    out = (gate * h.to(gate.dtype)) @ p.w_out
    return out, (new_conv, h_last)


def apply_recurrent_decode(p: Recurrent, x, cfg, conv_state, h_state):
    """x: (B, 1, D); conv_state: (B, 3, W); h_state: (B, W) float32."""
    gate = layers.act_fn("gelu")(x @ p.w_gate)
    xb = x @ p.w_x
    xc, new_conv = _causal_conv(xb, p.conv, conv_state)
    a, u = _gates(p, xc)
    h, new_h = rg_ops.rglru_decode_step(a[:, 0].float(), u[:, 0], h_state)
    out = (gate * h[:, None].to(gate.dtype)) @ p.w_out
    return out.to(x.dtype), (new_conv, new_h)
