"""Shared layers: norms, rotary embeddings, the gated FFN, embedding and
logits, and the random initialisers.

Parameters live in ``nn.Module`` containers (see :mod:`.attention`,
:mod:`.transformer`, :mod:`.model`) and keep the JAX package's layouts: a
dense weight is (d_in, d_out) and is applied as ``x @ w``.  Initialisers
draw from an explicit ``torch.Generator`` on the parameter's device; they
do not reproduce ``jax.random``'s numbers (the tests carry JAX parameters
across with :mod:`repro_torch.convert`).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def dtype_of(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def param(shape, dtype, device) -> nn.Parameter:
    """An uninitialised parameter (inference only: no gradient)."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def init_dense(w: torch.Tensor, gen: torch.Generator,
               scale: Optional[float] = None) -> None:
    """Fill a (d_in, d_out) weight with N(0, 1) * scale (default
    d_in ** -0.5), drawn in float32 and cast."""
    scale = scale if scale is not None else w.shape[0] ** -0.5
    x = torch.randn(w.shape, generator=gen, dtype=torch.float32,
                    device=w.device)
    w.copy_(x * scale)


def init_normal(w: torch.Tensor, gen: torch.Generator, std: float,
                mean: float = 0.0) -> None:
    """Fill ``w`` with N(mean, std^2), drawn in float32 and cast."""
    x = torch.randn(w.shape, generator=gen, dtype=torch.float32,
                    device=w.device)
    w.copy_(x * std + mean)


def init_uniform(w: torch.Tensor, gen: torch.Generator, lo: float,
                 hi: float) -> None:
    """Fill ``w`` with U(lo, hi), drawn in float32 and cast."""
    x = torch.rand(w.shape, generator=gen, dtype=torch.float32,
                   device=w.device)
    w.copy_(x * (hi - lo) + lo)


def rms_norm(x, gamma, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + gamma.float())
    return out.to(x.dtype)


def make_rope(positions, head_dim: int, theta: float,
              fraction: float = 1.0):
    """Returns (sin, cos) of shape (..., rot_dim//2) for given positions.
    The frequencies come from the same float32 numpy expression as the JAX
    package's, so the angles agree."""
    rot = int(head_dim * fraction) // 2 * 2
    freqs = 1.0 / (theta ** (np.arange(0, rot, 2, dtype=np.float32) / rot))
    freqs = torch.from_numpy(np.asarray(freqs, np.float32)).to(
        positions.device)
    ang = positions[..., None].float() * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x, sin, cos, fraction: float = 1.0):
    """x: (B, S, H, D); sin/cos: (B?, S, rot//2) or (S, rot//2).  Rotates
    interleaved (even, odd) lane pairs, as the JAX package does."""
    d = x.shape[-1]
    rot = int(d * fraction) // 2 * 2
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    # insert the head axis, and a leading batch axis if positions were
    # unbatched
    sin, cos = sin[..., None, :], cos[..., None, :]
    if sin.ndim < x1.ndim:
        sin, cos = sin[None], cos[None]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape)
    return torch.cat([out, xp.to(out.dtype)], dim=-1).to(x.dtype)


def act_fn(name: str):
    # jax.nn.gelu defaults to the tanh approximation
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


# --- gated FFN (SwiGLU / GeGLU) ---------------------------------------------

class FFN(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        dt = dtype_of(cfg)
        self.w_gate = param((cfg.d_model, cfg.d_ff), dt, device)
        self.w_up = param((cfg.d_model, cfg.d_ff), dt, device)
        self.w_down = param((cfg.d_ff, cfg.d_model), dt, device)


def init_ffn(p: FFN, cfg, gen: torch.Generator) -> None:
    init_dense(p.w_gate, gen)
    init_dense(p.w_up, gen)
    init_dense(p.w_down, gen, scale=cfg.d_ff ** -0.5)


def apply_ffn(p: FFN, x, cfg):
    h = act_fn(cfg.act)(x @ p.w_gate) * (x @ p.w_up)
    return h @ p.w_down


# --- embedding / logits ------------------------------------------------------

class Embed(nn.Module):
    """The token embedding (padded vocab) and, untied, the LM head."""

    def __init__(self, cfg, device):
        super().__init__()
        dt = dtype_of(cfg)
        self.embedding = param((cfg.padded_vocab, cfg.d_model), dt, device)
        self.lm_head = (None if cfg.tie_embeddings else
                        param((cfg.d_model, cfg.padded_vocab), dt, device))


def init_embed(p: Embed, cfg, gen: torch.Generator) -> None:
    init_dense(p.embedding, gen, scale=0.02)
    if p.lm_head is not None:
        init_dense(p.lm_head, gen)


def embed_tokens(p: Embed, tokens, cfg):
    x = F.embedding(tokens, p.embedding)
    if cfg.name.startswith("gemma") or cfg.name.startswith("recurrent"):
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)  # gemma
    return x


def logits_fn(p: Embed, x, cfg):
    w = p.lm_head if p.lm_head is not None else p.embedding.T
    logits = (x @ w).float()
    if cfg.logits_softcap > 0:
        c = cfg.logits_softcap
        logits = torch.tanh(logits / c) * c
    return logits


def cross_entropy(logits, labels, mask=None):
    """Mean next-token cross entropy in float32 (the JAX package's
    ``cross_entropy``, in its max-shifted form).  The label's logit is what
    the JAX package's one-hot sum gives: 0 for a label outside [0, V).
    With ``mask``, the masked mean over max(sum(mask), 1)."""
    m = logits.amax(-1, keepdim=True)
    lse = torch.log(torch.exp(logits - m).sum(-1)) + m[..., 0]
    v = logits.shape[-1]
    inside = (labels >= 0) & (labels < v)
    lab = torch.gather(logits, -1,
                       labels.long().clamp(0, v - 1)[..., None])[..., 0]
    nll = lse - torch.where(inside, lab, torch.zeros_like(lab))
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
