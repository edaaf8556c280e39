"""Plain PyTorch single-token decode attention over a (possibly sharded)
cache: the plain version of the decode kernel, as the JAX package's
``decode_attention/ref.py`` computes it.

The *partial* form returns un-normalised ``(acc, m, l)`` per shard so that
partials merge across sequence shards — the flash-decoding identity:
softmax over the union == combine of per-shard partials with
``m* = max m_s; l* = sum l_s e^{m_s-m*}; acc* = sum acc_s e^{m_s-m*}``.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def decode_partial_reference(q, k, v, lengths, *, window: int = 0,
                             kpos_offset: int = 0,
                             scale: Optional[float] = None):
    """q: (B,H,1,D); k,v: (B,KH,S,D) — one shard's cache slice.

    lengths: (B,) GLOBAL valid length; kpos_offset: this shard's first
    global position.  Returns acc (B,H,1,D) f32, m (B,H,1,1), l (B,H,1,1).
    """
    b, h, _, d = q.shape
    _, kh, s, _ = k.shape
    g = h // kh
    scale = scale if scale is not None else d ** -0.5
    qf = q.float() * scale
    kf = torch.repeat_interleave(k.float(), g, dim=1)
    vf = torch.repeat_interleave(v.float(), g, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    kpos = torch.arange(s, device=q.device) + kpos_offset
    ln = lengths.to(q.device)[:, None, None, None]
    mask = kpos < ln
    if window > 0:
        mask &= kpos >= ln - window
    logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(logits - m), 0.0)
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bhqk,bhkd->bhqd", p, vf)
    return acc, m, l


def combine_partials_reference(parts):
    """parts: list of (acc, m, l). Returns normalised output (B,H,1,D)."""
    m_star = parts[0][1]
    for _, m, _ in parts[1:]:
        m_star = torch.maximum(m_star, m)
    l_star = sum(l * torch.exp(m - m_star) for _, m, l in parts)
    acc_star = sum(a * torch.exp(m - m_star) for a, m, _ in parts)
    return acc_star / torch.clamp(l_star, min=1e-30)


def decode_reference(q, k, v, lengths, *, window: int = 0,
                     scale: Optional[float] = None):
    acc, m, l = decode_partial_reference(q, k, v, lengths, window=window,
                                         scale=scale)
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)
