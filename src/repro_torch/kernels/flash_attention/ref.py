"""Plain PyTorch attention (causal / sliding-window / length / full): the
plain version of the flash-attention kernel, as the JAX package's
``attention_reference`` computes it.

Shapes: q (B, H, Sq, D); k, v (B, KH, Sk, D) with H % KH == 0 (GQA).
``mode``:
  'full'    — no mask (encoder / cross-attention)
  'causal'  — position i (+ ``q_offset``) attends to j <= i (+ window)
  'length'  — decode: attend to j < lengths[b] (Sq is typically 1)
``window`` — sliding window size w: j > i - w (0 = unlimited).
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_reference(q, k, v, *, mode: str = "causal", window: int = 0,
                        lengths: Optional[torch.Tensor] = None,
                        q_offset: int = 0, scale: Optional[float] = None):
    b, h, sq, d = q.shape
    _, kh, sk, _ = k.shape
    if h % kh:
        raise ValueError(f"{h} query heads do not group over {kh} KV heads")
    g = h // kh
    scale = scale if scale is not None else d ** -0.5

    qf = q.float() * scale
    kf = torch.repeat_interleave(k.float(), g, dim=1)
    vf = torch.repeat_interleave(v.float(), g, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", qf, kf)

    qpos = torch.arange(sq, device=q.device) + q_offset
    kpos = torch.arange(sk, device=q.device)
    if mode == "causal":
        mask = kpos[None, :] <= qpos[:, None]
        if window > 0:
            mask &= kpos[None, :] > qpos[:, None] - window
        mask = mask[None, None]
    elif mode == "length":
        # the cache holds lengths[b] valid entries (including the current
        # token); attend to j < length, and with a sliding window only to
        # the last `window` of them
        if lengths is None:
            raise ValueError("mode='length' needs lengths")
        ln = lengths.to(q.device)[:, None, None, None]
        mask = kpos < ln
        if window > 0:
            mask &= kpos >= ln - window
    elif mode == "full":
        mask = torch.ones((1, 1, sq, sk), dtype=torch.bool, device=q.device)
    else:
        raise ValueError(mode)

    logits = torch.where(mask, logits, NEG_INF)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = p / (p.sum(-1, keepdim=True) + 1e-30)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)
