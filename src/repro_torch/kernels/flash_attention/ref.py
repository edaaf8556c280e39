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


def visible_mask(sq: int, sk: int, device, *, mode: str = "causal",
                 window: int = 0, lengths: Optional[torch.Tensor] = None,
                 q_offset: int = 0):
    """The (q, k) pairs a mode lets through, broadcastable to
    (B, H, Sq, Sk)."""
    qpos = torch.arange(sq, device=device) + q_offset
    kpos = torch.arange(sk, device=device)
    if mode == "causal":
        mask = kpos[None, :] <= qpos[:, None]
        if window > 0:
            mask &= kpos[None, :] > qpos[:, None] - window
        return mask[None, None]
    if mode == "length":
        # the cache holds lengths[b] valid entries (including the current
        # token); attend to j < length, and with a sliding window only to
        # the last `window` of them
        if lengths is None:
            raise ValueError("mode='length' needs lengths")
        ln = lengths.to(device)[:, None, None, None]
        mask = kpos < ln
        if window > 0:
            mask &= kpos >= ln - window
        return mask
    if mode == "full":
        return torch.ones((1, 1, sq, sk), dtype=torch.bool, device=device)
    raise ValueError(mode)


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
    mask = visible_mask(sq, sk, q.device, mode=mode, window=window,
                        lengths=lengths, q_offset=q_offset)
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = p / (p.sum(-1, keepdim=True) + 1e-30)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)


def tensor_core_emulation(q, k, v, *, mode: str = "causal", window: int = 0,
                          lengths: Optional[torch.Tensor] = None,
                          q_offset: int = 0, scale: Optional[float] = None,
                          block_k: Optional[int] = None):
    """The tensor-core kernel's arithmetic in plain PyTorch, for the tests:
    float32 scores (q . k) * scale over tiles of ``block_k`` keys (the
    kernel's BK: 64 at head dim 256, else 128), the online softmax (running
    max m, sum l of the float32 p, acc rescaled by alpha), p rounded to
    bfloat16 before p @ v, and acc / max(l, 1e-30); a masked score gives
    p = 0, so a row that sees no key gives 0."""
    b, h, sq, d = q.shape
    _, kh, sk, _ = k.shape
    g = h // kh
    scale = scale if scale is not None else d ** -0.5
    bk = block_k or (64 if d == 256 else 128)
    qf = q.float()
    kf = torch.repeat_interleave(k.float(), g, dim=1)
    vf = torch.repeat_interleave(v.float(), g, dim=1)
    mask = visible_mask(sq, sk, q.device, mode=mode, window=window,
                        lengths=lengths, q_offset=q_offset)
    m = torch.full((b, h, sq, 1), -torch.inf, device=q.device)
    l = torch.zeros((b, h, sq, 1), device=q.device)
    acc = torch.zeros((b, h, sq, d), device=q.device)
    for k0 in range(0, sk, bk):
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, k0:k0 + bk]) * scale
        s = torch.where(mask[..., k0:k0 + bk], s, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        base = torch.where(m_new == -torch.inf, 0.0, m_new)
        alpha = torch.exp(m - base)
        p = torch.exp(s - base)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = alpha * acc + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(),
            vf[:, :, k0:k0 + bk])
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)
