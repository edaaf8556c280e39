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


def split_partial_emulation(q, k, v, lengths, *, window: int = 0,
                            kpos_offset: int = 0,
                            scale: Optional[float] = None,
                            rows: Optional[int] = None,
                            cols: Optional[int] = None):
    """The decode kernel's split and combine passes in plain PyTorch: the
    shard cut into splits of ``rows`` rows (the wrapper's ``plan_splits``
    by default), ``decode_partial_reference`` on each split at its own
    kpos_offset, and the splits that hold visible rows merged as the
    combine kernel merges them (the kernel evaluates the same sums in base
    2), ``cols`` columns of acc a block (``combine_cols`` by default) over
    D // cols blocks: a column no block covers stays NaN.  A row with no
    visible row gives acc 0, l 0, m -1e30.  Returns (acc, m, l) as
    ``decode_partial_reference`` does."""
    from .ops import combine_cols, plan_splits
    b, _, _, d = q.shape
    kh, s = k.shape[1], k.shape[2]
    if rows is None:
        rows = plan_splits(b, kh, s)[0]
    if cols is None:
        cols = combine_cols(d)
    n = max(1, -(-s // rows))
    ln = lengths.to(device=q.device, dtype=torch.int64)
    lo = ln - window if window > 0 else torch.zeros_like(ln)
    j_lo = (lo - kpos_offset).clamp(min=0)
    j_hi = (ln - kpos_offset).clamp(max=s)
    visible = j_hi > j_lo
    idx = torch.arange(n, device=q.device)[:, None]
    used = visible & (idx >= j_lo // rows) & (idx <= (j_hi - 1) // rows)
    used = used[:, :, None, None, None]                   # (n, B, 1, 1, 1)
    parts = [decode_partial_reference(
        q, k[:, :, i * rows:(i + 1) * rows], v[:, :, i * rows:(i + 1) * rows],
        lengths, window=window, kpos_offset=kpos_offset + i * rows,
        scale=scale) for i in range(n)]
    accs, ms, ls = (torch.stack(x) for x in zip(*parts))
    m = torch.where(used, ms, -torch.inf).amax(0)
    f = torch.where(used, torch.exp(ms - m), 0.0)
    l = (f * ls).sum(0)
    acc = torch.full_like(accs[0], torch.nan)
    for c0 in range(0, (d // cols) * cols, cols):         # the column blocks
        acc[..., c0:c0 + cols] = (f * accs[..., c0:c0 + cols]).sum(0)
    vis = visible[:, None, None, None]
    return (torch.where(vis, acc, 0.0), torch.where(vis, m, NEG_INF),
            torch.where(vis, l, 0.0))


def decode_reference(q, k, v, lengths, *, window: int = 0,
                     scale: Optional[float] = None):
    acc, m, l = decode_partial_reference(q, k, v, lengths, window=window,
                                         scale=scale)
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)
