"""Attention block: GQA/MQA/MHA, RoPE (full/partial/none), qk-norm,
causal, sliding-window and bidirectional attention, cross-attention, and
the one-token decode against a KV cache.

Cache layout: {'k','v'}: (B, KH, S_max, hd), one dict per layer; with
``kv_quant`` 'k'/'v' are int8 with float32 per-(b, h, position) scales
'ks'/'vs' (B, KH, S_max, 1); with ``window_cache`` a local layer whose
window is shorter than S_max keeps a rolling cache of ``window`` slots,
position p at slot p % window.  Prefill runs the flash-attention kernel,
decode the decode-attention kernel on the (dequantized) cache (their plain
versions on the CPU).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..distributed.sharding import is_dtensor, shard, split_last
from ..kernels.decode_attention import ops as dec_ops
from ..kernels.flash_attention import ops as fa_ops
from . import layers


class Attention(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        dt = layers.dtype_of(cfg)
        d = cfg.d_model
        self.wq = layers.param((d, cfg.attn_dim), dt, device)
        self.wk = layers.param((d, cfg.kv_dim), dt, device)
        self.wv = layers.param((d, cfg.kv_dim), dt, device)
        self.wo = layers.param((cfg.attn_dim, d), dt, device)
        if cfg.qk_norm:
            self.q_norm = layers.param((cfg.head_dim,), torch.float32, device)
            self.k_norm = layers.param((cfg.head_dim,), torch.float32, device)
        else:
            self.q_norm = self.k_norm = None


def init_attention(p: Attention, cfg, gen: torch.Generator) -> None:
    layers.init_dense(p.wq, gen)
    layers.init_dense(p.wk, gen)
    layers.init_dense(p.wv, gen)
    layers.init_dense(p.wo, gen, scale=cfg.attn_dim ** -0.5)
    if p.q_norm is not None:
        p.q_norm.zero_()
        p.k_norm.zero_()


def quantize_kv(x):
    """int8 per-(b, h, position) symmetric quantization (KIVI-style): the
    JAX package's ``_quantize_kv``, op for op (``torch.round`` rounds half
    to even, as ``jnp.round`` does).  Returns (int8 q, float32 scale)."""
    xf = x.float()
    scale = torch.amax(torch.abs(xf), dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-8)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q, scale, dtype):
    return (q.float() * scale).to(dtype)


def rolling(cfg, kind: str, s_max: int) -> bool:
    """Whether a ``kind`` layer keeps a rolling window cache at s_max."""
    return (cfg.window_cache and kind == "local" and 0 < cfg.window < s_max)


def _project(p: Attention, x, cfg):
    b, s, _ = x.shape
    q = split_last(x @ p.wq, (b, s, cfg.num_heads, cfg.head_dim))
    k = split_last(x @ p.wk, (b, s, cfg.num_kv_heads, cfg.head_dim))
    v = split_last(x @ p.wv, (b, s, cfg.num_kv_heads, cfg.head_dim))
    if cfg.qk_norm:
        q = layers.rms_norm(q, p.q_norm, cfg.norm_eps)
        k = layers.rms_norm(k, p.k_norm, cfg.norm_eps)
    return q, k, v


def apply_attention(p: Attention, x, cfg, kind: str, *,
                    positions: Optional[torch.Tensor] = None,
                    mode: str = "causal", return_cache: bool = False,
                    s_max: Optional[int] = None):
    """Train/prefill path. x: (B, S, D). kind: global|local|nope; mode:
    causal, full (bidirectional, the encoder's) or cross (full, no RoPE).
    Returns (out, cache or None); the cache holds the S positions' k/v at
    the front of an s_max-long zero cache, or the last ``window`` positions
    at their slots of a rolling one, int8 with scales under ``kv_quant``."""
    b, s, _ = x.shape
    q, k, v = _project(p, x, cfg)
    if kind != "nope" and mode != "cross":
        pos = (positions if positions is not None
               else torch.arange(s, device=x.device))
        sin, cos = layers.make_rope(pos, cfg.head_dim, cfg.rope_theta,
                                    cfg.rope_fraction)
        q = layers.apply_rope(q, sin, cos, cfg.rope_fraction)
        k = layers.apply_rope(k, sin, cos, cfg.rope_fraction)

    qh = shard(q.transpose(1, 2), "batch", "heads", None, None)
    kh = shard(k.transpose(1, 2), "batch", "kv_heads", None, None)
    vh = shard(v.transpose(1, 2), "batch", "kv_heads", None, None)
    window = cfg.window if kind == "local" else 0
    o = fa_ops.flash_attention(qh, kh, vh,
                               mode="causal" if mode == "causal" else "full",
                               window=window)
    o = o.transpose(1, 2).reshape(b, s, cfg.attn_dim)
    out = o @ p.wo
    if not return_cache:
        return out, None
    sm = s_max or s
    seq_axis = "long_seq" if sm >= (1 << 19) else "kv_seq"
    if rolling(cfg, kind, sm):
        seq_axis = None
        # only the last `window` positions are live, position p at slot
        # p % window (k carries its RoPE, so a slot is position-free)
        w = cfg.window
        take = min(s, w)
        slots = torch.arange(s - take, s, device=x.device) % w
        cache = {}
        for name, t in (("k", kh), ("v", vh)):
            c = t.new_zeros((b, cfg.num_kv_heads, w, cfg.head_dim))
            cache[name] = c.index_copy(2, slots, t[:, :, s - take:])
    else:
        if s > sm:
            raise ValueError(f"{s} prompt positions do not fit s_max={sm}")
        # the s positions at the front of an s_max-long zero cache
        pad = (b, cfg.num_kv_heads, sm - s, cfg.head_dim)
        cache = {"k": torch.cat([kh, kh.new_zeros(pad)], dim=2),
                 "v": torch.cat([vh, vh.new_zeros(pad)], dim=2)}
    cache["k"] = shard(cache["k"], "batch", "kv_heads", seq_axis, None)
    cache["v"] = shard(cache["v"], "batch", "kv_heads", seq_axis, None)
    if cfg.kv_quant:
        (kq, ks), (vq, vs) = quantize_kv(cache["k"]), quantize_kv(cache["v"])
        cache = {"k": shard(kq, "batch", "kv_heads", seq_axis, None),
                 "v": shard(vq, "batch", "kv_heads", seq_axis, None),
                 "ks": shard(ks, "batch", "kv_heads", seq_axis, None),
                 "vs": shard(vs, "batch", "kv_heads", seq_axis, None)}
    return out, cache


def write_cache(cache: torch.Tensor, new: torch.Tensor,
                slot: torch.Tensor) -> None:
    """In place: cache[b, :, slot[b]] = new[b] for every row with
    0 <= slot[b] < S; other rows (an idle slot's length 0, or a full
    cache) are left as they are, as the JAX package's masked write leaves
    them.  cache (B, KH, S, X), new (B, KH, X).  Only the B written rows
    move, not the cache."""
    b, _, s, _ = cache.shape
    if is_dtensor(cache):
        # a cache sharded over its positions: each shard keeps its rows
        # and takes the new entry where the one-hot of the slot says
        hit = (torch.arange(s, device=cache.device)[None, :]
               == slot.long()[:, None])[:, None, :, None]
        cache.copy_(torch.where(hit, new.to(cache.dtype)[:, :, None],
                                cache))
        return
    rows = torch.arange(b, device=cache.device)
    ok = ((slot >= 0) & (slot < s))[:, None, None]
    pos = torch.clamp(slot.long(), 0, s - 1)
    old = cache[rows, :, pos]
    cache[rows, :, pos] = torch.where(ok, new.to(cache.dtype), old)


def apply_attention_decode(p: Attention, x, cfg, kind: str, cache: Dict, *,
                           lengths: torch.Tensor, cross: bool = False):
    """One-token decode. x: (B, 1, D); cache k/v: (B, KH, S, hd); lengths:
    (B,) valid entries INCLUDING the new token (for self-attention; the
    encoder's lengths for ``cross``).  Self-attention writes the new
    token's k/v (quantized under ``kv_quant``) into the cache in place, at
    position lengths - 1, or its slot (lengths - 1) % window of a rolling
    cache (the JAX package returns a new cache); cross-attention reads its
    cache as it is, with no RoPE.  Returns (out, cache)."""
    b = x.shape[0]
    q, k, v = _project(p, x, cfg)
    is_rolling = (not cross and cfg.window_cache and kind == "local"
                  and cfg.window > 0 and cache["k"].shape[2] == cfg.window)
    if not cross:
        if kind != "nope":
            pos = (lengths - 1)[:, None]
            sin, cos = layers.make_rope(pos, cfg.head_dim, cfg.rope_theta,
                                        cfg.rope_fraction)
            q = layers.apply_rope(q, sin, cos, cfg.rope_fraction)
            k = layers.apply_rope(k, sin, cos, cfg.rope_fraction)
        slot = lengths.long() - 1
        if is_rolling:
            slot = torch.remainder(slot, cfg.window)
        if "ks" in cache:          # int8 cache: quantize the new entry
            (kq, ksc), (vq, vsc) = quantize_kv(k[:, 0]), quantize_kv(v[:, 0])
            for name, t in (("k", kq), ("ks", ksc), ("v", vq), ("vs", vsc)):
                write_cache(cache[name], t, slot)
        else:
            write_cache(cache["k"], k[:, 0], slot)
            write_cache(cache["v"], v[:, 0], slot)

    qh = q.transpose(1, 2)
    if "ks" in cache:              # dequantize for the attention kernel
        ck = dequantize_kv(cache["k"], cache["ks"], qh.dtype)
        cv = dequantize_kv(cache["v"], cache["vs"], qh.dtype)
    else:
        ck, cv = cache["k"], cache["v"]
    if is_rolling:
        # every live slot is inside the window, and attention does not
        # depend on the slots' order (RoPE is applied), so plain length
        # masking over min(length, window) slots is exact
        o = dec_ops.decode_attention(
            qh, ck, cv, torch.clamp(lengths, max=cfg.window), window=0)
    else:
        o = dec_ops.decode_attention(
            qh, ck, cv, lengths,
            window=cfg.window if kind == "local" else 0)
    o = o.transpose(1, 2).reshape(b, 1, cfg.attn_dim)
    return (o @ p.wo).to(x.dtype), cache


def init_cross_cache(p: Attention, enc_out, cfg) -> Dict:
    """The cross-attention K/V of the encoder output enc_out (B, S, D):
    {'k', 'v'} (B, KH, S, hd)."""
    b, s, _ = enc_out.shape
    k = split_last(enc_out @ p.wk, (b, s, cfg.num_kv_heads, cfg.head_dim))
    v = split_last(enc_out @ p.wv, (b, s, cfg.num_kv_heads, cfg.head_dim))
    if cfg.qk_norm:
        k = layers.rms_norm(k, p.k_norm, cfg.norm_eps)
    return {"k": shard(k.transpose(1, 2), "batch", "kv_heads", "kv_seq",
                       None),
            "v": shard(v.transpose(1, 2), "batch", "kv_heads", "kv_seq",
                       None)}
