"""Attention block: GQA/MQA/MHA, RoPE (full/partial/none), qk-norm,
causal and sliding-window self-attention and its one-token decode against
a KV cache.

Cache layout: {'k','v'}: (B, KH, S_max, hd), one dict per layer.  Prefill
runs the flash-attention kernel, decode the decode-attention kernel (their
plain versions on the CPU).  The JAX package's int8 cache (``kv_quant``),
rolling window cache (``window_cache``) and cross-attention arms raise
``NotImplementedError`` here.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

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


def _check_supported(cfg, kind: str) -> None:
    if cfg.kv_quant:
        raise NotImplementedError("the int8 KV cache (kv_quant) is not "
                                  "ported yet")
    if cfg.window_cache and kind == "local":
        raise NotImplementedError("the rolling window cache (window_cache) "
                                  "is not ported yet")


def _project(p: Attention, x, cfg):
    b, s, _ = x.shape
    q = (x @ p.wq).reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = (x @ p.wk).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = (x @ p.wv).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = layers.rms_norm(q, p.q_norm, cfg.norm_eps)
        k = layers.rms_norm(k, p.k_norm, cfg.norm_eps)
    return q, k, v


def apply_attention(p: Attention, x, cfg, kind: str, *,
                    return_cache: bool = False, s_max: Optional[int] = None):
    """Causal train/prefill path. x: (B, S, D). kind: global|local|nope.
    Returns (out, cache or None); the cache holds the S positions' k/v at
    the front of an s_max-long zero cache.  (The encoder's bidirectional
    mode waits for the encoder.)"""
    if return_cache:
        _check_supported(cfg, kind)
    b, s, _ = x.shape
    q, k, v = _project(p, x, cfg)
    if kind != "nope":
        sin, cos = layers.make_rope(torch.arange(s, device=x.device),
                                    cfg.head_dim, cfg.rope_theta,
                                    cfg.rope_fraction)
        q = layers.apply_rope(q, sin, cos, cfg.rope_fraction)
        k = layers.apply_rope(k, sin, cos, cfg.rope_fraction)

    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    window = cfg.window if kind == "local" else 0
    o = fa_ops.flash_attention(qh, kh, vh, mode="causal", window=window)
    o = o.transpose(1, 2).reshape(b, s, cfg.attn_dim)
    out = o @ p.wo
    if not return_cache:
        return out, None
    sm = s_max or s
    if s > sm:
        raise ValueError(f"{s} prompt positions do not fit s_max={sm}")
    shape = (b, cfg.num_kv_heads, sm, cfg.head_dim)
    cache = {"k": torch.zeros(shape, dtype=kh.dtype, device=x.device),
             "v": torch.zeros(shape, dtype=vh.dtype, device=x.device)}
    cache["k"][:, :, :s] = kh
    cache["v"][:, :, :s] = vh
    return out, cache


def write_cache(cache: torch.Tensor, new: torch.Tensor,
                lengths: torch.Tensor) -> None:
    """In place: cache[b, :, lengths[b] - 1] = new[b] for every row with
    1 <= lengths[b] <= S_max; other rows (an idle slot's length 0, or a
    full cache) are left as they are, as the JAX package's masked write
    leaves them.  cache (B, KH, S_max, hd), new (B, KH, hd).  Only the B
    written rows move, not the cache."""
    b, _, s_max, _ = cache.shape
    rows = torch.arange(b, device=cache.device)
    ok = ((lengths >= 1) & (lengths <= s_max))[:, None, None]
    pos = torch.clamp(lengths.long() - 1, 0, s_max - 1)
    old = cache[rows, :, pos]
    cache[rows, :, pos] = torch.where(ok, new.to(cache.dtype), old)


def apply_attention_decode(p: Attention, x, cfg, kind: str, cache: Dict, *,
                           lengths: torch.Tensor):
    """One-token decode. x: (B, 1, D); cache k/v: (B, KH, S_max, hd);
    lengths: (B,) valid entries INCLUDING the new token.  Writes the new
    token's k/v into the cache in place (the JAX package returns a new
    cache) and returns (out, cache)."""
    _check_supported(cfg, kind)
    b = x.shape[0]
    q, k, v = _project(p, x, cfg)
    if kind != "nope":
        pos = (lengths - 1)[:, None]
        sin, cos = layers.make_rope(pos, cfg.head_dim, cfg.rope_theta,
                                    cfg.rope_fraction)
        q = layers.apply_rope(q, sin, cos, cfg.rope_fraction)
        k = layers.apply_rope(k, sin, cos, cfg.rope_fraction)
    write_cache(cache["k"], k[:, 0], lengths)
    write_cache(cache["v"], v[:, 0], lengths)

    window = cfg.window if kind == "local" else 0
    o = dec_ops.decode_attention(q.transpose(1, 2), cache["k"], cache["v"],
                                 lengths, window=window)
    o = o.transpose(1, 2).reshape(b, 1, cfg.attn_dim)
    return (o @ p.wo).to(x.dtype), cache
