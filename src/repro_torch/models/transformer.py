"""Blocks and the layer stack.

A stack is an ``nn.ModuleList`` of blocks run in a Python loop; layer i
has kind ``pattern[i % len(pattern)]`` (the decoder's ``cfg.layer_pattern``,
the encoder's ``("global",)``).  (The JAX package stacks parameters by
pattern group and scans over the groups; ``repro_torch.convert`` maps its
layout onto this one.)  Caches are a list with one dict per layer, by
kind: attention {'k','v'} (int8 with 'ks','vs' under ``kv_quant``), rwkv
{'state','xtm','xcm'}, recurrent {'conv','h'}; a decoder block with
cross-attention adds the encoder's {'ck','cv'}.  The attention and
recurrent kinds have a dense FFN or, in an MoE model, an MoE FFN; the rwkv
kind its channel-mix.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from ..kernels.flash_attention import ops as fa_ops
from . import attention, griffin, layers, moe, rwkv

ATTN_KINDS = ("global", "local", "nope")
KINDS = ATTN_KINDS + ("rwkv", "recurrent")


class Block(nn.Module):
    def __init__(self, cfg, kind: str, device, cross: bool = False):
        super().__init__()
        if kind not in KINDS:
            raise ValueError(f"unknown block kind {kind!r}")
        self.kind = kind
        self.norm1 = layers.param((cfg.d_model,), torch.float32, device)
        self.norm2 = layers.param((cfg.d_model,), torch.float32, device)
        if kind in ATTN_KINDS:
            self.attn = attention.Attention(cfg, device)
        elif kind == "rwkv":
            self.mix = rwkv.RWKV(cfg, device)
        else:
            self.rec = griffin.Recurrent(cfg, device)
        if cross:
            self.norm_cross = layers.param((cfg.d_model,), torch.float32,
                                           device)
            self.cross = attention.Attention(cfg, device)
        else:
            self.norm_cross = self.cross = None
        if kind != "rwkv":
            if cfg.is_moe:
                self.moe = moe.MoE(cfg, device)
            else:
                self.ffn = layers.FFN(cfg, device)


def init_block(p: Block, cfg, gen: torch.Generator) -> None:
    p.norm1.zero_()
    p.norm2.zero_()
    if p.kind in ATTN_KINDS:
        attention.init_attention(p.attn, cfg, gen)
    elif p.kind == "rwkv":
        rwkv.init_rwkv(p.mix, cfg, gen)
    else:
        griffin.init_recurrent(p.rec, cfg, gen)
    if p.cross is not None:
        p.norm_cross.zero_()
        attention.init_attention(p.cross, cfg, gen)
    if p.kind != "rwkv":
        if cfg.is_moe:
            moe.init_moe(p.moe, cfg, gen)
        else:
            layers.init_ffn(p.ffn, cfg, gen)


def _ffn(p: Block, h2, cfg):
    """The block's FFN on h2: (out, MoE aux or 0)."""
    if cfg.is_moe:
        return moe.apply_moe(p.moe, h2, cfg)
    return layers.apply_ffn(p.ffn, h2, cfg), torch.zeros(
        (), dtype=torch.float32, device=h2.device)


def apply_block(p: Block, x, cfg, *, mode: str = "causal", enc_out=None,
                return_cache: bool = False, s_max: Optional[int] = None):
    """Returns (x, cache or None, aux), aux the MoE auxiliary loss (0
    without MoE).  With ``enc_out`` a cross-attention block attends to it
    (flash, mode full) and caches its K/V as 'ck', 'cv'."""
    h = layers.rms_norm(x, p.norm1, cfg.norm_eps)
    if p.kind in ATTN_KINDS:
        o, cache = attention.apply_attention(
            p.attn, h, cfg, p.kind, mode=mode, return_cache=return_cache,
            s_max=s_max)
    elif p.kind == "rwkv":
        o, (state, xtm) = rwkv.time_mix(p.mix, h, cfg)
        cache = dict(state=state, xtm=xtm)
    else:
        o, (conv, h_last) = griffin.apply_recurrent(p.rec, h, cfg)
        cache = dict(conv=conv, h=h_last)
    x = x + o

    if p.cross is not None and enc_out is not None:
        hc = layers.rms_norm(x, p.norm_cross, cfg.norm_eps)
        ckv = attention.init_cross_cache(p.cross, enc_out, cfg)
        b, s, _ = hc.shape
        q = (hc @ p.cross.wq).reshape(b, s, cfg.num_heads, cfg.head_dim)
        if cfg.qk_norm:
            q = layers.rms_norm(q, p.cross.q_norm, cfg.norm_eps)
        o = fa_ops.flash_attention(q.transpose(1, 2), ckv["k"], ckv["v"],
                                   mode="full")
        o = o.transpose(1, 2).reshape(b, s, cfg.attn_dim)
        x = x + o @ p.cross.wo
        if return_cache:
            cache.update(ck=ckv["k"], cv=ckv["v"])

    h2 = layers.rms_norm(x, p.norm2, cfg.norm_eps)
    if p.kind == "rwkv":
        o, cache["xcm"] = rwkv.channel_mix(p.mix, h2, cfg)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        o, aux = _ffn(p, h2, cfg)
    return x + o, (cache if return_cache else None), aux


def apply_block_decode(p: Block, x, cfg, cache: Dict, *, lengths,
                       enc_lengths=None):
    """One-token decode. Returns (x, cache), the cache dict updated in
    place (attention writes its k/v rows in place; the recurrent kinds
    replace their state tensors; the cross K/V are read only)."""
    h = layers.rms_norm(x, p.norm1, cfg.norm_eps)
    if p.kind in ATTN_KINDS:
        o, _ = attention.apply_attention_decode(p.attn, h, cfg, p.kind,
                                                cache, lengths=lengths)
    elif p.kind == "rwkv":
        o, (cache["state"], cache["xtm"]) = rwkv.time_mix_decode(
            p.mix, h, cfg, cache["state"], cache["xtm"])
    else:
        o, (cache["conv"], cache["h"]) = griffin.apply_recurrent_decode(
            p.rec, h, cfg, cache["conv"], cache["h"])
    x = x + o

    if p.cross is not None and "ck" in cache:
        hc = layers.rms_norm(x, p.norm_cross, cfg.norm_eps)
        o, _ = attention.apply_attention_decode(
            p.cross, hc, cfg, "global", {"k": cache["ck"], "v": cache["cv"]},
            lengths=enc_lengths, cross=True)
        x = x + o

    h2 = layers.rms_norm(x, p.norm2, cfg.norm_eps)
    if p.kind == "rwkv":
        o, cache["xcm"] = rwkv.channel_mix(p.mix, h2, cfg,
                                           x_prev=cache["xcm"], decode=True)
        return x + o, cache
    return x + _ffn(p, h2, cfg)[0], cache


def make_stack(cfg, n_layers: int, device,
               pattern: Optional[Sequence[str]] = None,
               cross: bool = False) -> nn.ModuleList:
    """``n_layers`` blocks of ``pattern`` (default ``cfg.layer_pattern``)."""
    pattern = tuple(pattern or cfg.layer_pattern)
    return nn.ModuleList(Block(cfg, pattern[i % len(pattern)], device, cross)
                         for i in range(n_layers))


def apply_stack(stack: nn.ModuleList, x, cfg, *, mode: str = "causal",
                enc_out=None, return_cache: bool = False,
                s_max: Optional[int] = None):
    """Returns (x, caches (a list per layer) or None, aux summed over the
    layers)."""
    caches: List[Dict] = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for blk in stack:
        x, c, a = apply_block(blk, x, cfg, mode=mode, enc_out=enc_out,
                              return_cache=return_cache, s_max=s_max)
        caches.append(c)
        aux = aux + a
    return x, (caches if return_cache else None), aux


def apply_stack_decode(stack: nn.ModuleList, x, cfg, caches: List[Dict], *,
                       lengths, enc_lengths=None):
    new_caches = []
    for blk, c in zip(stack, caches, strict=True):
        x, c = apply_block_decode(blk, x, cfg, c, lengths=lengths,
                                  enc_lengths=enc_lengths)
        new_caches.append(c)
    return x, new_caches
