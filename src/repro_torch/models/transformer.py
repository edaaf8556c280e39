"""Blocks and the layer stack.

The stack is an ``nn.ModuleList`` of blocks run in a Python loop; layer i
has kind ``cfg.layer_type(i)``.  (The JAX package stacks parameters by
pattern group and scans over the groups; ``repro_torch.convert`` maps its
layout onto this one.)  Caches are a list with one dict per layer, by
kind: attention {'k','v'}, rwkv {'state','xtm','xcm'}, recurrent
{'conv','h'}.  The attention and recurrent kinds have a dense FFN, the
rwkv kind its channel-mix; MoE and cross-attention blocks raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from . import attention, griffin, layers, rwkv

ATTN_KINDS = ("global", "local", "nope")
KINDS = ATTN_KINDS + ("rwkv", "recurrent")


class Block(nn.Module):
    def __init__(self, cfg, kind: str, device):
        super().__init__()
        if kind not in KINDS:
            raise ValueError(f"unknown block kind {kind!r}")
        if cfg.is_moe:
            raise NotImplementedError("MoE blocks are not ported yet")
        if cfg.cross_attention:
            raise NotImplementedError("cross-attention is not ported yet")
        self.kind = kind
        self.norm1 = layers.param((cfg.d_model,), torch.float32, device)
        self.norm2 = layers.param((cfg.d_model,), torch.float32, device)
        if kind in ATTN_KINDS:
            self.attn = attention.Attention(cfg, device)
        elif kind == "rwkv":
            self.mix = rwkv.RWKV(cfg, device)
        else:
            self.rec = griffin.Recurrent(cfg, device)
        if kind != "rwkv":
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
    if p.kind != "rwkv":
        layers.init_ffn(p.ffn, cfg, gen)


def apply_block(p: Block, x, cfg, *, return_cache: bool = False,
                s_max: Optional[int] = None):
    """Returns (x, cache or None).  (The JAX block also returns the MoE
    auxiliary loss, which is 0 without MoE.)"""
    h = layers.rms_norm(x, p.norm1, cfg.norm_eps)
    if p.kind in ATTN_KINDS:
        o, cache = attention.apply_attention(
            p.attn, h, cfg, p.kind, return_cache=return_cache, s_max=s_max)
    elif p.kind == "rwkv":
        o, (state, xtm) = rwkv.time_mix(p.mix, h, cfg)
        cache = dict(state=state, xtm=xtm)
    else:
        o, (conv, h_last) = griffin.apply_recurrent(p.rec, h, cfg)
        cache = dict(conv=conv, h=h_last)
    x = x + o
    h2 = layers.rms_norm(x, p.norm2, cfg.norm_eps)
    if p.kind == "rwkv":
        o, cache["xcm"] = rwkv.channel_mix(p.mix, h2, cfg)
        x = x + o
    else:
        x = x + layers.apply_ffn(p.ffn, h2, cfg)
    return x, (cache if return_cache else None)


def apply_block_decode(p: Block, x, cfg, cache: Dict, *, lengths):
    """One-token decode. Returns (x, cache), the cache dict updated in
    place (attention writes its k/v rows in place; the recurrent kinds
    replace their state tensors)."""
    h = layers.rms_norm(x, p.norm1, cfg.norm_eps)
    if p.kind in ATTN_KINDS:
        o, cache = attention.apply_attention_decode(p.attn, h, cfg, p.kind,
                                                    cache, lengths=lengths)
    elif p.kind == "rwkv":
        o, (cache["state"], cache["xtm"]) = rwkv.time_mix_decode(
            p.mix, h, cfg, cache["state"], cache["xtm"])
    else:
        o, (cache["conv"], cache["h"]) = griffin.apply_recurrent_decode(
            p.rec, h, cfg, cache["conv"], cache["h"])
    x = x + o
    h2 = layers.rms_norm(x, p.norm2, cfg.norm_eps)
    if p.kind == "rwkv":
        o, cache["xcm"] = rwkv.channel_mix(p.mix, h2, cfg,
                                           x_prev=cache["xcm"], decode=True)
        return x + o, cache
    return x + layers.apply_ffn(p.ffn, h2, cfg), cache


def make_stack(cfg, n_layers: int, device) -> nn.ModuleList:
    return nn.ModuleList(Block(cfg, cfg.layer_type(i), device)
                         for i in range(n_layers))


def apply_stack(stack: nn.ModuleList, x, cfg, *, return_cache: bool = False,
                s_max: Optional[int] = None):
    """Returns (x, caches (a list per layer) or None)."""
    caches: List[Dict] = []
    for blk in stack:
        x, c = apply_block(blk, x, cfg, return_cache=return_cache,
                           s_max=s_max)
        caches.append(c)
    return x, (caches if return_cache else None)


def apply_stack_decode(stack: nn.ModuleList, x, cfg, caches: List[Dict], *,
                       lengths):
    new_caches = []
    for blk, c in zip(stack, caches, strict=True):
        x, c = apply_block_decode(blk, x, cfg, c, lengths=lengths)
        new_caches.append(c)
    return x, new_caches
