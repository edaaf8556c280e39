"""Top-level model: init, forward, prefill, decode, and the zero cache.

The entry points the launch and serve layers call are ``prefill`` (the
prompt pass) and ``decode_step`` (one token per sequence).  The encoder
(seamless) and the modality frontends are not ported yet; configs that need
them raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from .. import device as device_mod
from . import layers, transformer
from .config import ModelConfig


class Model(nn.Module):
    """The decoder-only LM: embedding, a stack of blocks, the final norm."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        if cfg.is_encdec or cfg.frontend != "none":
            raise NotImplementedError(
                f"{cfg.name}: the encoder and the modality frontends are not"
                " ported yet")
        self.embed = layers.Embed(cfg, device)
        self.final_norm = layers.param((cfg.d_model,), torch.float32, device)
        self.decoder = transformer.make_stack(cfg, cfg.num_layers, device)


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Model:
    """Random parameters from ``seed``, drawn on ``device`` (default: the
    card).  Same shapes, scales and dtypes as the JAX package's
    ``init_params``; not the same numbers."""
    dev = device_mod.resolve(device)
    p = Model(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        layers.init_embed(p.embed, cfg, gen)
        p.final_norm.zero_()
        for blk in p.decoder:
            transformer.init_block(blk, cfg, gen)
    return p


def forward(params: Model, batch: Dict, cfg: ModelConfig, *,
            return_cache: bool = False, s_max: Optional[int] = None):
    """Full forward over batch['tokens'] (B, S). Returns (logits (B, S, V)
    float32, caches or None, aux) — aux, the MoE auxiliary loss of the JAX
    package's signature, is 0 without MoE."""
    x = layers.embed_tokens(params.embed, batch["tokens"], cfg)
    x, caches = transformer.apply_stack(params.decoder, x, cfg,
                                        return_cache=return_cache,
                                        s_max=s_max)
    x = layers.rms_norm(x, params.final_norm, cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return layers.logits_fn(params.embed, x, cfg), caches, aux


def prefill(params: Model, batch: Dict, cfg: ModelConfig, s_max: int):
    """Prompt pass: returns (last_logits (B, V), caches, lengths).

    The JAX package computes every position's logits and keeps the last;
    only the last row is computed here (each row's logits depend on that
    row alone), which spares a (B, S, V) float32 tensor."""
    x = layers.embed_tokens(params.embed, batch["tokens"], cfg)
    x, caches = transformer.apply_stack(params.decoder, x, cfg,
                                        return_cache=True, s_max=s_max)
    x = layers.rms_norm(x[:, -1:], params.final_norm, cfg.norm_eps)
    logits = layers.logits_fn(params.embed, x, cfg)
    lengths = batch.get("lengths")
    if lengths is None:
        b, s = batch["tokens"].shape
        lengths = torch.full((b,), s, dtype=torch.int32, device=x.device)
    return logits[:, 0], caches, lengths


def decode_step(params: Model, token, caches: List[Dict], lengths,
                cfg: ModelConfig):
    """One decode step. token: (B,) int; lengths include this token.
    Returns (logits (B, V), caches) — the caches are updated in place."""
    x = layers.embed_tokens(params.embed, token[:, None], cfg)
    x, caches = transformer.apply_stack_decode(params.decoder, x, cfg,
                                               caches, lengths=lengths)
    x = layers.rms_norm(x, params.final_norm, cfg.norm_eps)
    return layers.logits_fn(params.embed, x, cfg)[:, 0], caches


# cache leaves kept in float32 whatever the model dtype (the recurrent
# states); every other leaf is in the model dtype
FLOAT32_CACHE = ("state", "h")


def cache_dtype(cfg: ModelConfig, name: str) -> torch.dtype:
    return torch.float32 if name in FLOAT32_CACHE else layers.dtype_of(cfg)


def cache_shapes(cfg: ModelConfig, kind: str, batch: int,
                 s_max: int) -> Dict[str, tuple]:
    """A layer's decode cache, leaf by leaf, as the JAX package's
    ``abstract_cache`` lays it out."""
    d = cfg.d_model
    if kind in transformer.ATTN_KINDS:
        shape = (batch, cfg.num_kv_heads, s_max, cfg.head_dim)
        return {"k": shape, "v": shape}
    if kind == "rwkv":
        n = cfg.rwkv_head_dim
        return {"state": (batch, d // n, n, n), "xtm": (batch, 1, d),
                "xcm": (batch, 1, d)}
    w = cfg.lru_width or d
    return {"conv": (batch, 3, w), "h": (batch, w)}


def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               device=None) -> List[Dict]:
    """The zero decode cache of a batch: one dict per layer, by layer kind
    (attention {'k','v'} (B, KH, s_max, hd); rwkv {'state' (B, H, N, N),
    'xtm', 'xcm' (B, 1, D)}; recurrent {'conv' (B, 3, W), 'h' (B, W)}),
    'state' and 'h' in float32, the rest in the model's dtype."""
    dev = device_mod.resolve(device)
    return [{name: torch.zeros(shape, dtype=cache_dtype(cfg, name),
                               device=dev)
             for name, shape in cache_shapes(cfg, cfg.layer_type(i), batch,
                                             s_max).items()}
            for i in range(cfg.num_layers)]
