"""Top-level model: init and abstract init, forward, loss, prefill, decode,
and the zero cache.

Handles the modality frontends (stubs, as in the JAX package: ``patches``
and ``frames`` arrive as precomputed embeddings) and the optional encoder
(seamless).  The entry points the launch and serve layers call are
``prefill`` (the prompt pass) and ``decode_step`` (one token per
sequence); ``loss_fn`` is the forward half of the train step.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from .. import device as device_mod
from . import attention, layers, transformer
from .config import ModelConfig

ENCODER_PATTERN = ("global",)


class Model(nn.Module):
    """The LM: embedding, a decoder stack of blocks (with cross-attention
    in an encoder-decoder model), the final norm; the encoder stack and
    its norm (seamless), and the frontend projection of the patch or frame
    embeddings."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.embed = layers.Embed(cfg, device)
        self.final_norm = layers.param((cfg.d_model,), torch.float32, device)
        self.decoder = transformer.make_stack(cfg, cfg.num_layers, device,
                                              cross=cfg.cross_attention)
        if cfg.is_encdec:
            self.encoder = transformer.make_stack(
                cfg, cfg.num_encoder_layers, device, ENCODER_PATTERN)
            self.enc_norm = layers.param((cfg.d_model,), torch.float32,
                                         device)
        else:
            self.encoder = self.enc_norm = None
        self.frontend_proj = (
            layers.param((cfg.frontend_dim, cfg.d_model),
                         layers.dtype_of(cfg), device)
            if cfg.frontend != "none" else None)


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
        if p.encoder is not None:
            for blk in p.encoder:
                transformer.init_block(blk, cfg, gen)
            p.enc_norm.zero_()
        if p.frontend_proj is not None:
            layers.init_dense(p.frontend_proj, gen)
    return p


def abstract_params(cfg: ModelConfig) -> Model:
    """The parameters on the meta device: every shape and dtype, no
    storage (the dry run's view of a model of any size)."""
    return Model(cfg, torch.device("meta"))


# ---------------------------------------------------------------------------
# forward paths
# ---------------------------------------------------------------------------

def _encode(params: Model, batch: Dict, cfg: ModelConfig):
    """The encoder over batch['frames'] (B, T_src, frontend_dim):
    bidirectional (flash, mode full), RoPE on."""
    proj = params.frontend_proj
    x = batch["frames"].to(proj.dtype) @ proj
    x, _, _ = transformer.apply_stack(params.encoder, x, cfg, mode="full")
    return layers.rms_norm(x, params.enc_norm, cfg.norm_eps)


def _embed_inputs(params: Model, batch: Dict, cfg: ModelConfig):
    """Token embeddings, with the projected patches first (vision)."""
    x = layers.embed_tokens(params.embed, batch["tokens"], cfg)
    if cfg.frontend == "vision" and "patches" in batch:
        pe = batch["patches"].to(x.dtype) @ params.frontend_proj
        x = torch.cat([pe, x], dim=1)
    return x


def _stack(params: Model, batch: Dict, cfg: ModelConfig, return_cache,
           s_max):
    enc_out = _encode(params, batch, cfg) if cfg.is_encdec else None
    x = _embed_inputs(params, batch, cfg)
    return transformer.apply_stack(params.decoder, x, cfg, mode="causal",
                                   enc_out=enc_out,
                                   return_cache=return_cache, s_max=s_max)


def forward(params: Model, batch: Dict, cfg: ModelConfig, *,
            return_cache: bool = False, s_max: Optional[int] = None):
    """Full forward over batch['tokens'] (B, S) (and 'patches' or
    'frames'). Returns (logits (B, S', V) float32, caches or None, aux),
    S' counting the patches; aux is the MoE auxiliary loss (0 without
    MoE)."""
    x, caches, aux = _stack(params, batch, cfg, return_cache, s_max)
    x = layers.rms_norm(x, params.final_norm, cfg.norm_eps)
    return layers.logits_fn(params.embed, x, cfg), caches, aux


def loss_fn(params: Model, batch: Dict, cfg: ModelConfig):
    """Next-token CE (+ 0.01 MoE aux), the frontend positions sliced off.
    Returns (loss, {"ce", "aux"}).  (Forward only: no gradient yet.)"""
    logits, _, aux = forward(params, batch, cfg)
    labels = batch["targets"]
    n_front = logits.shape[1] - labels.shape[1]
    if n_front > 0:
        logits = logits[:, n_front:]
    loss = layers.cross_entropy(logits, labels, batch.get("loss_mask"))
    return loss + 0.01 * aux, {"ce": loss, "aux": aux}


def prefill(params: Model, batch: Dict, cfg: ModelConfig, s_max: int):
    """Prompt pass: returns (last_logits (B, V), caches, lengths), lengths
    counting every cached position, the patches too.

    The JAX package computes every position's logits and keeps the last;
    only the last row is computed here (each row's logits depend on that
    row alone), which spares a (B, S, V) float32 tensor."""
    x, caches, _ = _stack(params, batch, cfg, True, s_max)
    lengths = batch.get("lengths")
    if lengths is None:
        lengths = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                             device=x.device)
    x = layers.rms_norm(x[:, -1:], params.final_norm, cfg.norm_eps)
    return layers.logits_fn(params.embed, x, cfg)[:, 0], caches, lengths


def decode_step(params: Model, token, caches: List[Dict], lengths,
                cfg: ModelConfig, enc_lengths=None):
    """One decode step. token: (B,) int; lengths include this token;
    enc_lengths (B,) the encoder positions a cross-attention layer reads.
    Returns (logits (B, V), caches) — the caches are updated in place."""
    x = layers.embed_tokens(params.embed, token[:, None], cfg)
    x, caches = transformer.apply_stack_decode(params.decoder, x, cfg,
                                               caches, lengths=lengths,
                                               enc_lengths=enc_lengths)
    x = layers.rms_norm(x, params.final_norm, cfg.norm_eps)
    return layers.logits_fn(params.embed, x, cfg)[:, 0], caches


# ---------------------------------------------------------------------------
# the decode cache
# ---------------------------------------------------------------------------

# cache leaves kept in float32 whatever the model dtype: the recurrent
# states and the int8 cache's scales
FLOAT32_CACHE = ("state", "h", "ks", "vs")


def cache_dtype(cfg: ModelConfig, name: str) -> torch.dtype:
    if name in FLOAT32_CACHE:
        return torch.float32
    if cfg.kv_quant and name in ("k", "v"):
        return torch.int8
    return layers.dtype_of(cfg)


def cache_shapes(cfg: ModelConfig, kind: str, batch: int, s_max: int,
                 src_len: Optional[int] = None) -> Dict[str, tuple]:
    """A decoder layer's decode cache, leaf by leaf, as the JAX package's
    ``abstract_cache`` lays it out; a cross-attention layer's encoder K/V
    are ``src_len`` (default s_max) long."""
    d = cfg.d_model
    if kind in transformer.ATTN_KINDS:
        s = cfg.window if attention.rolling(cfg, kind, s_max) else s_max
        shape = (batch, cfg.num_kv_heads, s, cfg.head_dim)
        out = {"k": shape, "v": shape}
        if cfg.kv_quant:
            out.update(ks=shape[:3] + (1,), vs=shape[:3] + (1,))
    elif kind == "rwkv":
        n = cfg.rwkv_head_dim
        out = {"state": (batch, d // n, n, n), "xtm": (batch, 1, d),
               "xcm": (batch, 1, d)}
    else:
        w = cfg.lru_width or d
        out = {"conv": (batch, 3, w), "h": (batch, w)}
    if cfg.cross_attention:
        shape = (batch, cfg.num_kv_heads, src_len or s_max, cfg.head_dim)
        out.update(ck=shape, cv=shape)
    return out


def init_cache(cfg: ModelConfig, batch: int, s_max: int, device=None,
               src_len: Optional[int] = None) -> List[Dict]:
    """The zero decode cache of a batch: one dict per layer, by layer kind
    (attention {'k','v'} (B, KH, s_max or window, hd), int8 with float32
    'ks','vs' (B, KH, S, 1) under ``kv_quant``; rwkv {'state'
    (B, H, N, N), 'xtm', 'xcm' (B, 1, D)}; recurrent {'conv' (B, 3, W),
    'h' (B, W)}; cross-attention {'ck','cv'} (B, KH, src_len, hd)), each
    leaf of ``cache_dtype``."""
    dev = device_mod.resolve(device)
    return [{name: torch.zeros(shape, dtype=cache_dtype(cfg, name),
                               device=dev)
             for name, shape in cache_shapes(cfg, cfg.layer_type(i), batch,
                                             s_max, src_len).items()}
            for i in range(cfg.num_layers)]


def abstract_cache(cfg: ModelConfig, batch_size: int, s_max: int,
                   src_len: Optional[int] = None) -> List[Dict]:
    """The decode cache on the meta device: shapes and dtypes, no
    storage."""
    return init_cache(cfg, batch_size, s_max, torch.device("meta"), src_len)
