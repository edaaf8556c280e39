"""Registry: arch lookup, smoke configs, the assigned input shapes.

The four assigned input shapes (per arch):
  train_4k    : seq_len=4096,   global_batch=256   -> train_step
  prefill_32k : seq_len=32768,  global_batch=32    -> prefill_step
  decode_32k  : seq_len=32768,  global_batch=128   -> serve_step (1 token)
  long_500k   : seq_len=524288, global_batch=1     -> serve_step; only for
                sub-quadratic archs (SSM / hybrid / SWA / mostly-local).

``input_specs`` gives each cell's model inputs as tensors on the meta
device: shapes and dtypes, no storage.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..models import model as model_lib
from ..models.config import ModelConfig
from . import archs

ARCHS: Tuple[str, ...] = tuple(archs.CONFIGS.keys())

SHAPES: Dict[str, Dict] = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

# long-context decode applicability: window-bounded or O(1) state archs
# run; pure-full-attention archs skip.
LONG_OK = {
    "mixtral-8x7b": True,            # SWA everywhere
    "llama4-maverick-400b-a17b": False,   # NoPE layers are full-attention
    "qwen3-1.7b": False,
    "smollm-135m": False,
    "glm4-9b": False,
    "gemma3-1b": True,               # 5:1 local; global layers seq-sharded
    "seamless-m4t-medium": False,
    "phi-3-vision-4.2b": False,
    "rwkv6-7b": True,                # O(1) recurrent state
    "recurrentgemma-9b": True,       # RG-LRU + local(2048)
}


def get_config(name: str) -> ModelConfig:
    return archs.CONFIGS[name]


def smoke_config(name: str) -> ModelConfig:
    return archs.smoke_of(archs.CONFIGS[name])


def shape_supported(name: str, shape: str) -> Tuple[bool, str]:
    if shape == "long_500k" and not LONG_OK[name]:
        return False, "full-attention arch: 500k dense decode skipped"
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: str) -> Dict:
    """Meta-tensor stand-ins for every model input of this cell, under the
    JAX package's keys: {'kind', 'batch', 'seq', 'global_batch'} for train
    and prefill, {'kind', 'token', 'caches', 'lengths', 'enc_lengths',
    'seq', 'global_batch'} for decode (one new token against an s-long
    cache)."""
    info = SHAPES[shape]
    b, s = info["batch"], info["seq"]
    if info["kind"] in ("train", "prefill"):
        batch = {"tokens": _meta((b, s), torch.int32),
                 "targets": _meta((b, s), torch.int32),
                 "loss_mask": _meta((b, s), torch.bfloat16)}
        if cfg.is_encdec:
            src = int(s * cfg.encoder_seq_ratio)
            batch["frames"] = _meta((b, src, cfg.frontend_dim),
                                    torch.bfloat16)
        if cfg.frontend == "vision" and cfg.frontend_tokens:
            batch["patches"] = _meta((b, cfg.frontend_tokens,
                                      cfg.frontend_dim), torch.bfloat16)
        return dict(kind=info["kind"], batch=batch, seq=s, global_batch=b)
    return dict(
        kind="decode", token=_meta((b,), torch.int32),
        caches=model_lib.abstract_cache(cfg, b, s),
        lengths=_meta((b,), torch.int32),
        enc_lengths=_meta((b,), torch.int32) if cfg.is_encdec else None,
        seq=s, global_batch=b)
