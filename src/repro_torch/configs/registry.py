"""Registry: arch lookup, smoke configs, the assigned input shapes.

The four assigned input shapes (per arch):
  train_4k    : seq_len=4096,   global_batch=256   -> train_step
  prefill_32k : seq_len=32768,  global_batch=32    -> prefill_step
  decode_32k  : seq_len=32768,  global_batch=128   -> serve_step (1 token)
  long_500k   : seq_len=524288, global_batch=1     -> serve_step; only for
                sub-quadratic archs (SSM / hybrid / SWA / mostly-local).

The JAX package's ``input_specs`` (abstract shapes for its dry run) has no
counterpart here yet.
"""
from __future__ import annotations

from typing import Dict, Tuple

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
