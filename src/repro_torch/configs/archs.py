"""The 10 assigned architectures — exact public-literature configs (a copy
of the JAX package's ``configs/archs.py``).

Sources per the assignment table; every field below mirrors the assigned
spec (layers / d_model / heads / kv / d_ff / vocab / family notes).
"""
from __future__ import annotations

import dataclasses

from ..models.config import ModelConfig

CONFIGS = {}


def _reg(cfg: ModelConfig) -> ModelConfig:
    CONFIGS[cfg.name] = cfg
    return cfg


# [moe] 8 experts top-2, SWA(4096) [arXiv:2401.04088]
MIXTRAL_8X7B = _reg(ModelConfig(
    name="mixtral-8x7b", family="moe", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=8, head_dim=128, d_ff=14336,
    vocab_size=32000, layer_pattern=("local",), window=4096,
    rope_theta=1e6, num_experts=8, experts_per_token=2))

# [moe] iRoPE: 3 chunked-local(8192)+RoPE : 1 global NoPE; 128e top-1 +
# shared expert; early fusion (vision stub optional)
# [hf:meta-llama/Llama-4-*; unverified]
LLAMA4_MAVERICK = _reg(ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe", num_layers=48,
    d_model=5120, num_heads=40, num_kv_heads=8, head_dim=128, d_ff=8192,
    vocab_size=202048, layer_pattern=("local", "local", "local", "nope"),
    window=8192, rope_theta=5e5, num_experts=128, experts_per_token=1,
    num_shared_experts=1, frontend="vision", frontend_tokens=576,
    frontend_dim=1408))

# [dense] qk_norm, GQA [hf:Qwen/Qwen3-*]
QWEN3_1_7B = _reg(ModelConfig(
    name="qwen3-1.7b", family="dense", num_layers=28, d_model=2048,
    num_heads=16, num_kv_heads=8, head_dim=128, d_ff=6144,
    vocab_size=151936, layer_pattern=("global",), qk_norm=True,
    rope_theta=1e6, tie_embeddings=True))

# [dense] llama-arch small [hf:HuggingFaceTB/SmolLM-135M]
SMOLLM_135M = _reg(ModelConfig(
    name="smollm-135m", family="dense", num_layers=30, d_model=576,
    num_heads=9, num_kv_heads=3, head_dim=64, d_ff=1536, vocab_size=49152,
    layer_pattern=("global",), rope_theta=1e4, tie_embeddings=True))

# [dense] RoPE(partial 0.5), GQA kv=2 [hf:THUDM/glm-4-9b]
GLM4_9B = _reg(ModelConfig(
    name="glm4-9b", family="dense", num_layers=40, d_model=4096,
    num_heads=32, num_kv_heads=2, head_dim=128, d_ff=13696,
    vocab_size=151552, layer_pattern=("global",), rope_fraction=0.5,
    rope_theta=1e4))

# [dense] 5 local(512) : 1 global, 128k ctx, huge vocab
# [hf:google/gemma-3-1b-pt; unverified]
GEMMA3_1B = _reg(ModelConfig(
    name="gemma3-1b", family="dense", num_layers=26, d_model=1152,
    num_heads=4, num_kv_heads=1, head_dim=256, d_ff=6912,
    vocab_size=262144,
    layer_pattern=("local", "local", "local", "local", "local", "global"),
    window=512, rope_theta=1e6, act="gelu", qk_norm=True,
    tie_embeddings=True))

# [audio] enc-dec, multimodal (frontend STUB: precomputed frame embeddings)
# [arXiv:2308.11596]
SEAMLESS_M4T_MEDIUM = _reg(ModelConfig(
    name="seamless-m4t-medium", family="encdec", num_layers=12,
    d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64, d_ff=4096,
    vocab_size=256206, layer_pattern=("global",), rope_theta=1e4,
    num_encoder_layers=12, cross_attention=True, frontend="audio",
    frontend_dim=1024))

# [vlm] phi3-mini backbone + CLIP stub (patch embeddings precomputed)
# [hf:microsoft/Phi-3-vision-128k-instruct]
PHI3_VISION_4_2B = _reg(ModelConfig(
    name="phi-3-vision-4.2b", family="vlm", num_layers=32, d_model=3072,
    num_heads=32, num_kv_heads=32, head_dim=96, d_ff=8192,
    vocab_size=32064, layer_pattern=("global",), rope_theta=1e4,
    frontend="vision", frontend_tokens=576, frontend_dim=1024))

# [ssm] Finch — data-dependent decay, attention-free [arXiv:2404.05892]
RWKV6_7B = _reg(ModelConfig(
    name="rwkv6-7b", family="ssm", num_layers=32, d_model=4096,
    num_heads=64, num_kv_heads=64, head_dim=64, d_ff=14336,
    vocab_size=65536, layer_pattern=("rwkv",), rwkv_head_dim=64))

# [hybrid] RG-LRU + local attn, 1 attn : 2 recurrent [arXiv:2402.19427]
RECURRENTGEMMA_9B = _reg(ModelConfig(
    name="recurrentgemma-9b", family="hybrid", num_layers=38, d_model=4096,
    num_heads=16, num_kv_heads=1, head_dim=256, d_ff=12288,
    vocab_size=256000, layer_pattern=("recurrent", "recurrent", "local"),
    window=2048, lru_width=4096, act="gelu", rope_theta=1e4))


def smoke_of(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config: small width/depth, tiny vocab/tables."""
    p = len(cfg.layer_pattern)
    hd = 32
    heads = 4
    kv = max(1, min(cfg.num_kv_heads, 2))
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=p + min(2, p),                 # 1 group + remainder
        d_model=128, num_heads=heads, num_kv_heads=kv, head_dim=hd,
        d_ff=256, vocab_size=512,
        window=min(cfg.window, 16) if cfg.window else 0,
        num_experts=min(cfg.num_experts, 4) or 0,
        experts_per_token=min(cfg.experts_per_token, 2) or 0,
        # drop-free capacity so batched prefill == incremental decode
        # (capacity = T*k regardless of routing imbalance)
        capacity_factor=float(min(cfg.num_experts, 4) or 1),
        num_encoder_layers=2 if cfg.is_encdec else 0,
        frontend_tokens=8 if cfg.frontend != "none" else 0,
        frontend_dim=48 if cfg.frontend != "none" else 0,
        rwkv_head_dim=32,
        lru_width=128 if cfg.lru_width else 0,
        remat="none", dtype="float32")
