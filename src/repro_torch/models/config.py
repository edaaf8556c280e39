"""Model configuration covering every assigned architecture (a copy of the
JAX package's ``models/config.py``: the port imports nothing of it).

``layer_pattern`` drives the per-layer block type: layer i is
``layer_pattern[i % pattern_len]``.  (The JAX package stacks the layers
by pattern group and scans over the groups; the port runs a plain list of
layers, and ``convert`` maps one layout onto the other.)

Block types:
  'global'     causal attention, RoPE
  'local'      causal attention, sliding window, RoPE
  'nope'       causal attention, NO positional encoding (llama4 iRoPE's
               global layers)
  'rwkv'       RWKV6 time-mix + channel-mix (attention-free)
  'recurrent'  RG-LRU temporal block (Griffin/RecurrentGemma)
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    layer_pattern: Tuple[str, ...] = ("global",)
    window: int = 0                # sliding window for 'local' layers
    qk_norm: bool = False
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0     # GLM partial rotary
    act: str = "silu"              # silu | gelu

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    capacity_factor: float = 1.25

    # attention-free / hybrid
    rwkv_head_dim: int = 64
    lru_width: int = 0

    # encoder-decoder (seamless)
    num_encoder_layers: int = 0
    cross_attention: bool = False
    encoder_seq_ratio: float = 1.0   # src_len = ratio * seq_len

    # modality frontends (STUBS per assignment: precomputed embeddings)
    frontend: str = "none"           # none | vision | audio
    frontend_tokens: int = 0         # patches/frames prepended
    frontend_dim: int = 0            # incoming embedding dim

    tie_embeddings: bool = False
    logits_softcap: float = 0.0
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"

    # numerics / memory knobs (hillclimb levers)
    remat: str = "block"             # none | block | full
    attn_impl: Optional[str] = None  # kernels' impl selection
    scan_layers: bool = True
    window_cache: bool = False       # local layers keep a rolling window-
                                     # sized cache instead of full s_max
                                     # (beyond-paper decode optimization)
    attn_gqa: str = "grouped"        # 'repeat' enables head-sharded TP
                                     # attention (the tpattn hillclimb)
    kv_quant: bool = False           # int8 KV cache with per-(b,h,pos)
                                     # scales (KIVI-style; kvquant lever)

    def __post_init__(self):
        assert self.num_heads % max(self.num_kv_heads, 1) == 0

    @property
    def pattern_len(self) -> int:
        return len(self.layer_pattern)

    @property
    def n_groups(self) -> int:
        return self.num_layers // self.pattern_len

    @property
    def n_rem(self) -> int:
        return self.num_layers % self.pattern_len

    @property
    def attn_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 512 (shardable over model axes)."""
        return ((self.vocab_size + 511) // 512) * 512

    def layer_type(self, i: int) -> str:
        return self.layer_pattern[i % self.pattern_len]

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_encdec(self) -> bool:
        return self.num_encoder_layers > 0

    @property
    def active_params(self) -> int:
        """Approximate active (per-token) parameter count (6*N*D roofline)."""
        d, f, v = self.d_model, self.d_ff, self.padded_vocab
        per_layer = 0
        for i in range(self.num_layers):
            t = self.layer_type(i)
            if t in ("global", "local", "nope"):
                per_layer += d * (self.attn_dim + 2 * self.kv_dim) \
                    + self.attn_dim * d
            elif t == "rwkv":
                # r,k,w,g,v projections + output
                per_layer += 5 * d * d + d * d
            elif t == "recurrent":
                w = self.lru_width or d
                per_layer += 2 * d * w + w * d + 2 * w  # in/gates/out + lru
            # mlp / moe active
            if self.is_moe and t != "rwkv":
                k = self.experts_per_token + self.num_shared_experts
                per_layer += k * 3 * d * f
            elif t == "rwkv":
                per_layer += 2 * d * int(f)
            else:
                per_layer += 3 * d * f
        emb = v * d * (1 if self.tie_embeddings else 2)
        enc = 0
        if self.is_encdec:
            enc = self.num_encoder_layers * (
                d * (self.attn_dim + 2 * self.kv_dim) + self.attn_dim * d
                + 3 * d * f)
            per_layer += self.num_layers * 0  # cross-attn counted below
            enc += self.num_layers * (d * (self.attn_dim + 2 * self.kv_dim)
                                      + self.attn_dim * d)
        return per_layer + emb + enc

    @property
    def total_params(self) -> int:
        if not self.is_moe:
            return self.active_params
        d, f = self.d_model, self.d_ff
        k = self.experts_per_token + self.num_shared_experts
        extra = (self.num_experts + self.num_shared_experts - k) * 3 * d * f
        return self.active_params + self.num_layers * extra
