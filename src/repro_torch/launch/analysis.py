"""Roofline terms of a step on the H100 (the JAX package's
``repro.launch.analysis``, the parts that read no HLO).

Three terms per (arch x shape x mesh), in seconds:

  compute    = FLOPs / (ranks * PEAK_FLOPS)       [dense bf16 tensor cores]
  memory     = bytes / (ranks * HBM_BW)           [HBM3]
  collective = collective_bytes / (ranks * LINK_BW)   [NVLink, one way]

The dry run (:mod:`repro_torch.launch.dryrun`) counts FLOPs with
``FlopCounterMode`` and collectives by kind and operand bytes with
``CommDebugMode``; :func:`model_flops` and :func:`model_bytes` are the
analytic floors beside them.
"""
from __future__ import annotations

from typing import Dict

# NVIDIA H100 SXM5 data sheet: 989.4 TFLOP/s dense BF16 tensor core
# (1,979 with sparsity), 3.35 TB/s HBM3, NVLink 4 at 900 GB/s both ways
# (450 GB/s each way) per GPU
PEAK_FLOPS = 989e12        # bf16 FLOP/s a card, dense
HBM_BW = 3.35e12           # bytes/s a card
LINK_BW = 450e9            # bytes/s a card, one direction of its NVLink


def roofline_terms(flops: float, bytes_accessed: float,
                   collective_bytes: float, chips: int) -> Dict[str, float]:
    compute = flops / (chips * PEAK_FLOPS)
    memory = bytes_accessed / (chips * HBM_BW)
    collective = collective_bytes / (chips * LINK_BW)
    terms = dict(compute_s=compute, memory_s=memory, collective_s=collective)
    dom = max(terms, key=lambda k: terms[k])
    terms["bottleneck"] = dom.replace("_s", "")
    total = max(compute, memory, collective)
    terms["roofline_fraction_compute"] = compute / total if total else 0.0
    return terms


def model_flops(cfg, kind: str, seq: int, global_batch: int) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE); decode counts one token."""
    n = cfg.active_params
    if kind == "train":
        return 6.0 * n * seq * global_batch
    if kind == "prefill":
        return 2.0 * n * seq * global_batch
    return 2.0 * n * global_batch          # decode: one token per sequence


def model_bytes(cfg, kind: str, seq: int, global_batch: int, *,
                params_bytes: float, opt_bytes: float = 0.0,
                cache_bytes: float = 0.0) -> float:
    """Analytic HBM-traffic floor (global, all ranks):
      train   - weights read fwd+bwd + grad write (3x params) + optimizer
                state read+write + activation stream (~12 accesses of the
                residual per layer: norms, qkv, mlp, residual adds);
      prefill - weights once + activations + cache write;
      decode  - weights once (the memory-bound term) + cache read/write.
    MoE: the full expert tensors stream from HBM once per step, so the
    params term uses total params.
    """
    tokens = seq * global_batch
    act = tokens * cfg.d_model * cfg.num_layers * 2.0   # bf16 residual
    if kind == "train":
        return (3.0 * params_bytes + 2.0 * opt_bytes + 12.0 * act)
    if kind == "prefill":
        return params_bytes + 8.0 * act + cache_bytes
    # decode: one token - activations negligible, cache dominates
    return params_bytes + cache_bytes + 2.0 * global_batch * cfg.d_model \
        * cfg.num_layers * 2.0
