"""Step builders: the prefill and serve steps of the LM serving path.

The JAX package jits these closures; PyTorch runs them eagerly.  The
train step (loss, gradients, AdamW) waits for the training slice.
"""
from __future__ import annotations

from ..models import model as model_lib
from ..models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig, s_max: int):
    def prefill_step(params, batch):
        return model_lib.prefill(params, batch, cfg, s_max=s_max)
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    def serve_step(params, token, caches, lengths, enc_lengths=None):
        return model_lib.decode_step(params, token, caches, lengths, cfg,
                                     enc_lengths=enc_lengths)
    return serve_step
