"""Synthetic, deterministic data pipelines (the port's
``repro.data.pipeline``).

* :class:`TokenPipeline` — an infinite LM token stream with a learnable
  structure (token t+1 repeats token t on ~60% of positions), deterministic
  per (seed, step, shard): the same numpy draws as the JAX package's.
* :func:`make_lm_batch` — a whole batch as tensors on a device, with the
  frontend stubs (patch or frame embeddings).
* :func:`kv_request_stream` — zipf-distributed get/set request batches for
  the Memcached-analogue benchmarks (memtier stand-in).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from .. import device as device_mod


@dataclasses.dataclass
class TokenPipeline:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_shards: int = 1
    shard: int = 0

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """The shard-local slice of the global batch for `step`."""
        assert self.global_batch % self.n_shards == 0
        per = self.global_batch // self.n_shards
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + step) % (2 ** 31 - 1))
        toks = rng.randint(1, self.vocab_size,
                           (self.global_batch, self.seq_len + 1))
        echo = toks[:, :-1]
        mask = rng.rand(self.global_batch, self.seq_len) < 0.6
        toks[:, 1:] = np.where(mask, echo, toks[:, 1:])
        lo, hi = self.shard * per, (self.shard + 1) * per
        return {
            "tokens": toks[lo:hi, :-1].astype(np.int32),
            "targets": toks[lo:hi, 1:].astype(np.int32),
            "loss_mask": np.ones((per, self.seq_len), np.float32),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def make_lm_batch(cfg, b: int, s: int, seed: int = 0,
                  device=None) -> Dict[str, torch.Tensor]:
    """A whole batch on ``device`` (default: the card): step 0 of
    ``TokenPipeline``, and the frontend stubs from ``RandomState(seed +
    1)`` in the JAX package's order — 'frames' (B, S, frontend_dim) for an
    encoder-decoder model, 'patches' (B, frontend_tokens, frontend_dim)
    for a vision frontend, float32."""
    dev = device_mod.resolve(device)
    pipe = TokenPipeline(cfg.vocab_size, s, b, seed=seed)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in pipe.batch_at(0).items()}
    rng = np.random.RandomState(seed + 1)
    if cfg.is_encdec:
        batch["frames"] = torch.from_numpy(
            rng.randn(b, s, cfg.frontend_dim).astype(np.float32)).to(dev)
    if cfg.frontend == "vision" and cfg.frontend_tokens:
        batch["patches"] = torch.from_numpy(
            rng.randn(b, cfg.frontend_tokens, cfg.frontend_dim).astype(
                np.float32)).to(dev)
    return batch


def kv_request_stream(n_keys: int, batch: int, *, zipf_a: float = 1.1,
                      get_fraction: float = 0.9, seed: int = 0):
    """Infinite stream of (ops, keys): op 0 = get, 1 = set (memtier-ish)."""
    rng = np.random.RandomState(seed)
    while True:
        ranks = rng.zipf(zipf_a, size=batch)
        keys = ((ranks - 1) % n_keys + 1).astype(np.int32)
        ops = (rng.rand(batch) > get_fraction).astype(np.int32)
        yield ops, keys
