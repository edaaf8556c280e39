"""Synthetic, deterministic request streams (the port's
``repro.data.pipeline``, KV part).

* :func:`kv_request_stream` — zipf-distributed get/set request batches for
  the Memcached-analogue benchmarks (memtier stand-in).
"""
from __future__ import annotations

import numpy as np


def kv_request_stream(n_keys: int, batch: int, *, zipf_a: float = 1.1,
                      get_fraction: float = 0.9, seed: int = 0):
    """Infinite stream of (ops, keys): op 0 = get, 1 = set (memtier-ish)."""
    rng = np.random.RandomState(seed)
    while True:
        ranks = rng.zipf(zipf_a, size=batch)
        keys = ((ranks - 1) % n_keys + 1).astype(np.int32)
        ops = (rng.rand(batch) > get_fraction).astype(np.int32)
        yield ops, keys
