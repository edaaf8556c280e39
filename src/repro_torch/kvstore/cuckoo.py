"""Cuckoo hash table (MemC3-style, 2 hashes x 4-way buckets) — the variant
RedN's Memcached integration uses (§5.4, citing [24] MemC3); the port's
``repro.kvstore.cuckoo``.

The host table (:class:`CuckooTable`) is numpy; :func:`lookup` is a plain
batched gather on tensors (the JAX package computes it as plain array code
too, with no kernel).  Torch has no full uint32 arithmetic, so the tensor
hashes work in int64 on ``key & 0xFFFFFFFF``: the mask comes before the
shift, which makes ``>> 7`` the logical shift of uint32.  The Python-int
hashes keep the reference's arithmetic ``>>``, so for a negative key ``h2``
differs between the host ``insert`` and the tensor ``lookup`` exactly as it
does in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from .. import device as device_mod

EMPTY = 0
_M1 = 2654435761
_M2 = 40503
_U32 = 0xFFFFFFFF


def h1(key, n: int):
    if isinstance(key, (int, np.integer)):
        return (key * _M1 & _U32) % n
    k = key.long() & _U32
    # the int64 product may wrap; its low 32 bits are uint32's product
    return torch.remainder(k * _M1 & _U32, n).to(torch.int32)


def h2(key, n: int):
    if isinstance(key, (int, np.integer)):
        return ((key ^ (key >> 7)) * _M2 & _U32) % n
    k = key.long() & _U32
    return torch.remainder((k ^ (k >> 7)) * _M2 & _U32, n).to(torch.int32)


def kick_ways(keys, ways: int) -> np.ndarray:
    """``np.random.RandomState(k).randint(ways)`` for every key ``k`` at
    once (``ways`` a power of two, keys in [0, 2^32)).

    Seeded by an int, the legacy generator is MT19937 from
    ``init_genrand(k)``, and ``randint(ways)`` masks its first tempered
    output to ``ways - 1``; that output needs only state words 0, 1 and
    397, so the seeding recurrence runs 397 steps over all keys together
    instead of building one generator a key.
    """
    if ways & (ways - 1) or ways < 1:
        raise ValueError(f"ways must be a power of two, got {ways}")
    k = np.asarray(keys, np.int64)
    if k.size and (k.min() < 0 or k.max() > _U32):
        raise ValueError("seeds must lie in [0, 2^32)")
    u32, one = np.uint64(_U32), np.uint64(1)
    s0 = s = k.astype(np.uint64)
    for i in range(1, 398):          # state word i from word i - 1
        s = (np.uint64(1812433253) * (s ^ (s >> np.uint64(30)))
             + np.uint64(i)) & u32
        if i == 1:
            s1 = s
    y = (s0 & np.uint64(0x80000000)) | (s1 & np.uint64(0x7FFFFFFF))
    v = s ^ (y >> one) ^ np.where(y & one, np.uint64(0x9908B0DF),
                                  np.uint64(0))
    v ^= v >> np.uint64(11)
    v ^= (v << np.uint64(7)) & np.uint64(0x9D2C5680)
    v ^= (v << np.uint64(15)) & np.uint64(0xEFC60000)
    v ^= v >> np.uint64(18)
    return (v & np.uint64(ways - 1)).astype(np.int64)


@dataclasses.dataclass
class CuckooTable:
    keys: np.ndarray        # (n_buckets, ways) int32
    values: np.ndarray      # (n_buckets, ways, val_words) int32
    max_kicks: int = 64
    # key -> its eviction way, memoized draws of RandomState(key)
    kicks: dict = dataclasses.field(default_factory=dict)

    @property
    def n_buckets(self) -> int:
        return self.keys.shape[0]

    @property
    def ways(self) -> int:
        return self.keys.shape[1]

    def insert(self, key: int, value: Sequence[int]) -> bool:
        assert key != EMPTY
        n = self.n_buckets
        cur_key, cur_val = key, np.zeros(self.values.shape[-1], np.int32)
        cur_val[:len(value)] = value
        for b in (h1(key, n), h2(key, n)):      # update-in-place
            for w in range(self.ways):
                if self.keys[b, w] == key:
                    self.values[b, w] = cur_val
                    return True
        for _ in range(self.max_kicks):
            for b in (h1(cur_key, n), h2(cur_key, n)):
                for w in range(self.ways):
                    if self.keys[b, w] == EMPTY:
                        self.keys[b, w] = cur_key
                        self.values[b, w] = cur_val
                        return True
            # evict a resident from cur_key's first bucket
            b = int(h1(cur_key, n))
            w = self.kicks.get(cur_key)
            if w is None:
                w = np.random.RandomState(cur_key).randint(self.ways)
            vk, vv = int(self.keys[b, w]), self.values[b, w].copy()
            self.keys[b, w] = cur_key
            self.values[b, w] = cur_val
            cur_key, cur_val = vk, vv
        return False

    def memo_kicks(self, keys) -> None:
        """Draw the eviction way of every key in ``keys`` at once
        (:func:`kick_ways`) for later inserts: a bulk fill near capacity
        otherwise spends most of its time building one generator a kick.
        The draws are the ones ``insert`` would make."""
        k = np.asarray(keys, np.int64)
        k = k[(k >= 0) & (k <= _U32)]
        self.kicks.update(zip(k.tolist(), kick_ways(k, self.ways).tolist()))

    def as_device(self, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(keys, values)`` as int32 tensors on ``device`` (default
        CUDA, see :func:`repro_torch.device.resolve`)."""
        dev = device_mod.resolve(device)
        return (torch.from_numpy(self.keys).to(dev),
                torch.from_numpy(self.values).to(dev))


def make_table(n_buckets: int, val_words: int, ways: int = 4) -> CuckooTable:
    return CuckooTable(np.zeros((n_buckets, ways), np.int32),
                       np.zeros((n_buckets, ways, val_words), np.int32))


def lookup(keys: torch.Tensor, values: torch.Tensor,
           queries: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched cuckoo get: probe both buckets x all ways.  Returns
    ``(found (B,) bool, values (B, val_words))``, zeros where not found.
    The first hit in (bucket, way) order wins, as in the reference; a
    query of ``EMPTY`` hits any empty way and reads as found."""
    n = keys.shape[0]
    b1, b2 = h1(queries, n).long(), h2(queries, n).long()      # (B,)
    cand = torch.stack([keys[b1], keys[b2]], dim=1)             # (B, 2, W)
    vals = torch.stack([values[b1], values[b2]], dim=1)         # (B, 2, W, V)
    hit = cand == queries[:, None, None].to(cand.dtype)
    flat = hit.reshape(hit.shape[0], -1)
    found = flat.any(dim=1)
    slot = flat.to(torch.int32).argmax(dim=1)   # the first maximal index
    vflat = vals.reshape(vals.shape[0], -1, vals.shape[-1])
    out = torch.gather(vflat, 1, slot[:, None, None].expand(
        -1, 1, vflat.shape[-1]))[:, 0]
    return found, out * found[:, None].to(out.dtype)
