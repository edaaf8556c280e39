"""Hopscotch hash table (paper §5.2): the host-side table and the batched
get (the port's ``repro.kvstore.hopscotch``).

Layout: open-addressed array of ``n_buckets``; a key hashing to bucket ``b``
lives within the neighborhood ``[b, b+H)`` (wrapping).  ``keys[i] == 0``
means empty.  Values are fixed-width word payloads in a parallel array,
always written full-width (zero-filled past the given words), as the chain
programs move whole rows.

:class:`HopscotchTable` holds numpy arrays on the host (the oracle and the
bootstrap set path); :func:`lookup` is the plain PyTorch batched get, the
oracle of the hopscotch kernel and of the chain get server.  A query of key
0 would compare equal to every empty bucket, so every lookup masks
``found &= query != EMPTY``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import device as device_mod

EMPTY = 0
_MULT = 2654435761

# SET outcome codes reported by the chain writer/displacer response words
# (numerically identical to repro_torch.core.programs.SET_*)
SET_UPDATED = 1              # key present in neighborhood, value rewritten
SET_INSERTED = 2             # EMPTY bucket in neighborhood CAS-claimed
SET_NEEDS_DISPLACEMENT = 3   # neighborhood full: displacer chain required
SET_DISPLACED = 4            # displacement bubbled a slot home and claimed it
SET_NEEDS_RESIZE = 5         # bounded search/bubble failed: resize required

# migration outcome codes reported by the table-growth migrator chain
MIG_MOVED = 6                # source bucket re-homed into the new frame
MIG_DISCARDED = 7            # key already in the new frame: stale copy dropped
MIG_NEEDS_DISPLACE = 8       # new-frame neighborhood full: displacer needed

# DELETE / CLOCK-sweep outcome codes
DEL_DELETED = 9              # bucket matched and vacated (key -> EMPTY)
DEL_MISS = 10                # no probe matched; table untouched
SWEEP_RECLAIMED = 11         # expired bucket vacated by the CLOCK sweeper
SWEEP_LIVE = 12              # deadline still ahead; bucket left untouched

# TTL sentinel: buckets with no deadline carry INT32_MAX
NO_TTL = 0x7FFFFFFF

# the displacer chain's bounds (the oracle stops exactly where it does)
DEFAULT_MAX_SEARCH = 16      # linear-probe window for the first EMPTY slot
DEFAULT_MAX_MOVES = 8        # bubble laps before reporting needs-resize

#: status code -> human-readable name (0 is the padded/never-dispatched slot)
STATUS_NAMES = {
    0: "UNSERVED",
    SET_UPDATED: "SET_UPDATED",
    SET_INSERTED: "SET_INSERTED",
    SET_NEEDS_DISPLACEMENT: "SET_NEEDS_DISPLACEMENT",
    SET_DISPLACED: "SET_DISPLACED",
    SET_NEEDS_RESIZE: "SET_NEEDS_RESIZE",
    MIG_MOVED: "MIG_MOVED",
    MIG_DISCARDED: "MIG_DISCARDED",
    MIG_NEEDS_DISPLACE: "MIG_NEEDS_DISPLACE",
    DEL_DELETED: "DEL_DELETED",
    DEL_MISS: "DEL_MISS",
    SWEEP_RECLAIMED: "SWEEP_RECLAIMED",
    SWEEP_LIVE: "SWEEP_LIVE",
}


def status_name(code) -> str:
    """Readable name for a status code (unknown codes pass through as
    ``status<n>``)."""
    return STATUS_NAMES.get(int(code), f"status<{int(code)}>")


def bucket_of(key, n_buckets: int):
    """Multiplicative hash ``(uint32(key) * 2654435761 mod 2^32) mod n`` for
    python ints, numpy arrays and tensors (int32 result for arrays)."""
    if isinstance(key, (int, np.integer)):
        return (key * _MULT & 0xFFFFFFFF) % n_buckets
    if isinstance(key, np.ndarray):
        k = key.astype(np.int64) & 0xFFFFFFFF
        return ((k * _MULT & 0xFFFFFFFF) % n_buckets).astype(np.int32)
    k = (key.long() & 0xFFFFFFFF) * _MULT & 0xFFFFFFFF
    return torch.remainder(k, n_buckets).to(torch.int32)


@dataclasses.dataclass
class HopscotchTable:
    keys: np.ndarray           # (n_buckets,) int32, 0 = empty
    values: np.ndarray         # (n_buckets, val_words) int32
    neighborhood: int          # H

    @property
    def n_buckets(self) -> int:
        return len(self.keys)

    def _write_row(self, i: int, value: Sequence[int]):
        """Full-width value-row write (zero-filled tail)."""
        self.values[i] = 0
        self.values[i, :len(value)] = value

    # -- host-side set paths --------------------------------------------------
    def set_fast(self, key: int, value: Sequence[int]) -> int:
        """The fast writer chain's semantics (no displacement): update the
        first match in the neighborhood (``SET_UPDATED``), else claim the
        first EMPTY bucket (``SET_INSERTED``), else report
        ``SET_NEEDS_DISPLACEMENT`` without mutating anything."""
        assert key != EMPTY
        n, H = self.n_buckets, self.neighborhood
        home = int(bucket_of(key, n))
        for d in range(H):
            i = (home + d) % n
            if self.keys[i] == key:
                self._write_row(i, value)
                return SET_UPDATED
        for d in range(H):
            i = (home + d) % n
            if self.keys[i] == EMPTY:
                self.keys[i] = key
                self._write_row(i, value)
                return SET_INSERTED
        return SET_NEEDS_DISPLACEMENT

    def set_full(self, key: int, value: Sequence[int],
                 max_search: int = DEFAULT_MAX_SEARCH,
                 max_moves: int = DEFAULT_MAX_MOVES) -> int:
        """The displacer chain's semantics — the full bounded SET.

        Update if present; else probe ``[home, home + max_search)`` for the
        first EMPTY slot; else bubble it toward the neighborhood with up to
        ``max_moves`` hopscotch moves, scanning each window ``back = H-1 ..
        1`` for the first resident whose home distance ``pad`` satisfies
        ``pad + back <= H-1``.  Vacated rows are zeroed.  A dead end returns
        ``SET_NEEDS_RESIZE`` and leaves the table bit-identical (the bubble
        is planned first and applied only on success).
        """
        assert key != EMPTY
        n, H = self.n_buckets, self.neighborhood
        home = int(bucket_of(key, n))
        for d in range(H):
            i = (home + d) % n
            if self.keys[i] == key:
                self._write_row(i, value)
                return SET_UPDATED

        free = dist = None
        for s in range(min(max_search, n)):
            i = (home + s) % n
            if self.keys[i] == EMPTY:
                free, dist = i, s
                break
        if free is None:
            return SET_NEEDS_RESIZE

        moves: List[Tuple[int, int]] = []     # (free, cand) plan
        while dist >= H:
            if len(moves) >= max_moves:
                return SET_NEEDS_RESIZE
            for back in range(H - 1, 0, -1):
                cand = (free - back) % n
                ck = int(self.keys[cand])
                if ck == EMPTY:
                    continue          # pad marker H: never movable
                pad = (cand - int(bucket_of(ck, n))) % n
                if pad + back <= H - 1:
                    moves.append((free, cand))
                    free, dist = cand, dist - back
                    break
            else:
                return SET_NEEDS_RESIZE
        for f, c in moves:
            self.keys[f] = self.keys[c]
            self.values[f] = self.values[c]
            self.keys[c] = EMPTY
            self.values[c] = 0        # vacated rows must not leak values
        self.keys[free] = key
        self._write_row(free, value)
        return SET_DISPLACED if moves else SET_INSERTED

    def insert(self, key: int, value: Sequence[int],
               max_search: int = DEFAULT_MAX_SEARCH,
               max_moves: int = DEFAULT_MAX_MOVES) -> bool:
        """Bounded hopscotch insert/update; False = needs resize (the table
        is then untouched)."""
        return self.set_full(key, value, max_search,
                             max_moves) != SET_NEEDS_RESIZE

    def as_device(self, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
        dev = device_mod.resolve(device)
        return (torch.from_numpy(self.keys).to(dev),
                torch.from_numpy(self.values).to(dev))


def make_table(n_buckets: int, val_words: int,
               neighborhood: int = 8) -> HopscotchTable:
    return HopscotchTable(np.zeros(n_buckets, np.int32),
                          np.zeros((n_buckets, val_words), np.int32),
                          neighborhood)


def lookup(keys: torch.Tensor, values: torch.Tensor, queries: torch.Tensor,
           neighborhood: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched hopscotch get — the plain PyTorch oracle.

    Returns (found: bool[B], value: int32[B, val_words]); a hit returns the
    row of the first matching bucket in the neighborhood, misses yield 0s,
    and a query of ``EMPTY`` (0) is always a miss.
    """
    n = keys.shape[0]
    home = bucket_of(queries, n)                                   # (B,)
    offs = torch.arange(neighborhood, dtype=torch.int32,
                        device=keys.device)                        # (H,)
    idx = torch.remainder(home[:, None] + offs, n)                 # (B, H)
    probed = keys[idx.long()]                                      # (B, H)
    hit = probed == queries[:, None].to(probed.dtype)
    found = hit.any(dim=1) & (queries != EMPTY)
    slot = torch.argmax(hit.to(torch.int32), dim=1)                # first hit
    rows = idx.gather(1, slot[:, None])[:, 0]                      # (B,)
    vals = values[rows.long()] * found[:, None].to(values.dtype)
    return found, vals
