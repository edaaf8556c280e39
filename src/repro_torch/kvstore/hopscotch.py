"""Hopscotch hash table (paper §5.2): the host-side table and the batched
get (the port's ``repro.kvstore.hopscotch``).

Layout: open-addressed array of ``n_buckets``; a key hashing to bucket ``b``
lives within the neighborhood ``[b, b+H)`` (wrapping).  ``keys[i] == 0``
means empty.  Values are fixed-width word payloads in a parallel array,
always written full-width (zero-filled past the given words), as the chain
programs move whole rows.

:class:`HopscotchTable` holds numpy arrays on the host (the oracles and the
bootstrap set path); :func:`lookup` is the plain PyTorch batched get, the
oracle of the hopscotch kernel and of the chain get server, and
:func:`lookup_ttl` its TTL-aware form.  :func:`insert_many`,
:func:`insert_many_displaced`, :func:`delete_many` and
:func:`sweep_expired` are the host oracles of the write-side chains
(writer, writer + displacer, deleter, CLOCK sweeper): the batch applied in
order.  A query of key
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

    def delete(self, key: int) -> int:
        """The deleter chain's semantics: on a match in the neighborhood
        vacate the bucket (key -> ``EMPTY``, value row zeroed) and return
        ``DEL_DELETED``; otherwise ``DEL_MISS``, the table untouched."""
        assert key != EMPTY
        n, H = self.n_buckets, self.neighborhood
        home = int(bucket_of(key, n))
        for d in range(H):
            i = (home + d) % n
            if self.keys[i] == key:
                self.keys[i] = EMPTY
                self.values[i] = 0
                return DEL_DELETED
        return DEL_MISS

    # -- host-side online-resize oracle ---------------------------------------
    def migrate_bucket(self, new: "HopscotchTable", bucket: int) -> int:
        """Re-home one source bucket into the doubled frame — the semantics
        of one migrator-chain lap
        (``repro_torch.core.programs.build_hopscotch_migrator``).

        A key already in the new frame (re-written there while this stale
        copy waited) only vacates the source bucket (``MIG_DISCARDED``:
        the newer value wins); else the first EMPTY bucket of the new
        neighborhood is claimed and the value row moves across
        (``MIG_MOVED``).  A full new neighborhood leaves both frames
        untouched (``MIG_NEEDS_DISPLACE``); an EMPTY source bucket is a
        no-op (status 0).
        """
        k = int(self.keys[bucket])
        if k == EMPTY:
            return 0
        hn = int(bucket_of(k, new.n_buckets))
        H, nn = new.neighborhood, new.n_buckets
        for d in range(H):
            i = (hn + d) % nn
            if new.keys[i] == k:
                self.keys[bucket] = EMPTY
                self.values[bucket] = 0
                return MIG_DISCARDED
        for d in range(H):
            i = (hn + d) % nn
            if new.keys[i] == EMPTY:
                new.keys[i] = k
                new.values[i] = self.values[bucket]
                self.keys[bucket] = EMPTY
                self.values[bucket] = 0
                return MIG_MOVED
        return MIG_NEEDS_DISPLACE

    def grow(self, max_search: int = DEFAULT_MAX_SEARCH,
             max_moves: int = DEFAULT_MAX_MOVES,
             step: int = 1) -> "HopscotchTable":
        """Full-table growth oracle: drain this table into a doubled one.

        Replays the migration as ``store.sharded_resize`` drives it:
        source buckets in quanta of ``step``, each through
        :meth:`migrate_bucket`, and every ``MIG_NEEDS_DISPLACE`` lap of a
        quantum escalated *after* that quantum's sweep through the bounded
        :meth:`set_full` on the new frame (a failed escalation raises and
        commits nothing).  On return this table is empty and the returned
        doubled table holds every entry.  Needs a power-of-two bucket
        count.
        """
        n = self.n_buckets
        if n < 1 or (n & (n - 1)):
            raise ValueError(
                f"resize needs a power-of-two bucket count, got {n}")
        new = HopscotchTable(np.zeros(2 * n, np.int32),
                             np.zeros((2 * n,) + self.values.shape[1:],
                                      np.int32), self.neighborhood)
        bounded_search = min(max(max_search, self.neighborhood), 2 * n)
        for q0 in range(0, n, step):
            pending = []
            for b in range(q0, min(q0 + step, n)):
                if self.migrate_bucket(new, b) == MIG_NEEDS_DISPLACE:
                    pending.append(b)
            for b in pending:
                k = int(self.keys[b])
                st2 = new.set_full(k, self.values[b].tolist(),
                                   bounded_search, max_moves)
                if st2 == SET_NEEDS_RESIZE:
                    raise RuntimeError(
                        f"growth escalation dead-ended on key {k} "
                        f"(bucket {b}) — the doubled frame cannot "
                        "place it within the bounded bubble")
                self.keys[b] = EMPTY
                self.values[b] = 0
        return new

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


def _i32(x) -> np.int32:
    """A python int or int32 as numpy int32 (its 32-bit pattern)."""
    return np.array(int(x) & 0xFFFFFFFF, np.uint32).astype(np.int32)


def lookup_ttl(keys: torch.Tensor, values: torch.Tensor, exp: torch.Tensor,
               queries: torch.Tensor, now, neighborhood: int,
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`lookup` with the TTL server chain's semantics: a hit whose
    deadline has lapsed (``exp[row] - now <= 0``, in wrapping int32, as
    the chain's Calc verbs compute it) is a miss with a zero value row.
    Buckets with no deadline carry :data:`NO_TTL`."""
    n = keys.shape[0]
    home = bucket_of(queries, n)
    offs = torch.arange(neighborhood, dtype=torch.int32, device=keys.device)
    idx = torch.remainder(home[:, None] + offs, n)
    hit = keys[idx.long()] == queries[:, None].to(keys.dtype)
    found = hit.any(dim=1) & (queries != EMPTY)
    slot = torch.argmax(hit.to(torch.int32), dim=1)
    rows = idx.gather(1, slot[:, None])[:, 0].long()
    now32 = torch.as_tensor(_i32(now), device=keys.device)
    found = found & ((exp[rows].to(torch.int32) - now32) > 0)
    vals = values[rows] * found[:, None].to(values.dtype)
    return found, vals


def insert_many(table: HopscotchTable, keys, values) -> np.ndarray:
    """Batched host insert oracle with the fast writer chain's semantics:
    the batch applied *in order* through :meth:`HopscotchTable.set_fast`
    (needs-displacement rows leave the table untouched); returns the
    per-request status codes."""
    return np.asarray(
        [table.set_fast(int(k), [int(x) for x in np.asarray(v)])
         for k, v in zip(np.asarray(keys).tolist(), values)], np.int32)


def insert_many_displaced(table: HopscotchTable, keys, values,
                          max_search: int = DEFAULT_MAX_SEARCH,
                          max_moves: int = DEFAULT_MAX_MOVES) -> np.ndarray:
    """The two-stage escalation oracle of ``store.sharded_set``: every
    request through the fast writer in order, then every
    ``SET_NEEDS_DISPLACEMENT`` row through the bounded displacer
    (:meth:`HopscotchTable.set_full`) in order; returns the merged
    statuses."""
    ks = np.asarray(keys)
    vals = [np.asarray(v) for v in values]
    st = insert_many(table, ks, vals)
    for i in np.where(st == SET_NEEDS_DISPLACEMENT)[0]:
        st[i] = table.set_full(
            int(ks[i]), [int(x) for x in vals[i]], max_search, max_moves)
    return st


def delete_many(table: HopscotchTable, keys) -> np.ndarray:
    """Batched host delete oracle: the batch applied *in order* through
    :meth:`HopscotchTable.delete`; returns the per-request statuses."""
    return np.asarray([table.delete(int(k))
                       for k in np.asarray(keys).tolist()], np.int32)


def sweep_expired(table: HopscotchTable, exp: np.ndarray, now: int,
                  start: int, count: int) -> Tuple[np.ndarray, np.ndarray]:
    """CLOCK-sweeper oracle: ``count`` buckets from the hand at ``start``
    (wrapping).  A visited bucket whose deadline has lapsed (``exp[b] -
    now <= 0`` in wrapping int32, as the sweeper chain's Calc verbs
    compute it) is vacated — key -> ``EMPTY``, value row zeroed, deadline
    reset to :data:`NO_TTL`; live buckets are untouched (an EMPTY bucket
    with a lapsed deadline is reclaimed too).  Returns ``(statuses,
    exp)``: per-visited-bucket ``SWEEP_RECLAIMED`` / ``SWEEP_LIVE`` and the
    updated deadline column."""
    exp = np.array(exp, np.int32, copy=True)
    st = np.zeros(count, np.int32)
    n = table.n_buckets
    with np.errstate(over="ignore"):
        for j in range(count):
            b = (start + j) % n
            if exp[b] - _i32(now) <= 0:
                table.keys[b] = EMPTY
                table.values[b] = 0
                exp[b] = NO_TTL
                st[j] = SWEEP_RECLAIMED
            else:
                st[j] = SWEEP_LIVE
    return st, exp
