"""Sharded KV store with the paper's three get paths (the port's
``repro.kvstore.store``, steady-state gets).

* ``redn``      — §5.2: the request is routed to the owner shard, the
                  *offload chain* — a chain VM program
                  (:class:`repro_torch.core.programs.HopscotchShardServer`,
                  executed by ``ChainEngine.run_many``) — runs there, the
                  value comes back: **1 RTT**, no host involvement.
* ``one_sided`` — FaRM/Pilaf style: RDMA READ of the H-bucket neighborhood
                  metadata, client-side match, RDMA READ of the value:
                  **2 RTTs**, no host involvement.
* ``two_sided`` — RPC: request routed to the owner, the *host* performs the
                  lookup (the plain :func:`hopscotch.lookup`, which doubles
                  as the oracle of the chain program), response routed
                  back: 1 RTT + host service time.

All three return identical values on served requests.  The store's S
shards are a leading tensor dim on one device (see
:mod:`repro_torch.rdma.transport`).  Every path returns a
:class:`GetResult` whose ``ok`` mask says whether a response is
authoritative: a request dropped at the transport's capacity limit, or
deferred by ``live``, has ``ok=False`` and must never be read as a miss.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import device as device_mod
from ..core import programs
from ..rdma import transport
from . import hopscotch

_SHARD_MULT = 0x9E3779B1


def shard_of(key, n_shards: int):
    """Owner shard of a key — identical for python ints, numpy arrays and
    tensors: the key is taken as its 32-bit pattern, then
    ``((k ^ (k >> 13)) * 0x9E3779B1 mod 2^32) mod n_shards``."""
    if isinstance(key, (int, np.integer)):
        k = int(key) & 0xFFFFFFFF
        k ^= k >> 13
        return (k * _SHARD_MULT & 0xFFFFFFFF) % n_shards
    if isinstance(key, np.ndarray):
        k = key.astype(np.int64) & 0xFFFFFFFF
        k ^= k >> 13
        return ((k * _SHARD_MULT & 0xFFFFFFFF) % n_shards).astype(np.int32)
    k = key.long() & 0xFFFFFFFF
    k = (k ^ (k >> 13)) * _SHARD_MULT & 0xFFFFFFFF
    return torch.remainder(k, n_shards).to(torch.int32)


def keys_homed_at(bucket: int, count: int, n_buckets: int, start: int = 1,
                  n_shards: Optional[int] = None, shard: int = 0):
    """Brute-force enumerate 24-bit keys whose home bucket is ``bucket``
    (optionally also pinned to one owner shard)."""
    out, k = [], start
    while len(out) < count:
        if k > 0xFFFFFF:
            raise ValueError(
                f"ran out of 24-bit keys homed at bucket {bucket} "
                f"(found {len(out)}/{count} from start={start})")
        if (int(hopscotch.bucket_of(k, n_buckets)) == bucket
                and (n_shards is None
                     or int(shard_of(k, n_shards)) == shard)):
            out.append(k)
        k += 1
    return out


def _check_key_batch(arr, *, what: str, allow_zero: bool, live=None):
    """Host-side 24-bit key validation for the batched paths.

    Keys live in the chain ISA's id space (``opcode:8 | id:24``): a wider
    key's top byte would decode as an opcode once a probe READ lands it on
    a WR's control word, and a negative key aliases another key's bit
    pattern.  Rows masked dead (``live=False``) are never dispatched, so a
    sentinel there is legal and skipped.
    """
    a = arr.cpu().numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)
    lo = 0 if allow_zero else 1
    bad = (a < lo) | (a > 0xFFFFFF)
    if live is not None:
        bad &= (live.cpu().numpy() if isinstance(live, torch.Tensor)
                else np.asarray(live)).astype(bool)
    if bad.any():
        offender = a[bad].ravel()[0]
        raise ValueError(
            f"{what} keys are 24-bit chain ids"
            f"{' (0 = unused slot)' if allow_zero else ''}; "
            f"got {int(offender):#x}")


class GetResult(NamedTuple):
    """Distributed get outcome. ``found``/``values`` are authoritative only
    where ``ok`` is True — a False row was dropped (capacity) or deferred
    (``live``), *not* a miss."""
    found: torch.Tensor      # (S, B) bool
    values: torch.Tensor     # (S, B, V) int32
    ok: torch.Tensor         # (S, B) bool — response authoritative
    dropped: torch.Tensor    # (S,) int32 — capacity drops at the source
    deferred: torch.Tensor   # (S,) int32 — deferred at the source

    def __repr__(self):
        return (f"GetResult(found {int(self.found.sum())}/"
                f"{self.found.numel()}, ok {int(self.ok.sum())}/"
                f"{self.ok.numel()}, dropped={int(self.dropped.sum())}, "
                f"deferred={int(self.deferred.sum())})")


@dataclasses.dataclass
class ShardedKV:
    """Host handle: per-shard hopscotch tables (the device arrays come from
    :meth:`device_arrays`)."""
    tables: list                       # [HopscotchTable] * n_shards
    n_shards: int
    val_words: int
    neighborhood: int

    @classmethod
    def build(cls, n_shards: int, buckets_per_shard: int, val_words: int,
              neighborhood: int = 8) -> "ShardedKV":
        tables = [hopscotch.make_table(buckets_per_shard, val_words,
                                       neighborhood)
                  for _ in range(n_shards)]
        return cls(tables, n_shards, val_words, neighborhood)

    @staticmethod
    def check_key(key: int):
        """Keys live in the chain ISA's 24-bit id space, and key 0 is the
        EMPTY bucket marker."""
        if not 0 < key <= 0xFFFFFF:
            raise ValueError(f"keys are 24-bit chain ids, got {key:#x}")

    def set(self, key: int, value: Sequence[int]) -> bool:
        """Host-side set (bootstrap/tests)."""
        self.check_key(key)
        return self.tables[int(shard_of(key, self.n_shards))].insert(
            key, value)

    def device_arrays(self, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
        dev = device_mod.resolve(device)
        keys = torch.from_numpy(np.stack([t.keys for t in self.tables]))
        vals = torch.from_numpy(np.stack([t.values for t in self.tables]))
        return keys.to(dev), vals.to(dev)     # (S, B), (S, B, V)

    def sync_from_device(self, keys, vals):
        """Refresh the host tables from the authoritative device arrays."""
        kk, vv = keys.cpu().numpy(), vals.cpu().numpy()
        for s, t in enumerate(self.tables):
            t.keys = kk[s].copy()
            t.values = vv[s].copy()


# ---------------------------------------------------------------------------
# the three get paths, over all S shards at once
# ---------------------------------------------------------------------------

def _redn_get(keys, vals, queries, live, *, n_shards, capacity,
              neighborhood, val_words):
    """RedN path: the pre-posted chain VM program executes at the owner —
    1 RTT, the hash probing done by verbs, not the host."""
    dest = shard_of(queries, n_shards)
    n_buckets = keys.shape[1]
    srv = programs.build_hopscotch_server(n_buckets, val_words, neighborhood,
                                          device=keys.device)
    state = srv.device_state(keys, vals)
    payload = srv.device_payloads(queries, hopscotch.bucket_of(queries,
                                                               n_buckets))
    resp, ok = transport.triggered_chain_engine(
        srv.engine, state, srv.recv_wq, srv.resp_region, srv.resp_words,
        payload, dest, n_shards, capacity, live)
    return resp[..., 0] > 0, resp[..., 1:], ok


def _one_sided_get(keys, vals, queries, live, *, n_shards, capacity,
                   neighborhood, val_words):
    """FaRM-style: READ the neighborhood metadata, match locally, READ the
    value — 2 RTTs, and H-fold metadata amplification."""
    n_buckets = keys.shape[1]
    dest = shard_of(queries, n_shards)
    home = hopscotch.bucket_of(queries, n_buckets)

    # RTT 1: one READ of the H-bucket neighborhood (metadata)
    remote_window = torch.stack(
        [torch.roll(keys, -d, dims=1) for d in range(neighborhood)], dim=2)
    window, ok = transport.one_sided_read(remote_window, dest, home,
                                          n_shards, capacity, live)
    hit = window == queries[..., None].to(window.dtype)
    # a query of EMPTY (0) compares equal to every empty bucket
    found = hit.any(dim=-1) & (queries != hopscotch.EMPTY)
    slot = torch.argmax(hit.to(torch.int32), dim=-1).to(torch.int32)
    row = torch.remainder(home + slot, n_buckets)

    # RTT 2: fetch the value row (same dest/live -> same ok mask)
    v, _ = transport.one_sided_read(vals, dest, row, n_shards, capacity, live)
    v = v * found[..., None].to(v.dtype)
    return found, v, ok


def _two_sided_get(keys, vals, queries, live, *, n_shards, capacity,
                   neighborhood, val_words):
    """RPC: identical wire pattern to redn, but the lookup runs as a plain
    host function at each owner."""
    dest = shard_of(queries, n_shards)
    payload = queries[..., None].to(torch.int32)

    def host_lookup(reqs):
        out = []
        for s in range(n_shards):
            found, v = hopscotch.lookup(keys[s], vals[s], reqs[s, :, 0],
                                        neighborhood)
            out.append(torch.cat([found[:, None].to(torch.int32), v], dim=1))
        return torch.stack(out)

    resp, ok = transport.triggered_chain(
        host_lookup, payload, dest, n_shards, capacity, val_words + 1, live)
    return resp[..., 0] > 0, resp[..., 1:], ok


_PATHS = dict(redn=_redn_get, one_sided=_one_sided_get,
              two_sided=_two_sided_get)

# collective phases per path (the fidelity latency model reads these):
#   redn: dispatch+combine (1 RTT); one_sided: 2x(dispatch+combine);
#   two_sided: 1 RTT + host service
RTTS = dict(redn=1, one_sided=2, two_sided=1)
HOST_SERVICE = dict(redn=False, one_sided=False, two_sided=True)


def sharded_get(keys, vals, queries, method: str = "redn",
                neighborhood: int = 8, capacity: Optional[int] = None,
                live=None, *, isolation=None, exp=None, now=None,
                device=None) -> GetResult:
    """Batched distributed get over the store's S shards (steady state).

    keys: (S, n) int32 device keys array; vals: (S, n, V); queries:
    (S, B) — row s holds the requests issued at shard s.  ``live``
    (optional, (S, B) bool) is an admission mask: False requests are never
    dispatched and come back with ``ok=False`` and a ``deferred`` count.
    ``capacity`` (default B) bounds the requests each source sends to each
    destination; ``capacity=0`` drops every live request.  Runs on
    ``device`` (default CUDA; see :func:`repro_torch.device.resolve`).

    Per-client admission (``isolation=``), TTL-aware gets (``exp``/``now``)
    and the mid-resize arm (a resize state in place of ``keys``) are not
    ported yet and raise ``NotImplementedError``.
    """
    if isolation is not None:
        raise NotImplementedError(
            "admission control (isolation=) is not ported yet")
    if exp is not None or now is not None:
        raise NotImplementedError("TTL-aware gets are not ported yet")
    if not isinstance(keys, (torch.Tensor, np.ndarray)):
        raise NotImplementedError(
            "sharded_get serves a steady-state keys array; the mid-resize "
            f"arm ({type(keys).__name__}) is not ported yet")
    if method not in _PATHS:
        raise ValueError(f"unknown get method {method!r}")
    dev = device_mod.resolve(device)
    keys = torch.as_tensor(keys, device=dev).to(torch.int32)
    vals = torch.as_tensor(vals, device=dev).to(torch.int32)
    queries = torch.as_tensor(queries, device=dev).to(torch.int32)
    if live is not None:
        live = torch.as_tensor(live, device=dev).to(torch.bool)
    _check_key_batch(queries, what="query", allow_zero=True, live=live)
    n_shards = keys.shape[0]
    if queries.ndim != 2 or queries.shape[0] != n_shards:
        raise ValueError(f"queries must be (S={n_shards}, B), got "
                         f"{tuple(queries.shape)}")
    b_local = queries.shape[1]
    # an explicit capacity=0 is a legal (drop-everything) limit
    capacity = b_local if capacity is None else capacity
    if live is None:
        live = torch.ones(queries.shape, dtype=torch.bool, device=dev)
    if capacity == 0:
        return GetResult(
            found=torch.zeros(queries.shape, dtype=torch.bool, device=dev),
            values=torch.zeros(queries.shape + (vals.shape[-1],),
                               dtype=vals.dtype, device=dev),
            ok=torch.zeros(queries.shape, dtype=torch.bool, device=dev),
            dropped=live.sum(dim=1, dtype=torch.int32),
            deferred=(~live).sum(dim=1, dtype=torch.int32))

    found, v, ok = _PATHS[method](
        keys, vals, queries, live, n_shards=n_shards, capacity=capacity,
        neighborhood=neighborhood, val_words=vals.shape[-1])
    return GetResult(
        found=found, values=v, ok=ok,
        dropped=(live.sum(dim=1, dtype=torch.int32)
                 - ok.sum(dim=1, dtype=torch.int32)),
        deferred=(~live).sum(dim=1, dtype=torch.int32))


def reference_get(kv: ShardedKV, queries) -> Tuple[np.ndarray, np.ndarray]:
    """Host oracle: each query looked up in its owner shard's table with the
    plain :func:`hopscotch.lookup` (on the CPU).  Returns numpy
    ``(found (B,), values (B, V))``."""
    q = np.asarray(queries.cpu() if isinstance(queries, torch.Tensor)
                   else queries, np.int32).reshape(-1)
    out = np.zeros((len(q), kv.val_words), np.int32)
    found = np.zeros(len(q), bool)
    owner = shard_of(q, kv.n_shards)
    for s, t in enumerate(kv.tables):
        sel = np.flatnonzero(owner == s)
        if sel.size == 0:
            continue
        f, v = hopscotch.lookup(*t.as_device("cpu"), torch.from_numpy(q[sel]),
                                kv.neighborhood)
        found[sel] = f.numpy()
        out[sel] = v.numpy()
    return found, out
