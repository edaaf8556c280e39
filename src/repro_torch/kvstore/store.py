"""Sharded KV store with the paper's three get paths and the chain-offloaded
write path (the port's ``repro.kvstore.store``, steady state).

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
:mod:`repro_torch.rdma.transport`) or, with ``group=`` (a
``torch.distributed`` process group), blocks of ``S_local`` shards on the
group's ranks: each rank passes its block (global shard ``rank * S_local
+ local index``) and the requests its shards issue, and gets back its
block's results, bit for bit what the one-device arm gives for those
shards.  Every path returns a
:class:`GetResult` whose ``ok`` mask says whether a response is
authoritative: a request dropped at the transport's capacity limit, or
deferred by ``live``, has ``ok=False`` and must never be read as a miss.

The write path is chain-offloaded too, against the device arrays as the
source of truth: :func:`sharded_set` (the writer chain, escalating
neighborhood-full inserts to the displacer chain), :func:`sharded_delete`
(the deleter chain) and :func:`sharded_sweep` (the CLOCK sweeper chain
over a per-bucket deadline column, which TTL-aware gets also read).  The
requests against one shard are serialized, so a batch equals its host
oracle applied in order.

Concurrency and isolation: ``sharded_set(n_writers=N)`` serves each
owner's window through N racing writer lanes over the shared table, and
``sharded_get(isolation=Admission(...))`` admits each request against its
client's token bucket first (§3.5, §5.5).

Robustness: ``sharded_set(faults=)`` arms each request's writer chain with
a :class:`repro_torch.core.faults.FaultPlan` row (armed rows commit the
torn image and never escalate), and :func:`repair_bucket` is the primitive
:mod:`repro_torch.kvstore.fsck` mends torn buckets with.

Online growth: :func:`begin_resize` opens a doubled frame beside the live
one (a :class:`ResizeState`); :func:`sharded_resize` drains source buckets
through the migrator chain, quantum by quantum, behind a per-shard
watermark; ``sharded_get`` and ``sharded_set`` given the ResizeState serve
from both frames (writes routed by the watermark) until
:func:`finish_resize` adopts the doubled frame.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import device as device_mod
from ..core import faults as faults_mod
from ..core import programs
from ..core import machine
from ..rdma import isolation as isolation_mod
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

    def block(self, group=None) -> range:
        """The global shards this rank holds under ``group`` (all of them
        without one)."""
        if group is None:
            return range(self.n_shards)
        if not dist.is_initialized():
            raise RuntimeError("group= given, but no process group is "
                               "initialised")
        world = dist.get_world_size(group)
        if self.n_shards % world:
            raise ValueError(f"{self.n_shards} shards do not split over "
                             f"{world} ranks")
        n = self.n_shards // world
        rank = dist.get_rank(group)
        return range(rank * n, (rank + 1) * n)

    def device_arrays(self, device=None, group=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(keys (S, n), vals (S, n, V)) on ``device``: every shard, or
        with ``group`` this rank's block."""
        dev = device_mod.resolve(device)
        tables = [self.tables[s] for s in self.block(group)]
        keys = torch.from_numpy(np.stack([t.keys for t in tables]))
        vals = torch.from_numpy(np.stack([t.values for t in tables]))
        return keys.to(dev), vals.to(dev)     # (S, B), (S, B, V)

    def sync_from_device(self, keys, vals, group=None):
        """Refresh the host tables (with ``group``, this rank's block) from
        the authoritative device arrays."""
        kk, vv = keys.cpu().numpy(), vals.cpu().numpy()
        for i, s in enumerate(self.block(group)):
            self.tables[s].keys = kk[i].copy()
            self.tables[s].values = vv[i].copy()


# ---------------------------------------------------------------------------
# the three get paths, over all S shards at once
# ---------------------------------------------------------------------------

def _redn_get(keys, vals, queries, live, *, n_shards, capacity, group,
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
        payload, dest, n_shards, capacity, live, group=group,
        window=srv.shared_window)
    return resp[..., 0] > 0, resp[..., 1:], ok


def _redn_get_ttl(keys, vals, exp, now, queries, live, *, n_shards,
                  capacity, group, neighborhood, val_words):
    """TTL-aware redn path: the server chain built with ``ttl=True`` ADDs
    the client's negated clock onto each probed deadline and gates the
    response write on the Calc-verb compare — an expired hit quiesces
    exactly like a miss (bit-exact with :func:`hopscotch.lookup_ttl`)."""
    dest = shard_of(queries, n_shards)
    n_buckets = keys.shape[1]
    srv = programs.build_hopscotch_server(n_buckets, val_words, neighborhood,
                                          ttl=True, device=keys.device)
    state = srv.device_state(keys, vals, exp)
    payload = srv.device_payloads(
        queries, hopscotch.bucket_of(queries, n_buckets), now)
    resp, ok = transport.triggered_chain_engine(
        srv.engine, state, srv.recv_wq, srv.resp_region, srv.resp_words,
        payload, dest, n_shards, capacity, live, group=group,
        window=srv.shared_window)
    return resp[..., 0] > 0, resp[..., 1:], ok


def _one_sided_get(keys, vals, queries, live, *, n_shards, capacity, group,
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
                                          n_shards, capacity, live, group)
    hit = window == queries[..., None].to(window.dtype)
    # a query of EMPTY (0) compares equal to every empty bucket
    found = hit.any(dim=-1) & (queries != hopscotch.EMPTY)
    slot = torch.argmax(hit.to(torch.int32), dim=-1).to(torch.int32)
    row = torch.remainder(home + slot, n_buckets)

    # RTT 2: fetch the value row (same dest/live -> same ok mask)
    v, _ = transport.one_sided_read(vals, dest, row, n_shards, capacity, live,
                                    group)
    v = v * found[..., None].to(v.dtype)
    return found, v, ok


def _two_sided_get(keys, vals, queries, live, *, n_shards, capacity, group,
                   neighborhood, val_words):
    """RPC: identical wire pattern to redn, but the lookup runs as a plain
    host function at each owner."""
    dest = shard_of(queries, n_shards)
    payload = queries[..., None].to(torch.int32)

    def host_lookup(reqs):
        out = []
        for s in range(reqs.shape[0]):          # the local shards
            found, v = hopscotch.lookup(keys[s], vals[s], reqs[s, :, 0],
                                        neighborhood)
            out.append(torch.cat([found[:, None].to(torch.int32), v], dim=1))
        return torch.stack(out)

    resp, ok = transport.triggered_chain(
        host_lookup, payload, dest, n_shards, capacity, val_words + 1, live,
        group)
    return resp[..., 0] > 0, resp[..., 1:], ok


_PATHS = dict(redn=_redn_get, one_sided=_one_sided_get,
              two_sided=_two_sided_get)

# collective phases per path (the fidelity latency model reads these):
#   redn: dispatch+combine (1 RTT); one_sided: 2x(dispatch+combine);
#   two_sided: 1 RTT + host service
RTTS = dict(redn=1, one_sided=2, two_sided=1)
HOST_SERVICE = dict(redn=False, one_sided=False, two_sided=True)


class Admission(NamedTuple):
    """Per-client token-bucket admission parameters for
    :func:`sharded_get` (the §5.5 isolation stage).

    ``clients``: (S, B) int32 global client/QP ids aligned with the
    queries; ``bucket``: the :class:`repro_torch.rdma.isolation.
    BucketState` carried across calls.  Passing ``isolation=Admission(
    ...)`` admits each request against its client's bucket first —
    deferred rows are never dispatched, surface ``ok=False`` and are
    counted per shard — and makes the call return ``(GetResult, new
    BucketState)``.
    """
    clients: torch.Tensor
    bucket: isolation_mod.BucketState
    now_us: float
    rate_per_us: float
    burst: float


def _bind_args(fname: str, names: Tuple[str, ...], args, kwargs) -> dict:
    """Map a dispatcher's ``*args`` onto the selected implementation's
    parameter names (the entry points accept both modes' positional
    orders, chosen by the state argument's type)."""
    if len(args) > len(names):
        raise TypeError(
            f"{fname}: too many positional arguments "
            f"({len(args)} given, at most {len(names)}: {names})")
    bound = dict(kwargs)
    for name, val in zip(names, args):
        if name in bound:
            raise TypeError(
                f"{fname}: got multiple values for argument '{name}'")
        bound[name] = val
    return bound


def sharded_get(table_or_resize_state, *args,
                isolation: Optional[Admission] = None, device=None,
                group=None, **kwargs):
    """Batched distributed get over the store's S shards — the one serving
    entry point.  The first argument selects the store's mode:

    * a device ``keys`` array (S, n) (steady state) — followed by
      ``(vals, queries, method="redn", neighborhood=8, capacity=None,
      live=None, exp=None, now=None)``; see :func:`_get_table`.
    * a :class:`ResizeState` (mid-growth) — followed by ``(queries,
      neighborhood=8, capacity=None, live=None)``; served from the double
      frame with the watermark-gated second probe (:func:`_get_resize`).

    ``live`` (optional, (S, B) bool) is an admission mask: False requests
    are never dispatched and come back with ``ok=False`` and a
    ``deferred`` count.  ``isolation=Admission(...)`` runs the §5.5
    per-client token-bucket stage to *produce* that mask (composed with
    any explicit ``live``) and returns ``(GetResult, new BucketState)``
    instead of a bare :class:`GetResult`.  Runs on ``device`` (default
    CUDA; see :func:`repro_torch.device.resolve`).  With ``group`` the
    arrays and queries are this rank's block of shards (see the module
    docstring).
    """
    if isinstance(table_or_resize_state, ResizeState):
        bound = _bind_args(
            "sharded_get", ("queries", "neighborhood", "capacity", "live"),
            args, kwargs)
        run = _get_resize
    else:
        bound = _bind_args(
            "sharded_get", ("vals", "queries", "method", "neighborhood",
                            "capacity", "live", "exp", "now"), args, kwargs)
        run = _get_table
    bound["group"] = group
    if isolation is None:
        return run(table_or_resize_state, device=device, **bound)
    adm = isolation
    dev = device_mod.resolve(device)
    bucket = isolation_mod.BucketState(*(torch.as_tensor(a, device=dev)
                                         for a in adm.bucket))
    bucket, admitted = isolation_mod.admit(
        bucket, torch.as_tensor(adm.clients, device=dev).reshape(-1),
        adm.now_us, adm.rate_per_us, adm.burst)
    live = admitted.reshape(tuple(torch.as_tensor(bound["queries"]).shape))
    if bound.get("live") is not None:
        live = live & torch.as_tensor(bound["live"], device=dev).to(
            torch.bool)
    bound["live"] = live
    return run(table_or_resize_state, device=device, **bound), bucket


def sharded_get_isolated(keys, vals, queries, clients,
                         bucket: isolation_mod.BucketState, now_us: float,
                         rate_per_us: float, burst: float, *, device=None,
                         **kwargs) -> Tuple[GetResult,
                                            isolation_mod.BucketState]:
    """Deprecated spelling of the §5.5 isolated get — now
    ``sharded_get(..., isolation=Admission(...))``.  Thin shim, bit-exact
    with the unified path."""
    warnings.warn(
        "sharded_get_isolated is deprecated: call sharded_get(keys, vals, "
        "queries, isolation=Admission(clients, bucket, now_us, "
        "rate_per_us, burst)) instead",
        DeprecationWarning, stacklevel=2)
    return sharded_get(
        keys, vals, queries,
        isolation=Admission(clients, bucket, now_us, rate_per_us, burst),
        device=device, **kwargs)


def _world(group, dev) -> int:
    """1, or the size of ``group`` (which must carry ``dev``)."""
    return 1 if group is None else transport.check_group(group, dev)


def _get_table(keys, vals, queries, method: str = "redn",
               neighborhood: int = 8, capacity: Optional[int] = None,
               live=None, exp=None, now=None, *, device=None,
               group=None) -> GetResult:
    """Steady-state get.

    keys: (S, n) int32 device keys array; vals: (S, n, V); queries:
    (S, B) — row s holds the requests issued at shard s.  ``live``
    (optional, (S, B) bool) is an admission mask: False requests are never
    dispatched and come back with ``ok=False`` and a ``deferred`` count.
    ``capacity`` (default B) bounds the requests each source sends to each
    destination; ``capacity=0`` drops every live request.

    Passing a per-bucket deadline column ``exp`` (S, n) together with the
    clock ``now`` serves TTL-aware gets (redn path only): an expired hit
    answers as a miss, the deadline compared by the server chain.
    """
    if (exp is None) != (now is None):
        raise ValueError("TTL gets need both exp and now (or neither): "
                         f"exp given={exp is not None}, "
                         f"now given={now is not None}")
    if exp is not None and method != "redn":
        raise ValueError("TTL-aware serving is chain-only: the deadline "
                         "compare is a Calc verb in the server chain "
                         f"(method='redn'), got method={method!r}")
    if method not in _PATHS:
        raise ValueError(f"unknown get method {method!r}")
    dev = device_mod.resolve(device)
    keys = torch.as_tensor(keys, device=dev).to(torch.int32)
    vals = torch.as_tensor(vals, device=dev).to(torch.int32)
    queries = torch.as_tensor(queries, device=dev).to(torch.int32)
    if live is not None:
        live = torch.as_tensor(live, device=dev).to(torch.bool)
    _check_key_batch(queries, what="query", allow_zero=True, live=live)
    n_local = keys.shape[0]
    n_shards = n_local * _world(group, dev)
    if queries.ndim != 2 or queries.shape[0] != n_local:
        raise ValueError(f"queries must be (S={n_local}, B), got "
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

    if exp is not None:
        found, v, ok = _redn_get_ttl(
            keys, vals, torch.as_tensor(exp, device=dev).to(torch.int32),
            now, queries, live, n_shards=n_shards, capacity=capacity,
            group=group, neighborhood=neighborhood, val_words=vals.shape[-1])
    else:
        found, v, ok = _PATHS[method](
            keys, vals, queries, live, n_shards=n_shards,
            capacity=capacity, group=group, neighborhood=neighborhood,
            val_words=vals.shape[-1])
    return GetResult(
        found=found, values=v, ok=ok,
        dropped=(live.sum(dim=1, dtype=torch.int32)
                 - ok.sum(dim=1, dtype=torch.int32)),
        deferred=(~live).sum(dim=1, dtype=torch.int32))


# ---------------------------------------------------------------------------
# the chain-offloaded write path: SET (writer + displacer), DELETE, and the
# CLOCK sweeper over the TTL deadline column
# ---------------------------------------------------------------------------

class WriterFaultConflict(ValueError):
    """``sharded_set(..., n_writers=N, faults=...)``: the two arguments are
    mutually exclusive, and silently dropping either would run a different
    experiment than the caller asked for.  Fault rows address a single
    chain's WQ layout, which a racing writer group does not share."""

    def __init__(self, n_writers: int):
        self.n_writers = int(n_writers)
        super().__init__(
            f"n_writers={n_writers} and faults=... are mutually "
            f"exclusive: FaultPlan rows address one chain's WQ layout, "
            f"which the racing writer group does not share")


def _mutation_repr(name: str, result) -> str:
    """Summary ``__repr__`` of the mutation results: a status histogram by
    name (:data:`hopscotch.STATUS_NAMES`) over the served rows."""
    st = result.status.cpu().numpy()
    ok = result.ok.cpu().numpy()
    codes, counts = np.unique(st[ok.astype(bool)], return_counts=True)
    hist = ", ".join(f"{hopscotch.status_name(c)}={n}"
                     for c, n in zip(codes.tolist(), counts.tolist()))
    return (f"{name}({hist or 'no served rows'}, "
            f"ok {int(ok.sum())}/{ok.size}, "
            f"applied={int(result.applied.sum())}, "
            f"dropped={int(result.dropped.sum())}, "
            f"deferred={int(result.deferred.sum())})")


class SetResult(NamedTuple):
    """Distributed set outcome.  ``status`` is authoritative only where
    ``ok`` is True (a False row was dropped/deferred, status 0):
    ``SET_UPDATED`` (1), ``SET_INSERTED`` (2), ``SET_DISPLACED`` (4 — the
    displacer bubbled a slot into the neighborhood and claimed it) or
    ``SET_NEEDS_RESIZE`` (5 — nothing committed, the table needs to
    grow).  ``SET_NEEDS_DISPLACEMENT`` (3) is internal: every such row
    resolves within the same call.  ``applied`` acks the rows the device
    arrays absorbed."""
    status: torch.Tensor     # (S, B) int32 — the path taken per request
    applied: torch.Tensor    # (S, B) bool — committed to the device arrays
    ok: torch.Tensor         # (S, B) bool — response authoritative
    dropped: torch.Tensor    # (S,) int32
    deferred: torch.Tensor   # (S,) int32

    def __repr__(self):
        return _mutation_repr("SetResult", self)


class DeleteResult(NamedTuple):
    """Distributed delete outcome: ``DEL_DELETED`` (9 — the deleter
    chain's vacate CAS retired the bucket) or ``DEL_MISS`` (10 — no
    resident with that key), authoritative only where ``ok`` is True.
    ``applied`` acks the rows that vacated a bucket."""
    status: torch.Tensor     # (S, B) int32
    applied: torch.Tensor    # (S, B) bool — a bucket was vacated
    ok: torch.Tensor         # (S, B) bool — response authoritative
    dropped: torch.Tensor    # (S,) int32
    deferred: torch.Tensor   # (S,) int32

    def __repr__(self):
        return _mutation_repr("DeleteResult", self)


class SweepReport(NamedTuple):
    """Outcome of one :func:`sharded_sweep` quantum: per-visited-bucket
    statuses (``SWEEP_RECLAIMED`` / ``SWEEP_LIVE``), per-shard reclaim
    counts, and the advanced CLOCK hand."""
    status: torch.Tensor     # (S, count) int32
    reclaimed: torch.Tensor  # (S,) int32
    hand: torch.Tensor       # (S,) int32 — next quantum starts here

    def __repr__(self):
        return (f"SweepReport(reclaimed={int(self.reclaimed.sum())}"
                f"/{self.status.numel()}, hand={self.hand.tolist()})")


def _write_inputs(device, keys, vals, req_keys, live):
    """The write paths' arrays as int32 (bool ``live``) tensors on the
    resolved device; ``live`` defaults to all True."""
    dev = device_mod.resolve(device)
    keys = torch.as_tensor(keys, device=dev).to(torch.int32)
    vals = torch.as_tensor(vals, device=dev).to(torch.int32)
    req_keys = torch.as_tensor(req_keys, device=dev).to(torch.int32)
    live = (torch.ones(req_keys.shape, dtype=torch.bool, device=dev)
            if live is None else torch.as_tensor(live, device=dev).to(
                torch.bool))
    return dev, keys, vals, req_keys, live


def _counts(live, real, ok):
    """Per-shard ``(dropped, deferred)``: key-0 (unused) slots count as
    neither."""
    deferred = (~live & real).sum(dim=1, dtype=torch.int32)
    dropped = ((live & real).sum(dim=1, dtype=torch.int32)
               - ok.sum(dim=1, dtype=torch.int32))
    return dropped, deferred


def _writer_set(keys, vals, qk, qv, live, *, n_shards, capacity,
                neighborhood, val_words, max_steps, max_search, max_moves,
                frows=None, n_writers=1, group=None):
    """Owner-side SET serving: the pre-posted writer chain CAS-claims /
    updates buckets, each owner's requests serialized so each chain
    observes its predecessors' writes.

    ``n_writers`` > 1 partitions each owner's window into laps of that
    many **racing writer lanes** over ONE shared table image
    (:func:`repro_torch.core.programs.build_multi_writer_group`), their
    claim CASes racing under a round-robin :class:`machine.Schedule`
    (quantum 16, 8 rounds, then the drain round); laps serialize, so by
    CAS linearizability each lap equals *some* serialized order of its
    rows.

    Rows the writer answers ``SET_NEEDS_DISPLACEMENT`` re-run through the
    *displacer* chain as a second stateful stage at the same capacity:
    stage-2 live rows are a subset of stage-1's admitted rows and
    :func:`transport.rank_within_dest` ranks only live rows, so the
    re-dispatch can never drop.  Returns ``(status, ok, keys, vals)``.

    ``frows`` (optional, (S, B, FIELDS)): each request's packed fault row
    rides its payload through dispatch and arms the writer chain for that
    request (torn commit).  An *armed* row never escalates: a killed
    writer's response region still holds the pre-set
    ``SET_NEEDS_DISPLACEMENT`` default, and escalating on it would run a
    clean displacement that papers over the fault.
    """
    dest = shard_of(qk, n_shards)
    n_buckets = keys.shape[1]
    home = hopscotch.bucket_of(qk, n_buckets).reshape(-1)
    q, v = qk.reshape(-1), qv.reshape(-1, val_words)
    if n_writers > 1:
        mw = programs.build_multi_writer_group(
            n_buckets, val_words, neighborhood, n_writers,
            device=keys.device)
        payload = mw.device_payloads(q, home, v).reshape(
            qk.shape + (-1,))
        # fair interleave: quantum-16 rounds while lanes are busy, then the
        # drain round completes stragglers; fuel bounds any schedule's run
        sched = machine.Schedule.round_robin(n_writers, quantum=16,
                                             n_rounds=8, device=keys.device)
        gsteps = max(max_steps, mw.fuel)
        resp, ok, (nk, nv) = transport.triggered_chain_group(
            mw, sched, gsteps, (keys, vals), payload, dest, n_shards,
            capacity, 1, live, stage="writer-group", group=group)
    else:
        writer = programs.build_hopscotch_writer(
            n_buckets, val_words, neighborhood, device=keys.device)
        payload = writer.device_payloads(q, home, v).reshape(
            qk.shape + (-1,))
        resp, ok, (nk, nv) = transport.triggered_chain_stateful(
            writer, max_steps, (keys, vals), payload, dest, n_shards,
            capacity, 1, live, stage="writer", faults=frows, group=group)
    status = resp[..., 0]
    live2 = ok & (status == programs.SET_NEEDS_DISPLACEMENT)
    if frows is not None:
        live2 = live2 & ~faults_mod.FaultPlan.from_row(frows).active()

    if neighborhood < 2 or max_search < neighborhood:
        # geometries the displacer cannot be built for (an H=1 bubble
        # window is empty; a search window below the neighborhood probes
        # only known-full buckets): an escalated row is unplaceable, the
        # bounded oracle's SET_NEEDS_RESIZE
        return (torch.where(live2, programs.SET_NEEDS_RESIZE, status), ok,
                nk, nv)
    if group is None and not bool(live2.any()):
        # (across ranks every rank takes the displacer stage: its exchange
        # is collective)
        return status, ok, nk, nv

    # --- escalation: the displacement bubble, still on-chain --------------
    disp = programs.build_hopscotch_displacer(
        n_buckets, val_words, neighborhood, max_search, max_moves,
        device=keys.device)
    payload2 = disp.device_payloads(q, home, v).reshape(qk.shape + (-1,))
    # the displacer's budget must cover its whole unroll: `fuel` is exact
    disp_steps = max(max_steps, disp.fuel)
    resp2, ok2, (nk, nv) = transport.triggered_chain_stateful(
        disp, disp_steps, (nk, nv), payload2, dest, n_shards, capacity, 1,
        live2, stage="displacer", group=group)
    return torch.where(live2 & ok2, resp2[..., 0], status), ok, nk, nv


def relocate_exp(old_keys, old_exp, new_keys, req_keys=None,
                 req_deadlines=None, applied=None) -> torch.Tensor:
    """Re-derive a per-bucket deadline column after keys moved.

    For every bucket of ``new_keys`` (S, m): the deadline its key had in
    ``(old_keys (S, n), old_exp)`` on the same shard (the first such
    bucket), else :data:`hopscotch.NO_TTL`.  Rows of ``req_keys`` (S, B)
    with ``applied`` True then override their key's deadline with
    ``req_deadlines`` (``None`` = NO_TTL: a set without a TTL clears
    one); when a batch sets the same key twice the later request, in
    source-major row order, wins.

    The JAX reference computes this with (S, m, n) and (S, m, S*B) match
    masks; here each side is a stable sort by key and a binary search,
    the same function in O((n + m + S*B) log) per call.
    """
    empty = hopscotch.EMPTY
    s, m = new_keys.shape
    dev = new_keys.device
    pat = lambda a: a.to(torch.int64) & 0xFFFFFFFF   # noqa: E731
    shard = torch.arange(s, device=dev)[:, None] << 32
    nonempty = (new_keys != empty).reshape(-1)

    old = (pat(old_keys) + shard).reshape(-1)
    order = torch.argsort(old, stable=True)
    sorted_old = old[order]
    want = (pat(new_keys) + shard).reshape(-1)
    i = torch.searchsorted(sorted_old, want).clamp(max=old.numel() - 1)
    has_old = (sorted_old[i] == want) & nonempty
    carried = old_exp.to(torch.int32).reshape(-1)[order[i]]
    out = torch.where(has_old, carried, hopscotch.NO_TTL)
    if req_keys is None or req_keys.numel() == 0:
        return out.reshape(s, m)

    rk = req_keys.reshape(-1)
    ap = rk != empty
    if applied is not None:
        ap = ap & applied.reshape(-1)
    rd = (torch.full_like(rk, hopscotch.NO_TTL, dtype=torch.int32)
          if req_deadlines is None
          else torch.as_tensor(req_deadlines, device=dev).reshape(-1).to(
              torch.int32))
    cand = torch.where(ap, pat(rk), -1)              # -1 matches no key
    order = torch.argsort(cand, stable=True)         # ties keep row order
    sorted_req = cand[order]
    j = torch.searchsorted(sorted_req, pat(new_keys).reshape(-1),
                           right=True) - 1           # the last such row
    jc = j.clamp(min=0)
    hit = (j >= 0) & (sorted_req[jc] == pat(new_keys).reshape(-1)) \
        & nonempty
    return torch.where(hit, rd[order[jc]], out).reshape(s, m)


def sharded_set(table_or_resize_state, *args, device=None, group=None,
                **kwargs):
    """Batched chain-offloaded distributed SET — the one entry point.  The
    first argument selects the store's mode:

    * a device ``keys`` array (S, n) (steady state) — followed by
      ``(vals, set_keys, set_vals, neighborhood=8, capacity=None,
      live=None, max_steps=512, max_search=..., max_moves=...,
      faults=None, n_writers=1, exp=None, deadlines=None)``; returns
      ``(SetResult, new_keys, new_vals)``, plus the updated deadline
      column when ``exp`` is given (see :func:`_set_table`).
    * a :class:`ResizeState` (mid-growth) — followed by ``(set_keys,
      set_vals, neighborhood=8, capacity=None, live=None, max_steps=512,
      max_search=..., max_moves=...)``; watermark-routed over the double
      frame, returns ``(SetResult, new ResizeState)`` (see
      :func:`_set_resize`).

    Runs on ``device`` (default CUDA); with ``group`` on this rank's block
    of shards.
    """
    if isinstance(table_or_resize_state, ResizeState):
        bound = _bind_args(
            "sharded_set", ("set_keys", "set_vals", "neighborhood",
                            "capacity", "live", "max_steps", "max_search",
                            "max_moves"), args, kwargs)
        return _set_resize(table_or_resize_state, device=device,
                           group=group, **bound)
    bound = _bind_args(
        "sharded_set", ("vals", "set_keys", "set_vals", "neighborhood",
                        "capacity", "live", "max_steps", "max_search",
                        "max_moves", "faults", "n_writers", "exp",
                        "deadlines"), args, kwargs)
    return _set_table(table_or_resize_state, device=device, group=group,
                      **bound)


def _set_table(keys, vals, set_keys, set_vals, neighborhood: int = 8,
               capacity: Optional[int] = None, live=None,
               max_steps: int = 512,
               max_search: int = hopscotch.DEFAULT_MAX_SEARCH,
               max_moves: int = hopscotch.DEFAULT_MAX_MOVES,
               faults=None, n_writers: int = 1, exp=None, deadlines=None,
               *, device=None, group=None):
    """Steady-state SET, displacement included.

    keys: (S, n) int32 device keys array; vals: (S, n, V); set_keys:
    (S, B) int32 keys in 1..2^24-1 (0 marks an unused slot — never
    dispatched, never committed, ``ok=False``/status 0 and in neither
    counter; wider or negative live keys raise); set_vals: (S, B, V).
    Each request is routed to its owner shard, where the pre-posted
    writer chain (:func:`repro_torch.core.programs.build_hopscotch_writer`)
    match-updates or CAS-claims a bucket; rows it reports
    ``SET_NEEDS_DISPLACEMENT`` escalate to the displacer chain
    (bounded by ``max_search``/``max_moves``) in a second stage, so every
    outcome is computed by verbs against device state; only
    ``SET_NEEDS_RESIZE`` leaves a request uncommitted.  Returns
    ``(SetResult, new_keys, new_vals)``, plus the updated deadline column
    when ``exp`` (S, n) is given (TTL mode: ``deadlines`` (S, B) stamps
    each applied request's expiry, omitted means none).  The input arrays
    are not modified.

    ``faults`` (optional): a :class:`repro_torch.core.faults.FaultPlan`
    with (S, B) leaves — per-request fault injection into the writer
    stage (armed rows commit torn state and never escalate; recovery is
    :mod:`repro_torch.kvstore.fsck` plus a retry).

    ``n_writers`` > 1 partitions each owner's receive window into laps of
    ``n_writers`` racing writer lanes over the shared table (see
    :func:`_writer_set`) — the serialized path's results up to
    lap-internal serialization order (CAS linearizability), same
    ``SetResult`` contract.  Mutually exclusive with ``faults``
    (:class:`WriterFaultConflict`, raised before any other check): the
    fault rows address a single chain's WQs.
    """
    if n_writers < 1:
        raise ValueError(f"n_writers must be >= 1, got {n_writers}")
    if n_writers > 1 and faults is not None:
        raise WriterFaultConflict(n_writers)
    if deadlines is not None and exp is None:
        raise ValueError("deadlines= stamps per-request expiry into the "
                         "exp column — pass exp= (the store's deadline "
                         "state) alongside it")
    dev, keys, vals, set_keys, live = _write_inputs(device, keys, vals,
                                                    set_keys, live)
    set_vals = torch.as_tensor(set_vals, device=dev).to(torch.int32)
    _check_key_batch(set_keys, what="set", allow_zero=True, live=live)
    n_shards = keys.shape[0] * _world(group, dev)
    # the displacer's search window cannot exceed the shard's bucket count
    max_search = min(max_search, int(keys.shape[1]))
    capacity = set_keys.shape[1] if capacity is None else capacity
    real = set_keys != hopscotch.EMPTY
    live = live & real
    if capacity == 0:
        status = torch.zeros(set_keys.shape, dtype=torch.int32, device=dev)
        ok = torch.zeros(set_keys.shape, dtype=torch.bool, device=dev)
        nk, nv = keys, vals
    else:
        frows = (None if faults is None
                 else faults.as_rows().to(device=dev, dtype=torch.int32))
        status, ok, nk, nv = _writer_set(
            keys, vals, set_keys, set_vals, live, n_shards=n_shards,
            capacity=capacity, neighborhood=neighborhood,
            val_words=vals.shape[-1], max_steps=max_steps,
            max_search=max_search, max_moves=max_moves, frows=frows,
            n_writers=n_writers, group=group)
    applied = ok & ((status == programs.SET_UPDATED)
                    | (status == programs.SET_INSERTED)
                    | (status == programs.SET_DISPLACED))
    result = SetResult(status, applied, ok, *_counts(live, real, ok))
    if exp is None:
        return result, nk, nv
    # the deadline column is commit-layer state: the chains may have
    # relocated keys, so re-home it by key and stamp the applied rows'
    # own deadlines
    exp = torch.as_tensor(exp, device=dev).to(torch.int32)
    return result, nk, nv, relocate_exp(keys, exp, nk, set_keys, deadlines,
                                        applied)


def sharded_delete(keys, vals, del_keys, neighborhood: int = 8,
                   capacity: Optional[int] = None, live=None,
                   max_steps: int = 512, exp=None, *, device=None,
                   group=None):
    """Batched chain-offloaded distributed DELETE.

    del_keys: (S, B) int32 (0 marks an unused slot — never dispatched,
    status 0).  Each request routes to its owner shard, where the
    pre-posted deleter chain
    (:func:`repro_torch.core.programs.build_hopscotch_deleter`) matches
    the key across its neighborhood and on a hit retires the bucket (a
    re-read-comparand CAS ``key -> EMPTY`` plus stale-row zeroing).
    Returns ``(DeleteResult, new_keys, new_vals)``; with a deadline
    column ``exp`` (S, n), also its update (a vacated bucket's deadline
    resets to NO_TTL) as a 4th element.  Runs on ``device`` (default
    CUDA); with ``group`` on this rank's block of shards.
    """
    dev, keys, vals, del_keys, live = _write_inputs(device, keys, vals,
                                                    del_keys, live)
    _check_key_batch(del_keys, what="delete", allow_zero=True, live=live)
    n_shards, n_buckets = keys.shape
    n_shards *= _world(group, dev)
    capacity = del_keys.shape[1] if capacity is None else capacity
    real = del_keys != hopscotch.EMPTY
    live = live & real
    if capacity == 0:
        status = torch.zeros(del_keys.shape, dtype=torch.int32, device=dev)
        ok = torch.zeros(del_keys.shape, dtype=torch.bool, device=dev)
        nk, nv = keys, vals
    else:
        deleter = programs.build_hopscotch_deleter(
            n_buckets, vals.shape[-1], neighborhood, device=dev)
        payload = deleter.device_payloads(
            del_keys.reshape(-1),
            hopscotch.bucket_of(del_keys, n_buckets).reshape(-1)
        ).reshape(del_keys.shape + (-1,))
        resp, ok, (nk, nv) = transport.triggered_chain_stateful(
            deleter, max_steps, (keys, vals), payload,
            shard_of(del_keys, n_shards), n_shards, capacity, 1, live,
            stage="deleter", group=group)
        status = resp[..., 0]
    applied = ok & (status == programs.DEL_DELETED)
    result = DeleteResult(status, applied, ok, *_counts(live, real, ok))
    if exp is None:
        return result, nk, nv
    # a vacated bucket carries no deadline; the deleter never relocates
    exp = torch.as_tensor(exp, device=dev).to(torch.int32)
    return result, nk, nv, torch.where(nk == hopscotch.EMPTY,
                                       hopscotch.NO_TTL, exp)


def sharded_sweep(keys, vals, exp, hand, now, count: int = 16, *,
                  device=None, group=None):
    """Advance the CLOCK sweeper by ``count`` buckets per shard.

    Every lap is the sweeper chain
    (:func:`repro_torch.core.programs.build_clock_sweeper`) run against
    device state over a loopback QP: it reads the visited bucket's
    deadline, evaluates the expiry predicate in Calc verbs, and vacates
    an expired bucket (deadline reset to NO_TTL).  ``hand``: (S,) int32
    per-shard CLOCK hands; ``now``: the clock.  Returns ``(SweepReport,
    new_keys, new_vals, new_exp)``.  Runs on ``device`` (default CUDA).
    The sweeper is loopback: with ``group`` a rank sweeps its own block
    and exchanges nothing.
    """
    dev = device_mod.resolve(device)
    _world(group, dev)
    keys = torch.as_tensor(keys, device=dev).to(torch.int32)
    vals = torch.as_tensor(vals, device=dev).to(torch.int32)
    exp = torch.as_tensor(exp, device=dev).to(torch.int32)
    hand = torch.as_tensor(hand, device=dev).to(torch.int32)
    n = keys.shape[1]
    swp = programs.build_clock_sweeper(n, vals.shape[-1], device=dev)
    buckets = torch.remainder(hand[:, None] + torch.arange(
        count, dtype=torch.int32, device=dev), n)
    resp, (nk, nv, ne) = transport.local_chain_stateful(
        swp, swp.fuel, (keys, vals, exp), swp.device_payloads(buckets, now),
        1, stage="sweeper")
    status = resp[..., 0]
    reclaimed = (status == programs.SWEEP_RECLAIMED).sum(
        dim=1, dtype=torch.int32)
    new_hand = torch.remainder(hand + count, n).to(torch.int32)
    return SweepReport(status, reclaimed, new_hand), nk, nv, ne


# ---------------------------------------------------------------------------
# online resize: the double frame, the migrator-driven quanta, and serving
# from both frames while the watermark sweeps
# ---------------------------------------------------------------------------

class ResizeState(NamedTuple):
    """A store mid-growth: two frames serve at once.

    ``keys``/``vals`` are the old ``(S, n)`` frame, ``new_keys``/
    ``new_vals`` the doubled ``(S, 2n)`` frame, and ``watermark`` (S,)
    counts migrated source buckets per shard: buckets ``[0, w)`` have been
    drained into the new frame, buckets ``[w, n)`` still serve from the
    old frame.  Invariants the serving paths rely on:

    * a key is *writable* in exactly one frame — SETs route by watermark,
      and the only transient double residency (a key re-written into the
      new frame while its stale copy awaits migration) is resolved by the
      migrator's match-discard with the *new* frame winning;
    * a key whose entire old neighborhood is behind the watermark cannot
      be in the old frame, which gates the second get probe;
    * old-frame claims never land behind the watermark (wrap-around homes
      route to the new frame), so the watermark never re-visits a bucket.
    """
    keys: torch.Tensor        # (S, n)  old frame
    vals: torch.Tensor        # (S, n, V)
    new_keys: torch.Tensor    # (S, 2n) doubled frame
    new_vals: torch.Tensor    # (S, 2n, V)
    watermark: torch.Tensor   # (S,) int32 — buckets [0, w) migrated

    @property
    def n_buckets(self) -> int:
        return int(self.keys.shape[1])

    def to(self, device) -> "ResizeState":
        """The state's tensors on ``device`` (int32)."""
        return ResizeState(*(torch.as_tensor(a, device=device).to(
            torch.int32) for a in self))


class MigrateReport(NamedTuple):
    """Per-shard outcome counts of one :func:`sharded_resize` quantum."""
    moved: torch.Tensor       # (S,) re-homed by the migrator chain
    discarded: torch.Tensor   # (S,) stale copies dropped (new frame won)
    escalated: torch.Tensor   # (S,) placed via the new-frame displacer
    stuck: torch.Tensor       # (S,) unplaceable even displaced (watermark
    #                               parks on the first such bucket)


class ResizeStuck(RuntimeError):
    """A resize quantum made no progress: a shard's watermark is parked on
    a bucket whose resident cannot be placed in the doubled frame even by
    the bounded displacer.  Carries the parked (shard, bucket) pairs."""

    def __init__(self, shards, buckets, message: Optional[str] = None):
        self.shards = [int(s) for s in shards]
        self.buckets = [int(b) for b in buckets]
        if message is None:
            where = ", ".join(
                f"shard {s} bucket {b}"
                for s, b in zip(self.shards, self.buckets))
            message = (
                f"resize stuck: resident unplaceable in the doubled "
                f"frame even displaced ({where}); the table needs "
                f"another growth step or a larger displacement budget")
        super().__init__(message)

    @property
    def stuck(self):
        """``[(shard, bucket), ...]`` — every parked migration."""
        return list(zip(self.shards, self.buckets))


def begin_resize(keys, vals, *, device=None) -> ResizeState:
    """Open the doubled frame next to the live one (watermark 0), on
    ``device`` (default CUDA).  The bucket count must be a power of two:
    growth exposes exactly one more hash-mask bit, which is what the
    migrator chain's select branch recomputes in verbs."""
    n = int(keys.shape[1])
    if n < 1 or (n & (n - 1)):
        raise ValueError(
            f"resize needs a power-of-two bucket count, got {n}")
    dev = device_mod.resolve(device)
    keys = torch.as_tensor(keys, device=dev).to(torch.int32)
    vals = torch.as_tensor(vals, device=dev).to(torch.int32)
    s = keys.shape[0]
    return ResizeState(
        keys=keys, vals=vals,
        new_keys=keys.new_zeros((s, 2 * n)),
        new_vals=vals.new_zeros((s, 2 * n, vals.shape[-1])),
        watermark=keys.new_zeros((s,)))


def resize_done(rs: ResizeState) -> bool:
    """True once every shard's watermark has swept its whole old frame."""
    return bool(int(rs.watermark.min()) >= rs.n_buckets)


def finish_resize(rs: ResizeState) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cutover: adopt the doubled frame as *the* store.  Only legal
    once :func:`resize_done`, and the old frame must be fully drained — a
    resident left behind would silently vanish from serving, so that is
    checked, not assumed."""
    if not resize_done(rs):
        raise ValueError(
            f"resize incomplete: watermarks {rs.watermark.tolist()} < "
            f"{rs.n_buckets}")
    if bool((rs.keys != hopscotch.EMPTY).any()):
        raise RuntimeError(
            "old frame still holds residents after a full sweep — "
            "migration lost track of a bucket")
    return rs.new_keys, rs.new_vals


def _shard_rows(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a[s, idx[s]]`` for every shard: (S, n, ...) by (S, k)."""
    s = torch.arange(a.shape[0], device=a.device)[:, None]
    return a[s, idx.long()]


def sharded_resize(rs: ResizeState, step: int = 16, neighborhood: int = 8,
                   max_search: int = hopscotch.DEFAULT_MAX_SEARCH,
                   max_moves: int = hopscotch.DEFAULT_MAX_MOVES,
                   faults=None, *, device=None, group=None
                   ) -> Tuple[ResizeState, MigrateReport]:
    """Advance the migration by up to ``step`` source buckets per shard.

    Every lap is a chain run against device state over a loopback QP
    (:func:`transport.local_chain_stateful`): the migrator program from
    each shard's watermark, one source bucket a lap, and then the new
    frame's displacer for the laps that found their new neighborhood full
    (``MIG_NEEDS_DISPLACE``), whose source buckets are vacated on success.
    The watermark advances past everything that resolved and parks on the
    first stuck bucket.  Returns the advanced state and a
    :class:`MigrateReport`.  Runs on ``device`` (default CUDA).

    ``faults`` (optional): a :class:`repro_torch.core.faults.FaultPlan`
    with (S, step) leaves — lap ``i`` of the quantum runs under row ``i``
    (a shard dying at lap j is :meth:`FaultPlan.kill_lap`).  An armed lap
    commits its torn image and never escalates, and the watermark stops
    at the first lap whose fault fired: a lap on an EMPTY source bucket
    runs no chain, so its fault never fires.

    The migrator is loopback: with ``group`` a rank drains its own block
    and exchanges nothing.
    """
    dev = device_mod.resolve(device)
    _world(group, dev)
    ok, ov, nk, nv, wm = rs.to(dev)
    s, n = ok.shape
    v = ov.shape[-1]
    mig = programs.build_hopscotch_migrator(n, v, neighborhood, device=dev)
    buckets = wm[:, None] + torch.arange(step, dtype=torch.int32,
                                         device=dev)
    valid = buckets < n
    b_safe = buckets.clamp(0, n - 1)
    pay = mig.device_payloads(b_safe, ok) * valid[..., None]

    if faults is None:
        resp, (tk, tv, gk, gv) = transport.local_chain_stateful(
            mig, mig.fuel, (ok, ov, nk, nv), pay, 1, stage="migrator")
        fired = torch.zeros_like(valid)
    else:
        frows = faults.as_rows().to(device=dev, dtype=torch.int32)
        resp, (tk, tv, gk, gv) = transport.local_chain_stateful(
            mig, mig.fuel, (ok, ov, nk, nv), pay, 1, stage="migrator",
            faults=frows)
        # a fault only fires on a lap that ran a chain
        fired = (faults_mod.FaultPlan.from_row(frows).active()
                 & (pay[..., 0] != hopscotch.EMPTY))
    st = resp[..., 0]

    # an armed lap's status may be the pre-set NEEDS_DISPLACE default:
    # escalating on it would paper over the fault with a clean bubble
    esc = valid & (st == programs.MIG_NEEDS_DISPLACE) & ~fired
    ms = min(max(max_search, neighborhood), 2 * n)
    placed = torch.zeros_like(esc)
    if neighborhood >= 2 and ms >= neighborhood and bool(esc.any()):
        disp = programs.build_hopscotch_displacer(
            2 * n, v, neighborhood, ms, max_moves, device=dev)
        k_esc = _shard_rows(tk, b_safe)
        pay2 = disp.device_payloads(
            k_esc.reshape(-1), hopscotch.bucket_of(k_esc, 2 * n).reshape(-1),
            _shard_rows(tv, b_safe).reshape(-1, v)).reshape(s, step, -1)
        pay2 = pay2 * esc[..., None]
        resp2, (gk, gv) = transport.local_chain_stateful(
            disp, disp.fuel, (gk, gv), pay2, 1, stage="mig-displacer")
        st2 = resp2[..., 0]
        placed = esc & ((st2 == programs.SET_INSERTED)
                        | (st2 == programs.SET_DISPLACED)
                        | (st2 == programs.SET_UPDATED))
    # vacate the source buckets the displacer placed, scattered as the
    # JAX package scatters it: every lap writes ``placed ? EMPTY : the
    # bucket as the quantum left it`` to its clamped bucket, and where
    # laps past the frame end clamp onto the last bucket the highest lap
    # wins — it may write back a key a lower lap vacated (ROADMAP queue 3)
    if bool(placed.any()):
        lap = torch.arange(step, device=dev)
        later = ((b_safe[:, :, None] == b_safe[:, None, :])
                 & (lap[None, None, :] > lap[None, :, None])).any(-1)
        sh, j = torch.nonzero(placed & ~later, as_tuple=True)
        tk[sh, b_safe[sh, j].long()] = hopscotch.EMPTY
        tv[sh, b_safe[sh, j].long()] = 0

    stuck = esc & ~placed
    first_stuck = torch.where(stuck, buckets, n).min(dim=1).values
    first_fault = torch.where(fired & valid, buckets, n).min(dim=1).values
    new_w = torch.minimum(torch.clamp(wm + step, max=n),
                          torch.minimum(first_stuck, first_fault))

    def count(m):
        return m.sum(dim=1, dtype=torch.int32)

    return (ResizeState(tk, tv, gk, gv, new_w.to(torch.int32)),
            MigrateReport(count(st == programs.MIG_MOVED),
                          count(st == programs.MIG_DISCARDED),
                          count(placed), count(stuck)))


def _owner_watermarks(wm: torch.Tensor, group) -> torch.Tensor:
    """Every owner's watermark, in global shard order: the clients' cached
    migration progress (one all-gather across ranks)."""
    if group is None:
        return wm
    parts = [torch.empty_like(wm) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, wm, group=group)
    return torch.cat(parts)


def _get_resize(rs: ResizeState, queries, neighborhood: int = 8,
                capacity: Optional[int] = None, live=None, *,
                device=None, group=None) -> GetResult:
    """Batched distributed get against a store mid-growth (the redn
    path), served from the double frame: stage 1 is the chain server
    against the doubled frame; stage 2 re-dispatches the *misses* against
    the old frame, gated on the owner's watermark — a key whose whole old
    neighborhood is behind it cannot be in the old frame, so migrated
    keys pay a single probe.  Stage-2 lives are a subset of stage-1
    admits, so the second hop adds no drop.  Bit-exact with "lookup the
    new frame, else the old frame" on the oracle tables."""
    dev = device_mod.resolve(device)
    ok_, ov, nk, nv, wm = rs.to(dev)
    queries = torch.as_tensor(queries, device=dev).to(torch.int32)
    if live is not None:
        live = torch.as_tensor(live, device=dev).to(torch.bool)
    _check_key_batch(queries, what="query", allow_zero=True, live=live)
    n_shards, n = ok_.shape
    n_shards *= _world(group, dev)
    v = ov.shape[-1]
    capacity = queries.shape[1] if capacity is None else capacity
    if live is None:
        live = torch.ones(queries.shape, dtype=torch.bool, device=dev)
    if capacity == 0:
        return GetResult(
            found=torch.zeros(queries.shape, dtype=torch.bool, device=dev),
            values=torch.zeros(queries.shape + (v,), dtype=torch.int32,
                               device=dev),
            ok=torch.zeros(queries.shape, dtype=torch.bool, device=dev),
            dropped=live.sum(dim=1, dtype=torch.int32),
            deferred=(~live).sum(dim=1, dtype=torch.int32))
    dest = shard_of(queries, n_shards)

    srv_new = programs.build_hopscotch_server(2 * n, v, neighborhood,
                                              device=dev)
    resp1, ok1 = transport.triggered_chain_engine(
        srv_new.engine, srv_new.device_state(nk, nv), srv_new.recv_wq,
        srv_new.resp_region, srv_new.resp_words,
        srv_new.device_payloads(queries,
                                hopscotch.bucket_of(queries, 2 * n)),
        dest, n_shards, capacity, live, group=group,
        window=srv_new.shared_window)
    found1 = resp1[..., 0] > 0

    # the client caches the owners' migration progress
    h_old = hopscotch.bucket_of(queries, n)
    owner_w = _owner_watermarks(wm, group)[dest.long()]
    mig_done = ((h_old + neighborhood <= owner_w)
                & (h_old + neighborhood <= n))
    live2 = live & ok1 & ~found1 & ~mig_done

    srv_old = programs.build_hopscotch_server(n, v, neighborhood, device=dev)
    resp2, _ = transport.triggered_chain_engine(
        srv_old.engine, srv_old.device_state(ok_, ov), srv_old.recv_wq,
        srv_old.resp_region, srv_old.resp_words,
        srv_old.device_payloads(queries, h_old), dest, n_shards, capacity,
        live2, group=group, window=srv_old.shared_window)
    found2 = resp2[..., 0] > 0
    return GetResult(
        found=found1 | found2,
        values=torch.where(found1[..., None], resp1[..., 1:],
                           resp2[..., 1:]),
        ok=ok1,
        dropped=(live.sum(dim=1, dtype=torch.int32)
                 - ok1.sum(dim=1, dtype=torch.int32)),
        deferred=(~live).sum(dim=1, dtype=torch.int32))


def _set_resize(rs: ResizeState, set_keys, set_vals, neighborhood: int = 8,
                capacity: Optional[int] = None, live=None,
                max_steps: int = 512,
                max_search: int = hopscotch.DEFAULT_MAX_SEARCH,
                max_moves: int = hopscotch.DEFAULT_MAX_MOVES, *,
                device=None, group=None) -> Tuple[SetResult, ResizeState]:
    """Watermark-routed double-frame SET (up to three chain stages).

    A key whose old home bucket is behind the owner's watermark — or whose
    old neighborhood would wrap past the frame end — writes the **new**
    frame; everything else writes the **old** frame, where claims land at
    or ahead of the watermark, so a bucket is writable in exactly one
    frame at any instant.  Old-frame rows the writer answers
    ``SET_NEEDS_DISPLACEMENT`` escalate to the new-frame writer (the old
    frame never bubbles during growth), and new-frame neighborhood-full
    rows escalate to the new frame's displacer.  A key re-written into
    the new frame while its stale copy awaits migration is the intended
    transient: gets probe new-first, and the migrator discards the stale
    copy.  Returns ``(SetResult, new ResizeState)``; the watermark is
    untouched.
    """
    dev = device_mod.resolve(device)
    ok_, ov, nk, nv, wm = rs.to(dev)
    dev, _, _, set_keys, live = _write_inputs(dev, ok_, ov, set_keys, live)
    set_vals = torch.as_tensor(set_vals, device=dev).to(torch.int32)
    _check_key_batch(set_keys, what="set", allow_zero=True, live=live)
    n_shards, n = ok_.shape
    n_shards *= _world(group, dev)
    v, h = ov.shape[-1], neighborhood
    capacity = set_keys.shape[1] if capacity is None else capacity
    real = set_keys != hopscotch.EMPTY
    if capacity == 0:
        zero = torch.zeros(set_keys.shape, dtype=torch.int32, device=dev)
        return (SetResult(zero, zero.bool(), zero.bool(),
                          (live & real).sum(dim=1, dtype=torch.int32),
                          (~live & real).sum(dim=1, dtype=torch.int32)),
                rs.to(dev))
    live = live & real
    dest = shard_of(set_keys, n_shards)
    q, qv = set_keys.reshape(-1), set_vals.reshape(-1, v)
    h_old = hopscotch.bucket_of(set_keys, n)
    route_new = (h_old < _owner_watermarks(wm, group)[dest.long()]) \
        | (h_old + h > n)

    def stage(prog, carry, live_s, budget, name, home):
        pay = prog.device_payloads(q, home.reshape(-1), qv).reshape(
            set_keys.shape + (-1,))
        resp, ok_s, carry = transport.triggered_chain_stateful(
            prog, budget, carry, pay, dest,
            n_shards, capacity, 1, live_s, stage=name, group=group)
        return resp[..., 0], ok_s, carry

    # stage 1: old-frame writer (match/update or claim >= watermark)
    st1, ok1, (tk, tv) = stage(
        programs.build_hopscotch_writer(n, v, h, device=dev), (ok_, ov),
        live & ~route_new, max_steps, "mig-writer-old", h_old)
    esc1 = ok1 & (st1 == programs.SET_NEEDS_DISPLACEMENT)

    # stage 2: new-frame writer (routed + escalated rows)
    home_new = hopscotch.bucket_of(set_keys, 2 * n)
    live2 = live & (route_new | esc1)
    st2, ok2, (gk, gv) = stage(
        programs.build_hopscotch_writer(2 * n, v, h, device=dev), (nk, nv),
        live2, max_steps, "mig-writer-new", home_new)
    status = torch.where(live2 & ok2, st2, st1)
    live3 = live2 & ok2 & (st2 == programs.SET_NEEDS_DISPLACEMENT)

    ms = min(max(max_search, h), 2 * n)
    if h < 2 or ms < h:
        status = torch.where(live3, programs.SET_NEEDS_RESIZE, status)
    elif group is not None or bool(live3.any()):
        # stage 3: the displacement bubble, on the doubled frame (every
        # rank takes it across ranks: its exchange is collective)
        disp = programs.build_hopscotch_displacer(2 * n, v, h, ms,
                                                  max_moves, device=dev)
        st3, ok3, (gk, gv) = stage(disp, (gk, gv), live3,
                                   max(max_steps, disp.fuel),
                                   "mig-displacer", home_new)
        status = torch.where(live3 & ok3, st3, status)

    # a row is authoritative when every stage it needed admitted it
    okf = torch.where(route_new, ok2, torch.where(esc1, ok1 & ok2, ok1))
    okf = okf & live
    status = status * okf
    applied = okf & ((status == programs.SET_UPDATED)
                     | (status == programs.SET_INSERTED)
                     | (status == programs.SET_DISPLACED))
    return (SetResult(status.to(torch.int32), applied, okf,
                      *_counts(live, real, okf)),
            ResizeState(tk, tv, gk, gv, wm))


def sharded_get_migrating(rs: ResizeState, queries, neighborhood: int = 8,
                          capacity: Optional[int] = None, live=None, *,
                          device=None) -> GetResult:
    """Deprecated spelling of the mid-growth get — now ``sharded_get(
    resize_state, queries, ...)``.  Thin shim, bit-exact."""
    warnings.warn(
        "sharded_get_migrating is deprecated: pass the ResizeState as "
        "sharded_get's first argument instead",
        DeprecationWarning, stacklevel=2)
    return _get_resize(rs, queries, neighborhood=neighborhood,
                       capacity=capacity, live=live, device=device)


def sharded_set_migrating(rs: ResizeState, set_keys, set_vals, *,
                          device=None, **kwargs
                          ) -> Tuple[SetResult, ResizeState]:
    """Deprecated spelling of the mid-growth set — now ``sharded_set(
    resize_state, set_keys, set_vals, ...)``.  Thin shim, bit-exact."""
    warnings.warn(
        "sharded_set_migrating is deprecated: pass the ResizeState as "
        "sharded_set's first argument instead",
        DeprecationWarning, stacklevel=2)
    return _set_resize(rs, set_keys, set_vals, device=device, **kwargs)


# ---------------------------------------------------------------------------
# crash recovery primitive (fsck's repair applies its policy through this)
# ---------------------------------------------------------------------------

def repair_bucket(keys: torch.Tensor, vals: torch.Tensor, shard: int,
                  bucket: int, key: int = hopscotch.EMPTY,
                  val=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rewrite one bucket (key word + value row) of one shard's frame.

    The host-side equivalent of a vacate chain aimed at a known-torn
    bucket: recovery runs *between* serving quanta with the frame
    quiesced, so a plain update is faithful.  Defaults vacate the bucket
    (key EMPTY, zero row), the invariant fsck enforces.  Returns updated
    copies ``(keys, vals)`` on the arrays' device — either frame of a
    :class:`ResizeState` works.
    """
    keys, vals = keys.clone(), vals.clone()
    keys[shard, bucket] = int(key)
    vals[shard, bucket] = (0 if val is None else torch.as_tensor(
        val, dtype=vals.dtype, device=vals.device))
    return keys, vals


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
