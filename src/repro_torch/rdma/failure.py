"""Failure resiliency (paper §5.6), the port's ``repro.rdma.failure``.

The paper's trick: RDMA resources live in an "empty hull" parent process,
so the NIC keeps executing pre-posted recycled chains when the Memcached
child (or the whole OS) dies.  Here the serving state — the recycled chain
VM state, the hash table, the response regions — lives in *device
tensors* owned by :class:`DeviceResidentService` and
:class:`ShardedKVService`; the *host driver* (config, logging) is a
disposable Python object.  Crashing and restarting the driver touches no
device state, so gets — and, on the sharded store, every chain-offloaded
set, delete, sweep and resize quantum — keep being served with zero
recovery time; a cold restart would rebuild the table and re-post chains
(the multi-second gap of Fig. 16).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import device as device_mod
from ..core import faults as faults_mod
from ..core import programs
from ..kvstore import fsck
from ..kvstore import store as kv_store


class ChainInterrupted(RuntimeError):
    """A chain-offloaded request could not be completed within the
    recovery retry budget: every attempt either faulted or came back with
    a non-terminal status, and fsck + repair + re-issue did not converge.
    Carries the key, the attempt count, the last status observed and
    whether the store was left fsck-clean.  Distinct from
    :class:`repro_torch.kvstore.store.ResizeStuck` (a capacity dead end,
    not an interrupted chain)."""

    def __init__(self, key: int, attempts: int, last_status: int,
                 fsck_clean: bool):
        self.key = int(key)
        self.attempts = int(attempts)
        self.last_status = int(last_status)
        self.fsck_clean = bool(fsck_clean)
        super().__init__(
            f"set of key {self.key:#x} interrupted and unrecovered after "
            f"{self.attempts} attempts (last status {self.last_status}, "
            f"fsck {'clean' if fsck_clean else 'NOT clean'})")


class HostDriver:
    """Host-side, crash-prone state (the 'Memcached process')."""

    def __init__(self):
        self.config = {"name": "memcached-redn", "pid": id(self)}
        self.log: list = []
        self.alive = True

    def crash(self):
        self.alive = False
        self.config = None
        self.log = None


class _HostDriverLifecycle:
    """Shared §5.6 crash/restart semantics for services whose dataclasses
    declare ``driver``/``bootstrap_s``/``rebuild_s`` fields: killing the
    driver never touches device state, so serving continues; a restart is
    instant; the cold numbers are what a vanilla server would pay."""

    def crash_host(self):
        """Kill the host process. Device chains keep running (§5.6)."""
        if self.driver is not None:
            self.driver.crash()
        self.driver = None

    def restart_host(self):
        """Restart the driver: instant, because device state is intact."""
        self.driver = HostDriver()

    def host_alive(self) -> bool:
        return self.driver is not None and self.driver.alive

    def cold_restart_downtime_s(self) -> float:
        """What a vanilla (non-offloaded) server would pay after a crash:
        the model constants ``bootstrap_s + rebuild_s``."""
        return self.bootstrap_s + self.rebuild_s


# Fig. 16's vanilla-restart model: ~1 s to boot the process and ~1.25 s
# to rebuild its metadata and hash table.  These are the paper's figures,
# used as model constants; nothing here measures them.
BOOTSTRAP_S = 1.0
REBUILD_S = 1.25

TERMINAL_SET = (programs.SET_UPDATED, programs.SET_INSERTED,
                programs.SET_DISPLACED)


@dataclasses.dataclass
class DeviceResidentService(_HostDriverLifecycle):
    """Device-resident serving state (the §3.4 recycled get server):
    survives host driver crashes."""
    server: programs.RecycledGetServer
    driver: Optional[HostDriver]
    bootstrap_s: float = BOOTSTRAP_S   # vanilla restart cost (model)
    rebuild_s: float = REBUILD_S       # + metadata/hashtable rebuild (model)

    @classmethod
    def start(cls, items, n_buckets: int = 64, val_len: int = 2,
              mem_words: int = 4096, device=None):
        srv = programs.build_recycled_get_server(
            n_buckets, val_len, mem_words, device=device_mod.resolve(device))
        for k, v in items:
            srv.insert(k, v)
        srv.load()
        return cls(server=srv, driver=HostDriver())

    # -- the serving path (pure device state) --------------------------------
    def get(self, key: int) -> np.ndarray:
        return self.server.serve(key)

    def get_many(self, keys) -> np.ndarray:
        """Batched serving path: the key stream flows through the
        recycled chain (``ChainEngine.serve_stream``) — the same answers,
        laps and all, as N :meth:`get` calls.  Works with the driver
        dead, same as :meth:`get`."""
        return self.server.serve_many(keys)


def _as_rows(a, device, dtype=torch.int32) -> torch.Tensor:
    """``a`` as a tensor on ``device``; a 1-D batch becomes one row."""
    t = torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor)
                        else a, device=device).to(dtype)
    return t[None] if t.ndim == 1 else t


@dataclasses.dataclass
class ShardedKVService(_HostDriverLifecycle):
    """The §5.6 story at store scale: the *sharded* store's serving state —
    device tensors plus the pre-posted per-shard chain programs — is
    device-resident; the host driver is a disposable Python object.  Kill
    the driver and sharded gets and every SET path — update,
    in-neighborhood insert and hopscotch displacement — keep executing
    their chain programs with zero recovery time.  Only a
    ``SET_NEEDS_RESIZE`` answer (table genuinely full) needs more, and
    with ``auto_resize`` that too is chain work: the service grows the
    table online.

    The S shards live on one device as a leading dim (the tensors'
    device is the service's); ``axis`` names the serving axis for a
    reader, as the JAX package's mesh axis does.
    """
    kv: "kv_store.ShardedKV"       # host handle (bootstrap/geometry only)
    axis: str
    keys: torch.Tensor             # (S, n) int32
    vals: torch.Tensor             # (S, n, V) int32
    driver: Optional[HostDriver]
    bootstrap_s: float = BOOTSTRAP_S
    rebuild_s: float = REBUILD_S
    # -- online growth (resize while serving) --------------------------------
    resize: Optional["kv_store.ResizeState"] = None
    auto_resize: bool = True       # SET_NEEDS_RESIZE escalates to growth
    resize_quantum: int = 16       # buckets migrated per serving call
    resizes_completed: int = 0
    # -- crash-consistent retry (interrupted chains, not dead drivers) -------
    retry_budget: int = 4          # re-issues before ChainInterrupted
    backoff_base_s: float = 1e-4   # first retry delay (doubles per attempt)
    backoff_cap_s: float = 0.05    # exponential backoff ceiling
    repairs_applied: int = 0       # fsck repairs across the service lifetime
    # -- concurrent serving (racing writer QPs over shared shard state) ------
    n_writers: int = 1             # writer lanes per shard on the SET path
    # -- full lifecycle (DELETE + TTL eviction; Memcached parity) ------------
    exp: Optional[torch.Tensor] = None   # (S, n) deadlines, None = no TTL
    sweep_hand: Optional[torch.Tensor] = None   # (S,) CLOCK hand per shard
    deletes_applied: int = 0       # buckets vacated by the deleter chain
    sweeps_reclaimed: int = 0      # buckets reclaimed by the sweeper chain
    chained_growths: int = 0       # 2n frames that dead-ended into a 4n one
    # resize-window TTL bookkeeping (commit-layer, host-held): the frame
    # snapshot the exp column is aligned to, and deadlines stamped while
    # the frames were doubled — folded back at cutover
    _exp_keys: Optional[torch.Tensor] = None
    _pending_deadlines: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def start(cls, items: Sequence[Tuple[int, Sequence[int]]],
              n_shards: int = 1, buckets_per_shard: int = 128,
              val_words: int = 2, axis: str = "kv", ttl: bool = False,
              device=None) -> "ShardedKVService":
        """Bootstrap a store from ``items`` through the host tables and
        serve it from ``device`` (default CUDA)."""
        dev = device_mod.resolve(device)
        kv = kv_store.ShardedKV.build(n_shards, buckets_per_shard, val_words)
        for k, v in items:
            if not kv.set(int(k), list(v)):
                # the bounded host insert mirrors the chain's search/move
                # budget — a failure here would silently drop the item
                raise ValueError(
                    f"bootstrap insert of key {int(k)} needs a resize "
                    f"(buckets_per_shard={buckets_per_shard} too tight "
                    "for this item set)")
        keys, vals = kv.device_arrays(dev)
        svc = cls(kv=kv, axis=axis, keys=keys, vals=vals,
                  driver=HostDriver())
        if ttl:
            # bootstrap items carry no TTL; deadlines arrive with
            # set_many(..., deadlines=...)
            svc.exp = torch.full(keys.shape, programs.NO_TTL,
                                 dtype=torch.int32, device=dev)
            svc.sweep_hand = torch.zeros(keys.shape[0], dtype=torch.int32,
                                         device=dev)
        return svc

    @property
    def device(self) -> torch.device:
        return self.keys.device

    # -- the serving path (pure device state) --------------------------------
    def get_many(self, queries, now=None, **kwargs) -> "kv_store.GetResult":
        """Sharded redn gets: chain programs execute at the owner shards.
        Works with the driver dead.  While a resize is in flight the store
        serves from the double frame and each call also advances the
        migration by one quantum — the serving traffic drives the growth.

        ``now`` (TTL services only): the clock.  Steady state, the GET
        server chain evaluates the expiry compare in verbs.  During a
        resize window the double-frame server has no deadline column, so
        expired hits are filtered host-side from the parked deadline
        snapshot (a commit-layer stopgap bounded by the resize window)."""
        q = _as_rows(queries, self.device)
        if self.resize is not None:
            res = kv_store.sharded_get(self.resize, q, device=self.device,
                                       **kwargs)
            self._advance_resize()
            if self.exp is not None and now is not None:
                res = self._filter_expired(res, q, now)
            return res
        if self.exp is not None and now is not None:
            kwargs = dict(kwargs, exp=self.exp, now=now)
        return kv_store.sharded_get(self.keys, self.vals, q, method="redn",
                                    device=self.device, **kwargs)

    def _filter_expired(self, res, q, now):
        """Resize-window TTL stopgap: mask expired hits host-side."""
        deadlines = self._deadline_map()
        if not deadlines:
            return res
        qn = q.cpu().numpy()
        expired = np.zeros(qn.shape, bool)
        for k, d in deadlines.items():
            if d != programs.NO_TTL and d - int(now) <= 0:
                expired |= qn == k
        if not expired.any():
            return res
        keep = torch.from_numpy(~expired).to(self.device)
        return kv_store.GetResult(
            res.found & keep, torch.where(keep[..., None], res.values, 0),
            res.ok, res.dropped, res.deferred)

    def _deadline_map(self) -> dict:
        """key -> deadline as of the resize window (snapshot + stamps)."""
        out = {}
        if self._exp_keys is not None:
            kn = self._exp_keys.cpu().numpy()
            en = self.exp.cpu().numpy()
            mask = kn != 0
            out.update(zip(kn[mask].tolist(), en[mask].tolist()))
        out.update(self._pending_deadlines)
        return out

    def set_many(self, set_keys, set_vals, deadlines=None,
                 **kwargs) -> "kv_store.SetResult":
        """Batched chain-offloaded sets: the writer chains execute at the
        owner shards against the device tensors, and neighborhood-full
        rows escalate to the displacer chain in the same call.  Works
        with the driver dead.

        A ``SET_NEEDS_RESIZE`` answer, with ``auto_resize``, opens the
        doubled frame (:func:`repro_torch.kvstore.store.begin_resize`),
        re-issues exactly the unplaced rows through the double-frame path
        and continues the migration on every later serving call.

        With ``n_writers`` > 1 the steady-state path serves each shard's
        window through that many racing writer lanes; the resize path
        stays serialized, and combining the race with ``faults=`` raises
        :class:`repro_torch.kvstore.store.WriterFaultConflict`.

        ``deadlines`` (TTL services only): (S, B) int32 absolute expiry
        deadlines aligned with ``set_keys``; ``None`` stamps NO_TTL (a set
        without a TTL clears a previous one, as in Memcached).
        """
        qk = _as_rows(set_keys, self.device)
        qv = torch.as_tensor(np.asarray(set_vals)
                             if not isinstance(set_vals, torch.Tensor)
                             else set_vals, device=self.device).to(
                                 torch.int32)
        if qv.ndim == 2:
            qv = qv[None]
        if self.resize is not None:
            res, self.resize = kv_store.sharded_set(
                self.resize, qk, qv, device=self.device, **kwargs)
            self._advance_resize()
            self._stamp_pending(res.applied, qk, deadlines)
            return res
        if self.n_writers > 1:
            if kwargs.get("faults") is not None:
                raise kv_store.WriterFaultConflict(self.n_writers)
            kwargs = dict(kwargs, n_writers=self.n_writers)
        if self.exp is not None:
            res, self.keys, self.vals, self.exp = kv_store.sharded_set(
                self.keys, self.vals, qk, qv, exp=self.exp,
                deadlines=deadlines, device=self.device, **kwargs)
        else:
            res, self.keys, self.vals = kv_store.sharded_set(
                self.keys, self.vals, qk, qv, device=self.device, **kwargs)
        if not self.auto_resize:
            return res
        # reading the statuses is a host sync: the control flow needs it
        needs = res.status == programs.SET_NEEDS_RESIZE
        if not bool(needs.any()):
            return res
        # --- auto-escalation: grow, then land the unplaced rows ----------
        self._park_exp()
        self.resize = kv_store.begin_resize(self.keys, self.vals,
                                            device=self.device)
        # needs-resize rows were necessarily live/admitted, so the retry
        # mask subsumes any caller admission mask
        rekw = {k: v for k, v in kwargs.items()
                if k not in ("live", "n_writers")}
        res2, self.resize = kv_store.sharded_set(
            self.resize, qk, qv, live=needs, device=self.device, **rekw)
        self._stamp_pending(res2.applied, qk, deadlines)
        self._advance_resize()
        return kv_store.SetResult(
            torch.where(needs, res2.status, res.status), res.applied
            | res2.applied, torch.where(needs, res2.ok, res.ok),
            res.dropped + res2.dropped, res.deferred)

    # -- resize-window TTL bookkeeping (commit-layer, host-held) -------------
    def _park_exp(self):
        """Snapshot the frame the exp column is aligned to: keys keep their
        identity across migration and displacement, so the deadlines are
        re-derived by key at cutover (:func:`kv_store.relocate_exp`)."""
        if self.exp is not None and self._exp_keys is None:
            self._exp_keys = self.keys

    def _stamp_pending(self, applied, qk, deadlines):
        """Record deadlines stamped while the frames were doubled; the
        cutover folds them over the relocated column (last write wins,
        None clears)."""
        if self.exp is None:
            return
        kn = qk.cpu().numpy()
        dn = None if deadlines is None else np.asarray(
            deadlines.cpu() if isinstance(deadlines, torch.Tensor)
            else deadlines)
        for s, b in np.argwhere(applied.cpu().numpy()):
            self._pending_deadlines[int(kn[s, b])] = (
                programs.NO_TTL if dn is None else int(dn[s, b]))

    # -- the delete path: deleter chain at the owner shards ------------------
    def delete_many(self, del_keys, **kwargs) -> "kv_store.DeleteResult":
        """Batched chain-offloaded DELETEs: the deleter chain matches the
        key across its neighborhood and retires the bucket with the
        re-read-comparand vacate CAS.  Works with the driver dead.

        While a resize is in flight the delete runs against **both**
        frames: vacating only the live copy would leave a stale old-frame
        resident for the migrator to re-home — resurrecting the deleted
        key at cutover."""
        qk = _as_rows(del_keys, self.device)
        if self.resize is not None:
            rs = self.resize
            res_new, nk_new, nv_new = kv_store.sharded_delete(
                rs.new_keys, rs.new_vals, qk, device=self.device, **kwargs)
            res_old, nk_old, nv_old = kv_store.sharded_delete(
                rs.keys, rs.vals, qk, device=self.device, **kwargs)
            self.resize = rs._replace(keys=nk_old, vals=nv_old,
                                      new_keys=nk_new, new_vals=nv_new)
            self._advance_resize()
            hit_new = res_new.status == programs.DEL_DELETED
            res = kv_store.DeleteResult(
                torch.where(hit_new, res_new.status, res_old.status),
                res_new.applied | res_old.applied,
                res_new.ok & res_old.ok,
                torch.maximum(res_new.dropped, res_old.dropped),
                res_new.deferred)
            if self.exp is not None:
                kn = qk.cpu().numpy()
                for s, b in np.argwhere(res.applied.cpu().numpy()):
                    self._pending_deadlines.pop(int(kn[s, b]), None)
        elif self.exp is not None:
            res, self.keys, self.vals, self.exp = kv_store.sharded_delete(
                self.keys, self.vals, qk, exp=self.exp, device=self.device,
                **kwargs)
        else:
            res, self.keys, self.vals = kv_store.sharded_delete(
                self.keys, self.vals, qk, device=self.device, **kwargs)
        self.deletes_applied += int(res.applied.sum())
        return res

    def delete(self, key: int) -> bool:
        """One DELETE through the deleter chain; True iff a bucket was
        vacated (deleting an absent key returns False but is not an
        error, as in Memcached)."""
        kv_store.ShardedKV.check_key(key)
        qk = np.zeros((self.kv.n_shards, 1), np.int32)
        qk[0, 0] = key
        return bool(self.delete_many(qk).applied[0, 0])

    # -- the eviction path: CLOCK sweeper chain laps -------------------------
    def sweep(self, now, count: int = 16) -> "kv_store.SweepReport":
        """Advance the background CLOCK sweeper by ``count`` buckets per
        shard: the sweeper chain reads each visited bucket's deadline,
        evaluates the expiry predicate in Calc verbs and vacates expired
        buckets.  Pure chain work, driver-dead safe."""
        if self.exp is None:
            raise ValueError(
                "sweep() needs a TTL-enabled service "
                "(ShardedKVService.start(..., ttl=True))")
        if self.resize is not None:
            raise ValueError(
                "sweep() cannot run against the doubled frame — drive "
                "the resize to completion first (drive_resize())")
        report, self.keys, self.vals, self.exp = kv_store.sharded_sweep(
            self.keys, self.vals, self.exp, self.sweep_hand, now,
            count=count, device=self.device)
        self.sweep_hand = report.hand
        self.sweeps_reclaimed += int(report.reclaimed.sum())
        return report

    # -- incremental growth driver (device chains only; driver-dead safe) ----
    def _advance_resize(self, step: Optional[int] = None):
        if self.resize is None:
            return
        before = int(self.resize.watermark.min())
        self.resize, report = kv_store.sharded_resize(
            self.resize, step=step or self.resize_quantum,
            device=self.device)
        after = int(self.resize.watermark.min())
        if after == before and int(report.stuck.sum()):
            # the watermark parks on the bucket the quantum could not
            # place: the dead end chains — the doubled frame itself grows
            # (2n -> 4n) and the parked residents land there
            self._chain_growth()
            return
        if kv_store.resize_done(self.resize):
            self._cutover(*kv_store.finish_resize(self.resize))

    def _chain_growth(self):
        """Second chained growth: the 2n frame dead-ended (a resident is
        unplaceable even displaced), so grow *it* — the migrator chains
        drain 2n into a fresh 4n frame, then the still-parked old-frame
        residents land in 4n through the writer chain.
        :class:`repro_torch.kvstore.store.ResizeStuck` is raised only for a
        stuck inner growth."""
        rs = self.resize
        ok_np = rs.keys.cpu().numpy()
        ov_np = rs.vals.cpu().numpy()
        inner = kv_store.begin_resize(rs.new_keys, rs.new_vals,
                                      device=self.device)
        while not kv_store.resize_done(inner):
            before = int(inner.watermark.min())
            inner, report = kv_store.sharded_resize(
                inner, step=self.resize_quantum, device=self.device)
            after = int(inner.watermark.min())
            if after == before and int(report.stuck.sum()):
                stuck = report.stuck.cpu().numpy()
                wm = inner.watermark.cpu().numpy()
                shards = [s for s in range(len(stuck)) if stuck[s] > 0]
                raise kv_store.ResizeStuck(
                    shards, [int(wm[s]) for s in shards],
                    "chained growth stuck: resident unplaceable even in "
                    "the quadrupled frame (shards "
                    f"{[int(s) for s in shards]})")
        keys4, vals4 = kv_store.finish_resize(inner)
        self.resizes_completed += 1          # the inner 2n -> 4n growth
        # re-issue the parked old-frame residents through the writer chain
        # against the quadrupled frame (zero-key slots are dead)
        n_shards = ok_np.shape[0]
        rows = [np.flatnonzero(ok_np[s] != 0) for s in range(n_shards)]
        width = max([len(r) for r in rows] + [1])
        qk = np.zeros((n_shards, width), np.int32)
        qv = np.zeros((n_shards, width, ov_np.shape[-1]), np.int32)
        for s, idx in enumerate(rows):
            qk[s, :len(idx)] = ok_np[s, idx]
            qv[s, :len(idx)] = ov_np[s, idx]
        qkt = torch.from_numpy(qk).to(self.device)
        res, keys4, vals4 = kv_store.sharded_set(
            keys4, vals4, qkt, torch.from_numpy(qv).to(self.device),
            live=qkt != 0, device=self.device)
        status = res.status.cpu().numpy()
        landed = np.isin(status, TERMINAL_SET)
        if ((qk != 0) & ~landed).any():
            bad = np.argwhere((qk != 0) & ~landed)
            raise kv_store.ResizeStuck(
                [int(s) for s, _ in bad], [0 for _ in bad],
                "chained growth stuck: parked resident did not land in "
                "the quadrupled frame (statuses "
                f"{status[(qk != 0) & ~landed].tolist()})")
        self.chained_growths += 1
        self._cutover(keys4, vals4)

    def _cutover(self, keys, vals):
        """Adopt a finished frame; on TTL services, re-derive the deadline
        column (key match against the parked snapshot, then the
        resize-window stamps, last write wins)."""
        if self.exp is not None:
            snap = self._exp_keys if self._exp_keys is not None \
                else self.keys
            exp = kv_store.relocate_exp(snap, self.exp, keys)
            if self._pending_deadlines:
                kn = keys.cpu().numpy()
                en = exp.cpu().numpy().copy()
                for k, d in self._pending_deadlines.items():
                    en[kn == k] = d
                exp = torch.from_numpy(en).to(self.device)
            self.exp = exp
            self._exp_keys = None
            self._pending_deadlines = {}
        self.keys, self.vals = keys, vals
        self.resize = None
        self.resizes_completed += 1

    def drive_resize(self):
        """Run the in-flight migration to completion (cutover included).
        Pure chain work — callable with the host driver dead."""
        while self.resize is not None:
            self._advance_resize()

    def resizing(self) -> bool:
        return self.resize is not None

    # -- the set path: fully chain-served, displacement included -------------
    def set(self, key: int, value: Sequence[int]) -> bool:
        """One SET through the full chain pipeline — update,
        in-neighborhood insert or displacement, all device state, all
        serving with the driver dead.  With ``auto_resize`` a
        ``SET_NEEDS_RESIZE`` answer grows the table and lands the key, so
        False only means the escalation itself was dropped or stuck;
        without it, False is the bounded needs-resize report."""
        qk, qv = self._one_request(key, value)
        status = int(self.set_many(qk, qv).status[0, 0])
        return status in TERMINAL_SET

    def _one_request(self, key: int, value: Sequence[int]):
        """One real request from shard 0; the other source shards send a
        zero-padded slot the chains' null guards ignore."""
        kv_store.ShardedKV.check_key(key)
        qk = np.zeros((self.kv.n_shards, 1), np.int32)
        qk[0, 0] = key
        qv = np.zeros((self.kv.n_shards, 1, self.kv.val_words), np.int32)
        qv[0, 0, :len(value)] = value
        return qk, qv

    # -- crash-consistent recovery (interrupted chains) ----------------------
    def fsck_and_repair(self):
        """Audit the store's frames for torn state and mend what the policy
        knows how to mend (:mod:`repro_torch.kvstore.fsck`).  Host-driven
        and quiesced by construction — recovery runs between serving
        calls.  Returns the pre-repair report; the applied-repair count
        accumulates on ``repairs_applied``."""
        h = self.kv.neighborhood
        if self.resize is not None:
            report = fsck.check_invariants(resize=self.resize,
                                           neighborhood=h)
            if not report.clean:
                self.resize, actions = fsck.repair_resize(
                    self.resize, report, neighborhood=h)
                self.repairs_applied += len(actions)
        else:
            report = fsck.check_invariants(self.keys, self.vals,
                                           neighborhood=h)
            if not report.clean:
                self.keys, self.vals, actions = fsck.repair(
                    self.keys, self.vals, report, neighborhood=h)
                self.repairs_applied += len(actions)
        return report

    def set_reliable(self, key: int, value: Sequence[int],
                     faults: Optional[faults_mod.FaultPlan] = None
                     ) -> Tuple[int, int]:
        """One SET that survives interrupted chains: issue, and on any
        non-terminal outcome run fsck + repair and re-issue with bounded
        exponential backoff (``backoff_base_s`` doubling up to
        ``backoff_cap_s``, at most ``retry_budget`` re-issues).

        ``faults`` (a scalar :class:`repro_torch.core.faults.FaultPlan`)
        arms the *first* attempt's writer chain: the fault fires once,
        and every retry runs clean against whatever torn state it left.
        Injection needs the steady-state path; during a resize the plan
        is not armed.

        Returns ``(status, attempts)``; raises :class:`ChainInterrupted`
        when the budget is exhausted — with the store fsck-clean."""
        qk, qv = self._one_request(key, value)
        plan = None
        if faults is not None and self.resize is None:
            rows = np.full((self.kv.n_shards, 1, faults_mod.FIELDS),
                           faults_mod.NONE, np.int32)
            rows[0, 0] = faults.as_rows().cpu().numpy()
            plan = faults_mod.FaultPlan.from_row(
                torch.from_numpy(rows).to(self.device))

        last_status = 0
        attempts = 0
        for attempt in range(self.retry_budget + 1):
            if attempt:
                time.sleep(min(self.backoff_base_s * (2 ** (attempt - 1)),
                               self.backoff_cap_s))
            kwargs = {} if plan is None else {"faults": plan}
            plan = None          # the injected fault fires exactly once
            res = self.set_many(qk, qv, **kwargs)
            attempts = attempt + 1
            last_status = int(res.status[0, 0])
            if last_status in TERMINAL_SET:
                return last_status, attempts
            # non-terminal (or needs-resize with auto_resize off): the
            # chain was interrupted — audit, mend, re-issue
            self.fsck_and_repair()
        report = self.fsck_and_repair()
        raise ChainInterrupted(key, attempts, last_status, report.clean)
