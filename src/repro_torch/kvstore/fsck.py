"""Crash-consistency checker and repair policy for the hopscotch frames
(the port's ``repro.kvstore.fsck``).

A chain that dies mid-flight (:mod:`repro_torch.core.faults`) leaves device
memory **torn**: every WR that executed landed, everything after the cut
did not.  This module is the offline authority on what states that can
produce and how to mend them, run between serving quanta with the frames
quiesced.

Invariants checked (:func:`check_invariants`):

* **no duplicate live key** within a frame, nor across the two frames of
  a mid-resize :class:`repro_torch.kvstore.store.ResizeState`;
* **neighborhood membership** — every live key sits within ``H`` buckets
  (mod n) of its home;
* **EMPTY buckets have all-zero value rows** (a vacate cut between its key
  CAS and its row zeroing leaves a ghost row);
* **live value rows are non-zero** (a claim cut between its key CAS and
  its row write leaves a key that would serve zeros; real payloads are
  non-zero by the store's convention);
* **drained watermark prefix** — old-frame buckets behind the migration
  watermark are EMPTY, and the watermark lies in ``[0, n]``.

The checks run as tensor ops on the frames' device — a sort by (shard,
key) finds every key's first sighting — and only the flagged buckets
travel to the host, where the report is assembled in the reference's
order: shard, then bucket, then within a bucket stale-row before
torn-vacate, or torn-claim, neighborhood, dup-key.  ``dup-key`` names the
*second* sighting and points at the first.

:func:`repair` / :func:`repair_resize` apply the *minimal rollback*
policy, one violation at a time:

``torn-claim``      key claimed, value row never crossed → vacate it;
``dup-key``         a half-done displacement move → keep the copy
                    **closest to its home** (roll the move back);
``cross-frame-dup`` a migration lap cut between the new-frame claim and
                    the old-frame vacate → a complete new copy wins
                    (finish the vacate); a zero new row is itself the
                    tear (vacate it and let the re-driven lap re-migrate);
``stale-row``       key EMPTY, row not zeroed → zero the row;
``torn-vacate``     key EMPTY, deadline not ``NO_TTL`` → reset it;
``neighborhood``,   chain bugs, not crashes: reported, never repaired.
``watermark``
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from . import hopscotch, store

KINDS = ("torn-claim", "dup-key", "cross-frame-dup", "stale-row",
         "torn-vacate", "neighborhood", "watermark")

#: kinds :func:`repair`/:func:`repair_resize` know how to mend; the rest
#: indicate chain bugs, not crashes, and are surfaced unrepaired
REPAIRABLE = ("torn-claim", "dup-key", "cross-frame-dup", "stale-row",
              "torn-vacate")

# EMPTY buckets' sort key (see _pattern): no live key's pattern reaches it
_EMPTY_GROUP = 1 << 32


class Violation(NamedTuple):
    """One invariant breach, localized to a bucket."""
    kind: str        # one of KINDS
    shard: int
    frame: str       # "single" | "old" | "new"
    bucket: int      # bucket index in that frame
    key: int         # offending key (0 for stale-row/watermark)
    detail: str      # human-readable specifics

    def __repr__(self):
        return (f"Violation({self.kind}: shard {self.shard} "
                f"{self.frame}[{self.bucket}] key={self.key:#x} — "
                f"{self.detail})")


class FsckReport(NamedTuple):
    """The checker's verdict: every violation found, pre-classified."""
    violations: List[Violation]

    @property
    def clean(self) -> bool:
        return not self.violations

    def of_kind(self, kind: str) -> List[Violation]:
        return [v for v in self.violations if v.kind == kind]

    @property
    def repairable(self) -> bool:
        """True iff every violation has a known repair."""
        return all(v.kind in REPAIRABLE for v in self.violations)

    def __repr__(self):
        if self.clean:
            return "FsckReport(clean)"
        counts = {}
        for v in self.violations:
            counts[v.kind] = counts.get(v.kind, 0) + 1
        body = ", ".join(f"{k}={n}" for k, n in sorted(counts.items()))
        return f"FsckReport({len(self.violations)} violations: {body})"


def _home_distance(key: int, bucket: int, n: int) -> int:
    home = int(hopscotch.bucket_of(key, n))
    return (bucket - home) % n


class _Sightings(NamedTuple):
    """A frame's live keys sorted by (shard, key pattern), stable, so each
    group's head is the key's first sighting (lowest bucket)."""
    patterns: torch.Tensor    # (S*n,) int64 sorted
    order: torch.Tensor       # (S*n,) flat bucket index of each


def _pattern(keys: torch.Tensor) -> torch.Tensor:
    """(shard, 32-bit key pattern) as one sortable int64 per bucket; EMPTY
    buckets sort into a group of their own past every live key."""
    s = keys.shape[0]
    shard = torch.arange(s, dtype=torch.int64, device=keys.device)[:, None]
    pat = (keys.to(torch.int64) & 0xFFFFFFFF) + (shard << 33)
    return torch.where(keys != hopscotch.EMPTY, pat,
                       _EMPTY_GROUP).reshape(-1)


def _frame_scan(keys, vals, neighborhood: int, exp=None):
    """The per-bucket checks of one frame as tensors.  Returns ``(flags
    (S*n, 5) bool [stale, torn-vacate, torn-claim, neighborhood, dup],
    home distance (S*n,), first-sighting bucket (S*n,), sightings)``."""
    s, n = keys.shape
    dev = keys.device
    empty = keys == hopscotch.EMPTY
    row_any = (vals != 0).any(dim=-1)
    torn_vac = (torch.zeros_like(empty) if exp is None
                else empty & (exp != hopscotch.NO_TTL))
    b = torch.arange(n, dtype=torch.int32, device=dev)
    dist = torch.remainder(b - hopscotch.bucket_of(keys, n), n)
    pat = _pattern(keys)
    order = torch.argsort(pat, stable=True)
    sp = pat[order]
    pos = torch.arange(sp.numel(), device=dev)
    start = torch.ones_like(sp, dtype=torch.bool)
    start[1:] = sp[1:] != sp[:-1]
    head = torch.cummax(torch.where(start, pos, 0), 0).values
    first = torch.empty_like(order)
    first[order] = order[head]
    first_b = (first % n).reshape(s, n)
    live = ~empty
    flags = torch.stack([empty & row_any, torn_vac, live & ~row_any,
                         live & (dist >= neighborhood),
                         live & (first_b != b)], dim=-1).reshape(-1, 5)
    return flags, dist.reshape(-1), first_b.reshape(-1), _Sightings(sp, order)


def _frame_violations(shard_lists, frame: str, keys, vals, neighborhood: int,
                      exp=None):
    """Append one frame's violations to each shard's list, in bucket
    order; returns the frame's :class:`_Sightings`."""
    s, n = keys.shape
    flags, dist, first_b, seen = _frame_scan(keys, vals, neighborhood, exp)
    idx = torch.nonzero(flags.any(dim=1)).reshape(-1)
    if idx.numel() == 0:
        return seen
    host = dict(
        idx=idx, flags=flags[idx], key=keys.reshape(-1)[idx],
        row=vals.reshape(s * n, -1)[idx], dist=dist[idx],
        first=first_b[idx],
        exp=(keys.reshape(-1)[idx] if exp is None
             else exp.reshape(-1)[idx]))
    host = {k: v.cpu().numpy() for k, v in host.items()}
    for j, flat in enumerate(host["idx"].tolist()):
        sh, b = divmod(flat, n)
        out = shard_lists[sh]
        f = host["flags"][j]
        k = int(host["key"][j])
        if f[0]:
            out.append(Violation(
                "stale-row", sh, frame, b, 0,
                f"EMPTY bucket holds value row {host['row'][j].tolist()}"))
        if f[1]:
            out.append(Violation(
                "torn-vacate", sh, frame, b, 0,
                f"EMPTY bucket holds deadline {int(host['exp'][j])} "
                f"(vacate cut before the expiry reset)"))
        if f[2]:
            out.append(Violation("torn-claim", sh, frame, b, k,
                                 "live key with an all-zero value row"))
        if f[3]:
            out.append(Violation(
                "neighborhood", sh, frame, b, k,
                f"{int(host['dist'][j])} buckets from home "
                f"(H={neighborhood})"))
        if f[4]:
            out.append(Violation("dup-key", sh, frame, b, k,
                                 f"also live at bucket "
                                 f"{int(host['first'][j])}"))
    return seen


def _cross_frame(old: _Sightings, new: _Sightings):
    """``(old flat bucket, new flat bucket, key)`` rows, one for every key
    whose first old-frame sighting is also live in the new frame, in
    old-bucket order; the new bucket is the key's first new-frame
    sighting (the head of its sorted group)."""
    heads = torch.ones_like(old.patterns, dtype=torch.bool)
    heads[1:] = old.patterns[1:] != old.patterns[:-1]
    heads &= old.patterns != _EMPTY_GROUP
    i = torch.searchsorted(new.patterns, old.patterns).clamp(
        max=new.patterns.numel() - 1)
    hit = heads & (new.patterns[i] == old.patterns)
    j = torch.nonzero(hit).reshape(-1)
    rows = torch.stack([old.order[j], new.order[i[j]],
                        old.patterns[j] & 0xFFFFFFFF], dim=1).cpu().numpy()
    rows = rows[np.argsort(rows[:, 0], kind="stable")]
    keys = rows[:, 2].astype(np.uint32).view(np.int32)
    return [(int(ob), int(nb), int(k))
            for (ob, nb, _), k in zip(rows.tolist(), keys.tolist())]


def check_invariants(keys=None, vals=None, *, resize=None,
                     neighborhood: int = 8, exp=None) -> FsckReport:
    """Audit a store's frames for crash-consistency invariants.

    Steady state: pass the sharded ``keys (S, n)`` / ``vals (S, n, V)``
    tensors — plus the deadline column ``exp (S, n)`` when the store
    tracks TTLs, which enables the ``torn-vacate`` classifier.
    Mid-resize: pass ``resize=`` a
    :class:`repro_torch.kvstore.store.ResizeState` instead — both frames,
    the watermark prefix and cross-frame duplicates are audited.  Runs on
    the frames' device; returns an :class:`FsckReport`.
    """
    if resize is None:
        keys = torch.as_tensor(keys)
        lists = [[] for _ in range(keys.shape[0])]
        _frame_violations(lists, "single", keys, torch.as_tensor(vals),
                          neighborhood,
                          None if exp is None else torch.as_tensor(exp))
        return FsckReport([v for sh in lists for v in sh])

    ok, ov, gk, gv, wm = (torch.as_tensor(a) for a in resize)
    s, n = ok.shape
    pre = [[] for _ in range(s)]
    w_host = wm.cpu().numpy().astype(np.int64)
    w = np.clip(w_host, 0, n)
    for sh in range(s):
        if not 0 <= w_host[sh] <= n:
            pre[sh].append(Violation(
                "watermark", sh, "old", int(min(max(w_host[sh], 0), n - 1)),
                0, f"watermark {int(w_host[sh])} outside [0, {n}]"))
    old_l = [[] for _ in range(s)]
    new_l = [[] for _ in range(s)]
    old_seen = _frame_violations(old_l, "old", ok, ov, neighborhood)
    new_seen = _frame_violations(new_l, "new", gk, gv, neighborhood)
    behind = ((torch.arange(n, device=ok.device)[None, :]
               < torch.as_tensor(w, device=ok.device)[:, None])
              & (ok != hopscotch.EMPTY))
    res = torch.nonzero(behind).cpu().numpy()
    res_keys = ok[behind].cpu().numpy()
    cross = [[] for _ in range(s)]
    for ob, nb, k in _cross_frame(old_seen, new_seen):
        sh = ob // n
        cross[sh].append(Violation(
            "cross-frame-dup", sh, "new", nb % (2 * n), k,
            f"also live in old frame bucket {ob % n}"))
    out: List[Violation] = []
    for sh in range(s):
        out += pre[sh] + old_l[sh] + new_l[sh]
        out += [Violation("watermark", sh, "old", int(b), int(k),
                          f"resident behind drained watermark {int(w[sh])}")
                for (rs_, b), k in zip(res, res_keys) if rs_ == sh]
        out += cross[sh]
    return FsckReport(out)


class RepairAction(NamedTuple):
    """One applied repair (the recovery log line)."""
    violation: Violation
    action: str      # "vacate" | "zero-row" | "vacate-old" |
    #                  "vacate-new" | "reset-deadline"


def _set_bucket(keys, vals, shard: int, bucket: int,
                key: int = hopscotch.EMPTY) -> None:
    """In place: bucket ``(shard, bucket)`` holds ``key`` and a zero row
    (the effect of :func:`store.repair_bucket` on arrays recovery owns)."""
    keys[shard, bucket] = int(key)
    vals[shard, bucket] = 0


def _mend_frame(keys, vals, shard: int, report: FsckReport, frame: str,
                actions: List[RepairAction], kk: np.ndarray) -> None:
    """Apply the single-frame policy for one shard, in place and in report
    order; ``kk`` is the host copy of the keys the dup-key repairs
    consult (and update)."""
    n = kk.shape[1]
    for v in report.violations:
        if v.shard != shard or v.frame != frame:
            continue
        if v.kind == "torn-claim":
            _set_bucket(keys, vals, shard, v.bucket)
            actions.append(RepairAction(v, "vacate"))
        elif v.kind == "stale-row":
            _set_bucket(keys, vals, shard, v.bucket,
                        key=int(kk[shard, v.bucket]))
            actions.append(RepairAction(v, "zero-row"))
        elif v.kind == "dup-key":
            # the checker reports the second sighting: recompute every
            # copy from the updated keys and vacate the one farthest from
            # home (the half-move's destination); a tie keeps the first
            sites = np.flatnonzero(kk[shard] == v.key).tolist()
            far = max(sites, key=lambda b: _home_distance(v.key, b, n))
            _set_bucket(keys, vals, shard, far)
            actions.append(RepairAction(v, "vacate"))
            kk[shard, far] = hopscotch.EMPTY


def repair(keys, vals, report: FsckReport, neighborhood: int = 8,
           exp=None):
    """Mend a steady-state store per the rollback policy.

    Returns ``(keys, vals, actions)`` — or ``(keys, vals, exp, actions)``
    when the deadline column is passed, with every ``torn-vacate`` mended
    by resetting the bucket's expiry to ``NO_TTL``.  Violations without a
    repair (``neighborhood``, ``watermark``) are left in place and absent
    from ``actions``.  The inputs are not modified; a follow-up
    :func:`check_invariants` of a repairable report comes back clean.
    """
    keys, vals = torch.as_tensor(keys).clone(), torch.as_tensor(vals).clone()
    kk = keys.cpu().numpy().copy()
    actions: List[RepairAction] = []
    for s in range(kk.shape[0]):
        _mend_frame(keys, vals, s, report, "single", actions, kk)
    if exp is None:
        return keys, vals, actions
    exp = torch.as_tensor(exp).clone()
    for v in report.of_kind("torn-vacate"):
        if v.frame != "single":
            continue
        exp[v.shard, v.bucket] = hopscotch.NO_TTL
        actions.append(RepairAction(v, "reset-deadline"))
    return keys, vals, exp, actions


def repair_resize(rs, report: FsckReport, neighborhood: int = 8):
    """Mend a mid-resize store (both frames and cross-frame duplicates).

    The cross-frame policy mirrors the migrator's match-discard rule: a
    complete new-frame copy wins and the old residents are vacated; a
    new-frame copy whose row is still zero is itself the tear and is
    vacated so the re-driven lap re-migrates.  Returns ``(ResizeState,
    actions)``; the input state is not modified.
    """
    ok, ov, gk, gv = (torch.as_tensor(a).clone() for a in rs[:4])
    kk_old = ok.cpu().numpy().copy()
    kk_new = gk.cpu().numpy().copy()
    actions: List[RepairAction] = []

    # cross-frame first: its verdict decides which frame loses a copy,
    # and the per-frame passes must not see (and "fix") the loser twice
    cross = report.of_kind("cross-frame-dup")
    complete = ([bool((torch.as_tensor(rs.new_vals)[v.shard, v.bucket] != 0)
                      .any()) for v in cross])
    for v, whole in zip(cross, complete):
        s, k = v.shard, v.key
        if whole:
            for b in np.flatnonzero(kk_old[s] == k).tolist():
                _set_bucket(ok, ov, s, b)
                kk_old[s, b] = hopscotch.EMPTY
            actions.append(RepairAction(v, "vacate-old"))
        else:
            _set_bucket(gk, gv, s, v.bucket)
            kk_new[s, v.bucket] = hopscotch.EMPTY
            actions.append(RepairAction(v, "vacate-new"))

    for s in range(kk_old.shape[0]):
        _mend_frame(ok, ov, s, report, "old", actions, kk_old)
        _mend_frame(gk, gv, s, report, "new", actions, kk_new)
    return store.ResizeState(ok, ov, gk, gv, rs.watermark), actions
