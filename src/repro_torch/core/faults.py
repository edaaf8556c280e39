"""Deterministic fault injection for chain executions (the port's
``repro.core.faults``).

A chain can die *mid-flight* — fuel exhausted mid-displacement, a WQE
dropped by the NIC, a QP reset zeroing a doorbell — and leave a **torn**
intermediate state in device memory.  A :class:`FaultPlan` is the seeded,
reproducible description of such faults; the interpreter
(``machine.run(..., faults=...)``) is the authority on their semantics,
and the ``"kernel"`` backend keeps bit-exact parity on the one fault it
models (fuel truncation).

A plan is a NamedTuple of int32 tensors.  Each leaf is a *step/ordinal
index*, with ``NONE`` (-1) meaning "fault disarmed":

``kill_step``
    Truncate fuel before executing step ``k``: exactly ``k`` WRs run and
    the machine stops, leaving whatever the executed WRs wrote.
``suppress_step``
    The WR scheduled at step ``k`` is dropped: head advances, no effects,
    **no completion** (a NIC WQE drop).
``fail_cas``
    The ``n``-th executed CAS spuriously fails (the return-old path still
    reports the true old value).
``zero_enable``
    The ``n``-th executed ENABLE is nulled (the doorbell write is lost).

Shard-kill at migration lap ``j`` composes from these
(:meth:`FaultPlan.kill_lap`).  Plans stack into per-request **rows**
(:meth:`as_rows` / :meth:`from_row`) so the transport can dispatch a
request's fault along with its payload, and :func:`storm` draws a seeded
batch of plans (the seed rotated by the ``FAULT_SEED`` environment
variable, see :func:`storm_seed`).
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import device as device_mod

NONE = -1          # disarmed fault slot
FIELDS = 4         # words per fault row: [kill, suppress, cas, enable]


class FaultPlan(NamedTuple):
    """Injectable faults for chain executions (all leaves int32 tensors).

    Scalar leaves describe one run; leaves with a leading batch dim
    describe one run per row.  ``NONE`` disarms a slot.
    """
    kill_step: torch.Tensor       # truncate fuel before step k
    suppress_step: torch.Tensor   # drop the WR scheduled at step k
    fail_cas: torch.Tensor        # force the n-th executed CAS to miss
    zero_enable: torch.Tensor     # null the n-th executed ENABLE doorbell

    # -- constructors -------------------------------------------------------
    @classmethod
    def none(cls, shape=(), device=None) -> "FaultPlan":
        full = torch.full(tuple(shape), NONE, dtype=torch.int32,
                          device=device_mod.resolve(device))
        return cls(full, full.clone(), full.clone(), full.clone())

    @classmethod
    def _one(cls, field: str, k, shape, device) -> "FaultPlan":
        plan = cls.none(shape, device)
        return plan._replace(**{field: torch.full_like(plan.kill_step,
                                                       int(k))})

    @classmethod
    def kill_at(cls, k, shape=(), device=None) -> "FaultPlan":
        return cls._one("kill_step", k, shape, device)

    @classmethod
    def suppress_at(cls, k, shape=(), device=None) -> "FaultPlan":
        return cls._one("suppress_step", k, shape, device)

    @classmethod
    def cas_fail_at(cls, n, shape=(), device=None) -> "FaultPlan":
        return cls._one("fail_cas", n, shape, device)

    @classmethod
    def enable_zero_at(cls, n, shape=(), device=None) -> "FaultPlan":
        return cls._one("zero_enable", n, shape, device)

    @classmethod
    def kill_lap(cls, n_laps: int, lap: int, step: int,
                 device=None) -> "FaultPlan":
        """Shard dies at migration lap ``lap``, ``step`` WRs in: laps
        before run clean, lap ``lap`` truncates at ``step``, later laps
        never execute (``kill_step = 0``).  Leaves are (n_laps,)."""
        kill = np.full(n_laps, NONE, np.int32)
        kill[lap] = step
        kill[lap + 1:] = 0
        plan = cls.none((n_laps,), device)
        return plan._replace(kill_step=torch.from_numpy(kill).to(
            plan.kill_step.device))

    # -- row packing (for dispatch alongside payloads) ----------------------
    def as_rows(self) -> torch.Tensor:
        """Stack the leaves into ``(..., FIELDS)`` int32 rows."""
        return torch.stack([torch.as_tensor(leaf).to(torch.int32)
                            for leaf in self], dim=-1)

    @classmethod
    def from_row(cls, row) -> "FaultPlan":
        """Rebuild a plan from packed rows ``(..., FIELDS)``."""
        row = torch.as_tensor(row).to(torch.int32)
        return cls(row[..., 0], row[..., 1], row[..., 2], row[..., 3])

    # -- predicates ---------------------------------------------------------
    def active(self) -> torch.Tensor:
        """Per-row bool: any fault slot armed."""
        return ((self.kill_step >= 0) | (self.suppress_step >= 0)
                | (self.fail_cas >= 0) | (self.zero_enable >= 0))

    def kernel_supported(self) -> bool:
        """True iff this plan uses only faults the single-WQ chain kernel
        models bit-exactly (fuel truncation)."""
        return not bool(((self.suppress_step >= 0) | (self.fail_cas >= 0)
                         | (self.zero_enable >= 0)).any())


def storm_seed(default: int = 20260807) -> int:
    """The storm seed, rotated through the ``FAULT_SEED`` env var."""
    return int(os.environ.get("FAULT_SEED", default))


def storm(n: int, p_fault: float = 0.25, max_step: int = 64,
          seed: Optional[int] = None,
          kinds=("kill", "suppress", "cas", "enable"),
          device=None) -> FaultPlan:
    """Draw a seeded batch of per-request fault plans (leaves ``(n,)``).

    Each request independently faults with probability ``p_fault``; a
    faulted request gets one uniformly drawn fault kind with a uniform
    parameter in ``[0, max_step)``.  The draws are numpy's
    ``default_rng`` in the JAX package's order, so a seed gives the same
    rows in both packages.
    """
    rng = np.random.default_rng(storm_seed() if seed is None else seed)
    rows = np.full((n, FIELDS), NONE, np.int32)
    hit = rng.random(n) < p_fault
    kind = rng.integers(0, len(kinds), n)
    param = rng.integers(0, max_step, n).astype(np.int32)
    col = {"kill": 0, "suppress": 1, "cas": 2, "enable": 3}
    for i in range(n):
        if hit[i]:
            rows[i, col[kinds[kind[i]]]] = param[i]
    return FaultPlan.from_row(torch.from_numpy(rows).to(
        device_mod.resolve(device)))
