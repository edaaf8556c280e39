"""Static verifier for RedN chain programs (the port's copy of
``repro.core.analysis``; numpy only, no tensors).

The interpreter in :mod:`repro_torch.core.machine` always reads a WR's
fields at *execution* time, so it silently forgives the one bug class a real
ConnectX NIC does not: a self-modifying patch landing after the target WQE
was already prefetched (RedN §3.1 — under work-queue ordering the NIC may
fetch any posted WQE ahead of time; only doorbell/completion ordering
fetches one-by-one).  This module analyzes a finalized :class:`~repro_torch.
core.assembler.Program` *statically* and produces typed :class:`Finding`\\ s
from a pass pipeline:

``bounds``
    Every src/dst/len range inside ``mem_words``, ``MAX_COPY`` /
    ``MAX_SCATTER`` respected, opcodes/flags/WAIT/ENABLE targets and RECV
    scatter tables valid.  Fields that are patched at runtime are skipped
    (the self-mod pass tracks them instead).
``order``
    The cross-WQ happens-before graph: program order within a WQ (the VM
    retires head-order in every mode), WAIT edges to the producer WR whose
    signaled completion satisfies the count (``SUPPRESS_COMPLETION``-aware),
    and ENABLE-ladder edges to the slots each ENABLE admits past a managed
    WQ's watermark.  Statically unsatisfiable WAITs, enable-limit
    starvation, and ordering cycles are errors.
``selfmod``
    Every WR whose (static) write-set intersects the code region is a
    patch; the patched WR + field are resolved from the WQ geometry (the
    same arithmetic as ``WRRef.addr``/``future_wr_addr``).  A patch is safe
    only if it is ordered before the target WQE can be *fetched*:
    one-by-one orderings fetch slot ``s`` after slot ``s-1`` retires, so
    reaching any earlier slot of the target WQ suffices; ``ORD_WQ``
    prefetches the whole admitted window, so only an ENABLE that admits the
    slot *after* the patch can make it safe.  Everything else is the §3.1
    stale-prefetch hazard — an error.
``race``
    Any two HB-unordered WRs (necessarily cross-WQ) with overlapping
    write/write or write/read footprints.  Conditional WRs (a NOOP that a
    CAS may convert) carry the footprint of their converted form too.
    Known-benign races are declared with :class:`Waiver`\\ s (matched by
    substring, so one waiver covers a family); a waiver that matches
    nothing is itself a finding, which keeps waivers from going stale.
``certificates``
    A static posted-WR upper bound (``None`` when a recycled WQ makes the
    program statically unbounded) checked against the engine fuel
    convention (``sum(tails) + 1``), and a static
    :func:`repro_torch.core.cost.chain_latency_us` estimate per WQ.

Entry points: :func:`verify_program` (one program), :func:`verify_builder`
/ :func:`verify_all` (the shipped-builder registry), and a CLI::

    PYTHONPATH=src python -m repro_torch.core.analysis --list
    PYTHONPATH=src python -m repro_torch.core.analysis hopscotch_writer
    PYTHONPATH=src python -m repro_torch.core.analysis --sweep --device cpu

The registry's builders allocate their programs' state, so the registry
functions and the CLI take a device (default CUDA, see
:func:`repro_torch.device.resolve`); the analysis itself reads only the
posted WRs.  ``--sweep`` exits non-zero on any non-waived finding — the
admission gate every shipped builder must pass.
"""
from __future__ import annotations

import argparse
import dataclasses
import re
import sys
from typing import (Callable, Dict, FrozenSet, List, Optional, Sequence, Set,
                    Tuple)

import numpy as np

from .. import device as device_mod
from . import cost, isa

# --- severities / pass names -------------------------------------------------
SEV_ERROR = "error"
SEV_WARN = "warn"
SEV_INFO = "info"
SEV_WAIVED = "waived"

PASS_BOUNDS = "bounds"
PASS_ORDER = "order"
PASS_SELFMOD = "selfmod"
PASS_RACE = "race"
PASS_CERT = "certificates"
PASS_WAIVER = "waiver"

_ONE_BY_ONE = (isa.ORD_COMPLETION, isa.ORD_DOORBELL)


@dataclasses.dataclass(frozen=True)
class Finding:
    severity: str
    pass_name: str
    wq: int                 # -1 for program-level findings
    slot: int
    tag: str
    message: str

    @property
    def location(self) -> str:
        if self.wq < 0:
            return "program"
        loc = f"WQ{self.wq}[{self.slot}]"
        return f"{loc}({self.tag})" if self.tag else loc

    def __str__(self) -> str:
        return (f"[{self.severity}] {self.pass_name}: {self.location}: "
                f"{self.message}")


@dataclasses.dataclass(frozen=True)
class Waiver:
    """Declared-benign finding: matched by pass name + substring.

    ``covers`` receives the static model too, so proof-carrying subclasses
    (:class:`RetryWaiver`) can check program *structure* instead of taking
    the declaration on faith; the base class ignores it."""
    pass_name: str
    match: str              # substring of str(finding)
    reason: str

    def covers(self, finding: Finding, model=None) -> bool:
        return (finding.pass_name == self.pass_name
                and self.match in str(finding))


_RACE_PARTIES = re.compile(
    r"race: WQ(\d+)\(([^)]*)\)\[(\d+)\] vs WQ(\d+)\(([^)]*)\)\[(\d+)\]")


@dataclasses.dataclass(frozen=True)
class RetryWaiver(Waiver):
    """Proof-carrying race waiver for bounded CAS-retry loops.

    Two unordered CAS-claims on the same cell are exactly the race the
    §3.5 multi-writer story is *built on* — benign because a CAS is one
    atomic step and every loser takes its not-taken branch.  But "the
    parties are retry loops" must be checked, not declared: this waiver
    covers a race finding only if **both** parties prove out as
    :func:`repro_torch.core.constructs.emit_cas_retry_loop` structure:

    1. *claim-shaped*: the party WR is a CAS whose return-old (``src``)
       steers into a conditional NOOP's ctrl word in a managed mod WQ,
       and that conditional is CAS-convertible (the claim-test pair) —
       so a lost race provably leaves the cell and the branch untouched;
    2. *failure-gated*: consecutive claims of the same cell within the
       party's one-by-one WQ are separated by a WAIT on the mod WQ —
       the re-probe only fetches after the previous attempt's events
       completed un-converted (the loop re-probes on loss, never
       double-fires).

    Structure missing -> not covered -> the race stays an ERROR and the
    waiver is reported stale (the engineered-bad test in
    ``tests/test_torch_analysis.py``).
    """

    def covers(self, finding: Finding, model=None) -> bool:
        if not super().covers(finding):
            return False
        if model is None:
            return False
        mobj = _RACE_PARTIES.search(finding.message)
        if not mobj:
            return False
        qa, _, sa, qb, _, sb = mobj.groups()
        for wq, slot in ((int(qa), int(sa)), (int(qb), int(sb))):
            mod_wq = _claim_shaped(model, wq, slot)
            if mod_wq is None:
                return False
            if not _failure_gated(model, wq, slot, mod_wq):
                return False
        return True


def _claim_shaped(m, wq: int, slot: int) -> Optional[int]:
    """Is WQ[slot] an `emit_cas_claim`-style claiming CAS?  Returns the
    mod WQ index its conditional lives in, else None."""
    wr = m.wr(wq, slot)
    if wr is None or wr.opcode != isa.CAS or wr.src < 0:
        return None
    loc = m.locate(wr.src)                  # return-old steering target
    if loc is None or loc[2] != "ctrl":
        return None
    twq, tslot, _ = loc
    cond = m.wr(twq, tslot)
    if cond is None or cond.opcode != isa.NOOP or not cond.conversions:
        return None
    if not m.wqs[twq].managed:
        return None
    return twq


def _failure_gated(m, wq: int, slot: int, mod_wq: int) -> bool:
    """Every pair of consecutive claims (same cell, same mod WQ) in this
    one-by-one WQ must have a WAIT-on-mod between them."""
    q = m.wqs[wq]
    if q.ordering not in _ONE_BY_ONE:
        return False
    cell = m.wr(wq, slot).dst
    claim_slots = [w.slot for w in q.wrs
                   if w.opcode == isa.CAS and w.dst == cell
                   and "dst" not in w.patched
                   and _claim_shaped(m, wq, w.slot) == mod_wq]
    for s1, s2 in zip(claim_slots, claim_slots[1:]):
        gated = any(w.opcode == isa.WAIT and w.opb == mod_wq
                    and "opa" not in w.patched and "opb" not in w.patched
                    for w in q.wrs[s1 + 1:s2])
        if not gated:
            return False
    return True


def retry_loop_waiver(match: str, reason: str) -> RetryWaiver:
    """A :class:`RetryWaiver` for the race pass (the only pass where the
    retry-loop proof applies)."""
    return RetryWaiver(PASS_RACE, match, reason)


@dataclasses.dataclass
class Report:
    name: str
    findings: List[Finding]
    certificates: dict

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == SEV_ERROR]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == SEV_WARN]

    @property
    def waived(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == SEV_WAIVED]

    def ok(self) -> bool:
        """Clean-or-waivered: no error/warn findings survive."""
        return not self.errors and not self.warnings

    def render(self) -> str:
        lines = [f"== {self.name}: "
                 f"{len(self.errors)} error(s), {len(self.warnings)} "
                 f"warning(s), {len(self.waived)} waived =="]
        for f in self.findings:
            if f.severity != SEV_INFO:
                lines.append(f"  {f}")
        c = self.certificates
        bound = c.get("static_wr_bound")
        lines.append(f"  certificates: wr_bound="
                     f"{'unbounded (recycled)' if bound is None else bound} "
                     f"serial_latency_us={c.get('serial_latency_us')}")
        return "\n".join(lines)


class VerificationError(ValueError):
    def __init__(self, report: Report):
        self.report = report
        super().__init__(
            f"program '{report.name}' failed static verification:\n"
            + "\n".join(str(f) for f in report.findings
                        if f.severity in (SEV_ERROR, SEV_WARN)))


# ---------------------------------------------------------------------------
# static model extraction
# ---------------------------------------------------------------------------

_FIELD_BY_OFFSET = {v: k for k, v in isa.FIELD_NAMES.items()}


@dataclasses.dataclass
class _WR:
    wq: int
    slot: int
    tag: str
    opcode: int
    id_: int
    flags: int
    signaled: bool
    src: int
    dst: int
    ln: int
    opa: int
    opb: int
    aux: int
    # fields overwritten at runtime by some patch ("dynamic" to the passes)
    patched: FrozenSet[str] = frozenset()
    # opcodes this WR may be converted to by a ctrl patch (Fig. 4 CAS trick)
    conversions: Tuple[int, ...] = ()
    # whole-WR template instantiation target (all 8 fields patched at once)
    opaque: bool = False


@dataclasses.dataclass
class _WQ:
    index: int
    base: int
    size: int
    ordering: int
    managed: bool
    recycled: bool
    initial_enable: int
    wrs: List[_WR]

    @property
    def n_posted(self) -> int:
        return len(self.wrs)


@dataclasses.dataclass(frozen=True)
class _Patch:
    """One statically-resolved code-region write."""
    src: Tuple[int, int]        # patcher (wq, slot)
    dst: Tuple[int, int]        # target  (wq, slot)
    fields: Tuple[str, ...]     # patched field names
    via: int                    # patcher opcode


class _Model:
    def __init__(self, prog):
        self.mem_words = prog.mem_words
        self.code_top = prog._code_top
        self.wqs: List[_WQ] = []
        for wq in prog.wqs:
            wrs = []
            for slot, wr in enumerate(wq.wrs):
                ctrl = int(wr["ctrl"])
                flags = int(wr["flags"])
                wrs.append(_WR(
                    wq=wq.index, slot=slot, tag=wr.get("tag", ""),
                    opcode=isa.unpack_opcode(ctrl), id_=isa.unpack_id(ctrl),
                    flags=flags,
                    signaled=(flags & isa.FLAG_SUPPRESS_COMPLETION) == 0,
                    src=int(wr["src"]), dst=int(wr["dst"]),
                    ln=int(wr["ln"]), opa=int(wr["opa"]),
                    opb=int(wr["opb"]), aux=int(wr["aux"])))
            self.wqs.append(_WQ(wq.index, wq.base, wq.size, wq.ordering,
                                wq.managed, wq.recycled, wq.initial_enable,
                                wrs))
        self.num_wqs = len(self.wqs)
        # the static memory image (same construction as Program.finalize)
        img = np.zeros(self.mem_words, dtype=np.int64)
        for wq, mwq in zip(prog.wqs, self.wqs):
            for slot, wr in enumerate(mwq.wrs):
                o = mwq.base + slot * isa.WR_WORDS
                img[o + isa.F_CTRL] = isa.pack_ctrl(wr.opcode, wr.id_)
                img[o + isa.F_FLAGS] = wr.flags
                img[o + isa.F_SRC] = wr.src
                img[o + isa.F_DST] = wr.dst
                img[o + isa.F_LEN] = wr.ln
                img[o + isa.F_OPA] = wr.opa
                img[o + isa.F_OPB] = wr.opb
                img[o + isa.F_AUX] = wr.aux
        for a, v in prog._data_init.items():
            img[a] = v
        self.img = img
        self.patches: List[_Patch] = []

    # -- address resolution ---------------------------------------------------
    def locate(self, addr: int) -> Optional[Tuple[int, int, str]]:
        """(wq, slot, field) of a code-region word, else None."""
        if not 0 <= addr < self.code_top:
            return None
        for wq in self.wqs:
            if wq.base <= addr < wq.base + wq.size * isa.WR_WORDS:
                off = addr - wq.base
                return wq.index, off // isa.WR_WORDS, \
                    _FIELD_BY_OFFSET[off % isa.WR_WORDS]
        return None

    def wr(self, wq: int, slot: int) -> Optional[_WR]:
        w = self.wqs[wq]
        return w.wrs[slot] if slot < len(w.wrs) else None

    def all_wrs(self):
        for wq in self.wqs:
            for wr in wq.wrs:
                yield wq, wr


# ---------------------------------------------------------------------------
# footprints
# ---------------------------------------------------------------------------

def _opcode_footprint(wr: _WR, opcode: int, img) -> Tuple[List[Tuple[int, int]],
                                                          List[Tuple[int, int]]]:
    """(reads, writes) as (start, len) intervals for `wr` executing as
    `opcode`, using only fields that are statically known."""
    reads: List[Tuple[int, int]] = []
    writes: List[Tuple[int, int]] = []
    p = wr.patched

    def known(*fields):
        return not any(f in p for f in fields)

    if opcode in (isa.WRITE, isa.READ):
        if known("len"):
            if known("src"):
                reads.append((wr.src, wr.ln))
            if known("dst"):
                writes.append((wr.dst, wr.ln))
    elif opcode == isa.SEND:
        if known("src", "len"):
            reads.append((wr.src, wr.ln))
        if known("opb") and wr.opb < 0 and known("dst", "len"):
            writes.append((wr.dst, wr.ln))
    elif opcode == isa.WRITE_IMM:
        if known("dst"):
            writes.append((wr.dst, 1))
    elif opcode in (isa.CAS, isa.ADD, isa.MAX, isa.MIN):
        if known("dst"):
            reads.append((wr.dst, 1))
            writes.append((wr.dst, 1))
        if opcode in (isa.CAS, isa.ADD) and known("src") and wr.src >= 0:
            writes.append((wr.src, 1))
    elif opcode == isa.RECV:
        if known("aux") and 0 <= wr.aux < len(img):
            n = int(img[wr.aux])
            if 0 <= n <= isa.MAX_SCATTER:
                reads.append((wr.aux, 1 + n))
                for i in range(n):
                    a = wr.aux + 1 + i
                    if a < len(img):
                        writes.append((int(img[a]), 1))
    # NOOP / WAIT / ENABLE / HALT: no memory footprint
    return reads, writes


def _footprint(wr: _WR, img) -> Tuple[List[Tuple[int, int]],
                                      List[Tuple[int, int]]]:
    """Footprint over the WR's static opcode plus any conditional forms."""
    if wr.opaque:
        return [], []
    reads, writes = _opcode_footprint(wr, wr.opcode, img)
    for op in wr.conversions:
        r2, w2 = _opcode_footprint(wr, op, img)
        reads += r2
        writes += w2
    return reads, writes


def _words(intervals: Sequence[Tuple[int, int]]) -> FrozenSet[int]:
    out = set()
    for start, n in intervals:
        if n > 0 and start >= 0:
            out.update(range(start, start + n))
    return frozenset(out)


# ---------------------------------------------------------------------------
# patch resolution (fixpoint: patched fields become dynamic, which can
# retract spurious patches discovered from placeholder values)
# ---------------------------------------------------------------------------

def _resolve_patches(m: _Model) -> None:
    for _ in range(16):
        patches: List[_Patch] = []
        patched: Dict[Tuple[int, int], set] = {}
        conversions: Dict[Tuple[int, int], set] = {}
        for wq, wr in m.all_wrs():
            _, writes = _footprint(wr, m.img)
            per_target: Dict[Tuple[int, int], set] = {}
            for start, n in writes:
                for a in range(start, start + n):
                    loc = m.locate(a)
                    if loc is None:
                        continue
                    twq, tslot, field = loc
                    per_target.setdefault((twq, tslot), set()).add(field)
            for (twq, tslot), fields in sorted(per_target.items()):
                patches.append(_Patch((wr.wq, wr.slot), (twq, tslot),
                                      tuple(sorted(fields)), wr.opcode))
                patched.setdefault((twq, tslot), set()).update(fields)
                if "ctrl" in fields and wr.opcode == isa.CAS \
                        and "opb" not in wr.patched:
                    conversions.setdefault((twq, tslot), set()).add(
                        isa.unpack_opcode(wr.opb))
        changed = False
        for wq in m.wqs:
            for wr in wq.wrs:
                key = (wr.wq, wr.slot)
                pf = frozenset(patched.get(key, ()))
                conv = tuple(sorted(conversions.get(key, ())))
                opaque = len(pf) == isa.WR_WORDS
                if (pf != wr.patched or conv != wr.conversions
                        or opaque != wr.opaque):
                    wr.patched, wr.conversions, wr.opaque = pf, conv, opaque
                    changed = True
        m.patches = patches
        if not changed:
            return


# ---------------------------------------------------------------------------
# pass: bounds & encoding
# ---------------------------------------------------------------------------

def _check_bounds(m: _Model) -> List[Finding]:
    out: List[Finding] = []

    def err(wr, msg):
        out.append(Finding(SEV_ERROR, PASS_BOUNDS, wr.wq, wr.slot, wr.tag,
                           msg))

    def warn(wr, msg):
        out.append(Finding(SEV_WARN, PASS_BOUNDS, wr.wq, wr.slot, wr.tag,
                           msg))

    for wq, wr in m.all_wrs():
        if wr.opaque:
            continue
        op = wr.opcode
        if not 0 <= op < isa.NUM_OPCODES:
            err(wr, f"invalid opcode {op}")
            continue
        if wr.flags not in (0, isa.FLAG_SUPPRESS_COMPLETION) \
                and "flags" not in wr.patched:
            err(wr, f"invalid flags {wr.flags:#x}")
        kn = wr.patched.isdisjoint

        def addr_ok(a, n=1):
            return 0 <= a and a + n <= m.mem_words

        if op in (isa.WRITE, isa.READ) or (op == isa.SEND and wr.opb < 0
                                           and kn({"opb"})):
            if kn({"len"}):
                if wr.ln > isa.MAX_COPY:
                    err(wr, f"copy len {wr.ln} exceeds MAX_COPY="
                            f"{isa.MAX_COPY}")
                elif wr.ln < 0:
                    warn(wr, f"negative copy len {wr.ln} (clamped to 0 at "
                             "runtime)")
                else:
                    ln = wr.ln
                    if kn({"src"}) and not addr_ok(wr.src, ln):
                        err(wr, f"src range [{wr.src}, {wr.src + ln}) "
                                f"outside mem_words={m.mem_words}")
                    if kn({"dst"}) and not addr_ok(wr.dst, ln):
                        err(wr, f"dst range [{wr.dst}, {wr.dst + ln}) "
                                f"outside mem_words={m.mem_words}")
        if op == isa.SEND:
            if kn({"opb"}) and wr.opb >= m.num_wqs:
                err(wr, f"SEND target WQ {wr.opb} out of range "
                        f"(num_wqs={m.num_wqs})")
        if op in (isa.WRITE_IMM, isa.CAS, isa.ADD, isa.MAX, isa.MIN):
            if kn({"dst"}) and not addr_ok(wr.dst):
                err(wr, f"atomic/scalar dst {wr.dst} outside "
                        f"mem_words={m.mem_words}")
            if op in (isa.CAS, isa.ADD) and kn({"src"}) and wr.src >= 0 \
                    and not addr_ok(wr.src):
                err(wr, f"return-old address {wr.src} outside "
                        f"mem_words={m.mem_words}")
        if op in (isa.WAIT, isa.ENABLE):
            if kn({"opb"}) and not 0 <= wr.opb < m.num_wqs:
                err(wr, f"{isa.OPCODE_NAMES[op]} target WQ {wr.opb} out of "
                        f"range (num_wqs={m.num_wqs})")
            elif op == isa.ENABLE and kn({"opb"}) \
                    and not m.wqs[wr.opb].managed:
                warn(wr, f"ENABLE targets unmanaged WQ{wr.opb} (no effect)")
            if kn({"opa"}) and wr.opa < 0:
                err(wr, f"negative {isa.OPCODE_NAMES[op]} count {wr.opa}")
        if op == isa.RECV and kn({"aux"}):
            if not addr_ok(wr.aux):
                err(wr, f"scatter table address {wr.aux} outside "
                        f"mem_words={m.mem_words}")
            else:
                n = int(m.img[wr.aux])
                if not 0 <= n <= isa.MAX_SCATTER:
                    err(wr, f"scatter table length {n} invalid "
                            f"(MAX_SCATTER={isa.MAX_SCATTER})")
                else:
                    for i in range(n):
                        d = int(m.img[wr.aux + 1 + i])
                        if not addr_ok(d):
                            err(wr, f"scatter entry {i} -> {d} outside "
                                    f"mem_words={m.mem_words}")
    return out


# ---------------------------------------------------------------------------
# pass: WAIT/ENABLE happens-before graph
# ---------------------------------------------------------------------------

class _HBGraph:
    def __init__(self, m: _Model):
        self.m = m
        self.node_of = {}
        self.nodes = []
        for wq in m.wqs:
            for wr in wq.wrs:
                self.node_of[(wq.index, wr.slot)] = len(self.nodes)
                self.nodes.append((wq.index, wr.slot))
        n = len(self.nodes)
        self.edges: List[Tuple[int, int]] = []
        self._reach: Optional[np.ndarray] = None
        self.cyclic = False
        self.n = n

    def add(self, a: Tuple[int, int], b: Tuple[int, int]):
        self.edges.append((self.node_of[a], self.node_of[b]))

    def close(self) -> bool:
        """Topological closure; returns False when the graph has a cycle."""
        n = self.n
        succ: List[List[int]] = [[] for _ in range(n)]
        indeg = [0] * n
        for a, b in set(self.edges):
            succ[a].append(b)
            indeg[b] += 1
        order = [i for i in range(n) if indeg[i] == 0]
        seen = 0
        topo = []
        while seen < len(order):
            u = order[seen]
            seen += 1
            topo.append(u)
            for v in succ[u]:
                indeg[v] -= 1
                if indeg[v] == 0:
                    order.append(v)
        if len(topo) != n:
            self.cyclic = True
            return False
        reach = np.zeros((n, n), dtype=bool)
        for u in reversed(topo):
            for v in succ[u]:
                reach[u, v] = True
                reach[u] |= reach[v]
        self._reach = reach
        return True

    def reaches(self, a: Tuple[int, int], b: Tuple[int, int]) -> bool:
        if self._reach is None:
            return False
        return bool(self._reach[self.node_of[a], self.node_of[b]])

    def reaches_eq(self, a, b) -> bool:
        return a == b or self.reaches(a, b)

    def common_ancestors(self, nodes: Sequence[Tuple[int, int]]
                         ) -> List[Tuple[int, int]]:
        """Maximal nodes HB-before-or-equal every node in `nodes`."""
        if self._reach is None or not nodes:
            return []
        mask = np.ones(self.n, dtype=bool)
        for node in nodes:
            i = self.node_of[node]
            col = self._reach[:, i].copy()
            col[i] = True
            mask &= col
        cand = np.nonzero(mask)[0]
        if cand.size == 0:
            return []
        sub = self._reach[np.ix_(cand, cand)]
        return [self.nodes[i] for i in cand[~sub.any(axis=1)]]


def _build_hb(m: _Model) -> Tuple[_HBGraph, List[Finding], Dict]:
    out: List[Finding] = []
    g = _HBGraph(m)
    # admission map: managed slot -> [(admitter node, admits-via-conversion)]
    adm: Dict[Tuple[int, int], List[Tuple[Tuple[int, int], bool]]] = {}
    # slots whose candidate admitters span WQs (edges added post-closure)
    deferred: List[Tuple[Tuple[int, int], List[Tuple[int, int]]]] = []

    # program order (the VM retires strictly head-order in every mode)
    for wq in m.wqs:
        for s in range(wq.n_posted - 1):
            g.add((wq.index, s), (wq.index, s + 1))

    # cumulative completion counts per WQ (lap 0).  A slot *may* signal
    # when its static encoding is signaled, OR when it is a template
    # target (opaque) or has runtime-patched flags — those execute with
    # runtime-decided content, so the max-possible count includes them.
    # An edge from the first slot whose max-possible count reaches the
    # WAIT operand is sound: reaching `opa` completions requires the
    # head to have retired at least that many slots, in head order.
    cum: Dict[int, List[int]] = {}
    for wq in m.wqs:
        c, counts = 0, []
        for wr in wq.wrs:
            if wr.signaled or wr.opaque or "flags" in wr.patched:
                c += 1
            counts.append(c)
        cum[wq.index] = counts

    # WAIT edges
    for wq, wr in m.all_wrs():
        if wr.opcode != isa.WAIT or wr.opaque:
            continue
        if wr.patched & {"opa", "opb"}:
            out.append(Finding(SEV_INFO, PASS_ORDER, wr.wq, wr.slot, wr.tag,
                               "WAIT with runtime-patched operands (no "
                               "static edge)"))
            continue
        if not 0 <= wr.opb < m.num_wqs or wr.opa <= 0:
            continue                     # bounds pass reports / trivially ok
        prod = m.wqs[wr.opb]
        counts = cum[wr.opb]
        total = counts[-1] if counts else 0
        if wr.opa > total:
            if not prod.recycled:
                out.append(Finding(
                    SEV_ERROR, PASS_ORDER, wr.wq, wr.slot, wr.tag,
                    f"unsatisfiable WAIT: needs {wr.opa} completions from "
                    f"WQ{wr.opb} which signals at most {total}"))
            continue
        pslot = next(s for s, c in enumerate(counts) if c >= wr.opa)
        g.add((wr.opb, pslot), (wr.wq, wr.slot))

    # ENABLE ladder edges + starvation.  An admitter is any WR that can
    # raise tq's enable limit: a static ENABLE, a WR whose ctrl may be
    # CAS-converted into one (the enable-branch idiom — conversions keep
    # their static opa/opb, so the watermark is still known), or an
    # opaque template slot whose stamped image decodes to an ENABLE of
    # tq (the template-release idiom).  A slot s gets an HB edge when
    # every admitter able to admit it lives in one WQ: admission then
    # implies the earliest of them (in that WQ's head order) already
    # retired, converted/stamped or not.  Each admission candidate
    # carries the set of cond conversions it implies (the converted WR
    # itself, or the cond that stamps the template) for `_requires`.
    for tq in m.wqs:
        if not tq.managed:
            continue
        admitters = []           # (node, watermark, implied conversions)
        dynamic = False
        for wq, wr in m.all_wrs():
            if wr.opaque:
                hit = _template_enables(m, wr, tq.index)
                if hit is not None:
                    admitters.append(((wr.wq, wr.slot), hit[0], hit[1]))
                continue
            can_enable = (wr.opcode == isa.ENABLE
                          or isa.ENABLE in wr.conversions)
            if not can_enable:
                continue
            if "opb" in wr.patched:
                dynamic = True           # could target any WQ at runtime
                continue
            if wr.opb != tq.index:
                continue
            if "opa" in wr.patched:
                dynamic = True
                continue
            extra = (((wr.wq, wr.slot),)
                     if wr.opcode != isa.ENABLE else ())
            admitters.append(((wr.wq, wr.slot), wr.opa, extra))
        starved: List[int] = []
        multi_wq = False
        for s in range(tq.initial_enable, tq.n_posted):
            cand = [a for a in admitters if a[1] > s]
            if not cand:
                if not dynamic:
                    starved.append(s)
                continue
            if not dynamic:
                adm[(tq.index, s)] = [(node, extra)
                                      for node, _, extra in cand]
            if len({node[0] for node, _, _ in cand}) > 1:
                multi_wq = True
                deferred.append(((tq.index, s),
                                 [node for node, _, _ in cand]))
                continue
            first = min(cand, key=lambda a: a[0][1])
            g.add(first[0], (tq.index, s))
        if multi_wq:
            out.append(Finding(
                SEV_INFO, PASS_ORDER, tq.index, -1, "",
                f"ENABLE ladder for WQ{tq.index} spans multiple WQs; "
                "multi-WQ-admitted slots are ordered after the common "
                "ancestors of their candidate admitters"))
        if starved:
            sev = SEV_WARN if tq.recycled else SEV_ERROR
            out.append(Finding(
                sev, PASS_ORDER, tq.index, starved[0], "",
                f"enable starvation: slots {starved} of managed "
                f"WQ{tq.index} have no possible admitter"))
        if tq.recycled and not dynamic and admitters:
            out.append(Finding(
                SEV_WARN, PASS_ORDER, tq.index, -1, "",
                f"recycled managed WQ{tq.index} has only static ENABLE "
                "watermarks; laps beyond the last watermark starve"))

    if not g.close():
        out.append(Finding(
            SEV_ERROR, PASS_ORDER, -1, -1, "",
            "ordering cycle in the WAIT/ENABLE happens-before graph "
            "(static deadlock)"))
        return g, out, adm

    # multi-WQ-admitted slots still get sound edges from every common
    # ancestor of their candidate admitters: admission means one of them
    # fired, so anything HB-before all of them has already retired.
    for _ in range(4):
        added = False
        for s_node, cands in deferred:
            for x in g.common_ancestors(cands):
                if x != s_node and not g.reaches_eq(x, s_node):
                    g.add(x, s_node)
                    added = True
        if not added:
            break
        if not g.close():
            out.append(Finding(
                SEV_ERROR, PASS_ORDER, -1, -1, "",
                "ordering cycle in the WAIT/ENABLE happens-before graph "
                "(static deadlock)"))
            break
    return g, out, adm


def _template_enables(m: _Model, wr: _WR, target: int
                      ) -> Optional[Tuple[int, Tuple[Tuple[int, int], ...]]]:
    """Does an opaque (whole-WR-patched) slot's template decode to an
    ENABLE of `target`?  Resolved through the patcher's static src.

    Returns (watermark, extra_conds) — extra_conds names the cond WR
    whose conversion stamps the template (empty when the stamp is an
    unconditional WRITE/READ) — or None when the slot can't be shown to
    become an ENABLE of `target`."""
    for p in m.patches:
        if p.dst != (wr.wq, wr.slot):
            continue
        patcher = m.wr(*p.src)
        if patcher is None:
            continue
        # a CAS-converted cond WR (enable-branch / cas-claim idiom) stamps
        # the template with its *static* src/dst/ln, so treat conversions
        # to WRITE like static WRITE patchers
        eff = {patcher.opcode} | set(patcher.conversions)
        if not eff & {isa.WRITE, isa.READ}:
            continue
        if patcher.patched & {"src", "len"}:
            continue
        base = patcher.src + (m.wqs[wr.wq].base
                              + wr.slot * isa.WR_WORDS - patcher.dst)
        if not 0 <= base <= m.mem_words - isa.WR_WORDS:
            continue
        ctrl = int(m.img[base + isa.F_CTRL])
        opb = int(m.img[base + isa.F_OPB])
        if isa.unpack_opcode(ctrl) == isa.ENABLE and opb == target:
            extra = (((patcher.wq, patcher.slot),)
                     if patcher.conversions else ())
            return int(m.img[base + isa.F_OPA]), extra
    return None


# ---------------------------------------------------------------------------
# pass: self-modification audit
# ---------------------------------------------------------------------------

def _check_selfmod(m: _Model, g: _HBGraph) -> List[Finding]:
    out: List[Finding] = []
    for p in m.patches:
        swq, sslot = p.src
        twq_i, tslot = p.dst
        twq = m.wqs[twq_i]
        patcher = m.wr(swq, sslot)
        tag = patcher.tag if patcher else ""
        fields = ",".join(p.fields)
        if tslot >= twq.n_posted:
            out.append(Finding(
                SEV_WARN, PASS_SELFMOD, swq, sslot, tag,
                f"patch targets unposted WQ{twq_i}[{tslot}].{fields} "
                "(slot beyond tail; never executes)"))
            continue

        safe = None
        same_wq = twq_i == swq
        if same_wq and tslot <= sslot and not twq.recycled:
            out.append(Finding(
                SEV_WARN, PASS_SELFMOD, swq, sslot, tag,
                f"patch targets already-executed WQ{twq_i}[{tslot}]."
                f"{fields} (dead patch in a non-recycled WQ)"))
            continue

        # enable-gated: the slot is admitted only by ENABLEs (static,
        # CAS-converted, or template-stamped) that all happen after the
        # patch (safe in every ordering mode).  Any admitter with a
        # runtime-patched target or watermark defeats the proof.
        if twq.managed and tslot >= twq.initial_enable:
            nodes = []
            unknown = False
            for _, w in m.all_wrs():
                if w.opaque:
                    hit = _template_enables(m, w, twq_i)
                    if hit is not None and hit[0] > tslot:
                        nodes.append((w.wq, w.slot))
                    continue
                if not (w.opcode == isa.ENABLE
                        or isa.ENABLE in w.conversions):
                    continue
                if "opb" in w.patched:
                    unknown = True
                    continue
                if w.opb != twq_i:
                    continue
                if "opa" in w.patched:
                    unknown = True
                elif w.opa > tslot:
                    nodes.append((w.wq, w.slot))
            if nodes and not unknown and all(
                    g.reaches((swq, sslot), n) for n in nodes):
                safe = "enable-gated"

        if safe is None and twq.ordering in _ONE_BY_ONE:
            if same_wq:
                # forward patch: slot tslot is fetched only after slot
                # tslot-1 (>= sslot) retires; backward patches hit the
                # *next lap* of a recycled queue, fetched after this lap.
                safe = "one-by-one fetch"
            else:
                if any(g.reaches_eq((swq, sslot), (twq_i, w))
                       for w in range(tslot)):
                    safe = "ordered before target fetch"

        if safe is None:
            if twq.ordering == isa.ORD_WQ:
                out.append(Finding(
                    SEV_ERROR, PASS_SELFMOD, swq, sslot, tag,
                    f"stale-prefetch hazard (§3.1): patch of WQ{twq_i}"
                    f"[{tslot}].{fields} targets an ORD_WQ queue, which may "
                    "prefetch the WQE before the patch lands"))
            else:
                out.append(Finding(
                    SEV_ERROR, PASS_SELFMOD, swq, sslot, tag,
                    f"unordered patch: WQ{twq_i}[{tslot}].{fields} may be "
                    "fetched before the patch (no happens-before path to "
                    "the target queue)"))
        else:
            out.append(Finding(
                SEV_INFO, PASS_SELFMOD, swq, sslot, tag,
                f"patches WQ{twq_i}[{tslot}].{fields} [{safe}]"))
    return out


# ---------------------------------------------------------------------------
# pass: race detection
# ---------------------------------------------------------------------------

def _branch_exclusions(m: _Model, g: _HBGraph
                       ) -> Set[FrozenSet[Tuple[int, int]]]:
    """Cond-WR pairs proven mutually exclusive.

    The enable-branch idiom (constructs.emit_enable_branch): one value v
    is loaded into both cond ctrl words, one arm is MAX-clamped against
    thr and CAS-tested for thr (fires iff v <= thr), the other is
    MIN-clamped against thr+1 and CAS-tested for thr+1 (fires iff
    v > thr) — at most one CAS can convert its NOOP.  The proof only
    needs the static patch shapes: same loaded value, clamp constants
    matching the CAS comparands, thr+1 on the MIN side, and everything
    in one one-by-one-fetch ctl WQ in load < clamp < test slot order.
    """
    by_cond: Dict[Tuple[int, int], List[_Patch]] = {}
    for p in m.patches:
        if "ctrl" in p.fields:
            by_cond.setdefault(p.dst, []).append(p)

    info = {}
    for node, plist in by_cond.items():
        twr = m.wr(*node)
        if (twr is None or twr.opcode != isa.NOOP or twr.opaque
                or len(twr.conversions) != 1):
            continue
        ctrl_addr = m.wqs[node[0]].base + node[1] * isa.WR_WORDS + isa.F_CTRL
        cas = clamp = None
        loads, adds = [], []
        ok = True
        for p in plist:
            s = m.wr(*p.src)
            # a patched src is fine on a load (the value still gets
            # duplicated into both arms); everything else must be static
            if (s is None or s.conversions or s.opaque
                    or s.patched & {"ctrl", "dst", "len", "opa", "opb"}):
                ok = False
                break
            if s.opcode == isa.CAS and s.dst == ctrl_addr:
                if cas is not None:
                    ok = False
                    break
                cas = s
            elif s.opcode in (isa.MAX, isa.MIN) and s.dst == ctrl_addr:
                if clamp is not None:
                    ok = False
                    break
                clamp = s
            elif s.opcode == isa.ADD and s.dst == ctrl_addr:
                adds.append(s)
            elif (s.opcode in (isa.WRITE, isa.READ) and s.ln == 1
                  and p.fields == ("ctrl",)):
                loads.append(s)
            else:
                ok = False
                break
        if ok and cas and clamp and len(loads) == 1:
            info[node] = (cas, clamp, loads[0], ctrl_addr, tuple(adds))

    def same_value(la, lb, ctrl_a, clamp_a):
        # (a) both arms load the same static source word; (b) arm b
        # copies arm a's pre-clamp ctrl word (probe READ + WRITE copy)
        if (la.opcode == isa.WRITE and lb.opcode == isa.WRITE
                and "src" not in la.patched and "src" not in lb.patched
                and la.src == lb.src):
            return True
        return (lb.opcode == isa.WRITE and "src" not in lb.patched
                and lb.src == ctrl_a and la.slot < lb.slot < clamp_a.slot)

    out: Set[FrozenSet[Tuple[int, int]]] = set()
    items = sorted(info.items())
    for i, (n1, a1) in enumerate(items):
        for n2, a2 in items[i + 1:]:
            if a1[1].opcode == isa.MAX and a2[1].opcode == isa.MIN:
                amax, amin = a1, a2
            elif a1[1].opcode == isa.MIN and a2[1].opcode == isa.MAX:
                amax, amin = a2, a1
            else:
                continue
            thr = amax[1].opa
            if not (amax[0].opa == thr and amin[1].opa == thr + 1
                    and amin[0].opa == thr + 1):
                continue
            wrs = [amax[0], amax[1], amax[2], amin[0], amin[1], amin[2]]
            wrs += list(amax[4]) + list(amin[4])
            if len({w.wq for w in wrs}) != 1:
                continue
            if m.wqs[wrs[0].wq].ordering not in _ONE_BY_ONE:
                continue
            lo_slot = max(amax[2].slot, amin[2].slot)
            hi_slot = min(amax[1].slot, amin[1].slot)
            if not (lo_slot < hi_slot
                    and max(amax[1].slot, amin[1].slot)
                    < min(amax[0].slot, amin[0].slot)):
                continue
            # equal post-load biases applied between the loads and the
            # clamps keep the two arm values equal
            if sorted(a.opa for a in amax[4]) != \
                    sorted(a.opa for a in amin[4]):
                continue
            if any(not lo_slot < a.slot < hi_slot
                   for a in list(amax[4]) + list(amin[4])):
                continue
            if not (same_value(amax[2], amin[2], amax[3], amax[1])
                    or same_value(amin[2], amax[2], amin[3], amin[1])):
                continue
            out.add(frozenset((n1, n2)))
    return out


def _requires(m: _Model, g: _HBGraph, adm: Dict
              ) -> Dict[Tuple[int, int], FrozenSet[Tuple[int, int]]]:
    """For each WR node: the set of cond WRs that must have *converted*
    for the node to execute.

    Every HB edge here carries the execution implication (program order,
    WAIT satisfaction, admission), so requirements flow along in-edges;
    a managed slot additionally requires the intersection over its
    candidate admitters of (admitter's requirements + the admitter
    itself when it only admits via conversion).
    """
    if g.cyclic:
        return {}
    preds: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
    for a, b in set(g.edges):
        preds.setdefault(g.nodes[b], []).append(g.nodes[a])
    req: Dict[Tuple[int, int], Set[Tuple[int, int]]] = {
        n: set() for n in g.nodes}
    for _ in range(32):
        changed = False
        for n in g.nodes:
            r: Set[Tuple[int, int]] = set()
            for p in preds.get(n, ()):
                r |= req[p]
            cands = adm.get(n)
            if cands:
                inter = None
                for c, extra in cands:
                    contrib = set(req[c]) | set(extra)
                    inter = contrib if inter is None else inter & contrib
                r |= inter
            if r != req[n]:
                req[n] = r
                changed = True
        if not changed:
            break
    return {n: frozenset(s) for n, s in req.items()}


def _check_races(m: _Model, g: _HBGraph, adm: Dict) -> List[Finding]:
    out: List[Finding] = []
    if g.cyclic:
        return out
    excl = _branch_exclusions(m, g)
    req = _requires(m, g, adm)
    excluded = 0
    cond_ordered = 0

    # --- conditional-order refinement -----------------------------------
    # In an execution where BOTH parties of a pair run, every cond in
    # req(a)|req(b) converted.  Candidate admitters whose own execution
    # requirements are excluded by that context provably did not fire;
    # reachability where a slot is reached once all *remaining* possible
    # admitters are reached then orders many cross-phase pairs (e.g. a
    # found-arm's WRs before the bubble laps that only its ENABLE, or a
    # sibling arm's, could have released).
    succ_nodes: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
    for ai, bi in set(g.edges):
        succ_nodes.setdefault(g.nodes[ai], []).append(g.nodes[bi])

    def _not_exec(c, extra, ctx):
        needs = set(req.get(c, frozenset())) | set(extra)
        return any(frozenset((d, e)) in excl for d in needs for e in ctx)

    ctx_cache: Dict[FrozenSet, Tuple[Dict, Dict]] = {}

    def _ctx_info(ctx):
        hit = ctx_cache.get(ctx)
        if hit is None:
            poss = {s: [c for c, ex in cands if not _not_exec(c, ex, ctx)]
                    for s, cands in adm.items()}
            cand_of: Dict[Tuple[int, int], List] = {}
            for s, cs in poss.items():
                for c in cs:
                    cand_of.setdefault(c, []).append(s)
            hit = ctx_cache[ctx] = (poss, cand_of)
        return hit

    reach_cache: Dict[Tuple, FrozenSet] = {}

    def _reached_under(src, ctx):
        key = (src, ctx)
        hit = reach_cache.get(key)
        if hit is not None:
            return hit
        poss, cand_of = _ctx_info(ctx)
        need = {s: set(cs) for s, cs in poss.items() if cs}
        reached = {src}
        stack = [src]
        while stack:
            n = stack.pop()
            for nxt in succ_nodes.get(n, ()):
                if nxt not in reached:
                    reached.add(nxt)
                    stack.append(nxt)
            for s in cand_of.get(n, ()):
                rem = need.get(s)
                if rem is None:
                    continue
                rem.discard(n)
                if not rem:
                    del need[s]
                    if s not in reached:
                        reached.add(s)
                        stack.append(s)
        hit = reach_cache[key] = frozenset(reached)
        return hit

    def _cannot_execute(n, ctx):
        # some slot at-or-before n in its WQ has no possible admitter
        # left under ctx: n never runs in an execution matching ctx
        poss, _ = _ctx_info(ctx)
        return any(not poss[(n[0], s)] for s in range(n[1] + 1)
                   if (n[0], s) in poss)

    foot = {}
    for wq, wr in m.all_wrs():
        reads, writes = _footprint(wr, m.img)
        foot[(wq.index, wr.slot)] = (_words(reads), _words(writes))

    merged: Dict[Tuple, List] = {}
    keys = sorted(foot)
    for i, a in enumerate(keys):
        ra, wa = foot[a]
        if not ra and not wa:
            continue
        for b in keys[i + 1:]:
            if a[0] == b[0]:
                continue                 # same WQ: program-ordered
            rb, wb = foot[b]
            if not wa and not wb:
                continue
            if g.reaches(a, b) or g.reaches(b, a):
                continue
            clash = (wa & wb) | (wa & rb) | (ra & wb)
            if not clash:
                continue
            if excl and any(frozenset((c1, c2)) in excl
                            for c1 in req.get(a, ())
                            for c2 in req.get(b, ())):
                excluded += 1
                continue
            ctx = req.get(a, frozenset()) | req.get(b, frozenset())
            if ctx and excl:
                if _cannot_execute(a, ctx) or _cannot_execute(b, ctx):
                    excluded += 1
                    continue
                if b in _reached_under(a, ctx) \
                        or a in _reached_under(b, ctx):
                    cond_ordered += 1
                    continue
            wra, wrb = m.wr(*a), m.wr(*b)
            key = (a[0], b[0], wra.tag, wrb.tag)
            merged.setdefault(key, [0, set(), a, b])
            merged[key][0] += 1
            merged[key][1] |= clash
    for (qa, qb, ta, tb), (npairs, words, a, b) in sorted(merged.items()):
        lo, hi = min(words), max(words)
        kind = "write/write" if ta == tb else "write vs read/write"
        out.append(Finding(
            SEV_ERROR, PASS_RACE, a[0], a[1], ta,
            f"race: WQ{qa}({ta or 'untagged'})[{a[1]}] vs WQ{qb}"
            f"({tb or 'untagged'})[{b[1]}] — {npairs} HB-unordered "
            f"{kind} pair(s) on words {lo}..{hi}"))
    if excluded:
        out.append(Finding(
            SEV_INFO, PASS_RACE, -1, -1, "",
            f"{excluded} overlapping pair(s) proven benign: the parties "
            "require mutually-exclusive branch arms"))
    if cond_ordered:
        out.append(Finding(
            SEV_INFO, PASS_RACE, -1, -1, "",
            f"{cond_ordered} overlapping pair(s) ordered once branch "
            "context is fixed (conditional happens-before)"))
    return out


# ---------------------------------------------------------------------------
# pass: certificates
# ---------------------------------------------------------------------------

def _certificates(m: _Model) -> dict:
    wq_lat = {}
    serial = 0.0
    for wq in m.wqs:
        ops = [wr.opcode if 0 <= wr.opcode < isa.NUM_OPCODES else isa.NOOP
               for wr in wq.wrs]
        parked = bool(ops) and ops[0] in (isa.WAIT, isa.RECV)
        lat = cost.chain_latency_us(ops, wq.ordering,
                                    first_is_doorbelled=not parked)
        wq_lat[str(wq.index)] = round(float(lat), 3)
        serial += float(lat)
    recycled = [wq.index for wq in m.wqs if wq.recycled]
    n_posted = sum(wq.n_posted for wq in m.wqs)
    return {
        "n_wqs": m.num_wqs,
        "n_posted": n_posted,
        "static_wr_bound": None if recycled else n_posted,
        "recycled_wqs": recycled,
        "wq_latency_us": wq_lat,
        "serial_latency_us": round(serial, 3),
    }


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def analyze(prog) -> Tuple[_Model, _HBGraph, List[Finding]]:
    m = _Model(prog)
    _resolve_patches(m)
    findings = _check_bounds(m)
    g, order_findings, adm = _build_hb(m)
    findings += order_findings
    findings += _check_selfmod(m, g)
    findings += _check_races(m, g, adm)
    return m, g, findings


def verify_program(prog, waivers: Sequence[Waiver] = (),
                   name: str = "program") -> Report:
    m, _, findings = analyze(prog)
    used = set()
    final: List[Finding] = []
    for f in findings:
        cover = next((w for w in waivers if w.covers(f, m)), None)
        if cover is not None and f.severity in (SEV_ERROR, SEV_WARN):
            used.add(cover)
            final.append(dataclasses.replace(
                f, severity=SEV_WAIVED,
                message=f"{f.message} [waived: {cover.reason}]"))
        else:
            final.append(f)
    for w in waivers:
        if w not in used:
            final.append(Finding(
                SEV_WARN, PASS_WAIVER, -1, -1, "",
                f"stale waiver ({w.pass_name}: {w.match!r}) matches no "
                "finding — remove it"))
    return Report(name=name, findings=final, certificates=_certificates(m))


# ---------------------------------------------------------------------------
# shipped-builder registry (the sweep CI gates on)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RegistryEntry:
    name: str
    # (device) -> (prog, fuel)
    build: Callable[..., Tuple[object, Optional[int]]]
    waivers: Tuple[Waiver, ...] = ()


def _registry() -> Dict[str, RegistryEntry]:
    # local imports: the CLI should not build anything before argparse runs
    def rpc_echo(device):
        from . import programs
        _, _, info = programs.build_rpc_echo(device=device)
        return info["prog"], None

    def hash_lookup(parallel):
        def build(device):
            from . import programs
            off = programs.build_hash_lookup(n_buckets=16, val_len=2,
                                             parallel=parallel,
                                             device=device)
            return off.prog, None
        return build

    def hopscotch(kind, **kw):
        def build(device):
            from . import programs
            fn = getattr(programs, f"build_hopscotch_{kind}")
            if kind == "displacer":
                off = fn(16, 2, neighborhood=4, max_search=8, max_moves=4,
                         device=device)
            else:
                off = fn(16, 2, neighborhood=4, device=device, **kw)
            return off.prog, getattr(off, "fuel", None)
        return build

    def list_traversal(use_break):
        def build(device):
            from . import programs
            off = programs.build_list_traversal(n_iters=4, val_len=2,
                                                use_break=use_break,
                                                device=device)
            return off.prog, None
        return build

    def recycled_server(device):
        from . import programs
        srv = programs.build_recycled_get_server(n_buckets=16, val_len=2,
                                                 device=device)
        return srv.prog, None

    def interpreter(device):
        from . import turing
        it = turing.build_interpreter(device=device)
        return it.prog, None

    def cas_retry_pair(device):
        from . import programs
        pair = programs.build_cas_retry_pair(attempts=2, device=device)
        return pair.prog, pair.fuel

    def multi_writer_group(lane_kinds=None):
        def build(device):
            from . import programs
            g = programs.build_multi_writer_group(16, 2, neighborhood=4,
                                                  n_writers=2,
                                                  lane_kinds=lane_kinds,
                                                  device=device)
            return g.prog, g.fuel
        return build

    def clock_sweeper(device):
        from . import programs
        off = programs.build_clock_sweeper(16, 2, device=device)
        return off.prog, off.fuel

    # Declared-benign races.  Both waivers cover the same pattern: the
    # per-bucket probe WQs race their response copies on the shared
    # response window, but at most one probe bucket can hold the looked-
    # up key (the hash-table uniqueness invariant the writer's CAS-claim
    # phase maintains), so at most one arm's copy ever converts — a
    # data-dependent exclusion no static pass can see.
    resp_race = Waiver(
        PASS_RACE, "hash.resp",
        "response arms are exclusive by the hash-table invariant: the "
        "key matches at most one probe bucket, so at most one resp copy "
        "is CAS-converted")
    hs_resp_race = Waiver(
        PASS_RACE, "hs.resp",
        "per-bucket response arms are exclusive by the hash-table "
        "invariant: a key occupies at most one bucket of its "
        "neighborhood, so at most one resp copy is CAS-converted")
    # Genuinely-racing CAS claims: admitted by *proof*, not declaration —
    # RetryWaiver checks both parties are bounded failure-gated retry
    # loops (see the class docstring) before covering the finding.
    claim_race = retry_loop_waiver(
        "claim.cas",
        "bounded CAS-retry race: a claim CAS is one atomic step, losers "
        "observe old != expect and re-probe behind a failure gate — any "
        "interleaving equals a serialized order (linearizability)")
    entries = [
        RegistryEntry("rpc_echo", rpc_echo),
        RegistryEntry("hash_lookup", hash_lookup(True),
                      waivers=(resp_race,)),
        RegistryEntry("hash_lookup_seq", hash_lookup(False)),
        RegistryEntry("hopscotch_server", hopscotch("server"),
                      waivers=(hs_resp_race,)),
        RegistryEntry("hopscotch_writer", hopscotch("writer")),
        RegistryEntry("hopscotch_displacer", hopscotch("displacer")),
        RegistryEntry("hopscotch_migrator", hopscotch("migrator")),
        RegistryEntry("list_traversal", list_traversal(False)),
        RegistryEntry("list_traversal_break", list_traversal(True)),
        RegistryEntry("recycled_get_server", recycled_server),
        RegistryEntry("turing_interpreter", interpreter),
        RegistryEntry("cas_retry_pair", cas_retry_pair,
                      waivers=(claim_race,)),
        RegistryEntry("multi_writer_group", multi_writer_group()),
        # Full-lifecycle programs (DELETE + TTL).  The deleter, sweeper,
        # and mixed set/delete group verify clean — the vacate CAS
        # re-reads its comparand behind per-probe exclusivity, so no
        # waiver is needed.  The TTL server variant hits the same
        # hs.resp response-arm family as the plain server.
        RegistryEntry("hopscotch_deleter", hopscotch("deleter")),
        RegistryEntry("hopscotch_server_ttl", hopscotch("server", ttl=True),
                      waivers=(hs_resp_race,)),
        RegistryEntry("clock_sweeper", clock_sweeper),
        RegistryEntry("multi_writer_del_group",
                      multi_writer_group(("set", "delete"))),
        RegistryEntry("multi_writer_sweep_group",
                      multi_writer_group(("set", "sweep"))),
    ]
    return {e.name: e for e in entries}


def registry_names() -> List[str]:
    return sorted(_registry())


def verify_builder(name: str, device=None) -> Report:
    """Build the registered program ``name`` on ``device`` (default CUDA)
    and verify it, with its certificates, budget and engine fuel."""
    entry = _registry()[name]
    prog, fuel = entry.build(device_mod.resolve(device))
    report = verify_program(prog, waivers=entry.waivers, name=name)
    report.certificates["budget"] = prog.budget()
    if fuel is not None:
        report.certificates["fuel"] = int(fuel)
        bound = report.certificates["static_wr_bound"]
        if bound is not None and bound >= fuel:
            report.findings.append(Finding(
                SEV_ERROR, PASS_CERT, -1, -1, "",
                f"static WR bound {bound} not covered by engine fuel "
                f"{fuel}"))
    return report


def verify_all(device=None) -> Dict[str, Report]:
    return {name: verify_builder(name, device) for name in registry_names()}


# ---------------------------------------------------------------------------
# disassembler / CLI
# ---------------------------------------------------------------------------

def disassemble(prog, name: str = "program") -> str:
    m = _Model(prog)
    _resolve_patches(m)
    patch_by_src: Dict[Tuple[int, int], List[_Patch]] = {}
    patch_by_dst: Dict[Tuple[int, int], List[_Patch]] = {}
    for p in m.patches:
        patch_by_src.setdefault(p.src, []).append(p)
        patch_by_dst.setdefault(p.dst, []).append(p)

    lines = [f"program {name}: mem_words={m.mem_words} "
             f"code_top={m.code_top} wqs={m.num_wqs}"]
    for wq in m.wqs:
        attrs = [isa.ORDERING_NAMES[wq.ordering]]
        if wq.managed:
            attrs.append(f"managed(enable={wq.initial_enable})")
        if wq.recycled:
            attrs.append("recycled")
        lines.append(f"WQ{wq.index} @ {wq.base} size={wq.size} "
                     f"posted={wq.n_posted} [{', '.join(attrs)}]")
        for wr in wq.wrs:
            op = (isa.OPCODE_NAMES[wr.opcode]
                  if 0 <= wr.opcode < isa.NUM_OPCODES
                  else f"OP{wr.opcode}?")
            sup = "s" if not wr.signaled else " "
            base = (f"  [{wr.slot:3d}]{sup} {op:<9} src={wr.src:<6} "
                    f"dst={wr.dst:<6} ln={wr.ln:<3} opa={wr.opa:<10} "
                    f"opb={wr.opb:<4} aux={wr.aux:<6}")
            notes = []
            if wr.tag:
                notes.append(wr.tag)
            if wr.opcode == isa.WAIT and not wr.patched & {"opa", "opb"}:
                notes.append(f"waits completions[WQ{wr.opb}] >= {wr.opa}")
            if wr.opcode == isa.ENABLE and not wr.patched & {"opa", "opb"}:
                notes.append(f"enables WQ{wr.opb} upto {wr.opa}")
            for p in patch_by_src.get((wq.index, wr.slot), ()):
                notes.append(f"patches WQ{p.dst[0]}[{p.dst[1]}]."
                             f"{','.join(p.fields)}")
            if wr.patched:
                srcs = sorted({p.src for p in
                               patch_by_dst.get((wq.index, wr.slot), ())})
                by = ",".join(f"WQ{s[0]}[{s[1]}]" for s in srcs)
                notes.append(f"patched({','.join(sorted(wr.patched))}) "
                             f"by {by}")
            if wr.conversions:
                conv = "/".join(isa.OPCODE_NAMES[c] for c in wr.conversions
                                if 0 <= c < isa.NUM_OPCODES)
                notes.append(f"may become {conv}")
            lines.append(base + ("   ; " + "; ".join(notes) if notes else ""))
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.core.analysis",
        description="Static verifier / disassembler for chain programs.")
    ap.add_argument("builder", nargs="?", help="registered builder name")
    ap.add_argument("--list", action="store_true",
                    help="list registered builders")
    ap.add_argument("--sweep", action="store_true",
                    help="verify every registered builder; exit 1 on any "
                         "non-waived finding")
    ap.add_argument("--device", default=None,
                    help="device the builders allocate on (default cuda)")
    args = ap.parse_args(argv)

    if args.list:
        for name in registry_names():
            print(name)
        return 0

    if args.sweep:
        bad = 0
        for name in registry_names():
            report = verify_builder(name, args.device)
            status = "OK" if report.ok() else "FAIL"
            print(f"{status:<4} {name}: {len(report.errors)} error(s), "
                  f"{len(report.warnings)} warning(s), "
                  f"{len(report.waived)} waived, "
                  f"wr_bound={report.certificates['static_wr_bound']}, "
                  f"latency={report.certificates['serial_latency_us']}us")
            if not report.ok():
                bad += 1
                for f in report.findings:
                    if f.severity in (SEV_ERROR, SEV_WARN):
                        print(f"     {f}")
        print(f"sweep: {len(registry_names()) - bad}/"
              f"{len(registry_names())} clean-or-waivered")
        return 1 if bad else 0

    if not args.builder:
        ap.print_help()
        return 2
    if args.builder not in _registry():
        print(f"unknown builder {args.builder!r}; try --list",
              file=sys.stderr)
        return 2
    entry = _registry()[args.builder]
    prog, _ = entry.build(device_mod.resolve(args.device))
    print(disassemble(prog, name=args.builder))
    print()
    report = verify_program(prog, waivers=entry.waivers, name=args.builder)
    print(report.render())
    return 0


if __name__ == "__main__":
    sys.exit(main())
