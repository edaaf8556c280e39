"""The RedN chain VM: a discrete-event interpreter for RDMA work-request
chains (RedN §3), in PyTorch.

This is the functional model of what the RNIC's processing units do:

* one PU per work queue (§3.5 "each WQ is allocated a single RNIC PU");
* WQs are circular buffers of 8-word WRs inside the flat memory image, so
  chains can modify their own code (self-modifying WRs, §3.2);
* ``WAIT`` blocks a WQ until another WQ's completion counter reaches a
  threshold (completion ordering, Fig. 2a);
* managed WQs execute only up to a monotonic ``enable_limit`` raised by
  ``ENABLE`` (doorbell ordering, Fig. 2b), the mechanism behind WQ
  recycling (§3.4);
* scheduling is min-clock-first over eligible WQs (lowest WQ index on a
  tie), so the per-WQ latency clocks priced by ``cost.py`` interleave like
  concurrent PUs;
* a machine stops on quiescence (no WQ eligible), HALT, or fuel exhaustion.

Batches of independent machines (one client context per row) carry a
leading batch dim on every ``VMState`` field.  On the card
:func:`run_batch` is one launch of the interpreter kernel
(``kernels/chain_interp``), every row run to its own stop.  Its plain
version, :func:`plain_run`, is a host loop over steps (:func:`_run_rows`):
each step executes one WR on every row that can still run, and a row whose
own condition is false (nothing eligible, halted, out of fuel) is frozen,
exactly as a vmapped ``while_loop`` freezes it.  The step applies its
updates in place, on the running rows only, and reads or writes only the
words a WR touches — never a full-image select.

Out-of-range addresses follow the JAX reference bit for bit: a read clamps
its (negative-wrapped) index into the image, a scalar write past the end
is dropped, and a 16-word block's start is wrapped and clamped into
``[0, L - 16]``.  int32 arithmetic wraps.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import device as device_mod
from . import cost, isa


class MachineSpec(NamedTuple):
    """Static machine geometry."""
    mem_words: int
    wq_bases: tuple            # word address of WR slot 0, per WQ
    wq_sizes: tuple            # WR slots per WQ (circular)
    orderings: tuple           # isa.ORD_* per WQ (cost model)
    managed: tuple             # bool per WQ (ENABLE-gated)
    msg_capacity: int = 8      # inbound message slots per WQ

    @property
    def num_wqs(self) -> int:
        return len(self.wq_bases)


class VMState(NamedTuple):
    """Dynamic machine state; a batch adds a leading dim to every field."""
    mem: torch.Tensor            # i32[mem_words + GUARD_WORDS]
    head: torch.Tensor           # i32[N] monotonic executed count
    tail: torch.Tensor           # i32[N] monotonic posted count (doorbell)
    enable_limit: torch.Tensor   # i32[N] monotonic ENABLE watermark
    completions: torch.Tensor    # i32[N] signaled-completion count
    last_comp_time: torch.Tensor  # f32[N] clock of latest completion
    msg_buf: torch.Tensor        # i32[N, CAP, MSG_WORDS]
    msg_head: torch.Tensor       # i32[N]
    msg_tail: torch.Tensor       # i32[N]
    clock: torch.Tensor          # f32[N] per-PU latency clock (us)
    steps: torch.Tensor          # i32[] WRs executed
    halted: torch.Tensor         # bool[]
    verb_counts: torch.Tensor    # i32[NUM_OPCODES] executed-verb histogram
    responses: torch.Tensor      # i32[] count of SEND-to-client responses


# Guard pad past the addressable image: every copy verb and the SEND
# payload gather read a fixed 16-word block (reads past mem_words land in
# zeros).
GUARD_WORDS = max(isa.MAX_COPY, isa.MSG_WORDS)


def init_state(spec: MachineSpec, mem_image: np.ndarray,
               tails: Sequence[int], enable_limits: Sequence[int],
               device=None) -> VMState:
    dev = device_mod.resolve(device)
    mem = np.zeros(spec.mem_words + GUARD_WORDS, dtype=np.int32)
    mem[: len(mem_image)] = mem_image
    n = spec.num_wqs
    i32 = dict(dtype=torch.int32, device=dev)
    return VMState(
        mem=torch.from_numpy(mem).to(dev),
        head=torch.zeros(n, **i32),
        tail=torch.as_tensor(np.asarray(tails, np.int32), device=dev),
        enable_limit=torch.as_tensor(np.asarray(enable_limits, np.int32),
                                     device=dev),
        completions=torch.zeros(n, **i32),
        last_comp_time=torch.zeros(n, dtype=torch.float32, device=dev),
        msg_buf=torch.zeros((n, spec.msg_capacity, isa.MSG_WORDS), **i32),
        msg_head=torch.zeros(n, **i32),
        msg_tail=torch.zeros(n, **i32),
        clock=torch.zeros(n, dtype=torch.float32, device=dev),
        steps=torch.zeros((), **i32),
        halted=torch.zeros((), dtype=torch.bool, device=dev),
        verb_counts=torch.zeros(isa.NUM_OPCODES, **i32),
        responses=torch.zeros((), **i32),
    )


# ---------------------------------------------------------------------------
# host-side doorbells (the client/driver API); each returns a new state
# ---------------------------------------------------------------------------

def ring(state: VMState, wq: int, count: int = 1) -> VMState:
    """Ring the doorbell: post `count` already-written WRs on `wq`."""
    tail = state.tail.clone()
    tail[..., wq] += count
    return state._replace(tail=tail)


def pad_payload_rows(payloads: torch.Tensor) -> torch.Tensor:
    """Zero-pad the last dim of int32 payload rows to MSG_WORDS."""
    k = payloads.shape[-1]
    if k > isa.MSG_WORDS:
        raise ValueError(f"payload of {k} words exceeds MSG_WORDS")
    if k == isa.MSG_WORDS:
        return payloads
    out = payloads.new_zeros(payloads.shape[:-1] + (isa.MSG_WORDS,))
    out[..., :k] = payloads
    return out


def deliver(state: VMState, wq: int, payload) -> VMState:
    """Client SEND arriving at `wq`'s QP: lands in the message queue and is
    consumed by a pre-posted RECV (Fig. 3's trigger)."""
    if not isinstance(payload, torch.Tensor):
        payload = np.asarray(payload, np.int32)
    pay = pad_payload_rows(torch.as_tensor(
        payload, device=state.mem.device).to(torch.int32).reshape(-1))
    cap = state.msg_buf.shape[-2]
    slot = int(torch.remainder(state.msg_tail[wq], cap))
    msg_buf = state.msg_buf.clone()
    msg_buf[wq, slot] = pay
    msg_tail = state.msg_tail.clone()
    msg_tail[wq] += 1
    return state._replace(msg_buf=msg_buf, msg_tail=msg_tail)


def deliver_many(state: VMState, wq: int, payloads) -> VMState:
    """Batched deliver: stack N client SENDs into a batch of machines.

    ``payloads`` is ``(N, k)`` (k <= MSG_WORDS): every field of ``state`` is
    copied to a leading batch dim of N and row ``i`` receives
    ``payloads[i]`` on ``wq``.  The message slot is taken from the
    unbatched ``msg_tail``.

    ``payloads`` may also be ``(G, N, k)`` against a ``state`` stacked over
    G machines (every field with a leading dim G, e.g. one machine per
    virtual shard): rows ``g*N .. g*N+N-1`` of the result start from
    machine ``g``.  The result is one fresh allocation that the caller may
    run in place.
    """
    if not isinstance(payloads, torch.Tensor):
        payloads = np.asarray(payloads, np.int32)
    p = torch.as_tensor(payloads, device=state.mem.device)
    if p.ndim not in (2, 3):
        raise ValueError(
            f"payloads must be a (N, k) or (G, N, k) batch, got shape "
            f"{tuple(p.shape)}; use deliver() for a single request")
    pays = pad_payload_rows(p.to(torch.int32))
    cap = state.msg_buf.shape[-2]
    if p.ndim == 2:
        n = pays.shape[0]
        batch = VMState(*(a.unsqueeze(0).expand((n,) + a.shape).clone()
                          for a in state))
        slot = torch.remainder(state.msg_tail[wq], cap).long().expand(n)
    else:
        g, n = pays.shape[:2]
        if state.mem.ndim != 2 or state.mem.shape[0] != g:
            raise ValueError(
                f"(G, N, k) payloads need a state stacked over G={g} "
                f"machines, got mem of shape {tuple(state.mem.shape)}")
        batch = VMState(*(a.repeat_interleave(n, dim=0) for a in state))
        slot = torch.remainder(state.msg_tail[:, wq], cap).long()
        slot = slot.repeat_interleave(n)
        pays = pays.reshape(g * n, isa.MSG_WORDS)
    rows = torch.arange(pays.shape[0], device=pays.device)
    batch.msg_buf[rows, wq, slot] = pays
    batch.msg_tail[:, wq] += 1
    return batch


def enable(state: VMState, wq: int, absolute_count: int) -> VMState:
    """Host-side ENABLE (used when the trigger comes from the driver)."""
    en = state.enable_limit.clone()
    en[..., wq] = torch.clamp(en[..., wq], min=absolute_count)
    return state._replace(enable_limit=en)


# ---------------------------------------------------------------------------
# index rules of the JAX reference
# ---------------------------------------------------------------------------

def read_index(idx: torch.Tensor, length: int) -> torch.Tensor:
    """Gather index rule: a negative index counts from the end, then the
    index is clamped into the array.  Returns int64 for indexing."""
    idx = torch.where(idx < 0, idx + length, idx)
    return idx.clamp(0, length - 1).long()


def block_start(start: torch.Tensor, length: int, size: int) -> torch.Tensor:
    """``dynamic_slice`` start rule: a negative start counts from the end,
    then the start is clamped into ``[0, length - size]``.  int64."""
    start = torch.where(start < 0, start + length, start)
    return start.clamp(0, length - size).long()


@functools.lru_cache(maxsize=16)
def _arange(n: int, device) -> torch.Tensor:
    """``torch.arange(n)`` on ``device``, built once (read-only use)."""
    return torch.arange(n, device=device)


def masked_copy(mem: torch.Tensor, rows: torch.Tensor, src: torch.Tensor,
                dst: torch.Tensor, ln: torch.Tensor) -> None:
    """In place, per row: ``mem[r, dst:dst+ln] = mem[r, src:src+ln]`` for
    ln <= MAX_COPY.  Both 16-word blocks are placed by :func:`block_start`
    independently and the source block is read before anything is written;
    rows with ln <= 0 write their own words back."""
    L = mem.shape[-1]
    ar = _arange(isa.MAX_COPY, mem.device)
    ln = ln.clamp(0, isa.MAX_COPY)
    rc = rows[:, None]
    cs = block_start(src, L, isa.MAX_COPY)[:, None] + ar
    cd = block_start(dst, L, isa.MAX_COPY)[:, None] + ar
    blk = mem[rc, cs]
    cur = mem[rc, cd]
    mem[rc, cd] = torch.where(ar < ln[:, None], blk, cur)


def store_where(mem: torch.Tensor, rows: torch.Tensor, addr: torch.Tensor,
                value: torch.Tensor, pred: torch.Tensor) -> None:
    """In place, per row: ``mem[r, addr] = value`` where ``pred`` and the
    (non-negative) address lies in the image; dropped otherwise."""
    L = mem.shape[-1]
    a = read_index(addr, L)
    cur = mem[rows, a]
    mem[rows, a] = torch.where(pred & (addr < L), value, cur)


def maybe_store(mem: torch.Tensor, rows: torch.Tensor, addr: torch.Tensor,
                value: torch.Tensor) -> None:
    """mem[addr] = value if addr >= 0 (atomic return-old path)."""
    store_where(mem, rows, addr.clamp_min(0), value, addr >= 0)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

class _Geometry(NamedTuple):
    bases: torch.Tensor        # i32[N]
    sizes: torch.Tensor        # i32[N]
    managed: torch.Tensor      # bool[N]
    orderings: torch.Tensor    # i64[N]
    fetch_tab: torch.Tensor    # f32[3]
    exec_tab: torch.Tensor     # f32[NUM_OPCODES]
    ctrl_opa_opb: torch.Tensor  # i32[3] field offsets read by eligibility


@functools.lru_cache(maxsize=64)
def _geometry(spec: MachineSpec, dev: torch.device) -> _Geometry:
    return _Geometry(
        bases=torch.tensor(spec.wq_bases, dtype=torch.int32, device=dev),
        sizes=torch.tensor(spec.wq_sizes, dtype=torch.int32, device=dev),
        managed=torch.tensor(spec.managed, dtype=torch.bool, device=dev),
        orderings=torch.tensor(spec.orderings, dtype=torch.int64, device=dev),
        fetch_tab=torch.from_numpy(
            np.asarray(cost.FETCH_BY_ORDERING, np.float32)).to(dev),
        exec_tab=torch.from_numpy(
            np.asarray(cost.EXEC_COST, np.float32)).to(dev),
        ctrl_opa_opb=torch.tensor([isa.F_CTRL, isa.F_OPA, isa.F_OPB],
                                  dtype=torch.int32, device=dev),
    )


def _eligibility(geo: _Geometry, s: VMState, rows: torch.Tensor):
    """Per row and WQ: (eligible, ctrl-word address of the head WR)."""
    L = s.mem.shape[-1]
    head = s.head[rows]
    addr = geo.bases + torch.remainder(head, geo.sizes) * isa.WR_WORDS
    tail = s.tail[rows]
    limit = torch.where(geo.managed, torch.minimum(tail, s.enable_limit[rows]),
                        tail)
    has_work = head < limit
    words = s.mem[rows[:, None, None],
                  read_index(addr[..., None] + geo.ctrl_opa_opb, L)]
    opcode = (words[..., 0] >> isa.ID_BITS) & 0x7F
    opa, opb = words[..., 1], words[..., 2]
    tgt = opb.clamp(0, s.head.shape[-1] - 1).long()
    wait_ok = torch.where(opcode == isa.WAIT,
                          s.completions[rows].gather(1, tgt) >= opa, True)
    recv_ok = torch.where(opcode == isa.RECV,
                          s.msg_tail[rows] > s.msg_head[rows], True)
    eligible = has_work & wait_ok & recv_ok & ~s.halted[rows][:, None]
    return eligible, addr


def _schedule(s: VMState, rows, eligible, addrs):
    """The WR each row runs next: min clock over eligible WQs, lowest index
    on a tie.  Returns (w, its 8 fields, clipped opcode)."""
    L = s.mem.shape[-1]
    clock = torch.where(eligible, s.clock[rows], torch.inf)
    w = torch.argmin(clock, dim=1)
    addr = addrs.gather(1, w[:, None])
    fields = s.mem[rows[:, None],
                   read_index(addr + _arange(isa.WR_WORDS, s.mem.device), L)]
    opcode = ((fields[:, isa.F_CTRL] >> isa.ID_BITS) & 0x7F).clamp(
        0, isa.NUM_OPCODES - 1)
    return w, fields, opcode


# opcode classes whose micro-effect blocks a step can skip when no running
# row needs them (one host read per step decides)
_NEEDS = ("copy", "rmw", "recv", "send")


def _needs(opcode, opb):
    is_copy = ((opcode == isa.WRITE) | (opcode == isa.READ)
               | ((opcode == isa.SEND) & (opb < 0)))
    is_rmw = ((opcode == isa.WRITE_IMM) | (opcode == isa.CAS)
              | (opcode == isa.ADD) | (opcode == isa.MAX)
              | (opcode == isa.MIN))
    return torch.stack([is_copy, is_rmw, opcode == isa.RECV,
                        (opcode == isa.SEND) & (opb >= 0)], dim=1)


def _execute(geo: _Geometry, s: VMState, rows, w, fields, opcode,
             need, fault=None) -> None:
    """Apply one scheduling step to the running ``rows`` of ``s``, in place.

    Each verb decomposes into micro-effects applied in the reference's
    order: a block copy, a scalar read-modify-write store, the atomics'
    return-old store, the RECV scatter, the peer SEND, then queue, enable,
    halt and clock bookkeeping.  ``need`` (host bools, one per
    :data:`_NEEDS` class) skips the blocks no running row uses.

    ``fault``, when given, is ``(suppress, spur_cas, zero_enable)`` per
    running row (see :func:`_fault_masks`): a spurious CAS miss keeps the
    old value (the return-old store still reports it), a zeroed ENABLE
    raises no watermark, and a suppressed WR (already rewritten to NOOP)
    signals no completion.
    """
    mem = s.mem
    L = mem.shape[-1]
    n_wq = s.head.shape[-1]
    flags, src, dst = (fields[:, isa.F_FLAGS], fields[:, isa.F_SRC],
                       fields[:, isa.F_DST])
    ln, opa, opb, aux = (fields[:, isa.F_LEN], fields[:, isa.F_OPA],
                         fields[:, isa.F_OPB], fields[:, isa.F_AUX])
    tgt = opb.clamp(0, n_wq - 1).long()
    need_copy, need_rmw, need_recv, need_send = need

    if need_copy:
        is_copy = ((opcode == isa.WRITE) | (opcode == isa.READ)
                   | ((opcode == isa.SEND) & (opb < 0)))
        masked_copy(mem, rows, src, dst, torch.where(is_copy, ln, 0))
        s.responses[rows] += ((opcode == isa.SEND) & (opb < 0)).int()

    if need_rmw:
        d = dst.clamp_min(0)
        old = mem[rows, read_index(d, L)]
        sval = torch.where(opcode == isa.WRITE_IMM, opa, old)
        cas_hit = old == opa
        if fault is not None:
            cas_hit = cas_hit & ~fault[1]
        sval = torch.where(opcode == isa.CAS,
                           torch.where(cas_hit, opb, old), sval)
        sval = torch.where(opcode == isa.ADD, old + opa, sval)
        sval = torch.where(opcode == isa.MAX, torch.maximum(old, opa), sval)
        sval = torch.where(opcode == isa.MIN, torch.minimum(old, opa), sval)
        store_where(mem, rows, d, sval, torch.ones_like(d, dtype=torch.bool))
        ret = torch.where((opcode == isa.CAS) | (opcode == isa.ADD), src, -1)
        maybe_store(mem, rows, ret, old)

    if need_recv:
        is_recv = opcode == isa.RECV
        cap = s.msg_buf.shape[-2]
        rslot = torch.remainder(s.msg_head[rows, w], cap).long()
        payload = s.msg_buf[rows, w, rslot]
        a = aux.clamp_min(0)
        n_scatter = torch.where(is_recv, mem[rows, read_index(a, L)].clamp(
            0, isa.MAX_SCATTER), 0)
        for i in range(isa.MAX_SCATTER):
            sd = mem[rows, read_index(a + (1 + i), L)].clamp_min(0)
            store_where(mem, rows, sd, payload[:, i], i < n_scatter)
        s.msg_head[rows, w] += is_recv.int()

    if need_send:
        send_msg = (opcode == isa.SEND) & (opb >= 0)
        cap = s.msg_buf.shape[-2]
        ps = (block_start(src.clamp_min(0), L, isa.MSG_WORDS)[:, None]
              + _arange(isa.MSG_WORDS, mem.device))
        payload = mem[rows[:, None], ps]
        mslot = torch.remainder(s.msg_tail[rows, tgt], cap).long()
        cur = s.msg_buf[rows, tgt, mslot]
        s.msg_buf[rows, tgt, mslot] = torch.where(send_msg[:, None], payload,
                                                  cur)
        s.msg_tail[rows, tgt] += send_msg.int()

    # ENABLE raises the target's monotonic watermark; HALT stops the row
    cur_en = s.enable_limit[rows, tgt]
    raises = opcode == isa.ENABLE
    if fault is not None:
        raises = raises & ~fault[2]
    s.enable_limit[rows, tgt] = torch.where(
        raises, torch.maximum(cur_en, opa), cur_en)
    s.halted[rows] |= opcode == isa.HALT

    # bookkeeping: head, completions, clock, stats.  Pre-posted chains
    # parked on a WAIT/RECV don't pay the doorbell+fetch at trigger time.
    parked = (opcode == isa.WAIT) | (opcode == isa.RECV)
    first = s.head[rows, w] == 0
    fetch = torch.where(first & parked, 0.0, torch.where(
        first, cost.DOORBELL_BASE, geo.fetch_tab[geo.orderings[w]]))
    t = s.clock[rows, w] + fetch + geo.exec_tab[opcode.long()]
    # WAIT synchronizes with the producer's completion time (Fig 2a)
    t = torch.where(opcode == isa.WAIT,
                    torch.maximum(t, s.last_comp_time[rows, tgt]), t)
    signaled = (flags & isa.FLAG_SUPPRESS_COMPLETION) == 0
    if fault is not None:
        signaled = signaled & ~fault[0]
    s.completions[rows, w] += signaled.int()
    s.last_comp_time[rows, w] = torch.where(signaled, t,
                                            s.last_comp_time[rows, w])
    s.head[rows, w] += 1
    s.clock[rows, w] = t
    s.steps[rows] += 1
    s.verb_counts[rows, opcode.long()] += 1


class _Faults(NamedTuple):
    """A batch's fault rows as int32 columns, indexed by absolute row, and
    the executed-verb ordinals the CAS and ENABLE faults count."""
    kill: torch.Tensor
    suppress: torch.Tensor
    cas: torch.Tensor
    enable: torch.Tensor
    cas_seen: torch.Tensor
    enable_seen: torch.Tensor


def _fault_columns(faults, n: int, dev) -> _Faults:
    """One fault row per machine of a batch of ``n`` (a plan with scalar
    leaves applies to every row)."""
    cols = [torch.as_tensor(leaf, device=dev).to(torch.int32).reshape(-1)
            .expand(n).contiguous() for leaf in faults]
    zero = torch.zeros(n, dtype=torch.int32, device=dev)
    return _Faults(*cols, zero, zero.clone())


def _fault_masks(f: _Faults, s: VMState, rows, opcode):
    """Suppress the WR a row schedules at its ``suppress`` step (its opcode
    becomes NOOP), then the spurious-CAS and zeroed-ENABLE masks, which
    index the verbs that execute after suppression.  Returns ``(opcode,
    (suppress, spur_cas, zero_enable))``."""
    steps = s.steps[rows]
    sup = f.suppress[rows]
    suppress = (sup >= 0) & (steps == sup)
    opcode = torch.where(suppress, isa.NOOP, opcode)
    cas, en = f.cas[rows], f.enable[rows]
    spur = (cas >= 0) & (opcode == isa.CAS) & (f.cas_seen[rows] == cas)
    zero = (en >= 0) & (opcode == isa.ENABLE) & (f.enable_seen[rows] == en)
    return opcode, (suppress, spur, zero)


def _run_rows(geo: _Geometry, s: VMState, rows: torch.Tensor,
              max_steps: int, f: Optional[_Faults] = None,
              mask: Optional[torch.Tensor] = None,
              quota: Optional[torch.Tensor] = None) -> None:
    """Step the machines ``rows`` of ``s`` in place until none can run.

    A row runs while it has an eligible WQ, is not halted and its
    ``steps`` odometer is below ``max_steps``; a row whose condition is
    false is frozen.  ``f`` arms the rows' faults (see
    :func:`run_batch_in_place`).  ``mask`` (bool[N]) restricts
    eligibility, and so the scheduler, to one writer's WQs; ``quota``
    (int32 per absolute row, negative = unlimited) caps the steps each
    row takes in this call."""
    k = None if quota is None else torch.zeros_like(quota)
    while rows.numel():
        eligible, addrs = _eligibility(geo, s, rows)
        if mask is not None:
            eligible = eligible & mask
        go = (eligible.any(1) & ~s.halted[rows]
              & (s.steps[rows] < max_steps))
        if quota is not None:
            q = quota[rows]
            go = go & ((q < 0) | (k[rows] < q))
        w, fields, opcode = _schedule(s, rows, eligible, addrs)
        masks = None
        if f is not None:
            kill = f.kill[rows]
            go = go & ~((kill >= 0) & (s.steps[rows] >= kill))
            # the rewrite precedes _needs: a suppressed WR needs no block
            opcode, masks = _fault_masks(f, s, rows, opcode)
        flags = torch.cat([go[:, None],
                           _needs(opcode, fields[:, isa.F_OPB])
                           & go[:, None]], dim=1).cpu().numpy()
        keep = flags[:, 0]
        if not keep.any():
            break
        if not keep.all():
            sel = torch.from_numpy(np.flatnonzero(keep)).to(rows.device)
            rows, w, fields, opcode = rows[sel], w[sel], fields[sel], \
                opcode[sel]
            if masks is not None:
                masks = tuple(m[sel] for m in masks)
        _execute(geo, s, rows, w, fields, opcode,
                 tuple(bool(x) for x in flags[:, 1:].any(0)), masks)
        if f is not None:
            f.cas_seen[rows] += (opcode == isa.CAS).int()
            f.enable_seen[rows] += (opcode == isa.ENABLE).int()
        if k is not None:
            k[rows] += 1


def run_batch_in_place(spec: MachineSpec, s: VMState,
                       max_steps: int = 4096, faults=None) -> VMState:
    """:func:`run_batch` on the caller's tensors: every row of ``s`` runs
    to its own stop and ``s`` itself is updated (and returned).

    ``faults`` (a :class:`repro_torch.core.faults.FaultPlan`, one row per
    machine) arms each row's faults: ``kill_step`` stops the row before
    its cumulative ``steps`` counter reaches it, the others apply inside
    the step (see :func:`_fault_masks`).  A fully disarmed plan is
    bit-identical to no plan.

    On the card the whole batch is one launch of the interpreter kernel
    (:func:`repro_torch.kernels.chain_interp.ops.run_interp`), with no
    host read inside it, and every field of ``s`` must be contiguous; on
    the CPU its plain version, :func:`plain_run`."""
    from ..kernels.chain_interp import ops as interp_ops
    return interp_ops.run_interp(spec, s, max_steps, faults)


def plain_run(spec: MachineSpec, s: VMState, max_steps: int, faults=None,
              quota: Optional[torch.Tensor] = None,
              writer_slices=None) -> VMState:
    """The interpreter kernel's plain version, in place: the host loop
    :func:`_run_rows` over every row of ``s``.  With ``quota`` (int32
    ``(B, R, W)``) and ``writer_slices``, rounds and writers advance in
    lockstep across the batch, and within a (round, writer) each row steps
    until its own quota, quiescence, HALT or fuel stops it."""
    dev = s.mem.device
    b = s.mem.shape[0]
    geo = _geometry(spec, dev)
    rows = torch.arange(b, device=dev)
    if quota is None:
        f = None if faults is None else _fault_columns(faults, b, dev)
        _run_rows(geo, s, rows, max_steps, f)
        return s
    masks = _writer_masks(spec, writer_slices, dev)
    on_host = quota.cpu().numpy()
    for r in range(quota.shape[1]):
        for w, mask in enumerate(masks):
            q = on_host[:, r, w]
            if not q.any():
                continue                 # nobody may step: skip the sync
            live = torch.from_numpy(np.flatnonzero(q)).to(dev)
            _run_rows(geo, s, rows[live] if live.numel() < b else rows,
                      max_steps, mask=mask,
                      quota=quota[:, r, w].contiguous())
    return s


def _batched(state: VMState) -> VMState:
    return VMState(*(a.unsqueeze(0) for a in state))


def _unbatched(state: VMState) -> VMState:
    return VMState(*(a.squeeze(0) for a in state))


def _clone(state: VMState) -> VMState:
    return VMState(*(a.clone() for a in state))


def step(spec: MachineSpec, s: VMState) -> VMState:
    """One scheduling step of an unbatched machine (a no-op when nothing is
    eligible); the fuel counter is not consulted."""
    b = _clone(_batched(s))
    geo = _geometry(spec, b.mem.device)
    rows = torch.zeros(1, dtype=torch.long, device=b.mem.device)
    eligible, addrs = _eligibility(geo, b, rows)
    if bool(eligible.any()):
        w, fields, opcode = _schedule(b, rows, eligible, addrs)
        _execute(geo, b, rows, w, fields, opcode, (True,) * len(_NEEDS))
    return _unbatched(b)


def quiescent(spec: MachineSpec, s: VMState) -> torch.Tensor:
    b = _batched(s)
    rows = torch.zeros(1, dtype=torch.long, device=b.mem.device)
    eligible, _ = _eligibility(_geometry(spec, b.mem.device), b, rows)
    return ~eligible.any()


def run(spec: MachineSpec, state: VMState, max_steps: int = 4096,
        faults=None) -> VMState:
    """Run until quiescence / HALT / fuel exhaustion (``steps < max_steps``
    is the fuel condition, so a reused state's step count is consumed
    fuel).  ``faults``: a scalar-leaf
    :class:`repro_torch.core.faults.FaultPlan` armed on this run."""
    return _unbatched(run_batch_in_place(spec, _clone(_batched(state)),
                                         max_steps, faults))


def run_batch(spec: MachineSpec, states: VMState,
              max_steps: int = 4096, faults=None) -> VMState:
    """A fleet of independent machines (batched clients), one per row;
    ``faults`` leaves carry one plan per row."""
    return run_batch_in_place(spec, _clone(states), max_steps, faults)


def total_time_us(state: VMState) -> torch.Tensor:
    """End-to-end chain latency: the latest PU clock."""
    return torch.max(state.clock)


# -- multi-writer scheduling --------------------------------------------------
#
# Many independent chains share ONE memory image; a Schedule decides, round
# by round, how many VM steps each writer's WQ group may take.  A Schedule
# is a NamedTuple of int32 quota rows, and the sentinel ``-1`` means
# "unlimited" the same way FaultPlan's ``NONE = -1`` means "disarmed".

SCHED_DRAIN = -1  # quota sentinel: run this writer to quiescence this round


def _plan_device(device, *tensors):
    """The device of a plan built from ``tensors``: ``device`` if given,
    else the first tensor's, else :func:`repro_torch.device.resolve`."""
    if device is None:
        for t in tensors:
            if isinstance(t, torch.Tensor):
                return t.device
    return device_mod.resolve(device)


class Schedule(NamedTuple):
    """Deterministic multi-writer interleaving plan.

    ``quota`` is int32 of shape ``(n_rounds, n_writers)``, or ``(B,
    n_rounds, n_writers)`` for one plan per machine of a batch.  Round
    ``r`` advances writers in index order ``0..n-1``; writer ``w``
    executes at most ``quota[r, w]`` VM steps (``SCHED_DRAIN`` = -1: run
    to quiescence, 0: skip).  A step is one executed WR picked
    min-clock-first among the writer's *own* eligible WQs (lowest WQ
    index on a tie) — the scheduler of :func:`run`, masked to the
    writer's WQ slice.
    """
    quota: torch.Tensor

    # -- constructors (FaultPlan's classmethod style) -----------------------
    @classmethod
    def serialized(cls, n_writers: int, order: Sequence[int] | None = None,
                   device=None) -> "Schedule":
        """One writer per round, each run to quiescence — the serialized
        oracle order (default 0..n-1)."""
        order = tuple(range(n_writers)) if order is None else tuple(order)
        q = np.zeros((len(order), n_writers), np.int32)
        for r, w in enumerate(order):
            q[r, w] = SCHED_DRAIN
        return cls(torch.from_numpy(q).to(device_mod.resolve(device)))

    @classmethod
    def round_robin(cls, n_writers: int, quantum: int, n_rounds: int,
                    device=None) -> "Schedule":
        """``n_rounds`` rounds of ``quantum`` steps each, then a drain round
        so outstanding work always completes."""
        q = np.full((n_rounds + 1, n_writers), int(quantum), np.int32)
        q[n_rounds] = SCHED_DRAIN
        return cls(torch.from_numpy(q).to(device_mod.resolve(device)))

    @classmethod
    def cut(cls, c, n_writers: int = 2, device=None) -> "Schedule":
        """Cut-point schedule (the interleaving analogue of
        ``FaultPlan.kill_at``): writer 0 runs exactly ``c`` steps, writer 1
        drains against the half-done state, then everyone drains.  ``c``
        may be a tensor of cuts: its shape leads the quota's, one plan
        per cut, so a whole sweep runs as one batch of machines."""
        dev = _plan_device(device, c)
        c = torch.as_tensor(c, device=dev).to(torch.int32)
        q = torch.zeros(c.shape + (4, n_writers), dtype=torch.int32,
                        device=dev)
        q[..., 0, 0] = c
        q[..., 1, 1] = SCHED_DRAIN
        q[..., 2:, :] = SCHED_DRAIN
        return cls(q)

    # -- row plumbing (FaultPlan.as_rows/from_row idiom) --------------------
    def as_rows(self) -> torch.Tensor:
        return torch.as_tensor(self.quota).to(torch.int32)

    @classmethod
    def from_rows(cls, rows, device=None) -> "Schedule":
        rows = (rows if isinstance(rows, torch.Tensor)
                else torch.from_numpy(np.array(rows, np.int32)))
        return cls(rows.to(device=_plan_device(device, rows),
                           dtype=torch.int32))

    @property
    def n_rounds(self) -> int:
        return self.quota.shape[-2]

    @property
    def n_writers(self) -> int:
        return self.quota.shape[-1]


def _writer_masks(spec: MachineSpec, writer_slices, dev) -> list:
    masks = []
    for lo, hi in writer_slices:
        m = torch.zeros(spec.num_wqs, dtype=torch.bool, device=dev)
        m[lo:hi] = True
        masks.append(m)
    return masks


def run_scheduled_in_place(spec: MachineSpec, s: VMState,
                           schedule: Schedule, writer_slices,
                           max_steps: int = 4096) -> VMState:
    """:func:`run_scheduled` on a batch of machines, updating ``s`` (and
    returning it).  The quota is ``(n_rounds, n_writers)`` for every row,
    or ``(B, n_rounds, n_writers)``: row ``b`` of the batch follows its
    own plan, so the S shards of a lap, or every cut of a cut sweep, run
    as one batch.  Each row walks its rounds and writers in order, and
    within a (round, writer) steps until its own quota, quiescence, HALT
    or fuel stops it; the rows are independent machines.  On the card
    one launch of the interpreter kernel runs the whole batch through
    every round, on contiguous fields; on the CPU its plain version,
    :func:`plain_run`."""
    from ..kernels.chain_interp import ops as interp_ops
    dev = s.mem.device
    b = s.mem.shape[0]
    quota = schedule.as_rows().to(dev)
    if quota.ndim == 2:
        quota = quota.expand((b,) + tuple(quota.shape))
    if tuple(quota.shape[:1]) != (b,) or quota.shape[-1] != len(
            writer_slices):
        raise ValueError(
            f"schedule of shape {tuple(schedule.quota.shape)} does not fit "
            f"{b} machines of {len(writer_slices)} writers")
    return interp_ops.run_interp(spec, s, max_steps, quota=quota,
                                 writer_slices=writer_slices)


def run_scheduled(spec: MachineSpec, state: VMState, schedule: Schedule,
                  writer_slices, max_steps: int = 4096) -> VMState:
    """Run many writers' chains over ONE shared memory image under a
    deterministic :class:`Schedule`.

    ``writer_slices`` is a tuple of ``(lo, hi)`` WQ index ranges, one per
    writer; writer ``w`` owns WQs ``lo..hi-1``.  Slices must be disjoint
    (shared *memory* is the point; shared *WQs* are not).  Any WQ outside
    every slice (e.g. the null guard WQ) never advances.  ``max_steps``
    bounds the global step count (``steps``) across all rounds.  Fault
    injection is not supported here (interleaving sweeps and fault sweeps
    compose at the harness level, not in one run).

    ``state`` is one machine or a batch (a leading dim on every field);
    see :func:`run_scheduled_in_place` for a batch with one plan a row.
    Returns a new state."""
    if state.mem.ndim == 1:
        return _unbatched(run_scheduled_in_place(
            spec, _clone(_batched(state)), schedule, writer_slices,
            max_steps))
    return run_scheduled_in_place(spec, _clone(state), schedule,
                                  writer_slices, max_steps)
