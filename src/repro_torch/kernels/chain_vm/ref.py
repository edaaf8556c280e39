"""Plain PyTorch versions of the single-WQ chain executors — the oracles of
the chain kernels in ``csrc/chain_vm.cu``.

Two tiers, as in the JAX package's ``kernels/chain_vm/ref.py``:

* :func:`step_wr` / :func:`run_chain_reference` — the straight-line subset
  (no WAIT/ENABLE/SEND/RECV, no return-old): a single queue run for a fixed
  number of steps; a context freezes once it HALTs.
* :func:`step_wr_managed` / :func:`managed_chain_loop` — the managed-WQ
  semantics the recycled get server needs: an ENABLE-gated head limit,
  completion counters (WAIT on self), RECV consuming staged messages,
  client-response SEND, and CAS/ADD return-old.  A blocked head WR
  (unsatisfied WAIT, empty message queue, head at the enable limit) stops
  the context — on a single queue nothing else can unblock it.

The functions are batched: one image per row of ``mem``.  A step updates
the running rows in place and touches only the words its WR names.
Indexing follows the interpreter's rules (:func:`machine.read_index`,
:func:`machine.block_start`); note that these executors place a copy's
destination block at ``max(dst, 0)``, as the JAX kernels do.
"""
from __future__ import annotations

import torch

from ...core import isa
from ...core.machine import (_arange, masked_copy, maybe_store, read_index,
                             store_where)

# per-context init-vector layout (int32[8]) shared with the CUDA kernel:
INIT_HEAD, INIT_TAIL, INIT_ENABLE, INIT_COMPLETIONS = 0, 1, 2, 3
INIT_MSG_HEAD, INIT_MSG_TAIL, INIT_FUEL, INIT_HALTED = 4, 5, 6, 7
STAT_HEAD, STAT_ENABLE, STAT_COMPLETIONS = 0, 1, 2
STAT_MSG_HEAD, STAT_HALTED, STAT_STOPPED, STAT_RESPONSES = 3, 4, 5, 6


def _fields(mem, rows, wr_addr):
    """The 8 fields of each row's WR and its clipped opcode."""
    L = mem.shape[-1]
    f = mem[rows[:, None],
            read_index(wr_addr[:, None] + _arange(isa.WR_WORDS, mem.device),
                       L)]
    opcode = ((f[:, isa.F_CTRL] >> isa.ID_BITS) & 0x7F).clamp(
        0, isa.NUM_OPCODES - 1)
    return f, opcode


def _scalar_verbs(mem, rows, opcode, d, opa, opb):
    """WRITE_IMM / CAS / ADD / MAX / MIN on ``mem[r, d]`` (d >= 0; dropped
    past the image).  Returns the old word (clamped read)."""
    L = mem.shape[-1]
    old = mem[rows, read_index(d, L)]
    new = torch.where(opcode == isa.WRITE_IMM, opa, old)
    new = torch.where(opcode == isa.CAS, torch.where(old == opa, opb, old),
                      new)
    new = torch.where(opcode == isa.ADD, old + opa, new)
    new = torch.where(opcode == isa.MAX, torch.maximum(old, opa), new)
    new = torch.where(opcode == isa.MIN, torch.minimum(old, opa), new)
    store_where(mem, rows, d, new, torch.ones_like(d, dtype=torch.bool))
    return old


def step_wr(mem, rows, wr_addr):
    """Execute, in place, the WR at ``wr_addr[i]`` of image ``rows[i]``
    (straight-line subset).  Returns each row's HALT flag."""
    f, opcode = _fields(mem, rows, wr_addr)
    d = f[:, isa.F_DST].clamp_min(0)
    is_copy = (opcode == isa.WRITE) | (opcode == isa.READ)
    masked_copy(mem, rows, f[:, isa.F_SRC], d,
                torch.where(is_copy, f[:, isa.F_LEN], 0))
    _scalar_verbs(mem, rows, opcode, d, f[:, isa.F_OPA], f[:, isa.F_OPB])
    return opcode == isa.HALT


def run_chain_reference(mems, wq_base: int, n_wrs: int, max_steps: int):
    """Run up to max_steps WRs of a single circular WQ starting at slot 0,
    one image per row.  Returns ``(mems, head)``."""
    mem = mems.clone()
    n = mem.shape[0]
    head = torch.zeros(n, dtype=torch.int32, device=mem.device)
    rows = torch.arange(n, device=mem.device)
    for _ in range(max_steps):
        if rows.numel() == 0:
            break
        addr = wq_base + torch.remainder(head[rows], n_wrs) * isa.WR_WORDS
        halt = step_wr(mem, rows, addr)
        head[rows] += 1
        rows = rows[~halt]                  # frozen once halted
    return mem, head


def step_wr_managed(mem, rows, wr_addr, payload, enable_limit):
    """Execute, in place, the WR at ``wr_addr[i]`` of image ``rows[i]`` with
    managed-WQ semantics.  ``payload`` is each row's head message
    (R, MSG_WORDS) for RECV.  Returns ``(enable_limit, halted)``; ENABLE
    and WAIT targets clip to the one queue itself."""
    L = mem.shape[-1]
    f, opcode = _fields(mem, rows, wr_addr)
    src, opa, opb = f[:, isa.F_SRC], f[:, isa.F_OPA], f[:, isa.F_OPB]
    d = f[:, isa.F_DST].clamp_min(0)
    # single-WQ subset: SEND is only the client-response form (opb < 0)
    is_copy = ((opcode == isa.WRITE) | (opcode == isa.READ)
               | ((opcode == isa.SEND) & (opb < 0)))
    masked_copy(mem, rows, src, d, torch.where(is_copy, f[:, isa.F_LEN], 0))
    old = _scalar_verbs(mem, rows, opcode, d, opa, opb)
    maybe_store(mem, rows,
                torch.where((opcode == isa.CAS) | (opcode == isa.ADD), src,
                            -1), old)
    is_recv = opcode == isa.RECV
    if bool(is_recv.any()):
        a = f[:, isa.F_AUX].clamp_min(0)
        n = torch.where(is_recv, mem[rows, read_index(a, L)].clamp(
            0, isa.MAX_SCATTER), 0)
        for i in range(isa.MAX_SCATTER):
            dd = mem[rows, read_index(a + (1 + i), L)].clamp_min(0)
            store_where(mem, rows, dd, payload[:, i], i < n)
    enable_limit = torch.where(opcode == isa.ENABLE,
                               torch.maximum(enable_limit, opa), enable_limit)
    return enable_limit, opcode == isa.HALT


def managed_chain_loop(mems, msgs, inits, *, wq_base: int, n_wrs: int,
                       managed: bool, max_steps: int):
    """Run managed single-WQ contexts until stall/HALT/fuel exhaustion.

    ``mems``: (n, M) int32 images; ``msgs``: (n, CAP*MSG_WORDS) staged
    inbound messages; ``inits``: (n, 8) int32 per the INIT_* layout —
    ``INIT_FUEL`` is the maximum number of *executed* WRs (mirroring
    ``machine.run``'s ``steps < max_steps`` condition), while ``max_steps``
    bounds loop iterations.  Returns ``(mems, stats)`` with ``stats`` (n,
    8) int32 per the STAT_* layout.
    """
    mem = mems.clone()
    n, dev = mem.shape[0], mem.device
    cap = msgs.shape[1] // isa.MSG_WORDS
    inits = inits.to(torch.int32)
    head0, tail = inits[:, INIT_HEAD], inits[:, INIT_TAIL]
    msg_tail, fuel = inits[:, INIT_MSG_TAIL], inits[:, INIT_FUEL]
    head = head0.clone()
    enable = inits[:, INIT_ENABLE].clone()
    comps = inits[:, INIT_COMPLETIONS].clone()
    mhead = inits[:, INIT_MSG_HEAD].clone()
    resps = torch.zeros(n, dtype=torch.int32, device=dev)
    halted = inits[:, INIT_HALTED] > 0       # a HALTed machine stays stopped
    rows = torch.arange(n, device=dev)[~halted]
    msg_ar = _arange(isa.MSG_WORDS, dev)
    for _ in range(max_steps):
        if rows.numel() == 0:
            break
        h = head[rows]
        addr = wq_base + torch.remainder(h, n_wrs) * isa.WR_WORDS
        f, opcode = _fields(mem, rows, addr)
        opa = f[:, isa.F_OPA]
        limit = (torch.minimum(tail[rows], enable[rows]) if managed
                 else tail[rows])
        runnable = ((h < limit)
                    & torch.where(opcode == isa.WAIT, comps[rows] >= opa,
                                  True)
                    & torch.where(opcode == isa.RECV,
                                  mhead[rows] < msg_tail[rows], True)
                    & (h - head0[rows] < fuel[rows]))
        # a row that cannot run now is stopped for good
        rows, addr, f, opcode = (rows[runnable], addr[runnable],
                                 f[runnable], opcode[runnable])
        if rows.numel() == 0:
            break
        start = torch.remainder(mhead[rows], cap) * isa.MSG_WORDS
        payload = msgs[rows[:, None], start.long()[:, None] + msg_ar]
        enable[rows], halt = step_wr_managed(mem, rows, addr, payload,
                                             enable[rows])
        signaled = (f[:, isa.F_FLAGS] & isa.FLAG_SUPPRESS_COMPLETION) == 0
        comps[rows] += signaled.int()
        mhead[rows] += (opcode == isa.RECV).int()
        resps[rows] += ((opcode == isa.SEND)
                        & (f[:, isa.F_OPB] < 0)).int()
        head[rows] += 1
        halted[rows] |= halt
        rows = rows[~halt]
    stopped = torch.ones(n, dtype=torch.bool, device=dev)
    stopped[rows] = False
    stats = torch.stack([
        head, enable, comps, mhead, halted.int(), stopped.int(), resps,
        torch.zeros(n, dtype=torch.int32, device=dev)], dim=1)
    return mem, stats
