"""Assembler for RedN chain programs (the port's ``repro.core.assembler``).

Builds the flat memory image (code = work queues + data region) and the
static :class:`~repro_torch.core.machine.MachineSpec` — RedN's setup phase
(Fig. 1): the offload developer writes Python that *emits verbs*, and the
result is a self-contained image the VM (or the chain kernel) executes with
no host involvement.

Layout: work queues are allocated bottom-up from word 0 (the code region,
writable so chains can self-modify); data is allocated top-down from the
end of memory.  The two regions are collision-checked at
:meth:`Program.finalize`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import isa, machine


@dataclasses.dataclass(frozen=True)
class WRRef:
    """Handle to an emitted WR: resolves field addresses + completion index."""
    wq: int                  # WQ index
    slot: int                # slot within the WQ
    base: int                # absolute word address of the WR
    completion_count: int    # signaled completions in this WQ up to & incl.

    def addr(self, field: str) -> int:
        return self.base + isa.FIELD_NAMES[field]

    @property
    def ctrl_addr(self) -> int:
        return self.addr("ctrl")


class WQBuilder:
    def __init__(self, prog: "Program", index: int, base: int, size: int,
                 ordering: int, managed: bool, recycled: bool,
                 initial_enable: int):
        self.prog = prog
        self.index = index
        self.base = base
        self.size = size
        self.ordering = ordering
        self.managed = managed
        self.recycled = recycled
        self.initial_enable = initial_enable
        self.wrs: List[dict] = []
        self._signaled = 0

    # -- raw post ------------------------------------------------------------
    def post(self, opcode: int, *, id_: int = 0, src: int = -1, dst: int = -1,
             ln: int = 1, opa: int = 0, opb: int = 0, aux: int = -1,
             signaled: bool = True, tag: str = "") -> WRRef:
        if len(self.wrs) >= self.size:
            raise ValueError(
                f"WQ{self.index} overflow: size {self.size}")
        # build-time validation: what the static analyzer checks later is
        # rejected loudly here instead of deferring to runtime clamping.
        # (Self-modifying programs patch fields *after* posting, so the
        # analyzer remains the authority on the final image.)
        if not 0 <= opcode < isa.NUM_OPCODES:
            raise ValueError(
                f"WQ{self.index}[{len(self.wrs)}]: opcode {opcode} out of "
                f"range [0, {isa.NUM_OPCODES})")
        if opcode in (isa.WRITE, isa.READ, isa.SEND) and ln > isa.MAX_COPY:
            raise ValueError(
                f"WQ{self.index}[{len(self.wrs)}]: copy len {ln} exceeds "
                f"MAX_COPY={isa.MAX_COPY} "
                f"({isa.OPCODE_NAMES[opcode]}{f' {tag!r}' if tag else ''})")
        flags = 0 if signaled else isa.FLAG_SUPPRESS_COMPLETION
        slot = len(self.wrs)
        self.wrs.append(dict(ctrl=isa.pack_ctrl(opcode, id_), flags=flags,
                             src=src, dst=dst, ln=ln, opa=opa, opb=opb,
                             aux=aux, tag=tag, opcode=opcode))
        if signaled:
            self._signaled += 1
        return WRRef(self.index, slot, self.base + slot * isa.WR_WORDS,
                     self._signaled)

    # -- verb sugar ----------------------------------------------------------
    def noop(self, **kw) -> WRRef:
        return self.post(isa.NOOP, **kw)

    def write(self, src: int, dst: int, ln: int = 1, **kw) -> WRRef:
        return self.post(isa.WRITE, src=src, dst=dst, ln=ln, **kw)

    def write_imm(self, dst: int, value: int, **kw) -> WRRef:
        return self.post(isa.WRITE_IMM, dst=dst, opa=value, **kw)

    def read(self, src: int, dst: int, ln: int = 1, **kw) -> WRRef:
        return self.post(isa.READ, src=src, dst=dst, ln=ln, **kw)

    def cas(self, dst: int, old: int, new: int, ret: int = -1, **kw) -> WRRef:
        return self.post(isa.CAS, dst=dst, opa=old, opb=new, src=ret, **kw)

    def add(self, dst: int, addend: int, ret: int = -1, **kw) -> WRRef:
        return self.post(isa.ADD, dst=dst, opa=addend, src=ret, **kw)

    def max_(self, dst: int, operand: int, **kw) -> WRRef:
        return self.post(isa.MAX, dst=dst, opa=operand, **kw)

    def min_(self, dst: int, operand: int, **kw) -> WRRef:
        return self.post(isa.MIN, dst=dst, opa=operand, **kw)

    def send(self, src: int, ln: int, dst_region: int = -1,
             target_qp: int = -1, **kw) -> WRRef:
        """target_qp >= 0: inter-QP message; else client response to region."""
        return self.post(isa.SEND, src=src, dst=dst_region, ln=ln,
                         opb=target_qp, **kw)

    def recv(self, scatter_table: int, **kw) -> WRRef:
        return self.post(isa.RECV, aux=scatter_table, **kw)

    def wait(self, target: "WQBuilder | int", count: int, **kw) -> WRRef:
        tgt = target.index if isinstance(target, WQBuilder) else target
        return self.post(isa.WAIT, opa=count, opb=tgt, **kw)

    def wait_for(self, ref: WRRef, **kw) -> WRRef:
        """WAIT for a specific WR's (static) completion."""
        return self.post(isa.WAIT, opa=ref.completion_count, opb=ref.wq, **kw)

    def enable(self, target: "WQBuilder | int", upto: int, **kw) -> WRRef:
        """ENABLE execution of `target` up to absolute WR count `upto`."""
        tgt = target.index if isinstance(target, WQBuilder) else target
        return self.post(isa.ENABLE, opa=upto, opb=tgt, **kw)

    def halt(self, **kw) -> WRRef:
        return self.post(isa.HALT, **kw)

    @property
    def n_posted(self) -> int:
        return len(self.wrs)

    def future_wr_addr(self, ahead: int, field: str) -> int:
        """Absolute address of a field of the WR that will sit `ahead` slots
        after the next one posted (0 = the next post).  Lets a patch verb be
        emitted *before* its target without post-hoc list surgery."""
        return (self.base + (len(self.wrs) + ahead) * isa.WR_WORDS
                + isa.FIELD_NAMES[field])


class Program:
    def __init__(self, mem_words: int = 4096, msg_capacity: int = 8):
        self.mem_words = mem_words
        self.msg_capacity = msg_capacity
        self.wqs: List[WQBuilder] = []
        self._code_top = 0
        self._data_ptr = mem_words
        self._data_init: Dict[int, int] = {}
        self.symbols: Dict[str, int] = {}

    # -- queues ---------------------------------------------------------------
    def add_wq(self, size: int, ordering: int = isa.ORD_WQ,
               managed: bool = False, recycled: bool = False,
               initial_enable: int = 0) -> WQBuilder:
        base = self._code_top
        self._code_top += size * isa.WR_WORDS
        wq = WQBuilder(self, len(self.wqs), base, size, ordering, managed,
                       recycled, initial_enable)
        self.wqs.append(wq)
        return wq

    # -- data -----------------------------------------------------------------
    def alloc(self, n: int = 1, init: Optional[Sequence[int]] = None,
              name: Optional[str] = None) -> int:
        self._data_ptr -= n
        addr = self._data_ptr
        if init is not None:
            vals = list(init)
            if len(vals) > n:
                raise ValueError("init longer than allocation")
            for i, v in enumerate(vals):
                u = int(v) & 0xFFFFFFFF
                self._data_init[addr + i] = u - (1 << 32) if u >= (1 << 31) else u
        if name:
            self.symbols[name] = addr
        return addr

    def word(self, value: int = 0, name: Optional[str] = None) -> int:
        return self.alloc(1, [value], name)

    def scatter_table(self, dsts: Sequence[int]) -> int:
        """RECV scatter table: [n, dst0, dst1, ...] (n <= MAX_SCATTER)."""
        if len(dsts) > isa.MAX_SCATTER:
            raise ValueError(
                f"scatter table with {len(dsts)} entries exceeds "
                f"MAX_SCATTER={isa.MAX_SCATTER}")
        return self.alloc(1 + len(dsts), [len(dsts)] + list(dsts))

    # -- finalize ---------------------------------------------------------------
    def finalize(self, verify: bool = False, waivers: Sequence = (),
                 name: str = "program", device=None
                 ) -> Tuple[machine.MachineSpec, machine.VMState]:
        """Build the memory image + MachineSpec/VMState on ``device``
        (default CUDA, see :func:`repro_torch.device.resolve`).

        With ``verify=True`` the static verifier (`core.analysis`) runs
        over the finalized program first and raises
        :class:`analysis.VerificationError` on any finding not covered
        by ``waivers`` — the admission gate for generated programs.
        """
        if verify:
            from . import analysis      # lazy: keeps assembler import-light
            report = analysis.verify_program(self, waivers=waivers,
                                             name=name)
            if not report.ok():
                raise analysis.VerificationError(report)
        if self._code_top > self._data_ptr:
            raise ValueError(
                f"code ({self._code_top}) collides with data "
                f"({self._data_ptr}); grow mem_words")
        img = np.zeros(self.mem_words, dtype=np.int32)
        for wq in self.wqs:
            for slot, wr in enumerate(wq.wrs):
                o = wq.base + slot * isa.WR_WORDS
                img[o + isa.F_CTRL] = wr["ctrl"]
                img[o + isa.F_FLAGS] = wr["flags"]
                img[o + isa.F_SRC] = wr["src"]
                img[o + isa.F_DST] = wr["dst"]
                img[o + isa.F_LEN] = wr["ln"]
                img[o + isa.F_OPA] = wr["opa"]
                img[o + isa.F_OPB] = wr["opb"]
                img[o + isa.F_AUX] = wr["aux"]
        for a, v in self._data_init.items():
            img[a] = v

        # recycled WQs never run out of posted WRs, and unmanaged WQs are
        # never gated by an ENABLE watermark
        BIG = 1 << 29
        spec = machine.MachineSpec(
            mem_words=self.mem_words,
            wq_bases=tuple(w.base for w in self.wqs),
            wq_sizes=tuple(w.size for w in self.wqs),
            orderings=tuple(w.ordering for w in self.wqs),
            managed=tuple(w.managed for w in self.wqs),
            msg_capacity=self.msg_capacity,
        )
        tails = [BIG if w.recycled else w.n_posted for w in self.wqs]
        enables = [w.initial_enable if w.managed else BIG for w in self.wqs]
        state = machine.init_state(spec, img, tails, enables, device)
        return spec, state

    # -- verb accounting (Table 2) ---------------------------------------------
    def budget(self) -> Dict[str, int]:
        """Count posted verbs by Table-2 category: C(opy)/A(tomic)/E(order)."""
        cats = dict(C=0, A=0, E=0, other=0)
        copy_ops = {isa.WRITE, isa.WRITE_IMM, isa.READ, isa.NOOP, isa.SEND}
        atomic_ops = {isa.CAS, isa.ADD, isa.MAX, isa.MIN}
        order_ops = {isa.WAIT, isa.ENABLE}
        for wq in self.wqs:
            for wr in wq.wrs:
                op = wr["opcode"]
                if op in copy_ops:
                    cats["C"] += 1
                elif op in atomic_ops:
                    cats["A"] += 1
                elif op in order_ops:
                    cats["E"] += 1
                else:
                    cats["other"] += 1
        return cats
