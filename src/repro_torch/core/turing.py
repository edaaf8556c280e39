"""Turing-completeness demonstration (paper Appendix A, constructive form;
the port's ``repro.core.turing``).

The paper proves RDMA Turing complete by showing the verb set emulates
Dolan's x86 ``mov`` machine (immediate/indirect/indexed addressing +
nontermination via WQ recycling).  Here we go one step further and *run* a
stored-program computer on the chain VM: a WQ-recycled interpreter for the
single-instruction **ADDLEQ** OISC (``mem[b] += mem[a]; if mem[b] <= 0
goto c else fall through`` — a known Turing-complete one-instruction set).

Every interpreter lap executes exactly one guest instruction using only
RDMA verbs:

* operand fetch      — indirect ``mov`` (WRITE-patches-READ, Appendix A);
* the add            — WRITE-patched ADD (indexed-``mov`` style);
* the ``<= 0`` test  — Mellanox Calc verbs MIN/MAX clamp the result to
  {0,1}, a READ reflects it into a conditional WR's control word, and a
  CAS converts NOOP->WRITE (the Fig. 4 conditional);
* the branch         — both branch targets are *written to the PC*: the
  taken target unconditionally, then the fall-through overrides it iff the
  conditional fired;
* halting            — a guard conditional converts to the HALT pseudo-verb
  when PC equals the halt sentinel;
* nontermination     — the interpreter WQ recycles itself (§3.4), bumping
  its own monotonic ENABLE watermark with an ADD each lap.

Guest programs live in plain VM memory as 4-word instructions
``[a, b, c, 0]`` with *absolute word addresses* (stride 4 keeps PC
arithmetic to a single ADD).  The halt sentinel is PC == 1.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import torch

from . import isa, machine
from .assembler import Program

HALT_PC = 1
INSTR_WORDS = 4


# ---------------------------------------------------------------------------
# guest-side: a tiny ADDLEQ assembler + reference emulator
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AddleqProgram:
    """Guest program: list of (a, b, c) with symbolic or absolute operands."""
    instrs: List[Tuple[int, int, int]]
    data: Dict[int, int]            # absolute addr -> initial value


def addleq_reference(instrs: Sequence[Tuple[int, int, int]],
                     mem: Dict[int, int], pc0: int, base: int,
                     max_instrs: int = 1000) -> Tuple[Dict[int, int], int]:
    """Pure-python ADDLEQ oracle (the hypothesis-test reference)."""
    m = dict(mem)
    pc = pc0
    n = 0
    while pc != HALT_PC and n < max_instrs:
        idx = (pc - base) // INSTR_WORDS
        a, b, c = instrs[idx]
        m[b] = m.get(b, 0) + m.get(a, 0)
        pc = c if m[b] <= 0 else pc + INSTR_WORDS
        n += 1
    return m, n


# ---------------------------------------------------------------------------
# host-side: the chain interpreter
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ChainInterpreter:
    prog: Program
    spec: machine.MachineSpec
    state0: machine.VMState
    pc_addr: int
    instr_base: int
    data_base: int
    lap_words: int

    def load(self, guest: AddleqProgram,
             pc0: int | None = None) -> machine.VMState:
        """The interpreter's state with ``guest`` written into a copy of
        its image, on the image's device."""
        mem = self.state0.mem.cpu().numpy().copy()
        for i, (a, b, c) in enumerate(guest.instrs):
            o = self.instr_base + i * INSTR_WORDS
            mem[o:o + 4] = [a, b, c, 0]
        for addr, v in guest.data.items():
            mem[addr] = v
        mem[self.pc_addr] = self.instr_base if pc0 is None else pc0
        return self.state0._replace(
            mem=torch.from_numpy(mem).to(self.state0.mem.device))

    def run(self, state: machine.VMState, max_steps: int = 4096):
        return machine.run(self.spec, state, max_steps)


def build_interpreter(mem_words: int = 4096, n_instr_slots: int = 32,
                      n_data_slots: int = 32,
                      device=None) -> ChainInterpreter:
    """The ADDLEQ interpreter: one managed, recycled 26-WR queue a guest
    instruction, its state on ``device`` (default CUDA, see
    :func:`repro_torch.device.resolve`)."""
    p = Program(mem_words)

    # guest registers / regions ------------------------------------------------
    # [RA, RB, RC] contiguous so one len-3 READ fetches a whole instruction
    regs = p.alloc(3, [0, 0, 0], "regs")
    RA, RB, RC = regs, regs + 1, regs + 2
    VA = p.word(0, "va")          # value at [a]
    RES = p.word(0, "res")        # mem[b] after the add
    T = p.word(0, "t")            # clamp temp
    PCN = p.word(0, "pcn")        # PC + 4 (fall-through)
    PC = p.word(0, "pc")
    data_base = p.alloc(n_data_slots, [0] * n_data_slots, "guest_data")
    instr_base = p.alloc(n_instr_slots * INSTR_WORDS,
                         [0] * (n_instr_slots * INSTR_WORDS), "guest_code")

    size = 26
    wq = p.add_wq(size, ordering=isa.ORD_DOORBELL, managed=True,
                  recycled=True, initial_enable=4)

    # 0-3: halt guard ----------------------------------------------------------
    guard = None
    wq.read(src=PC, dst=wq.future_wr_addr(3, "ctrl"), ln=1, tag="tm.refl")
    wq.cas(dst=wq.future_wr_addr(2, "ctrl"), old=isa.pack_ctrl(isa.NOOP, HALT_PC),
           new=isa.pack_ctrl(isa.HALT, 0), tag="tm.haltcas")
    en = wq.enable(wq, upto=size + 4, tag="tm.enable")
    guard = wq.post(isa.NOOP, tag="tm.guard")

    # 4-5: fetch [a, b, c] <- mem[PC:PC+3] (indirect mov) -----------------------
    wq.write(src=PC, dst=wq.future_wr_addr(1, "src"), ln=1, tag="tm.pc2ld")
    wq.read(src=0, dst=regs, ln=3, tag="tm.ldabc")

    # 6-7: VA <- mem[a] ----------------------------------------------------------
    wq.write(src=RA, dst=wq.future_wr_addr(1, "src"), ln=1, tag="tm.a2ld")
    wq.read(src=0, dst=VA, ln=1, tag="tm.ldva")

    # 8-10: mem[b] += VA (indexed-mov-style patched ADD) -------------------------
    wq.write(src=VA, dst=wq.future_wr_addr(2, "opa"), ln=1, tag="tm.va2add")
    wq.write(src=RB, dst=wq.future_wr_addr(1, "dst"), ln=1, tag="tm.b2add")
    wq.add(dst=0, addend=0, tag="tm.add")

    # 11-12: RES <- mem[b] --------------------------------------------------------
    wq.write(src=RB, dst=wq.future_wr_addr(1, "src"), ln=1, tag="tm.b2ld")
    wq.read(src=0, dst=RES, ln=1, tag="tm.ldres")

    # 13-15: T <- clamp(RES, 0, 1)  (Calc verbs; T==1 iff RES >= 1) --------------
    wq.write(src=RES, dst=T, ln=1, tag="tm.res2t")
    wq.min_(dst=T, operand=1, tag="tm.min")
    wq.max_(dst=T, operand=0, tag="tm.max")

    # 16-17: PCN <- PC + 4 ---------------------------------------------------------
    wq.write(src=PC, dst=PCN, ln=1, tag="tm.pc2pcn")
    wq.add(dst=PCN, addend=INSTR_WORDS, tag="tm.inc")

    # 18: branch taken by default: PC <- c ----------------------------------------
    wq.write(src=RC, dst=PC, ln=1, tag="tm.jump")

    # 19-21: if T == 1 (RES > 0) override with fall-through -------------------------
    wq.read(src=T, dst=wq.future_wr_addr(2, "ctrl"), ln=1, tag="tm.t2sel")
    wq.cas(dst=wq.future_wr_addr(1, "ctrl"), old=isa.pack_ctrl(isa.NOOP, 1),
           new=isa.pack_ctrl(isa.WRITE, 0), tag="tm.selcas")
    wq.post(isa.NOOP, src=PCN, dst=PC, ln=1, tag="tm.sel")

    # 22: wqe_count maintenance (§3.4) ----------------------------------------------
    wq.add(dst=en.addr("opa"), addend=size, tag="tm.bump")
    while wq.n_posted < size:
        wq.noop(signaled=False, tag="tm.pad")

    spec, st0 = p.finalize(device=device)
    return ChainInterpreter(prog=p, spec=spec, state0=st0, pc_addr=PC,
                            instr_base=instr_base, data_base=data_base,
                            lap_words=size)


# ---------------------------------------------------------------------------
# demo guest programs
# ---------------------------------------------------------------------------

def guest_countdown(interp: ChainInterpreter, n: int) -> AddleqProgram:
    """Decrement ``counter`` from n to 0, then halt (loop + conditional)."""
    d = interp.data_base
    counter, minus1, z0, z1 = d, d + 1, d + 2, d + 3
    i0 = interp.instr_base
    instrs = [
        (minus1, counter, HALT_PC),     # counter -= 1; if <= 0 halt
        (z0, z1, i0),                   # z1 += 0 (== 0) -> always jump back
    ]
    return AddleqProgram(instrs, {counter: n, minus1: -1, z0: 0, z1: 0})


def guest_add(interp: ChainInterpreter, x: int, y: int) -> AddleqProgram:
    """acc = x + y (both positive), then halt."""
    d = interp.data_base
    xa, ya, big = d, d + 1, d + 2
    instrs = [
        (xa, ya, HALT_PC),              # y += x; halts only if <= 0
        (big, big, HALT_PC),            # big += big stays negative -> halt
    ]
    return AddleqProgram(instrs, {xa: x, ya: y, big: -(1 << 20)})


def guest_multiply(interp: ChainInterpreter, x: int, y: int) -> AddleqProgram:
    """acc = x * y via repeated addition (nested control flow)."""
    d = interp.data_base
    xa, cnt, acc, minus1, z0, z1, big = d, d + 1, d + 2, d + 3, d + 4, d + 5, d + 6
    i = interp.instr_base

    def I(k):  # address of instruction k
        return i + k * INSTR_WORDS

    instrs = [
        (xa, acc, I(1)),                # 0: acc += x (acc>0 falls through too)
        (minus1, cnt, HALT_PC),         # 1: cnt -= 1; if <= 0 halt
        (z0, z1, I(0)),                 # 2: jump 0
    ]
    return AddleqProgram(instrs, {xa: x, cnt: y, acc: 0, minus1: -1,
                                  z0: 0, z1: 0, big: -(1 << 20)})
