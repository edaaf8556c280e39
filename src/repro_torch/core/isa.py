"""RedN work-request ISA, 32-bit form (the port's copy of ``repro.core.isa``).

A flat, word-addressed int32 memory holds the work queues (the code
region), data, registers and message buffers, so a WRITE/CAS/ADD whose
destination is a field of a later WR edits the program (self-modifying
chains, RedN §3.2).  The control word packs ``opcode:8 | id:24``; the 24-bit
id is the operand one CAS can compare (RedN §3.5 chains several CAS for
wider operands).

Work request layout (8 words)::

    0 ctrl   opcode << 24 | (id & 0xFFFFFF)   the CAS target
    1 flags  bit0: SUPPRESS_COMPLETION
    2 src    word address; CAS/ADD: return-old address or -1
    3 dst    word address
    4 len    copy length in words, <= MAX_COPY
    5 opa    CAS old / immediate / addend / WAIT count
    6 opb    CAS new / WAIT+ENABLE target WQ / SEND target WQ
    7 aux    RECV scatter-table address

The constants are kept numerically identical to the JAX package's; the
parity tests compare them.
"""
from __future__ import annotations

import numpy as np

# --- opcodes ---------------------------------------------------------------
NOOP = 0
WRITE = 1        # copy mem[src:src+len] -> mem[dst:dst+len] (posted)
WRITE_IMM = 2    # mem[dst] = opa (immediate)
READ = 3         # copy mem[src:src+len] -> mem[dst:dst+len] (non-posted cost)
SEND = 4         # opb >= 0: enqueue payload on WQ opb's message queue
                 # opb <  0: deliver payload to response region at dst
RECV = 5         # pop one message; scatter words per table at aux
CAS = 6          # old=mem[dst]; if old==opa: mem[dst]=opb; if src>=0 mem[src]=old
ADD = 7          # old=mem[dst]; mem[dst]=old+opa;          if src>=0 mem[src]=old
MAX = 8          # mem[dst] = max(mem[dst], opa)   (ConnectX Calc verb)
MIN = 9          # mem[dst] = min(mem[dst], opa)   (ConnectX Calc verb)
WAIT = 10        # block WQ until completions[opb] >= opa
ENABLE = 11      # enable_limit[opb] = max(enable_limit[opb], opa)
HALT = 12        # simulation pseudo-verb: stop the machine

NUM_OPCODES = 13

OPCODE_NAMES = [
    "NOOP", "WRITE", "WRITE_IMM", "READ", "SEND", "RECV", "CAS", "ADD",
    "MAX", "MIN", "WAIT", "ENABLE", "HALT",
]

# --- WR field indices (word offsets within the 8-word WR) -------------------
WR_WORDS = 8
F_CTRL = 0       # packed opcode|id
F_FLAGS = 1
F_SRC = 2
F_DST = 3
F_LEN = 4
F_OPA = 5
F_OPB = 6
F_AUX = 7

FIELD_NAMES = {
    "ctrl": F_CTRL, "flags": F_FLAGS, "src": F_SRC, "dst": F_DST,
    "len": F_LEN, "opa": F_OPA, "opb": F_OPB, "aux": F_AUX,
}

# --- flags ------------------------------------------------------------------
FLAG_SUPPRESS_COMPLETION = 1  # bit0: do NOT generate a completion event

# --- copy / scatter bounds ---------------------------------------------------
MAX_COPY = 16      # max words moved by one copy verb inside the VM
MAX_SCATTER = 16   # paper: "RECVs can only perform 16 scatters" (§5.3)
MSG_WORDS = 16     # message payload words per SEND

ID_MASK = 0x00FFFFFF
ID_BITS = 24


def pack_ctrl(opcode: int, id_val: int = 0) -> int:
    """Pack opcode|id into the int32 control word (sign-safe for int32)."""
    v = ((opcode & 0x7F) << ID_BITS) | (int(id_val) & ID_MASK)
    return int(np.int32(v))


def unpack_opcode(ctrl: int) -> int:
    return (int(ctrl) >> ID_BITS) & 0x7F


def unpack_id(ctrl: int) -> int:
    return int(ctrl) & ID_MASK


# --- WQ ordering modes (cost model; §3.1 Fig. 2) -----------------------------
ORD_WQ = 0          # default work-queue order (prefetch allowed)
ORD_COMPLETION = 1  # completion order (WAIT-chained)
ORD_DOORBELL = 2    # doorbell order (managed WQ, fetch one-by-one)

ORDERING_NAMES = ["wq", "completion", "doorbell"]
