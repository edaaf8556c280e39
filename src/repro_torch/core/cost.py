"""Verb cost model calibrated to RedN §5.1 (ConnectX-5, back-to-back IB).

The port's copy of ``repro.core.cost``.  Fidelity benchmarks price the
chains the VM executes with the paper's measured constants (microseconds):

* Fig. 7 — remote verb latencies: WRITE 1.6, READ/ADD/CAS/MAX ~1.8; the
  doorbell-MMIO + WR copy baseline is ~1.21 (NOOP); back-to-back network
  adds ~0.25 one way.
* Fig. 8 — chain of NOOPs: first verb 1.21, each additional verb
  +0.17 (WQ order), +0.19 (completion order), +0.54 (doorbell order).
* Table 1 — verb processing bandwidth: ConnectX-5 63M verbs/s (8 PUs).
* Table 3 — single-port throughput: CAS 8.4M/s, ADD 0.4M/s, READ 65M/s,
  WRITE 63M/s, MAX 63M/s.

latency(verb, position, mode) =
    (DOORBELL_BASE if first-in-queue else FETCH[mode]) + EXEC[opcode]

The tables are float32 built from the same decimal literals as the JAX
package's, so the interpreter's latency clocks (which pick the next WQ to
run) come out bit-identical.
"""
from __future__ import annotations

import numpy as np

from . import isa

US = 1.0  # all times in microseconds

DOORBELL_BASE = 1.21 * US          # doorbell MMIO + initial WR fetch (Fig 7/8)
NET_ONE_WAY = 0.25 * US            # back-to-back IB hop (Fig 7, loopback delta)

# per-additional-WR fetch cost by WQ ordering mode (Fig 8)
FETCH_BY_ORDERING = np.array([0.17, 0.19, 0.54], dtype=np.float32) * US

# per-opcode execution cost on top of fetch (calibrated to Fig 7)
_EXEC = np.zeros(isa.NUM_OPCODES, dtype=np.float32)
_EXEC[isa.NOOP] = 0.0
_EXEC[isa.WRITE] = 0.39        # posted PCIe write:   1.21 + 0.39 = 1.60
_EXEC[isa.WRITE_IMM] = 0.39
_EXEC[isa.SEND] = 0.39
_EXEC[isa.RECV] = 0.0
_EXEC[isa.READ] = 0.59         # non-posted:          1.21 + 0.59 = 1.80
_EXEC[isa.CAS] = 0.59
_EXEC[isa.ADD] = 0.59
_EXEC[isa.MAX] = 0.59
_EXEC[isa.MIN] = 0.59
_EXEC[isa.WAIT] = 0.0
_EXEC[isa.ENABLE] = 0.0
_EXEC[isa.HALT] = 0.0
EXEC_COST = _EXEC * US

# Table 1 — verb processing bandwidth per generation (verbs/s)
VERB_RATE = {
    "ConnectX-3": 15e6,
    "ConnectX-5": 63e6,
    "ConnectX-6": 112e6,
}
PUS = {"ConnectX-3": 2, "ConnectX-5": 8, "ConnectX-6": 16}

# Table 3 — single-port ConnectX-5 throughput (M ops/s)
TABLE3_THROUGHPUT = {
    "CAS": 8.4e6,
    "ADD": 0.4e6,
    "READ": 65e6,
    "WRITE": 63e6,
    "MAX": 63e6,
}

# per-verb *throughput* cost (pipelined; used by throughput models, not the
# latency clock): one PU retires 63/8 M verbs/s/PU for copy verbs; atomics
# serialize on PCIe atomic transactions.
PIPELINED_VERB_COST = {
    isa.WRITE: 1.0 / (63e6 / 8),
    isa.READ: 1.0 / (65e6 / 8),
    isa.CAS: 1.0 / 8.4e6,      # atomics serialize across PUs (§5.1.3)
    isa.ADD: 1.0 / 8.4e6,
    isa.MAX: 1.0 / (63e6 / 8),
}

# IB / PCIe bandwidth bounds used in Table 4's bottleneck analysis
IB_BW_GBPS = 92.0              # single-port IB limit observed (§5.2.2)
PCIE3_X16_GBPS = 128.0         # dual-port cap (§5.2.2)


def chain_latency_us(opcodes, ordering: int, first_is_doorbelled: bool = True,
                     net_hops: int = 0) -> float:
    """Closed-form latency of a single chain, matching the VM clock."""
    t = 0.0
    for i, op in enumerate(opcodes):
        fetch = DOORBELL_BASE if (i == 0 and first_is_doorbelled) \
            else float(FETCH_BY_ORDERING[ordering])
        t += fetch + float(EXEC_COST[op])
    return t + net_hops * NET_ONE_WAY
