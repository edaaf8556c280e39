"""The chain interpreter's wrapper: every row of a batched ``VMState`` run to
its own stop, in place.

:func:`run_interp` takes the plain version, the host loop
:func:`repro_torch.core.machine.plain_run` (``machine._run_rows``), for
states on the CPU, and launches the CUDA kernel (``csrc/chain_interp.cu``)
for states on the card: one launch for the whole batch, with no host read
inside it.  ``launches`` counts kernel launches.  There is no fallback: a
state or plan the kernel cannot take raises.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ...core import cost, isa, machine
from .. import _build

launches = {"run_interp": 0}

# one block a row, one thread a WQ
MAX_WQS = 1024

# the fields the kernel reads and writes, by dtype
_INT_FIELDS = ("mem", "head", "tail", "enable_limit", "completions",
               "msg_buf", "msg_head", "msg_tail", "steps", "verb_counts",
               "responses")
_FLOAT_FIELDS = ("last_comp_time", "clock")


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.chain_interp_run.argtypes = [p] * 19 + [i] * 8 + [p]
    lib.chain_interp_run.restype = i
    lib.cuda_error_string.argtypes = [i]
    lib.cuda_error_string.restype = ctypes.c_char_p


@functools.lru_cache(maxsize=64)
def _tables(spec: machine.MachineSpec, dev: torch.device):
    """The spec's geometry as int32 (4, N): WR base, WR slots, ordering,
    managed; and the cost tables of ``core/cost.py`` as float32: fetch by
    ordering, exec by opcode, then the doorbell."""
    geometry = np.array([spec.wq_bases, spec.wq_sizes, spec.orderings,
                         spec.managed], np.int32).reshape(4, spec.num_wqs)
    costs = np.concatenate([np.asarray(cost.FETCH_BY_ORDERING, np.float32),
                            np.asarray(cost.EXEC_COST, np.float32),
                            np.float32([cost.DOORBELL_BASE])])
    return (torch.from_numpy(geometry).to(dev),
            torch.from_numpy(costs).to(dev))


@functools.lru_cache(maxsize=64)
def _slices(writer_slices: tuple, n_wq: int, dev: torch.device):
    """Each writer's WQs as int32 (W, 2) ``[lo, hi)``, Python's slice rule
    on ``range(n_wq)`` (that of ``machine._writer_masks``)."""
    rows = []
    for lo, hi in writer_slices:
        start, stop, _ = slice(lo, hi).indices(n_wq)
        rows.append((start, max(start, stop)))
    return torch.tensor(rows, dtype=torch.int32,
                        device=dev).reshape(len(rows), 2)


def _check(spec: machine.MachineSpec, s: machine.VMState, faults=None,
          quota=None, writer_slices=None) -> None:
    """Raise ``ValueError`` unless the kernel can take ``s`` (batched, every
    field contiguous on one CUDA device, of the interpreter's dtypes and
    shapes for ``spec``), the plan and the schedule."""
    n = spec.num_wqs
    if not 1 <= n <= MAX_WQS:
        raise ValueError(f"a spec of {n} WQs: the interpreter kernel runs "
                         f"1 to {MAX_WQS} WQs (one thread each)")
    if any(size < 1 for size in spec.wq_sizes) or any(
            not 0 <= o < len(cost.FETCH_BY_ORDERING)
            for o in spec.orderings):
        raise ValueError(f"WQ sizes {spec.wq_sizes} must be positive and "
                         f"orderings {spec.orderings} in [0, 3)")
    if s.mem.ndim != 2:
        raise ValueError(f"a batched state (mem (B, L)), got mem of shape "
                         f"{tuple(s.mem.shape)}")
    b, length = s.mem.shape
    cap = s.msg_buf.shape[2] if s.msg_buf.ndim == 4 else 0
    shapes = dict(mem=(b, length), msg_buf=(b, n, cap, isa.MSG_WORDS),
                  steps=(b,), halted=(b,), responses=(b,),
                  verb_counts=(b, isa.NUM_OPCODES))
    for name, t in zip(machine.VMState._fields, s):
        want = shapes.get(name, (b, n))
        if tuple(t.shape) != want:
            raise ValueError(f"{name} of shape {tuple(t.shape)}, expected "
                             f"{want} for {b} machines of {n} WQs")
        dtype = (torch.int32 if name in _INT_FIELDS else torch.float32
                 if name in _FLOAT_FIELDS else torch.bool)
        if t.dtype != dtype:
            raise ValueError(f"{name} of dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous: the kernel writes "
                             f"the caller's tensors in place")
        if t.device != s.mem.device:
            raise ValueError(f"{name} on {t.device}, mem on {s.mem.device}")
    if length < isa.MAX_COPY or cap < 1:
        raise ValueError(f"an image of {length} words (at least "
                         f"{isa.MAX_COPY}) and {cap} message slots (at "
                         f"least 1)")
    if faults is not None:
        for leaf in faults:
            if leaf.numel() not in (1, b):
                raise ValueError(f"a fault plan of one value or one a "
                                 f"machine ({b}) a leaf; got "
                                 f"{tuple(leaf.shape)}")
    if quota is not None:
        if faults is not None:
            raise ValueError("a schedule and a fault plan in one run")
        if writer_slices is None or quota.ndim != 3 or \
                quota.shape[0] != b or \
                quota.shape[2] != len(writer_slices) or \
                quota.dtype != torch.int32 or quota.device != s.mem.device:
            raise ValueError(
                f"a (B, R, W) int32 quota on the state's device for {b} "
                f"machines and its writers; got {tuple(quota.shape)} "
                f"{quota.dtype} on {quota.device}")
    if s.mem.device.type != "cuda":
        raise ValueError(f"a state on {s.mem.device}: the interpreter "
                         f"kernel runs on CUDA tensors (CPU tensors take "
                         f"the plain path)")


def run_interp(spec: machine.MachineSpec, s: machine.VMState,
               max_steps: int = 4096, faults=None, quota=None,
               writer_slices=None) -> machine.VMState:
    """Run every row of the batched state ``s`` to its own stop, updating
    ``s`` in place (and returning it), as :func:`machine.run_batch_in_place`
    does; with ``quota`` (int32 (B, R, W)) and ``writer_slices``, each
    row walks its rounds and writers as
    :func:`machine.run_scheduled_in_place` does.  ``faults``: a
    :class:`repro_torch.core.faults.FaultPlan`, one row a machine (or
    scalar leaves for all).

    On the CPU the plain version, :func:`machine.plain_run`; on the card
    one launch of ``chain_interp_kernel``, which needs ``_check``'s
    layout."""
    if s.mem.device.type == "cpu":
        return machine.plain_run(spec, s, max_steps, faults, quota,
                                 writer_slices)
    if faults is not None:
        faults = type(faults)(*(torch.as_tensor(
            leaf, device=s.mem.device).to(torch.int32) for leaf in faults))
    _check(spec, s, faults, quota, writer_slices)
    b, length = s.mem.shape
    if b == 0:
        return s
    dev = s.mem.device
    geometry, costs = _tables(spec, dev)
    plan = slices = None
    if faults is not None:
        plan = torch.stack([leaf.reshape(-1).expand(b) for leaf in faults],
                           dim=1).contiguous()
    rounds, writers, stride = 0, 0, 0
    if quota is not None:
        rounds, writers = quota.shape[1:]
        if quota.stride(0) == 0:         # one plan for every machine
            quota = quota[0].contiguous()
        else:
            quota = quota.contiguous()
            stride = rounds * writers
        slices = _slices(tuple((int(lo), int(hi)) for lo, hi in writer_slices),
                         spec.num_wqs, dev)
    lib = _build.load("chain_interp", _declare)
    ptr = _build.pointer
    _build.check(lib, lib.chain_interp_run(
        *(ptr(t) for t in s), ptr(geometry), ptr(costs),
        None if plan is None else ptr(plan),
        None if quota is None else ptr(quota),
        None if slices is None else ptr(slices), stride, rounds, writers,
        b, spec.num_wqs, length, s.msg_buf.shape[2],
        max(min(int(max_steps), 2 ** 31 - 1), -2 ** 31),
        _build.stream()), "chain_interp_run")
    launches["run_interp"] += 1
    return s
