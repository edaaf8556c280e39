"""The chain interpreter's wrappers: every row of a batched ``VMState``, or
of a :class:`repro_torch.core.machine.SharedBatch`, run to its own stop,
in place (:func:`run_interp`); and a write-side program's stateful
receive window walked in order over one persistent image an owner
(:func:`run_walk`).

:func:`run_interp` takes the plain version, the host loop
:func:`repro_torch.core.machine.plain_run` (``machine._run_rows``; for a
split batch :func:`machine.plain_run_shared`), for states on the CPU, and
launches the CUDA kernel (``csrc/chain_interp.cu``) for states on the
card: one launch for the whole batch, with no host read inside it (a
split batch then reads its rows' window flags once).  A split batch's
private words are staged in shared memory; a full batch runs in global
memory.  :func:`run_walk` takes its plain version,
:func:`repro_torch.kernels.chain_interp.ref.plain_walk`, for a window on
the CPU, and launches ``chain_walk_kernel`` (the same source, the same
step) for one on the card: one launch a stage, no host read.
``launches`` counts kernel launches, ``run_interp`` and ``walk``.
There is no fallback: a state, plan or layout the kernel cannot take
raises.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ...core import cost, faults as faults_mod, isa, machine
from .. import _build
from . import ref

launches = {"run_interp": 0, "walk": 0}

# one block a row, one thread a WQ
MAX_WQS = 1024

# the fields the kernel reads and writes, by dtype
_INT_FIELDS = ("mem", "head", "tail", "enable_limit", "completions",
               "msg_buf", "msg_head", "msg_tail", "steps", "verb_counts",
               "responses")
_FLOAT_FIELDS = ("last_comp_time", "clock")


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.chain_interp_run.argtypes = [p] * 21 + [i] * 11 + [p]
    lib.chain_interp_run.restype = i
    lib.chain_walk_run.argtypes = ([p] * 19 + [ctypes.POINTER(ctypes.c_int)]
                                   + [i] * 16 + [p])
    lib.chain_walk_run.restype = i
    lib.chain_interp_staged_budget.argtypes = [ctypes.POINTER(i)]
    lib.chain_interp_staged_budget.restype = i
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


@functools.lru_cache(maxsize=16)
def staged_budget(dev: torch.device) -> int:
    """Bytes of dynamic shared memory a split batch's block may take on
    ``dev``: the opt-in limit less the kernel's static arrays."""
    lib = _build.load("chain_interp", _declare)
    out = ctypes.c_int(0)
    with torch.cuda.device(dev):
        _build.check(lib, lib.chain_interp_staged_budget(ctypes.byref(out)),
                     "chain_interp_staged_budget")
    return out.value


def staged_bytes(n_wq: int, private_words: int) -> int:
    """A split batch's block's dynamic shared memory: the per-WQ arrays
    and the row's private words, staged."""
    return 4 * (n_wq * 9 + private_words)


def _check_spec(spec: machine.MachineSpec) -> None:
    """Raise ``ValueError`` unless the kernel's step can take ``spec``'s
    WQs."""
    n = spec.num_wqs
    if not 1 <= n <= MAX_WQS:
        raise ValueError(f"a spec of {n} WQs: the interpreter kernel runs "
                         f"1 to {MAX_WQS} WQs (one thread each)")
    if any(size < 1 for size in spec.wq_sizes) or any(
            not 0 <= o < len(cost.FETCH_BY_ORDERING)
            for o in spec.orderings):
        raise ValueError(f"WQ sizes {spec.wq_sizes} must be positive and "
                         f"orderings {spec.orderings} in [0, 3)")


def _check(spec: machine.MachineSpec, s: machine.VMState, faults=None,
          quota=None, writer_slices=None, length=None) -> None:
    """Raise ``ValueError`` unless the kernel can take ``s`` (batched, every
    field contiguous on one CUDA device, of the interpreter's dtypes and
    shapes for ``spec``), the plan and the schedule.  ``length``: the
    image's virtual length when ``s.mem`` holds private segments."""
    _check_spec(spec)
    n = spec.num_wqs
    if s.mem.ndim != 2:
        raise ValueError(f"a batched state (mem (B, L)), got mem of shape "
                         f"{tuple(s.mem.shape)}")
    b, width = s.mem.shape
    length = width if length is None else length
    cap = s.msg_buf.shape[2] if s.msg_buf.ndim == 4 else 0
    shapes = dict(mem=(b, width), msg_buf=(b, n, cap, isa.MSG_WORDS),
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


def _check_shared(batch: machine.SharedBatch) -> int:
    """Raise ``ValueError`` unless the kernel can take ``batch``'s base
    images and window; returns the images' length L."""
    base, s = batch.base, batch.state
    if base.ndim != 2 or base.dtype != torch.int32 or \
            not base.is_contiguous() or base.device != s.mem.device:
        raise ValueError(f"base images must be contiguous int32 (G, L) on "
                         f"{s.mem.device}; got {tuple(base.shape)} "
                         f"{base.dtype} on {base.device}")
    g, length = base.shape
    b = s.mem.shape[0] if s.mem.ndim == 2 else -1
    if g < 1 or b % g:
        raise ValueError(f"{b} contexts do not split over {g} base images")
    if not 0 <= batch.lo <= batch.hi <= length:
        raise ValueError(f"a window [{batch.lo}, {batch.hi}) outside an "
                         f"image of {length} words")
    want = length - (batch.hi - batch.lo)
    if s.mem.ndim == 2 and s.mem.shape[1] != want:
        raise ValueError(f"private segments of {s.mem.shape[1]} words, "
                         f"expected {want} (L {length} less the window)")
    return length


def run_interp(spec: machine.MachineSpec, s, max_steps: int = 4096,
               faults=None, quota=None, writer_slices=None):
    """Run every row of the batched state ``s`` to its own stop, updating
    ``s`` in place (and returning it), as :func:`machine.run_batch_in_place`
    does; with ``quota`` (int32 (B, R, W)) and ``writer_slices``, each
    row walks its rounds and writers as
    :func:`machine.run_scheduled_in_place` does.  ``faults``: a
    :class:`repro_torch.core.faults.FaultPlan`, one row a machine (or
    scalar leaves for all).  ``s`` may be a
    :class:`machine.SharedBatch` (no schedule): a store that would change
    a window word raises ``ValueError`` naming the rows.

    On the CPU the plain version, :func:`machine.plain_run` (or
    :func:`machine.plain_run_shared`); on the card one launch of
    ``chain_interp_kernel``, which needs ``_check``'s layout and, for a
    split batch, private segments within :func:`staged_budget`."""
    shared = isinstance(s, machine.SharedBatch)
    state = s.state if shared else s
    if shared and quota is not None:
        raise ValueError("a split batch runs without a schedule")
    if state.mem.device.type == "cpu":
        if shared:
            return machine.plain_run_shared(spec, s, max_steps, faults)
        return machine.plain_run(spec, s, max_steps, faults, quota,
                                 writer_slices)
    if faults is not None:
        faults = type(faults)(*(torch.as_tensor(
            leaf, device=state.mem.device).to(torch.int32) for leaf in faults))
    length = _check_shared(s) if shared else None
    _check(spec, state, faults, quota, writer_slices, length)
    b, width = state.mem.shape
    length = width if length is None else length
    dev = state.mem.device
    if shared and staged_bytes(spec.num_wqs, width) > staged_budget(dev):
        raise ValueError(
            f"private segments of {width} words with {spec.num_wqs} WQs "
            f"take {staged_bytes(spec.num_wqs, width)} bytes of shared "
            f"memory, over the {staged_budget(dev)} a block may take")
    if b == 0:
        return s
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
    # every row's flag is written by the kernel
    changed = (torch.empty(b, dtype=torch.int32, device=dev) if shared
               else None)
    lib = _build.load("chain_interp", _declare)
    ptr = _build.pointer
    _build.check(lib, lib.chain_interp_run(
        *(ptr(t) for t in state), ptr(geometry), ptr(costs),
        None if plan is None else ptr(plan),
        None if quota is None else ptr(quota),
        None if slices is None else ptr(slices),
        ptr(s.base) if shared else None,
        None if changed is None else ptr(changed), stride, rounds, writers,
        b, spec.num_wqs, length, state.msg_buf.shape[2],
        max(min(int(max_steps), 2 ** 31 - 1), -2 ** 31),
        s.per if shared else 1, s.lo if shared else length,
        s.hi if shared else length, _build.stream()), "chain_interp_run")
    launches["run_interp"] += 1
    if shared:
        rows = np.flatnonzero(changed.cpu().numpy()).tolist()
        if rows:
            raise machine.window_error(s, rows)
    return s


# the walk kernel's frames and commit statuses, at most
MAX_FRAMES = 2
MAX_COMMIT = 4
# log entries a step may add (a copy block, a RECV scatter)
LOG_PER_STEP = max(isa.MAX_COPY, isa.MAX_SCATTER)


def check_layout(prog) -> None:
    """Raise ``ValueError`` unless the walk kernel can take ``prog``'s
    :class:`repro_torch.core.programs.WalkLayout`: at most
    :data:`MAX_FRAMES` frames inside the image and apart, mirror rows no
    more than carry rows, at most :data:`MAX_COMMIT` commit statuses, the
    response word and the receive WQ in range, and ``state0``'s message
    queues empty (a run reads only messages it delivered or sent, so the
    queues need no reset between positions)."""
    layout, st0 = prog.walk_layout, prog.state0
    length = st0.mem.shape[-1]
    if not 1 <= len(layout.frames) <= MAX_FRAMES or not \
            1 <= len(layout.commit) <= MAX_COMMIT:
        raise ValueError(f"{len(layout.frames)} frames and "
                         f"{len(layout.commit)} commit statuses: the walk "
                         f"kernel takes 1 to {MAX_FRAMES} and 1 to "
                         f"{MAX_COMMIT}")
    spans = []
    for f in layout.frames:
        if not (1 <= f.n and f.n <= f.rows <= 2 * f.n and f.val_len >= 1):
            raise ValueError(f"a frame of {f.n} carry rows, {f.rows} image "
                             f"rows and {f.val_len} value words: the mirror "
                             f"rows must number at most the carry rows")
        spans += [(f.table_base, f.table_base + 3 * f.rows),
                  (f.values_base, f.values_base + f.val_len * f.rows)]
        if f.pad >= 0 and f.home_pad > 0:
            raise ValueError("a frame's pad words are carried or home "
                             "distances, not both")
    spans.sort()
    if spans[0][0] < 0 or spans[-1][1] > length or any(
            a[1] > b[0] for a, b in zip(spans, spans[1:])):
        raise ValueError(f"frames {spans} overlap or leave the image of "
                         f"{length} words")
    if not 0 <= layout.resp_region < length or not \
            0 <= layout.recv_wq < prog.spec.num_wqs:
        raise ValueError(f"response word {layout.resp_region} or receive WQ"
                         f" {layout.recv_wq} out of range")
    if bool((st0.msg_tail != st0.msg_head).any()):
        raise ValueError("state0 holds queued messages: the walk kernel "
                         "starts every position from empty queues")


@functools.lru_cache(maxsize=64)
def _walk_plan(prog) -> tuple:
    """:func:`check_layout` once a program (its host reads included), and
    the ints the kernel takes: 7 a frame (table and values base, carry
    and image rows, value words, pad carried, home-distance pad) for
    :data:`MAX_FRAMES` frames, then the commit statuses; and ``state0``'s
    steps, halted and responses."""
    check_layout(prog)
    layout, st0 = prog.walk_layout, prog.state0
    ints = [0] * (7 * MAX_FRAMES + MAX_COMMIT)
    for i, f in enumerate(layout.frames):
        ints[7 * i:7 * i + 7] = [f.table_base, f.values_base, f.n, f.rows,
                                 f.val_len, int(f.pad >= 0), f.home_pad]
    at = 7 * MAX_FRAMES
    ints[at:at + len(layout.commit)] = list(layout.commit)
    return tuple(ints), (int(st0.steps), int(st0.halted),
                         int(st0.responses))


def run_walk(prog, carry, rows: torch.Tensor, budget: int,
             faults: torch.Tensor = None, resp_words: int = 1):
    """Walk the S owners' windows ``rows`` (S, P, W) int32 through the
    single-chain write-side program ``prog``: each owner's image built
    once (``prog.device_state(*carry)``), then every position in order
    run on it and committed by ``prog.walk_layout``, as
    :func:`repro_torch.kernels.chain_interp.ref.plain_walk` says.
    ``budget``: each request's ``max_steps``; ``faults`` (S, P, FIELDS)
    int32 fault rows or None.  Returns ``(responses (S, P, resp_words),
    steps (S, P), the new carry)``.

    On the CPU the plain version; on the card one launch of
    ``chain_walk_kernel``, a block an owner, which makes no host read."""
    if rows.device.type == "cpu":
        return ref.plain_walk(prog, carry, rows, budget, faults, resp_words)
    layout, st0, spec = prog.walk_layout, prog.state0, prog.spec
    _check_spec(spec)
    ints, scalars = _walk_plan(prog)
    if rows.ndim != 3 or rows.dtype != torch.int32 or \
            not 1 <= rows.shape[-1] <= isa.MSG_WORDS or \
            not rows.is_contiguous():
        raise ValueError(f"a window of contiguous int32 (S, P, W) rows, W "
                         f"in [1, {isa.MSG_WORDS}]; got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    s, positions, width = rows.shape
    dev = rows.device
    if faults is not None and (
            tuple(faults.shape) != (s, positions, faults_mod.FIELDS)
            or faults.dtype != torch.int32 or not faults.is_contiguous()
            or faults.device != dev):
        raise ValueError(f"fault rows of contiguous int32 "
                         f"{(s, positions, faults_mod.FIELDS)} on {dev}; "
                         f"got {tuple(faults.shape)} {faults.dtype}")
    for name, t in zip(machine.VMState._fields, st0):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"state0.{name} on {t.device}, the window on "
                             f"{dev}, or not contiguous")
    length = st0.mem.shape[-1]
    if not 1 <= resp_words <= length - layout.resp_region:
        raise ValueError(f"{resp_words} response words past the image")
    if length < isa.MAX_COPY or spec.msg_capacity < 1:
        raise ValueError(f"an image of {length} words (at least "
                         f"{isa.MAX_COPY}) and {spec.msg_capacity} message "
                         f"slots (at least 1)")
    budget = max(min(int(budget), 2 ** 31 - 1), 0)
    log_cap = budget * LOG_PER_STEP
    if log_cap >= 2 ** 31 // max(s, 1):
        raise ValueError(f"a budget of {budget} steps: its store log "
                         f"overflows")
    resp = torch.zeros((s, positions, resp_words), dtype=torch.int32,
                       device=dev)
    steps = torch.zeros((s, positions), dtype=torch.int32, device=dev)
    img = prog.device_state(*carry).mem.to(torch.int32).contiguous()
    if tuple(img.shape) != (s, length):
        raise ValueError(f"images of shape {tuple(img.shape)} for a window "
                         f"of {s} owners")
    if s == 0 or positions == 0:
        return resp, steps, ref.read_carry(layout, img, carry)
    shadow = img.clone()
    msgs = st0.msg_buf.expand((s,) + tuple(st0.msg_buf.shape)).contiguous()
    log = torch.empty((s, max(log_cap, 1)), dtype=torch.int32, device=dev)
    vals = torch.empty_like(log)
    geometry, costs = _tables(spec, dev)
    frames = (ctypes.c_int * len(ints))(*ints)
    lib = _build.load("chain_interp", _declare)
    ptr = _build.pointer
    _build.check(lib, lib.chain_walk_run(
        ptr(img), ptr(shadow), ptr(msgs), ptr(log), ptr(vals), ptr(rows),
        None if faults is None else ptr(faults), ptr(resp), ptr(steps),
        ptr(st0.head), ptr(st0.tail), ptr(st0.enable_limit),
        ptr(st0.completions), ptr(st0.last_comp_time), ptr(st0.msg_head),
        ptr(st0.msg_tail), ptr(st0.clock), ptr(geometry), ptr(costs),
        frames, len(layout.frames), len(layout.commit), s, positions, width,
        spec.num_wqs, length, spec.msg_capacity, budget, layout.resp_region,
        resp_words, layout.recv_wq, log.shape[1], *scalars,
        _build.stream()),
        "chain_walk_run")
    launches["walk"] += 1
    return resp, steps, ref.read_carry(layout, img, carry)
