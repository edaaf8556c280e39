"""Chain-VM wrappers: a batch of single-WQ client chains, one per row.

Each wrapper takes the plain PyTorch version (:mod:`.ref`) for tensors on
the CPU and launches the CUDA kernel (``csrc/chain_vm.cu``) for tensors on
the card.  ``launches`` counts kernel launches, per wrapper.
"""
from __future__ import annotations

import ctypes

import torch

from ...core import isa
from .. import _build
from .ref import managed_chain_loop, run_chain_reference

launches = {"run_managed": 0, "run_chains": 0}


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.chain_vm_run_managed.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i,
                                         p]
    lib.chain_vm_run_managed.restype = i
    lib.chain_vm_run_chains.argtypes = [p, p, i, i, i, i, i, p]
    lib.chain_vm_run_chains.restype = i
    lib.chain_vm_chase.argtypes = [p, p, i, i, i, i, p]
    lib.chain_vm_chase.restype = i
    lib.cuda_error_string.argtypes = [i]
    lib.cuda_error_string.restype = ctypes.c_char_p


def _check_images(mems: torch.Tensor, n_wrs: int) -> None:
    if n_wrs < 1:
        raise ValueError(f"a work queue needs at least one WR slot, got "
                         f"n_wrs={n_wrs}")
    if mems.device.type != "cuda":
        raise ValueError(f"images on {mems.device}: the chain kernels run "
                         "on CUDA tensors (CPU tensors take the plain path)")
    if mems.dtype != torch.int32 or mems.ndim != 2 or \
            not mems.is_contiguous():
        raise ValueError("images must be a contiguous (n, M) int32 tensor")
    if mems.shape[1] < isa.MAX_COPY:
        raise ValueError(f"images of {mems.shape[1]} words are shorter "
                         f"than one {isa.MAX_COPY}-word copy block")


def run_managed(mems, msgs, inits, *, wq_base: int, n_wrs: int,
                managed: bool = True, max_steps: int = 64):
    """Managed-WQ batch executor (ENABLE gate + completions + RECV).

    ``mems``: (n, M) int32 images; ``msgs``: (n, CAP*MSG_WORDS) staged
    inbound messages; ``inits``: (n, 8) int32 per the ``ref.INIT_*``
    layout.  Returns ``(mems, stats)``, ``stats`` (n, 8) per ``STAT_*``.
    """
    if mems.device.type == "cpu":
        return managed_chain_loop(mems, msgs, inits, wq_base=wq_base,
                                  n_wrs=n_wrs, managed=managed,
                                  max_steps=max_steps)
    _check_images(mems, n_wrs)
    n, m = mems.shape
    if msgs.shape[0] != n or msgs.shape[1] < isa.MSG_WORDS or \
            msgs.shape[1] % isa.MSG_WORDS or inits.shape != (n, 8):
        raise ValueError(
            f"msgs must be (n, CAP*{isa.MSG_WORDS}) and inits (n, 8) for "
            f"n={n}; got {tuple(msgs.shape)} and {tuple(inits.shape)}")
    for t in (msgs, inits):
        if t.device != mems.device or t.dtype != torch.int32 or \
                not t.is_contiguous():
            raise ValueError("msgs and inits must be contiguous int32 "
                             "tensors on the images' device")
    out = torch.empty_like(mems)
    stats = torch.empty((n, 8), dtype=torch.int32, device=mems.device)
    if n == 0:
        return out, stats
    lib = _build.load("chain_vm", _declare)
    _build.check(lib, lib.chain_vm_run_managed(
        _build.pointer(mems), _build.pointer(msgs), _build.pointer(inits),
        _build.pointer(out), _build.pointer(stats), n, m, msgs.shape[1],
        wq_base, n_wrs, int(bool(managed)), max_steps, _build.stream()),
        "chain_vm_run_managed")
    launches["run_managed"] += 1
    return out, stats


def run_chains(mems, *, wq_base: int, n_wrs: int, max_steps: int = 64):
    """Execute one single-WQ straight-line chain per row of ``mems`` (n, M)
    for ``max_steps`` steps (a row freezes once it HALTs)."""
    if mems.device.type == "cpu":
        return run_chain_reference(mems, wq_base, n_wrs, max_steps)[0]
    _check_images(mems, n_wrs)
    n, m = mems.shape
    out = torch.empty_like(mems)
    if n == 0:
        return out
    lib = _build.load("chain_vm", _declare)
    _build.check(lib, lib.chain_vm_run_chains(
        _build.pointer(mems), _build.pointer(out), n, m, wq_base, n_wrs,
        max_steps, _build.stream()), "chain_vm_run_chains")
    launches["run_chains"] += 1
    return out


# where a chain step's dependent loads may be served: the C code's ``where``
CHASE_LEVELS = {"shared": 0, "l2": 1}


def chase_cycles(level: str, device="cuda", steps: int = 4096) -> float:
    """SM cycles of one dependent load from ``level`` ("shared", or "l2":
    ``ld.global.cg``, past L1), measured on the card: one thread follows
    ``steps`` indices around a ring of ints 33 words apart (a new 128-byte
    line each load), timed by ``clock64`` after as many to warm up."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"device {dev}: the latency probe runs on the card")
    words = 4096 if level == "shared" else 1 << 18
    ring = torch.empty(words if level == "l2" else 0, dtype=torch.int32,
                       device=dev)
    out = torch.zeros(2, dtype=torch.int64, device=dev)
    lib = _build.load("chain_vm", _declare)
    _build.check(lib, lib.chain_vm_chase(
        _build.pointer(ring), _build.pointer(out), words, 33, steps,
        CHASE_LEVELS[level], _build.stream()), "chain_vm_chase")
    return int(out[0]) / steps
