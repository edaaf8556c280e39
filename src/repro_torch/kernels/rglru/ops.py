"""RG-LRU wrapper: the plain scan for tensors on the CPU, a CUDA kernel
(``csrc/rglru.cu``) for tensors on the card — the ring kernel or the
direct one, as ``variant`` says.  ``launches`` counts kernel launches, in
all and by kernel.  The decode step stays plain, as in the JAX package."""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import rglru_decode_step, rglru_reference  # noqa: F401

launches = {"rglru": 0, "rglru.ring": 0, "rglru.direct": 0}

# The kernel for each type: "ring" (the steps fed from a shared-memory ring
# that TMA copies fill) when a row of D elements is a whole number of
# 16-byte units, as a TMA tensor map's rows must be; "direct" (each thread
# loads its own steps from device memory) for every other D.
ROW_UNIT = {torch.float32: 4, torch.bfloat16: 8}   # elements in 16 bytes


def variant(dtype: torch.dtype, d: int) -> str:
    """"ring" or "direct": the kernel that runs the scan of a and u of
    ``dtype`` over ``d`` channels on the card."""
    if dtype not in ROW_UNIT:
        raise ValueError(f"no RG-LRU kernel for {dtype}")
    return "ring" if d % ROW_UNIT[dtype] == 0 else "direct"


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.rglru_forward, lib.rglru_ring_forward):
        fn.argtypes = [p, p, p, p, i, i, i, i, p]
        fn.restype = i
    lib.cuda_error_string.argtypes = [i]
    lib.cuda_error_string.restype = ctypes.c_char_p


def rglru(a, u):
    """h_t = a_t h_{t-1} + u_t from h_0 = 0 over a, u (B, T, D).  Returns
    (h (B, T, D) in a's dtype, final state (B, D) float32)."""
    if a.device.type == "cpu":
        return rglru_reference(a, u)
    if a.device.type != "cuda":
        raise ValueError(f"a on {a.device}: the RG-LRU kernel runs on CUDA "
                         "tensors (CPU tensors take the plain path)")
    _build.refuse_grad("the RG-LRU kernel (csrc/rglru.cu)", a, u)
    if a.ndim != 3 or u.shape != a.shape:
        raise ValueError(f"expected a and u (B, T, D); got {tuple(a.shape)},"
                         f" {tuple(u.shape)}")
    if a.dtype not in _build.DTYPES or u.dtype != a.dtype:
        raise ValueError(f"RG-LRU takes float32 or bfloat16 a and u of one "
                         f"type; got {a.dtype}, {u.dtype}")
    if u.device != a.device:
        raise ValueError("a and u must lie on one device")
    b, t, d = a.shape
    a, u = _build.kernel_input(a), _build.kernel_input(u)
    h = torch.empty_like(a)
    h_last = torch.empty((b, d), dtype=torch.float32, device=a.device)
    if b * d == 0:
        return h, h_last
    kind = variant(a.dtype, d)
    lib = _build.load("rglru", _declare)
    fn = lib.rglru_ring_forward if kind == "ring" else lib.rglru_forward
    _build.check(lib, fn(
        _build.pointer(a), _build.pointer(u), _build.pointer(h),
        _build.pointer(h_last), _build.DTYPES[a.dtype], b, t, d,
        _build.stream()), "rglru")
    launches["rglru"] += 1
    launches[f"rglru.{kind}"] += 1
    return h, h_last
