"""RG-LRU wrapper: the plain scan for tensors on the CPU, the CUDA kernel
(``csrc/rglru.cu``) for tensors on the card.  ``launches`` counts kernel
launches.  The decode step stays plain, as in the JAX package."""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import rglru_decode_step, rglru_reference  # noqa: F401

launches = {"rglru": 0}


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rglru_forward.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.rglru_forward.restype = i
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
    if a.ndim != 3 or u.shape != a.shape:
        raise ValueError(f"expected a and u (B, T, D); got {tuple(a.shape)},"
                         f" {tuple(u.shape)}")
    if a.dtype not in _build.DTYPES or u.dtype != a.dtype:
        raise ValueError(f"RG-LRU takes float32 or bfloat16 a and u of one "
                         f"type; got {a.dtype}, {u.dtype}")
    if u.device != a.device:
        raise ValueError("a and u must lie on one device")
    b, t, d = a.shape
    a, u = a.contiguous(), u.contiguous()
    h = torch.empty_like(a)
    h_last = torch.empty((b, d), dtype=torch.float32, device=a.device)
    if b * d == 0:
        return h, h_last
    lib = _build.load("rglru", _declare)
    _build.check(lib, lib.rglru_forward(
        _build.pointer(a), _build.pointer(u), _build.pointer(h),
        _build.pointer(h_last), _build.DTYPES[a.dtype], b, t, d,
        _build.stream()), "rglru")
    launches["rglru"] += 1
    return h, h_last
