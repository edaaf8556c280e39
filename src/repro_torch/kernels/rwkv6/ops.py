"""WKV6 wrapper: the plain scan for tensors on the CPU, the CUDA kernel
(``csrc/wkv6.cu``) for tensors on the card.  ``launches`` counts kernel
launches.  The decode step stays plain, as in the JAX package."""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import wkv6_decode_step, wkv6_reference  # noqa: F401

launches = {"wkv6": 0}

HEAD_DIMS = (32, 64)


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wkv6_forward.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.wkv6_forward.restype = i
    lib.cuda_error_string.argtypes = [i]
    lib.cuda_error_string.restype = ctypes.c_char_p


def _check(r, k, v, w, u) -> None:
    if r.device.type != "cuda":
        raise ValueError(f"r on {r.device}: the WKV6 kernel runs on CUDA "
                         "tensors (CPU tensors take the plain path)")
    b, h, t, n = r.shape if r.ndim == 4 else (0, 0, 0, 0)
    if r.ndim != 4 or k.shape != r.shape or w.shape != r.shape or \
            v.shape != r.shape or u.shape != (h, n):
        raise ValueError(f"expected r, k, v, w (B, H, T, N) and u (H, N) "
                         f"with M = N; got {tuple(r.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(w.shape)}, {tuple(u.shape)}")
    if n not in HEAD_DIMS:
        raise ValueError(f"head dim {n} not in {HEAD_DIMS}")
    if r.dtype not in _build.DTYPES or k.dtype != r.dtype or \
            v.dtype != r.dtype:
        raise ValueError(f"WKV6 takes float32 or bfloat16 r, k, v of one "
                         f"type; got {r.dtype}, {k.dtype}, {v.dtype}")
    if w.dtype != torch.float32 or u.dtype != torch.float32:
        raise ValueError(f"WKV6 takes float32 w and u; got {w.dtype}, "
                         f"{u.dtype}")
    if any(x.device != r.device for x in (k, v, w, u)):
        raise ValueError("r, k, v, w and u must lie on one device")


def wkv6(r, k, v, w, u):
    """The WKV6 recurrence from a zero state: r, k, v, w (B, H, T, N), u
    (H, N).  Returns (o (B, H, T, N) in r's dtype, final state (B, H, N, N)
    float32)."""
    if r.device.type == "cpu":
        return wkv6_reference(r, k, v, w, u)
    _check(r, k, v, w, u)
    _build.refuse_grad("the WKV6 kernel (csrc/wkv6.cu)", r, k, v, w, u)
    b, h, t, n = r.shape
    r, k, v, w, u = (x.contiguous() for x in (r, k, v, w, u))
    o = torch.empty_like(r)
    s = torch.empty((b, h, n, n), dtype=torch.float32, device=r.device)
    if b * h == 0:
        return o, s
    lib = _build.load("wkv6", _declare)
    _build.check(lib, lib.wkv6_forward(
        _build.pointer(r), _build.pointer(k), _build.pointer(v),
        _build.pointer(w), _build.pointer(u), _build.pointer(o),
        _build.pointer(s), _build.DTYPES[r.dtype], b, h, t, n,
        _build.stream()), "wkv6")
    launches["wkv6"] += 1
    return o, s
