"""Hopscotch lookup wrapper: the plain PyTorch version for tensors on the
CPU, the CUDA kernel (``csrc/hopscotch.cu``) for tensors on the card.
``launches`` counts kernel launches."""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import lookup_reference

launches = {"hopscotch_lookup": 0}


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.hopscotch_lookup.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.hopscotch_lookup.restype = i
    lib.cuda_error_string.argtypes = [i]
    lib.cuda_error_string.restype = ctypes.c_char_p


def hopscotch_lookup(keys, values, queries, neighborhood: int = 8):
    """Batched get: returns (found (B,) bool, values (B, V) int32); a hit
    returns the first matching bucket's row, misses and key 0 are zeros."""
    if keys.device.type == "cpu":
        return lookup_reference(keys, values, queries, neighborhood)
    if keys.device.type != "cuda":
        raise ValueError(f"keys on {keys.device}: the hopscotch kernel runs "
                         "on CUDA tensors (CPU tensors take the plain path)")
    n, b = keys.shape[0], queries.shape[0]
    if keys.ndim != 1 or values.ndim != 2 or values.shape[0] != n or \
            queries.ndim != 1 or n == 0:
        raise ValueError(
            f"expected keys (N,), values (N, V), queries (B,) with N > 0; got "
            f"{tuple(keys.shape)}, {tuple(values.shape)}, "
            f"{tuple(queries.shape)}")
    for t in (keys, values, queries):
        if t.device != keys.device or t.dtype != torch.int32 or \
                not t.is_contiguous():
            raise ValueError("keys, values and queries must be contiguous "
                             "int32 tensors on one device")
    v = values.shape[1]
    found = torch.empty(b, dtype=torch.bool, device=keys.device)
    out = torch.empty((b, v), dtype=torch.int32, device=keys.device)
    if b == 0:
        return found, out
    lib = _build.load("hopscotch", _declare)
    _build.check(lib, lib.hopscotch_lookup(
        _build.pointer(keys), _build.pointer(values), _build.pointer(queries),
        _build.pointer(found), _build.pointer(out), n, v, b, neighborhood,
        _build.stream()), "hopscotch_lookup")
    launches["hopscotch_lookup"] += 1
    return found, out
