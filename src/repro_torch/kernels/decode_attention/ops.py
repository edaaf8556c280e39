"""Decode-attention wrappers: ``decode_partial`` takes the plain PyTorch
version for tensors on the CPU and launches the CUDA kernel
(``csrc/decode_attention.cu``) for tensors on the card; ``launches``
counts kernel launches.  ``decode_attention`` normalises the partial, and
``combine_partials`` merges shards' partials (plain torch, not a kernel)."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build
from .ref import combine_partials_reference, decode_partial_reference

launches = {"decode_partial": 0}


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.decode_partial.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                                   i, ctypes.c_float, p]
    lib.decode_partial.restype = i
    lib.cuda_error_string.argtypes = [i]
    lib.cuda_error_string.restype = ctypes.c_char_p


def decode_partial(q, k, v, lengths, *, window: int = 0,
                   kpos_offset: int = 0, scale: Optional[float] = None):
    """q (B, H, 1, D); k, v (B, KH, S, D), one shard whose row j is global
    position j + kpos_offset; lengths (B,) global.  Returns the float32
    partial acc (B, H, 1, D), m (B, H, 1, 1), l (B, H, 1, 1)."""
    if q.device.type == "cpu":
        return decode_partial_reference(q, k, v, lengths, window=window,
                                        kpos_offset=kpos_offset, scale=scale)
    _build.check_attention_inputs(q, k, v, "decode-attention")
    b, h, sq, d = q.shape
    kh, s = k.shape[1], k.shape[2]
    if sq != 1 or lengths.shape != (b,):
        raise ValueError(f"expected q (B, H, 1, D) and lengths (B,); got "
                         f"{tuple(q.shape)}, {tuple(lengths.shape)}")
    lengths = lengths.to(device=q.device, dtype=torch.int32)
    q, k, v, lengths = (_build.kernel_input(t) for t in (q, k, v, lengths))
    acc = torch.empty((b, h, 1, d), dtype=torch.float32, device=q.device)
    m = torch.empty((b, h, 1, 1), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    if acc.numel() == 0:
        return acc, m, l
    lib = _build.load("decode_attention", _declare)
    _build.check(lib, lib.decode_partial(
        _build.pointer(q), _build.pointer(k), _build.pointer(v),
        _build.pointer(lengths), _build.pointer(acc), _build.pointer(m),
        _build.pointer(l), _build.DTYPES[q.dtype], b, h, kh, s, d, window,
        kpos_offset, d ** -0.5 if scale is None else scale, _build.stream()),
        "decode_partial")
    launches["decode_partial"] += 1
    return acc, m, l


def combine_partials(parts):
    """Merge shards' (acc, m, l) partials; returns the normalised float32
    output (B, H, 1, D)."""
    return combine_partials_reference(parts)


def decode_attention(q, k, v, lengths, *, window: int = 0,
                     scale: Optional[float] = None):
    """Single-shard decode: the partial, normalised, in q's type."""
    acc, m, l = decode_partial(q, k, v, lengths, window=window, scale=scale)
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)
