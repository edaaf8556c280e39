"""Decode-attention wrappers: ``decode_partial`` takes the plain PyTorch
version for tensors on the CPU and, for tensors on the card, launches the
CUDA kernels of ``csrc/decode_attention.cu``: a split pass over blocks of
cache rows, then a combine pass.  ``launches`` counts kernel launches, in
all (one per call) and by kernel.  ``decode_attention`` normalises the
partial, and ``combine_partials`` merges shards' partials (plain torch,
not a kernel)."""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _build
from .ref import combine_partials_reference, decode_partial_reference

launches = {"decode_partial": 0, "decode_partial.split": 0,
            "decode_partial.combine": 0}

# The split rule.  Rows per split are a multiple of SPLIT_QUANTUM (32,
# which every shared-memory tile of the kernel divides) and at most
# SPLIT_ROWS_MAX; within that, as few as give SPLIT_BLOCKS blocks (four per
# SM of an H100's 132) over the whole cache.  A 32,768-long cache at B 16,
# KH 8 gets 512 rows (8,192 blocks, several waves of those with visible
# rows); recurrentgemma-9b's decode (B 4, KH 1, S 4,096) gets 32 (128
# splits, of which its window of 2,048 reaches 65: the kernel launches
# only those, 260 blocks).
SPLIT_QUANTUM = 32
SPLIT_ROWS_MAX = 512
SPLIT_BLOCKS = 4 * 132


# The combine kernel's column blocks, as ``csrc/decode_attention.cu``'s
# ``combine_cols`` computes them: a combine block sums COMBINE_COLS columns
# of acc, or 32 where that does not divide the head dim (a multiple of 32),
# so the D // cols blocks cover every column.
COMBINE_COLS = 64


def combine_cols(d: int) -> int:
    """Columns of acc one combine block sums at head dim ``d``."""
    return COMBINE_COLS if d % COMBINE_COLS == 0 else 32


def plan_splits(b: int, kh: int, s: int) -> Tuple[int, int]:
    """(rows per split, number of splits) for a (B, KH, S) cache, from the
    shapes alone: the rule never reads ``lengths``, which would sync the
    serving loop.  The splits tile [0, S); an empty cache has one."""
    want = -(-s * b * kh // SPLIT_BLOCKS)
    rows = -(-want // SPLIT_QUANTUM) * SPLIT_QUANTUM
    rows = min(SPLIT_ROWS_MAX, max(SPLIT_QUANTUM, rows))
    return rows, max(1, -(-s // rows))


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.decode_split.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, i, i,
                                 ctypes.c_float, p]
    lib.decode_split.restype = i
    lib.decode_combine.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, p]
    lib.decode_combine.restype = i
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
    rows, n_split = plan_splits(b, kh, s)
    # each split's (acc, m, l); only the splits with visible rows are
    # written, and only those are read
    part = torch.empty((b, h, n_split, d + 2), dtype=torch.float32,
                       device=q.device)
    lib = _build.load("decode_attention", _declare)
    stream = _build.stream()
    _build.check(lib, lib.decode_split(
        _build.pointer(q), _build.pointer(k), _build.pointer(v),
        _build.pointer(lengths), _build.pointer(part),
        _build.DTYPES[q.dtype], b, h, kh, s, d, rows, n_split, window,
        kpos_offset, d ** -0.5 if scale is None else scale, stream),
        "decode_partial")
    launches["decode_partial.split"] += 1
    _build.check(lib, lib.decode_combine(
        _build.pointer(part), _build.pointer(lengths), _build.pointer(acc),
        _build.pointer(m), _build.pointer(l), b, h, s, d, rows, n_split,
        window, kpos_offset, stream), "decode_partial")
    launches["decode_partial.combine"] += 1
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
