"""Flash-attention forward wrapper: the plain PyTorch version for tensors
on the CPU, the CUDA kernel (``csrc/flash_attention.cu``) for tensors on
the card.  ``launches`` counts kernel launches."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build
from .ref import attention_reference

launches = {"flash_attention": 0}

MODES = {"causal": 0, "length": 1, "full": 2}


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i,
                                        i, i, i, ctypes.c_float, p]
    lib.flash_attention_fwd.restype = i
    lib.cuda_error_string.argtypes = [i]
    lib.cuda_error_string.restype = ctypes.c_char_p


def flash_attention(q, k, v, *, mode: str = "causal", window: int = 0,
                    lengths: Optional[torch.Tensor] = None,
                    q_offset: int = 0, scale: Optional[float] = None):
    """Attention forward; q (B, H, Sq, D), k/v (B, KH, Sk, D); the modes and
    masks of :func:`.ref.attention_reference`.  Returns q's shape and type."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, mode=mode, window=window,
                                   lengths=lengths, q_offset=q_offset,
                                   scale=scale)
    _build.check_attention_inputs(q, k, v, "flash-attention")
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {tuple(MODES)}")
    b, h, sq, d = q.shape
    kh, sk = k.shape[1], k.shape[2]
    if lengths is None:
        if mode == "length":
            raise ValueError("mode='length' needs lengths")
        lengths = torch.full((b,), sk, dtype=torch.int32, device=q.device)
    if lengths.shape != (b,):
        raise ValueError(f"lengths {tuple(lengths.shape)}, expected ({b},)")
    lengths = lengths.to(device=q.device, dtype=torch.int32)
    q, k, v, lengths = (_build.kernel_input(t) for t in (q, k, v, lengths))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _build.load("flash_attention", _declare)
    _build.check(lib, lib.flash_attention_fwd(
        _build.pointer(q), _build.pointer(k), _build.pointer(v),
        _build.pointer(lengths), _build.pointer(out), _build.DTYPES[q.dtype],
        b, h, kh, sq, sk, d, MODES[mode], window, q_offset,
        d ** -0.5 if scale is None else scale, _build.stream()),
        "flash_attention")
    launches["flash_attention"] += 1
    return out
