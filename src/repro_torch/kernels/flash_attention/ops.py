"""Flash-attention forward wrapper: the plain PyTorch version for tensors
on the CPU, a CUDA kernel (``csrc/flash_attention.cu``) for tensors on the
card — the tensor-core kernel (``flash_wgmma_kernel``: bfloat16 at head
dims 64, 96, 128 and 256) or the CUDA-core one (``flash_fwd_kernel``:
float32, and bfloat16 at head dim 32), as ``variant`` says.  There is no
fallback: a launch or tensor map the card refuses raises.  ``launches``
counts kernel launches, in all and by kernel."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build
from .ref import attention_reference

launches = {"flash_attention": 0, "flash_attention.wgmma": 0,
            "flash_attention.fma": 0}

MODES = {"causal": 0, "length": 1, "full": 2}

# The kernel for each (type, head dim) the wrapper takes: "wgmma" (the
# tensor cores, bf16 operands, float32 accumulation) for bfloat16 at head
# dims 64, 96, 128 and 256 (Q and K in 64-column TMA boxes, and at D 96 a
# last box of 32 columns, 96 = 64 + 32; V in 32-column boxes there); "fma"
# (CUDA-core float32) for float32, which TF32 would round past its 2e-5
# tolerance, and for bfloat16 at head dim 32, which no arch uses at full
# size.
VARIANTS = {
    (torch.bfloat16, 32): "fma", (torch.bfloat16, 64): "wgmma",
    (torch.bfloat16, 96): "wgmma", (torch.bfloat16, 128): "wgmma",
    (torch.bfloat16, 256): "wgmma",
    (torch.float32, 32): "fma", (torch.float32, 64): "fma",
    (torch.float32, 96): "fma", (torch.float32, 128): "fma",
    (torch.float32, 256): "fma",
}


def variant(dtype: torch.dtype, d: int) -> str:
    """"wgmma" or "fma": the kernel that computes q of ``dtype`` at head dim
    ``d`` on the card."""
    try:
        return VARIANTS[(dtype, d)]
    except KeyError:
        raise ValueError(f"no flash-attention kernel for {dtype} at head "
                         f"dim {d}") from None


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i,
                                        i, i, i, ctypes.c_float, p]
    lib.flash_attention_fwd.restype = i
    lib.flash_attention_wgmma_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                              i, i, i, i, ctypes.c_float, p]
    lib.flash_attention_wgmma_fwd.restype = i
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
    kind = variant(q.dtype, d)
    lib = _build.load("flash_attention", _declare)
    ptrs = [_build.pointer(t) for t in (q, k, v, lengths, out)]
    dims = (b, h, kh, sq, sk, d, MODES[mode], window, q_offset,
            d ** -0.5 if scale is None else scale, _build.stream())
    if kind == "wgmma":
        code = lib.flash_attention_wgmma_fwd(*ptrs, *dims)
    else:
        code = lib.flash_attention_fwd(*ptrs, _build.DTYPES[q.dtype], *dims)
    _build.check(lib, code, "flash_attention")
    launches["flash_attention"] += 1
    launches[f"flash_attention.{kind}"] += 1
    return out
