"""Flash-attention wrappers: the plain PyTorch versions for tensors on the
CPU, CUDA kernels for tensors on the card.  The forward
(``csrc/flash_attention.cu``) is the tensor-core kernel
(``flash_wgmma_kernel``: bfloat16 at head dims 64, 96, 128 and 256) or the
CUDA-core one (``flash_fwd_kernel``: float32, and bfloat16 at head dim
32), as ``variant`` says; the backward (``csrc/flash_attention_bwd.cu``) is
a pair of kernels, a dQ kernel then a dK/dV kernel, on the tensor cores
(``flash_bwd_dq_wgmma_kernel``, ``flash_bwd_dkdv_wgmma_kernel``: bfloat16
at head dims 64, 128 and 256; at 256 the dK/dV kernel may split a KV
head's query heads over blocks, ``bwd_split``, and ``flash_bwd_sum_kernel``
then adds their partial sums) or the CUDA cores (``flash_bwd_dq_kernel``,
``flash_bwd_dkdv_kernel``: the rest), as ``bwd_variant`` says, behind
:class:`FlashAttentionFn`, which :func:`flash_attention` goes through when
autograd needs the gradient.  There is no fallback: a launch or tensor
map the card refuses raises.  ``launches`` counts kernel launches, in all
and by kernel (the backward's calls as ``flash_attention.bwd``, by pair as
``.bwd_wgmma`` and ``.bwd_fma``, its kernels as ``.bwd_dq``,
``.bwd_dkdv`` and ``.bwd_sum``)."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ...distributed.sharding import shard
from .. import _build
from .ref import (attention_backward_reference, attention_reference,
                  attention_reference_lse)

launches = {"flash_attention": 0, "flash_attention.wgmma": 0,
            "flash_attention.fma": 0, "flash_attention.bwd": 0,
            "flash_attention.bwd_wgmma": 0, "flash_attention.bwd_fma": 0,
            "flash_attention.bwd_dq": 0, "flash_attention.bwd_dkdv": 0,
            "flash_attention.bwd_sum": 0}

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


# The backward pair for each (type, head dim) the forward takes: "wgmma"
# (the tensor cores) for bfloat16 at head dims 64, 128 and 256 (at 256 the
# dK/dV kernel's two warpgroups share a block's keys, one holding dV and
# the other dK); "fma" (CUDA-core float32) for float32, which TF32 would
# round past its tolerance, and for bfloat16 at 32 and 96.
BWD_VARIANTS = {key: "wgmma" if key in ((torch.bfloat16, 64),
                                        (torch.bfloat16, 128),
                                        (torch.bfloat16, 256)) else "fma"
                for key in VARIANTS}
# the tensor-core pair's float32 scratch holds lse2 and delta for Sq
# rounded up to 128 rows (a multiple of every block's and tile's rows)
BWD_ROWS = 128
# the keys of a D 256 dK/dV block, as the library's
# flash_attention_wgmma_bwd_keys(256) gives them (checked on the card)
BWD_KEYS_256 = 64


def variant(dtype: torch.dtype, d: int) -> str:
    """"wgmma" or "fma": the kernel that computes q of ``dtype`` at head dim
    ``d`` on the card."""
    try:
        return VARIANTS[(dtype, d)]
    except KeyError:
        raise ValueError(f"no flash-attention kernel for {dtype} at head "
                         f"dim {d}") from None


def bwd_variant(dtype: torch.dtype, d: int) -> str:
    """"wgmma" or "fma": the backward pair for q of ``dtype`` at head dim
    ``d`` on the card."""
    variant(dtype, d)
    return BWD_VARIANTS[(dtype, d)]


def bwd_split(b: int, h: int, kh: int, sk: int, d: int, sms: int) -> int:
    """The slices of each KV head's group of query heads that the
    tensor-core dK/dV kernel spreads over blocks: at head dim 256 the
    fewest, a divisor of the group H / KH, that give at least one block an
    SM (``sms``), else the whole group; 1 where the blocks of B x KH x
    key tiles already fill the card, and at the other head dims.  Each
    slice's block writes float32 partials that a last kernel adds in slice
    order."""
    if d != 256:
        return 1
    blocks = b * kh * -(-sk // BWD_KEYS_256)
    group = h // kh
    return next((s for s in range(1, group + 1)
                 if group % s == 0 and blocks * s >= sms), group)


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i,
                                        i, i, i, i, ctypes.c_float, p]
    lib.flash_attention_fwd.restype = i
    lib.flash_attention_wgmma_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i,
                                              i, i, i, i, i, ctypes.c_float,
                                              p]
    lib.flash_attention_wgmma_fwd.restype = i
    lib.cuda_error_string.argtypes = [i]
    lib.cuda_error_string.restype = ctypes.c_char_p


def _declare_bwd(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_bwd.argtypes = [p] * 11 + [i] * 10 + [
        ctypes.c_float, p]
    lib.flash_attention_bwd.restype = i
    lib.flash_attention_wgmma_bwd.argtypes = [p] * 12 + [i] * 10 + [
        ctypes.c_float, p]
    lib.flash_attention_wgmma_bwd.restype = i
    lib.flash_attention_wgmma_bwd_smem.argtypes = [i, i]
    lib.flash_attention_wgmma_bwd_smem.restype = i
    lib.flash_attention_wgmma_bwd_keys.argtypes = [i]
    lib.flash_attention_wgmma_bwd_keys.restype = i
    lib.cuda_error_string.argtypes = [i]
    lib.cuda_error_string.restype = ctypes.c_char_p


def _prepare(q, k, v, mode: str, lengths):
    """Check the card's inputs; returns them contiguous and aligned, with
    ``lengths`` as a (B,) int32 tensor (Sk for every row if None)."""
    _build.check_attention_inputs(q, k, v, "flash-attention")
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {tuple(MODES)}")
    b, sk = q.shape[0], k.shape[2]
    if lengths is None:
        if mode == "length":
            raise ValueError("mode='length' needs lengths")
        lengths = torch.full((b,), sk, dtype=torch.int32, device=q.device)
    if lengths.shape != (b,):
        raise ValueError(f"lengths {tuple(lengths.shape)}, expected ({b},)")
    lengths = lengths.to(device=q.device, dtype=torch.int32)
    return tuple(_build.kernel_input(t) for t in (q, k, v, lengths))


def _scale(scale: Optional[float], d: int) -> float:
    return d ** -0.5 if scale is None else scale


def _forward(q, k, v, lengths, mode: str, window: int, q_offset: int,
             scale: Optional[float], with_lse: bool):
    """The forward kernel on prepared inputs: (out, lse (B, H, Sq) float32
    or None)."""
    b, h, sq, d = q.shape
    kh, sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return out, lse
    kind = variant(q.dtype, d)
    lib = _build.load("flash_attention", _declare)
    ptrs = [_build.pointer(t) for t in (q, k, v, lengths, out)]
    ptrs.append(_build.pointer(lse) if with_lse else None)
    dims = (b, h, kh, sq, sk, d, MODES[mode], window, q_offset,
            _scale(scale, d), _build.stream())
    if kind == "wgmma":
        code = lib.flash_attention_wgmma_fwd(*ptrs, *dims)
    else:
        code = lib.flash_attention_fwd(*ptrs, _build.DTYPES[q.dtype], *dims)
    _build.check(lib, code, "flash_attention")
    launches["flash_attention"] += 1
    launches[f"flash_attention.{kind}"] += 1
    return out, lse


def flash_attention_lse(q, k, v, *, mode: str = "causal", window: int = 0,
                        lengths: Optional[torch.Tensor] = None,
                        q_offset: int = 0, scale: Optional[float] = None):
    """The forward and its log-sum-exp: (out, lse (B, H, Sq) float32), as
    :func:`.ref.attention_reference_lse` gives them."""
    if _build.plain(q):
        return attention_reference_lse(q, k, v, mode=mode, window=window,
                                       lengths=lengths, q_offset=q_offset,
                                       scale=scale)
    q, k, v, lengths = _prepare(q, k, v, mode, lengths)
    return _forward(q, k, v, lengths, mode, window, q_offset, scale, True)


def wgmma_backward(lib, q, k, v, out, do, lse, lengths, dq, dk, dv,
                   mode: int, window: int, q_offset: int, scale: float,
                   split: Optional[int] = None) -> int:
    """The tensor-core pair of ``lib`` (the built ``flash_attention_bwd``
    library, or a variant of it) on prepared bf16 inputs, writing dq, dk
    and dv: allocates the lse2 / delta scratch and, where the split gives
    more than one slice, the float32 partials; raises on a refused launch.
    ``split`` is ``bwd_split``'s unless given (the variant tool times
    others against it).  Returns the split."""
    b, h, sq, d = q.shape
    kh, sk = k.shape[1], k.shape[2]
    if split is None:
        split = bwd_split(b, h, kh, sk, d, _sms(q.device))
    # lse2 and delta, each (B, H, Sq rounded up to BWD_ROWS)
    rows = -(-sq // BWD_ROWS) * BWD_ROWS
    vec = torch.empty((2, b, h, rows), dtype=torch.float32, device=q.device)
    part = (torch.empty((2, split, b, kh, sk, d), dtype=torch.float32,
                        device=q.device) if split > 1 else None)
    code = lib.flash_attention_wgmma_bwd(
        *(_build.pointer(t) for t in (q, k, v, out, do, lse, lengths, vec)),
        None if part is None else _build.pointer(part),
        *(_build.pointer(t) for t in (dq, dk, dv)), b, h, kh, sq, sk, d,
        mode, window, q_offset, split, scale, _build.stream())
    _build.check(lib, code, "flash_attention_bwd")
    return split


def flash_attention_backward(q, k, v, out, lse, do, *, mode: str = "causal",
                             window: int = 0,
                             lengths: Optional[torch.Tensor] = None,
                             q_offset: int = 0,
                             scale: Optional[float] = None):
    """(dq, dk, dv) of the forward from its ``out`` and ``lse`` and the
    output gradient ``do``, as :func:`.ref.attention_backward_reference`
    computes them: the plain version on the CPU, the backward kernels on
    the card."""
    if _build.plain(q):
        return attention_backward_reference(
            q, k, v, out, lse, do, mode=mode, window=window, lengths=lengths,
            q_offset=q_offset, scale=scale)
    q, k, v, lengths = _prepare(q, k, v, mode, lengths)
    if out.shape != q.shape or do.shape != q.shape or \
            lse.shape != q.shape[:3]:
        raise ValueError(f"out {tuple(out.shape)}, do {tuple(do.shape)} and "
                         f"lse {tuple(lse.shape)} do not match q "
                         f"{tuple(q.shape)}")
    out, do = (_build.kernel_input(t.to(q.dtype)) for t in (out, do))
    lse = _build.kernel_input(lse.float())
    if q.numel() == 0 or k.numel() == 0:
        return tuple(torch.zeros_like(t) for t in (q, k, v))
    # both pairs write every element of dq, dk and dv
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    b, h, sq, d = q.shape
    kh, sk = k.shape[1], k.shape[2]
    kind = bwd_variant(q.dtype, d)
    lib = _build.load("flash_attention_bwd", _declare_bwd)
    if kind == "wgmma":
        split = wgmma_backward(lib, q, k, v, out, do, lse, lengths, dq, dk,
                               dv, MODES[mode], window, q_offset,
                               _scale(scale, d))
        launches["flash_attention.bwd_sum"] += int(split > 1)
    else:
        delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        code = lib.flash_attention_bwd(
            *(_build.pointer(t) for t in (q, k, v, out, do, lse, lengths,
                                           delta, dq, dk, dv)),
            _build.DTYPES[q.dtype], b, h, kh, sq, sk, d, MODES[mode], window,
            q_offset, _scale(scale, d), _build.stream())
        _build.check(lib, code, "flash_attention_bwd")
    launches["flash_attention.bwd"] += 1
    launches[f"flash_attention.bwd_{kind}"] += 1
    launches["flash_attention.bwd_dq"] += 1
    launches["flash_attention.bwd_dkdv"] += 1
    return dq, dk, dv


def _pin(x):
    """The batch axis pinned (under an active mesh, on a DTensor)."""
    return shard(x, "batch", *([None] * (x.ndim - 1)))


def _pin_h(x):
    """(batch, heads) pinned on rank-4 (B, H, S, D) tensors: the heads
    shard only where the 'heads' rule maps to a mesh axis."""
    if x.ndim == 4:
        return shard(x, "batch", "heads", None, None)
    return _pin(x)


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with the flash backward: the forward saves (q, k, v,
    lengths, out, lse) and the backward recomputes p from lse, as the JAX
    package's ``_make_blocked_vjp`` does.  Both halves are kernels on the
    card and the plain versions on the CPU.  Under activation
    checkpointing the forward runs again in the backward pass, and its
    ``lse`` is saved with the rest (never kept on a module)."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, mode, window, q_offset, scale):
        q, k, v = _pin_h(q), _pin_h(k), _pin_h(v)
        if _build.plain(q):
            out, lse = attention_reference_lse(
                q, k, v, mode=mode, window=window, lengths=lengths,
                q_offset=q_offset, scale=scale)
        else:
            q, k, v, lengths = _prepare(q, k, v, mode, lengths)
            out, lse = _forward(q, k, v, lengths, mode, window, q_offset,
                                scale, True)
        out = _pin_h(out)
        ctx.save_for_backward(q, k, v, lengths, out, lse)
        ctx.args = dict(mode=mode, window=window, q_offset=q_offset,
                        scale=scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, lengths, out, lse = ctx.saved_tensors
        do, lse = _pin_h(do), _pin(lse)
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse, do,
                                              lengths=lengths, **ctx.args)
        return (_pin_h(dq), _pin(dk), _pin(dv), None, None, None, None,
                None)


def flash_attention(q, k, v, *, mode: str = "causal", window: int = 0,
                    lengths: Optional[torch.Tensor] = None,
                    q_offset: int = 0, scale: Optional[float] = None):
    """Attention forward; q (B, H, Sq, D), k/v (B, KH, Sk, D); the modes and
    masks of :func:`.ref.attention_reference`.  Returns q's shape and type.
    When grad is enabled and an input requires it, the call goes through
    :class:`FlashAttentionFn` (its gradient from the backward kernels);
    otherwise the forward runs alone, with no ``lse``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, lengths, mode, window,
                                      q_offset, scale)
    if _build.plain(q):
        return attention_reference(q, k, v, mode=mode, window=window,
                                   lengths=lengths, q_offset=q_offset,
                                   scale=scale)
    q, k, v, lengths = _prepare(q, k, v, mode, lengths)
    return _forward(q, k, v, lengths, mode, window, q_offset, scale,
                    False)[0]
