"""WKV6 wrappers: the plain scan and its plain backward for tensors on the
CPU, the CUDA kernels for tensors on the card: the forward
(``csrc/wkv6.cu``) and the backward (``csrc/wkv6_bwd.cu``), joined by
:class:`WKV6Fn`, which :func:`wkv6` goes through when autograd needs the
gradient.  There is no fallback: a launch the card refuses raises.
``launches`` counts kernel launches (the backward's as ``wkv6_bwd``).
The decode step stays plain, as in the JAX package."""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import (wkv6_backward_reference, wkv6_decode_step,  # noqa: F401
                  wkv6_reference)

launches = {"wkv6": 0, "wkv6_bwd": 0}

HEAD_DIMS = (32, 64)


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wkv6_forward.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.wkv6_forward.restype = i
    lib.cuda_error_string.argtypes = [i]
    lib.cuda_error_string.restype = ctypes.c_char_p


def _declare_bwd(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wkv6_backward.argtypes = [p] * 13 + [i] * 5 + [p]
    lib.wkv6_backward.restype = i
    lib.wkv6_backward_chunk.argtypes = []
    lib.wkv6_backward_chunk.restype = i
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


def _forward(r, k, v, w, u):
    """The forward: the plain scan on the CPU, the kernel on the card."""
    if r.device.type == "meta":
        # the dry run: the launch's outputs by shape (the plain scan would
        # step T times over no data)
        return (torch.empty_like(r, memory_format=torch.contiguous_format),
                torch.empty_like(w[:, :, :1, :1]).expand(
                    r.shape[:2] + (r.shape[3],) * 2))
    if _build.plain(r):
        return wkv6_reference(r, k, v, w, u)
    _check(r, k, v, w, u)
    b, h, t, n = r.shape
    r, k, v, w, u = (_build.kernel_input(x) for x in (r, k, v, w, u))
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


def wkv6_backward(r, k, v, w, u, do, ds=None):
    """(dr, dk, dv, dw, du) of :func:`wkv6` from its inputs, the output
    gradient ``do`` (B, H, T, N) and optionally the final state's ``ds``
    (B, H, N, N), as :func:`.ref.wkv6_backward_reference` computes them:
    the plain version on the CPU, the backward kernel
    (``wkv6_bwd_chunk_kernel``) on the card (dr, dk, dv in r's dtype, dw
    and du float32; du summed over B from the kernel's per-(b, h)
    partials)."""
    if r.device.type == "meta":          # the dry run: shapes alone
        return (*(torch.empty_like(x, memory_format=torch.contiguous_format)
                  for x in (r, k, v, w)), torch.empty_like(u))
    if _build.plain(r):
        return wkv6_backward_reference(r, k, v, w, u, do, ds)
    _check(r, k, v, w, u)
    b, h, t, n = r.shape
    if do.shape != r.shape or (ds is not None and ds.shape != (b, h, n, n)):
        raise ValueError(f"do {tuple(do.shape)} and ds "
                         f"{None if ds is None else tuple(ds.shape)} do not "
                         f"match r {tuple(r.shape)}")
    r, k, v, w, u = (_build.kernel_input(x) for x in (r, k, v, w, u))
    do = _build.kernel_input(do.to(r.dtype))
    ds = None if ds is None else _build.kernel_input(ds.float())
    dr, dk, dv = (torch.empty_like(r) for _ in range(3))
    dw = torch.empty_like(w)
    du = torch.empty((b, h, n), dtype=torch.float32, device=r.device)
    if b * h * t == 0:
        return (*(torch.zeros_like(x) for x in (dr, dk, dv, dw)),
                torch.zeros_like(u))
    lib = _build.load("wkv6_bwd", _declare_bwd)
    # the state before every chunk but the first, which pass A keeps for
    # pass B
    kept = -(-t // lib.wkv6_backward_chunk()) - 1
    states = torch.empty((max(b * h * kept, 1), n, n), dtype=torch.float32,
                         device=r.device)
    _build.check(lib, lib.wkv6_backward(
        *(_build.pointer(x) for x in (r, k, v, w, u, do)),
        None if ds is None else _build.pointer(ds),
        *(_build.pointer(x) for x in (dr, dk, dv, dw, du, states)),
        _build.DTYPES[r.dtype], b, h, t, n, _build.stream()), "wkv6_bwd")
    launches["wkv6_bwd"] += 1
    return dr, dk, dv, dw, du.sum(0)


class WKV6Fn(torch.autograd.Function):
    """WKV6 with its backward: the forward saves its inputs (pass A of the
    backward recomputes the states); both halves are kernels on the card
    and the plain versions on the CPU.  A gradient that reaches neither
    output gives none."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, w, u)
        return _forward(r, k, v, w, u)

    @staticmethod
    def backward(ctx, do, ds):
        if do is None and ds is None:
            return None, None, None, None, None
        r, k, v, w, u = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(r)
        return wkv6_backward(r, k, v, w, u, do, ds)


def wkv6(r, k, v, w, u):
    """The WKV6 recurrence from a zero state: r, k, v, w (B, H, T, N), u
    (H, N).  Returns (o (B, H, T, N) in r's dtype, final state (B, H, N, N)
    float32).  When grad is enabled and an input requires it, the call
    goes through :class:`WKV6Fn`; otherwise the forward runs alone and
    nothing is saved."""
    if torch.is_grad_enabled() and any(x.requires_grad
                                       for x in (r, k, v, w, u)):
        return WKV6Fn.apply(r, k, v, w, u)
    return _forward(r, k, v, w, u)
