"""RG-LRU wrappers: the plain scan and its plain backward for tensors on
the CPU, CUDA kernels for tensors on the card: the forward
(``csrc/rglru.cu``) and the backward (``csrc/rglru_bwd.cu``), each the
ring kernel or the direct one as ``variant`` says, joined by
:class:`RGLRUFn`, which :func:`rglru` goes through when autograd needs
the gradient.  There is no fallback: a launch the card refuses raises.
``launches`` counts kernel launches, in all and by kernel (the
backward's as ``rglru_bwd``, ``rglru_bwd.ring`` and
``rglru_bwd.direct``).  The decode step stays plain, as in the JAX
package."""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import (rglru_backward_reference,  # noqa: F401
                  rglru_decode_step, rglru_reference)

launches = {"rglru": 0, "rglru.ring": 0, "rglru.direct": 0, "rglru_bwd": 0,
            "rglru_bwd.ring": 0, "rglru_bwd.direct": 0}

# The kernel for each type, forward and backward alike: "ring" (the steps
# fed from a shared-memory ring that TMA copies fill; the backward's runs
# from the last step to the first) when a row of D elements is a whole
# number of 16-byte units, as a TMA tensor map's rows must be; "direct"
# (each thread loads its own steps from device memory) for every other D.
ROW_UNIT = {torch.float32: 4, torch.bfloat16: 8}   # elements in 16 bytes


def variant(dtype: torch.dtype, d: int) -> str:
    """"ring" or "direct": the kernel that runs the scan of a and u of
    ``dtype`` over ``d`` channels on the card, and its backward."""
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


def _declare_bwd(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.rglru_backward, lib.rglru_ring_backward):
        fn.argtypes = [p] * 6 + [i] * 4 + [p]
        fn.restype = i
    lib.cuda_error_string.argtypes = [i]
    lib.cuda_error_string.restype = ctypes.c_char_p


def _check(a, u) -> None:
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


def _forward(a, u):
    """The forward: the plain scan on the CPU, a kernel on the card."""
    if a.device.type == "cpu":
        return rglru_reference(a, u)
    _check(a, u)
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


def rglru_backward(a, h, dh, dh_last=None):
    """(da, du) of :func:`rglru` from a, its output h (in a's dtype), the
    output gradient ``dh`` (B, T, D) and optionally the final state's
    ``dh_last`` (B, D), as :func:`.ref.rglru_backward_reference` computes
    them: the plain version on the CPU, the backward kernel ``variant``
    picks on the card (both in a's dtype)."""
    if a.device.type == "cpu":
        return rglru_backward_reference(a, h, dh, dh_last)
    _check(a, h)
    b, t, d = a.shape
    if dh.shape != a.shape or (dh_last is not None and
                               dh_last.shape != (b, d)):
        raise ValueError(f"dh {tuple(dh.shape)} and dh_last "
                         f"{None if dh_last is None else tuple(dh_last.shape)}"
                         f" do not match a {tuple(a.shape)}")
    a, h = _build.kernel_input(a), _build.kernel_input(h)
    dh = _build.kernel_input(dh.to(a.dtype))
    if dh_last is not None:
        dh_last = _build.kernel_input(dh_last.float())
    da, du = torch.empty_like(a), torch.empty_like(a)
    if b * t * d == 0:
        return da, du
    kind = variant(a.dtype, d)
    lib = _build.load("rglru_bwd", _declare_bwd)
    fn = lib.rglru_ring_backward if kind == "ring" else lib.rglru_backward
    _build.check(lib, fn(
        _build.pointer(a), _build.pointer(h), _build.pointer(dh),
        None if dh_last is None else _build.pointer(dh_last),
        _build.pointer(da), _build.pointer(du), _build.DTYPES[a.dtype], b, t,
        d, _build.stream()), "rglru_bwd")
    launches["rglru_bwd"] += 1
    launches[f"rglru_bwd.{kind}"] += 1
    return da, du


class RGLRUFn(torch.autograd.Function):
    """RG-LRU with its backward: the forward saves a and its output h, and
    the backward walks time in reverse from them; both halves are kernels
    on the card and the plain versions on the CPU.  A gradient that
    reaches neither output gives none."""

    @staticmethod
    def forward(ctx, a, u):
        ctx.set_materialize_grads(False)
        h, h_last = _forward(a, u)
        ctx.save_for_backward(a, h)
        return h, h_last

    @staticmethod
    def backward(ctx, dh, dh_last):
        if dh is None and dh_last is None:
            return None, None
        a, h = ctx.saved_tensors
        if dh is None:
            dh = torch.zeros_like(h)
        return rglru_backward(a, h, dh, dh_last)


def rglru(a, u):
    """h_t = a_t h_{t-1} + u_t from h_0 = 0 over a, u (B, T, D).  Returns
    (h (B, T, D) in a's dtype, final state (B, D) float32).  When grad is
    enabled and a or u requires it, the call goes through
    :class:`RGLRUFn`; otherwise the forward runs alone and nothing is
    saved."""
    if torch.is_grad_enabled() and (a.requires_grad or u.requires_grad):
        return RGLRUFn.apply(a, u)
    return _forward(a, u)
