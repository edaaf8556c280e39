"""Build and load the port's hand-written CUDA kernels.

Each source under ``src/repro_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded with
``ctypes``.  A library is named by a digest of its source and of the
headers of ``csrc/`` it includes, and built at first use into
``build/kernels/`` of the checkout, so a changed source or header is
rebuilt and an unchanged one is reused.  Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("chain_vm", "chain_interp", "hopscotch", "flash_attention",
           "flash_attention_bwd", "decode_attention", "wkv6", "wkv6_bwd",
           "rglru", "rglru_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# what the float kernels take: element types (their codes in the C
# interface); and the attention kernels' head dims
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 96, 128, 256)

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")


def library_path(name: str) -> Path:
    """The library of ``csrc/{name}.cu``, named by a digest of the source
    and of each header of ``csrc/`` it includes (``#include "x.cuh"``)."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src)
    for header in sorted(set(re.findall(rb'#include "([^"]+)"', src))):
        digest.update((CSRC / header.decode()).read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_log(name: str) -> Path:
    """Where :func:`build` keeps the compiler output of ``name``'s
    library."""
    out = library_path(name)
    return out.with_name(f"{out.name}.log")


def build(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile the named sources that are not built yet, one ``nvcc`` per
    source, all started together.  Returns each named source's compiler
    output (its ``-Xptxas -v`` register and spill report), kept beside
    its library (``build_log``) so that a source built earlier gives it
    too; raises on a failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, logs = {}, {}
    for name in names:
        out = library_path(name)
        if out.exists():
            log = build_log(name)
            logs[name] = log.read_text() if log.exists() else ""
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            log = build_log(name)
            log_tmp = log.with_name(f"{log.name}.{os.getpid()}.tmp")
            log_tmp.write_text(logs[name])
            os.replace(log_tmp, log)
            os.replace(tmp, out)
        else:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str, declare: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if needed); ``declare``
    sets its functions' ``argtypes``/``restype`` once."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        declare(lib)
        _LIBS[name] = lib
    return lib


def sass(name: str) -> str:
    """The built library ``name``'s machine code as ``cuobjdump -sass``
    (from beside ``nvcc``) prints it."""
    tool = Path(_nvcc()).with_name("cuobjdump")
    return subprocess.run([str(tool), "-sass", str(library_path(name))],
                          check=True, capture_output=True, text=True).stdout


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = lib.cuda_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code}: {msg}")


def pointer(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def kernel_input(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (the kernels' vector loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def plain(t: torch.Tensor) -> bool:
    """Whether a wrapper takes its plain version for ``t``: on CPU tensors,
    and on meta tensors, whose ops carry shapes and no data (the dry run
    of ``launch/dryrun.py``; the recurrences' wrappers give meta tensors
    their outputs' shapes alone).  A CUDA tensor takes the kernel."""
    return t.device.type in ("cpu", "meta")


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise when autograd would need a gradient through ``kernel``, a
    forward kernel with no backward kernel (decode attention, which only
    serving runs): its output, written through a raw pointer, would carry
    none, and the gradient would silently be zero.  CPU tensors never get
    here (their plain path differentiates)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel} has no backward kernel, so no gradient can flow "
            f"through it on the card; call it under torch.no_grad(), or on "
            f"CPU tensors for a differentiable plain version")


def check_attention_inputs(q, k, v, what: str) -> None:
    """Raise unless q (B, H, Sq, D), k/v (B, KH, Sk, D) are CUDA tensors of
    one supported type with a supported head dim and H % KH == 0."""
    if q.device.type != "cuda":
        raise ValueError(f"q on {q.device}: the {what} kernel runs on CUDA "
                         "tensors (CPU tensors take the plain path)")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape or \
            k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"expected q (B, H, Sq, D), k and v (B, KH, Sk, D);"
                         f" got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{what} takes float32 or bfloat16 q, k, v of one "
                         f"type; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[3]} not in {HEAD_DIMS}")
    if k.shape[1] == 0 or q.shape[1] % k.shape[1]:
        raise ValueError(f"{q.shape[1]} query heads do not group over "
                         f"{k.shape[1]} KV heads")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on one device")
