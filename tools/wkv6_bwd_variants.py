"""Unroll variants of the WKV6 backward kernel's walks, on the card.

``csrc/wkv6_bwd.cu`` walks time in two loops, one a pass (``for (int tt =
0; ...`` and ``for (int tt = len - 1; ...``), each under ``#pragma unroll
4``.  This script builds a copy of the source for each unroll count of
``VARIANTS`` (4: the source as committed), one ``nvcc`` each, all started
together, into ``build/variants/``; prints each build's ptxas registers
and spills; holds each against the plain backward on small cases (both
types, T 1, ragged chunks, decays down to 0.01, a final-state gradient)
and two calls against each other (bit for bit); then times each at the
rwkv6-7b prefill shape (4, 64, 2,048, 64) in bf16 by CUDA events, in
turns (every variant, then in reverse, twice).  Run from the root of a
checkout on a machine with an H100:

    python3 tools/wkv6_bwd_variants.py
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
VARIANTS = (1, 2, 4, 8)
# the unroll pragma of each walk
WALKS = re.compile(r"#pragma unroll (\d+)\n(    for \(int tt = "
                   r"(?:0; tt < len; \+\+tt|len - 1; tt >= 0; --tt)\) \{\n)")
# (b, h, t, n, lowest decay, highest decay, with a final-state gradient)
CASES = ((1, 2, 1, 64, 0.01, 0.999, True), (2, 3, 33, 32, 0.01, 0.999, True),
         (2, 2, 65, 64, 0.01, 0.115, True), (1, 4, 300, 64, 0.3, 0.99, False))
SHAPE = (4, 64, 2048, 64)
REC_TOL = {torch.float32: 5e-5, torch.bfloat16: 5e-2}
STATE_TOL = 5e-5


def variant_source(text: str, unroll: int) -> str:
    """The source with both walks' unroll pragmas set to ``unroll``;
    raises unless there are exactly two."""
    found = WALKS.findall(text)
    if len(found) != 2:
        raise ValueError(f"the walks' unroll pragma matches {len(found)} "
                         f"times")
    return WALKS.sub(lambda m: f"#pragma unroll {unroll}\n{m.group(2)}",
                     text)


def build(names_sources: dict) -> dict:
    """Compile each (name -> source text) with the kernels' flags, all at
    once; returns each library's path and ptxas report."""
    from repro_torch.kernels import _build
    out_dir = ROOT / "build" / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in names_sources.items():
        src = out_dir / f"wkv6_bwd_{name}.cu"
        src.write_text(text)
        lib = out_dir / f"libwkv6_bwd_{name}.so"
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    built = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        built[name] = (lib, " | ".join(
            line.strip() for line in log.splitlines()
            if "registers" in line or "spill" in line))
    return built


def run(lib, r, k, v, w, u, do, ds=None):
    """The wrapper's launch (``ops.wkv6_backward``) on library ``lib``."""
    from repro_torch.kernels import _build
    b, h, t, n = r.shape
    dr, dk, dv = (torch.empty_like(r) for _ in range(3))
    dw = torch.empty_like(w)
    du = torch.empty((b, h, n), dtype=torch.float32, device=r.device)
    a = torch.empty((b, h, t, n), dtype=torch.float64, device=r.device)
    _build.check(lib, lib.wkv6_backward(
        *(_build.pointer(x) for x in (r, k, v, w, u, do)),
        None if ds is None else _build.pointer(ds),
        *(_build.pointer(x) for x in (dr, dk, dv, dw, du, a)),
        _build.DTYPES[r.dtype], b, h, t, n, _build.stream()), "wkv6_bwd")
    return dr, dk, dv, dw, du.sum(0)


def inputs(seed, dtype, b, h, t, n, lo, hi, with_ds):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    r, k, v, do = (rnd(b, h, t, n).to(dtype) for _ in range(4))
    w = lo + (hi - lo) * torch.rand((b, h, t, n), generator=gen,
                                    device="cuda")
    u = 0.3 * rnd(h, n)
    return (r, k, v, w, u, do), (rnd(b, h, n, n) if with_ds else None)


def check(lib, name):
    from repro_torch.kernels.rwkv6 import ref
    for i, (b, h, t, n, lo, hi, with_ds) in enumerate(CASES):
        for dtype in (torch.bfloat16, torch.float32):
            args, ds = inputs(i, dtype, b, h, t, n, lo, hi, with_ds)
            got = run(lib, *args, ds)
            again = run(lib, *args, ds)
            want = ref.wkv6_backward_reference(*args, ds)
            for g, g2, wnt, what in zip(got, again, want, ("dr", "dk", "dv",
                                                           "dw", "du")):
                if not torch.equal(g, g2):
                    raise AssertionError(f"{name}: {what} run to run")
                g, wnt = g.double(), wnt.double()
                if what in ("dw", "du"):
                    bad = float((g - wnt).abs().max()) > STATE_TOL * max(
                        float(wnt.abs().max()), 1e-30)
                else:
                    bad = bool(((g - wnt).abs() > REC_TOL[dtype] * (
                        1 + wnt.abs())).any())
                if bad:
                    raise AssertionError(f"{name}: {what} off, case {i} "
                                         f"{dtype}")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("wkv6_bwd_variants: runs on the card only")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.rwkv6 import ops
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    text = (ROOT / "src/repro_torch/csrc/wkv6_bwd.cu").read_text()
    names = {f"unroll{u}": u for u in VARIANTS}
    built = build({name: variant_source(text, u)
                   for name, u in names.items()})
    libs = {}
    for name, (path, ptxas) in built.items():
        print(f"[{name}] ptxas {ptxas}", flush=True)
        libs[name] = ctypes.CDLL(str(path))
        ops._declare_bwd(libs[name])
        check(libs[name], name)
        print(f"[{name}] matches the plain backward, bit-equal run to run",
              flush=True)
    args, _ = inputs(0, torch.bfloat16, *SHAPE, 0.3, 0.99, False)
    times = {name: [] for name in libs}
    order = list(libs) + list(libs)[::-1]
    for _ in range(2):
        for name in order:
            lib = libs[name]
            run(lib, *args)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(5):
                run(lib, *args)
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / 5)
    for name, ts in times.items():
        print(f"[times] wkv6_bwd {name} ({card}) at {SHAPE} bf16: min "
              f"{min(ts):.4f} ms, mean {sum(ts) / len(ts):.4f} ms over "
              f"{len(ts)} turns of 5 calls", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
