"""The WKV6 backward kernel beside the walk it replaced, on the card.

This script builds ``csrc/wkv6_bwd.cu`` (``wkv6_bwd_chunk_kernel``, chunks
of 16 steps) as committed, and the two-pass walk with float64 states that
it replaced (``csrc/wkv6_bwd.cu`` at commit ``WALK_COMMIT``), one ``nvcc``
each, both started together, into ``build/variants/``; prints each
build's ptxas registers and spills; holds each against the plain backward
on small cases (both types, T 1, ragged chunks, decays down to 0.01, half
the channels at decays in [1e-12, 1e-10] or [1e-30, 1e-20], a final-state
gradient) and two calls against each other (bit for bit).  The walk's dw
is wrong at the tiny decays (its identity cancels), so there its errors
are printed and not held.  It also builds copies of the kernel with one
part cut out (``CUTS``: pass B's walk, its products, G's update, dv, or
the chunk states' round trip through device memory), whose outputs are
wrong and not checked: what each saves says where the kernel's time
goes.  Then it times them all at the rwkv6-7b prefill shape (4, 64,
2,048, 64) in bf16 by CUDA events, in turns (each, then in reverse,
twice).

The machine with the card has no git: on a checkout with its history,
first write the walk's source to ``build/variants/`` (nothing runs on a
card), then run the script from the root of the checkout on a machine
with an H100:

    python3 tools/wkv6_bwd_variants.py --fetch-walk
    python3 tools/wkv6_bwd_variants.py
"""
from __future__ import annotations

import ctypes
import math
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "variants"
# the last commit whose csrc/wkv6_bwd.cu is the walk
WALK_COMMIT = "6836214"
WALK = OUT / "wkv6_bwd_walk.cu"
# (b, h, t, n, lowest decay, highest decay, with a final-state gradient);
# a highest decay below 1e-3 sets half the channels log-uniform in the
# range and the rest in [0.9, 0.999]
CASES = ((1, 2, 1, 64, 0.01, 0.999, True), (2, 3, 33, 32, 0.01, 0.999, True),
         (2, 2, 65, 64, 0.01, 0.115, True), (1, 4, 300, 64, 0.3, 0.99, False),
         (1, 2, 40, 32, 1e-12, 1e-10, True),
         (2, 2, 77, 64, 1e-30, 1e-20, True))
SHAPE = (4, 64, 2048, 64)
REC_TOL = {torch.float32: 5e-5, torch.bfloat16: 5e-2}
STATE_TOL = 5e-5
NAMES = ("dr", "dk", "dv", "dw", "du")


# parts of wkv6_bwd_chunk_kernel to cut, each as the spans of its source
# removed: from a span's first text (exactly once in the source) up to the
# next occurrence of its second, which stays
CUTS = {
    # pass B's walk: dr, dk, dw and M, a (channel, step) a lane
    "walk": (("#pragma unroll 1\n      for (int it = 0; it < C / 4;",
              "      // G <- Hd_{t0+C} G"),),
    # pass B's products P, Q, Zv and A on the tensor cores
    "products": (("    for (int tile = warp; tile < 3 * kTilesPQ",
                  "    if (tid >= NT - N) {"),),
    # G <- Hd G + sum_x (Hd_x r_x) do_x^T
    "g_update": (("      // G <- Hd_{t0+C} G",
                  "    }\n    __syncthreads();\n\n    // IV:"),),
    # dv
    "dv": (("    for (int tile = warp; tile < (C / 16) * (N / 8);",
            "  }\n  // du: each channel's"),),
    # pass A's stores of the chunk states and pass B's copies of them
    "states": (("      // the state before chunk c + 1\n",
                "    }\n  }\n  // pass A's states"),
               ("    const float* src = s_mine",
                "    cp_async_commit();\n  };")),
}


def cut_source(text: str, name: str) -> str:
    """The source with part ``name`` of ``CUTS`` removed; raises unless
    each span's first text is there exactly once and its second follows."""
    for first, second in CUTS[name]:
        if text.count(first) != 1:
            raise ValueError(f"cut {name}: {first!r} matches "
                             f"{text.count(first)} times")
        start = text.index(first)
        end = text.find(second, start + len(first))
        if end < 0:
            raise ValueError(f"cut {name}: no {second!r} after {first!r}")
        text = text[:start] + text[end:]
    return text


def variant_sources(text: str, walk: str) -> dict:
    """What is built, by name: the chunk kernel's source as committed, the
    walk's, and a copy for each cut."""
    return {"chunk": text, "walk": walk,
            **{f"cut_{name}": cut_source(text, name) for name in CUTS}}


def fetch_walk() -> Path:
    """Write the walk's source (``git show``) to ``WALK``."""
    text = subprocess.run(
        ["git", "-C", str(ROOT), "show",
         f"{WALK_COMMIT}:src/repro_torch/csrc/wkv6_bwd.cu"],
        check=True, capture_output=True, text=True).stdout
    OUT.mkdir(parents=True, exist_ok=True)
    WALK.write_text(text)
    return WALK


def build(names_sources: dict) -> dict:
    """Compile each (name -> source text) with the kernels' flags, all at
    once; returns each library's path and ptxas report."""
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in names_sources.items():
        src = OUT / f"wkv6_bwd_{name}.cu"
        src.write_text(text)
        lib = OUT / f"libwkv6_bwd_{name}.so"
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


def declare(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wkv6_backward.argtypes = [p] * 13 + [i] * 5 + [p]
    lib.wkv6_backward.restype = i
    lib.cuda_error_string.argtypes = [i]
    lib.cuda_error_string.restype = ctypes.c_char_p
    if hasattr(lib, "wkv6_backward_chunk"):
        lib.wkv6_backward_chunk.argtypes = []
        lib.wkv6_backward_chunk.restype = i


def run(lib, r, k, v, w, u, do, ds=None):
    """The wrapper's launch (``ops.wkv6_backward``) on library ``lib``:
    the chunk kernel's float32 states, or the walk's float64 a_t."""
    from repro_torch.kernels import _build
    b, h, t, n = r.shape
    dr, dk, dv = (torch.empty_like(r) for _ in range(3))
    dw = torch.empty_like(w)
    du = torch.empty((b, h, n), dtype=torch.float32, device=r.device)
    if hasattr(lib, "wkv6_backward_chunk"):
        kept = -(-t // lib.wkv6_backward_chunk()) - 1
        scratch = torch.empty((max(b * h * kept, 1), n, n),
                              dtype=torch.float32, device=r.device)
    else:
        scratch = torch.empty((b, h, t, n), dtype=torch.float64,
                              device=r.device)
    _build.check(lib, lib.wkv6_backward(
        *(_build.pointer(x) for x in (r, k, v, w, u, do)),
        None if ds is None else _build.pointer(ds),
        *(_build.pointer(x) for x in (dr, dk, dv, dw, du, scratch)),
        _build.DTYPES[r.dtype], b, h, t, n, _build.stream()), "wkv6_bwd")
    return dr, dk, dv, dw, du.sum(0)


def inputs(seed, dtype, b, h, t, n, lo, hi, with_ds):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    r, k, v, do = (rnd(b, h, t, n).to(dtype) for _ in range(4))
    x = torch.rand((b, h, t, n), generator=gen, device="cuda")
    if hi < 1e-3:
        w = 0.9 + 0.099 * x
        w[..., n // 2:] = torch.exp(math.log(lo) + (math.log(hi) - math.log(
            lo)) * x[..., n // 2:])
    else:
        w = lo + (hi - lo) * x
    u = 0.3 * rnd(h, n)
    return (r, k, v, w, u, do), (rnd(b, h, n, n) if with_ds else None)


def errors(got, want, dtype) -> dict:
    """Each gradient's error: dw and du of their largest magnitude, dr, dk,
    dv the largest |got - want| / (1 + |want|)."""
    out = {}
    for g, wnt, what in zip(got, want, NAMES):
        g, wnt = g.double(), wnt.double()
        if what in ("dw", "du"):
            out[what] = float((g - wnt).abs().max()) / max(
                float(wnt.abs().max()), 1e-30)
        else:
            out[what] = float(((g - wnt).abs() / (1 + wnt.abs())).max())
    return out


def check(lib, name, held=True):
    """Every case against the plain backward, two calls bit-equal; raises
    on an error past the tolerances unless ``held`` is False for the tiny
    decays (then prints them)."""
    from repro_torch.kernels.rwkv6 import ref
    for i, (b, h, t, n, lo, hi, with_ds) in enumerate(CASES):
        for dtype in (torch.bfloat16, torch.float32):
            args, ds = inputs(i, dtype, b, h, t, n, lo, hi, with_ds)
            got = run(lib, *args, ds)
            again = run(lib, *args, ds)
            want = ref.wkv6_backward_reference(*args, ds)
            for g, g2, what in zip(got, again, NAMES):
                if not torch.equal(g, g2):
                    raise AssertionError(f"{name}: {what} run to run")
            errs = errors(got, want, dtype)
            bad = {k: e for k, e in errs.items()
                   if e > (STATE_TOL if k in ("dw", "du") else
                           REC_TOL[dtype]) or not math.isfinite(e)}
            if bad and (held or hi >= 1e-3):
                raise AssertionError(f"{name}: {bad} off, case {i} {dtype}")
            if hi < 1e-3:
                print(f"[{name}] decays [{lo}, {hi}] on half the channels, "
                      f"{dtype}: errors {errs}", flush=True)


def main() -> int:
    if "--fetch-walk" in sys.argv[1:]:
        print(f"wrote {fetch_walk()}")
        return 0
    if not torch.cuda.is_available():
        raise SystemExit("wkv6_bwd_variants: runs on the card only")
    if not WALK.is_file():
        raise SystemExit(f"wkv6_bwd_variants: no {WALK}: run with "
                         f"--fetch-walk on a checkout with git history")
    sys.path.insert(0, str(ROOT / "src"))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    text = (ROOT / "src/repro_torch/csrc/wkv6_bwd.cu").read_text()
    built = build(variant_sources(text, WALK.read_text()))
    libs = {}
    for name, (path, ptxas) in built.items():
        print(f"[{name}] ptxas {ptxas}", flush=True)
        libs[name] = ctypes.CDLL(str(path))
        declare(libs[name])
        if name.startswith("cut_"):
            continue
        check(libs[name], name, held=name != "walk")
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
