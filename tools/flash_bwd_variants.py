"""Tile variants of the flash backward's tensor-core pair, on the card.

``csrc/flash_attention_bwd.cu`` fixes two tile constants of its tensor-core
pair (``BwdTile``): the rows of a streamed tile at head dim 64 (``kStep``;
64 at head dim 128) and the depth of the streamed ring (``kStages``).  This
script builds a copy of the source for each (rows at D 64, stages) pair in
``VARIANTS``, one ``nvcc`` each, all started together, into
``build/variants/``; prints each build's ptxas registers and spills; holds
each variant against the plain backward on small cases (bf16, D 64 and
128, every mask mode, ragged edges) and two calls against each other (bit
for bit); then times each at qwen3-1.7b's and smollm-135m's bf16 training
shapes by CUDA events, in turns (every variant, then in reverse, twice),
and by a profiler trace per kernel.  Run from the root of a checkout on a
machine with an H100:

    python3 tools/flash_bwd_variants.py
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
VARIANTS = ((64, 2), (64, 3), (128, 2), (128, 3), (128, 4))
CONSTANTS = (r"static constexpr int kStep = D == 64 \? (\d+) : 64;",
             r"static constexpr int kStages = (\d+);")
# (case, b, h, kh, sq, sk, d, kwargs): the lengths of "length" modes are
# (sk // 3, sk)
CASES = (
    ("causal_d128", 2, 8, 2, 320, 320, 128, dict(mode="causal")),
    ("causal_d64", 2, 9, 3, 256, 256, 64, dict(mode="causal")),
    ("window", 2, 4, 2, 512, 512, 64, dict(mode="causal", window=128)),
    ("length", 2, 4, 2, 256, 700, 64, dict(mode="length")),
    ("length_window", 2, 4, 1, 64, 700, 128, dict(mode="length",
                                                  window=200)),
    ("full_sk384", 2, 4, 2, 200, 384, 64, dict(mode="full")),
    ("offset", 2, 4, 2, 77, 333, 128, dict(mode="causal", q_offset=256)),
    ("no_key_rows", 1, 4, 2, 300, 160, 64, dict(mode="causal", window=32)))
SHAPES = (("qwen3-1.7b", 4, 16, 8, 2048, 128),
          ("smollm-135m", 8, 9, 3, 2048, 64))
TOL = 2e-2      # bf16, of each gradient's largest magnitude


def variant_source(text: str, step64: int, stages: int) -> str:
    """The source with ``BwdTile``'s constants set to (step64, stages);
    raises unless each constant appears exactly once."""
    for pattern, value in zip(CONSTANTS, (step64, stages)):
        found = re.findall(pattern, text)
        if len(found) != 1:
            raise ValueError(f"{pattern!r} matches {len(found)} times")
        text = re.sub(pattern, lambda m: m.group(0).replace(
            m.group(1), str(value)), text)
    return text


def build(_build, variants):
    """One library per variant (built together); returns {variant:
    library} after printing each one's ptxas lines for the pair."""
    src_dir = _build.CSRC
    out_dir = ROOT / "build" / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = (src_dir / "flash_attention_bwd.cu").read_text()
    procs = {}
    for step64, stages in variants:
        src = out_dir / f"bwd_{step64}_{stages}.cu"
        src.write_text(variant_source(text, step64, stages))
        lib = out_dir / f"libbwd_{step64}_{stages}.so"
        procs[(step64, stages)] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{src_dir}", "-o",
             str(lib), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for key, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        name = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                k = re.search(r"(flash_bwd_\w+_wgmma_kernel)ILi(\d+)",
                              m.group(1))
                name = f"{k.group(1)}<{k.group(2)}>" if k else None
            elif name and ("registers" in line or "spill" in line):
                print(f"{key} {name}: {line.strip()}", flush=True)
        libs[key] = ctypes.CDLL(str(lib))
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_variants: no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    libs = build(_build, VARIANTS)
    for lib in libs.values():
        fa_ops._declare_bwd(lib)

    def run(lib, q, k, v, out, lse, do, mode="causal", window=0,
            lengths=None, q_offset=0):
        b, h, sq, d = q.shape
        kh, sk = k.shape[1], k.shape[2]
        if lengths is None:
            lengths = torch.full((b,), sk, dtype=torch.int32, device=dev)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        rows = -(-sq // fa_ops.BWD_ROWS) * fa_ops.BWD_ROWS
        vec = torch.empty((2, b, h, rows), dtype=torch.float32, device=dev)
        _build.check(lib, lib.flash_attention_wgmma_bwd(
            *(_build.pointer(t) for t in (q, k, v, out, do, lse, lengths,
                                           vec, dq, dk, dv)),
            b, h, kh, sq, sk, d, fa_ops.MODES[mode], window, q_offset,
            d ** -0.5, _build.stream()), "variant")
        return dq, dk, dv

    def inputs(b, h, kh, sq, sk, d):
        gen = torch.Generator(device=dev).manual_seed(7)

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(
                torch.bfloat16)
        return (rnd(b, h, sq, d), rnd(b, kh, sk, d), rnd(b, kh, sk, d),
                rnd(b, h, sq, d))

    sound = {}
    for key, lib in libs.items():
        worst, equal = 0.0, True
        for case, b, h, kh, sq, sk, d, kw in CASES:
            q, k, v, do = inputs(b, h, kh, sq, sk, d)
            kw = dict(kw)
            if kw["mode"] == "length":
                kw["lengths"] = torch.tensor([sk // 3, sk], dtype=torch.int32,
                                             device=dev)
            out, lse = fa_ops.flash_attention_lse(q, k, v, **kw)
            got = run(lib, q, k, v, out, lse, do, **kw)
            again = run(lib, q, k, v, out, lse, do, **kw)
            want = fa_ref.attention_backward_reference(q, k, v, out, lse, do,
                                                       **kw)
            for g, w, a in zip(got, want, again):
                err = float((g.float() - w.float()).abs().max()
                            / w.float().abs().max())
                worst = max(worst, err if torch.isfinite(g).all()
                            else float("inf"))
                equal &= torch.equal(g, a)
        sound[key] = worst <= TOL and equal
        print(f"{key}: worst error {worst} of the largest magnitude, "
              f"bit-equal {equal}: {'sound' if sound[key] else 'WRONG'}",
              flush=True)

    from torch.profiler import ProfilerActivity, profile
    for name, b, h, kh, s, d in SHAPES:
        q, k, v, do = inputs(b, h, kh, s, s, d)
        out, lse = fa_ops.flash_attention_lse(q, k, v)
        times = {key: [] for key in libs if sound[key]}
        order = list(times) + list(times)[::-1]
        for key in order * 2:
            fn = lambda: run(libs[key], q, k, v, out, lse, do)  # noqa: E731
            fn()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                fn()
            end.record()
            end.synchronize()
            times[key].append(start.elapsed_time(end) / 10)
        for key, ts in times.items():
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    run(libs[key], q, k, v, out, lse, do)
                torch.cuda.synchronize()
            kernels = {re.search(r"(flash_bwd_\w+_wgmma_kernel)", e.key)
                       .group(1): getattr(e, "self_device_time_total", 0)
                       / e.count / 1e3
                       for e in prof.key_averages() if "wgmma" in e.key}
            print(f"{name} {key}: ms by events {[round(t, 4) for t in ts]}"
                  f", min {min(ts):.4f}; by trace {kernels}", flush=True)
    return 0 if all(sound.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
