"""Tile variants of the flash backward's tensor-core pair, on the card.

``csrc/flash_attention_bwd.cu`` fixes two tile constants of its
tensor-core pair (``BwdTile``): the rows of a streamed tile at head dim 64
(``kStep``; 64 at head dims 128 and 256) and the depth of the streamed ring
at D 64 and 128 (``kStages``).  This script builds a copy of the source for
each (rows at D 64, stages) in ``VARIANTS``, one ``nvcc`` each, all started
together, into ``build/variants/``; prints each build's ptxas registers and
spills; holds each variant against the plain backward on small cases
(bf16, D 64, 128 and 256, every mask mode, ragged edges, an MQA group of
16; at D 256 at every split of the group's heads, a divisor of it) and two
calls against each other (bit for bit); then times each at qwen3-1.7b's
and smollm-135m's bf16 training shapes and at recurrentgemma-9b's and
gemma3-1b's (D 256, their windows; there at every split, against the one
``ops.bwd_split`` picks) by CUDA events, in turns (every variant and split,
then in reverse, twice), and by a profiler trace per kernel.  (Earlier
variants of both constants, and of the D 256 dQ block, are timed in
PERF.md.)  Run from the root of a checkout on a machine with an H100:

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
VARIANTS = ((128, 3),)
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
    ("no_key_rows", 1, 4, 2, 300, 160, 64, dict(mode="causal", window=32)),
    ("mqa16_d256", 1, 16, 1, 200, 200, 256, dict(mode="causal")),
    ("window_d256", 2, 4, 1, 300, 300, 256, dict(mode="causal", window=64)),
    ("length_d256", 2, 4, 2, 96, 300, 256, dict(mode="length")),
    ("offset_d256", 2, 4, 1, 77, 333, 256, dict(mode="causal",
                                                q_offset=256)),
    ("no_key_rows_d256", 1, 2, 1, 200, 100, 256, dict(mode="causal",
                                                      window=16)))
# (name, b, h, kh, s, d, window), causal
SHAPES = (("qwen3-1.7b", 4, 16, 8, 2048, 128, 0),
          ("smollm-135m", 8, 9, 3, 2048, 64, 0),
          ("recurrentgemma-9b", 2, 16, 1, 2048, 256, 2048),
          ("gemma3-1b", 4, 4, 1, 2048, 256, 512))
TOL = 2e-2      # bf16, of each gradient's largest magnitude


def variant_source(text: str, step64: int, stages: int) -> str:
    """The source with ``BwdTile``'s constants set to (step64, stages);
    raises unless each constant appears exactly once."""
    for pattern, value in zip(CONSTANTS, (step64, stages)):
        found = re.findall(pattern, text)
        if len(found) != 1:
            raise ValueError(f"{pattern!r} matches {len(found)} times")
        text = re.sub(pattern, lambda m: m.string[m.start(0):m.start(1)]
                      + str(value) + m.string[m.end(1):m.end(0)], text)
    return text


def splits(h: int, kh: int, d: int) -> tuple:
    """The head splits the D 256 dK/dV kernel can take for a group of
    H / KH query heads (the divisors of the group); (1,) at the other head
    dims."""
    group = h // kh
    return (tuple(s for s in range(1, group + 1) if group % s == 0)
            if d == 256 else (1,))


def build(_build, variants):
    """One library per variant (built together); returns {variant:
    library} after printing each one's ptxas lines for the pair."""
    src_dir = _build.CSRC
    out_dir = ROOT / "build" / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = (src_dir / "flash_attention_bwd.cu").read_text()
    procs = {}
    for key in variants:
        tag = "_".join(map(str, key))
        src = out_dir / f"bwd_{tag}.cu"
        src.write_text(variant_source(text, *key))
        lib = out_dir / f"libbwd_{tag}.so"
        procs[key] = (subprocess.Popen(
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
            lengths=None, q_offset=0, split=None):
        b, sk = q.shape[0], k.shape[2]
        if lengths is None:
            lengths = torch.full((b,), sk, dtype=torch.int32, device=dev)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        fa_ops.wgmma_backward(lib, q, k, v, out, do, lse, lengths, dq, dk, dv,
                              fa_ops.MODES[mode], window, q_offset,
                              q.shape[-1] ** -0.5, split)
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
            want = fa_ref.attention_backward_reference(q, k, v, out, lse, do,
                                                       **kw)
            for split in splits(h, kh, d):
                got = run(lib, q, k, v, out, lse, do, split=split, **kw)
                again = run(lib, q, k, v, out, lse, do, split=split, **kw)
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
    for name, b, h, kh, s, d, window in SHAPES:
        q, k, v, do = inputs(b, h, kh, s, s, d)
        out, lse = fa_ops.flash_attention_lse(q, k, v, window=window)
        rule = fa_ops.bwd_split(b, h, kh, s, d, fa_ops._sms(dev))
        times = {(key, split): [] for key in libs if sound[key]
                 for split in splits(h, kh, d)}
        order = list(times) + list(times)[::-1]
        for key, split in order * 2:
            fn = lambda: run(libs[key], q, k, v, out, lse, do,  # noqa: E731
                             window=window, split=split)
            fn()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                fn()
            end.record()
            end.synchronize()
            times[key, split].append(start.elapsed_time(end) / 10)
        for (key, split), ts in times.items():
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    run(libs[key], q, k, v, out, lse, do, window=window,
                        split=split)
                torch.cuda.synchronize()
            kernels = {re.search(r"(flash_bwd_\w+_kernel)", e.key)
                       .group(1): getattr(e, "self_device_time_total", 0)
                       / e.count / 1e3
                       for e in prof.key_averages()
                       if re.search(r"flash_bwd_(\w+_wgmma|sum)_kernel",
                                    e.key)}
            which = " (bwd_split's)" if split == rule else ""
            print(f"{name} {key} split {split}{which}: ms by events "
                  f"{[round(t, 4) for t in ts]}"
                  f", min {min(ts):.4f}; by trace {kernels}", flush=True)
    return 0 if all(sound.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
