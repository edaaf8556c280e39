"""Chip smoke test: drive the PyTorch/CUDA port's paths on one card — the
RedN GET path and the LM serving paths (qwen3-1.7b, rwkv6-7b and
recurrentgemma-9b prefill, decode and ServeEngine ticks).

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``src/repro_torch/csrc`` (one
``nvcc`` per source, all started together), then runs thirteen phases and
raises on any mismatch:

1. ``card``            — the card's name and power limit, the kernel build;
                         the flash library's SASS must hold HGMMA
                         (tensor-core) instructions.
2. ``kv_get``          — the GET path at a real size: a 4-shard hopscotch
                         store (4 x 65,536 buckets, 157,286 keys, 60% load)
                         answers zipf GET batches through ``sharded_get`` on
                         the redn, one_sided and two_sided paths, each row
                         checked against the host oracle ``reference_get``.
3. ``chain_kernel``    — the recycled get server (65,536 buckets, 2^19-word
                         image) through ``ChainEngine(spec, "kernel")``
                         against the interpreter and the plain loop; again
                         at the throughput benchmark's size.
4. ``chain_straight``  — the straight-line chain kernel against its plain
                         version on 1,024 seeded random programs; timed
                         by device time from a trace.
5. ``hopscotch_probe`` — the hopscotch kernel against the plain lookup on
                         every shard table, and against the redn answers;
                         on shard 0's table also at neighborhoods of 16
                         and 32 and with one value word.  Timed by device
                         time from a trace.
6. ``lm_prefill``      — qwen3-1.7b at full width and depth (28 layers,
                         bf16, seeded random weights): ``make_prefill_step``
                         on 4 x 2,048 prompt tokens (one flash-attention
                         launch per layer), then 8 ``decode_step``s whose
                         last logits are held against ``forward`` over all
                         2,056 tokens.
7. ``lm_serve``        — ``ServeEngine`` (8 slots, s_max 4,096): token-bucket
                         admission of a client mix, 32 ticks with the host
                         driver crashed at tick 16 (one launch of each
                         decode-attention kernel, split and combine, per
                         layer per tick), every tick finite and
                         in the vocab.  Here and in ``lm_prefill`` the
                         decode kernel is then held against its plain
                         version on a layer's cache as the drive left it,
                         at the drive's lengths (idle slots' zeros
                         included).  Then ``lm_float32``: the weights cast
                         to float32, the ``lm_prefill`` drive again at
                         2e-3, its ``forward`` the witness of the bf16
                         decode (``decode_witness``).
8. ``flash_kernel``    — the flash-attention kernels against their plain
                         version at the qwen3-1.7b prefill shape (causal),
                         windowed and in length mode, and at the
                         recurrentgemma-9b one (head dim 256, GQA 16,
                         window 2,048), float32 and bfloat16; ragged bf16
                         cases (Sq = Sk = 1,025; Sq 77, Sk 333, q_offset
                         256) at both.  Both shapes timed beside SDPA.
                         The drives' flash launches by kernel must be 28
                         tensor-core (lm_prefill), 12 tensor-core
                         (lm_griffin) and 28 CUDA-core (lm_float32).
9. ``decode_kernel``   — the decode kernels against their plain version
                         over a 32,768-long cache (B 16), lengths spread
                         over [1, S], and at recurrentgemma-9b's decode
                         shape (B 4, 16 query heads on 1 KV head of 256,
                         S 4,096, window 2,048, lengths 2,049-2,056), each
                         whole and as two ``kpos_offset`` shards, bf16 and
                         float32.  A planted fault (half of each sequence's
                         rows dropped) must fail the check.  Both shapes
                         timed (device time from a trace) beside the plain
                         version and SDPA.
10. ``lm_rwkv``        — rwkv6-7b at full width and depth (32 RWKV6 layers,
                         d 4,096, bf16, seeded random weights): the
                         ``lm_prefill`` drive (one WKV6 launch per layer),
                         then 16 ``ServeEngine`` ticks (8 slots, crash at
                         tick 8).  The WKV6 kernel is then held against the
                         plain scan and a float64 scan on layer 0's own
                         (r, k, v, w, u) from the drive, whose decays
                         include channels below the chunked form's range.
                         Then control drives, each with a fault planted in
                         the decode steps' recurrent state, and
                         ``lm_float32``, whose witness must pass the bf16
                         decode and fail each control.
11. ``lm_griffin``     — recurrentgemma-9b at full width and depth (26
                         recurrent layers, one RG-LRU launch each, and 12
                         local-attention layers, head dim 256, 16 query
                         heads on 1 KV head, window 2,048), s_max 4,096:
                         the same drives; the window binds on the last
                         rows.  The decode kernel is held on a local
                         layer's cache as the drive left it.
12. ``wkv6_kernel``    — the WKV6 kernel against its plain scan at the
                         prefill shape, at a T that is not a multiple of 32
                         and at T = 1, bfloat16 and float32.
13. ``rglru_kernel``   — the RG-LRU kernel likewise, and at a D that ends
                         in a part of the ring kernel's 64-channel tile
                         and at one whose rows no TMA copy can move (the
                         direct kernel); each case's launch by kernel as
                         ``rglru.variant`` picks it.  The recurrentgemma-9b
                         drives' 26 launches a prefill must all be the
                         ring kernel's.

Each kernel's launches are counted over the drive of its path only (the
counts are zeroed just before and read just after); the comparison and
timing launches come after.  The int32 kernels are exact (tolerance 0);
the flash kernel is held at 2e-5 (float32) and 2e-2 (bfloat16),
test_kernels.py's tolerances, the decode partial at DECODE_TOL in
both types, the recurrences at REC_TOL and their float32 final states at
STATE_TOL.  The last lines are the kernels' JSON, the
card line from ``nvidia-smi`` and the result line.  Without a CUDA card,
or outside a checkout, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM memory bandwidth (data sheet)
BF16_FLOP_PER_S = 989e12           # H100 SXM dense bf16 tensor-core peak
F32_FLOP_PER_S = 67e12             # H100 SXM float32 peak, no tensor cores
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # test_kernels.py's
# Last logits of prefill + decode against one forward over the same tokens
# (different shapes, so different bf16 roundings): bf16 keeps 8 significant
# bits, so one rounding flip moves an activation by ~2^-8 of its size, and
# flips accumulate over 28 layers.  The logits' std is 0.02 * sqrt(2048),
# ~0.9, at these init scales; 1/8 of that unit scale bounds the rounding,
# while a wrong cache or mask moves logits by O(1).  Float32 (the CPU
# rehearsal) keeps test_system.py's 2e-3.  qwen3's decoded logits are held
# to it; the recurrent models' bf16 prefill logits are, but their decode
# departs further (PERF.md), and every model's decode is held by
# ``decode_witness`` instead.
LOGIT_TOL = {torch.float32: 2e-3, torch.bfloat16: 0.125}
# The decode partial against its plain version, in either type: both read
# the same inputs and accumulate in float32, so the limit is set from the
# readings of sound runs (at most 1.7e-6, on l / l over a 32,768-long
# cache), not from bf16's precision.  A dropped half of each sequence's
# rows moves acc / l by orders of magnitude more (PERF.md).
DECODE_TOL = 1e-5
# The recurrences' outputs against their plain scans (and a float64 scan):
# test_kernels.py's tolerances; the final states are float32 in either
# input type and are held at the float32 limit.
REC_TOL = {torch.float32: 5e-5, torch.bfloat16: 5e-2}
STATE_TOL = 5e-5
# The bf16 decode witness: bf16 decoded logits against float32 ``forward``
# on the same weights may be WITNESS_K times as far from it as bf16
# ``forward`` is on the same rows (the bf16 rounding floor of the model at
# this depth).  Sound runs read 1.007-1.052 of it and the control runs,
# each with one STATE_FAULTS fault planted in the decode step's recurrent
# state, 6.09-11.1 (H100, full width and depth; PERF.md).  A fault of one
# bf16 rounding reads as the floor: the CPU tests hold those casts.
WITNESS_K = 2.0
STATE_FAULTS = ("stale", "zero")
# A WKV6 channel whose decay over a 32-step chunk falls below the chunked
# form's 1e-30 clamp: 32 |log w| > 69 (w < ~0.115).
CHUNK_LOG_RANGE = 69.0


def _import_port():
    """Import the port from this checkout's ``src`` (and nowhere else); a
    copy of this script outside a checkout exits non-zero here."""
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        raise SystemExit(f"chip_smoke: no src/repro_torch beside this script"
                         f" in {ROOT}: run it from the root of a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch
    if Path(repro_torch.__file__).resolve().parents[1] != ROOT / "src":
        raise RuntimeError(f"repro_torch imported from {repro_torch.__file__}"
                           f", not from this checkout ({ROOT})")


_import_port()
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import isa, machine, programs  # noqa: E402
from repro_torch.core.engine import ChainEngine  # noqa: E402
from repro_torch.data.pipeline import kv_request_stream  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.chain_vm import ops as chain_ops  # noqa: E402
from repro_torch.kernels.chain_vm import ref as chain_ref  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.decode_attention import ref as dec_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.hopscotch import ops as hop_ops  # noqa: E402
from repro_torch.kernels.rglru import ops as rg_ops  # noqa: E402
from repro_torch.kernels.rglru import ref as rg_ref  # noqa: E402
from repro_torch.kernels.rwkv6 import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.rwkv6 import ref as wkv_ref  # noqa: E402
from repro_torch.kvstore import hopscotch, store  # noqa: E402
from repro_torch.models import layers as model_layers  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.models import rwkv  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.rdma import transport  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.train import loop as train_loop  # noqa: E402


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Mean device time of ``fn()`` in ms, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


LAUNCH_COUNTS = (chain_ops.launches, hop_ops.launches, fa_ops.launches,
                 dec_ops.launches, wkv_ops.launches, rg_ops.launches)


def reset_launches():
    for counts in LAUNCH_COUNTS:
        for k in counts:
            counts[k] = 0


def read_launches() -> dict:
    return {k: n for counts in LAUNCH_COUNTS for k, n in counts.items()}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def require_close(got, want, tol: float, what: str) -> float:
    """Raise unless |got - want| <= tol + tol * |want| everywhere (and both
    are finite); returns the max absolute difference."""
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}")
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"{what}: non-finite values")
    diff = (got - want).abs()
    bad = diff > tol + tol * want.abs()
    if bool(bad.any()):
        raise AssertionError(f"{what}: {int(bad.sum())} values off by more "
                             f"than {tol} (max {float(diff.max())})")
    return float(diff.max())


def require_equal(a, b, what: str) -> int:
    """Raise unless the two integer arrays are equal; returns the max
    absolute difference (0)."""
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    if a.shape != b.shape or not np.array_equal(a, b):
        bad = np.argwhere(a != b)[:5] if a.shape == b.shape else "shape"
        raise AssertionError(f"{what}: mismatch {a.shape} vs {b.shape} at "
                             f"{bad}")
    if a.size == 0 or a.dtype == bool:
        return 0
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())


def mixed_keys(batch: int, live, miss_every: int = 4):
    """Deterministic mixed hit/miss key batch (the throughput benchmark's)."""
    live = list(live)
    return [1_000_000 + i if i % miss_every == miss_every - 1
            else live[i % len(live)] for i in range(batch)]


# ---------------------------------------------------------------------------
# phase 2: the main path
# ---------------------------------------------------------------------------

def build_store(n_shards: int, buckets: int, n_keys: int, val_words: int = 4):
    """The store loaded through the host ``set``: key k -> [k, 2k, 3k, 5k]."""
    kv = store.ShardedKV.build(n_shards, buckets, val_words)
    for k in range(1, n_keys + 1):
        if not kv.set(k, [k, 2 * k, 3 * k, 5 * k][:val_words]):
            raise RuntimeError(f"host set of key {k} needs a resize")
    return kv


def kv_batches(n_shards: int, n_keys: int, batch: int, n_batches: int):
    """(S, batch) zipf query batches from each source shard, with a few
    misses and key 0 mixed in."""
    stream = kv_request_stream(n_keys, batch, zipf_a=1.1, seed=1)
    out = []
    for i in range(n_batches):
        q = np.stack([next(stream)[1] for _ in range(n_shards)])
        q[:, -2] = n_keys + 1 + np.arange(n_shards) + i * n_shards  # misses
        q[i % n_shards, -1] = 0                                      # key 0
        out.append(q.astype(np.int32))
    return out


def redn_breakdown(dk, dv, q, neighborhood: int = 8) -> dict:
    """Device time of each stage of one redn batch (ms, CUDA events; the
    second of two passes, so nothing is cold), and the interpreter's step
    count: where the path's time goes."""
    s, n = dk.shape[0], dk.shape[1]
    srv = programs.build_hopscotch_server(n, dv.shape[2], neighborhood,
                                          device=dk.device)
    out = {}

    def timed(name, fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        value = fn()
        end.record()
        end.synchronize()
        out[name + "_ms"] = start.elapsed_time(end)
        return value

    for _ in range(2):
        state = timed("device_state", lambda: srv.device_state(dk, dv))
        dest = store.shard_of(q, s)
        pay = srv.device_payloads(q, hopscotch.bucket_of(q, n))
        recv, pos, ok = timed("dispatch", lambda: transport.dispatch(
            pay, dest, s, q.shape[1]))
        batch = timed("deliver_many", lambda: srv.engine.deliver_many(
            state, srv.recv_wq, recv.reshape(s, -1, recv.shape[-1])))
        batch.steps.zero_()
        ran = timed("step_loop", lambda: machine.run_batch_in_place(
            srv.spec, batch, 256))
        resp = ran.mem[:, srv.resp_region:srv.resp_region + srv.resp_words]
        timed("combine", lambda: transport.combine(
            resp.reshape(s, s, q.shape[1], -1), dest, pos, ok))
    out["contexts"] = int(ran.mem.shape[0])
    out["steps"] = int(ran.steps.max())
    out["step_ms"] = out["step_loop_ms"] / max(out["steps"], 1)
    return out


def phase_kv_get(device, n_shards=4, buckets=65536, n_keys=157286, batch=64,
                 n_batches=4, time_it=True):
    t0 = time.perf_counter()
    kv = build_store(n_shards, buckets, n_keys)
    load_s = time.perf_counter() - t0
    per_shard = [int((t.keys != 0).sum()) for t in kv.tables]
    dk, dv = kv.device_arrays(device)
    batches = kv_batches(n_shards, n_keys, batch, n_batches)
    refs = [store.reference_get(kv, q) for q in batches]
    if time_it:
        torch.cuda.reset_peak_memory_stats()
    result = dict(shards=n_shards, buckets_per_shard=buckets, keys=n_keys,
                  load_s=load_s, keys_per_shard=per_shard, hits={},
                  gets_per_s={})
    for method in ("redn", "one_sided", "two_sided"):
        hits = 0
        for q, (rf, rv) in zip(batches, refs):
            res = store.sharded_get(dk, dv, torch.from_numpy(q),
                                    method=method, device=device)
            if not bool(res.ok.all()):
                raise AssertionError(f"{method}: requests dropped: {res}")
            require_equal(res.found.reshape(-1), rf, f"{method} found")
            require_equal(res.values.reshape(-1, rv.shape[1]), rv,
                          f"{method} values")
            hits += int(res.found.sum())
        result["hits"][method] = hits
        if time_it:
            qs = [torch.from_numpy(q).to(device) for q in batches]
            ms = cuda_ms(lambda: [store.sharded_get(
                dk, dv, q, method=method, device=device) for q in qs],
                reps=1, warmup=1)
            result["gets_per_s"][method] = (n_batches * n_shards * batch
                                            / (ms * 1e-3))
    if time_it:
        result["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        result["redn_breakdown"] = redn_breakdown(
            dk, dv, torch.from_numpy(batches[0]).to(device))
    return result, kv, dk, dv


# ---------------------------------------------------------------------------
# phase 3: the managed chain kernel (ChainEngine "kernel" backend)
# ---------------------------------------------------------------------------

def recycled_server(device, n_buckets, mem_words, n_keys):
    srv = programs.build_recycled_get_server(n_buckets=n_buckets, val_len=2,
                                             mem_words=mem_words,
                                             device=device)
    for k in range(1, n_keys + 1):
        srv.insert(k, [k * 11, k * 11 + 1])
    srv.load()
    return srv


def served_value(srv, key: int):
    """What the recycled server answers for ``key``: its value if the key
    holds its bucket, else zeros."""
    entry = srv.kv.get(srv.h1(key))
    return entry[1] if entry is not None and entry[0] == key else [0, 0]


def plain_run_many(spec, state, wq, payloads, max_steps):
    """The batch ``ChainEngine(spec, "kernel").run_many`` runs, through the
    plain ``managed_chain_loop`` instead of the kernel; fields as the
    engine maps them back."""
    batch = ChainEngine(spec).deliver_many(state, wq, payloads)
    batch.steps.zero_()
    n, cap = batch.mem.shape[0], batch.msg_buf.shape[2]
    inits = torch.stack(
        [batch.head[:, 0], batch.tail[:, 0], batch.enable_limit[:, 0],
         batch.completions[:, 0], batch.msg_head[:, 0],
         batch.msg_tail[:, 0], torch.full_like(batch.steps, max_steps),
         batch.halted.int()], dim=1)
    mem, stats = chain_ref.managed_chain_loop(
        batch.mem, batch.msg_buf[:, 0].reshape(n, cap * isa.MSG_WORDS), inits,
        wq_base=spec.wq_bases[0], n_wrs=spec.wq_sizes[0],
        managed=bool(spec.managed[0]), max_steps=max_steps)
    return dict(mem=mem, head=stats[:, 0:1], enable_limit=stats[:, 1:2],
                completions=stats[:, 2:3], msg_head=stats[:, 3:4],
                halted=stats[:, 4] > 0, responses=stats[:, 6],
                steps=stats[:, 0] - batch.head[:, 0]), (batch, inits)


_CHAIN_FIELDS = ("mem", "head", "enable_limit", "completions", "msg_head",
                 "halted", "responses", "steps")


def chain_kernel_cases(device, n_buckets=65536, mem_words=1 << 19,
                       n_keys=40000, batch=256, small=(1, 16, 64, 256)):
    """(server, payloads) for the big server and the benchmark-size ones."""
    cases = []
    srv = recycled_server(device, n_buckets, mem_words, n_keys)
    keys = mixed_keys(batch, range(1, n_keys + 1, max(1, n_keys // batch)))
    cases.append((srv, np.asarray([srv._payload(k) for k in keys], np.int32)))
    small_srv = recycled_server(device, 32, 4096, 16)
    for b in small:
        keys = mixed_keys(b, range(1, 17))
        cases.append((small_srv, np.asarray(
            [small_srv._payload(k) for k in keys], np.int32)))
    return cases


def phase_chain_kernel(device, time_it=True, **sizes):
    cases = chain_kernel_cases(device, **sizes)
    reset_launches()
    outs = [ChainEngine(srv.spec, "kernel").run_many(
        srv.state, srv.loop_wq, pay, 64) for srv, pay in cases]
    launches = read_launches()["run_managed"]
    err = 0
    for (srv, pay), out_k in zip(cases, outs):
        out_i = ChainEngine(srv.spec, "interp").run_many(
            srv.state, srv.loop_wq, pay, 64)
        plain, _ = plain_run_many(srv.spec, srv.state, srv.loop_wq, pay, 64)
        for f in _CHAIN_FIELDS:
            err = max(err, require_equal(getattr(out_k, f), getattr(out_i, f),
                                         f"kernel vs interp {f}"))
            require_equal(getattr(out_k, f), plain[f], f"kernel vs plain {f}")
        resp = out_k.mem[:, srv.resp_region:srv.resp_region + srv.val_len]
        require_equal(resp, [served_value(srv, int(k)) for k in pay[:, 0]],
                      "recycled server responses")
    result = dict(launches=launches, max_abs_err=err,
                  contexts=[int(p.shape[0]) for _, p in cases])
    srv, pay = cases[0]
    _, (batch, inits) = plain_run_many(srv.spec, srv.state, srv.loop_wq, pay,
                                       64)
    n, cap = batch.mem.shape[0], batch.msg_buf.shape[2]
    msgs = batch.msg_buf[:, 0].reshape(n, cap * isa.MSG_WORDS).contiguous()
    args = (batch.mem, msgs, inits.contiguous())
    kw = dict(wq_base=srv.spec.wq_bases[0], n_wrs=srv.spec.wq_sizes[0],
              managed=True, max_steps=64)
    mem_k, stats_k = chain_ops.run_managed(*args, **kw)
    mem_p, stats_p = chain_ref.managed_chain_loop(*args, **kw)
    err = max(err, require_equal(mem_k, mem_p, "run_managed mem"),
              require_equal(stats_k, stats_p, "run_managed stats"))
    result["max_abs_err"] = err
    result["shape"] = tuple(batch.mem.shape)
    result["bound_ms"] = 2 * batch.mem.numel() * 4 / HBM_BYTES_PER_S * 1e3
    if time_it:
        result["ms"] = cuda_ms(lambda: chain_ops.run_managed(*args, **kw))
        result["plain_ms"] = cuda_ms(
            lambda: chain_ref.managed_chain_loop(*args, **kw), reps=2)
    return result


# ---------------------------------------------------------------------------
# phase 4: the straight-line chain kernel
# ---------------------------------------------------------------------------

STRAIGHT_OPS = (isa.NOOP, isa.WRITE, isa.WRITE_IMM, isa.READ, isa.CAS,
                isa.ADD, isa.MAX, isa.MIN, isa.HALT, isa.SEND, isa.WAIT, 13)


def random_straight_programs(n: int, mem_words: int, n_wrs: int, seed: int):
    """n images of one WQ of n_wrs random WRs at address 0, over random data;
    fields stray past both ends of the image to exercise the index rules."""
    rng = np.random.RandomState(seed)
    mems = rng.randint(-64, 64, size=(n, mem_words)).astype(np.int64)
    ops = rng.choice(STRAIGHT_OPS, size=(n, n_wrs))
    wr = mems[:, :n_wrs * isa.WR_WORDS].reshape(n, n_wrs, isa.WR_WORDS)
    wr[..., isa.F_CTRL] = (ops << isa.ID_BITS) | rng.randint(0, 8, (n, n_wrs))
    lo, hi = -24, mem_words + 24
    wr[..., isa.F_SRC] = rng.randint(lo, hi, (n, n_wrs))
    wr[..., isa.F_DST] = np.where(rng.rand(n, n_wrs) < 0.7,
                                  rng.randint(n_wrs * isa.WR_WORDS, hi,
                                              (n, n_wrs)),
                                  rng.randint(lo, hi, (n, n_wrs)))
    wr[..., isa.F_LEN] = rng.randint(-2, isa.MAX_COPY + 3, (n, n_wrs))
    mems[:, :n_wrs * isa.WR_WORDS] = wr.reshape(n, -1)
    return mems.astype(np.int32)


def phase_chain_straight(device, n=1024, mem_words=4096, n_wrs=16,
                         max_steps=24, time_it=True):
    mems = torch.from_numpy(
        random_straight_programs(n, mem_words, n_wrs, seed=7)).to(device)
    reset_launches()
    out = chain_ops.run_chains(mems, wq_base=0, n_wrs=n_wrs,
                               max_steps=max_steps)
    launches = read_launches()["run_chains"]
    plain, _ = chain_ref.run_chain_reference(mems, 0, n_wrs, max_steps)
    err = require_equal(out, plain, "run_chains")
    changed = int((out != mems).any(dim=1).sum())
    result = dict(launches=launches, max_abs_err=err, changed=changed,
                  shape=tuple(mems.shape),
                  bound_ms=2 * mems.numel() * 4 / HBM_BYTES_PER_S * 1e3)
    if time_it:
        # device time: CUDA events around a call this short time the host
        kw = dict(wq_base=0, n_wrs=n_wrs, max_steps=max_steps)
        result["ms"] = device_time(lambda: chain_ops.run_chains(mems, **kw),
                                   20)["device_ms"]
        result["plain_ms"] = device_time(
            lambda: chain_ref.run_chain_reference(mems, 0, n_wrs, max_steps),
            2)["device_ms"]
    return result


# ---------------------------------------------------------------------------
# phase 5: the hopscotch kernel
# ---------------------------------------------------------------------------

def probe_queries(kv, shard: int, n_queries: int, n_keys: int, seed: int):
    """Queries for one shard's table: stored keys, keys whose neighborhood
    wraps the table end, misses owned by the shard, and key 0."""
    rng = np.random.RandomState(seed + shard)
    t = kv.tables[shard]
    n, h = t.n_buckets, t.neighborhood
    stored = t.keys[t.keys != 0]
    homes = hopscotch.bucket_of(stored, n)
    wrap = stored[homes > n - h]
    cand = np.arange(n_keys + 1, n_keys + 1 + 64 * n_queries)
    misses = cand[store.shard_of(cand, kv.n_shards) == shard]
    n_wrap = min(len(wrap), n_queries // 8)
    n_miss = n_queries // 4
    q = np.concatenate([
        wrap[:n_wrap], misses[:n_miss], [0] * 4,
        rng.choice(stored, n_queries - n_wrap - n_miss - 4)])
    return rng.permutation(q).astype(np.int32), n_wrap


def probe_bytes(found, slot_probes, val_words: int) -> float:
    """Least bytes the probe must move for this data: each query read, its
    probed keys up to the first hit, a value row per hit, and found plus a
    row written."""
    b = found.numel()
    return 4.0 * (b + int(slot_probes.sum()) + int(found.sum()) * val_words
                  + b * val_words) + b


# The probe's cases beyond the store's own (H 8, V 4) on shard 0's table:
# (neighborhood, value words); a neighborhood of 16 or 32 fills a group of
# 16 lanes or a whole warp, one value word leaves all but one lane of a
# group without a word to copy.
PROBE_CASES = ((16, 4), (32, 4), (8, 1))


def phase_hopscotch_probe(device, kv, dk, dv, n_queries=4096, n_keys=157286,
                          redn_chunk=64, time_it=True):
    qs = [probe_queries(kv, s, n_queries, n_keys, seed=11)
          for s in range(kv.n_shards)]
    q_dev = [torch.from_numpy(q).to(device) for q, _ in qs]
    reset_launches()
    outs = [hop_ops.hopscotch_lookup(dk[s], dv[s], q_dev[s], kv.neighborhood)
            for s in range(kv.n_shards)]
    launches = read_launches()["hopscotch_lookup"]
    err, hits = 0, 0
    for s, (f, v) in enumerate(outs):
        pf, pv = hopscotch.lookup(dk[s], dv[s], q_dev[s], kv.neighborhood)
        require_equal(f, pf, f"shard {s} found")
        err = max(err, require_equal(v, pv, f"shard {s} values"))
        hits += int(f.sum())
    case_hits = {}
    for h, v in PROBE_CASES:
        vals = dv[0][:, :v].contiguous()
        f, got = hop_ops.hopscotch_lookup(dk[0], vals, q_dev[0], h)
        pf, pv = hopscotch.lookup(dk[0], vals, q_dev[0], h)
        require_equal(f, pf, f"H {h}, V {v} found")
        err = max(err, require_equal(got, pv, f"H {h}, V {v} values"))
        case_hits[f"H{h}/V{v}"] = int(f.sum())
    # the same queries through the redn path: row s of each call carries
    # shard s's queries (each owned by s, except key 0, a miss everywhere)
    for lo in range(0, n_queries, redn_chunk):
        q = torch.stack([qd[lo:lo + redn_chunk] for qd in q_dev])
        res = store.sharded_get(dk, dv, q, method="redn", device=device)
        for s, (f, v) in enumerate(outs):
            require_equal(res.found[s], f[lo:lo + redn_chunk],
                          f"redn vs kernel found, shard {s}")
            require_equal(res.values[s], v[lo:lo + redn_chunk],
                          f"redn vs kernel values, shard {s}")
    # bytes this data needs (shard 0's table and queries)
    n, h = dk.shape[1], kv.neighborhood
    q0 = q_dev[0]
    home = hopscotch.bucket_of(q0, n)
    idx = torch.remainder(home[:, None] + torch.arange(h, device=device), n)
    hit = dk[0][idx.long()] == q0[:, None]
    first = torch.argmax(hit.int(), dim=1) + 1
    probes = torch.where(hit.any(dim=1), first, h) * (q0 != 0)
    result = dict(launches=launches, max_abs_err=err, hits=hits,
                  case_hits=case_hits, wrap_queries=[w for _, w in qs],
                  shape=(n, n_queries),
                  bound_ms=probe_bytes(outs[0][0], probes, dv.shape[2])
                  / HBM_BYTES_PER_S * 1e3)
    if time_it:
        # device time: CUDA events around a ~20 us call time the host
        args = (dk[0], dv[0], q0, h)
        result["ms"] = device_time(lambda: hop_ops.hopscotch_lookup(*args),
                                   50)["device_ms"]
        result["plain_ms"] = device_time(lambda: hopscotch.lookup(*args),
                                         20)["device_ms"]
        result["event_ms"] = cuda_ms(lambda: hop_ops.hopscotch_lookup(*args),
                                     reps=20)
    return result


# ---------------------------------------------------------------------------
# phase 6: LM prefill (and decode continuing it)
# ---------------------------------------------------------------------------

def path_launches(cfg, device):
    """The kernel launches one prefill and one decode step of ``cfg``'s
    model make: a flash-attention launch per attention layer, a WKV6 launch
    per RWKV6 layer, an RG-LRU launch per recurrent layer, and a decode
    launch per attention layer and step (none on the CPU, where the plain
    versions run)."""
    kinds = [cfg.layer_type(i) for i in range(cfg.num_layers)]
    n_attn = sum(k in transformer.ATTN_KINDS for k in kinds)
    on = int(torch.device(device).type == "cuda")
    prefill = {"flash_attention": on * n_attn,
               "wkv6": on * kinds.count("rwkv"),
               "rglru": on * kinds.count("recurrent")}
    return prefill, {"decode_partial": on * n_attn}


def flash_variant_launches(cfg, device) -> dict:
    """The flash-attention launches of one prefill of ``cfg``'s model by
    kernel: every one of the kernel that ``variant`` picks for the model's
    type and head dim (none on the CPU)."""
    n = path_launches(cfg, device)[0]["flash_attention"]
    kind = fa_ops.variant(getattr(torch, cfg.dtype), cfg.head_dim) if n \
        else None
    return {f"flash_attention.{v}": n if v == kind else 0
            for v in ("wgmma", "fma")}


def rglru_variant_launches(cfg, device) -> dict:
    """The RG-LRU launches of one prefill of ``cfg``'s model by kernel:
    every one of the kernel that ``variant`` picks for the float32 a and u
    that the recurrent layers pass at the LRU width (none on the CPU)."""
    n = path_launches(cfg, device)[0]["rglru"]
    kind = rg_ops.variant(torch.float32, cfg.lru_width or cfg.d_model) \
        if n else None
    return {f"rglru.{v}": n if v == kind else 0 for v in ("ring", "direct")}


def decode_kernel_launches(cfg, device) -> dict:
    """The decode-attention launches of one decode step of ``cfg``'s model
    by kernel: one split and one combine launch per attention layer (none
    on the CPU)."""
    n = path_launches(cfg, device)[1]["decode_partial"]
    return {"decode_partial.split": n, "decode_partial.combine": n}


def require_launches(want: dict, what: str) -> dict:
    got = read_launches()
    got = {k: got[k] for k in want}
    if got != want:
        raise AssertionError(f"{what} launched {got}, expected {want}")
    return got


def last_attention_cache(cfg, caches):
    """The last attention layer's cache and its window (None if the model
    has no attention layer)."""
    for i in reversed(range(cfg.num_layers)):
        kind = cfg.layer_type(i)
        if kind in transformer.ATTN_KINDS:
            return caches[i], cfg.window if kind == "local" else 0
    return None, 0


def lm_drive(device, cfg, params, batch=4, prompt=2048, extra=8, s_max=None,
             time_it=True):
    """The prompt pass of ``batch`` seeded prompts, then ``extra`` decode
    steps continuing them, and one ``forward`` over the whole ``prompt +
    extra`` tokens; the prefill's last logits are held against it.  Returns
    (the result, {"tokens", "decoded" (B, extra, V), "forward" (the same
    rows of ``forward``)}, both float32)."""
    want_prefill, want_step = path_launches(cfg, device)
    want_variants = flash_variant_launches(cfg, device)
    want_rglru = rglru_variant_launches(cfg, device)
    dt = params.embed.embedding.dtype
    rng = np.random.RandomState(0)
    toks = torch.from_numpy(rng.randint(1, cfg.vocab_size, (
        batch, prompt + extra)).astype(np.int32)).to(device)
    prefill_step = train_loop.make_prefill_step(cfg,
                                                s_max=s_max or prompt + 64)
    serve_step = train_loop.make_serve_step(cfg)
    if time_it:
        torch.cuda.reset_peak_memory_stats()
    sync(device)
    reset_launches()
    t0 = time.perf_counter()
    last, caches, lengths = prefill_step(params, {"tokens": toks[:, :prompt]})
    sync(device)
    first_s = time.perf_counter() - t0
    prefill_launches = require_launches(want_prefill, "the prefill")
    flash_variants = require_launches(want_variants,
                                      "the prefill's flash kernels")
    rglru_variants = require_launches(want_rglru,
                                      "the prefill's RG-LRU kernels")
    step_ms, decoded = [], []
    reset_launches()
    for i in range(extra):
        t0 = time.perf_counter()
        lengths = lengths + 1
        logits, caches = serve_step(params, toks[:, prompt + i], caches,
                                    lengths)
        sync(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        decoded.append(logits.float())
    decode_launches = require_launches(
        {k: n * extra for k, n in {**want_step, **decode_kernel_launches(
            cfg, device)}.items()}, f"{extra} decode steps")["decode_partial"]
    if logits.shape != (batch, cfg.padded_vocab):
        raise AssertionError(f"decode logits {tuple(logits.shape)}")
    cache, window = last_attention_cache(cfg, caches)
    cache_errs = None if cache is None else require_cache_decode(
        cache, lengths, cfg.num_heads, "decode on the prefill cache",
        window=window)
    full, _, _ = model_lib.forward(params, {"tokens": toks}, cfg)
    err_prefill = require_close(last, full[:, prompt - 1], LOGIT_TOL[dt],
                                "prefill last logits vs forward")
    rows = dict(tokens=toks, decoded=torch.stack(decoded, 1),
                forward=full[:, prompt:].float().clone())
    del full
    result = dict(batch=batch, prompt=prompt, decode_steps=extra,
                  prefill_launches=prefill_launches,
                  flash_launches=prefill_launches["flash_attention"],
                  flash_variant_launches=flash_variants,
                  rglru_variant_launches=rglru_variants,
                  decode_launches=decode_launches,
                  max_abs_err_prefill=err_prefill, logit_tol=LOGIT_TOL[dt],
                  cache_decode_errs=cache_errs, first_prefill_s=first_s,
                  decode_step_ms=step_ms)
    if time_it:
        sync(device)
        t0 = time.perf_counter()
        prefill_step(params, {"tokens": toks[:, :prompt]})
        sync(device)
        result["prefill_s"] = time.perf_counter() - t0
        result["prefill_tokens_per_s"] = batch * prompt / result["prefill_s"]
        result["decode_ms_per_step_median"] = float(np.median(step_ms))
        result["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        prof = device_profile(
            lambda: prefill_step(params, {"tokens": toks[:, :prompt]}), 1)
        prof["idle_share"] = 1 - prof["device_ms"] / (result["prefill_s"]
                                                      * 1e3)
        result["prefill_profile"] = prof
        prof = device_profile(lambda: serve_step(
            params, toks[:, prompt + extra - 1], caches, lengths), 3)
        prof["idle_share"] = 1 - (prof["device_ms"]
                                  / result["decode_ms_per_step_median"])
        result["decode_profile"] = prof
        result["decode_kernel_ms_per_step"] = prof["by_group_ms"][
            "decode_attention"]
    return result, rows


def phase_lm_prefill(device, cfg, params, batch=4, prompt=2048, extra=8,
                     s_max=None, time_it=True):
    """``lm_drive``, with the last decoded logits also held against
    ``forward`` at LOGIT_TOL.  The drive's rows are kept under "rows"."""
    result, rows = lm_drive(device, cfg, params, batch, prompt, extra, s_max,
                            time_it)
    result["max_abs_err_decode"] = require_close(
        rows["decoded"][:, -1], rows["forward"][:, -1], result["logit_tol"],
        "decoded last logits vs forward")
    result["rows"] = rows
    return result


def decoded_rows(cfg, params, toks, prompt: int, s_max: int):
    """Prefill ``toks[:, :prompt]``, decode the rest; the decoded logits
    (B, steps, V) float32."""
    last, caches, lengths = train_loop.make_prefill_step(cfg, s_max=s_max)(
        params, {"tokens": toks[:, :prompt]})
    serve_step = train_loop.make_serve_step(cfg)
    out = []
    for i in range(prompt, toks.shape[1]):
        lengths = lengths + 1
        logits, caches = serve_step(params, toks[:, i], caches, lengths)
        out.append(logits.float())
    return torch.stack(out, 1)


class planted_state_fault:
    """A decode fault planted for a control run: each one-token recurrence
    step (WKV6's and RG-LRU's) hands on ``kind`` of state instead of the
    one it computed: "stale" the state it was given, "zero" zeros."""

    def __init__(self, kind: str):
        self.kind = kind

    def _plant(self, fn):
        def step(*args):
            out, new = fn(*args)
            new = args[-1] if self.kind == "stale" else torch.zeros_like(new)
            return out, new
        return step

    def __enter__(self):
        self.saved = [(m, m.__dict__[n]) for m, n in (
            (wkv_ops, "wkv6_decode_step"), (rg_ops, "rglru_decode_step"))]
        for m, fn in self.saved:
            setattr(m, fn.__name__, self._plant(fn))
        return self

    def __exit__(self, *exc):
        for m, fn in self.saved:
            setattr(m, fn.__name__, fn)


# ---------------------------------------------------------------------------
# phase 7: LM serving (ServeEngine decode ticks)
# ---------------------------------------------------------------------------

def phase_lm_serve(device, cfg, params, s_max=4096, n_slots=8, ticks=32,
                   crash_at=16, time_it=True):
    """Admission of a client mix, the admitted requests in slots (the rest
    idle at length 0), ``ticks`` decode ticks with the host driver crashed
    at ``crash_at``."""
    layers = path_launches(cfg, device)[1]["decode_partial"]
    pair = decode_kernel_launches(cfg, device)
    if time_it:
        torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(cfg, params, s_max=s_max, n_slots=n_slots, burst=4.0,
                      device=device)
    mix = [0, 0, 0, 0, 0, 0, 1, 2][:n_slots]
    admitted = eng.admit(mix)
    want = [True] * 4 + [False] * 2 + [True] * 2
    if admitted != want[:n_slots]:
        raise AssertionError(f"admission {admitted}, expected {want}")
    rng = np.random.RandomState(1)
    slots = 0
    for client, ok in zip(mix, admitted):
        if ok:
            eng.add_request(slots, client, int(rng.randint(1,
                                                           cfg.vocab_size)))
            slots += 1
    finite = []
    serve = eng._serve

    def checked_serve(*args):
        logits, caches = serve(*args)
        finite.append(torch.isfinite(logits).all())
        return logits, caches
    eng._serve = checked_serve

    sync(device)
    reset_launches()
    per_tick, tick_ms, tokens = [], [], []
    t_start = time.perf_counter()
    for tick in range(ticks):
        if tick == crash_at:
            eng.crash_host_driver()
        t0 = time.perf_counter()
        tokens.append(eng.step())          # reads the tokens back: a sync
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        per_tick.append(read_launches()["decode_partial"])
    wall = time.perf_counter() - t_start
    tokens = np.stack(tokens)
    launches = [b - a for a, b in zip([0] + per_tick[:-1], per_tick)]
    if launches != [layers] * ticks:
        raise AssertionError(f"decode_partial launches per tick {launches}, "
                             f"expected {layers}")
    pair = require_launches({k: n * ticks for k, n in pair.items()},
                            f"{ticks} serving ticks")
    if not all(bool(f) for f in finite):
        raise AssertionError("non-finite logits in a serving tick")
    if tokens.min() < 0 or tokens.max() >= cfg.padded_vocab:
        raise AssertionError("a sampled token lies outside the vocab")
    if eng.host_alive() or eng.stats["steps"] != ticks or \
            eng.stats["tokens"] != slots * ticks:
        raise AssertionError(f"serving did not continue after the crash: "
                             f"{eng.stats}")
    want_lengths = [1 + ticks] * slots + [0] * (n_slots - slots)
    if eng.lengths.cpu().tolist() != want_lengths:
        raise AssertionError(f"lengths {eng.lengths.tolist()}")
    cache, window = last_attention_cache(cfg, eng.caches)
    cache_errs = None if cache is None else require_cache_decode(
        cache, eng.lengths, cfg.num_heads, "decode on the serving cache",
        window=window)
    result = dict(slots=n_slots, active=slots, s_max=s_max, ticks=ticks,
                  crash_at=crash_at, admitted=admitted,
                  decode_launches=per_tick[-1],
                  decode_kernel_launches=pair, stats=dict(eng.stats),
                  cache_decode_errs=cache_errs)
    if time_it:
        result["tokens_per_s"] = slots * ticks / wall
        result["ms_per_tick_mean"] = wall * 1e3 / ticks
        result["ms_per_tick_median"] = float(np.median(tick_ms))
        result["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        prof = device_profile(eng.step, 3)
        prof["idle_share"] = 1 - (prof["device_ms"]
                                  / result["ms_per_tick_median"])
        result["tick_profile"] = prof
    return result


# ---------------------------------------------------------------------------
# phases 8-9: the attention kernels against their plain versions
# ---------------------------------------------------------------------------

def random_qkv(device, seed, dtype, b, h, kh, sq, sk, d):
    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dtype)
    return rnd(b, h, sq, d), rnd(b, kh, sk, d), rnd(b, kh, sk, d)


# The flash kernel's timed shapes: the prefill attention of the two models
# whose prefill runs it, B 4 x 2,048 prompt tokens: (name, b, h, kh, s, d,
# window).  At S = 2,048 griffin's window of 2,048 binds nothing, so SDPA
# with is_causal=True, enable_gqa=True computes the same function.
FLASH_SHAPES = (("qwen3-1.7b", 4, 16, 8, 2048, 128, 0),
                ("recurrentgemma-9b", 4, 16, 1, 2048, 256, 2048))
# ragged bf16 causal cases at each shape's heads: (sq, sk, q_offset)
FLASH_RAGGED = ((1025, 1025, 0), (77, 333, 256))
BOTH_DTYPES = (torch.bfloat16, torch.float32)


def flash_timing(device, b, h, kh, s, d, window, time_it=True) -> dict:
    """The bound of one causal (windowed) prefill attention at this shape
    and, with ``time_it``, the bf16 and float32 kernels' times beside the
    plain version's and SDPA's."""
    q, k, v = random_qkv(device, 0, torch.bfloat16, b, h, kh, s, s, d)
    pairs = int(fa_ref.visible_mask(s, s, "cpu", window=window).sum())
    flops = 4.0 * b * h * d * pairs                  # the visible (q, k)
    nbytes = 2.0 * (2 * q.numel() + 2 * k.numel())   # q, k, v, out
    result = dict(shape=(b, h, kh, s, s, d, window), flops=flops,
                  bound_ms=max(flops / BF16_FLOP_PER_S,
                               nbytes / HBM_BYTES_PER_S) * 1e3,
                  bound_by=("operations" if flops / BF16_FLOP_PER_S
                            >= nbytes / HBM_BYTES_PER_S else "bytes"))
    if time_it:
        kw = dict(window=window)
        result["ms"] = cuda_ms(lambda: fa_ops.flash_attention(q, k, v, **kw),
                               reps=10)
        result["tflop_per_s"] = flops / (result["ms"] * 1e-3) / 1e12
        result["plain_ms"] = cuda_ms(
            lambda: fa_ref.attention_reference(q, k, v, **kw), reps=2)
        result["library_ms"] = cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True),
            reps=10) if window == 0 or window >= s else None
        q, k, v = (t.float() for t in (q, k, v))
        result["float32_ms"] = cuda_ms(
            lambda: fa_ops.flash_attention(q, k, v, **kw), reps=2)
    return result


def phase_flash_kernel(device, shapes=FLASH_SHAPES, time_it=True):
    """The flash kernel against its plain version at each of ``shapes``:
    causal with the shape's window in bf16 and float32, at the first shape
    also windowed (S / 4) and in length mode, and the FLASH_RAGGED cases in
    bf16; then ``flash_timing`` at each.  The first shape's numbers are the
    kernel's row."""
    errs, timed = {}, {}
    for si, (name, b, h, kh, s, d, window) in enumerate(shapes):
        rng = np.random.RandomState(3)
        lengths = torch.from_numpy(np.sort(rng.randint(1, s + 1, b)).astype(
            np.int32)).to(device)
        cases = [  # case, (b, sq, sk), kwargs, types
            ("causal", (b, s, s), dict(mode="causal", window=window),
             BOTH_DTYPES)]
        if si == 0:
            cases += [
                ("window", (1, s, s), dict(mode="causal", window=s // 4),
                 BOTH_DTYPES),
                ("length", (b, 16, s), dict(mode="length", lengths=lengths),
                 BOTH_DTYPES)]
        cases += [(f"ragged{sq}x{sk}+{off}", (b, sq, sk),
                   dict(mode="causal", q_offset=off), (torch.bfloat16,))
                  for sq, sk, off in FLASH_RAGGED]
        for i, (case, (bb, sq, sk), kw, dtypes) in enumerate(cases):
            for dtype in dtypes:
                q, k, v = random_qkv(device, i, dtype, bb, h, kh, sq, sk, d)
                got = fa_ops.flash_attention(q, k, v, **kw)
                want = fa_ref.attention_reference(q, k, v, **kw)
                key = f"{name}/{case}/{str(dtype)[6:]}"
                errs[key] = require_close(got, want, TOL[dtype],
                                          f"flash {key}")
                del got, want
        timed[name] = flash_timing(device, b, h, kh, s, d, window, time_it)
    first = shapes[0][0]
    return dict(timed[first], max_abs_err=errs[f"{first}/causal/bfloat16"],
                errs=errs, shapes=timed)


def require_partial_close(got, want, tol: float, what: str) -> dict:
    """Hold a decode partial (acc, m, l) to the plain one; returns the max
    errors.  acc and l both carry the factor exp(-m), and m, a max of dot
    products rounded in another order, differs from the plain version's by
    ulps, which moves the un-normalised acc (of size up to l) by more than
    the limit.  So both are divided by the plain version's l (acc / l is
    the attention output); m is held as it is."""
    (acc, m, l), (pa, pm, pl) = got, want
    unit = pl.clamp(min=1e-30)
    return dict(
        acc=require_close(acc / unit, pa / unit, tol, f"{what}: acc / l"),
        l=require_close(l / unit, pl / unit, tol, f"{what}: l / l"),
        m=require_close(m, pm, tol, f"{what}: m"))


def require_cache_decode(cache, lengths, n_heads: int, what: str,
                         window: int = 0) -> dict:
    """The decode kernel on a layer's cache as the main path left it, at
    the path's lengths and window, against its plain version, with a
    seeded query; a row of length 0 (an idle slot) must give acc 0 and
    l 0."""
    k, v = cache["k"], cache["v"]
    gen = torch.Generator(device=k.device).manual_seed(6)
    q = torch.randn((k.shape[0], n_heads, 1, k.shape[3]), generator=gen,
                    device=k.device).to(k.dtype)
    got = dec_ops.decode_partial(q, k, v, lengths, window=window)
    errs = require_partial_close(
        got, dec_ref.decode_partial_reference(q, k, v, lengths,
                                              window=window), DECODE_TOL,
        what)
    idle = lengths == 0
    if bool((got[0][idle] != 0).any() | (got[2][idle] != 0).any()):
        raise AssertionError(f"{what}: an idle row gives a non-zero partial")
    errs["idle_rows"] = int(idle.sum())
    errs["window"] = window
    return errs


def planted_fault_err(q, k, v, lengths, want, tol: float) -> float:
    """The check against a faulty partial that read only the first half of
    each sequence's rows: raises unless the check rejects it, and returns
    its largest acc / l error."""
    fault = dec_ref.decode_partial_reference(q, k, v, (lengths + 1) // 2)
    unit = want[2].clamp(min=1e-30)
    err = float((fault[0] / unit - want[0] / unit).abs().max())
    try:
        require_partial_close(fault, want, tol, "planted fault")
    except AssertionError:
        return err
    raise AssertionError("the decode check passes a partial that dropped "
                         "half of each sequence's rows")


# The decode kernel's shapes: (name, b, h, kh, s, d, window, lengths):
# a 32,768-long cache (B 16, 16 / 8 heads of 128) with lengths spread over
# [1, S], and recurrentgemma-9b's decode step as the lm_griffin drive runs
# it (B 4, 16 query heads on 1 KV head of 256, s_max 4,096, window 2,048,
# lengths 2,049-2,056, past the window).
DECODE_SHAPES = (("32k", 16, 16, 8, 32768, 128, 0, (1, 32768)),
                 ("recurrentgemma-9b", 4, 16, 1, 4096, 256, 2048,
                  (2049, 2056)))


def decode_lengths(device, b: int, span) -> torch.Tensor:
    """Seeded lengths in [lo, hi], the first lo and the last hi."""
    lo, hi = span
    rng = np.random.RandomState(4)
    ln = rng.randint(lo, hi + 1, b)
    ln[0], ln[-1] = lo, hi
    return torch.from_numpy(ln.astype(np.int32)).to(device)


def device_time(fn, reps: int, kernels=()) -> dict:
    """``device_profile`` of ``fn`` after one warm-up call: the device time
    per call (all its kernels) from a torch.profiler trace, where CUDA
    events around a kernel shorter than its wrapper's host work would time
    the host."""
    fn()
    return device_profile(fn, reps, kernels)


DECODE_KERNELS = ("decode_split_kernel", "decode_combine_kernel")


def decode_timing(device, q, k, v, lengths, window, time_it=True) -> dict:
    """The bytes bound of one decode partial (the visible K and V rows, q
    and the outputs) and, with ``time_it``, the kernel pair's, the plain
    version's and SDPA's device times per call."""
    b, h, _, d = q.shape
    kh, s = k.shape[1], k.shape[2]
    ln = lengths.long()
    lo = (ln - window).clamp(min=0) if window > 0 else torch.zeros_like(ln)
    visible = int((ln.clamp(max=s) - lo).clamp(min=0).sum())
    nbytes = (2.0 * visible * kh * d * k.element_size()  # visible K, V rows
              + q.numel() * q.element_size() + b * h * (d + 2) * 4)
    result = dict(shape=(b, h, kh, s, d, window), visible_rows=visible,
                  splits=dec_ops.plan_splits(b, kh, s),
                  bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    if time_it:
        kw = dict(window=window)
        prof = device_time(
            lambda: dec_ops.decode_partial(q, k, v, lengths, **kw), 20,
            DECODE_KERNELS)
        result["ms"] = prof["device_ms"]
        result["by_kernel_ms"] = prof["by_kernel_ms"]
        result["plain_ms"] = device_time(
            lambda: dec_ref.decode_partial_reference(q, k, v, lengths, **kw),
            2)["device_ms"]
        pos = torch.arange(s, device=device)[None, None, None, :]
        ln4 = lengths[:, None, None, None]
        mask = (pos < ln4) & (pos >= ln4 - window) if window > 0 \
            else pos < ln4
        result["library_ms"] = device_time(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True), 20)["device_ms"]
        result["gb_per_s"] = nbytes / (result["ms"] * 1e-3) / 1e9
    return result


def phase_decode_kernel(device, shapes=DECODE_SHAPES, time_it=True):
    """The decode kernel against its plain version at each of ``shapes``,
    float32 and bf16, whole and as two ``kpos_offset`` shards; at the
    first shape also a planted fault (half of each sequence's rows
    dropped) that the check must reject.  Then ``decode_timing`` of the
    bf16 cache at each.  The first shape's numbers are the kernel's row."""
    errs, timed = {}, {}
    for si, (name, b, h, kh, s, d, window, span) in enumerate(shapes):
        lengths = decode_lengths(device, b, span)
        for dtype in (torch.float32, torch.bfloat16):
            t = f"{name}/{str(dtype)[6:]}"
            q, k, v = random_qkv(device, 5, dtype, b, h, kh, 1, s, d)
            want = dec_ref.decode_partial_reference(q, k, v, lengths,
                                                    window=window)
            got = dec_ops.decode_partial(q, k, v, lengths, window=window)
            for part, err in require_partial_close(
                    got, want, DECODE_TOL, f"decode {t}").items():
                errs[f"{t}/{part}"] = err
            # two shards of the cache, each with its kpos_offset, combined
            half = s // 2
            parts = [dec_ops.decode_partial(
                q, k[:, :, i * half:(i + 1) * half],
                v[:, :, i * half:(i + 1) * half], lengths, window=window,
                kpos_offset=i * half) for i in range(2)]
            errs[f"{t}/shards"] = require_close(
                dec_ops.combine_partials(parts),
                want[0] / want[2].clamp(min=1e-30), DECODE_TOL,
                f"decode 2 shards {t}")
            if si == 0 and dtype == torch.bfloat16:
                fault_err = planted_fault_err(q, k, v, lengths, want,
                                              DECODE_TOL)
            del got, want, parts
        timed[name] = decode_timing(device, q, k, v, lengths, window,
                                    time_it)
        del q, k, v
    first = shapes[0][0]
    return dict(timed[first], max_abs_err=errs[f"{first}/bfloat16/acc"],
                errs=errs, tol=DECODE_TOL, planted_fault_err=fault_err,
                shapes=timed)


# ---------------------------------------------------------------------------
# phases 10-11: the recurrent LM paths (rwkv6-7b, recurrentgemma-9b)
# ---------------------------------------------------------------------------

def check_wkv6_layer(r, k, v, w, u) -> dict:
    """The WKV6 kernel on one layer's own inputs against the plain float32
    scan and a float64 scan; the errors, also on the state rows of the
    channels whose decay over a 32-step chunk leaves the chunked form's
    range, and the share of such channels."""
    dt = r.dtype
    o, s = wkv_ops.wkv6(r, k, v, w, u)
    po, ps = wkv_ref.wkv6_reference(r, k, v, w, u)
    do, ds = wkv_ref.wkv6_reference(*(x.double() for x in (r, k, v, w, u)))
    small = 32 * torch.log(w).abs() > CHUNK_LOG_RANGE      # (B, H, T, N)
    rows = small.any(dim=2)                                 # (B, H, N)
    out = dict(
        shape=tuple(r.shape), dtype=str(dt)[6:],
        o_vs_plain=require_close(o, po, REC_TOL[dt], "layer-0 o vs plain"),
        s_vs_plain=require_close(s, ps, STATE_TOL, "layer-0 S vs plain"),
        o_vs_f64=require_close(o, do, REC_TOL[dt], "layer-0 o vs float64"),
        s_vs_f64=require_close(s, ds, STATE_TOL, "layer-0 S vs float64"),
        small_decay_share=float(small.float().mean()),
        small_decay_channel_share=float(small.any(dim=(0, 2)).float()
                                        .mean()),
        w_min=float(w.min()))
    if bool(rows.any()):
        out["s_vs_f64_small_decay_rows"] = float(
            (s.double() - ds).abs()[rows].max())
    return out


def layer0_wkv6_inputs(cfg, params, tokens):
    """Layer 0's WKV6 inputs (r, k, v, w, u) for ``tokens``, as its
    ``time_mix`` forms them in the prefill."""
    blk = params.decoder[0]
    x = model_layers.embed_tokens(params.embed, tokens, cfg)
    h = model_layers.rms_norm(x, blk.norm1, cfg.norm_eps)
    r, k, v, w, _ = rwkv.time_mix_inputs(blk.mix, h, cfg)
    return r, k, v, w, blk.mix.u


def decode_witness(rows, truth, controls: dict) -> dict:
    """The bf16 decoded logits against float32 ``forward`` of the same
    weights (``truth``), within WITNESS_K times bf16 ``forward``'s own
    distance from it on the same rows; each control's decoded logits must
    fall outside that limit."""
    floor = float((rows["forward"] - truth).abs().max())
    if not floor > 0:
        raise AssertionError("bf16 forward equals float32 forward: the "
                             "witness needs a bf16 model")
    limit = WITNESS_K * floor
    err = float((rows["decoded"] - truth).abs().max())
    out = dict(floor=floor, limit=limit, err=err, ratio=err / floor,
               controls={})
    if not err <= limit:
        raise AssertionError(f"bf16 decoded logits {err} from float32 "
                             f"forward, over {WITNESS_K} x bf16 forward's "
                             f"{floor}")
    for name, decoded in controls.items():
        c = float((decoded - truth).abs().max())
        out["controls"][name] = c
        if not c > limit:
            raise AssertionError(f"control {name!r} ({c}) passes the witness"
                                 f" (limit {limit})")
    return out


def phase_lm_float32(device, cfg, params, rows, controls: dict, batch=4,
                     prompt=2048, extra=8, s_max=None) -> dict:
    """The weights cast to float32 in place and the ``lm_prefill`` drive
    again, gated at LOGIT_TOL[float32]; its ``forward`` is then the
    witness of the bf16 drive's decoded ``rows`` (``decode_witness``)."""
    params.float()
    result = phase_lm_prefill(
        device, dataclasses.replace(cfg, dtype="float32"), params, batch,
        prompt, extra, s_max, time_it=False)
    f32 = result.pop("rows")
    if not torch.equal(f32["tokens"], rows["tokens"]):
        raise AssertionError("the float32 drive read other tokens")
    result["bf16_decode_witness"] = decode_witness(rows, f32["forward"],
                                                   controls)
    return result


def phase_lm_recurrent(device, cfg, params, batch=4, prompt=2048, extra=8,
                       s_max=4096, n_slots=8, ticks=16, crash_at=8,
                       time_it=True):
    """The ``lm_prefill`` drive (its decode gated by ``lm_float32``) and
    the ``lm_serve`` drive of a recurrent model in bf16; for RWKV6, the
    WKV6 kernel then held on layer 0's own inputs from the drive's
    prompt.  The control runs of ``decode_witness`` (the drive with each
    ``planted_state_fault``), then ``lm_float32``."""
    prefill, rows = lm_drive(device, cfg, params, batch, prompt, extra,
                             s_max, time_it)
    prefill["max_abs_err_decode"] = float(
        (rows["decoded"][:, -1] - rows["forward"][:, -1]).abs().max())
    result = dict(prefill=prefill)
    if "rwkv" in [cfg.layer_type(i) for i in range(cfg.num_layers)]:
        result["layer0_wkv6"] = check_wkv6_layer(*layer0_wkv6_inputs(
            cfg, params, rows["tokens"][:, :prompt]))
    result["serve"] = phase_lm_serve(device, cfg, params, s_max, n_slots,
                                     ticks, crash_at, time_it)
    controls = {}
    for kind in STATE_FAULTS:
        with planted_state_fault(kind):
            controls[kind] = decoded_rows(cfg, params, rows["tokens"],
                                          prompt, s_max)
    result["lm_float32"] = phase_lm_float32(device, cfg, params, rows,
                                            controls, batch, prompt, extra,
                                            s_max)
    return result


# ---------------------------------------------------------------------------
# phases 12-13: the recurrence kernels against their plain versions
# ---------------------------------------------------------------------------

def model_decays(gen, shape, device):
    """Decays drawn as rwkv's init draws them with a zero LoRA term:
    w = exp(-exp(w0)), w0 ~ N(-0.5, 0.5)."""
    w0 = 0.5 * torch.randn(shape, generator=gen, device=device) - 0.5
    return torch.exp(-torch.exp(w0))


def wkv6_inputs(device, seed, dtype, b, h, t, n):
    gen = torch.Generator(device=device).manual_seed(seed)
    r, k, v = (torch.randn((b, h, t, n), generator=gen, device=device)
               .to(dtype) for _ in range(3))
    u = 0.3 * torch.randn((h, n), generator=gen, device=device)
    return r, k, v, model_decays(gen, (b, h, t, n), device), u


def phase_wkv6_kernel(device, b=4, h=64, t=2048, n=64, time_it=True):
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for tt in (t, t // 2 + 1, 1):
            args = wkv6_inputs(device, tt, dtype, b, h, tt, n)
            o, s = wkv_ops.wkv6(*args)
            po, ps = wkv_ref.wkv6_reference(*args)
            key = f"T{tt}/{str(dtype)[6:]}"
            errs[f"o/{key}"] = require_close(o, po, REC_TOL[dtype],
                                             f"wkv6 o {key}")
            errs[f"S/{key}"] = require_close(s, ps, STATE_TOL,
                                             f"wkv6 S {key}")
            del o, s, po, ps, args
    args = wkv6_inputs(device, 0, torch.bfloat16, b, h, t, n)
    r, w = args[0], args[3]
    nbytes = (3 * r.numel() * r.element_size() + w.numel() * 4
              + args[4].numel() * 4 + r.numel() * r.element_size()
              + b * h * n * n * 4)           # r, k, v, w, u in; o, S out
    flops = b * h * t * (4.0 * n * n + 3 * n + 2 * n)
    result = dict(max_abs_err=errs[f"o/T{t}/bfloat16"], errs=errs,
                  shape=(b, h, t, n), bytes=nbytes, flops=flops,
                  bound_ms=max(nbytes / HBM_BYTES_PER_S,
                               flops / F32_FLOP_PER_S) * 1e3,
                  bound_by=("operations" if flops / F32_FLOP_PER_S
                            > nbytes / HBM_BYTES_PER_S else "bytes"))
    if time_it:
        result["ms"] = cuda_ms(lambda: wkv_ops.wkv6(*args), reps=10)
        result["plain_ms"] = cuda_ms(lambda: wkv_ref.wkv6_reference(*args),
                                     reps=1)
    return result


def rglru_cases(b: int, t: int, d: int):
    """The RG-LRU kernel's checked shapes: the prefill's (b, t, d); at its D
    a T that ends in a part of the ring kernel's 32-step chunk and T 1; a
    D that ends in a part of its 64-channel tile (d + 4; the direct kernel
    in bf16, whose rows are then not whole 16-byte units) and one whose
    rows no TMA copy can move in either type (d + 3, the direct kernel)."""
    return ((b, t, d), (b, t // 2 + 1, d), (b, 1, d), (b, 97, d + 4),
            (b, 33, d + 3))


def phase_rglru_kernel(device, b=4, t=2048, d=4096, time_it=True):
    def inputs(seed, dtype, bb, tt, dd):
        gen = torch.Generator(device=device).manual_seed(seed)
        # the path's decays: a = exp(-8 softplus(lam) r) >= ~0.86
        a = 0.86 + 0.14 * torch.rand((bb, tt, dd), generator=gen,
                                     device=device)
        u = torch.randn((bb, tt, dd), generator=gen, device=device)
        return a.to(dtype), u.to(dtype)

    on = int(torch.device(device).type == "cuda")
    errs, kinds = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        for bb, tt, dd in rglru_cases(b, t, d):
            key = f"{bb}x{tt}x{dd}/{str(dtype)[6:]}"
            a, u = inputs(tt + dd, dtype, bb, tt, dd)
            kind = rg_ops.variant(dtype, dd)
            before = read_launches()
            h, last = rg_ops.rglru(a, u)
            got = {k: n - before[k] for k, n in read_launches().items()
                   if k.startswith("rglru.")}
            want = {f"rglru.{v}": on * (v == kind)
                    for v in ("ring", "direct")}
            if got != want:
                raise AssertionError(f"rglru {key} launched {got}, expected "
                                     f"{want}")
            kinds[key] = kind
            ph, plast = rg_ref.rglru_reference(a, u)
            if dtype == torch.float32 and not (torch.equal(h, ph) and
                                               torch.equal(last, plast)):
                raise AssertionError(f"rglru {key}: float32 h or final h "
                                     f"not bit-equal to the plain scan")
            errs[f"h/{key}"] = require_close(h, ph, REC_TOL[dtype],
                                             f"rglru h {key}")
            errs[f"last/{key}"] = require_close(last, plast, STATE_TOL,
                                                f"rglru final h {key}")
            del a, u, h, last, ph, plast
    a, u = inputs(0, torch.float32, b, t, d)
    nbytes = 3 * a.numel() * 4 + b * d * 4      # a, u in; h, final h out
    result = dict(max_abs_err=errs[f"h/{b}x{t}x{d}/float32"], errs=errs,
                  variants=kinds, shape=(b, t, d), bytes=nbytes,
                  bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    if time_it:
        result["ms"] = cuda_ms(lambda: rg_ops.rglru(a, u), reps=10)
        result["plain_ms"] = cuda_ms(lambda: rg_ref.rglru_reference(a, u),
                                     reps=1)
        result["gb_per_s"] = nbytes / (result["ms"] * 1e-3) / 1e9
        a, u = a.bfloat16(), u.bfloat16()
        result["bf16_ms"] = cuda_ms(lambda: rg_ops.rglru(a, u), reps=10)
        result["bf16_bound_ms"] = (3 * a.numel() * 2 + b * d * 4) \
            / HBM_BYTES_PER_S * 1e3
    return result


# ---------------------------------------------------------------------------
# where the LM path's device time goes
# ---------------------------------------------------------------------------

KERNEL_GROUPS = (("flash_attention", ("flash_fwd_kernel",
                                      "flash_wgmma_kernel")),
                 ("decode_attention", DECODE_KERNELS),
                 ("wkv6", ("wkv6_kernel",)),
                 ("rglru", ("rglru_kernel", "rglru_ring_kernel")),
                 ("matmul", ("gemm", "gemv", "nvjet", "xmma", "cutlass")))


def device_profile(fn, steps: int, kernels=()) -> dict:
    """Device time by kernel group over ``steps`` calls of ``fn`` (a
    torch.profiler trace of the card), per call, and the number of device
    kernels per call; with ``kernels``, also the time of the kernels whose
    names hold each of them."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    groups = {g: 0.0 for g, _ in KERNEL_GROUPS}
    groups["other"] = 0.0
    named = {k: 0.0 for k in kernels}
    count = 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        count += e.count
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(k in e.key for k in keys)), "other")
        groups[group] += us / 1e3 / steps
        for k in named:
            named[k] += us / 1e3 / steps if k in e.key else 0.0
    out = dict(device_ms=sum(groups.values()), by_group_ms=groups,
               device_ops=count / steps)
    if kernels:
        out["by_kernel_ms"] = named
    return out


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

KERNELS = (
    # name, phase, source, replaces
    ("chain_vm.run_managed", "chain_kernel",
     "src/repro_torch/csrc/chain_vm.cu",
     "src/repro/kernels/chain_vm/kernel.py:66"),
    ("chain_vm.run_chains", "chain_straight",
     "src/repro_torch/csrc/chain_vm.cu",
     "src/repro/kernels/chain_vm/kernel.py:30"),
    ("hopscotch.hopscotch_lookup", "hopscotch_probe",
     "src/repro_torch/csrc/hopscotch.cu",
     "src/repro/kernels/hopscotch/kernel.py:31"),
    ("flash_attention.flash_attention", "flash_kernel",
     "src/repro_torch/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention/kernel.py:31"),
    ("decode_attention.decode_partial", "decode_kernel",
     "src/repro_torch/csrc/decode_attention.cu",
     "src/repro/kernels/decode_attention/kernel.py:24"),
    ("rwkv6.wkv6", "wkv6_kernel", "src/repro_torch/csrc/wkv6.cu",
     "src/repro/kernels/rwkv6/kernel.py:61"),
    ("rglru.rglru", "rglru_kernel", "src/repro_torch/csrc/rglru.cu",
     "src/repro/kernels/rglru/kernel.py:32"),
)
LM_ARCH = "qwen3-1.7b"
# each drive's flash launches per prefill: (kernel, one per attention layer)
FLASH_DRIVE_LAUNCHES = {"lm_prefill": ("wgmma", 28),
                        "lm_griffin": ("wgmma", 12),
                        "lm_float32": ("fma", 28)}
RECURRENT_ARCHS = (("lm_rwkv", "rwkv6-7b"), ("lm_griffin", "recurrentgemma-9b"))


def run_phase(phases, key, fn):
    t0 = time.perf_counter()
    phases[key] = fn()
    shown = {k: v for k, v in phases[key].items() if k != "rows"}
    print(f"[{key}] {time.perf_counter() - t0:.1f} s: {shown}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this test runs on the "
                         "card only")
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False    # plain float32 is exact
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"[card] {name} | nvidia-smi: {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"[card] kernels built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for src, log in logs.items():
        print(f"[build {src}] " + " | ".join(
            line.strip() for line in log.splitlines() if "registers" in line
            or "spill" in line or "arning" in line), flush=True)
    hgmma = sum("HGMMA" in line
                for line in _build.sass("flash_attention").splitlines())
    print(f"[card] flash_attention: {hgmma} HGMMA instructions in its SASS",
          flush=True)
    if hgmma == 0:
        raise AssertionError("the flash library holds no HGMMA instruction:"
                             " its bf16 kernel is not on the tensor cores")

    phases = {}
    t0 = time.perf_counter()
    kv_res, kv, dk, dv = phase_kv_get(device)
    print(f"[kv_get] {time.perf_counter() - t0:.1f} s: {kv_res}", flush=True)
    run_phase(phases, "chain_kernel", lambda: phase_chain_kernel(device))
    run_phase(phases, "chain_straight", lambda: phase_chain_straight(device))
    run_phase(phases, "hopscotch_probe",
              lambda: phase_hopscotch_probe(device, kv, dk, dv))
    del kv, dk, dv

    cfg = registry.get_config(LM_ARCH)
    t0 = time.perf_counter()
    params = model_lib.init_params(cfg, seed=0, device=device)
    sync(device)
    print(f"[lm] {LM_ARCH}: {sum(p.numel() for p in params.parameters())} "
          f"parameters ({cfg.dtype}) initialised in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    run_phase(phases, "lm_prefill",
              lambda: phase_lm_prefill(device, cfg, params))
    run_phase(phases, "lm_serve", lambda: phase_lm_serve(device, cfg, params))
    run_phase(phases, "lm_float32", lambda: phase_lm_float32(
        device, cfg, params, phases["lm_prefill"].pop("rows"), {}))
    del params
    torch.cuda.empty_cache()
    run_phase(phases, "flash_kernel", lambda: phase_flash_kernel(device))
    torch.cuda.empty_cache()
    run_phase(phases, "decode_kernel", lambda: phase_decode_kernel(device))
    torch.cuda.empty_cache()
    for key, arch in RECURRENT_ARCHS:
        cfg = registry.get_config(arch)
        t0 = time.perf_counter()
        params = model_lib.init_params(cfg, seed=0, device=device)
        sync(device)
        print(f"[{key}] {arch}: {sum(p.numel() for p in params.parameters())}"
              f" parameters ({cfg.dtype}) initialised in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        run_phase(phases, key, lambda: phase_lm_recurrent(device, cfg,
                                                          params))
        del params
        torch.cuda.empty_cache()
    run_phase(phases, "wkv6_kernel", lambda: phase_wkv6_kernel(device))
    torch.cuda.empty_cache()
    run_phase(phases, "rglru_kernel", lambda: phase_rglru_kernel(device))
    # the attention kernels' launches are those of the LM path's drives;
    # the flash launches by kernel: bf16 prefills on the tensor cores, the
    # float32 drive on the CUDA cores
    phases["flash_kernel"]["launches"] = phases["lm_prefill"][
        "flash_launches"]
    variants = dict(
        lm_prefill=phases["lm_prefill"]["flash_variant_launches"],
        lm_griffin=phases["lm_griffin"]["prefill"][
            "flash_variant_launches"],
        lm_float32=phases["lm_float32"]["flash_variant_launches"])
    for drive, (kind, n) in FLASH_DRIVE_LAUNCHES.items():
        want = {f"flash_attention.{v}": n if v == kind else 0
                for v in ("wgmma", "fma")}
        if variants[drive] != want:
            raise AssertionError(f"{drive}: flash launches {variants[drive]}"
                                 f", expected {want}")
    phases["flash_kernel"]["variant_launches"] = variants
    print(f"[flash_kernel] launches by kernel: {variants}", flush=True)
    phases["decode_kernel"]["launches"] = phases["lm_serve"][
        "decode_launches"]
    phases["decode_kernel"]["kernel_launches"] = phases["lm_serve"][
        "decode_kernel_launches"]
    print(f"[decode_kernel] launches by kernel over the lm_serve ticks: "
          f"{phases['decode_kernel']['kernel_launches']}; decode-kernel "
          f"device ms per decode step: qwen3-1.7b "
          f"{phases['lm_prefill']['decode_kernel_ms_per_step']}, "
          f"recurrentgemma-9b "
          f"{phases['lm_griffin']['prefill']['decode_kernel_ms_per_step']}",
          flush=True)
    # the recurrences' launches are those of their paths' prefill drives;
    # the RG-LRU launches by kernel, which lm_drive has gated
    phases["wkv6_kernel"]["launches"] = phases["lm_rwkv"]["prefill"][
        "prefill_launches"]["wkv6"]
    phases["rglru_kernel"]["launches"] = phases["lm_griffin"]["prefill"][
        "prefill_launches"]["rglru"]
    rg_variants = dict(
        bf16=phases["lm_griffin"]["prefill"]["rglru_variant_launches"],
        float32=phases["lm_griffin"]["lm_float32"]["rglru_variant_launches"])
    phases["rglru_kernel"]["kernel_launches"] = rg_variants["bf16"]
    print(f"[rglru_kernel] launches by kernel per recurrentgemma-9b prefill:"
          f" {rg_variants}", flush=True)

    rows = []
    for kname, phase, source, replaces in KERNELS:
        r = phases[phase]
        if r["launches"] < 1:
            raise AssertionError(f"{kname}: no launch on its path")
        rows.append(dict(
            name=kname, route="cuda", source=source, replaces=replaces,
            launches=r["launches"], max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r.get("bound_by", "bytes"),
            library_ms=r.get("library_ms")))
        if "kernel_launches" in r:
            rows[-1]["kernel_launches"] = r["kernel_launches"]
        if "shapes" in r:
            rows[-1]["shapes"] = {n: {f: t.get(f) for f in (
                "shape", "ms", "plain_ms", "bound_ms", "library_ms")}
                for n, t in r["shapes"].items()}
        for t in r.get("shapes", {}).values() or (r,):
            print(f"[times] {kname} ({card}): {t['ms']:.4f} ms, bound "
                  f"{t['bound_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
                  f"library {t.get('library_ms')}, shape {t['shape']}",
                  flush=True)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
