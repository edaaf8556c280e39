"""Chip smoke test: drive the PyTorch/CUDA port's RedN GET path on one card.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``src/repro_torch/csrc``, then
runs five phases and raises on any mismatch:

1. ``card``            — the card's name and power limit, the kernel build.
2. ``kv_get``          — the main path at a real size: a 4-shard hopscotch
                         store (4 x 65,536 buckets, 157,286 keys, 60% load)
                         answers zipf GET batches through ``sharded_get`` on
                         the redn, one_sided and two_sided paths, each row
                         checked against the host oracle ``reference_get``.
3. ``chain_kernel``    — the recycled get server (65,536 buckets, 2^19-word
                         image) through ``ChainEngine(spec, "kernel")``
                         against the interpreter and the plain loop; again
                         at the throughput benchmark's size.
4. ``chain_straight``  — the straight-line chain kernel against its plain
                         version on 1,024 seeded random programs.
5. ``hopscotch_probe`` — the hopscotch kernel against the plain lookup on
                         every shard table, and against the redn answers.

Each kernel's launches are counted over the drive of its phase only (the
counts are zeroed just before and read just after); the comparison and
timing launches come after.  Every kernel is exact (int32), so its
tolerance is 0.  The last lines are the kernels' JSON, the card line from
``nvidia-smi`` and the result line.  Without a CUDA card, or outside a
checkout, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM memory bandwidth (data sheet)


def _import_port():
    """Import the port from this checkout's ``src`` (and nowhere else)."""
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch
    if Path(repro_torch.__file__).resolve().parents[1] != ROOT / "src":
        raise RuntimeError(f"repro_torch imported from {repro_torch.__file__}"
                           f", not from this checkout ({ROOT})")


_import_port()
from repro_torch.core import isa, machine, programs  # noqa: E402
from repro_torch.core.engine import ChainEngine  # noqa: E402
from repro_torch.data.pipeline import kv_request_stream  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.chain_vm import ops as chain_ops  # noqa: E402
from repro_torch.kernels.chain_vm import ref as chain_ref  # noqa: E402
from repro_torch.kernels.hopscotch import ops as hop_ops  # noqa: E402
from repro_torch.kvstore import hopscotch, store  # noqa: E402
from repro_torch.rdma import transport  # noqa: E402


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


def reset_launches():
    for counts in (chain_ops.launches, hop_ops.launches):
        for k in counts:
            counts[k] = 0


def read_launches() -> dict:
    return {**chain_ops.launches, **hop_ops.launches}


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
        kw = dict(wq_base=0, n_wrs=n_wrs, max_steps=max_steps)
        result["ms"] = cuda_ms(lambda: chain_ops.run_chains(mems, **kw))
        result["plain_ms"] = cuda_ms(
            lambda: chain_ref.run_chain_reference(mems, 0, n_wrs, max_steps),
            reps=2)
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
                  wrap_queries=[w for _, w in qs], shape=(n, n_queries),
                  bound_ms=probe_bytes(outs[0][0], probes, dv.shape[2])
                  / HBM_BYTES_PER_S * 1e3)
    if time_it:
        args = (dk[0], dv[0], q0, h)
        result["ms"] = cuda_ms(lambda: hop_ops.hopscotch_lookup(*args),
                               reps=20)
        result["plain_ms"] = cuda_ms(lambda: hopscotch.lookup(*args), reps=20)
    return result


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

KERNELS = (
    # name, phase, source, replaces
    ("chain_vm.run_managed", "chain_kernel", "src/repro_torch/csrc/chain_vm.cu",
     "src/repro/kernels/chain_vm/kernel.py:66"),
    ("chain_vm.run_chains", "chain_straight",
     "src/repro_torch/csrc/chain_vm.cu",
     "src/repro/kernels/chain_vm/kernel.py:30"),
    ("hopscotch.hopscotch_lookup", "hopscotch_probe",
     "src/repro_torch/csrc/hopscotch.cu",
     "src/repro/kernels/hopscotch/kernel.py:31"),
)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this test runs on the "
                         "card only")
    device = torch.device("cuda")
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
            or "spill" in line), flush=True)

    phases = {}
    t0 = time.perf_counter()
    kv_res, kv, dk, dv = phase_kv_get(device)
    print(f"[kv_get] {time.perf_counter() - t0:.1f} s: {kv_res}", flush=True)
    for key, fn in (("chain_kernel", lambda: phase_chain_kernel(device)),
                    ("chain_straight", lambda: phase_chain_straight(device)),
                    ("hopscotch_probe",
                     lambda: phase_hopscotch_probe(device, kv, dk, dv))):
        t0 = time.perf_counter()
        phases[key] = fn()
        print(f"[{key}] {time.perf_counter() - t0:.1f} s: {phases[key]}",
              flush=True)

    rows = []
    for kname, phase, source, replaces in KERNELS:
        r = phases[phase]
        if r["launches"] < 1:
            raise AssertionError(f"{kname}: no launch on its path")
        rows.append(dict(
            name=kname, route="cuda", source=source, replaces=replaces,
            launches=r["launches"], max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by="bytes",
            library_ms=None))
        print(f"[times] {kname} ({card}): {r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"shape {r['shape']}", flush=True)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
