"""The GET path and the interpreter kernel of several checkouts, timed in
turns on one card.

Each argument is the root of a checkout (its own ``chip_smoke.py`` and
``src/``); each turn is a process of its own that builds that checkout's
interpreter and chain kernels and runs its ``chip_smoke.phase_kv_get``
(the 4-shard, 65,536-bucket store: gets/s per path) and ``guest_drive``
(4,096 ADDLEQ guests: the interpreter's time around the engine's call,
``interp_ms``), times the stages of one redn batch by this script's own
code (the same for every checkout: a checkout with
``machine.deliver_shared`` runs the split batch, an earlier one its full
copies), and ``chain_interp_kernel`` alone by device time from a trace
on that batch and on the 4,096 guests.  Then the write path, whose
chains run on the same kernel with full images: its
``chip_smoke.phase_kv_write`` (SET, DELETE and sweep ms) and
``phase_kv_resize`` (ms a quantum), and a (4, 32) SET batch of updates
and inserts timed by CUDA events and from a trace (all its kernels, and
``chain_interp_kernel`` alone).  Each turn prints one ``AB`` line of
JSON.  Give the checkouts in turns, e.g. an earlier commit unpacked with
``git archive`` into ``build/parent`` against this one:

    python3 tools/get_path_ab.py build/parent . . build/parent

Run from the root of a checkout on a machine with an NVIDIA H100; every
number is the card's, by CUDA events.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

TURN = """
import dataclasses, json, sys
import numpy as np
root = {root!r}
sys.path[:0] = [root, root + "/src"]
import torch
import chip_smoke as cs
from repro_torch.core import machine, programs, turing
from repro_torch.core.engine import ChainEngine
from repro_torch.kvstore import hopscotch, store
from repro_torch.rdma import transport
cs._build.build(("chain_interp", "chain_vm", "hopscotch"))
dev = torch.device("cuda")
kv_get, kv, dk, dv = cs.phase_kv_get(dev)
guests = cs.guest_drive(dev, 4096, 100, 20261017, False)


def stages(q):
    # the last of three passes of one redn batch, each stage by CUDA
    # events, each pass's tensors freed before the next; a checkout
    # with split batches runs them, an earlier one its full copies
    s, n = dk.shape[0], dk.shape[1]
    srv = programs.build_hopscotch_server(n, dv.shape[2], 8, device=dev)
    split = hasattr(machine, "deliver_shared")
    for _ in range(3):
        out = dict(split=split)

        def timed(name, fn):
            value, out[name + "_ms"] = cs.timed_call(dev, fn)
            return value

        state = timed("device_state", lambda: srv.device_state(dk, dv))
        dest = store.shard_of(q, s)
        pay = srv.device_payloads(q, hopscotch.bucket_of(q, n))
        recv, pos, ok = timed("dispatch", lambda: transport.dispatch(
            pay, dest, s, q.shape[1]))
        flat = recv.reshape(s, -1, recv.shape[-1])
        if split:
            batch = timed("deliver", lambda: machine.deliver_shared(
                state, srv.recv_wq, flat, srv.shared_window))
            batch.state.steps.zero_()
            ran = timed("run", lambda: machine.run_batch_shared_in_place(
                srv.spec, batch, 256))
            resp = timed("response", lambda: machine.words(
                ran, srv.resp_region, srv.resp_words))
        else:
            batch = timed("deliver", lambda: srv.engine.deliver_many(
                state, srv.recv_wq, flat))
            batch.steps.zero_()
            ran = timed("run", lambda: machine.run_batch_in_place(
                srv.spec, batch, 256))
            resp = timed("response", lambda: ran.mem[
                :, srv.resp_region:srv.resp_region + srv.resp_words])
        timed("combine", lambda: transport.combine(
            resp.reshape(s, s, q.shape[1], -1), dest, pos, ok))
        del recv, pos, ok, batch, ran, resp
        torch.cuda.synchronize()
    # the interpreter kernel alone on this batch, by trace
    if split:
        run = lambda: machine.run_batch_shared_in_place(  # noqa: E731
            srv.spec, machine.deliver_shared(state, srv.recv_wq, flat,
                                             srv.shared_window), 256)
    else:
        run = lambda: machine.run_batch_in_place(  # noqa: E731
            srv.spec, srv.engine.deliver_many(state, srv.recv_wq, flat), 256)
    out["kernel_ms"] = kernel_ms(run)
    return out


def kernel_ms(fn):
    prof = cs.device_time(fn, 3, ("chain_interp_kernel",))
    return (prof["by_kernel_ms"]["chain_interp_kernel"]
            if prof["timed_by"] == "trace" else None)


def guests_kernel_ms():
    interp = turing.build_interpreter(device=dev)
    host = dataclasses.replace(interp, state0=machine.VMState(
        *(a.cpu() for a in interp.state0)))
    states = [host.load(g) for g in cs.addleq_guests(interp, 4096, 20261017)]
    batch = machine.VMState(*(torch.stack(f).to(dev) for f in zip(*states)))
    return kernel_ms(lambda: ChainEngine(interp.spec).run_batch(
        batch, interp.lap_words * 102))


def write_path():
    # the write phases, then one SET batch of 16 updates and 16 inserts a
    # shard (no displacement) by events and by trace; sharded_set leaves
    # dk and dv as they were
    w = cs.phase_kv_write(dev, kv, dk, dv)
    r = cs.phase_kv_resize(dev, kv, dk, dv)
    rng = np.random.RandomState(7)
    loaded = np.concatenate([t.keys[t.keys != 0] for t in kv.tables])
    fresh = int(loaded.max()) + 1000
    sk = np.concatenate([
        rng.choice(loaded, 64, replace=False).reshape(4, 16),
        (fresh + np.arange(64)).reshape(4, 16)], axis=1).astype(np.int32)
    keys = torch.from_numpy(sk).to(dev)
    vals = torch.from_numpy(cs.new_values(sk, dv.shape[2])).to(dev)

    def set_batch():
        return store.sharded_set(dk, dv, keys, vals, device=dev)

    set_batch()
    _, set_ms = cs.timed_call(dev, set_batch)
    prof = cs.device_time(set_batch, 2, ("chain_interp_kernel",))
    return dict(set_ms=w["set_ms"], delete_ms=w["delete_ms"],
                sweep_ms=w["sweep_ms"], quantum_ms=r["quantum_ms"],
                set32_ms=set_ms, set32_timed_by=prof["timed_by"],
                set32_device_ms=prof["device_ms"],
                set32_kernel_ms=prof["by_kernel_ms"]["chain_interp_kernel"])


q = torch.from_numpy(cs.kv_batches(4, 157286, 64, 1)[0]).to(dev)
keep = ("gets_per_s", "get_latency_ms", "peak_bytes", "max_memory_allocated")
print("AB " + json.dumps(dict(
    root=root, card=cs.card_line(),
    kv_get={{k: kv_get[k] for k in keep if k in kv_get}},
    redn_stages=stages(q), guests_interp_ms=guests["interp_ms"],
    guests_kernel_ms=guests_kernel_ms(), write=write_path())),
    flush=True)
"""


def main(roots) -> int:
    if not roots:
        raise SystemExit(__doc__)
    for root in roots:
        path = Path(root).resolve()
        if not (path / "chip_smoke.py").is_file():
            raise SystemExit(f"{root}: no chip_smoke.py")
        out = subprocess.run([sys.executable, "-c", TURN.format(
            root=str(path))], capture_output=True, text=True)
        lines = [x for x in out.stdout.splitlines() if x.startswith("AB ")]
        if out.returncode != 0 or not lines:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"{root}: turn failed ({out.returncode})")
        print(lines[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
