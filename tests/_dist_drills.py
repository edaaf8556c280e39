"""The process-group drills of ``test_torch_distributed_group.py``: one
gloo group of 8 ranks, each rank a process running this file.

    python tests/_dist_drills.py RANK WORLD STORE_FILE OUT_DIR
    python tests/_dist_drills.py one OUT_DIR     # the one-device arm

The store drills (``kv_multidevice_main.py``'s store and probes for the
gets; a denser store for a SET batch with displacement and a DELETE
batch) run with 8 ranks of 1 shard and with ranks 0-3 holding 2 shards
each, the latter also at a capacity that drops requests and mid-growth
(a get and a SET batch after one migration quantum); the gradient combine runs on all 8 ranks; gpipe on ranks 0-3
(``pipeline_main.py``'s inputs).  Each rank saves what it got to
``OUT_DIR/rank{RANK}.pt``.  The inputs are built by the functions below,
which the test imports to run the same batches on one device.
"""
import sys

import numpy as np
import torch

from repro_torch.kvstore import store

METHODS = ("redn", "one_sided", "two_sided")
LAYOUTS = {"8x1": 8, "4x2": 4}        # layout -> ranks (8 shards in all)
DROP_CAPACITY = 1
# the capacities each layout runs, and the layout that also runs the
# mid-growth drill
CAPACITIES = {"8x1": (None,), "4x2": (None, DROP_CAPACITY)}
RESIZE_LAYOUT = "4x2"
RESIZE_STEP = 24
ALIVE = ((1, 1, 1, 1, 1, 1, 1, 1), (1, 0, 1, 1, 0, 1, 1, 1),
         (0, 0, 0, 0, 0, 0, 0, 0), (0, 0, 0, 0, 0, 0, 0, 1))
PIPE = dict(S=4, M=6, B=2, D=16)


def get_store():
    """``kv_multidevice_main.py``'s store: 8 shards x 64 buckets, 120 keys,
    16 probes a shard, every 13th a miss."""
    kv = store.ShardedKV.build(n_shards=8, buckets_per_shard=64,
                               val_words=2)
    rng = np.random.RandomState(0)
    keys = rng.choice(np.arange(1, 1 << 16), size=120, replace=False)
    for k in keys:
        kv.set(int(k), [int(k) % 251, int(k) % 241])
    probe = rng.choice(keys, size=8 * 16).astype(np.int32)
    probe[::13] = 1 << 20
    return kv, probe.reshape(8, 16)


def write_store():
    """A store at 75% load (8 shards x 16 buckets), a SET batch of updates,
    inserts, displacements and overflows (one unused slot), and a DELETE
    batch of hits, misses and an unused slot."""
    kv = store.ShardedKV.build(8, 16, 2)
    rng = np.random.RandomState(0)
    loaded = []
    for k in rng.choice(np.arange(1, 1 << 16), size=400, replace=False):
        if len(loaded) == 96:
            break
        if kv.set(int(k), [int(k) % 251, int(k) % 241]):
            loaded.append(int(k))
    sk = rng.choice(np.arange(1 << 16, 1 << 20), size=48,
                    replace=False).reshape(8, 6).astype(np.int32)
    sk[:, 0] = loaded[:8]
    sk[1, 5] = 0
    sv = np.stack([sk, -sk], -1).astype(np.int32)
    dk = np.concatenate([np.array(loaded[8:24], np.int32).reshape(8, 2),
                         sk[:, 1:2], (1 << 21) + np.arange(8)[:, None]],
                        axis=1).astype(np.int32)
    dk[3, 3] = 0
    return kv, sk, sv, dk


def combine_grads(rank: int):
    """This rank's gradients: integer-valued, so every summation order
    gives the same float32 sum."""
    rng = np.random.RandomState(100 + rank)
    return {"w": torch.from_numpy(rng.randint(-64, 64, (3, 4)).astype(
                np.float32)),
            "b": torch.from_numpy(rng.randint(-64, 64, (5,)).astype(
                np.float32)).to(torch.bfloat16)}


def pipe_inputs():
    s, m, b, d = (PIPE[k] for k in "SMBD")
    rng = np.random.RandomState(0)
    w_all = (rng.randn(s, d, d) * 0.3).astype(np.float32)
    x = rng.randn(m, b, d).astype(np.float32)
    return w_all, x


def stage_fn(w, h):
    return torch.tanh(h @ w)


def result_fields(res) -> dict:
    return {f: getattr(res, f).clone() for f in res._fields}


def drill_keys(layout: str):
    """The drills a layout runs, by result key."""
    caps = CAPACITIES[layout]
    keys = [f"get/{m}/{c}" for m in METHODS for c in caps]
    keys += [f"{w}/{c}" for w in ("set", "delete") for c in caps]
    if layout == RESIZE_LAYOUT:
        keys += ["resize/get", "resize/set"]
    return keys


def store_drills(group, caps, resize: bool, rank: int = 0,
                 ranks: int = 1) -> dict:
    """The store drills on this rank's block of the 8 shards (all of them
    with ``group=None``: the one-device arm)."""
    out = {}
    kv, probe = get_store()
    per = 8 // ranks
    mine = slice(rank * per, (rank + 1) * per)
    k, v = kv.device_arrays("cpu", group=group)
    q = torch.from_numpy(probe[mine])
    for method in METHODS:
        for cap in caps:
            res = store.sharded_get(k, v, q, method=method, capacity=cap,
                                    device="cpu", group=group)
            out[f"get/{method}/{cap}"] = result_fields(res)
    if resize:
        out.update(resize_drill(k, v, q, group))
    kv, sk, sv, dk = write_store()
    k, v = kv.device_arrays("cpu", group=group)
    for cap in caps:
        res, nk, nv = store.sharded_set(
            k, v, torch.from_numpy(sk[mine]), torch.from_numpy(sv[mine]),
            capacity=cap, device="cpu", group=group)
        out[f"set/{cap}"] = dict(result_fields(res), keys=nk, vals=nv)
        res, nk, nv = store.sharded_delete(
            nk, nv, torch.from_numpy(dk[mine]), capacity=cap, device="cpu",
            group=group)
        out[f"delete/{cap}"] = dict(result_fields(res), keys=nk, vals=nv)
    return out


def resize_drill(k, v, q, group) -> dict:
    out = {}
    # mid-growth: one migration quantum (loopback, no exchange), then gets
    # and sets served from both frames, the owners' watermarks gathered
    rs, _ = store.sharded_resize(store.begin_resize(k, v, device="cpu"),
                                 step=RESIZE_STEP, device="cpu",
                                 group=group)
    res = store.sharded_get(rs, q, device="cpu", group=group)
    out["resize/get"] = result_fields(res)
    res, rs = store.sharded_set(rs, q, torch.stack([q, -q], -1),
                                device="cpu", group=group)
    out["resize/set"] = dict(result_fields(res), keys=rs.keys,
                             new_keys=rs.new_keys)
    return out


def one_device(out_dir: str) -> None:
    """Every drill on one device, all 8 shards in one tensor."""
    torch.set_num_threads(1)
    torch.save(store_drills(None, (None, DROP_CAPACITY), True),
               f"{out_dir}/one.pt")


def main(rank: int, world: int, store_file: str, out_dir: str) -> None:
    import torch.distributed as dist
    from repro_torch.distributed import fault, pipeline
    from repro_torch.rdma import transport
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_file, world),
                            rank=rank, world_size=world)
    g4 = dist.new_group(list(range(4)))
    out = {}
    for layout, group in (("8x1", dist.group.WORLD), ("4x2", g4)):
        if rank < LAYOUTS[layout]:
            out[layout] = store_drills(
                group, CAPACITIES[layout], layout == RESIZE_LAYOUT, rank,
                LAYOUTS[layout])
    # a backend that cannot carry the tensors raises, before any exchange
    errors = []
    for dev in ("cuda", "meta"):
        try:
            transport.check_group(dist.group.WORLD, dev)
        except RuntimeError as e:
            errors.append(str(e))
    out["refused"] = errors
    out["combine"] = []
    for alive in ALIVE:
        g, n_live = fault.masked_grad_combine(
            combine_grads(rank), torch.tensor(bool(alive[rank])),
            dist.group.WORLD)
        out["combine"].append(dict(g, n_live=n_live))
    if rank < 4:
        w_all, x = pipe_inputs()
        w = torch.from_numpy(w_all[rank]).requires_grad_(True)
        y = pipeline.gpipe(stage_fn, w, torch.from_numpy(x), group=g4,
                           n_stages=PIPE["S"])
        (y ** 2).sum().backward()
        out["gpipe"] = dict(y=y.detach(), grad=w.grad)
    torch.save(out, f"{out_dir}/rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1] == "one":
        one_device(sys.argv[2])
    else:
        main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
