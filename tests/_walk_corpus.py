"""Tables, windows and programs of the walk's tests at small
sizes (``tests/test_torch_walk.py``, ``tests/test_torch_walk_store.py``
and the card tests in ``tests/test_torch_gpu.py``): numpy and the port,
no JAX."""
import numpy as np
import torch

from repro_torch.core import programs as tp
from repro_torch.kvstore import hopscotch as th

N, V, H = 64, 2, 4
MAX_SEARCH, MAX_MOVES = 8, 4
NOW = 1000
LOADS = (0.5, 0.9, 1.0)
PROGRAMS = ("writer", "displacer", "deleter", "sweeper", "migrator")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _build(name: str, n: int = N, device="cpu"):
    d = dict(device=device)
    return {
        "writer": lambda: tp.build_hopscotch_writer(n, V, H, **d),
        "displacer": lambda: tp.build_hopscotch_displacer(
            n, V, H, MAX_SEARCH, MAX_MOVES, **d),
        "deleter": lambda: tp.build_hopscotch_deleter(n, V, H, **d),
        "sweeper": lambda: tp.build_clock_sweeper(n, V, **d),
        "migrator": lambda: tp.build_hopscotch_migrator(n, V, H, **d),
    }[name]()


def _table(n: int, load: float, rng) -> th.HopscotchTable:
    """A table filled by the bounded host SET to ``load``; past what it
    places, the empty buckets take random keys (load 1.0)."""
    t = th.make_table(n, V, neighborhood=H)
    want = int(round(load * n))
    for k in rng.permutation(np.arange(1, 1 << 20))[:4 * n].tolist():
        if int((t.keys != 0).sum()) >= want:
            break
        t.set_full(k, [k % 97, k % 89])
    empty = np.flatnonzero(t.keys == 0)[:want - int((t.keys != 0).sum())]
    t.keys[empty] = rng.randint(1 << 20, 1 << 21, len(empty))
    t.values[empty] = rng.randint(1, 100, (len(empty), V))
    return t


def _keys(t, rng, g: int):
    """Request keys: residents (hits), fresh keys and fresh keys homed
    where a resident lives (neighborhoods at their fullest)."""
    res = t.keys[t.keys != 0]
    hits = rng.choice(res, g // 3) if len(res) else np.zeros(0, np.int32)
    fresh = rng.randint(1 << 21, 1 << 22, g // 3)
    homes = th.bucket_of(res, t.n_buckets) if len(res) else np.zeros(1)
    crowded = [k for k in range(1 << 22, (1 << 22) + 64 * t.n_buckets)
               if th.bucket_of(k, t.n_buckets) in homes][:g - 2 * (g // 3)]
    return np.concatenate([hits, fresh, crowded]).astype(np.int32)


def _corpus(name: str, load: float, seed: int, g: int = 48):
    """``(prog, carry (G, ...), payloads (G, W))``: G contexts against one
    table, none with key 0 (the walk runs no key-0 row)."""
    rng = np.random.RandomState(seed)
    prog = _build(name)
    t = _table(N, load, rng)
    keys, vals = _t(t.keys), _t(t.values)
    if name in ("writer", "displacer", "deleter"):
        q = _keys(t, rng, g)
        home = _t(th.bucket_of(q, N).astype(np.int32))
        if name == "deleter":
            pay = prog.device_payloads(_t(q), home)
        else:
            pay = prog.device_payloads(_t(q), home,
                                       _t(rng.randint(1, 99, (g, V))))
        carry = (keys, vals)
    elif name == "sweeper":
        exp = rng.randint(NOW - 500, NOW + 500, N).astype(np.int32)
        exp[t.keys == 0] = tp.NO_TTL
        pay = prog.device_payloads(_t(rng.randint(0, N, g).astype(np.int32)),
                                   NOW)
        carry = (keys, vals, _t(exp))
    else:
        # the new frame half filled by migrating a prefix of the old one;
        # the rest of the old frame's laps, some homed at the frame's end
        # so that their claim wraps into a mirror row
        new = th.make_table(2 * N, V, neighborhood=H)
        for b in range(N // 2):
            t.migrate_bucket(new, b)
        end = [k for k in range(1, 1 << 16)
               if th.bucket_of(k, 2 * N) >= 2 * N - 2][:4]
        for j, k in enumerate(end):
            t.keys[N - 1 - j], t.values[N - 1 - j] = k, [k % 7, k % 5]
            new.keys[2 * N - 1 - (j % 2)] = k + (1 << 20)
        new.keys[:2], new.values[:2] = 0, 0
        keys, vals = _t(t.keys), _t(t.values)
        src = np.flatnonzero(t.keys[N // 2:] != 0) + N // 2
        src = rng.choice(src, g)
        src[:len(end)] = N - 1 - np.arange(len(end))
        pay = prog.device_payloads(_t(src.astype(np.int32)), keys)
        carry = (keys, vals, _t(new.keys), _t(new.values))
    carry = tuple(c[None].expand((g,) + tuple(c.shape)).contiguous()
                  for c in carry)
    live = pay[:, 0] != 0
    return prog, tuple(c[live] for c in carry), pay[live]


def _window(name: str, s: int, positions: int, seed: int):
    """S owners' windows of ``positions`` rows (key-0 rows among them)
    and their carry."""
    rng = np.random.RandomState(seed)
    progs, carries, rows = None, [], []
    for o in range(s):
        prog, carry, pay = _corpus(name, LOADS[o % 3], seed + o,
                                   g=positions)
        progs = prog
        carries.append(tuple(c[0] for c in carry))
        pay = pay[:positions]
        pad = positions - pay.shape[0]
        pay = torch.cat([pay, pay.new_zeros((pad, pay.shape[1]))])
        pay[rng.rand(positions) < 0.15] = 0
        rows.append(pay)
    carry = tuple(torch.stack(c) for c in zip(*carries))
    return progs, carry, torch.stack(rows).contiguous()
