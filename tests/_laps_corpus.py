"""Groups, tables and lap windows of the racing lanes' lap walk at small
sizes (``tests/test_torch_laps.py`` and the card tests in
``tests/test_torch_gpu.py``): numpy and the port, no JAX."""
import numpy as np

from _walk_corpus import H, N, NOW, V, _keys, _t, _table
from repro_torch.core import machine, programs as tp
from repro_torch.kvstore import hopscotch as th
from repro_torch.kvstore import store as tstore

LOADS = (0.5, 0.75, 1.0)
# lane kinds by name: the store's all-SET groups and the write mix
KINDS = {"set2": ("set", "set"), "set4": ("set",) * 4,
         "mix3": ("set", "delete", "sweep"),
         "mix4": ("set", "sweep", "delete", "set")}
# a row's words: a SET row's; DELETE and SWEEP rows are zero-padded
WIDTH = 1 + V + H
# window cases: key-0 rows and all-key-0 laps among live ones; every SET
# lane's keys homed at one bucket (the hot-key hammer); one key sent by
# two lanes of a lap; one owner with no live row at all; a window whose
# first lap has no live row (its commit still normalises the deadlines)
CASES = ("mixed", "hot", "dup", "idle", "late")


def group(kinds: str, device="cpu"):
    return tp.build_multi_writer_group(N, V, H, len(KINDS[kinds]),
                                       lane_kinds=KINDS[kinds],
                                       device=device)


def schedule(n_writers: int, cut=None, device="cpu"):
    """The store's round-robin (quantum 16, 8 rounds, then the drain
    round), or ``Schedule.cut(cut)``: writer 0 runs ``cut`` steps, writer
    1 drains against the half-done state, then everyone drains."""
    if cut is None:
        return machine.Schedule.round_robin(n_writers, quantum=16,
                                            n_rounds=8, device=device)
    return machine.Schedule.cut(cut, n_writers, device=device)


def exp_column(t, rng, normalized: bool = True) -> np.ndarray:
    """Deadlines around ``NOW`` for the residents; the empty buckets'
    ``NO_TTL`` (the store's invariant), or random when not
    ``normalized``."""
    exp = rng.randint(NOW - 500, NOW + 500, N).astype(np.int32)
    if normalized:
        exp[t.keys == 0] = tp.NO_TTL
    return exp


def lane_rows(mw, kinds: str, keys: np.ndarray, rng) -> np.ndarray:
    """Rows (B, n_writers, WIDTH) int32 for laps whose lane ``w`` sends
    ``keys[:, w]``: a SET row with a random value, a DELETE row, or for a
    SWEEP lane the row of bucket ``key % N``; a key of 0 makes the row
    all zeros."""
    b, n = keys.shape
    out = np.zeros((b, n, WIDTH), np.int32)
    for w, kind in enumerate(KINDS[kinds]):
        q = _t(keys[:, w].astype(np.int32))
        home = _t(th.bucket_of(keys[:, w], N).astype(np.int32))
        if kind == "set":
            pay = mw.device_payloads(q, home, _t(rng.randint(
                1, 99, (b, V)).astype(np.int32)))
        elif kind == "delete":
            pay = mw.device_delete_payloads(q, home)
        else:
            pay = mw.device_sweep_payloads(
                _t((keys[:, w] % N).astype(np.int32)), NOW)
        out[:, w, :pay.shape[1]] = pay.numpy()
        out[keys[:, w] == 0, w] = 0
    return out


def lap_keys(t, kinds: str, n_laps: int, case: str, rng) -> np.ndarray:
    """(n_laps, n_writers) keys for one owner's window of ``case``."""
    n = len(KINDS[kinds])
    sets = [w for w, k in enumerate(KINDS[kinds]) if k == "set"]
    pool = _keys(t, rng, 3 * n_laps * n)
    keys = rng.permutation(pool)[:n_laps * n].reshape(n_laps, n).astype(
        np.int64)
    keys[rng.rand(n_laps, n) < 0.2] = 0
    if case == "hot":
        hot = tstore.keys_homed_at(int(rng.randint(N)), n_laps * len(sets),
                                   N, start=int(rng.randint(1 << 20,
                                                            1 << 21)))
        keys[:, sets] = np.asarray(hot).reshape(n_laps, len(sets))
        return keys
    keys[1] = 0                          # an all-key-0 lap among live ones
    if case == "dup":
        other = sets[1] if len(sets) > 1 else (sets[0] + 1) % n
        keys[0, [sets[0], other]] = rng.randint(1 << 21, 1 << 22)
    elif case == "idle":
        keys[:] = 0
    elif case == "late":
        keys[0] = 0
    return keys


def window(kinds: str, s: int, n_laps: int, seed: int, case: str = "mixed",
           exp: bool = False, device="cpu"):
    """``(group, carry, rows (S, R, WIDTH))``: S owners' windows of R =
    ``n_laps`` x n_writers - 1 rows (the last lap zero-padded by the
    walk) and their carry, ``(keys, vals)`` or with ``exp`` ``(keys,
    vals, exp)``; ``exp`` "raw" leaves the empty buckets' deadlines
    random (not at ``NO_TTL``).  ``case`` "idle" leaves owner 0 with no
    live row and the others "mixed"."""
    rng = np.random.RandomState(seed)
    mw = group(kinds)
    n = mw.n_writers
    carries, rows = [], []
    for o in range(s):
        t = _table(N, LOADS[o % 3], rng)
        c = case if case != "idle" or o == 0 else "mixed"
        keys = lap_keys(t, kinds, n_laps, c, rng)
        rows.append(lane_rows(mw, kinds, keys, rng).reshape(n_laps * n,
                                                            WIDTH)[:-1])
        carries.append((t.keys, t.values) + ((exp_column(
            t, rng, normalized=exp != "raw"),) if exp else ()))
    carry = tuple(_t(np.stack(c)).to(device) for c in zip(*carries))
    rows = _t(np.stack(rows)).to(device)
    return group(kinds, device), carry, rows
