"""The store's write stages, which walk their windows through the plain
version of ``chain_walk_kernel`` on the CPU, against the JAX package's at
S = 1 on the same numpy inputs: SET with displacement and with fault rows,
DELETE, TTL SET, the CLOCK sweeper, two resize quanta (also with a lap
killed) and the resize window's SET, every result field and carry array
bit-equal, fsck's reports equal; and each against the rows route (the
earlier ``_walk`` over ``run_rows``) in every walked stage's responses,
steps and carry.  The tables and keys are ``tests/_walk_corpus.py``'s."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from _walk_corpus import H, MAX_MOVES, MAX_SEARCH, N, NOW, _t, _table
from repro.core import faults as jfaults
from repro.kvstore import fsck as jfsck
from repro.kvstore import store as jstore
from repro_torch.core import faults, programs as tp
from repro_torch.kvstore import fsck as tfsck
from repro_torch.kvstore import store as tstore
from repro_torch.rdma import transport


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh1():
    return Mesh(np.array(jax.devices()[:1]), ("kv",))


def _equal(got, want, what):
    got = [getattr(got, f) for f in got._fields] if hasattr(got, "_fields") \
        else list(got)
    want = [getattr(want, f) for f in want._fields] if hasattr(
        want, "_fields") else list(want)
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        if isinstance(g, tuple):
            _equal(g, w, f"{what}[{i}]")
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                          err_msg=f"{what}[{i}]")


def _store(seed: int, n: int = N, load: float = 0.8):
    rng = np.random.RandomState(seed)
    t = _table(n, load, rng)
    while (t.keys > (1 << 24) - 1).any():
        t = _table(n, load, rng)
    return rng, t


def _set_rows(rng, t, count=16):
    res = t.keys[t.keys != 0]
    sk = np.concatenate([rng.choice(res, count // 4),
                         rng.randint(1 << 21, 1 << 22, count - count // 4)])
    sk[3] = 0
    sk[-1] = sk[5]
    sv = np.stack([sk % 61, sk % 53], -1)
    return sk.astype(np.int32)[None], sv.astype(np.int32)[None]


def _stage_set(seed, with_faults=False):
    rng, t = _store(seed)
    sk, sv = _set_rows(rng, t)
    kw = dict(neighborhood=H, max_search=MAX_SEARCH, max_moves=MAX_MOVES)
    jkw, tkw = dict(kw), dict(kw)
    if with_faults:
        rows = faults.storm(sk.size, p_fault=0.5, max_step=40, seed=seed,
                            device="cpu").as_rows().numpy().reshape(
                                sk.shape + (-1,))
        jkw["faults"] = jfaults.FaultPlan.from_row(jnp.asarray(rows))
        tkw["faults"] = faults.FaultPlan.from_row(_t(rows))
    return (lambda: tstore.sharded_set(
                _t(t.keys)[None], _t(t.values)[None], _t(sk), _t(sv),
                device="cpu", **tkw),
            lambda mesh1: jstore.sharded_set(
                mesh1, "kv", jnp.asarray(t.keys)[None],
                jnp.asarray(t.values)[None], jnp.asarray(sk),
                jnp.asarray(sv), **jkw))


def _stage_delete(seed):
    rng, t = _store(seed)
    res = t.keys[t.keys != 0]
    dk = np.concatenate([rng.choice(res, 8), rng.randint(1 << 21, 1 << 22,
                                                         4), [0]])
    dk = dk.astype(np.int32)[None]
    return (lambda: tstore.sharded_delete(
                _t(t.keys)[None], _t(t.values)[None], _t(dk), neighborhood=H,
                device="cpu"),
            lambda mesh1: jstore.sharded_delete(
                mesh1, "kv", jnp.asarray(t.keys)[None],
                jnp.asarray(t.values)[None], jnp.asarray(dk),
                neighborhood=H))


def _stage_ttl_set(seed):
    rng, t = _store(seed)
    sk, sv = _set_rows(rng, t, 12)
    exp = np.where(t.keys != 0, rng.randint(0, 2000, N),
                   tp.NO_TTL).astype(np.int32)[None]
    dl = rng.randint(500, 1500, sk.shape).astype(np.int32)
    kw = dict(neighborhood=H, max_search=MAX_SEARCH, max_moves=MAX_MOVES)
    return (lambda: tstore.sharded_set(
                _t(t.keys)[None], _t(t.values)[None], _t(sk), _t(sv),
                exp=_t(exp), deadlines=_t(dl), device="cpu", **kw),
            lambda mesh1: jstore.sharded_set(
                mesh1, "kv", jnp.asarray(t.keys)[None],
                jnp.asarray(t.values)[None], jnp.asarray(sk),
                jnp.asarray(sv), exp=jnp.asarray(exp),
                deadlines=jnp.asarray(dl), **kw))


def _stage_sweep(seed):
    rng, t = _store(seed)
    exp = np.where(t.keys != 0, rng.randint(0, 2 * NOW, N),
                   tp.NO_TTL).astype(np.int32)[None]
    hand = np.array([N - 6], np.int32)
    return (lambda: tstore.sharded_sweep(
                _t(t.keys)[None], _t(t.values)[None], _t(exp), _t(hand),
                NOW, 16, device="cpu"),
            lambda mesh1: jstore.sharded_sweep(
                mesh1, "kv", jnp.asarray(t.keys)[None],
                jnp.asarray(t.values)[None], jnp.asarray(exp),
                jnp.asarray(hand), NOW, 16))


def _resize_store(seed):
    rng, t = _store(seed, load=0.9)
    return rng, t, (lambda: tstore.begin_resize(
        _t(t.keys)[None], _t(t.values)[None], device="cpu")), (
        lambda: jstore.begin_resize(jnp.asarray(t.keys)[None],
                                    jnp.asarray(t.values)[None]))


def _stage_resize(seed, with_faults=False):
    """Two quanta, the second from each side's own first."""
    rng, t, trs, jrs = _resize_store(seed)
    kw = dict(step=12, neighborhood=H, max_search=MAX_SEARCH,
              max_moves=MAX_MOVES)
    jkw, tkw = dict(kw), dict(kw)
    if with_faults:
        live = np.flatnonzero(t.keys[:12] != 0)
        lap, kill = int(live[2]), 30
        rows = faults.FaultPlan.kill_lap(12, lap, kill,
                                         device="cpu").as_rows()[None]
        jkw["faults"] = jfaults.FaultPlan.from_row(jnp.asarray(rows.numpy()))
        tkw["faults"] = faults.FaultPlan.from_row(rows)
    kw2 = dict(kw, step=8)

    def port():
        first = tstore.sharded_resize(trs(), device="cpu", **tkw)
        return first, tstore.sharded_resize(first[0], device="cpu", **kw2)

    def jax_(mesh1):
        first = jstore.sharded_resize(mesh1, "kv", jrs(), **jkw)
        return first, jstore.sharded_resize(mesh1, "kv", first[0], **kw2)

    return port, jax_


def _stage_resize_set(seed):
    """A quantum, then a SET through both frames."""
    rng, t, trs, jrs = _resize_store(seed)
    sk, sv = _set_rows(rng, t, 16)
    sk[0, :3] = t.keys[t.keys != 0][:3]
    kw = dict(neighborhood=H, max_search=MAX_SEARCH, max_moves=MAX_MOVES)

    def port():
        rs, _ = tstore.sharded_resize(trs(), step=12, neighborhood=H,
                                      device="cpu")
        return tstore.sharded_set(rs, _t(sk), _t(sv), device="cpu", **kw)

    def jax_(mesh1):
        rs, _ = jstore.sharded_resize(mesh1, "kv", jrs(), step=12,
                                      neighborhood=H)
        return jstore.sharded_set(mesh1, "kv", rs, jnp.asarray(sk),
                                  jnp.asarray(sv), **kw)

    return port, jax_


# each stage: (the port's run, JAX's run on a mesh)
STAGES = {
    "set": lambda: _stage_set(1),
    "set_faults": lambda: _stage_set(2, with_faults=True),
    "delete": lambda: _stage_delete(3),
    "ttl_set": lambda: _stage_ttl_set(4),
    "sweep": lambda: _stage_sweep(5),
    "resize_quanta": lambda: _stage_resize(6),
    "resize_quanta_killed": lambda: _stage_resize(7, with_faults=True),
    "resize_window_set": lambda: _stage_resize_set(8),
}


def _fsck_inputs(stage, result, jax_side):
    """The arrays a stage's result leaves, as ``check_invariants``'s
    keyword arguments."""
    if stage.startswith("resize_quanta"):
        return dict(resize=result[1][0])
    if stage == "resize_window_set":
        return dict(resize=result[1])
    kw = dict(keys=result[1], vals=result[2])
    if len(result) == 4:
        kw["exp"] = result[3]
    if jax_side:
        kw = {k: jnp.asarray(v) if k != "resize" else v
              for k, v in kw.items()}
    return kw


def _traced(port):
    """The port's run with the transport's trace on, and its walked
    stages' records."""
    transport.trace = []
    try:
        got = port()
        return got, [r for r in transport.trace if "out" in r]
    finally:
        transport.trace = None


@pytest.mark.parametrize("stage", sorted(STAGES))
def test_store_stage_equals_jax(mesh1, stage, monkeypatch):
    """The stage through the plain walk equals JAX's in every result
    field and carry array, and fsck's reports of both equal; again on the
    rows route (``transport.rows_stage``, the earlier ``_walk``), every
    walked stage's responses, steps and carry and the whole result equal
    the walk's."""
    port, jax_ = STAGES[stage]()
    want = jax_(mesh1)
    got, walked = _traced(port)
    _equal(got, want, stage)
    assert walked and all("args" in r for r in walked), "no stage walked"
    jrep = jfsck.check_invariants(neighborhood=H,
                                  **_fsck_inputs(stage, want, True))
    trep = tfsck.check_invariants(neighborhood=H,
                                  **_fsck_inputs(stage, got, False))
    assert trep == jrep and repr(trep) == repr(jrep)
    monkeypatch.setattr(transport, "walk_stage", transport.rows_stage)
    rows_got, rows_walked = _traced(port)
    _equal(got, rows_got, f"{stage} on the rows route")
    assert [r["stage"] for r in walked] == [r["stage"] for r in rows_walked]
    for a, b in zip(walked, rows_walked):
        _equal(a["out"], b["out"], f"{stage} {a['stage']} vs _walk")
