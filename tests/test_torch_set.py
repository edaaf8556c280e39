"""Parity of the port's SET path with the JAX package: the writer and
displacer chain programs (word-identical images, equal states after a run,
equal statuses and arrays after ``run_one``/``set_many``), the host
oracles, ``sharded_set`` at S = 1 against JAX's on a 1-device mesh, and at
S = 4 against the host oracle applied per owner in window order.  The
cases mirror ``tests/test_set_offload.py`` and
``tests/test_displacement.py``.  All state is int32: tolerance 0."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from _parity import assert_states_equal, fresh_jax_programs
from repro.core import machine as jm
from repro.core import programs as jp
from repro.kvstore import hopscotch as jh
from repro.kvstore import store as jstore
from repro_torch import convert
from repro_torch.core import machine as tm
from repro_torch.core import programs as tp
from repro_torch.kvstore import hopscotch as th
from repro_torch.kvstore import store as tstore
from repro_torch.rdma import transport

NB, H, S, M, V = 64, 4, 8, 4, 2


_fresh_jax_programs = pytest.fixture(scope="module", autouse=True)(
    fresh_jax_programs)


def _homed(bucket, count, n_buckets=NB, start=1, n_shards=None):
    return tstore.keys_homed_at(bucket, count, n_buckets, start=start,
                                n_shards=n_shards)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# --- program images ----------------------------------------------------------

GEOMETRIES = {
    "writer_128_v2_h8": (lambda m, d: m.build_hopscotch_writer(
        128, 2, 8, **d)),
    "writer_64_v2_h4": (lambda m, d: m.build_hopscotch_writer(
        NB, V, H, **d)),
    "displacer_128_v2_h8": (lambda m, d: m.build_hopscotch_displacer(
        128, 2, 8, 16, 8, **d)),
    "displacer_64_v2_h4_wrap": (lambda m, d: m.build_hopscotch_displacer(
        NB, V, H, S, M, **d)),
}


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_program_image_equal(name):
    j = GEOMETRIES[name](jp, {})
    t = GEOMETRIES[name](tp, dict(device="cpu"))
    assert convert.spec_from_tuple(j.spec) == t.spec
    assert_states_equal(j.state0, t.state0)
    for f in ("n_buckets", "val_len", "neighborhood", "table_base",
              "values_base", "resp_region", "recv_wq", "resp_words",
              "fuel"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.prog.budget() == j.prog.budget()


def test_build_bounds_match():
    for m, d in ((jp, {}), (tp, dict(device="cpu"))):
        with pytest.raises(ValueError):
            m.build_hopscotch_writer(32, 8, 8, **d)
        m.build_hopscotch_writer(32, 7, 8, **d)
        with pytest.raises(ValueError, match="neighborhood"):
            m.build_hopscotch_displacer(NB, V, 1, S, M, **d)
        with pytest.raises(ValueError, match="max_search"):
            m.build_hopscotch_displacer(NB, V, H, NB + 1, M, **d)
        with pytest.raises(ValueError, match="max_moves"):
            m.build_hopscotch_displacer(NB, V, H, S, 0, **d)
        with pytest.raises(ValueError, match="request budget"):
            m.build_hopscotch_displacer(NB, 15, H, S, M, **d)


def test_status_codes_and_hash_equal():
    for name in ("SET_UPDATED", "SET_INSERTED", "SET_NEEDS_DISPLACEMENT",
                 "SET_DISPLACED", "SET_NEEDS_RESIZE", "NO_TTL"):
        assert getattr(tp, name) == getattr(jp, name) == getattr(th, name)
    ks = np.asarray([1, 2, 12345, 0xFFFFFF, 999983, -7], np.int32)
    for n in (7, 64, 128, 1000):
        np.testing.assert_array_equal(
            tp.bucket_home(_t(ks), n).numpy(),
            np.asarray(jp.bucket_home(jnp.asarray(ks), n)))


# --- one request / a serialized batch through both programs ------------------

def _run_both(jprog, tprog, keys, vals, payload, max_steps):
    """One request through each package's program: the raw final states
    must be equal, then ``run_one``'s commit."""
    jst = jm.deliver(jprog.device_state(jnp.asarray(keys), jnp.asarray(vals)),
                     jprog.recv_wq, jnp.asarray(payload))
    tst = tm.deliver(tprog.device_state(_t(keys), _t(vals)), tprog.recv_wq,
                     _t(payload))
    assert_states_equal(jst, tst)
    assert_states_equal(jprog.engine.run(jst, max_steps),
                        tprog.engine.run(tst, max_steps))
    want = jprog.run_one(jnp.asarray(keys), jnp.asarray(vals),
                         jnp.asarray(payload), max_steps)
    got = tprog.run_one(_t(keys), _t(vals), _t(payload), max_steps)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    return [g.numpy() for g in got]


@pytest.fixture(scope="module")
def writers():
    return (jp.build_hopscotch_writer(NB, 2, 8),
            tp.build_hopscotch_writer(NB, 2, 8, device="cpu"))


def _seeded_table():
    t = th.make_table(NB, 2, neighborhood=8)
    for k in range(1, 25):
        assert t.insert(k, [k, k * 2])
    return t


def _set_many_both(progs, table, reqs, vals):
    jw, tw = progs
    reqs = np.asarray(reqs, np.int32)
    vals = np.asarray(vals, np.int32)
    want = jw.set_many(jnp.asarray(table.keys), jnp.asarray(table.values),
                       jnp.asarray(reqs),
                       jh.bucket_of(jnp.asarray(reqs), table.n_buckets),
                       jnp.asarray(vals))
    got = tw.set_many(_t(table.keys), _t(table.values), _t(reqs),
                      th.bucket_of(_t(reqs), table.n_buckets), _t(vals))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    ref = th.HopscotchTable(table.keys.copy(), table.values.copy(),
                            table.neighborhood)
    np.testing.assert_array_equal(got[0].numpy(),
                                  th.insert_many(ref, reqs, vals))
    np.testing.assert_array_equal(got[1].numpy(), ref.keys)
    np.testing.assert_array_equal(got[2].numpy(), ref.values)
    return got[0].numpy()


def test_writer_set_many_updates_and_inserts(writers):
    reqs = [5, 70001, 5, 70002, 70001, 19]
    st = _set_many_both(writers, _seeded_table(), reqs,
                        np.stack([np.asarray(reqs) % 97,
                                  np.asarray(reqs) % 89], 1))
    assert st.tolist() == [1, 2, 1, 2, 1, 1]


def test_writer_needs_displacement_without_mutation(writers):
    t = th.make_table(NB, 2, neighborhood=8)
    cluster = _homed(7, 9)
    for k in cluster[:8]:
        assert t.insert(k, [k, k + 1])
    st = _set_many_both(writers, t, [cluster[8], cluster[3]],
                        [[1, 2], [77, 78]])
    assert st.tolist() == [tp.SET_NEEDS_DISPLACEMENT, tp.SET_UPDATED]


def test_writer_sequentializes_conflicting_inserts(writers):
    a, b = _homed(33, 2, start=100000)
    st = _set_many_both(writers, _seeded_table(), [a, b], [[1, 1], [2, 2]])
    assert st.tolist() == [tp.SET_INSERTED] * 2


def test_writer_run_one_states_equal(writers):
    jw, tw = writers
    t = _seeded_table()
    for key, val in ((5, [9, 9]), (70001, [1, 2]), (0, [0, 0])):
        pay = np.asarray(_np(tw.device_payloads(
            _t([key]), th.bucket_of(_t([key]), NB), _t([val])))[0])
        st, _, _ = _run_both(jw, tw, t.keys, t.values, pay, 512)
        if key == 0:
            assert int(st) == 0


# --- the displacer -----------------------------------------------------------

@pytest.fixture(scope="module")
def displacers():
    return (jp.build_hopscotch_displacer(NB, V, H, S, M),
            tp.build_hopscotch_displacer(NB, V, H, S, M, device="cpu"))


def _disp_case(displacers, table, key, value, want_status):
    jd, td = displacers
    row = np.zeros(V, np.int32)
    row[:len(value)] = value
    pay = td.device_payloads(_t([key]), th.bucket_of(_t([key]), NB),
                             _t([row]))[0].numpy()
    st, nk, nv = _run_both(jd, td, table.keys, table.values, pay, 4096)
    ref = th.HopscotchTable(table.keys.copy(), table.values.copy(), H)
    assert int(st) == ref.set_full(key, value, td.max_search,
                                   td.max_moves) == want_status
    np.testing.assert_array_equal(nk, ref.keys)
    np.testing.assert_array_equal(nv, ref.values)


def _staggered(home):
    t = th.make_table(NB, V, neighborhood=H)
    for d in range(H):
        k = _homed((home + d) % NB, 1, start=200 + 97 * d)[0]
        assert t.insert(k, [k % 7, k % 11])
    return t


def _ladder(home=10):
    t = th.make_table(NB, V, neighborhood=H)
    for pos in range(home, home + 6):
        k = _homed((pos - 2) % NB, 1, start=300 + 13 * pos)[0]
        t.keys[pos] = k
        t.values[pos] = [k % 7, k % 11]
    return t


def _stuck():
    t = th.make_table(NB, V, neighborhood=H)
    cluster = _homed(10, H + 1)
    for k in cluster[:H]:
        assert t.insert(k, [k % 7, k % 11])
    for d in range(H, H + 2):
        k = _homed((10 + d) % NB, 1, start=500 + d)[0]
        assert t.insert(k, [k % 7, k % 11])
    return t, cluster[H]


def _no_empty_in_window(home=20):
    t = th.make_table(NB, V, neighborhood=H)
    for pos in range(home, home + S):
        k = _homed(pos % NB, 1, start=400 + 17 * pos)[0]
        t.keys[pos % NB] = k
        t.values[pos % NB] = [k % 7, k % 11]
    return t


def test_displacer_one_move(displacers):
    _disp_case(displacers, _staggered(10), _homed(10, 1, start=50000)[0],
               [9, 9], tp.SET_DISPLACED)


def test_displacer_wraparound_window(displacers):
    _disp_case(displacers, _staggered(NB - 2),
               _homed(NB - 2, 1, start=60000)[0], [8, 8], tp.SET_DISPLACED)


def test_displacer_multi_move_ladder(displacers):
    _disp_case(displacers, _ladder(), _homed(10, 1, start=70000)[0],
               [3, 4], tp.SET_DISPLACED)


def test_displacer_update_and_plain_insert(displacers):
    t = _staggered(10)
    _disp_case(displacers, t, int(t.keys[11]), [1], tp.SET_UPDATED)
    t2 = th.make_table(NB, V, neighborhood=H)
    assert t2.insert(_homed(10, 1)[0], [5, 5])
    _disp_case(displacers, t2, _homed(10, 1, start=90000)[0], [6, 6],
               tp.SET_INSERTED)


def test_displacer_stuck_window_needs_resize(displacers):
    t, key = _stuck()
    _disp_case(displacers, t, key, [1, 2], tp.SET_NEEDS_RESIZE)


def test_displacer_search_window_honored(displacers):
    _disp_case(displacers, _no_empty_in_window(),
               _homed(20, 1, start=80000)[0], [2, 2], tp.SET_NEEDS_RESIZE)


def test_displacer_move_budget_honored():
    progs = (jp.build_hopscotch_displacer(NB, V, H, S, 1),
             tp.build_hopscotch_displacer(NB, V, H, S, 1, device="cpu"))
    _disp_case(progs, _ladder(), _homed(10, 1, start=70000)[0], [3, 4],
               tp.SET_NEEDS_RESIZE)


def test_displacer_zero_padded_request_is_inert(displacers):
    jd, td = displacers
    t = _staggered(10)
    st, nk, nv = _run_both(jd, td, t.keys, t.values,
                           np.zeros(V + 2, np.int32), 4096)
    assert int(st) == 0
    np.testing.assert_array_equal(nk, t.keys)
    np.testing.assert_array_equal(nv, t.values)


# --- host oracles ------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_insert_oracles_match_jax(seed):
    rng = np.random.RandomState(seed)
    tables = []
    for mod in (jh, th):
        t = mod.make_table(NB, V, neighborhood=H)
        k = 1 + int(np.random.RandomState(seed).randint(1 << 20))
        while (t.keys != 0).sum() < int(NB * 0.85):
            t.insert(int(k), [int(k) % 97, int(k) % 89], S, M)
            k += 7
        tables.append(t)
    live = tables[0].keys[tables[0].keys != 0]
    sk = np.concatenate([rng.choice(live, 4),
                         1 + rng.randint(0, 1 << 22, 6)]).astype(np.int32)
    sv = np.stack([sk % 251, sk % 241], 1).astype(np.int32)
    for fn, args in ((jh.insert_many, ()), (jh.insert_many_displaced,
                                            (S, M))):
        jt, tt = (mod.HopscotchTable(t.keys.copy(), t.values.copy(), H)
                  for mod, t in zip((jh, th), tables))
        want = fn(jt, sk, sv, *args)
        got = getattr(th, fn.__name__)(tt, sk, sv, *args)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tt.keys, jt.keys)
        np.testing.assert_array_equal(tt.values, jt.values)


# --- sharded_set at S = 1 against JAX's --------------------------------------

@pytest.fixture(scope="module")
def mesh1():
    return Mesh(np.array(jax.devices()[:1]), ("kv",))


def _sharded_set_both(mesh1, keys, vals, sk, sv, live=None, **kw):
    sk = np.asarray(sk, np.int32)[None]
    sv = np.asarray(sv, np.int32)[None]
    want = jstore.sharded_set(
        mesh1, "kv", jnp.asarray(keys)[None], jnp.asarray(vals)[None],
        jnp.asarray(sk), jnp.asarray(sv),
        live=None if live is None else jnp.asarray(live)[None], **kw)
    got = tstore.sharded_set(
        _t(keys)[None], _t(vals)[None], _t(sk), _t(sv),
        live=None if live is None else _t(live)[None], device="cpu", **kw)
    for field, g, w in zip(tstore.SetResult._fields, got[0], want[0]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=field)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    return got


def _kv_table(nb, items, h=8):
    t = th.make_table(nb, V, neighborhood=h)
    for k in items:
        assert t.set_full(int(k), [int(k) % 7, int(k) % 11]) in (1, 2, 4)
    return t


def test_sharded_set_escalates_displacement_bit_exact(mesh1):
    nb, home = 128, 40
    staggered = [_homed((home + d) % nb, 1, n_buckets=nb,
                        start=200 + 97 * d, n_shards=1)[0] for d in range(8)]
    t = _kv_table(nb, staggered)
    z = _homed(home, 1, n_buckets=nb, start=50000, n_shards=1)[0]
    sk = np.asarray([staggered[3], z, 77001, z], np.int32)
    sv = np.stack([sk % 61, sk % 53], axis=1)
    res, nk, nv = _sharded_set_both(mesh1, t.keys, t.values, sk, sv)
    ref = th.HopscotchTable(t.keys.copy(), t.values.copy(), 8)
    np.testing.assert_array_equal(res.status[0].numpy(),
                                  th.insert_many_displaced(ref, sk, sv))
    assert res.status[0].tolist() == [1, 4, 2, 1]
    np.testing.assert_array_equal(nk[0].numpy(), ref.keys)


def test_sharded_set_resize_rows_not_acked(mesh1):
    nb = 128
    cluster = _homed(7, 9, n_buckets=nb, start=1000, n_shards=1)
    t = _kv_table(nb, cluster[:8])
    res, nk, nv = _sharded_set_both(mesh1, t.keys, t.values, [cluster[8]],
                                    [[1, 2]])
    assert res.status.tolist() == [[tp.SET_NEEDS_RESIZE]]
    assert not bool(res.applied.any()) and bool(res.ok.all())
    np.testing.assert_array_equal(nk[0].numpy(), t.keys)


@pytest.fixture(scope="module")
def table128():
    rng = np.random.RandomState(2)
    return _kv_table(128, rng.choice(np.arange(1, 1 << 16), 48,
                                     replace=False))


def test_sharded_set_updates_inserts_and_live_mask(mesh1, table128):
    t = table128
    upd = t.keys[t.keys != 0][:5]
    sk = np.concatenate([upd, [80001, 80002, 80003, 80001, -1]])
    sv = np.stack([sk % 61, sk % 53], axis=1)
    live = np.ones(len(sk), bool)
    live[[2, -1]] = False                 # a sentinel key under a dead row
    res, _, _ = _sharded_set_both(mesh1, t.keys, t.values, sk, sv,
                                  live=live)
    assert res.deferred.tolist() == [2]


def test_sharded_set_padding_slots_are_inert(mesh1, table128):
    t = table128
    res, _, _ = _sharded_set_both(mesh1, t.keys, t.values, [0, 91001],
                                  [[0, 0], [6, 7]], capacity=1)
    assert res.ok[0].tolist() == [False, True]
    assert res.dropped.tolist() == [0] and res.deferred.tolist() == [0]


def test_sharded_set_capacity_drops_are_not_acks(mesh1, table128):
    t = table128
    sk = np.asarray([90001, 90002, 90003, 90004], np.int32)
    for cap in (2, 0):
        res, _, _ = _sharded_set_both(mesh1, t.keys, t.values, sk,
                                      np.stack([sk % 7, sk % 11], 1),
                                      capacity=cap)
        assert int(res.ok.sum()) == cap and res.dropped.tolist() == [4 - cap]


def test_sharded_set_on_tiny_shard_serves_writer_only(mesh1):
    t = th.make_table(4, V, neighborhood=8)
    sk = np.asarray([11, 12, 13, 14, 15], np.int32)
    res, nk, _ = _sharded_set_both(mesh1, t.keys, t.values, sk,
                                   np.stack([sk % 7, sk % 5], 1))
    assert sorted(res.status[0].tolist()) == [2, 2, 2, 2, 5]


def test_sharded_set_neighborhood_one_still_serves(mesh1):
    t = th.make_table(NB, V, neighborhood=1)
    a = _homed(5, 1)[0]
    b = _homed(5, 2, start=a + 1)[1]
    sk = np.asarray([a, a, b], np.int32)
    res, _, _ = _sharded_set_both(mesh1, t.keys, t.values, sk,
                                  np.stack([sk % 7 + 1, sk % 5 + 1], 1),
                                  neighborhood=1)
    assert res.status[0].tolist() == [2, 1, 5]


def test_sharded_set_escalation_fuel_covers_the_unroll(mesh1):
    """A 16-move ladder under max_steps=256: the displacer stage runs at
    its exact fuel, not the writer's budget."""
    nb, h = 128, 8
    t = th.make_table(nb, V, neighborhood=h)
    for pos in range(30, 53):
        k = _homed((pos - 6) % nb, 1, n_buckets=nb, start=500 + 29 * pos,
                   n_shards=1)[0]
        t.keys[pos % nb] = k
        t.values[pos % nb] = [k % 7, k % 11]
    z = _homed(30, 1, n_buckets=nb, start=60000, n_shards=1)[0]
    res, _, _ = _sharded_set_both(mesh1, t.keys, t.values, [z], [[5, 6]],
                                  neighborhood=h, max_steps=256,
                                  max_search=24, max_moves=16)
    assert res.status.tolist() == [[tp.SET_DISPLACED]]


# --- sharded_set at S = 4 against the host oracle ----------------------------

def window_oracle(tables, sk, sv, live, fn, *args):
    """Apply a batch per owner shard in window order (source-major, then
    batch order): ``fn(table, keys, vals, *args)`` on each owner's live
    rows.  Returns the per-request statuses (0 for rows not run)."""
    n_shards = len(tables)
    owner = tstore.shard_of(sk, n_shards)
    status = np.zeros(sk.shape, np.int32)
    for o in range(n_shards):
        rows = [(s, b) for s in range(sk.shape[0])
                for b in range(sk.shape[1])
                if owner[s, b] == o and live[s, b] and sk[s, b] != 0]
        if not rows:
            continue
        keys = [sk[r] for r in rows]
        out = (fn(tables[o], keys, [sv[r] for r in rows], *args)
               if sv is not None else fn(tables[o], keys, *args))
        for r, x in zip(rows, out):
            status[r] = x
    return status


def test_s4_sharded_set_matches_window_oracle():
    nb = 64
    kv = tstore.ShardedKV.build(4, nb, V, neighborhood=H)
    rng = np.random.RandomState(5)
    keys = rng.choice(np.arange(1, 1 << 20), 150, replace=False)
    for k in keys.tolist():
        kv.set(k, [k % 97, k % 89])
    dk, dv = kv.device_arrays("cpu")
    sk = np.concatenate([rng.choice(keys, (4, 6)),
                         rng.randint(1 << 20, 1 << 22, (4, 6))], 1)
    sk[:, -1] = sk[:, 7]                  # a later duplicate of an insert
    sk[1, 3] = 0
    sk = sk.astype(np.int32)
    sv = np.stack([sk % 61, sk % 53], -1).astype(np.int32)
    live = rng.rand(*sk.shape) < 0.9
    transport.trace = []
    try:
        res, nk, nv = tstore.sharded_set(dk, dv, _t(sk), _t(sv),
                                         neighborhood=H, live=_t(live),
                                         max_search=S, max_moves=M,
                                         device="cpu")
        stages = [(r["stage"], r["depth"]) for r in transport.trace]
    finally:
        transport.trace = None
    want = window_oracle(kv.tables, sk, sv, live, th.insert_many_displaced,
                         S, M)
    np.testing.assert_array_equal(res.status.numpy(), want)
    np.testing.assert_array_equal(nk.numpy(), np.stack([t.keys for t in
                                                        kv.tables]))
    np.testing.assert_array_equal(nv.numpy(), np.stack([t.values for t in
                                                        kv.tables]))
    run = live & (sk != 0)
    np.testing.assert_array_equal(res.ok.numpy(), run)
    np.testing.assert_array_equal(res.deferred.numpy(),
                                  (~live & (sk != 0)).sum(1))
    assert stages[0][0] == "writer" and stages[0][1] < run.sum()
    # the new values are served on every get path
    for method in ("redn", "one_sided", "two_sided"):
        g = tstore.sharded_get(nk, nv, _t(sk), method=method, neighborhood=H,
                               device="cpu")
        rf, rv = tstore.reference_get(kv, sk.reshape(-1))
        np.testing.assert_array_equal(g.found.numpy().reshape(-1), rf)
        np.testing.assert_array_equal(g.values.numpy().reshape(-1, V), rv)


def test_escalation_subset_never_drops():
    rng = np.random.RandomState(11)
    for _ in range(50):
        n, cap = rng.randint(1, 40), rng.randint(1, 8)
        dests = _t(rng.randint(0, 4, size=n).astype(np.int32))
        live1 = _t(rng.rand(n) < 0.7)
        ok1 = (transport.rank_within_dest(dests, live1) < cap) & live1
        live2 = ok1 & _t(rng.rand(n) < 0.5)
        ok2 = (transport.rank_within_dest(dests, live2) < cap) & live2
        np.testing.assert_array_equal(ok2.numpy(), live2.numpy())


def test_sharded_set_guards(monkeypatch):
    kv = tstore.ShardedKV.build(2, 32, V)
    dk, dv = kv.device_arrays("cpu")
    sk = _t(np.asarray([[5, 6], [7, 8]], np.int32))
    sv = torch.zeros((2, 2, V), dtype=torch.int32)
    # faults= with racing writers conflicts, before any other check; the
    # racing writers alone serve this batch as the serialized writer does
    with pytest.raises(tstore.WriterFaultConflict, match="exclusive"):
        tstore.sharded_set(dk, dv, sk, sv, faults=object(), n_writers=2,
                           device="cpu")
    raced = tstore.sharded_set(dk, dv, sk, sv, n_writers=2, device="cpu")
    serial = tstore.sharded_set(dk, dv, sk, sv, device="cpu")
    for a, b in zip(raced[0], serial[0]):
        assert torch.equal(a, b)
    assert torch.equal(raced[1], serial[1]) and bool(raced[0].applied.all())
    # a resize state selects the watermark-routed arm
    res, rs = tstore.sharded_set(tstore.begin_resize(dk, dv, device="cpu"),
                                 sk, sv + 1, device="cpu")
    assert isinstance(rs, tstore.ResizeState) and bool(res.applied.all())
    with pytest.raises(TypeError, match="multiple values"):
        tstore.sharded_set(dk, dv, sk, sv, vals=dv, device="cpu")
    with pytest.raises(ValueError, match="exp"):
        tstore.sharded_set(dk, dv, sk, sv, deadlines=sk, device="cpu")
    with pytest.raises(ValueError, match="24-bit"):
        tstore.sharded_set(dk, dv, sk + (1 << 24), sv, device="cpu")
    with pytest.raises(ValueError, match="24-bit"):
        tstore.sharded_set(dk, dv, -sk, sv, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tstore.sharded_set(dk, dv, sk, sv),
                 lambda: tstore.sharded_delete(dk, dv, sk),
                 lambda: tstore.sharded_sweep(dk, dv, dk, dk[:, 0], 5),
                 lambda: tp.build_hopscotch_writer(16, 2, 4),
                 lambda: tp.build_hopscotch_displacer(16, 2, 4, 8, 2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_set_result_repr_names_statuses():
    res = tstore.SetResult(
        status=_t(np.asarray([[1, 4, 0]], np.int32)),
        applied=_t(np.asarray([[True, True, False]])),
        ok=_t(np.asarray([[True, True, False]])),
        dropped=_t(np.asarray([0], np.int32)),
        deferred=_t(np.asarray([1], np.int32)))
    assert repr(res) == ("SetResult(SET_UPDATED=1, SET_DISPLACED=1, "
                         "ok 2/3, applied=2, dropped=0, deferred=1)")
