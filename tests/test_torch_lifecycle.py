"""Parity of the port's Memcached lifecycle with the JAX package: the
deleter, CLOCK sweeper and TTL get server (word-identical images, equal
states after a run), ``sharded_delete``, ``sharded_sweep``, TTL-aware
``sharded_get`` and ``sharded_set`` at S = 1 against JAX's on a 1-device
mesh, ``relocate_exp`` against JAX's on random cases, and the whole
set -> get -> expire -> sweep -> delete -> re-insert scenario of
``tests/test_lifecycle.py`` replayed on both packages.  All state is
int32: tolerance 0."""
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

NO_TTL = th.NO_TTL


_fresh_jax_programs = pytest.fixture(scope="module", autouse=True)(
    fresh_jax_programs)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def mesh1():
    return Mesh(np.array(jax.devices()[:1]), ("kv",))


def _seeded(n=16, v=2, h=8, items=((1, (11, 12)), (2, (21, 22)),
                                   (7, (71, 72)))):
    t = th.make_table(n, v, h)
    st = th.insert_many(t, [k for k, _ in items],
                        [list(val) for _, val in items])
    assert all(int(s) in (1, 2) for s in st)
    return t


def _equal(got, want, what=""):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=f"{what}[{i}]")


# --- program images and single runs -----------------------------------------

GEOMETRIES = {
    "deleter_16_v2_h8": lambda m, d: m.build_hopscotch_deleter(16, 2, 8, **d),
    "deleter_64_v3_h4": lambda m, d: m.build_hopscotch_deleter(64, 3, 4, **d),
    "sweeper_16_v2": lambda m, d: m.build_clock_sweeper(16, 2, **d),
    "sweeper_64_v3": lambda m, d: m.build_clock_sweeper(64, 3, **d),
    "ttl_server_16_v2_h8": lambda m, d: m.build_hopscotch_server(
        16, 2, 8, ttl=True, **d),
    "ttl_server_64_v3_h4": lambda m, d: m.build_hopscotch_server(
        64, 3, 4, ttl=True, **d),
}


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_program_image_equal(name):
    j = GEOMETRIES[name](jp, {})
    t = GEOMETRIES[name](tp, dict(device="cpu"))
    assert convert.spec_from_tuple(j.spec) == t.spec
    assert_states_equal(j.state0, t.state0)
    for f in ("n_buckets", "val_len", "table_base", "values_base",
              "resp_region", "recv_wq", "resp_words"):
        assert getattr(t, f) == getattr(j, f), f
    if not name.startswith("ttl"):
        assert t.fuel == j.fuel
    assert t.prog.budget() == j.prog.budget()


def test_constants_equal():
    for name in ("DEL_DELETED", "DEL_MISS", "SWEEP_RECLAIMED", "SWEEP_LIVE",
                 "NO_TTL"):
        assert getattr(tp, name) == getattr(jp, name) == getattr(th, name)
    assert tp._SWEEP_WQS == jp._SWEEP_WQS


def test_deleter_runs_equal():
    jd = jp.build_hopscotch_deleter(16, 2, 8)
    td = tp.build_hopscotch_deleter(16, 2, 8, device="cpu")
    t = _seeded()
    for key in (1, 7, 5, 0):
        pay = td.device_payloads(_t([key]), th.bucket_of(_t([key]), 16))[0]
        jst = jm.deliver(jd.device_state(jnp.asarray(t.keys),
                                         jnp.asarray(t.values)),
                         jd.recv_wq, jnp.asarray(pay.numpy()))
        tst = tm.deliver(td.device_state(_t(t.keys), _t(t.values)),
                         td.recv_wq, pay)
        assert_states_equal(jd.engine.run(jst, 512),
                            td.engine.run(tst, 512))
        _equal(td.run_one(_t(t.keys), _t(t.values), pay, 512),
               jd.run_one(jnp.asarray(t.keys), jnp.asarray(t.values),
                          jnp.asarray(pay.numpy()), 512), f"delete {key}")
    dels = np.asarray([1, 5, 7, 1], np.int32)
    want = jd.delete_many(jnp.asarray(t.keys), jnp.asarray(t.values),
                          jnp.asarray(dels), jh.bucket_of(jnp.asarray(dels),
                                                          16))
    got = td.delete_many(_t(t.keys), _t(t.values), _t(dels),
                         th.bucket_of(_t(dels), 16))
    _equal(got, want, "delete_many")
    ref = th.HopscotchTable(t.keys.copy(), t.values.copy(), 8)
    np.testing.assert_array_equal(got[0].numpy(), th.delete_many(ref, dels))
    np.testing.assert_array_equal(got[1].numpy(), ref.keys)


@pytest.mark.parametrize("now", [50, 100, 150, -1])
def test_sweeper_runs_equal(now):
    js = jp.build_clock_sweeper(16, 2)
    ts = tp.build_clock_sweeper(16, 2, device="cpu")
    t = _seeded()
    exp = np.full(16, NO_TTL, np.int32)
    exp[t.keys == 2] = 40
    exp[t.keys == 7] = 100
    exp[5] = 10                        # an EMPTY bucket with a stale deadline
    for b in range(0, 16, 3):
        pay = ts.device_payloads(_t([b]), now)[0]
        jst = jm.deliver(js.device_state(*map(jnp.asarray,
                                              (t.keys, t.values, exp))),
                         js.recv_wq, jnp.asarray(pay.numpy()))
        tst = tm.deliver(ts.device_state(_t(t.keys), _t(t.values), _t(exp)),
                         ts.recv_wq, pay)
        assert_states_equal(js.engine.run(jst, js.fuel),
                            ts.engine.run(tst, ts.fuel))
    want = js.sweep(*map(jnp.asarray, (t.keys, t.values, exp)), 3, 14, now)
    got = ts.sweep(_t(t.keys), _t(t.values), _t(exp), 3, 14, now)
    _equal(got, want, "sweep")
    # the host oracle compares in wrapping int32, like the chain
    ref = th.HopscotchTable(t.keys.copy(), t.values.copy(), 8)
    st, oexp = th.sweep_expired(ref, exp, now, 3, 14)
    _equal((st, ref.keys, ref.values, oexp), [g.numpy() for g in got],
           "oracle")


# --- DELETE ------------------------------------------------------------------

DELETE_ARMS = {
    "plain": dict(dels=[1, 5, 7]),
    "padding_and_live": dict(dels=[0, 2, 1, 9], live=[True, True, False,
                                                      True]),
    "capacity_2": dict(dels=[1, 2, 7], capacity=2),
    "capacity_0": dict(dels=[1, 2], capacity=0),
}


@pytest.mark.parametrize("arm", sorted(DELETE_ARMS))
def test_sharded_delete_bit_exact(mesh1, arm):
    t = _seeded()
    kw = dict(DELETE_ARMS[arm])
    dels = np.asarray([kw.pop("dels")], np.int32)
    live = kw.pop("live", None)
    exp = np.where(t.keys == 1, 123, NO_TTL).astype(np.int32)[None]
    want = jstore.sharded_delete(
        mesh1, "kv", jnp.asarray(t.keys)[None], jnp.asarray(t.values)[None],
        jnp.asarray(dels), live=None if live is None
        else jnp.asarray([live]), exp=jnp.asarray(exp), **kw)
    got = tstore.sharded_delete(
        _t(t.keys)[None], _t(t.values)[None], _t(dels),
        live=None if live is None else _t([live]), exp=_t(exp),
        device="cpu", **kw)
    _equal(got[0], want[0], "DeleteResult")
    _equal(got[1:], want[1:], "arrays")
    if arm == "plain":
        assert got[0].applied[0].tolist() == [True, False, True]
        np.testing.assert_array_equal(
            got[0].status[0].numpy(),
            th.delete_many(t, dels[0]))
        np.testing.assert_array_equal(got[1][0].numpy(), t.keys)
        assert (got[3].numpy() == NO_TTL).all()


# --- TTL gets and sets -------------------------------------------------------

def test_ttl_get_bit_exact(mesh1):
    t = _seeded()
    exp = np.full(t.keys.shape, NO_TTL, np.int32)
    exp[t.keys == 7] = 100
    q = np.asarray([[1, 2, 7, 9, 0]], np.int32)
    found = {}
    for now in (50, 100, 150, -1, -2 ** 31):
        want = jstore.sharded_get(mesh1, "kv", jnp.asarray(t.keys)[None],
                                  jnp.asarray(t.values)[None], jnp.asarray(q),
                                  exp=jnp.asarray(exp)[None], now=now)
        got = tstore.sharded_get(_t(t.keys)[None], _t(t.values)[None],
                                 _t(q), exp=_t(exp)[None], now=now,
                                 device="cpu")
        _equal(got, want, f"now={now}")
        f, v = th.lookup_ttl(_t(t.keys), _t(t.values), _t(exp), _t(q[0]),
                             now, 8)
        jf, jv = jh.lookup_ttl(jnp.asarray(t.keys), jnp.asarray(t.values),
                               jnp.asarray(exp), jnp.asarray(q[0]), now, 8)
        _equal((f, v), (jf, jv), f"lookup_ttl now={now}")
        _equal((got.found[0], got.values[0]), (f, v), f"oracle now={now}")
        found[now] = got.found[0].tolist()
    assert found[50] == [True, True, True, False, False]
    assert found[150] == [True, True, False, False, False]


def test_ttl_get_requires_both_exp_and_now():
    t = _seeded()
    k, v = _t(t.keys)[None], _t(t.values)[None]
    q = _t(np.asarray([[1]], np.int32))
    with pytest.raises(ValueError, match="exp"):
        tstore.sharded_get(k, v, q, exp=torch.zeros_like(k), device="cpu")
    with pytest.raises(ValueError, match="now"):
        tstore.sharded_get(k, v, q, now=5, device="cpu")
    with pytest.raises(ValueError, match="chain-only"):
        tstore.sharded_get(k, v, q, method="two_sided",
                           exp=torch.zeros_like(k), now=5, device="cpu")


def test_ttl_set_stamps_and_clears_deadlines(mesh1):
    t = _seeded()
    exp = np.where(t.keys == 7, 100, NO_TTL).astype(np.int32)[None]
    args = ([[9, 1]], [[[91, 92], [13, 14]]])
    dl = np.asarray([[500, 0]], np.int32)
    want = jstore.sharded_set(
        mesh1, "kv", jnp.asarray(t.keys)[None], jnp.asarray(t.values)[None],
        *(jnp.asarray(a, jnp.int32) for a in args), exp=jnp.asarray(exp),
        deadlines=jnp.asarray(dl))
    got = tstore.sharded_set(_t(t.keys)[None], _t(t.values)[None],
                             *(_t(np.asarray(a, np.int32)) for a in args),
                             exp=_t(exp), deadlines=_t(dl), device="cpu")
    _equal(got[0], want[0], "SetResult")
    _equal(got[1:], want[1:], "arrays")
    nk, ne = got[1][0].numpy(), got[3][0].numpy()
    assert ne[nk == 9] == 500 and ne[nk == 7] == 100 and ne[nk == 1] == 0
    # a set without deadlines clears the key's TTL
    want2 = jstore.sharded_set(mesh1, "kv", *want[1:3],
                               jnp.asarray([[9]], jnp.int32),
                               jnp.asarray([[[93, 94]]], jnp.int32),
                               exp=want[3])
    got2 = tstore.sharded_set(*got[1:3], _t(np.asarray([[9]], np.int32)),
                              _t(np.asarray([[[93, 94]]], np.int32)),
                              exp=got[3], device="cpu")
    _equal(got2[1:], want2[1:], "cleared")
    assert got2[3][0].numpy()[got2[1][0].numpy() == 9] == NO_TTL


# --- the CLOCK sweeper -------------------------------------------------------

@pytest.mark.parametrize("hand,count,now", [(0, 16, 100), (5, 7, 45),
                                            (13, 20, 1000), (2, 4, -1)])
def test_sharded_sweep_bit_exact(mesh1, hand, count, now):
    t = _seeded()
    exp = np.full(t.keys.shape, NO_TTL, np.int32)
    exp[t.keys == 2] = 40
    exp[t.keys == 7] = 90
    want = jstore.sharded_sweep(
        mesh1, "kv", jnp.asarray(t.keys)[None], jnp.asarray(t.values)[None],
        jnp.asarray(exp)[None], jnp.asarray([hand], jnp.int32), now=now,
        count=count)
    got = tstore.sharded_sweep(_t(t.keys)[None], _t(t.values)[None],
                               _t(exp)[None], _t([hand]), now=now,
                               count=count, device="cpu")
    _equal(got[0], want[0], "SweepReport")
    _equal(got[1:], want[1:], "arrays")
    st, oexp = th.sweep_expired(t, exp, now, hand, count)
    _equal((got[0].status[0], got[1][0], got[2][0], got[3][0]),
           (st, t.keys, t.values, oexp), "oracle")


def test_sharded_sweep_s4_matches_oracle():
    kv = tstore.ShardedKV.build(4, 32, 2)
    rng = np.random.RandomState(3)
    keys = rng.choice(np.arange(1, 1 << 16), 60, replace=False)
    for k in keys.tolist():
        kv.set(k, [k % 13, k % 17])
    dk, dv = kv.device_arrays("cpu")
    exp = rng.randint(0, 200, dk.shape).astype(np.int32)
    exp[rng.rand(*dk.shape) < 0.5] = NO_TTL
    hand = np.asarray([0, 7, 31, 12], np.int32)
    rep, nk, nv, ne = tstore.sharded_sweep(dk, dv, _t(exp), _t(hand), 100,
                                           count=10, device="cpu")
    for s, t in enumerate(kv.tables):
        st, oexp = th.sweep_expired(t, exp[s], 100, int(hand[s]), 10)
        np.testing.assert_array_equal(rep.status[s].numpy(), st)
        np.testing.assert_array_equal(nk[s].numpy(), t.keys)
        np.testing.assert_array_equal(nv[s].numpy(), t.values)
        np.testing.assert_array_equal(ne[s].numpy(), oexp)
    assert rep.hand.tolist() == ((hand + 10) % 32).tolist()
    assert int(rep.reclaimed.sum()) > 0


# --- relocate_exp ------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_relocate_exp_matches_jax(seed):
    rng = np.random.RandomState(seed)
    s, n, b = rng.randint(1, 4), rng.randint(4, 24), rng.randint(0, 12)
    old = np.zeros((s, n), np.int32)
    for i in range(s):
        live = rng.choice(np.arange(1, 60), rng.randint(0, n), replace=False)
        old[i, rng.choice(n, len(live), replace=False)] = live
    old_exp = rng.randint(-5, 500, (s, n)).astype(np.int32)
    # moved keys: each shard's keys permuted, a few dropped, a few new
    new = np.stack([rng.permutation(row) for row in old])
    new[rng.rand(s, n) < 0.15] = 0
    new[rng.rand(s, n) < 0.1] = rng.randint(60, 70)
    req = rng.randint(0, 70, (s, b)).astype(np.int32)
    if b:
        req.reshape(-1)[-1] = req.reshape(-1)[0]       # a duplicate
    dl = rng.randint(-5, 500, (s, b)).astype(np.int32)
    applied = rng.rand(s, b) < 0.7
    for args in ((), (req,), (req, dl), (req, dl, applied),
                 (req, None, applied)):
        want = jstore.relocate_exp(*(None if a is None else jnp.asarray(a)
                                     for a in (old, old_exp, new) + args))
        got = tstore.relocate_exp(*(None if a is None else _t(a)
                                    for a in (old, old_exp, new) + args))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f"{len(args)} args")


# --- the whole lifecycle, both packages --------------------------------------

def test_full_lifecycle_on_both_packages(mesh1):
    """set -> get -> expire -> sweeper reclaim -> delete -> re-insert, each
    verb a chain execution against device state on both packages; keys,
    vals and exp equal after every verb, and equal to the host oracle."""
    t = th.make_table(16, 2, 8)
    th.insert_many(t, [1, 2], [[11, 11], [22, 22]])
    jk, jv = jnp.asarray(t.keys)[None], jnp.asarray(t.values)[None]
    je = jnp.full((1, 16), NO_TTL, jnp.int32)
    tk, tv = _t(t.keys)[None], _t(t.values)[None]
    te = torch.full((1, 16), NO_TTL, dtype=torch.int32)
    oexp = np.full(16, NO_TTL, np.int32)

    def same(what):
        _equal((tk, tv, te), (jk, jv, je), what)
        _equal((tk[0], tv[0], te[0]), (t.keys, t.values, oexp), what)

    def get(now):
        q = np.asarray([[1, 2, 5]], np.int32)
        want = jstore.sharded_get(mesh1, "kv", jk, jv, jnp.asarray(q),
                                  exp=je, now=now)
        got = tstore.sharded_get(tk, tv, _t(q), exp=te, now=now,
                                 device="cpu")
        _equal(got, want, f"get now={now}")
        f, v = th.lookup_ttl(_t(t.keys), _t(t.values), _t(oexp), _t(q[0]),
                             now, 8)
        _equal((got.found[0], got.values[0]), (f, v), f"oracle now={now}")
        return got.found[0].tolist()

    sk, sv, dl = (np.asarray([[5]], np.int32),
                  np.asarray([[[55, 56]]], np.int32),
                  np.asarray([[100]], np.int32))
    res, jk, jv, je = jstore.sharded_set(
        mesh1, "kv", jk, jv, jnp.asarray(sk), jnp.asarray(sv), exp=je,
        deadlines=jnp.asarray(dl))
    _, tk, tv, te = tstore.sharded_set(tk, tv, _t(sk), _t(sv), exp=te,
                                       deadlines=_t(dl), device="cpu")
    th.insert_many(t, [5], [[55, 56]])
    oexp[t.keys == 5] = 100
    same("set")
    assert get(50) == [True, True, True]
    assert get(150) == [True, True, False]          # expired: lazy miss

    rep, jk, jv, je = jstore.sharded_sweep(mesh1, "kv", jk, jv, je,
                                           jnp.zeros(1, jnp.int32), now=150)
    trep, tk, tv, te = tstore.sharded_sweep(tk, tv, te, _t([0]), 150,
                                            device="cpu")
    _equal(trep, rep, "sweep report")
    _, oexp = th.sweep_expired(t, oexp, 150, 0, 16)
    assert int(trep.reclaimed.sum()) == 1
    same("sweep")

    res, jk, jv, je = jstore.sharded_delete(
        mesh1, "kv", jk, jv, jnp.asarray([[1]], jnp.int32), exp=je)
    tres, tk, tv, te = tstore.sharded_delete(
        tk, tv, _t(np.asarray([[1]], np.int32)), exp=te, device="cpu")
    _equal(tres, res, "delete result")
    th.delete_many(t, [1])
    same("delete")
    assert get(160) == [False, True, False]

    sk, sv = np.asarray([[1]], np.int32), np.asarray([[[77, 78]]], np.int32)
    res, jk, jv, je = jstore.sharded_set(mesh1, "kv", jk, jv,
                                         jnp.asarray(sk), jnp.asarray(sv),
                                         exp=je)
    _, tk, tv, te = tstore.sharded_set(tk, tv, _t(sk), _t(sv), exp=te,
                                       device="cpu")
    th.insert_many(t, [1], [[77, 78]])
    same("re-insert")
    assert get(170) == [True, True, False]


def test_delete_and_sweep_results_repr():
    res = tstore.DeleteResult(
        status=_t(np.asarray([[9, 10]], np.int32)),
        applied=_t(np.asarray([[True, False]])),
        ok=_t(np.asarray([[True, True]])),
        dropped=_t(np.asarray([0], np.int32)),
        deferred=_t(np.asarray([0], np.int32)))
    assert repr(res) == ("DeleteResult(DEL_DELETED=1, DEL_MISS=1, ok 2/2, "
                         "applied=1, dropped=0, deferred=0)")
    rep = tstore.SweepReport(status=_t(np.asarray([[11, 12, 12]], np.int32)),
                             reclaimed=_t(np.asarray([1], np.int32)),
                             hand=_t(np.asarray([3], np.int32)))
    assert repr(rep) == "SweepReport(reclaimed=1/3, hand=[3])"
