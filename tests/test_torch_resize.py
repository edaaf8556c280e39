"""Parity of the port's online resize with the JAX package: the migrator
chain (word-identical image, equal laps), the ``grow`` oracle,
``sharded_resize`` quanta, and serving from the double frame
(``sharded_get`` / ``sharded_set`` given a ``ResizeState``, and their
``*_migrating`` spellings) at S = 1 against JAX's on a 1-device mesh.  The
cases mirror ``tests/test_resize.py`` from
``test_mig_status_codes_match_across_layers`` through
``test_set_migrating_never_reports_internal_status``; each runs the same
seeded inputs through both packages.  All state is int32: tolerance 0."""
import warnings

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

NB, H, V = 32, 4, 2


_fresh_jax_programs = pytest.fixture(scope="module", autouse=True)(
    fresh_jax_programs)


@pytest.fixture(scope="module")
def mesh1():
    return Mesh(np.array(jax.devices()[:1]), ("kv",))


@pytest.fixture(scope="module")
def migrators():
    return (jp.build_hopscotch_migrator(NB, V, H),
            tp.build_hopscotch_migrator(NB, V, H, device="cpu"))


def _t(a):
    return torch.from_numpy(np.array(a))


def _keys_with_home(bucket, count, n_buckets=NB, start=1):
    return tstore.keys_homed_at(bucket, count, n_buckets, start=start,
                                n_shards=1)


def _filled_table(n_keys, seed=0, nb=NB, h=H):
    t = th.make_table(nb, V, neighborhood=h)
    rng = np.random.RandomState(seed)
    ks, k = [], 1
    while len(ks) < n_keys:
        if t.insert(k, [k % 7 + 1, k % 11 + 1]):
            ks.append(k)
        k += 1 + int(rng.randint(4))
    return t, ks


def _copy(t):
    return th.HopscotchTable(t.keys.copy(), t.values.copy(), t.neighborhood)


def _equal(got, want, what=""):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=f"{what}[{i}]")


def _rs_equal(trs, jrs, what=""):
    _equal(trs, jrs, what)


def _lap_both(migs, frames, b, states=True):
    """One migrator lap of source bucket ``b`` through both packages (and,
    with ``states``, the raw run states): returns the port's ``(status,
    ok, ov, nk, nv)`` after asserting it equals JAX's."""
    jmig, tmig = migs
    pj = jmig.device_payloads(jnp.asarray([b], jnp.int32),
                              jnp.asarray(frames[0]))[0]
    pt = tmig.device_payloads(torch.tensor([b], dtype=torch.int32),
                              _t(frames[0]))[0]
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    if states:
        jst = jm.deliver(jmig.device_state(*map(jnp.asarray, frames)),
                         jmig.recv_wq, pj)
        tst = tm.deliver(tmig.device_state(*map(_t, frames)), tmig.recv_wq,
                         pt)
        assert_states_equal(jst, tst)
        assert_states_equal(jmig.engine.run(jst, jmig.fuel),
                            tmig.engine.run(tst, tmig.fuel))
    want = jmig.run_one(*map(jnp.asarray, frames), pj, jmig.fuel)
    got = tmig.run_one(*map(_t, frames), pt, tmig.fuel)
    _equal(got, want, f"lap {b}")
    return got


def _mig_parity(migs, t, new, b):
    """One lap through both packages and the ``migrate_bucket`` oracle of
    each: status and all four arrays bit-exact."""
    ref_old, ref_new = _copy(t), _copy(new)
    jref_old = jh.HopscotchTable(t.keys.copy(), t.values.copy(), H)
    jref_new = jh.HopscotchTable(new.keys.copy(), new.values.copy(), H)
    st, ok, ov, nk, nv = _lap_both(migs, (t.keys, t.values, new.keys,
                                          new.values), b)
    ref_st = ref_old.migrate_bucket(ref_new, b)
    assert ref_st == jref_old.migrate_bucket(jref_new, b) == int(st)
    for got, want in ((ok, ref_old.keys), (ov, ref_old.values),
                      (nk, ref_new.keys), (nv, ref_new.values)):
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ref_old.keys, jref_old.keys)
    np.testing.assert_array_equal(ref_new.keys, jref_new.keys)
    return int(st), nk, nv


# --- the migrator program vs the per-bucket oracle ---------------------------

def test_mig_status_codes_match_across_layers():
    for name in ("MIG_MOVED", "MIG_DISCARDED", "MIG_NEEDS_DISPLACE"):
        assert (getattr(th, name) == getattr(tp, name) == getattr(jh, name)
                == getattr(jp, name))


@pytest.mark.parametrize("geom", [(NB, V, H), (8, 2, 4), (64, 3, 8)])
def test_migrator_image_equal(geom):
    j = jp.build_hopscotch_migrator(*geom)
    t = tp.build_hopscotch_migrator(*geom, device="cpu")
    assert convert.spec_from_tuple(j.spec) == t.spec
    assert_states_equal(j.state0, t.state0)
    for f in ("n_buckets", "val_len", "neighborhood", "old_table_base",
              "old_values_base", "new_table_base", "new_values_base",
              "resp_region", "recv_wq", "resp_words", "fuel"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.prog.budget() == j.prog.budget()


def test_migrator_full_sweep_bit_exact(migrators):
    """Every source bucket of a populated table through both chains, each
    lap bit-exact with the other package and ``migrate_bucket``; then the
    old frame is empty and every key serves from the new frame."""
    t, ks = _filled_table(12, seed=0)
    frames = [t.keys.copy(), t.values.copy(),
              np.zeros(2 * NB, np.int32), np.zeros((2 * NB, V), np.int32)]
    ref_old, ref_new = _copy(t), th.make_table(2 * NB, V, neighborhood=H)
    ks_first = int(np.flatnonzero(t.keys)[0])
    for b in range(NB):
        ref_st = ref_old.migrate_bucket(ref_new, b)
        if int(frames[0][b]) == 0:
            assert ref_st == 0          # EMPTY source: never dispatched
            continue
        # the raw machine states of the first lap; every lap's commit
        st, *out = _lap_both(migrators, frames, b, states=b == ks_first)
        frames = [o.numpy() for o in out]
        assert int(st) == ref_st == th.MIG_MOVED
        np.testing.assert_array_equal(frames[2], ref_new.keys)
        np.testing.assert_array_equal(frames[3], ref_new.values)
    assert (frames[0] == th.EMPTY).all()
    f, v = th.lookup(_t(frames[2]), _t(frames[3]),
                     torch.tensor(ks, dtype=torch.int32), H)
    assert bool(f.all())
    for i, k in enumerate(ks):
        assert v[i].tolist() == [k % 7 + 1, k % 11 + 1]


def test_migrator_discard_keeps_newer_value(migrators):
    t = th.make_table(NB, V, neighborhood=H)
    k = 5
    assert t.insert(k, [1, 1])
    b = int(np.where(t.keys == k)[0][0])
    new = th.make_table(2 * NB, V, neighborhood=H)
    assert new.insert(k, [9, 9])        # the fresher copy
    st, nk, nv = _mig_parity(migrators, t, new, b)
    assert st == th.MIG_DISCARDED
    f, v = th.lookup(nk, nv, torch.tensor([k], dtype=torch.int32), H)
    assert bool(f[0]) and v[0].tolist() == [9, 9]


def test_migrator_needs_displace_leaves_frames_untouched(migrators):
    t = th.make_table(NB, V, neighborhood=H)
    kk = _keys_with_home(3, 1)[0]
    assert t.insert(kk, [2, 3])
    b = int(np.where(t.keys == kk)[0][0])
    hn = int(th.bucket_of(kk, 2 * NB))
    new = th.make_table(2 * NB, V, neighborhood=H)
    start = 1
    for d in range(H):
        want = (hn + d) % (2 * NB)
        c = _keys_with_home(want, 1, 2 * NB, start=start)[0]
        if c == kk:
            c = _keys_with_home(want, 1, 2 * NB, start=c + 1)[0]
        start = c + 1
        new.keys[want] = c
        new.values[want] = [c % 5 + 1, c % 3 + 1]
    kb, nb_ = t.keys.copy(), new.keys.copy()
    st, nk, nv = _mig_parity(migrators, t, new, b)
    assert st == th.MIG_NEEDS_DISPLACE
    np.testing.assert_array_equal(t.keys, kb)
    np.testing.assert_array_equal(nk.numpy(), nb_)


def test_migrator_select_covers_both_halves(migrators):
    """The Calc-verb select branch: bit-0 keys land in the lower
    half-neighborhood, bit-1 keys in the upper — both arms bit-exact."""
    shift = NB.bit_length() - 1
    done = {0: False, 1: False}
    k = 1
    while not all(done.values()):
        sel = ((k * 2654435761) & 0xFFFFFFFF) >> shift & 1
        t = th.make_table(NB, V, neighborhood=H)
        assert t.insert(k, [4, 4])
        b = int(np.where(t.keys == k)[0][0])
        new = th.make_table(2 * NB, V, neighborhood=H)
        st, nk, nv = _mig_parity(migrators, t, new, b)
        assert st == th.MIG_MOVED
        row = int(np.where(nk.numpy() == k)[0][0])
        hn = int(th.bucket_of(k, 2 * NB))
        assert (row - hn) % (2 * NB) < H
        assert hn == int(th.bucket_of(k, NB)) + sel * NB
        done[sel] = True
        k += 1


def test_migrator_zero_padded_request_is_inert(migrators):
    t, _ = _filled_table(8, seed=3)
    frames = (t.keys, t.values, np.zeros(2 * NB, np.int32),
              np.zeros((2 * NB, V), np.int32))
    jmig, tmig = migrators
    want = jmig.run_one(*map(jnp.asarray, frames), jnp.zeros(4, jnp.int32),
                        jmig.fuel)
    got = tmig.run_one(*map(_t, frames), torch.zeros(4, dtype=torch.int32),
                       tmig.fuel)
    _equal(got, want)
    assert int(got[0]) == 0
    _equal(got[1:], frames)


def test_migrator_build_bounds():
    for mod, kw in ((jp, {}), (tp, dict(device="cpu"))):
        with pytest.raises(ValueError, match="power-of-two"):
            mod.build_hopscotch_migrator(33, V, H, **kw)
        with pytest.raises(ValueError, match="row copy"):
            mod.build_hopscotch_migrator(NB, 17, H, **kw)
    with pytest.raises(ValueError, match="power-of-two"):
        th.make_table(33, V, neighborhood=H).grow()
    with pytest.raises(ValueError, match="power-of-two"):
        tstore.begin_resize(torch.zeros((1, 33), dtype=torch.int32),
                            torch.zeros((1, 33, V), dtype=torch.int32),
                            device="cpu")


@pytest.mark.parametrize("step", [1, 8, 13])
def test_grow_oracle_equals_reference(step):
    t, _ = _filled_table(20, seed=4)
    a = _copy(t).grow(step=step)
    b = jh.HopscotchTable(t.keys.copy(), t.values.copy(), H).grow(step=step)
    np.testing.assert_array_equal(a.keys, b.keys)
    np.testing.assert_array_equal(a.values, b.values)


# --- the sharded resize quanta -----------------------------------------------

def _begin_both(t):
    jrs = jstore.begin_resize(jnp.asarray(t.keys)[None],
                              jnp.asarray(t.values)[None])
    trs = tstore.begin_resize(_t(t.keys)[None], _t(t.values)[None],
                              device="cpu")
    _rs_equal(trs, jrs, "begin")
    return jrs, trs


def _resize_both(mesh1, jrs, trs, **kw):
    jrs, jrep = jstore.sharded_resize(mesh1, "kv", jrs, **kw)
    trs, trep = tstore.sharded_resize(trs, device="cpu", **kw)
    _rs_equal(trs, jrs, "resize state")
    _equal(trep, jrep, "migrate report")
    return jrs, jrep, trs, trep


def test_sharded_resize_matches_grow_oracle(mesh1):
    """Quantum-driven migration to cutover: every quantum's frames and
    report equal JAX's, and the final doubled frame equals
    ``grow(step=quantum)``."""
    t, ks = _filled_table(14, seed=1)
    ref = _copy(t)
    jrs, trs = _begin_both(t)
    grown = ref.grow(step=8)
    while not tstore.resize_done(trs):
        jrs, _, trs, rep = _resize_both(mesh1, jrs, trs, step=8,
                                        neighborhood=H)
        assert int(rep.stuck.sum()) == 0
    assert jstore.resize_done(jrs)
    nk, nv = tstore.finish_resize(trs)
    assert nk.shape == (1, 2 * NB)
    np.testing.assert_array_equal(nk[0].numpy(), grown.keys)
    np.testing.assert_array_equal(nv[0].numpy(), grown.values)
    assert (ref.keys == th.EMPTY).all()


def test_sharded_resize_escalates_through_displacer(mesh1):
    """A source key whose doubled-frame neighborhood is already full
    escalates through the new frame's displacer chain — placed, source
    vacated, reported — in both packages alike."""
    t = th.make_table(NB, V, neighborhood=H)
    kk = _keys_with_home(2, 1)[0]
    assert t.insert(kk, [3, 4])
    hn = int(th.bucket_of(kk, 2 * NB))
    new = th.make_table(2 * NB, V, neighborhood=H)
    start = 1
    for d in range(H):
        want = (hn + d) % (2 * NB)
        c = _keys_with_home(want, 1, 2 * NB, start=start)[0]
        if c == kk:
            c = _keys_with_home(want, 1, 2 * NB, start=c + 1)[0]
        start = c + 1
        assert new.insert(c, [c % 5 + 1, c % 3 + 1])
    frames = (t.keys[None], t.values[None], new.keys[None],
              new.values[None], np.zeros(1, np.int32))
    jrs = jstore.ResizeState(*map(jnp.asarray, frames))
    trs = tstore.ResizeState(*map(_t, frames))
    _, jrep, trs, rep = _resize_both(mesh1, jrs, trs, step=8,
                                     neighborhood=H)
    assert int(rep.escalated[0]) == 1 and int(rep.stuck[0]) == 0


def test_sharded_resize_stuck_parks_watermark(mesh1):
    """A resident unplaceable even displaced (its whole doubled-frame
    window full of immovable keys) parks the watermark on its bucket and
    counts as stuck, in both packages alike."""
    n = 8
    k0 = _keys_with_home(0, 1, n)[0]
    nk = np.zeros((1, 2 * n), np.int32)
    nv = np.zeros((1, 2 * n, 2), np.int32)
    for b in range(2 * n):
        nk[0, b] = _keys_with_home(b, 1, 2 * n, start=0x1000)[0]
        nv[0, b] = [b + 1, 1]
    keys = np.zeros((1, n), np.int32)
    vals = np.zeros((1, n, 2), np.int32)
    keys[0, 0], vals[0, 0] = k0, [5, 5]
    frames = (keys, vals, nk, nv, np.zeros(1, np.int32))
    jrs = jstore.ResizeState(*map(jnp.asarray, frames))
    trs = tstore.ResizeState(*map(_t, frames))
    _, _, trs, rep = _resize_both(mesh1, jrs, trs, step=n, neighborhood=H)
    assert int(rep.stuck[0]) == 1 and int(trs.watermark[0]) == 0


def test_finish_resize_guards():
    rs = tstore.begin_resize(torch.zeros((1, NB), dtype=torch.int32),
                             torch.zeros((1, NB, V), dtype=torch.int32),
                             device="cpu")
    with pytest.raises(ValueError, match="incomplete"):
        tstore.finish_resize(rs)
    keys = rs.keys.clone()
    keys[0, 3] = 7
    bad = rs._replace(watermark=torch.full((1,), NB, dtype=torch.int32),
                      keys=keys)
    with pytest.raises(RuntimeError, match="resident"):
        tstore.finish_resize(bad)


def test_resize_stuck_is_typed_with_parked_bucket():
    err = tstore.ResizeStuck([0], [3])
    assert isinstance(err, RuntimeError)
    assert err.stuck == [(0, 3)]
    assert str(err) == str(jstore.ResizeStuck([0], [3]))


# --- double-frame serving ----------------------------------------------------

def _get_both(mesh1, jrs, trs, q, **kw):
    """The double-frame get through both packages (the unified entry point
    and the deprecated spelling, which must agree)."""
    qj = jnp.asarray(np.asarray(q, np.int32)[None])
    qt = _t(np.asarray(q, np.int32)[None])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = jstore.sharded_get_migrating(mesh1, "kv", jrs, qj, **kw)
        shim = tstore.sharded_get_migrating(trs, qt, device="cpu", **kw)
    got = tstore.sharded_get(trs, qt, device="cpu", **kw)
    _equal(got, want, "get")
    _equal(shim, want, "get shim")
    return got


def _set_both(mesh1, jrs, trs, sk, sv, **kw):
    skj, svj = jnp.asarray(sk[None]), jnp.asarray(sv[None])
    jres, jrs = jstore.sharded_set(mesh1, "kv", jrs, skj, svj, **kw)
    tres, trs = tstore.sharded_set(trs, _t(sk[None]), _t(sv[None]),
                                   device="cpu", **kw)
    _equal(tres, jres, "set result")
    _rs_equal(trs, jrs, "set state")
    return jres, jrs, tres, trs


def _oracle_double_get(rs, q):
    fn, vn = th.lookup(rs.new_keys[0], rs.new_vals[0],
                       torch.tensor(q, dtype=torch.int32), H)
    fo, vo = th.lookup(rs.keys[0], rs.vals[0],
                       torch.tensor(q, dtype=torch.int32), H)
    return (fn | fo).numpy(), torch.where(fn[:, None], vn, vo).numpy()


def _mid_migration_state(mesh1, n_keys=12, seed=2, step=8):
    t, ks = _filled_table(n_keys, seed=seed)
    jrs, trs = _begin_both(t)
    jrs, _, trs, _ = _resize_both(mesh1, jrs, trs, step=step,
                                  neighborhood=H)
    return jrs, trs, ks


def test_get_migrating_bit_exact_all_watermarks(mesh1):
    t, ks = _filled_table(12, seed=2)
    jrs, trs = _begin_both(t)
    q = ks + [999983, 0]
    while not tstore.resize_done(trs):
        jrs, _, trs, _ = _resize_both(mesh1, jrs, trs, step=8,
                                      neighborhood=H)
        g = _get_both(mesh1, jrs, trs, q, neighborhood=H)
        f_ref, v_ref = _oracle_double_get(trs, q)
        np.testing.assert_array_equal(g.found[0].numpy(), f_ref)
        np.testing.assert_array_equal(g.values[0].numpy(), v_ref)
        assert bool(g.ok[0].all())
        assert not bool(g.found[0][-1])      # query 0: still a miss


def test_get_migrating_bucket_exactly_at_watermark(mesh1):
    t = th.make_table(NB, V, neighborhood=H)
    at_w = _keys_with_home(8, 1)[0]
    behind = _keys_with_home(7, 1)[0]
    assert t.insert(at_w, [11, 12]) and t.insert(behind, [13, 14])
    jrs, trs = _begin_both(t)
    jrs, _, trs, _ = _resize_both(mesh1, jrs, trs, step=8, neighborhood=H)
    assert int(trs.watermark[0]) == 8
    assert int(trs.keys[0, 8]) == at_w
    assert int(trs.keys[0, 7]) == th.EMPTY
    assert behind in trs.new_keys[0].tolist()
    g = _get_both(mesh1, jrs, trs, [at_w, behind], neighborhood=H)
    assert bool(g.found[0].all())
    np.testing.assert_array_equal(g.values[0].numpy(), [[11, 12], [13, 14]])


def test_set_migrating_routes_and_survives_cutover(mesh1):
    t = th.make_table(NB, V, neighborhood=H)
    k6a = _keys_with_home(6, 1)[0]
    k7 = _keys_with_home(7, 1)[0]
    k6b = _keys_with_home(6, 2, start=k6a + 1)[1]
    k20 = _keys_with_home(20, 1)[0]
    for k in (k6a, k7, k6b, k20):
        assert t.insert(k, [k % 9 + 1, k % 5 + 1])
    assert int(t.keys[8]) == k6b
    jrs, trs = _begin_both(t)
    jrs, _, trs, _ = _resize_both(mesh1, jrs, trs, step=8, neighborhood=H)
    fresh = 77001
    sk = np.asarray([k6b, k20, fresh], np.int32)
    sv = np.stack([sk % 61 + 1, sk % 53 + 1], axis=1).astype(np.int32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        shim, _ = tstore.sharded_set_migrating(
            trs, _t(sk[None]), _t(sv[None]), neighborhood=H, device="cpu")
    _, jrs, res, trs = _set_both(mesh1, jrs, trs, sk, sv, neighborhood=H)
    _equal(shim, res, "set shim")
    assert bool(res.ok[0].all()) and bool(res.applied[0].all())
    assert res.status[0].tolist() == [tp.SET_INSERTED, tp.SET_UPDATED,
                                      tp.SET_INSERTED]
    assert k6b in trs.new_keys[0].tolist() and int(trs.keys[0, 8]) == k6b
    g = _get_both(mesh1, jrs, trs, sk, neighborhood=H)
    np.testing.assert_array_equal(g.values[0].numpy(), sv)
    discarded = 0
    while not tstore.resize_done(trs):
        jrs, _, trs, rep = _resize_both(mesh1, jrs, trs, step=8,
                                        neighborhood=H)
        discarded += int(rep.discarded.sum())
    assert discarded == 1
    nk, nv = tstore.finish_resize(trs)
    g2 = tstore.sharded_get(nk, nv, _t(sk[None]), neighborhood=H,
                            device="cpu")
    assert bool(g2.found[0].all())
    np.testing.assert_array_equal(g2.values[0].numpy(), sv)


def test_set_migrating_wrap_home_routes_new(mesh1):
    t = th.make_table(NB, V, neighborhood=H)
    jrs, trs = _begin_both(t)
    wrap = _keys_with_home(NB - 1, 1)[0]
    sk = np.asarray([wrap], np.int32)
    sv = np.asarray([[5, 6]], np.int32)
    _, jrs, res, trs = _set_both(mesh1, jrs, trs, sk, sv, neighborhood=H)
    assert int(res.status[0, 0]) == tp.SET_INSERTED
    assert wrap in trs.new_keys[0].tolist()
    assert wrap not in trs.keys[0].tolist()
    while not tstore.resize_done(trs):
        jrs, _, trs, _ = _resize_both(mesh1, jrs, trs, step=8,
                                      neighborhood=H)
    nk, nv = tstore.finish_resize(trs)
    g = tstore.sharded_get(nk, nv, _t(sk[None]), neighborhood=H,
                           device="cpu")
    assert bool(g.found[0, 0])
    np.testing.assert_array_equal(g.values[0, 0].numpy(), [5, 6])


def test_set_migrating_never_reports_internal_status(mesh1):
    jrs, trs, ks = _mid_migration_state(mesh1, n_keys=10, seed=5)
    w = int(trs.watermark[0])
    migrated = [k for k in ks if int(th.bucket_of(k, NB)) < w]
    assert len(migrated) >= 2
    sk = np.asarray(migrated[:2], np.int32)
    sv = np.stack([sk % 61 + 1, sk % 53 + 1], axis=1).astype(np.int32)
    _, _, res, _ = _set_both(mesh1, jrs, trs, sk, sv, neighborhood=H,
                             capacity=1)
    st, ok = res.status[0].numpy(), res.ok[0].numpy()
    assert tp.SET_NEEDS_DISPLACEMENT not in st.tolist()
    assert ok.sum() == 1 and int(res.dropped[0]) == 1
    assert st[~ok].tolist() == [0]


def test_set_migrating_escalates_old_to_new_frame(mesh1):
    """An old-frame write whose neighborhood is full escalates to the
    new-frame writer (the old frame never bubbles during growth), in both
    packages alike."""
    t = th.make_table(NB, V, neighborhood=H)
    homed = _keys_with_home(20, H + 1)
    for k in homed[:H]:
        assert t.insert(k, [k % 9 + 1, 3])
    jrs, trs = _begin_both(t)
    sk = np.asarray([homed[H]], np.int32)
    sv = np.asarray([[7, 7]], np.int32)
    _, jrs, res, trs = _set_both(mesh1, jrs, trs, sk, sv, neighborhood=H)
    assert int(res.status[0, 0]) == tp.SET_INSERTED
    assert homed[H] in trs.new_keys[0].tolist()


def test_escalated_lap_at_the_frame_end_is_vacated():
    """A quantum that runs past the frame end (watermark 2, step 8, n 8):
    its laps past bucket 7 clamp onto bucket 7, whose resident escalates
    through the displacer.  The port vacates that source bucket, as the
    host oracle does; the reference's scatter of the clamped duplicates
    writes the old key back last and leaves it behind the watermark
    (ROADMAP queue 3), so this case is held to the oracle, not to JAX."""
    n = 8
    kk = _keys_with_home(7, 1, n)[0]
    t = th.make_table(n, V, neighborhood=H)
    assert t.insert(kk, [3, 4]) and int(t.keys[7]) == kk
    hn = int(th.bucket_of(kk, 2 * n))
    new = th.make_table(2 * n, V, neighborhood=H)
    start = 1
    for d in range(H):
        want = (hn + d) % (2 * n)
        c = _keys_with_home(want, 1, 2 * n, start=start)[0]
        if c == kk:
            c = _keys_with_home(want, 1, 2 * n, start=c + 1)[0]
        start = c + 1
        assert new.insert(c, [c % 5 + 1, c % 3 + 1])
    old_ref, new_ref = _copy(t), _copy(new)
    pending = [b for b in range(2, n)
               if old_ref.migrate_bucket(new_ref, b) == th.MIG_NEEDS_DISPLACE]
    assert pending == [7]
    assert new_ref.set_full(kk, [3, 4]) == th.SET_DISPLACED
    old_ref.keys[7], old_ref.values[7] = 0, 0
    rs = tstore.ResizeState(_t(t.keys[None]), _t(t.values[None]),
                            _t(new.keys[None]), _t(new.values[None]),
                            torch.tensor([2], dtype=torch.int32))
    rs, rep = tstore.sharded_resize(rs, step=8, neighborhood=H,
                                    device="cpu")
    assert int(rep.escalated[0]) == 1 and int(rs.watermark[0]) == n
    np.testing.assert_array_equal(rs.keys[0].numpy(), old_ref.keys)
    np.testing.assert_array_equal(rs.new_keys[0].numpy(), new_ref.keys)
    np.testing.assert_array_equal(rs.new_vals[0].numpy(), new_ref.values)
    nk, _ = tstore.finish_resize(rs)
    assert kk in nk[0].tolist()
