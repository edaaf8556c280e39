"""Parity of the port's crash-resilient services (``rdma/failure.py``)
with the JAX package: ``DeviceResidentService`` serving through a host
crash, and ``ShardedKVService`` — ``set_reliable`` under each fault kind,
``ChainInterrupted`` with a clean store, the chained second growth, the
whole lifecycle with the driver dead from the start, delete racing the
migrator, auto-resize with every key served through the growth, racing
writer lanes and their conflict with faults, and the public surface.
Each case drives the same seeded calls through both packages' services
and compares every frame, deadline column, status and counter.  The cases
mirror ``tests/test_faults.py`` (service-level recovery),
``tests/test_lifecycle.py`` and ``tests/test_system.py``.  All state is
int32: tolerance 0."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _parity import fresh_jax_programs
from repro.core import faults as jfaults
from repro.data.pipeline import kv_request_stream as j_stream
from repro.kvstore import hopscotch as jh
from repro.kvstore import store as jstore
from repro.rdma import failure as jfail
from repro_torch.core import faults as tfaults
from repro_torch.core import programs as tp
from repro_torch.data.pipeline import kv_request_stream as t_stream
from repro_torch.kvstore import hopscotch as th
from repro_torch.kvstore import store as tstore
from repro_torch.rdma import failure as tfail

TERMINAL_SET = (tp.SET_UPDATED, tp.SET_INSERTED, tp.SET_DISPLACED)
COUNTERS = ("resizes_completed", "repairs_applied", "deletes_applied",
            "sweeps_reclaimed", "chained_growths")


_fresh_jax_programs = pytest.fixture(scope="module", autouse=True)(
    fresh_jax_programs)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _start(items, **kw):
    """The same service in both packages (no backoff sleeps)."""
    svcs = (jfail.ShardedKVService.start(items, **kw),
            tfail.ShardedKVService.start(items, device="cpu", **kw))
    for s in svcs:
        s.backoff_base_s = s.backoff_cap_s = 0.0
    return svcs


def _same_service(jsvc, tsvc, what=""):
    """Every frame, the deadline column, the resize state and the
    counters of the two services equal."""
    np.testing.assert_array_equal(_np(tsvc.keys), _np(jsvc.keys), what)
    np.testing.assert_array_equal(_np(tsvc.vals), _np(jsvc.vals), what)
    assert (tsvc.exp is None) == (jsvc.exp is None), what
    if tsvc.exp is not None:
        np.testing.assert_array_equal(_np(tsvc.exp), _np(jsvc.exp), what)
    assert (tsvc.resize is None) == (jsvc.resize is None), what
    if tsvc.resize is not None:
        for f, a, b in zip(tstore.ResizeState._fields, tsvc.resize,
                           jsvc.resize):
            np.testing.assert_array_equal(_np(a), _np(b), f"{what} {f}")
    for c in COUNTERS:
        assert getattr(tsvc, c) == getattr(jsvc, c), (what, c)
    assert tsvc.host_alive() == jsvc.host_alive()


def _same_result(got, want, what=""):
    for f, g, w in zip(type(got)._fields, got, want):
        np.testing.assert_array_equal(_np(g), _np(w), f"{what} {f}")


def _both(jsvc, tsvc, method, *args, **kw):
    """Call ``method`` on both services; their results must agree."""
    want = getattr(jsvc, method)(*args, **kw)
    got = getattr(tsvc, method)(*args, **kw)
    if isinstance(got, tuple) and hasattr(got, "_fields"):
        _same_result(got, want, method)
    else:
        assert got == want, (method, got, want)
    _same_service(jsvc, tsvc, method)
    return got


# --- the recycled get server through a host crash ----------------------------

def test_serving_survives_crash_under_load():
    """``tests/test_system.py``: Zipf gets keep succeeding while the host
    driver dies and returns, single and batched, equal to JAX's answers."""
    items = [(k, [k * 7, k * 11]) for k in range(1, 33)]
    jsvc = jfail.DeviceResidentService.start(items, n_buckets=64)
    tsvc = tfail.DeviceResidentService.start(items, n_buckets=64,
                                             device="cpu")
    jst, tst = j_stream(32, 16, seed=3), t_stream(32, 16, seed=3)
    for step in range(6):
        if step == 2:
            jsvc.crash_host()
            tsvc.crash_host()
            assert not tsvc.host_alive()
        if step == 4:
            jsvc.restart_host()
            tsvc.restart_host()
        _, jkeys = next(jst)
        _, keys = next(tst)
        np.testing.assert_array_equal(keys, jkeys)
        for k in keys[:4]:
            got = tsvc.get(int(k))
            np.testing.assert_array_equal(got, _np(jsvc.get(int(k))))
            assert got.tolist() == [int(k) * 7, int(k) * 11]
        got = tsvc.get_many(keys[4:12])
        np.testing.assert_array_equal(got, _np(jsvc.get_many(keys[4:12])))
        np.testing.assert_array_equal(got, np.stack(
            [[int(k) * 7, int(k) * 11] for k in keys[4:12]]))
    np.testing.assert_array_equal(_np(tsvc.server.state.mem),
                                  _np(jsvc.server.state.mem))
    assert tsvc.host_alive()
    assert (tsvc.cold_restart_downtime_s()
            == jsvc.cold_restart_downtime_s() == 2.25)


# --- service-level recovery --------------------------------------------------

def _service(items=None, **kw):
    items = items if items is not None else [(k, [k * 2, k * 2 + 1])
                                             for k in range(1, 7)]
    return _start(items, n_shards=1, buckets_per_shard=64, val_words=2,
                  **kw)


@pytest.mark.parametrize("kind,param,must_retry", [
    ("kill_at", 10, True), ("suppress_at", 5, True),
    ("cas_fail_at", 0, False), ("enable_zero_at", 0, True)])
def test_set_reliable_recovers_from_each_fault_kind(kind, param, must_retry):
    jsvc, tsvc = _service()
    key, value = 0x1234, [7, 8]
    want = jsvc.set_reliable(key, value,
                             faults=getattr(jfaults.FaultPlan, kind)(param))
    got = tsvc.set_reliable(key, value, faults=getattr(
        tfaults.FaultPlan, kind)(param, device="cpu"))
    assert got == want
    status, attempts = got
    assert status in TERMINAL_SET and attempts <= tsvc.retry_budget + 1
    if must_retry:
        assert attempts >= 2
    _same_service(jsvc, tsvc, kind)
    res = _both(jsvc, tsvc, "get_many", [key])
    assert bool(res.found[0, 0])
    np.testing.assert_array_equal(res.values[0, 0].numpy(), value)
    assert tsvc.fsck_and_repair().clean


def test_set_reliable_clean_path_is_one_attempt():
    jsvc, tsvc = _service()
    assert _both(jsvc, tsvc, "set_reliable", 0x4321, [9, 9]) == (
        tp.SET_INSERTED, 1)
    assert tsvc.repairs_applied == 0


def test_chain_interrupted_raised_with_clean_store():
    """Budget exhausted on an unplaceable key (full immovable
    neighborhood, growth off): the typed error carries the key and the
    attempt count, and the failed retries left the store fsck-clean."""
    homed = tstore.keys_homed_at(0, 9, 16)
    jsvc, tsvc = _start([(k, [k & 0xFF, 1]) for k in homed[:8]],
                        n_shards=1, buckets_per_shard=16, val_words=2)
    errs = []
    for svc, mod in ((jsvc, jfail), (tsvc, tfail)):
        svc.auto_resize = False
        svc.retry_budget = 1
        with pytest.raises(mod.ChainInterrupted) as ei:
            svc.set_reliable(homed[8], [2, 3])
        errs.append(ei.value)
    want, err = errs
    assert (err.key, err.attempts, err.last_status, err.fsck_clean) == (
        want.key, want.attempts, want.last_status, want.fsck_clean)
    assert str(err) == str(want)
    assert err.key == homed[8] and err.attempts == 2 and err.fsck_clean
    _same_service(jsvc, tsvc)
    found, _ = th.lookup(tsvc.keys[0], tsvc.vals[0],
                         torch.tensor(homed[:8], dtype=torch.int32), 8)
    assert bool(found.all())


def test_resize_dead_end_chains_second_growth():
    """A resident unplaceable even in the doubled frame: the doubled frame
    grows (2n -> 4n) with the driver dead, the parked resident lands
    there, and every key survives — the same frames as JAX's."""
    n = 8
    k0 = tstore.keys_homed_at(0, 1, n)[0]
    jsvc, tsvc = _start([(k0, [5, 5])], n_shards=1, buckets_per_shard=n,
                        val_words=2)
    nk = np.zeros((1, 2 * n), np.int32)
    nv = np.zeros((1, 2 * n, 2), np.int32)
    for b in range(2 * n):
        nk[0, b] = tstore.keys_homed_at(b, 1, 2 * n, start=0x1000)[0]
        nv[0, b] = [b + 1, 1]
    jsvc.resize = jstore.ResizeState(
        jsvc.keys, jsvc.vals, jnp.asarray(nk), jnp.asarray(nv),
        jnp.zeros((1,), jnp.int32))
    tsvc.resize = tstore.ResizeState(
        tsvc.keys, tsvc.vals, torch.from_numpy(nk), torch.from_numpy(nv),
        torch.zeros(1, dtype=torch.int32))
    for svc in (jsvc, tsvc):
        svc.crash_host()
        svc._advance_resize()
    _same_service(jsvc, tsvc)
    assert tsvc.resize is None and tsvc.chained_growths == 1
    assert tsvc.keys.shape[1] == 4 * n
    res = _both(jsvc, tsvc, "get_many",
                np.asarray([[k0] + nk[0].tolist()], np.int32))
    assert bool(res.found.all())


def test_auto_resize_serves_every_key_through_growth():
    """A 1-shard, 8-bucket service fills up: ``set_many`` answers
    SET_NEEDS_RESIZE, grows online (more than once) and every key stays
    served through the growth — each call equal to JAX's."""
    jsvc, tsvc = _start([(1, [1, 1])], n_shards=1, buckets_per_shard=8,
                        val_words=2)
    jsvc.resize_quantum = tsvc.resize_quantum = 4
    stored = {1: [1, 1]}
    rng = np.random.RandomState(3)
    for step in range(3):
        ks = rng.randint(2, 3000, (1, 6)).astype(np.int32)
        vs = np.stack([ks, ks + step], -1).astype(np.int32)
        res = _both(jsvc, tsvc, "set_many", ks, vs)
        for k, v, a in zip(ks[0], vs[0], res.applied[0].numpy()):
            if a:
                stored[int(k)] = v.tolist()
        q = np.asarray([list(stored)], np.int32)
        g = _both(jsvc, tsvc, "get_many", q)
        assert bool(g.found.all()), step
        np.testing.assert_array_equal(g.values[0].numpy(),
                                      np.asarray(list(stored.values())))
    _both(jsvc, tsvc, "drive_resize")
    assert tsvc.resizes_completed >= 2 and tsvc.keys.shape[1] >= 32


# --- §5.6 extended: the whole lifecycle with the driver dead -----------------

def test_full_lifecycle_with_driver_dead_from_start():
    """set -> get -> expire -> sweeper reclaim -> delete -> re-insert,
    every verb a chain execution, the driver dead before the first
    request; each step equal to JAX's service and the host oracle."""
    jsvc, tsvc = _start([(1, [11, 11]), (2, [22, 22])], n_shards=1,
                        buckets_per_shard=16, val_words=2, ttl=True)
    for svc in (jsvc, tsvc):
        svc.crash_host()
    oracle = th.make_table(16, 2, 8)
    th.insert_many(oracle, [1, 2], [[11, 11], [22, 22]])
    oexp = np.full(16, th.NO_TTL, np.int32)

    def check(now):
        q = [1, 2, 5]
        g = _both(jsvc, tsvc, "get_many", np.asarray([q], np.int32),
                  now=now)
        f, v = th.lookup_ttl(torch.from_numpy(oracle.keys),
                             torch.from_numpy(oracle.values),
                             torch.from_numpy(oexp),
                             torch.tensor(q, dtype=torch.int32), now, 8)
        np.testing.assert_array_equal(g.found[0].numpy(), f.numpy())
        np.testing.assert_array_equal(g.values[0].numpy(), v.numpy())

    res = _both(jsvc, tsvc, "set_many", np.asarray([[5]], np.int32),
                np.asarray([[[55, 56]]], np.int32),
                deadlines=np.asarray([[100]], np.int32))
    assert int(res.status[0, 0]) in TERMINAL_SET
    th.insert_many(oracle, [5], [[55, 56]])
    oexp[oracle.keys == 5] = 100
    check(now=50)
    check(now=150)
    rep = _both(jsvc, tsvc, "sweep", now=150, count=16)
    _, oexp = th.sweep_expired(oracle, oexp, 150, 0, 16)
    assert int(rep.reclaimed.sum()) == 1
    np.testing.assert_array_equal(tsvc.exp[0].numpy(), oexp)
    assert _both(jsvc, tsvc, "delete", 1)
    th.delete_many(oracle, [1])
    check(now=160)
    _both(jsvc, tsvc, "set_many", np.asarray([[1]], np.int32),
          np.asarray([[[77, 78]]], np.int32))
    th.insert_many(oracle, [1], [[77, 78]])
    check(now=170)
    np.testing.assert_array_equal(tsvc.keys[0].numpy(), oracle.keys)
    np.testing.assert_array_equal(tsvc.vals[0].numpy(), oracle.values)
    assert not tsvc.host_alive()


def test_ttl_gets_through_a_resize_window():
    """Deadlines stamped while the frames are doubled: expired hits are
    filtered during the window, and the cutover folds the stamps into
    the relocated deadline column — as in JAX."""
    jsvc, tsvc = _start([(k, [k, 1]) for k in range(1, 6)], n_shards=1,
                        buckets_per_shard=16, val_words=2, ttl=True)
    _both(jsvc, tsvc, "set_many", np.asarray([[3, 4]], np.int32),
          np.asarray([[[30, 3], [40, 4]]], np.int32),
          deadlines=np.asarray([[50, 500]], np.int32))
    jsvc.resize = jstore.begin_resize(jsvc.keys, jsvc.vals)
    tsvc.resize = tstore.begin_resize(tsvc.keys, tsvc.vals, device="cpu")
    for svc in (jsvc, tsvc):
        svc.resize_quantum = 4
        svc._park_exp()
    _both(jsvc, tsvc, "set_many", np.asarray([[9, 2]], np.int32),
          np.asarray([[[90, 9], [20, 2]]], np.int32),
          deadlines=np.asarray([[60, 70]], np.int32))
    g = _both(jsvc, tsvc, "get_many", np.asarray([[2, 3, 4, 9, 1]],
                                                 np.int32), now=65)
    assert g.found[0].tolist() == [True, False, True, False, True]
    _both(jsvc, tsvc, "drive_resize")
    g = _both(jsvc, tsvc, "get_many", np.asarray([[2, 3, 4, 9, 1]],
                                                 np.int32), now=65)
    assert g.found[0].tolist() == [True, False, True, False, True]


def test_delete_racing_migrator_no_resurrection():
    """A DELETE on a half-migrated store: the key's stale old-frame copy
    is deleted too, so the migrator cannot resurrect it at cutover."""
    n = 16
    homed = tstore.keys_homed_at(3, 4, n)
    jsvc, tsvc = _start([(int(k), [int(k) & 0xFF, 9]) for k in homed],
                        n_shards=1, buckets_per_shard=n, val_words=2)
    jsvc.resize = jstore.begin_resize(jsvc.keys, jsvc.vals)
    tsvc.resize = tstore.begin_resize(tsvc.keys, tsvc.vals, device="cpu")
    for svc in (jsvc, tsvc):
        svc.resize_quantum = 2
        svc._advance_resize()
    _same_service(jsvc, tsvc, "half-migrated")
    assert 0 < int(tsvc.resize.watermark[0]) < n
    victim = int(homed[0])
    res = _both(jsvc, tsvc, "delete_many", np.asarray([[victim]], np.int32))
    assert bool(res.applied[0, 0])
    _both(jsvc, tsvc, "drive_resize")
    assert tsvc.resize is None
    g = _both(jsvc, tsvc, "get_many",
              np.asarray([[victim] + [int(k) for k in homed[1:]]], np.int32))
    assert not bool(g.found[0, 0]), "deleted key resurrected"
    assert bool(g.found[0, 1:].all())


# --- racing writers through the service --------------------------------------

def test_service_writer_lanes_and_fault_conflict():
    """``n_writers = 2`` serves a racing batch equal to JAX's; a FaultPlan
    riding along raises the typed conflict instead of being dropped."""
    jsvc, tsvc = _start([(1, [1, 1])], n_shards=1, buckets_per_shard=16,
                        val_words=2)
    jsvc.n_writers = tsvc.n_writers = 2
    rows = np.full((1, 1, tfaults.FIELDS), tfaults.NONE, np.int32)
    rows[0, 0] = tfaults.FaultPlan.cas_fail_at(0, device="cpu").as_rows(
    ).numpy()
    plan = tfaults.FaultPlan.from_row(torch.from_numpy(rows))
    with pytest.raises(tstore.WriterFaultConflict):
        tsvc.set_many(np.asarray([[7]], np.int32),
                      np.asarray([[[7, 7]]], np.int32), faults=plan)
    homed = tstore.keys_homed_at(3, 5, 16)
    ks = np.asarray([homed], np.int32)
    res = _both(jsvc, tsvc, "set_many", ks,
                np.stack([ks, ks + 1], -1).astype(np.int32))
    assert set(res.status[0].tolist()) <= set(TERMINAL_SET)


def test_kvstore_public_surface():
    import repro_torch.kvstore as kvstore

    for name in ("GetResult", "SetResult", "DeleteResult", "SweepReport",
                 "Admission", "WriterFaultConflict", "STATUS_NAMES",
                 "status_name", "HopscotchTable", "ShardedKVService"):
        assert hasattr(kvstore, name), name
    assert kvstore.ShardedKVService is tfail.ShardedKVService
    assert kvstore.status_name(tp.DEL_DELETED) == "DEL_DELETED"
    assert kvstore.status_name(tp.SWEEP_RECLAIMED) == "SWEEP_RECLAIMED"
    assert set(kvstore.__all__) <= set(
        __import__("repro.kvstore", fromlist=["__all__"]).__all__)
    assert jh.STATUS_NAMES == th.STATUS_NAMES
