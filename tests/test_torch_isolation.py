"""Parity of the port's isolation layer with the JAX package: token-bucket
fairness between racing writers (``fair_quotas``: its rows, its burst cap,
its validation, a schedule it drives) and the §5.5 admission arm of
``sharded_get`` (``isolation=Admission(...)``) in both store modes, with
an explicit ``live`` composed in, over a greedy tenant's repeated calls,
and through the deprecated ``sharded_get_isolated`` shim — against JAX on
a 1-device mesh.  The cases mirror ``tests/test_multiwriter.py``'s
``fair_quotas`` tests and ``tests/test_lifecycle.py``'s shim test.  The
token buckets are float32 and compared bit for bit; the rest is int32 or
bool: tolerance 0."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from _parity import assert_states_equal, fresh_jax_programs
from repro.core import assembler as ja
from repro.core import machine as jm
from repro.kvstore import store as jstore
from repro.rdma import isolation as jiso
from repro_torch.core import assembler as ta
from repro_torch.core import machine as tm
from repro_torch.core import programs as tp
from repro_torch.kvstore import hopscotch as th
from repro_torch.kvstore import store as tstore
from repro_torch.rdma import failure as tfail
from repro_torch.rdma import isolation as tiso

V = 2


_fresh_jax_programs = pytest.fixture(scope="module", autouse=True)(
    fresh_jax_programs)


@pytest.fixture(scope="module")
def mesh1():
    return Mesh(np.array(jax.devices()[:1]), ("kv",))


def _t(a):
    return torch.from_numpy(np.array(a))


# --- fair_quotas: token buckets compiled to a Schedule -----------------------

@pytest.mark.parametrize("rates,n_rounds,burst", [
    ([2.0, 0.5], 4, None),
    ([3.0], 2, 1.0),
    ([8.0] * 4, 48, None),
    ([0.3, 1.7, 2.5], 9, 4.0),
    ([0.6, 1.0 / 3], 31, None),
])
def test_fair_quotas_rows_equal_jax(rates, n_rounds, burst):
    got = tiso.fair_quotas(rates, n_rounds, burst, device="cpu")
    want = jiso.fair_quotas(rates, n_rounds, burst)
    np.testing.assert_array_equal(got.as_rows().numpy(),
                                  np.asarray(want.as_rows()))
    assert got.quota.dtype == torch.int32
    assert (got.as_rows()[-1] == tm.SCHED_DRAIN).all()


def test_fair_quotas_fractional_rates_accumulate():
    rows = tiso.fair_quotas([2.0, 0.5], n_rounds=4, device="cpu").as_rows()
    assert rows[:, 0].tolist() == [2, 2, 2, 2, tm.SCHED_DRAIN]
    assert rows[:, 1].tolist() == [0, 1, 0, 1, tm.SCHED_DRAIN]
    capped = tiso.fair_quotas([3.0], n_rounds=2, burst=1.0, device="cpu")
    assert capped.as_rows()[:, 0].tolist() == [1, 1, tm.SCHED_DRAIN]


@pytest.mark.parametrize("args", [
    ([], 3, None), ([1.0, 0.0], 3, None), ([1.0], 0, None),
    ([0.25], 3, 0.75), ([[1.0, 2.0]], 3, None)])
def test_fair_quotas_validation_matches_jax(args):
    with pytest.raises(ValueError) as want:
        jiso.fair_quotas(*args)
    with pytest.raises(ValueError) as got:
        tiso.fair_quotas(*args, device="cpu")
    assert str(got.value) == str(want.value)


def test_fair_quotas_drives_run_scheduled():
    states = []
    for mod, m, iso, dev in ((ja, jm, jiso, {}),
                             (ta, tm, tiso, dict(device="cpu"))):
        p = mod.Program(256)
        cs = [p.word(0, "c0"), p.word(0, "c1")]
        for c in cs:
            wq = p.add_wq(4)
            for _ in range(4):
                wq.add(dst=c, addend=1)
        spec, st0 = p.finalize(**dev)
        states.append(m.run_scheduled(spec, st0, iso.fair_quotas(
            [1.0, 0.5], 2, **dev), ((0, 1), (1, 2))))
    assert_states_equal(*states)
    assert [int(states[1].mem[c]) for c in cs] == [4, 4]


# --- the isolation arm of sharded_get ----------------------------------------

def _table(n=16, items=((1, (11, 12)), (2, (21, 22)), (7, (71, 72)),
                        (9, (91, 92)))):
    t = th.make_table(n, V, 8)
    th.insert_many(t, [k for k, _ in items], [list(v) for _, v in items])
    return t


def _both_buckets(n_clients, burst):
    return (jiso.init(n_clients, burst),
            tiso.init(n_clients, burst, device="cpu"))


def _equal_result(got, want):
    res_g, b_g = got
    res_w, b_w = want
    for field, g, w in zip(tstore.GetResult._fields, res_g, res_w):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=field)
    for field, g, w in zip(tiso.BucketState._fields, b_g, b_w):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=field)


def test_isolated_get_greedy_tenant_over_calls(mesh1):
    """Four clients, one greedy (half the batch), served over six calls
    with the clock advancing: every call's admitted mask, answers and
    float32 buckets equal JAX's; the greedy tenant is deferred."""
    t = _table()
    keys, vals = t.keys[None], t.values[None]
    q = np.asarray([[1, 2, 7, 9, 5, 1, 2, 7, 9, 1, 2, 7, 3, 9, 1, 2]],
                   np.int32)
    clients = np.asarray([[0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 2, 2, 3, 0, 1, 3]],
                         np.int32)
    jb, tb = _both_buckets(4, burst=3.0)
    deferred = 0
    for step in range(6):
        now = 10.0 * step + 0.25
        want = jstore.sharded_get(
            mesh1, "kv", jnp.asarray(keys), jnp.asarray(vals),
            jnp.asarray(q), isolation=jstore.Admission(
                jnp.asarray(clients), jb, now, 0.07, 3.0))
        got = tstore.sharded_get(
            _t(keys), _t(vals), _t(q), isolation=tstore.Admission(
                _t(clients), tb, now, 0.07, 3.0), device="cpu")
        _equal_result(got, want)
        jb, tb = want[1], got[1]
        res = got[0]
        deferred += int(res.deferred.sum())
        # admitted hits are the oracle's answers
        f, v = th.lookup(_t(t.keys), _t(t.values), _t(q[0]), 8)
        ok = res.ok[0]
        np.testing.assert_array_equal(res.found[0][ok].numpy(),
                                      f[ok].numpy())
        np.testing.assert_array_equal(res.values[0][ok].numpy(),
                                      v[ok].numpy())
    assert deferred > 0
    greedy = clients[0] == 0
    assert int(res.ok[0][torch.from_numpy(greedy)].sum()) < greedy.sum()


def test_isolated_get_composes_with_live(mesh1):
    t = _table()
    q = np.asarray([[1, 2, 7, 9, 4, 1]], np.int32)
    clients = np.asarray([[0, 1, 0, 1, 0, 1]], np.int32)
    live = np.asarray([[True, True, False, True, True, False]])
    jb, tb = _both_buckets(2, burst=2.0)
    want = jstore.sharded_get(
        mesh1, "kv", jnp.asarray(t.keys[None]), jnp.asarray(t.values[None]),
        jnp.asarray(q), live=jnp.asarray(live),
        isolation=jstore.Admission(jnp.asarray(clients), jb, 5.0, 0.1, 2.0))
    got = tstore.sharded_get(
        _t(t.keys[None]), _t(t.values[None]), _t(q), live=_t(live),
        isolation=tstore.Admission(_t(clients), tb, 5.0, 0.1, 2.0),
        device="cpu")
    _equal_result(got, want)
    assert not bool(got[0].ok[0, 2]) and not bool(got[0].ok[0, 5])


def test_isolated_get_on_a_resize_state(mesh1):
    """The admission stage in front of the double-frame get."""
    t = _table()
    jrs = jstore.begin_resize(jnp.asarray(t.keys[None]),
                              jnp.asarray(t.values[None]))
    jrs, _ = jstore.sharded_resize(mesh1, "kv", jrs, step=4, neighborhood=8)
    trs = tstore.ResizeState(*(_t(np.asarray(a)) for a in jrs))
    q = np.asarray([[1, 2, 7, 9, 5, 1, 2, 7]], np.int32)
    clients = np.asarray([[0, 0, 0, 0, 0, 1, 1, 1]], np.int32)
    jb, tb = _both_buckets(2, burst=2.0)
    want = jstore.sharded_get(mesh1, "kv", jrs, jnp.asarray(q),
                              isolation=jstore.Admission(
                                  jnp.asarray(clients), jb, 1.0, 0.5, 2.0))
    got = tstore.sharded_get(trs, _t(q), isolation=tstore.Admission(
        _t(clients), tb, 1.0, 0.5, 2.0), device="cpu")
    _equal_result(got, want)


def test_get_shim_isolated_bit_exact_and_deprecated(mesh1):
    t = _table()
    keys, vals = t.keys[None], t.values[None]
    q = np.asarray([[1, 2, 7, 9]], np.int32)
    clients = np.asarray([[0, 0, 1, 1]], np.int32)
    args = dict(now_us=10.0, rate_per_us=0.1, burst=2.0)
    _, tb = _both_buckets(2, burst=2.0)
    res_new, b_new = tstore.sharded_get(
        _t(keys), _t(vals), _t(q),
        isolation=tstore.Admission(_t(clients), tb, **args), device="cpu")
    with pytest.warns(DeprecationWarning, match="sharded_get_isolated"):
        res_old, b_old = tstore.sharded_get_isolated(
            _t(keys), _t(vals), _t(q), _t(clients), tb, device="cpu",
            **args)
    for a, b in zip(res_new, res_old):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(b_new.tokens.numpy(), b_old.tokens.numpy())
    with pytest.warns(DeprecationWarning):
        want = jstore.sharded_get_isolated(
            mesh1, "kv", jnp.asarray(keys), jnp.asarray(vals),
            jnp.asarray(q), jnp.asarray(clients), jiso.init(2, 2.0), **args)
    _equal_result((res_old, b_old), want)


# --- entry points default to the card ----------------------------------------

def test_new_entry_points_need_the_card_or_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda d: tm.Schedule.serialized(2, **d),
        lambda d: tm.Schedule.round_robin(2, 4, 2, **d),
        lambda d: tm.Schedule.cut(3, **d),
        lambda d: tiso.fair_quotas([1.0, 2.0], 3, **d),
        lambda d: tp.build_multi_writer_group(16, 2, 4, 2, **d),
        lambda d: tp.build_cas_retry_pair(**d),
        lambda d: tfail.ShardedKVService.start([(1, [1, 2])], **d),
        lambda d: tfail.DeviceResidentService.start([(1, [1, 2])], **d),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call({})
        call(dict(device="cpu"))
