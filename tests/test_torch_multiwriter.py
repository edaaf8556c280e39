"""Parity of the port's racing writers with the JAX package: the
``Schedule`` constructors, ``run_scheduled`` (drain, zero quota, exact
quota, an unsliced WQ, round robin, ``fair_quotas``) and
``ChainEngine.run_interleaved``, the CAS-retry race, the multi-writer
group (word-identical images for every lane mix, the 2-writer cut-point
sweeps of insert vs insert and delete vs set, the serialized schedule,
a sweep lane racing a SET), and ``sharded_set(n_writers=2/4)`` — at S = 1
and, per owner, at S = 4 — against JAX's on a 1-device mesh.  The cases
mirror ``tests/test_multiwriter.py``, ``tests/test_faults.py``'s
interleaving sweep and ``tests/test_lifecycle.py``'s racing lanes.  The
port runs every cut of a sweep as one batch of machines; JAX runs the
smoke cuts one by one.  All state is int32 and the clocks float32:
tolerance 0."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from _parity import assert_states_equal, fresh_jax_programs
from repro.core import assembler as ja
from repro.core import constructs as jc
from repro.core import isa as jisa
from repro.core import machine as jm
from repro.core import programs as jp
from repro.core.engine import ChainEngine as JEngine
from repro.kvstore import store as jstore
from repro.rdma import isolation as jiso
from repro_torch import convert
from repro_torch.core import assembler as ta
from repro_torch.core import constructs as tc
from repro_torch.core import isa as tisa
from repro_torch.core import machine as tm
from repro_torch.core import programs as tp
from repro_torch.core.engine import ChainEngine as TEngine
from repro_torch.kvstore import fsck as tfsck
from repro_torch.kvstore import hopscotch as th
from repro_torch.kvstore import store as tstore
from repro_torch.rdma import isolation as tiso

TERMINAL_SET = (tp.SET_UPDATED, tp.SET_INSERTED, tp.SET_DISPLACED)


_fresh_jax_programs = pytest.fixture(scope="module", autouse=True)(
    fresh_jax_programs)


@pytest.fixture(scope="module")
def mesh1():
    return Mesh(np.array(jax.devices()[:1]), ("kv",))


def _t(a):
    return torch.from_numpy(np.array(a))


def _rows(sched):
    return np.asarray(sched.as_rows().cpu() if isinstance(
        sched.quota, torch.Tensor) else sched.as_rows())


def _port_schedule(jsched):
    return tm.Schedule.from_rows(_rows(jsched), device="cpu")


# --- Schedule: constructors and row plumbing ---------------------------------

def test_schedule_serialized_rows():
    for args in ((3,), (2, (1, 0)), (4, (2, 0, 3))):
        got = _rows(tm.Schedule.serialized(*args, device="cpu"))
        np.testing.assert_array_equal(got, _rows(jm.Schedule.serialized(
            *args)))
    rows = _rows(tm.Schedule.serialized(3, device="cpu"))
    for r in range(3):
        assert rows[r, r] == tm.SCHED_DRAIN
        assert (np.delete(rows[r], r) == 0).all()


def test_schedule_round_robin_has_drain_tail():
    s = tm.Schedule.round_robin(2, quantum=5, n_rounds=3, device="cpu")
    rows = _rows(s)
    np.testing.assert_array_equal(rows, _rows(jm.Schedule.round_robin(
        2, quantum=5, n_rounds=3)))
    assert (rows[:3] == 5).all() and (rows[3] == tm.SCHED_DRAIN).all()
    assert s.n_rounds == 4 and s.n_writers == 2


def test_schedule_cut_shape_and_roundtrip():
    s = tm.Schedule.cut(torch.tensor(7, dtype=torch.int32))
    rows = _rows(s)
    np.testing.assert_array_equal(rows, _rows(jm.Schedule.cut(
        jnp.int32(7))))
    rt = tm.Schedule.from_rows(rows, device="cpu")
    np.testing.assert_array_equal(_rows(rt), rows)
    # a tensor of cuts is a batch of plans, one per cut
    batch = tm.Schedule.cut(torch.arange(5, dtype=torch.int32), 3)
    assert tuple(batch.quota.shape) == (5, 4, 3)
    assert batch.n_rounds == 4 and batch.n_writers == 3
    for c in range(5):
        np.testing.assert_array_equal(
            _rows(batch)[c], _rows(jm.Schedule.cut(jnp.int32(c), 3)))


# --- run_scheduled: quota semantics over a toy two-writer program ------------

def _two_counters(mod, n_adds=4, **dev):
    """Two private counters, one WQ each: writer w ADDs 1 to counter w,
    n_adds times."""
    p = mod.Program(256)
    c0 = p.word(0, "c0")
    c1 = p.word(0, "c1")
    for c in (c0, c1):
        wq = p.add_wq(n_adds)
        for _ in range(n_adds):
            wq.add(dst=c, addend=1)
    spec, st0 = p.finalize(**dev)
    return spec, st0, (c0, c1)


SCHEDULES = {
    # name: (JAX schedule, writer slices, counters after, steps)
    "serialized": (lambda: jm.Schedule.serialized(2), ((0, 1), (1, 2)),
                   (4, 4), 8),
    "zero_quota": (lambda: jm.Schedule.from_rows(
        [[jm.SCHED_DRAIN, 0]]), ((0, 1), (1, 2)), (4, 0), 4),
    "exact_quota": (lambda: jm.Schedule.from_rows([[3, 1], [1, 0]]),
                    ((0, 1), (1, 2)), (4, 1), 5),
    "unsliced_wq": (lambda: jm.Schedule.serialized(1), ((0, 1),),
                    (4, 0), 4),
    "round_robin": (lambda: jm.Schedule.round_robin(2, 2, 3),
                    ((0, 1), (1, 2)), (4, 4), 8),
    "fair_quotas": (lambda: jiso.fair_quotas([1.0, 1.0], 2),
                    ((0, 1), (1, 2)), (4, 4), 8),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_run_scheduled_matches_jax(name):
    make, slices, counts, steps = SCHEDULES[name]
    jspec, jst, (c0, c1) = _two_counters(ja)
    tspec, tst, _ = _two_counters(ta, device="cpu")
    jsched = make()
    want = jm.run_scheduled(jspec, jst, jsched, slices)
    got = tm.run_scheduled(tspec, tst, _port_schedule(jsched), slices)
    assert_states_equal(want, got)
    assert (int(got.mem[c0]), int(got.mem[c1])) == counts
    assert int(got.steps) == steps


def test_run_scheduled_batch_follows_each_rows_plan():
    """A (B, R, W) quota: each machine of the batch runs its own plan,
    bit-equal to that plan run alone in JAX."""
    jspec, jst, _ = _two_counters(ja)
    tspec, tst, _ = _two_counters(ta, device="cpu")
    plans = [[[3, 1], [1, 0]], [[jm.SCHED_DRAIN, 0], [0, 2]],
             [[0, 0], [0, 0]], [[1, 1], [jm.SCHED_DRAIN, jm.SCHED_DRAIN]]]
    batch = tm.VMState(*(a.unsqueeze(0).expand((len(plans),) + a.shape)
                         for a in tst))
    got = tm.run_scheduled(tspec, batch, tm.Schedule.from_rows(plans),
                           ((0, 1), (1, 2)))
    for b, plan in enumerate(plans):
        want = jm.run_scheduled(jspec, jst, jm.Schedule.from_rows(plan),
                                ((0, 1), (1, 2)))
        assert_states_equal(want, tm.VMState(*(a[b] for a in got)))


def test_run_interleaved_matches_run_scheduled():
    tspec, tst, _ = _two_counters(ta, device="cpu")
    sched = tm.Schedule.round_robin(2, quantum=2, n_rounds=3, device="cpu")
    a = TEngine.for_spec(tspec).run_interleaved(tst, sched,
                                                ((0, 1), (1, 2)))
    b = tm.run_scheduled(tspec, tst, sched, ((0, 1), (1, 2)))
    np.testing.assert_array_equal(a.mem.numpy(), b.mem.numpy())


def test_run_interleaved_rejects_kernel_backend():
    for mod, eng_cls, backend, dev in (
            (ja, JEngine, "pallas-interpret", {}),
            (ta, TEngine, "kernel", dict(device="cpu"))):
        p = mod.Program(128)
        x = p.word(0)
        p.add_wq(2).write_imm(dst=x, value=1)
        spec, st0 = p.finalize(**dev)
        eng = eng_cls.for_spec(spec, backend=backend)
        sched = (jm.Schedule.serialized(1) if mod is ja
                 else tm.Schedule.serialized(1, device="cpu"))
        with pytest.raises(ValueError, match="interp backend"):
            eng.run_interleaved(st0, sched, ((0, 1),))


# --- CAS-retry loop: schedule-dependent outcomes, both linearizable ----------

def _retry_vs_releaser(mod, cons, isa, **dev):
    """Writer 0 retry-claims a cell that starts OCCUPIED (9); writer 1
    writes it free.  Whether writer 0 lands the claim depends on when the
    scheduler runs the releaser relative to its bounded attempts."""
    p = mod.Program(1024)
    cell = p.word(9, "cell")
    mark = p.word(0, "mark")
    tmpl = p.alloc(2 * isa.WR_WORDS, [
        isa.pack_ctrl(isa.WRITE_IMM, 0), isa.FLAG_SUPPRESS_COMPLETION,
        -1, mark, 1, 1, 0, -1,
        isa.pack_ctrl(isa.NOOP, 0), isa.FLAG_SUPPRESS_COMPLETION,
        0, 0, 1, 0, 0, -1], "tmpl")
    ctl = p.add_wq(8, ordering=isa.ORD_DOORBELL)
    mod_wq = p.add_wq(6, ordering=isa.ORD_DOORBELL, managed=True,
                      initial_enable=0)
    refs = cons.emit_cas_retry_loop(
        ctl, mod_wq, cell=cell, expect=0, new=1, template=tmpl, attempts=2)
    rel = p.add_wq(1)
    rel.write_imm(dst=cell, value=0, tag="release")
    spec, st0 = p.finalize(**dev)
    assert refs.exhausted_count == 6
    return spec, st0, cell, mark


@pytest.mark.parametrize("rows,mark", [
    # the releaser runs after writer 0 exhausted both attempts
    ([[jm.SCHED_DRAIN, 0], [0, jm.SCHED_DRAIN]], 0),
    # 6 steps = attempt 0 failing; the releaser frees the cell; attempt 1
    ([[6, 0], [0, jm.SCHED_DRAIN],
      [jm.SCHED_DRAIN, jm.SCHED_DRAIN]], 1),
])
def test_cas_retry_race_matches_jax(rows, mark):
    jspec, jst, cell, mark_w = _retry_vs_releaser(ja, jc, jisa)
    tspec, tst, _, _ = _retry_vs_releaser(ta, tc, tisa, device="cpu")
    assert_states_equal(jst, tst)
    slices = ((0, 2), (2, 3))
    want = jm.run_scheduled(jspec, jst, jm.Schedule.from_rows(rows), slices)
    got = tm.run_scheduled(tspec, tst, tm.Schedule.from_rows(rows), slices)
    assert_states_equal(want, got)
    assert int(got.mem[mark_w]) == mark
    assert int(got.mem[cell]) == mark


def test_cas_retry_pair_image_and_every_cut():
    """The two-writer retry pair: the same image, and every cut of writer
    0 (one port batch) equal to JAX's run of that cut; exactly one writer
    wins the cell at every cut."""
    jpair = jp.build_cas_retry_pair(attempts=2)
    tpair = tp.build_cas_retry_pair(attempts=2, device="cpu")
    assert_states_equal(jpair.state0, tpair.state0)
    assert convert.spec_from_tuple(jpair.spec) == tpair.spec
    assert (tpair.cell, tpair.marks, tpair.writer_slices, tpair.fuel) == (
        jpair.cell, jpair.marks, jpair.writer_slices, jpair.fuel)
    cuts = np.arange(tpair.fuel + 1, dtype=np.int32)
    batch = tm.VMState(*(a.unsqueeze(0).expand((len(cuts),) + a.shape)
                         for a in tpair.state0))
    got = tm.run_scheduled(tpair.spec, batch, tm.Schedule.cut(_t(cuts)),
                           tpair.writer_slices, tpair.fuel)
    for c in cuts[::3]:
        want = jm.run_scheduled(jpair.spec, jpair.state0,
                                jm.Schedule.cut(jnp.int32(c)),
                                jpair.writer_slices, jpair.fuel)
        assert_states_equal(want, tm.VMState(*(a[c] for a in got)))
    marks = got.mem[:, list(tpair.marks)].numpy()
    assert ((marks != 0).sum(1) == 1).all()
    np.testing.assert_array_equal(got.mem[:, tpair.cell].numpy(),
                                  marks.sum(1))


# --- the multi-writer group --------------------------------------------------

LANE_MIXES = {
    "set2": (16, 2, 4, 2, None),
    "set4_h8": (32, 2, 8, 4, None),
    "set_delete": (16, 2, 4, 2, ("set", "delete")),
    "set_sweep": (16, 2, 4, 2, ("set", "sweep")),
    "mix4_v3": (16, 3, 4, 4, ("delete", "set", "sweep", "set")),
}


@pytest.mark.parametrize("name", sorted(LANE_MIXES))
def test_group_image_equal(name):
    n, v, h, w, kinds = LANE_MIXES[name]
    jg = jp.build_multi_writer_group(n, v, h, w, kinds)
    tg = tp.build_multi_writer_group(n, v, h, w, kinds, device="cpu")
    assert convert.spec_from_tuple(jg.spec) == tg.spec
    assert_states_equal(jg.state0, tg.state0)
    for f in ("n_buckets", "val_len", "neighborhood", "n_writers",
              "table_base", "values_base", "lanes", "writer_slices",
              "lane_kinds", "resp_words", "fuel", "writer_fuel"):
        assert getattr(tg, f) == getattr(jg, f), f
    assert tg.prog.budget() == jg.prog.budget()


def test_group_build_bounds_match():
    for m, d in ((jp, {}), (tp, dict(device="cpu"))):
        for args in ((16, 2, 4, 0), (16, 2, 4, 2, ("set",)),
                     (16, 2, 4, 2, ("set", "get")), (16, 8, 8, 2)):
            with pytest.raises(ValueError):
                m.build_multi_writer_group(*args, **d)


def _mw_scenario():
    """n=16, H=4: two distinct keys homed at the same bucket, racing for
    the two free slots of a half-full neighborhood."""
    n, v, h = 16, 2, 4
    homed = tstore.keys_homed_at(3, 4, n)
    keys0 = np.zeros(n, np.int32)
    vals0 = np.zeros((n, v), np.int32)
    for b, k in zip((3, 4), homed[:2]):
        keys0[b] = k
        vals0[b] = [k & 0xFF, b]
    return n, v, h, keys0, vals0, homed[2], homed[3]


def _writer_oracles(tw, keys0, vals0, steps):
    """Sequential single-writer outcomes of each order of ``steps``."""
    outs = {}
    for name, order in steps.items():
        k, v = _t(keys0), _t(vals0)
        for run in order:
            k, v = run(k, v)
        outs[name] = (k.numpy(), v.numpy())
    return outs


def _set_step(tw, q, value):
    n = tw.n_buckets

    def run(k, v):
        pay = tw.device_payloads(_t([q]), th.bucket_of(_t([q]), n),
                                 _t([value]))[0]
        st, k, v = tw.run_one(k, v, pay, max_steps=tw.fuel)
        assert int(st) in TERMINAL_SET
        return k, v
    return run


def _both_groups(n, v, h, kinds=None):
    return (jp.build_multi_writer_group(n, v, neighborhood=h, n_writers=2,
                                        lane_kinds=kinds),
            tp.build_multi_writer_group(n, v, neighborhood=h, n_writers=2,
                                        lane_kinds=kinds, device="cpu"))


def _sweep_both(jg, tg, keys0, vals0, pay, oracles, h, check):
    """Every cut 0..writer_fuel through the port as ONE batch; JAX at the
    smoke cuts; each cut terminal, fsck-clean and on an oracle."""
    fuel = tg.writer_fuel
    cuts = np.arange(fuel + 1, dtype=np.int32)
    g = len(cuts)
    st, k, v = tg.run_group(
        _t(keys0).expand(g, -1), _t(vals0).expand(g, -1, -1),
        pay.expand(g, -1, -1), tm.Schedule.cut(_t(cuts)), tg.fuel)
    for c in sorted(set(list(range(0, fuel + 1, 7)) + [fuel])):
        js, jk, jv = jg.run_group(
            jnp.asarray(keys0), jnp.asarray(vals0), jnp.asarray(pay.numpy()),
            jm.Schedule.cut(jnp.int32(c)), jg.fuel)
        np.testing.assert_array_equal(st[c].numpy(), np.asarray(js))
        np.testing.assert_array_equal(k[c].numpy(), np.asarray(jk))
        np.testing.assert_array_equal(v[c].numpy(), np.asarray(jv))
    diverged = []
    for c in range(g):
        check(c, st[c].numpy())
        rep = tfsck.check_invariants(k[c][None], v[c][None], neighborhood=h)
        assert rep.clean, (c, rep)
        if not any((k[c].numpy() == ok).all() and (v[c].numpy() == ov).all()
                   for ok, ov in oracles.values()):
            diverged.append(c)
    assert diverged == [], f"non-linearizable cuts: {diverged}"
    return st, k, v


def test_insert_race_every_cut_linearizable():
    """``tests/test_faults.py``'s 2-writer cut-point sweep: two keys
    homed at one bucket race for its last two free slots; every cut
    commits bit-exactly the AB or the BA oracle."""
    n, v, h, keys0, vals0, qa, qb = _mw_scenario()
    jg, tg = _both_groups(n, v, h)
    tw = tp.build_hopscotch_writer(n, v, neighborhood=h, device="cpu")
    sa, sb = (_set_step(tw, q, [q & 0xFF, q >> 4]) for q in (qa, qb))
    oracles = _writer_oracles(tw, keys0, vals0,
                              {"AB": (sa, sb), "BA": (sb, sa)})
    assert oracles["AB"][0].tolist() != oracles["BA"][0].tolist()
    qs = _t([qa, qb])
    pay = tg.device_payloads(qs, th.bucket_of(qs, n),
                             _t([[qa & 0xFF, qa >> 4], [qb & 0xFF, qb >> 4]]))

    def terminal(c, st):
        assert all(int(s) in TERMINAL_SET for s in st), (c, st)
    st, k, _ = _sweep_both(jg, tg, keys0, vals0, pay, oracles, h, terminal)
    # both orders occur across the sweep
    hits = {name for name, (ok, _) in oracles.items()
            for c in range(k.shape[0]) if (k[c].numpy() == ok).all()}
    assert hits == {"AB", "BA"}


def test_serialized_schedule_matches_sequential_oracle():
    n, v, h, keys0, vals0, qa, qb = _mw_scenario()
    jg, tg = _both_groups(n, v, h)
    tw = tp.build_hopscotch_writer(n, v, neighborhood=h, device="cpu")
    sa, sb = (_set_step(tw, q, [q & 0xFF, q >> 4]) for q in (qa, qb))
    oracles = _writer_oracles(tw, keys0, vals0,
                              {"AB": (sa, sb), "BA": (sb, sa)})
    qs = _t([qa, qb])
    pay = tg.device_payloads(qs, th.bucket_of(qs, n),
                             _t([[qa & 0xFF, qa >> 4], [qb & 0xFF, qb >> 4]]))
    for name, order in (("AB", (0, 1)), ("BA", (1, 0))):
        js, jk, jv = jg.run_group(
            jnp.asarray(keys0), jnp.asarray(vals0), jnp.asarray(pay.numpy()),
            jm.Schedule.serialized(2, order=order), jg.fuel)
        st, k, vv = tg.run_group(_t(keys0), _t(vals0), pay,
                                 tm.Schedule.serialized(2, order=order,
                                                        device="cpu"),
                                 tg.fuel)
        np.testing.assert_array_equal(st.numpy(), np.asarray(js))
        np.testing.assert_array_equal(k.numpy(), oracles[name][0])
        np.testing.assert_array_equal(vv.numpy(), oracles[name][1])
        np.testing.assert_array_equal(k.numpy(), np.asarray(jk))


def test_delete_vs_set_every_cut_linearizable():
    """``tests/test_lifecycle.py``'s delete-vs-set sweep: the two
    sequential orders differ (delete-first frees the home bucket), and
    every cut commits one of them."""
    n, v, h = 16, 2, 4
    jg, tg = _both_groups(n, v, h, ("set", "delete"))
    homed = tstore.keys_homed_at(3, 4, n)
    keys0 = np.zeros(n, np.int32)
    vals0 = np.zeros((n, v), np.int32)
    for b, k in zip((3, 4, 5), homed[:3]):     # one free slot (bucket 6)
        keys0[b] = k
        vals0[b] = [k & 0xFF, b]
    set_key, del_key = homed[3], homed[0]
    tw = tp.build_hopscotch_writer(n, v, neighborhood=h, device="cpu")
    td = tp.build_hopscotch_deleter(n, v, neighborhood=h, device="cpu")

    def run_del(k, vv):
        pay = td.device_payloads(_t([del_key]),
                                 th.bucket_of(_t([del_key]), n))[0]
        st, k, vv = td.run_one(k, vv, pay, td.fuel)
        assert int(st) == tp.DEL_DELETED
        return k, vv
    run_set = _set_step(tw, set_key, [set_key & 0xFF, 99])
    oracles = _writer_oracles(tw, keys0, vals0, {
        "set-del": (run_set, run_del), "del-set": (run_del, run_set)})
    assert oracles["set-del"][0].tolist() != oracles["del-set"][0].tolist()
    pay_set = tg.device_payloads(_t([set_key]),
                                 th.bucket_of(_t([set_key]), n),
                                 _t([[set_key & 0xFF, 99]]))[0]
    pay_del = tg.device_delete_payloads(_t([del_key]),
                                        th.bucket_of(_t([del_key]), n))[0]
    pay_del = torch.nn.functional.pad(pay_del,
                                      (0, pay_set.shape[0] - len(pay_del)))
    pay = torch.stack([pay_set, pay_del])

    def statuses(c, st):
        assert int(st[0]) in TERMINAL_SET and int(st[1]) == tp.DEL_DELETED, \
            (c, st)
    _sweep_both(jg, tg, keys0, vals0, pay, oracles, h, statuses)


def test_sweeper_lane_under_fair_quotas_with_racing_set():
    """A SET lane and a SWEEP lane interleave over the shared image under
    ``fair_quotas``: both terminal, the expired bucket reclaimed, the new
    key landed, fsck-clean — and equal to JAX's run, clocks included."""
    n, v, h = 16, 2, 4
    jg, tg = _both_groups(n, v, h, ("set", "sweep"))
    t = th.make_table(n, v, h)
    th.insert_many(t, [1, 2, 7], [[11, 12], [21, 22], [71, 72]])
    exp = np.full(n, th.NO_TTL, np.int32)
    victim = int(np.flatnonzero(t.keys == 7)[0])
    exp[victim] = 50
    pay_set = tg.device_payloads(_t([9]), th.bucket_of(_t([9]), n),
                                 _t([[91, 92]]))[0]
    pay_swp = tg.device_sweep_payloads(_t([victim]), now=100)[0]
    np.testing.assert_array_equal(
        pay_swp.numpy(),
        np.asarray(jg.device_sweep_payloads(jnp.asarray([victim]),
                                            now=100)[0]))
    pay_swp = torch.nn.functional.pad(pay_swp,
                                      (0, pay_set.shape[0] - len(pay_swp)))
    pay = torch.stack([pay_set, pay_swp])
    want = jg.run_group(jnp.asarray(t.keys), jnp.asarray(t.values),
                        jnp.asarray(pay.numpy()),
                        jiso.fair_quotas([1.0, 1.0], n_rounds=jg.fuel),
                        jg.fuel, exp=jnp.asarray(exp))
    sched = tiso.fair_quotas([1.0, 1.0], n_rounds=tg.fuel, device="cpu")
    got = tg.run_group(_t(t.keys), _t(t.values), pay, sched, tg.fuel,
                       exp=_t(exp))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    st, nk, nv, ne = (a.numpy() for a in got)
    assert int(st[0]) in TERMINAL_SET and int(st[1]) == tp.SWEEP_RECLAIMED
    assert (nk == 9).any() and not (nk == 7).any()
    assert ne[victim] == th.NO_TTL
    assert tfsck.check_invariants(_t(nk[None]), _t(nv[None]),
                                  neighborhood=h, exp=_t(ne[None])).clean


def test_hot_key_hammer_clocks_match_jax():
    """``benchmarks/write_contention.py``'s hammer at 4 writers: every key
    homed at one bucket, ``fair_quotas([8] * 4, 48)``; the whole final
    machine (per-writer completion clocks included) equals JAX's, and the
    best/worst completion ratio stays under 2."""
    n, v, h, w = 32, 2, 8, 4
    qs = tstore.keys_homed_at(3, w, n)
    jg = jp.build_multi_writer_group(n, v, neighborhood=h, n_writers=w)
    tg = tp.build_multi_writer_group(n, v, neighborhood=h, n_writers=w,
                                     device="cpu")
    q = _t(qs)
    pay = tg.device_payloads(q, th.bucket_of(q, n),
                             _t([[k & 0xFF, k >> 4] for k in qs]))
    jst = jg.device_state(jnp.zeros(n, jnp.int32),
                          jnp.zeros((n, v), jnp.int32))
    for lane, (rq, _) in enumerate(jg.lanes):
        jst = jm.deliver(jst, rq, jnp.asarray(pay[lane].numpy()))
    want = jm.run_scheduled(jg.spec, jst, jiso.fair_quotas([8.0] * w, 48),
                            jg.writer_slices, jg.fuel)
    tst = tg.delivered_state(torch.zeros((1, n), dtype=torch.int32),
                             torch.zeros((1, n, v), dtype=torch.int32),
                             pay[None])
    got = tm.run_scheduled(tg.spec, tm.VMState(*(a[0] for a in tst)),
                           tiso.fair_quotas([8.0] * w, 48, device="cpu"),
                           tg.writer_slices, tg.fuel)
    assert_states_equal(want, got)
    finish = [float(got.last_comp_time[lo:hi].max())
              for lo, hi in tg.writer_slices]
    assert max(finish) / min(finish) <= 2.0
    assert all(int(got.mem[r]) in TERMINAL_SET for _, r in tg.lanes)


# --- sharded_set with racing writer lanes ------------------------------------

NB, H, V = 32, 4, 2


def _crowded_table(seed, n_keys=14):
    kv = jstore.ShardedKV.build(1, NB, V, neighborhood=H)
    rng = np.random.RandomState(seed)
    for k in rng.choice(np.arange(1, 5000), n_keys, replace=False):
        kv.set(int(k), [int(k) % 7, 1])
    return [np.asarray(a) for a in kv.device_arrays()]


@pytest.mark.parametrize("n_writers", [2, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_sharded_set_n_writers_matches_jax(mesh1, n_writers, seed):
    """A hot batch at S = 1 — keys homed in four buckets of a crowded
    table, so lanes race, rows escalate to the displacer and some need a
    resize — bit-equal to JAX's."""
    keys, vals = _crowded_table(seed)
    rng = np.random.RandomState(100 + seed)
    sk = np.array([[tstore.keys_homed_at(int(b), 1, NB, start=int(s))[0]
                    for b, s in zip(rng.randint(0, 4, 10),
                                    rng.randint(1, 9000, 10))]], np.int32)
    sk[0, 7] = 0                               # an unused slot
    sv = np.stack([sk % 97, sk % 13], -1).astype(np.int32)
    live = np.ones_like(sk, bool)
    live[0, 2] = False
    want = jstore.sharded_set(mesh1, "kv", jnp.asarray(keys),
                              jnp.asarray(vals), jnp.asarray(sk),
                              jnp.asarray(sv), neighborhood=H,
                              live=jnp.asarray(live), n_writers=n_writers)
    got = tstore.sharded_set(_t(keys), _t(vals), _t(sk), _t(sv),
                             neighborhood=H, live=_t(live),
                             n_writers=n_writers, device="cpu")
    for field, g, w in zip(tstore.SetResult._fields, got[0], want[0]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=field)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    st = got[0].status.numpy()[0]
    assert tp.SET_NEEDS_DISPLACEMENT not in st.tolist()
    assert set(st[got[0].ok.numpy()[0]].tolist()) <= set(TERMINAL_SET) | {
        tp.SET_NEEDS_RESIZE}


@pytest.mark.parametrize("n_writers", [2, 4])
def test_s4_sharded_set_n_writers_matches_jax_per_owner(mesh1, n_writers):
    """S = 4 with full windows (every source sends exactly two requests to
    every owner), so each owner's window is its rows in source order with
    no hole: each owner's statuses and table equal JAX's sharded_set of
    that window at S = 1.  Some owners' neighborhoods are full, so rows
    escalate through the displacer."""
    s, cap, nb = 4, 2, 32
    rng = np.random.RandomState(7)
    tables, want_tables = [], []
    for d in range(s):
        t = th.make_table(nb, V, neighborhood=H)
        for b in range(5 + d, 5 + d + H):      # each resident at home
            k = tstore.keys_homed_at(b, 1, nb, start=1 + 1000 * d)[0]
            assert t.insert(k, [k % 9 + 1, d])
        tables.append(t)
    keys = np.stack([t.keys for t in tables])
    vals = np.stack([t.values for t in tables])
    sk = np.zeros((s, s * cap), np.int32)
    start = 20000
    for src in range(s):
        for d in range(s):
            for c in range(cap):
                home = 5 + d if (src + c) % 2 == 0 else int(
                    rng.randint(0, nb))
                k = tstore.keys_homed_at(home, 1, nb, start=start,
                                         n_shards=s, shard=d)[0]
                start = k + 1
                sk[src, d * cap + c] = k
    sv = np.stack([sk % 61 + 1, sk % 53 + 1], -1).astype(np.int32)
    got, nk, nv = tstore.sharded_set(_t(keys), _t(vals), _t(sk), _t(sv),
                                     neighborhood=H, n_writers=n_writers,
                                     device="cpu")
    assert got.ok.numpy().all()
    escalated = 0
    for d in range(s):
        # owner d's window: each source's two rows to d, sources in order
        wk = sk[:, d * cap:(d + 1) * cap].reshape(1, -1)
        wv = sv[:, d * cap:(d + 1) * cap].reshape(1, -1, V)
        res, jk, jv = jstore.sharded_set(
            mesh1, "kv", jnp.asarray(keys[d:d + 1]),
            jnp.asarray(vals[d:d + 1]), jnp.asarray(wk), jnp.asarray(wv),
            neighborhood=H, n_writers=n_writers)
        np.testing.assert_array_equal(
            got.status.numpy()[:, d * cap:(d + 1) * cap].reshape(-1),
            np.asarray(res.status)[0])
        np.testing.assert_array_equal(nk.numpy()[d], np.asarray(jk)[0])
        np.testing.assert_array_equal(nv.numpy()[d], np.asarray(jv)[0])
        escalated += int((np.asarray(res.status) == tp.SET_DISPLACED).sum())
    assert escalated > 0


def test_uniform_batch_equals_single_writer():
    """Keys with disjoint home neighborhoods never race: the racing lanes
    commit exactly what the serialized writer commits."""
    s, nb = 4, 64
    kv = tstore.ShardedKV.build(s, nb, V, neighborhood=H)
    sk = np.zeros((s, 8), np.int32)
    for src in range(s):
        for c in range(8):
            home = (src * 8 + c) * 2 % nb
            d = c % s
            sk[src, c] = tstore.keys_homed_at(home, 1, nb, start=1 + 997 * c,
                                              n_shards=s, shard=d)[0]
    sv = np.stack([sk % 31, sk % 29], -1).astype(np.int32)
    dk, dv = kv.device_arrays("cpu")
    one = tstore.sharded_set(dk, dv, _t(sk), _t(sv), neighborhood=H,
                             device="cpu")
    for w in (2, 4):
        many = tstore.sharded_set(dk, dv, _t(sk), _t(sv), neighborhood=H,
                                  n_writers=w, device="cpu")
        for a, b in zip(one[0], many[0]):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        for a, b in zip(one[1:], many[1:]):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_n_writers_and_faults_conflict_first():
    from repro_torch.core import faults as tf
    keys = torch.zeros((1, 16), dtype=torch.int32)
    vals = torch.zeros((1, 16, 2), dtype=torch.int32)
    plan = tf.FaultPlan.cas_fail_at(0, shape=(1, 1), device="cpu")
    with pytest.raises(tstore.WriterFaultConflict) as ei:
        # the conflict outranks even the bad deadlines/exp pairing
        tstore.sharded_set(keys, vals, _t([[9]]), _t([[[1, 2]]]),
                           n_writers=2, faults=plan,
                           deadlines=_t([[5]]), device="cpu")
    assert isinstance(ei.value, ValueError) and ei.value.n_writers == 2
    with pytest.raises(ValueError, match="n_writers"):
        tstore.sharded_set(keys, vals, _t([[9]]), _t([[[1, 2]]]),
                           n_writers=0, device="cpu")
