"""Parity of the port's fault injection with the JAX package: the
``FaultPlan`` rows and the seeded storm, the four fault kinds in the
interpreter (every VMState field, float32 clocks included, against JAX's
on the same programs), kill-fault parity of the ``"kernel"`` backend
(its plain version on the CPU) with the interpreter and with JAX's Pallas
kernel in interpret mode, the cut-point sweeps of the writer, displacer
and migration lap (the torn arrays, fsck reports and repairs at every cut
equal to JAX's), and the faulted sharded SET and resize paths at S = 1
against JAX's on a 1-device mesh.  The cases mirror ``tests/test_faults.py``
minus the service tests (``rdma/failure.py`` is not ported) and the
racing-writer sweeps.  ``test_pallas_rejects_traced_fault_params`` has no
counterpart: the port's plans are plain tensors, never traced values, so
there is nothing to reject.  All state is int32 or bit-compared float32:
tolerance 0."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from _parity import (RANDOM_SPEC, assert_states_equal, fresh_jax_programs,
                     random_program_state, stack, to_torch)
from repro.core import assembler as jasm
from repro.core import faults as jf
from repro.core import machine as jm
from repro.core import programs as jp
from repro.core.engine import ChainEngine as JEngine
from repro.kvstore import fsck as jfsck
from repro.kvstore import hopscotch as jh
from repro.kvstore import store as jstore
from repro_torch import convert
from repro_torch.core import assembler as tasm
from repro_torch.core import faults as tf
from repro_torch.core import machine as tm
from repro_torch.core import programs as tp
from repro_torch.core.engine import ChainEngine as TEngine
from repro_torch.kvstore import fsck as tfsck
from repro_torch.kvstore import hopscotch as th
from repro_torch.kvstore import store as tstore

TERMINAL_SET = (tp.SET_UPDATED, tp.SET_INSERTED, tp.SET_DISPLACED)
TERMINAL_MIG = (tp.MIG_MOVED, tp.MIG_DISCARDED)


_fresh_jax_programs = pytest.fixture(scope="module", autouse=True)(
    fresh_jax_programs)


def _t(a):
    return torch.from_numpy(np.array(a))


def _equal(got, want, what=""):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=f"{what}[{i}]")


def _plan_both(rows):
    """One packed (..., 4) numpy array as a plan of each package."""
    rows = np.array(rows, np.int32)
    return (jf.FaultPlan.from_row(jnp.asarray(rows)),
            tf.FaultPlan.from_row(torch.from_numpy(rows)))


@pytest.fixture(scope="module")
def mesh1():
    return Mesh(np.array(jax.devices()[:1]), ("kv",))


# --- FaultPlan basics --------------------------------------------------------

def test_fault_plan_row_roundtrip():
    p = tf.FaultPlan(*(torch.tensor(x, dtype=torch.int32)
                       for x in (3, -1, 0, -1)))
    row = p.as_rows()
    assert row.shape == (tf.FIELDS,) and row.dtype == torch.int32
    q = tf.FaultPlan.from_row(row)
    assert [int(x) for x in q] == [3, -1, 0, -1]
    assert bool(p.active())
    assert not bool(tf.FaultPlan.none(device="cpu").active())
    assert tf.NONE == jf.NONE and tf.FIELDS == jf.FIELDS


def test_constructors_match_jax():
    for name, arg in (("kill_at", 5), ("suppress_at", 2), ("cas_fail_at", 0),
                      ("enable_zero_at", 1)):
        want = getattr(jf.FaultPlan, name)(arg, shape=(3,)).as_rows()
        got = getattr(tf.FaultPlan, name)(arg, shape=(3,), device="cpu")
        np.testing.assert_array_equal(got.as_rows().numpy(),
                                      np.asarray(want))
        assert got.kill_step.dtype == torch.int32
    np.testing.assert_array_equal(
        tf.FaultPlan.none((2, 3), device="cpu").as_rows().numpy(),
        np.asarray(jf.FaultPlan.none((2, 3)).as_rows()))


def test_kill_lap_plan_shape_and_semantics():
    p = tf.FaultPlan.kill_lap(6, lap=2, step=9, device="cpu")
    assert p.kill_step.tolist() == [-1, -1, 9, 0, 0, 0]
    assert p.active().tolist() == [False, False] + [True] * 4
    np.testing.assert_array_equal(
        p.as_rows().numpy(),
        np.asarray(jf.FaultPlan.kill_lap(6, lap=2, step=9).as_rows()))


def test_storm_is_seed_deterministic_and_matches_jax(monkeypatch):
    for seed, kw in ((7, {}), (20260807, dict(p_fault=0.5, max_step=60)),
                     (3, dict(kinds=("kill",)))):
        a = tf.storm(64, seed=seed, device="cpu", **kw)
        np.testing.assert_array_equal(
            a.as_rows().numpy(), np.asarray(jf.storm(64, seed=seed,
                                                     **kw).as_rows()))
    c = tf.storm(64, seed=8, device="cpu")
    assert not torch.equal(tf.storm(64, seed=7, device="cpu").as_rows(),
                           c.as_rows())
    monkeypatch.setenv("FAULT_SEED", "12345")
    assert tf.storm_seed() == 12345
    assert torch.equal(tf.storm(64, device="cpu").as_rows(),
                       tf.storm(64, seed=12345, device="cpu").as_rows())


def test_kernel_supported_predicate():
    for name, arg, ok in (("kill_at", 5, True), ("suppress_at", 5, False),
                          ("cas_fail_at", 0, False),
                          ("enable_zero_at", 0, False)):
        plan = getattr(tf.FaultPlan, name)(arg, device="cpu")
        assert plan.kernel_supported() is ok
        assert getattr(jf.FaultPlan, name)(arg).pallas_supported() is ok
    assert tf.FaultPlan.none(device="cpu").kernel_supported()


def test_plans_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tf.FaultPlan.none()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tf.storm(4, seed=1)


# --- machine-level fault semantics -------------------------------------------

def _three_writes(asm, device=None):
    p = asm.Program(256)
    words = tuple(p.word(0) for _ in range(4))
    wq = p.add_wq(4)
    wq.write_imm(dst=words[0], value=11)
    wq.write_imm(dst=words[1], value=22)
    r2 = wq.write_imm(dst=words[2], value=33)
    gated = p.add_wq(2)
    gated.wait_for(r2)
    gated.write_imm(dst=words[3], value=44)
    spec, st = p.finalize() if device is None else p.finalize(device=device)
    return spec, st, words


def _straight_writes(asm, device=None):
    p = asm.Program(256)
    words = [p.word(0) for _ in range(3)]
    wq = p.add_wq(4)
    for i, w in enumerate(words):
        wq.write_imm(dst=w, value=11 * (i + 1))
    spec, st = p.finalize() if device is None else p.finalize(device=device)
    return spec, st, words


def _cas_prog(asm, device=None):
    p = asm.Program(256)
    x, ret = p.word(5), p.word(0)
    wq = p.add_wq(2)
    wq.cas(dst=x, old=5, new=99, ret=ret)
    spec, st = p.finalize() if device is None else p.finalize(device=device)
    return spec, st, (x, ret)


def _enable_prog(asm, device=None):
    p = asm.Program(256)
    d = p.word(0)
    gated = p.add_wq(2, managed=True, ordering=jm.isa.ORD_DOORBELL,
                     initial_enable=0)
    gated.write_imm(dst=d, value=7)
    ctl = p.add_wq(2)
    ctl.enable(gated, upto=1)
    spec, st = p.finalize() if device is None else p.finalize(device=device)
    return spec, st, (d,)


def _run_both(build, row, max_steps):
    """One program under one fault row (or none) through both packages;
    every field must agree.  Returns the port's final state and words."""
    jspec, jst, words = build(jasm)
    tspec, tst, _ = build(tasm, "cpu")
    jplan = None if row is None else jf.FaultPlan(
        *(jnp.int32(x) for x in row))
    tplan = None if row is None else tf.FaultPlan(
        *(torch.tensor(x, dtype=torch.int32) for x in row))
    want = jm.run(jspec, jst, max_steps, faults=jplan)
    got = tm.run(tspec, tst, max_steps, faults=tplan)
    assert_states_equal(want, got)
    return got, words


def test_kill_truncates_at_exact_step():
    for k in range(4):
        out, words = _run_both(_straight_writes, (k, -1, -1, -1), 16)
        assert [int(out.mem[w]) for w in words] == [
            11 * (i + 1) if i < k else 0 for i in range(3)]
        assert int(out.steps) == k


def test_suppress_drops_effect_and_completion():
    out, (a, b, c, d) = _run_both(_three_writes, (-1, 0, -1, -1), 16)
    assert int(out.mem[a]) == 0
    assert int(out.mem[b]) == 22 and int(out.mem[c]) == 33
    assert int(out.mem[d]) == 0             # the WAIT starves
    assert int(out.verb_counts[jm.isa.NOOP]) == 1
    clean, _ = _run_both(_three_writes, None, 16)
    assert int(clean.mem[d]) == 44


def test_cas_fault_forces_compare_miss():
    out, (x, ret) = _run_both(_cas_prog, (-1, -1, 0, -1), 8)
    assert int(out.mem[x]) == 5 and int(out.mem[ret]) == 5
    clean, _ = _run_both(_cas_prog, None, 8)
    assert int(clean.mem[x]) == 99


def test_enable_zero_loses_the_doorbell():
    out, (d,) = _run_both(_enable_prog, (-1, -1, -1, 0), 8)
    assert int(out.mem[d]) == 0
    clean, _ = _run_both(_enable_prog, None, 8)
    assert int(clean.mem[d]) == 7


def test_disarmed_plan_is_bit_exact_with_clean_run():
    tspec, tst, _ = _three_writes(tasm, "cpu")
    clean = tm.run(tspec, tst, 16)
    off = tm.run(tspec, tst, 16, faults=tf.FaultPlan.none(device="cpu"))
    assert_states_equal(jm.run(*_three_writes(jasm)[:2], 16), off)
    for f in tm.VMState._fields:
        assert torch.equal(getattr(clean, f), getattr(off, f)), f


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_programs_under_random_plans(seed):
    """Random multi-WQ programs, each row under its own random plan of all
    four kinds (ordinals and steps small enough to fire): every field,
    clocks included, equal to JAX's.  The rows' compaction inside the
    port's loop must keep each row's ordinals."""
    rng = np.random.RandomState(seed)
    n = 24
    batch = stack([random_program_state(rng) for _ in range(n)])
    rows = np.stack([rng.randint(-1, 12, n), rng.randint(-1, 12, n),
                     rng.randint(-1, 3, n), rng.randint(-1, 3, n)],
                    axis=1).astype(np.int32)
    jplan, tplan = _plan_both(rows)
    want = jm.run_batch(RANDOM_SPEC, batch, 40, jplan)
    got = tm.run_batch(convert.spec_from_tuple(RANDOM_SPEC), to_torch(batch),
                       40, tplan)
    assert_states_equal(want, got)


def _recycled(n_buckets=16):
    js = jp.build_recycled_get_server(n_buckets=n_buckets, val_len=2)
    ts = tp.build_recycled_get_server(n_buckets=n_buckets, val_len=2,
                                      device="cpu")
    for k in range(1, 11):
        js.insert(k, [k * 11, k * 11 + 1])
        ts.insert(k, [k * 11, k * 11 + 1])
    js.load()
    ts.load()
    return js, ts


def test_serve_stream_with_faults_matches_jax():
    js, ts = _recycled(8)
    keys = [1, 3, 100, 6, 2, 9]
    pay = np.asarray([js._payload(k) for k in keys], np.int32)
    rows = np.full((len(keys), 4), -1, np.int32)
    rows[1, 0] = 3          # killed mid-lap: its effects persist
    rows[3, 1] = 2
    rows[4, 2] = 0
    jplan, tplan = _plan_both(rows)
    jst, jv = JEngine.for_spec(js.spec).serve_stream(
        js.state, js.loop_wq, pay, js.resp_region, 2, 64, jplan)
    tst, tv = TEngine.for_spec(ts.spec).serve_stream(
        ts.state, ts.loop_wq, pay, ts.resp_region, 2, 64, tplan)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert_states_equal(jst, tst)


# --- the kernel backend (its plain version on the CPU) ----------------------

def _straight_line(asm, device=None):
    p = asm.Program(256)
    x, y = p.word(5), p.word(0)
    wq = p.add_wq(8)
    wq.read(src=x, dst=y)
    wq.add(dst=y, addend=10)
    wq.cas(dst=y, old=15, new=99)
    wq.max_(dst=y, operand=120)
    wq.min_(dst=y, operand=60)
    return p.finalize() if device is None else p.finalize(device=device)


@pytest.mark.parametrize("k", [0, 2, 4, 99])
def test_kernel_kill_parity_bit_exact(k):
    jspec, jst = _straight_line(jasm)
    tspec, tst = _straight_line(tasm, "cpu")
    jb = jax.tree_util.tree_map(lambda a: jnp.stack([a] * 3), jst)
    tb = to_torch(jb)
    jrows = jf.FaultPlan.kill_at(k, shape=(3,))
    trows = tf.FaultPlan.kill_at(k, shape=(3,), device="cpu")
    out_j = JEngine.for_spec(jspec, "pallas-interpret").run_batch(
        jb, 16, jrows)
    out_i = TEngine.for_spec(tspec).run_batch(tb, 16, trows)
    out_k = TEngine.for_spec(tspec, "kernel").run_batch(tb, 16, trows)
    assert_states_equal(out_j, out_k)
    for f in ("mem", "steps", "head", "completions", "halted"):
        assert torch.equal(getattr(out_i, f), getattr(out_k, f)), f


def test_kill_on_a_reused_state_matches_each_reference_backend():
    """A state whose ``steps`` counter is already 5, killed at step 3: the
    interpreter stops at once (its kill compares the cumulative counter),
    the kernel's per-row fuel runs 3 WRs.  The reference's backends
    disagree here (ROADMAP queue 3); the port matches each of them."""
    jspec, jst = _straight_line(jasm)
    tspec, _ = _straight_line(tasm, "cpu")
    jb = jax.tree_util.tree_map(lambda a: jnp.stack([a]), jst)._replace(
        steps=jnp.asarray([5], jnp.int32))
    jplan = jf.FaultPlan.kill_at(3, shape=(1,))
    tplan = tf.FaultPlan.kill_at(3, shape=(1,), device="cpu")
    want_i = JEngine.for_spec(jspec).run_batch(jb, 16, jplan)
    want_k = JEngine.for_spec(jspec, "pallas-interpret").run_batch(
        jb, 16, jplan)
    got_i = TEngine.for_spec(tspec).run_batch(to_torch(jb), 16, tplan)
    got_k = TEngine.for_spec(tspec, "kernel").run_batch(to_torch(jb), 16,
                                                         tplan)
    assert_states_equal(want_i, got_i)
    assert_states_equal(want_k, got_k)
    assert int(got_i.head[0, 0]) == 0 and int(got_k.head[0, 0]) == 3


def test_kernel_kill_rows_on_run_many_match_interp():
    """Per-row kill steps (one row disarmed) through the recycled server's
    run_many: the kernel backend equals the interpreter on every field it
    models, and JAX's Pallas kernel in interpret mode."""
    js, ts = _recycled()
    keys = [1, 4, 1000, 7, 2, 9, 3]
    pay = np.asarray([js._payload(k) for k in keys], np.int32)
    rows = np.full((len(keys), 4), -1, np.int32)
    rows[:, 0] = [0, 3, 5, -1, 64, 11, 1]
    jplan, tplan = _plan_both(rows)
    want = JEngine.for_spec(js.spec, "pallas-interpret").run_many(
        js.state, js.loop_wq, pay, 64, jplan)
    got = TEngine.for_spec(ts.spec, "kernel").run_many(
        ts.state, ts.loop_wq, pay, 64, tplan)
    assert_states_equal(want, got)
    interp = TEngine.for_spec(ts.spec).run_many(ts.state, ts.loop_wq, pay,
                                                64, tplan)
    assert_states_equal(JEngine.for_spec(js.spec).run_many(
        js.state, js.loop_wq, pay, 64, jplan), interp)
    for f in ("mem", "head", "enable_limit", "completions", "msg_head",
              "halted", "responses", "steps"):
        assert torch.equal(getattr(got, f), getattr(interp, f)), f


def test_kernel_rejects_unsupported_fault_kinds():
    tspec, tst = _straight_line(tasm, "cpu")
    eng = TEngine.for_spec(tspec, "kernel")
    batch = tm.VMState(*(a[None] for a in tst))
    for name in ("suppress_at", "cas_fail_at", "enable_zero_at"):
        plan = getattr(tf.FaultPlan, name)(1, shape=(1,), device="cpu")
        with pytest.raises(ValueError, match="suppress|truncation"):
            eng.run_batch(batch, 16, plan)
    js, ts = _recycled()
    pay = np.asarray([js._payload(1)], np.int32)
    with pytest.raises(ValueError, match="suppress|truncation"):
        TEngine.for_spec(ts.spec, "kernel").run_many(
            ts.state, ts.loop_wq, pay, 64,
            tf.FaultPlan.suppress_at(1, shape=(1,), device="cpu"))


# --- cut-point sweeps: kill every step, repair, converge to the oracle -------

def _writer_scenario(mod, **kw):
    n, v, h = 16, 2, 4
    w = mod.build_hopscotch_writer(n, v, neighborhood=h, **kw)
    homed = tstore.keys_homed_at(3, 3, n)
    keys0 = np.zeros(n, np.int32)
    vals0 = np.zeros((n, v), np.int32)
    for b, k in zip((3, 4), homed[:2]):
        keys0[b] = k
        vals0[b] = [k & 0xFF, b]
    return w, h, keys0, vals0, homed[2], [77, 78]


def _displacer_scenario(mod, **kw):
    n, v, h = 16, 2, 4
    d = mod.build_hopscotch_displacer(n, v, neighborhood=h, max_search=16,
                                      max_moves=8, **kw)
    homed3 = tstore.keys_homed_at(3, 4, n)
    homed6 = tstore.keys_homed_at(6, 1, n)
    keys0 = np.zeros(n, np.int32)
    vals0 = np.zeros((n, v), np.int32)
    for b, k in zip((3, 4, 5), homed3[:3]):
        keys0[b] = k
        vals0[b] = [k & 0xFF, b]
    keys0[6] = homed6[0]
    vals0[6] = [homed6[0] & 0xFF, 6]
    return d, h, keys0, vals0, homed3[3], [91, 92]


def _jax_cuts(run_one_faulted, cuts):
    """JAX's faulted run at every cut, as one vmapped call over the kill
    step (the reference's plans are traced values, so one compile serves
    every cut).  Returns numpy arrays with a leading cut dim."""
    out = jax.jit(jax.vmap(run_one_faulted))(jnp.asarray(cuts, jnp.int32))
    return [np.asarray(a) for a in out]


def _stacked(a, g):
    """``g`` copies of a numpy array as one tensor (one machine each)."""
    return _t(np.repeat(np.asarray(a)[None], g, axis=0))


def _sweep_writer_like(scenario, cuts):
    """Kill a SET chain at each cut in both packages: the torn status and
    arrays, the fsck report and the repaired arrays must be equal, and the
    retry must land on the host oracle.  The port runs every cut at
    once, one machine (and one fsck shard) per cut; JAX runs them one by
    one.  Returns the number of cuts that produced a torn state."""
    jprog, h, keys0, vals0, q, qval = scenario(jp)
    tprog = scenario(tp, device="cpu")[0]
    oracle = th.HopscotchTable(keys0.copy(), vals0.copy(), h)
    assert int(th.insert_many_displaced(oracle, [q], [np.asarray(qval)])[0]) \
        in TERMINAL_SET
    home = [th.bucket_of(q, len(keys0))]
    jpay = jprog.device_payloads(jnp.asarray([q]), jnp.asarray(home),
                                 jnp.asarray([qval]))[0]
    tpay = tprog.device_payloads(torch.tensor([q]), torch.tensor(home),
                                 torch.tensor([qval]))
    fuel = tprog.fuel
    assert fuel == jprog.fuel
    cuts = list(cuts)
    g = len(cuts)
    want = _jax_cuts(lambda k: jprog.run_one_faulted(
        jnp.asarray(keys0), jnp.asarray(vals0), jpay, fuel,
        jf.FaultPlan.kill_at(k)), cuts)
    plan = tf.FaultPlan.none((g,), device="cpu")._replace(
        kill_step=torch.tensor(cuts, dtype=torch.int32))
    pays = tpay.expand(g, -1)
    st, tk, tv, _ = tprog.run_rows_faulted(
        _stacked(keys0, g), _stacked(vals0, g), pays, fuel, plan)
    _equal((st, tk, tv), want, "torn")
    rep = tfsck.check_invariants(tk, tv, neighborhood=h)
    assert rep == jfsck.check_invariants(want[1], want[2], neighborhood=h)
    assert rep.repairable, rep
    jk, jv, jact = jfsck.repair(jnp.asarray(want[1]), jnp.asarray(want[2]),
                                rep, neighborhood=h)
    tk, tv, tact = tfsck.repair(tk, tv, rep, neighborhood=h)
    assert tact == jact
    _equal((tk, tv), (jk, jv), "repaired")
    assert tfsck.check_invariants(tk, tv, neighborhood=h).clean
    # unconditional retry: an idempotent same-value update for a chain
    # that finished, the roll-forward for a torn one
    st2, rk, rv, _ = tprog.run_rows(tk, tv, pays, fuel)
    assert np.isin(st2.numpy(), TERMINAL_SET).all(), st2
    for i, cut in enumerate(cuts):
        np.testing.assert_array_equal(rk[i].numpy(), oracle.keys,
                                      err_msg=f"cut={cut}")
        np.testing.assert_array_equal(rv[i].numpy(), oracle.values,
                                      err_msg=f"cut={cut}")
    return len({v.shard for v in rep.violations})


def test_writer_cutpoint_sweep_smoke():
    fuel = _writer_scenario(tp, device="cpu")[0].fuel
    _sweep_writer_like(_writer_scenario,
                       sorted(set(list(range(0, fuel + 1, 7)) + [fuel])))


@pytest.mark.slow
def test_writer_cutpoint_sweep_full():
    fuel = _writer_scenario(tp, device="cpu")[0].fuel
    _sweep_writer_like(_writer_scenario, range(fuel + 1))


def test_displacer_cutpoint_sweep_smoke():
    fuel = _displacer_scenario(tp, device="cpu")[0].fuel
    cuts = sorted(set(list(range(0, fuel + 1, 37)) + list(range(180, 200))
                      + [fuel]))
    assert _sweep_writer_like(_displacer_scenario, cuts) > 0


def _migrator_scenario(mod, **kw):
    n, v, h = 8, 2, 4
    m = mod.build_hopscotch_migrator(n, v, neighborhood=h, **kw)
    k2 = tstore.keys_homed_at(2, 1, n)[0]
    k5 = tstore.keys_homed_at(5, 1, n)[0]
    ok0 = np.zeros(n, np.int32)
    ov0 = np.zeros((n, v), np.int32)
    ok0[2], ov0[2] = k2, [21, 22]
    ok0[5], ov0[5] = k5, [51, 52]
    return m, h, ok0, ov0


def _sweep_migrator(cuts):
    """The migration lap killed at each cut in both packages (the port's
    cuts as one batch): torn frames, fsck reports and repairs equal, and
    the re-driven lap lands on the ``migrate_bucket`` oracle."""
    jm_, h, ok0, ov0 = _migrator_scenario(jp)
    tm_ = _migrator_scenario(tp, device="cpu")[0]
    n = len(ok0)
    to = th.HopscotchTable(ok0.copy(), ov0.copy(), h)
    tn = th.make_table(2 * n, ov0.shape[1], h)
    assert to.migrate_bucket(tn, 2) == tp.MIG_MOVED
    frames = (ok0, ov0, np.zeros(2 * n, np.int32),
              np.zeros((2 * n, ov0.shape[1]), np.int32))
    fuel = tm_.fuel
    cuts = list(cuts)
    g = len(cuts)
    jpay = jm_.device_payloads(jnp.asarray([2]), jnp.asarray(ok0))[0]
    tpay = tm_.device_payloads(torch.tensor([2]), _t(ok0))
    want = _jax_cuts(lambda k: jm_.run_one_faulted(
        *map(jnp.asarray, frames), jpay, fuel, jf.FaultPlan.kill_at(k)),
        cuts)
    plan = tf.FaultPlan.none((g,), device="cpu")._replace(
        kill_step=torch.tensor(cuts, dtype=torch.int32))
    got = tm_.run_rows_faulted(*(_stacked(a, g) for a in frames),
                               tpay.expand(g, -1), fuel, plan)
    _equal(got[:5], want, "torn")
    wm = np.zeros(g, np.int32)
    jrs = jstore.ResizeState(*map(jnp.asarray, want[1:]), jnp.asarray(wm))
    trs = tstore.ResizeState(*got[1:5], _t(wm))
    rep = tfsck.check_invariants(resize=trs, neighborhood=h)
    assert rep == jfsck.check_invariants(resize=jrs, neighborhood=h)
    assert rep.repairable, rep
    jrs, jact = jfsck.repair_resize(jrs, rep, neighborhood=h)
    trs, tact = tfsck.repair_resize(trs, rep, neighborhood=h)
    assert tact == jact
    _equal(trs, jrs, "repaired")
    assert tfsck.check_invariants(resize=trs, neighborhood=h).clean
    # re-drive while the source bucket is live: a MIG_MOVED response lands
    # before the copy/vacate tail; a zero payload is an inert lap
    pay = tm_.device_payloads(torch.full((g, 1), 2), trs.keys)[:, 0]
    st2, *out = tm_.run_rows(*trs[:4], pay, fuel)[:5]
    redriven = (trs.keys[:, 2] != th.EMPTY).numpy()
    assert np.isin(st2.numpy()[redriven], TERMINAL_MIG).all(), st2
    for i, cut in enumerate(cuts):
        for a, b in zip(out, (to.keys, to.values, tn.keys, tn.values)):
            np.testing.assert_array_equal(a[i].numpy(), b,
                                          err_msg=f"cut={cut}")
    return len({v.shard for v in rep.violations})


def test_migration_lap_cutpoint_sweep_smoke():
    fuel = _migrator_scenario(tp, device="cpu")[0].fuel
    _sweep_migrator(sorted(set(list(range(0, fuel + 1, 5)) + [fuel])))


@pytest.mark.slow
def test_migration_lap_cutpoint_sweep_full():
    fuel = _migrator_scenario(tp, device="cpu")[0].fuel
    assert _sweep_migrator(range(fuel + 1)) > 0


# --- faulted sharded paths ---------------------------------------------------

def _set_both(mesh1, keys, vals, sk, sv, rows=None, **kw):
    """``sharded_set`` at S = 1 through both packages, under the same
    packed fault rows (or none): results and arrays equal."""
    jkw, tkw = dict(kw), dict(kw)
    if rows is not None:
        jkw["faults"], tkw["faults"] = _plan_both(rows)
    jres, jk, jv = jstore.sharded_set(mesh1, "kv", jnp.asarray(keys),
                                      jnp.asarray(vals), jnp.asarray(sk),
                                      jnp.asarray(sv), **jkw)
    tres, tk, tv = tstore.sharded_set(_t(keys), _t(vals), _t(sk), _t(sv),
                                      device="cpu", **tkw)
    _equal(tres, jres, "set result")
    _equal((tk, tv), (jk, jv), "set arrays")
    return tres, tk, tv


def test_sharded_set_disarmed_plan_bit_exact(mesh1):
    keys, vals = np.zeros((1, 32), np.int32), np.zeros((1, 32, 2), np.int32)
    sk = np.asarray([[0x101, 0x202, 0x303, 0x404]], np.int32)
    sv = np.arange(8, dtype=np.int32).reshape(1, 4, 2) + 1
    res_c, kc, vc = _set_both(mesh1, keys, vals, sk, sv, neighborhood=4)
    res_f, kf, vf = _set_both(mesh1, keys, vals, sk, sv,
                              np.full((1, 4, 4), -1, np.int32),
                              neighborhood=4)
    _equal(res_f, res_c)
    _equal((kf, vf), (kc, vc))


def test_sharded_set_armed_row_never_escalates(mesh1):
    _, h, keys0, vals0, q, qval = _displacer_scenario(jp)
    keys, vals = keys0[None], vals0[None]
    sk = np.asarray([[q]], np.int32)
    sv = np.asarray([[qval]], np.int32)
    res_c, _, _ = _set_both(mesh1, keys, vals, sk, sv, neighborhood=h)
    assert int(res_c.status[0, 0]) == tp.SET_DISPLACED
    rows = np.asarray([[[30_000, -1, -1, -1]]], np.int32)
    res_f, kf, _ = _set_both(mesh1, keys, vals, sk, sv, rows,
                             neighborhood=h)
    assert int(res_f.status[0, 0]) == tp.SET_NEEDS_DISPLACEMENT
    np.testing.assert_array_equal(kf.numpy(), keys)


def test_writer_fault_conflict_precedes_not_ported():
    keys = torch.zeros((1, 16), dtype=torch.int32)
    vals = torch.zeros((1, 16, 2), dtype=torch.int32)
    sk = torch.tensor([[5]], dtype=torch.int32)
    sv = torch.tensor([[[1, 2]]], dtype=torch.int32)
    plan = tf.FaultPlan.none((1, 1), device="cpu")
    with pytest.raises(tstore.WriterFaultConflict) as ei:
        tstore.sharded_set(keys, vals, sk, sv, faults=plan, n_writers=2,
                           device="cpu")
    assert ei.value.n_writers == 2
    assert str(ei.value) == str(jstore.WriterFaultConflict(2))
    assert isinstance(ei.value, ValueError)
    # without a fault plan the racing writers serve the request
    res, nk, _ = tstore.sharded_set(keys, vals, sk, sv, n_writers=2,
                                    device="cpu")
    assert int(res.status[0, 0]) == tp.SET_INSERTED and 5 in nk[0].tolist()


def test_sharded_set_storm_recovers_every_request(mesh1):
    """A seeded storm of all four kinds: faulted rows are audited,
    repaired and retried; afterwards every key serves its value and the
    store is fsck-clean.  Statuses, arrays, reports and repair actions
    equal JAX's at every step."""
    h = 4
    keys, vals = np.zeros((1, 32), np.int32), np.zeros((1, 32, 2), np.int32)
    n_req = 12
    sk = np.arange(1, n_req + 1, dtype=np.int32)[None, :] * 17
    sv = np.stack([sk[0] % 251 + 1, sk[0] % 97 + 1], axis=1)[None]
    rows = jf.storm(n_req, p_fault=0.5, max_step=60,
                    seed=20260807).as_rows()
    rows = np.asarray(rows)[None]
    np.testing.assert_array_equal(
        tf.storm(n_req, p_fault=0.5, max_step=60, seed=20260807,
                 device="cpu").as_rows().numpy(), rows[0])
    res, k1, v1 = _set_both(mesh1, keys, vals, sk, sv, rows, neighborhood=h)
    rep = tfsck.check_invariants(k1, v1, neighborhood=h)
    assert rep == jfsck.check_invariants(k1.numpy(), v1.numpy(),
                                         neighborhood=h)
    assert rep.repairable
    if not rep.clean:
        jk, jv, jact = jfsck.repair(jnp.asarray(k1.numpy()),
                                    jnp.asarray(v1.numpy()), rep,
                                    neighborhood=h)
        k1, v1, tact = tfsck.repair(k1, v1, rep, neighborhood=h)
        assert tact == jact
        _equal((k1, v1), (jk, jv))
    retry = ~np.isin(res.status.numpy(), TERMINAL_SET)
    assert retry.any()
    res2, k2, v2 = _set_both(mesh1, k1.numpy(), v1.numpy(), sk, sv,
                             neighborhood=h, live=retry)
    assert np.isin(res2.status.numpy()[retry], TERMINAL_SET).all()
    found, got = th.lookup(k2[0], v2[0], _t(sk[0]), h)
    assert bool(found.all())
    np.testing.assert_array_equal(got.numpy(), sv[0])
    assert tfsck.check_invariants(k2, v2, neighborhood=h).clean


def test_sharded_resize_fault_parks_watermark_then_recovers(mesh1):
    n, h = 8, 4
    k2 = tstore.keys_homed_at(2, 1, n)[0]
    k5 = tstore.keys_homed_at(5, 1, n)[0]
    keys = np.zeros((1, n), np.int32)
    vals = np.zeros((1, n, 2), np.int32)
    keys[0, 2], vals[0, 2] = k2, [21, 22]
    keys[0, 5], vals[0, 5] = k5, [51, 52]
    jrs = jstore.begin_resize(jnp.asarray(keys), jnp.asarray(vals))
    trs = tstore.begin_resize(_t(keys), _t(vals), device="cpu")
    rows = np.asarray(jf.FaultPlan.kill_lap(n, lap=2, step=30).as_rows())
    jplan, tplan = _plan_both(rows[None])
    jrs, jrep = jstore.sharded_resize(mesh1, "kv", jrs, step=n,
                                      neighborhood=h, faults=jplan)
    trs, trep = tstore.sharded_resize(trs, step=n, neighborhood=h,
                                      faults=tplan, device="cpu")
    _equal(trs, jrs, "faulted quantum")
    _equal(trep, jrep, "faulted report")
    assert int(trs.watermark[0]) == 2 and int(trep.stuck[0]) == 0
    rep = tfsck.check_invariants(resize=trs, neighborhood=h)
    assert rep == jfsck.check_invariants(resize=jrs, neighborhood=h)
    assert rep.repairable
    if not rep.clean:
        jrs, jact = jfsck.repair_resize(jrs, rep, neighborhood=h)
        trs, tact = tfsck.repair_resize(trs, rep, neighborhood=h)
        assert tact == jact
        _equal(trs, jrs, "repaired")
        assert tfsck.check_invariants(resize=trs, neighborhood=h).clean
    while not tstore.resize_done(trs):
        jrs, jrep = jstore.sharded_resize(mesh1, "kv", jrs, step=n,
                                          neighborhood=h)
        trs, trep = tstore.sharded_resize(trs, step=n, neighborhood=h,
                                          device="cpu")
        _equal(trs, jrs, "re-driven quantum")
    fk, fv = tstore.finish_resize(trs)
    found, got = th.lookup(fk[0], fv[0], torch.tensor([k2, k5]), h)
    assert bool(found.all())
    np.testing.assert_array_equal(got.numpy(), [[21, 22], [51, 52]])


def test_status_names_cover_the_migration_codes():
    for code, name in ((tp.MIG_MOVED, "MIG_MOVED"),
                       (tp.MIG_DISCARDED, "MIG_DISCARDED"),
                       (tp.MIG_NEEDS_DISPLACE, "MIG_NEEDS_DISPLACE")):
        assert th.status_name(code) == jh.status_name(code) == name
