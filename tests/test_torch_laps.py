"""The racing writer lanes' laps (``kernels/chain_interp/ref.py::
plain_laps``, the plain version of ``chain_laps_kernel``) on the CPU.

* The lap rule (``ref.fold_lap``) equals
  ``MultiWriterGroup.run_group`` over quiesced images, as images: the fold
  of a lap equals ``device_state`` of the carry ``run_group`` returns, at
  loads 0.5, 0.75 and 1.0, with 2 and 4 lanes of SET, DELETE and SWEEP,
  with and without the pad words (``exp``).
* The plain laps equal the rows route (``transport.laps_rows_stage``: the
  earlier ``_walk`` over ``run_group``) in responses and carry: key-0
  rows and all-key-0 laps, the hot-key hammer, one key sent by two lanes
  of a lap, an owner with no live row, a cut schedule; and the image
  equals ``device_state`` of the carry it holds after every lap.
* The group's refusals.
* The port's ``triggered_chain_group`` and ``local_chain_group`` equal the
  JAX package's (``src/repro/rdma/transport.py:207``, ``:278``) at S = 1
  on the same numpy inputs, through its ``run_group``; with the deadlines
  random where a bucket is empty, also where lap 0 has no live row.

``sharded_set(n_writers=2, 4)`` against JAX's is in
``tests/test_torch_multiwriter.py``.  All state is int32: tolerance 0."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec

from _laps_corpus import (CASES, KINDS, LOADS, exp_column, group,
                          lane_rows, lap_keys, schedule, window)
from _walk_corpus import H, N, V, _t, _table
from repro.compat import shard_map
from repro.core import machine as jmachine
from repro.core import programs as jprograms
from repro.rdma import transport as jtransport
from repro_torch.core import machine
from repro_torch.kernels.chain_interp import ops as interp_ops
from repro_torch.kernels.chain_interp import ref
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


RULE_CASES = [(kinds, load, exp) for kinds in KINDS for load in LOADS
              for exp in (False, True)]


@pytest.mark.parametrize("kinds,load,exp", RULE_CASES)
def test_lap_rule_is_run_group(kinds, load, exp):
    """G laps, one a context against one table (half of them the hot-key
    hammer), the pads random where a bucket is empty: the fold of each
    quiesced image is ``device_state`` of ``run_group``'s carry."""
    rng = np.random.RandomState(int(load * 100) + 7 * exp + len(kinds))
    mw = group(kinds)
    n = mw.n_writers
    t = _table(N, load, rng)
    keys = np.concatenate([lap_keys(t, kinds, 3, "mixed", rng),
                           lap_keys(t, kinds, 3, "hot", rng)])
    g = keys.shape[0]
    rows = _t(lane_rows(mw, kinds, keys, rng))
    carry = (_t(t.keys)[None].expand(g, N).contiguous(),
             _t(t.values)[None].expand(g, N, V).contiguous())
    if exp:
        e = exp_column(t, rng, normalized=False)
        carry += (_t(e)[None].expand(g, N).contiguous(),)
    sched = schedule(n)
    pre = mw.device_state(*carry).mem
    out = machine.run_scheduled_in_place(
        mw.spec, mw.delivered_state(*carry[:2], rows,
                                    carry[2] if exp else None),
        sched, mw.writer_slices, mw.fuel)
    want = mw.run_group(*carry[:2], rows, sched, mw.fuel,
                        exp=carry[2] if exp else None)
    got = ref.fold_lap(mw, exp, out.mem, pre)
    np.testing.assert_array_equal(got.numpy(),
                                  mw.device_state(*want[1:]).mem.numpy())
    for a, b in zip(ref.read_lap_carry(mw, got, carry), want[1:]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    resp = torch.tensor([r for _, r in mw.lanes])
    status = torch.where(rows[..., 0] == 0, 0, out.mem[:, resp])
    np.testing.assert_array_equal(status.numpy(), want[0].numpy())
    # the rule keeps some lap's table writes (below a full table, where a
    # SET can claim) and restores others' words
    assert load == 1.0 or any(bool((a != c).any())
                              for a, c in zip(want[1:], carry))
    assert bool(((out.mem != pre) & (got == pre)).any())


def _traced(stage_fn, *args):
    transport.trace = []
    try:
        stage_fn(*args)
        return transport.trace[-1]
    finally:
        transport.trace = None


# (lanes, case, exp, cut): every case at 2 lanes, the live ones at 4, the
# write mix with its pads, and a cut schedule
LAP_CASES = ([("set2", c, False, None) for c in CASES]
             + [("set4", c, False, None) for c in ("mixed", "hot", "dup")]
             + [("mix3", "mixed", True, None), ("mix4", "dup", True, None),
                ("mix4", "hot", False, None), ("set2", "mixed", False, 5),
                ("mix3", "hot", True, 9), ("mix3", "late", "raw", None),
                ("mix3", "idle", "raw", None)])


@pytest.mark.parametrize("kinds,case,exp,cut", LAP_CASES)
def test_plain_laps_equal_the_rows_route(kinds, case, exp, cut):
    mw, carry, rows = window(kinds, 2, 4, seed=len(kinds) + 3 * bool(exp),
                             case=case, exp=exp)
    sched = schedule(mw.n_writers, cut)
    got = _traced(transport.laps_stage, mw, sched, mw.fuel, carry, rows, 1,
                  kinds)
    want = _traced(transport.laps_rows_stage, mw, sched, mw.fuel, carry,
                   rows, 1, kinds)
    for field in ("depth", "runs"):
        assert got[field] == want[field], field
    (gr, gs, gc), (wr, _, wc) = got["out"], want["out"]
    np.testing.assert_array_equal(gr.numpy(), wr.numpy())
    assert len(gc) == len(carry) == len(wc)
    for a, b in zip(gc, wc):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert got["route"] == "laps"
    assert got["launches"] == {"run_interp": 0, "laps": 0}
    assert int(gs.max()) > 0 and got["depth"] >= 2
    live = (mw.lap_rows(rows)[..., 0] != 0).any(-1)
    np.testing.assert_array_equal((gs > 0).numpy(), live.numpy())
    if case == "idle":
        assert int(gs[0].max()) == 0 and not bool(gr[0].any())


@pytest.mark.parametrize("kinds,exp", [("set4", False), ("mix3", True)])
def test_image_is_device_state_after_every_lap(kinds, exp):
    mw, carry, rows = window(kinds, 2, 5, seed=17, exp=exp)
    seen = []

    def check(p, img):
        held = ref.read_lap_carry(mw, img, carry)
        np.testing.assert_array_equal(img.numpy(),
                                      mw.device_state(*held).mem.numpy())
        seen.append(p)

    ref.plain_laps(mw, carry, rows, schedule(mw.n_writers), mw.fuel,
                   on_lap=check)
    live = (mw.lap_rows(rows)[..., 0] != 0).any(-1)
    assert len(seen) == int(live.sum(1).max()) >= 3


def test_run_laps_on_the_cpu_is_the_plain_laps():
    mw, carry, rows = window("set2", 2, 4, seed=3)
    sched = schedule(2)
    before = dict(interp_ops.launches)
    a = interp_ops.run_laps(mw, carry, rows, sched, mw.fuel, 2)
    b = ref.plain_laps(mw, carry, rows, sched, mw.fuel, 2)
    assert interp_ops.launches == before
    for x, y in zip(a[:2] + a[2], b[:2] + b[2]):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    # the second response word is each live lane's bucket address
    assert a[0].shape == rows.shape[:2] + (2,) and bool(a[0][..., 1].any())


class _Relaid:
    """A group with some of its attributes changed."""

    def __init__(self, mw, **changes):
        self._mw, self._changes = mw, changes

    def __getattr__(self, name):
        return self._changes.get(name, getattr(self._mw, name))


def test_lap_layouts_are_accepted_and_refused():
    for kinds in KINDS:
        interp_ops.check_laps(group(kinds))
    mw = group("set2")
    (wq, r0), (_, r1) = mw.lanes
    with pytest.raises(ValueError, match="receive WQs"):
        interp_ops.check_laps(_Relaid(mw, lanes=((wq, r0), (wq, r1))))
    with pytest.raises(ValueError, match="response words"):
        interp_ops.check_laps(_Relaid(mw, lanes=((wq, r0), (wq + 1, -1))))
    with pytest.raises(ValueError, match="overlap"):
        interp_ops.check_laps(_Relaid(mw, values_base=mw.table_base))
    with pytest.raises(ValueError, match="lanes"):
        interp_ops.check_laps(_Relaid(mw, writer_slices=mw.writer_slices[:1]))
    queued = mw.state0._replace(msg_tail=mw.state0.msg_tail + 1)
    with pytest.raises(ValueError, match="queued"):
        interp_ops.check_laps(_Relaid(mw, state0=queued))
    # the wrapper's own checks, on meta tensors (no card needed)
    _, carry, rows = window("set2", 1, 3, seed=1)
    meta = rows.to("meta")
    with pytest.raises(ValueError, match="int32"):
        interp_ops.run_laps(mw, carry, meta.long(), schedule(2), mw.fuel)
    with pytest.raises(ValueError, match="schedule"):
        interp_ops.run_laps(mw, carry, meta, schedule(2), mw.fuel)


def _jax_group(kinds: str):
    return jprograms.build_multi_writer_group(N, V, H, len(KINDS[kinds]),
                                              lane_kinds=KINDS[kinds])


@pytest.mark.parametrize("kinds,case", [("set2", "hot"), ("set4", "dup")])
def test_triggered_chain_group_matches_jax(mesh1, kinds, case):
    """One owner's window through the dispatch, two rows not live, the
    racing lanes' laps and the combine: responses, ok and the carry
    bit-equal to the JAX package's at S = 1."""
    mw, carry, rows = window(kinds, 1, 4, seed=29, case=case)
    n, b = mw.n_writers, rows.shape[1]
    dest = torch.zeros((1, b), dtype=torch.int32)
    live = torch.ones((1, b), dtype=torch.bool)
    live[0, [1, 4]] = False
    got = transport.triggered_chain_group(
        mw, schedule(n), mw.fuel, carry, rows, dest, 1, b, 1, live=live)
    jg = _jax_group(kinds)
    assert jg.fuel == mw.fuel
    jsched = jmachine.Schedule.round_robin(n, quantum=16, n_rounds=8)

    def group_fn(c, lap):
        st, k, v = jg.run_group(*c, lap, jsched, jg.fuel)
        return (k, v), st[:, None]

    def body(p, d, lv, k, v):
        resp, ok, (nk, nv) = jtransport.triggered_chain_group(
            group_fn, (k[0], v[0]), p, d, 1, b, "kv", 1, n, lv)
        return resp, ok, nk[None], nv[None]

    spec = PartitionSpec()
    f = shard_map(body, mesh=mesh1, in_specs=(spec,) * 5,
                  out_specs=(spec,) * 4, check_vma=False)
    want = f(*(jnp.asarray(x.numpy()) for x in (rows[0], dest[0], live[0],
                                                 *carry)))
    resp, ok, (nk, nv) = got
    for g, w in zip((resp[0], ok[0], nk, nv), want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool((resp[0, :, 0] != 0).any())


@pytest.mark.parametrize("kinds,exp,case", [
    ("mix3", True, "mixed"), ("set2", False, "mixed"),
    ("mix3", "raw", "mixed"), ("mix3", "raw", "idle"),
    ("mix3", "raw", "late")])
def test_local_chain_group_matches_jax(kinds, exp, case):
    """One shard's loopback laps (the write mix with its deadlines, or
    two SET lanes): responses and carry bit-equal to the JAX package's at
    S = 1.  With the deadlines random where a bucket is empty ("raw"),
    JAX's scan runs ``run_group`` on all-key-0 laps too, so lap 0's
    commit sets them to ``NO_TTL`` whether it runs or not: a live lap 0
    (whose sweep lane reads the random ones), no live row at all, and a
    skipped lap 0 before live ones."""
    mw, carry, rows = window(kinds, 1, 5, seed=41, case=case, exp=exp)
    n = mw.n_writers
    assert case != "late" or not bool(rows[0, :n, 0].any())
    resp, new = transport.local_chain_group(mw, schedule(n), mw.fuel, carry,
                                            rows, 1)
    jg = _jax_group(kinds)
    jsched = jmachine.Schedule.round_robin(n, quantum=16, n_rounds=8)

    def group_fn(c, lap):
        out = jg.run_group(c[0], c[1], lap, jsched, jg.fuel,
                           exp=c[2] if exp else None)
        return tuple(out[1:]), out[0][:, None]

    jresp, jnew = jtransport.local_chain_group(
        group_fn, tuple(jnp.asarray(c[0].numpy()) for c in carry),
        jnp.asarray(rows[0].numpy()), n)
    np.testing.assert_array_equal(resp[0].numpy(), np.asarray(jresp))
    assert len(new) == len(jnew) == len(carry)
    for g, w in zip(new, jnew):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))
    assert case == "idle" or bool((resp != 0).any())
    if exp == "raw":
        empty = carry[0][0] == 0
        assert bool((carry[2][0][empty] != jprograms.NO_TTL).any())
        assert bool((new[2][0][new[0][0] == 0] == jprograms.NO_TTL).all())
