"""The write window's walk (``kernels/chain_interp/ref.py::plain_walk``, the
plain version of ``chain_walk_kernel``) on the CPU.

* Each single-chain write-side program's ``commit`` and ``commit_torn``
  equal its ``walk_layout``'s rule (``ref.fold``) over quiesced images, as
  images: the fold of a run equals ``device_state`` of the committed
  carry, at loads 0.5, 0.9 and 1.0 and under a storm of all four fault
  kinds (a displacer's SET_NEEDS_RESIZE runs whose partial moves the rule
  undoes, a migrator's laps that touch a mirror row).
* The plain walk equals the rows route (``transport.rows_stage``: the
  earlier ``_walk`` over ``run_rows``) in responses, steps and carry, with
  and without fault rows, and its image equals ``device_state`` of the
  carry it holds at every position.

The store's stages against the JAX package's are in
``tests/test_torch_walk_store.py``.  All state is int32: tolerance 0."""
import numpy as np
import pytest
import torch

from _walk_corpus import (LOADS, N, PROGRAMS, V, _build, _corpus, _keys, _t,
                          _table, _window)
from repro_torch.core import faults, programs as tp
from repro_torch.kernels.chain_interp import ops as interp_ops
from repro_torch.kernels.chain_interp import ref
from repro_torch.kvstore import hopscotch as th
from repro_torch.rdma import transport


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _mirror_touched(prog, post, pre) -> int:
    """The contexts whose run wrote a mirror row's word."""
    hits = torch.zeros(post.shape[0], dtype=torch.bool)
    for f in prog.walk_layout.frames:
        _, mir = ref._frame_words(f, post.device)
        if mir.numel():
            hits |= (post[:, mir.reshape(-1)] != pre[:, mir.reshape(-1)]
                     ).any(1)
    return int(hits.sum())


# the sweeper takes no fault rows (its stage arms none): it has no torn
# commit to hold the rule to
RULE_CASES = [(name, load, armed) for name in PROGRAMS for load in LOADS
              for armed in (False, True) if not (armed and name == "sweeper")]


@pytest.mark.parametrize("name,load,armed", RULE_CASES)
def test_commit_is_the_layout_rule(name, load, armed):
    prog, carry, pay = _corpus(name, load, seed=int(load * 10) + armed)
    g = pay.shape[0]
    plan = (faults.storm(g, p_fault=0.6, max_step=prog.fuel // 2,
                         seed=int(load * 100), device="cpu")
            if armed else None)
    pre = prog.device_state(*carry).mem
    out = tp._run_contexts(prog, prog.device_state(*carry), pay, prog.fuel,
                           plan)
    layout = prog.walk_layout
    status = out.mem[:, layout.resp_region]
    clean = prog.commit(out.mem, pay, *carry)
    want_carry = clean[1:]
    keep = torch.isin(status, torch.tensor(layout.commit))
    if armed:
        act = plan.active()
        torn = prog.commit_torn(out.mem, pay, *carry)
        want_carry = tuple(
            torch.where(act.reshape((-1,) + (1,) * (c.ndim - 1)), t, c)
            for t, c in zip(torn[1:], want_carry))
        keep = keep | act
        assert bool(act.any()) and not bool(act.all())
    np.testing.assert_array_equal(clean[0].numpy(), status.numpy())
    got = ref.fold(layout, out.mem, pre, keep)
    want = prog.device_state(*want_carry).mem
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    for a, b in zip(ref.read_carry(layout, got, carry), want_carry):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    if name == "migrator" and not armed:
        assert _mirror_touched(prog, out.mem, pre) >= 1


def test_displacer_resize_runs_are_undone():
    """A full table with a hole every 11 buckets: some displacer runs move
    buckets, then find no way home and quiesce on SET_NEEDS_RESIZE; the
    rule restores every word they moved."""
    prog = _build("displacer")
    rng = np.random.RandomState(0)
    t = _table(N, 1.0, rng)
    t.keys[::11], t.values[::11] = 0, 0
    g = 48
    q = _keys(t, rng, g)
    pay = prog.device_payloads(_t(q), _t(th.bucket_of(q, N).astype(np.int32)),
                               _t(rng.randint(1, 99, (g, V)).astype(np.int32)))
    carry = (_t(t.keys)[None].expand(g, N).contiguous(),
             _t(t.values)[None].expand(g, N, V).contiguous())
    pre = prog.device_state(*carry).mem
    out = tp._run_contexts(prog, prog.device_state(*carry), pay, prog.fuel)
    layout = prog.walk_layout
    status = out.mem[:, layout.resp_region]
    prim, mir = ref._frame_words(layout.frames[0], pre.device)
    words = torch.cat([prim.reshape(-1), mir.reshape(-1)])
    moved = (out.mem[:, words] != pre[:, words]).any(1)
    stuck = status == tp.SET_NEEDS_RESIZE
    assert int((moved & stuck).sum()) >= 2
    keep = torch.isin(status, torch.tensor(layout.commit))
    got = ref.fold(layout, out.mem, pre, keep)
    np.testing.assert_array_equal(got[stuck].numpy(), pre[stuck].numpy())
    want = prog.device_state(*prog.commit(out.mem, pay, *carry)[1:]).mem
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def _traced(stage_fn, *args):
    transport.trace = []
    try:
        stage_fn(*args)
        return transport.trace[-1]
    finally:
        transport.trace = None


@pytest.mark.parametrize("name,faulted", [
    (name, faulted) for name in PROGRAMS for faulted in (False, True)
    if not (faulted and name == "sweeper")])
def test_plain_walk_equals_the_rows_route(name, faulted):
    prog, carry, rows = _window(name, 3, 10, seed=11 + faulted)
    frows = (faults.storm(rows.shape[0] * rows.shape[1], p_fault=0.4,
                          max_step=prog.fuel // 2, seed=5,
                          device="cpu").as_rows().reshape(rows.shape[:2]
                                                          + (-1,))
             if faulted else None)
    budget = prog.fuel
    got = _traced(transport.walk_stage, prog, budget, carry, rows, frows, 1,
                  name)
    want = _traced(transport.rows_stage, prog, budget, carry, rows, frows, 1,
                   name)
    for field in ("depth", "runs"):
        assert got[field] == want[field], field
    for a, b in zip(got["steps"], want["steps"]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    (gr, gs, gc), (wr, ws, wc) = got["out"], want["out"]
    np.testing.assert_array_equal(gr.numpy(), wr.numpy())
    np.testing.assert_array_equal(gs.numpy(), ws.numpy())
    for a, b in zip(gc, wc):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert got["launches"] == {"run_interp": 0, "walk": 0}
    assert want["launches"]["run_interp"] == 0          # the CPU's loop
    assert int(gs.max()) > 0


@pytest.mark.parametrize("name", PROGRAMS)
def test_image_is_device_state_at_every_position(name):
    prog, carry, rows = _window(name, 2, 8, seed=23)
    seen = []

    def check(p, img):
        held = ref.read_carry(prog.walk_layout, img, carry)
        np.testing.assert_array_equal(img.numpy(),
                                      prog.device_state(*held).mem.numpy())
        seen.append(p)

    ref.plain_walk(prog, carry, rows, prog.fuel, on_position=check)
    assert len(seen) == int((rows[..., 0] != 0).sum(1).max())


def test_run_walk_on_the_cpu_is_the_plain_walk():
    prog, carry, rows = _window("writer", 2, 6, seed=3)
    before = dict(interp_ops.launches)
    a = interp_ops.run_walk(prog, carry, rows, prog.fuel)
    b = ref.plain_walk(prog, carry, rows, prog.fuel)
    assert interp_ops.launches == before
    for x, y in zip(a[:2] + a[2], b[:2] + b[2]):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_walk_layouts_are_accepted():
    for name in PROGRAMS:
        interp_ops.check_layout(_build(name))
    bad = _build("writer")
    with pytest.raises(ValueError, match="mirror rows"):
        interp_ops.check_layout(_Relaid(bad, rows=3 * N))
    with pytest.raises(ValueError, match="overlap"):
        interp_ops.check_layout(_Relaid(bad, values_base=bad.table_base))


class _Relaid:
    """A program whose walk layout's one frame has other fields."""

    def __init__(self, prog, **changes):
        self.spec, self.state0 = prog.spec, prog.state0
        lay = prog.walk_layout
        self.walk_layout = lay._replace(
            frames=(lay.frames[0]._replace(**changes),))
