"""Split batches (``machine.SharedBatch``: the words a program's chains only
read kept once an image, each context holding the rest) on the CPU, where
the interpreter kernel's wrapper takes its plain version, against the JAX
package's runs of full copies:

* the hopscotch get servers (64 and 256 buckets, H 4 and 8, default and
  TTL) through ``ChainEngine.run_many`` with the server's shared window,
  materialized, bit-equal in all 14 fields to JAX's ``run_many`` of each
  shard's full image; every private segment shorter than the image;
* the store's redn gets (default and TTL) bit-equal to JAX's
  ``sharded_get``, and ``get_many`` to JAX's, each run handing the
  interpreter a split batch;
* the window cases of ``_interp_images.py`` (copies straddling either
  end, negative addresses wrapping in, stores past the image, stores of
  the value a window word holds) bit-equal to JAX's ``run_batch``, plain
  and under fault rows; each store that would change a window word
  raises, naming its rows, also one that a later store takes back;
* ``deliver_shared``, ``words``, ``materialize`` and ``split`` against the
  full-copy forms.

The kernel is held to this plain version on the card
(``test_torch_gpu.py``).  Tolerance 0 throughout."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import _interp_images as images
from _parity import fresh_jax_programs
from repro.core import faults as jf
from repro.core import machine as jm
from repro.core import programs as jp
from repro.kvstore import store as jstore
from repro_torch import convert
from repro_torch.core import faults as tf
from repro_torch.core import machine as tm
from repro_torch.core import programs as tp
from repro_torch.kernels.chain_interp import ops as interp_ops
from repro_torch.kvstore import hopscotch as th
from repro_torch.kvstore import store as tstore

JSPEC = jm.MachineSpec(*images.SPEC)
TSPEC = convert.spec_from_tuple(images.SPEC)

_fresh_jax_programs = pytest.fixture(scope="module", autouse=True)(
    fresh_jax_programs)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the machines are small, and several threads a
    worker oversubscribe the cores of a parallel run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_states(want, got: tm.VMState, what=""):
    """Every field bit-equal, dtypes included (``want``: JAX's or the
    port's state, or a dict of numpy arrays)."""
    for f in tm.VMState._fields:
        w = np.asarray(want[f] if isinstance(want, dict) else
                       getattr(want, f))
        g = getattr(got, f).numpy()
        assert g.dtype == w.dtype, (what, f, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {f}")


def store_tables(n_shards, n, v, h, seed):
    """(keys (S, n), vals (S, n, v)) int32 of a store filled by the host
    insert with random keys to ~60% load."""
    kv = tstore.ShardedKV.build(n_shards, n, v, neighborhood=h)
    rng = np.random.RandomState(seed)
    for k in rng.choice(np.arange(1, 1 << 20), int(0.6 * n * n_shards),
                        replace=False).tolist():
        kv.set(k, [(k * (j + 3)) % 9973 - 4000 for j in range(v)])
    keys = np.stack([t.keys for t in kv.tables]).astype(np.int32)
    vals = np.stack([t.values for t in kv.tables]).astype(np.int32)
    return keys, vals


def queries(keys, rng, b):
    """(S, b) int32 queries: stored keys, misses and key 0."""
    out = []
    for row in keys:
        stored = row[row != 0]
        q = rng.choice(stored, b - 3)
        out.append(np.concatenate([q, [(1 << 21) + 7, 0, (1 << 22) + 1]]))
    return np.stack(out).astype(np.int32)


@pytest.mark.parametrize("ttl", [False, True])
@pytest.mark.parametrize("n,h", [(64, 4), (64, 8), (256, 4), (256, 8)])
def test_split_gets_match_jax_full_copies(n, h, ttl):
    s_, v, b = 2, 4, 12
    keys, vals = store_tables(s_, n, v, h, seed=n + h)
    rng = np.random.RandomState(n * h + ttl)
    exp = rng.randint(0, 100, keys.shape).astype(np.int32) if ttl else None
    now = 50 if ttl else None
    q = queries(keys, rng, b)
    home = np.asarray(th.bucket_of(torch.from_numpy(q), n))
    tsrv = tp.build_hopscotch_server(n, v, h, ttl=ttl, device="cpu")
    jsrv = jp.build_hopscotch_server(n, v, h, ttl=ttl)
    st = tsrv.device_state(torch.from_numpy(keys), torch.from_numpy(vals),
                           None if exp is None else torch.from_numpy(exp))
    pay = tsrv.device_payloads(torch.from_numpy(q), torch.from_numpy(home),
                               now)
    out = tsrv.engine.run_many(st, tsrv.recv_wq, pay, 256,
                               window=tsrv.shared_window)
    assert isinstance(out, tm.SharedBatch)
    length = st.mem.shape[1]
    assert out.state.mem.shape == (s_ * b, length - (out.hi - out.lo))
    assert out.state.mem.shape[1] < length
    assert out.base.data_ptr() == st.mem.data_ptr()   # no copy of images
    full = tm.materialize(out)
    for g in range(s_):
        jst = jsrv.device_state(jnp.asarray(keys[g]), jnp.asarray(vals[g]),
                                None if exp is None else jnp.asarray(exp[g]))
        jpay = jsrv.device_payloads(jnp.asarray(q[g]), jnp.asarray(home[g]),
                                    now)
        want = jsrv.engine.run_many(jst, jsrv.recv_wq, jpay, 256)
        assert_states(want, tm.VMState(*(a[g * b:(g + 1) * b]
                                         for a in full)), f"shard {g}")
    resp = tm.words(out, tsrv.resp_region, tsrv.resp_words)
    assert torch.equal(resp, full.mem[:, tsrv.resp_region:
                                      tsrv.resp_region + tsrv.resp_words])


@pytest.mark.parametrize("h", [4, 8])
@pytest.mark.parametrize("ttl", [False, True])
def test_server_window_holds_nothing_the_chain_writes(h, ttl):
    """The window is the table then the value rows; the code, the scatter
    table, the TTL cells and the response row lie outside it."""
    srv = tp.build_hopscotch_server(128, 4, h, ttl=ttl, device="cpu")
    lo, hi = srv.shared_window
    assert lo == srv.table_base
    assert hi - lo == 128 * (tp.BUCKET_WORDS + 5)
    assert srv.prog._code_top <= lo and srv.resp_region >= hi
    cells = [a for name, a in srv.prog.symbols.items()
             if name in ("key", "negnow") or name.startswith("e")]
    assert len(cells) == (2 + h if ttl else 0)
    assert all(a < lo for a in cells)


def _mesh():
    return Mesh(np.array(jax.devices()[:1]), ("kv",))


@pytest.fixture
def interp_runs(monkeypatch):
    """The batches the interpreter's wrapper is handed."""
    seen, real = [], interp_ops.run_interp

    def capture(spec, s, *args, **kw):
        seen.append(s)
        return real(spec, s, *args, **kw)

    monkeypatch.setattr(interp_ops, "run_interp", capture)
    return seen


@pytest.mark.parametrize("ttl", [False, True])
def test_store_redn_gets_match_jax_on_split_batches(interp_runs, ttl):
    """``sharded_get`` (redn) at S = 1 against JAX's on a 1-device mesh;
    the interpreter ran one split batch of private segments shorter than
    the image."""
    n, v, h = 128, 2, 8
    keys, vals = store_tables(1, n, v, h, seed=3)
    rng = np.random.RandomState(4)
    q = queries(keys, rng, 24)
    kw = {}
    if ttl:
        exp = rng.randint(0, 100, keys.shape).astype(np.int32)
        kw = dict(exp=exp, now=40)
    want = jstore.sharded_get(
        _mesh(), "kv", jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(q),
        method="redn", **{k: jnp.asarray(x) for k, x in kw.items()})
    got = tstore.sharded_get(
        torch.from_numpy(keys), torch.from_numpy(vals), torch.from_numpy(q),
        method="redn", device="cpu",
        **{k: torch.as_tensor(x) for k, x in kw.items()})
    for field, g, w in zip(tstore.GetResult._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=field)
    assert bool(got.found.any()) and not bool(got.found.all())
    assert len(interp_runs) == 1
    run = interp_runs[0]
    assert isinstance(run, tm.SharedBatch)
    assert run.state.mem.shape[1] < run.base.shape[1]


def test_get_many_matches_jax_on_a_split_batch(interp_runs):
    n, v, h = 64, 4, 4
    keys, vals = store_tables(1, n, v, h, seed=5)
    q = queries(keys, np.random.RandomState(6), 16)[0]
    home = np.asarray(th.bucket_of(torch.from_numpy(q), n))
    jsrv = jp.build_hopscotch_server(n, v, h)
    tsrv = tp.build_hopscotch_server(n, v, h, device="cpu")
    jf_, jv = jsrv.get_many(jnp.asarray(keys[0]), jnp.asarray(vals[0]),
                            jnp.asarray(q), jnp.asarray(home))
    tf_, tv = tsrv.get_many(torch.from_numpy(keys[0]),
                            torch.from_numpy(vals[0]), torch.from_numpy(q),
                            torch.from_numpy(home))
    np.testing.assert_array_equal(tf_.numpy(), np.asarray(jf_))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert [type(r) for r in interp_runs] == [tm.SharedBatch]


def _split(machines, per, window=images.WINDOW):
    full = convert.vmstate_from_numpy(
        images.stack(images.repeat(machines, per)), "cpu")
    return tm.split(full, window, per)


def _jax_full(machines, per, max_steps, plan=None):
    batch = images.stack(images.repeat(machines, per))
    st = jm.VMState(*(jnp.asarray(batch[f]) for f in jm.VMState._fields))
    return jm.run_batch(JSPEC, st, max_steps, plan)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("max_steps", [images.MAX_STEPS, 5, 4096])
def test_window_machines_match_jax(seed, max_steps):
    machines = images.window_machines(seed)
    b = _split(machines, 2)
    tm.run_batch_shared_in_place(TSPEC, b, max_steps)
    assert_states(_jax_full(machines, 2, max_steps), tm.materialize(b),
                  f"seed {seed}")


def test_window_machines_under_faults_match_jax():
    machines = images.window_machines(2)
    rows = images.fault_rows(9, 2 * len(machines))
    b = _split(machines, 2)
    tm.run_batch_shared_in_place(
        TSPEC, b, images.MAX_STEPS,
        tf.FaultPlan.from_row(torch.from_numpy(rows)))
    want = _jax_full(machines, 2, images.MAX_STEPS,
                     jf.FaultPlan.from_row(jnp.asarray(rows)))
    assert_states(want, tm.materialize(b), "faults")


def test_window_machines_reach_the_edge_cases():
    """The cases do what they are named for: copies straddle ``lo`` and
    ``hi``, RECVs scatter through tables in the window, return-old
    stores land on window words (of the value they hold)."""
    b = _split(images.window_machines(0), 1)
    tm.run_batch_shared_in_place(TSPEC, b, 4096)
    counts = b.state.verb_counts.sum(0)
    for op in (images.WRITE, images.READ, images.RECV, images.SEND,
               images.CAS, images.ADD, images.WRITE_IMM):
        assert int(counts[op]) > 0, op
    assert int(b.state.msg_head.sum()) >= 2


@pytest.mark.parametrize("i", range(len(images.window_raisers(0))))
def test_a_changed_window_word_raises(i):
    bad = images.window_raisers(0)[i]
    with pytest.raises(ValueError, match=r"rows \[0, 1, 2\] would change"):
        tm.run_batch_shared_in_place(TSPEC, _split([bad], 3), 4096)
    good = images.window_machines(0)
    with pytest.raises(ValueError, match=rf"rows \[{len(good)}\] "):
        tm.run_batch_shared_in_place(TSPEC, _split(good + [bad], 1), 4096)


def test_a_raise_is_the_full_run_changing_the_window():
    """Each raiser's full-copy run changes its window in its first step
    (so the raise is no false alarm, also where a later store takes the
    change back), and the window machines' full runs change none."""
    lo, hi = images.WINDOW
    for machines, changes, steps in ((images.window_raisers(0), True, 1),
                                     (images.window_machines(0), False,
                                      4096)):
        batch = images.stack(machines)
        out = _jax_full(machines, 1, steps)
        moved = (np.asarray(out.mem)[:, lo:hi] != batch["mem"][:, lo:hi])
        assert list(moved.any(1)) == [changes] * len(machines)


def test_a_change_taken_back_raises_at_its_store():
    """The raiser whose window word is changed and then restored: its
    full-copy run ends with the window as it began (a check after the run
    would pass it), yet the split run is refused, as on the card."""
    lo, hi = images.WINDOW
    bad = images.window_raisers(0)[-1]
    out = _jax_full([bad], 1, 4096)
    assert np.array_equal(np.asarray(out.mem)[:, lo:hi],
                          images.stack([bad])["mem"][:, lo:hi])
    assert int(np.asarray(out.steps)[0]) == 2
    with pytest.raises(ValueError, match=r"rows \[0, 1\] would change"):
        tm.run_batch_shared_in_place(TSPEC, _split([bad], 2), 4096)


def test_deliver_shared_is_deliver_many_split():
    """The split batch of ``deliver_shared`` materializes to
    ``deliver_many``'s, in both payload forms; its base is the caller's
    images, uncopied."""
    srv = tp.build_hopscotch_server(64, 2, 4, device="cpu")
    keys, vals = store_tables(3, 64, 2, 4, seed=8)
    st = srv.device_state(torch.from_numpy(keys), torch.from_numpy(vals))
    pay = torch.from_numpy(np.random.RandomState(9).randint(
        0, 500, (3, 5, 8)).astype(np.int32))
    got = tm.deliver_shared(st, srv.recv_wq, pay, srv.shared_window)
    assert got.per == 5 and got.base.data_ptr() == st.mem.data_ptr()
    assert_states(tm.deliver_many(st, srv.recv_wq, pay),
                  tm.materialize(got), "(G, N, k)")
    one = tm.VMState(*(a[1] for a in st))
    got = tm.deliver_shared(one, srv.recv_wq, pay[1], srv.shared_window)
    assert_states(tm.deliver_many(one, srv.recv_wq, pay[1]),
                  tm.materialize(got), "(N, k)")
    with pytest.raises(ValueError, match="window"):
        tm.deliver_shared(st, srv.recv_wq, pay, (10, st.mem.shape[1] + 1))


@pytest.mark.parametrize("addr,n", [(0, 5), (295, 10), (300, 100),
                                    (395, 10), (290, 120), (510, 18)])
def test_words_gathers_across_the_window(addr, n):
    full = convert.vmstate_from_numpy(
        images.stack(images.repeat(images.window_machines(0), 2)), "cpu")
    b = tm.split(full, images.WINDOW, 2)
    assert torch.equal(tm.words(b, addr, n), full.mem[:, addr:addr + n])
    assert torch.equal(tm.materialize(b).mem, full.mem)
    with pytest.raises(ValueError):
        tm.words(b, images.L - 2, 4)


def test_split_refuses_rows_that_differ_in_the_window():
    full = convert.vmstate_from_numpy(
        images.stack(images.repeat(images.window_machines(0), 2)), "cpu")
    full.mem[1, images.WINDOW[0] + 3] += 1
    with pytest.raises(ValueError, match="differ"):
        tm.split(full, images.WINDOW, 2)


def test_migrating_gets_run_on_split_batches(interp_runs):
    """A store mid-growth (``sharded_get`` given a ``ResizeState``) serves
    its gets from both frames, each stage a split batch; the answers are
    those of the frames before the growth began."""
    n, v, h = 64, 2, 4
    keys, vals = store_tables(2, n, v, h, seed=11)
    rs = tstore.begin_resize(torch.from_numpy(keys), torch.from_numpy(vals),
                             device="cpu")
    rs, _ = tstore.sharded_resize(rs, 8, neighborhood=h, device="cpu")
    q = queries(keys, np.random.RandomState(12), 10)
    interp_runs.clear()
    got = tstore.sharded_get(rs, torch.from_numpy(q), neighborhood=h,
                             device="cpu")
    want = tstore.sharded_get(torch.from_numpy(keys), torch.from_numpy(vals),
                              torch.from_numpy(q), neighborhood=h,
                              device="cpu")
    for field in ("found", "values", "ok"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field
    assert len(interp_runs) == 3          # the plain get, both frames
    assert all(isinstance(r, tm.SharedBatch)
               and r.state.mem.shape[1] < r.base.shape[1]
               for r in interp_runs)
