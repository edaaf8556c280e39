"""The port across ranks, on one gloo group of 8 processes
(``_dist_drills.py``), against the one-device arm and the JAX package:

* the store's three get paths, SET with displacement and DELETE, on 8
  ranks of 1 shard and on 4 ranks of 2 shards (these also at a capacity
  that drops requests, and a get and a SET mid-growth), bit-equal to
  the one-device arm (which the other store tests hold to
  JAX bit for bit), and the gets to JAX's ``store.reference_get``;
* ``masked_grad_combine`` against JAX's under ``jax.vmap(...,
  axis_name=)``, exactly, for alive patterns down to all dead;
* gpipe against JAX's vmapped gpipe on ``pipeline_main.py``'s inputs:
  outputs within 1e-6, gradients within 1e-5.

No process group is initialised in this process: the ranks rendezvous
through a FileStore in the test's temporary directory."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _dist_drills as dd
from repro.distributed import fault as jfault
from repro.distributed import pipeline as jpipeline
from repro.kvstore import hopscotch as jh
from repro.kvstore import store as jstore
from repro_torch import convert
from repro_torch.kvstore import store
from repro_torch.rdma import transport

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 8 ranks' results, and the one-device arm's from a process
    started beside them."""
    tmp = tmp_path_factory.mktemp("group")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    script = str(ROOT / "tests" / "_dist_drills.py")
    args = [[str(r), str(WORLD), str(tmp / "store"), str(tmp)]
            for r in range(WORLD)] + [["one", str(tmp)]]
    procs = [subprocess.Popen(
        [sys.executable, script, *a], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for a in args]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return ([torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)],
            torch.load(tmp / "one.pt", weights_only=False))


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


@pytest.fixture(scope="module")
def one_device(runs):
    """The same drills on one device, all 8 shards in one tensor."""
    return runs[1]


def gathered(ranks, layout: str, key: str) -> dict:
    """Every field of one drill's result, the ranks' blocks concatenated
    in global shard order."""
    parts = [r[layout][key] for r in ranks[:dd.LAYOUTS[layout]]]
    return {f: torch.cat([p[f] for p in parts]) for f in parts[0]}


@pytest.mark.parametrize("layout,drill", [
    (layout, drill) for layout in dd.LAYOUTS
    for drill in dd.drill_keys(layout)])
def test_store_group_arm_equals_one_device(ranks, one_device, layout,
                                           drill):
    got, want = gathered(ranks, layout, drill), one_device[drill]
    assert set(got) == set(want)
    for f in want:
        assert got[f].dtype == want[f].dtype, f
        assert torch.equal(got[f], want[f]), (layout, drill, f)


def test_drills_cover_drops_and_displacement(one_device):
    """The drop capacity drops gets, SETs and DELETEs, and the SET batch
    reaches every outcome: update, insert, displacement, overflow."""
    for key in ("get/redn/1", "set/1", "delete/1"):
        assert int(one_device[key]["dropped"].sum()) > 0, key
    for key in ("get/redn/None", "set/None", "delete/None"):
        assert int(one_device[key]["dropped"].sum()) == 0, key
    st = one_device["set/None"]["status"][one_device["set/None"]["ok"]]
    for code in (jh.SET_UPDATED, jh.SET_INSERTED, jh.SET_DISPLACED,
                 jh.SET_NEEDS_RESIZE):
        assert bool((st == code).any()), code
    ds = one_device["delete/None"]["status"]
    assert bool((ds == jh.DEL_DELETED).any()) and bool(
        (ds == jh.DEL_MISS).any())


@pytest.mark.parametrize("layout", dd.LAYOUTS)
def test_group_gets_equal_jax_reference(ranks, layout):
    kv, probe = dd.get_store()
    jkv = jstore.ShardedKV.build(8, 64, 2)
    for s, t in enumerate(kv.tables):
        jkv.tables[s].keys[:] = t.keys
        jkv.tables[s].values[:] = t.values
    rfound, rvals = jstore.reference_get(jkv, probe.reshape(-1))
    for method in dd.METHODS:
        got = gathered(ranks, layout, f"get/{method}/None")
        assert bool(got["ok"].all())
        np.testing.assert_array_equal(got["found"].numpy().reshape(-1),
                                      rfound)
        np.testing.assert_array_equal(got["values"].numpy().reshape(-1, 2),
                                      rvals)


def test_group_refuses_what_its_backend_cannot_carry(ranks):
    for r in ranks:
        assert len(r["refused"]) == 2
        assert all("cannot carry" in e for e in r["refused"])
    # and with no process group at all
    with pytest.raises(RuntimeError, match="no process group"):
        transport.check_group(None, "cpu")
    kv, probe = dd.get_store()
    k, v = kv.device_arrays("cpu")
    with pytest.raises(RuntimeError, match="no process group"):
        store.sharded_get(k, v, torch.from_numpy(probe), device="cpu",
                          group=object())


def test_kv_block_carries_the_jax_store(ranks):
    """``convert.kv_from_numpy`` of a JAX-built store, then each rank's
    block: the shards the drill ranks served."""
    kv, _ = dd.get_store()
    jkv = jstore.ShardedKV.build(8, 64, 2)
    for t_, t in zip(jkv.tables, kv.tables):
        t_.keys[:], t_.values[:] = t.keys, t.values
    jk, jv = jkv.device_arrays()
    port = convert.kv_from_numpy(np.asarray(jk), np.asarray(jv))
    k, v = port.device_arrays("cpu")
    assert torch.equal(k, torch.from_numpy(np.stack([t.keys for t in
                                                     kv.tables])))
    assert torch.equal(v, torch.from_numpy(np.stack([t.values for t in
                                                     kv.tables])))


def test_masked_grad_combine_equals_jax_vmapped(ranks):
    grads = [dd.combine_grads(r) for r in range(WORLD)]
    stacked = {k: jnp.asarray(np.stack([g[k].float().numpy()
                                        for g in grads])).astype(
        jnp.bfloat16 if grads[0][k].dtype == torch.bfloat16 else jnp.float32)
        for k in grads[0]}
    for i, alive in enumerate(dd.ALIVE):
        want, n_live = jax.vmap(
            lambda g, a: jfault.masked_grad_combine(g, a, "dp"),
            axis_name="dp")(stacked, jnp.asarray(alive, bool))
        for r in range(WORLD):
            got = ranks[r]["combine"][i]
            assert float(got["n_live"]) == float(n_live[r]) == sum(alive)
            for k in grads[0]:
                assert got[k].dtype == torch.float32
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(want[k][r]))


def test_gpipe_matches_jax_vmapped(ranks):
    s = dd.PIPE["S"]
    w_all, x = dd.pipe_inputs()

    def stage_fn(w, h):
        return jnp.tanh(h @ w)

    def run(w):
        return jax.vmap(lambda w_s, xx: jpipeline.gpipe(
            stage_fn, w_s, xx, axis_name="pod", n_stages=s),
            in_axes=(0, None), axis_name="pod")(w, jnp.asarray(x))

    outs = run(jnp.asarray(w_all))
    grads = jax.grad(lambda w: jnp.sum(run(w)[s - 1] ** 2))(
        jnp.asarray(w_all))
    for r in range(s):
        got = ranks[r]["gpipe"]
        want_y = np.asarray(outs[r])
        np.testing.assert_allclose(got["y"].numpy(), want_y, atol=1e-6,
                                   rtol=0)
        np.testing.assert_allclose(got["grad"].numpy(),
                                   np.asarray(grads[r]), atol=1e-5, rtol=0)
    # the last stage holds the sequential apply; the others zeros
    h = x
    for st in range(s):
        h = np.tanh(h @ w_all[st])
    np.testing.assert_allclose(ranks[s - 1]["gpipe"]["y"].numpy(), h,
                               atol=1e-5)
    assert not ranks[0]["gpipe"]["y"].any()
