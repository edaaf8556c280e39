"""``chip_smoke.py``'s ``phase_kv_contend``, the racing-writer phase, rehearsed on the
CPU at a tiny size in a module of its own: a slow phase that a parallel run
places on a worker of its own (the other phases are in
``test_torch_smoke_cpu.py``)."""
import torch

from _smoke_fixtures import one_thread, smoke, write_store  # noqa: F401


def test_phase_kv_contend_cpu(smoke, write_store):
    """The racing-writer phase at 2 shards x 256 buckets: its gates hold
    the uniform batches at every writer count to n_writers=1 and the host
    oracle, the hammer to fsck and read-back, every lap and walk stage to
    the earlier route, the lap kernel's replay to its plain laps, the cut
    sweep and the fairness run to the oracles, and the isolation arm to
    the CPU path; here the counts show each part ran."""
    dk, dv = write_store.device_arrays("cpu")
    r = smoke.phase_kv_contend("cpu", write_store, dk, dv, per_owner=4,
                               n_gets=16, burst=8.0, wide=8)
    assert set(r["sets_per_s"]) == {"uniform/1", "uniform/2", "uniform/4",
                                    "hot/2", "hot/4", "uniform8/1",
                                    "uniform8/2", "uniform8/4"}
    assert "writer-group" in r["set_stages"]["hot/2"]
    assert r["laps_kernel"]["stages"] == ["writer-group"]
    assert r["laps_kernel"]["lap_steps"][0] > 0
    assert r["cuts"] > 100 and set(r["cut_oracles"]) == {"AB", "BA"}
    assert r["fairness_ratio"] <= 2.0 and r["fair_steps"] > 0
    assert r["isolation_deferred"][0] > 0
    k, v = write_store.device_arrays("cpu")
    assert torch.equal(k, dk) and torch.equal(v, dv)
