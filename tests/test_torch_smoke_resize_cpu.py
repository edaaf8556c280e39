"""``chip_smoke.py``'s ``phase_kv_resize``, the online-resize phase, rehearsed on the
CPU at a tiny size in a module of its own: a slow phase that a parallel run
places on a worker of its own (the other phases are in
``test_torch_smoke_cpu.py``)."""
from _smoke_fixtures import one_thread, smoke, write_store  # noqa: F401


def test_phase_kv_resize_cpu(smoke, write_store):
    dk, dv = write_store.device_arrays("cpu")
    r = smoke.phase_kv_resize("cpu", write_store, dk, dv, step=8,
                              small_buckets=16, small_keys=8)
    assert r["killed_lap"] >= 2 and r["gets"] == 2 * 64
    assert r["sets"] == 4 and r["small_quanta"] == 2
    assert r["get_hits"] > 0
