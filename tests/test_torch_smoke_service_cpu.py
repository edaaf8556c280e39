"""``chip_smoke.py``'s ``phase_kv_service``, the services phase, rehearsed on the
CPU at a tiny size in a module of its own: a slow phase that a parallel run
places on a worker of its own (the other phases are in
``test_torch_smoke_cpu.py``)."""
import torch

from _smoke_fixtures import one_thread, smoke, write_store  # noqa: F401


def test_phase_kv_service_cpu(smoke, write_store):
    dk, dv = write_store.device_arrays("cpu")
    r = smoke.phase_kv_service("cpu", write_store, dk, dv,
                               recycled_buckets=64, recycled_words=1024,
                               n_stream=16, per_owner=4)
    assert r["resident_gets"] == 16 and r["reliable_attempts"] >= 2
    assert r["deleted"] > 0 and r["small_resizes"] >= 1
    assert r["chained_buckets_after"] == 32
    k, v = write_store.device_arrays("cpu")
    assert torch.equal(k, dk) and torch.equal(v, dv)
