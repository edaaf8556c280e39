"""``chip_smoke.py``'s ``phase_chain_interp``, the interpreter kernel's phase, rehearsed on the
CPU at a tiny size in a module of its own: a slow phase that a parallel run
places on a worker of its own (the other phases are in
``test_torch_smoke_cpu.py``)."""
import pytest
import torch

from _smoke_fixtures import one_thread, smoke, write_store  # noqa: F401


def test_phase_chain_interp_cpu(smoke, write_store):
    """The interpreter kernel's phase at 2 shards x 256 buckets, where the
    wrapper takes its plain version: every case reaches the interpreter
    (the redn window in one run, a split batch) and holds its runs to the
    plain loop; here the counts show each case ran."""
    dk, dv = write_store.device_arrays("cpu")
    r = smoke.phase_chain_interp("cpu", write_store, dk, dv, n_keys=300,
                                 batch=8, set_rows=(1, 2, 1),
                                 server=(64, 1024, 40), server_batch=16,
                                 guests=12)
    c = r["cases"]
    assert set(c) == {"corpus", "window", "redn", "set", "contend",
                      "cut_sweep", "faults", "guests"}
    assert c["redn"]["runs"] == 1 and r["redn_contexts"] == 2 * 2 * 8
    assert c["redn"]["split"] == [True] and c["window"]["split"] == [True] * 4
    assert r["redn_private_words"] < r["redn_image_words"]
    assert r["window_refused"] == 5
    assert c["redn"]["wqs"] == [18] and r["max_abs_err"] == 0
    assert 263 in c["set"]["wqs"] and 113 in c["contend"]["wqs"]
    assert c["guests"]["steps_max"] == 26 * 102 and r["faults_armed"] > 0
    assert r["set_batch"] == (2, 4) and r["bound_by"] == "bytes"
    k, v = write_store.device_arrays("cpu")
    assert torch.equal(k, dk) and torch.equal(v, dv)


def test_ptxas_report_names_the_interpreter_instances(smoke):
    """``chain_interp_kernel`` is templated on two bools (one warp,
    split): each instance is reported by them, and a spill in any fails
    the card's gate."""
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__178b4947"
        "_15_chain_interp_cu_08b274de19chain_interp_kernelILb0ELb1EEEvNS"
        "_10InterpArgsE' for 'sm_90a'",
        "    8 bytes stack frame, 16 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 32 registers, used 1 barriers, 640 bytes smem",
        "ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__178b4947"
        "_15_chain_interp_cu_08b274de19chain_interp_kernelILb1ELb0EEEvNS"
        "_10InterpArgsE' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 59 registers, used 0 barriers, 128 bytes smem"])
    got = smoke.ptxas_report(log, ("chain_interp_kernel",))
    assert got == {
        "chain_interp_kernel<false,true>": dict(
            registers=32, spill_stores=16, spill_loads=8),
        "chain_interp_kernel<true,false>": dict(
            registers=59, spill_stores=0, spill_loads=0)}
    with pytest.raises(AssertionError, match="spills"):
        smoke.check_spill_free(got, ("chain_interp_kernel",))
