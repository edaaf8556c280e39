"""``chip_smoke.py``'s phases run on the CPU at a tiny size (the kernels'
plain versions stand in, since CPU tensors take the plain path), and its
``main()`` refuses to run without a CUDA card."""
import importlib.util
import re
from pathlib import Path

import pytest
import torch

from repro_torch.configs import registry
from repro_torch.models import model as model_lib

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def small_store(smoke):
    return smoke.phase_kv_get("cpu", n_shards=2, buckets=128, n_keys=150,
                              batch=16, n_batches=2, time_it=False)


def test_phase_kv_get_cpu(small_store):
    result, kv, dk, dv = small_store
    assert sum(result["keys_per_shard"]) == 150
    hits = result["hits"]
    assert hits["redn"] == hits["one_sided"] == hits["two_sided"] > 0


def test_phase_chain_kernel_cpu(smoke):
    r = smoke.phase_chain_kernel("cpu", time_it=False, n_buckets=64,
                                 mem_words=1024, n_keys=40, batch=16,
                                 small=(1, 5))
    assert r["max_abs_err"] == 0 and r["contexts"] == [16, 1, 5]
    assert r["launches"] == 0               # CPU tensors: no kernel launch


def test_phase_chain_straight_cpu(smoke):
    r = smoke.phase_chain_straight("cpu", n=64, mem_words=256, n_wrs=8,
                                   max_steps=12, time_it=False)
    assert r["max_abs_err"] == 0 and r["changed"] > 0


def test_phase_hopscotch_probe_cpu(smoke, small_store):
    _, kv, dk, dv = small_store
    r = smoke.phase_hopscotch_probe("cpu", kv, dk, dv, n_queries=64,
                                    n_keys=150, redn_chunk=16, time_it=False)
    assert r["max_abs_err"] == 0 and r["hits"] > 0
    assert r["bound_ms"] > 0


@pytest.fixture(scope="module")
def smoke_lm():
    cfg = registry.smoke_config("qwen3-1.7b")
    return cfg, model_lib.init_params(cfg, seed=0, device="cpu")


def test_phase_lm_prefill_cpu(smoke, smoke_lm):
    cfg, params = smoke_lm
    r = smoke.phase_lm_prefill("cpu", cfg, params, batch=2, prompt=12,
                               extra=3, time_it=False)
    assert r["flash_launches"] == r["decode_launches"] == 0   # plain path
    assert r["max_abs_err_decode"] <= r["logit_tol"] == 2e-3
    assert len(r["decode_step_ms"]) == 3
    assert r["cache_decode_errs"]["idle_rows"] == 0


def test_phase_lm_serve_cpu(smoke, smoke_lm):
    cfg, params = smoke_lm
    r = smoke.phase_lm_serve("cpu", cfg, params, s_max=48, n_slots=8,
                             ticks=6, crash_at=3, time_it=False)
    assert r["admitted"] == [True] * 4 + [False] * 2 + [True] * 2
    assert r["active"] == 6 and r["stats"]["throttled"] == 2
    assert r["stats"] == dict(steps=6, tokens=36, throttled=2)
    assert r["cache_decode_errs"]["idle_rows"] == 2     # the idle slots


def test_phase_flash_kernel_cpu(smoke):
    r = smoke.phase_flash_kernel("cpu", b=2, h=4, kh=2, s=96, d=32,
                                 time_it=False)
    assert set(r["errs"]) == {f"{c}/{t}" for c in ("causal", "window",
                                                    "length")
                              for t in ("bfloat16", "float32")}
    assert r["max_abs_err"] == 0          # the CPU compares plain to plain
    assert r["bound_ms"] > 0


def test_phase_decode_kernel_cpu(smoke):
    r = smoke.phase_decode_kernel("cpu", b=3, h=4, kh=2, s=64, d=32,
                                  time_it=False)
    assert r["errs"]["shards/float32"] < r["tol"]
    assert r["planted_fault_err"] > 100 * r["tol"]    # the check rejects it
    assert r["visible_rows"] > 0 and r["bound_ms"] > 0


def test_main_exits_without_cuda(smoke, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        smoke.main()
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_kernel_rows_name_the_tpu_kernels(smoke):
    assert len(smoke.KERNELS) == 5
    for name, _, source, replaces in smoke.KERNELS:
        assert (ROOT / source).is_file(), source
        path, line = replaces.split(":")
        text = (ROOT / path).read_text().splitlines()[int(line) - 1]
        assert re.match(r"def _\w+_kernel\(", text), (replaces, text)
