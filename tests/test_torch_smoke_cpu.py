"""``chip_smoke.py``'s phases run on the CPU at a tiny size (the kernels'
plain versions stand in, since CPU tensors take the plain path), and its
``main()`` refuses to run without a CUDA card."""
import dataclasses
import importlib.util
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _smoke_fixtures import smoke, write_store  # noqa: F401
from repro_torch.configs import registry
from repro_torch.models import model as model_lib

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def small_store(smoke):
    return smoke.phase_kv_get("cpu", n_shards=2, buckets=128, n_keys=150,
                              batch=16, n_batches=2, time_it=False)


def test_phase_kv_get_cpu(small_store):
    result, kv, dk, dv = small_store
    assert sum(result["keys_per_shard"]) == 150
    hits = result["hits"]
    assert hits["redn"] == hits["one_sided"] == hits["two_sided"] > 0


KV_GET_GROUP_CPU = """
import sys, torch
sys.path.insert(0, {root!r})
import chip_smoke as cs
torch.set_num_threads(1)
_, kv, dk, dv = cs.phase_kv_get("cpu", n_shards=2, buckets=128, n_keys=150,
                                batch=16, n_batches=2, time_it=False)
r = cs.phase_kv_get_group("cpu", kv, dk, dv, n_keys=150, batch=16,
                          n_batches=2, time_it=False)
print(r)
assert r["backend"] == "gloo" and r["ranks"] == 1
assert r["shards_per_rank"] == 2 and r["mesh"] == {{"data": 1, "model": 1}}
assert r["checked"] == {{m: 64 for m in ("redn", "one_sided", "two_sided")}}
assert not torch.distributed.is_initialized()
print("KV_GET_GROUP_OK")
"""


def test_phase_kv_get_group_cpu():
    """The group arm's phase on a one-rank gloo group, in a process of its
    own (this one initialises no process group): every path bit-equal to
    the one-device arm, the exchange of one rank the swap, the group
    destroyed at the end."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c",
                        KV_GET_GROUP_CPU.format(root=str(ROOT))],
                       capture_output=True, text=True, timeout=300, env=env)
    assert "KV_GET_GROUP_OK" in r.stdout, r.stdout + r.stderr


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
    # the wider neighborhoods and the one-word rows, on shard 0's table
    assert set(r["case_hits"]) == {"H16/V4", "H32/V4", "H8/V1"}
    assert min(r["case_hits"].values()) > 0
    assert r["case_hits"]["H16/V4"] == r["case_hits"]["H32/V4"]


def test_phase_kv_write_cpu(smoke):
    """The write phase at 2 shards x 256 buckets, 300 random keys (59%
    load; the sequential keys of ``build_store`` leave no neighborhood
    full at this size): its gates hold every status and array to the host
    oracles; here the counts it reports show the phase reached each verb."""
    kv = smoke.store.ShardedKV.build(2, 256, 4)
    rng = np.random.RandomState(0)
    for k in rng.choice(np.arange(1, 1 << 20), 300, replace=False).tolist():
        assert kv.set(k, [k, 2 * k, 3 * k, 5 * k])
    dk, dv = kv.device_arrays("cpu")
    r = smoke.phase_kv_write("cpu", kv, dk, dv, n_update=3, n_insert=3,
                             n_disp=2, n_delete=(2, 2, 2), n_ttl=2,
                             ttl_span=8, time_it=False)
    assert r["set_statuses"]["SET_DISPLACED"] >= 1
    assert set(r["set_stages"]) == {"writer", "displacer"}
    assert r["set_stages"]["writer"]["runs"] == 2 * (3 + 3 + 2 + 1)
    assert r["delete_deleted"] >= 4 and r["sweep_reclaimed"] >= 1
    assert r["ttl_get_hits"][300] > r["ttl_get_hits"][1000]
    # the phase worked on copies: the store it was given is unchanged
    k, v = kv.device_arrays("cpu")
    assert torch.equal(k, dk) and torch.equal(v, dv)


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
    shapes = (("a", 2, 4, 2, 96, 32, 0), ("b", 1, 4, 1, 80, 64, 80))
    r = smoke.phase_flash_kernel("cpu", shapes, time_it=False)
    ragged = {f"ragged{sq}x{sk}+{off}/bfloat16"
              for sq, sk, off in smoke.FLASH_RAGGED}
    assert set(r["errs"]) == {f"a/{c}/{t}" for c in ("causal", "window",
                                                      "length")
                              for t in ("bfloat16", "float32")} | {
        "b/causal/bfloat16", "b/causal/float32"} | {
        f"{s}/{c}" for s in "ab" for c in ragged}
    assert r["max_abs_err"] == 0          # the CPU compares plain to plain
    assert r["bound_ms"] > 0 and set(r["shapes"]) == {"a", "b"}
    # the window of 80 binds nothing at S = 80: all causal pairs count
    assert r["shapes"]["b"]["flops"] == 4.0 * 4 * 64 * 80 * 81 / 2


def test_flash_launches_by_kernel_follow_the_dispatch(smoke):
    """The drives' gate: bf16 prefills launch only the tensor-core kernel,
    float32 ones only the CUDA-core kernel, one per attention layer."""
    for drive, arch, dtype in (("lm_prefill", "qwen3-1.7b", "bfloat16"),
                               ("lm_griffin", "recurrentgemma-9b",
                                "bfloat16"),
                               ("lm_float32", "qwen3-1.7b", "float32")):
        cfg = dataclasses.replace(registry.get_config(arch), dtype=dtype)
        kind, n = smoke.FLASH_DRIVE_LAUNCHES[drive]
        assert smoke.flash_variant_launches(cfg, "cuda") == {
            f"flash_attention.{v}": n if v == kind else 0
            for v in ("wgmma", "fma")}
        assert set(smoke.flash_variant_launches(cfg, "cpu").values()) == {0}
    rwkv = registry.get_config("rwkv6-7b")          # no attention layer
    assert set(smoke.flash_variant_launches(rwkv, "cuda").values()) == {0}


def _sass_listing(bodies):
    """A ``cuobjdump -sass`` listing with one function per (name, lines)."""
    out = ["", "Fatbin elf code:", "================", "arch = sm_90a"]
    for name, lines in bodies:
        out += [f"\t\tFunction : {name}",
                '\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"']
        out += [f"        /*{16 * i:04x}*/   {x} ;" for i, x in enumerate(lines)]
    return "\n".join(out)


def test_hgmma_check_counts_each_head_dim(smoke):
    """The card phase's SASS check: HGMMA counted per flash_wgmma_kernel<D>
    instantiation (mangled names), other functions ignored; a head dim
    whose function holds none, or has no function, fails the run."""
    def wgmma(d):
        return (f"_ZN12_GLOBAL__N_118flash_wgmma_kernelILi{d}EEEv14CUtensorM"
                f"ap_stS1_S1_S1_S1_PKiP13__nv_bfloat16iiiiiiif")
    hg = "HGMMA.64x128x16.F32.BF16 R24, gdesc[UR8], RZ, !UPT"
    bodies = [(wgmma(d), ["MOV R1, c[0x0][0x28]"] + [hg] * n)
              for d, n in ((64, 4), (96, 7), (128, 8), (256, 16))]
    fma = ("_ZN12_GLOBAL__N_116flash_fwd_kernelI13__nv_bfloat16Li96EEEvPKT_"
           "S4_S4_PKiPS2_iiiiiiiif", [hg, "FFMA R0, R1, R2, R0"])
    assert smoke.hgmma_by_head_dim(_sass_listing(bodies + [fma])) == {
        64: 4, 96: 7, 128: 8, 256: 16}
    bodies[1] = (wgmma(96), ["FFMA R0, R1, R2, R0"])
    with pytest.raises(AssertionError, match=r"head dims \[96\]"):
        smoke.hgmma_by_head_dim(_sass_listing(bodies + [fma]))
    with pytest.raises(AssertionError, match=r"head dims \[64, 96\]"):
        smoke.hgmma_by_head_dim(_sass_listing(bodies[2:] + [fma]))
    # the backward's tensor-core pair, each kernel at head dims 64, 128
    # and 256
    assert smoke.BWD_WGMMA_HEAD_DIMS == (64, 128, 256)
    bwd = [(f"_ZN12_GLOBAL__N_125{k}ILi{d}EEEv14CUtensorMap_", [hg] * 3)
           for k in smoke.BWD_WGMMA_KERNELS for d in (64, 128, 256)]
    for k in smoke.BWD_WGMMA_KERNELS:
        assert smoke.hgmma_by_head_dim(_sass_listing(bwd), k,
                                       smoke.BWD_WGMMA_HEAD_DIMS) == {
            64: 3, 128: 3, 256: 3}
    with pytest.raises(AssertionError, match=r"dkdv_wgmma_kernel at head "
                                             r"dims \[128\]"):
        smoke.hgmma_by_head_dim(_sass_listing(bwd[:4]), "flash_bwd_dkdv_"
                                "wgmma_kernel", (64, 128))


def test_device_time_retakes_an_empty_trace(smoke, monkeypatch):
    """A profiler trace that recorded no device time is taken again; after
    three empty ones CUDA events stand in, labelled, so no time reads 0."""
    traces = iter([0.0, 0.0, 0.25])

    def profile(fn, reps, kernels=()):
        return dict(device_ms=next(traces), by_group_ms={}, device_ops=1.0,
                    by_kernel_ms={k: 0.1 for k in kernels})
    monkeypatch.setattr(smoke, "device_profile", profile)
    monkeypatch.setattr(smoke, "cuda_ms", lambda fn, reps=5, warmup=1: 0.5)
    calls = []
    r = smoke.device_time(lambda: calls.append(1), 4, ("k",))
    assert (r["device_ms"], r["timed_by"], calls) == (0.25, "trace", [1])
    traces = iter([0.0] * 3)
    assert smoke.device_time(lambda: None, 4, ("k",)) == dict(
        device_ms=0.5, by_group_ms=None, device_ops=None,
        by_kernel_ms={"k": None}, timed_by="events")


def test_phase_decode_kernel_cpu(smoke):
    # the 32k case and the recurrentgemma-9b decode case at a small size:
    # 16 query heads on one KV head, a window the lengths are past
    shapes = (("a", 3, 4, 2, 64, 32, 0, (1, 64)),
              ("b", 4, 16, 1, 96, 64, 32, (33, 40)))
    r = smoke.phase_decode_kernel("cpu", shapes, time_it=False)
    assert set(r["errs"]) == {f"{n}/{t}/{p}" for n in "ab"
                              for t in ("float32", "bfloat16")
                              for p in ("acc", "l", "m", "shards")}
    assert r["errs"]["a/float32/shards"] < r["tol"]
    assert r["max_abs_err"] == 0          # the CPU compares plain to plain
    assert r["planted_fault_err"] > 100 * r["tol"]    # the check rejects it
    assert r["visible_rows"] > 0 and r["bound_ms"] > 0
    assert set(r["shapes"]) == {"a", "b"}
    b = r["shapes"]["b"]               # each row sees its window's 32 rows
    assert b["visible_rows"] == 4 * 32 and b["shape"] == (4, 16, 1, 96, 64,
                                                          32)
    lengths = smoke.decode_lengths("cpu", 4, (33, 40))
    assert lengths.tolist()[0] == 33 and lengths.tolist()[-1] == 40
    assert r["shapes"]["a"]["splits"] == smoke.dec_ops.plan_splits(3, 2, 64)


def test_decode_launches_by_kernel(smoke):
    """The drives' gate on the decode pair: one split and one combine
    launch per attention layer and step."""
    for arch, n in (("qwen3-1.7b", 28), ("recurrentgemma-9b", 12),
                    ("rwkv6-7b", 0)):
        cfg = registry.get_config(arch)
        assert smoke.decode_kernel_launches(cfg, "cuda") == {
            "decode_partial.split": n, "decode_partial.combine": n}
        assert set(smoke.decode_kernel_launches(cfg, "cpu").values()) == {0}


def bf16_smoke(arch):
    cfg = dataclasses.replace(registry.smoke_config(arch), dtype="bfloat16")
    return cfg, model_lib.init_params(cfg, seed=0, device="cpu")


def test_phase_lm_float32_cpu(smoke):
    """qwen3's witness: the bf16 drive, then the float32 one."""
    cfg, params = bf16_smoke("qwen3-1.7b")
    pre = smoke.phase_lm_prefill("cpu", cfg, params, batch=2, prompt=12,
                                 extra=3, time_it=False)
    assert pre["max_abs_err_decode"] <= pre["logit_tol"] == 0.125
    r = smoke.phase_lm_float32("cpu", cfg, params, pre.pop("rows"), {},
                               batch=2, prompt=12, extra=3)
    assert params.embed.embedding.dtype == torch.float32
    assert r["max_abs_err_decode"] <= r["logit_tol"] == 2e-3
    w = r["bf16_decode_witness"]
    assert 0 < w["floor"] and w["err"] <= w["limit"] == smoke.WITNESS_K * \
        w["floor"] and w["controls"] == {}


def test_decode_witness_rejects_a_far_decode_and_a_close_control(smoke):
    gen = torch.Generator().manual_seed(0)
    truth = torch.randn((2, 3, 50), generator=gen)
    rows = dict(forward=truth + 0.01, decoded=truth - 0.015)
    w = smoke.decode_witness(rows, truth, {"far": truth + 1.0})
    assert w["ratio"] == pytest.approx(1.5, rel=1e-4) and w["controls"]["far"] > 0.99
    with pytest.raises(AssertionError, match="control 'near'"):
        smoke.decode_witness(rows, truth, {"near": truth + 0.02})
    with pytest.raises(AssertionError, match="from float32 forward"):
        smoke.decode_witness(dict(rows, decoded=truth + 0.03), truth, {})
    with pytest.raises(AssertionError, match="needs a bf16 model"):
        smoke.decode_witness(dict(rows, forward=truth), truth, {})


@pytest.mark.parametrize("arch", ["rwkv6-7b", "recurrentgemma-9b"])
def test_phase_lm_recurrent_cpu(smoke, arch):
    cfg, params = bf16_smoke(arch)
    r = smoke.phase_lm_recurrent("cpu", cfg, params, batch=2, prompt=40,
                                 extra=3, s_max=48, n_slots=8, ticks=6,
                                 crash_at=3, time_it=False)
    pre, serve = r["prefill"], r["serve"]
    # plain path: no launch, but the launches the card would make
    assert pre["prefill_launches"] == {"flash_attention": 0, "wkv6": 0,
                                       "rglru": 0}
    kinds = [cfg.layer_type(i) for i in range(cfg.num_layers)]
    want, step = smoke.path_launches(cfg, "cuda")
    assert want == {"flash_attention": kinds.count("local"),
                    "wkv6": kinds.count("rwkv"),
                    "rglru": kinds.count("recurrent")}
    assert step == {"decode_partial": kinds.count("local")}
    assert pre["max_abs_err_prefill"] <= pre["logit_tol"] == 0.125
    assert serve["stats"] == dict(steps=6, tokens=36, throttled=2)
    f32 = r["lm_float32"]           # the float32 drive, gated at 2e-3
    assert f32["max_abs_err_decode"] <= f32["logit_tol"] == 2e-3
    w = f32["bf16_decode_witness"]  # the witness of the bf16 decode
    assert 0 < w["floor"] and w["err"] <= w["limit"]
    assert set(w["controls"]) == set(smoke.STATE_FAULTS)
    assert min(w["controls"].values()) > w["limit"]
    if arch == "rwkv6-7b":
        assert pre["cache_decode_errs"] is None     # no attention layer
        w0 = r["layer0_wkv6"]
        assert w0["shape"] == (2, 4, 40, 32) and w0["dtype"] == "bfloat16"
        assert w0["o_vs_plain"] == 0 and w0["s_vs_f64"] < smoke.STATE_TOL
        assert 0 <= w0["small_decay_channel_share"] <= 1
    else:
        assert "layer0_wkv6" not in r
        # the smoke window (16) binds at these lengths, on an idle-free
        # prefill cache and on the serving cache's idle rows
        assert pre["cache_decode_errs"]["window"] == 16
        assert serve["cache_decode_errs"]["idle_rows"] == 2


@pytest.mark.parametrize("key", ["lm_gemma3", "lm_gemma3_cache",
                                 "lm_mixtral", "lm_phi3v", "lm_seamless",
                                 "lm_llama4", "lm_llama4_nope"])
def test_phase_lm_arch_cpu(smoke, key):
    """Each of the other archs' drives at its smoke config with the
    drive's cache and routing changes: the prefill against ``forward``,
    decode through the cache arms, the patches counted in the lengths,
    the frames read by the cross layers."""
    _, arch, changes, _ = next(d for d in smoke.ARCH_DRIVES if d[0] == key)
    changes = {k: v for k, v in changes.items() if k != "num_layers"}
    cfg = dataclasses.replace(registry.smoke_config(arch), **changes)
    params = model_lib.init_params(cfg, seed=0, device="cpu")
    r = smoke.phase_lm_arch("cpu", cfg, params, batch=2, prompt=20, extra=3,
                            time_it=False)
    assert r["flash_launches"] == r["decode_launches"] == 0   # plain path
    assert r["max_abs_err_prefill"] <= r["logit_tol"] == 2e-3
    # float32 decode continues forward; an int8 cache within its error
    assert r["max_abs_err_decode"] <= (0.05 if cfg.kv_quant else 2e-3)
    assert r["frontend_positions"] == (cfg.frontend_tokens
                                       if cfg.frontend == "vision" else 0)
    assert r["frontend_positions"] == (8 if key in ("lm_phi3v", "lm_llama4",
                                                    "lm_llama4_nope") else 0)
    assert (r["forward_aux"] > 0) == cfg.is_moe
    assert cfg.is_moe == (key in ("lm_mixtral", "lm_llama4",
                                  "lm_llama4_nope"))
    errs = r["cache_decode_errs"]
    # a last local layer's full cache is read through the 16 window, a
    # rolling one (20 + 3 positions in 16 slots) with none
    local = cfg.layer_type(cfg.num_layers - 1) == "local"
    assert errs["window"] == (16 if local and not cfg.window_cache else 0)
    assert r["config"]["kv_quant"] == (key == "lm_gemma3_cache")
    if cfg.is_moe:                  # float32: every route as forward's
        routes = r["routes"]
        assert routes["prefill_agree"] == routes["decode_agree"] == 1.0
        assert routes["decode_flips"] == 0
        assert routes["max_abs_err_agreeing"] <= 2e-3
        assert routes["max_abs_err_after_flip"] is None
        dropped = routes["dropped"]
        assert dropped["forward_pairs"] == 2 * 23 * cfg.experts_per_token \
            * cfg.num_layers
        assert 0 <= dropped["prefill"] <= dropped["forward_pairs"]
    else:
        assert "routes" not in r


def test_drive_launch_table_matches_the_configs(smoke):
    """``FLASH_DRIVE_LAUNCHES`` of the other archs' drives is what their
    configs launch on the card: a flash launch per attention, encoder and
    cross layer, of the kernel ``variant`` picks."""
    for key, arch, changes, _ in smoke.ARCH_DRIVES:
        cfg = dataclasses.replace(registry.get_config(arch), **changes)
        kind, n = smoke.FLASH_DRIVE_LAUNCHES[key]
        assert smoke.flash_variant_launches(cfg, "cuda")[
            f"flash_attention.{kind}"] == n, key
    seamless = registry.get_config("seamless-m4t-medium")
    assert smoke.path_launches(seamless, "cuda") == (
        {"flash_attention": 36, "wkv6": 0, "rglru": 0},
        {"decode_partial": 24})
    phi3v = registry.get_config("phi-3-vision-4.2b")
    assert smoke.decode_kernel_launches(phi3v, "cuda") == {
        "decode_partial.split": 32, "decode_partial.combine": 32}


def test_layer0_wkv6_inputs_are_the_prefills(smoke, monkeypatch):
    """What the layer-0 check reads is what layer 0 of a prefill hands the
    WKV6 recurrence."""
    cfg, params = bf16_smoke("rwkv6-7b")
    calls = []
    wkv6 = smoke.wkv_ops.wkv6

    def tap(*args):
        calls.append(args)
        return wkv6(*args)
    monkeypatch.setattr(smoke.wkv_ops, "wkv6", tap)
    toks = torch.randint(1, cfg.vocab_size, (2, 20),
                         generator=torch.Generator().manual_seed(1))
    model_lib.prefill(params, {"tokens": toks}, cfg, s_max=24)
    assert len(calls) == cfg.num_layers
    for got, want in zip(smoke.layer0_wkv6_inputs(cfg, params, toks),
                         calls[0], strict=True):
        assert torch.equal(got, want)


def test_phase_wkv6_kernel_cpu(smoke):
    r = smoke.phase_wkv6_kernel("cpu", b=1, h=2, t=40, n=32, time_it=False)
    assert set(r["errs"]) == {f"{p}/T{t}/{d}" for p in ("o", "S")
                              for t in (40, 21, 1)
                              for d in ("bfloat16", "float32")}
    assert r["max_abs_err"] == 0          # the CPU compares plain to plain
    assert r["bound_ms"] > 0 and r["bound_by"] in ("bytes", "operations")


def test_phase_rglru_kernel_cpu(smoke):
    r = smoke.phase_rglru_kernel("cpu", b=2, t=40, d=20, time_it=False)
    cases = [f"2x{t}x{d}" for t, d in ((40, 20), (21, 20), (1, 20), (97, 24),
                                       (33, 23))]
    assert set(r["errs"]) == {f"{p}/{c}/{t}" for p in ("h", "last")
                              for c in cases
                              for t in ("float32", "bfloat16")}
    assert r["max_abs_err"] == 0 and max(r["errs"].values()) == 0
    assert r["bound_ms"] > 0 and r["bound_by"] == "bytes"
    # the kernel each case takes on the card: rows of 20 or 24 float32
    # channels, and of 24 bf16 ones, are whole 16-byte units (the ring's);
    # 20 bf16 channels are not, 23 channels in neither type
    assert {c: r["variants"][f"{c}/float32"] for c in cases} == dict(
        zip(cases, ["ring"] * 4 + ["direct"]))
    assert {c: r["variants"][f"{c}/bfloat16"] for c in cases} == dict(
        zip(cases, ["direct"] * 3 + ["ring", "direct"]))


def test_rglru_launches_by_kernel_follow_the_dispatch(smoke):
    """The drives' gate: a recurrentgemma-9b prefill launches the ring
    kernel once per recurrent layer, in a bf16 model and a float32 one;
    models without recurrent layers launch neither kernel."""
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(registry.get_config("recurrentgemma-9b"),
                                  dtype=dtype)
        assert smoke.rglru_variant_launches(cfg, "cuda") == {
            "rglru.ring": 26, "rglru.direct": 0}
        assert set(smoke.rglru_variant_launches(cfg, "cpu").values()) == {0}
    for arch in ("qwen3-1.7b", "rwkv6-7b"):
        cfg = registry.get_config(arch)
        assert set(smoke.rglru_variant_launches(cfg, "cuda").values()) == {0}


def test_main_exits_without_cuda(smoke, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        smoke.main()
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_script_alone_exits_nonzero(tmp_path):
    """Copied into a directory that holds nothing else of the repository,
    the script exits non-zero before any phase and prints no result."""
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    run = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"})
    assert run.returncode != 0 and '"ok"' not in run.stdout
    assert "no src/repro_torch beside this script" in run.stderr


def test_kernel_rows_name_the_tpu_kernels(smoke):
    """Thirteen rows: seven a TPU kernel each; the flash backward, which
    replaces the JAX package's plain-JAX backward (``_make_blocked_vjp``'s
    ``bwd``); the recurrences' backward kernels, which replace JAX's
    autodiff of its chunked forms (``_chunked_jax``); the interpreter
    kernel, which replaces ``machine.run``'s device-side while loop; the
    walk kernel, which replaces the write stages' ``lax.scan``; and the
    lap kernel, which replaces the racing lanes' ``lax.scan`` of
    ``run_group``.  Each row's phase runs, and the guest drive of
    ``chain_programs`` reaches kernel #1 (its launches join that row's
    ``launches_by_phase``)."""
    assert len(smoke.KERNELS) == 13
    assert smoke.KERNELS[0][:2] == ("chain_vm.run_managed", "chain_kernel")
    assert "chain_programs" in smoke.PHASES
    for name, phase, source, replaces, kernels in smoke.KERNELS:
        assert phase in smoke.PHASES, (name, phase)
        assert (ROOT / source).is_file(), source
        text = (ROOT / source).read_text()
        for kernel in kernels:       # each a __global__ of its source
            assert re.search(r"__global__ void[^;{]*?\b" + kernel +
                             r"\(", text), (name, kernel)
        path, line = replaces.split(":")
        text = (ROOT / path).read_text().splitlines()[int(line) - 1]
        pattern = (r"\s+def bwd\(res, do\):" if name.endswith(".backward")
                   else r"def _chunked_jax\(" if name.endswith("_backward")
                   else r"def run\(" if name == "chain_interp.run_interp"
                   else r"\s+carry, resp = lax\.scan\("
                   if name in ("chain_interp.walk", "chain_interp.laps")
                   else r"def _\w+_kernel\(")
        assert re.match(pattern, text), (replaces, text)


def test_phases_run_in_order(smoke):
    """The robustness phases sit after the paths they reuse: the kill
    faults after the chain kernel's own phase, the interpreter kernel's
    phase after them (on the ``kv_get`` store), the recovery drill, the
    resize, the racing writers and the services after the write path, on
    its store."""
    p = smoke.PHASES
    assert len(p) == len(set(p)) == 37
    assert p.index("kv_get") + 1 == p.index("kv_get_group")
    assert p.index("chain_faults") + 1 == p.index("chain_interp")
    assert p.index("lm_seamless") + 1 == p.index("lm_llama4")
    assert p.index("lm_llama4") + 1 == p.index("lm_llama4_nope")
    assert p.index("chain_kernel") + 1 == p.index("chain_faults")
    assert p.index("kv_write") + 1 == p.index("kv_faults")
    assert p.index("kv_faults") + 1 == p.index("kv_resize")
    assert p.index("kv_resize") + 1 == p.index("kv_contend")
    assert p.index("kv_contend") + 1 == p.index("kv_service")
    assert p.index("kv_service") + 1 == p.index("chain_programs")
    assert p.index("chain_programs") + 1 == p.index("cuckoo_get")
    assert p.index("cuckoo_get") < p.index("lm_prefill")
    assert p.index("wkv6_kernel") < p.index("wkv6_bwd_kernel")
    assert p.index("rglru_kernel") < p.index("rglru_bwd_kernel")
    assert p[-5:] == ("flash_bwd_kernel", "lm_train", "lm_train_bf16",
                      "lm_train_rwkv", "lm_train_griffin")


def test_phase_chain_faults_cpu(smoke):
    r = smoke.phase_chain_faults("cpu", n_buckets=64, mem_words=1024,
                                 n_keys=40, batch=16, max_steps=24)
    assert r["max_abs_err"] == 0 and r["launches"] == 0   # plain path
    assert r["contexts"] == [16, 3 * 25]
    assert r["interp_vs_plain"]["runs"] == 2
    assert r["interp_vs_plain"]["max_abs_err"] == 0
    assert r["truncated"] > 0 and r["storm_armed"] > 0
    assert r["drill_violations"] >= 0 and r["drill_retried"] > 0


@pytest.mark.parametrize("field, a, b, err", [
    ("mem", 3, -2, 5.0),
    ("clock", 1.5, math.inf, math.inf),
    ("clock", math.inf, math.inf, 0.0),
    ("clock", 0.0, -0.0, None),
])
def test_require_states_reports_the_largest_difference(smoke, field, a, b,
                                                       err):
    """``require_states`` returns what ``state_abs_err`` measured; any
    difference, a clock's sign bit included, raises."""
    s = smoke.machine.VMState(
        mem=torch.zeros(2, 4, dtype=torch.int32),
        clock=torch.zeros(2, 3), **{
            f: torch.zeros(1, dtype=torch.int32)
            for f in smoke.machine.VMState._fields
            if f not in ("mem", "clock")})
    x, y = smoke.machine._clone(s), smoke.machine._clone(s)
    getattr(x, field)[1, 2] = a
    getattr(y, field)[1, 2] = b
    assert smoke.require_states(x, x, "same") == 0.0
    assert smoke.state_abs_err(y, y) == 0.0
    if err == 0.0:
        assert smoke.require_states(x, y, "inf on both sides") == 0.0
        return
    with pytest.raises(AssertionError, match=field):
        smoke.require_states(x, y, "differs")
    if err is not None:
        assert smoke.state_abs_err(x, y) == err


def test_phase_kv_faults_cpu(smoke, write_store):
    dk, dv = write_store.device_arrays("cpu")
    r = smoke.phase_kv_faults("cpu", write_store, dk, dv)
    assert r["interrupted"] > 0 and r["armed"] >= r["interrupted"]
    assert r["set_batch"] == (2, 8)
    assert sorted(r["planted"]) == sorted(
        ("torn-claim", "neighborhood", "dup-key", "stale-row",
         "torn-vacate", "cross-frame-dup"))
    k, v = write_store.device_arrays("cpu")
    assert torch.equal(k, dk) and torch.equal(v, dv)


def test_plant_tears_names_each_kind_once(smoke, write_store):
    dk, dv = write_store.device_arrays("cpu")
    k, v, e, want = smoke.plant_tears(dk.numpy(), dv.numpy(), 8)
    rep = smoke.fsck.check_invariants(torch.from_numpy(k),
                                      torch.from_numpy(v), neighborhood=8,
                                      exp=torch.from_numpy(e))
    assert [(x.kind, x.shard, x.bucket, x.key)
            for x in rep.violations] == want
    assert len({w[0] for w in want}) == 5


def test_phase_chain_programs_cpu(smoke):
    """The toolchain phase at 32 guests and 64 list probes: the sweep
    equals BENCH_chains.json, the guests' kernel-backend batch (its plain
    version here) equals the interpreter and the oracle, the looping
    guest stops at its fuel, and break saves steps at position 0."""
    r = smoke.phase_chain_programs("cpu", n_guests=32, n_probes=64,
                                   time_it=False)
    assert r["sweep"] == "18/18" and r["launches"] == 0
    g = r["guests"]
    assert g["max_abs_err"] == 0 and g["guests"] == 32
    assert 10 <= g["halting"] == g["halted"] < 32
    assert g["steps_max"] == g["max_steps"] == 26 * 102
    assert g["shape"] == (32, 4096 + smoke.machine.GUARD_WORDS)
    lw = r["lists"]
    assert lw["probes"] == 64 and lw["break_saves_at_0"] > 0
    assert lw["steps_at_0"][True] < lw["steps_at_0"][False]


def test_guest_drive_refuses_a_wrong_cell(smoke, monkeypatch):
    """The guest check fails when the oracle disagrees with the chain."""
    real = smoke.turing.addleq_reference

    def off_by_one(instrs, mem, pc0, base, max_instrs=1000):
        m, n = real(instrs, mem, pc0, base, max_instrs)
        return {a: v + 1 for a, v in m.items()}, n

    monkeypatch.setattr(smoke.turing, "addleq_reference", off_by_one)
    with pytest.raises(AssertionError, match="oracle"):
        smoke.guest_drive("cpu", 12, 100, seed=1, time_it=False)


def test_phase_cuckoo_get_cpu(smoke):
    r = smoke.phase_cuckoo_get("cpu", log2_buckets=10, n_queries=1024,
                               time_it=False)
    assert r["keys"] == int(1024 * 4 * 0.9) and r["max_abs_err"] >= 0
    assert r["resident"] + r["failed_inserts"] == r["keys"]
    assert 0 < r["hits"] <= 512 + 1
    assert r["table_bytes"] == 1024 * 4 * 4 * (1 + 4)


@pytest.fixture
def one_thread():
    """One intra-op thread for the training rehearsals' tiny models, so
    that a parallel test run does not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_phase_flash_bwd_kernel_cpu(smoke, one_thread):
    """The backward phase at small shapes on the CPU: the plain versions
    stand in on both sides, so every error is 0 and nothing launches."""
    r = smoke.phase_flash_bwd_kernel(
        "cpu", shapes=(("tiny", 2, 4, 2, 64, 32, torch.float32, 0),),
        small=smoke.FLASH_BWD_SMALL[:2] + smoke.FLASH_BWD_SMALL[-1:],
        time_it=False)
    assert r["max_abs_err"] == 0 and len(r["errs"]) == 7
    assert r["shape"] == (2, 4, 2, 64, 64, 32, "float32")
    assert r["bound_by"] in ("bytes", "operations") and r["bound_ms"] > 0
    assert r["flops"] == 10 * 2 * 4 * 64 * 64 * 32 / 2


def test_phase_lm_train_cpu(smoke, tmp_path, one_thread):
    """The training phase at the smoke config on the CPU, with the AdamW
    settings of ``test_loss_decreases``: the witness (the plain attention
    both ways: equal), the loss falling over 40 steps, microbatches (loss
    and summed gradient), the int8 run and the bit-exact restart drill."""
    cfg = registry.smoke_config("smollm-135m")
    ocfg = smoke.train_opt.AdamWConfig(lr=1e-2, warmup_steps=3,
                                       total_steps=200, weight_decay=0.0)
    r = smoke.phase_lm_train("cpu", cfg=cfg, ocfg=ocfg, batch=16, seq=32,
                             steps=40, drill_seq=16, int8_steps=40,
                             ckpt_root=tmp_path, time_it=False)
    assert r["witness"]["loss"] == r["witness"]["plain_loss"]
    assert r["witness"]["worst_grad_rel_err"] == 0
    assert r["step_launches"] == {k: 0 for k in r["step_launches"]}
    assert r["restart"]["bit_equal"] and r["restart"]["resumed_at"] == 5
    assert len(r["losses"]) == 40
    assert r["microbatches"]["worst_grad_rel_err"] <= 1e-5
    assert not list(tmp_path.iterdir())       # the checkpoints are gone


def test_phase_lm_train_bf16_cpu(smoke, one_thread):
    """The bf16 training phase at qwen3's smoke config on the CPU: the
    three witnesses (the plain attention every way: equal), no launches,
    AdamW's float32 state and finite losses whose last is below the
    first."""
    cfg = dataclasses.replace(registry.smoke_config("qwen3-1.7b"),
                              dtype="bfloat16", remat="block")
    ocfg = smoke.train_opt.AdamWConfig(lr=1e-2, warmup_steps=3,
                                       total_steps=200, weight_decay=0.0)
    r = smoke.phase_lm_train_bf16("cpu", cfg=cfg, ocfg=ocfg, batch=16,
                                  seq=32, steps=40, time_it=False)
    w = r["witness"]
    assert w["loss"] == w["plain_loss"] == w["fma_loss"]
    assert w["worst_grad_rel_err"] == {"wgmma": 0.0, "fma": 0.0}
    assert r["step_launches"] == {k: 0 for k in r["step_launches"]}
    assert len(r["losses"]) == 40 and r["losses"][-1] < r["losses"][0]
    with pytest.raises(ValueError, match="bf16 model"):
        smoke.phase_lm_train_bf16("cpu", cfg=dataclasses.replace(
            cfg, dtype="float32"))


def test_ptxas_report_reads_each_instantiation(smoke):
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_125flash_"
        "bwd_dq_wgmma_kernelILi128EEEv14CUtensorMap_st' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_1",
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119flash_"
        "bwd_dq_kernelIfLi64EEEvPKT_' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 90 registers, used 1 barriers"])
    assert smoke.ptxas_report(log, smoke.BWD_WGMMA_KERNELS) == {
        "flash_bwd_dq_wgmma_kernel<128>": dict(
            registers=168, spill_stores=8, spill_loads=4)}


def test_ptxas_report_names_the_recurrences_instantiations(smoke):
    """The recurrences' backward kernels are templated on the type (and
    the head dim and chunk): each instantiation is reported by its
    arguments, and the gate wants every kernel reported and no spill."""
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121wkv6_"
        "bwd_chunk_kernelI13__nv_bfloat16Li64ELi16EEEvPKT_' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 126 registers, used 2 barriers",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121rglru_"
        "bwd_ring_kernelIfEEv14CUtensorMap_stS1_S1_PKfPT_S5_ii' for "
        "'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116rglru_"
        "bwd_kernelIfEEvPKT_S3_S3_PKfPS1_S6_ii' for 'sm_90a'",
        "    0 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 32 registers, used 0 barriers"])
    report = smoke.ptxas_report(log, smoke.RECURRENT_BWD_KERNELS)
    assert report == {
        "wkv6_bwd_chunk_kernel<bf16,64,16>": dict(
            registers=126, spill_stores=0, spill_loads=0),
        "rglru_bwd_ring_kernel<float>": dict(
            registers=40, spill_stores=0, spill_loads=0),
        "rglru_bwd_kernel<float>": dict(
            registers=32, spill_stores=4, spill_loads=4)}
    with pytest.raises(AssertionError, match="spills"):
        smoke.check_spill_free(report, smoke.RECURRENT_BWD_KERNELS)
    del report["rglru_bwd_kernel<float>"]
    with pytest.raises(AssertionError, match="no ptxas report"):
        smoke.check_spill_free(report, smoke.RECURRENT_BWD_KERNELS)
    smoke.check_spill_free(report, smoke.RECURRENT_BWD_KERNELS[:2])


@pytest.mark.parametrize("report,error", [
    ({"k<64>": dict(registers=168, spill_stores=0, spill_loads=0),
      "k<256>": dict(registers=168, spill_stores=0, spill_loads=0)}, None),
    # a build read from nowhere: the gate has nothing to pass
    ({}, "no ptxas report"),
    ({"k<64>": dict(registers=168, spill_stores=0, spill_loads=0)},
     r"no ptxas report for \['k<256>'\]"),
    ({"k<64>": dict(registers=168, spill_stores=0, spill_loads=0),
      "k<256>": dict(registers=255, spill_stores=8, spill_loads=4)},
     "spills")])
def test_ptxas_gate_needs_every_instantiation(smoke, report, error):
    if error is None:
        smoke.check_ptxas(report, ("k",), (64, 256))
    else:
        with pytest.raises(AssertionError, match=error):
            smoke.check_ptxas(report, ("k",), (64, 256))


def test_train_launches_count_the_remat(smoke):
    cfg = dataclasses.replace(registry.get_config("smollm-135m"),
                              dtype="float32")
    want = smoke.train_launches(cfg, "cuda")
    assert want == {"flash_attention": 60, "flash_attention.wgmma": 0,
                    "flash_attention.fma": 60, "flash_attention.bwd": 30,
                    "flash_attention.bwd_wgmma": 0,
                    "flash_attention.bwd_fma": 30,
                    "flash_attention.bwd_dq": 30,
                    "flash_attention.bwd_dkdv": 30}
    want = smoke.train_launches(dataclasses.replace(cfg, remat="none"),
                                "cuda")
    assert want["flash_attention.fma"] == 30
    assert set(smoke.train_launches(cfg, "cpu").values()) == {0}
    # lm_train_bf16's: qwen3-1.7b in bf16, all on the tensor cores
    want = smoke.train_launches(registry.get_config("qwen3-1.7b"), "cuda")
    assert want == {"flash_attention": 56, "flash_attention.wgmma": 56,
                    "flash_attention.fma": 0, "flash_attention.bwd": 28,
                    "flash_attention.bwd_wgmma": 28,
                    "flash_attention.bwd_fma": 0,
                    "flash_attention.bwd_dq": 28,
                    "flash_attention.bwd_dkdv": 28}


def test_plain_attention_patch_is_undone(smoke):
    from repro_torch.kernels.flash_attention import ops as fa_ops
    kernel = fa_ops.flash_attention
    with pytest.raises(ValueError):
        with smoke.plain_attention():
            assert fa_ops.flash_attention is not kernel
            raise ValueError
    assert fa_ops.flash_attention is kernel


def test_phase_wkv6_bwd_kernel_cpu(smoke, one_thread):
    """The WKV6 backward phase at a small shape on the CPU: the plain
    backward on both sides, so every error is 0 and nothing launches."""
    r = smoke.phase_wkv6_bwd_kernel("cpu", b=1, h=2, t=40, n=32,
                                    time_it=False)
    assert set(r["errs"]) == {f"{c}/{d}" for c in ("T40", "T21", "T1",
                                                    "tiny_1e-12",
                                                    "tiny_1e-30")
                              for d in ("bfloat16", "float32")} | {
        "dS/bfloat16", "small_decays/float32"}
    assert all(set(e) == set(smoke.WKV_BWD_NAMES)
               for e in r["errs"].values())
    assert r["max_abs_err"] == 0
    assert max(max(e.values()) for e in r["errs"].values()) == 0
    assert r["flops"] == 10 * 1 * 2 * 40 * 32 * 32
    # the products at the split-TF32 rate the kernel runs them by
    assert r["bound_by"] == "bytes" and r["bound_ms"] == pytest.approx(
        r["bytes"] / smoke.HBM_BYTES_PER_S * 1e3)
    assert r["flops"] / smoke.TF32X3_FLOP_PER_S < r["bytes"] / (
        smoke.HBM_BYTES_PER_S)


def test_phase_rglru_bwd_kernel_cpu(smoke, one_thread):
    r = smoke.phase_rglru_bwd_kernel("cpu", b=2, t=40, d=20, time_it=False)
    cases = [f"2x{t}x{d}" for t, d in ((40, 20), (21, 20), (1, 20), (97, 24),
                                       (33, 23))]
    assert set(r["errs"]) == {f"{p}/{c}/{t}" for p in ("da", "du")
                              for c in cases
                              for t in ("float32", "bfloat16")}
    assert r["max_abs_err"] == 0 and max(r["errs"].values()) == 0
    assert r["bytes"] == 5 * 2 * 40 * 20 * 4 and r["bound_by"] == "bytes"
    # the kernel each case launches on the card, as variant picks it
    assert r["variants"] == {
        f"{c}/{t}": smoke.rg_ops.variant(getattr(torch, t),
                                         int(c.split("x")[2]))
        for c in cases for t in ("float32", "bfloat16")}
    assert r["variants"]["2x1x20/float32"] == "ring"


def recurrent_smoke(arch):
    return dataclasses.replace(registry.smoke_config(arch),
                               dtype="bfloat16", remat="block")


@pytest.mark.parametrize("arch", ["rwkv6-7b", "recurrentgemma-9b"])
def test_phase_lm_train_recurrent_cpu(smoke, one_thread, arch):
    """The recurrent training drives at the smoke configs in bf16 on the
    CPU: the witness (the plain recurrences both ways: equal; the float64
    forward's yardstick apart), no launches, finite losses whose last is
    below the first; griffin's local-attention layer also has the flash
    backward checked at its shape (plain both ways)."""
    ocfg = smoke.train_opt.AdamWConfig(lr=1e-2, warmup_steps=3,
                                       total_steps=200, weight_decay=0.0)
    r = smoke.phase_lm_train_recurrent(
        "cpu", recurrent_smoke(arch), ocfg=ocfg, batch=4, seq=32, steps=12,
        witness_seq=16, time_it=False)
    w = r["witness"]
    assert w["loss"] == w["plain_loss"]
    assert w["worst_grad_rel_err"]["kernels"] == 0
    assert w["worst_grad_rel_err"]["float64"] < 0.5
    assert r["step_launches"] == {k: 0 for k in r["step_launches"]}
    assert {"wkv6", "wkv6_bwd", "rglru", "rglru_bwd", "rglru_bwd.ring",
            "rglru_bwd.direct"} <= set(r["step_launches"])
    assert len(r["losses"]) == 12 and r["losses"][-1] < r["losses"][0]
    if arch == "recurrentgemma-9b":
        fb = r["flash_backward"]
        assert fb["pair"] == "plain" and fb["window"] == 16
        assert fb["shape"] == (4, 4, 1, 32, 32, 32, "bfloat16")
    else:
        assert "flash_backward" not in r
    with pytest.raises(ValueError, match="bf16 model"):
        smoke.phase_lm_train_recurrent("cpu", dataclasses.replace(
            recurrent_smoke(arch), dtype="float32"))


def test_recurrent_train_launches_count_the_remat(smoke):
    """A step of the drives' cuts: each recurrence's forward once a layer
    and again under remat, its backward once a layer; griffin's local
    layer one flash forward twice and one tensor-core backward pair (D
    256)."""
    cfg = dataclasses.replace(registry.get_config("rwkv6-7b"), num_layers=8)
    want = smoke.recurrent_train_launches(cfg, "cuda")
    assert (want["wkv6"], want["wkv6_bwd"]) == (16, 8)
    assert want["flash_attention"] == want["rglru"] == want["rglru_bwd"] == 0
    cfg = dataclasses.replace(registry.get_config("recurrentgemma-9b"),
                              num_layers=3)
    want = smoke.recurrent_train_launches(cfg, "cuda")
    assert {k: want[k] for k in ("rglru", "rglru.ring", "rglru.direct",
                                 "rglru_bwd", "rglru_bwd.ring",
                                 "rglru_bwd.direct", "wkv6",
                                 "wkv6_bwd")} == dict(
        rglru=4, **{"rglru.ring": 4, "rglru.direct": 0}, rglru_bwd=2,
        **{"rglru_bwd.ring": 2, "rglru_bwd.direct": 0}, wkv6=0, wkv6_bwd=0)
    assert {k: want[f"flash_attention{k}"] for k in (
        "", ".wgmma", ".bwd", ".bwd_fma", ".bwd_wgmma")} == {
        "": 2, ".wgmma": 2, ".bwd": 1, ".bwd_fma": 0, ".bwd_wgmma": 1}
    assert set(smoke.recurrent_train_launches(cfg, "cpu").values()) == {0}
    assert [(k, a, n, b) for k, a, n, b in smoke.RECURRENT_TRAIN] == [
        ("lm_train_rwkv", "rwkv6-7b", 8, 4),
        ("lm_train_griffin", "recurrentgemma-9b", 3, 2)]


def test_plain_recurrence_patches_are_undone_and_count(smoke):
    from repro_torch.kernels.rglru import ops as rg_ops
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    kernels = wkv_ops.wkv6, rg_ops.rglru
    with pytest.raises(ValueError):
        with smoke.plain_recurrences():
            assert wkv_ops.wkv6 == smoke.PlainWKV6Fn.apply
            raise ValueError
    assert (wkv_ops.wkv6, rg_ops.rglru) == kernels
    calls = {}
    a = torch.full((1, 3, 4), 0.5)
    with smoke.counted_plain_calls(calls):
        rg_ops.rglru(a, a)
    assert calls["rglru_reference"] == 1 and calls["wkv6_reference"] == 0
    assert rg_ops.rglru_reference is smoke.rg_ref.rglru_reference
