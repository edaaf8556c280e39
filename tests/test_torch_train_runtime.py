"""The port's training runtime on the CPU, mirroring the JAX package's
``tests/test_train_runtime.py``: the loss decreases, a crash and resume
is bit-exact, error feedback is contractive, int8-moment AdamW trains;
and a torn checkpoint write is invisible, remat changes no number, the
launcher runs and resumes, and a meta-device template restores."""
import copy
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.distributed import compression, fault
from repro_torch.launch import train as launch_train
from repro_torch.models import model as M
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import loop as loop_lib
from repro_torch.train import optimizer as opt_lib


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The models here are tiny: one intra-op thread, so that a parallel
    test run does not oversubscribe the cores (several threads a worker
    made these steps tens of times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_setup():
    cfg = registry.smoke_config("smollm-135m")
    params = M.init_params(cfg, seed=0, device="cpu")
    ocfg = opt_lib.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=50)
    return cfg, params, ocfg


def make_batches(cfg, n, b=4, s=32, seed=3):
    pipe = TokenPipeline(cfg.vocab_size, s, b, seed=seed)
    return [{k: torch.from_numpy(v) for k, v in pipe.batch_at(i).items()}
            for i in range(n)]


def test_loss_decreases(tiny_setup):
    cfg, params0, _ = tiny_setup
    params = copy.deepcopy(params0)
    ocfg = opt_lib.AdamWConfig(lr=1e-2, warmup_steps=3, total_steps=200,
                               weight_decay=0.0)
    opt_state = opt_lib.init(params)
    step = loop_lib.make_train_step(cfg, ocfg)
    losses = []
    for b in make_batches(cfg, 40, b=16):
        params, opt_state, m = step(params, opt_state, b)
        losses.append(float(m["loss"]))
    assert min(losses[-5:]) < losses[0] - 0.3, losses


def test_grad_accumulation_matches_full_batch(tiny_setup):
    cfg, params0, ocfg = tiny_setup
    batch = make_batches(cfg, 1, b=4)[0]
    p1, p2 = copy.deepcopy(params0), copy.deepcopy(params0)
    loop_lib.make_train_step(cfg, ocfg, microbatches=1)(
        p1, opt_lib.init(p1), batch)
    loop_lib.make_train_step(cfg, ocfg, microbatches=2)(
        p2, opt_lib.init(p2), batch)
    for (name, a), b_ in zip(p1.named_parameters(), p2.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b_.detach().numpy(),
                                   atol=2e-5, err_msg=name)


def _state_arrays(params, opt_state):
    return ckpt._flatten({"params": params, "opt": opt_state})


def test_checkpoint_restart_bit_exact(tiny_setup, tmp_path):
    """Crash at step 7, resume from the step-5 checkpoint -> identical
    parameters and optimizer state, bit for bit."""
    cfg, params0, ocfg = tiny_setup
    step = loop_lib.make_train_step(cfg, ocfg)
    pipe = TokenPipeline(cfg.vocab_size, 32, 4, seed=5)

    def batch_fn(i):
        return {k: torch.from_numpy(v) for k, v in pipe.batch_at(i).items()}

    ctl = fault.TrainController(step, batch_fn, str(tmp_path / "ck"),
                                ckpt_every=5)
    p = copy.deepcopy(params0)
    p_ref, o_ref, _ = ctl.run(p, opt_lib.init(p), 0, 10)

    ctl2 = fault.TrainController(step, batch_fn, str(tmp_path / "ck2"),
                                 ckpt_every=5)
    p = copy.deepcopy(params0)
    with pytest.raises(RuntimeError, match="simulated node failure at 7"):
        ctl2.run(p, opt_lib.init(p), 0, 10, crash_at=7)
    assert ckpt.latest_step(str(tmp_path / "ck2")) == 5
    p, o, step_resumed = ctl2.resume(M.abstract_params(cfg),
                                     opt_lib.abstract_init(params0), "cpu")
    assert step_resumed == 5
    p_fin, o_fin, end = ctl2.run(p, o, step_resumed, 10)
    assert end == 10
    want, got = _state_arrays(p_ref, o_ref), _state_arrays(p_fin, o_fin)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_torn_write_is_invisible(tiny_setup, tmp_path):
    """A payload whose manifest never landed (the crash between the two
    writes) is not a checkpoint: ``latest_step`` skips it."""
    cfg, params, _ = tiny_setup
    d = str(tmp_path / "ck")
    assert ckpt.latest_step(d) is None
    ckpt.save(d, 5, {"params": params})
    ckpt.save(d, 10, {"params": params})
    os.remove(os.path.join(d, "manifest_00000010.json"))
    assert os.path.exists(os.path.join(d, "step_00000010.npz"))
    assert ckpt.latest_step(d) == 5
    with open(os.path.join(d, "step_00000015.npz"), "wb") as f:
        f.write(b"torn")
    assert ckpt.latest_step(d) == 5


def test_checkpoint_keys_and_int8_restore(tiny_setup, tmp_path):
    """Keys are ``name::path`` (parameter names, AdamWState fields, int8
    moments' q and s); an int8, master-less state restores exactly into a
    meta-device template."""
    cfg, params, _ = tiny_setup
    ocfg = opt_lib.AdamWConfig(moments_dtype="int8", master=False)
    state = opt_lib.init(params, ocfg)
    g = {n: torch.randn(p.shape, generator=torch.Generator().manual_seed(1))
         for n, p in params.named_parameters()}
    p = copy.deepcopy(params)
    _, state, _ = opt_lib.update(ocfg, g, state, p)
    path = ckpt.save(str(tmp_path), 1, {"params": p, "opt": state})
    with np.load(path) as npz:
        keys = set(npz.files)
    assert "params::embed.embedding" in keys
    assert "opt::step" in keys and "opt::mu/final_norm/q" in keys
    assert "opt::nu/decoder.0.attn.wq/s" in keys
    assert not any(k.startswith("opt::master") for k in keys)
    out = ckpt.restore(str(tmp_path), 1, {
        "params": M.abstract_params(cfg),
        "opt": opt_lib.abstract_init(params, ocfg)}, "cpu")
    assert out["opt"].master is None
    assert out["opt"].mu["final_norm"]["q"].dtype == torch.int8
    want, got = _state_arrays(p, state), _state_arrays(out["params"],
                                                       out["opt"])
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_compression_error_feedback_is_contractive():
    rng = np.random.RandomState(0)
    err = compression.init_error({"w": torch.zeros(64, 64)})
    total_true = np.zeros((64, 64), np.float32)
    total_applied = np.zeros((64, 64), np.float32)
    for _ in range(20):
        gi = {"w": torch.from_numpy(rng.randn(64, 64).astype(np.float32))}
        total_true += gi["w"].numpy()
        deq, err, ratio = compression.compress_with_feedback(gi, err)
        total_applied += deq["w"].numpy()
    # error feedback: cumulative applied ~= cumulative true (residual
    # bounded)
    resid = np.abs(total_applied + err["w"].numpy() - total_true).max()
    assert resid < 1e-3
    assert ratio == 0.25


def test_int8_moment_adamw_trains(tiny_setup):
    """Master-less int8 moments (``tests/test_optimizations.py``'s test):
    the loss still falls, the moments stay int8 with float32 per-row
    scales, and no master is kept."""
    cfg, params0, _ = tiny_setup
    params = copy.deepcopy(params0)
    ocfg = opt_lib.AdamWConfig(lr=1e-2, warmup_steps=3, total_steps=200,
                               weight_decay=0.0, moments_dtype="int8",
                               master=False)
    opt_state = opt_lib.init(params, ocfg)
    step = loop_lib.make_train_step(cfg, ocfg)
    losses = []
    for b in make_batches(cfg, 40, b=16):
        params, opt_state, m = step(params, opt_state, b)
        losses.append(float(m["loss"]))
    assert min(losses[-5:]) < losses[0] - 0.25, losses
    assert opt_state.master is None
    for mom in (opt_state.mu, opt_state.nu):
        for x in mom.values():
            assert x["q"].dtype == torch.int8
            assert x["s"].dtype == torch.float32
            assert x["s"].shape == x["q"].shape[:-1] + (1,)


@pytest.mark.parametrize("remat", ["block", "full", "dots"])
def test_remat_changes_no_number(tiny_setup, remat):
    """remat="block"/"full"/"dots" recompute the groups' forward in the
    backward pass: the same loss and gradients as "none", bit for bit."""
    cfg, params0, _ = tiny_setup
    batch = make_batches(cfg, 1)[0]
    out = {}
    for mode in ("none", remat):
        c = dataclasses.replace(cfg, remat=mode)
        p = copy.deepcopy(params0)
        seen = {}
        step = loop_lib.make_train_step(
            c, opt_lib.AdamWConfig(),
            grad_constraint=lambda g, seen=seen: seen.update(g) or g)
        _, _, m = step(p, opt_lib.init(p), batch)
        out[mode] = (float(m["loss"]), seen)
    assert out["none"][0] == out[remat][0]
    for name, g in out["none"][1].items():
        torch.testing.assert_close(out[remat][1][name], g, rtol=0, atol=0)


def test_remat_recomputes_the_attention_forward(tiny_setup, monkeypatch):
    """Under remat="block" the attention forward (on the CPU, its plain
    version inside ``FlashAttentionFn``) runs twice a layer per step (the
    forward, and again in the backward pass) and its backward once; under
    "none" once each."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = fa_ops.attention_reference_lse, fa_ops.flash_attention_backward

    def count_fwd(*a, **k):
        calls["fwd"] += 1
        return fwd(*a, **k)

    def count_bwd(*a, **k):
        calls["bwd"] += 1
        return bwd(*a, **k)
    monkeypatch.setattr(fa_ops, "attention_reference_lse", count_fwd)
    monkeypatch.setattr(fa_ops, "flash_attention_backward", count_bwd)
    cfg, params0, _ = tiny_setup
    batch = make_batches(cfg, 1)[0]
    for mode, want in (("none", 1), ("block", 2)):
        calls.update(fwd=0, bwd=0)
        p = copy.deepcopy(params0)
        loop_lib.make_train_step(dataclasses.replace(cfg, remat=mode),
                                 opt_lib.AdamWConfig())(
            p, opt_lib.init(p), batch)
        assert calls == {"fwd": want * cfg.num_layers,
                         "bwd": cfg.num_layers}, (mode, calls)


def test_params_need_no_grad_outside_the_train_step(tiny_setup):
    cfg, params, _ = tiny_setup
    fresh = M.init_params(cfg, seed=1, device="cpu")
    assert not any(p.requires_grad for p in fresh.parameters())


def test_launcher_trains_checkpoints_and_resumes(tmp_path, capsys):
    d = str(tmp_path / "ck")
    argv = ["--device", "cpu", "--smoke", "--steps", "26", "--batch", "4",
            "--seq", "16", "--ckpt", d]
    params, opt, m = launch_train.main(argv)
    assert ckpt.latest_step(d) == 25 and int(opt.step) == 26
    assert np.isfinite(float(m["loss"]))
    params2, opt2, _ = launch_train.main(argv + ["--resume"])
    out = capsys.readouterr().out
    assert "[train] resumed at step 25" in out and "[train] done" in out
    assert int(opt2.step) == 26
    for (name, a), b in zip(params.named_parameters(),
                            params2.parameters()):
        np.testing.assert_array_equal(a.detach().numpy(),
                                      b.detach().numpy(), err_msg=name)


def test_launcher_compressed_microbatched(capsys):
    launch_train.main(["--device", "cpu", "--smoke", "--steps", "3",
                       "--batch", "4", "--seq", "16", "--microbatches", "2",
                       "--compress-grads"])
    assert "[train] done" in capsys.readouterr().out
