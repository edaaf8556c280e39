"""The port's train step against the JAX package's, on the CPU, at the
smoke configs of smollm-135m and gemma3-1b (sliding window and qk-norm):
the same parameters (carried by ``convert``) and the same
``TokenPipeline`` batches through ``make_train_step`` of each package —
one step (loss, grad_norm, lr and every gradient within 1e-5), two
microbatches, and a 3-step loss trajectory (within 1e-4 relative).  The
optimizer, the bf16 wire and the compression are in
``test_torch_train_opt.py``; the helpers in ``_train_parity.py``."""
import dataclasses

import jax
import pytest
import torch

from _train_parity import (ARCHS, OCFG, REL, capture, fresh, jax_grads,
                           leaf_close, rel_close, setup, to_jax, to_port)
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro_torch.train import loop as tloop
from repro_torch.train import optimizer as topt


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The models here are tiny: one intra-op thread, so that a parallel
    test run does not oversubscribe the cores (several threads a worker
    made these steps tens of times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    return setup(request.param)


def test_train_step_matches_jax(arch):
    a = arch
    ocfg_t = topt.AdamWConfig(**OCFG)
    _, _, jm = a["step"](a["jp"], jopt.init(a["jp"]),
                         to_jax(a["batches"][0]))
    _, jg = jax_grads(a, a["batches"][0])

    tp, seen = fresh(a), {}
    tstep = tloop.make_train_step(a["tcfg"], ocfg_t,
                                  grad_constraint=capture(seen))
    _, state, tm = tstep(tp, topt.init(tp), to_port(a["batches"][0]))
    for key in ("loss", "ce", "grad_norm", "lr"):
        rel_close(tm[key], jm[key], REL, key)
    assert int(state.step) == 1
    assert set(seen) == set(jg)
    for name, want in jg.items():
        leaf_close(seen[name], want, REL, f"{a['name']}: d {name}")


def test_microbatches_match_jax(arch):
    """microbatches=2 on both sides: the loss, the last microbatch's ce
    (which rows it holds: rows j, j + 2, ...), grad_norm, and the summed
    gradient, which equals the whole batch's."""
    a = arch
    ocfg_j, ocfg_t = jopt.AdamWConfig(**OCFG), topt.AdamWConfig(**OCFG)
    batch = a["batches"][1]
    jstep = jax.jit(jloop.make_train_step(a["jcfg"], ocfg_j,
                                          microbatches=2))
    _, _, jm = jstep(a["jp"], jopt.init(a["jp"]), to_jax(batch))
    _, jg = jax_grads(a, batch)
    tp, seen = fresh(a), {}
    tstep = tloop.make_train_step(a["tcfg"], ocfg_t, microbatches=2)
    _, _, tm = tstep(tp, topt.init(tp), to_port(batch))
    for key in ("loss", "ce", "grad_norm", "lr"):
        rel_close(tm[key], jm[key], REL, key)
    # the accumulated gradient, from a grad_constraint on the running sum
    tp = fresh(a)
    calls = []
    tloop.make_train_step(a["tcfg"], ocfg_t, microbatches=2,
                          grad_constraint=lambda g: calls.append(g) or g)(
        tp, topt.init(tp), to_port(batch))
    # calls: zero sum, mb 0 grads, sum, mb 1 grads, sum
    assert len(calls) == 5
    for name, want in jg.items():
        leaf_close(calls[-1][name] / 2, want, REL, f"accumulated d {name}")
    # the fold: microbatch 1 holds rows 1 and 3
    odd = {k: v[1::2] for k, v in batch.items()}
    lo, _ = jax_grads(a, odd)
    rel_close(tm["ce"], lo, REL, "last microbatch's ce = rows 1, 3")


def test_three_step_loss_trajectory_matches_jax(arch):
    a = arch
    tstep = tloop.make_train_step(a["tcfg"], topt.AdamWConfig(**OCFG))
    jp, js = a["jp"], jopt.init(a["jp"])
    tp = fresh(a)
    ts = topt.init(tp)
    for i, batch in enumerate(a["batches"]):
        jp, js, jm = a["step"](jp, js, to_jax(batch))
        tp, ts, tm = tstep(tp, ts, to_port(batch))
        rel_close(tm["loss"], jm["loss"], 1e-4, f"loss at step {i}")


def test_configs_are_the_smoke_ones(arch):
    a = arch
    assert dataclasses.asdict(a["tcfg"]) == dataclasses.asdict(a["jcfg"])
