"""The port's train step against the JAX package's, on the CPU, for the
recurrent archs at their smoke configs: rwkv6-7b (WKV6) and
recurrentgemma-9b (RG-LRU and local attention).  The same parameters
(carried by ``convert``) and the same ``TokenPipeline`` batches through
``make_train_step`` of each package: one step (loss, grad_norm, lr and
every gradient within 1e-5), two microbatches, and a 3-step loss
trajectory (within 1e-4 relative).  The port's recurrences take their
gradient from the plain backwards here (``WKV6Fn`` / ``RGLRUFn`` on CPU
tensors), JAX's from autodiff of its chunked forms; but for rwkv6-7b from
its scan (``attn_impl="scan"``, which the port's config carries and
ignores): at this smoke setup JAX's chunked gradient is not finite
(ROADMAP queue 3)
(``test_jax_chunked_rwkv6_gradient_is_not_finite_here``).  Helpers in
``_train_parity.py``.

Also the port's counterpart of ``tests/test_optimizations.py::
test_grad_wire_and_constraint_do_not_change_training_much``: a bf16
gradient wire tracks the float32 one over 6 steps."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _train_parity import (OCFG, REL, capture, fresh, jax_grads, leaf_close,
                           rel_close, setup, to_jax, to_port)
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro_torch.configs import registry as treg
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models import model as tmodel
from repro_torch.train import loop as tloop
from repro_torch.train import optimizer as topt

ARCHS = ("rwkv6-7b", "recurrentgemma-9b")
# the JAX package's WKV6 form for each arch's reference step
IMPL = {"rwkv6-7b": dict(attn_impl="scan"), "recurrentgemma-9b": {}}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these tiny models (several threads a
    worker under a parallel run made such steps tens of times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    return setup(request.param, **IMPL[request.param])


def test_jax_chunked_rwkv6_gradient_is_not_finite_here():
    """The reference's fault at the model level: the chunked WKV6 form
    (the JAX model's default) divides k_t by the chunk's cumulative decay
    W_t, so its gradient carries 1 / W_t^2; in rwkv6-7b's smoke step W_t
    reaches ~3e-22 in layer 1 (decays down to ~0.10 over 24 steps), the
    square leaves float32's range, and JAX's gradient holds non-finite
    values, while the port's is finite."""
    a = setup("rwkv6-7b")
    _, jg = jax_grads(a, a["batches"][0])
    assert not all(np.isfinite(g).all() for g in jg.values())
    tp = fresh(a)
    tstep = tloop.make_train_step(a["tcfg"], topt.AdamWConfig(**OCFG))
    _, _, tm = tstep(tp, topt.init(tp), to_port(a["batches"][0]))
    assert np.isfinite(float(tm["grad_norm"]))


def test_recurrent_train_step_matches_jax(arch):
    a = arch
    _, _, jm = a["step"](a["jp"], jopt.init(a["jp"]),
                         to_jax(a["batches"][0]))
    _, jg = jax_grads(a, a["batches"][0])
    tp, seen = fresh(a), {}
    tstep = tloop.make_train_step(a["tcfg"], topt.AdamWConfig(**OCFG),
                                  grad_constraint=capture(seen))
    _, state, tm = tstep(tp, topt.init(tp), to_port(a["batches"][0]))
    for key in ("loss", "ce", "grad_norm", "lr"):
        rel_close(tm[key], jm[key], REL, key)
    assert int(state.step) == 1
    assert set(seen) == set(jg)
    for name, want in jg.items():
        leaf_close(seen[name], want, REL, f"{a['name']}: d {name}")


def test_recurrent_microbatches_match_jax(arch):
    """microbatches=2 on both sides: loss, the last microbatch's ce,
    grad_norm, and the summed gradient, which equals the whole batch's."""
    a = arch
    batch = a["batches"][1]
    jstep = jax.jit(jloop.make_train_step(
        a["jcfg"], jopt.AdamWConfig(**OCFG), microbatches=2))
    _, _, jm = jstep(a["jp"], jopt.init(a["jp"]), to_jax(batch))
    _, jg = jax_grads(a, batch)
    tp, calls = fresh(a), []
    tstep = tloop.make_train_step(
        a["tcfg"], topt.AdamWConfig(**OCFG), microbatches=2,
        grad_constraint=lambda g: calls.append(g) or g)
    _, _, tm = tstep(tp, topt.init(tp), to_port(batch))
    for key in ("loss", "ce", "grad_norm", "lr"):
        rel_close(tm[key], jm[key], REL, key)
    assert len(calls) == 5      # zero sum, mb 0, sum, mb 1, sum
    for name, want in jg.items():
        leaf_close(calls[-1][name] / 2, want, REL, f"accumulated d {name}")


def test_recurrent_three_step_loss_trajectory_matches_jax(arch):
    a = arch
    tstep = tloop.make_train_step(a["tcfg"], topt.AdamWConfig(**OCFG))
    jp, js = a["jp"], jopt.init(a["jp"])
    tp = fresh(a)
    ts = topt.init(tp)
    for i, batch in enumerate(a["batches"]):
        jp, js, jm = a["step"](jp, js, to_jax(batch))
        tp, ts, tm = tstep(tp, ts, to_port(batch))
        rel_close(tm["loss"], jm["loss"], 1e-4, f"loss at step {i}")


def test_recurrent_configs_are_the_smoke_ones(arch):
    a = arch
    assert dataclasses.asdict(a["tcfg"]) == dataclasses.asdict(a["jcfg"])
    kinds = {a["tcfg"].layer_type(i) for i in range(a["tcfg"].num_layers)}
    assert kinds & {"rwkv", "recurrent"}


def test_grad_wire_and_constraint_do_not_change_training_much():
    """bf16 gradient wire: the loss trajectory of 6 steps at microbatches=2
    tracks the float32 wire's (the JAX test's settings and tolerance)."""
    cfg = treg.smoke_config("smollm-135m")
    ocfg = topt.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=50)
    pipe = TokenPipeline(cfg.vocab_size, 32, 8, seed=1)
    batches = [{k: torch.from_numpy(v) for k, v in pipe.batch_at(i).items()}
               for i in range(6)]
    traj = {}
    for wire in (None, "bfloat16"):
        p = tmodel.init_params(cfg, seed=0, device="cpu")
        o = topt.init(p)
        step = tloop.make_train_step(cfg, ocfg, microbatches=2,
                                     wire_dtype=wire)
        losses = []
        for bt in batches:
            p, o, m = step(p, o, bt)
            losses.append(float(m["loss"]))
        traj[wire] = losses
    np.testing.assert_allclose(traj[None], traj["bfloat16"], rtol=0.02)
    assert traj[None] != traj["bfloat16"]        # the wire did round


def test_adamw_updates_its_state_in_place():
    """The update writes the float32 moments and master in place (a
    functional update would hold two of each at once, which the
    recurrent drives' cuts cannot spare on one card); the parameters
    take the master's new values."""
    cfg = treg.smoke_config("smollm-135m")
    p = tmodel.init_params(cfg, seed=0, device="cpu")
    state = topt.init(p)
    before = {f: {n: t.clone() for n, t in getattr(state, f).items()}
              for f in ("mu", "nu", "master")}
    ids = {f: {n: id(t) for n, t in getattr(state, f).items()}
           for f in ("mu", "nu", "master")}
    g = {n: torch.ones_like(t) for n, t in p.named_parameters()}
    _, new, _ = topt.update(topt.AdamWConfig(**OCFG), g, state, p)
    for f in ("mu", "nu", "master"):
        for n, t in getattr(new, f).items():
            assert id(t) == ids[f][n], (f, n)
            assert not torch.equal(t, before[f][n]), (f, n)
    for n, t in p.named_parameters():
        assert torch.equal(t, new.master[n].to(t.dtype))
