"""The port's optimizer, bf16 gradient wire and gradient compression
against the JAX package's, on the CPU, at the smoke configs of
smollm-135m and gemma3-1b: AdamW with float32 moments and with int8
moments (with and without the master) fed the JAX gradients, its state
held within 1e-6 of each leaf's largest magnitude and its int8 codes
within 1 in under 0.1% of the entries (a value on a rounding edge); the
state's round trip through the JAX layout; ``wire_dtype="bfloat16"``;
``compress_with_feedback`` and the compressed train step."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _train_parity import (ARCHS, OCFG, REL, STATE_REL, capture, fresh,
                           jax_grads, leaf_close, rel_close, setup, to_jax,
                           to_port)
from repro.distributed import compression as jcomp
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro_torch import convert
from repro_torch.distributed import compression as tcomp
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


MOMENTS = {"float32": dict(moments_dtype="float32"),
           "int8_master": dict(moments_dtype="int8", master=True),
           "int8_masterless": dict(moments_dtype="int8", master=False)}


def state_close(tstate, jstate_np, cfg, what):
    want = convert.adamw_state_from_numpy(jstate_np, cfg, "cpu")
    assert int(tstate.step) == int(want.step)
    assert (tstate.master is None) == (want.master is None)
    for field in ("mu", "nu", "master"):
        got_f, want_f = getattr(tstate, field), getattr(want, field)
        if want_f is None:
            continue
        for name, w in want_f.items():
            g = got_f[name]
            if isinstance(w, dict):
                assert g["q"].dtype == torch.int8
                diff = (g["q"].int() - w["q"].int()).abs()
                assert int(diff.max()) <= 1, (what, field, name)
                assert int((diff > 0).sum()) <= 1e-3 * diff.numel(), \
                    (what, field, name, int((diff > 0).sum()))
                leaf_close(g["s"], w["s"].numpy(), STATE_REL,
                           f"{what} {field}/{name}/s")
            else:
                leaf_close(g, w.numpy(), STATE_REL,
                           f"{what} {field}/{name}")


@pytest.mark.parametrize("moments", sorted(MOMENTS))
def test_optimizer_fed_jax_grads_matches_jax(arch, moments):
    """Three updates, each taken by both optimizers from the JAX state and
    parameters of the step before (carried across by ``convert``), with
    the JAX gradients of that step's batch.  (A carried-over code that
    differs by one would move the next update of its entry by up to a
    code's worth: each update is held from the same inputs.)"""
    a = arch
    ocfg_j = jopt.AdamWConfig(**OCFG, **MOMENTS[moments])
    ocfg_t = topt.AdamWConfig(**OCFG, **MOMENTS[moments])
    jparams, jstate = a["jp"], jopt.init(a["jp"], ocfg_j)
    tp = fresh(a)
    state_close(topt.init(tp, ocfg_t),
                jax.tree_util.tree_map(np.asarray, jstate), a["tcfg"],
                f"{moments} init")
    jupdate = jax.jit(functools.partial(jopt.update, ocfg_j))
    for i, batch in enumerate(a["batches"]):
        tp = convert.lm_params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jparams), a["tcfg"], "cpu")
        tstate = convert.adamw_state_from_numpy(
            jax.tree_util.tree_map(np.asarray, jstate), a["tcfg"], "cpu")
        _, jg_tree = a["grad_fn"](jparams, to_jax(batch), a["jcfg"])
        jparams, jstate, jm = jupdate(jg_tree, jstate, jparams)
        tg = {n: torch.from_numpy(np.array(g)) for n, g in
              convert.lm_param_leaves(jax.tree_util.tree_map(
                  np.asarray, jg_tree), a["tcfg"]).items()}
        _, tstate, tm = topt.update(ocfg_t, tg, tstate, tp)
        rel_close(tm["grad_norm"], jm["grad_norm"], STATE_REL, "grad_norm")
        rel_close(tm["lr"], jm["lr"], STATE_REL, "lr")
        state_close(tstate, jax.tree_util.tree_map(np.asarray, jstate),
                    a["tcfg"], f"{moments} step {i + 1}")
        named = dict(tp.named_parameters())
        for name, want in convert.lm_param_leaves(jax.tree_util.tree_map(
                np.asarray, jparams), a["tcfg"]).items():
            leaf_close(named[name], want, STATE_REL,
                       f"{moments} step {i + 1} {name}")


@pytest.mark.parametrize("moments", ["float32", "int8_masterless"])
def test_adamw_state_round_trips_to_the_jax_layout(arch, moments):
    a = arch
    ocfg = jopt.AdamWConfig(**OCFG, **MOMENTS[moments])
    _, g = a["grad_fn"](a["jp"], to_jax(a["batches"][0]), a["jcfg"])
    _, jstate, _ = jopt.update(ocfg, g, jopt.init(a["jp"], ocfg), a["jp"])
    jnp_state = jax.tree_util.tree_map(np.asarray, jstate)
    back = convert.adamw_state_to_numpy(
        convert.adamw_state_from_numpy(jnp_state, a["tcfg"], "cpu"),
        a["tcfg"])
    want_leaves, want_def = jax.tree_util.tree_flatten(jnp_state._asdict())
    got_leaves, got_def = jax.tree_util.tree_flatten(back)
    assert got_def == want_def
    for got, want in zip(got_leaves, want_leaves):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    # and the JAX package's update takes it back as its own
    jopt.update(ocfg, g, jopt.AdamWState(
        **jax.tree_util.tree_map(jnp.asarray, back)), a["jp"])


def test_wire_dtype_bfloat16_matches_jax(arch):
    a = arch
    ocfg_j, ocfg_t = jopt.AdamWConfig(**OCFG), topt.AdamWConfig(**OCFG)
    batch = a["batches"][0]
    jstep = jax.jit(jloop.make_train_step(a["jcfg"], ocfg_j,
                                          wire_dtype="bfloat16"))
    _, _, jm = jstep(a["jp"], jopt.init(a["jp"]), to_jax(batch))
    tp, seen = fresh(a), {}
    tstep = tloop.make_train_step(a["tcfg"], ocfg_t, wire_dtype="bfloat16",
                                  grad_constraint=capture(seen))
    _, _, tm = tstep(tp, topt.init(tp), to_port(batch))
    for key in ("loss", "lr"):
        rel_close(tm[key], jm[key], REL, key)
    # bf16 grads: a float32 gradient within REL may round to the next bf16
    # value (2^-8 relative) where it lies on a rounding edge
    rel_close(tm["grad_norm"], jm["grad_norm"], 1e-4, "grad_norm")
    _, jg = jax_grads(a, batch)
    for name, want in jg.items():
        assert seen[name].dtype == torch.bfloat16
        leaf_close(seen[name], jnp.asarray(want).astype(jnp.bfloat16),
                   2 ** -7, f"bf16 d {name}")


def test_compress_with_feedback_matches_jax(arch):
    """Both packages' error-feedback compression over three rounds of the
    JAX gradients, given as the same dict of per-layer tensors (the port
    scales each layer's tensor; the JAX package, which stacks a pattern
    position's layers, scales a stack as one tensor)."""
    a = arch
    names = list(convert.lm_param_leaves(a["tree"], a["tcfg"]))
    jerr = {n: jnp.zeros(np.shape(t), jnp.float32) for n, t in
            convert.lm_param_leaves(a["tree"], a["tcfg"]).items()}
    terr = tcomp.init_error(fresh(a))
    assert set(terr) == set(names)
    for batch in a["batches"]:
        _, jg = jax_grads(a, batch)
        jdeq, jerr, jratio = jcomp.compress_with_feedback(
            {n: jnp.asarray(g) for n, g in jg.items()}, jerr)
        tdeq, terr, tratio = tcomp.compress_with_feedback(
            {n: torch.from_numpy(np.array(g)) for n, g in jg.items()}, terr)
        assert tratio == jratio == 0.25
        for name in names:
            leaf_close(tdeq[name], jdeq[name], STATE_REL, f"deq {name}")
            leaf_close(terr[name], jerr[name], STATE_REL, f"error {name}")


def test_compressed_train_step_matches_jax(arch):
    a = arch
    ocfg_j, ocfg_t = jopt.AdamWConfig(**OCFG), topt.AdamWConfig(**OCFG)
    jstep = jax.jit(jloop.make_train_step(a["jcfg"], ocfg_j,
                                          compress_grads=True))
    _, _, _, jm = jstep(a["jp"], jopt.init(a["jp"]),
                        to_jax(a["batches"][0]), jcomp.init_error(a["jp"]))
    tp = fresh(a)
    tstep = tloop.make_train_step(a["tcfg"], ocfg_t, compress_grads=True)
    _, _, err, tm = tstep(tp, topt.init(tp), to_port(a["batches"][0]),
                          tcomp.init_error(tp))
    assert tm["wire_ratio"] == jm["wire_ratio"] == 0.25
    for key in ("loss", "grad_norm", "lr"):
        rel_close(tm[key], jm[key], REL, key)


