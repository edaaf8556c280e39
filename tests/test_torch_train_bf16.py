"""The port's bf16 train step against the JAX package's, on the CPU, at
the smoke configs of qwen3-1.7b (qk-norm) and smollm-135m with
``dtype="bfloat16"``: the same parameters (carried by ``convert``) and the
same ``TokenPipeline`` batch through ``make_train_step`` of each package,
one step.  Both packages keep AdamW's master and moments in float32 and
the parameters in their own types (the matrices bf16, the norms float32).

Tolerances.  The two packages round to bf16 after different operations,
so a gradient differs by the model's own bf16 rounding, not by summation
order: measured, the port's gradients lie as far from JAX's bf16 ones as
JAX's bf16 gradients lie from its float32 ones (the largest leaf error
0.017-0.021 of the leaf's largest magnitude against a float32 distance of
0.017-0.019).  So each gradient is held within GRAD_K times that float32
distance (the largest over the model's leaves, from JAX's own float32 step
on the same parameters); a wrong gradient (a dropped term, a transposed
weight) moves a leaf by O(1) of its size.  The loss, ce and grad_norm sum
float32 terms of bf16 values: held within SCALAR_REL (half a bf16 unit,
2^-9, against measured 1e-5 and 3e-4); lr exactly."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import _lm_parity as lp
from _train_parity import (OCFG, batches, capture, rel_close, to_jax,
                           to_port)
from repro.configs import registry as jreg
from repro.models import model as JM
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.train import loop as tloop
from repro_torch.train import optimizer as topt

ARCHS = ("qwen3-1.7b", "smollm-135m")
GRAD_K = 2.0
SCALAR_REL = 2.0 ** -9


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the models are tiny, and several threads a
    worker oversubscribe the cores of a parallel test run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(grads, tcfg):
    return {n: np.asarray(a, np.float32) for n, a in convert.lm_param_leaves(
        jax.tree_util.tree_map(np.asarray, grads), tcfg).items()}


@pytest.fixture(scope="module", params=ARCHS)
def run(request):
    """One bf16 step of each package on the same parameters and batch,
    and JAX's float32 gradients on the same (bf16-valued) parameters."""
    jcfg = dataclasses.replace(jreg.smoke_config(request.param),
                               dtype="bfloat16")
    tcfg = dataclasses.replace(treg.smoke_config(request.param),
                               dtype="bfloat16")
    jp, tree, tp = lp.carried(jcfg, tcfg)
    batch = batches(jcfg, 1)[0]
    grad_fn = jax.jit(jax.value_and_grad(JM.loss_fn, has_aux=True),
                      static_argnums=(2,))
    _, jg = grad_fn(jp, to_jax(batch), jcfg)
    f32 = jax.tree_util.tree_map(lambda a: a.astype(np.float32), jp)
    _, jg32 = grad_fn(f32, to_jax(batch), dataclasses.replace(
        jcfg, dtype="float32"))
    _, _, jm = jax.jit(jloop.make_train_step(jcfg, jopt.AdamWConfig(**OCFG)))(
        jp, jopt.init(jp), to_jax(batch))
    before = {n: p.dtype for n, p in tp.named_parameters()}
    seen = {}
    tp, state, tm = tloop.make_train_step(
        tcfg, topt.AdamWConfig(**OCFG), grad_constraint=capture(seen))(
        tp, topt.init(tp), to_port(batch))
    return dict(name=request.param, tcfg=tcfg, tree=tree, jm=jm, tm=tm,
                jg=_leaves(jg, tcfg), jg32=_leaves(jg32, tcfg), seen=seen,
                tp=tp, state=state, before=before)


def test_bf16_train_step_matches_jax(run):
    """loss, ce, grad_norm and lr, and every gradient, within the bf16
    tolerances above."""
    for key in ("loss", "ce", "grad_norm"):
        rel_close(run["tm"][key], run["jm"][key], SCALAR_REL, key)
    assert float(run["tm"]["lr"]) == float(run["jm"]["lr"])
    floor = max(float(np.abs(run["jg"][n] - f).max() / np.abs(f).max())
                for n, f in run["jg32"].items())
    assert 0 < floor < 0.05, floor          # bf16's rounding, not a fault
    assert set(run["seen"]) == set(run["jg"])
    for name, want in run["jg"].items():
        got = run["seen"][name]
        assert got.dtype == run["before"][name], name
        err = float(np.abs(got.float().numpy() - want).max()
                    / np.abs(want).max())
        assert err <= GRAD_K * floor, (run["name"], name, err, floor)


def test_bf16_train_step_keeps_float32_state(run):
    """AdamW's master and moments are float32; the parameters keep the
    types JAX gives them (bf16 matrices, float32 norms), and each
    parameter is its float32 master rounded once."""
    leaves = convert.lm_param_leaves(run["tree"], run["tcfg"])
    st = run["state"]
    assert int(st.step) == 1
    for name, p in run["tp"].named_parameters():
        assert str(p.dtype)[6:] == str(leaves[name].dtype), name
        assert p.dtype == run["before"][name], name
        for d in (st.master, st.mu, st.nu):
            assert d[name].dtype == torch.float32, name
        assert torch.equal(p.detach(), st.master[name].to(p.dtype)), name
    assert {p.dtype for p in run["tp"].parameters()} == {torch.bfloat16,
                                                         torch.float32}
