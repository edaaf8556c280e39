"""Helpers for the train-step parity tests between the JAX package and
the port (``test_torch_train.py``, ``test_torch_train_opt.py``): one
smoke config's parameters carried across by ``convert``, the same
``TokenPipeline`` batches, the JAX gradient and step functions jitted once
per arch, and the tolerances.  Both packages sum float32 in their own
orders: the loss, grad_norm and lr are held within 1e-5 relative, each
gradient within 1e-5 of its leaf's largest magnitude, optimizer state
within 1e-6 of its leaf's largest magnitude."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import _lm_parity as lp
from repro.configs import registry as jreg
from repro.data.pipeline import TokenPipeline
from repro.models import model as JM
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro_torch import convert
from repro_torch.configs import registry as treg

ARCHS = ("smollm-135m", "gemma3-1b")
B, S = 4, 24               # gemma3's smoke window (16) binds at 24
OCFG = dict(lr=3e-3, warmup_steps=2, total_steps=50)
REL = 1e-5
STATE_REL = 1e-6


def batches(cfg, n):
    pipe = TokenPipeline(cfg.vocab_size, S, B, seed=3)
    return [pipe.batch_at(i) for i in range(n)]


def to_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def to_port(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def rel_close(got, want, rel, what):
    got, want = float(got), float(want)
    assert abs(got - want) <= rel * abs(want), (what, got, want)


def leaf_close(got, want, rel, what):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()),
                               err_msg=what)


def setup(name, **changes):
    """The arch's smoke config in both packages (with ``changes``, e.g. the
    JAX package's ``attn_impl``), its carried parameters, jitted JAX
    gradient and step functions and three batches."""
    jcfg = dataclasses.replace(jreg.smoke_config(name), **changes)
    tcfg = dataclasses.replace(treg.smoke_config(name), **changes)
    jp, tree, _ = lp.carried(jcfg, tcfg)
    grad_fn = jax.jit(jax.value_and_grad(JM.loss_fn, has_aux=True),
                      static_argnums=(2,))
    step = jax.jit(jloop.make_train_step(jcfg, jopt.AdamWConfig(**OCFG)))
    return dict(name=name, jcfg=jcfg, tcfg=tcfg, jp=jp, tree=tree,
                grad_fn=grad_fn, step=step, batches=batches(jcfg, 3))


def fresh(a):
    """A new port model from the carried JAX parameters (the train step
    updates its parameters in place)."""
    return convert.lm_params_from_numpy(a["tree"], a["tcfg"], "cpu")


def capture(into: dict):
    """A grad_constraint that records the gradients it sees."""
    def hook(g):
        into.update(g)
        return g
    return hook


def jax_grads(a, batch):
    (loss, m), g = a["grad_fn"](a["jp"], to_jax(batch), a["jcfg"])
    return float(loss), convert.lm_param_leaves(
        jax.tree_util.tree_map(np.asarray, g), a["tcfg"])


