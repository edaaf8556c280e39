"""Parity of the port's MoE archs with the JAX package at their smoke
configs (mixtral-8x7b: 4 experts top-2 over local layers; llama4: top-1
with a shared expert, a vision stub and a ``nope`` layer), and of the MoE
routing itself: the chosen experts, slots and drops equal as integers on
seeded logits with planted gate ties and overflow past capacity."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _lm_parity as lp
from repro.configs import registry as jreg
from repro.models import moe as jmoe
from repro_torch.configs import registry as treg
from repro_torch.models import moe as tmoe

ARCHS = ("mixtral-8x7b", "llama4-maverick-400b-a17b")


@pytest.fixture(scope="module", params=ARCHS)
def run(request):
    return lp.run_arch(jreg.smoke_config(request.param),
                       treg.smoke_config(request.param))


def test_params_carry_over_exactly(run):
    lp.check_params(run)


def test_forward_matches_jax(run):
    lp.check_forward(run)


def test_loss_matches_jax(run):
    lp.check_loss(run)


def test_prefill_then_two_decode_steps_match_jax(run):
    lp.check_prefill_and_decode(run)


def test_decode_continues_the_ports_forward(run):
    lp.check_decode_continues_forward(run)


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_matches_jax(arch):
    lp.check_abstract(jreg.smoke_config(arch), treg.smoke_config(arch))


def jax_routing(logits, cfg):
    """The JAX package's routing (``models/moe.py:51-75``) on float32
    logits (T, E): idx_k, the expert-sorted experts, tokens and gates,
    slot and ok."""
    t, e, k = logits.shape[0], cfg.num_experts, cfg.experts_per_token
    gates_all = jax.nn.softmax(logits, axis=-1)
    gate_k, idx_k = jax.lax.top_k(gates_all, k)
    gate_k = gate_k / jnp.maximum(jnp.sum(gate_k, -1, keepdims=True), 1e-9)
    capacity = max(int(t * k / e * cfg.capacity_factor), 8)
    flat_e = idx_k.reshape(-1)
    order = jnp.argsort(flat_e)
    e_sorted = flat_e[order]
    seg_start = jnp.searchsorted(e_sorted, jnp.arange(e))
    pos = jnp.arange(t * k) - seg_start[e_sorted]
    ok = pos < capacity
    return dict(idx_k=idx_k, e_sorted=e_sorted,
                tok_sorted=jnp.repeat(jnp.arange(t), k)[order],
                gate_sorted=gate_k.reshape(-1)[order],
                slot=jnp.where(ok, pos, capacity), ok=ok), capacity


def planted_logits(seed, t, e, hot=None):
    """Seeded router logits (T, E) with planted ties: rows whose experts
    share a value (two, three or all of them), and optionally a ``hot``
    expert that most tokens prefer, which overflows its capacity."""
    rng = np.random.RandomState(seed)
    x = rng.randn(t, e).astype(np.float32)
    if hot is not None:
        x[rng.rand(t) < 0.8, hot] += 4.0
    x[::5, 1] = x[::5, 2]                       # a pair tie
    x[1::7, :3] = x[1::7, :1]                   # three-way ties
    x[2::11] = 0.5                              # every expert ties
    return x


@pytest.mark.parametrize("arch,factor,hot,drops", [
    ("mixtral-8x7b", None, None, False), ("mixtral-8x7b", 1.0, 3, True),
    ("mixtral-8x7b", 0.5, 0, True),
    ("llama4-maverick-400b-a17b", None, 2, False),
    ("llama4-maverick-400b-a17b", 0.25, None, True)])
def test_routing_equals_jax_as_integers(arch, factor, hot, drops):
    cfg = treg.smoke_config(arch)
    if factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=factor)
    t = 96
    logits = planted_logits(7, t, cfg.num_experts, hot)
    want, capacity = jax_routing(jnp.asarray(logits), cfg)
    got = tmoe.route(torch.from_numpy(logits), cfg)
    assert got.capacity == capacity
    for name in ("idx_k", "e_sorted", "tok_sorted", "slot", "ok"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(want[name]), name)
    lp.close(got.gate_sorted, want["gate_sorted"], 1e-6, "gates")
    # the planted ties were chosen lowest index first, and slots overflow
    # where an expert draws more than capacity pairs (the smoke configs'
    # capacity factor is drop-free)
    tied = got.idx_k[2::11]
    assert (tied == torch.arange(cfg.experts_per_token)).all()
    most = int(torch.bincount(got.idx_k.flatten()).max())
    assert (most > capacity) == drops == (not got.ok.all())


@pytest.mark.parametrize("arch,factor", [("mixtral-8x7b", None),
                                         ("mixtral-8x7b", 0.5),
                                         ("llama4-maverick-400b-a17b", 0.25)])
def test_apply_moe_matches_jax_with_ties_and_drops(arch, factor):
    """The whole MoE FFN on seeded tokens, with two router columns equal
    (tied gates on every token) and, at a small capacity factor, tokens
    dropped: y and aux as JAX gives them."""
    jcfg, tcfg = jreg.smoke_config(arch), treg.smoke_config(arch)
    if factor is not None:
        jcfg = dataclasses.replace(jcfg, capacity_factor=factor)
        tcfg = dataclasses.replace(tcfg, capacity_factor=factor)
    jp = jmoe.init_moe(jax.random.PRNGKey(3), jcfg)
    jp["router"] = jp["router"].at[:, 1].set(jp["router"][:, 0])
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tp = tmoe.MoE(tcfg, "cpu")
    with torch.no_grad():
        for name, t in tp.named_parameters():
            a = tree
            for part in name.split("."):
                a = a[part]
            t.copy_(torch.from_numpy(np.array(a)))
    x = np.random.RandomState(5).randn(2, 24, tcfg.d_model).astype(
        np.float32)
    jy, jaux = jmoe.apply_moe(jp, jnp.asarray(x), jcfg)
    ty, taux = tmoe.apply_moe(tp, torch.from_numpy(x), tcfg)
    assert ty.dtype == torch.float32 and ty.shape == x.shape
    lp.close(ty, jy, lp.TOL, "y")
    lp.close(taux, jaux, lp.LOSS_TOL, "aux")
    # experts 0 and 1 tie on every token: 1 is never taken before 0
    r = tmoe.route(torch.from_numpy(x.reshape(-1, tcfg.d_model))
                   @ tp.router, tcfg)
    assert (r.idx_k[:, 0] != 1).all()
    if r.idx_k.shape[1] > 1:
        assert ((r.idx_k[:, 1] != 1) | (r.idx_k[:, 0] == 0)).all()
    if factor is not None and factor < 1:
        assert not r.ok.all()          # some (token, expert) pairs drop
