"""Parity of the port's dense LM archs with the JAX package at their smoke
configs (smollm-135m, glm4-9b with partial RoPE, gemma3-1b with 5 local :
1 global, gelu and qk-norm): the JAX parameters carried across, the same
seeded batch through forward, the loss, prefill and two decode steps of
both; plus the loss, the token pipeline and the per-arch config modules."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _lm_parity as lp
from repro.configs import registry as jreg
from repro.data import pipeline as jpipe
from repro.models import layers as jlayers
from repro_torch.configs import registry as treg
from repro_torch.data import pipeline as tpipe
from repro_torch.models import layers as tlayers
from repro_torch.models import model as TM

ARCHS = ("smollm-135m", "glm4-9b", "gemma3-1b")


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
def test_abstract_matches_concrete(arch):
    tcfg = treg.smoke_config(arch)
    ab, cache = lp.check_abstract(jreg.smoke_config(arch), tcfg)
    concrete = TM.init_params(tcfg, seed=1, device="cpu")
    assert lp.port_specs(dict(ab.named_parameters())) == lp.port_specs(
        dict(concrete.named_parameters()))
    assert [lp.port_specs(c) for c in cache] == [
        lp.port_specs(c) for c in TM.init_cache(tcfg, 3, 16, "cpu")]


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(masked):
    rng = np.random.RandomState(11)
    logits = (rng.randn(3, 7, 50) * 4).astype(np.float32)
    # labels inside [0, V), and two outside it (the JAX one-hot sum reads
    # their logit as 0)
    labels = rng.randint(0, 50, (3, 7)).astype(np.int32)
    labels[0, 0], labels[2, 3] = 50, -1
    mask = (rng.rand(3, 7) < 0.7).astype(np.float32) if masked else None
    want = jlayers.cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask))
    got = tlayers.cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == ()
    lp.close(got, want, 1e-6, "cross entropy")
    if masked:       # an all-zero mask divides by max(0, 1)
        zero = np.zeros_like(mask)
        lp.close(tlayers.cross_entropy(torch.from_numpy(logits),
                                       torch.from_numpy(labels),
                                       torch.from_numpy(zero)),
                 jlayers.cross_entropy(jnp.asarray(logits),
                                       jnp.asarray(labels),
                                       jnp.asarray(zero)), 0, "empty mask")


@pytest.mark.parametrize("n_shards,shard,step", [(1, 0, 0), (1, 0, 5),
                                                 (4, 2, 3)])
def test_token_pipeline_draws_as_jax(n_shards, shard, step):
    kw = dict(vocab_size=300, seq_len=9, global_batch=8, seed=4,
              n_shards=n_shards, shard=shard)
    want = jpipe.TokenPipeline(**kw).batch_at(step)
    got = tpipe.TokenPipeline(**kw).batch_at(step)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], k)
    first = next(iter(tpipe.TokenPipeline(**kw)))
    np.testing.assert_array_equal(first["tokens"], tpipe.TokenPipeline(
        **kw).batch_at(0)["tokens"])


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "seamless-m4t-medium",
                                  "phi-3-vision-4.2b",
                                  "llama4-maverick-400b-a17b"])
def test_make_lm_batch_matches_jax(arch):
    cfg = treg.smoke_config(arch)
    want = jpipe.make_lm_batch(jreg.smoke_config(arch), 3, 10, seed=6)
    got = tpipe.make_lm_batch(cfg, 3, 10, seed=6, device="cpu")
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].device.type == "cpu"
        assert str(got[k].dtype).replace("torch.", "") == str(v.dtype)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), k)


def test_make_lm_batch_defaults_to_the_card():
    cfg = treg.smoke_config("qwen3-1.7b")
    if torch.cuda.is_available():
        assert tpipe.make_lm_batch(cfg, 1, 4)["tokens"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpipe.make_lm_batch(cfg, 1, 4)


@pytest.mark.parametrize("arch", jreg.ARCHS)
def test_config_modules_are_copies(arch):
    mod = arch.replace("-", "_").replace(".", "_")
    jm = importlib.import_module(f"repro.configs.{mod}")
    tm = importlib.import_module(f"repro_torch.configs.{mod}")
    assert vars(tm.CONFIG) == vars(jm.CONFIG)
    assert vars(tm.smoke_config()) == vars(jm.smoke_config())
    assert tm.CONFIG == treg.get_config(arch)
