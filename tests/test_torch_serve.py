"""The serving path on both packages from the same parameters: the
isolation + failover scenario of test_system.py (admission, two requests,
eight ticks through a host-driver crash), token by token, and the
token-bucket admission bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import model as JM
from repro.rdma import isolation as jiso
from repro.serve import ServeEngine as JaxEngine
from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.launch import serve as tlaunch
from repro_torch.rdma import isolation as tiso
from repro_torch.serve import ServeEngine as TorchEngine

LOGIT_TOL = 2e-3


def recording(engine, log, to_numpy):
    """Wrap the engine's serve step so that each tick's logits are kept."""
    serve = engine._serve

    def step(*args):
        logits, caches = serve(*args)
        log.append(to_numpy(logits))
        return logits, caches
    engine._serve = step


def test_serve_engines_agree_through_a_host_crash():
    arch = "qwen3-1.7b"
    jcfg, tcfg = jreg.smoke_config(arch), treg.smoke_config(arch)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                      tcfg, "cpu")
    kw = dict(s_max=48, n_slots=4, n_clients=2, rate_per_us=0.1, burst=3.0)
    je = JaxEngine(jcfg, jp, **kw)
    te = TorchEngine(tcfg, tp, device="cpu", **kw)
    jlog, tlog = [], []
    recording(je, jlog, np.asarray)
    recording(te, tlog, lambda t: t.numpy().copy())

    admitted = je.admit([0, 0, 0, 0, 1])
    assert te.admit([0, 0, 0, 0, 1]) == admitted == [True, True, True,
                                                     False, True]
    for eng in (je, te):
        eng.add_request(0, 0, 3)
        eng.add_request(1, 1, 5)
    for i in range(8):
        if i == 4:
            je.crash_host_driver()
            te.crash_host_driver()
        jt, tt = je.step(), te.step()
        assert tt.tolist() == jt.tolist(), f"tick {i}"
        np.testing.assert_allclose(tlog[-1], jlog[-1], atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL, err_msg=f"tick {i}")
        # the argmax comparison means something only if the top two
        # logits of each active slot are further apart than the tolerance
        top2 = np.sort(jlog[-1][:2], axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > LOGIT_TOL, f"tick {i}"
    assert not te.host_alive() and te.stats == je.stats
    assert te.stats == dict(steps=8, tokens=16, throttled=1)
    assert np.array_equal(te.lengths.numpy(), np.asarray(je.lengths))
    for t, j in zip(te.buckets, je.buckets):
        assert np.array_equal(t.numpy().view(np.uint32),
                              np.asarray(j).view(np.uint32))


@pytest.mark.parametrize("seed", [0, 1])
def test_admission_is_bit_equal(seed):
    rng = np.random.RandomState(seed)
    burst = float(rng.choice([3.0, 4.5]))
    js, ts = jiso.init(5, burst), tiso.init(5, burst, "cpu")
    now = 0.0
    for _ in range(60):
        now += float(rng.choice([0.0, 0.01, 0.3, 1.0, 2.7]))
        clients = rng.randint(0, 5, rng.randint(1, 20))
        rate = float(rng.choice([0.1, 0.37, 1.3]))
        js, jok = jiso.admit(js, jnp.asarray(clients, jnp.int32), now, rate,
                             burst)
        ts, tok = tiso.admit(ts, torch.from_numpy(clients), now, rate, burst)
        assert np.array_equal(tok.numpy(), np.asarray(jok))
        for t, j in zip(ts, js):
            assert t.dtype == torch.float32
            assert np.array_equal(t.numpy().view(np.uint32),
                                  np.asarray(j).view(np.uint32))


def test_serve_launcher_on_the_cpu(capsys):
    eng = tlaunch.main(["--steps", "4", "--slots", "2", "--crash-host"],
                       device="cpu")
    out = capsys.readouterr().out
    assert "host driver crashed at step 2" in out
    assert eng.stats == dict(steps=4, tokens=8, throttled=0)
    assert not eng.host_alive()
