"""The elastic drill on 8 gloo ranks (``_elastic_drill.py``, the port's
``elastic_main.py``): smollm-135m's smoke config trained 5 steps with its
parameters and AdamW state as DTensors on a (4 data, 2 model) mesh,
checkpointed (gathered whole), restored placed on a (2, 2) mesh and
trained 5 more, against JAX's uninterrupted 10-step run on one device
from the same weights, within the drill's atol 2e-4 / rtol 1e-4.  No
process group is initialised in this process."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import registry as jreg
from repro.data.pipeline import TokenPipeline
from repro.models import model as JM
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro_torch import convert
from repro_torch.configs import registry as treg

import _elastic_drill as ed

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8


def test_elastic_remesh_restore_matches_jax(tmp_path):
    jcfg = jreg.smoke_config(ed.ARCH)
    tcfg = treg.smoke_config(ed.ARCH)
    params0 = JM.init_params(jax.random.PRNGKey(0), jcfg)
    np.savez(tmp_path / "params0.npz", **{
        n: np.asarray(a, np.float32) for n, a in convert.lm_param_leaves(
            jax.tree_util.tree_map(np.asarray, params0), tcfg).items()})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_elastic_drill.py"), str(r),
         str(WORLD), str(tmp_path / "store"), str(tmp_path)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]

    # meanwhile, JAX's uninterrupted run on one device
    ocfg = jopt.AdamWConfig(**ed.OPT)
    pipe = TokenPipeline(jcfg.vocab_size, 32, 8, seed=11)
    step = jax.jit(jloop.make_train_step(jcfg, ocfg))
    p, o = params0, jopt.init(params0)
    for i in range(10):
        p, o, _ = step(p, o, {k: jnp.asarray(v)
                              for k, v in pipe.batch_at(i).items()})
    want = convert.lm_param_leaves(jax.tree_util.tree_map(np.asarray, p),
                                   tcfg)

    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=400)[0])
    finally:
        for proc in procs:
            proc.kill()
    assert all(proc.returncode == 0 for proc in procs), "\n".join(logs)
    with np.load(tmp_path / "final.npz") as got:
        assert set(got.files) == set(want)
        for name, a in want.items():
            np.testing.assert_allclose(got[name], np.asarray(a, np.float32),
                                       atol=2e-4, rtol=1e-4, err_msg=name)
