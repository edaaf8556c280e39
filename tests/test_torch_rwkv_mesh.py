"""rwkv6-7b's smoke train step on a (2, 2) gloo mesh (``_rwkv_mesh_drill.py``,
4 ranks, each a process): the loss and every gradient of one
``loss_and_grads`` call with the parameters placed by ``distributed/specs.py``
and the batch sharded over "data", against the same call on one device
from the same weights, within the elastic drill's atol 2e-4 / rtol 1e-4.
The one-device step is held to JAX's in ``test_torch_train_recurrent.py``.
No process group is initialised in this process."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.models import model as M
from repro_torch.train import loop as loop_lib

import _rwkv_mesh_drill as rd

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4


def test_rwkv6_train_step_on_a_mesh_matches_one_device(tmp_path):
    torch.set_num_threads(1)
    cfg = registry.smoke_config(rd.ARCH)
    params = M.init_params(cfg, seed=0, device="cpu")
    np.savez(tmp_path / "params0.npz", **{
        n: p.detach().numpy() for n, p in params.named_parameters()})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_rwkv_mesh_drill.py"), str(r),
         str(WORLD), str(tmp_path / "store"), str(tmp_path)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]

    # meanwhile, the one-device step from the same weights
    loss, _, grads = loop_lib.loss_and_grads(rd.load_params(cfg, tmp_path),
                                             rd.batch0(cfg), cfg)
    want = {n: g.numpy() for n, g in grads.items()}
    want["loss"] = loss.numpy()

    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=300)[0])
    finally:
        for proc in procs:
            proc.kill()
    assert all(proc.returncode == 0 for proc in procs), "\n".join(logs)
    with np.load(tmp_path / "mesh.npz") as got:
        assert set(got.files) == set(want)
        for name, a in want.items():
            np.testing.assert_allclose(got[name], a, atol=2e-4, rtol=1e-4,
                                       err_msg=name)
