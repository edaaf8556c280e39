"""The elastic drill of ``test_torch_elastic.py`` (``elastic_main.py`` on
a gloo group of 8 ranks, each rank a process running this file):

    python tests/_elastic_drill.py RANK WORLD STORE_FILE WORK_DIR

smollm-135m's smoke config from the weights in ``WORK_DIR/params0.npz``
(by the port's parameter names), AdamW (lr 3e-3, 2 warm-up steps of 20),
``TokenPipeline(vocab, 32, 8, seed=11)``: 5 steps on a (4 data, 2 model)
mesh of the 8 ranks, a checkpoint, a restore placed on a (2, 2) mesh of
ranks 0-3, and 5 more steps there.  Rank 0 writes the final parameters,
gathered, to ``WORK_DIR/final.npz``.
"""
import sys

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.distributed import fault
from repro_torch.distributed import sharding as shrules
from repro_torch.distributed import specs as specs_lib
from repro_torch.models import model as M
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import loop as loop_lib
from repro_torch.train import optimizer as opt_lib

ARCH = "smollm-135m"
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=20)


def main(rank: int, world: int, store_file: str, work: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_file, world),
                            rank=rank, world_size=world)
    cfg = registry.smoke_config(ARCH)
    ocfg = opt_lib.AdamWConfig(**OPT)
    pipe = TokenPipeline(cfg.vocab_size, 32, 8, seed=11)
    step = loop_lib.make_train_step(cfg, ocfg)
    plan = fault.remesh_plan({"data": 4, "model": 2},
                             {"data": 2, "model": 2}, global_batch=8)
    assert plan["batch_ok"], plan

    params = M.init_params(cfg, seed=0, device="cpu")
    with np.load(f"{work}/params0.npz") as npz, torch.no_grad():
        for name, p in params.named_parameters():
            p.copy_(torch.from_numpy(npz[name]))

    def batch(i, mesh, rules):
        b = {k: torch.as_tensor(v) for k, v in pipe.batch_at(i).items()}
        return specs_lib.distribute_batch(b, mesh, rules)

    # phase 1: the big mesh, 5 steps, a checkpoint
    mesh_a = DeviceMesh("cpu", np.arange(8).reshape(4, 2),
                        mesh_dim_names=("data", "model"))
    with shrules.use_mesh(mesh_a) as rules:
        specs_lib.distribute_params(params, mesh_a, rules)
        opt = opt_lib.init(params, ocfg)
        for i in range(5):
            params, opt, _ = step(params, opt, batch(i, mesh_a, rules))
        ckpt_lib.save(f"{work}/ckpt", 5, {"params": params, "opt": opt})

    # phase 2: the shrunk mesh (node loss), restored onto it, 5 more steps
    mesh_b = DeviceMesh("cpu", np.arange(4).reshape(2, 2),
                        mesh_dim_names=("data", "model"))
    if rank < 4:
        with shrules.use_mesh(mesh_b) as rules:
            template = M.abstract_params(cfg)
            shardings = {
                "params": specs_lib.param_shardings(template, mesh_b, rules),
                "opt": specs_lib.param_shardings(
                    opt_lib.abstract_init(template, ocfg), mesh_b, rules)}
            trees = ckpt_lib.restore(
                f"{work}/ckpt", 5,
                {"params": template,
                 "opt": opt_lib.abstract_init(template, ocfg)},
                device="cpu", shardings=shardings)
            p2, o2 = trees["params"], trees["opt"]
            leaf = next(p2.parameters())
            assert tuple(leaf.device_mesh.mesh.shape) == (2, 2), leaf
            for i in range(5, 10):
                p2, o2, _ = step(p2, o2, batch(i, mesh_b, rules))
            final = {n: p.full_tensor().detach().numpy()
                     for n, p in p2.named_parameters()}
        if rank == 0:
            np.savez(f"{work}/final.npz", **final)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
