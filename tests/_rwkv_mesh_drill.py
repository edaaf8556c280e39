"""The rwkv6 mesh drill of ``test_torch_rwkv_mesh.py``: rwkv6-7b's smoke
train step on a (2 data, 2 model) gloo mesh of 4 ranks, each rank a
process running this file:

    python tests/_rwkv_mesh_drill.py RANK WORLD STORE_FILE WORK_DIR

The weights come from ``WORK_DIR/params0.npz`` (by the port's parameter
names), are placed by ``distributed/specs.py``, and the batch is
``TokenPipeline(vocab, 32, 8, seed=11).batch_at(0)`` sharded over
"data".  One ``loss_and_grads`` call; rank 0 writes the loss and every
gradient, gathered whole, to ``WORK_DIR/mesh.npz``.
"""
import sys

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.distributed import sharding as shrules
from repro_torch.distributed import specs as specs_lib
from repro_torch.models import model as M
from repro_torch.train import loop as loop_lib

ARCH = "rwkv6-7b"
MESH = (2, 2)


def load_params(cfg, work: str):
    params = M.init_params(cfg, seed=0, device="cpu")
    with np.load(f"{work}/params0.npz") as npz, torch.no_grad():
        for name, p in params.named_parameters():
            p.copy_(torch.from_numpy(npz[name]))
    return params


def batch0(cfg):
    pipe = TokenPipeline(cfg.vocab_size, 32, 8, seed=11)
    return {k: torch.as_tensor(v) for k, v in pipe.batch_at(0).items()}


def main(rank: int, world: int, store_file: str, work: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_file, world),
                            rank=rank, world_size=world)
    cfg = registry.smoke_config(ARCH)
    params = load_params(cfg, work)
    mesh = DeviceMesh("cpu", np.arange(world).reshape(MESH),
                      mesh_dim_names=("data", "model"))
    with shrules.use_mesh(mesh) as rules:
        specs_lib.distribute_params(params, mesh, rules)
        batch = specs_lib.distribute_batch(batch0(cfg), mesh, rules)
        loss, _, grads = loop_lib.loss_and_grads(params, batch, cfg)
        out = {n: g.full_tensor().detach().numpy() for n, g in grads.items()}
        out["loss"] = loss.full_tensor().detach().numpy()
    if rank == 0:
        np.savez(f"{work}/mesh.npz", **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
