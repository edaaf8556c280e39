"""Production mesh construction (the JAX package's ``repro.launch.mesh``).

FUNCTIONS, not module-level constants: importing this module touches no
process group.  Each returns a ``DeviceMesh`` over the process group that
is running (``torch.distributed.init_process_group`` first), with the
reference's axis names as ``mesh_dim_names``.
"""
from __future__ import annotations

from typing import Optional

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def _device_type(device_type: Optional[str]) -> str:
    if device_type is not None:
        return device_type
    import torch.distributed as dist
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None) -> DeviceMesh:
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data",
    "model") with ``multi_pod``: 256 or 512 ranks.  ``device_type``
    defaults to the group's (cuda under NCCL, else cpu)."""
    shape, axes = PRODUCTION[multi_pod]
    return init_device_mesh(_device_type(device_type), shape,
                            mesh_dim_names=axes)


def make_host_mesh(data: int = 1, model: int = 1,
                   device_type: Optional[str] = None) -> DeviceMesh:
    """A small ("data", "model") mesh over ``data * model`` ranks: tests,
    examples and the card's one-rank group."""
    return init_device_mesh(_device_type(device_type), (data, model),
                            mesh_dim_names=("data", "model"))
