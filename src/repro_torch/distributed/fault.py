"""Fault tolerance: checkpoint/restart controller, elastic remesh,
straggler mitigation (the JAX package's ``repro.distributed.fault``).

The data pipeline is deterministic per (seed, step) and the train step,
flash backward kernels included, sums in a fixed order, so a restore at
step k replays exactly the batches and the arithmetic an uninterrupted run
would see: recovery is bit-exact (tested).  Across ranks,
:func:`masked_grad_combine` is the data-parallel gradient combine that
tolerates missing participants, over a ``torch.distributed`` process
group, and :func:`remesh_plan` checks an elastic transition between two
mesh shapes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

from ..train import checkpoint as ckpt_lib
from .sharding import tree_map


@dataclasses.dataclass
class TrainController:
    """Run-to-step driver with periodic checkpoints and crash recovery."""
    step_fn: Callable          # (params, opt, batch) -> (params, opt, m)
    batch_fn: Callable         # step -> batch
    ckpt_dir: str
    ckpt_every: int = 5

    def run(self, params, opt_state, start_step: int, end_step: int,
            crash_at: Optional[int] = None):
        step = start_step
        while step < end_step:
            if crash_at is not None and step == crash_at:
                raise RuntimeError(f"simulated node failure at {step}")
            params, opt_state, metrics = self.step_fn(
                params, opt_state, self.batch_fn(step))
            step += 1
            if step % self.ckpt_every == 0 or step == end_step:
                ckpt_lib.save(self.ckpt_dir, step,
                              {"params": params, "opt": opt_state})
        return params, opt_state, step

    def resume(self, abstract_params, abstract_opt, device=None,
               shardings: Optional[Dict] = None):
        """(params, opt_state, step) from the latest complete checkpoint,
        filled into the templates on ``device`` (default: the card) and,
        with ``shardings`` ({"params": ..., "opt": ...}), placed on a
        mesh; or None if there is none."""
        step = ckpt_lib.latest_step(self.ckpt_dir)
        if step is None:
            return None
        trees = ckpt_lib.restore(self.ckpt_dir, step,
                                 {"params": abstract_params,
                                  "opt": abstract_opt}, device, shardings)
        return trees["params"], trees["opt"], step


# ---------------------------------------------------------------------------
# straggler mitigation
# ---------------------------------------------------------------------------

def masked_grad_combine(local_grads, alive, group):
    """DP gradient combine that tolerates dead/straggling ranks.

    alive: this rank's () bool (False = it missed its deadline; its
    contribution is dropped).  Gradients are summed in float32 over the
    group's live ranks and divided by the live count (at least 1): an
    unbiased estimate on the surviving data, instead of a stalled or
    corrupt all-reduce.  Returns ``(grads, n_live)``, the grads in the
    tree's structure, float32.
    """
    if group is None:
        raise ValueError("masked_grad_combine needs a process group")
    ref = next(iter(_leaves(local_grads)), None)
    device = ref.device if ref is not None else torch.device("cpu")
    w = torch.as_tensor(alive, device=device).to(torch.float32)
    n_live = w.clone()
    dist.all_reduce(n_live, group=group)
    denom = torch.clamp(n_live, min=1.0)

    def one(g):
        s = g.to(torch.float32) * w
        dist.all_reduce(s, group=group)
        return s / denom

    return tree_map(one, local_grads), n_live


def _leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


# ---------------------------------------------------------------------------
# elastic scaling
# ---------------------------------------------------------------------------

def remesh_plan(old_shape: Dict[str, int], new_shape: Dict[str, int],
                global_batch: int) -> Dict[str, Any]:
    """Sanity-check an elastic transition and derive the new data layout."""
    old_n = int(math.prod(old_shape.values()))
    new_n = int(math.prod(new_shape.values()))
    batch_axes = [a for a in ("pod", "data") if a in new_shape]
    bdiv = int(math.prod(new_shape[a] for a in batch_axes)) or 1
    ok = global_batch % bdiv == 0
    return dict(old_devices=old_n, new_devices=new_n,
                batch_divisor=bdiv, batch_ok=ok,
                note=("resharding checkpointed state via restore() with "
                      "the new mesh's shardings"))
