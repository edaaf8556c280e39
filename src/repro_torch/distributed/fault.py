"""Fault tolerance: the checkpoint/restart controller (the JAX package's
``repro.distributed.fault.TrainController``).

The data pipeline is deterministic per (seed, step) and the train step,
flash backward kernels included, sums in a fixed order, so a restore at
step k replays exactly the batches and the arithmetic an uninterrupted run
would see: recovery is bit-exact (tested).  The straggler-tolerant
gradient combine and the elastic remesh plan need a mesh, which the port
does not have yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from ..train import checkpoint as ckpt_lib


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

    def resume(self, abstract_params, abstract_opt, device=None):
        """(params, opt_state, step) from the latest complete checkpoint,
        filled into the templates on ``device`` (default: the card), or
        None if there is none."""
        step = ckpt_lib.latest_step(self.ckpt_dir)
        if step is None:
            return None
        trees = ckpt_lib.restore(self.ckpt_dir, step,
                                 {"params": abstract_params,
                                  "opt": abstract_opt}, device)
        return trees["params"], trees["opt"], step
