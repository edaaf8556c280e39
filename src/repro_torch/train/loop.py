"""Step builders: loss -> grads -> (optional compression) -> AdamW, and the
prefill and serve steps of the LM serving path.

The JAX package jits these closures; PyTorch runs them eagerly.  The
train step differentiates ``model.loss_fn`` with ``torch.autograd.grad``
(the attention gradient from the flash backward kernels on the card) and
updates the parameters in place (:func:`..train.optimizer.update`).

On a mesh the parameters (and optimizer state) are DTensors placed by
:mod:`..distributed.specs` and the batch's tensors DTensors sharded over
the batch axes: the step then runs on them as it is, under the active
``sharding.use_mesh`` rules (the model's ``shard`` calls redistribute
activations), plain tensors it makes taken as replicated, and each
gradient placed as its parameter is before the update.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from ..distributed import compression, sharding
from ..models import model as model_lib
from ..models.config import ModelConfig
from . import optimizer as opt_lib


def loss_and_grads(params, batch, cfg: ModelConfig):
    """(loss, metrics, grads by parameter name) of ``model.loss_fn`` on
    ``batch``, by autograd (the JAX package's ``jax.value_and_grad`` of
    it); makes the parameters require grad, and gives a parameter that the
    loss does not reach a zero gradient."""
    ps = opt_lib.named(params)
    for p in ps.values():
        p.requires_grad_(True)
    with torch.enable_grad(), on_mesh(ps):
        loss, metrics = model_lib.loss_fn(params, batch, cfg)
        grads = torch.autograd.grad(loss, list(ps.values()),
                                    allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else placed_as(g, p)
             for (n, p), g in zip(ps.items(), grads)}
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def on_mesh(named_params):
    """Within: plain tensors that meet DTensors count as replicated, when
    the parameters are DTensors (a no-op otherwise)."""
    if not any(sharding.is_dtensor(p) for p in named_params.values()):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def placed_as(g, p):
    """A DTensor gradient redistributed to its parameter's placements (a
    partial sum reduced, a replicated one sliced); anything else as it
    is."""
    if sharding.is_dtensor(g) and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(cfg: ModelConfig, opt_cfg: opt_lib.AdamWConfig, *,
                    compress_grads: bool = False,
                    microbatches: int = 1,
                    grad_constraint=None,
                    wire_dtype: Optional[str] = None):
    """Returns train_step(params, opt_state, batch[, error]) -> (params,
    opt_state[, error], metrics), as the JAX package's does; ``params`` is
    the model, whose parameters are made to require grad and are updated
    in place, and the batch's tensors lie on its device.

    microbatches: gradient accumulation over u microbatches, microbatch j
    holding rows j, j + u, j + 2u, ... (the JAX fold: (B,) -> (B/u, u),
    u moved to the front); the sum in float32 divided by u; the metrics
    those of the last microbatch.
    grad_constraint: optional fn(grads) -> grads applied to each
    microbatch's gradients and to the running sum (the JAX package's
    sharding hook; on one card any function of the grads dict).
    wire_dtype: cast each microbatch's grads to it ('bfloat16' halves a
    reduce's bytes); the accumulation stays float32.
    """

    def post_grads(g):
        if wire_dtype is not None:
            dt = getattr(torch, wire_dtype)
            g = {n: a.to(dt) for n, a in g.items()}
        if grad_constraint is not None:
            g = grad_constraint(g)
        return g

    def step_grads(params, batch):
        loss, metrics, grads = loss_and_grads(params, batch, cfg)
        return loss, metrics, post_grads(grads)

    def grads_of(params, batch):
        if microbatches == 1:
            return step_grads(params, batch)
        b = batch["tokens"].shape[0]
        if b % microbatches:
            raise ValueError(f"batch {b} does not split into "
                             f"{microbatches} microbatches")

        def fold(a, j):
            return a.reshape(b // microbatches, microbatches,
                             *a.shape[1:])[:, j].contiguous()

        acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for n, p in opt_lib.named(params).items()}
        if grad_constraint is not None:
            acc = grad_constraint(acc)
        loss_sum = 0.0
        for j in range(microbatches):
            loss, metrics, g = step_grads(
                params, {k: fold(a, j) for k, a in batch.items()})
            acc = {n: a + g[n].float() for n, a in acc.items()}
            if grad_constraint is not None:
                acc = grad_constraint(acc)
            loss_sum = loss_sum + loss
        grads = {n: g / microbatches for n, g in acc.items()}
        return loss_sum / microbatches, metrics, grads

    if compress_grads:
        def train_step(params, opt_state, batch, error):
            loss, metrics, grads = grads_of(params, batch)
            grads, error, ratio = compression.compress_with_feedback(
                grads, error)
            with on_mesh(opt_lib.named(params)):
                params, opt_state, om = opt_lib.update(
                    opt_cfg, grads, opt_state, params)
            metrics = dict(metrics, loss=loss, wire_ratio=ratio, **om)
            return params, opt_state, error, metrics
    else:
        def train_step(params, opt_state, batch):
            loss, metrics, grads = grads_of(params, batch)
            with on_mesh(opt_lib.named(params)):
                params, opt_state, om = opt_lib.update(
                    opt_cfg, grads, opt_state, params)
            metrics = dict(metrics, loss=loss, **om)
            return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, s_max: int):
    def prefill_step(params, batch):
        return model_lib.prefill(params, batch, cfg, s_max=s_max)
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    def serve_step(params, token, caches, lengths, enc_lengths=None):
        return model_lib.decode_step(params, token, caches, lengths, cfg,
                                     enc_lengths=enc_lengths)
    return serve_step

