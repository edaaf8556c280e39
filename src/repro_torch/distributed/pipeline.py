"""GPipe-style pipeline parallelism over a process group (the JAX
package's ``repro.distributed.pipeline``).

Each rank of the group is one pipeline stage; microbatches stream through
a ring s -> s+1.  The ring is an autograd function whose backward is the
reverse ring (the transpose of the reference's ``ppermute``), so autograd
through :func:`gpipe` gives GPipe's full-forward / full-backward schedule.

Schedule: T = M + S - 1 ticks; at tick t, stage s runs microbatch t - s
(when in range).  Each tick every rank runs the stage fn on its current
buffer (zeros on a bubble tick) and passes the result to stage s+1.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist


def _ring(x: torch.Tensor, send_to: int, recv_from: int,
          group) -> torch.Tensor:
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(), send_to, group),
           dist.P2POp(dist.irecv, out, recv_from, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class RingShift(torch.autograd.Function):
    """y on rank ``nxt`` = x on this rank; the gradient goes back to
    ``prev`` the same way round the ring."""

    @staticmethod
    def forward(ctx, x, nxt: int, prev: int, group, anchor):
        ctx.nxt, ctx.prev, ctx.group = nxt, prev, group
        return _ring(x, nxt, prev, group)

    @staticmethod
    def backward(ctx, g):
        return (_ring(g.contiguous(), ctx.prev, ctx.nxt, ctx.group), None,
                None, None, None)


class _Tie(torch.autograd.Function):
    """``out`` itself, with every ring output as an input of zero
    gradient: backward then runs every rank's ring shifts, in reverse tick
    order, even those whose result the stage never read (stage 0's
    inputs, the last tick's), so that each rank takes part in each
    reverse shift its neighbours make."""

    @staticmethod
    def forward(ctx, out, *rings):
        ctx.shapes = [(r.shape, r.dtype, r.device) for r in rings]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return (g,) + tuple(torch.zeros(s, dtype=d, device=v)
                            for s, d, v in ctx.shapes)


def gpipe(stage_fn: Callable, stage_params, x_microbatches: torch.Tensor,
          *, group, n_stages: int) -> torch.Tensor:
    """stage_fn(params_for_stage, x) -> y; all stages shape-preserving.

    stage_params: this rank's stage parameters.  x_microbatches: (M, b,
    ...): every stage holds the full microbatch array; stage 0 injects
    them in order.  The group's rank r is stage r % n_stages of pipeline
    replica r // n_stages.  Returns (M, b, ...) outputs as produced by the
    last stage (valid on stage S-1; other stages hold zeros: callers
    all-reduce or slice).
    """
    if group is None or not dist.is_initialized():
        raise RuntimeError("gpipe needs an initialised process group")
    size = dist.get_world_size(group)
    if size % n_stages:
        raise ValueError(f"a group of {size} ranks is not a whole number "
                         f"of {n_stages}-stage pipelines")
    rank = dist.get_rank(group)
    stage = rank % n_stages
    base = rank - stage
    nxt = dist.get_global_rank(group, base + (stage + 1) % n_stages)
    prev = dist.get_global_rank(group, base + (stage - 1) % n_stages)
    m = x_microbatches.shape[0]
    buf = torch.zeros_like(x_microbatches[0])
    outs, rings = [], []
    # every shift joins the graph, even of a tick that passes zeros, so
    # that every rank runs every reverse shift (callers differentiate the
    # output on every rank)
    anchor = (torch.zeros((), device=buf.device, requires_grad=True)
              if torch.is_grad_enabled() else None)
    for t in range(m + n_stages - 1):
        # stage 0 picks up microbatch t (if any); others use the ring input
        inject = x_microbatches[min(max(t, 0), m - 1)]
        cur = inject if stage == 0 else buf
        # bubble ticks pass zeros
        active = 0 <= t - stage < m
        y = stage_fn(stage_params, cur) if active else torch.zeros_like(cur)
        # the last stage records its finished microbatch t - (S - 1)
        if active and stage == n_stages - 1:
            outs.append(y)
        # ring: s -> s+1 (within each pipeline replica)
        buf = RingShift.apply(y, nxt, prev, group, anchor)
        rings.append(buf)
    out = (torch.stack(outs) if stage == n_stages - 1
           else torch.zeros_like(x_microbatches))
    return _Tie.apply(out, *rings)
