"""Per-QP rate limiting (paper §3.5 'Isolation', §5.5).

ConnectX WQ rate-limiters bound how fast a (possibly misbehaving) client's
chain may execute.  Here a token bucket guards each client QP in the
serving engine: requests beyond the rate are deferred, so a tenant spinning
a non-terminating recycled loop cannot starve others.  The buckets are
float32, as in the JAX package, so admission decisions agree bit for bit.
:func:`fair_quotas` applies the same rate limiter one layer down: it
compiles per-writer rates into a :class:`repro_torch.core.machine.Schedule`
for racing writer lanes.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import device as device_mod
from ..core import machine
from . import transport


class BucketState(NamedTuple):
    tokens: torch.Tensor       # f32[n_clients]
    last_us: torch.Tensor      # f32[n_clients]


def init(n_clients: int, burst: float, device=None) -> BucketState:
    dev = device_mod.resolve(device)
    return BucketState(
        tokens=torch.full((n_clients,), burst, dtype=torch.float32,
                          device=dev),
        last_us=torch.zeros((n_clients,), dtype=torch.float32, device=dev))


def admit(state: BucketState, client: torch.Tensor, now_us: float,
          rate_per_us: float, burst: float
          ) -> Tuple[BucketState, torch.Tensor]:
    """Vector admit: one request per entry of `client`, all at `now_us`.

    Returns (new_state, admitted mask).  A request is admitted iff, after
    linear refill, its QP's bucket still holds >= 1 token counting the
    requests ahead of it in this batch (same-client requests drain in
    order).
    """
    f32 = dict(dtype=torch.float32, device=state.tokens.device)
    client = client.to(device=state.tokens.device, dtype=torch.int64)
    now = torch.tensor(now_us, **f32)
    elapsed = torch.clamp(now - state.last_us, min=0.0)
    refilled = torch.minimum(
        state.tokens + elapsed * torch.tensor(rate_per_us, **f32),
        torch.tensor(burst, **f32))
    grp_rank = transport.rank_within_dest(client).float()
    admitted = refilled[client] - grp_rank >= 1.0
    spent = torch.zeros_like(state.tokens).index_add_(0, client,
                                                      admitted.float())
    tokens = torch.clamp(refilled - spent, min=0.0)
    last = torch.full_like(state.last_us, now_us)    # rounds to float32
    return BucketState(tokens, last), admitted


def fair_quotas(rates: Sequence[float], n_rounds: int,
                burst: Optional[float] = None,
                device=None) -> machine.Schedule:
    """Token-bucket fairness **between racing writers**: compile per-QP
    rate limits down to a :class:`repro_torch.core.machine.Schedule`.

    :func:`admit` rations *requests into* the engine; this rations
    *execution steps between* concurrent writer lanes over shared state.
    Each scheduler round refills writer ``w``'s bucket by ``rates[w]``
    tokens (capped at ``burst``, default ``2 * max(rates)``), grants
    ``floor(bucket)`` WR completions as that round's quota, and carries
    the fractional remainder — float64 host arithmetic, as in the JAX
    package, so the rows agree exactly.  A final drain round
    (``SCHED_DRAIN`` for every writer) runs stragglers to quiescence:
    rate limiting shapes interleaving, it never abandons an admitted
    request mid-chain.  The rows land on ``device`` (default CUDA).
    """
    r = np.asarray(rates, np.float64)
    if r.ndim != 1 or r.size < 1:
        raise ValueError(f"rates must be a 1-D sequence, got {rates!r}")
    if (r <= 0).any():
        raise ValueError(f"rates must be positive, got {rates!r}")
    if n_rounds < 1:
        raise ValueError(f"n_rounds must be >= 1, got {n_rounds}")
    cap = float(2.0 * r.max() if burst is None else burst)
    if cap < 1.0:
        raise ValueError(f"burst {cap} grants no whole token ever")
    bucket = np.zeros_like(r)
    rows = np.zeros((n_rounds + 1, r.size), np.int32)
    for k in range(n_rounds):
        bucket = np.minimum(bucket + r, cap)
        grant = np.floor(bucket)
        bucket -= grant
        rows[k] = grant.astype(np.int32)
    rows[n_rounds] = machine.SCHED_DRAIN
    return machine.Schedule.from_rows(
        torch.from_numpy(rows).to(device_mod.resolve(device)))
