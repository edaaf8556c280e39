"""Per-QP rate limiting (paper §3.5 'Isolation', §5.5).

ConnectX WQ rate-limiters bound how fast a (possibly misbehaving) client's
chain may execute.  Here a token bucket guards each client QP in the
serving engine: requests beyond the rate are deferred, so a tenant spinning
a non-terminating recycled loop cannot starve others.  The buckets are
float32, as in the JAX package, so admission decisions agree bit for bit.
(``fair_quotas``, which compiles rates into a chain-VM ``Schedule``, waits
for the scheduled interpreter.)
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .. import device as device_mod
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
