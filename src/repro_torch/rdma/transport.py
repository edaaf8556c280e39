"""RC transport between the store's virtual shards (the port's
``repro.rdma.transport``).

A *get* request travels to the shard that owns the key (dispatch), the
owner executes the offload chain against its memory, and the response
travels back (combine): one dispatch/combine pair is one network RTT in
the paper's latency structure.

All S shards live on one device as a leading tensor dim.  Every source
shard ``s`` fills a send window ``(S_dst, capacity, W)``; the windows stack
into ``(S_src, S_dst, capacity, W)``, and the all-to-all exchange of the
JAX reference becomes a swap of the two leading dims.

The dispatch is fixed-capacity: each source shard sends up to ``capacity``
requests to each destination per step, and the rest are dropped and
reported.  Every entry point returns a per-request ``ok`` mask, so a
dropped (or admission-deferred) request is distinguishable from a served
request whose answer happens to be zero.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch


def rank_within_dest(dest: torch.Tensor,
                     live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """pos[i] = #{j < i : dest[j] == dest[i] and live[j]} (slot in the group).

    Sort/segment-cumsum formulation over a stable sort.  ``live=None``
    means all requests count; non-live requests get the rank they *would*
    have had but consume no slot for anyone else.
    """
    b = dest.shape[0]
    order = torch.argsort(dest, stable=True)      # stable: keeps batch order
    sd = dest[order]
    lv = (torch.ones(b, dtype=torch.int64, device=dest.device) if live is None
          else live[order].to(torch.int64))
    csum = torch.cumsum(lv, 0) - lv               # exclusive live count
    is_start = torch.ones(b, dtype=torch.bool, device=dest.device)
    is_start[1:] = sd[1:] != sd[:-1]
    # live count at each group's first row, carried across the group
    base = torch.cummax(torch.where(is_start, csum, 0), 0).values
    out = torch.zeros(b, dtype=torch.int32, device=dest.device)
    out[order] = (csum - base).to(torch.int32)
    return out


def dispatch(payload: torch.Tensor, dest: torch.Tensor, n_shards: int,
             capacity: int, live: Optional[torch.Tensor] = None):
    """Route every source shard's requests to their destination shards.

    payload: (S, B, W) int32; dest: (S, B) in [0, n_shards); live: (S, B)
    bool — requests an admission stage deferred (not dispatched, no slot
    consumed).  Returns (recv, pos, ok):
      recv : (S_dst, S_src, capacity, W) — slot [d, s, c] = c-th live
             request from source s to d (zero-padded);
      pos  : (S, B) each request's slot at its destination;
      ok   : (S, B) bool — True iff the request was dispatched (live and
             within capacity); a False row's response is not authoritative.
    """
    s, b, w = payload.shape
    # one stable sort over (source, destination) groups ranks every source
    # shard's requests at once, in batch order within each source
    src = torch.arange(s, device=dest.device)[:, None]
    group = (src * n_shards + dest).reshape(-1)
    pos = rank_within_dest(group, None if live is None
                           else live.reshape(-1)).reshape(s, b)
    ok = pos < capacity
    if live is not None:
        ok = ok & live
    # not-ok rows go to the spare slot `capacity`, which is cut off
    send = payload.new_zeros((s, n_shards, capacity + 1, w))
    slot = torch.where(ok, pos, capacity).long()
    send[src.expand(s, b), dest.long(), slot] = payload
    recv = send[:, :, :capacity].transpose(0, 1).contiguous()
    return recv, pos, ok


def combine(responses: torch.Tensor, dest: torch.Tensor, pos: torch.Tensor,
            ok: torch.Tensor) -> torch.Tensor:
    """Return responses to their source shards and gather per request.

    responses: (S_dst, S_src, capacity, V) — slot [d, s, c] answers source
    s's c-th request to d.  Returns (S, B, V) aligned with the original
    requests; rows with ``ok == False`` are zeroed.
    """
    back = responses.transpose(0, 1)              # (S_src, S_dst, cap, V)
    capacity = back.shape[2]
    s, b = dest.shape
    src = torch.arange(s, device=dest.device)[:, None].expand(s, b)
    safe = torch.clamp(pos, max=capacity - 1).long()
    out = back[src, dest.long(), safe]
    return out * ok[..., None].to(out.dtype)


def one_sided_read(remote: torch.Tensor, shard: torch.Tensor,
                   rows: torch.Tensor, n_shards: int, capacity: int,
                   live: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RDMA READ: fetch ``remote[shard][rows]`` from the shard owning them.

    remote: (S, local_rows, W) — each shard's slice; shard/rows: (S, B)
    target shard and *local* row on it.  Pure data movement: the remote
    side executes no logic.  Returns (data (S, B, W), ok (S, B)).
    """
    req = torch.stack([rows, torch.ones_like(rows)], dim=-1).to(torch.int32)
    recv, pos, ok = dispatch(req, shard, n_shards, capacity, live)
    rrows = recv[..., 0].reshape(n_shards, -1)
    filled = recv[..., 1].reshape(n_shards, -1)
    dst = torch.arange(n_shards, device=remote.device)[:, None]
    data = remote[dst, rrows.clamp(0, remote.shape[1] - 1).long()]
    data = data * filled[..., None].to(data.dtype)
    data = data.reshape(n_shards, n_shards, capacity, -1)
    return combine(data, shard, pos, ok), ok


def triggered_chain(remote_fn: Callable, payload: torch.Tensor,
                    dest: torch.Tensor, n_shards: int, capacity: int,
                    resp_words: int, live: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SEND triggers a *function* at the owner (the RPC baseline).

    ``remote_fn(requests (S_dst, N, W)) -> responses (S_dst, N,
    resp_words)`` stands for the owner hosts' CPUs doing the work.
    Returns (responses (S, B, resp_words), ok (S, B)).
    """
    recv, pos, ok = dispatch(payload, dest, n_shards, capacity, live)
    flat = recv.reshape(n_shards, -1, recv.shape[-1])
    resp = remote_fn(flat).reshape(n_shards, n_shards, capacity, resp_words)
    return combine(resp, dest, pos, ok), ok


def triggered_chain_engine(engine, state, recv_wq: int, resp_region: int,
                           resp_words: int, payload: torch.Tensor,
                           dest: torch.Tensor, n_shards: int, capacity: int,
                           live: Optional[torch.Tensor] = None,
                           max_steps: int = 256
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RedN pattern: SEND triggers a pre-posted chain VM program.

    ``state`` is stacked over the S owner shards (every field with a
    leading dim S).  Every arriving request — one slot of an owner's
    ``(S_src, capacity)`` receive window — is delivered as a client SEND to
    ``recv_wq`` of an independent context copied from its owner's machine,
    and all S * S * capacity contexts run in one batched
    ``ChainEngine.run_many`` call: the chain, not the host, computes the
    answer.  Returns (responses (S, B, resp_words), ok (S, B)); each
    response is the context's ``resp_region`` after its chain quiesced.
    """
    recv, pos, ok = dispatch(payload, dest, n_shards, capacity, live)
    flat = recv.reshape(n_shards, -1, recv.shape[-1])
    out = engine.run_many(state, recv_wq, flat, max_steps)
    resp = out.mem[:, resp_region:resp_region + resp_words]
    resp = resp.reshape(n_shards, n_shards, capacity, resp_words)
    return combine(resp, dest, pos, ok), ok
