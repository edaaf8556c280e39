"""RC transport between the store's virtual shards (the port's
``repro.rdma.transport``).

A *get* request travels to the shard that owns the key (dispatch), the
owner executes the offload chain against its memory, and the response
travels back (combine): one dispatch/combine pair is one network RTT in
the paper's latency structure.

Without a process group all S shards live on one device as a leading
tensor dim.  Every source shard ``s`` fills a send window ``(S_dst,
capacity, W)``; the windows stack into ``(S_src, S_dst, capacity, W)``,
and the all-to-all exchange of the JAX reference becomes a swap of the two
leading dims.  With ``group=`` (a ``torch.distributed`` process group)
each rank holds a block of ``S_local`` shards, global shard ``rank *
S_local + local index``, and that swap is ``all_to_all_single`` over the
group: :func:`dispatch` and :func:`combine` are the only places where
requests cross shards, so every path below carries the store across
ranks with no other change.  Shard indices (``dest``, ``n_shards``) are
global; the tensors a rank passes and gets hold its own block.  A group
whose backend cannot carry the tensors' device raises: nothing falls back
to one device or goes through the host.

The dispatch is fixed-capacity: each source shard sends up to ``capacity``
requests to each destination per step, and the rest are dropped and
reported.  Every entry point returns a per-request ``ok`` mask, so a
dropped (or admission-deferred) request is distinguishable from a served
request whose answer happens to be zero.

The read-*write* variants (:func:`triggered_chain_stateful`, the SET and
DELETE wire pattern, and the loopback :func:`local_chain_stateful` of the
CLOCK sweeper and the table-growth migrator) serialize each owner's
requests: each owner's window walks in order over one persistent image
of its shard, every request seeing every earlier one's writes, and
owners never share state.  On the card a stage is one launch of the walk
kernel (:func:`repro_torch.kernels.chain_interp.ops.run_walk`); on the
CPU its plain version.  :func:`rows_stage`, the walk of the earlier
route (:func:`_walk` over the program's ``run_rows``, one batch of the S
owners' requests a window position), is the yardstick the tests and
``chip_smoke.py`` hold it to.  Their group forms
(:func:`triggered_chain_group`, :func:`local_chain_group`) hand each
owner's window to racing writer lanes a lap of ``n_writers`` rows at a
time, on :func:`_walk`.

Setting :data:`trace` to a list records each stateful stage's serial
depth, the chain steps of every request it ran and, on the card, CUDA
events around it; a single-chain stage also records copies of its
output and its walk and interpreter launches, and on the walk its
arguments (``args``, copies, for :func:`rows_stage` to replay).
``None``, the default, records nothing (and the walk then reads
nothing back to the host).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core import faults as faults_mod
from ..core import machine
from ..kernels.chain_interp import ops as interp_ops

#: None, or a list that each stateful stage appends a record to
trace: Optional[list] = None

# the device type each backend carries
_CARRIES = {"gloo": "cpu", "nccl": "cuda"}


def check_group(group, device) -> int:
    """The group's size; raises unless ``group`` is initialised and its
    backend carries tensors on ``device``."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("group= given, but no process group is "
                           "initialised")
    kind = torch.device(device).type
    backend = str(dist.get_backend(group))
    carries = {}
    for part in backend.split(","):
        dev, _, name = part.rpartition(":")
        carries.update({dev: name} if dev else {_CARRIES.get(name): name})
    if kind not in carries:
        raise RuntimeError(f"the group's backend {backend!r} cannot carry "
                           f"{kind} tensors")
    return dist.get_world_size(group)


def exchange(x: torch.Tensor, group) -> torch.Tensor:
    """The all-to-all swap of the two leading dims across the group.

    x: (A, world * B, ...) on this rank, dim 1 indexing global shards in
    blocks of B a rank.  Returns (B, world * A, ...): out[b, r * A + a] is
    rank r's x[a, rank * B + b].  With one rank it is
    ``x.transpose(0, 1)``."""
    world = check_group(group, x.device)
    a, rest = x.shape[0], tuple(x.shape[2:])
    b = x.shape[1] // world
    blocks = x.reshape((a, world, b) + rest).transpose(0, 1).contiguous()
    out = torch.empty_like(blocks)
    dist.all_to_all_single(out, blocks, group=group)
    return out.permute((2, 0, 1) + tuple(range(3, out.ndim))).reshape(
        (b, world * a) + rest)


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
             capacity: int, live: Optional[torch.Tensor] = None,
             group=None):
    """Route every source shard's requests to their destination shards.

    payload: (S, B, W) int32; dest: (S, B) in [0, n_shards); live: (S, B)
    bool — requests an admission stage deferred (not dispatched, no slot
    consumed).  With ``group`` S is this rank's block and ``n_shards``
    the global count.  Returns (recv, pos, ok):
      recv : (S_dst, S_src, capacity, W) — slot [d, s, c] = c-th live
             request from source s to d (zero-padded; with ``group``, d
             local and s global);
      pos  : (S, B) each request's slot at its destination;
      ok   : (S, B) bool — True iff the request was dispatched (live and
             within capacity); a False row's response is not authoritative.
    """
    s, b, w = payload.shape
    # one stable sort over (source, destination) groups ranks every source
    # shard's requests at once, in batch order within each source
    src = torch.arange(s, device=dest.device)[:, None]
    key = (src * n_shards + dest).reshape(-1)
    pos = rank_within_dest(key, None if live is None
                           else live.reshape(-1)).reshape(s, b)
    ok = pos < capacity
    if live is not None:
        ok = ok & live
    # not-ok rows go to the spare slot `capacity`, which is cut off
    send = payload.new_zeros((s, n_shards, capacity + 1, w))
    slot = torch.where(ok, pos, capacity).long()
    send[src.expand(s, b), dest.long(), slot] = payload
    send = send[:, :, :capacity]
    if group is not None:
        return exchange(send, group), pos, ok
    return send.transpose(0, 1).contiguous(), pos, ok


def combine(responses: torch.Tensor, dest: torch.Tensor, pos: torch.Tensor,
            ok: torch.Tensor, group=None) -> torch.Tensor:
    """Return responses to their source shards and gather per request.

    responses: (S_dst, S_src, capacity, V) — slot [d, s, c] answers source
    s's c-th request to d (with ``group``, d local and s global).
    Returns (S, B, V) aligned with the original requests; rows with
    ``ok == False`` are zeroed.
    """
    back = (responses.transpose(0, 1) if group is None
            else exchange(responses, group))      # (S_src, S_dst, cap, V)
    capacity = back.shape[2]
    s, b = dest.shape
    src = torch.arange(s, device=dest.device)[:, None].expand(s, b)
    safe = torch.clamp(pos, max=capacity - 1).long()
    out = back[src, dest.long(), safe]
    return out * ok[..., None].to(out.dtype)


def one_sided_read(remote: torch.Tensor, shard: torch.Tensor,
                   rows: torch.Tensor, n_shards: int, capacity: int,
                   live: Optional[torch.Tensor] = None, group=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RDMA READ: fetch ``remote[shard][rows]`` from the shard owning them.

    remote: (S, local_rows, W) — each shard's slice; shard/rows: (S, B)
    target shard and *local* row on it.  Pure data movement: the remote
    side executes no logic.  Returns (data (S, B, W), ok (S, B)).
    """
    req = torch.stack([rows, torch.ones_like(rows)], dim=-1).to(torch.int32)
    recv, pos, ok = dispatch(req, shard, n_shards, capacity, live, group)
    n_dst = recv.shape[0]
    rrows = recv[..., 0].reshape(n_dst, -1)
    filled = recv[..., 1].reshape(n_dst, -1)
    dst = torch.arange(n_dst, device=remote.device)[:, None]
    data = remote[dst, rrows.clamp(0, remote.shape[1] - 1).long()]
    data = data * filled[..., None].to(data.dtype)
    data = data.reshape(recv.shape[:3] + (-1,))
    return combine(data, shard, pos, ok, group), ok


def triggered_chain(remote_fn: Callable, payload: torch.Tensor,
                    dest: torch.Tensor, n_shards: int, capacity: int,
                    resp_words: int, live: Optional[torch.Tensor] = None,
                    group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """SEND triggers a *function* at the owner (the RPC baseline).

    ``remote_fn(requests (S_dst, N, W)) -> responses (S_dst, N,
    resp_words)`` stands for the owner hosts' CPUs doing the work.
    Returns (responses (S, B, resp_words), ok (S, B)).
    """
    recv, pos, ok = dispatch(payload, dest, n_shards, capacity, live, group)
    flat = recv.reshape(recv.shape[0], -1, recv.shape[-1])
    resp = remote_fn(flat).reshape(recv.shape[:3] + (resp_words,))
    return combine(resp, dest, pos, ok, group), ok


def triggered_chain_engine(engine, state, recv_wq: int, resp_region: int,
                           resp_words: int, payload: torch.Tensor,
                           dest: torch.Tensor, n_shards: int, capacity: int,
                           live: Optional[torch.Tensor] = None,
                           max_steps: int = 256, group=None, window=None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RedN pattern: SEND triggers a pre-posted chain VM program.

    ``state`` is stacked over the S owner shards (every field with a
    leading dim S).  Every arriving request — one slot of an owner's
    ``(S_src, capacity)`` receive window — is delivered as a client SEND to
    ``recv_wq`` of an independent context of its owner's machine, and all
    S * S * capacity contexts run in one batched ``ChainEngine.run_many``
    call: the chain, not the host, computes the answer.  ``window``, the
    program's words no chain writes (a get server's table and value
    rows), is kept once a shard and each context copies only the rest
    (:func:`machine.deliver_shared`).  Returns (responses (S, B,
    resp_words), ok (S, B)); each response is the context's
    ``resp_region`` after its chain quiesced.
    """
    recv, pos, ok = dispatch(payload, dest, n_shards, capacity, live, group)
    flat = recv.reshape(recv.shape[0], -1, recv.shape[-1])
    out = engine.run_many(state, recv_wq, flat, max_steps, window=window)
    resp = machine.words(out, resp_region, resp_words)
    resp = resp.reshape(recv.shape[:3] + (resp_words,))
    return combine(resp, dest, pos, ok, group), ok


def _open_record(stage: str, rows: torch.Tensor):
    """A :data:`trace` record for a single-chain stage over the window
    ``rows`` (S, P, W), and its start event on the card; ``(None, None)``
    when tracing is off."""
    if trace is None:
        return None, None
    run = (rows[..., 0] != 0).cpu().numpy()
    rec = dict(stage=stage, depth=int(run.sum(1).max(initial=0)),
               runs=int(run.sum()), steps=[],
               launches=dict(interp_ops.launches))
    if rows.is_cuda:
        rec.update(start=torch.cuda.Event(enable_timing=True),
                   end=torch.cuda.Event(enable_timing=True))
        rec["start"].record()
    trace.append(rec)
    return rec, run


def _close_record(rec, run, resp, steps, carry) -> None:
    """The stage's output, its launches (as counts since the record was
    opened) and its requests' steps by window position."""
    if "end" in rec:
        rec["end"].record()
    rec["launches"] = {k: interp_ops.launches[k] - n
                       for k, n in rec["launches"].items()}
    rec["out"] = (resp, steps, tuple(c.clone() for c in carry))
    grid = steps.cpu()
    order = [np.flatnonzero(r) for r in run]
    for p in range(rec["depth"]):
        owners = [o for o in range(len(order)) if len(order[o]) > p]
        rec["steps"].append(grid[owners, [order[o][p] for o in owners]])


def walk_stage(prog, budget: int, carry, rows: torch.Tensor,
               faults: Optional[torch.Tensor], resp_words: int, stage: str):
    """Walk each owner's window ``rows`` (S, P, W) through ``prog``'s
    chain (:func:`repro_torch.kernels.chain_interp.ops.run_walk`): one
    launch of the walk kernel on the card.  ``faults`` (S, P, FIELDS) or
    None.  Returns (responses (S, P, resp_words), the new carry)."""
    args = None if trace is None else (
        prog, budget, tuple(c.clone() for c in carry), rows.clone(),
        None if faults is None else faults.clone(), resp_words, stage)
    rec, run = _open_record(stage, rows)
    resp, steps, carry = interp_ops.run_walk(prog, carry, rows, budget,
                                             faults, resp_words)
    if rec is not None:
        rec["args"] = args
        _close_record(rec, run, resp, steps, carry)
    return resp, carry


def rows_stage(prog, budget: int, carry, rows: torch.Tensor,
               faults: Optional[torch.Tensor], resp_words: int, stage: str):
    """:func:`walk_stage` as the earlier route ran it, the walk's
    yardstick: :func:`_walk` over ``prog.run_rows`` (``run_rows_faulted``
    under fault rows), which builds the G owners' images from the carry,
    delivers, runs (one interpreter launch) and commits them at every
    window position.  Answers the status word alone (``resp_words``
    1); its trace record is :func:`walk_stage`'s."""
    if resp_words != 1:
        raise ValueError("the rows route answers the status word alone")
    width = rows.shape[-1]
    wire = rows if faults is None else torch.cat(
        [rows, faults.to(rows.dtype)], dim=-1)
    before = dict(interp_ops.launches)

    def step(c, reqs):
        if faults is None:
            status, *new, steps = prog.run_rows(*c, reqs, budget)
        else:
            status, *new, steps = prog.run_rows_faulted(
                *c, reqs[:, :width], budget,
                faults_mod.FaultPlan.from_row(reqs[:, width:]))
        if trace:
            trace[-1]["steps"].append(steps)
        return tuple(new), torch.stack([status, steps.to(status.dtype)], 1)

    run = (rows[..., 0] != 0).cpu().numpy()
    out, carry = _walk(step, carry, wire, run, 2, stage)
    resp, steps = out[..., :1], out[..., 1]
    if trace is not None:
        trace[-1].update(out=(resp, steps, tuple(c.clone() for c in carry)),
                         launches={k: interp_ops.launches[k] - n
                                   for k, n in before.items()})
    return resp, carry


def _walk(step_fn: Callable, carry, rows: torch.Tensor,
          run: np.ndarray, resp_words: int, stage: str):
    """Run an owner-major request window serially per owner.

    rows: (S, P, W); run: (S, P) host bools, the rows that execute.  At
    each position p the S owners' p-th running rows go to ``step_fn(
    carry rows (G, ...), requests (G, W)) -> (new carry rows, responses
    (G, resp_words))`` as one batch: each owner's requests keep their
    order and see every earlier one's writes, and owners never share
    state.  Rows that do not run answer zeros.  Returns (responses (S, P,
    resp_words), the new carry).
    """
    carry = tuple(c.clone() for c in carry)
    s = rows.shape[0]
    resp = rows.new_zeros(rows.shape[:2] + (resp_words,))
    order = [np.flatnonzero(run[o]) for o in range(s)]
    depth = max((len(o) for o in order), default=0)
    timed = trace is not None and rows.is_cuda
    if trace is not None:
        trace.append(dict(stage=stage, depth=depth, runs=int(run.sum()),
                          steps=[]))
        if timed:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            trace[-1].update(start=start, end=end)
            start.record()
    for p in range(depth):
        owners = [o for o in range(s) if len(order[o]) > p]
        o_idx = torch.as_tensor(owners, device=rows.device)
        p_idx = torch.as_tensor([order[o][p] for o in owners],
                                device=rows.device)
        new, r = step_fn(tuple(c[o_idx] for c in carry), rows[o_idx, p_idx])
        for c, n in zip(carry, new):
            c[o_idx] = n
        resp[o_idx, p_idx] = r.to(resp.dtype)
    if timed:
        end.record()
    return resp, carry


def _window(payload: torch.Tensor, faults: Optional[torch.Tensor], dest,
            n_shards: int, capacity: int, live, group):
    """Dispatch requests with their fault rows riding along.  Returns
    ``(recv, pos, ok, window rows (S_dst, S_src * capacity, W), window
    fault rows or None)``."""
    width = payload.shape[-1]
    if faults is not None:
        payload = torch.cat([payload, faults.to(payload.dtype)], dim=-1)
    recv, pos, ok = dispatch(payload, dest, n_shards, capacity, live, group)
    flat = recv.reshape(recv.shape[0], -1, recv.shape[-1])
    if faults is None:
        return recv, pos, ok, flat.contiguous(), None
    return (recv, pos, ok, flat[..., :width].contiguous(),
            flat[..., width:].contiguous())


def triggered_chain_stateful(prog, budget: int, carry,
                             payload: torch.Tensor, dest: torch.Tensor,
                             n_shards: int, capacity: int, resp_words: int,
                             live: Optional[torch.Tensor] = None,
                             stage: str = "stateful",
                             faults: Optional[torch.Tensor] = None,
                             group=None):
    """SEND-triggered chains that *mutate* owner state (the §3.5 read-write
    offload — the SET and DELETE wire pattern).

    Same dispatch/combine as :func:`triggered_chain_engine`, but each
    owner's receive window ``(S_src * capacity)`` walks through the
    single-chain write-side program ``prog`` in order (:func:`walk_stage`,
    at most ``budget`` steps a request), so every chain run observes
    every earlier request's writes (the NIC serializes atomics against
    local memory).  ``carry`` is a tuple of the owners' authoritative
    state, each with a leading dim S (e.g. the shards' hopscotch arrays),
    in the order ``prog.device_state`` takes them.  A window slot whose
    first word (the key) is 0 — a padded slot, or a row no live request
    landed on — runs no chain and answers 0: the write-side programs are
    self-guarding on such slots (status 0, state unchanged).  The serial
    depth is the most live requests any owner received.  Each response is
    the ``resp_words`` words at the program's response region (the
    status first).  Returns ``(responses (S, B, resp_words), ok (S, B),
    final carry)``.

    Stages compose: a caller may re-dispatch a *subset* of one stage's
    admitted rows through a second stage at the same capacity, threading
    the carry through both (the SET path's displacement escalation).
    :func:`rank_within_dest` ranks only live rows, so every row of a
    ``live2 <= ok1`` subset gets a rank <= its stage-1 rank: the second
    stage can add no drop.

    ``faults`` (optional): (S, B, ``faults.FIELDS``) int32 packed
    :class:`repro_torch.core.faults.FaultPlan` rows, one per request.  A
    request's fault *rides its payload through dispatch* (the columns are
    concatenated onto the payload and split back off at the window), so
    it lands wherever the request lands and arms that request's chain:
    an armed request keeps whatever its chain wrote (the program's
    ``commit_torn``).  A window slot no request landed on carries an
    all-zero fault row — armed (``0 >= 0``) — but runs no chain, like any
    key-0 slot.
    """
    recv, pos, ok, flat, frows = _window(payload, faults, dest, n_shards,
                                         capacity, live, group)
    resp, carry = walk_stage(prog, budget, carry, flat, frows, resp_words,
                             stage)
    resp = resp.reshape(recv.shape[:3] + (resp_words,))
    return combine(resp, dest, pos, ok, group), ok, carry


def local_chain_stateful(prog, budget: int, carry, payload: torch.Tensor,
                         resp_words: int, stage: str = "local",
                         faults: Optional[torch.Tensor] = None):
    """Loopback chains: each owner triggers its *own* pre-posted chain.

    Maintenance offloads (the CLOCK sweeper, table growth) originate at
    the shard that owns the data, so there is no dispatch/combine pair:
    shard ``s``'s requests ``payload[s]`` (S, B, W) walk through
    ``prog`` in order against its own state (see
    :func:`triggered_chain_stateful` for ``prog``, ``budget`` and
    ``carry``).  A row whose first word is 0 (an EMPTY migration source,
    a padded slot) runs no chain and answers zeros.  ``faults``
    (optional, (S, B, FIELDS)) are walked alongside the payload: a
    loopback lap's fault is the shard itself dying mid-lap.  Returns
    ``(responses (S, B, resp_words), final carry)``.
    """
    if faults is not None:
        faults = faults.to(torch.int32).contiguous()
    return walk_stage(prog, budget, carry, payload.contiguous(), faults,
                      resp_words, stage)


def _walk_laps(group_fn: Callable, carry, flat: torch.Tensor, n_lanes: int,
               resp_words: int, stage: str):
    """:func:`_walk` over laps: each owner's rows ``flat`` (S, R, W) in
    laps of ``n_lanes`` consecutive rows (the last zero-padded), a lap
    running while any of its rows has a nonzero first word.  Returns
    (responses (S, R, resp_words), carry)."""
    s, rows, w = flat.shape
    pad = (-rows) % n_lanes
    laps = torch.cat([flat, flat.new_zeros((s, pad, w))], dim=1).reshape(
        s, -1, n_lanes * w)
    run = (laps.reshape(s, laps.shape[1], n_lanes, w)[..., 0] != 0).any(
        -1).cpu().numpy()

    def step(c, lap_rows):
        new, r = group_fn(c, lap_rows.reshape(-1, n_lanes, w))
        return new, r.reshape(r.shape[0], n_lanes * resp_words)

    resp, carry = _walk(step, carry, laps, run, n_lanes * resp_words, stage)
    return resp.reshape(s, -1, resp_words)[:, :rows], carry


def triggered_chain_group(group_fn: Callable, carry, payload: torch.Tensor,
                          dest: torch.Tensor, n_shards: int, capacity: int,
                          resp_words: int, n_writers: int,
                          live: Optional[torch.Tensor] = None,
                          stage: str = "group", group=None):
    """:func:`triggered_chain_stateful` with each owner's receive window
    partitioned into **racing writer QPs** (the §3.5 multi-writer wire
    pattern).

    The window's rows are grouped into *laps* of ``n_writers`` consecutive
    slots (zero-padded to a whole lap); a lap's rows go to ``n_writers``
    independent pre-posted writer lanes that execute **concurrently**
    against the owner's shared state (one
    :meth:`repro_torch.core.programs.MultiWriterGroup.run_group` call),
    while laps serialize through the carry.  So within a lap the chains
    race their claim CASes, and across laps a request observes every
    earlier lap's writes.  At each lap position the S owners' laps run as
    one batch.  A lap whose rows all have key 0 runs no chain (padded
    lanes are self-guarding: status 0, state unchanged); a lap with some
    live rows runs whole, its key-0 lanes included.

    ``group_fn(carry rows (G, ...), laps (G, n_writers, W)) -> (new carry
    rows, responses (G, n_writers, resp_words))``.  Returns
    ``(responses (S, B, resp_words), ok (S, B), final carry)``.
    """
    recv, pos, ok = dispatch(payload, dest, n_shards, capacity, live, group)
    flat = recv.reshape(recv.shape[0], -1, recv.shape[-1])
    resp, carry = _walk_laps(group_fn, carry, flat, n_writers, resp_words,
                             stage)
    resp = resp.reshape(recv.shape[:3] + (resp_words,))
    return combine(resp, dest, pos, ok, group), ok, carry


def local_chain_group(group_fn: Callable, carry, payload: torch.Tensor,
                      n_lanes: int, resp_words: int, stage: str = "local"):
    """Loopback analogue of :func:`triggered_chain_group`: maintenance
    lanes that originate at the owning shard (the CLOCK sweeper's laps, a
    local compaction pass) race foreground writer lanes over the same
    shared state with no dispatch/combine pair.  Shard ``s``'s requests
    ``payload[s]`` (S, B, W) are partitioned into laps of ``n_lanes``
    consecutive rows, each lap delivered to the group's lanes in one
    ``run_group`` call, laps serializing through the carry (see
    :func:`triggered_chain_group` for ``group_fn`` and the zero-key
    rule).  Returns ``(responses (S, B, resp_words), final carry)``."""
    return _walk_laps(group_fn, carry, payload, n_lanes, resp_words, stage)
