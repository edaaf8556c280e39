"""The walk kernels' plain versions: a stateful receive window walked over
one persistent image an owner, in PyTorch, request by request
(:func:`plain_walk`) or in laps of racing writer lanes
(:func:`plain_laps`).

The JAX package streams each owner's window through its stage's step as
one ``lax.scan`` inside the store's jitted programs
(``src/repro/rdma/transport.py:196``): each step builds the owner's image
from the carry, delivers the request, runs the chain to quiescence and
commits.  Here, as in the kernel (``csrc/chain_interp.cu``,
``chain_walk_kernel``), an owner's image is built once, by the program's
``device_state(carry)``, and every window position in order

1. skips a row whose first word is 0 (it answers zeros, in 0 steps);
2. runs the row's request on the image as it stands: the program's
   ``state0`` fields, the request delivered as ``machine.deliver_many``
   delivers it, the chain run to its stop under the row's budget and
   fault row (``machine._run_rows``);
3. commits by the program's :class:`repro_torch.core.programs.WalkLayout`
   (:func:`fold`): the carry words keep the run's writes (mirrored rows
   merged, home-distance pads recomputed) where the row's fault row is
   armed or its status commits, and are restored otherwise; every other
   word is restored.

So at the start of every position the image equals
``device_state(carry)`` bit for bit, and the carry is read off the image
once at the end (:func:`read_carry`).

The laps (``chain_laps_kernel``; the JAX package's ``lax.scan`` of
``MultiWriterGroup.run_group``, ``src/repro/rdma/transport.py:239`` and
``:304``) run the same way: an owner's window in laps of ``n_writers``
consecutive rows (``MultiWriterGroup.lap_rows``), a lap whose rows all
have key 0 skipped, every other lap run whole from ``state0``'s fields
with lane ``w``'s row delivered to lane ``w`` under the group's schedule,
and committed by the lap rule (:func:`fold_lap`).  With the pads carried,
the reference's lap 0 sets every EMPTY bucket's pad to ``NO_TTL`` at its
commit even where none of its rows is live: so an owner whose lap 0 is
skipped has its pad column normalised before its first running lap
(:func:`normalized_pads`).
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np
import torch

from ...core import faults as faults_mod
from ...core import machine
from ...core.programs import BUCKET_WORDS, EMPTY_KEY, NO_TTL, bucket_home


@functools.lru_cache(maxsize=64)
def _frame_words(frame, device: torch.device):
    """A frame's carry words as image addresses: ``(primary (n, K),
    mirror (rows - n, K))``, K = key, the carried pad if any, then the
    value words, in that order."""
    r = torch.arange(frame.rows, dtype=torch.int64, device=device)
    cols = [frame.table_base + r * BUCKET_WORDS]
    if frame.pad >= 0:
        cols.append(frame.table_base + r * BUCKET_WORDS + 1)
    cols.append(frame.values_base + r[:, None] * frame.val_len
                + torch.arange(frame.val_len, device=device))
    words = torch.cat([c.reshape(frame.rows, -1) for c in cols], dim=1)
    return words[:frame.n], words[frame.n:]


def _home_pads(frame, keys: torch.Tensor) -> torch.Tensor:
    """The pad words of every image row of a home-distance frame, from the
    carry's key column (G, n): ``(row - home(key)) % n``, ``home_pad``
    for an empty row."""
    n = frame.n
    src = torch.remainder(torch.arange(frame.rows, device=keys.device), n)
    k = keys[:, src]
    return torch.where(k != EMPTY_KEY,
                       torch.remainder(src.to(torch.int32)
                                       - bucket_home(k, n), n),
                       frame.home_pad).to(torch.int32)


def fold(layout, post: torch.Tensor, pre: torch.Tensor,
         keep: torch.Tensor) -> torch.Tensor:
    """The commit rule on whole images: G runs' images ``post`` (G, L)
    that started from ``pre`` (G, L), each keeping its carry writes where
    ``keep`` (G,) holds.  Returns the images the next position starts
    from: ``pre`` but for the kept carry words, each primary copy's write
    winning over its mirror's and both copies set, and the home-distance
    pads of the new keys."""
    out = pre.clone()
    k = keep.reshape(-1, 1, 1)
    for frame in layout.frames:
        prim, mir = _frame_words(frame, post.device)
        m = mir.shape[0]
        after, before = post[:, prim], pre[:, prim]
        merged = before.clone()
        if m:
            mirrored = post[:, mir]
            merged[:, :m] = torch.where(mirrored != before[:, :m], mirrored,
                                        before[:, :m])
        merged = torch.where(after != before, after, merged)
        value = torch.where(k, merged, before)
        out[:, prim] = value
        if m:
            out[:, mir] = value[:, :m]
        if frame.home_pad > 0:
            rows = torch.arange(frame.rows, device=post.device)
            out[:, frame.table_base + rows * BUCKET_WORDS + 1] = _home_pads(
                frame, value[..., 0])
    return out


def read_carry(layout, img: torch.Tensor, like) -> tuple:
    """The carry arrays as the images ``img`` (S, L) hold them, in the
    dtypes of ``like`` (the walk's input carry)."""
    out = [None] * len(like)
    for frame in layout.frames:
        prim, _ = _frame_words(frame, img.device)
        words = img[:, prim]
        out[frame.keys] = words[..., 0]
        if frame.pad >= 0:
            out[frame.pad] = words[..., 1]
        out[frame.vals] = words[..., -frame.val_len:]
    return tuple(o.to(c.dtype) for o, c in zip(out, like))


def plain_walk(prog, carry, rows: torch.Tensor, budget: int,
               faults: Optional[torch.Tensor] = None, resp_words: int = 1,
               on_position: Optional[Callable] = None):
    """Walk the window ``rows`` (S, P, W) int32 of the S owners of
    ``carry`` (each array with a leading dim S) through ``prog``'s chain:
    position by position, the owners' running rows as one batch, each
    against its own persistent image (see the module docstring).
    ``faults`` (S, P, FIELDS) int32 arms each row's
    :class:`repro_torch.core.faults.FaultPlan`.  ``on_position(p, img)``,
    if given, sees the images after each position's commit.  Returns
    ``(responses (S, P, resp_words) — the words at the program's
    resp_region —, steps (S, P), the new carry)``."""
    layout = prog.walk_layout
    s, positions = rows.shape[:2]
    img = prog.device_state(*carry).mem.clone()
    resp = rows.new_zeros((s, positions, resp_words))
    steps = torch.zeros((s, positions), dtype=torch.int32,
                        device=rows.device)
    run = (rows[..., 0] != 0).cpu().numpy()
    order = [np.flatnonzero(run[o]) for o in range(s)]
    depth = max((len(o) for o in order), default=0)
    commit = torch.tensor(layout.commit, dtype=torch.int32,
                          device=rows.device)
    st0 = prog.state0
    region = slice(layout.resp_region, layout.resp_region + resp_words)
    for p in range(depth):
        owners = [o for o in range(s) if len(order[o]) > p]
        o_idx = torch.as_tensor(owners, device=rows.device)
        p_idx = torch.as_tensor([order[o][p] for o in owners],
                                device=rows.device)
        pre = img[o_idx]
        g = len(owners)
        state = machine.VMState(*(
            pre if name == "mem" else a.expand((g,) + a.shape)
            for name, a in zip(machine.VMState._fields, st0)))
        batch = machine.deliver_many(state, layout.recv_wq,
                                     rows[o_idx, p_idx][:, None, :])
        plan = (None if faults is None else
                faults_mod.FaultPlan.from_row(faults[o_idx, p_idx]))
        machine.plain_run(prog.spec, batch, budget, plan)
        keep = torch.isin(batch.mem[:, layout.resp_region], commit)
        if plan is not None:
            keep = keep | plan.active()
        resp[o_idx, p_idx] = batch.mem[:, region]
        steps[o_idx, p_idx] = batch.steps
        img[o_idx] = fold(layout, batch.mem, pre, keep)
        if on_position is not None:
            on_position(p, img)
    return resp, steps, read_carry(layout, img, carry)


@functools.lru_cache(maxsize=64)
def _lap_words(mw, device: torch.device):
    """The group's carry words as image addresses: ``(keys (n,), pads
    (n,), values (n, val_len))``."""
    r = torch.arange(mw.n_buckets, dtype=torch.int64, device=device)
    keys = mw.table_base + r * BUCKET_WORDS
    vals = mw.values_base + r[:, None] * mw.val_len + torch.arange(
        mw.val_len, device=device)
    return keys, keys + 1, vals


def normalized_pads(mw, img: torch.Tensor) -> torch.Tensor:
    """The pad words (G, n) of the images ``img`` (G, L), ``NO_TTL``
    where the bucket's key is ``EMPTY`` (what ``run_group`` returns with
    ``exp``)."""
    keys, pads, _ = _lap_words(mw, img.device)
    return torch.where(img[:, keys] == EMPTY_KEY, NO_TTL, img[:, pads])


def fold_lap(mw, pad: bool, post: torch.Tensor,
             pre: torch.Tensor) -> torch.Tensor:
    """The lap rule on whole images: G laps' images ``post`` (G, L) that
    started from ``pre`` (G, L).  Returns the images the next lap starts
    from: ``pre`` but for every write to a bucket's key word and to its
    value row, whatever the lanes' statuses (``run_group`` reads these
    back from the image), and with ``pad`` (the caller carries ``exp``)
    the pad words, each bucket whose key is ``EMPTY`` at ``NO_TTL``.
    Every other word a lap wrote (the val_ptr words, the pads without
    ``pad``, the lanes' staging and response regions, the guard region)
    goes back as it was.  ``tests/test_torch_laps.py`` holds the rule to
    ``MultiWriterGroup.run_group``."""
    out = pre.clone()
    keys, pads, vals = _lap_words(mw, post.device)
    vals = vals.reshape(-1)
    out[:, keys] = post[:, keys]
    out[:, vals] = post[:, vals]
    if pad:
        out[:, pads] = normalized_pads(mw, post)
    return out


def read_lap_carry(mw, img: torch.Tensor, like) -> tuple:
    """``(keys, vals[, exp])`` as the images ``img`` (S, L) hold them, in
    the dtypes of ``like`` (the walk's input carry, whose length says
    whether the pads are carried)."""
    keys, pads, vals = _lap_words(mw, img.device)
    out = (img[:, keys], img[:, vals]) + ((img[:, pads],) if len(like) == 3
                                          else ())
    return tuple(o.to(c.dtype) for o, c in zip(out, like))


def plain_laps(mw, carry, rows: torch.Tensor, schedule, budget: int,
               resp_words: int = 1, on_lap: Optional[Callable] = None):
    """Walk the window ``rows`` (S, R, W) int32 of the S owners of
    ``carry`` (``(keys, vals)``, or ``(keys, vals, exp)`` to carry the
    pad words; each with a leading dim S) through the racing lanes of the
    :class:`repro_torch.core.programs.MultiWriterGroup` ``mw``: lap by
    lap, the owners' running laps as one batch, each against its own
    persistent image (see the module docstring), every lap under
    ``schedule``'s (R, W) quota and at most ``budget`` steps in all.
    ``on_lap(p, img)``, if given, sees the images after each lap
    position's commit.  Returns ``(responses (S, R, resp_words): the
    words at each lane's response region, zeros for a key-0 row —,
    steps (S, laps), the new carry)``."""
    pad = len(carry) == 3
    n = mw.n_writers
    laps = mw.lap_rows(rows)
    s, n_laps = laps.shape[:2]
    dev = rows.device
    img = mw.device_state(*carry).mem.to(torch.int32).clone()
    resp = rows.new_zeros((s, n_laps, n, resp_words))
    steps = torch.zeros((s, n_laps), dtype=torch.int32, device=dev)
    run = (laps[..., 0] != EMPTY_KEY).any(-1).cpu().numpy()
    if pad and n_laps:
        # lap 0's commit normalises the pad column, run or not
        idle = torch.as_tensor(~run[:, 0], device=dev)[:, None]
        _, pad_words, _ = _lap_words(mw, dev)
        img[:, pad_words] = torch.where(idle, normalized_pads(mw, img),
                                        img[:, pad_words])
    order = [np.flatnonzero(run[o]) for o in range(s)]
    depth = max((len(o) for o in order), default=0)
    quota = schedule.as_rows().to(dev)
    pays = machine.pad_payload_rows(laps.to(torch.int32))
    words = torch.tensor([r for _, r in mw.lanes], device=dev)[:, None] \
        + torch.arange(resp_words, device=dev)
    st0 = mw.state0
    cap = st0.msg_buf.shape[-2]
    for p in range(depth):
        owners = [o for o in range(s) if len(order[o]) > p]
        o_idx = torch.as_tensor(owners, device=dev)
        l_idx = torch.as_tensor([order[o][p] for o in owners], device=dev)
        pre = img[o_idx]
        g = len(owners)
        state = machine.VMState(*(
            pre.clone() if name == "mem" else a.expand((g,) + a.shape).clone()
            for name, a in zip(machine.VMState._fields, st0)))
        gi = torch.arange(g, device=dev)
        for w, (recv_wq, _) in enumerate(mw.lanes):
            slot = torch.remainder(state.msg_tail[:, recv_wq], cap).long()
            state.msg_buf[gi, recv_wq, slot] = pays[o_idx, l_idx, w]
            state.msg_tail[:, recv_wq] += 1
        machine.plain_run(mw.spec, state, budget, None,
                          quota.expand((g,) + tuple(quota.shape)),
                          mw.writer_slices)
        live = laps[o_idx, l_idx, :, 0] != EMPTY_KEY
        resp[o_idx, l_idx] = torch.where(live[..., None],
                                         state.mem[:, words], 0)
        steps[o_idx, l_idx] = state.steps
        img[o_idx] = fold_lap(mw, pad, state.mem, pre)
        if on_lap is not None:
            on_lap(p, img)
    resp = resp.reshape(s, -1, resp_words)[:, :rows.shape[1]]
    return resp, steps, read_lap_carry(mw, img, carry)
