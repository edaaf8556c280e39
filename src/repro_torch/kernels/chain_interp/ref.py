"""The walk kernel's plain version: a stateful receive window walked over
one persistent image an owner, in PyTorch.

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
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np
import torch

from ...core import faults as faults_mod
from ...core import machine
from ...core.programs import BUCKET_WORDS, EMPTY_KEY, bucket_home


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
