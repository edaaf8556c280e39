"""Carry state over from the JAX package, given as numpy arrays.

The port holds no weights; its state is the chain VM's machines and the
store's tables.  These functions build the port's objects from the JAX
package's, passed across as plain numpy arrays and tuples, so that both
packages can run from the same state:

* :func:`spec_from_tuple` — a ``MachineSpec`` (any 6-tuple in its field
  order) to the port's :class:`~repro_torch.core.machine.MachineSpec`;
* :func:`vmstate_from_numpy` — a dict of ``VMState`` fields (batched or
  not) to a :class:`~repro_torch.core.machine.VMState` on a device, and
  :func:`vmstate_to_numpy` back;
* :func:`kv_from_numpy` — the ``(keys (S, n), vals (S, n, V))`` pair of
  ``ShardedKV.device_arrays()`` to the port's
  :class:`~repro_torch.kvstore.store.ShardedKV`.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from . import device as device_mod
from .core.machine import MachineSpec, VMState
from .kvstore import hopscotch
from .kvstore.store import ShardedKV

_VM_DTYPES = dict(last_comp_time=np.float32, clock=np.float32,
                  halted=np.bool_)


def spec_from_tuple(spec) -> MachineSpec:
    mem_words, bases, sizes, orderings, managed, cap = tuple(spec)
    return MachineSpec(
        mem_words=int(mem_words),
        wq_bases=tuple(int(x) for x in bases),
        wq_sizes=tuple(int(x) for x in sizes),
        orderings=tuple(int(x) for x in orderings),
        managed=tuple(bool(x) for x in managed),
        msg_capacity=int(cap))


def vmstate_from_numpy(fields: Mapping[str, np.ndarray],
                       device=None) -> VMState:
    dev = device_mod.resolve(device)
    return VMState(**{
        name: torch.from_numpy(np.array(
            fields[name], _VM_DTYPES.get(name, np.int32))).to(dev)
        for name in VMState._fields})


def vmstate_to_numpy(state: VMState) -> Dict[str, np.ndarray]:
    return {name: getattr(state, name).cpu().numpy()
            for name in VMState._fields}


def kv_from_numpy(keys: np.ndarray, vals: np.ndarray,
                  neighborhood: int = 8) -> ShardedKV:
    keys = np.array(keys, np.int32)
    vals = np.array(vals, np.int32)
    if keys.ndim != 2 or vals.ndim != 3 or vals.shape[:2] != keys.shape:
        raise ValueError(f"expected keys (S, n) and vals (S, n, V), got "
                         f"{keys.shape} and {vals.shape}")
    tables = [hopscotch.HopscotchTable(keys[s].copy(), vals[s].copy(),
                                       neighborhood)
              for s in range(keys.shape[0])]
    return ShardedKV(tables, keys.shape[0], vals.shape[2], neighborhood)
