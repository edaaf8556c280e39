"""Carry state over from the JAX package, given as numpy arrays.

These functions build the port's objects from the JAX package's, passed
across as plain numpy arrays and tuples, so that both packages can run
from the same state:

* :func:`spec_from_tuple` — a ``MachineSpec`` (any 6-tuple in its field
  order) to the port's :class:`~repro_torch.core.machine.MachineSpec`;
* :func:`vmstate_from_numpy` — a dict of ``VMState`` fields (batched or
  not) to a :class:`~repro_torch.core.machine.VMState` on a device, and
  :func:`vmstate_to_numpy` back;
* :func:`kv_from_numpy` — the ``(keys (S, n), vals (S, n, V))`` pair of
  ``ShardedKV.device_arrays()`` to the port's
  :class:`~repro_torch.kvstore.store.ShardedKV`;
* :func:`lm_params_from_numpy` — the LM's parameter tree (numpy leaves;
  bfloat16 leaves as the ``bfloat16`` numpy type JAX hands out, or as
  float32) to the port's :class:`~repro_torch.models.model.Model`;
* :func:`lm_cache_from_numpy` / :func:`lm_cache_to_numpy` — the decode
  caches between the JAX layout ``{"groups": [per pattern position,
  stacked over groups], "rem": [...]}`` and the port's list of one dict
  per layer (attention {'k','v'} and, int8, {'ks','vs'}, rwkv
  {'state','xtm','xcm'}, recurrent {'conv','h'}, cross-attention
  {'ck','cv'}).

Layer ``g * pattern_len + pos`` of the port is group ``g`` of the JAX
package's ``groups[pos]``; the ``rem`` layers follow.
"""
from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np
import torch

from . import device as device_mod
from .core.machine import MachineSpec, VMState
from .kvstore import hopscotch
from .kvstore.store import ShardedKV
from .models import model as model_lib
from .models.config import ModelConfig

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


# --- the LM ------------------------------------------------------------------

def _tensor(a, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    """A numpy array (float32, or numpy's ``bfloat16`` extension type) as a
    tensor of ``dtype``; bfloat16 goes through float32, which is exact."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a)).to(dev, dtype)


def _layer_trees(stack: Mapping, n_layers: int,
                 p_len: int) -> List[Mapping]:
    """The per-layer trees of a JAX ``{"groups", "rem"}`` stack of
    ``n_layers`` layers of a ``p_len``-long pattern, in layer order."""
    out: List = [None] * n_layers
    n_groups = n_layers // p_len
    for pos, tree in enumerate(stack["groups"] or []):
        for g in range(n_groups):
            out[g * p_len + pos] = _index(tree, g)
    for i, tree in enumerate(stack["rem"]):
        out[n_groups * p_len + i] = tree
    return out


def _index(tree, g: int):
    if isinstance(tree, Mapping):
        return {k: _index(v, g) for k, v in tree.items()}
    return np.asarray(tree)[g]


def _block_leaves(prefix: str, layer: Mapping, out: Dict) -> None:
    """A JAX block tree's leaves under the port's parameter names
    (``moe.shared`` nests one level deeper)."""
    for name, a in layer.items():
        if isinstance(a, Mapping):
            _block_leaves(f"{prefix}.{name}", a, out)
        else:
            out[f"{prefix}.{name}"] = a


def lm_param_leaves(tree: Mapping, cfg: ModelConfig) -> Dict:
    """The JAX package's LM parameter tree (numpy leaves, or any leaves
    with a shape that index like them) flattened to the port's parameter
    names: ``embed.*``, ``final_norm``, ``decoder.{i}.*`` by layer (their
    ``attn``, ``mix``, ``rec``, ``ffn``, ``moe`` (``moe.shared.*``),
    ``cross`` and norms), ``encoder.{i}.*``, ``enc_norm`` and
    ``frontend_proj``."""
    flat = {f"embed.{name}": a for name, a in tree["embed"].items()}
    for name in ("final_norm", "enc_norm", "frontend_proj"):
        if name in tree:
            flat[name] = tree[name]
    stacks = [("decoder", cfg.num_layers, cfg.pattern_len)]
    if "encoder" in tree:
        stacks.append(("encoder", cfg.num_encoder_layers,
                       len(model_lib.ENCODER_PATTERN)))
    for stack, n_layers, p_len in stacks:
        for i, layer in enumerate(_layer_trees(tree[stack], n_layers,
                                               p_len)):
            _block_leaves(f"{stack}.{i}", layer, flat)
    return flat


def lm_params_from_numpy(tree: Mapping, cfg: ModelConfig,
                         device=None) -> model_lib.Model:
    """The JAX package's LM parameters (a tree of numpy arrays) as the
    port's ``Model`` on ``device``, value for value.  Raises on a leaf that
    is in one tree and not the other."""
    dev = device_mod.resolve(device)
    m = model_lib.Model(cfg, dev)
    named = dict(m.named_parameters())
    flat = lm_param_leaves(tree, cfg)
    if set(flat) != set(named):
        raise ValueError(f"parameter trees differ: only in JAX "
                         f"{sorted(set(flat) - set(named))}, only in the "
                         f"port {sorted(set(named) - set(flat))}")
    with torch.no_grad():
        for name, a in flat.items():
            t = named[name]
            if tuple(np.shape(a)) != tuple(t.shape):
                raise ValueError(f"{name}: shape {np.shape(a)}, expected "
                                 f"{tuple(t.shape)}")
            t.copy_(_tensor(a, t.dtype, dev))
    return m


def lm_cache_from_numpy(tree: Mapping, cfg: ModelConfig,
                        device=None) -> List[Dict[str, torch.Tensor]]:
    """A JAX ``{"groups", "rem"}`` cache tree (numpy leaves) as the port's
    list of one dict per layer.  Each leaf takes its own dtype
    (``model.cache_dtype``): the recurrent states 'state' and 'h' and the
    scales 'ks' and 'vs' float32, 'k' and 'v' int8 under ``kv_quant``, the
    rest the model's dtype."""
    dev = device_mod.resolve(device)
    return [{name: _tensor(a, model_lib.cache_dtype(cfg, name), dev)
             for name, a in layer.items()}
            for layer in _layer_trees(tree, cfg.num_layers, cfg.pattern_len)]


def lm_cache_to_numpy(caches, cfg: ModelConfig) -> Dict:
    """The port's per-layer caches as the JAX ``{"groups", "rem"}`` layout:
    float32 and int8 leaves as they are, bfloat16 leaves widened (exactly)
    to float32; :func:`lm_cache_from_numpy` restores each leaf's dtype."""
    def arr(t):
        t = t.detach()
        return (t if t.dtype == torch.int8 else t.float()).cpu().numpy()

    p_len, n_groups = cfg.pattern_len, cfg.n_groups
    groups = [{name: np.stack([arr(caches[g * p_len + pos][name])
                               for g in range(n_groups)])
               for name in caches[pos]} for pos in range(p_len)]
    rem = [{name: arr(t) for name, t in caches[n_groups * p_len + i].items()}
           for i in range(cfg.n_rem)]
    return {"groups": groups, "rem": rem}
