"""Sharding-spec inference for parameter / optimizer / batch / cache trees
(the JAX package's ``repro.distributed.specs``).

Maps tree paths to logical axes by parameter name, then resolves logical
axes through the active rule set.  Every concrete dimension is checked for
divisibility: a logical axis that doesn't divide is dropped (replicated).

The port keeps one leaf a layer where the reference stacks a layer
group's leaves under a leading group dim, so a port leaf's spec is the
reference's without that leading entry, and divisibility is checked on
the port's own dims.  A path is the tree's mapping keys (and NamedTuple
fields), each parameter name split at its dots: ``mu`` /
``decoder.0.attn.wq`` / ``q`` resolves as ``wq``.  A model (an
``nn.Module``) is taken as its ``named_parameters``.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from .sharding import (NamedSharding, P, Spec, axis_size, distribute,
                       mesh_shape, tree_map)

# trailing-dims logical axes by parameter leaf name
_BY_NAME: Dict[str, Optional[Tuple]] = {
    "embedding": ("vocab", "fsdp"),
    "lm_head": ("fsdp", "vocab"),
    "wq": ("fsdp", "tp"), "wk": ("fsdp", "tp"), "wv": ("fsdp", "tp"),
    "wo": ("tp", "fsdp"),
    "w_gate": ("fsdp", "tp"), "w_up": ("fsdp", "tp"),
    "w_down": ("tp", "fsdp"),
    "router": ("fsdp", None),
    "shared": None,            # nested dict handled by leaf names
    "wr": ("fsdp", "tp"), "wg": ("fsdp", "tp"),
    "ck": ("fsdp", "tp"), "cv": ("tp", "fsdp"), "cr": ("fsdp", "tp"),
    "wA": ("fsdp", None), "wB": (None, None),
    "w_x": ("fsdp", "tp"), "w_out": ("tp", "fsdp"),
    "w_i": ("fsdp", "tp"), "w_r": ("fsdp", "tp"),
    "conv": (None, "tp"), "lam": ("tp",),
    "frontend_proj": (None, None),
}
# MoE expert tensors carry a leading E dim before (d, f)
_MOE_NAMES = {"w_gate", "w_up", "w_down"}

_LOGICAL_TO_RULE = {"vocab": "vocab", "tp": "ff", "fsdp": "fsdp",
                    "experts": "experts"}


def _leaf_name(keys) -> str:
    """Deepest path key with a known spec: lets the same inference cover
    optimizer-state trees (mu/<param path>/q) and quantized leaves."""
    last = ""
    for k in reversed(keys):
        if not last:
            last = k
        if k in _BY_NAME:
            return k
    return last


def _map_with_path(fn, tree, keys: Tuple[str, ...] = ()):
    """``fn(keys, leaf)`` over a tree of mappings, NamedTuples, lists and
    tensors (a module as its named parameters); ``None`` stays ``None``."""
    if isinstance(tree, nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(tree, Mapping):
        return {k: _map_with_path(fn, v, keys + tuple(str(k).split(".")))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, v, keys + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, keys) for v in tree)
    if tree is None:
        return None
    return fn(keys, tree)


def _resolve(axes, shape, rules, mesh) -> Spec:
    """Logical trailing axes -> spec with divisibility checks."""
    ndim = len(shape)
    full = (None,) * (ndim - len(axes)) + tuple(axes)
    out = []
    for dim, logical in zip(shape, full):
        mesh_axis = None
        if logical is not None:
            mesh_axis = rules.get(_LOGICAL_TO_RULE.get(logical, logical))
        if mesh_axis is not None and dim % axis_size(mesh, mesh_axis) != 0:
            mesh_axis = None
        out.append(mesh_axis)
    return P(*out)


def param_specs(abstract_params, mesh, rules: Dict):
    """Spec tree for a parameter tree (or an optimizer state over one)."""
    mesh_shape(mesh)

    def one(keys, leaf):
        name = _leaf_name(keys)
        axes = _BY_NAME.get(name)
        if axes is None:
            axes = ()                      # norms, scalars -> replicated
        if (name in _MOE_NAMES and "moe" in keys and "shared" not in keys
                and len(axes) == 2):
            # expert tensors (E, d, f): the leading E dim maps to the
            # 'experts' rule (None in the baseline; the EP profile maps it
            # to the data axis)
            axes = ("experts",) + tuple(axes)
        return _resolve(axes, tuple(leaf.shape), rules, mesh)

    return _map_with_path(one, abstract_params)


def to_shardings(spec_tree, mesh):
    return tree_map(lambda s: NamedSharding(mesh, s), spec_tree,
                    is_leaf=lambda x: isinstance(x, tuple)
                    and not hasattr(x, "_fields"))


def param_shardings(abstract_params, mesh, rules: Dict):
    return to_shardings(param_specs(abstract_params, mesh, rules), mesh)


def distribute_params(model: nn.Module, mesh, rules: Dict) -> nn.Module:
    """The model's parameters replaced, in place, by DTensors placed on
    ``mesh`` (a ``DeviceMesh``) by :func:`param_specs`."""
    shardings = param_shardings(model, mesh, rules)
    with torch.no_grad():
        for name, p in list(model.named_parameters()):
            mod, _, leaf = name.rpartition(".")
            setattr(model.get_submodule(mod) if mod else model, leaf,
                    nn.Parameter(distribute(p.detach(), shardings[name]),
                                 requires_grad=p.requires_grad))
    return model


def distribute_batch(batch: Mapping, mesh, rules: Dict) -> Dict:
    """A batch's tensors as DTensors placed by :func:`batch_specs`."""
    shardings = to_shardings(batch_specs(batch, mesh, rules), mesh)
    return {k: distribute(v, shardings[k]) for k, v in batch.items()}


def batch_specs(batch_tree, mesh, rules: Dict):
    """Shard dim 0 (global batch) over the batch axes when divisible."""

    def one(keys, leaf):
        axes = rules.get("batch")
        if axes is None:
            return ()
        shape = tuple(leaf.shape)
        if shape and shape[0] % axis_size(mesh, axes) == 0 and shape[0] > 1:
            return P(axes, *(None,) * (len(shape) - 1))
        return ()

    return _map_with_path(one, batch_tree)


def cache_specs(cache_tree, mesh, rules: Dict, *,
                long_context: bool = False):
    """Decode caches: batch on dim 0, sequence-shard k/v on dim 2."""
    seq_rule = rules.get("long_seq" if long_context else "kv_seq")

    def one(keys, leaf):
        name = _leaf_name(keys)
        shape = tuple(leaf.shape)
        batch_axes = rules.get("batch")
        out = [None] * len(shape)
        if batch_axes is not None and shape:
            if shape[0] % axis_size(mesh, batch_axes) == 0 and shape[0] > 1:
                out[0] = batch_axes
        if name in ("k", "v", "ck", "cv", "ks", "vs") and len(shape) == 4 \
                and seq_rule is not None:
            if shape[2] % axis_size(mesh, seq_rule) == 0:
                out[2] = seq_rule
        return P(*out)

    return _map_with_path(one, cache_tree)


def local_shape(shape, spec_: Spec, mesh) -> Tuple[int, ...]:
    """A rank's block of a tensor of ``shape`` sharded by ``spec_`` (every
    sharded dim divides: the specs above drop the rest)."""
    spec_ = tuple(spec_) + (None,) * (len(shape) - len(spec_))
    return tuple(int(d) // axis_size(mesh, e) for d, e in zip(shape, spec_))
