"""Logical-axis sharding (the JAX package's ``repro.distributed.sharding``):
model code annotates tensors with *logical* axis names; a rule set maps
them to mesh axes (or nothing, on a single device).

Baseline rules (the reference's, exactly):

  batch     -> (pod, data)     data parallelism across pods and the DP axis
  ff        -> model           Megatron MLP tensor parallelism
  vocab     -> model           sharded embedding/logits
  heads     -> model           ONLY when num_heads % |model| == 0 (opt-in)
  kv_seq    -> model           decode caches shard over sequence
  long_seq  -> (data, model)   the 500k decode cache
  fsdp      -> data            ZeRO-style parameter/optimizer sharding

A *spec* is a tuple with one entry per tensor dim: a mesh axis name, a
tuple of names, or ``None`` (the reference's ``PartitionSpec``).
:func:`placements` turns a spec into DTensor placements (``Shard(d)`` /
``Replicate()``, one per mesh dim).  A mesh is a ``DeviceMesh`` or, where
only its shape matters (specs, the dry run's analysis), a mapping
``{axis name: size}``.

``shard`` redistributes only a DTensor under an active ``DeviceMesh``: on
one card, with no mesh, it returns its argument, so the same model code
pays nothing there.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple, Union

import torch

Axis = Union[str, Tuple[str, ...], None]
Spec = Tuple[Axis, ...]

_state = threading.local()


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or of such a mapping."""
    if isinstance(mesh, Mapping):
        return {str(a): int(n) for a, n in mesh.items()}
    return dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.mesh.shape)))


def axis_size(mesh, axis: Axis) -> int:
    """The number of shards a spec entry makes (1 for ``None``)."""
    if axis is None:
        return 1
    shape = mesh_shape(mesh)
    names = (axis,) if isinstance(axis, str) else axis
    n = 1
    for a in names:
        n *= shape[a]
    return n


def default_rules(mesh) -> Dict[str, Axis]:
    if mesh is None:
        return {}
    axes = set(mesh_shape(mesh))
    batch = tuple(a for a in ("pod", "data") if a in axes) or None
    return {
        "batch": batch,
        "ff": "model" if "model" in axes else None,
        "vocab": "model" if "model" in axes else None,
        "heads": None,           # opt-in per arch (divisibility)
        "kv_heads": None,
        "kv_seq": "model" if "model" in axes else None,
        "long_seq": tuple(a for a in ("data", "model") if a in axes) or None,
        "fsdp": "data" if "data" in axes else None,
        "experts": None,         # EP is a hillclimb option
        "d_model": None,
        "seq": None,
    }


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[Dict[str, Axis]] = None, **overrides):
    """Activate a mesh + logical rules for model code in this thread."""
    r = default_rules(mesh)
    if rules:
        r.update(rules)
    r.update(overrides)
    prev = getattr(_state, "ctx", None)
    _state.ctx = (mesh, r)
    try:
        yield r
    finally:
        _state.ctx = prev


def current() -> Tuple[Any, Dict[str, Axis]]:
    ctx = getattr(_state, "ctx", None)
    return ctx if ctx is not None else (None, {})


def P(*entries: Axis) -> Spec:
    """A spec of these entries, a one-name tuple as the name alone (as the
    reference's ``PartitionSpec`` normalizes it)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def resolve(logical, rules: Mapping[str, Axis]) -> Spec:
    """Logical axis names (or None) to a spec under ``rules``."""
    return P(*(rules.get(name) if name else None for name in logical))


def spec(*logical: Optional[str]) -> Spec:
    """The spec of logical axis names under the active rules."""
    return resolve(logical, current()[1])


def placements(spec_: Spec, mesh) -> tuple:
    """DTensor placements of ``spec_`` on ``mesh``: for each mesh dim,
    ``Shard(d)`` of the tensor dim whose entry names it, else
    ``Replicate()``.  A tensor dim split over several mesh dims (a tuple
    entry, major first as the mesh orders them) shards over each."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in mesh_shape(mesh):
        dim = next((d for d, e in enumerate(spec_)
                    if e == axis or (isinstance(e, tuple) and axis in e)),
                   None)
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


class NamedSharding(NamedTuple):
    """A spec on a mesh (the reference's ``NamedSharding``)."""
    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def shard(x, *logical: Optional[str]):
    """Redistribute a DTensor to the logical axes' placements under the
    active mesh; any other argument, or no active ``DeviceMesh``, or a spec
    that names no mesh axis, returns ``x`` as it is."""
    mesh, rules = current()
    if mesh is None or isinstance(mesh, Mapping):
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    resolved = resolve(logical, rules)
    if all(r is None for r in resolved):
        return x
    return x.redistribute(mesh, placements(resolved, mesh))


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def split_last(x, shape):
    """``x.reshape(shape)``, where ``shape`` splits x's last dim (into
    heads and a head dim, say).  A DTensor whose last dim is sharded over
    more ranks than the leading factor divides is gathered on that dim
    first (the reference's partitioner does the same); anything else
    reshapes as it is."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate
        last = x.ndim - 1
        ways = 1
        for i, p in enumerate(x.placements):
            if p.is_shard(last):
                ways *= x.device_mesh.size(i)
        if shape[last] % ways:
            x = x.redistribute(x.device_mesh, [
                Replicate() if p.is_shard(last) else p
                for p in x.placements])
    return x.reshape(shape)


def as_replicated(t: torch.Tensor, mesh):
    """A plain tensor that every rank holds whole as a replicated DTensor
    on ``mesh`` (differentiably: its gradient comes back plain)."""
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


def replicated(x):
    """A DTensor gathered whole on every rank of its mesh (a row gather
    from a sharded table needs the table whole); anything else as it
    is."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh,
                          (Replicate(),) * x.device_mesh.ndim)


def named_sharding(*logical: Optional[str]) -> Optional[NamedSharding]:
    mesh, _ = current()
    if mesh is None:
        return None
    return NamedSharding(mesh, spec(*logical))


def _is_logical(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def tree_map(fn, tree, is_leaf=None):
    """``fn`` over the leaves of a tree of mappings, lists and tuples
    (a NamedTuple keeps its type); ``None`` stays ``None``."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, is_leaf) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, is_leaf) for v in tree)
    if tree is None:
        return None
    return fn(tree)


def tree_shardings(tree_of_logical, mesh, rules: Dict[str, Axis]):
    """Map a tree of logical-axis tuples to NamedShardings."""
    return tree_map(lambda axes: NamedSharding(mesh, resolve(axes, rules)),
                    tree_of_logical, is_leaf=_is_logical)


def distribute(t: torch.Tensor, sharding: NamedSharding):
    """``t`` as a DTensor by ``sharding``'s placements on its mesh."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, sharding.mesh, sharding.placements)
