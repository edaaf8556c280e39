"""Checkpointing: save/restore of the training state with atomic
manifests (the JAX package's ``repro.train.checkpoint``, same files).

* Trees flatten to path-keyed arrays in one ``step_XXXXXXXX.npz`` per
  step, keys ``name::path``: a module by its parameter names, an
  :class:`~.optimizer.AdamWState` by field (``step``, ``mu/<param>``, an
  int8 moment's ``mu/<param>/q`` and ``/s``; no master, no keys), a dict by
  its keys.  bfloat16 tensors are stored as float32 (exact) and restored
  to their template's type.
* Writes are crash-safe: payload first, then ``manifest_XXXXXXXX.json``
  by an atomic ``os.replace``, so a torn write is invisible to
  ``latest_step``.
* ``restore`` fills templates (a module on any device, the meta device
  included, an ``AdamWState`` of tensors or meta tensors) on a device.
* On a mesh: ``save`` gathers each DTensor whole (every rank of the
  process group calls it; rank 0 writes), and ``restore(...,
  shardings=)`` places each restored tensor by the DTensor placements of
  a mesh that may be another than the one that saved it (the elastic
  path: a checkpoint of a (4, 2) mesh resumed on (2, 2)).
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from .. import device as device_mod
from ..distributed import sharding
from .optimizer import AdamWState


def _items(tree):
    if isinstance(tree, nn.Module):
        return list(tree.named_parameters())
    if isinstance(tree, AdamWState):
        return list(tree._asdict().items())
    if isinstance(tree, Mapping):
        return list(tree.items())
    return None


def _key(prefix: str, k) -> str:
    return f"{prefix}/{k}" if prefix else str(k)


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    if tree is None:
        return {}
    items = _items(tree)
    if items is None:
        t = tree.detach()
        if sharding.is_dtensor(t):
            t = t.full_tensor()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return {prefix: t.cpu().numpy()}
    flat = {}
    for k, v in items:
        flat.update(_flatten(v, _key(prefix, k)))
    return flat


def _on_mesh(tree) -> bool:
    if tree is None:
        return False
    items = _items(tree)
    if items is None:
        return sharding.is_dtensor(tree)
    return any(_on_mesh(v) for _, v in items)


def save(ckpt_dir: str, step: int, trees: Dict[str, Any]) -> str:
    payload = {}
    for name, tree in trees.items():
        for k, v in _flatten(tree).items():
            payload[f"{name}::{k}"] = v
    data_path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    if any(_on_mesh(t) for t in trees.values()) and dist.is_initialized():
        # every rank gathered the same whole tensors: one writes
        if dist.get_rank() == 0:
            _write(ckpt_dir, step, payload, data_path)
        dist.barrier()
        return data_path
    return _write(ckpt_dir, step, payload, data_path)


def _write(ckpt_dir: str, step: int, payload, data_path: str) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp_fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".npz.tmp")
    with os.fdopen(tmp_fd, "wb") as f:      # file handle: savez must not
        np.savez(f, **payload)              # append ".npz" to the tmp name
    os.replace(tmp, data_path)
    manifest = os.path.join(ckpt_dir, f"manifest_{step:08d}.json")
    tmp_fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".json.tmp")
    with os.fdopen(tmp_fd, "w") as f:
        json.dump({"step": step, "data": os.path.basename(data_path)}, f)
    os.replace(tmp, manifest)           # atomic commit point
    return data_path


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(f[len("manifest_"):-len(".json")])
             for f in os.listdir(ckpt_dir)
             if f.startswith("manifest_") and f.endswith(".json")]
    return max(steps) if steps else None


def _sub(sh, k):
    """The shardings of entry ``k`` of a tree (None: not sharded)."""
    if sh is None:
        return None
    if isinstance(sh, AdamWState):
        return getattr(sh, k)
    return sh.get(k) if isinstance(sh, Mapping) else None


def _fill(tree, prefix: str, data, dev: torch.device, sh=None):
    if tree is None:
        return None
    if isinstance(tree, nn.Module):
        if any(p.is_meta for p in tree.parameters()):
            tree = tree.to_empty(device=dev)
        tree = tree.to(dev)
        with torch.no_grad():
            for name, p in list(tree.named_parameters()):
                full = torch.from_numpy(data[_key(prefix, name)])
                s = _sub(sh, name)
                if s is None:
                    p.copy_(full)
                    continue
                mod, _, leaf = name.rpartition(".")
                setattr(tree.get_submodule(mod) if mod else tree, leaf,
                        nn.Parameter(sharding.distribute(
                            full.to(dev, p.dtype), s),
                            requires_grad=p.requires_grad))
        return tree
    if isinstance(tree, AdamWState):
        return AdamWState(**{f: _fill(v, _key(prefix, f), data, dev,
                                      _sub(sh, f))
                             for f, v in tree._asdict().items()})
    if isinstance(tree, Mapping):
        return {k: _fill(v, _key(prefix, k), data, dev, _sub(sh, k))
                for k, v in tree.items()}
    t = torch.from_numpy(data[prefix]).to(dev, tree.dtype)
    return t if sh is None else sharding.distribute(t, sh)


def restore(ckpt_dir: str, step: int, templates: Dict[str, Any],
            device=None, shardings: Optional[Dict[str, Any]] = None
            ) -> Dict[str, Any]:
    """Trees shaped like ``templates``, filled from checkpoint ``step`` on
    ``device`` (default: the card).  A module template is filled in place
    (materialised first if it lies on the meta device).  ``shardings``
    (optional): by template name, a tree of
    :class:`~repro_torch.distributed.sharding.NamedSharding` shaped like
    it (a module's by parameter name; None: not sharded), by which each
    tensor is placed as a DTensor on its mesh."""
    dev = device_mod.resolve(device)
    with open(os.path.join(ckpt_dir, f"manifest_{step:08d}.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(ckpt_dir, manifest["data"])) as npz:
        data = {k: npz[k] for k in npz.files}
    out = {}
    for name, template in templates.items():
        sub = {k[len(name) + 2:]: v for k, v in data.items()
               if k.startswith(f"{name}::")}
        out[name] = _fill(template, "", sub, dev,
                          (shardings or {}).get(name))
    return out
