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
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from .. import device as device_mod
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
        if t.dtype == torch.bfloat16:
            t = t.float()
        return {prefix: t.cpu().numpy()}
    flat = {}
    for k, v in items:
        flat.update(_flatten(v, _key(prefix, k)))
    return flat


def save(ckpt_dir: str, step: int, trees: Dict[str, Any]) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    payload = {}
    for name, tree in trees.items():
        for k, v in _flatten(tree).items():
            payload[f"{name}::{k}"] = v
    data_path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
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


def _fill(tree, prefix: str, data, dev: torch.device):
    if tree is None:
        return None
    if isinstance(tree, nn.Module):
        if any(p.is_meta for p in tree.parameters()):
            tree = tree.to_empty(device=dev)
        tree = tree.to(dev)
        with torch.no_grad():
            for name, p in tree.named_parameters():
                p.copy_(torch.from_numpy(data[_key(prefix, name)]))
        return tree
    if isinstance(tree, AdamWState):
        return AdamWState(**{f: _fill(v, _key(prefix, f), data, dev)
                             for f, v in tree._asdict().items()})
    if isinstance(tree, Mapping):
        return {k: _fill(v, _key(prefix, k), data, dev)
                for k, v in tree.items()}
    return torch.from_numpy(data[prefix]).to(dev, tree.dtype)


def restore(ckpt_dir: str, step: int, templates: Dict[str, Any],
            device=None) -> Dict[str, Any]:
    """Trees shaped like ``templates``, filled from checkpoint ``step`` on
    ``device`` (default: the card).  A module template is filled in place
    (materialised first if it lies on the meta device)."""
    dev = device_mod.resolve(device)
    with open(os.path.join(ckpt_dir, f"manifest_{step:08d}.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(ckpt_dir, manifest["data"])) as npz:
        data = {k: npz[k] for k in npz.files}
    out = {}
    for name, template in templates.items():
        sub = {k[len(name) + 2:]: v for k, v in data.items()
               if k.startswith(f"{name}::")}
        out[name] = _fill(template, "", sub, dev)
    return out
