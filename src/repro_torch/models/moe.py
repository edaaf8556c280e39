"""Mixture-of-Experts FFN: top-k routing with sort-based capacity dispatch
(the port of the JAX package's ``models/moe.py``).

Flat (token, expert, gate) triples are sorted by expert (a stable sort, as
``jnp.argsort`` is); a triple's slot is its position within its expert's
segment, and slots past ``capacity`` are dropped.  The kept tokens go to an
(E, C, D) buffer, the experts' gated FFNs run as batched matmuls, and the
outputs, times their gates, are added back to their tokens in x's type.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed.sharding import (as_replicated, is_dtensor, replicated,
                                   shard)
from . import layers


class MoE(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        dt = layers.dtype_of(cfg)
        e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
        self.router = layers.param((d, e), dt, device)
        self.w_gate = layers.param((e, d, f), dt, device)
        self.w_up = layers.param((e, d, f), dt, device)
        self.w_down = layers.param((e, f, d), dt, device)
        self.shared = (layers.FFN(cfg, device) if cfg.num_shared_experts
                       else None)


def init_moe(p: MoE, cfg, gen: torch.Generator) -> None:
    d, f = cfg.d_model, cfg.d_ff
    layers.init_dense(p.router, gen, scale=0.02)
    layers.init_normal(p.w_gate, gen, d ** -0.5)
    layers.init_normal(p.w_up, gen, d ** -0.5)
    layers.init_normal(p.w_down, gen, f ** -0.5)
    if p.shared is not None:
        layers.init_ffn(p.shared, cfg, gen)


class Routing(NamedTuple):
    """Where each of the T * k (token, expert) pairs goes, in expert order:
    its expert, token and normalised gate, its slot in the expert's buffer
    and whether the slot is inside ``capacity`` (``ok``); ``idx_k`` (T, k)
    are the chosen experts, best first; ``aux`` the load-balancing loss."""
    idx_k: torch.Tensor
    e_sorted: torch.Tensor
    tok_sorted: torch.Tensor
    gate_sorted: torch.Tensor
    slot: torch.Tensor
    ok: torch.Tensor
    capacity: int
    aux: torch.Tensor


def route(logits: torch.Tensor, cfg) -> Routing:
    """The routing of T tokens from their float32 router logits (T, E).
    Logits that are a DTensor are routed whole on every rank (a sort over
    all tokens), and the gates and the auxiliary loss come back as
    replicated DTensors."""
    mesh = None
    if is_dtensor(logits):
        mesh = logits.device_mesh
        logits = replicated(logits).to_local()
    t, e = logits.shape
    k = cfg.experts_per_token
    gates_all = torch.softmax(logits, dim=-1)
    # lax.top_k puts the lower index first among equal gates: a stable
    # descending sort does too
    vals, idx = torch.sort(gates_all, dim=-1, descending=True, stable=True)
    gate_k, idx_k = vals[:, :k], idx[:, :k]
    gate_k = gate_k / torch.clamp(gate_k.sum(-1, keepdim=True), min=1e-9)

    # load-balancing auxiliary loss (Switch/GShard form)
    me = gates_all.mean(0)
    ce = F.one_hot(idx_k[:, 0], e).to(torch.float32).mean(0)
    aux = e * torch.sum(me * ce)

    capacity = max(int(t * k / e * cfg.capacity_factor), 8)
    flat_e = idx_k.reshape(-1)
    flat_tok = torch.arange(t, device=logits.device).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    seg_start = torch.searchsorted(e_sorted,
                                   torch.arange(e, device=logits.device))
    pos = torch.arange(t * k, device=logits.device) - seg_start[e_sorted]
    ok = pos < capacity
    gate_sorted = gate_k.reshape(-1)[order]
    if mesh is not None:
        gate_sorted, aux = (as_replicated(gate_sorted, mesh),
                            as_replicated(aux, mesh))
    return Routing(idx_k, e_sorted, flat_tok[order], gate_sorted,
                   torch.where(ok, pos, torch.full_like(pos, capacity)), ok,
                   capacity, aux)


def apply_moe(p: MoE, x, cfg):
    """x (B, S, D) -> (y, aux)."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    r = route((xf @ p.router).float(), cfg)
    # one spare row takes the slots past capacity, and is dropped
    buf = xf.new_zeros((cfg.num_experts, r.capacity + 1, d))
    buf[r.e_sorted, r.slot] = xf[r.tok_sorted]
    buf = shard(buf[:, :r.capacity], "experts", None, None)
    h = F.silu(torch.bmm(buf, p.w_gate)) * torch.bmm(buf, p.w_up)
    h = shard(h, "experts", None, "ff")
    out = torch.bmm(h, p.w_down)                              # (E, C, D)
    gathered = out[r.e_sorted, torch.clamp(r.slot, max=r.capacity - 1)]
    gathered = gathered * (r.gate_sorted * r.ok)[:, None].to(gathered.dtype)
    y = xf.new_zeros((b * s, d)).index_add(0, r.tok_sorted, gathered)
    y = y.reshape(b, s, d)
    if p.shared is not None:
        y = y + layers.apply_ffn(p.shared, x, cfg)
    return y, r.aux
