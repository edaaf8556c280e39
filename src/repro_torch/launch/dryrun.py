"""Dry run of the production meshes on the meta device (the JAX package's
``repro.launch.dryrun``).

Per (arch x shape x mesh) cell this script:
  1. starts a fake process group of the production mesh's size (256
     ranks for (16, 16), 512 for (2, 16, 16); ``FakeStore``, no peers:
     every collective returns at once) and builds the mesh,
  2. resolves the sharding rules (with the ``--opt`` profile's levers) and
     places parameters, optimizer state, the batch and the caches as
     DTensors on the meta device by :mod:`..distributed.specs`,
  3. runs one train, prefill or decode step of the port's own step
     builders on them under a FLOP counter and a collective counter,
  4. records per-rank bytes of parameters, optimizer state and caches
     (from the local shards' shapes) and whether they fit the card's
     80 GB, the rank's FLOPs, collectives by kind with their operand
     bytes, :func:`.analysis.model_flops` / ``model_bytes`` and the
     roofline terms at the H100's data-sheet peaks,
  5. writes one JSON per cell under ``results/dryrun_torch/`` (a failing
     cell is recorded with ``status="error"`` and its exception).

Nothing touches a card: meta tensors carry shapes and no data, and the
kernels' wrappers take their plain versions on them.  Of the reference's
``--opt`` levers, ``donate`` and ``rsgrads`` change nothing here: eager
PyTorch has no buffers to donate, and every gradient is already placed
as its parameter (the reduce-scatter ``rsgrads`` asks for).  A train cell runs
one microbatch's loss and gradients and one optimizer update; with ``u``
microbatches its loss-and-gradient counts are taken ``u`` times.

Usage:
  python -m repro_torch.launch.dryrun --arch mixtral-8x7b --shape train_4k
  python -m repro_torch.launch.dryrun --arch all --shape all [--multi-pod]
  python -m repro_torch.launch.dryrun ... --opt ep+tpattn
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree
from torch.utils.flop_counter import FlopCounterMode

from ..configs import registry
from ..distributed import sharding as shrules
from ..distributed import specs as specs_lib
from ..distributed.sharding import mesh_shape
from ..models import model as model_lib
from ..train import loop as loop_lib
from ..train import optimizer as opt_lib
from . import analysis
from .mesh import PRODUCTION, make_production_mesh

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")
CARD_BYTES = 80e9          # H100 SXM: 80 GB of HBM3 (data sheet)


def pick_microbatches(cfg, seq: int, global_batch: int, mesh,
                      rules, budget_bytes: float = 2e9) -> int:
    """Smallest power-of-2 microbatch count keeping the saved residual
    streams (one per layer group) under budget."""
    batch_axes = rules.get("batch") or ()
    if isinstance(batch_axes, str):
        batch_axes = (batch_axes,)
    shape = mesh_shape(mesh)
    dp = int(math.prod(shape[a] for a in batch_axes)) or 1
    b_local = max(global_batch // dp, 1)
    carries = max(cfg.n_groups, 1)
    u = 1
    while u < b_local:
        per = (b_local // u) * seq * cfg.d_model * 2 * carries
        if per <= budget_bytes:
            break
        u *= 2
    return u


def overrides_for(tokens, shape: str, multi_pod: bool,
                  dims: Dict[str, int]) -> Dict:
    """The rule overrides of a cell on a mesh of ``dims``: the shape's
    batch, the multi-pod long sequence, and the ``ep`` / ``tpattn``
    levers."""
    out = {}
    if registry.SHAPES[shape]["batch"] < dims.get("pod", 1) * dims["data"]:
        out["batch"] = None        # B=1 long-context: no batch shard
    if multi_pod:
        out["long_seq"] = ("pod", "data", "model")
    if "ep" in tokens:
        out["experts"] = "data"
        out["fsdp"] = None
    if "tpattn" in tokens:
        # q-heads over the model axis (H % |model| == 0 where it applies)
        out["heads"] = "model"
    return out


def config_for(arch: str, tokens, smoke: bool = False):
    """The arch's config (or its smoke config) with the profile's config
    levers: wincache, tpattn (repeated K/V), kvquant, rematdots."""
    cfg = (registry.smoke_config if smoke else registry.get_config)(arch)
    if "wincache" in tokens:
        cfg = dataclasses.replace(cfg, window_cache=True)
    if "tpattn" in tokens:
        cfg = dataclasses.replace(cfg, attn_gqa="repeat")
    if "kvquant" in tokens:
        cfg = dataclasses.replace(cfg, kv_quant=True)
    if "rematdots" in tokens:
        cfg = dataclasses.replace(cfg, remat="dots")
    return cfg


def fake_group(ranks: int) -> None:
    """A fake process group of ``ranks`` ranks in this process (rank 0),
    replacing one of another size."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == ranks and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=ranks)


class FlopCounter(FlopCounterMode):
    """FLOPs of the rank's own (local) operations: the ops a DTensor
    dispatches on its shards, not the DTensor-level op above them."""

    def _count_flops(self, func_packet, out, args, kwargs):
        from torch.distributed.tensor import DTensor
        leaves = pytree.tree_leaves((args, kwargs))
        if any(isinstance(a, DTensor) for a in leaves):
            return out
        return super()._count_flops(func_packet, out, args, kwargs)


def _comm_mode():
    from torch.distributed.tensor.debug import CommDebugMode

    class CommCounter(CommDebugMode):
        """CommDebugMode with each collective's operand bytes by kind."""

        def __init__(self):
            super().__init__()
            self.bytes_by_kind = collections.defaultdict(float)
            self.count_by_kind = collections.defaultdict(int)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            name = getattr(getattr(func, "_overloadpacket", None),
                           "__name__", "")
            if out is not NotImplemented and name.startswith(
                    ("all_gather", "all_reduce", "reduce_scatter",
                     "all_to_all", "broadcast")):
                t = next((a for a in pytree.tree_leaves(args)
                          if isinstance(a, torch.Tensor)), None)
                kind = name.replace("_into_tensor", "").replace("_tensor",
                                                                "")
                self.count_by_kind[kind] += 1
                if t is not None:
                    self.bytes_by_kind[kind] += t.numel() * t.element_size()
            return out

    return CommCounter()


def _bytes(tree, local: bool) -> float:
    """Bytes of a tree's tensors (a model by its parameters): in all, or
    on this rank (a DTensor's local shard)."""
    if isinstance(tree, torch.nn.Module):
        tree = dict(tree.named_parameters())
    total = 0.0

    def add(t):
        nonlocal total
        if isinstance(t, torch.Tensor):
            if local and shrules.is_dtensor(t):
                t = t.to_local()
            total += t.numel() * t.element_size()
    shrules.tree_map(add, tree)
    return total


def _distribute_tree(tree, spec_tree, mesh):
    """Meta tensors of ``tree`` as DTensors by the specs of ``spec_tree``
    (the same structure)."""
    if isinstance(tree, torch.Tensor):
        return shrules.distribute(tree, shrules.NamedSharding(mesh,
                                                              spec_tree))
    if isinstance(tree, dict):
        return {k: _distribute_tree(v, spec_tree[k], mesh)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_distribute_tree(v, s, mesh)
                          for v, s in zip(tree, spec_tree))
    return tree


def _fold(batch: Dict, u: int) -> Dict:
    """One of ``u`` microbatches (rows j, j + u, ...): its shapes."""
    return {k: v[::u] for k, v in batch.items()}


def run_cell(arch: str, shape: str, multi_pod: bool,
             opt_profile: str = "baseline",
             mesh_shape_override: Optional[tuple] = None) -> dict:
    """One cell, recorded (``status`` ok, skipped or error).
    ``mesh_shape_override`` ((data, model)) replaces the production mesh
    (the tests' small meshes at smoke configs)."""
    t0 = time.time()
    if mesh_shape_override is None:
        mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    else:
        mesh_name = "x".join(map(str, mesh_shape_override))
    rec = dict(arch=arch, shape=shape, mesh=mesh_name, status="ok",
               opt_profile=opt_profile)
    ok, why = registry.shape_supported(arch, shape)
    if not ok:
        rec.update(status="skipped", reason=why, wall_s=0.0)
        return rec
    try:
        rec.update(_measure(arch, shape, multi_pod, opt_profile,
                            mesh_shape_override))
    except Exception as e:  # a failing cell is a bug: record it loudly
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    rec["wall_s"] = round(time.time() - t0, 2)
    return rec


def _measure(arch, shape, multi_pod, opt_profile, mesh_override) -> dict:
    tokens = set(opt_profile.split("+"))
    cfg = config_for(arch, tokens, smoke=mesh_override is not None)
    if mesh_override is None:
        dims, axes = PRODUCTION[multi_pod]
    else:
        dims, axes = tuple(mesh_override), ("data", "model")
    chips = math.prod(dims)
    fake_group(chips)
    from torch.distributed.device_mesh import init_device_mesh
    mesh = (make_production_mesh(multi_pod=multi_pod, device_type="cpu")
            if mesh_override is None else
            init_device_mesh("cpu", dims, mesh_dim_names=axes))
    ov = overrides_for(tokens, shape, multi_pod, dict(zip(axes, dims)))
    cell = registry.input_specs(cfg, shape)
    kind = cell["kind"]
    with shrules.use_mesh(mesh, **ov) as rules:
        params = model_lib.abstract_params(cfg)
        specs_lib.distribute_params(params, mesh, rules)
        meta = dict(chips=chips, kind=kind, seq=cell["seq"],
                    global_batch=cell["global_batch"],
                    opt_profile=opt_profile)
        opt_bytes = cache_bytes = 0.0
        opt_local = cache_local = 0.0
        flops_c, comm = FlopCounter(display=False), _comm_mode()
        if kind == "train":
            # llama4-maverick: int8 Adam moments, no float32 master
            quant = cfg.total_params > 1e11
            ocfg = (opt_lib.AdamWConfig(moments_dtype="int8", master=False)
                    if quant else opt_lib.AdamWConfig())
            ub = pick_microbatches(cfg, cell["seq"], cell["global_batch"],
                                   mesh, rules)
            for t in tokens:        # 'mbN' forces the microbatch count
                if t.startswith("mb") and t[2:].isdigit():
                    ub = int(t[2:])
            opt = opt_lib.init(params, ocfg)
            opt_bytes, opt_local = _bytes(opt, False), _bytes(opt, True)
            batch = specs_lib.distribute_batch(_fold(cell["batch"], ub),
                                               mesh, rules)
            wire = "bfloat16" if "bf16wire" in tokens else None
            with flops_c, comm:
                _, _, grads = loop_lib.loss_and_grads(params, batch, cfg)
                if wire is not None:
                    grads = {n: g.to(getattr(torch, wire))
                             for n, g in grads.items()}
            micro = (flops_c.get_total_flops(), dict(comm.count_by_kind),
                     dict(comm.bytes_by_kind))
            flops_u, comm_u = FlopCounter(display=False), _comm_mode()
            with flops_u, comm_u, loop_lib.on_mesh(opt_lib.named(params)):
                opt_lib.update(ocfg, grads, opt, params)
            flops = micro[0] * ub + flops_u.get_total_flops()
            counts = {k: micro[1].get(k, 0) * ub
                      + comm_u.count_by_kind.get(k, 0)
                      for k in set(micro[1]) | set(comm_u.count_by_kind)}
            coll = {k: micro[2].get(k, 0.0) * ub
                    + comm_u.bytes_by_kind.get(k, 0.0)
                    for k in set(micro[2]) | set(comm_u.bytes_by_kind)}
            meta.update(microbatches=ub, quantized_opt=quant)
        elif kind == "prefill":
            extra = cfg.frontend_tokens if cfg.frontend == "vision" else 0
            step = loop_lib.make_prefill_step(cfg, s_max=cell["seq"] + extra)
            batch = specs_lib.distribute_batch(cell["batch"], mesh, rules)
            with torch.no_grad(), flops_c, comm, \
                    loop_lib.on_mesh(opt_lib.named(params)):
                _, caches, _ = step(params, batch)
            cache_bytes, cache_local = (_bytes(caches, False),
                                        _bytes(caches, True))
            flops = flops_c.get_total_flops()
            counts, coll = dict(comm.count_by_kind), dict(comm.bytes_by_kind)
        else:
            long_ctx = cell["seq"] >= (1 << 19)
            c_specs = specs_lib.cache_specs(cell["caches"], mesh, rules,
                                            long_context=long_ctx)
            caches = _distribute_tree(cell["caches"], c_specs, mesh)
            cache_bytes, cache_local = (_bytes(caches, False),
                                        _bytes(caches, True))
            b_spec = shrules.P(rules.get("batch"))
            tok = {k: cell[k] for k in ("token", "lengths", "enc_lengths")
                   if cell[k] is not None}
            tok = {k: shrules.distribute(v, shrules.NamedSharding(
                mesh, b_spec if rules.get("batch") else ()))
                for k, v in tok.items()}
            step = loop_lib.make_serve_step(cfg)
            with torch.no_grad(), flops_c, comm, \
                    loop_lib.on_mesh(opt_lib.named(params)):
                step(params, tok["token"], caches, tok["lengths"],
                     tok.get("enc_lengths"))
            flops = flops_c.get_total_flops()
            counts, coll = dict(comm.count_by_kind), dict(comm.bytes_by_kind)
            meta.update(long_context=long_ctx)
    params_bytes, params_local = _bytes(params, False), _bytes(params, True)
    mf = analysis.model_flops(cfg, kind, meta["seq"], meta["global_batch"])
    mb = analysis.model_bytes(cfg, kind, meta["seq"], meta["global_batch"],
                              params_bytes=params_bytes,
                              opt_bytes=opt_bytes, cache_bytes=cache_bytes)
    coll_rank = float(sum(coll.values()))
    per_rank = params_local + opt_local + cache_local
    # the rank's FLOPs and operand bytes, taken for every rank
    terms = analysis.roofline_terms(max(flops * chips, mf), mb,
                                    coll_rank * chips, chips)
    return dict(
        meta=meta, per_rank_bytes=dict(params=params_local,
                                       opt=opt_local, caches=cache_local,
                                       total=per_rank),
        fits_80gb=per_rank <= CARD_BYTES,
        flops_rank=float(flops), flops_used=max(flops * chips, mf),
        model_flops=mf, model_bytes=mb, params_bytes=params_bytes,
        opt_bytes=opt_bytes, cache_bytes=cache_bytes,
        collective_bytes_rank=coll_rank, collective_breakdown=coll,
        collective_counts=counts, roofline=terms)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--opt", default="baseline",
                    help="optimization profile ('+'-separated levers)")
    ap.add_argument("--out", default=RESULTS_DIR)
    args = ap.parse_args(argv)

    archs = registry.ARCHS if args.arch == "all" else [args.arch]
    shapes = list(registry.SHAPES) if args.shape == "all" else [args.shape]
    os.makedirs(args.out, exist_ok=True)
    torch.set_num_threads(1)
    try:
        for arch in archs:
            for shape in shapes:
                rec = run_cell(arch, shape, args.multi_pod, args.opt)
                fname = f"{arch}__{shape}__{rec['mesh']}__{args.opt}.json"
                with open(os.path.join(args.out, fname), "w") as f:
                    json.dump(rec, f, indent=1)
                r = rec.get("roofline", {})
                pr = rec.get("per_rank_bytes", {})
                print(f"[{rec['status']:7s}] {arch:28s} {shape:12s} "
                      f"{rec['mesh']:10s} "
                      f"rank {pr.get('total', 0) / 1e9:.2f} GB "
                      f"fits={rec.get('fits_80gb', '-')} "
                      f"C={r.get('compute_s', 0):.2e}s "
                      f"M={r.get('memory_s', 0):.2e}s "
                      f"X={r.get('collective_s', 0):.2e}s "
                      f"dom={r.get('bottleneck', '-'):10s} "
                      f"{rec['wall_s']}s", flush=True)
                if rec["status"] == "error":
                    print(rec["error"], flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
