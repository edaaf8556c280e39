"""The dry run on the meta device (``repro_torch.launch.dryrun``): every
arch's smoke config through a train, a prefill and a decode step on a
fake (2, 4) mesh, with status ok, and per-rank parameter bytes equal to
what the JAX package's specs imply for the same shapes.  The cells run in
a process of their own (the fake process group is never started in this
one)."""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro.configs import registry as jreg
from repro.distributed import sharding as jsh
from repro.distributed import specs as jspecs
from repro.models import model as JM

import jax

ROOT = Path(__file__).resolve().parents[1]
MESH = (2, 4)
SHAPES = ("train_4k", "prefill_32k", "decode_32k")

RUN = """
import json, sys
import torch
from repro_torch.configs import registry
from repro_torch.launch import dryrun
torch.set_num_threads(1)
out = []
for arch in registry.ARCHS:
    for shape in {shapes!r}:
        rec = dryrun.run_cell(arch, shape, False, "baseline",
                              mesh_shape_override={mesh!r})
        rec.pop("traceback", None)
        out.append(rec)
dryrun.dist.destroy_process_group()
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    path = tmp_path_factory.mktemp("dryrun") / "cells.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c",
                        RUN.format(shapes=SHAPES, mesh=MESH), str(path)],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    return {(c["arch"], c["shape"]): c for c in json.loads(path.read_text())}


def jax_param_bytes_per_rank(arch: str) -> float:
    """Bytes of a rank's shards of the JAX package's smoke parameters on
    a (2, 4) ("data", "model") mesh under its baseline rules."""
    cfg = jreg.smoke_config(arch)
    mesh = AbstractMesh(MESH, ("data", "model"))
    params = JM.abstract_params(cfg)
    with jsh.use_mesh(mesh) as rules:
        specs = jspecs.param_specs(params, mesh, rules)
    total = 0.0
    for leaf, spec in zip(jax.tree_util.tree_leaves(params),
                          jax.tree_util.tree_leaves(
                              specs, is_leaf=lambda x: isinstance(
                                  x, jax.sharding.PartitionSpec))):
        n = 1
        for dim, entry in zip(leaf.shape, tuple(spec) + (None,) * len(
                leaf.shape)):
            ways = 1 if entry is None else math.prod(
                mesh.shape[a] for a in ((entry,) if isinstance(entry, str)
                                        else entry))
            n *= dim // ways
        total += n * np.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("arch", jreg.ARCHS)
def test_every_step_runs_on_the_fake_mesh(cells, arch):
    for shape in SHAPES:
        c = cells[(arch, shape)]
        assert c["status"] == "ok", (shape, c.get("error"))
        assert c["mesh"] == "2x4" and c["meta"]["chips"] == 8
        assert c["fits_80gb"] is True
        assert c["flops_rank"] > 0 and c["model_flops"] > 0
        assert set(c["roofline"]) >= {"compute_s", "memory_s",
                                      "collective_s", "bottleneck"}
        pr = c["per_rank_bytes"]
        assert pr["total"] == pr["params"] + pr["opt"] + pr["caches"]
        # every rank holds a slice: less than the whole
        assert 0 < pr["params"] < c["params_bytes"]
    train = cells[(arch, "train_4k")]
    assert train["per_rank_bytes"]["opt"] > 0
    assert sum(train["collective_counts"].values()) > 0
    assert cells[(arch, "decode_32k")]["per_rank_bytes"]["caches"] > 0


@pytest.mark.parametrize("arch", jreg.ARCHS)
def test_per_rank_parameter_bytes_match_jax_specs(cells, arch):
    want = jax_param_bytes_per_rank(arch)
    for shape in SHAPES:
        assert cells[(arch, shape)]["per_rank_bytes"]["params"] == want
