"""The port's package rules: nothing on the card side imports JAX or the
JAX package, and entry points run on the card unless given the CPU."""
import ast
from pathlib import Path

import pytest
import torch

from repro_torch import device as device_mod
from repro_torch.configs import registry
from repro_torch.models import model as model_lib

ROOT = Path(__file__).resolve().parents[1]
CARD_SIDE = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_gpu.py"]


def imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", CARD_SIDE,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_card_side_imports_no_jax(path):
    for name in imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert device_mod.resolve("cpu").type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_mod.resolve()
    for arch in ("qwen3-1.7b", "rwkv6-7b", "recurrentgemma-9b"):
        cfg = registry.smoke_config(arch)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            model_lib.init_params(cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            model_lib.init_cache(cfg, 2, 16)
