"""The kernel build's naming (``kernels/_build.py``) and the flash
backward's dispatch table, on the CPU: a library is named by its source
and the ``csrc/`` headers it includes, so an edit to a shared header
rebuilds every library that includes it; and every (type, head dim) the
forward takes has a backward pair."""
import re

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as fa_ops


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "shared.cuh").write_text("// v1\n")
    (tmp_path / "a.cu").write_text('#include <cuda.h>\n#include "shared.cuh"\n'
                                   "int a;\n")
    (tmp_path / "b.cu").write_text("int b;\n")
    return tmp_path


def test_a_header_edit_renames_the_libraries_that_include_it(csrc):
    a, b = _build.library_path("a"), _build.library_path("b")
    assert re.fullmatch(r"liba-[0-9a-f]{16}\.so", a.name)
    assert _build.library_path("a") == a              # stable
    (csrc / "shared.cuh").write_text("// v2\n")
    assert _build.library_path("a") != a              # rebuilt
    assert _build.library_path("b") == b              # not including it
    (csrc / "b.cu").write_text("int b;  \n")
    assert _build.library_path("b") != b


def test_the_sources_include_only_headers_that_exist():
    for name in _build.SOURCES:
        src = (_build.CSRC / f"{name}.cu").read_text()
        for header in re.findall(r'#include "([^"]+)"', src):
            assert (_build.CSRC / header).is_file(), (name, header)
        assert _build.library_path(name).name.startswith(f"lib{name}-")
    for name in ("flash_attention", "flash_attention_bwd"):
        assert '#include "hopper.cuh"' in (_build.CSRC /
                                           f"{name}.cu").read_text()


def test_flash_backward_variant_table_is_pinned():
    """Every (type, head dim) of the forward's table has a backward pair:
    the tensor cores for bf16 at head dims 64, 128 and 256, the CUDA cores
    for the rest (float32, and bf16 at 32 and 96)."""
    assert set(fa_ops.BWD_VARIANTS) == set(fa_ops.VARIANTS)
    wgmma = {k for k, v in fa_ops.BWD_VARIANTS.items() if v == "wgmma"}
    assert wgmma == {(torch.bfloat16, 64), (torch.bfloat16, 128),
                     (torch.bfloat16, 256)}
    assert set(fa_ops.BWD_VARIANTS.values()) == {"wgmma", "fma"}
    for (dtype, d), kind in fa_ops.BWD_VARIANTS.items():
        assert fa_ops.bwd_variant(dtype, d) == kind
        if kind == "wgmma":
            assert fa_ops.variant(dtype, d) == "wgmma"
    with pytest.raises(ValueError, match="head dim 48"):
        fa_ops.bwd_variant(torch.bfloat16, 48)
    assert set(fa_ops.launches) >= {"flash_attention.bwd_wgmma",
                                    "flash_attention.bwd_fma",
                                    "flash_attention.bwd_sum"}


def test_the_variant_tool_sets_the_tile_constants():
    """``tools/flash_bwd_variants.py`` rewrites the tensor-core pair's
    two tile constants in a copy of the source: the committed values
    give the source back, others change exactly those two lines, and
    every variant it builds is a distinct source; at head dim 256 it
    times every split of the group, the rule's among them."""
    import importlib.util
    path = _build.CSRC.parents[2] / "tools" / "flash_bwd_variants.py"
    spec = importlib.util.spec_from_file_location("flash_bwd_variants", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    text = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    assert tool.variant_source(text, 128, 3) == text
    other = tool.variant_source(text, 64, 2)
    changed = [(a, b) for a, b in zip(text.splitlines(),
                                      other.splitlines()) if a != b]
    assert [b.strip() for _, b in changed] == [
        "static constexpr int kStep = D == 64 ? 64 : 64;",
        "static constexpr int kStages = 2;"]
    assert len({tool.variant_source(text, *key)
                for key in tool.VARIANTS}) == len(tool.VARIANTS)
    with pytest.raises(ValueError, match="matches 0 times"):
        tool.variant_source("int x;", 64, 2)
    for _, b, h, kh, s, d, _ in tool.SHAPES:
        assert fa_ops.bwd_split(b, h, kh, s, d, 132) in tool.splits(h, kh, d)
    assert tool.splits(16, 1, 256) == (1, 2, 4, 8, 16)
    assert tool.splits(16, 8, 128) == (1,)


def test_the_wkv6_backward_tool_sets_the_walks_unroll():
    """``tools/wkv6_bwd_variants.py`` sets the unroll pragma of both of
    the WKV6 backward's walks in a copy of the source (the committed 4
    gives the source back, others change exactly those two lines); the
    recurrences' backward sources are built."""
    import importlib.util
    path = _build.CSRC.parents[2] / "tools" / "wkv6_bwd_variants.py"
    spec = importlib.util.spec_from_file_location("wkv6_bwd_variants", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    text = (_build.CSRC / "wkv6_bwd.cu").read_text()
    assert tool.variant_source(text, 4) == text
    other = tool.variant_source(text, 2)
    changed = [(a, b) for a, b in zip(text.splitlines(),
                                      other.splitlines()) if a != b]
    assert [b for _, b in changed] == ["#pragma unroll 2"] * 2
    with pytest.raises(ValueError, match="matches 0 times"):
        tool.variant_source("int x;", 2)
    assert {"wkv6_bwd", "rglru_bwd"} <= set(_build.SOURCES)


@pytest.mark.parametrize("shape,split", [
    ((2, 16, 1, 2048, 256), 4),    # recurrentgemma-9b's training shape
    ((4, 4, 1, 2048, 256), 2),     # gemma3-1b's
    ((1, 16, 1, 200, 256), 16),    # too few key tiles: the whole group
    ((2, 4, 4, 2048, 256), 1),     # a group of 1 cannot split
    ((4, 16, 8, 2048, 128), 1),    # the other head dims never split
    ((3, 8, 1, 4096, 256), 1),     # 192 key tiles already fill the card
    ((1, 12, 1, 1024, 256), 12)])  # 16 tiles x 6 < 132: the group
def test_the_head_dim_256_split_fills_the_card(shape, split):
    """``bwd_split``: the fewest slices of a KV head's query heads, a
    divisor of the group, that give the D 256 dK/dV kernel one block an SM
    of the H100's 132; each slice owns a contiguous run of the group."""
    b, h, kh, sk, d = shape
    got = fa_ops.bwd_split(b, h, kh, sk, d, 132)
    assert got == split and (h // kh) % got == 0
    blocks = b * kh * -(-sk // fa_ops.BWD_KEYS_256) * got
    assert blocks >= 132 or got == h // kh or d != 256
