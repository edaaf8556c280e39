"""The decode kernel's split rule and its split-and-combine arithmetic, on
the CPU: ``plan_splits`` (rows per split from B, KH and S alone) and the
plain emulation of the two kernels (``split_partial_emulation``) held
against the JAX package's decode partial, its Pallas kernel in interpret
mode and its oracle, on the same seeded inputs at 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import ops as jdec
from repro_torch.kernels.decode_attention import ops as tdec
from repro_torch.kernels.decode_attention import ref as tdec_ref

TOL = 1e-5
SMS = 132                 # an H100's streaming multiprocessors


@pytest.mark.parametrize("b,kh,s", [
    (1, 1, 0), (1, 1, 1), (1, 1, 31), (1, 1, 32), (1, 1, 33), (3, 2, 700),
    (5, 1, 5000), (4, 8, 2112), (8, 8, 4096), (4, 1, 4096), (16, 8, 32768),
    (1, 1, 1 << 20)])
def test_plan_splits_tile_the_cache(b, kh, s):
    rows, n = tdec.plan_splits(b, kh, s)
    assert rows % tdec.SPLIT_QUANTUM == 0
    assert tdec.SPLIT_QUANTUM <= rows <= tdec.SPLIT_ROWS_MAX
    assert n >= 1 and n * rows >= s and (n - 1) * rows < max(s, 1)


def _visible_blocks(b, kh, s, lengths, window=0):
    """Split blocks with a visible row at these lengths, and all."""
    rows, n = tdec.plan_splits(b, kh, s)
    busy = 0
    for ln in lengths:
        lo = max(0, ln - window) if window else 0
        hi = min(s, ln)
        busy += kh * ((hi - 1) // rows - lo // rows + 1) if hi > lo else 0
    return busy, b * kh * n


def test_plan_splits_meet_the_block_targets():
    # a 32,768-long cache at B 16, KH 8 with the smoke test's lengths:
    # several waves of busy blocks over the SMs
    rng = np.random.RandomState(4)
    ln = rng.randint(1, 32769, 16)
    ln[0], ln[-1] = 1, 32768
    busy, blocks = _visible_blocks(16, 8, 32768, ln.tolist())
    assert busy >= 8 * SMS and blocks >= 16 * SMS
    # recurrentgemma-9b's decode step (B 4, KH 1, S 4,096, window 2,048,
    # lengths past the window): ~2 x 132 busy blocks, where the old kernel
    # had 4 x 4 = 16 (32 rows, the smallest split, cut the window into 65)
    busy, blocks = _visible_blocks(4, 1, 4096, [2049, 2051, 2054, 2056],
                                   window=2048)
    assert busy == 4 * 65 and blocks >= 2 * SMS
    assert tdec.plan_splits(4, 1, 4096)[0] == tdec.SPLIT_QUANTUM


def _inputs(seed, b, h, kh, s, d, dtype):
    """The same seeded numpy inputs as JAX arrays and CPU tensors (bf16
    values rounded once, identically for both)."""
    rng = np.random.RandomState(seed)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    js = [jnp.asarray(rng.randn(*shape).astype(np.float32), jdt)
          for shape in ((b, h, 1, d), (b, kh, s, d), (b, kh, s, d))]
    ts = [torch.from_numpy(np.array(j, np.float32)).to(getattr(torch, dtype))
          for j in js]
    return js, ts


def _close(got, want, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=TOL, rtol=TOL, err_msg=what)


# (G, D, window, kpos_offset, dtype): G 1, 2 and 16 (H / KH), head dims 32
# and 256, with the window and the shard offset off and on
SPLIT_CASES = [(g, d, window, off, "float32") for g in (1, 2, 16)
               for d in (32, 256) for window, off in ((0, 0), (100, 256))]
SPLIT_CASES += [(16, 256, 100, 0, "bfloat16"), (2, 32, 0, 256, "bfloat16")]
# head dim 96 (phi-3-vision): three 32-column combine blocks
SPLIT_CASES += [(2, 96, 0, 0, "float32"), (16, 96, 100, 256, "bfloat16")]


@pytest.mark.parametrize("g,d,window,kpos_offset,dtype", SPLIT_CASES)
def test_split_emulation_matches_jax(g, d, window, kpos_offset, dtype):
    b, s = 5, 512
    kh = 1 if g == 16 else 2
    h = g * kh
    rows, n = tdec.plan_splits(b, kh, s)
    assert n > 8                     # many splits at this size
    # global lengths: an idle row, one row (or, with an offset, a row that
    # ends before this shard), a length on a split boundary, one inside a
    # split whose window crosses boundaries, the whole shard
    off = kpos_offset
    lengths = np.asarray([0, off // 2 + 1, off + 2 * rows, off + 301,
                          off + s], np.int32)
    (q, k, v), (tq, tk, tv) = _inputs(g * 1000 + d + window, b, h, kh, s,
                                      d, dtype)
    kw = dict(window=window, kpos_offset=kpos_offset)
    got = tdec_ref.split_partial_emulation(tq, tk, tv,
                                           torch.from_numpy(lengths), **kw)
    jl = jnp.asarray(lengths)
    for impl in ("interpret", "ref"):
        want = jdec.decode_partial(q, k, v, jl, impl=impl, **kw)
        for x, y, name in zip(got, want, ("acc", "m", "l")):
            assert x.dtype == torch.float32 and x.shape == y.shape
            _close(x, y, f"{impl} {name}")
    acc, m, l = got
    assert torch.all(acc[0] == 0) and torch.all(l[0] == 0)     # idle
    assert torch.all(m[0] == tdec_ref.NEG_INF)
    assert torch.isfinite(acc).all() and torch.isfinite(l).all()


@pytest.mark.parametrize("rows", [32, 64, 96, 512])
def test_split_emulation_at_other_split_sizes(rows):
    """Any split size gives the one partial, within the float32 limit of
    the whole-cache oracle; an offset shard whose rows no length reaches
    gives the idle partial."""
    (_, _, _), (tq, tk, tv) = _inputs(rows, 4, 8, 2, 700, 64, "float32")
    lengths = torch.tensor([0, 96, 500, 700], dtype=torch.int32)
    for window, off in ((0, 0), (150, 64), (0, 700)):
        kw = dict(window=window, kpos_offset=off)
        got = tdec_ref.split_partial_emulation(tq, tk, tv, lengths,
                                               rows=rows, **kw)
        want = tdec_ref.decode_partial_reference(tq, tk, tv, lengths, **kw)
        for x, y, name in zip(got, want, ("acc", "m", "l")):
            _close(x, y, f"{kw} {name}")
        if off == 700:                # past every length: all rows idle
            assert torch.all(got[0] == 0) and torch.all(got[2] == 0)
            assert torch.all(got[1] == tdec_ref.NEG_INF)


@pytest.mark.parametrize("d", [32, 64, 96, 128, 256])
def test_combine_columns_cover_every_head_dim(d):
    """The combine's D // cols column blocks tile [0, D) at every head dim
    the kernels take."""
    cols = tdec.combine_cols(d)
    assert cols in (32, 64) and (d // cols) * cols == d


def test_combine_at_head_dim_96_covers_every_column():
    """At D 96 the combine's blocks of 32 columns write all of acc; blocks
    of min(D, 64) = 64 columns, one block, would leave columns 64-95
    unwritten."""
    (_, _, _), (tq, tk, tv) = _inputs(96, 3, 4, 2, 300, 96, "float32")
    lengths = torch.tensor([0, 150, 300], dtype=torch.int32)
    want = tdec_ref.decode_partial_reference(tq, tk, tv, lengths)
    got = tdec_ref.split_partial_emulation(tq, tk, tv, lengths)
    for x, y, name in zip(got, want, ("acc", "m", "l")):
        _close(x, y, name)
    short = tdec_ref.split_partial_emulation(tq, tk, tv, lengths, cols=64)
    assert torch.isnan(short[0][1:, :, :, 64:]).all()
    _close(short[0][1:, :, :, :64], want[0][1:, :, :, :64], "first block")
