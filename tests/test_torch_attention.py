"""Parity of the port's attention kernels' wrappers (plain versions on the
CPU) with the JAX package's Pallas kernels in interpret mode and its
oracles, on the same seeded inputs, at test_kernels.py's tolerances."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import ops as jdec
from repro.kernels.decode_attention import ref as jdec_ref
from repro.kernels.flash_attention import ops as jfa
from repro.kernels.flash_attention import ref as jfa_ref
from repro_torch.kernels.decode_attention import ops as tdec
from repro_torch.kernels.decode_attention import ref as tdec_ref
from repro_torch.kernels.flash_attention import ops as tfa
from repro_torch.kernels.flash_attention import ref as tfa_ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def inputs(seed, shapes, dtype):
    """The same seeded numpy inputs as JAX arrays and as CPU tensors (the
    bfloat16 values rounded once, identically for both)."""
    rng = np.random.RandomState(seed)
    xs = [rng.randn(*s).astype(np.float32) for s in shapes]
    js = [jnp.asarray(x, JDT[dtype]) for x in xs]
    ts = [torch.from_numpy(np.array(j, np.float32)).to(TDT[dtype])
          for j in js]
    return js, ts


def close(got, want, dtype, what=""):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype], err_msg=what)


# --- flash attention --------------------------------------------------------

FLASH_CASES = [
    ("float32", 1, 2, 2, 128, 128, 64, "causal", 0, 0),      # GQA 1
    ("bfloat16", 2, 4, 2, 256, 256, 64, "causal", 64, 0),    # GQA 2, window
    ("float32", 1, 8, 2, 128, 384, 32, "causal", 0, 256),    # GQA 4, offset
    ("bfloat16", 1, 4, 1, 384, 384, 128, "full", 0, 0),      # tail (384)
    ("float32", 1, 4, 2, 384, 384, 32, "causal", 100, 0),    # tail + window
    ("bfloat16", 1, 4, 2, 256, 384, 96, "causal", 100, 128), # D 96 (64 + 32)
]


@pytest.mark.parametrize("dtype,b,h,kh,sq,sk,d,mode,window,q_offset",
                         FLASH_CASES)
def test_flash_attention_matches_jax(dtype, b, h, kh, sq, sk, d, mode,
                                     window, q_offset):
    (q, k, v), (tq, tk, tv) = inputs(
        b * 100 + sq, [(b, h, sq, d), (b, kh, sk, d), (b, kh, sk, d)], dtype)
    kw = dict(mode=mode, window=window, q_offset=q_offset)
    got = tfa.flash_attention(tq, tk, tv, **kw)
    assert got.dtype == TDT[dtype] and got.shape == (b, h, sq, d)
    # 128-row blocks, as test_kernels.py runs it: with the default 256-key
    # block, S = 384 leaves a tail block that interpret mode fills with NaN,
    # and the Pallas kernel's p @ v (p = 0 there) turns into NaN rows
    close(got, jfa.flash_attention(q, k, v, impl="interpret", block_q=128,
                                   block_k=128, **kw), dtype,
          "vs pallas interpret")
    close(got, jfa_ref.attention_reference(q, k, v, **kw), dtype, "vs ref")


@pytest.mark.parametrize("dtype,window", [("float32", 0),
                                          ("bfloat16", 32)])
def test_flash_attention_length_mode_matches_jax(dtype, window):
    b, h, kh, sk, d = 3, 4, 2, 256, 64
    (q, k, v), (tq, tk, tv) = inputs(
        7, [(b, h, 1, d), (b, kh, sk, d), (b, kh, sk, d)], dtype)
    lengths = np.asarray([1, 100, 256], np.int32)
    kw = dict(mode="length", window=window)
    got = tfa.flash_attention(tq, tk, tv, lengths=torch.from_numpy(lengths),
                              **kw)
    jl = jnp.asarray(lengths)
    close(got, jfa.flash_attention(q, k, v, lengths=jl, impl="interpret",
                                   **kw), dtype, "vs pallas interpret")
    close(got, jfa_ref.attention_reference(q, k, v, lengths=jl, **kw),
          dtype, "vs ref")


def test_flash_variant_table():
    for d in (64, 96, 128, 256):
        assert tfa.variant(torch.bfloat16, d) == "wgmma"
        assert tfa.variant(torch.float32, d) == "fma"
    assert tfa.variant(torch.bfloat16, 32) == tfa.variant(
        torch.float32, 32) == "fma"
    for dtype, d in ((torch.float16, 128), (torch.bfloat16, 48)):
        with pytest.raises(ValueError, match="no flash-attention kernel"):
            tfa.variant(dtype, d)


def test_flash_variant_table_is_pinned():
    # the whole table: every bf16 head dim but 32 on the tensor cores,
    # float32 (which TF32 would round past 2e-5) always on the CUDA cores
    assert tfa.VARIANTS == {
        (torch.bfloat16, 32): "fma", (torch.bfloat16, 64): "wgmma",
        (torch.bfloat16, 96): "wgmma", (torch.bfloat16, 128): "wgmma",
        (torch.bfloat16, 256): "wgmma",
        (torch.float32, 32): "fma", (torch.float32, 64): "fma",
        (torch.float32, 96): "fma", (torch.float32, 128): "fma",
        (torch.float32, 256): "fma"}


# The tensor-core kernel's arithmetic (P rounded to bf16 before P @ V, l
# from the float32 p, BK-key tiles) in bf16 on every case above: within
# bf16's tolerance of the Pallas kernel and of the oracle.
@pytest.mark.parametrize("b,h,kh,sq,sk,d,mode,window,q_offset",
                         [c[1:] for c in FLASH_CASES])
def test_tensor_core_arithmetic_matches_jax(b, h, kh, sq, sk, d, mode,
                                            window, q_offset):
    (q, k, v), (tq, tk, tv) = inputs(
        b * 100 + sq, [(b, h, sq, d), (b, kh, sk, d), (b, kh, sk, d)],
        "bfloat16")
    kw = dict(mode=mode, window=window, q_offset=q_offset)
    got = tfa_ref.tensor_core_emulation(tq, tk, tv, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == (b, h, sq, d)
    close(got, jfa.flash_attention(q, k, v, impl="interpret", block_q=128,
                                   block_k=128, **kw), "bfloat16",
          "vs pallas interpret")
    close(got, jfa_ref.attention_reference(q, k, v, **kw), "bfloat16",
          "vs ref")


@pytest.mark.parametrize("window", [0, 32])
def test_tensor_core_arithmetic_length_mode_matches_jax(window):
    b, h, kh, sk, d = 4, 4, 2, 256, 64
    (q, k, v), (tq, tk, tv) = inputs(
        7, [(b, h, 1, d), (b, kh, sk, d), (b, kh, sk, d)], "bfloat16")
    lengths = np.asarray([1, 100, 256, 0], np.int32)
    kw = dict(mode="length", window=window)
    got = tfa_ref.tensor_core_emulation(tq, tk, tv, block_k=64,
                                        lengths=torch.from_numpy(lengths),
                                        **kw)
    jl = jnp.asarray(lengths)
    want = jfa.flash_attention(q, k, v, lengths=jl, impl="interpret", **kw)
    close(got, want, "bfloat16", "vs pallas interpret")   # length 0 too
    assert torch.all(got[3] == 0)
    close(got[:3], jfa_ref.attention_reference(q, k, v, lengths=jl, **kw)[
        :3], "bfloat16", "vs ref")


# --- decode attention --------------------------------------------------------

@pytest.mark.parametrize("dtype,window,kpos_offset", [
    ("float32", 0, 0), ("float32", 48, 256), ("bfloat16", 0, 256),
    ("bfloat16", 200, 0)])
def test_decode_partial_matches_jax(dtype, window, kpos_offset):
    b, h, kh, s, d = 4, 8, 2, 512, 64
    (q, k, v), (tq, tk, tv) = inputs(
        11 + window, [(b, h, 1, d), (b, kh, s, d), (b, kh, s, d)], dtype)
    # global lengths: before, inside and past this shard's rows
    lengths = np.asarray([1, 300, 700, 768], np.int32)
    kw = dict(window=window, kpos_offset=kpos_offset)
    acc, m, l = tdec.decode_partial(tq, tk, tv, torch.from_numpy(lengths),
                                    **kw)
    ja, jm, jl = jdec.decode_partial(q, k, v, jnp.asarray(lengths),
                                     impl="interpret", **kw)
    for got, want, name in ((acc, ja, "acc"), (m, jm, "m"), (l, jl, "l")):
        assert got.dtype == torch.float32
        close(got, want, "float32" if dtype == "float32" else dtype, name)


def test_decode_shard_combine_equals_decode_reference():
    b, h, kh, s, d = 2, 4, 2, 1024, 64
    (q, k, v), (tq, tk, tv) = inputs(
        3, [(b, h, 1, d), (b, kh, s, d), (b, kh, s, d)], "float32")
    lengths = np.asarray([700, 1024], np.int32)
    tl = torch.from_numpy(lengths)
    want = jdec_ref.decode_reference(q, k, v, jnp.asarray(lengths))
    close(tdec.decode_attention(tq, tk, tv, tl), want, "float32", "whole")
    for n_shards in (2, 4, 8):
        w = s // n_shards
        parts = [tdec.decode_partial(tq, tk[:, :, i * w:(i + 1) * w],
                                     tv[:, :, i * w:(i + 1) * w], tl,
                                     kpos_offset=i * w)
                 for i in range(n_shards)]
        close(tdec.combine_partials(parts), want, "float32",
              f"{n_shards} shards")


def test_decode_idle_row_gives_zeros():
    """An idle serving slot (length 0): acc = 0, l = 0, m = -1e30, and the
    normalised output is 0, with no NaN."""
    _, (tq, tk, tv) = inputs(5, [(2, 4, 1, 32), (2, 2, 64, 32),
                                 (2, 2, 64, 32)], "float32")
    tl = torch.tensor([0, 17], dtype=torch.int32)
    acc, m, l = tdec.decode_partial(tq, tk, tv, tl)
    assert torch.all(acc[0] == 0) and torch.all(l[0] == 0)
    assert torch.all(m[0] == tdec_ref.NEG_INF)
    out = tdec.decode_attention(tq, tk, tv, tl)
    assert torch.isfinite(out).all() and torch.all(out[0] == 0)
    assert torch.all(l[1] > 0)
