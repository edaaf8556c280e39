"""Card-only tests: each hand-written CUDA kernel against its plain PyTorch
version on the same inputs (exact for the int32 kernels; the flash kernel
at test_kernels.py's tolerances, 2e-5 in float32 and 2e-2 in bfloat16; the
decode partial at 2e-5 in both types; the WKV6 and RG-LRU recurrences at
5e-5 in float32 and 5e-2 on bfloat16 outputs, their float32 final states
at 5e-5, and also against a float64 scan), the interpreter on the card
against the interpreter on the CPU (plain and under fault plans), the
chain kernel under kill faults against the interpreter, and fsck on the
card against fsck on the CPU.  They skip without a card.  On the card
(which has no JAX, so nothing here imports it):

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import faults, isa, machine, programs
from repro_torch.core.engine import ChainEngine
from repro_torch.kernels.chain_vm import ops as chain_ops
from repro_torch.kernels.chain_vm import ref as chain_ref
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.decode_attention import ref as dec_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.hopscotch import ops as hop_ops
from repro_torch.kernels.rglru import ops as rg_ops
from repro_torch.kernels.rglru import ref as rg_ref
from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.kernels.rwkv6 import ref as wkv_ref
from repro_torch.kvstore import fsck, hopscotch

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _images(seed, n, m, n_wrs):
    """Random single-WQ images at base 0 whose fields stray past both ends
    of the image; opcodes 0..15 (13 and up execute as HALT)."""
    rng = np.random.RandomState(seed)
    mems = rng.randint(-40, m + 40, size=(n, m)).astype(np.int32)
    for s in range(n_wrs):
        o = s * isa.WR_WORDS
        mems[:, o] = (rng.randint(0, 16, n) << 24) | rng.randint(0, 5, n)
        mems[:, o + 1] = rng.randint(0, 2, n)
        mems[:, o + 4] = rng.randint(-2, 20, n)
        mems[:, o + 5] = rng.randint(-2, 6, n)
    return mems


@pytest.mark.parametrize("managed", [True, False])
def test_run_managed_kernel_matches_plain(cuda, managed):
    n, m = 300, 1024
    rng = np.random.RandomState(1)
    mems = torch.from_numpy(_images(0, n, m, 8)).to(cuda)
    msgs = torch.from_numpy(rng.randint(-5, m + 40, (n, 4 * isa.MSG_WORDS))
                            .astype(np.int32)).to(cuda)
    inits = torch.from_numpy(np.stack([
        rng.randint(0, 3, n), rng.randint(0, 12, n), rng.randint(0, 12, n),
        rng.randint(0, 3, n), rng.randint(0, 2, n), rng.randint(0, 4, n),
        rng.randint(0, 40, n), rng.rand(n) < 0.1], 1).astype(np.int32)).to(
        cuda)
    kw = dict(wq_base=0, n_wrs=8, managed=managed, max_steps=48)
    before = chain_ops.launches["run_managed"]
    got = chain_ops.run_managed(mems, msgs, inits, **kw)
    want = chain_ref.managed_chain_loop(mems, msgs, inits, **kw)
    torch.cuda.synchronize()
    assert chain_ops.launches["run_managed"] == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("m", [16, 517, 4096])
def test_run_chains_kernel_matches_plain(cuda, m):
    mems = torch.from_numpy(_images(2, 257, m, 2 if m == 16 else 8)).to(cuda)
    n_wrs = 2 if m == 16 else 8
    got = chain_ops.run_chains(mems, wq_base=0, n_wrs=n_wrs, max_steps=30)
    want, _ = chain_ref.run_chain_reference(mems, 0, n_wrs, 30)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_chain_kernels_reject_bad_inputs(cuda):
    with pytest.raises(ValueError):
        chain_ops.run_chains(torch.zeros((2, 8), dtype=torch.int32,
                                         device=cuda), wq_base=0, n_wrs=1)
    with pytest.raises(ValueError):
        chain_ops.run_chains(torch.zeros((2, 64), dtype=torch.int64,
                                         device=cuda), wq_base=0, n_wrs=1)
    with pytest.raises(ValueError, match="n_wrs=0"):
        chain_ops.run_chains(torch.zeros((2, 64), dtype=torch.int32,
                                         device=cuda), wq_base=0, n_wrs=0)
    empty = torch.zeros((0, 64), dtype=torch.int32, device=cuda)
    assert chain_ops.run_chains(empty, wq_base=0, n_wrs=1).shape == (0, 64)


def test_hopscotch_kernel_matches_plain(cuda):
    n, v = 4096, 4
    rng = np.random.RandomState(3)
    t = hopscotch.make_table(n, v)
    keys = rng.choice(np.arange(1, 1 << 24), 2400, replace=False)
    for k in keys.tolist():
        t.insert(k, [k, -k, 2 ** 31 - 1, 2 ** 24 + k])
    # a key stored twice in one neighborhood: the first bucket wins
    h = hopscotch.bucket_of(77, n)
    t.keys[h], t.keys[(h + 3) % n] = 77, 77
    t.values[h], t.values[(h + 3) % n] = [1, 2, 3, 4], [5, 6, 7, 8]
    q = np.concatenate([rng.choice(keys, 3000), rng.randint(1 << 24, 1 << 25,
                                                            900), [0, 77]])
    dk, dv = t.as_device(cuda)
    qd = torch.from_numpy(q.astype(np.int32)).to(cuda)
    got = hop_ops.hopscotch_lookup(dk, dv, qd, 8)
    want = hopscotch.lookup(dk, dv, qd, 8)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[1][-1].tolist() == [1, 2, 3, 4] and not bool(got[0][-2])
    empty = hop_ops.hopscotch_lookup(dk, dv, qd[:0], 8)
    assert empty[1].shape == (0, v)


@pytest.mark.parametrize("h", [1, 8, 16, 32, 40])
@pytest.mark.parametrize("v", [1, 4, 16])
def test_hopscotch_kernel_neighborhoods_and_row_widths(cuda, h, v):
    """Neighborhoods that fill a group of 1 to 32 lanes or walk two
    32-bucket windows, rows of 1 to 16 words: exact against the plain
    lookup, with a neighborhood that wraps the table end, a key stored
    twice (the first bucket wins), key 0 and values at +-(2^31 - 1)."""
    n, big = 2048, 2 ** 31 - 1
    rng = np.random.RandomState(100 * h + v)
    t = hopscotch.make_table(n, v, neighborhood=h)
    keys = rng.choice(np.arange(1, 1 << 24), 800, replace=False)
    for k in keys.tolist():
        row = rng.randint(-big, big + 1, v, dtype=np.int64)
        row[0] = big if k % 2 else -big
        t.insert(k, row.tolist())
    # a key homed on the last bucket, stored in its neighborhood's last
    # bucket: past the table end for h > 1
    wrap = next(k for k in range(1 << 24, 1 << 25)
                if hopscotch.bucket_of(k, n) == n - 1)
    t.keys[(n + h - 2) % n], t.values[(n + h - 2) % n] = wrap, -big
    # key 77 twice, the second copy h // 2 buckets on (past it for h 1)
    b77 = hopscotch.bucket_of(77, n)
    t.keys[b77], t.values[b77] = 77, big
    t.keys[(b77 + max(1, h // 2)) % n] = 77
    t.values[(b77 + max(1, h // 2)) % n] = 5
    q = np.concatenate([rng.choice(keys, 1500), rng.randint(1 << 25, 1 << 26,
                                                            500),
                        [0, 77, wrap, 0]])
    dk, dv = t.as_device(cuda)
    qd = torch.from_numpy(q.astype(np.int32)).to(cuda)
    before = hop_ops.launches["hopscotch_lookup"]
    got = hop_ops.hopscotch_lookup(dk, dv, qd, h)
    want = hopscotch.lookup(dk, dv, qd, h)
    torch.cuda.synchronize()
    assert hop_ops.launches["hopscotch_lookup"] == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[0][-3:-1].tolist() == [True, True] and not bool(got[0][-1])
    assert got[1][-3].tolist() == [big] * v and got[1][-1].abs().sum() == 0
    assert int(got[0].sum()) > 1000          # most stored keys are hits


def test_interpreter_on_the_card_matches_the_cpu(cuda):
    spec = machine.MachineSpec(512, (0, 48, 96), (6, 6, 6), (0, 2, 1),
                               (False, True, True), 4)
    rng = np.random.RandomState(4)
    states = []
    for _ in range(16):
        img = _images(int(rng.randint(1 << 30)), 1, 512, 18)[0]
        st = machine.init_state(spec, img, rng.randint(0, 8, 3),
                                rng.randint(0, 8, 3), "cpu")
        st = machine.deliver(st, int(rng.randint(0, 3)),
                             rng.randint(-10, 600, 7))
        states.append(st)
    batch = machine.VMState(*(torch.stack(f) for f in zip(*states)))
    want = machine.run_batch(spec, batch, 200)
    got = machine.run_batch(
        spec, machine.VMState(*(a.to(cuda) for a in batch)), 200)
    for name, g, w in zip(machine.VMState._fields, got, want):
        assert torch.equal(g.cpu(), w), name


def test_faulted_interpreter_on_the_card_matches_the_cpu(cuda):
    """Random programs under random plans of all four fault kinds: the
    card's interpreter equals the CPU's on every field."""
    spec = machine.MachineSpec(512, (0, 48, 96), (6, 6, 6), (0, 2, 1),
                               (False, True, True), 4)
    rng = np.random.RandomState(6)
    states = []
    for _ in range(24):
        img = _images(int(rng.randint(1 << 30)), 1, 512, 18)[0]
        st = machine.init_state(spec, img, rng.randint(0, 8, 3),
                                rng.randint(0, 8, 3), "cpu")
        states.append(machine.deliver(st, int(rng.randint(0, 3)),
                                      rng.randint(-10, 600, 7)))
    batch = machine.VMState(*(torch.stack(f) for f in zip(*states)))
    rows = torch.from_numpy(np.stack(
        [rng.randint(-1, 12, 24), rng.randint(-1, 12, 24),
         rng.randint(-1, 3, 24), rng.randint(-1, 3, 24)], 1).astype(np.int32))
    want = machine.run_batch(spec, batch, 60, faults.FaultPlan.from_row(rows))
    got = machine.run_batch(
        spec, machine.VMState(*(a.to(cuda) for a in batch)), 60,
        faults.FaultPlan.from_row(rows.to(cuda)))
    for name, g, w in zip(machine.VMState._fields, got, want):
        assert torch.equal(g.cpu(), w), name


def test_kernel_backend_kill_rows_match_interp_on_the_card(cuda):
    """Per-context kill steps, every cut from 0 to the fuel, through the
    chain kernel: equal to the interpreter, and counted as launches."""
    srv = programs.build_recycled_get_server(n_buckets=64, val_len=2,
                                             mem_words=2048, device=cuda)
    for k in range(1, 41):
        srv.insert(k, [k * 11, k * 11 + 1])
    srv.load()
    pay = np.asarray([srv._payload(k) for k in (3, 17, 999)
                      for _ in range(33)], np.int32)
    plan = faults.FaultPlan.none((len(pay),), device=cuda)._replace(
        kill_step=torch.arange(33, dtype=torch.int32, device=cuda).repeat(3))
    before = chain_ops.launches["run_managed"]
    got = ChainEngine(srv.spec, "kernel").run_many(srv.state, srv.loop_wq,
                                                   pay, 32, plan)
    assert chain_ops.launches["run_managed"] == before + 1
    want = ChainEngine(srv.spec).run_many(srv.state, srv.loop_wq, pay, 32,
                                          plan)
    for f in ("mem", "head", "enable_limit", "completions", "msg_head",
              "halted", "responses", "steps"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_fsck_on_the_card_matches_the_cpu(cuda):
    """The tensor-op fsck on the card reports exactly what it reports on
    the CPU, and repairs alike."""
    rng = np.random.RandomState(3)
    keys = rng.randint(0, 1 << 20, (4, 4096)).astype(np.int32)
    keys[rng.rand(4, 4096) < 0.4] = 0
    vals = rng.randint(1, 99, (4, 4096, 2)).astype(np.int32)
    vals[rng.rand(4, 4096) < 0.01] = 0
    keys[:, 7::97] = keys[:, 3::97][:, :keys[:, 7::97].shape[1]]
    exp = np.where(rng.rand(4, 4096) < 0.01, 5, hopscotch.NO_TTL).astype(
        np.int32)
    args = [torch.from_numpy(a) for a in (keys, vals, exp)]
    want = fsck.check_invariants(args[0], args[1], neighborhood=8,
                                 exp=args[2])
    got = fsck.check_invariants(*(a.to(cuda) for a in args[:2]),
                                neighborhood=8, exp=args[2].to(cuda))
    assert got == want and len(want.violations) > 100
    rk, rv, re_, acts = fsck.repair(*(a.to(cuda) for a in args[:2]), got,
                                    neighborhood=8, exp=args[2].to(cuda))
    wk, wv, we, wacts = fsck.repair(*args[:2], want, neighborhood=8,
                                    exp=args[2])
    assert acts == wacts
    for g, w in ((rk, wk), (rv, wv), (re_, we)):
        assert torch.equal(g.cpu(), w)


# --- attention kernels -------------------------------------------------------

def _qkv(cuda, seed, dtype, b, h, kh, sq, sk, d):
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(dtype)
    return rnd(b, h, sq, d), rnd(b, kh, sk, d), rnd(b, kh, sk, d)


def _close(got, want, dtype, what):
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype], msg=what)


def _flash_checked(q, k, v, kind, **kw):
    """The wrapper's output, with its launch counted once in all and once
    under ``kind``'s kernel."""
    before = (fa_ops.launches["flash_attention"],
              fa_ops.launches[f"flash_attention.{kind}"])
    got = fa_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert (fa_ops.launches["flash_attention"],
            fa_ops.launches[f"flash_attention.{kind}"]) == (before[0] + 1,
                                                            before[1] + 1)
    assert got.dtype == q.dtype and got.shape == q.shape
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_flash_kernel_matches_plain(cuda, dtype, d):
    # tails: 200, 333, 130, 77 and 1,025 are not multiples of the 32- to
    # 128-row tiles; bf16 at D >= 64 takes the tensor-core kernel
    b, h, kh = 2, 4, 2
    kind = fa_ops.variant(dtype, d)
    assert kind == ("wgmma" if dtype == torch.bfloat16 and d >= 64
                    else "fma")
    lengths = torch.tensor([1, 150], dtype=torch.int32, device=cuda)
    cases = [  # (sq, sk, kwargs)
        (200, 200, dict(mode="causal")),
        (200, 200, dict(mode="causal", window=37)),
        (77, 333, dict(mode="causal", q_offset=256)),
        (77, 333, dict(mode="causal", window=64, q_offset=200)),
        (3, 200, dict(mode="length", lengths=lengths)),
        (3, 200, dict(mode="length", lengths=lengths, window=50)),
        (130, 333, dict(mode="full")),
        (1025, 1025, dict(mode="causal")),
        (191, 129, dict(mode="full")),
    ]
    for i, (sq, sk, kw) in enumerate(cases):
        q, k, v = _qkv(cuda, i, dtype, b, h, kh, sq, sk, d)
        got = _flash_checked(q, k, v, kind, **kw)
        want = fa_ref.attention_reference(q, k, v, **kw)
        _close(got, want, dtype, f"{kw}")


def test_flash_kernel_gqa_groups_and_scale(cuda):
    for kh in (1, 2, 4):
        q, k, v = _qkv(cuda, kh, torch.bfloat16, 1, 8, kh, 160, 160, 128)
        got = fa_ops.flash_attention(q, k, v, scale=0.05)
        want = fa_ref.attention_reference(q, k, v, scale=0.05)
        _close(got, want, torch.bfloat16, f"KH={kh}")


@pytest.mark.parametrize("kh", [16, 8, 1])
def test_flash_tensor_core_gqa_groups_at_head_dim_256(cuda, kh):
    # GQA groups 1, 2 and 16 (recurrentgemma-9b's) over 16 query heads,
    # windowed as its local layers are, on ragged lengths
    for i, (sq, sk, kw) in enumerate((
            (300, 300, dict(mode="causal", window=100)),
            (65, 321, dict(mode="causal", q_offset=256)),
            (130, 190, dict(mode="full")))):
        q, k, v = _qkv(cuda, 10 * kh + i, torch.bfloat16, 2, 16, kh, sq, sk,
                       256)
        got = _flash_checked(q, k, v, "wgmma", **kw)
        want = fa_ref.attention_reference(q, k, v, **kw)
        _close(got, want, torch.bfloat16, f"KH={kh} {kw}")


@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_tensor_core_empty_row_gives_zeros(cuda, d):
    # length 0 sees no key: exactly 0 (the reference's uniform row over the
    # -1e30 logits is not the kernel's function there); the others as plain
    lengths = torch.tensor([0, 77, 200], dtype=torch.int32, device=cuda)
    for window in (0, 50):
        q, k, v = _qkv(cuda, d + window, torch.bfloat16, 3, 4, 2, 5, 200, d)
        kw = dict(mode="length", lengths=lengths, window=window)
        got = _flash_checked(q, k, v, "wgmma", **kw)
        assert torch.isfinite(got).all() and torch.all(got[0] == 0)
        want = fa_ref.attention_reference(q, k, v, **kw)
        _close(got[1:], want[1:], torch.bfloat16, f"window={window}")


def _decode_checked(q, k, v, lengths, **kw):
    """The wrapper's partial, with one launch of each kernel of the pair
    (and one call) counted; every part float32."""
    before = dict(dec_ops.launches)
    got = dec_ops.decode_partial(q, k, v, lengths, **kw)
    torch.cuda.synchronize()
    assert {n: c - before[n] for n, c in dec_ops.launches.items()} == {
        "decode_partial": 1, "decode_partial.split": 1,
        "decode_partial.combine": 1}
    assert all(g.dtype == torch.float32 for g in got)
    return got


def _decode_close(got, want, what):
    # both sides read the same inputs and accumulate in float32, so bf16 is
    # held at the float32 limit too
    for g, w, name in zip(got, want, ("acc", "m", "l")):
        _close(g, w, torch.float32, f"{what} {name}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_decode_kernel_matches_plain(cuda, dtype, d):
    b, s = 5, 700
    # an idle row (0), rows before, inside and past the shard at offset 128
    lengths = torch.tensor([0, 1, 129, 600, 828], dtype=torch.int32,
                           device=cuda)
    # G 1, 2, 4, 3, 16, and 20 (two blocks of query heads per KV head)
    for h, kh in ((8, 8), (8, 4), (8, 2), (12, 4), (16, 1), (20, 1)):
        q, k, v = _qkv(cuda, h + kh, dtype, b, h, kh, 1, s, d)
        for kw in (dict(), dict(window=100), dict(kpos_offset=128),
                   dict(window=300, kpos_offset=128)):
            got = _decode_checked(q, k, v, lengths, **kw)
            want = dec_ref.decode_partial_reference(q, k, v, lengths, **kw)
            _decode_close(got, want, f"H={h} KH={kh} {kw}")
            acc, m, l = got
            if not kw:      # the idle row: zeros, -1e30, no NaN
                assert torch.all(acc[0] == 0) and torch.all(l[0] == 0)
                assert torch.all(m[0] == dec_ref.NEG_INF)
                out = dec_ops.decode_attention(q, k, v, lengths)
                assert torch.isfinite(out).all() and torch.all(out[0] == 0)
    # a cache of many splits: an idle row, a length on a split boundary,
    # one just past and one just short of one, the whole cache; windows and
    # shard offsets that cross split boundaries
    s = 5000
    for h, kh in ((8, 2), (16, 1)):
        rows, n_split = dec_ops.plan_splits(b, kh, s)
        assert n_split > 8
        lengths = torch.tensor([0, rows, 2 * rows + 1, 3 * rows - 1, s],
                               dtype=torch.int32, device=cuda)
        q, k, v = _qkv(cuda, h, dtype, b, h, kh, 1, s, d)
        for kw in (dict(), dict(window=rows + 7), dict(kpos_offset=rows),
                   dict(window=2 * rows, kpos_offset=rows // 2 + 3),
                   dict(window=s + 100)):
            got = _decode_checked(q, k, v, lengths, **kw)
            want = dec_ref.decode_partial_reference(q, k, v, lengths, **kw)
            _decode_close(got, want, f"S={s} H={h} KH={kh} {kw}")
            assert torch.all(got[0][0] == 0) and torch.all(got[2][0] == 0)
    if d == 256:
        # recurrentgemma-9b's decode: 16 query heads on one KV head, window
        # 2,048 over a 4,096-row cache, lengths past the window
        lengths = torch.tensor([2049, 2056, 3001, 4096], dtype=torch.int32,
                               device=cuda)
        q, k, v = _qkv(cuda, 16, dtype, 4, 16, 1, 1, 4096, d)
        got = _decode_checked(q, k, v, lengths, window=2048)
        want = dec_ref.decode_partial_reference(q, k, v, lengths,
                                                window=2048)
        _decode_close(got, want, "griffin decode shape")


def test_decode_shards_combine_on_the_card(cuda):
    q, k, v = _qkv(cuda, 9, torch.float32, 3, 8, 2, 1, 1024, 128)
    lengths = torch.tensor([1, 700, 1024], dtype=torch.int32, device=cuda)
    want = dec_ref.decode_reference(q, k, v, lengths)
    for n in (2, 4, 8):
        w = 1024 // n
        parts = [dec_ops.decode_partial(q, k[:, :, i * w:(i + 1) * w],
                                        v[:, :, i * w:(i + 1) * w], lengths,
                                        kpos_offset=i * w) for i in range(n)]
        _close(dec_ops.combine_partials(parts), want, torch.float32, f"{n}")


def test_attention_kernels_reject_and_raise(cuda):
    q, k, v = _qkv(cuda, 0, torch.float32, 1, 2, 1, 4, 4, 48)
    with pytest.raises(ValueError, match="head dim 48"):
        fa_ops.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="head dim 48"):
        dec_ops.decode_partial(q[:, :, :1], k, v,
                               torch.ones(1, dtype=torch.int32, device=cuda))
    q, k, v = _qkv(cuda, 0, torch.float16, 1, 2, 1, 4, 4, 32)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa_ops.flash_attention(q, k, v)
    # a launch the card refuses (a grid dimension past 65,535) raises, and
    # is not counted: there is no fallback to the plain version
    q, k, v = _qkv(cuda, 0, torch.float32, 65536, 1, 1, 1, 1, 32)
    lengths = torch.ones(65536, dtype=torch.int32, device=cuda)
    before = (fa_ops.launches["flash_attention"], dict(dec_ops.launches))
    with pytest.raises(RuntimeError, match="flash_attention launch failed"):
        fa_ops.flash_attention(q, k, v)
    with pytest.raises(RuntimeError, match="decode_partial launch failed"):
        dec_ops.decode_partial(q, k, v, lengths)
    assert (fa_ops.launches["flash_attention"],
            dict(dec_ops.launches)) == before


# --- recurrences -------------------------------------------------------------

REC_TOL = {torch.float32: 5e-5, torch.bfloat16: 5e-2}   # test_kernels.py's
STATE_TOL = 5e-5          # float32 final states, in either input type


def _close_rec(got, want, tol, what):
    torch.testing.assert_close(got.double(), want.double(), atol=tol,
                               rtol=tol, msg=what)


def _wkv_inputs(cuda, seed, dtype, b, h, t, n, w_lo):
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=cuda)
    r, k, v = (rnd(b, h, t, n).to(dtype) for _ in range(3))
    w = w_lo + (0.999 - w_lo) * torch.rand((b, h, t, n), generator=gen,
                                           device=cuda)
    u = 0.3 * rnd(h, n)
    return r, k, v, w, u


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [32, 64])
def test_wkv6_kernel_matches_scans(cuda, dtype, n):
    # decays down to 0.01: far below the chunked form's range (w > ~0.115);
    # T 31, 33 and 65 end in a part of the kernel's 32-step chunk
    for i, (b, h, t) in enumerate(((1, 1, 1), (2, 3, 33), (1, 1, 2048),
                                   (2, 2, 2048), (2, 3, 31), (1, 2, 65))):
        r, k, v, w, u = _wkv_inputs(cuda, i, dtype, b, h, t, n, 0.01)
        before = wkv_ops.launches["wkv6"]
        o, s = wkv_ops.wkv6(r, k, v, w, u)
        torch.cuda.synchronize()
        assert wkv_ops.launches["wkv6"] == before + 1
        assert o.dtype == dtype and o.shape == v.shape
        assert s.dtype == torch.float32 and s.shape == (b, h, n, n)
        po, ps = wkv_ref.wkv6_reference(r, k, v, w, u)
        _close_rec(o, po, REC_TOL[dtype], f"o vs plain, T={t}")
        _close_rec(s, ps, STATE_TOL, f"S vs plain, T={t}")
        do, ds = wkv_ref.wkv6_reference(*(x.double() for x in (r, k, v, w,
                                                               u)))
        _close_rec(o, do, REC_TOL[dtype], f"o vs float64, T={t}")
        _close_rec(s, ds, STATE_TOL, f"S vs float64, T={t}")


def _rglru_case(cuda, seed, dtype, b, t, d):
    """The RG-LRU kernel on seeded a in [0.5, 1) and u: (a, u, h, final h),
    after checking that it launched the kernel ``variant`` picks."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    a = (0.5 + 0.5 * torch.rand((b, t, d), generator=gen,
                                device=cuda)).to(dtype)
    u = torch.randn((b, t, d), generator=gen, device=cuda).to(dtype)
    kind = rg_ops.variant(dtype, d)
    before = dict(rg_ops.launches)
    h, h_last = rg_ops.rglru(a, u)
    torch.cuda.synchronize()
    assert rg_ops.launches["rglru"] == before["rglru"] + 1
    assert {v: rg_ops.launches[f"rglru.{v}"] - before[f"rglru.{v}"]
            for v in ("ring", "direct")} == {
        v: int(v == kind) for v in ("ring", "direct")}
    return a, u, h, h_last


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_kernel_matches_scans(cuda, dtype):
    for i, (b, t, d) in enumerate(((1, 1, 1), (3, 1, 7), (2, 37, 4099),
                                   (4, 300, 130))):
        a, u, h, h_last = _rglru_case(cuda, i, dtype, b, t, d)
        assert h.dtype == dtype and h.shape == a.shape
        assert h_last.dtype == torch.float32 and h_last.shape == (b, d)
        ph, plast = rg_ref.rglru_reference(a, u)
        if dtype == torch.float32:
            # the kernel rounds each multiply and add as the scan does
            assert torch.equal(h, ph) and torch.equal(h_last, plast)
        _close_rec(h, ph, REC_TOL[dtype], f"h vs plain, {(b, t, d)}")
        _close_rec(h_last, plast, STATE_TOL, f"final h, {(b, t, d)}")
        dh, dlast = rg_ref.rglru_reference(a.double(), u.double())
        _close_rec(h, dh, REC_TOL[dtype], f"h vs float64, {(b, t, d)}")
        _close_rec(h_last, dlast, STATE_TOL, f"final vs float64, {(b, t, d)}")


# the ring kernel's shapes: the recurrentgemma-9b prefill; a T shorter
# than its 32-step chunk on one tile; a T that ends in a part of a chunk at
# a D that ends in a part of a 64-channel tile (bf16: not whole 16-byte
# rows, the direct kernel); T 1 on a tile of 8 channels
RING_SHAPES = ((4, 2048, 4096), (1, 31, 64), (2, 97, 4100), (3, 1, 8))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", RING_SHAPES)
def test_rglru_ring_kernel_matches_scan(cuda, dtype, shape):
    a, u, h, h_last = _rglru_case(cuda, sum(shape), dtype, *shape)
    assert rg_ops.variant(dtype, shape[2]) == (
        "direct" if (dtype, shape[2]) == (torch.bfloat16, 4100) else "ring")
    assert h.dtype == dtype and h.shape == a.shape
    ph, plast = rg_ref.rglru_reference(a, u)
    if dtype == torch.float32:
        assert torch.equal(h, ph) and torch.equal(h_last, plast)
    _close_rec(h, ph, REC_TOL[dtype], f"h vs plain, {shape}")
    _close_rec(h_last, plast, STATE_TOL, f"final h, {shape}")


def test_recurrence_kernels_refuse_bad_inputs(cuda):
    r, k, v, w, u = _wkv_inputs(cuda, 0, torch.float32, 1, 2, 8, 32, 0.5)
    before = (wkv_ops.launches["wkv6"], rg_ops.launches["rglru"])
    with pytest.raises(ValueError, match="float32 w and u"):
        wkv_ops.wkv6(r, k, v, w.bfloat16(), u)
    with pytest.raises(ValueError, match="one type"):
        wkv_ops.wkv6(r, k.bfloat16(), v, w, u)
    with pytest.raises(ValueError, match="head dim 48"):
        wkv_ops.wkv6(*_wkv_inputs(cuda, 0, torch.float32, 1, 2, 8, 48, 0.5))
    with pytest.raises(ValueError, match="M = N"):
        wkv_ops.wkv6(r, k, v[..., :16], w, u)
    a = torch.rand((2, 5, 9), device=cuda)
    with pytest.raises(ValueError, match="one type"):
        rg_ops.rglru(a, a.double())
    with pytest.raises(ValueError, match=r"\(B, T, D\)"):
        rg_ops.rglru(a, a[:, :4])
    with pytest.raises(ValueError, match="CUDA tensors"):
        rg_ops.rglru(a.to("meta"), a.to("meta"))
    # no launch was made or counted
    assert (wkv_ops.launches["wkv6"], rg_ops.launches["rglru"]) == before
