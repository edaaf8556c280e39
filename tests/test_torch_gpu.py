"""Card-only tests: each hand-written CUDA kernel against its plain PyTorch
version on the same inputs (exact for the int32 kernels; the flash kernel
at test_kernels.py's tolerances, 2e-5 in float32 and 2e-2 in bfloat16; the
decode partial at 2e-5 in both types; the WKV6 and RG-LRU recurrences at
5e-5 in float32 and 5e-2 on bfloat16 outputs, their float32 final states
at 5e-5, and also against a float64 scan), the interpreter on the card
against the interpreter on the CPU (plain and under fault plans), the
interpreter kernel against its plain loop on the card (the hazard corpus
of ``_interp_images.py``, fault rows, schedules, machines of up to 1,024
WQs, full batches in global memory, split batches staged in shared
memory and the raise on a changed window word, split GETs of both
server builds;
all 14 fields bit-equal, clocks included), the walk kernel against its
plain walk and the rows route (every write-side program, fault rows,
1-4 owners; no host read; no ptxas spill) and the store's write stages
on the card against the CPU, the
chain kernel under kill faults against the interpreter, fsck on the
card against fsck on the CPU, and the scheduled interpreter (a batch of
cut schedules, the racing-writer SET) on the card against the CPU.  They
skip without a card.  On the card
(which has no JAX, so nothing here imports it):

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import math
import re

import numpy as np
import pytest
import torch

import _chain_images as hazards
import _interp_images as interp_images
import _walk_corpus as walk_corpus
from repro_torch import convert
from repro_torch.core import faults, isa, machine, programs, turing
from repro_torch.core.engine import ChainEngine
from repro_torch.kernels import _build
from repro_torch.kernels.chain_interp import ops as interp_ops
from repro_torch.kernels.chain_interp import ref as walk_ref
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
from repro_torch.kvstore import cuckoo, fsck, hopscotch, store
from repro_torch.rdma import transport

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


# run_managed's routes (csrc/chain_vm.cu): an image of up to WHOLE_WORDS
# words is staged whole in shared memory, a larger one stages its ring and
# logs the words its chain writes outside it while copy warps copy the image
WHOLE_WORDS = 16384


def _managed_equal(cuda, mems, msgs, inits, **kw):
    """run_managed against managed_chain_loop on the card: one launch, mem
    and stats bit for bit."""
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
            for a in (mems, msgs, inits)]
    before = chain_ops.launches["run_managed"]
    got = chain_ops.run_managed(*args, **kw)
    want = chain_ref.managed_chain_loop(*args, **kw)
    torch.cuda.synchronize()
    assert chain_ops.launches["run_managed"] == before + 1
    bad = (got[0] != want[0]).nonzero()[:8].tolist()
    assert not bad, f"words differ at (row, word) {bad}"
    assert torch.equal(got[1], want[1]), (got[1], want[1])
    return want


def _random_managed(seed, n, m, wq_base, n_wrs):
    """n random managed contexts of m words with the ring at wq_base; fields
    stray past both ends of the image and into the ring."""
    rng = np.random.RandomState(seed)
    mems = rng.randint(-40, m + 40, size=(n, m)).astype(np.int32)
    lo, hi = wq_base - 24, wq_base + 8 * n_wrs + 24
    for s in range(n_wrs):
        o = wq_base + s * isa.WR_WORDS
        mems[:, o] = (rng.randint(0, 16, n) << 24) | rng.randint(0, 5, n)
        mems[:, o + 1] = rng.randint(0, 2, n)
        near = rng.rand(n, 3) < 0.5            # src, dst, aux near the ring
        mems[:, o + 2:o + 4] = np.where(
            near[:, :2], rng.randint(lo, hi, (n, 2)), mems[:, o + 2:o + 4])
        mems[:, o + 4] = rng.randint(-2, 20, n)
        mems[:, o + 5] = rng.randint(-2, 6, n)
        mems[:, o + 7] = np.where(near[:, 2], rng.randint(lo, hi, n),
                                  mems[:, o + 7])
    msgs = rng.randint(-5, m + 40, (n, 4 * isa.MSG_WORDS)).astype(np.int32)
    inits = np.stack([
        rng.randint(0, 3, n), rng.randint(0, 40, n), rng.randint(0, 40, n),
        rng.randint(0, 3, n), rng.randint(0, 2, n), rng.randint(0, 4, n),
        rng.randint(0, 48, n), rng.rand(n) < 0.1], 1).astype(np.int32)
    return mems, msgs, inits


@pytest.mark.parametrize("m", [WHOLE_WORDS - 1, WHOLE_WORDS,
                               WHOLE_WORDS + 1])
def test_run_managed_kernel_at_the_whole_image_budget(cuda, m):
    """Images one word under, at and over the shared-memory budget: the
    whole-image route twice, then the ring-and-log route."""
    for managed in (True, False):
        _managed_equal(cuda, *_random_managed(m, 96, m, 0, 8), wq_base=0,
                       n_wrs=8, managed=managed, max_steps=48)


@pytest.mark.parametrize("m,wq_base", [(20000, 20000 - 64), (20000, 7001),
                                       (4112, 4112 - 64)])
def test_run_managed_kernel_ring_at_the_image_end(cuda, m, wq_base):
    """A ring away from word 0, once ending at the image's last word (in
    both routes), once at an odd base: fields that reach around it."""
    _managed_equal(cuda, *_random_managed(m + wq_base, 128, m, wq_base, 8),
                   wq_base=wq_base, n_wrs=8, managed=True, max_steps=48)


def test_run_managed_kernel_long_walks(cuda):
    """Rings without HALT, RECV or WAIT that run to their fuel or enable
    limit (up to 700 steps) unless a write makes one."""
    n, m = 64, 1024
    mems, msgs, inits = _random_managed(5, n, m, 0, 8)
    rng = np.random.RandomState(6)
    ops = np.asarray([0, 1, 2, 3, 4, 6, 7, 8, 9, 11])
    for s in range(8):
        mems[:, 8 * s] = (rng.choice(ops, n) << 24) | rng.randint(0, 5, n)
        mems[:, 8 * s + 5] = rng.randint(-2, 700, n)     # ENABLE limits
    inits[:, 1] = 700
    inits[:, 2] = rng.randint(0, 700, n)
    inits[:, 6] = rng.randint(200, 700, n)
    want = _managed_equal(cuda, mems, msgs, inits, wq_base=0, n_wrs=8,
                          managed=True, max_steps=700)
    steps = (want[1][:, 0].cpu() - torch.from_numpy(inits[:, 0])).numpy()
    assert (steps > 256).sum() >= n // 4, steps


def test_run_managed_kernel_on_addleq_guests(cuda):
    """A batch of 4,112-word ADDLEQ interpreter images (the chain_programs
    drive's shape), one guest looping until its fuel runs out."""
    interp = turing.build_interpreter(device="cpu")
    d, i0 = interp.data_base, interp.instr_base
    guests = [turing.guest_countdown(interp, c) for c in (1, 5, 12)]
    guests += [turing.guest_add(interp, 17, 25),
               turing.guest_multiply(interp, 7, 6),
               turing.guest_multiply(interp, 3, 0),
               turing.AddleqProgram([(d, d + 1, i0)], {d: 0, d + 1: 0})]
    st = [interp.load(g) for g in guests]
    batch = machine.VMState(*(torch.stack(f) for f in zip(*st)))
    n, cap = batch.mem.shape[0], batch.msg_buf.shape[2]
    max_steps = interp.lap_words * 30
    inits = torch.stack(
        [batch.head[:, 0], batch.tail[:, 0], batch.enable_limit[:, 0],
         batch.completions[:, 0], batch.msg_head[:, 0], batch.msg_tail[:, 0],
         torch.full((n,), max_steps, dtype=torch.int32),
         batch.halted.to(torch.int32)], 1)
    msgs = batch.msg_buf[:, 0].reshape(n, cap * isa.MSG_WORDS)
    assert batch.mem.shape[1] == 4112
    spec = interp.spec
    want = _managed_equal(cuda, batch.mem.numpy(), msgs.numpy(),
                          inits.numpy(), wq_base=spec.wq_bases[0],
                          n_wrs=spec.wq_sizes[0], managed=True,
                          max_steps=max_steps)
    stats = want[1].cpu()
    assert int(stats[-1, 0] - inits[-1, 0]) == max_steps   # the loop guest
    assert int(stats[:-1, 4].sum()) == n - 1                # the rest halt


@pytest.mark.parametrize("m,wq_base", [(512, 0), (512, 448), (20000, 0),
                                       (20000, 19936), (20000, 5000)])
def test_run_managed_kernel_on_hazard_images(cuda, m, wq_base):
    """RECV scatters that rewrite their own table or store twice to one
    word, tables clamped at the image's end or inside the ring, copies
    across the ring's edges and the image's end (tests/_chain_images.py),
    in both routes."""
    cases = {**hazards.recv_cases(m, wq_base),
             **hazards.copy_cases(m, wq_base)}
    for name, (mems, msgs, inits, kw) in sorted(cases.items()):
        _managed_equal(cuda, mems, msgs, inits, **kw)


def test_run_managed_kernel_past_its_write_log(cuda):
    """A chain that writes 0, 320, 640 and 1,280 distinct words outside its
    ring (the log holds 512): the walker waits for the copy warps at a
    named barrier and writes the rest straight to the output, reading them
    back from there."""
    (mems, msgs, inits, kw), = hazards.overflow_case(20000).values()
    _managed_equal(cuda, mems, msgs, inits, **kw)


def test_chase_probe_reads_latencies(cuda):
    """The latency probe: a shared-memory load beats an L2 hit, both take
    more than a cycle and less than a microsecond."""
    smem = chain_ops.chase_cycles("shared", cuda)
    l2 = chain_ops.chase_cycles("l2", cuda)
    assert 1 < smem < l2 < 2000, (smem, l2)


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


def _same_states(a, b, what=""):
    """Every VMState field bit-equal (clocks as their bits)."""
    for name, x, y in zip(machine.VMState._fields, a, b):
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x.cpu(), y.cpu()), (what, name)


def _plain_run(spec, s, max_steps, **kw):
    """The interpreter kernel's plain version on a copy of ``s``."""
    return machine.plain_run(spec, machine.VMState(*(a.clone() for a in s)),
                             max_steps, **kw)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_interp_kernel_matches_the_plain_loop(cuda, seed):
    """The hazard corpus, plain (at two fuels), under fault rows of all
    four kinds and under two-writer plans (one a row and one for all):
    one launch each, every field bit-equal to the plain loop's."""
    spec = convert.spec_from_tuple(interp_images.SPEC)
    s = convert.vmstate_from_numpy(interp_images.corpus(seed), cuda)
    b, steps = s.mem.shape[0], interp_images.MAX_STEPS
    for fuel in (steps, 4096):
        before = interp_ops.launches["run_interp"]
        got = machine.run_batch(spec, s, fuel)
        assert interp_ops.launches["run_interp"] == before + 1
        _same_states(got, _plain_run(spec, s, fuel), f"fuel {fuel}")
    plan = faults.FaultPlan.from_row(torch.from_numpy(
        interp_images.fault_rows(seed + 10, b)).to(cuda))
    _same_states(machine.run_batch(spec, s, steps, plan),
                 _plain_run(spec, s, steps, faults=plan), "faults")
    quota = torch.from_numpy(interp_images.quotas(seed, b)).to(cuda)
    for q in (quota, quota[0]):
        got = machine.run_scheduled(spec, s, machine.Schedule(q),
                                    interp_images.SLICES, steps)
        _same_states(got, _plain_run(
            spec, s, steps, quota=q.expand(b, -1, -1),
            writer_slices=interp_images.SLICES), f"schedule {q.ndim}")


def _wide_batch(seed, n_wq, b, size=4):
    """``b`` machines of ``n_wq`` WQs of random WRs (several warps of the
    kernel's block): random orderings and managed WQs, opcodes up to 255
    (HALT rare), fields past both ends, messages and clocks."""
    rng = np.random.RandomState(seed)
    words = n_wq * size * isa.WR_WORDS
    spec = machine.MachineSpec(
        words + 256, tuple(range(0, words, size * isa.WR_WORDS)),
        (size,) * n_wq, tuple(rng.randint(0, 3, n_wq).tolist()),
        tuple(bool(x) for x in rng.rand(n_wq) < 0.3), 4)
    length = spec.mem_words + machine.GUARD_WORDS
    states = []
    for _ in range(b):
        img = rng.randint(-20, length + 20, spec.mem_words).astype(np.int32)
        wrs = img[:words].reshape(-1, isa.WR_WORDS)
        # HALT rarely, so that runs are long
        ops = np.where(rng.rand(len(wrs)) < 0.98, rng.randint(0, 12, len(wrs)),
                       rng.randint(12, 256, len(wrs)))
        wrs[:, 0] = (ops.astype(np.uint32) << 24).view(np.int32) \
            | rng.randint(0, 4, len(wrs))
        wrs[:, 1] = rng.rand(len(wrs)) < 0.2
        wrs[:, 4] = rng.randint(-2, 19, len(wrs))
        wrs[:, 5] = rng.randint(-3, 8, len(wrs))
        wrs[:, 6] = rng.randint(-2, n_wq + 2, len(wrs))
        st = machine.init_state(spec, img, rng.randint(0, 9, n_wq),
                                rng.randint(0, 9, n_wq), "cpu")
        for _ in range(rng.randint(0, 6)):
            st = machine.deliver(st, int(rng.randint(0, n_wq)),
                                 rng.randint(-10, length, rng.randint(1, 17)))
        states.append(st._replace(clock=torch.from_numpy(
            rng.choice([0.0, 0.5, 1.21], n_wq).astype(np.float32))))
    return spec, machine.VMState(*(torch.stack(f) for f in zip(*states)))


@pytest.mark.parametrize("n_wq", [33, 70, 263, 1024])
def test_interp_kernel_on_wide_machines(cuda, n_wq):
    """Blocks of several warps (the argmin across warps through shared
    memory): plain, under faults and under a three-writer plan with a
    negative slice bound, bit-equal to the plain loop."""
    spec, s = _wide_batch(n_wq, n_wq, 4)
    s = machine.VMState(*(a.to(cuda) for a in s))
    b = s.mem.shape[0]
    _same_states(machine.run_batch(spec, s, 300), _plain_run(spec, s, 300))
    rows = torch.tensor([[5, 3, 0, 1], [-1, 7, 1, -1], [40, -1, -1, 0],
                         [-1, -1, 2, 2]], dtype=torch.int32, device=cuda)
    plan = faults.FaultPlan.from_row(rows[:b])
    _same_states(machine.run_batch(spec, s, 300, plan),
                 _plain_run(spec, s, 300, faults=plan))
    quota = torch.from_numpy(np.random.RandomState(n_wq).choice(
        [-1, 0, 1, 3, 7], (b, 3, 3)).astype(np.int32)).to(cuda)
    slices = ((0, n_wq // 3), (n_wq // 3, -5), (-5, n_wq))
    _same_states(machine.run_scheduled(spec, s, machine.Schedule(quota),
                                       slices, 300),
                 _plain_run(spec, s, 300, quota=quota, writer_slices=slices))


def test_interp_kernel_runs_a_batch_with_no_host_read(cuda):
    """One launch, and no device-to-host read inside the run (a
    synchronising call raises under the sync debug mode)."""
    spec = convert.spec_from_tuple(interp_images.SPEC)
    s = convert.vmstate_from_numpy(interp_images.corpus(3), cuda)
    want = machine.run_batch(spec, s, 4096)        # builds, caches tables
    x = machine.VMState(*(a.clone() for a in s))
    torch.cuda.synchronize()
    before = interp_ops.launches["run_interp"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        machine.run_batch_in_place(spec, x, 4096)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert interp_ops.launches["run_interp"] == before + 1
    _same_states(x, want)


def test_interp_kernel_refuses_what_it_cannot_take(cuda):
    spec, s = _wide_batch(0, 1025, 1, size=1)
    s = machine.VMState(*(a.to(cuda) for a in s))
    with pytest.raises(ValueError, match="1025 WQs"):
        machine.run_batch(spec, s, 10)
    spec = convert.spec_from_tuple(interp_images.SPEC)
    s = convert.vmstate_from_numpy(interp_images.corpus(0), cuda)
    with pytest.raises(ValueError, match="dtype"):
        interp_ops.run_interp(spec, s._replace(clock=s.clock.double()))


def _split_on(device, machines, per):
    """``machines`` (``_interp_images`` dicts), each ``per`` times, as a
    split batch over :data:`interp_images.WINDOW` on ``device``."""
    full = convert.vmstate_from_numpy(
        interp_images.stack(interp_images.repeat(machines, per)), device)
    return machine.split(full, interp_images.WINDOW, per)


def _clone_split(b):
    return machine.SharedBatch(machine.VMState(*(a.clone() for a in b.state)),
                               b.base.clone(), b.lo, b.hi)


@pytest.mark.parametrize("max_steps", [interp_images.MAX_STEPS, 7, 4096])
def test_interp_kernel_split_matches_the_plain_loop(cuda, max_steps):
    """Split batches (the window machines of two seeds, two a base image)
    staged in shared memory: one launch each, the private words and every
    other field bit-equal to the plain loop over the materialized batch,
    plain and under fault rows; no store changed a window word, so
    nothing raises; the base images are untouched."""
    spec = convert.spec_from_tuple(interp_images.SPEC)
    for machines in (interp_images.window_machines(0),
                     interp_images.window_machines(1)):
        b = _split_on(cuda, machines, 2)
        base = b.base.clone()
        want = machine.plain_run(spec, machine.materialize(_clone_split(b)),
                                 max_steps)
        before = interp_ops.launches["run_interp"]
        machine.run_batch_shared_in_place(spec, b, max_steps)
        assert interp_ops.launches["run_interp"] == before + 1
        _same_states(machine.materialize(b), want, f"fuel {max_steps}")
        assert torch.equal(b.base, base)
        plan = faults.FaultPlan.from_row(torch.from_numpy(
            interp_images.fault_rows(max_steps, b.state.mem.shape[0])).to(
                cuda))
        b = _split_on(cuda, machines, 2)
        want = machine.plain_run(spec, machine.materialize(_clone_split(b)),
                                 max_steps, plan)
        machine.run_batch_shared_in_place(spec, b, max_steps, plan)
        _same_states(machine.materialize(b), want, "faults")


def test_interp_kernel_refuses_a_changed_window_word(cuda):
    """Each store that would change a window word (a return-old store, a
    RECV scatter, a straddling copy, a swapping CAS, a change a later
    store takes back) raises on the card, as on the CPU, naming the rows;
    mixed into the window machines, only its own rows are named."""
    spec = convert.spec_from_tuple(interp_images.SPEC)
    good = interp_images.window_machines(0)
    for i, bad in enumerate(interp_images.window_raisers(0)):
        for device in (cuda, "cpu"):
            b = _split_on(device, [bad], 2)
            with pytest.raises(ValueError, match=r"rows \[0, 1\]"):
                machine.run_batch_shared_in_place(spec, b, 4096)
            b = _split_on(device, good + [bad], 1)
            with pytest.raises(ValueError, match=rf"rows \[{len(good)}\]"):
                machine.run_batch_shared_in_place(spec, b, 4096)


@pytest.mark.parametrize("seed", [5, 6])
def test_interp_kernel_runs_whole_images_in_global_memory(cuda, seed):
    """A full batch runs in global memory, one launch a run: the corpus,
    plain, under fault rows and under a schedule, bit-equal to the plain
    loop; so do the same machines in 60,016-word images, whose private
    words could not be staged.  A split batch whose private segments pass
    the shared-memory budget is refused before any launch."""
    spec = convert.spec_from_tuple(interp_images.SPEC)
    s = convert.vmstate_from_numpy(interp_images.corpus(seed), cuda)
    b = s.mem.shape[0]
    budget = interp_ops.staged_budget(s.mem.device)
    plan = faults.FaultPlan.from_row(torch.from_numpy(
        interp_images.fault_rows(seed, b)).to(cuda))
    quota = torch.from_numpy(interp_images.quotas(seed, b)).to(cuda)
    runs = [dict(), dict(faults=plan),
            dict(quota=quota, writer_slices=interp_images.SLICES)]
    for kw in runs:
        want = _plain_run(spec, s, interp_images.MAX_STEPS, **kw)
        x = machine.VMState(*(a.clone() for a in s))
        before = interp_ops.launches["run_interp"]
        interp_ops.run_interp(spec, x, interp_images.MAX_STEPS, **kw)
        assert interp_ops.launches["run_interp"] == before + 1
        _same_states(x, want, f"{sorted(kw)}")
    big = spec._replace(mem_words=60000)
    mem = torch.zeros(b, 60016, dtype=torch.int32, device=cuda)
    mem[:, :s.mem.shape[1]] = s.mem
    s = s._replace(mem=mem)
    assert interp_ops.staged_bytes(spec.num_wqs, 60016) > budget
    _same_states(machine.run_batch(big, s, 4096), _plain_run(big, s, 4096))
    split = machine.split(s, (100, 110), 1)
    before = interp_ops.launches["run_interp"]
    with pytest.raises(ValueError, match="over the"):
        machine.run_batch_shared_in_place(big, split, 10)
    assert interp_ops.launches["run_interp"] == before


@pytest.mark.parametrize("ttl", [False, True])
def test_interp_kernel_runs_split_gets(cuda, ttl):
    """A hopscotch server's get window (4 shards x 256 buckets, H 8) as a
    split batch through ``run_many``: bit-equal to the plain loop over the
    full copies, and ``sharded_get`` on the card equal to the CPU's."""
    n, s_ = 256, 4
    srv = programs.build_hopscotch_server(n, 4, 8, ttl=ttl, device=cuda)
    rng = np.random.RandomState(7)
    keys = np.zeros((s_, n), np.int32)
    for sh in range(s_):
        keys[sh, rng.choice(n, 150, replace=False)] = rng.randint(
            1, 1 << 20, 150)
    vals = rng.randint(-99, 99, (s_, n, 4)).astype(np.int32)
    exp = rng.randint(0, 100, (s_, n)).astype(np.int32) if ttl else None
    q = np.stack([np.concatenate([rng.choice(keys[sh][keys[sh] != 0], 12),
                                  [5, 0, 77, 1]]) for sh in range(s_)])
    q = torch.from_numpy(q.astype(np.int32))
    now = 50 if ttl else None
    dk, dv = torch.from_numpy(keys).to(cuda), torch.from_numpy(vals).to(cuda)
    de = None if exp is None else torch.from_numpy(exp).to(cuda)
    st = srv.device_state(dk, dv, de)
    pay = srv.device_payloads(q.to(cuda), hopscotch.bucket_of(q, n).to(cuda),
                              now).reshape(s_, -1, 8 + (2 if ttl else 8))
    out = srv.engine.run_many(st, srv.recv_wq, pay, 256,
                              window=srv.shared_window)
    assert isinstance(out, machine.SharedBatch)
    assert out.state.mem.shape[1] < st.mem.shape[1]
    batch = srv.engine.deliver_many(st, srv.recv_wq, pay)
    batch.steps.zero_()
    want = machine.plain_run(srv.spec, batch, 256)
    _same_states(machine.materialize(out), want)
    got = store.sharded_get(dk, dv, q.to(cuda), device=cuda, exp=de, now=now)
    ref = store.sharded_get(torch.from_numpy(keys), torch.from_numpy(vals),
                            q, device="cpu", now=now,
                            exp=None if exp is None else torch.from_numpy(exp))
    for f in ("found", "values", "ok"):
        assert torch.equal(getattr(got, f).cpu(), getattr(ref, f)), f


# --- the walk kernel (the write stages' windows) -----------------------------

def _walk_on(device, name, s, positions, seed, faulted):
    """A window of ``_walk_corpus``: the program built on ``device``, the
    carry, the rows and (``faulted``) a storm of fault rows there."""
    prog, carry, rows = walk_corpus._window(name, s, positions, seed)
    frows = None
    if faulted:
        frows = faults.storm(s * positions, p_fault=0.4,
                             max_step=prog.fuel // 2, seed=seed,
                             device="cpu").as_rows().reshape(
                                 s, positions, -1).contiguous()
    prog = walk_corpus._build(name, device=device)
    return (prog, tuple(c.to(device) for c in carry), rows.to(device),
            None if frows is None else frows.to(device))


def _walk_equal(got, want, what):
    for i, (a, b) in enumerate(zip(got[:2] + got[2], want[:2] + want[2])):
        assert torch.equal(a.cpu(), b.cpu()), (what, i)


# every program (both mirror geometries: the displacer's unwrapped frame,
# the migrator's new frame), fault rows disarmed and armed (not the
# sweeper's: its stage arms none), 1 to 4 owners, key-0 rows among them
WALK_CASES = [(name, faulted, s)
              for i, (name, faulted) in enumerate(
                  (n, f) for n in walk_corpus.PROGRAMS for f in (False, True)
                  if not (f and n == "sweeper"))
              for s in (1 + i % 4, 4 - i % 4)]


@pytest.mark.parametrize("name,faulted,s", WALK_CASES)
def test_walk_kernel_matches_the_plain_walk(cuda, name, faulted, s):
    """One launch of ``chain_walk_kernel``, responses, steps and the carry
    bit-equal to ``ref.plain_walk`` on the CPU and to the rows route on
    the card."""
    prog, carry, rows, frows = _walk_on(cuda, name, s, 12, 31 + s, faulted)
    cpu = walk_corpus._build(name)
    want = walk_ref.plain_walk(cpu, tuple(c.cpu() for c in carry), rows.cpu(),
                               prog.fuel,
                               None if frows is None else frows.cpu())
    before = dict(interp_ops.launches)
    got = interp_ops.run_walk(prog, carry, rows, prog.fuel, frows)
    torch.cuda.synchronize()
    assert interp_ops.launches["walk"] == before["walk"] + 1
    assert interp_ops.launches["run_interp"] == before["run_interp"]
    _walk_equal(got, want, f"{name} plain")
    transport.trace = []
    try:
        transport.rows_stage(prog, prog.fuel, carry, rows, frows, 1, name)
        rec = transport.trace[-1]
    finally:
        transport.trace = None
    _walk_equal(got, rec["out"], f"{name} rows route")
    assert int(want[1].max()) > 0


def test_walk_kernel_runs_a_stage_with_no_host_read(cuda):
    """After a first call (which checks the layout once), a stage is one
    launch with no device-to-host read."""
    prog, carry, rows, frows = _walk_on(cuda, "displacer", 4, 10, 5, True)
    fuel = prog.fuel                   # (a host read of the program's)
    want = interp_ops.run_walk(prog, carry, rows, fuel, frows)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = interp_ops.run_walk(prog, carry, rows, fuel, frows)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    _walk_equal(got, want, "no host read")


def test_walk_kernel_refuses_what_it_cannot_take(cuda):
    prog, carry, rows, frows = _walk_on(cuda, "writer", 2, 4, 1, True)
    with pytest.raises(ValueError, match="int32"):
        interp_ops.run_walk(prog, carry, rows.long(), prog.fuel)
    with pytest.raises(ValueError, match="fault rows"):
        interp_ops.run_walk(prog, carry, rows, prog.fuel, frows[:, :2])
    with pytest.raises(ValueError, match="fault rows"):
        interp_ops.run_walk(prog, carry, rows, prog.fuel, frows.cpu())


def test_walk_kernel_build_is_spill_free(cuda):
    """ptxas reports registers and no spill for both instances of
    ``chain_walk_kernel`` (one warp, several)."""
    log = _build.build(["chain_interp"])["chain_interp"]
    found, entry = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line if "chain_walk_kernel" in line else None
            if entry:
                found[entry] = {}
        elif entry and "spill stores" in line:
            stores, loads = (int(x) for x in re.findall(
                r"(\d+) bytes spill (?:stores|loads)", line))
            found[entry].update(stores=stores, loads=loads)
        elif entry and "Used" in line and "registers" in line:
            found[entry]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
            entry = None
    assert len(found) == 2, found
    for entry, r in found.items():
        assert "registers" in r and r["stores"] == r["loads"] == 0, (entry,
                                                                     r)


def test_write_stages_on_the_card_match_the_cpu(cuda):
    """SET (with displacement), DELETE and a sweep through the store on
    the card, one walk launch a stage and no interpreter launch: every
    result and array equal to the CPU's."""
    kv = store.ShardedKV.build(3, 64, 2, neighborhood=4)
    rng = np.random.RandomState(9)
    for k in rng.choice(np.arange(1, 1 << 16), 150, replace=False).tolist():
        try:
            kv.set(k, [k, k + 1])
        except Exception:
            pass
    sk = rng.randint(1, 1 << 16, (3, 16)).astype(np.int32)
    sk[0, 2] = 0
    sv = np.stack([sk, sk ^ 0x55], -1).astype(np.int32)
    exp = np.full((3, 64), hopscotch.NO_TTL, np.int32)
    outs = []
    for dev in (cuda, "cpu"):
        dk, dv = kv.device_arrays(dev)
        before = dict(interp_ops.launches)
        t = lambda a: torch.from_numpy(a).to(dev)      # noqa: E731
        res, k, v, e = store.sharded_set(
            dk, dv, t(sk), t(sv), neighborhood=4, max_search=8,
            max_moves=4, exp=t(exp), deadlines=t(np.full_like(sk, 50)),
            device=dev)
        dres, k, v, e = store.sharded_delete(k, v, t(sk[:, :6]), exp=e,
                                             neighborhood=4, device=dev)
        rep, k, v, e = store.sharded_sweep(k, v, e, t(np.zeros(3, np.int32)),
                                           100, 64, device=dev)
        after = {n: interp_ops.launches[n] - before[n] for n in before}
        outs.append((res, dres, rep, k, v, e, after))
    card, host = outs
    for a, b, what in zip(card[:3], host[:3], ("set", "delete", "sweep")):
        for f, x, y in zip(a._fields, a, b):
            assert torch.equal(x.cpu(), y), (what, f)
    for x, y in zip(card[3:6], host[3:6]):
        assert torch.equal(x.cpu(), y)
    assert card[6]["run_interp"] == 0 and card[6]["walk"] >= 4, card[6]


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
@pytest.mark.parametrize("d", [32, 64, 96, 128, 256])
def test_flash_kernel_matches_plain(cuda, dtype, d):
    # tails: 200, 333, 130, 77 and 1,025 are not multiples of the 32- to
    # 128-row tiles; bf16 at D 64, 96, 128 and 256 takes the tensor-core
    # kernel (at D 96 a 64- and a 32-column box), float32 and bf16 at D 32
    # the CUDA-core one
    b, h, kh = 2, 4, 2
    kind = fa_ops.variant(dtype, d)
    assert kind == ("wgmma" if dtype == torch.bfloat16
                    and d in (64, 96, 128, 256) else "fma")
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


def _flash_gqa_checked(cuda, seed, h, kh, d, cases):
    """Each (sq, sk, kwargs) case over h query heads on kh KV heads of d,
    bf16, on the tensor-core kernel against the plain version."""
    for i, (sq, sk, kw) in enumerate(cases):
        q, k, v = _qkv(cuda, seed + i, torch.bfloat16, 2, h, kh, sq, sk, d)
        got = _flash_checked(q, k, v, "wgmma", **kw)
        want = fa_ref.attention_reference(q, k, v, **kw)
        _close(got, want, torch.bfloat16, f"D={d} KH={kh} {kw}")


@pytest.mark.parametrize("kh", [16, 8, 1])
def test_flash_tensor_core_gqa_groups_at_head_dim_256(cuda, kh):
    # GQA groups 1, 2 and 16 (recurrentgemma-9b's) over 16 query heads,
    # windowed as its local layers are, on ragged lengths
    _flash_gqa_checked(cuda, 10 * kh, 16, kh, 256, (
        (300, 300, dict(mode="causal", window=100)),
        (65, 321, dict(mode="causal", q_offset=256)),
        (130, 190, dict(mode="full"))))


@pytest.mark.parametrize("kh", [32, 8, 1])
def test_flash_tensor_core_gqa_groups_at_head_dim_96(cuda, kh):
    # phi-3-vision's 32 query heads of 96 over 32 KV heads (its own), 8
    # and 1: causal with a window, ragged (no length a multiple of the
    # 128-row tiles), an offset query block, and full
    _flash_gqa_checked(cuda, 20 * kh, 32, kh, 96, (
        (300, 300, dict(mode="causal", window=100)),
        (65, 321, dict(mode="causal", window=64, q_offset=256)),
        (130, 190, dict(mode="full"))))


@pytest.mark.parametrize("d", [64, 96, 128, 256])
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
@pytest.mark.parametrize("d", [32, 64, 96, 128, 256])
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


def test_flash_tensor_core_at_head_dim_96_raises_without_fallback(cuda):
    # bf16 at D 96 launches the tensor-core kernel or raises: a grid the
    # card refuses (B past 65,535) reaches neither kernel nor the plain
    # version, and nothing is counted
    q, k, v = _qkv(cuda, 0, torch.bfloat16, 65536, 1, 1, 1, 1, 96)
    before = dict(fa_ops.launches)
    with pytest.raises(RuntimeError, match="flash_attention launch failed"):
        fa_ops.flash_attention(q, k, v)
    assert fa_ops.launches == before


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
    # meta tensors (the dry run's) get their outputs' shapes alone
    h, h_last = rg_ops.rglru(a.to("meta"), a.to("meta"))
    assert h.is_meta and h.shape == a.shape and h_last.shape == (2, 9)
    # no launch was made or counted
    assert (wkv_ops.launches["wkv6"], rg_ops.launches["rglru"]) == before


def _cut_batch(device, n=16, v=2, h=4):
    """Every cut of the 2-writer insert race as one batch of group machines
    (keys homed at one bucket racing for a half-full neighborhood)."""
    group = programs.build_multi_writer_group(n, v, neighborhood=h,
                                              n_writers=2, device=device)
    homed = store.keys_homed_at(3, 4, n)
    keys0 = torch.zeros(n, dtype=torch.int32, device=device)
    vals0 = torch.zeros((n, v), dtype=torch.int32, device=device)
    for b, k in zip((3, 4), homed[:2]):
        keys0[b] = k
        vals0[b] = torch.tensor([k & 0xFF, b])
    q = torch.tensor(homed[2:4], dtype=torch.int32, device=device)
    pay = group.device_payloads(q, hopscotch.bucket_of(q, n),
                                torch.stack([q & 0xFF, q >> 4], 1))
    cuts = torch.arange(group.writer_fuel + 1, dtype=torch.int32,
                        device=device)
    g = cuts.numel()
    st = group.delivered_state(keys0.expand(g, n), vals0.expand(g, n, v),
                               pay.expand(g, 2, -1))
    return group, st, machine.Schedule.cut(cuts)


def test_run_scheduled_on_card_matches_cpu(cuda):
    """The scheduled interpreter over a batch of cut schedules: every
    field of every machine (float32 clocks included) equal to the CPU."""
    outs = []
    for dev in (cuda, torch.device("cpu")):
        group, st, sched = _cut_batch(dev)
        outs.append(machine.run_scheduled(group.spec, st, sched,
                                          group.writer_slices, group.fuel))
    for f, a, b in zip(machine.VMState._fields, *outs):
        assert torch.equal(a.cpu(), b), f


def test_racing_writer_set_on_card_matches_cpu(cuda):
    """``sharded_set(n_writers=2)`` on a 2-shard store with a hot bucket
    per owner (racing claims, displacement escalation): statuses and
    tables equal the CPU's."""
    kv = store.ShardedKV.build(2, 128, 2, neighborhood=4)
    rng = np.random.RandomState(3)
    for k in rng.choice(np.arange(1, 1 << 16), 70, replace=False).tolist():
        kv.set(k, [k, k + 1])
    sk = np.stack([store.keys_homed_at(9, 6, 128, start=1 << 17,
                                       n_shards=2, shard=o)
                   for o in range(2)]).astype(np.int32)
    sv = np.stack([sk, sk ^ 0x55], -1).astype(np.int32)
    outs = []
    for dev in (cuda, "cpu"):
        dk, dv = kv.device_arrays(dev)
        outs.append(store.sharded_set(
            dk, dv, torch.from_numpy(sk).to(dev),
            torch.from_numpy(sv).to(dev), neighborhood=4, n_writers=2,
            device=dev))
    (res_g, kg, vg), (res_c, kc, vc) = outs
    for f, a, b in zip(store.SetResult._fields, res_g, res_c):
        assert torch.equal(a.cpu(), b), f
    assert torch.equal(kg.cpu(), kc) and torch.equal(vg.cpu(), vc)
    assert int(res_c.applied.sum()) >= 4


# --- the chain-program toolchain and the cuckoo table ------------------------

def test_addleq_guests_on_the_kernel_match_the_interpreter(cuda):
    """ADDLEQ guests (the demos, one that loops forever) through the
    managed chain kernel: equal to the interpreter on the card and to
    the interpreter on the CPU in the fields the kernel models, every
    halting guest's product right, the loop stopped at its fuel."""
    interp = turing.build_interpreter(device=cuda)
    d, i0 = interp.data_base, interp.instr_base
    guests = [turing.guest_multiply(interp, x, y)
              for x, y in ((7, 6), (3, 4), (12, 8), (9, 0))]
    guests += [turing.guest_countdown(interp, 40),
               turing.guest_add(interp, 17, 25),
               turing.AddleqProgram([(d, d + 1, i0)], {d: 0, d + 1: 0})]
    states = [interp.load(g) for g in guests]
    batch = machine.VMState(*(torch.stack(f) for f in zip(*states)))
    max_steps = interp.lap_words * 102
    before = chain_ops.launches["run_managed"]
    got = ChainEngine(interp.spec, "kernel").run_batch(batch, max_steps)
    assert chain_ops.launches["run_managed"] == before + 1
    interp_card = ChainEngine(interp.spec).run_batch(batch, max_steps)
    cpu = machine.VMState(*(a.cpu() for a in batch))
    interp_cpu = ChainEngine(interp.spec).run_batch(cpu, max_steps)
    for f in ("mem", "head", "tail", "enable_limit", "completions", "steps",
              "halted"):
        assert torch.equal(getattr(got, f), getattr(interp_card, f)), f
        assert torch.equal(getattr(got, f).cpu(), getattr(interp_cpu, f)), f
    prods = got.mem[:3, d + 2].tolist()
    assert prods == [42, 12, 96] and got.halted[:6].all()
    assert not bool(got.halted[6]) and int(got.steps[6]) == max_steps


def test_cuckoo_lookup_on_the_card_matches_the_cpu(cuda):
    tbl = cuckoo.make_table(1024, 4)
    rng = np.random.RandomState(4)
    keys = rng.choice(np.arange(1, 1 << 24), 3600, replace=False)
    tbl.memo_kicks(keys)
    for k in keys.tolist():
        tbl.insert(k, [k, -k, k ^ 3, 7])
    q = torch.from_numpy(np.concatenate([
        keys[:2000], rng.randint(1 << 24, 1 << 30, 2000), [0, -5]]).astype(
        np.int32))
    found, vals = cuckoo.lookup(*tbl.as_device(cuda), q.to(cuda))
    cfound, cvals = cuckoo.lookup(*tbl.as_device("cpu"), q)
    assert torch.equal(found.cpu(), cfound) and torch.equal(vals.cpu(), cvals)
    assert int(cfound[:2000].sum()) > 1800


# --- the flash backward --------------------------------------------------

# (b, h, kh, sq, sk, d, kwargs): causal GQA, window, q_offset with Sq < Sk,
# length with rows past the length and a window, full with Sk 384, G 1,
# head dims 32, 96, 128, 256, and rows that see no key (window, Sq > Sk);
# at head dim 256 also an MQA group of 16 at a ragged Sq (its dK/dV blocks
# split over the heads) and each mode's edge; in bf16 the cases at head
# dims 64, 128 and 256 take the tensor-core pair
FLASH_BWD_CASES = {
    "causal_gqa3": (2, 9, 3, 256, 256, 64, dict(mode="causal")),
    "causal_d128": (2, 8, 2, 320, 320, 128, dict(mode="causal")),
    "window": (1, 4, 2, 200, 200, 64, dict(mode="causal", window=48)),
    "offset": (2, 4, 1, 77, 333, 128, dict(mode="causal", q_offset=256)),
    "length": (2, 4, 2, 96, 300, 64, dict(mode="length")),
    "length_window": (2, 2, 1, 40, 300, 96, dict(mode="length", window=70)),
    "full_384": (2, 4, 2, 130, 384, 64, dict(mode="full")),
    "g1_d32": (2, 4, 4, 100, 100, 32, dict(mode="causal")),
    "d256": (1, 4, 1, 96, 96, 256, dict(mode="causal")),
    "no_key_rows": (1, 2, 1, 200, 100, 64, dict(mode="causal", window=16)),
    "no_key_rows_d128": (1, 2, 1, 200, 100, 128, dict(mode="causal",
                                                      window=16)),
    "mqa16_d256": (1, 16, 1, 200, 200, 256, dict(mode="causal")),
    "window_d256": (1, 4, 1, 200, 200, 256, dict(mode="causal", window=64)),
    "length_d256": (2, 4, 2, 130, 300, 256, dict(mode="length")),
    "offset_d256": (2, 4, 1, 77, 333, 256, dict(mode="causal",
                                                q_offset=256)),
    "full_384_d256": (2, 4, 2, 130, 384, 256, dict(mode="full")),
    "g1_d256": (2, 2, 2, 100, 100, 256, dict(mode="causal")),
    "no_key_rows_d256": (1, 2, 1, 200, 100, 256, dict(mode="causal",
                                                      window=16)),
}


def _bwd_inputs(cuda, case, dtype, seed=0):
    b, h, kh, sq, sk, d, kw = FLASH_BWD_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(dtype)
    q, k, v, do = rnd(b, h, sq, d), rnd(b, kh, sk, d), rnd(b, kh, sk, d), \
        rnd(b, h, sq, d)
    kw = dict(kw)
    if kw["mode"] == "length":
        kw["lengths"] = torch.tensor([sk // 3, sk], dtype=torch.int32,
                                     device=cuda)
    return q, k, v, do, kw


def _scaled_close(got, want, tol, what):
    got, want = got.float(), want.float()
    assert got.shape == want.shape and torch.isfinite(got).all(), what
    err = float((got - want).abs().max())
    assert err <= tol * max(float(want.abs().max()), 1e-30), (what, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(FLASH_BWD_CASES))
def test_flash_lse_matches_plain(cuda, case, dtype):
    q, k, v, _, kw = _bwd_inputs(cuda, case, dtype)
    out, lse = fa_ops.flash_attention_lse(q, k, v, **kw)
    want_out, want_lse = fa_ref.attention_reference_lse(q, k, v, **kw)
    assert lse.dtype == torch.float32 and lse.shape == q.shape[:3]
    seen = want_lse > -1e29              # rows that see a key
    torch.testing.assert_close(lse[seen], want_lse[seen], rtol=1e-5,
                               atol=1e-4)
    assert (lse[~seen] == -1e30).all()
    _scaled_close(out[seen], want_out[seen], TOL[dtype], f"{case} out")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(FLASH_BWD_CASES))
def test_flash_backward_matches_plain(cuda, case, dtype):
    """The backward kernels against the plain backward on the same (q, k,
    v, out, lse, dO) — the kernel forward's out and lse — at the float32
    (2e-5) and bf16 (2e-2) tolerances, scaled by each gradient's largest
    magnitude, through the pair ``bwd_variant`` picks (the tensor cores
    for bf16 at head dims 64, 128 and 256, with the partial sums' kernel
    where ``bwd_split`` slices the heads); and through autograd, against
    the plain backward of the plain forward."""
    q, k, v, do, kw = _bwd_inputs(cuda, case, dtype)
    out, lse = fa_ops.flash_attention_lse(q, k, v, **kw)
    before = dict(fa_ops.launches)
    got = fa_ops.flash_attention_backward(q, k, v, out, lse, do, **kw)
    pair = fa_ops.bwd_variant(dtype, q.shape[-1])
    assert pair == ("wgmma" if dtype == torch.bfloat16
                    and q.shape[-1] in (64, 128, 256) else "fma")
    for key in ("bwd", f"bwd_{pair}", "bwd_dq", "bwd_dkdv"):
        assert fa_ops.launches[f"flash_attention.{key}"] == \
            before[f"flash_attention.{key}"] + 1
    b, h, _, d = q.shape
    split = fa_ops.bwd_split(b, h, k.shape[1], k.shape[2], d,
                             fa_ops._sms(q.device))
    assert fa_ops.launches["flash_attention.bwd_sum"] == \
        before["flash_attention.bwd_sum"] + (pair == "wgmma" and split > 1)
    other = {"wgmma": "fma", "fma": "wgmma"}[pair]
    assert fa_ops.launches[f"flash_attention.bwd_{other}"] == \
        before[f"flash_attention.bwd_{other}"]
    want = fa_ref.attention_backward_reference(q, k, v, out, lse, do, **kw)
    for name, g, w, t in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        assert g.dtype == t.dtype and g.shape == t.shape
        _scaled_close(g, w, TOL[dtype], f"{case} {name}")
    qa, ka, va = (t.clone().requires_grad_(True) for t in (q, k, v))
    fa_ops.flash_attention(qa, ka, va, **kw).backward(do)
    pout, plse = fa_ref.attention_reference_lse(q, k, v, **kw)
    want = fa_ref.attention_backward_reference(q, k, v, pout, plse, do, **kw)
    for name, t, w in zip(("dq", "dk", "dv"), (qa, ka, va), want):
        _scaled_close(t.grad, w, TOL[dtype], f"{case} autograd {name}")
    if case.startswith("no_key_rows"):   # rows 115.. see no key
        assert (qa.grad[:, :, 115:] == 0).all()


@pytest.mark.parametrize("case,dtype", [
    ("causal_gqa3", torch.float32), ("causal_d128", torch.bfloat16),
    *((c, torch.bfloat16) for c in sorted(FLASH_BWD_CASES)
      if c.endswith("_d256"))])
def test_flash_backward_is_deterministic(cuda, case, dtype):
    """Two calls, bit-equal: the CUDA-core pair in float32 and the
    tensor-core pair in bf16 at head dims 128 and 256, the latter with
    its heads split over blocks and without (no atomics: the partial sums
    are added in a fixed order)."""
    q, k, v, do, kw = _bwd_inputs(cuda, case, dtype, 3)
    out, lse = fa_ops.flash_attention_lse(q, k, v, **kw)
    a = fa_ops.flash_attention_backward(q, k, v, out, lse, do, **kw)
    b = fa_ops.flash_attention_backward(q, k, v, out, lse, do, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_flash_backward_at_head_dim_256_raises_without_fallback(
        cuda, monkeypatch):
    # bf16 at D 256 launches the tensor-core pair or raises: a grid the
    # card refuses (B past 65,535) reaches neither the CUDA-core pair nor
    # the plain backward, and nothing is counted
    def plain(*args, **kwargs):
        raise AssertionError("the plain backward ran on the card")
    monkeypatch.setattr(fa_ops, "attention_backward_reference", plain)
    b, d = 65536, 256
    q, k, v, out, do = (torch.zeros(b, 1, 1, d, dtype=torch.bfloat16,
                                    device=cuda) for _ in range(5))
    lse = torch.zeros(b, 1, 1, device=cuda)
    assert fa_ops.bwd_variant(torch.bfloat16, d) == "wgmma"
    before = dict(fa_ops.launches)
    with pytest.raises(RuntimeError,
                       match="flash_attention_bwd launch failed"):
        fa_ops.flash_attention_backward(q, k, v, out, lse, do)
    assert fa_ops.launches == before


def test_the_split_counts_the_dkdv_blocks_keys(cuda):
    # bwd_split counts a D 256 dK/dV block's keys from BWD_KEYS_256: the
    # library's blocks own that many (and 128 at D 64 and 128)
    lib = _build.load("flash_attention_bwd", fa_ops._declare_bwd)
    assert lib.flash_attention_wgmma_bwd_keys(256) == fa_ops.BWD_KEYS_256
    assert [lib.flash_attention_wgmma_bwd_keys(d) for d in (64, 128, 96)] \
        == [128, 128, 0]


def test_kernels_without_a_backward_refuse_grad(cuda):
    """Decode attention (serving only) has no backward kernel: asked for a
    gradient on the card it raises instead of giving a zero one; under
    no_grad it runs.  (WKV6 and RG-LRU have backward kernels: the next
    test.)"""
    q = torch.randn(1, 4, 1, 64, device=cuda, requires_grad=True)
    kc, vc = (torch.randn(1, 2, 16, 64, device=cuda) for _ in range(2))
    lengths = torch.tensor([9], dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="decode-attention.*no backward"):
        dec_ops.decode_attention(q, kc, vc, lengths)
    with torch.no_grad():
        dec_ops.decode_attention(q, kc, vc, lengths)


def test_a_gradient_through_the_recurrences_launches_their_backward(cuda):
    """A gradient through WKV6 or RG-LRU on the card goes through the
    Functions: one forward and one backward kernel launch, counted, and
    the gradients of the plain backward."""
    r, k, v, w, u = _wkv_inputs(cuda, 3, torch.float32, 1, 2, 40, 32, 0.4)
    xs = [x.clone().requires_grad_(True) for x in (r, k, v, w, u)]
    do = torch.randn_like(r)
    before = dict(wkv_ops.launches)
    o, _ = wkv_ops.wkv6(*xs)
    o.backward(do)
    torch.cuda.synchronize()
    assert {n: wkv_ops.launches[n] - before[n] for n in before} == {
        "wkv6": 1, "wkv6_bwd": 1}
    want = wkv_ref.wkv6_backward_reference(r, k, v, w, u, do)
    for x, g in zip(xs, want):
        _scaled_close(x.grad, g, STATE_TOL, "wkv6 autograd")
    a = (0.5 + 0.5 * torch.rand(2, 70, 96, device=cuda)).requires_grad_(True)
    x = torch.randn(2, 70, 96, device=cuda, requires_grad=True)
    before = dict(rg_ops.launches)
    h, h_last = rg_ops.rglru(a, x)
    (h * 2).sum().backward()
    torch.cuda.synchronize()
    assert rg_ops.launches["rglru"] == before["rglru"] + 1
    assert rg_ops.launches["rglru_bwd"] == before["rglru_bwd"] + 1
    da, du = rg_ref.rglru_backward_reference(a.detach(), h.detach(),
                                             torch.full_like(h, 2.0))
    assert torch.equal(a.grad, da) and torch.equal(x.grad, du)


def _wkv_bwd_case(cuda, seed, dtype, b, h, t, n, w_lo, w_hi, with_ds):
    """Seeded WKV6 inputs, decays uniform in [w_lo, w_hi]; with w_hi below
    1e-3, half the channels decay in [0.9, 0.999] and the other half
    log-uniformly in [w_lo, w_hi]."""
    r, k, v, w, u = _wkv_inputs(cuda, seed, dtype, b, h, t, n, 0.0)
    if w_hi < 1e-3:
        w = 0.9 + 0.099 * w
        lo, hi = math.log(w_lo), math.log(w_hi)
        gen = torch.Generator(device=cuda).manual_seed(seed + 200)
        w[..., n // 2:] = torch.exp(lo + (hi - lo) * torch.rand(
            (b, h, t, n - n // 2), generator=gen, device=cuda))
    else:
        w = w_lo + w * (w_hi - w_lo) / 0.999
    gen = torch.Generator(device=cuda).manual_seed(seed + 100)
    do = torch.randn((b, h, t, n), generator=gen, device=cuda).to(dtype)
    ds = (torch.randn((b, h, n, n), generator=gen, device=cuda)
          if with_ds else None)
    return (r, k, v, w, u), do, ds


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [32, 64])
def test_wkv6_backward_kernel_matches_plain(cuda, dtype, n):
    """The backward kernel against the plain backward: T 1, T that end in
    a part of its chunk, a long T; decays down to 0.01, in [0.01, 0.115]
    and, on half the channels, in [1e-12, 1e-10] and [1e-30, 1e-20]; with
    and without dS_T.  dr, dk, dv at REC_TOL, dw and du within STATE_TOL of
    their largest magnitude; two runs bit-equal."""
    cases = ((1, 1, 1, 0.01, 0.999, False), (1, 2, 1, 0.5, 0.9, True),
             (2, 3, 33, 0.01, 0.999, True), (2, 2, 65, 0.01, 0.115, True),
             (1, 2, 2048, 0.01, 0.115, False), (2, 3, 31, 0.3, 0.99, True),
             (1, 2, 40, 1e-12, 1e-10, True), (2, 2, 77, 1e-30, 1e-20, False),
             (1, 3, 300, 1e-30, 1e-20, True))
    for i, (b, h, t, lo, hi, with_ds) in enumerate(cases):
        args, do, ds = _wkv_bwd_case(cuda, i, dtype, b, h, t, n, lo, hi,
                                     with_ds)
        before = wkv_ops.launches["wkv6_bwd"]
        got = wkv_ops.wkv6_backward(*args, do, ds)
        again = wkv_ops.wkv6_backward(*args, do, ds)
        torch.cuda.synchronize()
        assert wkv_ops.launches["wkv6_bwd"] == before + 2
        want = wkv_ref.wkv6_backward_reference(*args, do, ds)
        what = f"{(b, h, t, n)} w [{lo}, {hi}] ds={with_ds}"
        for name, g, wnt, g2, x in zip(("dr", "dk", "dv", "dw", "du"), got,
                                       want, again, (*args[:4], args[4])):
            assert g.dtype == x.dtype and g.shape == x.shape, name
            assert torch.equal(g, g2), f"{name} run to run, {what}"
            if name in ("dw", "du"):
                _scaled_close(g, wnt, STATE_TOL, f"{name} {what}")
            else:
                _close_rec(g, wnt, REC_TOL[dtype], f"{name} {what}")
        if t == 1:        # S_0 = 0: dw is exactly 0
            assert (got[3] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_backward_kernel_matches_plain(cuda, dtype):
    """The backward kernel ``variant`` picks, on the forward kernel's h,
    against the plain backward, bit for bit (both round each multiply and
    add alone, and bf16 outputs once), with and without dh_last; two runs
    bit-equal.  The ring kernel at T 1, at T that end in a part of its
    32-step chunk and at a D that ends in a part of its 64-channel tile;
    the direct kernel at D whose rows no TMA copy can move."""
    for i, (b, t, d) in enumerate(((1, 1, 1), (3, 1, 7), (2, 37, 4099),
                                   (4, 300, 130), (4, 2048, 4096),
                                   (1, 1, 64), (3, 1, 4160), (2, 45, 4160),
                                   (2, 65, 4100))):
        a, u, h, _ = _rglru_case(cuda, i, dtype, b, t, d)
        gen = torch.Generator(device=cuda).manual_seed(i + 50)
        dh = torch.randn((b, t, d), generator=gen, device=cuda).to(dtype)
        last = (torch.randn((b, d), generator=gen, device=cuda)
                if i % 2 else None)
        kind = rg_ops.variant(dtype, d)
        before = dict(rg_ops.launches)
        da, du = rg_ops.rglru_backward(a, h, dh, last)
        da2, du2 = rg_ops.rglru_backward(a, h, dh, last)
        torch.cuda.synchronize()
        assert {v: rg_ops.launches[v] - before[v] for v in (
            "rglru_bwd", "rglru_bwd.ring", "rglru_bwd.direct")} == {
            "rglru_bwd": 2, f"rglru_bwd.{kind}": 2,
            "rglru_bwd." + ("direct" if kind == "ring" else "ring"): 0}
        pda, pdu = rg_ref.rglru_backward_reference(a, h, dh, last)
        assert da.dtype == du.dtype == dtype and da.shape == a.shape
        assert torch.equal(da, pda) and torch.equal(du, pdu), (b, t, d)
        assert torch.equal(da, da2) and torch.equal(du, du2), (b, t, d)


def test_recurrent_backward_kernels_refuse_bad_inputs(cuda):
    r, k, v, w, u = _wkv_inputs(cuda, 0, torch.float32, 1, 2, 8, 32, 0.5)
    a = torch.rand((2, 5, 9), device=cuda)
    before = (wkv_ops.launches["wkv6_bwd"], rg_ops.launches["rglru_bwd"])
    with pytest.raises(ValueError, match="do not match"):
        wkv_ops.wkv6_backward(r, k, v, w, u, r[:, :, :4])
    with pytest.raises(ValueError, match="do not match"):
        wkv_ops.wkv6_backward(r, k, v, w, u, r, torch.zeros(1, 2, 32, 16,
                                                            device=cuda))
    with pytest.raises(ValueError, match="float32 w and u"):
        wkv_ops.wkv6_backward(r, k, v, w.bfloat16(), u, r)
    with pytest.raises(ValueError, match="do not match"):
        rg_ops.rglru_backward(a, a, a[:, :4])
    with pytest.raises(ValueError, match="one type"):
        rg_ops.rglru_backward(a, a.double(), a)
    assert (wkv_ops.launches["wkv6_bwd"],
            rg_ops.launches["rglru_bwd"]) == before
