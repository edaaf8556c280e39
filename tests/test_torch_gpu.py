"""Card-only tests: each hand-written CUDA kernel against its plain PyTorch
version on the same inputs (exact, int32), and the interpreter on the card
against the interpreter on the CPU.  They skip without a card.  On the
card (which has no JAX, so nothing here imports it):

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import isa, machine
from repro_torch.kernels.chain_vm import ops as chain_ops
from repro_torch.kernels.chain_vm import ref as chain_ref
from repro_torch.kernels.hopscotch import ops as hop_ops
from repro_torch.kvstore import hopscotch

pytestmark = pytest.mark.gpu


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
