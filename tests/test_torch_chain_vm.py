"""Parity of the port's single-WQ chain executors (the plain versions of the
chain kernels, and ChainEngine's "kernel" backend on the CPU) with the
JAX package's Pallas kernels in interpret mode and its interpreter,
including the out-of-range index rules."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _chain_images as hazards
from _parity import assert_states_equal, to_torch
from repro.core import assembler as jasm
from repro.core import isa, machine as jm
from repro.core import programs as jp
from repro.core.engine import ChainEngine as JEngine
from repro.kernels.chain_vm import ops as jops
from repro_torch import convert
from repro_torch.core import assembler as tasm
from repro_torch.core import machine as tm
from repro_torch.core import programs as tp
from repro_torch.core.engine import ChainEngine as TEngine
from repro_torch.kernels.chain_vm import ops as tops
from repro_torch.kernels.chain_vm import ref as tref

N_WRS, M = 8, 256


def _random_contexts(seed, n=24):
    """n managed single-WQ contexts at base 0: random WRs over random data,
    random staged messages and init vectors (some pre-halted)."""
    rng = np.random.RandomState(seed)
    mems = rng.randint(-40, M + 40, size=(n, M)).astype(np.int32)
    for i in range(n):
        for s in range(N_WRS):
            o = s * isa.WR_WORDS
            mems[i, o] = (rng.randint(0, 16) << 24) | rng.randint(0, 5)
            mems[i, o + 1] = rng.randint(0, 2)
            mems[i, o + 4] = rng.randint(-2, 20)
            mems[i, o + 5] = rng.randint(-2, 6)
    msgs = rng.randint(-5, M + 40, size=(n, 8 * isa.MSG_WORDS)).astype(
        np.int32)
    inits = np.stack([
        rng.randint(0, 3, n), rng.randint(0, 12, n), rng.randint(0, 12, n),
        rng.randint(0, 3, n), rng.randint(0, 2, n), rng.randint(0, 4, n),
        rng.randint(0, 20, n), (rng.rand(n) < 0.1)], 1).astype(np.int32)
    return mems, msgs, inits


@pytest.mark.parametrize("managed", [True, False])
def test_managed_chain_loop_matches_pallas_interpret(managed):
    mems, msgs, inits = _random_contexts(0)
    want_mem, want_stats = jops.run_managed(
        jnp.asarray(mems), jnp.asarray(msgs), jnp.asarray(inits), wq_base=0,
        n_wrs=N_WRS, managed=managed, max_steps=24, impl="interpret")
    got_mem, got_stats = tref.managed_chain_loop(
        torch.from_numpy(mems), torch.from_numpy(msgs),
        torch.from_numpy(inits), wq_base=0, n_wrs=N_WRS, managed=managed,
        max_steps=24)
    np.testing.assert_array_equal(got_mem.numpy(), np.asarray(want_mem))
    np.testing.assert_array_equal(got_stats.numpy(), np.asarray(want_stats))


# the images the kernel's shared-memory walk makes hard
# (tests/_chain_images.py): a ring at the image's start and one ending at
# its last word
HAZARD_M, HAZARD_STEPS = 512, 17
HAZARDS = {(base, name): case
           for base in (0, HAZARD_M - 8 * hazards.WR)
           for name, case in {**hazards.recv_cases(HAZARD_M, base),
                              **hazards.copy_cases(HAZARD_M, base)}.items()}


@pytest.mark.parametrize("base,name", sorted(HAZARDS))
def test_managed_chain_loop_matches_jax_on_hazard_images(base, name):
    """RECV scatters that rewrite their own table or store twice to one
    word, tables clamped at the image's end, copies across the ring's edges
    and the image's end: the port's plain loop equals JAX's loop and its
    Pallas kernel in interpret mode, every word and counter."""
    mems, msgs, inits, kw = hazards.fixed_steps(HAZARDS[base, name],
                                                HAZARD_STEPS)
    got = tref.managed_chain_loop(torch.from_numpy(mems),
                                  torch.from_numpy(msgs),
                                  torch.from_numpy(inits), **kw)
    assert bool((got[0] != torch.from_numpy(mems)).any())
    for impl in ("ref", "interpret"):
        want = jops.run_managed(jnp.asarray(mems), jnp.asarray(msgs),
                                jnp.asarray(inits), impl=impl, **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=impl)


def test_run_chain_reference_matches_pallas_interpret():
    mems, _, _ = _random_contexts(1, n=32)
    want = jops.run_chains(jnp.asarray(mems), wq_base=0, n_wrs=N_WRS,
                           max_steps=20, impl="interpret")
    got, head = tref.run_chain_reference(torch.from_numpy(mems), 0, N_WRS, 20)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert head.dtype == torch.int32 and head.shape == (32,)


def test_cpu_wrappers_take_the_plain_path_without_launching():
    mems, msgs, inits = _random_contexts(2, n=4)
    before = dict(tops.launches)
    out = tops.run_chains(torch.from_numpy(mems), wq_base=0, n_wrs=N_WRS,
                          max_steps=8)
    ref, _ = tref.run_chain_reference(torch.from_numpy(mems), 0, N_WRS, 8)
    assert torch.equal(out, ref)
    got = tops.run_managed(torch.from_numpy(mems), torch.from_numpy(msgs),
                           torch.from_numpy(inits), wq_base=0, n_wrs=N_WRS,
                           max_steps=8)
    want = tref.managed_chain_loop(
        torch.from_numpy(mems), torch.from_numpy(msgs),
        torch.from_numpy(inits), wq_base=0, n_wrs=N_WRS, managed=True,
        max_steps=8)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tops.launches == before


# --- ChainEngine("kernel") on the CPU vs ChainEngine("pallas-interpret") ----

def _recycled(n_buckets=16):
    js = jp.build_recycled_get_server(n_buckets=n_buckets, val_len=2)
    ts = tp.build_recycled_get_server(n_buckets=n_buckets, val_len=2,
                                      device="cpu")
    for k in range(1, 11):
        js.insert(k, [k * 11, k * 11 + 1])
        ts.insert(k, [k * 11, k * 11 + 1])
    js.load()
    ts.load()
    return js, ts


@pytest.mark.parametrize("batch,max_steps", [(1, 64), (9, 64), (9, 5)])
def test_kernel_backend_matches_pallas_interpret_recycled_server(batch,
                                                                  max_steps):
    js, ts = _recycled()
    keys = [(i * 7) % 13 + 1 if i % 4 != 3 else 1000 + i
            for i in range(batch)]
    pay = np.asarray([js._payload(k) for k in keys], np.int32)
    want = JEngine.for_spec(js.spec, "pallas-interpret").run_many(
        js.state, js.loop_wq, pay, max_steps)
    got = TEngine.for_spec(ts.spec, "kernel").run_many(
        ts.state, ts.loop_wq, pay, max_steps)
    assert_states_equal(want, got)
    interp = TEngine.for_spec(ts.spec).run_many(ts.state, ts.loop_wq, pay,
                                                max_steps)
    for f in ("mem", "head", "enable_limit", "completions", "msg_head",
              "halted", "responses", "steps"):
        assert torch.equal(getattr(got, f), getattr(interp, f)), f


def _straight_line(asm, device=None):
    p = asm.Program(512)
    x, y, ret, resp = p.word(5), p.word(0), p.word(0), p.word(0)
    wq = p.add_wq(8)
    wq.read(src=x, dst=y)
    wq.add(dst=y, addend=10, ret=ret)
    wq.cas(dst=y, old=15, new=99)
    wq.max_(dst=y, operand=120)
    wq.min_(dst=y, operand=60)
    wq.send(src=y, ln=1, dst_region=resp, target_qp=-1)
    return p.finalize() if device is None else p.finalize(device=device)


def test_kernel_backend_run_batch_straight_line_and_pre_halted():
    jspec, jst = _straight_line(jasm)
    tspec, tst = _straight_line(tasm, "cpu")
    jb = jax.tree_util.tree_map(lambda a: jnp.stack([a] * 3), jst)
    jb = jb._replace(halted=jnp.asarray([False, True, False]))
    want = JEngine(jspec, "pallas-interpret").run_batch(jb, 16)
    got = TEngine(tspec, "kernel").run_batch(to_torch(jb), 16)
    assert_states_equal(want, got)


def test_kernel_backend_rejects_inter_qp_send_keyed_on_image():
    def prog(asm, bad, device=None):
        p = asm.Program(256)
        x = p.word(1)
        wq = p.add_wq(4)
        if bad:
            wq.send(src=x, ln=1, target_qp=0)
        else:
            wq.send(src=x, ln=1, dst_region=x, target_qp=-1)
        return p.finalize() if device is None else p.finalize(device=device)

    good_spec, good = prog(tasm, False, "cpu")
    bad_spec, bad = prog(tasm, True, "cpu")
    assert good_spec == bad_spec
    eng = TEngine(good_spec, "kernel")
    eng.run_many(good, 0, np.zeros((2, 1), np.int32), 8)
    with pytest.raises(ValueError, match="inter-QP SEND"):
        eng.run_many(bad, 0, np.zeros((2, 1), np.int32), 8)
    with pytest.raises(ValueError, match="inter-QP SEND"):
        JEngine(prog(jasm, True)[0], "pallas-interpret").run_many(
            prog(jasm, True)[1], 0, np.zeros((2, 1), np.int32), 8)


# --- out-of-range edges: every executor against its JAX counterpart --------

L = 512 + jm.GUARD_WORDS


def _edge_image(wrs):
    """One unmanaged WQ at base 0 holding ``wrs`` (opcode, src, dst, ln,
    opa, opb), then HALT; data 100.. in the image's upper part."""
    img = np.zeros(512, np.int32)
    img[128:] = np.arange(100, 100 + 512 - 128)
    for s, (op, src, dst, ln, opa, opb) in enumerate(wrs):
        o = s * isa.WR_WORDS
        img[o:o + 8] = [isa.pack_ctrl(op), 0, src, dst, ln, opa, opb, -1]
    img[len(wrs) * 8] = isa.pack_ctrl(isa.HALT)
    return img


EDGES = {
    "copy_near_image_end": [(isa.WRITE, L - 3, L - 5, 16, 0, 0),
                            (isa.READ, 200, L - 2, 9, 0, 0)],
    "dst_past_image": [(isa.WRITE_IMM, 0, L + 5, 1, 7, 0),
                       (isa.CAS, L + 1, L, 1, 0, 9),
                       (isa.ADD, 300, L + 2, 1, 5, 0),
                       (isa.MAX, 0, L + 9, 1, 99, 0),
                       (isa.WRITE, 140, L + 40, 4, 0, 0)],
    "negative_src_and_dst": [(isa.WRITE, -3, 200, 6, 0, 0),
                             (isa.READ, -L - 9, 220, 5, 0, 0),
                             (isa.WRITE, 150, -7, 3, 0, 0),
                             (isa.ADD, -1, 300, 1, 4, 0),
                             (isa.CAS, -5, 301, 1, 401, 77)],
    "opcode_13_or_more_halts": [(isa.WRITE_IMM, 0, 250, 1, 11, 0),
                                (13, 0, 251, 1, 12, 0),
                                (isa.WRITE_IMM, 0, 252, 1, 13, 0)],
    "opcode_127_halts": [(127, 0, 251, 1, 12, 0),
                         (isa.WRITE_IMM, 0, 252, 1, 13, 0)],
}


@pytest.mark.parametrize("case", sorted(EDGES))
def test_out_of_range_edges_match_jax(case):
    img = _edge_image(EDGES[case])
    spec = jm.MachineSpec(512, (0,), (8,), (0,), (False,), 8)
    jst = jm.init_state(spec, img, [8], [1 << 29])
    tspec = convert.spec_from_tuple(spec)
    # the multi-WQ interpreter
    assert_states_equal(jm.run(spec, jst, 16), tm.run(tspec, to_torch(jst),
                                                      16))
    # the straight-line executor and the managed executor
    mems = np.stack([np.asarray(jst.mem)] * 2)
    want = jops.run_chains(jnp.asarray(mems), wq_base=0, n_wrs=8,
                           max_steps=10, impl="interpret")
    got = tops.run_chains(torch.from_numpy(mems), wq_base=0, n_wrs=8,
                          max_steps=10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    msgs = np.zeros((2, 8 * isa.MSG_WORDS), np.int32)
    inits = np.asarray([[0, 8, 1 << 29, 0, 0, 0, 16, 0]] * 2, np.int32)
    want = jops.run_managed(jnp.asarray(mems), jnp.asarray(msgs),
                            jnp.asarray(inits), wq_base=0, n_wrs=8,
                            managed=False, max_steps=10, impl="interpret")
    got = tops.run_managed(torch.from_numpy(mems), torch.from_numpy(msgs),
                           torch.from_numpy(inits), wq_base=0, n_wrs=8,
                           managed=False, max_steps=10)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_opcode_13_executes_as_halt():
    img = _edge_image(EDGES["opcode_13_or_more_halts"])
    spec = tm.MachineSpec(512, (0,), (8,), (0,), (False,), 8)
    st = tm.init_state(spec, img, [8], [1 << 29], "cpu")
    out = tm.run(spec, st, 16)
    assert bool(out.halted) and int(out.steps) == 2
    assert int(out.verb_counts[isa.HALT]) == 1
    assert int(out.mem[251]) != 12 and int(out.mem[252]) != 13
