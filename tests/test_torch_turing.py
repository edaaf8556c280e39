"""The port's ADDLEQ stored-program interpreter (``repro_torch.core.turing``)
against the JAX package's: the tests of ``tests/test_turing.py`` on the
port, each run's whole ``VMState`` bit-equal to JAX's ``machine.run``
(clocks included), and the port's ``"kernel"`` backend (the plain version
of the managed chain kernel on the CPU) equal to JAX's
``"pallas-interpret"`` on a seeded batch of guests."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyp import given, settings, st

from _parity import assert_states_equal, jax_fields
from repro.core import turing as jturing
from repro.core.engine import ChainEngine as JEngine
from repro_torch import convert
from repro_torch.core import machine, turing
from repro_torch.core.engine import ChainEngine

# the fields the kernel backend models (it passes the clocks through)
KERNEL_FIELDS = ("mem", "head", "tail", "enable_limit", "completions",
                 "steps", "halted")


@pytest.fixture(scope="module")
def interp():
    return turing.build_interpreter(device="cpu")


@pytest.fixture(scope="module")
def jinterp():
    return jturing.build_interpreter()


def _guest(module, interp, kind, *args):
    if kind == "raw":
        return module.AddleqProgram(*args)
    return getattr(module, f"guest_{kind}")(interp, *args)


def run_both(interp, jinterp, kind, *args, max_steps=None):
    """The same guest through the port and JAX; every state field equal."""
    tst = interp.load(_guest(turing, interp, kind, *args))
    jst = jinterp.load(_guest(jturing, jinterp, kind, *args))
    assert_states_equal(jst, tst)
    steps = max_steps or interp.lap_words * 202
    out = interp.run(tst, max_steps=steps)
    assert_states_equal(jinterp.run(jst, max_steps=steps), out)
    return out.mem.numpy(), out


def test_interpreter_image_equals_jax(interp, jinterp):
    assert tuple(interp.spec) == tuple(jinterp.spec)
    assert_states_equal(jinterp.state0, interp.state0)
    assert (interp.pc_addr, interp.instr_base, interp.data_base,
            interp.lap_words) == (jinterp.pc_addr, jinterp.instr_base,
                                  jinterp.data_base, jinterp.lap_words)
    assert interp.lap_words == 26 and interp.prog.wqs[0].n_posted == 26


def test_countdown_halts(interp, jinterp):
    mem, out = run_both(interp, jinterp, "countdown", 5)
    assert bool(out.halted)
    assert mem[interp.data_base] == 0          # counter reached 0
    assert int(out.steps) >= 9 * interp.lap_words


def test_add(interp, jinterp):
    mem, out = run_both(interp, jinterp, "add", 17, 25)
    assert bool(out.halted)
    assert mem[interp.data_base + 1] == 42


@pytest.mark.parametrize("x,y", [(3, 4), (7, 6), (1, 1), (9, 0)])
def test_multiply(interp, jinterp, x, y):
    mem, out = run_both(interp, jinterp, "multiply", x, y)
    assert bool(out.halted)
    if y == 0:
        # cnt starts 0: first decrement halts immediately, acc gets one x
        return
    assert mem[interp.data_base + 2] == x * y


def test_nontermination_is_fuel_bounded(interp, jinterp):
    """An infinite guest loop never quiesces (requirement T3)."""
    d, i0 = interp.data_base, interp.instr_base
    _, out = run_both(interp, jinterp, "raw", [(d, d + 1, i0)],
                      {d: 0, d + 1: 0}, max_steps=500)
    assert not bool(out.halted)
    assert int(out.steps) == 500


def random_guest(draw_int, draw_choice, d, i0):
    """``tests/test_turing.py``'s random guest: 1-5 instructions over 6
    cells in [-50, 50], jumps to HALT or a valid instruction, and a trap
    instruction whose cell is very negative."""
    n_instr = draw_int(1, 5)
    n_cells = 6
    trap = d + n_cells
    instrs = []
    for _ in range(n_instr):
        a = d + draw_int(0, n_cells - 1)
        b = d + draw_int(0, n_cells - 1)
        c = draw_choice([turing.HALT_PC] + [i0 + k * turing.INSTR_WORDS
                                            for k in range(n_instr + 1)])
        instrs.append((a, b, c))
    instrs.append((trap, trap, turing.HALT_PC))
    cells = {d + k: draw_int(-50, 50) for k in range(n_cells)}
    cells[trap] = -(1 << 20)
    return instrs, cells, trap


@settings(max_examples=10, deadline=None)
@given(st.data())
def test_random_addleq_against_reference(interp, jinterp, data):
    """Random small ADDLEQ programs: chain interpreter == python oracle,
    and the port's run == JAX's run, every field."""
    d, i0 = interp.data_base, interp.instr_base
    instrs, cells, trap = random_guest(
        lambda lo, hi: data.draw(st.integers(lo, hi)),
        lambda xs: data.draw(st.sampled_from(xs)), d, i0)
    budget = 100
    ref_mem, ref_n = turing.addleq_reference(instrs, cells, i0, i0,
                                             max_instrs=budget)
    assert (ref_mem, ref_n) == jturing.addleq_reference(
        instrs, cells, i0, i0, max_instrs=budget)
    got, out = run_both(interp, jinterp, "raw", instrs, dict(cells),
                        max_steps=interp.lap_words * (budget + 2))
    if ref_n < budget:     # reference halted within budget -> exact match
        assert bool(out.halted)
        for addr in sorted(cells):
            if addr == trap:
                continue
            assert got[addr] == ref_mem.get(addr, 0), (instrs, cells, addr)


# --- the kernel backend (its plain version here) against JAX's kernel -------

def _seeded_guests(interp, n, seed):
    rng = np.random.RandomState(seed)
    d, i0 = interp.data_base, interp.instr_base
    guests = [turing.guest_countdown(interp, 7),
              turing.guest_add(interp, 3, 9),
              turing.guest_multiply(interp, 7, 6),
              turing.AddleqProgram([(d, d + 1, i0)], {d: 0, d + 1: 0})]
    while len(guests) < n:
        instrs, cells, _ = random_guest(
            lambda lo, hi: int(rng.randint(lo, hi + 1)),
            lambda xs: xs[rng.randint(len(xs))],
            interp.data_base, interp.instr_base)
        guests.append(turing.AddleqProgram(instrs, cells))
    return guests


def _stack(states):
    return jax.tree_util.tree_map(lambda *a: jnp.stack(a), *states)


def test_kernel_backend_matches_pallas_interpret(interp, jinterp):
    guests = _seeded_guests(interp, 12, seed=20)
    max_steps = interp.lap_words * 102
    jbatch = _stack([jinterp.load(jturing.AddleqProgram(g.instrs, g.data))
                     for g in guests])
    tbatch = convert.vmstate_from_numpy(jax_fields(jbatch), "cpu")
    want = JEngine(jinterp.spec, "pallas-interpret").run_batch(jbatch,
                                                               max_steps)
    got = ChainEngine(interp.spec, "kernel").run_batch(tbatch, max_steps)
    assert_states_equal(want, got, KERNEL_FIELDS)
    # and the interpreter on the same batch, in the kernel's fields
    assert_states_equal(want, ChainEngine(interp.spec).run_batch(
        tbatch, max_steps), KERNEL_FIELDS)
    halted = got.halted.tolist()
    assert all(halted[:3]) and not halted[3]
    assert int(got.steps[3]) == max_steps       # the loop stops at its fuel
    mem = got.mem.numpy()
    for i, g in enumerate(guests):
        ref, n = turing.addleq_reference(g.instrs, g.data, interp.instr_base,
                                         interp.instr_base, max_instrs=100)
        if n < 100:          # the oracle halted within the guest budget
            assert halted[i], i
            for addr, v in g.data.items():
                if v != -(1 << 20):
                    assert mem[i, addr] == ref.get(addr, 0), (i, addr)


def test_kernel_backend_stops_a_looping_guest_at_its_fuel(interp):
    d, i0 = interp.data_base, interp.instr_base
    st0 = interp.load(turing.AddleqProgram([(d, d + 1, i0)],
                                           {d: 0, d + 1: 0}))
    batch = machine.VMState(*(torch.stack([a, a]) for a in st0))
    out = ChainEngine(interp.spec, "kernel").run_batch(batch, 500)
    assert out.steps.tolist() == [500, 500]
    assert not out.halted.any()


def test_load_copies_onto_the_image_device(interp):
    st = interp.load(turing.guest_add(interp, 1, 2), pc0=interp.instr_base)
    assert st.mem.device.type == "cpu"
    assert not torch.equal(st.mem, interp.state0.mem)
    assert int(interp.state0.mem[interp.pc_addr]) == 0


def test_build_interpreter_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        turing.build_interpreter()
