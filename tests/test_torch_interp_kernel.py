"""The chain interpreter kernel's wrapper (``kernels/chain_interp/ops.py``)
on the CPU, where it takes its plain version, the machine's host loop:
every field of every machine of ``_interp_images.py``'s corpus, clocks
included, bit-equal to JAX's ``machine.run_batch`` (plain and under fault
rows of all four kinds) and ``machine.run_scheduled`` (a two-writer plan a
machine); the scheduled batch run row by row equal to the whole batch (the
rows are independent machines, which lets the kernel walk each row's
rounds alone); the wrapper's refusals; the source's registration.  The
kernel itself is held to this plain version on the card
(``test_torch_gpu.py``, phase ``chain_interp`` of ``chip_smoke.py``)."""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _interp_images as images
from repro.core import faults as jf
from repro.core import machine as jm
from repro_torch import convert
from repro_torch.core import faults as tf
from repro_torch.core import machine as tm
from repro_torch.kernels import _build
from repro_torch.kernels.chain_interp import ops as interp_ops

ROOT = Path(__file__).resolve().parents[1]
JSPEC = jm.MachineSpec(*images.SPEC)
TSPEC = convert.spec_from_tuple(images.SPEC)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_state(fields):
    return jm.VMState(*(jnp.asarray(fields[f]) for f in jm.VMState._fields))


def torch_state(fields):
    return convert.vmstate_from_numpy(fields, "cpu")


def assert_equal(want, got: tm.VMState, what=""):
    """Every VMState field bit-equal, dtypes included."""
    for f in tm.VMState._fields:
        w = np.asarray(getattr(want, f) if not isinstance(want, dict)
                       else want[f])
        g = getattr(got, f).numpy()
        assert g.dtype == w.dtype, (what, f, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {f}")


def plans(rows):
    rows = np.asarray(rows, np.int32)
    return (jf.FaultPlan.from_row(jnp.asarray(rows)),
            tf.FaultPlan.from_row(torch.from_numpy(rows)))


@pytest.mark.parametrize("seed,max_steps", [(0, images.MAX_STEPS),
                                            (1, images.MAX_STEPS),
                                            (2, 4096), (3, 7)])
def test_run_batch_matches_jax(seed, max_steps):
    batch = images.corpus(seed)
    want = jm.run_batch(JSPEC, jax_state(batch), max_steps)
    before = dict(interp_ops.launches)
    got = tm.run_batch(TSPEC, torch_state(batch), max_steps)
    assert interp_ops.launches == before          # the plain path
    assert_equal(want, got, f"seed {seed}")
    assert int(got.halted.sum()) > 0 and int(got.steps.min()) >= 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_faulted_run_batch_matches_jax(seed):
    batch = images.corpus(seed)
    b = batch["mem"].shape[0]
    jplan, tplan = plans(images.fault_rows(seed + 10, b))
    want = jm.run_batch(JSPEC, jax_state(batch), images.MAX_STEPS, jplan)
    got = tm.run_batch(TSPEC, torch_state(batch), images.MAX_STEPS, tplan)
    assert_equal(want, got, f"seed {seed}")
    clean = tm.run_batch(TSPEC, torch_state(batch), images.MAX_STEPS)
    assert not torch.equal(clean.mem, got.mem)    # the faults fired


def test_hazards_run_through_every_verb():
    """The corpus reaches every verb, clipped opcodes and both ends."""
    got = tm.run_batch(TSPEC, torch_state(images.corpus(0)), 4096)
    counts = got.verb_counts.sum(0)
    assert bool((counts > 0).all()), counts
    assert int(got.responses.sum()) > 0 and int(got.msg_head.sum()) > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_run_scheduled_matches_jax_row_by_row(seed):
    """Each machine under its own two-writer plan, against JAX's
    ``run_scheduled`` of that machine alone."""
    batch = images.corpus(seed, n_random=8)
    b = batch["mem"].shape[0]
    quota = images.quotas(seed, b)
    got = tm.run_scheduled(TSPEC, torch_state(batch),
                           tm.Schedule.from_rows(quota, device="cpu"),
                           images.SLICES, images.MAX_STEPS)
    for i in range(b):
        one = jax_state({f: a[i] for f, a in batch.items()})
        want = jm.run_scheduled(JSPEC, one, jm.Schedule.from_rows(quota[i]),
                                images.SLICES, images.MAX_STEPS)
        assert_equal(want, tm.VMState(*(a[i] for a in got)), f"row {i}")


@pytest.mark.parametrize("shared", [False, True])
def test_scheduled_rows_are_independent(shared):
    """The scheduled batch run row by row equals the whole batch, with a
    plan a row or one plan for all: the host loop's lockstep over rounds
    and writers is no part of the result."""
    batch = images.corpus(4, n_random=12)
    b = batch["mem"].shape[0]
    quota = images.quotas(5, b)
    quota = quota[:1] if shared else quota
    sched = tm.Schedule.from_rows(quota[0] if shared else quota,
                                  device="cpu")
    whole = tm.run_scheduled_in_place(TSPEC, torch_state(batch), sched,
                                      images.SLICES, images.MAX_STEPS)
    for i in range(b):
        one = torch_state({f: a[i:i + 1] for f, a in batch.items()})
        alone = tm.Schedule.from_rows(quota[0 if shared else i][None],
                                      device="cpu")
        tm.run_scheduled_in_place(TSPEC, one, alone, images.SLICES,
                                  images.MAX_STEPS)
        assert_equal({f: getattr(one, f).numpy()[0]
                      for f in tm.VMState._fields},
                     tm.VMState(*(a[i] for a in whole)), f"row {i}")


def test_non_contiguous_fields_are_written_back():
    """On the CPU ``run_batch_in_place`` (the plain loop) updates a
    strided field in place; on the card the wrapper refuses one (the
    ``strided`` case of :func:`bad_input`)."""
    batch = images.corpus(0, n_random=4)
    want = tm.run_batch(TSPEC, torch_state(batch), images.MAX_STEPS)
    s = torch_state(batch)
    wide = torch.zeros(s.head.shape[0], 2 * s.head.shape[1],
                       dtype=torch.int32)
    head = wide[:, ::2]
    head.copy_(s.head)
    s = s._replace(head=head)
    out = tm.run_batch_in_place(TSPEC, s, images.MAX_STEPS)
    assert out.head is head and not head.is_contiguous()
    for f in tm.VMState._fields:
        assert torch.equal(getattr(out, f), getattr(want, f)), f


def meta(a: torch.Tensor) -> torch.Tensor:
    """``a``'s shape, strides and dtype on the meta device (no data, and
    not the card)."""
    return torch.empty_strided(a.shape, a.stride(), dtype=a.dtype,
                               device="meta")


def bad_input(case):
    """A (spec, state, kwargs) the kernel must refuse."""
    s = torch_state(images.corpus(0, n_random=2))
    b = s.mem.shape[0]
    spec, kw = TSPEC, {}
    if case == "too_many_wqs":
        spec = TSPEC._replace(wq_bases=(0,) * 1025, wq_sizes=(1,) * 1025,
                              orderings=(0,) * 1025, managed=(False,) * 1025)
    elif case == "ordering":
        spec = TSPEC._replace(orderings=(0, 3, 1, 0))
    elif case == "unbatched":
        s = tm.VMState(*(a[0] for a in s))
    elif case == "dtype":
        s = s._replace(clock=s.clock.double())
    elif case == "strided":
        s = s._replace(head=torch.zeros(b, 8, dtype=torch.int32)[:, ::2])
    elif case == "shape":
        s = s._replace(verb_counts=s.verb_counts[:, :12].contiguous())
    elif case == "quota":
        kw = dict(quota=meta(torch.zeros(1, 4, 2, dtype=torch.int32)),
                  writer_slices=images.SLICES)
    elif case == "plan_and_quota":
        kw = dict(quota=meta(torch.zeros(b, 4, 2, dtype=torch.int32)),
                  writer_slices=images.SLICES,
                  faults=tf.FaultPlan(*(meta(a) for a in tf.FaultPlan.none(
                      (b,), "cpu"))))
    return spec, tm.VMState(*(meta(a) for a in s)), kw


@pytest.mark.parametrize("case", ["too_many_wqs", "ordering", "unbatched",
                                  "dtype", "strided", "shape", "quota",
                                  "plan_and_quota", "not_cuda"])
def test_wrapper_refuses_what_the_kernel_cannot_take(case):
    """Off the CPU the wrapper takes only what the kernel can run, and
    raises (before any build or launch) on the rest; a sound state on
    another device than the card is refused too."""
    spec, s, kw = bad_input(case)
    before = dict(interp_ops.launches)
    with pytest.raises(ValueError):
        interp_ops.run_interp(spec, s, 16, **kw)
    assert interp_ops.launches == before


def test_source_is_built_and_registered():
    assert "chain_interp" in _build.SOURCES
    assert (_build.CSRC / "chain_interp.cu").is_file()
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    rows = {r[0]: r for r in smoke.KERNELS}
    name, phase, source, replaces, kernels = rows["chain_interp.run_interp"]
    assert phase == "chain_interp" and phase in smoke.PHASES
    assert source == "src/repro_torch/csrc/chain_interp.cu"
    assert replaces == "src/repro/core/machine.py:447"
    assert kernels == ("chain_interp_kernel",)
    assert smoke.PHASES.index("chain_faults") + 1 == smoke.PHASES.index(
        "chain_interp")
    assert interp_ops.launches in smoke.LAUNCH_COUNTS
