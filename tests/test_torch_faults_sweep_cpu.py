"""The displacer's cut-point sweep at every cut from 0 to its fuel, the
port's cuts as one batch against JAX's one by one (the smaller sweeps and
the scenario are in ``test_torch_faults.py``), in a module of its own: the
slowest case of that file, which a parallel run places on a worker of its
own."""
import pytest
import torch

from _parity import fresh_jax_programs
from repro_torch.core import programs as tp
from test_torch_faults import _displacer_scenario, _sweep_writer_like

_fresh_jax_programs = pytest.fixture(scope="module", autouse=True)(
    fresh_jax_programs)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the sweep's machines are tiny, and several
    threads a worker oversubscribe the cores of a parallel run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.slow
def test_displacer_cutpoint_sweep_full():
    fuel = _displacer_scenario(tp, device="cpu")[0].fuel
    assert _sweep_writer_like(_displacer_scenario, range(fuel + 1)) > 0
