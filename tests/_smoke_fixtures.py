"""The module fixtures that ``chip_smoke.py``'s CPU rehearsals share:
the script itself, imported from the checkout, and a small store whose
write path reaches every verb.  ``tests/test_torch_smoke_cpu.py`` and the
modules split from it (one slow phase each, so that a parallel run can
place them on other workers) import them."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def write_store(smoke):
    """2 shards x 256 buckets, 300 random keys (59% load): the sequential
    keys of ``build_store`` leave no neighborhood full at this size."""
    kv = smoke.store.ShardedKV.build(2, 256, 4)
    rng = np.random.RandomState(0)
    for k in rng.choice(np.arange(1, 1 << 20), 300, replace=False).tolist():
        assert kv.set(k, [k, 2 * k, 3 * k, 5 * k])
    return kv


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the rehearsals' tensors are tiny, and several
    threads a worker oversubscribe the cores of a parallel run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
