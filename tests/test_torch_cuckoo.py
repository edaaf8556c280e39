"""The port's MemC3-style cuckoo table (``repro_torch.kvstore.cuckoo``)
against the JAX package's: the hashes on Python ints and on int32 arrays
(negative keys included, at power-of-two and other bucket counts), the
host insert sequence with its seeded evictions, and the batched lookup,
key 0 included.  The reference's two quirks are reproduced, not mended:
``h2`` of a negative key differs between the host and the arrays when the
bucket count is not a power of two, and a query of key 0 reads as found."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kvstore import cuckoo as jcuckoo
from repro_torch.kvstore import cuckoo

SIZES = [64, 100, 1000, 1 << 12]


def _keys(seed, n=4096):
    rng = np.random.RandomState(seed)
    k = rng.randint(-(1 << 31), (1 << 31) - 1, size=n, dtype=np.int64)
    extremes = [0, 1, -1, -5, -1000, 127, 128, -128, (1 << 31) - 1,
                -(1 << 31)]
    return np.concatenate([k, extremes]).astype(np.int32)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("h", ["h1", "h2"])
def test_tensor_hashes_equal_jax(h, n):
    keys = _keys(n)
    got = getattr(cuckoo, h)(torch.from_numpy(keys), n)
    want = np.asarray(getattr(jcuckoo, h)(jnp.asarray(keys), n))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.min() >= 0 and got.max() < n


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("h", ["h1", "h2"])
def test_int_hashes_equal_jax(h, n):
    for k in _keys(n + 1, n=512).tolist():
        assert getattr(cuckoo, h)(k, n) == getattr(jcuckoo, h)(k, n), k


def test_h2_host_and_tensor_split_on_negative_keys():
    """The reference's ``h2`` shifts a Python int arithmetically and a
    uint32 logically: at n = 100, key -5 homes at 12 on the host and at 48
    on tensors, key -1000 at 76 and 12.  ``h1`` agrees on both paths."""
    for key, host, dev in ((-5, 12, 48), (-1000, 76, 12)):
        t = torch.tensor([key], dtype=torch.int32)
        assert cuckoo.h2(key, 100) == jcuckoo.h2(key, 100) == host
        assert int(cuckoo.h2(t, 100)) == dev
        assert int(jcuckoo.h2(jnp.asarray([key], jnp.int32), 100)[0]) == dev
        assert cuckoo.h1(key, 100) == int(cuckoo.h1(t, 100))
    # a power-of-two count keeps only low bits: both paths agree there
    t = torch.tensor([-5, -1000], dtype=torch.int32)
    assert cuckoo.h2(t, 64).tolist() == [cuckoo.h2(-5, 64),
                                         cuckoo.h2(-1000, 64)]


def _fill(module, n_buckets, val_words, keys, memo=()):
    tbl = module.make_table(n_buckets, val_words)
    if len(memo):
        tbl.memo_kicks(memo)
    ok = [tbl.insert(int(k), [int(k), int(k) * 3 + 1][:val_words])
          for k in keys]
    return tbl, ok


@pytest.mark.parametrize("n_buckets,load", [(64, 0.9), (100, 0.95)])
def test_insert_sequence_equal_jax(n_buckets, load):
    rng = np.random.RandomState(n_buckets)
    n = int(n_buckets * 4 * load)
    keys = rng.choice(np.arange(1, 1 << 20), n, replace=False)
    keys = np.concatenate([keys, keys[:5]])            # updates in place
    tbl, ok = _fill(cuckoo, n_buckets, 2, keys)
    jtbl, jok = _fill(jcuckoo, n_buckets, 2, keys)
    assert ok == jok and sum(ok) > n * 0.8
    np.testing.assert_array_equal(tbl.keys, jtbl.keys)
    np.testing.assert_array_equal(tbl.values, jtbl.values)
    assert (tbl.n_buckets, tbl.ways) == (n_buckets, 4)


def test_lookup_equals_jax_and_the_host_dict():
    rng = np.random.RandomState(7)
    keys = rng.choice(np.arange(1, 1 << 24), 900, replace=False)
    tbl, ok = _fill(cuckoo, 256, 3, keys)
    jtbl, _ = _fill(jcuckoo, 256, 3, keys)
    # a failed insert drops the last key of its kick chain, which may be
    # an earlier one: the table itself is the oracle's dict
    live = {int(k) for k in tbl.keys.ravel() if k != cuckoo.EMPTY}
    assert live <= {int(k) for k in keys} and len(live) > 800
    absent = rng.choice(np.arange(1 << 24, 1 << 25), 200, replace=False)
    q = np.concatenate([keys[:300], absent, [0, 0, -5]]).astype(np.int32)
    dk, dv = tbl.as_device("cpu")
    found, vals = cuckoo.lookup(dk, dv, torch.from_numpy(q))
    jfound, jvals = jcuckoo.lookup(*jtbl.as_device(), jnp.asarray(q))
    np.testing.assert_array_equal(found.numpy(), np.asarray(jfound))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    for i, k in enumerate(q.tolist()):
        if k == 0:
            continue
        assert bool(found[i]) == (k in live), k
        want = [k, k * 3 + 1, 0] if k in live else [0, 0, 0]
        assert vals[i].tolist() == want, k


def test_lookup_of_key_zero_reads_as_found():
    """Key 0 is ``EMPTY``: its query hits any empty way, as in the
    reference, and reads zeros."""
    tbl = cuckoo.make_table(16, 2)
    assert tbl.insert(9, [1, 2])
    dk, dv = tbl.as_device("cpu")
    found, vals = cuckoo.lookup(dk, dv, torch.tensor([0, 9, 10],
                                                     dtype=torch.int32))
    assert found.tolist() == [True, True, False]
    assert vals.tolist() == [[0, 0], [1, 2], [0, 0]]


def test_as_device_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cuckoo.make_table(4, 1).as_device()


@pytest.mark.parametrize("ways", [1, 2, 4, 8])
def test_kick_ways_are_randomstate_draws(ways):
    rng = np.random.RandomState(ways)
    seeds = np.concatenate([rng.randint(0, 1 << 32, 3000, dtype=np.int64),
                            [0, 1, 2, (1 << 31) - 1, 1 << 31,
                             (1 << 32) - 1]])
    want = [np.random.RandomState(int(k)).randint(ways) for k in seeds]
    assert cuckoo.kick_ways(seeds, ways).tolist() == want
    with pytest.raises(ValueError):
        cuckoo.kick_ways(seeds, 3)
    with pytest.raises(ValueError):
        cuckoo.kick_ways([-1], ways)


def test_memoized_fill_equals_jax():
    """A fill past capacity with the eviction ways drawn up front gives the
    reference's table, failures included; the memo leaves out a key no
    generator takes (a negative one)."""
    rng = np.random.RandomState(3)
    keys = rng.choice(np.arange(1, 1 << 24), int(128 * 4 * 0.97),
                      replace=False)
    tbl, ok = _fill(cuckoo, 128, 2, keys, memo=np.append(keys, -7))
    assert len(tbl.kicks) == len(keys)
    jtbl, jok = _fill(jcuckoo, 128, 2, keys)
    assert ok == jok and not all(ok)
    np.testing.assert_array_equal(tbl.keys, jtbl.keys)
    np.testing.assert_array_equal(tbl.values, jtbl.values)
