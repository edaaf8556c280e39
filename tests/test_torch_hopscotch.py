"""Parity of the port's hopscotch table and batched get with the JAX
package: the uint32 hash, the host set paths, the plain lookup, and the
hopscotch wrapper (plain path on the CPU) against the Pallas kernel in
interpret mode where that kernel is exact, and against ``lookup`` where
it is not (a key twice in one neighborhood, |value| >= 2^24)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyp import given, settings, st

from repro.kernels.hopscotch import ops as jops
from repro.kvstore import hopscotch as jh
from repro_torch.kernels.hopscotch import ops as tops
from repro_torch.kvstore import hopscotch as th

HIGH_BIT_KEYS = np.asarray([0, 1, 7, 0xFFFFFF, 0x7FFFFFFF, -1, -2 ** 31,
                            -123456789, 2 ** 31 - 2, 0x80000001 - 2 ** 32],
                           np.int32)


@pytest.mark.parametrize("n_buckets", [1, 7, 64, 65536, 2 ** 31 - 1])
def test_bucket_of_high_bit_keys(n_buckets):
    want = np.asarray(jh.bucket_of(jnp.asarray(HIGH_BIT_KEYS), n_buckets))
    got = th.bucket_of(torch.from_numpy(HIGH_BIT_KEYS), n_buckets)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(th.bucket_of(HIGH_BIT_KEYS, n_buckets),
                                  want)
    for k in HIGH_BIT_KEYS.tolist() + [2 ** 40 + 3]:
        assert th.bucket_of(k, n_buckets) == jh.bucket_of(k, n_buckets)


def test_constants_and_status_names_equal():
    for name in [n for n in dir(jh) if n.isupper()]:
        assert getattr(th, name) == getattr(jh, name), name
    for code in list(jh.STATUS_NAMES) + [99]:
        assert th.status_name(code) == jh.status_name(code)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_set_paths_match_jax(seed):
    """set_fast / set_full / insert on a crowded table: identical statuses
    and arrays, displacement and needs-resize included."""
    rng = np.random.RandomState(seed)
    jt, tt = jh.make_table(64, 3, 4), th.make_table(64, 3, 4)
    keys = rng.randint(1, 1 << 24, 90)
    for i, k in enumerate(keys.tolist()):
        v = rng.randint(-99, 99, rng.randint(1, 4)).tolist()
        if i % 3 == 0:
            assert tt.set_fast(k, v) == jt.set_fast(k, v)
        elif i % 3 == 1:
            assert tt.set_full(k, v, 12, 4) == jt.set_full(k, v, 12, 4)
        else:
            assert tt.insert(k, v) == jt.insert(k, v)
    np.testing.assert_array_equal(tt.keys, jt.keys)
    np.testing.assert_array_equal(tt.values, jt.values)
    k, v = tt.as_device("cpu")
    assert k.dtype == torch.int32 and v.shape == (64, 3)


def _loaded_table(n=128, v=2, n_keys=70, seed=0):
    rng = np.random.RandomState(seed)
    t = jh.make_table(n, v)
    keys = rng.choice(np.arange(1, 1 << 22), n_keys, replace=False)
    for k in keys.tolist():
        t.insert(k, [k % 251, -k][:v])
    return t, keys


def _queries(keys, n_buckets, rng, n=64):
    stored = np.asarray(keys)
    wrap = [k for k in stored.tolist()
            if jh.bucket_of(k, n_buckets) > n_buckets - 8]
    q = np.concatenate([rng.choice(stored, n - 12), wrap[:4],
                        rng.randint(1 << 22, 1 << 23, 6), [0, 0]])
    return rng.permutation(np.resize(q, n)).astype(np.int32)


def test_lookup_matches_jax():
    t, keys = _loaded_table()
    q = _queries(keys, 128, np.random.RandomState(1))
    wf, wv = jh.lookup(jnp.asarray(t.keys), jnp.asarray(t.values),
                       jnp.asarray(q), 8)
    gf, gv = th.lookup(torch.from_numpy(t.keys), torch.from_numpy(t.values),
                       torch.from_numpy(q), 8)
    np.testing.assert_array_equal(gf.numpy(), np.asarray(wf))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    assert not gf[torch.from_numpy(q) == 0].any()


@pytest.mark.parametrize("n,v", [(64, 2), (128, 4)])
def test_hopscotch_lookup_matches_pallas_interpret(n, v):
    t, keys = _loaded_table(n, v, n // 2, seed=n)
    q = _queries(keys, n, np.random.RandomState(2), n=128)
    wf, wv = jops.hopscotch_lookup(jnp.asarray(t.keys), jnp.asarray(t.values),
                                   jnp.asarray(q), 8, impl="interpret",
                                   block_q=64, block_n=32)
    before = dict(tops.launches)
    gf, gv = tops.hopscotch_lookup(torch.from_numpy(t.keys),
                                   torch.from_numpy(t.values),
                                   torch.from_numpy(q), 8)
    assert tops.launches == before           # CPU tensors: plain path
    np.testing.assert_array_equal(gf.numpy(), np.asarray(wf))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_first_hit_on_duplicate_key_and_wide_values_match_lookup():
    """Where the Pallas one-hot matmul is inexact, the port follows the
    JAX package's ``lookup``: the first matching bucket wins, and values
    at or beyond 2^24 come back as exact int32 words."""
    n = 64
    keys = np.zeros(n, np.int32)
    vals = np.zeros((n, 2), np.int32)
    dup = 12345
    h = jh.bucket_of(dup, n)
    keys[(h + 1) % n], keys[(h + 5) % n] = dup, dup
    vals[(h + 1) % n] = [2 ** 24 + 1, -(2 ** 31)]
    vals[(h + 5) % n] = [7, 8]
    other = next(k for k in range(1, 10 ** 6)
                 if jh.bucket_of(k, n) == (h + 20) % n)
    keys[(h + 21) % n] = other
    vals[(h + 21) % n] = [2 ** 31 - 1, 2 ** 24 + 3]
    q = np.asarray([dup, other, 0, 99999], np.int32)
    wf, wv = jh.lookup(jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(q), 8)
    gf, gv = tops.hopscotch_lookup(torch.from_numpy(keys),
                                   torch.from_numpy(vals), torch.from_numpy(q),
                                   8)
    np.testing.assert_array_equal(gf.numpy(), np.asarray(wf))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    assert gv[0].tolist() == [2 ** 24 + 1, -(2 ** 31)]
    assert gv[1].tolist() == [2 ** 31 - 1, 2 ** 24 + 3]


@settings(max_examples=20, deadline=None)
@given(nkeys=st.integers(1, 60), seed=st.integers(0, 1000))
def test_lookup_property_matches_jax(nkeys, seed):
    t, keys = _loaded_table(128, 2, nkeys, seed)
    q = _queries(keys, 128, np.random.RandomState(seed), n=32)
    wf, wv = jh.lookup(jnp.asarray(t.keys), jnp.asarray(t.values),
                       jnp.asarray(q), 8)
    gf, gv = th.lookup(torch.from_numpy(t.keys), torch.from_numpy(t.values),
                       torch.from_numpy(q), 8)
    np.testing.assert_array_equal(gf.numpy(), np.asarray(wf))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
