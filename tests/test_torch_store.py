"""Parity of the port's sharded store and transport: at S = 1 the three get
paths against the JAX package's ``sharded_get`` on a 1-device mesh over the
same table (capacity drops, capacity=0 and live masks included); at S = 4
against ``reference_get``; the transport against loop oracles."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from _parity import fresh_jax_programs
from repro.kvstore import store as jstore
from repro_torch import convert
from repro_torch.data.pipeline import kv_request_stream
from repro_torch.kvstore import store as tstore
from repro_torch.rdma import isolation as tiso
from repro_torch.rdma import transport

METHODS = ["redn", "one_sided", "two_sided"]


_fresh_jax_programs = pytest.fixture(scope="module", autouse=True)(
    fresh_jax_programs)


@pytest.fixture(scope="module")
def kv1():
    kv = jstore.ShardedKV.build(n_shards=1, buckets_per_shard=128,
                                val_words=2)
    rng = np.random.RandomState(0)
    keys = rng.choice(np.arange(1, 1 << 16), size=60, replace=False)
    for k in keys:
        kv.set(int(k), [int(k) % 251, int(k) % 241])
    dk, dv = kv.device_arrays()
    return kv, keys, dk, dv


ARMS = {
    "default": dict(),
    "capacity_9": dict(capacity=9),
    "capacity_0": dict(capacity=0),
    "live": dict(live=True),
    "live_capacity_5": dict(live=True, capacity=5),
}


@pytest.mark.parametrize("arm", sorted(ARMS))
@pytest.mark.parametrize("method", METHODS)
def test_s1_paths_match_jax_sharded_get(kv1, method, arm):
    kv, keys, dk, dv = kv1
    rng = np.random.RandomState(1)
    probe = np.concatenate([rng.choice(keys, 20), [99999, 77777, 0]])
    q = probe[None].astype(np.int32)
    kw = dict(ARMS[arm])
    live = None
    if kw.pop("live", False):
        live = rng.rand(*q.shape) < 0.7
    mesh = Mesh(np.array(jax.devices()[:1]), ("kv",))
    want = jstore.sharded_get(mesh, "kv", dk, dv, jnp.asarray(q),
                              method=method,
                              live=None if live is None else jnp.asarray(live),
                              **kw)
    tkv = convert.kv_from_numpy(np.asarray(dk), np.asarray(dv))
    tk, tv = tkv.device_arrays("cpu")
    got = tstore.sharded_get(tk, tv, torch.from_numpy(q), method=method,
                             live=None if live is None
                             else torch.from_numpy(live), device="cpu", **kw)
    for field, g, w in zip(tstore.GetResult._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=field)


def test_s1_reference_get_matches_jax(kv1):
    kv, keys, dk, dv = kv1
    probe = np.concatenate([keys[:10], [0, 123457]]).astype(np.int32)
    tkv = convert.kv_from_numpy(np.asarray(dk), np.asarray(dv))
    for g, w in zip(tstore.reference_get(tkv, probe),
                    jstore.reference_get(kv, probe)):
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def kv4():
    kv = tstore.ShardedKV.build(n_shards=4, buckets_per_shard=64,
                                val_words=3)
    rng = np.random.RandomState(2)
    keys = rng.choice(np.arange(1, 1 << 20), size=150, replace=False)
    for k in keys.tolist():
        assert kv.set(k, [k, 2 * k, -k])
    return kv, keys


@pytest.mark.parametrize("method", METHODS)
def test_s4_paths_match_reference_get(kv4, method):
    kv, keys = kv4
    stream = kv_request_stream(len(keys), 12, seed=3)
    q = np.stack([keys[next(stream)[1] - 1] for _ in range(4)])
    q[:, -1] = [0, 1 << 21, (1 << 21) + 1, 5]
    q = q.astype(np.int32)
    tk, tv = kv.device_arrays("cpu")
    res = tstore.sharded_get(tk, tv, torch.from_numpy(q), method=method,
                             device="cpu")
    rf, rv = tstore.reference_get(kv, q.reshape(-1))
    assert bool(res.ok.all())
    np.testing.assert_array_equal(res.found.numpy().reshape(-1), rf)
    np.testing.assert_array_equal(res.values.numpy().reshape(-1, 3), rv)
    assert rf.sum() >= 40


def test_s4_capacity_drops_are_flagged(kv4):
    kv, keys = kv4
    q = np.stack([keys[i * 20:i * 20 + 20] for i in range(4)]).astype(
        np.int32)
    tk, tv = kv.device_arrays("cpu")
    res = tstore.sharded_get(tk, tv, torch.from_numpy(q), capacity=2,
                             device="cpu")
    ok = res.ok.numpy()
    assert 0 < ok.sum() < ok.size
    np.testing.assert_array_equal(res.dropped.numpy(),
                                  ok.shape[1] - ok.sum(axis=1))
    rf, rv = tstore.reference_get(kv, q.reshape(-1))
    np.testing.assert_array_equal(res.found.numpy().reshape(-1)[ok.ravel()],
                                  rf[ok.ravel()])
    assert not res.found.numpy()[~ok].any()


def test_sharded_get_guards(kv4, monkeypatch):
    kv, keys = kv4
    tk, tv = kv.device_arrays("cpu")
    q = torch.from_numpy(keys[None, :4].repeat(4, 0).astype(np.int32))
    # the isolation arm answers (GetResult, BucketState); a bucket deep
    # enough for the batch admits every request, as no admission does
    res, bucket = tstore.sharded_get(
        tk, tv, q, isolation=tstore.Admission(
            torch.zeros_like(q), tiso.init(1, 64.0, device="cpu"), 0.0,
            1.0, 64.0), device="cpu")
    plain = tstore.sharded_get(tk, tv, q, device="cpu")
    for a, b in zip(res, plain):
        assert torch.equal(a, b)
    assert float(bucket.tokens[0]) == 64.0 - q.numel()
    with pytest.raises(ValueError, match="both exp and now"):
        tstore.sharded_get(tk, tv, q, exp=tk, device="cpu")
    # a resize state selects the double-frame arm (at watermark 0 every
    # key still serves from the old frame)
    mid = tstore.sharded_get(tstore.begin_resize(tk, tv, device="cpu"), q,
                             device="cpu")
    steady = tstore.sharded_get(tk, tv, q, device="cpu")
    assert torch.equal(mid.found, steady.found)
    assert torch.equal(mid.values, steady.values)
    with pytest.raises(TypeError, match="positional"):
        tstore.sharded_get(tk, tv, q, "redn", 8, None, None, None, 5, 6,
                           device="cpu")
    with pytest.raises(ValueError, match="24-bit"):
        tstore.sharded_get(tk, tv, q - (1 << 30), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tstore.sharded_get(tk, tv, q)


def test_shard_of_and_keys_homed_at_match_jax():
    keys = np.asarray([0, 1, 2, 0xFFFFFF, -1, 2 ** 31 - 1, -2 ** 31],
                      np.int32)
    for s in (1, 3, 4, 7):
        want = np.asarray(jstore.shard_of(jnp.asarray(keys), s))
        np.testing.assert_array_equal(
            tstore.shard_of(torch.from_numpy(keys), s).numpy(), want)
        np.testing.assert_array_equal(tstore.shard_of(keys, s), want)
        for k in keys.tolist() + [2 ** 33 + 5]:
            assert tstore.shard_of(k, s) == jstore.shard_of(k, s)
    assert tstore.keys_homed_at(5, 4, 64, n_shards=4, shard=2) == \
        jstore.keys_homed_at(5, 4, 64, n_shards=4, shard=2)


# --- transport against loop oracles ------------------------------------------

def _rank_oracle(dest, live):
    out, seen = [], {}
    for d, lv in zip(dest.tolist(), live.tolist()):
        out.append(seen.get(d, 0))
        if lv:
            seen[d] = seen.get(d, 0) + 1
    return np.asarray(out, np.int32)


@pytest.mark.parametrize("seed", range(4))
def test_rank_within_dest_matches_loop_oracle(seed):
    rng = np.random.RandomState(seed)
    dest = rng.randint(0, 5, 64).astype(np.int32)
    live = rng.rand(64) < 0.7
    got = transport.rank_within_dest(torch.from_numpy(dest),
                                     torch.from_numpy(live))
    np.testing.assert_array_equal(got.numpy(), _rank_oracle(dest, live))
    got_all = transport.rank_within_dest(torch.from_numpy(dest))
    np.testing.assert_array_equal(got_all.numpy(),
                                  _rank_oracle(dest, np.ones(64, bool)))


@pytest.mark.parametrize("capacity", [1, 3, 16])
def test_dispatch_and_combine_match_loop_oracle(capacity):
    rng = np.random.RandomState(capacity)
    s, b, w = 3, 10, 2
    payload = rng.randint(1, 1000, (s, b, w)).astype(np.int32)
    dest = rng.randint(0, s, (s, b)).astype(np.int32)
    live = rng.rand(s, b) < 0.8
    recv, pos, ok = transport.dispatch(
        torch.from_numpy(payload), torch.from_numpy(dest), s, capacity,
        torch.from_numpy(live))
    want = np.zeros((s, s, capacity, w), np.int32)
    want_ok = np.zeros((s, b), bool)
    for src in range(s):
        p = _rank_oracle(dest[src], live[src])
        np.testing.assert_array_equal(pos[src].numpy(), p)
        for i in range(b):
            if live[src, i] and p[i] < capacity:
                want[dest[src, i], src, p[i]] = payload[src, i]
                want_ok[src, i] = True
    np.testing.assert_array_equal(recv.numpy(), want)
    np.testing.assert_array_equal(ok.numpy(), want_ok)
    # echo every slot back: served rows get their own payload, others zero
    back = transport.combine(recv, torch.from_numpy(dest), pos, ok)
    np.testing.assert_array_equal(back.numpy(),
                                  payload * want_ok[..., None])
