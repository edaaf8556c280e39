"""Parity of the PyTorch port's chain-VM core with the JAX package: ISA and
cost tables, the five ported program builders, the interpreter (every
VMState field after k steps, clocks bit-equal), the batched entry points,
and the engine."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _parity import (RANDOM_SPEC, assert_states_equal, jax_fields,
                     random_program_state, stack, to_torch)
from repro.core import cost as jcost
from repro.core import isa as jisa
from repro.core import machine as jm
from repro.core import programs as jp
from repro.core.engine import ChainEngine as JEngine
from repro_torch import convert
from repro_torch.core import analysis as tanalysis
from repro_torch.core import assembler as tasm
from repro_torch.core import cost as tcost
from repro_torch.core import isa as tisa
from repro_torch.core import machine as tm
from repro_torch.core import programs as tp
from repro_torch.core.engine import ChainEngine as TEngine


# --- ISA and cost tables ---------------------------------------------------

def test_isa_constants_equal():
    names = [n for n in dir(jisa) if n.isupper()]
    assert names and all(hasattr(tisa, n) for n in names)
    for n in names:
        assert getattr(tisa, n) == getattr(jisa, n), n
    for op in range(jisa.NUM_OPCODES):
        for id_ in (0, 1, 0xFFFFFF, 0x1234567, -1):
            assert tisa.pack_ctrl(op, id_) == jisa.pack_ctrl(op, id_)
            c = jisa.pack_ctrl(op, id_)
            assert tisa.unpack_opcode(c) == jisa.unpack_opcode(c)
            assert tisa.unpack_id(c) == jisa.unpack_id(c)


def test_cost_tables_bit_equal():
    for name in ("FETCH_BY_ORDERING", "EXEC_COST"):
        a, b = getattr(tcost, name), getattr(jcost, name)
        assert a.dtype == b.dtype == np.float32
        assert a.tobytes() == b.tobytes(), name
    assert tcost.DOORBELL_BASE == jcost.DOORBELL_BASE
    assert np.float32(tcost.DOORBELL_BASE) == np.float32(jcost.DOORBELL_BASE)
    for name in ("NET_ONE_WAY", "VERB_RATE", "PUS", "TABLE3_THROUGHPUT",
                 "PIPELINED_VERB_COST", "IB_BW_GBPS", "PCIE3_X16_GBPS"):
        assert getattr(tcost, name) == getattr(jcost, name), name
    ops = [jisa.WRITE, jisa.READ, jisa.CAS, jisa.NOOP]
    for ordering in range(3):
        assert (tcost.chain_latency_us(ops, ordering, net_hops=2)
                == jcost.chain_latency_us(ops, ordering, net_hops=2))


# --- builders: equal spec, word-identical image ------------------------------

def _built(name):
    """(jax (spec, state), port (spec, state)) from the same builder call."""
    if name == "rpc_echo":
        j, t = jp.build_rpc_echo(), tp.build_rpc_echo(device="cpu")
        return j[:2], t[:2]
    if name.startswith("hash_lookup"):
        par = name.endswith("parallel")
        j = jp.build_hash_lookup(n_buckets=16, val_len=2, parallel=par)
        t = tp.build_hash_lookup(n_buckets=16, val_len=2, parallel=par,
                                 device="cpu")
        return (j.spec, j.state0), (t.spec, t.state0)
    if name == "hopscotch_server":
        j = jp.build_hopscotch_server(64, 2, 8)
        t = tp.build_hopscotch_server(64, 2, 8, device="cpu")
        assert (j.table_base, j.values_base, j.resp_region, j.recv_wq) == \
            (t.table_base, t.values_base, t.resp_region, t.recv_wq)
        return (j.spec, j.state0), (t.spec, t.state0)
    j = jp.build_recycled_get_server(n_buckets=32, val_len=2)
    t = tp.build_recycled_get_server(n_buckets=32, val_len=2, device="cpu")
    assert (j.table_base, j.values_base, j.resp_region, j.loop_wq,
            j.laps_addr) == (t.table_base, t.values_base, t.resp_region,
                             t.loop_wq, t.laps_addr)
    return (j.spec, j.state), (t.spec, t.state)


BUILDERS = ["rpc_echo", "hash_lookup_parallel", "hash_lookup_seq",
            "hopscotch_server", "recycled_get_server"]


@pytest.mark.parametrize("name", BUILDERS)
def test_builder_spec_and_image_equal(name):
    (jspec, jst), (tspec, tst) = _built(name)
    assert tuple(tspec) == tuple(jspec)
    assert convert.spec_from_tuple(jspec) == tspec
    assert_states_equal(jst, tst)


def test_program_budget_and_verify():
    jprog = jp.build_hash_lookup(n_buckets=8).prog
    tprog = tp.build_hash_lookup(n_buckets=8, device="cpu").prog
    assert tprog.budget() == jprog.budget()
    # the hash lookup's response arms race unless their waiver is given
    with pytest.raises(tanalysis.VerificationError):
        tprog.finalize(verify=True, device="cpu")
    p = tasm.Program(16)
    p.add_wq(4)                       # 32 code words in a 16-word image
    with pytest.raises(ValueError, match="collides"):
        p.finalize(device="cpu")


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tp.build_rpc_echo()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tp.build_hopscotch_server(16, 2, 4)


# --- the interpreter on random multi-WQ programs ----------------------------

def _random_batch(seed, n=24):
    rng = np.random.RandomState(seed)
    return stack([random_program_state(rng) for _ in range(n)])


@pytest.mark.parametrize("k", [1, 2, 5, 13, 400])
def test_run_batch_random_programs_every_field_after_k_steps(k):
    batch = _random_batch(0)
    want = jm.run_batch(RANDOM_SPEC, batch, k)
    got = tm.run_batch(convert.spec_from_tuple(RANDOM_SPEC), to_torch(batch),
                       k)
    assert_states_equal(want, got)


def test_run_unbatched_and_step_match():
    rng = np.random.RandomState(1)
    tspec = convert.spec_from_tuple(RANDOM_SPEC)
    for _ in range(6):
        st = random_program_state(rng)
        assert_states_equal(jm.run(RANDOM_SPEC, st, 400),
                            tm.run(tspec, to_torch(st), 400))
        js, ts = st, to_torch(st)
        for _ in range(4):
            js, ts = jm.step(RANDOM_SPEC, js), tm.step(tspec, ts)
            assert_states_equal(js, ts)
            assert bool(tm.quiescent(tspec, ts)) == bool(
                jm.quiescent(RANDOM_SPEC, js))
        assert float(tm.total_time_us(ts)) == float(jm.total_time_us(js))


def test_run_does_not_mutate_its_input():
    st = random_program_state(np.random.RandomState(2))
    ts = to_torch(st)
    before = convert.vmstate_to_numpy(ts)
    tm.run(convert.spec_from_tuple(RANDOM_SPEC), ts, 400)
    for f, v in convert.vmstate_to_numpy(ts).items():
        np.testing.assert_array_equal(v, before[f])


@pytest.mark.parametrize("k", [3, 20, 60])
def test_hopscotch_server_run_many_after_k_steps(k):
    jsrv = jp.build_hopscotch_server(64, 2, 8)
    tsrv = tp.build_hopscotch_server(64, 2, 8, device="cpu")
    rng = np.random.RandomState(3)
    keys = np.zeros(64, np.int32)
    keys[rng.choice(64, 40, replace=False)] = rng.randint(1, 1 << 20, 40)
    vals = rng.randint(-1000, 1000, (64, 2)).astype(np.int32)
    q = np.concatenate([keys[keys != 0][:10], [0, 5, 1 << 21]]).astype(
        np.int32)
    home = np.array(jp.bucket_home(jnp.asarray(q), 64))
    np.testing.assert_array_equal(
        tp.bucket_home(torch.from_numpy(q), 64).numpy(), home)
    jst = jsrv.device_state(jnp.asarray(keys), jnp.asarray(vals))
    tst = tsrv.device_state(torch.from_numpy(keys), torch.from_numpy(vals))
    assert_states_equal(jst, tst)
    jpay = jsrv.device_payloads(jnp.asarray(q), jnp.asarray(home))
    tpay = tsrv.device_payloads(torch.from_numpy(q), torch.from_numpy(home))
    np.testing.assert_array_equal(tpay.numpy(), np.asarray(jpay))
    want = JEngine.for_spec(jsrv.spec).run_many(jst, jsrv.recv_wq, jpay, k)
    got = TEngine.for_spec(tsrv.spec).run_many(tst, tsrv.recv_wq, tpay, k)
    assert_states_equal(want, got)


# --- batched entry points ---------------------------------------------------

def test_deliver_many_matches_jax():
    st = random_program_state(np.random.RandomState(4))
    pays = np.random.RandomState(5).randint(-9, 99, (5, 7)).astype(np.int32)
    want = jm.deliver_many(st, 2, pays)
    got = tm.deliver_many(to_torch(st), 2, torch.from_numpy(pays))
    assert_states_equal(want, got)
    with pytest.raises(ValueError):
        tm.deliver_many(to_torch(st), 2, np.zeros((2, 17), np.int32))


def test_grouped_deliver_many_stacks_one_machine_per_group():
    rng = np.random.RandomState(6)
    sts = [random_program_state(rng) for _ in range(3)]
    pays = rng.randint(-9, 99, (3, 4, 5)).astype(np.int32)
    got = tm.deliver_many(to_torch(stack(sts)), 1, torch.from_numpy(pays))
    want = stack([jax_fields(jm.deliver_many(s, 1, p))
                  for s, p in zip(sts, pays)])
    got = convert.vmstate_to_numpy(got)
    for f, v in want.items():
        np.testing.assert_array_equal(got[f], v.reshape((12,) + v.shape[2:]),
                                      err_msg=f)


def test_ring_and_enable_match_jax():
    st = random_program_state(np.random.RandomState(7))
    assert_states_equal(jm.ring(st, 1, 3), tm.ring(to_torch(st), 1, 3))
    assert_states_equal(jm.enable(st, 2, 9), tm.enable(to_torch(st), 2, 9))


@pytest.mark.parametrize("parallel", [True, False])
def test_hash_get_and_get_many_match_jax(parallel):
    joff = jp.build_hash_lookup(n_buckets=16, val_len=2, parallel=parallel)
    toff = tp.build_hash_lookup(n_buckets=16, val_len=2, parallel=parallel,
                                device="cpu")
    for k in range(1, 30):
        assert joff.insert(k, [k, 7 * k]) == toff.insert(k, [k, 7 * k])
    keys = [1, 2, 17, 29, 31, 99]
    jv, jout = joff.get_many(keys)
    tv, tout = toff.get_many(keys)
    np.testing.assert_array_equal(tv, jv)
    assert_states_equal(jout, tout)
    jv1, jst = joff.get(17)
    tv1, tst = toff.get(17)
    np.testing.assert_array_equal(tv1, jv1)
    assert_states_equal(jst, tst)


def test_rpc_echo_run_matches_jax():
    jspec, jst, ji = jp.build_rpc_echo()
    tspec, tst, ti = tp.build_rpc_echo(device="cpu")
    for arg in (5, -3):
        js = jm.deliver(jst, ji["recv_wq"], [arg])
        ts = tm.deliver(tst, ti["recv_wq"], [arg])
        for k in (1, 3, 100):
            assert_states_equal(jm.run(jspec, js, k), tm.run(tspec, ts, k))


def test_recycled_serve_stream_and_serve_match_jax():
    jsrv = jp.build_recycled_get_server(n_buckets=8, val_len=2)
    tsrv = tp.build_recycled_get_server(n_buckets=8, val_len=2, device="cpu")
    for k in range(1, 7):
        jsrv.insert(k, [k * 11, k * 11 + 1])
        tsrv.insert(k, [k * 11, k * 11 + 1])
    jsrv.load()
    tsrv.load()
    keys = [1, 3, 100, 6, 2, 9]
    np.testing.assert_array_equal(tsrv.serve_many(keys),
                                  jsrv.serve_many(keys))
    assert_states_equal(jsrv.state, tsrv.state)
    np.testing.assert_array_equal(tsrv.serve(4), jsrv.serve(4))
    assert_states_equal(jsrv.state, tsrv.state)
    tv, tst = tsrv.get_many([])
    assert tv.shape == (0, 2)


def test_run_many_fresh_fuel_on_reused_state():
    jsrv = jp.build_recycled_get_server(n_buckets=8, val_len=2)
    tsrv = tp.build_recycled_get_server(n_buckets=8, val_len=2, device="cpu")
    jsrv.insert(1, [5, 6])
    tsrv.insert(1, [5, 6])
    jsrv.load()
    tsrv.load()
    jst = jsrv.state._replace(steps=jnp.asarray(60, jnp.int32))
    tst = tsrv.state._replace(steps=torch.tensor(60, dtype=torch.int32))
    pay = np.asarray([[1, jsrv.bucket_addr(1)]] * 2, np.int32)
    want = JEngine.for_spec(jsrv.spec).run_many(jst, jsrv.loop_wq, pay, 64)
    got = TEngine.for_spec(tsrv.spec).run_many(tst, tsrv.loop_wq, pay, 64)
    assert_states_equal(want, got)


# --- the engine ---------------------------------------------------------------

def test_engine_for_spec_lru_and_stats():
    TEngine.cache_clear()
    spec = convert.spec_from_tuple(RANDOM_SPEC)
    e1 = TEngine.for_spec(spec)
    assert TEngine.for_spec(spec) is e1
    assert TEngine.for_spec(spec, "interp") is e1
    st = TEngine.cache_stats()
    assert (st["hits"], st["misses"], st["size"], st["limit"]) == (2, 1, 1, 64)
    for i in range(70):
        TEngine.for_spec(spec._replace(mem_words=1000 + i))
    st = TEngine.cache_stats()
    assert st["size"] == 64 and st["evictions"] == 7
    TEngine.cache_clear()
    assert TEngine.cache_stats()["size"] == 0


def test_engine_rejects_unknown_backend_and_multi_wq_kernel():
    spec = convert.spec_from_tuple(RANDOM_SPEC)
    with pytest.raises(ValueError, match="unknown backend"):
        TEngine(spec, "pallas")
    with pytest.raises(ValueError, match="single-WQ"):
        TEngine(spec, "kernel")


def test_engine_run_batch_matches_jax():
    batch = _random_batch(8, n=6)
    want = JEngine(RANDOM_SPEC).run_batch(batch, 50)
    got = TEngine(convert.spec_from_tuple(RANDOM_SPEC)).run_batch(
        to_torch(batch), 50)
    assert_states_equal(want, got)
