"""Fig. 12's list walk in the port (``build_list_traversal``, with and
without the §5.3 break) against the JAX package's: the list tests of
``tests/test_programs.py`` and ``tests/test_engine.py`` on the port, each
also held to JAX's values, steps and float32 ``total_time_us``, bit for
bit."""
import numpy as np
import pytest
import torch
from _hyp import given, settings, st

from _parity import assert_states_equal
from repro.core import machine as jm
from repro.core import programs as jp
from repro_torch.core import machine, programs


def build_both(n_iters, val_len=2, use_break=False, items=()):
    t = programs.build_list_traversal(n_iters=n_iters, val_len=val_len,
                                      use_break=use_break, device="cpu")
    j = jp.build_list_traversal(n_iters=n_iters, val_len=val_len,
                                use_break=use_break)
    for off in (t, j):
        off.set_list(items)
    return t, j


def get_both(t, j, key):
    """The port's ``get``, with its whole state held to JAX's."""
    val, out = t.get(key)
    jval, jout = j.get(key)
    np.testing.assert_array_equal(val, np.asarray(jval))
    assert_states_equal(jout, out)
    assert float(machine.total_time_us(out)) == float(jm.total_time_us(jout))
    return val, out


@pytest.mark.parametrize("use_break", [False, True])
def test_image_and_layout_equal_jax(use_break):
    t, j = build_both(8, use_break=use_break,
                      items=[(10 + i, [100 + i, 200 + i]) for i in range(8)])
    assert tuple(t.spec) == tuple(j.spec)
    assert (t.nodes_base, t.values_base, t.resp_region, t.recv_wq) == (
        j.nodes_base, j.values_base, j.resp_region, j.recv_wq)
    assert programs.NODE_WORDS == jp.NODE_WORDS
    assert_states_equal(j.materialize(), t.materialize())


@pytest.mark.parametrize("use_break", [False, True])
def test_list_traversal_finds_each_position(use_break):
    t, j = build_both(8, use_break=use_break,
                      items=[(10 + i, [100 + i, 200 + i]) for i in range(8)])
    for pos in [0, 3, 7]:
        val, _ = get_both(t, j, 10 + pos)
        assert val.tolist() == [100 + pos, 200 + pos], (pos, use_break)


@pytest.mark.parametrize("use_break", [False, True])
def test_list_traversal_miss(use_break):
    t, j = build_both(4, use_break=use_break,
                      items=[(10 + i, [i, i]) for i in range(4)])
    val, _ = get_both(t, j, 999)
    assert val.tolist() == [0, 0]


def test_list_break_saves_work():
    """§5.3: break stops iterations after the hit."""
    counts = {}
    for use_break in (False, True):
        t, j = build_both(8, use_break=use_break,
                          items=[(10 + i, [i, i]) for i in range(8)])
        _, out = get_both(t, j, 10)        # hit at position 0
        counts[use_break] = int(out.steps)
    assert counts[True] < counts[False]


def test_list_break_latency_overhead_on_full_walk():
    """Fig. 13: with the key at the end, +break costs extra latency."""
    lat = {}
    for use_break in (False, True):
        t, j = build_both(8, use_break=use_break,
                          items=[(10 + i, [i, i]) for i in range(8)])
        val, out = get_both(t, j, 17)      # hit at last position
        assert val.tolist() == [7, 7]
        lat[use_break] = float(machine.total_time_us(out))
    assert lat[True] > lat[False]


@settings(max_examples=10, deadline=None)
@given(st.data())
def test_list_traversal_matches_python(data):
    n = data.draw(st.integers(2, 8))
    keys = data.draw(st.lists(st.integers(1, 10000), min_size=n, max_size=n,
                              unique=True))
    use_break = data.draw(st.booleans())
    items = [(k, [k % 97, k % 89]) for k in keys]
    t, j = build_both(n, use_break=use_break, items=items)
    probe = data.draw(st.sampled_from(keys + [20001]))
    val, _ = get_both(t, j, probe)
    want = next((v for k, v in items if k == probe), [0, 0])
    assert val.tolist() == want


@pytest.mark.parametrize("use_break", [False, True])
def test_list_get_many_matches_sequential(use_break):
    t, j = build_both(6, use_break=use_break,
                      items=[(20 + i, [i, i * 3]) for i in range(6)])
    keys = [20, 23, 999, 25, 20]
    seq = [t.get(k)[0].tolist() for k in keys]
    vals, out = t.get_many(keys)
    assert vals.tolist() == seq
    jvals, jout = j.get_many(keys)
    np.testing.assert_array_equal(vals, np.asarray(jvals))
    assert_states_equal(jout, out)
    np.testing.assert_array_equal(machine.total_time_us(out).numpy(),
                                  np.asarray(jm.total_time_us(jout)))


def test_materialize_leaves_the_built_image_alone():
    t, _ = build_both(4, items=[(5, [1, 2])])
    st = t.materialize()
    assert int(st.mem[t.node_addr(0)]) == 5
    assert int(t.state0.mem[t.node_addr(0)]) == 0
    assert st.mem.device.type == "cpu"


def test_build_list_traversal_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        programs.build_list_traversal(n_iters=2)
