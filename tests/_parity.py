"""Helpers for the parity tests between the JAX package (``repro``) and the
PyTorch port (``repro_torch``): state crosses between them as numpy."""
import jax
import numpy as np

from repro.core import machine as jm
from repro_torch import convert

# one fixed multi-WQ geometry for the random programs, so JAX compiles each
# run once: an unmanaged WQ-order queue, a managed doorbell-order queue and
# a recycled completion-order queue, 6 WRs each, 4 message slots per WQ
RANDOM_SPEC = jm.MachineSpec(
    mem_words=512, wq_bases=(0, 48, 96), wq_sizes=(6, 6, 6),
    orderings=(0, 2, 1), managed=(False, True, True), msg_capacity=4)


def jax_fields(state) -> dict:
    return {f: np.asarray(getattr(state, f)) for f in jm.VMState._fields}


def to_torch(state, device="cpu"):
    """A JAX VMState (batched or not) as the port's, on ``device``."""
    return convert.vmstate_from_numpy(jax_fields(state), device)


def assert_states_equal(jax_state, torch_state, fields=None):
    """Every (or the named) VMState field bit-equal, clocks included."""
    got = convert.vmstate_to_numpy(torch_state)
    for f in fields or jm.VMState._fields:
        want = np.asarray(getattr(jax_state, f))
        assert got[f].dtype == want.dtype, (f, got[f].dtype, want.dtype)
        np.testing.assert_array_equal(got[f], want, err_msg=f)


def random_program_state(rng: np.random.RandomState):
    """A JAX VMState of RANDOM_SPEC with every WR slot random: opcodes
    0..14 (13 and 14 execute as HALT), fields that stray past both ends of
    the image, random queue counters and 0-3 delivered messages."""
    spec = RANDOM_SPEC
    L = spec.mem_words + jm.GUARD_WORDS
    img = rng.randint(-40, 600, size=spec.mem_words).astype(np.int32)
    for base, size in zip(spec.wq_bases, spec.wq_sizes):
        for slot in range(size):
            o = base + slot * 8
            img[o] = (rng.randint(0, 15) << 24) | rng.randint(0, 4)
            img[o + 1] = rng.randint(0, 2)
            img[o + 2] = rng.randint(-24, L + 8)
            img[o + 3] = rng.randint(-24, L + 8)
            img[o + 4] = rng.randint(-2, 19)
            img[o + 5] = rng.randint(-3, 8)
            img[o + 6] = rng.randint(-2, 4)
            img[o + 7] = rng.randint(-5, L + 8)
    st = jm.init_state(spec, img, rng.randint(0, 8, 3), rng.randint(0, 8, 3))
    for _ in range(rng.randint(0, 4)):
        st = jm.deliver(st, int(rng.randint(0, 3)),
                        rng.randint(-10, 600, rng.randint(1, 17)))
    return st


def stack(states):
    return jax.tree_util.tree_map(lambda *a: np.stack(a), *states)


_JAX_BUILDERS = ("build_hopscotch_server", "build_hopscotch_writer",
                 "build_multi_writer_group", "build_hopscotch_displacer",
                 "build_hopscotch_migrator", "build_hopscotch_deleter",
                 "build_clock_sweeper")


def fresh_jax_programs():
    """A generator fixture body: clear the JAX package's lru-cached program
    builders before and after a test module.  A program first built
    inside a ``shard_map`` trace keeps that mesh's axis names, and a later
    module of the same worker whose mesh names its axis otherwise then
    fails on it (ROADMAP queue 3); each module builds its own."""
    from repro.core import programs as jp

    def clear():
        for name in _JAX_BUILDERS:
            getattr(jp, name).cache_clear()
    clear()
    yield
    clear()
