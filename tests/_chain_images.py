"""Seeded single-WQ contexts for the managed chain kernel's hard cases,
numpy only: RECV scatters that rewrite their own scatter table or store
twice to one word, scatter tables clamped at the image's end, copies that
straddle the ring's edges and the image's end, and a chain that writes more
distinct words outside its ring than the kernel's write log holds.

``tests/test_torch_chain_vm.py`` holds the port's plain loop to JAX's on
them, ``tests/test_torch_gpu.py`` the kernel to the plain loop on the card.
Each case is ``(mems (n, m), msgs (n, CAP * 16), inits (n, 8), kw)``.
"""
import numpy as np

WR, MSG, CAP = 8, 16, 4
# opcodes and the control word's layout (repro_torch/core/isa.py)
NOOP, WRITE, WRITE_IMM, READ, SEND, RECV, CAS, ADD, MAX, MIN = range(10)
HALT = 12


def wr(op, src=0, dst=0, ln=0, opa=0, opb=0, aux=0, flags=0):
    return [op << 24, flags, src, dst, ln, opa, opb, aux]


def contexts(seed, m, wq_base, ring, n=3, n_wrs=None, laps=1, tables=(),
             payloads=None):
    """``n`` images of ``m`` words holding ``ring`` (lists of 8 words) at
    ``wq_base`` over seeded data, each scatter table of ``tables``
    ((address, [n, d0, d1, ...]), ...) written over both; the queue runs
    ``laps`` laps of ``len(ring)`` WRs with room for ``n_wrs`` slots.
    Messages: ``payloads`` (up to CAP lists of 16 words), else seeded."""
    rng = np.random.RandomState(seed)
    n_wrs = n_wrs or len(ring)
    mems = rng.randint(-20, m + 20, size=(n, m)).astype(np.int64)
    for s, w in enumerate(ring):
        mems[:, wq_base + WR * s:wq_base + WR * (s + 1)] = w
    for addr, words in tables:
        mems[:, addr:addr + len(words)] = words
    msgs = rng.randint(-20, m + 20, size=(n, CAP * MSG)).astype(np.int64)
    for k, p in enumerate(payloads or ()):
        msgs[:, k * MSG:k * MSG + len(p)] = p
    steps = laps * len(ring)
    inits = np.zeros((n, 8), np.int64)
    inits[:, 1] = steps                      # tail
    inits[:, 2] = steps                      # enable limit
    inits[:, 5] = CAP                        # messages staged
    inits[:, 6] = steps                      # fuel
    kw = dict(wq_base=wq_base, n_wrs=n_wrs, managed=True,
              max_steps=steps + 1)
    return (mems.astype(np.int32), msgs.astype(np.int32),
            inits.astype(np.int32), kw)


def fixed_steps(case, max_steps):
    """``case`` run for ``max_steps`` loop iterations (at least its own),
    so that cases of one queue geometry share one compiled loop."""
    mems, msgs, inits, kw = case
    assert max_steps >= kw["max_steps"]
    return mems, msgs, inits, dict(kw, max_steps=max_steps)


def recv_cases(m, wq_base, seed=0):
    """RECV scatters: the first store rewrites a later table entry (the
    next destination comes from the payload) and the count word; stores
    that land twice on one word (the last wins); a table inside the ring's
    unused slots; a table whose reads clamp at the image's last word; and
    a plain scatter to distinct words, which may run in parallel."""
    t = 100 if 2 * wq_base > m else m - 300     # a table outside the ring
    x, y = t + 40, t + 60
    ring_end = wq_base + WR * 8
    cases = {}
    # d0 = t + 2 rewrites d1 with payload[0] = x; d2 = t + 4 rewrites d3
    # with payload[2] = -5 (clamped to word 0); d4 = t, the count word
    pay = [[x, 11, -5, 13, 14, 15, 16] + [0] * 9,
           [y, 21, 22, 23, 24, 25, 26] + [0] * 9]
    ring = [wr(RECV, aux=t), wr(RECV, aux=t),
            wr(WRITE, src=t, dst=y + 8, ln=8), wr(HALT)]
    cases["recv_rewrites_its_table"] = contexts(
        seed, m, wq_base, ring, n_wrs=8,
        tables=[(t, [5, t + 2, t + 9, t + 4, t + 10, t])], payloads=pay)
    ring = [wr(RECV, aux=t), wr(WRITE, src=x, dst=y + 8, ln=4), wr(HALT)]
    cases["recv_duplicate_destinations"] = contexts(
        seed + 1, m, wq_base, ring, n_wrs=8,
        tables=[(t, [6, x, x, y, x, y + 1, y + 1])])
    a = wq_base + WR * 5                       # slots 5..7 never run
    ring = [wr(RECV, aux=a), wr(RECV, aux=a), wr(HALT)]
    cases["recv_table_in_the_ring"] = contexts(
        seed + 2, m, wq_base, ring, n_wrs=8,
        tables=[(a, [4, a + 2, ring_end - 1, x, a + 1])],
        payloads=[[a + 3, 7, 8, 9] + [0] * 12])
    ring = [wr(RECV, aux=m - 3), wr(RECV, aux=m - 1), wr(HALT)]
    cases["recv_table_at_the_image_end"] = contexts(
        seed + 3, m, wq_base, ring, n_wrs=8,
        tables=[(m - 3, [6, x, m - 1])])
    ring = [wr(RECV, aux=t), wr(RECV, aux=t), wr(HALT)]
    cases["recv_distinct_destinations"] = contexts(
        seed + 4, m, wq_base, ring, n_wrs=8,
        tables=[(t, [16] + [x + 2 * i for i in range(16)])])
    return cases


def copy_cases(m, wq_base, n_wrs=8, seed=0):
    """Copies across the ring's first and last words and the image's last
    16 (the block clamp), the scalar verbs' dropped and clamped words at
    the end, over two laps so the second runs the WRs the first rewrote."""
    lo, hi = wq_base, min(wq_base + WR * n_wrs, m)
    d = 100 if 2 * wq_base > m else m - 200     # data outside the ring
    ring = [wr(WRITE, src=lo - 5, dst=d, ln=16),
            wr(READ, src=hi - 7, dst=d + 20, ln=16),
            wr(WRITE, src=d + 40, dst=hi - 9, ln=12, flags=1),
            wr(READ, src=m - 3, dst=d + 60, ln=16),
            wr(WRITE, src=d, dst=m - 10, ln=16),
            wr(CAS, src=d + 80, dst=m + 5, opa=1, opb=2),
            wr(ADD, src=lo + 4, dst=m - 1, opa=7),
            wr(WRITE, src=d + 20, dst=lo - 3, ln=9)][:n_wrs]
    return {"copies_straddle_the_ring_and_the_end": contexts(
        seed, m, wq_base, ring, n_wrs=n_wrs, laps=2)}


def overflow_case(m, laps=(0, 20, 40, 80), seed=0):
    """One ring that copies 16 fresh words a lap to a region that moves on
    by 16 (WR 1 bumps WR 0's destination), copies them back out (WR 3
    bumps WR 2's source), and ADDs with return-old to two fixed words:
    ``laps`` laps write 16 * laps distinct words outside the ring, past
    the kernel's write log (512 entries) from 32 laps on.  Needs m > 416 +
    16 * laps."""
    src, reg, out, z = 40, 400, 200, 300
    ring = [wr(WRITE, src=src, dst=reg, ln=16),
            wr(ADD, dst=3, opa=16, src=-1),
            wr(WRITE, src=reg, dst=out, ln=16),
            wr(ADD, dst=WR * 2 + 2, opa=16, src=-1),
            wr(ADD, dst=z, opa=1, src=z + 1)]
    mems, msgs, inits, kw = contexts(seed, m, 0, ring, n=len(laps),
                                     laps=max(laps))
    inits[:, 1] = inits[:, 2] = np.asarray(laps) * len(ring)
    return {"log_overflow": (mems, msgs, inits, kw)}
