"""Seeded multi-WQ machines for the chain interpreter kernel's hard cases,
numpy only (the card's tests use it too):

* WAIT across WQs, ENABLE raising a managed WQ's watermark, completions
  suppressed by a WR's flag;
* a peer SEND followed by the target's RECV, client messages, a RECV
  scatter that rewrites its own table, tables past the image's end;
* tied clocks (the lowest WQ wins), set clocks and a head past 0, an
  eligible WQ at a clock of +inf (the lowest WQ runs, eligible or not);
* opcodes 13..127 (executed as HALT) and control words whose high bits
  mask to a verb (0x85 -> RECV, 0x8A -> WAIT), negative ones included;
* negative and past-the-end destinations, copies that straddle the
  image's end, wrapping ADDs, CAS returning the old value onto itself;
* recycled WQs (tail past the ring) over WRs the chain rewrote;
* fault rows of all four kinds, and two-writer schedules with quotas,
  skipped writers and drains;
* the shared window (:data:`WINDOW`, the words a split batch keeps once an
  image): copy blocks that straddle its ends, negative addresses that wrap
  into it, stores past the image, return-old and plain stores of the value
  a window word holds (:func:`window_machines`), and stores that would
  change a window word, one of them taken back by a later store
  (:func:`window_raisers`).

Every machine has one geometry, :data:`SPEC` (so each entry point of the
JAX package compiles once).  A machine is a dict of the ``VMState``
fields as numpy arrays; :func:`stack` batches them.
``tests/test_torch_interp_kernel.py`` holds the port's interpreter to
JAX's on them, ``tests/test_torch_gpu.py`` the kernel to the plain loop
on the card.
"""
import numpy as np

WR, MSG, GUARD, NUM_OPCODES = 8, 16, 16, 13
(NOOP, WRITE, WRITE_IMM, READ, SEND, RECV, CAS, ADD, MAX, MIN, WAIT, ENABLE,
 HALT) = range(13)
FIELDS = ("mem", "head", "tail", "enable_limit", "completions",
          "last_comp_time", "msg_buf", "msg_head", "msg_tail", "clock",
          "steps", "halted", "verb_counts", "responses")

# (mem_words, WR bases, WR slots, orderings, managed, message slots): four
# WQs of six slots, WQ-, doorbell-, completion- and WQ-ordered, the second
# and fourth ENABLE-gated; data in [256, 512)
SPEC = (512, (0, 64, 128, 192), (6, 6, 6, 6), (0, 2, 1, 0),
        (False, True, False, True), 4)
MEM, BASES, SIZES, ORDERINGS, MANAGED, CAP = SPEC
N = len(BASES)
L = MEM + GUARD                        # the image with its guard words
DATA = 256
# the schedules' writers: WQs 0-1 and 2-3
SLICES = ((0, 2), (2, 4))
MAX_STEPS = 40
# a split batch's shared window: data words only
WINDOW = (300, 400)


def i32(x: int) -> int:
    """``x`` wrapped to int32."""
    return int(np.array(x & 0xFFFFFFFF, np.uint32).view(np.int32))


def wr(op, src=0, dst=0, ln=0, opa=0, opb=0, aux=0, flags=0, ident=0):
    """One WR's 8 words; ``op`` may take the control byte's high bit."""
    return [i32(((op & 0xFF) << 24) | (ident & 0xFFFFFF)), flags, src, dst,
            ln, opa, opb, aux]


def machine(rng, queues, tails, enables, messages=(), data=(), **fields):
    """One machine over a seeded data image: ``queues`` (a list of WRs per
    WQ, the rest of each ring NOOPs), ``data`` ((address, words), ...)
    written over the image, ``messages`` ((wq, payload), ...) delivered in
    order, and ``fields`` replacing initial counters or clocks."""
    img = rng.randint(-40, L + 40, size=L).astype(np.int64)
    img[MEM:] = 0
    for base, size, wrs in zip(BASES, SIZES, queues):
        ring = list(wrs) + [wr(NOOP)] * (size - len(wrs))
        img[base:base + size * WR] = np.asarray(ring[:size]).reshape(-1)
    for addr, words in data:
        img[addr:addr + len(words)] = words
    st = dict(mem=img.astype(np.int32), head=np.zeros(N, np.int32),
              tail=np.asarray(tails, np.int32),
              enable_limit=np.asarray(enables, np.int32),
              completions=np.zeros(N, np.int32),
              last_comp_time=np.zeros(N, np.float32),
              msg_buf=np.zeros((N, CAP, MSG), np.int32),
              msg_head=np.zeros(N, np.int32), msg_tail=np.zeros(N, np.int32),
              clock=np.zeros(N, np.float32), steps=np.int32(0),
              halted=np.bool_(False),
              verb_counts=np.zeros(NUM_OPCODES, np.int32),
              responses=np.int32(0))
    for name, value in fields.items():
        st[name] = np.asarray(value, st[name].dtype).reshape(
            st[name].shape)
    for wq, payload in messages:
        slot = st["msg_tail"][wq] % CAP
        st["msg_buf"][wq, slot, :len(payload)] = payload
        st["msg_tail"][wq] += 1
    return st


def stack(machines) -> dict:
    return {f: np.stack([m[f] for m in machines]) for f in FIELDS}


def hazards(seed: int = 0) -> list:
    """The hand-made machines, each over a seeded image."""
    rng = np.random.RandomState(seed)
    out = []
    # WAIT across WQs, ENABLE of managed WQs, a suppressed completion
    out.append(machine(rng, [
        [wr(WRITE, src=300, dst=320, ln=5), wr(ADD, src=331, dst=330, opa=7),
         wr(ENABLE, opb=1, opa=2), wr(NOOP, flags=1), wr(ENABLE, opb=3,
                                                         opa=1)],
        [wr(WRITE_IMM, dst=340, opa=11), wr(CAS, dst=341, opa=5, opb=9,
                                             src=342), wr(HALT)],
        [wr(WAIT, opa=3, opb=0), wr(READ, src=320, dst=350, ln=5),
         wr(WAIT, opa=2, opb=1), wr(WAIT, opa=5, opb=0),
         wr(WRITE_IMM, dst=360, opa=1)],
        [wr(WRITE_IMM, dst=370, opa=4), wr(MAX, dst=371, opa=50)]],
        tails=(5, 3, 5, 2), enables=(0, 0, 0, 0),
        data=[(341, [5])]))
    # a peer SEND, then the target's RECV through a table that rewrites
    # itself (entry 1 stores over entry 2's destination); a client message
    # first; a table past the image's end; a response SEND
    payload = list(range(400, 416))
    payload[1] = 420                     # entry 2 then stores at 420
    out.append(machine(rng, [
        [wr(SEND, src=300, opb=2), wr(SEND, src=-7, opb=3),
         wr(SEND, src=310, dst=380, ln=4, opb=-1), wr(SEND, src=L - 3,
                                                       opb=2)],
        [wr(RECV, aux=L + 5), wr(WRITE, src=250, dst=L - 9, ln=16)],
        [wr(RECV, aux=440), wr(RECV, aux=450), wr(RECV, aux=460),
         wr(WRITE_IMM, dst=470, opa=3)],
        [wr(RECV, aux=-20), wr(RECV, aux=440)]],
        tails=(4, 2, 4, 2), enables=(0, 1, 0, 2),
        messages=[(2, [7, 8, 9]), (1, [500, 501])],
        data=[(300, payload), (440, [3, 480, 442, 490]),
              (450, [20, 452, 453, -5, 460, 461]),
              (460, [-2, 300]), (L - 1, [2])]))
    # tied clocks, set clocks, a head past 0, high and masked opcodes
    out.append(machine(rng, [
        [wr(13), wr(WRITE_IMM, dst=300, opa=1)],
        [wr(0x85, aux=440), wr(127)],
        [wr(0x8A, opa=1, opb=3), wr(0xFE)],
        [wr(WRITE_IMM, dst=301, opa=2), wr(NOOP), wr(64)]],
        tails=(2, 2, 2, 3), enables=(0, 2, 0, 3),
        messages=[(1, [11, 12])], data=[(440, [1, 445])],
        clock=[0.5, 0.5, 0.0, 0.0], head=[0, 0, 0, 1]))
    # edges: negative and past-the-end destinations, straddling copies,
    # dropped stores, wrapping ADDs, CAS returning onto its own word
    out.append(machine(rng, [
        [wr(WRITE, src=L - 4, dst=-5, ln=16), wr(WRITE, src=-3, dst=L + 3,
                                                 ln=9),
         wr(WRITE_IMM, dst=L + 2, opa=5), wr(WRITE_IMM, dst=L - 1, opa=6),
         wr(READ, src=L + 100, dst=-100, ln=20), wr(WRITE, src=3, dst=4,
                                                     ln=-3)],
        [wr(ADD, dst=300, opa=2 ** 31 - 3, src=-1), wr(ADD, dst=300, opa=9,
                                                         src=301),
         wr(CAS, dst=302, opa=77, opb=-8, src=302), wr(CAS, dst=303, opa=1,
                                                        src=L + 4),
         wr(MAX, dst=-9, opa=3), wr(MIN, dst=L + 1, opa=-3)],
        [wr(ADD, dst=-1, opa=-2 ** 31, src=L - 1)],
        [wr(WRITE_IMM, dst=-L - 7, opa=1)]],
        tails=(6, 6, 1, 1), enables=(0, 6, 0, 1),
        data=[(300, [2 ** 31 - 1, 0, 77, 1])]))
    # recycled WQs over WRs the chain rewrites (self-modifying chains)
    out.append(machine(rng, [
        [wr(WRITE_IMM, dst=8 * 2 + 5, opa=9),
         wr(WRITE, src=320, dst=64, ln=8), wr(ADD, dst=330, opa=1)],
        [wr(WRITE_IMM, dst=331, opa=1), wr(ENABLE, opb=1, opa=9)],
        [wr(ADD, dst=332, opa=1), wr(WRITE_IMM, dst=128, opa=i32(HALT << 24))],
        [wr(WAIT, opa=2, opb=2), wr(ENABLE, opb=3, opa=12)]],
        tails=(14, 7, 9, 12), enables=(0, 2, 0, 2),
        data=[(320, wr(ADD, dst=333, opa=5))]))
    # an eligible WQ whose clock is +inf: every key ties at +inf, so the
    # lowest WQ runs, here one with no work, from its own head past 0
    out.append(machine(rng, [
        [wr(NOOP), wr(WRITE_IMM, dst=380, opa=5), wr(ADD, dst=381, opa=1)],
        [wr(WRITE_IMM, dst=382, opa=7)],
        [wr(WRITE_IMM, dst=383, opa=6), wr(ADD, dst=383, opa=2)],
        [wr(HALT)]],
        tails=(1, 1, 2, 0), enables=(0, 0, 0, 0),
        head=[1, 0, 0, 0], clock=[0.0, 0.0, np.inf, 0.0]))
    return out


def random_machine(rng) -> dict:
    """A machine of random WRs: opcodes mostly 0..12, some 13..255,
    fields that stray past both ends of the image, WAIT and ENABLE
    targets past both ends of the WQs, recycling tails, random heads,
    clocks and messages."""
    queues = []
    for size in SIZES:
        ring = []
        for _ in range(size):
            op = (rng.randint(0, NUM_OPCODES) if rng.rand() < 0.85
                  else rng.randint(13, 256))
            ring.append(wr(op, src=rng.randint(-24, L + 8),
                           dst=rng.randint(-24, L + 8),
                           ln=rng.randint(-2, 19), opa=rng.randint(-3, 8),
                           opb=rng.randint(-2, N + 2),
                           aux=rng.randint(-5, L + 8),
                           flags=int(rng.rand() < 0.2),
                           ident=rng.randint(0, 4)))
        queues.append(ring)
    head = rng.randint(0, 3, N)
    messages = [(int(rng.randint(0, N)), rng.randint(-10, L + 10,
                                                      rng.randint(1, 17)))
                for _ in range(rng.randint(0, 5))]
    return machine(rng, queues, tails=head + rng.randint(0, 11, N),
                   enables=head + rng.randint(0, 8, N), messages=messages,
                   head=head,
                   clock=rng.choice([0.0, 0.5, 1.21, 2.0], N),
                   last_comp_time=rng.choice([0.0, 1.0, 3.5], N))


def random_machines(seed: int, n: int) -> list:
    rng = np.random.RandomState(seed)
    return [random_machine(rng) for _ in range(n)]


def fault_rows(seed: int, n: int) -> np.ndarray:
    """(n, 4) int32 fault rows (kill, suppress, cas, enable), each slot
    armed at random (small enough to fire) or -1."""
    rng = np.random.RandomState(seed)
    hi = (14, 14, 3, 3)
    rows = np.stack([np.where(rng.rand(n) < 0.5, rng.randint(0, h, n), -1)
                     for h in hi], axis=1)
    return rows.astype(np.int32)


def quotas(seed: int, n: int, rounds: int = 4) -> np.ndarray:
    """(n, rounds, 2) int32 quotas of the two writers of :data:`SLICES`:
    steps, 0 (skip) or -1 (drain), and a last round that drains both."""
    rng = np.random.RandomState(seed)
    q = rng.choice([-1, 0, 0, 1, 2, 3, 5], size=(n, rounds, 2))
    q[:, -1] = -1
    return q.astype(np.int32)


def corpus(seed: int = 0, n_random: int = 24) -> dict:
    """The hazards and ``n_random`` random machines, stacked."""
    return stack(hazards(seed) + random_machines(seed, n_random))


def window_machines(seed: int = 0) -> list:
    """Machines whose runs read the words of :data:`WINDOW` and change
    none of them: copy blocks straddling ``lo`` and ``hi`` (read, and
    copied onto themselves), negative addresses wrapping into the window,
    stores past the image, a WRITE_IMM, a CAS's and an ADD's return-old
    store of the value the window word holds, RECV tables and a SEND
    payload in the window."""
    rng = np.random.RandomState(seed)
    lo, hi = WINDOW
    out = []
    out.append(machine(rng, [
        [wr(WRITE, src=lo - 8, dst=440, ln=16),
         wr(READ, src=hi - 8, dst=456, ln=16),
         wr(WRITE, src=lo - 4, dst=lo - 4, ln=16),
         wr(WRITE, src=hi - 8, dst=hi - 8, ln=16),
         wr(WRITE, src=472, dst=lo - 16, ln=16),
         wr(WRITE_IMM, dst=L + 3, opa=9)],
        [wr(READ, src=305 - L, dst=480, ln=8),
         wr(WRITE, src=320 - L, dst=320 - L, ln=5),
         wr(WRITE_IMM, dst=330, opa=41),
         wr(CAS, dst=488, opa=77, opb=5, src=350),
         wr(ADD, dst=489, opa=3, src=351),
         wr(MAX, dst=L + 100, opa=1)],
        [wr(RECV, aux=360), wr(RECV, aux=370),
         wr(WRITE, src=L + 100, dst=L + 50, ln=16)],
        [wr(SEND, src=hi - 5, opb=2), wr(READ, src=lo - 3, dst=-L - 9,
                                         ln=16)]],
        tails=(6, 6, 3, 2), enables=(0, 6, 0, 2),
        messages=[(2, [1000, 1001, 1002])],
        data=[(330, [41]), (350, [77, 12]), (488, [77, 12]),
              (360, [2, 490, 491]), (370, [1, 495])]))
    # the same reads under other clocks, and an eligible WAIT on a window
    # word's completion count (the WR fields all private)
    out.append(machine(rng, [
        [wr(WRITE, src=hi - 1, dst=505, ln=4), wr(ADD, dst=501, opa=-7)],
        [wr(WAIT, opa=1, opb=0), wr(WRITE, src=lo, dst=lo, ln=16)],
        [wr(CAS, dst=502, opa=0, opb=1, src=lo + 2)],
        [wr(WRITE_IMM, dst=hi, opa=3), wr(WRITE_IMM, dst=lo - 1, opa=4)]],
        tails=(2, 2, 1, 2), enables=(0, 2, 0, 2),
        data=[(lo + 2, [0]), (502, [0])],
        clock=[0.5, 0.0, 1.21, 0.0]))
    return out


def window_raisers(seed: int = 0) -> list:
    """Machines each of whose runs makes a store that would change a word
    of :data:`WINDOW`, in its first step: an ADD's return-old store, a RECV
    scatter, a copy straddling ``hi``, a CAS that swaps, and a WRITE_IMM
    whose change the next WRITE_IMM takes back (the window ends as it
    began, and the run is refused all the same)."""
    rng = np.random.RandomState(seed)
    lo, hi = WINDOW
    nothing = [[], [], [], []]
    cases = [
        ([wr(ADD, dst=450, opa=1, src=352)], [(352, [5]), (450, [9])]),
        ([wr(RECV, aux=460)], [(460, [1, 350]), (350, [7])]),
        ([wr(WRITE, src=440, dst=hi - 4, ln=10)],
         [(440, list(range(1, 11))), (hi - 4, [0] * 10)]),
        ([wr(CAS, dst=lo + 40, opa=6, opb=8, src=470)], [(lo + 40, [6])]),
        ([wr(WRITE_IMM, dst=lo + 60, opa=99), wr(WRITE_IMM, dst=lo + 60,
                                                  opa=5)],
         [(lo + 60, [5])]),
    ]
    out = []
    for wrs, data in cases:
        queues = [list(q) for q in nothing]
        queues[2 if wrs[0][0] >> 24 == RECV else 0] = wrs
        out.append(machine(rng, queues, tails=(len(queues[0]), 0,
                                               len(queues[2]), 0),
                           enables=(0, 0, 0, 0), data=data,
                           messages=[(2, [123])]))
    return out


def repeat(machines, per: int) -> list:
    """Each machine ``per`` times, the copies at other clocks (rows of one
    image in a split batch)."""
    out = []
    for m in machines:
        for i in range(per):
            c = {f: np.array(a, copy=True) for f, a in m.items()}
            c["clock"] = c["clock"] + np.float32(0.25 * i)
            out.append(c)
    return out
