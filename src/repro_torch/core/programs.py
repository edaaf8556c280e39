"""RedN offload programs: the paper's use-cases as verb chains (the port's
``repro.core.programs``, GET servers first).

* :func:`build_rpc_echo` — Fig. 3's offloaded RPC handler: a client SEND
  triggers a pre-posted RECV whose scatter list injects the argument into
  the posted chain (self-modifying, data-dependent execution).
* :class:`HashLookupOffload` — Fig. 9's hash-table *get*: RECV scatters the
  key into the CAS comparand and the bucket address into the READ; the READ
  pulls ``[key, pad, val_ptr]`` onto the response WR's ``[ctrl, flags,
  src]`` fields, and the CAS converts the response NOOP into the
  value-returning WRITE only on a key match.
* :class:`HopscotchShardServer` — §5.2's sharded-store *get*: Fig. 9
  generalized to the hopscotch neighborhood, one chain per owner shard
  (and its TTL variant, whose deadline compare is a Calc-verb chain).
* :class:`HopscotchShardWriter` / :class:`HopscotchShardDisplacer` —
  §3.5's CAS-claiming *set* and the bounded hopscotch displacement bubble.
* :class:`MultiWriterGroup` — §3.5's racing writers: N SET (or DELETE,
  or CLOCK sweep) lanes over one shared table under a
  :class:`machine.Schedule`; :class:`CasRetryPair`, the minimal race.
* :class:`HopscotchShardMigrator` — one lap of online table growth: a
  source bucket re-homed into the doubled frame.
* :class:`HopscotchShardDeleter` / :class:`ClockSweeper` — the rest of the
  Memcached lifecycle: *delete* and the CLOCK expiry sweeper.
* :class:`ListTraversalOffload` — Fig. 12's linked-list walk, with and
  without the §5.3 ``break``.
* :class:`RecycledGetServer` — a §3.4 WQ-recycled *get* server on one
  managed WQ (the single-WQ program the chain kernel runs).

Every builder takes ``device`` (default CUDA; see
:func:`repro_torch.device.resolve`) and builds the same image, word for
word, as the JAX package's builder of the same name.

The write-side programs' contexts are ephemeral: the authoritative shard
arrays live outside the image, ``device_state`` scatters them in per
request and ``commit`` folds a quiesced context back.  Their batched
methods take a leading dim G of independent requests, each against its
own table (one owner shard per row).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import device as device_mod
from . import constructs, isa, machine
from .assembler import Program
from .engine import ChainEngine

EMPTY_KEY = 0          # bucket key 0 == empty; live keys are 1..2^24-1
MISS_SENTINEL = 0      # response region default (paper: "default value 0")

# SET outcome codes reported by the hopscotch writer/displacer chains'
# response words (mirrored in repro_torch.kvstore.hopscotch)
SET_UPDATED = 1              # key matched in neighborhood, value rewritten
SET_INSERTED = 2             # EMPTY bucket CAS-claimed, key + value written
SET_NEEDS_DISPLACEMENT = 3   # neighborhood full: displacer chain required
SET_DISPLACED = 4            # displacer bubbled a slot home and claimed it
SET_NEEDS_RESIZE = 5         # bounded search/bubble failed: resize required

# Migration lap outcomes (table growth; see HopscotchShardMigrator).
# Disjoint from SET_* so a mixed log stays unambiguous.
MIG_MOVED = 6                # source bucket re-homed into the new frame
MIG_DISCARDED = 7            # key already in the new frame: stale copy dropped
MIG_NEEDS_DISPLACE = 8       # new-frame neighborhood full: displacer needed

# DELETE / sweep outcome codes (disjoint from the SET codes)
DEL_DELETED = 9              # bucket matched and vacated (key -> EMPTY)
DEL_MISS = 10                # no probe matched; the pre-set default response
SWEEP_RECLAIMED = 11         # expired bucket vacated by the CLOCK sweeper
SWEEP_LIVE = 12              # deadline still ahead; bucket left untouched

# TTL sentinel: a bucket with no deadline carries INT32_MAX in its expiry
# word, so the chains' one signed compare — expired <=> deadline - now <= 0
# — needs no "has a TTL" special case
NO_TTL = 0x7FFFFFFF

# the hopscotch home-bucket hash — numerically identical to
# repro_torch.kvstore.hopscotch.bucket_of (core does not import kvstore)
_HASH_MULT = 2654435761


def bucket_home(keys: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """``(uint32(key) * 2654435761 mod 2^32) mod n_buckets`` as int32 (the
    product is taken in int64, whose wrap keeps the low 32 bits)."""
    k = (keys.long() & 0xFFFFFFFF) * _HASH_MULT & 0xFFFFFFFF
    return torch.remainder(k, n_buckets).to(torch.int32)


def _batched_get(off, keys: Sequence[int], max_steps: int):
    """Shared get_many body: one materialize(), one batched engine run,
    one response-region gather for the whole key batch."""
    st = off.materialize()
    payloads = np.asarray([off._payload(int(k)) for k in keys], np.int32)
    out = off.engine.run_many(st, off.recv_wq, payloads, max_steps)
    vals = out.mem[:, off.resp_region:off.resp_region + off.val_len]
    return vals.cpu().numpy(), out


# ---------------------------------------------------------------------------
# Fig. 3 — RPC offload
# ---------------------------------------------------------------------------

def build_rpc_echo(mem_words: int = 1024, bias: int = 1000, device=None):
    """RPC handler computing ``f(arg) = arg + bias`` entirely on the chain.

    The client's SEND carries ``arg``; the RECV scatter injects it into an
    ADD's immediate field (self-modifying) and the chain responds with the
    sum — the minimal data-dependent offload of Fig. 3.
    """
    p = Program(mem_words)
    acc = p.word(bias, "acc")
    resp = p.word(0, "resp")

    rq = p.add_wq(4)
    wq = p.add_wq(8, ordering=isa.ORD_DOORBELL)
    wq.wait(rq, 1, tag="rpc.trigger")                    # pre-posted chain
    add = wq.add(dst=acc, addend=0, tag="rpc.add")       # addend patched
    wq.send(src=acc, ln=1, dst_region=resp, target_qp=-1, tag="rpc.resp")
    tbl = p.scatter_table([add.addr("opa")])
    rq.recv(scatter_table=tbl, tag="rpc.recv")

    spec, state = p.finalize(device=device)
    return spec, state, dict(resp=resp, acc=acc, bias=bias, recv_wq=rq.index,
                             chain_wq=wq.index, prog=p)


# ---------------------------------------------------------------------------
# Fig. 9 — hash-table get
# ---------------------------------------------------------------------------

BUCKET_WORDS = 3       # [key, pad(=flags default 0), val_ptr]


@dataclasses.dataclass
class HashLookupOffload:
    prog: Program
    spec: machine.MachineSpec
    state0: machine.VMState
    n_buckets: int
    val_len: int
    table_base: int
    values_base: int
    resp_region: int
    recv_wq: int
    parallel: bool
    kv: Dict[int, Tuple[int, List[int]]]

    # -- hashes (client-side, like the paper) --------------------------------
    def h1(self, key: int) -> int:
        return key % self.n_buckets

    def h2(self, key: int) -> int:
        return (key * 2654435761 >> 8) % self.n_buckets

    def bucket_addr(self, b: int) -> int:
        return self.table_base + b * BUCKET_WORDS

    # -- host-side set path (the server CPU populates; gets are offloaded) --
    def insert(self, key: int, value: Sequence[int]) -> bool:
        assert 0 < key <= isa.ID_MASK and len(value) <= self.val_len
        for b in (self.h1(key), self.h2(key)):
            cur = self.kv.get(b)
            if cur is None or cur[0] == key:
                self.kv[b] = (key, list(value))
                return True
        return False   # displacement is the kvstore layer's job

    def materialize(self) -> machine.VMState:
        """Fresh machine state with the current table contents."""
        mem = self.state0.mem.cpu().numpy().copy()
        for b, (key, value) in self.kv.items():
            vslot = self.values_base + b * self.val_len
            a = self.bucket_addr(b)
            mem[a], mem[a + 1], mem[a + 2] = key, 0, vslot
            mem[vslot: vslot + len(value)] = value
        return self.state0._replace(
            mem=torch.from_numpy(mem).to(self.state0.mem.device))

    @property
    def engine(self) -> ChainEngine:
        return ChainEngine.for_spec(self.spec)

    def _payload(self, key: int) -> List[int]:
        return [key, key, self.bucket_addr(self.h1(key)),
                self.bucket_addr(self.h2(key))]

    # -- the offloaded get ---------------------------------------------------
    def get(self, key: int, state: Optional[machine.VMState] = None,
            max_steps: int = 256):
        st = self.materialize() if state is None else state
        st = machine.deliver(st, self.recv_wq, self._payload(key))
        out = self.engine.run(st, max_steps)
        val = out.mem[self.resp_region:self.resp_region + self.val_len]
        return val.cpu().numpy(), out

    def get_many(self, keys: Sequence[int], max_steps: int = 256):
        """Batched get: one materialize(), one batched run for all keys.

        Returns ``(vals (N, val_len) np.ndarray, batched VMState)`` —
        row i identical to ``get(keys[i])`` against the same table.
        """
        return _batched_get(self, keys, max_steps)


def build_hash_lookup(n_buckets: int = 64, val_len: int = 4,
                      parallel: bool = True, mem_words: int = 4096,
                      device=None) -> HashLookupOffload:
    p = Program(mem_words)
    resp = p.alloc(val_len, [MISS_SENTINEL] * val_len, "resp")
    values = p.alloc(n_buckets * val_len, name="values")
    table = p.alloc(n_buckets * BUCKET_WORDS,
                    [0] * (n_buckets * BUCKET_WORDS), "table")

    rq = p.add_wq(4)
    probes = []
    for pi in range(2):
        # WQ1: probe READ (RECV-patched -> doorbell-ordered)
        wq1 = p.add_wq(4, ordering=isa.ORD_DOORBELL, managed=True)
        # WQ2: CAS + response (READ- and CAS-patched)
        wq2 = p.add_wq(6, ordering=isa.ORD_DOORBELL, managed=True,
                       initial_enable=3)
        if pi == 1 and not parallel:
            # RedN-Seq: second bucket probed only after the first completes
            wq1.wait(probes[0]["wq2"], 4, tag="hash.seq")
        wq1.wait(rq, 1, tag=f"hash.trig{pi}")
        wq1.initial_enable = wq1.n_posted + 1
        rd = wq1.read(src=0, dst=0, ln=BUCKET_WORDS, tag=f"hash.read{pi}")

        wq2.wait(wq1, rd.completion_count, tag=f"hash.sync{pi}")
        cas = wq2.cas(dst=0, old=isa.pack_ctrl(isa.NOOP, 0),
                      new=isa.pack_ctrl(isa.WRITE, 0), tag=f"hash.cas{pi}")
        wq2.enable(wq2, upto=4, tag=f"hash.en{pi}")
        # R4: the response — NOOP unless the CAS converts it
        # (bucket [key, pad, val_ptr] lands on its [ctrl, flags, src])
        r4 = wq2.post(isa.NOOP, src=0, dst=resp, ln=val_len,
                      tag=f"hash.resp{pi}")
        wq1.wrs[rd.slot]["dst"] = r4.ctrl_addr      # READ patches R4
        wq2.wrs[cas.slot]["dst"] = r4.ctrl_addr     # CAS tests/converts R4
        probes.append(dict(wq1=wq1, wq2=wq2, rd=rd, cas=cas, r4=r4))

    # RECV scatter: key -> both CAS comparands; bucket addrs -> the READs
    tbl = p.scatter_table([
        probes[0]["cas"].addr("opa"), probes[1]["cas"].addr("opa"),
        probes[0]["rd"].addr("src"), probes[1]["rd"].addr("src")])
    rq.recv(scatter_table=tbl, tag="hash.recv")

    spec, st0 = p.finalize(device=device)
    return HashLookupOffload(
        prog=p, spec=spec, state0=st0, n_buckets=n_buckets, val_len=val_len,
        table_base=table, values_base=values, resp_region=resp,
        recv_wq=rq.index, parallel=parallel, kv={})


# ---------------------------------------------------------------------------
# §5.2 — the sharded-store get server: hopscotch probes as a chain program
# ---------------------------------------------------------------------------

def _scatter_rows(state0: machine.VMState, keys: torch.Tensor,
                  vals: torch.Tensor, *, table_base: int, values_base: int,
                  pad: Optional[torch.Tensor] = None,
                  found: bool = False) -> machine.VMState:
    """``state0`` with a table's rows scattered into the image.

    keys: (..., n) int32 (0 = empty) into the bucket rows' key words;
    vals: (..., n, V) into the value rows; ``pad`` (..., n), if given,
    into the bucket rows' pad words; ``found`` prefixes each value row
    with the flag ``keys != EMPTY`` (the get server's ``[found, v...]``
    rows).  The val_ptr column is static (baked at build time).  Leading
    dims stack one machine per table: every field of the result gains
    them.
    """
    lead = tuple(keys.shape[:-1])
    n, v = keys.shape[-1], vals.shape[-1]
    dev = state0.mem.device
    keys = keys.to(device=dev, dtype=torch.int32)
    vals = vals.to(device=dev, dtype=torch.int32)
    row_stride = v + 1 if found else v
    rows = torch.arange(n, dtype=torch.int64, device=dev)
    mem = state0.mem.expand(lead + state0.mem.shape).clone()
    mem[..., table_base + rows * BUCKET_WORDS] = keys
    if pad is not None:
        mem[..., table_base + rows * BUCKET_WORDS + 1] = pad.to(
            device=dev, dtype=torch.int32)
    first = values_base + rows * row_stride
    if found:
        mem[..., first] = (keys != EMPTY_KEY).to(torch.int32)
        first = first + 1
    vidx = first[:, None] + torch.arange(v, device=dev)[None, :]
    mem[..., vidx.reshape(-1)] = vals.reshape(lead + (-1,))
    return machine.VMState(*(
        mem if name == "mem" else a.expand(lead + a.shape)
        for name, a in zip(machine.VMState._fields, state0)))


def _probe_addrs(home: torch.Tensor, h: int, n_buckets: int,
                 table_base: int) -> torch.Tensor:
    """Bucket-row addresses of the wrapping neighborhood ``[home, home +
    h)``: (..., h) int32."""
    offs = torch.arange(h, dtype=torch.int32, device=home.device)
    rows = torch.remainder(home[..., None].to(torch.int32) + offs, n_buckets)
    return (table_base + rows * BUCKET_WORDS).to(torch.int32)


@dataclasses.dataclass(frozen=True, eq=False)
class HopscotchShardServer:
    """Fig. 9's get offload generalized to the hopscotch neighborhood.

    One pre-posted chain per owner shard: the client SEND carries the key
    plus the H probe-bucket addresses (the client computes hashes, like the
    paper); H RedN-Parallel probe pairs each READ a bucket onto their
    response WR's ``[ctrl, flags, src]`` and CAS-convert it into the
    value-returning WRITE on a key match.  Value rows are
    ``[found, v0..v{V-1}]``: the response region reads ``[found, value...]``
    and a served miss is ``[0, 0...]``, bit-exact with
    :func:`repro_torch.kvstore.hopscotch.lookup`.  The flag word is set to
    ``keys != EMPTY`` by :meth:`device_state`, so a query of key 0 — which
    CAS-matches every empty bucket — lands flag 0 and reads as a miss.

    WQ0 is a never-posted all-zero guard: a zero-padded request slot probes
    address 0, reads the all-zero null bucket, and resolves to a harmless
    zero write.  The table contents are dynamic (:meth:`device_state`), so
    one built program serves every shard.

    **TTL variant** (``ttl=True``): each bucket's pad word carries an
    expiry deadline (:data:`NO_TTL` = never), the client also sends
    ``-now``, and each probe's conversion WQ computes ``e = min(max(
    deadline - now, 0), 1)`` over the deadline its READ landed on the
    response WR's flags field; ``e == 0`` arms a *tester* CAS that turns a
    matched response WRITE back into a NOOP.  An expired hit quiesces
    exactly like a miss, bit-exact with
    :func:`repro_torch.kvstore.hopscotch.lookup_ttl`.
    """
    prog: Program
    spec: machine.MachineSpec
    state0: machine.VMState
    n_buckets: int
    val_len: int
    neighborhood: int
    table_base: int
    values_base: int
    resp_region: int
    recv_wq: int
    ttl: bool = False

    @property
    def resp_words(self) -> int:
        return self.val_len + 1            # [found, value...]

    @property
    def shared_window(self) -> Tuple[int, int]:
        """``(lo, hi)``: the table and the value rows, which the get chain
        only reads, contiguous because the data grows down.  A batch of
        gets keeps these words once a shard
        (:func:`machine.deliver_shared`); each context copies only the
        code, the scatter table, the response row and (TTL) the key,
        ``-now`` and ``e`` cells, which all lie outside."""
        return (self.table_base,
                self.values_base + self.n_buckets * (self.val_len + 1))

    @property
    def engine(self) -> ChainEngine:
        return ChainEngine.for_spec(self.spec)

    def device_state(self, keys: torch.Tensor, vals: torch.Tensor,
                     exp: Optional[torch.Tensor] = None) -> machine.VMState:
        """Image with a shard's hopscotch slice scattered in.

        keys: (..., n_buckets) int32 (0 = empty); vals: (..., n_buckets,
        val_len); a TTL build also takes the deadline column ``exp``
        (..., n_buckets), scattered into the bucket pad words.  Leading
        dims (the store's virtual shards) stack one machine per table.
        """
        if self.ttl != (exp is not None):
            raise ValueError(
                "exp column required iff the server was built with "
                f"ttl=True (ttl={self.ttl}, exp given={exp is not None})")
        return _scatter_rows(self.state0, keys, vals,
                             table_base=self.table_base,
                             values_base=self.values_base, pad=exp,
                             found=True)

    def device_payloads(self, queries: torch.Tensor, home: torch.Tensor,
                        now=None) -> torch.Tensor:
        """Client-side request assembly: ``[key x H, probe addrs x H]``
        (default build) or ``[key, -now, probe addrs x H]`` (TTL build;
        a padded row, key 0, keeps ``-now`` 0).

        queries: (B,) int32; home: (B,) int32 home buckets (the client
        computes the hash).  Probes cover the wrapping neighborhood
        ``[home, home + H)``.
        """
        if self.ttl != (now is not None):
            raise ValueError(
                "now required iff the server was built with ttl=True "
                f"(ttl={self.ttl}, now given={now is not None})")
        addrs = _probe_addrs(home, self.neighborhood, self.n_buckets,
                             self.table_base)
        q = queries[..., None].to(torch.int32)
        if now is not None:
            negnow = -torch.as_tensor(now, dtype=torch.int32,
                                      device=queries.device)
            negnow = negnow * (q != EMPTY_KEY).to(torch.int32)
            return torch.cat([q, negnow, addrs], dim=-1)
        return torch.cat([q.expand(addrs.shape), addrs], dim=-1)

    def get_many(self, keys: torch.Tensor, vals: torch.Tensor,
                 queries: torch.Tensor, home: torch.Tensor,
                 max_steps: int = 96, exp=None, now=None):
        """Single-machine batched get, the contexts sharing the table and
        value rows (:attr:`shared_window`).  Returns (found bool (B,),
        values (B, val_len))."""
        st = self.device_state(keys, vals, exp)
        out = self.engine.run_many(
            st, self.recv_wq, self.device_payloads(queries, home, now),
            max_steps, window=self.shared_window)
        resp = machine.words(out, self.resp_region, self.resp_words)
        return resp[:, 0] > 0, resp[:, 1:]


def build_hopscotch_server(n_buckets: int, val_len: int,
                           neighborhood: int = 8, ttl: bool = False,
                           device=None) -> HopscotchShardServer:
    """Build (and cache per geometry and device) the per-shard hopscotch
    get chain.  ``2 * neighborhood`` payload words / scatter entries must
    fit the RECV scatter limit (§5.3: 16 scatters), so ``neighborhood <=
    8``.  With ``ttl=True`` each probe also evaluates the expiry predicate
    on the chain (see :class:`HopscotchShardServer`); the request then
    sends ``[key, -now]`` once plus the probe addresses."""
    return _build_hopscotch_server(n_buckets, val_len, neighborhood,
                                   bool(ttl), device_mod.resolve(device))


@functools.lru_cache(maxsize=None)
def _build_hopscotch_server(n_buckets: int, val_len: int, neighborhood: int,
                            ttl: bool, dev: torch.device
                            ) -> HopscotchShardServer:
    if not 1 <= neighborhood <= isa.MAX_SCATTER // 2:
        raise ValueError(
            f"neighborhood must be in [1, {isa.MAX_SCATTER // 2}] "
            f"(2 payload words per probe, {isa.MAX_SCATTER}-scatter RECV)")
    if val_len + 1 > isa.MAX_COPY:
        raise ValueError(f"val_len {val_len} exceeds one-WRITE response")
    row_stride = val_len + 1
    h = neighborhood

    # size the image exactly: code (1 guard + recv + 6 [ttl: 17] slots per
    # probe) grows up, data grows down
    code_words = (1 + 2 + (4 + 13 if ttl else 6) * h) * isa.WR_WORDS
    data_words = (row_stride                      # response region
                  + n_buckets * row_stride        # value rows [flag, v...]
                  + n_buckets * BUCKET_WORDS      # table
                  + (2 + h if ttl else 0)         # key/-now words, e cells
                  + 1 + (2 + h if ttl else 2 * h))  # scatter table
    mem_words = -(-(code_words + data_words + 32) // 128) * 128

    p = Program(mem_words)
    p.add_wq(1)                                   # WQ0: all-zero null bucket
    resp = p.alloc(row_stride, [MISS_SENTINEL] * row_stride, "resp")
    # value rows [found, v...]: the found flag is per-row dynamic state
    # (device_state writes keys != EMPTY), so the static image is zeros
    values = p.alloc(n_buckets * row_stride,
                     [0] * (n_buckets * row_stride), "values")
    # table rows [key=0, pad, val_ptr]: val_ptr column baked statically;
    # in a TTL build the pad word is the deadline, NO_TTL statically
    tbl_init = [NO_TTL if ttl else 0] * (n_buckets * BUCKET_WORDS)
    for b in range(n_buckets):
        tbl_init[b * BUCKET_WORDS] = 0
        tbl_init[b * BUCKET_WORDS + 2] = values + b * row_stride
    table = p.alloc(n_buckets * BUCKET_WORDS, tbl_init, "table")
    key_w = p.word(0, "key") if ttl else None
    negnow_w = p.word(0, "negnow") if ttl else None
    cells = [key_w, negnow_w] if ttl else []     # the TTL cells it writes

    rq = p.add_wq(2)
    cas_opa_addrs, read_src_addrs = [], []
    for pi in range(h):
        if not ttl:
            wq1 = p.add_wq(2, ordering=isa.ORD_DOORBELL, managed=True)
            wq2 = p.add_wq(4, ordering=isa.ORD_DOORBELL, managed=True,
                           initial_enable=3)
            wq1.wait(rq, 1, tag=f"hs.trig{pi}")
            wq1.initial_enable = wq1.n_posted + 1
            rd = wq1.read(src=0, dst=0, ln=BUCKET_WORDS, tag=f"hs.read{pi}")

            wq2.wait(wq1, rd.completion_count, tag=f"hs.sync{pi}")
            cas = wq2.cas(dst=0, old=isa.pack_ctrl(isa.NOOP, 0),
                          new=isa.pack_ctrl(isa.WRITE, 0), tag=f"hs.cas{pi}")
            wq2.enable(wq2, upto=4, tag=f"hs.en{pi}")
            # the response: NOOP unless the CAS converts it; the bucket row
            # [key, pad, val_ptr] lands on its [ctrl, flags, src]
            r4 = wq2.post(isa.NOOP, src=0, dst=resp, ln=row_stride,
                          tag=f"hs.resp{pi}")
            wq1.wrs[rd.slot]["dst"] = r4.ctrl_addr
            wq2.wrs[cas.slot]["dst"] = r4.ctrl_addr
            cas_opa_addrs.append(cas.addr("opa"))
            read_src_addrs.append(rd.addr("src"))
            continue

        # TTL probe: wq1 patches key/-now into wq2's compare verbs, then
        # the usual 3-word probe READ; wq2 computes e = clamp(deadline -
        # now) between the match CAS and the response slot and arms the
        # tester iff expired.  Chained self-enables fence the tester (10)
        # and the response (12) behind the arithmetic.
        e_cell = p.word(0, f"e{pi}")
        cells.append(e_cell)
        wq1 = p.add_wq(4, ordering=isa.ORD_DOORBELL, managed=True)
        wq2 = p.add_wq(13, ordering=isa.ORD_DOORBELL, managed=True,
                       initial_enable=10)
        wq1.wait(rq, 1, tag=f"hs.trig{pi}")
        wq1.write(src=key_w, dst=wq2.future_wr_addr(1, "opa"),
                  tag=f"hs.key{pi}")              # match comparand <- key
        wq1.write(src=negnow_w, dst=wq2.future_wr_addr(4, "opa"),
                  tag=f"hs.now{pi}")              # ADD operand <- -now
        rd = wq1.read(src=0, dst=0, ln=BUCKET_WORDS, tag=f"hs.read{pi}")
        wq1.initial_enable = wq1.n_posted + 1

        wq2.wait(wq1, rd.completion_count, tag=f"hs.sync{pi}")      # [0]
        cas = wq2.cas(dst=0, old=isa.pack_ctrl(isa.NOOP, 0),
                      new=isa.pack_ctrl(isa.WRITE, 0),
                      tag=f"hs.cas{pi}")                            # [1]
        wq2.write(src=wq2.future_wr_addr(10, "flags"), dst=e_cell,
                  tag=f"hs.exp{pi}")              # [2] deadline -> e
        wq2.write_imm(dst=wq2.future_wr_addr(9, "flags"), value=0,
                      tag=f"hs.fl0{pi}")          # [3] flags hygiene
        wq2.add(dst=e_cell, addend=0, tag=f"hs.sub{pi}")            # [4]
        wq2.max_(dst=e_cell, operand=0, tag=f"hs.clm{pi}")          # [5]
        wq2.min_(dst=e_cell, operand=1, tag=f"hs.cl1{pi}")          # [6]
        wq2.write(src=e_cell, dst=wq2.future_wr_addr(3, "ctrl"),
                  tag=f"hs.et{pi}")               # [7] e -> tester ctrl
        wq2.cas(dst=wq2.future_wr_addr(2, "ctrl"),
                old=isa.pack_ctrl(isa.NOOP, 0),
                new=isa.pack_ctrl(isa.CAS, 0),
                tag=f"hs.arm{pi}")                # [8] arm tester iff e=0
        wq2.enable(wq2, upto=12, tag=f"hs.en{pi}")                  # [9]
        # the tester: NOOP unless armed; armed, it CASes the response WR
        # back WRITE -> NOOP (an expired match answers as a miss)
        wq2.post(isa.NOOP, src=-1, dst=wq2.future_wr_addr(2, "ctrl"),
                 opa=isa.pack_ctrl(isa.WRITE, 0),
                 opb=isa.pack_ctrl(isa.NOOP, 0),
                 tag=f"hs.tst{pi}")               # [10]
        wq2.enable(wq2, upto=13, tag=f"hs.en2{pi}")                 # [11]
        r4 = wq2.post(isa.NOOP, src=0, dst=resp, ln=row_stride,
                      tag=f"hs.resp{pi}")         # [12]
        wq1.wrs[rd.slot]["dst"] = r4.ctrl_addr
        wq2.wrs[cas.slot]["dst"] = r4.ctrl_addr
        read_src_addrs.append(rd.addr("src"))

    tbl = p.scatter_table(
        ([key_w, negnow_w] if ttl else cas_opa_addrs) + read_src_addrs)
    rq.recv(scatter_table=tbl, tag="hs.recv")
    # the shared window: the table then the value rows, and nothing the
    # chain writes (code, scatter table, response row, TTL cells) inside
    lo, hi = table, values + n_buckets * row_stride
    if table + n_buckets * BUCKET_WORDS != values:
        raise ValueError(f"the table [{table}, ...) and the value rows at "
                         f"{values} are not contiguous")
    written = [(0, p._code_top), (resp, resp + row_stride)]
    written += [(a, a + 1) for a in cells]
    for a, b in written:
        if a < hi and b > lo:
            raise ValueError(f"words [{a}, {b}) the chain writes lie in "
                             f"the shared window [{lo}, {hi})")

    spec, st0 = p.finalize(device=dev)
    return HopscotchShardServer(
        prog=p, spec=spec, state0=st0, n_buckets=n_buckets, val_len=val_len,
        neighborhood=neighborhood, table_base=table, values_base=values,
        resp_region=resp, recv_wq=rq.index, ttl=ttl)


# ---------------------------------------------------------------------------
# §3.5 — the sharded-store SET writer: CAS-claimed hopscotch writes
# ---------------------------------------------------------------------------

def _set_templates(p: Program, val_stage: int, val_len: int, resp: int,
                   stage_default: int):
    """16-word Fig.-6 template (over two event WRs): a suppressed value
    WRITE (dst patched with the bucket's val_ptr at run time) and a
    suppressed ``[status, bucket_addr]`` response WRITE.  Shared by the
    writer's match/claim phases and the displacer's match/claim phases."""
    stage = p.alloc(2, [stage_default, 0])
    tmpl = p.alloc(2 * isa.WR_WORDS, [
        isa.pack_ctrl(isa.WRITE, 0), isa.FLAG_SUPPRESS_COMPLETION,
        val_stage, 0, val_len, 0, 0, -1,
        isa.pack_ctrl(isa.WRITE, 0), isa.FLAG_SUPPRESS_COMPLETION,
        stage, resp, 2, 0, 0, -1])
    return tmpl, stage


def _emit_set_match_phase(p: Program, rq, h: int, key_w: int, val_stage: int,
                          val_len: int, resp: int,
                          home_w: Optional[int] = None):
    """The SET programs' shared match phase: H parallel probe pairs.

    Each probe READs its bucket's key onto a conditional WR's control
    word and CAS-tests it against the query key; a hit converts the
    conditional into a Fig.-6 template WRITE whose two suppressed event
    WRITEs rewrite the bucket's value row and land ``[SET_UPDATED,
    bucket_addr]`` in the response region — and the missing event
    completions starve everything gated on ``wait(m_mod, 3)`` (the
    writer's claim phase, the displacer's search phase).

    Probe addresses: with ``home_w=None`` each probe READ's src is left
    for the RECV scatter (the writer's client sends all H addresses);
    with ``home_w`` set they are derived in-chain as ``home + d *
    BUCKET_WORDS`` from the single scattered home address (the
    displacer's unwrapped frame).  Returns ``(rd1s, m_tmpls, m_mods)``.
    """
    rd1s, m_tmpls, m_mods = [], [], []
    for pi in range(h):
        tmpl, stage = _set_templates(p, val_stage, val_len, resp,
                                     SET_UPDATED)
        mmod = p.add_wq(3, ordering=isa.ORD_DOORBELL, managed=True,
                        initial_enable=0)
        mdrv = p.add_wq(9 if home_w is not None else 7,
                        ordering=isa.ORD_DOORBELL, managed=True)
        mexe = p.add_wq(3, ordering=isa.ORD_DOORBELL, managed=True,
                        initial_enable=3)

        c_i = mmod.post(isa.NOOP, src=tmpl,
                        dst=mmod.future_wr_addr(1, "ctrl"),
                        ln=2 * isa.WR_WORDS, tag=f"wr.mc{pi}")
        mmod.post(isa.NOOP, tag=f"wr.me{pi}")     # event: value WRITE slot
        mmod.post(isa.NOOP, tag=f"wr.mf{pi}")     # event: response slot

        mdrv.wait(rq, 1, tag=f"wr.trig{pi}")
        if home_w is not None:
            mdrv.write(src=home_w, dst=mdrv.future_wr_addr(3, "src"),
                       tag=f"wr.home{pi}")        # probe addr <- home + d*BW
            mdrv.add(dst=mdrv.future_wr_addr(2, "src"),
                     addend=pi * BUCKET_WORDS, tag=f"wr.hoff{pi}")
        mdrv.write(src=key_w, dst=mexe.future_wr_addr(1, "opa"),
                   tag=f"wr.key{pi}")             # CAS comparand <- key
        rd1 = mdrv.read(src=0, dst=c_i.ctrl_addr, ln=1,
                        tag=f"wr.read{pi}")       # src scatter/self-patched
        mdrv.write(src=rd1.addr("src"), dst=mdrv.future_wr_addr(2, "src"),
                   tag=f"wr.vp_patch{pi}")
        mdrv.add(dst=mdrv.future_wr_addr(1, "src"), addend=2,
                 tag=f"wr.vp_off{pi}")
        mdrv.read(src=0, dst=tmpl + isa.F_DST, ln=1,
                  tag=f"wr.vp{pi}")               # val_ptr -> template dst
        last = mdrv.write(src=rd1.addr("src"), dst=stage + 1,
                          tag=f"wr.addr{pi}")     # bucket addr -> response
        mdrv.initial_enable = mdrv.n_posted + 1

        mexe.wait(mdrv, last.completion_count, tag=f"wr.sync{pi}")
        mexe.cas(dst=c_i.ctrl_addr, old=isa.pack_ctrl(isa.NOOP, 0),
                 new=isa.pack_ctrl(isa.WRITE, 0), tag=f"wr.cas{pi}")
        mexe.enable(mmod, upto=3, tag=f"wr.en{pi}")
        rd1s.append(rd1)
        m_tmpls.append(tmpl)
        m_mods.append(mmod)
    return rd1s, m_tmpls, m_mods


def _emit_set_claim_phase(p: Program, rd1s, m_tmpls, m_mods, h: int,
                          key_w: int, val_stage: int, val_len: int,
                          resp: int):
    """The SET programs' claim phase: sequential CAS-claims over the H
    probed buckets, gated on an all-miss match phase."""
    cdrv = p.add_wq(5 * h, ordering=isa.ORD_DOORBELL, managed=True)
    cexe = p.add_wq(4 * h, ordering=isa.ORD_DOORBELL, managed=True)
    cmod = p.add_wq(3 * h, ordering=isa.ORD_DOORBELL, managed=True,
                    initial_enable=0)

    claims = []
    for pi in range(h):
        tmpl, stage = _set_templates(p, val_stage, val_len, resp,
                                     SET_INSERTED)
        if pi == 0:
            # every cdrv patch below completed (and, transitively, every
            # match probe finished without a hit)
            cexe.wait(cdrv, 5 * h, tag="wr.cgate")
        else:
            # previous claim resolved un-claimed (its events completed)
            cexe.wait(cmod, 3 * pi, tag=f"wr.cseq{pi}")
        refs = constructs.emit_cas_claim(
            cexe, cmod, cell=0, expect=EMPTY_KEY, new=0, then_src=tmpl,
            then_dst=cmod.future_wr_addr(1, "ctrl"),
            then_len=2 * isa.WR_WORDS)
        cmod.post(isa.NOOP, tag=f"wr.ce{pi}")     # event: value WRITE slot
        cmod.post(isa.NOOP, tag=f"wr.cf{pi}")     # event: response slot
        cexe.enable(cmod, upto=3 * (pi + 1), tag=f"wr.cen{pi}")
        claims.append((refs, tmpl, stage))
    cexe.initial_enable = cexe.n_posted + 1

    for pi in range(h):
        cdrv.wait(m_mods[pi], 3, tag=f"wr.nomatch{pi}")
    for pi, (refs, tmpl, stage) in enumerate(claims):
        cdrv.write(src=rd1s[pi].addr("src"), dst=refs.cell_dst_addr,
                   tag=f"wr.cdst{pi}")            # claim the probed bucket
        cdrv.write(src=key_w, dst=refs.new_opb_addr,
                   tag=f"wr.cnew{pi}")            # CAS new <- key
        cdrv.write(src=m_tmpls[pi] + isa.F_DST, dst=tmpl + isa.F_DST,
                   tag=f"wr.cvp{pi}")             # reuse probed val_ptr
        cdrv.write(src=rd1s[pi].addr("src"), dst=stage + 1,
                   tag=f"wr.caddr{pi}")           # bucket addr -> response
    cdrv.initial_enable = cdrv.n_posted + 1
    return cdrv, cexe, cmod


def _fuel(state0: machine.VMState) -> int:
    """An exact safe step budget for one request of a program whose WQs
    never recycle: every posted WR executes at most once."""
    return int(state0.tail.sum()) + 1


def _run_contexts(prog, state: machine.VMState, payloads: torch.Tensor,
                  max_steps: int, faults=None) -> machine.VMState:
    """Deliver ``payloads[g]`` to machine ``g`` of a state stacked over G
    machines and run all G to quiescence, batched (the contexts are
    independent, one owner shard each); ``faults`` arms one plan per
    machine."""
    batch = machine.deliver_many(state, prog.recv_wq,
                                 payloads.to(torch.int32)[:, None, :])
    return machine.run_batch_in_place(prog.spec, batch, max_steps, faults)


def _run_rows_faulted(prog, carry, payloads: torch.Tensor, max_steps: int,
                      faults):
    """``prog.run_rows`` under a :class:`repro_torch.core.faults.FaultPlan`
    with one row per request: each chain runs with its row's faults armed;
    an **armed** row commits the torn image (``prog.commit_torn`` — the
    device state a real interrupted chain leaves behind), a disarmed row
    commits through the ordinary status-gated ``prog.commit``, so a
    disarmed row is bit-exact with ``run_rows``.  Returns ``(status,
    *carry, steps)``."""
    out = _run_contexts(prog, prog.device_state(*carry), payloads,
                        max_steps, faults)
    torn = prog.commit_torn(out.mem, payloads, *carry)
    clean = prog.commit(out.mem, payloads, *carry)
    act = faults.active().to(out.mem.device)
    picked = tuple(torch.where(act.reshape(act.shape + (1,) * (t.ndim - 1)),
                               t, c) for t, c in zip(torn, clean))
    return (*picked, out.steps)


def _one_faulted(prog, carry, payload: torch.Tensor, max_steps: int, faults):
    """One request through :func:`_run_rows_faulted` under a scalar-leaf
    plan.  Returns ``(status, *carry)``."""
    plan = type(faults)(*(torch.as_tensor(leaf).reshape(1) for leaf in faults))
    out = _run_rows_faulted(prog, tuple(c[None] for c in carry),
                            payload[None], max_steps, plan)
    return tuple(a[0] for a in out[:-1])


def _image_rows(out_mem: torch.Tensor, table_base: int, values_base: int,
                rows: torch.Tensor, v: int):
    """The key words and value rows of table ``rows`` as they stand in G
    images: ``(keys (G, R), vals (G, R, v))``."""
    cols = torch.arange(v, dtype=torch.int64, device=out_mem.device)
    return (out_mem[:, table_base + rows * BUCKET_WORDS],
            out_mem[:, values_base + rows[:, None] * v + cols[None, :]])


def _fold_mirrored(out_mem: torch.Tensor, keys: torch.Tensor,
                   vals: torch.Tensor, table_base: int, values_base: int,
                   n_mirror: int):
    """Fold an unwrapped frame back by per-word diff: rows ``n + b`` (``b <
    n_mirror``) mirror row ``b``, and any word a run touched lives in
    exactly one copy, so ``where(img != pre, img, mirror-merged)``
    reconstructs the post-state.  Returns int32 ``(keys, vals)``."""
    n, v = keys.shape[-1], vals.shape[-1]
    dev = out_mem.device
    rows = torch.arange(n, dtype=torch.int64, device=dev)
    mir = torch.arange(n_mirror, dtype=torch.int64, device=dev)
    img_k, img_v = _image_rows(out_mem, table_base, values_base, rows, v)
    mir_k, mir_v = _image_rows(out_mem, table_base, values_base, n + mir, v)
    base_k, base_v = keys.to(torch.int32), vals.to(torch.int32)
    merged_k, merged_v = base_k.clone(), base_v.clone()
    s = n_mirror
    merged_k[:, :s] = torch.where(mir_k != base_k[:, :s], mir_k,
                                  base_k[:, :s])
    merged_v[:, :s] = torch.where(mir_v != base_v[:, :s], mir_v,
                                  base_v[:, :s])
    return (torch.where(img_k != base_k, img_k, merged_k),
            torch.where(img_v != base_v, img_v, merged_v))


def _bucket_row(addr: torch.Tensor, table_base: int) -> torch.Tensor:
    """The table row of a bucket address (floor division, int32)."""
    return torch.div(addr - table_base, BUCKET_WORDS, rounding_mode="floor")


def _row_of(row: torch.Tensor, n: int):
    """A row index under the JAX reference's index rules: a negative row
    counts from the end once; returns (the row clamped into the table, for
    a read, and whether a write to it lands — out of range, it drops)."""
    row = torch.where(row < 0, row + n, row)
    inb = (row >= 0) & (row < n)
    return row.clamp(0, n - 1).long(), inb


def _put_rows(arr: torch.Tensor, row: torch.Tensor, put: torch.Tensor,
              value: torch.Tensor) -> torch.Tensor:
    """A copy of ``arr`` (G, n, ...) with ``arr[g, row[g]] = value[g]``
    where ``put[g]``."""
    out = arr.clone()
    g = torch.arange(arr.shape[0], device=arr.device)
    cur = out[g, row]
    mask = put.reshape(put.shape + (1,) * (cur.ndim - 1))
    out[g, row] = torch.where(mask, value.to(arr.dtype), cur)
    return out


class WalkFrame(NamedTuple):
    """One table of a write-side program's image, as a serial walk over
    one persistent image carries it (:attr:`WalkLayout.frames`).

    Carry row ``b < n`` is the bucket row ``[key, pad, val_ptr]`` at
    ``table_base + 3 b`` and the value row of ``val_len`` words at
    ``values_base + val_len b``; image rows ``n .. rows - 1`` mirror rows
    ``0 .. rows - n - 1`` (the unwrapped frame, ``rows - n <= n``).  The
    key words and value rows are the carry arrays ``carry[keys]`` and
    ``carry[vals]``; the pad words are ``carry[pad]`` when ``pad >= 0``,
    each row's home distance (``H = home_pad`` for an empty row) when
    ``home_pad > 0``, else the program's own constant words.  The
    val_ptr words never belong to the carry."""
    table_base: int
    values_base: int
    n: int
    rows: int
    val_len: int
    keys: int
    vals: int
    pad: int = -1
    home_pad: int = 0


class WalkLayout(NamedTuple):
    """What a walk needs of a single-chain write-side program: the frames
    its carry lives in, and the statuses whose clean run commits.

    The rule every such program's ``commit`` and ``commit_torn`` equal
    (``tests/test_torch_walk.py``): a run keeps its writes to the carry
    words when its fault row is armed (``commit_torn``) or its status
    (the word at ``resp_region``) is in ``commit``, and else changes no
    carry word; a kept word of a mirrored row takes the primary copy's
    write, else the mirror's (``_fold_mirrored``).  No run needs to keep
    a word outside the carry."""
    frames: Tuple[WalkFrame, ...]
    commit: Tuple[int, ...]
    resp_region: int
    recv_wq: int


@dataclasses.dataclass(frozen=True, eq=False)
class HopscotchShardWriter:
    """The write-side companion of :class:`HopscotchShardServer`.

    One pre-posted chain per owner shard makes SET an offload (§3.5:
    chained CAS builds atomics wider than one verb).  The client SEND
    carries ``[key, value x V, probe-bucket addrs x H]``; the chain then
    runs two phases:

    * **match** — H parallel probe pairs READ each bucket key onto a
      conditional WR's control word and CAS-test it against the query key;
      a hit rewrites the bucket's value row and lands ``[SET_UPDATED,
      bucket_addr]`` in the response region, and its missing completions
      starve the claim phase.
    * **claim** — gated on every match probe completing un-hit, the probes
      run again **sequentially**, each a
      :func:`repro_torch.core.constructs.emit_cas_claim` of the bucket's
      key word ``EMPTY -> key``; the first EMPTY bucket wins and answers
      ``[SET_INSERTED, bucket_addr]``.

    Neither phase firing leaves the pre-set default response
    ``[SET_NEEDS_DISPLACEMENT, 0]`` — the cue for the displacer stage
    (:class:`HopscotchShardDisplacer`).  :meth:`commit` folds a finished
    context's effects back into the arrays; requests against one shard
    are serialized, so a batch behaves exactly like the host oracle
    applied in order.
    """
    prog: Program
    spec: machine.MachineSpec
    state0: machine.VMState
    n_buckets: int
    val_len: int
    neighborhood: int
    table_base: int
    values_base: int
    resp_region: int
    recv_wq: int

    resp_words = 2                     # [status, bucket addr]

    @property
    def engine(self) -> ChainEngine:
        return ChainEngine.for_spec(self.spec)

    @property
    def fuel(self) -> int:
        """An exact safe step budget for one request (no WQ recycles, so
        the posted-WR count bounds any run): callers with tunable unroll
        bounds must use it rather than a fixed guess."""
        return _fuel(self.state0)

    @property
    def walk_layout(self) -> WalkLayout:
        """The table straight (no mirror rows); UPDATED and INSERTED
        commit."""
        return WalkLayout(
            (WalkFrame(self.table_base, self.values_base, self.n_buckets,
                       self.n_buckets, self.val_len, 0, 1),),
            (SET_UPDATED, SET_INSERTED), self.resp_region, self.recv_wq)

    def device_state(self, keys: torch.Tensor,
                     vals: torch.Tensor) -> machine.VMState:
        """Image with a shard's authoritative slice scattered in.

        keys: (..., n_buckets) int32 (0 = empty); vals: (..., n_buckets,
        val_len); leading dims stack one machine per table.
        """
        return _scatter_rows(self.state0, keys, vals,
                             table_base=self.table_base,
                             values_base=self.values_base)

    def device_payloads(self, queries: torch.Tensor, home: torch.Tensor,
                        values: torch.Tensor) -> torch.Tensor:
        """Client-side request assembly: ``[key, value x V, addrs x H]``.

        queries: (B,) int32 keys; home: (B,) int32 home buckets; values:
        (B, val_len) int32.
        """
        addrs = _probe_addrs(home, self.neighborhood, self.n_buckets,
                             self.table_base)
        return torch.cat([queries[:, None].to(torch.int32),
                          values.to(torch.int32).reshape(-1, self.val_len),
                          addrs], dim=1)

    def commit(self, out_mem: torch.Tensor, payload: torch.Tensor,
               keys: torch.Tensor, vals: torch.Tensor):
        """Fold G quiesced contexts' effects into their shards' arrays.

        out_mem (G, L), payload (G, W), keys (G, n), vals (G, n, V).
        Returns ``(status (G,), keys, vals)``.  Only UPDATED/INSERTED
        commit; the committed value row is read back from where the chain
        wrote it (placed by :func:`machine.block_start`, which clamps
        like the reference's ``dynamic_slice``: a row of nothing applied
        reads row 0 and writes it back unchanged).  A key-0 request is
        never committed and reports status 0.
        """
        status = out_mem[:, self.resp_region]
        addr = out_mem[:, self.resp_region + 1]
        live = payload[:, 0] != EMPTY_KEY
        applied = live & ((status == SET_UPDATED)
                          | (status == SET_INSERTED))
        n, v = keys.shape[1], self.val_len
        row = torch.where(applied, _bucket_row(addr, self.table_base), 0)
        start = machine.block_start(self.values_base + row * v,
                                    out_mem.shape[-1], v)
        value = out_mem.gather(1, start[:, None] + torch.arange(
            v, device=out_mem.device))
        rr, inb = _row_of(row, n)
        g = torch.arange(keys.shape[0], device=keys.device)
        new_key = torch.where(status == SET_INSERTED,
                              payload[:, 0].to(keys.dtype), keys[g, rr])
        put = applied & inb
        return (torch.where(live, status, 0),
                _put_rows(keys, rr, put, new_key),
                _put_rows(vals, rr, put, value))

    def commit_torn(self, out_mem: torch.Tensor, payload: torch.Tensor,
                    keys: torch.Tensor, vals: torch.Tensor):
        """Fault-mode commit: fold back *whatever the chain wrote*,
        terminal status or not.  Every WR that executed already landed
        its write before the fault hit, so the table and value regions
        are read straight back (an untouched word equals the input arrays
        by construction): a key claimed but its value row not crossed, a
        response written but never completed.  Returns ``(status,
        keys, vals)``; ``status`` may be the pre-set non-terminal
        default."""
        rows = torch.arange(self.n_buckets, dtype=torch.int64,
                            device=out_mem.device)
        k, v = _image_rows(out_mem, self.table_base, self.values_base, rows,
                           self.val_len)
        return (torch.where(payload[:, 0] != EMPTY_KEY,
                            out_mem[:, self.resp_region], 0),
                k.to(keys.dtype), v.to(vals.dtype))

    def run_rows(self, keys: torch.Tensor, vals: torch.Tensor,
                 payloads: torch.Tensor, max_steps: int = 512):
        """G requests, request ``g`` against table ``g``: build the
        images, deliver the SENDs, run the chains to quiescence, commit.
        Returns ``(status (G,), keys, vals, steps (G,))``."""
        out = _run_contexts(self, self.device_state(keys, vals), payloads,
                            max_steps)
        return (*self.commit(out.mem, payloads, keys, vals), out.steps)

    def run_rows_faulted(self, keys: torch.Tensor, vals: torch.Tensor,
                         payloads: torch.Tensor, max_steps: int, faults):
        """:meth:`run_rows` under a fault plan with one row per request
        (see :func:`_run_rows_faulted`)."""
        return _run_rows_faulted(self, (keys, vals), payloads, max_steps,
                                 faults)

    def run_one(self, keys: torch.Tensor, vals: torch.Tensor,
                payload: torch.Tensor, max_steps: int = 512):
        """Serve one assembled request against the shard arrays.  Returns
        ``(status, new_keys, new_vals)``."""
        out = self.run_rows(keys[None], vals[None], payload[None],
                            max_steps)
        return tuple(a[0] for a in out[:3])

    def run_one_faulted(self, keys: torch.Tensor, vals: torch.Tensor,
                        payload: torch.Tensor, max_steps: int, faults):
        """:meth:`run_one` under a scalar-leaf fault plan: an armed plan
        commits the torn image, a disarmed one is bit-exact with
        :meth:`run_one`.  Returns ``(status, new_keys, new_vals)``."""
        return _one_faulted(self, (keys, vals), payload, max_steps, faults)

    def set_many(self, keys: torch.Tensor, vals: torch.Tensor,
                 queries: torch.Tensor, home: torch.Tensor,
                 values: torch.Tensor, max_steps: int = 512):
        """Single-machine batched SET: the requests run one at a time,
        each against the arrays as its predecessors left them — bit-exact
        with :func:`repro_torch.kvstore.hopscotch.insert_many`.  Returns
        ``(status (B,), new_keys, new_vals)``."""
        payloads = self.device_payloads(queries, home, values)
        statuses = []
        for pay in payloads:
            status, keys, vals = self.run_one(keys, vals, pay, max_steps)
            statuses.append(status)
        return torch.stack(statuses), keys, vals


def build_hopscotch_writer(n_buckets: int, val_len: int,
                           neighborhood: int = 8,
                           device=None) -> HopscotchShardWriter:
    """Build (and cache per geometry and device) the per-shard hopscotch
    SET chain.  The request is one SEND: ``1 + val_len + neighborhood``
    payload words must fit the RECV scatter/message limits (§5.3: 16
    scatters), so ``val_len <= 15 - neighborhood``."""
    return _build_hopscotch_writer(n_buckets, val_len, neighborhood,
                                   device_mod.resolve(device))


@functools.lru_cache(maxsize=None)
def _build_hopscotch_writer(n_buckets: int, val_len: int, neighborhood: int,
                            dev: torch.device) -> HopscotchShardWriter:
    if not 1 <= neighborhood:
        raise ValueError("neighborhood must be >= 1")
    if 1 + val_len + neighborhood > min(isa.MAX_SCATTER, isa.MSG_WORDS):
        raise ValueError(
            f"val_len {val_len} + neighborhood {neighborhood} exceeds the "
            f"one-SEND request budget ({isa.MAX_SCATTER}-scatter RECV)")
    h = neighborhood

    # size the image exactly: 1 guard WR + 2 recv slots + per probe
    # (7 match-driver + 3 match-exec + 3 match-cond) + claim
    # (5 driver-patch + 4 exec + 3 cond per probe); data grows down
    code_words = (1 + 2 + h * (7 + 3 + 3) + 5 * h + 4 * h + 3 * h) \
        * isa.WR_WORDS
    data_words = (2 + 1 + val_len              # resp, key_w, val_stage
                  + n_buckets * val_len        # value rows
                  + n_buckets * BUCKET_WORDS   # table
                  + h * 2 * (2 * isa.WR_WORDS + 2)   # templates + stages
                  + 2 + val_len + h)           # scatter table
    mem_words = -(-(code_words + data_words + 32) // 128) * 128

    p = Program(mem_words)
    p.add_wq(1)                 # WQ0: all-zero null bucket (padding guard)

    # data: response defaults to the needs-displacement report
    resp = p.alloc(2, [SET_NEEDS_DISPLACEMENT, 0], "resp")
    key_w = p.word(0, "key")
    val_stage = p.alloc(val_len, [0] * val_len, "val_stage")
    values = p.alloc(n_buckets * val_len, name="values")
    # table rows [key=0, pad, val_ptr]: val_ptr column baked statically
    tbl_init = [0] * (n_buckets * BUCKET_WORDS)
    for b in range(n_buckets):
        tbl_init[b * BUCKET_WORDS + 2] = values + b * val_len
    table = p.alloc(n_buckets * BUCKET_WORDS, tbl_init, "table")

    rq = p.add_wq(2)
    rd1s, m_tmpls, m_mods = _emit_set_match_phase(
        p, rq, h, key_w, val_stage, val_len, resp)
    _emit_set_claim_phase(p, rd1s, m_tmpls, m_mods, h, key_w, val_stage,
                          val_len, resp)

    # RECV scatter: key, staged value words, one probe addr per READ
    tbl = p.scatter_table(
        [key_w] + [val_stage + j for j in range(val_len)]
        + [rd.addr("src") for rd in rd1s])
    rq.recv(scatter_table=tbl, tag="wr.recv")

    spec, st0 = p.finalize(device=dev)
    return HopscotchShardWriter(
        prog=p, spec=spec, state0=st0, n_buckets=n_buckets,
        val_len=val_len, neighborhood=neighborhood, table_base=table,
        values_base=values, resp_region=resp, recv_wq=rq.index)


# ---------------------------------------------------------------------------
# §3.5 multi-writer: N independent SET lanes racing over ONE shared table
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class MultiWriterGroup:
    """N independent hopscotch writer lanes sharing ONE memory image.

    Each *lane* is a full writer pipeline — private recv WQ, match phase,
    claim phase, response and staging regions — but the table and value
    rows are allocated once and shared, so the lanes' pre-posted
    :func:`repro_torch.core.constructs.emit_cas_claim` CASes genuinely
    race: the claim ``EMPTY -> key`` on the shared bucket word is the
    arbitration point (§3.5's concurrent writers).  Interleaving is set by
    a :class:`machine.Schedule` over ``writer_slices`` (each lane's
    contiguous WQ index range).  A lane may also be a DELETE or a CLOCK
    SWEEP lane (``lane_kinds``), so the whole Memcached write mix races
    under one schedule.

    **Linearizability.** A claim CAS is one atomic VM step, so each bucket
    is won by exactly one lane at one step; a loser observes ``old !=
    expect``, leaves the cell untouched and re-probes the next bucket —
    the path it would take running strictly after the winner.  Lanes share
    nothing else, so for distinct keys the committed state under any
    schedule equals the serialized order in which the contended claims
    won.  (Two lanes inserting the *same* key can both claim distinct
    EMPTY buckets — a duplicate no serial order produces; the store's
    sharded path never issues that, and fsck flags ``dup-key``.)
    """
    prog: Program
    spec: machine.MachineSpec
    state0: machine.VMState
    n_buckets: int
    val_len: int
    neighborhood: int
    n_writers: int
    table_base: int
    values_base: int
    lanes: tuple               # per writer: (recv_wq, resp_region)
    writer_slices: tuple       # per writer: (lo, hi) WQ index range
    lane_kinds: tuple          # per writer: "set" | "delete" | "sweep"

    resp_words = 2             # [status, bucket addr] per lane

    @property
    def engine(self) -> ChainEngine:
        return ChainEngine.for_spec(self.spec)

    @property
    def fuel(self) -> int:
        """Safe global step budget: nothing is recycled, so the total
        posted count bounds any schedule's run."""
        return _fuel(self.state0)

    @property
    def writer_fuel(self) -> int:
        """Steps after which any single lane has certainly quiesced — the
        cut-point sweep's upper bound (per-lane posted count max)."""
        tails = self.state0.tail.cpu().numpy()
        return int(max(tails[lo:hi].sum()
                       for lo, hi in self.writer_slices)) + 1

    def lap_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """An owner-major window (S, R, W) as laps of the group's lanes
        (S, R / n_writers rounded up, n_writers, W), the last
        zero-padded: lap ``i``'s row ``w`` feeds lane ``w``."""
        s, r, w = rows.shape
        pad = (-r) % self.n_writers
        return torch.cat([rows, rows.new_zeros((s, pad, w))],
                         dim=1).reshape(s, -1, self.n_writers, w)

    def device_state(self, keys: torch.Tensor, vals: torch.Tensor,
                     exp: Optional[torch.Tensor] = None) -> machine.VMState:
        """Image with the shared table scattered in: keys (..., n), vals
        (..., n, V); leading dims stack one machine per table.  ``exp``
        (only with a ``"sweep"`` lane): per-bucket TTL deadlines into the
        pad words."""
        return _scatter_rows(self.state0, keys, vals,
                             table_base=self.table_base,
                             values_base=self.values_base, pad=exp)

    def device_payloads(self, queries: torch.Tensor, home: torch.Tensor,
                        values: torch.Tensor) -> torch.Tensor:
        """``[key, value x V, probe addrs x H]`` — one row per request;
        row ``w`` of an ``(n_writers, ...)`` lap feeds lane ``w``."""
        addrs = _probe_addrs(home, self.neighborhood, self.n_buckets,
                             self.table_base)
        return torch.cat([queries[:, None].to(torch.int32),
                          values.to(torch.int32).reshape(-1, self.val_len),
                          addrs], dim=1)

    def device_delete_payloads(self, queries: torch.Tensor,
                               home: torch.Tensor) -> torch.Tensor:
        """``[key, probe addrs x H]`` for a DELETE lane — narrower than a
        SET row; the caller zero-pads rows to a common width (a lane's
        RECV scatters exactly its own table, so pad words are never
        read)."""
        addrs = _probe_addrs(home, self.neighborhood, self.n_buckets,
                             self.table_base)
        return torch.cat([queries[:, None].to(torch.int32), addrs], dim=1)

    def device_sweep_payloads(self, buckets: torch.Tensor,
                              now) -> torch.Tensor:
        """``[bucket_addr, deadline_addr, -now]`` for a SWEEP lane (the
        :meth:`ClockSweeper.device_payloads` row); the caller zero-pads
        rows to the group's common width."""
        addr = self.table_base + buckets.to(torch.int32) * BUCKET_WORDS
        negnow = torch.full_like(addr, -int(now))
        return torch.stack([addr, addr + 1, negnow], dim=1)

    def delivered_state(self, keys: torch.Tensor, vals: torch.Tensor,
                        payloads: torch.Tensor,
                        exp: Optional[torch.Tensor] = None
                        ) -> machine.VMState:
        """The batch of machines :meth:`run_group` runs, before it runs:
        keys (G, n), vals (G, n, V) and ``exp`` scattered in, payload row
        ``payloads[g, w]`` (G, n_writers, W) delivered to lane ``w`` of
        machine ``g``.  A fresh allocation the caller may run in place."""
        st = machine.VMState(*(a.clone() for a in self.device_state(
            keys, vals, exp)))
        dev = st.mem.device
        pays = machine.pad_payload_rows(payloads.to(device=dev,
                                                    dtype=torch.int32))
        g = torch.arange(st.mem.shape[0], device=dev)
        cap = st.msg_buf.shape[-2]
        for w, (recv_wq, _) in enumerate(self.lanes):
            slot = torch.remainder(st.msg_tail[:, recv_wq], cap).long()
            st.msg_buf[g, recv_wq, slot] = pays[:, w]
            st.msg_tail[:, recv_wq] += 1
        return st

    def run_group(self, keys: torch.Tensor, vals: torch.Tensor,
                  payloads: torch.Tensor, schedule: machine.Schedule,
                  max_steps: int = 4096,
                  exp: Optional[torch.Tensor] = None):
        """One concurrent group round: deliver payload row ``w`` to lane
        ``w``, run all lanes over the shared image under ``schedule``,
        read the table and value regions straight back (every executed
        WR's write is already in the image).

        keys (n,) or (G, n), vals (..., n, V), payloads (..., n_writers,
        W); a leading G runs G independent groups, each against its own
        table, as one batch (the schedule's quota is then ``(R, W)`` for
        all or ``(G, R, W)``).  Returns ``(status (..., n_writers),
        new_keys, new_vals)``.  A zero-padded lane (key 0) probes the
        null guard region and reports status 0; it never touches the
        table.

        With ``exp`` (a group that has a ``"sweep"`` lane) the deadline
        column rides the image too and the return gains ``new_exp``;
        buckets that came back EMPTY are normalized to :data:`NO_TTL`.
        """
        single = keys.ndim == 1
        if single:
            keys, vals, payloads = keys[None], vals[None], payloads[None]
            exp = None if exp is None else exp[None]
        st = self.delivered_state(keys, vals, payloads, exp)
        dev = st.mem.device
        out = machine.run_scheduled_in_place(self.spec, st, schedule,
                                             self.writer_slices, max_steps)
        pays = payloads.to(device=dev, dtype=torch.int32)
        rows = torch.arange(self.n_buckets, dtype=torch.int64, device=dev)
        keys_out, vals_out = _image_rows(out.mem, self.table_base,
                                         self.values_base, rows,
                                         self.val_len)
        resp = torch.tensor([r for _, r in self.lanes], device=dev)
        status = torch.where(pays[..., 0] == EMPTY_KEY, 0, out.mem[:, resp])
        result = (status, keys_out.to(keys.dtype), vals_out.to(vals.dtype))
        if exp is not None:
            exp_out = out.mem[:, self.table_base + rows * BUCKET_WORDS + 1]
            exp_out = torch.where(keys_out == EMPTY_KEY, NO_TTL, exp_out)
            result += (exp_out.to(exp.dtype),)
        return tuple(a[0] for a in result) if single else result


def build_multi_writer_group(n_buckets: int, val_len: int,
                             neighborhood: int = 8, n_writers: int = 2,
                             lane_kinds: Optional[tuple] = None,
                             device=None) -> MultiWriterGroup:
    """Build (and cache per geometry and device) the N-writer
    shared-table group.

    Structurally ``n_writers`` copies of :func:`build_hopscotch_writer`'s
    lane emitted into one :class:`Program` against one table/values
    allocation; each lane's WQs form a contiguous index slice for
    :func:`machine.run_scheduled` masking.  ``lane_kinds`` (default: all
    ``"set"``) assigns each lane a verb — ``"set"``, ``"delete"`` (payload
    rows: :meth:`MultiWriterGroup.device_delete_payloads`) or ``"sweep"``
    (the CLOCK eviction body; payload rows:
    :meth:`MultiWriterGroup.device_sweep_payloads`, deadlines in the
    table's pad words)."""
    return _build_multi_writer_group(
        n_buckets, val_len, neighborhood, n_writers,
        None if lane_kinds is None else tuple(lane_kinds),
        device_mod.resolve(device))


@functools.lru_cache(maxsize=None)
def _build_multi_writer_group(n_buckets: int, val_len: int,
                              neighborhood: int, n_writers: int,
                              lane_kinds: Optional[tuple],
                              dev: torch.device) -> MultiWriterGroup:
    if n_writers < 1:
        raise ValueError("n_writers must be >= 1")
    if lane_kinds is None:
        lane_kinds = ("set",) * n_writers
    if len(lane_kinds) != n_writers:
        raise ValueError(
            f"lane_kinds has {len(lane_kinds)} entries for "
            f"{n_writers} writers")
    bad = sorted(set(lane_kinds) - {"set", "delete", "sweep"})
    if bad:
        raise ValueError(f"unknown lane kinds {bad!r} "
                         "(expected 'set', 'delete', or 'sweep')")
    if not 1 <= neighborhood:
        raise ValueError("neighborhood must be >= 1")
    if 1 + val_len + neighborhood > min(isa.MAX_SCATTER, isa.MSG_WORDS):
        raise ValueError(
            f"val_len {val_len} + neighborhood {neighborhood} exceeds the "
            f"one-SEND request budget ({isa.MAX_SCATTER}-scatter RECV)")
    h = neighborhood
    n_del = lane_kinds.count("delete")
    n_swp = lane_kinds.count("sweep")
    n_set = n_writers - n_del - n_swp

    # exact image sizing: guard + per-lane code; shared table/values +
    # per-lane data.  A delete or sweep lane's ghost lap covers words
    # [0..2] and a val_len zero-write, so the guard widens when one is
    # present.
    lane_code_set = (2 + h * (7 + 3 + 3) + 5 * h + 4 * h + 3 * h)
    lane_code_del = 2 + h * (8 + 3 + 4 + 3)
    lane_code_swp = 2 + sum(_SWEEP_WQS)
    guard_slots = (1 if not (n_del or n_swp)
                   else max(1, -(-val_len // isa.WR_WORDS)))
    code_words = (guard_slots + n_set * lane_code_set
                  + n_del * lane_code_del
                  + n_swp * lane_code_swp) * isa.WR_WORDS
    lane_data_set = (2 + 1 + val_len                 # resp, key_w, val_stage
                     + h * 2 * (2 * isa.WR_WORDS + 2)  # templates + stages
                     + 2 + val_len + h)              # scatter table
    lane_data_del = (2 + 1                           # resp, key_w
                     + h * (2 * isa.WR_WORDS + 2)    # templates + stages
                     + 2 + h)                        # scatter table
    lane_data_swp = 2 + 2 + 1 + 3                    # resp, cells, scatter
    data_words = (n_buckets * val_len + n_buckets * BUCKET_WORDS
                  + (val_len if (n_del or n_swp) else 0)  # shared zero row
                  + (1 if n_swp else 0)              # shared NO_TTL word
                  + n_set * lane_data_set
                  + n_del * lane_data_del
                  + n_swp * lane_data_swp)
    mem_words = -(-(code_words + data_words + 32) // 128) * 128

    p = Program(mem_words)
    p.add_wq(guard_slots)       # WQ0: all-zero null bucket (padding guard)

    # shared state: ONE value region, ONE table (pad words carry the TTL
    # deadlines when a sweep lane is present — NO_TTL until scattered)
    values = p.alloc(n_buckets * val_len, name="values")
    tbl_init = [0] * (n_buckets * BUCKET_WORDS)
    for b in range(n_buckets):
        if n_swp:
            tbl_init[b * BUCKET_WORDS + 1] = NO_TTL
        tbl_init[b * BUCKET_WORDS + 2] = values + b * val_len
    table = p.alloc(n_buckets * BUCKET_WORDS, tbl_init, "table")
    zeros_v = (p.alloc(val_len, [0] * val_len, "zeros")
               if (n_del or n_swp) else None)
    no_ttl_w = p.word(NO_TTL, "no_ttl") if n_swp else None

    lanes, slices = [], []
    for w, kind in enumerate(lane_kinds):
        if kind == "set":
            resp = p.alloc(2, [SET_NEEDS_DISPLACEMENT, 0], f"resp{w}")
            key_w = p.word(0, f"key{w}")
            val_stage = p.alloc(val_len, [0] * val_len, f"val_stage{w}")

            lo = len(p.wqs)
            rq = p.add_wq(2)
            rd1s, m_tmpls, m_mods = _emit_set_match_phase(
                p, rq, h, key_w, val_stage, val_len, resp)
            _emit_set_claim_phase(p, rd1s, m_tmpls, m_mods, h, key_w,
                                  val_stage, val_len, resp)
            tbl = p.scatter_table(
                [key_w] + [val_stage + j for j in range(val_len)]
                + [rd.addr("src") for rd in rd1s])
            rq.recv(scatter_table=tbl, tag="wr.recv")
        elif kind == "delete":
            resp = p.alloc(2, [DEL_MISS, 0], f"resp{w}")
            key_w = p.word(0, f"key{w}")

            lo = len(p.wqs)
            rq = p.add_wq(2)
            rd1s = _emit_delete_probes(p, rq, h, val_len, key_w, resp,
                                       zeros_v)
            tbl = p.scatter_table(
                [key_w] + [rd.addr("src") for rd in rd1s])
            rq.recv(scatter_table=tbl, tag="dl.recv")
        else:
            resp = p.alloc(2, [SWEEP_LIVE, 0], f"resp{w}")
            bucket_w = p.word(0, f"bucket{w}")
            e_cell = p.word(0, f"e{w}")

            lo = len(p.wqs)
            rq = p.add_wq(2)
            scatter = _emit_sweep_lane(p, rq, val_len, resp, bucket_w,
                                       e_cell, no_ttl_w, zeros_v)
            tbl = p.scatter_table(scatter)
            rq.recv(scatter_table=tbl, tag="sw.recv")
        lanes.append((rq.index, resp))
        slices.append((lo, len(p.wqs)))

    spec, st0 = p.finalize(device=dev)
    return MultiWriterGroup(
        prog=p, spec=spec, state0=st0, n_buckets=n_buckets,
        val_len=val_len, neighborhood=neighborhood, n_writers=n_writers,
        table_base=table, values_base=values, lanes=tuple(lanes),
        writer_slices=tuple(slices), lane_kinds=lane_kinds)


# ---------------------------------------------------------------------------
# bounded CAS-retry demo: two writers racing retry loops on one static cell
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class CasRetryPair:
    """Two chains running :func:`repro_torch.core.constructs.
    emit_cas_retry_loop` against ONE statically named cell — the minimal
    genuinely racing program.  The winner's stamped template writes ``w +
    1`` to its mark word; a loser retries with exponential NOOP backoff
    until its attempts exhaust, leaving its mark 0."""
    prog: Program
    spec: machine.MachineSpec
    state0: machine.VMState
    cell: int
    marks: tuple               # per writer: mark word address
    writer_slices: tuple       # per writer: (lo, hi) WQ index range
    attempts: int

    @property
    def fuel(self) -> int:
        return _fuel(self.state0)


def build_cas_retry_pair(attempts: int = 2, backoff_base: int = 1,
                         device=None) -> CasRetryPair:
    """Build the two-writer CAS-retry race on ``device`` (not memoized:
    callers may mutate the posted image to engineer broken variants)."""
    p = Program(1024)
    cell = p.word(0, "cell")
    marks, slices = [], []
    n_ctl = sum(3 + ((1 + (backoff_base << (a - 1))) if a else 0)
                for a in range(attempts))
    for w in range(2):
        mark = p.word(0, f"mark{w}")
        # 2-WR suppressed result template: WRITE_IMM mark <- w+1, NOOP pad
        tmpl = p.alloc(2 * isa.WR_WORDS, [
            isa.pack_ctrl(isa.WRITE_IMM, 0), isa.FLAG_SUPPRESS_COMPLETION,
            -1, mark, 1, w + 1, 0, -1,
            isa.pack_ctrl(isa.NOOP, 0), isa.FLAG_SUPPRESS_COMPLETION,
            0, 0, 1, 0, 0, -1], f"tmpl{w}")
        lo = len(p.wqs)
        ctl = p.add_wq(n_ctl, ordering=isa.ORD_DOORBELL)
        mod = p.add_wq(3 * attempts, ordering=isa.ORD_DOORBELL,
                       managed=True, initial_enable=0)
        constructs.emit_cas_retry_loop(
            ctl, mod, cell=cell, expect=0, new=w + 1, template=tmpl,
            attempts=attempts, backoff_base=backoff_base, tag=f"w{w}")
        marks.append(mark)
        slices.append((lo, len(p.wqs)))
    spec, st0 = p.finalize(device=device_mod.resolve(device))
    return CasRetryPair(prog=p, spec=spec, state0=st0, cell=cell,
                        marks=tuple(marks), writer_slices=tuple(slices),
                        attempts=attempts)


@dataclasses.dataclass(frozen=True, eq=False)
class HopscotchShardDisplacer(HopscotchShardWriter):
    """The displacement escalation of :class:`HopscotchShardWriter`.

    A neighborhood-full insert needs the hopscotch *bubble*: find the
    first EMPTY bucket past the neighborhood, repeatedly move a bucket
    from the window ``[free-H+1, free)`` into it, and stop once the free
    slot lands inside the requester's neighborhood.  This program is that
    loop, bounded and unrolled (Fig. 5), with
    :func:`repro_torch.core.constructs.emit_enable_branch` as its exits:

    * **match** — the shared H-probe phase (``SET_UPDATED`` on a hit);
    * **search** — up to ``max_search`` sequential probes from home; the
      first EMPTY latches the free slot's address and distance into the
      ``free``/``dist`` carry words;
    * **bubble** — up to ``max_moves`` laps: a break-check (``dist <=
      H-1`` releases the claim), then a scan of ``back = H-1 .. 1`` whose
      first movable candidate (its home distance, the bucket's pad word,
      satisfies ``pad + back <= H-1``) runs an
      :func:`~repro_torch.core.constructs.emit_displace_move`;
    * **claim** — :func:`~repro_torch.core.constructs.emit_cas_claim` on
      the final free slot: ``[SET_INSERTED | SET_DISPLACED, addr]``.

    Any dead end quiesces on the pre-set ``[SET_NEEDS_RESIZE, 0]`` and
    :meth:`commit` discards the image's partial moves, exactly like the
    bounded host oracle ``hopscotch.HopscotchTable.set_full``.

    **The unwrapped frame.** Verbs add constants; they do not reduce
    modulo the table.  So the image carries ``n_buckets + max_search``
    rows where row ``r`` mirrors bucket ``r % n_buckets``, and every
    address a request touches is the unwrapped position ``home + d``;
    :meth:`commit` folds the image back by per-word diff against the
    pre-state (at most one copy of any word changed).
    """
    max_search: int = 0
    max_moves: int = 0

    @property
    def walk_layout(self) -> WalkLayout:
        """The unwrapped frame: ``max_search`` mirror rows, the pad words
        each row's home distance; UPDATED, INSERTED and DISPLACED
        commit."""
        n = self.n_buckets
        return WalkLayout(
            (WalkFrame(self.table_base, self.values_base, n,
                       n + self.max_search, self.val_len, 0, 1,
                       home_pad=self.neighborhood),),
            (SET_UPDATED, SET_INSERTED, SET_DISPLACED), self.resp_region,
            self.recv_wq)

    def device_state(self, keys: torch.Tensor,
                     vals: torch.Tensor) -> machine.VMState:
        """Image with the shard slice scattered into the unwrapped frame:
        each of the ``n + max_search`` rows gets ``[key, pad, val_ptr]``
        with ``pad`` the resident's home distance ``(row - home(key)) %
        n``, or ``H`` for an EMPTY row (never movable)."""
        n = self.n_buckets
        dev = self.state0.mem.device
        src = torch.remainder(torch.arange(
            n + self.max_search, dtype=torch.int64, device=dev), n)
        k = keys.to(device=dev, dtype=torch.int32)[..., src]
        home = bucket_home(k, n)
        pad = torch.where(k != EMPTY_KEY,
                          torch.remainder(src.to(torch.int32) - home, n),
                          self.neighborhood).to(torch.int32)
        return _scatter_rows(self.state0, k,
                             vals.to(device=dev)[..., src, :],
                             table_base=self.table_base,
                             values_base=self.values_base, pad=pad)

    def device_payloads(self, queries: torch.Tensor, home: torch.Tensor,
                        values: torch.Tensor) -> torch.Tensor:
        """``[key, value x V, home_addr]`` — one scattered home address;
        the chain derives every probe address from it."""
        addrs = self.table_base + home.to(torch.int32) * BUCKET_WORDS
        return torch.cat([queries[:, None].to(torch.int32),
                          values.to(torch.int32).reshape(-1, self.val_len),
                          addrs[:, None].to(torch.int32)], dim=1)

    def commit(self, out_mem: torch.Tensor, payload: torch.Tensor,
               keys: torch.Tensor, vals: torch.Tensor):
        """Fold G quiesced contexts back into their arrays by diff (see
        :func:`_fold_mirrored`).  Nothing commits unless the status is
        UPDATED/INSERTED/DISPLACED."""
        status = out_mem[:, self.resp_region]
        live = payload[:, 0] != EMPTY_KEY
        applied = live & ((status == SET_UPDATED) | (status == SET_INSERTED)
                          | (status == SET_DISPLACED))
        new_k, new_v = _fold_mirrored(out_mem, keys, vals, self.table_base,
                                      self.values_base, self.max_search)
        keys_out = torch.where(applied[:, None], new_k, keys.to(torch.int32))
        vals_out = torch.where(applied[:, None, None], new_v,
                               vals.to(torch.int32))
        return (torch.where(live, status, 0), keys_out.to(keys.dtype),
                vals_out.to(vals.dtype))

    def commit_torn(self, out_mem: torch.Tensor, payload: torch.Tensor,
                    keys: torch.Tensor, vals: torch.Tensor):
        """Fault-mode commit: :meth:`commit`'s fold with the status gate
        removed.  An interrupted bubble's executed moves have landed (a
        half-done move leaves a key in two buckets); folding them back
        ungated is what lets fsck see, and recovery repair, the torn
        displacement."""
        live = payload[:, 0] != EMPTY_KEY
        new_k, new_v = _fold_mirrored(out_mem, keys, vals, self.table_base,
                                      self.values_base, self.max_search)
        keys_out = torch.where(live[:, None], new_k, keys.to(torch.int32))
        vals_out = torch.where(live[:, None, None], new_v,
                               vals.to(torch.int32))
        return (torch.where(live, out_mem[:, self.resp_region], 0),
                keys_out.to(keys.dtype), vals_out.to(vals.dtype))


def build_hopscotch_displacer(n_buckets: int, val_len: int,
                              neighborhood: int = 8, max_search: int = 16,
                              max_moves: int = 8,
                              device=None) -> HopscotchShardDisplacer:
    """Build (and cache per geometry and device) the per-shard
    displacement chain.  ``max_search`` bounds the free-slot probe from
    the home bucket (and sizes the unwrapped mirror rows); ``max_moves``
    bounds the bubble.  Both bounds are mirrored by the host oracle
    ``hopscotch.HopscotchTable.set_full``."""
    return _build_hopscotch_displacer(n_buckets, val_len, neighborhood,
                                      max_search, max_moves,
                                      device_mod.resolve(device))


@functools.lru_cache(maxsize=None)
def _build_hopscotch_displacer(n_buckets: int, val_len: int,
                               neighborhood: int, max_search: int,
                               max_moves: int, dev: torch.device
                               ) -> HopscotchShardDisplacer:
    h, s, m = neighborhood, max_search, max_moves
    if h < 2:
        raise ValueError("displacement needs a neighborhood >= 2 "
                         "(the bubble window [free-H+1, free) is empty)")
    if not h <= s <= n_buckets:
        raise ValueError(
            f"max_search must be in [neighborhood, n_buckets], got {s}")
    if m < 1:
        raise ValueError("max_moves must be >= 1")
    if 1 + val_len + 1 > min(isa.MAX_SCATTER, isa.MSG_WORDS):
        raise ValueError(
            f"val_len {val_len} exceeds the one-SEND request budget")
    ext = n_buckets + s

    # exact image sizing: WQ slots (code) + data
    SCTL, SMOD, SFND = 9, 2, 4            # per search probe
    BCTL, BMOD = 7, 2                     # per break-check
    PCTL, PMOD, PMOVE = 13, 2, 20         # per window probe
    CLDRV, CLMOD = 9, 3
    # null-guard sizing: a zero-padded request derives its H probe
    # addresses from home_w = 0, so the guard's zero words must cover
    # every derived read — probe pi reads [pi*BW] and [pi*BW + 2] — and
    # the ghost update's value write of val_len words at val_ptr 0
    guard_slots = max(2, -(-((h - 1) * BUCKET_WORDS + 3) // isa.WR_WORDS),
                      -(-val_len // isa.WR_WORDS))
    wq_slots = (guard_slots + 2 + h * (3 + 9 + 3) + (h + 1)
                + s * (SCTL + SMOD + SFND) + (m + 1) * (BCTL + BMOD)
                + m * (h - 1) * (PCTL + PMOD + PMOVE) + CLDRV + CLMOD)
    data_words = (2 + 5 + 2 * val_len            # resp, carries, stages
                  + ext * val_len                # value rows (mirrored)
                  + ext * BUCKET_WORDS           # table (mirrored)
                  + (h + 1) * 18                 # match + claim templates
                  + 2 + val_len + 1)             # scatter table
    mem_words = -(-(wq_slots * isa.WR_WORDS + data_words + 32) // 128) * 128

    p = Program(mem_words)
    # WQ0: the null region a zero-padded request's match probes hit
    guard = p.add_wq(guard_slots)

    resp = p.alloc(2, [SET_NEEDS_RESIZE, 0], "resp")
    key_w = p.word(0, "key")
    home_w = p.word(0, "home")
    free_w = p.word(0, "free")     # carry: free slot's (unwrapped) address
    dist_w = p.word(0, "dist")     # carry: its bucket distance from home
    cand_w = p.word(0, "cand")     # scratch: current window candidate
    val_stage = p.alloc(val_len, [0] * val_len, "val_stage")
    zeros_v = p.alloc(val_len, [0] * val_len, "zeros")
    values = p.alloc(ext * val_len, name="values")
    tbl_init = [0] * (ext * BUCKET_WORDS)
    for b in range(ext):
        tbl_init[b * BUCKET_WORDS + 2] = values + b * val_len
    table = p.alloc(ext * BUCKET_WORDS, tbl_init, "table")

    rq = p.add_wq(2)

    # --- match phase (shared emission; probe addrs derived from home) -----
    _, _, m_mods = _emit_set_match_phase(
        p, rq, h, key_w, val_stage, val_len, resp, home_w=home_w)

    # --- the control-flow WQs up front (branches name successors) ---------
    def wqs(size, count):
        return [p.add_wq(size, ordering=isa.ORD_DOORBELL, managed=True,
                         initial_enable=0) for _ in range(count)]

    sgate = p.add_wq(h + 1, ordering=isa.ORD_DOORBELL, managed=True)
    sctl, smod, sfnd = wqs(SCTL, s), wqs(SMOD, s), wqs(SFND, s)
    bctl, bmod = wqs(BCTL, m + 1), wqs(BMOD, m + 1)
    pctl = [wqs(PCTL, h - 1) for _ in range(m)]
    pmod = [wqs(PMOD, h - 1) for _ in range(m)]
    pmove = [wqs(PMOVE, h - 1) for _ in range(m)]
    cldrv, clmod = wqs(CLDRV, 1)[0], wqs(CLMOD, 1)[0]

    # --- search phase: gated on every match probe resolving un-hit --------
    for pi in range(h):
        sgate.wait(m_mods[pi], 3, tag=f"dp.nomatch{pi}")
    sgate.enable(sctl[0], upto=SCTL, tag="dp.search")
    sgate.initial_enable = sgate.n_posted + 1

    for si in range(s):
        ctl = sctl[si]

        def load_key(a_addr, b_addr, ctl=ctl, si=si):
            ctl.write(src=home_w, dst=ctl.future_wr_addr(2, "src"),
                      tag=f"dp.sp{si}")
            ctl.add(dst=ctl.future_wr_addr(1, "src"),
                    addend=si * BUCKET_WORDS, tag=f"dp.so{si}")
            ctl.read(src=0, dst=a_addr, ln=1, tag=f"dp.skey{si}")
            ctl.write(src=a_addr, dst=b_addr, tag=f"dp.scp{si}")

        nxt = (sctl[si + 1].index, SCTL) if si + 1 < s else (guard.index, 0)
        constructs.emit_enable_branch(
            ctl, smod[si], threshold=EMPTY_KEY,
            then_wq=sfnd[si].index, then_upto=SFND,
            else_wq=nxt[0], else_upto=nxt[1], load=load_key,
            tag=f"dp.sbr{si}")

        # found: latch the free slot's unwrapped address + home distance
        sfnd[si].write(src=home_w, dst=free_w, tag=f"dp.free{si}")
        sfnd[si].add(dst=free_w, addend=si * BUCKET_WORDS,
                     tag=f"dp.foff{si}")
        sfnd[si].write_imm(dst=dist_w, value=si, tag=f"dp.dist{si}")
        sfnd[si].enable(bctl[0], upto=BCTL, tag=f"dp.go{si}")

    # --- bubble laps: break-check + window scan + one move ----------------
    for li in range(m + 1):
        def load_dist(a_addr, b_addr, ctl=bctl[li], li=li):
            ctl.write(src=dist_w, dst=a_addr, tag=f"dp.bd{li}")
            ctl.write(src=dist_w, dst=b_addr, tag=f"dp.bd2{li}")

        cont = ((pctl[li][0].index, PCTL) if li < m else (guard.index, 0))
        constructs.emit_enable_branch(
            bctl[li], bmod[li], threshold=h - 1,
            then_wq=cldrv.index, then_upto=CLDRV,
            else_wq=cont[0], else_upto=cont[1], load=load_dist,
            tag=f"dp.brk{li}")

    cl_tmpl, cl_stage = _set_templates(p, val_stage, val_len, resp,
                                       SET_INSERTED)

    for li in range(m):
        for j in range(h - 1):
            back = h - 1 - j            # scan order: farthest-back first
            ctl = pctl[li][j]
            ctl.write(src=free_w, dst=cand_w, tag=f"dp.c{li}.{j}")
            ctl.add(dst=cand_w, addend=-back * BUCKET_WORDS,
                    tag=f"dp.cb{li}.{j}")

            def load_pad(a_addr, b_addr, ctl=ctl, back=back):
                ctl.write(src=cand_w, dst=ctl.future_wr_addr(2, "src"),
                          tag="dp.pp")
                ctl.add(dst=ctl.future_wr_addr(1, "src"), addend=1,
                        tag="dp.po")
                ctl.read(src=0, dst=a_addr, ln=1, tag="dp.pad")
                ctl.write(src=a_addr, dst=b_addr, tag="dp.pcp")
                ctl.add(dst=a_addr, addend=back, tag="dp.pb1")
                ctl.add(dst=b_addr, addend=back, tag="dp.pb2")

            nxt = ((pctl[li][j + 1].index, PCTL) if j + 1 < h - 1
                   else (guard.index, 0))
            constructs.emit_enable_branch(
                ctl, pmod[li][j], threshold=h - 1,
                then_wq=pmove[li][j].index, then_upto=PMOVE,
                else_wq=nxt[0], else_upto=nxt[1], load=load_pad,
                tag=f"dp.mv{li}.{j}")

            constructs.emit_displace_move(
                pmove[li][j], cand_w=cand_w, free_w=free_w, dist_w=dist_w,
                back=back, val_len=val_len, zeros=zeros_v,
                status_addr=cl_stage, status_val=SET_DISPLACED,
                next_wq=bctl[li + 1].index, next_upto=BCTL,
                empty_key=EMPTY_KEY, tag=f"dp.mv{li}.{j}")

    # --- claim phase: CAS-claim the final free slot -----------------------
    cldrv.write(src=free_w, dst=cldrv.future_wr_addr(2, "src"),
                tag="dp.clvp")
    cldrv.add(dst=cldrv.future_wr_addr(1, "src"), addend=2, tag="dp.clvo")
    cldrv.read(src=0, dst=cl_tmpl + isa.F_DST, ln=1, tag="dp.clv")
    cldrv.write(src=free_w, dst=cl_stage + 1, tag="dp.claddr")
    cldrv.write(src=free_w, dst=cldrv.future_wr_addr(2, "dst"),
                tag="dp.clcell")
    cldrv.write(src=key_w, dst=cldrv.future_wr_addr(1, "opb"),
                tag="dp.clnew")
    constructs.emit_cas_claim(
        cldrv, clmod, cell=0, expect=EMPTY_KEY, new=0, then_src=cl_tmpl,
        then_dst=clmod.future_wr_addr(1, "ctrl"), then_len=2 * isa.WR_WORDS)
    clmod.post(isa.NOOP, tag="dp.cle")        # event: value WRITE slot
    clmod.post(isa.NOOP, tag="dp.clf")        # event: response slot
    cldrv.enable(clmod, upto=3, tag="dp.clen")

    # RECV scatter: key, staged value words, the single home address
    tbl = p.scatter_table(
        [key_w] + [val_stage + j for j in range(val_len)] + [home_w])
    rq.recv(scatter_table=tbl, tag="dp.recv")

    spec, st0 = p.finalize(device=dev)
    return HopscotchShardDisplacer(
        prog=p, spec=spec, state0=st0, n_buckets=n_buckets,
        val_len=val_len, neighborhood=neighborhood, table_base=table,
        values_base=values, resp_region=resp, recv_wq=rq.index,
        max_search=max_search, max_moves=max_moves)


# ---------------------------------------------------------------------------
# online table growth: the migrator chain (one source bucket per lap)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class HopscotchShardMigrator:
    """One lap of online table growth (§5.6 "resize *while* serving").

    The store grows by migrating one **source bucket** per request from
    the old ``n``-bucket frame into a doubled ``2n``-bucket frame that
    serves concurrently (the double-frame mode of ``kvstore.store``).
    The chain per lap:

    * **select** — the new home under the doubled geometry is ``h_old +
      sel * n``, ``sel`` the next hash bit the wider mask exposes (``n``
      a power of two).  The client scatters ``sel`` and the lower-half
      probe base; a Calc-verb branch
      (:func:`repro_torch.core.constructs.emit_enable_branch` on ``sel``)
      releases the probes directly or first ADDs ``n`` buckets to the
      base — the mask recompute, in verbs.
    * **match** — H parallel probe pairs test the new-frame neighborhood
      for the key.  A hit (the key was re-written into the new frame
      while this stale copy sat in the old one) lands ``[MIG_DISCARDED,
      addr]`` and releases the **vacate** WQ: the newer value wins.
    * **claim** — gated on an all-miss match, sequential
      :func:`~repro_torch.core.constructs.emit_cas_claim` probes CAS the
      first EMPTY new-frame bucket ``EMPTY -> key``; the winner lands
      ``[MIG_MOVED, addr]`` and releases its **copy** WQ, whose WRITE
      moves the old value row across frames before releasing the vacate.
    * **vacate** — :func:`~repro_torch.core.constructs.emit_bucket_vacate`
      on the source bucket, only after the key is safe in the new frame.

    A full new-frame neighborhood quiesces on the pre-set
    ``[MIG_NEEDS_DISPLACE, 0]`` with both frames untouched (the caller
    escalates through the new frame's displacer chain).  The new frame is
    mirrored unwrapped (``2n + H - 1`` rows), and :meth:`commit` folds it
    back by per-word diff.
    """
    prog: Program
    spec: machine.MachineSpec
    state0: machine.VMState
    n_buckets: int             # OLD frame size n; the new frame holds 2n
    val_len: int
    neighborhood: int
    old_table_base: int
    old_values_base: int
    new_table_base: int
    new_values_base: int
    resp_region: int
    recv_wq: int

    resp_words = 2             # [status, bucket addr]

    @property
    def engine(self) -> ChainEngine:
        return ChainEngine.for_spec(self.spec)

    @property
    def fuel(self) -> int:
        """Exact step budget (no WQ recycles; see
        :attr:`HopscotchShardWriter.fuel`)."""
        return _fuel(self.state0)

    @property
    def walk_layout(self) -> WalkLayout:
        """Two frames: the old one straight, the new one of ``2n`` rows
        with ``H - 1`` mirror rows; MOVED and DISCARDED commit."""
        n, h, v = self.n_buckets, self.neighborhood, self.val_len
        return WalkLayout(
            (WalkFrame(self.old_table_base, self.old_values_base, n, n, v,
                       0, 1),
             WalkFrame(self.new_table_base, self.new_values_base, 2 * n,
                       2 * n + h - 1, v, 2, 3)),
            (MIG_MOVED, MIG_DISCARDED), self.resp_region, self.recv_wq)

    def device_state(self, old_keys: torch.Tensor, old_vals: torch.Tensor,
                     new_keys: torch.Tensor,
                     new_vals: torch.Tensor) -> machine.VMState:
        """Image with both frames scattered in (new frame unwrapped: rows
        ``r >= 2n`` mirror ``r - 2n``).  Leading dims of the arrays stack
        one machine per shard."""
        n, h = self.n_buckets, self.neighborhood
        dev = self.state0.mem.device
        src = torch.remainder(torch.arange(2 * n + h - 1, dtype=torch.int64,
                                           device=dev), 2 * n)
        old = _scatter_rows(self.state0, old_keys, old_vals,
                            table_base=self.old_table_base,
                            values_base=self.old_values_base)
        lead = tuple(old_keys.shape[:-1])
        rows = torch.arange(src.numel(), dtype=torch.int64, device=dev)
        cols = torch.arange(self.val_len, dtype=torch.int64, device=dev)
        mem = old.mem
        mem[..., self.new_table_base + rows * BUCKET_WORDS] = new_keys.to(
            device=dev, dtype=torch.int32)[..., src]
        vidx = self.new_values_base + rows[:, None] * self.val_len + cols
        mem[..., vidx.reshape(-1)] = new_vals.to(
            device=dev, dtype=torch.int32)[..., src, :].reshape(lead + (-1,))
        return old

    def device_payloads(self, buckets: torch.Tensor,
                        old_keys: torch.Tensor) -> torch.Tensor:
        """Request assembly: ``[key, sel, old_addr, lo_base]`` per source
        bucket.  ``buckets`` (..., B) int32 source-bucket indices into
        ``old_keys`` (..., n), the shards' old-frame key columns.  The
        client computes the hash and sends the *select bit* the doubled
        mask exposes plus the lower-half probe base; the chain recomputes
        the home by branching on ``sel``.  Rows whose source bucket is
        EMPTY are zeroed — inert padding."""
        n = self.n_buckets
        shift = n.bit_length() - 1
        k = old_keys.to(torch.int32).gather(-1, buckets.long())
        live = k != EMPTY_KEY
        h_old = bucket_home(k, n)
        ku = (k.to(torch.int64) & 0xFFFFFFFF) * _HASH_MULT & 0xFFFFFFFF
        sel = ((ku >> shift) & 1).to(torch.int32)
        old_addr = self.old_table_base + buckets.to(torch.int32) * BUCKET_WORDS
        lo = self.new_table_base + h_old * BUCKET_WORDS
        pay = torch.stack([k, sel, old_addr.to(torch.int32), lo], dim=-1)
        return (pay * live[..., None]).to(torch.int32)

    def _fold(self, out_mem, old_keys, old_vals, new_keys, new_vals):
        """Both frames as the G images left them: the old frame read
        straight off the image (a lap touches only its source bucket),
        the new frame folded by diff with the mirror merge."""
        rows = torch.arange(self.n_buckets, dtype=torch.int64,
                            device=out_mem.device)
        ko, vo = _image_rows(out_mem, self.old_table_base,
                             self.old_values_base, rows, self.val_len)
        kn, vn = _fold_mirrored(out_mem, new_keys, new_vals,
                                self.new_table_base, self.new_values_base,
                                self.neighborhood - 1)
        return ko, vo, kn, vn

    def _select(self, take, folded, old_keys, old_vals, new_keys, new_vals):
        t = take[:, None]
        ko, vo, kn, vn = folded
        return (torch.where(t, ko, old_keys.to(torch.int32)).to(
                    old_keys.dtype),
                torch.where(t[..., None], vo, old_vals.to(torch.int32)).to(
                    old_vals.dtype),
                torch.where(t, kn, new_keys.to(torch.int32)).to(
                    new_keys.dtype),
                torch.where(t[..., None], vn, new_vals.to(torch.int32)).to(
                    new_vals.dtype))

    def commit(self, out_mem: torch.Tensor, payload: torch.Tensor,
               old_keys: torch.Tensor, old_vals: torch.Tensor,
               new_keys: torch.Tensor, new_vals: torch.Tensor):
        """Fold G quiesced laps back into both frames.  Nothing commits
        unless the status is MOVED/DISCARDED: a NEEDS_DISPLACE lap (or a
        zero-padded slot) leaves both frames bit-identical.  Returns
        ``(status, old_keys, old_vals, new_keys, new_vals)``."""
        status = out_mem[:, self.resp_region]
        live = payload[:, 0] != EMPTY_KEY
        applied = live & ((status == MIG_MOVED) | (status == MIG_DISCARDED))
        folded = self._fold(out_mem, old_keys, old_vals, new_keys, new_vals)
        return (torch.where(live, status, 0),
                *self._select(applied, folded, old_keys, old_vals, new_keys,
                              new_vals))

    def commit_torn(self, out_mem: torch.Tensor, payload: torch.Tensor,
                    old_keys: torch.Tensor, old_vals: torch.Tensor,
                    new_keys: torch.Tensor, new_vals: torch.Tensor):
        """Fault-mode commit: :meth:`commit`'s fold with the status gate
        removed.  A lap cut between the new-frame claim and the old-frame
        vacate has written both or either; folding the torn image back
        exposes the cross-frame duplicate (or the claimed-but-uncopied
        row) to fsck."""
        live = payload[:, 0] != EMPTY_KEY
        folded = self._fold(out_mem, old_keys, old_vals, new_keys, new_vals)
        return (torch.where(live, out_mem[:, self.resp_region], 0),
                *self._select(live, folded, old_keys, old_vals, new_keys,
                              new_vals))

    def run_rows(self, old_keys: torch.Tensor, old_vals: torch.Tensor,
                 new_keys: torch.Tensor, new_vals: torch.Tensor,
                 payloads: torch.Tensor, max_steps: int = 2048):
        """G laps, lap ``g`` against shard ``g``'s two frames.  Returns
        ``(status (G,), old_keys, old_vals, new_keys, new_vals, steps
        (G,))``."""
        carry = (old_keys, old_vals, new_keys, new_vals)
        out = _run_contexts(self, self.device_state(*carry), payloads,
                            max_steps)
        return (*self.commit(out.mem, payloads, *carry), out.steps)

    def run_rows_faulted(self, old_keys: torch.Tensor, old_vals: torch.Tensor,
                         new_keys: torch.Tensor, new_vals: torch.Tensor,
                         payloads: torch.Tensor, max_steps: int, faults):
        """:meth:`run_rows` under a fault plan with one row per lap (see
        :func:`_run_rows_faulted`)."""
        return _run_rows_faulted(self, (old_keys, old_vals, new_keys,
                                        new_vals), payloads, max_steps,
                                 faults)

    def run_one(self, old_keys: torch.Tensor, old_vals: torch.Tensor,
                new_keys: torch.Tensor, new_vals: torch.Tensor,
                payload: torch.Tensor, max_steps: int = 2048):
        """One migration lap.  Returns ``(status, old_keys, old_vals,
        new_keys, new_vals)``."""
        out = self.run_rows(old_keys[None], old_vals[None], new_keys[None],
                            new_vals[None], payload[None], max_steps)
        return tuple(a[0] for a in out[:5])

    def run_one_faulted(self, old_keys: torch.Tensor, old_vals: torch.Tensor,
                        new_keys: torch.Tensor, new_vals: torch.Tensor,
                        payload: torch.Tensor, max_steps: int, faults):
        """:meth:`run_one` under a scalar-leaf fault plan (an armed plan
        commits the torn image)."""
        return _one_faulted(self, (old_keys, old_vals, new_keys, new_vals),
                            payload, max_steps, faults)


def build_hopscotch_migrator(n_buckets: int, val_len: int,
                             neighborhood: int = 8,
                             device=None) -> HopscotchShardMigrator:
    """Build (and cache per geometry and device) the per-shard table-growth
    chain.  ``n_buckets`` is the OLD frame size and must be a power of two
    — the doubled geometry's home recompute is "one more mask bit", which
    is what the in-chain select branch implements."""
    return _build_hopscotch_migrator(n_buckets, val_len, neighborhood,
                                     device_mod.resolve(device))


@functools.lru_cache(maxsize=None)
def _build_hopscotch_migrator(n_buckets: int, val_len: int,
                              neighborhood: int, dev: torch.device
                              ) -> HopscotchShardMigrator:
    h = neighborhood
    if h < 1:
        raise ValueError("neighborhood must be >= 1")
    if n_buckets < 1 or (n_buckets & (n_buckets - 1)):
        raise ValueError(
            f"resize needs a power-of-two bucket count (the doubled "
            f"mask exposes exactly one more hash bit), got {n_buckets}")
    if val_len > isa.MAX_COPY:
        raise ValueError(
            f"val_len {val_len} exceeds the one-WRITE row copy budget")
    n = n_buckets
    ext = 2 * n + h - 1

    # exact image sizing (code slots + data words)
    SELDRV, SELMOD = 11 + h, 2
    GOLO, GOHI = h, h + 1
    MDRV, MEXE, MMOD = 5, 3, 3
    CDRV, CEXE, CMOD = 7 * h, 4 * h, 3 * h
    VCLAIM, VMATCH = 2, 8
    # null-guard: a zero-padded slot probes [0, (h-1)*BW + key] and its
    # ghost vacate reads [0..2] and zero-writes val_len words at ptr 0
    guard_slots = max(2, -(-((h - 1) * BUCKET_WORDS + 3) // isa.WR_WORDS),
                      -(-val_len // isa.WR_WORDS))
    wq_slots = (guard_slots + 2 + SELDRV + SELMOD + GOLO + GOHI
                + h * (MDRV + MEXE + MMOD) + CDRV + CEXE + CMOD
                + h * VCLAIM + VMATCH)
    data_words = (2 + 5 + val_len                    # resp, words, zeros
                  + n * (val_len + BUCKET_WORDS)     # old frame
                  + ext * (val_len + BUCKET_WORDS)   # new frame (mirrored)
                  + 2 * h * 18                       # match+claim templates
                  + 1 + 4)                           # scatter table
    mem_words = -(-(wq_slots * isa.WR_WORDS + data_words + 32) // 128) * 128

    p = Program(mem_words)
    p.add_wq(guard_slots)                  # WQ0: the padding null region

    resp = p.alloc(2, [MIG_NEEDS_DISPLACE, 0], "resp")
    key_w = p.word(0, "key")
    sel_w = p.word(0, "sel")               # the doubled mask's new bit
    old_addr_w = p.word(0, "old_addr")     # source bucket (old frame)
    base_w = p.word(0, "base")             # probe base (new frame, lo half)
    vptr_w = p.word(0, "vptr")             # source bucket's value row
    zeros_v = p.alloc(val_len, [0] * val_len, "zeros")

    values_old = p.alloc(n * val_len, name="values_old")
    tbl_o = [0] * (n * BUCKET_WORDS)
    for b in range(n):
        tbl_o[b * BUCKET_WORDS + 2] = values_old + b * val_len
    table_old = p.alloc(n * BUCKET_WORDS, tbl_o, "table_old")
    values_new = p.alloc(ext * val_len, name="values_new")
    tbl_n = [0] * (ext * BUCKET_WORDS)
    for b in range(ext):
        tbl_n[b * BUCKET_WORDS + 2] = values_new + b * val_len
    table_new = p.alloc(ext * BUCKET_WORDS, tbl_n, "table_new")

    rq = p.add_wq(2)

    # --- control-flow WQs up front (templates/branches name successors) ---
    seldrv = p.add_wq(SELDRV, ordering=isa.ORD_DOORBELL, managed=True)
    selmod = p.add_wq(SELMOD, ordering=isa.ORD_DOORBELL, managed=True,
                      initial_enable=0)
    golo = p.add_wq(GOLO, ordering=isa.ORD_DOORBELL, managed=True,
                    initial_enable=0)
    gohi = p.add_wq(GOHI, ordering=isa.ORD_DOORBELL, managed=True,
                    initial_enable=0)
    vmatch = p.add_wq(VMATCH, ordering=isa.ORD_DOORBELL, managed=True,
                      initial_enable=0)
    vclaim = [p.add_wq(VCLAIM, ordering=isa.ORD_DOORBELL, managed=True,
                       initial_enable=0) for _ in range(h)]

    # --- vacate: retire the source bucket once the key is safe -----------
    constructs.emit_bucket_vacate(vmatch, bucket_w=old_addr_w,
                                  val_len=val_len, zeros=zeros_v,
                                  empty_key=EMPTY_KEY, tag="mg.vac")

    # --- per-probe cross-frame value copy (claim path only) --------------
    vclaim_wrs = []
    for pi in range(h):
        vw = vclaim[pi].write(src=0, dst=0, ln=val_len, tag=f"mg.vcp{pi}")
        vclaim[pi].enable(vmatch, upto=vmatch.n_posted, tag=f"mg.vgo{pi}")
        vclaim_wrs.append(vw)

    # --- match phase: H parallel probe pairs against the new frame -------
    rd1s, m_mods, m_drvs = [], [], []
    for pi in range(h):
        m_tmpl, m_stage = _vacate_templates(p, resp, MIG_DISCARDED,
                                            vmatch.index, vmatch.n_posted)
        mmod = p.add_wq(MMOD, ordering=isa.ORD_DOORBELL, managed=True,
                        initial_enable=0)
        mdrv = p.add_wq(MDRV, ordering=isa.ORD_DOORBELL, managed=True,
                        initial_enable=0)
        mexe = p.add_wq(MEXE, ordering=isa.ORD_DOORBELL, managed=True,
                        initial_enable=3)

        c_i = mmod.post(isa.NOOP, src=m_tmpl,
                        dst=mmod.future_wr_addr(1, "ctrl"),
                        ln=2 * isa.WR_WORDS, tag=f"mg.mc{pi}")
        mmod.post(isa.NOOP, tag=f"mg.me{pi}")     # event: response slot
        mmod.post(isa.NOOP, tag=f"mg.mf{pi}")     # event: ENABLE(vacate)

        mdrv.write(src=base_w, dst=mdrv.future_wr_addr(2, "src"),
                   tag=f"mg.mb{pi}")              # probe addr <- base + d*BW
        mdrv.add(dst=mdrv.future_wr_addr(1, "src"),
                 addend=pi * BUCKET_WORDS, tag=f"mg.mo{pi}")
        rd1 = mdrv.read(src=0, dst=c_i.ctrl_addr, ln=1, tag=f"mg.mr{pi}")
        mdrv.write(src=key_w, dst=mexe.future_wr_addr(1, "opa"),
                   tag=f"mg.mk{pi}")              # CAS comparand <- key
        last = mdrv.write(src=rd1.addr("src"), dst=m_stage + 1,
                          tag=f"mg.ma{pi}")       # match addr -> response

        mexe.wait(mdrv, last.completion_count, tag=f"mg.ms{pi}")
        mexe.cas(dst=c_i.ctrl_addr, old=isa.pack_ctrl(isa.NOOP, 0),
                 new=isa.pack_ctrl(isa.WRITE, 0), tag=f"mg.mx{pi}")
        mexe.enable(mmod, upto=3, tag=f"mg.men{pi}")
        rd1s.append(rd1)
        m_mods.append(mmod)
        m_drvs.append(mdrv)

    # --- claim phase: sequential CAS-claims, gated on an all-miss match --
    cdrv = p.add_wq(CDRV, ordering=isa.ORD_DOORBELL, managed=True)
    cexe = p.add_wq(CEXE, ordering=isa.ORD_DOORBELL, managed=True)
    cmod = p.add_wq(CMOD, ordering=isa.ORD_DOORBELL, managed=True,
                    initial_enable=0)

    claims = []
    for pi in range(h):
        cl_tmpl, cl_stage = _vacate_templates(p, resp, MIG_MOVED,
                                              vclaim[pi].index, VCLAIM)
        if pi == 0:
            cexe.wait(cdrv, CDRV, tag="mg.cgate")
        else:
            cexe.wait(cmod, 3 * pi, tag=f"mg.cseq{pi}")
        refs = constructs.emit_cas_claim(
            cexe, cmod, cell=0, expect=EMPTY_KEY, new=0, then_src=cl_tmpl,
            then_dst=cmod.future_wr_addr(1, "ctrl"),
            then_len=2 * isa.WR_WORDS)
        cmod.post(isa.NOOP, tag=f"mg.ce{pi}")     # event: response slot
        cmod.post(isa.NOOP, tag=f"mg.cf{pi}")     # event: ENABLE(copy)
        cexe.enable(cmod, upto=3 * (pi + 1), tag=f"mg.cen{pi}")
        claims.append((refs, cl_stage))
    cexe.initial_enable = cexe.n_posted + 1

    for pi in range(h):
        cdrv.wait(m_mods[pi], 3, tag=f"mg.nomatch{pi}")
    for pi, (refs, cl_stage) in enumerate(claims):
        cdrv.write(src=rd1s[pi].addr("src"), dst=refs.cell_dst_addr,
                   tag=f"mg.cdst{pi}")            # claim the probed bucket
        cdrv.write(src=key_w, dst=refs.new_opb_addr,
                   tag=f"mg.cnew{pi}")            # CAS new <- key
        cdrv.write(src=rd1s[pi].addr("src"),
                   dst=cdrv.future_wr_addr(2, "src"), tag=f"mg.cvp{pi}")
        cdrv.add(dst=cdrv.future_wr_addr(1, "src"), addend=2,
                 tag=f"mg.cvo{pi}")
        cdrv.read(src=0, dst=vclaim_wrs[pi].addr("dst"), ln=1,
                  tag=f"mg.cvr{pi}")              # claimed val_ptr -> copy dst
        cdrv.write(src=rd1s[pi].addr("src"), dst=cl_stage + 1,
                   tag=f"mg.caddr{pi}")           # claimed addr -> response
    cdrv.initial_enable = cdrv.n_posted + 1

    # --- select: the doubled mask's new bit, as a Calc-verb branch -------
    seldrv.wait(rq, 1, tag="mg.trig")
    # source value row -> every copy WR's src (the old row READ)
    seldrv.write(src=old_addr_w, dst=seldrv.future_wr_addr(2, "src"),
                 tag="mg.vp_p")
    seldrv.add(dst=seldrv.future_wr_addr(1, "src"), addend=2, tag="mg.vp_o")
    seldrv.read(src=0, dst=vptr_w, ln=1, tag="mg.vp")
    for pi in range(h):
        seldrv.write(src=vptr_w, dst=vclaim_wrs[pi].addr("src"),
                     tag=f"mg.vsrc{pi}")

    def load_sel(a_addr, b_addr):
        seldrv.write(src=sel_w, dst=a_addr, tag="mg.s1")
        seldrv.write(src=sel_w, dst=b_addr, tag="mg.s2")

    constructs.emit_enable_branch(
        seldrv, selmod, threshold=0,
        then_wq=golo.index, then_upto=GOLO,
        else_wq=gohi.index, else_upto=GOHI, load=load_sel, tag="mg.sel")
    seldrv.initial_enable = seldrv.n_posted + 1

    for pi in range(h):
        golo.enable(m_drvs[pi], upto=MDRV + 1, tag=f"mg.lo{pi}")
    gohi.add(dst=base_w, addend=n * BUCKET_WORDS, tag="mg.hi")
    for pi in range(h):
        gohi.enable(m_drvs[pi], upto=MDRV + 1, tag=f"mg.hi{pi}")

    # RECV scatter: key, select bit, source bucket, lo probe base
    tbl = p.scatter_table([key_w, sel_w, old_addr_w, base_w])
    rq.recv(scatter_table=tbl, tag="mg.recv")

    spec, st0 = p.finalize(device=dev)
    return HopscotchShardMigrator(
        prog=p, spec=spec, state0=st0, n_buckets=n, val_len=val_len,
        neighborhood=h, old_table_base=table_old,
        old_values_base=values_old, new_table_base=table_new,
        new_values_base=values_new, resp_region=resp, recv_wq=rq.index)


# ---------------------------------------------------------------------------
# the Memcached lifecycle verbs: DELETE and the CLOCK expiry sweeper
# ---------------------------------------------------------------------------

def _vacate_templates(p: Program, resp: int, status_default: int,
                      enable_wq: int, enable_upto: int):
    """16-word template (two event WRs): a suppressed ``[status,
    bucket_addr]`` response WRITE and a suppressed **ENABLE** releasing
    the vacate path, so one Fig.-6 conversion both answers and hands
    control to the retirement WQ (the JAX package's ``_mig_templates``,
    which its table-growth migrator shares)."""
    stage = p.alloc(2, [status_default, 0])
    tmpl = p.alloc(2 * isa.WR_WORDS, [
        isa.pack_ctrl(isa.WRITE, 0), isa.FLAG_SUPPRESS_COMPLETION,
        stage, resp, 2, 0, 0, -1,
        isa.pack_ctrl(isa.ENABLE, 0), isa.FLAG_SUPPRESS_COMPLETION,
        -1, -1, 1, enable_upto, enable_wq, -1])
    return tmpl, stage


def _emit_delete_probes(p: Program, rq, h: int, val_len: int, key_w: int,
                        resp: int, zeros: int):
    """The DELETE program's match-and-vacate phase: H parallel probes.

    Each probe READs its bucket key onto a conditional WR's control word
    and CAS-tests it against the query key; a hit converts the
    conditional into a template copy whose two suppressed events land
    ``[DEL_DELETED, bucket_addr]`` in the response region and ENABLE the
    probe's private vacate WQ —
    :func:`repro_torch.core.constructs.emit_bucket_vacate` on the matched
    bucket.  An all-miss request quiesces on the pre-set ``[DEL_MISS,
    0]``.  Returns the probe READs (their ``src`` fields are the RECV
    scatter targets).
    """
    VAC = 8                    # emit_bucket_vacate's exact WR count
    rd1s = []
    for pi in range(h):
        vac = p.add_wq(VAC, ordering=isa.ORD_DOORBELL, managed=True,
                       initial_enable=0)
        m_tmpl, m_stage = _vacate_templates(p, resp, DEL_DELETED,
                                            vac.index, VAC)
        mmod = p.add_wq(3, ordering=isa.ORD_DOORBELL, managed=True,
                        initial_enable=0)
        mdrv = p.add_wq(4, ordering=isa.ORD_DOORBELL, managed=True)
        mexe = p.add_wq(3, ordering=isa.ORD_DOORBELL, managed=True,
                        initial_enable=3)

        c_i = mmod.post(isa.NOOP, src=m_tmpl,
                        dst=mmod.future_wr_addr(1, "ctrl"),
                        ln=2 * isa.WR_WORDS, tag=f"dl.mc{pi}")
        mmod.post(isa.NOOP, tag=f"dl.me{pi}")     # event: response slot
        mmod.post(isa.NOOP, tag=f"dl.mf{pi}")     # event: ENABLE(vacate)

        mdrv.wait(rq, 1, tag=f"dl.trig{pi}")
        mdrv.write(src=key_w, dst=mexe.future_wr_addr(1, "opa"),
                   tag=f"dl.key{pi}")             # CAS comparand <- key
        rd1 = mdrv.read(src=0, dst=c_i.ctrl_addr, ln=1,
                        tag=f"dl.read{pi}")       # src RECV-scattered
        last = mdrv.write(src=rd1.addr("src"), dst=m_stage + 1,
                          tag=f"dl.addr{pi}")     # bucket addr -> response
        mdrv.initial_enable = mdrv.n_posted + 1

        mexe.wait(mdrv, last.completion_count, tag=f"dl.sync{pi}")
        mexe.cas(dst=c_i.ctrl_addr, old=isa.pack_ctrl(isa.NOOP, 0),
                 new=isa.pack_ctrl(isa.WRITE, 0), tag=f"dl.cas{pi}")
        mexe.enable(mmod, upto=3, tag=f"dl.en{pi}")

        # the vacate reads its bucket address out of the probe READ's own
        # src field — the scattered cell itself, no copy needed
        constructs.emit_bucket_vacate(vac, bucket_w=rd1.addr("src"),
                                      val_len=val_len, zeros=zeros,
                                      empty_key=EMPTY_KEY,
                                      tag=f"dl.vac{pi}")
        rd1s.append(rd1)
    return rd1s


@dataclasses.dataclass(frozen=True, eq=False)
class HopscotchShardDeleter:
    """The delete-side companion of :class:`HopscotchShardWriter`: the
    client SEND carries ``[key, probe-bucket addrs x H]`` and the chain
    is a match phase feeding per-probe bucket vacates (see
    :func:`_emit_delete_probes`), so the transition ``key -> EMPTY`` is a
    re-read-comparand CAS against the table itself and the value row is
    zeroed before the response commits.  Bit-exact with
    :func:`repro_torch.kvstore.hopscotch.delete_many`.
    """
    prog: Program
    spec: machine.MachineSpec
    state0: machine.VMState
    n_buckets: int
    val_len: int
    neighborhood: int
    table_base: int
    values_base: int
    resp_region: int
    recv_wq: int

    resp_words = 2                     # [status, bucket addr]

    @property
    def engine(self) -> ChainEngine:
        return ChainEngine.for_spec(self.spec)

    @property
    def fuel(self) -> int:
        """Exact step budget (no WQ recycles; see
        :attr:`HopscotchShardWriter.fuel`)."""
        return _fuel(self.state0)

    @property
    def walk_layout(self) -> WalkLayout:
        """The table straight; DELETED commits."""
        return WalkLayout(
            (WalkFrame(self.table_base, self.values_base, self.n_buckets,
                       self.n_buckets, self.val_len, 0, 1),),
            (DEL_DELETED,), self.resp_region, self.recv_wq)

    def device_state(self, keys: torch.Tensor,
                     vals: torch.Tensor) -> machine.VMState:
        """Image with a shard's slice scattered in (see
        :meth:`HopscotchShardWriter.device_state`)."""
        return _scatter_rows(self.state0, keys, vals,
                             table_base=self.table_base,
                             values_base=self.values_base)

    def device_payloads(self, queries: torch.Tensor,
                        home: torch.Tensor) -> torch.Tensor:
        """Client-side request assembly: ``[key, probe addrs x H]``."""
        addrs = _probe_addrs(home, self.neighborhood, self.n_buckets,
                             self.table_base)
        return torch.cat([queries[:, None].to(torch.int32), addrs], dim=1)

    def commit(self, out_mem: torch.Tensor, payload: torch.Tensor,
               keys: torch.Tensor, vals: torch.Tensor):
        """Fold G quiesced contexts into their arrays: a ``DEL_DELETED``
        response vacates the reported bucket (key -> EMPTY, value row
        zeroed); a miss commits nothing; key-0 requests report status
        0.  Returns ``(status (G,), keys, vals)``."""
        status = out_mem[:, self.resp_region]
        addr = out_mem[:, self.resp_region + 1]
        live = payload[:, 0] != EMPTY_KEY
        applied = live & (status == DEL_DELETED)
        rr, inb = _row_of(torch.where(
            applied, _bucket_row(addr, self.table_base), 0), keys.shape[1])
        put = applied & inb
        return (torch.where(live, status, 0),
                _put_rows(keys, rr, put, torch.zeros_like(status)),
                _put_rows(vals, rr, put, torch.zeros_like(vals[:, 0])))

    # the torn image of an interrupted delete: a vacate CAS that landed
    # without its row zeroing is what fsck's stale-row classifier finds
    commit_torn = HopscotchShardWriter.commit_torn

    def run_rows(self, keys: torch.Tensor, vals: torch.Tensor,
                 payloads: torch.Tensor, max_steps: int = 512):
        """G DELETEs, request ``g`` against table ``g``.  Returns
        ``(status (G,), keys, vals, steps (G,))``."""
        out = _run_contexts(self, self.device_state(keys, vals), payloads,
                            max_steps)
        return (*self.commit(out.mem, payloads, keys, vals), out.steps)

    run_rows_faulted = HopscotchShardWriter.run_rows_faulted

    def run_one(self, keys: torch.Tensor, vals: torch.Tensor,
                payload: torch.Tensor, max_steps: int = 512):
        """Serve one assembled DELETE against the shard arrays.  Returns
        ``(status, new_keys, new_vals)``."""
        out = self.run_rows(keys[None], vals[None], payload[None],
                            max_steps)
        return tuple(a[0] for a in out[:3])

    run_one_faulted = HopscotchShardWriter.run_one_faulted

    def delete_many(self, keys: torch.Tensor, vals: torch.Tensor,
                    queries: torch.Tensor, home: torch.Tensor,
                    max_steps: int = 512):
        """Single-machine batched DELETE, one request at a time, each
        committed before the next — bit-exact with
        :func:`repro_torch.kvstore.hopscotch.delete_many`.  Returns
        ``(status (B,), new_keys, new_vals)``."""
        statuses = []
        for pay in self.device_payloads(queries, home):
            status, keys, vals = self.run_one(keys, vals, pay, max_steps)
            statuses.append(status)
        return torch.stack(statuses), keys, vals


def build_hopscotch_deleter(n_buckets: int, val_len: int,
                            neighborhood: int = 8,
                            device=None) -> HopscotchShardDeleter:
    """Build (and cache per geometry and device) the per-shard hopscotch
    DELETE chain.  ``1 + neighborhood`` payload words must fit the RECV
    scatter limit (§5.3: 16 scatters), so ``neighborhood <= 15``."""
    return _build_hopscotch_deleter(n_buckets, val_len, neighborhood,
                                    device_mod.resolve(device))


@functools.lru_cache(maxsize=None)
def _build_hopscotch_deleter(n_buckets: int, val_len: int, neighborhood: int,
                             dev: torch.device) -> HopscotchShardDeleter:
    if not 1 <= neighborhood:
        raise ValueError("neighborhood must be >= 1")
    if 1 + neighborhood > min(isa.MAX_SCATTER, isa.MSG_WORDS):
        raise ValueError(
            f"neighborhood {neighborhood} exceeds the one-SEND request "
            f"budget ({isa.MAX_SCATTER}-scatter RECV)")
    if val_len > isa.MAX_COPY:
        raise ValueError(
            f"val_len {val_len} exceeds the one-WRITE row-zero budget")
    h = neighborhood

    # exact image sizing: guard + recv + per probe (8 vacate + 3 match-
    # cond + 4 match-driver + 3 match-exec); a ghost probe (padded key 0,
    # all probe addrs 0) reads bucket words [0..2] and zero-writes
    # val_len words at value-pointer 0, all inside the guard
    guard_slots = max(2, -(-val_len // isa.WR_WORDS))
    code_words = (guard_slots + 2 + h * (8 + 3 + 4 + 3)) * isa.WR_WORDS
    data_words = (2 + 1 + val_len              # resp, key_w, zeros
                  + n_buckets * val_len        # value rows
                  + n_buckets * BUCKET_WORDS   # table
                  + h * (2 * isa.WR_WORDS + 2)  # templates + stages
                  + 1 + 1 + h)                 # scatter table
    mem_words = -(-(code_words + data_words + 32) // 128) * 128

    p = Program(mem_words)
    p.add_wq(guard_slots)       # WQ0: all-zero null bucket (padding guard)

    resp = p.alloc(2, [DEL_MISS, 0], "resp")
    key_w = p.word(0, "key")
    zeros_v = p.alloc(val_len, [0] * val_len, "zeros")
    values = p.alloc(n_buckets * val_len, name="values")
    tbl_init = [0] * (n_buckets * BUCKET_WORDS)
    for b in range(n_buckets):
        tbl_init[b * BUCKET_WORDS + 2] = values + b * val_len
    table = p.alloc(n_buckets * BUCKET_WORDS, tbl_init, "table")

    rq = p.add_wq(2)
    rd1s = _emit_delete_probes(p, rq, h, val_len, key_w, resp, zeros_v)

    tbl = p.scatter_table([key_w] + [rd.addr("src") for rd in rd1s])
    rq.recv(scatter_table=tbl, tag="dl.recv")

    spec, st0 = p.finalize(device=dev)
    return HopscotchShardDeleter(
        prog=p, spec=spec, state0=st0, n_buckets=n_buckets,
        val_len=val_len, neighborhood=neighborhood, table_base=table,
        values_base=values, resp_region=resp, recv_wq=rq.index)


@dataclasses.dataclass(frozen=True, eq=False)
class ClockSweeper:
    """One CLOCK-hand lap of chain-driven TTL eviction.

    Each request visits ONE bucket: the chain READs the bucket's deadline
    word, evaluates ``e = min(max(deadline - now, 0), 1)`` in Calc verbs,
    and an :func:`repro_torch.core.constructs.emit_enable_branch` on ``e``
    releases either the **vacate** arm —
    :func:`~repro_torch.core.constructs.emit_bucket_vacate`, the deadline
    reset to :data:`NO_TTL`, ``SWEEP_RECLAIMED`` reported — or the
    **live** arm (``SWEEP_LIVE``, bucket untouched).  The deadline column
    lives in the bucket pad words, as in the TTL get server.  Bit-exact
    with :func:`repro_torch.kvstore.hopscotch.sweep_expired`.
    """
    prog: Program
    spec: machine.MachineSpec
    state0: machine.VMState
    n_buckets: int
    val_len: int
    table_base: int
    values_base: int
    resp_region: int
    recv_wq: int

    resp_words = 2                     # [status, bucket addr]

    @property
    def engine(self) -> ChainEngine:
        return ChainEngine.for_spec(self.spec)

    @property
    def fuel(self) -> int:
        """Exact step budget (no WQ recycles; see
        :attr:`HopscotchShardWriter.fuel`)."""
        return _fuel(self.state0)

    @property
    def walk_layout(self) -> WalkLayout:
        """The table straight, the deadlines (``carry[2]``) in the pad
        words; RECLAIMED commits."""
        return WalkLayout(
            (WalkFrame(self.table_base, self.values_base, self.n_buckets,
                       self.n_buckets, self.val_len, 0, 1, pad=2),),
            (SWEEP_RECLAIMED,), self.resp_region, self.recv_wq)

    def device_state(self, keys: torch.Tensor, vals: torch.Tensor,
                     exp: torch.Tensor) -> machine.VMState:
        """Image with a shard's ``(keys, vals, exp)`` scattered in —
        deadlines into the bucket pad words."""
        return _scatter_rows(self.state0, keys, vals,
                             table_base=self.table_base,
                             values_base=self.values_base, pad=exp)

    def device_payloads(self, buckets: torch.Tensor, now) -> torch.Tensor:
        """Request assembly: ``[bucket_addr, deadline_addr, -now]`` per
        visited bucket (the driver computes the hand positions; the clock
        rides the payload)."""
        addr = self.table_base + buckets.to(torch.int32) * BUCKET_WORDS
        negnow = -torch.as_tensor(now, dtype=torch.int32,
                                  device=addr.device)
        return torch.stack([addr, addr + 1, negnow.expand(addr.shape)],
                           dim=-1).to(torch.int32)

    def commit(self, out_mem: torch.Tensor, payload: torch.Tensor,
               keys: torch.Tensor, vals: torch.Tensor, exp: torch.Tensor):
        """Fold G quiesced laps back: ``SWEEP_RECLAIMED`` vacates the
        visited bucket and resets its deadline to :data:`NO_TTL`; a live
        lap commits nothing; padded rows (addr 0) report status 0.
        Returns ``(status (G,), keys, vals, exp)``."""
        status = out_mem[:, self.resp_region]
        live = payload[:, 0] != 0
        applied = live & (status == SWEEP_RECLAIMED)
        rr, inb = _row_of(torch.where(
            applied, _bucket_row(payload[:, 0], self.table_base), 0),
            keys.shape[1])
        put = applied & inb
        return (torch.where(live, status, 0),
                _put_rows(keys, rr, put, torch.zeros_like(status)),
                _put_rows(vals, rr, put, torch.zeros_like(vals[:, 0])),
                _put_rows(exp, rr, put, torch.full_like(status, NO_TTL)))

    def run_rows(self, keys: torch.Tensor, vals: torch.Tensor,
                 exp: torch.Tensor, payloads: torch.Tensor,
                 max_steps: int = 256):
        """G laps, lap ``g`` against table ``g``.  Returns ``(status (G,),
        keys, vals, exp, steps (G,))``."""
        out = _run_contexts(self, self.device_state(keys, vals, exp),
                            payloads, max_steps)
        return (*self.commit(out.mem, payloads, keys, vals, exp), out.steps)

    def run_one(self, keys: torch.Tensor, vals: torch.Tensor,
                exp: torch.Tensor, payload: torch.Tensor,
                max_steps: int = 256):
        """One sweeper lap.  Returns ``(status, keys, vals, exp)``."""
        out = self.run_rows(keys[None], vals[None], exp[None], payload[None],
                            max_steps)
        return tuple(a[0] for a in out[:4])

    def sweep(self, keys: torch.Tensor, vals: torch.Tensor,
              exp: torch.Tensor, start: int, count: int, now,
              max_steps: int = 256):
        """``count`` CLOCK laps from the hand at ``start`` (wrapping), each
        committed before the next.  Returns ``(status (count,), keys,
        vals, exp)``."""
        buckets = torch.remainder(start + torch.arange(
            count, dtype=torch.int32, device=keys.device), self.n_buckets)
        statuses = []
        for pay in self.device_payloads(buckets, now):
            status, keys, vals, exp = self.run_one(keys, vals, exp, pay,
                                                   max_steps)
            statuses.append(status)
        return torch.stack(statuses), keys, vals, exp


#: sweeper lane WQ sizes — (ctl, mod, vacate arm, live arm)
_SWEEP_WQS = (13, 2, 11, 1)


def _emit_sweep_lane(p: Program, rq, val_len: int, resp: int,
                     bucket_w: int, e_cell: int, no_ttl_w: int,
                     zeros_v: int):
    """One CLOCK-lap chain body: the control WQ (expiry predicate in Calc
    verbs, clamped to ``e in {0, 1}``), the enable-branch modifier, and
    the vacate / live arms against the caller's cells.  Returns the RECV
    scatter address list ``[bucket_w, read-src patch, ADD-operand
    patch]``."""
    CTL, MOD, VAC, LIVE = _SWEEP_WQS
    ctl = p.add_wq(CTL, ordering=isa.ORD_DOORBELL, managed=True)
    mod = p.add_wq(MOD, ordering=isa.ORD_DOORBELL, managed=True,
                   initial_enable=0)
    vac = p.add_wq(VAC, ordering=isa.ORD_DOORBELL, managed=True,
                   initial_enable=0)
    live = p.add_wq(LIVE, ordering=isa.ORD_DOORBELL, managed=True,
                    initial_enable=0)

    ctl.wait(rq, 1, tag="sw.trig")
    ctl.write(src=bucket_w, dst=resp + 1, tag="sw.addr")
    rd = ctl.read(src=0, dst=e_cell, ln=1, tag="sw.exp")  # src scattered
    ad = ctl.add(dst=e_cell, addend=0, tag="sw.sub")      # opa scattered
    ctl.max_(dst=e_cell, operand=0, tag="sw.cl0")
    ctl.min_(dst=e_cell, operand=1, tag="sw.cl1")         # e in {0, 1}

    def load_e(a_addr, b_addr):
        ctl.write(src=e_cell, dst=a_addr, tag="sw.e1")
        ctl.write(src=e_cell, dst=b_addr, tag="sw.e2")

    # e = 0 (expired) <= threshold -> vacate arm; e = 1 -> live arm
    constructs.emit_enable_branch(
        ctl, mod, threshold=0, then_wq=vac.index, then_upto=VAC,
        else_wq=live.index, else_upto=LIVE, load=load_e, tag="sw.br")
    ctl.initial_enable = ctl.n_posted + 1

    # vacate arm: retire the bucket, reset its deadline, report
    constructs.emit_bucket_vacate(vac, bucket_w=bucket_w, val_len=val_len,
                                  zeros=zeros_v, empty_key=EMPTY_KEY,
                                  tag="sw.vac")
    vac.write(src=rd.addr("src"), dst=vac.future_wr_addr(1, "dst"),
              tag="sw.rs_p")            # deadline addr <- scattered cell
    vac.write(src=no_ttl_w, dst=0, ln=1, tag="sw.rs")
    vac.write_imm(dst=resp, value=SWEEP_RECLAIMED, tag="sw.rc")

    # live arm: the bucket is untouched; the report is the (idempotent)
    # pre-set default, re-asserted so the arm completes observably
    live.write_imm(dst=resp, value=SWEEP_LIVE, tag="sw.lv")

    return [bucket_w, rd.addr("src"), ad.addr("opa")]


def build_clock_sweeper(n_buckets: int, val_len: int,
                        device=None) -> ClockSweeper:
    """Build (and cache per geometry and device) the per-shard CLOCK
    sweeper chain."""
    return _build_clock_sweeper(n_buckets, val_len,
                                device_mod.resolve(device))


@functools.lru_cache(maxsize=None)
def _build_clock_sweeper(n_buckets: int, val_len: int,
                         dev: torch.device) -> ClockSweeper:
    if val_len > isa.MAX_COPY:
        raise ValueError(
            f"val_len {val_len} exceeds the one-WRITE row-zero budget")

    # exact image sizing: the ghost lap (padded addr 0) reads words
    # [0..2] and zero-writes val_len at ptr 0 — the guard covers both; a
    # ghost deadline reset also lands NO_TTL on guard word 0, which is
    # never executed (WQ0 posts nothing)
    CTL, MOD, VAC, LIVE = _SWEEP_WQS
    guard_slots = max(2, -(-val_len // isa.WR_WORDS))
    code_words = (guard_slots + 2 + CTL + MOD + VAC + LIVE) * isa.WR_WORDS
    data_words = (2 + 3 + val_len              # resp, cells, zeros
                  + n_buckets * val_len        # value rows
                  + n_buckets * BUCKET_WORDS   # table (pad = deadline)
                  + 1 + 3)                     # scatter table
    mem_words = -(-(code_words + data_words + 32) // 128) * 128

    p = Program(mem_words)
    p.add_wq(guard_slots)       # WQ0: all-zero null bucket (padding guard)

    resp = p.alloc(2, [SWEEP_LIVE, 0], "resp")
    bucket_w = p.word(0, "bucket")     # scattered: visited bucket addr
    e_cell = p.word(0, "e")
    no_ttl_w = p.word(NO_TTL, "no_ttl")
    zeros_v = p.alloc(val_len, [0] * val_len, "zeros")
    values = p.alloc(n_buckets * val_len, name="values")
    tbl_init = [0] * (n_buckets * BUCKET_WORDS)
    for b in range(n_buckets):
        tbl_init[b * BUCKET_WORDS + 1] = NO_TTL
        tbl_init[b * BUCKET_WORDS + 2] = values + b * val_len
    table = p.alloc(n_buckets * BUCKET_WORDS, tbl_init, "table")

    rq = p.add_wq(2)
    scatter = _emit_sweep_lane(p, rq, val_len, resp, bucket_w, e_cell,
                               no_ttl_w, zeros_v)
    tbl = p.scatter_table(scatter)
    rq.recv(scatter_table=tbl, tag="sw.recv")

    spec, st0 = p.finalize(device=dev)
    return ClockSweeper(
        prog=p, spec=spec, state0=st0, n_buckets=n_buckets,
        val_len=val_len, table_base=table, values_base=values,
        resp_region=resp, recv_wq=rq.index)


# ---------------------------------------------------------------------------
# Fig. 12 — linked-list traversal
# ---------------------------------------------------------------------------

NODE_WORDS = 4   # [key, pad, val_ptr, next]


@dataclasses.dataclass
class ListTraversalOffload:
    prog: Program
    spec: machine.MachineSpec
    state0: machine.VMState
    n_iters: int
    val_len: int
    nodes_base: int
    values_base: int
    resp_region: int
    recv_wq: int
    use_break: bool
    items: List[Tuple[int, List[int]]]

    def node_addr(self, i: int) -> int:
        return self.nodes_base + i * NODE_WORDS

    def set_list(self, items: Sequence[Tuple[int, Sequence[int]]]):
        self.items = [(k, list(v)) for k, v in items]

    def materialize(self) -> machine.VMState:
        """Fresh machine state holding the current list, on the image's
        device."""
        mem = self.state0.mem.cpu().numpy().copy()
        for i, (key, value) in enumerate(self.items):
            a = self.node_addr(i)
            vslot = self.values_base + i * self.val_len
            nxt = self.node_addr(i + 1) if i + 1 < len(self.items) else 0
            mem[a:a + 4] = [key, 0, vslot, nxt]
            mem[vslot:vslot + len(value)] = value
        return self.state0._replace(
            mem=torch.from_numpy(mem).to(self.state0.mem.device))

    @property
    def engine(self) -> ChainEngine:
        return ChainEngine.for_spec(self.spec)

    def _payload(self, key: int) -> List[int]:
        return [self.node_addr(0)] + [key] * self.n_iters

    def get(self, key: int, max_steps: int = 4096):
        st = self.materialize()
        st = machine.deliver(st, self.recv_wq, self._payload(key))
        out = self.engine.run(st, max_steps)
        val = out.mem[self.resp_region:self.resp_region + self.val_len]
        return val.cpu().numpy(), out

    def get_many(self, keys: Sequence[int], max_steps: int = 4096):
        """Batched list walk: one materialize(), one vmapped run."""
        return _batched_get(self, keys, max_steps)


def build_list_traversal(n_iters: int = 8, val_len: int = 2,
                         use_break: bool = False, mem_words: int = 8192,
                         device=None) -> ListTraversalOffload:
    """Unrolled list walk (Fig. 12), its state on ``device``.

    Per iteration: ``drv`` patches and performs the node READ (filling the
    response WR's ctrl/flags/src from the node) and advances the cursor;
    ``exe`` CASes the response WR's control word against the searched key;
    ``mod`` holds the conditional response WRs.  With ``use_break`` a hit
    rewrites the *next* iteration's conditional WR into a completion-
    suppressed response WRITE, so its missing completion starves both the
    ``exe`` and ``drv`` chains — no further iterations execute (Fig. 6).
    """
    p = Program(mem_words)
    resp = p.alloc(val_len, [MISS_SENTINEL] * val_len, "resp")
    values = p.alloc(n_iters * val_len, name="values")
    nodes = p.alloc(n_iters * NODE_WORDS, [0] * (n_iters * NODE_WORDS),
                    "nodes")
    cur = p.word(0, "cur")

    rq = p.add_wq(4)
    drv = p.add_wq(10 * n_iters + 4, ordering=isa.ORD_COMPLETION)
    exe = p.add_wq(4 * n_iters + 4, ordering=isa.ORD_DOORBELL)
    mod = p.add_wq(2 * n_iters + 2, ordering=isa.ORD_DOORBELL, managed=True)

    per_iter = 2 if use_break else 1     # mod WRs per iteration
    cas_opa_addrs = []
    for i in range(n_iters):
        # --- mod: the conditional WR (and, in break mode, the adjacent
        #     event WR the next iteration gates on — Fig. 6's layout) -------
        if use_break:
            # C_i converted -> WRITE(template over E_i): E_i becomes a
            # completion-suppressed response WRITE. Response fires AND the
            # missing completion starves iteration i+1 before it can touch
            # anything.
            tmpl = p.alloc(isa.WR_WORDS, [
                isa.pack_ctrl(isa.WRITE, 0), isa.FLAG_SUPPRESS_COMPLETION,
                0, resp, val_len, 0, 0, -1])
            c_i = mod.post(isa.NOOP, src=tmpl,
                           dst=mod.future_wr_addr(1, "ctrl"), ln=8,
                           tag=f"list.c{i}")
            mod.post(isa.NOOP, tag=f"list.e{i}")      # E_i (the gate event)
        else:
            # C_i converted -> WRITE(value -> response region) directly
            c_i = mod.post(isa.NOOP, src=0, dst=resp, ln=val_len,
                           tag=f"list.c{i}")

        # --- drv: patch + node READ + cursor advance ------------------------
        if i == 0:
            drv.wait(rq, 1, tag="list.trig")
        else:
            drv.wait(mod, per_iter * i, tag=f"list.gate{i}")
        # node [key, pad(, val_ptr)] -> C_i.[ctrl, flags(, src)]; in break
        # mode C_i.src must keep pointing at the template, so the READ stops
        # after flags and the value pointer is forwarded into the template.
        drv.write(src=cur, dst=drv.future_wr_addr(1, "src"), ln=1,
                  tag=f"list.patch{i}")
        drv.read(src=0, dst=c_i.ctrl_addr, ln=(2 if use_break else 3),
                 tag=f"list.node{i}")
        if use_break:
            drv.write(src=cur, dst=drv.future_wr_addr(2, "src"), ln=1,
                      tag=f"list.patch_v{i}")
            drv.add(dst=drv.future_wr_addr(1, "src"), addend=2,
                    tag=f"list.voff{i}")
            drv.read(src=0, dst=tmpl + 2, ln=1, tag=f"list.val{i}")
        # advance: cursor <- node.next
        drv.write(src=cur, dst=drv.future_wr_addr(2, "src"), ln=1,
                  tag=f"list.patch_n{i}")
        drv.add(dst=drv.future_wr_addr(1, "src"), addend=3,
                tag=f"list.off{i}")
        rdn = drv.read(src=0, dst=cur, ln=1, tag=f"list.next{i}")

        # --- exe: the conditional (gated on the full drv iteration) ---------
        if i > 0:
            exe.wait(mod, per_iter * i, tag=f"list.syncm{i}")
        exe.wait(drv, rdn.completion_count, tag=f"list.sync{i}")
        cas = exe.cas(dst=c_i.ctrl_addr, old=isa.pack_ctrl(isa.NOOP, 0),
                      new=isa.pack_ctrl(isa.WRITE, 0), tag=f"list.cas{i}")
        exe.enable(mod, upto=per_iter * (i + 1), tag=f"list.en{i}")
        cas_opa_addrs.append(cas.addr("opa"))

    # RECV: first-node address -> cursor; x -> every CAS comparand
    tbl = p.scatter_table([cur] + cas_opa_addrs)
    rq.recv(scatter_table=tbl, tag="list.recv")

    spec, st0 = p.finalize(device=device)
    return ListTraversalOffload(
        prog=p, spec=spec, state0=st0, n_iters=n_iters, val_len=val_len,
        nodes_base=nodes, values_base=values, resp_region=resp,
        recv_wq=rq.index, use_break=use_break, items=[])


# ---------------------------------------------------------------------------
# §3.4 / §5.6 — WQ-recycled get server (survives host failures)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RecycledGetServer:
    prog: Program
    spec: machine.MachineSpec
    state: machine.VMState
    n_buckets: int
    val_len: int
    table_base: int
    values_base: int
    resp_region: int
    loop_wq: int
    lap_words: int
    laps_addr: int
    kv: Dict[int, Tuple[int, List[int]]]

    def h1(self, key: int) -> int:
        return key % self.n_buckets

    def bucket_addr(self, b: int) -> int:
        return self.table_base + b * BUCKET_WORDS

    def insert(self, key: int, value: Sequence[int]):
        self.kv[self.h1(key)] = (key, list(value))

    def load(self):
        mem = self.state.mem.cpu().numpy().copy()
        for b, (key, value) in self.kv.items():
            vslot = self.values_base + b * self.val_len
            a = self.bucket_addr(b)
            mem[a:a + 3] = [key, 0, vslot]
            mem[vslot:vslot + len(value)] = value
        self.state = self.state._replace(
            mem=torch.from_numpy(mem).to(self.state.mem.device))

    @property
    def engine(self) -> ChainEngine:
        return ChainEngine.for_spec(self.spec)

    def _payload(self, key: int) -> List[int]:
        return [key, self.bucket_addr(self.h1(key))]

    def serve(self, key: int, max_steps: int = 64):
        """One request against the *persistent* loop state — no host-side
        re-arming ever happens (that is §5.6's resiliency story)."""
        st = machine.deliver(self.state, self.loop_wq, self._payload(key))
        st = st._replace(steps=torch.zeros_like(st.steps))
        out = self.engine.run(st, max_steps)
        val = out.mem[self.resp_region:self.resp_region + self.val_len]
        self.state = out
        return val.cpu().numpy()

    def serve_many(self, keys: Sequence[int],
                   max_steps: int = 64) -> np.ndarray:
        """Stream a key batch through the persistent loop: equivalent to N
        sequential :meth:`serve` calls (same responses, same on-chain lap
        counters).  Returns ``(N, val_len)``."""
        payloads = np.asarray([self._payload(int(k)) for k in keys],
                              np.int32)
        final, vals = self.engine.serve_stream(
            self.state, self.loop_wq, payloads, self.resp_region,
            self.val_len, max_steps)
        self.state = final
        return vals.cpu().numpy()

    def get_many(self, keys: Sequence[int], max_steps: int = 64):
        """Batched get mirroring the other offloads' ``(vals, state)``
        return shape; the state is the persistent post-batch loop state."""
        vals = self.serve_many(keys, max_steps)
        return vals, self.state


def build_recycled_get_server(n_buckets: int = 32, val_len: int = 2,
                              mem_words: int = 4096,
                              device=None) -> RecycledGetServer:
    """Single-bucket get server on ONE recycled WQ (lap layout in code)."""
    p = Program(mem_words)
    resp = p.alloc(val_len, [MISS_SENTINEL] * val_len, "resp")
    zeros = p.alloc(val_len, [0] * val_len, "zeros")
    values = p.alloc(n_buckets * val_len, name="values")
    table = p.alloc(n_buckets * BUCKET_WORDS,
                    [0] * (n_buckets * BUCKET_WORDS), "table")
    laps = p.word(0, "laps")

    size = 12
    wq = p.add_wq(size, ordering=isa.ORD_DOORBELL, managed=True,
                  recycled=True, initial_enable=5)
    rv = wq.recv(scatter_table=0, tag="srv.recv")           # table patched in
    wq.read(src=zeros, dst=resp, ln=val_len, tag="srv.clear")
    rd = wq.read(src=0, dst=0, ln=BUCKET_WORDS, tag="srv.read")
    cas = wq.cas(dst=0, old=isa.pack_ctrl(isa.NOOP, 0),
                 new=isa.pack_ctrl(isa.WRITE, 0), tag="srv.cas")
    en = wq.enable(wq, upto=size + 5, tag="srv.enable")
    r4 = wq.post(isa.NOOP, src=0, dst=resp, ln=val_len, tag="srv.resp")
    pristine = p.alloc(isa.WR_WORDS, [
        isa.pack_ctrl(isa.NOOP, 0), 0, 0, resp, val_len, 0, 0, -1])
    wq.read(src=pristine, dst=r4.base, ln=isa.WR_WORDS, tag="srv.rearm")
    wq.add(dst=laps, addend=1, tag="srv.laps")
    wq.add(dst=en.addr("opa"), addend=size, tag="srv.bump")
    while wq.n_posted < size:
        wq.noop(signaled=False, tag="srv.pad")

    wq.wrs[rd.slot]["dst"] = r4.ctrl_addr
    wq.wrs[cas.slot]["dst"] = r4.ctrl_addr
    tbl = p.scatter_table([cas.addr("opa"), rd.addr("src")])
    wq.wrs[rv.slot]["aux"] = tbl

    spec, st0 = p.finalize(device=device)
    return RecycledGetServer(
        prog=p, spec=spec, state=st0, n_buckets=n_buckets, val_len=val_len,
        table_base=table, values_base=values, resp_region=resp,
        loop_wq=wq.index, lap_words=size, laps_addr=laps, kv={})
