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
  generalized to the hopscotch neighborhood, one chain per owner shard.
* :class:`RecycledGetServer` — a §3.4 WQ-recycled *get* server on one
  managed WQ (the single-WQ program the chain kernel runs).

Every builder takes ``device`` (default CUDA; see
:func:`repro_torch.device.resolve`) and builds the same image, word for
word, as the JAX package's builder of the same name.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import device as device_mod
from . import isa, machine
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

# TTL sentinel: a bucket with no deadline carries INT32_MAX in its expiry
# word
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

    @property
    def resp_words(self) -> int:
        return self.val_len + 1            # [found, value...]

    @property
    def engine(self) -> ChainEngine:
        return ChainEngine.for_spec(self.spec)

    def device_state(self, keys: torch.Tensor,
                     vals: torch.Tensor) -> machine.VMState:
        """Image with a shard's hopscotch slice scattered in.

        keys: (..., n_buckets) int32 (0 = empty); vals: (..., n_buckets,
        val_len).  Leading dims (the store's virtual shards) stack one
        machine per table: every field of the result gains them.
        """
        lead = tuple(keys.shape[:-1])
        dev = self.state0.mem.device
        keys = keys.to(device=dev, dtype=torch.int32)
        vals = vals.to(device=dev, dtype=torch.int32)
        row_stride = self.val_len + 1
        rows = torch.arange(self.n_buckets, dtype=torch.int64, device=dev)
        mem = self.state0.mem.expand(lead + self.state0.mem.shape).clone()
        mem[..., self.table_base + rows * BUCKET_WORDS] = keys
        mem[..., self.values_base + rows * row_stride] = (
            keys != EMPTY_KEY).to(torch.int32)
        vidx = (self.values_base + rows[:, None] * row_stride + 1
                + torch.arange(self.val_len, device=dev)[None, :])
        mem[..., vidx.reshape(-1)] = vals.reshape(lead + (-1,))
        return machine.VMState(*(
            mem if name == "mem" else a.expand(lead + a.shape)
            for name, a in zip(machine.VMState._fields, self.state0)))

    def device_payloads(self, queries: torch.Tensor,
                        home: torch.Tensor) -> torch.Tensor:
        """Client-side request assembly: ``[key x H, probe addrs x H]``.

        queries: (B,) int32; home: (B,) int32 home buckets (the client
        computes the hash).  Probes cover the wrapping neighborhood
        ``[home, home + H)``.
        """
        h = self.neighborhood
        offs = torch.arange(h, dtype=torch.int32, device=queries.device)
        rows = torch.remainder(home[..., None] + offs, self.n_buckets)
        addrs = (self.table_base + rows * BUCKET_WORDS).to(torch.int32)
        keys_rep = queries[..., None].to(torch.int32).expand(rows.shape)
        return torch.cat([keys_rep, addrs], dim=-1)

    def get_many(self, keys: torch.Tensor, vals: torch.Tensor,
                 queries: torch.Tensor, home: torch.Tensor,
                 max_steps: int = 96):
        """Single-machine batched get.  Returns (found bool (B,), values
        (B, val_len))."""
        st = self.device_state(keys, vals)
        out = self.engine.run_many(
            st, self.recv_wq, self.device_payloads(queries, home), max_steps)
        resp = out.mem[:, self.resp_region:self.resp_region + self.resp_words]
        return resp[:, 0] > 0, resp[:, 1:]


def build_hopscotch_server(n_buckets: int, val_len: int,
                           neighborhood: int = 8, ttl: bool = False,
                           device=None) -> HopscotchShardServer:
    """Build (and cache per geometry and device) the per-shard hopscotch
    get chain.  ``2 * neighborhood`` payload words / scatter entries must
    fit the RECV scatter limit (§5.3: 16 scatters), so ``neighborhood <=
    8``.  The TTL-aware variant (``ttl=True``) is not ported yet."""
    if ttl:
        raise NotImplementedError(
            "the TTL-aware hopscotch server (ttl=True) is not ported yet")
    return _build_hopscotch_server(n_buckets, val_len, neighborhood,
                                   device_mod.resolve(device))


@functools.lru_cache(maxsize=None)
def _build_hopscotch_server(n_buckets: int, val_len: int, neighborhood: int,
                            dev: torch.device) -> HopscotchShardServer:
    if not 1 <= neighborhood <= isa.MAX_SCATTER // 2:
        raise ValueError(
            f"neighborhood must be in [1, {isa.MAX_SCATTER // 2}] "
            f"(2 payload words per probe, {isa.MAX_SCATTER}-scatter RECV)")
    if val_len + 1 > isa.MAX_COPY:
        raise ValueError(f"val_len {val_len} exceeds one-WRITE response")
    row_stride = val_len + 1
    h = neighborhood

    # size the image exactly: code (1 guard + recv + 6 slots per probe)
    # grows up, data grows down
    code_words = (1 + 2 + 6 * h) * isa.WR_WORDS
    data_words = (row_stride                      # response region
                  + n_buckets * row_stride        # value rows [flag, v...]
                  + n_buckets * BUCKET_WORDS      # table
                  + 1 + 2 * h)                    # scatter table
    mem_words = -(-(code_words + data_words + 32) // 128) * 128

    p = Program(mem_words)
    p.add_wq(1)                                   # WQ0: all-zero null bucket
    resp = p.alloc(row_stride, [MISS_SENTINEL] * row_stride, "resp")
    # value rows [found, v...]: the found flag is per-row dynamic state
    # (device_state writes keys != EMPTY), so the static image is zeros
    values = p.alloc(n_buckets * row_stride,
                     [0] * (n_buckets * row_stride), "values")
    # table rows [key=0, pad, val_ptr]: val_ptr column baked statically
    tbl_init = [0] * (n_buckets * BUCKET_WORDS)
    for b in range(n_buckets):
        tbl_init[b * BUCKET_WORDS + 2] = values + b * row_stride
    table = p.alloc(n_buckets * BUCKET_WORDS, tbl_init, "table")

    rq = p.add_wq(2)
    cas_opa_addrs, read_src_addrs = [], []
    for pi in range(h):
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

    tbl = p.scatter_table(cas_opa_addrs + read_src_addrs)
    rq.recv(scatter_table=tbl, tag="hs.recv")

    spec, st0 = p.finalize(device=dev)
    return HopscotchShardServer(
        prog=p, spec=spec, state0=st0, n_buckets=n_buckets, val_len=val_len,
        neighborhood=neighborhood, table_base=table, values_base=values,
        resp_region=resp, recv_wq=rq.index)


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
