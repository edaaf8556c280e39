"""ChainEngine — batched execution of RedN chains (the port's
``repro.core.engine``).

* :meth:`ChainEngine.run_many` — one :func:`machine.deliver_many` (stack N
  payloads into a batch of machines) followed by one batched run: the
  engine behind ``HashLookupOffload.get_many`` and the store's redn path.
* :meth:`ChainEngine.serve_stream` — requests chained through *persistent*
  state (the §3.4 recycled-WQ server): the same responses and on-chain lap
  counters as N sequential ``serve()`` calls.
* :meth:`ChainEngine.run_interleaved` — many writers' chains over one
  shared image under a :class:`machine.Schedule` (interpreter only).
* ``backend="kernel"`` — single-WQ programs (the recycled get server's lap
  loop, straight-line chains) run as a batch of client contexts through
  the managed chain kernel in :mod:`repro_torch.kernels.chain_vm`, with
  the interpreter as oracle.

Engines are memoized per ``(spec, backend)`` in a bounded LRU
(:meth:`ChainEngine.for_spec`).
"""
from __future__ import annotations

import collections

import numpy as np
import torch

from . import isa, machine

_INTERP_BACKENDS = ("interp",)
_KERNEL_BACKENDS = ("kernel",)


def _pad_payloads(payloads, device) -> torch.Tensor:
    """Payload rows zero-padded to MSG_WORDS, as an int32 tensor on
    ``device``.  ``(N, k)``, or ``(G, N, k)`` for a state stacked over G
    machines (see :func:`machine.deliver_many`)."""
    if isinstance(payloads, torch.Tensor):
        p = payloads.to(device=device, dtype=torch.int32)
        if p.ndim not in (2, 3):
            raise ValueError(
                f"payloads must be (N, k) or (G, N, k), got shape "
                f"{tuple(p.shape)}")
    else:
        a = np.asarray(payloads, np.int32)
        if a.ndim == 1 and a.size == 0:
            a = a.reshape(0, 0)          # literal []: empty batch
        if a.ndim != 2:
            raise ValueError(f"payloads must be (N, k), got shape {a.shape}")
        p = torch.from_numpy(a).to(device)
    return machine.pad_payload_rows(p)


class ChainEngine:
    """Batched executor for one chain program (spec).

    Backends:

    * ``"interp"`` (default) — the multi-WQ discrete-event interpreter in
      :mod:`repro_torch.core.machine` (full ISA, latency clocks): on the
      card one launch of the interpreter kernel a batch
      (:func:`repro_torch.kernels.chain_interp.ops.run_interp`).
    * ``"kernel"`` — the single-WQ managed chain kernel
      (:func:`repro_torch.kernels.chain_vm.ops.run_managed`): the CUDA
      kernel for states on the card, its plain PyTorch version for states
      on the CPU.  It models memory, queue counters, steps and client
      responses, but not the latency cost model: ``clock``,
      ``last_comp_time`` and ``verb_counts`` pass through unchanged.
    """

    _cache: "collections.OrderedDict" = collections.OrderedDict()
    _cache_limit: int = 64
    _cache_stats: dict = {"hits": 0, "misses": 0, "evictions": 0}

    def __init__(self, spec: machine.MachineSpec, backend: str = "interp"):
        if backend not in _INTERP_BACKENDS + _KERNEL_BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        if backend in _KERNEL_BACKENDS and spec.num_wqs != 1:
            raise ValueError(
                "kernel backend supports single-WQ programs only "
                f"(spec has {spec.num_wqs} WQs)")
        self.spec = spec
        self.backend = backend
        # kernel-subset validation, keyed on the code-region image: engines
        # are memoized per (spec, backend), so a "checked once" flag would
        # let a different program image with the same spec bypass it
        self._validated_wq_images: set = set()

    @classmethod
    def for_spec(cls, spec: machine.MachineSpec,
                 backend: str = "interp") -> "ChainEngine":
        key = (spec, backend)
        eng = cls._cache.get(key)
        if eng is not None:
            cls._cache.move_to_end(key)
            cls._cache_stats["hits"] += 1
            return eng
        cls._cache_stats["misses"] += 1
        eng = cls._cache[key] = cls(spec, backend)
        while len(cls._cache) > cls._cache_limit:
            cls._cache.popitem(last=False)
            cls._cache_stats["evictions"] += 1
        return eng

    @classmethod
    def cache_stats(cls) -> dict:
        """Snapshot of the engine-memo LRU: size/limit plus cumulative
        hit/miss/eviction counters."""
        return {"size": len(cls._cache), "limit": cls._cache_limit,
                **cls._cache_stats}

    @classmethod
    def cache_clear(cls) -> None:
        cls._cache.clear()
        cls._cache_stats.update(hits=0, misses=0, evictions=0)

    # -- single-machine path --------------------------------------------------
    def run(self, state: machine.VMState, max_steps: int = 4096,
            faults=None) -> machine.VMState:
        return machine.run(self.spec, state, max_steps, faults)

    def run_batch(self, states: machine.VMState, max_steps: int = 4096,
                  faults=None) -> machine.VMState:
        """Run a batched (leading-dim) ``VMState`` on the selected backend.

        ``faults`` is a :class:`repro_torch.core.faults.FaultPlan` with
        one row per context (the interpreter is the authority; the kernel
        supports the kill fault only and keeps bit-exact parity on it)."""
        if self.backend in _INTERP_BACKENDS:
            return machine.run_batch(self.spec, states, max_steps, faults)
        return self._run_batch_kernel(states, max_steps, faults)

    def run_interleaved(self, state: machine.VMState,
                        schedule: machine.Schedule, writer_slices,
                        max_steps: int = 4096) -> machine.VMState:
        """Run many writers' chains over ONE shared memory image under a
        deterministic :class:`machine.Schedule` (see
        :func:`machine.run_scheduled`; ``state`` may be a batch).

        The serialized schedule is the bit-exact oracle for the
        *committed* state under any schedule, for programs whose only
        cross-writer touch points are CAS claims on shared cells: a CAS
        is one atomic VM step, so each contended cell is won by exactly
        one writer, and every loser observes ``old != expect`` and
        re-probes — what it would have observed running after the winner
        in some serialized order.

        Interpreter-only: the chain kernel runs a grid of *independent*
        single-WQ contexts and cannot share a memory image.
        """
        if self.backend not in _INTERP_BACKENDS:
            raise ValueError(
                "run_interleaved shares one memory image across writers; "
                "the chain kernel's grid runs independent contexts — use "
                "the interp backend")
        return machine.run_scheduled(self.spec, state, schedule,
                                     tuple(writer_slices), max_steps)

    # -- batched request paths ----------------------------------------------
    def deliver_many(self, state: machine.VMState, wq: int,
                     payloads) -> machine.VMState:
        return machine.deliver_many(
            state, wq, _pad_payloads(payloads, state.mem.device))

    def run_many(self, state: machine.VMState, wq: int, payloads,
                 max_steps: int = 4096, faults=None) -> machine.VMState:
        """Deliver N payloads to `wq` and run all N contexts, batched.

        Every context gets ``max_steps`` of fresh fuel: the cumulative
        ``steps`` counter of a reused persistent state is reset, exactly as
        the single-request ``serve()`` path does.  ``faults`` rows (leading
        dim N) inject per-context faults.
        """
        batch = self.deliver_many(state, wq, payloads)
        batch.steps.zero_()
        if self.backend in _INTERP_BACKENDS:
            # the batch is a fresh allocation: run it in place
            return machine.run_batch_in_place(self.spec, batch, max_steps,
                                              faults)
        return self._run_batch_kernel(batch, max_steps, faults)

    def serve_stream(self, state: machine.VMState, wq: int, payloads,
                     resp_region: int, resp_len: int, max_steps: int = 64,
                     faults=None):
        """Stream N requests through *persistent* state (recycled server).

        Returns ``(final_state, values)`` with ``values`` of shape
        ``(N, resp_len)`` — the response region after each request, as N
        sequential ``serve()`` calls would observe it.  Always runs on the
        interpreter: one machine chained across requests is not a batch
        of independent contexts.  ``faults`` rows (leading dim N) fault
        individual requests; a killed request's effects stay in the
        persistent state.
        """
        pays = _pad_payloads(payloads, state.mem.device)
        vals = []
        for i, pay in enumerate(pays):
            state = machine.deliver(state, wq, pay)
            state = state._replace(steps=torch.zeros_like(state.steps))
            plan = None if faults is None else type(faults)(
                *(leaf[i] for leaf in faults))
            state = machine.run(self.spec, state, max_steps, plan)
            vals.append(state.mem[resp_region:resp_region + resp_len])
        if not vals:
            return state, state.mem.new_zeros((0, resp_len))
        return state, torch.stack(vals)

    # -- kernel backend -------------------------------------------------------
    def _check_kernel_subset(self, states: machine.VMState) -> None:
        """Inter-QP SEND (opb >= 0) has no peer on a single queue and is
        outside the kernel's subset: reject posted ones up front rather
        than silently no-op them.  Keyed on the WQ slice of the image; a
        batch that is a broadcast of one image transfers one row."""
        base, size = self.spec.wq_bases[0], self.spec.wq_sizes[0]
        sl = states.mem[:, base:base + size * isa.WR_WORDS]
        if sl.shape[0] > 0 and bool((sl == sl[0]).all()):
            img = sl[:1].cpu().numpy()
        else:
            img = sl.cpu().numpy()
        img_key = hash(img.tobytes())
        if img_key in self._validated_wq_images:
            return
        opcodes = (img[:, isa.F_CTRL::isa.WR_WORDS] >> isa.ID_BITS) & 0x7F
        opbs = img[:, isa.F_OPB::isa.WR_WORDS]
        if np.any((opcodes == isa.SEND) & (opbs >= 0)):
            raise ValueError(
                "inter-QP SEND (opb >= 0) is outside the kernel's "
                "single-WQ subset; use the interp backend")
        self._validated_wq_images.add(img_key)

    def _run_batch_kernel(self, states: machine.VMState, max_steps: int,
                          faults=None) -> machine.VMState:
        from ..kernels.chain_vm import ops as chain_ops

        # the kernel models one fault, fuel truncation, as per-row fuel;
        # any other needs the interpreter's per-step hooks
        if faults is not None and not faults.kernel_supported():
            raise ValueError(
                "kernel backend supports only kill_step (fuel truncation) "
                "faults; suppress/CAS/ENABLE faults need the interp "
                "backend")
        spec = self.spec
        self._check_kernel_subset(states)
        n = states.mem.shape[0]
        cap = states.msg_buf.shape[2]
        msgs = states.msg_buf[:, 0].reshape(n, cap * isa.MSG_WORDS)
        # fuel: the interpreter's run() treats the cumulative steps counter
        # as consumed fuel (cond: steps < max_steps) — mirror it
        fuel = torch.clamp(max_steps - states.steps, 0, max_steps)
        if faults is not None:
            # kill_step as fuel: the interpreter stops before executing
            # step k, so a killed row gets exactly k steps of fuel
            kill = faults.kill_step.to(device=fuel.device, dtype=torch.int32)
            fuel = torch.minimum(fuel, torch.where(
                kill >= 0, torch.clamp(kill, max=max_steps), max_steps))
        inits = torch.stack(
            [states.head[:, 0], states.tail[:, 0],
             states.enable_limit[:, 0], states.completions[:, 0],
             states.msg_head[:, 0], states.msg_tail[:, 0],
             fuel.to(torch.int32), states.halted.to(torch.int32)],
            dim=1).contiguous()
        mem, stats = chain_ops.run_managed(
            states.mem.contiguous(), msgs.contiguous(), inits,
            wq_base=spec.wq_bases[0], n_wrs=spec.wq_sizes[0],
            managed=bool(spec.managed[0]), max_steps=max_steps)
        # queue/response counters come back from the kernel; executed-WR
        # counts are the per-row head advance.  The latency clocks and the
        # verb_counts histogram are interpreter-only and pass through.
        return states._replace(
            mem=mem,
            head=stats[:, 0:1],
            enable_limit=stats[:, 1:2],
            completions=stats[:, 2:3],
            msg_head=stats[:, 3:4],
            halted=stats[:, 4] > 0,
            responses=states.responses + stats[:, 6],
            steps=states.steps + (stats[:, 0] - states.head[:, 0]))
