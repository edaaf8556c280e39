"""Chip smoke test: drive the PyTorch/CUDA port's paths on one card — the
RedN GET path, the store's write path, its fault recovery and online
resize, racing writers and isolation, the crash-resilient services, the
chain-program toolchain (verifier, ADDLEQ guests, list walks), the cuckoo
table, the LM serving paths
(qwen3-1.7b, rwkv6-7b and recurrentgemma-9b prefill, decode and
ServeEngine ticks; gemma3-1b, also on rolling int8 caches, mixtral-8x7b,
phi-3-vision-4.2b and seamless-m4t-medium prefill and decode), and the
training paths (smollm-135m in float32: train steps through the flash
backward's CUDA-core pair, AdamW, checkpoints and a crash resumed bit for
bit; qwen3-1.7b in bf16 through its tensor-core pair; rwkv6-7b and
recurrentgemma-9b in bf16 through the recurrences' backward kernels, and
recurrentgemma-9b's local attention through the tensor-core pair at head
dim 256).

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``src/repro_torch/csrc`` (one
``nvcc`` per source, all started together), then runs thirty-seven phases
(``PHASES``, in this order) and raises on any mismatch:

1. ``card``            — the card's name and power limit, the kernel build;
                         each ``flash_wgmma_kernel`` instantiation (head
                         dims 64, 96, 128, 256) in the flash library's SASS
                         must hold HGMMA (tensor-core) instructions.
2. ``kv_get``          — the GET path at a real size: a 4-shard hopscotch
                         store (4 x 65,536 buckets, 157,286 keys, 60% load)
                         answers zipf GET batches through ``sharded_get`` on
                         the redn, one_sided and two_sided paths, each row
                         checked against the host oracle ``reference_get``;
                         the redn path's chains run on the interpreter
                         kernel, one launch a window, as a split batch
                         (each shard's table and value rows kept once,
                         each context's private words staged in shared
                         memory).  Timed: gets/s, the latency of one GET
                         at a time (the median of 128 by CUDA events) and
                         the peak bytes a batch, per path; the stages of
                         a redn batch (``redn_breakdown``: deliver,
                         dispatch, the run, combine) with the private
                         words a context and the bytes delivered.
3. ``chain_kernel``    — the recycled get server (65,536 buckets, 2^19-word
                         image) through ``ChainEngine(spec, "kernel")``
                         against the interpreter and the plain loop; again
                         at the throughput benchmark's size.
3b. ``chain_faults``   — the same server under kill faults: 256 contexts
                         under a seeded storm of kill rows and 3 keys cut
                         at every step from 0 to the fuel, through the
                         kernel backend (kill as per-context fuel) against
                         the interpreter, every field bit-equal; a suppress
                         row must be refused; then the storm drill of
                         ``tests/test_faults.py`` (1 shard, 32 buckets, 12
                         requests, all four kinds) on the card against
                         the same drill on the CPU, bit for bit.
3c. ``chain_interp``   — the chain interpreter kernel
                         (``chain_interp_kernel``: every row of a batched
                         VMState run to its own stop in one launch)
                         against its plain loop on the card, each run's
                         14 fields bit-equal, clocks included: the hazard
                         corpus of ``tests/_interp_images.py`` (plain,
                         fault rows, two-writer schedules); its window
                         machines as split
                         batches, and each store that would change a
                         window word refused; the ``kv_get``
                         store's redn window (4 x 4 x 64 contexts, one
                         launch of a split batch, held to the plain loop's
                         run of full copies; again under
                         ``torch.cuda.set_sync_debug_mode``, one launch
                         and one host read, the window flags'); a
                         (4, 8) SET batch (writer and displacer); a 4-lane
                         SET of hot keys and the 2-writer cut sweep as one
                         batch; the recycled server under a storm of all
                         four fault kinds; 512 ADDLEQ guests on the
                         interpreter image.  Full batches run in global
                         memory, split ones staged in shared memory.  The
                         kernel timed by device time from a trace, the
                         wrapper's call by CUDA events, beside the plain
                         loop and the serial floor (four round trips a
                         step: L2 hits for an image in global memory,
                         shared-memory loads for a split batch's private
                         words, and an L2 hit a READ).  Its
                         launches in the JSON are those of the paths
                         whose chains run on it (``INTERP_PATHS``).
4. ``chain_straight``  — the straight-line chain kernel against its plain
                         version on 1,024 seeded random programs; timed
                         by device time from a trace.
5. ``hopscotch_probe`` — the hopscotch kernel against the plain lookup on
                         every shard table, and against the redn answers;
                         on shard 0's table also at neighborhoods of 16
                         and 32 and with one value word.  Timed by device
                         time from a trace.
6. ``kv_write``        — the write path on the ``kv_get`` store (4 x 65,536
                         buckets, 60% load): a (4, 32) SET batch of
                         updates, inserts, keys whose neighborhood is full
                         (escalated to the displacer chain), a duplicate,
                         key 0 and dead rows; a (4, 16) DELETE batch; a
                         TTL SET, TTL gets before and after the deadlines
                         and a CLOCK sweep.  Every status and array is held
                         bit for bit to the host oracles, and the touched
                         keys are read back on all three get paths.  Its
                         single-chain stages (writer, displacer, deleter,
                         sweeper) run on the walk kernel
                         (``chain_walk_kernel``: a stage's windows walked
                         in one launch, a block an owner), each held bit
                         for bit to ``_walk`` (the earlier route, an
                         interpreter launch a window position) on the same
                         inputs in responses, steps and carry; the SET,
                         DELETE and sweep batches timed by host clock on
                         both routes, the SET batch traced on both (the
                         walk kernel's device time beside ``_walk``'s
                         interpreter time, the device's idle share); the
                         walk kernel replayed on the SET batch's stages
                         against its plain walk, beside its serial floor.
                         The GETs' chains run on the interpreter kernel.
6b. ``kv_faults``      — the recovery drill on the ``kv_get`` store: a
                         (4, 8) SET batch of updates, inserts and forced
                         displacements under a seeded storm of all four
                         kinds; fsck, repair, a retry of the rows that
                         did not finish; every SET key read back on the
                         three get paths, fsck clean.  One tear of each
                         kind planted in copies of the store (five
                         repairable kinds and a neighborhood breach): the
                         report names exactly those, and repair mends the
                         five.  Times fsck and repair at 262,144 buckets.
                         Each SET stage (fault rows on the writer) walks
                         and is held to ``_walk``.
6c. ``kv_resize``      — online growth of the same store: two 16-lap
                         ``sharded_resize`` quanta against the host oracle;
                         again with shard 0 killed inside a lap (a torn
                         claim-to-vacate window), fsck, ``repair_resize``
                         and the re-driven quanta equal to the fault-free
                         frames; 256 gets and 8 sets through the
                         ResizeState arms against the double-frame
                         oracle; a 4 x 32-bucket store grown to the end
                         against ``grow``.  Every migrator, displacer and
                         writer stage walks and is held to ``_walk``; the
                         quanta timed by host clock on both routes.
6d. ``kv_contend``     — racing writers and isolation (§3.5, §5.5) on the
                         same store: ``sharded_set`` with 1, 2 and 4
                         writer lanes on a (4, 8) batch whose homes lie
                         far apart (all equal, and equal to the host
                         oracle), and with 2 and 4 lanes on a hot-key
                         hammer (each owner's 8 keys homed at one bucket):
                         every row answered, fsck clean, every applied
                         key read back.  The 2-writer cut sweep of
                         ``tests/test_faults.py`` (every cut one batch,
                         each on the AB or BA oracle), and the fairness
                         hammer under ``fair_quotas([8] * 4, 48)``
                         (best/worst completion clock <= 2), each bit-equal
                         to the same run on the CPU, clocks included; the
                         ``isolation=`` arm of ``sharded_get`` with a
                         greedy client, its admitted mask and buckets
                         bit-equal to the CPU's.  On the interpreter kernel.
6e. ``kv_service``     — the §5.6 services with the host driver crashed:
                         256 Zipf gets through a ``DeviceResidentService``;
                         ``ShardedKVService`` over the same store's tensors
                         serving a get batch, a 2-lane SET batch and a
                         DELETE batch against the host oracles,
                         ``set_reliable`` under a kill plan, fsck clean;
                         a 1-shard, 8-bucket service grown by its own
                         SETs, and the chained second growth, every key
                         served throughout.  The single-chain stages walk,
                         each held to ``_walk``; the 2-lane SET's laps and
                         the GETs run on the interpreter kernel.
6f. ``chain_programs`` — the chain-program toolchain: the static
                         verifier's sweep of its 18 registered programs,
                         built on the card, equal to ``BENCH_chains.json``
                         ``verification.programs`` in every field; 4,096
                         ADDLEQ guests (one 4,096-word interpreter image
                         each: the demo guests at several inputs, one that
                         never halts, the rest seeded random guests with a
                         budget of 100 instructions) through
                         ``ChainEngine(spec, "kernel")``, bit-equal to the
                         interpreter on the card and to
                         ``addleq_reference``,
                         the looping guest stopped at its fuel; Fig. 12's
                         list walks (8 nodes, with and without break) on
                         1,024 probes through ``get_many``, values equal to
                         the host oracle, steps and ``total_time_us`` equal
                         to the same batch on the CPU, bit for bit.  The
                         guests' serial floor takes one dependent load a
                         step at the latency ``chase_cycles`` measures in
                         shared memory (and, beside it, in L2).
6g. ``cuckoo_get``     — a MemC3-layout cuckoo table (2^18 buckets x 4
                         ways, 4 value words) filled to 90% by the host
                         insert, moved to the card, and one ``lookup`` of
                         65,536 queries (half stored, half absent, key 0)
                         equal to a host dict and to the CPU's lookup.
                         Plain torch: the reference has no kernel here.
7. ``lm_prefill``      — qwen3-1.7b at full width and depth (28 layers,
                         bf16, seeded random weights): ``make_prefill_step``
                         on 4 x 2,048 prompt tokens (one flash-attention
                         launch per layer), then 8 ``decode_step``s whose
                         last logits are held against ``forward`` over all
                         2,056 tokens.
8. ``lm_serve``        — ``ServeEngine`` (8 slots, s_max 4,096): token-bucket
                         admission of a client mix, 32 ticks with the host
                         driver crashed at tick 16 (one launch of each
                         decode-attention kernel, split and combine, per
                         layer per tick), every tick finite and
                         in the vocab.  Here and in ``lm_prefill`` the
                         decode kernel is then held against its plain
                         version on a layer's cache as the drive left it,
                         at the drive's lengths (idle slots' zeros
                         included).  Then ``lm_float32``: the weights cast
                         to float32, the ``lm_prefill`` drive again at
                         2e-3, its ``forward`` the witness of the bf16
                         decode (``decode_witness``).
9. ``flash_kernel``    — the flash-attention kernels against their plain
                         version at the qwen3-1.7b prefill shape (causal),
                         windowed and in length mode, and at the
                         recurrentgemma-9b one (head dim 256, GQA 16,
                         window 2,048), float32 and bfloat16; ragged bf16
                         cases (Sq = Sk = 1,025; Sq 77, Sk 333, q_offset
                         256) at both, and at phi-3-vision's (32 heads
                         of 96: bf16 on the tensor cores, Q and K in a 64-
                         and a 32-column box).  All
                         three shapes timed beside SDPA.  The drives'
                         flash launches by kernel must be 28 tensor-core
                         (lm_prefill), 12 tensor-core (lm_griffin), 28
                         CUDA-core (lm_float32), and those of
                         ``FLASH_DRIVE_LAUNCHES`` for the drives of 12b.
10. ``decode_kernel``  — the decode kernels against their plain version
                         over a 32,768-long cache (B 16), lengths spread
                         over [1, S], and at recurrentgemma-9b's decode
                         shape (B 4, 16 query heads on 1 KV head of 256,
                         S 4,096, window 2,048, lengths 2,049-2,056) and
                         phi-3-vision's (B 4, 32 heads of 96, S 4,096),
                         each whole and as two ``kpos_offset`` shards, bf16
                         and float32.  A planted fault (half of each
                         sequence's rows dropped) must fail the check.
                         Every shape timed (device time from a trace)
                         beside the plain version and SDPA.
11. ``lm_rwkv``        — rwkv6-7b at full width and depth (32 RWKV6 layers,
                         d 4,096, bf16, seeded random weights): the
                         ``lm_prefill`` drive (one WKV6 launch per layer),
                         then 16 ``ServeEngine`` ticks (8 slots, crash at
                         tick 8).  The WKV6 kernel is then held against the
                         plain scan and a float64 scan on layer 0's own
                         (r, k, v, w, u) from the drive, whose decays
                         include channels below the chunked form's range.
                         Then control drives, each with a fault planted in
                         the decode steps' recurrent state, and
                         ``lm_float32``, whose witness must pass the bf16
                         decode and fail each control.
12. ``lm_griffin``     — recurrentgemma-9b at full width and depth (26
                         recurrent layers, one RG-LRU launch each, and 12
                         local-attention layers, head dim 256, 16 query
                         heads on 1 KV head, window 2,048), s_max 4,096:
                         the same drives; the window binds on the last
                         rows.  The decode kernel is held on a local
                         layer's cache as the drive left it.
12b. ``lm_gemma3`` .. ``lm_seamless`` — the ``lm_prefill`` drive of the
                         other archs in bf16 (``ARCH_DRIVES``), B 4, 8
                         decode steps, prefill last logits held against
                         ``forward``, the decode kernel held on the last
                         self-attention layer's cache as decode reads it:
                         gemma3-1b whole (26 layers, 5 local (512) : 1
                         global, vocab 262,144, prompt 2,048);
                         ``lm_gemma3_cache``, the same weights with the
                         rolling (512-slot) and int8 caches, the decode
                         kernel on the dequantized caches; mixtral-8x7b at
                         4 of its 32 layers, capacity factor 8 (drop-free),
                         prompt 1,024; phi-3-vision-4.2b (head dim 96: the
                         tensor-core flash kernel), 576 seeded patch
                         embeddings before 1,472 tokens; seamless-m4t
                         (12 + 12 layers), 2,048 seeded frames through the
                         encoder (flash, mode full) and cross-attention in
                         every decoder layer, 36 flash launches a prefill
                         and 24 + 24 decode launches a step.
13. ``wkv6_kernel``    — the WKV6 kernel against its plain scan at the
                         prefill shape, at a T that is not a multiple of 32
                         and at T = 1, bfloat16 and float32.
14. ``rglru_kernel``   — the RG-LRU kernel likewise, and at a D that ends
                         in a part of the ring kernel's 64-channel tile
                         and at one whose rows no TMA copy can move (the
                         direct kernel); each case's launch by kernel as
                         ``rglru.variant`` picks it.  The recurrentgemma-9b
                         drives' 26 launches a prefill must all be the
                         ring kernel's.
14b. ``wkv6_bwd_kernel`` — the WKV6 backward kernel
                         (``wkv6_bwd_chunk_kernel``: chunks of 16 steps,
                         float32 states, dw with no division by a decay)
                         against its plain backward at the
                         ``wkv6_kernel`` cases (prefill shape, T / 2 + 1,
                         T 1; bf16 and float32), with a final-state
                         gradient, at decays in [0.01, 0.115] and with
                         half the channels at decays in [1e-12, 1e-10]
                         and [1e-30, 1e-20] (both types): dr, dk, dv at
                         REC_TOL, dw and du within STATE_TOL of their
                         largest magnitude, each case bit-equal run to
                         run; timed beside its bound (operations) and the
                         plain backward; its ptxas registers, no spill.
14c. ``rglru_bwd_kernel`` — the RG-LRU backward kernels likewise at the
                         ``rglru_kernel`` cases on the forward kernel's h,
                         with and without a final-state gradient, each
                         case's launch by kernel as ``rglru.variant`` picks
                         it (``rglru_bwd_ring_kernel``, a TMA ring walked
                         from the last step to the first, at the prefill
                         shape, T / 2 + 1 and T 1; ``rglru_bwd_kernel``
                         where no TMA copy can move a row): float32
                         bit-equal to the plain backward, du at REC_TOL,
                         da within STATE_TOL of its largest magnitude,
                         bit-equal run to run; the ring and the direct
                         kernel timed at the prefill shape beside the
                         bytes bound, in both types; no ptxas spill.
15. ``flash_bwd_kernel`` — the flash backward's two pairs, a dQ kernel
                         then a dK/dV kernel: on the tensor cores
                         (``flash_bwd_dq_wgmma_kernel``,
                         ``flash_bwd_dkdv_wgmma_kernel``, and at head
                         dim 256 ``flash_bwd_sum_kernel`` where the
                         dK/dV blocks split a group's heads; bf16 at head
                         dims 64, 128 and 256, whose SASS must hold HGMMA
                         instructions at each, with no ptxas spill) and
                         on the CUDA cores (``flash_bwd_dq_kernel``,
                         ``flash_bwd_dkdv_kernel``; the rest), each case
                         through the pair ``bwd_variant`` picks, against
                         the plain backward, and the forward's lse
                         against the plain one: at qwen3-1.7b's training
                         shape (4, 16 / 8, 2,048^2, head dim 128, causal,
                         bf16) and smollm-135m's (8, 9 / 3, 2,048^2, 64,
                         causal) in bf16 and float32, phi-3-vision's (4,
                         32 / 32, 2,048^2, 96, causal, bf16) and
                         gemma3-1b's (4, 4 / 1, 2,048^2, 256, window 512,
                         bf16); and in both types on window, length (rows
                         past a short length), full (Sk 384), q_offset, G
                         1, head dims 32 / 96 / 256 (an MQA group of 16
                         and each mode's edge at 256) and rows that see
                         no key.  The big shapes timed by device time
                         beside their bound (10 B H D FLOPs a visible
                         pair at the float32 or bf16 peak), the plain
                         backward and SDPA's backward (where SDPA's mask
                         is the window's); the bf16 ones on the
                         tensor-core pair also on the CUDA-core pair (its
                         C entry point), the time that pair replaced.
16. ``lm_train``       — smollm-135m at full width and depth (30 layers,
                         d 576, vocab 49,152, tied), float32, remat
                         "block", batch 8 x 2,048 from ``TokenPipeline``,
                         the launcher's AdamW: the first step's loss,
                         grad_norm and every gradient held against the
                         same step with the plain attention forward and
                         backward on the card; 60 forward (fma) and 30 of
                         each backward kernel's launches a step, counted;
                         30 steps whose loss falls by 0.3 (on
                         ``TokenPipeline`` data over 512 tokens);
                         microbatches=2 against 1; an int8-moment,
                         master-less run that descends; the restart drill
                         at seq 512 (10 steps straight against a crash at
                         7 resumed from the step-5 checkpoint: every
                         parameter and optimizer tensor bit-equal, with
                         PyTorch's default algorithms); ms a step, tokens/s,
                         peak memory and a traced step's idle share.
17. ``lm_train_bf16``  — qwen3-1.7b at full width and depth (28 layers,
                         16 / 8 heads, head dim 128, vocab 151,936,
                         tied), bf16 with AdamW's float32 master and
                         moments, remat "block", batch 4 x 2,048 from
                         ``TokenPipeline``, the launcher's AdamW: the
                         first step's loss and gradients against the same
                         step with the plain attention, beside the same
                         step with the flash backward's CUDA-core pair
                         (the tensor-core pair's worst gradient error
                         within 2x the CUDA-core pair's, the loss within
                         1e-2 relative); 56 forward (wgmma) and 28 + 28
                         tensor-core backward launches a step and no
                         CUDA-core one, counted; 12 steps (on data over
                         512 tokens) whose losses are finite and whose
                         last is below the first; ms a step, tokens/s,
                         peak memory, a traced step's idle share and its
                         device time by flash backward (dQ, dK/dV), flash
                         forward, matmuls and the rest.
18. ``lm_train_rwkv``   — rwkv6-7b at full width and 8 of its 32 layers
                         (2.29 G parameters), bf16 with AdamW's float32
                         master and moments, remat "block", batch 4 x
                         2,048: the first step's loss and gradients at
                         sequence 512 against the same call with the
                         plain recurrences (plain forward and plain
                         backward functions) on the card, beside the
                         same with their forward in float64; 16 WKV6
                         forward and 8 backward (``wkv6_bwd_chunk_kernel``)
                         launches a step and no plain call; 8 steps (on
                         data over 512 tokens) whose losses are finite and
                         fall; ms a step, tokens/s, peak memory, a traced
                         step's idle share and its device time by kernel
                         group and by backward kernel.
19. ``lm_train_griffin`` — recurrentgemma-9b at full width and one
                         pattern (2 recurrent layers and 1 local-attention
                         layer, 2.76 G parameters), bf16, batch 2 x 2,048:
                         the same, the plain arm and the yardstick with
                         the plain attention and the CUDA-core backward
                         pair too; 4 RG-LRU forward (ring) and 2 backward
                         (ring) launches, 2 flash forward (tensor cores) and 1 +
                         1 tensor-core backward launches a step (and the
                         partial sums' kernel once where the heads are
                         split); then the flash backward at its shape (2,
                         16 / 1, 2,048^2, head dim 256, window 2,048,
                         bf16; the tensor-core pair) against the plain
                         backward, timed beside its bound, the CUDA-core
                         pair, the plain backward and SDPA's backward.

Each kernel's launches are counted over the drive of its path only (the
counts are zeroed just before and read just after); the comparison and
timing launches come after.  The int32 kernels are exact (tolerance 0);
the flash kernel is held at 2e-5 (float32) and 2e-2 (bfloat16),
test_kernels.py's tolerances, the decode partial at DECODE_TOL in
both types, the recurrences at REC_TOL and their float32 final states at
STATE_TOL; the flash backward's gradients at TOL of their largest
magnitude, lm_train's at GRAD_REL, lm_train_bf16's against the
CUDA-core pair's error (BF16_WITNESS_K), the recurrent drives' against
the float64 recurrences' with the CUDA-core pair (REC_WITNESS_K); the
recurrences' backward kernels as 14b and 14c say.  The
last lines are the kernels' JSON, the card line from ``nvidia-smi`` and
the result line.  Without a
CUDA card, or outside a checkout, the script exits non-zero and prints no
result.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import importlib.util
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM memory bandwidth (data sheet)
BF16_FLOP_PER_S = 989e12           # H100 SXM dense bf16 tensor-core peak
F32_FLOP_PER_S = 67e12             # H100 SXM float32 peak, no tensor cores
# H100 SXM dense TF32 tensor-core peak over three: a float32 product taken
# as three TF32 products of split operands (hi hi, hi lo, lo hi)
TF32X3_FLOP_PER_S = 495e12 / 3
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # test_kernels.py's
# Last logits of prefill + decode against one forward over the same tokens
# (different shapes, so different bf16 roundings): bf16 keeps 8 significant
# bits, so one rounding flip moves an activation by ~2^-8 of its size, and
# flips accumulate over 28 layers.  The logits' std is 0.02 * sqrt(2048),
# ~0.9, at these init scales; 1/8 of that unit scale bounds the rounding,
# while a wrong cache or mask moves logits by O(1).  Float32 (the CPU
# rehearsal) keeps test_system.py's 2e-3.  qwen3's decoded logits are held
# to it; the recurrent models' bf16 prefill logits are, but their decode
# departs further (PERF.md), and every model's decode is held by
# ``decode_witness`` instead.
LOGIT_TOL = {torch.float32: 2e-3, torch.bfloat16: 0.125}
# The decode partial against its plain version, in either type: both read
# the same inputs and accumulate in float32, so the limit is set from the
# readings of sound runs (at most 1.7e-6, on l / l over a 32,768-long
# cache), not from bf16's precision.  A dropped half of each sequence's
# rows moves acc / l by orders of magnitude more (PERF.md).
DECODE_TOL = 1e-5
# The recurrences' outputs against their plain scans (and a float64 scan):
# test_kernels.py's tolerances; the final states are float32 in either
# input type and are held at the float32 limit.
REC_TOL = {torch.float32: 5e-5, torch.bfloat16: 5e-2}
STATE_TOL = 5e-5
# The bf16 decode witness: bf16 decoded logits against float32 ``forward``
# on the same weights may be WITNESS_K times as far from it as bf16
# ``forward`` is on the same rows (the bf16 rounding floor of the model at
# this depth).  Sound runs read 1.007-1.052 of it and the control runs,
# each with one STATE_FAULTS fault planted in the decode step's recurrent
# state, 6.09-11.1 (H100, full width and depth; PERF.md).  A fault of one
# bf16 rounding reads as the floor: the CPU tests hold those casts.
WITNESS_K = 2.0
STATE_FAULTS = ("stale", "zero")
# A WKV6 channel whose decay over a 32-step chunk falls below the chunked
# form's 1e-30 clamp: 32 |log w| > 69 (w < ~0.115).
CHUNK_LOG_RANGE = 69.0


def _import_port():
    """Import the port from this checkout's ``src`` (and nowhere else); a
    copy of this script outside a checkout exits non-zero here."""
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        raise SystemExit(f"chip_smoke: no src/repro_torch beside this script"
                         f" in {ROOT}: run it from the root of a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch
    if Path(repro_torch.__file__).resolve().parents[1] != ROOT / "src":
        raise RuntimeError(f"repro_torch imported from {repro_torch.__file__}"
                           f", not from this checkout ({ROOT})")


_import_port()
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import analysis, turing  # noqa: E402
from repro_torch.core import faults, isa, machine, programs  # noqa: E402
from repro_torch.core.engine import ChainEngine  # noqa: E402
from repro_torch.data.pipeline import TokenPipeline  # noqa: E402
from repro_torch.data.pipeline import kv_request_stream  # noqa: E402
from repro_torch.distributed import fault  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.chain_interp import ops as interp_ops  # noqa: E402
from repro_torch.kernels.chain_interp import ref as walk_ref  # noqa: E402
from repro_torch.kernels.chain_vm import ops as chain_ops  # noqa: E402
from repro_torch.kernels.chain_vm import ref as chain_ref  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.decode_attention import ref as dec_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.hopscotch import ops as hop_ops  # noqa: E402
from repro_torch.kernels.rglru import ops as rg_ops  # noqa: E402
from repro_torch.kernels.rglru import ref as rg_ref  # noqa: E402
from repro_torch.kernels.rwkv6 import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.rwkv6 import ref as wkv_ref  # noqa: E402
from repro_torch.kvstore import cuckoo, fsck, hopscotch, store  # noqa: E402
from repro_torch.launch import mesh as launch_mesh  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models import layers as model_layers  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import rwkv  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.rdma import failure, isolation, transport  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.train import checkpoint as train_ckpt  # noqa: E402
from repro_torch.train import loop as train_loop  # noqa: E402
from repro_torch.train import optimizer as train_opt  # noqa: E402


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Mean device time of ``fn()`` in ms, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def timed_call(device, fn):
    """``(fn(), ms)``: CUDA events around the call on the card, the host
    clock on the CPU."""
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        return fn(), (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    value = fn()
    end.record()
    end.synchronize()
    return value, start.elapsed_time(end)


LAUNCH_COUNTS = (chain_ops.launches, interp_ops.launches, hop_ops.launches,
                 fa_ops.launches, dec_ops.launches, wkv_ops.launches,
                 rg_ops.launches)


def reset_launches():
    for counts in LAUNCH_COUNTS:
        for k in counts:
            counts[k] = 0


def read_launches() -> dict:
    return {k: n for counts in LAUNCH_COUNTS for k, n in counts.items()}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def require_close(got, want, tol: float, what: str) -> float:
    """Raise unless |got - want| <= tol + tol * |want| everywhere (and both
    are finite); returns the max absolute difference."""
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}")
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"{what}: non-finite values")
    diff = (got - want).abs()
    bad = diff > tol + tol * want.abs()
    if bool(bad.any()):
        raise AssertionError(f"{what}: {int(bad.sum())} values off by more "
                             f"than {tol} (max {float(diff.max())})")
    return float(diff.max())


def require_scaled(got, want, rel: float, what: str) -> float:
    """Raise unless |got - want| <= rel * max|want| everywhere (and both
    are finite): a gradient held at a tolerance relative to its largest
    magnitude.  Returns max|got - want| / max|want|."""
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}")
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"{what}: non-finite values")
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max()) / scale
    if err > rel:
        raise AssertionError(f"{what}: off by {err} of its largest "
                             f"magnitude {scale} (limit {rel})")
    return err


def require_equal(a, b, what: str) -> int:
    """Raise unless the two integer arrays are equal; returns the max
    absolute difference (0)."""
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    if a.shape != b.shape or not np.array_equal(a, b):
        bad = np.argwhere(a != b)[:5] if a.shape == b.shape else "shape"
        raise AssertionError(f"{what}: mismatch {a.shape} vs {b.shape} at "
                             f"{bad}")
    if a.size == 0 or a.dtype == bool:
        return 0
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())


def mixed_keys(batch: int, live, miss_every: int = 4):
    """Deterministic mixed hit/miss key batch (the throughput benchmark's)."""
    live = list(live)
    return [1_000_000 + i if i % miss_every == miss_every - 1
            else live[i % len(live)] for i in range(batch)]


# ---------------------------------------------------------------------------
# phase 2: the main path
# ---------------------------------------------------------------------------

def build_store(n_shards: int, buckets: int, n_keys: int, val_words: int = 4):
    """The store loaded through the host ``set``: key k -> [k, 2k, 3k, 5k]."""
    kv = store.ShardedKV.build(n_shards, buckets, val_words)
    for k in range(1, n_keys + 1):
        if not kv.set(k, [k, 2 * k, 3 * k, 5 * k][:val_words]):
            raise RuntimeError(f"host set of key {k} needs a resize")
    return kv


def kv_batches(n_shards: int, n_keys: int, batch: int, n_batches: int):
    """(S, batch) zipf query batches from each source shard, with a few
    misses and key 0 mixed in."""
    stream = kv_request_stream(n_keys, batch, zipf_a=1.1, seed=1)
    out = []
    for i in range(n_batches):
        q = np.stack([next(stream)[1] for _ in range(n_shards)])
        q[:, -2] = n_keys + 1 + np.arange(n_shards) + i * n_shards  # misses
        q[i % n_shards, -1] = 0                                      # key 0
        out.append(q.astype(np.int32))
    return out


def redn_breakdown(dk, dv, q, neighborhood: int = 8) -> dict:
    """Device time of each stage of one redn batch (ms, CUDA events; the
    second of two passes, so nothing is cold, and each pass's tensors
    freed before the next, as a serving loop frees a batch before the
    next: the allocator's cache then serves every stage), and the
    interpreter's step count: where the path's time goes.  The deliver
    stage builds the split batch (``deliver_shared``): the words each
    context copies (its private segment) and the bytes the stage writes
    are reported beside it."""
    s, n = dk.shape[0], dk.shape[1]
    srv = programs.build_hopscotch_server(n, dv.shape[2], neighborhood,
                                          device=dk.device)
    out = {}

    def timed(name, fn):
        value, out[name + "_ms"] = timed_call(dk.device, fn)
        return value

    for i in range(2):
        if i:
            out.update(contexts=int(ran.state.mem.shape[0]),
                       private_words=int(ran.state.mem.shape[1]),
                       image_words=int(ran.base.shape[1]),
                       deliver_bytes=sum(t.numel() * t.element_size()
                                         for t in ran.state),
                       steps=int(ran.state.steps.max()))
            del state, recv, pos, ok, batch, ran, resp
            torch.cuda.synchronize()
        state = timed("device_state", lambda: srv.device_state(dk, dv))
        dest = store.shard_of(q, s)
        pay = srv.device_payloads(q, hopscotch.bucket_of(q, n))
        recv, pos, ok = timed("dispatch", lambda: transport.dispatch(
            pay, dest, s, q.shape[1]))
        batch = timed("deliver", lambda: machine.deliver_shared(
            state, srv.recv_wq, recv.reshape(s, -1, recv.shape[-1]),
            srv.shared_window))
        batch.state.steps.zero_()
        ran = timed("step_loop", lambda: machine.run_batch_shared_in_place(
            srv.spec, batch, 256))
        resp = timed("response", lambda: machine.words(
            ran, srv.resp_region, srv.resp_words))
        timed("combine", lambda: transport.combine(
            resp.reshape(s, s, q.shape[1], -1), dest, pos, ok))
    out["full_copy_bytes"] = out["deliver_bytes"] + out["contexts"] * (
        out["image_words"] - out["private_words"]) * 4
    out["step_ms"] = out["step_loop_ms"] / max(out["steps"], 1)
    return out


def get_latency_ms(dk, dv, keys, method: str, reps: int = 128,
                   warmup: int = 8) -> float:
    """The median time of one GET, one request at a time: shard 0 asks
    ``keys[i]`` (cycled), the other shards send nothing (``live`` False);
    CUDA events around each ``sharded_get`` call, after ``warmup``
    calls."""
    s = dk.shape[0]
    live = torch.zeros((s, 1), dtype=torch.bool, device=dk.device)
    live[0] = True
    times = []
    for i in range(warmup + reps):
        q = torch.zeros((s, 1), dtype=torch.int32, device=dk.device)
        q[0, 0] = int(keys[i % len(keys)])
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        store.sharded_get(dk, dv, q, method=method, live=live,
                          device=dk.device)
        end.record()
        end.synchronize()
        if i >= warmup:
            times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_kv_get(device, n_shards=4, buckets=65536, n_keys=157286, batch=64,
                 n_batches=4, time_it=True):
    t0 = time.perf_counter()
    kv = build_store(n_shards, buckets, n_keys)
    load_s = time.perf_counter() - t0
    per_shard = [int((t.keys != 0).sum()) for t in kv.tables]
    dk, dv = kv.device_arrays(device)
    batches = kv_batches(n_shards, n_keys, batch, n_batches)
    refs = [store.reference_get(kv, q) for q in batches]
    peak = 0
    result = dict(shards=n_shards, buckets_per_shard=buckets, keys=n_keys,
                  load_s=load_s, keys_per_shard=per_shard, hits={},
                  gets_per_s={}, get_latency_ms={}, peak_bytes={})
    for method in ("redn", "one_sided", "two_sided"):
        if time_it:
            # the bytes a batch of this path allocates at its peak, over
            # what the store holds
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            store.sharded_get(dk, dv, torch.from_numpy(batches[0]).to(device),
                              method=method, device=device)
            torch.cuda.synchronize()
            result["peak_bytes"][method] = (torch.cuda.max_memory_allocated()
                                            - held)
        hits = 0
        for q, (rf, rv) in zip(batches, refs):
            res = store.sharded_get(dk, dv, torch.from_numpy(q),
                                    method=method, device=device)
            if not bool(res.ok.all()):
                raise AssertionError(f"{method}: requests dropped: {res}")
            require_equal(res.found.reshape(-1), rf, f"{method} found")
            require_equal(res.values.reshape(-1, rv.shape[1]), rv,
                          f"{method} values")
            hits += int(res.found.sum())
        result["hits"][method] = hits
        if time_it:
            qs = [torch.from_numpy(q).to(device) for q in batches]
            ms = cuda_ms(lambda: [store.sharded_get(
                dk, dv, q, method=method, device=device) for q in qs],
                reps=1, warmup=1)
            result["gets_per_s"][method] = (n_batches * n_shards * batch
                                            / (ms * 1e-3))
            result["get_latency_ms"][method] = get_latency_ms(
                dk, dv, batches[0][0][:-2], method)
            peak = max(peak, torch.cuda.max_memory_allocated())
    if time_it:
        result["max_memory_allocated"] = peak
        result["redn_breakdown"] = redn_breakdown(
            dk, dv, torch.from_numpy(batches[0]).to(device))
    return result, kv, dk, dv


GET_FIELDS = ("found", "values", "ok", "dropped", "deferred")


def phase_kv_get_group(device, kv, dk, dv, n_keys=157286, batch=64,
                       n_batches=4, time_it=True):
    """The ``kv_get`` store and batches through the store's process-group
    arm: a group of one rank (NCCL on the card, gloo on the CPU; a
    ``HashStore``) on ``make_host_mesh(1, 1)``, the rank holding all the
    shards.  Every path's results are held bit-equal to the one-device
    arm's on the same batches; gets/s of both arms are timed in turns, and
    one all-to-all exchange of the redn dispatch window by CUDA events.
    The group is destroyed at the end."""
    dev = torch.device(device)
    n_shards = dk.shape[0]
    batches = [torch.from_numpy(q).to(dev) for q in kv_batches(
        n_shards, n_keys, batch, n_batches)]
    kw = (dict(device_id=torch.device("cuda", torch.cuda.current_device()
                                      if dev.index is None else dev.index))
          if dev.type == "cuda" else {})
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1,
                            **kw)
    try:
        mesh = launch_mesh.make_host_mesh(1, 1, device_type=dev.type)
        group = mesh.get_group("data")
        gk, gv = kv.device_arrays(dev, group=group)
        result = dict(backend=dist.get_backend(group),
                      ranks=dist.get_world_size(group),
                      shards_per_rank=int(gk.shape[0]),
                      mesh=dict(zip(mesh.mesh_dim_names,
                                    map(int, mesh.mesh.shape))),
                      batches=n_batches, batch=batch, checked={},
                      gets_per_s={})
        for method in ("redn", "one_sided", "two_sided"):
            n = 0
            for q in batches:
                one = store.sharded_get(dk, dv, q, method=method,
                                        device=dev)
                grp = store.sharded_get(gk, gv, q, method=method,
                                        device=dev, group=group)
                for f in GET_FIELDS:
                    a, b = getattr(one, f), getattr(grp, f)
                    if a.dtype != b.dtype or not torch.equal(a, b):
                        raise AssertionError(
                            f"kv_get_group {method}: {f} differs from the "
                            f"one-device arm")
                n += q.numel()
            result["checked"][method] = n
            if time_it:
                arms = dict(one_device=lambda: [store.sharded_get(
                    dk, dv, q, method=method, device=dev) for q in batches],
                    group=lambda: [store.sharded_get(
                        gk, gv, q, method=method, device=dev, group=group)
                        for q in batches])
                ms = {}
                for turn in ("one_device", "group", "group", "one_device"):
                    ms.setdefault(turn, []).append(
                        cuda_ms(arms[turn], reps=1, warmup=1))
                result["gets_per_s"][method] = {
                    arm: n_batches * n_shards * batch
                    / (float(np.mean(t)) * 1e-3) for arm, t in ms.items()}
        srv = programs.build_hopscotch_server(dk.shape[1], dv.shape[2], 8,
                                              device=dev)
        q = batches[0]
        pay = srv.device_payloads(q, hopscotch.bucket_of(q, dk.shape[1]))
        window = pay.new_zeros((n_shards, n_shards, batch, pay.shape[-1]))
        if not torch.equal(transport.exchange(window, group),
                           window.transpose(0, 1)):
            raise AssertionError("exchange of one rank is not the swap")
        result["exchange_shape"] = list(window.shape)
        result["exchange_bytes"] = window.numel() * window.element_size()
        if time_it:
            result["exchange_ms"] = cuda_ms(
                lambda: transport.exchange(window, group), reps=20)
            result["card"] = card_line()
    finally:
        dist.destroy_process_group()
    return result


# ---------------------------------------------------------------------------
# phase 3: the managed chain kernel (ChainEngine "kernel" backend)
# ---------------------------------------------------------------------------

def recycled_server(device, n_buckets, mem_words, n_keys):
    srv = programs.build_recycled_get_server(n_buckets=n_buckets, val_len=2,
                                             mem_words=mem_words,
                                             device=device)
    for k in range(1, n_keys + 1):
        srv.insert(k, [k * 11, k * 11 + 1])
    srv.load()
    return srv


def served_value(srv, key: int):
    """What the recycled server answers for ``key``: its value if the key
    holds its bucket, else zeros."""
    entry = srv.kv.get(srv.h1(key))
    return entry[1] if entry is not None and entry[0] == key else [0, 0]


def kernel_args(spec, states, max_steps: int):
    """The arguments ``ChainEngine(spec, "kernel").run_batch`` passes to
    ``run_managed`` for ``states`` (fresh fuel, no faults)."""
    n, cap = states.mem.shape[0], states.msg_buf.shape[2]
    fuel = torch.clamp(max_steps - states.steps, 0, max_steps)
    inits = torch.stack(
        [states.head[:, 0], states.tail[:, 0], states.enable_limit[:, 0],
         states.completions[:, 0], states.msg_head[:, 0],
         states.msg_tail[:, 0], fuel.to(torch.int32),
         states.halted.to(torch.int32)], dim=1).contiguous()
    msgs = states.msg_buf[:, 0].reshape(n, cap * isa.MSG_WORDS).contiguous()
    kw = dict(wq_base=spec.wq_bases[0], n_wrs=spec.wq_sizes[0],
              managed=bool(spec.managed[0]), max_steps=max_steps)
    return (states.mem.contiguous(), msgs, inits), kw


def plain_run_many(spec, state, wq, payloads, max_steps):
    """The batch ``ChainEngine(spec, "kernel").run_many`` runs, through the
    plain ``managed_chain_loop`` instead of the kernel; fields as the
    engine maps them back."""
    batch = ChainEngine(spec).deliver_many(state, wq, payloads)
    batch.steps.zero_()
    args, kw = kernel_args(spec, batch, max_steps)
    mem, stats = chain_ref.managed_chain_loop(*args, **kw)
    return dict(mem=mem, head=stats[:, 0:1], enable_limit=stats[:, 1:2],
                completions=stats[:, 2:3], msg_head=stats[:, 3:4],
                halted=stats[:, 4] > 0, responses=stats[:, 6],
                steps=stats[:, 0] - batch.head[:, 0]), (batch, args, kw)


_CHAIN_FIELDS = ("mem", "head", "enable_limit", "completions", "msg_head",
                 "halted", "responses", "steps")


def chain_kernel_cases(device, n_buckets=65536, mem_words=1 << 19,
                       n_keys=40000, batch=256, small=(1, 16, 64, 256)):
    """(server, payloads) for the big server and the benchmark-size ones."""
    cases = []
    srv = recycled_server(device, n_buckets, mem_words, n_keys)
    keys = mixed_keys(batch, range(1, n_keys + 1, max(1, n_keys // batch)))
    cases.append((srv, np.asarray([srv._payload(k) for k in keys], np.int32)))
    small_srv = recycled_server(device, 32, 4096, 16)
    for b in small:
        keys = mixed_keys(b, range(1, 17))
        cases.append((small_srv, np.asarray(
            [small_srv._payload(k) for k in keys], np.int32)))
    return cases


def phase_chain_kernel(device, time_it=True, **sizes):
    cases = chain_kernel_cases(device, **sizes)
    reset_launches()
    outs = [ChainEngine(srv.spec, "kernel").run_many(
        srv.state, srv.loop_wq, pay, 64) for srv, pay in cases]
    launches = read_launches()["run_managed"]
    err = 0
    for (srv, pay), out_k in zip(cases, outs):
        out_i = ChainEngine(srv.spec, "interp").run_many(
            srv.state, srv.loop_wq, pay, 64)
        plain, _ = plain_run_many(srv.spec, srv.state, srv.loop_wq, pay, 64)
        for f in _CHAIN_FIELDS:
            err = max(err, require_equal(getattr(out_k, f), getattr(out_i, f),
                                         f"kernel vs interp {f}"))
            require_equal(getattr(out_k, f), plain[f], f"kernel vs plain {f}")
        resp = out_k.mem[:, srv.resp_region:srv.resp_region + srv.val_len]
        require_equal(resp, [served_value(srv, int(k)) for k in pay[:, 0]],
                      "recycled server responses")
    result = dict(launches=launches, max_abs_err=err,
                  contexts=[int(p.shape[0]) for _, p in cases])
    srv, pay = cases[0]
    _, (batch, args, kw) = plain_run_many(srv.spec, srv.state, srv.loop_wq,
                                          pay, 64)
    mem_k, stats_k = chain_ops.run_managed(*args, **kw)
    mem_p, stats_p = chain_ref.managed_chain_loop(*args, **kw)
    err = max(err, require_equal(mem_k, mem_p, "run_managed mem"),
              require_equal(stats_k, stats_p, "run_managed stats"))
    result["max_abs_err"] = err
    result["shape"] = tuple(batch.mem.shape)
    result["bound_ms"] = 2 * batch.mem.numel() * 4 / HBM_BYTES_PER_S * 1e3
    if time_it:
        result["ms"] = cuda_ms(lambda: chain_ops.run_managed(*args, **kw))
        result["plain_ms"] = cuda_ms(
            lambda: chain_ref.managed_chain_loop(*args, **kw), reps=2)
    return result


# ---------------------------------------------------------------------------
# phase 3b: kill faults on the chain kernel, and the storm drill
# ---------------------------------------------------------------------------

_FAULT_FIELDS = _CHAIN_FIELDS + ("msg_head",)


def storm_drill(device, n_buckets=32, n_req=12, h=4, seed=20260807) -> dict:
    """``tests/test_faults.py``'s storm drill on ``device``: a (1, 12) SET
    batch under a seeded storm of all four kinds, fsck, repair, and a
    retry of the rows that did not reach a terminal status.  Returns
    every status, array and report as host values, to hold the card's run
    against the CPU's."""
    keys = torch.zeros((1, n_buckets), dtype=torch.int32)
    vals = torch.zeros((1, n_buckets, 2), dtype=torch.int32)
    sk = torch.arange(1, n_req + 1, dtype=torch.int32)[None] * 17
    sv = torch.stack([sk[0] % 251 + 1, sk[0] % 97 + 1], dim=1)[None]
    plan = faults.storm(n_req, p_fault=0.5, max_step=60, seed=seed,
                        device=device)
    plan = faults.FaultPlan(*(leaf[None] for leaf in plan))
    res, keys, vals = store.sharded_set(keys, vals, sk, sv, neighborhood=h,
                                        faults=plan, device=device)
    out = dict(status=res.status, torn_keys=keys, torn_vals=vals)
    rep = fsck.check_invariants(keys, vals, neighborhood=h)
    if not rep.repairable:
        raise AssertionError(f"storm drill: unrepairable {rep}")
    keys, vals, actions = fsck.repair(keys, vals, rep, neighborhood=h)
    retry = ~torch.isin(res.status, torch.tensor(SET_TERMINAL,
                                                 device=res.status.device))
    if not bool(retry.any()):
        raise AssertionError("storm drill: no chain was interrupted")
    res2, keys, vals = store.sharded_set(keys, vals, sk, sv, neighborhood=h,
                                         live=retry, device=device)
    if not bool(torch.isin(res2.status[retry], torch.tensor(
            SET_TERMINAL, device=res2.status.device)).all()):
        raise AssertionError(f"storm drill: retry {res2}")
    found, got = hopscotch.lookup(keys[0], vals[0], sk[0].to(keys.device), h)
    require_equal(found, np.ones(n_req, bool), "storm drill found")
    require_equal(got, sv[0], "storm drill values")
    if not fsck.check_invariants(keys, vals, neighborhood=h).clean:
        raise AssertionError("storm drill: fsck not clean at the end")
    out.update(status2=res2.status, keys=keys, vals=vals)
    out = {k: v.cpu().numpy() for k, v in out.items()}
    out.update(report=rep.violations, actions=actions)
    return out


def phase_chain_faults(device, n_buckets=65536, mem_words=1 << 19,
                       n_keys=40000, batch=256, max_steps=64, cut_keys=3,
                       seed=20260807, drill=True):
    """Kill faults through ``ChainEngine(spec, "kernel")`` (fuel truncation
    per context) against the interpreter under the same rows, on the
    ``chain_kernel`` phase's recycled server: a batch under a seeded storm
    of kill rows, and ``cut_keys`` keys cut at every step from 0 to the
    fuel; the interpreter's runs are held to the plain loop on the same
    inputs.  A suppress row must be refused.  Then the storm drill on this
    device against the same drill on the CPU, bit for bit."""
    srv = recycled_server(device, n_buckets, mem_words, n_keys)
    keys = mixed_keys(batch, range(1, n_keys + 1, max(1, n_keys // batch)))
    storm_plan = faults.storm(batch, p_fault=0.5, max_step=max_steps,
                              seed=seed, kinds=("kill",), device=device)
    cut = keys[:cut_keys - 1] + [keys[3]]            # hits and a miss
    cut_pay = [srv._payload(k) for k in cut for _ in range(max_steps + 1)]
    cut_plan = faults.FaultPlan.none((len(cut_pay),), device=device)._replace(
        kill_step=torch.arange(max_steps + 1, dtype=torch.int32,
                               device=device).repeat(len(cut)))
    cases = [(np.asarray([srv._payload(k) for k in keys], np.int32),
              storm_plan),
             (np.asarray(cut_pay, np.int32), cut_plan)]
    kernel = ChainEngine(srv.spec, "kernel")
    reset_launches()
    outs = [kernel.run_many(srv.state, srv.loop_wq, pay, max_steps, plan)
            for pay, plan in cases]
    launches = read_launches()["run_managed"]
    err, truncated = 0, 0
    with captured_runs() as runs:
        outs_i = [ChainEngine(srv.spec, "interp").run_many(
            srv.state, srv.loop_wq, pay, max_steps, plan)
            for pay, plan in cases]
    # the plain loop witnesses both kernels on the same inputs
    plain = check_interp_runs(device, "killed interp", runs, None)
    del runs
    for (pay, plan), out_k, out_i in zip(cases, outs, outs_i):
        for f in _FAULT_FIELDS:
            err = max(err, require_equal(getattr(out_k, f),
                                         getattr(out_i, f),
                                         f"killed kernel vs interp {f}"))
        kill = plan.kill_step
        truncated += int(((kill >= 0) & (out_k.steps == kill)
                          & ~out_k.halted).sum())
    clean = kernel.run_many(srv.state, srv.loop_wq, cases[1][0], max_steps)
    full = int(clean.steps.max())
    if truncated < 1 or full < 2:
        raise AssertionError(f"no kill truncated a chain ({truncated}, "
                             f"chains of {full} steps)")
    try:
        kernel.run_many(srv.state, srv.loop_wq, cases[0][0][:1], max_steps,
                        faults.FaultPlan.suppress_at(1, shape=(1,),
                                                     device=device))
    except ValueError as exc:
        if "suppress" not in str(exc) or "truncation" not in str(exc):
            raise
    else:
        raise AssertionError("the kernel backend ran a suppress fault")
    result = dict(launches=launches, max_abs_err=err,
                  interp_vs_plain=dict(
                      max_abs_err=plain["max_abs_err"], ms=plain["ms"],
                      plain_ms=plain["plain_ms"], runs=plain["runs"]),
                  contexts=[int(p.shape[0]) for p, _ in cases],
                  storm_armed=int(storm_plan.active().sum()),
                  truncated=truncated, chain_steps=full)
    if drill:
        t0 = time.perf_counter()
        here = storm_drill(device)
        result["drill_s"] = time.perf_counter() - t0
        cpu = storm_drill("cpu")
        for k, v in cpu.items():
            if k in ("report", "actions"):
                if here[k] != v:
                    raise AssertionError(f"storm drill {k}: {here[k]} vs "
                                         f"{v}")
            else:
                require_equal(here[k], v, f"storm drill {k} vs the CPU")
        result.update(drill_violations=len(cpu["report"]),
                      drill_retried=int((cpu["status2"] != 0).sum()))
    return result


# ---------------------------------------------------------------------------
# phase 3c: the chain interpreter kernel against its plain loop
# ---------------------------------------------------------------------------

# dependent round trips a step of the interpreter kernel takes at least:
# the head WRs' words (eligibility), the chosen WR's fields, the
# read-modify-write (or the copy's or scatter's reads), the store.  Each is
# an L2 trip for an image in global memory and a shared-memory trip for a
# split batch's private words, staged, whose window reads (a GET's probe
# READs and value row) still go to L2
INTERP_STEP_TRIPS = 4


def copy_batch(s):
    """A copy of a full batch or of a :class:`machine.SharedBatch`."""
    if isinstance(s, machine.SharedBatch):
        return machine.SharedBatch(machine._clone(s.state), s.base.clone(),
                                   s.lo, s.hi)
    return machine._clone(s)


def full_batch(s) -> machine.VMState:
    """A batch's full images: a split batch materialized."""
    return machine.materialize(s) if isinstance(s, machine.SharedBatch) \
        else s


def run_state(s) -> machine.VMState:
    """The per-context fields of a run's batch (private words as mem)."""
    return s.state if isinstance(s, machine.SharedBatch) else s


def kernel_device_ms(fn) -> tuple:
    """``chain_interp_kernel``'s device time a call of ``fn`` from a trace,
    and how it was timed (CUDA events around the calls where the trace
    held no device time)."""
    prof = device_time(fn, 2, ("chain_interp_kernel",))
    if prof["timed_by"] == "trace":
        return prof["by_kernel_ms"]["chain_interp_kernel"], "trace"
    return prof["device_ms"], "events"


def interp_images():
    """``tests/_interp_images.py`` (numpy only: the interpreter's hazard
    corpus) from this checkout."""
    spec = importlib.util.spec_from_file_location(
        "_interp_images", ROOT / "tests" / "_interp_images.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def captured_runs():
    """Every interpreter run inside the block, as it reaches the wrapper:
    the spec, a copy of the state before and after the launch, and the
    run's arguments."""
    runs, real = [], interp_ops.run_interp

    def capture(spec, s, max_steps=4096, faults=None, quota=None,
                writer_slices=None):
        dev = run_state(s).mem.device
        plan = None if faults is None else type(faults)(*(
            torch.as_tensor(leaf, device=dev).to(torch.int32).clone()
            for leaf in faults))
        before = copy_batch(s)
        out = real(spec, s, max_steps, faults, quota, writer_slices)
        runs.append(dict(spec=spec, before=before, after=copy_batch(out),
                         kw=dict(max_steps=max_steps, faults=plan,
                                 quota=None if quota is None
                                 else quota.clone(),
                                 writer_slices=writer_slices)))
        return out

    interp_ops.run_interp = capture
    try:
        yield runs
    finally:
        interp_ops.run_interp = real


def interp_floor_ms(cycles, split: bool, steps, reads) -> float:
    """The serial floor of a run, in ms at the card's maximum SM clock:
    the row that takes longest at ``INTERP_STEP_TRIPS`` dependent trips a
    step, each an L2 hit (an image in global memory) or a shared-memory
    load (a split batch's staged private words), plus, when split, one L2
    hit for each READ (a window read: a GET's probe).  ``cycles``:
    ``chase_cycles`` by level, or None off the card (floor 0)."""
    if cycles is None:
        return 0.0
    per_step = cycles["shared" if split else "l2"] * INTERP_STEP_TRIPS
    rows = steps.double() * per_step
    if split:
        rows = rows + reads.double() * cycles["l2"]
    return float(rows.max()) / max_sm_clock_hz() * 1e3


def check_interp_runs(device, what: str, runs, cycles) -> dict:
    """Each captured run's kernel result against the plain loop
    (``machine.plain_run``) on a copy of the same input on the card, all 14
    fields bit-equal; a split batch's kernel run is materialized and held
    to the plain loop's run of the full copies.  The wrapper's call
    (again, on another copy; ``call_ms``, host work and a split run's
    flag read included) and the plain loop timed by CUDA events; the
    kernel alone (``ms``) by device time from a trace, beside the serial
    floor (:func:`interp_floor_ms`).  The bytes bound counts what
    the run's data needs: each executed WR's 8 words read, each changed
    word of the images and message queues written, each WQ's counters and
    clocks read and written."""
    if not runs:
        raise AssertionError(f"{what}: no interpreter run")
    out = dict(runs=len(runs), rows=0, wqs=sorted({r["spec"].num_wqs
                                                    for r in runs}),
               steps_max=0, steps_total=0, ms=0.0, call_ms=0.0, plain_ms=0.0,
               serial_floor_ms=0.0, bytes=0, max_abs_err=0.0, split=[],
               timed_by=[])
    for r in runs:
        spec, before, after, kw = r["spec"], r["before"], r["after"], r["kw"]
        x = machine._clone(full_batch(before))
        plain, plain_ms = timed_call(device, lambda: machine.plain_run(
            spec, x, **kw))
        out["max_abs_err"] = max(out["max_abs_err"], require_states(
            full_batch(after), plain, f"{what}: kernel vs plain loop"))
        del x, plain
        x = copy_batch(before)
        _, ms = timed_call(device, lambda: interp_ops.run_interp(spec, x,
                                                                 **kw))
        require_states(run_state(x), run_state(after),
                       f"{what}: kernel run to run")
        del x
        kernel_ms, timed_by = ms, "events"
        if on_card(device):
            kernel_ms, timed_by = kernel_device_ms(
                lambda: interp_ops.run_interp(spec, copy_batch(before), **kw))
        b0, b1 = run_state(before), run_state(after)
        steps = b1.steps - b0.steps
        reads = b1.verb_counts[:, isa.READ] - b0.verb_counts[:, isa.READ]
        b, n = b0.head.shape
        changed = int((b1.mem != b0.mem).sum()) + int(
            (b1.msg_buf != b0.msg_buf).sum())
        split = isinstance(before, machine.SharedBatch)
        out["rows"] += b
        out["steps_max"] = max(out["steps_max"], int(steps.max()))
        out["steps_total"] += int(steps.sum())
        out["ms"] += kernel_ms
        out["call_ms"] += ms
        out["timed_by"].append(timed_by)
        out["plain_ms"] += plain_ms
        out["serial_floor_ms"] += interp_floor_ms(
            cycles, split, steps, reads)
        out["bytes"] += 4 * (8 * int(steps.sum()) + changed + 2 * b * 9 * n)
        out["split"].append(split)
    out["bound_ms"] = out["bytes"] / HBM_BYTES_PER_S * 1e3
    return out


def on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def redn_under_sync_check(device, run) -> dict:
    """The captured redn run (a split batch) again, through
    ``machine.run_batch_shared_in_place`` under
    ``torch.cuda.set_sync_debug_mode("warn")``, which warns at each host
    read: the run must make one launch and one host read, the window
    flags' after the launch.  The full copies of the same run, through
    ``machine.run_batch_in_place`` under ``"error"`` (any host read
    raises), must make one launch and none.  Returns the counts."""
    x = copy_batch(run["before"])
    torch.cuda.synchronize()
    before = interp_ops.launches["run_interp"]
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            machine.run_batch_shared_in_place(run["spec"], x,
                                              run["kw"]["max_steps"])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    out = dict(split_launches=interp_ops.launches["run_interp"] - before,
               split_host_reads=sum("synchroniz" in str(w.message).lower()
                                    for w in caught))
    require_states(run_state(x), run_state(run["after"]),
                   "redn under the sync check")
    x = machine._clone(full_batch(run["before"]))
    torch.cuda.synchronize()
    before = interp_ops.launches["run_interp"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        machine.run_batch_in_place(run["spec"], x, run["kw"]["max_steps"])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    out["full_launches"] = interp_ops.launches["run_interp"] - before
    require_states(x, full_batch(run["after"]), "full redn copies")
    return out


def phase_chain_interp(device, kv, dk, dv, n_keys=157286, batch=64,
                       set_rows=(3, 3, 2), server=(65536, 1 << 19, 40000),
                       server_batch=256, guests=512, budget=100,
                       seed=20261018):
    """The interpreter kernel (``chain_interp_kernel``) against its plain
    loop on the card, every run's 14 fields bit-equal, clocks included:
    the hazard corpus (plain, under fault rows, under two-writer
    schedules); a redn GET window of the ``kv_get`` store (S x S x batch
    contexts, one launch, which again passes with any host read inside
    made an error); a (S, 8) SET batch (updates, inserts, displacements:
    the writer and displacer chains); a 4-lane SET of hot keys (the racing
    writers' group, scheduled) and the 2-writer cut sweep as one batch;
    the recycled get server under a storm of all four fault kinds; and
    ADDLEQ guests on the interpreter image.  The redn window runs as a split batch (the shards' tables and
    value rows kept once, each context's private words staged), held to
    the plain loop's run of the full copies; the corpus's window
    machines run split too, and each store that would change a window
    word must raise.  Each timed beside the plain loop and its serial
    floor."""
    dev = torch.device(device)
    images = interp_images()
    on_card = dev.type == "cuda"
    cycles = ({level: chain_ops.chase_cycles(level, device)
               for level in chain_ops.CHASE_LEVELS} if on_card else None)
    result = dict(load_cycles=cycles, cases={})
    s_, n = dk.shape[0], dk.shape[1]
    h, v = kv.neighborhood, dv.shape[2]
    rng = np.random.RandomState(seed)

    def case(name, fn):
        with captured_runs() as runs:
            fn()
        result["cases"][name] = check_interp_runs(device, name, runs,
                                                  cycles)
        return runs

    # the hazard corpus
    spec = convert.spec_from_tuple(images.SPEC)
    corpus = convert.vmstate_from_numpy(images.corpus(seed % 1000), dev)
    b = corpus.mem.shape[0]
    plan = faults.FaultPlan.from_row(torch.from_numpy(
        images.fault_rows(seed % 1000 + 1, b)).to(dev))
    quota = torch.from_numpy(images.quotas(seed % 1000 + 2, b)).to(dev)
    case("corpus", lambda: (
        machine.run_batch(spec, corpus, images.MAX_STEPS),
        machine.run_batch(spec, corpus, 4096),
        machine.run_batch(spec, corpus, images.MAX_STEPS, plan),
        machine.run_scheduled(spec, corpus, machine.Schedule(quota),
                              images.SLICES, images.MAX_STEPS)))

    # the window machines as split batches (two contexts an image), and
    # each store that would change a window word, refused
    def split(machines):
        return machine.split(convert.vmstate_from_numpy(
            images.stack(images.repeat(machines, 2)), dev), images.WINDOW, 2)

    case("window", lambda: [machine.run_batch_shared_in_place(
        spec, split(images.window_machines(i)), steps)
        for i in range(2) for steps in (images.MAX_STEPS, 4096)])
    refused = 0
    for bad in images.window_raisers(seed % 1000):
        try:
            machine.run_batch_shared_in_place(spec, split([bad]), 4096)
        except ValueError as e:
            if "rows [0, 1]" not in str(e):
                raise AssertionError(f"window raise names other rows: {e}")
            refused += 1
    if refused != len(images.window_raisers(0)):
        raise AssertionError(f"{refused} window stores refused, not all")
    result["window_refused"] = refused

    # a redn GET window: one launch for the whole window, a split batch
    q = torch.from_numpy(kv_batches(s_, n_keys, batch, 1)[0]).to(dev)
    runs = case("redn", lambda: store.sharded_get(dk, dv, q, method="redn",
                                                  device=device))
    if len(runs) != 1 or not isinstance(runs[0]["before"],
                                        machine.SharedBatch):
        raise AssertionError(f"a redn batch made {len(runs)} interpreter "
                             f"runs, not one of a split batch")
    red = runs[0]["before"]
    result.update(redn_contexts=int(red.state.mem.shape[0]),
                  redn_private_words=int(red.state.mem.shape[1]),
                  redn_image_words=int(red.base.shape[1]),
                  redn_window=(red.lo, red.hi))
    if red.state.mem.shape[1] >= red.base.shape[1]:
        raise AssertionError("the redn contexts copy their whole image")
    if on_card:
        result["redn_sync_check"] = chk = redn_under_sync_check(device,
                                                               runs[0])
        if chk != dict(split_launches=1, split_host_reads=1,
                       full_launches=1):
            raise AssertionError(f"the redn run is not one launch and one "
                                 f"host read: {chk}")
    del runs, red

    # a (S, 8) SET batch: updates, inserts and displacements
    loaded = np.concatenate([t.keys[t.keys != 0] for t in kv.tables])
    tables = [hopscotch.HopscotchTable(t.keys.copy(), t.values.copy(), h)
              for t in kv.tables]
    n_update, n_insert, n_disp = set_rows
    fresh = int(loaded.max()) + 7000
    disp = displacement_keys(tables, s_, fresh + (1 << 21), s_ * n_disp)
    upd = rng.choice(loaded, s_ * n_update, replace=False)
    rows = []
    for o in range(s_):
        rows.append(rng.permutation(np.concatenate([
            upd[o * n_update:(o + 1) * n_update],
            np.arange(fresh, fresh + n_insert),
            disp[o * n_disp:(o + 1) * n_disp]])))
        fresh += n_insert
    sk = np.stack(rows).astype(np.int32)
    sv = new_values(sk, v)
    # (the SET's stages walk on the walk kernel: the rows route runs their
    # chains here)
    with rows_route():
        case("set", lambda: store.sharded_set(
            dk, dv, torch.from_numpy(sk).to(dev),
            torch.from_numpy(sv).to(dev), device=device))
    result["set_batch"] = tuple(sk.shape)

    # racing writers: a 4-lane SET of hot keys, the 2-writer cut sweep
    hk, _ = hot_keys(kv, rng, sk.shape[1], int(loaded.max()) + 1)
    case("contend", lambda: store.sharded_set(
        dk, dv, torch.from_numpy(hk).to(dev),
        torch.from_numpy(new_values(hk, v)).to(dev), n_writers=4,
        device=device))
    case("cut_sweep", lambda: cut_sweep(device))

    # the recycled get server under a storm of all four fault kinds
    srv = recycled_server(device, *server)
    keys = mixed_keys(server_batch, range(1, server[2] + 1,
                                          max(1, server[2] // server_batch)))
    pay = np.asarray([srv._payload(k) for k in keys], np.int32)
    storm = faults.storm(len(keys), p_fault=0.5, max_step=64, seed=seed,
                         device=device)
    case("faults", lambda: ChainEngine(srv.spec).run_many(
        srv.state, srv.loop_wq, pay, 64, storm))
    result["faults_armed"] = int(storm.active().sum())
    del srv

    # ADDLEQ guests on the interpreter image
    interp = turing.build_interpreter(device=device)
    host = dataclasses.replace(interp, state0=machine.VMState(
        *(a.cpu() for a in interp.state0)))
    states = [host.load(g) for g in addleq_guests(interp, guests, seed)]
    gb = machine.VMState(*(torch.stack(f).to(dev) for f in zip(*states)))
    del states
    case("guests", lambda: ChainEngine(interp.spec).run_batch(
        gb, interp.lap_words * (budget + 2)))
    del gb

    # the row of the KERNELS table: the redn window, the paper's path
    r = result["cases"]["redn"]
    result.update(max_abs_err=max(c["max_abs_err"]
                                  for c in result["cases"].values()),
                  ms=r["ms"], plain_ms=r["plain_ms"],
                  bound_ms=r["bound_ms"], bound_by="bytes",
                  serial_floor_ms=r["serial_floor_ms"], library_ms=None,
                  shape=(result["redn_contexts"], int(dk.shape[1])))
    return result


# ---------------------------------------------------------------------------
# phase 4: the straight-line chain kernel
# ---------------------------------------------------------------------------

STRAIGHT_OPS = (isa.NOOP, isa.WRITE, isa.WRITE_IMM, isa.READ, isa.CAS,
                isa.ADD, isa.MAX, isa.MIN, isa.HALT, isa.SEND, isa.WAIT, 13)


def random_straight_programs(n: int, mem_words: int, n_wrs: int, seed: int):
    """n images of one WQ of n_wrs random WRs at address 0, over random data;
    fields stray past both ends of the image to exercise the index rules."""
    rng = np.random.RandomState(seed)
    mems = rng.randint(-64, 64, size=(n, mem_words)).astype(np.int64)
    ops = rng.choice(STRAIGHT_OPS, size=(n, n_wrs))
    wr = mems[:, :n_wrs * isa.WR_WORDS].reshape(n, n_wrs, isa.WR_WORDS)
    wr[..., isa.F_CTRL] = (ops << isa.ID_BITS) | rng.randint(0, 8, (n, n_wrs))
    lo, hi = -24, mem_words + 24
    wr[..., isa.F_SRC] = rng.randint(lo, hi, (n, n_wrs))
    wr[..., isa.F_DST] = np.where(rng.rand(n, n_wrs) < 0.7,
                                  rng.randint(n_wrs * isa.WR_WORDS, hi,
                                              (n, n_wrs)),
                                  rng.randint(lo, hi, (n, n_wrs)))
    wr[..., isa.F_LEN] = rng.randint(-2, isa.MAX_COPY + 3, (n, n_wrs))
    mems[:, :n_wrs * isa.WR_WORDS] = wr.reshape(n, -1)
    return mems.astype(np.int32)


def phase_chain_straight(device, n=1024, mem_words=4096, n_wrs=16,
                         max_steps=24, time_it=True):
    mems = torch.from_numpy(
        random_straight_programs(n, mem_words, n_wrs, seed=7)).to(device)
    reset_launches()
    out = chain_ops.run_chains(mems, wq_base=0, n_wrs=n_wrs,
                               max_steps=max_steps)
    launches = read_launches()["run_chains"]
    plain, _ = chain_ref.run_chain_reference(mems, 0, n_wrs, max_steps)
    err = require_equal(out, plain, "run_chains")
    changed = int((out != mems).any(dim=1).sum())
    result = dict(launches=launches, max_abs_err=err, changed=changed,
                  shape=tuple(mems.shape),
                  bound_ms=2 * mems.numel() * 4 / HBM_BYTES_PER_S * 1e3)
    if time_it:
        # device time: CUDA events around a call this short time the host
        kw = dict(wq_base=0, n_wrs=n_wrs, max_steps=max_steps)
        result["ms"] = device_time(lambda: chain_ops.run_chains(mems, **kw),
                                   20)["device_ms"]
        result["plain_ms"] = device_time(
            lambda: chain_ref.run_chain_reference(mems, 0, n_wrs, max_steps),
            2)["device_ms"]
    return result


# ---------------------------------------------------------------------------
# phase 5: the hopscotch kernel
# ---------------------------------------------------------------------------

def probe_queries(kv, shard: int, n_queries: int, n_keys: int, seed: int):
    """Queries for one shard's table: stored keys, keys whose neighborhood
    wraps the table end, misses owned by the shard, and key 0."""
    rng = np.random.RandomState(seed + shard)
    t = kv.tables[shard]
    n, h = t.n_buckets, t.neighborhood
    stored = t.keys[t.keys != 0]
    homes = hopscotch.bucket_of(stored, n)
    wrap = stored[homes > n - h]
    cand = np.arange(n_keys + 1, n_keys + 1 + 64 * n_queries)
    misses = cand[store.shard_of(cand, kv.n_shards) == shard]
    n_wrap = min(len(wrap), n_queries // 8)
    n_miss = n_queries // 4
    q = np.concatenate([
        wrap[:n_wrap], misses[:n_miss], [0] * 4,
        rng.choice(stored, n_queries - n_wrap - n_miss - 4)])
    return rng.permutation(q).astype(np.int32), n_wrap


def probe_bytes(found, slot_probes, val_words: int) -> float:
    """Least bytes the probe must move for this data: each query read, its
    probed keys up to the first hit, a value row per hit, and found plus a
    row written."""
    b = found.numel()
    return 4.0 * (b + int(slot_probes.sum()) + int(found.sum()) * val_words
                  + b * val_words) + b


# The probe's cases beyond the store's own (H 8, V 4) on shard 0's table:
# (neighborhood, value words); a neighborhood of 16 or 32 fills a group of
# 16 lanes or a whole warp, one value word leaves all but one lane of a
# group without a word to copy.
PROBE_CASES = ((16, 4), (32, 4), (8, 1))


def phase_hopscotch_probe(device, kv, dk, dv, n_queries=4096, n_keys=157286,
                          redn_chunk=64, time_it=True):
    qs = [probe_queries(kv, s, n_queries, n_keys, seed=11)
          for s in range(kv.n_shards)]
    q_dev = [torch.from_numpy(q).to(device) for q, _ in qs]
    reset_launches()
    outs = [hop_ops.hopscotch_lookup(dk[s], dv[s], q_dev[s], kv.neighborhood)
            for s in range(kv.n_shards)]
    launches = read_launches()["hopscotch_lookup"]
    err, hits = 0, 0
    for s, (f, v) in enumerate(outs):
        pf, pv = hopscotch.lookup(dk[s], dv[s], q_dev[s], kv.neighborhood)
        require_equal(f, pf, f"shard {s} found")
        err = max(err, require_equal(v, pv, f"shard {s} values"))
        hits += int(f.sum())
    case_hits = {}
    for h, v in PROBE_CASES:
        vals = dv[0][:, :v].contiguous()
        f, got = hop_ops.hopscotch_lookup(dk[0], vals, q_dev[0], h)
        pf, pv = hopscotch.lookup(dk[0], vals, q_dev[0], h)
        require_equal(f, pf, f"H {h}, V {v} found")
        err = max(err, require_equal(got, pv, f"H {h}, V {v} values"))
        case_hits[f"H{h}/V{v}"] = int(f.sum())
    # the same queries through the redn path: row s of each call carries
    # shard s's queries (each owned by s, except key 0, a miss everywhere)
    for lo in range(0, n_queries, redn_chunk):
        q = torch.stack([qd[lo:lo + redn_chunk] for qd in q_dev])
        res = store.sharded_get(dk, dv, q, method="redn", device=device)
        for s, (f, v) in enumerate(outs):
            require_equal(res.found[s], f[lo:lo + redn_chunk],
                          f"redn vs kernel found, shard {s}")
            require_equal(res.values[s], v[lo:lo + redn_chunk],
                          f"redn vs kernel values, shard {s}")
    # bytes this data needs (shard 0's table and queries)
    n, h = dk.shape[1], kv.neighborhood
    q0 = q_dev[0]
    home = hopscotch.bucket_of(q0, n)
    idx = torch.remainder(home[:, None] + torch.arange(h, device=device), n)
    hit = dk[0][idx.long()] == q0[:, None]
    first = torch.argmax(hit.int(), dim=1) + 1
    probes = torch.where(hit.any(dim=1), first, h) * (q0 != 0)
    result = dict(launches=launches, max_abs_err=err, hits=hits,
                  case_hits=case_hits, wrap_queries=[w for _, w in qs],
                  shape=(n, n_queries),
                  bound_ms=probe_bytes(outs[0][0], probes, dv.shape[2])
                  / HBM_BYTES_PER_S * 1e3)
    if time_it:
        # device time: CUDA events around a ~20 us call time the host
        args = (dk[0], dv[0], q0, h)
        result["ms"] = device_time(lambda: hop_ops.hopscotch_lookup(*args),
                                   50)["device_ms"]
        result["plain_ms"] = device_time(lambda: hopscotch.lookup(*args),
                                         20)["device_ms"]
        result["event_ms"] = cuda_ms(lambda: hop_ops.hopscotch_lookup(*args),
                                     reps=20)
    return result


# ---------------------------------------------------------------------------
# phase 6: the write path (SET with displacement, DELETE, TTL, the sweeper)
# ---------------------------------------------------------------------------

def run_traced(device, fn):
    """``(fn(), ms, stages)`` with the transport's stateful-stage trace on:
    per stage its ms (CUDA events; None on the CPU), serial depth (window
    positions or laps run), requests run, and chain steps per request (max
    and median; None for a group stage)."""
    transport.trace = []
    try:
        value, ms = timed_call(device, fn)
        records = transport.trace
    finally:
        transport.trace = None
    stages = {}
    for r in records:
        # a group stage (racing lanes) records no per-request steps
        steps = torch.cat(r["steps"]).cpu().numpy() if r["steps"] else None
        stages[r["stage"]] = dict(
            ms=r["start"].elapsed_time(r["end"]) if "start" in r else None,
            depth=r["depth"], runs=r["runs"],
            steps_max=None if steps is None else int(steps.max()),
            steps_median=None if steps is None else float(np.median(steps)))
    return value, ms, stages


# launches made to compare: the rows route's interpreter launches (the
# walk's yardstick) and the walk kernel's replays against its plain
# version; no path's
YARDSTICK = {"run_interp": 0, "walk": 0}
# the walk kernel's ptxas instances (one warp, several)
WALK_KERNEL = "chain_walk_kernel"


@contextlib.contextmanager
def rows_route():
    """The single-chain write stages on the earlier route inside the block
    (``transport.rows_stage``: ``_walk`` over the program's ``run_rows``,
    an interpreter launch a window position), the walk's yardstick,
    called by this script: the package has no switch for it.  Its
    interpreter launches count in ``YARDSTICK``, not in a path's."""
    walk = transport.walk_stage
    before = interp_ops.launches["run_interp"]
    transport.walk_stage = transport.rows_stage
    try:
        yield
    finally:
        transport.walk_stage = walk
        YARDSTICK["run_interp"] += interp_ops.launches["run_interp"] - before


@contextlib.contextmanager
def walk_records():
    """The transport's trace of the block: a record a stateful stage, a
    walked stage's with its arguments and output (copies)."""
    prev = transport.trace
    transport.trace = []
    try:
        yield transport.trace
    finally:
        transport.trace = prev


def recorded(records: list, fn):
    """``fn()`` with the transport's trace on, its records added to
    ``records``."""
    with walk_records() as recs:
        value = fn()
    records.extend(recs)
    return value


def host_ms(device, fn):
    """``(fn(), ms)`` by host clock, the card synchronised before and
    after."""
    sync(device)
    t0 = time.perf_counter()
    value = fn()
    sync(device)
    return value, (time.perf_counter() - t0) * 1e3


def require_same(a, b, what: str) -> None:
    """Raise unless two results (tensors, arrays, scalars and tuples of
    them, named or not) are equal, integers bit for bit."""
    if isinstance(a, (torch.Tensor, np.ndarray)):
        require_equal(a, b, what)
    elif isinstance(a, (tuple, list)):
        if len(a) != len(b):
            raise AssertionError(f"{what}: {len(a)} vs {len(b)} parts")
        for name, x, y in zip(getattr(a, "_fields", range(len(a))), a, b):
            require_same(x, y, f"{what}.{name}")
    elif a != b:
        raise AssertionError(f"{what}: {a} vs {b}")


def require_walked(device, what: str, records) -> list:
    """Every walked stage of ``records`` again on the rows route from its
    recorded arguments: responses, steps per request and carry bit-equal
    to ``_walk``'s; on the card each stage one ``chain_walk_kernel``
    launch and no interpreter launch.  Returns a dict a stage: depth,
    runs, steps, and the walk's and the rows route's ms (CUDA events,
    None on the CPU)."""
    walked = [r for r in records if "args" in r]
    if not walked:
        raise AssertionError(f"{what}: no stage walked")
    want = {"run_interp": 0, "walk": 1 if on_card(device) else 0}
    out = []
    for r in walked:
        stage = r["stage"]
        if r["launches"] != want:
            raise AssertionError(f"{what} {stage}: launches {r['launches']}"
                                 f", not {want}")
        before = interp_ops.launches["run_interp"]
        with walk_records() as yard:
            transport.rows_stage(*r["args"])
        YARDSTICK["run_interp"] += interp_ops.launches["run_interp"] - before
        y = yard[-1]
        for name, a, b in zip(("responses", "steps"), r["out"], y["out"]):
            require_equal(a, b, f"{what} {stage}: {name} vs _walk")
        for i, (a, b) in enumerate(zip(r["out"][2], y["out"][2])):
            require_equal(a, b, f"{what} {stage}: carry[{i}] vs _walk")
        sync(device)
        steps = r["out"][1]
        out.append(dict(
            stage=stage, depth=r["depth"], runs=r["runs"],
            steps_max=int(steps.max()),
            steps_median=float(np.median(steps[steps > 0].cpu().numpy()))
            if bool((steps > 0).any()) else 0.0,
            ms=r["start"].elapsed_time(r["end"]) if "start" in r else None,
            rows_ms=y["start"].elapsed_time(y["end"]) if "start" in y
            else None))
    return out


def walk_vs_rows(device, what: str, fn):
    """``fn()`` (store calls whose single-chain stages walk) from the same
    inputs three times: traced, each walked stage then held to the rows
    route (``require_walked``); untraced, by host clock; and on the rows
    route by host clock, its whole result equal to the walk's.  Returns
    ``(the traced run's value, dict(ms, rows_ms, stages, records))``."""
    with walk_records() as recs:
        value = fn()
    stages = require_walked(device, what, recs)
    _, ms = host_ms(device, fn)
    with rows_route():
        rows_value, rows_ms = host_ms(device, fn)
    require_same(value, rows_value, f"{what}: the walk vs _walk")
    return value, dict(ms=ms, rows_ms=rows_ms, stages=stages,
                       records=[r for r in recs if "args" in r])


def stage_summary(stages) -> dict:
    """``require_walked``'s stages by name (a repeated name: the last),
    as ``run_traced`` reports them."""
    return {st["stage"]: {k: st[k] for k in ("ms", "rows_ms", "depth",
                                             "runs", "steps_max",
                                             "steps_median")}
            for st in stages}


def walk_profile(device, fn, kernels) -> dict:
    """A call of ``fn`` on the card by host clock, then one traced: the
    device ms of the traced call, its named kernels' ms, and the
    device's idle share of the call (1 - device ms / the untraced call's
    ms, as the training drives take it); all None off the card or when
    the trace holds no device time."""
    none = dict(wall_ms=None, device_ms=None, idle_share=None,
                by_kernel_ms={k: None for k in kernels})
    if not on_card(device):
        return none
    fn()
    _, wall_ms = host_ms(device, fn)
    for _ in range(3):
        prof = device_profile(fn, 1, kernels)
        if prof["device_ms"] > 0:
            return dict(wall_ms=wall_ms, device_ms=prof["device_ms"],
                        idle_share=1.0 - prof["device_ms"] / wall_ms,
                        by_kernel_ms=prof["by_kernel_ms"])
    return none


def walk_floor_ms(cycles, steps) -> dict:
    """The walk's serial floor at the card's maximum SM clock, a step
    ``INTERP_STEP_TRIPS`` dependent L2 trips: an owner's positions in
    order (the most steps any owner's window sums), and beside it the
    lockstep sum (each position's most steps, summed over positions, the
    depth the earlier route ran owners in).  0 off the card."""
    if cycles is None:
        return dict(owner=0.0, lockstep=0.0)
    per = cycles["l2"] * INTERP_STEP_TRIPS / max_sm_clock_hz() * 1e3
    return dict(owner=float(steps.sum(1).max()) * per,
                lockstep=float(steps.max(0).values.sum()) * per)


def walk_kernel_row(device, records, cycles) -> dict:
    """The walk kernel on the stages of ``records`` (a batch's), each
    replayed from its recorded arguments: the kernel's device time from a
    trace (the sum over the stages, one launch each), the plain version
    (``ref.plain_walk``, on the card) by host clock and bit-equal, the
    serial floor and the bytes bound: each executed WR's 8 words, each
    run row's window and fault words, its 9 counters a WQ restored and
    its response and steps written, and each changed carry word of the
    image and its shadow.  The plain version's steps agree by
    construction."""
    out = dict(ms=0.0, plain_ms=0.0, max_abs_err=0, bytes=0,
               serial_floor_ms=0.0, lockstep_floor_ms=0.0, timed_by=[],
               stages=[r["stage"] for r in records])
    before = interp_ops.launches["walk"]
    for r in records:
        prog, budget, carry, rows, frows, resp_words, _ = r["args"]

        def run(prog=prog, carry=carry, rows=rows, budget=budget,
                frows=frows, resp_words=resp_words):
            return interp_ops.run_walk(prog, carry, rows, budget, frows,
                                       resp_words)

        got = run()
        plain, plain_ms = host_ms(device, lambda: walk_ref.plain_walk(
            prog, carry, rows, budget, frows, resp_words))
        for i, (a, b) in enumerate(zip(got[:2] + got[2],
                                       plain[:2] + plain[2])):
            out["max_abs_err"] = max(out["max_abs_err"], require_equal(
                a, b, f"walk kernel vs plain walk {r['stage']} [{i}]"))
        ms, timed_by = plain_ms, "plain"
        if on_card(device):
            prof = device_time(run, 2, (WALK_KERNEL,))
            timed_by = prof["timed_by"]
            ms = (prof["by_kernel_ms"][WALK_KERNEL] if timed_by == "trace"
                  else prof["device_ms"])
        steps = r["out"][1]
        runs = int((rows[..., 0] != 0).sum())
        changed = sum(int((a != b).sum()) for a, b in zip(r["out"][2],
                                                          carry))
        width = rows.shape[-1] + (0 if frows is None else frows.shape[-1])
        out["bytes"] += 4 * (8 * int(steps.sum()) + runs * (
            width + 9 * prog.spec.num_wqs + resp_words + 1) + 2 * changed)
        floor = walk_floor_ms(cycles, steps)
        out["ms"] += ms
        out["plain_ms"] += plain_ms
        out["timed_by"].append(timed_by)
        out["serial_floor_ms"] += floor["owner"]
        out["lockstep_floor_ms"] += floor["lockstep"]
    YARDSTICK["walk"] += interp_ops.launches["walk"] - before
    out["bytes_bound_ms"] = out["bytes"] / HBM_BYTES_PER_S * 1e3
    out.update(bound_ms=out["bytes_bound_ms"], bound_by="bytes",
               library_ms=None)
    return out


def window_oracle(tables, keys, live, fn, values=None):
    """A batch applied to the host tables the way the store serializes it:
    per owner shard, its live rows in window order (source-major, then
    batch order), through ``fn(table, keys[, values])``.  Returns the
    statuses (0 for rows not run)."""
    owner = store.shard_of(keys, len(tables))
    status = np.zeros(keys.shape, np.int32)
    for o, t in enumerate(tables):
        rows = [(s, b) for s in range(keys.shape[0])
                for b in range(keys.shape[1])
                if owner[s, b] == o and live[s, b] and keys[s, b] != 0]
        if not rows:
            continue
        args = [[values[r] for r in rows]] if values is not None else []
        for r, x in zip(rows, fn(t, [keys[r] for r in rows], *args)):
            status[r] = x
    return status


def require_tables(what: str, tables, keys, vals, exp=None, exps=None):
    require_equal(keys, np.stack([t.keys for t in tables]), f"{what} keys")
    require_equal(vals, np.stack([t.values for t in tables]), f"{what} vals")
    if exp is not None:
        require_equal(exp, np.stack(exps), f"{what} exp")


def require_mutation(what: str, res, want, keys, live, terminal):
    """A SetResult/DeleteResult against its oracle statuses: ok exactly
    on the live rows, status, applied on the terminal statuses, no drop,
    the dead rows deferred (key-0 slots neither)."""
    real = keys != 0
    require_equal(res.ok, live & real, f"{what} ok")
    require_equal(res.status, want, f"{what} status")
    require_equal(res.applied, np.isin(want, terminal), f"{what} applied")
    require_equal(res.dropped, np.zeros(len(keys), np.int32),
                  f"{what} dropped")
    require_equal(res.deferred, (~live & real).sum(1).astype(np.int32),
                  f"{what} deferred")


def exp_oracle(before, exps, after, keys, deadlines, applied):
    """The deadline column after a SET, from its meaning: a key keeps the
    deadline it had on its shard, an applied request stamps its own (the
    last in source-major order wins), an empty bucket has none."""
    stamped = {}
    for k, d, a in zip(keys.reshape(-1).tolist(),
                       deadlines.reshape(-1).tolist(),
                       applied.reshape(-1).tolist()):
        if a and k != 0:
            stamped[k] = d
    out = []
    for t0, e0, t1 in zip(before, exps, after):
        had = {int(k): int(e) for k, e in zip(t0.keys, e0) if k != 0}
        out.append(np.asarray(
            [hopscotch.NO_TTL if k == 0 else stamped.get(
                int(k), had.get(int(k), hopscotch.NO_TTL))
             for k in t1.keys.tolist()], np.int32))
    return out


def ttl_reference(tables, exps, queries, now):
    """Host oracle of the TTL get: each query through ``lookup_ttl`` on its
    owner's table and deadline column."""
    q = queries.reshape(-1)
    owner = store.shard_of(q, len(tables))
    found = np.zeros(len(q), bool)
    vals = np.zeros((len(q), tables[0].values.shape[1]), np.int32)
    for o, t in enumerate(tables):
        sel = np.flatnonzero(owner == o)
        f, v = hopscotch.lookup_ttl(
            torch.from_numpy(t.keys), torch.from_numpy(t.values),
            torch.from_numpy(exps[o]), torch.from_numpy(q[sel]), now,
            t.neighborhood)
        found[sel], vals[sel] = f.numpy(), v.numpy()
    return found, vals


def displacement_keys(tables, n_shards: int, start: int, count: int):
    """New keys whose home neighborhood on their owner is full in the host
    table and which the bounded host oracle places by displacement."""
    n, h = tables[0].n_buckets, tables[0].neighborhood
    full = [np.all(np.stack([np.roll(t.keys != 0, -d) for d in range(h)]),
                   axis=0) for t in tables]
    out = []
    while len(out) < count:
        if start > 0xFFFFFF:
            raise RuntimeError(f"found {len(out)}/{count} displacement keys")
        cand = np.arange(start, start + (1 << 16), dtype=np.int64)
        start += 1 << 16
        own = store.shard_of(cand, n_shards)
        home = hopscotch.bucket_of(cand, n)
        for k in cand[[full[o][b] for o, b in zip(own, home)]].tolist():
            t = tables[int(store.shard_of(k, n_shards))]
            scratch = hopscotch.HopscotchTable(t.keys.copy(),
                                               t.values.copy(), h)
            if scratch.set_full(k, [1] * t.values.shape[1]) == \
                    hopscotch.SET_DISPLACED:
                out.append(k)
                if len(out) == count:
                    break
    return out


def keys_homed_in(n_shards: int, n: int, shard: int, lo: int, span: int,
                  start: int, count: int):
    """``count`` keys from ``start`` up owned by ``shard`` whose home bucket
    lies in ``[lo, lo + span)``."""
    out = []
    while len(out) < count:
        if start > 0xFFFFFF:
            raise RuntimeError("ran out of 24-bit keys")
        cand = np.arange(start, start + (1 << 20), dtype=np.int64)
        start += 1 << 20
        home = hopscotch.bucket_of(cand, n)
        sel = ((store.shard_of(cand, n_shards) == shard) & (home >= lo)
               & (home < lo + span))
        out.extend(cand[sel][:count - len(out)].tolist())
    return out


def new_values(keys, v: int):
    """The values a write stores: distinct from the load's [k, 2k, ...]."""
    k = np.asarray(keys, np.int64)
    return (np.stack([k ^ 0x5A5A5, 7 * k + 1, 3 * k + 2, k % 1009],
                     axis=-1)[..., :v] & 0x7FFFFFFF).astype(np.int32)


SET_TERMINAL = (hopscotch.SET_UPDATED, hopscotch.SET_INSERTED,
                hopscotch.SET_DISPLACED)


def phase_kv_write(device, kv, dk, dv, n_update=12, n_insert=12, n_disp=4,
                   n_delete=(6, 6, 4), n_ttl=4, ttl_span=16, seed=7,
                   time_it=True):
    """The store's write path on the ``kv_get`` store, against host copies
    of its tables: a SET batch (per source row ``n_update`` updates,
    ``n_insert`` inserts, ``n_disp`` keys whose neighborhood is full, a
    later duplicate of an insert, key 0 and two dead rows, one holding a
    sentinel key), a DELETE batch (set keys, loaded keys and misses per
    row), a TTL SET into a window of ``ttl_span`` home buckets per shard,
    TTL gets before and after the deadlines, and a CLOCK sweep over the
    window; every result and array is held bit for bit to the host
    oracles applied per owner in window order, and the touched keys are
    read back through all three get paths."""
    rng = np.random.RandomState(seed)
    s_, n = dk.shape[0], dk.shape[1]
    h, v = kv.neighborhood, dv.shape[2]
    loaded = np.concatenate([t.keys[t.keys != 0] for t in kv.tables])
    tables = [hopscotch.HopscotchTable(t.keys.copy(), t.values.copy(), h)
              for t in kv.tables]
    host = store.ShardedKV(tables, s_, v, h)
    if time_it:
        torch.cuda.reset_peak_memory_stats()

    def dev(a):
        return torch.from_numpy(np.asarray(a)).to(device)

    # --- SET -----------------------------------------------------------------
    fresh = int(loaded.max()) + 1000
    disp = displacement_keys(tables, s_, fresh + (1 << 20), s_ * n_disp)
    rows, live, inserted = [], [], []
    for s in range(s_):
        upd = rng.choice(loaded, n_update, replace=False)
        ins = np.arange(fresh, fresh + n_insert)
        body = rng.permutation(np.concatenate(
            [upd, ins, disp[s * n_disp:(s + 1) * n_disp]]))
        rows.append(np.concatenate([body, [ins[0], 0, fresh + n_insert,
                                           -1]]))
        live.append([True] * (len(body) + 2) + [False, False])
        inserted.append(ins)
        fresh += n_insert + 1
    sk, live = np.stack(rows).astype(np.int32), np.asarray(live)
    sv = new_values(sk, v)

    def set_batch():
        return store.sharded_set(dk, dv, dev(sk), dev(sv), live=dev(live),
                                 device=device)

    (res, wk, wv), set_walk = walk_vs_rows(device, "set", set_batch)
    set_ms, set_stages = set_walk["ms"], stage_summary(set_walk["stages"])
    want = window_oracle(tables, sk, live, hopscotch.insert_many_displaced,
                         sv)
    require_mutation("set", res, want, sk, live, SET_TERMINAL)
    require_tables("set", tables, wk, wv)
    statuses = {hopscotch.status_name(c): int((want == c).sum())
                for c in np.unique(want[want > 0])}
    if statuses.get("SET_DISPLACED", 0) < 1:
        raise AssertionError(f"no SET_DISPLACED row: {statuses}")
    n_sets = int((live & (sk != 0)).sum())
    result = dict(shards=s_, buckets_per_shard=n, set_batch=sk.shape,
                  set_statuses=statuses, set_ms=set_ms,
                  set_rows_ms=set_walk["rows_ms"],
                  sets_per_s=n_sets / (set_ms * 1e-3), set_stages=set_stages)
    # the walk kernel beside _walk's interpreter launches on the same
    # batch, by device time from a trace; the device's idle share
    walk_prof = walk_profile(device, set_batch, (WALK_KERNEL,))
    with rows_route():
        rows_prof = walk_profile(device, set_batch, ("chain_interp_kernel",))
    cycles = ({level: chain_ops.chase_cycles(level, device)
               for level in chain_ops.CHASE_LEVELS} if on_card(device)
              else None)
    result.update(
        set_walk_kernel_ms=walk_prof["by_kernel_ms"][WALK_KERNEL],
        set_rows_interp_ms=rows_prof["by_kernel_ms"]["chain_interp_kernel"],
        set_device_ms=walk_prof["device_ms"],
        set_rows_device_ms=rows_prof["device_ms"],
        set_untraced_ms=walk_prof["wall_ms"],
        set_rows_untraced_ms=rows_prof["wall_ms"],
        set_idle_share=walk_prof["idle_share"],
        set_rows_idle_share=rows_prof["idle_share"],
        walk_kernel=dict(walk_kernel_row(device, set_walk["records"],
                                         cycles), shape=tuple(sk.shape)))

    # --- DELETE: keys this batch set, loaded keys, misses --------------------
    n_set, n_old, n_miss = n_delete
    dk_rows = np.stack([np.concatenate([
        rng.choice(inserted[s], n_set, replace=False),
        rng.choice(loaded, n_old, replace=False),
        fresh + s * n_miss + np.arange(n_miss)]) for s in range(s_)])
    dk_rows = np.stack([rng.permutation(r) for r in dk_rows]).astype(
        np.int32)
    fresh += s_ * n_miss
    d_live = np.ones(dk_rows.shape, bool)
    (dres, wk, wv), del_walk = walk_vs_rows(
        device, "delete", lambda: store.sharded_delete(wk, wv, dev(dk_rows),
                                                       device=device))
    del_ms, del_stages = del_walk["ms"], stage_summary(del_walk["stages"])
    want = window_oracle(tables, dk_rows, d_live, hopscotch.delete_many)
    require_mutation("delete", dres, want, dk_rows, d_live,
                     (hopscotch.DEL_DELETED,))
    require_tables("delete", tables, wk, wv)
    result.update(
        delete_deleted=int((want == hopscotch.DEL_DELETED).sum()),
        delete_ms=del_ms, delete_rows_ms=del_walk["rows_ms"],
        delete_stages=del_stages)

    # --- TTL SET: per shard, new keys homed in a window plus a loaded key
    # in it; half the deadlines lapse between the two clocks
    lo = min(1000, n // 4)
    now_before, now_after = 300, 1000
    exps = [np.full(n, hopscotch.NO_TTL, np.int32) for _ in range(s_)]
    ttl_rows = []
    for s in range(s_):
        new = keys_homed_in(s_, n, s, lo, ttl_span, fresh, n_ttl)
        fresh = max(new) + 1
        old = [int(k) for k in tables[s].keys[lo:lo + ttl_span] if k][:1]
        ttl_rows.append(np.asarray((new + old + [0])[:n_ttl + 1]))
    tk = np.stack(ttl_rows).astype(np.int32)
    deadlines = np.where(np.arange(tk.shape[1]) % 2 == 0, 600, 5000)
    deadlines = np.broadcast_to(deadlines, tk.shape).astype(np.int32)
    tv = new_values(tk + 3, v)
    t_live = np.ones(tk.shape, bool)
    before = [hopscotch.HopscotchTable(t.keys.copy(), t.values.copy(), h)
              for t in tables]
    recs = []
    (tres, wk, wv, we), ttl_ms = recorded(recs, lambda: timed_call(
        device, lambda: store.sharded_set(
            wk, wv, dev(tk), dev(tv), exp=dev(np.stack(exps)),
            deadlines=dev(deadlines), device=device)))
    result["ttl_set_stages"] = stage_summary(require_walked(
        device, "ttl set", recs))
    want = window_oracle(tables, tk, t_live, hopscotch.insert_many_displaced,
                         tv)
    require_mutation("ttl set", tres, want, tk, t_live, SET_TERMINAL)
    exps = exp_oracle(before, exps, tables, tk, deadlines,
                      np.isin(want, SET_TERMINAL))
    require_tables("ttl set", tables, wk, wv, we, exps)
    result["ttl_set_ms"] = ttl_ms

    # --- TTL gets before and after the deadlines -----------------------------
    mixed = np.concatenate([tk, sk[:, :8], dk_rows[:, :4]], axis=1)
    mixed = np.where(mixed < 0, 0, mixed).astype(np.int32)
    ttl_hits = {}
    for now in (now_before, now_after):
        g = store.sharded_get(wk, wv, dev(mixed), exp=we, now=now,
                              device=device)
        rf, rv = ttl_reference(tables, exps, mixed, now)
        require_equal(g.found.reshape(-1), rf, f"ttl get found now={now}")
        require_equal(g.values.reshape(-1, v), rv,
                      f"ttl get values now={now}")
        ttl_hits[now] = int(rf.sum())
    if not ttl_hits[now_before] > ttl_hits[now_after]:
        raise AssertionError(f"no deadline lapsed: {ttl_hits}")
    result["ttl_get_hits"] = ttl_hits

    # --- the CLOCK sweep over the window -------------------------------------
    count = ttl_span + 2 * h
    hand = np.full(s_, lo, np.int32)
    (rep, wk, wv, we), sweep_walk = walk_vs_rows(
        device, "sweep", lambda: store.sharded_sweep(
            wk, wv, we, dev(hand), now_after, count, device=device))
    sweep_ms = sweep_walk["ms"]
    sweep_stages = stage_summary(sweep_walk["stages"])
    for s, t in enumerate(tables):
        st, exps[s] = hopscotch.sweep_expired(t, exps[s], now_after, lo,
                                              count)
        require_equal(rep.status[s], st, f"sweep status shard {s}")
    require_equal(rep.reclaimed, (rep.status == hopscotch.SWEEP_RECLAIMED)
                  .sum(1), "sweep reclaimed")
    require_equal(rep.hand, (hand + count) % n, "sweep hand")
    require_tables("sweep", tables, wk, wv, we, exps)
    reclaimed = int(rep.reclaimed.sum())
    if reclaimed < 1:
        raise AssertionError("the sweeper reclaimed no bucket")
    result.update(sweep_count=count, sweep_reclaimed=reclaimed,
                  sweep_ms=sweep_ms, sweep_rows_ms=sweep_walk["rows_ms"],
                  sweep_stages=sweep_stages)

    # --- every get path reads the touched keys back --------------------------
    rf, rv = store.reference_get(host, mixed)
    for method in ("redn", "one_sided", "two_sided"):
        g = store.sharded_get(wk, wv, dev(mixed), method=method,
                              device=device)
        require_equal(g.found.reshape(-1), rf, f"{method} found")
        require_equal(g.values.reshape(-1, v), rv, f"{method} values")
    g = store.sharded_get(wk, wv, dev(mixed), exp=we, now=now_after,
                          device=device)
    tf, tv_ = ttl_reference(tables, exps, mixed, now_after)
    require_equal(g.found.reshape(-1), tf, "redn ttl found after sweep")
    require_equal(g.values.reshape(-1, v), tv_, "redn ttl values after sweep")
    result["readback_hits"] = int(rf.sum())
    if time_it:
        result["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    return result


# ---------------------------------------------------------------------------
# phase 6b: the recovery drill at the real store size
# ---------------------------------------------------------------------------

# report order of the kinds within one bucket (fsck's)
_TEAR_RANK = {"stale-row": 0, "torn-vacate": 1, "torn-claim": 2,
              "neighborhood": 3, "dup-key": 4}


def plant_tears(keys, vals, h: int):
    """A copy of a clean store with one tear of each steady-state kind
    planted at a known bucket: a torn claim and a neighborhood breach (a
    live key moved H buckets past its home) on shard 0, a half-done move
    (a live key copied into an EMPTY bucket later in its neighborhood) on
    shard 1, a stale row on shard 2 and a torn vacate (in the deadline
    column) on shard 3 (shard numbers modulo S).  Returns ``(keys, vals,
    exp, expected [(kind, shard, bucket, key)] in report order)``."""
    k, v = keys.copy(), vals.copy()
    s_, n = k.shape
    exp = np.full(k.shape, hopscotch.NO_TTL, np.int32)
    want = []
    live0 = np.flatnonzero(k[0] != 0)
    b = int(live0[0])
    want.append(("torn-claim", 0, b, int(k[0, b])))
    v[0, b] = 0
    for src in live0[1:].tolist():
        key = int(k[0, src])
        dst = int(hopscotch.bucket_of(key, n)) + h
        if src < dst < n and k[0, dst] == 0:
            break
    k[0, dst], v[0, dst] = key, v[0, src]
    k[0, src], v[0, src] = 0, 0
    want.append(("neighborhood", 0, dst, key))
    sh = 1 % s_
    for src in np.flatnonzero(k[sh] != 0).tolist():
        key = int(k[sh, src])
        home = int(hopscotch.bucket_of(key, n))
        cand = [b for b in range(src + 1, min(home + h, n)) if k[sh, b] == 0]
        if cand:
            break
    k[sh, cand[0]], v[sh, cand[0]] = key, v[sh, src]
    want.append(("dup-key", sh, cand[0], key))
    sh = 2 % s_
    b = int(np.flatnonzero(k[sh] == 0)[0])
    v[sh, b, 0] = 7
    want.append(("stale-row", sh, b, 0))
    sh = 3 % s_
    b = int(np.flatnonzero(k[sh] == 0)[0])
    exp[sh, b] = 123
    want.append(("torn-vacate", sh, b, 0))
    want.sort(key=lambda w: (w[1], w[2], _TEAR_RANK[w[0]]))
    return k, v, exp, want


def phase_kv_faults(device, kv, dk, dv, n_update=3, n_insert=3, n_disp=2,
                    seed=11):
    """The recovery drill on the ``kv_get`` store: a (S, 8) SET batch of
    updates, inserts and keys whose neighborhood is full under a seeded
    storm of all four kinds (p 0.5, steps below 60); fsck, repair, and a
    retry of the rows that did not reach a terminal status.  Every SET
    key must read back its value on the three get paths, untouched keys
    theirs, and fsck must be clean.  Then one planted tear of each kind
    on copies of the store, which the report must name exactly."""
    rng = np.random.RandomState(seed)
    s_, n = dk.shape[0], dk.shape[1]
    h, v = kv.neighborhood, dv.shape[2]
    loaded = np.concatenate([t.keys[t.keys != 0] for t in kv.tables])
    tables = [hopscotch.HopscotchTable(t.keys.copy(), t.values.copy(), h)
              for t in kv.tables]

    def dev(a):
        return torch.from_numpy(np.asarray(a)).to(device)

    fresh = int(loaded.max()) + 5000
    disp = displacement_keys(tables, s_, fresh + (1 << 21), s_ * n_disp)
    upd = rng.choice(loaded, s_ * n_update, replace=False)
    rows = []
    for s in range(s_):
        rows.append(rng.permutation(np.concatenate([
            upd[s * n_update:(s + 1) * n_update],
            np.arange(fresh, fresh + n_insert),
            disp[s * n_disp:(s + 1) * n_disp]])))
        fresh += n_insert
    sk = np.stack(rows).astype(np.int32)
    sv = new_values(sk, v)
    plan = faults.storm(sk.size, p_fault=0.5, max_step=60,
                        seed=faults.storm_seed(), device=device)
    plan = faults.FaultPlan(*(leaf.reshape(sk.shape) for leaf in plan))
    recs = []
    (res, wk, wv), set_ms = recorded(recs, lambda: timed_call(
        device, lambda: store.sharded_set(dk, dv, dev(sk), dev(sv),
                                          faults=plan, device=device)))
    status = res.status.cpu().numpy()
    retry = ~np.isin(status, SET_TERMINAL)
    if not retry.any():
        raise AssertionError("the storm interrupted no chain")
    rep, fsck_ms = timed_call(device, lambda: fsck.check_invariants(
        wk, wv, neighborhood=h))
    if not rep.repairable:
        raise AssertionError(f"storm left an unrepairable store: {rep}")
    (wk, wv, actions), repair_ms = timed_call(device, lambda: fsck.repair(
        wk, wv, rep, neighborhood=h))
    if not fsck.check_invariants(wk, wv, neighborhood=h).clean:
        raise AssertionError("fsck not clean after repair")
    (res2, wk, wv), retry_ms = recorded(recs, lambda: timed_call(
        device, lambda: store.sharded_set(wk, wv, dev(sk), dev(sv),
                                          live=dev(retry), device=device)))
    # each SET stage, the storm's (fault rows on the writer) and the
    # retry's, held to _walk on the same inputs
    walked = require_walked(device, "storm and retry sets", recs)
    if not np.isin(res2.status.cpu().numpy()[retry], SET_TERMINAL).all():
        raise AssertionError(f"the retry left rows unserved: {res2}")
    untouched = rng.choice(np.setdiff1d(loaded, sk), s_ * 16,
                           replace=False).reshape(s_, 16).astype(np.int32)
    q = np.concatenate([sk, untouched], axis=1)
    want_v = np.concatenate([sv, np.stack(
        [untouched, 2 * untouched, 3 * untouched, 5 * untouched],
        axis=-1)[..., :v]], axis=1)
    for method in ("redn", "one_sided", "two_sided"):
        g = store.sharded_get(wk, wv, dev(q), method=method, device=device)
        require_equal(g.found, np.ones(q.shape, bool), f"{method} found")
        require_equal(g.values, want_v, f"{method} values")
    final, final_ms = timed_call(device, lambda: fsck.check_invariants(
        wk, wv, neighborhood=h))
    if not final.clean:
        raise AssertionError(f"fsck not clean at the end: {final}")
    result = dict(set_batch=sk.shape, armed=int(plan.active().sum()),
                  interrupted=int(retry.sum()),
                  statuses={hopscotch.status_name(c): int((status == c).sum())
                            for c in np.unique(status)},
                  violations=repr(rep), repairs=len(actions), set_ms=set_ms,
                  retry_ms=retry_ms, fsck_ms=fsck_ms, repair_ms=repair_ms,
                  final_fsck_ms=final_ms, buckets=s_ * n,
                  walked_stages=[w["stage"] for w in walked])

    # --- planted tears: the report names exactly them ------------------------
    pk, pv, pe, want = plant_tears(dk.cpu().numpy(), dv.cpu().numpy(), h)
    got, planted_ms = timed_call(device, lambda: fsck.check_invariants(
        dev(pk), dev(pv), neighborhood=h, exp=dev(pe)))
    named = [(x.kind, x.shard, x.bucket, x.key) for x in got.violations]
    if named != want:
        raise AssertionError(f"planted tears: report {named}, planted {want}")
    (rk, rv, re_, acts), planted_repair_ms = timed_call(
        device, lambda: fsck.repair(dev(pk), dev(pv), got, neighborhood=h,
                                    exp=dev(pe)))
    left = fsck.check_invariants(rk, rv, neighborhood=h, exp=re_)
    breach = [w for w in want if w[0] == "neighborhood"]
    if [(x.kind, x.shard, x.bucket, x.key) for x in left.violations] != \
            breach or len(acts) != 4:
        raise AssertionError(f"planted repair left {left} ({acts})")
    # the fifth repairable kind needs two frames: a complete copy of a
    # resident of shard 2 (mod S) planted in the doubled frame
    rs = store.begin_resize(dk, dv, device=device)
    sh = 2 % s_
    b_old = int(np.flatnonzero(pk[sh] != 0)[0])
    key = int(pk[sh, b_old])
    b_new = int(hopscotch.bucket_of(key, 2 * n))
    rs.new_keys[sh, b_new] = key
    rs.new_vals[sh, b_new] = rs.vals[sh, b_old]
    got, resize_fsck_ms = timed_call(device, lambda: fsck.check_invariants(
        resize=rs, neighborhood=h))
    named = [(x.kind, x.shard, x.bucket, x.key) for x in got.violations]
    if named != [("cross-frame-dup", sh, b_new, key)]:
        raise AssertionError(f"cross-frame tear: report {named}")
    rs, acts = fsck.repair_resize(rs, got, neighborhood=h)
    if ([a.action for a in acts] != ["vacate-old"]
            or not fsck.check_invariants(resize=rs, neighborhood=h).clean):
        raise AssertionError(f"cross-frame repair: {acts}")
    result.update(planted=[w[0] for w in want] + ["cross-frame-dup"],
                  planted_fsck_ms=planted_ms,
                  planted_repair_ms=planted_repair_ms,
                  resize_fsck_ms=resize_fsck_ms)
    return result


# ---------------------------------------------------------------------------
# phase 6c: online resize at the real store size
# ---------------------------------------------------------------------------

def host_quantum(old, new, start: int, step: int, max_search: int,
                 max_moves: int):
    """The host oracle of one ``sharded_resize`` quantum on one shard:
    ``migrate_bucket`` over ``[start, start + step)``, then each
    ``MIG_NEEDS_DISPLACE`` lap through the bounded ``set_full`` on the new
    frame (``HopscotchTable.grow``'s inner loop)."""
    ms = min(max(max_search, old.neighborhood), new.n_buckets)
    pending = [b for b in range(start, min(start + step, old.n_buckets))
               if old.migrate_bucket(new, b) == hopscotch.MIG_NEEDS_DISPLACE]
    for b in pending:
        if new.set_full(int(old.keys[b]), old.values[b].tolist(), ms,
                        max_moves) == hopscotch.SET_NEEDS_RESIZE:
            raise AssertionError(f"host oracle: bucket {b} is stuck")
        old.keys[b] = 0
        old.values[b] = 0


def require_frames(what: str, rs, olds, news):
    require_equal(rs.keys, np.stack([t.keys for t in olds]), f"{what} old k")
    require_equal(rs.vals, np.stack([t.values for t in olds]),
                  f"{what} old v")
    require_equal(rs.new_keys, np.stack([t.keys for t in news]),
                  f"{what} new k")
    require_equal(rs.new_vals, np.stack([t.values for t in news]),
                  f"{what} new v")


def double_reference(olds, news, queries):
    """The double-frame get oracle: each query looked up in its owner's new
    table, else its old one (``reference_get`` on each frame)."""
    s_, v = len(olds), olds[0].values.shape[1]
    fn, vn = store.reference_get(store.ShardedKV(news, s_, v,
                                                 news[0].neighborhood),
                                 queries)
    fo, vo = store.reference_get(store.ShardedKV(olds, s_, v,
                                                 olds[0].neighborhood),
                                 queries)
    return fn | fo, np.where(fn[:, None], vn, vo)


def phase_kv_resize(device, kv, dk, dv, step=16, before_end=8, n_gets=64,
                    small_buckets=32, small_keys=20, seed=5):
    """Online growth of the ``kv_get`` store: ``begin_resize``, then two
    ``sharded_resize`` quanta of ``step`` laps, fault-free, held to the
    host oracle replaying the same quanta.  The same two quanta again with
    shard 0 killed ``before_end`` WRs before the end of a lap of the first
    (between its new-frame claim and its old-frame vacate, as the
    fault-free lap's step count from the trace places it): its watermark
    parks on the fired lap's bucket; fsck must find the tear, and repair,
    re-driving shard 0's interrupted quantum and the second quantum must
    land on the fault-free frames and watermarks.  Gets (keys behind, at
    and ahead of the watermark, and misses) and sets through the
    ResizeState arms of ``sharded_get``/``sharded_set``, each against the
    double-frame oracle.  Then a small store grown to the end, against
    ``grow``."""
    rng = np.random.RandomState(seed)
    s_, n = dk.shape[0], dk.shape[1]
    h, v = kv.neighborhood, dv.shape[2]
    ms, mm = hopscotch.DEFAULT_MAX_SEARCH, hopscotch.DEFAULT_MAX_MOVES
    olds = [hopscotch.HopscotchTable(t.keys.copy(), t.values.copy(), h)
            for t in kv.tables]
    news = [hopscotch.make_table(2 * n, v, h) for _ in range(s_)]
    rs0 = store.begin_resize(dk, dv, device=device)

    # --- two fault-free quanta against the host oracle -----------------------
    clean, reports, quantum_ms, quantum_rows_ms = rs0, [], [], []
    quantum_stages = []
    for q in range(2):
        (clean, rep), walked = walk_vs_rows(
            device, f"quantum {q}", lambda: store.sharded_resize(
                clean, step, h, device=device))
        reports.append({k: x.tolist() for k, x in rep._asdict().items()})
        quantum_ms.append(walked["ms"])
        quantum_rows_ms.append(walked["rows_ms"])
        quantum_stages.append(stage_summary(walked["stages"]))
        for o, nw in zip(olds, news):
            host_quantum(o, nw, q * step, step, ms, mm)
        if q == 0:
            mig_steps = [r["steps"] for r in walked["records"]
                         if r["stage"] == "migrator"]
    require_frames("clean quanta", clean, olds, news)
    require_equal(clean.watermark, np.full(s_, 2 * step, np.int32),
                  "clean watermarks")

    # --- the same quanta with shard 0 killed mid-lap -------------------------
    # a lap whose source bucket is live, after two earlier laps; shard 0
    # is the first row of every walk position it runs at
    live0 = np.flatnonzero(dk[0, :step].cpu().numpy() != 0)
    at = int(np.flatnonzero(live0 >= 2)[0])
    lap = int(live0[at])
    kill_step = int(mig_steps[0][at][0]) - before_end
    rows = faults.FaultPlan.none((s_, step), device=device).as_rows()
    rows[0] = faults.FaultPlan.kill_lap(step, lap, kill_step,
                                        device=device).as_rows()
    (frs, frep), faulted = walk_vs_rows(
        device, "faulted quantum", lambda: store.sharded_resize(
            rs0, step, h, faults=faults.FaultPlan.from_row(rows),
            device=device))
    faulted_ms = faulted["ms"]
    require_equal(frs.watermark, [lap] + [step] * (s_ - 1),
                  "faulted watermarks")
    rep, fsck_ms = timed_call(device, lambda: fsck.check_invariants(
        resize=frs, neighborhood=h))
    if rep.clean or not rep.repairable:
        raise AssertionError(f"the killed lap left no repairable tear: "
                             f"{rep}")
    (frs, actions), repair_ms = timed_call(device, lambda: fsck.repair_resize(
        frs, rep, neighborhood=h))
    if not fsck.check_invariants(resize=frs, neighborhood=h).clean:
        raise AssertionError("fsck not clean after repair_resize")
    rest = []
    one, _ = recorded(rest, lambda: store.sharded_resize(
        store.ResizeState(*(a[:1] for a in frs)), step - lap, h,
        device=device))
    frs = store.ResizeState(*(torch.cat([a, b[1:]]) for a, b in zip(one,
                                                                     frs)))
    frs, _ = recorded(rest, lambda: store.sharded_resize(frs, step, h,
                                                         device=device))
    for f in store.ResizeState._fields:
        require_equal(getattr(frs, f), getattr(clean, f),
                      f"re-driven vs fault-free {f}")
    result = dict(step=step, quantum_ms=quantum_ms, reports=reports,
                  killed_lap=lap, kill_step=kill_step, violations=repr(rep),
                  repairs=[a.action for a in actions],
                  faulted_quantum_ms=faulted_ms, fsck_ms=fsck_ms,
                  repair_ms=repair_ms, buckets=s_ * 3 * n,
                  quantum_rows_ms=quantum_rows_ms,
                  quantum_stages=quantum_stages,
                  faulted_quantum_rows_ms=faulted["rows_ms"])

    # --- serving from both frames --------------------------------------------
    w = 2 * step

    def dev(a):
        return torch.from_numpy(np.asarray(a)).to(device)

    qs = []
    for s in range(s_):
        old_k = kv.tables[s].keys
        at = [int(old_k[w])] if old_k[w] else []
        behind = [int(k) for k in old_k[:w] if k][:8]
        ahead = rng.choice(old_k[w + h:][old_k[w + h:] != 0],
                           n_gets - len(at) - len(behind) - 4,
                           replace=False).tolist()
        misses = (10_000_000 + s * 10 + np.arange(3)).tolist()
        qs.append(at + behind + ahead + misses + [0])
    q = np.asarray(qs, np.int32)
    g, get_ms = timed_call(device, lambda: store.sharded_get(
        clean, dev(q), neighborhood=h, device=device))
    rf, rv = double_reference(olds, news, q)
    require_equal(g.found.reshape(-1), rf, "resize get found")
    require_equal(g.values.reshape(-1, v), rv, "resize get values")
    if not bool(g.ok.all()):
        raise AssertionError(f"resize gets dropped: {g}")
    # two sets per shard: a migrated key (routes to the new frame) and an
    # unmigrated one (updated in the old frame)
    sk = np.stack([[r[1], r[-6]] for r in qs]).astype(np.int32)
    sv = new_values(sk, v)
    (sres, srs), set_ms = recorded(rest, lambda: timed_call(
        device, lambda: store.sharded_set(clean, dev(sk), dev(sv),
                                          neighborhood=h, device=device)))
    if not np.isin(sres.status.cpu().numpy(), SET_TERMINAL).all():
        raise AssertionError(f"resize sets: {sres}")
    g2 = store.sharded_get(srs, dev(q), neighborhood=h, device=device)
    want_v = rv.reshape(q.shape + (v,)).copy()
    for s in range(s_):
        for j, k in enumerate(sk[s]):
            want_v[q == k] = sv[s, j]
    require_equal(g2.values, want_v, "resize get after set")
    if not fsck.check_invariants(resize=srs, neighborhood=h).clean:
        raise AssertionError("fsck not clean after the resize sets")
    result.update(gets=int(q.size), get_hits=int(rf.sum()), get_ms=get_ms,
                  sets=int(sk.size),
                  set_statuses=sres.status.cpu().numpy().tolist(),
                  set_ms=set_ms)

    # --- a small store grown to the end --------------------------------------
    small = store.ShardedKV.build(s_, small_buckets, v, h)
    for k in rng.choice(np.arange(1, 1 << 20), s_ * small_keys,
                        replace=False).tolist():
        small.set(k, [k, k + 1, k + 2, k + 3][:v])
    grown = [hopscotch.HopscotchTable(t.keys.copy(), t.values.copy(),
                                      h).grow(step=step)
             for t in small.tables]
    rs = store.begin_resize(*small.device_arrays(device), device=device)
    t0 = time.perf_counter()
    quanta = 0
    while not store.resize_done(rs):
        rs, _ = recorded(rest, lambda: store.sharded_resize(
            rs, step, h, device=device))
        quanta += 1
    nk, nv = store.finish_resize(rs)
    require_equal(nk, np.stack([t.keys for t in grown]), "grown keys")
    require_equal(nv, np.stack([t.values for t in grown]), "grown vals")
    # every walked stage of the re-drive, the window's sets and the growth
    # to the end, held to _walk on the same inputs
    walked = require_walked(device, "resize", rest)
    result.update(small_quanta=quanta,
                  small_grow_s=time.perf_counter() - t0,
                  walked_stages=len(walked))
    return result


# ---------------------------------------------------------------------------
# phase 6d: racing writers and isolation (§3.5, §5.5)
# ---------------------------------------------------------------------------

def spaced_keys(kv, rng, per_owner: int, fresh: int, gap: int = 128):
    """Per owner shard ``per_owner`` keys whose home buckets lie at least
    ``gap`` apart: half loaded keys (updates), half fresh keys (inserts).
    No two of them can touch one neighborhood, or one displacement
    window, so their writes commute.  Returns {owner: [keys]}."""
    s_, n = kv.n_shards, kv.tables[0].n_buckets
    gap = min(gap, n // (2 * per_owner))
    out = {}
    for o, t in enumerate(kv.tables):
        homes, keys = [], []

        def take(cand):
            for k in cand:
                hb = int(hopscotch.bucket_of(int(k), n))
                if all(min((hb - x) % n, (x - hb) % n) >= gap
                       for x in homes):
                    homes.append(hb)
                    keys.append(int(k))
                    return
        loaded = t.keys[t.keys != 0]
        for _ in range(per_owner // 2):
            take(rng.permutation(loaded)[:256])
        while len(keys) < per_owner:
            cand = np.arange(fresh, fresh + (1 << 16), dtype=np.int64)
            fresh += 1 << 16
            take(cand[store.shard_of(cand, s_) == o][:256])
        out[o] = keys
    return out, fresh


def hot_keys(kv, rng, count: int, start: int):
    """Per owner a bucket with at least two EMPTY slots in its neighborhood
    and ``count`` fresh keys (from ``start`` up) homed at it: the hot-key
    hammer.  The home hash keeps a key's low bits, and so does the owner
    hash's low bits, so at 65,536 buckets every key homed at a bucket has
    the same owner: the bucket is drawn among those whose homed keys the
    owner holds.  Returns (keys (S, count), row o owned by shard o; the
    hot buckets)."""
    s_, n, h = kv.n_shards, kv.tables[0].n_buckets, kv.neighborhood
    cand = np.arange(start, min(start + (1 << 22), 0x1000000),
                     dtype=np.int64)
    owner = store.shard_of(cand, s_)
    home = hopscotch.bucket_of(cand, n)
    rows, buckets = [], []
    for o, t in enumerate(kv.tables):
        empty = np.stack([np.roll(t.keys == 0, -d) for d in range(h)]).sum(0)
        mine = owner == o
        per = np.bincount(home[mine], minlength=n)
        b = int(rng.choice(np.flatnonzero((empty >= 2) & (per >= count))))
        rows.append(cand[mine & (home == b)][:count])
        buckets.append(b)
    return np.asarray(rows, np.int32), buckets


def state_abs_err(a, b) -> float:
    """The largest absolute difference between two machine batches of one
    shape, over every field (float64, in slices of 2**24 elements; a clock
    bit-equal on both sides counts 0, an inf or NaN against another
    value inf)."""
    worst = 0.0
    for x, y in zip(a, b):
        x = x.to(y.device)
        for xs, ys in zip(x.reshape(-1).split(1 << 24),
                          y.reshape(-1).split(1 << 24)):
            d = (xs.double() - ys.double()).abs()
            if xs.is_floating_point():
                d = torch.where(xs.view(torch.int32) == ys.view(torch.int32),
                                0.0, d.nan_to_num(nan=math.inf,
                                                 posinf=math.inf))
            worst = max(worst, float(d.max()))
    return worst


def require_states(a, b, what: str) -> float:
    """Every field of two machine batches bit-equal (clocks as their bits),
    compared on ``b``'s device; returns :func:`state_abs_err` (0)."""
    for f, x, y in zip(machine.VMState._fields, a, b):
        x = x.to(y.device)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if x.shape != y.shape or not torch.equal(x, y):
            bad = int((x != y).sum()) if x.shape == y.shape else "shape"
            raise AssertionError(f"{what}: {f} differs ({bad} elements)")
    return state_abs_err(a, b)


def cut_sweep(device, n=16, v=2, h=4):
    """``tests/test_faults.py``'s 2-writer scenario: two keys homed at one
    bucket race for the last two free slots of a half-full neighborhood.
    Every cut 0..writer_fuel runs as ONE batch of machines on ``device``;
    returns (group, final states, per-cut (status, keys, vals), the AB/BA
    oracles, ms)."""
    group = programs.build_multi_writer_group(n, v, neighborhood=h,
                                              n_writers=2, device=device)
    homed = store.keys_homed_at(3, 4, n)
    keys0 = np.zeros(n, np.int32)
    vals0 = np.zeros((n, v), np.int32)
    for b, k in zip((3, 4), homed[:2]):
        keys0[b] = k
        vals0[b] = [k & 0xFF, b]
    qa, qb = homed[2], homed[3]
    dev = torch.device(device)
    q = torch.tensor([qa, qb], dtype=torch.int32, device=dev)
    qv = torch.tensor([[qa & 0xFF, qa >> 4], [qb & 0xFF, qb >> 4]],
                      dtype=torch.int32, device=dev)
    pay = group.device_payloads(q, hopscotch.bucket_of(q, n), qv)
    writer = programs.build_hopscotch_writer(n, v, neighborhood=h,
                                             device=device)
    oracles = {}
    for name, order in (("AB", (0, 1)), ("BA", (1, 0))):
        k = torch.from_numpy(keys0).to(dev)
        vv = torch.from_numpy(vals0).to(dev)
        for i in order:
            wp = writer.device_payloads(q[i:i + 1], hopscotch.bucket_of(
                q[i:i + 1], n), qv[i:i + 1])[0]
            st, k, vv = writer.run_one(k, vv, wp, writer.fuel)
            if int(st) not in SET_TERMINAL:
                raise AssertionError(f"oracle {name}: status {int(st)}")
        oracles[name] = (k.cpu().numpy(), vv.cpu().numpy())
    cuts = torch.arange(group.writer_fuel + 1, dtype=torch.int32,
                        device=dev)
    g = cuts.numel()
    kb = torch.from_numpy(keys0).to(dev).expand(g, n)
    vb = torch.from_numpy(vals0).to(dev).expand(g, n, v)
    sched = machine.Schedule.cut(cuts)
    out, ms = timed_call(device, lambda: machine.run_scheduled_in_place(
        group.spec, group.delivered_state(kb, vb, pay.expand(g, 2, -1)),
        sched, group.writer_slices, group.fuel))
    per_cut = group.run_group(kb, vb, pay.expand(g, 2, -1), sched,
                              group.fuel)
    return group, out, per_cut, oracles, ms


def fairness_run(device, n=32, v=2, h=8, w=4):
    """``benchmarks/write_contention.py``'s hammer: ``w`` writers insert
    distinct keys homed at one bucket under ``fair_quotas([8] * w, 48)``.
    Returns (group, final state, ms)."""
    group = programs.build_multi_writer_group(n, v, neighborhood=h,
                                              n_writers=w, device=device)
    qs = store.keys_homed_at(3, w, n)
    dev = torch.device(device)
    q = torch.tensor(qs, dtype=torch.int32, device=dev)
    pay = group.device_payloads(q, hopscotch.bucket_of(q, n), torch.tensor(
        [[k & 0xFF, k >> 4] for k in qs], dtype=torch.int32, device=dev))
    st = group.delivered_state(
        torch.zeros((1, n), dtype=torch.int32, device=dev),
        torch.zeros((1, n, v), dtype=torch.int32, device=dev), pay[None])
    sched = isolation.fair_quotas([8.0] * w, n_rounds=48, device=device)
    out, ms = timed_call(device, lambda: machine.run_scheduled_in_place(
        group.spec, st, sched, group.writer_slices, group.fuel))
    return group, out, ms


SET_ANSWERS = SET_TERMINAL + (hopscotch.SET_NEEDS_RESIZE,)


def phase_kv_contend(device, kv, dk, dv, per_owner=8, n_gets=64,
                     burst=64.0, rate=0.5, seed=11):
    """Racing writers and isolation on the ``kv_get`` store.

    ``sharded_set`` with ``n_writers`` 2 and 4 on a (S, ``per_owner``)
    SET batch of two traffics: *uniform* (updates and inserts whose home
    buckets lie far apart) must equal ``n_writers=1`` and the host oracle
    bit for bit; the *hot-key hammer* (each owner's keys homed at one
    bucket, sent as one source row, so a lap's claim CASes race) must
    answer every row (inserted, displaced or needs-resize), stay
    fsck-clean and read every applied key back.  Then ``tests/
    test_faults.py``'s 2-writer cut sweep, every cut as one batch, each
    cut on the AB or BA oracle and bit-equal to the same batch on the CPU;
    the fairness hammer under ``fair_quotas`` (best/worst completion
    clock <= 2, clocks bit-equal to the CPU); and ``sharded_get``'s
    ``isolation=`` arm over (S, ``n_gets``) queries from 4 clients, one
    greedy, two calls apart in time: the admitted mask and the float32
    buckets bit-equal to the CPU's, admitted answers equal
    ``reference_get``."""
    rng = np.random.RandomState(seed)
    s_, n = dk.shape[0], dk.shape[1]
    h, v = kv.neighborhood, dv.shape[2]

    def dev(a):
        return torch.from_numpy(np.asarray(a)).to(device)

    loaded = np.concatenate([t.keys[t.keys != 0] for t in kv.tables])
    # fresh keys: the hammer's from just above the loaded ones (a bucket
    # of a 4 x 65,536 store homes one key in 262,144), the spaced ones
    # from the top of the 24-bit space
    hot_start, fresh = int(loaded.max()) + 1, 0xC00000
    result = dict(shards=s_, buckets_per_shard=n, sets_per_s={},
                  set_ms={}, set_stages={})

    # --- uniform traffic: the lanes never race, so every writer count
    # commits what the serialized writer commits ---------------------------
    spaced, fresh = spaced_keys(kv, rng, per_owner, fresh)
    flat = np.concatenate([spaced[o] for o in range(s_)])
    sk = rng.permutation(flat).reshape(s_, per_owner).astype(np.int32)
    sv = new_values(sk, v)
    live = np.ones(sk.shape, bool)
    tables = [hopscotch.HopscotchTable(t.keys.copy(), t.values.copy(), h)
              for t in kv.tables]
    want = window_oracle(tables, sk, live, hopscotch.insert_many_displaced,
                         sv)
    runs = {}
    for w in (1, 2, 4):
        runs[w], ms, stages = run_traced(device, lambda: store.sharded_set(
            dk, dv, dev(sk), dev(sv), n_writers=w, device=device))
        result["set_ms"][f"uniform/{w}"] = ms
        result["sets_per_s"][f"uniform/{w}"] = sk.size / (ms * 1e-3)
        result["set_stages"][f"uniform/{w}"] = stages
        require_mutation(f"uniform n_writers={w}", runs[w][0], want, sk,
                         live, SET_TERMINAL)
        require_tables(f"uniform n_writers={w}", tables, *runs[w][1:])
        for a, b, f in zip(runs[w][0], runs[1][0], store.SetResult._fields):
            require_equal(a, b, f"uniform n_writers={w} vs 1 {f}")
    result["uniform_statuses"] = {
        hopscotch.status_name(c): int((want == c).sum())
        for c in np.unique(want)}

    # --- the hot-key hammer --------------------------------------------------
    hk, hot_buckets = hot_keys(kv, rng, per_owner, hot_start)
    hv = new_values(hk, v)
    result["hot_statuses"] = {}
    for w in (2, 4):
        (res, nk, nv), ms, stages = run_traced(
            device, lambda: store.sharded_set(dk, dv, dev(hk), dev(hv),
                                              n_writers=w, device=device))
        result["set_ms"][f"hot/{w}"] = ms
        result["sets_per_s"][f"hot/{w}"] = hk.size / (ms * 1e-3)
        result["set_stages"][f"hot/{w}"] = stages
        st = res.status.cpu().numpy()
        if not (bool(res.ok.all()) and np.isin(st, SET_ANSWERS).all()):
            raise AssertionError(f"hot n_writers={w}: unanswered rows {res}")
        applied = res.applied.cpu().numpy()
        if int(applied.sum()) < 2 * s_:
            raise AssertionError(f"hot n_writers={w}: {res}")
        rep = fsck.check_invariants(nk, nv, neighborhood=h)
        if not rep.clean:
            raise AssertionError(f"hot n_writers={w}: fsck {rep}")
        g = store.sharded_get(nk, nv, dev(hk), device=device)
        require_equal(g.found, applied, f"hot n_writers={w} found")
        require_equal(g.values.cpu().numpy()[applied], hv[applied],
                      f"hot n_writers={w} values")
        result["hot_statuses"][w] = {
            hopscotch.status_name(c): int((st == c).sum())
            for c in np.unique(st)}

    # --- the 2-writer cut sweep, every cut one batch, card against CPU -------
    group, out, (cst, ck, cv), oracles, sweep_ms = cut_sweep(device)
    _, out_cpu, (cst_c, ck_c, cv_c), _, _ = cut_sweep("cpu")
    require_states(out, out_cpu, "cut sweep card vs cpu")
    for a, b, f in ((cst, cst_c, "status"), (ck, ck_c, "keys"),
                    (cv, cv_c, "vals")):
        require_equal(a, b, f"cut sweep run_group {f}")
    hits = {}
    for c in range(ck.shape[0]):
        if not np.isin(cst[c].cpu().numpy(), SET_TERMINAL).all():
            raise AssertionError(f"cut {c}: statuses {cst[c]}")
        name = [nm for nm, (ok, ov) in oracles.items()
                if np.array_equal(ck[c].cpu().numpy(), ok)
                and np.array_equal(cv[c].cpu().numpy(), ov)]
        if not name:
            raise AssertionError(f"cut {c}: on neither serialized oracle")
        hits[name[0]] = hits.get(name[0], 0) + 1
        if not fsck.check_invariants(ck[c][None], cv[c][None],
                                     neighborhood=4).clean:
            raise AssertionError(f"cut {c}: fsck not clean")
    steps = out.steps.cpu().numpy()
    result.update(cuts=int(ck.shape[0]), cut_oracles=hits,
                  sweep_ms=sweep_ms, sweep_steps_total=int(steps.sum()),
                  sweep_steps_max=int(steps.max()),
                  sweep_steps_per_s=float(steps.sum()) / (sweep_ms * 1e-3))

    # --- fairness under fair_quotas, card against CPU ------------------------
    fg, fout, fair_ms = fairness_run(device)
    _, fout_cpu, _ = fairness_run("cpu")
    require_states(fout, fout_cpu, "fairness card vs cpu")
    finish = [float(fout.last_comp_time[0, lo:hi].max())
              for lo, hi in fg.writer_slices]
    ratio = max(finish) / min(finish)
    if ratio > 2.0:
        raise AssertionError(f"fairness ratio {ratio} > 2: {finish}")
    lane_st = [int(fout.mem[0, r]) for _, r in fg.lanes]
    if not np.isin(lane_st, SET_TERMINAL).all():
        raise AssertionError(f"fairness statuses {lane_st}")
    fsteps = int(fout.steps[0])
    result.update(fairness_ratio=ratio, finish_us=finish,
                  fair_ms=fair_ms, fair_steps=fsteps,
                  fair_steps_per_s=fsteps / (fair_ms * 1e-3),
                  fair_ms_per_step=fair_ms / fsteps)

    # --- the isolation arm: a greedy client among four -----------------------
    qs = np.stack([rng.choice(loaded, n_gets) for _ in range(s_)])
    qs[:, ::8] = fresh + np.arange(qs[:, ::8].size).reshape(s_, -1)  # misses
    qs = qs.astype(np.int32)
    clients = np.where(np.arange(n_gets) % 2 == 0, 0,
                       1 + np.arange(n_gets) % 3)
    clients = np.broadcast_to(clients, qs.shape).astype(np.int32)
    buckets = {d: isolation.init(4, burst, device=d)
               for d in (device, "cpu")}
    rf, rv = store.reference_get(kv, qs)
    deferred, admitted = [], []
    for call, now in enumerate((0.0, 100.0)):
        adm = {d: store.Admission(dev(clients) if d == device
                                  else torch.from_numpy(clients), buckets[d],
                                  now, rate, burst)
               for d in (device, "cpu")}
        res, buckets[device] = store.sharded_get(
            dk, dv, dev(qs), isolation=adm[device], device=device)
        res_c, buckets["cpu"] = store.sharded_get(
            dk.cpu(), dv.cpu(), torch.from_numpy(qs), method="two_sided",
            isolation=adm["cpu"], device="cpu")
        for f in ("found", "values", "ok", "dropped", "deferred"):
            require_equal(getattr(res, f), getattr(res_c, f),
                          f"isolated get {call} {f}")
        for f, a, b in zip(("tokens", "last_us"), buckets[device],
                           buckets["cpu"]):
            require_equal(a.cpu().view(torch.int32), b.view(torch.int32),
                          f"bucket {call} {f}")
        ok = res.ok.cpu().numpy().reshape(-1)
        require_equal(res.found.reshape(-1).cpu().numpy()[ok], rf[ok],
                      f"isolated get {call} hits")
        require_equal(res.values.reshape(-1, v).cpu().numpy()[ok], rv[ok],
                      f"isolated get {call} values")
        greedy = clients.reshape(-1) == 0
        if ok[greedy].all() or (call == 0 and not ok[~greedy].all()):
            raise AssertionError(f"isolated get {call}: the greedy client "
                                 f"is not the one deferred: {res}")
        deferred.append(int(res.deferred.sum()))
        admitted.append(int(ok.sum()))
    result.update(isolation_deferred=deferred, isolation_admitted=admitted,
                  isolation_tokens=buckets[device].tokens.tolist())
    return result


# ---------------------------------------------------------------------------
# phase 6e: the crash-resilient services (§5.6)
# ---------------------------------------------------------------------------

def phase_kv_service(device, kv, dk, dv, recycled_buckets=4096,
                     recycled_words=32768, n_stream=256, per_owner=8,
                     small_buckets=8, seed=13):
    """The §5.6 services with the host driver crashed.

    ``DeviceResidentService``: crash, stream ``n_stream`` Zipf gets
    through ``get_many`` (the recycled chain), restart; every value
    right.  ``ShardedKVService`` over the ``kv_get`` store's tensors:
    crash; ``get_many``, a (S, ``per_owner``) ``set_many`` with
    ``n_writers=2`` and a ``delete_many``, each against the host oracles;
    restart; ``set_reliable`` under a kill plan recovers and
    ``fsck_and_repair`` comes back clean.  Then a 1-shard,
    ``small_buckets``-bucket service grows under ``set_many`` (auto-resize)
    with every key served through the growth, and the chained second
    growth of ``tests/test_faults.py`` (a full doubled frame) with the
    driver dead."""
    rng = np.random.RandomState(seed)
    s_, n = dk.shape[0], dk.shape[1]
    h, v = kv.neighborhood, dv.shape[2]
    result = dict(ms={})
    set_one = [9, 8, 7, 6][:v]
    walked = []                    # the transport's records of the phase

    def dev(a):
        return torch.from_numpy(np.asarray(a)).to(device)

    def timed(name, fn):
        value, ms = recorded(walked, lambda: timed_call(device, fn))
        result["ms"][name] = ms
        return value

    # --- the recycled get server through a crash -------------------------
    items = [(k, [k * 7, k * 11]) for k in range(1, recycled_buckets + 1)]
    drs = failure.DeviceResidentService.start(
        items, n_buckets=recycled_buckets, val_len=2,
        mem_words=recycled_words, device=device)
    drs.crash_host()
    _, keys = next(kv_request_stream(recycled_buckets, n_stream, seed=3))
    got = timed("resident_stream", lambda: drs.get_many(keys))
    require_equal(got, np.stack([[int(k) * 7, int(k) * 11] for k in keys]),
                  "resident stream values")
    if drs.host_alive():
        raise AssertionError("the driver came back by itself")
    drs.restart_host()
    result.update(resident_gets=int(len(keys)),
                  resident_gets_per_s=len(keys) / (
                      result["ms"]["resident_stream"] * 1e-3))

    # --- the sharded service over the kv_get store ---------------------------
    svc = failure.ShardedKVService(kv=kv, axis="kv", keys=dk.clone(),
                                   vals=dv.clone(),
                                   driver=failure.HostDriver(), n_writers=2)
    tables = [hopscotch.HopscotchTable(t.keys.copy(), t.values.copy(), h)
              for t in kv.tables]
    host = store.ShardedKV(tables, s_, v, h)
    svc.crash_host()
    q = kv_batches(s_, int(sum((t.keys != 0).sum() for t in tables)), 64,
                   1)[0]
    g = timed("service_get", lambda: svc.get_many(dev(q)))
    rf, rv = store.reference_get(host, q)
    require_equal(g.found.reshape(-1), rf, "service get found")
    require_equal(g.values.reshape(-1, v), rv, "service get values")
    loaded = np.concatenate([t.keys[t.keys != 0] for t in tables])
    spaced, fresh = spaced_keys(host, rng, per_owner, int(loaded.max()) + 1)
    sk = rng.permutation(np.concatenate(list(spaced.values()))).reshape(
        s_, per_owner).astype(np.int32)
    sv = new_values(sk + 5, v)
    live = np.ones(sk.shape, bool)
    want = window_oracle(tables, sk, live, hopscotch.insert_many_displaced,
                         sv)
    res = timed("service_set", lambda: svc.set_many(dev(sk), dev(sv)))
    require_mutation("service set", res, want, sk, live, SET_TERMINAL)
    require_tables("service set", tables, svc.keys, svc.vals)
    dkeys = np.concatenate([sk[:, :per_owner // 2],
                            np.stack([rng.choice(loaded, 2)
                                      for _ in range(s_)]),
                            fresh + np.arange(2 * s_).reshape(s_, 2)],
                           axis=1).astype(np.int32)
    d_live = np.ones(dkeys.shape, bool)
    want = window_oracle(tables, dkeys, d_live, hopscotch.delete_many)
    dres = timed("service_delete", lambda: svc.delete_many(dev(dkeys)))
    require_mutation("service delete", dres, want, dkeys, d_live,
                     (hopscotch.DEL_DELETED,))
    require_tables("service delete", tables, svc.keys, svc.vals)
    if svc.host_alive():
        raise AssertionError("the driver came back by itself")
    svc.restart_host()

    # --- set_reliable under a kill plan --------------------------------------
    key = fresh + 100
    owner = int(store.shard_of(key, s_))
    svc.n_writers = 1          # a fault plan addresses one writer chain
    (status, attempts) = timed("set_reliable", lambda: svc.set_reliable(
        key, set_one, faults=faults.FaultPlan.kill_at(10, device=device)))
    if status not in SET_TERMINAL or attempts < 2:
        raise AssertionError(f"set_reliable: status {status} after "
                             f"{attempts} attempts")
    rep = timed("fsck_and_repair", svc.fsck_and_repair)
    if not rep.clean:
        raise AssertionError(f"fsck after set_reliable: {rep}")
    g = svc.get_many(dev(np.asarray([[key]] + [[0]] * (s_ - 1), np.int32)))
    if not bool(g.found[0, 0]) or g.values[0, 0].tolist() != set_one:
        raise AssertionError(f"set_reliable key reads back {g}")
    if tables[owner].set_full(key, set_one) not in SET_TERMINAL:
        raise AssertionError("the host oracle could not place the key")
    require_tables("after set_reliable", tables, svc.keys, svc.vals)
    result.update(service_set_statuses={
        hopscotch.status_name(c): int((res.status.cpu().numpy() == c).sum())
        for c in np.unique(res.status.cpu().numpy())},
        deleted=int(dres.applied.sum()), reliable_attempts=attempts,
        repairs=svc.repairs_applied)

    # --- a small service grows under its own traffic -------------------------
    small = failure.ShardedKVService.start(
        [(1, [1] * v)], n_shards=1, buckets_per_shard=small_buckets,
        val_words=v, device=device)
    small.crash_host()
    small.resize_quantum = 4
    stored = {1: [1] * v}
    t0 = time.perf_counter()
    for step in range(3):
        ks = rng.randint(2, 1 << 20, (1, 6)).astype(np.int32)
        vs = new_values(ks, v)
        r = recorded(walked, lambda: small.set_many(dev(ks), dev(vs)))
        for k, val, a in zip(ks[0], vs[0], r.applied[0].cpu().numpy()):
            if a:
                stored[int(k)] = val.tolist()
        gq = np.asarray([list(stored)], np.int32)
        gg = small.get_many(dev(gq))
        if not bool(gg.found.all()):
            raise AssertionError(f"growth step {step}: a key went missing")
        require_equal(gg.values[0], np.asarray(list(stored.values())),
                      f"growth step {step} values")
    recorded(walked, small.drive_resize)
    if small.resizes_completed < 1:
        raise AssertionError("the small service never grew")
    result["growth_s"] = time.perf_counter() - t0
    result.update(small_resizes=small.resizes_completed,
                  small_buckets_after=int(small.keys.shape[1]))

    # --- the chained second growth (a full doubled frame) --------------------
    k0 = store.keys_homed_at(0, 1, small_buckets)[0]
    chain = failure.ShardedKVService.start(
        [(k0, [5] * v)], n_shards=1, buckets_per_shard=small_buckets,
        val_words=v, device=device)
    nk = np.zeros((1, 2 * small_buckets), np.int32)
    nv = np.zeros((1, 2 * small_buckets, v), np.int32)
    for b in range(2 * small_buckets):
        nk[0, b] = store.keys_homed_at(b, 1, 2 * small_buckets,
                                       start=0x1000)[0]
        nv[0, b] = b + 1
    chain.resize = store.ResizeState(
        chain.keys, chain.vals, dev(nk), dev(nv),
        torch.zeros(1, dtype=torch.int32, device=device))
    chain.crash_host()
    t0 = time.perf_counter()
    recorded(walked, chain._advance_resize)
    result["chained_growth_s"] = time.perf_counter() - t0
    if chain.resize is not None or chain.chained_growths != 1:
        raise AssertionError("the dead end did not chain a second growth")
    all_keys = np.asarray([[k0] + nk[0].tolist()], np.int32)
    gg = chain.get_many(dev(all_keys))
    if not bool(gg.found.all()):
        raise AssertionError("a key went missing in the chained growth")
    result["chained_buckets_after"] = int(chain.keys.shape[1])
    # every walked stage of the services (the 2-lane SET's laps are the
    # racing lanes' route), held to _walk on the same inputs
    result["walked_stages"] = len(require_walked(device, "service",
                                                 walked))
    return result


# ---------------------------------------------------------------------------
# phase 6f: the chain-program toolchain (verifier, ADDLEQ guests, list walks)
# ---------------------------------------------------------------------------

# the fields of BENCH_chains.json's verification.programs rows
SWEEP_FIELDS = ("ok", "errors", "warnings", "waived", "n_wqs", "n_posted",
                "static_wr_bound", "recycled_wqs", "budget",
                "serial_latency_us", "fuel")
# the fields the kernel backend models (it passes the clocks through)
GUEST_FIELDS = ("mem", "head", "tail", "enable_limit", "completions",
                "steps", "halted")


def sweep_rows(device) -> dict:
    """The verifier's sweep of the port's registry, every program built on
    ``device``, in BENCH_chains.json's fields."""
    rows = {}
    for name, rep in analysis.verify_all(device).items():
        row = dict(ok=rep.ok(), errors=len(rep.errors),
                   warnings=len(rep.warnings), waived=len(rep.waived))
        row.update({k: rep.certificates[k] for k in SWEEP_FIELDS[4:]
                    if k in rep.certificates})
        rows[name] = row
    return rows


def random_guest(rng, d: int, i0: int):
    """``tests/test_turing.py``'s random guest: 1-5 instructions over 6
    cells in [-50, 50], jumps to HALT or a valid instruction, and a trap
    instruction on a very negative cell."""
    n_instr = rng.randint(1, 6)
    trap = d + 6
    targets = [turing.HALT_PC] + [i0 + k * turing.INSTR_WORDS
                                  for k in range(n_instr + 1)]
    instrs = [(d + rng.randint(6), d + rng.randint(6),
               targets[rng.randint(len(targets))]) for _ in range(n_instr)]
    instrs.append((trap, trap, turing.HALT_PC))
    cells = {d + k: int(rng.randint(-50, 51)) for k in range(6)}
    cells[trap] = -(1 << 20)
    return turing.AddleqProgram(instrs, cells)


LOOP_GUEST = 9      # addleq_guests' index of the guest that never halts


def addleq_guests(interp, n: int, seed: int) -> list:
    """The demo guests at several inputs, one guest that loops forever
    (index ``LOOP_GUEST``), then seeded random guests up to ``n``."""
    d, i0 = interp.data_base, interp.instr_base
    guests = [turing.guest_countdown(interp, c) for c in (1, 5, 40)]
    guests += [turing.guest_add(interp, x, y)
               for x, y in ((17, 25), (1000, 2345))]
    guests += [turing.guest_multiply(interp, x, y)
               for x, y in ((7, 6), (3, 4), (9, 0), (12, 8))]
    guests.append(turing.AddleqProgram([(d, d + 1, i0)], {d: 0, d + 1: 0}))
    rng = np.random.RandomState(seed)
    while len(guests) < n:
        guests.append(random_guest(rng, d, i0))
    return guests[:n]


def max_sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], check=True,
                         capture_output=True, text=True).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def require_guests(guests, interp, out, budget: int) -> int:
    """Every guest the oracle halts within ``budget`` instructions halted on
    the chain with the oracle's cells; returns how many did."""
    mem, halted = out.mem.cpu().numpy(), out.halted.cpu().numpy()
    i0 = interp.instr_base
    n_halting = 0
    for i, g in enumerate(guests):
        ref, n = turing.addleq_reference(g.instrs, g.data, i0, i0,
                                         max_instrs=budget)
        if n >= budget:
            continue
        n_halting += 1
        if not halted[i]:
            raise AssertionError(f"guest {i} did not halt ({n} instrs)")
        for addr, v in ref.items():
            if mem[i, addr] != v:
                raise AssertionError(f"guest {i}: cell {addr} is "
                                     f"{mem[i, addr]}, the oracle's {v}")
    return n_halting


def guest_drive(device, n_guests: int, budget: int, seed: int,
                time_it: bool) -> dict:
    """A batch of ADDLEQ guests, one interpreter image each, through the
    managed chain kernel (``ChainEngine(spec, "kernel")``) and the
    interpreter on the card, held to each other, to ``addleq_reference``
    and to the fuel."""
    interp = turing.build_interpreter(device=device)
    host = dataclasses.replace(interp, state0=machine.VMState(
        *(a.cpu() for a in interp.state0)))
    guests = addleq_guests(interp, n_guests, seed)
    states = [host.load(g) for g in guests]
    batch = machine.VMState(*(torch.stack(f).to(device)
                              for f in zip(*states)))
    del states
    max_steps = interp.lap_words * (budget + 2)
    chain_ops.launches["run_managed"] = 0
    out_k, k_ms = timed_call(device, lambda: ChainEngine(
        interp.spec, "kernel").run_batch(batch, max_steps))
    launches = read_launches()["run_managed"]
    out_i, i_ms = timed_call(device, lambda: ChainEngine(
        interp.spec).run_batch(batch, max_steps))
    err = 0
    for f in GUEST_FIELDS:
        err = max(err, require_equal(getattr(out_k, f), getattr(out_i, f),
                                     f"guests kernel vs interpreter {f}"))
    n_halting = require_guests(guests, interp, out_k, budget)
    steps = out_k.steps.cpu().numpy()
    if bool(out_k.halted[LOOP_GUEST]) or steps[LOOP_GUEST] != max_steps:
        raise AssertionError(f"the looping guest stopped after "
                             f"{steps[LOOP_GUEST]} steps, not its fuel "
                             f"{max_steps}")
    # the wrapper against its plain version at the drive's shape
    args, kw = kernel_args(interp.spec, batch, max_steps)
    mem_k, stats_k = chain_ops.run_managed(*args, **kw)
    (mem_p, stats_p), plain_ms = timed_call(
        device, lambda: chain_ref.managed_chain_loop(*args, **kw))
    err = max(err, require_equal(mem_k, mem_p, "guests run_managed mem"),
              require_equal(stats_k, stats_p, "guests run_managed stats"))
    instrs = steps // interp.lap_words         # one guest instruction a lap
    result = dict(
        launches=launches, max_abs_err=err, guests=n_guests,
        halting=n_halting, halted=int(out_k.halted.sum()),
        max_steps=max_steps, steps_max=int(steps.max()),
        steps_total=int(steps.sum()), guest_instrs=int(instrs.sum()),
        interp_ms=i_ms, interp_ms_per_step=i_ms / max(1, int(steps.max())),
        engine_ms=k_ms, plain_ms=plain_ms, shape=tuple(batch.mem.shape),
        bound_ms=(2 * batch.mem.numel() + args[1].numel()
                  + args[2].numel() + stats_k.numel()) * 4
        / HBM_BYTES_PER_S * 1e3,
        interp_guest_instrs_per_s=float(instrs.sum()) / i_ms * 1e3)
    if time_it:
        run = lambda: chain_ops.run_managed(*args, **kw)  # noqa: E731
        result["event_ms"] = cuda_ms(run, reps=3)
        prof = device_time(run, 3)
        result["trace_ms"] = prof["device_ms"] if prof[
            "timed_by"] == "trace" else 0.0
        # a full run's trace once held no device time for this kernel (a
        # run of the phase alone did): CUDA events, over a kernel of ~2 ms,
        # then stand in
        result["ms"] = result["trace_ms"] or result["event_ms"]
        # the serial floor: one dependent shared-memory load a step (the
        # walk's words live there), at the card's maximum SM clock; beside
        # it the same steps at one L2 hit each, as a walk in global memory
        cycles = {level: chain_ops.chase_cycles(level, device)
                  for level in chain_ops.CHASE_LEVELS}
        hz = max_sm_clock_hz()
        result["load_cycles"] = cycles
        result["serial_floor_ms"] = (result["steps_max"] * cycles["shared"]
                                     / hz * 1e3)
        result["serial_floor_l2_ms"] = (result["steps_max"] * cycles["l2"]
                                        / hz * 1e3)
        # the looping guest's walk by itself: what one walk costs a step,
        # beside the batch in which thousands of walks share the SMs
        one = [t[LOOP_GUEST:LOOP_GUEST + 1].contiguous() for t in args]
        result["loop_guest_ms"] = cuda_ms(
            lambda: chain_ops.run_managed(*one, **kw), reps=5)
        result["loop_guest_cycles_per_step"] = (
            result["loop_guest_ms"] * 1e-3 * hz / max_steps)
        result["guest_instrs_per_s"] = result["guest_instrs"] / result[
            "ms"] * 1e3
    return result


def list_walks(device, use_break: bool, items, probes, n_iters: int,
               val_len: int):
    off = programs.build_list_traversal(n_iters=n_iters, val_len=val_len,
                                        use_break=use_break, device=device)
    off.set_list(items)
    (vals, out), ms = timed_call(device, lambda: off.get_many(probes))
    return vals, out, ms


def list_drive(device, n_iters: int, val_len: int, n_probes: int,
               seed: int) -> dict:
    """Fig. 12's walks with and without break over one seeded list: every
    position and misses, through ``get_many`` on ``device``; values held to
    the host oracle, steps and ``total_time_us`` to the same batch on the
    CPU, bit for bit."""
    rng = np.random.RandomState(seed)
    keys = rng.choice(np.arange(1, 1 << 20), n_iters, replace=False)
    items = [(int(k), [int(k) * 7 + j for j in range(val_len)])
             for k in keys]
    hits = np.resize(keys, n_probes - n_probes // 4)
    misses = rng.choice(np.arange(1 << 20, 1 << 21), n_probes // 4,
                        replace=False)
    probes = rng.permutation(np.concatenate([hits, misses])).tolist()
    oracle = dict(items)
    want = np.asarray([oracle.get(k, [programs.MISS_SENTINEL] * val_len)
                       for k in probes], np.int32)
    result = dict(probes=n_probes, ms={}, steps_max={})
    steps0 = {}
    for use_break in (False, True):
        mode = "break" if use_break else "plain"
        vals, out, ms = list_walks(device, use_break, items, probes, n_iters,
                                   val_len)
        require_equal(vals, want, f"list walk ({mode}) values")
        cvals, cout, _ = list_walks("cpu", use_break, items, probes,
                                    n_iters, val_len)
        require_equal(out.steps, cout.steps, f"list walk ({mode}) steps")
        require_equal(machine.total_time_us(out).view(torch.int32),
                      machine.total_time_us(cout).view(torch.int32),
                      f"list walk ({mode}) total_time_us bits")
        steps = out.steps.cpu().numpy()
        at0 = steps[np.asarray(probes) == items[0][0]]
        steps0[use_break] = int(at0[0])
        result["ms"][mode] = ms
        result["steps_max"][mode] = int(steps.max())
    result["steps_at_0"] = steps0
    result["break_saves_at_0"] = steps0[False] - steps0[True]
    if result["break_saves_at_0"] <= 0:
        raise AssertionError(f"break saved no steps at position 0: {steps0}")
    return result


def phase_chain_programs(device, n_guests=4096, budget=100, n_iters=8,
                         val_len=2, n_probes=1024, seed=20261017,
                         time_it=True):
    t0 = time.perf_counter()
    result = dict(sweep=sweep_rows(device))
    result["sweep_s"] = time.perf_counter() - t0
    want = json.loads((ROOT / "BENCH_chains.json").read_text())[
        "verification"]["programs"]
    if result["sweep"] != want:
        bad = sorted(n for n in set(want) | set(result["sweep"])
                     if result["sweep"].get(n) != want.get(n))
        raise AssertionError(f"verifier sweep differs from BENCH_chains.json"
                             f" on {bad}")
    result["sweep"] = f"{sum(r['ok'] for r in want.values())}/{len(want)}"
    result["guests"] = guest_drive(device, n_guests, budget, seed, time_it)
    result["lists"] = list_drive(device, n_iters, val_len, n_probes, seed)
    g = result["guests"]
    result.update(launches=g["launches"], max_abs_err=g["max_abs_err"])
    return result


# ---------------------------------------------------------------------------
# phase 6g: the MemC3-style cuckoo table's batched get
# ---------------------------------------------------------------------------

def cuckoo_values(keys: np.ndarray, val_words: int) -> np.ndarray:
    k = keys.astype(np.int64)
    cols = (k, k * 3 + 1, k ^ 0x5A5A5A5A, -k)
    return np.stack(cols[:val_words], 1).astype(np.int32)


def phase_cuckoo_get(device, log2_buckets=18, ways=4, val_words=4,
                     load=0.9, n_queries=65536, seed=5, time_it=True):
    """A MemC3-layout table filled to ``load`` by the host insert, moved to
    ``device`` and probed by one batched ``lookup``: half stored keys, half
    absent, and key 0, held to a host dict and to the CPU's lookup."""
    n_buckets = 1 << log2_buckets
    n_keys = int(n_buckets * ways * load)
    rng = np.random.RandomState(seed)
    keys = np.unique(rng.randint(1, 1 << 30, size=n_keys + n_keys // 8))
    keys = rng.permutation(keys)[:n_keys]
    vals = cuckoo_values(keys, val_words)
    tbl = cuckoo.make_table(n_buckets, val_words, ways)
    t0 = time.perf_counter()
    tbl.memo_kicks(keys)
    failed = sum(not tbl.insert(k, v) for k, v in zip(keys.tolist(), vals))
    fill_s = time.perf_counter() - t0
    # a failed insert drops the last key of its kick chain
    resident = set(tbl.keys[tbl.keys != cuckoo.EMPTY].tolist())
    oracle = {k: v for k, v in zip(keys.tolist(), vals.tolist())
              if k in resident}
    absent = rng.randint(1 << 30, (1 << 31) - 1, size=n_queries // 2)
    absent[0] = cuckoo.EMPTY
    q = rng.permutation(np.concatenate([
        rng.choice(keys, n_queries - n_queries // 2), absent])).astype(
        np.int32)
    # key 0 hits any empty way of its buckets (the reference's rule)
    zero_found = bool((tbl.keys[[cuckoo.h1(0, n_buckets),
                                 cuckoo.h2(0, n_buckets)]] == 0).any())
    want_found = np.asarray([k in oracle or (k == 0 and zero_found)
                             for k in q.tolist()])
    want_vals = np.asarray([oracle.get(k, [0] * val_words)
                            for k in q.tolist()], np.int32)
    dk, dv = tbl.as_device(device)
    qd = torch.from_numpy(q).to(device)
    found, out = cuckoo.lookup(dk, dv, qd)
    require_equal(found, want_found, "cuckoo found")
    err = require_equal(out, want_vals, "cuckoo values")
    ck, cv = tbl.as_device("cpu")
    cfound, cout = cuckoo.lookup(ck, cv, torch.from_numpy(q))
    require_equal(found, cfound, "cuckoo found, card vs CPU")
    require_equal(out, cout, "cuckoo values, card vs CPU")
    table_bytes = dk.numel() * 4 + dv.numel() * 4
    # each query reads its two buckets' keys and values once and writes
    # its found flag and value row
    per_query = 4 + 2 * ways * 4 * (1 + val_words) + 1 + val_words * 4
    result = dict(buckets=n_buckets, ways=ways, val_words=val_words,
                  keys=n_keys, failed_inserts=failed,
                  resident=len(resident), fill_s=fill_s, queries=n_queries,
                  hits=int(found.sum()), max_abs_err=err,
                  table_bytes=table_bytes,
                  bound_ms=n_queries * per_query / HBM_BYTES_PER_S * 1e3)
    if time_it:
        result["ms"] = cuda_ms(lambda: cuckoo.lookup(dk, dv, qd), reps=20)
        result["lookups_per_s"] = n_queries / result["ms"] * 1e3
    return result


# ---------------------------------------------------------------------------
# phase 7: LM prefill (and decode continuing it)
# ---------------------------------------------------------------------------

def path_launches(cfg, device):
    """The kernel launches one prefill and one decode step of ``cfg``'s
    model make: a flash-attention launch per attention layer, per encoder
    layer and per cross-attention layer, a WKV6 launch per RWKV6 layer, an
    RG-LRU launch per recurrent layer, and a decode launch per attention
    and cross-attention layer and step (none on the CPU, where the plain
    versions run)."""
    kinds = [cfg.layer_type(i) for i in range(cfg.num_layers)]
    n_attn = sum(k in transformer.ATTN_KINDS for k in kinds)
    n_cross = cfg.num_layers if cfg.cross_attention else 0
    on = int(torch.device(device).type == "cuda")
    prefill = {"flash_attention": on * (n_attn + cfg.num_encoder_layers
                                        + n_cross),
               "wkv6": on * kinds.count("rwkv"),
               "rglru": on * kinds.count("recurrent")}
    return prefill, {"decode_partial": on * (n_attn + n_cross)}


def flash_variant_launches(cfg, device) -> dict:
    """The flash-attention launches of one prefill of ``cfg``'s model by
    kernel: every one of the kernel that ``variant`` picks for the model's
    type and head dim (none on the CPU)."""
    n = path_launches(cfg, device)[0]["flash_attention"]
    kind = fa_ops.variant(getattr(torch, cfg.dtype), cfg.head_dim) if n \
        else None
    return {f"flash_attention.{v}": n if v == kind else 0
            for v in ("wgmma", "fma")}


def rglru_variant_launches(cfg, device) -> dict:
    """The RG-LRU launches of one prefill of ``cfg``'s model by kernel:
    every one of the kernel that ``variant`` picks for the float32 a and u
    that the recurrent layers pass at the LRU width (none on the CPU)."""
    n = path_launches(cfg, device)[0]["rglru"]
    kind = rg_ops.variant(torch.float32, cfg.lru_width or cfg.d_model) \
        if n else None
    return {f"rglru.{v}": n if v == kind else 0 for v in ("ring", "direct")}


def decode_kernel_launches(cfg, device) -> dict:
    """The decode-attention launches of one decode step of ``cfg``'s model
    by kernel: one split and one combine launch per attention layer (none
    on the CPU)."""
    n = path_launches(cfg, device)[1]["decode_partial"]
    return {"decode_partial.split": n, "decode_partial.combine": n}


def require_launches(want: dict, what: str) -> dict:
    got = read_launches()
    got = {k: got[k] for k in want}
    if got != want:
        raise AssertionError(f"{what} launched {got}, expected {want}")
    return got


def last_attention_cache(cfg, caches, lengths):
    """The last self-attention layer's cache as its decode step reads it:
    ({'k', 'v'} in the model's type (an int8 cache dequantized), the
    lengths and the window the decode kernel gets (a rolling cache:
    min(lengths, window), no window)); (None, lengths, 0) if the model has
    no attention layer."""
    for i in reversed(range(cfg.num_layers)):
        kind = cfg.layer_type(i)
        if kind not in transformer.ATTN_KINDS:
            continue
        c = caches[i]
        k, v = c["k"], c["v"]
        if "ks" in c:
            dt = model_layers.dtype_of(cfg)
            k = attention.dequantize_kv(k, c["ks"], dt)
            v = attention.dequantize_kv(v, c["vs"], dt)
        window = cfg.window if kind == "local" else 0
        if window and cfg.window_cache and k.shape[2] == window:
            return dict(k=k, v=v), torch.clamp(lengths, max=window), 0
        return dict(k=k, v=v), lengths, window
    return None, lengths, 0


def frontend_inputs(cfg, batch: int, prompt: int, device) -> dict:
    """The frontend stubs a drive's batch carries, seeded on the device:
    'patches' (B, frontend_tokens, frontend_dim) for a vision model,
    'frames' (B, prompt, frontend_dim) for an encoder-decoder, float32."""
    gen = torch.Generator(device=device).manual_seed(1)
    out = {}
    if cfg.is_encdec:
        out["frames"] = torch.randn((batch, prompt, cfg.frontend_dim),
                                    generator=gen, device=device)
    if cfg.frontend == "vision" and cfg.frontend_tokens:
        out["patches"] = torch.randn(
            (batch, cfg.frontend_tokens, cfg.frontend_dim), generator=gen,
            device=device)
    return out


def lm_drive(device, cfg, params, batch=4, prompt=2048, extra=8, s_max=None,
             time_it=True):
    """The prompt pass of ``batch`` seeded prompts (after the seeded
    patches of a vision model; with the seeded frames of an
    encoder-decoder, which every decode step's cross-attention reads
    whole), then ``extra`` decode steps continuing them, and one
    ``forward`` over the whole ``prompt + extra`` tokens; the prefill's
    last logits are held against it.  Returns (the result, {"tokens",
    "decoded" (B, extra, V), "forward" (the same rows of ``forward``)},
    both float32)."""
    want_prefill, want_step = path_launches(cfg, device)
    want_variants = flash_variant_launches(cfg, device)
    want_rglru = rglru_variant_launches(cfg, device)
    dt = params.embed.embedding.dtype
    rng = np.random.RandomState(0)
    toks = torch.from_numpy(rng.randint(1, cfg.vocab_size, (
        batch, prompt + extra)).astype(np.int32)).to(device)
    inputs = frontend_inputs(cfg, batch, prompt, device)
    n_front = inputs["patches"].shape[1] if "patches" in inputs else 0
    enc_lengths = (torch.full((batch,), prompt, dtype=torch.int32,
                              device=device) if cfg.is_encdec else None)
    prompt_batch = dict(inputs, tokens=toks[:, :prompt])
    prefill_step = train_loop.make_prefill_step(
        cfg, s_max=s_max or n_front + prompt + 64)
    serve_step = train_loop.make_serve_step(cfg)
    if time_it:
        torch.cuda.reset_peak_memory_stats()
    sync(device)
    reset_launches()
    t0 = time.perf_counter()
    last, caches, lengths = prefill_step(params, prompt_batch)
    sync(device)
    first_s = time.perf_counter() - t0
    prefill_launches = require_launches(want_prefill, "the prefill")
    flash_variants = require_launches(want_variants,
                                      "the prefill's flash kernels")
    rglru_variants = require_launches(want_rglru,
                                      "the prefill's RG-LRU kernels")
    step_ms, decoded = [], []
    reset_launches()
    for i in range(extra):
        t0 = time.perf_counter()
        lengths = lengths + 1
        logits, caches = serve_step(params, toks[:, prompt + i], caches,
                                    lengths, enc_lengths)
        sync(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        decoded.append(logits.float())
    decode_launches = require_launches(
        {k: n * extra for k, n in {**want_step, **decode_kernel_launches(
            cfg, device)}.items()}, f"{extra} decode steps")["decode_partial"]
    if logits.shape != (batch, cfg.padded_vocab):
        raise AssertionError(f"decode logits {tuple(logits.shape)}")
    if not bool(torch.isfinite(torch.stack(decoded)).all()):
        raise AssertionError("non-finite decoded logits")
    if int(lengths[0]) != n_front + prompt + extra:
        raise AssertionError(f"lengths {lengths.tolist()} do not count the "
                             f"{n_front} patches")
    cache, cache_lengths, window = last_attention_cache(cfg, caches, lengths)
    cache_errs = None if cache is None else require_cache_decode(
        cache, cache_lengths, cfg.num_heads, "decode on the prefill cache",
        window=window)
    full, _, aux = model_lib.forward(params, dict(inputs, tokens=toks), cfg)
    err_prefill = require_close(last, full[:, n_front + prompt - 1],
                                LOGIT_TOL[dt],
                                "prefill last logits vs forward")
    rows = dict(tokens=toks, decoded=torch.stack(decoded, 1),
                forward=full[:, n_front + prompt:].float().clone())
    del full
    result = dict(arch=cfg.name, batch=batch, prompt=prompt,
                  frontend_positions=n_front, decode_steps=extra,
                  forward_aux=float(aux),
                  prefill_launches=prefill_launches,
                  flash_launches=prefill_launches["flash_attention"],
                  flash_variant_launches=flash_variants,
                  rglru_variant_launches=rglru_variants,
                  decode_launches=decode_launches,
                  max_abs_err_prefill=err_prefill, logit_tol=LOGIT_TOL[dt],
                  cache_decode_errs=cache_errs, first_prefill_s=first_s,
                  decode_step_ms=step_ms)
    if time_it:
        sync(device)
        t0 = time.perf_counter()
        prefill_step(params, prompt_batch)
        sync(device)
        result["prefill_s"] = time.perf_counter() - t0
        result["prefill_tokens_per_s"] = (batch * (n_front + prompt)
                                          / result["prefill_s"])
        result["decode_ms_per_step_median"] = float(np.median(step_ms))
        result["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        prof = device_profile(lambda: prefill_step(params, prompt_batch), 1)
        prof["idle_share"] = 1 - prof["device_ms"] / (result["prefill_s"]
                                                      * 1e3)
        result["prefill_profile"] = prof
        prof = device_profile(lambda: serve_step(
            params, toks[:, prompt + extra - 1], caches, lengths,
            enc_lengths), 3)
        prof["idle_share"] = 1 - (prof["device_ms"]
                                  / result["decode_ms_per_step_median"])
        result["decode_profile"] = prof
        result["decode_kernel_ms_per_step"] = prof["by_group_ms"][
            "decode_attention"]
    return result, rows


def phase_lm_prefill(device, cfg, params, batch=4, prompt=2048, extra=8,
                     s_max=None, time_it=True):
    """``lm_drive``, with the last decoded logits also held against
    ``forward`` at LOGIT_TOL.  The drive's rows are kept under "rows"."""
    result, rows = lm_drive(device, cfg, params, batch, prompt, extra, s_max,
                            time_it)
    result["max_abs_err_decode"] = require_close(
        rows["decoded"][:, -1], rows["forward"][:, -1], result["logit_tol"],
        "decoded last logits vs forward")
    result["rows"] = rows
    return result


def decoded_rows(cfg, params, toks, prompt: int, s_max: int):
    """Prefill ``toks[:, :prompt]``, decode the rest; the decoded logits
    (B, steps, V) float32."""
    last, caches, lengths = train_loop.make_prefill_step(cfg, s_max=s_max)(
        params, {"tokens": toks[:, :prompt]})
    serve_step = train_loop.make_serve_step(cfg)
    out = []
    for i in range(prompt, toks.shape[1]):
        lengths = lengths + 1
        logits, caches = serve_step(params, toks[:, i], caches, lengths)
        out.append(logits.float())
    return torch.stack(out, 1)


class planted_state_fault:
    """A decode fault planted for a control run: each one-token recurrence
    step (WKV6's and RG-LRU's) hands on ``kind`` of state instead of the
    one it computed: "stale" the state it was given, "zero" zeros."""

    def __init__(self, kind: str):
        self.kind = kind

    def _plant(self, fn):
        def step(*args):
            out, new = fn(*args)
            new = args[-1] if self.kind == "stale" else torch.zeros_like(new)
            return out, new
        return step

    def __enter__(self):
        self.saved = [(m, m.__dict__[n]) for m, n in (
            (wkv_ops, "wkv6_decode_step"), (rg_ops, "rglru_decode_step"))]
        for m, fn in self.saved:
            setattr(m, fn.__name__, self._plant(fn))
        return self

    def __exit__(self, *exc):
        for m, fn in self.saved:
            setattr(m, fn.__name__, fn)


class recorded_routes:
    """Records the experts each MoE layer chooses (``moe.route``'s idx_k,
    (T, k)), call by call."""

    def __enter__(self):
        self.routes, self.dropped, self.saved = [], [], moe.route

        def route(logits, cfg):
            r = self.saved(logits, cfg)
            self.routes.append(r.idx_k)
            self.dropped.append(int((~r.ok).sum()))
            return r
        moe.route = route
        return self

    def __exit__(self, *exc):
        moe.route = self.saved


def route_agreement(cfg, params, toks, prompt: int, s_max: int) -> dict:
    """The experts prefill and each decode step choose, against those
    ``forward`` over the same tokens chooses, per (layer, token): the
    share that agree, and the decoded logits' largest distance from
    ``forward``'s in the rows whose routes agreed at every layer and step
    so far, and in the rest."""
    b, n = toks.shape
    with recorded_routes() as fwd:
        full, _, _ = model_lib.forward(params, {"tokens": toks}, cfg)
    with recorded_routes() as dec:
        decoded = decoded_rows(cfg, params, toks, prompt, s_max)
    n_moe = len(fwd.routes)
    want = torch.stack([r.reshape(b, n, -1) for r in fwd.routes])
    pre = torch.stack([r.reshape(b, prompt, -1)
                       for r in dec.routes[:n_moe]])
    steps = torch.stack(dec.routes[n_moe:]).reshape(n - prompt, n_moe, b, -1)
    # (token, expert) pairs past their expert's capacity, which the layer
    # drops: forward's, prefill's, and the decode steps' in all
    dropped = dict(forward=sum(fwd.dropped),
                   prefill=sum(dec.dropped[:n_moe]),
                   decode=sum(dec.dropped[n_moe:]),
                   forward_pairs=b * n * cfg.experts_per_token * n_moe)
    same = (steps == want[:, :, prompt:].permute(2, 0, 1, 3)).all(-1)
    clean = same.all(1).int().cumprod(0).bool()        # (steps, B)
    err = (decoded - full[:, prompt:].float()).abs().amax(-1).T
    return dict(
        prefill_agree=float((pre == want[:, :, :prompt]).all(-1)
                            .float().mean()),
        decode_agree=float(same.float().mean()),
        decode_flips=int((~same).sum()),
        max_abs_err_agreeing=float(err[clean].max()) if clean.any()
        else None,
        max_abs_err_after_flip=float(err[~clean].max()) if (~clean).any()
        else None, dropped=dropped)


# ---------------------------------------------------------------------------
# phase 8: LM serving (ServeEngine decode ticks)
# ---------------------------------------------------------------------------

def phase_lm_serve(device, cfg, params, s_max=4096, n_slots=8, ticks=32,
                   crash_at=16, time_it=True):
    """Admission of a client mix, the admitted requests in slots (the rest
    idle at length 0), ``ticks`` decode ticks with the host driver crashed
    at ``crash_at``."""
    layers = path_launches(cfg, device)[1]["decode_partial"]
    pair = decode_kernel_launches(cfg, device)
    if time_it:
        torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(cfg, params, s_max=s_max, n_slots=n_slots, burst=4.0,
                      device=device)
    mix = [0, 0, 0, 0, 0, 0, 1, 2][:n_slots]
    admitted = eng.admit(mix)
    want = [True] * 4 + [False] * 2 + [True] * 2
    if admitted != want[:n_slots]:
        raise AssertionError(f"admission {admitted}, expected {want}")
    rng = np.random.RandomState(1)
    slots = 0
    for client, ok in zip(mix, admitted):
        if ok:
            eng.add_request(slots, client, int(rng.randint(1,
                                                           cfg.vocab_size)))
            slots += 1
    finite = []
    serve = eng._serve

    def checked_serve(*args):
        logits, caches = serve(*args)
        finite.append(torch.isfinite(logits).all())
        return logits, caches
    eng._serve = checked_serve

    sync(device)
    reset_launches()
    per_tick, tick_ms, tokens = [], [], []
    t_start = time.perf_counter()
    for tick in range(ticks):
        if tick == crash_at:
            eng.crash_host_driver()
        t0 = time.perf_counter()
        tokens.append(eng.step())          # reads the tokens back: a sync
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        per_tick.append(read_launches()["decode_partial"])
    wall = time.perf_counter() - t_start
    tokens = np.stack(tokens)
    launches = [b - a for a, b in zip([0] + per_tick[:-1], per_tick)]
    if launches != [layers] * ticks:
        raise AssertionError(f"decode_partial launches per tick {launches}, "
                             f"expected {layers}")
    pair = require_launches({k: n * ticks for k, n in pair.items()},
                            f"{ticks} serving ticks")
    if not all(bool(f) for f in finite):
        raise AssertionError("non-finite logits in a serving tick")
    if tokens.min() < 0 or tokens.max() >= cfg.padded_vocab:
        raise AssertionError("a sampled token lies outside the vocab")
    if eng.host_alive() or eng.stats["steps"] != ticks or \
            eng.stats["tokens"] != slots * ticks:
        raise AssertionError(f"serving did not continue after the crash: "
                             f"{eng.stats}")
    want_lengths = [1 + ticks] * slots + [0] * (n_slots - slots)
    if eng.lengths.cpu().tolist() != want_lengths:
        raise AssertionError(f"lengths {eng.lengths.tolist()}")
    cache, cache_lengths, window = last_attention_cache(cfg, eng.caches,
                                                        eng.lengths)
    cache_errs = None if cache is None else require_cache_decode(
        cache, cache_lengths, cfg.num_heads, "decode on the serving cache",
        window=window)
    result = dict(slots=n_slots, active=slots, s_max=s_max, ticks=ticks,
                  crash_at=crash_at, admitted=admitted,
                  decode_launches=per_tick[-1],
                  decode_kernel_launches=pair, stats=dict(eng.stats),
                  cache_decode_errs=cache_errs)
    if time_it:
        result["tokens_per_s"] = slots * ticks / wall
        result["ms_per_tick_mean"] = wall * 1e3 / ticks
        result["ms_per_tick_median"] = float(np.median(tick_ms))
        result["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        prof = device_profile(eng.step, 3)
        prof["idle_share"] = 1 - (prof["device_ms"]
                                  / result["ms_per_tick_median"])
        result["tick_profile"] = prof
    return result


# ---------------------------------------------------------------------------
# phases 9-10: the attention kernels against their plain versions
# ---------------------------------------------------------------------------

def random_qkv(device, seed, dtype, b, h, kh, sq, sk, d):
    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dtype)
    return rnd(b, h, sq, d), rnd(b, kh, sk, d), rnd(b, kh, sk, d)


# The flash kernel's timed shapes: the prefill attention of three models
# whose prefill runs it, B 4 x 2,048 prompt positions: (name, b, h, kh, s,
# d, window).  At S = 2,048 griffin's window of 2,048 binds nothing, so
# SDPA with is_causal=True, enable_gqa=True computes the same function.
# phi-3-vision's head dim 96 takes the tensor-core kernel in bf16 (a 64-
# and a 32-column box for Q and K) and the CUDA-core one in float32.
FLASH_SHAPES = (("qwen3-1.7b", 4, 16, 8, 2048, 128, 0),
                ("recurrentgemma-9b", 4, 16, 1, 2048, 256, 2048),
                ("phi-3-vision-4.2b", 4, 32, 32, 2048, 96, 0))
# ragged bf16 causal cases at each shape's heads: (sq, sk, q_offset)
FLASH_RAGGED = ((1025, 1025, 0), (77, 333, 256))
BOTH_DTYPES = (torch.bfloat16, torch.float32)


def flash_timing(device, b, h, kh, s, d, window, time_it=True) -> dict:
    """The bound of one causal (windowed) prefill attention at this shape
    and, with ``time_it``, the bf16 and float32 kernels' times beside the
    plain version's and SDPA's."""
    q, k, v = random_qkv(device, 0, torch.bfloat16, b, h, kh, s, s, d)
    pairs = int(fa_ref.visible_mask(s, s, "cpu", window=window).sum())
    flops = 4.0 * b * h * d * pairs                  # the visible (q, k)
    nbytes = 2.0 * (2 * q.numel() + 2 * k.numel())   # q, k, v, out
    result = dict(shape=(b, h, kh, s, s, d, window), flops=flops,
                  bound_ms=max(flops / BF16_FLOP_PER_S,
                               nbytes / HBM_BYTES_PER_S) * 1e3,
                  bound_by=("operations" if flops / BF16_FLOP_PER_S
                            >= nbytes / HBM_BYTES_PER_S else "bytes"))
    if time_it:
        kw = dict(window=window)
        result["ms"] = cuda_ms(lambda: fa_ops.flash_attention(q, k, v, **kw),
                               reps=10)
        result["tflop_per_s"] = flops / (result["ms"] * 1e-3) / 1e12
        result["plain_ms"] = cuda_ms(
            lambda: fa_ref.attention_reference(q, k, v, **kw), reps=2)
        result["library_ms"] = cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True),
            reps=10) if window == 0 or window >= s else None
        q, k, v = (t.float() for t in (q, k, v))
        result["float32_ms"] = cuda_ms(
            lambda: fa_ops.flash_attention(q, k, v, **kw), reps=2)
    return result


def phase_flash_kernel(device, shapes=FLASH_SHAPES, time_it=True):
    """The flash kernel against its plain version at each of ``shapes``:
    causal with the shape's window in bf16 and float32, at the first shape
    also windowed (S / 4) and in length mode, and the FLASH_RAGGED cases in
    bf16; then ``flash_timing`` at each.  The first shape's numbers are the
    kernel's row."""
    errs, timed = {}, {}
    for si, (name, b, h, kh, s, d, window) in enumerate(shapes):
        rng = np.random.RandomState(3)
        lengths = torch.from_numpy(np.sort(rng.randint(1, s + 1, b)).astype(
            np.int32)).to(device)
        cases = [  # case, (b, sq, sk), kwargs, types
            ("causal", (b, s, s), dict(mode="causal", window=window),
             BOTH_DTYPES)]
        if si == 0:
            cases += [
                ("window", (1, s, s), dict(mode="causal", window=s // 4),
                 BOTH_DTYPES),
                ("length", (b, 16, s), dict(mode="length", lengths=lengths),
                 BOTH_DTYPES)]
        cases += [(f"ragged{sq}x{sk}+{off}", (b, sq, sk),
                   dict(mode="causal", q_offset=off), (torch.bfloat16,))
                  for sq, sk, off in FLASH_RAGGED]
        for i, (case, (bb, sq, sk), kw, dtypes) in enumerate(cases):
            for dtype in dtypes:
                q, k, v = random_qkv(device, i, dtype, bb, h, kh, sq, sk, d)
                got = fa_ops.flash_attention(q, k, v, **kw)
                want = fa_ref.attention_reference(q, k, v, **kw)
                key = f"{name}/{case}/{str(dtype)[6:]}"
                errs[key] = require_close(got, want, TOL[dtype],
                                          f"flash {key}")
                del got, want
        timed[name] = flash_timing(device, b, h, kh, s, d, window, time_it)
    first = shapes[0][0]
    return dict(timed[first], max_abs_err=errs[f"{first}/causal/bfloat16"],
                errs=errs, shapes=timed)


def require_partial_close(got, want, tol: float, what: str) -> dict:
    """Hold a decode partial (acc, m, l) to the plain one; returns the max
    errors.  acc and l both carry the factor exp(-m), and m, a max of dot
    products rounded in another order, differs from the plain version's by
    ulps, which moves the un-normalised acc (of size up to l) by more than
    the limit.  So both are divided by the plain version's l (acc / l is
    the attention output); m is held as it is."""
    (acc, m, l), (pa, pm, pl) = got, want
    unit = pl.clamp(min=1e-30)
    return dict(
        acc=require_close(acc / unit, pa / unit, tol, f"{what}: acc / l"),
        l=require_close(l / unit, pl / unit, tol, f"{what}: l / l"),
        m=require_close(m, pm, tol, f"{what}: m"))


def require_cache_decode(cache, lengths, n_heads: int, what: str,
                         window: int = 0) -> dict:
    """The decode kernel on a layer's cache as the main path left it, at
    the path's lengths and window, against its plain version, with a
    seeded query; a row of length 0 (an idle slot) must give acc 0 and
    l 0."""
    k, v = cache["k"], cache["v"]
    gen = torch.Generator(device=k.device).manual_seed(6)
    q = torch.randn((k.shape[0], n_heads, 1, k.shape[3]), generator=gen,
                    device=k.device).to(k.dtype)
    got = dec_ops.decode_partial(q, k, v, lengths, window=window)
    errs = require_partial_close(
        got, dec_ref.decode_partial_reference(q, k, v, lengths,
                                              window=window), DECODE_TOL,
        what)
    idle = lengths == 0
    if bool((got[0][idle] != 0).any() | (got[2][idle] != 0).any()):
        raise AssertionError(f"{what}: an idle row gives a non-zero partial")
    errs["idle_rows"] = int(idle.sum())
    errs["window"] = window
    return errs


def planted_fault_err(q, k, v, lengths, want, tol: float) -> float:
    """The check against a faulty partial that read only the first half of
    each sequence's rows: raises unless the check rejects it, and returns
    its largest acc / l error."""
    fault = dec_ref.decode_partial_reference(q, k, v, (lengths + 1) // 2)
    unit = want[2].clamp(min=1e-30)
    err = float((fault[0] / unit - want[0] / unit).abs().max())
    try:
        require_partial_close(fault, want, tol, "planted fault")
    except AssertionError:
        return err
    raise AssertionError("the decode check passes a partial that dropped "
                         "half of each sequence's rows")


# The decode kernel's shapes: (name, b, h, kh, s, d, window, lengths):
# a 32,768-long cache (B 16, 16 / 8 heads of 128) with lengths spread over
# [1, S], and recurrentgemma-9b's decode step as the lm_griffin drive runs
# it (B 4, 16 query heads on 1 KV head of 256, s_max 4,096, window 2,048,
# lengths 2,049-2,056, past the window), and phi-3-vision's (B 4, 32 heads
# of 96, s_max 4,096, the lengths of 2,048 prompt positions and 8 steps).
DECODE_SHAPES = (("32k", 16, 16, 8, 32768, 128, 0, (1, 32768)),
                 ("recurrentgemma-9b", 4, 16, 1, 4096, 256, 2048,
                  (2049, 2056)),
                 ("phi-3-vision-4.2b", 4, 32, 32, 4096, 96, 0,
                  (2049, 2056)))


def decode_lengths(device, b: int, span) -> torch.Tensor:
    """Seeded lengths in [lo, hi], the first lo and the last hi."""
    lo, hi = span
    rng = np.random.RandomState(4)
    ln = rng.randint(lo, hi + 1, b)
    ln[0], ln[-1] = lo, hi
    return torch.from_numpy(ln.astype(np.int32)).to(device)


def device_time(fn, reps: int, kernels=()) -> dict:
    """``device_profile`` of ``fn`` after one warm-up call: the device time
    per call (all its kernels) from a torch.profiler trace, where CUDA
    events around a kernel shorter than its wrapper's host work would time
    the host.  In a full run the profiler now and then records no device
    activity at all: such a trace is taken again, twice at most, and after
    that CUDA events around the calls stand in (``timed_by`` says which),
    so that no time reads 0."""
    fn()
    for _ in range(3):
        prof = device_profile(fn, reps, kernels)
        if prof["device_ms"] > 0:
            return dict(prof, timed_by="trace")
    return dict(device_ms=cuda_ms(fn, reps), by_group_ms=None,
                device_ops=None, by_kernel_ms={k: None for k in kernels},
                timed_by="events")


DECODE_KERNELS = ("decode_split_kernel", "decode_combine_kernel")


def decode_timing(device, q, k, v, lengths, window, time_it=True) -> dict:
    """The bytes bound of one decode partial (the visible K and V rows, q
    and the outputs) and, with ``time_it``, the kernel pair's, the plain
    version's and SDPA's device times per call."""
    b, h, _, d = q.shape
    kh, s = k.shape[1], k.shape[2]
    ln = lengths.long()
    lo = (ln - window).clamp(min=0) if window > 0 else torch.zeros_like(ln)
    visible = int((ln.clamp(max=s) - lo).clamp(min=0).sum())
    nbytes = (2.0 * visible * kh * d * k.element_size()  # visible K, V rows
              + q.numel() * q.element_size() + b * h * (d + 2) * 4)
    result = dict(shape=(b, h, kh, s, d, window), visible_rows=visible,
                  splits=dec_ops.plan_splits(b, kh, s),
                  bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    if time_it:
        kw = dict(window=window)
        prof = device_time(
            lambda: dec_ops.decode_partial(q, k, v, lengths, **kw), 20,
            DECODE_KERNELS)
        result["ms"] = prof["device_ms"]
        result["timed_by"] = prof["timed_by"]
        result["by_kernel_ms"] = prof["by_kernel_ms"]
        result["plain_ms"] = device_time(
            lambda: dec_ref.decode_partial_reference(q, k, v, lengths, **kw),
            2)["device_ms"]
        pos = torch.arange(s, device=device)[None, None, None, :]
        ln4 = lengths[:, None, None, None]
        mask = (pos < ln4) & (pos >= ln4 - window) if window > 0 \
            else pos < ln4
        result["library_ms"] = device_time(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True), 20)["device_ms"]
        result["gb_per_s"] = nbytes / (result["ms"] * 1e-3) / 1e9
    return result


def phase_decode_kernel(device, shapes=DECODE_SHAPES, time_it=True):
    """The decode kernel against its plain version at each of ``shapes``,
    float32 and bf16, whole and as two ``kpos_offset`` shards; at the
    first shape also a planted fault (half of each sequence's rows
    dropped) that the check must reject.  Then ``decode_timing`` of the
    bf16 cache at each.  The first shape's numbers are the kernel's row."""
    errs, timed = {}, {}
    for si, (name, b, h, kh, s, d, window, span) in enumerate(shapes):
        lengths = decode_lengths(device, b, span)
        for dtype in (torch.float32, torch.bfloat16):
            t = f"{name}/{str(dtype)[6:]}"
            q, k, v = random_qkv(device, 5, dtype, b, h, kh, 1, s, d)
            want = dec_ref.decode_partial_reference(q, k, v, lengths,
                                                    window=window)
            got = dec_ops.decode_partial(q, k, v, lengths, window=window)
            for part, err in require_partial_close(
                    got, want, DECODE_TOL, f"decode {t}").items():
                errs[f"{t}/{part}"] = err
            # two shards of the cache, each with its kpos_offset, combined
            half = s // 2
            parts = [dec_ops.decode_partial(
                q, k[:, :, i * half:(i + 1) * half],
                v[:, :, i * half:(i + 1) * half], lengths, window=window,
                kpos_offset=i * half) for i in range(2)]
            errs[f"{t}/shards"] = require_close(
                dec_ops.combine_partials(parts),
                want[0] / want[2].clamp(min=1e-30), DECODE_TOL,
                f"decode 2 shards {t}")
            if si == 0 and dtype == torch.bfloat16:
                fault_err = planted_fault_err(q, k, v, lengths, want,
                                              DECODE_TOL)
            del got, want, parts
        timed[name] = decode_timing(device, q, k, v, lengths, window,
                                    time_it)
        del q, k, v
    first = shapes[0][0]
    return dict(timed[first], max_abs_err=errs[f"{first}/bfloat16/acc"],
                errs=errs, tol=DECODE_TOL, planted_fault_err=fault_err,
                shapes=timed)


# ---------------------------------------------------------------------------
# phases 11-12: the recurrent LM paths (rwkv6-7b, recurrentgemma-9b)
# ---------------------------------------------------------------------------

def check_wkv6_layer(r, k, v, w, u) -> dict:
    """The WKV6 kernel on one layer's own inputs against the plain float32
    scan and a float64 scan; the errors, also on the state rows of the
    channels whose decay over a 32-step chunk leaves the chunked form's
    range, and the share of such channels."""
    dt = r.dtype
    o, s = wkv_ops.wkv6(r, k, v, w, u)
    po, ps = wkv_ref.wkv6_reference(r, k, v, w, u)
    do, ds = wkv_ref.wkv6_reference(*(x.double() for x in (r, k, v, w, u)))
    small = 32 * torch.log(w).abs() > CHUNK_LOG_RANGE      # (B, H, T, N)
    rows = small.any(dim=2)                                 # (B, H, N)
    out = dict(
        shape=tuple(r.shape), dtype=str(dt)[6:],
        o_vs_plain=require_close(o, po, REC_TOL[dt], "layer-0 o vs plain"),
        s_vs_plain=require_close(s, ps, STATE_TOL, "layer-0 S vs plain"),
        o_vs_f64=require_close(o, do, REC_TOL[dt], "layer-0 o vs float64"),
        s_vs_f64=require_close(s, ds, STATE_TOL, "layer-0 S vs float64"),
        small_decay_share=float(small.float().mean()),
        small_decay_channel_share=float(small.any(dim=(0, 2)).float()
                                        .mean()),
        w_min=float(w.min()))
    if bool(rows.any()):
        out["s_vs_f64_small_decay_rows"] = float(
            (s.double() - ds).abs()[rows].max())
    return out


def layer0_wkv6_inputs(cfg, params, tokens):
    """Layer 0's WKV6 inputs (r, k, v, w, u) for ``tokens``, as its
    ``time_mix`` forms them in the prefill."""
    blk = params.decoder[0]
    x = model_layers.embed_tokens(params.embed, tokens, cfg)
    h = model_layers.rms_norm(x, blk.norm1, cfg.norm_eps)
    r, k, v, w, _ = rwkv.time_mix_inputs(blk.mix, h, cfg)
    return r, k, v, w, blk.mix.u


def decode_witness(rows, truth, controls: dict) -> dict:
    """The bf16 decoded logits against float32 ``forward`` of the same
    weights (``truth``), within WITNESS_K times bf16 ``forward``'s own
    distance from it on the same rows; each control's decoded logits must
    fall outside that limit."""
    floor = float((rows["forward"] - truth).abs().max())
    if not floor > 0:
        raise AssertionError("bf16 forward equals float32 forward: the "
                             "witness needs a bf16 model")
    limit = WITNESS_K * floor
    err = float((rows["decoded"] - truth).abs().max())
    out = dict(floor=floor, limit=limit, err=err, ratio=err / floor,
               controls={})
    if not err <= limit:
        raise AssertionError(f"bf16 decoded logits {err} from float32 "
                             f"forward, over {WITNESS_K} x bf16 forward's "
                             f"{floor}")
    for name, decoded in controls.items():
        c = float((decoded - truth).abs().max())
        out["controls"][name] = c
        if not c > limit:
            raise AssertionError(f"control {name!r} ({c}) passes the witness"
                                 f" (limit {limit})")
    return out


def phase_lm_float32(device, cfg, params, rows, controls: dict, batch=4,
                     prompt=2048, extra=8, s_max=None) -> dict:
    """The weights cast to float32 in place and the ``lm_prefill`` drive
    again, gated at LOGIT_TOL[float32]; its ``forward`` is then the
    witness of the bf16 drive's decoded ``rows`` (``decode_witness``)."""
    params.float()
    result = phase_lm_prefill(
        device, dataclasses.replace(cfg, dtype="float32"), params, batch,
        prompt, extra, s_max, time_it=False)
    f32 = result.pop("rows")
    if not torch.equal(f32["tokens"], rows["tokens"]):
        raise AssertionError("the float32 drive read other tokens")
    result["bf16_decode_witness"] = decode_witness(rows, f32["forward"],
                                                   controls)
    return result


def phase_lm_recurrent(device, cfg, params, batch=4, prompt=2048, extra=8,
                       s_max=4096, n_slots=8, ticks=16, crash_at=8,
                       time_it=True):
    """The ``lm_prefill`` drive (its decode gated by ``lm_float32``) and
    the ``lm_serve`` drive of a recurrent model in bf16; for RWKV6, the
    WKV6 kernel then held on layer 0's own inputs from the drive's
    prompt.  The control runs of ``decode_witness`` (the drive with each
    ``planted_state_fault``), then ``lm_float32``."""
    prefill, rows = lm_drive(device, cfg, params, batch, prompt, extra,
                             s_max, time_it)
    prefill["max_abs_err_decode"] = float(
        (rows["decoded"][:, -1] - rows["forward"][:, -1]).abs().max())
    result = dict(prefill=prefill)
    if "rwkv" in [cfg.layer_type(i) for i in range(cfg.num_layers)]:
        result["layer0_wkv6"] = check_wkv6_layer(*layer0_wkv6_inputs(
            cfg, params, rows["tokens"][:, :prompt]))
    result["serve"] = phase_lm_serve(device, cfg, params, s_max, n_slots,
                                     ticks, crash_at, time_it)
    controls = {}
    for kind in STATE_FAULTS:
        with planted_state_fault(kind):
            controls[kind] = decoded_rows(cfg, params, rows["tokens"],
                                          prompt, s_max)
    result["lm_float32"] = phase_lm_float32(device, cfg, params, rows,
                                            controls, batch, prompt, extra,
                                            s_max)
    return result


def phase_lm_arch(device, cfg, params, batch=4, prompt=2048, extra=8,
                  s_max=None, time_it=True):
    """``lm_drive`` of one of the other archs in bf16 (its flash and
    decode launches gated per kernel), with the largest distance of the
    decoded logits from ``forward``'s (reported: bf16 decode differs from
    bf16 forward by the model's own rounding, and an int8 cache by its
    quantization), the MoE auxiliary loss, an MoE model's
    ``route_agreement`` and the card's line."""
    result, rows = lm_drive(device, cfg, params, batch, prompt, extra, s_max,
                            time_it)
    result["max_abs_err_decode"] = float(
        (rows["decoded"] - rows["forward"]).abs().max())
    if cfg.is_moe:
        result["routes"] = route_agreement(
            cfg, params, rows["tokens"], prompt,
            s_max or result["frontend_positions"] + prompt + 64)
    result["decode_kernel_launches"] = decode_kernel_launches(cfg, device)
    result["config"] = dict(layers=cfg.num_layers, dtype=cfg.dtype,
                            head_dim=cfg.head_dim, window=cfg.window,
                            window_cache=cfg.window_cache,
                            kv_quant=cfg.kv_quant,
                            capacity_factor=cfg.capacity_factor)
    if time_it:
        result["card"] = card_line()
    return result


# ---------------------------------------------------------------------------
# phases 13-14: the recurrence kernels against their plain versions
# ---------------------------------------------------------------------------

def model_decays(gen, shape, device):
    """Decays drawn as rwkv's init draws them with a zero LoRA term:
    w = exp(-exp(w0)), w0 ~ N(-0.5, 0.5)."""
    w0 = 0.5 * torch.randn(shape, generator=gen, device=device) - 0.5
    return torch.exp(-torch.exp(w0))


def wkv6_inputs(device, seed, dtype, b, h, t, n):
    gen = torch.Generator(device=device).manual_seed(seed)
    r, k, v = (torch.randn((b, h, t, n), generator=gen, device=device)
               .to(dtype) for _ in range(3))
    u = 0.3 * torch.randn((h, n), generator=gen, device=device)
    return r, k, v, model_decays(gen, (b, h, t, n), device), u


def phase_wkv6_kernel(device, b=4, h=64, t=2048, n=64, time_it=True):
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for tt in (t, t // 2 + 1, 1):
            args = wkv6_inputs(device, tt, dtype, b, h, tt, n)
            o, s = wkv_ops.wkv6(*args)
            po, ps = wkv_ref.wkv6_reference(*args)
            key = f"T{tt}/{str(dtype)[6:]}"
            errs[f"o/{key}"] = require_close(o, po, REC_TOL[dtype],
                                             f"wkv6 o {key}")
            errs[f"S/{key}"] = require_close(s, ps, STATE_TOL,
                                             f"wkv6 S {key}")
            del o, s, po, ps, args
    args = wkv6_inputs(device, 0, torch.bfloat16, b, h, t, n)
    r, w = args[0], args[3]
    nbytes = (3 * r.numel() * r.element_size() + w.numel() * 4
              + args[4].numel() * 4 + r.numel() * r.element_size()
              + b * h * n * n * 4)           # r, k, v, w, u in; o, S out
    flops = b * h * t * (4.0 * n * n + 3 * n + 2 * n)
    result = dict(max_abs_err=errs[f"o/T{t}/bfloat16"], errs=errs,
                  shape=(b, h, t, n), bytes=nbytes, flops=flops,
                  bound_ms=max(nbytes / HBM_BYTES_PER_S,
                               flops / F32_FLOP_PER_S) * 1e3,
                  bound_by=("operations" if flops / F32_FLOP_PER_S
                            > nbytes / HBM_BYTES_PER_S else "bytes"))
    if time_it:
        result["ms"] = cuda_ms(lambda: wkv_ops.wkv6(*args), reps=10)
        result["plain_ms"] = cuda_ms(lambda: wkv_ref.wkv6_reference(*args),
                                     reps=1)
    return result


def rglru_cases(b: int, t: int, d: int):
    """The RG-LRU kernel's checked shapes: the prefill's (b, t, d); at its D
    a T that ends in a part of the ring kernel's 32-step chunk and T 1; a
    D that ends in a part of its 64-channel tile (d + 4; the direct kernel
    in bf16, whose rows are then not whole 16-byte units) and one whose
    rows no TMA copy can move in either type (d + 3, the direct kernel)."""
    return ((b, t, d), (b, t // 2 + 1, d), (b, 1, d), (b, 97, d + 4),
            (b, 33, d + 3))


def rglru_inputs(device, seed, dtype, b, t, d):
    """Seeded a and u (B, T, D) of ``dtype``, a drawn in the path's range:
    a = exp(-8 softplus(lam) r) >= ~0.86."""
    gen = torch.Generator(device=device).manual_seed(seed)
    a = 0.86 + 0.14 * torch.rand((b, t, d), generator=gen, device=device)
    u = torch.randn((b, t, d), generator=gen, device=device)
    return a.to(dtype), u.to(dtype)


def phase_rglru_kernel(device, b=4, t=2048, d=4096, time_it=True):
    on = int(torch.device(device).type == "cuda")
    errs, kinds = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        for bb, tt, dd in rglru_cases(b, t, d):
            key = f"{bb}x{tt}x{dd}/{str(dtype)[6:]}"
            a, u = rglru_inputs(device, tt + dd, dtype, bb, tt, dd)
            kind = rg_ops.variant(dtype, dd)
            before = read_launches()
            h, last = rg_ops.rglru(a, u)
            got = {k: n - before[k] for k, n in read_launches().items()
                   if k.startswith("rglru.")}
            want = {f"rglru.{v}": on * (v == kind)
                    for v in ("ring", "direct")}
            if got != want:
                raise AssertionError(f"rglru {key} launched {got}, expected "
                                     f"{want}")
            kinds[key] = kind
            ph, plast = rg_ref.rglru_reference(a, u)
            if dtype == torch.float32 and not (torch.equal(h, ph) and
                                               torch.equal(last, plast)):
                raise AssertionError(f"rglru {key}: float32 h or final h "
                                     f"not bit-equal to the plain scan")
            errs[f"h/{key}"] = require_close(h, ph, REC_TOL[dtype],
                                             f"rglru h {key}")
            errs[f"last/{key}"] = require_close(last, plast, STATE_TOL,
                                                f"rglru final h {key}")
            del a, u, h, last, ph, plast
    a, u = rglru_inputs(device, 0, torch.float32, b, t, d)
    nbytes = 3 * a.numel() * 4 + b * d * 4      # a, u in; h, final h out
    result = dict(max_abs_err=errs[f"h/{b}x{t}x{d}/float32"], errs=errs,
                  variants=kinds, shape=(b, t, d), bytes=nbytes,
                  bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    if time_it:
        result["ms"] = cuda_ms(lambda: rg_ops.rglru(a, u), reps=10)
        result["plain_ms"] = cuda_ms(lambda: rg_ref.rglru_reference(a, u),
                                     reps=1)
        result["gb_per_s"] = nbytes / (result["ms"] * 1e-3) / 1e9
        a, u = a.bfloat16(), u.bfloat16()
        result["bf16_ms"] = cuda_ms(lambda: rg_ops.rglru(a, u), reps=10)
        result["bf16_bound_ms"] = (3 * a.numel() * 2 + b * d * 4) \
            / HBM_BYTES_PER_S * 1e3
    return result


# ---------------------------------------------------------------------------
# phases 14b-14c: the recurrences' backward kernels
# ---------------------------------------------------------------------------

WKV_BWD_NAMES = ("dr", "dk", "dv", "dw", "du")
# half the channels' decays in the tiny-decay cases, log-uniform
WKV_TINY_DECAYS = {"1e-12": (1e-12, 1e-10), "1e-30": (1e-30, 1e-20)}


def wkv6_bwd_inputs(device, seed, dtype, b, h, t, n, decays=None,
                    with_ds=False, tiny=None):
    """``wkv6_inputs`` (decays drawn as the model's, or uniform in
    ``decays``, or with ``tiny`` = (lo, hi) half the channels log-uniform
    in [lo, hi] and the rest in [0.9, 0.999]), an output gradient do of
    r's type and, ``with_ds``, a float32 final-state gradient."""
    args = list(wkv6_inputs(device, seed, dtype, b, h, t, n))
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    if decays is not None:
        lo, hi = decays
        args[3] = lo + (hi - lo) * torch.rand((b, h, t, n), generator=gen,
                                              device=device)
    if tiny is not None:
        lo, hi = math.log(tiny[0]), math.log(tiny[1])
        x = torch.rand((b, h, t, n), generator=gen, device=device)
        args[3] = torch.cat([0.9 + 0.099 * x[..., :n // 2],
                             torch.exp(lo + (hi - lo) * x[..., n // 2:])],
                            -1)
    do = torch.randn((b, h, t, n), generator=gen, device=device).to(dtype)
    ds = (torch.randn((b, h, n, n), generator=gen, device=device)
          if with_ds else None)
    return tuple(args), do, ds


def check_wkv6_backward(args, do, ds, what) -> dict:
    """The WKV6 backward (kernel on the card) against the plain backward:
    dr, dk, dv at REC_TOL of r's type, dw and du within STATE_TOL of their
    largest magnitude; a second run must be bit-equal.  Returns the
    errors."""
    got = wkv_ops.wkv6_backward(*args, do, ds)
    again = wkv_ops.wkv6_backward(*args, do, ds)
    want = wkv_ref.wkv6_backward_reference(*args, do, ds)
    errs = {}
    for name, g, w, g2 in zip(WKV_BWD_NAMES, got, want, again):
        if name in ("dw", "du"):
            errs[name] = require_scaled(g, w, STATE_TOL, f"{what} {name}")
        else:
            errs[name] = require_close(g, w, REC_TOL[args[0].dtype],
                                       f"{what} {name}")
        if not torch.equal(g, g2):
            raise AssertionError(f"{what}: {name} differs from run to run")
    return errs


def phase_wkv6_bwd_kernel(device, b=4, h=64, t=2048, n=64, time_it=True):
    """The WKV6 backward kernel (``wkv6_bwd_chunk_kernel``) against its
    plain backward at the ``wkv6_kernel`` phase's shapes and cases (the
    prefill shape, T / 2 + 1 and T 1, bf16 and float32), with a given
    final-state gradient, with decays in [0.01, 0.115], below the chunked
    form's range, and with half the channels at decays in [1e-12, 1e-10]
    and [1e-30, 1e-20] (where the walk it replaced lost dw), both types;
    each case twice, bit-equal.  With ``time_it``, the kernel (CUDA
    events) beside its bound and the plain backward at the prefill
    shape."""
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for tt in (t, t // 2 + 1, 1):
            key = f"T{tt}/{str(dtype)[6:]}"
            errs[key] = check_wkv6_backward(
                *wkv6_bwd_inputs(device, tt, dtype, b, h, tt, n),
                f"wkv6 bwd {key}")
    errs["dS/bfloat16"] = check_wkv6_backward(
        *wkv6_bwd_inputs(device, 5, torch.bfloat16, b, h, t, n,
                         with_ds=True), "wkv6 bwd dS/bfloat16")
    errs["small_decays/float32"] = check_wkv6_backward(
        *wkv6_bwd_inputs(device, 6, torch.float32, b, h, t // 2 + 1, n,
                         decays=(0.01, 0.115), with_ds=True),
        "wkv6 bwd small_decays/float32")
    for i, (name, tiny) in enumerate(WKV_TINY_DECAYS.items()):
        for dtype in (torch.bfloat16, torch.float32):
            key = f"tiny_{name}/{str(dtype)[6:]}"
            errs[key] = check_wkv6_backward(
                *wkv6_bwd_inputs(device, 7 + i, dtype, b, h, t // 2 + 1, n,
                                 with_ds=dtype == torch.float32, tiny=tiny),
                f"wkv6 bwd {key}")
    args, do, _ = wkv6_bwd_inputs(device, 0, torch.bfloat16, b, h, t, n)
    r = args[0]
    # r, k, v, do, w in; dr, dk, dv, dw out; u and du
    nbytes = (r.numel() * (7 * r.element_size() + 2 * 4)
              + 2 * args[4].numel() * 4)
    # pass A 4 N^2, pass B 6 N^2, at the rate of the kernel's products
    flops = 10.0 * b * h * t * n * n
    result = dict(max_abs_err=max(errs[f"T{t}/bfloat16"][k]
                                  for k in ("dr", "dk", "dv")),
                  errs=errs, shape=(b, h, t, n), bytes=nbytes, flops=flops,
                  bound_ms=max(nbytes / HBM_BYTES_PER_S,
                               flops / TF32X3_FLOP_PER_S) * 1e3,
                  bound_by=("operations" if flops / TF32X3_FLOP_PER_S
                            > nbytes / HBM_BYTES_PER_S else "bytes"))
    if time_it:
        result["ms"] = cuda_ms(lambda: wkv_ops.wkv6_backward(*args, do),
                               reps=5)
        result["plain_ms"] = cuda_ms(
            lambda: wkv_ref.wkv6_backward_reference(*args, do), reps=1)
        f32 = tuple(x.float() for x in args)
        result["float32_ms"] = cuda_ms(
            lambda: wkv_ops.wkv6_backward(*f32, do.float()), reps=5)
        result["tflop_per_s"] = flops / (result["ms"] * 1e-3) / 1e12
    return result


def direct_rglru_backward(a, h, dh):
    """The direct backward kernel (``rglru_bwd_kernel``) through the
    library's C entry point, at any D: the kernel the ring replaced at the
    prefill shape, timed beside it (not counted: no wrapper launches it
    there)."""
    lib = _build.load("rglru_bwd", rg_ops._declare_bwd)
    da, du = torch.empty_like(a), torch.empty_like(a)
    b, t, d = a.shape
    _build.check(lib, lib.rglru_backward(
        _build.pointer(a), _build.pointer(h), _build.pointer(dh), None,
        _build.pointer(da), _build.pointer(du), _build.DTYPES[a.dtype], b, t,
        d, _build.stream()), "rglru_bwd direct")
    return da, du


def phase_rglru_bwd_kernel(device, b=4, t=2048, d=4096, time_it=True):
    """The RG-LRU backward kernels against their plain backward at the
    ``rglru_kernel`` phase's cases, float32 and bf16, on the forward
    kernel's own h, every other case with a final-state gradient: the ring
    kernel (``rglru_bwd_ring_kernel``) at the prefill shape, at T 1 and at
    a T that ends in a part of its 32-step chunk, the direct one where
    ``variant`` says (each case's launch by kernel checked); du at
    REC_TOL, da within STATE_TOL of its largest magnitude, float32
    bit-equal to the plain backward (both round each multiply and add
    alone), and a second run bit-equal.  With ``time_it``, the ring kernel
    and the direct one at the prefill shape (CUDA events) beside the bytes
    bound and the plain backward, in float32 and bf16."""
    on = int(torch.device(device).type == "cuda")
    errs, kinds = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        for i, (bb, tt, dd) in enumerate(rglru_cases(b, t, d)):
            key = f"{bb}x{tt}x{dd}/{str(dtype)[6:]}"
            a, u = rglru_inputs(device, tt + dd, dtype, bb, tt, dd)
            h, _ = rg_ops.rglru(a, u)
            gen = torch.Generator(device=device).manual_seed(i)
            dh = torch.randn((bb, tt, dd), generator=gen,
                             device=device).to(dtype)
            last = (torch.randn((bb, dd), generator=gen, device=device)
                    if i % 2 == 0 else None)
            kind = rg_ops.variant(dtype, dd)
            before = read_launches()
            da, du = rg_ops.rglru_backward(a, h, dh, last)
            got = {k: n - before[k] for k, n in read_launches().items()
                   if k.startswith("rglru_bwd")}
            want = {"rglru_bwd": on, **{f"rglru_bwd.{v}": on * (v == kind)
                                        for v in ("ring", "direct")}}
            if got != want:
                raise AssertionError(f"rglru bwd {key} launched {got}, "
                                     f"expected {want}")
            kinds[key] = kind
            pda, pdu = rg_ref.rglru_backward_reference(a, h, dh, last)
            if dtype == torch.float32 and not (torch.equal(da, pda) and
                                               torch.equal(du, pdu)):
                raise AssertionError(f"rglru bwd {key}: float32 da or du "
                                     f"not bit-equal to the plain backward")
            errs[f"du/{key}"] = require_close(du, pdu, REC_TOL[dtype],
                                              f"rglru bwd du {key}")
            errs[f"da/{key}"] = require_scaled(da, pda, STATE_TOL,
                                               f"rglru bwd da {key}")
            da2, du2 = rg_ops.rglru_backward(a, h, dh, last)
            if not (torch.equal(da, da2) and torch.equal(du, du2)):
                raise AssertionError(f"rglru bwd {key}: differs from run "
                                     f"to run")
            del a, u, h, dh, da, du, pda, pdu, da2, du2
    a, u = rglru_inputs(device, 0, torch.float32, b, t, d)
    h, _ = rg_ops.rglru(a, u)
    dh = torch.randn_like(h)
    nbytes = 5 * a.numel() * 4               # a, h, dh in; da, du out
    result = dict(max_abs_err=errs[f"du/{b}x{t}x{d}/float32"], errs=errs,
                  variants=kinds, shape=(b, t, d), bytes=nbytes,
                  bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    if time_it:
        if rg_ops.variant(a.dtype, d) != "ring":
            raise AssertionError(f"rglru bwd at {(b, t, d)}: not the ring")
        if not all(torch.equal(x, y) for x, y in zip(
                direct_rglru_backward(a, h, dh),
                rg_ops.rglru_backward(a, h, dh))):
            raise AssertionError("rglru bwd: the direct kernel and the ring"
                                 " differ")
        result["ms"] = cuda_ms(lambda: rg_ops.rglru_backward(a, h, dh),
                               reps=10)
        result["direct_ms"] = cuda_ms(lambda: direct_rglru_backward(a, h, dh),
                                      reps=10)
        result["plain_ms"] = cuda_ms(
            lambda: rg_ref.rglru_backward_reference(a, h, dh), reps=1)
        result["gb_per_s"] = nbytes / (result["ms"] * 1e-3) / 1e9
        a, h, dh = a.bfloat16(), h.bfloat16(), dh.bfloat16()
        result["bf16_ms"] = cuda_ms(lambda: rg_ops.rglru_backward(a, h, dh),
                                    reps=10)
        result["bf16_direct_ms"] = cuda_ms(
            lambda: direct_rglru_backward(a, h, dh), reps=10)
        result["bf16_bound_ms"] = nbytes / 2 / HBM_BYTES_PER_S * 1e3
    return result


# ---------------------------------------------------------------------------
# phases 15-16: the flash backward, and the training path
# ---------------------------------------------------------------------------

def flash_bwd_ops(b, h, sq, sk, d, causal: bool, window: int = 0) -> float:
    """The backward's FLOPs: five products (S, dP, dV, dK, dQ) of 2 B H D
    FLOPs a visible (query, key) pair: Sq Sk pairs, halved when causal;
    with a window narrower than Sk (causal, Sq == Sk), the pairs it keeps
    (min(q + 1, window) keys for query q)."""
    if causal and 0 < window < sk:
        pairs = sum(min(q + 1, window) for q in range(sq))
        return 10.0 * b * h * d * pairs
    return 10.0 * b * h * sq * sk * d * (0.5 if causal else 1.0)


def flash_bwd_check(device, dtype, b, h, kh, sq, sk, d, kw, seed, what):
    """The forward's lse and the backward kernels against the plain
    versions on one seeded case: lse (on the rows that see a key) at 1e-5
    relative, the other rows at -1e30, out at TOL, and dq, dk, dv within
    TOL[dtype] of each gradient's largest magnitude; on the card the
    backward must launch the pair ``bwd_variant`` picks.  Returns the
    errors (and the pair, "plain" on the CPU) and the inputs."""
    q, k, v = random_qkv(device, seed, dtype, b, h, kh, sq, sk, d)
    do = random_qkv(device, seed + 1000, dtype, b, h, kh, sq, sk, d)[0]
    out, lse = fa_ops.flash_attention_lse(q, k, v, **kw)
    want_out, want_lse = fa_ref.attention_reference_lse(q, k, v, **kw)
    seen = want_lse > -1e29
    errs = dict(lse=require_close(lse[seen], want_lse[seen], 1e-5,
                                  f"{what} lse"))
    if not bool((lse[~seen] == -1e30).all()):
        raise AssertionError(f"{what}: rows that see no key have lse "
                             f"{lse[~seen].unique()[:4].tolist()}")
    errs["out"] = require_close(out[seen], want_out[seen], TOL[dtype],
                                f"{what} out")
    del want_out, want_lse
    before = read_launches()
    got = fa_ops.flash_attention_backward(q, k, v, out, lse, do, **kw)
    ran = [kind for kind in ("wgmma", "fma")
           if read_launches()[f"flash_attention.bwd_{kind}"]
           > before[f"flash_attention.bwd_{kind}"]]
    errs["pair"] = ran[0] if ran else "plain"
    if torch.device(device).type == "cuda" and \
            ran != [fa_ops.bwd_variant(dtype, d)]:
        raise AssertionError(f"{what}: the backward launched {ran}, not "
                             f"{fa_ops.bwd_variant(dtype, d)}")
    want = fa_ref.attention_backward_reference(q, k, v, out, lse, do, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        errs[name] = require_scaled(g, w, TOL[dtype], f"{what} {name}")
    return errs, (q, k, v, out, lse, do)


def cuda_core_backward(q, k, v, out, lse, do, *, mode="causal", window=0,
                       lengths=None, q_offset=0, scale=None):
    """(dq, dk, dv) from the flash backward's CUDA-core pair at any type
    and head dim, through its C entry point: the time the tensor-core pair
    replaced, and the bf16 training witnesses' yardstick (the wrapper
    routes bf16 at head dims 64, 128 and 256 to the tensor cores).  Counts
    no launch; the plain backward on the CPU."""
    kw = dict(mode=mode, window=window, lengths=lengths, q_offset=q_offset,
              scale=scale)
    if q.device.type == "cpu":
        return fa_ref.attention_backward_reference(q, k, v, out, lse, do,
                                                   **kw)
    q, k, v, lengths = fa_ops._prepare(q, k, v, mode, lengths)
    out, do = (_build.kernel_input(t.to(q.dtype)) for t in (out, do))
    lse = _build.kernel_input(lse.float())
    b, h, sq, d = q.shape
    kh, sk = k.shape[1], k.shape[2]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = _build.load("flash_attention_bwd", fa_ops._declare_bwd)
    code = lib.flash_attention_bwd(
        *(_build.pointer(t) for t in (q, k, v, out, do, lse, lengths, delta,
                                       dq, dk, dv)),
        _build.DTYPES[q.dtype], b, h, kh, sq, sk, d, fa_ops.MODES[mode],
        window, q_offset, fa_ops._scale(scale, d), _build.stream())
    _build.check(lib, code, "flash_attention_bwd (CUDA cores)")
    return dq, dk, dv


# The backward's timed shapes, as training runs them: qwen3-1.7b's
# (lm_train_bf16's: the tensor-core pair's row) and smollm-135m's in bf16,
# smollm-135m's in float32 (lm_train's, the CUDA-core pair), phi-3-vision's
# at head dim 96 (the CUDA-core pair in bf16) and gemma3-1b's at 256 with
# its 512 window (the tensor-core pair); all causal:
# (name, b, h, kh, s, d, dtype, window)
FLASH_BWD_SHAPES = (("qwen3-1.7b", 4, 16, 8, 2048, 128, torch.bfloat16, 0),
                    ("smollm-135m", 8, 9, 3, 2048, 64, torch.bfloat16, 0),
                    ("smollm-135m", 8, 9, 3, 2048, 64, torch.float32, 0),
                    ("phi-3-vision-4.2b", 4, 32, 32, 2048, 96,
                     torch.bfloat16, 0),
                    ("gemma3-1b", 4, 4, 1, 2048, 256, torch.bfloat16, 512))
# small cases in both types (bf16 at head dims 64, 128 and 256 on the
# tensor cores, the rest on the CUDA cores): (case, b, h, kh, sq, sk, d,
# kwargs); the lengths of "length" are (sk // 3, sk), so rows past a short
# length stay; at head dim 256 an MQA group of 16 at a ragged Sq (its dK/dV
# blocks split over the heads) and each mode's edge
FLASH_BWD_SMALL = (
    ("window", 2, 4, 2, 512, 512, 64, dict(mode="causal", window=128)),
    ("length", 2, 4, 2, 256, 700, 64, dict(mode="length")),
    ("length_window", 2, 4, 1, 64, 700, 128, dict(mode="length",
                                                  window=200)),
    ("full_sk384", 2, 4, 2, 200, 384, 64, dict(mode="full")),
    ("offset", 2, 4, 2, 77, 333, 128, dict(mode="causal", q_offset=256)),
    ("g1", 2, 4, 4, 300, 300, 64, dict(mode="causal")),
    ("d32", 2, 4, 2, 200, 200, 32, dict(mode="causal")),
    ("d96", 1, 8, 2, 256, 256, 96, dict(mode="causal")),
    ("d256", 1, 4, 1, 256, 256, 256, dict(mode="causal")),
    ("no_key_rows", 1, 4, 2, 300, 160, 64, dict(mode="causal", window=32)),
    ("mqa16_d256", 1, 16, 1, 200, 200, 256, dict(mode="causal")),
    ("window_d256", 1, 4, 1, 200, 200, 256, dict(mode="causal", window=64)),
    ("length_d256", 2, 4, 2, 130, 300, 256, dict(mode="length")),
    ("offset_d256", 2, 4, 1, 77, 333, 256, dict(mode="causal",
                                                q_offset=256)),
    ("full_d256", 2, 4, 2, 130, 384, 256, dict(mode="full")),
    ("no_key_rows_d256", 1, 2, 1, 200, 100, 256, dict(mode="causal",
                                                      window=16)),
    ("no_key_rows_d128", 1, 2, 1, 200, 100, 128, dict(mode="causal",
                                                      window=16)))
# the tensor-core pair's kernels and head dims, which the SASS must show
BWD_WGMMA_KERNELS = ("flash_bwd_dq_wgmma_kernel",
                     "flash_bwd_dkdv_wgmma_kernel")
BWD_WGMMA_HEAD_DIMS = tuple(sorted(
    d for (_, d), kind in fa_ops.BWD_VARIANTS.items() if kind == "wgmma"))


def phase_flash_bwd_kernel(device, shapes=FLASH_BWD_SHAPES,
                           small=FLASH_BWD_SMALL, time_it=True):
    """The backward kernels (and the forward's lse) against the plain
    backward at each of ``shapes`` (causal) and on ``small`` in float32 and
    bf16, each through the pair ``bwd_variant`` picks; gradients held
    within TOL of their largest magnitude.  On the card, the tensor-core
    pair's SASS must hold HGMMA at each of its head dims.  With
    ``time_it``, each shape's backward by device time beside its bound
    (operations: ``flash_bwd_ops`` at the float32 or bf16 peak), the plain
    backward and SDPA's backward (SDPA forward plus backward less its
    forward; a window as a boolean mask); a bf16 shape on the
    tensor-core pair also on the CUDA-core pair (``fma_ms``).  The first
    shape's numbers are the backward's row."""
    errs, timed = {}, {}
    hgmma = None
    if torch.device(device).type == "cuda":
        listing = _build.sass("flash_attention_bwd")
        hgmma = {kname: hgmma_by_head_dim(listing, kname,
                                          BWD_WGMMA_HEAD_DIMS)
                 for kname in BWD_WGMMA_KERNELS}
    for i, (case, b, h, kh, sq, sk, d, kw) in enumerate(small):
        kw = dict(kw)
        if kw["mode"] == "length":
            kw["lengths"] = torch.tensor([sk // 3, sk], dtype=torch.int32,
                                         device=device)
        for dtype in BOTH_DTYPES:
            key = f"{case}/{str(dtype)[6:]}"
            errs[key] = flash_bwd_check(device, dtype, b, h, kh, sq, sk, d,
                                        kw, 40 + i, f"flash bwd {key}")[0]
    for name, b, h, kh, s, d, dtype, window in shapes:
        key = f"{name}/causal/{str(dtype)[6:]}"
        kw = dict(mode="causal", window=window)
        errs[key], (q, k, v, out, lse, do) = flash_bwd_check(
            device, dtype, b, h, kh, s, s, d, kw, 7, f"flash bwd {key}")
        flops = flash_bwd_ops(b, h, s, s, d, True, window)
        peak = F32_FLOP_PER_S if dtype == torch.float32 else BF16_FLOP_PER_S
        nbytes = (q.element_size() * (4 * q.numel() + 4 * k.numel())
                  + 4 * lse.numel())     # q, out, dO, dQ; k, v, dK, dV
        r = dict(shape=(b, h, kh, s, s, d, str(dtype)[6:]), window=window,
                 flops=flops, pair=errs[key]["pair"],
                 bound_ms=max(flops / peak, nbytes / HBM_BYTES_PER_S) * 1e3,
                 bound_by=("operations" if flops / peak
                           >= nbytes / HBM_BYTES_PER_S else "bytes"))
        if time_it:
            r.update(flash_bwd_times(q, k, v, out, lse, do, kw, r["pair"],
                                     flops))
        timed[f"{name}/{str(dtype)[6:]}"] = r
        del q, k, v, out, lse, do
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    name, *_, dtype, _ = shapes[0]
    first = f"{name}/{str(dtype)[6:]}"
    return dict(timed[first], max_abs_err=errs[f"{name}/causal/"
                                               f"{str(dtype)[6:]}"]["dq"],
                errs=errs, shapes=timed, hgmma=hgmma)


FLASH_BWD_KERNELS = ("flash_bwd_dq_kernel", "flash_bwd_dkdv_kernel",
                     "flash_bwd_dq_wgmma_kernel",
                     "flash_bwd_dkdv_wgmma_kernel", "flash_bwd_sum_kernel")


def flash_bwd_times(q, k, v, out, lse, do, kw, pair, flops) -> dict:
    """A backward case's times: the wrapper's pair by device time (and
    by kernel), on the tensor cores also the CUDA-core pair's
    (``fma_ms``), the plain backward's, and SDPA's backward's (causal; a
    window narrower than Sk as a boolean mask)."""
    t = device_time(lambda: fa_ops.flash_attention_backward(
        q, k, v, out, lse, do, **kw), 3, FLASH_BWD_KERNELS)
    r = dict(ms=t["device_ms"], timed_by=t["timed_by"],
             by_kernel_ms=t["by_kernel_ms"],
             tflop_per_s=flops / (t["device_ms"] * 1e-3) / 1e12)
    if pair == "wgmma":
        f = device_time(lambda: cuda_core_backward(
            q, k, v, out, lse, do, **kw), 3, FLASH_BWD_KERNELS)
        r.update(fma_ms=f["device_ms"], fma_by_kernel_ms=f["by_kernel_ms"])
    r["plain_ms"] = cuda_ms(lambda: fa_ref.attention_backward_reference(
        q, k, v, out, lse, do, **kw), reps=2)
    r["library_ms"], r["library_kernels"] = sdpa_backward_ms(
        q, k, v, do, kw.get("window", 0))
    return r


def sdpa_backward_ms(q, k, v, do, window=0):
    """SDPA's backward at this shape (causal, GQA; a window narrower than
    Sk as a boolean ``attn_mask``, the plain backward's visible pairs):
    the time of SDPA's forward plus backward less that of its forward (the
    yardstick; the port never calls it), and the names of the kernels its
    forward plus backward launch (which backend SDPA took)."""
    from torch.profiler import ProfilerActivity, profile
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    sq, sk = q.shape[2], k.shape[2]
    if 0 < window < sk:
        mask = dict(attn_mask=fa_ref.visible_mask(sq, sk, q.device,
                                                  window=window))
    else:
        mask = dict(is_causal=True)

    def fwd():
        with torch.no_grad():
            sdpa(q, k, v, enable_gqa=True, **mask)

    def fwd_bwd():
        o = sdpa(qg, kg, vg, enable_gqa=True, **mask)
        torch.autograd.grad(o, (qg, kg, vg), do)
    ms = cuda_ms(fwd_bwd, reps=5) - cuda_ms(fwd, reps=5)
    names = []
    for _ in range(3):      # a trace now and then holds no device activity
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fwd_bwd()
            torch.cuda.synchronize()
        names = sorted({e.key[:60] for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA})
        if names:
            break
    return ms, names


class PlainAttentionFn(torch.autograd.Function):
    """The plain forward and the plain backward (``attention_reference_lse``
    and ``attention_backward_reference``) as one autograd function: the
    witness of the kernels' gradient in ``lm_train``."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, mode, window, q_offset, scale):
        kw = dict(mode=mode, window=window, lengths=lengths,
                  q_offset=q_offset, scale=scale)
        out, lse = fa_ref.attention_reference_lse(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        return (*fa_ref.attention_backward_reference(q, k, v, out, lse, do,
                                                     **ctx.kw),
                None, None, None, None, None)


class CudaCoreBackwardFn(torch.autograd.Function):
    """The forward kernel with its lse, and the flash backward's CUDA-core
    pair by its C entry point (``cuda_core_backward``): lm_train_bf16's
    yardstick for the tensor-core pair's gradient."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, mode, window, q_offset, scale):
        kw = dict(mode=mode, window=window, lengths=lengths,
                  q_offset=q_offset, scale=scale)
        out, lse = fa_ops.flash_attention_lse(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        return (*cuda_core_backward(q, k, v, out, lse, do, **ctx.kw),
                None, None, None, None, None)


@contextlib.contextmanager
def plain_attention(fn=PlainAttentionFn):
    """Within: the models' flash attention is ``fn`` (by default the plain
    forward and backward, no kernel launches), on any device."""
    kernel = fa_ops.flash_attention

    def patched(q, k, v, *, mode="causal", window=0, lengths=None,
                q_offset=0, scale=None):
        return fn.apply(q, k, v, lengths, mode, window, q_offset, scale)
    fa_ops.flash_attention = patched
    try:
        yield
    finally:
        fa_ops.flash_attention = kernel


def train_launches(cfg, device) -> dict:
    """The flash launches of one train step of ``cfg``'s model under its
    remat: the forward once per attention layer, again under remat (in
    the backward pass), all of the kernel ``variant`` picks, and each
    backward kernel once, all of the pair ``bwd_variant`` picks (none on
    the CPU)."""
    n = path_launches(cfg, device)[0]["flash_attention"]
    fwd = n * (1 if cfg.remat == "none" else 2)
    dtype = getattr(torch, cfg.dtype)
    kind = fa_ops.variant(dtype, cfg.head_dim) if n else None
    pair = fa_ops.bwd_variant(dtype, cfg.head_dim) if n else None
    return {"flash_attention": fwd,
            **{f"flash_attention.{v}": fwd if v == kind else 0
               for v in ("wgmma", "fma")},
            "flash_attention.bwd": n,
            **{f"flash_attention.bwd_{v}": n if v == pair else 0
               for v in ("wgmma", "fma")},
            "flash_attention.bwd_dq": n, "flash_attention.bwd_dkdv": n}


def grad_step(cfg, ocfg, params, batch, **kw):
    """One ``make_train_step`` step on a copy of ``params``: (the copy,
    the state, the metrics, the gradients it took)."""
    p, seen = copy.deepcopy(params), {}
    step = train_loop.make_train_step(
        cfg, ocfg, grad_constraint=lambda g: seen.update(g) or g, **kw)
    p, state, m = step(p, train_opt.init(p), batch)
    return p, state, m, seen


def state_arrays(params, state) -> dict:
    """Every parameter and optimizer-state tensor, by checkpoint key."""
    return train_ckpt._flatten({"params": params, "opt": state})


# lm_train's gates: the first step's loss within LOSS_REL of the witness
# (the same step with the plain attention forward and backward on the
# card), each gradient within GRAD_REL of its leaf's largest magnitude
# (float32: the kernels sum in another order than the plain einsums, over
# 30 layers of backward); microbatches=2 against 1 on the loss and the
# summed gradient, at the same limits
LOSS_REL = 1e-5
GRAD_REL = 1e-4
LOSS_DROP = 0.3          # tests/test_train_runtime.py::test_loss_decreases
INT8_DROP = 0.1          # "descends" over a few steps
# The data of the runs that must learn (the loss-falls and int8 runs):
# TokenPipeline over 512 tokens, the smoke configs' vocabulary that
# test_loss_decreases trains on, fed to the full model (its logits stay
# 49,152 wide, so a step costs the same).  Over the full vocabulary a
# token recurs ~0.33 times a step, and 30 steps at lr 3e-4 to 3e-3 moved
# the loss by under 0.03 (PERF.md §6).  The witness, the launches,
# the microbatches and the restart drill read full-vocabulary batches.
LEARN_VOCAB = 512


def phase_lm_train(device, cfg=None, ocfg=None, batch=8, seq=2048,
                   steps=30, drill_seq=512, int8_steps=10, ckpt_root=None,
                   time_it=True):
    """smollm-135m at full width and depth in float32 (remat "block"),
    batches of ``TokenPipeline`` (seed 0), the launcher's AdamW settings
    unless ``ocfg`` is given (lr 3e-3, warmup 10, total ``steps``): the
    gradient witness; the flash
    launches of a step; ``steps`` steps (on LEARN_VOCAB data) whose loss
    must fall by LOSS_DROP;
    microbatches=2 against 1 (loss and gradient); an int8-moment
    master-less run; the restart
    drill at ``drill_seq`` (10 steps straight, and a run that crashes at
    7 and resumes from the step-5 checkpoint: bit-equal parameters and
    optimizer state, as the launcher runs them); and,
    with ``time_it``, ms per step, tokens/s, peak memory and the idle
    share of a traced step."""
    cfg = cfg or dataclasses.replace(registry.get_config("smollm-135m"),
                                     dtype="float32")
    ocfg = ocfg or train_opt.AdamWConfig(lr=3e-3, warmup_steps=10,
                                         total_steps=steps)
    t0 = time.perf_counter()
    params = model_lib.init_params(cfg, seed=0, device=device)
    n_params = sum(p.numel() for p in params.parameters())
    pipe = TokenPipeline(cfg.vocab_size, seq, batch, seed=0)

    def batch_at(i, pipe=pipe):
        return {k: torch.from_numpy(v).to(device)
                for k, v in pipe.batch_at(i).items()}
    sync(device)
    result = dict(arch=cfg.name, params=n_params, batch=batch, seq=seq,
                  remat=cfg.remat, dtype=cfg.dtype,
                  init_s=time.perf_counter() - t0)

    # the gradient witness and a step's launches
    want = train_launches(cfg, device)
    sync(device)
    reset_launches()
    p_kernel, _, m_kernel, g_kernel = grad_step(cfg, ocfg, params,
                                                batch_at(0))
    sync(device)
    result["step_launches"] = require_launches(want, "one train step")
    reset_launches()
    with plain_attention():
        _, _, m_plain, g_plain = grad_step(cfg, ocfg, params, batch_at(0))
    sync(device)
    if any(read_launches().values()):
        raise AssertionError(f"the plain witness launched kernels: "
                             f"{read_launches()}")
    for key, rel in (("loss", LOSS_REL), ("grad_norm", GRAD_REL)):
        got, ref = float(m_kernel[key]), float(m_plain[key])
        if not abs(got - ref) <= rel * abs(ref):
            raise AssertionError(f"lm_train witness: {key} {got} vs plain "
                                 f"{ref} (limit {rel} relative)")
    grad_errs = {name: require_scaled(g_kernel[name], ref, GRAD_REL,
                                      f"lm_train witness d {name}")
                 for name, ref in g_plain.items()}
    worst = max(grad_errs, key=grad_errs.get)
    result["witness"] = dict(loss=float(m_kernel["loss"]),
                             plain_loss=float(m_plain["loss"]),
                             grad_norm=float(m_kernel["grad_norm"]),
                             plain_grad_norm=float(m_plain["grad_norm"]),
                             worst_grad=worst,
                             worst_grad_rel_err=grad_errs[worst])
    del g_plain

    # microbatches=2 against 1: the same loss, and the two halves' summed
    # gradient (the last sum the grad_constraint sees, over 2) equal to
    # the whole batch's at the witness's limits.  The parameters after
    # the step are reported, not held: Adam's first step moves a
    # parameter by lr g / (|g| + eps), so a gradient within summation
    # noise of 0 may move by up to 2 lr either way (PERF.md §6).
    p_micro, _, m_micro, g_micro = grad_step(cfg, ocfg, params, batch_at(0),
                                             microbatches=2)
    for key, rel in (("loss", LOSS_REL), ("grad_norm", GRAD_REL)):
        got, ref = float(m_micro[key]), float(m_kernel[key])
        if not abs(got - ref) <= rel * abs(ref):
            raise AssertionError(f"microbatches=2: {key} {got} vs one batch"
                                 f" {ref} (limit {rel} relative)")
    micro_errs = {name: require_scaled(g_micro[name] / 2, ref, GRAD_REL,
                                       f"microbatches=2 d {name}")
                  for name, ref in g_kernel.items()}
    result["microbatches"] = dict(
        loss=float(m_micro["loss"]),
        worst_grad_rel_err=max(micro_errs.values()),
        param_max_abs_diff=max(float((a - b).detach().abs().max())
                               for a, b in zip(p_micro.parameters(),
                                               p_kernel.parameters())))
    del p_kernel, p_micro, g_kernel, g_micro

    # the loss falls over ``steps`` steps
    learn = TokenPipeline(LEARN_VOCAB, seq, batch, seed=0)
    p = copy.deepcopy(params)
    state = train_opt.init(p)
    step = train_loop.make_train_step(cfg, ocfg)
    losses, step_ms = [], []
    sync(device)
    reset_launches()
    for i in range(steps):
        t0 = time.perf_counter()
        p, state, m = step(p, state, batch_at(i, learn))
        losses.append(float(m["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    result["launches"] = require_launches(
        {k: n * steps for k, n in want.items()}, f"{steps} train steps")
    if not min(losses[-5:]) < losses[0] - LOSS_DROP:
        raise AssertionError(f"lm_train: the loss did not fall by "
                             f"{LOSS_DROP}: {losses}")
    result.update(losses=losses, step_ms=step_ms)
    if time_it:
        result["ms_per_step_median"] = float(np.median(step_ms[1:]))
        result["tokens_per_s"] = (batch * seq * 1e3
                                  / result["ms_per_step_median"])
        torch.cuda.reset_peak_memory_stats()
        b0 = batch_at(steps, learn)
        sync(device)
        t0 = time.perf_counter()
        p, state, _ = step(p, state, b0)
        sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
        result["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        prof = device_profile(lambda: step(p, state, b0), 1,
                              FLASH_BWD_KERNELS)
        prof["wall_ms"] = wall_ms
        prof["idle_share"] = 1 - prof["device_ms"] / wall_ms
        result["step_profile"] = prof
    del p, state

    # int8 moments, no master
    qcfg = dataclasses.replace(ocfg, moments_dtype="int8", master=False)
    p = copy.deepcopy(params)
    state = train_opt.init(p, qcfg)
    qstep = train_loop.make_train_step(cfg, qcfg)
    qlosses = []
    for i in range(int8_steps):
        p, state, m = qstep(p, state, batch_at(i, learn))
        qlosses.append(float(m["loss"]))
    kinds = {x["q"].dtype for mom in (state.mu, state.nu)
             for x in mom.values()}
    if state.master is not None or kinds != {torch.int8}:
        raise AssertionError(f"int8 moments: master {state.master is None},"
                             f" moment types {kinds}")
    if not min(qlosses[-3:]) < qlosses[0] - INT8_DROP:
        raise AssertionError(f"int8-moment run did not descend by "
                             f"{INT8_DROP}: {qlosses}")
    result["int8_losses"] = qlosses
    del p, state

    # the restart drill
    result["restart"] = restart_drill(device, cfg, ocfg, params, batch,
                                      drill_seq, ckpt_root)
    del params
    return result


def restart_drill(device, cfg, ocfg, params, batch, seq, ckpt_root=None):
    """10 steps straight; then a run that crashes at step 7 and resumes
    from the step-5 checkpoint into meta-device templates: every
    parameter and optimizer tensor bit-equal.  The steps run as the
    launcher runs them, with PyTorch's default algorithms (no
    ``use_deterministic_algorithms``, which would swap in other kernels
    than training uses), so the drill holds the path users run.
    Checkpoints go to a scratch directory of the checkout's ``build/``,
    removed after."""
    pipe = TokenPipeline(cfg.vocab_size, seq, batch, seed=5)

    def batch_fn(i):
        return {k: torch.from_numpy(v).to(device)
                for k, v in pipe.batch_at(i).items()}
    root = Path(ckpt_root or ROOT / "build")
    root.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="lm_train_ckpt_", dir=root))
    try:
        step = train_loop.make_train_step(cfg, ocfg)
        t0 = time.perf_counter()
        ctl = fault.TrainController(step, batch_fn, str(tmp / "a"), 5)
        p = copy.deepcopy(params)
        p_ref, o_ref, _ = ctl.run(p, train_opt.init(p), 0, 10)
        want = state_arrays(p_ref, o_ref)
        del p_ref, o_ref, p
        shutil.rmtree(tmp / "a")
        ctl2 = fault.TrainController(step, batch_fn, str(tmp / "b"), 5)
        p = copy.deepcopy(params)
        try:
            ctl2.run(p, train_opt.init(p), 0, 10, crash_at=7)
            raise AssertionError("the crashing run did not crash")
        except RuntimeError as e:
            if "simulated node failure at 7" not in str(e):
                raise
        del p
        p, o, at = ctl2.resume(model_lib.abstract_params(cfg),
                               train_opt.abstract_init(params), device)
        if at != 5:
            raise AssertionError(f"resumed at step {at}, not 5")
        p, o, end = ctl2.run(p, o, at, 10)
        got = state_arrays(p, o)
        drill_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if set(got) != set(want):
        raise AssertionError("restart drill: the states hold other keys")
    differ = [k for k in want if not np.array_equal(got[k], want[k])]
    if differ:
        raise AssertionError(f"restart drill: {len(differ)} tensors differ "
                             f"after the resume, e.g. {differ[:3]}")
    return dict(seq=seq, steps=end, resumed_at=at, tensors=len(want),
                bit_equal=True, drill_s=drill_s)


# lm_train_bf16's witness: the tensor-core pair's worst gradient error
# (against each leaf's largest magnitude, from the same step with the plain
# attention) may be BF16_WITNESS_K times the CUDA-core pair's, which sums
# the same bf16 operands in float32 on the CUDA cores; both read the same
# forward.  Over 28 layers of bf16 backward the floor is the model's own
# rounding, common to both; a wrong mask, scale or tile moves a gradient
# by O(1) of its size.  The loss reads the forward only: BF16_LOSS_REL.
BF16_WITNESS_K = 2.0
BF16_LOSS_REL = 1e-2


def phase_lm_train_bf16(device, cfg=None, ocfg=None, batch=4, seq=2048,
                        steps=12, time_it=True):
    """qwen3-1.7b at full width and depth in bf16 (remat "block"; AdamW's
    float32 master and moments), batches of ``TokenPipeline`` (seed 0),
    the launcher's AdamW settings unless ``ocfg`` is given (lr 3e-3,
    warmup 10, total ``steps``): the gradient witness at the drive's
    batch (a step's loss and gradients, ``loss_and_grads``, against the
    same with the plain attention, beside the same with the CUDA-core
    backward pair); ``steps`` steps on LEARN_VOCAB data, each loss finite and the
    last below the first, the first step's flash launches all on the
    tensor cores, AdamW's state float32; and, with ``time_it``, ms a step,
    tokens/s, peak memory, a traced step's idle share and its device time
    by kernel group, and a step's loss and gradients against its AdamW
    update by CUDA events."""
    cfg = cfg or registry.get_config("qwen3-1.7b")
    ocfg = ocfg or train_opt.AdamWConfig(lr=3e-3, warmup_steps=10,
                                         total_steps=steps)
    if cfg.dtype != "bfloat16":
        raise ValueError(f"lm_train_bf16 trains a bf16 model, not "
                         f"{cfg.dtype}")
    t0 = time.perf_counter()
    params = model_lib.init_params(cfg, seed=0, device=device)
    n_params = sum(p.numel() for p in params.parameters())
    pipe = TokenPipeline(cfg.vocab_size, seq, batch, seed=0)

    def batch_at(i, pipe=pipe):
        return {k: torch.from_numpy(v).to(device)
                for k, v in pipe.batch_at(i).items()}
    sync(device)
    result = dict(arch=cfg.name, params=n_params, batch=batch, seq=seq,
                  remat=cfg.remat, dtype=cfg.dtype, witness_batch=batch,
                  init_s=time.perf_counter() - t0)

    # a step's gradient against the plain attention's and against the
    # CUDA-core pair's (the loss and gradients alone: an optimizer state,
    # 3 x 1.72 G float32 words, for each of the three would not fit)
    want = train_launches(cfg, device)
    loss, g_kernel = train_loop.loss_and_grads(params, batch_at(0), cfg)[::2]
    with plain_attention():
        plain_loss, g_plain = train_loop.loss_and_grads(
            params, batch_at(0), cfg)[::2]
    with plain_attention(CudaCoreBackwardFn):
        fma_loss, g_fma = train_loop.loss_and_grads(params, batch_at(0),
                                                    cfg)[::2]
    sync(device)
    inf = float("inf")
    errs = {pair: {name: require_scaled(g[name], ref, inf,
                                        f"lm_train_bf16 {pair} d {name}")
                   for name, ref in g_plain.items()}
            for pair, g in (("wgmma", g_kernel), ("fma", g_fma))}
    worst = {pair: max(e, key=e.get) for pair, e in errs.items()}
    result["witness"] = dict(
        loss=float(loss), plain_loss=float(plain_loss),
        fma_loss=float(fma_loss),
        grad_norm=float(train_opt.global_norm(g_kernel)),
        plain_grad_norm=float(train_opt.global_norm(g_plain)),
        fma_grad_norm=float(train_opt.global_norm(g_fma)),
        worst_grad=worst,
        worst_grad_rel_err={p: errs[p][w] for p, w in worst.items()})
    del g_kernel, g_plain, g_fma
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()    # the witnesses' blocks, before the run
    w = result["witness"]
    if not abs(w["loss"] - w["plain_loss"]) <= BF16_LOSS_REL * abs(
            w["plain_loss"]):
        raise AssertionError(f"lm_train_bf16 witness: loss {w['loss']} vs "
                             f"plain {w['plain_loss']} (limit "
                             f"{BF16_LOSS_REL} relative)")
    e = w["worst_grad_rel_err"]
    if not e["wgmma"] <= BF16_WITNESS_K * e["fma"]:
        raise AssertionError(f"lm_train_bf16 witness: the tensor-core pair's"
                             f" worst gradient error {e['wgmma']} is past "
                             f"{BF16_WITNESS_K} x the CUDA-core pair's "
                             f"{e['fma']}")

    # ``steps`` steps on data that can be learned in that many
    learn = TokenPipeline(LEARN_VOCAB, seq, batch, seed=0)
    p, params = params, None
    state = train_opt.init(p)
    step = train_loop.make_train_step(cfg, ocfg)
    losses, step_ms = [], []
    sync(device)
    reset_launches()
    for i in range(steps):
        t0 = time.perf_counter()
        p, state, m = step(p, state, batch_at(i, learn))
        losses.append(float(m["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            result["step_launches"] = require_launches(
                want, "one bf16 train step")
    result["launches"] = require_launches(
        {k: n * steps for k, n in want.items()}, f"{steps} bf16 train steps")
    types = {str(t.dtype)[6:] for t in [*state.mu.values(),
                                        *state.nu.values(),
                                        *state.master.values()]}
    if types != {"float32"}:
        raise AssertionError(f"AdamW's master and moments hold {types}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"lm_train_bf16: the losses are not finite or "
                             f"the last is not below the first: {losses}")
    result.update(losses=losses, step_ms=step_ms)
    if time_it:
        result["ms_per_step_median"] = float(np.median(step_ms[1:]))
        result["tokens_per_s"] = (batch * seq * 1e3
                                  / result["ms_per_step_median"])
        torch.cuda.reset_peak_memory_stats()
        b0 = batch_at(steps, learn)
        sync(device)
        t0 = time.perf_counter()
        p, state, _ = step(p, state, b0)
        sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
        result["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        prof = device_profile(lambda: step(p, state, b0), 1,
                              FLASH_BWD_KERNELS)
        prof["wall_ms"] = wall_ms
        prof["idle_share"] = 1 - prof["device_ms"] / wall_ms
        prof["flash_backward_share"] = (prof["by_group_ms"]["flash_backward"]
                                        / prof["device_ms"])
        result["step_profile"] = prof
        # the step's two halves by CUDA events: the loss and gradients,
        # then AdamW's update
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        marks[0].record()
        grads = train_loop.loss_and_grads(p, b0, cfg)[2]
        marks[1].record()
        train_opt.update(ocfg, grads, state, p)
        marks[2].record()
        marks[2].synchronize()
        result["grads_ms"] = marks[0].elapsed_time(marks[1])
        result["update_ms"] = marks[1].elapsed_time(marks[2])
        del grads
    del p, state
    return result


# ---------------------------------------------------------------------------
# phases 18-19: training of the recurrent archs
# ---------------------------------------------------------------------------

class PlainWKV6Fn(torch.autograd.Function):
    """The plain WKV6 forward and the plain backward
    (``wkv6_reference``, ``wkv6_backward_reference``) as one autograd
    function, on any device: the recurrent drives' witness."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, w, u)
        return wkv_ref.wkv6_reference(r, k, v, w, u)

    @staticmethod
    def backward(ctx, do, ds):
        r, k, v, w, u = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(r)
        return wkv_ref.wkv6_backward_reference(r, k, v, w, u, do, ds)


class PlainRGLRUFn(torch.autograd.Function):
    """The plain RG-LRU forward and backward as one autograd function."""

    @staticmethod
    def forward(ctx, a, u):
        ctx.set_materialize_grads(False)
        h, h_last = rg_ref.rglru_reference(a, u)
        ctx.save_for_backward(a, h)
        return h, h_last

    @staticmethod
    def backward(ctx, dh, dh_last):
        a, h = ctx.saved_tensors
        if dh is None:
            dh = torch.zeros_like(h)
        return rg_ref.rglru_backward_reference(a, h, dh, dh_last)


class Float64WKV6Fn(PlainWKV6Fn):
    """The plain WKV6 forward in float64 (its outputs rounded to the
    model's types once), and the plain backward (float64 throughout): the
    recurrence's own rounding floor, the yardstick of the witness."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, w, u)
        o, s = wkv_ref.wkv6_reference(*(x.double() for x in (r, k, v, w,
                                                             u)))
        return o.to(r.dtype), s.float()


class Float64RGLRUFn(torch.autograd.Function):
    """The plain RG-LRU forward and backward in float64, rounded to the
    model's types once."""

    @staticmethod
    def forward(ctx, a, u):
        ctx.set_materialize_grads(False)
        h, h_last = rg_ref.rglru_reference(a.double(), u.double())
        ctx.save_for_backward(a, h)
        return h.to(a.dtype), h_last.float()

    @staticmethod
    def backward(ctx, dh, dh_last):
        a, h = ctx.saved_tensors
        if dh is None:
            dh = torch.zeros_like(h)
        da, du = rg_ref.rglru_backward_reference(
            a.double(), h, dh.double(),
            None if dh_last is None else dh_last.double())
        return da.to(a.dtype), du.to(a.dtype)


@contextlib.contextmanager
def plain_recurrences(wkv_fn=PlainWKV6Fn, rglru_fn=PlainRGLRUFn):
    """Within: the models' WKV6 and RG-LRU are the plain forward and
    backward functions (by default; no kernel launches, and not autograd
    of the scans, which would keep a state a step), on any device."""
    kernels = wkv_ops.wkv6, rg_ops.rglru
    wkv_ops.wkv6 = wkv_fn.apply
    rg_ops.rglru = rglru_fn.apply
    try:
        yield
    finally:
        wkv_ops.wkv6, rg_ops.rglru = kernels


# the plain versions the kernel wrappers call on CPU tensors
PLAIN_FUNCTIONS = ((wkv_ops, "wkv6_reference"),
                   (wkv_ops, "wkv6_backward_reference"),
                   (rg_ops, "rglru_reference"),
                   (rg_ops, "rglru_backward_reference"),
                   (fa_ops, "attention_reference"),
                   (fa_ops, "attention_reference_lse"),
                   (fa_ops, "attention_backward_reference"))


@contextlib.contextmanager
def counted_plain_calls(calls: dict):
    """Within: each call the wrappers make of a plain version (which they
    make only for CPU tensors) is counted in ``calls`` by name."""
    saved = [(mod, name, getattr(mod, name)) for mod, name in
             PLAIN_FUNCTIONS]
    for mod, name, fn in saved:
        calls.setdefault(name, 0)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        setattr(mod, name, counted)
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def recurrent_train_launches(cfg, device) -> dict:
    """``train_launches`` of ``cfg`` and the recurrences' launches of one
    train step: each forward kernel once per layer and again under remat,
    and each backward kernel once per layer, for RG-LRU both of the kernel
    ``variant`` picks (none on the CPU).  recurrentgemma-9b's local layers
    take the flash backward's tensor-core pair (bf16 at head dim 256)."""
    prefill = path_launches(cfg, device)[0]
    again = 1 if cfg.remat == "none" else 2
    by_kind = rglru_variant_launches(cfg, device)
    return {**train_launches(cfg, device),
            "wkv6": again * prefill["wkv6"], "wkv6_bwd": prefill["wkv6"],
            "rglru": again * prefill["rglru"],
            **{k: again * n for k, n in by_kind.items()},
            "rglru_bwd": prefill["rglru"],
            **{k.replace("rglru.", "rglru_bwd."): n
               for k, n in by_kind.items()}}


# The recurrent drives' witness, at sequence WITNESS_SEQ on the card: the
# loss and gradients with the kernels against the same call with the plain
# recurrences (float32 forward) and the plain attention (forward and
# backward), the loss within BF16_LOSS_REL.  Both compute the recurrence
# in float32 (the backward in float64) on the same bf16 operands and
# differ in the order of the forward's sums, which flips bf16 roundings of
# its outputs that the next layers carry: the kernels' worst gradient
# error (of its leaf's largest magnitude) may be REC_WITNESS_K times that
# of the yardstick, the plain recurrences with a float64 forward and the
# flash backward's CUDA-core pair (float32 sums of the same bf16
# operands), which differ from the plain arm by just such roundings.  (A
# first fixed limit of 5e-2 read 0.0566 on rwkv6-7b's decoder.0.mix.wo, of
# a leaf whose largest magnitude is 0.011.)
WITNESS_SEQ = 512
REC_WITNESS_K = BF16_WITNESS_K
# rwkv6-7b at 8 of its 32 layers (2.29 G parameters, 36.6 GB of parameter,
# gradient, master and moments), batch 4; recurrentgemma-9b at one whole
# pattern, 3 of 38 layers (2.76 G parameters, 2.1 G of them the untied
# embedding and head, 44 GB), batch 2 (its 256,000-wide logits and AdamW's
# temporaries would pass 80 GB at 4)
RECURRENT_TRAIN = (("lm_train_rwkv", "rwkv6-7b", 8, 4),
                   ("lm_train_griffin", "recurrentgemma-9b", 3, 2))


def phase_lm_train_recurrent(device, cfg, ocfg=None, batch=4, seq=2048,
                             steps=8, witness_seq=WITNESS_SEQ,
                             time_it=True):
    """A recurrent arch (rwkv6-7b or recurrentgemma-9b, cut in depth) in
    bf16 (remat "block"; AdamW's float32 master and moments), batches of
    ``TokenPipeline`` (seed 0), the launcher's AdamW settings unless
    ``ocfg`` is given: the gradient witness at ``witness_seq`` (the loss
    and gradients, ``loss_and_grads``, against the same call with the
    plain recurrences and the plain attention, beside the float64
    recurrences with the flash backward's CUDA-core pair); a step's
    launches by kernel, with no plain call;
    ``steps`` steps on LEARN_VOCAB data, each loss finite and the last
    below the first; with ``time_it``, ms a step, tokens/s, peak memory, a
    traced step's idle share and device time by kernel group.  A model
    with attention layers (recurrentgemma-9b's local ones), also the flash
    backward at the drive's shape (its D 256 pair) against the plain
    backward, timed beside its bound, the CUDA-core pair, the plain
    backward and SDPA's backward."""
    ocfg = ocfg or train_opt.AdamWConfig(lr=3e-3, warmup_steps=10,
                                         total_steps=steps)
    if cfg.dtype != "bfloat16":
        raise ValueError(f"the recurrent drives train a bf16 model, not "
                         f"{cfg.dtype}")
    t0 = time.perf_counter()
    params = model_lib.init_params(cfg, seed=0, device=device)
    n_params = sum(p.numel() for p in params.parameters())
    pipe = TokenPipeline(cfg.vocab_size, seq, batch, seed=0)

    def batch_at(i, pipe=pipe):
        return {k: torch.from_numpy(v).to(device)
                for k, v in pipe.batch_at(i).items()}
    sync(device)
    result = dict(arch=cfg.name, layers=cfg.num_layers, params=n_params,
                  batch=batch, seq=seq, remat=cfg.remat, dtype=cfg.dtype,
                  witness_seq=witness_seq, init_s=time.perf_counter() - t0)

    # the witness: kernels against the plain recurrences and the plain
    # attention, at witness_seq, beside the plain recurrences with a
    # float64 forward and the flash backward's CUDA-core pair
    wb = batch_at(0, TokenPipeline(cfg.vocab_size, witness_seq, batch,
                                   seed=0))
    loss, g_kernel = train_loop.loss_and_grads(params, wb, cfg)[::2]
    sync(device)
    reset_launches()
    with plain_recurrences(), plain_attention():
        plain_loss, g_plain = train_loop.loss_and_grads(params, wb, cfg)[::2]
    with plain_recurrences(Float64WKV6Fn, Float64RGLRUFn), \
            plain_attention(CudaCoreBackwardFn):
        f64_loss, g_f64 = train_loop.loss_and_grads(params, wb, cfg)[::2]
    sync(device)
    ran = {k: n for k, n in read_launches().items()
           if k.startswith(("wkv6", "rglru")) and n}
    if ran:
        raise AssertionError(f"the plain witnesses launched {ran}")
    inf = float("inf")
    errs = {kind: {name: require_scaled(g[name], ref, inf,
                                        f"{cfg.name} {kind} d {name}")
                   for name, ref in g_plain.items()}
            for kind, g in (("kernels", g_kernel), ("float64", g_f64))}
    worst = {kind: max(e, key=e.get) for kind, e in errs.items()}
    result["witness"] = dict(
        loss=float(loss), plain_loss=float(plain_loss),
        float64_loss=float(f64_loss),
        grad_norm=float(train_opt.global_norm(g_kernel)),
        plain_grad_norm=float(train_opt.global_norm(g_plain)),
        worst_grad=worst,
        worst_grad_rel_err={k: errs[k][w] for k, w in worst.items()})
    del g_kernel, g_plain, g_f64, wb
    if not abs(float(loss) - float(plain_loss)) <= BF16_LOSS_REL * abs(
            float(plain_loss)):
        raise AssertionError(f"{cfg.name} witness: loss {float(loss)} vs "
                             f"plain {float(plain_loss)} (limit "
                             f"{BF16_LOSS_REL} relative)")
    e = result["witness"]["worst_grad_rel_err"]
    if not e["kernels"] <= REC_WITNESS_K * e["float64"]:
        raise AssertionError(f"{cfg.name} witness: the kernels' worst "
                             f"gradient error {e['kernels']} is past "
                             f"{REC_WITNESS_K} x the float64 forward's "
                             f"{e['float64']}")
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    # ``steps`` steps on data that can be learned in that many; the first
    # counted by kernel, with no plain version called; on the card also
    # the D 256 backward's partial sums where its dK/dV blocks split the
    # heads at this shape
    want = recurrent_train_launches(cfg, device)
    if torch.device(device).type == "cuda":
        split = fa_ops.bwd_split(batch, cfg.num_heads, cfg.num_kv_heads, seq,
                                 cfg.head_dim, fa_ops._sms(device))
        want["flash_attention.bwd_sum"] = (
            want["flash_attention.bwd_wgmma"] if split > 1 else 0)
    learn = TokenPipeline(LEARN_VOCAB, seq, batch, seed=0)
    p, params = params, None
    state = train_opt.init(p)
    step = train_loop.make_train_step(cfg, ocfg)
    losses, step_ms, plain_calls = [], [], {}
    sync(device)
    reset_launches()
    for i in range(steps):
        t0 = time.perf_counter()
        if i == 0 and torch.device(device).type == "cuda":
            with counted_plain_calls(plain_calls):
                p, state, m = step(p, state, batch_at(i, learn))
        else:
            p, state, m = step(p, state, batch_at(i, learn))
        losses.append(float(m["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            result["step_launches"] = require_launches(
                want, f"one {cfg.name} train step")
            if any(plain_calls.values()):
                raise AssertionError(f"a {cfg.name} train step called plain"
                                     f" versions: {plain_calls}")
    result["launches"] = require_launches(
        {k: n * steps for k, n in want.items()},
        f"{steps} {cfg.name} train steps")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"{cfg.name}: the losses are not finite or the"
                             f" last is not below the first: {losses}")
    result.update(losses=losses, step_ms=step_ms, plain_calls=plain_calls)
    if time_it:
        result["ms_per_step_median"] = float(np.median(step_ms[1:]))
        result["tokens_per_s"] = (batch * seq * 1e3
                                  / result["ms_per_step_median"])
        torch.cuda.reset_peak_memory_stats()
        b0 = batch_at(steps, learn)
        sync(device)
        t0 = time.perf_counter()
        p, state, _ = step(p, state, b0)
        sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
        result["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        prof = device_profile(lambda: step(p, state, b0), 1,
                              RECURRENT_BWD_KERNELS)
        prof["wall_ms"] = wall_ms
        prof["idle_share"] = 1 - prof["device_ms"] / wall_ms
        result["step_profile"] = prof
    del p, state
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    if any(cfg.layer_type(i) in transformer.ATTN_KINDS
           for i in range(cfg.num_layers)):
        result["flash_backward"] = flash_bwd_at(
            device, cfg, batch, seq, time_it)
    return result


def flash_bwd_at(device, cfg, batch, seq, time_it=True) -> dict:
    """The flash backward at a drive's attention shape (``cfg``'s heads,
    head dim and window, causal, its type), through the pair
    ``bwd_variant`` picks, against the plain backward; with ``time_it``
    by device time beside its bound (operations: ``flash_bwd_ops`` at the
    bf16 peak), the CUDA-core pair (``fma_ms``), the plain backward and
    SDPA's backward."""
    dtype = getattr(torch, cfg.dtype)
    b, h, kh, d = batch, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kw = dict(mode="causal", window=cfg.window)
    errs, (q, k, v, out, lse, do) = flash_bwd_check(
        device, dtype, b, h, kh, seq, seq, d, kw, 9,
        f"flash bwd at {cfg.name}'s shape")
    flops = flash_bwd_ops(b, h, seq, seq, d, True, cfg.window)
    r = dict(shape=(b, h, kh, seq, seq, d, str(dtype)[6:]),
             window=cfg.window, pair=errs["pair"], errs=errs, flops=flops,
             bound_ms=flops / BF16_FLOP_PER_S * 1e3, bound_by="operations")
    if time_it:
        r.update(flash_bwd_times(q, k, v, out, lse, do, kw, r["pair"],
                                 flops))
    return r


# ---------------------------------------------------------------------------
# where the LM path's device time goes
# ---------------------------------------------------------------------------

# the recurrences' backward kernels (a name is matched as a substring:
# rglru_bwd_kernel is not one of rglru_bwd_ring_kernel)
WKV6_BWD_KERNELS = ("wkv6_bwd_chunk_kernel",)
RGLRU_BWD_KERNELS = ("rglru_bwd_ring_kernel", "rglru_bwd_kernel")
RECURRENT_BWD_KERNELS = WKV6_BWD_KERNELS + RGLRU_BWD_KERNELS
KERNEL_GROUPS = (("flash_attention", ("flash_fwd_kernel",
                                      "flash_wgmma_kernel")),
                 ("flash_backward", FLASH_BWD_KERNELS),
                 ("decode_attention", DECODE_KERNELS),
                 ("wkv6_bwd", WKV6_BWD_KERNELS),
                 ("rglru_bwd", RGLRU_BWD_KERNELS),
                 ("wkv6", ("wkv6_kernel",)),
                 ("rglru", ("rglru_kernel", "rglru_ring_kernel")),
                 ("matmul", ("gemm", "gemv", "nvjet", "xmma", "cutlass")))


def device_profile(fn, steps: int, kernels=()) -> dict:
    """Device time by kernel group over ``steps`` calls of ``fn`` (a
    torch.profiler trace of the card), per call, and the number of device
    kernels per call; with ``kernels``, also the time of the kernels whose
    names hold each of them."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    groups = {g: 0.0 for g, _ in KERNEL_GROUPS}
    groups["other"] = 0.0
    named = {k: 0.0 for k in kernels}
    count = 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        count += e.count
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(k in e.key for k in keys)), "other")
        groups[group] += us / 1e3 / steps
        for k in named:
            named[k] += us / 1e3 / steps if k in e.key else 0.0
    out = dict(device_ms=sum(groups.values()), by_group_ms=groups,
               device_ops=count / steps)
    if kernels:
        out["by_kernel_ms"] = named
    return out


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

KERNELS = (
    # name, phase, source, replaces, the CUDA kernels behind the wrapper
    ("chain_vm.run_managed", "chain_kernel",
     "src/repro_torch/csrc/chain_vm.cu",
     "src/repro/kernels/chain_vm/kernel.py:66",
     ("managed_whole_kernel", "managed_window_kernel")),
    # no TPU kernel: the JAX package's run is a lax.while_loop under jit
    ("chain_interp.run_interp", "chain_interp",
     "src/repro_torch/csrc/chain_interp.cu", "src/repro/core/machine.py:447",
     ("chain_interp_kernel",)),
    # no TPU kernel: the JAX package walks a write stage's window as a
    # lax.scan of image build, run and commit under jit
    ("chain_interp.walk", "kv_write", "src/repro_torch/csrc/chain_interp.cu",
     "src/repro/rdma/transport.py:196", (WALK_KERNEL,)),
    ("chain_vm.run_chains", "chain_straight",
     "src/repro_torch/csrc/chain_vm.cu",
     "src/repro/kernels/chain_vm/kernel.py:30", ("run_chains_kernel",)),
    ("hopscotch.hopscotch_lookup", "hopscotch_probe",
     "src/repro_torch/csrc/hopscotch.cu",
     "src/repro/kernels/hopscotch/kernel.py:31", ("probe_kernel",)),
    ("flash_attention.flash_attention", "flash_kernel",
     "src/repro_torch/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention/kernel.py:31",
     ("flash_wgmma_kernel", "flash_fwd_kernel")),
    ("decode_attention.decode_partial", "decode_kernel",
     "src/repro_torch/csrc/decode_attention.cu",
     "src/repro/kernels/decode_attention/kernel.py:24", DECODE_KERNELS),
    ("rwkv6.wkv6", "wkv6_kernel", "src/repro_torch/csrc/wkv6.cu",
     "src/repro/kernels/rwkv6/kernel.py:61", ("wkv6_kernel",)),
    ("rglru.rglru", "rglru_kernel", "src/repro_torch/csrc/rglru.cu",
     "src/repro/kernels/rglru/kernel.py:32",
     ("rglru_ring_kernel", "rglru_kernel")),
    # no TPU kernel: the JAX package's flash backward is plain JAX
    ("flash_attention.backward", "flash_bwd_kernel",
     "src/repro_torch/csrc/flash_attention_bwd.cu",
     "src/repro/kernels/flash_attention/ops.py:166", FLASH_BWD_KERNELS),
    # no TPU kernel: the JAX package differentiates its chunked forms
    ("rwkv6.wkv6_backward", "wkv6_bwd_kernel",
     "src/repro_torch/csrc/wkv6_bwd.cu", "src/repro/kernels/rwkv6/ops.py:15",
     WKV6_BWD_KERNELS),
    ("rglru.rglru_backward", "rglru_bwd_kernel",
     "src/repro_torch/csrc/rglru_bwd.cu", "src/repro/kernels/rglru/ops.py:14",
     RGLRU_BWD_KERNELS),
)
# the phases in the order main() runs them
PHASES = ("kv_get", "kv_get_group", "chain_kernel", "chain_faults",
          "chain_interp", "chain_straight",
          "hopscotch_probe", "kv_write", "kv_faults", "kv_resize",
          "kv_contend", "kv_service", "chain_programs", "cuckoo_get",
          "lm_prefill", "lm_serve",
          "lm_float32", "flash_kernel", "decode_kernel", "lm_rwkv",
          "lm_griffin", "lm_gemma3", "lm_gemma3_cache", "lm_mixtral",
          "lm_phi3v", "lm_seamless", "lm_llama4", "lm_llama4_nope",
          "wkv6_kernel", "rglru_kernel",
          "wkv6_bwd_kernel", "rglru_bwd_kernel", "flash_bwd_kernel",
          "lm_train", "lm_train_bf16", "lm_train_rwkv", "lm_train_griffin")
# the paths whose multi-WQ chains run on the interpreter kernel
INTERP_PATHS = ("kv_get", "kv_write", "kv_faults", "kv_resize", "kv_contend",
                "kv_service", "chain_programs")
# the paths whose single-chain write stages walk on the walk kernel (each
# must launch it; kv_contend's one-lane SETs walk too)
WALK_PATHS = ("kv_write", "kv_faults", "kv_resize", "kv_service")
# a row whose numbers sit under a key of its phase's result
ROW_KEYS = {"chain_interp.walk": "walk_kernel"}
LM_ARCH = "qwen3-1.7b"
# each drive's flash launches per prefill: (kernel, one per attention,
# encoder and cross-attention layer)
FLASH_DRIVE_LAUNCHES = {"lm_prefill": ("wgmma", 28),
                        "lm_griffin": ("wgmma", 12),
                        "lm_float32": ("fma", 28),
                        "lm_gemma3": ("wgmma", 26),
                        "lm_gemma3_cache": ("wgmma", 26),
                        "lm_mixtral": ("wgmma", 4),
                        "lm_phi3v": ("wgmma", 32),
                        "lm_seamless": ("wgmma", 36),
                        "lm_llama4": ("wgmma", 1),
                        "lm_llama4_nope": ("wgmma", 1)}
RECURRENT_ARCHS = (("lm_rwkv", "rwkv6-7b"), ("lm_griffin", "recurrentgemma-9b"))
# the other archs' drives: (phase, arch, config changes, prompt tokens).
# gemma3-1b whole (its 512 window binds at 2,048), then with the rolling
# int8 caches on the same weights; mixtral-8x7b at 4 of its 32 layers
# (about 12 GB), drop-free as its own router is; phi-3-vision's 576 patch
# positions before 1,472 tokens; seamless with 2,048 frames; llama4-maverick
# at 1 of its 48 layers (128 experts, ~36.7 GB of weights) with the
# capacity its config defines, its pattern's first layer (local, window
# 8,192) and then, on fresh weights, one NoPE layer (causal, no RoPE),
# each with phi-3-vision's 576 patch positions before 1,472 tokens.
ARCH_DRIVES = (
    ("lm_gemma3", "gemma3-1b", {}, 2048),
    ("lm_gemma3_cache", "gemma3-1b", dict(window_cache=True, kv_quant=True),
     2048),
    ("lm_mixtral", "mixtral-8x7b", dict(num_layers=4, capacity_factor=8.0),
     1024),
    ("lm_phi3v", "phi-3-vision-4.2b", {}, 1472),
    ("lm_seamless", "seamless-m4t-medium", {}, 2048),
    ("lm_llama4", "llama4-maverick-400b-a17b", dict(num_layers=1), 1472),
    ("lm_llama4_nope", "llama4-maverick-400b-a17b",
     dict(num_layers=1, layer_pattern=("nope",)), 1472))


# the head dims of the tensor-core flash kernel's instantiations
WGMMA_HEAD_DIMS = tuple(sorted(d for (_, d), kind in fa_ops.VARIANTS.items()
                               if kind == "wgmma"))


def hgmma_by_head_dim(sass: str, kernel: str = "flash_wgmma_kernel",
                      head_dims=WGMMA_HEAD_DIMS) -> dict:
    """The HGMMA (tensor-core) instructions of each ``kernel<D>`` function
    (``flash_wgmma_kernel`` by default) in a ``cuobjdump -sass`` listing,
    by D; raises unless every head dim of ``head_dims`` has a function
    that holds some."""
    counts, head_dim = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(re.escape(kernel) + r"(?:ILi|<)(\d+)", line)
            head_dim = int(m.group(1)) if m else None
            if head_dim is not None:
                counts[head_dim] = 0
        elif head_dim is not None and "HGMMA" in line:
            counts[head_dim] += 1
    bare = [d for d in head_dims if not counts.get(d)]
    if bare:
        raise AssertionError(
            f"{kernel} at head dims {bare} holds no HGMMA "
            f"instruction (counts {counts}): not on the tensor cores")
    return counts


def template_args(mangled: str) -> list:
    """The template arguments of a mangled kernel name's instantiation,
    from its name's ``I ... E`` list: ints (``Li64E``) as they are, bools
    (``Lb1E``) as ``true`` / ``false``, float as ``float``, __nv_bfloat16
    as ``bf16``."""
    args, i = [], 1
    if not mangled.startswith("I"):
        return args
    while i < len(mangled) and mangled[i] != "E":
        if mangled.startswith("Li", i):
            j = mangled.index("E", i)
            args.append(mangled[i + 2:j])
            i = j + 1
        elif mangled.startswith("Lb", i):
            j = mangled.index("E", i)
            args.append("true" if mangled[i + 2:j] == "1" else "false")
            i = j + 1
        elif mangled[i] == "f":
            args.append("float")
            i += 1
        elif mangled[i].isdigit():
            m = re.match(r"\d+", mangled[i:])
            j = i + len(m.group(0)) + int(m.group(0))
            name = mangled[i + len(m.group(0)):j]
            args.append("bf16" if "bfloat16" in name else name)
            i = j
        else:
            break
    return args


def ptxas_report(log: str, kernels) -> dict:
    """Registers and spills of each instantiation of the named kernels,
    from a ``-Xptxas -v`` build log, by ``kernel<args>`` (``kernel<D>``
    for the flash kernels, templated on the head dim alone)."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = next((k for k in kernels if k in m.group(1)), None)
            args = template_args(m.group(1).split(k, 1)[1]) if k else []
            name = f"{k}<{','.join(args)}>" if args else None
            if name:
                out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name].update(spill_stores=int(m.group(1)),
                             spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            name = None
    return out


def check_spill_free(ptxas: dict, kernels) -> None:
    """Raises unless ``ptxas`` (``ptxas_report``'s) reports registers for
    at least one instantiation of each kernel and for every one it holds,
    and no spill in any."""
    missing = [k for k in kernels
               if not any(n.startswith(k + "<") for n in ptxas)]
    missing += [n for n, r in ptxas.items() if "registers" not in r]
    if missing:
        raise AssertionError(f"no ptxas report for {missing}")
    spilled = {k: r for k, r in ptxas.items()
               if r.get("spill_stores") or r.get("spill_loads")}
    if spilled:
        raise AssertionError(f"ptxas spills: {spilled}")


def check_ptxas(ptxas: dict, kernels, head_dims) -> None:
    """Raises unless ``ptxas`` (``ptxas_report``'s) reports registers for
    each ``kernel<D>`` and no spill in any."""
    missing = [f"{k}<{d}>" for k in kernels for d in head_dims
               if "registers" not in ptxas.get(f"{k}<{d}>", {})]
    if missing:
        raise AssertionError(f"no ptxas report for {missing}")
    spilled = {k: r for k, r in ptxas.items()
               if r.get("spill_stores") or r.get("spill_loads")}
    if spilled:
        raise AssertionError(f"the tensor-core backward spills: {spilled}")


def run_phase(phases, key, fn):
    """``phases[key] = fn()``, with the interpreter kernel's launches in
    the phase (counted from 0; not the rows route's, the walk's
    yardstick) as its ``interp_launches`` and the walk kernel's as its
    ``walk_launches``."""
    t0 = time.perf_counter()
    interp_ops.launches["run_interp"] = interp_ops.launches["walk"] = 0
    YARDSTICK["run_interp"] = YARDSTICK["walk"] = 0
    phases[key] = fn()
    phases[key]["interp_launches"] = (interp_ops.launches["run_interp"]
                                      - YARDSTICK["run_interp"])
    phases[key]["walk_launches"] = (interp_ops.launches["walk"]
                                    - YARDSTICK["walk"])
    shown = {k: v for k, v in phases[key].items() if k != "rows"}
    print(f"[{key}] {time.perf_counter() - t0:.1f} s: {shown}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this test runs on the "
                         "card only")
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False    # plain float32 is exact
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"[card] {name} | nvidia-smi: {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"[card] kernels built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for src, log in logs.items():
        print(f"[build {src}] " + " | ".join(
            line.strip() for line in log.splitlines() if "registers" in line
            or "spill" in line or "arning" in line), flush=True)
    hgmma = hgmma_by_head_dim(_build.sass("flash_attention"))
    print(f"[card] flash_attention: HGMMA instructions in the SASS of "
          f"flash_wgmma_kernel by head dim: {hgmma}", flush=True)
    ptxas = ptxas_report(logs.get("flash_attention_bwd", ""),
                         BWD_WGMMA_KERNELS)
    print(f"[card] flash_attention_bwd: ptxas of the tensor-core pair "
          f"{ptxas}", flush=True)
    check_ptxas(ptxas, BWD_WGMMA_KERNELS, BWD_WGMMA_HEAD_DIMS)
    rec_ptxas = {**ptxas_report(logs.get("wkv6_bwd", ""), WKV6_BWD_KERNELS),
                 **ptxas_report(logs.get("rglru_bwd", ""),
                                RGLRU_BWD_KERNELS)}
    print(f"[card] the recurrences' backward kernels: ptxas {rec_ptxas}",
          flush=True)
    check_spill_free(rec_ptxas, RECURRENT_BWD_KERNELS)
    interp_ptxas = ptxas_report(logs.get("chain_interp", ""),
                                ("chain_interp_kernel",))
    print(f"[card] chain_interp: ptxas of each <one warp, split> "
          f"instance {interp_ptxas}", flush=True)
    check_spill_free(interp_ptxas, ("chain_interp_kernel",))
    if len(interp_ptxas) != 4:
        raise AssertionError(f"{len(interp_ptxas)} chain_interp_kernel "
                             f"instances in the ptxas report, not 4")
    walk_ptxas = ptxas_report(logs.get("chain_interp", ""), (WALK_KERNEL,))
    print(f"[card] chain_interp: ptxas of each <one warp> instance of "
          f"{WALK_KERNEL} {walk_ptxas}", flush=True)
    check_spill_free(walk_ptxas, (WALK_KERNEL,))
    if len(walk_ptxas) != 2:
        raise AssertionError(f"{len(walk_ptxas)} {WALK_KERNEL} instances "
                             f"in the ptxas report, not 2")
    lib = _build.load("flash_attention_bwd", fa_ops._declare_bwd)
    if lib.flash_attention_wgmma_bwd_keys(256) != fa_ops.BWD_KEYS_256:
        raise AssertionError(
            f"a D 256 dK/dV block owns "
            f"{lib.flash_attention_wgmma_bwd_keys(256)} keys, bwd_split "
            f"counts {fa_ops.BWD_KEYS_256}")
    smem = {d: {kname: lib.flash_attention_wgmma_bwd_smem(d, which)
                for which, kname in enumerate(("dq", "dkdv"))}
            for d in BWD_WGMMA_HEAD_DIMS}
    print(f"[card] flash_attention_bwd: the tensor-core pair's dynamic "
          f"shared memory a block by head dim: {smem} bytes", flush=True)

    phases, stored = {}, []

    def kv_get():
        res, *arrays = phase_kv_get(device)
        stored.extend(arrays)
        return res

    run_phase(phases, "kv_get", kv_get)
    kv, dk, dv = stored
    g_ = phases["kv_get"]
    bd = g_["redn_breakdown"]
    print(f"[times] kv_get ({card}): gets/s by path " + ", ".join(
        f"{m} {x:.1f}" for m, x in g_["gets_per_s"].items())
          + "; latency a GET (median ms, one request at a time) " + ", ".join(
              f"{m} {x:.4f}" for m, x in g_["get_latency_ms"].items())
          + "; peak bytes a batch " + ", ".join(
              f"{m} {x}" for m, x in g_["peak_bytes"].items())
          + "; redn stages (ms): " + ", ".join(
              f"{k[:-3]} {x:.4f}" for k, x in bd.items()
              if k.endswith("_ms") and k != "step_ms")
          + f"; {bd['contexts']} contexts of {bd['private_words']} private "
          f"words (images of {bd['image_words']}), {bd['deliver_bytes']} "
          f"bytes delivered (full copies: {bd['full_copy_bytes']})",
          flush=True)
    run_phase(phases, "kv_get_group",
              lambda: phase_kv_get_group(device, kv, dk, dv))
    g_ = phases["kv_get_group"]
    print(f"[times] kv_get_group ({card}): gets/s by path, one device / "
          f"group of {g_['ranks']} ({g_['backend']}): " + ", ".join(
              f"{m} {x['one_device']:.1f} / {x['group']:.1f}"
              for m, x in g_["gets_per_s"].items())
          + f"; all-to-all exchange of {g_['exchange_bytes']} bytes "
          f"{g_['exchange_ms']:.4f} ms", flush=True)
    run_phase(phases, "chain_kernel", lambda: phase_chain_kernel(device))
    run_phase(phases, "chain_faults", lambda: phase_chain_faults(device))
    run_phase(phases, "chain_interp", lambda: phase_chain_interp(
        device, kv, dk, dv))
    ci = phases["chain_interp"]
    print(f"[times] chain_interp ({card}): the kernel against the plain loop"
          f" (ms, CUDA events), serial floor at {INTERP_STEP_TRIPS} trips a "
          f"step (cycles {ci['load_cycles']}; split batches: shared-memory "
          f"trips and an L2 trip a READ): " + "; ".join(
              f"{k} {x['runs']} runs of {x['rows']} rows, WQs {x['wqs']}, "
              f"split {x['split']}, "
              f"{x['steps_max']} steps max: kernel {x['ms']:.4f} (by "
              f"{x['timed_by']}; the wrapper's call {x['call_ms']:.4f}), "
              f"plain {x['plain_ms']:.4f}, floor {x['serial_floor_ms']:.4f}, "
              f"bytes bound {x['bound_ms']:.6f}"
              for k, x in ci["cases"].items())
          + f"; redn: {ci['redn_contexts']} contexts of "
          f"{ci['redn_private_words']} private words (images of "
          f"{ci['redn_image_words']}, window {ci['redn_window']}), "
          f"{ci['window_refused']} window stores refused", flush=True)
    torch.cuda.empty_cache()
    run_phase(phases, "chain_straight", lambda: phase_chain_straight(device))
    run_phase(phases, "hopscotch_probe",
              lambda: phase_hopscotch_probe(device, kv, dk, dv))
    run_phase(phases, "kv_write", lambda: phase_kv_write(device, kv, dk, dv))
    w = phases["kv_write"]
    wk_ = w["walk_kernel"]
    print(f"[times] kv_write ({card}): by host clock, the walk / _walk: SET "
          f"batch {w['set_ms']:.1f} / {w['set_rows_ms']:.1f} ms "
          f"({w['sets_per_s']:.1f} SETs/s), stages {w['set_stages']}; "
          f"DELETE batch {w['delete_ms']:.1f} / {w['delete_rows_ms']:.1f} "
          f"ms; sweep quantum of {w['sweep_count']} {w['sweep_ms']:.1f} / "
          f"{w['sweep_rows_ms']:.1f} ms; SET batch by device time from a "
          f"trace: {WALK_KERNEL} {w['set_walk_kernel_ms']} ms, "
          f"_walk's chain_interp_kernel {w['set_rows_interp_ms']} ms, all "
          f"kernels {w['set_device_ms']} / {w['set_rows_device_ms']} ms, "
          f"idle share {w['set_idle_share']} / {w['set_rows_idle_share']} "
          f"(of {w['set_untraced_ms']} / {w['set_rows_untraced_ms']} ms "
          f"by host clock); the walk kernel replayed "
          f"on the batch's stages {wk_['ms']:.4f} ms (by {wk_['timed_by']}),"
          f" plain walk {wk_['plain_ms']:.1f} ms, serial floor "
          f"{wk_['serial_floor_ms']:.4f} ms (lockstep "
          f"{wk_['lockstep_floor_ms']:.4f}), bytes bound "
          f"{wk_['bytes_bound_ms']:.6f} ms; peak device memory "
          f"{w['max_memory_allocated']} bytes", flush=True)
    run_phase(phases, "kv_faults", lambda: phase_kv_faults(device, kv, dk,
                                                           dv))
    f = phases["kv_faults"]
    print(f"[times] kv_faults ({card}): fsck of {f['buckets']} buckets "
          f"{f['fsck_ms']:.2f} ms (clean store {f['final_fsck_ms']:.2f} ms, "
          f"planted {f['planted_fsck_ms']:.2f} ms), repair of "
          f"{f['repairs']} violations {f['repair_ms']:.2f} ms", flush=True)
    run_phase(phases, "kv_resize", lambda: phase_kv_resize(device, kv, dk,
                                                           dv))
    r_ = phases["kv_resize"]
    print(f"[times] kv_resize ({card}): by host clock, the walk / _walk: "
          f"quanta of {r_['step']} laps {r_['quantum_ms']} / "
          f"{r_['quantum_rows_ms']} ms, the faulted one "
          f"{r_['faulted_quantum_ms']} / {r_['faulted_quantum_rows_ms']} ms;"
          f" stages {r_['quantum_stages']}", flush=True)
    run_phase(phases, "kv_contend", lambda: phase_kv_contend(device, kv, dk,
                                                             dv))
    c_ = phases["kv_contend"]
    print(f"[times] kv_contend ({card}): SETs/s "
          + ", ".join(f"{k} {x:.1f} ({c_['set_ms'][k]:.1f} ms)"
                      for k, x in c_["sets_per_s"].items())
          + f"; cut sweep of {c_['cuts']} cuts in one batch "
          f"{c_['sweep_ms']:.1f} ms ({c_['sweep_steps_max']} lockstep "
          f"steps, {c_['sweep_steps_total']} machine steps, "
          f"{c_['sweep_steps_per_s']:.1f} steps/s); fairness run "
          f"{c_['fair_steps']} steps in {c_['fair_ms']:.1f} ms "
          f"({c_['fair_ms_per_step']:.3f} ms a scheduled step, "
          f"{c_['fair_steps_per_s']:.1f} steps/s), best/worst "
          f"{c_['fairness_ratio']:.4f}; isolation deferred "
          f"{c_['isolation_deferred']}", flush=True)
    run_phase(phases, "kv_service", lambda: phase_kv_service(device, kv, dk,
                                                             dv))
    print(f"[times] kv_service ({card}): " + ", ".join(
        f"{k} {x:.1f} ms" for k, x in phases["kv_service"]["ms"].items())
        + f"; growth {phases['kv_service']['growth_s']:.1f} s, chained "
        f"growth {phases['kv_service']['chained_growth_s']:.1f} s",
        flush=True)
    del kv, dk, dv
    torch.cuda.empty_cache()
    run_phase(phases, "chain_programs",
              lambda: phase_chain_programs(device))
    g = phases["chain_programs"]["guests"]
    lw = phases["chain_programs"]["lists"]
    print(f"[times] chain_programs ({card}): verifier sweep "
          f"{phases['chain_programs']['sweep_s']:.1f} s; "
          f"{g['guests']} ADDLEQ guests "
          f"{g['shape']}, kernel {g['ms']:.4f} ms (trace {g['trace_ms']:.4f}"
          f", events {g['event_ms']:.4f}; bound "
          f"{g['bound_ms']:.4f} ms, serial floor {g['serial_floor_ms']:.4f}"
          f" ms over {g['steps_max']} steps at {g['load_cycles']['shared']}"
          f" cycles a shared load, {g['serial_floor_l2_ms']:.4f} ms at "
          f"{g['load_cycles']['l2']} an L2 hit; the looping guest alone "
          f"{g['loop_guest_ms']:.4f} ms, "
          f"{g['loop_guest_cycles_per_step']:.1f} cycles a step; engine "
          f"{g['engine_ms']:.1f} "
          f"ms), plain {g['plain_ms']:.1f} ms, interpreter "
          f"{g['interp_ms']:.1f} ms ({g['interp_ms_per_step']:.4f} ms a "
          f"step); guest instructions "
          f"a second: kernel {g['guest_instrs_per_s']:.1f}, interpreter "
          f"{g['interp_guest_instrs_per_s']:.1f}; list walks of "
          f"{lw['probes']} probes {lw['ms']}, break saves "
          f"{lw['break_saves_at_0']} steps at position 0", flush=True)
    torch.cuda.empty_cache()
    run_phase(phases, "cuckoo_get", lambda: phase_cuckoo_get(device))
    c_ = phases["cuckoo_get"]
    print(f"[times] cuckoo_get ({card}): {c_['queries']} lookups "
          f"{c_['ms']:.4f} ms ({c_['lookups_per_s']:.1f} lookups/s, bound "
          f"{c_['bound_ms']:.4f} ms), table {c_['table_bytes']} bytes, host"
          f" fill {c_['fill_s']:.1f} s", flush=True)
    torch.cuda.empty_cache()

    cfg = registry.get_config(LM_ARCH)
    t0 = time.perf_counter()
    params = model_lib.init_params(cfg, seed=0, device=device)
    sync(device)
    print(f"[lm] {LM_ARCH}: {sum(p.numel() for p in params.parameters())} "
          f"parameters ({cfg.dtype}) initialised in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    run_phase(phases, "lm_prefill",
              lambda: phase_lm_prefill(device, cfg, params))
    run_phase(phases, "lm_serve", lambda: phase_lm_serve(device, cfg, params))
    run_phase(phases, "lm_float32", lambda: phase_lm_float32(
        device, cfg, params, phases["lm_prefill"].pop("rows"), {}))
    del params
    torch.cuda.empty_cache()
    run_phase(phases, "flash_kernel", lambda: phase_flash_kernel(device))
    torch.cuda.empty_cache()
    run_phase(phases, "decode_kernel", lambda: phase_decode_kernel(device))
    torch.cuda.empty_cache()
    for key, arch in RECURRENT_ARCHS:
        cfg = registry.get_config(arch)
        t0 = time.perf_counter()
        params = model_lib.init_params(cfg, seed=0, device=device)
        sync(device)
        print(f"[{key}] {arch}: {sum(p.numel() for p in params.parameters())}"
              f" parameters ({cfg.dtype}) initialised in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        run_phase(phases, key, lambda: phase_lm_recurrent(device, cfg,
                                                          params))
        del params
        torch.cuda.empty_cache()
    params, shape = None, None
    for key, arch, changes, prompt in ARCH_DRIVES:
        cfg = dataclasses.replace(registry.get_config(arch), **changes)
        # the cache arms share weights; another layer pattern draws anew
        if (arch, cfg.num_layers, cfg.layer_pattern) != shape:
            del params
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            params = model_lib.init_params(cfg, seed=0, device=device)
            sync(device)
            shape = (arch, cfg.num_layers, cfg.layer_pattern)
            print(f"[{key}] {arch}: "
                  f"{sum(p.numel() for p in params.parameters())} "
                  f"parameters ({cfg.dtype}, {cfg.num_layers} layers) "
                  f"initialised in {time.perf_counter() - t0:.1f} s",
                  flush=True)
        run_phase(phases, key, lambda: phase_lm_arch(device, cfg, params,
                                                     prompt=prompt))
        d = phases[key]
        print(f"[times] {key} ({card}): prefill {d['prefill_s']:.4f} s "
              f"({d['prefill_tokens_per_s']:.1f} positions/s), decode step "
              f"median {d['decode_ms_per_step_median']:.2f} ms, peak memory "
              f"{d['max_memory_allocated']} bytes, aux {d['forward_aux']}, "
              f"routes {d.get('routes')}", flush=True)
    del params
    torch.cuda.empty_cache()
    run_phase(phases, "wkv6_kernel", lambda: phase_wkv6_kernel(device))
    torch.cuda.empty_cache()
    run_phase(phases, "rglru_kernel", lambda: phase_rglru_kernel(device))
    torch.cuda.empty_cache()
    run_phase(phases, "wkv6_bwd_kernel",
              lambda: phase_wkv6_bwd_kernel(device))
    torch.cuda.empty_cache()
    run_phase(phases, "rglru_bwd_kernel",
              lambda: phase_rglru_bwd_kernel(device))
    torch.cuda.empty_cache()
    run_phase(phases, "flash_bwd_kernel",
              lambda: phase_flash_bwd_kernel(device))
    torch.cuda.empty_cache()
    run_phase(phases, "lm_train", lambda: phase_lm_train(device))
    t = phases["lm_train"]
    print(f"[times] lm_train ({card}): {t['arch']} {t['params']} parameters"
          f" float32, batch {t['batch']} x {t['seq']}, remat {t['remat']}: "
          f"{t['ms_per_step_median']:.1f} ms a step (median of "
          f"{len(t['step_ms']) - 1}), {t['tokens_per_s']:.1f} tokens/s, peak"
          f" memory {t['max_memory_allocated']} bytes, idle share "
          f"{t['step_profile']['idle_share']:.4f} of a traced step "
          f"(device {t['step_profile']['device_ms']:.1f} ms of "
          f"{t['step_profile']['wall_ms']:.1f}; by group "
          f"{t['step_profile']['by_group_ms']}); loss {t['losses'][0]:.4f} "
          f"-> {min(t['losses'][-5:]):.4f}; restart drill "
          f"{t['restart']['drill_s']:.1f} s", flush=True)
    torch.cuda.empty_cache()
    run_phase(phases, "lm_train_bf16", lambda: phase_lm_train_bf16(device))
    t16 = phases["lm_train_bf16"]
    sp = t16["step_profile"]
    print(f"[times] lm_train_bf16 ({card}): {t16['arch']} {t16['params']} "
          f"parameters bf16, batch {t16['batch']} x {t16['seq']}, remat "
          f"{t16['remat']}: {t16['ms_per_step_median']:.1f} ms a step "
          f"(median of {len(t16['step_ms']) - 1}), "
          f"{t16['tokens_per_s']:.1f} tokens/s, peak memory "
          f"{t16['max_memory_allocated']} bytes, idle share "
          f"{sp['idle_share']:.4f} of a traced step (device "
          f"{sp['device_ms']:.1f} ms of {sp['wall_ms']:.1f}; by group "
          f"{sp['by_group_ms']}; backward kernels {sp['by_kernel_ms']}; "
          f"the flash backward {sp['flash_backward_share']:.4f} of device "
          f"time); loss and gradients {t16['grads_ms']:.2f} ms, AdamW "
          f"update {t16['update_ms']:.2f} ms; loss {t16['losses'][0]:.4f} -> "
          f"{t16['losses'][-1]:.4f}; "
          f"witness {t16['witness']}", flush=True)
    for key, arch, layers, batch in RECURRENT_TRAIN:
        torch.cuda.empty_cache()
        cfg = dataclasses.replace(registry.get_config(arch),
                                  num_layers=layers)
        run_phase(phases, key, lambda: phase_lm_train_recurrent(
            device, cfg, batch=batch))
        t = phases[key]
        sp = t["step_profile"]
        print(f"[times] {key} ({card}): {t['arch']} at {t['layers']} layers"
              f", {t['params']} parameters bf16, batch {t['batch']} x "
              f"{t['seq']}, remat {t['remat']}: "
              f"{t['ms_per_step_median']:.1f} ms a step (median of "
              f"{len(t['step_ms']) - 1}), {t['tokens_per_s']:.1f} tokens/s,"
              f" peak memory {t['max_memory_allocated']} bytes, idle share "
              f"{sp['idle_share']:.4f} of a traced step (device "
              f"{sp['device_ms']:.1f} ms of {sp['wall_ms']:.1f}; by group "
              f"{sp['by_group_ms']}; backward kernels {sp['by_kernel_ms']});"
              f" loss {t['losses'][0]:.4f} -> {t['losses'][-1]:.4f}; "
              f"witness at seq {t['witness_seq']} {t['witness']}; flash "
              f"backward {t.get('flash_backward')}", flush=True)
    # the recurrences' backward launches are those of their training
    # drives' steps
    phases["wkv6_bwd_kernel"]["launches"] = phases["lm_train_rwkv"][
        "launches"]["wkv6_bwd"]
    phases["rglru_bwd_kernel"]["launches"] = phases["lm_train_griffin"][
        "launches"]["rglru_bwd"]
    phases["rglru_bwd_kernel"]["kernel_launches"] = {
        k: phases["lm_train_griffin"]["launches"][f"rglru_bwd.{k}"]
        for k in ("ring", "direct")}
    if phases["rglru_bwd_kernel"]["kernel_launches"]["ring"] < 1:
        raise AssertionError("rglru_bwd.ring: no launch on the training path")
    for key, kernels in (("wkv6_bwd_kernel", WKV6_BWD_KERNELS),
                         ("rglru_bwd_kernel", RGLRU_BWD_KERNELS)):
        phases[key]["ptxas"] = {k: r for k, r in rec_ptxas.items()
                                if k.startswith(kernels)}
    phases["chain_interp"]["ptxas"] = interp_ptxas
    # the flash backward at recurrentgemma-9b's shape (D 256, on the pair
    # bwd_variant picks) joins the backward's timed shapes
    phases["flash_bwd_kernel"]["shapes"]["recurrentgemma-9b/bfloat16"] = \
        phases["lm_train_griffin"]["flash_backward"]
    # the backward's launches are those of the training drives' steps:
    # lm_train's on the CUDA-core pair, lm_train_bf16's (D 128) and
    # lm_train_griffin's (D 256, with the partial sums' kernel where its
    # dK/dV blocks split the heads, which that drive gated) on the tensor
    # cores; the forward's there join its launches by phase
    trains = {key: phases[key]["launches"]
              for key in ("lm_train", "lm_train_bf16", "lm_train_griffin")}
    phases["flash_bwd_kernel"]["launches"] = sum(
        n["flash_attention.bwd"] for n in trains.values())
    phases["flash_bwd_kernel"]["kernel_launches"] = {
        k: sum(n.get(f"flash_attention.{k}", 0) for n in trains.values())
        for k in ("bwd_wgmma", "bwd_fma", "bwd_dq", "bwd_dkdv", "bwd_sum")}
    phases["flash_bwd_kernel"]["launches_by_phase"] = {
        key: {k: n.get(f"flash_attention.{k}", 0)
              for k in ("bwd_wgmma", "bwd_fma", "bwd_sum")}
        for key, n in trains.items()}
    for pair in ("bwd_wgmma", "bwd_fma"):
        if phases["flash_bwd_kernel"]["kernel_launches"][pair] < 1:
            raise AssertionError(f"flash_attention.{pair}: no launch on the "
                                 f"training paths")
    # the attention kernels' launches are those of the LM path's drives;
    # the flash launches by kernel: bf16 prefills on the tensor cores, the
    # float32 drive on the CUDA cores
    phases["flash_kernel"]["launches"] = phases["lm_prefill"][
        "flash_launches"]
    variants = dict(
        lm_prefill=phases["lm_prefill"]["flash_variant_launches"],
        lm_griffin=phases["lm_griffin"]["prefill"][
            "flash_variant_launches"],
        lm_float32=phases["lm_float32"]["flash_variant_launches"],
        **{key: phases[key]["flash_variant_launches"]
           for key, *_ in ARCH_DRIVES})
    for drive, (kind, n) in FLASH_DRIVE_LAUNCHES.items():
        want = {f"flash_attention.{v}": n if v == kind else 0
                for v in ("wgmma", "fma")}
        if variants[drive] != want:
            raise AssertionError(f"{drive}: flash launches {variants[drive]}"
                                 f", expected {want}")
    phases["flash_kernel"]["variant_launches"] = variants
    phases["flash_kernel"]["launches_by_phase"] = {
        drive: sum(v.values()) for drive, v in variants.items()}
    for key in trains:
        phases["flash_kernel"]["launches_by_phase"][key] = phases[key][
            "launches"]["flash_attention"]
    phases["decode_kernel"]["launches_by_phase"] = dict(
        lm_serve=phases["lm_serve"]["decode_launches"],
        **{key: phases[key]["decode_launches"] for key, *_ in ARCH_DRIVES})
    print(f"[flash_kernel] launches by kernel: {variants}", flush=True)
    phases["decode_kernel"]["launches"] = phases["lm_serve"][
        "decode_launches"]
    phases["decode_kernel"]["kernel_launches"] = phases["lm_serve"][
        "decode_kernel_launches"]
    print(f"[decode_kernel] launches by kernel over the lm_serve ticks: "
          f"{phases['decode_kernel']['kernel_launches']}; decode-kernel "
          f"device ms per decode step: qwen3-1.7b "
          f"{phases['lm_prefill']['decode_kernel_ms_per_step']}, "
          f"recurrentgemma-9b "
          f"{phases['lm_griffin']['prefill']['decode_kernel_ms_per_step']}",
          flush=True)
    # the recurrences' launches are those of their paths' prefill drives;
    # the RG-LRU launches by kernel, which lm_drive has gated
    phases["wkv6_kernel"]["launches"] = phases["lm_rwkv"]["prefill"][
        "prefill_launches"]["wkv6"]
    phases["rglru_kernel"]["launches"] = phases["lm_griffin"]["prefill"][
        "prefill_launches"]["rglru"]
    phases["wkv6_kernel"]["launches_by_phase"] = dict(
        lm_rwkv=phases["wkv6_kernel"]["launches"],
        lm_train_rwkv=phases["lm_train_rwkv"]["launches"]["wkv6"])
    phases["rglru_kernel"]["launches_by_phase"] = dict(
        lm_griffin=phases["rglru_kernel"]["launches"],
        lm_train_griffin=phases["lm_train_griffin"]["launches"]["rglru"])
    rg_variants = dict(
        bf16=phases["lm_griffin"]["prefill"]["rglru_variant_launches"],
        float32=phases["lm_griffin"]["lm_float32"]["rglru_variant_launches"])
    phases["rglru_kernel"]["kernel_launches"] = rg_variants["bf16"]
    print(f"[rglru_kernel] launches by kernel per recurrentgemma-9b prefill:"
          f" {rg_variants}", flush=True)

    if tuple(phases) != PHASES:
        raise AssertionError(f"phases ran as {tuple(phases)}, not {PHASES}")
    # the interpreter kernel's launches are those of the paths whose chains
    # run on it (its own phase's are comparisons)
    by_phase = {key: phases[key]["interp_launches"] for key in INTERP_PATHS}
    print(f"[chain_interp] run_interp launches by phase: {by_phase}",
          flush=True)
    for key, count in by_phase.items():
        if count < 1:
            raise AssertionError(f"{key}: no run_interp launch")
    phases["chain_interp"]["launches"] = sum(by_phase.values())
    phases["chain_interp"]["launches_by_phase"] = by_phase
    # the walk kernel's are those of the write paths' stages
    walk_by_phase = {key: phases[key]["walk_launches"]
                     for key in WALK_PATHS + ("kv_contend",)}
    print(f"[chain_interp] walk launches by phase: {walk_by_phase}",
          flush=True)
    for key in WALK_PATHS:
        if walk_by_phase[key] < 1:
            raise AssertionError(f"{key}: no {WALK_KERNEL} launch")
    walk_row = phases["kv_write"]["walk_kernel"]
    walk_row.update(launches=sum(walk_by_phase.values()),
                    launches_by_phase=walk_by_phase, ptxas=walk_ptxas)
    # kernel #1 also carries the kill faults of chain_faults' drive and the
    # ADDLEQ guests of chain_programs'
    phases["chain_kernel"]["launches_by_phase"] = dict(
        chain_kernel=phases["chain_kernel"]["launches"],
        chain_faults=phases["chain_faults"]["launches"],
        chain_programs=phases["chain_programs"]["launches"])
    for key in ("chain_faults", "chain_programs"):
        if phases[key]["launches"] < 1:
            raise AssertionError(f"{key}: no run_managed launch")
    g = phases["chain_programs"]["guests"]
    phases["chain_kernel"]["addleq_guests"] = {f: g[f] for f in (
        "shape", "launches", "ms", "trace_ms", "event_ms", "plain_ms",
        "bound_ms", "serial_floor_ms", "serial_floor_l2_ms", "load_cycles",
        "steps_max", "loop_guest_ms", "loop_guest_cycles_per_step")}

    rows = []
    for kname, phase, source, replaces, cuda_kernels in KERNELS:
        r = phases[phase]
        if kname in ROW_KEYS:
            r = r[ROW_KEYS[kname]]
        if r["launches"] < 1:
            raise AssertionError(f"{kname}: no launch on its path")
        rows.append(dict(
            name=kname, route="cuda", source=source, replaces=replaces,
            cuda_kernels=list(cuda_kernels),
            launches=r["launches"], max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r.get("bound_by", "bytes"),
            library_ms=r.get("library_ms")))
        if "kernel_launches" in r:
            rows[-1]["kernel_launches"] = r["kernel_launches"]
        if "launches_by_phase" in r:
            rows[-1]["launches_by_phase"] = r["launches_by_phase"]
        if "addleq_guests" in r:
            rows[-1]["addleq_guests"] = r["addleq_guests"]
        if "ptxas" in r:
            rows[-1]["ptxas"] = r["ptxas"]
        if "serial_floor_ms" in r:
            rows[-1]["serial_floor_ms"] = r["serial_floor_ms"]
        if "cases" in r:
            rows[-1]["cases"] = {n: {f: c[f] for f in (
                "runs", "rows", "wqs", "steps_max", "ms", "plain_ms",
                "serial_floor_ms", "bound_ms")}
                for n, c in r["cases"].items()}
        if "shapes" in r:
            rows[-1]["shapes"] = {n: {f: t.get(f) for f in (
                "shape", "ms", "plain_ms", "bound_ms", "library_ms",
                "pair", "fma_ms", "tflop_per_s")}
                for n, t in r["shapes"].items()}
        for t in r.get("shapes", {}).values() or (r,):
            print(f"[times] {kname} ({card}): {t['ms']:.4f} ms, bound "
                  f"{t['bound_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
                  f"library {t.get('library_ms')}, shape {t['shape']}",
                  flush=True)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
