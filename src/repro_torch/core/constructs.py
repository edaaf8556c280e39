"""RedN programming constructs (paper §3.3–§3.4, Appendix A; the port's
``repro.core.constructs``).

``if`` — Fig. 4: a CAS whose destination is the packed ``opcode|id`` control
word of a later (managed) WR.  The comparison ``x == y`` piggybacks on the
``opcode == NOOP`` check because ``NOOP`` encodes as 0 in the high bits, so a
raw 24-bit operand *is* the packed comparand.  On success the swap rewrites
``NOOP -> WRITE`` and the converted WR performs the then-branch.

``CAS-claim`` — §3.5's write-side chained-CAS pattern: a CAS takes
ownership of a memory cell and its *return-old* value, steered into a
later conditional WR's control word, selects the success branch — the
primitive behind the chain-offloaded hopscotch SET.

``enable-branch`` — the Calc-verb inequality conditional (Table 3):
``MAX``/``MIN`` clamp a loaded value against a threshold, a CAS converts
a NOOP into an **ENABLE**, so ``if (v <= thr)`` releases one WQ and
``else`` the other — the data-dependent exits of the displacement bubble,
the CLOCK sweeper's expiry test and the TTL server.

``displace-move`` / ``bucket-vacate`` — the claim pattern inverted: a
chained sequence that *releases* a bucket (value row copied out or not,
the key retired by a re-read-comparand CAS ``key -> EMPTY``, the stale
value row zeroed).

``while`` (unrolled, with or without ``break``; Fig. 5/6), ``while``
(recycled, §3.4) and the ``mov`` emulation of Appendix A complete the set.

Every emitter posts the same WRs, in the same order and with the same
fields, as the JAX package's emitter of the same name, so a program built
from them is word-identical in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from . import isa
from .assembler import Program, WQBuilder, WRRef


# ---------------------------------------------------------------------------
# if (Fig. 4)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class IfRefs:
    cas: WRRef
    cond_wr: WRRef      # R2: the NOOP that becomes the then-branch WRITE
    enable: WRRef
    x_ctrl_addr: int    # scatter x here (24-bit) -> pack(NOOP, x)
    y_opa_addr: int     # scatter/patch y here (24-bit comparand)


def emit_if(ctl: WQBuilder, mod: WQBuilder, *, y: int = 0, x: int = 0,
            then_src: int, then_dst: int, then_len: int = 1,
            wait_for: Optional[WRRef] = None,
            converted_signaled: bool = True) -> IfRefs:
    """Emit Fig. 4's conditional: ``if (x == y) then WRITE(src->dst)``.

    ``x`` sits in the conditional WR's id field (24-bit, may be scattered at
    runtime via ``x_ctrl_addr``); ``y`` in the CAS old field (``y_opa_addr``).
    """
    flags_kw = dict(signaled=converted_signaled)
    cond = mod.post(isa.NOOP, id_=x, src=then_src, dst=then_dst,
                    ln=then_len, tag="if.cond", **flags_kw)
    if wait_for is not None:
        ctl.wait_for(wait_for, tag="if.wait_input")
    cas = ctl.cas(dst=cond.ctrl_addr, old=isa.pack_ctrl(isa.NOOP, y),
                  new=isa.pack_ctrl(isa.WRITE, 0), tag="if.cas")
    en = ctl.enable(mod, upto=mod.n_posted, tag="if.enable")
    return IfRefs(cas=cas, cond_wr=cond, enable=en,
                  x_ctrl_addr=cond.ctrl_addr, y_opa_addr=cas.addr("opa"))


# ---------------------------------------------------------------------------
# CAS-claim (§3.5): atomically take ownership of a cell, branch on success
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CasClaimRefs:
    claim: WRRef        # the claiming CAS (its dst/opb are patch targets)
    test: WRRef         # converts cond_wr iff the claim won
    cond_wr: WRRef      # NOOP -> then-branch WRITE on successful claim
    cell_dst_addr: int  # patch the claimed cell's address here (claim.dst)
    new_opb_addr: int   # patch the claim value here (claim.opb)


def emit_cas_claim(ctl: WQBuilder, mod: WQBuilder, *, cell: int = 0,
                   expect: int = 0, new: int = 0, then_src: int,
                   then_dst: int, then_len: int = 1) -> CasClaimRefs:
    """Claim ``mem[cell]``: CAS ``expect -> new``, then-branch iff it won.

    The paper's §3.5 write-side pattern (chained CAS building atomics wider
    than one verb): the claiming CAS steers its *return-old* value into the
    conditional WR's packed control word, so the follow-up test-CAS sees
    ``pack(NOOP, old)`` and converts the conditional into its then-WRITE
    exactly when ``old == expect`` — a losing claim leaves the cell *and*
    the conditional untouched (the cond WR executes as a NOOP whose id
    happens to be the occupying value).  ``cell``/``new`` are usually 0
    here and patched at runtime via ``cell_dst_addr``/``new_opb_addr``
    (RECV scatter or self-modifying WRITEs), which is how the hopscotch
    writer aims one pre-posted claim at a client-chosen bucket.

    Cell values must live in the 24-bit id space: the return-old lands in
    a ctrl word, so a high byte would decode as an opcode.

    The caller emits the ENABLE that releases ``mod`` (after the test-CAS
    completes), so more WRs — e.g. the then-branch's event slots — can be
    posted to ``mod`` behind ``cond_wr`` first.
    """
    cond = mod.post(isa.NOOP, id_=0, src=then_src, dst=then_dst,
                    ln=then_len, tag="claim.cond")
    claim = ctl.cas(dst=cell, old=expect, new=new, ret=cond.ctrl_addr,
                    tag="claim.cas")
    test = ctl.cas(dst=cond.ctrl_addr,
                   old=isa.pack_ctrl(isa.NOOP, expect & isa.ID_MASK),
                   new=isa.pack_ctrl(isa.WRITE, 0), tag="claim.test")
    return CasClaimRefs(claim=claim, test=test, cond_wr=cond,
                        cell_dst_addr=claim.addr("dst"),
                        new_opb_addr=claim.addr("opb"))


# ---------------------------------------------------------------------------
# CAS-retry loop: bounded re-probe of one contended cell (lost races)
# ---------------------------------------------------------------------------

# mod-WQ completions per FAILED attempt: the cond NOOP + the two event
# NOOPs.  A winning attempt's then-WRITE stamps the events with a
# completion-suppressed template, so the winner contributes only 1 and
# every later attempt's gate (WAIT mod >= FAIL_COMPLETIONS * a) starves.
FAIL_COMPLETIONS = 3


@dataclasses.dataclass
class CasRetryRefs:
    claims: List[CasClaimRefs]   # one per attempt, in order
    gates: List[WRRef]           # attempt a>0's WAIT(mod, 3a) entry gate
    attempts: int

    @property
    def exhausted_count(self) -> int:
        """mod completion count observed iff *every* attempt lost."""
        return FAIL_COMPLETIONS * self.attempts


def emit_cas_retry_loop(ctl: WQBuilder, mod: WQBuilder, *, cell: int = 0,
                        expect: int = 0, new: int = 0, template: int,
                        attempts: int, backoff_base: int = 1,
                        tag: str = "retry") -> CasRetryRefs:
    """Bounded CAS-retry loop: re-probe ``mem[cell]`` on a *lost race*.

    The loop is the unrolled-while idiom (Fig. 5) applied to §3.5's
    CAS-claim: ``attempts`` copies of :func:`emit_cas_claim` aimed at the
    same cell, where attempt ``a > 0`` is gated behind
    ``WAIT(mod, 3a)`` — a count only reachable if attempt ``a-1``'s cond
    *and* both of its event NOOPs completed unconverted, i.e. the claim
    lost.  A winning attempt's then-WRITE copies the 2-WR
    completion-suppressed ``template`` image (16 words: the caller's
    result WRs, ``FLAG_SUPPRESS_COMPLETION`` set) over the two event
    slots, so the events execute the result *without* signaling — the
    next gate starves and the remaining attempts are dead code (the
    Fig. 6 ``break``).  Backoff is chain fuel: attempt ``a`` is preceded
    by ``backoff_base << (a-1)`` suppressed NOOPs on ``ctl``, an
    exponentially growing delay priced by the latency clocks.

    Retry semantics: a retry fires when the claim observed ``old !=
    expect`` — a *lost race* (another writer holds the cell).  It
    succeeds if the cell is released by the time the re-probe runs.
    After ``attempts`` losses the loop
    exhausts: ``mod``'s completion count equals ``exhausted_count``,
    which the caller can WAIT on to take the give-up path.

    ``ctl`` must be one-by-one ordered (doorbell/completion) and ``mod``
    a managed doorbell WQ starting disabled, as with
    :func:`emit_cas_claim`.
    """
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    if ctl.ordering == isa.ORD_WQ:
        raise ValueError(
            f"{tag}: ctl WQ{ctl.index} must be one-by-one ordered "
            "(doorbell/completion) — the gate must fetch after the "
            "previous attempt's outcome is known")
    claims: List[CasClaimRefs] = []
    gates: List[WRRef] = []
    for a in range(attempts):
        if a:
            gates.append(ctl.wait(mod, FAIL_COMPLETIONS * a,
                                  tag=f"{tag}.gate{a}"))
            for b in range(backoff_base << (a - 1)):
                ctl.noop(signaled=False, tag=f"{tag}.backoff{a}.{b}")
        refs = emit_cas_claim(
            ctl, mod, cell=cell, expect=expect, new=new,
            then_src=template, then_dst=mod.future_wr_addr(1, "ctrl"),
            then_len=2 * isa.WR_WORDS)
        mod.post(isa.NOOP, tag=f"{tag}.ev{a}a")
        mod.post(isa.NOOP, tag=f"{tag}.ev{a}b")
        ctl.enable(mod, upto=FAIL_COMPLETIONS * (a + 1),
                   tag=f"{tag}.en{a}")
        claims.append(refs)
    return CasRetryRefs(claims=claims, gates=gates, attempts=attempts)


# ---------------------------------------------------------------------------
# enable-branch: if (v <= threshold) ENABLE(then) else ENABLE(else)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EnableBranchRefs:
    cond_then: WRRef    # becomes ENABLE(then_wq, then_upto) iff v <= thr
    cond_else: WRRef    # becomes ENABLE(else_wq, else_upto) iff v >  thr
    then_ctrl_addr: int  # the caller loads v (24-bit) here ...
    else_ctrl_addr: int  # ... and here (both copies see the same v)


def emit_enable_branch(ctl: WQBuilder, mod: WQBuilder, *, threshold: int,
                       then_wq: int, then_upto: int, else_wq: int,
                       else_upto: int, load, tag: str = "br") -> \
        EnableBranchRefs:
    """Data-dependent two-way branch: exactly one of two WQs is released.

    The chain ISA has no signed compare, but the Calc verbs give one
    (Table 3: MAX/MIN "used for inequality predicates"): load ``v`` into
    two conditional NOOPs' control words (``pack(NOOP, v)`` is just ``v``
    for 24-bit values), clamp one with ``MAX(.., thr)`` and the other with
    ``MIN(.., thr+1)``, and CAS each against its clamp constant —
    ``max(v, thr) == thr  <=>  v <= thr`` and
    ``min(v, thr+1) == thr+1  <=>  v > thr``, so *exactly one* CAS
    converts its NOOP.  The conversion target is ``pack(ENABLE, 0)`` and
    the cond WRs carry their ENABLE operands (target WQ / watermark) in
    their static opa/opb fields, so the surviving branch *is* the release
    of its WQ — no template copy, one verb per arm.  This is the
    data-dependent exit the hopscotch displacer's bubble loop breaks on
    (``dist < H``) and the movability test its window scan selects with.

    ``load(then_ctrl_addr, else_ctrl_addr)`` is called between the cond
    posts and the clamp/test verbs; it must emit (into ``ctl``) the verbs
    that put ``v`` into both control words (e.g. a probe READ plus a
    WRITE copy, plus any ADD bias).  ``ctl`` must be doorbell-ordered so
    the loads precede the clamps.  Budget: 2C (conds) + the load +
    2 Calc + 2A (CAS) + 1E (the mod release).
    """
    if not 0 <= threshold < isa.ID_MASK:
        # threshold+1 must stay in the 24-bit id space: pack_ctrl masks
        # it, and a wrapped comparand would let BOTH arms convert for v=0
        raise ValueError(
            f"threshold must be in [0, {isa.ID_MASK}), got {threshold:#x}")
    cond_then = mod.post(isa.NOOP, opa=then_upto, opb=then_wq,
                         tag=f"{tag}.then")
    cond_else = mod.post(isa.NOOP, opa=else_upto, opb=else_wq,
                         tag=f"{tag}.else")
    load(cond_then.ctrl_addr, cond_else.ctrl_addr)
    ctl.max_(dst=cond_then.ctrl_addr,
             operand=isa.pack_ctrl(isa.NOOP, threshold), tag=f"{tag}.clamp<")
    ctl.min_(dst=cond_else.ctrl_addr,
             operand=isa.pack_ctrl(isa.NOOP, threshold + 1),
             tag=f"{tag}.clamp>")
    ctl.cas(dst=cond_then.ctrl_addr,
            old=isa.pack_ctrl(isa.NOOP, threshold),
            new=isa.pack_ctrl(isa.ENABLE, 0), tag=f"{tag}.test<")
    ctl.cas(dst=cond_else.ctrl_addr,
            old=isa.pack_ctrl(isa.NOOP, threshold + 1),
            new=isa.pack_ctrl(isa.ENABLE, 0), tag=f"{tag}.test>")
    ctl.enable(mod, upto=mod.n_posted, tag=f"{tag}.release")
    return EnableBranchRefs(cond_then=cond_then, cond_else=cond_else,
                            then_ctrl_addr=cond_then.ctrl_addr,
                            else_ctrl_addr=cond_else.ctrl_addr)


# ---------------------------------------------------------------------------
# displace-move: one hopscotch bubble step (the §3.5 claim pattern, inverted)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DisplaceMoveRefs:
    value_copy: WRRef    # cand's value row -> free's value row
    key_move: WRRef      # cand's key word  -> free's key word
    vacate: WRRef        # the CAS that retires cand: key -> EMPTY
    zero_row: WRRef      # zeroes cand's (now stale) value row


def emit_displace_move(ctl: WQBuilder, *, cand_w: int, free_w: int,
                       dist_w: int, back: int, val_len: int, zeros: int,
                       status_addr: int, status_val: int, next_wq: int,
                       next_upto: int, empty_key: int = 0,
                       tag: str = "mv") -> DisplaceMoveRefs:
    """One hopscotch bubble step, entirely in verbs.

    :func:`emit_cas_claim` *acquires* a cell (CAS ``EMPTY -> key``); this
    is its inverse — the §3.5 chained-CAS pattern extended to *release*
    one: copy the movable entry at ``mem[cand_w]`` (a bucket address held
    in a carry word) into the free bucket at ``mem[free_w]``, then CAS
    the mover's key word ``key -> EMPTY`` so the vacated bucket becomes
    the new free slot.  Order matters and the doorbell-ordered ``ctl``
    provides it: value row first, key second (a concurrent reader sees
    either the old bucket or a fully-written new one, never a key without
    its value), the vacate CAS third (its comparand is re-read from the
    bucket, so a raced mover would lose the CAS rather than corrupt), the
    stale value row zeroed last (a vacated bucket must not leak its old
    value words to a later claimant).  Finally the carry words are
    advanced — ``free <- cand``, ``dist -= back`` — and the next bubble
    lap's break-check WQ is released.

    All bucket addressing is self-modifying: every probe/patch WRITE
    derives from the ``cand_w``/``free_w`` carry words, so one pre-posted
    move serves whatever window position the previous lap's scan chose.
    ``[bucket+2]`` must hold the bucket's value-row pointer (the shared
    ``[key, pad, val_ptr]`` row layout).
    """
    assert back >= 1

    # value row: READ both bucket rows' val_ptrs into the copy's src/dst
    ctl.write(src=cand_w, dst=ctl.future_wr_addr(2, "src"),
              tag=f"{tag}.p_vpc")
    ctl.add(dst=ctl.future_wr_addr(1, "src"), addend=2, tag=f"{tag}.o_vpc")
    ctl.read(src=0, dst=ctl.future_wr_addr(4, "src"), ln=1,
             tag=f"{tag}.vp_cand")
    ctl.write(src=free_w, dst=ctl.future_wr_addr(2, "src"),
              tag=f"{tag}.p_vpf")
    ctl.add(dst=ctl.future_wr_addr(1, "src"), addend=2, tag=f"{tag}.o_vpf")
    ctl.read(src=0, dst=ctl.future_wr_addr(1, "dst"), ln=1,
             tag=f"{tag}.vp_free")
    value_copy = ctl.write(src=0, dst=0, ln=val_len, tag=f"{tag}.val")

    # key: one READ moves it, both ends patched from the carry words
    ctl.write(src=cand_w, dst=ctl.future_wr_addr(2, "src"),
              tag=f"{tag}.p_ksrc")
    ctl.write(src=free_w, dst=ctl.future_wr_addr(1, "dst"),
              tag=f"{tag}.p_kdst")
    key_move = ctl.read(src=0, dst=0, ln=1, tag=f"{tag}.key")

    # vacate: CAS the mover's key word key -> EMPTY (comparand re-read
    # from the bucket itself, so only the expected occupant is retired)
    ctl.write(src=cand_w, dst=ctl.future_wr_addr(1, "src"),
              tag=f"{tag}.p_rk")
    ctl.read(src=0, dst=ctl.future_wr_addr(2, "opa"), ln=1,
             tag=f"{tag}.rk")
    ctl.write(src=cand_w, dst=ctl.future_wr_addr(1, "dst"),
              tag=f"{tag}.p_vac")
    vacate = ctl.cas(dst=0, old=0, new=empty_key, tag=f"{tag}.vacate")

    # the vacated bucket's value row is dead — zero it (its val_ptr is
    # already sitting in the value copy's src field)
    ctl.write(src=value_copy.addr("src"), dst=ctl.future_wr_addr(1, "dst"),
              tag=f"{tag}.p_zero")
    zero_row = ctl.write(src=zeros, dst=0, ln=val_len, tag=f"{tag}.zero")

    # record that a displacement happened, advance the carries, and hand
    # off to the next lap's break-check
    ctl.write_imm(dst=status_addr, value=status_val, tag=f"{tag}.status")
    ctl.write(src=cand_w, dst=free_w, tag=f"{tag}.free")
    ctl.add(dst=dist_w, addend=-back, tag=f"{tag}.dist")
    ctl.enable(next_wq, upto=next_upto, tag=f"{tag}.next")
    return DisplaceMoveRefs(value_copy=value_copy, key_move=key_move,
                            vacate=vacate, zero_row=zero_row)

# ---------------------------------------------------------------------------
# bucket-vacate: retire a bucket held in a carry word
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BucketVacateRefs:
    vacate: WRRef        # the CAS that retires the bucket: key -> EMPTY
    zero_row: WRRef      # zeroes the bucket's (now stale) value row


def emit_bucket_vacate(ctl: WQBuilder, *, bucket_w: int, val_len: int,
                       zeros: int, empty_key: int = 0,
                       tag: str = "vac") -> BucketVacateRefs:
    """Release the bucket whose address sits in ``mem[bucket_w]``.

    The tail half of :func:`emit_displace_move`, factored for chains that
    vacate a bucket *without* first copying it anywhere (the deleter and
    the CLOCK sweeper).  Same
    discipline as the move: the vacate CAS's comparand is re-read from
    the bucket itself (a raced occupant loses the CAS rather than being
    clobbered), and the stale value row is zeroed *after* the key is gone
    through the row's own ``val_ptr`` (``[bucket+2]``, the shared
    ``[key, pad, val_ptr]`` layout) so a later claimant of the slot can
    never read the retired value.  ``ctl`` must be doorbell-ordered.
    Budget: 6C + 2A over 8 WRs — 4 WRITEs + 2 READs (patches counted as
    copies), the vacate CAS, and the val_ptr-offset ADD.
    """
    # key retire: CAS key -> EMPTY, comparand re-read from the bucket
    ctl.write(src=bucket_w, dst=ctl.future_wr_addr(1, "src"),
              tag=f"{tag}.p_rk")
    ctl.read(src=0, dst=ctl.future_wr_addr(2, "opa"), ln=1, tag=f"{tag}.rk")
    ctl.write(src=bucket_w, dst=ctl.future_wr_addr(1, "dst"),
              tag=f"{tag}.p_vac")
    vacate = ctl.cas(dst=0, old=0, new=empty_key, tag=f"{tag}.vacate")

    # stale value row: val_ptr derived from the bucket row, then zeroed
    ctl.write(src=bucket_w, dst=ctl.future_wr_addr(2, "src"),
              tag=f"{tag}.p_vp")
    ctl.add(dst=ctl.future_wr_addr(1, "src"), addend=2, tag=f"{tag}.o_vp")
    ctl.read(src=0, dst=ctl.future_wr_addr(1, "dst"), ln=1, tag=f"{tag}.vp")
    zero_row = ctl.write(src=zeros, dst=0, ln=val_len, tag=f"{tag}.zero")
    return BucketVacateRefs(vacate=vacate, zero_row=zero_row)


@dataclasses.dataclass
class WhileRefs:
    cond_wrs: List[WRRef]          # C_i per iteration (+ tail slot if break)
    cas_wrs: List[WRRef]
    x_opa_addrs: List[int]         # scatter the searched x into each CAS here
    ctrl_addrs: List[int]          # A[i] lands here (pack(NOOP, A[i]))


def emit_while_search_unrolled(
        prog: Program, body: WQBuilder, ctl: WQBuilder, mod: WQBuilder, *,
        n_iters: int, keys: Optional[Sequence[int]] = None, x: int = 0,
        resp_region: int, resp_payloads: Sequence[int],
        use_break: bool = False) -> WhileRefs:
    """Unrolled search: respond with ``resp_payloads[i]`` when x == keys[i].

    keys[i] may be None/static — at runtime a READ (emitted by the caller,
    e.g. the hash-lookup program) typically patches ``ctrl_addrs[i]``.
    Per-iteration verbs: 1C (cond NOOP) + 1A (CAS) + 3E (WAIT body, WAIT ctl,
    ENABLE ctl) — Table 2's ``while/unrolled`` row.
    """
    assert len(resp_payloads) == n_iters
    cond_wrs: List[WRRef] = []
    cas_wrs: List[WRRef] = []
    x_opa_addrs: List[int] = []
    ctrl_addrs: List[int] = []

    # payload words holding each iteration's response value
    payload_addrs = [prog.word(int(v)) for v in resp_payloads]

    # conditional WRs, one per iteration (+ tail response placeholder when
    # breaking: C_{i+1} is rewritten wholesale into the response WRITE)
    slots = n_iters + (1 if use_break else 0)
    for i in range(slots):
        if i < n_iters:
            key_i = 0 if keys is None else int(keys[i]) & isa.ID_MASK
            if use_break:
                cond_wrs.append(mod.post(isa.NOOP, id_=key_i,
                                         tag=f"while.c{i}"))
            else:
                cond_wrs.append(mod.post(
                    isa.NOOP, id_=key_i, src=payload_addrs[i],
                    dst=resp_region, ln=1, tag=f"while.c{i}"))
        else:
            cond_wrs.append(mod.post(isa.NOOP, tag="while.tail"))

    if use_break:
        # prepared 8-word WR templates: converting C_i makes it WRITE this
        # template over C_{i+1} -> C_{i+1} becomes a completion-suppressed
        # response WRITE (Fig. 6: one converted verb both responds and
        # starves the next iteration's WAIT).
        for i in range(n_iters):
            tmpl = prog.alloc(isa.WR_WORDS, [
                isa.pack_ctrl(isa.WRITE, 0), isa.FLAG_SUPPRESS_COMPLETION,
                payload_addrs[i], resp_region, 1, 0, 0, -1])
            # retarget C_i's (latent) WRITE at the next conditional WR
            wr = mod.wrs[cond_wrs[i].slot]
            wr["src"], wr["dst"], wr["ln"] = tmpl, cond_wrs[i + 1].base, 8

    # driving chain: body CASes gated on mod completions; ctl releases mod
    for i in range(n_iters):
        if i > 0:
            body.wait(mod, i, tag=f"while.gate{i}")
        cas = body.cas(dst=cond_wrs[i].ctrl_addr,
                       old=isa.pack_ctrl(isa.NOOP, x),
                       new=isa.pack_ctrl(isa.WRITE, 0), tag=f"while.cas{i}")
        cas_wrs.append(cas)
        x_opa_addrs.append(cas.addr("opa"))
        ctrl_addrs.append(cond_wrs[i].ctrl_addr)
        ctl.wait(body, cas.completion_count, tag=f"while.sync{i}")
        ctl.enable(mod, upto=i + 1, tag=f"while.en{i}")
    if use_break:
        # release the tail slot so a break at the last iteration can respond
        ctl.wait(body, cas_wrs[-1].completion_count, tag="while.sync_tail")
        ctl.enable(mod, upto=n_iters + 1, tag="while.en_tail")

    return WhileRefs(cond_wrs, cas_wrs, x_opa_addrs, ctrl_addrs)


# ---------------------------------------------------------------------------
# while, recycled (§3.4) — unbounded loop with zero CPU involvement
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RecycledLoopRefs:
    wq: WQBuilder
    cas: WRRef
    cond_wr: WRRef
    lap_words: int
    x_opa_addr: int


def emit_recycled_predicate_loop(
        prog: Program, *, data_addr: int, x: int,
        then_src: int, then_dst: int, wq_size: int = 8,
        max_mem: Optional[int] = None) -> RecycledLoopRefs:
    """A self-recycling managed WQ evaluating ``if (mem[data] == x)`` forever.

    Layout per lap (crawling enable window):
      0 CAS        (A)  predicate -> converts slot 2
      1 ENABLE     (E)  release the rest of the lap (doorbell barrier: the
                        CAS has completed, so slot 2's rewrite is coherent)
      2 cond WR    (C)  NOOP or converted then-WRITE
      3 READ       (C)  restore slot 2's pristine template (re-arm)
      4 READ       (C)  re-fetch the guarded datum into the CAS comparand
      5 ADD        (A)  bump slot 1's monotonic enable watermark (+wq_size) —
                        the wqe_count maintenance §3.4 describes
      6 NOOP pad / 7 NOOP pad (wrap)

    Budget: 3C + 2A + 1E (+2 pad) per lap; the paper's ConnectX layout is
    3C + 2A + 4E — our managed window subsumes its tail WAIT+ENABLE pair
    because the VM fetches at execution within the enabled window (see
    module docstring).  Benchmarks report both.
    """
    wq = prog.add_wq(wq_size, ordering=isa.ORD_DOORBELL, managed=True,
                     recycled=True, initial_enable=2)
    cond = None
    # slot 0: CAS. Its comparand (opa) is refreshed each lap from data_addr
    # by the slot-4 READ; initial value x.
    cas = wq.cas(dst=0, old=isa.pack_ctrl(isa.NOOP, x),
                 new=isa.pack_ctrl(isa.WRITE, 0), tag="loop.cas")
    # crawling window: each lap's ENABLE must reach past the *next* lap's
    # ENABLE slot, otherwise the window closes exactly at the wrap boundary
    en = wq.enable(wq, upto=wq_size + 2, tag="loop.enable")
    cond = wq.post(isa.NOOP, id_=0, src=then_src, dst=then_dst, ln=1,
                   tag="loop.cond")
    # fix CAS target now that cond exists
    wq.wrs[cas.slot]["dst"] = cond.ctrl_addr

    pristine = prog.alloc(isa.WR_WORDS, [
        isa.pack_ctrl(isa.NOOP, 0), 0, then_src, then_dst, 1, 0, 0, -1])
    wq.read(src=pristine, dst=cond.base, ln=isa.WR_WORDS, tag="loop.restore")
    # refresh the observed datum into the cond WR's id (so the NEXT lap's CAS
    # compares pack(NOOP, mem[data]) against pack(NOOP, x))
    wq.read(src=data_addr, dst=cond.ctrl_addr, ln=1, tag="loop.refetch")
    wq.add(dst=en.addr("opa"), addend=wq_size, tag="loop.bump")
    while wq.n_posted < wq_size:
        wq.noop(signaled=False, tag="loop.pad")
    return RecycledLoopRefs(wq=wq, cas=cas, cond_wr=cond, lap_words=wq_size,
                            x_opa_addr=cas.addr("opa"))


# ---------------------------------------------------------------------------
# mov emulation (Appendix A)
# ---------------------------------------------------------------------------

def emit_mov_imm(wq: WQBuilder, value: int, r_dst: int) -> WRRef:
    """mov R_dst, C  ->  WRITE_IMM C R_dst."""
    return wq.write_imm(dst=r_dst, value=value, tag="mov.imm")


def emit_mov_indirect(ctl: WQBuilder, mod: WQBuilder, r_src: int,
                      r_dst: int) -> WRRef:
    """mov R_dst, [R_src]: patch W2.src with *R_src, then W2 copies."""
    w2 = mod.write(src=0, dst=r_dst, ln=1, tag="mov.ind.w2")
    ctl.write(src=r_src, dst=w2.addr("src"), ln=1, tag="mov.ind.patch")
    ctl.enable(mod, upto=mod.n_posted, tag="mov.ind.enable")
    return w2


def emit_mov_indexed(ctl: WQBuilder, mod: WQBuilder, r_src: int, r_off: int,
                     r_dst: int) -> WRRef:
    """mov R_dst, [R_src + R_off]: patch, ADD the offset, then copy."""
    addw = mod.add(dst=0, addend=0, tag="mov.idx.add")      # dst/opa patched
    w3 = mod.write(src=0, dst=r_dst, ln=1, tag="mov.idx.w3")
    mod.wrs[addw.slot]["dst"] = w3.addr("src")
    ctl.write(src=r_src, dst=w3.addr("src"), ln=1, tag="mov.idx.patch_src")
    ctl.write(src=r_off, dst=addw.addr("opa"), ln=1, tag="mov.idx.patch_off")
    # two-step enable: the ADD must complete before W3 is released
    ctl.enable(mod, upto=addw.slot + 1, tag="mov.idx.en_add")
    ctl.wait(mod, addw.completion_count, tag="mov.idx.wait_add")
    ctl.enable(mod, upto=w3.slot + 1, tag="mov.idx.en_w3")
    return w3


def emit_mov_store_indirect(ctl: WQBuilder, mod: WQBuilder, r_src: int,
                            r_dst_ptr: int) -> WRRef:
    """mov [R_dst], R_src (store form): patch W2.dst with *R_dst_ptr."""
    w2 = mod.write(src=r_src, dst=0, ln=1, tag="mov.st.w2")
    ctl.write(src=r_dst_ptr, dst=w2.addr("dst"), ln=1, tag="mov.st.patch")
    ctl.enable(mod, upto=mod.n_posted, tag="mov.st.enable")
    return w2
