"""Parity of the port's RedN constructs with the JAX package: every emitter
of ``core/constructs.py`` is built in both packages by the same builder,
the finalized specs and memory images must be equal word for word, and
both interpreters must run them to the same state (every ``VMState`` field,
clocks and verb counts included).  The programs are those of
``tests/test_constructs.py``."""
import numpy as np
import pytest

from _parity import assert_states_equal
from repro.core import assembler as jasm
from repro.core import constructs as jcons
from repro.core import isa as jisa
from repro.core import machine as jm
from repro_torch import convert
from repro_torch.core import assembler as tasm
from repro_torch.core import constructs as tcons
from repro_torch.core import machine as tm

JAX = (jasm, jcons)
PORT = (tasm, tcons)


def _if(asm, cons, x, y):
    p = asm.Program(512)
    one, resp = p.word(1), p.word(0)
    mod = p.add_wq(4, managed=True, ordering=jisa.ORD_DOORBELL)
    ctl = p.add_wq(8)
    cons.emit_if(ctl, mod, x=x, y=y, then_src=one, then_dst=resp)
    return p


def _if_gated(asm, cons):
    p = asm.Program(512)
    one, resp = p.word(1), p.word(0)
    inp = p.add_wq(2)
    trigger = inp.noop()
    mod = p.add_wq(4, managed=True, ordering=jisa.ORD_DOORBELL)
    ctl = p.add_wq(8)
    refs = cons.emit_if(ctl, mod, x=1, y=1, then_src=one, then_dst=resp,
                        wait_for=trigger, converted_signaled=False)
    resp_wq = p.add_wq(4)
    resp_wq.wait_for(refs.cond_wr)
    resp_wq.send(src=resp, ln=1, dst_region=resp, target_qp=-1)
    return p


def _search(asm, cons, keys, x, use_break):
    n = len(keys)
    p = asm.Program(2048)
    resp = p.word(-1 & 0xFFFFFF)
    body = p.add_wq(2 * n + 2)
    ctl = p.add_wq(2 * n + 2)
    mod = p.add_wq(n + 2, managed=True, ordering=jisa.ORD_DOORBELL)
    cons.emit_while_search_unrolled(
        p, body, ctl, mod, n_iters=n, keys=keys, x=x, resp_region=resp,
        resp_payloads=list(range(n)), use_break=use_break)
    return p


def _recycled(asm, cons, datum_value):
    p = asm.Program(1024)
    datum = p.word(datum_value)
    marker, hits = p.word(111), p.word(0)
    cons.emit_recycled_predicate_loop(p, data_addr=datum, x=7,
                                      then_src=marker, then_dst=hits)
    return p


def _claim(asm, cons, cell_value, expect=0, new=42):
    p = asm.Program(512)
    one, resp = p.word(1), p.word(0)
    cell = p.word(cell_value)
    mod = p.add_wq(4, managed=True, ordering=jisa.ORD_DOORBELL)
    ctl = p.add_wq(8)
    cons.emit_cas_claim(ctl, mod, cell=cell, expect=expect, new=new,
                        then_src=one, then_dst=resp)
    ctl.enable(mod, upto=mod.n_posted)
    return p


def _claim_patched(asm, cons):
    p = asm.Program(512)
    one, resp = p.word(1), p.word(0)
    cell = p.word(0)
    cell_addr_w = p.word(cell)
    key_w = p.word(1234)
    mod = p.add_wq(4, managed=True, ordering=jisa.ORD_DOORBELL)
    drv = p.add_wq(4)
    ctl = p.add_wq(8)
    ctl.wait(drv, 2)
    refs = cons.emit_cas_claim(ctl, mod, then_src=one, then_dst=resp)
    ctl.enable(mod, upto=mod.n_posted)
    drv.write(src=cell_addr_w, dst=refs.cell_dst_addr)
    drv.write(src=key_w, dst=refs.new_opb_addr)
    return p


def _retry(asm, cons, cell_value, attempts):
    """A bounded CAS-retry loop on one cell; the template's two WRs write
    the winner's marker and the claim's attempt count into ``resp``."""
    p = asm.Program(1024)
    resp = p.alloc(2, [0, 0])
    marker = p.word(77)
    cell = p.word(cell_value)
    tmpl = p.alloc(2 * jisa.WR_WORDS, [
        jisa.pack_ctrl(jisa.WRITE, 0), jisa.FLAG_SUPPRESS_COMPLETION,
        marker, resp, 1, 0, 0, -1,
        jisa.pack_ctrl(jisa.WRITE_IMM, 0), jisa.FLAG_SUPPRESS_COMPLETION,
        -1, resp + 1, 1, 5, 0, -1])
    mod = p.add_wq(3 * attempts + 1, managed=True,
                   ordering=jisa.ORD_DOORBELL)
    ctl = p.add_wq(8 * attempts + 8, ordering=jisa.ORD_DOORBELL)
    cons.emit_cas_retry_loop(ctl, mod, cell=cell, expect=0, new=9,
                             template=tmpl, attempts=attempts)
    return p


def _mov(asm, cons, kind):
    p = asm.Program(512)
    if kind == "imm":
        r = p.word(0)
        cons.emit_mov_imm(p.add_wq(2), 77, r)
        return p
    mod = p.add_wq(4, managed=True, ordering=jisa.ORD_DOORBELL)
    if kind == "indirect":
        cell = p.word(345)
        r_src, r_dst = p.word(cell), p.word(0)
        cons.emit_mov_indirect(p.add_wq(4), mod, r_src, r_dst)
    elif kind == "indexed":
        arr = p.alloc(4, [10, 20, 30, 40])
        r_src, r_off, r_dst = p.word(arr), p.word(2), p.word(0)
        cons.emit_mov_indexed(p.add_wq(8), mod, r_src, r_off, r_dst)
    else:
        cell = p.word(0)
        r_val, r_ptr = p.word(55), p.word(cell)
        cons.emit_mov_store_indirect(p.add_wq(4), mod, r_val, r_ptr)
    return p


def _branch(asm, cons, v, threshold):
    p = asm.Program(512)
    v_w = p.word(v)
    one, two = p.word(1), p.word(2)
    resp = p.word(0)
    wq_a = p.add_wq(2, managed=True, ordering=jisa.ORD_DOORBELL,
                    initial_enable=0)
    wq_b = p.add_wq(2, managed=True, ordering=jisa.ORD_DOORBELL,
                    initial_enable=0)
    wq_a.write(src=one, dst=resp)
    wq_b.write(src=two, dst=resp)
    mod = p.add_wq(2, managed=True, ordering=jisa.ORD_DOORBELL,
                   initial_enable=0)
    ctl = p.add_wq(10, managed=True, ordering=jisa.ORD_DOORBELL,
                   initial_enable=99)

    def load(a_addr, b_addr):
        ctl.write(src=v_w, dst=a_addr)
        ctl.write(src=v_w, dst=b_addr)

    cons.emit_enable_branch(ctl, mod, threshold=threshold,
                            then_wq=wq_a.index, then_upto=2,
                            else_wq=wq_b.index, else_upto=2, load=load)
    return p


def _move(asm, cons):
    V, BW = 2, 3
    p = asm.Program(1024)
    status = p.word(0)
    vals = p.alloc(4 * V, [11, 12, 21, 22, 31, 32, 0, 0], "vals")
    tbl_init = []
    for b, key in enumerate([101, 102, 103, 0]):
        tbl_init += [key, b, vals + b * V]
    table = p.alloc(4 * BW, tbl_init, "table")
    zeros = p.alloc(V, [0] * V)
    cand_w, free_w = p.word(table + 1 * BW), p.word(table + 3 * BW)
    dist_w = p.word(5)
    nxt = p.add_wq(2, managed=True, ordering=jisa.ORD_DOORBELL,
                   initial_enable=0)
    done = p.word(0)
    nxt.write_imm(dst=done, value=77)
    ctl = p.add_wq(24, managed=True, ordering=jisa.ORD_DOORBELL,
                   initial_enable=99)
    cons.emit_displace_move(
        ctl, cand_w=cand_w, free_w=free_w, dist_w=dist_w, back=2,
        val_len=V, zeros=zeros, status_addr=status, status_val=4,
        next_wq=nxt.index, next_upto=2)
    return p


def _vacate(asm, cons, bucket_keys, target, repeats, V=2):
    BW = 3
    p = asm.Program(1024)
    n = len(bucket_keys)
    vals = p.alloc(n * V, [10 * b + j for b in range(n) for j in range(V)])
    tbl_init = []
    for b, key in enumerate(bucket_keys):
        tbl_init += [key, b, vals + b * V]
    table = p.alloc(n * BW, tbl_init, "table")
    zeros = p.alloc(V, [0] * V)
    bucket_w = p.word(table + target * BW)
    ctl = p.add_wq(8 * repeats + 2, managed=True,
                   ordering=jisa.ORD_DOORBELL, initial_enable=99)
    for _ in range(repeats):
        cons.emit_bucket_vacate(ctl, bucket_w=bucket_w, val_len=V,
                                zeros=zeros)
    return p


CASES = {
    **{f"if_{x}_{y}": (lambda a, c, x=x, y=y: _if(a, c, x, y), 64)
       for x, y in [(3, 3), (3, 4), (0, 0), (0xFFFFFF, 0xFFFFFF),
                    (0xFFFFFF, 0xFFFFFE)]},
    "if_gated": (_if_gated, 64),
    **{f"search_{x}_{b}": (lambda a, c, x=x, b=b: _search(
        a, c, [11, 22, 33, 44], x, b), 2048)
       for x in (11, 33, 44, 99) for b in (False, True)},
    "recycled_hit": (lambda a, c: _recycled(a, c, 7), 64),
    "recycled_miss": (lambda a, c: _recycled(a, c, 8), 64),
    **{f"claim_{v}": (lambda a, c, v=v: _claim(a, c, v), 64)
       for v in (0, 7, 42)},
    **{f"claim_expect9_{v}": (lambda a, c, v=v: _claim(a, c, v, 9, 11), 64)
       for v in (9, 10)},
    "claim_patched": (_claim_patched, 64),
    **{f"retry_{v}_{n}": (lambda a, c, v=v, n=n: _retry(a, c, v, n), 256)
       for v in (0, 5) for n in (1, 3)},
    **{f"mov_{k}": (lambda a, c, k=k: _mov(a, c, k), 64)
       for k in ("imm", "indirect", "indexed", "store")},
    **{f"branch_{v}_{t}": (lambda a, c, v=v, t=t: _branch(a, c, v, t), 64)
       for v, t in [(0, 0), (1, 0), (3, 7), (7, 7), (8, 7),
                    (0xFFFFFE, 0xFFFFFE), (0xFFFFFD, 3)]},
    "displace_move": (_move, 128),
    "vacate_live": (lambda a, c: _vacate(a, c, [101, 102, 103], 1, 1), 64),
    "vacate_twice": (lambda a, c: _vacate(a, c, [101, 102, 103], 1, 2),
                     128),
    "vacate_empty": (lambda a, c: _vacate(a, c, [101, 0, 103], 1, 1), 64),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_construct_image_and_run_equal(name):
    build, max_steps = CASES[name]
    jprog, tprog = build(*JAX), build(*PORT)
    assert tprog.budget() == jprog.budget()
    jspec, jst = jprog.finalize()
    tspec, tst = tprog.finalize(device="cpu")
    assert convert.spec_from_tuple(jspec) == tspec
    assert_states_equal(jst, tst)
    assert_states_equal(jm.run(jspec, jst, max_steps),
                        tm.run(tspec, tst, max_steps))


def test_emitter_guards_raise_in_both():
    for asm, cons in (JAX, PORT):
        p = asm.Program(512)
        mod = p.add_wq(2, managed=True, ordering=jisa.ORD_DOORBELL)
        ctl = p.add_wq(10, managed=True, ordering=jisa.ORD_DOORBELL)
        with pytest.raises(ValueError, match="threshold"):
            cons.emit_enable_branch(
                ctl, mod, threshold=jisa.ID_MASK, then_wq=0, then_upto=1,
                else_wq=0, else_upto=1, load=lambda a, b: None)
        with pytest.raises(ValueError, match="attempts"):
            cons.emit_cas_retry_loop(ctl, mod, template=0, attempts=0)
        with pytest.raises(ValueError, match="one-by-one"):
            cons.emit_cas_retry_loop(p.add_wq(8), mod, template=0,
                                     attempts=1)


def test_refs_dataclasses_keep_their_fields():
    for name in ("IfRefs", "CasClaimRefs", "CasRetryRefs",
                 "EnableBranchRefs", "DisplaceMoveRefs", "BucketVacateRefs",
                 "WhileRefs", "RecycledLoopRefs"):
        jf = [f.name for f in jcons.dataclasses.fields(getattr(jcons, name))]
        tf = [f.name for f in tcons.dataclasses.fields(getattr(tcons, name))]
        assert tf == jf, name
    assert tcons.FAIL_COMPLETIONS == jcons.FAIL_COMPLETIONS


def test_retry_loop_outcomes():
    """The retry cases do what they claim: a free cell is won on the first
    attempt (marker written, no later attempt), an occupied one exhausts
    every attempt."""
    for cell_value, won in ((0, True), (5, False)):
        p = _retry(tasm, tcons, cell_value, 3)
        spec, st = p.finalize(device="cpu")
        out = tm.run(spec, st, 256)
        resp = int(np.asarray(out.mem)[spec.mem_words - 2])
        assert resp == (77 if won else 0)
