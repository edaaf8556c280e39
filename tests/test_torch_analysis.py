"""The port's static chain-program verifier (``repro_torch.core.analysis``)
against the JAX package's: every test of ``tests/test_analysis.py`` on the
port, then the same findings, certificates and disassembly as JAX's on
each of the 18 registered builders and on the engineered-bad programs, the
sweep against ``BENCH_chains.json`` and the CLI's exits."""
import json
from pathlib import Path

import pytest
import torch

from _parity import fresh_jax_programs
from repro.core import analysis as janalysis
from repro.core import assembler as jasm
from repro.core import programs as jprograms
from repro_torch.core import analysis, assembler, isa
from repro_torch.core import programs as tprograms

ROOT = Path(__file__).resolve().parents[1]
NAMES = janalysis.registry_names()

# the registry builds the reference's lru-cached programs: build them
# afresh here and leave none behind (tests/_parity.py)
_fresh_jax_programs = pytest.fixture(scope="module", autouse=True)(
    fresh_jax_programs)


def report(prog, waivers=(), name="t"):
    return analysis.verify_program(prog, waivers=waivers, name=name)


def errors_of(rep, pass_name):
    return [f for f in rep.errors if f.pass_name == pass_name]


# ---------------------------------------------------------------------------
# engineered programs, built by either package's assembler
# ---------------------------------------------------------------------------

def _oob_copy(asm):
    p = asm.Program(256)
    a = p.alloc(4)
    wq = p.add_wq(2)
    wq.write(src=a, dst=a, ln=4)
    wq.wrs[0]["ln"] = isa.MAX_COPY + 1          # post() would reject this
    return p


def _range_outside(asm):
    p = asm.Program(256)
    wq = p.add_wq(2)
    wq.write(src=250, dst=0, ln=8)              # [250, 258) > mem_words
    return p


def _bad_opcode_and_scatter(asm):
    p = asm.Program(256)
    tbl = p.scatter_table([10, 11])
    wq = p.add_wq(3)
    wq.recv(scatter_table=tbl)
    wq.noop()
    wq.wrs[1]["ctrl"] = isa.pack_ctrl(isa.NUM_OPCODES + 3, 0)
    wq.wrs[1]["opcode"] = isa.NUM_OPCODES + 3
    p._data_init[tbl] = isa.MAX_SCATTER + 1     # corrupt the table length
    return p


def _selfmod_prog(asm, target_ordering):
    """WQ1 patches WQ0's second slot; WQ0 runs under `target_ordering`
    with no WAIT/ENABLE ordering the patch before the fetch."""
    p = asm.Program(512)
    v = p.word(7)
    wq0 = p.add_wq(4, ordering=target_ordering)
    wq1 = p.add_wq(4, ordering=isa.ORD_DOORBELL)
    wq0.noop()
    t = wq0.write(src=v, dst=v)
    wq1.write_imm(dst=t.addr("src"), value=v)
    return p


def _wait_ordered_patch(asm):
    p = asm.Program(512)
    v = p.word(7)
    wq0 = p.add_wq(4, ordering=isa.ORD_DOORBELL)
    wq1 = p.add_wq(4, ordering=isa.ORD_DOORBELL)
    wq1.write_imm(dst=wq0.future_wr_addr(1, "src"), value=v)
    wq0.wait(wq1, 1)                    # patch lands before slot 1 fetch
    wq0.write(src=-1, dst=v)
    return p


def _enable_gated_patch(asm):
    p = asm.Program(512)
    v = p.word(7)
    wq0 = p.add_wq(4, ordering=isa.ORD_WQ, managed=True, initial_enable=1)
    wq1 = p.add_wq(4, ordering=isa.ORD_DOORBELL)
    wq0.noop()
    t = wq0.write(src=-1, dst=v)
    wq1.write_imm(dst=t.addr("src"), value=v)
    wq1.enable(wq0, upto=2)             # admits the slot after the patch
    return p


def _unsatisfiable_wait(asm):
    p = asm.Program(256)
    wq0 = p.add_wq(4)
    wq1 = p.add_wq(4)
    wq0.noop()
    wq0.noop(signaled=False)
    wq1.wait(wq0, 3)                    # at most 1 completion ever
    return p


def _enable_starvation(asm):
    p = asm.Program(256)
    wq0 = p.add_wq(4, managed=True, initial_enable=1)
    wq1 = p.add_wq(4)
    wq0.noop()
    wq0.noop()                          # slot 1 needs an ENABLE
    wq1.enable(wq0, upto=1)             # watermark too low to admit it
    return p


def _wait_cycle(asm):
    p = asm.Program(256)
    wq0 = p.add_wq(4)
    wq1 = p.add_wq(4)
    wq0.wait(wq1, 1)
    wq0.noop()
    wq1.wait(wq0, 1)
    wq1.noop()
    return p


def _racy_prog(asm=assembler):
    p = asm.Program(256)
    x = p.word(0, name="x")
    wq0 = p.add_wq(2)
    wq1 = p.add_wq(2)
    wq0.write_imm(dst=x, value=1, tag="left")
    wq1.write_imm(dst=x, value=2, tag="right")
    return p


def _wait_ordered_writes(asm):
    p = asm.Program(256)
    x = p.word(0)
    wq0 = p.add_wq(2)
    wq1 = p.add_wq(2)
    wq0.write_imm(dst=x, value=1)
    wq1.wait(wq0, 1)
    wq1.write_imm(dst=x, value=2)
    return p


def _wait_for_signaled(asm):
    p = asm.Program(256)
    wq0 = p.add_wq(4)
    wq1 = p.add_wq(4)
    wq0.noop(signaled=False)
    ref = wq0.noop()                    # first *signaled* completion
    wq0.noop()
    wq1.wait_for(ref)
    return p


ENGINEERED = {
    "oob_copy": _oob_copy,
    "range_outside": _range_outside,
    "bad_opcode_and_scatter": _bad_opcode_and_scatter,
    "selfmod_ord_wq": lambda asm: _selfmod_prog(asm, isa.ORD_WQ),
    "selfmod_doorbell": lambda asm: _selfmod_prog(asm, isa.ORD_DOORBELL),
    "wait_ordered_patch": _wait_ordered_patch,
    "enable_gated_patch": _enable_gated_patch,
    "unsatisfiable_wait": _unsatisfiable_wait,
    "enable_starvation": _enable_starvation,
    "wait_cycle": _wait_cycle,
    "racy": _racy_prog,
    "wait_ordered_writes": _wait_ordered_writes,
    "wait_for_signaled": _wait_for_signaled,
}


def _findings(rep):
    return [(f.severity, str(f)) for f in rep.findings]


# ---------------------------------------------------------------------------
# pass: bounds & encoding
# ---------------------------------------------------------------------------

def test_bounds_flags_out_of_bounds_copy():
    errs = errors_of(report(_oob_copy(assembler)), analysis.PASS_BOUNDS)
    assert len(errs) == 1 and "MAX_COPY" in errs[0].message


def test_bounds_flags_range_outside_memory():
    errs = errors_of(report(_range_outside(assembler)), analysis.PASS_BOUNDS)
    assert errs and "src range" in errs[0].message


def test_bounds_flags_bad_opcode_and_scatter():
    msgs = [f.message for f in errors_of(
        report(_bad_opcode_and_scatter(assembler)), analysis.PASS_BOUNDS)]
    assert any("invalid opcode" in m for m in msgs)
    assert any("scatter table length" in m for m in msgs)


# ---------------------------------------------------------------------------
# pass: self-modification audit
# ---------------------------------------------------------------------------

def test_selfmod_stale_prefetch_is_error_under_ord_wq():
    errs = errors_of(report(_selfmod_prog(assembler, isa.ORD_WQ)),
                     analysis.PASS_SELFMOD)
    assert len(errs) == 1 and "stale-prefetch" in errs[0].message


def test_selfmod_unordered_patch_is_error_even_one_by_one():
    errs = errors_of(report(_selfmod_prog(assembler, isa.ORD_DOORBELL)),
                     analysis.PASS_SELFMOD)
    assert len(errs) == 1 and "unordered patch" in errs[0].message


def test_selfmod_wait_ordered_patch_is_clean():
    rep = report(_wait_ordered_patch(assembler))
    assert not errors_of(rep, analysis.PASS_SELFMOD)
    assert any("ordered before target fetch" in f.message
               for f in rep.findings)


def test_selfmod_enable_gated_patch_is_clean_under_ord_wq():
    rep = report(_enable_gated_patch(assembler))
    assert not errors_of(rep, analysis.PASS_SELFMOD)
    assert any("enable-gated" in f.message for f in rep.findings)


# ---------------------------------------------------------------------------
# pass: WAIT/ENABLE ordering
# ---------------------------------------------------------------------------

def test_order_flags_unsatisfiable_wait():
    errs = errors_of(report(_unsatisfiable_wait(assembler)),
                     analysis.PASS_ORDER)
    assert len(errs) == 1 and "unsatisfiable WAIT" in errs[0].message


def test_order_flags_enable_starvation():
    errs = errors_of(report(_enable_starvation(assembler)),
                     analysis.PASS_ORDER)
    assert len(errs) == 1 and "enable starvation" in errs[0].message
    assert "[1]" in errs[0].message


def test_order_flags_wait_cycle_deadlock():
    errs = errors_of(report(_wait_cycle(assembler)), analysis.PASS_ORDER)
    assert errs and "cycle" in errs[0].message


# ---------------------------------------------------------------------------
# pass: races + waivers
# ---------------------------------------------------------------------------

def test_race_flags_unordered_overlapping_writes():
    errs = errors_of(report(_racy_prog()), analysis.PASS_RACE)
    assert len(errs) == 1 and "race" in errs[0].message


def test_race_waiver_downgrades_and_stale_waiver_warns():
    w = analysis.Waiver(analysis.PASS_RACE, "left",
                        "last-writer-wins by design")
    rep = report(_racy_prog(), waivers=(w,))
    assert rep.ok() and len(rep.waived) == 1
    assert "last-writer-wins" in rep.waived[0].message
    stale = analysis.Waiver(analysis.PASS_RACE, "no-such-tag", "stale")
    rep2 = report(_racy_prog(), waivers=(w, stale))
    assert not rep2.ok()
    assert any(f.pass_name == analysis.PASS_WAIVER for f in rep2.warnings)


def test_wait_ordering_suppresses_race():
    assert report(_wait_ordered_writes(assembler)).ok()


# ---------------------------------------------------------------------------
# finalize(verify=...) admission gate + build-time validation
# ---------------------------------------------------------------------------

def test_finalize_verify_raises_on_bad_program():
    with pytest.raises(analysis.VerificationError) as ei:
        _racy_prog().finalize(verify=True, name="racy", device="cpu")
    assert "racy" in str(ei.value) and ei.value.report.errors
    with pytest.raises(janalysis.VerificationError) as ej:
        _racy_prog(jasm).finalize(verify=True, name="racy")
    assert str(ei.value) == str(ej.value)


def test_finalize_verify_accepts_clean_and_waivered():
    p = assembler.Program(256)
    x = p.word(0)
    p.add_wq(2).write_imm(dst=x, value=1)
    spec, state = p.finalize(verify=True, device="cpu")
    assert spec.mem_words == 256 and state.mem.device.type == "cpu"
    w = analysis.Waiver(analysis.PASS_RACE, "left", "benign")
    _racy_prog().finalize(verify=True, waivers=(w,), device="cpu")


def test_post_rejects_oversized_copy_and_bad_opcode():
    p = assembler.Program(256)
    wq = p.add_wq(4)
    with pytest.raises(ValueError, match="MAX_COPY"):
        wq.write(src=0, dst=8, ln=isa.MAX_COPY + 1)
    with pytest.raises(ValueError, match="opcode"):
        wq.post(isa.NUM_OPCODES)
    with pytest.raises(ValueError, match="MAX_SCATTER"):
        p.scatter_table(list(range(isa.MAX_SCATTER + 1)))
    assert wq.n_posted == 0             # nothing half-posted


# ---------------------------------------------------------------------------
# assembler edge cases the analyzer leans on
# ---------------------------------------------------------------------------

def test_future_wr_addr_resolves_fields():
    p = assembler.Program(256)
    wq = p.add_wq(4)
    ahead0 = {f: wq.future_wr_addr(0, f) for f in isa.FIELD_NAMES}
    ahead1_src = wq.future_wr_addr(1, "src")
    r0 = wq.noop()
    r1 = wq.noop()
    assert ahead0 == {f: r0.addr(f) for f in isa.FIELD_NAMES}
    assert ahead1_src == r1.addr("src")
    assert r0.ctrl_addr == r0.addr("ctrl")


def test_wait_for_counts_signaled_completions_only():
    p = assembler.Program(256)
    wq0 = p.add_wq(4)
    wq1 = p.add_wq(4)
    wq0.noop(signaled=False)
    ref = wq0.noop()                    # first *signaled* completion
    wq0.noop()
    w = wq1.wait_for(ref)
    assert ref.completion_count == 1
    assert wq1.wrs[w.slot]["opa"] == 1 and wq1.wrs[w.slot]["opb"] == 0
    assert report(p).ok()


# ---------------------------------------------------------------------------
# registry sweep + certificates
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def all_reports():
    return analysis.verify_all("cpu")


@pytest.fixture(scope="module")
def jax_reports():
    return janalysis.verify_all()


def test_registry_sweep_clean_or_waivered(all_reports):
    bad = {n: [str(f) for f in r.errors + r.warnings]
           for n, r in all_reports.items() if not r.ok()}
    assert not bad, f"non-waived findings: {bad}"
    assert sorted(all_reports) == NAMES and len(NAMES) == 18


def test_static_wr_bound_matches_budget(all_reports):
    for name, rep in all_reports.items():
        cats = rep.certificates["budget"]
        n_posted = rep.certificates["n_posted"]
        assert sum(cats.values()) == n_posted, name
        bound = rep.certificates["static_wr_bound"]
        if rep.certificates["recycled_wqs"]:
            assert bound is None, name
        else:
            assert bound == n_posted, name


def test_static_bound_under_engine_fuel(all_reports):
    checked = 0
    for name, rep in all_reports.items():
        fuel = rep.certificates.get("fuel")
        if fuel is None:
            continue
        checked += 1
        bound = rep.certificates["static_wr_bound"]
        assert bound is not None and bound < fuel, name
    assert checked, "no builder exposed an engine fuel to check"


def test_latency_certificates_are_positive(all_reports):
    for name, rep in all_reports.items():
        c = rep.certificates
        assert c["serial_latency_us"] > 0, name
        total = sum(c["wq_latency_us"].values())
        assert c["serial_latency_us"] == pytest.approx(total, abs=0.01), name


# ---------------------------------------------------------------------------
# disassembler / CLI
# ---------------------------------------------------------------------------

def test_disassemble_renders_opcodes_and_patches():
    p = _selfmod_prog(assembler, isa.ORD_WQ)
    text = analysis.disassemble(p, name="demo")
    assert "demo" in text and "WRITE_IMM" in text
    assert "patches" in text            # the self-mod annotation


def test_cli_list_and_single_builder(capsys):
    assert analysis.main(["--list"]) == 0
    out = capsys.readouterr().out
    assert "rpc_echo" in out and "hopscotch_migrator" in out
    assert analysis.main(["rpc_echo", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "SEND" in out and "0 error(s)" in out


def test_cli_sweep_exits_zero(capsys):
    assert analysis.main(["--sweep", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "clean-or-waivered" in out


# ---------------------------------------------------------------------------
# pass: races — the bounded CAS-retry loop (waiver-or-proof admission)
# ---------------------------------------------------------------------------

def _retry_pair():
    return tprograms.build_cas_retry_pair(attempts=2, device="cpu")


def _break_claims(pair):
    broken = 0
    for wq in pair.prog.wqs:
        for wr in wq.wrs:
            if wr.get("tag") == "claim.cas":
                wr["src"] = -1
                broken += 1
    return broken


def test_retry_race_flagged_without_waiver():
    rep = report(_retry_pair().prog, name="retry-pair")
    errs = errors_of(rep, analysis.PASS_RACE)
    assert errs and "claim.cas" in errs[0].message


def test_retry_waiver_admits_proven_retry_shape():
    w = analysis.retry_loop_waiver("claim.cas", "bounded CAS-retry race")
    rep = report(_retry_pair().prog, waivers=(w,), name="retry-pair")
    assert rep.ok() and len(rep.waived) >= 1
    assert "bounded CAS-retry race" in rep.waived[0].message


def test_retry_waiver_refuses_unproven_shape():
    pair = _retry_pair()
    assert _break_claims(pair) == 2 * pair.attempts
    w = analysis.retry_loop_waiver("claim.cas", "no longer true")
    rep = report(pair.prog, waivers=(w,), name="retry-pair-broken")
    assert not rep.ok()
    assert errors_of(rep, analysis.PASS_RACE)
    assert any(f.pass_name == analysis.PASS_WAIVER for f in rep.warnings)


def test_retry_waiver_base_class_tag_match_is_not_enough():
    pair = _retry_pair()
    _break_claims(pair)
    plain = analysis.Waiver(analysis.PASS_RACE, "claim.cas", "tag only")
    assert report(pair.prog, waivers=(plain,)).ok()
    proof = analysis.retry_loop_waiver("claim.cas", "proof")
    assert not report(pair.prog, waivers=(proof,)).ok()


# ---------------------------------------------------------------------------
# parity with the JAX package's verifier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_registry_findings_equal_jax(name, all_reports, jax_reports):
    assert _findings(all_reports[name]) == _findings(jax_reports[name])
    assert all_reports[name].render() == jax_reports[name].render()


@pytest.mark.parametrize("name", NAMES)
def test_registry_certificates_equal_jax(name, all_reports, jax_reports):
    assert all_reports[name].certificates == jax_reports[name].certificates


@pytest.mark.parametrize("name", NAMES)
def test_registry_disassembly_equal_jax(name):
    tprog, _ = analysis._registry()[name].build(torch.device("cpu"))
    jprog, _ = janalysis._registry()[name].build()
    text = analysis.disassemble(tprog, name=name)
    assert text == janalysis.disassemble(jprog, name=name)
    assert text.count("\n") + 1 == 1 + len(tprog.wqs) + sum(
        w.n_posted for w in tprog.wqs)


@pytest.mark.parametrize("case", sorted(ENGINEERED))
def test_engineered_programs_findings_equal_jax(case):
    build = ENGINEERED[case]
    tprog, jprog = build(assembler), build(jasm)
    assert _findings(report(tprog)) == _findings(
        janalysis.verify_program(jprog, name="t"))
    assert analysis.disassemble(tprog) == janalysis.disassemble(jprog)


def test_broken_retry_pair_findings_equal_jax():
    tpair = _retry_pair()
    jpair = jprograms.build_cas_retry_pair(attempts=2)
    for pair in (tpair, jpair):
        _break_claims(pair)
    for mk in (lambda a: a.retry_loop_waiver("claim.cas", "proof"),
               lambda a: a.Waiver(a.PASS_RACE, "claim.cas", "tag only")):
        got = report(tpair.prog, waivers=(mk(analysis),))
        want = janalysis.verify_program(jpair.prog,
                                        waivers=(mk(janalysis),), name="t")
        assert _findings(got) == _findings(want)


_SWEEP_KEYS = ("static_wr_bound", "n_wqs", "n_posted", "recycled_wqs",
               "budget", "serial_latency_us", "fuel")


def test_sweep_equals_bench_chains_verification(all_reports):
    """The port's sweep reproduces the JAX package's recorded sweep
    (``BENCH_chains.json`` ``verification.programs``) field for field."""
    bench = json.loads((ROOT / "BENCH_chains.json").read_text())
    want = bench["verification"]["programs"]
    assert sorted(want) == NAMES
    for name, rep in all_reports.items():
        c = rep.certificates
        got = dict(ok=rep.ok(), errors=len(rep.errors),
                   warnings=len(rep.warnings), waived=len(rep.waived),
                   **{k: c[k] for k in _SWEEP_KEYS if k in c})
        assert got == want[name], name


def test_cli_exits_as_jax(capsys):
    for argv in (["--list"], ["--sweep"], ["no_such_builder"], []):
        want = janalysis.main(argv)
        jout = capsys.readouterr()
        got = analysis.main(argv + (["--device", "cpu"] if argv else []))
        tout = capsys.readouterr()
        assert got == want, argv
        if argv and argv[0].startswith("--"):
            assert tout.out == jout.out, argv
    assert analysis.main(["turing_interpreter", "--device", "cpu"]) == 0
    tout = capsys.readouterr().out
    assert janalysis.main(["turing_interpreter"]) == 0
    assert tout == capsys.readouterr().out


def test_verify_builder_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        analysis.verify_builder("rpc_echo")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        analysis.main(["--sweep"])
