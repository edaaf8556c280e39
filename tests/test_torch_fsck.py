"""Parity of the port's fsck with the JAX package: the engineered
violations of ``tests/test_faults.py`` (torn claim, stale row, half-done
move, neighborhood breach, watermark resident, the cross-frame policy),
the deadline column's torn vacate, the sequential repair of a key with
three copies, random frames with planted tears, and the report at the
vectorised scale (4 x 4,096 buckets) against JAX's per-bucket loop.  Reports must be identical — the same violations in
the same order with the same ``detail`` strings — and so must the repair
actions and the repaired arrays."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kvstore import fsck as jfsck
from repro.kvstore import store as jstore
from repro_torch.kvstore import fsck as tfsck
from repro_torch.kvstore import hopscotch as th
from repro_torch.kvstore import store as tstore


def _t(a):
    return torch.from_numpy(np.array(a))


def _frame(n, v=2, s=1):
    return np.zeros((s, n), np.int32), np.zeros((s, n, v), np.int32)


def _homed(bucket, count, n, start=1):
    return tstore.keys_homed_at(bucket, count, n, start=start)


def _check_both(keys, vals, h, exp=None):
    want = jfsck.check_invariants(jnp.asarray(keys), jnp.asarray(vals),
                                  neighborhood=h,
                                  exp=None if exp is None
                                  else jnp.asarray(exp))
    got = tfsck.check_invariants(_t(keys), _t(vals), neighborhood=h,
                                 exp=None if exp is None else _t(exp))
    assert got == want
    assert repr(got) == repr(want)
    assert (got.clean, got.repairable) == (want.clean, want.repairable)
    return got


def _repair_both(keys, vals, rep, h, exp=None):
    """Repair through both packages: actions and arrays equal; the port's
    inputs are left untouched.  Returns the port's repaired arrays."""
    if exp is None:
        jk, jv, jact = jfsck.repair(jnp.asarray(keys), jnp.asarray(vals), rep,
                                    neighborhood=h)
        tk0, tv0 = _t(keys), _t(vals)
        tk, tv, tact = tfsck.repair(tk0, tv0, rep, neighborhood=h)
        want, got = (jk, jv), (tk, tv)
    else:
        jk, jv, je, jact = jfsck.repair(jnp.asarray(keys), jnp.asarray(vals),
                                        rep, neighborhood=h,
                                        exp=jnp.asarray(exp))
        tk0, tv0 = _t(keys), _t(vals)
        tk, tv, te, tact = tfsck.repair(tk0, tv0, rep, neighborhood=h,
                                        exp=_t(exp))
        want, got = (jk, jv, je), (tk, tv, te)
    assert tact == jact
    assert [a.action for a in tact] == [a.action for a in jact]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(tk0.numpy(), keys)
    return got


def _fix_both(keys, vals, h, exp=None):
    rep = _check_both(keys, vals, h, exp)
    out = _repair_both(keys, vals, rep, h, exp)
    return rep, out


# --- engineered violations, steady state -------------------------------------

def test_fsck_clean_on_valid_frame():
    keys, vals = _frame(8)
    keys[0, 2] = _homed(2, 1, 8)[0]
    vals[0, 2] = [5, 6]
    rep = _check_both(keys, vals, 4)
    assert rep.clean and rep.repairable
    assert repr(rep) == "FsckReport(clean)"


def test_fsck_torn_claim_detected_and_repaired():
    keys, vals = _frame(8)
    keys[0, 2] = _homed(2, 1, 8)[0]
    rep, (k, v) = _fix_both(keys, vals, 4)
    assert [x.kind for x in rep.violations] == ["torn-claim"]
    assert int(k[0, 2]) == th.EMPTY
    assert tfsck.check_invariants(k, v, neighborhood=4).clean


def test_fsck_stale_row_detected_and_zeroed():
    keys, vals = _frame(8)
    vals[0, 5] = [9, 9]
    rep, (k, v) = _fix_both(keys, vals, 4)
    assert [x.kind for x in rep.violations] == ["stale-row"]
    assert rep.violations[0].detail == "EMPTY bucket holds value row [9, 9]"
    assert not bool(v[0, 5].any())


def test_fsck_dup_key_vacates_copy_farthest_from_home():
    keys, vals = _frame(8)
    k = _homed(2, 1, 8)[0]
    keys[0, 2] = keys[0, 3] = k
    vals[0, 2] = vals[0, 3] = [5, 6]
    rep, (kk, vv) = _fix_both(keys, vals, 4)
    assert [x.kind for x in rep.violations] == ["dup-key"]
    assert rep.violations[0].bucket == 3     # the second sighting
    assert rep.violations[0].detail == "also live at bucket 2"
    assert int(kk[0, 2]) == k and int(kk[0, 3]) == th.EMPTY


def test_fsck_three_copies_repair_sequentially():
    """Three copies give two dup-key violations; each repair recomputes
    the copies from the keys the earlier repairs left."""
    n = 16
    keys, vals = _frame(n)
    k = _homed(4, 1, n)[0]
    for b in (4, 5, 7):
        keys[0, b] = k
        vals[0, b] = [1, b]
    rep, (kk, _) = _fix_both(keys, vals, 8)
    assert [(x.kind, x.bucket) for x in rep.violations] == [
        ("dup-key", 5), ("dup-key", 7)]
    assert kk[0].tolist().count(k) == 1 and int(kk[0, 4]) == k


def test_fsck_dup_repair_order_follows_the_report():
    """Three copies at distances 0, 1, 2 from home: the first repair
    vacates the farthest (bucket 2), the second, recomputing the copies,
    the next farthest (bucket 1); the copy at home survives."""
    n = 4
    keys, vals = _frame(n)
    k = _homed(0, 1, n)[0]
    keys[0, :3] = k
    vals[0, :3] = 1
    rep, (kk, _) = _fix_both(keys, vals, 4)
    assert [x.kind for x in rep.violations] == ["dup-key", "dup-key"]
    assert kk[0].tolist() == [k, 0, 0, 0]


def test_fsck_neighborhood_breach_reported_not_repaired():
    keys, vals = _frame(8)
    keys[0, 5] = _homed(0, 1, 8)[0]
    vals[0, 5] = [1, 1]
    rep, (k2, _) = _fix_both(keys, vals, 4)
    assert [x.kind for x in rep.violations] == ["neighborhood"]
    assert rep.violations[0].detail == "5 buckets from home (H=4)"
    assert not rep.repairable
    np.testing.assert_array_equal(k2.numpy(), keys)


def test_fsck_torn_vacate_resets_deadline():
    keys, vals = _frame(8, s=2)
    exp = np.full((2, 8), th.NO_TTL, np.int32)
    exp[1, 3] = 500                          # EMPTY bucket, stale deadline
    vals[1, 6] = [4, 4]                      # and a ghost row beside it
    exp[1, 6] = 9
    live = _homed(1, 1, 8)[0]
    keys[0, 1], vals[0, 1], exp[0, 1] = live, [2, 2], 77
    rep, (_, _, e) = _fix_both(keys, vals, 4, exp)
    assert [(x.kind, x.shard, x.bucket) for x in rep.violations] == [
        ("torn-vacate", 1, 3), ("stale-row", 1, 6), ("torn-vacate", 1, 6)]
    assert rep.violations[0].detail == (
        "EMPTY bucket holds deadline 500 (vacate cut before the expiry "
        "reset)")
    assert int(e[1, 3]) == int(e[1, 6]) == th.NO_TTL and int(e[0, 1]) == 77


def test_repair_bucket_matches_jax():
    keys, vals = _frame(8, s=2)
    keys[1, 4], vals[1, 4] = 9, [3, 3]
    for kw in ({}, dict(key=5, val=[7, 8])):
        jk, jv = jstore.repair_bucket(jnp.asarray(keys), jnp.asarray(vals), 1,
                                      4, **kw)
        tk, tv = tstore.repair_bucket(_t(keys), _t(vals), 1, 4, **kw)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# --- engineered violations, mid-resize ---------------------------------------

def _resize_both(ok, ov, gk, gv, wm):
    frames = (ok, ov, gk, gv, np.asarray(wm, np.int32))
    return (jstore.ResizeState(*map(jnp.asarray, frames)),
            tstore.ResizeState(*map(_t, frames)))


def _check_resize_both(jrs, trs, h):
    want = jfsck.check_invariants(resize=jrs, neighborhood=h)
    got = tfsck.check_invariants(resize=trs, neighborhood=h)
    assert got == want
    return got


def _repair_resize_both(jrs, trs, rep, h):
    jrs2, jact = jfsck.repair_resize(jrs, rep, neighborhood=h)
    trs2, tact = tfsck.repair_resize(trs, rep, neighborhood=h)
    assert tact == jact
    for g, w in zip(trs2, jrs2):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    return trs2, tact


def test_fsck_watermark_resident_reported():
    ok, ov = _frame(8)
    gk, gv = _frame(16)
    ok[0, 1] = _homed(1, 1, 8)[0]
    ov[0, 1] = [3, 3]
    jrs, trs = _resize_both(ok, ov, gk, gv, [4])
    rep = _check_resize_both(jrs, trs, 4)
    assert "watermark" in [x.kind for x in rep.violations]
    assert not rep.repairable


@pytest.mark.parametrize("w", [-3, 9])
def test_fsck_watermark_out_of_range(w):
    ok, ov = _frame(8)
    gk, gv = _frame(16)
    ok[0, 6] = _homed(6, 1, 8)[0]
    ov[0, 6] = [3, 3]
    jrs, trs = _resize_both(ok, ov, gk, gv, [w])
    rep = _check_resize_both(jrs, trs, 4)
    assert rep.violations[0].kind == "watermark"


@pytest.mark.parametrize("new_row_complete", [True, False])
def test_fsck_cross_frame_dup_policy(new_row_complete):
    ok, ov = _frame(8)
    gk, gv = _frame(16)
    k = _homed(2, 1, 8)[0]
    ok[0, 2], ov[0, 2] = k, [7, 8]
    b_new = int(th.bucket_of(k, 16))
    gk[0, b_new] = k
    if new_row_complete:
        gv[0, b_new] = [7, 8]
    jrs, trs = _resize_both(ok, ov, gk, gv, [0])
    rep = _check_resize_both(jrs, trs, 4)
    assert rep.of_kind("cross-frame-dup") and rep.repairable
    rs2, actions = _repair_resize_both(jrs, trs, rep, 4)
    acts = {a.action for a in actions}
    if new_row_complete:
        assert "vacate-old" in acts
        assert int(rs2.keys[0, 2]) == th.EMPTY
        assert int(rs2.new_keys[0, b_new]) == k
    else:
        assert "vacate-new" in acts
        assert int(rs2.keys[0, 2]) == k
        assert int(rs2.new_keys[0, b_new]) == th.EMPTY
    assert tfsck.check_invariants(resize=rs2, neighborhood=4).clean


# --- random frames and the vectorised scale ----------------------------------

def _planted(seed, s, n, v=2, h=8, fill=0.5, tears=24):
    """A random frame (random keys at random buckets of their
    neighborhoods) with every kind of tear planted at random buckets:
    torn claims, stale rows, duplicates (in and out of the neighborhood),
    breaches, and stray deadlines."""
    rng = np.random.RandomState(seed)
    keys, vals = _frame(n, v, s)
    exp = np.full((s, n), th.NO_TTL, np.int32)
    for sh in range(s):
        for k in rng.choice(np.arange(1, 1 << 22), int(n * fill),
                            replace=False).tolist():
            b = (int(th.bucket_of(k, n)) + rng.randint(h)) % n
            if keys[sh, b] == 0:
                keys[sh, b] = k
                vals[sh, b] = rng.randint(1, 1000, v)
                exp[sh, b] = rng.randint(0, 1 << 20)
    for _ in range(tears):
        sh, b = rng.randint(s), rng.randint(n)
        kind = rng.randint(5)
        if kind == 0 and keys[sh, b]:
            vals[sh, b] = 0                              # torn claim
        elif kind == 1 and not keys[sh, b]:
            vals[sh, b, rng.randint(v)] = rng.randint(1, 9)   # stale row
        elif kind == 2:
            src = rng.randint(n)
            if keys[sh, src]:
                d = rng.randint(1, h + 3)               # dup, maybe far
                keys[sh, (src + d) % n] = keys[sh, src]
                vals[sh, (src + d) % n] = vals[sh, src]
        elif kind == 3 and keys[sh, b]:
            keys[sh, (b + h + 1) % n] = keys[sh, b]     # a breach
            keys[sh, b] = 0
            vals[sh, b] = 0
        elif not keys[sh, b]:
            exp[sh, b] = rng.randint(0, 99)             # torn vacate
    return keys, vals, exp


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_planted_frames_match_jax(seed):
    keys, vals, exp = _planted(seed, 3, 64, h=4, tears=40)
    rep, out = _fix_both(keys, vals, 4, exp)
    assert len({x.kind for x in rep.violations}) >= 3
    # what the repair leaves (a breach; a vacated claim's deadline) is
    # reported alike too
    _check_both(*(a.numpy() for a in out[:2]), 4, out[2].numpy())


def test_random_planted_resize_frames_match_jax():
    ok, ov, _ = _planted(5, 2, 32, h=4, tears=12)
    gk, gv, _ = _planted(6, 2, 64, h=4, tears=12)
    # cross-frame duplicates, complete and torn
    for sh, b_old, row in ((0, 3, True), (1, 9, False), (1, 20, True)):
        k = int(ok[sh, b_old]) or 4242
        ok[sh, b_old], ov[sh, b_old] = k, [1, 2]
        b_new = int(th.bucket_of(k, 64))
        gk[sh, b_new] = k
        gv[sh, b_new] = [1, 2] if row else 0
    jrs, trs = _resize_both(ok, ov, gk, gv, [5, 40])
    rep = _check_resize_both(jrs, trs, 4)
    assert rep.of_kind("cross-frame-dup") and rep.of_kind("watermark")
    _repair_resize_both(jrs, trs, rep, 4)


def test_report_at_vectorised_scale_matches_jax_loop():
    """4 x 4,096 buckets with planted tears: the tensor-op checker's
    report (and repair) equals JAX's per-bucket loop."""
    keys, vals, exp = _planted(11, 4, 4096, h=8, fill=0.6, tears=200)
    rep, _ = _fix_both(keys, vals, 8, exp)
    assert len(rep.violations) > 50
    assert {x.kind for x in rep.violations} >= {
        "torn-claim", "stale-row", "dup-key", "neighborhood", "torn-vacate"}
