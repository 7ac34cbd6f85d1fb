"""Right-origin staging (``ops/staging.py:_stage_rights``) against the
group-by-group loop it replaced, kept here as the oracle: the client
column, the hard segments and their representative rows, the largest
rank and every ``rights.*`` counter must come out the same on nested
workspaces, on hand-built forests of hostile shapes and on random
ones; and the native conflict scan must order every group as
``ops/yata.py:_simulate_group`` does, including when the native library
is missing."""

import numpy as np
import pytest

from benchmark.gen import nested
from crdt_tpu_torch.codec import native
from crdt_tpu_torch.models.replay import replay_trace
from crdt_tpu_torch.obs.tracer import Tracer, get_tracer, set_tracer
from crdt_tpu_torch.ops import staging
from crdt_tpu_torch.ops.device import _CLOCK_BITS
from crdt_tpu_torch.ops.staging import _RIGHT_WALK_CAP, _right_walks
from crdt_tpu_torch.ops.yata import _simulate_group

MIX = {"insert": 0.5, "push": 0.3, "unshift": 0.1, "cut": 0.1}
COUNTERS = ("rights.rows", "rights.groups", "rights.scanned_groups",
            "rights.hard_segments", "rights.hard_rows")


# the loop over segments and origin groups as it stood before the
# array passes, verbatim
def _oracle_stage_rights(cols, order, ikey_s, uniq, seg, origin_row, oc_s,
                  seq_rows, uniq_valid, kid_s, client_s, client_raw_s,
                  clock_raw_s):
    """Exact right-origin (attachment) ordering, computed at staging
    in column space — the device kernel needs NO change: a simulated
    group's conflict-scan ranks are written over its members' entries
    in the client column, and since ranks are unique within a group
    the kernel's (client, position) tie-break never fires.

    Semantics match ops.yata.order_sequences exactly. A segment is
    HARD — routed to the scalar fallback at gather via the returned
    representative rows — when any member's declared origin is
    unresolved (orphan subtrees take the fallback's dropping rules),
    or any member's right is dangling/unknown, cross-segment, or
    inside another member's subtree (right_walk_is_hard). Groups with
    in-group anchors replay the Yjs conflict scan (_simulate_group);
    attachment-free groups keep the plain (client, clock-desc) key.

    Returns (client column, caller-space hard rows, max rank written,
    hard segment ids). The hard segment ids let the subtree split
    skip exactly the segments whose staged order is inexact — every
    other right-bearing segment has its conflict-scan ranks baked
    into the client column by the time the split runs, so the
    sibling comparator (and any DFS-suffix cut of it) stays exact.

    With the tracer on, the group loop is the span ``pack.rights.scan``
    and the pass counts ``rights.rows`` (right-bearing sequence rows),
    ``rights.groups`` (origin groups holding one), ``rights.scanned_groups``
    (those replayed through the conflict scan), ``rights.hard_segments``
    and ``rights.hard_rows`` (the right-bearing rows of hard segments).
    """
    n = len(client_s)
    rr = np.asarray(cols["right_client"], np.int64)[order]
    rk = np.asarray(cols["right_clock"], np.int64)[order]
    rows_r = np.flatnonzero(uniq_valid & (kid_s < 0) & (rr >= 0))
    if not len(rows_r):
        return client_s, [], 0, []

    # resolve right-target rows through the dense id table (leftmost
    # match is the kept duplicate representative, like origins)
    posu = np.clip(
        np.searchsorted(uniq, np.clip(rr, uniq[0], None)), 0, len(uniq) - 1
    )
    known_c = (
        (rr >= 0) & (uniq[posu] == rr)
        & (rk >= 0) & (rk < (1 << _CLOCK_BITS))
    )
    rkey = np.where(known_c, (posu << _CLOCK_BITS) | rk, np.int64(-1))
    pos = np.clip(np.searchsorted(ikey_s, rkey), 0, n - 1)
    right_row = np.where((rkey >= 0) & (ikey_s[pos] == rkey), pos, -1)

    # segment -> member rows (one stable sort over the seq rows)
    seg_of_seq = seg[seq_rows]
    so = np.argsort(seg_of_seq, kind="stable")
    ss, sr = seg_of_seq[so], seq_rows[so]
    seg_cuts = np.r_[0, np.flatnonzero(ss[1:] != ss[:-1]) + 1, len(ss)]
    seg_slices = {
        int(ss[a]): sr[a:b] for a, b in zip(seg_cuts[:-1], seg_cuts[1:])
    }

    walk_of = np.full(n, -1, np.int8)
    walk_of[rows_r] = _right_walks(rows_r, right_row, origin_row, seg,
                                   seq_rows)
    tracer = get_tracer()
    hard_reps: list = []
    hard_segs: list = []
    max_rank = 0
    n_groups = n_scanned = 0
    # accumulated conflict-scan ranks, written with ONE bulk
    # searchsorted at the end (a per-sid binary search dominated text
    # staging time — profiled round 4)
    rank_sids: list = []
    rank_vals: list = []
    with tracer.span("pack.rights.scan"):
        for S in np.unique(seg[rows_r]).tolist():
            members = seg_slices.get(int(S))
            if members is None:
                continue
            # orphan member (declared origin that resolved nowhere):
            # vectorized — member loops in python made staging the text
            # replay's dominant cost
            if bool(np.any((oc_s[members] >= 0)
                           & (origin_row[members] < 0))):
                hard_reps.append(int(order[int(members[0])]))
                hard_segs.append(int(S))
                continue
            # groups within the segment, keyed by in-union origin row:
            # one stable sort + run split instead of a python setdefault
            # walk over every member
            og = origin_row[members]
            gorder = np.argsort(og, kind="stable")
            og_s, mem_s = og[gorder], members[gorder]
            gcuts = np.r_[
                0, np.flatnonzero(og_s[1:] != og_s[:-1]) + 1, len(og_s)
            ]
            hard = False
            # shared walk budget for ALL of this segment's out-of-group
            # right walks: linear in segment size (hostile staging cost
            # stays O(n) total — advisor finding, round 3), generous for
            # benign shapes; exhaustion marks the segment hard, which the
            # exact scalar fallback absorbs. Chains _right_walks answered
            # (those within the segment) draw nothing from it
            walk_budget = max(_RIGHT_WALK_CAP, 8 * len(members))
            seg_rank_sids: list = []
            seg_rank_vals: list = []
            seg_max_rank = 0
            for a, b in zip(gcuts[:-1], gcuts[1:]):
                grows = mem_s[a:b]
                # only right-bearing members need the per-row checks
                gr = grows[rr[grows] >= 0]
                if not len(gr):
                    continue
                n_groups += 1
                grow_set = set(grows.tolist())
                has_anchor = False
                # one fused python pass (groups are tiny — typically the
                # few writers racing one position — so per-group numpy
                # reductions cost more than they save)
                for rt, walked in zip(right_row[gr].tolist(),
                                      walk_of[gr].tolist()):
                    if rt < 0 or seg[rt] != S:
                        hard = True  # dangling/unknown or cross-parent
                        break
                    if rt in grow_set:
                        has_anchor = True  # in-group anchor: simulated
                        continue
                    if walked >= 0:
                        # answered by _right_walks without a walk
                        if walked:
                            hard = True
                            break
                        continue
                    # out-of-group right: hard if its origin chain passes
                    # through a GROUP member (the scan would stop inside
                    # that member's subtree). Walks draw on the segment's
                    # shared linear budget (see above)
                    cur = rt
                    while cur >= 0:
                        if cur in grow_set:
                            hard = True
                            break
                        walk_budget -= 1
                        if walk_budget < 0:
                            hard = True  # budget spent: exact fallback
                            break
                        cur = int(origin_row[cur])
                    if hard:
                        break
                if hard:
                    break
                if not has_anchor:
                    continue  # attachment-free: plain keys are exact
                glist = grows.tolist()
                sibs = [
                    {
                        "id": int(ikey_s[r]),
                        "client": int(client_raw_s[r]),
                        "clock": int(clock_raw_s[r]),
                        "right": int(rkey[r]) if rr[r] >= 0 else None,
                    }
                    for r in glist
                ]
                ordered = _simulate_group(
                    sibs, {int(ikey_s[r]) for r in glist}
                )
                n_scanned += 1
                seg_rank_sids.extend(ordered)
                seg_rank_vals.extend(range(len(ordered)))
                seg_max_rank = max(seg_max_rank, len(ordered) - 1)
            if hard:
                hard_reps.append(int(order[int(members[0])]))
                hard_segs.append(int(S))
                continue
            rank_sids.extend(seg_rank_sids)
            rank_vals.extend(seg_rank_vals)
            max_rank = max(max_rank, seg_max_rank)
    if tracer.enabled:
        hard_rows = 0
        if hard_segs:
            hard_rows = int(np.isin(seg[rows_r], hard_segs).sum())
        for name, v in (("rights.rows", len(rows_r)),
                        ("rights.groups", n_groups),
                        ("rights.scanned_groups", n_scanned),
                        ("rights.hard_segments", len(hard_segs)),
                        ("rights.hard_rows", hard_rows)):
            tracer.count(name, v)
    if rank_sids:
        rows = np.searchsorted(ikey_s, np.asarray(rank_sids, np.int64))
        client_s[rows] = np.asarray(rank_vals, np.int64)
    return client_s, hard_reps, max_rank, hard_segs


def _run(fn, args):
    old = get_tracer()
    tr = set_tracer(Tracer(enabled=True))
    try:
        a = list(args)
        a[10] = args[10].copy()
        out = fn(*a)
    finally:
        set_tracer(old)
    return out, tr.counters("rights.")


@pytest.fixture
def compared(monkeypatch):
    """Every ``_stage_rights`` call staging makes is also run through
    the oracle; the list holds each call's (new counters, result)."""
    calls = []
    real = staging._stage_rights

    def both(*args):
        (col, reps, top, segs), c = _run(real, args)
        (ocol, oreps, otop, osegs), oc = _run(_oracle_stage_rights, args)
        assert np.array_equal(col, ocol)
        assert (reps, top, segs) == (oreps, otop, osegs)
        assert {k: c.get(k, 0) for k in COUNTERS} == \
            {k: oc.get(k, 0) for k in COUNTERS}
        calls.append((c, (col, reps, top, segs)))
        return real(*args)

    monkeypatch.setattr(staging, "_stage_rights", both)
    return calls


def _scanned(c, path):
    return c.get(f'rights.scanned_rows{{path="{path}"}}', 0)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_nested_workspaces_stage_as_the_loop_did(compared, seed):
    blobs, _, _, info = nested.build(8, 16, 300, 50, 0.99, MIX, 6, 32, seed)
    replay_trace(blobs, route="device", device="cpu")
    assert len(compared) == 1
    c, (_, reps, top, _) = compared[0]
    assert c["rights.rows"] == info["right_bearing"]
    assert c["rights.scanned_groups"] > 0 and top > 0 and reps == []
    assert c["rights.walked_rows"] == 0
    assert _scanned(c, "native") > c["rights.scanned_groups"]


def test_without_the_native_library_groups_replay_in_python(
        compared, monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)
    blobs, _, _, _ = nested.build(8, 16, 300, 50, 0.99, MIX, 6, 32, 7)
    replay_trace(blobs, route="device", device="cpu")
    c = compared[0][0]
    assert _scanned(c, "python") > 0 and _scanned(c, "native") == 0


def _cols(rows, lists=("l", "m")):
    """Sequence rows (client, clock, list, origin, right) as kernel
    columns; origin and right are ids or None."""
    def ids(i):
        return np.asarray([r[i] or (-1, -1) for r in rows], np.int64)
    o, rt = ids(3), ids(4)
    n = len(rows)
    return {
        "client": np.asarray([r[0] for r in rows], np.int64),
        "clock": np.asarray([r[1] for r in rows], np.int64),
        "parent_is_root": np.ones(n, bool),
        "parent_a": np.asarray([lists.index(r[2]) for r in rows], np.int64),
        "parent_b": np.full(n, -1, np.int64),
        "key_id": np.full(n, -1, np.int64),
        "origin_client": o[:, 0], "origin_clock": o[:, 1],
        "right_client": rt[:, 0], "right_clock": rt[:, 1],
        "valid": np.ones(n, bool),
    }


# a list ``l`` of A, then B and C after A racing D (inserted before B):
# one group with an in-group anchor, in a segment nothing makes hard
BENIGN = [(1, 0, "l", None, None), (1, 1, "l", (1, 0), None),
          (3, 0, "l", (1, 0), None), (2, 0, "l", (1, 0), (1, 1)),
          (4, 0, "l", None, (1, 0))]
# a list ``m`` beside it with its own anchored group
OTHER = [(5, 0, "m", None, None), (5, 1, "m", (5, 0), None),
         (6, 0, "m", (5, 0), (5, 1))]


def _one(compared, rows):
    plan = staging.stage(_cols(rows))
    assert plan is not None and len(compared) == 1
    return compared[0]


def _chain(client, n, lst, first_origin=None):
    """``n`` rows of one client, each after the one before."""
    out, prev = [], first_origin
    for k in range(n):
        out.append((client, k, lst, prev, None))
        prev = (client, k)
    return out


HOSTILE = {
    # a declared origin no row carries
    "orphan": [(7, 0, "l", (9, 9), None)],
    # a right origin no row carries
    "dangling right": [(7, 0, "l", (1, 0), (99, 3))],
    # a right origin in another list
    "cross-segment right": [(7, 0, "l", (1, 0), (5, 1))],
    # a right origin inside a group member's subtree (under B)
    "right into a subtree": [(7, 0, "l", (1, 1), None),
                             (8, 0, "l", (1, 0), (7, 0))],
    # origins that loop: the walk from the right target never ends
    "origin cycle": [(7, 0, "l", (7, 1), None), (7, 1, "l", (7, 0), None),
                     (8, 0, "l", (1, 0), (7, 1))],
}


@pytest.mark.parametrize("case", sorted(HOSTILE))
def test_a_hostile_shape_makes_its_segment_hard(compared, case):
    c, (_, reps, _, segs) = _one(compared, BENIGN + OTHER + HOSTILE[case])
    assert c["rights.hard_segments"] == len(segs) == len(reps) == 1
    assert _scanned(c, "native") == 2  # list m's group alone


def test_a_chain_that_leaves_the_segment_is_walked(compared):
    # E's right target T hangs off list m's chain: the walk leaves l's
    # rows, meets no member of E's group and ends within its budget
    rows = BENIGN + OTHER + [(7, 0, "l", (5, 1), None),
                             (8, 0, "l", (1, 0), (7, 0))]
    c, (_, reps, _, _) = _one(compared, rows)
    assert reps == [] and c["rights.walked_rows"] == 1


def test_a_walk_that_returns_to_the_group_is_hard(compared):
    # T's chain leaves l for m and comes back to B, a member of the
    # group of the row that names T
    rows = BENIGN + OTHER + [(5, 2, "m", (1, 1), None),
                             (7, 0, "l", (5, 2), None),
                             (8, 0, "l", (1, 0), (7, 0))]
    c, (_, reps, _, _) = _one(compared, rows)
    assert len(reps) == 1 and c["rights.walked_rows"] == 1


def test_no_walk_is_made_after_a_segment_is_hard(compared):
    # the first group of l (no origin) names a right no row carries; a
    # later group's walk, which would meet B, is never made
    rows = BENIGN + OTHER + [(7, 0, "l", None, (99, 3)),
                             (5, 2, "m", (1, 1), None),
                             (7, 1, "l", (5, 2), None),
                             (8, 0, "l", (1, 0), (7, 1))]
    c, (_, reps, _, _) = _one(compared, rows)
    assert len(reps) == 1 and c["rights.walked_rows"] == 0
    assert c["rights.groups"] == 2  # l's first group and m's


@pytest.mark.parametrize("length,hard", [(_RIGHT_WALK_CAP - 8, False),
                                         (_RIGHT_WALK_CAP + 8, True)])
def test_the_walk_budget_is_shared_by_a_segment(compared, length, hard):
    # two groups of l (after A, after B) each walk one of two chains in
    # list m, half the length each: the budget runs out in the second
    # group when the two walks together pass it
    half = length // 2
    rows = BENIGN + _chain(9, half, "m") + _chain(10, half, "m") + [
        (7, 0, "l", (9, half - 1), None), (8, 0, "l", (1, 0), (7, 0)),
        (7, 1, "l", (10, half - 1), None), (8, 1, "l", (1, 1), (7, 1)),
        (6, 0, "l", (1, 1), (8, 1)),
    ]
    c, (_, reps, _, _) = _one(compared, rows)
    assert bool(reps) == hard
    assert c["rights.walked_rows"] == 2
    # the groups before the hard one still count as scanned
    assert c["rights.scanned_groups"] == (2 if hard else 3)


def _random_cols(seed, n=400, lists=10):
    rng = np.random.default_rng(seed)
    clients = rng.integers(1, 9, n)
    clocks = np.zeros(n, np.int64)
    seen: dict = {}
    for i, c in enumerate(clients.tolist()):
        clocks[i] = seen.get(c, 0)
        seen[c] = clocks[i] + 1
    lst = rng.integers(0, lists, n)
    o = np.full(n, -1, np.int64)
    r = np.full(n, -1, np.int64)
    for i in range(1, n):
        same = np.flatnonzero(lst[:i] == lst[i])
        u = rng.random()
        if u < 0.8 and len(same):
            o[i] = rng.choice(same[-4:])  # a few origins, many racing
        elif u < 0.83:
            o[i] = rng.integers(0, i)    # maybe another list
        group = same[o[same] == o[i]]
        v = rng.random()
        if v < 0.3 and len(group):
            r[i] = rng.choice(group)     # an in-group anchor
        elif v < 0.36 and len(same):
            r[i] = rng.choice(same)      # maybe into a subtree
        elif v < 0.37:
            r[i] = rng.integers(0, n)    # maybe another list
    if seed % 3 == 0:
        o[[n - 2, n - 1]] = [n - 1, n - 2]  # an origin cycle
    oc = np.where(o >= 0, clients[np.maximum(o, 0)], -1)
    ok = np.where(o >= 0, clocks[np.maximum(o, 0)], -1)
    rc = np.where(r >= 0, clients[np.maximum(r, 0)], -1)
    rk = np.where(r >= 0, clocks[np.maximum(r, 0)], -1)
    if seed % 4 == 1:
        oc[5], ok[5] = 99, 0   # an orphan
    if seed % 4 == 2:
        rc[7], rk[7] = 99, 0   # a dangling right
    return {
        "client": clients.astype(np.int64), "clock": clocks,
        "parent_is_root": np.ones(n, bool),
        "parent_a": lst.astype(np.int64), "parent_b": np.full(n, -1),
        "key_id": np.full(n, -1, np.int64),
        "origin_client": oc, "origin_clock": ok,
        "right_client": rc, "right_clock": rk, "valid": np.ones(n, bool),
    }


@pytest.mark.parametrize("seed", range(12))
def test_random_forests_stage_as_the_loop_did(compared, seed):
    assert staging.stage(_random_cols(seed)) is not None
    assert len(compared) == 1


def _random_group(rng, k, cycle=False):
    """One origin group in (client, clock) order as CSR columns: ids,
    raw clients and clocks, right keys (-1 none) and anchors."""
    client = np.sort(rng.integers(1, 6, k))
    clock = np.zeros(k, np.int64)
    for c in np.unique(client):
        at = np.flatnonzero(client == c)
        clock[at] = np.sort(rng.choice(50, len(at), replace=False))
    ids = (client << 8) | clock
    anchor = np.where(rng.random(k) < 0.5, rng.integers(0, k, k), -1)
    if cycle and k > 1:
        anchor[0], anchor[1] = 1, 0
    # rights outside the group: few distinct ones, so they repeat
    right = np.where(anchor >= 0, ids[np.maximum(anchor, 0)],
                     np.where(rng.random(k) < 0.5,
                              (1 << 20) + rng.integers(0, 3, k), -1))
    return ids, client, clock, right, anchor


def _simulated(ids, client, clock, right):
    sibs = [{"id": int(i), "client": int(c), "clock": int(t),
             "right": int(r) if r >= 0 else None}
            for i, c, t, r in zip(ids, client, clock, right)]
    at = {int(i): j for j, i in enumerate(ids)}
    out = np.empty(len(ids), np.int64)
    for rank, sid in enumerate(_simulate_group(sibs, set(at))):
        out[at[sid]] = rank
    return out


@pytest.mark.parametrize("seed", range(4))
def test_native_scan_orders_groups_as_the_simulation(seed):
    rng = np.random.default_rng(seed)
    groups = [_random_group(rng, int(k), cycle=i % 5 == 0)
              for i, k in enumerate(rng.integers(1, 40, 60))]
    cat = [np.concatenate(x) for x in zip(*groups)]
    offsets = np.r_[0, np.cumsum([len(g[0]) for g in groups])]
    ids, client, clock, right, anchor = cat
    got = native.conflict_ranks(offsets, client, right, anchor)
    want = np.concatenate([_simulated(*g[:4]) for g in groups])
    assert np.array_equal(got, want)
    py, path = staging._scan_ranks(offsets, ids, client, clock, right,
                                   anchor)
    assert path == "native" and np.array_equal(py, want)


def test_native_scan_of_a_long_unshift_chain():
    # 5,000 unshifts by two writers: each names the list's head as its
    # right origin, and every member shares the origin
    k = 5000
    client = np.r_[np.full(k // 2, 1), np.full(k // 2, 2)]
    clock = np.r_[np.arange(k // 2), np.arange(k // 2)]
    ids = (client << 20) | clock
    # item j (in integration order) unshifts before item j - 1
    seq = np.argsort(clock * 2 + client, kind="stable")
    anchor = np.full(k, -1, np.int64)
    anchor[seq[1:]] = seq[:-1]
    right = np.where(anchor >= 0, ids[np.maximum(anchor, 0)], -1)
    got = native.conflict_ranks(np.r_[0, k], client, right, anchor)
    assert np.array_equal(got, _simulated(ids, client, clock, right))
    assert np.array_equal(np.argsort(got)[::-1], seq)


def test_native_scan_refuses_malformed_groups():
    one = np.zeros(1, np.int64)
    with pytest.raises(ValueError):
        native.conflict_ranks(np.r_[0, 2], one, one, one)
    with pytest.raises(ValueError):
        native.conflict_ranks(np.r_[0, 1], one, one, np.r_[1])
