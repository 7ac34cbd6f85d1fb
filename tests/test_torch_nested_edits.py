"""A workspace of nested arrays under interleaved insert, push, unshift
and cut (``benchmark/gen/nested.py``): the port's replay against the
benchmark's item-by-item Yjs reference (``benchmark/reference/yata.py``)
and against the JAX package's replay, the reference against the scalar
left-origin integration and against hand-built concurrent inserts, and
the staging counters and spans of right origins."""

import numpy as np
import pytest

from benchmark.gen import nested, traces
from benchmark.reference import scalar, yata
from crdt_tpu_torch.codec import v1
from crdt_tpu_torch.core.records import ItemRecord
from crdt_tpu_torch.models.replay import replay_trace
from crdt_tpu_torch.obs.tracer import Tracer, get_tracer, set_tracer

MIX = {"insert": 0.5, "push": 0.3, "unshift": 0.1, "cut": 0.1}


def _workspace(seed):
    return nested.build(8, 16, 300, 50, 0.99, MIX, 6, 32, seed)


@pytest.fixture
def tracer():
    old = get_tracer()
    tr = set_tracer(Tracer(enabled=True))
    yield tr
    set_tracer(old)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_replay_equals_the_reference_on_every_route(seed):
    from crdt_tpu.models.replay import replay_trace as jax_replay

    blobs, t, ds, info = _workspace(seed)
    assert info["right_bearing"] > 0 and info["deleted"] > 0
    want = yata.converge(t, ds)
    snap = nested.encode_union(t, *ds)
    assert sorted(want["ws"]) == sorted(f"a{k}" for k in range(16))
    for route in ("device", "host"):
        res = replay_trace(blobs, route=route, device="cpu")
        assert yata.cache_diff(res.cache, want) == 0, route
        assert res.cache == want and res.snapshot == snap, route
        assert res.n_ops == info["items"]
    assert jax_replay(blobs).cache == want


@pytest.mark.parametrize("R,K,seed", [(4, 60, 0), (9, 40, 11)])
def test_reference_equals_the_scalar_integration_without_right_origins(
        R, K, seed):
    _, t, ds = traces.build_trace(R, K, seed=seed)
    assert yata.converge(t, ds) == scalar.converge(t, ds)


def _table(rows):
    """A root list ``l`` of (client, clock, value, origin, right)."""
    def ids(i):
        return [(r[i] or (-1, -1)) for r in rows]
    o, rt = np.asarray(ids(3)), np.asarray(ids(4))
    n = len(rows)
    return {
        "client": np.asarray([r[0] for r in rows]),
        "clock": np.asarray([r[1] for r in rows]),
        "root": np.zeros(n, np.int64), "key": np.full(n, -1),
        "oc": o[:, 0], "ok": o[:, 1], "rc": rt[:, 0], "rk": rt[:, 1],
        "content": np.asarray([r[2] for r in rows]),
        "roots": ["l"], "keys": [],
    }


A = (1, 0, 10, None, None)
NO_DS = (np.zeros(0, np.int64),) * 3


@pytest.mark.parametrize("order", [(0, 1, 2), (0, 2, 1)])
def test_concurrent_inserts_at_one_gap_lower_client_first(order):
    rows = [A, (3, 0, 30, (1, 0), None), (2, 0, 20, (1, 0), None)]
    t = _table([rows[i] for i in order])
    assert yata.converge(t, NO_DS) == {"l": [10, 20, 30]}


# o3 (client 1) and T (client 4) go after A concurrently; then client 7,
# seeing A o3 T, inserts o between A and o3. Integrating T against o
# (same origin, higher client, another right origin) the scan does not
# stop at o, as a left-origin-only rule would, but runs on to o3 (same
# origin, lower client) and puts T after it.
RIGHTS = [A, (1, 1, 13, (1, 0), None), (4, 0, 40, (1, 0), None),
          (7, 0, 70, (1, 0), (1, 1))]


@pytest.mark.parametrize("order", [(0, 1, 2, 3), (0, 2, 1, 3),
                                   (0, 1, 3, 2)])
def test_the_scan_passes_a_same_origin_item_of_another_right_origin(order):
    t = _table([RIGHTS[i] for i in order])
    assert yata.converge(t, NO_DS) == {"l": [10, 70, 13, 40]}
    blind = dict(t, rc=np.full(4, -1), rk=np.full(4, -1))
    assert yata.converge(blind, NO_DS) != {"l": [10, 70, 13, 40]}
    recs = [ItemRecord(client=c, clock=k, content=v, origin=o, right=r,
                       parent_root="l" if o is None and r is None else None)
            for c, k, v, o, r in (RIGHTS[i] for i in order)]
    blobs = [v1.encode_update([x]) for x in recs]
    assert replay_trace(blobs, route="device", device="cpu").cache == \
        {"l": [10, 70, 13, 40]}


def test_the_same_right_origin_ends_the_scan():
    # two items in the gap A..B, both with B as right origin: the later
    # (lower client) stops at the first, whatever the clients' order
    B = (1, 1, 11, (1, 0), None)
    rows = [A, B, (6, 0, 60, (1, 0), (1, 1)), (5, 0, 50, (1, 0), (1, 1))]
    assert yata.converge(_table(rows), NO_DS) == {"l": [10, 50, 60, 11]}
    assert yata.converge(_table([rows[i] for i in (0, 1, 3, 2)]),
                         NO_DS) == {"l": [10, 50, 60, 11]}


def test_rights_counters_and_spans_are_recorded(tracer):
    blobs, _, _, info = _workspace(5)
    replay_trace(blobs, route="device", device="cpu")
    rep = tracer.report()
    c = rep["counters"]
    assert c["rights.rows"] == info["right_bearing"] > 0
    assert c["rights.groups"] >= c["rights.scanned_groups"] > 0
    assert c["rights.hard_segments"] == c["rights.hard_rows"] == 0
    assert "pack.rights.scan" in rep["spans"] and "pack.rights" in rep["spans"]
    assert rep["spans"]["pack.rights.scan"]["total_s"] <= \
        rep["spans"]["pack.rights"]["total_s"]
    assert "gather.hard" not in rep["spans"]


def test_a_hard_segment_is_counted_and_its_reorder_spanned(tracer):
    # a right origin no update delivers: the segment goes to the host
    recs = [ItemRecord(client=c, clock=k, content=v, origin=o, right=r,
                       parent_root="l" if o is None and r is None else None)
            for c, k, v, o, r in RIGHTS + [(5, 0, 50, (1, 0), (99, 3))]]
    res = replay_trace([v1.encode_update(recs)], route="device",
                       device="cpu")
    assert res.cache == {"l": [10, 70, 13, 40]}
    rep = tracer.report()
    assert rep["counters"]["rights.hard_segments"] == 1
    assert rep["counters"]["rights.hard_rows"] == 2
    assert rep["spans"]["gather.hard"]["count"] == 1


def _walk_hits_group(rt, group, origin):
    cur, seen = rt, set()
    while cur >= 0 and cur not in seen:
        if cur in group:
            return True
        seen.add(cur)
        cur = int(origin[cur])
    return False


@pytest.mark.parametrize("seed", range(6))
def test_right_walks_answer_as_an_unbounded_walk_does(seed):
    from crdt_tpu_torch.ops import staging

    rng = np.random.default_rng(seed)
    n = 400
    seg = rng.integers(0, 3, n)
    origin = np.full(n, -1, np.int64)
    for i in range(1, n):
        r = rng.random()
        same = np.flatnonzero(seg[:i] == seg[i])
        if r < 0.75 and len(same):
            # mostly the row before in the segment: long chains
            origin[i] = same[-1] if rng.random() < 0.6 else rng.choice(same)
        elif r < 0.85:
            origin[i] = rng.integers(0, i)  # maybe another segment
    origin[[n - 2, n - 1]] = [n - 1, n - 2]  # a cycle
    seq_rows = np.flatnonzero(rng.random(n) < 0.97)
    rows_r = rng.choice(seq_rows, 150, replace=False)
    right_row = np.full(n, -1, np.int64)
    right_row[rows_r] = np.where(rng.random(150) < 0.9,
                                 rng.integers(0, n, 150), -1)
    got = staging._right_walks(rows_r, right_row, origin, seg, seq_rows)
    member = set(seq_rows.tolist())
    decided = 0
    for r, ans in zip(rows_r.tolist(), got.tolist()):
        rt = int(right_row[r])
        group = {m for m in member
                 if seg[m] == seg[r] and origin[m] == origin[r]}
        if ans < 0 or rt in group:
            continue  # left to the budgeted walk, or an in-group anchor
        decided += 1
        assert ans == _walk_hits_group(rt, group, origin), (r, rt)
    assert decided > 20
    assert (got[right_row[rows_r] < 0] == -1).all()
