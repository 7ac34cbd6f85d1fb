"""A swarm's anti-entropy round on the fleet route, on the CPU.

``replay_trace(route="fleet")`` over per-peer views that overlap (each
peer holds its own writes and prefixes of other peers' broadcasts, so
most rows are redeliveries) returns the round's plan beside the cache
and snapshot. Held against the benchmark's plain reference
(``benchmark/reference/swarm.py`` for the plan, ``reference/yjs.py``
and ``gen/wire.py`` for the document), against ``crdt_tpu``'s
``FleetStep`` on the same blobs mapped to client ids, and against the
device route's cache and snapshot. ``load_trace``, which takes each
peer's rows from the union's one parse, is held against ``crdt_tpu``'s
(which decodes every blob again alone) field by field.
"""

import numpy as np
import pytest

from benchmark.gen import swarm as gen_swarm
from benchmark.gen import traces as gen_traces
from benchmark.gen import wire
from benchmark.reference import swarm as ref_plan
from benchmark.reference import yjs
from crdt_tpu.models import fleet as ref_fleet
from crdt_tpu.parallel import gossip as ref_gossip
from crdt_tpu_torch import replay_trace
from crdt_tpu_torch.codec import native, v1
from crdt_tpu_torch.core.ids import DeleteSet
from crdt_tpu_torch.models import fleet, replay
from crdt_tpu_torch.obs import Tracer, set_tracer


def _swarm(seed, peers=16, ops=20, fanout=4):
    return gen_swarm.build(peers, ops, fanout, ops, seed=seed)


def _held_blobs(held, ops=12, seed=3):
    """Blobs of peers holding ``held[p, w]`` of writer w's first ops."""
    _, t, ds = gen_traces.build_trace(held.shape[1], ops, seed=seed)
    blobs, peer, row = gen_swarm.encode_views(t, ds, held, ops)
    return blobs, t, ds, {"peer": peer, "row": row}


def _assert_round(blobs, t, ds, views):
    got = replay_trace(blobs, route="fleet", device="cpu")
    want = ref_plan.plan(t, views, len(blobs))
    assert ref_plan.plan_diff(got.plan, want) == 0
    assert yjs.cache_diff(got.cache, yjs.converge(t, ds)) == 0
    assert got.snapshot == wire.encode_union(t, *ds)
    dev = replay_trace(blobs, device="cpu")
    assert got.cache == dev.cache and got.snapshot == dev.snapshot
    assert got.n_ops == len(views["row"])
    return got


@pytest.mark.parametrize("seed", [0, 17, 2**40 + 5])
def test_round_equals_the_plain_reference(seed):
    blobs, t, ds, views, info = _swarm(seed)
    assert info["rows"] > info["ops"]  # redeliveries
    got = _assert_round(blobs, t, ds, views)
    assert got.path == "fleet"
    assert got.plan.deficit.shape == (16, 16)
    assert (np.diag(got.plan.deficit) == 0).all()


@pytest.mark.parametrize("seed", [1, 2])
def test_plan_equals_the_reference_packages_fleet_step(seed):
    blobs = _swarm(seed)[0]
    got = replay_trace(blobs, route="fleet", device="cpu").plan
    tr = ref_fleet.load_trace(blobs)
    step = ref_fleet.fleet_for_trace(
        tr, mesh=ref_gossip.make_mesh(1)).step(tr.cols, tr.dels)
    c = len(tr.clients)
    sv = np.asarray(step.sv_local)
    assert (got.clients == tr.clients).all()
    assert (got.peer_sv == sv[:len(blobs), 1:c + 1]).all()
    assert (got.swarm_sv == np.asarray(step.global_sv)[1:c + 1]).all()
    assert (got.deficit == np.asarray(step.deficit)).all()


def test_overlapping_and_duplicated_views():
    P, K = 6, 12
    held = np.zeros((P, P), np.int64)
    held[np.arange(P), np.arange(P)] = K
    held[1] = held[2] = [5, 9, 7, 0, 3, K]  # overlapping views
    held[1, 1] = held[2, 2] = K             # each with all its own
    held[0, 0] = 0                          # holds nothing of its own
    held[0, 3:] = [K, 4, K]
    held[4] = 0                             # holds nothing at all
    blobs, t, ds, views = _held_blobs(held, K)
    # writer 4's ops reach the union only through the others' views
    held_any = held.max(axis=0)
    rows = np.flatnonzero(t["clock"] < held_any[t["client"] - 1])
    sub = wire.take(t, rows)
    keep = ds[1] < held_any[ds[0] - 1]
    sub_ds = tuple(x[keep] for x in ds)
    views = {"peer": views["peer"], "row": np.searchsorted(rows,
                                                           views["row"])}
    got = _assert_round(blobs, sub, sub_ds, views)
    assert got.plan.vector(4) == {}
    assert got.plan.vector(0) == {6: K, 5: 4, 4: K}
    # peers 1 and 2 differ only in each other's writes
    assert got.plan.deficit[1, 2] == K - 9 and got.plan.deficit[2, 1] == \
        K - 7
    assert (got.plan.deficit[:, 4] == got.plan.peer_sv.sum(axis=1)).all()


def test_the_same_blob_twice():
    blobs = _swarm(4, peers=5, ops=10, fanout=2)[0]
    dup = blobs + [blobs[3]]
    got = replay_trace(dup, route="fleet", device="cpu")
    assert (got.plan.peer_sv[5] == got.plan.peer_sv[3]).all()
    assert got.plan.deficit[3, 5] == got.plan.deficit[5, 3] == 0
    assert got.cache == replay_trace(blobs, route="fleet",
                                     device="cpu").cache


def test_no_plan_off_the_replicated_mapping():
    blobs = _swarm(5, peers=6, ops=10, fanout=2)[0]
    assert replay_trace(blobs, device="cpu").plan is None
    from crdt_tpu_torch.parallel.gossip import make_mesh

    res = fleet.fleet_replay(blobs, mesh=make_mesh(2, device="cpu"),
                             shard="segments")
    assert res.plan is None
    empty = replay_trace([], route="fleet", device="cpu").plan
    assert empty.clients.size == 0 and empty.deficit.shape == (0, 0)


def test_the_round_counts_its_layout_and_kernel_operands():
    blobs, *_, info = _swarm(6)
    tr = set_tracer(Tracer(enabled=True))
    try:
        replay_trace(blobs, route="fleet", device="cpu")
        rep = tr.report()
    finally:
        set_tracer(Tracer(enabled=False))
    c = rep["counters"]
    R, N = 16, fleet.bucket_pow2(info["largest_peer"])
    assert c["fleet.slots"] == R * N
    assert c["fleet.ops_converged"] == info["rows"]
    assert c["fleet.redelivered"] == info["rows"] - info["ops"]
    C = info["peers"] + 2
    assert (c["sv_deficit.rows"], c["sv_deficit.clients"],
            c["sv_deficit.cells"], c["sv_deficit.entries"],
            c["sv_deficit.pairs"]) == (R, C, R * R * C, R * C, R * R)
    assert c["ds_mask.items"] == R * N and c["ds_mask.ranges"] >= 16
    assert {"fleet.load", "fleet.step", "fleet.plan"} <= set(rep["spans"])


# --- load_trace takes each peer's rows from the union's one parse ------

EMPTY = v1.encode_update([], DeleteSet())


def _repeating(blob):
    """``blob`` with its client sections written twice, so that it holds
    each of its ids twice."""
    _, ds = v1.decode_update(blob)
    tail = v1.encode_update([], ds)[1:]
    assert blob.endswith(tail) and blob[0] < 64
    sections = blob[1:len(blob) - len(tail)]
    return bytes([2 * blob[0]]) + sections + sections + tail


def _delete_only(blob):
    """A blob of ``blob``'s delete set and no structs."""
    _, ds = v1.decode_update(blob)
    assert any(True for _ in ds.iter_all())
    return v1.encode_update([], ds)


def _views(seed):
    return gen_swarm.build(40, 20, 8, 20, seed=seed)[0]


LOAD_CASES = {
    "views_seed11": lambda: (_views(11), {}),
    "views_seed2p40": lambda: (_views(2**40 + 9), {}),
    "the_same_blob_twice": lambda: (_views(12) + [_views(12)[5]], {}),
    "an_id_twice_in_one_blob": lambda: (
        _views(13)[:4] + [_repeating(_views(13)[4])] + _views(13)[4:], {}),
    "an_empty_blob": lambda: (_views(14)[:7] + [EMPTY] + _views(14)[7:],
                              {}),
    "a_delete_only_blob": lambda: (
        _views(15) + [_delete_only(_views(15)[0])], {}),
    "replicas_multiple_4": lambda: (_views(16)[:37],
                                    {"replicas_multiple": 4}),
    "pinned_ops_bucket": lambda: (_views(17), {"ops_bucket": 4096}),
}


def _assert_same_trace(got, want):
    assert set(got.cols) == set(want.cols)
    for k, v in want.cols.items():
        assert got.cols[k].dtype == v.dtype and (got.cols[k] == v).all(), k
    for g, w in zip(got.dels, want.dels):
        assert g.dtype == w.dtype and (g == w).all()
    assert got.row_map.shape == want.row_map.shape
    assert (got.row_map == want.row_map).all()
    assert (got.clients == want.clients).all()
    assert (got.num_clients, got.num_segments, got.n_ops) == \
        (want.num_clients, want.num_segments, want.n_ops)


def _traced(fn):
    tr = set_tracer(Tracer(enabled=True))
    try:
        out = fn()
    finally:
        set_tracer(Tracer(enabled=False))
    return out, tr.report()["counters"]


@pytest.mark.parametrize("case", sorted(LOAD_CASES) + ["ops_bucket_too_small"])
def test_load_trace_from_the_parse_equals_the_reference(case):
    if case == "ops_bucket_too_small":
        blobs = _views(18)
        with pytest.raises(ValueError, match="ops_bucket"):
            fleet.load_trace(blobs, ops_bucket=4)
        with pytest.raises(ValueError, match="ops_bucket"):
            ref_fleet.load_trace(blobs, ops_bucket=4)
        return
    blobs, kw = LOAD_CASES[case]()
    got, c = _traced(lambda: fleet.load_trace(blobs, **kw))
    _assert_same_trace(got, ref_fleet.load_trace(blobs, **kw))
    # the reference's n_ops counts every blob's rows, decoded alone
    assert c["fleet.redelivered"] == \
        got.n_ops - len(replay.decode(blobs)["client"])


@pytest.mark.parametrize("other", ["without_blob_rows", "of_fewer_blobs",
                                   "of_other_blobs"])
def test_load_trace_refuses_a_union_not_of_its_blobs(other):
    blobs = LOAD_CASES["an_id_twice_in_one_blob"]()[0]
    dec = {
        "without_blob_rows": lambda: {
            k: v for k, v in replay.decode(blobs).items()
            if k != "blob_rows"},
        "of_fewer_blobs": lambda: replay.decode(blobs[:-1]),
        "of_other_blobs": lambda: replay.decode(_views(20)[:len(blobs)]),
    }[other]()
    with pytest.raises(ValueError, match="not the union"):
        fleet.load_trace(blobs, dec=dec)


def test_a_round_parses_its_blobs_once(monkeypatch):
    blobs, *_, info = _swarm(19)
    parse = native.decode_updates_columns_any
    calls = []

    def counted(b):
        calls.append(len(b))
        return parse(b)

    monkeypatch.setattr(native, "decode_updates_columns_any", counted)
    res = replay_trace(blobs, route="fleet", device="cpu")
    assert calls == [len(blobs)]
    assert res.plan is not None and res.n_ops == info["rows"]
