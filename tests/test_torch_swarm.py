"""A swarm's anti-entropy round on the fleet route, on the CPU.

``replay_trace(route="fleet")`` over per-peer views that overlap (each
peer holds its own writes and prefixes of other peers' broadcasts, so
most rows are redeliveries) returns the round's plan beside the cache
and snapshot. Held against the benchmark's plain reference
(``benchmark/reference/swarm.py`` for the plan, ``reference/yjs.py``
and ``gen/wire.py`` for the document), against ``crdt_tpu``'s
``FleetStep`` on the same blobs mapped to client ids, and against the
device route's cache and snapshot.
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
from crdt_tpu_torch.models import fleet
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
