"""The swarm's anti-entropy cell: the generator's determinism and
causal cuts, the kernels' work counts, the cell driven for a moment
against the port on the CPU, the control and the timed-path faults (not
correct), and each of its metric files read from a synthetic readings
dict."""

import time

import numpy as np
import pytest

from benchmark import run
from benchmark.drivers import replay
from benchmark.gen import swarm
from benchmark.harness import cell as cells
from benchmark.harness import device, fleet_counts
from benchmark.reference import controls_swarm
from benchmark.reference import swarm as ref_swarm
from benchmark.tests import test_portbench_cells as base
from benchmark.tests.test_portbench_harness import _imports

ROOT = run.ROOT
METRICS = f"{ROOT}/benchmark/metrics"
SMALL = {
    "swarm_1k.anti_entropy": {"config": {"peers": 16, "ops_per_peer": 20,
                                         "fanout": 4, "prefix_max": 20}},
}
CELLS = sorted(SMALL)
SWARM_METRICS = [
    "swarm.decode_ms", "swarm.decode_parse_ms", "swarm.decode_dedup_ms",
    "swarm.load_ms", "swarm.step_ms", "swarm.plan_ms", "swarm.assemble_ms",
    "swarm.pad_pct", "sv_deficit_roofline.swarm", "ds_mask_roofline.swarm",
    "device.idle_pct.swarm"]


def _run(cell, trace=False, program=None, seed=20260101):
    return run.run_cell(ROOT, cell, seed, 1.5, trace, "cpu",
                        overrides=SMALL[cell], program=program,
                        t_start=time.perf_counter())


def test_generator_is_byte_deterministic_per_seed():
    a, b = swarm.build(12, 30, 3, 30, 2**40 + 3), \
        swarm.build(12, 30, 3, 30, 2**40 + 3)
    c = swarm.build(12, 30, 3, 30, 2**40 + 4)
    assert a[0] == b[0] and a[0] != c[0]
    for k in ("peer", "row", "held"):
        assert np.array_equal(a[3][k], b[3][k])


@pytest.mark.parametrize("seed", [0, 2**33 + 1])
def test_every_view_is_a_causal_cut(seed):
    from crdt_tpu_torch.codec import v1

    P, K = 12, 30
    blobs, t, ds, views, info = swarm.build(P, K, 3, K, seed)
    held = views["held"]
    assert (np.diag(held) == K).all()
    assert ((held > 0).sum(axis=1) <= 4).all() and held.max() <= K
    for p, blob in enumerate(blobs):
        recs, dset = v1.decode_update(blob)
        got = {}
        for r in recs:
            got.setdefault(r.client, []).append(r.clock)
        # each writer's first held[p, w] ops, nothing else
        want = {w + 1: list(range(held[p, w])) for w in range(P)
                if held[p, w]}
        assert {c: sorted(k) for c, k in got.items()} == want
        for c, clock, n in dset.iter_all():
            assert clock + n <= held[p, c - 1]
        # every origin lies inside the view
        for r in recs:
            if r.origin is not None:
                assert r.origin[1] < held[p, r.origin[0] - 1]
    # the views' union is the whole document, most rows redelivered
    assert len(set(views["row"].tolist())) == info["ops"] == P * K


def test_kernel_work_against_hand_counts():
    # R = 1000, C = 1002: M over 500,500 pairs at 3/2 an op a term,
    # 1,002,000 row-sum adds, 1,000,000 subtractions
    assert fleet_counts.sv_deficit_ops(1000, 1002) == \
        500_500 * 1002 * 3 // 2 + 1_002_000 + 1_000_000
    assert fleet_counts.sv_deficit_ops(1000, 1002) / \
        fleet_counts.INT32_OPS_PER_S == pytest.approx(0.04509e-3, rel=1e-3)
    assert fleet_counts.ds_mask_bytes(2_048_000, 131_072) == \
        2_048_000 * (4 + 8 + 1 + 1) + 131_072 * 24
    assert fleet_counts.ds_mask_bytes(2_048_000, 131_072) / \
        device.HBM_BYTES_PER_S == pytest.approx(0.0095e-3, rel=1e-2)


def test_deficit_work_sums_launches_of_any_shape():
    # two launches of different shapes, counted call by call, and no
    # other layer's span needed
    shapes = [(1000, 1002), (17, 5)]
    counters = {
        "sv_deficit.cells": sum(r * r * c for r, c in shapes),
        "sv_deficit.entries": sum(r * c for r, c in shapes),
        "sv_deficit.pairs": sum(r * r for r, _ in shapes)}
    want = sum(fleet_counts.sv_deficit_ops(r, c) for r, c in shapes)
    assert fleet_counts.sv_deficit_s(counters) * \
        fleet_counts.INT32_OPS_PER_S == pytest.approx(want, abs=len(shapes))
    r = _readings()
    del r["spans"]["fleet.step"]
    assert cells.reader("sv_deficit_roofline.swarm", METRICS)(r) == \
        pytest.approx(100 * 2 * 0.045091869e-3 / 1.02e-4, rel=1e-4)


@pytest.mark.parametrize("seed", [20260101, 2**31 + 77])
@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_cpu(cell, trace, seed):
    res = _run(cell, trace, seed=seed)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    names = set(res["metrics"])
    if trace:
        want = {m["name"] for m in cells.load(ROOT, cell).per_layer}
        # every metric but the card's readings gives a value on the CPU
        assert names == want - {"sv_deficit_roofline.swarm",
                                "ds_mask_roofline.swarm",
                                "device.idle_pct.swarm"}
    else:
        assert names == {"converge_ops_per_s", "setup_s"}


def test_the_swarm_control_fails_on_the_plan_alone():
    res = _run("swarm_1k.anti_entropy", program=controls_swarm.swarm,
               seed=31)
    assert not res["correct"], res["checks"]
    checks = res["checks"]
    assert checks["plan_entries_differing"][0] > 0
    assert checks["doc_entries_differing"][0] == 0
    assert checks["snapshot_bytes_differing"][0] == 0


def _swarm_fault(kind):
    if kind in ("unchanged", "half"):
        return base._replay_fault(kind)

    def make(drv):
        real = replay.port(drv)

        def faulty(blobs):
            res = real(blobs)
            if kind == "altered":
                return res._replace(cache=base._altered(res.cache))
            p = res.plan  # a dropped plan row
            return res._replace(plan=p._replace(peer_sv=p.peer_sv[:-1],
                                                deficit=p.deficit[:-1]))
        return faulty
    return make


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered",
                                  "dropped_plan_row"])
def test_a_fault_in_the_timed_path_comes_out_not_correct(kind):
    res = _run("swarm_1k.anti_entropy", program=_swarm_fault(kind))
    assert not res["correct"], res["checks"]


def test_a_program_without_the_plan_fails_at_set_up():
    def planless(drv):
        real = replay.port(drv)
        return lambda blobs: real(blobs)._replace(plan=None)

    with pytest.raises(SystemExit, match="no anti-entropy plan"):
        _run("swarm_1k.anti_entropy", program=planless)


@pytest.mark.parametrize("name", [
    "reference/swarm.py", "reference/controls_swarm.py", "gen/swarm.py",
    "harness/fleet_counts.py"])
def test_the_new_yardstick_imports_nothing_of_the_program(name):
    top = set(_imports(f"{ROOT}/benchmark/{name}"))
    assert not top & {"crdt_tpu_torch", "crdt_tpu", "jax", "jaxlib"}


def _readings(counters=None, spans=None):
    win = device.Window([
        ("(anonymous namespace)::sv_deficit_tile(long long const*)",
         0.0, 1e-4),
        ("(anonymous namespace)::row_sums(long long const*)", 0.1, 0.1 + 2e-6),
        ("(anonymous namespace)::ds_search(int const*)", 0.2, 0.2 + 5e-5),
        ("(anonymous namespace)::run_max_scan(long long const*)",
         0.3, 0.3 + 5e-5),
        ("memcpy", 0.5, 0.75)], 0.0, 1.0)
    spans = spans or {n: {"count": 2, "total_s": s} for n, s in (
        ("decode", 0.4), ("decode.parse", 0.3), ("decode.dedup", 0.1),
        ("fleet.load", 1.0), ("fleet.step", 0.6),
        ("fleet.plan", 0.002), ("gather", 0.1), ("materialize", 0.2),
        ("compact", 0.1))}
    c = {"fleet.slots": 4000, "fleet.ops_converged": 1800,
         "sv_deficit.rows": 2000, "sv_deficit.clients": 2004,
         "sv_deficit.cells": 2 * 1000 * 1000 * 1002,
         "sv_deficit.entries": 2 * 1000 * 1002,
         "sv_deficit.pairs": 2 * 1000 * 1000,
         "ds_mask.items": 4_096_000, "ds_mask.ranges": 262_144}
    return {"spans": spans, "timeline": [], "window": win,
            "counts": {"replays": 2},
            "counters": c if counters is None else counters, "calls": {}}


@pytest.mark.parametrize("name,want", [
    ("swarm.decode_ms", 200.0), ("swarm.decode_parse_ms", 150.0),
    ("swarm.decode_dedup_ms", 50.0), ("swarm.load_ms", 500.0),
    ("swarm.step_ms", 300.0), ("swarm.plan_ms", 1.0),
    ("swarm.assemble_ms", 200.0), ("swarm.pad_pct", 55.0),
    # two launches of 0.0451 ms of work in 0.102 ms of device time
    ("sv_deficit_roofline.swarm", 100 * 2 * 0.045091869e-3 / 1.02e-4),
    # two launches of 0.0095 ms of work in 0.1 ms
    ("ds_mask_roofline.swarm", 100 * 2 * 0.0094978e-3 / 1e-4),
    ("device.idle_pct.swarm", 74.9798)])
def test_each_new_metric_reads_its_value(name, want):
    read = cells.reader(name, METRICS)
    assert read(_readings()) == pytest.approx(want, rel=1e-4)


@pytest.mark.parametrize("name", [
    "swarm.plan_ms", "swarm.pad_pct", "sv_deficit_roofline.swarm",
    "ds_mask_roofline.swarm"])
def test_a_metric_the_parent_cannot_give_reads_none(name):
    # a program without the span or the counters: nothing, no raise
    r = _readings(counters={})
    del r["spans"]["fleet.plan"]
    assert cells.reader(name, METRICS)(r) is None


@pytest.mark.parametrize("name", SWARM_METRICS)
def test_each_metric_reads_none_from_an_empty_window(name):
    # a window in which no round ended and nothing ran: nothing, no raise
    r = {"spans": {}, "timeline": [], "window": device.Window([], 0.0, 1.0),
         "counts": {"replays": 0}, "counters": {}, "calls": {}}
    assert cells.reader(name, METRICS)(r) is None


def test_every_metric_of_the_cell_is_tested_here():
    listed = {m["name"] for m in cells.load(
        ROOT, "swarm_1k.anti_entropy").per_layer}
    assert set(SWARM_METRICS) <= listed


def test_the_control_plan_sends_nothing():
    class Drv:
        pass

    drv = Drv()
    drv.blobs, drv.table, drv.ds, drv.views, info = swarm.build(
        8, 10, 3, 10, 4)
    drv.peers, drv.n_ops = 8, info["rows"]
    res = controls_swarm.swarm(drv)(drv.blobs)
    assert (res.plan.deficit == 0).all()
    want = ref_swarm.plan(drv.table, drv.views, 8)
    assert ref_swarm.plan_diff(res.plan, want) > 0
    assert ref_swarm.plan_diff(want, want) == 0
    assert ref_swarm.plan_diff(None, want) == 8 * 8 + 8 * 8 + 8
