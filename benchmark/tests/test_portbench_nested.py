"""The nested-array workspace and the uniform server cell: the
generator's determinism and bytes against the port's encoder, both
cells driven for a moment against the port on the CPU, their controls
and the timed-path faults (not correct), and each new metric file read
from a synthetic readings dict."""

import time

import numpy as np
import pytest

from benchmark import run
from benchmark.gen import nested
from benchmark.harness import cell as cells
from benchmark.harness import device
from benchmark.reference import controls_nested, yata
from benchmark.tests import test_portbench_cells as base

ROOT = run.ROOT
MIX = {"insert": 0.5, "push": 0.3, "unshift": 0.1, "cut": 0.1}
SMALL = {
    "nested_64.edit_replay": {"config": {"writers": 8, "arrays": 16,
                                         "edits_per_writer": 300,
                                         "sync_every": 50}},
    "tenants_1k.uniform": {"config": {"recordcount": 60},
                           "mix": {"rate": 80, "check_reads": 30}},
}
CELLS = sorted(SMALL)


def _nested_fault(kind):
    if kind != "altered":
        return base._replay_fault(kind)

    def make(drv):
        real = base.replay.port(drv)

        def altered(blobs):
            res = real(blobs)
            ws = {k: list(v) for k, v in res.cache["ws"].items()}
            k = next(k for k in sorted(ws) if ws[k])
            ws[k][0] += "!"
            return base._Replayed(res, dict(res.cache, ws=ws))
        return altered
    return make


FAULTS = {
    "nested_64.edit_replay": _nested_fault,
    "tenants_1k.uniform": lambda k: (lambda drv: base._ServerFault(drv, k)),
}


def _build(seed, writers=6, arrays=8, edits=120, sync=30):
    return nested.build(writers, arrays, edits, sync, 0.99, MIX, 6, 32, seed)


def test_generator_is_byte_deterministic_per_seed():
    a, b, c = _build(2**40 + 3), _build(2**40 + 3), _build(2**40 + 4)
    assert a[0] == b[0] and a[0] != c[0]
    for k in a[1]:
        if k not in ("roots", "keys"):
            assert np.array_equal(a[1][k], b[1][k]), k
    assert all(np.array_equal(x, y) for x, y in zip(a[2], b[2]))


def _records(t, rows):
    from crdt_tpu_torch.core.records import ItemRecord
    from crdt_tpu_torch.core.store import K_ANY, K_TYPE

    out = []
    for r in rows:
        def pair(c, k):
            return (int(t[c][r]), int(t[k][r])) if t[c][r] >= 0 else None
        is_type = t["type_ref"][r] >= 0
        out.append(ItemRecord(
            client=int(t["client"][r]), clock=int(t["clock"][r]),
            parent_root=t["roots"][t["root"][r]] if t["root"][r] >= 0
            else None,
            parent_item=pair("pc", "pk"),
            key=t["keys"][t["key"][r]] if t["key"][r] >= 0 else None,
            origin=pair("oc", "ok"), right=pair("rc", "rk"),
            kind=K_TYPE if is_type else K_ANY,
            type_ref=int(t["type_ref"][r]),
            content=None if is_type else bytes(t["text"][r]).decode()))
    return out


def _delete_set(client, clock):
    from crdt_tpu_torch.core.ids import DeleteSet

    ds = DeleteSet()
    for c, k in zip(np.asarray(client).tolist(), np.asarray(clock).tolist()):
        ds.add(c, k)
    return ds


@pytest.mark.parametrize("seed", [0, 7, 2**33 + 1])
def test_encoder_equals_the_ports_encoder_byte_for_byte(seed):
    from crdt_tpu_torch.codec import v1

    blobs, t, ds, info = _build(seed)
    assert info["right_bearing"] > 0 and info["deleted"] > 0
    bounds = np.r_[0, np.cumsum([len(v1.decode_update(b)[0])
                                 for b in blobs])]
    assert bounds[-1] == len(t["client"])
    for g, blob in enumerate(blobs):
        rows = range(bounds[g], bounds[g + 1])
        _, dset = v1.decode_update(blob)
        assert v1.encode_update(_records(t, rows), dset) == blob
    whole = _delete_set(ds[0], ds[1])
    assert v1.encode_update(_records(t, range(len(t["client"]))), whole) \
        == nested.encode_union(t, *ds)


def test_a_write_is_yjs_typelist_insert_shaped():
    _, t, ds, _ = _build(5)
    vals = t["type_ref"] < 0
    # every value hangs under an array's own item, never under a root
    assert (t["root"][vals] == -1).all() and (t["pc"][vals] >= 0).all()
    types = ~vals
    assert (t["oc"][types] == -1).all() and (t["rc"][types] == -1).all()
    assert sorted(t["key"][types].tolist()) == list(range(8))
    # every origin lies in its row's own array (segments() raises where
    # one does not)
    seg, orow, rrow = yata.segments(t)
    assert (orow[vals] >= 0).any() and (rrow[vals] >= 0).any()


def _run(cell, trace=False, program=None, seed=20260101):
    return run.run_cell(ROOT, cell, seed, 1.5, trace, "cpu",
                        overrides=SMALL[cell], program=program,
                        t_start=time.perf_counter())


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_cpu(cell, trace):
    res = _run(cell, trace)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    names = set(res["metrics"])
    if trace:
        c = cells.load(ROOT, cell)
        want = {m["name"] for m in c.per_layer}
        if cell.startswith("nested"):
            # every metric of the cell but the card's readings gives a
            # value on the CPU
            assert names == want - {"seg_argmax_scan_roofline.nested",
                                    "device.idle_pct.nested"}
            counters = res["_detail"]["counters"]
            assert counters["rights.rows"] == \
                res["_detail"]["trace"]["right_bearing"] * \
                res["_detail"]["replay_s"]["n"]
        assert names and all(not n.endswith("_s") for n in names)
    else:
        assert "setup_s" in names and len(names) >= 2


@pytest.mark.parametrize("cell", CELLS)
def test_control_comes_out_not_correct(cell):
    c = cells.load(ROOT, cell)
    res = _run(cell, program=controls_nested.CONTROLS[c.mix["driver"]],
               seed=31)
    assert not res["correct"], res["checks"]


def test_the_edits_control_fails_on_the_document_alone():
    res = _run("nested_64.edit_replay", program=controls_nested.edits,
               seed=32)
    checks = res["checks"]
    assert checks["doc_entries_differing"][0] > 0
    assert checks["snapshot_bytes_differing"][0] == 0


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_in_the_timed_path_comes_out_not_correct(cell, kind):
    res = _run(cell, program=FAULTS[cell](kind))
    assert not res["correct"], res["checks"]


def test_uniform_reads_spread_over_every_acknowledged_record():
    from benchmark.drivers import server_uniform

    c = cells.load(ROOT, "tenants_1k.uniform")
    config = dict(c.config, recordcount=60)
    drv = server_uniform.Driver(config, dict(c.mix, rate=80), 9, "cpu", 2.0)
    drv.newest = 99
    got = [drv._target(i) for i in range(len(drv.due))]
    assert min(got) == 0 and max(got) == 99
    # no recency skew: the newest tenth draws about a tenth of reads
    assert 0.05 < np.mean(np.asarray(got) >= 90) < 0.15


def _readings():
    win = device.Window([("scan_tiles(...)", 0.0, 1e-5),
                         ("memcpy", 0.5, 0.75)], 0.0, 1.0)
    spans = {n: {"count": 2, "total_s": s} for n, s in (
        ("decode", 0.4), ("pack", 1.0), ("pack.rights", 0.6),
        ("pack.rights.scan", 0.5), ("converge.dispatch", 0.02),
        ("converge.fetch", 0.01), ("gather", 0.1), ("materialize", 0.2),
        ("compact", 0.1))}
    return {"spans": spans, "timeline": [], "window": win,
            "counts": {"replays": 2},
            "counters": {"rights.rows": 400, "rights.hard_rows": 10},
            "calls": {"seg_argmax_scan": {"calls": 2, "bytes": 3350000}}}


@pytest.mark.parametrize("name,want", [
    ("nested.decode_ms", 200.0), ("nested.stage_ms", 500.0),
    ("nested.rights_ms", 300.0), ("nested.rights_scan_ms", 250.0),
    ("nested.converge_ms", 15.0), ("nested.assemble_ms", 200.0),
    ("nested.hard_rows_pct", 2.5),
    ("seg_argmax_scan_roofline.nested", 10.0),
    ("device.idle_pct.nested", 74.999)])
def test_each_new_metric_reads_its_value(name, want):
    read = cells.reader(name, f"{ROOT}/benchmark/metrics")
    assert read(_readings()) == pytest.approx(want)


@pytest.mark.parametrize("name", ["nested.rights_scan_ms",
                                  "nested.hard_rows_pct"])
def test_a_metric_the_parent_cannot_give_reads_none(name):
    # a program without the span or the counters: nothing, no raise
    r = _readings()
    del r["spans"]["pack.rights.scan"]
    r["counters"] = {}
    assert cells.reader(name, f"{ROOT}/benchmark/metrics")(r) is None


def test_hard_rows_pct_reads_zero_where_none_went_hard():
    r = _readings()
    r["counters"] = {"rights.rows": 400}
    read = cells.reader("nested.hard_rows_pct", f"{ROOT}/benchmark/metrics")
    assert read(r) == 0.0
