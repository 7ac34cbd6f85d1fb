"""The per-layer metrics that read the program's finer spans (the cold
replay's column stage, decode parts and staging passes, and the
server's reads) and its ticks' wall time. Each reads its one span, or
the tick timeline's records, per unit of the load driver's count, and
None where the run recorded no such span, record or unit."""

import json
import os

import pytest

from benchmark import run
from benchmark.harness import cell as cells

ROOT = run.ROOT
METRICS = os.path.join(ROOT, "benchmark", "metrics")

REPLAY = ("replays", "fanin_1k.cold_replay", "converge_ops_per_s")

# metric -> (the span it reads, the load driver's count, the cell, the
# end-to-end metric it moves)
SPAN_METRICS = {
    "replay.columns_ms": ("columns",) + REPLAY,
    "replay.decode_parse_ms": ("decode.parse",) + REPLAY,
    "replay.decode_dedup_ms": ("decode.dedup",) + REPLAY,
    "replay.pack_ids_ms": ("pack.ids",) + REPLAY,
    "replay.pack_rights_ms": ("pack.rights",) + REPLAY,
    "replay.pack_split_ms": ("pack.split",) + REPLAY,
    "replay.pack_maps_ms": ("pack.maps",) + REPLAY,
    "replay.pack_siblings_ms": ("pack.siblings",) + REPLAY,
    "tenants.digest_ms": ("digest", "reads", "tenants_1k.ycsb_d",
                          "read_p95_ms"),
}
# the tick's wall time is the timeline's, no span: (None, count, cell,
# moves)
TICK = {"tenants.tick_ms": (None, "ticks", "tenants_1k.ycsb_d",
                            "apply_p95_ms")}
METRICS_ALL = {**SPAN_METRICS, **TICK}


def _readings(spans: dict, counts: dict, walls=()) -> dict:
    return {"spans": {k: {"count": n, "total_s": s}
                      for k, (n, s) in spans.items()},
            "counters": {},
            "timeline": [{"wall_s": w, "lanes": {"prepare": w / 2}}
                         for w in walls],
            "counts": counts, "window": None, "calls": {}}


@pytest.mark.parametrize("name", sorted(METRICS_ALL))
def test_reads_none_where_nothing_was_recorded(name):
    span, per, _, _ = METRICS_ALL[name]
    read = cells.reader(name, METRICS)
    assert read(_readings({}, {})) is None
    assert read(_readings({}, {per: 4})) is None
    if span is None:
        # tick records, but no tick counted
        assert read(_readings({}, {}, [0.5, 0.25])) is None
        assert read(_readings({}, {per: 0}, [0.5])) is None
        # spans are not ticks
        assert read(_readings({"tick": (2, 1.0), "pack": (1, 1.0)},
                              {per: 2})) is None
        return
    assert read(_readings({span: (3, 0.5)}, {})) is None
    assert read(_readings({span: (3, 0.5)}, {per: 0})) is None
    # another span of the same family is not this one
    assert read(_readings({span + ".other": (1, 1.0), "pack": (1, 1.0),
                           "decode": (1, 1.0)}, {per: 2})) is None


@pytest.mark.parametrize("name", sorted(METRICS_ALL))
def test_reads_milliseconds_a_unit(name):
    span, per, _, _ = METRICS_ALL[name]
    read = cells.reader(name, METRICS)
    if span is None:
        r = _readings({"tick": (7, 9.0), "pack": (2, 9.0)},
                      {per: 5, "other": 1}, [0.5, 0.75, 0.25, 0.125, 0.125])
        assert read(r) == pytest.approx(350.0)
        return
    r = _readings({span: (7, 1.75), "pack": (2, 9.0), "decode": (2, 9.0),
                   "tick.x": (1, 5.0)},
                  {per: 5, "other": 1}, [9.0])
    assert read(r) == pytest.approx(350.0)


@pytest.mark.parametrize("name", sorted(METRICS_ALL))
def test_benchmark_json_lists_the_metric_for_its_cell(name):
    _, _, cell, moves = METRICS_ALL[name]
    b = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    (m,) = [m for m in b["per_layer"] if m["name"] == name]
    assert m["source"] == "program_span" and m["unit"] == "ms"
    assert m["better"] == "lower" and m["workloads"] == [cell]
    assert m["moves"] == moves
    assert name in [x["name"] for x in cells.load(ROOT, cell).per_layer]
