"""The harness's shared arithmetic, its import check, the loader's
data-driven lookup, the byte counts, and BENCHMARK.json against the
benchmark's contract."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from benchmark import run
from benchmark.harness import cell as cells
from benchmark.harness import device, stats

ROOT = run.ROOT
BENCH = os.path.join(ROOT, "benchmark")


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_nothing_imports_jax_or_the_jax_package():
    for path in _sources():
        for top in _imports(path):
            assert top not in ("jax", "jaxlib", "flax", "crdt_tpu",
                               "bench", "chip_smoke"), (path, top)


@pytest.mark.parametrize("sub", ["reference", "gen"])
def test_the_yardstick_imports_nothing_of_the_program(sub):
    for path in _sources(sub):
        assert "crdt_tpu_torch" not in set(_imports(path)), path


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "crdt_tpu_torchx", object())
    assert run.forbidden_modules() == [] or \
        "crdt_tpu_torchx" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "crdt_tpu.models", object())
    assert "crdt_tpu" in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla", object())
    assert "jaxlib" in run.forbidden_modules()


def test_percentile_is_nearest_rank():
    v = list(range(1, 101))
    assert stats.percentile(v, 95) == 95
    assert stats.percentile(v, 50) == 50
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([5, 1, 4, 2, 3], 95) == 5


def test_latency_from_due_time_counts_a_stall():
    # requests due every 10 ms; the server stalls 500 ms at 100 ms, so
    # everything due during the stall waits for its end
    due = np.arange(100) * 0.01
    served = np.maximum(due, np.where(due >= 0.1, 0.6, 0.0)) + 0.002
    served[due > 0.6] = due[due > 0.6] + 0.002
    lat = served - due
    assert stats.percentile(lat.tolist(), 50) == pytest.approx(0.002)
    assert stats.percentile(lat.tolist(), 95) > 0.3


def test_poisson_schedule_rate_is_exact_and_seeds_permute_one_set():
    a = stats.poisson_due(120, 51, stats.rng_of(1))
    b = stats.poisson_due(120, 51, stats.rng_of(2**33 + 5))
    assert len(a) == len(b) == 6120
    assert a[0] == 0 and a[-1] < 51
    assert np.allclose(np.sort(np.diff(np.r_[a, 51])),
                       np.sort(np.diff(np.r_[b, 51])))
    assert not np.allclose(a, b)


def test_poisson_mix_gives_each_kind_one_set_of_gaps():
    a_due, a_kind = stats.poisson_mix(1000, 8, (0.95, 0, 0.05),
                                      stats.rng_of(1))
    b_due, b_kind = stats.poisson_mix(1000, 8, (0.95, 0, 0.05),
                                      stats.rng_of(2**33 + 5))
    assert (np.diff(a_due) >= 0).all() and a_due[0] == 0
    assert set(a_kind.tolist()) == {0, 2}
    for k, n in ((0, 7600), (2, 400)):
        ga = np.diff(np.r_[a_due[a_kind == k], 8])
        gb = np.diff(np.r_[b_due[b_kind == k], 8])
        assert len(ga) == len(gb) == n
        assert np.allclose(np.sort(ga), np.sort(gb))
        assert not np.allclose(ga, gb)


def test_zipf_ranks_follow_the_distribution():
    r = stats.zipf_ranks(10000, 1000, 0.99, stats.rng_of(3))
    assert r.min() >= 1 and r.max() <= 1000
    w = np.arange(1, 1001) ** -0.99
    assert abs((r == 1).mean() - w[0] / w.sum()) < 1e-3


def test_byte_counts_against_hand_counts():
    # 960,000 live scan rows: client and flags read, position written
    assert device.seg_argmax_scan_bytes(960_000) == 960_000 * (4 + 4 + 4)
    # 640,000 in-range scatter targets: target read, slot written
    assert device.stream_scatter_bytes(640_000) == 640_000 * (4 + 4)
    win = device.Window([("k", 0.0, 2e-6)], 0.0, 1.0)
    calls = {"stream_scatter": {"calls": 1, "bytes": 3350}}
    win.events = [("(anonymous namespace)::scatter(int const*, int, int*,"
                   " int)", 0.0, 2e-9)]
    assert device.roofline_pct("stream_scatter", calls, win) == \
        pytest.approx(50.0)
    assert device.roofline_pct("seg_argmax_scan", calls, win) is None


def test_window_busy_idle_and_gaps():
    w = device.Window([("a", 0.0, 0.2), ("b", 0.1, 0.3), ("c", 0.7, 0.8),
                       ("d", 1.5, 2.5)], 0.0, 2.0)
    assert w.busy_s == pytest.approx(0.3 + 0.1 + 0.5)
    gaps = w.idle_gaps([("decode", 0.25, 0.75), ("pack", 0.8, 1.6)], 2)
    assert gaps[0][0] == "pack" and gaps[0][1] == pytest.approx(0.7)
    assert gaps[1][0] == "decode" and gaps[1][1] == pytest.approx(0.4)
    assert w.top_ops(1) == [["d", pytest.approx(0.5)]]


def test_loader_finds_a_cell_config_mix_and_metric_added_as_files(tmp_path):
    root = tmp_path / "co"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    (root / "benchmark/configs/toy.json").write_text(json.dumps(
        {"writers": 4, "ops_per_writer": 30, "map_frac": 0.6}))
    (root / "benchmark/traffic/toy_mix.json").write_text(json.dumps(
        {"driver": "replay", "route": "host", "samples": 1,
         "sample_from": 2}))
    (root / "benchmark/metrics/toy.replays.py").write_text(
        "def read(r):\n    return float(r['counts']['replays'])\n")
    bench["configs"].append({"name": "toy", "source": "a test",
                             "file": "benchmark/configs/toy.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "toy.toy_mix", "config": "toy",
                               "traffic": "toy_mix", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "toy.replays", "unit": "n",
                               "better": "higher", "source": "host_clock",
                               "layer": "replay assembly",
                               "moves": "converge_ops_per_s",
                               "workloads": ["toy.toy_mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    c = cells.load(str(root), "toy.toy_mix")
    assert c.config["writers"] == 4 and c.mix["route"] == "host"
    assert [m["name"] for m in c.per_layer] == ["toy.replays"]
    read = cells.reader("toy.replays",
                        str(root / "benchmark" / "metrics"))
    assert read({"counts": {"replays": 3}}) == 3.0


def _bench():
    return json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_benchmark_json_keeps_the_contract():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and 1 <= b["run_seconds"] <= 51
    assert len(json.dumps(b)) < 64 * 1024
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert 1 <= len(c["source"]) <= 200 and len(c["why"]) <= 200
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        names.add(c["name"])
    cells_ = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in names
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert os.path.exists(os.path.join(BENCH, "traffic",
                                           w["traffic"] + ".json"))
        cells_.add(w["name"])
    e2e = {}
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        e2e[m["name"]] = set(m.get("workloads", cells_))
    assert "setup_s" in e2e
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert set(m["workloads"]) <= e2e[m["moves"]]
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))
    for w in cells_:
        assert sum(w in s for s in e2e.values()) >= 2
        assert any(w in m["workloads"] for m in b["per_layer"])


def test_run_without_a_card_fails_with_no_result():
    p = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "fanin_1k.cold_replay", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_run_without_the_program_fails_with_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "fanin_1k.cold_replay", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=tmp_path, env={k: v for k, v in os.environ.items()
                           if k != "PYTHONPATH"})
    assert p.returncode != 0 and p.stdout.strip() == ""
