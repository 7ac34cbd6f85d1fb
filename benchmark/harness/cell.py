"""Finds everything one cell needs by the names in ``BENCHMARK.json``.

A cell ``<config>.<mix>`` is an entry of ``workloads``. Its
configuration is the JSON file the ``configs`` entry names, its traffic
mix is ``benchmark/traffic/<mix>.json``, and each per-layer metric is
``benchmark/metrics/<metric name>.py``. A later cell, configuration or
metric is a new file and a new entry; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, Dict, List, NamedTuple, Optional

class Cell(NamedTuple):
    name: str
    chips: int
    config: Dict          # the configuration file's contents
    mix: Dict             # the traffic mix file's contents
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _reports(metric: Dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in e2e_names or "moves" not in metric


def load(root: str, workload: str) -> Cell:
    """The cell ``workload`` as ``root/BENCHMARK.json`` defines it."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(os.path.join(root, configs[w["config"]]["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "benchmark", "traffic",
                           w["traffic"] + ".json")) as f:
        mix = json.load(f)
    e2e = [m for m in bench["end_to_end"]
           if m.get("workloads") is None or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, workload, names)]
    return Cell(workload, int(w["chips"]), config, mix, e2e, per_layer)


def reader(name: str, metrics_dir: str
           ) -> Callable[[Dict], Optional[float]]:
    """The ``read(readings)`` function of metric ``name``'s own file in
    ``metrics_dir``. It returns the metric's value, or None where this
    run gave it nothing to read."""
    path = os.path.join(metrics_dir, name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
