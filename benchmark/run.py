"""Run one benchmark cell of the PyTorch/CUDA port on the card.

    python3 benchmark/run.py --workload <config>.<mix> --seed <n>
        --seconds <s> --trace <0|1>

Set-up (inputs and state made from the seed, every shape the cell uses
warmed once), then the measured window of ``--seconds``, then the check
of what the window produced against the plain reference, then one JSON
line on standard output. ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics from a profiled window.
Without a CUDA card it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.harness import cell as cells  # noqa: E402
from benchmark.harness import device as dev  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "crdt_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is one the
    port must never load."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def _program_from_checkout(root: str) -> None:
    import crdt_tpu_torch

    here = os.path.realpath(os.path.dirname(crdt_tpu_torch.__file__))
    if not here.startswith(os.path.realpath(root) + os.sep):
        raise SystemExit(f"crdt_tpu_torch loaded from {here}, outside the "
                         f"checkout {root}")


def span_log():
    """The program's tracer, enabled, also keeping each span's interval
    on the host clock (to name what the host did in the device's idle
    gaps). Durations the program records without a span (its SLO
    clocks, measured from a submit) keep no interval."""
    from contextlib import contextmanager

    from crdt_tpu_torch.obs.tracer import Tracer

    class SpanLog(Tracer):
        def __init__(self):
            super().__init__(enabled=True)
            self.intervals = []

        @contextmanager
        def span(self, name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                t1 = time.perf_counter()
                self.intervals.append((name, t0, t1))
                self.observe(name, t1 - t0)

    return SpanLog()


def _host_clocks():
    r = resource.getrusage(resource.RUSAGE_SELF)
    return (time.perf_counter(), time.thread_time(), r.ru_utime + r.ru_stime,
            r.ru_nivcsw, gc.get_stats())


def _host_use(a, b) -> dict:
    """How the host served the window: its wall seconds, the CPU seconds
    of the window's thread and of the whole process, the times the
    process was descheduled against its will, and the collector's
    passes of each generation (a slow run whose thread's CPU time grew
    with its wall time ran on a slower or busier core; one whose did
    not waited)."""
    return {"wall_s": b[0] - a[0], "thread_cpu_s": b[1] - a[1],
            "process_cpu_s": b[2] - a[2], "involuntary_switches": b[3] - a[3],
            "gc_passes": [y["collections"] - x["collections"]
                          for x, y in zip(a[4], b[4])]}


class _GcPauses:
    """The collector's pauses while installed in ``gc.callbacks``: their
    total and the longest, in seconds."""

    def __init__(self):
        self.t0, self.total_s, self.max_s = None, 0.0, 0.0

    def __call__(self, phase, info):
        if phase == "start":
            self.t0 = time.perf_counter()
        elif self.t0 is not None:
            d = time.perf_counter() - self.t0
            self.total_s += d
            self.max_s = max(self.max_s, d)
            self.t0 = None


def run_cell(root: str, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", *, overrides=None,
             program=None, t_start: float = None) -> dict:
    """One run of ``workload``; returns the result line's dict.
    ``device`` and ``program`` are seams for the benchmark's CPU tests
    (the card's own runs never set them); ``overrides`` replaces keys
    of the configuration and the mix, for the same tests."""
    import torch

    t_start = _T_START if t_start is None else t_start
    c = cells.load(root, workload)
    config = dict(c.config, **(overrides or {}).get("config", {}))
    mix = dict(c.mix, **(overrides or {}).get("mix", {}))
    _program_from_checkout(root)
    mod = importlib.import_module(f"benchmark.drivers.{mix['driver']}")
    drv = mod.Driver(config, mix, seed, device, seconds, program=program)
    gc.collect()
    setup_s = time.perf_counter() - t_start
    host0 = _host_clocks()
    pauses = _GcPauses()
    gc.callbacks.append(pauses)

    readings = None
    if trace:
        from crdt_tpu_torch.obs.timeline import TickTimeline, set_timeline
        from crdt_tpu_torch.obs.tracer import Tracer, set_tracer

        log = set_tracer(span_log())
        tl = set_timeline(TickTimeline(capacity=1 << 16, enabled=True))
        try:
            with dev.traced(device) as tr:
                out = drv.window()
        finally:
            set_tracer(Tracer(enabled=False))
            set_timeline(TickTimeline(enabled=False))
        rep = log.report()
        readings = {"spans": rep["spans"], "counters": rep["counters"],
                    "timeline": tl.records(), "counts": drv.counts,
                    "window": tr["window"], "calls": tr["calls"]}
        host_spans = log.intervals + getattr(drv, "phases", [])
    else:
        out = drv.window()
    host = _host_use(host0, _host_clocks())
    gc.callbacks.remove(pauses)
    host.update(gc_pause_s=pauses.total_s, gc_pause_max_s=pauses.max_s)
    left = forbidden_modules()
    if left:
        raise SystemExit(f"forbidden modules loaded: {left}")
    peak = torch.cuda.max_memory_allocated(0) if device == "cuda" else 0
    drv.release()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    checks = drv.check()
    correct = all(ch["limit"] is None or ch["value"] <= ch["limit"]
                  for ch in checks)

    metrics = {}
    if not trace:
        for m in c.end_to_end:
            v = setup_s if m["name"] == "setup_s" else out.get(m["name"])
            if v is None:
                raise SystemExit(f"the load driver gave no {m['name']}")
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in c.per_layer:
            v = cells.reader(m["name"], os.path.join(
                root, "benchmark", "metrics"))(readings)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    devinfo = {"platform": "gpu" if device == "cuda" else device,
               "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                        else "cpu"),
               "count": c.chips, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": devinfo}
    detail = {"cell": workload, "seed": seed, "setup_s": setup_s,
              "host": host, **out.get("extra", {}),
              **getattr(drv, "detail", {})}
    if trace:
        win = readings["window"]
        devinfo["busy_s"] = win.busy_s
        devinfo["window_s"] = win.window_s
        result["breakdown"] = {"device_ops": win.top_ops(10),
                               "idle_gaps": win.idle_gaps(host_spans, 10)}
        detail.update(counters=readings["counters"],
                      kernel_calls=readings["calls"],
                      kernel_s={k: win.kernel_s(k) for k in dev.KERNELS},
                      spans={k: [v["count"], v["total_s"]]
                             for k, v in readings["spans"].items()})
    result["checks"] = {ch["name"]: [ch["value"], ch["limit"]]
                        for ch in checks}
    result["_detail"] = detail
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    c = cells.load(ROOT, a.workload)
    dev.require_cards(c.chips)
    res = run_cell(ROOT, a.workload, a.seed, a.seconds, bool(a.trace))
    left = forbidden_modules()
    if left:
        print(f"forbidden modules loaded: {left}", file=sys.stderr)
        return 3
    detail = res.pop("_detail")
    print("detail " + json.dumps(detail, default=str), file=sys.stderr)
    for name, (value, limit) in res["checks"].items():
        print(f"check {name}: {value} (limit {limit})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
