"""Find an open-loop cell's knee: the highest arrival rate at which the
backlog does not grow over the window.

    python3 benchmark/sweep.py --workload <cell> --rates 10,20,40
        --seconds 15 --seed <n>

For each rate, one set-up and one window of the cell's driver with the
mix's ``rate`` replaced; prints a JSON line a rate with the write
latency's median in each quarter of the window (by due time), its
95th percentile, and how far the window overran. A backlog that grows
shows as quarter medians that climb and an overrun that grows with the
rate. The benchmark's own runs never run this; it sets the rate that
the mix file then fixes.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.harness import cell as cells  # noqa: E402
from benchmark.harness import device as dev  # noqa: E402
from benchmark.harness import stats  # noqa: E402


def sweep(root, workload, rates, seconds, seed, device="cuda"):
    c = cells.load(root, workload)
    mod = importlib.import_module(f"benchmark.drivers.{c.mix['driver']}")
    for rate in rates:
        t0 = time.perf_counter()
        drv = mod.Driver(c.config, dict(c.mix, rate=rate), seed, device,
                         seconds)
        setup = time.perf_counter() - t0
        out = drv.window()
        due, lat = drv.due_w, drv.lat_w
        q = []
        for k in range(4):
            part = [x for d, x in zip(due, lat)
                    if k * seconds / 4 <= d < (k + 1) * seconds / 4]
            q.append(1e3 * stats.percentile(part, 50) if part else None)
        yield {"rate": rate, "setup_s": setup,
               "apply_p95_ms": out["apply_p95_ms"],
               "read_p95_ms": out.get("read_p95_ms"),
               "apply_p50_ms_by_quarter": q,
               "overrun_s": drv.detail["window_span_s"] - seconds,
               "detail": drv.detail}
        del drv
        gc.collect()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=15)
    p.add_argument("--seed", type=int, default=1)
    a = p.parse_args(argv)
    dev.require_cards(1)
    for row in sweep(ROOT, a.workload, [float(r) for r in a.rates.split(",")],
                     a.seconds, a.seed):
        print(json.dumps(row, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
