"""Run a cell's control: the plain reference in the program's place with
one guarantee broken (``benchmark/reference/controls.py``), through the
cell's own driver and check, at the cell's own size and load.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3
        --seconds 10

Prints one JSON line a seed with the numbers the check compared. Each
must come out not correct; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import run  # noqa: E402
from benchmark.harness import cell as cells  # noqa: E402
from benchmark.reference.controls import CONTROLS  # noqa: E402


def control(root, workload, seed, seconds, device="cuda", overrides=None):
    c = cells.load(root, workload)
    mix = dict(c.mix, **(overrides or {}).get("mix", {}))
    res = run.run_cell(root, workload, seed, seconds, False, device,
                       overrides=overrides,
                       program=CONTROLS[mix["driver"]],
                       t_start=time.perf_counter())
    res.pop("_detail")
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10)
    a = p.parse_args(argv)
    for s in a.seeds.split(","):
        res = control(ROOT, a.workload, int(s), a.seconds)
        print(json.dumps({"seed": int(s), "correct": res["correct"],
                          "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
