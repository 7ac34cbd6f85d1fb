"""Closed-loop cold replay: one client replays the whole history of a
fan-in document through ``replay_trace`` back to back.

The mix file sets ``route`` (the replay route, the device one for
the cold-replay cell) and ``samples`` (how many replays, drawn from the
seed among the window's first ``sample_from``, the check compares
besides the last).

End to end: ``converge_ops_per_s``, every op of every replay started
in the window over the time from the first start to the last end.
Each replay is handed a fresh copy of the history (new bytes objects,
as a load from the network or disk would give), so nothing can answer
a replay from an earlier one by the identity of its input. The check
compares the sampled replays' converged documents and compacted
snapshots with the plain reference's, entry by entry and byte by byte,
and counts replays that returned the previous replay's result object.
"""

from __future__ import annotations

import time
from typing import Dict, List

from benchmark.gen import traces, wire
from benchmark.harness import stats
from benchmark.reference import yjs


def port(drv):
    """The system under test: the port's one-shot replay on the
    driver's route and device."""
    from crdt_tpu_torch.models.replay import replay_trace

    return lambda blobs: replay_trace(blobs, route=drv.route,
                                      device=drv.device)


class Driver:
    """``program`` (a seam for the benchmark's tests and control) builds
    the replay callable from this load driver in place of :func:`port`."""

    def __init__(self, config: Dict, mix: Dict, seed: int, device: str,
                 seconds: float, program=None):
        self.device = device
        self.seconds = seconds
        self.route = mix["route"]
        self.R, self.K = config["writers"], config["ops_per_writer"]
        self.blobs, self.table, self.ds = traces.build_trace(
            self.R, self.K, seed=stats.rng_of(seed).integers(1 << 62),
            map_frac=config["map_frac"])
        self.n_ops = self.R * self.K
        self.replay = (program or port)(self)
        self.samples = mix["samples"]
        self.pick = set(stats.rng_of(seed, 1).choice(
            mix["sample_from"], size=self.samples, replace=False).tolist())
        self.kept: Dict[int, object] = {}
        self.counts: Dict[str, int] = {}
        self.replay(self.blobs)  # warm: builds and loads every kernel
        self._sync()

    def _sync(self):
        if self.device == "cuda":
            import torch

            torch.cuda.synchronize()

    def window(self) -> Dict:
        times: List[float] = []
        t0 = time.perf_counter()
        last = None
        self.repeats = 0
        i = 0
        while time.perf_counter() - t0 < self.seconds:
            blobs = [bytes(bytearray(b)) for b in self.blobs]
            a = time.perf_counter()
            res = self.replay(blobs)
            self._sync()
            times.append(time.perf_counter() - a)
            if i in self.pick:
                self.kept[i] = res
            if last is not None and (res is last[1]
                                     or res.cache is last[1].cache):
                self.repeats += 1
            last = (i, res)
            i += 1
        self.total_s = time.perf_counter() - t0
        self.kept[last[0]] = last[1]
        self.counts = {"replays": i}
        return {
            "converge_ops_per_s": self.n_ops * i / self.total_s,
            "attempted": i, "failed": 0,
            "extra": {"replay_s": stats.summary(times)},
        }

    def release(self) -> None:
        """Keep the outputs to judge; drop the program's state."""

    def check(self) -> List[Dict]:
        want = yjs.converge(self.table, self.ds)
        snap = wire.encode_union(self.table, *self.ds)
        cache_bad = snap_bad = ops_bad = 0
        for res in self.kept.values():
            cache_bad = max(cache_bad, yjs.cache_diff(res.cache, want))
            snap_bad = max(snap_bad, yjs.bytes_diff(res.snapshot, snap))
            ops_bad = max(ops_bad, abs(res.n_ops - self.n_ops))
        return [
            {"name": "doc_entries_differing", "value": cache_bad, "limit": 0},
            {"name": "snapshot_bytes_differing", "value": snap_bad,
             "limit": 0},
            {"name": "op_count_off_by", "value": ops_bad, "limit": 0},
            {"name": "results_repeated", "value": self.repeats, "limit": 0},
            {"name": "replays_compared", "value": len(self.kept),
             "limit": None},
        ]
