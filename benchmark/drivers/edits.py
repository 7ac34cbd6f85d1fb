"""Closed-loop cold replay of an edited workspace: one client replays the
whole stored history of a doc of nested arrays through ``replay_trace``
back to back.

The configuration is :func:`benchmark.gen.nested.build`'s (writers,
arrays, edits a writer, the sync interval, the arrays' Zipf skew, the
edit mix, the cut length, the value size); the mix file sets ``route``
and ``samples`` as for :mod:`benchmark.drivers.replay`, whose window
this driver runs.

End to end: ``converge_ops_per_s``, every item of every replay started
in the window (each value inserted, pushed or unshifted, and each
array's own item) over the time from the first start to the last end.
Each replay gets a fresh copy of the history. The check compares the
sampled replays' converged documents (every array's visible values in
order) and compacted snapshots with the plain reference's
(:mod:`benchmark.reference.yata`), value by value and byte by byte.
"""

from __future__ import annotations

from typing import Dict, List

from benchmark.drivers import replay
from benchmark.gen import nested
from benchmark.harness import stats
from benchmark.reference import yata, yjs


class Driver(replay.Driver):
    """``program`` (a seam for the benchmark's tests and control) builds
    the replay callable from this load driver in place of
    :func:`benchmark.drivers.replay.port`."""

    def __init__(self, config: Dict, mix: Dict, seed: int, device: str,
                 seconds: float, program=None):
        self.device = device
        self.seconds = seconds
        self.route = mix["route"]
        self.blobs, self.table, self.ds, trace = nested.build(
            config["writers"], config["arrays"], config["edits_per_writer"],
            config["sync_every"], config["array_zipf"], config["mix"],
            config["cut_max"], config["value_bytes"],
            seed=stats.rng_of(seed).integers(1 << 62))
        self.n_ops = len(self.table["client"])
        self.detail = {"trace": dict(trace, bytes=sum(map(len, self.blobs)))}
        self.replay = (program or replay.port)(self)
        self.samples = mix["samples"]
        self.pick = set(stats.rng_of(seed, 1).choice(
            mix["sample_from"], size=self.samples, replace=False).tolist())
        self.kept: Dict[int, object] = {}
        self.counts: Dict[str, int] = {}
        self.replay(self.blobs)  # warm: builds and loads every kernel
        self._sync()

    def check(self) -> List[Dict]:
        want = yata.converge(self.table, self.ds)
        snap = nested.encode_union(self.table, *self.ds)
        cache_bad = snap_bad = ops_bad = 0
        for res in self.kept.values():
            cache_bad = max(cache_bad, yata.cache_diff(res.cache, want))
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
