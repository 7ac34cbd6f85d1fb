"""Closed-loop anti-entropy rounds of a swarm: one client runs the whole
swarm's round through ``replay_trace(route="fleet")`` back to back.

The configuration is :func:`benchmark.gen.swarm.build`'s (peers, ops a
peer, the fan-out of the broadcasts a peer received, the longest
prefix of one); the mix file sets ``route`` and ``samples`` as for
:mod:`benchmark.drivers.replay`, whose window this driver runs, so a
round is one replay and is counted as ``replays``. Each round is handed
a fresh copy of every peer's blob.

End to end: ``converge_ops_per_s``, every row of every peer's blob (the
updates a round merges, redeliveries included) of every round started
in the window over the time from the first start to the last end; the
``detail`` line gives the distinct ops beside it. The check compares
the sampled rounds' converged documents and compacted snapshots with
the plain reference's, and every entry of their plans (each peer's
state vector, the swarm vector, the deficit matrix) with
:mod:`benchmark.reference.swarm`'s.
"""

from __future__ import annotations

from typing import Dict, List

from benchmark.drivers import replay
from benchmark.gen import swarm, wire
from benchmark.harness import stats
from benchmark.reference import swarm as ref_swarm
from benchmark.reference import yjs


class Driver(replay.Driver):
    """``program`` (a seam for the benchmark's tests and control) builds
    the round callable from this load driver in place of
    :func:`benchmark.drivers.replay.port`."""

    def __init__(self, config: Dict, mix: Dict, seed: int, device: str,
                 seconds: float, program=None):
        self.device = device
        self.seconds = seconds
        self.route = mix["route"]
        self.peers = config["peers"]
        self.blobs, self.table, self.ds, self.views, info = swarm.build(
            self.peers, config["ops_per_peer"], config["fanout"],
            config["prefix_max"], seed=stats.rng_of(seed).integers(1 << 62),
            map_frac=config["map_frac"])
        self.n_ops = info["rows"]
        self.distinct = info["ops"]
        self.detail = {"swarm": info}
        self.replay = (program or replay.port)(self)
        self.samples = mix["samples"]
        self.pick = set(stats.rng_of(seed, 1).choice(
            mix["sample_from"], size=self.samples, replace=False).tolist())
        self.kept: Dict[int, object] = {}
        self.counts: Dict[str, int] = {}
        warm = self.replay(self.blobs)  # warm: builds and loads every kernel
        self._sync()
        if getattr(warm, "plan", None) is None:
            raise SystemExit("the fleet route returned no anti-entropy "
                             "plan (ReplayResult.plan)")

    def window(self) -> Dict:
        out = super().window()
        out["extra"]["distinct_ops_per_s"] = \
            self.distinct * self.counts["replays"] / self.total_s
        return out

    def check(self) -> List[Dict]:
        want = yjs.converge(self.table, self.ds)
        snap = wire.encode_union(self.table, *self.ds)
        plan = ref_swarm.plan(self.table, self.views, self.peers)
        cache_bad = snap_bad = ops_bad = plan_bad = 0
        for res in self.kept.values():
            cache_bad = max(cache_bad, yjs.cache_diff(res.cache, want))
            snap_bad = max(snap_bad, yjs.bytes_diff(res.snapshot, snap))
            ops_bad = max(ops_bad, abs(res.n_ops - self.n_ops))
            plan_bad = max(plan_bad, ref_swarm.plan_diff(
                getattr(res, "plan", None), plan))
        return [
            {"name": "doc_entries_differing", "value": cache_bad, "limit": 0},
            {"name": "snapshot_bytes_differing", "value": snap_bad,
             "limit": 0},
            {"name": "plan_entries_differing", "value": plan_bad, "limit": 0},
            {"name": "op_count_off_by", "value": ops_bad, "limit": 0},
            {"name": "results_repeated", "value": self.repeats, "limit": 0},
            {"name": "rounds_compared", "value": len(self.kept),
             "limit": None},
        ]
