"""Open-loop multi-tenant sync server: a YCSB core workload's requests
to many documents through ``MultiDocServer`` with its default settings.

The configuration is the workload's: ``recordcount`` records loaded
before the run, of ``fieldcount`` fields of ``fieldlength`` bytes, each
record a document (:mod:`benchmark.gen.ycsb`: an insert sets every
field of a new record, an update one field, a read is the document's
digest); the shares ``readproportion``, ``updateproportion`` and
``insertproportion`` of the requests; and the record a read or update
targets, drawn by ``requestdistribution``: ``zipfian`` (Zipf with
``zipfian_constant`` over the loaded records) or ``latest`` (YCSB's
skewed-latest: the newest acknowledged record less a Zipf-drawn
offset, resolved when the request is served; reads only). The mix sets
the arrival ``rate`` (requests a second, Poisson, each kind its own
stream at its share) and ``check_reads``, how many reads, drawn from
the seed, the check recomputes.

The server loop is one thread: admit every request due, answer the
reads due (each sees the writes acknowledged before it), then tick if
writes wait; a tick's return acknowledges every write it took. A
write's latency runs from its due time to that return, a read's from
its due time to its digest's return, so a stall shows in every request
it delays.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from benchmark.gen import wire, ycsb
from benchmark.harness import stats
from benchmark.reference import yjs

NO_DS = (np.zeros(0, np.int64),) * 3
READ, UPDATE, INSERT = 0, 1, 2
WARM_UPDATE_DOCS = 40           # updated in each of two warm ticks
WARM_INSERTS = (1, 2, 4, 8, 16)  # records inserted in each warm tick


def port(drv):
    """The system under test: a multi-tenant server with its default
    settings on the load driver's device."""
    from crdt_tpu_torch.models.multidoc import MultiDocServer

    return MultiDocServer(device=drv.device)


class Driver:
    """``program`` (a seam for the benchmark's tests and control) builds
    the server from this load driver in place of :func:`port`.

    Every row the server is sent lies in one record table,
    ``self.table``; ``self.applied[doc]`` lists the row indices of each
    write acknowledged to ``doc`` (its insert first), in order."""

    def __init__(self, config: Dict, mix: Dict, seed: int, device: str,
                 seconds: float, program=None):
        self.device = device
        n0, F = config["recordcount"], config["fieldcount"]
        latest = config["requestdistribution"] == "latest"

        # the schedule: each kind's own set of gaps, and the ranks, the
        # same every seed
        rng = stats.rng_of(seed)
        shares = (config["readproportion"], config["updateproportion"],
                  config["insertproportion"])
        if abs(sum(shares) - 1) > 1e-9:
            raise ValueError("the request shares do not sum to 1")
        self.due, self.kind = stats.poisson_mix(mix["rate"], seconds,
                                                shares, rng)
        n = len(self.due)
        self.rank = stats.zipf_ranks(n, n0, config["zipfian_constant"],
                                     rng) - 1
        if latest and (self.kind == UPDATE).any():
            raise ValueError("latest draws the targets of reads only")
        self.latest = latest

        writes = np.flatnonzero(self.kind != READ)
        n_ins = int((self.kind == INSERT).sum())
        warm_ins = sum(WARM_INSERTS) if config["insertproportion"] else 0
        total = n0 + warm_ins + n_ins
        self.names = [f"user{d}" for d in range(total)]
        rec = ycsb.Records(total, F, config["fieldlength"],
                           stats.rng_of(seed, 3))

        tables: List[Dict] = []

        def batch(docs, insert):
            # (docs, one blob a write, each write's rows in self.table)
            t, bounds = rec.writes(docs, insert)
            start = sum(len(x["client"]) for x in tables)
            tables.append(t)
            blobs = wire.encode_updates(t, bounds, [[]] * len(bounds[1:]))
            return (list(docs), blobs,
                    [np.arange(start + a, start + b)
                     for a, b in zip(bounds[:-1], bounds[1:])])

        # the load phase: every record's insert, one blob a record
        _, self.first, self.first_rows = batch(range(n0), True)
        # warm-up ticks: updates to the hottest records, then inserts in
        # batches of the sizes a window's ticks hold (the cold route's)
        self.warm = []
        if config["updateproportion"]:
            hot = range(min(n0, WARM_UPDATE_DOCS))
            self.warm += [batch(hot, False) for _ in range(2)]
        nxt = n0
        for k in (WARM_INSERTS if warm_ins else ()):
            self.warm.append(batch(range(nxt, nxt + k), True))
            nxt += k
        # the window's writes, in due order
        ins = self.kind[writes] == INSERT
        w_doc = np.where(ins, nxt + np.cumsum(ins) - 1, self.rank[writes])
        self.w_doc, self.w_blobs, self.w_rows = batch(w_doc, ins)
        self.w_req = writes
        self.w_of = {int(i): j for j, i in enumerate(writes)}
        self.table = wire.concat(tables)

        self.applied: Dict[str, List] = {}
        self.newest = n0 - 1
        self.srv = (program or port)(self)
        for d, (blob, rows) in enumerate(zip(self.first, self.first_rows)):
            self.srv.submit(self.names[d], blob)
            self.applied[self.names[d]] = [rows]
        self.srv.tick()
        for docs, blobs, rows in self.warm:
            for d, b, r in zip(docs, blobs, rows):
                self.srv.submit(self.names[d], b)
                self.applied.setdefault(self.names[d], []).append(r)
            self.srv.tick()
            self.newest = max([self.newest] + list(docs))
            for d in docs:
                self.srv.digest(self.names[d])
        self.check_reads = mix["check_reads"]
        self.seed = seed
        self.counts: Dict[str, int] = {}
        self.detail: Dict = {}

    def _target(self, i: int) -> int:
        """The record request ``i`` reads or updates."""
        if self.latest:
            return self.newest - int(self.rank[i]) % (self.newest + 1)
        return int(self.rank[i])

    def window(self) -> Dict:
        srv, names = self.srv, self.names
        n = len(self.due)
        t0 = time.perf_counter()
        due = t0 + self.due
        n_applied = {d: len(v) for d, v in self.applied.items()}
        lat_w: List[float] = []
        lat_r: List[float] = []
        self.reads: List[tuple] = []  # (doc, writes applied, digest)
        reads, unacked = [], []
        self.due_w: List[float] = []
        self.lat_w = lat_w
        shed = ticks = 0
        late = 0.0
        i = 0
        routes = {"delta_docs": 0, "promotions": 0, "pool_dispatches": 0,
                  "dispatches": 0, "fallback_docs": 0}
        while True:
            now = time.perf_counter()
            while i < n and due[i] <= now:
                late = max(late, now - due[i])
                if self.kind[i] == READ:
                    reads.append(i)
                else:
                    j = self.w_of[i]
                    shed += srv.submit(names[self.w_doc[j]], self.w_blobs[j])
                    unacked.append(j)
                i += 1
            for r in reads:
                d = names[self._target(r)]
                try:
                    dig = srv.digest(d)
                except KeyError:  # an acknowledged record it lacks
                    dig = None
                lat_r.append(time.perf_counter() - due[r])
                self.reads.append((d, n_applied[d], dig))
            reads.clear()
            if unacked:
                rep = srv.tick()
                ticks += 1
                t = time.perf_counter()
                for k in routes:
                    routes[k] += getattr(rep, k)
                for j in unacked:
                    u = self.w_req[j]
                    lat_w.append(t - due[u])
                    self.due_w.append(self.due[u])
                    doc = self.w_doc[j]
                    d = names[doc]
                    self.applied.setdefault(d, []).append(self.w_rows[j])
                    n_applied[d] = n_applied.get(d, 0) + 1
                    self.newest = max(self.newest, doc)
                unacked.clear()
            elif i >= n:
                break
            else:
                stats.wait_until(due[i])
        span = time.perf_counter() - t0
        self.counts = {"ticks": ticks, "reads": len(lat_r),
                       "writes": len(lat_w)}
        self.detail = {"routes": routes, "ticks": ticks,
                       "generator_late_s": late, "window_span_s": span,
                       "docs": len(self.applied)}
        return {
            "apply_p95_ms": 1e3 * stats.percentile(lat_w, 95),
            "read_p95_ms": 1e3 * stats.percentile(lat_r, 95),
            "attempted": n, "failed": shed,
            "extra": {"apply_ms": {k: v * 1e3 if k != "n" else v for k, v
                                   in stats.summary(lat_w).items()},
                      "read_ms": {k: v * 1e3 if k != "n" else v for k, v
                                  in stats.summary(lat_r).items()}},
        }

    def release(self) -> None:
        """Read the final documents (one the server lacks reads as
        empty), then drop the server."""
        self.final = {}
        for d in self.applied:
            try:
                self.final[d] = self.srv.cache(d)
            except KeyError:
                self.final[d] = {}
        self.srv = None

    def _want(self, d: str, k: int) -> dict:
        if k == 0:
            return {}
        rows = np.concatenate(self.applied[d][:k])
        return yjs.converge(wire.take(self.table, rows), NO_DS)

    def check(self) -> List[Dict]:
        rng = stats.rng_of(self.seed, 4)
        pick = rng.permutation(len(self.reads))[:self.check_reads]
        bad_reads = sum(
            yjs.digest(self._want(d, k)) != dig
            for d, k, dig in (self.reads[j] for j in pick))
        bad_docs = sum(yjs.cache_diff(self.final[d],
                                      self._want(d, len(self.applied[d])))
                       for d in self.applied)
        lost = sum(dig is None for _, _, dig in self.reads)
        return [
            {"name": "read_digests_wrong", "value": bad_reads, "limit": 0},
            {"name": "reads_unanswered", "value": lost, "limit": 0},
            {"name": "doc_entries_differing", "value": bad_docs, "limit": 0},
            {"name": "reads_compared", "value": len(pick), "limit": None},
            {"name": "docs_compared", "value": len(self.applied),
             "limit": None},
        ]
