"""Live fleet collector: federate N processes' obs endpoints.

The port's copy of ``crdt_tpu.obs.collector``; it federates port and
reference processes alike (their scrape surfaces are the same).

Every instrumented process already serves ``/metrics /snapshot
/events /timeline`` (:class:`crdt_tpu_torch.obs.http.ObsHTTPServer`); until
round 19 correlating them meant dumping rings to disk and running
``obsq`` offline. The collector is the live federation tier the
ROADMAP item-2 fleet presupposes:

- **scrape or push**: :meth:`FleetCollector.scrape` pulls every
  registered process's ``/snapshot`` + ``/events`` + ``/timeline``
  over stdlib ``urllib`` (bounded timeout; a dead process counts
  ``collector.scrape_errors`` and keeps its last snapshot), and
  :meth:`FleetCollector.push` accepts the same payloads pushed by a
  process that cannot be scraped;
- **fleet registries**: counters/gauges/spans re-keyed with a
  ``proc=`` label (``replica.updates_applied{proc="p1"}``) plus
  fleet-wide counter sums, one dict;
- **live cross-process correlation**: the merged event streams run
  through the SAME analysis core offline ``obsq`` uses
  (:mod:`crdt_tpu_torch.obs.propagation`) — trace-id pairing, per-route
  hop-lag percentiles, full-path reconstruction (``pair_rate``), and
  ``obsq diverge``'s divergence correlation, promoted from offline
  to live;
- **merged Perfetto timelines**: :func:`merge_perfetto` re-pids each
  process's trace-event JSON deterministically so the fleet renders
  as one zoomable multi-process timeline (the round-19 pid
  namespacing in ``timeline.to_perfetto`` makes raw exports
  collision-free too).

Collector-process metrics (stable registry rows): gauge
``collector.procs`` (processes with a live snapshot), counters
``collector.scrapes`` / ``collector.scrape_errors`` /
``collector.events_ingested`` / ``collector.divergences``, gauge
``collector.pair_rate`` (fraction of traced receives whose full path
reconstructs — the fleet acceptance number).

Serve it: ``ObsHTTPServer(collector=col)`` adds ``GET /fleet`` (the
fleet report as JSON) and ``GET /fleet/timeline`` (merged Perfetto).
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request
from collections import OrderedDict
from typing import Any, Dict, List, Optional

from crdt_tpu_torch.obs.propagation import (
    correlate_divergences,
    pair_latency,
)
from crdt_tpu_torch.obs.tracer import get_tracer

# scrape responses are bounded before json-parse: a misconfigured
# endpoint (or a hostile one) must cost a capped read, not memory
_MAX_BODY = 32 * 1024 * 1024
_EVENTS_LIMIT = 4096


def _proc_key(name: str, metric: str) -> str:
    """Re-key one process metric with its proc label, composing with
    existing labels (``a.b{x="y"}`` -> ``a.b{proc="p",x="y"}``)."""
    esc = str(name).replace("\\", "\\\\").replace('"', '\\"')
    if metric.endswith("}") and "{" in metric:
        base, inner = metric[:-1].split("{", 1)
        return f'{base}{{proc="{esc}",{inner}}}'
    return f'{metric}{{proc="{esc}"}}'


def merge_perfetto(traces: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """Merge per-process Chrome trace-event JSON into one fleet
    trace: processes sort by name and take pids 1..N (deterministic —
    child os.getpid()s are not), every event is re-pidded, and each
    process's ``process_name`` metadata is rewritten to the proc name
    so the Perfetto UI groups tracks by process identity."""
    events: List[Dict[str, Any]] = []
    for pid, name in enumerate(sorted(traces), start=1):
        trace = traces[name] or {}
        for ev in trace.get("traceEvents", ()):
            if not isinstance(ev, dict):
                continue
            ev = dict(ev, pid=pid)
            if ev.get("name") == "process_name":
                ev["args"] = {"name": str(name)}
            events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


class FleetCollector:
    """Federates N processes' obs surfaces into one fleet view."""

    def __init__(self, procs: Optional[Dict[str, str]] = None, *,
                 timeout_s: float = 3.0,
                 events_limit: int = _EVENTS_LIMIT):
        self._lock = threading.Lock()
        self._urls: Dict[str, str] = dict(procs or {})
        self._snapshots: Dict[str, Dict[str, Any]] = {}
        self._events: Dict[str, List[Dict[str, Any]]] = {}
        self._timelines: Dict[str, Dict[str, Any]] = {}
        # round 22: per-process /control reports (ledger tail +
        # placement advice) — absent for processes without a control
        # plane (the endpoint 404s; the scrape tolerates it)
        self._controls: Dict[str, Dict[str, Any]] = {}
        self.timeout_s = timeout_s
        self.events_limit = events_limit
        self.scrapes = 0
        self.scrape_errors = 0
        # divergences already counted on the tracer: the same event
        # sits in the merged stream across scrapes, and re-counting
        # it per fleet_report() would inflate the health counter.
        # Bounded (insertion-ordered dict, oldest evicted) like every
        # other obs structure — a long-lived collector watching a
        # divergence-prone fleet must not grow without bound; an
        # evicted key's event has long aged out of the source rings.
        self._counted_divs: "OrderedDict[tuple, None]" = OrderedDict()

    # -- membership ------------------------------------------------------

    def add_proc(self, name: str, base_url: str) -> None:
        """Register one process's ObsHTTPServer base URL."""
        with self._lock:
            self._urls[str(name)] = base_url.rstrip("/")

    @property
    def procs(self) -> List[str]:
        """Processes with a LIVE surface (at least one successful
        scrape or push); registered-but-silent ones show up in the
        fleet report's ``stale_procs`` instead."""
        with self._lock:
            return sorted(
                set(self._snapshots) | set(self._events)
                | set(self._timelines)
            )

    # -- ingest: push ----------------------------------------------------

    def push(self, name: str, *,
             snapshot: Optional[Dict[str, Any]] = None,
             events: Optional[List[Dict[str, Any]]] = None,
             timeline: Optional[Dict[str, Any]] = None,
             control: Optional[Dict[str, Any]] = None) -> None:
        """Push-mode ingest: a process (or a test) hands the same
        payloads a scrape would fetch. Partial pushes update only the
        supplied surfaces."""
        name = str(name)
        tagged = None
        if events is not None:
            tagged = [dict(e, proc=name) for e in events
                      if isinstance(e, dict)]
            # explicit zero-guard: tagged[-0:] would keep EVERYTHING
            # (the same falsy-slice hazard _filter_events documents)
            tagged = tagged[-self.events_limit:] \
                if self.events_limit else []
        with self._lock:
            if snapshot is not None:
                self._snapshots[name] = snapshot
            if tagged is not None:
                self._events[name] = tagged
            if timeline is not None:
                self._timelines[name] = timeline
            if control is not None:
                self._controls[name] = control
        if tagged is not None:
            get_tracer().count(
                "collector.events_ingested", len(tagged)
            )

    # -- ingest: scrape --------------------------------------------------

    def _get(self, url: str) -> bytes:
        with urllib.request.urlopen(
            url, timeout=self.timeout_s
        ) as resp:
            return resp.read(_MAX_BODY)

    def scrape(self) -> Dict[str, bool]:
        """One scrape round over every registered URL. Returns
        {proc: ok}; a failing process keeps its last good surfaces
        (the fleet view degrades to stale, never to absent)."""
        with self._lock:
            urls = dict(self._urls)
        ok: Dict[str, bool] = {}
        tracer = get_tracer()
        for name, base in sorted(urls.items()):
            try:
                snap = json.loads(self._get(f"{base}/snapshot"))
                ev_lines = self._get(
                    f"{base}/events?limit={self.events_limit}"
                ).decode("utf-8", "replace")
                events = [
                    json.loads(ln) for ln in ev_lines.splitlines()
                    if ln.strip()
                ]
                timeline = json.loads(self._get(f"{base}/timeline"))
            except (OSError, ValueError, urllib.error.URLError):
                # concurrent /fleet handlers (ThreadingHTTPServer)
                # may scrape at once: the health counters the fleet
                # report publishes must not lose increments
                with self._lock:
                    self.scrape_errors += 1
                tracer.count("collector.scrape_errors")
                ok[name] = False
                continue
            # the control surface is OPTIONAL (round 22): a process
            # without a control plane 404s here, which must neither
            # fail the scrape nor count as a scrape error
            control = None
            try:
                control = json.loads(self._get(f"{base}/control"))
            except (OSError, ValueError, urllib.error.URLError):
                pass
            self.push(name, snapshot=snap, events=events,
                      timeline=timeline, control=control)
            ok[name] = True
        with self._lock:
            self.scrapes += 1
            n_live = len(self._snapshots)
        tracer.count("collector.scrapes")
        tracer.gauge("collector.procs", n_live)
        return ok

    # -- fleet views -----------------------------------------------------

    def merged_events(self) -> List[Dict[str, Any]]:
        """Every ingested event, oldest-first on the shared monotonic
        timebase, each tagged ``proc=`` — the exact shape the
        propagation analysis core (and obsq) consumes."""
        with self._lock:
            evs = [e for lst in self._events.values() for e in lst]
        evs.sort(key=lambda e: (e.get("ts", 0.0),
                                str(e.get("proc", ""))))
        return evs

    def fleet_metrics(self) -> Dict[str, Any]:
        """Counters/gauges re-keyed with ``proc=`` labels plus
        fleet-wide sums of every unlabeled counter."""
        out: Dict[str, Any] = {"counters": {}, "gauges": {},
                               "sums": {}}
        with self._lock:
            snaps = dict(self._snapshots)
        for name, snap in sorted(snaps.items()):
            tr = (snap or {}).get("tracer") or {}
            for section in ("counters", "gauges"):
                for metric, value in (tr.get(section) or {}).items():
                    out[section][_proc_key(name, metric)] = value
                    if section == "counters" and "{" not in metric \
                            and isinstance(value, (int, float)):
                        out["sums"][metric] = \
                            out["sums"].get(metric, 0) + value
        return out

    def fleet_report(self) -> Dict[str, Any]:
        """The /fleet payload: membership, proc-labeled registries,
        live cross-process propagation + divergence correlation —
        one JSON-ready dict. Publishes ``collector.pair_rate`` and
        ``collector.divergences`` on the collector's tracer."""
        events = self.merged_events()
        latency = pair_latency(events)
        # pair_latency already ran the reconstruction over the same
        # events — reuse it instead of a second O(events) scan
        paths = latency["paths"]
        diverge = correlate_divergences(events)
        tracer = get_tracer()
        tracer.gauge("collector.pair_rate", paths["pair_rate"])
        tracer.gauge("collector.procs", len(self.procs))
        fresh = 0
        for d in diverge["events"]:
            key = (d["src"], json.dumps(d["divergence"],
                                        sort_keys=True, default=str))
            with self._lock:
                if key in self._counted_divs:
                    continue
                self._counted_divs[key] = None
                while len(self._counted_divs) > 4096:
                    self._counted_divs.popitem(last=False)
            fresh += 1
        if fresh:
            tracer.count("collector.divergences", fresh)
        live = set(self.procs)
        with self._lock:
            stale = sorted(set(self._urls) - live)
            controls = dict(self._controls)
        return {
            "procs": self.procs,
            "stale_procs": stale,
            "scrapes": self.scrapes,
            "scrape_errors": self.scrape_errors,
            "events": len(events),
            "metrics": self.fleet_metrics(),
            "latency": latency,
            "paths": paths,
            "divergence": diverge,
            # round 22: each process's live control report (ledger
            # tail, setpoints) plus the flattened proc-tagged advice
            # rows — ROADMAP item 2's rebalance hints, federated
            # here, consumed by a later round's placement loop
            "control": controls,
            "advice": self.fleet_advice(),
        }

    def fleet_advice(self) -> List[Dict[str, Any]]:
        """Every process's placement-advice rows, proc-tagged, in
        deterministic (proc, tenant) order."""
        with self._lock:
            controls = dict(self._controls)
        out: List[Dict[str, Any]] = []
        for name in sorted(controls):
            for row in (controls[name] or {}).get("advice") or ():
                if isinstance(row, dict):
                    out.append(dict(row, proc=name))
        return out

    def merged_perfetto(self) -> Dict[str, Any]:
        with self._lock:
            traces = dict(self._timelines)
        return merge_perfetto(traces)
