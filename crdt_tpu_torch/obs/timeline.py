"""Tick-timeline profiler: a bounded ring of per-tick phase records.

The port's copy of ``crdt_tpu.obs.timeline`` (pure Python). The
streaming executor records one ``stream`` tick per replay on it: the
per-shard converges as dispatch windows, its per-stage busy sums as
extra lanes.

The round-15 serve() loop overlaps host staging with in-flight
converge dispatches (the streaming executor's double-buffer
discipline applied at the server level), but until round 18 that
overlap was only *claimed* by aggregate counters. This profiler makes
it *visible and gateable*: each tick records its host phases
(prepare, fair_order, route, pack, unpack, settle — plus ingest in
the serve loop) as wall intervals and each converge dispatch as an
async in-flight window (enqueue -> fetch-complete), then computes

- ``overlap_efficiency`` — the round-6 overlap accounting over the
  tick's lanes (host phases + the merged device window):
  ``(busy - wall) / (busy - longest)``, 0 = fully serial, 1 = the
  wall collapsed onto the single longest lane;
- ``stall_ms`` — time the host spent *blocked* inside result fetches
  (the converge_wait analogue): the double-buffer's failure signature
  is stall growing while efficiency shrinks.

Records live in a fixed-size ring (always cheap, always recent) and
export as Chrome/Perfetto trace-event JSON (:meth:`TickTimeline.
to_perfetto` — ``ui.perfetto.dev`` renders a serve() run as a
zoomable timeline with the dispatch windows on their own track), or
as plain dicts (:meth:`records`). Disabled by default; when disabled
every hook is a single attribute check and :meth:`phase` returns one
shared no-op context manager — the same free-when-off contract as the
tracer. The record-building methods are called only from the single
tick thread; the ring itself is locked so ``/timeline`` scrapes and
``records()`` reads are safe from any thread.

Tracer emission at each tick end (README "Observability v2"):
gauges ``timeline.overlap_efficiency`` / ``timeline.stall_ms`` (the
last tick's values — gateable in ``tools/metrics_diff.py``), counter
``timeline.ticks``.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from contextlib import nullcontext
from typing import Any, Dict, List, Optional

from crdt_tpu_torch.obs.tracer import get_tracer

_NULL_PHASE = nullcontext()


def overlap_of(lanes: Dict[str, float], wall_s: float) -> float:
    """The round-6 overlap efficiency over per-lane busy seconds:
    (busy - wall) / (busy - longest), clamped to [0, 1]. 0 = fully
    serial, 1 = wall collapsed onto the longest lane."""
    busy = sum(lanes.values())
    longest = max(lanes.values(), default=0.0)
    hideable = busy - longest
    if hideable > 1e-9:
        eff = (busy - wall_s) / hideable
    else:
        eff = 1.0 if wall_s <= busy + 1e-9 else 0.0
    return min(max(eff, 0.0), 1.0)


class _PhaseCM:
    __slots__ = ("_tl", "_name", "_t0")

    def __init__(self, tl: "TickTimeline", name: str):
        self._tl = tl
        self._name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return None

    def __exit__(self, *exc):
        self._tl.add_phase(
            self._name, self._t0, time.perf_counter()
        )
        return False


class TickTimeline:
    """Bounded ring of structured per-tick phase records."""

    def __init__(self, capacity: int = 256, *, enabled: bool = False):
        self.enabled = enabled
        self.capacity = capacity
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=capacity)
        self.recorded = 0          # ticks ever recorded (ring evicts)
        self._cur: Optional[Dict[str, Any]] = None
        # epoch: perf_counter origin for the exported microsecond
        # timestamps, pinned at the first recorded tick
        self._epoch: Optional[float] = None

    # -- record building (single tick thread) --------------------------

    def tick_begin(self, tick: int, label: str = "tick") -> None:
        if not self.enabled:
            return
        t0 = time.perf_counter()
        if self._epoch is None:
            self._epoch = t0
        self._cur = {
            "tick": tick,
            "label": label,
            "t0": t0,
            "phases": [],      # (name, start_s, end_s)
            "dispatches": [],  # {i, enq, fetch0, end}
            "stall_s": 0.0,
        }

    def phase(self, name: str):
        """Context manager timing one host phase of the current tick
        (no-op when disabled or outside a tick)."""
        if not self.enabled or self._cur is None:
            return _NULL_PHASE
        return _PhaseCM(self, name)

    def add_phase(self, name: str, t0: float, t1: float) -> None:
        if not self.enabled or self._cur is None:
            return
        self._cur["phases"].append((name, t0, t1))

    def instant(self, name: str,
                args: Optional[Dict[str, Any]] = None) -> None:
        """Mark a point event inside the current tick (round 22: the
        control plane stamps one per decision, so a budget squeeze
        is visible AT the tick it fired on the Perfetto track).
        No-op when disabled or outside a tick."""
        if not self.enabled or self._cur is None:
            return
        self._cur.setdefault("instants", []).append(
            (name, time.perf_counter(), args or {})
        )

    def dispatch_begin(self, t: Optional[float] = None) -> Optional[int]:
        """A converge dispatch was enqueued (its async in-flight
        window opens). Returns a token for :meth:`dispatch_end`, or
        None when disabled. ``t`` overrides the enqueue stamp for
        producers that enqueued on another thread (the streaming
        stager)."""
        if not self.enabled or self._cur is None:
            return None
        d = {
            "i": len(self._cur["dispatches"]),
            "enq": time.perf_counter() if t is None else t,
            "fetch0": None,
            "end": None,
        }
        self._cur["dispatches"].append(d)
        return d["i"]

    def dispatch_end(self, token: Optional[int],
                     fetch_t0: float, fetch_t1: float) -> None:
        """The dispatch's result fetch completed; ``fetch_t0..t1`` is
        the host's *blocked* wait (the stall)."""
        if not self.enabled or self._cur is None or token is None:
            return
        d = self._cur["dispatches"][token]
        d["fetch0"] = fetch_t0
        d["end"] = fetch_t1
        self._cur["stall_s"] += max(0.0, fetch_t1 - fetch_t0)

    def tick_end(self, extra_busy: Optional[Dict[str, float]] = None
                 ) -> Optional[Dict[str, Any]]:
        """Close the current tick: compute the overlap accounting,
        push the record into the ring, publish the gauges.
        ``extra_busy`` adds lanes measured elsewhere (the streaming
        executor's per-stage busy sums)."""
        if not self.enabled or self._cur is None:
            return None
        cur, self._cur = self._cur, None
        t_end = time.perf_counter()
        wall = t_end - cur["t0"]
        lanes: Dict[str, float] = {}
        for name, a, b in cur["phases"]:
            lanes[name] = lanes.get(name, 0.0) + max(0.0, b - a)
        device = _merged_windows(
            [(d["enq"], d["end"]) for d in cur["dispatches"]
             if d["end"] is not None]
        )
        if device > 0.0:
            lanes["dispatch"] = device
        if extra_busy:
            for k, v in extra_busy.items():
                lanes[k] = lanes.get(k, 0.0) + float(v)
        eff = overlap_of(lanes, wall)
        rec = {
            "tick": cur["tick"],
            "label": cur["label"],
            "t0": cur["t0"],
            "wall_s": wall,
            "phases": cur["phases"],
            "dispatches": cur["dispatches"],
            "stall_s": cur["stall_s"],
            "stall_ms": cur["stall_s"] * 1e3,
            "overlap_efficiency": eff,
            "lanes": lanes,
            "instants": cur.get("instants", []),
        }
        with self._lock:
            self._ring.append(rec)
            self.recorded += 1
        tracer = get_tracer()
        if tracer.enabled:
            tracer.count("timeline.ticks")
            tracer.gauge("timeline.overlap_efficiency", eff)
            tracer.gauge("timeline.stall_ms", rec["stall_ms"])
        return rec

    # -- reads / export ------------------------------------------------

    def records(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def to_perfetto(self, *, pid: Optional[int] = None,
                    process_name: Optional[str] = None
                    ) -> Dict[str, Any]:
        """The ring as Chrome trace-event JSON (the subset Perfetto
        renders): host phases on tid 1, dispatch in-flight windows on
        tid 2, a counter track for overlap efficiency. Timestamps are
        microseconds from the first recorded tick.

        ``pid`` defaults to the PROCESS identity (``os.getpid()``) —
        round 18 emitted one flat pid, so collector-merged timelines
        from multiple processes collided onto one track; now every
        process exports under its own pid and ``process_name``
        (default ``crdt_tpu.serve[<pid>]``), and a collector that
        merges several processes' timelines re-pids on top."""
        if pid is None:
            import os

            pid = os.getpid()
        if process_name is None:
            process_name = f"crdt_tpu.serve[{pid}]"
        epoch = self._epoch if self._epoch is not None else 0.0

        def us(t: float) -> float:
            return round((t - epoch) * 1e6, 1)

        events: List[Dict[str, Any]] = [
            {"name": "process_name", "ph": "M", "ts": 0,
             "pid": pid, "tid": 0,
             "args": {"name": process_name}},
            {"name": "thread_name", "ph": "M", "ts": 0,
             "pid": pid, "tid": 1, "args": {"name": "host"}},
            {"name": "thread_name", "ph": "M", "ts": 0,
             "pid": pid, "tid": 2, "args": {"name": "device"}},
        ]
        for rec in self.records():
            targs = {"tick": rec["tick"],
                     "stall_ms": round(rec["stall_ms"], 3),
                     "overlap_efficiency": round(
                         rec["overlap_efficiency"], 4)}
            events.append({
                "name": f"{rec['label']}[{rec['tick']}]",
                "ph": "X", "ts": us(rec["t0"]),
                "dur": round(rec["wall_s"] * 1e6, 1),
                "pid": pid, "tid": 1, "cat": "tick", "args": targs,
            })
            for name, a, b in rec["phases"]:
                events.append({
                    "name": name, "ph": "X", "ts": us(a),
                    "dur": round(max(0.0, b - a) * 1e6, 1),
                    "pid": pid, "tid": 1, "cat": "phase",
                    "args": {"tick": rec["tick"]},
                })
            for d in rec["dispatches"]:
                if d["end"] is None:
                    continue
                events.append({
                    "name": f"dispatch({d['i']})", "ph": "X",
                    "ts": us(d["enq"]),
                    "dur": round((d["end"] - d["enq"]) * 1e6, 1),
                    "pid": pid, "tid": 2, "cat": "dispatch",
                    "args": {
                        "tick": rec["tick"],
                        "fetch_wait_ms": round(
                            (d["end"] - d["fetch0"]) * 1e3, 3
                        ) if d["fetch0"] is not None else None,
                    },
                })
            for name, t, iargs in rec.get("instants", ()):
                # ph "i": a Perfetto instant — the control plane's
                # decision markers land on the host track at the
                # moment the rule fired (scope "t": thread-scoped)
                events.append({
                    "name": name, "ph": "i", "ts": us(t),
                    "pid": pid, "tid": 1, "cat": "control",
                    "s": "t", "args": dict(iargs,
                                           tick=rec["tick"]),
                })
            events.append({
                "name": "overlap_efficiency", "ph": "C",
                "ts": us(rec["t0"]), "pid": pid, "tid": 1,
                "args": {"value": round(rec["overlap_efficiency"], 4)},
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def perfetto_json(self, path: Optional[str] = None) -> str:
        text = json.dumps(self.to_perfetto())
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text


def _merged_windows(spans: List[tuple]) -> float:
    """Total length of the union of [a, b) intervals — the device
    lane's occupancy without double-counting windows the
    double-buffer overlapped with each other."""
    total = 0.0
    end = float("-inf")
    for a, b in sorted(spans):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


_timeline = TickTimeline(enabled=False)


def get_timeline() -> TickTimeline:
    return _timeline


def set_timeline(timeline: TickTimeline) -> TickTimeline:
    global _timeline
    _timeline = timeline
    return timeline
