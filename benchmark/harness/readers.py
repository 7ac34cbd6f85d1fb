"""Shared arithmetic of the per-layer metric readers.

A reader gets the traced run's readings: ``spans`` (the program's
tracer report over the window: name -> count, total_s, ...),
``counters``, ``timeline`` (the multi-tenant server's tick records),
``counts`` (what the load driver did in the window: replays, ticks, reads,
rounds), ``window`` (:class:`benchmark.harness.device.Window`) and
``calls`` (the converge kernels' live rows). Each returns None where
the run gave it nothing to read, never a 0 that stands for "absent".
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from benchmark.harness import device


def span_ms_per(r: Dict, spans: Sequence[str], per: str) -> Optional[float]:
    """Milliseconds the named program spans took in all, per unit of
    the load driver's count ``per``."""
    n = r["counts"].get(per)
    got = [r["spans"][s]["total_s"] for s in spans if s in r["spans"]]
    if not n or not got:
        return None
    return 1e3 * sum(got) / n


def lane_ms_per(r: Dict, lane: str, per: str) -> Optional[float]:
    """Milliseconds of one tick-timeline lane in all, per unit of
    ``per``."""
    n = r["counts"].get(per)
    got = [t["lanes"][lane] for t in r["timeline"] if lane in t["lanes"]]
    if not n or not got:
        return None
    return 1e3 * sum(got) / n


def roofline(r: Dict, kernel: str) -> Optional[float]:
    return device.roofline_pct(kernel, r["calls"], r["window"])


def idle_pct(r: Dict) -> Optional[float]:
    """Share of the traced window in which nothing ran on the device."""
    w = r["window"]
    if not w.events or w.window_s <= 0:
        return None
    return 100.0 * (1.0 - w.busy_s / w.window_s)
