"""Tracing / metrics — compatibility surface over :mod:`crdt_tpu_torch.obs`
(the port's copy of ``crdt_tpu.utils.trace``).

The observability layer lives in :mod:`crdt_tpu_torch.obs`: a
thread-safe tracer with log-bucketed latency histograms (p50/p90/p99
per span), the sync flight recorder, the divergence sentinel, and
Prometheus/JSON export. This module keeps the reference's import site
(``from crdt_tpu_torch.utils.trace import get_tracer`` ...):

- ``Tracer.span(name)`` — context-manager timer; aggregates count /
  total / max / min and a latency histogram per phase
- ``Tracer.count(name, n)`` / ``gauge(name, v)`` — counters, gauges
- ``Tracer.counters(prefix)`` — filtered counter snapshot
- ``report()`` — one plain dict, JSON-ready

The process-global default tracer is DISABLED by default: every hook
in the hot path is a single attribute check when off. Enable with
``get_tracer().enabled = True`` (or install your own via
:func:`set_tracer`).

For device-side profiling, :func:`torch_profile` captures a
``torch.profiler`` trace of a block and never leaks a running profiler
on failure; :func:`device_annotation` names a range in it
(:mod:`crdt_tpu_torch.obs.profiling`).
"""

from __future__ import annotations

from crdt_tpu_torch.obs.profiling import device_annotation, torch_profile
from crdt_tpu_torch.obs.tracer import Tracer, get_tracer, set_tracer

__all__ = [
    "Tracer",
    "device_annotation",
    "get_tracer",
    "set_tracer",
    "torch_profile",
]
