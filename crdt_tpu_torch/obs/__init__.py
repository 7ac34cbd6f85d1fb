"""Observability: the phase tracer (spans, counters, gauges), the tick
timeline and the profiler annotation seam."""

from crdt_tpu_torch.obs.timeline import (
    TickTimeline,
    get_timeline,
    set_timeline,
)
from crdt_tpu_torch.obs.tracer import Tracer, get_tracer, set_tracer

__all__ = [
    "TickTimeline", "Tracer", "get_timeline", "get_tracer",
    "set_timeline", "set_tracer",
]
