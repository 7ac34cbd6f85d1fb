"""Observability: the phase tracer (spans, counters, gauges)."""

from crdt_tpu_torch.obs.tracer import Tracer, get_tracer, set_tracer

__all__ = ["Tracer", "get_tracer", "set_tracer"]
