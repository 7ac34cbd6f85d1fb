"""Observability: the phase tracer (spans, counters, gauges), the tick
timeline, the flight recorder, the wire trace context with its
propagation ledger, the divergence sentinel and the profiler annotation
seam."""

from crdt_tpu_torch.obs.propagation import (
    PropagationLedger,
    TraceContext,
    decode_context,
    encode_context,
    get_propagation,
    set_propagation,
)
from crdt_tpu_torch.obs.recorder import (
    FlightRecorder,
    get_recorder,
    set_recorder,
)
from crdt_tpu_torch.obs.sentinel import (
    DivergenceSentinel,
    MultiDocSentinel,
    delete_set_digest,
    state_digest,
)
from crdt_tpu_torch.obs.timeline import (
    TickTimeline,
    get_timeline,
    set_timeline,
)
from crdt_tpu_torch.obs.tracer import Tracer, get_tracer, set_tracer

__all__ = [
    "DivergenceSentinel", "FlightRecorder", "MultiDocSentinel",
    "PropagationLedger", "TickTimeline", "TraceContext", "Tracer",
    "decode_context", "delete_set_digest", "encode_context",
    "get_propagation", "get_recorder", "get_timeline", "get_tracer",
    "set_propagation", "set_recorder", "set_timeline", "set_tracer",
    "state_digest",
]
