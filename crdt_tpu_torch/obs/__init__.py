"""Observability: the phase tracer (spans, counters, gauges), the tick
timeline, the flight recorder, the wire trace context with its
propagation ledger and analysis core, the divergence sentinel, the
per-tenant SLO ledger, the control plane, the Prometheus/JSON export,
the HTTP scrape endpoint, the live fleet collector, and the profiler
seam (``torch_profile``, ``device_annotation``)."""

from crdt_tpu_torch.obs.collector import FleetCollector, merge_perfetto
from crdt_tpu_torch.obs.control import Actuation, ControlLedger, Controller
from crdt_tpu_torch.obs.export import snapshot_json, to_prometheus
from crdt_tpu_torch.obs.http import ObsHTTPServer
from crdt_tpu_torch.obs.profiling import device_annotation, torch_profile
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
from crdt_tpu_torch.obs.slo import SLOLedger
from crdt_tpu_torch.obs.timeline import (
    TickTimeline,
    get_timeline,
    set_timeline,
)
from crdt_tpu_torch.obs.tracer import (
    Histogram,
    Tracer,
    get_tracer,
    set_tracer,
)

__all__ = [
    "Actuation",
    "ControlLedger",
    "Controller",
    "DivergenceSentinel",
    "MultiDocSentinel",
    "FleetCollector",
    "FlightRecorder",
    "Histogram",
    "ObsHTTPServer",
    "PropagationLedger",
    "SLOLedger",
    "TickTimeline",
    "TraceContext",
    "Tracer",
    "decode_context",
    "delete_set_digest",
    "device_annotation",
    "encode_context",
    "get_propagation",
    "get_recorder",
    "get_timeline",
    "get_tracer",
    "merge_perfetto",
    "set_propagation",
    "set_recorder",
    "set_timeline",
    "set_tracer",
    "snapshot_json",
    "state_digest",
    "to_prometheus",
    "torch_profile",
]
