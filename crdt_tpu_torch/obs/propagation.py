"""Causal cross-replica tracing: wire trace context + lag attribution.

The port's copy of ``crdt_tpu.obs.propagation``, byte for byte on the
wire, so a port replica and a reference replica read each other's
contexts:

- **Wire trace context** (:class:`TraceContext`): a compact, bounded
  causal context carried on update / sync-answer / anti-entropy
  frames — the origin trace id ``(client, seq, monotonic_ts)`` plus
  one **path record per forward leg**: ``(replica, route, delta_us)``
  where ``route`` is one of :data:`ROUTES` and ``delta_us`` is the
  stamping process's monotonic offset from the origin timestamp
  (microseconds). Encoded with the lib0 primitives
  (:mod:`crdt_tpu_torch.codec.lib0`); decoded DEFENSIVELY — a hostile
  context (oversized hop list, negative delta, truncated or trailing
  bytes, non-bytes payload) raises ``ValueError`` and is dropped by
  callers without touching the update it rode on.
- **Per-hop lag attribution** (:class:`PropagationLedger`): receivers
  decompose origin-to-visibility into per-leg, route-tagged
  latencies — leg *i*'s lag is ``path[i+1].delta - path[i].delta``
  (the final leg closes against the receive stamp) — into tracer
  histograms ``replica.hop_lag{route=...}`` and the end-to-end
  ``replica.birth_to_visibility`` span, plus the wire-overhead
  accounting (``propagation.context_bytes`` vs
  ``propagation.traced_update_bytes``; gauge
  ``propagation.wire_overhead_ratio``).

The reference's offline analysis core (``pair_latency``,
``reconstruct_paths``, ``correlate_divergences``) serves its ``obsq``
CLI and fleet collector, which are not ported.

Knobs: ``CRDT_TPU_TRACE_SAMPLE`` (0..1, default 1 — deterministic
per-tid sampling, crc32-derived so every replica agrees on which tids
are traced) and ``CRDT_TPU_TRACE_MAX_HOPS`` (default 8 — forward
seams refuse to grow a context past the bound and count
``propagation.hops_capped`` instead).
"""

from __future__ import annotations

import math
import os
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

from crdt_tpu_torch.codec.lib0 import Decoder, Encoder
from crdt_tpu_torch.obs.tracer import Histogram, get_tracer

# route tags, one per forward-leg kind; the wire carries the index
ROUTES: Tuple[str, ...] = (
    "direct", "predicted", "relayed", "anti_entropy", "sync_answer",
)
_ROUTE_CODE = {r: i for i, r in enumerate(ROUTES)}

_VERSION = 1
# hard wire bounds (the decode fences; every one raises ValueError):
# a context larger than this is hostile before a single field parses
MAX_CONTEXT_BYTES = 512
MAX_REPLICA_ID = 16      # path-record replica ids are short prefixes
_MAX_TID = 1 << 53       # JS-safe integers, like every honest tid
_MAX_DELTA_US = 1 << 53


def max_hops() -> int:
    """The per-context hop bound (``CRDT_TPU_TRACE_MAX_HOPS``)."""
    try:
        n = int(os.environ.get("CRDT_TPU_TRACE_MAX_HOPS", "8"))
    except ValueError:
        return 8
    return max(1, min(n, 64))


def sample_rate() -> float:
    """The origin sampling rate (``CRDT_TPU_TRACE_SAMPLE``)."""
    try:
        r = float(os.environ.get("CRDT_TPU_TRACE_SAMPLE", "1"))
    except ValueError:
        return 1.0
    return min(max(r, 0.0), 1.0)


def sampled(client: int, seq: int, rate: float) -> bool:
    """Deterministic per-tid sampling decision: crc32-derived (no
    process salt), so every replica — and every offline analysis —
    agrees on which trace ids carry context."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    return zlib.crc32(f"{client}:{seq}".encode()) / 2**32 < rate


class TraceContext:
    """Origin tid + bounded per-leg path records."""

    __slots__ = ("origin_client", "origin_seq", "origin_ts", "hops")

    def __init__(self, origin_client: int, origin_seq: int,
                 origin_ts: float,
                 hops: Optional[List[Tuple[str, str, int]]] = None):
        self.origin_client = origin_client
        self.origin_seq = origin_seq
        self.origin_ts = origin_ts
        # [(replica, route, delta_us)] — delta_us is the stamping
        # process's monotonic offset from origin_ts at send time
        self.hops: List[Tuple[str, str, int]] = list(hops or [])

    @property
    def tid(self) -> List[Any]:
        return [self.origin_client, self.origin_seq, self.origin_ts]

    @property
    def tid_key(self) -> Tuple[int, int]:
        return (self.origin_client, self.origin_seq)

    def path_json(self) -> List[List[Any]]:
        """The path as plain JSON (the shape recorder events carry)."""
        return [[r, rt, d] for r, rt, d in self.hops]

    def __repr__(self):
        legs = "→".join(f"{r}[{rt}]" for r, rt, _ in self.hops)
        return (f"TraceContext({self.origin_client}:{self.origin_seq}"
                f" {legs})")


def start_context(client: int, seq: int, replica: str,
                  route: str = "direct",
                  ts: Optional[float] = None) -> TraceContext:
    """A fresh context at the origin: one path record for the first
    send leg, delta 0 by definition."""
    if ts is None:
        ts = time.monotonic()
    return TraceContext(
        client, seq, ts, [(str(replica)[:MAX_REPLICA_ID], route, 0)]
    )


def append_hop(ctx: TraceContext, replica: str, route: str,
               delta_us: int) -> bool:
    """Append one forward-leg record, honoring the max-hops bound.
    Returns False (and counts ``propagation.hops_capped``) when the
    context is already at the bound — the path is then truncated, not
    unbounded."""
    if len(ctx.hops) >= max_hops():
        get_tracer().count("propagation.hops_capped")
        return False
    ctx.hops.append(
        (str(replica)[:MAX_REPLICA_ID], route, max(0, int(delta_us)))
    )
    get_tracer().count("propagation.hops_appended")
    return True


def encode_context(ctx: TraceContext) -> bytes:
    """Compact lib0 wire form: version byte, origin tid, hop count,
    then one (replica varString, route uint8, delta varInt) triple
    per path record."""
    enc = Encoder()
    enc.write_uint8(_VERSION)
    enc.write_var_uint(int(ctx.origin_client))
    enc.write_var_uint(int(ctx.origin_seq))
    enc.write_float64(float(ctx.origin_ts))
    enc.write_var_uint(len(ctx.hops))
    for replica, route, delta_us in ctx.hops:
        enc.write_var_string(str(replica)[:MAX_REPLICA_ID])
        enc.write_uint8(_ROUTE_CODE.get(route, 0))
        enc.write_var_int(int(delta_us))
    return enc.to_bytes()


def decode_context(blob) -> TraceContext:
    """Decode a wire trace context, failing CLOSED: any hostile shape
    — non-bytes payload, oversized blob or hop list, out-of-range
    tid, negative or absurd delta, unknown route or version,
    truncation, trailing garbage — raises ``ValueError`` (only), so
    the poll-loop isolation that guards update decodes covers this
    field too."""
    if not isinstance(blob, (bytes, bytearray)):
        raise ValueError("trace context is not bytes")
    if len(blob) > MAX_CONTEXT_BYTES:
        raise ValueError("trace context exceeds wire bound")
    dec = Decoder(bytes(blob))
    version = dec.read_uint8()
    if version != _VERSION:
        raise ValueError(f"unknown trace context version {version}")
    client = dec.read_var_uint()
    seq = dec.read_var_uint()
    if client >= _MAX_TID or seq >= _MAX_TID:
        raise ValueError("trace context tid out of range")
    ts = dec.read_float64()
    if not math.isfinite(ts):
        # a NaN origin stamp poisons every delta; +/-inf would
        # overflow the microsecond conversions at the forward seams
        raise ValueError("trace context origin ts is not finite")
    n_hops = dec.read_var_uint()
    # buffer-anchored first (a hop is >= 3 wire bytes, so a count
    # past the remaining byte budget is hostile before the protocol
    # bound even applies), then the protocol max-hops bound
    if n_hops > dec.remaining() or n_hops > max_hops():
        raise ValueError("trace context hop list exceeds bound")
    hops: List[Tuple[str, str, int]] = []
    for _ in range(n_hops):  # body reads wire bytes every iteration
        replica = dec.read_var_string()
        if len(replica) > MAX_REPLICA_ID:
            raise ValueError("trace context replica id too long")
        route_code = dec.read_uint8()
        if route_code >= len(ROUTES):
            raise ValueError("unknown trace context route tag")
        delta_us = dec.read_var_int()
        if delta_us < 0:
            raise ValueError("negative trace context ts-delta")
        if delta_us >= _MAX_DELTA_US:
            raise ValueError("trace context ts-delta out of range")
        hops.append((replica, ROUTES[route_code], delta_us))
    if dec.has_content():
        raise ValueError("trailing bytes after trace context")
    return TraceContext(client, seq, ts, hops)


def decode_or_none(blob, *, count: bool = True
                   ) -> Optional[TraceContext]:
    """Admission wrapper for untrusted contexts: a reject is counted
    (``propagation.malformed_contexts``) and returns None — the
    update the context rode on is untouched either way.
    ``count=False`` is for the forward/retag seams, where the
    RECEIVING replica is the authoritative counter (a relayed
    hostile context must read as one, not two)."""
    if blob is None:
        return None
    try:
        return decode_context(blob)
    except ValueError:
        if count:
            get_tracer().count("propagation.malformed_contexts")
        return None


def retag_last_hop(blob: bytes, route: str) -> bytes:
    """Rewrite the newest path record's route tag (the send seam's
    transport attribution: a 'direct' leg that actually rides a
    predicted or relayed path). Semantic tags (anti_entropy,
    sync_answer) are preserved; failures return the blob unchanged —
    attribution must never break delivery."""
    ctx = decode_or_none(blob, count=False)
    if ctx is None or not ctx.hops:
        return blob
    replica, old_route, delta = ctx.hops[-1]
    if old_route != "direct" or route not in _ROUTE_CODE:
        return blob
    ctx.hops[-1] = (replica, route, delta)
    return encode_context(ctx)


def append_hop_wire(blob: bytes, replica: str, route: str,
                    hop_ts: Optional[float] = None) -> bytes:
    """The forward-seam hop incrementer on WIRE form: decode, append
    one path record stamped at ``hop_ts`` (monotonic; defaults to
    now), re-encode. Failures — malformed context, hop bound — return
    the blob unchanged (truncated beats dropped)."""
    ctx = decode_or_none(blob, count=False)
    if ctx is None:
        return blob
    if hop_ts is None:
        hop_ts = time.monotonic()
    if not math.isfinite(hop_ts):
        return blob  # a hostile stamp attributes nothing
    # clamp into the wire-legal range: the decoded origin ts is
    # finite, but a far-future stamp must not overflow the varint
    delta_us = int(min(float(_MAX_DELTA_US - 1),
                       max(0.0, hop_ts - ctx.origin_ts) * 1e6))
    if not append_hop(ctx, replica, route, delta_us):
        return blob
    return encode_context(ctx)


def hop_legs(path: List, origin_ts: float,
             recv_ts: float) -> List[Tuple[str, str, float]]:
    """Per-leg (replica, route, lag_seconds) attribution: leg *i*
    closes at leg *i+1*'s stamp, the final leg at the receive stamp.
    Accepts both decoded hop tuples and the JSON path shape; lags are
    clamped at 0 (cross-host clock offsets must not go negative)."""
    legs: List[Tuple[str, str, float]] = []
    total = max(0.0, recv_ts - origin_ts)
    for i, hop in enumerate(path):
        replica, route, delta_us = hop[0], hop[1], hop[2]
        if not isinstance(delta_us, (int, float)) or route not in _ROUTE_CODE:
            return []  # a malformed offline path attributes nothing
        start_s = max(0.0, float(delta_us) / 1e6)
        if i + 1 < len(path):
            nxt = path[i + 1][2]
            if not isinstance(nxt, (int, float)):
                return []
            end_s = max(0.0, float(nxt) / 1e6)
        else:
            end_s = total
        legs.append((str(replica), str(route),
                     max(0.0, end_s - start_s)))
    return legs


class PropagationLedger:
    """End-to-end birth-to-visibility ledger + per-route hop lag.

    One process-global instance (:func:`get_propagation` /
    :func:`set_propagation`), fed by the replica's send/receive seams
    when observability is on. Keeps route-tagged lag histograms and
    the wire-overhead accounting, mirrors everything into the
    process-global tracer (so ``/metrics`` scrapes and BENCH_OUT
    artifacts carry it), and reports as one JSON-ready dict."""

    def __init__(self):
        self._lock = threading.Lock()
        self._route_lag: Dict[str, Histogram] = {}
        self._e2e = Histogram()
        self.contexts_sent = 0
        self.contexts_received = 0
        self.context_bytes = 0
        self.traced_update_bytes = 0

    # -- producer seams --------------------------------------------------

    def record_send(self, ctx_bytes: bytes, update_bytes: int) -> None:
        """A context was attached at a send seam: count the tracing
        tax against the payload it rode on."""
        with self._lock:
            self.contexts_sent += 1
            self.context_bytes += len(ctx_bytes)
            self.traced_update_bytes += max(0, int(update_bytes))
            ratio = (
                self.context_bytes / self.traced_update_bytes
                if self.traced_update_bytes else 0.0
            )
        tracer = get_tracer()
        if tracer.enabled:
            tracer.count("propagation.contexts_sent")
            tracer.count("propagation.context_bytes", len(ctx_bytes))
            tracer.count(
                "propagation.traced_update_bytes",
                max(0, int(update_bytes)),
            )
            tracer.gauge("propagation.wire_overhead_ratio", ratio)

    def record_receipt(self, ctx: TraceContext,
                       recv_ts: Optional[float] = None) -> int:
        """A traced frame became visible here: attribute every leg to
        its route and close the birth-to-visibility clock. Returns
        the hop count (the frame's delivery depth)."""
        if recv_ts is None:
            recv_ts = time.monotonic()
        legs = hop_legs(ctx.hops, ctx.origin_ts, recv_ts)
        e2e = max(0.0, recv_ts - ctx.origin_ts)
        tracer = get_tracer()
        with self._lock:
            self.contexts_received += 1
            for _, route, lag in legs:
                h = self._route_lag.get(route)
                if h is None:
                    h = self._route_lag[route] = Histogram()
                h.add(lag)
            self._e2e.add(e2e)
        if tracer.enabled:
            tracer.count("propagation.contexts_received")
            for _, route, lag in legs:
                # crdtlint: emits=replica.hop_lag
                tracer.observe(
                    f'replica.hop_lag{{route="{route}"}}', lag
                )
            tracer.observe("replica.birth_to_visibility", e2e)
        return len(ctx.hops)

    # -- reporting -------------------------------------------------------

    def report(self) -> Dict[str, Any]:
        with self._lock:
            ratio = (
                self.context_bytes / self.traced_update_bytes
                if self.traced_update_bytes else 0.0
            )
            return {
                "contexts_sent": self.contexts_sent,
                "contexts_received": self.contexts_received,
                "context_bytes": self.context_bytes,
                "traced_update_bytes": self.traced_update_bytes,
                "wire_overhead_ratio": ratio,
                "birth_to_visibility": self._e2e.summary(),
                "hop_lag_by_route": {
                    r: h.summary()
                    for r, h in sorted(self._route_lag.items())
                },
            }


_ledger = PropagationLedger()


def get_propagation() -> PropagationLedger:
    return _ledger


def set_propagation(ledger: PropagationLedger) -> PropagationLedger:
    global _ledger
    _ledger = ledger
    return ledger
