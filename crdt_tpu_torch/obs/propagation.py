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

- **Analysis core** (:func:`pair_latency`, :func:`reconstruct_paths`,
  :func:`correlate_divergences`): the tid-pairing / path-completeness
  / divergence-correlation logic of the live fleet collector
  (:mod:`crdt_tpu_torch.obs.collector`), the reference's own: events
  are plain recorder dicts, so port and reference dumps pair alike.

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


# ---------------------------------------------------------------------------
# analysis core — shared by tools/obsq.py (offline dumps) and the
# fleet collector (live scrapes); events are plain recorder dicts
# ---------------------------------------------------------------------------


def _percentiles(sorted_vals: List[float]) -> Dict[str, float]:
    def q(p: float) -> float:
        if not sorted_vals:
            return 0.0
        i = min(len(sorted_vals) - 1,
                max(0, int(p * len(sorted_vals) + 0.5) - 1))
        return sorted_vals[i]

    return {
        "count": len(sorted_vals),
        "p50_s": q(0.50),
        "p90_s": q(0.90),
        "p99_s": q(0.99),
        "max_s": sorted_vals[-1] if sorted_vals else 0.0,
    }


def _tid_key(ev: Dict[str, Any]) -> Optional[Tuple[Any, Any]]:
    t = ev.get("tid")
    if isinstance(t, (list, tuple)) and len(t) >= 2:
        a, b = t[0], t[1]
        # events carry wire tids verbatim, so elements can be any
        # JSON shape: only hashable scalars make a pairing key (an
        # unhashable hostile tid must not TypeError out of obsq or
        # a live /fleet request)
        if isinstance(a, (int, float, str)) and \
                isinstance(b, (int, float, str)):
            return (a, b)
    return None


# every ORIGIN-frame event kind (each stamps a fresh tid + context):
# broadcasts, sync-answer diffs, anti-entropy deltas — receives pair
# back against any of them
ORIGIN_KINDS = frozenset({"update.send", "sync.answer", "ae.delta"})


def pair_latency(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """send/recv pairing by trace id across every loaded source: the
    cross-process propagation story. One send may fan out to many
    receivers; every (send, recv) pair contributes one latency. The
    round-19 additions: per-ROUTE leg-lag percentiles decomposed from
    the carried path records, and the path-reconstruction stats the
    fleet acceptance gate reads."""
    sends: Dict[tuple, float] = {}
    for e in events:
        t = e.get("tid")
        key = _tid_key(e)
        if e.get("kind") in ORIGIN_KINDS and key is not None \
                and isinstance(t, (list, tuple)) and len(t) >= 3:
            try:
                sends.setdefault(key, float(t[2]))
            except (TypeError, ValueError):
                continue
    lats: List[float] = []
    unmatched_recv = 0
    hops: Dict[str, int] = {}
    route_legs: Dict[str, List[float]] = {}
    for e in events:
        if e.get("kind") != "update.recv":
            continue
        key = _tid_key(e)
        if key is not None and key in sends and isinstance(
                e.get("ts"), (int, float)):
            lats.append(max(0.0, e["ts"] - sends[key]))
        else:
            unmatched_recv += 1
        h = e.get("hop")
        hkey = str(h) if isinstance(h, int) else "unknown"
        hops[hkey] = hops.get(hkey, 0) + 1
        path = e.get("path")
        t = e.get("tid")
        if (isinstance(path, list) and path
                and isinstance(t, (list, tuple)) and len(t) >= 3
                and isinstance(e.get("ts"), (int, float))
                and isinstance(t[2], (int, float))):
            for _, route, lag in hop_legs(path, float(t[2]), e["ts"]):
                route_legs.setdefault(route, []).append(lag)
    lats.sort()
    paths = reconstruct_paths(events)
    return {
        "sends": len(sends),
        "pairs": len(lats),
        "unmatched_recv": unmatched_recv,
        "propagation": _percentiles(lats),
        "hops": dict(sorted(hops.items())),
        "routes": {
            r: _percentiles(sorted(v))
            for r, v in sorted(route_legs.items())
        },
        "paths": paths,
    }


def reconstruct_paths(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Path completeness across sources: a traced receive is COMPLETE
    when its carried path parses, its hop count matches the path
    depth, every leg carries a known route tag, and its origin tid
    pairs back to an ``update.send`` in some loaded source. The
    ``pair_rate`` (complete / traced receives) is the fleet-leg
    acceptance number — 1.0 means every sampled frame's full path
    reconstructs across processes."""
    send_tids = set()
    origin_procs = set()
    for e in events:
        if e.get("kind") in ORIGIN_KINDS:
            k = _tid_key(e)
            if k is not None:
                send_tids.add(k)
                src = e.get("_src", e.get("proc"))
                if src is not None:
                    origin_procs.add(str(src))
    traced = complete = 0
    routes: Dict[str, int] = {}
    incomplete: List[Dict[str, Any]] = []
    for e in events:
        if e.get("kind") != "update.recv":
            continue
        path = e.get("path")
        if not isinstance(path, list) or not path:
            continue
        traced += 1
        ok = True
        seen_routes = []
        for hop in path:
            if (not isinstance(hop, (list, tuple)) or len(hop) < 3
                    or hop[1] not in _ROUTE_CODE):
                ok = False
                break
            seen_routes.append(hop[1])
        hop_field = e.get("hop")
        if ok and isinstance(hop_field, int) and hop_field != len(path):
            ok = False
        if ok and _tid_key(e) not in send_tids:
            ok = False
        if ok:
            complete += 1
            for r in seen_routes:
                routes[r] = routes.get(r, 0) + 1
        elif len(incomplete) < 8:
            incomplete.append({
                "tid": e.get("tid"), "path": path,
                "src": e.get("_src", e.get("proc")),
            })
    return {
        "sends": len(send_tids),
        "traced_recvs": traced,
        "complete": complete,
        "pair_rate": (complete / traced) if traced else 0.0,
        "routes": dict(sorted(routes.items())),
        "origin_procs": sorted(origin_procs),
        "incomplete_sample": incomplete,
    }


def correlate_divergences(events: List[Dict[str, Any]],
                          context: int = 8) -> Dict[str, Any]:
    """Correlate divergence events across the loaded sources: for
    each, the trailing ``context`` events per source on the same
    topic before the divergence, with digests surfaced for eyeballing
    which update the two sides last disagreed on. (Moved verbatim
    from the round-18 ``obsq diverge`` — offline dumps and live
    collector snapshots share this one implementation.)"""
    out: List[Dict[str, Any]] = []
    divs = [e for e in events if e.get("kind") == "divergence"]
    for div in divs:
        topic = div.get("topic")
        ts = div.get("ts", float("inf"))
        per_src: Dict[str, List[Dict[str, Any]]] = {}
        for e in events:
            if e is div or e.get("ts", 0.0) > ts:
                continue
            if topic is not None and \
                    e.get("topic") not in (None, topic):
                continue
            src = str(e.get("_src", e.get("proc", "?")))
            per_src.setdefault(src, []).append(e)
        ctx = {
            src: [
                {k: ev.get(k) for k in
                 ("ts", "kind", "peer", "replica", "digest", "tid",
                  "hop", "path", "size") if k in ev}
                for ev in evs[-context:]
            ]
            for src, evs in sorted(per_src.items())
        }
        digests = {
            src: [e.get("digest") for e in evs if e.get("digest")]
            for src, evs in ctx.items()
        }
        common = set.intersection(
            *(set(d) for d in digests.values())
        ) if len(digests) > 1 else set()
        out.append({
            "divergence": {
                k: div.get(k) for k in
                ("ts", "topic", "peer", "replica", "local_digest",
                 "peer_digest", "doc") if k in div
            },
            "src": str(div.get("_src", div.get("proc", "?"))),
            "context": ctx,
            "last_common_digests": sorted(common),
        })
    return {"divergences": len(divs), "events": out}
