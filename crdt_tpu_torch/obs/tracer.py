"""Thread-safe phase tracer with log-bucketed latency histograms.

The port's copy of ``crdt_tpu.obs.tracer``: the same span, counter and
gauge API and the same report schema, so a replay on the card reports
under the span names the reference uses (``decode``, ``pack``,
``converge.dispatch``, ``converge.fetch``, ``gather``, ``materialize``,
``compact``) and the ``xfer.*`` counters of the transfer seam.

Every mutation takes one lock; when disabled, ``span`` returns a shared
no-op context manager and ``count`` / ``gauge`` / ``observe`` return
before touching any state. Spans aggregate count / total / max / min
and a base-2 log-bucketed histogram (1 microsecond floor), so
``report()`` carries p50/p90/p99 per phase.

Spans are also profiler ranges: while a ``torch.profiler`` session is
recording, ``span(name)`` opens ``record_function(f"crdt.{name}")``
around the same block, whether or not the tracer is enabled. The host
ranges then lie on the profiler's own clock, nested as the spans nest,
and every kernel links to the range that launched it. With neither the
profiler nor the tracer on, ``span`` costs one check of the profiler's
flag and returns the shared no-op. Durations recorded with
``observe`` (no block to wrap) have no range.
"""

from __future__ import annotations

import json
import threading
import time
from bisect import bisect_left
from contextlib import nullcontext
from typing import Any, Dict, Optional

import torch.autograd.profiler as _profiler
from torch.profiler import record_function

# base-2 bucket upper edges, 1us floor: bucket k holds durations in
# (edge[k-1], edge[k]] — an observation exactly AT an edge lands in
# that edge's bucket (bisect_left semantics, pinned by test_obs).
# 40 edges reach ~5.5e5 s; anything beyond lands in the +Inf bucket.
N_BUCKETS = 40
BUCKET_EDGES_S = tuple(1e-6 * (1 << k) for k in range(N_BUCKETS))
_OVERFLOW = N_BUCKETS  # index of the +Inf bucket


def bucket_index(seconds: float) -> int:
    """Histogram bucket for a duration (upper-edge inclusive)."""
    if seconds <= BUCKET_EDGES_S[0]:
        return 0
    return bisect_left(BUCKET_EDGES_S, seconds)


class Histogram:
    """Log2-bucketed duration aggregate (the span accumulator).

    Public: other aggregates keep latency histograms on exactly these
    edges, so every report buckets identically."""

    __slots__ = ("count", "total_s", "max_s", "min_s", "buckets")

    def __init__(self):
        self.count = 0
        self.total_s = 0.0
        self.max_s = 0.0
        self.min_s = float("inf")
        self.buckets: Dict[int, int] = {}

    def add(self, dt: float) -> None:
        self.count += 1
        self.total_s += dt
        if dt > self.max_s:
            self.max_s = dt
        if dt < self.min_s:
            self.min_s = dt
        b = bucket_index(dt)
        self.buckets[b] = self.buckets.get(b, 0) + 1

    def summary(self) -> Dict[str, Any]:
        """The per-span report dict (shared by ``Tracer.report()`` and
        the SLO ledger's per-tenant summaries)."""
        return {
            "count": self.count,
            "total_s": self.total_s,
            "mean_s": self.total_s / self.count if self.count else 0.0,
            "max_s": self.max_s,
            "min_s": self.min_s if self.count else 0.0,
            "p50_s": self.quantile(0.50),
            "p90_s": self.quantile(0.90),
            "p99_s": self.quantile(0.99),
            "buckets": {
                (
                    f"{BUCKET_EDGES_S[b]:.9g}"
                    if b < _OVERFLOW else "+Inf"
                ): n
                for b, n in sorted(self.buckets.items())
            },
        }

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile: the upper edge of the bucket
        holding the q-rank observation, clamped to the observed max
        (so p99 never reports above the true maximum). Edge
        semantics (pinned in test_obs): an empty histogram answers
        0.0 for every q; ``q=0`` is the rank-1 (minimum-bucket)
        estimate; ``q>=1`` is the observed max; a single observation
        answers that observation at every q."""
        if not self.count:
            return 0.0
        rank = max(1, min(self.count, int(q * self.count + 0.5)))
        cum = 0
        for b in sorted(self.buckets):
            cum += self.buckets[b]
            if cum >= rank:
                edge = (
                    BUCKET_EDGES_S[b] if b < _OVERFLOW else self.max_s
                )
                return min(edge, self.max_s)
        return self.max_s


# shared no-op context manager: the disabled-tracer span (stdlib
# nullcontext is reusable and reentrant)
_NULL_SPAN = nullcontext()


class _LiveSpan:
    """A timed span; while the profiler records, also the ``crdt.<name>``
    range around the block (``rng``)."""

    __slots__ = ("_tracer", "_name", "_t0", "_range")

    def __init__(self, tracer: "Tracer", name: str, rng=None):
        self._tracer = tracer
        self._name = name
        self._range = rng

    def __enter__(self):
        if self._range is not None:
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return None

    def __exit__(self, *exc):
        self._tracer.observe(self._name, time.perf_counter() - self._t0)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def _esc_label(value: Any) -> str:
    """Prometheus exposition label-value escaping (backslash, quote,
    newline). Label values are caller-controlled since round 18 (doc
    ids become ``tenant=`` labels) — an unescaped ``"`` or newline
    would corrupt the whole /metrics scrape, and a newline could
    inject arbitrary exposition lines."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _labeled(name: str, labels: Optional[Dict[str, Any]]) -> str:
    if not labels:
        return name
    inner = ",".join(
        f'{k}="{_esc_label(labels[k])}"' for k in sorted(labels)
    )
    return f"{name}{{{inner}}}"


class Tracer:
    """Aggregating phase timer + counters + gauges. Thread-safe: all
    mutations take one lock (sub-microsecond uncontended; the timed
    region of a span is measured OUTSIDE the lock)."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._spans: Dict[str, Histogram] = {}
        self._counters: Dict[str, int] = {}
        self._gauges: Dict[str, float] = {}

    # -- phases ----------------------------------------------------------
    def span(self, name: str):
        """Time the block into ``name``'s histogram (enabled tracer)
        and, while the profiler records, mark it as the range
        ``crdt.<name>`` (either way)."""
        rng = None
        if _profiler._is_profiler_enabled:
            rng = record_function(f"crdt.{name}")
        if not self.enabled:
            return _NULL_SPAN if rng is None else rng
        return _LiveSpan(self, name, rng)

    def observe(self, name: str, seconds: float) -> None:
        """Record an externally measured duration into ``name``'s
        histogram (same aggregate a ``span`` produces)."""
        if not self.enabled:
            return
        with self._lock:
            s = self._spans.get(name)
            if s is None:
                s = self._spans[name] = Histogram()
            s.add(seconds)

    def quantile(self, name: str, q: float) -> float:
        """Bucket-resolution quantile of one span's histogram (0.0
        for a span never observed — the always-on serving path must
        be able to probe a quantile without try/except)."""
        with self._lock:
            s = self._spans.get(name)
            return s.quantile(q) if s is not None else 0.0

    # -- counters / gauges ----------------------------------------------
    def count(self, name: str, n: int = 1,
              labels: Optional[Dict[str, Any]] = None) -> None:
        if not self.enabled:
            return
        key = _labeled(name, labels)
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + n

    def gauge(self, name: str, value: float,
              labels: Optional[Dict[str, Any]] = None) -> None:
        if not self.enabled:
            return
        key = _labeled(name, labels)
        with self._lock:
            self._gauges[key] = value

    def counters(self, prefix: str = "") -> Dict[str, int]:
        """Counter snapshot, optionally filtered by name prefix —
        e.g. ``counters("router.relay")`` for the relay path or
        ``counters("replica.probe")`` for the retry schedule (the
        partition-tolerance counters: ``router.dial_retries``,
        ``router.predict_probes``, ``router.relay_*``,
        ``replica.probe_retries``, ``replica.anti_entropy_rounds`` —
        a stable contract, see README "Observability")."""
        with self._lock:
            return {
                k: v for k, v in sorted(self._counters.items())
                if k.startswith(prefix)
            }

    # -- reporting -------------------------------------------------------
    def report(self) -> Dict[str, Any]:
        """One plain JSON-ready dict — the shared schema the JSON
        snapshot, the Prometheus exposition, and ``bench.py``'s
        embedded evidence all read."""
        with self._lock:
            spans = {
                k: s.summary() for k, s in sorted(self._spans.items())
            }
            return {
                "spans": spans,
                "counters": dict(sorted(self._counters.items())),
                "gauges": dict(sorted(self._gauges.items())),
            }

    def to_json(self) -> str:
        return json.dumps(self.report())

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()
            self._counters.clear()
            self._gauges.clear()


_tracer = Tracer(enabled=False)


def get_tracer() -> Tracer:
    return _tracer


def set_tracer(tracer: Tracer) -> Tracer:
    global _tracer
    _tracer = tracer
    return tracer
