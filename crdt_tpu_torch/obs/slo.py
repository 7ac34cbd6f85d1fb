"""Per-tenant SLO accounting for the multi-tenant serving path.

The round-15 serve() loop made ``MultiDocServer`` a live tick server,
but its user-visible behavior — how long a tenant's update waits
between ingest and being readable — existed only as one aggregate
latency per doc. This ledger (round 18, ROADMAP items 1/2
precondition) closes the loop per blob: every update admitted by
:meth:`crdt_tpu_torch.models.multidoc.MultiDocServer.submit` is stamped,
the settle path ends the *ingest-to-converged* clock, the tick end
(state readable to every consumer) ends *ingest-to-served*, and both
land in per-tenant log2 histograms on the tracer's own bucket edges
(:class:`crdt_tpu_torch.obs.tracer.Histogram` — an SLO report and a
Prometheus scrape bucket identically).

**Objective + breaches.** ``slo_ms`` (constructor, or
``CRDT_TPU_SLO_MS``; default 250 ms) is the ingest-to-served
objective. A blob breaches when it is served later than the
objective — or when it is **shed**: an update trimmed by the
admission budget is never served at all, which misses any finite
objective by definition, so shed counts fold into the breach ledger
(the flooding-tenant acceptance pin: breach == shed == the admission
oracle, while untouched neighbors hold zero). ``burn_rate`` is the
breach fraction over a sliding window of the tenant's most recent
outcomes (served + shed), the gauge an on-call human watches while
the total counters only ever grow.

**Route mix.** Every doc-serve is attributed to the route that
produced it — ``delta`` (resident incremental splice), ``cold``
(full replay through the packed batch, promotions included),
``fallback`` (a packed batch that degraded to per-doc dispatches) —
and sheds ride the same table, so a perpetually-cold or flooding
tenant is diagnosable from metrics alone.

Tracer emission (README "Observability v2" registry; every call is
gated on ``tracer.enabled`` so the ledger adds no tracer cost when
tracing is off): counters ``slo.breaches`` (+ ``slo.breaches{tenant=}``),
``slo.route_delta`` / ``slo.route_cold`` / ``slo.route_fallback`` /
``slo.route_shed`` (labeled per tenant), gauges ``slo.burn_rate``
(worst tenant) + ``slo.burn_rate{tenant=}``, and the
``slo.ingest_to_converged`` / ``slo.ingest_to_served`` latency
histograms (span registry).
"""

from __future__ import annotations

import os
import threading
from collections import deque
from typing import Any, Dict, Iterable, Optional

from crdt_tpu_torch.obs.tracer import Histogram, get_tracer

_SLO_MS_ENV = "CRDT_TPU_SLO_MS"
DEFAULT_SLO_MS = 250.0
DEFAULT_BURN_WINDOW = 128

ROUTES = ("delta", "cold", "fallback", "shed")
_ROUTE_COUNTERS = {
    "delta": "slo.route_delta",
    "cold": "slo.route_cold",
    "fallback": "slo.route_fallback",
    "shed": "slo.route_shed",
}


def _env_slo_ms() -> float:
    raw = os.environ.get(_SLO_MS_ENV, "")
    if raw == "":
        return DEFAULT_SLO_MS
    try:
        return max(0.0, float(raw))
    except ValueError:
        return DEFAULT_SLO_MS


class _TenantSLO:
    __slots__ = ("converged", "served", "breaches", "routes", "window")

    def __init__(self, window: int):
        self.converged = Histogram()
        self.served = Histogram()
        self.breaches = 0
        self.routes = {r: 0 for r in ROUTES}
        # sliding breach window: most recent served/shed outcomes,
        # True = breached (burn rate = mean over the window)
        self.window: deque = deque(maxlen=window)

    def burn_rate(self) -> float:
        if not self.window:
            return 0.0
        return sum(self.window) / len(self.window)


class SLOLedger:
    """Per-tenant ingest-latency objective ledger (see module doc).

    Thread-safe like the tracer (one lock per mutation): the serve()
    loop settles docs while its ingest hook admits more, and an HTTP
    scrape may call :meth:`report` from its own thread at any time.
    """

    def __init__(self, slo_ms: Optional[float] = None, *,
                 burn_window: int = DEFAULT_BURN_WINDOW):
        if slo_ms is None:
            slo_ms = _env_slo_ms()
        self.slo_ms = float(slo_ms)
        self.slo_s = self.slo_ms / 1e3
        self.burn_window = int(burn_window)
        self._lock = threading.Lock()
        self._tenants: Dict[Any, _TenantSLO] = {}

    # -- accounting (called by the serving path) -----------------------

    def _tenant(self, tenant) -> _TenantSLO:
        t = self._tenants.get(tenant)
        if t is None:
            t = self._tenants[tenant] = _TenantSLO(self.burn_window)
        return t

    def converged(self, tenant, latencies_s: Iterable[float],
                  route: str) -> None:
        """Blobs of one tenant just settled (moved from the in-flight
        window into converged history) via ``route``; each latency is
        submit -> settle. The route is counted once per settle batch
        (one doc-serve), the histogram once per blob."""
        lats = list(latencies_s)
        tracer = get_tracer()
        with self._lock:
            t = self._tenant(tenant)
            for dt in lats:
                t.converged.add(dt)
            t.routes[route] += 1
        if tracer.enabled:
            # crdtlint: emits=slo.route_delta,slo.route_cold,slo.route_fallback
            tracer.count(_ROUTE_COUNTERS[route], 1,
                         labels={"tenant": tenant})
            for dt in lats:
                tracer.observe("slo.ingest_to_converged", dt)

    def served(self, tenant, latencies_s: Iterable[float]) -> None:
        """The same blobs became *readable* (tick end); each latency
        is submit -> served, checked against the objective."""
        lats = list(latencies_s)
        breached = 0
        tracer = get_tracer()
        with self._lock:
            t = self._tenant(tenant)
            for dt in lats:
                t.served.add(dt)
                bad = dt > self.slo_s
                t.window.append(bad)
                if bad:
                    breached += 1
            t.breaches += breached
            burn = t.burn_rate()
        if tracer.enabled:
            for dt in lats:
                tracer.observe("slo.ingest_to_served", dt)
            if breached:
                tracer.count("slo.breaches", breached)
                tracer.count("slo.breaches", breached,
                             labels={"tenant": tenant})
            # only the per-tenant gauge here: the global worst-tenant
            # gauge scans every tenant, which would make a tick's
            # served loop O(tenants^2) — it publishes once per tick
            # instead (:meth:`publish_worst`)
            tracer.gauge("slo.burn_rate", burn,
                         labels={"tenant": tenant})

    def shed(self, tenant, n: int = 1) -> None:
        """``n`` of the tenant's pending blobs were trimmed by the
        admission budget: never served, so each one is a breach of
        any finite objective (and a ``shed`` route outcome)."""
        if n <= 0:
            return
        tracer = get_tracer()
        with self._lock:
            t = self._tenant(tenant)
            t.routes["shed"] += n
            t.breaches += n
            for _ in range(n):
                t.window.append(True)
            burn = t.burn_rate()
        if tracer.enabled:
            tracer.count("slo.breaches", n)
            tracer.count("slo.breaches", n, labels={"tenant": tenant})
            # crdtlint: emits=slo.route_shed
            tracer.count(_ROUTE_COUNTERS["shed"], n,
                         labels={"tenant": tenant})
            tracer.gauge("slo.burn_rate", burn,
                         labels={"tenant": tenant})

    # -- reads ---------------------------------------------------------

    def breaches(self, tenant) -> int:
        with self._lock:
            t = self._tenants.get(tenant)
            return t.breaches if t is not None else 0

    def route_counts(self, tenant) -> Dict[str, int]:
        with self._lock:
            t = self._tenants.get(tenant)
            return dict(t.routes) if t is not None \
                else {r: 0 for r in ROUTES}

    def _worst_burn_locked(self) -> float:
        return max(
            (t.burn_rate() for t in self._tenants.values()),
            default=0.0,
        )

    def worst_burn_rate(self) -> float:
        with self._lock:
            return self._worst_burn_locked()

    def publish_worst(self) -> float:
        """Publish the global worst-tenant burn-rate gauge
        (``slo.burn_rate``, unlabeled). One O(tenants) scan — called
        once per tick by the serving loop, never per served blob."""
        worst = self.worst_burn_rate()
        tracer = get_tracer()
        if tracer.enabled:
            tracer.gauge("slo.burn_rate", worst)
        return worst

    def control_snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Cheap per-tenant sensor slice for the control plane
        (round 22): burn rate, shed count, and total breaches per
        tenant — no histograms, so the controller's once-per-tick
        read stays O(tenants). Keys are the ORIGINAL tenant objects
        (the server joins them against its own doc table); the
        controller stringifies for its JSON ledger."""
        with self._lock:
            return {
                k: {
                    "burn": round(t.burn_rate(), 4),
                    "shed": t.routes["shed"],
                    "breaches": t.breaches,
                }
                for k, t in self._tenants.items()
            }

    def report(self) -> Dict[str, Any]:
        """JSON-ready per-tenant summary — the ``/snapshot`` section
        and the ``bench --multitenant`` evidence block."""
        with self._lock:
            tenants = {
                str(k): {
                    "breaches": t.breaches,
                    "burn_rate": round(t.burn_rate(), 4),
                    "routes": dict(t.routes),
                    "ingest_to_converged": t.converged.summary(),
                    "ingest_to_served": t.served.summary(),
                }
                for k, t in sorted(
                    self._tenants.items(), key=lambda kv: str(kv[0])
                )
            }
        return {
            "slo_ms": self.slo_ms,
            "tenants": tenants,
            "total_breaches": sum(
                t["breaches"] for t in tenants.values()
            ),
            "worst_burn_rate": max(
                (t["burn_rate"] for t in tenants.values()),
                default=0.0,
            ),
        }

    def reset(self) -> None:
        with self._lock:
            self._tenants.clear()
