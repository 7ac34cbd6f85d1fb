"""Pull-based observability endpoint — stdlib only, zero new deps.

The port's copy of ``crdt_tpu.obs.http``: the same endpoints and
bodies as the reference's.

One background thread serves the four surfaces a fleet scheduler or
an on-call human scrapes while ``MultiDocServer.serve()`` (or any
instrumented process) runs:

- ``GET /metrics``   — the Prometheus text exposition of the
  process-global tracer (:func:`crdt_tpu_torch.obs.export.to_prometheus`).
- ``GET /snapshot``  — JSON: the full tracer report plus whatever
  extra sections the host process registered (the server's per-tenant
  SLO report, timeline summary — ``snapshot_extra``).
- ``GET /events``    — the flight-recorder tail as JSONL, filterable:
  ``?kind=`` (exact event kind), ``?doc=`` (matches an event's
  ``doc`` or ``topic`` field), ``?peer=`` (matches ``peer`` or
  ``replica``), ``?limit=`` (newest N).
- ``GET /timeline``  — the tick-timeline ring as Perfetto
  trace-event JSON (open it at ui.perfetto.dev).
- ``GET /control``   — the control plane's live report (round 22,
  ``control=`` a :class:`crdt_tpu_torch.obs.control.Controller`): config,
  decision/cooldown counters, current setpoints, placement advice,
  and the ledger tail (``?limit=`` rows, default 128).

Reads are snapshots under the producers' own locks (tracer, recorder
and timeline are all thread-safe), so scraping never blocks the tick
loop beyond those sub-microsecond critical sections. The server binds
127.0.0.1 by default and ``port=0`` picks a free port (``.port``
reports the bound one) — tests and bench runs never collide.

    from crdt_tpu_torch.obs.http import ObsHTTPServer
    obs = ObsHTTPServer(port=0, snapshot_extra=lambda: {
        "slo": server.slo.report(),
    })
    obs.start()
    print(obs.url)           # http://127.0.0.1:<port>
    ...
    obs.stop()
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional
from urllib.parse import parse_qs, urlparse


def _filter_events(events, q: Dict[str, list]) -> list:
    kind = q.get("kind", [None])[0]
    doc = q.get("doc", [None])[0]
    peer = q.get("peer", [None])[0]
    limit = q.get("limit", [None])[0]
    out = []
    for e in events:
        if kind is not None and e.get("kind") != kind:
            continue
        if doc is not None and str(e.get("doc", e.get("topic"))) != doc:
            continue
        if peer is not None and \
                str(e.get("peer", e.get("replica"))) != peer:
            continue
        out.append(e)
    if limit is not None:
        try:
            n = max(0, int(limit))
        except ValueError:
            return out
        # newest-N semantics: n=0 means none (out[-0:] would be ALL)
        out = out[max(0, len(out) - n):] if n else []
    return out


class ObsHTTPServer:
    """Scrape endpoint over the process-global obs singletons.

    With ``collector=`` (a :class:`crdt_tpu_torch.obs.collector.
    FleetCollector`), the server additionally exposes the fleet
    surfaces: ``GET /fleet`` (scrape every registered process, then
    the fleet report — proc-labeled registries, live cross-process
    trace pairing and divergence correlation; ``?scrape=0`` reports
    from the last ingest instead) and ``GET /fleet/timeline`` (the
    collector-merged multi-process Perfetto trace)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 snapshot_extra: Optional[
                     Callable[[], Dict[str, Any]]] = None,
                 collector: Optional[Any] = None,
                 control: Optional[Any] = None):
        self._extra = snapshot_extra
        self.collector = collector
        self.control = control
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            # scrapes are high-frequency; server-side request logging
            # to stderr would be pure noise
            def log_message(self, fmt, *args):  # noqa: ARG002
                pass

            def do_GET(self):  # noqa: N802 (http.server contract)
                try:
                    body, ctype, status = outer._route(self.path)
                except Exception as exc:  # never kill the serve loop
                    body = json.dumps(
                        {"error": repr(exc)}
                    ).encode()
                    ctype, status = "application/json", 500
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    # -- routing -------------------------------------------------------

    def _route(self, path: str):
        from crdt_tpu_torch.obs.export import to_prometheus
        from crdt_tpu_torch.obs.recorder import get_recorder
        from crdt_tpu_torch.obs.timeline import get_timeline
        from crdt_tpu_torch.obs.tracer import get_tracer

        u = urlparse(path)
        if u.path == "/metrics":
            return (to_prometheus().encode(),
                    "text/plain; version=0.0.4", 200)
        if u.path == "/snapshot":
            snap: Dict[str, Any] = {"tracer": get_tracer().report()}
            if self._extra is not None:
                snap.update(self._extra() or {})
            return (json.dumps(snap, sort_keys=True, default=str)
                    .encode(), "application/json", 200)
        if u.path == "/events":
            evs = _filter_events(
                get_recorder().events(), parse_qs(u.query)
            )
            text = "\n".join(
                json.dumps(e, sort_keys=True, default=str)
                for e in evs
            )
            if text:
                text += "\n"
            return text.encode(), "application/x-ndjson", 200
        if u.path == "/timeline":
            return (get_timeline().perfetto_json().encode(),
                    "application/json", 200)
        if self.control is not None and u.path == "/control":
            q = parse_qs(u.query)
            try:
                limit = max(0, int(q.get("limit", ["128"])[0]))
            except ValueError:
                limit = 128
            return (json.dumps(
                self.control.report(limit), sort_keys=True,
                default=str,
            ).encode(), "application/json", 200)
        if self.collector is not None and u.path == "/fleet":
            q = parse_qs(u.query)
            if q.get("scrape", ["1"])[0] not in ("0", "false"):
                self.collector.scrape()
            return (json.dumps(
                self.collector.fleet_report(), sort_keys=True,
                default=str,
            ).encode(), "application/json", 200)
        if self.collector is not None and u.path == "/fleet/timeline":
            return (json.dumps(
                self.collector.merged_perfetto()
            ).encode(), "application/json", 200)
        routes = ["/metrics", "/snapshot", "/events", "/timeline"]
        if self.control is not None:
            routes += ["/control"]
        if self.collector is not None:
            routes += ["/fleet", "/fleet/timeline"]
        return (json.dumps({
            "error": "unknown path",
            "routes": routes,
        }).encode(), "application/json", 404)

    # -- lifecycle -----------------------------------------------------

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "ObsHTTPServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                name="crdt-obs-http", daemon=True,
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(timeout=5.0)
            self._thread = None
        self._httpd.server_close()

    def __enter__(self) -> "ObsHTTPServer":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False
