"""The port's scrape surfaces against the reference's: the Prometheus
and JSON export (``crdt_tpu_torch.obs.export``), the HTTP endpoint
(``obs.http.ObsHTTPServer``), the fleet collector (``obs.collector``),
the propagation analysis core and ``torch_profile``.

Both packages' process-global tracer, recorder, timeline and control
plane are filled by the same calls on the same fake clock, so each
package's server must answer every path with the same status and the
same body, byte for byte. The analysis core runs on events recorded
from a mixed swarm of port and reference routers.
"""

import json
import os
import time
import urllib.error
import urllib.request

import pytest
import torch

from crdt_tpu.net.replica import Replica as RefReplica
from crdt_tpu.net.udp_router import UdpRouter as RefUdpRouter
from crdt_tpu.obs import collector as ref_collector
from crdt_tpu.obs import control as ref_control
from crdt_tpu.obs import export as ref_export
from crdt_tpu.obs import http as ref_http
from crdt_tpu.obs import propagation as ref_propagation
from crdt_tpu.obs import recorder as ref_recorder
from crdt_tpu.obs import timeline as ref_timeline
from crdt_tpu.obs import tracer as ref_tracer
from crdt_tpu_torch.net import Replica, UdpRouter, pump
from crdt_tpu_torch.obs import (collector, control, export, http, propagation,
                                recorder, timeline, torch_profile, tracer)

PORT = dict(tracer=tracer, recorder=recorder, timeline=timeline,
            propagation=propagation, control=control, export=export,
            http=http, collector=collector)
REF = dict(tracer=ref_tracer, recorder=ref_recorder, timeline=ref_timeline,
           propagation=ref_propagation, control=ref_control,
           export=ref_export, http=ref_http, collector=ref_collector)


class _Clock:
    """A fake ``time.perf_counter`` / ``time.monotonic``: each call
    advances by a fixed, call-dependent step."""

    def __init__(self):
        self.n = 0

    def __call__(self):
        self.n += 1
        return 100.0 + self.n * 0.0007 + (self.n % 7) * 1e-5


def _fill(pkg, monkeypatch):
    """Install fresh obs singletons in ``pkg`` and fill them with the
    same calls on a fresh fake clock; returns (tracer, controller)."""
    clock = _Clock()
    monkeypatch.setattr(time, "perf_counter", clock)
    monkeypatch.setattr(time, "monotonic", clock)
    tr = pkg["tracer"].set_tracer(pkg["tracer"].Tracer(enabled=True))
    rec = pkg["recorder"].set_recorder(
        pkg["recorder"].FlightRecorder(enabled=True))
    tl = pkg["timeline"].set_timeline(
        pkg["timeline"].TickTimeline(enabled=True))
    # counters, gauges and spans, labelled, with sanitization
    # collisions across names and across sections
    tr.count("replica.updates_applied", 7)
    tr.count("guard.a-b", 3)
    tr.count("guard.a_b", 4)
    tr.count("depth", 1)
    tr.gauge("depth", 2.5)
    tr.count("slo.breaches", 1, labels={"tenant": "a"})
    tr.count("slo.breaches", 2, labels={"tenant": 'b"q'})
    tr.gauge("tenant.pending_bytes", 4096)
    tr.count("9lives", 9)
    for v in (1e-6, 2e-5, 3e-4, 4e-3, 5e-2, 0.6, 7.0):
        tr.observe("converge.dispatch", v)
    with tr.span("net.poll"):
        pass
    tr.observe("x-y.z", 0.01)
    tr.observe("x_y.z", 0.02)
    # recorder events: traced sends and receives, a divergence
    rec.record("update.send", topic="room", replica="p0", size=10,
               digest="d1", tid=[1, 1, 100.0], hop=0,
               path=[["p0", "direct", 0]])
    rec.record("update.recv", topic="room", peer="p1", size=10,
               digest="d1", tid=[1, 1, 100.0], hop=1,
               path=[["p0", "direct", 0]])
    rec.record("sync.answer", topic="room", peer="p2", size=5,
               tid=[2, 9, 100.1], hop=0, path=[["p2", "sync_answer", 0]])
    rec.record("divergence", topic="room", local_digest="xx",
               peer_digest="yy")
    rec.record("fault.drop", src=1, dst=2, seq=0, size=3, digest="e")
    # two ticks with phases and a dispatch window
    for t in range(2):
        tl.tick_begin(t, label=f"ops[{t}]")
        with tl.phase("edit"):
            tok = tl.dispatch_begin()
            t1 = time.perf_counter()
            tl.dispatch_end(tok, t1, t1 + 0.0004)
        with tl.phase("pump"):
            pass
        tl.tick_end()
    ctrl = pkg["control"].Controller(cooldown_ticks=2)
    for ct in range(4):
        ctrl.observe({
            "tick": ct,
            "budget": {"max_bytes": 2048, "max_updates": 4},
            "tenants": {"flood!": {"burn": 1.0, "shed": 8 * (ct + 1),
                                   "pending_bytes": 4096}},
        })
    monkeypatch.undo()
    return tr, ctrl


@pytest.fixture
def filled(monkeypatch):
    """Both packages' singletons filled alike; tracers then disabled so
    that serving and scraping leave their reports as they are."""
    out = {}
    for name, pkg in (("port", PORT), ("reference", REF)):
        tr, ctrl = _fill(pkg, monkeypatch)
        tr.enabled = False
        out[name] = (tr, ctrl)
    yield out
    for pkg in (PORT, REF):
        pkg["tracer"].set_tracer(pkg["tracer"].Tracer(enabled=False))
        pkg["recorder"].set_recorder(
            pkg["recorder"].FlightRecorder(enabled=False))
        pkg["timeline"].set_timeline(
            pkg["timeline"].TickTimeline(enabled=False))


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------


def test_to_prometheus_byte_equal(filled):
    (tr, _), (ref_tr, _) = filled["port"], filled["reference"]
    assert tr.report() == ref_tr.report()
    text = export.to_prometheus(tr.report())
    assert text == ref_export.to_prometheus(ref_tr.report())
    assert export.to_prometheus() == text  # the global tracer's
    assert export.to_prometheus(tr.report(), namespace="x") == \
        ref_export.to_prometheus(ref_tr.report(), namespace="x")
    # the collisions really were disambiguated
    assert "crdt_guard_a_b_" in text and "crdt_depth_" in text


def test_snapshot_json_byte_equal(filled):
    (tr, _), (ref_tr, _) = filled["port"], filled["reference"]
    assert export.snapshot_json(tr.report()) == \
        ref_export.snapshot_json(ref_tr.report())
    assert export.snapshot_json() == ref_export.snapshot_json()


@pytest.mark.parametrize("name", ["a.b-c", "0x", "ok_name", "é:z", "",
                                  "a{b}", "converge.dispatch"])
def test_sanitize_metric_name_equal(name):
    assert export.sanitize_metric_name(name) == \
        ref_export.sanitize_metric_name(name)


# ---------------------------------------------------------------------------
# the HTTP endpoint
# ---------------------------------------------------------------------------


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


PATHS = ["/metrics", "/snapshot", "/events", "/events?kind=update.recv",
         "/events?doc=room&limit=2", "/events?peer=p1", "/events?limit=0",
         "/events?limit=x", "/timeline", "/control", "/control?limit=1",
         "/nope", "/fleet"]


def test_http_endpoints_equal_reference(filled):
    servers = {}
    for name, pkg in (("port", PORT), ("reference", REF)):
        ctrl = filled[name][1]
        servers[name] = pkg["http"].ObsHTTPServer(
            port=0, control=ctrl,
            snapshot_extra=lambda: {"extra": {"k": [1, 2]}}).start()
    try:
        for path in PATHS:
            got = _get(servers["port"].url + path)
            want = _get(servers["reference"].url + path)
            assert got == want, path
            assert got[0] == (404 if path in ("/nope", "/fleet") else 200)
    finally:
        for s in servers.values():
            s.stop()


def test_http_fleet_routes_equal_reference(filled):
    servers = {}
    for name, pkg in (("port", PORT), ("reference", REF)):
        col = pkg["collector"].FleetCollector()
        col.push("p0", snapshot={"tracer": {"counters": {"a": 1},
                                            "gauges": {}}},
                 events=[], timeline={"traceEvents": [
                     {"name": "process_name", "ph": "M", "ts": 0,
                      "pid": 77, "tid": 0, "args": {"name": "x"}}]})
        servers[name] = pkg["http"].ObsHTTPServer(
            port=0, collector=col).start()
    try:
        for path in ("/fleet?scrape=0", "/fleet/timeline", "/nope",
                     "/control"):
            assert _get(servers["port"].url + path) == \
                _get(servers["reference"].url + path), path
    finally:
        for s in servers.values():
            s.stop()


def test_collector_federates_port_and_reference_servers(filled):
    """A port collector and a reference collector, each federating one
    port server and one reference server (and a dead address), give
    equal fleet reports and equal merged Perfetto traces."""
    servers = {name: pkg["http"].ObsHTTPServer(
        port=0, control=filled[name][1]).start()
        for name, pkg in (("port", PORT), ("reference", REF))}
    try:
        reports = []
        for pkg in (PORT, REF):
            col = pkg["collector"].FleetCollector()
            col.add_proc("p-port", servers["port"].url)
            col.add_proc("p-ref", servers["reference"].url)
            col.add_proc("dead", "http://127.0.0.1:1")
            ok = col.scrape()
            assert ok == {"dead": False, "p-port": True, "p-ref": True}
            reports.append((col.fleet_report(), col.merged_perfetto(),
                            col.fleet_advice()))
        assert reports[0] == reports[1]
        rep = reports[0][0]
        assert rep["procs"] == ["p-port", "p-ref"]
        assert rep["stale_procs"] == ["dead"]
        assert rep["divergence"]["divergences"] == 2
        assert {e["pid"] for e in reports[0][1]["traceEvents"]} == {1, 2}
    finally:
        for s in servers.values():
            s.stop()


def test_merge_perfetto_equal_reference():
    def trace(label):
        return {"traceEvents": [
            {"name": "process_name", "ph": "M", "ts": 0, "pid": 4242,
             "tid": 0, "args": {"name": label}},
            {"name": "tick[0]", "ph": "X", "ts": 0, "dur": 5, "pid": 4242,
             "tid": 1}, "junk"]}

    traces = {"p1": trace("x"), "p0": trace("y"), "p2": None}
    assert collector.merge_perfetto(traces) == \
        ref_collector.merge_perfetto(traces)


# ---------------------------------------------------------------------------
# the analysis core on a mixed swarm's events
# ---------------------------------------------------------------------------


def _swarm_events():
    """Events of a mixed swarm (a port rendezvous, a port replica and a
    reference replica, both packages recording), each tagged with its
    process as the collector tags them, plus one divergence."""
    recs = [recorder.set_recorder(recorder.FlightRecorder(enabled=True)),
            ref_recorder.set_recorder(
                ref_recorder.FlightRecorder(enabled=True))]
    propagation.set_propagation(propagation.PropagationLedger())
    ref_propagation.set_propagation(ref_propagation.PropagationLedger())
    boot = UdpRouter(rendezvous=True)
    pr = UdpRouter(bootstrap=[boot.addr])
    rr = RefUdpRouter(bootstrap=[boot.addr])
    routers = [boot, pr, rr]
    try:
        p = Replica(pr, topic="room", client_id=1)
        r = RefReplica(rr, topic="room", client_id=2)
        pump(routers, timeout_s=20.0)
        for i in range(6):
            p.set("m", f"p{i}", i)
            r.push("l", f"r{i}")
            pump(routers, timeout_s=20.0)
        late = UdpRouter(bootstrap=[boot.addr])
        routers.append(late)
        Replica(late, topic="room", client_id=3)
        pump(routers, timeout_s=20.0)
        assert dict(p.c) == dict(r.c)
    finally:
        for x in routers:
            x.close()
        recorder.set_recorder(recorder.FlightRecorder(enabled=False))
        ref_recorder.set_recorder(ref_recorder.FlightRecorder(enabled=False))
    events = [dict(e, proc=proc) for proc, rec in zip(("port", "ref"), recs)
              for e in rec.events()]
    events.append({"ts": events[-1]["ts"] + 1, "kind": "divergence",
                   "topic": "room", "local_digest": "a", "peer_digest": "b",
                   "proc": "port"})
    events.sort(key=lambda e: (e.get("ts", 0.0), e["proc"]))
    return json.loads(json.dumps(events, default=str))


def test_analysis_core_equal_on_mixed_swarm_events():
    events = _swarm_events()
    kinds = {e["kind"] for e in events}
    assert {"update.send", "update.recv", "sync.answer"} <= kinds
    lat = propagation.pair_latency(events)
    assert lat == ref_propagation.pair_latency(events)
    assert lat["paths"]["traced_recvs"] > 0
    assert lat["paths"]["pair_rate"] == 1.0
    assert propagation.reconstruct_paths(events) == \
        ref_propagation.reconstruct_paths(events)
    div = propagation.correlate_divergences(events)
    assert div == ref_propagation.correlate_divergences(events)
    assert div["divergences"] == 1
    vals = sorted(float(i) / 7 for i in range(23))
    assert propagation._percentiles(vals) == \
        ref_propagation._percentiles(vals)
    for ev in events[:50] + [{"tid": [{}, 1]}, {"tid": "x"}, {}]:
        assert propagation._tid_key(ev) == ref_propagation._tid_key(ev)


# ---------------------------------------------------------------------------
# torch_profile
# ---------------------------------------------------------------------------


def _profiler_on():
    return torch.autograd.profiler._is_profiler_enabled


def test_torch_profile_writes_a_trace(tmp_path):
    from crdt_tpu_torch.obs import device_annotation

    with torch_profile(str(tmp_path / "prof")) as prof:
        with device_annotation("converge.dispatch"):
            torch.arange(1000).sum()
    assert not _profiler_on()
    (path,) = (tmp_path / "prof").glob("*.pt.trace.json")
    trace = json.loads(path.read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "converge.dispatch" in names
    assert any(e.key == "converge.dispatch" for e in prof.key_averages())


def test_torch_profile_stops_when_the_body_raises(tmp_path):
    with pytest.raises(ZeroDivisionError):
        with torch_profile(str(tmp_path)):
            assert _profiler_on()
            1 / 0
    assert not _profiler_on()
    # a later capture starts cleanly
    with torch_profile(str(tmp_path / "again")):
        torch.ones(3).sum()
    assert not _profiler_on()
    assert len(list((tmp_path / "again").glob("*.json"))) == 1


def test_torch_profile_keeps_the_body_error_when_stop_fails(tmp_path,
                                                            monkeypatch):
    def broken_stop(self):
        raise RuntimeError("stop failed")

    started = []
    orig_stop = torch.profiler.profile.stop
    monkeypatch.setattr(torch.profiler.profile, "stop",
                        lambda self: (started.append(self),
                                      orig_stop(self), broken_stop(self)))
    with pytest.raises(KeyError):
        with torch_profile(str(tmp_path)):
            raise KeyError("body")
    assert started and not _profiler_on()
    assert os.listdir(tmp_path) == []
