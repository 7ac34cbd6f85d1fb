"""The port's tracer spans on the cold path and the server's paths, and
the spans as ``torch.profiler`` ranges, on the CPU.

A traced replay reports ``columns``, ``decode.parse``/``decode.dedup``
inside ``decode`` and one span a staging pass inside ``pack``, and
converges byte for byte as an untraced one. Under a profiler every span
is a ``crdt.<name>`` range nested in its parent's, whether or not the
tracer is on; with neither on a span is the shared no-op. A
``MultiDocServer`` records one ``digest`` a read, and its tick timeline
one record a tick whose wall time holds the tick's spans.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from crdt_tpu_torch.models import traces
from crdt_tpu_torch.models.multidoc import MultiDocServer
from crdt_tpu_torch.models.replay import replay_trace
from crdt_tpu_torch.obs import tracer as tracer_mod
from crdt_tpu_torch.obs.timeline import TickTimeline, set_timeline
from crdt_tpu_torch.obs.tracer import Tracer, get_tracer, set_tracer
from crdt_tpu_torch.ops import staging

PACK_PASSES = ("pack.ids", "pack.rights", "pack.split", "pack.maps",
               "pack.siblings", "pack.encode")
NEW_REPLAY_SPANS = ("columns", "decode.parse", "decode.dedup") + PACK_PASSES


@pytest.fixture
def traced():
    """An enabled tracer installed for the test, the disabled one
    restored after it."""
    tr = set_tracer(Tracer(enabled=True))
    yield tr
    set_tracer(Tracer(enabled=False))


@pytest.fixture(scope="module")
def blobs():
    return traces.build_trace(24, 40, seed=5)


def _total(spans, name):
    return spans[name]["total_s"]


def test_traced_replay_reports_every_new_span(blobs, traced):
    plain_tracer = Tracer(enabled=False)
    set_tracer(plain_tracer)
    want = replay_trace(blobs, device="cpu")
    set_tracer(traced)
    got = replay_trace(blobs, device="cpu")
    assert got.cache == want.cache
    assert got.snapshot == want.snapshot
    assert plain_tracer.report()["spans"] == {}
    spans = traced.report()["spans"]
    for name in NEW_REPLAY_SPANS:
        assert spans[name]["count"] == 1, name
    assert (_total(spans, "decode.parse") + _total(spans, "decode.dedup")
            <= _total(spans, "decode"))
    assert (sum(_total(spans, p) for p in PACK_PASSES)
            <= _total(spans, "pack"))


def test_a_pass_that_does_not_run_records_nothing(blobs, traced,
                                                  monkeypatch):
    monkeypatch.setenv("CRDT_TPU_CHAIN_SPLIT", "0")
    assert staging.chain_split_width() == 0
    replay_trace(blobs, device="cpu")
    spans = traced.report()["spans"]
    assert "pack.split" not in spans
    assert spans["pack.ids"]["count"] == spans["pack"]["count"] == 1


def _ranges(prof) -> dict:
    """``crdt.*`` range name -> list of (start, end) on the profiler's
    clock."""
    out: dict = {}
    for e in prof.events():
        if e.name.startswith("crdt."):
            out.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    return out


def _inside(child, parent) -> bool:
    return parent[0] <= child[0] and child[1] <= parent[1]


@pytest.mark.parametrize("tracer_on", [False, True])
def test_spans_are_nested_profiler_ranges(blobs, tracer_on):
    tr = set_tracer(Tracer(enabled=tracer_on))
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            replay_trace(blobs, device="cpu")
    finally:
        set_tracer(Tracer(enabled=False))
    r = _ranges(prof)
    for parent, child in (("crdt.decode", "crdt.decode.parse"),
                          ("crdt.decode", "crdt.decode.dedup"),
                          ("crdt.pack", "crdt.pack.ids"),
                          ("crdt.pack", "crdt.pack.rights")):
        (p,), (c,) = r[parent], r[child]
        assert _inside(c, p), (child, c, parent, p)
    # one range a span: the converge's hand-written ranges are gone
    assert len(r["crdt.converge.dispatch"]) == 1
    assert len(r["crdt.converge.fetch"]) == 1
    assert (set(tr.report()["spans"]) >= set(NEW_REPLAY_SPANS)) == tracer_on


def test_span_is_the_shared_no_op_with_profiler_and_tracer_off():
    assert not torch.autograd.profiler._is_profiler_enabled
    assert Tracer(enabled=False).span("decode") is tracer_mod._NULL_SPAN
    assert get_tracer().span("pack.ids") is tracer_mod._NULL_SPAN


def test_span_reraises_and_closes_its_range():
    tr = Tracer(enabled=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(KeyError):
            with tr.span("outer"):
                raise KeyError("x")
        with tr.span("after"):
            pass
    r = _ranges(prof)
    (outer,), (after,) = r["crdt.outer"], r["crdt.after"]
    assert outer[1] <= after[0]
    assert tr.report()["spans"]["outer"]["count"] == 1


def _server_with_docs(n_docs=4):
    docs = traces.build_doc_trace(n_docs, 24, 0, 0, seed=3)
    srv = MultiDocServer(device="cpu")
    for d, bs in docs.items():
        srv.submit_many(d, bs)
    return srv, sorted(docs)


def test_server_records_a_digest_a_read_and_a_tick_a_tick(traced):
    tl = set_timeline(TickTimeline(enabled=True))
    try:
        srv, names = _server_with_docs()
        srv.tick()          # converges every doc
        srv.tick()          # an idle tick: the early return
        reads = names + names[:2]
        for d in reads:
            srv.digest(d)
        with pytest.raises(KeyError):
            srv.digest("no such doc")
    finally:
        set_timeline(TickTimeline(enabled=False))
    spans = traced.report()["spans"]
    ticks = tl.records()
    assert len(ticks) == 2
    assert "tick" not in spans
    assert spans["digest"]["count"] == len(reads) + 1
    assert spans["columns"]["count"] == len(names)
    # the tick's wall time encloses the spans it ran (one clock)
    assert ticks[0]["wall_s"] >= spans["pack"]["total_s"]


def test_server_records_nothing_with_the_tracer_off():
    tr = set_tracer(Tracer(enabled=False))
    srv, names = _server_with_docs(2)
    srv.tick()
    srv.digest(names[0])
    assert tr.report()["spans"] == {}
