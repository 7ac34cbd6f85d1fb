"""The port's multi-tenant server (``MultiDocServer``) against the
reference's, on the CPU.

The same submissions go through ``crdt_tpu.models.multidoc.
MultiDocServer`` and ``crdt_tpu_torch.models.multidoc.MultiDocServer(
device="cpu")``, tick by tick, on the shapes of tests/test_multidoc.py:
after every tick both servers must agree on every ``TickReport`` field,
every doc's canonical digest, cache and op count, the shed, eviction and
fallback counters and the resident ledger. Around the server: the
admission budget, fairness order, dispatch bin-packing and resident
budget (``guard/tenant.py``), ``cache_digest``, the multi-doc sentinel
over the port's server, and the multi-tenant trace generators, byte-equal
to ``bench.py``'s.
"""

from collections import deque

import numpy as np
import pytest
import torch

import bench
from crdt_tpu.guard import tenant as ref_tenant
from crdt_tpu.models.multidoc import MultiDocServer as RefServer
from crdt_tpu.models.multidoc import cache_digest as ref_digest
from crdt_tpu.ops import shard as ref_shard
from crdt_tpu_torch.guard import tenant
from crdt_tpu_torch.models import traces
from crdt_tpu_torch.models.multidoc import MultiDocServer, cache_digest
from crdt_tpu_torch.obs import Tracer, get_tracer, set_tracer
from crdt_tpu_torch.obs.sentinel import MultiDocSentinel
from tests.test_multidoc import DocStream, doc_blobs


@pytest.fixture(autouse=True)
def _no_ambient_sharding(monkeypatch):
    monkeypatch.delenv(ref_shard.SHARD_ENV, raising=False)
    monkeypatch.delenv(ref_shard.MIN_ROWS_ENV, raising=False)


def _pair(**kw):
    """The reference server and the port's on the CPU, same config."""
    return RefServer(**kw), MultiDocServer(device="cpu", **kw)


def assert_same_servers(ref, port, docs=None) -> None:
    """Every per-doc and per-server observable the tick leaves."""
    docs = ref.doc_ids() if docs is None else docs
    assert port.doc_ids() == ref.doc_ids()
    for d in docs:
        assert port.digest(d) == ref.digest(d), d
        assert port.cache(d) == ref.cache(d), d
        assert port._docs[d].n_ops == ref._docs[d].n_ops, d
        assert port.is_resident(d) == ref.is_resident(d), d
    assert port.doc_digests() == ref.doc_digests()
    for name in ("shed_count", "shed_bytes", "eviction_count",
                 "delta_fallback_count", "ticks", "max_rows"):
        assert getattr(port, name) == getattr(ref, name), name
    assert port.resident_doc_count() == ref.resident_doc_count()
    assert port.resident_bytes_total() == ref.resident_bytes_total()
    assert port.resident_peak_bytes() == ref.resident_peak_bytes()
    assert port.pending_bytes() == ref.pending_bytes()


def tick_both(ref, port) -> tuple:
    a, b = ref.tick(), port.tick()
    assert tuple(b) == tuple(a)
    return a, b


# ---------------------------------------------------------------------------
# guard/tenant.py and cache_digest
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tenant_budget_order_and_packing_match_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        blobs = [bytes(int(rng.integers(1, 300)))
                 for _ in range(int(rng.integers(0, 12)))]
        mb, mu = int(rng.integers(1, 2000)), int(rng.integers(1, 8))
        a, b = deque(blobs), deque(blobs)
        ra, pa = ref_tenant.TenantBudget(mb, mu), tenant.TenantBudget(mb, mu)
        if rng.random() < 0.5:
            ob, ou = int(rng.integers(1, 900)), int(rng.integers(1, 4))
            ra.set_override("t", ob, ou)
            pa.set_override("t", ob, ou)
            assert pa.limits("t") == ra.limits("t")
        assert pa.trim(b, tenant="t") == ra.trim(a, tenant="t")
        assert list(b) == list(a)
        sizes = [(f"d{i}", int(rng.integers(0, 400)))
                 for i in range(int(rng.integers(0, 15)))]
        cap = int(rng.integers(1, 600))
        assert tenant.pack_batches(sizes, cap) == \
            ref_tenant.pack_batches(sizes, cap)
        served = {d: int(rng.integers(-1, 5)) for d, _ in sizes}
        dirty = [d for d, _ in sizes if rng.random() < 0.7]
        assert tenant.fair_order(dirty, served) == \
            ref_tenant.fair_order(dirty, served)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_resident_budget_fits_matches_reference(seed):
    rng = np.random.default_rng(seed)
    budgets = [None, int(rng.integers(500, 3000))]
    for max_bytes in budgets:
        ref, port = (ref_tenant.ResidentBudget(max_bytes),
                     tenant.ResidentBudget(max_bytes))
        evicted = {"ref": [], "port": []}
        for step in range(40):
            d = f"d{int(rng.integers(0, 8))}"
            nbytes = int(rng.integers(1, 900))
            op = rng.random()
            if op < 0.5:
                ref.set_doc(d, nbytes)
                port.set_doc(d, nbytes)
            elif op < 0.7:
                ref.drop_doc(d)
                port.drop_doc(d)
            else:
                lru = sorted(set(ref._bytes) - {d})

                def evict(budget, log):
                    def go(x):
                        log.append(x)
                        budget.drop_doc(x)
                    return go

                got = port.fits(nbytes, lru=list(lru),
                                evict=evict(port, evicted["port"]))
                want = ref.fits(nbytes, lru=list(lru),
                                evict=evict(ref, evicted["ref"]))
                assert got == want
            ref.note_peak()
            port.note_peak()
            assert (port.total, port.peak, port.docs()) == \
                (ref.total, ref.peak, ref.docs())
        assert evicted["port"] == evicted["ref"]


def _nested(rng, depth=0):
    r = rng.random()
    if depth > 3 or r < 0.3:
        return [int(rng.integers(-5, 5)), "s%d" % rng.integers(0, 9),
                None, True, 1.5, b"\x01"][int(rng.integers(0, 6))]
    if r < 0.65:
        return {f"k{int(rng.integers(0, 20))}": _nested(rng, depth + 1)
                for _ in range(int(rng.integers(0, 5)))}
    return [_nested(rng, depth + 1) for _ in range(int(rng.integers(0, 5)))]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_cache_digest_matches_reference_on_nested_caches(seed):
    rng = np.random.default_rng(seed)
    for _ in range(30):
        cache = {f"r{i}": _nested(rng) for i in range(int(rng.integers(0, 4)))}
        assert cache_digest(cache) == ref_digest(cache)
        shuffled = dict(reversed(list(cache.items())))
        assert cache_digest(shuffled) == cache_digest(cache)


# ---------------------------------------------------------------------------
# the server, tick by tick against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_docs", [2, 3, 17])
def test_server_ticks_match_reference(n_docs):
    """Mixed LWW/YATA docs with deletes, right origins and shared raw
    client ids, plus empty docs, through bin-packed batches; then a
    redelivery tick and a promotion tick."""
    docs = {f"d{i:02d}": doc_blobs(i, K=12 + (i % 5), rights=(i % 3 == 1),
                                   deletes=(i % 2 == 0))
            for i in range(n_docs)}
    ref, port = _pair(max_rows_per_dispatch=160)
    for srv in (ref, port):
        for d, bs in docs.items():
            srv.submit_many(d, bs)
        srv.submit_many("empty", [])
    rep, _ = tick_both(ref, port)
    assert rep.docs == n_docs and rep.dispatches >= 1
    assert_same_servers(ref, port)
    # redelivery of every doc's history: the second touch promotes
    for srv in (ref, port):
        for d, bs in docs.items():
            srv.submit_many(d, bs)
    rep, _ = tick_both(ref, port)
    assert rep.promotions == n_docs
    assert_same_servers(ref, port)


def test_unpacked_server_matches_reference():
    docs = {f"d{i}": doc_blobs(i, K=10, rights=(i == 1)) for i in range(4)}
    ref, port = _pair(pack_docs=False, delta_ticks=False)
    for srv in (ref, port):
        for d, bs in docs.items():
            srv.submit_many(d, bs)
    rep, _ = tick_both(ref, port)
    assert rep.dispatches == 4 and rep.batches == (1, 1, 1, 1)
    assert_same_servers(ref, port)


def test_flooding_tenant_matches_reference():
    normal = {f"n{i}": doc_blobs(i, K=12) for i in range(5)}
    flood = [doc_blobs(50 + j, n_clients=1, K=30, shared_clients=False)[0]
             for j in range(10)]
    ref, port = _pair(max_rows_per_dispatch=512,
                      tenant_max_pending_bytes=1200,
                      tenant_max_pending_updates=3)
    shed = {}
    for name, srv in (("ref", ref), ("port", port)):
        for d, bs in normal.items():
            srv.submit_many(d, bs)
        shed[name] = [srv.submit("flooder", b) for b in flood]
    assert shed["port"] == shed["ref"] and sum(shed["port"]) > 0
    tick_both(ref, port)
    assert_same_servers(ref, port)
    # sheds are breaches by definition; the route mix is deterministic
    got, want = (srv.slo.report()["tenants"]["flooder"] for srv in (port, ref))
    assert got["routes"] == want["routes"] and got["routes"]["shed"] > 0


def test_delta_ticks_match_reference():
    streams = {f"d{i}": (DocStream(i, n_clients=1 + i % 3),
                         DocStream(i, n_clients=1 + i % 3))
               for i in range(5)}
    ref, port = _pair()
    for t in range(5):
        for d, (sr, sp) in streams.items():
            kw = dict(deletes=(t == 2), mid_insert=(t == 3))
            k = 12 if t == 0 else 3
            ref.submit(d, sr.delta(k, **kw))
            port.submit(d, sp.delta(k, **kw))
        rep, _ = tick_both(ref, port)
        assert_same_servers(ref, port)
    assert rep.delta_docs == 5


def test_offset_clock_fallback_matches_reference():
    sr, sp = DocStream(5, n_clients=1), DocStream(5, n_clients=1)
    ref, port = _pair()
    for k, gap in ((8, 0), (3, 0), (4, 5), (2, 0)):
        for s in (sr, sp):
            s.clock[s.clients[0]] += gap
        ref.submit("a", sr.delta(k))
        port.submit("a", sp.delta(k))
        tick_both(ref, port)
        assert_same_servers(ref, port)
    assert port.delta_fallback_count == 1


def test_lru_eviction_matches_reference():
    from crdt_tpu.models.incremental import IncrementalReplay as RefReplay

    budget = int(RefReplay.estimate_resident_bytes(64) * 2.5)
    ref, port = _pair(resident_max_bytes=budget)
    streams = {f"w{i}": (DocStream(i, n_clients=1), DocStream(i, n_clients=1))
               for i in range(6)}
    waves = [["w0", "w1", "w2"], ["w3", "w4", "w5"]]
    for docs, k in ((waves[0], 12), (waves[0], 3), (waves[1], 12),
                    (waves[1], 3), (waves[1], 3), (waves[0], 3)):
        for d in docs:
            ref.submit(d, streams[d][0].delta(k))
            port.submit(d, streams[d][1].delta(k))
        tick_both(ref, port)
        assert_same_servers(ref, port)
    assert port.eviction_count > 0
    assert port.resident_peak_bytes() <= budget


def test_serve_with_ingest_hook_matches_reference():
    streams = {f"s{i}": (DocStream(i), DocStream(i)) for i in range(4)}

    def source(which):
        for t in range(5):
            yield [(d, s[which].delta(8 if t == 0 else 2))
                   for d, s in streams.items()]

    ref, port = _pair()
    a = ref.serve(source(0), max_ticks=12)
    b = port.serve(source(1), max_ticks=12)
    assert tuple(b) == tuple(a)
    assert b.delta_docs > 0
    assert_same_servers(ref, port)
    for d in streams:
        assert port._docs[d].blobs == ref._docs[d].blobs


def test_multidoc_sentinel_over_the_port_server():
    """The port's sentinel over two port servers: a fork in one doc is
    attributed to that doc alone, a lagging doc is lag."""
    from crdt_tpu_torch.codec import v1
    from crdt_tpu_torch.core.ids import DeleteSet
    from crdt_tpu_torch.core.records import ItemRecord

    tracer = set_tracer(Tracer(enabled=True))
    try:
        shared = {f"d{i}": doc_blobs(i, K=12) for i in range(4)}
        a = MultiDocServer(device="cpu")
        b = MultiDocServer(device="cpu")
        for d, bs in shared.items():
            a.submit_many(d, bs)
            b.submit_many(d, bs)
        forked = doc_blobs(2, K=12)
        forked[0] = v1.encode_update([ItemRecord(
            client=10, clock=k, parent_root="m0", key="k0",
            content=f"forked{k}") for k in range(12)], DeleteSet())
        b._docs.pop("d2")
        b.submit_many("d2", forked)
        b.submit_many("d3", [v1.encode_update([ItemRecord(
            client=777, clock=k, parent_root="m0", key="kq", content=k)
            for k in range(4)], DeleteSet())])
        a.tick()
        b.tick()
        sen = MultiDocSentinel(a, topic="t", replica="a")
        peer = MultiDocSentinel(b, topic="t", replica="b")
        events = sen.check("b", peer.beacon_payload())
        assert [(e["doc"], e["kind"]) for e in events] == \
            [("d2", "divergence")]
        counters = get_tracer().counters()
        assert counters.get("sentinel.doc_divergence", 0) == 1
        assert counters.get("sentinel.doc_lag", 0) == 1
    finally:
        set_tracer(Tracer(enabled=False))


def test_shards_above_one_raise_naming_item_9(monkeypatch):
    # shards above one (ROADMAP.md queue A item 9) serve a cold tick
    # through the sharded route, digests equal to one device's. The
    # name is the one this test had while the route raised, kept so the
    # test's history stays one line.
    from crdt_tpu_torch.ops import shard as shard_ops

    monkeypatch.setenv(shard_ops.MIN_ROWS_ENV, "1")
    docs = {f"d{i}": doc_blobs(i, K=12) for i in range(4)}
    got = {}
    for shards in (2, 1):
        srv = MultiDocServer(shards=shards, device="cpu")
        routes = []
        enqueue = srv._dispatch_async

        def spy(comb, _enqueue=enqueue, _routes=routes):
            out = _enqueue(comb)
            _routes.append(out[0])
            return out

        srv._dispatch_async = spy
        for d, blobs in docs.items():
            srv.submit_many(d, blobs)
        srv.tick()
        assert routes == (["shard"] if shards == 2 else ["packed"])
        got[shards] = {d: srv.digest(d) for d in docs}
    assert got[2] == got[1]


def test_no_card_raises_at_construction(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiDocServer()
    from crdt_tpu_torch.ops.resident import ResidentPool

    with pytest.raises(RuntimeError, match="no CUDA device"):
        ResidentPool()


def test_multitenant_traces_byte_equal_to_bench():
    assert traces.build_doc_trace(6, 64, 2, 256) == \
        bench.build_doc_trace(6, 64, 2, 256)
    assert traces.build_doc_trace(3, 30, 1, 100, seed=5) == \
        bench.build_doc_trace(3, 30, 1, 100, seed=5)
    for i in (0, 7, 500):
        a, b = traces._SteadyStream(i), bench._SteadyStream(i)
        for n in (1, 5, 64, 300):
            assert a.delta(n) == b.delta(n)
