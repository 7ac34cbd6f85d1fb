"""The port's replica layer (``crdt_tpu_torch.net``) against the
reference's, on the CPU.

Port swarms over the port's ``LoopbackNetwork`` run the same client ids
and ops as reference swarms in the same merge mode (``"scalar"``, and
``"resident"`` with ``device="cpu"``): every replica must agree with its
reference counterpart on ``c``, the state vector, the full state, its
``MemoryPersistence`` log byte for byte and the compaction snapshot. A
port replica and a reference replica on one network (the router
contract is duck-typed) must converge with the tracer and recorder on in
both packages, which pins the wire form of updates, state vectors and
trace contexts. The obs modules ``Replica`` imports (trace-context wire
form, propagation ledger, divergence sentinel) are held against the
reference directly.
"""

import types

import pytest

import crdt_tpu.net as ref_net
import crdt_tpu_torch.net as port_net
from crdt_tpu.api import Crdt as RefCrdt
from crdt_tpu.core.ids import StateVector as RefStateVector
from crdt_tpu.net import replica as ref_replica
from crdt_tpu.obs import propagation as ref_prop
from crdt_tpu.obs import sentinel as ref_sentinel
from crdt_tpu.obs.recorder import FlightRecorder as RefRecorder
from crdt_tpu.obs.recorder import set_recorder as ref_set_recorder
from crdt_tpu.obs.tracer import Tracer as RefTracer
from crdt_tpu.obs.tracer import set_tracer as ref_set_tracer
from crdt_tpu.ops import packed as ref_pk
from crdt_tpu_torch.api import Crdt, ResidentCrdt
from crdt_tpu_torch.core.ids import StateVector
from crdt_tpu_torch.models.traces import build_trace
from crdt_tpu_torch.net import replica as port_replica
from crdt_tpu_torch.obs import propagation as port_prop
from crdt_tpu_torch.obs import sentinel as port_sentinel
from crdt_tpu_torch.obs.recorder import FlightRecorder, set_recorder
from crdt_tpu_torch.obs.tracer import Tracer, set_tracer
from crdt_tpu_torch.ops import packed as pk

PORT = types.SimpleNamespace(net=port_net, kw={"device": "cpu"},
                             StateVector=StateVector)
REF = types.SimpleNamespace(net=ref_net, kw={}, StateVector=RefStateVector)
MODES = ["scalar", "resident"]


def _rep(pkg, net, pk_name, mode, **options):
    kw = dict(pkg.kw) if mode == "resident" else {}
    kw.update(options)
    return pkg.net.ypear_crdt(pkg.net.LoopbackRouter(net, pk_name),
                              topic=kw.pop("topic", "t"), merge_mode=mode,
                              **kw)


def _snapshot(reps, stores=()):
    """Everything a swarm is compared on, as plain values."""
    return {
        "c": [dict(r.c) for r in reps],
        "sv": [r.encode_state_vector() for r in reps],
        "full": [r.encode_state_as_update() for r in reps],
        "logs": [s.get_all_updates("t") for s in stores],
        "log_svs": [s.get_state_vector("t") for s in stores],
        "synced": [r.synced for r in reps],
    }


# ---------------------------------------------------------------------------
# swarm scripts: each runs on one package and returns its snapshot
# ---------------------------------------------------------------------------


def two_replica_map(pkg, mode):
    net = pkg.net.LoopbackNetwork()
    a = _rep(pkg, net, "pk0", mode, client_id=1)
    b = _rep(pkg, net, "pk1", mode, client_id=2)
    net.run()
    for i in range(30):
        a.set("users", f"a{i}", i)
        b.set("users", f"b{i}", i)
    net.run()
    for i in range(0, 30, 2):
        a.delete("users", f"b{i}")
        b.delete("users", f"a{i}")
    net.run()
    return _snapshot([a, b])


def four_replica_arrays(pkg, mode):
    net = pkg.net.LoopbackNetwork(seed=3, reorder=True, duplicate=0.3)
    reps = [_rep(pkg, net, f"pk{i}", mode, client_id=i + 1)
            for i in range(4)]
    net.run()
    for i, r in enumerate(reps):
        r.push("log", [f"p{i}-{j}" for j in range(5)])
    net.run()
    for i, r in enumerate(reps):
        r.insert("log", i, f"ins{i}")
        r.unshift("log", f"u{i}")
    net.run()
    for i, r in enumerate(reps):
        r.cut("log", i, 2)
    net.run()
    return _snapshot(reps)


def batch_with_persistence(pkg, mode):
    """BASELINE config 3 at 8 replicas: exec_batch of maps, a list and a
    nested list, every replica persisting."""
    net = pkg.net.LoopbackNetwork()
    stores = [pkg.net.MemoryPersistence() for _ in range(8)]
    reps = [_rep(pkg, net, f"pk{i}", mode, client_id=i + 1,
                 persistence=stores[i], batch_incoming=i % 2 == 0)
            for i in range(8)]
    net.run()
    reps[0].set("nested", "l", "seed", array_method="push")
    net.run()
    for i, r in enumerate(reps):
        r.set("m", f"k{i}", i, batch=True)
        r.push("log", f"v{i}", batch=True)
        r.set("nested", "l", f"n{i}", array_method="push", batch=True)
        r.exec_batch()
    net.run()
    return _snapshot(reps, stores)


def mixed_interleaved(pkg, mode):
    """bench.py's mixed swarm op mix (maps, appends, live-index
    mid-inserts, nested array-in-map), delivery interleaved."""
    net = pkg.net.LoopbackNetwork()
    reps = [_rep(pkg, net, f"pk{i}", mode, client_id=i + 1,
                 batch_incoming=True) for i in range(9)]
    net.run()
    for i, r in enumerate(reps):
        for j in range(30):
            k = j % 5
            if k == 0:
                r.set("m", f"k{i % 16}-{j % 32}", [i, j])
            elif k == 1:
                r.push("l", f"v{i}-{j}")
            elif k == 2:
                r.set("nest", f"arr{i % 8}", value=f"n{i}-{j}",
                      array_method="push")
            elif k == 3:
                cur = r.get("l") or []
                r.insert("l", (i * 7 + j) % (len(cur) + 1), f"ins{i}-{j}")
            else:
                r.set("m", f"solo{i}", j)
        if i % 4 == 3:
            net.run()
    net.run()
    return _snapshot(reps)


def restart_and_compact(pkg, mode):
    """A persisting replica edits, leaves, misses an edit, restarts
    from its log and is caught up; a compaction squashes the log and a
    restart from the snapshot equals the live replica."""
    net = pkg.net.LoopbackNetwork()
    store = pkg.net.MemoryPersistence()
    a = _rep(pkg, net, "a", mode, client_id=1)
    b = _rep(pkg, net, "b", mode, client_id=2, persistence=store)
    net.run()
    a.set("m", "k", 1)
    b.push("l", ["mine", "too"])
    b.set("m", "gone", 0)
    b.delete("m", "gone")
    net.run()
    b.self_close()
    a.set("m", "k2", 2)
    net.run()
    b2 = _rep(pkg, net, "b2", mode, client_id=3, persistence=store)
    restored = dict(b2.c)
    net.run()
    b2.push("l", "after")
    net.run()
    log = store.get_all_updates("t")
    b2.compact()
    snap = store.get_all_updates("t")
    b3 = _rep(pkg, pkg.net.LoopbackNetwork(), "b3", mode, client_id=4,
              persistence=store)
    out = _snapshot([a, b2, b3], [store])
    out.update(restored=restored, log_before=log, snapshot=snap)
    return out


def anti_entropy_round(pkg, mode):
    net = pkg.net.LoopbackNetwork()
    a = _rep(pkg, net, "a", mode, client_id=1)
    b = _rep(pkg, net, "b", mode, client_id=2)
    net.run()
    for i in range(5):
        a.set("m", f"k{i}", i)
    net.run()
    a.peer_state_vectors["b"] = pkg.StateVector({})  # forget b's progress
    sent = a.anti_entropy()
    net.run()
    out = _snapshot([a, b])
    out["sent"] = sent
    return out


SWARMS = [two_replica_map, four_replica_arrays, batch_with_persistence,
          mixed_interleaved, restart_and_compact, anti_entropy_round]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("script", SWARMS, ids=lambda s: s.__name__)
def test_port_swarm_matches_reference(script, mode):
    want = script(REF, mode)
    got = script(PORT, mode)
    assert set(got) == set(want)
    for key in want:
        assert got[key] == want[key], key
    assert all(got["synced"])
    assert all(c == got["c"][0] for c in got["c"])


def test_compaction_snapshot_is_the_full_state_from_resident_columns():
    got = restart_and_compact(PORT, "resident")
    assert len(got["snapshot"]) == 1
    assert got["snapshot"][0] == got["full"][1]  # b2's full state
    assert got["c"][2] == got["c"][1] == got["c"][0]
    scalar = restart_and_compact(PORT, "scalar")
    assert scalar["c"] == got["c"]
    fresh = Crdt(9)
    fresh.apply_update(got["snapshot"][0])
    assert dict(fresh.c) == got["c"][1]


# ---------------------------------------------------------------------------
# one network, both packages
# ---------------------------------------------------------------------------


@pytest.fixture
def observed():
    """The tracer and recorder on in both packages, so every origin
    frame carries a wire trace context."""
    port = (set_tracer(Tracer(enabled=True)),
            set_recorder(FlightRecorder(enabled=True)),
            port_prop.set_propagation(port_prop.PropagationLedger()))
    ref = (ref_set_tracer(RefTracer(enabled=True)),
           ref_set_recorder(RefRecorder(enabled=True)),
           ref_prop.set_propagation(ref_prop.PropagationLedger()))
    yield port, ref
    set_tracer(Tracer(enabled=False))
    set_recorder(FlightRecorder(enabled=False))
    ref_set_tracer(RefTracer(enabled=False))
    ref_set_recorder(RefRecorder(enabled=False))


@pytest.mark.parametrize("layout", [
    ("port-net", "scalar", "scalar"),
    ("ref-net", "scalar", "scalar"),
    ("port-net", "resident", "resident"),
    ("ref-net", "resident", "scalar"),
    ("port-net", "resident", "scalar"),
], ids=lambda x: "-".join(x))
def test_cross_package_swarm_converges(layout, observed):
    """Reference and port replicas, alternating, on one network: a
    late joiner of each package, reordered and duplicated delivery,
    anti-entropy, beacons checked by the other package's sentinel."""
    net_pkg, port_mode, ref_mode = layout
    (tracer, recorder, ledger), (ref_tracer, ref_recorder, ref_ledger) = \
        observed
    net = (port_net if net_pkg == "port-net" else ref_net).LoopbackNetwork(
        seed=11, reorder=True, duplicate=0.2)
    reps = []
    for i in range(6):
        pkg, mode = (PORT, port_mode) if i % 2 else (REF, ref_mode)
        reps.append(_rep(pkg, net, f"pk{i}", mode, client_id=i + 1,
                         batch_incoming=i % 3 == 0))
    net.run()
    for i, r in enumerate(reps):
        r.set("m", f"k{i % 3}", i)
        r.push("l", [i, f"v{i}"])
        r.set("nest", "arr", f"n{i}", array_method="push")
        if i % 2:
            r.unshift("l", f"u{i}")
            r.cut("l", 1, 1)
    net.run()
    for pkg, pk_name, cid in ((PORT, "late-port", 20), (REF, "late-ref", 21)):
        reps.append(_rep(pkg, net, pk_name, "scalar", client_id=cid))
        net.run()
    for r in reps:
        r.anti_entropy()
    net.run()
    for r in reps:
        r.beacon()
    net.run()
    first = dict(reps[0].c)
    assert first["nest"]["arr"] and len(first["m"]) == 3
    for r in reps[1:]:
        assert r.synced
        assert dict(r.c) == first, r.router.public_key
        assert r.state_vector().clocks == reps[0].state_vector().clocks
        assert r.encode_state_vector() == reps[0].encode_state_vector()
        assert not r.sentinel.events
    # contexts flowed both ways and decoded everywhere
    assert ledger.contexts_sent and ref_ledger.contexts_sent
    assert ledger.contexts_received and ref_ledger.contexts_received
    for t in (tracer, ref_tracer):
        assert not t.counters("propagation.malformed_contexts")
        assert not t.counters("replica.malformed_updates")
    for rec in (recorder, ref_recorder):
        assert not rec.events("update.bad_context")
        assert rec.events("update.recv")
    # the port's beacons were checked by reference sentinels and back
    assert sum(r.sentinel.beacons_checked for r in reps) > 0
    assert tracer.counters("sentinel.agree") and \
        ref_tracer.counters("sentinel.agree")


# ---------------------------------------------------------------------------
# restart, late join and anti-entropy with forced device rounds
# ---------------------------------------------------------------------------


def forced_device_rounds(pkg):
    """A resident replica restarts from a log of 12 writers' blobs, a
    resident late joiner ingests its diff, both edit, anti-entropy:
    every round with rows is a device round (``device_min_rows=1``)."""
    blobs = build_trace(12, 20, seed=4)
    net = pkg.net.LoopbackNetwork()
    store = pkg.net.MemoryPersistence()
    store.store_updates("t", blobs)
    a = _rep(pkg, net, "a", "resident", client_id=1, persistence=store,
             device_min_rows=1)
    loaded = dict(a.c)
    b = _rep(pkg, net, "b", "resident", client_id=2, device_min_rows=1)
    net.run()
    a.set("m", "x", 1)
    b.push("l", ["y", "z"])
    b.insert("l", 1, "w")
    net.run()
    a.peer_state_vectors["b"] = pkg.StateVector({})
    sent = a.anti_entropy()
    net.run()
    a.compact()
    out = _snapshot([a, b], [store])
    out.update(loaded=loaded, sent=sent)
    return out


def test_restart_late_join_and_anti_entropy_in_device_rounds():
    r0, p0 = ref_pk.device_dispatch_count, pk.device_dispatch_count
    want = forced_device_rounds(REF)
    r1 = ref_pk.device_dispatch_count
    got = forced_device_rounds(PORT)
    rounds = (pk.device_dispatch_count - p0, r1 - r0)
    for key in want:
        assert got[key] == want[key], key
    assert rounds[0] == rounds[1] >= 3  # the load, the join, the edits
    assert got["c"][0] == got["c"][1]
    ref = RefCrdt(5)
    ref.apply_updates(build_trace(12, 20, seed=4))
    assert got["loaded"] == dict(ref.c)


# ---------------------------------------------------------------------------
# what raises
# ---------------------------------------------------------------------------


def test_device_merge_mode_raises_naming_item_7():
    net = port_net.LoopbackNetwork()
    with pytest.raises(NotImplementedError, match="item 7"):
        port_net.ypear_crdt(port_net.LoopbackRouter(net, "d"), topic="t",
                            merge_mode="device")
    with pytest.raises(NotImplementedError, match="item 7"):
        port_net.ypear_crdt(port_net.LoopbackRouter(net, "e"), topic="t",
                            device_merge=True)
    assert not net.topics.get("t")  # raised before joining the topic


def test_resident_replica_without_a_device_raises_here(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    net = port_net.LoopbackNetwork()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_net.ypear_crdt(port_net.LoopbackRouter(net, "r"), topic="t",
                            merge_mode="resident")
    # CRDT_TPU_DEVICE=1 selects the resident mode: on the card too
    monkeypatch.setenv("CRDT_TPU_DEVICE", "1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_net.ypear_crdt(port_net.LoopbackRouter(net, "s"), topic="t")
    # scalar mode is the host engine and needs no card
    r = port_net.ypear_crdt(port_net.LoopbackRouter(net, "u"), topic="t",
                            merge_mode="scalar")
    assert isinstance(r.doc, Crdt)


def test_env_var_precedence_matches_reference(monkeypatch):
    monkeypatch.setenv("CRDT_TPU_DEVICE", "1")
    for options, mode in (({}, "resident"), ({"merge_mode": "scalar"},
                                              "scalar"),
                          ({"device_merge": False}, "scalar")):
        net = port_net.LoopbackNetwork()
        r = port_net.ypear_crdt(port_net.LoopbackRouter(net, "p"),
                                topic="t", device="cpu", **options)
        ref = ref_net.ypear_crdt(ref_net.LoopbackRouter(
            ref_net.LoopbackNetwork(), "p"), topic="t", **options)
        assert r.merge_mode == ref.merge_mode == mode
        assert isinstance(r.doc, ResidentCrdt if mode == "resident"
                          else Crdt)
        assert r.batch_incoming == ref.batch_incoming


def test_unknown_mode_and_missing_topic_raise():
    net = port_net.LoopbackNetwork()
    with pytest.raises(ValueError):
        port_net.ypear_crdt(port_net.LoopbackRouter(net, "x"), topic="t",
                            merge_mode="bogus")
    with pytest.raises(ValueError):
        port_net.ypear_crdt(port_net.LoopbackRouter(net, "x"))
    with pytest.raises(TypeError):
        port_net.Replica(object(), "t")


class _OnlySingle(port_net.MemoryPersistence):
    def store_update(self, doc_name, update, sv=None):
        super().store_update(doc_name, update, sv=sv)


class _Both(_OnlySingle):
    def store_updates(self, doc_name, updates, sv=None):
        super().store_updates(doc_name, updates, sv=sv)


@pytest.mark.parametrize("cls", [port_net.MemoryPersistence, _OnlySingle,
                                 _Both, object])
def test_prefers_batch_verb_matches_reference(cls):
    assert port_replica._prefers_batch_verb(cls) == \
        ref_replica._prefers_batch_verb(cls)


def test_random_client_id_is_31_bits():
    ids = {port_replica._random_client_id() for _ in range(64)}
    assert len(ids) > 60 and all(0 <= i < 1 << 31 for i in ids)


# ---------------------------------------------------------------------------
# the obs modules Replica imports
# ---------------------------------------------------------------------------

CONTEXTS = [
    (1, 1, 0.5, [("pk0", "direct", 0)]),
    ((1 << 31) - 1, 12345, 1e6 + 0.25,
     [("replica-id-long-", "anti_entropy", 7),
      ("r2", "relayed", 1 << 40), ("r3", "sync_answer", 99)]),
    (7, 0, 0.0, []),
]


@pytest.mark.parametrize("ctx", CONTEXTS, ids=lambda c: f"{len(c[3])}hops")
def test_trace_context_wire_form_matches_reference(ctx):
    client, seq, ts, hops = ctx
    got = port_prop.encode_context(port_prop.TraceContext(client, seq, ts,
                                                          hops))
    want = ref_prop.encode_context(ref_prop.TraceContext(client, seq, ts,
                                                         hops))
    assert got == want
    back = port_prop.decode_context(want)
    assert (back.tid, back.hops) == (
        [client, seq, ts], [(r[:16], rt, d) for r, rt, d in hops])
    assert port_prop.retag_last_hop(got, "predicted") == \
        ref_prop.retag_last_hop(want, "predicted")
    assert port_prop.append_hop_wire(got, "fwd", "relayed", ts + 1.5) == \
        ref_prop.append_hop_wire(want, "fwd", "relayed", ts + 1.5)
    path = [list(h) for h in hops]
    assert port_prop.hop_legs(path, ts, ts + 2.0) == \
        ref_prop.hop_legs(path, ts, ts + 2.0)


def test_hostile_contexts_rejected_as_the_reference_does():
    good = port_prop.encode_context(port_prop.start_context(3, 4, "pk"))
    blobs = [good[:n] for n in range(len(good))] + [
        good + b"\x00", b"\x02" + good[1:], "text", None, 5,
        b"\x01" * 600, bytes([1, 1, 1]) + b"\xff" * 8 + b"\x00",
    ]
    for blob in blobs:
        want = ref_prop.decode_or_none(blob, count=False)
        got = port_prop.decode_or_none(blob, count=False)
        assert (got is None) == (want is None), blob


def test_sampling_matches_reference(monkeypatch):
    for rate in ("0", "0.3", "1", "junk"):
        monkeypatch.setenv("CRDT_TPU_TRACE_SAMPLE", rate)
        assert port_prop.sample_rate() == ref_prop.sample_rate()
    for c in range(40):
        assert port_prop.sampled(c, c * 3, 0.3) == \
            ref_prop.sampled(c, c * 3, 0.3)


def test_propagation_ledger_report_matches_reference():
    got, want = port_prop.PropagationLedger(), ref_prop.PropagationLedger()
    for ledger, prop in ((got, port_prop), (want, ref_prop)):
        ctx = prop.TraceContext(1, 2, 10.0, [("a", "direct", 0),
                                             ("b", "relayed", 250_000)])
        ledger.record_send(prop.encode_context(ctx), 1000)
        ledger.record_receipt(ctx, recv_ts=11.0)
    assert got.report() == want.report()


def test_sentinel_digests_and_check_match_reference():
    docs = {}
    for name, cls in (("port", Crdt), ("ref", RefCrdt)):
        d = cls(1)
        d.set("m", "k", 1)
        d.push("l", [1, 2, 3])
        d.cut("l", 0, 1)
        docs[name] = d
    assert port_sentinel.state_digest(docs["port"]) == \
        ref_sentinel.state_digest(docs["ref"])
    assert port_sentinel.delete_set_digest(docs["port"]) == \
        ref_sentinel.delete_set_digest(docs["ref"])
    got = port_sentinel.DivergenceSentinel(docs["port"], topic="t",
                                           replica="p")
    want = ref_sentinel.DivergenceSentinel(docs["ref"], topic="t",
                                           replica="p")
    assert got.beacon_payload() == want.beacon_payload()
    sv = docs["port"].state_vector()
    for digest in ("x", port_sentinel.state_digest(docs["port"])):
        ds = port_sentinel.delete_set_digest(docs["port"])
        a = got.check("q", sv, digest, ds)
        b = want.check("q", docs["ref"].state_vector(), digest, ds)
        assert (a is None) == (b is None)
    assert got.events and got.events[0]["peer_digest"] == "x"


def test_multidoc_sentinel_matches_reference():
    class Source:
        def __init__(self, docs):
            self.docs = docs

        def doc_digests(self):
            return self.docs

    mine = {"a": {"digest": "1", "ops": 3}, "b": {"digest": "2", "ops": 4}}
    theirs = {"docs": {"a": {"digest": "1", "ops": 3},
                       "b": {"digest": "9", "ops": 4},
                       "c": {"digest": "5", "ops": 1}}}
    got = port_sentinel.MultiDocSentinel(Source(mine), topic="t",
                                         replica="p")
    want = ref_sentinel.MultiDocSentinel(Source(mine), topic="t",
                                         replica="p")
    assert got.beacon_payload() == want.beacon_payload()
    a, b = got.check("q", theirs), want.check("q", theirs)
    a, b = ([{k: v for k, v in e.items() if k != "flight_recorder"}
             for e in events] for events in (a, b))
    assert a == b and len(a) == 1 and a[0]["doc"] == "b"
