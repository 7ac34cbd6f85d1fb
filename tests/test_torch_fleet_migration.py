"""The port's fleet (``crdt_tpu_torch.fleet``) against the reference's,
on the CPU.

Every case of tests/test_fleet_migration.py runs on port objects with
``device="cpu"`` and on the reference's with the same inputs: the kill
matrix, the partition matrix, byte identity against a migration-free
oracle, the destination's tail stash, beacons, fenced restore, the
placement loop and the wire. Each case returns its outcome (who serves,
the leases, the odometers, the digests, the fabric's counts and the
tracer's fleet, migration and snapshot counters, labels included) and
the two outcomes must be equal; the port must also meet the reference
test's own pins.

Across the packages: frames and blob lists are byte-equal, a port node
and a reference node hand a warm doc to each other on one ``MemFabric``
under the handoff schedule, ``FleetNode.load()`` is equal after the
same submissions, and ``chip_smoke.rebalance_leg(device="cpu")`` returns
``bench.rebalance_leg()``'s dict.
"""

import types

import pytest

import crdt_tpu.fleet as ref_fleet
from crdt_tpu.codec import v1 as ref_v1
from crdt_tpu.core.ids import DeleteSet as RefDeleteSet
from crdt_tpu.core.records import ItemRecord as RefItemRecord
from crdt_tpu.fleet import wire as ref_wire
from crdt_tpu.guard import faults as ref_guard_faults
from crdt_tpu.models.multidoc import MultiDocServer as RefServer
from crdt_tpu.net import faults as ref_net_faults
from crdt_tpu.obs import Tracer as RefTracer
from crdt_tpu.obs import set_tracer as ref_set_tracer
from crdt_tpu.obs.control import Controller as RefController
from crdt_tpu.storage import snapshot as ref_snapshot
from crdt_tpu_torch import fleet
from crdt_tpu_torch.codec import v1
from crdt_tpu_torch.core.ids import DeleteSet
from crdt_tpu_torch.core.records import ItemRecord
from crdt_tpu_torch.fleet import wire
from crdt_tpu_torch.guard import faults as guard_faults
from crdt_tpu_torch.models.multidoc import MultiDocServer
from crdt_tpu_torch.net import faults as net_faults
from crdt_tpu_torch.obs import Tracer, set_tracer
from crdt_tpu_torch.obs.control import Controller
from crdt_tpu_torch.storage import snapshot


def _pkg(name, fl, wr, codec, ds, rec, srv, gf, nf, tracer, set_tr, ctrl,
         snap, kw):
    return types.SimpleNamespace(
        name=name, FleetNode=fl.FleetNode, HashRing=fl.HashRing,
        LeaseTable=fl.LeaseTable, MemFabric=fl.MemFabric,
        PlacementLoop=fl.PlacementLoop, wire=wr, v1=codec, DeleteSet=ds,
        ItemRecord=rec, Server=srv, MigrationCrashPlan=gf.MigrationCrashPlan,
        SimulatedCrash=gf.SimulatedCrash,
        HandoffFaultSchedule=nf.HandoffFaultSchedule,
        DuplicateAdviceSchedule=nf.DuplicateAdviceSchedule, Tracer=tracer,
        set_tracer=set_tr, Controller=ctrl, Store=snap.SnapshotStore,
        encode_engine=snap.encode_engine, adopt_doc=fl.adopt_doc, kw=kw)


PKGS = {
    "ref": _pkg("ref", ref_fleet, ref_wire, ref_v1, RefDeleteSet,
                RefItemRecord, RefServer, ref_guard_faults, ref_net_faults,
                RefTracer, ref_set_tracer, RefController, ref_snapshot, {}),
    "port": _pkg("port", fleet, wire, v1, DeleteSet, ItemRecord,
                 MultiDocServer, guard_faults, net_faults, Tracer,
                 set_tracer, Controller, snapshot, {"device": "cpu"}),
}
MEMBERS = ("a", "b", "c")
DOC = "doc"  # ring-owned by "a" at vnodes=64
SERVER_KW = {"slo_ms": 10_000.0}
# the tracer namespaces the fleet layer emits into
FLEET_NS = ("fleet.", "migration.", "snap.")


@pytest.fixture(autouse=True)
def _quiet_obs():
    olds = [(p, p.set_tracer(p.Tracer(enabled=False)))
            for p in PKGS.values()]
    yield
    for p, old in olds:
        p.set_tracer(old)


def chain_blob(p, client, k0, n_ops=4):
    """One doc's chained list appends (clocks k0..k0+n_ops-1)."""
    return p.v1.encode_update([p.ItemRecord(
        client=client, clock=k, parent_root="l",
        origin=(client, k - 1) if k else None, content=client * 1000 + k,
    ) for k in range(k0, k0 + n_ops)], p.DeleteSet())


def make_fleet(p, tmp_path, *, faults=None, crash_plans=None,
               timeout_ticks=3, beacon_every=0):
    fab = p.MemFabric(faults=faults)
    stores, nodes = {}, {}
    for q in MEMBERS:
        stores[q] = p.Store(str(tmp_path / p.name / q))
        nodes[q] = p.FleetNode(
            q, MEMBERS, fab, store=stores[q], timeout_ticks=timeout_ticks,
            beacon_every=beacon_every,
            crash_plan=(crash_plans or {}).get(q),
            server_kw=dict(SERVER_KW), **p.kw)
    return fab, nodes, stores


def run_ticks(p, fab, nodes, n):
    for _ in range(n):
        for q in sorted(nodes):
            if q in fab.dead:
                continue
            try:
                nodes[q].tick()
            except p.SimulatedCrash:
                fab.kill(q)


def revive(p, fab, nodes, stores, proc, *, timeout_ticks=3,
           beacon_every=0):
    node = p.FleetNode(proc, MEMBERS, fab, store=stores[proc],
                       timeout_ticks=timeout_ticks,
                       beacon_every=beacon_every,
                       server_kw=dict(SERVER_KW), **p.kw)
    fab.revive(proc, node)
    node.restore()
    nodes[proc] = node
    return node


def seed_doc(p, nodes, doc=DOC, owner="a", rounds=4):
    for k in range(rounds):
        r, _ = nodes[owner].submit(doc, chain_blob(p, 7, 4 * k))
        assert r == "ok"
        for q in sorted(nodes):
            nodes[q].tick()
    return nodes[owner].server.digest(doc)


def serving(nodes, doc=DOC):
    return [q for q in sorted(nodes) if nodes[q].digest(doc) is not None]


def fleet_state(fab, nodes, docs=(DOC,)):
    """Everything a case leaves on the fleet: who serves, each node's
    leases, odometers and doc set, the fabric's counts."""
    out = {"serving": {d: serving(nodes, d) for d in docs},
           "fabric": (fab.sent, fab.dropped, fab.duplicated,
                      sorted(fab.dead))}
    for q in sorted(nodes):
        n = nodes[q]
        m = n.migrator
        out[q] = {
            "lease": {d: n.lease.lease(d) for d in docs},
            "recorded": n.lease.recorded(),
            "fence": (n.lease.fence_rejects, n.lease.fork_refused),
            "node": (n.redirects, n.demotions, n.tick_count, n.load()),
            "migrator": (m.started, m.completed, dict(m.recoveries),
                         sorted(m.outbound), sorted(m.inbound)),
            "docs": sorted(map(str, n.server._docs)),
            "digests": {d: n.server.digest(d) for d in docs
                        if d in n.server._docs},
        }
    return out


def both(case, tmp_path):
    """``case(pkg, tmp_path)`` on the reference and on the port, each
    under an enabled tracer: equal outcomes and equal fleet, migration
    and snapshot counters. Returns the port's outcome."""
    outs = {}
    for name in ("ref", "port"):
        p = PKGS[name]
        tracer = p.set_tracer(p.Tracer(enabled=True))
        try:
            res = case(p, tmp_path)
        finally:
            p.set_tracer(p.Tracer(enabled=False))
        counters = {k: v for k, v in tracer.counters().items()
                    if k.startswith(FLEET_NS)}
        outs[name] = (res, counters)
    assert outs["port"][0] == outs["ref"][0]
    assert outs["port"][1] == outs["ref"][1]
    return outs["port"][0]


# ---- the happy path ------------------------------------------------


class TestHappyPath:
    def test_live_migration_is_lossless_and_single_owner(self, tmp_path):
        def case(p, tmp):
            fab, nodes, _ = make_fleet(p, tmp)
            d0 = seed_doc(p, nodes)
            before = serving(nodes)
            assert nodes["a"].migrate(DOC, "c")
            run_ticks(p, fab, nodes, 6)
            redirect = nodes["a"].submit(DOC, chain_blob(p, 7, 16))
            return d0, before, redirect, fleet_state(fab, nodes)

        d0, before, redirect, st = both(case, tmp_path)
        assert before == ["a"] and st["serving"][DOC] == ["c"]
        assert st["c"]["digests"][DOC] == d0
        assert st["a"]["migrator"][1:3] == (1, {})
        assert st["c"]["lease"][DOC] == st["a"]["lease"][DOC] == (2, "c")
        assert all(st[q]["fence"][1] == 0 for q in MEMBERS)
        assert redirect == ("redirect", "c") and st["a"]["node"][0] == 1

    def test_migrate_refusals(self, tmp_path):
        def case(p, tmp):
            fab, nodes, _ = make_fleet(p, tmp)
            seed_doc(p, nodes)
            return ([nodes["b"].migrate(DOC, "c"),
                     nodes["a"].migrate(DOC, "a"),
                     nodes["a"].migrate(DOC, "c"),
                     nodes["a"].migrate(DOC, "b")],
                    fleet_state(fab, nodes))

        res, st = both(case, tmp_path)
        assert res == [False, False, True, False]
        assert st["a"]["migrator"][0] == 1


# ---- the kill matrix -----------------------------------------------


KILL_CASES = [
    ("drain", "a", {"drain": 1}, {}, "a"),
    ("ship", "a", {"ship": 1}, {}, "a"),
    ("commit", "a", {"commit": 2}, {"commit": 1}, "a"),
    ("ack", "a", {"commit": 1, "ack": 1}, {}, "c"),
    ("rehydrate", "c", {}, {"rehydrate": 1}, "a"),
]


class TestKillMatrix:
    @pytest.mark.parametrize(
        "step,victim,rec_revived,rec_peer,winner", KILL_CASES,
        ids=[c[0] for c in KILL_CASES])
    def test_kill_at_step(self, tmp_path, step, victim, rec_revived,
                          rec_peer, winner):
        def case(p, tmp):
            plans = {victim: p.MigrationCrashPlan(kill_at={step: 1})}
            fab, nodes, stores = make_fleet(p, tmp, crash_plans=plans)
            d0 = seed_doc(p, nodes)
            nodes["a"].checkpoint()
            assert nodes["a"].migrate(DOC, "c")
            run_ticks(p, fab, nodes, 4)
            dead = sorted(fab.dead)
            run_ticks(p, fab, nodes, 4)
            revive(p, fab, nodes, stores, victim)
            run_ticks(p, fab, nodes, 12)
            return d0, dead, fleet_state(fab, nodes)

        d0, dead, st = both(case, tmp_path)
        peer = "c" if victim == "a" else "a"
        assert dead == [victim]
        assert st[victim]["migrator"][2] == rec_revived
        assert st[peer]["migrator"][2] == rec_peer
        assert st["serving"][DOC] == [winner]
        assert st[winner]["digests"][DOC] == d0
        for q in MEMBERS:
            if q != winner:
                assert st[q]["fence"][0] >= 1
            assert st[q]["fence"][1] == 0

    def test_commit_kill_reclaims_above_the_granted_epoch(self, tmp_path):
        def case(p, tmp):
            plans = {"a": p.MigrationCrashPlan(kill_at={"commit": 1})}
            fab, nodes, stores = make_fleet(p, tmp, crash_plans=plans)
            seed_doc(p, nodes)
            nodes["a"].checkpoint()
            assert nodes["a"].migrate(DOC, "c")
            run_ticks(p, fab, nodes, 4)
            dead = sorted(fab.dead)
            revived = revive(p, fab, nodes, stores, "a")
            fenced = (revived.lease.lease(DOC), revived.digest(DOC))
            run_ticks(p, fab, nodes, 12)
            return dead, fenced, fleet_state(fab, nodes)

        dead, fenced, st = both(case, tmp_path)
        assert dead == ["a"] and fenced == ((2, "c"), None)
        assert st["a"]["lease"][DOC] == (3, "a")
        assert st["serving"][DOC] == ["a"]


# ---- the partition matrix (scripted frame drops) -------------------


DROP_CASES = [
    ("commit", ("a", "c"), {"commit": 1}, {"commit": 1}, "a", 3),
    ("ack", ("c", "a"), {"ack": 1}, {}, "c", 2),
    ("offer", ("a", "c"), {"rehydrate": 1}, {}, "a", 1),
]


class TestPartitionMatrix:
    @pytest.mark.parametrize(
        "kind,link,rec_src,rec_dst,winner,epoch", DROP_CASES,
        ids=[c[0] for c in DROP_CASES])
    def test_dropped_frame_window(self, tmp_path, kind, link, rec_src,
                                  rec_dst, winner, epoch):
        def case(p, tmp):
            faults = p.HandoffFaultSchedule(seed=3, windows=[{
                "src": link[0], "dst": link[1], "kinds": (kind,),
                "from_n": 1, "mode": "drop"}])
            fab, nodes, _ = make_fleet(p, tmp, faults=faults)
            d0 = seed_doc(p, nodes)
            assert nodes["a"].migrate(DOC, "c")
            run_ticks(p, fab, nodes, 20)
            return d0, faults.window_hits, fleet_state(fab, nodes)

        d0, hits, st = both(case, tmp_path)
        assert hits >= 1
        assert st["a"]["migrator"][2] == rec_src
        assert st["c"]["migrator"][2] == rec_dst
        assert st["serving"][DOC] == [winner]
        assert st[winner]["digests"][DOC] == d0
        assert st[winner]["lease"][DOC] == (epoch, winner)
        assert all(st[q]["fence"][1] == 0 for q in MEMBERS)

    def test_dropped_ack_completes_via_probe(self, tmp_path):
        def case(p, tmp):
            faults = p.HandoffFaultSchedule(seed=3, windows=[{
                "src": "c", "dst": "a", "kinds": ("ack",),
                "from_n": 1, "to_n": 1, "mode": "drop"}])
            fab, nodes, _ = make_fleet(p, tmp, faults=faults)
            seed_doc(p, nodes)
            assert nodes["a"].migrate(DOC, "c")
            run_ticks(p, fab, nodes, 20)
            return fleet_state(fab, nodes)

        st = both(case, tmp_path)
        assert st["a"]["migrator"][1] == 1
        assert DOC not in st["a"]["docs"]


# ---- byte identity under mid-handoff traffic -----------------------


def try_submit(nodes, doc, blob):
    for q in sorted(nodes):
        r, _info = nodes[q].submit(doc, blob)
        if r in ("ok", "buffered"):
            return r
    raise AssertionError("no process accepted the update")


def engine_state(srv, doc, p):
    eng = srv._docs[doc].resident
    assert eng is not None
    return (srv.digest(doc), eng.state_vector().clocks,
            eng.encode_state_as_update(), p.encode_engine(eng, seq=0))


class TestByteIdentity:
    def test_mid_handoff_tail_vs_migration_free_oracle(self, tmp_path):
        def case(p, tmp):
            fab, nodes, _ = make_fleet(p, tmp)
            oracle = p.Server(**SERVER_KW, **p.kw)
            blobs = [chain_blob(p, 7, 4 * k) for k in range(6)]
            routes = []
            for k in range(6):
                if k == 3:
                    assert nodes["a"].migrate(DOC, "c")
                routes.append(try_submit(nodes, DOC, blobs[k]))
                oracle.submit(DOC, blobs[k])
                run_ticks(p, fab, nodes, 1)
                oracle.tick()
            run_ticks(p, fab, nodes, 8)
            for _ in range(8):
                oracle.tick()
            got = engine_state(nodes["c"].server, DOC, p)
            return (routes, got, engine_state(oracle, DOC, p),
                    fleet_state(fab, nodes))

        routes, got, want, st = both(case, tmp_path)
        assert routes[:3] == ["ok"] * 3 and "buffered" in routes
        assert st["serving"][DOC] == ["c"]
        assert st["a"]["migrator"][1] == 1
        assert got == want


# ---- durability: the commit-path tail stash ------------------------


class TestDstDurability:
    def test_dst_crash_after_commit_restores_from_tail_stash(self, tmp_path):
        def case(p, tmp):
            fab, nodes, stores = make_fleet(p, tmp)
            d0 = seed_doc(p, nodes)
            assert nodes["a"].migrate(DOC, "c")
            r, _ = nodes["a"].submit(DOC, chain_blob(p, 7, 16))
            run_ticks(p, fab, nodes, 8)
            before = serving(nodes)
            d1 = nodes["c"].server.digest(DOC)
            fab.kill("c")
            tracer = p.set_tracer(p.Tracer(enabled=True))
            revived = revive(p, fab, nodes, stores, "c")
            restores = tracer.counters().get("migration.tail_restores", 0)
            run_ticks(p, fab, nodes, 4)
            return (d0, r, before, d1, restores, revived.server.digest(DOC),
                    fleet_state(fab, nodes))

        d0, r, before, d1, restores, d2, st = both(case, tmp_path)
        assert r == "buffered" and before == ["c"] and d1 != d0
        assert restores == 1
        assert st["serving"][DOC] == ["c"] and d2 == d1


# ---- beacons: the partitioned ex-owner heals -----------------------


class TestBeacons:
    def test_stale_owner_demotes_on_newer_epoch_beacon(self, tmp_path):
        def case(p, tmp):
            fab, nodes, _ = make_fleet(p, tmp, beacon_every=2)
            seed_doc(p, nodes)
            nodes["b"].lease.grant(DOC, 5, "b")
            nodes["b"].server.submit(DOC, chain_blob(p, 7, 0))
            run_ticks(p, fab, nodes, 6)
            return fleet_state(fab, nodes)

        st = both(case, tmp_path)
        assert st["a"]["node"][1] == 1
        assert st["a"]["lease"][DOC] == (5, "b")
        assert st["serving"][DOC] == ["b"]

    def test_equal_epoch_rival_beacon_is_a_refused_fork(self, tmp_path):
        def case(p, tmp):
            fab, nodes, _ = make_fleet(p, tmp, beacon_every=2)
            seed_doc(p, nodes)
            nodes["b"].lease._leases[DOC] = (1, "b")
            nodes["b"].server.submit(DOC, chain_blob(p, 7, 0))
            run_ticks(p, fab, nodes, 6)
            return fleet_state(fab, nodes)

        st = both(case, tmp_path)
        assert st["a"]["fence"][1] >= 1
        assert st["a"]["lease"][DOC] == (1, "a")
        assert st["a"]["node"][1] == 0
        assert "a" in st["serving"][DOC]


# ---- fenced checkpoint/restore -------------------------------------


def _seeded_server(p, store):
    srv = p.Server(snap_store=store, **SERVER_KW, **p.kw)
    for k in range(4):
        srv.submit("w", chain_blob(p, 7, 4 * k))
        srv.tick()
    assert srv._docs["w"].resident is not None
    return srv


class TestFencedRestore:
    def test_restore_refuses_newer_fencing_epoch(self, tmp_path):
        def case(p, tmp):
            store = p.Store(str(tmp / p.name))
            ring = p.HashRing(["a", "b"], vnodes=64)
            writer = p.LeaseTable("a", ring)
            writer.grant("w", 5, "a")
            n = _seeded_server(p, store).checkpoint(fence=writer)
            srv2 = p.Server(snap_store=store, **SERVER_KW, **p.kw)
            warm = srv2.restore(fence=p.LeaseTable("a", ring))
            return (n, warm, "w" in srv2._docs, srv2.snap_fallback_count,
                    store.get_blob("checkpoint.fence"))

        n, warm, present, fallbacks, stamp = both(case, tmp_path)
        assert n >= 1 and warm == 0 and not present and fallbacks == 1
        assert b'"w": 5' in stamp

    def test_restore_admits_matching_epoch(self, tmp_path):
        def case(p, tmp):
            store = p.Store(str(tmp / p.name))
            writer = p.LeaseTable("a", p.HashRing(["a", "b"], vnodes=64))
            writer.grant("w", 5, "a")
            srv = _seeded_server(p, store)
            d0 = srv.digest("w")
            srv.checkpoint(fence=writer)
            srv2 = p.Server(snap_store=store, **SERVER_KW, **p.kw)
            return (d0, srv2.restore(fence=writer), srv2.digest("w"),
                    srv2.snap_fallback_count)

        d0, warm, d1, fallbacks = both(case, tmp_path)
        assert warm == 1 and d1 == d0 and fallbacks == 0

    def test_unfenced_restore_unchanged(self, tmp_path):
        def case(p, tmp):
            store = p.Store(str(tmp / p.name))
            srv = _seeded_server(p, store)
            d0 = srv.digest("w")
            srv.checkpoint()
            srv2 = p.Server(snap_store=store, **SERVER_KW, **p.kw)
            return d0, srv2.restore(), srv2.digest("w")

        d0, warm, d1 = both(case, tmp_path)
        assert warm == 1 and d1 == d0


# ---- the placement loop (advice in, migrations out) ----------------


class TestPlacementLoop:
    def test_advice_rows_carry_seq_and_target(self, tmp_path):
        def case(p, tmp):
            c = p.Controller(cooldown_ticks=0)
            c.observe({"tick": 7,
                       "budget": {"max_bytes": 2048, "max_updates": 4},
                       "tenants": {DOC: {"burn": 1.0}}})
            adv = c.advice()
            ring = p.HashRing(MEMBERS, vnodes=64)
            c.placement_hint = lambda t: ring.least_loaded_successor(
                t, exclude=["a"], loads={"b": 9.0, "c": 1.0})
            return adv, c.advice()

        adv, hinted = both(case, tmp_path)
        assert len(adv) == 1 and adv[0]["seq"] == 1
        assert adv[0]["target"] is None and hinted[0]["target"] == "c"

    def test_duplicated_and_replayed_advice_is_idempotent(self, tmp_path):
        def case(p, tmp):
            fab, nodes, _ = make_fleet(p, tmp)
            seed_doc(p, nodes)
            loop = p.PlacementLoop(p.HashRing(MEMBERS, vnodes=64),
                                   nodes.get, hysteresis=2,
                                   budget_per_tick=1)
            sched = p.DuplicateAdviceSchedule(seed=7, duplicate=0.9,
                                              replay=0.9)
            row = {"action": "rebalance_away", "tenant": DOC, "proc": "a",
                   "seq": 1, "burn": 1.3, "target": None}
            started = []
            for poll in range(6):
                started.append(loop.observe(
                    poll, sched.mangle(poll, [dict(row)]),
                    loads={"b": 2.0, "c": 1.0}))
                run_ticks(p, fab, nodes, 1)
            run_ticks(p, fab, nodes, 6)
            return (started, sched.injected, loop.dup_drops,
                    loop.migrations, loop.ledger.rows(),
                    fleet_state(fab, nodes))

        started, injected, drops, migs, rows, st = both(case, tmp_path)
        assert injected > 0 and drops > 0 and migs == 1
        assert st["a"]["migrator"][0] == 1
        assert st["serving"][DOC] == ["c"]
        acts = [r for r in rows if r["action"] == "migrate"]
        assert len(acts) == 1
        assert acts[0]["tenant"] == DOC and acts[0]["dst"] == "c"

    def test_in_flight_breach_is_skipped_with_a_ledger_row(self, tmp_path):
        def case(p, tmp):
            fab, nodes, _ = make_fleet(p, tmp)
            seed_doc(p, nodes)
            loop = p.PlacementLoop(p.HashRing(MEMBERS, vnodes=64),
                                   nodes.get, hysteresis=1)
            row = {"action": "rebalance_away", "tenant": DOC, "proc": "a",
                   "seq": 1, "burn": 1.3, "target": "c"}
            first = loop.observe(0, [dict(row)])
            second = loop.observe(1, [dict(row, seq=2)])
            return first, second, loop.migrations, loop.ledger.rows()

        first, second, migs, rows = both(case, tmp_path)
        assert len(first) == 1 and second == [] and migs == 1
        skips = [r for r in rows if r["action"] == "skip"]
        assert skips and skips[-1]["why"] == "in_flight"


# ---- the frame codec -----------------------------------------------


class TestWire:
    def test_frame_round_trip(self, tmp_path):
        def case(p, tmp):
            hdr = {"kind": "offer", "doc": DOC, "epoch": 2, "proc": "a"}
            payload = p.wire.pack_blobs([b"one", b"", b"three"])
            frame = p.wire.encode_frame(hdr, payload)
            dec = p.wire.decode_frame(frame)
            return frame, dec, p.wire.unpack_blobs(dec[1])

        frame, dec, blobs = both(case, tmp_path)
        assert dec[0] == {"kind": "offer", "doc": DOC, "epoch": 2,
                          "proc": "a"}
        assert blobs == [b"one", b"", b"three"]

    def test_malformed_frames_counted_not_raised(self, tmp_path):
        def case(p, tmp):
            return [p.wire.decode_frame(b"garbage"),
                    p.wire.decode_frame(b"CFR1\xff\xff\xff\xff"),
                    p.wire.decode_frame(p.wire.encode_frame({"kind": "nope"})),
                    p.wire.unpack_blobs(b"\x02\x00\x00\x00")]

        assert both(case, tmp_path) == [None] * 4
        tracer = set_tracer(Tracer(enabled=True))
        case(PKGS["port"], tmp_path)
        assert tracer.counters()["fleet.frames_malformed"] == 4

    def test_fabric_drops_malformed_without_counting_codec(self, tmp_path):
        def case(p, tmp):
            fab = p.MemFabric()
            node = p.FleetNode("a", MEMBERS, fab, beacon_every=0,
                               server_kw=dict(SERVER_KW), **p.kw)
            fab.send("b", "a", b"not a frame")
            return node.drain_inbox(), node.server._docs, fab.sent

        assert both(case, tmp_path) == (1, {}, 1)


# ---- in place of the README registry pin ---------------------------


REGISTRY = (
    "fleet.fence_rejects", "fleet.fork_refused", "fleet.redirects",
    "fleet.demotions", "fleet.beacons_sent", "fleet.frames_malformed",
    "fleet.advice_dups", "fleet.migrations_started", "migration.started",
    "migration.completed", "migration.recovery", "migration.tail_blobs",
    "migration.tail_restores", "snap.fallbacks",
)


def test_fleet_counter_keys_match_reference(tmp_path):
    """The reference pins these names in its README registry; over one
    scenario that emits every one of them (a redirect, a malformed
    frame, duplicated advice, a buffered tail, a dropped ack, a
    destination crash after commit, a fork attempt, a demotion, a
    damaged offer and a stale-epoch restore) the port's tracer emits
    the reference's keys, labels included, with the same counts."""
    def case(p, tmp):
        faults = p.HandoffFaultSchedule(seed=3, windows=[{
            "src": "c", "dst": "a", "kinds": ("ack",), "mode": "drop"}])
        fab, nodes, stores = make_fleet(p, tmp, faults=faults,
                                        beacon_every=2)
        seed_doc(p, nodes)
        redirect = nodes["b"].submit(DOC, chain_blob(p, 7, 16))
        fab.send("b", "a", b"not a frame")
        loop = p.PlacementLoop(p.HashRing(MEMBERS, vnodes=64), nodes.get,
                               hysteresis=1)
        sched = p.DuplicateAdviceSchedule(seed=7, duplicate=0.9,
                                          replay=0.9)
        row = {"action": "rebalance_away", "tenant": DOC, "proc": "a",
               "seq": 1, "burn": 1.3, "target": "c"}
        started = loop.observe(0, sched.mangle(0, [row]))
        buffered = nodes["a"].submit(DOC, chain_blob(p, 7, 16))
        run_ticks(p, fab, nodes, 12)
        fab.kill("c")
        revive(p, fab, nodes, stores, "c", beacon_every=2)
        nodes["a"].lease._leases[DOC] = (2, "a")   # a rival at epoch 2
        nodes["a"].server.submit(DOC, chain_blob(p, 7, 0))
        run_ticks(p, fab, nodes, 4)
        nodes["b"].lease.grant(DOC, 5, "b")        # a newer owner
        nodes["b"].server.submit(DOC, chain_blob(p, 7, 0))
        run_ticks(p, fab, nodes, 4)
        damaged = p.adopt_doc(nodes["b"].server, "z", b"not a snapshot",
                              [chain_blob(p, 9, 0)])
        store = p.Store(str(tmp / p.name / "fenced"))
        writer = p.LeaseTable("a", p.HashRing(["a", "b"], vnodes=64))
        writer.grant("w", 5, "a")
        _seeded_server(p, store).checkpoint(fence=writer)
        stale = p.Server(snap_store=store, **SERVER_KW, **p.kw).restore(
            fence=p.LeaseTable("a", p.HashRing(["a", "b"], vnodes=64)))
        return (redirect, started, buffered, damaged, stale,
                fleet_state(fab, nodes))

    counters = {}

    def counted(p, tmp):
        tracer = p.set_tracer(p.Tracer(enabled=True))
        out = case(p, tmp)
        counters[p.name] = dict(tracer.counters())
        return out

    redirect, started, buffered, damaged, stale, st = both(counted,
                                                           tmp_path)
    assert redirect == ("redirect", "a") and len(started) == 1
    assert buffered == ("buffered", None) and not damaged and stale == 0
    assert st["serving"][DOC] == ["b"]
    got = {k: v for k, v in counters["port"].items()
           if k.startswith(FLEET_NS)}
    assert got == {k: v for k, v in counters["ref"].items()
                   if k.startswith(FLEET_NS)}
    assert set(REGISTRY) <= {k.split("{")[0] for k in got}
    assert {'migration.recovery{step="ack"}',
            'snap.fallbacks{reason="rehydrate"}',
            'snap.fallbacks{reason="stale_epoch"}',
            'fleet.fence_rejects{op="serve"}'} <= set(got)


# ---- the port's device seam ----------------------------------------


def test_node_builds_its_server_on_its_device(tmp_path):
    node = fleet.FleetNode("a", MEMBERS, fleet.MemFabric(), device="cpu",
                           server_kw=dict(SERVER_KW))
    assert node.device.type == node.server.device.type == "cpu"
    with pytest.raises(ValueError, match="has a server on"):
        fleet.FleetNode("a", MEMBERS, None, device="cpu",
                        server_kw={"device": "meta"})
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fleet.FleetNode("a", MEMBERS, fleet.MemFabric())


# ---- across the packages --------------------------------------------


FRAMES = [
    ({"kind": "update", "doc": DOC, "epoch": 1, "proc": "a"}, b"\x01\x02"),
    ({"kind": "offer", "doc": "w07", "epoch": 2, "proc": "a",
      "mode": "snap"}, None),
    ({"kind": "beacon", "proc": "c",
      "docs": {"d%d" % i: 1 + i % 3 for i in range(40)}}, b""),
    ({"kind": "probe_reply", "doc": "unicodé ✓", "epoch": 9,
      "owner": "b", "proc": "b"}, b"\xff" * 3),
    ({"kind": "redirect", "doc": "tenant-0", "epoch": 3, "owner": "c",
      "proc": "a", "extra": [1, 2.5, None, True]}, b"x" * 4096),
]
BLOB_LISTS = [[], [b""], [b"one", b"", b"three"], [bytes(range(256)) * 9]]
DAMAGED = [b"", b"CFR1", b"CFR2\x00\x00\x00\x00", b"CFR1\x02\x00\x00\x00[]",
           b"CFR1\x05\x00\x00\x00{\"a\":", b"\x01\x00\x00\x00",
           b"\x01\x00\x00\x00\x05\x00\x00\x00ab",
           b"\x00\x00\x00\x00trailing"]


@pytest.mark.parametrize("i", range(len(FRAMES)))
def test_frames_byte_equal_across_packages(i):
    hdr, blob = FRAMES[i]
    payload = wire.pack_blobs(BLOB_LISTS[i % len(BLOB_LISTS)]) \
        if blob is None else blob
    frame = wire.encode_frame(hdr, payload)
    assert frame == ref_wire.encode_frame(hdr, payload)
    assert wire.decode_frame(frame) == ref_wire.decode_frame(frame) == \
        (hdr, payload)
    for lst in BLOB_LISTS:
        packed = wire.pack_blobs(lst)
        assert packed == ref_wire.pack_blobs(lst)
        assert wire.unpack_blobs(packed) == lst
    for bad in DAMAGED:
        assert wire.decode_frame(bad) == ref_wire.decode_frame(bad)
        assert wire.unpack_blobs(bad) == ref_wire.unpack_blobs(bad)


# the handoff schedule of bench.py's rebalance leg: every ack on c->a
# dropped, every commit on a->c duplicated
HANDOFF_WINDOWS = [
    {"src": "c", "dst": "a", "kinds": ("ack",), "mode": "drop"},
    {"src": "a", "dst": "c", "kinds": ("commit",), "mode": "dup"},
]


@pytest.mark.parametrize("src_pkg,dst_pkg", [("port", "ref"),
                                             ("ref", "port")])
def test_port_and_reference_nodes_hand_a_doc_to_each_other(
        tmp_path, src_pkg, dst_pkg):
    """"a" (one package) owns a warm doc and hands it to "c" (the other
    package) on one ``MemFabric`` under the handoff schedule while the
    doc keeps taking updates; "c" then hands it back. Each hop ends with
    one serving node, and the doc byte-identical to single-server
    oracles of both packages fed the same blobs in the same order."""
    S, D = PKGS[src_pkg], PKGS[dst_pkg]
    pkg_of = {"a": S, "b": S, "c": D}
    faults = S.HandoffFaultSchedule(seed=7, windows=HANDOFF_WINDOWS)
    fab = S.MemFabric(faults=faults)
    nodes = {q: pkg_of[q].FleetNode(
        q, MEMBERS, fab, store=pkg_of[q].Store(str(tmp_path / q)),
        timeout_ticks=3, beacon_every=4, server_kw=dict(SERVER_KW),
        **pkg_of[q].kw) for q in MEMBERS}
    oracles = {name: p.Server(**SERVER_KW, **p.kw)
               for name, p in PKGS.items()}
    blobs = iter([chain_blob(S, 7, 4 * k) for k in range(40)])
    backlog = []

    def tick():
        # a redirect-chasing client that keeps an update no process
        # takes (the lease moved, the commit not landed yet) for the
        # next tick, in order
        backlog.append(next(blobs))
        routes = []
        while backlog:
            r = next((r for r, _ in (nodes[q].submit(DOC, backlog[0])
                                     for q in MEMBERS)
                      if r in ("ok", "buffered")), "retry")
            routes.append(r)
            if r == "retry":
                break
            for o in oracles.values():
                o.submit(DOC, backlog[0])
            backlog.pop(0)
        for o in oracles.values():
            o.tick()
        for q in MEMBERS:
            nodes[q].tick()
        return routes

    routes = sum((tick() for _ in range(4)), [])
    for src, dst, epoch in (("a", "c", 2), ("c", "a", 3)):
        assert nodes[src].migrate(DOC, dst)
        for _ in range(14):
            routes += tick()
        assert not backlog
        assert serving(nodes) == [dst]
        assert all(nodes[q].lease.lease(DOC) == (epoch, dst)
                   for q in MEMBERS)
        got = engine_state(nodes[dst].server, DOC, pkg_of[dst])
        for name, o in oracles.items():
            assert got == engine_state(o, DOC, PKGS[name]), (src, name)
    assert "buffered" in routes
    assert nodes["a"].migrator.completed == nodes["c"].migrator.completed \
        == 1
    assert nodes["a"].migrator.recoveries == {"ack": 1}
    assert faults.window_hits >= 2 and fab.duplicated >= 1
    assert all(nodes[q].lease.fork_refused == 0 for q in MEMBERS)


LOAD_CASES = {
    "pooled": {},
    "unpooled": {"pool": False},
    "budgeted": {"resident_max_bytes": 60_000, "tenant_max_pending_bytes":
                 4096},
}


@pytest.mark.parametrize("kw", LOAD_CASES.values(), ids=list(LOAD_CASES))
def test_load_equal_across_packages(tmp_path, kw):
    """``FleetNode.load()`` (pending bytes + resident bytes, the
    rebalance hint's input) equals the reference's after the same
    submissions: cold docs, warm docs promoted and advancing, pending
    blobs not yet ticked, and evictions under a resident budget."""
    from crdt_tpu_torch.models import traces

    docs = traces.build_doc_trace(6, 24, 1, 300, seed=3)
    streams = [traces._SteadyStream(40 + i) for i in range(4)]
    nodes = {name: p.FleetNode(
        "a", ["a"], p.MemFabric(), store=p.Store(str(tmp_path / name)),
        server_kw=dict(SERVER_KW, **kw), **p.kw)
        for name, p in PKGS.items()}
    loads = []
    for t in range(6):
        batch = [(d, b) for d, bl in docs.items() for b in bl] if t == 0 \
            else []
        batch += [("s%d" % i, s.delta(200 if t == 0 else 16))
                  for i, s in enumerate(streams)]
        for n in nodes.values():
            for d, b in batch:
                assert n.submit(d, b)[0] == "ok"
        loads.append([n.load() for n in nodes.values()])
        for n in nodes.values():
            n.tick()
        loads.append([n.load() for n in nodes.values()])
    assert all(a == b for a, b in loads)
    assert max(a for a, _ in loads) > 0


def test_rebalance_leg_equals_bench(monkeypatch):
    """``chip_smoke.rebalance_leg(device="cpu")`` (the port's copy of
    ``bench.py --rebalance``'s leg, which phase 13 runs on the card)
    returns ``bench.rebalance_leg()``'s dict field by field, under the
    same seed and the same shortened flood and sustain ticks (the
    shortest that still see the placement loop move the flooder)."""
    import bench
    import chip_smoke

    flood, sustain = 4, 14
    monkeypatch.setenv("BENCH_RB_SEED", str(chip_smoke.RB_SEED))
    monkeypatch.setenv("BENCH_RB_FLOOD_TICKS", str(flood))
    monkeypatch.setenv("BENCH_RB_SUSTAIN_TICKS", str(sustain))
    for name in ("BENCH_RB_HYSTERESIS", "BENCH_RB_RECOVERY_BUDGET"):
        monkeypatch.delenv(name, raising=False)
    got = chip_smoke.rebalance_leg("cpu", flood_ticks=flood,
                                   sustain_ticks=sustain, warmup=False)
    want = bench.rebalance_leg()
    assert list(got) == list(want)
    for key in want:
        assert got[key] == want[key], key
    assert got["double_serves"] == got["forks"] == 0
    assert got["all_identical"] and got["migrations_completed"] >= 1
    assert got["hops"] and got["recoveries_by_step"].get("ack")


def test_engine_snapshot_key_order_follows_cache_reads():
    """Reference behaviour seen through the port (ROADMAP C): a resident
    engine rebuilds its cache lazily on read, and new map keys enter it
    in each rebuild's order, so ``encode_engine``'s bytes depend on when
    the cache was read. Two servers take the same blobs in the same
    ticks, one read between the last two: equal digests, state vectors
    and full-state updates, engine snapshots that differ in the cache's
    key order, and the same bytes in both packages. Phase 13's oracle
    therefore reads a moved doc whenever the fleet did."""
    def rec(p, client, clock, root, key, val):
        return p.v1.encode_update([p.ItemRecord(
            client=client, clock=clock, parent_root=root, key=key,
            content=val)], p.DeleteSet())

    out = {}
    for name, p in PKGS.items():
        for read_between in (True, False):
            srv = p.Server(**SERVER_KW, **p.kw)
            srv.submit("d", p.v1.encode_update([
                p.ItemRecord(client=1, clock=0, parent_root="n", key="x",
                             content=1),
                p.ItemRecord(client=1, clock=1, parent_root="n", key="y",
                             content=2)], p.DeleteSet()))
            srv.tick()
            srv.submit("d", rec(p, 1, 2, "n", "z", 3))
            srv.tick()                     # promoted: resident from here
            srv.submit("d", rec(p, 2, 0, "m", "y", 4))
            srv.tick()
            if read_between:
                srv.digest("d")
            srv.submit("d", rec(p, 3, 0, "m", "x", 5))
            srv.tick()
            eng = srv._docs["d"].resident
            assert eng is not None
            out[name, read_between] = (
                list(eng.cache["m"]), srv.digest("d"),
                eng.state_vector().clocks, eng.encode_state_as_update(),
                p.encode_engine(eng, seq=0))
    for name in PKGS:
        read, unread = out[name, True], out[name, False]
        assert (read[0], unread[0]) == (["y", "x"], ["x", "y"])
        assert read[1:4] == unread[1:4]
        assert read[4] != unread[4]
    assert out["port", True] == out["ref", True]
    assert out["port", False] == out["ref", False]


def _small_tenants(traces, chip_smoke):
    """Phase 10's tenants in small: cold docs, 8 warm ``_SteadyStream``
    docs with their blobs tick by tick, and one pooled server's digests
    after each tick, as ``multidoc_phase`` returns them."""
    from crdt_tpu_torch.codec import v1 as v1_
    from crdt_tpu_torch.core.ids import DeleteSet as DS
    from crdt_tpu_torch.core.records import ItemRecord as IR

    cold = traces.build_doc_trace(30, 16, 2, 300, seed=5)
    names = ["w%02d" % i for i in range(8)]
    streams = [traces._SteadyStream(500 + i) for i in range(8)]
    ticks = [dict(zip(names, (s.delta(400) for s in streams)))]
    ticks += [dict(zip(names, (s.delta(chip_smoke.WARM_DELTA)
                               for s in streams))) for _ in range(6)]
    extra = {d: [s.delta(chip_smoke.WARM_DELTA), v1_.encode_update([IR(
        client=1_000_000 + i, clock=0, parent_root="m", key="k0",
        content=-i)], DS())] for i, (d, s) in enumerate(zip(names, streams))}
    srv = MultiDocServer(device="cpu", pool=True,
                         max_rows_per_dispatch=chip_smoke.COLD_MAX_ROWS)
    for d, bl in cold.items():
        srv.submit_many(d, bl)
    digests = []
    for t, blobs in enumerate(ticks):
        for d, b in blobs.items():
            srv.submit(d, b)
        srv.tick()
        digests.append({d: srv.digest(d) for d in names})
        if t == 0:
            cold_digests = {d: srv.digest(d) for d in cold}
    return {"cold": cold, "cold_digests": cold_digests, "names": names,
            "streams": streams, "ticks": ticks, "tick_digests": digests,
            "extra": extra}


def test_fleet_phase_on_the_cpu(monkeypatch):
    """Phase 13 (b) as a whole (``chip_smoke.fleet_phase``) at a small
    size on the CPU: the cold tick equal to one server's digests and the
    big tenant's cache to the device route, "a"'s warm docs and the big
    tenant live-migrated under the handoff chaos, each moved doc
    byte-equal to the oracle, each destination's next tick one pool
    dispatch, "a" killed and revived with every digest unchanged."""
    import json

    import chip_smoke
    import torch
    from crdt_tpu_torch.models import replay, traces
    from crdt_tpu_torch.ops import kernels, packed

    monkeypatch.setenv("CRDT_TPU_DEVICE_MIN", "1")
    tenants = _small_tenants(traces, chip_smoke)
    big = traces.build_trace(20, 30, seed=0)
    cache = json.dumps(replay.replay_trace(big, device="cpu").cache,
                       sort_keys=True)
    held = []
    out = chip_smoke.fleet_phase(torch, kernels, packed, traces,
                                 lambda *a: held.append(a), tenants, big,
                                 cache, device="cpu")
    rec = out["record"]
    assert rec["double_serves"] == 0 and rec["completed"] == 2
    assert set(rec["migrations"]) == {"w07", chip_smoke.FLEET_BIG}
    assert rec["recoveries"] == {'migration.recovery{step="ack"}': 1}
    assert rec["tail_blobs"] > 0 and rec["fabric"]["duplicated"] == 1
    for cost in rec["migrations"].values():
        assert {"ticks", "seconds", "offer_bytes", "encode_engine_s",
                "encode_state_as_update_s", "rehydrate_s"} <= set(cost)
    assert out["rows"]["fleet"][0] and held
