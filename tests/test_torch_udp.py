"""The port's UDP router, its pump and the fault/NAT layer
(``crdt_tpu_torch.net.udp_router`` / ``.faults``) against the
reference's, on the CPU over real sockets on 127.0.0.1.

The router cases of the reference's ``tests/test_transport.py`` run on
the port's routers and replicas, and where the case allows, on a
*mixed* swarm: port and reference routers alternate, each carrying a
replica of its own package — the wire-compatibility test. The seeded
fault and NAT decisions must equal the reference's over a grid, and a
resident port replica (``device="cpu"``) synced over UDP under faults
must end with the reference replica's cache. Deadlines are the
reference tests' own.
"""

import time

import pytest

from crdt_tpu.net import faults as ref_faults
from crdt_tpu.net.replica import Replica as RefReplica
from crdt_tpu.net.udp_router import UdpRouter as RefUdpRouter
from crdt_tpu_torch.codec.lib0 import Encoder
from crdt_tpu_torch.net import faults, transport
from crdt_tpu_torch.net import (
    ConeNat,
    FaultSchedule,
    NatFabric,
    Partition,
    Replica,
    SymmetricNat,
    UdpRouter,
    install_faults,
    install_nat,
    pump,
    pump_until,
)
from crdt_tpu_torch.obs import Tracer, set_tracer

STACKS = ("port", "mixed")


def _router(stack, i, **kw):
    """The ``i``-th router of a swarm: the port's, or on a mixed swarm
    the port's and the reference's in turn."""
    if stack == "mixed" and i % 2:
        return RefUdpRouter(**kw)
    return UdpRouter(**kw)


def _replica(router, **kw):
    """A replica of the router's own package."""
    cls = RefReplica if isinstance(router, RefUdpRouter) else Replica
    return cls(router, **kw)


def _mesh(stack, n):
    routers = [_router(stack, i) for i in range(n)]
    for i, r in enumerate(routers):
        for other in routers[:i]:
            r.add_peer(*other.addr)
    pump(routers)
    return routers


def _close(routers):
    for r in routers:
        r.close()


# ---------------------------------------------------------------------------
# the router contract over UDP
# ---------------------------------------------------------------------------


class TestUdpRouter:
    @pytest.mark.parametrize("stack", STACKS)
    def test_handshake_builds_full_mesh(self, stack):
        routers = _mesh(stack, 3)
        try:
            for r in routers:
                assert len(r.peers) == 2
        finally:
            _close(routers)

    @pytest.mark.parametrize("stack", STACKS)
    def test_two_replicas_converge(self, stack):
        routers = _mesh(stack, 2)
        try:
            r1 = _replica(routers[0], topic="room", client_id=1)
            r2 = _replica(routers[1], topic="room", client_id=2)
            pump(routers)
            r1.set("users", "alice", {"role": "admin"})
            r2.set("users", "bob", {"role": "guest"})
            pump(routers)
            assert r1.c == r2.c
            assert r1.c["users"]["alice"] == {"role": "admin"}
            assert r1.c["users"]["bob"] == {"role": "guest"}
        finally:
            _close(routers)

    @pytest.mark.parametrize("stack", STACKS)
    def test_late_joiner_syncs_existing_state(self, stack):
        routers = _mesh(stack, 2)
        try:
            r1 = _replica(routers[0], topic="room", client_id=1)
            pump(routers)
            r1.set("cfg", "mode", "dark")
            r1.push("log", ["a", "b"])
            pump(routers)
            late = _router(stack, 1)
            routers.append(late)
            r3 = _replica(late, topic="room", client_id=3)
            late.add_peer(*routers[0].addr)
            pump(routers)
            assert r3.c == r1.c
            assert r3.c["cfg"]["mode"] == "dark"
        finally:
            _close(routers)

    def test_convergence_under_loss(self):
        routers = _mesh("port", 2)
        try:
            for r in routers:
                r.endpoint.set_loss(150, seed=11)
            r1 = Replica(routers[0], topic="room", client_id=1)
            r2 = Replica(routers[1], topic="room", client_id=2)
            pump(routers, timeout_s=30.0)
            for i in range(10):
                (r1 if i % 2 else r2).set("kv", f"k{i}", i)
            pump(routers, timeout_s=30.0)
            assert r1.c == r2.c
            assert len(r1.c["kv"]) == 10
        finally:
            _close(routers)

    def test_malformed_hello_rejected(self):
        """A hello with a short / non-hex / uppercase key does not
        poison the peer table; uppercase hex of a real key is accepted
        and normalized."""
        def hello(pk):
            enc = Encoder()
            enc.write_any({"pk": pk, "ack": True})
            return bytes([0]) + enc.to_bytes()

        with transport.UdpEndpoint() as attacker:
            target = UdpRouter()
            try:
                for bad in ("aa", "", "zz" * 32, 123):
                    attacker.send("127.0.0.1", target.endpoint.port,
                                  hello(bad))
                deadline = time.monotonic() + 5
                while time.monotonic() < deadline and (
                        attacker.pending or target.endpoint.pending):
                    attacker.poll()
                    target.poll()
                    time.sleep(0.002)
                target.poll()
                assert target.peers == []
                pub, _ = transport.keypair()
                attacker.send("127.0.0.1", target.endpoint.port,
                              hello(pub.hex().upper()))
                deadline = time.monotonic() + 5
                while time.monotonic() < deadline and not target.peers:
                    attacker.poll()
                    target.poll()
                    time.sleep(0.002)
                assert target.peers == [pub.hex()]
            finally:
                target.close()

    @pytest.mark.parametrize("stack", STACKS)
    def test_envelope_from_unknown_peer_triggers_rehandshake(self, stack):
        routers = _mesh(stack, 2)
        try:
            r1 = _replica(routers[0], topic="room", client_id=1)
            r2 = _replica(routers[1], topic="room", client_id=2)
            pump(routers)
            r1.set("m", "k", 1)
            pump(routers)
            routers[0]._peers.clear()  # a restart losing peer state
            r2.set("m", "k2", 2)
            pump(routers)
            assert r1.c == r2.c
        finally:
            _close(routers)


class TestRendezvousDiscovery:
    @pytest.mark.parametrize("stack", STACKS)
    def test_three_routers_discover_via_bootstrap_only(self, stack):
        # on the mixed swarm the rendezvous is the reference's
        boot = _router(stack, 1, rendezvous=True)
        members = [_router(stack, i, bootstrap=[boot.addr])
                   for i in range(3)]
        routers = [boot] + members
        try:
            reps = [_replica(r, topic="room", client_id=i + 1)
                    for i, r in enumerate(members)]
            pump(routers, timeout_s=20.0)
            for m in members:
                others = {x.public_key for x in members if x is not m}
                assert others <= set(m.peers), (m.public_key, m.peers)
            reps[0].set("m", "k0", 0)
            reps[1].push("l", "v1")
            reps[2].set("m", "k2", 2)
            pump(routers, timeout_s=20.0)
            first = dict(reps[0].c)
            assert first == dict(reps[1].c) == dict(reps[2].c)
            assert first["m"] == {"k0": 0, "k2": 2}
        finally:
            _close(routers)

    def test_late_joiner_discovers_existing_swarm(self):
        boot = UdpRouter(rendezvous=True)
        a = UdpRouter(bootstrap=[boot.addr])
        b = UdpRouter(bootstrap=[boot.addr])
        routers = [boot, a, b]
        try:
            ra = Replica(a, topic="room", client_id=1)
            rb = Replica(b, topic="room", client_id=2)
            pump(routers, timeout_s=20.0)
            ra.set("m", "k", "early")
            pump(routers, timeout_s=20.0)
            late_r = UdpRouter(bootstrap=[boot.addr])
            routers.append(late_r)
            late = Replica(late_r, topic="room", client_id=3)
            pump(routers, timeout_s=20.0)
            assert late.c["m"] == {"k": "early"}
            assert rb.c == ra.c == late.c
        finally:
            _close(routers)

    def test_rendezvous_node_subscribes_nothing(self):
        boot = UdpRouter(rendezvous=True)
        a = UdpRouter(bootstrap=[boot.addr])
        b = UdpRouter(bootstrap=[boot.addr])
        routers = [boot, a, b]
        try:
            ra = Replica(a, topic="room", client_id=1)
            rb = Replica(b, topic="room", client_id=2)
            pump(routers, timeout_s=20.0)
            assert boot._handlers == {}
            ra.set("m", "k", 1)
            pump(routers, timeout_s=20.0)
            assert rb.c["m"] == {"k": 1}
        finally:
            _close(routers)


class TestIntroductionPunch:
    def test_intro_makes_both_sides_dial_observed_addresses(self):
        boot = UdpRouter(rendezvous=True)
        a = UdpRouter(bootstrap=[boot.addr])
        routers = [boot, a]
        try:
            ra = Replica(a, topic="room", client_id=1)
            pump(routers, timeout_s=20.0)
            dials: dict = {"a": [], "b": []}

            def spy(router, key):
                orig = router._send_hello

                def send_hello(ip, port, **kw):
                    dials[key].append((ip, port))
                    return orig(ip, port, **kw)

                router._send_hello = send_hello

            spy(a, "a")
            b = UdpRouter(bootstrap=[boot.addr])
            routers.append(b)
            spy(b, "b")
            rb = Replica(b, topic="room", client_id=2)
            pump(routers, timeout_s=20.0)
            assert b.addr in dials["a"], (dials, b.addr)
            assert a.addr in dials["b"], (dials, a.addr)
            assert a.public_key in b.peers and b.public_key in a.peers
            rb.set("m", "k", 1)
            pump(routers, timeout_s=20.0)
            assert dict(ra.c) == dict(rb.c)
        finally:
            _close(routers)

    def test_hello_survives_unopened_window(self):
        a = UdpRouter()
        b = UdpRouter()
        try:
            a.start()
            b.start()
            a.add_peer(*b.addr)  # one dial, before b ever polls
            deadline = time.monotonic() + 1.0
            while time.monotonic() < deadline:
                a.poll()
                time.sleep(0.002)
            assert b.public_key not in a.peers
            pump([a, b], timeout_s=20.0)
            assert b.public_key in a.peers
            assert a.public_key in b.peers
        finally:
            a.close()
            b.close()


# ---------------------------------------------------------------------------
# symmetric-NAT traversal: port prediction + relay fallback
# ---------------------------------------------------------------------------


def _nat_pair(nat_a, nat_b, **router_kw):
    """Rendezvous + two members behind simulated NATs on one virtual
    fabric. Returns (routers, a, b)."""
    fabric = NatFabric()
    boot = UdpRouter(rendezvous=True)
    install_nat(boot, fabric)
    router_kw.setdefault("dial_retry_s", 0.05)
    a = UdpRouter(bootstrap=[boot.addr], **router_kw)
    install_nat(a, fabric, nat_a)
    b = UdpRouter(bootstrap=[boot.addr], **router_kw)
    install_nat(b, fabric, nat_b)
    return [boot, a, b], a, b


class TestSymmetricNatTraversal:
    def test_introduction_alone_is_filtered(self):
        routers, a, b = _nat_pair(
            SymmetricNat(21000), SymmetricNat(23000),
            port_prediction=False, relay_after_s=3600.0,
            dial_retry_s=3600.0,
        )
        try:
            Replica(a, topic="room", client_id=1)
            Replica(b, topic="room", client_id=2)
            deadline = time.monotonic() + 1.5
            while time.monotonic() < deadline:
                for r in routers:
                    r.poll()
                time.sleep(0.002)
            assert b.public_key not in a.peers
            assert a.public_key not in b.peers
            assert a.endpoint.stats["filtered"] > 0
            assert b.endpoint.stats["filtered"] > 0
        finally:
            _close(routers)

    def test_converges_via_port_prediction(self):
        tracer = set_tracer(Tracer(enabled=True))
        routers, a, b = _nat_pair(
            SymmetricNat(21000), ConeNat(22000),
            predict_after=1, relay_after_s=3600.0,
        )
        try:
            ra = Replica(a, topic="room", client_id=1)
            rb = Replica(b, topic="room", client_id=2)
            pump_until(
                routers,
                lambda: (b.public_key in a._peers
                         and a._peers[b.public_key].direct
                         and a.public_key in b._peers
                         and b._peers[a.public_key].direct),
                timeout_s=30.0,
            )
            assert a.stats["predict_probes"] > 0
            assert tracer.counters("router.")["router.dial_retries"] > 0
            ra.set("m", "ka", 1)
            rb.set("m", "kb", 2)
            pump_until(
                routers,
                lambda: dict(ra.c) == dict(rb.c)
                and ra.c.get("m", {}).get("kb") == 2,
                timeout_s=30.0,
            )
            assert a._peers[b.public_key].addr[1] >= 22000
        finally:
            set_tracer(Tracer(enabled=False))
            _close(routers)


class TestRelayFallback:
    def test_converges_via_relay_with_prediction_disabled(self):
        tracer = set_tracer(Tracer(enabled=True))
        routers, a, b = _nat_pair(
            SymmetricNat(21000), SymmetricNat(23000),
            port_prediction=False, relay_after_s=0.3,
        )
        boot = routers[0]
        try:
            ra = Replica(a, topic="room", client_id=1,
                         probe_retry_s=0.1, anti_entropy_s=0.2)
            rb = Replica(b, topic="room", client_id=2,
                         probe_retry_s=0.1, anti_entropy_s=0.2)
            ra.set("m", "ka", 1)
            rb.set("m", "kb", 2)
            pump_until(
                routers,
                lambda: dict(ra.c) == dict(rb.c)
                and ra.c.get("m", {}).get("kb") == 2
                and ra.c.get("m", {}).get("ka") == 1,
                timeout_s=30.0,
            )
            pa = a._peers[b.public_key]
            assert not pa.direct and pa.relay == boot.public_key
            assert boot.stats["relay_frames_forwarded"] > 0
            assert boot.stats["relay_bytes_forwarded"] > 0
            assert a.stats["relay_sends"] > 0
            counters = tracer.counters("router.relay")
            assert counters["router.relay_frames_forwarded"] > 0
            assert counters["router.relay_elections"] > 0
        finally:
            set_tracer(Tracer(enabled=False))
            _close(routers)

    def test_later_probe_success_upgrades_relay_to_direct(self):
        routers, a, b = _nat_pair(
            SymmetricNat(21000), ConeNat(22000),
            port_prediction=False, relay_after_s=0.2, predict_after=1,
        )
        try:
            ra = Replica(a, topic="room", client_id=1)
            rb = Replica(b, topic="room", client_id=2)
            ra.set("m", "early", 7)
            pump_until(routers,
                       lambda: rb.c.get("m", {}).get("early") == 7,
                       timeout_s=30.0)
            assert not a._peers[b.public_key].direct
            a._port_prediction = True
            b._port_prediction = True
            pump_until(routers,
                       lambda: a._peers[b.public_key].direct
                       and b._peers[a.public_key].direct,
                       timeout_s=30.0)
            assert a._peers[b.public_key].relay is None
            assert a.stats["relay_upgrades"] + b.stats["relay_upgrades"] > 0
            ra.set("m", "late", 8)
            pump_until(routers, lambda: rb.c.get("m", {}).get("late") == 8,
                       timeout_s=15.0)
        finally:
            _close(routers)

    def test_fresh_intro_reopens_expired_dial_for_relayed_peer(self):
        routers, a, b = _nat_pair(
            SymmetricNat(21000), ConeNat(22000),
            port_prediction=False, relay_after_s=0.2, predict_after=1,
            dial_give_up_s=0.5,
        )
        boot = routers[0]
        try:
            Replica(a, topic="room", client_id=1).set("m", "x", 1)
            rb = Replica(b, topic="room", client_id=2)
            pump_until(routers, lambda: rb.c.get("m", {}).get("x") == 1,
                       timeout_s=30.0)
            end = time.monotonic() + 0.8  # let the 0.5 s dials expire
            while time.monotonic() < end:
                for r in routers:
                    r.poll()
                time.sleep(0.002)
            assert not a._dials and not b._dials
            assert not a._peers[b.public_key].direct
            a._port_prediction = True
            b._port_prediction = True
            bs = boot._peers
            for src, dst in ((a, b), (b, a)):
                src._apply_intro(
                    {"peers": [{"pk": dst.public_key,
                                "ip": bs[dst.public_key].addr[0],
                                "port": bs[dst.public_key].addr[1]}]},
                    introducer=boot.public_key,
                )
            assert b.public_key in a._dials
            pump_until(routers,
                       lambda: a._peers[b.public_key].direct
                       and b._peers[a.public_key].direct,
                       timeout_s=30.0)
            assert a._peers[b.public_key].relay is None
        finally:
            _close(routers)

    def test_saturated_relay_sheds_and_recovers(self):
        fabric = NatFabric()
        boot = UdpRouter(rendezvous=True, relay_budget_bytes=400,
                         relay_refill_bps=1500)
        install_nat(boot, fabric)
        kw = dict(bootstrap=[boot.addr], dial_retry_s=0.05,
                  port_prediction=False, relay_after_s=0.2)
        a = UdpRouter(**kw)
        install_nat(a, fabric, SymmetricNat(21000))
        b = UdpRouter(**kw)
        install_nat(b, fabric, SymmetricNat(23000))
        routers = [boot, a, b]
        try:
            ra = Replica(a, topic="room", client_id=1,
                         probe_retry_s=0.1, anti_entropy_s=0.15)
            rb = Replica(b, topic="room", client_id=2,
                         probe_retry_s=0.1, anti_entropy_s=0.15)
            for i in range(8):
                (ra if i % 2 else rb).set("m", f"k{i}", i)
            pump_until(routers,
                       lambda: dict(ra.c) == dict(rb.c)
                       and len(ra.c.get("m", {})) == 8,
                       timeout_s=40.0)
            assert boot.stats["relay_sheds"] > 0
        finally:
            _close(routers)


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_synced_joiner_that_loses_its_answers_stalls_until_probed(pkg):
    """A replica built before it hears any peer takes itself for the
    solo first node and is synced with nothing. When its peer appears,
    the peer's state reaches it only as the answers to the two
    ``peer_joined`` probes. If those are lost, nothing retries a synced
    replica's probe: the join stalls for good, in both packages alike
    (ROADMAP §C). One more probe, as ``chip_smoke.py``'s late join
    makes when it finds this stall, completes it."""
    router, rep = ((UdpRouter, Replica) if pkg == "port"
                   else (RefUdpRouter, RefReplica))
    routers = [router()]
    try:
        a = rep(routers[0], topic="room", client_id=1)
        pump(routers)
        a.set("cfg", "mode", "dark")
        a.push("log", ["a", "b"])
        pump(routers)
        late = router()
        routers.append(late)
        b = rep(late, topic="room", client_id=3)
        assert b.synced and not b.c
        lost: list = []
        send = a._to_peer

        def lose_updates(pk, msg):
            if "update" in msg:
                lost.append(msg)
            else:
                send(pk, msg)

        a._to_peer = lose_updates
        late.add_peer(*routers[0].addr)
        pump(routers)
        a._to_peer = send
        assert len(lost) == 2  # the answer and the back-diff
        for _ in range(3):  # the fabric is whole again; nothing retries
            pump(routers)
            assert b.synced and not b.c
        assert b.state_vector() != a.state_vector()
        b.probe()
        pump(routers)
        assert b.state_vector() == a.state_vector()
        assert b.c == a.c and b.c["cfg"]["mode"] == "dark"
    finally:
        _close(routers)


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_member_that_lost_its_rendezvous_proof_is_never_introduced(pkg):
    """The liveness challenge that proves a rendezvous's key is sent
    once, and only a member that proved it refreshes its announcement
    there. A member whose challenge was lost ages out of the
    rendezvous's introductions, and a newcomer that announces then is
    never introduced to it, not even after the member proves the key
    later: the rendezvous introduces only on a newly announced topic.
    Both packages alike (ROADMAP §C). A re-dial of the rendezvous, as
    ``chip_smoke.py``'s joins make, proves it, and the next newcomer
    meets the member."""
    router = UdpRouter if pkg == "port" else RefUdpRouter
    ttl = {"announce_ttl": 0.3}
    boot = router(rendezvous=True, **ttl)
    routers = [boot]

    def member(**kw):
        r = router(bootstrap=[boot.addr], **ttl, **kw)
        routers.append(r)
        r.start()
        r.alow("room", lambda msg, pk: None)
        return r

    def settle(rounds: int = 3) -> None:
        for _ in range(rounds):
            pump(routers)
            time.sleep(0.15)
        pump(routers)

    try:
        lost: list = []
        a = router(bootstrap=[boot.addr], **ttl)
        routers.append(a)
        a._challenge_liveness = lambda peer, addr: lost.append(addr)
        a.start()
        a.alow("room", lambda msg, pk: None)
        pump(routers)
        del a._challenge_liveness
        assert lost and a.public_key in boot.peers_on("room")
        assert boot.public_key not in a._rendezvous_pks
        settle()  # past A's TTL: A never refreshes its announcement
        b = member()
        settle()
        assert boot.public_key in b._rendezvous_pks
        assert a.public_key not in b.peers and b.public_key not in a.peers
        a.add_peer(*boot.addr)  # the re-dial: A proves R's key now
        settle()
        assert boot.public_key in a._rendezvous_pks
        assert a.public_key not in b.peers  # B's join stays stalled
        c = member()
        settle()
        assert a.public_key in c.peers_on("room")
        assert c.public_key in a.peers_on("room")
    finally:
        _close(routers)


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_lost_topic_announcement_to_a_direct_peer_stays_lost(pkg):
    """A router announces its topics to a direct peer once, when their
    hellos meet (only rendezvous and relay-routed peers get the
    refresh). If that announcement is lost, the peer never lists the
    router on the topic, in both packages alike (ROADMAP §C). A re-dial
    of the peer, as ``chip_smoke.py``'s joins make, makes both ends
    announce again."""
    router = UdpRouter if pkg == "port" else RefUdpRouter
    a, b = router(announce_ttl=0.3), router(announce_ttl=0.3)
    routers = [a, b]
    try:
        for r in routers:
            r.alow("room", lambda msg, pk: None)
        lost: list = []
        announce = b._announce_topics

        def lose_first(peer=None, targets=None):
            if peer is not None and peer.pk_hex == a.public_key \
                    and not lost:
                lost.append(peer.pk_hex)
                return
            announce(peer, targets)

        b._announce_topics = lose_first
        a.add_peer(*b.addr)
        for _ in range(3):
            pump(routers)
            time.sleep(0.15)
        del b._announce_topics
        assert lost and b.public_key in a.peers
        assert a.public_key in b.peers_on("room")
        assert b.public_key not in a.peers_on("room")
        a.add_peer(*b.addr)  # the re-dial
        pump(routers)
        assert b.public_key in a.peers_on("room")
    finally:
        _close(routers)


# ---------------------------------------------------------------------------
# the mixed swarm: one network, both packages
# ---------------------------------------------------------------------------


def _mixed_ops(r, i, n):
    for j in range(n):
        k = j % 4
        if k == 0:
            r.set("m", f"k{i}-{j % 5}", [i, j])
        elif k == 1:
            r.push("l", f"v{i}-{j}")
        elif k == 2:
            cur = r.get("l") or []
            r.insert("l", (i * 7 + j) % (len(cur) + 1), f"ins{i}-{j}")
        else:
            r.set("m", f"solo{i}", j)


@pytest.mark.parametrize("rendezvous", ["port", "reference"])
def test_mixed_swarm_converges_to_equal_caches(rendezvous):
    """A port router and a reference router, each with a replica of its
    own package, found through a rendezvous of either package, edit
    concurrently (map sets, list pushes, mid-inserts) and converge to
    equal caches and equal full states."""
    boot = (UdpRouter if rendezvous == "port" else RefUdpRouter)(
        rendezvous=True)
    pr = UdpRouter(bootstrap=[boot.addr])
    rr = RefUdpRouter(bootstrap=[boot.addr])
    routers = [boot, pr, rr]
    try:
        p = Replica(pr, topic="swarm", client_id=11)
        r = RefReplica(rr, topic="swarm", client_id=12)
        pump(routers, timeout_s=20.0)
        for step in range(3):
            _mixed_ops(p, 0, 12)
            _mixed_ops(r, 1, 12)
            pump(routers, timeout_s=20.0)
        assert dict(p.c) == dict(r.c)
        assert len(p.c["l"]) == 2 * 3 * 6
        assert p.encode_state_vector() == r.encode_state_vector()
        assert p.encode_state_as_update() == r.encode_state_as_update()
    finally:
        _close(routers)


# ---------------------------------------------------------------------------
# the seeded decisions, equal to the reference's
# ---------------------------------------------------------------------------


GRID = [(src, dst, n) for src in (4000, 4001, 51234) for dst in (4000, 4002)
        for n in range(40)]


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_fault_schedule_decisions_equal_reference(seed):
    kw = dict(drop=0.1, duplicate=0.2, delay=0.3, delay_polls=(1, 5),
              corrupt=0.05)
    ours = FaultSchedule(seed, **kw)
    theirs = ref_faults.FaultSchedule(seed, **kw)
    for src, dst, n in GRID:
        assert ours.decide(src, dst, n) == theirs.decide(src, dst, n)
    for key in [(seed, "drop", 1, 2, 3), (seed, "pos", 9, 9, 9), ()]:
        assert faults._hash01(*key) == ref_faults._hash01(*key)


@pytest.mark.parametrize("max_blocked", [None, 5])
def test_partition_decisions_equal_reference(max_blocked):
    def run(mod):
        part = mod.Partition({4000, 4001}, {4002}, max_blocked=max_blocked)
        sched = mod.FaultSchedule(3, drop=0.1, partition=part)
        out = [sched.decide(src, dst, n) for src, dst, n in GRID]
        part.heal()
        return out, part.blocked, part.blocks(4000, 4002)

    assert run(faults) == run(ref_faults)


@pytest.mark.parametrize("nat", ["SymmetricNat", "ConeNat"])
def test_nat_mapping_decisions_equal_reference(nat):
    def run(mod):
        n = getattr(mod, nat)(30000)
        fabric = mod.NatFabric()
        dsts = [("127.0.0.1", p) for p in (5000, 5001, 5000, 5002)]
        ports = [n.open_mapping(d) for d in dsts]
        accepts = [n.accept((ip, port), src) for ip in ("127.0.0.1", "1.2.3.4")
                   for port in range(29999, 30004)
                   for src in dsts + [("127.0.0.1", 6000)]]
        return ports, accepts, fabric.resolve(("127.0.0.1", 30000))

    assert run(faults) == run(ref_faults)


def test_handoff_and_advice_schedules_equal_reference():
    windows = [{"src": "a", "dst": "b", "kinds": ["commit"], "from_n": 2,
                "to_n": 3, "mode": "drop"},
               {"src": None, "dst": "c", "mode": "dup"}]

    def run(mod):
        h = mod.HandoffFaultSchedule(5, windows=windows, drop=0.2,
                                     duplicate=0.3)
        d = [h.decide(s, t, k, n) for s in "abc" for t in "bc"
             for k in ("commit", "ack") for n in range(1, 8)]
        adv = mod.DuplicateAdviceSchedule(9)
        rows = [adv.mangle(p, [{"proc": "p", "tenant": p, "seq": p}])
                for p in range(6)]
        return d, h.window_hits, rows, adv.injected

    assert run(faults) == run(ref_faults)


# ---------------------------------------------------------------------------
# a resident port replica over UDP under faults
# ---------------------------------------------------------------------------


def test_resident_port_replica_under_faults_equals_reference():
    """A resident port replica (``merge_mode="resident"`` on the CPU)
    and a reference replica join over UDP through a port rendezvous,
    then every router takes the reference's fleet-trace schedule
    (drops, duplicates, delays) and both edit: both end with equal
    caches, and the faults really fired."""
    sched = dict(drop=0.04, duplicate=0.02, delay=0.08, delay_polls=(1, 3))
    boot = UdpRouter(rendezvous=True)
    pr = UdpRouter(bootstrap=[boot.addr], dial_retry_s=0.1)
    rr = RefUdpRouter(bootstrap=[boot.addr], dial_retry_s=0.1)
    routers = [boot, pr, rr]
    try:
        p = Replica(pr, topic="doc", client_id=21, merge_mode="resident",
                    device="cpu", probe_retry_s=0.1, anti_entropy_s=0.2)
        r = RefReplica(rr, topic="doc", client_id=22, probe_retry_s=0.1,
                       anti_entropy_s=0.2)
        pump_until(routers, lambda: p.synced and r.synced
                   and pr.peers_on("doc") and rr.peers_on("doc"),
                   timeout_s=30.0)
        eps = [install_faults(boot, FaultSchedule(7, **sched)),
               install_faults(pr, FaultSchedule(7, **sched)),
               ref_faults.install_faults(
                   rr, ref_faults.FaultSchedule(7, **sched))]
        for step in range(3):
            _mixed_ops(p, 0, 10)
            _mixed_ops(r, 1, 10)
            for _ in range(20):
                for x in routers:
                    x.poll()
                time.sleep(0.002)

        def converged():
            sp, sr = p.doc.state_vector(), r.doc.state_vector()
            return dict(sp.clocks) == dict(sr.clocks) and \
                sp.get(21) >= 30 and sp.get(22) >= 30

        pump_until(routers, converged, timeout_s=30.0)
        assert dict(p.c) == dict(r.c)
        assert len(p.c["l"]) == 2 * 3 * 5
        stats = [e.stats for e in eps]
        assert sum(s["dropped"] + s["delayed"] + s["duplicated"]
                   for s in stats) > 0
    finally:
        _close(routers)


# ---------------------------------------------------------------------------
# a resident replica's full state beside an engine replica's
# ---------------------------------------------------------------------------


def _resident_and_engine(pkg):
    if pkg == "port":
        from crdt_tpu_torch.api.doc import Crdt
        from crdt_tpu_torch.net import (LoopbackNetwork, LoopbackRouter,
                                        ypear_crdt)
        from crdt_tpu_torch.obs import state_digest
        kw = {"device": "cpu"}
    else:
        from crdt_tpu.api.doc import Crdt
        from crdt_tpu.net import LoopbackNetwork, LoopbackRouter, ypear_crdt
        from crdt_tpu.obs import state_digest
        kw = {}
    net = LoopbackNetwork()
    a = ypear_crdt(LoopbackRouter(net, "A"), topic="d", client_id=31,
                   merge_mode="resident", **kw)
    b = ypear_crdt(LoopbackRouter(net, "B"), topic="d", client_id=32)
    net.run()
    for step in range(2):
        _mixed_ops(a, 0, 10)
        _mixed_ops(b, 1, 10)
        net.run()
    canon = Crdt(33)
    canon.apply_updates([a.encode_state_as_update()])
    return (dict(a.c), dict(b.c), a.encode_state_vector(),
            b.encode_state_vector(), a.encode_state_as_update(),
            b.encode_state_as_update(), state_digest(canon),
            state_digest(b.doc))


def test_resident_full_state_leaves_out_overwrite_tombstones():
    """After the same ops a resident replica and an engine replica hold
    the same ``c`` and state vector, but the resident full state leaves
    out the tombstones of overwritten map entries, so the two full
    states (and ``state_digest``\\ s) differ — in both packages alike,
    byte for byte. Fed through a fresh engine the resident state gives
    the engine replica's digest: the canonical comparison phase 12 of
    ``chip_smoke.py`` makes."""
    from crdt_tpu_torch.codec import v1

    port = _resident_and_engine("port")
    assert port == _resident_and_engine("reference")
    ca, cb, sva, svb, fa, fb, canon, db = port
    assert ca == cb and sva == svb
    assert fa != fb and canon == db
    (ra, dsa), (rb, dsb) = v1.decode_update(fa), v1.decode_update(fb)
    key = lambda r: (r.client, r.clock)  # noqa: E731
    assert sorted(ra, key=key) == sorted(rb, key=key)
    ranges_a, ranges_b = set(dsa.iter_all()), set(dsb.iter_all())
    assert ranges_a < ranges_b


@pytest.mark.parametrize("seed", [0, 5])
def test_fork_fault_equals_reference(seed):
    """``ForkFault`` forks two replicas with the reference's blobs (the
    same seeded content under one id), through the port's own codec:
    equal state vectors, unequal documents."""
    def run(pkg):
        if pkg == "port":
            from crdt_tpu_torch.net import (ForkFault, LoopbackNetwork,
                                            LoopbackRouter, ypear_crdt)
        else:
            from crdt_tpu.net import (ForkFault, LoopbackNetwork,
                                      LoopbackRouter, ypear_crdt)
        net = LoopbackNetwork()
        reps = [ypear_crdt(LoopbackRouter(net, f"r{i}"), topic="t",
                           client_id=40 + i) for i in range(2)]
        net.run()
        blobs = ForkFault(seed).inject(reps)
        return (blobs, [r.encode_state_vector() for r in reps],
                [dict(r.c) for r in reps])

    blobs, svs, caches = run("port")
    assert (blobs, svs, caches) == run("reference")
    assert svs[0] == svs[1] and caches[0] != caches[1]
