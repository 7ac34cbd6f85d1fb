"""Multi-process router: the ypear router contract over native UDP.

The port's copy of ``crdt_tpu.net.udp_router``. The wire protocol is
the reference's byte for byte, so port and reference routers form one
swarm and their replicas sync with each other.

The reference's router is Hyperswarm — DHT topic discovery plus
Noise-encrypted peer streams over udx (SURVEY.md §2.2). This router
implements the same contract surface the CRDT layer consumes
(``is_ypear_router``, ``options``, ``update_options[_cache]``,
``start``/``started``/``peers``, ``alow`` -> the four verbs,
crdt.js:172-317) over the native transport seam
(:mod:`crdt_tpu_torch.net.transport`): reliable-datagram UDP + X25519 /
XChaCha20-Poly1305 encrypted peer links.

Peer discovery is rendezvous-based, the datacenter reduction of
Hyperswarm's DHT (consumed at crdt.js:315): a router constructed with
``bootstrap=[(ip, port), ...]`` dials those known nodes, and any
router running with ``rendezvous=True`` INTRODUCES peers that
announce a shared topic to each other — each side receives the
other's (public key, address) over the established encrypted link and
dials it, after which the ordinary hello/key-exchange/announce/sync
machinery takes over. A swarm therefore forms from one well-known
address, no static peer lists (``add_peer`` remains for fabrics where
peers ARE known addresses). Full DHT walking stays out of scope —
the rendezvous node is the trust anchor the reference's bootstrap DHT
nodes are; a wrong introduction is only a dial to a peer that cannot
complete the key exchange.

NAT traversal (cone NATs) falls out of the introduction mechanics by
construction — the same simultaneous-open recipe Hyperswarm's
holepuncher runs, minus its relay fallback:

- the rendezvous advertises each member's OBSERVED UDP source
  address (``_Peer.addr`` is the packet source, i.e. the NAT's
  public mapping, held open by the member's TTL'd announce refresh);
- one introduction is sent to BOTH sides (:meth:`UdpRouter._introduce`
  tells the newcomer about every holder AND every holder about the
  newcomer), so both ends dial out at once — each outbound hello
  opens its own NAT's mapping toward the other;
- hellos ride the reliable transport (40 ms initial RTO, exponential
  backoff — native/transport/transport.cc), so whichever side's
  first packet loses the race against the other NAT's mapping
  creation is retransmitted straight through once it exists.

Full-cone and (address-)restricted-cone NATs traverse by the intro
mechanics alone. Symmetric NATs (per-destination port mappings) get
the two remaining Hyperswarm capabilities:

- **port prediction**: an introduced dial that does not complete is
  retried on a jittered exponential backoff, and after a few rounds
  the retry sprays unreliable hellos at the advertised port ±
  ``predict_window`` — sequential-allocation symmetric NATs put the
  mapping toward us within a few ports of the mapping the rendezvous
  observed, so a predicted probe (or the peer's probe toward our
  predicted port) lands and the ordinary handshake completes. Probes
  ride :meth:`UdpEndpoint.send_unreliable` (no retransmit state, no
  ``failed`` accounting — most probes are EXPECTED to die).
- **peer relay**: past ``relay_after_s`` the dialer falls back to
  forwarding end-to-end encrypted frames through a mutually reachable
  peer (the introducer first, then other proven peers — deterministic
  election order, rotated on NAK or death). Relays enforce per-source
  byte budgets (token bucket); a saturated or dead relay answers with
  a NAK / goes silent and the sender re-elects or sheds to the sync
  protocol's own retry/anti-entropy cadence. A direct path proven
  LATER (a predicted probe finally landing) upgrades the peer in
  place and the relay leg is dropped.

The mechanism properties are pinned by tests/test_transport.py
(TestIntroductionPunch, TestSymmetricNatTraversal, TestRelayFallback)
over the simulated-NAT loopback fabric in :mod:`crdt_tpu_torch.net.faults`.

Wire protocol (each transport message, after reassembly):
  kind 0x00  plaintext hello       {pk: hex, ack: bool}
  kind 0x01  encrypted envelope    sender_pk(32 raw) || SecureBox
             payload (AAD = sender pk), decrypting to one lib0 `any`:
             {t:'topics', topics:[...]} | {t:'m', topic, msg} |
             {t:'intro', peers:[{pk, ip, port}...]} (rendezvous)

Like the loopback fabric, nothing is delivered until ``poll()`` runs —
single-threaded, event-loop style (udx's own model).
"""

from __future__ import annotations

import logging
import socket
import time
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from crdt_tpu_torch.codec.lib0 import Decoder, Encoder
from crdt_tpu_torch.net.transport import SecureBox, UdpEndpoint, keypair
from crdt_tpu_torch.obs import propagation
from crdt_tpu_torch.obs.recorder import get_recorder
from crdt_tpu_torch.obs.tracer import get_tracer
from crdt_tpu_torch.utils.backoff import jitter

_HELLO = 0
_ENVELOPE = 1

_log = logging.getLogger(__name__)

# protocol-level ceiling for a peer's wire-declared announce TTL. The
# clamp must NOT derive from the receiver's local announce_ttl: a
# member legitimately configured with a longer refresh than the
# rendezvous node would be silently clamped below its own schedule and
# age out of introductions while still refreshing on time (advisor
# finding, round 3). One hour bounds how long a crashed peer can pin
# itself into introductions regardless of either side's local config.
_TTL_CAP = 3600.0


def _canon_addr(host: str, port: int) -> Tuple[str, int]:
    """Resolve a configured bootstrap entry to the canonical (ip, port)
    tuple that will appear as a UDP source address. Introducer trust
    compares observed sources against the bootstrap list; a hostname
    entry would never match its numeric source and trust would silently
    never be granted (advisor finding, round 3).

    Resolution is pinned to AF_INET because the native transport's
    sockets are IPv4-only (``native/transport/transport.cc`` binds
    ``AF_INET``) — an AAAA-only answer could never appear as a source
    address on that socket anyway. IPv6 bootstrap entries (literals or
    IPv6-only hostnames) are therefore unsupported; they fail loudly
    here instead of silently never matching (advisor finding, round 4).
    """
    try:
        infos = socket.getaddrinfo(
            host, port, socket.AF_INET, socket.SOCK_DGRAM
        )
        return (infos[0][4][0], int(port))
    except OSError:
        if ":" in host:
            _log.error(
                "bootstrap entry %s:%s looks like an IPv6 literal; the "
                "transport is IPv4-only — this entry can never grant "
                "introducer trust", host, port,
            )
        else:
            _log.warning(
                "bootstrap entry %s:%s did not resolve over IPv4 (the "
                "transport is IPv4-only); introducer trust will never "
                "match this entry until restart", host, port,
            )
        return (host, int(port))


def _pack_any(v: Any) -> bytes:
    enc = Encoder()
    enc.write_any(v)
    return enc.to_bytes()


def _unpack_any(data: bytes) -> Any:
    return Decoder(data).read_any()


class _Peer:
    __slots__ = ("pk_hex", "addr", "topics", "topics_v", "inst", "box",
                 "last_seen", "announce_ttl", "direct", "relay",
                 "relay_idx", "relay_paused_until", "introducer",
                 "predicted")

    def __init__(self, pk_hex: str, addr: Tuple[str, int], inst: str,
                 box: SecureBox, *, direct: bool = True):
        self.pk_hex = pk_hex
        self.addr = addr
        self.topics: Set[str] = set()
        self.topics_v = -1  # last applied announcement version
        self.inst = inst  # incarnation token: resets topics_v on restart
        self.box = box
        self.last_seen = time.monotonic()  # last AUTHENTICATED traffic
        self.announce_ttl = 0.0  # the peer's own wire-declared TTL
        # `direct`: addr is a real datagram source / a proven rebind —
        # usable for direct sends. False for peers seeded from an intro
        # hint or met through a relay: their addr is at best a guess,
        # and traffic routes via `relay` until a probe proves a path
        self.direct = direct
        self.relay: Optional[str] = None  # forwarding peer's pk
        self.relay_idx = 0  # election cursor (rotated on NAK/death)
        self.relay_paused_until = 0.0  # budget-shed cooldown
        self.introducer: Optional[str] = None  # who told us about them
        # the proven direct path landed on a PREDICTED port (not the
        # advertised one): topic frames toward this peer retag their
        # newest trace-context path record `predicted` (obs seam)
        self.predicted = False

    def new_incarnation(self, inst: str) -> None:
        """A restarted process announces from version 1 again; carrying
        the dead incarnation's version watermark would reject every
        announcement of the new one."""
        self.inst = inst
        self.topics_v = -1
        self.topics = set()
        # route attribution resets with the incarnation: the new
        # process proved whatever path it proved, not the old one's
        # predicted mapping
        self.predicted = False


class _Dial:
    """One in-progress introduction dial: retried on a jittered
    exponential backoff, escalating through port prediction to the
    relay fallback, until the peer proves a direct path or the dial
    expires (bounded — a gone-forever peer must not probe forever)."""

    __slots__ = ("pk_hex", "addr", "introducer", "created", "attempts",
                 "interval", "next_due", "give_up_at", "relay_on")

    def __init__(self, pk_hex: str, addr: Tuple[str, int],
                 introducer: Optional[str], *, base_s: float,
                 give_up_s: float):
        self.pk_hex = pk_hex
        self.addr = addr
        self.introducer = introducer
        now = time.monotonic()
        self.created = now
        self.attempts = 0
        self.interval = base_s
        self.next_due = now + base_s
        self.give_up_at = now + give_up_s
        self.relay_on = False


class UdpRouter:
    """One peer's router over a real socket (multi-process capable)."""

    is_ypear_router = True  # crdt.js:172's validation flag

    def __init__(
        self,
        *,
        bind_ip: str = "127.0.0.1",
        port: int = 0,
        seed: Optional[bytes] = None,
        username: Optional[str] = None,
        rendezvous: bool = False,
        bootstrap: Optional[List[Tuple[str, int]]] = None,
        announce_ttl: float = 60.0,
        dial_retry_s: float = 0.5,
        dial_retry_max_s: float = 8.0,
        dial_give_up_s: float = 60.0,
        port_prediction: bool = True,
        predict_after: int = 2,
        predict_window: int = 8,
        relay_after_s: float = 3.0,
        relay_stale_s: float = 30.0,
        relay_budget_bytes: int = 256 * 1024,
        relay_refill_bps: int = 64 * 1024,
        relay_shed_pause_s: float = 1.0,
    ):
        self.endpoint = UdpEndpoint(bind_ip, port)
        pub, sec = keypair(seed)
        self._secret = sec
        pk_hex = pub.hex()
        self.options: Dict[str, Any] = {
            "public_key": pk_hex,
            "username": username or pk_hex[:8],
            "cache": {},
        }
        self.started = False
        self._handlers: Dict[str, Callable] = {}
        self._peers: Dict[str, _Peer] = {}  # pk_hex -> peer
        # announcement version: bumped when OUR topic set changes, so a
        # delayed retransmit of an older announcement can never regress
        # a peer's view of our topics (transport is reliable but not
        # ordered across messages)
        self._topics_v = 0
        # per-process incarnation token, carried in hellos: lets peers
        # distinguish a restart (reset announcement watermark) from a
        # delayed retransmit of an old announcement
        import os as _os

        self._inst = _os.urandom(8).hex()
        # liveness challenges: pk_hex -> (nonce, challenged addr). A
        # hello claiming a known identity from a NEW address — or any
        # hint that the peer's incarnation changed — must prove key
        # possession NOW (decrypt the ping, echo the nonce FROM THAT
        # ADDRESS) before we reroute traffic or reset announcement
        # watermarks. The pong carries the responder's CURRENT inst,
        # and that fresh-nonce-bound value is the only way peer.inst
        # ever changes: trusting the plaintext hello's inst would let
        # a replayed old hello wedge topic membership permanently
        # (set peer.inst to a dead token that no genuine announcement
        # matches)
        self._rebind_nonce: Dict[str, Tuple[str, Tuple[str, int]]] = {}
        # rendezvous discovery (Hyperswarm reduction; module docstring).
        # Announcements carry the announcer's liveness TTL on the wire:
        # bootstrap-joined members refresh their announcement to their
        # RENDEZVOUS peers every ttl/3, and a rendezvous node only
        # introduces holders heard from within each holder's OWN
        # declared TTL — a crashed member ages out instead of being
        # handed to every future joiner as a dead address to dial
        # (reliable-transport retries against it would count as hard
        # failures), and asymmetric TTL configuration cannot silently
        # drop a live member. Introductions are honored only from
        # peers reached at a configured bootstrap address — the stated
        # trust anchor — never from arbitrary swarm members.
        self._rendezvous = rendezvous
        # bootstrap entries are (host, port) with IPv4-only resolution:
        # the native transport's sockets are AF_INET (_canon_addr).
        self._bootstrap = list(bootstrap or [])
        # canonical (ip, port) forms of the bootstrap entries — the set
        # observed UDP sources are compared against for introducer
        # trust. Resolved eagerly; start() re-resolves in case DNS
        # changed between construction and start.
        self._bootstrap_canon: Set[Tuple[str, int]] = {
            _canon_addr(h, p) for h, p in self._bootstrap
        }
        self._announce_ttl = announce_ttl
        self._last_announce = 0.0
        # NAT traversal / partition tolerance (module docstring):
        # dial retry schedule, port prediction, relay fallback
        self._dial_retry_s = dial_retry_s
        self._dial_retry_max_s = dial_retry_max_s
        self._dial_give_up_s = dial_give_up_s
        self._port_prediction = port_prediction
        self._predict_after = predict_after
        self._predict_window = predict_window
        self._relay_after_s = relay_after_s
        self._relay_stale_s = relay_stale_s
        self._relay_budget_bytes = relay_budget_bytes
        self._relay_refill_bps = relay_refill_bps
        self._relay_shed_pause_s = relay_shed_pause_s
        self._dials: Dict[str, _Dial] = {}  # pk_hex -> in-progress dial
        # token buckets for frames WE forward, keyed by source pk
        self._relay_budget: Dict[str, Tuple[float, float]] = {}
        self._last_ping: Dict[str, float] = {}  # keepalive rate limit
        # discovery diagnostics: a wedged swarm (intros never applied,
        # claimants never proving) must be visible, not silent
        self.stats: Dict[str, int] = {
            "intros_applied": 0,
            "intros_buffered": 0,
            "intros_dropped": 0,
            "intros_refused": 0,
            "dial_retries": 0,
            "dials_expired": 0,
            "predict_probes": 0,
            "relay_sends": 0,
            "relay_frames_forwarded": 0,
            "relay_bytes_forwarded": 0,
            "relay_naks": 0,
            "relay_sheds": 0,
            "relay_elections": 0,
            "relay_upgrades": 0,
            "relay_unroutable": 0,
        }
        # introducer trust is granted ONLY by proven key possession at
        # a configured bootstrap address (nonce challenge/pong, the
        # same machinery that guards address rebinds) — a plaintext
        # hello with a spoofed bootstrap source must not mint trust.
        # Intros arriving before the proof completes buffer here and
        # replay on grant (bounded: latest per claimant, few claimants)
        self._rendezvous_pks: Set[str] = set()
        self._pending_intros: Dict[str, Any] = {}

    # -- options bag (crdt.js:175-180) ----------------------------------
    def update_options(self, opts: Dict[str, Any]) -> None:
        self.options.update(opts)

    def update_options_cache(self, per_topic: Dict[str, dict]) -> None:
        for topic, contract in per_topic.items():
            self.options["cache"].setdefault(topic, {}).update(contract)

    # -- lifecycle -------------------------------------------------------
    def start(self, network_name: Optional[str] = None) -> None:
        self.options.setdefault("network_name", network_name)
        self.started = True
        # EVERY configured bootstrap is dialed (not rotated through):
        # a dead rendezvous node then costs only its own unanswered
        # hello, and any live one introduces — the failover the
        # reference gets from Hyperswarm's multi-node DHT bootstrap
        self._bootstrap_canon = {
            _canon_addr(h, p) for h, p in self._bootstrap
        }
        # dial the RESOLVED addresses: the native transport sends to
        # numeric IPs only (a hostname entry would raise at the
        # socket). Per-entry failures are logged and skipped — one
        # unresolved/dead entry must not abort dialing the rest, or
        # multi-bootstrap failover is lost
        for ip, port in sorted(self._bootstrap_canon):
            try:
                self.add_peer(ip, port)
            except OSError as exc:
                _log.warning(
                    "bootstrap %s:%s not dialable (%s); trying others",
                    ip, port, exc,
                )

    def close(self) -> None:
        self.endpoint.close()

    @property
    def public_key(self) -> str:
        return self.options["public_key"]

    @property
    def addr(self) -> Tuple[str, int]:
        return (self.endpoint.bind_ip, self.endpoint.port)

    # -- discovery (bootstrap list; the DHT-walk divergence) -------------
    def add_peer(self, ip: str, port: int) -> None:
        """Dial a known address: plaintext hello carrying our identity;
        the reply completes the key exchange."""
        self._send_hello(ip, port, ack=False)

    def _send_hello(self, ip: str, port: int, *, ack: bool,
                    unreliable: bool = False) -> None:
        payload = bytes([_HELLO]) + _pack_any(
            {"pk": self.public_key, "ack": ack, "inst": self._inst}
        )
        if unreliable:
            # dial retries and prediction probes: most are EXPECTED to
            # die at a closed NAT mapping — no retransmit state, no
            # `failed` accounting; the dial schedule is the retry layer
            send = getattr(self.endpoint, "send_unreliable", None)
            if send is not None:
                send(ip, port, payload)
                return
        self.endpoint.send(ip, port, payload)

    # -- peer/topic views ------------------------------------------------
    @property
    def peers(self) -> List[str]:
        return list(self._peers)

    def peers_on(self, topic: str) -> List[str]:
        return [pk for pk, p in self._peers.items() if topic in p.topics]

    # -- the four verbs (crdt.js:315-317) --------------------------------
    def alow(self, topic: str, handler: Callable) -> Tuple[
        Callable, Callable, Callable, Callable
    ]:
        self._handlers[topic] = handler
        self._topics_v += 1
        self._announce_topics()

        def send_msg(p: _Peer, msg: dict) -> None:
            # transport-route attribution (obs/propagation): a frame
            # whose newest path record says `direct` but which will
            # ride a relay or a prediction-proven mapping retags that
            # record BEFORE sealing — per peer, since the route is
            # per peer. Failures leave the context unchanged;
            # attribution never breaks delivery.
            tc = msg.get("tc")
            if isinstance(tc, (bytes, bytearray)):
                if not p.direct:
                    tc2 = propagation.retag_last_hop(
                        bytes(tc), "relayed"
                    )
                elif p.predicted:
                    tc2 = propagation.retag_last_hop(
                        bytes(tc), "predicted"
                    )
                else:
                    tc2 = tc
                if tc2 is not tc:
                    msg = dict(msg, tc=tc2)
            self._send_envelope(p, {"t": "m", "topic": topic, "msg": msg})

        def propagate(msg: dict) -> None:
            for p in list(self._peers.values()):
                if topic in p.topics:
                    send_msg(p, msg)

        broadcast = propagate  # the reference uses them interchangeably

        def for_peers(fn: Callable[[str], None]) -> None:
            for pk in self.peers_on(topic):
                fn(pk)

        def to_peer(public_key: str, msg: dict) -> None:
            p = self._peers.get(public_key)
            if p is not None and topic in p.topics:
                send_msg(p, msg)

        return propagate, broadcast, for_peers, to_peer

    def unsubscribe(self, topic: str) -> None:
        self._handlers.pop(topic, None)
        self._topics_v += 1
        self._announce_topics()

    # -- wire ------------------------------------------------------------
    def _send_envelope(
        self, peer: _Peer, payload: Any,
        addr: Optional[Tuple[str, int]] = None,
    ) -> None:
        me = bytes.fromhex(self.public_key)
        body = peer.box.encrypt(_pack_any(payload), aad=me)
        if addr is None and not peer.direct:
            # no proven direct path: forward the sealed frame through
            # the elected relay (addr=None in _rebind_nonce marks the
            # relay-routed challenges this peer may owe us)
            self._send_via_relay(peer, me + body)
            return
        ip, port = addr if addr is not None else peer.addr
        self.endpoint.send(ip, port, bytes([_ENVELOPE]) + me + body)

    # -- peer relay (module docstring: the Hyperswarm relay reduction) ---
    def _relay_candidates(self, peer: _Peer) -> List[str]:
        """Deterministic election order: the introducer (connected to
        both sides at introduction time by construction), then proven
        rendezvous peers, then every other direct peer."""
        order: List[str] = []
        seen: Set[str] = set()
        cands: List[str] = []
        if peer.introducer:
            cands.append(peer.introducer)
        cands += sorted(self._rendezvous_pks)
        cands += sorted(self._peers)
        for pk in cands:
            if pk in seen or pk == peer.pk_hex or pk == self.public_key:
                continue
            seen.add(pk)
            p = self._peers.get(pk)
            if p is not None and p.direct:
                order.append(pk)
        return order

    def _relay_for(self, peer: _Peer) -> Optional[_Peer]:
        """Resolve (electing / re-electing as needed) the relay to
        route `peer`'s traffic through. A silent candidate is pinged
        (rate-limited) and skipped while any fresh one exists — a dead
        relay therefore triggers re-election, never a wedge."""
        order = self._relay_candidates(peer)
        if not order:
            return None
        now = time.monotonic()
        fresh = []
        for pk in order:
            p = self._peers[pk]
            if now - p.last_seen <= self._relay_stale_s:
                fresh.append(pk)
            else:
                # nudge: an alive-but-quiet relay pongs, refreshes
                # last_seen, and rejoins the fresh pool
                last = self._last_ping.get(pk, 0.0)
                if now - last > max(self._relay_stale_s / 4, 0.05):
                    self._last_ping[pk] = now
                    self._challenge_liveness(p, p.addr)
        pool = fresh or order
        pk = pool[peer.relay_idx % len(pool)]
        if pk != peer.relay:
            peer.relay = pk
            self.stats["relay_elections"] += 1
            get_tracer().count("router.relay_elections")
        return self._peers[pk]

    def _send_via_relay(self, peer: _Peer, frame: bytes) -> None:
        now = time.monotonic()
        if peer.relay_paused_until > now:
            # relay shed our traffic (budget): drop — the sync layer's
            # retry/anti-entropy cadence recovers the payload later
            self.stats["relay_sheds"] += 1
            get_tracer().count("router.relay_sheds")
            return
        relay = self._relay_for(peer)
        if relay is None:
            self.stats["relay_unroutable"] += 1
            return
        self.stats["relay_sends"] += 1
        tracer = get_tracer()
        tracer.count("router.relay_sends")
        tracer.count("router.relay_send_bytes", len(frame))
        rec = get_recorder()
        if rec.enabled:
            rec.record(
                "relay.send", replica=self.public_key,
                peer=peer.pk_hex, via=relay.pk_hex, size=len(frame),
            )
        self._send_envelope(
            relay, {"t": "relay", "dst": peer.pk_hex, "f": frame}
        )

    def _relay_allow(self, src_pk: str, nbytes: int) -> bool:
        """Token bucket per forwarded-for source: a chatty pair cannot
        monopolize this node's forwarding capacity."""
        now = time.monotonic()
        tokens, last = self._relay_budget.get(
            src_pk, (float(self._relay_budget_bytes), now)
        )
        tokens = min(
            float(self._relay_budget_bytes),
            tokens + (now - last) * self._relay_refill_bps,
        )
        if nbytes > tokens:
            self._relay_budget[src_pk] = (tokens, now)
            return False
        self._relay_budget[src_pk] = (tokens - nbytes, now)
        return True

    def _announce_topics(
        self,
        peer: Optional[_Peer] = None,
        targets: Optional[List[_Peer]] = None,
    ) -> None:
        msg = {
            "t": "topics",
            "v": self._topics_v,
            # incarnation-bound: the static per-pair SecureBox key means
            # a captured announcement from a previous process life would
            # otherwise replay cleanly; a high replayed `v` would set the
            # watermark above the new incarnation's counter and wedge
            # topic membership until v caught up
            "inst": self._inst,
            # our liveness TTL, on the wire: a rendezvous node ages our
            # entry by THIS value, not its local config
            "ttl": self._announce_ttl,
            "topics": sorted(self._handlers),
        }
        if targets is None:
            targets = [peer] if peer is not None else list(self._peers.values())
        for p in targets:
            self._send_envelope(p, msg)
        if peer is None:
            self._last_announce = time.monotonic()

    def _register_peer(
        self, pk_hex: str, addr: Tuple[str, int], inst: str,
        *, direct: bool = True,
    ) -> Optional[_Peer]:
        """Create a peer entry for a previously unknown identity.
        Returns None for keys no secure channel can be built with."""
        try:
            box = SecureBox(self._secret, bytes.fromhex(pk_hex))
        except ValueError:
            return None  # low-order key
        p = _Peer(pk_hex, addr, inst, box, direct=direct)
        self._peers[pk_hex] = p
        return p

    def _challenge_liveness(
        self, peer: _Peer, addr: Optional[Tuple[str, int]]
    ) -> None:
        """A hello is unauthenticated: before rerouting a KNOWN peer's
        traffic to a new address, or believing its incarnation
        changed, ping that address under the peer's key — only the
        real key holder can echo the nonce back, and only from the
        challenged address (the pong's source is checked, so a copied
        pong from elsewhere proves nothing). The pong also reports the
        responder's live inst.

        ``addr=None`` challenges over the RELAY path instead: there is
        no address claim to verify, but the fresh nonce still proves
        the far end holds the key NOW (relayed frames are end-to-end
        sealed), which is what inst adoption needs."""
        import os as _os

        nonce = _os.urandom(16).hex()
        self._rebind_nonce[peer.pk_hex] = (nonce, addr)
        self._send_envelope(peer, {"t": "ping", "n": nonce}, addr=addr)

    def poll(self) -> int:
        """One pump: transport poll + dispatch every complete message.
        Returns the number of router-level messages handled."""
        # announcement refresh (TTL liveness; see __init__): members
        # that joined through a bootstrap keep their topic announcement
        # warm at the RENDEZVOUS peers (so introductions never hand
        # out aged entries) and — since round 19 — at RELAY-ROUTED
        # peers too: a relay-met peer is exactly one whose announce
        # had no reliable path (the one-shot announce rides the relay
        # chain, where an app-level loss is never retransmitted), so
        # a dropped announce must be a delay, not a permanently
        # invisible topic. Refreshing the whole swarm would be O(N^2)
        # steady-state traffic nobody consumes; these two classes are
        # the ones with no other repair path.
        if (
            self._handlers
            and time.monotonic() - self._last_announce
            > self._announce_ttl / 3
        ):
            refresh_targets = [
                p for pk, p in self._peers.items()
                if pk in self._rendezvous_pks or not p.direct
            ]
            if refresh_targets:
                # peer=None path: _announce_topics stamps
                # _last_announce
                self._announce_topics(targets=refresh_targets)
            else:
                # nothing to repair until membership changes (joins
                # announce directly): stamp anyway, or every later
                # poll pays the peer scan with an expired deadline
                self._last_announce = time.monotonic()
        self._service_dials()
        self.endpoint.poll()
        handled = 0
        for src_ip, src_port, data in self.endpoint.recv_all():
            if not data:
                continue
            kind, body = data[0], data[1:]
            if kind == _HELLO:
                self._on_hello(body, (src_ip, src_port))
                handled += 1
            elif kind == _ENVELOPE and len(body) > 32:
                if self._on_envelope(body, (src_ip, src_port)):
                    handled += 1
        # end of poll round: replicas buffering inbound updates
        # (batch_incoming) merge this round's worth in one txn, then
        # get a timer tick (probe retry/backoff, periodic anti-entropy)
        for contract in list(self.options["cache"].values()):
            flush = contract.get("flush")
            if flush is not None:
                flush()
        for contract in list(self.options["cache"].values()):
            tick = contract.get("tick")
            if tick is not None:
                tick()
        return handled

    def _service_dials(self) -> None:
        """Drive every in-progress introduction dial: retry hellos on
        a jittered exponential backoff, escalate to port-prediction
        probes, fall back to a relay, expire bounded."""
        if not self._dials:
            return
        now = time.monotonic()
        tracer = get_tracer()
        for pk, d in list(self._dials.items()):
            peer = self._peers.get(pk)
            if peer is not None and peer.direct:
                del self._dials[pk]  # proven direct path: dial done
                continue
            if now >= d.give_up_at:
                # bounded: stop probing a peer that never answered.
                # An established relay route (peer entry) stays.
                del self._dials[pk]
                self.stats["dials_expired"] += 1
                continue
            if now >= d.next_due:
                d.attempts += 1
                self.stats["dial_retries"] += 1
                tracer.count("router.dial_retries")
                rec = get_recorder()
                if rec.enabled:
                    rec.record(
                        "dial.retry", replica=self.public_key, peer=pk,
                        attempt=d.attempts,
                    )
                ip, port = d.addr
                self._send_hello(ip, port, ack=False, unreliable=True)
                if self._port_prediction and d.attempts >= self._predict_after:
                    # sequential-allocation NATs put the real mapping
                    # near the observed one: spray the neighborhood
                    sent = 0
                    for delta in range(1, self._predict_window + 1):
                        for p in (port + delta, port - delta):
                            if 0 < p < 65536:
                                self._send_hello(
                                    ip, p, ack=False, unreliable=True
                                )
                                sent += 1
                    self.stats["predict_probes"] += sent
                    tracer.count("router.predict_probes", sent)
                d.interval = min(d.interval * 2, self._dial_retry_max_s)
                d.next_due = now + d.interval * jitter()
            if not d.relay_on and now - d.created >= self._relay_after_s:
                if self._activate_relay(d):
                    d.relay_on = True

    def _activate_relay(self, d: _Dial) -> bool:
        """Relay fallback for a dial that direct probing has not
        completed: register the peer (we hold its pk from the intro)
        routed via an elected relay and open the handshake by
        announcing our topics through it."""
        peer = self._peers.get(d.pk_hex)
        if peer is None:
            peer = self._register_peer(d.pk_hex, d.addr, "", direct=False)
            if peer is None:
                return True  # unusable key: stop trying
        if peer.introducer is None:
            peer.introducer = d.introducer
        if self._relay_for(peer) is None:
            return False  # no candidate yet; retry next pass
        get_tracer().count("router.relay_activations")
        self._announce_topics(peer)
        return True

    def _on_hello(self, body: bytes, addr: Tuple[str, int]) -> None:
        try:
            info = _unpack_any(body)
            # normalize case so the envelope lookup (raw.hex(), always
            # lowercase) can never miss a peer registered from a hello
            pk_hex = info["pk"].lower()
            if len(bytes.fromhex(pk_hex)) != 32:
                return  # an X25519 public key is exactly 32 bytes
        except (ValueError, KeyError, TypeError, AttributeError):
            return
        if pk_hex == self.public_key:
            return
        inst = info.get("inst", "")
        peer = self._peers.get(pk_hex)
        if peer is None:
            peer = self._register_peer(pk_hex, addr, inst)
            if peer is None:
                return  # rejected key
        # every continuing path answers a non-ack hello: a restarted
        # peer must be able to learn us, or the encrypted challenges
        # below could never be decrypted
        if not info.get("ack"):
            self._send_hello(addr[0], addr[1], ack=True)
        if peer.addr != addr or not peer.direct:
            # identity known but source moved — or known only through
            # a relay / an intro hint (no proven direct path at all):
            # don't reroute (or upgrade) until this address proves key
            # possession
            self._challenge_liveness(peer, addr)
            return
        if inst != peer.inst:
            # same address, different claimed incarnation: do NOT
            # adopt it from an unauthenticated hello (a replayed old
            # hello would set a dead inst that no genuine announcement
            # matches, wedging topic membership). Challenge instead;
            # the pong reports the live inst
            self._challenge_liveness(peer, peer.addr)
            return
        # introducer trust needs PROOF, not a claimed hello source: a
        # peer presenting from a bootstrap address is challenged there;
        # only the pong (fresh nonce, decrypted under its key, FROM
        # that address) grants it (see the pong branch)
        if (
            addr in self._bootstrap_canon
            and pk_hex not in self._rendezvous_pks
        ):
            self._challenge_liveness(peer, addr)
        # key exchange is done on both ends; tell THIS peer our topics
        # (announcing to everyone here would be O(N^2) per join wave)
        self._announce_topics(peer)

    def _on_envelope(self, body: bytes, addr: Tuple[str, int]) -> bool:
        sender_raw, sealed = body[:32], body[32:]
        pk_hex = sender_raw.hex()
        peer = self._peers.get(pk_hex)
        if peer is None:
            # envelope from an unknown peer (e.g. we restarted): redo
            # the handshake; the CRDT layer's anti-entropy recovers
            # whatever this message carried
            self._send_hello(addr[0], addr[1], ack=False)
            return False
        try:
            payload = _unpack_any(peer.box.decrypt(sealed, aad=sender_raw))
        except ValueError:
            get_tracer().count("router.envelopes_rejected")
            rec = get_recorder()
            if rec.enabled:
                rec.record(
                    "envelope.reject", replica=self.public_key,
                    peer=pk_hex, size=len(sealed),
                )
            return False  # forged or corrupted
        peer.last_seen = time.monotonic()
        return self._dispatch(peer, payload, addr, via=None)

    def _on_relayed_frame(self, frame: bytes, via: str,
                          relay_hop: Optional[tuple] = None) -> bool:
        """A frame forwarded to us by a relay: `frame` is the same
        sealed wire body a direct envelope carries (sender pk || box).
        The relay authenticated nothing about the CONTENT — end-to-end
        AEAD under the sender's static key does. An unknown sender
        reached this way is registered route-via-relay (its address is
        unknown by definition) and greeted with our topic set, which
        is the relayed half of the hello handshake. ``relay_hop`` is
        the relay's (id, monotonic ts) leg attestation from the
        wrapper, merged into topic messages' trace contexts."""
        sender_raw, sealed = frame[:32], frame[32:]
        pk_hex = sender_raw.hex()
        if pk_hex == self.public_key:
            return False
        peer = self._peers.get(pk_hex)
        announce_back = False
        if peer is None:
            peer = self._register_peer(
                pk_hex, ("0.0.0.0", 0), "", direct=False
            )
            if peer is None:
                return False
            peer.relay = via
            peer.introducer = via
            announce_back = True
        try:
            payload = _unpack_any(peer.box.decrypt(sealed, aad=sender_raw))
        except ValueError:
            return False
        peer.last_seen = time.monotonic()
        if announce_back:
            self._announce_topics(peer)
        return self._dispatch(peer, payload, None, via=via,
                              relay_hop=relay_hop)

    @staticmethod
    def _merge_relay_hop(msg: dict, relay_hop: tuple) -> dict:
        """The receiver-side half of the forward-seam hop
        incrementer: fold the relay's attested leg into the message's
        trace fields — the legacy ``hop`` count increments, and the
        trace context (the relay cannot edit it; the frame is sealed
        end-to-end) gains the relay's path record, delta-stamped from
        the relay's forward time. Every failure shape — no trace
        fields, malformed context, hostile attestation types, hop
        bound reached — leaves the message unchanged."""
        import math

        hid, hts = relay_hop
        # finite-only: NaN fails the self-compare, and +/-inf would
        # overflow the microsecond conversion downstream — either
        # way a hostile attestation must degrade to "unattributed",
        # never raise out of the poll loop
        if not isinstance(hid, str) or not isinstance(
            hts, (int, float)
        ) or isinstance(hts, bool) or not math.isfinite(hts):
            return msg
        out = dict(msg)
        if isinstance(out.get("hop"), int):
            out["hop"] = out["hop"] + 1
        tc = out.get("tc")
        if isinstance(tc, (bytes, bytearray)):
            out["tc"] = propagation.append_hop_wire(
                bytes(tc), hid, "relayed", hop_ts=float(hts)
            )
        return out

    def _dispatch(
        self, peer: _Peer, payload: Any,
        addr: Optional[Tuple[str, int]], via: Optional[str],
        relay_hop: Optional[tuple] = None,
    ) -> bool:
        pk_hex = peer.pk_hex
        t = payload.get("t") if isinstance(payload, dict) else None
        if t == "topics":
            if payload.get("inst") != peer.inst:
                if peer.inst == "" and via is not None and isinstance(
                    payload.get("inst"), str
                ):
                    # relay-met peer announcing for the first time: no
                    # recorded incarnation to protect yet — adopt. (A
                    # replayed DEAD-incarnation first announce heals
                    # through the relay-routed nonce challenge the
                    # genuine announce then triggers below.)
                    peer.inst = payload["inst"]
                else:
                    # replayed from a dead incarnation — or our
                    # recorded inst is the stale one (bootstrap raced
                    # a restart, or a spoofed hello poisoned it).
                    # Never adopt an inst from a replayable envelope;
                    # challenge instead: the fresh-nonce pong reports
                    # the live inst, after which the peer's
                    # re-announce applies. Self-healing either way,
                    # wedge-proof both ways. Challenged at the
                    # envelope's source (peer.addr may be a dead pre-
                    # restart socket; the pong's source-binding keeps
                    # a spoofed source harmless) — or, for a
                    # relay-met peer (addr=None), over the relay: no
                    # address claim to verify, but the nonce still
                    # proves key possession NOW.
                    self._challenge_liveness(peer, addr)
                    return True
            v = payload.get("v", 0)
            if v < peer.topics_v:
                return True  # stale retransmit must not regress the set
            peer.topics_v = v
            try:
                ttl = float(payload.get("ttl", 0.0))
            except (TypeError, ValueError):
                ttl = 0.0
            # clamp the declared TTL: an unbounded (or inf) value would
            # pin a crashed peer in introductions forever, and a
            # negative/NaN one would silently exclude a live member
            # (NaN fails every comparison, so it clamps to 0 -> the
            # local default applies). The cap is the PROTOCOL constant
            # _TTL_CAP, not a multiple of the receiver's local refresh
            # default — asymmetric configs stay live (advisor, round 3)
            peer.announce_ttl = ttl if 0.0 < ttl <= _TTL_CAP else (
                _TTL_CAP if ttl > _TTL_CAP else 0.0
            )
            before = set(peer.topics)
            peer.topics = set(payload.get("topics", ()))
            new_topics = peer.topics - before
            for topic in new_topics:
                if topic in self._handlers:
                    self._on_peer_joined_topic(topic, pk_hex)
            if self._rendezvous and new_topics:
                self._introduce(peer, new_topics)
        elif t == "m":
            handler = self._handlers.get(payload.get("topic"))
            if handler is not None:
                msg = payload.get("msg")
                if relay_hop is not None and isinstance(msg, dict):
                    msg = self._merge_relay_hop(msg, relay_hop)
                handler(msg, pk_hex)
        elif t == "intro":
            # rendezvous introduction — honored ONLY from peers whose
            # key possession was nonce-proven at a configured bootstrap
            # address (the trust anchor): an ordinary swarm member —
            # or an attacker spoofing a bootstrap source on a
            # plaintext hello — must not be able to direct us to
            # spray dials at arbitrary third-party addresses. An intro
            # racing its sender's proof buffers (latest per claimant,
            # claimants bounded by the bootstrap list) and replays on
            # grant.
            if pk_hex not in self._rendezvous_pks:
                if peer.addr in self._bootstrap_canon:
                    if len(self._pending_intros) < 8:
                        if pk_hex not in self._pending_intros:
                            self.stats["intros_buffered"] += 1
                        self._pending_intros[pk_hex] = payload
                    else:
                        self.stats["intros_dropped"] += 1
                        _log.warning(
                            "intro from unproven claimant %s dropped: "
                            "pending-intro buffer full (%d claimants "
                            "awaiting liveness proof)",
                            pk_hex[:8], len(self._pending_intros),
                        )
                else:
                    self.stats["intros_refused"] += 1
                    _log.debug(
                        "intro from %s at %s refused: not a configured "
                        "bootstrap address %s",
                        pk_hex[:8], peer.addr,
                        sorted(self._bootstrap_canon),
                    )
                return True
            self.stats["intros_applied"] += 1
            self._apply_intro(payload, introducer=pk_hex)
        elif t == "relay" and via is None:
            # forward a sealed frame between two peers that cannot
            # reach each other. Accepted on DIRECT links only (no
            # multi-hop chains, no forwarding loops), forwarded only
            # to DIRECT peers, and metered per source (token bucket) —
            # a saturated pair is NAK'd and sheds to its own
            # anti-entropy cadence rather than starving the relay.
            dst_pk = payload.get("dst")
            frame = payload.get("f")
            if not isinstance(dst_pk, str) or not isinstance(
                frame, (bytes, bytearray)
            ) or len(frame) <= 32:
                return True
            dstp = self._peers.get(dst_pk)
            if dstp is None or not dstp.direct:
                self.stats["relay_naks"] += 1
                self._send_envelope(
                    peer, {"t": "relay_nak", "dst": dst_pk, "why": "unknown"}
                )
            elif not self._relay_allow(pk_hex, len(frame)):
                self.stats["relay_sheds"] += 1
                get_tracer().count("router.relay_sheds")
                self._send_envelope(
                    peer, {"t": "relay_nak", "dst": dst_pk, "why": "budget"}
                )
            else:
                self.stats["relay_frames_forwarded"] += 1
                self.stats["relay_bytes_forwarded"] += len(frame)
                tracer = get_tracer()
                tracer.count("router.relay_frames_forwarded")
                tracer.count("router.relay_bytes_forwarded", len(frame))
                rec = get_recorder()
                if rec.enabled:
                    rec.record(
                        "relay.forward", replica=self.public_key,
                        peer=dst_pk, src=pk_hex, size=len(frame),
                    )
                # the forward-seam half of the hop incrementer: the
                # inner frame is sealed end-to-end (this relay cannot
                # edit it), so the relay ATTESTS its leg in the
                # wrapper — its identity + monotonic forward stamp —
                # and the receiving router merges that into the
                # decoded trace context (see _merge_relay_hop)
                self._send_envelope(
                    dstp,
                    {"t": "relayed", "src": pk_hex, "f": bytes(frame),
                     "hid": self.public_key[:8],
                     "hts": time.monotonic()},
                )
        elif t == "relayed" and via is None:
            frame = payload.get("f")
            if isinstance(frame, (bytes, bytearray)) and len(frame) > 32:
                self._on_relayed_frame(
                    bytes(frame), via=pk_hex,
                    relay_hop=(payload.get("hid"), payload.get("hts")),
                )
        elif t == "relay_nak":
            dst_pk = payload.get("dst")
            dstp = self._peers.get(dst_pk) if isinstance(dst_pk, str) else None
            if dstp is not None and dstp.relay == pk_hex:
                if payload.get("why") == "budget":
                    # saturation: pause relayed traffic toward this
                    # peer; the sync layer's retry/anti-entropy picks
                    # the payload back up after the pause
                    dstp.relay_paused_until = (
                        time.monotonic() + self._relay_shed_pause_s
                    )
                else:
                    # this relay cannot see the peer: rotate the
                    # election cursor; the next send re-elects
                    dstp.relay_idx += 1
                    dstp.relay = None
        elif t == "ping":
            # liveness challenge: echo the nonce (proving this address
            # — or, relay-routed, this KEY — holds the secret NOW; the
            # nonce is fresh) and report our current incarnation, the
            # only trusted source for it
            self._send_envelope(
                peer,
                {"t": "pong", "n": payload.get("n"), "inst": self._inst},
                addr=addr,
            )
        elif t == "pong":
            pending = self._rebind_nonce.get(pk_hex)
            if pending is None or payload.get("n") != pending[0]:
                return True
            if pending[1] is None:
                # relay-routed challenge: no address was claimed, so
                # none is proven — adopt only the (fresh-nonce-bound)
                # incarnation; routing is untouched
                del self._rebind_nonce[pk_hex]
                live_inst = payload.get("inst", peer.inst)
                if live_inst != peer.inst:
                    peer.new_incarnation(live_inst)
                self._announce_topics(peer)
                return True
            if addr != pending[1]:  # nonce is bound to the challenged
                # address: a pong copied and re-sent from elsewhere
                # must not redirect traffic there
                return True
            del self._rebind_nonce[pk_hex]
            peer.addr = addr  # proven: reroute to the new address
            if not peer.direct or peer.relay is not None:
                # a direct path just beat the relay route (a predicted
                # probe landed, or the peer dialed us): upgrade in
                # place and drop the relay leg
                if peer.relay is not None:
                    self.stats["relay_upgrades"] += 1
                    get_tracer().count("router.relay_upgrades")
                peer.relay = None
            peer.direct = True
            d = self._dials.pop(pk_hex, None)
            # route attribution: the proven address is NOT the
            # advertised one and the prediction spray actually ran —
            # this mapping was found by port prediction, so topic
            # frames toward it carry the `predicted` route tag. A
            # proof AT the advertised address (re-dial, restart)
            # clears it: the tag describes the current path.
            peer.predicted = (
                self._port_prediction
                and d is not None
                and d.attempts >= self._predict_after
                and addr != d.addr
            )
            if addr in self._bootstrap_canon:
                # key possession proven AT a bootstrap address:
                # grant introducer trust and replay any intro that
                # arrived while the proof was in flight
                self._rendezvous_pks.add(pk_hex)
                held = self._pending_intros.pop(pk_hex, None)
                if held is not None:
                    self.stats["intros_applied"] += 1
                    self._apply_intro(held, introducer=pk_hex)
            live_inst = payload.get("inst", peer.inst)
            if live_inst != peer.inst:
                # fresh-nonce-proven incarnation change: reset the
                # announcement watermark and prompt the new
                # incarnation to (re)announce its topics to us;
                # ours go out right below
                peer.new_incarnation(live_inst)
                self._send_hello(addr[0], addr[1], ack=True)
            self._announce_topics(peer)
        return True

    def _apply_intro(self, payload: Any,
                     introducer: Optional[str] = None) -> None:
        """Dial every listed peer we do not already know. The address
        is only a hint — the hello/key-exchange (and, for known
        identities, the liveness challenge) authenticates; a malformed
        or bogus entry must never escape this loop (it would kill the
        router's event loop), so every per-entry failure — wrong-typed
        fields included — just skips the entry. Each dial is tracked
        in ``_dials`` so an unanswered hello escalates through retry /
        prediction / relay instead of being fired once and forgotten
        (the cone-NAT-only gap this closes)."""
        peers_list = payload.get("peers", ())
        if not isinstance(peers_list, (list, tuple)):
            return
        now = time.monotonic()
        for entry in peers_list:
            try:
                pk = entry["pk"].lower()
                ip, port = entry["ip"], int(entry["port"])
                if not isinstance(ip, str):
                    continue
                if pk == self.public_key:
                    continue
                peer = self._peers.get(pk)
                if peer is not None and peer.direct:
                    continue  # already have a proven path
                # unknown peer OR one we only reach via relay (or whose
                # earlier dial expired): a fresh introduction carries a
                # fresh observed address — (re)open the dial so the
                # retry/prediction escalation gets its shot at
                # upgrading the pair to a direct path
                if len(bytes.fromhex(pk)) != 32:
                    continue
                d = self._dials.get(pk)
                if d is None:
                    self._dials[pk] = _Dial(
                        pk, (ip, port), introducer,
                        base_s=self._dial_retry_s,
                        give_up_s=self._dial_give_up_s,
                    )
                else:
                    # refresh the hint and extend the window: the
                    # introducer just vouched the peer is alive
                    d.addr = (ip, port)
                    d.give_up_at = now + self._dial_give_up_s
                if peer is None:
                    self.add_peer(ip, port)
            except (KeyError, TypeError, ValueError,
                    AttributeError, OSError):
                continue

    def _introduce(self, newcomer: _Peer, new_topics: Set[str]) -> None:
        """Rendezvous: tell the newcomer about every other LIVE holder
        of its newly announced topics, and each holder about it — one
        intro envelope per side, holders unioned across topics. Fires
        only on NEWLY announced topics, so refresh re-announcements
        cost nothing; symmetric convergence comes from every
        announcement introducing against the then-current holder set.
        Holders silent past their own wire-declared announce TTL are
        aged out (they are expected to refresh; see __init__)."""
        if not newcomer.direct:
            return  # a relay-met peer has no dialable address to share
        now = time.monotonic()
        holders = {
            pk: p for pk, p in self._peers.items()
            if pk != newcomer.pk_hex
            and p.direct  # never hand out unproven hint addresses
            and now - p.last_seen <= (p.announce_ttl or self._announce_ttl)
            and p.topics & new_topics
        }
        if not holders:
            return
        self._send_envelope(newcomer, {
            "t": "intro",
            "peers": [
                {"pk": p.pk_hex, "ip": p.addr[0], "port": p.addr[1]}
                for p in holders.values()
            ],
        })
        about_new = {
            "t": "intro",
            "peers": [{
                "pk": newcomer.pk_hex,
                "ip": newcomer.addr[0],
                "port": newcomer.addr[1],
            }],
        }
        for p in holders.values():
            self._send_envelope(p, about_new)

    # -- topology hook driving the injected sync contract ----------------
    def _on_peer_joined_topic(self, topic: str, pk_hex: str) -> None:
        contract = self.options["cache"].get(topic)
        if not contract:
            return
        probe = contract.get("peer_joined")
        if probe is not None:
            probe(pk_hex)  # anti-entropy probe regardless of synced
        elif not contract.get("synced") and "sync" in contract:
            contract["sync"]()


def pump(routers: List[UdpRouter], *, quiet_rounds: int = 5,
         timeout_s: float = 10.0, sleep_s: float = 0.002) -> None:
    """Poll a set of in-process routers until the fabric is quiet:
    no router handles a message and no endpoint has unacked sends for
    `quiet_rounds` consecutive sweeps. Raises on timeout (undelivered
    traffic after transport-level retries = a real failure)."""
    deadline = time.monotonic() + timeout_s
    quiet = 0
    failed0 = sum(r.endpoint.failed for r in routers)
    while quiet < quiet_rounds:
        if time.monotonic() > deadline:
            pend = [(r.public_key[:8], r.endpoint.pending) for r in routers]
            raise TimeoutError(f"fabric not quiet: pending={pend}")
        handled = sum(r.poll() for r in routers)
        pending = sum(r.endpoint.pending for r in routers)
        failed = sum(r.endpoint.failed for r in routers)
        if failed > failed0:
            # a message burned every retransmit: the fabric would look
            # quiet, but traffic was lost — that is a failure, not quiet
            raise RuntimeError(f"{failed - failed0} message(s) dropped "
                               "after exhausting transport retries")
        if handled == 0 and pending == 0:
            quiet += 1
        else:
            quiet = 0
        time.sleep(sleep_s)
