"""Deterministic fault-injection fabric + simulated-NAT loopback net.

The port's copy of ``crdt_tpu.net.faults``: the same seeded decisions
for the same ``(seed, src, dst, n)``, so a schedule replays identically
in either package.

The sync protocol's loss-recovery story (retry/backoff on ready
probes, periodic anti-entropy, relay fallback, re-election) was until
now exercised only by ad-hoc per-test plumbing — a loss knob here, a
cleared peer table there. This module makes the adversary a reusable,
SEEDED object so every recovery behavior is pinned by a replayable
schedule instead of one-off setup:

- :class:`FaultSchedule` — per-message fault decisions (drop,
  duplicate, delay/reorder, corrupt, partition) derived from
  ``crc32((seed, src, dst, flow_seq))``: deterministic per flow
  sequence regardless of cross-flow interleaving, so the same seed
  replays the same per-flow fault pattern on every run.
- :class:`FaultyEndpoint` — wraps a transport endpoint (the router
  seam: whole router messages, ABOVE the native reliable layer, so a
  "drop" models an app-level loss the native retransmit cannot see
  and only the protocol's own retries recover).
- :class:`Partition` — blocks cross-group traffic until healed
  (explicitly, or automatically after a fixed number of blocked
  messages — a count, not a timer, so schedules replay).
- :class:`NatFabric` / :class:`SymmetricNat` / :class:`ConeNat` /
  :class:`NattedEndpoint` — a userspace NAT simulation over loopback.
  A real NAT cannot be interposed on 127.0.0.1 sockets, so the fabric
  virtualizes ADDRESSES instead: every participant's endpoint is
  wrapped; sends carry a small virtual (src, dst) header; a natted
  wrapper allocates per-destination external ports (sequential — the
  allocation policy port prediction exploits), registers them with
  the shared fabric, and FILTERS inbound messages exactly the way the
  modeled NAT would (symmetric: accepted only on a mapping opened to
  precisely that remote (ip, port)). Datagrams still ride the real
  native transport between real sockets; what the routers above
  observe — source addresses, reachability, filtering — is the NAT's
  view. Sends to virtual addresses nobody has allocated are dropped
  at the sender (the real network drops them at the NAT), and the
  sender-side mapping is still opened first, exactly like a real
  symmetric NAT processing an outbound packet that dies remotely.

Everything is poll-driven and thread-free, like the endpoints it
wraps. See tests/test_faults.py and tests/test_transport.py
(TestSymmetricNatTraversal) for the schedules these pin.
"""

from __future__ import annotations

import socket as _socket
import time
import zlib
from typing import Dict, List, Optional, Set, Tuple

from crdt_tpu_torch.obs.recorder import get_recorder, update_digest

Addr = Tuple[str, int]


# ---------------------------------------------------------------------------
# seeded fault schedule
# ---------------------------------------------------------------------------


def _hash01(*key) -> float:
    """Stable [0, 1) hash of a tuple of primitives — process-salt-free
    (unlike ``hash``), so schedules replay across runs."""
    return zlib.crc32(repr(key).encode()) / 2**32


class Partition:
    """Blocks messages between two address groups (sets of ports).

    Heals either explicitly (:meth:`heal`) or automatically after
    ``max_blocked`` total messages were suppressed — a message COUNT,
    not a wall-clock timer, so a schedule replays identically however
    fast the fabric is pumped.
    """

    def __init__(self, group_a, group_b, *, max_blocked: Optional[int] = None):
        self.group_a: Set[int] = set(group_a)
        self.group_b: Set[int] = set(group_b)
        self.max_blocked = max_blocked
        self.blocked = 0
        self.healed = False

    def heal(self) -> None:
        self.healed = True

    def blocks(self, src_port: int, dst_port: int) -> bool:
        if self.healed:
            return False
        cross = (
            (src_port in self.group_a and dst_port in self.group_b)
            or (src_port in self.group_b and dst_port in self.group_a)
        )
        if not cross:
            return False
        self.blocked += 1
        if self.max_blocked is not None and self.blocked >= self.max_blocked:
            self.healed = True
        return True


class FaultSchedule:
    """Seeded per-message fault plan, shared by every wrapper in one
    test fabric (each applies it to its own OUTBOUND messages, so
    installing it on all routers covers every direction once)."""

    def __init__(
        self,
        seed: int = 0,
        *,
        drop: float = 0.0,
        duplicate: float = 0.0,
        delay: float = 0.0,
        delay_polls: Tuple[int, int] = (1, 4),
        corrupt: float = 0.0,
        partition: Optional[Partition] = None,
    ):
        self.seed = seed
        self.drop = drop
        self.duplicate = duplicate
        self.delay = delay
        self.delay_polls = delay_polls
        self.corrupt = corrupt
        self.partition = partition

    def decide(self, src: int, dst: int, n: int) -> dict:
        """Fault decision for the n-th message of flow (src, dst)."""
        d = {"drop": False, "dup": False, "delay": 0, "corrupt": False}
        if self.partition is not None and self.partition.blocks(src, dst):
            d["drop"] = True
            d["partitioned"] = True
            return d
        if self.drop and _hash01(self.seed, "drop", src, dst, n) < self.drop:
            d["drop"] = True
            return d
        if self.corrupt and _hash01(self.seed, "corr", src, dst, n) < self.corrupt:
            d["corrupt"] = True
        if self.duplicate and _hash01(self.seed, "dup", src, dst, n) < self.duplicate:
            d["dup"] = True
        if self.delay and _hash01(self.seed, "delay", src, dst, n) < self.delay:
            lo, hi = self.delay_polls
            d["delay"] = lo + int(_hash01(self.seed, "dn", src, dst, n) * (hi - lo + 1))
        return d


class FaultyEndpoint:
    """Endpoint wrapper applying a :class:`FaultSchedule` to outbound
    messages at the ROUTER seam (whole messages, above the native
    reliable layer — faults here model losses the transport's own
    retransmit cannot repair; only protocol retries recover them).

    Delayed messages are held and released by :meth:`poll` — delay
    doubles as reorder, since later messages overtake held ones. Held
    messages count as ``pending`` so quiescence detection does not
    declare a fabric quiet while traffic is still scheduled.
    """

    def __init__(self, inner, schedule: FaultSchedule):
        self._inner = inner
        self.schedule = schedule
        self._polls = 0
        self._flow_seq: Dict[Tuple[int, int], int] = {}
        # [(release_at_poll, ip, port, data, unreliable)]
        self._held: List[tuple] = []
        self.stats: Dict[str, int] = {
            "sent": 0, "dropped": 0, "duplicated": 0, "delayed": 0,
            "corrupted": 0, "partitioned": 0,
        }

    # -- fault application -------------------------------------------------
    def _fault_send(self, ip: str, port: int, data: bytes,
                    unreliable: bool) -> int:
        flow = (self.port, port)
        n = self._flow_seq.get(flow, 0)
        self._flow_seq[flow] = n + 1
        d = self.schedule.decide(flow[0], flow[1], n)
        rec = get_recorder()
        if rec.enabled:
            # one event PER fault kind APPLIED: corrupt co-occurs with
            # delay or dup on one message (drop/partition are
            # exclusive early-outs; a held message is sent once on
            # release, so its dup decision is never applied), and the
            # recorder must agree with the stats counters
            kinds = []
            if d["drop"]:
                kinds = ["partition" if d.get("partitioned") else "drop"]
            else:
                if d["corrupt"]:
                    kinds.append("corrupt")
                if d["delay"]:
                    kinds.append("delay")
                elif d["dup"]:
                    kinds.append("dup")
            for kind in kinds:
                # crdtlint: emits=fault.drop,fault.partition,fault.corrupt,fault.delay,fault.dup
                rec.record(
                    f"fault.{kind}", src=flow[0], dst=flow[1], seq=n,
                    size=len(data), digest=update_digest(data),
                )
        if d["drop"]:
            self.stats["partitioned" if d.get("partitioned") else "dropped"] += 1
            return 0
        if d["corrupt"]:
            # flip one deterministic byte: an encrypted envelope fails
            # authentication at the receiver and is discarded — the
            # recovery path is identical to a drop, but it exercises
            # the decrypt-reject seam too
            if data:
                pos = int(_hash01(self.schedule.seed, "pos", *flow, n) * len(data))
                data = data[:pos] + bytes([data[pos] ^ 0x41]) + data[pos + 1:]
            self.stats["corrupted"] += 1
        if d["delay"]:
            self.stats["delayed"] += 1
            self._held.append((self._polls + d["delay"], ip, port, data, unreliable))
            return 0
        mid = self._raw_send(ip, port, data, unreliable)
        self.stats["sent"] += 1
        if d["dup"]:
            self.stats["duplicated"] += 1
            self._raw_send(ip, port, data, unreliable)
        return mid

    def _raw_send(self, ip: str, port: int, data: bytes,
                  unreliable: bool) -> int:
        if unreliable:
            return self._inner.send_unreliable(ip, port, data)
        return self._inner.send(ip, port, data)

    # -- the endpoint surface ---------------------------------------------
    def send(self, ip: str, port: int, data: bytes) -> int:
        return self._fault_send(ip, port, data, False)

    def send_unreliable(self, ip: str, port: int, data: bytes) -> int:
        return self._fault_send(ip, port, data, True)

    def poll(self) -> int:
        self._polls += 1
        if self._held:
            due = [h for h in self._held if h[0] <= self._polls]
            if due:
                self._held = [h for h in self._held if h[0] > self._polls]
                for _, ip, port, data, unrel in due:
                    self._raw_send(ip, port, data, unrel)
                    self.stats["sent"] += 1
        return self._inner.poll()

    def recv_all(self):
        return self._inner.recv_all()

    def recv(self):
        return self._inner.recv()

    @property
    def pending(self) -> int:
        return self._inner.pending + len(self._held)

    @property
    def failed(self) -> int:
        return self._inner.failed

    @property
    def bind_ip(self) -> str:
        return self._inner.bind_ip

    @property
    def port(self) -> int:
        return self._inner.port

    def close(self) -> None:
        self._inner.close()

    def __getattr__(self, name):
        return getattr(self._inner, name)


def install_faults(router, schedule: FaultSchedule) -> FaultyEndpoint:
    """Wrap ``router.endpoint`` (idempotent layering: applies to
    whatever endpoint the router currently has, raw or NAT-wrapped)."""
    ep = FaultyEndpoint(router.endpoint, schedule)
    router.endpoint = ep
    return ep


# ---------------------------------------------------------------------------
# simulated NATs over loopback
# ---------------------------------------------------------------------------

_VMAGIC = b"\xf7\x43\x56\x31"  # virtual-net header marker ("\xf7CV1")


def _pack_addr(addr: Addr) -> bytes:
    return _socket.inet_aton(addr[0]) + int(addr[1]).to_bytes(2, "big")


def _unpack_addr(b: bytes) -> Addr:
    return (_socket.inet_ntoa(b[:4]), int.from_bytes(b[4:6], "big"))


class NatFabric:
    """Shared bookkeeping for one virtual network: which wrapper owns
    which virtual address. Public wrappers own their real address;
    natted wrappers own each external mapping port they allocate."""

    def __init__(self):
        self._owners: Dict[Addr, "NattedEndpoint"] = {}

    def register(self, vaddr: Addr, wrapper: "NattedEndpoint") -> None:
        self._owners[vaddr] = wrapper

    def resolve(self, vaddr: Addr) -> Optional[Addr]:
        w = self._owners.get(vaddr)
        return w.real_addr if w is not None else None


class SymmetricNat:
    """Per-destination external mappings, sequentially allocated —
    the NAT class that defeats plain hole punching (the mapping the
    rendezvous observed is NOT the mapping used toward a new peer)
    and that port prediction exploits (the new mapping lands on the
    next sequential port). Filtering is address-AND-port-dependent:
    inbound is accepted only on a mapping opened to exactly that
    remote (ip, port)."""

    def __init__(self, base_port: int, ip: str = "127.0.0.1"):
        self.ip = ip
        self._next = base_port
        self.by_dst: Dict[Addr, int] = {}     # remote -> ext port
        self.by_port: Dict[int, Addr] = {}    # ext port -> remote

    def open_mapping(self, dst: Addr) -> int:
        port = self.by_dst.get(dst)
        if port is None:
            port = self._next
            self._next += 1
            self.by_dst[dst] = port
            self.by_port[port] = dst
        return port

    def accept(self, dst_v: Addr, src_v: Addr) -> bool:
        if dst_v[0] != self.ip:
            return False
        remote = self.by_port.get(dst_v[1])
        return remote == src_v


class ConeNat(SymmetricNat):
    """One external mapping for every destination (endpoint-
    independent mapping), with PORT-restricted filtering: inbound is
    accepted only from (ip, port) pairs the host has sent to — the
    strictest cone variant, deliberately, so anything that traverses
    it also traverses the laxer address-restricted and full cones."""

    def open_mapping(self, dst: Addr) -> int:
        if not self.by_port:
            port = self._next
            self._next += 1
            self.by_port[port] = dst  # first remote (unused for filter)
        port = next(iter(self.by_port))
        self.by_dst[dst] = port
        return port

    def accept(self, dst_v: Addr, src_v: Addr) -> bool:
        if dst_v[0] != self.ip or dst_v[1] not in self.by_port:
            return False
        return src_v in self.by_dst  # address-restricted


class NattedEndpoint:
    """Endpoint wrapper placing its router behind a simulated NAT (or,
    with ``nat=None``, making a public host a fabric participant —
    every member of one fabric must be wrapped, since fabric traffic
    carries the virtual-address header).

    Outbound: opens the sender-side mapping (even when the target
    resolves nowhere — real NATs allocate on the outbound packet),
    resolves the virtual destination, and sends the header-framed
    message over the real transport. Inbound: verifies the message was
    addressed to one of our virtual addresses, applies the NAT's
    filter, and presents the sender's VIRTUAL address as the message
    source — which is what the router's observed-address machinery
    (rendezvous introductions, rebind challenges) then sees.
    """

    def __init__(self, inner, fabric: NatFabric,
                 nat: Optional[SymmetricNat] = None):
        self._inner = inner
        self.fabric = fabric
        self.nat = nat
        self.real_addr: Addr = (inner.bind_ip, inner.port)
        self.stats: Dict[str, int] = {
            "blackholed": 0, "filtered": 0, "delivered": 0,
        }
        if nat is None:
            fabric.register(self.real_addr, self)

    def _send(self, ip: str, port: int, data: bytes, unreliable: bool) -> int:
        dst = (ip, port)
        src_v = self.real_addr
        if self.nat is not None:
            ext = self.nat.open_mapping(dst)
            src_v = (self.nat.ip, ext)
            self.fabric.register(src_v, self)
        real = self.fabric.resolve(dst)
        if real is None:
            # nobody owns that virtual address (unallocated predicted
            # port, aged-out mapping): the real network drops this at
            # the NAT — silently, sender-side
            self.stats["blackholed"] += 1
            return 0
        framed = _VMAGIC + _pack_addr(src_v) + _pack_addr(dst) + data
        if unreliable:
            return self._inner.send_unreliable(real[0], real[1], framed)
        return self._inner.send(real[0], real[1], framed)

    def send(self, ip: str, port: int, data: bytes) -> int:
        return self._send(ip, port, data, False)

    def send_unreliable(self, ip: str, port: int, data: bytes) -> int:
        return self._send(ip, port, data, True)

    def recv_all(self):
        out = []
        for ip, port, data in self._inner.recv_all():
            if not data.startswith(_VMAGIC) or len(data) < 16:
                out.append((ip, port, data))  # non-fabric traffic
                continue
            src_v = _unpack_addr(data[4:10])
            dst_v = _unpack_addr(data[10:16])
            payload = data[16:]
            if self.nat is not None:
                if not self.nat.accept(dst_v, src_v):
                    self.stats["filtered"] += 1
                    continue
            elif dst_v != self.real_addr:
                self.stats["filtered"] += 1
                continue
            self.stats["delivered"] += 1
            out.append((src_v[0], src_v[1], payload))
        return out

    def poll(self) -> int:
        return self._inner.poll()

    @property
    def pending(self) -> int:
        return self._inner.pending

    @property
    def failed(self) -> int:
        return self._inner.failed

    @property
    def bind_ip(self) -> str:
        return self._inner.bind_ip

    @property
    def port(self) -> int:
        return self._inner.port

    def close(self) -> None:
        self._inner.close()

    def __getattr__(self, name):
        return getattr(self._inner, name)


def install_nat(router, fabric: NatFabric,
                nat: Optional[SymmetricNat] = None) -> NattedEndpoint:
    """Place a router on a virtual fabric, optionally behind a NAT."""
    ep = NattedEndpoint(router.endpoint, fabric, nat)
    router.endpoint = ep
    return ep


# ---------------------------------------------------------------------------
# seeded state-fork fault (the divergence sentinel's adversary)
# ---------------------------------------------------------------------------


class ForkFault:
    """Seeded fault that FORKS replica state silently — the failure
    class the drop/dup/delay/corrupt schedule above cannot produce
    (those are all eventually repaired by the protocol; CRDT
    convergence guarantees it). A fork models the guarantees-void
    cases: storage bitrot surviving validation, a buggy merge, a
    byzantine peer emitting two different ops under ONE (client,
    clock) id.

    :meth:`inject` applies a conflicting record with the SAME id but
    seed-derived DIFFERENT content to each given replica, bypassing
    the network (nothing is broadcast — the fork is silent). Every
    replica's state vector advances identically, so the sync
    protocol sees two healthy, "converged" peers whose states will
    never agree: later anti-entropy diffs carry each side's forked
    record, and the receiver drops it as an already-known id
    (first-wins dedup). Exactly the condition the divergence
    sentinel's snapshot-hash beacon exists to expose — pinned in
    tests/test_obs.py.
    """

    def __init__(self, seed: int = 0, *, root: str = "kv",
                 key: Optional[str] = None):
        self.seed = seed
        self.root = root
        self.key = key if key is not None else f"fork{seed}"
        # fake origin client well above test/client-id ranges but
        # inside the 31-bit random-id space
        self.client = (1 << 29) + (seed % (1 << 16))

    def inject(self, replicas) -> List[bytes]:
        """Fork the given replicas' states; returns the per-replica
        conflicting blobs (for assertions/postmortems)."""
        from crdt_tpu_torch.codec import v1
        from crdt_tpu_torch.core.ids import DeleteSet
        from crdt_tpu_torch.core.records import ItemRecord

        rec = get_recorder()
        blobs = []
        for i, rep in enumerate(replicas):
            content = f"fork-{self.seed}-{i}-" \
                      f"{int(_hash01(self.seed, 'fork', i) * 1e9)}"
            blob = v1.encode_update(
                [ItemRecord(client=self.client, clock=0,
                            parent_root=self.root, key=self.key,
                            content=content)],
                DeleteSet(),
            )
            rep.doc.apply_updates([blob], origin="fork")
            if rec.enabled:
                rec.record(
                    "fault.fork", replica=rep.router.public_key,
                    topic=rep.topic, digest=update_digest(blob),
                    size=len(blob),
                )
            blobs.append(blob)
        return blobs


# ---------------------------------------------------------------------------
# pumping helpers for faulty fabrics
# ---------------------------------------------------------------------------


def pump_until(routers, cond, *, timeout_s: float = 30.0,
               sleep_s: float = 0.002) -> None:
    """Poll a router set until ``cond()`` holds. Unlike
    :func:`crdt_tpu_torch.net.udp_router.pump`, this neither requires the
    fabric to go quiet (retry timers keep traffic flowing until
    convergence) nor treats burned retransmits as failure (dials at
    blackholed NAT mappings are EXPECTED to die here)."""
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > deadline:
            raise TimeoutError("condition not reached under faults")
        for r in routers:
            r.poll()
        time.sleep(sleep_s)


# ---------------------------------------------------------------------------
# fleet handoff chaos (round 24)
# ---------------------------------------------------------------------------


class HandoffFaultSchedule:
    """Deterministic fault plan for the fleet fabric
    (``fleet.fabric.MemFabric``): scripted windows keyed on per-link
    FRAME COUNTS (never clocks) plus seeded background drop/dup.

    ``windows`` rows are dicts: ``{"src", "dst", "kinds", "from_n",
    "to_n", "mode"}`` — frames number ``from_n``..``to_n``
    (1-based, inclusive) on link src->dst whose kind is in
    ``kinds`` (empty = all) get ``mode`` ``"drop"`` (the
    partition-during-handoff lever: drop exactly the commit/ack
    exchange) or ``"dup"``. Background ``drop``/``duplicate``
    probabilities hash like :class:`FaultSchedule`.
    """

    def __init__(self, seed: int = 0, *, windows=(),
                 drop: float = 0.0, duplicate: float = 0.0):
        self.seed = seed
        self.windows = [dict(w) for w in windows]
        self.drop = drop
        self.duplicate = duplicate
        self.window_hits = 0

    def decide(self, src: str, dst: str, kind: str, n: int) -> dict:
        d = {"drop": False, "dup": 0}
        for w in self.windows:
            if w.get("src") not in (None, src):
                continue
            if w.get("dst") not in (None, dst):
                continue
            kinds = w.get("kinds") or ()
            if kinds and kind not in kinds:
                continue
            if not int(w.get("from_n", 1)) <= n <= \
                    int(w.get("to_n", 1 << 30)):
                continue
            self.window_hits += 1
            if w.get("mode", "drop") == "drop":
                d["drop"] = True
                return d
            d["dup"] += 1
        if self.drop and \
                _hash01(self.seed, "fdrop", src, dst, n) < self.drop:
            d["drop"] = True
            return d
        if self.duplicate and \
                _hash01(self.seed, "fdup", src, dst, n) < self.duplicate:
            d["dup"] += 1
        return d


class DuplicateAdviceSchedule:
    """Seeded advice-row duplication/replay for the placement loop's
    idempotence proof: ``mangle(poll, rows)`` returns the rows plus
    seeded duplicates of this poll's rows and replays of earlier
    polls' rows (stale seqs) — the consumer must dedup on
    ``(proc, tenant, seq)`` or double-start migrations."""

    def __init__(self, seed: int = 0, *, duplicate: float = 0.5,
                 replay: float = 0.5):
        self.seed = seed
        self.duplicate = duplicate
        self.replay = replay
        self._history: List[dict] = []
        self.injected = 0

    def mangle(self, poll: int, rows) -> List[dict]:
        out = [dict(r) for r in rows]
        for i, r in enumerate(rows):
            if _hash01(self.seed, "adv_dup", poll, i) < self.duplicate:
                out.append(dict(r))
                self.injected += 1
        for i, r in enumerate(self._history):
            if _hash01(self.seed, "adv_rep", poll, i) < self.replay:
                out.append(dict(r))
                self.injected += 1
        self._history.extend(dict(r) for r in rows)
        del self._history[:-64]
        return out
