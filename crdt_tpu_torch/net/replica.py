"""Replica = document + sync protocol over a router (crdt.js:166-317).

The port's copy of ``crdt_tpu.net.replica``. ``ypear_crdt(router,
topic=...)`` mirrors the reference factory: it wires a
:class:`crdt_tpu_torch.api.Crdt` document (``merge_mode="scalar"``, the
default: the host engine, as in the reference) or a
:class:`crdt_tpu_torch.api.ResidentCrdt` (``merge_mode="resident"``:
the document resident on ``device``, the card unless the caller asks
for the CPU) to a router implementing the contract in
:mod:`crdt_tpu_torch.net.router`, registers the per-topic
sync contract (crdt.js:234-277), and dispatches inbound messages the
way the reference's ``onData`` does (crdt.js:279-312):

- ``{message}``            -> observer passthrough (crdt.js:280-284)
- ``{meta:'cleanup'}``     -> peer_close (crdt.js:285)
- ``{meta:'ready', ...}``  -> if synced, act as syncer: encode the diff
                              against the requester's state vector and
                              unicast ``{update, meta:'sync'}``
                              (crdt.js:286-291 — the one true delta in
                              the reference; every update here is one)
- ``{update}``             -> apply, persist, flip ``synced`` on
                              ``meta:'sync'`` (crdt.js:292-311)

Divergences (documented, SURVEY.md §6): broadcasts are per-transaction
deltas, not full state (Q2); a replica whose topic has no peers starts
synced (the reference's heuristic covers only ``-db`` topics and its
50 ms poll loop otherwise hangs a solo first node); collections
created remotely appear in the cache (D3).

Messages are the reference's, trace contexts included
(:mod:`crdt_tpu_torch.obs.propagation`), so port and reference replicas
share one network. The reference's engine-backed device mode
(``merge_mode="device"``) is not ported yet and raises at construction.
"""

from __future__ import annotations

import math
import random
import time
from typing import Any, Callable, Dict, List, Optional

from crdt_tpu_torch.api.doc import DEVICE_MERGE_ITEM, Crdt
from crdt_tpu_torch.codec import v1
from crdt_tpu_torch.core.ids import StateVector
from crdt_tpu_torch.obs import propagation
from crdt_tpu_torch.obs.propagation import get_propagation
from crdt_tpu_torch.obs.recorder import get_recorder, update_digest
from crdt_tpu_torch.obs.sentinel import DivergenceSentinel
from crdt_tpu_torch.obs.tracer import get_tracer
from crdt_tpu_torch.utils.backoff import jitter


class MemoryPersistence:
    """In-RAM stand-in for the update-log store (stage-6 interface).

    Mirrors the reference keyspace semantics (`doc_<name>_update_<ts>`,
    `_sv`, `_meta` — crdt.js:41-71) with monotonic sequence numbers
    instead of `Date.now()` keys (fix D6) and caller-supplied state
    vectors (fix D5: the reference recomputes SVs on an empty doc and
    stores garbage).
    """

    def __init__(self):
        self._updates: Dict[str, List[bytes]] = {}
        self._sv: Dict[str, bytes] = {}
        self._meta: Dict[str, dict] = {}
        self.closed = False

    def store_update(self, doc_name: str, update: bytes, sv: Optional[bytes] = None):
        self.store_updates(doc_name, [update], sv=sv)

    def store_updates(self, doc_name: str, updates,
                      sv: Optional[bytes] = None):
        """Batched window append — interface parity with the
        reference's ``LogPersistence`` (one "batch" per call; in RAM
        the batch is just a list extend)."""
        updates = list(updates)  # survive generator args
        for u in updates:
            if not isinstance(u, (bytes, bytearray)):
                raise TypeError("update must be bytes")  # crdt.js:29-31
        if not updates:
            return
        self._updates.setdefault(doc_name, []).extend(
            bytes(u) for u in updates
        )
        if sv is not None:
            self._sv[doc_name] = sv
        self._meta[doc_name] = {
            "last_updated": time.time(),
            "size": sum(len(u) for u in self._updates[doc_name]),
            "count": len(self._updates[doc_name]),
        }

    def get_all_updates(self, doc_name: str) -> List[bytes]:
        return list(self._updates.get(doc_name, []))

    def get_state_vector(self, doc_name: str) -> Optional[bytes]:
        return self._sv.get(doc_name)

    def get_meta(self, doc_name: str) -> Optional[dict]:
        return self._meta.get(doc_name)

    def compact(self, doc_name: str, snapshot: bytes, sv: Optional[bytes] = None):
        """Replace the update log with one snapshot update (the
        compaction the reference lacks — SURVEY.md Q3)."""
        self._updates[doc_name] = [bytes(snapshot)]
        if sv is not None:
            self._sv[doc_name] = sv
        self._meta[doc_name] = {
            "last_updated": time.time(),
            "size": len(snapshot),
            "count": 1,
        }

    def open(self):
        self.closed = False

    def close(self):
        self.closed = True


def _prefers_batch_verb(cls) -> bool:
    """Whether a persistence class should take the batched
    ``store_updates`` path. True only when the class defines
    ``store_updates`` at least as deep in the MRO as ``store_update``:
    a subclass that overrides ONLY ``store_update`` (to encrypt,
    mirror, filter — the sole verb that existed before round 9)
    expects to intercept every write, and the inherited batch verb
    would silently bypass it."""
    batch = single = None
    for i, c in enumerate(cls.__mro__):
        if batch is None and "store_updates" in vars(c):
            batch = i
        if single is None and "store_update" in vars(c):
            single = i
    if batch is None:
        return False
    return single is None or batch <= single


def _random_client_id() -> int:
    # Yjs randomizes the client id per doc *instance* — a deterministic
    # identity-derived id is unsafe: a restart without persistence
    # restarts the clock at 0, so new ops fall below peers' watermarks
    # and are silently discarded as stale duplicates, and any id
    # collision between two identities diverges replicas permanently
    return random.getrandbits(31)


class Replica:
    """One peer: document + transport verbs + sync state.

    ``device`` is where a resident document lives
    (``merge_mode="resident"``; the card by default, so with no card
    construction raises). A scalar document is the host engine and
    takes no device."""

    def __init__(
        self,
        router,
        topic: str,
        *,
        client_id: Optional[int] = None,
        persistence=None,
        observer_function: Optional[Callable[[dict], None]] = None,
        full_state_updates: bool = False,
        compact_every: Optional[int] = None,
        device_merge: Optional[bool] = None,
        batch_incoming: Optional[bool] = None,
        merge_mode: Optional[str] = None,
        device_min_rows: Optional[int] = None,
        probe_retry_s: float = 0.5,
        probe_retry_max_s: float = 8.0,
        probe_max_retries: int = 10,
        anti_entropy_s: Optional[float] = None,
        anti_entropy_max_s: Optional[float] = None,
        sentinel: Optional[bool] = None,
        on_divergence: Optional[Callable[[dict], None]] = None,
        inbox_max_bytes: Optional[int] = None,
        inbox_max_updates: Optional[int] = None,
        pending_max_records: Optional[int] = None,
        resync_retry_s: float = 0.25,
        resync_max_retries: int = 20,
        device="cuda",
    ):
        if not getattr(router, "is_ypear_router", False):
            raise TypeError("router is not a ypear router")  # crdt.js:172
        self.router = router
        self.topic = topic
        self.persistence = persistence
        self.observer_function = observer_function
        self.compact_every = compact_every
        self.synced = False
        self.closed = False
        self.peer_state_vectors: Dict[str, StateVector] = {}

        # partition tolerance: ready probes were historically fired
        # ONCE and lost probes were only repaired by topology changes.
        # Now un-synced replicas re-probe on a jittered exponential
        # backoff (bounded — a dead topic must not broadcast forever;
        # any topology change re-arms the schedule), and an optional
        # periodic anti-entropy cadence re-runs the two-way SV
        # exchange so updates lost AFTER sync (where the optimistic
        # SV advancement lies about delivery) are repaired too.
        self.probe_retry_s = probe_retry_s
        self.probe_retry_max_s = probe_retry_max_s
        self.probe_max_retries = probe_max_retries
        self.anti_entropy_s = anti_entropy_s
        self.anti_entropy_max_s = (
            anti_entropy_max_s
            if anti_entropy_max_s is not None
            else (anti_entropy_s or 0.0) * 16
        )
        self._probe_interval = probe_retry_s
        self._probe_retries = 0
        self._next_probe_at: Optional[float] = None
        self._ae_interval = anti_entropy_s or 0.0
        self._next_ae_at: Optional[float] = (
            time.monotonic() + anti_entropy_s if anti_entropy_s else None
        )

        # merge_mode selects the document backend:
        #   "scalar"   — Engine-backed, host integrate loop
        #   "device"   — Engine-backed, kernel merges (device_merge):
        #                not ported yet, raises below
        #   "resident" — no engine at all: device-resident columns
        #                serve merges, local ops, AND the sync protocol
        #                (crdt_tpu_torch.api.resident_doc)
        if merge_mode is None:
            if device_merge:
                merge_mode = "device"
            else:
                # CRDT_TPU_DEVICE=1 selects RESIDENT, the device-
                # resident product mode: the engine-backed device gate
                # pays a device round-trip per small merge (the
                # reference's choice; merge_mode="device" is its
                # explicit differential oracle)
                import os

                env = os.environ.get("CRDT_TPU_DEVICE", "0") not in (
                    "", "0", "false", "False",
                )
                # an explicit device_merge=False still means scalar
                # even with the env var set (same precedence Crdt uses)
                merge_mode = (
                    "resident" if env and device_merge is None
                    else "scalar"
                )
        if merge_mode not in ("scalar", "device", "resident"):
            raise ValueError(f"unknown merge_mode {merge_mode!r}")
        if merge_mode == "device":
            # the engine-backed kernel merge is not ported: running the
            # replica on the host engine instead would hide that
            raise NotImplementedError(
                f"merge_mode='device' is not ported yet "
                f"({DEVICE_MERGE_ITEM}); use merge_mode='resident' "
                "(the device-resident document) or 'scalar'"
            )
        self.merge_mode = merge_mode

        cid = client_id if client_id is not None else _random_client_id()
        if merge_mode == "resident":
            from crdt_tpu_torch.api.resident_doc import ResidentCrdt

            self.doc = ResidentCrdt(
                cid,
                observer_function=observer_function,
                on_update=self._on_local_update,
                full_state_updates=full_state_updates,
                device_min_rows=device_min_rows,
                device=device,
            )
        else:
            # scalar: device_merge is falsy here or overridden by an
            # explicit merge_mode="scalar" (the reference passes
            # device_merge=False then)
            self.doc = Crdt(
                cid,
                observer_function=observer_function,
                on_update=self._on_local_update,
                full_state_updates=full_state_updates,
            )
        # receive-side batching: updates arriving within one router
        # poll round are buffered and applied as ONE merge transaction
        # (one device round in resident mode, above the crossover) —
        # the north-star gate at the sync handler. Defaults on in
        # resident mode; scalar mode keeps per-message application
        # unless asked.
        if batch_incoming is None:
            batch_incoming = self.doc.device_merge
        self.batch_incoming = batch_incoming
        self._inbox: List[tuple] = []  # (update bytes, meta dict)

        # resource guards: the inbox byte/count
        # budget sheds the OLDEST buffered updates (re-fetched via the
        # anti-entropy/re-probe path — our SV never advertised them),
        # and the pending-stash cap evicts blocked records whose
        # missing (client, clock) ranges the re-probe machinery below
        # then re-fetches from the blocking peer. None = unbounded
        # (the historical behavior).
        self.inbox_max_bytes = inbox_max_bytes
        self.inbox_max_updates = inbox_max_updates
        self._inbox_bytes = 0
        self.inbox_peak_bytes = 0  # bench/test evidence of boundedness
        if pending_max_records is not None:
            self.doc.engine.pending_limit = pending_max_records
        # bounded-backoff targeted re-probe: armed by sheds/evictions,
        # pumped by tick(); independent of the un-synced probe retry
        # schedule (a replica can be "synced" and still owe itself a
        # re-fetch of evicted state)
        self.resync_retry_s = resync_retry_s
        self.resync_max_retries = resync_max_retries
        self._resync_at: Optional[float] = None
        self._resync_interval = resync_retry_s
        self._resync_retries = 0
        self._resync_needs: Dict[int, int] = {}  # client -> clock owed

        # divergence sentinel (obs.sentinel): snapshot-hash beacons
        # ride the anti-entropy cadence (``sentinel=None`` => beacons
        # enabled exactly when ``anti_entropy_s`` is set). Inbound
        # beacons are ALWAYS checked — a beaconing peer gets fork
        # coverage even from replicas that never beacon themselves.
        self._sentinel_beacons = (
            sentinel if sentinel is not None else anti_entropy_s is not None
        )
        self.sentinel = DivergenceSentinel(
            self.doc, topic=topic, replica=router.public_key,
            on_divergence=on_divergence,
        )
        # per-origin trace-id sequence: sync frames are stamped with
        # (client, seq, monotonic ts) so per-peer propagation and
        # convergence lag become measurable gauges downstream.
        # Round 19: sampled origin frames additionally carry a wire
        # trace context (origin tid + per-leg path records) so the
        # path reconstructs ACROSS processes — see obs/propagation
        self._tid_seq = 0
        self._trace_sample = propagation.sample_rate()
        self._pk8 = str(router.public_key)[:8]

        # load from the update log (crdt.js:193-217): the whole log
        # replays as ONE batched merge (one observer flush; in device
        # mode, one kernel dispatch instead of one per logged update)
        if persistence is not None:
            if getattr(persistence, "closed", False):
                persistence.open()  # restart after self_close
            self.doc.apply_updates(
                persistence.get_all_updates(topic), origin="load"
            )

        if not router.started:
            router.start(router.options.get("network_name"))  # crdt.js:231

        (
            self._propagate,
            self._broadcast,
            self.for_peers,
            self._to_peer,
        ) = router.alow(topic, self._on_data)
        # the per-topic sync contract the router drives (crdt.js:234-277)
        # — registered after `alow` so a topology-triggered sync() never
        # runs before the transport verbs exist
        router.update_options_cache(
            {
                topic: {
                    "synced": False,
                    "sync": self.sync,
                    "peer_state_vectors": self.peer_state_vectors,
                    "update_state_vector": self._update_own_sv,
                    "set_peer_state_vector": self.set_peer_state_vector,
                    "peer_close": self.peer_close,
                    "self_close": self.self_close,
                    # routers call this after each poll/delivery round
                    # so buffered inbound updates land as one merge
                    "flush": self.flush_incoming,
                    # ... and this afterwards: the replica's timer
                    # pump (probe retry/backoff, periodic
                    # anti-entropy) — a lost sync message is now a
                    # delay, not a permanent divergence
                    "tick": self.tick,
                    # async-transport hook (e.g. the UDP router): a
                    # peer subscribing to our topic AFTER construction
                    # triggers a directed anti-entropy probe even when
                    # we are already synced — on a real network peers
                    # appear at any time and both sides must reconcile
                    "peer_joined": self.probe,
                }
            }
        )

        if not router.peers_on(topic):
            # solo first node: nobody can answer a ready probe
            self._set_synced(True)
        else:
            self.sync()

    # ------------------------------------------------------------------
    # sync contract (crdt.js:234-277)
    # ------------------------------------------------------------------
    def sync(self) -> None:
        """Anti-entropy entry point: announce readiness with our SV
        (crdt.js:237-244). Peers answer with a diff update."""
        if self.synced or self.closed:
            return
        if not self.router.peers_on(self.topic):
            # the last peer left before answering: a solo replica is
            # synced by definition (same rule as construction; without
            # it a topic whose synced members all departed would wedge
            # every remaining and future replica forever)
            self._set_synced(True)
            return
        self.probe()

    def probe(self, public_key: Optional[str] = None, *,
              _rearm: bool = True) -> None:
        """Unconditional ready probe (unlike :meth:`sync`, which is a
        no-op once synced): ask one peer — or everyone — for whatever
        we lack. The two-way handshake then reconciles both sides.

        A topology-triggered probe (``public_key`` set: someone
        joined) re-arms the retry schedule from its base interval —
        new peers are new chances to sync, whatever the retry budget
        said before. The resync pump passes ``_rearm=False``: its
        probes ride their OWN backoff and must not refresh the join
        schedule's retry budget on every pump."""
        if self.closed:
            return
        self.flush_incoming()  # advertise the SV incl. buffered updates
        msg = {
            "meta": "ready",
            "public_key": self.router.public_key,
            "state_vector": self.doc.encode_state_vector(),
        }
        rec = get_recorder()
        if rec.enabled:
            rec.record(
                "probe.send", topic=self.topic,
                replica=self.router.public_key, peer=public_key,
            )
        if public_key is not None:
            if _rearm:
                self._probe_retries = 0
                self._probe_interval = self.probe_retry_s
                if not self.synced:
                    # re-arm from the BASE interval even when a
                    # (backed-off) deadline is already pending: the
                    # new peer is a fresh chance to sync and must be
                    # retried promptly
                    self._next_probe_at = (
                        time.monotonic() + self._probe_interval * jitter()
                    )
            self._to_peer(public_key, msg)
        else:
            self._broadcast(msg)
        if _rearm and not self.synced and self._next_probe_at is None:
            self._next_probe_at = (
                time.monotonic() + self._probe_interval * jitter()
            )

    def tick(self, now: Optional[float] = None) -> None:
        """Timer pump, called by routers once per poll/delivery round:
        retries un-synced ready probes (jittered exponential backoff,
        bounded by ``probe_max_retries``) and runs the periodic
        anti-entropy cadence when ``anti_entropy_s`` is set (interval
        backs off while rounds stay idle, resets on any activity)."""
        if self.closed:
            return
        if now is None:
            now = time.monotonic()
        if (
            not self.synced
            and self._next_probe_at is not None
            and now >= self._next_probe_at
        ):
            if self._probe_retries >= self.probe_max_retries:
                self._next_probe_at = None  # bounded; re-armed on join
            else:
                self._probe_retries += 1
                get_tracer().count("replica.probe_retries")
                self._probe_interval = min(
                    self._probe_interval * 2, self.probe_retry_max_s
                )
                self._next_probe_at = (
                    now + self._probe_interval * jitter()
                )
                self.probe()
        if self._resync_at is not None and now >= self._resync_at:
            self._pump_resync(now)
        if self._next_ae_at is not None and now >= self._next_ae_at:
            get_tracer().count("replica.anti_entropy_rounds")
            sent = self.anti_entropy()
            # the SV-records-driven delta above repairs known
            # deficits; the periodic probe below re-exchanges REAL
            # state vectors, repairing deficits the optimistic
            # advancement mis-recorded (a dropped broadcast)
            self.probe()
            if self._sentinel_beacons:
                # the sentinel's snapshot-hash beacon rides the same
                # cadence: silent divergence (equal SVs, unequal
                # state) becomes an observable event at the receivers
                self.beacon()
            if sent:
                self._ae_interval = self.anti_entropy_s
            else:
                self._ae_interval = min(
                    self._ae_interval * 2, self.anti_entropy_max_s
                )
            self._next_ae_at = now + self._ae_interval * jitter()

    # ------------------------------------------------------------------
    # guard layer: shed + targeted re-probe
    # ------------------------------------------------------------------
    def _shed_inbox(self) -> None:
        """Enforce the inbox budget: drop the OLDEST buffered updates
        until within bounds (always keeping the newest — a single
        over-budget update must still make progress). Shed updates
        were never applied, so our advertised SV doesn't cover them
        and any ready-probe answer re-ships them; shedding therefore
        trades latency for bounded memory, never state. Each shed
        re-arms the anti-entropy cadence and the re-probe schedule so
        the re-fetch is immediate, not left to luck."""
        def over(n_left: int, bytes_left: int) -> bool:
            return (
                (self.inbox_max_bytes is not None
                 and bytes_left > self.inbox_max_bytes)
                or (self.inbox_max_updates is not None
                    and n_left > self.inbox_max_updates)
            )

        if not over(len(self._inbox), self._inbox_bytes):
            return
        # one O(shed) slice, not per-item pop(0): a tiny-update flood
        # against a byte budget can hold MANY buffered items, and the
        # guard must stay linear exactly when it is needed
        shed_n = shed_b = 0
        n = len(self._inbox)
        while n - shed_n > 1 and over(n - shed_n, self._inbox_bytes):
            shed_b += len(self._inbox[shed_n][0])
            self._inbox_bytes -= len(self._inbox[shed_n][0])
            shed_n += 1
        if not shed_n:
            return
        self._inbox = self._inbox[shed_n:]
        tracer = get_tracer()
        tracer.count("guard.inbox_shed", shed_n)
        tracer.count("guard.inbox_shed_bytes", shed_b)
        tracer.gauge("guard.inbox_bytes", self._inbox_bytes)
        rec = get_recorder()
        if rec.enabled:
            rec.record(
                "guard.shed", topic=self.topic,
                replica=self.router.public_key, n=shed_n, size=shed_b,
            )
        # immediate AE re-arm: the next tick runs the repair round now
        if self._next_ae_at is not None:
            self._next_ae_at = time.monotonic()
        self._arm_resync()

    def _arm_resync(self, needs: Optional[Dict[int, int]] = None) -> None:
        """Arm (or extend) the bounded-backoff re-probe. ``needs``
        maps client -> highest evicted clock; satisfaction = our SV
        passing that clock. A shed arms with no needs: one prompt
        probe re-fetches whatever was dropped (the answer is an SV
        diff, so it is exact), with the AE cadence as the backstop."""
        if needs:
            for c, hi in needs.items():
                self._resync_needs[c] = max(self._resync_needs.get(c, -1), hi)
        if self._resync_at is None:
            self._resync_interval = self.resync_retry_s
            self._resync_retries = 0
            self._resync_at = (
                time.monotonic() + self._resync_interval * jitter()
            )

    def _resync_target(self) -> Optional[str]:
        """A peer whose recorded SV covers an owed range — the
        BLOCKING peer, probed by unicast; None broadcasts."""
        for c, hi in self._resync_needs.items():
            for pk, sv in self.peer_state_vectors.items():
                if sv.get(c) > hi:
                    return pk
        return None

    def _pump_resync(self, now: float) -> None:
        sv = self.doc.state_vector()
        self._resync_needs = {
            c: hi for c, hi in self._resync_needs.items()
            if sv.get(c) <= hi
        }
        if self._resync_retries >= self.resync_max_retries:
            # bounded: the periodic anti-entropy cadence (and any
            # topology change) remains the backstop
            self._resync_at = None
            return
        self._resync_retries += 1
        get_tracer().count("guard.resync_probes")
        self.probe(self._resync_target(), _rearm=False)
        if self._resync_needs:
            self._resync_interval = min(
                self._resync_interval * 2, self.probe_retry_max_s
            )
            self._resync_at = now + self._resync_interval * jitter()
        else:
            self._resync_at = None  # satisfied (or shed-only: one shot)

    def beacon(self) -> None:
        """Broadcast one divergence-sentinel beacon: our state vector
        plus snapshot/delete-set digests. Receivers whose SV equals
        ours compare digests; a mismatch with equal delete sets is
        silent divergence and raises an observable event (with a
        flight-recorder dump) at the receiver."""
        if self.closed or not self.router.peers_on(self.topic):
            return
        self.flush_incoming()  # digest the state the SV advertises
        self._broadcast({
            "meta": "beacon",
            "public_key": self.router.public_key,
            "state_vector": self.doc.encode_state_vector(),
            **self.sentinel.beacon_payload(),
        })

    def _reset_ae_backoff(self) -> None:
        if self.anti_entropy_s is not None:
            was = self._ae_interval
            self._ae_interval = self.anti_entropy_s
            if was != self._ae_interval and self._next_ae_at is not None:
                self._next_ae_at = min(
                    self._next_ae_at,
                    time.monotonic() + self._ae_interval * jitter(),
                )

    def _set_synced(self, value: bool) -> None:
        self.synced = value
        if value:
            self._next_probe_at = None
            self._probe_retries = 0
            self._probe_interval = self.probe_retry_s
        self.router.options["cache"].setdefault(self.topic, {})["synced"] = value

    def _update_own_sv(self) -> bytes:
        self.flush_incoming()  # the advertised SV covers buffered updates
        return self.doc.encode_state_vector()

    def set_peer_state_vector(self, public_key: str, sv_bytes: bytes) -> None:
        # the router-cache sync-contract hook: peers' SV bytes arrive
        # here too, so the same admission check applies (a hostile SV
        # drops, it does not raise into the caller's loop)
        sv = self._decode_peer_sv(sv_bytes, public_key)
        if sv is not None:
            self.peer_state_vectors[public_key] = sv

    def _decode_peer_sv(self, blob, from_pk: str):
        """Admission check for a peer-supplied state vector (round-17
        wire-taint contract): a hostile SV — client/clock past the
        wire bounds, truncated, trailing garbage, or not bytes at all
        (lib0 `any` payloads can carry str/int/None here, and
        ``bytes(2**40)`` would be the allocation bomb itself) —
        degrades exactly like a malformed update (counted, recorded,
        dropped) instead of raising out of the router's poll loop.
        Returns None on reject; callers skip the protocol action."""
        try:
            if not isinstance(blob, (bytes, bytearray)):
                raise ValueError("state vector is not bytes")
            return v1.decode_state_vector(blob)
        except ValueError:
            get_tracer().count("replica.malformed_updates")
            rec = get_recorder()
            if rec.enabled:
                rec.record(
                    "update.malformed", topic=self.topic,
                    replica=self.router.public_key, peer=from_pk,
                    size=len(blob)
                    if isinstance(blob, (bytes, bytearray)) else 0,
                )
            return None

    def peer_close(self, public_key: str) -> None:
        self.peer_state_vectors.pop(public_key, None)  # crdt.js:266-270

    def self_close(self) -> None:
        """Close persistence and announce cleanup (crdt.js:272-275)."""
        if self.closed:
            return
        self.flush_incoming()  # buffered updates land before the log closes
        self.closed = True
        if self.persistence is not None:
            self.persistence.close()
        self._propagate({"meta": "cleanup", "public_key": self.router.public_key})
        self.router.unsubscribe(self.topic)

    def anti_entropy(self) -> Dict[str, int]:
        """One targeted delta round driven by recorded peer SVs: for
        each peer whose state vector shows a record deficit, unicast
        exactly the records it lacks (the syncer's SV-diff,
        crdt.js:288, generalized to every known peer instead of only
        ready-probe requesters). Returns {peer: bytes_sent}.

        Bytes scale with the DEFICIT, not the doc: a peer missing 3
        ops gets a 3-op update (plus the delete-set tail every diff
        carries, Yjs-style). Peers with no record deficit get nothing
        — tombstone-only surplus still flows through the ready/sync
        handshake, which sends unconditionally. Recorded SVs advance
        optimistically (transports retry until acked; a lost message
        is recovered by the next ready probe). The device-path
        analogue is :mod:`crdt_tpu_torch.parallel.delta`.
        """
        sent: Dict[str, int] = {}
        if self.closed:
            return sent
        self.flush_incoming()  # deficits computed on current state
        mine = self.doc.state_vector()
        rec = get_recorder()
        for pk, sv in list(self.peer_state_vectors.items()):
            if sv.diff_dominates(mine):
                continue  # no record deficit
            update = self.doc.encode_state_as_update(sv)
            # each AE delta is its own origin frame (per-peer diffs
            # differ); the anti_entropy route tag makes repair
            # traffic separable from first-delivery lag downstream
            trace, path = self._trace_fields(update, "anti_entropy")
            self._to_peer(pk, {"update": update, **trace})
            sent[pk] = len(update)
            if rec.enabled:
                rec.record(
                    "ae.delta", topic=self.topic,
                    replica=self.router.public_key, peer=pk,
                    size=len(update), digest=update_digest(update),
                    tid=trace["tid"], path=path,
                )
            self.peer_state_vectors[pk] = sv.merge(mine)
        if sent:
            tracer = get_tracer()
            tracer.count("replica.anti_entropy_bytes", sum(sent.values()))
        return sent

    # ------------------------------------------------------------------
    # local update tail: persist + broadcast (crdt.js:442-446)
    # ------------------------------------------------------------------
    def _trace_fields(self, update: bytes, route: str) -> tuple:
        """The wire trace fields for one ORIGIN frame: the round-18
        trace id + hop count, and (for sampled tids) the round-19
        wire trace context whose first path record tags this frame's
        semantic route (``direct`` broadcasts, ``anti_entropy``
        deltas, ``sync_answer`` diffs — the transport seam may
        retag a direct leg ``predicted``/``relayed``, and forward
        seams append further records). Returns ``(fields, path)`` —
        the dict to splice into the outbound message, plus the
        recorder-shape path (None when the tid was not sampled)."""
        self._tid_seq += 1
        tid = [self.doc.engine.client_id, self._tid_seq,
               time.monotonic()]
        fields: dict = {"tid": tid, "hop": 0}
        path = None
        # contexts ship only while observability is on in THIS
        # process (tracer or recorder): with both off, the origin
        # frame pays nothing beyond the two attribute checks — the
        # same free-when-off contract as every obs hook. Within an
        # observed process the sampling knob scales the tax.
        if (
            (get_tracer().enabled or get_recorder().enabled)
            and propagation.sampled(tid[0], tid[1],
                                    self._trace_sample)
        ):
            ctx = propagation.start_context(
                tid[0], tid[1], self._pk8, route, ts=tid[2]
            )
            tc = propagation.encode_context(ctx)
            fields["tc"] = tc
            path = ctx.path_json()
            get_propagation().record_send(tc, len(update))
        return fields, path

    def _on_local_update(self, update: bytes, meta: dict) -> None:
        self._persist(update)
        if not self.closed:
            # origin trace id: (client, per-origin seq, monotonic ts).
            # Receivers subtract the stamp from their clock to gauge
            # propagation/convergence lag (exact in-process and on a
            # shared clock; cross-host offsets shift it uniformly).
            trace, path = self._trace_fields(update, "direct")
            rec = get_recorder()
            if rec.enabled:
                rec.record(
                    "update.send", topic=self.topic,
                    replica=self.router.public_key, size=len(update),
                    digest=update_digest(update), tid=trace["tid"],
                    hop=0, path=path,
                )
            # hop count: 0 at the origin, so a direct receiver
            # records hop=1. Since round 19 every origin frame —
            # broadcasts here, sync answers and AE deltas at their
            # seams — carries tid/hop plus (sampled) the wire trace
            # context, and the relay forward seam in udp_router
            # actually increments both (closing the round-18
            # caveat): a relayed delivery records hop=2 with the
            # relay's own path record.
            self._propagate({"update": update, **trace, **meta})
            self._advance_topic_peer_svs()
            self._reset_ae_backoff()  # fresh writes: stay chatty

    def _advance_topic_peer_svs(self) -> None:
        """Optimistically advance recorded SVs of peers CURRENTLY on
        the topic — they just received our broadcast (transports retry
        until acked). Keeps ``anti_entropy`` deficit-accurate without
        extra probes; a peer that truly lost the message re-syncs via
        its next ready probe. Peers not subscribed right now (left,
        partitioned) are untouched and stay owed the delta."""
        reached: List[str] = []
        self.for_peers(reached.append)
        if not reached:
            return
        mine = self.doc.state_vector()
        for pk in reached:
            sv = self.peer_state_vectors.get(pk)
            if sv is not None:
                self.peer_state_vectors[pk] = sv.merge(mine)

    def _persist(self, update: bytes) -> None:
        self._persist_many([update])

    def _persist_many(self, updates) -> None:
        """Persist a whole merge window as ONE store batch: the
        batched-incoming path (``flush_incoming``) applies N buffered
        updates in one transaction, so the WAL gets one KV batch —
        N log keys + one SV + one meta — instead of N separate 3-key
        batches (``persist.batches`` vs ``persist.appends`` counters
        record the ratio)."""
        if not updates:
            return
        if self.persistence is None or self.persistence.closed:
            return
        tracer = get_tracer()
        try:
            with tracer.span("replica.persist"):
                sv = self.doc.encode_state_vector()
                if _prefers_batch_verb(type(self.persistence)):
                    self.persistence.store_updates(
                        self.topic, list(updates), sv=sv
                    )
                else:  # no batch verb, or store_update overridden below it
                    for u in updates:
                        self.persistence.store_update(self.topic, u, sv=sv)
        except (OSError, RuntimeError) as e:
            # storage failure policy, last-resort rung: a disk fault
            # must degrade (the doc still holds the state; the WAL is
            # merely behind), never kill the apply path mid-merge.
            # LogPersistence retries + buffers internally and only
            # raises once ITS policy is exhausted or set to "raise";
            # this guard covers third-party backends with no policy.
            tracer.count("persist.errors")
            rec = get_recorder()
            if rec.enabled:
                rec.record(
                    "persist.error", topic=self.topic,
                    replica=self.router.public_key, error=repr(e)[:200],
                )
            return
        for u in updates:
            tracer.count("replica.bytes_persisted", len(u))
        if self.compact_every:
            try:
                meta = self.persistence.get_meta(self.topic)
                if meta and meta.get("count", 0) >= self.compact_every:
                    self.compact()
            except (OSError, RuntimeError):
                # same policy as the store verbs above: a failing
                # compaction trigger (meta read or the compact write)
                # must degrade — skipped now, retried at the next
                # threshold crossing — never kill the apply path
                tracer.count("persist.errors")

    def compact(self) -> None:
        """Squash the update log into one full-state snapshot."""
        if self.persistence is None:
            return
        eng = self.doc.engine
        if eng.pending or eng.pending_deletes.ranges:
            # stashed updates exist only in the raw log; a snapshot of
            # integrated state would drop them across a restart
            return
        with get_tracer().span("replica.compact"):
            self.persistence.compact(
                self.topic,
                self.doc.encode_state_as_update(),
                sv=self.doc.encode_state_vector(),
            )

    # ------------------------------------------------------------------
    # receive path (crdt.js:279-312)
    # ------------------------------------------------------------------
    def _on_data(self, msg: dict, from_pk: str) -> None:
        if self.closed:
            return
        if "message" in msg:
            # free-form payload passthrough (crdt.js:280-284)
            if self.observer_function is not None:
                self.observer_function(msg)
            return
        meta = msg.get("meta")
        if meta == "cleanup":
            self.peer_close(msg.get("public_key", from_pk))
            return
        if meta == "beacon":
            # sentinel check against OUR settled state: buffered
            # updates land first, or a batching window would read as
            # SV lag / a false digest mismatch
            self.flush_incoming()
            rec = get_recorder()
            if rec.enabled:
                rec.record(
                    "beacon.recv", topic=self.topic,
                    replica=self.router.public_key,
                    peer=msg.get("public_key", from_pk),
                    digest=msg.get("digest"),
                )
            # .get(): a key-less beacon is as attacker-shaped as a
            # hostile SV — None rejects through the same admission
            # check instead of a KeyError killing the poll loop
            beacon_sv = self._decode_peer_sv(
                msg.get("state_vector"), from_pk
            )
            if beacon_sv is None:
                return
            self.sentinel.check(
                msg.get("public_key", from_pk),
                beacon_sv,
                msg.get("digest", ""),
                msg.get("ds_digest", ""),
            )
            return
        if meta == "ready":
            # answer with everything we hold: buffered updates must
            # land first or the diff would silently omit them
            self.flush_incoming()
            # act as syncer (crdt.js:286-291). Unlike the reference,
            # unsynced replicas answer too: two unsynced peers exchange
            # what they have and both converge (the reference's
            # synced-only gate deadlocks a topic whose synced members
            # all left). The reply carries our own SV so the requester
            # can return a back-diff — the reference's handshake is
            # one-way and silently strands the requester's surplus
            # state (e.g. ops replayed from its local log).
            requester = msg.get("public_key", from_pk)
            sv = self._decode_peer_sv(msg.get("state_vector"), from_pk)
            if sv is None:
                return
            diff = self.doc.encode_state_as_update(sv)
            # a sync answer is an ORIGIN frame (a fresh diff, not a
            # forward): it gets its own tid + trace context, route
            # tagged sync_answer — the round-18 "unknown" hop class
            # becomes attributable
            trace, path = self._trace_fields(diff, "sync_answer")
            rec = get_recorder()
            if rec.enabled:
                rec.record(
                    "sync.answer", topic=self.topic,
                    replica=self.router.public_key, peer=requester,
                    size=len(diff), digest=update_digest(diff),
                    tid=trace["tid"], path=path,
                )
            self._to_peer(
                requester,
                {
                    "update": diff,
                    "meta": "sync",
                    "state_vector": self.doc.encode_state_vector(),
                    **trace,
                },
            )
            # record the requester's SV ADVANCED by the diff just sent,
            # or every later anti_entropy round would re-unicast the
            # whole document to a peer that already converged
            self.peer_state_vectors[requester] = sv.merge(
                self.doc.state_vector()
            )
            return
        if "update" in msg:
            if self.batch_incoming:
                self._inbox.append((msg["update"], dict(msg), from_pk))
                self._inbox_bytes += len(msg["update"])
                self._shed_inbox()
                # peak measured post-shed: the budget is a real bound
                # (exceeded only by a single over-budget update, which
                # is always kept — see _shed_inbox)
                if self._inbox_bytes > self.inbox_peak_bytes:
                    self.inbox_peak_bytes = self._inbox_bytes
                return
            self._apply_incoming([(msg["update"], dict(msg), from_pk)])

    def flush_incoming(self) -> int:
        """Apply all buffered inbound updates as ONE merge transaction.
        Returns the number of updates applied. No-op when empty; safe
        to call from any router at any time."""
        if not self._inbox:
            return 0
        items, self._inbox = self._inbox, []
        if self._inbox_bytes and (
            self.inbox_max_bytes is not None
            or self.inbox_max_updates is not None
        ):
            # keep the budget gauge honest: a drained inbox is 0
            # bytes, not whatever the last shed left behind
            get_tracer().gauge("guard.inbox_bytes", 0)
        self._inbox_bytes = 0
        self._apply_incoming(items)
        return len(items)

    def _apply_incoming(self, items) -> None:
        tracer = get_tracer()
        rec = get_recorder()
        obs_on = tracer.enabled or rec.enabled
        t_apply = time.monotonic() if obs_on else 0.0
        updates = [u for u, _, _ in items]
        try:
            with tracer.span("replica.apply_update"):
                # two origin-preserving sub-batches: observers filter
                # on origin, so a handshake reply sharing a round with
                # ordinary broadcasts must not relabel them "sync"
                remote = [u for u, m, _ in items if m.get("meta") != "sync"]
                syncs = [u for u, m, _ in items if m.get("meta") == "sync"]
                if remote:
                    self.doc.apply_updates(remote, origin="remote")
                if syncs:
                    self.doc.apply_updates(syncs, origin="sync")
        except ValueError:
            # a malformed blob poisons its whole batch decode; isolate
            # it by RECURSIVE BISECTION so one poisoned blob in an
            # N-update flush costs O(log N) extra merge transactions,
            # not O(N) per-item retries (application is idempotent, so
            # re-applying survivors is safe; replica.isolation_splits
            # pins the cost in the malformed-update tests)
            if len(items) == 1:
                tracer.count("replica.malformed_updates")
                if rec.enabled:
                    rec.record(
                        "update.malformed", topic=self.topic,
                        replica=self.router.public_key,
                        peer=items[0][2], size=len(items[0][0]),
                        digest=update_digest(items[0][0]),
                    )
                return
            tracer.count("replica.isolation_splits")
            mid = len(items) // 2
            self._apply_incoming(items[:mid])
            self._apply_incoming(items[mid:])
            return
        if updates:
            self._reset_ae_backoff()  # remote activity: stay chatty
        # pending-stash evictions (guard layer): the engine recorded
        # the missing (client, clock) ranges; arm the targeted
        # bounded-backoff re-probe that re-fetches the evicted state
        take = getattr(self.doc.engine, "take_evicted_ranges", None)
        ev = take() if take is not None else None
        if ev:
            if rec.enabled:
                rec.record(
                    "guard.evict", topic=self.topic,
                    replica=self.router.public_key,
                    ranges={c: list(r) for c, r in ev.items()},
                )
            self._arm_resync({c: hi for c, (_, hi) in ev.items()})
        if obs_on:
            # observability tail AFTER a successful merge (so the
            # malformed-batch per-item retry above records each
            # surviving item exactly once, and the disabled path
            # pays nothing beyond the two attribute checks):
            # propagation lag = origin stamp -> merge entry,
            # convergence lag = origin stamp -> integrated here
            t_done = time.monotonic()
            for u, m, from_pk in items:
                tid = m.get("tid")
                # hop count (round 18): the frame's hop stamp + this
                # delivery leg. Frames predating the stamp (an older
                # peer) read as one unattributed hop — None, not a
                # guessed 1, so obsq can tell "unknown" from "direct".
                raw_hop = m.get("hop")
                hop = raw_hop + 1 if isinstance(raw_hop, int) else None
                # round 19: a carried trace context decomposes the
                # lag per route-tagged leg (obs/propagation ledger:
                # replica.hop_lag{route=} + birth_to_visibility) and
                # supplies the authoritative hop count / path. A
                # hostile context is counted + recorded and dropped
                # — the update it rode on is untouched.
                ctx = path = None
                tc = m.get("tc")
                if tc is not None:
                    ctx = propagation.decode_or_none(tc)
                    if ctx is None:
                        if rec.enabled:
                            rec.record(
                                "update.bad_context",
                                topic=self.topic,
                                replica=self.router.public_key,
                                peer=from_pk,
                                size=len(tc) if isinstance(
                                    tc, (bytes, bytearray)) else 0,
                            )
                    else:
                        hop = get_propagation().record_receipt(
                            ctx, recv_ts=t_done
                        )
                        path = ctx.path_json()
                # the tid rides the same untrusted frame as tc: a
                # non-numeric (or non-finite) origin stamp must
                # degrade to "no lag observed", never raise out of
                # the flush/poll loop
                if tracer.enabled and isinstance(tid, (list, tuple)) \
                        and len(tid) == 3 \
                        and isinstance(tid[2], (int, float)) \
                        and not isinstance(tid[2], bool) \
                        and math.isfinite(tid[2]):
                    t0 = float(tid[2])
                    lag = t_apply - t0
                    tracer.observe("replica.propagation_lag", lag)
                    tracer.gauge("replica.propagation_lag_s", lag)
                    clag = t_done - t0
                    tracer.observe("replica.convergence_lag", clag)
                    tracer.gauge("replica.convergence_lag_s", clag)
                if rec.enabled:
                    rec.record(
                        "update.recv", topic=self.topic,
                        replica=self.router.public_key, peer=from_pk,
                        size=len(u), digest=update_digest(u), tid=tid,
                        hop=hop, path=path,
                    )
        for u in updates:
            tracer.count("replica.updates_applied")
            tracer.count("replica.bytes_received", len(u))
        # one WAL batch per merge window (the flush_incoming contract),
        # not one append per update
        self._persist_many(updates)
        for _, m, from_pk in items:
            if m.get("meta") == "sync":
                self._set_synced(True)  # crdt.js:306
                if "state_vector" in m:
                    # second leg of the handshake: ship the syncer
                    # whatever we hold beyond its state vector. Sent
                    # unconditionally — an SV-dominance check would
                    # strand tombstone-only surplus, since delete sets
                    # live outside state vectors (diffs always carry
                    # the full delete set, like Yjs)
                    their_sv = self._decode_peer_sv(
                        m["state_vector"], from_pk
                    )
                    if their_sv is None:
                        continue
                    back = self.doc.encode_state_as_update(their_sv)
                    trace, path = self._trace_fields(
                        back, "sync_answer"
                    )
                    if rec.enabled:
                        rec.record(
                            "sync.answer", topic=self.topic,
                            replica=self.router.public_key,
                            peer=from_pk, size=len(back),
                            digest=update_digest(back),
                            tid=trace["tid"], path=path,
                        )
                    self._to_peer(from_pk, {"update": back, **trace})
                    # the syncer now holds everything we do (see the
                    # ready-branch advance)
                    self.peer_state_vectors[from_pk] = their_sv.merge(
                        self.doc.state_vector()
                    )

    # ------------------------------------------------------------------
    # convenience passthroughs to the document API
    # ------------------------------------------------------------------
    @property
    def c(self):
        return self.doc.c

    def __getattr__(self, prop: str) -> Any:
        doc = self.__dict__.get("doc")
        if doc is not None:
            try:
                return getattr(doc, prop)
            except AttributeError:
                pass
        raise AttributeError(prop)

    def send_message(self, payload: Any) -> None:
        """Broadcast a non-CRDT message to peers (observer passthrough)."""
        self._propagate({"message": payload, "public_key": self.router.public_key})


def ypear_crdt(router, **options) -> Replica:
    """Factory mirroring ``ypearCRDT(router, options)`` (crdt.js:166)."""
    topic = options.pop("topic", None)
    if not topic:
        raise ValueError("options.topic is required")
    return Replica(router, topic, **options)
