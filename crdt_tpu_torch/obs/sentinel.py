"""Divergence sentinel: snapshot-hash beacons over anti-entropy.

The port's copy of ``crdt_tpu.obs.sentinel``; a beacon's digests are
the reference's, so port and reference replicas check each other.

CRDT convergence failures are the worst kind of bug: two replicas
whose state vectors agree (every op delivered) but whose STATES
differ (a merge-order bug, a corrupted store, a byzantine peer) look
perfectly healthy to the sync protocol — nothing retries, nothing
repairs, the fork is silent and permanent. The sentinel turns that
into an observable event:

- each replica periodically broadcasts a **beacon** riding the
  anti-entropy cadence: its state vector, a digest of its canonical
  state snapshot (``encode_state_as_update()`` — byte-identical
  across converged replicas), and a digest of its delete set;
- a receiver whose state vector EQUALS the sender's compares digests:
  equal SVs + equal delete sets + different snapshot digests is, by
  CRDT determinism, impossible for honest replicas — the sentinel
  raises a divergence event carrying a flight-recorder dump for the
  postmortem. Unequal SVs (or delete-set digests: tombstones ride
  outside state vectors, so a delete-only update in flight is lag,
  not divergence) are ordinary propagation lag and stay silent.

The check is sound, not complete: a fork confined to tombstones alone
hides behind the delete-set guard until a record lands on either
side. That trade keeps the sentinel silent across every honest
transient the sync protocol produces.
"""

from __future__ import annotations

import hashlib
from typing import Any, Callable, Dict, List, Optional

from crdt_tpu_torch.obs.recorder import FlightRecorder, get_recorder
from crdt_tpu_torch.obs.tracer import Tracer, get_tracer


def state_digest(doc) -> str:
    """Digest of the doc's canonical full-state snapshot. Converged
    replicas encode byte-identical snapshots (pinned invariant), so
    equal states <=> equal digests."""
    return hashlib.sha1(doc.encode_state_as_update()).hexdigest()[:16]


def delete_set_digest(doc) -> str:
    """Digest of the doc's normalized delete-set ranges (tombstones
    live OUTSIDE state vectors; the sentinel must not call a
    tombstone-only deficit a fork)."""
    ds = doc.engine.delete_set()
    h = hashlib.sha1()
    for c, s, n in ds.iter_all():
        h.update(f"{c}:{s}:{n};".encode())
    return h.hexdigest()[:16]


class DivergenceSentinel:
    """Per-replica sentinel state: builds outgoing beacons, checks
    incoming ones, raises divergence events."""

    def __init__(
        self,
        doc,
        *,
        topic: str,
        replica: str,
        tracer: Optional[Tracer] = None,
        recorder: Optional[FlightRecorder] = None,
        on_divergence: Optional[Callable[[Dict[str, Any]], None]] = None,
    ):
        self.doc = doc
        self.topic = topic
        self.replica = replica
        self._tracer = tracer
        self._recorder = recorder
        self.on_divergence = on_divergence
        self.events: List[Dict[str, Any]] = []
        self.max_events = 64  # bounded: divergence is permanent, so
                              # an un-deduped fork would grow forever
        self.beacons_sent = 0
        self.beacons_checked = 0
        # digest cache keyed by (sv bytes, ds digest): same SV + same
        # delete set => same state for THIS doc, so a quiescent mesh
        # pays one full-state encode per change, not per beacon
        self._digest_cache: Optional[tuple] = None
        # (peer, local, remote) triples already raised: a permanent
        # fork must not re-event (and re-dump) on every later beacon
        self._raised: set = set()

    # injected globals resolve per call so set_tracer/set_recorder
    # installed after replica construction still take effect
    @property
    def tracer(self) -> Tracer:
        return self._tracer if self._tracer is not None else get_tracer()

    @property
    def recorder(self) -> FlightRecorder:
        return (
            self._recorder if self._recorder is not None
            else get_recorder()
        )

    def _digests(self) -> tuple:
        """(state digest, ds digest), cached until the doc's state
        vector or delete set changes (both cheap to key on)."""
        sv_key = self.doc.encode_state_vector()
        ds_d = delete_set_digest(self.doc)
        cached = self._digest_cache
        if cached is not None and cached[0] == sv_key \
                and cached[1] == ds_d:
            return cached[2], ds_d
        st = state_digest(self.doc)
        self._digest_cache = (sv_key, ds_d, st)
        return st, ds_d

    def beacon_payload(self) -> Dict[str, Any]:
        """The broadcastable beacon body (caller adds transport
        framing: meta/public_key/state_vector)."""
        self.beacons_sent += 1
        self.tracer.count("sentinel.beacons_sent")
        st, ds_d = self._digests()
        payload = {"digest": st, "ds_digest": ds_d}
        self.recorder.record(
            "beacon.send", topic=self.topic, replica=self.replica,
            digest=st,
        )
        return payload

    def check(self, from_pk: str, peer_sv, digest: str,
              ds_digest: str) -> Optional[Dict[str, Any]]:
        """Compare a received beacon against local state. Returns the
        divergence event when one fires, else None (silent)."""
        self.beacons_checked += 1
        tracer = self.tracer
        tracer.count("sentinel.beacons_checked")
        mine_sv = self.doc.state_vector()
        if peer_sv != mine_sv:
            # ordinary lag: ops still in flight
            tracer.count("sentinel.sv_lag")
            return None
        my_digest, my_ds = self._digests()
        if ds_digest != my_ds:
            # tombstone-only deficit in flight (delete sets ride
            # outside SVs); anti-entropy repairs it — not a fork
            tracer.count("sentinel.ds_lag")
            return None
        if digest == my_digest:
            tracer.count("sentinel.agree")
            return None
        # equal SVs, equal delete sets, different state: silent
        # divergence. Raise loudly, with the evidence attached —
        # ONCE per (peer, fork): divergence is permanent, so later
        # beacons of the same fork only bump the counter
        tracer.count("sentinel.divergence")
        fork_key = (from_pk, my_digest, digest)
        if fork_key in self._raised:
            return None
        self._raised.add(fork_key)
        recorder = self.recorder
        event = {
            "kind": "divergence",
            "topic": self.topic,
            "replica": self.replica,
            "peer": from_pk,
            "local_digest": my_digest,
            "peer_digest": digest,
            "state_vector": {
                int(c): int(k) for c, k in mine_sv.clocks.items()
            },
            "flight_recorder": recorder.dump_jsonl(),
        }
        recorder.record(
            "divergence", topic=self.topic, replica=self.replica,
            peer=from_pk, local_digest=my_digest, peer_digest=digest,
        )
        if len(self.events) < self.max_events:
            self.events.append(event)
        if self.on_divergence is not None:
            self.on_divergence(event)
        return event


class MultiDocSentinel:
    """Divergence sentinel for multi-doc serving: beacons
    carry PER-DOC digests, so a fork is attributed to the one doc
    that diverged — on a server converging thousands of tenants in
    one dispatch, "some doc forked" is not actionable, "doc X
    forked" is.

    ``source`` is anything with a ``doc_digests()`` returning
    ``{doc_id: {"digest": str, "ops": int}}`` (the reference's
    ``MultiDocServer.doc_digests``; the port's multi-doc server is
    ROADMAP queue A item 6).
    The op count is the lag guard standing in for the single-doc
    sentinel's state-vector equality: unequal counts mean one side
    has not admitted the other's ops yet — propagation lag, silent
    (``sentinel.doc_lag``). Equal counts with unequal digests is a
    fork in THAT doc: one ``sentinel.doc_divergence`` count and one
    event naming the doc, deduped per (peer, doc, digest pair) like
    the single-doc sentinel's permanent-fork rule. Docs only the
    peer serves are skipped (placement, not health)."""

    def __init__(self, source, *, topic: str, replica: str,
                 tracer: Optional[Tracer] = None,
                 recorder: Optional[FlightRecorder] = None,
                 on_divergence: Optional[
                     Callable[[Dict[str, Any]], None]] = None):
        self.source = source
        self.topic = topic
        self.replica = replica
        self._tracer = tracer
        self._recorder = recorder
        self.on_divergence = on_divergence
        self.events: List[Dict[str, Any]] = []
        self.max_events = 64
        self._raised: set = set()

    @property
    def tracer(self) -> Tracer:
        return self._tracer if self._tracer is not None else get_tracer()

    @property
    def recorder(self) -> FlightRecorder:
        return (
            self._recorder if self._recorder is not None
            else get_recorder()
        )

    def beacon_payload(self) -> Dict[str, Any]:
        """The broadcastable multi-doc beacon body."""
        self.tracer.count("sentinel.beacons_sent")
        docs = self.source.doc_digests()
        self.recorder.record(
            "beacon.send", topic=self.topic, replica=self.replica,
            size=len(docs),
        )
        return {"docs": docs}

    def check(self, from_pk: str,
              payload: Dict[str, Any]) -> List[Dict[str, Any]]:
        """Compare a received multi-doc beacon doc by doc. Returns
        the divergence events that fired (possibly empty)."""
        tracer = self.tracer
        tracer.count("sentinel.beacons_checked")
        mine = self.source.doc_digests()
        fired: List[Dict[str, Any]] = []
        for doc_id, theirs in (payload.get("docs") or {}).items():
            ours = mine.get(doc_id)
            if ours is None:
                continue  # not served here: placement, not health
            if ours["ops"] != theirs.get("ops"):
                tracer.count("sentinel.doc_lag")
                continue
            if ours["digest"] == theirs.get("digest"):
                tracer.count("sentinel.agree")
                continue
            tracer.count("sentinel.doc_divergence")
            fork_key = (from_pk, doc_id, ours["digest"],
                        theirs.get("digest"))
            if fork_key in self._raised:
                continue
            self._raised.add(fork_key)
            event = {
                "kind": "divergence",
                "topic": self.topic,
                "replica": self.replica,
                "peer": from_pk,
                "doc": doc_id,
                "local_digest": ours["digest"],
                "peer_digest": theirs.get("digest"),
                "flight_recorder": self.recorder.dump_jsonl(),
            }
            self.recorder.record(
                "divergence", topic=self.topic, replica=self.replica,
                peer=from_pk, local_digest=ours["digest"],
                peer_digest=theirs.get("digest"),
            )
            if len(self.events) < self.max_events:
                self.events.append(event)
            if self.on_divergence is not None:
                self.on_divergence(event)
            fired.append(event)
        return fired
