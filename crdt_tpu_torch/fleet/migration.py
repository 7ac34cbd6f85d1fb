"""Crash-safe live doc migration between fleet processes.

The port's copy of ``crdt_tpu.fleet.migration``. The destination
rehydrates an adopted doc on its own server's device (the card unless
the server runs on the CPU), into the server's pool when it has one.

The protocol (one doc, source ``src`` -> destination ``dst``, lease
``(e, src)`` -> ``(e+1, dst)``)::

    src                                  dst
    ---  drain in-flight tick window
    ---  [intent blob: step=ship]
    ---  offer {e+1} + snapshot/tail --> rehydrate (NOT serving)
         rehydrated {e+1}            <--
    ---  [intent blob: step=commit]
    ---  grant (e+1, dst) LOCALLY  (src is fenced from here on)
    ---  commit {e+1} + late tail  --> grant (e+1, dst), serve
         ack {e+1}                 <--
    ---  drop doc, clear intent

Crash/partition at ANY step falls down a counted recovery ladder
(``migration.recovery{step=...}``), never into a fork:

- ``drain``/``ship``: nothing granted anywhere — src (or its
  restart, via the intent blob) keeps serving; dst's half-adopted
  state times out waiting for commit and is discarded.
- ``rehydrate`` (dst dies mid-adopt / offer lost): src's
  rehydrated-wait deadline aborts the migration; the tail buffer
  re-ingests and src keeps serving.
- ``commit`` (partition or dst crash after src granted away): src
  is fenced — it can NOT just resume (that is the fork the fence
  exists to prevent). It probes: an answer proving dst serves at
  ``e+1`` completes the handoff (``step=ack``: the ack was lost);
  an explicit NACK from dst proves the commit never landed, and
  ONLY then does src reclaim at ``e+2``. Silence keeps the doc
  fenced (unavailable, never forked) and keeps probing.
- source CRASH: the lease table and a small intent blob are
  persisted in the snapshot store, so the restarted process knows
  a migration was in flight, counts the recovery at the recorded
  step, and re-enters the ladder above instead of blindly serving.

Updates submitted to src during the handoff buffer into the
migration tail and ride the commit frame — an acked update is never
dropped by a successful migration, and an aborted one re-ingests
the buffer. Warm docs ship a snapshot generation
(``storage/snapshot.py``) + the history sidecar; cold docs ship the
admitted WAL tail (their blob history).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from crdt_tpu_torch.obs import get_tracer

from . import wire
from .placement import FencingToken

MIGRATION_STEPS = ("drain", "ship", "rehydrate", "commit", "ack")
INTENT_BLOB = "fleet.migration.intent"

DEFAULT_TIMEOUT_TICKS = 8


def _count(name: str, labels: Optional[Dict[str, str]] = None) -> None:
    tracer = get_tracer()
    if tracer.enabled:
        # crdtlint: emits=migration.started,migration.completed,migration.recovery,migration.tail_blobs,snap.fallbacks
        tracer.count(name, labels=labels)


def adopt_doc(server, doc, snap_payload: bytes,
              hist_blobs: List[bytes]) -> bool:
    """Adopt a shipped doc into ``server`` (the dst half of the
    round-15 promotion path, mirroring ``restore()``'s per-doc
    body): history re-seeded from the shipped blobs, the snapshot
    generation rehydrated warm when present and intact, the
    documented cold rung otherwise. The engine lands on the server's
    device, in its pool when it has one. Returns True when
    resident."""
    from crdt_tpu_torch.models.multidoc import _DocState
    from crdt_tpu_torch.storage.snapshot import decode_payload, rehydrate

    st = server._docs.setdefault(doc, _DocState())
    st.blobs = list(hist_blobs)
    st.pending.clear()
    st.pending_ts.clear()
    st.in_flight = []
    st.in_flight_ts = []
    st.stale = True
    st.no_promote_len = -1
    st._digest = None
    eng = None
    if snap_payload:
        try:
            eng = rehydrate(decode_payload(snap_payload),
                            pool=server.pool, device=server.device)
        except ValueError:
            server.snap_fallback_count += 1
            _count("snap.fallbacks", {"reason": "rehydrate"})
            eng = None
    if eng is None:
        return False
    st.resident = eng
    st.stale = False
    st.cache = {}
    server._adopt_engine(doc)
    return st.resident is not None


def remove_doc(server, doc) -> None:
    """Drop a handed-off doc from the source server (pool extents,
    resident budget, pending-byte odometer all reconciled)."""
    st = server._docs.get(doc)
    if st is None:
        return
    if st.resident is not None:
        server._drop_resident(doc)
    freed = sum(len(b) for b in st.pending) + \
        sum(len(b) for b in st.in_flight)
    server._pending_total = max(0, server._pending_total - freed)
    del server._docs[doc]


class Outbound:
    """Source-side migration record for one doc."""

    __slots__ = ("doc", "dst", "epoch_new", "step", "deadline",
                 "tail", "probe_deadline")

    def __init__(self, doc: str, dst: str, epoch_new: int):
        self.doc = doc
        self.dst = dst
        self.epoch_new = int(epoch_new)
        self.step = "drain"
        self.deadline = 0
        self.probe_deadline = 0
        # updates accepted during the handoff; ride the commit frame
        self.tail: List[bytes] = []


class Inbound:
    """Destination-side record: adopted, awaiting the epoch bump."""

    __slots__ = ("doc", "src", "epoch_new", "deadline")

    def __init__(self, doc: str, src: str, epoch_new: int,
                 deadline: int):
        self.doc = doc
        self.src = src
        self.epoch_new = int(epoch_new)
        self.deadline = deadline


class Migrator:
    """Per-node migration engine. ``node`` provides the seams
    (server, lease table, frame send, snapshot-store blobs); every
    timeout is TICK-indexed — wall clocks never steer recovery, the
    chaos matrix replays bit-for-bit."""

    def __init__(self, node, *, timeout_ticks: int =
                 DEFAULT_TIMEOUT_TICKS, crash_plan=None):
        self.node = node
        self.timeout_ticks = int(timeout_ticks)
        # guard.faults.MigrationCrashPlan (or None): raises
        # SimulatedCrash at scripted step boundaries — the chaos
        # harness's kill-at-step-k lever
        self.crash_plan = crash_plan
        self.outbound: Dict[str, Outbound] = {}
        self.inbound: Dict[str, Inbound] = {}
        # deterministic odometers (tracer rows mirror these)
        self.started = 0
        self.completed = 0
        self.recoveries: Dict[str, int] = {}

    # -- intent persistence (source crash safety) ----------------------

    def _write_intent(self, m: Outbound, step: str) -> None:
        store = self.node.store
        if store is None:
            return
        store.put_blob(INTENT_BLOB, json.dumps({
            "doc": m.doc, "dst": m.dst, "epoch_new": m.epoch_new,
            "step": step,
        }, sort_keys=True).encode())

    def _clear_intent(self) -> None:
        store = self.node.store
        if store is not None:
            store.put_blob(INTENT_BLOB, b"{}")

    def resume_intent(self) -> Optional[str]:
        """Called on node restart: a dangling intent blob means the
        process died mid-migration. Count the recovery at the
        recorded step and re-enter the ladder: pre-commit steps
        resume serving (nothing was granted); a commit-step intent
        re-arms the probe path — the lease table already persisted
        the grant, so the restart stays fenced."""
        store = self.node.store
        if store is None:
            return None
        raw = store.get_blob(INTENT_BLOB)
        if not raw:
            return None
        try:
            intent = json.loads(raw)
        except ValueError:
            intent = {}
        if not intent or "doc" not in intent:
            return None
        step = str(intent.get("step", "ship"))
        self._recover(step)
        if step == "commit":
            m = Outbound(str(intent["doc"]), str(intent["dst"]),
                         int(intent.get("epoch_new", 0)))
            m.step = "wait_ack"
            m.deadline = self.node.tick_count + self.timeout_ticks
            self.outbound[m.doc] = m
            self._send_probe(m)
        else:
            self._clear_intent()
        return step

    def _recover(self, step: str) -> None:
        self.recoveries[step] = self.recoveries.get(step, 0) + 1
        _count("migration.recovery", {"step": step})

    # -- source side ---------------------------------------------------

    def start(self, doc, dst: str) -> bool:
        """Begin migrating ``doc`` to ``dst``. Refused when this
        process does not own the doc or a handoff is already in
        flight (the placement loop's budget/skip logic relies on
        the False)."""
        doc = str(doc)
        node = self.node
        if doc in self.outbound or doc in self.inbound:
            return False
        if not node.lease.holds(doc) or dst == node.proc:
            return False
        m = Outbound(doc, dst, node.lease.epoch_of(doc) + 1)
        self.outbound[doc] = m
        self.started += 1
        _count("migration.started")
        self._write_intent(m, "drain")
        return True

    def buffer_update(self, doc: str, blob: bytes) -> bool:
        """An update for a doc mid-handoff: buffer it into the tail
        (it rides the commit frame) instead of the server. Returns
        True when buffered. Only valid BEFORE the commit frame is
        cut — past that the tail has shipped and the lease has moved,
        so the caller's fence check redirects the update to the new
        owner instead (buffering here would silently drop it)."""
        m = self.outbound.get(str(doc))
        if m is None or m.step not in ("drain", "wait_rehydrated"):
            return False
        m.tail.append(bytes(blob))
        _count("migration.tail_blobs")
        return True

    def migrating(self, doc) -> bool:
        return str(doc) in self.outbound or str(doc) in self.inbound

    def _maybe_crash(self, step: str) -> None:
        if self.crash_plan is not None:
            self.crash_plan.check(step)

    def _ship(self, m: Outbound) -> None:
        """Build + send the offer payload: warm docs ship the
        snapshot generation + history sidecar, cold docs the WAL
        tail (admitted blob history). Pending-but-unconverged blobs
        move into the migration tail so nothing admitted is lost."""
        from crdt_tpu_torch.storage.snapshot import encode_engine

        node = self.node
        st = node.server._docs.get(m.doc)
        mode = "tail"
        snap = b""
        hist: List[bytes] = []
        if st is not None:
            # drain pending into the tail buffer (they were never
            # converged here; dst converges them post-commit)
            while st.pending:
                m.tail.append(st.pending.popleft())
            while st.pending_ts:
                st.pending_ts.popleft()
            freed = sum(len(b) for b in m.tail)
            node.server._pending_total = max(
                0, node.server._pending_total - freed)
            if st.resident is not None:
                try:
                    snap = encode_engine(st.resident,
                                         seq=len(st.blobs))
                    hist = [st.resident.encode_state_as_update()]
                    mode = "snap"
                except ValueError:
                    snap, hist, mode = b"", list(st.blobs), "tail"
            else:
                hist = list(st.blobs)
        self._write_intent(m, "ship")
        self._maybe_crash("ship")
        node.send(m.dst, {
            "kind": "offer", "doc": m.doc, "epoch": m.epoch_new,
            "proc": node.proc, "mode": mode,
        }, wire.pack_blobs([snap] + hist))
        m.step = "wait_rehydrated"
        m.deadline = node.tick_count + self.timeout_ticks

    def _commit(self, m: Outbound) -> None:
        node = self.node
        self._write_intent(m, "commit")
        # the point of no unfenced return: src hands the lease to
        # dst locally FIRST, so even a crash right here leaves src
        # fenced (persisted) rather than forkable
        node.lease.grant(m.doc, m.epoch_new, m.dst)
        self._maybe_crash("commit")
        node.send(m.dst, {
            "kind": "commit", "doc": m.doc, "epoch": m.epoch_new,
            "proc": node.proc,
        }, wire.pack_blobs(list(m.tail)))
        m.step = "wait_ack"
        m.deadline = node.tick_count + self.timeout_ticks

    def _abort(self, m: Outbound, step: str) -> None:
        """Pre-grant abort: re-ingest the tail, keep serving."""
        node = self.node
        self.outbound.pop(m.doc, None)
        self._clear_intent()
        for blob in m.tail:
            node.server.submit(m.doc, blob)
        self._recover(step)

    def _complete(self, m: Outbound) -> None:
        node = self.node
        remove_doc(node.server, m.doc)
        self.outbound.pop(m.doc, None)
        self._clear_intent()
        self.completed += 1
        _count("migration.completed")

    def _send_probe(self, m: Outbound) -> None:
        self.node.send(m.dst, {
            "kind": "probe", "doc": m.doc, "proc": self.node.proc,
        })
        m.probe_deadline = self.node.tick_count + self.timeout_ticks

    def step_tick(self) -> None:
        """Advance every in-flight migration one tick (called from
        ``FleetNode.tick`` AFTER the server tick, so drain sees the
        settled window)."""
        node = self.node
        now = node.tick_count
        for doc in sorted(self.outbound):
            m = self.outbound[doc]
            if m.step == "drain":
                st = node.server._docs.get(doc)
                self._maybe_crash("drain")
                if st is None or not st.in_flight:
                    self._ship(m)
            elif m.step == "wait_rehydrated" and now >= m.deadline:
                # dst died mid-rehydrate or the offer was lost:
                # nothing granted — source keeps serving
                self._abort(m, "rehydrate")
            elif m.step == "wait_ack" and now >= m.deadline:
                if now >= m.probe_deadline:
                    self._send_probe(m)
        for doc in sorted(self.inbound):
            inb = self.inbound[doc]
            if now >= inb.deadline:
                # commit never arrived: discard the half-adopted
                # doc — the lease never moved, src still owns it
                self.inbound.pop(doc, None)
                remove_doc(node.server, doc)
                self._recover("commit")

    # -- frame handlers (both sides) -----------------------------------

    def on_offer(self, header: Dict[str, Any],
                 payload: bytes) -> None:
        node = self.node
        doc = str(header.get("doc", ""))
        epoch_new = int(header.get("epoch", 0))
        src = str(header.get("proc", ""))
        # fence the offer with the CURRENT lease: the proposer must
        # be the owner proposing exactly epoch+1
        cur_e, cur_o = node.lease.lease(doc)
        if src != cur_o or epoch_new != cur_e + 1:
            node.lease.reject(doc, "offer")
            node.send(src, {"kind": "nack", "doc": doc,
                            "epoch": epoch_new, "proc": node.proc})
            return
        blobs = wire.unpack_blobs(payload)
        if blobs is None or not blobs:
            node.send(src, {"kind": "nack", "doc": doc,
                            "epoch": epoch_new, "proc": node.proc})
            return
        self._maybe_crash("rehydrate")
        adopt_doc(node.server, doc, blobs[0], blobs[1:])
        self.inbound[doc] = Inbound(
            doc, src, epoch_new,
            node.tick_count + 2 * self.timeout_ticks)
        node.send(src, {"kind": "rehydrated", "doc": doc,
                        "epoch": epoch_new, "proc": node.proc})

    def on_rehydrated(self, header: Dict[str, Any]) -> None:
        m = self.outbound.get(str(header.get("doc", "")))
        if m is None or m.step != "wait_rehydrated":
            return
        if int(header.get("epoch", 0)) != m.epoch_new or \
                str(header.get("proc", "")) != m.dst:
            return
        self._commit(m)

    def on_commit(self, header: Dict[str, Any],
                  payload: bytes) -> None:
        node = self.node
        doc = str(header.get("doc", ""))
        epoch_new = int(header.get("epoch", 0))
        src = str(header.get("proc", ""))
        inb = self.inbound.get(doc)
        if inb is None:
            # duplicate commit after we already took over: re-ack
            # (idempotent — the first ack may have been lost)
            if node.lease.lease(doc) == (epoch_new, node.proc):
                node.send(src, {"kind": "ack", "doc": doc,
                                "epoch": epoch_new,
                                "proc": node.proc})
            return
        if epoch_new != inb.epoch_new or src != inb.src:
            return
        tail = wire.unpack_blobs(payload)
        self.inbound.pop(doc, None)
        # durability BEFORE the ack: stash the doc's full admitted
        # history (shipped blobs + commit tail) in the store, so a
        # dst crash right after taking ownership restores the doc
        # from the stash instead of losing a committed handoff
        # (FleetNode.restore re-seeds it, counted
        # ``migration.tail_restores``)
        if node.store is not None:
            st = node.server._docs.get(doc)
            hist = list(st.blobs) if st is not None else []
            node.store.put_blob("fleet.tail.%s" % doc,
                                wire.pack_blobs(hist + list(tail or [])))
        node.lease.grant(doc, epoch_new, node.proc)
        for blob in tail or []:
            node.server.submit(doc, blob)
        node.send(src, {"kind": "ack", "doc": doc,
                        "epoch": epoch_new, "proc": node.proc})

    def on_ack(self, header: Dict[str, Any]) -> None:
        m = self.outbound.get(str(header.get("doc", "")))
        if m is None or m.step != "wait_ack":
            return
        if int(header.get("epoch", 0)) != m.epoch_new:
            return
        self._maybe_crash("ack")
        self._complete(m)

    def on_nack(self, header: Dict[str, Any]) -> None:
        doc = str(header.get("doc", ""))
        m = self.outbound.get(doc)
        if m is None:
            return
        node = self.node
        if m.step == "wait_rehydrated":
            self._abort(m, "ship")
            return
        if m.step == "wait_ack":
            # EXPLICIT proof the commit never landed: dst does not
            # hold the migration. Reclaim at epoch_new + 1 — a
            # higher epoch than the failed grant, so any late
            # commit replay at epoch_new is fenced off
            node.lease.grant(m.doc, m.epoch_new + 1, node.proc)
            self.outbound.pop(doc, None)
            self._clear_intent()
            for blob in m.tail:
                node.server.submit(m.doc, blob)
            self._recover("commit")

    def on_probe(self, header: Dict[str, Any]) -> None:
        node = self.node
        doc = str(header.get("doc", ""))
        src = str(header.get("proc", ""))
        e, o = node.lease.lease(doc)
        if o == node.proc and doc not in self.inbound:
            node.send(src, {"kind": "probe_reply", "doc": doc,
                            "epoch": e, "owner": o,
                            "proc": node.proc})
            return
        if doc in self.inbound:
            # a probe means the source's ack wait expired — the
            # NACK below is BINDING ("I have not committed, and now
            # never will"): cancel the inbound so a delayed commit
            # frame can't make this node start serving after the
            # source reclaims (the double-serve window the fence
            # exists to close)
            self.inbound.pop(doc, None)
            remove_doc(node.server, doc)
            self._recover("commit")
        node.send(src, {"kind": "nack", "doc": doc,
                        "epoch": 0, "proc": node.proc})

    def on_probe_reply(self, header: Dict[str, Any]) -> None:
        m = self.outbound.get(str(header.get("doc", "")))
        if m is None or m.step != "wait_ack":
            return
        epoch = int(header.get("epoch", 0))
        owner = str(header.get("owner", ""))
        if owner == m.dst and epoch >= m.epoch_new:
            # dst IS serving — only the ack was lost
            self._complete(m)
            self._recover("ack")
