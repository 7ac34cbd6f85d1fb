"""One fleet process: a ``MultiDocServer`` wrapped in ownership.

The port's copy of ``crdt_tpu.fleet.node``. A node builds its server
on ``device`` (the card unless the caller asks for the CPU), and
refuses a passed ``server=`` that lives on another device.

``FleetNode`` is the glue object the chaos harness and the
subprocess smoke leg both drive: ring + lease table + migrator
around one server, every doc-state operation passing the fencing
gate first. The transport is a seam (``fabric``): the in-process
harness uses :class:`crdt_tpu_torch.fleet.fabric.MemFabric`, the smoke
leg adapts the round-7 sealed ``UdpEndpoint`` — frames are
identical bytes either way (``fleet/wire.py``).

Ownership semantics:

- ``submit`` admits only docs this process owns; a mis-routed
  submit answers with the believed owner (``fleet.redirects``) so
  clients re-aim instead of forking.
- ``digest``/serving refuse docs the process does not own
  (``fleet.fence_rejects{op=serve}``) — the no-double-serve half of
  the fork guard.
- every ``beacon_every`` ticks the node broadcasts its owned docs'
  epochs (the round-8 sentinel idea applied to ownership): a
  receiver holding a STALE lease adopts the newer epoch and demotes
  itself (``fleet.demotions`` — the partitioned ex-owner healing
  path), an equal-epoch rival claim is refused as a fork
  (``fleet.fork_refused``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from crdt_tpu_torch.models.multidoc import MultiDocServer
from crdt_tpu_torch.obs import get_tracer
from crdt_tpu_torch.ops.device import resolve_device

from . import wire
from .migration import Migrator, remove_doc
from .placement import FencingToken, HashRing, LeaseTable


class FleetNode:
    def __init__(self, proc: str, members, fabric, *,
                 store=None,
                 vnodes: int = 64,
                 timeout_ticks: int = 8,
                 beacon_every: int = 4,
                 crash_plan=None,
                 server: Optional[MultiDocServer] = None,
                 server_kw: Optional[Dict[str, Any]] = None,
                 device="cuda"):
        self.proc = str(proc)
        self.device = resolve_device(device)
        self.fabric = fabric
        self.store = store
        self.ring = HashRing(members, vnodes=vnodes)
        self.lease = LeaseTable(self.proc, self.ring, store=store)
        if server is None:
            kw = dict(server_kw or {})
            kw.setdefault("snap_store", store)
            kw.setdefault("device", self.device)
            server = MultiDocServer(**kw)
        if server.device != self.device:
            raise ValueError(
                f"FleetNode({self.proc!r}, device={str(self.device)!r}) "
                f"has a server on {str(server.device)!r}")
        self.server = server
        self.migrator = Migrator(self, timeout_ticks=timeout_ticks,
                                 crash_plan=crash_plan)
        self.tick_count = 0
        self.beacon_every = int(beacon_every)
        # deterministic odometers (tracer rows mirror these)
        self.redirects = 0
        self.demotions = 0
        if fabric is not None:
            fabric.register(self.proc, self)

    # -- transport -----------------------------------------------------

    def send(self, dst: str, header: Dict[str, Any],
             payload: bytes = b"") -> None:
        self.fabric.send(self.proc, dst,
                         wire.encode_frame(header, payload))

    def drain_inbox(self) -> int:
        n = 0
        for src, data in self.fabric.deliver(self.proc):
            self.handle(src, data)
            n += 1
        return n

    def handle(self, src: str, data: bytes) -> None:
        dec = wire.decode_frame(data)
        if dec is None:
            return
        header, payload = dec
        kind = header.get("kind")
        mig = self.migrator
        if kind == "update":
            self._on_update(header, payload)
        elif kind == "redirect":
            self._on_redirect(header)
        elif kind == "beacon":
            self._on_beacon(header)
        elif kind == "offer":
            mig.on_offer(header, payload)
        elif kind == "rehydrated":
            mig.on_rehydrated(header)
        elif kind == "commit":
            mig.on_commit(header, payload)
        elif kind == "ack":
            mig.on_ack(header)
        elif kind == "nack":
            mig.on_nack(header)
        elif kind == "probe":
            mig.on_probe(header)
        elif kind == "probe_reply":
            mig.on_probe_reply(header)

    # -- the tick loop -------------------------------------------------

    def tick(self):
        """One fleet tick: settle inbound frames, run the server
        tick, advance migrations, emit ownership beacons."""
        self.drain_inbox()
        rep = self.server.tick()
        self.tick_count += 1
        self.migrator.step_tick()
        if self.beacon_every and \
                self.tick_count % self.beacon_every == 0:
            self._emit_beacons()
        return rep

    # -- client ingest (fenced) ----------------------------------------

    def submit(self, doc, blob: bytes) -> Tuple[str, Any]:
        """Admit one client update. Returns ``("ok", shed)`` when
        this process owns the doc, ``("buffered", None)`` when the
        doc is mid-handoff (the blob rides the commit frame), or
        ``("redirect", owner)`` so the client re-aims."""
        d = str(doc)
        if self.migrator.buffer_update(d, blob):
            return ("buffered", None)
        if not self.lease.holds(d):
            self.redirects += 1
            tracer = get_tracer()
            if tracer.enabled:
                tracer.count("fleet.redirects")
            return ("redirect", self.lease.owner_of(d))
        return ("ok", self.server.submit(d, blob))

    def forward(self, doc, blob: bytes) -> None:
        """Inter-node route: ship the update to the believed owner,
        stamped with this node's lease view — the receiver's fence
        corrects a stale view via redirect."""
        d = str(doc)
        e, o = self.lease.lease(d)
        self.send(o, {"kind": "update", "doc": d, "epoch": e,
                      "proc": self.proc}, bytes(blob))

    def _on_update(self, header: Dict[str, Any],
                   payload: bytes) -> None:
        d = str(header.get("doc", ""))
        src = str(header.get("proc", ""))
        if self.migrator.buffer_update(d, payload):
            return
        if not self.lease.holds(d):
            self.lease.reject(d, "update")
            e, o = self.lease.lease(d)
            self.send(src, {"kind": "redirect", "doc": d,
                            "epoch": e, "owner": o,
                            "proc": self.proc})
            return
        self.server.submit(d, payload)

    def _on_redirect(self, header: Dict[str, Any]) -> None:
        d = str(header.get("doc", ""))
        e = int(header.get("epoch", 0))
        o = str(header.get("owner", ""))
        if e >= self.lease.epoch_of(d):
            self.lease.grant(d, e, o)

    # -- serving (fenced) ----------------------------------------------

    def digest(self, doc) -> Optional[str]:
        """Serve the doc's canonical digest — refused (and counted)
        when this process does not own it: the half of the fork
        guard a stale ex-owner hits first."""
        d = str(doc)
        if not self.lease.holds(d) or self.migrator.migrating(d):
            self.lease.reject(d, "serve")
            return None
        return self.server.digest(d)

    # -- ownership beacons (the sentinel seam) -------------------------

    def _emit_beacons(self) -> None:
        owned = {d: self.lease.epoch_of(d)
                 for d in sorted(self.server._docs, key=str)
                 if self.lease.holds(d)}
        if not owned:
            return
        tracer = get_tracer()
        for peer in self.ring.members:
            if peer == self.proc:
                continue
            self.send(peer, {"kind": "beacon", "proc": self.proc,
                             "docs": owned})
            if tracer.enabled:
                tracer.count("fleet.beacons_sent")

    def _on_beacon(self, header: Dict[str, Any]) -> None:
        sender = str(header.get("proc", ""))
        docs = header.get("docs")
        if not isinstance(docs, dict):
            return
        for d in sorted(docs, key=str):
            try:
                e = int(docs[d])
            except (TypeError, ValueError):
                continue
            was_mine = self.lease.holds(d)
            # admit() does the whole ladder: stale claim refused +
            # counted, equal-epoch rival refused as a fork, newer
            # epoch adopted
            if self.lease.admit(str(d), FencingToken(e, sender),
                                op="beacon") and was_mine and \
                    not self.lease.holds(d):
                # we were the partitioned ex-owner: demote — stop
                # serving and drop the stale copy (the new owner
                # carries the doc now)
                self.demotions += 1
                tracer = get_tracer()
                if tracer.enabled:
                    tracer.count("fleet.demotions")
                self.migrator.outbound.pop(str(d), None)
                remove_doc(self.server, str(d))

    # -- migration entry + durability ----------------------------------

    def migrate(self, doc, dst: str) -> bool:
        return self.migrator.start(doc, dst)

    def checkpoint(self) -> int:
        return self.server.checkpoint(fence=self.lease)

    def restore(self) -> int:
        """Warm restart: rehydrate the server (fence-checked),
        re-seed any doc this process owns by granted lease but the
        checkpoint missed (a handoff committed after the last
        cadence: the commit path stashed its full history), and
        resume any migration the crashed process left in flight."""
        n = self.server.restore(fence=self.lease)
        tracer = get_tracer()
        for d in sorted(self.lease.recorded()):
            _e, o = self.lease.recorded()[d]
            if o != self.proc or d in self.server._docs:
                continue
            raw = self.store.get_blob("fleet.tail.%s" % d) \
                if self.store is not None else None
            blobs = wire.unpack_blobs(raw) if raw else None
            if not blobs:
                continue
            for b in blobs:
                self.server.submit(d, b)
            if tracer.enabled:
                tracer.count("migration.tail_restores")
        self.migrator.resume_intent()
        return n

    # -- load report (the placement loop's tie-breaker) ----------------

    def load(self) -> float:
        return float(self.server.pending_bytes() +
                     self.server.resident_bytes_total())
