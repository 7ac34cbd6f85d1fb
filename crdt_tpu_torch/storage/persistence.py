"""Durable update log with the reference's keyspace semantics.

The port's copy of ``crdt_tpu.storage.persistence``, over the port's
own build of the native kvlog store (:mod:`crdt_tpu_torch.storage.kv`);
the keys and values on disk are the reference's, so a log written by
either package opens in the other. It mirrors `CRDTPersistence`
(crdt.js:5-141) over the native kvlog store instead of LevelDB:

  doc_<name>_update_<seq>  append-only update log   (crdt.js:41-42,61)
  doc_<name>_sv            latest state vector      (crdt.js:62)
  doc_<name>_meta          JSON {last_updated,size} (crdt.js:63-70)

All three written in one atomic batch per update, like the reference's
3-key LevelDB batch (crdt.js:60-71). Documented fixes (SURVEY.md §6):

- D5: the stored state vector is the caller's *accumulated* vector —
  the reference recomputes it by diffing an empty doc and stores
  garbage (crdt.js:54-59).
- D6: log keys are zero-padded monotonic sequence numbers, not
  `Date.now()` — two updates in the same millisecond no longer
  overwrite each other (crdt.js:41-42).
- Q3: `compact()` exists — squashes the log to a single snapshot
  update so startup replay is O(state), not O(history). The reference
  replays its entire unbounded log (crdt.js:79-98).

Updates are validated by decoding before hitting the log (the
reference applies each update to a throwaway Y.Doc for the same
purpose, crdt.js:33-40).
"""

from __future__ import annotations

import json
import time
from typing import List, Optional

from crdt_tpu_torch.guard.faults import retry_with_backoff
from crdt_tpu_torch.obs.tracer import get_tracer
from crdt_tpu_torch.storage.kv import Batch, KvLog


def _esc(doc: str) -> str:
    # doc names are caller-chosen: a raw name containing "_update_"
    # would collide with another doc's log prefix (e.g. doc "a" vs doc
    # "a_update_0"). Percent-escape "_" so the literal separators below
    # are the only underscores in any key.
    return doc.replace("%", "%25").replace("_", "%5f")


def _update_key(doc: str, seq: int) -> bytes:
    # 20 digits: lexicographic order == numeric order for any int64
    return f"doc_{_esc(doc)}_update_{seq:020d}".encode()


def _update_prefix(doc: str) -> bytes:
    return f"doc_{_esc(doc)}_update_".encode()


def _sv_key(doc: str) -> bytes:
    return f"doc_{_esc(doc)}_sv".encode()


def _meta_key(doc: str) -> bytes:
    return f"doc_{_esc(doc)}_meta".encode()


# Process-wide degraded registry: the ``persist.degraded`` gauge counts
# currently-degraded (store, doc) windows across EVERY LogPersistence
# in the process (they share one tracer), so one store's recovery can
# never mask another store's still-active degradation. 0 = all clear.
_DEGRADED: set = set()


def _set_degraded(store, doc_name: str, on: bool) -> None:
    key = (id(store), doc_name)
    if on:
        _DEGRADED.add(key)
    else:
        _DEGRADED.discard(key)
    get_tracer().gauge("persist.degraded", len(_DEGRADED))


class LogPersistence:
    """Drop-in for :class:`crdt_tpu_torch.net.replica.MemoryPersistence`,
    backed by the native store. One kvlog file may hold many docs (the
    reference opens one LevelDB per path; the keyspace is already
    doc-prefixed so sharing is safe and cheaper).

    Failure policy: a failed KV batch retries with
    backoff (``retries`` x ``retry_backoff_s``, ``persist.retries``
    counter), then — under the default ``failure_policy="degrade"`` —
    the window lands in a BOUNDED in-memory overflow buffer
    (``overflow_max_bytes``, enforced across every doc the store
    buffers; the ``persist.degraded`` gauge counts currently-degraded
    (store, doc) windows process-wide, 0 = all clear) instead of
    raising into the apply path. The buffer drains into the
    next successful write (one batch, followed by ``sync()``;
    ``persist.recovered_updates``), and reads (``get_all_updates`` /
    ``get_state_vector``) see buffered state meanwhile, so replicas
    syncing FROM persistence never observe the outage. Past the bound
    the OLDEST buffered updates drop (``persist.dropped_updates`` —
    visible, bounded, and only lossy if the process dies while the
    disk is still down). ``failure_policy="raise"`` restores the
    historical propagate-everything behavior.

    ``kv_wrapper`` is the fault-injection seam: a callable applied to
    every freshly opened :class:`KvLog` (e.g. ``lambda kv:
    FaultyKv(kv, schedule)`` — :mod:`crdt_tpu_torch.guard.faults`), so
    seeded ENOSPC/EIO/torn-batch/crash schedules survive close/open
    cycles."""

    def __init__(self, path: str, *, validate: bool = True,
                 retries: int = 2, retry_backoff_s: float = 0.01,
                 failure_policy: str = "degrade",
                 overflow_max_bytes: int = 4 << 20,
                 kv_wrapper=None):
        if failure_policy not in ("degrade", "raise"):
            raise ValueError(f"unknown failure_policy {failure_policy!r}")
        self.path = str(path)
        self.validate = validate
        self.retries = retries
        self.retry_backoff_s = retry_backoff_s
        self.failure_policy = failure_policy
        self.overflow_max_bytes = overflow_max_bytes
        self._kv_wrapper = kv_wrapper
        self._kv: Optional[KvLog] = None
        self._next_seq: dict = {}
        self._overflow: dict = {}      # doc -> [update bytes]
        self._overflow_sv: dict = {}   # doc -> latest sv bytes
        self._overflow_bytes = 0
        self._kv = self._make_kv()

    def _make_kv(self):
        kv = KvLog(self.path)
        return self._kv_wrapper(kv) if self._kv_wrapper else kv

    # -- lifecycle ---------------------------------------------------------
    @property
    def closed(self) -> bool:
        return self._kv is None

    def open(self) -> None:
        if self._kv is None:
            self._kv = self._make_kv()
            # _next_seq is derived from the log scan on every open:
            # a cached value can be stale after a crashed compact
            # (see _seq_for/compact)
            self._next_seq.clear()

    def close(self) -> None:
        if self._kv is not None:
            # best-effort write-back of degraded-mode buffers: the
            # process is exiting, so a still-failing disk drops them
            # (counted — the honest semantics of degraded mode)
            for doc in list(self._overflow):
                try:
                    self._flush_overflow(doc)
                except OSError:
                    lost = self._overflow.pop(doc, [])
                    self._overflow_sv.pop(doc, None)
                    _set_degraded(self, doc, False)
                    get_tracer().count(
                        "persist.dropped_updates", len(lost)
                    )
            self._overflow_bytes = 0
            try:
                self._kv.sync()
            except OSError:
                pass  # nothing more to do on a dead disk at close
            self._kv.close()
            self._kv = None

    def __del__(self):
        # a degraded store dropped without close() must not pin the
        # process-wide gauge forever (and its registry keys embed
        # id(self), which the allocator may reuse after this dealloc)
        try:
            for key in [k for k in _DEGRADED if k[0] == id(self)]:
                _set_degraded(self, key[1], False)
        except Exception:
            pass  # interpreter shutdown: globals may already be gone

    def _require(self) -> KvLog:
        if self._kv is None:
            raise RuntimeError("persistence is closed")
        return self._kv

    def _seq_for(self, doc: str) -> int:
        seq = self._next_seq.get(doc)
        if seq is None:
            # resume after the highest logged sequence (scan once)
            seq = 0
            last = None
            for k, _ in self._require().scan_prefix(_update_prefix(doc)):
                last = k
            if last is not None:
                seq = int(last.rsplit(b"_", 1)[1]) + 1
        self._next_seq[doc] = seq + 1
        return seq

    # -- the CRDTPersistence surface --------------------------------------
    def store_update(self, doc_name: str, update: bytes, sv: Optional[bytes] = None) -> None:
        self.store_updates(doc_name, [update], sv=sv)

    def store_updates(self, doc_name: str, updates: List[bytes],
                      sv: Optional[bytes] = None) -> None:
        """Append a WINDOW of updates as ONE atomic KV batch — N log
        keys, one state vector, one meta write, one fsync-able log
        append. This is the batched-incoming path's WAL shape
        (``Replica.flush_incoming`` applies a whole inbox as one merge
        transaction; before this, each update still paid its own
        3-key batch + meta read-modify-write). Counters distinguish
        units from windows: ``persist.appends`` counts updates,
        ``persist.batches`` counts KV batches."""
        # materialize FIRST: a generator argument must survive the
        # validation pass (iterating it twice would silently store
        # nothing while still advancing the SV)
        updates = list(updates)
        for u in updates:
            if not isinstance(u, (bytes, bytearray)):
                raise TypeError("update must be bytes")  # crdt.js:29-31
        updates = [bytes(u) for u in updates]
        if not updates and not self._overflow.get(doc_name):
            return
        if self.validate:
            from crdt_tpu_torch.codec import v1

            for u in updates:
                v1.decode_update(u)  # raises on malformed input
        self._require()
        tracer = get_tracer()
        # drain any degraded-mode buffer FIRST (same batch): recovery
        # is automatic on the first write the disk accepts
        drain = self._overflow.pop(doc_name, [])
        if drain:
            self._overflow_bytes -= sum(map(len, drain))
            if sv is None:
                sv = self._overflow_sv.get(doc_name)
        window = drain + updates
        with tracer.span("persist"):
            try:
                self._write_with_retry(doc_name, window, sv)
            except OSError:
                if self.failure_policy == "raise":
                    # restore the drained buffer: raising must not
                    # silently discard previously accepted updates
                    if drain:
                        self._overflow[doc_name] = (
                            drain + self._overflow.get(doc_name, [])
                        )
                        self._overflow_bytes += sum(map(len, drain))
                    raise
                self._degrade(doc_name, window, sv)
                return
        if drain:
            # recovered: the buffered window is durable — make it so
            # on disk too before declaring the degradation over
            self._require().sync()
            self._overflow_sv.pop(doc_name, None)
            tracer.count("persist.recovered_updates", len(drain))
        _set_degraded(self, doc_name, False)
        tracer.count("persist.appends", len(window))
        tracer.count("persist.batches")
        tracer.count("persist.bytes_appended", sum(map(len, window)))

    def _write_batch(self, doc_name: str, updates: List[bytes],
                     sv: Optional[bytes]) -> None:
        kv = self._require()
        batch = Batch()
        for u in updates:
            batch.put(_update_key(doc_name, self._seq_for(doc_name)), u)
        if sv is not None:
            batch.put(_sv_key(doc_name), bytes(sv))
        meta = self.get_meta(doc_name) or {"size": 0, "count": 0}
        batch.put(
            _meta_key(doc_name),
            json.dumps(
                {
                    "last_updated": time.time(),
                    "size": meta["size"] + sum(map(len, updates)),
                    "count": meta["count"] + len(updates),
                }
            ).encode(),
        )
        kv.write(batch)

    def _write_with_retry(self, doc_name: str, updates: List[bytes],
                          sv: Optional[bytes]) -> None:
        """One window write with bounded-backoff retries. On any
        failure the cached ``_next_seq`` is invalidated so the next
        attempt re-derives it from the log scan — a torn batch on a
        non-atomic store may have landed a prefix of the keys."""
        def attempt():
            try:
                self._write_batch(doc_name, updates, sv)
            except OSError:
                self._next_seq.pop(doc_name, None)
                raise

        retry_with_backoff(
            attempt, retries=self.retries,
            backoff_s=self.retry_backoff_s, counter="persist.retries",
        )

    def _degrade(self, doc_name: str, updates: List[bytes],
                 sv: Optional[bytes]) -> None:
        """Disk still failing after retries: buffer the window in RAM
        (bounded — oldest drop past ``overflow_max_bytes``), flip the
        ``persist.degraded`` gauge, and let the next successful write
        (or ``flush_degraded``) drain it back."""
        tracer = get_tracer()
        buf = self._overflow.setdefault(doc_name, [])
        buf.extend(updates)
        self._overflow_bytes += sum(map(len, updates))
        if sv is not None:
            self._overflow_sv[doc_name] = bytes(sv)
        _set_degraded(self, doc_name, True)
        # the bound is GLOBAL across every doc this store buffers:
        # drop the oldest update of the largest buffered doc, always
        # keeping the newest update of the window degrading right now
        # (a single over-budget update must still make progress)
        sizes = {d: sum(map(len, b)) for d, b in self._overflow.items()}
        dropped_n = 0
        while self._overflow_bytes > self.overflow_max_bytes:
            victim = max(
                (d for d in self._overflow
                 if d != doc_name or len(self._overflow[d]) > 1),
                key=lambda d: sizes[d], default=None,
            )
            if victim is None:
                break  # only the current window's newest remains
            vbuf = self._overflow[victim]
            dropped = vbuf.pop(0)
            self._overflow_bytes -= len(dropped)
            sizes[victim] -= len(dropped)
            dropped_n += 1
            if not vbuf:
                del self._overflow[victim]
                del sizes[victim]
                self._overflow_sv.pop(victim, None)
                _set_degraded(self, victim, False)
        if dropped_n:
            tracer.count("persist.dropped_updates", dropped_n)
        tracer.count("persist.degraded_writes")
        tracer.gauge("persist.overflow_bytes", self._overflow_bytes)

    def flush_degraded(self) -> bool:
        """Explicitly retry the degraded-mode write-back for every
        buffered doc (the drain also rides every ordinary write).
        Returns True when no buffer remains."""
        for doc in list(self._overflow):
            try:
                self._flush_overflow(doc)
            except OSError:
                return False
        return not self._overflow

    def _flush_overflow(self, doc_name: str) -> None:
        drain = self._overflow.pop(doc_name, [])
        if not drain:
            return
        self._overflow_bytes -= sum(map(len, drain))
        try:
            self._write_with_retry(
                doc_name, drain, self._overflow_sv.get(doc_name)
            )
        except OSError:
            self._overflow[doc_name] = (
                drain + self._overflow.get(doc_name, [])
            )
            self._overflow_bytes += sum(map(len, drain))
            raise
        self._require().sync()
        self._overflow_sv.pop(doc_name, None)
        tracer = get_tracer()
        tracer.count("persist.recovered_updates", len(drain))
        _set_degraded(self, doc_name, False)

    def get_all_updates(self, doc_name: str) -> List[bytes]:
        # degraded-mode buffers append after the log: readers (replica
        # restarts-within-process, peers syncing from persistence) see
        # accepted updates whether or not the disk took them yet
        logged = [
            v for _, v in self._require().scan_prefix(_update_prefix(doc_name))
        ]
        return logged + list(self._overflow.get(doc_name, []))

    def get_updates_since(self, doc_name: str, seq: int) -> List[bytes]:
        """The WAL tail a snapshot at coverage ``seq`` still needs:
        logged updates with sequence number STRICTLY greater than
        ``seq`` (the snapshot rider lands at the compaction blob's
        own seq, so the blob is never replayed on top of itself),
        plus any degraded-mode overflow (accepted but not yet on
        disk — always newer than any durable snapshot)."""
        tail = [
            v for k, v in
            self._require().scan_prefix(_update_prefix(doc_name))
            if int(k.rsplit(b"_", 1)[1]) > seq
        ]
        return tail + list(self._overflow.get(doc_name, []))

    def get_state_vector(self, doc_name: str) -> Optional[bytes]:
        ov = self._overflow_sv.get(doc_name)
        if ov is not None and self._overflow.get(doc_name):
            return ov
        return self._require().get(_sv_key(doc_name))

    def get_meta(self, doc_name: str) -> Optional[dict]:
        raw = self._require().get(_meta_key(doc_name))
        return json.loads(raw) if raw is not None else None

    def compact(self, doc_name: str, snapshot: bytes, sv: Optional[bytes] = None) -> None:
        """Replace the doc's update log with one snapshot update, then
        drop dead log history from disk.

        Crash-safe at every intermediate write, even on a store WITHOUT
        atomic batches (the torn-batch adversary in
        :mod:`crdt_tpu_torch.guard.faults`): the snapshot is PUT at a fresh
        sequence number BEFORE the old log keys are deleted, so any
        prefix of the batch leaves either the full old log, old log +
        snapshot (idempotent replay), or a partial old log + snapshot
        (the snapshot dominates) — never an empty log. The native
        store's batch is atomic anyway; the ordering is the defense in
        depth the crash-point matrix pins. A compaction failure
        degrades (the un-compacted log is perfectly valid; retried at
        the next threshold crossing) and invalidates the cached
        ``_next_seq`` so sequence numbers re-derive from the log scan
        — a stale cache after a torn compact could otherwise overwrite
        a live key."""
        kv = self._require()
        tracer = get_tracer()
        with tracer.span("persist.compact"):
            old_keys = kv.keys(_update_prefix(doc_name))
            batch = Batch()
            batch.put(
                _update_key(doc_name, self._seq_for(doc_name)),
                bytes(snapshot),
            )
            for k in old_keys:
                batch.delete(k)
            if sv is not None:
                batch.put(_sv_key(doc_name), bytes(sv))
            batch.put(
                _meta_key(doc_name),
                json.dumps(
                    {"last_updated": time.time(), "size": len(snapshot), "count": 1}
                ).encode(),
            )
            try:
                retry_with_backoff(
                    lambda: kv.write(batch), retries=self.retries,
                    backoff_s=self.retry_backoff_s,
                    counter="persist.retries",
                )
            except OSError:
                self._next_seq.pop(doc_name, None)
                tracer.count("persist.compact_errors")
                if self.failure_policy == "raise":
                    raise
                return
            # compaction squashed everything the overflow buffer held
            # (the snapshot is full state): the buffer is now redundant
            if self._overflow.pop(doc_name, None) is not None:
                self._overflow_sv.pop(doc_name, None)
                self._overflow_bytes = sum(
                    sum(map(len, v)) for v in self._overflow.values()
                )
                _set_degraded(self, doc_name, False)
            # reclaim disk only when dead history dominates: kv.compact()
            # rewrites the WHOLE shared store, so an unconditional call
            # would make N docs' auto-compaction O(store) each — amortize
            # against live size instead (LevelDB's own trigger is
            # similarly ratio-based)
            if kv.log_size > 4 * max(kv.live_size, 1):
                kv.compact()
        tracer.count("persist.compactions")
        tracer.gauge("persist.log_size_bytes", kv.log_size)

    # -- maintenance -------------------------------------------------------
    def sync(self) -> None:
        self._require().sync()

    @property
    def log_size(self) -> int:
        return self._require().log_size
