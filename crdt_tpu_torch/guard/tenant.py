"""Per-tenant admission budgets + fairness for multi-doc serving.

The round-10 ladders bound ONE replica's memory/disk/device exposure;
a multi-tenant batch server (:class:`crdt_tpu_torch.models.multidoc.
MultiDocServer`) adds the cross-tenant failure mode: one flooding doc
filling the shared admission queue until every other tenant's deltas
wait behind it. Same discipline, tenant-scoped:

- **budget** — each tenant's PENDING (admitted, not yet converged)
  updates are bounded by bytes and count. Overflow sheds the
  tenant's OWN oldest pending updates (keep-the-newest, the
  round-10 inbox rule: a single over-budget repair blob still
  lands whole). A flooding tenant therefore degrades alone — its
  backlog is trimmed — while every other tenant's queue, and the
  bytes they converge to, are untouched (tests/test_multidoc.py
  chaos leg).
- **fairness** — dispatch admission orders dirty docs by how long
  ago they were last served (then doc id for determinism), so a
  tenant that fills every tick's row budget cannot starve the rest:
  the docs left out of this tick are FIRST in line for the next.
- **resident budget** (round 15) — the delta-tick path keeps per-doc
  RESIDENT state (device matrices + host caches) across ticks; that
  memory is bounded by :class:`ResidentBudget`
  (``CRDT_TPU_MT_RESIDENT_BYTES``). Overflow evicts the
  least-recently-served docs' resident state back to cold replay
  (``tenant.resident_evictions``) — eviction costs the evicted doc a
  cold replay on its next touch, never bytes.

Counters (README "Observability" registry): ``tenant.shed`` /
``tenant.shed_bytes`` on every trimmed update, the
``tenant.pending_bytes`` gauge for the queue's live total,
``tenant.resident_evictions`` + the ``tenant.resident_bytes`` /
``tenant.resident_docs`` gauges for the resident-state ledger.
Round 18: a trim with a known ``tenant=`` additionally emits the
labeled ``tenant.shed{tenant=}`` counter and a ``tenant.shed``
flight-recorder event (``doc``/``count``/``bytes`` fields), so a
shed shows up attributed in the SLO ledger's route mix, the
``/events?doc=`` filter, and an ``obsq`` query — not just as an
anonymous aggregate.
"""

from __future__ import annotations

from typing import Callable, Deque, Dict, Iterable, List, Optional, Tuple

from crdt_tpu_torch.obs.recorder import get_recorder
from crdt_tpu_torch.obs.tracer import get_tracer


class TenantBudget:
    """Byte + count budget over one tenant's pending update queue."""

    def __init__(self, max_bytes: int = 1 << 22,
                 max_updates: int = 4096):
        self.max_bytes = int(max_bytes)
        self.max_updates = int(max_updates)
        # round 22: per-tenant runtime overrides (the control plane's
        # budget_squeeze actuator) — tenant -> (max_bytes, max_updates)
        self._overrides: Dict[object, Tuple[int, int]] = {}

    def limits(self, tenant=None) -> Tuple[int, int]:
        """The effective ``(max_bytes, max_updates)`` for a tenant:
        its override when the control plane has squeezed it, the
        static budget otherwise."""
        if tenant is not None:
            ov = self._overrides.get(tenant)
            if ov is not None:
                return ov
        return (self.max_bytes, self.max_updates)

    def set_override(self, tenant, max_bytes: int,
                     max_updates: int) -> None:
        self._overrides[tenant] = (
            max(1, int(max_bytes)), max(1, int(max_updates))
        )

    def clear_override(self, tenant) -> None:
        self._overrides.pop(tenant, None)

    def overrides(self) -> Dict[object, Tuple[int, int]]:
        return dict(self._overrides)

    def trim(self, queue: Deque[bytes],
             tenant=None) -> List[bytes]:
        """Shed OLDEST pending updates until ``queue`` fits the
        budget; the newest update is always kept (keep-the-newest).
        Returns the shed blobs (callers count them). ``tenant``,
        when given, attributes the shed: the labeled
        ``tenant.shed{tenant=}`` counter and a ``tenant.shed``
        flight-recorder event carry it into the SLO route mix and
        the ``/events`` filters — and selects any control-plane
        override of the static budget (:meth:`limits`)."""
        max_bytes, max_updates = self.limits(tenant)
        shed: List[bytes] = []
        size = sum(len(b) for b in queue)
        while len(queue) > 1 and (
            size > max_bytes or len(queue) > max_updates
        ):
            old = queue.popleft()
            size -= len(old)
            shed.append(old)
        if shed and tenant is not None:
            nbytes = sum(len(b) for b in shed)
            tracer = get_tracer()
            if tracer.enabled:
                tracer.count("tenant.shed", len(shed),
                             labels={"tenant": tenant})
            rec = get_recorder()
            if rec.enabled:
                rec.record("tenant.shed", doc=str(tenant),
                           count=len(shed), bytes=nbytes)
        return shed


def fair_order(doc_ids: Iterable,
               last_served: Dict) -> List:
    """Dirty docs in service order: least-recently-served first,
    then doc id (deterministic). ``last_served`` maps doc id -> the
    tick index it last converged in (absent = never served, which
    sorts first)."""
    return sorted(doc_ids, key=lambda d: (last_served.get(d, -1), d))


class ResidentBudget:
    """Byte ledger over per-doc resident state (round 15).

    Tracks one server's total resident bytes (each doc's device
    matrix + host column store, :meth:`crdt_tpu_torch.models.incremental.
    IncrementalReplay.resident_bytes`) and answers the two questions
    the tick loop asks:

    - :meth:`fits` — may a doc of this (estimated) size be promoted
      to resident, after evicting least-recently-served residents to
      make room? Eviction happens eagerly inside the call via the
      caller's ``evict`` callback, so the ledger NEVER exceeds the
      budget: an over-budget promotion is refused before the engine
      is built, not rolled back after.
    - :meth:`set_doc` / :meth:`drop_doc` — commit a doc's measured
      bytes (post-promotion, post-round growth) or clear them on
      eviction/fallback.

    ``max_bytes=None`` disables the bound (unbudgeted server).
    ``peak`` tracks the ledger's high-water mark, noted only at
    STABLE points (:meth:`note_peak` — post-enforcement commit, tick
    end), so the published bound is the committed resident state,
    never a mid-enforcement transient."""

    def __init__(self, max_bytes: Optional[int] = None):
        self.max_bytes = None if max_bytes is None else int(max_bytes)
        self._bytes: Dict[object, int] = {}
        self.total = 0
        self.peak = 0

    def doc_bytes(self, doc_id) -> int:
        return self._bytes.get(doc_id, 0)

    def has_doc(self, doc_id) -> bool:
        return doc_id in self._bytes

    def docs(self) -> int:
        return len(self._bytes)

    def note_peak(self) -> int:
        self.peak = max(self.peak, self.total)
        return self.peak

    def set_doc(self, doc_id, nbytes: int) -> None:
        self.total += int(nbytes) - self._bytes.get(doc_id, 0)
        self._bytes[doc_id] = int(nbytes)

    def drop_doc(self, doc_id) -> int:
        """Clear a doc's ledger entry; returns the bytes released."""
        freed = self._bytes.pop(doc_id, 0)
        self.total -= freed
        return freed

    def fits(self, need: int, *,
             lru: Iterable,
             evict: Callable[[object], None]) -> bool:
        """Can ``need`` more resident bytes be admitted? Evicts docs
        from ``lru`` (least-recently-served first; ids without a
        ledger entry are skipped) through the caller's ``evict``
        callback — which must end up calling :meth:`drop_doc` — until
        the admission fits or no evictable doc remains. The caller
        counts evictions (its callback owns the observable side)."""
        if self.max_bytes is None:
            return True
        if need > self.max_bytes:
            return False  # one doc larger than the whole budget
        for doc_id in lru:
            if self.total + need <= self.max_bytes:
                break
            if doc_id not in self._bytes:
                continue
            evict(doc_id)
        return self.total + need <= self.max_bytes


def pack_batches(rows_of: List[Tuple[object, int]],
                 max_rows: int) -> List[List[object]]:
    """Greedy bin-pack of (doc, row_count) pairs — in the given
    fairness order — into dispatch batches of at most ``max_rows``
    rows. A doc larger than ``max_rows`` gets a batch of its own
    (it cannot be split: segments never cross docs, and a doc's
    converge is whole-history)."""
    batches: List[List[object]] = []
    cur: List[object] = []
    cur_rows = 0
    for doc_id, n in rows_of:
        if cur and cur_rows + n > max_rows:
            batches.append(cur)
            cur, cur_rows = [], 0
        cur.append(doc_id)
        cur_rows += n
    if cur:
        batches.append(cur)
    return batches
