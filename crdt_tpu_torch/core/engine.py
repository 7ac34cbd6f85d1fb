"""Host integration engine — the exact-semantics oracle.

The port's copy of ``crdt_tpu.core.engine``, pure Python over the
port's ``core`` modules. The replay's host fallbacks
(:func:`crdt_tpu_torch.ops.yata.order_hard_segment`) integrate through
it, and the tests hold it against the reference engine.

This is the scalar reference implementation of the CRDT semantics the
reference library gets from Yjs (``Y.applyUpdate`` at crdt.js:294 is
the hot merge loop; ``Y.Map.set``/``Y.Array.insert`` at crdt.js:375,527
are the local op constructors). The reference's kernels are
differential-tested against this engine on identical columnar inputs.

Semantics implemented (faithful to the YATA/Yjs behavior):

- Items are unit-length, identified by (client, clock); per-client
  clocks are contiguous. Remote items whose dependencies (origins,
  item parent, or preceding clocks) are unknown wait in a pending set
  — the analogue of Yjs's pending-update stash.
- Sequences (root arrays and nested arrays) are doubly linked chains
  including tombstones. Remote integration runs the YATA conflict
  resolution scan: for a new item with left origin ``o`` and right
  origin ``r``, scan the chain between them; an existing item with the
  same left origin and a smaller client goes before the new item; with
  the same left AND right origin and a larger client the scan stops;
  items whose origin lies strictly inside the scanned region are
  skipped or adopted per the items-before-origin rule.
- Map entries per (parent, key) are chains under the same conflict
  rule (right origin always null). The chain tail is the visible
  entry; when a newly integrated item lands at the tail, its left
  neighbor is tombstoned (Yjs deletes the superseded entry during
  integrate, which keeps delete sets converging under full-state
  exchange).
- Deletions are tombstones recorded in a DeleteSet; remote delete
  sets apply to known items and wait in pending ranges otherwise.
"""

from __future__ import annotations

import copy
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

from crdt_tpu_torch.core.ids import DeleteSet, StateVector
from crdt_tpu_torch.core.records import ItemRecord
from crdt_tpu_torch.core.store import (
    K_ANY,
    K_DELETED,
    K_GC,
    K_TYPE,
    NO_KEY,
    NULL,
    TYPE_ARRAY,
    TYPE_MAP,
    ItemStore,
)
from crdt_tpu_torch.obs.tracer import get_tracer

# parent spec: ("root", name_id) or ("item", client, clock)
ParentSpec = Tuple


def evict_deepest(
    keys: Iterable[Tuple[int, int]], limit: int
) -> Tuple[List[Tuple[int, int]], Dict[int, Tuple[int, int]]]:
    """Pick which ``(client, clock)`` ids to evict to shrink a pending
    stash to ``limit``: the ids DEEPEST in their own client's queue.
    Per-client clocks are contiguous, so an id's rank within its
    client (0 = the next to integrate once the gap heals) measures
    distance from its missing dependency — ranking per client, not by
    absolute clock, keeps one flooding fresh client (low clocks) from
    starving a long-lived client's nearly-ready records.

    Returns ``(evicted_keys, ranges)``; ``ranges`` maps client ->
    ``(lo, hi)`` evicted clock range for the replica layer's targeted
    re-probe. Safe by the sync protocol's own math: evicted records
    never advanced the state vector, so any ready-probe answer
    re-ships them.
    """
    keys = sorted(keys)
    n_evict = len(keys) - limit
    if n_evict <= 0:
        return [], {}
    ranked = []
    prev_client, rank = None, 0
    for key in keys:
        rank = rank + 1 if key[0] == prev_client else 0
        prev_client = key[0]
        ranked.append((rank, key[1], key))
    ranked.sort(reverse=True)  # deepest-in-queue first
    evicted = [key for _, _, key in ranked[:n_evict]]
    ranges: Dict[int, Tuple[int, int]] = {}
    for c, k in evicted:
        lo, hi = ranges.get(c, (k, k))
        ranges[c] = (min(lo, k), max(hi, k))
    return evicted, ranges


class Engine:
    def __init__(self, client_id: int):
        self.client_id = int(client_id)
        self.store = ItemStore()
        # linked chains over store rows
        self._next: Dict[int, int] = {}  # row -> row | NULL
        self._prev: Dict[int, int] = {}
        self._seq_head: Dict[ParentSpec, int] = {}  # sequence chains
        self._seq_tail: Dict[ParentSpec, int] = {}
        self._map_head: Dict[Tuple[ParentSpec, int], int] = {}  # key chains
        self._map_tail: Dict[Tuple[ParentSpec, int], int] = {}
        # spec -> ordered set of key ids with chains (dict-as-set), so
        # materializing one map is O(its keys), not O(all map keys)
        self._map_kids: Dict[ParentSpec, Dict[int, None]] = {}
        # pending remote records / deletes waiting on dependencies
        self.pending: List[ItemRecord] = []
        self.pending_deletes = DeleteSet()
        # pending-stash budget (guard layer): None = unbounded (the
        # historical behavior); an int caps len(pending) — overflow
        # evicts the records FURTHEST from integrable (largest clocks
        # per client: their blocker is deepest) and records the
        # evicted (client, clock) ranges so the replica layer can
        # re-probe the blocking peer (:func:`evict_deepest`).
        self.pending_limit: Optional[int] = None
        self.evicted_ranges: Dict[int, Tuple[int, int]] = {}
        # per-client next expected clock (contiguity guard)
        self._next_clock: Dict[int, int] = {}
        # root name -> kind hint ("map"/"array") from observed items
        self.root_kinds: Dict[str, str] = {}
        # batch-local bookkeeping for observers/delta tracking
        self.last_txn_items: List[int] = []
        self.last_txn_deletes = DeleteSet()

    # ------------------------------------------------------------------
    # clock / id helpers
    # ------------------------------------------------------------------
    def next_clock(self, client: Optional[int] = None) -> int:
        c = self.client_id if client is None else client
        return self._next_clock.get(c, 0)

    def _alloc_clock(self) -> int:
        c = self._next_clock.get(self.client_id, 0)
        return c

    def state_vector(self) -> StateVector:
        return StateVector(dict(self._next_clock))

    def delete_set(self) -> DeleteSet:
        return self.store.delete_set()

    # ------------------------------------------------------------------
    # parent / chain helpers
    # ------------------------------------------------------------------
    def _parent_spec_of_row(self, row: int) -> ParentSpec:
        s = self.store
        if s.parent_root[row] != NULL:
            return ("root", int(s.parent_root[row]))
        return ("item", int(s.parent_client[row]), int(s.parent_clock[row]))

    def _chain_of_row(self, row: int):
        """Return (head_dict, tail_dict, chain_key) for the row's chain."""
        spec = self._parent_spec_of_row(row)
        kid = int(self.store.key_id[row])
        if kid != NO_KEY:
            return self._map_head, self._map_tail, (spec, kid)
        return self._seq_head, self._seq_tail, spec

    def _root_spec(self, name: str) -> ParentSpec:
        return ("root", self.store.intern_root(name))

    # ------------------------------------------------------------------
    # local operations (construct records, integrate through same path)
    # ------------------------------------------------------------------
    def _local_record(self, **kw) -> ItemRecord:
        rec = ItemRecord(client=self.client_id, clock=self._alloc_clock(), **kw)
        ok = self._try_integrate(rec)
        assert ok, "local op must always be integrable"
        return rec

    def map_set(
        self, map_name: str, key: str, value: Any, *, parent: Optional[ParentSpec] = None
    ) -> ItemRecord:
        """Set key in a (root or nested) map; LWW via key-chain append."""
        spec = parent if parent is not None else self._root_spec(map_name)
        kid = self.store.intern_key(key)
        tail = self._map_tail.get((spec, kid))
        origin = self.store.id_of(tail) if tail is not None else None
        return self._local_record(
            parent_root=map_name if spec[0] == "root" else None,
            parent_item=(spec[1], spec[2]) if spec[0] == "item" else None,
            key=key,
            origin=origin,
            right=None,
            kind=K_ANY,
            content=copy.deepcopy(value),
        )

    def map_set_type(
        self, map_name: str, key: str, type_ref: int = TYPE_ARRAY,
        *, parent: Optional[ParentSpec] = None,
    ) -> ItemRecord:
        """Set key to a fresh nested type (Y.Array inside a map, crdt.js:423)."""
        spec = parent if parent is not None else self._root_spec(map_name)
        kid = self.store.intern_key(key)
        tail = self._map_tail.get((spec, kid))
        origin = self.store.id_of(tail) if tail is not None else None
        return self._local_record(
            parent_root=map_name if spec[0] == "root" else None,
            parent_item=(spec[1], spec[2]) if spec[0] == "item" else None,
            key=key,
            origin=origin,
            right=None,
            kind=K_TYPE,
            type_ref=type_ref,
        )

    def map_delete(self, map_name: str, key: str, *, parent: Optional[ParentSpec] = None) -> bool:
        """Tombstone the visible entry for key. Returns False if absent."""
        spec = parent if parent is not None else self._root_spec(map_name)
        kid = self.store.key_id_of(key)
        if kid is None:
            return False
        tail = self._map_tail.get((spec, kid))
        if tail is None or self.store.deleted[tail]:
            return False
        self._delete_row(tail)
        return True

    def seq_insert(
        self, name: str, index: int, values: List[Any], *, parent: Optional[ParentSpec] = None
    ) -> List[ItemRecord]:
        """Insert values at index into a (root or nested) sequence."""
        spec = parent if parent is not None else self._root_spec(name)
        left = self._visible_left(spec, index)
        out = []
        for v in values:
            right = self._next.get(left, NULL) if left is not None else self._seq_head.get(spec, NULL)
            rec = self._local_record(
                parent_root=name if spec[0] == "root" else None,
                parent_item=(spec[1], spec[2]) if spec[0] == "item" else None,
                key=None,
                origin=self.store.id_of(left) if left is not None else None,
                right=self.store.id_of(right) if right != NULL else None,
                kind=K_ANY,
                content=copy.deepcopy(v),
            )
            out.append(rec)
            left = self.store.find(*rec.id)
        return out

    def seq_insert_type(
        self, name: str, index: int, type_ref: int = TYPE_ARRAY,
        *, parent: Optional[ParentSpec] = None,
    ) -> ItemRecord:
        """Insert a nested type into a sequence (arrays of arrays)."""
        spec = parent if parent is not None else self._root_spec(name)
        left = self._visible_left(spec, index)
        right = self._next.get(left, NULL) if left is not None else self._seq_head.get(spec, NULL)
        return self._local_record(
            parent_root=name if spec[0] == "root" else None,
            parent_item=(spec[1], spec[2]) if spec[0] == "item" else None,
            key=None,
            origin=self.store.id_of(left) if left is not None else None,
            right=self.store.id_of(right) if right != NULL else None,
            kind=K_TYPE,
            type_ref=type_ref,
        )

    def seq_delete(
        self, name: str, index: int, length: int, *, parent: Optional[ParentSpec] = None
    ) -> int:
        """Tombstone `length` visible items from `index`. Returns count."""
        spec = parent if parent is not None else self._root_spec(name)
        row = self._visible_at(spec, index)
        count = 0
        while row is not None and count < length:
            nxt = self._next_visible(row)
            self._delete_row(row)
            count += 1
            row = nxt
        return count

    def _visible_left(self, spec: ParentSpec, index: int) -> Optional[int]:
        """Row of the (index-1)-th visible item, or None for index 0."""
        if index <= 0:
            return None
        row = self._seq_head.get(spec, NULL)
        seen = 0
        while row != NULL:
            if self._is_countable(row):
                seen += 1
                if seen == index:
                    return row
            row = self._next.get(row, NULL)
        raise IndexError(f"index {index} out of range (len={seen})")

    def _visible_at(self, spec: ParentSpec, index: int) -> Optional[int]:
        row = self._seq_head.get(spec, NULL)
        seen = 0
        while row != NULL:
            if self._is_countable(row):
                if seen == index:
                    return row
                seen += 1
            row = self._next.get(row, NULL)
        return None

    def seq_len(self, name: Optional[str] = None, *, parent: Optional[ParentSpec] = None) -> int:
        """Visible length of a sequence — chain count only, no JSON
        materialization (push's append-index lookup)."""
        if parent is not None:
            spec = parent
        else:
            rid = self.store.root_id(name)
            if rid is None:
                return 0
            spec = ("root", rid)
        n = 0
        row = self._seq_head.get(spec, NULL)
        while row != NULL:
            if self._is_countable(row):
                n += 1
            row = self._next.get(row, NULL)
        return n

    def _next_visible(self, row: int) -> Optional[int]:
        r = self._next.get(row, NULL)
        while r != NULL and not self._is_countable(r):
            r = self._next.get(r, NULL)
        return r if r != NULL else None

    def _is_countable(self, row: int) -> bool:
        # ContentFormat is not countable in Yjs (formatting markers carry
        # no sequence position); deleted/GC rows are tombstones
        from crdt_tpu_torch.core.store import K_FORMAT

        return not self.store.deleted[row] and self.store.kind[row] not in (
            K_DELETED,
            K_GC,
            K_FORMAT,
        )

    def _delete_row(self, row: int) -> None:
        if not self.store.deleted[row]:
            self.store.mark_deleted(row)
            self.last_txn_deletes.add(int(self.store.client[row]), int(self.store.clock[row]))

    # ------------------------------------------------------------------
    # remote integration
    # ------------------------------------------------------------------
    def apply_records(
        self, records: List[ItemRecord], delete_set: Optional[DeleteSet] = None
    ) -> None:
        """Integrate a batch of remote records + delete set (applyUpdate)."""
        self.apply_batch(records, delete_set, chain_integrate=True)

    def apply_batch(
        self,
        records: List[ItemRecord],
        delete_set: Optional[DeleteSet] = None,
        *,
        chain_integrate: bool,
    ) -> None:
        """Shared admission loop for both merge paths, O(n + deps):
        records that cannot integrate yet are parked on their first
        missing dependency (a clock gap parks on (client, clock-1);
        a missing origin/right/parent parks on that id) and woken the
        moment it lands — no quadratic re-scan passes over the batch
        (the r1 engine retried the whole remainder per round).
        ``chain_integrate=False`` is the device path's admit-only mode
        (chains are rebuilt by kernels afterwards); one loop keeps both
        modes' admission/pending semantics identical. Ends with the
        delete-set application, like ``Y.applyUpdate``."""
        self.begin_txn()
        if chain_integrate:
            step = self._try_integrate
        else:
            step = lambda rec: self._try_admit(rec)[0]  # noqa: E731
        queue = deque(
            sorted(records + self.pending, key=lambda r: (r.client, r.clock))
        )
        n_prior_pending = len(self.pending)
        self.pending = []
        waiting: Dict[Tuple[int, int], List[ItemRecord]] = {}
        n_integrated = 0
        try:
            while queue:
                rec = queue.popleft()
                if step(rec):
                    n_integrated += 1
                    # anything parked on this id (contiguity waiters key
                    # on (client, clock); dep waiters on the dep id)
                    woken = waiting.pop(rec.id, None)
                    if woken:
                        queue.extend(woken)
                else:
                    blocker = self._blocker_of(rec)
                    if blocker is None:
                        # cannot happen for well-formed records (not-
                        # handled implies a gap or a missing dep)
                        self.pending.append(rec)
                    else:
                        waiting.setdefault(blocker, []).append(rec)
        except BaseException as e:
            # an exception mid-batch must not wipe the stash: the
            # queue, parked waiters, and prior pending (absorbed into
            # the queue) return to pending. The in-flight record is
            # kept only for non-Exception interrupts (KeyboardInterrupt
            # etc. — it was presumably valid); a record that RAISED a
            # regular Exception is malformed and re-queueing it would
            # poison every later batch.
            if not isinstance(e, Exception):
                self.pending.append(rec)
            self.pending.extend(queue)
            for recs in waiting.values():
                self.pending.extend(recs)
            raise
        for recs in waiting.values():
            self.pending.extend(recs)
        if (
            self.pending_limit is not None
            and len(self.pending) > self.pending_limit
        ):
            self._evict_pending()
        if delete_set is not None:
            self._apply_delete_set(delete_set)
        self._retry_pending_deletes()
        tracer = get_tracer()
        if tracer.enabled:
            # one counter flush per batch, never per record: the
            # admission loop itself stays tracer-free. Stashed counts
            # only the NET NEW parked records (prior pending re-rides
            # every batch and must not re-count); the gauge carries
            # the current stash depth
            newly_stashed = len(self.pending) - n_prior_pending
            tracer.count("engine.records_integrated", n_integrated)
            if newly_stashed > 0:
                tracer.count("engine.records_stashed", newly_stashed)
            tracer.gauge("engine.pending", len(self.pending))
            tracer.gauge(
                "engine.pending_delete_ranges",
                sum(len(v) for v in self.pending_deletes.ranges.values()),
            )

    def _evict_pending(self) -> None:
        """Shrink the stash to ``pending_limit`` by dropping the
        records DEEPEST in their own client's queue (the shared
        fairness/recovery policy, :func:`evict_deepest`). Evicted ids
        merge into ``evicted_ranges`` (client -> (lo, hi)); the
        replica layer drains them via :meth:`take_evicted_ranges` and
        re-probes."""
        evicted, ranges = evict_deepest(
            [(r.client, r.clock) for r in self.pending], self.pending_limit
        )
        if not evicted:
            return
        ev = set(evicted)
        n_before = len(self.pending)
        self.pending = [
            r for r in self.pending if (r.client, r.clock) not in ev
        ]
        for c, (lo, hi) in ranges.items():
            plo, phi = self.evicted_ranges.get(c, (lo, hi))
            self.evicted_ranges[c] = (min(plo, lo), max(phi, hi))
        tracer = get_tracer()
        if tracer.enabled:
            tracer.count(
                "engine.pending_evictions", n_before - len(self.pending)
            )

    def take_evicted_ranges(self) -> Dict[int, Tuple[int, int]]:
        """Drain the evicted (client, clock) range bookkeeping — the
        replica layer's cue to issue targeted SV re-probes."""
        ev, self.evicted_ranges = self.evicted_ranges, {}
        return ev

    def _blocker_of(self, rec: ItemRecord) -> Optional[Tuple[int, int]]:
        """The first id this record is waiting on: the previous clock
        of its own client (contiguity), else a missing dependency."""
        nc = self._next_clock.get(rec.client, 0)
        if rec.clock > nc:
            return (rec.client, rec.clock - 1)
        for dep in rec.dep_ids():
            if not self.store.has(*dep):
                return dep
        return None

    def begin_txn(self) -> None:
        self.last_txn_items = []
        self.last_txn_deletes = DeleteSet()

    def _apply_delete_set(self, ds: DeleteSet) -> None:
        self._clamped_delete(ds, self.pending_deletes)

    def _retry_pending_deletes(self) -> None:
        if not self.pending_deletes.ranges:
            return
        pending, self.pending_deletes = self.pending_deletes, DeleteSet()
        self._clamped_delete(pending, self.pending_deletes)

    def _clamped_delete(self, ds: DeleteSet, pend_into: DeleteSet) -> None:
        """Delete every range's integrated clocks; the portion at or
        above the client's contiguity watermark pends as a RANGE, not
        per clock — a hostile (or merely early) range covering clocks
        that may never exist must cost O(ranges), never O(declared
        length) (adversarial matrix, tests/test_yjs_fixtures.py)."""
        for client, clock, length in ds.iter_all():
            end = clock + length
            wm = self._next_clock.get(client, 0)
            for k in range(clock, min(end, wm)):
                row = self.store.find(client, k)
                if row is None:
                    pend_into.add(client, k)
                else:
                    self._delete_row(row)
            if end > wm:
                tail = max(clock, wm)
                pend_into.add(client, tail, end - tail)

    def _try_integrate(self, rec: ItemRecord) -> bool:
        handled, row = self._try_admit(rec)
        if handled and row is not None:
            self._integrate_into_chain(row, rec)
        return handled

    def _try_admit(self, rec: ItemRecord) -> Tuple[bool, Optional[int]]:
        """Admission bookkeeping without chain integration: dedup, clock
        contiguity, dependency check, parent resolution, store append.

        Returns (handled, row): ``handled`` False means the record must
        wait (missing deps / clock gap); ``row`` is the new store row,
        or None when nothing needs chain integration (duplicates, GC
        fillers). The device merge path admits whole batches through
        this and rebuilds chain state with the kernels instead of the
        per-record scan (crdt.js:294's loop, vectorized)."""
        s = self.store
        # duplicate (already integrated) -> drop (idempotent merge)
        if s.has(rec.client, rec.clock):
            return True, None
        # clock contiguity per client
        if rec.clock != self._next_clock.get(rec.client, 0):
            if rec.clock < self._next_clock.get(rec.client, 0):
                return True, None  # stale duplicate below watermark
            return False, None
        # dependencies known?
        for dep in rec.dep_ids():
            if not s.has(*dep):
                return False, None
        if rec.kind == K_GC:
            # positional info is gone; record clock coverage only
            row = s.add_item(
                rec.client, rec.clock, kind=K_GC, content=None, deleted=True
            )
            self._next_clock[rec.client] = rec.clock + 1
            self.last_txn_items.append(row)
            return True, None
        # resolve parent
        if rec.parent_root is not None:
            spec: ParentSpec = ("root", s.intern_root(rec.parent_root))
            self.root_kinds.setdefault(
                rec.parent_root, "map" if rec.key is not None else "array"
            )
        elif rec.parent_item is not None:
            spec = ("item", rec.parent_item[0], rec.parent_item[1])
        else:
            # parent implied by origin's parent (Yjs omits parent info when
            # an origin is present)
            oid = rec.origin if rec.origin is not None else rec.right
            assert oid is not None, "record without parent or origin"
            orow = s.find(*oid)
            spec = self._parent_spec_of_row(orow)
            if rec.key is None and s.key_id[orow] != NO_KEY:
                rec.key = s.keys[int(s.key_id[orow])]
        row = s.add_item(
            rec.client,
            rec.clock,
            parent_root=spec[1] if spec[0] == "root" else NULL,
            parent_id=(spec[1], spec[2]) if spec[0] == "item" else (NULL, NULL),
            key_id=s.intern_key(rec.key) if rec.key is not None else NO_KEY,
            origin=rec.origin or (NULL, NULL),
            right=rec.right or (NULL, NULL),
            kind=rec.kind,
            type_ref=rec.type_ref if rec.type_ref is not None else NULL,
            content=rec.content,
            deleted=rec.kind in (K_DELETED, K_GC),
        )
        self._next_clock[rec.client] = rec.clock + 1
        self.last_txn_items.append(row)
        return True, row

    def _integrate_into_chain(self, row: int, rec: ItemRecord) -> None:
        """YATA conflict resolution: faithful port of the integrate scan."""
        s = self.store
        heads, tails, ckey = self._chain_of_row(row)
        head = heads.get(ckey, NULL)

        origin_row = s.find(*rec.origin) if rec.origin is not None else None
        left = origin_row
        right = s.find(*rec.right) if rec.right is not None else None

        o = self._next.get(left, NULL) if left is not None else head
        conflicting: set = set()
        items_before_origin: set = set()
        while o != NULL and (right is None or o != right):
            items_before_origin.add(o)
            conflicting.add(o)
            o_origin = (int(s.origin_client[o]), int(s.origin_clock[o]))
            o_origin_row = (
                s.find(*o_origin) if o_origin != (NULL, NULL) else None
            )
            if o_origin_row == origin_row:
                # case 1: same left origin as ours -> order by client id
                if int(s.client[o]) < rec.client:
                    left = o
                    conflicting.clear()
                else:
                    o_right = (int(s.right_client[o]), int(s.right_clock[o]))
                    my_right = rec.right if rec.right is not None else (NULL, NULL)
                    if o_right == my_right:
                        break
            elif o_origin_row is not None and o_origin_row in items_before_origin:
                # case 2: o's origin is inside the scanned region
                if o_origin_row not in conflicting:
                    left = o
                    conflicting.clear()
            else:
                break
            o = self._next.get(o, NULL)

        # splice after `left` (or at head)
        if left is not None:
            nxt = self._next.get(left, NULL)
            self._next[left] = row
            self._prev[row] = left
        else:
            nxt = head
            heads[ckey] = row
            self._prev[row] = NULL
        self._next[row] = nxt
        if nxt != NULL:
            self._prev[nxt] = row
        else:
            tails[ckey] = row

        # map-entry bookkeeping (Yjs Item.integrate): an item landing at
        # the chain tail becomes the visible entry and tombstones its
        # left neighbor; an item landing with a right neighbor lost the
        # race and is tombstoned itself. Both sides of a concurrent set
        # therefore derive the same delete set from the same op set.
        if int(s.key_id[row]) != NO_KEY:
            self._map_kids.setdefault(ckey[0], {})[ckey[1]] = None
            if self._next[row] == NULL:
                if left is not None and not s.deleted[left]:
                    self._delete_row(left)
            else:
                self._delete_row(row)

    # ------------------------------------------------------------------
    # materialization
    # ------------------------------------------------------------------
    def _value_of_row(self, row: int) -> Any:
        s = self.store
        if s.kind[row] == K_TYPE:
            spec = ("item", int(s.client[row]), int(s.clock[row]))
            if s.type_ref[row] == TYPE_MAP:
                return self._map_json(spec)
            return self._seq_json(spec)
        return s.content[row]

    def _map_json(self, spec: ParentSpec) -> Dict[str, Any]:
        out = {}
        for kid in self._map_kids.get(spec, ()):
            tail = self._map_tail.get((spec, kid))
            if tail is not None and not self.store.deleted[tail]:
                out[self.store.keys[kid]] = self._value_of_row(tail)
        return out

    def _seq_json(self, spec: ParentSpec) -> List[Any]:
        out = []
        row = self._seq_head.get(spec, NULL)
        while row != NULL:
            if self._is_countable(row):
                out.append(self._value_of_row(row))
            row = self._next.get(row, NULL)
        return out

    def map_json(self, name: str) -> Dict[str, Any]:
        rid = self.store.root_id(name)
        if rid is None:
            return {}
        return self._map_json(("root", rid))

    def seq_json(self, name: str) -> List[Any]:
        rid = self.store.root_id(name)
        if rid is None:
            return []
        return self._seq_json(("root", rid))

    def map_get(self, name: str, key: str) -> Any:
        """Visible value for key, or None (the `get` the README promised
        but the reference never shipped — SURVEY.md D7)."""
        rid = self.store.root_id(name)
        kid = self.store.key_id_of(key)
        if rid is None or kid is None:
            return None
        tail = self._map_tail.get((("root", rid), kid))
        if tail is None or self.store.deleted[tail]:
            return None
        return self._value_of_row(tail)

    def map_has(self, name: str, key: str) -> bool:
        """Whether the key has a VISIBLE entry — distinguishes a stored
        None value from an absent/tombstoned key (map_get can't)."""
        rid = self.store.root_id(name)
        kid = self.store.key_id_of(key)
        if rid is None or kid is None:
            return False
        tail = self._map_tail.get((("root", rid), kid))
        return tail is not None and not bool(self.store.deleted[tail])

    def map_entry_spec(self, name: str, key: str) -> Optional[ParentSpec]:
        """Parent spec of the visible nested type under (name, key)."""
        rid = self.store.root_id(name)
        kid = self.store.key_id_of(key)
        if rid is None or kid is None:
            return None
        tail = self._map_tail.get((("root", rid), kid))
        if tail is None or self.store.deleted[tail]:
            return None
        if self.store.kind[tail] != K_TYPE:
            return None
        return ("item", int(self.store.client[tail]), int(self.store.clock[tail]))

    def _public_parent(self, spec: ParentSpec) -> Tuple:
        """Interned parent spec -> the symbolic parent key used by the
        kernel wrappers: ("root", name) or ("item", client, clock)."""
        if spec[0] == "root":
            return ("root", self.store.root_names[spec[1]])
        return ("item", spec[1], spec[2])

    def seq_order_table(self) -> Dict[Tuple, List[Tuple[int, int]]]:
        """{parent: [item ids in chain order, tombstones included]} for
        every sequence — the oracle view the YATA kernel is tested
        against."""
        out: Dict[Tuple, List[Tuple[int, int]]] = {}
        for spec, head in self._seq_head.items():
            parent = self._public_parent(spec)
            ids = []
            row = head
            while row != NULL:
                ids.append(self.store.id_of(row))
                row = self._next.get(row, NULL)
            out[parent] = ids
        return out

    def map_winner_table(self) -> Dict[Tuple, Tuple[Tuple[int, int], bool]]:
        """{(parent, key): (winner id, visible)} over every map chain —
        the oracle view the LWW kernel is differential-tested against.
        Parent is ("root", name) or ("item", client, clock)."""
        out: Dict[Tuple, Tuple[Tuple[int, int], bool]] = {}
        for (spec, kid), tail in self._map_tail.items():
            parent = self._public_parent(spec)
            out[(parent, self.store.keys[kid])] = (
                self.store.id_of(tail),
                not bool(self.store.deleted[tail]),
            )
        return out

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for name, kind in self.root_kinds.items():
            out[name] = self.map_json(name) if kind == "map" else self.seq_json(name)
        return out

    # ------------------------------------------------------------------
    # export for codec / kernels
    # ------------------------------------------------------------------
    def record_of_row(self, row: int) -> ItemRecord:
        """Symbolic record for one store row."""
        s = self.store
        parent_root = (
            s.root_names[int(s.parent_root[row])]
            if s.parent_root[row] != NULL
            else None
        )
        parent_item = (
            (int(s.parent_client[row]), int(s.parent_clock[row]))
            if s.parent_root[row] == NULL and s.parent_client[row] != NULL
            else None
        )
        origin = (
            (int(s.origin_client[row]), int(s.origin_clock[row]))
            if s.origin_client[row] != NULL
            else None
        )
        right = (
            (int(s.right_client[row]), int(s.right_clock[row]))
            if s.right_client[row] != NULL
            else None
        )
        key = s.keys[int(s.key_id[row])] if s.key_id[row] != NO_KEY else None
        return ItemRecord(
            client=int(s.client[row]),
            clock=int(s.clock[row]),
            parent_root=parent_root,
            parent_item=parent_item,
            key=key,
            origin=origin,
            right=right,
            kind=int(s.kind[row]),
            type_ref=int(s.type_ref[row]),
            content=s.content[row],
        )

    def records_for_rows(self, rows) -> List[ItemRecord]:
        """Records for specific rows, (client, clock)-sorted — O(len)
        txn-delta extraction (vs records_since's full-store scan)."""
        out = [self.record_of_row(row) for row in rows]
        out.sort(key=lambda r: (r.client, r.clock))
        return out

    def to_decoded_columns(self, ds: Optional[DeleteSet] = None) -> dict:
        """The whole store in the decode column schema (client-grouped,
        clock-ascending — the wire's run order): the seam for the
        native ``encode_from_columns`` snapshot path. The store is
        already SoA numpy, so a full-state encode is one lexsort + one
        C pass instead of an O(doc) ``record_of_row`` walk — the same
        unification the resident replay has
        (``IncrementalReplay.to_decoded_columns``). ``ds`` lets the
        caller reuse an already-computed delete set (building one is
        an O(store) scan). Match: north star 'snapshot rebuild through
        the same kernel'; /root/reference/crdt.js:79-98."""
        import numpy as np

        from crdt_tpu_torch.codec.native import ds_to_triples

        s = self.store
        n = s.n
        order = np.lexsort((s.clock[:n], s.client[:n]))
        cols = {
            name: getattr(s, name)[:n][order]
            for name in (
                "client", "clock", "parent_client", "parent_clock",
                "origin_client", "origin_clock", "right_client",
                "right_clock",
            )
        }
        cols.update(
            parent_root=s.parent_root[:n][order].astype(np.int32),
            key_id=s.key_id[:n][order].astype(np.int32),
            kind=s.kind[:n][order].astype(np.int32),
            type_ref=s.type_ref[:n][order].astype(np.int32),
            contents=[s.content[int(r)] for r in order],
            roots=list(s.root_names),
            keys=list(s.keys),
            ds=ds_to_triples(ds if ds is not None else self.delete_set()),
        )
        return cols

    def records_since(self, sv: Optional[StateVector] = None) -> List[ItemRecord]:
        """All records with clock >= sv[client] (full state when sv None).

        O(delta) via the store's per-client clock-sorted row index: a
        ready-probe on a large doc touches only the rows the requester
        lacks, not the whole store (the reference's syncer re-encodes a
        full diff per probe, crdt.js:288)."""
        from bisect import bisect_left

        s = self.store
        if sv is None:
            out = [self.record_of_row(row) for row in range(s.n)]
        else:
            out = []
            for client, rows in s.client_rows.items():
                wm = sv.get(client)
                if not wm:
                    out.extend(self.record_of_row(r) for r in rows)
                    continue
                # rows are clock-ascending per client
                start = bisect_left(rows, wm, key=lambda r: int(s.clock[r]))
                out.extend(self.record_of_row(r) for r in rows[start:])
        out.sort(key=lambda r: (r.client, r.clock))
        return out
