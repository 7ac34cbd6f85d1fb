"""Resident-document API — the op layer over card-resident state.

The port's copy of ``crdt_tpu.api.resident_doc``.
``merge_mode="resident"`` replicas never materialize the scalar
engine: the document lives in :class:`crdt_tpu_torch.models.incremental.
IncrementalReplay` (host admission columns + the resident device
matrix on ``device``, the card unless the caller asks for the CPU +
per-segment winner/order caches), and this class puts the reference's
public surface (crdt.js:325-702 — the same one
:class:`crdt_tpu_torch.api.doc.Crdt` reproduces engine-backed) on top
of it.

The design collapses the local/remote asymmetry: **local ops ARE
updates**. Every mutation builds :class:`ItemRecord`s anchored on the
resident state (map chain tails from the winner cache, sequence
left/right anchors from the order cache — the same anchors
``Engine.map_set`` / ``Engine.seq_insert`` derive, with multi-value
inserts chained through fresh ids; see ``_seq_insert`` for the
placement-equivalence argument), encodes them as a v1 blob,
self-applies it through the SAME admission + convergence path remote
updates take, and hands the blob to the transport. One code path
integrates everything (crdt.js:294's ``applyUpdate``, unified for both
directions), so a resident replica converges with engine-backed peers
by construction, and emits the reference ``ResidentCrdt``'s blobs byte
for byte (tests/test_torch_api.py, tests/test_torch_net.py).

Per-round convergence cost follows the replay's host/device crossover
(``device_min_rows``): keystroke-sized deltas — including every local
op — converge on host against the resident columns; firehose rounds
go through the device round (``stream_scatter`` on the card). Sync
protocol answers (state vector,
ready-probe diffs, anti-entropy deficits, compaction snapshots) come
from the resident columns via ``IncrementalReplay``'s protocol
surface; see that module for the Engine-equivalence argument.
"""

from __future__ import annotations

import copy
from types import MappingProxyType
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from crdt_tpu_torch.api.doc import (
    ARRAY_METHODS,
    DocOpsMixin,
    WrongKindError,
    _as_list,
    _Observer,
)
from crdt_tpu_torch.codec import v1
from crdt_tpu_torch.core.ids import DeleteSet, StateVector
from crdt_tpu_torch.core.records import ItemRecord
from crdt_tpu_torch.core.store import (
    K_ANY,
    K_DELETED,
    K_FORMAT,
    K_GC,
    K_TYPE,
    NULL,
    TYPE_ARRAY,
)
from crdt_tpu_torch.models.incremental import IncrementalReplay
from crdt_tpu_torch.ops.staging import segkey_of


class _ResidentEngineShim:
    """The few ``doc.engine`` attributes the replica layer reads,
    answered from resident state (``Replica.compact``'s pending
    guard). Delete ranges are never pending here — the resident store
    records the full delete set immediately and every snapshot carries
    it — so only stashed rows gate compaction."""

    def __init__(self, replay: IncrementalReplay, client_id: int):
        self._replay = replay
        self.client_id = client_id
        self.pending_deletes = DeleteSet()

    @property
    def pending(self):
        return self._replay._pending

    # guard layer: the pending-budget contract (Engine parity) — the
    # replica layer sets the cap and drains evicted ranges through
    # ``doc.engine`` without caring which backend answers
    @property
    def pending_limit(self):
        return self._replay.pending_limit

    @pending_limit.setter
    def pending_limit(self, value) -> None:
        self._replay.pending_limit = value

    def take_evicted_ranges(self):
        return self._replay.take_evicted_ranges()

    def delete_set(self) -> DeleteSet:
        # the divergence sentinel's tombstone guard reads the full
        # recorded delete set (resident state records it immediately)
        return self._replay.ds


class ResidentCrdt(DocOpsMixin):
    """Drop-in :class:`crdt_tpu_torch.api.doc.Crdt` replacement backed
    by resident state. Constructor contract matches (the replica layer
    builds either without caring which); the name guard, observer
    registry, txn choreography, and batch queue come from the shared
    :class:`DocOpsMixin`. ``device`` is the replay's device, resolved
    at construction: with no card, the default raises there."""

    def __init__(
        self,
        client_id: int,
        *,
        observer_function: Optional[Callable[[dict], None]] = None,
        on_update: Optional[Callable[[bytes, dict], None]] = None,
        full_state_updates: bool = False,
        device_merge: Optional[bool] = None,  # accepted for signature parity
        device_min_rows: Optional[int] = None,
        capacity: int = 1 << 14,
        device="cuda",
    ):
        self._replay = IncrementalReplay(
            capacity=capacity, device_min_rows=device_min_rows,
            device=device,
        )
        self.client_id = client_id
        self.engine = _ResidentEngineShim(self._replay, client_id)
        self.observer_function = observer_function
        self.on_update = on_update
        self.full_state_updates = full_state_updates
        self.device_merge = True  # resident IS the device-resident mode
        self.root_kinds: Dict[str, str] = {}
        self._observers: List[_Observer] = []
        self._batched: List[Callable[[], Any]] = []
        # per-txn accumulators (one broadcast per op / per exec_batch)
        self._txn_records: List[ItemRecord] = []
        self._txn_ds = DeleteSet()
        self._txn_roots: set = set()
        self._txn_keys: Dict[str, set] = {}
        # per-sequence edit cursor: spec -> (k, row, epoch) where
        # ``row`` is the k-th visible item (1-based) as of the
        # segment's order ``epoch``. Indexed edits resolve their
        # anchors by walking FROM the cursor (O(|index - k|)) instead
        # of from the head (O(index)) — interactive editing is
        # position-local, so mid-document typing stays ~O(1) in doc
        # size. Any non-local mutation bumps the epoch and the cursor
        # falls back to one full scan.
        self._seq_cursor: Dict[Tuple, Tuple[int, int, int]] = {}

    # ------------------------------------------------------------------
    # cache / reads (same contract as Crdt)
    # ------------------------------------------------------------------
    @property
    def c(self):
        return MappingProxyType(self._replay.cache)

    def __getattr__(self, prop: str) -> Any:
        try:
            return self.__dict__["_replay"].cache[prop]
        except KeyError:
            raise AttributeError(prop) from None

    def __getitem__(self, prop: str) -> Any:
        return self._replay.cache[prop]

    def __contains__(self, prop: str) -> bool:
        return prop in self._replay.cache

    def __repr__(self) -> str:
        return f"ResidentCrdt(client={self.client_id}, c={self._replay.cache!r})"

    def get(self, name: str, key: Optional[str] = None) -> Any:
        if key is None:
            return copy.deepcopy(self._replay.cache.get(name))
        coll = self._replay.cache.get(name)
        if isinstance(coll, dict):
            return copy.deepcopy(coll.get(key))
        return None

    # ------------------------------------------------------------------
    # sync surface (served from resident state)
    # ------------------------------------------------------------------
    def state_vector(self) -> StateVector:
        return self._replay.state_vector()

    def encode_state_vector(self) -> bytes:
        return v1.encode_state_vector(self._replay.state_vector())

    def encode_state_as_update(self, sv: Optional[StateVector] = None) -> bytes:
        return self._replay.encode_state_as_update(sv)

    # ------------------------------------------------------------------
    # resident-state lookups (the Engine anchor equivalents)
    # ------------------------------------------------------------------
    def _sk(self, spec: Tuple, key: Optional[str]) -> Optional[int]:
        """Segkey of (parent spec, map key | sequence) without creating
        interner entries."""
        r = self._replay
        pref = r._prefs.get(spec)
        if pref is None:
            return None
        if key is None:
            kid = -1
        else:
            kid = r._keys.get(key)
            if kid is None:
                return None
        return int(segkey_of(np.int64(pref), np.int64(kid)))

    def _row_deleted(self, row: int) -> bool:
        r = self._replay
        return r.ds.contains(
            int(r.cols.col("client")[row]), int(r.cols.col("clock")[row])
        )

    def _row_id(self, row: int) -> Tuple[int, int]:
        r = self._replay
        return (
            int(r.cols.col("client")[row]),
            int(r.cols.col("clock")[row]),
        )

    def _tail_row(self, spec: Tuple, key: str) -> Optional[int]:
        sk = self._sk(spec, key)
        return None if sk is None else self._replay._win.get(sk)

    def _order_rows(self, spec: Tuple) -> List[int]:
        sk = self._sk(spec, None)
        return [] if sk is None else self._replay.order_list(sk)

    def _iter_rows(self, spec: Tuple):
        """Forward document-order iteration — O(1) per step on linked
        segments, no stale-list materialization."""
        sk = self._sk(spec, None)
        if sk is not None:
            yield from self._replay.iter_order(sk)

    def _countable(self, row: int) -> bool:
        kind = int(self._replay.cols.col("kind")[row])
        if kind in (K_DELETED, K_GC, K_FORMAT):
            return False
        return not self._row_deleted(row)

    def _visible_left(self, spec: Tuple, index: int) -> Optional[int]:
        """Row of the (index-1)-th visible item (Engine._visible_left).

        Resolution is cursor-local: the last indexed edit's anchor
        position is cached per sequence (epoch-validated against the
        replay's order epoch), so a run of nearby edits walks
        O(position delta) links instead of O(index) from the head."""
        if index <= 0:
            return None
        sk = self._sk(spec, None)
        r = self._replay
        if sk is not None:
            cur = self._seq_cursor.get(spec)
            if cur is not None:
                ck, crow, epoch = cur
                if epoch == r.order_epoch(sk):
                    row = self._walk_from_cursor(sk, ck, crow, index)
                    if row is not None:
                        self._seq_cursor[spec] = (
                            index, row, r.order_epoch(sk)
                        )
                        return row
        seen = 0
        for row in self._iter_rows(spec):
            if self._countable(row):
                seen += 1
                if seen == index:
                    if sk is not None:
                        self._seq_cursor[spec] = (
                            index, row, r.order_epoch(sk)
                        )
                    return row
        raise IndexError(f"index {index} out of range (len={seen})")

    def _walk_from_cursor(
        self, sk: int, ck: int, crow: int, index: int
    ) -> Optional[int]:
        """The index-th visible row, walking from the validated cursor
        (crow = ck-th visible). Returns None when the backward walk
        cannot satisfy the cursor's own claim (callers re-scan);
        raises IndexError when the document really is too short."""
        r = self._replay
        if index == ck:
            return crow
        if index > ck:
            seen = ck
            for row in r.iter_order_after(sk, crow):
                if self._countable(row):
                    seen += 1
                    if seen == index:
                        return row
            raise IndexError(
                f"index {index} out of range (len={seen})"
            )
        need = ck - index
        for prev in r.iter_order_before(sk, crow):
            if self._countable(prev):
                need -= 1
                if need == 0:
                    return prev
        return None

    def _right_of(self, spec: Tuple, left: Optional[int]) -> Optional[int]:
        """The item immediately after ``left`` in FULL order, tombstones
        included (Engine's ``_next``) — or the head when left is None.
        O(1) on linked segments."""
        sk = self._sk(spec, None)
        if sk is None:
            return None
        if left is None:
            for row in self._replay.iter_order(sk):
                return row
            return None
        return self._replay.order_next_row(sk, left)

    def _append_anchor(self, spec: Tuple) -> Optional[int]:
        """Last countable row — the left anchor of an append — found by
        scanning from the TAIL (O(trailing tombstones), usually O(1),
        vs the head scan's O(document))."""
        sk = self._sk(spec, None)
        if sk is None:
            return None
        for row in self._replay.iter_order_reversed(sk):
            if self._countable(row):
                return row
        return None

    # ------------------------------------------------------------------
    # record building: each primitive allocates clocks, SELF-APPLIES
    # through the replay (one blob), and accumulates for the broadcast
    # ------------------------------------------------------------------
    def _alloc_clock(self) -> int:
        return self._replay._next_clock.get(self.client_id, 0)

    def _apply_own(self, recs: List[ItemRecord],
                   ds: Optional[DeleteSet] = None) -> None:
        r = self._replay
        # direct admission: no per-op v1 encode/decode round-trip —
        # the broadcast blob is built once per txn in _finish_txn;
        # admit_local itself falls back to the exact blob path when its
        # preflight fails
        r.admit_local(recs, ds)
        for rec in recs:
            if (rec.client, rec.clock) not in r._id_row:
                raise AssertionError("local op must always be integrable")
        self._txn_records.extend(recs)
        if ds is not None:
            for c, k, n in ds.iter_all():
                self._txn_ds.add(c, k, n)
        self._txn_roots.update(r.last_touched_roots)
        for root, keys in r.last_touched_keys.items():
            self._txn_keys.setdefault(root, set()).update(keys)

    def _parent_kw(self, name: str, spec: Tuple) -> dict:
        if spec[0] == "root":
            return {"parent_root": name, "parent_item": None}
        return {"parent_root": None, "parent_item": (spec[1], spec[2])}

    def _map_set(self, name: str, spec: Tuple, key: str, value: Any,
                 *, kind: int = K_ANY,
                 type_ref: int = TYPE_ARRAY) -> ItemRecord:
        tail = self._tail_row(spec, key)
        origin = self._row_id(tail) if tail is not None else None
        rec = ItemRecord(
            client=self.client_id,
            clock=self._alloc_clock(),
            key=key,
            origin=origin,
            right=None,
            kind=kind,
            type_ref=type_ref if kind == K_TYPE else NULL,
            content=copy.deepcopy(value) if kind != K_TYPE else None,
            **self._parent_kw(name, spec),
        )
        self._apply_own([rec])
        return rec

    def _map_delete(self, spec: Tuple, key: str) -> bool:
        tail = self._tail_row(spec, key)
        if tail is None or self._row_deleted(tail):
            return False
        ds = DeleteSet()
        ds.add(*self._row_id(tail))
        self._apply_own([], ds)
        return True

    def _seq_insert(self, name: str, spec: Tuple, index: Optional[int],
                    values: List[Any]) -> None:
        """All values of one insert go out as ONE chained record run in
        ONE blob/apply: value k's origin is value k-1's id and every
        record shares the insertion point's right anchor. This is
        exact — a brand-new id cannot be any concurrent item's origin,
        so each chained record integrates immediately after its
        predecessor with no conflict scan the intermediate state could
        influence (the engine's per-value ``_next`` walk reduces to the
        same placement). ``index=None`` means append: the left anchor
        comes from a tail scan instead of a head walk (O(1) for the
        keystroke path instead of O(document))."""
        if index is None:
            left = self._append_anchor(spec)
        else:
            left = self._visible_left(spec, index)
        right = self._right_of(spec, left)
        right_id = self._row_id(right) if right is not None else None
        origin = self._row_id(left) if left is not None else None
        clock = self._alloc_clock()
        recs = []
        for v in values:
            rec = ItemRecord(
                client=self.client_id,
                clock=clock,
                key=None,
                origin=origin,
                right=right_id,
                kind=K_ANY,
                content=copy.deepcopy(v),
                **self._parent_kw(name, spec),
            )
            recs.append(rec)
            origin = (rec.client, rec.clock)
            clock += 1
        if recs:
            self._apply_own(recs)
            if index is not None:
                # the run's last row is now the (index+V)-th visible
                # item: seed the cursor there so the next nearby edit
                # walks O(delta) instead of O(index)
                sk = self._sk(spec, None)
                last = self._replay._id_row.get(
                    (recs[-1].client, recs[-1].clock)
                )
                if sk is not None and last is not None:
                    self._seq_cursor[spec] = (
                        index + len(recs), last,
                        self._replay.order_epoch(sk),
                    )

    def _seq_delete(self, spec: Tuple, index: int, length: int) -> int:
        if index < 0 or length <= 0:
            # Engine.seq_delete deletes nothing here; the reference's
            # resident copy deleted every item from the index (or from
            # the head) on, so the two merge modes disagreed
            return 0
        targets = []
        seen = 0
        try:
            anchor = (
                self._visible_left(spec, index) if index > 0 else None
            )
        except IndexError:
            return 0  # cut past the visible tail deletes nothing
        if anchor is not None:
            sk = self._sk(spec, None)
            it = self._replay.iter_order_after(sk, anchor)
            seen = index
        else:
            it = self._iter_rows(spec)
        for row in it:
            if not self._countable(row):
                continue
            if seen >= index:
                targets.append(row)
                if len(targets) == length:
                    break
            seen += 1
        if not targets:
            return 0
        ds = DeleteSet()
        for row in targets:
            ds.add(*self._row_id(row))
        self._apply_own([], ds)
        if anchor is not None:
            # the delete bumped the epoch, but every deleted row sits
            # strictly AFTER the anchor — its visible rank is intact,
            # so reseed the cursor instead of forcing the next edit
            # (type-backspace-type is the common keystroke mix) back
            # to a full head scan
            sk = self._sk(spec, None)
            if sk is not None:
                self._seq_cursor[spec] = (
                    index, anchor, self._replay.order_epoch(sk)
                )
        return len(targets)

    # ------------------------------------------------------------------
    # txn plumbing (the per-op broadcast tail, crdt.js:440-447;
    # _run_op and the batch queue live in DocOpsMixin)
    # ------------------------------------------------------------------
    def _begin_txn(self) -> None:
        self._txn_records = []
        self._txn_ds = DeleteSet()
        self._txn_roots = set()
        self._txn_keys = {}

    def _finish_txn(
        self,
        origin: str,
        meta: Optional[dict] = None,
        propagate: bool = True,
        want_update: bool = False,
    ) -> Optional[bytes]:
        update = None
        emitting = (
            propagate and self.on_update is not None and origin == "local"
        )
        if (self._txn_records or self._txn_ds.ranges) and (
            emitting or want_update
        ):
            if self.full_state_updates:
                update = self.encode_state_as_update()
            else:
                update = v1.encode_update(self._txn_records, self._txn_ds)
            if emitting:
                self.on_update(update, meta or {})
        self._fire_observers(
            sorted(self._txn_roots), self._txn_keys, origin
        )
        return update

    def _fire_observers(self, touched, touched_keys, origin) -> None:
        if not touched:
            return
        if self.observer_function is None and not self._observers:
            # no listeners: do not force the lazy cache to materialize
            # (the firehose steady state depends on this)
            return
        cache = self._replay.cache
        event = {
            "origin": origin,
            "touched": list(touched),
            "c": MappingProxyType(dict(cache)),
        }
        if self.observer_function is not None:
            self.observer_function(event)
        for ob in self._observers:
            if ob.name not in touched:
                continue
            if ob.key is not None:
                if ob.key not in touched_keys.get(ob.name, ()):
                    continue
                coll = cache.get(ob.name)
                value = (
                    copy.deepcopy(coll.get(ob.key))
                    if isinstance(coll, dict) else None
                )
                ob.func(
                    {**event, "name": ob.name, "key": ob.key, "value": value}
                )
            else:
                value = copy.deepcopy(cache.get(ob.name))
                ob.func({**event, "name": ob.name, "value": value})

    # ------------------------------------------------------------------
    # guards (name guard shared via DocOpsMixin)
    # ------------------------------------------------------------------
    def _ix_value(self, name: str) -> Optional[str]:
        tail = self._tail_row(("root", "ix"), name)
        if tail is None or self._row_deleted(tail):
            return None
        return self._replay.cols.contents[tail]

    def _kind_of(self, name: str) -> Optional[str]:
        kind = self._ix_value(name)
        if kind is not None:
            return kind
        return self.root_kinds.get(name)

    def _check_kind(self, name: str, want: str) -> None:
        kind = self._kind_of(name)
        if kind is not None and kind != want:
            raise WrongKindError(f"'{name}' is a {kind}, not a {want}")

    def _register(self, name: str, kind: str) -> None:
        if self._ix_value(name) is None:
            self._map_set("ix", ("root", "ix"), name, kind)
            self.root_kinds[name] = kind

    # ------------------------------------------------------------------
    # collection creation + map ops (crdt.js:363-477)
    # ------------------------------------------------------------------
    def map(self, name: str, batch: bool = False):
        self._check_name(name)

        def operation():
            self._check_kind(name, "map")
            self._register(name, "map")
            return name

        return self._run_op(batch, operation)

    def array(self, name: str, batch: bool = False):
        self._check_name(name)

        def operation():
            self._check_kind(name, "array")
            self._register(name, "array")
            return name

        return self._run_op(batch, operation)

    def set(
        self,
        name: str,
        key: str,
        value: Any = None,
        *,
        array_method: Optional[str] = None,
        index: Optional[int] = None,
        length: Optional[int] = None,
        batch: bool = False,
    ) -> Any:
        self._check_name(name)
        if not isinstance(key, str) or not key:
            raise ValueError("key must be a non-empty string")
        if array_method is not None and array_method not in ARRAY_METHODS:
            raise ValueError(f"array_method must be one of {ARRAY_METHODS}")
        if array_method == "insert" and index is None:
            raise ValueError("insert requires index")
        if array_method == "cut" and index is None:
            raise ValueError("cut requires index")

        def operation():
            self._check_kind(name, "map")
            self._register(name, "map")
            root = ("root", name)
            if array_method is None:
                self._map_set(name, root, key, value)
                return value
            # nested array under the key (crdt.js:422-432)
            spec = None
            tail = self._tail_row(root, key)
            if (
                tail is not None
                and not self._row_deleted(tail)
                and int(self._replay.cols.col("kind")[tail]) == K_TYPE
            ):
                spec = ("item",) + self._row_id(tail)
            if spec is None:
                rec = self._map_set(
                    name, root, key, None, kind=K_TYPE, type_ref=TYPE_ARRAY
                )
                spec = ("item", rec.client, rec.clock)
            if array_method == "insert":
                self._seq_insert(name, spec, index, _as_list(value))
            elif array_method == "push":
                self._seq_insert(name, spec, None, _as_list(value))
            elif array_method == "unshift":
                self._seq_insert(name, spec, 0, _as_list(value))
            else:  # cut
                self._seq_delete(
                    spec, index, length if length is not None else 1
                )
            coll = self._replay.cache.get(name)
            return (
                copy.deepcopy(coll.get(key))
                if isinstance(coll, dict) else None
            )

        return self._run_op(batch, operation)

    def delete(self, name: str, key: str, batch: bool = False) -> Any:
        self._check_name(name)

        def operation():
            self._check_kind(name, "map")
            return self._map_delete(("root", name), key)

        return self._run_op(batch, operation)

    del_ = delete

    # ------------------------------------------------------------------
    # array ops (crdt.js:485-617)
    # ------------------------------------------------------------------
    def _seq_op(self, name: str, batch: bool, body: Callable[[], Any]) -> Any:
        self._check_name(name)

        def operation():
            self._check_kind(name, "array")
            self._register(name, "array")
            return body()

        return self._run_op(batch, operation)

    def insert(self, name: str, index: int, value: Any, batch: bool = False):
        vals = _as_list(value)
        return self._seq_op(
            name, batch,
            lambda: self._seq_insert(name, ("root", name), index, vals),
        )

    def push(self, name: str, value: Any, batch: bool = False):
        vals = _as_list(value)
        return self._seq_op(
            name, batch,
            lambda: self._seq_insert(name, ("root", name), None, vals),
        )

    def unshift(self, name: str, value: Any, batch: bool = False):
        vals = _as_list(value)
        return self._seq_op(
            name, batch,
            lambda: self._seq_insert(name, ("root", name), 0, vals),
        )

    def cut(self, name: str, index: int, length: int = 1, batch: bool = False):
        return self._seq_op(
            name, batch,
            lambda: self._seq_delete(("root", name), index, length),
        )

    # ------------------------------------------------------------------
    # remote updates (crdt.js:292-311) — the same path local ops take
    # ------------------------------------------------------------------
    def apply_update(self, data: bytes, origin: str = "remote") -> None:
        self.apply_updates([data], origin)

    def apply_updates(self, datas, origin: str = "remote") -> None:
        if not datas:
            return
        r = self._replay
        r.apply(list(datas))
        self._fire_observers(
            r.last_touched_roots, r.last_touched_keys, origin
        )

