"""Document/API layer — the reference's public surface (L4+L5).

The port's copy of ``crdt_tpu.api.doc``: the same ops over the port's
scalar :class:`crdt_tpu_torch.core.engine.Engine`, emitting the same
update blobs byte for byte. Merges run on the host engine, as the
reference's scalar mode does; the reference's ``device_merge=True``
(``core.device_apply``, a kernel rebuild of the engine's chains) is not
ported yet, and asking for it raises (:data:`DEVICE_MERGE_ITEM`).

Reproduces the op layer and friendly API of the reference library
(``crdt.js:325-702``): named map/array collections over one shared
document, a plain-JSON read cache ``c`` with attribute
fallthrough (the reference's Proxy, crdt.js:688-693), a batch queue
drained by ``exec_batch`` in a single transaction (crdt.js:325-355),
an index map ``ix`` registering collection kinds (crdt.js:201,205),
and per-collection observers (crdt.js:620-657).

Documented divergences from the reference (SURVEY.md §6 — all defects
fixed rather than replicated):

- D1: non-batch ``unshift``/``cut`` actually mutate (the reference's
  else-branch skips ``operation()``, crdt.js:583-588,609-614).
- D2: nested-array validation works (the reference calls the
  nonexistent ``Array.prototype.contains``, crdt.js:411).
- D3: collections created remotely appear in the cache (the reference
  iterates its own stale index, crdt.js:297-305).
- D4: ``exec_batch`` on an empty queue returns instead of hanging
  (crdt.js:330-331).
- D7: ``get`` exists (README.md:83 promises it, the code lacks it);
  ``insert`` takes ``(name, index, value)`` in the README's order
  (the code's is val-then-index, crdt.js:521).
- Q1: observers fire on local mutations too, tagged with ``origin``
  (the reference only fires on remote updates, crdt.js:308-310).
- Q2: updates emitted per op are true deltas (new items + delete-set
  delta of the transaction); ``full_state_updates=True`` restores the
  reference's full-state-per-op broadcast behavior (crdt.js:443).
"""

from __future__ import annotations

import copy
from types import MappingProxyType
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from crdt_tpu_torch.codec import v1
from crdt_tpu_torch.core.engine import Engine, ParentSpec  # noqa: F401 — ParentSpec is part of the Doc API surface
from crdt_tpu_torch.core.ids import DeleteSet, StateVector
from crdt_tpu_torch.core.store import NO_KEY, NULL, TYPE_ARRAY

# names the reference refuses to use as collection names (crdt.js:320,365)
RESERVED_NAMES = ("ix", "doc")

ARRAY_METHODS = ("insert", "push", "unshift", "cut")

# where the engine-backed device merge (the reference's
# core.device_apply) is queued
DEVICE_MERGE_ITEM = (
    "ROADMAP.md queue A item 7 (resident full-converge and engine rebuild)"
)


class ReservedNameError(ValueError):
    pass


class WrongKindError(TypeError):
    pass


def _as_list(value: Any) -> list:
    """Scalar -> single-element list (the reference's push wrap,
    crdt.js:554); lists pass through."""
    return value if isinstance(value, list) else [value]


class _Observer:
    __slots__ = ("name", "key", "func")

    def __init__(self, name: str, key: Optional[str], func: Callable):
        self.name = name
        self.key = key
        self.func = func


class DocOpsMixin:
    """Backend-independent op plumbing shared by the engine-backed
    :class:`Crdt` and the resident-backed
    :class:`crdt_tpu_torch.api.resident_doc.ResidentCrdt`: the reserved-name
    guard, the observer registry, the txn-exception choreography, and
    the batch queue. Subclasses supply ``_begin_txn()`` and
    ``_finish_txn(origin, meta=None, propagate=True,
    want_update=False)`` plus ``_batched`` / ``_observers`` lists."""

    def _check_name(self, name: str) -> None:
        if not isinstance(name, str) or not name:
            raise ValueError("collection name must be a non-empty string")
        if name in RESERVED_NAMES:
            raise ReservedNameError(
                f"'{name}' is reserved (crdt.js:320,365)"
            )

    # ---- op plumbing (the per-op tail, crdt.js:440-447) --------------
    def _run_op(self, batch: bool, operation: Callable[[], Any]) -> Any:
        if batch:
            self._batched.append(operation)
            return None
        self._begin_txn()
        try:
            result = operation()
        except BaseException:
            # a throwing op still commits what it integrated (Yjs txn
            # semantics): the records exist with allocated clocks, so
            # not broadcasting them would wedge every peer on a
            # per-client clock gap forever — but the op's own error
            # must win over any broadcast-tail error
            try:
                self._finish_txn(origin="local")
            except Exception:
                pass
            raise
        self._finish_txn(origin="local")
        return result

    # ---- batch queue (crdt.js:325-355) -------------------------------
    def exec_batch(self, propagate: bool = True) -> Optional[bytes]:
        """Drain queued ops in one transaction → one update (one
        broadcast). Empty queue returns None (D4: the reference hangs).

        ``propagate=False`` mirrors ``throughDatabase``
        (crdt.js:350-353): the update is returned without invoking
        ``on_update``.
        """
        if not self._batched:
            return None
        ops, self._batched = self._batched, []
        self._begin_txn()
        try:
            for op in ops:
                op()
        except BaseException:
            # partial batches commit what ran before the throw (see
            # _run_op: unbroadcast records would wedge peers)
            try:
                self._finish_txn(
                    "local",
                    meta={"meta": "batch"},
                    propagate=propagate,
                    want_update=True,
                )
            except Exception:
                pass
            raise
        return self._finish_txn(
            "local",
            meta={"meta": "batch"},
            propagate=propagate,
            want_update=True,
        )

    @property
    def pending_batch_size(self) -> int:
        return len(self._batched)

    # ---- observers (crdt.js:620-657) ---------------------------------
    def observe(self, name: str, func: Callable, key: Optional[str] = None):
        self._observers.append(_Observer(name, key, func))
        return func

    def unobserve(self, func: Callable) -> bool:
        before = len(self._observers)
        self._observers = [o for o in self._observers if o.func is not func]
        return len(self._observers) < before


class Crdt(DocOpsMixin):
    """One replica's document + API.

    Transport and persistence attach through two hooks:

    - ``on_update(update_bytes, meta)`` — called after every non-batch
      op and every ``exec_batch`` with the encoded v1 update (the
      reference's persist+propagate tail, crdt.js:442-446).
    - ``observer_function(event)`` — the reference's coarse observer
      (crdt.js:308-310), fired with a dict carrying the frozen cache.

    ``device_merge=True`` raises ``NotImplementedError`` here, at
    construction: its merges would otherwise go down the host engine
    without a word.
    """

    def __init__(
        self,
        client_id: int,
        *,
        observer_function: Optional[Callable[[dict], None]] = None,
        on_update: Optional[Callable[[bytes, dict], None]] = None,
        full_state_updates: bool = False,
        device_merge: Optional[bool] = None,
    ):
        # CRDT_TPU_DEVICE is a PRODUCT-level knob consumed by the
        # replica layer, where it selects merge_mode="resident"
        # (net/replica.py). The standalone Crdt keeps the engine device
        # gate strictly explicit — one env var must not mean different
        # things at different layers.
        if device_merge:
            raise NotImplementedError(
                f"Crdt(device_merge=True) is not ported yet "
                f"({DEVICE_MERGE_ITEM}); merges run on the host engine "
                "with device_merge=False"
            )
        self.device_merge = False
        self.engine = Engine(client_id)
        self.observer_function = observer_function
        self.on_update = on_update
        self.full_state_updates = full_state_updates
        self._c: Dict[str, Any] = {}
        self._batched: List[Callable[[], Any]] = []
        self._observers: List[_Observer] = []
        self._known_len = 0  # root_kinds size at last D3 backfill

    # ------------------------------------------------------------------
    # cache / reads (the reference's Proxy + frozen `c`, crdt.js:661-702)
    # ------------------------------------------------------------------
    @property
    def c(self):
        """Read-only snapshot cache (``Object.freeze({...c})``)."""
        return MappingProxyType(self._c)

    def __getattr__(self, prop: str) -> Any:
        # Proxy fallthrough: unknown property reads hit the cache
        # (crdt.js:691: `return target.c[prop]`)
        try:
            return self.__dict__["_c"][prop]
        except KeyError:
            raise AttributeError(prop) from None

    def __getitem__(self, prop: str) -> Any:
        return self._c[prop]

    def __contains__(self, prop: str) -> bool:
        return prop in self._c

    def __repr__(self) -> str:
        # the reference's custom inspect prints the cache (crdt.js:696)
        return f"Crdt(client={self.engine.client_id}, c={self._c!r})"

    def get(self, name: str, key: Optional[str] = None) -> Any:
        """Visible value — the method README.md:83 documents but the
        reference never shipped (D7)."""
        if key is None:
            return copy.deepcopy(self._c.get(name))
        return copy.deepcopy(self.engine.map_get(name, key))

    def state_vector(self) -> StateVector:
        return self.engine.state_vector()

    def encode_state_vector(self) -> bytes:
        return v1.encode_state_vector_of(self.engine)

    def encode_state_as_update(self, sv: Optional[StateVector] = None) -> bytes:
        return v1.encode_state_as_update(self.engine, sv)

    # ------------------------------------------------------------------
    # guards
    # ------------------------------------------------------------------
    def _kind_of(self, name: str) -> Optional[str]:
        kind = self.engine.map_get("ix", name)
        if kind is not None:
            return kind
        return self.engine.root_kinds.get(name)

    def _check_kind(self, name: str, want: str) -> None:
        kind = self._kind_of(name)
        if kind is not None and kind != want:
            raise WrongKindError(f"'{name}' is a {kind}, not a {want}")

    # ------------------------------------------------------------------
    # op plumbing (the per-op tail, crdt.js:440-447; _run_op and the
    # batch queue live in DocOpsMixin)
    # ------------------------------------------------------------------
    def _begin_txn(self) -> None:
        self.engine.begin_txn()

    def _finish_txn(
        self,
        origin: str,
        meta: Optional[dict] = None,
        propagate: bool = True,
        want_update: bool = False,
    ) -> Optional[bytes]:
        eng = self.engine
        # last_txn_items lists exactly this txn's rows: O(txn), not the
        # O(doc) scan records_since would do
        new_records = eng.records_for_rows(eng.last_txn_items)
        txn_deletes = eng.last_txn_deletes
        touched, touched_keys = self._touched_roots()
        self._refresh_cache(touched, touched_keys)
        update = None
        emitting = propagate and self.on_update is not None and origin == "local"
        if (new_records or txn_deletes.ranges) and (emitting or want_update):
            if self.full_state_updates:
                update = v1.encode_state_as_update(eng)  # Q2 compat mode
            else:
                update = v1.encode_update(new_records, txn_deletes)
            # broadcast BEFORE observers: a throwing observer must not
            # abort the emission, or peers wedge on the clock gap
            if emitting:
                self.on_update(update, meta or {})
        self._fire_observers(touched, touched_keys, origin)
        return update

    def _touched_roots(self) -> Tuple[List[str], Dict[str, set]]:
        """Roots touched by the last txn, plus per-root changed top-level
        keys (the key of the item directly under the root — nested
        edits roll up to the map key holding the nested type)."""
        eng = self.engine
        s = eng.store
        roots: set = set()
        keys: Dict[str, set] = {}
        rows = list(eng.last_txn_items)
        for client, clock, length in eng.last_txn_deletes.iter_all():
            for k in range(clock, clock + length):
                row = s.find(client, k)
                if row is not None:
                    rows.append(row)
        for row in rows:
            root, key = self._classify_row(row)
            if root is not None:
                roots.add(root)
                if key is not None:
                    keys.setdefault(root, set()).add(key)
        return sorted(roots), keys

    def _classify_row(self, row: int) -> Tuple[Optional[str], Optional[str]]:
        """(root name, top-level map key) of a row, walking up nested
        parents; key is None for sequence members of a root array."""
        s = self.engine.store
        seen = set()
        while row is not None and row not in seen:
            seen.add(row)
            if s.parent_root[row] != NULL:
                root = s.root_names[int(s.parent_root[row])]
                kid = int(s.key_id[row])
                return root, (s.keys[kid] if kid != NO_KEY else None)
            if s.parent_client[row] == NULL:
                return None, None  # GC filler — no positional info
            row = s.find(int(s.parent_client[row]), int(s.parent_clock[row]))
        return None, None

    def _refresh_cache(
        self,
        roots: Sequence[str],
        touched_keys: Optional[Dict[str, set]] = None,
    ) -> None:
        eng = self.engine
        for name in roots:
            if name == "ix":
                continue
            kind = self._kind_of(name)
            # deep-copied: cache values must not alias live store
            # content, or `crdt.c['m']['k'].append(...)` would mutate
            # CRDT state without an op and diverge replicas
            if kind == "array":
                self._c[name] = copy.deepcopy(eng.seq_json(name))
            elif kind == "map":
                keys = (touched_keys or {}).get(name)
                cur = self._c.get(name)
                if keys is None or None in keys or not isinstance(cur, dict):
                    # unknown per-key delta (or first materialization):
                    # full rebuild
                    self._c[name] = copy.deepcopy(eng.map_json(name))
                    continue
                # per-key incremental refresh: O(changed keys), not
                # O(map) — r1 deep-copied whole collections per txn.
                # Rebound (not mutated): stored observer events hold
                # the previous snapshot dict. Like the reference's
                # SHALLOW Object.freeze({...c}) (crdt.js:668-670),
                # snapshots are isolated from CRDT-driven change, not
                # from callers mutating nested values — cache values
                # are read-only by contract (and unchanged keys were
                # always shared across snapshots for untouched roots)
                new = dict(cur)
                for k in keys:
                    if eng.map_has(name, k):
                        new[k] = copy.deepcopy(eng.map_get(name, k))
                    else:
                        new.pop(k, None)
                self._c[name] = new
        # D3 fix: collections created remotely get cache entries too.
        # New collections only appear when the txn touched the index
        # map or integrated items under a new root, so the O(known)
        # backfill is skipped on hot single-collection txns.
        if "ix" in roots or len(eng.root_kinds) != self._known_len:
            self._known_len = len(eng.root_kinds)
            known = set(eng.map_json("ix").keys()) | set(eng.root_kinds.keys())
            known.discard("ix")
            for name in known:
                if name not in self._c:
                    kind = self._kind_of(name)
                    self._c[name] = copy.deepcopy(
                        eng.seq_json(name) if kind == "array" else eng.map_json(name)
                    )

    def _fire_observers(
        self,
        touched: Sequence[str],
        touched_keys: Dict[str, set],
        origin: str,
    ) -> None:
        if not touched:
            return  # no-op txns (incl. failed ops) emit no events
        event = {
            "origin": origin,
            "touched": list(touched),
            # snapshot, not a live view: later txns rebind cache
            # entries and must not retroactively mutate stored events
            # (the reference freezes a copy too: Object.freeze({...c}),
            # crdt.js:668-670)
            "c": MappingProxyType(dict(self._c)),
        }
        if self.observer_function is not None:
            # Q1 fix: fires on local mutations too, origin-tagged
            self.observer_function(event)
        for ob in self._observers:
            if ob.name in touched:
                if ob.key is not None:
                    # per-key observers fire only when their key changed
                    # (the reference attaches to h[name][key],
                    # crdt.js:622-638)
                    if ob.key not in touched_keys.get(ob.name, ()):
                        continue
                    # deep-copied: observers must not be able to mutate
                    # live store content (see _refresh_cache)
                    value = copy.deepcopy(self.engine.map_get(ob.name, ob.key))
                    ob.func({**event, "name": ob.name, "key": ob.key, "value": value})
                else:
                    # deep-copied like the key path: observers must not
                    # mutate the cached snapshot. (event["c"] itself is
                    # the shallow-frozen view, matching the reference's
                    # Object.freeze({...c}) — crdt.js:668-670.)
                    value = copy.deepcopy(self._c.get(ob.name))
                    ob.func({**event, "name": ob.name, "value": value})

    # ------------------------------------------------------------------
    # collection creation (crdt.js:363-390, 485-512)
    # ------------------------------------------------------------------
    def map(self, name: str, batch: bool = False):
        self._check_name(name)

        def operation():
            # kind check at execution time: a queued or remote op may
            # have registered the name since this op was queued
            self._check_kind(name, "map")
            if self.engine.map_get("ix", name) is None:
                self.engine.map_set("ix", name, "map")
                self.engine.root_kinds[name] = "map"
                self._c.setdefault(name, {})
            return name

        return self._run_op(batch, operation)

    def array(self, name: str, batch: bool = False):
        self._check_name(name)

        def operation():
            self._check_kind(name, "array")
            if self.engine.map_get("ix", name) is None:
                self.engine.map_set("ix", name, "array")
                self.engine.root_kinds[name] = "array"
                self._c.setdefault(name, [])
            return name

        return self._run_op(batch, operation)

    # ------------------------------------------------------------------
    # map ops (crdt.js:400-477)
    # ------------------------------------------------------------------
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
        """Set ``key`` in map ``name``; with ``array_method`` operate on a
        nested array stored under the key (crdt.js:422-432).

        Nested mode (D2 fixed — the reference's validation throws):
        ``array_method`` ∈ insert/push/unshift/cut; ``index``/``length``
        qualify insert and cut.
        """
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
            eng = self.engine
            self._check_kind(name, "map")  # execution-time (see map())
            if eng.map_get("ix", name) is None:
                eng.map_set("ix", name, "map")  # auto-create (crdt.js:418-421)
                eng.root_kinds[name] = "map"
            if array_method is None:
                eng.map_set(name, key, value)
                return value
            spec = eng.map_entry_spec(name, key)
            if spec is None:
                rec = eng.map_set_type(name, key, TYPE_ARRAY)
                spec = ("item", rec.client, rec.clock)
            if array_method == "insert":
                eng.seq_insert(name, index, _as_list(value), parent=spec)
            elif array_method == "push":
                n = eng.seq_len(parent=spec)
                eng.seq_insert(name, n, _as_list(value), parent=spec)
            elif array_method == "unshift":
                eng.seq_insert(name, 0, _as_list(value), parent=spec)
            else:  # cut
                eng.seq_delete(
                    name,
                    index,
                    length if length is not None else 1,
                    parent=spec,
                )
            return copy.deepcopy(eng.map_get(name, key))

        return self._run_op(batch, operation)

    def delete(self, name: str, key: str, batch: bool = False) -> Any:
        """Delete ``key`` from map ``name`` (the reference's ``del``,
        crdt.js:459-477; ``del`` is a Python keyword)."""
        self._check_name(name)

        def operation():
            self._check_kind(name, "map")
            return self.engine.map_delete(name, key)

        return self._run_op(batch, operation)

    # the reference's name, for API parity in dynamic call sites
    del_ = delete

    # ------------------------------------------------------------------
    # array ops (crdt.js:485-617)
    # ------------------------------------------------------------------
    def _seq_op(self, name: str, batch: bool, body: Callable[[], Any]) -> Any:
        self._check_name(name)

        def operation():
            eng = self.engine
            self._check_kind(name, "array")  # execution-time (see map())
            if eng.map_get("ix", name) is None:
                eng.map_set("ix", name, "array")
                eng.root_kinds[name] = "array"
            return body()

        return self._run_op(batch, operation)

    def insert(self, name: str, index: int, value: Any, batch: bool = False):
        """Insert at index — README.md:87 argument order (D7; the
        reference code's is val-then-index, crdt.js:521)."""
        vals = _as_list(value)
        return self._seq_op(
            name, batch, lambda: self.engine.seq_insert(name, index, vals) and None
        )

    def push(self, name: str, value: Any, batch: bool = False):
        vals = _as_list(value)

        def body():
            n = self.engine.seq_len(name)
            self.engine.seq_insert(name, n, vals)

        return self._seq_op(name, batch, body)

    def unshift(self, name: str, value: Any, batch: bool = False):
        # D1 fix: the reference's non-batch unshift never mutates
        vals = _as_list(value)
        return self._seq_op(
            name, batch, lambda: self.engine.seq_insert(name, 0, vals) and None
        )

    def cut(self, name: str, index: int, length: int = 1, batch: bool = False):
        # D1 fix: the reference's non-batch cut never mutates
        return self._seq_op(
            name, batch, lambda: self.engine.seq_delete(name, index, length)
        )

    # ------------------------------------------------------------------
    # remote updates (crdt.js:292-311)
    # ------------------------------------------------------------------
    def apply_update(self, data: bytes, origin: str = "remote") -> None:
        self.apply_updates([data], origin)

    def apply_updates(self, datas: Sequence[bytes], origin: str = "remote") -> None:
        """Apply a batch of encoded updates as ONE merge transaction.

        This is the buffering gate of the north star: a sync backlog,
        a persistence log replay, or a gossip round's worth of updates
        decodes into one record union and pays one integration pass on
        the host engine, replacing the reference's per-update scalar
        loop (crdt.js:294).
        """
        if not datas:
            return
        all_records, all_ds = self._decode_batch(datas)
        self.engine.apply_records(all_records, all_ds)  # own txn
        touched, touched_keys = self._touched_roots()
        self._refresh_cache(touched, touched_keys)  # + D3 backfill
        self._fire_observers(touched, touched_keys, origin)

    @staticmethod
    def _decode_batch(datas: Sequence[bytes]):
        """Batch-decode updates, through the port's native C codec
        (``_v1codec_torch``) when the toolchain allows (one C pass for
        the whole backlog — the lib0/struct parsing that otherwise
        dominates log replays and sync bursts), falling back to the
        pure-Python codec. Both run on the host."""
        try:
            from crdt_tpu_torch.codec import native

            if native.available():
                # ValueError (malformed update) propagates: same
                # contract as the fallback below
                return native.decoded_to_records(
                    native.decode_updates_columns(datas)
                )
        except RuntimeError:
            pass  # toolchain raced away mid-call: fall back
        all_records: List[Any] = []
        all_ds = DeleteSet()
        for data in datas:
            records, ds = v1.decode_update(data)
            all_records.extend(records)
            for c, clk, length in ds.iter_all():
                all_ds.add(c, clk, length)
        return all_records, all_ds

