"""Columnar (struct-of-arrays) item store and its constants.

The port's copy of ``crdt_tpu.core.store``: the content-kind and
type-ref numbering shared by the codec, the records and the replay, and
:class:`ItemStore`, the scalar :class:`crdt_tpu_torch.core.engine.Engine`'s
row table (one unit item per (client, clock) row of interned integer
columns, contents in a host list). Numbering is identical, so decoded
columns mean the same thing in both packages.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from crdt_tpu_torch.core.ids import DeleteSet, StateVector

# content kinds (host-side; NOT the same numbering as wire content refs)
K_GC = 0
K_DELETED = 1
K_JSON = 2
K_BINARY = 3
K_STRING = 4
K_ANY = 5
K_TYPE = 6
# YText/subdoc payloads: carried for codec fidelity, not materialized
K_EMBED = 7
K_FORMAT = 8
K_DOC = 9

# Yjs type refs used by ContentType
TYPE_ARRAY = 0
TYPE_MAP = 1

ROOT_PARENT = -1
NO_KEY = -1
NULL = -1

_INT_COLS = (
    "client",
    "clock",
    "parent_root",
    "parent_client",
    "parent_clock",
    "key_id",
    "origin_client",
    "origin_clock",
    "right_client",
    "right_clock",
    "kind",
    "type_ref",
    "deleted",
)


class ItemStore:
    """Growable SoA table of unit items plus name/key interning."""

    def __init__(self, capacity: int = 1024):
        self._cap = max(capacity, 16)
        self.n = 0
        for col in _INT_COLS:
            setattr(self, col, np.full(self._cap, NULL, dtype=np.int64))
        self.content: List[Any] = []
        # interning tables; shared namespace semantics follow Yjs root types
        self.root_names: List[str] = []
        self._root_ids: Dict[str, int] = {}
        self.keys: List[str] = []
        self._key_ids: Dict[str, int] = {}
        self._id_index: Dict[Tuple[int, int], int] = {}
        # client -> rows in clock-ascending order (integration adds each
        # client's items with monotonically increasing clocks), so an
        # SV-diff can binary-search per client instead of scanning the
        # whole store (the reference recomputes full-doc diffs per sync,
        # crdt.js:288; at 100k items that is the difference between an
        # O(delta) and an O(doc) ready-probe)
        self.client_rows: Dict[int, List[int]] = {}

    # -- interning ---------------------------------------------------------
    def intern_root(self, name: str) -> int:
        rid = self._root_ids.get(name)
        if rid is None:
            rid = len(self.root_names)
            self.root_names.append(name)
            self._root_ids[name] = rid
        return rid

    def intern_key(self, key: str) -> int:
        kid = self._key_ids.get(key)
        if kid is None:
            kid = len(self.keys)
            self.keys.append(key)
            self._key_ids[key] = kid
        return kid

    def root_id(self, name: str) -> Optional[int]:
        return self._root_ids.get(name)

    def key_id_of(self, key: str) -> Optional[int]:
        return self._key_ids.get(key)

    # -- rows --------------------------------------------------------------
    def _grow(self) -> None:
        new_cap = self._cap * 2
        for col in _INT_COLS:
            arr = getattr(self, col)
            new = np.full(new_cap, NULL, dtype=np.int64)
            new[: self.n] = arr[: self.n]
            setattr(self, col, new)
        self._cap = new_cap

    def add_item(
        self,
        client: int,
        clock: int,
        *,
        parent_root: int = NULL,
        parent_id: Tuple[int, int] = (NULL, NULL),
        key_id: int = NO_KEY,
        origin: Tuple[int, int] = (NULL, NULL),
        right: Tuple[int, int] = (NULL, NULL),
        kind: int = K_ANY,
        type_ref: int = NULL,
        content: Any = None,
        deleted: bool = False,
    ) -> int:
        if (client, clock) in self._id_index:
            raise ValueError(f"duplicate item id ({client},{clock})")
        if self.n == self._cap:
            self._grow()
        i = self.n
        self.n += 1
        self.client[i] = client
        self.clock[i] = clock
        self.parent_root[i] = parent_root
        self.parent_client[i], self.parent_clock[i] = parent_id
        self.key_id[i] = key_id
        self.origin_client[i], self.origin_clock[i] = origin
        self.right_client[i], self.right_clock[i] = right
        self.kind[i] = kind
        self.type_ref[i] = type_ref
        self.deleted[i] = 1 if (deleted or kind in (K_DELETED, K_GC)) else 0
        self.content.append(content)
        self._id_index[(client, clock)] = i
        self.client_rows.setdefault(client, []).append(i)
        return i

    def find(self, client: int, clock: int) -> Optional[int]:
        return self._id_index.get((client, clock))

    def has(self, client: int, clock: int) -> bool:
        return (client, clock) in self._id_index

    def id_of(self, row: int) -> Tuple[int, int]:
        return (int(self.client[row]), int(self.clock[row]))

    def mark_deleted(self, row: int) -> None:
        self.deleted[row] = 1

    # -- aggregates --------------------------------------------------------
    def state_vector(self) -> StateVector:
        """Contiguous-prefix state vector: {client: k} claims clocks [0, k).

        Only the gap-free prefix per client is reported, so a store that
        received out-of-order clocks never claims knowledge it lacks
        (integration layers keep clocks contiguous via pending queues;
        this aggregate stays honest regardless). One vectorized pass.
        """
        sv = StateVector()
        if not self.n:
            return sv
        clients = self.client[: self.n]
        clocks = self.clock[: self.n]
        order = np.lexsort((clocks, clients))
        sc, sk = clients[order], clocks[order]
        starts = np.flatnonzero(np.r_[True, sc[1:] != sc[:-1]])
        ends = np.r_[starts[1:], len(sc)]
        # within each client segment, prefix length = #leading i with clock==i
        contiguous = sk == (np.arange(len(sk)) - np.repeat(starts, ends - starts))
        for s, e in zip(starts, ends):
            seg = contiguous[s:e]
            k = int(np.argmin(seg)) if not seg.all() else e - s
            if k:
                sv.clocks[int(sc[s])] = k
        return sv

    def delete_set(self) -> DeleteSet:
        """Vectorized: sort deleted (client, clock) rows, emit run ranges."""
        ds = DeleteSet()
        rows = np.flatnonzero(self.deleted[: self.n])
        if not len(rows):
            return ds
        clients = self.client[rows]
        clocks = self.clock[rows]
        order = np.lexsort((clocks, clients))
        sc, sk = clients[order], clocks[order]
        breaks = np.r_[True, (sc[1:] != sc[:-1]) | (sk[1:] != sk[:-1] + 1)]
        starts = np.flatnonzero(breaks)
        ends = np.r_[starts[1:], len(sc)]
        for s, e in zip(starts, ends):
            ds.ranges.setdefault(int(sc[s]), []).append(
                (int(sk[s]), int(sk[e - 1]) + 1)
            )
        return ds

    def columns(self) -> Dict[str, np.ndarray]:
        """Dense copies of the integer columns (length n) for device use."""
        return {col: getattr(self, col)[: self.n].copy() for col in _INT_COLS}

    def __len__(self) -> int:
        return self.n

    def __repr__(self) -> str:
        return (
            f"ItemStore(n={self.n}, roots={len(self.root_names)}, "
            f"keys={len(self.keys)})"
        )
