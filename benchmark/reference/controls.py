"""The controls: the plain reference put in the program's place with one
guarantee of the configuration broken, which the check must find.

Each is a ``program`` factory of its driver (``benchmark/drivers/``):
it takes the load driver, whose generated record tables it reads, and
returns an object with the entry points the window drives.

- ``replay``: a replay that drops every tombstone (the exact Yjs state
  is a guarantee of ``fanin_1k``);
- ``server``: a server whose reads miss the last write acknowledged
  to the record (``tenants_1k`` guarantees read-after-acknowledged-write;
  a record written only by its insert then reads as empty).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np

from benchmark.gen import wire
from benchmark.reference import yjs

_NO_DS = (np.zeros(0, np.int64),) * 3


class Replayed(NamedTuple):
    cache: dict
    snapshot: bytes
    n_ops: int


def replay(drv):
    t = drv.table
    out = Replayed(yjs.converge(t, _NO_DS), wire.encode_union(t, *_NO_DS),
                   len(t["client"]))
    return lambda blobs: out


class _Tick(NamedTuple):
    delta_docs: int = 0
    promotions: int = 0
    pool_dispatches: int = 0
    dispatches: int = 0
    fallback_docs: int = 0


class StaleReadServer:
    """Applies what it is given; a read answers from the doc's state
    before its last acknowledged update."""

    def __init__(self, drv):
        self.table = drv.table
        self.rows_of: Dict[bytes, object] = dict(zip(drv.first,
                                                     drv.first_rows))
        for _, blobs, rows in drv.warm:
            self.rows_of.update(zip(blobs, rows))
        self.rows_of.update(zip(drv.w_blobs, drv.w_rows))
        self.docs: Dict[str, List] = {}
        self.pending: List = []
        self.memo: Dict = {}

    def submit(self, doc, blob) -> int:
        self.pending.append((doc, self.rows_of[blob]))
        return 0

    def tick(self):
        for doc, rows in self.pending:
            self.docs.setdefault(doc, []).append(rows)
        self.pending.clear()
        return _Tick()

    def _cache(self, doc, k):
        key = (doc, k)
        if key not in self.memo:
            rows = self.docs[doc][:k]
            self.memo[key] = yjs.converge(
                wire.take(self.table, np.concatenate(rows)), _NO_DS) \
                if rows else {}
        return self.memo[key]

    def digest(self, doc) -> str:
        return yjs.digest(self._cache(doc, len(self.docs[doc]) - 1))

    def cache(self, doc) -> dict:
        return self._cache(doc, len(self.docs[doc]))


CONTROLS = {"replay": replay, "server": StaleReadServer}
