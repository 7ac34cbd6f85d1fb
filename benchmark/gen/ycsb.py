"""YCSB core-workload records as documents, and the writes to them.

A record of YCSB's core workload (``fieldcount`` fields of
``fieldlength`` bytes; ``CoreWorkload``'s defaults are 10 and 100) is
one document: a root map ``usertable`` whose keys ``field0``,
``field1``, ... hold the fields, each value a string of printable ASCII
as YCSB's ``RandomByteIterator`` draws them. Every record has its own
writer (client ``d + 1`` for record ``d``). Loading a record sets all
its fields (its insert: clocks 0 .. fieldcount - 1); an update sets one
field drawn uniformly (``writeallfields=false``) with a fresh value,
continuing the record's writer, with the field's current item as its
left origin, as ``YMap.set`` writes it. The record tables are
:mod:`benchmark.gen.wire`'s, with the values in a ``text`` column.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

ROOT = "usertable"


class Records:
    """Records 0 .. ``n`` - 1 (loaded or inserted later) of ``fields``
    fields of ``length`` bytes; values are drawn from ``rng``."""

    def __init__(self, n: int, fields: int, length: int, rng):
        if length >= 128:
            raise ValueError("a field longer than 127 bytes is not "
                             "supported by the benchmark's encoder")
        self.fields, self.length, self.rng = fields, length, rng
        self.keys = [f"field{i}" for i in range(fields)]
        self.next_clock = np.zeros(n, np.int64)
        self.tail = np.full(n * fields, -1, np.int64)  # a field's item

    def writes(self, docs, insert):
        """The writes to the records ``docs``, in that order: where
        ``insert`` (one flag, or one a record) holds, the record's
        insert, else one update. Returns the table and each write's row
        bounds."""
        docs = np.asarray(docs, np.int64)
        insert = np.broadcast_to(np.asarray(insert, bool), docs.shape)
        size = np.where(insert, self.fields, 1)
        bounds = np.r_[0, np.cumsum(size)]
        d = np.repeat(docs, size)
        f = np.arange(len(d)) - np.repeat(bounds[:-1], size)
        upd = np.repeat(~insert, size)
        f[upd] = self.rng.integers(0, self.fields, int(upd.sum()))
        return self._sets(d, f), bounds

    def _sets(self, d: np.ndarray, f: np.ndarray) -> Dict:
        n = len(d)
        # each row's clock: its record's next, in row order
        by_d = np.argsort(d, kind="stable")
        starts = np.r_[0, np.flatnonzero(np.diff(d[by_d])) + 1]
        rank = np.arange(n) - np.repeat(starts, np.diff(np.r_[starts, n]))
        clock = np.empty(n, np.int64)
        clock[by_d] = self.next_clock[d[by_d]] + rank
        np.add.at(self.next_clock, d, 1)
        # origin: the field's item before this set (-1 for the first)
        group = d * self.fields + f
        order = np.lexsort((clock, group))
        g, k = group[order], clock[order]
        prev = self.tail[g]
        same = np.zeros(n, bool)
        same[1:] = g[1:] == g[:-1]
        prev[1:][same[1:]] = k[:-1][same[1:]]
        ok = np.empty(n, np.int64)
        ok[order] = prev
        last = np.ones(n, bool)
        last[:-1] = ~same[1:]
        self.tail[g[last]] = k[last]
        return {
            "client": d + 1, "clock": clock,
            "root": np.zeros(n, np.int64), "key": f.astype(np.int64),
            "oc": np.where(ok >= 0, d + 1, -1), "ok": ok,
            "content": np.zeros(n, np.int64),
            "text": self.rng.integers(32, 127, (n, self.length),
                                      dtype=np.uint8),
            "roots": [ROOT], "keys": self.keys,
        }
