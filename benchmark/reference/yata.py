"""The plain reference for documents with right origins and nested
types: Yjs's ``Item.integrate``, one item at a time, in Python.

It reads a record table (never the program's decode) and integrates
every item as Yjs does:

- Each item lives in a segment: a key of a map, or a list. The parent
  is a root (``root`` names it) or an item that holds a type (``pc``,
  ``pk`` name that item's id); ``key`` is the map key, -1 for a list
  item. An item with an origin hangs in its origin's segment.
- An item goes after its left origin (or at the segment's start) and
  before its right origin. Where other items already sit in between,
  the conflict scan runs from the left origin's right up to the right
  origin: an item with the same origin and a lower client moves the
  insertion point past it, one with the same origin and the same right
  origin ends the scan, one whose origin lies among the items scanned
  (outside the current conflict) moves the point past it, and anything
  else ends the scan.
- A map key shows the value of its segment's last item, where that
  item is not deleted; a list shows its items in order, deleted ones
  left out. A value that is a type (``type_ref`` 0 for an array, 1 for
  a map) shows that type's own contents.

The converged document is stated as :func:`benchmark.reference.yjs.
converge` states it; the compacted snapshot is the union's v1 encoding
(:func:`benchmark.gen.nested.encode_union`). Columns a table lacks
(``pc``/``pk``, ``rc``/``rk``, ``type_ref``) read as absent, so the
fan-in tables integrate here too. Exact, and linear in the items for
the benchmark's traces (a conflict scan is as long as the concurrent
inserts at one gap).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from benchmark.reference.yjs import deleted_mask, values

TYPE_ARRAY, TYPE_MAP = 0, 1


class Lists:
    """Every segment's items as a linked list, integrated one at a
    time. Rows are numbered in the order :meth:`add` gives them."""

    def __init__(self):
        self.client: List[int] = []
        self.origin: List[int] = []   # row of the left origin, -1
        self.rorigin: List[int] = []  # row of the right origin, -1
        self.seg: List = []
        self.right: List[int] = []
        self.start: Dict = {}         # segment -> first row

    def add(self, client: int, seg, origin: int, rorigin: int) -> int:
        """A new row, not yet integrated."""
        self.client.append(client)
        self.seg.append(seg)
        self.origin.append(origin)
        self.rorigin.append(rorigin)
        self.right.append(-1)
        return len(self.client) - 1

    def integrate(self, i: int) -> None:
        """``Item.integrate`` of row ``i``: its origins integrated."""
        right, origin, rorigin = self.right, self.origin, self.rorigin
        s, oi, ri = self.seg[i], origin[i], rorigin[i]
        left = oi
        o = self.start.get(s, -1) if oi < 0 else right[oi]
        if o != ri and o >= 0:
            ci = self.client[i]
            before, conflict = set(), set()
            while o >= 0 and o != ri:
                before.add(o)
                conflict.add(o)
                oo = origin[o]
                if oo == oi:
                    if self.client[o] < ci:
                        left = o
                        conflict.clear()
                    elif rorigin[o] == ri:
                        break
                elif oo >= 0 and oo in before:
                    if oo not in conflict:
                        left = o
                        conflict.clear()
                else:
                    break
                o = right[o]
        if left < 0:
            right[i] = self.start.get(s, -1)
            self.start[s] = i
        else:
            right[i] = right[left]
            right[left] = i

    def order(self, s) -> List[int]:
        """Segment ``s``'s rows in document order."""
        out = []
        o = self.start.get(s, -1)
        right = self.right
        while o >= 0:
            out.append(o)
            o = right[o]
        return out


def _col(t: Dict, name: str, n: int) -> np.ndarray:
    return np.asarray(t[name], np.int64) if name in t else \
        np.full(n, -1, np.int64)


def _rows_of(ids: np.ndarray, by_id: np.ndarray, sorted_ids: np.ndarray,
             qc: np.ndarray, qk: np.ndarray) -> np.ndarray:
    """The row of each id (qc, qk), -1 where qc is -1; raises where the
    table lacks one."""
    out = np.full(len(qc), -1, np.int64)
    has = qc >= 0
    if has.any():
        q = (qc[has] << 40) | qk[has]
        j = np.minimum(np.searchsorted(sorted_ids, q), len(ids) - 1)
        if not (sorted_ids[j] == q).all():
            raise ValueError("a reference names an item the table lacks")
        out[has] = by_id[j]
    return out


def segments(t: Dict) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(segment of each row, left origin row, right origin row).
    A segment is ``(root, key)`` with ``root`` >= 0 for a root's items,
    or ``(-1 - parent row, key)`` for an item parent's."""
    n = len(t["client"])
    client = np.asarray(t["client"], np.int64)
    clock = np.asarray(t["clock"], np.int64)
    ids = (client << 40) | clock
    by_id = np.argsort(ids, kind="stable")
    sids = ids[by_id]
    orow = _rows_of(ids, by_id, sids, _col(t, "oc", n), _col(t, "ok", n))
    rrow = _rows_of(ids, by_id, sids, _col(t, "rc", n), _col(t, "rk", n))
    prow = _rows_of(ids, by_id, sids, _col(t, "pc", n), _col(t, "pk", n))
    root = _col(t, "root", n)
    par = np.where(prow >= 0, -1 - prow, root)
    if ((prow < 0) & (root < 0)).any():
        raise ValueError("a row with neither a root nor an item parent")
    seg = par * (len(t["keys"]) + 1) + (_col(t, "key", n) + 1)
    for ref in (orow, rrow):
        has = ref >= 0
        if (seg[ref[has]] != seg[has]).any():
            # Yjs takes such an item's parent from its origin; the
            # benchmark's generators never write one
            raise ValueError("an origin lies in another segment")
    return seg, orow, rrow


def integrate_all(t: Dict) -> Tuple[Lists, np.ndarray]:
    """Every row integrated, each once its origins are (table order
    where that already holds, as every generator's table does).
    Returns the lists and each row's segment."""
    seg, orow, rrow = segments(t)
    n = len(seg)
    lists = Lists()
    client = np.asarray(t["client"], np.int64).tolist()
    for c, s, o, r in zip(client, seg.tolist(), orow.tolist(),
                          rrow.tolist()):
        lists.add(c, s, o, r)
    done = [False] * n
    todo = range(n)
    while todo:
        later = []
        for i in todo:
            o, r = lists.origin[i], lists.rorigin[i]
            if (o >= 0 and not done[o]) or (r >= 0 and not done[r]):
                later.append(i)
                continue
            lists.integrate(i)
            done[i] = True
        if len(later) == len(todo):
            raise ValueError("items whose origins never arrive")
        todo = later
    return lists, seg


def converge(t: Dict, ds: Tuple) -> dict:
    """The converged document of the record table ``t`` under delete
    ranges ``ds`` = (client, start, length) arrays: a root map's keys
    (shown where their value is visible), a root list's visible
    values, and a type's contents where a value is a type."""
    n = len(t["client"])
    if n == 0:
        return {}
    lists, seg = integrate_all(t)
    dead = deleted_mask(t["client"], t["clock"], *ds).tolist()
    content = values(t).tolist() if "content" in t or "text" in t \
        else [None] * n
    tref = _col(t, "type_ref", n).tolist()
    key = _col(t, "key", n).tolist()
    K = len(t["keys"]) + 1
    by_par: Dict[int, List[int]] = {}
    for s in lists.start:
        by_par.setdefault(s // K, []).append(s)

    def value(row: int, depth: int):
        if tref[row] < 0:
            return content[row]
        return collection(-1 - row, tref[row] == TYPE_MAP, depth + 1)

    def collection(par: int, is_map: bool, depth: int):
        if depth > 64:
            raise ValueError("types nested past 64 levels")
        segs = sorted(by_par.get(par, ()))
        if is_map:
            out = {}
            for s in segs:
                rows = lists.order(s)
                if rows and key[rows[-1]] >= 0 and not dead[rows[-1]]:
                    out[t["keys"][key[rows[-1]]]] = value(rows[-1], depth)
            return out
        return [value(r, depth) for s in segs for r in lists.order(s)
                if not dead[r]]

    cache: dict = {}
    roots = sorted({s // K for s in lists.start if s >= 0})
    for r in roots:
        is_map = any(s % K for s in by_par[r])
        got = collection(r, is_map, 0)
        if not is_map or got:
            cache[t["roots"][r]] = got
    return cache


def cache_diff(got: dict, want: dict) -> int:
    """How many entries differ, nested values counted as
    :func:`benchmark.reference.yjs.cache_diff` counts a root's: a map
    key missing, extra or with another value, a list position with
    another value or beyond the shorter list, and a value of another
    kind counted once a row it should hold (at least one)."""
    if isinstance(want, dict) and isinstance(got, dict):
        return sum(_value_diff(got.get(k, _MISSING), want.get(k, _MISSING))
                   for k in set(got) | set(want))
    return _value_diff(got, want)


_MISSING = object()


def _size(v) -> int:
    return len(v) if isinstance(v, (dict, list)) else 1


def _value_diff(g, w) -> int:
    if g is _MISSING or w is _MISSING:
        return max(_size(w if g is _MISSING else g), 1)
    if isinstance(w, dict) and isinstance(g, dict):
        return cache_diff(g, w)
    if isinstance(w, list) and isinstance(g, list):
        m = min(len(g), len(w))
        return sum(_value_diff(a, b) for a, b in zip(g[:m], w[:m])) + \
            abs(len(g) - len(w))
    if type(g) is not type(w):
        return max(_size(g), _size(w), 1)
    return int(g != w)
