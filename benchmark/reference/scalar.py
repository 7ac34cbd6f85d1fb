"""Yjs's item integration, one item at a time: the scalar form the
vectorised reference (:mod:`benchmark.reference.yjs`) is held against
in the benchmark's CPU tests.

``Item.integrate`` of Yjs, for items with a left origin and no right
origin: starting right after the origin (or at the segment's first
item), scan the items up to the end of the segment; an item with the
same origin and a lower client, or one whose origin lies among the
items scanned (and outside the current conflict), moves the insertion
point past it; an item with the same origin and a client not lower, or
one hanging elsewhere, stops the scan. Too slow for a timed cell's
size; exact at the tests' sizes.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from benchmark.reference.yjs import deleted_mask, values


class _Seg:
    __slots__ = ("start", "right", "left")

    def __init__(self):
        self.start = None
        self.right: Dict[int, int] = {}
        self.left: Dict[int, int] = {}

    def insert_after(self, left, item) -> None:
        nxt = self.start if left is None else self.right.get(left)
        if left is None:
            self.start = item
        else:
            self.right[left] = item
        self.left[item] = left
        if nxt is not None:
            self.right[item] = nxt
            self.left[nxt] = item

    def items(self):
        o = self.start
        while o is not None:
            yield o
            o = self.right.get(o)


def integrate_all(t: Dict) -> Dict[Tuple[int, int], list]:
    """Every segment's rows in document order, integrating items as
    their origins arrive."""
    n = len(t["client"])
    client = np.asarray(t["client"]).tolist()
    clock = np.asarray(t["clock"]).tolist()
    oc = np.asarray(t["oc"]).tolist()
    ok = np.asarray(t["ok"]).tolist()
    segs = list(zip(np.asarray(t["root"]).tolist(),
                    np.asarray(t["key"]).tolist()))
    row_of = {(client[i], clock[i]): i for i in range(n)}
    origin = [row_of[(oc[i], ok[i])] if oc[i] >= 0 else None
              for i in range(n)]
    state: Dict[Tuple[int, int], _Seg] = {}
    done = [False] * n
    todo = sorted(range(n), key=lambda i: (clock[i], client[i]))
    while todo:
        later = []
        for i in todo:
            o_row = origin[i]
            if o_row is not None and not done[o_row]:
                later.append(i)
                continue
            seg = state.setdefault(segs[i], _Seg())
            left = o_row
            o = seg.start if left is None else seg.right.get(left)
            before, conflict = set(), set()
            while o is not None:
                before.add(o)
                conflict.add(o)
                if origin[o] == origin[i]:
                    if client[o] < client[i]:
                        left = o
                        conflict.clear()
                    else:
                        break
                elif origin[o] is not None and origin[o] in before:
                    if origin[o] not in conflict:
                        left = o
                        conflict.clear()
                else:
                    break
                o = seg.right.get(o)
            seg.insert_after(left, i)
            done[i] = True
        if len(later) == len(todo):
            raise ValueError("items whose origins never arrive")
        todo = later
    return {s: list(seg.items()) for s, seg in state.items()}


def converge(t: Dict, ds: Tuple) -> dict:
    """The converged document, as :func:`benchmark.reference.yjs.
    converge` states it, from the scalar integration."""
    dead = deleted_mask(t["client"], t["clock"], *ds)
    content = values(t).tolist()
    cache: dict = {}
    for (r, k), rows in sorted(integrate_all(t).items()):
        name = t["roots"][r]
        if k >= 0:
            if not dead[rows[-1]]:
                cache.setdefault(name, {})[t["keys"][k]] = content[rows[-1]]
        else:
            cache.setdefault(name, []).extend(
                content[i] for i in rows if not dead[i])
    return cache
