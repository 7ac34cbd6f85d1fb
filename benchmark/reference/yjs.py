"""The plain reference: Yjs semantics over record tables, in NumPy.

It reads the record tables the benchmark's generators make (never the
program's decode) and works out the converged document the way Yjs
defines it, with nothing of the program under test:

- Every item is a node of its parent's tree of left origins: an item
  with an origin hangs under that item, one without under the root of
  its segment (a map key of a root map, or a root list).
- Yjs's integration orders the children of one node by client
  ascending and, for one client, by clock descending (a later item of
  the same client at the same origin goes to its left), and puts each
  child's whole subtree right after it. A segment's document order is
  therefore that tree's depth-first order. ``benchmark/reference/
  scalar.py`` integrates item by item as Yjs does, and the tests hold
  this form against it.
- A map key's value is its segment's last item in that order, shown
  only where that item is not deleted; a map root shows where at least
  one key does. A list shows its items in order, deleted ones left
  out; a list root shows whenever it holds an item.

The depth-first order is found without recursion: each node's
successor in the order is its first child, or else the next sibling of
the nearest ancestor (itself included) that has one; pointer jumping
finds both, and list ranking the positions, in O(log depth) passes.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Tuple

import numpy as np


def _ids(client, clock) -> np.ndarray:
    return (np.asarray(client, np.int64) << 40) | np.asarray(clock, np.int64)


def deleted_mask(client, clock, ds_client, ds_start, ds_len) -> np.ndarray:
    """True where (client, clock) lies in a delete range."""
    key = _ids(client, clock)
    if len(ds_client) == 0:
        return np.zeros(len(key), bool)
    s = _ids(ds_client, ds_start)
    e = _ids(ds_client, np.asarray(ds_start) + np.asarray(ds_len))
    order = np.argsort(s, kind="stable")
    s, e = s[order], e[order]
    run_end = np.maximum.accumulate(e)  # ranges may overlap
    i = np.searchsorted(s, key, side="right") - 1
    ok = i >= 0
    out = np.zeros(len(key), bool)
    out[ok] = key[ok] < run_end[i[ok]]
    return out


def document_order(t: Dict) -> Tuple[np.ndarray, np.ndarray]:
    """(segment id of each row, rows in document order grouped by
    segment). Segment ids number the distinct (root, key) pairs."""
    n = len(t["client"])
    seg_code = np.asarray(t["root"], np.int64) * (len(t["keys"]) + 1) + \
        (np.asarray(t["key"], np.int64) + 1)
    _, seg = np.unique(seg_code, return_inverse=True)
    S = int(seg.max()) + 1 if n else 0
    N = n + S  # rows, then one head a segment
    ids = _ids(t["client"], t["clock"])
    by_id = np.argsort(ids, kind="stable")
    parent = n + seg
    has_o = np.asarray(t["oc"]) >= 0
    if has_o.any():
        oid = _ids(np.asarray(t["oc"])[has_o], np.asarray(t["ok"])[has_o])
        j = np.searchsorted(ids[by_id], oid)
        j = np.minimum(j, n - 1)
        if not (ids[by_id][j] == oid).all():
            raise ValueError("an origin names an item the tables lack")
        parent[has_o] = by_id[j]
        if (seg[parent[has_o]] != seg[has_o]).any():
            # Yjs takes such an item's parent from its origin; the
            # benchmark's generators never write one
            raise ValueError("an origin lies in another segment")
    client = np.asarray(t["client"], np.int64)
    clock = np.asarray(t["clock"], np.int64)
    sib = np.lexsort((-clock, client, parent))
    p_sorted = parent[sib]
    first_child = np.full(N, -1, np.int64)
    head = np.ones(n, bool)
    head[1:] = p_sorted[1:] != p_sorted[:-1]
    first_child[p_sorted[head]] = sib[head]
    next_sib = np.full(N, -1, np.int64)
    same = ~head[1:]
    next_sib[sib[:-1][same]] = sib[1:][same]

    # nxt(u): next sibling of the nearest ancestor-or-self having one
    val = next_sib.copy()
    done = val >= 0
    done[n:] = True  # a head ends its segment: nxt = -1
    jump = np.concatenate([parent, np.arange(n, N)])
    while not done.all():
        val = np.where(done, val, val[jump])
        done = done | done[jump]
        jump = jump[jump]
    succ = np.where(first_child >= 0, first_child, val)

    # list ranking: hops to the end of the segment's order
    dist = (succ >= 0).astype(np.int64)
    nx = succ.copy()
    while (nx >= 0).any():
        m = nx >= 0
        dist = dist + np.where(m, dist[np.where(m, nx, 0)], 0)
        nx = np.where(m, nx[np.where(m, nx, 0)], -1)
    order = np.lexsort((-dist[:n], seg))
    return seg, order


def values(t: Dict) -> np.ndarray:
    """Every row's value: its ``text`` as a string (an object array)
    where the table has that column, else its ``content`` integer."""
    if "text" in t:
        return np.asarray([bytes(r).decode("ascii") for r in t["text"]],
                          dtype=object)
    return np.asarray(t["content"])


def converge(t: Dict, ds: Tuple) -> dict:
    """The converged document (the ``crdt.c`` cache shape) of the
    record table ``t`` under delete ranges ``ds`` = (client, start,
    length) arrays."""
    n = len(t["client"])
    if n == 0:
        return {}
    seg, order = document_order(t)
    dead = deleted_mask(t["client"], t["clock"], *ds)
    roots, keys = t["roots"], t["keys"]
    root = np.asarray(t["root"])
    key = np.asarray(t["key"])
    content = values(t)
    o_seg = seg[order]
    last = np.ones(n, bool)
    last[:-1] = o_seg[1:] != o_seg[:-1]
    first = np.ones(n, bool)
    first[1:] = o_seg[1:] != o_seg[:-1]
    cache: dict = {}
    # maps: each key segment's last row, where visible
    w = order[last]
    w = w[(key[w] >= 0) & ~dead[w]]
    w = w[np.lexsort((key[w], root[w]))]
    for r, k, v in zip(root[w].tolist(), key[w].tolist(),
                       content[w].tolist()):
        cache.setdefault(roots[r], {})[keys[k]] = v
    # lists: every visible row in order; a list root with rows shows
    lrows = order[key[order] < 0]
    for r in np.unique(root[lrows]).tolist():
        cache[roots[r]] = []
    vis = lrows[~dead[lrows]]
    cuts = np.flatnonzero(np.diff(root[vis])) + 1
    for part in np.split(vis, cuts):
        if len(part):
            cache[roots[int(root[part[0]])]] = content[part].tolist()
    return cache


def _canon(v, out: List[str]) -> None:
    if isinstance(v, dict):
        out.append("{")
        for k in sorted(v, key=str):
            out.append("%r:" % (k,))
            _canon(v[k], out)
            out.append(",")
        out.append("}")
    elif isinstance(v, (list, tuple)):
        if not any(isinstance(x, (dict, list, tuple)) for x in v):
            out.append(repr(list(v)))
            return
        out.append("[")
        for x in v:
            _canon(x, out)
            out.append(",")
        out.append("]")
    else:
        out.append(repr(v))


def digest(cache: dict) -> str:
    """The multi-tenant server's read answer for a converged doc: the
    first 16 hex digits of SHA-1 over the doc's canonical text (map
    keys sorted at every depth, list order kept), as its wire API
    defines it."""
    out: List[str] = []
    _canon(cache, out)
    return hashlib.sha1("".join(out).encode()).hexdigest()[:16]


def cache_diff(got: dict, want: dict) -> int:
    """How many entries differ: a map key missing, extra or with
    another value, a list position with another value or beyond the
    shorter list, and a root present on one side only (counted once a
    row it should hold, at least one)."""
    bad = 0
    for name in set(got) | set(want):
        g, w = got.get(name), want.get(name)
        if type(g) is not type(w):
            bad += max(len(g or ()), len(w or ()), 1)
        elif isinstance(w, dict):
            for k in set(g) | set(w):
                bad += k not in g or k not in w or g[k] != w[k]
        else:
            m = min(len(g), len(w))
            ga = np.asarray(g[:m], dtype=object)
            wa = np.asarray(w[:m], dtype=object)
            bad += int((ga != wa).sum()) + abs(len(g) - len(w))
    return bad


def bytes_diff(got: bytes, want: bytes) -> int:
    """Positions at which two byte strings differ, the length
    difference included."""
    m = min(len(got), len(want))
    a = np.frombuffer(got[:m], np.uint8)
    b = np.frombuffer(want[:m], np.uint8)
    return int((a != b).sum()) + abs(len(got) - len(want))
