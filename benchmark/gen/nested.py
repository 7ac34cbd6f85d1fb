"""A workspace of nested arrays edited by many replicas between syncs.

One doc holds a root map ``ws`` whose keys ``a0``, ``a1``, ... each
hold a ``Y.Array`` (a map set of a ``ContentType``), as ypear/crdt's
``set(name, key, val)`` with an ``arrayMethod`` writes it. Round 0:
writer ``(k mod writers) + 1`` creates array ``a{k}``. Every later
round, each writer makes ``sync_every`` edits against its view (the
converged doc at the round's start plus its own edits of the round),
then every writer's update of the round is delivered to every other.

An edit picks an array by Zipf over a seeded permutation of the
arrays, then inserts one value at a uniform index in [0, visible
length], pushes one, unshifts one, or cuts 1 .. ``cut_max``
consecutive visible values from a uniform index (a cut of an empty
array becomes a push). Origins are set as Yjs's
``typeListInsertGenerics`` sets them: the left origin is the visible
value before the index (none at 0), the right origin the next item
after it in the array's full item list, deleted or not (at 0, the
array's first item). A value is a string of printable ASCII, one
``ContentAny`` a value.

The draws of a round are made in bulk; each writer's edits then run in
Python against its view, and the round's items are integrated as Yjs
integrates them (:class:`benchmark.reference.yata.Lists`). Blobs are
one v1 update a writer a round, runs merged as Yjs merges them.

The record table (see :mod:`benchmark.gen.wire`) adds to the root and
key columns: ``pc``, ``pk`` (the parent item's id, -1 for a root's
item), ``rc``, ``rk`` (the right origin, -1 for none) and ``type_ref``
(0 for an item holding an array, -1 for a value). Nothing here imports
the program under test.
"""

from __future__ import annotations

from itertools import chain
from typing import Dict, List, Sequence, Tuple

import numpy as np

from benchmark.gen import wire
from benchmark.reference.yata import Lists

ROOT = "ws"
INSERT, PUSH, UNSHIFT, CUT = range(4)
KINDS = ("insert", "push", "unshift", "cut")
REF_TYPE = 7

_RAW, _VU, _ROOT, _KEY, _TEXT = range(1, 6)
_SLOTS = 12


def build(writers: int, arrays: int, edits_per_writer: int,
          sync_every: int, array_zipf: float, mix: Dict[str, float],
          cut_max: int, value_bytes: int, seed: int):
    """The history. Returns (blobs, table, (ds client, start, len),
    stats), ``stats`` counting the items, the values inserted, the
    right-bearing items and the deleted items."""
    if value_bytes >= 128:
        raise ValueError("a value of 128 bytes or more is not supported "
                         "by this encoder")
    rng = np.random.default_rng(seed)
    p = np.array([mix[k] for k in KINDS], np.float64)
    if abs(p.sum() - 1) > 1e-9:
        raise ValueError("the edit mix does not sum to 1")
    cdf_kind = np.cumsum(p)
    w = np.arange(1, arrays + 1, dtype=np.float64) ** -array_zipf
    cdf_arr = np.cumsum(w) / w.sum()
    perm = rng.permutation(arrays)

    lists = Lists()
    dead: List[bool] = []
    r_client: List[int] = []
    r_clock: List[int] = []
    r_arr: List[int] = []       # array of a value row; -1 for a type row
    type_row = np.empty(arrays, np.int64)
    nxt_clock = np.zeros(writers + 1, np.int64)
    texts: List[np.ndarray] = []
    bounds = [0]
    ds_rounds: List[Tuple[List[int], List[int]]] = []

    # round 0: the arrays, each a map set of a type under ws/a{k}
    for wr in range(writers):
        for k in range(wr, arrays, writers):
            row = lists.add(wr + 1, ("key", k), -1, -1)
            lists.integrate(row)
            dead.append(False)
            r_client.append(wr + 1)
            r_clock.append(int(nxt_clock[wr + 1]))
            r_arr.append(-1)
            nxt_clock[wr + 1] += 1
            type_row[k] = row
        bounds.append(len(r_client))
        ds_rounds.append(([], []))
    texts.append(np.zeros((len(r_client), value_bytes), np.uint8))
    visible: Dict[int, list] = {k: [] for k in range(arrays)}

    rounds = -(-edits_per_writer // sync_every)
    done = 0
    for _ in range(rounds):
        m = min(sync_every, edits_per_writer - done)
        done += m
        E = writers * m
        kind = np.searchsorted(cdf_kind, rng.random(E), side="right")
        kind = np.minimum(kind, 3).tolist()
        arr = perm[np.minimum(np.searchsorted(cdf_arr, rng.random(E)),
                              arrays - 1)].tolist()
        u = rng.random(E).tolist()
        cut = rng.integers(1, cut_max + 1, E).tolist()
        vals = rng.integers(32, 127, (E, value_bytes), dtype=np.uint8)
        used: List[int] = []
        new_rows: List[int] = []
        kill: List[int] = []
        touched = set()
        right = lists.right
        for wr in range(writers):
            client = wr + 1
            clock = int(nxt_clock[client])
            view: Dict[int, list] = {}
            lnext: Dict[int, int] = {}
            lfirst: Dict[int, int] = {}
            d_client: List[int] = []
            d_clock: List[int] = []
            for j in range(wr * m, (wr + 1) * m):
                a = arr[j]
                vis = view.get(a)
                if vis is None:
                    vis = view[a] = list(visible[a])
                    touched.add(a)
                n = len(vis)
                k = kind[j]
                if k == CUT:
                    if n:
                        i = int(u[j] * n)
                        gone = vis[i:i + cut[j]]
                        del vis[i:i + cut[j]]
                        kill.extend(gone)
                        d_client.extend(r_client[x] for x in gone)
                        d_clock.extend(r_clock[x] for x in gone)
                        continue
                    k = PUSH
                i = n if k == PUSH else 0 if k == UNSHIFT else \
                    min(int(u[j] * (n + 1)), n)
                if i:
                    left = vis[i - 1]
                    rt = lnext.get(left, -2)
                    if rt == -2:
                        rt = right[left]
                else:
                    left = -1
                    rt = lfirst.get(a, -2)
                    if rt == -2:
                        rt = lists.start.get(("arr", a), -1)
                x = lists.add(client, ("arr", a), left, rt)
                dead.append(False)
                r_client.append(client)
                r_clock.append(clock)
                r_arr.append(a)
                clock += 1
                used.append(j)
                new_rows.append(x)
                vis.insert(i, x)
                lnext[x] = rt
                if left < 0:
                    lfirst[a] = x
                else:
                    lnext[left] = x
            nxt_clock[client] = clock
            bounds.append(len(r_client))
            ds_rounds.append((d_client, d_clock))
        texts.append(vals[used])
        for x in new_rows:
            lists.integrate(x)
        for x in kill:
            dead[x] = True
        for a in touched:
            visible[a] = [r for r in lists.order(("arr", a)) if not dead[r]]

    t = _table(lists, r_client, r_clock, r_arr, type_row,
               np.concatenate(texts), arrays)
    ranges = [_unit_ranges(c, k) for c, k in ds_rounds]
    blobs = encode_updates(t, np.asarray(bounds), ranges)
    ds_c = np.fromiter(chain.from_iterable(c for c, _ in ds_rounds),
                       np.int64)
    ds_k = np.fromiter(chain.from_iterable(k for _, k in ds_rounds),
                       np.int64)
    ds = (ds_c, ds_k, np.ones(len(ds_c), np.int64))
    n = len(r_client)
    stats = {"items": n, "values": n - arrays,
             "right_bearing": int((t["rc"] >= 0).sum()),
             "deleted": int(np.count_nonzero(dead)), "blobs": len(blobs)}
    return blobs, t, ds, stats


def _unit_ranges(client: List[int], clock: List[int]) -> List:
    """:func:`benchmark.gen.wire.normalize_ranges` of unit-length
    deletes, in plain Python (a round's few deletes a writer)."""
    by: Dict[int, set] = {}
    for c, k in zip(client, clock):
        by.setdefault(c, set()).add(k)
    out = []
    for c in sorted(by, reverse=True):
        ks = sorted(by[c])
        rs = []
        s = p = ks[0]
        for k in ks[1:]:
            if k != p + 1:
                rs.append((s, p - s + 1))
                s = k
            p = k
        rs.append((s, p - s + 1))
        out.append((c, rs))
    return out


def _table(lists: Lists, client, clock, arr, type_row, text,
           arrays: int) -> Dict:
    client = np.asarray(client, np.int64)
    clock = np.asarray(clock, np.int64)
    arr = np.asarray(arr, np.int64)
    orow = np.asarray(lists.origin, np.int64)
    rrow = np.asarray(lists.rorigin, np.int64)
    is_val = arr >= 0
    prow = np.where(is_val, type_row[np.maximum(arr, 0)], -1)
    n = len(client)
    key = np.full(n, -1, np.int64)
    key[type_row] = np.arange(arrays)

    def ref(rows, col):
        return np.where(rows >= 0, col[np.maximum(rows, 0)], -1)

    return {
        "client": client, "clock": clock,
        "root": np.where(is_val, -1, 0), "key": key,
        "pc": ref(prow, client), "pk": ref(prow, clock),
        "oc": ref(orow, client), "ok": ref(orow, clock),
        "rc": ref(rrow, client), "rk": ref(rrow, clock),
        "type_ref": np.where(is_val, -1, 0),
        "content": np.zeros(n, np.int64), "text": text,
        "roots": [ROOT], "keys": [f"a{k}" for k in range(arrays)],
    }


def run_starts(t: Dict, group: np.ndarray) -> np.ndarray:
    """True where a row starts a wire run: a row joins the run before
    it when both hold values, it is the next clock of the same client
    in the same update, its origin is the row before and its right
    origin and parent are that row's (as Yjs merges items)."""
    n = len(t["client"])
    start = np.ones(n, bool)
    if n > 1:
        c, k = t["client"], t["clock"]
        val = t["type_ref"] < 0
        same = [(t[f][1:] == t[f][:-1]) for f in ("rc", "rk", "pc", "pk",
                                                     "root", "key")]
        cont = ((group[1:] == group[:-1]) & (c[1:] == c[:-1])
                & (k[1:] == k[:-1] + 1) & (t["oc"][1:] == c[1:])
                & (t["ok"][1:] == k[:-1]) & val[1:] & val[:-1])
        for s in same:
            cont &= s
        start[1:] = ~cont
    return start


def _row_bytes(t: Dict, start: np.ndarray, run_len: np.ndarray):
    """Every row's struct bytes in row order, and each row's byte
    offset (length n + 1)."""
    n = len(t["client"])
    kind = np.zeros((n, _SLOTS), np.int8)
    val = np.zeros((n, _SLOTS), np.int64)
    has_o = t["oc"] >= 0
    has_r = t["rc"] >= 0
    is_val = t["type_ref"] < 0
    s_o = start & has_o
    s_r = start & has_r
    s_p = start & ~has_o & ~has_r
    s_root = s_p & (t["root"] >= 0)
    s_item = s_p & (t["root"] < 0)
    s_key = s_p & (t["key"] >= 0)
    kind[start, 0] = _RAW
    val[:, 0] = (np.where(is_val, wire.REF_ANY, REF_TYPE)
                 | np.where(has_o, 0x80, 0) | np.where(has_r, 0x40, 0)
                 | np.where(s_key, 0x20, 0))
    for slot, mask, col in ((1, s_o, "oc"), (2, s_o, "ok"), (3, s_r, "rc"),
                            (4, s_r, "rk"), (6, s_item, "pc"),
                            (7, s_item, "pk")):
        kind[mask, slot] = _VU
        val[mask, slot] = t[col][mask]
    kind[s_p, 5] = _VU
    val[s_p, 5] = s_root[s_p]  # 1: a root named next; 0: a parent id
    kind[s_root, 6] = _ROOT
    val[s_root, 6] = t["root"][s_root]
    kind[s_key, 8] = _KEY
    val[s_key, 8] = t["key"][s_key]
    kind[start, 9] = _VU
    val[start, 9] = np.where(is_val, run_len, t["type_ref"])[start]
    kind[is_val, 10] = _RAW
    val[is_val, 10] = wire.ANY_STRING
    kind[is_val, 11] = _TEXT
    val[is_val, 11] = np.flatnonzero(is_val)

    kind = kind.ravel()
    val = val.ravel()
    root_tab, root_len = wire._string_table(t["roots"])
    key_tab, key_len = wire._string_table(t["keys"])
    text = t["text"]
    length = np.zeros(kind.shape, np.int64)
    length[kind == _RAW] = 1
    m_vu = kind == _VU
    length[m_vu] = wire._varuint_len(val[m_vu])
    m_r = kind == _ROOT
    length[m_r] = root_len[val[m_r]]
    m_k = kind == _KEY
    length[m_k] = key_len[val[m_k]]
    m_t = kind == _TEXT
    length[m_t] = 1 + text.shape[1]
    ends = np.cumsum(length)
    off = ends - length
    out = np.zeros(int(ends[-1]) if len(ends) else 0, np.uint8)

    m = kind == _RAW
    out[off[m]] = val[m]
    o, v, nb = off[m_vu], val[m_vu], length[m_vu]
    for j in range(int(nb.max()) if len(nb) else 0):
        sel = nb > j
        byte = (v[sel] >> (7 * j)) & 0x7F
        byte |= np.where(nb[sel] - 1 > j, 0x80, 0)
        out[o[sel] + j] = byte
    for mask, tab, tlen in ((m_r, root_tab, root_len),
                            (m_k, key_tab, key_len)):
        o, ids = off[mask], val[mask]
        for j in range(tab.shape[1]):
            sel = tlen[ids] > j
            out[o[sel] + j] = tab[ids[sel], j]
    if m_t.any():
        o, w = off[m_t], text.shape[1]
        out[o] = w  # the string's length, one varUint byte
        out[o[:, None] + 1 + np.arange(w)] = text[val[m_t]]
    row_off = np.zeros(n + 1, np.int64)
    row_off[1:] = ends.reshape(n, _SLOTS)[:, -1] if n else []
    return out, row_off


def encode_updates(t: Dict, bounds: np.ndarray,
                   ranges: Sequence[List]) -> List[bytes]:
    """One v1 update per group of rows ``t[bounds[i]:bounds[i + 1]]``
    (rows grouped by client descending and clock ascending inside
    one), with ``ranges[i]`` (normalised) as its delete set."""
    n = len(t["client"])
    bounds = np.asarray(bounds, np.int64)
    group = np.repeat(np.arange(len(bounds) - 1), np.diff(bounds))
    start = run_starts(t, group)
    sidx = np.flatnonzero(start)
    run_len = np.diff(np.append(sidx, n))
    run_of = np.zeros(n, np.int64)
    run_of[sidx] = run_len
    data, row_off = _row_bytes(t, start, run_of)
    c = t["client"]
    sec = np.ones(n, bool)
    if n > 1:
        sec[1:] = (group[1:] != group[:-1]) | (c[1:] != c[:-1])
    sec_idx = np.flatnonzero(sec)
    sec_runs = np.add.reduceat(start.astype(np.int64), sec_idx) if n else []
    sec_of_group = np.searchsorted(sec_idx, bounds)
    raw = data.tobytes()
    blobs = []
    for g in range(len(bounds) - 1):
        a, b = sec_of_group[g], sec_of_group[g + 1]
        parts = [wire.varuint(int(b - a))]
        for s in range(a, b):
            r0 = sec_idx[s]
            r1 = sec_idx[s + 1] if s + 1 < len(sec_idx) else n
            parts.append(wire.varuint(int(sec_runs[s]))
                         + wire.varuint(int(c[r0]))
                         + wire.varuint(int(t["clock"][r0])))
            parts.append(raw[row_off[r0]:row_off[r1]])
        parts.append(wire.delete_set_bytes(ranges[g]))
        blobs.append(b"".join(parts))
    return blobs


def encode_union(t: Dict, ds_client, ds_start, ds_len) -> bytes:
    """The whole table as one update (clients descending, clocks
    ascending), as a snapshot of the union holds it."""
    order = np.lexsort((t["clock"], -t["client"]))
    return encode_updates(wire.take(t, order), np.asarray([0, len(order)]),
                          [wire.normalize_ranges(ds_client, ds_start,
                                                 ds_len)])[0]
