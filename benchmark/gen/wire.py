"""The benchmark's own Yjs v1 update encoder, vectorised with NumPy.

It encodes record tables: one row per unit item, every item a
root-parented map set or list append whose content is one lib0 ``any``
value: an integer (a varInt) or, in a table with a ``text`` column, a
string, which is all the benchmark's generators make.
The layout it writes is the wire format's (``numClients``, per client
``numStructs client clock struct*``, then the delete set), with maximal
runs coalesced as Yjs does: a row joins the run before it when it is
the next clock of the same client and its origin is that run's last
item. It imports nothing of the program under test.

A record table is a dict of equal-length arrays:

- ``client``, ``clock``: the item's id;
- ``root``: index into ``roots`` (the root type's name);
- ``key``: index into ``keys`` for a map set, -1 for a list item;
- ``oc``, ``ok``: the left origin's id, ``oc`` -1 where there is none;
- ``content``: the integer the item holds (non-negative);
- ``text`` (optional, a 2-D uint8 array of printable ASCII, under 128
  bytes a row): the string each item holds instead of ``content``;

plus the lists ``roots`` and ``keys``. Rows are grouped by update and,
inside one, by client descending and clock ascending, with each
client's clocks contiguous.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

REF_ANY = 8
ANY_VARINT = 125  # lib0 any: the varInt type byte
ANY_STRING = 119  # lib0 any: the string type byte

# token kinds of the vectorised emitter
_NONE, _RAW, _VARUINT, _VARINT, _ROOT, _KEY, _TEXT = range(7)
_SLOTS = 7


def varuint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(0x80 | b)
        else:
            out.append(b)
            return bytes(out)


def var_string(s: str) -> bytes:
    data = s.encode("utf-8")
    return varuint(len(data)) + data


def _varuint_len(v: np.ndarray) -> np.ndarray:
    n = np.ones(v.shape, np.int64)
    x = v >> 7
    while True:
        more = x > 0
        if not more.any():
            return n
        n += more
        x >>= 7


def _varint_len(v: np.ndarray) -> np.ndarray:
    # non-negative only: 6 payload bits in the first byte, 7 after
    n = np.ones(v.shape, np.int64)
    x = v >> 6
    while True:
        more = x > 0
        if not more.any():
            return n
        n += more
        x >>= 7


def _string_table(names: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
    enc = [var_string(s) for s in names] or [b""]
    width = max(len(b) for b in enc)
    tab = np.zeros((len(enc), width), np.uint8)
    for i, b in enumerate(enc):
        tab[i, :len(b)] = np.frombuffer(b, np.uint8)
    return tab, np.asarray([len(b) for b in enc], np.int64)


def run_starts(t: Dict, group: np.ndarray) -> np.ndarray:
    """True where a row starts a wire run. ``group`` labels the update
    each row belongs to: a run never crosses an update or a client."""
    n = len(t["client"])
    start = np.ones(n, bool)
    if n > 1:
        c, k = t["client"], t["clock"]
        cont = ((group[1:] == group[:-1]) & (c[1:] == c[:-1])
                & (k[1:] == k[:-1] + 1) & (t["oc"][1:] == c[1:])
                & (t["ok"][1:] == k[:-1]))
        start[1:] = ~cont
    return start


def _row_bytes(t: Dict, start: np.ndarray, run_len: np.ndarray):
    """Every row's struct bytes, concatenated in row order, and each
    row's byte offset (length n + 1)."""
    n = len(t["client"])
    kind = np.zeros((n, _SLOTS), np.int8)
    val = np.zeros((n, _SLOTS), np.int64)
    has_o = t["oc"] >= 0
    is_map = t["key"] >= 0
    s_o = start & has_o
    s_p = start & ~has_o
    kind[start, 0] = _RAW
    val[:, 0] = REF_ANY | np.where(has_o, 0x80, np.where(is_map, 0x20, 0))
    kind[s_o, 1] = _VARUINT
    val[s_o, 1] = t["oc"][s_o]
    kind[s_o, 2] = _VARUINT
    val[s_o, 2] = t["ok"][s_o]
    kind[s_p, 1] = _VARUINT
    val[s_p, 1] = 1  # the parent is a root, named next
    kind[s_p, 2] = _ROOT
    val[s_p, 2] = t["root"][s_p]
    sk = s_p & is_map
    kind[sk, 3] = _KEY
    val[sk, 3] = t["key"][sk]
    kind[start, 4] = _VARUINT
    val[start, 4] = run_len
    kind[:, 5] = _RAW
    text = t.get("text")
    if text is None:
        val[:, 5] = ANY_VARINT
        kind[:, 6] = _VARINT
        val[:, 6] = t["content"]
    else:
        val[:, 5] = ANY_STRING
        kind[:, 6] = _TEXT
        val[:, 6] = np.arange(n)

    kind = kind.ravel()
    val = val.ravel()
    root_tab, root_len = _string_table(t["roots"])
    key_tab, key_len = _string_table(t["keys"])
    length = np.zeros(kind.shape, np.int64)
    length[kind == _RAW] = 1
    m_vu = kind == _VARUINT
    length[m_vu] = _varuint_len(val[m_vu])
    m_vi = kind == _VARINT
    length[m_vi] = _varint_len(val[m_vi])
    m_r = kind == _ROOT
    length[m_r] = root_len[val[m_r]]
    m_k = kind == _KEY
    length[m_k] = key_len[val[m_k]]
    m_t = kind == _TEXT
    if m_t.any():
        length[m_t] = 1 + text.shape[1]
    ends = np.cumsum(length)
    off = ends - length
    out = np.zeros(int(ends[-1]) if len(ends) else 0, np.uint8)

    m = kind == _RAW
    out[off[m]] = val[m]
    for mask, first_bits in ((m_vu, 7), (m_vi, 6)):
        o, v, nb = off[mask], val[mask], length[mask]
        shift = np.zeros_like(v)
        for j in range(int(nb.max()) if len(nb) else 0):
            sel = nb > j
            bits = first_bits if j == 0 else 7
            byte = (v[sel] >> shift[sel]) & ((1 << bits) - 1)
            byte |= np.where(nb[sel] - 1 > j, 0x80, 0)
            out[o[sel] + j] = byte
            shift[sel] += bits
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


def normalize_ranges(client, start, length) -> List[Tuple[int, List]]:
    """Delete ranges -> [(client, [(start, len), ...])], clients
    descending, each client's ranges sorted with overlapping and
    touching ranges merged (the normal form the wire carries)."""
    client = np.asarray(client, np.int64)
    start = np.asarray(start, np.int64)
    end = start + np.asarray(length, np.int64)
    out = []
    order = np.lexsort((start, -client))
    client, start, end = client[order], start[order], end[order]
    cuts = np.flatnonzero(np.diff(client)) + 1
    for c, s, e in zip(np.split(client, cuts), np.split(start, cuts),
                       np.split(end, cuts)):
        if not len(c):
            continue
        # a range joins the previous one when it starts at or before
        # the running end of everything before it
        run_end = np.maximum.accumulate(e)
        new = np.ones(len(s), bool)
        new[1:] = s[1:] > run_end[:-1]
        idx = np.flatnonzero(new)
        ends = np.maximum.reduceat(e, idx)
        out.append((int(c[0]), list(zip(s[idx].tolist(),
                                        (ends - s[idx]).tolist()))))
    return out


def delete_set_bytes(ranges: List[Tuple[int, List]]) -> bytes:
    parts = [varuint(len(ranges))]
    for client, rs in ranges:
        parts.append(varuint(client) + varuint(len(rs)))
        parts.extend(varuint(s) + varuint(n) for s, n in rs)
    return b"".join(parts)


def encode_updates(t: Dict, bounds: np.ndarray,
                   ranges: Sequence[List]) -> List[bytes]:
    """One v1 update per group of rows ``t[bounds[i]:bounds[i + 1]]``,
    with ``ranges[i]`` (normalised, see :func:`normalize_ranges`) as
    its delete set."""
    n = len(t["client"])
    bounds = np.asarray(bounds, np.int64)
    group = np.repeat(np.arange(len(bounds) - 1), np.diff(bounds))
    start = run_starts(t, group)
    sidx = np.flatnonzero(start)
    run_len = np.diff(np.append(sidx, n))
    data, row_off = _row_bytes(t, start, run_len)
    c = t["client"]
    # client sections: a new section where the update or client changes
    sec = np.ones(n, bool)
    if n > 1:
        sec[1:] = (group[1:] != group[:-1]) | (c[1:] != c[:-1])
    sec_idx = np.flatnonzero(sec)
    sec_runs = np.add.reduceat(start.astype(np.int64), sec_idx) if n else []
    sec_of_group = np.searchsorted(sec_idx, bounds)
    blobs = []
    raw = data.tobytes()
    for g in range(len(bounds) - 1):
        a, b = sec_of_group[g], sec_of_group[g + 1]
        parts = [varuint(int(b - a))]
        for s in range(a, b):
            r0 = sec_idx[s]
            r1 = sec_idx[s + 1] if s + 1 < len(sec_idx) else n
            parts.append(varuint(int(sec_runs[s])) + varuint(int(c[r0]))
                         + varuint(int(t["clock"][r0])))
            parts.append(raw[row_off[r0]:row_off[r1]])
        parts.append(delete_set_bytes(ranges[g]))
        blobs.append(b"".join(parts))
    return blobs


def take(t: Dict, idx: np.ndarray) -> Dict:
    """Rows ``idx`` of a record table (same string tables)."""
    out = {k: np.asarray(v)[idx] for k, v in t.items()
           if k not in ("roots", "keys")}
    out["roots"], out["keys"] = t["roots"], t["keys"]
    return out


def concat(tables: Sequence[Dict]) -> Dict:
    """Rows of several tables over the same string tables, in order."""
    out = {k: np.concatenate([t[k] for t in tables])
           for k in tables[0] if k not in ("roots", "keys")}
    out["roots"], out["keys"] = tables[0]["roots"], tables[0]["keys"]
    return out


def encode_union(t: Dict, ds_client, ds_start, ds_len) -> bytes:
    """The whole table as one update (clients descending, clocks
    ascending), as a snapshot of the union holds it."""
    order = np.lexsort((t["clock"], -t["client"]))
    return encode_updates(take(t, order), np.asarray([0, len(order)]),
                          [normalize_ranges(ds_client, ds_start,
                                            ds_len)])[0]
