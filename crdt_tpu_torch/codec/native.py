"""Native v1 codec binding — decode-to-columns / encode-from-columns.

The port's copy of ``crdt_tpu.codec.native``. It builds the port's own
C++ source ``crdt_tpu_torch/csrc/v1codec.cc`` (module ``_v1codec_torch``,
whose ``undefined`` sentinel is :data:`crdt_tpu_torch.codec.lib0.UNDEFINED`)
as a CPython extension on first use (g++, Python + numpy headers, by
:mod:`crdt_tpu_torch.ops._build`) into the port's own build directory,
``crdt_tpu_torch/build/codec/``, and
exposes the entry points the replays need:

- :func:`decode_updates_columns` — one C pass over a batch of v1 blobs
  producing interned numpy columns + a contents list.
- :func:`encode_from_columns` — byte-identical to
  :func:`crdt_tpu_torch.codec.v1.encode_update` on the same logical rows;
- :func:`merge_decoded` — per-chunk decodes merged into the one-pass
  union (the streaming executor's decode lane), with the packed-id row
  index :func:`id_index` / :func:`id_lookup` it shares with the
  executor's partition climb;
- :func:`conflict_ranks` — staging's conflict-scan replay of every
  right-origin group of a union in one call.

When the toolchain is missing, :func:`available` is False and callers
take the pure-Python codec instead, with its own
:func:`resolve_parents`. Both run on the host; nothing here touches
the card.
"""

from __future__ import annotations

import sysconfig
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from crdt_tpu_torch.core.ids import DeleteSet
from crdt_tpu_torch.core.records import ItemRecord
from crdt_tpu_torch.core.store import K_GC
from crdt_tpu_torch.ops import _build

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "v1codec.cc"
_MODULE = "_v1codec_torch"
_RECIPE = _build.Recipe(
    "v1codec_torch", _SRC, _PKG / "build" / "codec",
    (*_build.GXX_FLAGS, f"-I{sysconfig.get_paths()['include']}",
     f"-I{np.get_include()}"),
)

_build_error: Optional[str] = None


def _import(path: Path):
    import importlib.util

    spec = importlib.util.spec_from_file_location(_MODULE, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load():
    global _build_error
    if _build_error is not None:
        raise RuntimeError(_build_error)
    try:
        return _build.load(_RECIPE, _import)
    except Exception as e:  # remember: don't retry a broken toolchain
        _build_error = f"native codec unavailable: {e}"
        raise RuntimeError(_build_error) from e


def available() -> bool:
    try:
        _load()
        return True
    except RuntimeError:
        return False


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def decode_updates_columns(blobs: Sequence[bytes]) -> Dict:
    """Batch-decode v1 blobs into one columnar union (see module doc).

    Returns a dict of numpy columns (client/clock/parent_root/
    parent_client/parent_clock/key_id/origin_client/origin_clock/
    right_client/right_clock/kind/type_ref), a ``contents`` list, the
    interning tables ``roots``/``keys``, ``ds`` — flat
    (client, clock, length) triples — and ``blob_rows``, the rows each
    blob appended, in input order (blob ``i``'s rows are the union's
    rows from ``blob_rows[:i].sum()`` on).
    """
    # bytes() normalization: the C pass takes exact bytes; callers may
    # hand bytearray/memoryview (the Python fallback accepts them too)
    return _load().decode_updates([bytes(b) for b in blobs])


def ds_from_triples(triples: np.ndarray) -> DeleteSet:
    ds = DeleteSet()
    t = np.asarray(triples).reshape(-1, 3)
    for c, s, length in t:
        ds.add(int(c), int(s), int(length))
    return ds


def kernel_columns(dec: Dict) -> Dict[str, np.ndarray]:
    """Kernel-facing columns (the packed stager's layout) from a decode.

    Matches ``records_to_columns`` exactly, including the -2 sentinel
    for rows with NO parent at all (unresolvable origins) — the kernels
    segment on parent_a/parent_b, so the sentinel must agree."""
    pr = dec["parent_root"]
    pc, pk = dec["parent_client"], dec["parent_clock"]
    root = pr >= 0
    item = (~root) & (pc >= 0)
    return {
        "client": dec["client"],
        "clock": dec["clock"],
        "parent_is_root": root,
        "parent_a": np.where(
            root, pr.astype(np.int64), np.where(item, pc, np.int64(-2))
        ),
        "parent_b": np.where(
            root, np.int64(-1), np.where(item, pk, np.int64(-2))
        ),
        "key_id": dec["key_id"],
        "origin_client": dec["origin_client"],
        "origin_clock": dec["origin_clock"],
        # right origins ride along so staging can order attachment
        # groups (mid-inserts/prepends) without a records detour; the
        # general kernels ignore them
        "right_client": dec["right_client"],
        "right_clock": dec["right_clock"],
        "valid": np.ones(len(dec["client"]), bool),
    }


def decoded_to_records(
    dec: Dict, rows: Optional[Sequence[int]] = None
) -> Tuple[List[ItemRecord], DeleteSet]:
    """Reconstruct symbolic records (parent-resolved) — the bridge to
    the scalar engine and the differential tests. ``rows`` restricts
    the output to a row subset (full delete set either way)."""
    return records_of(dec, rows), ds_from_triples(dec["ds"])


def records_of(dec: Dict, rows: Optional[Sequence[int]] = None
               ) -> List[ItemRecord]:
    """:func:`decoded_to_records`' records alone, without the delete
    set."""
    roots, keys = dec["roots"], dec["keys"]
    out: List[ItemRecord] = []
    n = len(dec["client"])
    client = dec["client"]
    clock = dec["clock"]
    pr = dec["parent_root"]
    pc, pk = dec["parent_client"], dec["parent_clock"]
    kid = dec["key_id"]
    oc, ok = dec["origin_client"], dec["origin_clock"]
    rc, rk = dec["right_client"], dec["right_clock"]
    kind, tref = dec["kind"], dec["type_ref"]
    contents = dec["contents"]
    for i in (range(n) if rows is None else rows):
        i = int(i)
        out.append(ItemRecord(
            client=int(client[i]),
            clock=int(clock[i]),
            parent_root=roots[pr[i]] if pr[i] >= 0 else None,
            parent_item=(int(pc[i]), int(pk[i])) if pc[i] >= 0 else None,
            key=keys[kid[i]] if kid[i] >= 0 else None,
            origin=(int(oc[i]), int(ok[i])) if oc[i] >= 0 else None,
            right=(int(rc[i]), int(rk[i])) if rc[i] >= 0 else None,
            kind=int(kind[i]),
            type_ref=int(tref[i]),
            content=contents[i],
        ))
    return out



def resolve_parents(records: List[ItemRecord]) -> List[ItemRecord]:
    """Fill implicit parent/key of mid-run records from their origins
    (the port's copy of ``crdt_tpu.ops.merge.resolve_parents``).

    Decoded wire runs omit parent info on parts 2..n (derived from the
    origin chain). Unresolvable records (origin outside the batch) keep
    parent unset. Duplicate ids resolve against the FIRST occurrence,
    the convention :func:`dedup_columns` applies too.
    """
    by_id: dict = {}
    for r in records:
        by_id.setdefault((r.client, r.clock), r)
    out = []
    for r in records:
        if r.parent_root is None and r.parent_item is None and r.kind != 0:
            seen = set()
            cur = r
            while (
                cur is not None
                and cur.parent_root is None
                and cur.parent_item is None
            ):
                if cur.id in seen:
                    cur = None
                    break
                seen.add(cur.id)
                nxt = cur.origin if cur.origin is not None else cur.right
                cur = by_id.get(nxt) if nxt is not None else None
            if cur is not None:
                r = ItemRecord(
                    client=r.client,
                    clock=r.clock,
                    parent_root=cur.parent_root,
                    parent_item=cur.parent_item,
                    key=cur.key if r.key is None else r.key,
                    origin=r.origin,
                    right=r.right,
                    kind=r.kind,
                    type_ref=r.type_ref,
                    content=r.content,
                )
        out.append(r)
    return out


def _decode_py(blobs: Sequence[bytes]) -> Dict:
    """Pure-Python fallback producing the same columnar dict (same
    first-appearance interning order as the C pass)."""
    from crdt_tpu_torch.codec import v1

    records: List[ItemRecord] = []
    triples: List[int] = []
    blob_rows: List[int] = []
    for blob in blobs:
        recs, d = v1.decode_update(blob)
        records.extend(recs)
        blob_rows.append(len(recs))
        for c, s, length in d.iter_all():
            triples.extend((c, s, length))
    records = resolve_parents(records)  # keeps record order
    n = len(records)
    dec: Dict = {
        "client": np.empty(n, np.int64),
        "clock": np.empty(n, np.int64),
        "parent_root": np.full(n, -1, np.int32),
        "parent_client": np.full(n, -1, np.int64),
        "parent_clock": np.full(n, -1, np.int64),
        "key_id": np.full(n, -1, np.int32),
        "origin_client": np.full(n, -1, np.int64),
        "origin_clock": np.full(n, -1, np.int64),
        "right_client": np.full(n, -1, np.int64),
        "right_clock": np.full(n, -1, np.int64),
        "kind": np.empty(n, np.int32),
        "type_ref": np.full(n, -1, np.int32),
        "contents": [r.content for r in records],
        "ds": np.asarray(triples, np.int64),
        "blob_rows": np.asarray(blob_rows, np.int64),
    }
    roots: Dict[str, int] = {}
    keys: Dict[str, int] = {}
    for i, r in enumerate(records):
        dec["client"][i] = r.client
        dec["clock"][i] = r.clock
        if r.parent_root is not None:
            dec["parent_root"][i] = roots.setdefault(r.parent_root, len(roots))
        if r.parent_item is not None:
            dec["parent_client"][i], dec["parent_clock"][i] = r.parent_item
        if r.key is not None:
            dec["key_id"][i] = keys.setdefault(r.key, len(keys))
        if r.origin is not None:
            dec["origin_client"][i], dec["origin_clock"][i] = r.origin
        if r.right is not None:
            dec["right_client"][i], dec["right_clock"][i] = r.right
        dec["kind"][i] = r.kind
        dec["type_ref"][i] = r.type_ref
    dec["roots"] = list(roots)
    dec["keys"] = list(keys)
    return dec


def decode_updates_columns_any(blobs: Sequence[bytes]) -> Dict:
    """Native decode when the toolchain allows, Python otherwise."""
    if available():
        return decode_updates_columns(blobs)
    return _decode_py(blobs)


_COLUMN_KEYS = (
    "client", "clock", "parent_root", "parent_client", "parent_clock",
    "key_id", "origin_client", "origin_clock", "right_client",
    "right_clock", "kind", "type_ref",
)


def merge_decoded(chunks: Sequence[Dict]) -> Dict:
    """Concatenate per-chunk decoded column dicts into ONE union,
    exactly as if the chunks' blobs had gone through a single
    :func:`decode_updates_columns_any` pass: the ``roots``/``keys``
    interning tables merge in first-appearance order and every chunk's
    index columns remap onto the merged tables. This is the seam the
    streaming executor's background decode workers feed — each worker
    decodes its blob chunk independently, and the merge is pure numpy.

    Like the single-pass decode, the result is NOT deduped; callers
    that need the canonical union apply :func:`dedup_columns` (one
    pass over the merged columns, identical to the one-shot path)."""
    chunks = [c for c in chunks]
    if len(chunks) == 1:
        return chunks[0]
    if not chunks:
        return decode_updates_columns_any([])
    roots: Dict[str, int] = {}
    keys: Dict[str, int] = {}
    parts: Dict[str, List[np.ndarray]] = {k: [] for k in _COLUMN_KEYS}
    contents: List = []
    ds_parts: List[np.ndarray] = []
    blob_rows: List[np.ndarray] = []
    for c in chunks:
        root_map = np.asarray(
            [roots.setdefault(r, len(roots)) for r in c["roots"]],
            np.int64,
        )
        key_map = np.asarray(
            [keys.setdefault(k, len(keys)) for k in c["keys"]],
            np.int64,
        )
        for name in _COLUMN_KEYS:
            col = c[name]
            if name == "parent_root" and len(root_map):
                col = np.where(
                    col >= 0, root_map[np.clip(col, 0, None)], col
                ).astype(col.dtype)
            elif name == "key_id" and len(key_map):
                col = np.where(
                    col >= 0, key_map[np.clip(col, 0, None)], col
                ).astype(col.dtype)
            parts[name].append(col)
        contents.extend(c["contents"])
        ds_parts.append(np.asarray(c["ds"], np.int64).reshape(-1))
        blob_rows.append(c["blob_rows"])
    out = {k: np.concatenate(parts[k]) for k in _COLUMN_KEYS}
    out["contents"] = contents
    out["ds"] = np.concatenate(ds_parts) if ds_parts else np.empty(
        0, np.int64
    )
    out["blob_rows"] = np.concatenate(blob_rows)
    out["roots"] = list(roots)
    out["keys"] = list(keys)
    _resolve_parents_merged(out)
    return out


def id_index(client, clock) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dense-rank-packed (client, clock) row index for vectorized id
    lookups: clients rank densely, clocks ride the low 41 bits (the
    wire bound is 2^40, so the packed key is collision-free for any
    decodable union). Returns ``(uniq_clients, keys_sorted,
    rows_sorted)`` for :func:`id_lookup`; duplicate ids resolve to
    their FIRST-appearing row (the decoder's emplace convention).
    Shared by the cross-chunk parent resolution below and the
    streaming executor's partition climb — one home for the bit
    layout."""
    client = np.asarray(client, np.int64)
    clock = np.asarray(clock, np.int64)
    uniq = np.unique(client)
    if not len(uniq):
        return uniq, np.empty(0, np.int64), np.empty(0, np.int64)
    keys = (np.searchsorted(uniq, client).astype(np.int64) << 41) | clock
    order = np.lexsort((np.arange(len(keys)), keys))
    return uniq, keys[order], order


def id_lookup(index, qc, qk) -> np.ndarray:
    """Row of each queried (qc, qk) id under an :func:`id_index`
    (-1 where absent; duplicate ids give the first-appearing row)."""
    uniq, keys_sorted, rows_sorted = index
    qc = np.asarray(qc, np.int64)
    qk = np.asarray(qk, np.int64)
    if not len(keys_sorted):
        return np.full(len(qc), -1, np.int64)
    qrank = np.searchsorted(uniq, np.clip(qc, uniq[0], None))
    found_c = (
        (qc >= 0) & (qrank < len(uniq))
        & (uniq[np.clip(qrank, 0, len(uniq) - 1)] == qc)
    )
    qkey = np.where(found_c, (qrank << 41) | qk, np.int64(-1))
    pos = np.searchsorted(keys_sorted, qkey)
    posc = np.clip(pos, 0, len(keys_sorted) - 1)
    hit = (qkey >= 0) & (keys_sorted[posc] == qkey)
    return np.where(hit, rows_sorted[posc], np.int64(-1))


def _resolve_parents_merged(dec: Dict) -> None:
    """Cross-chunk implicit-parent resolution, in place.

    Each chunk's decode already resolved origin-else-right chains that
    stay INSIDE the chunk; rows whose chains cross a chunk boundary
    come out parentless. This pass re-walks exactly those rows over
    the merged union — numpy pointer doubling, O(log chain) rounds —
    with the single-pass decoder's semantics: first-occurrence id
    index, walk to the first ancestor carrying an explicit parent,
    copy its parent columns (and key when the row has none), leave
    cycles and dangling references unresolved."""
    pr, pc, pk = dec["parent_root"], dec["parent_client"], dec["parent_clock"]
    kid, kind = dec["key_id"], dec["kind"]
    n = len(pr)
    need = (pr < 0) & (pc < 0) & (kind != K_GC)
    if not need.any():
        return
    oc, ock = dec["origin_client"], dec["origin_clock"]
    rc, rk = dec["right_client"], dec["right_clock"]
    ref_c = np.where(oc >= 0, oc, rc).astype(np.int64)
    ref_k = np.where(oc >= 0, ock, rk).astype(np.int64)

    # first-occurrence id index (duplicates may still be present at
    # this point — dedup runs after, exactly like the one-shot path)
    index = id_index(dec["client"], dec["clock"])
    ref_row = id_lookup(index, ref_c, ref_k)

    # pointer doubling to each row's first explicitly-parented
    # ancestor; node n is the dead-end sink
    has_explicit = (pr >= 0) | (pc >= 0)
    f = np.where(
        has_explicit, np.arange(n, dtype=np.int64),
        np.where(ref_row >= 0, ref_row, np.int64(n)),
    )
    f = np.r_[f, np.int64(n)]  # sink self-loop
    for _ in range(max(1, (max(n, 2) - 1).bit_length() + 1)):
        f = f[f]
    term = f[:n]
    ok = need & (term < n) & has_explicit[np.clip(term, 0, n - 1)]
    rows = np.flatnonzero(ok)
    t = term[rows]
    pr[rows] = pr[t]
    pc[rows] = pc[t]
    pk[rows] = pk[t]
    fill_key = ok & (kid < 0)
    rows_k = np.flatnonzero(fill_key)
    kid[rows_k] = kid[term[rows_k]]


def dedup_columns(dec: Dict) -> Dict:
    """Drop duplicate-id rows (first occurrence wins), returning a
    canonical union. Redelivered blobs — at-least-once transports,
    overlapping log segments — produce duplicate ids that the kernels
    dedup on-device but that would corrupt a host re-ENCODE (both
    encoders' run/skip bookkeeping assumes unique, forward-moving
    clocks per client).

    ``blob_rows`` passes through. When rows drop, the result also
    carries ``survivor``: for each row of the input, the row of the
    result that holds its id (its first occurrence). When nothing
    drops the input returns as it is, and the map is the identity."""
    n = len(dec["client"])
    if n == 0:
        return dec
    # lexsort, NOT a packed (client << 40 | clock) key: real client ids
    # are 31-bit and would alias modulo 2^24 in the shifted int64,
    # silently merging distinct clients' rows
    order = np.lexsort((dec["clock"], dec["client"]))
    sc = dec["client"][order]
    sk = dec["clock"][order]
    starts = np.r_[True, (sc[1:] != sc[:-1]) | (sk[1:] != sk[:-1])]
    first = np.zeros(n, bool)
    first[order[starts]] = True
    if first.all():
        return dec
    idx = np.flatnonzero(first)  # original order preserved
    out = {k: dec[k][idx] for k in _COLUMN_KEYS}
    contents = dec["contents"]
    out["contents"] = [contents[i] for i in idx]
    out["ds"] = dec["ds"]
    out["roots"] = dec["roots"]
    out["keys"] = dec["keys"]
    out["blob_rows"] = dec["blob_rows"]
    # the lexsort is stable, so each id's group opens on its first
    # occurrence; that row's rank among the kept rows is its new row
    kept_rank = np.cumsum(first) - 1
    group = np.cumsum(starts) - 1
    survivor = np.empty(n, np.int64)
    survivor[order] = kept_rank[order[starts]][group]
    out["survivor"] = survivor
    return out


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------


def ds_to_triples(ds: Optional[DeleteSet]) -> np.ndarray:
    """Flat (client, start, len) triples in the encoder's canonical
    order: clients descending, ranges ascending within a client."""
    if ds is None:
        return np.empty(0, np.int64)
    ds = ds.copy()
    ds.normalize()
    out: List[int] = []
    for client in sorted(ds.ranges, reverse=True):
        for s, e in ds.ranges[client]:
            out.extend((client, s, e - s))
    return np.asarray(out, np.int64)


def encode_from_columns_any(dec: Dict, ds: Optional[DeleteSet] = None) -> bytes:
    """Native encode when available; Python fallback otherwise."""
    if available():
        return encode_from_columns(dec, ds)
    from crdt_tpu_torch.codec import v1

    records, dec_ds = decoded_to_records(dec)
    return v1.encode_update(records, ds if ds is not None else dec_ds)


def encode_from_columns(dec: Dict, ds: Optional[DeleteSet] = None) -> bytes:
    """One v1 blob from a decoded (or equivalently-shaped) column set.
    ``ds`` defaults to the decode's own delete set."""
    triples = (
        ds_to_triples(ds)
        if ds is not None
        else ds_to_triples(ds_from_triples(dec["ds"]))
    )
    m = _load()
    return m.encode_update(
        np.ascontiguousarray(dec["client"], np.int64),
        np.ascontiguousarray(dec["clock"], np.int64),
        np.ascontiguousarray(dec["parent_root"], np.int32),
        np.ascontiguousarray(dec["parent_client"], np.int64),
        np.ascontiguousarray(dec["parent_clock"], np.int64),
        np.ascontiguousarray(dec["key_id"], np.int32),
        np.ascontiguousarray(dec["origin_client"], np.int64),
        np.ascontiguousarray(dec["origin_clock"], np.int64),
        np.ascontiguousarray(dec["right_client"], np.int64),
        np.ascontiguousarray(dec["right_clock"], np.int64),
        np.ascontiguousarray(dec["kind"], np.int32),
        np.ascontiguousarray(dec["type_ref"], np.int32),
        list(dec["contents"]),
        list(dec["roots"]),
        list(dec["keys"]),
        triples,
    )


# ---------------------------------------------------------------------------
# staging
# ---------------------------------------------------------------------------


def conflict_ranks(offsets, client, right, anchor) -> np.ndarray:
    """Each member's rank under the Yjs conflict scan, for origin groups
    laid out as CSR: group ``g`` is rows ``offsets[g]:offsets[g + 1]``,
    sorted by (client, clock). ``right`` is the right origin's id key
    (-1 for none) and ``anchor`` the in-group index of the member it
    names (-1 for none). The order is
    :func:`crdt_tpu_torch.ops.yata._simulate_group`'s, group by group."""
    return _load().conflict_ranks(
        np.ascontiguousarray(offsets, np.int64),
        np.ascontiguousarray(client, np.int64),
        np.ascontiguousarray(right, np.int64),
        np.ascontiguousarray(anchor, np.int64),
    )
