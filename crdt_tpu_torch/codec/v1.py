"""Yjs v1 binary update codec.

The reference moves document state exclusively as v1 update blobs
(``Y.encodeStateAsUpdate`` / ``Y.applyUpdate`` / ``Y.encodeStateVector``
at crdt.js:56,59,294); this module provides the byte-compatible codec
over our unit-item records so the framework can interoperate with
Yjs-wire peers and replay captured traces.

Wire layout (v1):

  update        := clientStructs deleteSet
  clientStructs := numClients:varUint
                   { numStructs:varUint client:varUint clock:varUint
                     struct* }*
  struct        := info:uint8 payload
      info bits: 5-bit content ref | 0x80 origin present |
                 0x40 rightOrigin present | 0x20 parentSub present
      refs: 0 GC, 1 Deleted, 2 JSON, 3 Binary, 4 String, 5 Embed,
            6 Format, 7 Type, 8 Any, 9 Doc, 10 Skip
      If neither origin nor rightOrigin is present the parent is
      written: varUint(1)+varString(rootName) or varUint(0)+ID, then
      the optional parentSub string. Otherwise the parent is derived
      from the origin item at integration time.
  deleteSet     := numClients:varUint
                   { client:varUint numRanges:varUint
                     { clock:varUint len:varUint }* }*

Runs: a wire struct may span several clocks (ContentAny with n
elements, ContentString with n UTF-16 code units, Deleted/GC/Skip with
a length). Decode splits runs into unit records (part j's origin is
(client, clock+j-1), all parts share the struct's rightOrigin — the
exact shape Yjs produces when splitting items). Encode re-coalesces
maximal runs, so round-trips are compact.
"""

from __future__ import annotations

import json
from typing import Any, List, Optional, Sequence, Tuple

from crdt_tpu_torch.codec.lib0 import UNDEFINED, Decoder, Encoder
from crdt_tpu_torch.core.ids import DeleteSet, StateVector
from crdt_tpu_torch.core.records import ItemRecord
from crdt_tpu_torch.core.store import (
    K_ANY,
    K_BINARY,
    K_DELETED,
    K_DOC,
    K_EMBED,
    K_FORMAT,
    K_GC,
    K_JSON,
    K_STRING,
    K_TYPE,
    NULL,
)

# wire content refs
# Wire sanity bound shared with the kernels' 40-bit clock packing
# (ops/device pack_id): any struct clock, run end, origin clock, or
# delete-range end at or beyond this is hostile — honest clocks count
# ops actually created. Bounding here keeps run expansion and every
# downstream clock computation finite (adversarial matrix,
# tests/test_yjs_fixtures.py).
_MAX_CLOCK = 1 << 40

# client-id fields get a looser bound: honest Yjs clients are random
# 32-bit ints; anything at or beyond 2^62 is hostile, and values in
# [2^63, 2^64) would wrap negative through an int64 cast in the native
# codec — 2^64-1 would even collide with its -1 "absent" sentinel.
# Both codecs reject the whole band so a hostile blob cannot make a
# python-decoding replica and a native-decoding replica disagree.
_MAX_ID = 1 << 62

REF_GC = 0
REF_DELETED = 1
REF_JSON = 2
REF_BINARY = 3
REF_STRING = 4
REF_EMBED = 5
REF_FORMAT = 6
REF_TYPE = 7
REF_ANY = 8
REF_DOC = 9
REF_SKIP = 10

_KIND_TO_REF = {
    K_GC: REF_GC,
    K_DELETED: REF_DELETED,
    K_JSON: REF_JSON,
    K_BINARY: REF_BINARY,
    K_STRING: REF_STRING,
    K_EMBED: REF_EMBED,
    K_FORMAT: REF_FORMAT,
    K_TYPE: REF_TYPE,
    K_ANY: REF_ANY,
    K_DOC: REF_DOC,
}


def _utf16_units(s: str) -> List[str]:
    """Split into UTF-16 code units (Yjs clock lengths are JS string
    lengths); surrogate halves survive via surrogatepass."""
    units = []
    for ch in s:
        b = ch.encode("utf-16-be", "surrogatepass")
        for i in range(0, len(b), 2):
            units.append(b[i : i + 2].decode("utf-16-be", "surrogatepass"))
    return units


def _join_utf16(units: Sequence[str]) -> str:
    b = b"".join(u.encode("utf-16-be", "surrogatepass") for u in units)
    return b.decode("utf-16-be", "surrogatepass")


# ---------------------------------------------------------------------------
# state vector
# ---------------------------------------------------------------------------

def encode_state_vector(sv: StateVector) -> bytes:
    e = Encoder()
    clocks = {c: k for c, k in sv.clocks.items() if k > 0}
    e.write_var_uint(len(clocks))
    for client in sorted(clocks, reverse=True):
        e.write_var_uint(client)
        e.write_var_uint(clocks[client])
    return e.to_bytes()


def decode_state_vector(data: bytes) -> StateVector:
    # round-17 wire-taint fix (crdtlint CL1001): state vectors arrive
    # off the wire in sync probes/beacons too — client and clock ride
    # the SAME bounds as update structs (_MAX_ID / _MAX_CLOCK).
    # Before this fence, a hostile SV with a 2^63 clock decoded fine
    # and overflowed int64 in device staging (statevec deficits,
    # shard boundary exchange) instead of failing closed here.
    d = Decoder(data)
    n = d.read_var_uint()
    sv = StateVector()
    for _ in range(n):
        client = _read_client_id(d)
        clock = _read_clock_val(d)
        if clock > 0:
            sv.clocks[client] = clock
    if d.has_content():
        raise ValueError("trailing bytes after state vector")
    return sv


# ---------------------------------------------------------------------------
# bounded wire reads (shared rejection semantics with the native
# codec's Reader::field — see _MAX_ID / _MAX_CLOCK)
# ---------------------------------------------------------------------------

def _read_client_id(d: Decoder) -> int:  # crdtlint: sanitizes
    v = d.read_var_uint()
    if v >= _MAX_ID:
        raise ValueError("client id exceeds wire bound")
    return v


def _read_clock_val(d: Decoder) -> int:  # crdtlint: sanitizes
    v = d.read_var_uint()
    if v >= _MAX_CLOCK:
        raise ValueError("clock exceeds wire bound")
    return v


def _read_id(d: Decoder) -> tuple:
    return (_read_client_id(d), _read_clock_val(d))


# ---------------------------------------------------------------------------
# delete set
# ---------------------------------------------------------------------------

def _write_delete_set(e: Encoder, ds: Optional[DeleteSet]) -> None:
    if ds is None:
        e.write_var_uint(0)
        return
    ds = ds.copy()
    ds.normalize()
    clients = sorted(ds.ranges, reverse=True)
    e.write_var_uint(len(clients))
    for client in clients:
        rs = ds.ranges[client]
        e.write_var_uint(client)
        e.write_var_uint(len(rs))
        for s, end in rs:
            e.write_var_uint(s)
            e.write_var_uint(end - s)


def _read_delete_set(d: Decoder) -> DeleteSet:
    ds = DeleteSet()
    for _ in range(d.read_var_uint()):
        client = _read_client_id(d)
        for _ in range(d.read_var_uint()):
            clock = d.read_var_uint()
            length = d.read_var_uint()
            if clock + length >= _MAX_CLOCK:
                raise ValueError("delete range exceeds wire clock bound")
            if length:
                ds.add(client, clock, length)
    ds.normalize()
    return ds


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------

def _coalesce(recs: List[ItemRecord]) -> List[List[ItemRecord]]:
    """Group a client's clock-sorted unit records into maximal wire runs."""
    runs: List[List[ItemRecord]] = []
    for rec in recs:
        if runs:
            run = runs[-1]
            prev = run[-1]
            # parent matches if explicitly equal, or absent entirely (then
            # it is derived from the origin chain at integration, which
            # inside a run always points at the previous part)
            same_parent = (
                rec.parent_root is None
                and rec.parent_item is None
                and rec.key is None
            ) or (
                rec.parent_root == prev.parent_root
                and rec.parent_item == prev.parent_item
                and rec.key == prev.key
            )
            chained = (
                rec.clock == prev.clock + 1
                and rec.origin == (prev.client, prev.clock)
                and rec.right == run[0].right
            )
            # GC/Skip runs only need clock adjacency
            plain = rec.kind in (K_GC,) and prev.kind == rec.kind and rec.clock == prev.clock + 1
            mergeable_kind = rec.kind == prev.kind and rec.kind in (
                K_ANY,
                K_JSON,
                K_STRING,
                K_DELETED,
            )
            if plain or (mergeable_kind and same_parent and chained):
                run.append(rec)
                continue
        runs.append([rec])
    return runs


def _write_item_content(e: Encoder, run: List[ItemRecord]) -> None:
    kind = run[0].kind
    if kind == K_DELETED:
        e.write_var_uint(len(run))
    elif kind == K_JSON:
        e.write_var_uint(len(run))
        for r in run:
            if r.content is UNDEFINED:
                e.write_var_string("undefined")
            else:
                e.write_var_string(json.dumps(r.content))
    elif kind == K_BINARY:
        e.write_var_uint8_array(bytes(run[0].content))
    elif kind == K_STRING:
        e.write_var_string(_join_utf16([r.content for r in run]))
    elif kind == K_EMBED:
        e.write_var_string(json.dumps(run[0].content))
    elif kind == K_FORMAT:
        k, v = run[0].content
        e.write_var_string(k)
        e.write_var_string(json.dumps(v))
    elif kind == K_TYPE:
        e.write_var_uint(int(run[0].type_ref))
    elif kind == K_ANY:
        e.write_var_uint(len(run))
        for r in run:
            e.write_any(r.content)
    elif kind == K_DOC:
        guid, opts = run[0].content
        e.write_var_string(guid)
        e.write_any(opts)
    else:
        raise ValueError(f"cannot encode content kind {kind}")


def encode_update(
    records: Sequence[ItemRecord], delete_set: Optional[DeleteSet] = None
) -> bytes:
    """Encode unit records + delete set as a v1 update blob."""
    by_client: dict = {}
    for r in records:
        by_client.setdefault(r.client, []).append(r)
    for recs in by_client.values():
        recs.sort(key=lambda r: r.clock)

    e = Encoder()
    e.write_var_uint(len(by_client))
    for client in sorted(by_client, reverse=True):
        recs = by_client[client]
        runs = _coalesce(recs)
        # inject Skip runs for clock gaps (diff updates above a state
        # vector are contiguous, but be defensive like Yjs is)
        withskips: List[Tuple[str, Any]] = []
        prev_end = None
        for run in runs:
            start = run[0].clock
            if prev_end is not None and start > prev_end:
                withskips.append(("skip", (prev_end, start - prev_end)))
            withskips.append(("run", run))
            prev_end = run[-1].clock + 1
        e.write_var_uint(len(withskips))
        e.write_var_uint(client)
        first = withskips[0]
        e.write_var_uint(
            first[1][0].clock if first[0] == "run" else first[1][0]
        )
        for tag, payload in withskips:
            if tag == "skip":
                _, length = payload
                e.write_uint8(REF_SKIP)
                e.write_var_uint(length)
                continue
            run = payload
            head = run[0]
            if head.kind == K_GC:
                e.write_uint8(REF_GC)
                e.write_var_uint(len(run))
                continue
            ref = _KIND_TO_REF[head.kind]
            has_origin = head.origin is not None
            has_right = head.right is not None
            write_parent = not has_origin and not has_right
            has_sub = write_parent and head.key is not None
            info = (
                ref
                | (0x80 if has_origin else 0)
                | (0x40 if has_right else 0)
                | (0x20 if has_sub else 0)
            )
            e.write_uint8(info)
            if has_origin:
                e.write_var_uint(head.origin[0])
                e.write_var_uint(head.origin[1])
            if has_right:
                e.write_var_uint(head.right[0])
                e.write_var_uint(head.right[1])
            if write_parent:
                if head.parent_root is not None:
                    e.write_var_uint(1)
                    e.write_var_string(head.parent_root)
                else:
                    assert head.parent_item is not None, (
                        "record needs parent_root, parent_item, or an origin"
                    )
                    e.write_var_uint(0)
                    e.write_var_uint(head.parent_item[0])
                    e.write_var_uint(head.parent_item[1])
                if has_sub:
                    e.write_var_string(head.key)
            _write_item_content(e, run)
    _write_delete_set(e, delete_set)
    return e.to_bytes()


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _split_units(
    client: int,
    clock: int,
    *,
    parent_root: Optional[str],
    parent_item: Optional[Tuple[int, int]],
    key: Optional[str],
    origin: Optional[Tuple[int, int]],
    right: Optional[Tuple[int, int]],
    kind: int,
    type_ref: int = NULL,
    contents: Optional[List[Any]] = None,
    length: int = 1,
) -> List[ItemRecord]:
    n = len(contents) if contents is not None else length
    out = []
    for j in range(n):
        out.append(
            ItemRecord(
                client=client,
                clock=clock + j,
                parent_root=parent_root if j == 0 else None,
                parent_item=parent_item if j == 0 else None,
                key=key if j == 0 else None,
                origin=origin if j == 0 else (client, clock + j - 1),
                right=right,
                kind=kind,
                type_ref=type_ref,
                content=contents[j] if contents is not None else None,
            )
        )
    # parts after the first derive parent from their origin (previous
    # part); keep key on the first part only, like a Yjs split does
    return out


def decode_update(data: bytes) -> Tuple[List[ItemRecord], DeleteSet]:
    d = Decoder(data)
    records: List[ItemRecord] = []
    # expansion budget: GC/Deleted runs decode to unit records, so a
    # few declared bytes must never buy unbounded allocation. Honest
    # compacted histories stay far under 4096 units per blob byte;
    # hostile declarations fail fast instead of hanging the decoder.
    budget = max(1 << 20, 4096 * len(data))
    num_clients = d.read_var_uint()
    for _ in range(num_clients):
        num_structs = d.read_var_uint()
        client = _read_client_id(d)
        clock = _read_clock_val(d)
        for _ in range(num_structs):
            info = d.read_uint8()
            ref = info & 0x1F
            if ref == REF_SKIP:
                clock += d.read_var_uint()
                if clock >= _MAX_CLOCK:
                    raise ValueError("skip run exceeds wire clock bound")
                continue
            if ref == REF_GC:
                length = d.read_var_uint()
                if clock + length >= _MAX_CLOCK:
                    raise ValueError("gc run exceeds wire clock bound")
                if len(records) + length > budget:
                    raise ValueError("expansion budget exceeded")
                records.extend(
                    _split_units(
                        client,
                        clock,
                        parent_root=None,
                        parent_item=None,
                        key=None,
                        origin=None,
                        right=None,
                        kind=K_GC,
                        length=length,
                    )
                )
                clock += length
                continue
            origin = None
            right = None
            parent_root = None
            parent_item = None
            key = None
            if info & 0x80:
                origin = _read_id(d)
            if info & 0x40:
                right = _read_id(d)
            if not (info & 0xC0):
                if d.read_var_uint() == 1:
                    parent_root = d.read_var_string()
                else:
                    parent_item = _read_id(d)
                if info & 0x20:
                    key = d.read_var_string()
            common = dict(
                parent_root=parent_root,
                parent_item=parent_item,
                key=key,
                origin=origin,
                right=right,
            )
            if ref == REF_DELETED:
                length = d.read_var_uint()
                if clock + length >= _MAX_CLOCK:
                    raise ValueError("deleted run exceeds wire clock bound")
                if len(records) + length > budget:
                    raise ValueError("expansion budget exceeded")
                recs = _split_units(
                    client, clock, kind=K_DELETED, length=length, **common
                )
            elif ref == REF_JSON:
                n = d.read_var_uint()
                vals = []
                for _ in range(n):
                    s = d.read_var_string()
                    vals.append(UNDEFINED if s == "undefined" else json.loads(s))
                recs = _split_units(
                    client, clock, kind=K_JSON, contents=vals, **common
                )
            elif ref == REF_BINARY:
                recs = _split_units(
                    client,
                    clock,
                    kind=K_BINARY,
                    contents=[d.read_var_uint8_array()],
                    **common,
                )
            elif ref == REF_STRING:
                units = _utf16_units(d.read_var_string())
                recs = _split_units(
                    client, clock, kind=K_STRING, contents=units, **common
                )
            elif ref == REF_EMBED:
                recs = _split_units(
                    client,
                    clock,
                    kind=K_EMBED,
                    contents=[json.loads(d.read_var_string())],
                    **common,
                )
            elif ref == REF_FORMAT:
                k = d.read_var_string()
                v = json.loads(d.read_var_string())
                recs = _split_units(
                    client, clock, kind=K_FORMAT, contents=[(k, v)], **common
                )
            elif ref == REF_TYPE:
                tref = d.read_var_uint()
                if tref >= (1 << 31):
                    raise ValueError("type ref exceeds wire bound")
                recs = _split_units(
                    client, clock, kind=K_TYPE, type_ref=tref, length=1, **common
                )
            elif ref == REF_ANY:
                n = d.read_var_uint()
                vals = [d.read_any() for _ in range(n)]
                recs = _split_units(
                    client, clock, kind=K_ANY, contents=vals, **common
                )
            elif ref == REF_DOC:
                guid = d.read_var_string()
                opts = d.read_any()
                recs = _split_units(
                    client, clock, kind=K_DOC, contents=[(guid, opts)], **common
                )
            else:
                raise ValueError(f"unknown struct ref {ref}")
            records.extend(recs)
            clock += len(recs)
    ds = _read_delete_set(d)
    if d.has_content():
        raise ValueError("trailing bytes after v1 update")
    return records, ds


# ---------------------------------------------------------------------------
# engine glue — the Y.* surface the reference calls
# ---------------------------------------------------------------------------

def encode_state_as_update(engine, sv: Optional[StateVector] = None) -> bytes:
    """``Y.encodeStateAsUpdate(doc[, sv])`` (crdt.js:56,288,347): items
    above the target state vector plus the full delete set, for a
    :class:`~crdt_tpu_torch.core.engine.Engine`.

    Full-state encodes (``sv`` None or empty — compaction snapshots,
    and the answer to a FRESH requester, whose decoded state vector is
    empty) go through the native column encoder in one C pass over the
    store's columns; real diffs stay on the O(deficit) record path."""
    if sv is None or not sv.clocks:
        from crdt_tpu_torch.codec import native

        if native.available():
            ds = engine.delete_set()
            return native.encode_from_columns(
                engine.to_decoded_columns(ds), ds
            )
    return encode_update(engine.records_since(sv), engine.delete_set())


def apply_update(engine, data: bytes) -> None:
    """``Y.applyUpdate(doc, update)`` (crdt.js:294)."""
    records, ds = decode_update(data)
    engine.apply_records(records, ds)


def encode_state_vector_of(engine) -> bytes:
    return encode_state_vector(engine.state_vector())
