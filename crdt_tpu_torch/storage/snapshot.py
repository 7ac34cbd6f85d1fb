"""Device-layout snapshots: crash-proof instant recovery.

The port's counterpart of ``crdt_tpu.storage.snapshot``; the on-disk
format is the reference's (``CTPUSNP1``, VERSION 2), so a snapshot
written by either package loads in the other. Cold replay of a large
doc pays decode + staging + converge + materialize over the FULL
history. Restarts, new-replica joins, resident evictions and
live doc migrations are all cold starts. The fix is a checksummed
snapshot of the resident engine whose load path is *validate + copy*:
the host columns land via one ``np.frombuffer`` per section (already
in the device staging layout, so the first warm round's H2D put ships
them unchanged), and the interner/segment bookkeeping is rebuilt with
the same O(n) pass ``_admit`` runs per batch.

On-disk format (one file per doc generation, little-endian):

  ``MAGIC(8) | u32 header_len | header | u32 crc32(header) | payload``

The header is lib0-encoded: version, row count, coverage seq, state
digest, then a section table (name, enc, byte length, crc32 each).
Sections reuse the round-12 staged-encoding vocabulary — per-section
``encs`` of ``'i16'`` (:func:`packed._narrow_ident`), ``'hilo'``
(:func:`packed._split_hi_lo`, exact for any int32) or raw ``'i64'``
(segkeys carry the map-flag bit 62) — plus ``'aux'`` sections for
the python-object state (keys, parent specs, contents, cache). An
aux payload leads with a flag byte: 1 = UTF-8 JSON, chosen when an
encode-time round-trip is type-faithful (decode is one C-speed
``json.loads``); 0 = element-wise lib0, the fallback for values
JSON would coerce (bytes, tuples, NaN, non-string dict keys).

Crash safety is the WAL compaction contract (round 10) extended to
files: the writer is *temp file -> fsync -> rename -> dir fsync ->
unlink older -> dir fsync* (put-at-fresh-seq BEFORE old state dies),
every fs primitive goes through a seam (:class:`Fs`) a fault-injecting
subclass can kill at any op, and the loader treats ANY damage — bad magic, version
skew, CRC mismatch, truncation, a torn rename's leftover ``.tmp`` —
as ``ValueError``, counts ``snap.fallbacks{reason=}``, tries the next
older generation, and finally lets the caller fall back to WAL
replay, which converges byte-identically.

The ``seq`` a snapshot carries is a *coverage cursor* in the writer's
own domain: the WAL rider stores the compaction seq (tail = WAL
entries with seq strictly greater), the server's eviction/checkpoint
writers store the covered ``len(st.blobs)`` prefix.

Knobs: ``CRDT_TPU_SNAP_DIR`` (store root; enables the server seams),
``CRDT_TPU_SNAP_BYTES`` (total store budget; writes that would
overflow it are skipped, counted, and never fatal).
"""

from __future__ import annotations

import hashlib
import json
import os
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from crdt_tpu_torch.codec import native
from crdt_tpu_torch.codec.lib0 import Decoder, Encoder
from crdt_tpu_torch.core.ids import DeleteSet
from crdt_tpu_torch.obs.tracer import get_tracer
from crdt_tpu_torch.ops.staging import _narrow_ident, _split_hi_lo, segkey_of

MAGIC = b"CTPUSNP1"
VERSION = 2

# the ten host metadata columns, snapshotted in _Cols.INT_COLS order
_COL_NAMES = (
    "client", "clock", "kid", "pref", "oc", "ock",
    "right_client", "right_clock", "kind", "type_ref",
)

# every section the format knows, in file order. Adding a section is
# a VERSION bump; unknown names on decode are a hard reject (a spliced
# header must not smuggle payload past the allocator fences).
_SECTION_NAMES = tuple("col_" + c for c in _COL_NAMES) + (
    "sv", "ds", "orders_idx", "orders_rows", "win_keys", "win_rows",
    "rights", "keys", "prefs", "contents", "cache",
)
_AUX_SECTIONS = frozenset({"keys", "prefs", "contents", "cache"})
# segkey-bearing sections carry the map-flag bit 62: never narrowed
_FORCE_I64 = frozenset({"orders_idx", "win_keys", "rights"})


def _crc(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


def _encode_ints(name: str, arr: np.ndarray) -> Tuple[str, bytes]:
    """One numeric section -> (enc kind, payload bytes). The round-12
    narrow ladder: int16 identity when the values fit, exact hi/lo
    int16 pair when int32-representable, raw int64 otherwise."""
    arr = np.ascontiguousarray(arr, np.int64)
    if name not in _FORCE_I64:
        narrow = _narrow_ident(arr)
        if narrow is not None:
            return "i16", narrow.astype("<i2").tobytes()
        if len(arr) == 0 or (
            int(arr.min()) >= -(1 << 31) and int(arr.max()) < (1 << 31)
        ):
            hi, lo = _split_hi_lo(arr)
            return "hilo", np.concatenate([hi, lo]).astype(
                "<i2").tobytes()
    return "i64", arr.astype("<i8").tobytes()


def _decode_ints(name: str, enc: str, data: bytes) -> np.ndarray:
    if enc == "i16":
        return np.frombuffer(data, "<i2").astype(np.int64)
    if enc == "hilo":
        if len(data) % 4:
            raise ValueError(f"snapshot: torn hilo section {name!r}")
        arr16 = np.frombuffer(data, "<i2").astype(np.int64)
        half = len(arr16) // 2
        hi, lo = arr16[:half], arr16[half:]
        return (hi << 16) | ((lo + 0x8000) & 0xFFFF)
    if enc == "i64":
        if len(data) % 8:
            raise ValueError(f"snapshot: torn i64 section {name!r}")
        return np.frombuffer(data, "<i8").astype(np.int64)
    raise ValueError(f"snapshot: unknown encoding {enc!r}")


def _faithful(a, b) -> bool:
    """Type-faithful structural equality: ``bool`` is not ``int``,
    ``tuple`` is not ``list``, and the check recurses through
    containers. This is the encode-time gate for the JSON aux rung —
    any value JSON would coerce disqualifies the whole section."""
    if type(a) is not type(b):
        return False
    if isinstance(a, list):
        return len(a) == len(b) and all(
            _faithful(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(
            _faithful(a[k], b[k]) for k in a)
    return a == b


def _json_rung(v) -> Optional[bytes]:
    """UTF-8 JSON bytes for *v* — or ``None`` when a decode
    round-trip does not reproduce it with :func:`_faithful` equality
    (bytes, tuples, NaN, non-string dict keys all fall through to
    the element-wise lib0 rung). Verification runs once at encode
    time so the hot load path can trust a flag-1 section blindly:
    ``json.loads`` is a C loop, the lib0 decode is a Python one."""
    try:
        blob = json.dumps(
            v, ensure_ascii=False, separators=(",", ":"),
            allow_nan=False).encode("utf-8")
        back = json.loads(blob.decode("utf-8"))
    except (TypeError, ValueError, RecursionError):
        return None
    return blob if _faithful(back, v) else None


def _json_list(body: bytes, what: str) -> list:
    """Parse a flag-1 aux body as a JSON array. Damage of any shape
    (bad UTF-8, torn JSON, a non-array top level) is ``ValueError``
    with the stable ``snapshot:`` prefix, nothing else."""
    try:
        # crdtlint: sanitizes — json.loads validates the full body;
        # the per-element fences below are the allocator guards
        vals = json.loads(body.decode("utf-8"))
    except Exception as exc:
        raise ValueError(
            f"snapshot: {what} json damage ({exc})") from exc
    if not isinstance(vals, list):
        raise ValueError(f"snapshot: {what} is not a list")
    return vals


class _Snap:
    """A decoded snapshot — validated columns + python-object state,
    ready for :func:`rehydrate`. Pure data, no engine references."""

    __slots__ = ("n", "seq", "cols", "contents", "keys", "prefs",
                 "sv", "ds", "orders", "wins", "rights", "cache",
                 "digest")

    def __init__(self):
        self.n = 0
        self.seq = 0
        self.cols: Dict[str, np.ndarray] = {}
        self.contents: List = []
        self.keys: List[str] = []
        self.prefs: List[Tuple] = []
        self.sv: Dict[int, int] = {}
        self.ds = DeleteSet()
        self.orders: Dict[int, List[int]] = {}
        self.wins: Dict[int, int] = {}
        self.rights: set = set()
        self.cache: dict = {}
        self.digest = b""


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------


def encode_engine(eng, *, seq: int = 0) -> bytes:
    """Serialize a settled ``IncrementalReplay`` engine. Refuses an
    engine with stashed or rootless state (exactly the refusal
    ``delta_admissible`` applies: such state is not a converged doc).
    The caller settles any pooled rounds first — reading
    ``eng.cache`` flushes the pool and is also what materializes the
    cache section, so the load path never pays a rebuild."""
    if eng._pending or eng._rootless:
        raise ValueError(
            "snapshot: engine has pending/rootless state")
    cache = eng.cache  # flushes the pool; stored verbatim below
    c = eng.cols
    n = c.n

    sections: List[Tuple[str, str, bytes]] = []
    for name in _COL_NAMES:
        enc, data = _encode_ints("col_" + name, c.col(name))
        sections.append(("col_" + name, enc, data))

    sv_flat: List[int] = []
    for client in sorted(eng._next_clock):
        sv_flat.extend((client, eng._next_clock[client]))
    enc, data = _encode_ints("sv", np.asarray(sv_flat, np.int64))
    sections.append(("sv", enc, data))

    ds_tri = native.ds_to_triples(eng.ds)
    enc, data = _encode_ints("ds", ds_tri)
    sections.append(("ds", enc, data))

    # seq segments: flat (segkey, len) index + concatenated rows, in
    # sorted-segkey order so encode is deterministic
    oidx: List[int] = []
    orows: List[int] = []
    for sk in sorted(eng._order):
        rows = eng.order_list(sk)  # materializes any stale links
        oidx.extend((sk, len(rows)))
        orows.extend(rows)
    enc, data = _encode_ints("orders_idx", np.asarray(oidx, np.int64))
    sections.append(("orders_idx", enc, data))
    enc, data = _encode_ints(
        "orders_rows", np.asarray(orows, np.int64))
    sections.append(("orders_rows", enc, data))

    wkeys = sorted(eng._win)
    enc, data = _encode_ints("win_keys", np.asarray(wkeys, np.int64))
    sections.append(("win_keys", enc, data))
    enc, data = _encode_ints("win_rows", np.asarray(
        [eng._win[sk] for sk in wkeys], np.int64))
    sections.append(("win_rows", enc, data))

    rights = sorted(sk for sk, v in eng._seg_rights.items() if v)
    enc, data = _encode_ints("rights", np.asarray(rights, np.int64))
    sections.append(("rights", enc, data))

    # aux sections carry a leading flag byte: 1 = UTF-8 JSON (the
    # fast rung — decode is a single C-speed ``json.loads``), 0 =
    # element-wise lib0. The JSON rung is only taken when the
    # encode-time round-trip is type-faithful, so flag 1 never lies.
    key_list = list(eng._key_names)
    blob = _json_rung(key_list)
    if blob is None:
        e = Encoder()
        e.write_var_uint(len(key_list))
        for name in key_list:
            e.write_var_string(name)
        sections.append(("keys", "aux", b"\x00" + e.to_bytes()))
    else:
        sections.append(("keys", "aux", b"\x01" + blob))

    blob = _json_rung([
        ["root", spec[1]] if spec[0] == "root"
        else ["item", int(spec[1]), int(spec[2])]
        for spec in eng._pref_spec])
    if blob is None:
        e = Encoder()
        e.write_var_uint(len(eng._pref_spec))
        for spec in eng._pref_spec:
            if spec[0] == "root":
                e.write_uint8(0)
                e.write_var_string(spec[1])
            else:
                e.write_uint8(1)
                e.write_var_int(int(spec[1]))
                e.write_var_int(int(spec[2]))
        sections.append(("prefs", "aux", b"\x00" + e.to_bytes()))
    else:
        sections.append(("prefs", "aux", b"\x01" + blob))

    blob = _json_rung(c.contents)
    if blob is None:
        e = Encoder()
        e.write_var_uint(n)
        for v in c.contents:
            e.write_any(v)
        sections.append(("contents", "aux", b"\x00" + e.to_bytes()))
    else:
        sections.append(("contents", "aux", b"\x01" + blob))

    blob = _json_rung(cache)
    if blob is None:
        e = Encoder()
        e.write_any(cache)
        sections.append(("cache", "aux", b"\x00" + e.to_bytes()))
    else:
        sections.append(("cache", "aux", b"\x01" + blob))

    by_name = {name: data for name, _, data in sections}
    digest = hashlib.sha1(
        by_name["sv"] + by_name["ds"]).digest()[:8]

    h = Encoder()
    h.write_var_uint(VERSION)
    h.write_var_uint(n)
    h.write_var_uint(seq)
    h.write_var_uint8_array(digest)
    h.write_var_uint(len(sections))
    for name, enc_kind, data in sections:
        h.write_var_string(name)
        h.write_var_string(enc_kind)
        h.write_var_uint(len(data))
        h.write_var_uint(_crc(data))
    header = h.to_bytes()

    parts = [MAGIC, len(header).to_bytes(4, "little"), header,
             _crc(header).to_bytes(4, "little")]
    parts.extend(data for _, _, data in sections)
    return b"".join(parts)


# ---------------------------------------------------------------------------
# decode (the recovery ladder's first rung: ANY damage -> ValueError)
# ---------------------------------------------------------------------------


def decode_payload(payload: bytes) -> _Snap:
    """Validate + parse a snapshot blob. Every reject is a
    ``ValueError`` with a stable reason prefix and ZERO partial
    state — the loader allocates nothing until the header and every
    section CRC check out (CL10xx wire-taint / CL11xx allocation
    scopes: all counts and lengths are fenced against the actual
    byte budget before any list/array is sized from them)."""
    if len(payload) < len(MAGIC) + 8:
        raise ValueError("snapshot: truncated header")
    if payload[:len(MAGIC)] != MAGIC:
        raise ValueError("snapshot: bad magic")
    off = len(MAGIC)
    hlen = int.from_bytes(payload[off:off + 4], "little")
    off += 4
    # crdtlint: sanitizes — hlen fenced against the real byte budget
    if hlen < 0 or off + hlen + 4 > len(payload):
        raise ValueError("snapshot: truncated header")
    header = payload[off:off + hlen]
    off += hlen
    want = int.from_bytes(payload[off:off + 4], "little")
    off += 4
    if _crc(header) != want:
        raise ValueError("snapshot: header crc mismatch")

    d = Decoder(header)
    try:
        version = d.read_var_uint()
        if version != VERSION:
            raise ValueError(
                f"snapshot: version skew (got {version})")
        n = d.read_var_uint()
        seq = d.read_var_uint()
        digest = bytes(d.read_var_uint8_array())
        nsec = d.read_var_uint()
        if nsec != len(_SECTION_NAMES):
            raise ValueError("snapshot: bad section count")
        table = []
        for _ in range(nsec):
            name = d.read_var_string()
            enc = d.read_var_string()
            size = d.read_var_uint()
            crc = d.read_var_uint()
            table.append((name, enc, size, crc))
    except ValueError:
        raise
    except Exception as exc:  # lib0 cursor errors are also damage
        raise ValueError(f"snapshot: header parse ({exc})") from exc

    if tuple(t[0] for t in table) != _SECTION_NAMES:
        raise ValueError("snapshot: bad section table")
    total = sum(t[2] for t in table)
    if off + total != len(payload):
        raise ValueError("snapshot: truncated payload")

    raw: Dict[str, bytes] = {}
    encs: Dict[str, str] = {}
    for name, enc, size, crc in table:
        # crdtlint: sanitizes — per-section re-fence (the sum check
        # above already pins the total to the real byte budget)
        if size < 0 or off + size > len(payload):
            raise ValueError("snapshot: truncated payload")
        data = payload[off:off + size]
        off += size
        if _crc(data) != crc:
            raise ValueError(f"snapshot: crc mismatch in {name!r}")
        if (name in _AUX_SECTIONS) != (enc == "aux"):
            raise ValueError(f"snapshot: bad encoding for {name!r}")
        raw[name] = data
        encs[name] = enc

    if hashlib.sha1(raw["sv"] + raw["ds"]).digest()[:8] != digest:
        raise ValueError("snapshot: state digest mismatch")

    snap = _Snap()
    snap.n, snap.seq, snap.digest = n, seq, digest

    for cname in _COL_NAMES:
        arr = _decode_ints(
            "col_" + cname, encs["col_" + cname], raw["col_" + cname])
        if len(arr) != n:
            raise ValueError(
                f"snapshot: column {cname!r} length mismatch")
        snap.cols[cname] = arr

    sv = _decode_ints("sv", encs["sv"], raw["sv"])
    if len(sv) % 2:
        raise ValueError("snapshot: torn sv section")
    snap.sv = {int(c): int(k) for c, k in zip(sv[0::2], sv[1::2])}
    if any(k < 0 for k in snap.sv.values()):
        raise ValueError("snapshot: negative sv clock")

    ds = _decode_ints("ds", encs["ds"], raw["ds"])
    if len(ds) % 3:
        raise ValueError("snapshot: torn ds section")
    if len(ds) and int(ds[2::3].min()) <= 0:
        raise ValueError("snapshot: non-positive ds run")
    snap.ds = native.ds_from_triples(ds)

    oidx = _decode_ints("orders_idx", encs["orders_idx"],
                        raw["orders_idx"])
    orows = _decode_ints("orders_rows", encs["orders_rows"],
                         raw["orders_rows"])
    if len(oidx) % 2:
        raise ValueError("snapshot: torn orders index")
    if np.any(orows < 0) or np.any(orows >= max(n, 1)):
        raise ValueError("snapshot: order row out of range")
    pos = 0
    rows_list = orows.tolist()
    for sk, cnt in zip(oidx[0::2].tolist(), oidx[1::2].tolist()):
        # crdtlint: sanitizes — cnt fenced against the decoded rows
        if cnt < 0 or pos + cnt > len(rows_list):
            raise ValueError("snapshot: order count out of range")
        if sk in snap.orders:
            raise ValueError("snapshot: duplicate order segment")
        snap.orders[sk] = rows_list[pos:pos + cnt]
        pos += cnt
    if pos != len(rows_list):
        raise ValueError("snapshot: dangling order rows")

    wkeys = _decode_ints("win_keys", encs["win_keys"], raw["win_keys"])
    wrows = _decode_ints("win_rows", encs["win_rows"], raw["win_rows"])
    if len(wkeys) != len(wrows):
        raise ValueError("snapshot: torn winner section")
    if len(wrows) and (int(wrows.min()) < 0 or int(wrows.max()) >= n):
        raise ValueError("snapshot: winner row out of range")
    snap.wins = dict(zip(wkeys.tolist(), wrows.tolist()))

    snap.rights = set(_decode_ints(
        "rights", encs["rights"], raw["rights"]).tolist())

    # every aux section begins with a flag byte (1 = JSON, 0 = lib0)
    for name in _AUX_SECTIONS:
        if not raw[name]:
            raise ValueError(f"snapshot: empty {name} section")
        if raw[name][0] not in (0, 1):
            raise ValueError(f"snapshot: bad {name} aux flag")

    try:
        if raw["keys"][0] == 1:
            snap.keys = _json_list(raw["keys"][1:], "keys")
            if not all(isinstance(s, str) for s in snap.keys):
                raise ValueError("snapshot: bad key name")
        else:
            d = Decoder(raw["keys"][1:])
            cnt = d.read_var_uint()
            # crdtlint: sanitizes — a name is >=1 byte on the wire
            if cnt > d.remaining():
                raise ValueError("snapshot: keys count out of range")
            snap.keys = [d.read_var_string() for _ in range(cnt)]

        if raw["prefs"][0] == 1:
            for spec in _json_list(raw["prefs"][1:], "prefs"):
                if (isinstance(spec, list) and len(spec) == 2
                        and spec[0] == "root"
                        and isinstance(spec[1], str)):
                    snap.prefs.append(("root", spec[1]))
                elif (isinstance(spec, list) and len(spec) == 3
                        and spec[0] == "item"
                        and isinstance(spec[1], int)
                        and isinstance(spec[2], int)
                        and not isinstance(spec[1], bool)
                        and not isinstance(spec[2], bool)):
                    snap.prefs.append(("item", spec[1], spec[2]))
                else:
                    raise ValueError("snapshot: bad pref spec")
        else:
            d = Decoder(raw["prefs"][1:])
            cnt = d.read_var_uint()
            # crdtlint: sanitizes — a spec is >=2 bytes on the wire
            if cnt * 2 > d.remaining():
                raise ValueError("snapshot: prefs count out of range")
            for _ in range(cnt):
                tag = d.read_uint8()
                if tag == 0:
                    snap.prefs.append(("root", d.read_var_string()))
                elif tag == 1:
                    snap.prefs.append(
                        ("item", d.read_var_int(), d.read_var_int()))
                else:
                    raise ValueError("snapshot: bad pref tag")

        if raw["contents"][0] == 1:
            snap.contents = _json_list(raw["contents"][1:], "contents")
            if len(snap.contents) != n:
                raise ValueError("snapshot: contents count mismatch")
        else:
            d = Decoder(raw["contents"][1:])
            cnt = d.read_var_uint()
            if cnt != n:
                raise ValueError("snapshot: contents count mismatch")
            snap.contents = [d.read_any() for _ in range(cnt)]
            if d.remaining():
                raise ValueError("snapshot: trailing content bytes")

        if raw["cache"][0] == 1:
            try:
                cache = json.loads(raw["cache"][1:].decode("utf-8"))
            except Exception as exc:
                raise ValueError(
                    f"snapshot: cache json damage ({exc})") from exc
        else:
            d = Decoder(raw["cache"][1:])
            cache = d.read_any()
        if not isinstance(cache, dict):
            raise ValueError("snapshot: cache is not a mapping")
        snap.cache = cache
    except ValueError:
        raise
    except Exception as exc:
        raise ValueError(f"snapshot: aux parse ({exc})") from exc

    # cross-section fences the rebuild relies on
    if len(snap.contents) != n:
        raise ValueError("snapshot: contents length mismatch")
    prefc = snap.cols["pref"]
    if len(prefc) and int(prefc.max()) >= len(snap.prefs):
        raise ValueError("snapshot: pref ref out of range")
    kidc = snap.cols["kid"]
    if len(kidc) and int(kidc.max()) >= len(snap.keys):
        raise ValueError("snapshot: key ref out of range")
    return snap


# ---------------------------------------------------------------------------
# rehydrate
# ---------------------------------------------------------------------------


def rehydrate(snap: _Snap, *, pool=None,
              device_min_rows: Optional[int] = None, device="cuda"):
    """A live ``IncrementalReplay`` on ``device`` (the card unless the
    caller asks for the CPU) from a decoded snapshot — the restore path
    the server's promotion calls instead of the full-history engine
    build. Columns land by copy; the interners
    replay in stored order (the pref/kid numbering is embedded in
    every segkey, so order is identity); the per-segment bookkeeping
    is rebuilt with the same grouped pass ``_admit`` runs. The device
    matrix stays lazy: the first warm round stages it exactly as a
    freshly promoted engine would."""
    from crdt_tpu_torch.core.store import K_GC
    from crdt_tpu_torch.models.incremental import IncrementalReplay

    n = snap.n
    eng = IncrementalReplay(
        capacity=max(n, 1), device_min_rows=device_min_rows,
        pool=pool, device=device)
    c = eng.cols
    while c._cap < n:
        c._cap *= 2
    for name in _COL_NAMES:
        col = np.zeros(c._cap, np.int64)
        col[:n] = snap.cols[name]
        c._a[name] = col
    c.contents = list(snap.contents)
    c.n = n

    eng.ds = snap.ds
    eng._next_clock = dict(snap.sv)
    for name in snap.keys:
        eng._kid_of_key(name)
    for spec in snap.prefs:
        eng._pref_of_spec(spec)
    cl = snap.cols["client"]
    ck = snap.cols["clock"]
    eng._id_row = dict(zip(
        zip(cl.tolist(), ck.tolist()), range(n)))

    # segment bookkeeping: the _admit grouped pass over ALL rows
    pref = snap.cols["pref"]
    kind = snap.cols["kind"]
    kid = snap.cols["kid"]
    live = (pref >= 0) & (kind != K_GC)
    if live.any():
        rows = np.arange(n)
        sks = segkey_of(pref[live], kid[live])
        live_rows = rows[live]
        order = np.argsort(sks, kind="stable")
        sks_s, rows_s = sks[order], live_rows[order]
        cuts = np.r_[
            0, np.flatnonzero(sks_s[1:] != sks_s[:-1]) + 1, len(sks_s)
        ]
        for a, b in zip(cuts[:-1], cuts[1:]):
            sk = int(sks_s[a])
            grp = rows_s[a:b]
            eng._seg_rows[sk] = grp.tolist()
            eng._seg_kid[sk] = int(kid[int(grp[0])])
            if sk in snap.rights:
                eng._seg_rights[sk] = True
            root = eng._root_of(eng._spec_of_row(int(grp[0])))
            if root is not None:
                eng._root_segs.setdefault(root, set()).add(sk)
            else:
                eng._rootless.add(sk)
    if eng._rootless:
        # a converged doc never has rootless segments; a snapshot
        # that decodes into one was forged or corrupted below the
        # CRC floor — reject rather than serve a diverged doc
        raise ValueError("snapshot: rootless segment after rebuild")

    for sk, rows_l in snap.orders.items():
        if sk not in eng._seg_rows:
            raise ValueError("snapshot: order for unknown segment")
        eng._order[sk] = list(rows_l)
    for sk, row in snap.wins.items():
        if sk not in eng._seg_rows:
            raise ValueError("snapshot: winner for unknown segment")
        eng._win[sk] = row

    eng._cache = dict(snap.cache)
    eng._dirty = set()
    # the restored winner/order caches are exact: device rounds may
    # advance tail-shaped deltas host-side in O(delta) instead of
    # paying the O(doc) first-round re-splice (the recovery path's
    # whole point — see IncrementalReplay._device_round)
    eng._from_snapshot = True
    return eng


# ---------------------------------------------------------------------------
# the store (atomic generations on a real or fault-injected fs)
# ---------------------------------------------------------------------------


class Fs:
    """The snapshot writer's fs primitives, one virtual op each — the
    seam a fault-injecting subclass overrides to crash or fail the
    writer at any op. Reads never fault."""

    def write(self, path: str, data: bytes) -> None:
        with open(path, "wb") as f:
            f.write(data)

    def fsync(self, path: str) -> None:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def rename(self, src: str, dst: str) -> None:
        os.replace(src, dst)

    def fsync_dir(self, path: str) -> None:
        try:
            fd = os.open(path, os.O_RDONLY)
        except OSError:
            return
        try:
            os.fsync(fd)
        except OSError:
            pass  # some filesystems refuse directory fsync
        finally:
            os.close(fd)

    def unlink(self, path: str) -> None:
        os.unlink(path)

    # -- read side (never fault-injected) --

    def read(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def listdir(self, path: str) -> List[str]:
        try:
            return os.listdir(path)
        except FileNotFoundError:
            return []

    def size(self, path: str) -> int:
        try:
            return os.path.getsize(path)
        except OSError:
            return 0


def _esc(doc: str) -> str:
    """Filesystem-safe doc name (percent-escape, collision-free)."""
    out = []
    for ch in str(doc):
        if ch.isalnum() or ch in "._":
            out.append(ch)
        else:
            out.append("%%%02x" % ord(ch))
    return "".join(out)


class SnapshotStore:
    """Snapshot generations under one directory, named
    ``<doc>-<seq:020d>.snap``. Writes are crash-atomic (tmp, fsync,
    rename, dir fsync; older generations die only AFTER the new one
    is durable). Loads walk generations newest-first through the
    recovery ladder: damage is counted per reason and skipped, never
    raised to the serving path."""

    def __init__(self, root: str, *, max_bytes: Optional[int] = None,
                 fs: Optional[Fs] = None):
        self.root = str(root)
        if max_bytes is None:
            env = os.environ.get("CRDT_TPU_SNAP_BYTES", "")
            max_bytes = int(env) if env else None
        self.max_bytes = max_bytes
        self.fs = fs if fs is not None else Fs()
        os.makedirs(self.root, exist_ok=True)

    # -- naming --

    def _files_of(self, doc) -> List[Tuple[int, str]]:
        """(seq, filename) generations of ``doc``, newest first.
        ``.tmp`` leftovers of a torn rename never match."""
        pref = _esc(doc) + "-"
        out = []
        for name in self.fs.listdir(self.root):
            if not (name.startswith(pref) and name.endswith(".snap")):
                continue
            stem = name[len(pref):-len(".snap")]
            if not stem.isdigit():
                continue
            out.append((int(stem), name))
        out.sort(reverse=True)
        return out

    def total_bytes(self) -> int:
        return sum(
            self.fs.size(os.path.join(self.root, name))
            for name in self.fs.listdir(self.root)
            if name.endswith(".snap"))

    # -- write --

    def write(self, doc, payload: bytes, seq: int) -> bool:
        """Land one generation atomically. Returns False (counted,
        never raised) when the store budget refuses or the disk
        errors — the caller keeps serving from the WAL and may retry
        at the next compaction. ``SimulatedCrash`` (a BaseException)
        propagates: the ALICE harness kills the writer mid-sequence
        and reopens."""
        tracer = get_tracer()
        if self.max_bytes is not None:
            mine = sum(
                self.fs.size(os.path.join(self.root, name))
                for _, name in self._files_of(doc))
            if self.total_bytes() - mine + len(payload) \
                    > self.max_bytes:
                if tracer.enabled:
                    tracer.count("snap.write_errors",
                                 labels={"reason": "budget"})
                return False
        final = os.path.join(
            self.root, "%s-%020d.snap" % (_esc(doc), seq))
        tmp = final + ".tmp"
        t0 = time.perf_counter()
        try:
            self.fs.write(tmp, payload)
            self.fs.fsync(tmp)
            self.fs.rename(tmp, final)
            self.fs.fsync_dir(self.root)
            # the new generation is durable: now (and only now) the
            # old ones may die — the round-10 put-before-delete order
            for _, name in self._files_of(doc):
                path = os.path.join(self.root, name)
                if path != final:
                    self.fs.unlink(path)
            self.fs.fsync_dir(self.root)
        except OSError:
            try:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            except OSError:
                pass
            if tracer.enabled:
                tracer.count("snap.write_errors",
                             labels={"reason": "io"})
            return False
        if tracer.enabled:
            tracer.count("snap.writes")
            tracer.count("snap.bytes", len(payload))
            tracer.gauge(
                "snap.write_ms",
                (time.perf_counter() - t0) * 1000.0)
        return True

    # -- load (the recovery ladder) --

    def load_latest(self, doc) -> Optional[Tuple[_Snap, int]]:
        """Newest valid generation, or None. Each damaged generation
        is counted ``snap.fallbacks{reason=}`` and skipped; the
        final None sends the caller down the WAL-replay rung."""
        tracer = get_tracer()
        for seq, name in self._files_of(doc):
            path = os.path.join(self.root, name)
            t0 = time.perf_counter()
            try:
                payload = self.fs.read(path)
            except OSError:
                if tracer.enabled:
                    tracer.count("snap.fallbacks",
                                 labels={"reason": "io"})
                continue
            try:
                snap = decode_payload(payload)
            except ValueError as exc:
                if tracer.enabled:
                    tracer.count("snap.fallbacks",
                                 labels={"reason": _reason(exc)})
                continue
            if snap.seq != seq:
                if tracer.enabled:
                    tracer.count("snap.fallbacks",
                                 labels={"reason": "seq_skew"})
                continue
            if tracer.enabled:
                tracer.count("snap.loads")
                tracer.gauge(
                    "snap.load_ms",
                    (time.perf_counter() - t0) * 1000.0)
            return snap, seq
        return None

    def drop(self, doc) -> None:
        """Best-effort removal of every generation of ``doc``."""
        for _, name in self._files_of(doc):
            try:
                self.fs.unlink(os.path.join(self.root, name))
            except OSError:
                pass

    # -- sidecars (server checkpoint manifests + history blobs) --

    def put_blob(self, name: str, data: bytes) -> bool:
        """An atomically-written sidecar file (same tmp/fsync/rename
        ladder, no generation bookkeeping)."""
        final = os.path.join(self.root, _esc(name) + ".blob")
        tmp = final + ".tmp"
        try:
            self.fs.write(tmp, data)
            self.fs.fsync(tmp)
            self.fs.rename(tmp, final)
            self.fs.fsync_dir(self.root)
        except OSError:
            if get_tracer().enabled:
                get_tracer().count("snap.write_errors",
                                   labels={"reason": "io"})
            return False
        return True

    def get_blob(self, name: str) -> Optional[bytes]:
        path = os.path.join(self.root, _esc(name) + ".blob")
        try:
            return self.fs.read(path)
        except OSError:
            return None


def _reason(exc: ValueError) -> str:
    """Stable low-cardinality fallback label from a reject message."""
    msg = str(exc)
    for key in ("magic", "version", "crc", "truncated", "digest"):
        if key in msg:
            return key
    return "invalid"


def store_from_env() -> Optional[SnapshotStore]:
    """The ambient store ``CRDT_TPU_SNAP_DIR`` names, or None."""
    root = os.environ.get("CRDT_TPU_SNAP_DIR", "")
    return SnapshotStore(root) if root else None


# ---------------------------------------------------------------------------
# the WAL compaction rider
# ---------------------------------------------------------------------------


def compact_with_snapshot(lp, doc, eng, store: SnapshotStore) -> bool:
    """Compact ``doc``'s WAL through ``lp`` AND land a snapshot of
    the settled engine at the SAME coverage seq, snapshot first. ``lp``
    is duck-typed: any persistence with the reference
    ``LogPersistence``'s ``_seq_for``, ``_next_seq`` and ``compact``.

      1. peek the seq the compaction blob will occupy,
      2. write the snapshot file (atomic; failure degrades to a
         plain compact — the WAL stays the source of truth),
      3. run the stock crash-safe ``LogPersistence.compact``.

    Every crash window is covered: before (2) nothing changed; after
    (2) but before (3) the snapshot covers every live WAL update and
    the tail query (seq strictly greater) returns nothing stale;
    crashes inside (3) are round 10's proven ladder. The caller must
    hold off concurrent appends for the doc (same contract as
    ``compact`` itself)."""
    from crdt_tpu_torch.codec.v1 import encode_state_vector

    sv = encode_state_vector(eng.state_vector())
    blob = eng.encode_state_as_update()
    # peek-without-consuming: _seq_for advances the cursor; putting
    # it back makes the compaction land at the SAME seq the snapshot
    # claims, so the compact blob itself is never replayed as tail
    seq = lp._seq_for(doc)
    lp._next_seq[doc] = seq
    wrote = store.write(doc, encode_engine(eng, seq=seq), seq)
    lp.compact(doc, blob, sv)
    return wrote
