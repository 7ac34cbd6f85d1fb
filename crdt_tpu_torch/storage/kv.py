"""ctypes binding for the native kvlog store.

The port's copy of ``crdt_tpu.storage.kv``. The store is the shared C++
source ``native/kvlog/kvlog.cc`` (it imports no Python module), built
with ``g++`` at first use by :mod:`crdt_tpu_torch.ops._build` into the
port's own build directory, ``crdt_tpu_torch/build/kvlog/``
(``libkvlog_torch-<hash>.so``), and driven through its flat C ABI with
ctypes. The
library's file name differs from the reference's, so the two packages
never load each other's build; the bytes on disk are the same, so a log
written by either package opens in the other.

Capability parity with the surface the reference exercises:
``get`` (crdt.js:47), atomic multi-key ``batch`` (crdt.js:60-71),
ordered prefix scans (`createReadStream` gt/lt, crdt.js:111-130),
``close`` (crdt.js:134) — plus ``compact`` and torn-tail crash
recovery, which LevelDB has and the reference's usage relies on
implicitly (every update is persisted before/around broadcast,
SURVEY.md §5 durability).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

from crdt_tpu_torch.ops import _build

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG.parent / "native" / "kvlog" / "kvlog.cc"
_RECIPE = _build.Recipe(
    "kvlog_torch", _SRC, _PKG / "build" / "kvlog", _build.GXX_FLAGS)


def _load() -> ctypes.CDLL:
    return _build.load(_RECIPE, _bind)


def _bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    c_u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.kv_open.restype = ctypes.c_void_p
    lib.kv_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
    lib.kv_close.argtypes = [ctypes.c_void_p]
    lib.kv_put.restype = ctypes.c_int
    lib.kv_put.argtypes = [ctypes.c_void_p, c_u8p, ctypes.c_uint32, c_u8p, ctypes.c_uint32]
    lib.kv_del.restype = ctypes.c_int
    lib.kv_del.argtypes = [ctypes.c_void_p, c_u8p, ctypes.c_uint32]
    lib.kv_batch.restype = ctypes.c_int
    lib.kv_batch.argtypes = [ctypes.c_void_p, c_u8p, ctypes.c_uint32]
    lib.kv_get.restype = ctypes.c_int
    lib.kv_get.argtypes = [
        ctypes.c_void_p, c_u8p, ctypes.c_uint32,
        ctypes.POINTER(c_u8p), ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.kv_free.argtypes = [c_u8p]
    lib.kv_scan.restype = ctypes.c_void_p
    lib.kv_scan.argtypes = [ctypes.c_void_p, c_u8p, ctypes.c_uint32, c_u8p, ctypes.c_uint32]
    lib.kv_iter_next.restype = ctypes.c_int
    lib.kv_iter_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(c_u8p), ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(c_u8p), ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.kv_iter_close.argtypes = [ctypes.c_void_p]
    lib.kv_sync.restype = ctypes.c_int
    lib.kv_sync.argtypes = [ctypes.c_void_p]
    lib.kv_compact.restype = ctypes.c_int
    lib.kv_compact.argtypes = [ctypes.c_void_p]
    lib.kv_count.restype = ctypes.c_uint64
    lib.kv_count.argtypes = [ctypes.c_void_p]
    lib.kv_log_size.restype = ctypes.c_uint64
    lib.kv_log_size.argtypes = [ctypes.c_void_p]
    lib.kv_live_size.restype = ctypes.c_uint64
    lib.kv_live_size.argtypes = [ctypes.c_void_p]
    return lib


def _as_u8p(data: bytes):
    return ctypes.cast(ctypes.c_char_p(data), ctypes.POINTER(ctypes.c_uint8))


def _take_bytes(lib, ptr, length: int) -> bytes:
    try:
        return ctypes.string_at(ptr, length)
    finally:
        lib.kv_free(ptr)


class Batch:
    """Atomic write batch — the `db.batch([...])` the reference uses
    for its update+sv+meta triple (crdt.js:60-71). Ops are buffered in
    the wire payload format and committed as ONE WAL record."""

    def __init__(self):
        self._buf = bytearray()
        self.count = 0

    def put(self, key: bytes, value: bytes) -> "Batch":
        self._buf.append(0)
        self._buf += len(key).to_bytes(4, "little")
        self._buf += len(value).to_bytes(4, "little")
        self._buf += key
        self._buf += value
        self.count += 1
        return self

    def delete(self, key: bytes) -> "Batch":
        self._buf.append(1)
        self._buf += len(key).to_bytes(4, "little")
        self._buf += (0).to_bytes(4, "little")
        self._buf += key
        self.count += 1
        return self

    def payload(self) -> bytes:
        return bytes(self._buf)

    def ops(self):
        """Decode the buffered ops back out: yields ("put", key,
        value) / ("del", key, None). The wire layout (op byte, klen
        u32le, vlen u32le, key, value) lives HERE only — fault
        injectors (:class:`crdt_tpu_torch.guard.faults.FaultyKv`)
        replay batches op by op through this iterator, so a format
        change cannot silently desynchronize the crash-point harness."""
        buf, i = self._buf, 0
        while i < len(buf):
            op = buf[i]
            klen = int.from_bytes(buf[i + 1:i + 5], "little")
            vlen = int.from_bytes(buf[i + 5:i + 9], "little")
            key = bytes(buf[i + 9:i + 9 + klen])
            val = bytes(buf[i + 9 + klen:i + 9 + klen + vlen])
            i += 9 + klen + vlen
            yield ("put", key, val) if op == 0 else ("del", key, None)


class KvLog:
    """One open store (= one log file). Not multi-process safe — same
    single-owner contract as a LevelDB directory."""

    def __init__(self, path: str):
        self._lib = _load()
        Path(path).parent.mkdir(parents=True, exist_ok=True)  # crdt.js:12-16
        err = ctypes.create_string_buffer(256)
        self._h = self._lib.kv_open(str(path).encode(), err, 256)
        if not self._h:
            raise OSError(f"kv_open({path}): {err.value.decode()}")
        self.path = str(path)

    @property
    def _handle(self):
        # close() nulls the handle; passing NULL to the C ABI would
        # segfault the interpreter instead of raising
        if not self._h:
            raise RuntimeError(f"store {self.path} is closed")
        return self._h

    # -- point ops ---------------------------------------------------------
    def put(self, key: bytes, value: bytes) -> None:
        if self._lib.kv_put(self._handle, _as_u8p(key), len(key), _as_u8p(value), len(value)):
            raise OSError("kv_put failed")

    def get(self, key: bytes) -> Optional[bytes]:  # crdtlint: taints
        out = ctypes.POINTER(ctypes.c_uint8)()
        n = ctypes.c_uint32()
        rc = self._lib.kv_get(self._handle, _as_u8p(key), len(key), ctypes.byref(out), ctypes.byref(n))
        if rc == 1:
            return None
        if rc != 0:
            raise OSError("kv_get failed")
        return _take_bytes(self._lib, out, n.value)

    def delete(self, key: bytes) -> None:
        if self._lib.kv_del(self._handle, _as_u8p(key), len(key)):
            raise OSError("kv_del failed")

    def write(self, batch: Batch) -> None:
        payload = batch.payload()
        rc = self._lib.kv_batch(self._handle, _as_u8p(payload), len(payload))
        if rc == -2:
            raise ValueError("malformed batch payload")
        if rc != 0:
            raise OSError("kv_batch failed")

    # -- scans -------------------------------------------------------------
    # stored bytes were written by a peer (or survived a torn tail);
    # readers re-fence them like wire input
    # crdtlint: taints
    def scan(self, start: bytes = b"", end: bytes = b"") -> Iterator[Tuple[bytes, bytes]]:
        """Ordered iteration over [start, end); empty end = to the last
        key. Snapshot semantics (writes during iteration don't appear):
        the native iterator snapshots here, eagerly, not on first
        ``next()`` of the returned generator."""
        it = self._lib.kv_scan(self._handle, _as_u8p(start), len(start), _as_u8p(end), len(end))
        if not it:
            raise OSError("kv_scan failed")
        return self._drain_iter(it)

    def _drain_iter(self, it) -> Iterator[Tuple[bytes, bytes]]:
        try:
            while True:
                kp = ctypes.POINTER(ctypes.c_uint8)()
                vp = ctypes.POINTER(ctypes.c_uint8)()
                kn = ctypes.c_uint32()
                vn = ctypes.c_uint32()
                rc = self._lib.kv_iter_next(
                    it, ctypes.byref(kp), ctypes.byref(kn), ctypes.byref(vp), ctypes.byref(vn)
                )
                if rc == 1:
                    return
                if rc != 0:
                    raise OSError("kv_iter_next failed")
                yield (
                    _take_bytes(self._lib, kp, kn.value),
                    _take_bytes(self._lib, vp, vn.value),
                )
        finally:
            self._lib.kv_iter_close(it)

    def scan_prefix(self, prefix: bytes) -> Iterator[Tuple[bytes, bytes]]:  # crdtlint: taints
        """The reference's gt/lt prefix range (crdt.js:115-118)."""
        return self.scan(prefix, prefix + b"\xff")

    def keys(self, prefix: bytes = b"") -> List[bytes]:  # crdtlint: taints
        return [k for k, _ in self.scan_prefix(prefix)] if prefix else [
            k for k, _ in self.scan()
        ]

    # -- maintenance -------------------------------------------------------
    def sync(self) -> None:
        if self._lib.kv_sync(self._handle):
            raise OSError("kv_sync failed")

    def compact(self) -> None:
        if self._lib.kv_compact(self._handle):
            raise OSError("kv_compact failed")

    def close(self) -> None:
        if self._h:
            self._lib.kv_close(self._h)
            self._h = None

    def __len__(self) -> int:
        return int(self._lib.kv_count(self._handle))

    @property
    def log_size(self) -> int:
        """Bytes in the on-disk log (history included)."""
        return int(self._lib.kv_log_size(self._handle))

    @property
    def live_size(self) -> int:
        """Bytes of live key+value data (what compaction keeps)."""
        return int(self._lib.kv_live_size(self._handle))

    def __enter__(self) -> "KvLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
