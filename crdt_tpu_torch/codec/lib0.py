"""lib0-compatible binary primitives (varint / string / any encoding).

The Yjs v1 update format (consumed by the reference through
``Y.encodeStateAsUpdate`` / ``Y.applyUpdate``, crdt.js:56,294) is built
on the lib0 encoding library. This module reimplements the wire-level
primitives from the published format description so our updates stay
byte-compatible with Yjs v1:

- varUint: little-endian base-128, 7 payload bits per byte, high bit
  set on all but the last byte.
- varInt: first byte carries sign (0x40) and 6 payload bits; later
  bytes carry 7 bits; 0x80 is the continue bit throughout.
- varString: varUint byte-length prefix + UTF-8 bytes.
- varUint8Array: varUint length prefix + raw bytes.
- any: one type byte (127=undefined, 126=null, 125=varInt, 124=f32,
  123=f64, 122=i64, 121=false, 120=true, 119=string, 118=object,
  117=array, 116=Uint8Array) followed by the payload.
"""

from __future__ import annotations

import math
import struct
from typing import Any, List


class Undefined:
    """Sentinel distinguishing JS `undefined` from `null` (Python None)."""

    _inst = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = super().__new__(cls)
        return cls._inst

    def __repr__(self):
        return "undefined"


UNDEFINED = Undefined()


class Encoder:
    __slots__ = ("_parts",)

    def __init__(self):
        self._parts: List[bytes] = []

    def to_bytes(self) -> bytes:
        return b"".join(self._parts)

    def write_uint8(self, n: int) -> None:
        self._parts.append(bytes((n & 0xFF,)))

    def write_var_uint(self, n: int) -> None:
        if n < 0:
            raise ValueError(f"varUint must be >= 0, got {n}")
        out = bytearray()
        while True:
            b = n & 0x7F
            n >>= 7
            if n:
                out.append(0x80 | b)
            else:
                out.append(b)
                break
        self._parts.append(bytes(out))

    def write_var_int(self, n: int) -> None:
        is_neg = n < 0
        if is_neg:
            n = -n
        # first byte: continue(0x80) | sign(0x40) | 6 bits
        first = (0x40 if is_neg else 0) | (n & 0x3F)
        n >>= 6
        out = bytearray()
        if n:
            out.append(0x80 | first)
            while True:
                b = n & 0x7F
                n >>= 7
                if n:
                    out.append(0x80 | b)
                else:
                    out.append(b)
                    break
        else:
            out.append(first)
        self._parts.append(bytes(out))

    def write_var_string(self, s: str) -> None:
        data = s.encode("utf-8")
        self.write_var_uint(len(data))
        self._parts.append(data)

    def write_var_uint8_array(self, data: bytes) -> None:
        self.write_var_uint(len(data))
        self._parts.append(bytes(data))

    def write_bytes(self, data: bytes) -> None:
        self._parts.append(bytes(data))

    def write_float32(self, x: float) -> None:
        self._parts.append(struct.pack(">f", x))

    def write_float64(self, x: float) -> None:
        self._parts.append(struct.pack(">d", x))

    def write_int64(self, n: int) -> None:
        self._parts.append(struct.pack(">q", n))

    def write_any(self, v: Any) -> None:
        if v is UNDEFINED:
            self.write_uint8(127)
        elif v is None:
            self.write_uint8(126)
        elif isinstance(v, bool):  # must precede int check
            self.write_uint8(120 if v else 121)
        elif isinstance(v, int):
            # lib0 uses varInt for every JS safe integer; type 122
            # (fixed int64 BigInt) only beyond Number.MAX_SAFE_INTEGER
            if -(2**53) < v < 2**53:
                self.write_uint8(125)
                self.write_var_int(v)
            elif -(2**63) <= v < 2**63:
                self.write_uint8(122)
                self.write_int64(v)
            else:
                # lib0 bigint is a fixed 8-byte field; larger cannot be represented
                raise TypeError(f"integer {v} out of lib0 bigint (int64) range")
        elif isinstance(v, float):
            if math.isfinite(v):
                # use f32 when exactly representable; values at/above
                # the f32 rounding boundary are legal f64 payloads and
                # must not OverflowError out of the probe
                try:
                    f32 = struct.unpack(">f", struct.pack(">f", v))[0]
                except (OverflowError, struct.error):
                    f32 = None
                if f32 == v:
                    self.write_uint8(124)
                    self.write_float32(v)
                    return
            self.write_uint8(123)
            self.write_float64(v)
        elif isinstance(v, str):
            self.write_uint8(119)
            self.write_var_string(v)
        elif isinstance(v, dict):
            self.write_uint8(118)
            self.write_var_uint(len(v))
            for k, val in v.items():
                self.write_var_string(str(k))
                self.write_any(val)
        elif isinstance(v, (list, tuple)):
            self.write_uint8(117)
            self.write_var_uint(len(v))
            for item in v:
                self.write_any(item)
        elif isinstance(v, (bytes, bytearray)):
            self.write_uint8(116)
            self.write_var_uint8_array(bytes(v))
        else:
            raise TypeError(f"cannot encode value of type {type(v)!r} as lib0 any")


class Decoder:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = bytes(data)
        self.pos = 0

    def has_content(self) -> bool:
        return self.pos < len(self.data)

    def remaining(self) -> int:
        """Bytes left to read — the buffer-anchored bound defensive
        decoders (state vectors, trace contexts) fence declared
        counts against before trusting them."""
        return len(self.data) - self.pos

    def read_uint8(self) -> int:
        if self.pos >= len(self.data):
            raise ValueError("unexpected end of lib0 buffer")
        b = self.data[self.pos]
        self.pos += 1
        return b

    def read_var_uint(self) -> int:
        n = 0
        shift = 0
        while True:
            b = self.read_uint8()
            n |= (b & 0x7F) << shift
            if not (b & 0x80):
                # uint64-representability, mirroring the native
                # reader's overflow rejection at EVERY varuint
                # position (flag/count positions included): a value
                # only python's bigints can hold would make a
                # python-decoding and a native-decoding replica
                # disagree on the same blob
                if n >= (1 << 64):
                    raise ValueError("varUint exceeds uint64")
                return n
            shift += 7
            if shift > 70:
                raise ValueError("varUint too long")

    def read_var_int(self) -> int:
        b = self.read_uint8()
        sign = -1 if b & 0x40 else 1
        n = b & 0x3F
        shift = 6
        while b & 0x80:
            b = self.read_uint8()
            n |= (b & 0x7F) << shift
            shift += 7
            if shift > 70:
                raise ValueError("varInt too long")
        # int64-representability bound, shared with the native codec:
        # magnitudes in [2^63, 2^64) wrap negative through its int64
        # cast, so a python-decoding and a native-decoding replica
        # would silently diverge on the same blob (honest lib0 writers
        # emit JS safe integers, < 2^53)
        if n >= (1 << 63):
            raise ValueError("varInt magnitude exceeds int64")
        return sign * n

    def read_var_string(self) -> str:
        return self.read_bytes(self.read_var_uint()).decode("utf-8")

    def read_var_uint8_array(self) -> bytes:
        return self.read_bytes(self.read_var_uint())

    def read_bytes(self, n: int) -> bytes:  # crdtlint: sanitizes
        # the pre-check fences the SIGN too: a negative count would
        # pass the tail check, return a truncated slice, and silently
        # REWIND the cursor (pos += n), letting a decoder re-read
        # bytes forever (round-17 decode-allocation contract)
        if n < 0:
            raise ValueError("negative lib0 byte count")
        if self.pos + n > len(self.data):
            raise ValueError("unexpected end of lib0 buffer")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def read_float32(self) -> float:
        return struct.unpack(">f", self.read_bytes(4))[0]

    def read_float64(self) -> float:
        return struct.unpack(">d", self.read_bytes(8))[0]

    def read_int64(self) -> int:
        return struct.unpack(">q", self.read_bytes(8))[0]

    def read_any(self) -> Any:
        t = self.read_uint8()
        if t == 127:
            return UNDEFINED
        if t == 126:
            return None
        if t == 125:
            return self.read_var_int()
        if t == 124:
            return self.read_float32()
        if t == 123:
            return self.read_float64()
        if t == 122:
            return self.read_int64()
        if t == 121:
            return False
        if t == 120:
            return True
        if t == 119:
            return self.read_var_string()
        if t == 118:
            n = self.read_var_uint()
            return {self.read_var_string(): self.read_any() for _ in range(n)}
        if t == 117:
            n = self.read_var_uint()
            return [self.read_any() for _ in range(n)]
        if t == 116:
            return self.read_var_uint8_array()
        raise ValueError(f"unknown lib0 any type byte {t}")
