"""Inter-server frame codec for the fleet layer.

The port's copy of ``crdt_tpu.fleet.wire``: frames and blob lists
byte-equal to the reference's, so port and reference nodes talk on
one fabric.

One binary framing for every fleet message — forwarded updates,
migration offers/commits, probes, and ownership beacons — whether it
rides the in-process chaos fabric or the round-7 sealed UDP streams
(``net/transport.py`` encrypts the WHOLE frame, so the header is
never on the wire in the clear).

Layout::

    b"CFR1" | u32 header_len | header_json | payload bytes

The header is a flat JSON dict carrying ``kind`` plus the fencing
stamp (``epoch``/``proc``) and message-specific fields; the payload
is opaque bytes (snapshot generations, history blobs). Multi-blob
payloads are length-prefixed (:func:`pack_blobs`). Decode is
defensive: damaged frames return ``None`` and count
``fleet.frames_malformed`` — a fleet peer is still an untrusted
input once the seal is off.
"""

from __future__ import annotations

import json
import struct
from typing import Any, Dict, List, Optional, Tuple

from crdt_tpu_torch.obs import get_tracer

MAGIC = b"CFR1"
_MAX_HEADER = 1 << 20

# frame kinds (the protocol surface; migration.py documents the
# state machine they drive)
KINDS = frozenset({
    "update",      # forwarded client update: doc, epoch, proc + blob
    "redirect",    # ownership hint back to a mis-routed sender
    "offer",       # migration step 2: snapshot/tail payload
    "rehydrated",  # dst -> src: payload adopted, awaiting commit
    "commit",      # src -> dst: epoch bump + late tail blobs
    "ack",         # dst -> src: serving at the new epoch
    "nack",        # dst -> src: migration unknown/refused
    "probe",       # who owns doc? (the ack-loss resolver)
    "probe_reply",
    "beacon",      # sentinel: owned-doc epochs, fork detection
})


def encode_frame(header: Dict[str, Any], payload: bytes = b"") -> bytes:
    hj = json.dumps(header, sort_keys=True,
                    separators=(",", ":")).encode()
    return MAGIC + struct.pack("<I", len(hj)) + hj + payload


def decode_frame(
    data: bytes,
) -> Optional[Tuple[Dict[str, Any], bytes]]:
    """Parse one frame; ``None`` (counted) on any damage."""
    try:
        if len(data) < 8 or data[:4] != MAGIC:
            raise ValueError("bad magic")
        (hlen,) = struct.unpack("<I", data[4:8])
        if hlen > _MAX_HEADER or 8 + hlen > len(data):
            raise ValueError("bad header length")
        header = json.loads(data[8:8 + hlen])
        if not isinstance(header, dict):
            raise ValueError("header not a dict")
        kind = header.get("kind")
        if kind not in KINDS:
            raise ValueError("unknown kind")
        return header, data[8 + hlen:]
    except (ValueError, struct.error, UnicodeDecodeError):
        tracer = get_tracer()
        if tracer.enabled:
            tracer.count("fleet.frames_malformed")
        return None


def pack_blobs(blobs: List[bytes]) -> bytes:
    """Length-prefixed blob list (u32 count, then u32+bytes each)."""
    parts = [struct.pack("<I", len(blobs))]
    for b in blobs:
        parts.append(struct.pack("<I", len(b)))
        parts.append(bytes(b))
    return b"".join(parts)


def unpack_blobs(data: bytes) -> Optional[List[bytes]]:
    """Inverse of :func:`pack_blobs`; ``None`` on damage (the
    caller's frame already counted, this keeps the refusal exact)."""
    try:
        if len(data) < 4:
            raise ValueError("short")
        (n,) = struct.unpack("<I", data[:4])
        if n > len(data):  # each blob needs >= 4 bytes of prefix
            raise ValueError("count")
        off = 4
        out: List[bytes] = []
        for _ in range(n):
            if off + 4 > len(data):
                raise ValueError("truncated prefix")
            (ln,) = struct.unpack("<I", data[off:off + 4])
            off += 4
            if off + ln > len(data):
                raise ValueError("truncated blob")
            out.append(data[off:off + ln])
            off += ln
        if off != len(data):
            raise ValueError("trailing bytes")
        return out
    except (ValueError, struct.error):
        tracer = get_tracer()
        if tracer.enabled:
            tracer.count("fleet.frames_malformed")
        return None
