"""Sync flight recorder: bounded ring buffer of structured events.

The port's copy of ``crdt_tpu.obs.recorder``. A Dapper-style record of
an update's life at the sync seams, kept in a fixed-size ring so it is
always cheap and always recent. The port's producer so far is the
guarded device ladder (:mod:`crdt_tpu_torch.guard.device`, event kind
``device.fault``); the consumer is a human doing a postmortem:
``dump_jsonl()`` on demand.

Events are plain dicts: ``{"ts": <monotonic seconds>, "kind": str,
...}`` with producer-chosen fields. Disabled by default; when disabled
every ``record()`` is a single attribute check. Thread-safe (one lock;
the ring is a deque with maxlen, so wraparound is O(1) and
allocation-free at steady state).
"""

from __future__ import annotations

import json
import threading
import time
import zlib
from collections import deque
from typing import Any, Dict, List, Optional


def update_digest(data: bytes) -> str:
    """Short stable digest of an update blob for event correlation
    (crc32 — identification, not integrity; envelopes are already
    authenticated at the transport)."""
    return f"{zlib.crc32(bytes(data)) & 0xFFFFFFFF:08x}"


class FlightRecorder:
    """Bounded ring of structured sync events."""

    def __init__(self, capacity: int = 4096, *, enabled: bool = False):
        self.enabled = enabled
        self.capacity = capacity
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=capacity)
        self.recorded = 0  # total ever recorded (ring may have evicted)

    def record(self, kind: str, **fields: Any) -> None:
        if not self.enabled:
            return
        ev = {"ts": time.monotonic(), "kind": kind}
        ev.update(fields)
        with self._lock:
            self._ring.append(ev)
            self.recorded += 1

    def events(self, kind: Optional[str] = None) -> List[Dict[str, Any]]:
        """Snapshot of the ring (oldest first), optionally filtered."""
        with self._lock:
            evs = list(self._ring)
        if kind is not None:
            evs = [e for e in evs if e["kind"] == kind]
        return evs

    def dump_jsonl(self, path: Optional[str] = None) -> str:
        """The ring as JSONL (one event per line, oldest first); when
        ``path`` is given the dump is also written there."""
        text = "\n".join(
            json.dumps(e, sort_keys=True, default=str)
            for e in self.events()
        )
        if text:
            text += "\n"
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


_recorder = FlightRecorder(enabled=False)


def get_recorder() -> FlightRecorder:
    return _recorder


def set_recorder(recorder: FlightRecorder) -> FlightRecorder:
    global _recorder
    _recorder = recorder
    return recorder
