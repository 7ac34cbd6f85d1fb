"""Shared retry-timing helpers for the partition-tolerance layer (the
port's copy of ``crdt_tpu.utils.backoff``)."""

from __future__ import annotations

import random


def jitter(spread: float = 0.25) -> float:
    """Multiplicative jitter factor in [1-spread, 1+spread]: keeps a
    fleet's retry timers from phase-locking into synchronized bursts
    (the thundering-herd failure mode of un-jittered backoff). Used by
    the replica's probe / anti-entropy cadence — one constant, tuned in
    one place."""
    return 1.0 + spread * (2.0 * random.random() - 1.0)
