"""Seeded storage fault adversaries and the shared retry helper.

The port's copy of the storage half of ``crdt_tpu.guard.faults``:
:class:`DiskFaultSchedule` + :class:`FaultyKv` wrap a
:class:`crdt_tpu_torch.storage.kv.KvLog` and inject ``ENOSPC`` / ``EIO``
write failures (seeded probabilities or an explicit write-index set),
TORN batches (the first half of a multi-op batch lands, then the write
dies — a store without the native log's atomic batch), and CRASH POINTS
(a :class:`SimulatedCrash` at the j-th op of the i-th batch, after which
the wrapper is dead); :func:`retry_with_backoff` is the storage failure
policy's retry loop (``LogPersistence``).

The reference module's other adversaries — ``FaultyFs`` (the snapshot
writer's file primitives), ``DeviceFaultPlan``, ``WithholdDeps`` and
``MigrationCrashPlan`` — are not ported: they stay with ROADMAP.md
queue A item 7b. The port's device faults are injected through
:func:`crdt_tpu_torch.ops.device.set_device_fault_hook`.
"""

from __future__ import annotations

import errno
import time
import zlib
from typing import Dict, Iterable, List, Optional, Set, Tuple

from crdt_tpu_torch.obs.recorder import get_recorder
from crdt_tpu_torch.obs.tracer import get_tracer


def _hash01(*key) -> float:
    """Stable [0, 1) hash of a tuple of primitives — process-salt-free
    (unlike ``hash``), so schedules replay across runs (the reference's
    ``crdt_tpu.net.faults._hash01``)."""
    return zlib.crc32(repr(key).encode()) / 2**32


class SimulatedCrash(BaseException):
    """A process kill at a storage op. BaseException on purpose: no
    retry/degrade policy may swallow it (a real crash isn't caught),
    only the test harness driving the crash-point matrix does."""


class DiskFaultSchedule:
    """Per-write fault plan for :class:`FaultyKv`.

    Two addressing modes, composable:

    - seeded probabilities ``enospc`` / ``eio`` / ``torn`` per write
      index (crc32-hashed like the network schedule — replayable),
      with ``heal_after`` capping the total number of injected faults
      (the recovery leg needs the disk to come back);
    - explicit ``fail_writes`` — a set of write indices that raise
      ``eio_errno``-style ``OSError`` deterministically (pinning exact
      retry/degrade counter values in tests).

    ``crash_at=(batch_index, op_index)`` arms ONE simulated process
    kill: the ``batch_index``-th ``write()`` applies its first
    ``op_index`` ops individually, then raises
    :class:`SimulatedCrash` and the wrapper goes dead.
    """

    def __init__(
        self,
        seed: int = 0,
        *,
        enospc: float = 0.0,
        eio: float = 0.0,
        torn: float = 0.0,
        heal_after: Optional[int] = None,
        fail_writes: Iterable[int] = (),
        fail_errno: int = errno.EIO,
        crash_at: Optional[Tuple[int, int]] = None,
    ):
        self.seed = seed
        self.enospc = enospc
        self.eio = eio
        self.torn = torn
        self.heal_after = heal_after
        self.fail_writes: Set[int] = set(fail_writes)
        self.fail_errno = fail_errno
        self.crash_at = crash_at
        self.fired = 0

    def decide(self, n: int) -> Optional[str]:
        """Fault kind for the n-th write(): "enospc" | "eio" | "torn"
        | "crash" | None."""
        if self.crash_at is not None and n == self.crash_at[0]:
            return "crash"
        if n in self.fail_writes:
            self.fired += 1
            return "eio" if self.fail_errno == errno.EIO else "enospc"
        if self.heal_after is not None and self.fired >= self.heal_after:
            return None
        for kind, p in (("enospc", self.enospc), ("eio", self.eio),
                        ("torn", self.torn)):
            if p and _hash01(self.seed, kind, n) < p:
                self.fired += 1
                return kind
        return None


class FaultyKv:
    """KvLog wrapper applying a :class:`DiskFaultSchedule` to writes.

    Same surface as :class:`crdt_tpu_torch.storage.kv.KvLog`; install via
    ``LogPersistence(path, kv_wrapper=lambda kv: FaultyKv(kv, sched))``
    (the seam survives close/open cycles). Only ``write`` (the batch
    verb every LogPersistence mutation uses) consults the schedule;
    reads pass through untouched. ``batches`` records each batch's op
    count so a clean run can enumerate the crash-point matrix."""

    def __init__(self, inner, schedule: DiskFaultSchedule):
        self._inner = inner
        self.schedule = schedule
        self.writes = 0
        self.batches: List[int] = []
        self.dead = False
        self.stats: Dict[str, int] = {
            "enospc": 0, "eio": 0, "torn": 0, "crashed": 0,
        }

    def write(self, batch) -> None:
        if self.dead:
            raise SimulatedCrash("store is dead (post-crash)")
        n = self.writes
        self.writes += 1
        ops = list(batch.ops())
        self.batches.append(len(ops))
        kind = self.schedule.decide(n)
        rec = get_recorder()
        if kind and rec.enabled:
            rec.record("fault.disk", kind=kind, write=n, ops=len(ops))
        if kind == "crash":
            self._apply_ops(ops[: self.schedule.crash_at[1]])
            self.stats["crashed"] += 1
            self.dead = True
            raise SimulatedCrash(
                f"crash at write {n} op {self.schedule.crash_at[1]}"
            )
        if kind == "enospc":
            self.stats["enospc"] += 1
            raise OSError(errno.ENOSPC, "injected: no space left")
        if kind == "eio":
            self.stats["eio"] += 1
            raise OSError(errno.EIO, "injected: I/O error")
        if kind == "torn":
            # the first half lands, then the write dies — the torn
            # multi-op batch a store WITHOUT atomic batches produces
            self._apply_ops(ops[: len(ops) // 2])
            self.stats["torn"] += 1
            raise OSError(errno.EIO, "injected: torn batch")
        self._inner.write(batch)

    def _apply_ops(self, ops) -> None:
        for op, key, val in ops:
            if op == "put":
                self._inner.put(key, val)
            else:
                self._inner.delete(key)

    def close(self) -> None:
        self._inner.close()

    def __getattr__(self, name):
        return getattr(self._inner, name)


def retry_with_backoff(fn, *, retries: int, backoff_s: float,
                       counter: Optional[str] = None):
    """Run ``fn`` with up to ``retries`` retries on ``OSError``,
    sleeping ``backoff_s * 2**attempt`` between attempts. The last
    failure re-raises. Shared by the storage failure policy (and any
    future retryable seam); ``counter`` names the tracer counter
    bumped once per retry."""
    for attempt in range(retries + 1):
        try:
            return fn()
        except OSError:
            if attempt == retries:
                raise
            if counter:
                get_tracer().count(counter)
            time.sleep(backoff_s * (2 ** attempt))
