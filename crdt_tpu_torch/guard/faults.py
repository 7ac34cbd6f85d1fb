"""Seeded storage + device fault adversaries (net/faults.py style).

The port's copy of ``crdt_tpu.guard.faults``. The network fabric's
lesson: recovery behavior is only trusted when the adversary is a
reusable, SEEDED object whose schedule replays identically run to run. This module extends that discipline to the two
failure domains the network schedule cannot reach:

- **disk** — :class:`DiskFaultSchedule` + :class:`FaultyKv` wrap a
  :class:`crdt_tpu_torch.storage.kv.KvLog` and inject ``ENOSPC`` / ``EIO``
  write failures (seeded probabilities or an explicit write-index
  set), TORN batches (the first half of a multi-op batch lands, then
  the write dies — simulating a store without the native log's atomic
  batch), and CRASH POINTS (a :class:`SimulatedCrash` at the j-th op
  of the i-th batch, after which the wrapper is dead — the crash-point
  matrix over ``LogPersistence.compact``/``store_updates`` reopens the
  real file underneath and proves no acked update is lost).
  :class:`FaultyFs` extends the same schedule to the snapshot
  writer's file primitives (write/fsync/rename/unlink), so the
  round-21 snapshot ALICE matrix kills the writer at every op.
- **device** — :class:`DeviceFaultPlan` installs itself as the
  :func:`crdt_tpu_torch.ops.device.set_device_fault_hook` hook and fails the
  first N guarded dispatch attempts with ``RuntimeError`` (optionally
  stage-filtered), driving the retry → split → host ladder in
  :mod:`crdt_tpu_torch.guard.device` without a real dying card.
- **network** — :class:`WithholdDeps`, the dependency-withholding
  adversary: a :class:`crdt_tpu_torch.net.faults.FaultSchedule` that drops
  the first W messages of chosen flows, so later updates arrive first,
  stash as pending, and (under a pending cap) force evictions that
  only the SV re-probe path can repair.
"""

from __future__ import annotations

import errno
import time
from typing import Dict, Iterable, List, Optional, Set, Tuple

from crdt_tpu_torch.net.faults import FaultSchedule, _hash01
from crdt_tpu_torch.obs.recorder import get_recorder
from crdt_tpu_torch.obs.tracer import get_tracer


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
            rec.record("fault.disk", fault=kind, write=n, ops=len(ops))
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


class FaultyFs:
    """Snapshot-seam fs adversary (round 21): wraps the
    :class:`crdt_tpu_torch.storage.snapshot.Fs` primitives and applies a
    :class:`DiskFaultSchedule` to every MUTATING op — ``write``,
    ``fsync``, ``rename``, ``fsync_dir``, ``unlink`` — addressed by a
    single per-op index (the n-th mutating op overall), so
    ``crash_at=(i, 0)`` kills the writer immediately BEFORE its i-th
    op and ``torn`` lands half the bytes of a ``write`` before dying.
    Together the two modes cover every prefix of the snapshot
    writer's op sequence — the ALICE matrix ``tests/test_snapshot.py``
    enumerates from a clean run's recorded ``ops`` list. Reads pass
    through untouched (recovery must see whatever the crash left)."""

    def __init__(self, inner, schedule: DiskFaultSchedule):
        self._inner = inner
        self.schedule = schedule
        self.n = 0
        self.ops: List[Tuple[str, str]] = []
        self.dead = False
        self.stats: Dict[str, int] = {
            "enospc": 0, "eio": 0, "torn": 0, "crashed": 0,
        }

    def _gate(self, verb: str, path: str, data: Optional[bytes] = None):
        if self.dead:
            raise SimulatedCrash("fs is dead (post-crash)")
        n = self.n
        self.n += 1
        self.ops.append((verb, path))
        kind = self.schedule.decide(n)
        rec = get_recorder()
        if kind and rec.enabled:
            rec.record("fault.fs", fault=kind, op=n, verb=verb)
        if kind == "crash":
            # crash BEFORE the op applies (torn covers the mid-write
            # states); the fs is dead from here on
            self.stats["crashed"] += 1
            self.dead = True
            raise SimulatedCrash(f"crash at fs op {n} ({verb})")
        if kind == "enospc":
            self.stats["enospc"] += 1
            raise OSError(errno.ENOSPC, "injected: no space left")
        if kind == "eio":
            self.stats["eio"] += 1
            raise OSError(errno.EIO, "injected: I/O error")
        if kind == "torn":
            self.stats["torn"] += 1
            if verb == "write" and data:
                self._inner.write(path, data[: len(data) // 2])
            raise OSError(errno.EIO, "injected: torn write")
        return None

    def write(self, path: str, data: bytes) -> None:
        self._gate("write", path, data)
        self._inner.write(path, data)

    def fsync(self, path: str) -> None:
        self._gate("fsync", path)
        self._inner.fsync(path)

    def rename(self, src: str, dst: str) -> None:
        self._gate("rename", src)
        self._inner.rename(src, dst)

    def fsync_dir(self, path: str) -> None:
        self._gate("fsync_dir", path)
        self._inner.fsync_dir(path)

    def unlink(self, path: str) -> None:
        self._gate("unlink", path)
        self._inner.unlink(path)

    def __getattr__(self, name):
        return getattr(self._inner, name)


class DeviceFaultPlan:
    """Scripted device-fault injector for the guarded-dispatch hook.

    Fails the first ``fail_attempts`` guarded attempts whose stage
    matches ``stages`` (``None`` = every stage) with ``RuntimeError``,
    then heals. Use as a context manager (or ``install()`` /
    ``uninstall()``) — the hook slot in :mod:`crdt_tpu_torch.ops.device` is
    process-global."""

    def __init__(self, fail_attempts: int = 2,
                 stages: Optional[Iterable[str]] = None):
        self.fail_attempts = fail_attempts
        self.stages = set(stages) if stages is not None else None
        self.fired = 0
        self._old = None

    def __call__(self, stage: str, attempt: int) -> None:
        if self.stages is not None and stage not in self.stages:
            return
        if self.fired < self.fail_attempts:
            self.fired += 1
            raise RuntimeError(
                f"injected device fault #{self.fired} at {stage!r} "
                f"(attempt {attempt})"
            )

    def install(self) -> "DeviceFaultPlan":
        from crdt_tpu_torch.ops.device import set_device_fault_hook

        self._old = set_device_fault_hook(self)
        return self

    def uninstall(self) -> None:
        from crdt_tpu_torch.ops.device import set_device_fault_hook

        set_device_fault_hook(self._old)
        self._old = None

    def __enter__(self) -> "DeviceFaultPlan":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()


class WithholdDeps(FaultSchedule):
    """Dependency-withholding adversary: DROP the first ``withhold``
    messages of each flow in ``flows`` (``(src_port, dst_port)``
    pairs), then behave like the base schedule. The receiver sees
    later updates before their dependencies, stashes them pending, and
    — under a pending cap — evicts; only the SV re-probe path (the
    withheld sender answers a ready probe with the full diff) repairs
    the gap, which is exactly the recovery the chaos tests pin."""

    def __init__(self, seed: int = 0, *,
                 flows: Iterable[Tuple[int, int]] = (),
                 withhold: int = 2, **kw):
        super().__init__(seed, **kw)
        self.flows = set(flows)
        self.withhold = withhold
        self.withheld = 0

    def decide(self, src: int, dst: int, n: int) -> dict:
        if (src, dst) in self.flows and n < self.withhold:
            self.withheld += 1
            return {"drop": True, "dup": False, "delay": 0,
                    "corrupt": False, "withheld": True}
        return super().decide(src, dst, n)


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


class MigrationCrashPlan:
    """Process-kill-at-step-k for the fleet migration ladder
    (round 24): :meth:`check` is called at every migration step
    boundary (``fleet/migration.py``); the k-th occurrence of a
    scheduled step raises :class:`SimulatedCrash` — the chaos
    harness catches it and kills that node, exactly like the disk
    matrix's ``crash_at``. Deterministic by construction: occurrence
    counts, no clocks, no randomness."""

    def __init__(self, kill_at: Optional[dict] = None):
        # step name -> 1-based occurrence at which to die
        self.kill_at = dict(kill_at or {})
        self.seen: dict = {}
        self.fired: list = []

    def check(self, step: str) -> None:
        n = self.seen.get(step, 0) + 1
        self.seen[step] = n
        k = self.kill_at.get(step)
        if k is not None and n == k:
            self.fired.append(step)
            raise SimulatedCrash(
                "migration step %s occurrence %d" % (step, n))
