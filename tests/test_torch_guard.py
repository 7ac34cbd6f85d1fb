"""The port's guarded dispatch ladder (``crdt_tpu_torch.guard.device``)
against the reference's (``crdt_tpu.guard.device``).

Each scenario injects the same faults through each package's fault hook
and must give the same result, the same ``device.*`` counters and the
same flight-recorder events. The split rung, which no port caller uses
yet, is held here.
"""

import pytest
import torch

from crdt_tpu.guard.device import dispatch_guarded as ref_guarded
from crdt_tpu.obs import recorder as ref_recorder
from crdt_tpu.obs import tracer as ref_tracer
from crdt_tpu.ops import device as ref_device
from crdt_tpu_torch.guard.device import dispatch_guarded
from crdt_tpu_torch.obs import recorder, tracer
from crdt_tpu_torch.ops import device
from crdt_tpu_torch.ops._build import KernelError


def _hook(failing):
    """A fault hook that raises on the (stage, attempt) pairs it is
    given, in order of the calls it sees."""
    calls = []

    def hook(stage, attempt):
        calls.append((stage, attempt))
        if failing(len(calls) - 1, stage, attempt):
            raise RuntimeError(f"injected at call {len(calls) - 1}")

    return hook, calls


def _run(guarded, dev, trc, rec, failing, *, split, host):
    hook, calls = _hook(failing)
    t = trc.set_tracer(trc.Tracer(enabled=True))
    r = rec.set_recorder(rec.FlightRecorder(enabled=True))
    old = dev.set_device_fault_hook(hook)
    try:
        try:
            out = guarded("stage", lambda: "device", split=split, host=host)
        except RuntimeError as e:
            out = ("raised", str(e))
    finally:
        dev.set_device_fault_hook(old)
        trc.set_tracer(trc.Tracer(enabled=False))
        rec.set_recorder(rec.FlightRecorder(enabled=False))
    events = [(e["kind"], e["stage"], e["error"]) for e in r.events()]
    return out, calls, t.counters("device."), events


def _halves():
    return [(lambda: "half 0", lambda: "host 0"),
            (lambda: "half 1", lambda: "host 1")]


SCENARIOS = {
    "no fault": (lambda i, s, a: False, None, None),
    "one fault retries": (lambda i, s, a: i == 0, None, lambda: "host"),
    "two faults to host": (lambda i, s, a: i < 2, None, lambda: "host"),
    "two faults, no rung": (lambda i, s, a: i < 2, None, None),
    "split, halves on the device": (lambda i, s, a: i < 2, _halves,
                                    lambda: "host"),
    "split, every half to host": (lambda i, s, a: True, _halves,
                                  lambda: "host"),
    "split, second half to host": (lambda i, s, a: i < 2 or i >= 3,
                                   _halves, lambda: "host"),
    "split refused": (lambda i, s, a: i < 2, lambda: None, lambda: "host"),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_ladder_matches_reference(name):
    failing, split, host = SCENARIOS[name]
    got = _run(dispatch_guarded, device, tracer, recorder, failing,
               split=split, host=host)
    want = _run(ref_guarded, ref_device, ref_tracer, ref_recorder, failing,
                split=split, host=host)
    assert got == want


@pytest.mark.parametrize("error", [
    KernelError("stream_scatter launch: CUDA error 700"),
    torch.OutOfMemoryError("CUDA out of memory"),
    RuntimeError("CUDA error: an illegal memory access"),
], ids=["kernel error", "out of memory", "CUDA error"])
def test_kernel_errors_skip_every_rung(error):
    # only the fault hook climbs the ladder: whatever the dispatch
    # itself raises propagates with no retry, split or host rung
    def run():
        raise error

    t = tracer.set_tracer(tracer.Tracer(enabled=True))
    try:
        with pytest.raises(type(error)):
            dispatch_guarded("stage", run, split=_halves,
                             host=lambda: "host")
    finally:
        tracer.set_tracer(tracer.Tracer(enabled=False))
    assert t.counters("device.") == {}


# ---------------------------------------------------------------------------
# the adversaries of guard/faults.py and the eviction rule of guard/limits.py
# ---------------------------------------------------------------------------

from crdt_tpu.guard import faults as ref_faults  # noqa: E402
from crdt_tpu.guard.limits import evict_deepest as ref_evict_deepest  # noqa: E402
from crdt_tpu.models.incremental import IncrementalReplay as RefReplay  # noqa: E402
from crdt_tpu.models.replay import cold_start as ref_cold_start  # noqa: E402
from crdt_tpu.storage import snapshot as ref_sn  # noqa: E402
from crdt_tpu.storage.persistence import LogPersistence as RefLog  # noqa: E402
from crdt_tpu_torch import guard  # noqa: E402
from crdt_tpu_torch.guard import faults  # noqa: E402
from crdt_tpu_torch.guard.limits import evict_deepest  # noqa: E402
from crdt_tpu_torch.models.incremental import IncrementalReplay  # noqa: E402
from crdt_tpu_torch.models.replay import cold_start  # noqa: E402
from crdt_tpu_torch.storage import snapshot as sn  # noqa: E402
from crdt_tpu_torch.storage.persistence import LogPersistence  # noqa: E402
from tests.test_snapshot import Stream  # noqa: E402


def test_guard_exports_the_reference_names():
    import crdt_tpu.guard as ref_guard

    assert set(ref_guard.__all__) <= set(guard.__all__)
    assert guard.evict_deepest is evict_deepest


@pytest.mark.parametrize("limit", [0, 1, 4, 11, 40])
def test_evict_deepest_equals_reference(limit):
    rng = __import__("random").Random(limit)
    keys = list({(rng.randrange(5), rng.randrange(30)) for _ in range(40)})
    assert evict_deepest(keys, limit) == ref_evict_deepest(keys, limit)


# ---- FaultyFs: the snapshot writer's whole crash-prefix matrix


def _fs_stack(pkg):
    if pkg == "port":
        return (faults, sn, lambda: IncrementalReplay(device="cpu"),
                LogPersistence,
                lambda *a: cold_start(*a, device="cpu"))
    return ref_faults, ref_sn, RefReplay, RefLog, ref_cold_start


def _fs_workload(pkg, root, fs):
    """Two snapshot generations of one doc through ``fs`` (the
    reference's ALICE workload); returns the doc's blobs."""
    _, snap, replay, _, _ = _fs_stack(pkg)
    store = snap.SnapshotStore(root, fs=fs)
    s = Stream(5)
    blobs = [s.delta(8, deletes=(i % 7 == 6)) for i in range(10)]
    eng1 = replay()
    eng1.apply(blobs)
    store.write("d", snap.encode_engine(eng1, seq=10), 10)
    tail = [s.delta(8) for _ in range(4)]
    eng2 = replay()
    eng2.apply(blobs + tail)
    store.write("d", snap.encode_engine(eng2, seq=14), 14)
    return blobs + tail


def _fs_matrix(pkg, tmp):
    """Kill the writer before each of its fs ops, and tear each write;
    after each kill a cold start over the WAL and whatever the crash
    left. Returns the clean run's ops and every recovered full state."""
    flt, snap, _, log, start = _fs_stack(pkg)
    clean = flt.FaultyFs(snap.Fs(), flt.DiskFaultSchedule())
    blobs = _fs_workload(pkg, str(tmp / "clean"), clean)
    scenarios = [("crash", i) for i in range(len(clean.ops))]
    scenarios += [("torn", i) for i, (verb, _) in enumerate(clean.ops)
                  if verb == "write"]
    out = []
    for kind, i in scenarios:
        root = str(tmp / f"{kind}_{i}")
        lp = log(str(tmp / f"{kind}_{i}.kvlog"))
        for b in blobs:
            lp.store_update("d", b)
        if kind == "crash":
            sched = flt.DiskFaultSchedule(crash_at=(i, 0))
        else:
            sched = flt.DiskFaultSchedule()
            sched.decide = lambda n, _i=i: "torn" if n == _i else None
        fs = flt.FaultyFs(snap.Fs(), sched)
        try:
            _fs_workload(pkg, root, fs)
        except (flt.SimulatedCrash, OSError):
            pass
        eng, path = start("d", lp, snap.SnapshotStore(root))
        out.append((kind, i, fs.stats, fs.dead,
                    eng.encode_state_as_update()))
        lp.close()
    return clean.ops, out


def test_faulty_fs_crash_matrix_equals_reference(tmp_path):
    ops, got = _fs_matrix("port", tmp_path / "port")
    ref_ops, want = _fs_matrix("reference", tmp_path / "ref")
    assert [v for v, _ in ops] == [v for v, _ in ref_ops]
    assert len(ops) >= 10 and any(v == "unlink" for v, _ in ops)
    assert got == want
    # every prefix recovers the same full state: the pure WAL replay's
    full = {state for *_, state in got}
    assert len(full) == 1


def test_faulty_fs_enospc_and_eio_degrade(tmp_path):
    for errno_, pkg in ((28, "port"), (5, "port"), (28, "reference")):
        flt, snap, replay, _, _ = _fs_stack(pkg)
        fs = flt.FaultyFs(snap.Fs(), flt.DiskFaultSchedule(
            fail_writes={0}, fail_errno=errno_))
        with pytest.raises(OSError) as exc:
            fs.write(str(tmp_path / f"{pkg}{errno_}"), b"x")
        assert exc.value.errno == errno_
        fs.write(str(tmp_path / f"{pkg}{errno_}"), b"y")
        assert fs.n == 2 and fs.ops[0][0] == "write"


# ---- DeviceFaultPlan drives each package's ladder alike


def _plan_run(pkg, fail_attempts, stages, split, host):
    dev, trc, flt, guarded = (
        (device, tracer, faults, dispatch_guarded) if pkg == "port" else
        (ref_device, ref_tracer, ref_faults, ref_guarded))
    t = trc.set_tracer(trc.Tracer(enabled=True))
    try:
        with flt.DeviceFaultPlan(fail_attempts, stages=stages) as plan:
            assert dev.device_fault_hook() is plan if pkg == "port" \
                else True
            try:
                out = guarded("stage", lambda: "device", split=split,
                              host=host)
            except RuntimeError as e:
                out = ("raised", str(e))
        hook_after = dev.device_fault_hook() if pkg == "port" else None
    finally:
        trc.set_tracer(trc.Tracer(enabled=False))
    return out, plan.fired, t.counters("device."), hook_after


@pytest.mark.parametrize("fail_attempts", [0, 1, 2, 3, 4, 99])
@pytest.mark.parametrize("rungs", ["host", "split", "none", "filtered"])
def test_device_fault_plan_drives_the_ladder_as_the_reference(
        fail_attempts, rungs):
    split = _halves if rungs == "split" else None
    host = None if rungs == "none" else (lambda: "host")
    stages = {"other"} if rungs == "filtered" else None
    got = _plan_run("port", fail_attempts, stages, split, host)
    want = _plan_run("reference", fail_attempts, stages, split, host)
    assert got[:3] == want[:3]
    assert got[3] is None  # uninstalled on exit


@pytest.mark.parametrize("fail_attempts", [1, 2, 4, 99])
def test_device_fault_plan_on_the_port_device_merge(fail_attempts):
    """The plan under the port's device merge (``Crdt(device_merge=True)``
    on the CPU): every rung lands on the scalar document's state."""
    from crdt_tpu_torch.api.doc import Crdt

    src = Crdt(3)
    blobs = []
    src.on_update = lambda u, m: blobs.append(u)
    for i in range(8):
        src.set("m", f"k{i}", i)
        src.push("l", [i])
        src.set("nest", "arr", i, array_method="push")
    oracle = Crdt(9)
    oracle.apply_updates(blobs)
    t = tracer.set_tracer(tracer.Tracer(enabled=True))
    try:
        dev = Crdt(9, device_merge=True, device="cpu")
        with faults.DeviceFaultPlan(fail_attempts=fail_attempts) as plan:
            dev.apply_updates(blobs)
    finally:
        tracer.set_tracer(tracer.Tracer(enabled=False))
    assert plan.fired > 0
    assert dev.encode_state_as_update() == oracle.encode_state_as_update()
    assert dev.engine.to_json() == oracle.engine.to_json()
    c = t.counters("device.")
    assert c["device.retries"] >= 1
    if fail_attempts >= 2:
        assert c.get("device.fallback", 0) > 0


# ---- WithholdDeps: repair through the re-probe


GRID = [(src, dst, n) for src in (4000, 4001) for dst in (4001, 4002)
        for n in range(12)]


def test_withhold_deps_decisions_equal_reference():
    kw = dict(flows=[(4000, 4001)], withhold=3, drop=0.1, delay=0.2)
    ours, theirs = faults.WithholdDeps(5, **kw), \
        ref_faults.WithholdDeps(5, **kw)
    assert [ours.decide(*g) for g in GRID] == \
        [theirs.decide(*g) for g in GRID]
    assert ours.withheld == theirs.withheld == 3


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_withhold_deps_repaired_by_the_reprobe(pkg):
    """Over UDP: B's first two updates to A are withheld at the router
    seam; A stashes the later ones, evicts past its pending cap, and
    only the re-probe of B repairs the gap. Both packages end the same
    way: A equal to B, nothing pending, the withheld flow counted."""
    if pkg == "port":
        from crdt_tpu_torch.net import (Replica, UdpRouter, install_faults,
                                        pump, pump_until)
        flt, trc = faults, tracer
    else:
        from crdt_tpu.net import (Replica, UdpRouter, install_faults,
                                  pump, pump_until)
        flt, trc = ref_faults, ref_tracer
    t = trc.set_tracer(trc.Tracer(enabled=True))
    ra, rb = UdpRouter(), UdpRouter()
    rb.add_peer(*ra.addr)
    try:
        a = Replica(ra, topic="t", client_id=1, batch_incoming=True,
                    pending_max_records=2, resync_retry_s=0.01)
        b = Replica(rb, topic="t", client_id=2)
        pump([ra, rb])
        sched = flt.WithholdDeps(flows=[(rb.addr[1], ra.addr[1])],
                                 withhold=2)
        install_faults(rb, sched)
        for i in range(6):
            b.set("m", f"k{i}", i)
        pump_until([ra, rb], lambda: dict(a.c) == dict(b.c)
                   and len(dict(a.c).get("m", {})) == 6, timeout_s=30.0)
        counters = t.counters()
    finally:
        trc.set_tracer(trc.Tracer(enabled=False))
        ra.close()
        rb.close()
    assert sched.withheld == 2
    assert counters.get("engine.pending_evictions", 0) >= 2
    assert counters.get("guard.resync_probes", 0) > 0
    assert not a.doc.engine.pending
    assert a.encode_state_as_update() == b.encode_state_as_update()


# ---- MigrationCrashPlan: occurrence counting


def test_migration_crash_plan_counts_occurrences_as_the_reference():
    steps = ["prepare", "commit", "prepare", "ack", "commit", "prepare"]
    kill_at = {"prepare": 3, "commit": 2}

    def run(flt):
        plan = flt.MigrationCrashPlan(kill_at=kill_at)
        out = []
        for step in steps:
            try:
                plan.check(step)
                out.append(None)
            except flt.SimulatedCrash as e:
                out.append(str(e))
        return out, plan.seen, plan.fired

    got = run(faults)
    assert got == run(ref_faults)
    assert got[2] == ["commit", "prepare"]
    assert faults.MigrationCrashPlan().fired == []
