"""The port's update log (``crdt_tpu_torch.storage``: ``KvLog`` over its
own build of ``native/kvlog/kvlog.cc``, and ``LogPersistence``) against
the reference's, on the CPU.

Each case of ``tests/test_storage.py`` runs once per package on its own
file under ``tmp_path``: the observables must be equal, a ``KvLog``
file must be byte-identical, and every file written by either package
must read back the same in the other. The port builds its library into
``crdt_tpu_torch/build/`` under its own name, never into
``native/build/``. A device-merge replica (``merge_mode="device"``,
``device="cpu"``) restarts from a native log written by the reference.
"""

import importlib.util
import json
import os
import types
from pathlib import Path

import pytest

import crdt_tpu.net as ref_net
import crdt_tpu.obs as ref_obs
import crdt_tpu.storage as ref_storage
import crdt_tpu_torch.net as port_net
import crdt_tpu_torch.obs as port_obs
import crdt_tpu_torch.storage as port_storage
from crdt_tpu.api.doc import Crdt as RefCrdt
from crdt_tpu.storage import kv as ref_kv
from crdt_tpu_torch.guard import faults
from crdt_tpu_torch.net import replica as port_replica
from crdt_tpu_torch.ops import _build
from crdt_tpu_torch.storage import kv as port_kv

REF = types.SimpleNamespace(name="ref", kv=ref_kv, st=ref_storage,
                            net=ref_net, obs=ref_obs, kw={})
PORT = types.SimpleNamespace(name="port", kv=port_kv, st=port_storage,
                             net=port_net, obs=port_obs,
                             kw={"device": "cpu"})
PKGS = (REF, PORT)


def _mk_update(client, n_ops=3):
    """A real v1 update: n_ops map sets from one client."""
    doc = RefCrdt(client)
    for i in range(n_ops):
        doc.map("m", batch=True)
        doc.set("m", f"k{i}", i, batch=True)
    return doc.exec_batch(propagate=False)


def _dump(pkg, path):
    with pkg.kv.KvLog(path) as kv:
        return list(kv.scan())


def run_both(tmp_path, scenario):
    """Run ``scenario(pkg, path)`` once per package; results equal,
    files byte-identical, and each file reads the same in both."""
    out, paths = {}, {}
    for pkg in PKGS:
        paths[pkg.name] = str(tmp_path / pkg.name / "store.kvlog")
        out[pkg.name] = scenario(pkg, paths[pkg.name])
    assert out["port"] == out["ref"]
    if os.path.exists(paths["ref"]):
        assert Path(paths["port"]).read_bytes() == \
            Path(paths["ref"]).read_bytes()
        for p in paths.values():
            assert _dump(PORT, p) == _dump(REF, p)
    return out["port"]


# ---------------------------------------------------------------------------
# KvLog
# ---------------------------------------------------------------------------


def put_get_delete_roundtrip(pkg, path):
    with pkg.kv.KvLog(path) as kv:
        kv.put(b"a", b"1")
        kv.put(b"b", b"\x00\xff" * 100)
        got = [kv.get(b"a"), kv.get(b"b"), kv.get(b"missing")]
        kv.delete(b"a")
        return got + [kv.get(b"a"), len(kv)]


def reopen_replays_log(pkg, path):
    with pkg.kv.KvLog(path) as kv:
        for i in range(100):
            kv.put(f"k{i:03d}".encode(), f"v{i}".encode())
        kv.put(b"k000", b"overwritten")
        kv.delete(b"k001")
    with pkg.kv.KvLog(path) as kv:
        return [len(kv), kv.get(b"k000"), kv.get(b"k001"), kv.get(b"k099")]


def ordered_scan_and_prefix(pkg, path):
    with pkg.kv.KvLog(path) as kv:
        for k, v in ((b"doc_a_update_002", b"u2"), (b"doc_a_update_000", b"u0"),
                     (b"doc_b_update_000", b"x"), (b"doc_a_update_001", b"u1"),
                     (b"doc_a_sv", b"sv")):
            kv.put(k, v)
        return [list(kv.scan_prefix(b"doc_a_update_")),
                list(kv.scan(b"doc_a_update_001", b"doc_b")),
                kv.keys(b"doc_a"), kv.keys()]


def scan_is_snapshot(pkg, path):
    with pkg.kv.KvLog(path) as kv:
        kv.put(b"a", b"1")
        kv.put(b"b", b"2")
        it = kv.scan()
        kv.put(b"c", b"3")  # must not appear in the open iterator
        return [k for k, _ in it]


def batch_is_atomic_across_crash(pkg, path):
    kv = pkg.kv.KvLog(path)
    kv.put(b"before", b"x")
    batch = pkg.kv.Batch()
    batch.put(b"doc_update_0", b"u" * 50).put(b"doc_sv", b"s" * 10)
    batch.put(b"doc_meta", b"m" * 10).delete(b"gone")
    ops = list(batch.ops())
    kv.write(batch)
    kv.close()
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size - 7)  # torn tail: the whole batch goes
    with pkg.kv.KvLog(path) as kv:
        got = [kv.get(k) for k in (b"before", b"doc_update_0", b"doc_sv",
                                   b"doc_meta")]
        kv.put(b"after", b"y")
    with pkg.kv.KvLog(path) as kv:
        return ops, got, kv.get(b"after")


def corrupt_tail_is_dropped(pkg, path):
    with pkg.kv.KvLog(path) as kv:
        kv.put(b"good", b"1")
        kv.put(b"bad", b"2")
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(size - 1)
        f.write(b"\x00")
    with pkg.kv.KvLog(path) as kv:
        return kv.get(b"good"), kv.get(b"bad")


def compact_drops_history(pkg, path):
    with pkg.kv.KvLog(path) as kv:
        for i in range(200):
            kv.put(b"hot", f"v{i}".encode())
        kv.put(b"cold", b"keep")
        before = (kv.log_size, kv.live_size)
        kv.compact()
        after = (kv.log_size, kv.live_size, kv.get(b"hot"), kv.get(b"cold"))
    with pkg.kv.KvLog(path) as kv:
        return before, after, kv.get(b"hot"), len(kv)


def inverted_scan_and_binary_keys(pkg, path):
    with pkg.kv.KvLog(path) as kv:
        for k in (b"a", b"b", b"c"):
            kv.put(k, k * 2)
        kv.put(b"\x00\x01\xfe", b"")
        got = [list(kv.scan(b"c", b"b")), list(kv.scan(b"b", b"b"))]
    with pkg.kv.KvLog(path) as kv:
        return got, kv.get(b"\x00\x01\xfe")


KV_CASES = [put_get_delete_roundtrip, reopen_replays_log,
            ordered_scan_and_prefix, scan_is_snapshot,
            batch_is_atomic_across_crash, corrupt_tail_is_dropped,
            compact_drops_history, inverted_scan_and_binary_keys]


@pytest.mark.parametrize("case", KV_CASES, ids=lambda c: c.__name__)
def test_kvlog_matches_reference(case, tmp_path):
    run_both(tmp_path, case)


def test_closed_store_raises_instead_of_segfaulting(tmp_path):
    kv = port_kv.KvLog(str(tmp_path / "s.kvlog"))
    kv.put(b"a", b"1")
    kv.close()
    for call in (lambda: kv.get(b"a"), lambda: kv.put(b"b", b"2"),
                 lambda: list(kv.scan())):
        with pytest.raises(RuntimeError):
            call()
    kv.close()  # double close is a no-op


def test_the_port_builds_its_own_library(tmp_path):
    port_storage.KvLog(str(tmp_path / "a.kvlog")).close()
    ref_storage.KvLog(str(tmp_path / "b.kvlog")).close()
    pkg_build = Path(port_kv.__file__).resolve().parents[1] / "build"
    port_so = _build.target(port_kv._RECIPE)
    assert port_so.parent == pkg_build / "kvlog"
    assert port_so.name.startswith("libkvlog_torch-")
    assert port_so.name != ref_kv._SO.name
    assert port_kv._SRC == ref_kv._SRC  # one shared source
    assert Path(port_kv._load()._name) == port_so
    assert Path(ref_kv._load()._name) == ref_kv._SO
    native_build = port_kv._SRC.parents[1] / "build"
    assert not any("torch" in p.name for p in native_build.glob("*"))


def test_missing_compiler_raises_at_use_not_import(monkeypatch, tmp_path):
    monkeypatch.setattr(port_kv, "_RECIPE",
                        port_kv._RECIPE._replace(out_dir=tmp_path / "b"))
    monkeypatch.delitem(_build._loaded, port_kv._RECIPE.name,
                        raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="native build failed"):
        port_storage.KvLog(str(tmp_path / "a.kvlog"))
    assert not list(tmp_path.rglob("*.tmp.*"))
    spec = importlib.util.find_spec(port_kv.__name__)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))


# ---------------------------------------------------------------------------
# LogPersistence
# ---------------------------------------------------------------------------


def _meta(p, doc):
    m = p.get_meta(doc)
    return None if m is None else {k: v for k, v in m.items()
                                   if k != "last_updated"}


def store_and_replay_updates(pkg, path):
    p = pkg.st.LogPersistence(path)
    u1, u2 = _mk_update(1), _mk_update(2)
    p.store_update("topic", u1, sv=b"\x01")
    p.store_update("topic", u2, sv=b"\x02")
    got = [p.get_all_updates("topic"), p.get_state_vector("topic"),
           _meta(p, "topic")]
    p.close()
    p = pkg.st.LogPersistence(path)  # sequence numbers continue
    p.store_update("topic", _mk_update(3))
    got += [p.get_all_updates("topic"), p.get_updates_since("topic", 1),
            p.closed]
    p.close()
    return got + [p.closed]


def store_updates_batched_window(pkg, path):
    tr = pkg.obs.set_tracer(pkg.obs.Tracer(enabled=True))
    try:
        p = pkg.st.LogPersistence(path)
        us = [_mk_update(c) for c in (1, 2, 3)]
        p.store_updates("topic", us, sv=b"\x09")
        got = [p.get_all_updates("topic"), _meta(p, "topic"),
               tr.counters("persist.")]
        p.store_update("topic", _mk_update(4))
        got.append(tr.counters("persist."))
        p.close()
        p = pkg.st.LogPersistence(path)
        p.store_updates("topic", (u for u in [_mk_update(5)]))
        p.store_updates("topic", [])
        with pytest.raises(ValueError):
            p.store_updates("topic", [_mk_update(6), b"\xff garbage"])
        got += [p.get_all_updates("topic"), tr.counters("persist.")]
        p.close()
        return got
    finally:
        pkg.obs.set_tracer(pkg.obs.Tracer(enabled=False))


def docs_isolated_and_names_escaped(pkg, path):
    p = pkg.st.LogPersistence(path)
    ua, ub, uc = _mk_update(1), _mk_update(2), _mk_update(3)
    p.store_update("a", ua)
    p.store_update("b", ub)
    p.store_update("a_update_0", uc)  # raw prefix of doc 'a's keyspace
    got = [p.get_all_updates(d) for d in ("a", "b", "a_update_0")]
    got += [_meta(p, d) for d in ("a", "b", "a_update_0", "none")]
    with pytest.raises(TypeError):
        p.store_update("t", "not bytes")
    with pytest.raises(ValueError):
        p.store_update("t", b"\xff\xff garbage \x00")
    got.append(p.get_all_updates("t"))
    p.close()
    return got


def compact_replaces_log(pkg, path):
    p = pkg.st.LogPersistence(path)
    for c in range(1, 6):
        p.store_update("t", _mk_update(c))
    snapshot = _mk_update(9, n_ops=1)
    p.compact("t", snapshot, sv=b"\x07")
    got = [p.get_all_updates("t"), p.get_state_vector("t"), _meta(p, "t")]
    p.store_update("t", _mk_update(10))
    got += [p.get_all_updates("t"), p.get_updates_since("t", 5)]
    p.close()
    return got


def crash_consistent_recovery(pkg, path):
    updates = [_mk_update(c) for c in range(1, 6)]
    p = pkg.st.LogPersistence(path)
    for u in updates:
        p.store_update("doc", u, sv=b"sv-%d" % len(u))
    p.close()
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size - 11)
    p = pkg.st.LogPersistence(path)
    got = [p.get_all_updates("doc"), _meta(p, "doc")]
    p.store_update("doc", _mk_update(9), sv=b"sv-after")
    p.close()
    p = pkg.st.LogPersistence(path)
    got += [p.get_all_updates("doc"), p.get_state_vector("doc")]
    p.close()
    return got


def degraded_window_recovers(pkg, path):
    """The failure policy over the port's fault wrapper: retries, the
    bounded overflow buffer, and the drain on the next good write."""
    tr = pkg.obs.set_tracer(pkg.obs.Tracer(enabled=True))
    try:
        sched = faults.DiskFaultSchedule(fail_writes={1, 2, 3, 4})
        p = pkg.st.LogPersistence(
            path, retry_backoff_s=0.0, overflow_max_bytes=400,
            kv_wrapper=lambda kv: faults.FaultyKv(kv, sched))
        us = [_mk_update(c, n_ops=4) for c in range(1, 6)]
        p.store_update("d", us[0], sv=b"s0")
        p.store_update("d", us[1], sv=b"s1")   # 3 failures: degrades
        p.store_update("d", us[2], sv=b"s2")   # 1 failure, then drains
        got = [p.get_all_updates("d"), p.get_state_vector("d"),
               p.flush_degraded(), tr.counters("persist.")]
        p.close()
        return got
    finally:
        pkg.obs.set_tracer(pkg.obs.Tracer(enabled=False))


PERSIST_CASES = [store_and_replay_updates, store_updates_batched_window,
                 docs_isolated_and_names_escaped, compact_replaces_log,
                 crash_consistent_recovery, degraded_window_recovers]


@pytest.mark.parametrize("case", PERSIST_CASES, ids=lambda c: c.__name__)
def test_log_persistence_matches_reference(case, tmp_path):
    out, paths = {}, {}
    for pkg in PKGS:
        paths[pkg.name] = str(tmp_path / pkg.name / "store.kvlog")
        out[pkg.name] = case(pkg, paths[pkg.name])
    assert out["port"] == out["ref"]
    # each package's log reads the same in the other, meta included
    for path in paths.values():
        got, want = (pkg.st.LogPersistence(path) for pkg in (PORT, REF))
        for doc in ("topic", "t", "doc", "d", "a"):
            assert got.get_all_updates(doc) == want.get_all_updates(doc)
            assert got.get_meta(doc) == want.get_meta(doc)
            assert got.get_state_vector(doc) == want.get_state_vector(doc)
        got.close()
        want.close()


def test_disk_faults_match_reference(tmp_path):
    from crdt_tpu.guard import faults as ref_faults

    for seed in range(4):
        scheds = [mod.DiskFaultSchedule(seed, enospc=0.2, eio=0.2,
                                        torn=0.2, heal_after=3)
                  for mod in (ref_faults, faults)]
        assert [scheds[1].decide(n) for n in range(40)] == \
            [scheds[0].decide(n) for n in range(40)]
    crash = faults.DiskFaultSchedule(crash_at=(1, 2))
    kv = faults.FaultyKv(port_kv.KvLog(str(tmp_path / "c.kvlog")), crash)
    b = port_kv.Batch().put(b"x", b"1").put(b"y", b"2").put(b"z", b"3")
    kv.write(b)
    with pytest.raises(faults.SimulatedCrash):
        kv.write(port_kv.Batch().put(b"p", b"1").put(b"q", b"2")
                 .put(b"r", b"3"))
    assert kv.dead and kv.batches == [3, 3] and kv.stats["crashed"] == 1
    assert kv.get(b"q") == b"2" and kv.get(b"r") is None
    kv.close()


class _NullFs:
    """The inner fs of a :class:`faults.FaultyFs` whose ops never land."""

    def write(self, path, data):
        pass


@pytest.mark.parametrize("seam", ["kv", "fs"])
def test_fault_event_recorded_with_recorder_on(seam, tmp_path):
    """One scheduled write failure under an enabled flight recorder:
    the port records one ``fault.disk`` / ``fault.fs`` event with the
    fault under ``fault``; the reference passes it as ``kind=``, which
    collides with ``record``'s own first parameter and raises
    ``TypeError`` (ROADMAP §C)."""
    from crdt_tpu.guard import faults as ref_faults
    from crdt_tpu.obs import recorder as ref_recorder
    from crdt_tpu_torch.obs import recorder as port_recorder

    def inject(mod, path):
        sched = mod.DiskFaultSchedule(fail_writes={0})
        if seam == "kv":
            wrapped = mod.FaultyKv(port_kv.KvLog(path), sched)
            try:
                wrapped.write(port_kv.Batch().put(b"k", b"v"))
            finally:
                wrapped.close()
        else:
            mod.FaultyFs(_NullFs(), sched).write(path, b"data")

    saved = port_recorder.get_recorder(), ref_recorder.get_recorder()
    port_recorder.set_recorder(port_recorder.FlightRecorder(enabled=True))
    ref_recorder.set_recorder(ref_recorder.FlightRecorder(enabled=True))
    try:
        with pytest.raises(OSError):
            inject(faults, str(tmp_path / "port.kvlog"))
        with pytest.raises(TypeError, match="multiple values"):
            inject(ref_faults, str(tmp_path / "ref.kvlog"))
        events = port_recorder.get_recorder().events()
    finally:
        port_recorder.set_recorder(saved[0])
        ref_recorder.set_recorder(saved[1])
    want = "fault.disk" if seam == "kv" else "fault.fs"
    assert [(e["kind"], e["fault"]) for e in events] == [(want, "eio")]


def test_prefers_batch_verb_for_log_persistence():
    assert port_replica._prefers_batch_verb(port_storage.LogPersistence)


# ---------------------------------------------------------------------------
# replicas on a native log
# ---------------------------------------------------------------------------


def _replica(pkg, net, pk, mode, path, **options):
    kw = dict(pkg.kw) if mode in ("device", "resident") else {}
    kw.update(options)
    return pkg.net.ypear_crdt(pkg.net.LoopbackRouter(net, pk),
                              topic=kw.pop("topic", "room"), merge_mode=mode,
                              persistence=pkg.st.LogPersistence(path), **kw)


def restart_from_native_log(pkg, path, mode):
    net = pkg.net.LoopbackNetwork()
    r1 = _replica(pkg, net, "pk1", mode, path, client_id=1)
    r1.map("users")
    r1.set("users", "alice", {"age": 30})
    r1.push("feed", ["hello", "world"])
    for i in range(12):
        r1.set("m", f"k{i}", i)
    net.run()
    expect = dict(r1.c)
    r1.self_close()
    net.run()
    r2 = _replica(pkg, pkg.net.LoopbackNetwork(), "pk1", mode, path,
                  client_id=1)
    assert dict(r2.c) == expect
    return [dict(r2.c), r2.encode_state_as_update(),
            r2.encode_state_vector()]


@pytest.mark.parametrize("mode", ["scalar", "device"])
def test_replica_restart_replays_native_log(mode, tmp_path):
    out = {pkg.name: restart_from_native_log(
        pkg, str(tmp_path / pkg.name / "s.kvlog"), mode) for pkg in PKGS}
    assert out["port"] == out["ref"]


def test_device_replica_restarts_from_a_reference_log(tmp_path):
    # the reference writes the log; the port's device-merge replica
    # restarts from it in one apply_updates batch (one rebuild)
    path = str(tmp_path / "shared.kvlog")
    want = restart_from_native_log(REF, path, "scalar")
    calls = []
    from crdt_tpu_torch.core import device_apply

    orig = device_apply.rebuild_chains

    def spy(engine, *, device):
        calls.append(engine.store.n)
        return orig(engine, device=device)

    device_apply.rebuild_chains = spy
    try:
        r = _replica(PORT, port_net.LoopbackNetwork(), "pk9", "device",
                     path, client_id=9)
    finally:
        device_apply.rebuild_chains = orig
    assert dict(r.c) == want[0]
    assert len(calls) == 1 and calls[0] > 0
    assert r.doc.device_merge and r.batch_incoming


def test_replica_auto_compaction_threshold(tmp_path):
    out = {}
    for pkg in PKGS:
        path = str(tmp_path / pkg.name / "s.kvlog")
        net = pkg.net.LoopbackNetwork()
        r = _replica(pkg, net, "pk1", "device", path, client_id=1,
                     compact_every=5)
        for i in range(12):
            r.set("m", f"k{i}", i)
        net.run()
        count = r.persistence.get_meta("room")["count"]
        r.self_close()
        r2 = _replica(pkg, pkg.net.LoopbackNetwork(), "pk2", "device", path,
                      client_id=2)
        out[pkg.name] = (count, dict(r2.c))
    assert out["port"] == out["ref"]
    assert out["port"][0] < 12
    assert out["port"][1]["m"] == {f"k{i}": i for i in range(12)}


def test_replica_batched_inbox_persists_one_window(tmp_path):
    out = {}
    for pkg in PKGS:
        tr = pkg.obs.set_tracer(pkg.obs.Tracer(enabled=True))
        try:
            net = pkg.net.LoopbackNetwork()
            a = pkg.net.ypear_crdt(pkg.net.LoopbackRouter(net, "pkA"),
                                   topic="t", client_id=1)
            b = _replica(pkg, net, "pkB", "device",
                         str(tmp_path / pkg.name / "s.kvlog"), client_id=2,
                         topic="t")
            net.run()
            for i in range(5):
                a.set("m", f"k{i}", i)
            net.run()
            b.flush_incoming()
            out[pkg.name] = (tr.counters("persist."), dict(b.c) == dict(a.c))
        finally:
            pkg.obs.set_tracer(pkg.obs.Tracer(enabled=False))
    assert out["port"] == out["ref"]


def test_replica_restart_after_torn_tail_resyncs(tmp_path):
    path = str(tmp_path / "s.kvlog")
    net = port_net.LoopbackNetwork()
    r1 = _replica(PORT, net, "pk1", "device", path, client_id=1)
    survivor = port_net.ypear_crdt(port_net.LoopbackRouter(net, "pk2"),
                                   topic="room", client_id=2)
    for i in range(6):
        r1.set("m", f"k{i}", i)
    net.run()
    r1.self_close()
    size = os.path.getsize(path)
    while True:  # tear until exactly one update record is gone
        size -= 7
        with open(path, "r+b") as f:
            f.truncate(size)
        probe = port_storage.LogPersistence(path)
        n = len(probe.get_all_updates("room"))
        probe.close()
        if n <= 5:
            break
    assert n == 5
    restarted = _replica(PORT, net, "pk3", "device", path, client_id=3)
    assert len(restarted.c.get("m", {})) < 6
    net.run()
    assert restarted.c["m"] == survivor.c["m"] == {f"k{i}": i
                                                    for i in range(6)}


def test_meta_is_json(tmp_path):
    path = str(tmp_path / "s.kvlog")
    p = port_storage.LogPersistence(path)
    p.store_update("t", _mk_update(1))
    p.close()
    with ref_storage.KvLog(path) as raw:
        meta = json.loads(raw.get(b"doc_t_meta"))
    assert set(meta) == {"last_updated", "size", "count"}
