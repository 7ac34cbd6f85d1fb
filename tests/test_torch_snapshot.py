"""The port's device-layout snapshots against the reference's, on the CPU.

- ``encode_engine`` writes the reference's bytes for engines fed the
  same history, and a payload written by either package rehydrates in
  the other to an equal cache that stays equal under a tail;
- mutated payloads are rejected with ``ValueError`` only, exactly where
  the reference rejects them;
- ``SnapshotStore``: generations, a torn rename's leftover, the store
  budget and a failing filesystem, on ``tmp_path``, and a store the
  reference wrote, read by the port;
- ``cold_start``'s three rungs and ``compact_with_snapshot`` over a
  stub persistence;
- ``MultiDocServer.checkpoint``/``restore`` of a whole resident set
  (the reference's checkpoint restored by the port too), and a damaged
  snapshot that serves cold.
"""

import os
import random

import pytest

from crdt_tpu.models.incremental import IncrementalReplay as RefReplay
from crdt_tpu.models.multidoc import MultiDocServer as RefServer
from crdt_tpu.models.replay import cold_start as ref_cold_start
from crdt_tpu.storage import snapshot as ref_sn
from crdt_tpu_torch.models.incremental import IncrementalReplay
from crdt_tpu_torch.models.multidoc import MultiDocServer, cache_digest
from crdt_tpu_torch.models.replay import cold_start, replay_trace
from crdt_tpu_torch.obs import Tracer, set_tracer
from crdt_tpu_torch.storage import snapshot as sn
from tests.test_snapshot import Stream, _mutants


@pytest.fixture
def tracer():
    t = set_tracer(Tracer(enabled=True))
    yield t
    set_tracer(Tracer(enabled=False))


def _history(n_deltas=30, k=8, seed=1):
    s = Stream(seed)
    return [s.delta(k, deletes=(i % 7 == 6)) for i in range(n_deltas)], s


def _engines(blobs, device_min_rows=None):
    ref = RefReplay(device_min_rows=device_min_rows)
    port = IncrementalReplay(device_min_rows=device_min_rows, device="cpu")
    ref.apply(blobs)
    port.apply(blobs)
    assert not port._pending and not port._rootless
    return ref, port


class _Log:
    """A stub persistence: a doc's blob log with the reads ``cold_start``
    makes and the compaction calls ``compact_with_snapshot`` makes."""

    def __init__(self, blobs):
        self.blobs = list(blobs)
        self._next_seq = {}
        self.compacted = []

    def get_updates_since(self, doc, seq):
        return self.blobs[seq:]

    def get_all_updates(self, doc):
        return list(self.blobs)

    def _seq_for(self, doc):
        seq = self._next_seq.get(doc, len(self.blobs))
        self._next_seq[doc] = seq + 1
        return seq

    def compact(self, doc, blob, sv):
        self.compacted.append((doc, blob, sv))


# ---------------------------------------------------------------------------
# the format
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,n,k,dmin", [
    (1, 30, 8, None), (2, 12, 5, None), (3, 20, 6, 1), (4, 1, 1, None),
])
def test_encode_engine_bytes_equal_reference(seed, n, k, dmin):
    blobs, _ = _history(n, k, seed)
    ref, port = _engines(blobs, dmin)
    for seq in (0, 17):
        assert sn.encode_engine(port, seq=seq) == \
            ref_sn.encode_engine(ref, seq=seq)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_snapshots_load_in_the_other_package(writer):
    blobs, s = _history(24, 7, seed=5)
    ref, port = _engines(blobs)
    if writer == "reference":
        payload = ref_sn.encode_engine(ref, seq=9)
        eng = sn.rehydrate(sn.decode_payload(payload), device="cpu")
        assert eng.device.type == "cpu" and eng._from_snapshot
    else:
        payload = sn.encode_engine(port, seq=9)
        eng = ref_sn.rehydrate(ref_sn.decode_payload(payload))
    assert cache_digest(eng.cache) == cache_digest(ref.cache)
    assert eng.cache == ref.cache
    assert eng.encode_state_as_update() == ref.encode_state_as_update()
    tail = [s.delta(8, deletes=(i == 2)) for i in range(6)]
    eng.apply(tail)
    ref.apply(tail)
    assert eng.cache == ref.cache
    assert eng.encode_state_as_update() == ref.encode_state_as_update()


def test_refuses_unsettled_engine():
    from crdt_tpu_torch.codec import v1
    from crdt_tpu_torch.core.ids import DeleteSet
    from crdt_tpu_torch.core.records import ItemRecord

    eng = IncrementalReplay(device="cpu")
    eng.apply([v1.encode_update([ItemRecord(
        client=5, clock=9, parent_root="m", key="k", content=1)],
        DeleteSet())])
    with pytest.raises(ValueError, match="pending"):
        sn.encode_engine(eng)


@pytest.mark.parametrize("seed", [20260806, 7])
def test_mutants_reject_value_error_only_where_the_reference_does(seed):
    blobs, _ = _history(12)
    _, port = _engines(blobs)
    payload = sn.encode_engine(port, seq=1)
    rng = random.Random(seed)
    rejected = 0
    for m in _mutants(payload, rng, n=160):
        try:
            ref_sn.decode_payload(m)
            want = None
        except ValueError as e:
            want = str(e)
        try:
            snap = sn.decode_payload(m)
        except ValueError as e:
            assert str(e) == want
            rejected += 1
            continue
        except Exception as exc:  # noqa: BLE001 - the contract
            pytest.fail(f"non-ValueError escape: {exc!r}")
        assert want is None
        try:
            sn.rehydrate(snap, device="cpu").cache
        except ValueError:
            pass
    assert rejected > 60


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------


class _FailingFs(sn.Fs):
    """A filesystem whose rename fails (a disk error mid-write)."""

    def rename(self, src, dst):
        raise OSError(5, "injected EIO")


def test_store_generations_leftovers_and_budget(tmp_path, tracer):
    blobs, s = _history(10)
    _, port = _engines(blobs)
    store = sn.SnapshotStore(str(tmp_path / "a"))
    assert store.write("d/1", sn.encode_engine(port, seq=2), 2)
    port.apply([s.delta(5)])
    assert store.write("d/1", sn.encode_engine(port, seq=5), 5)
    names = sorted(os.listdir(store.root))
    assert names == ["d%%2f1-%020d.snap" % 5]  # the older generation died
    # a torn rename's leftover is ignored
    with open(os.path.join(store.root, "d%%2f1-%020d.snap.tmp" % 9),
              "wb") as f:
        f.write(b"half a snapshot")
    snap, seq = store.load_latest("d/1")
    assert seq == 5 and snap.n == port.cols.n
    # a damaged newest generation falls back to none (counted)
    path = os.path.join(store.root, names[0])
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    assert store.load_latest("d/1") is None
    assert any(k.startswith("snap.fallbacks")
               for k in tracer.counters())
    # the store budget refuses politely
    small = sn.SnapshotStore(str(tmp_path / "b"), max_bytes=100)
    assert not small.write("d", sn.encode_engine(port, seq=1), 1)
    assert small.load_latest("d") is None
    # a failing filesystem: refused, no temporary left behind
    bad = sn.SnapshotStore(str(tmp_path / "c"), fs=_FailingFs())
    assert not bad.write("d", sn.encode_engine(port, seq=1), 1)
    assert os.listdir(bad.root) == []
    assert not bad.put_blob("x", b"1")
    assert store.put_blob("m", b"manifest") and store.get_blob("m") == \
        b"manifest"
    assert store.get_blob("absent") is None


def test_a_reference_store_reads_in_the_port(tmp_path):
    blobs, _ = _history(16, seed=9)
    ref, port = _engines(blobs)
    ref_sn.SnapshotStore(str(tmp_path)).write("doc", ref_sn.encode_engine(
        ref, seq=16), 16)
    snap, seq = sn.SnapshotStore(str(tmp_path)).load_latest("doc")
    assert seq == 16
    assert sn.rehydrate(snap, device="cpu").cache == ref.cache


# ---------------------------------------------------------------------------
# cold_start and the compaction rider
# ---------------------------------------------------------------------------


def test_cold_start_rungs_match_reference(tmp_path):
    blobs, s = _history(20, 6, seed=3)
    _, port = _engines(blobs)
    log = _Log(blobs)
    store = sn.SnapshotStore(str(tmp_path / "snaps"))
    ref_store = ref_sn.SnapshotStore(str(tmp_path / "snaps"))
    assert store.write("d", sn.encode_engine(port, seq=len(blobs)),
                       len(blobs))
    log.blobs += [s.delta(6) for _ in range(4)]
    want = RefReplay()
    want.apply(log.blobs)

    # rung 1: the snapshot plus the log's tail
    eng, path = cold_start("d", log, store, device="cpu")
    ref_eng, ref_path = ref_cold_start("d", log, ref_store)
    assert (path, ref_path) == ("snapshot", "snapshot")
    assert eng.cache == ref_eng.cache == want.cache
    assert eng.encode_state_as_update() == want.encode_state_as_update()

    # rung 2: a foreign snapshot whose tail cannot settle -> the log
    fs = Stream(11)
    fs.clients = [70, 71]
    fs.clock = {c: 0 for c in fs.clients}
    _, foreign = _engines([fs.delta(6) for _ in range(20)])
    store.write("e", sn.encode_engine(foreign, seq=2), 2)
    eng, path = cold_start("e", log, store, device="cpu")
    _, ref_path = ref_cold_start("e", log, ref_store)
    assert path == ref_path == "wal"
    assert eng.cache == want.cache

    # rung 3: no snapshot at all
    eng, path = cold_start("f", log, None, device="cpu")
    assert path == "wal" and eng.cache == want.cache


def test_compact_with_snapshot_matches_reference(tmp_path):
    blobs, _ = _history(14, seed=6)
    ref, port = _engines(blobs)
    lp, ref_lp = _Log(blobs), _Log(blobs)
    store = sn.SnapshotStore(str(tmp_path / "a"))
    ref_store = ref_sn.SnapshotStore(str(tmp_path / "b"))
    assert sn.compact_with_snapshot(lp, "d", port, store)
    assert ref_sn.compact_with_snapshot(ref_lp, "d", ref, ref_store)
    assert lp.compacted == ref_lp.compacted
    assert lp._next_seq == ref_lp._next_seq
    assert sorted(os.listdir(store.root)) == \
        sorted(os.listdir(ref_store.root))
    for name in os.listdir(store.root):
        assert open(os.path.join(store.root, name), "rb").read() == \
            open(os.path.join(ref_store.root, name), "rb").read()


# ---------------------------------------------------------------------------
# the server's checkpoint and restore
# ---------------------------------------------------------------------------


def _warm(srv, streams, rounds=4):
    for _ in range(rounds):
        for d, s in streams.items():
            srv.submit_many(d, [s.delta(6) for _ in range(3)])
        srv.tick()


def _same_docs(a, b, docs):
    for d in docs:
        assert cache_digest(a._cache_of(a._docs[d])) == \
            cache_digest(b._cache_of(b._docs[d])), d


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoint_restore_whole_resident_set(tmp_path, writer):
    docs = [f"doc{i}" for i in range(4)]
    if writer == "port":
        store = sn.SnapshotStore(str(tmp_path))
        src = MultiDocServer(snap_store=store, device="cpu")
    else:
        store = ref_sn.SnapshotStore(str(tmp_path))
        src = RefServer(snap_store=store)
    streams = {d: Stream(i) for i, d in enumerate(docs)}
    _warm(src, streams)
    n = src.checkpoint()
    assert n == sum(st.resident is not None for st in src._docs.values())
    dst = MultiDocServer(snap_store=sn.SnapshotStore(str(tmp_path)),
                         device="cpu")
    assert dst.restore() == n
    _same_docs(src, dst, docs)
    for d, s in streams.items():
        blob = s.delta(6)
        src.submit(d, blob)
        dst.submit(d, blob)
    src.tick()
    dst.tick()
    _same_docs(src, dst, docs)


def test_restore_with_damaged_snapshot_serves_cold(tmp_path):
    store = sn.SnapshotStore(str(tmp_path))
    srv = MultiDocServer(snap_store=store, device="cpu")
    streams = {f"doc{i}": Stream(i) for i in range(2)}
    _warm(srv, streams)
    assert srv.checkpoint() >= 1
    for name in os.listdir(str(tmp_path)):
        if name.endswith(".snap"):
            p = os.path.join(str(tmp_path), name)
            b = bytearray(open(p, "rb").read())
            b[len(b) // 2] ^= 0xFF
            open(p, "wb").write(bytes(b))
    srv2 = MultiDocServer(snap_store=store, device="cpu")
    assert srv2.restore() == 0
    for d in srv._docs:
        assert cache_digest(replay_trace(srv2._docs[d].blobs,
                                         device="cpu").cache) == \
            cache_digest(srv._cache_of(srv._docs[d])), d
    for i, d in enumerate(srv._docs):
        s = Stream(i + 50)
        s.clients = [90, 91]
        s.clock = {c: 0 for c in s.clients}
        blob = s.delta(6)
        srv.submit(d, blob)
        srv2.submit(d, blob)
    srv.tick()
    srv2.tick()
    _same_docs(srv, srv2, srv._docs)
