"""The port's device merge (``Crdt(device_merge=True)``, through
``crdt_tpu_torch.core.device_apply``) against the reference's, on the
CPU.

Every case of the reference's ``TestDifferentialModes`` and
``TestDeviceModePlumbing`` runs on four documents per peer at once: the
reference's scalar and device-merge ``Crdt`` and the port's, the port's
device merge with ``device="cpu"``. After every batch a peer applies,
its four documents must agree on the cache, the engine's JSON, chain
tables, delete set, state vector, pending stash and full-state encode,
byte for byte. Beside them: the guard ladder's split and host rungs
under an injected fault (against the reference's ladder), a kernel
error that must propagate, ``merge_records``/``records_to_columns``/
``Interner`` on the ``merge_records`` cases of ``tests/test_kernels.py``,
``fetch_packed_i32``, and ``_rank_conflict_groups`` on the fuzz seeds of
``tests/test_yata_kernel.py``.
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

from crdt_tpu.api.doc import Crdt as RefCrdt
from crdt_tpu.codec import v1 as ref_v1
from crdt_tpu.core import device_apply as ref_da
from crdt_tpu.core.engine import Engine as RefEngine
from crdt_tpu.core.ids import DeleteSet as RefDeleteSet
from crdt_tpu.core.records import ItemRecord as RefRecord
from crdt_tpu.core.store import TYPE_MAP
from crdt_tpu.obs import tracer as ref_tracer
from crdt_tpu.ops import device as ref_device
from crdt_tpu.ops import merge as ref_merge
from crdt_tpu_torch.api.doc import Crdt
from crdt_tpu_torch.core import device_apply
from crdt_tpu_torch.core.ids import DeleteSet
from crdt_tpu_torch.core.records import ItemRecord
from crdt_tpu_torch.obs import tracer
from crdt_tpu_torch.ops import device, merge
from crdt_tpu_torch.ops._build import KernelError
from tests.test_engine import _random_op
from tests.test_yata_kernel import _seq_fuzz_op

VARIANTS = ("ref scalar", "ref device", "port scalar", "port device")


def _doc(variant, cid, outbox, **kw):
    pkg, mode = variant.split()
    if mode == "device":
        kw["device_merge"] = True
        if pkg == "port":
            kw["device"] = "cpu"
    cls = RefCrdt if pkg == "ref" else Crdt
    return cls(cid, on_update=lambda u, m: outbox.append(u), **kw)


def state_of(doc) -> dict:
    """Everything two documents are compared on, as plain values."""
    e = doc.engine
    return {
        "c": dict(doc.c),
        "json": e.to_json(),
        "ds": list(e.delete_set().iter_all()),
        "sv": doc.encode_state_vector(),
        "winners": e.map_winner_table(),
        "orders": e.seq_order_table(),
        "pending": sorted((r.client, r.clock) for r in e.pending),
        "pending_ds": list(e.pending_deletes.iter_all()),
        "full": doc.encode_state_as_update(),
    }


def assert_same(docs: dict) -> None:
    want = state_of(docs["ref scalar"])
    for v, d in docs.items():
        got = state_of(d)
        for key in want:
            assert got[key] == want[key], (v, key)


class Peer:
    """One peer as four documents: the reference's and the port's, in
    scalar and device-merge mode, each with its own outbox."""

    def __init__(self, cid, **kw):
        self.outbox = {v: [] for v in VARIANTS}
        self.docs = {v: _doc(v, cid, self.outbox[v], **kw)
                     for v in VARIANTS}

    @property
    def c(self):
        return self.docs["port device"].c

    def do(self, op, *a, **kw):
        out = {v: getattr(d, op)(*a, **kw) for v, d in self.docs.items()}
        assert_same(self.docs)
        return out["port device"]

    def take(self) -> list:
        """The outboxes, update by update across the four variants."""
        outs = [self.outbox[v][:] for v in VARIANTS]
        for o in self.outbox.values():
            o.clear()
        assert len({len(o) for o in outs}) == 1
        for ups in zip(*outs):
            assert len(set(ups)) == 1  # the same bytes from every engine
        return list(zip(*outs))

    def apply(self, ups) -> None:
        """One update (or a batch) per variant, then the states agree."""
        for v, u in zip(VARIANTS, ups):
            if isinstance(u, list):
                self.docs[v].apply_updates(u)
            else:
                self.docs[v].apply_update(u)
        assert_same(self.docs)


def _drain(peers):
    progress = True
    while progress:
        progress = False
        for p in peers:
            for ups in p.take():
                for other in peers:
                    if other is not p:
                        other.apply(ups)
                        progress = True


def _run_script(script, ids=(1, 2, 3)):
    peers = [Peer(cid) for cid in ids]
    script(peers)
    _drain(peers)
    first = dict(peers[0].c)
    for p in peers[1:]:
        assert dict(p.c) == first
    return peers


# ---------------------------------------------------------------------------
# the reference's TestDifferentialModes
# ---------------------------------------------------------------------------


def concurrent_map_sets(peers):
    for i, p in enumerate(peers):
        for k in range(20):
            p.do("set", "m", f"k{k % 7}", f"v{i}.{k}")


def map_set_delete_interleaved(peers):
    a, b, c = peers
    for k in range(10):
        a.do("set", "m", f"k{k}", k)
    _drain(peers)
    b.do("delete", "m", "k3")
    c.do("set", "m", "k3", "resurrect")
    a.do("delete", "m", "k5")


def concurrent_seq_ops(peers):
    a, b, c = peers
    a.do("push", "l", ["a1", "a2"])
    b.do("push", "l", ["b1"])
    _drain(peers)
    a.do("insert", "l", 1, "mid")
    b.do("unshift", "l", "front")
    c.do("cut", "l", 0, 1)


def nested_array_in_map(peers):
    a, b, c = peers
    a.do("set", "cfg", "tags", None, array_method="push")
    _drain(peers)
    b.do("set", "cfg", "tags", ["x", "y"], array_method="push")
    c.do("set", "cfg", "tags", "z", array_method="unshift")
    a.do("set", "cfg", "mode", "dark")


def batch_then_remote(peers):
    a, b, _ = peers
    a.do("set", "m", "k1", 1, batch=True)
    a.do("push", "l", ["x"], batch=True)
    a.do("set", "m", "k2", 2, batch=True)
    a.do("exec_batch")
    b.do("set", "m", "k1", "b-wins-or-loses")


def fuzz_random_ops(peers):
    rng = np.random.default_rng(7)
    for step in range(60):
        p = peers[rng.integers(len(peers))]
        op = rng.integers(5)
        if op == 0:
            p.do("set", "m", f"k{rng.integers(6)}", int(step))
        elif op == 1:
            p.do("delete", "m", f"k{rng.integers(6)}")
        elif op == 2:
            p.do("push", "l", int(step))
        elif op == 3:
            if len(p.c.get("l", [])) > 1:
                p.do("cut", "l", int(rng.integers(len(p.c["l"]))))
        elif rng.integers(2):
            _drain(peers)


SCRIPTS = [concurrent_map_sets, map_set_delete_interleaved,
           concurrent_seq_ops, nested_array_in_map, batch_then_remote,
           fuzz_random_ops]


@pytest.mark.parametrize("script", SCRIPTS, ids=lambda s: s.__name__)
def test_differential_modes(script):
    _run_script(script)


# ---------------------------------------------------------------------------
# the reference's TestDeviceModePlumbing
# ---------------------------------------------------------------------------


def test_env_flag_does_not_touch_standalone_crdt(monkeypatch):
    monkeypatch.setenv("CRDT_TPU_DEVICE", "1")
    assert not Crdt(1).device_merge and not RefCrdt(1).device_merge
    assert Crdt(1, device_merge=True, device="cpu").device_merge
    assert Crdt(1).device is None  # the host engine takes no device
    monkeypatch.delenv("CRDT_TPU_DEVICE")
    assert not Crdt(1).device_merge


def test_apply_updates_batches_one_txn():
    src = Peer(1)
    for i in range(5):
        src.do("set", "m", f"k{i}", i)
    ups = src.take()
    events = {"ref": [], "port": []}
    dst = {"ref": RefCrdt(2, observer_function=events["ref"].append,
                          device_merge=True),
           "port": Crdt(2, observer_function=events["port"].append,
                        device_merge=True, device="cpu")}
    for name, d in dst.items():
        d.apply_updates([u[0] for u in ups])
    assert state_of(dst["port"]) == state_of(dst["ref"])
    assert dict(dst["port"].c)["m"] == dict(src.c)["m"]
    assert len(events["port"]) == len(events["ref"]) == 1


def test_pending_stash_device_mode():
    src = Peer(1)
    src.do("set", "m", "a", 1)
    src.do("set", "m", "b", 2)
    u1, u2 = src.take()
    dst = Peer(2)
    dst.apply(u2)  # clock gap: every variant stashes
    assert dst.docs["port device"].engine.pending
    dst.apply(u1)
    assert not dst.docs["port device"].engine.pending
    assert dict(dst.c)["m"] == {"a": 1, "b": 2}


def test_local_ops_after_device_rebuild():
    a, b = Peer(1), Peer(2)
    a.do("push", "l", ["x", "y"])
    a.do("set", "m", "k", "v1")
    for ups in a.take():
        b.apply(ups)
    b.do("insert", "l", 1, "mid")
    b.do("set", "m", "k", "v2")
    b.do("cut", "l", 0)
    for ups in b.take():
        a.apply(ups)
    assert a.c["l"] == ["mid", "y"] and a.c["m"] == {"k": "v2"}


def test_large_random_client_ids():
    def script(peers):
        a, b, c = peers
        a.do("set", "m", "k", "a")
        b.do("set", "m", "k", "b")
        c.do("set", "m", "k", "c")
        a.do("push", "l", ["x"])
        b.do("push", "l", ["y"])

    _run_script(script, ids=(2**31 - 7, 2**30 + 12345, 3))


def _crafted(recs) -> Peer:
    """A fresh peer (client 999) that applied one crafted blob."""
    blob = ref_v1.encode_update(recs, None)
    p = Peer(999)
    p.apply([blob] * len(VARIANTS))
    return p


def test_duplicate_siblings_rebuild_on_device(monkeypatch):
    import crdt_tpu.ops.yata as ref_yata
    import crdt_tpu_torch.ops.yata as yata

    recs = [
        RefRecord(client=1, clock=0, parent_root="s", content="b0"),
        RefRecord(client=1, clock=1, parent_root="s", origin=(1, 0),
                  content="b1"),
    ]
    for k in range(3):
        recs.append(RefRecord(client=2, clock=k, parent_root="s",
                              origin=(1, 0), content=f"dup{k}"))
    blob = ref_v1.encode_update(recs, None)
    scalar = {v: _doc(v, 999, []) for v in VARIANTS if "scalar" in v}
    for d in scalar.values():
        d.apply_update(blob)

    def boom(*a, **k):
        raise AssertionError("host scan ran in rebuild_chains")

    monkeypatch.setattr(ref_yata, "_simulate_group", boom)
    monkeypatch.setattr(yata, "_simulate_group", boom)
    dev = {v: _doc(v, 999, []) for v in VARIANTS if "device" in v}
    for d in dev.values():
        d.apply_update(blob)
    assert_same({**scalar, **dev})
    assert dev["port device"].c["s"] == ["b0", "b1", "dup2", "dup1", "dup0"]


HOSTILE = {
    "rights_into_subtree": (
        [RefRecord(client=1, clock=0, parent_root="s", content="a"),
         RefRecord(client=1, clock=1, parent_root="s", origin=(1, 0),
                   content="b"),
         RefRecord(client=1, clock=2, parent_root="s", origin=(1, 1),
                   content="c"),
         RefRecord(client=4, clock=0, parent_root="s", origin=(1, 0),
                   right=(1, 2), content="H")],
        ("s", ["a", "b", "H", "c"])),
    "interleaved_clocks": (
        [RefRecord(client=1, clock=0, parent_root="s", content="a"),
         RefRecord(client=1, clock=1, parent_root="m", key="k",
                   content="map-gap"),
         RefRecord(client=1, clock=2, parent_root="s", origin=(1, 0),
                   content="b"),
         RefRecord(client=1, clock=3, parent_root="s", origin=(1, 2),
                   content="c"),
         RefRecord(client=4, clock=0, parent_root="s", origin=(1, 0),
                   right=(1, 3), content="H")],
        ("s", ["a", "b", "H", "c"])),
    "deep_in_subtree": (
        [RefRecord(client=1, clock=0, parent_root="s", content="root"),
         RefRecord(client=2, clock=0, parent_root="s", origin=(1, 0),
                   content="a1")]
        + [RefRecord(client=2, clock=k, parent_root="s",
                     origin=(2, k - 1), content=f"d{k}")
           for k in range(1, 9)]
        + [RefRecord(client=5, clock=0, parent_root="s", origin=(1, 0),
                     right=(2, 8), content="H")],
        None),
    "cross_parent_right": (
        [RefRecord(client=1, clock=0, parent_root="other", content="x"),
         RefRecord(client=1, clock=1, parent_root="s", content="a"),
         RefRecord(client=3, clock=0, parent_root="s", origin=(1, 1),
                   right=(1, 0), content="weird")],
        None),
    "rights_on_map_rows": (
        [RefRecord(client=1, clock=0, parent_root="m", key="k",
                   content="A"),
         RefRecord(client=2, clock=0, parent_root="m", key="k",
                   right=(1, 0), content="B"),
         RefRecord(client=1, clock=1, parent_root="m", key="other",
                   content="clean")],
        None),
}


@pytest.mark.parametrize("name", list(HOSTILE))
def test_hostile_rights_stay_identical_across_modes(name):
    recs, want = HOSTILE[name]
    p = _crafted(recs)
    if want is not None:
        assert p.c[want[0]] == want[1]
    if name == "cross_parent_right":
        assert "weird" in p.c["s"]
    if name == "rights_on_map_rows":
        assert p.c["m"]["k"] == "A"


def test_second_apply_touches_only_new_parents(monkeypatch):
    # the rebuild interns O(new rows) parent specs, not the document
    from crdt_tpu_torch.core.engine import Engine

    src_out = []
    src = Crdt(1, on_update=lambda u, m: src_out.append(u))
    for i in range(300):
        src.set("big", f"k{i}", i)
    src.push("list", ["a", "b", "c"])
    dst = Crdt(2, device_merge=True, device="cpu")
    dst.apply_updates(src_out)
    src_out.clear()
    calls = []
    orig = Engine._parent_spec_of_row

    def counting(self, row):
        calls.append(row)
        return orig(self, row)

    monkeypatch.setattr(Engine, "_parent_spec_of_row", counting)
    src.set("small", "x", 1)
    dst.apply_update(src_out[-1])
    assert len(calls) <= 4
    assert dst.c["small"] == {"x": 1} and dict(dst.c) == dict(src.c)


# ---------------------------------------------------------------------------
# the guard ladder, a kernel error
# ---------------------------------------------------------------------------


def _fail_first(n):
    fired = []

    def hook(stage, attempt):
        if len(fired) < n:
            fired.append((stage, attempt))
            raise RuntimeError(f"injected at {stage!r} attempt {attempt}")

    return hook, fired


def _ladder_run(pkg_device, trc, crdt_cls, blobs, n_faults, **kw):
    hook, fired = _fail_first(n_faults)
    t = trc.set_tracer(trc.Tracer(enabled=True))
    old = pkg_device.set_device_fault_hook(hook)
    try:
        doc = crdt_cls(7, device_merge=True, **kw)
        doc.apply_updates(blobs)
    finally:
        pkg_device.set_device_fault_hook(old)
        trc.set_tracer(trc.Tracer(enabled=False))
    return doc, fired, t.counters("device.")


def _ladder_blobs():
    """Several parents (maps and lists), so the rebuild can split."""
    out = []
    src = Crdt(3, on_update=lambda u, m: out.append(u))
    for i in range(6):
        src.set(f"m{i % 3}", f"k{i}", i)
        src.push(f"l{i % 2}", [f"v{i}"])
    src.insert("l0", 1, "mid")
    src.delete("m0", "k0")
    return out


@pytest.mark.parametrize("n_faults,rung", [(1, "retry"), (2, "split"),
                                           (6, "split, half to host"),
                                           (100, "host")])
def test_ladder_rungs_match_reference(n_faults, rung):
    blobs = _ladder_blobs()
    got, got_fired, got_counts = _ladder_run(device, tracer, Crdt, blobs,
                                             n_faults, device="cpu")
    want, want_fired, want_counts = _ladder_run(ref_device, ref_tracer,
                                                RefCrdt, blobs, n_faults)
    assert got_fired == want_fired
    assert got_counts == want_counts
    assert state_of(got) == state_of(want)
    scalar = Crdt(7)
    scalar.apply_updates(blobs)
    assert state_of(got) == state_of(scalar)
    if rung != "retry":
        assert got_counts.get("device.fallback", 0) >= 1


def test_kernel_error_propagates(monkeypatch):
    def broken(*a, **kw):
        raise KernelError("ds_mask launch failed on purpose")

    monkeypatch.setattr(merge, "converge_maps", broken)
    t = tracer.set_tracer(tracer.Tracer(enabled=True))
    try:
        doc = Crdt(7, device_merge=True, device="cpu")
        with pytest.raises(KernelError, match="on purpose"):
            doc.apply_updates(_ladder_blobs())
    finally:
        tracer.set_tracer(tracer.Tracer(enabled=False))
    assert not t.counters("device.")  # the ladder never ran


def test_no_card_raises_at_construction(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Crdt(1, device_merge=True)
    eng = Crdt(1).engine
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_apply.rebuild_chains(eng)


# ---------------------------------------------------------------------------
# merge_records, records_to_columns, Interner
# ---------------------------------------------------------------------------


def _port_rec(r: RefRecord) -> ItemRecord:
    return ItemRecord(**{f.name: getattr(r, f.name)
                         for f in dataclasses.fields(RefRecord)})


def _port_ds(ds: RefDeleteSet) -> DeleteSet:
    out = DeleteSet()
    for c, k, n in ds.iter_all():
        out.add(c, k, n)
    return out


def check_merge(recs, ds=None):
    """The port's merge_records against the reference's, on the same
    records: same winners (by id), same visibility."""
    want = ref_merge.merge_records(recs, ds)
    got = merge.merge_records([_port_rec(r) for r in recs],
                              None if ds is None else _port_ds(ds),
                              device="cpu")
    assert {k: (v[0].id, v[1]) for k, v in got.items()} == \
        {k: (v[0].id, v[1]) for k, v in want.items()}
    return got


def union_of(engines):
    recs, ds = [], RefDeleteSet()
    for e in engines:
        recs.extend(e.records_since(None))
        ds = ds.merge(e.delete_set())
    return recs, ds


def _single_replica():
    e = RefEngine(1)
    e.map_set("m", "a", 1)
    e.map_set("m", "b", 2)
    e.map_set("m", "a", 3)
    e.map_delete("m", "b")
    return [e]


def _two_replicas():
    a, b = RefEngine(1), RefEngine(2)
    a.map_set("m", "k", "a1")
    b.map_set("m", "k", "b1")
    b.map_set("m", "j", "b2")
    return [a, b]


def _causal_chains():
    a, b = RefEngine(1), RefEngine(2)
    a.map_set("m", "k", "v1")
    b.apply_records(a.records_since(None), a.delete_set())
    b.map_set("m", "k", "v2")
    a.map_set("m", "k", "v3")
    return [a, b]


def _delete_visibility():
    a, b = RefEngine(1), RefEngine(2)
    a.map_set("m", "k", "v")
    b.apply_records(a.records_since(None), a.delete_set())
    b.map_delete("m", "k")
    return [a, b]


def _nested_map_parents():
    a = RefEngine(1)
    a.map_set_type("m", "sub", TYPE_MAP)
    a.map_set("", "inner", 42, parent=a.map_entry_spec("m", "sub"))
    return [a]


def _wide_client_ids():
    a, b = RefEngine(5), RefEngine((1 << 22) + 1)
    a.map_set("m", "k", "small")
    b.map_set("m", "k", "big")
    return [a, b]


ENGINE_CASES = {
    "single_replica": _single_replica,
    "two_replicas": _two_replicas,
    "causal_chains": _causal_chains,
    "delete_visibility": _delete_visibility,
    "nested_map_parents": _nested_map_parents,
    "wide_client_ids": _wide_client_ids,
}


@pytest.mark.parametrize("name", list(ENGINE_CASES))
def test_merge_records_matches_reference(name):
    recs, ds = union_of(ENGINE_CASES[name]())
    got = check_merge(recs, ds)
    if name == "delete_visibility":
        assert not got[(("root", "m"), "k")][1]


def test_merge_records_fuzz():
    rng = random.Random(321)
    for _ in range(10):
        engines = [RefEngine(i + 1) for i in range(rng.choice([2, 3, 6]))]
        for _ in range(150):
            e = rng.choice(engines)
            op = rng.randrange(4)
            if op == 0:
                e.map_set("m", rng.choice("abcdef"), rng.randrange(1000))
            elif op == 1:
                e.map_delete("m", rng.choice("abcdef"))
            elif op == 2:
                e.map_set(rng.choice("xyz"), rng.choice("ab"),
                          rng.randrange(10))
            else:
                src = rng.choice(engines)
                if src is not e:
                    e.apply_records(src.records_since(None),
                                    src.delete_set())
        check_merge(*union_of(engines))


def test_merge_records_duplicates_and_raw_chains():
    recs, ds = union_of(_two_replicas())
    check_merge(recs + recs + recs, ds)  # idempotent on a triplicate
    raw = [
        RefRecord(client=5, clock=0, parent_root="m", key="k", content="a"),
        RefRecord(client=5, clock=1, parent_root="m", key="k", content="b"),
        RefRecord(client=3, clock=0, parent_root="m", key="k", content="c"),
        RefRecord(client=5, clock=2, parent_root="m", key="k", content="d"),
    ]
    got = check_merge(raw)
    assert got[(("root", "m"), "k")][0].id == (5, 0)
    rng = random.Random(99)
    for _ in range(5):
        recs, clocks = [], {}
        for _ in range(120):
            client = rng.randrange(1, 5)
            clock = clocks.get(client, 0)
            clocks[client] = clock + 1
            key = rng.choice("ab")
            prior = [r for r in recs if r.key == key]
            origin = rng.choice([None] + [p.id for p in prior[-3:]])
            recs.append(RefRecord(client=client, clock=clock,
                                  parent_root="m", key=key, origin=origin,
                                  content=clock))
        check_merge(recs)


def test_records_to_columns_and_interner_match_reference():
    recs, _ = union_of(_nested_map_parents() + _causal_chains())
    recs = ref_merge.resolve_parents(recs)
    ref_int, port_int = ref_merge.Interner(), merge.Interner()
    want = ref_merge.records_to_columns(recs, ref_int, pad=64)
    got = merge.records_to_columns([_port_rec(r) for r in recs], port_int,
                                   pad=64)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and \
            np.array_equal(got[k], want[k]), k
    assert port_int.roots == ref_int.roots and port_int.keys == ref_int.keys
    # ops/merge re-exports the codec's one copy, no second fork
    from crdt_tpu_torch.codec import native

    assert merge.resolve_parents is native.resolve_parents


# ---------------------------------------------------------------------------
# fetch_packed_i32, _rank_conflict_groups
# ---------------------------------------------------------------------------


def test_fetch_packed_i32_one_transfer():
    a = torch.tensor([3, -1, 7], dtype=torch.int64)
    b = torch.tensor([0, 1], dtype=torch.int32)
    c = torch.tensor([], dtype=torch.int32)
    t = tracer.set_tracer(tracer.Tracer(enabled=True))
    try:
        got = device.fetch_packed_i32(a, b, c)
    finally:
        tracer.set_tracer(tracer.Tracer(enabled=False))
    assert [x.tolist() for x in got] == [[3, -1, 7], [0, 1], []]
    assert all(x.dtype == np.int32 for x in got)
    assert t.counters("xfer.d2h_fetches")["xfer.d2h_fetches"] == 1


def _spy_rank_groups(monkeypatch, module, seen):
    orig = module._rank_conflict_groups

    def spy(engine, seq_list, seg, parent_arr, key1, key2, *rest):
        hard = orig(engine, seq_list, seg, parent_arr, key1, key2, *rest)
        seen.append((sorted(hard), key1.tolist(), key2.tolist()))
        return hard

    monkeypatch.setattr(module, "_rank_conflict_groups", spy)


def _engine_blobs(engines):
    return [ref_v1.encode_update(e.records_since(None), e.delete_set())
            for e in engines]


def _seq_fuzz(seed, trials):
    rng = random.Random(seed)
    for _ in range(trials):
        engines = [RefEngine(i + 1) for i in range(rng.choice([2, 3, 5]))]
        for _ in range(120):
            _seq_fuzz_op(rng, rng.choice(engines), engines)
        yield _engine_blobs(engines)


def _mixed_fuzz(seed, trials):
    rng = random.Random(seed)
    for _ in range(trials):
        engines = [RefEngine(i + 1) for i in range(3)]
        for _ in range(150):
            _random_op(rng, rng.choice(engines), engines)
        yield _engine_blobs(engines)


def _rights_soup(seed, trials):
    rng = random.Random(seed)
    for _ in range(trials):
        recs = [RefRecord(client=1, clock=0, parent_root="s", content=0)]
        for k in range(1, 5):
            recs.append(RefRecord(client=1, clock=k, parent_root="s",
                                  origin=(1, k - 1), content=k))
        ids = [(1, k) for k in range(5)]
        for client in (2, 3, 4):
            for k in range(rng.randint(2, 8)):
                roll = rng.random()
                right = (None if roll < 0.4
                         else ids[rng.randrange(len(ids))] if roll < 0.8
                         else (99, rng.randrange(50)))
                rec = RefRecord(client=client, clock=k, parent_root="s",
                                origin=ids[rng.randrange(len(ids))],
                                right=right, content=client * 100 + k)
                recs.append(rec)
                ids.append(rec.id)
        yield [ref_v1.encode_update(recs, None)]


FUZZ = {
    "sequences_4242": lambda: _seq_fuzz(4242, 12),
    "mixed_31337": lambda: _mixed_fuzz(31337, 6),
    "rights_soup_31": lambda: _rights_soup(31, 8),
}


@pytest.mark.parametrize("name", list(FUZZ))
def test_rank_conflict_groups_on_fuzz_seeds(name, monkeypatch):
    ref_seen, port_seen = [], []
    _spy_rank_groups(monkeypatch, ref_da, ref_seen)
    _spy_rank_groups(monkeypatch, device_apply, port_seen)
    for blobs in FUZZ[name]():
        docs = {v: _doc(v, 10**6, []) for v in VARIANTS}
        for d in docs.values():
            d.apply_updates(blobs)
        assert_same(docs)
    assert port_seen == ref_seen and ref_seen
