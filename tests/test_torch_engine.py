"""The port's scalar host machinery against the reference, on the CPU.

``crdt_tpu_torch.core.engine.Engine`` (with its ``ItemStore``), and
``crdt_tpu_torch.ops.yata``'s ``order_sequences`` and
``order_hard_segment``, held against ``crdt_tpu`` on the same seeded
records: right origins (in-group anchors, dangling ids, rights into
another list), duplicates, implicit parents. Chain orders, map winners,
JSON, state vectors and delete sets must be equal, as must the port's
``resolve_parents``, ``_pad_to``, ``evict_deepest`` and tick timeline.
"""

import random

import numpy as np
import pytest

from crdt_tpu.core import engine as ref_engine_mod
from crdt_tpu.core.engine import Engine as RefEngine
from crdt_tpu.core.ids import DeleteSet as RefDeleteSet
from crdt_tpu.core.records import ItemRecord as RefRecord
from crdt_tpu.guard.limits import evict_deepest as ref_evict_deepest
from crdt_tpu.obs import timeline as ref_timeline
from crdt_tpu.ops import merge as ref_merge
from crdt_tpu.ops import yata as ref_yata
from crdt_tpu_torch.codec.native import resolve_parents
from crdt_tpu_torch.core.engine import Engine, evict_deepest
from crdt_tpu_torch.core.ids import DeleteSet
from crdt_tpu_torch.core.records import ItemRecord
from crdt_tpu_torch.obs import timeline
from crdt_tpu_torch.ops import merge, yata

FIELDS = ("client", "clock", "parent_root", "parent_item", "key", "origin",
          "right", "kind", "type_ref", "content")


def random_records(seed: int, n_clients: int = 5, steps: int = 70):
    """Seeded records (as field dicts) in creation order: map sets over
    two maps, inserts into two lists with left origins and in-list
    right origins, mid-run items with no explicit parent, and a tail of
    duplicates. One more writer (client 9) sends the hostile shapes:
    rights that dangle or point into the other list. Its items pend in
    the engine from its first dangling right on; no other writer
    anchors on them."""
    rng = np.random.default_rng(seed)
    clock = {c: 0 for c in (*range(1, n_clients + 1), 9)}
    lists = {"l0": [], "l1": []}
    keys: dict = {}
    out = []
    for step in range(steps):
        hostile = rng.random() < 0.12
        c = 9 if hostile else int(rng.integers(1, n_clients + 1))
        rid = (c, clock[c])
        clock[c] += 1
        rec = dict(client=c, clock=rid[1], content=[c, step])
        if not hostile and rng.random() < 0.3:
            m, k = f"m{int(rng.integers(2))}", f"k{int(rng.integers(3))}"
            chain = keys.setdefault((m, k), [])
            rec.update(parent_root=m, key=k)
            if chain and rng.random() < 0.7:
                rec["origin"] = chain[int(rng.integers(len(chain)))]
            if chain and rng.random() < 0.15:
                rec["right"] = chain[int(rng.integers(len(chain)))]
            chain.append(rid)
            out.append(rec)
            continue
        name = f"l{int(rng.integers(2))}"
        items = lists[name]
        rec["parent_root"] = name
        if items and rng.random() < 0.8:
            rec["origin"] = items[int(rng.integers(len(items)))]
            if rng.random() < 0.25:
                # a mid-run item: the wire omits the parent when an
                # origin is present
                rec["parent_root"] = None
        other = lists["l1" if name == "l0" else "l0"]
        if hostile and other and rng.random() < 0.6:
            rec["right"] = other[int(rng.integers(len(other)))]
        elif hostile:
            rec["right"] = (99, int(rng.integers(3)))  # dangling
        elif items and rng.random() < 0.3:
            rec["right"] = items[int(rng.integers(len(items)))]
        if not hostile:  # nobody anchors on the hostile writer's items
            items.append(rid)
        out.append(rec)
    out += [dict(r) for r in out[: int(rng.integers(1, 8))]]  # duplicates
    return out


def as_records(rows, cls):
    return [cls(**r) for r in rows]


def deletes(seed: int, cls):
    rng = np.random.default_rng(seed + 100)
    ds = cls()
    for _ in range(6):
        ds.add(int(rng.integers(1, 6)), int(rng.integers(0, 12)),
               int(rng.integers(1, 4)))
    return ds


def _pair(seed):
    rows = random_records(seed)
    rng = random.Random(seed)
    shuffled = list(rows)
    rng.shuffle(shuffled)
    ref, port = RefEngine(7), Engine(7)
    ref.apply_records(as_records(shuffled, RefRecord),
                      deletes(seed, RefDeleteSet))
    port.apply_records(as_records(shuffled, ItemRecord),
                       deletes(seed, DeleteSet))
    return ref, port


class TestEngine:
    @pytest.mark.parametrize("seed", range(8))
    def test_remote_integration_matches_reference(self, seed):
        ref, port = _pair(seed)
        assert port.seq_order_table() == ref.seq_order_table()
        assert port.map_winner_table() == ref.map_winner_table()
        assert port.to_json() == ref.to_json()
        assert port.state_vector().clocks == ref.state_vector().clocks
        assert port.delete_set().ranges == ref.delete_set().ranges
        assert port.store.state_vector().clocks == \
            ref.store.state_vector().clocks
        assert [r.id for r in port.pending] == [r.id for r in ref.pending]
        assert port.pending_deletes.ranges == ref.pending_deletes.ranges
        got = port.records_since(None)
        want = ref.records_since(None)
        assert [[getattr(r, f) for f in FIELDS] for r in got] == \
            [[getattr(r, f) for f in FIELDS] for r in want]

    def test_local_ops_match_reference(self):
        out = []
        for cls in (RefEngine, Engine):
            e = cls(3)
            e.map_set("cfg", "a", 1)
            e.map_set("cfg", "a", {"x": [1, 2]})
            t = e.map_set_type("cfg", "arr")
            e.seq_insert("", 0, ["p", "q"], parent=("item",) + t.id)
            e.seq_insert("log", 0, [1, 2, 3])
            e.seq_insert("log", 1, ["mid"])
            e.seq_insert_type("log", 0)
            e.seq_delete("log", 2, 2)
            e.map_delete("cfg", "a")
            out.append((e.to_json(), e.seq_order_table(),
                        e.map_winner_table(), e.delete_set().ranges,
                        e.state_vector().clocks, e.seq_len("log"),
                        e.map_has("cfg", "arr"), e.map_get("cfg", "a")))
        assert out[0] == out[1]

    def test_pending_limit_evicts_like_reference(self):
        rows = random_records(3)
        tail = [r for r in rows if r["clock"] > 2]  # gaps: all pend
        got = []
        for cls, rcls in ((RefEngine, RefRecord), (Engine, ItemRecord)):
            e = cls(1)
            e.pending_limit = 5
            e.apply_records(as_records(tail, rcls))
            got.append(([r.id for r in e.pending],
                         e.take_evicted_ranges()))
        assert got[0] == got[1]

    def test_evict_deepest_matches_reference(self):
        keys = [(c, k) for c in (3, 1, 2) for k in range(c * 3)]
        for limit in (0, 4, 11, 40):
            assert evict_deepest(keys, limit) == \
                ref_evict_deepest(keys, limit)


class TestHostOrdering:
    @pytest.mark.parametrize("seed", range(8))
    def test_order_sequences_matches_reference(self, seed):
        rows = random_records(seed)
        want = ref_yata.order_sequences(as_records(rows, RefRecord))
        got = yata.order_sequences(as_records(rows, ItemRecord),
                                   device="cpu")
        assert got == want

    @pytest.mark.parametrize("seed", range(8))
    def test_order_hard_segment_matches_reference(self, seed):
        rows = [r for r in random_records(seed)
                if r.get("key") is None]
        ids = {(r["client"], r["clock"]) for r in rows}
        # half the foreign references exist elsewhere, half dangle
        exists = lambda ref: ref in ids or ref[1] % 2 == 0  # noqa: E731
        want = ref_yata.order_hard_segment(as_records(rows, RefRecord),
                                           ref_exists=exists)
        got = yata.order_hard_segment(as_records(rows, ItemRecord),
                                      ref_exists=exists)
        assert got == want
        assert yata.order_hard_segment(as_records(rows, ItemRecord)) == \
            ref_yata.order_hard_segment(as_records(rows, RefRecord))

    def test_simulate_group_matches_reference(self):
        rng = np.random.default_rng(4)
        sibs = [dict(id=(int(c), i), client=int(c), clock=i, right=None)
                for i, c in enumerate(rng.integers(1, 6, 12))]
        member_ids = {s["id"] for s in sibs}
        for s in sibs[4:]:
            s["right"] = sibs[int(rng.integers(0, 4))]["id"]
        assert yata._simulate_group(sibs, member_ids) == \
            ref_yata._simulate_group(sibs, member_ids)

    def test_drop_orphan_subtrees_matches_reference(self):
        rng = np.random.default_rng(9)
        seg = rng.integers(-1, 3, 40).astype(np.int32)
        par = rng.integers(-1, 40, 40).astype(np.int32)
        rows = [i for i in range(40) if seg[i] >= 0]
        seg_a, seg_b = seg.copy(), seg.copy()
        assert yata.drop_orphan_subtrees(rows, seg_a, par) == \
            ref_yata.drop_orphan_subtrees(rows, seg_b, par)
        np.testing.assert_array_equal(seg_a, seg_b)


class TestHelpers:
    @pytest.mark.parametrize("seed", range(4))
    def test_resolve_parents_matches_reference(self, seed):
        rows = random_records(seed)
        # a cycle of parentless rows and a parentless dangling chain
        rows += [dict(client=50, clock=0, origin=(50, 1), content=0),
                 dict(client=50, clock=1, origin=(50, 0), content=1),
                 dict(client=51, clock=0, right=(98, 0), content=2)]
        got = resolve_parents(as_records(rows, ItemRecord))
        want = ref_merge.resolve_parents(as_records(rows, RefRecord))
        assert [[getattr(r, f) for f in FIELDS] for r in got] == \
            [[getattr(r, f) for f in FIELDS] for r in want]

    def test_pad_to_matches_reference(self):
        a = np.arange(5, dtype=np.int32)
        for size, fill in ((5, -1), (8, -1), (9, 0)):
            got = merge._pad_to(a, size, fill)
            want = ref_merge._pad_to(a, size, fill)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)

    def test_timeline_overlap_matches_reference(self):
        lanes = {"decode": 0.4, "pack": 0.3, "dispatch": 0.25}
        for wall in (0.3, 0.5, 0.95, 2.0):
            assert timeline.overlap_of(lanes, wall) == \
                ref_timeline.overlap_of(lanes, wall)
        spans = [(0.0, 1.0), (0.5, 1.5), (2.0, 2.5), (2.1, 2.2)]
        assert timeline._merged_windows(spans) == \
            ref_timeline._merged_windows(spans)
        tl = timeline.TickTimeline(enabled=True)
        tl.tick_begin(0, label="stream")
        tok = tl.dispatch_begin(t=1.0)
        tl.dispatch_end(tok, 2.0, 2.5)
        rec = tl.tick_end(extra_busy={"decode": 0.1})
        assert rec["stall_s"] == 0.5 and rec["lanes"]["decode"] == 0.1
        events = tl.to_perfetto(pid=1)["traceEvents"]
        assert any(e["name"] == "dispatch(0)" for e in events)

    def test_engine_module_is_the_reference_engine_api(self):
        public = {n for n in dir(ref_engine_mod.Engine)
                  if not n.startswith("__")}
        assert public <= set(dir(Engine))
