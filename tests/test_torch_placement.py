"""The port's fleet placement (``crdt_tpu_torch.fleet.placement``)
against the reference's, on the CPU.

Every case of tests/test_placement.py runs on the port and on the
reference with the same inputs: the ring's owner map, successors and
least-loaded hint, the ``LeaseTable`` grant and admit ladders with their
counters, the tracer rows the fence emits (labels included), and the
lease blob's persistence. Outcomes must be equal, and the port must
meet the reference test's own pins. The lease blob is byte-equal across
the packages, and a table restarts from a store the other package
wrote.
"""

import hashlib
import types

import pytest

from crdt_tpu.fleet import placement as ref_placement
from crdt_tpu.obs import Tracer as RefTracer
from crdt_tpu.obs import set_tracer as ref_set_tracer
from crdt_tpu.storage.snapshot import SnapshotStore as RefStore
from crdt_tpu_torch.fleet import placement
from crdt_tpu_torch.obs import Tracer, set_tracer
from crdt_tpu_torch.storage.snapshot import SnapshotStore

PKGS = {
    "ref": types.SimpleNamespace(
        pl=ref_placement, Store=RefStore, Tracer=RefTracer,
        set_tracer=ref_set_tracer),
    "port": types.SimpleNamespace(
        pl=placement, Store=SnapshotStore, Tracer=Tracer,
        set_tracer=set_tracer),
}
MEMBERS = ["a", "b", "c"]
DOCS = ["doc", "w", "x", "y", "tenant-0", "flood!", ""] + \
    ["d%d" % i for i in range(200)] + ["w%02d" % i for i in range(32)]


@pytest.fixture(autouse=True)
def _quiet_obs():
    olds = [(p, p.set_tracer(p.Tracer(enabled=False)))
            for p in PKGS.values()]
    yield
    for p, old in olds:
        p.set_tracer(old)


def both(case, *args):
    """``case(pkg, *args)`` on the reference and on the port: equal
    outcomes; returns the port's."""
    want = case(PKGS["ref"], *args)
    got = case(PKGS["port"], *args)
    assert got == want
    return got


# ---- the hash ------------------------------------------------------


class TestStableHash:
    def test_pinned_values(self):
        def case(p):
            return [p.pl.stable_hash(k) for k in DOCS + ["a#0", "a#1"]]

        got = both(case)
        assert placement.stable_hash("doc") == int.from_bytes(
            hashlib.sha1(b"doc").digest()[:8], "big")
        assert placement.stable_hash("") == 0xDA39A3EE5E6B4B0D
        assert got[-2] != got[-1]

    def test_independent_of_pythonhashseed(self):
        def case(p):
            return p.pl.stable_hash("tenant-0") == \
                p.pl.stable_hash("tenant-0")

        assert both(case)


# ---- the ring ------------------------------------------------------


class TestHashRing:
    def test_owner_map_is_deterministic_and_pinned(self):
        def case(p):
            r1 = p.pl.HashRing(MEMBERS, vnodes=64)
            r2 = p.pl.HashRing(["c", "a", "b"], vnodes=64)
            return ({d: r1.owner(d) for d in DOCS},
                    {d: r2.owner(d) for d in DOCS}, r1.members)

        m1, m2, members = both(case)
        assert m1 == m2 and members == MEMBERS
        assert (m1["doc"], m1["w"], m1["tenant-0"], m1["flood!"],
                m1["y"]) == ("a", "b", "c", "b", "a")

    def test_member_required(self):
        def case(p):
            out = []
            for build in (lambda: p.pl.HashRing([], vnodes=8).owner("doc"),
                          lambda: p.pl.HashRing(["a"], vnodes=0)):
                with pytest.raises(ValueError) as e:
                    build()
                out.append(str(e.value))
            out.append(p.pl.HashRing([], vnodes=8).successors("doc", 3))
            return out

        both(case)

    def test_join_moves_only_to_the_joiner(self):
        def case(p):
            before = p.pl.HashRing(MEMBERS, vnodes=64)
            after = p.pl.HashRing(MEMBERS + ["d"], vnodes=64)
            return {d: (before.owner(d), after.owner(d)) for d in DOCS}

        moves = both(case)
        moved = [d for d, (b, a) in moves.items() if b != a]
        assert moved and all(moves[d][1] == "d" for d in moved)

    def test_leave_moves_only_the_leavers_docs(self):
        def case(p):
            before = p.pl.HashRing(MEMBERS, vnodes=64)
            after = p.pl.HashRing(MEMBERS, vnodes=64)
            after.remove("c")
            after.remove("zz")  # absent: a no-op
            return {d: (before.owner(d), after.owner(d)) for d in DOCS}

        for b, a in both(case).values():
            assert a == b if b != "c" else a in ("a", "b")

    def test_successors_distinct_owner_first(self):
        def case(p):
            r = p.pl.HashRing(MEMBERS, vnodes=64)
            r.add("a")  # present: a no-op
            return {d: (r.owner(d), r.successors(d, 3), r.successors(d, 2))
                    for d in DOCS}

        for owner, s3, s2 in both(case).values():
            assert s3[0] == owner and sorted(s3) == MEMBERS
            assert s2 == s3[:2]

    def test_least_loaded_successor(self):
        loads = [{"b": 10.0, "c": 1.0}, {"b": 5.0, "c": 5.0}, None,
                 {"a": 0.0}, {"b": 1.0, "c": 1.0, "a": 0.5}]

        def case(p):
            r = p.pl.HashRing(MEMBERS, vnodes=64)
            return [[r.least_loaded_successor(d, exclude=ex, loads=ld)
                     for ld in loads]
                    for d in DOCS
                    for ex in ([], ["a"], [r.owner(d)], MEMBERS)]

        got = both(case)
        i = DOCS.index("doc") * 4 + 1   # "doc", exclude a
        assert got[i][:3] == ["c", "b", got[i][2]]
        assert got[i][2] in ("b", "c")
        assert got[i + 2] == [None] * len(loads)


# ---- the fence -----------------------------------------------------


def _table(p, proc="a", store=None):
    return p.pl.LeaseTable(proc, p.pl.HashRing(MEMBERS, vnodes=64),
                           store=store)


class TestLeaseTable:
    def test_ring_seeded_epoch_one(self):
        def case(p):
            t = _table(p, "a")
            return (t.lease("doc"), t.holds("doc"), t.holds("w"),
                    tuple(t.token("doc")), t.owned_docs(DOCS),
                    t.epochs_of(["doc", "w"]), t.recorded())

        lease, holds_doc, holds_w, token, owned, epochs, rec = both(case)
        assert lease == (1, "a") and holds_doc and not holds_w
        assert token == (1, "a") and "doc" in owned and "w" not in owned
        assert epochs == {"doc": 1, "w": 1} and rec == {}
        assert isinstance(_table(PKGS["port"]).token("doc"),
                          placement.FencingToken)

    def test_grant_ladder(self):
        def case(p):
            t = _table(p, "a")
            steps = [t.grant("doc", 2, "c"), t.lease("doc"),
                     t.holds("doc"), t.grant("doc", 1, "a"),
                     t.fence_rejects, t.grant("doc", 2, "b"),
                     t.fork_refused, t.grant("doc", 2, "c"),
                     t.lease("doc")]
            return steps, t.recorded()

        steps, rec = both(case)
        assert steps == [True, (2, "c"), False, False, 1, False, 1, True,
                         (2, "c")]
        assert rec == {"doc": (2, "c")}

    def test_admit_ladder(self):
        def case(p):
            t = _table(p, "a")
            T = p.pl.FencingToken
            t.grant("doc", 3, "a")
            return [t.admit("doc", T(2, "b"), op="update"),
                    t.fence_rejects,
                    t.admit("doc", T(3, "b"), op="update"), t.fork_refused,
                    t.lease("doc"), t.admit("doc", T(3, "a"), op="update"),
                    t.admit("doc", T(5, "b"), op="beacon"), t.lease("doc"),
                    t.fence_rejects, t.fork_refused]

        assert both(case) == [False, 1, False, 1, (3, "a"), True, True,
                              (5, "b"), 1, 1]

    def test_fence_reject_tracer_labels(self):
        def case(p):
            tracer = p.set_tracer(p.Tracer(enabled=True))
            try:
                t = _table(p, "a")
                T = p.pl.FencingToken
                t.grant("doc", 3, "a")
                t.admit("doc", T(1, "b"), op="serve")
                t.admit("doc", T(1, "b"), op="update")
                t.admit("doc", T(3, "b"), op="update")
                t.grant("doc", 2, "c")
                t.grant("doc", 3, "c")
                return dict(tracer.counters())
            finally:
                p.set_tracer(p.Tracer(enabled=False))

        counters = both(case)
        assert counters['fleet.fence_rejects{op="serve"}'] == 1
        assert counters['fleet.fence_rejects{op="update"}'] == 1
        assert counters['fleet.fence_rejects{op="grant"}'] == 1
        assert counters["fleet.fork_refused"] == 2

    def test_persistence_round_trip(self, tmp_path):
        def case(p):
            store = p.Store(str(tmp_path / p.pl.__name__))
            t = _table(p, "a", store=store)
            t.grant("doc", 4, "c")
            t.grant("w", 7, "a")
            raw = store.get_blob(p.pl.LEASE_BLOB)
            t2 = _table(p, "a", store=store)
            return (raw, t2.lease("doc"), t2.lease("w"), t2.holds("w"),
                    t2.holds("doc"), t2.grant("doc", 3, "a"),
                    t2.fence_rejects)

        raw, *rest = both(case)
        assert b'"doc"' in raw
        assert rest == [(4, "c"), (7, "a"), True, False, False, 1]

    def test_corrupt_lease_blob_falls_back_to_ring(self, tmp_path):
        def case(p):
            store = p.Store(str(tmp_path / p.pl.__name__))
            store.put_blob(p.pl.LEASE_BLOB, b"not json {")
            first = _table(p, "a", store=store).lease("doc")
            store.put_blob(p.pl.LEASE_BLOB,
                           b'{"doc": "bogus", "w": [9, "b"], "x": [1]}')
            t2 = _table(p, "a", store=store)
            return first, t2.lease("doc"), t2.lease("w"), t2.lease("x")

        got = both(case)
        assert got[:3] == ((1, "a"), (1, "a"), (9, "b"))


# ---- in place of the README registry pin ---------------------------


def test_fence_counter_keys_match_reference():
    """The reference pins its fence counters' names in the README
    registry; the port's tracer must emit exactly the reference's keys,
    labels included, over one scenario that walks every fence rung."""
    def case(p):
        tracer = p.set_tracer(p.Tracer(enabled=True))
        try:
            t = _table(p, "b")
            T = p.pl.FencingToken
            for op in ("serve", "update", "beacon", "offer", "grant"):
                t.grant("doc", 4, "a")
                t.admit("doc", T(2, "c"), op=op)
                t.reject("w", op)
            t.admit("doc", T(4, "c"), op="update")
            t.grant("doc", 4, "c")
            t.admit("doc", T(6, "b"), op="beacon")
            return dict(tracer.counters())
        finally:
            p.set_tracer(p.Tracer(enabled=False))

    counters = both(case)
    assert counters["fleet.fork_refused"] == 2
    assert {k.split("{")[0] for k in counters} == {
        "fleet.fence_rejects", "fleet.fork_refused"}


# ---- across the packages --------------------------------------------


LEASE_SETS = [
    [],
    [("doc", 2, "c")],
    [("doc", 2, "c"), ("w", 7, "a"), ("tenant-0", 3, "b"),
     ("flood!", 5, "c"), ("unicodé", 2, "b")],
    [("d%d" % i, 2 + i % 5, MEMBERS[i % 3]) for i in range(64)],
]


@pytest.mark.parametrize("grants", LEASE_SETS,
                         ids=["none", "one", "mixed", "many"])
def test_lease_blob_bytes_equal_and_cross_loadable(tmp_path, grants):
    """The same grants write byte-equal lease blobs in both packages,
    and each package's table restarts from the other's store with the
    same leases (a process may restart under the other package)."""
    tables, raws = {}, {}
    for name, p in PKGS.items():
        store = p.Store(str(tmp_path / name))
        t = _table(p, "a", store=store)
        for d, e, o in grants:
            assert t.grant(d, e, o)
        if not grants:
            t._save()
        tables[name], raws[name] = t, store.get_blob(p.pl.LEASE_BLOB)
    assert raws["port"] == raws["ref"]
    for name, other in (("ref", "port"), ("port", "ref")):
        p = PKGS[other]
        t = _table(p, "a", store=p.Store(str(tmp_path / name)))
        assert t.recorded() == tables[name].recorded()
        assert {d: t.lease(d) for d in DOCS} == \
            {d: tables[name].lease(d) for d in DOCS}
