"""The port's document API (``crdt_tpu_torch.api``) against the
reference's, on the CPU.

The same ops, with the same client ids, go through the reference
``Crdt`` and the port's ``Crdt`` (both over a scalar engine), and through
the reference ``ResidentCrdt`` and the port's
``ResidentCrdt(device="cpu")`` (both over ``IncrementalReplay``). Each
pair must agree exactly on every emitted update blob and its meta, every
op's result or exception, every observer event (origin, touched roots,
value and the cache snapshot), the cache ``c``, the state-vector bytes
and the full-state bytes; all four must agree on ``c``. The port's
``Crdt`` must rebuild the grand differential's random traces byte for
byte, and read each foreign v1 fixture as the reference does.
"""

import json
import random

import pytest

from crdt_tpu.api import Crdt as RefCrdt
from crdt_tpu.api import ResidentCrdt as RefResident
from crdt_tpu.ops import packed as ref_pk
from crdt_tpu_torch.api import Crdt, ResidentCrdt
from crdt_tpu_torch.models.replay import replay_trace
from crdt_tpu_torch.ops import packed as pk
from tests import test_yjs_fixtures as fx
from tests.test_grand_differential import _random_trace as ref_random_trace

# (reference factory, port factory) a backend; the port's resident
# document runs on the CPU, its crossover pinned ("device-rounds": every
# round with rows takes the device round, the plain scatter on the CPU)
BACKENDS = {
    "engine": (RefCrdt, Crdt),
    "resident": (RefResident,
                 lambda cid, **kw: ResidentCrdt(cid, device="cpu", **kw)),
    "resident-device-rounds": (
        lambda cid, **kw: RefResident(cid, device_min_rows=1, **kw),
        lambda cid, **kw: ResidentCrdt(cid, device_min_rows=1,
                                       device="cpu", **kw)),
}


def _json(value):
    return json.dumps(value, sort_keys=True, default=repr)


class Recorded:
    """A document with everything it emits recorded: update blobs with
    their meta, ``observer_function`` events, collection and key
    observer events, and each op's result or exception class."""

    def __init__(self, factory, cid, **kw):
        self.out = []
        self.log = []
        self.doc = factory(
            cid,
            on_update=lambda u, m: self.out.append((bytes(u), dict(m))),
            observer_function=lambda e: self.log.append(("all", _event(e))),
            **kw,
        )

    def do(self, op, *args, **kw):
        try:
            result = getattr(self.doc, op)(*args, **kw)
        except Exception as e:  # the exception class is the result
            self.log.append((op, "raises", type(e).__name__))
            return None
        self.log.append((op, "returns", _json(result)))
        return result

    def observe(self, name, key=None):
        tag = f"observe {name} {key}"
        self.doc.observe(name, lambda e: self.log.append((tag, _event(e))),
                         key=key)

    def state(self):
        return {
            "c": _json(dict(self.doc.c)),
            "sv": self.doc.encode_state_vector(),
            "full": self.doc.encode_state_as_update(),
        }


def _event(e):
    return _json({k: (dict(v) if k == "c" else v) for k, v in e.items()})


# ---------------------------------------------------------------------------
# scenarios: each takes a factory ``mk(cid, **kw) -> Recorded`` and returns
# the documents it drove (the op surface of tests/test_api.py)
# ---------------------------------------------------------------------------


def map_ops(mk):
    d = mk(1)
    d.do("map", "users")
    d.do("set", "users", "u1", {"age": 30})
    d.do("set", "people", "p1", 5)  # auto-create
    d.do("get", "users", "u1")
    d.do("get", "users", "missing")
    d.do("get", "users")
    d.do("set", "users", "u2", [1, {"x": None}])
    d.do("delete", "users", "u1")
    d.do("delete", "users", "u1")  # already gone
    d.do("del_", "people", "nobody")
    d.do("set", "m", "k", "a")
    d.do("set", "m", "k", "b")  # LWW overwrite
    for name in ("ix", "doc"):  # reserved names
        d.do("map", name)
        d.do("set", name, "k", 1)
    d.do("set", "m", "", 1)  # empty key
    d.do("map", "")  # empty name
    d.do("push", "m", 1)  # a map is not an array
    d.do("array", "a")
    d.do("set", "a", "k", 1)  # an array is not a map
    d.do("map", "a")
    return [d]


def array_ops(mk):
    d = mk(1)
    d.do("array", "log")
    d.do("push", "log", "b")
    d.do("push", "log", ["c", "d"])
    d.do("insert", "log", 0, "a")
    d.do("unshift", "log", ["y", "z"])
    d.do("cut", "log", 1, 2)
    d.do("insert", "log", 3, ["m", "n"])
    d.do("insert", "log", 99, "x")  # out of range
    d.do("cut", "log", 50, 1)  # past the visible tail
    d.do("cut", "log", 0, 99)
    d.do("push", "log", 7)
    d.do("insert", "arr", 5, "x")  # raises, but 'arr' is registered
    d.do("push", "arr", "ok")
    return [d]


def nested_ops(mk):
    d = mk(1)
    d.do("set", "m", "list", "x", array_method="push")
    d.do("set", "m", "list", ["y", "z"], array_method="push")
    d.do("set", "m", "list", None, array_method="cut", index=1, length=1)
    d.do("set", "m", "l", "c", array_method="push")
    d.do("set", "m", "l", "a", array_method="unshift")
    d.do("set", "m", "l", "b", array_method="insert", index=1)
    d.do("set", "m", "l", "x", array_method="bogus")
    d.do("set", "m", "l", "x", array_method="insert")  # no index
    d.do("set", "m", "l", array_method="cut")  # no index
    d.do("set", "m", "k", [10, 20, 30], array_method="insert", index=0)
    d.do("set", "m", "k", array_method="cut", index=1)
    d.do("set", "m", "plain", 1)
    d.do("set", "m", "plain", "again", array_method="push")  # over a value
    d.do("delete", "m", "list")
    d.do("set", "m", "list", "fresh", array_method="push")
    return [d]


def batch_ops(mk):
    d = mk(1)
    d.do("set", "m", "a", 1, batch=True)
    d.do("set", "m", "b", 2, batch=True)
    d.do("push", "log", "x", batch=True)
    d.do("set", "m", "n", "v", array_method="push", batch=True)
    d.log.append(("pending", d.doc.pending_batch_size))
    d.do("exec_batch")
    d.do("exec_batch")  # empty queue
    d.do("set", "m", "c", 3, batch=True)
    d.do("exec_batch", propagate=False)  # throughDatabase
    d.do("array", "x", batch=True)
    d.do("set", "x", "k", 1, batch=True)  # kind known only at exec
    d.do("exec_batch")
    d.do("push", "a", "x", batch=True)
    d.do("insert", "a", 99, "y", batch=True)  # raises mid-batch
    d.do("push", "a", "never", batch=True)
    d.do("exec_batch")
    d.do("push", "a", "z")
    return [d]


def observer_ops(mk):
    d = mk(1)
    d.observe("m")
    d.observe("m", key="watched")
    d.observe("m", key="list")
    d.do("set", "m", "k", 1)
    d.do("set", "other", "k", 2)
    d.do("set", "m", "watched", 42)
    d.do("set", "m", "list", "a", array_method="push")
    d.do("set", "m", "list", "b", array_method="push")
    d.do("delete", "m", "watched")
    d.do("set", "m", "x", 1, batch=True)
    d.do("set", "m", "watched", "y", batch=True)
    d.do("exec_batch")
    return [d]


def replication_ops(mk):
    """Two documents wired update -> apply, then a third fed the
    first's blobs reversed, tripled and as a state-vector diff; remote
    events carry their origin."""
    docs = {}
    a = mk(1, full_state_updates=False)
    b = mk(2)
    a.doc.on_update = lambda u, m: (a.out.append((bytes(u), dict(m))),
                                    docs["b"].doc.apply_update(u))
    b.doc.on_update = lambda u, m: (b.out.append((bytes(u), dict(m))),
                                    docs["a"].doc.apply_update(u))
    docs["a"], docs["b"] = a, b
    a.observe("users")
    b.observe("users", key="u1")
    a.do("set", "users", "u1", {"n": 1})
    b.do("set", "users", "u2", {"n": 2})
    a.do("push", "log", "a")
    b.do("push", "log", "b")
    a.do("set", "m", "k", "from-a")
    b.do("set", "m", "k", "from-b")
    a.do("insert", "log", 1, "mid")
    b.do("cut", "log", 0, 1)
    a.do("set", "newmap", "k", 1)
    b.do("set", "users", "u1", "list", array_method="push")
    c = mk(3)
    for u, _ in reversed(a.out):  # dependencies arrive late
        c.doc.apply_update(u, origin="sync")
    for u, _ in b.out * 3:  # duplicates
        c.doc.apply_update(u)
    late = mk(4)
    late.doc.apply_update(a.doc.encode_state_as_update(
        late.doc.state_vector()))
    c.do("set", "m", "k", "from-c")
    late.doc.apply_update(c.doc.encode_state_as_update(
        late.doc.state_vector()))
    return [a, b, c, late]


def full_state_ops(mk):
    """The Q2 compatibility mode: every op broadcasts the full state."""
    a = mk(1, full_state_updates=True)
    b = mk(2, full_state_updates=True)
    a.do("set", "m", "a", 1)
    b.doc.apply_update(a.out[-1][0])
    b.do("set", "m", "b", 2)
    a.doc.apply_update(b.out[-1][0])
    a.do("delete", "m", "a")
    a.do("push", "l", [1, 2, 3])
    b.doc.apply_update(a.out[-1][0])
    return [a, b]


SCENARIOS = [map_ops, array_ops, nested_ops, batch_ops, observer_ops,
             replication_ops, full_state_ops]
REMOTE = (replication_ops, full_state_ops)  # scenarios that apply updates


def _run(scenario, factory):
    return scenario(lambda cid, **kw: Recorded(factory, cid, **kw))


@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda s: s.__name__)
def test_op_surface_matches_reference(scenario, backend):
    ref_factory, port_factory = BACKENDS[backend]
    r0, p0 = ref_pk.device_dispatch_count, pk.device_dispatch_count
    ref = _run(scenario, ref_factory)
    got = _run(scenario, port_factory)
    for i, (r, g) in enumerate(zip(ref, got)):
        assert g.out == r.out, (i, "emitted blobs")
        assert g.log == r.log, (i, "results and observer events")
        assert g.state() == r.state(), (i, "c, state vector, full state")
    rounds = (pk.device_dispatch_count - p0,
              ref_pk.device_dispatch_count - r0)
    assert rounds[0] == rounds[1]
    if backend == "resident-device-rounds" and scenario in REMOTE:
        assert rounds[0] > 0  # local ops admit on the host fast path


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda s: s.__name__)
def test_backends_agree_on_the_cache(scenario):
    """The engine-backed and the resident port documents end in the
    same ``c``, which is the reference's."""
    caches = {name: [_json(dict(d.doc.c))
                     for d in _run(scenario, BACKENDS[name][1])]
              for name in BACKENDS}
    assert caches["resident"] == caches["engine"]
    assert caches["resident-device-rounds"] == caches["engine"]


@pytest.mark.parametrize("index,length",
                         [(0, 0), (1, 0), (1, -1), (-1, 1), (-2, 2)])
def test_resident_cut_of_nothing_deletes_nothing(index, length):
    """A cut of no items (length <= 0) or at a negative index deletes
    nothing and emits nothing in every port document, as in the
    engine-backed reference ``Crdt``. The reference ``ResidentCrdt``
    deletes from the index (or the head) on: that divergence is pinned
    here (ROADMAP.md section C)."""
    docs = {name: (Recorded(BACKENDS[name][0], 1),
                   Recorded(BACKENDS[name][1], 1))
            for name in ("engine", "resident")}
    for ref, got in docs.values():
        for d in (ref, got):
            d.do("push", "l", [1, 2, 3])
            d.do("set", "m", "k", [1, 2, 3], array_method="push")
            d.do("cut", "l", index, length)
            d.do("set", "m", "k", array_method="cut", index=index,
                 length=length)
    want = {"l": [1, 2, 3], "m": {"k": [1, 2, 3]}}
    for ref, got in docs.values():
        assert dict(got.doc.c) == want
        assert len(got.out) == 2  # the push and the nested push only
    eng_ref, eng_got = docs["engine"]
    assert eng_got.out == eng_ref.out and eng_got.log == eng_ref.log
    res_ref, res_got = docs["resident"]
    assert res_got.out == res_ref.out[:2]
    assert dict(res_ref.doc.c) != want  # the reference's resident cut


def test_device_merge_raises_naming_item_7(monkeypatch):
    import torch

    # Crdt(device_merge=True) is ported: the rebuild runs on the device
    # it names, the card by default (which raises without one); the
    # host engine takes no device
    doc = Crdt(1, device_merge=True, device="cpu")
    assert doc.device_merge is True and str(doc.device) == "cpu"
    assert Crdt(1, device_merge=False).device_merge is False
    assert Crdt(1).device_merge is False
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Crdt(1, device_merge=True)
    assert Crdt(1, device_merge=False).device is None


def test_resident_doc_without_device_needs_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ResidentCrdt(1)


# ---------------------------------------------------------------------------
# the grand differential's generator (tests/test_grand_differential.py),
# rebuilt over either package's Crdt
# ---------------------------------------------------------------------------


def _random_trace(crdt_cls, seed, n_writers=3, ops=40):
    """``tests.test_grand_differential._random_trace`` over
    ``crdt_cls``; returns the blobs and the writers' documents."""
    rng = random.Random(seed)
    outs = [[] for _ in range(n_writers)]
    docs = []
    for i in range(n_writers):
        out = outs[i]
        cid = i + 1 if seed % 2 == 0 else rng.getrandbits(31)
        docs.append(crdt_cls(cid, on_update=lambda u, m, o=out: o.append(u)))

    def deliver_some():
        blobs = [u for out in outs for u in out]
        rng.shuffle(blobs)
        take = blobs[: rng.randint(0, len(blobs))]
        for d in docs:
            for u in take:
                d.apply_update(u)

    for step in range(ops):
        d = docs[rng.randrange(n_writers)]
        op = rng.random()
        if op < 0.3:
            d.set("m", f"k{rng.randrange(8)}", rng.randrange(100))
        elif op < 0.45:
            d.delete("m", f"k{rng.randrange(8)}")
        elif op < 0.6:
            d.push("l", [step])
        elif op < 0.7:
            n = len(d.c.get("l", []))
            d.insert("l", rng.randint(0, n), f"i{step}")
        elif op < 0.78:
            n = len(d.c.get("l", []))
            if n:
                d.cut("l", rng.randrange(n))
        elif op < 0.88:
            d.set("cfg", "tags", f"t{step}", array_method=rng.choice(
                ["push", "unshift"]))
        elif op < 0.94:
            d.set("m", f"b{step}", step, batch=True)
            d.push("l", [f"b{step}"], batch=True)
            d.exec_batch()
        else:
            deliver_some()

    blobs = [u for out in outs for u in out]
    dup = blobs[: rng.randint(0, len(blobs))]
    return blobs + dup, docs


def test_generator_copy_is_the_reference_generator():
    for seed in range(4):
        assert _random_trace(RefCrdt, seed)[0] == ref_random_trace(seed)


@pytest.mark.parametrize("seed", range(24))
def test_random_trace_blobs_match_reference(seed):
    """3-6 writers, 40-150 ops; odd seeds draw 31-bit client ids."""
    n_writers, ops = 3 + seed % 4, 40 + (seed * 37) % 111
    want, ref_docs = _random_trace(RefCrdt, seed, n_writers, ops)
    blobs, docs = _random_trace(Crdt, seed, n_writers, ops)
    assert blobs == want
    res = replay_trace(blobs, device="cpu")
    for doc, ref_doc in zip(docs, ref_docs):
        assert doc.encode_state_as_update() == \
            ref_doc.encode_state_as_update()
        doc.apply_updates(blobs)  # every writer sees everything
        assert dict(doc.c) == res.cache
    fresh = Crdt(800 + seed)
    fresh.apply_update(res.snapshot)
    assert dict(fresh.c) == res.cache


# ---------------------------------------------------------------------------
# foreign v1 bytes (tests/test_yjs_fixtures.py)
# ---------------------------------------------------------------------------

FIXTURES = {
    name: getattr(fx, name) for name in (
        "FIX_MAP_SET", "FIX_TEXT_GC", "FIX_NESTED", "FIX_ANY_EDGE",
        "FIX_JSON_RUN", "FIX_BINARY", "FIX_EMBED", "FIX_FORMAT",
        "FIX_DOC", "FIX_SKIP_MID",
    )
}


def test_fixture_list_is_the_references():
    assert tuple(FIXTURES.values()) == fx._ALL_REF_FIXTURES


@pytest.mark.parametrize("backend", ["engine", "resident"])
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_foreign_fixture_matches_reference(name, backend):
    ref_factory, port_factory = BACKENDS[backend]
    ref, got = ref_factory(999), port_factory(999)
    ref.apply_update(FIXTURES[name])
    got.apply_update(FIXTURES[name])
    assert _json(dict(got.c)) == _json(dict(ref.c))
    assert got.encode_state_as_update() == ref.encode_state_as_update()
    assert got.encode_state_vector() == ref.encode_state_vector()
    assert bool(got.engine.pending) == bool(ref.engine.pending)
