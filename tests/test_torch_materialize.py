"""The port's replay assembly (``models/replay.py``: ``materialize``,
``assemble_cache``, ``visible_mask``, ``rows_visible``) against a copy
of the per-row walk it replaced, on the CPU.

The cache must equal the walk's as JSON text, key order included (the
multi-tenant digest serialises it), in both of its size regimes (the
array pass, and the per-row pass below ``SMALL_ROWS``): on every Yjs
wire fixture and their union, a crafted cyclic nesting cut at 64
levels, a fan-in trace on the packed path and on the host route's
converge, each stream shard's ``assemble_cache`` subset, and a 10-field
YCSB-shaped doc. Visibility must equal the delete set's own scalar
test, and ``materialize.rows`` must count each value by how it was
built.
"""

import json

import numpy as np
import pytest

from crdt_tpu_torch.codec.v1 import encode_update
from crdt_tpu_torch.core.ids import DeleteSet
from crdt_tpu_torch.core.records import ItemRecord
from crdt_tpu_torch.core.store import K_ANY, K_TYPE, TYPE_ARRAY, TYPE_MAP
from crdt_tpu_torch.models import replay as rp
from crdt_tpu_torch.models import streaming as sm
from crdt_tpu_torch.models import traces
from crdt_tpu_torch.models.streaming import stream_replay
from crdt_tpu_torch.obs.tracer import Tracer, set_tracer
from crdt_tpu_torch.ops import packed, staging
from tests import test_yjs_fixtures as fx
from tests.test_streaming import mixed_blobs, nested_blobs

FIXTURES = ("FIX_MAP_SET", "FIX_TEXT_GC", "FIX_NESTED", "FIX_ANY_EDGE",
            "FIX_JSON_RUN", "FIX_BINARY", "FIX_EMBED", "FIX_FORMAT",
            "FIX_DOC", "FIX_SKIP_MID")


# -- the oracle: the per-row walk, with the delete set's scalar test ----

def _oracle_visible(dec, rows, ds):
    return [not ds.contains(int(dec["client"][r]), int(dec["clock"][r]))
            for r in rows]


def _oracle_assemble_cache(dec, ds, win_rows, win_vis, seq_orders):
    keys = dec["keys"]
    kid = dec["key_id"]
    client, clock = dec["client"], dec["clock"]
    kind_col, tref = dec["kind"], dec["type_ref"]
    contents = dec["contents"]

    all_seq_rows = sorted(
        {int(r) for rows in seq_orders.values() for r in rows}
    )
    seq_vis = dict(
        zip(all_seq_rows, _oracle_visible(dec, all_seq_rows, ds))
    )

    map_groups = {}
    for row, vis in zip(win_rows, win_vis):
        if not vis:
            continue
        map_groups.setdefault(rp.parent_spec(dec, row), {})[
            keys[kid[row]]
        ] = row

    def value_of(row, depth):
        if kind_col[row] == K_TYPE:
            spec = ("item", int(client[row]), int(clock[row]))
            is_map = tref[row] == TYPE_MAP
            return collection(spec, is_map, depth + 1)
        return contents[row]

    def collection(spec, is_map, depth):
        if depth > 64:
            return None
        if is_map:
            return {
                k: value_of(r, depth)
                for k, r in map_groups.get(spec, {}).items()
            }
        return [
            value_of(r, depth)
            for r in seq_orders.get(spec, ())
            if seq_vis[int(r)]
        ]

    cache = {}
    for spec in map_groups:
        if spec[0] == "root" and spec[1] != "ix":
            cache[spec[1]] = collection(spec, True, 0)
    for spec in seq_orders:
        if spec[0] == "root" and spec[1] not in cache:
            cache[spec[1]] = collection(spec, False, 0)
    return cache, map_groups.get(("root", "ix"), {})


def _oracle_materialize(dec, ds, w, v, o):
    cache, ix_group = _oracle_assemble_cache(dec, ds, w, v, o)
    rp.finish_cache(cache, dec, ix_group)
    return cache


def _text(cache) -> str:
    # default=repr: binary payloads (ContentBinary) are bytes
    return json.dumps(cache, default=repr)


# -- the inputs ------------------------------------------------------------

def _gathered(blobs, route="device"):
    """(dec, ds, win_rows, win_vis, seq_orders) of a packed converge on
    the CPU: the device route's staging, or the host route's wide one."""
    dec = rp.decode(blobs)
    cols, ds = rp.stage(dec)
    if route == "host":
        plan = staging.stage(cols, wide=True)
        handle = ("packed", packed.converge(plan, device="cpu"))
    else:
        handle = rp.converge(cols, device="cpu")
    return (dec, ds) + rp.gather(dec, ds, handle, device="cpu")


def _ycsb_doc():
    """One YCSB record: a root map of 10 fields of 100 bytes, then
    updates that each replace a field (the old item tombstoned)."""
    recs, ds, tail = [], DeleteSet(), {}
    for f in range(10):
        recs.append(ItemRecord(client=7, clock=f, parent_root="usertable",
                               key=f"field{f}", content="a" * 100))
        tail[f] = f
    for k in range(10, 16):
        f = (k * 3) % 10
        recs.append(ItemRecord(client=7, clock=k, parent_root="usertable",
                               key=f"field{f}", origin=(7, tail[f]),
                               content=chr(ord("a") + k) * 100))
        ds.add(7, tail[f], 1)
        tail[f] = k
    return _gathered([encode_update(recs, ds)])


def _cyclic():
    """Type items that are their own descendants (a duplicated id, as
    only crafted columns carry): a map holding itself under key ``self``
    and an array holding itself, both reached from root ``m``; the walk
    cuts each at 64 levels. Row 4 is a tombstoned array member."""
    roots = ["m"]
    keys = ["a", "b", "self"]
    #          id      parent (root | item)  key  kind    type
    rows = [((1, 0), (0, -1, -1), 0, K_TYPE, TYPE_MAP),
            ((1, 1), (0, -1, -1), 1, K_TYPE, TYPE_ARRAY),
            ((1, 0), (-1, 1, 0), 2, K_TYPE, TYPE_MAP),
            ((1, 1), (-1, 1, 1), -1, K_TYPE, TYPE_ARRAY),
            ((1, 2), (-1, 1, 1), -1, K_ANY, 0)]
    dec = {
        "client": np.asarray([r[0][0] for r in rows], np.int64),
        "clock": np.asarray([r[0][1] for r in rows], np.int64),
        "parent_root": np.asarray([r[1][0] for r in rows], np.int32),
        "parent_client": np.asarray([r[1][1] for r in rows], np.int64),
        "parent_clock": np.asarray([r[1][2] for r in rows], np.int64),
        "key_id": np.asarray([r[2] for r in rows], np.int32),
        "kind": np.asarray([r[3] for r in rows], np.int32),
        "type_ref": np.asarray([r[4] for r in rows], np.int32),
        "roots": roots, "keys": keys,
        "contents": [None, None, None, None, "gone"],
    }
    ds = DeleteSet()
    ds.add(1, 2, 1)
    seq_orders = {("item", 1, 1): [3, 4]}
    return dec, ds, [0, 1, 2], np.ones(3, bool), seq_orders


def _shuffled(gathered):
    """The same winners and streams in another order: the cache's key
    order follows the order the winners and streams come in."""
    dec, ds, w, v, o = gathered
    perm = np.random.default_rng(11).permutation(len(w))
    specs = list(o)[::-1]
    return (dec, ds, [w[i] for i in perm], np.asarray(v)[perm],
            {spec: o[spec] for spec in specs})


CASES = {f"fixture-{name}": (lambda name=name: _gathered(
    [getattr(fx, name)])) for name in FIXTURES}
CASES.update({
    "fixtures-union": lambda: _gathered(
        [getattr(fx, name) for name in FIXTURES]),
    "cyclic-cut": _cyclic,
    "fanin-20x200-device": lambda: _gathered(traces.build_trace(20, 200)),
    "fanin-20x200-host": lambda: _gathered(traces.build_trace(20, 200),
                                           route="host"),
    "fanin-20x200-shuffled": lambda: _shuffled(
        _gathered(traces.build_trace(20, 200))),
    "ycsb-10-fields": _ycsb_doc,
    "nested-engine": lambda: _gathered(nested_blobs()),
})


@pytest.fixture(params=["arrays", "per-row"])
def regime(request, monkeypatch):
    """Each size regime forced on every input."""
    monkeypatch.setattr(rp, "SMALL_ROWS",
                        0 if request.param == "arrays" else 1 << 62)
    return request.param


@pytest.mark.parametrize("case", sorted(CASES))
def test_materialize_equals_the_per_row_walk(case, regime):
    dec, ds, w, v, o = CASES[case]()
    want = _oracle_materialize(dec, ds, w, v, o)
    got = rp.materialize(dec, ds, w, v, o)
    assert _text(got) == _text(want)
    if case == "cyclic-cut":
        depth, node = 0, got["m"]["a"]
        while node is not None:
            depth, node = depth + 1, node["self"]
        assert depth == 64
        assert len(got["m"]["b"]) == 1  # the tombstoned member dropped


@pytest.mark.parametrize("blobs", [mixed_blobs, nested_blobs],
                         ids=["mixed", "nested"])
def test_stream_shard_subsets_equal_the_walk_and_merge_to_one_shot(
        blobs, regime, monkeypatch):
    blobs = blobs()
    calls = []
    assemble = rp.assemble_cache

    def recorded(dec, ds, w, v, o):
        part = assemble(dec, ds, w, v, o)
        calls.append((part, _oracle_assemble_cache(dec, ds, w, v, o)))
        return part

    monkeypatch.setattr(sm.rp, "assemble_cache", recorded)
    got = stream_replay(blobs, max_shards=3, min_shard_rows=1,
                        device="cpu")
    assert len(calls) >= 2
    for (cache, ix), (want_cache, want_ix) in calls:
        assert _text(cache) == _text(want_cache)
        assert ix == want_ix
    dec, ds, w, v, o = _gathered(blobs)
    one_shot = rp.materialize(dec, ds, w, v, o)
    assert got.cache == one_shot
    for root, value in one_shot.items():
        assert _text(got.cache[root]) == _text(value)


def _wide_ids(rng, n_rows, n_ranges, client_bits, clock_bits):
    # clients that differ only above their low ``client_bits - 3`` bits
    step = 1 << (client_bits - 3)
    clients = int(rng.integers(0, step)) + step * np.arange(6, dtype=np.int64)
    ds = DeleteSet()
    for _ in range(n_ranges):
        ds.add(int(rng.choice(clients[:4])),
               int(rng.integers(0, (1 << clock_bits) - 8)),
               int(rng.integers(1, 8)))
    row_c = rng.choice(clients, n_rows)
    row_k = rng.integers(0, 1 << clock_bits, n_rows, dtype=np.int64)
    # rows at and around every range's bounds, of its client and of a
    # client with no range
    trip = list(ds.iter_all())
    edge_c = np.asarray([x for c, _, _ in trip for x in (c,) * 4
                         + (clients[5],)], np.int64)
    edge_k = np.asarray([k for _, s, n in trip
                         for k in (s - 1, s, s + n - 1, s + n, s)], np.int64)
    dec = {"client": np.concatenate([row_c, edge_c]),
           "clock": np.maximum(np.concatenate([row_k, edge_k]), 0)}
    return dec, ds


@pytest.mark.parametrize("client_bits,clock_bits", [
    (10, 20),   # packs as it is
    (32, 31),   # Yjs's random 32-bit clients: packs as it is
    (53, 40),   # the widest ids: clients rank first
])
def test_visible_mask_is_an_array_equal_to_the_scalar_test(
        client_bits, clock_bits):
    rng = np.random.default_rng(client_bits)
    dec, ds = _wide_ids(rng, 400, 60, client_bits, clock_bits)
    rows = list(range(len(dec["client"])))
    got = rp.visible_mask(dec, rows, ds)
    assert isinstance(got, np.ndarray) and got.dtype == bool
    want = _oracle_visible(dec, rows, ds)
    assert got.tolist() == want
    assert 0 < sum(want) < len(want)
    assert rp.visible_mask(dec, [], ds).tolist() == []
    assert rp.visible_mask(dec, rows, DeleteSet()).all()


@pytest.mark.parametrize("case,flat_all", [
    ("fanin-20x200-device", True),
    ("fixture-FIX_NESTED", False),
    ("nested-engine", False),
])
def test_materialize_rows_counts_flat_and_nested_values(case, flat_all):
    dec, ds, w, v, o = CASES[case]()
    tracer = set_tracer(Tracer(enabled=True))
    try:
        cache = rp.materialize(dec, ds, w, v, o)
    finally:
        set_tracer(Tracer(enabled=False))
    counts = tracer.counters("materialize.rows")
    flat = counts.get('materialize.rows{path="flat"}', 0)
    nested = counts.get('materialize.rows{path="nested"}', 0)
    if flat_all:
        assert nested == 0
        assert flat == sum(len(c) for c in cache.values()) > 0
    else:
        assert nested > 0
