"""The plain reference against Yjs's integration item by item and
against the port's CPU route, on every generator the cells use."""

import numpy as np
import pytest

from benchmark.gen import traces, wire, ycsb
from benchmark.reference import scalar, yjs
from crdt_tpu_torch.models.multidoc import cache_digest
from crdt_tpu_torch.models.replay import replay_trace

NO_DS = (np.zeros(0, np.int64),) * 3


def _cases():
    for R, K, s in [(3, 40, 0), (10, 100, 5), (30, 64, 99)]:
        blobs, t, ds = traces.build_trace(R, K, seed=s)
        yield f"trace{R}x{K}", blobs, t, ds
    for seed in (4, 11):
        r = ycsb.Records(6, 10, 100, np.random.default_rng(seed))
        load = r.writes(range(6), True)[0]
        blobs = wire.encode_updates(load, np.arange(7) * 10, [[]] * 6)
        up = r.writes([0, 0, 5, 0, 3, 0, 0, 5] * 3, False)[0]
        tabs = [wire.take(load, np.arange(10))]
        for row in np.flatnonzero(up["client"] == 1):
            tt = wire.take(up, [row])
            tabs.append(tt)
            blobs.append(wire.encode_updates(tt, np.array([0, 1]),
                                             [[]])[0])
        yield (f"ycsb{seed}", blobs[:1] + blobs[6:], wire.concat(tabs),
               NO_DS)


CASES = list(_cases())


@pytest.mark.parametrize("name,blobs,t,ds", CASES, ids=[c[0] for c in CASES])
def test_reference_equals_scalar_integration(name, blobs, t, ds):
    assert yjs.cache_diff(yjs.converge(t, ds), scalar.converge(t, ds)) == 0


@pytest.mark.parametrize("name,blobs,t,ds", CASES, ids=[c[0] for c in CASES])
def test_reference_equals_port_cpu_route(name, blobs, t, ds):
    res = replay_trace(blobs, route="host")
    want = yjs.converge(t, ds)
    assert yjs.cache_diff(res.cache, want) == 0
    assert res.snapshot == wire.encode_union(t, *ds)
    assert yjs.digest(want) == cache_digest(res.cache)


def test_same_client_siblings_go_left_of_earlier_ones():
    # three sets of one key by one client, no origins: Yjs puts each
    # later one to the left, so the first set stays the value
    t = {"client": np.array([5, 5, 5]), "clock": np.array([0, 1, 2]),
         "root": np.zeros(3, np.int64), "key": np.zeros(3, np.int64),
         "oc": np.full(3, -1), "ok": np.full(3, -1),
         "content": np.array([10, 11, 12]), "roots": ["m"], "keys": ["k"]}
    assert yjs.converge(t, NO_DS) == scalar.converge(t, NO_DS) == \
        {"m": {"k": 10}}
    t2 = dict(t, key=np.full(3, -1))
    assert yjs.converge(t2, NO_DS) == {"m": [12, 11, 10]}


def test_a_deleted_winner_hides_its_key_and_a_list_root_stays():
    t = {"client": np.array([1, 2, 1]), "clock": np.array([0, 0, 1]),
         "root": np.array([0, 0, 1]), "key": np.array([0, 0, -1]),
         "oc": np.full(3, -1), "ok": np.full(3, -1),
         "content": np.array([1, 2, 3]), "roots": ["m", "l"],
         "keys": ["k"]}
    ds = (np.array([2, 1]), np.array([0, 1]), np.array([1, 1]))
    assert yjs.converge(t, ds) == {"l": []}


def test_cache_diff_and_bytes_diff_hand_counts():
    a = {"m": {"x": 1, "y": 2}, "l": [1, 2, 3]}
    b = {"m": {"x": 1, "y": 3, "z": 0}, "l": [1, 5], "q": [7, 8]}
    # y differs, z extra; one list slot differs and one is missing; q
    # exists on one side (2 rows)
    assert yjs.cache_diff(a, b) == 2 + 2 + 2
    assert yjs.cache_diff(a, a) == 0
    assert yjs.bytes_diff(b"abcd", b"abXdZZ") == 1 + 2


def test_reference_rejects_cross_segment_origins():
    t = {"client": np.array([1, 1]), "clock": np.array([0, 1]),
         "root": np.array([0, 1]), "key": np.array([-1, -1]),
         "oc": np.array([-1, 1]), "ok": np.array([-1, 0]),
         "content": np.array([1, 2]), "roots": ["a", "b"], "keys": []}
    with pytest.raises(ValueError):
        yjs.converge(t, NO_DS)
