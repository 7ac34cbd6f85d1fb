"""The benchmark's frozen generators make the program's generators'
bytes, and its encoder the wire a decode round-trips."""

import numpy as np
import pytest

from benchmark.gen import traces, wire, ycsb
from crdt_tpu_torch.models import traces as port_traces


@pytest.mark.parametrize("R,K,seed", [(3, 40, 0), (10, 100, 5),
                                      (7, 33, 123456789012),
                                      (30, 64, 99)])
def test_build_trace_bytes_equal(R, K, seed):
    assert traces.build_trace(R, K, seed=seed)[0] == \
        port_traces.build_trace(R, K, seed=seed)


def test_build_trace_full_fanin_seed_bytes_equal():
    assert traces.build_trace(1000, 1600, seed=7)[0] == \
        port_traces.build_trace(1000, 1600, seed=7)


def test_encoder_round_trips_through_the_decoder():
    from crdt_tpu_torch.codec import v1

    _, t, ds = traces.build_trace(4, 50, seed=3)
    blob = wire.encode_union(t, *ds)
    recs, dset = v1.decode_update(blob)
    assert len(recs) == 200
    assert {(r.client, r.clock) for r in recs} == \
        set(zip(t["client"].tolist(), t["clock"].tolist()))
    assert dset.ranges == {c: [(s, s + n) for s, n in rs]
                           for c, rs in wire.normalize_ranges(*ds)}


def test_normalize_ranges_merges_overlaps_and_neighbours():
    got = wire.normalize_ranges([2, 2, 2, 5, 2], [4, 5, 9, 1, 10],
                                [1, 2, 1, 3, 1])
    assert got == [(5, [(1, 3)]), (2, [(4, 3), (9, 2)])]


def test_ycsb_records_load_and_update_as_ymap_set_writes_them():
    from crdt_tpu_torch.codec import v1

    r = ycsb.Records(4, 10, 100, np.random.default_rng(8))
    load = r.writes(range(4), True)[0]
    first = wire.encode_updates(load, np.arange(5) * 10, [[]] * 4)
    recs, _ = v1.decode_update(first[2])
    assert [(x.client, x.clock, x.parent_root, x.key, x.origin)
            for x in recs] == [(3, k, "usertable", f"field{k}", None)
                               for k in range(10)]
    assert [x.content for x in recs] == \
        [bytes(v).decode() for v in load["text"][20:30]]
    assert all(len(x.content) == 100 and x.content.isprintable()
               for x in recs)
    up = r.writes([2, 0, 2], False)[0]
    assert up["client"].tolist() == [3, 1, 3]
    assert up["clock"].tolist() == [10, 10, 11]
    blobs = wire.encode_updates(up, np.arange(4), [[]] * 3)
    for row, blob in enumerate(blobs):
        (x,), _ = v1.decode_update(blob)
        f = int(up["key"][row])
        # the origin is the field's current item: its insert, or the
        # update before this one to the same field
        prev = [k for k in range(row) if up["client"][k] == x.client
                and up["key"][k] == f]
        want = int(up["clock"][prev[-1]]) if prev else f
        assert x.origin == (x.client, want) and x.key is None
        assert x.content == bytes(up["text"][row]).decode()
