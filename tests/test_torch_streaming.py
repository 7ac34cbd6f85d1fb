"""The port's streaming replay (crdt_tpu_torch.models.streaming) and
host route against the reference, on the CPU.

``stream_replay(device="cpu")`` must give the reference's cache and
snapshot bytes — the reference's own ``stream_replay`` and its one-shot
``replay_trace(route="device")`` — on ``tests/test_streaming.py``'s
blob sets, over a chunk-size x shard-count matrix with
``min_shard_rows=1`` (every shard count reachable at test sizes);
``partition_shards`` and the decode merge must equal the reference's
field by field; and the grand differential's random traces must agree
through the port's device, stream and host routes.
"""

import json

import numpy as np
import pytest
import torch

from crdt_tpu.codec import native as ref_native
from crdt_tpu.codec import v1 as ref_v1
from crdt_tpu.core.ids import DeleteSet
from crdt_tpu.core.records import ItemRecord
from crdt_tpu.models import replay as ref_rp
from crdt_tpu.models import streaming as ref_sm
from crdt_tpu.ops import packed as ref_packed
from crdt_tpu_torch import replay_trace
from crdt_tpu_torch.codec import native
from crdt_tpu_torch.models import stream_replay
from crdt_tpu_torch.models import streaming as sm
from crdt_tpu_torch.obs import TickTimeline, set_timeline
from crdt_tpu_torch.ops import packed
from tests.test_grand_differential import _random_trace
from tests.test_streaming import mixed_blobs, nested_blobs, text_blobs

PHASE_KEYS = ("decode", "merge", "columns", "partition", "pack",
              "converge", "converge_wait", "gather", "materialize",
              "compact", "busy_sum_s", "wall_s", "wall_vs_phases",
              "overlap_efficiency", "longest_stage_s")

BLOB_SETS = {
    "mixed": mixed_blobs,
    "text": text_blobs,
    "nested": nested_blobs,
}


@pytest.fixture(autouse=True)
def _interpret_kernels(monkeypatch):
    monkeypatch.setenv("CRDT_TPU_PALLAS", "interpret")
    monkeypatch.delenv("CRDT_TPU_WIDE_STAGING", raising=False)
    monkeypatch.delenv(ref_packed._CHAIN_SPLIT_ENV, raising=False)


@pytest.fixture(scope="module")
def one_shot():
    """The reference's one-shot device route, once per blob set."""
    return {name: ref_rp.replay_trace(build(), route="device")
            for name, build in BLOB_SETS.items()}


def _same(got, want):
    assert json.dumps(got.cache, sort_keys=True, default=repr) == \
        json.dumps(want.cache, sort_keys=True, default=repr)
    assert got.cache == want.cache
    assert got.snapshot == want.snapshot
    assert got.n_ops == want.n_ops


class TestStreamDifferential:
    @pytest.mark.parametrize("name", sorted(BLOB_SETS))
    @pytest.mark.parametrize("chunk", [1, 3, None])
    def test_chunk_shard_matrix(self, one_shot, name, chunk):
        blobs = BLOB_SETS[name]()
        for shards in (1, 2, 3):
            got = stream_replay(blobs, chunk_blobs=chunk, max_shards=shards,
                                min_shard_rows=1, device="cpu")
            _same(got, one_shot[name])
            assert got.path == "stream"

    @pytest.mark.parametrize("name", sorted(BLOB_SETS))
    def test_equals_reference_stream(self, name):
        blobs = BLOB_SETS[name]()
        want_ph: dict = {}
        want = ref_sm.stream_replay(blobs, chunk_blobs=2, max_shards=3,
                                    min_shard_rows=1, phases=want_ph)
        ph: dict = {}
        got = stream_replay(blobs, chunk_blobs=2, max_shards=3,
                            min_shard_rows=1, phases=ph, device="cpu")
        _same(got, want)
        assert got.path == want.path == "stream"
        assert set(ph) == set(want_ph)

    def test_phase_keys(self):
        ph: dict = {}
        stream_replay(mixed_blobs(R=10, K=16, seed=9), chunk_blobs=3,
                      max_shards=3, min_shard_rows=1, phases=ph,
                      device="cpu")
        assert set(ph) == set(PHASE_KEYS)
        assert ph["busy_sum_s"] > 0
        assert 0.0 <= ph["overlap_efficiency"] <= 1.0
        assert ph["wall_vs_phases"] > 0

    def test_crafted_map_rights_and_redelivery(self):
        blobs = mixed_blobs(R=6, K=10, seed=21)
        recs = [
            ItemRecord(client=101, clock=0, parent_root="m0", key="kx",
                       content="A"),
            ItemRecord(client=102, clock=0, parent_root="m0", key="kx",
                       right=(101, 0), content="B"),
        ]
        blobs = blobs + [ref_v1.encode_update(recs, DeleteSet())]
        blobs = blobs + blobs[:3]
        want = ref_rp.replay_trace(blobs, route="device")
        for chunk in (1, 4):
            _same(stream_replay(blobs, chunk_blobs=chunk, max_shards=3,
                                min_shard_rows=1, device="cpu"), want)

    def test_empty_and_deletes_only_streams(self):
        _same(stream_replay([], device="cpu"),
              ref_rp.replay_trace([], route="device"))
        ds = DeleteSet()
        ds.add(2, 0, 5)
        only = [ref_v1.encode_update([], ds)] * 2
        _same(stream_replay(only, chunk_blobs=1, min_shard_rows=1,
                            device="cpu"),
              ref_rp.replay_trace(only, route="device"))

    def test_timeline_records_one_tick_per_replay(self):
        tl = set_timeline(TickTimeline(enabled=True))
        try:
            stream_replay(mixed_blobs(R=6, K=10, seed=3), max_shards=2,
                          min_shard_rows=1, device="cpu")
        finally:
            set_timeline(TickTimeline(enabled=False))
        (rec,) = tl.records()
        assert rec["label"] == "stream"
        assert len(rec["dispatches"]) == 2
        assert "dispatch" in rec["lanes"] and "decode" in rec["lanes"]


class TestPipelineFaults:
    def test_stager_error_reaches_the_caller(self, monkeypatch):
        def broken(plan, *, device):
            raise RuntimeError("converge failed on purpose")

        monkeypatch.setattr(packed, "converge_async", broken)
        with pytest.raises(RuntimeError, match="on purpose"):
            stream_replay(mixed_blobs(R=6, K=10), max_shards=2,
                          min_shard_rows=1, device="cpu")

    def test_consumer_error_leaves_no_stager_behind(self, monkeypatch):
        calls = []

        def broken(*a, **kw):
            calls.append(1)
            raise ValueError("gather failed on purpose")

        monkeypatch.setattr(sm.rp, "visible_mask", broken)
        with pytest.raises(ValueError, match="on purpose"):
            stream_replay(mixed_blobs(R=8, K=12), max_shards=3,
                          min_shard_rows=1, device="cpu")
        assert calls == [1]

    def test_unstageable_shard_raises(self, monkeypatch):
        # a shard past the packed stager's bounds (2^25 parents, 2^21
        # keys: too large to build here, so the stager is made to
        # refuse): both packages take the one-shot resident fallback
        blobs = mixed_blobs(R=6, K=10)
        monkeypatch.setattr(ref_packed, "stage", lambda *a, **kw: None)
        want = ref_sm.stream_replay(blobs, max_shards=2, min_shard_rows=1)
        monkeypatch.setattr(sm.staging, "stage", lambda *a, **kw: None)
        phases = {}
        got = stream_replay(blobs, max_shards=2, min_shard_rows=1,
                            phases=phases, device="cpu")
        assert got.path == want.path == "stream-fallback"
        assert phases["fallback"] is True
        assert got.cache == want.cache and got.snapshot == want.snapshot

    def test_default_is_the_card_and_raises_without_one(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            stream_replay(mixed_blobs(R=3, K=4))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            replay_trace(mixed_blobs(R=3, K=4), route="stream")


class TestPartitionAndMerge:
    @pytest.mark.parametrize("name,shards", [
        ("mixed", 3), ("text", 2), ("nested", 4),
    ])
    def test_partition_shards_field_by_field(self, name, shards):
        dec = ref_rp.decode(BLOB_SETS[name]())
        cols, _ = ref_rp.stage(dec)
        want_rows, want_seg, want_hard = ref_sm.partition_shards(cols,
                                                                 shards)
        got_rows, got_seg, got_hard = sm.partition_shards(cols, shards)
        assert len(got_rows) == len(want_rows)
        for a, b in zip(got_rows, want_rows):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got_seg, want_seg)
        assert got_hard == want_hard

    def test_cross_segment_origin_marks_extra_hard_rows(self):
        # a right-bearing sequence row whose origin lies in another
        # segment (columns edited after staging: the wire derives a
        # parent from the origin, so decoded blobs rarely show this)
        dec = ref_rp.decode(text_blobs())
        cols, _ = ref_rp.stage(dec)
        cols = {k: v.copy() for k, v in cols.items()}
        row = int(np.flatnonzero((cols["right_client"] >= 0)
                                 & (cols["origin_client"] >= 0))[0])
        cols["parent_a"][row] += 1
        got = sm.partition_shards(cols, 2)
        want = ref_sm.partition_shards(cols, 2)
        assert got[2] and got[2] == want[2]
        for a, b in zip(got[0], want[0]):
            np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("seed", [7, 8])
    def test_merge_decoded_equals_reference(self, seed):
        blobs = mixed_blobs(R=10, K=14, seed=seed)
        chunks = [blobs[i:i + 3] for i in range(0, len(blobs), 3)]
        got = native.merge_decoded(
            [native.decode_updates_columns_any(c) for c in chunks])
        want = ref_native.merge_decoded(
            [ref_native.decode_updates_columns_any(c) for c in chunks])
        for k in native._COLUMN_KEYS:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for k in ("roots", "keys", "contents"):
            assert got[k] == want[k]
        np.testing.assert_array_equal(got["ds"], want["ds"])
        # and the merged union is the one-shot decode, once deduped
        one = ref_rp.decode(blobs)
        dedup = native.dedup_columns(got)
        for k in native._COLUMN_KEYS:
            np.testing.assert_array_equal(dedup[k], one[k], err_msg=k)

    def test_id_lookup_equals_reference(self):
        rng = np.random.default_rng(5)
        client = rng.integers(0, 1 << 31, 200)
        clock = rng.integers(0, 1 << 40, 200)
        client[50:60] = client[:10]   # duplicate ids: first row wins
        clock[50:60] = clock[:10]
        qc = np.r_[client[::3], [-1, 7, 1 << 31]]
        qk = np.r_[clock[::3], [0, 3, 5]]
        got = native.id_lookup(native.id_index(client, clock), qc, qk)
        want = ref_native.id_lookup(ref_native.id_index(client, clock),
                                    qc, qk)
        np.testing.assert_array_equal(got, want)


class TestRoutes:
    @pytest.mark.parametrize("route", ["host", "stream"])
    def test_route_through_replay_trace(self, route):
        blobs = mixed_blobs(R=6, K=10, seed=12)
        want = ref_rp.replay_trace(blobs, route=route)
        got = replay_trace(blobs, route=route, device="cpu")
        _same(got, want)
        assert got.path == want.path == route

    def test_host_route_runs_on_the_cpu_whatever_the_device(
            self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        blobs = text_blobs()
        got = replay_trace(blobs, route="host")  # device left at "cuda"
        _same(got, ref_rp.replay_trace(blobs, route="host"))

    @pytest.mark.parametrize("seed", range(6))
    def test_grand_differential_traces(self, seed):
        blobs = _random_trace(seed)
        want = ref_rp.replay_trace(blobs, route="device")
        for route in ("device", "stream", "host"):
            got = replay_trace(blobs, route=route, device="cpu")
            _same(got, want)
            assert got.path == route
        _same(stream_replay(blobs, chunk_blobs=3, max_shards=3,
                            min_shard_rows=1, device="cpu"), want)
