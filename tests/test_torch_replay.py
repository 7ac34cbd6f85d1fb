"""The port's cold replay (crdt_tpu_torch.replay_trace) against the
reference (crdt_tpu.models.replay.replay_trace, route="device"), on
the CPU.

Cache and compacted snapshot must be byte-identical on the
benchmark's own trace shapes (built by the port's copy of the
generators, which must emit the benchmark's exact bytes), the
subtree-split and transfer-diet traces, every Yjs wire fixture (alone
and as one union), and the shapes the packed kernels leave to the
scalar host machinery (hard rows, right-bearing map rows). A union past
the stager's bounds converges on the resident fallback exactly as the
reference's does, and an entry point asked for the card without one
must raise.
"""

import json

import numpy as np
import pytest
import torch

import bench
from crdt_tpu.codec import lib0 as ref_lib0
from crdt_tpu.codec import v1 as ref_v1
from crdt_tpu.codec import native as ref_native
from crdt_tpu.core.ids import DeleteSet
from crdt_tpu.core.records import ItemRecord
from crdt_tpu.models import replay as ref_rp
from crdt_tpu.ops import packed as ref_packed
from crdt_tpu_torch import replay_trace
from crdt_tpu_torch.codec import lib0, native
from crdt_tpu_torch.models import replay as rp
from crdt_tpu_torch.models import traces
from crdt_tpu_torch.obs import Tracer, set_tracer
from tests import test_yjs_fixtures as fx
from tests.test_sort_diet import sort_diet_blobs
from tests.test_subtree_split import conflict_trace
from tests.test_transfer_diet import boundary_blobs


@pytest.fixture(autouse=True)
def _interpret_kernels(monkeypatch):
    monkeypatch.setenv("CRDT_TPU_PALLAS", "interpret")
    monkeypatch.delenv("CRDT_TPU_WIDE_STAGING", raising=False)
    monkeypatch.delenv(ref_packed._CHAIN_SPLIT_ENV, raising=False)


def _as_port_values(v):
    """A reference cache with the reference's ``undefined`` sentinel
    replaced by the port's: each package decodes JS ``undefined`` to its
    own ``lib0.UNDEFINED``."""
    if v is ref_lib0.UNDEFINED:
        return lib0.UNDEFINED
    if isinstance(v, dict):
        return {k: _as_port_values(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_as_port_values(x) for x in v]
    return v


def _has_reference_undefined(v) -> bool:
    if v is ref_lib0.UNDEFINED:
        return True
    if isinstance(v, dict):
        v = list(v.values())
    return isinstance(v, list) and any(map(_has_reference_undefined, v))


def _assert_identical(blobs):
    want = ref_rp.replay_trace(blobs, route="device")
    got = replay_trace(blobs, device="cpu")
    # default=repr: binary payloads (ContentBinary) are bytes
    assert json.dumps(got.cache, sort_keys=True, default=repr) == json.dumps(
        want.cache, sort_keys=True, default=repr)
    assert got.cache == _as_port_values(want.cache)
    assert not _has_reference_undefined(got.cache)
    assert got.snapshot == want.snapshot
    assert got.n_ops == want.n_ops
    return got


def _expressible(blobs) -> bool:
    """Do the packed kernels alone order this union? (no hard rows, no
    right-bearing map rows, inside the stager's bounds)"""
    dec = ref_rp.decode(blobs)
    cols, _ = ref_rp.stage(dec)
    plan = ref_packed.stage(cols)
    map_rights = bool(np.any((dec["right_client"] >= 0)
                             & (dec["key_id"] >= 0)))
    return plan is not None and not plan.hard_rows and not map_rights


class TestTraces:
    @pytest.mark.parametrize("R,K,seed", [(30, 20, 0), (60, 40, 5)])
    def test_build_trace(self, R, K, seed):
        blobs = traces.build_trace(R, K, seed=seed)
        assert blobs == bench.build_trace(R, K, seed=seed)
        _assert_identical(blobs)

    @pytest.mark.parametrize("R,K", [(20, 30), (40, 50)])
    def test_build_conflict_trace(self, R, K):
        blobs = traces.build_conflict_trace(R, K)
        assert blobs == bench.build_conflict_trace(R, K)
        _assert_identical(blobs)

    @pytest.mark.parametrize("R,K", [(12, 30), (20, 40)])
    def test_build_text_trace(self, R, K):
        blobs = traces.build_text_trace(R, K)
        assert blobs == bench.build_text_trace(R, K)
        want = _assert_identical(blobs)
        for route in ("stream", "fleet", "host"):
            got = replay_trace(blobs, route=route, device="cpu")
            assert got.cache == want.cache
            assert got.snapshot == want.snapshot

    @pytest.mark.parametrize("seed", [0, 1])
    def test_subtree_split_traces(self, seed, monkeypatch):
        monkeypatch.setenv(ref_packed._CHAIN_SPLIT_ENV, "13")
        blobs = conflict_trace(seed=seed, rights=False)
        assert _expressible(blobs)
        _assert_identical(blobs)

    def test_mid_inserts_with_rights(self):
        # right-bearing sequence mid-inserts whose attachment groups
        # the stager ranks exactly (no hard segments)
        blobs = boundary_blobs(0)
        assert _expressible(blobs)
        _assert_identical(blobs)

    @pytest.mark.parametrize("base", [(1 << 15) - 8, (1 << 31) - 8])
    def test_clock_ties_at_width_boundaries(self, base):
        blobs = sort_diet_blobs(base, tie=True)
        assert _expressible(blobs)
        _assert_identical(blobs)

    def test_delete_only_and_empty_blobs(self):
        ds = DeleteSet()
        ds.add(1, 3, 4)
        blobs = traces.build_trace(6, 12, seed=2) + [
            ref_v1.encode_update([], ds),
            ref_v1.encode_update([], DeleteSet()),
        ]
        _assert_identical(blobs)

    def test_phase_spans_match_reference_names(self):
        tracer = set_tracer(Tracer(enabled=True))
        try:
            replay_trace(traces.build_trace(10, 10), device="cpu")
        finally:
            set_tracer(Tracer(enabled=False))
        spans = set(tracer.report()["spans"])
        assert {"decode", "pack", "converge.dispatch", "converge.fetch",
                "gather", "materialize", "compact"} <= spans


FIXTURES = {
    name: getattr(fx, name) for name in (
        "FIX_MAP_SET", "FIX_TEXT_GC", "FIX_NESTED", "FIX_ANY_EDGE",
        "FIX_JSON_RUN", "FIX_BINARY", "FIX_EMBED", "FIX_FORMAT",
        "FIX_DOC", "FIX_SKIP_MID",
    )
}


class TestWireFixtures:
    @pytest.mark.parametrize("name", sorted(FIXTURES))
    def test_fixture(self, name):
        _assert_identical([FIXTURES[name]])

    def test_all_fixtures_in_one_union(self):
        _assert_identical(list(FIXTURES.values()))


class TestOutsideTheSlice:
    def test_hard_rows_raise(self):
        # a dangling right origin makes its segment HARD: the scalar
        # integrate orders it on the host, as in the reference
        recs = [
            ItemRecord(client=1, clock=0, parent_root="t", content="a"),
            ItemRecord(client=2, clock=0, parent_root="t", origin=(1, 0),
                       right=(9, 9), content="b"),
        ]
        blobs = [ref_v1.encode_update(recs, DeleteSet())]
        dec = ref_rp.decode(blobs)
        cols, _ = ref_rp.stage(dec)
        assert ref_packed.stage(cols).hard_rows
        _assert_identical(blobs)

    def test_right_bearing_map_rows_raise(self):
        recs = [
            ItemRecord(client=1, clock=0, parent_root="m", key="k",
                       content=1),
            ItemRecord(client=2, clock=0, parent_root="m", key="k",
                       right=(1, 0), content=2),
        ]
        blobs = [ref_v1.encode_update(recs, DeleteSet())]
        dec = ref_rp.decode(blobs)
        assert np.any((dec["right_client"] >= 0) & (dec["key_id"] >= 0))
        _assert_identical(blobs)

    def test_unstageable_union_raises(self):
        # a clock past the 40-bit packing bound: the packed stager
        # refuses it, and both packages answer on their resident
        # fallback (ResidentColumns) with the same kernel outputs
        cols = {
            "client": np.asarray([1], np.int64),
            "clock": np.asarray([1 << 40], np.int64),
            "parent_is_root": np.ones(1, bool),
            "parent_a": np.zeros(1, np.int64),
            "parent_b": np.full(1, -1, np.int64),
            "key_id": np.full(1, -1, np.int64),
            "origin_client": np.full(1, -1, np.int64),
            "origin_clock": np.full(1, -1, np.int64),
            "valid": np.ones(1, bool),
        }
        assert ref_packed.stage(cols) is None
        want = ref_rp.converge(cols)
        got = rp.converge(cols, device="cpu")
        assert want[0] == got[0] == "resident"
        for w_out, g_out in zip(want[1][1:], got[1][1:]):
            for w, g in zip(w_out, g_out):
                assert np.array_equal(np.asarray(w), g.numpy())


class TestDeviceArgument:
    def test_default_is_the_card_and_raises_without_one(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        blobs = traces.build_trace(3, 4)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            replay_trace(blobs)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            replay_trace(blobs, device="cuda")


class TestCodec:
    def test_native_decode_matches_reference(self):
        blobs = traces.build_trace(12, 15, seed=4)
        got = native.dedup_columns(native.decode_updates_columns_any(blobs))
        want = ref_native.dedup_columns(
            ref_native.decode_updates_columns_any(blobs))
        # the port's parse also reports each blob's rows
        assert set(got) == set(want) | {"blob_rows"}
        assert got["blob_rows"].sum() == len(got["client"])
        for k, v in want.items():
            if isinstance(v, np.ndarray):
                assert np.array_equal(got[k], v) and got[k].dtype == v.dtype
            else:
                assert got[k] == v, k

    def test_python_fallback_decode_matches_native(self):
        blobs = boundary_blobs(0) + [fx.FIX_NESTED, fx.FIX_SKIP_MID]
        got = native._decode_py(blobs)
        want = ref_native._decode_py(blobs)
        for k, v in want.items():
            if isinstance(v, np.ndarray):
                assert np.array_equal(got[k], v), k
            else:
                assert got[k] == v, k

    def test_python_encode_fallback_matches_native(self, monkeypatch):
        blobs = traces.build_trace(5, 8)
        dec = native.dedup_columns(native.decode_updates_columns_any(blobs))
        ds = native.ds_from_triples(dec["ds"])
        want = native.encode_from_columns_any(dec, ds)
        monkeypatch.setattr(native, "available", lambda: False)
        assert native.encode_from_columns_any(dec, ds) == want
