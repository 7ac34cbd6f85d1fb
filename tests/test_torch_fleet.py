"""The port's replica-fleet round against the reference, on the CPU.

``crdt_tpu_torch.parallel.gossip.make_gossip_step``,
``crdt_tpu_torch.models.fleet`` (``load_trace``, ``ReplicaFleet.step``
and ``delta_round``, ``fleet_replay``) and
``replay_trace(route="fleet")`` held against ``crdt_tpu`` on the same
inputs. The reference runs on a one-device mesh (``make_mesh(1)``):
the tests' eight virtual CPU devices would otherwise send its
``shard="auto"`` to the sharded mapping. Caches, snapshots and every
output field must be identical.
"""

import json

import numpy as np
import pytest
import torch

from crdt_tpu.codec import v1 as ref_v1
from crdt_tpu.models import fleet as ref_fleet
from crdt_tpu.models import replay as ref_rp
from crdt_tpu.parallel import delta as ref_delta
from crdt_tpu.parallel import gossip as ref_gossip
from crdt_tpu_torch import replay_trace
from crdt_tpu_torch.models import fleet
from crdt_tpu_torch.models import traces
from crdt_tpu_torch.obs import Tracer, set_tracer
from crdt_tpu_torch.ops import kernels
from crdt_tpu_torch.ops.device import bucket_pow2
from crdt_tpu_torch.parallel import delta, gossip
from tests.test_fleet_trace import build_round_blobs

TRACES = {
    "trace_8x24": lambda: traces.build_trace(8, 24, seed=0),
    "trace_12x30_seed3": lambda: traces.build_trace(12, 30, seed=3),
    "conflict_8x24": lambda: traces.build_conflict_trace(8, 24),
    "conflict_10x40": lambda: traces.build_conflict_trace(10, 40),
}


@pytest.fixture(scope="module")
def mesh1():
    return ref_gossip.make_mesh(1)


def _cache_json(res):
    return json.dumps(res.cache, sort_keys=True, default=repr)


def _assert_same_replay(got, want):
    assert _cache_json(got) == _cache_json(want)
    assert got.cache == want.cache
    assert got.snapshot == want.snapshot
    assert got.n_ops == want.n_ops


class TestGossipStep:
    @pytest.mark.parametrize("num_lists,seed", [(0, 0), (3, 1), (5, 2)])
    def test_output_vector_matches_reference(self, mesh1, num_lists, seed):
        R, N, S = 6, 40, 512
        cols, dels = ref_gossip.synth_columns(R, N, num_lists=num_lists,
                                              keys_per_map=8, seed=seed)
        rng = np.random.default_rng(seed)
        cols["valid"] &= rng.random((R, N)) < 0.9
        dels = (np.r_[[2, 3, 5], dels[0][3:]].astype(np.int32),
                np.r_[[0, 4, 10], dels[1][3:]].astype(np.int64),
                np.r_[[5, 9, 30], dels[2][3:]].astype(np.int64))
        C = R + 2
        ref_step = ref_gossip.make_gossip_step(mesh1, num_segments=S,
                                               num_clients=C)
        want = np.asarray(ref_step(ref_gossip.pack_cols(cols),
                                   ref_gossip.pack_dels(dels)))
        step = gossip.make_gossip_step(S, C, device="cpu")
        got = step(torch.from_numpy(gossip.pack_cols(cols)),
                   torch.from_numpy(gossip.pack_dels(dels))).numpy()
        assert got.dtype == np.int64 and got.shape == want.shape
        assert (got == want).all()
        assert gossip.fleet_out_sizes(R, N, C, S) == \
            ref_gossip.fleet_out_sizes(R, N, C, S)

    def test_step_rejects_another_device(self):
        step = gossip.make_gossip_step(512, 4, device="cpu")
        with pytest.raises(ValueError, match="built for"):
            step(torch.zeros((9, 1, 4), dtype=torch.int64,
                             device="meta"),
                 torch.zeros((3, 1), dtype=torch.int64))


class TestLoadTrace:
    @pytest.mark.parametrize("name", sorted(TRACES))
    def test_fields_match_reference(self, name):
        blobs = TRACES[name]()
        want = ref_fleet.load_trace(blobs)
        got = fleet.load_trace(blobs)
        assert set(got.cols) == set(want.cols)
        for k, v in want.cols.items():
            assert got.cols[k].dtype == v.dtype, k
            assert (got.cols[k] == v).all(), k
        for g, w in zip(got.dels, want.dels):
            assert g.dtype == w.dtype and (g == w).all()
        assert (got.row_map == want.row_map).all()
        assert (got.clients == want.clients).all()
        assert got.num_clients == want.num_clients
        assert got.num_segments == want.num_segments
        assert got.n_ops == want.n_ops

    def test_padding_and_bucket(self):
        blobs = traces.build_trace(5, 6, seed=1)
        tr = fleet.load_trace(blobs)
        want = ref_fleet.load_trace(blobs)
        rows = (tr.row_map >= 0).sum(axis=1)
        assert tr.row_map.shape == want.row_map.shape
        assert tr.row_map.shape == (5, bucket_pow2(int(rows.max())))
        assert (tr.row_map == want.row_map).all()
        # each replica's rows lead its line; the rest is padding
        for r, k in enumerate(rows):
            assert (tr.row_map[r, :k] >= 0).all()
            assert (tr.row_map[r, k:] == -1).all()


class TestFleetStep:
    @pytest.mark.parametrize("name", ["trace_8x24", "conflict_8x24"])
    def test_fields_match_reference(self, mesh1, name):
        blobs = TRACES[name]()
        tr = ref_fleet.load_trace(blobs)
        want = ref_fleet.fleet_for_trace(tr, mesh=mesh1).step(tr.cols,
                                                              tr.dels)
        ptr = fleet.load_trace(blobs)
        got = fleet.fleet_for_trace(ptr, device="cpu").step(ptr.cols,
                                                            ptr.dels)
        assert got._fields == want._fields
        for f in want._fields:
            g, w = getattr(got, f), np.asarray(getattr(want, f))
            assert g.shape == w.shape and (g == w).all(), f

    def test_synth_round_and_spans(self, mesh1):
        ref = ref_fleet.ReplicaFleet(8, 32, mesh=mesh1)
        cols, dels = ref.synth(num_lists=2, seed=5)
        want = ref.step(cols, dels)
        pf = fleet.ReplicaFleet(8, 32, device="cpu")
        tracer = set_tracer(Tracer(enabled=True))
        try:
            got = pf.step(cols, dels)
        finally:
            set_tracer(Tracer(enabled=False))
        for f in want._fields:
            assert (getattr(got, f) == np.asarray(getattr(want, f))).all(), f
        rep = tracer.report()
        assert "fleet.step" in rep["spans"]
        counters = json.dumps(rep, default=str)
        for label in ("fleet.cols", "fleet.dels", "fleet.out"):
            assert label in counters
        assert kernels.launch_counts()["sv_deficit"] == 0


class TestDeltaRound:
    @pytest.mark.parametrize("budget", [5, 16])  # below / above the deficit
    def test_fields_match_reference(self, mesh1, budget):
        R, shared, fresh = 8, 40, 8
        cols = delta.synth_resident_columns(R, shared, fresh, seed=4)
        assert all((cols[k] == v).all() for k, v in
                   ref_delta.synth_resident_columns(R, shared, fresh,
                                                    seed=4).items())
        ref = ref_fleet.ReplicaFleet(R, shared + fresh, mesh=mesh1)
        want = ref.delta_round(cols, budget=budget)
        got = fleet.ReplicaFleet(R, shared + fresh,
                                 device="cpu").delta_round(cols,
                                                           budget=budget)
        for g, w in zip(got[:3], want[:3]):
            assert g.shape == np.asarray(w).shape
            assert (g == np.asarray(w)).all()
        assert set(got[3]) == set(want[3])
        for k, w in want[3].items():
            w = np.asarray(w)
            assert got[3][k].dtype == w.dtype and (got[3][k] == w).all(), k
        assert (got[2] == fresh).all()
        assert got[3]["valid"].sum() == R * min(budget, fresh)

    def test_budget_past_the_rows_raises(self):
        cols = delta.synth_resident_columns(2, 4, 2)
        with pytest.raises(ValueError, match="budget"):
            fleet.ReplicaFleet(2, 6, device="cpu").delta_round(cols,
                                                               budget=7)


class TestFleetReplay:
    @pytest.mark.parametrize("name", sorted(TRACES))
    def test_matches_reference_and_device_route(self, mesh1, name):
        blobs = TRACES[name]()
        want = ref_fleet.fleet_replay(blobs, mesh=mesh1)
        got = replay_trace(blobs, route="fleet", device="cpu")
        assert got.path == want.path == "fleet"
        _assert_same_replay(got, want)
        _assert_same_replay(got, ref_rp.replay_trace(blobs, route="fleet"))
        _assert_same_replay(got, replay_trace(blobs, device="cpu"))

    def test_redelivered_blobs(self, mesh1):
        blobs = traces.build_conflict_trace(6, 20)
        dup = blobs + [blobs[2], blobs[4], blobs[0]]
        want = ref_fleet.fleet_replay(dup, mesh=mesh1)
        got = fleet.fleet_replay(dup, device="cpu")
        _assert_same_replay(got, want)
        _assert_same_replay(got, ref_rp.replay_trace(dup, route="fleet"))
        assert got.cache == replay_trace(blobs, device="cpu").cache

    @pytest.mark.parametrize("blobs", [
        [], [ref_v1.encode_update([], None)],
    ], ids=["no_blobs", "one_empty_blob"])
    def test_empty_blob_set(self, mesh1, blobs):
        want = ref_fleet.fleet_replay(blobs, mesh=mesh1)
        got = fleet.fleet_replay(blobs, device="cpu")
        _assert_same_replay(got, want)
        _assert_same_replay(got, ref_rp.replay_trace(blobs, route="fleet"))
        assert got.n_ops == 0

    def test_reused_trace_and_fleet(self):
        blobs = traces.build_trace(6, 10, seed=2)
        tr = fleet.load_trace(blobs)
        pf = fleet.fleet_for_trace(tr, device="cpu")
        first = fleet.fleet_replay(blobs, trace=tr, fleet=pf)
        again = fleet.fleet_replay(blobs, trace=tr, fleet=pf)
        _assert_same_replay(again, first)
        small = fleet.ReplicaFleet(2, 512, device="cpu")
        with pytest.raises(ValueError, match="do not fit"):
            fleet.fleet_replay(blobs, trace=tr, fleet=small)


class TestOutsideTheSlice:
    def test_right_bearing_sequence_rows_raise(self, mesh1):
        # mid-inserts carry right origins: both packages re-order their
        # parents through the scalar host YATA
        blobs = build_round_blobs(4, 6, seed=4)
        dec = ref_rp.decode(blobs)
        assert np.any((dec["right_client"] >= 0) & (dec["key_id"] < 0))
        want = ref_fleet.fleet_replay(blobs, mesh=mesh1)
        got = replay_trace(blobs, route="fleet", device="cpu")
        _assert_same_replay(got, want)
        _assert_same_replay(got, replay_trace(blobs, device="cpu"))

    @pytest.mark.parametrize("shard", ["segments", "sharded"])
    def test_multi_device_mappings_raise(self, shard):
        # the multi-device mappings (ROADMAP.md queue A item 9) on a
        # 4-entry CPU mesh: the reference's cache and snapshot on the
        # same trace. The name is the one these mappings had while they
        # raised, kept so the test's history stays one line.
        from crdt_tpu_torch.parallel.gossip import make_mesh

        for blobs in (traces.build_trace(3, 4),
                      traces.build_conflict_trace(8, 24)):
            got = fleet.fleet_replay(blobs, mesh=make_mesh(4, device="cpu"),
                                     shard=shard)
            want = ref_fleet.fleet_replay(
                blobs, mesh=ref_gossip.make_mesh(4), shard=shard)
            _assert_same_replay(got, want)
            assert got.path == want.path

    @pytest.mark.parametrize("route", [
        pytest.param("auto", id="auto-item 5"),
        pytest.param("replica", id="replica-item 5"),
    ])
    def test_unported_routes_raise(self, route):
        # the live replica's routes (ROADMAP.md queue A item 5): the
        # reference's cache and snapshot on the same trace. The name and
        # ids are those these routes had while they raised, kept so the
        # test's history stays one line.
        for blobs in (traces.build_trace(3, 4),
                      traces.build_conflict_trace(8, 24)):
            got = replay_trace(blobs, route=route, device="cpu")
            want = ref_rp.replay_trace(blobs, route=route)
            _assert_same_replay(got, want)
            assert got.path == want.path

    def test_host_route_on_an_inexpressible_plan(self, monkeypatch):
        # a plan past the stager's bounds (2^25 parents, 2^21 keys: too
        # large to build here) goes to the replica engine, as the
        # reference's host route does
        from crdt_tpu_torch.models import replay as rp

        monkeypatch.setattr(rp.staging, "stage", lambda *a, **kw: None)
        blobs = traces.build_conflict_trace(8, 24)
        got = replay_trace(blobs, route="host")
        want = ref_rp.replay_trace(blobs, route="replica")
        _assert_same_replay(got, want)
        assert got.path == "replica"

    def test_default_is_the_card_and_raises_without_one(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        blobs = traces.build_trace(3, 4)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            replay_trace(blobs, route="fleet")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fleet.fleet_replay(blobs)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fleet.ReplicaFleet(4, 8)
