"""The port's mesh steps against the reference, on the CPU.

``crdt_tpu_torch.parallel.mesh`` (the mesh and its collectives), the
two-tier gossip step and ``ReplicaFleet`` on a (hosts, replicas) mesh,
the segment-sharded step with ``shard_trace``, ``SegmentedFleet`` and
``fleet_replay(shard="segments")``, the ring delta, ``GossipFaultPlan``
and ``mask_packed``, and ``load_trace``'s ``replicas_multiple`` and
``ops_bucket``, held against ``crdt_tpu`` on the same inputs. The
reference runs on the tests' eight virtual CPU devices, the port on a
mesh whose entries are all ``cpu``. Every output is integer and must be
identical.
"""

import numpy as np
import pytest
import torch

from crdt_tpu.models import fleet as ref_fleet
from crdt_tpu.obs import recorder as ref_recorder
from crdt_tpu.parallel import delta as ref_delta
from crdt_tpu.parallel import gossip as ref_gossip
from crdt_tpu_torch.models import fleet
from crdt_tpu_torch.obs import recorder
from crdt_tpu_torch.ops import shard
from crdt_tpu_torch.parallel import delta, gossip, mesh as mesh_mod
from tests.test_fleet_trace import build_round_blobs, oracle_cache


@pytest.fixture(autouse=True)
def _no_ambient_sharding(monkeypatch):
    monkeypatch.delenv(shard.SHARD_ENV, raising=False)
    monkeypatch.delenv(shard.MIN_ROWS_ENV, raising=False)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _ref_vec(step, cols, dels):
    return np.asarray(step(ref_gossip.pack_cols(cols),
                           ref_gossip.pack_dels(dels)))


def _parts(cols, m):
    """The packed [9, R, N] block cut into one [9, r, N] part an entry."""
    blk = gossip.pack_cols(cols)
    devs = mesh_mod.entries(m)
    r = blk.shape[1] // len(devs)
    return [_t(blk[:, k * r:(k + 1) * r]).to(dev)
            for k, dev in enumerate(devs)]


def _fleet_cols(R, N, num_lists, seed):
    cols, dels = ref_gossip.synth_columns(R, N, num_maps=2, keys_per_map=8,
                                          num_lists=num_lists, seed=seed)
    rng = np.random.default_rng(seed)
    cols["valid"] &= rng.random((R, N)) < 0.9
    dels = (np.r_[[2, 3, 5], dels[0][3:]].astype(np.int32),
            np.r_[[0, 4, 10], dels[1][3:]].astype(np.int64),
            np.r_[[5, 9, 30], dels[2][3:]].astype(np.int64))
    return cols, dels


class TestMesh:
    def test_make_mesh_entries(self):
        m = mesh_mod.make_mesh(4, device="cpu")
        assert m.devices.shape == (4,) and m.devices.size == 4
        assert m.axis_names == ("replicas",)
        assert all(d == torch.device("cpu") for d in m.devices)
        m2 = gossip.make_mesh2d(2, 3, device="cpu")
        assert m2.devices.shape == (2, 3)
        assert m2.axis_names == ("hosts", "replicas")
        assert len(mesh_mod.make_mesh(device="cpu").devices) == 1
        with pytest.raises(ValueError):
            mesh_mod.make_mesh(0, device="cpu")

    def test_make_mesh_raises_without_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        for make in (lambda: mesh_mod.make_mesh(device="cuda"),
                     lambda: mesh_mod.make_mesh(2, device="cuda"),
                     lambda: gossip.make_mesh2d(2, 2),
                     lambda: mesh_mod.mesh_for("cuda"),
                     lambda: mesh_mod.mesh_for("cuda:0"),
                     lambda: fleet.ReplicaFleet(4, 8)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()

    def test_collectives(self):
        m = gossip.make_mesh2d(2, 3, device="cpu")
        parts = [torch.full((2,), k) for k in range(6)]
        flat = mesh_mod.all_gather(parts, torch.device("cpu"))
        assert flat.tolist() == [[k, k] for k in range(6)]
        assert torch.equal(mesh_mod.all_gather2(parts, m), flat)
        ring = [(i, (i + 1) % 6) for i in range(6)]
        got = mesh_mod.ppermute(parts, ring, m)
        assert [int(g[0]) for g in got] == [5, 0, 1, 2, 3, 4]
        # an entry no pair sends to receives zeros, as jax's ppermute
        got = mesh_mod.ppermute(parts, [(0, 1)], m)
        assert [int(g[0]) for g in got] == [0, 0, 0, 0, 0, 0]
        assert [int(b[0]) for b in mesh_mod.broadcast(parts[4], m)] == \
            [4] * 6


class TestHierarchicalStep:
    @pytest.mark.parametrize("num_lists,seed", [(0, 0), (2, 21), (3, 5)])
    def test_matches_flat_and_reference(self, num_lists, seed):
        R, N, S = 16, 24, 256
        C = R + 2
        cols, dels = _fleet_cols(R, N, num_lists, seed)
        want = _ref_vec(ref_gossip.make_hierarchical_gossip_step(
            ref_gossip.make_mesh2d(2, 4), num_segments=S, num_clients=C),
            cols, dels)
        ref_flat = _ref_vec(ref_gossip.make_gossip_step(
            ref_gossip.make_mesh(8), num_segments=S, num_clients=C),
            cols, dels)
        flat = gossip.make_gossip_step(S, C, device="cpu")(
            _t(gossip.pack_cols(cols)), _t(gossip.pack_dels(dels))).numpy()
        for h, d in ((2, 2), (2, 4), (4, 1), (1, 8)):
            m = gossip.make_mesh2d(h, d, device="cpu")
            step = gossip.make_hierarchical_gossip_step(m, S, C)
            got = step(_parts(cols, m), _t(gossip.pack_dels(dels))).numpy()
            assert got.dtype == np.int64 and got.shape == want.shape
            assert (got == want).all(), (h, d)
        assert (flat == want).all() and (ref_flat == want).all()

    def test_rejects_parts_on_the_wrong_entries(self):
        m = gossip.make_mesh2d(2, 2, device="cpu")
        step = gossip.make_hierarchical_gossip_step(m, 64, 6)
        cols, dels = _fleet_cols(4, 8, 0, 1)
        with pytest.raises(ValueError, match="parts for a mesh"):
            step(_parts(cols, m)[:3], _t(gossip.pack_dels(dels)))
        with pytest.raises(ValueError, match="hosts, replicas"):
            gossip.make_hierarchical_gossip_step(
                gossip.make_mesh(4, device="cpu"), 64, 6)

    @pytest.mark.parametrize("kind", ["2x2", "1d4"])
    def test_replica_fleet_on_a_mesh(self, kind):
        R, N = 8, 16
        cols, dels = _fleet_cols(R, N, 2, 7)
        m = (gossip.make_mesh2d(2, 2, device="cpu") if kind == "2x2"
             else gossip.make_mesh(4, device="cpu"))
        got = fleet.ReplicaFleet(R, N, mesh=m).step(cols, dels)
        one = fleet.ReplicaFleet(R, N, device="cpu").step(cols, dels)
        rm = (ref_gossip.make_mesh2d(2, 2) if kind == "2x2"
              else ref_gossip.make_mesh(4))
        want = ref_fleet.ReplicaFleet(R, N, mesh=rm).step(cols, dels)
        for name in want._fields:
            w = np.asarray(getattr(want, name))
            for out in (got, one):
                assert (getattr(out, name) == w).all(), (kind, name)
        with pytest.raises(ValueError, match="divide"):
            fleet.ReplicaFleet(6, N, mesh=m)

    def test_delta_round_needs_a_1d_mesh(self):
        f = fleet.ReplicaFleet(4, 8, mesh=gossip.make_mesh2d(2, 2,
                                                              device="cpu"))
        cols = delta.synth_resident_columns(4, 4, 4)
        with pytest.raises(ValueError, match="1D"):
            f.delta_round(cols, budget=4)

    @pytest.mark.parametrize("seed", [31, 32])
    def test_fleet_replay_replicas_on_a_2d_mesh(self, seed):
        blobs = build_round_blobs(8, 10, seed=seed)
        got = fleet.fleet_replay(
            blobs, mesh=gossip.make_mesh2d(2, 2, device="cpu"),
            shard="replicas")
        want = ref_fleet.fleet_replay(
            blobs, mesh=ref_gossip.make_mesh2d(2, 2), shard="replicas")
        assert got.cache == want.cache == oracle_cache(blobs)
        assert got.snapshot == want.snapshot
        assert got.path == want.path == "fleet"


def _assert_same_sharded_trace(got, want):
    assert set(got.cols) == set(want.cols)
    for k, v in want.cols.items():
        assert got.cols[k].dtype == v.dtype and (got.cols[k] == v).all(), k
    for g, w in zip(got.dels, want.dels):
        assert g.dtype == w.dtype and (g == w).all()
    for f in ("row_map", "svs", "global_sv"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and (a == b).all(), f
    for f in ("n_replicas", "num_clients", "num_segments", "n_devices",
              "n_ops"):
        assert getattr(got, f) == getattr(want, f), f


class TestSegmentStep:
    @pytest.mark.parametrize("nd", [1, 4, 8])
    @pytest.mark.parametrize("seed", [30, 31])
    def test_seg_step_matches_reference(self, nd, seed):
        blobs = build_round_blobs(8, 10, seed=seed)
        tr = fleet.load_trace(blobs)
        sh = fleet.shard_trace(tr, nd)
        rsh = ref_fleet.shard_trace(ref_fleet.load_trace(blobs), nd)
        _assert_same_sharded_trace(sh, rsh)
        got = fleet.SegmentedFleet(
            sh, mesh=gossip.make_mesh(nd, device="cpu")).step(sh)
        want = ref_fleet.SegmentedFleet(
            rsh, mesh=ref_gossip.make_mesh(nd)).step(rsh)
        for name in want._fields:
            w = np.asarray(getattr(want, name))
            g = getattr(got, name)
            assert g.shape == w.shape and (g == w).all(), name
        # the handshake equals the replicated round's
        rep = fleet.ReplicaFleet(tr.n_replicas, tr.ops_per_replica,
                                 device="cpu", num_clients=tr.num_clients,
                                 num_segments=tr.num_segments
                                 ).step(tr.cols, tr.dels)
        R = len(blobs)
        assert (rep.global_sv == got.global_sv).all()
        assert (rep.sv_local[:R] == got.svs[:R]).all()
        assert (rep.deficit[:R, :R] == got.deficit[:R, :R]).all()

    @pytest.mark.parametrize("nd", [1, 4, 8])
    def test_fleet_replay_segments(self, nd):
        blobs = build_round_blobs(8, 10, seed=33 + nd)
        got = fleet.fleet_replay(blobs, mesh=gossip.make_mesh(nd,
                                                              device="cpu"),
                                 shard="segments")
        want = ref_fleet.fleet_replay(blobs, mesh=ref_gossip.make_mesh(nd),
                                      shard="segments")
        assert got.cache == want.cache == oracle_cache(blobs)
        assert got.snapshot == want.snapshot
        assert got.n_ops == want.n_ops and got.path == want.path

    def test_rejects_out_of_bounds_trace(self):
        blobs = build_round_blobs(4, 4, seed=50)
        sh = fleet.shard_trace(fleet.load_trace(blobs), 4)
        sf = fleet.SegmentedFleet(sh, mesh=gossip.make_mesh(4,
                                                            device="cpu"))
        with pytest.raises(ValueError, match="does not fit"):
            sf.step(sh._replace(num_segments=sh.num_segments * 2))
        with pytest.raises(ValueError, match="does not fit"):
            sf.step(sh._replace(n_replicas=sh.n_replicas + 1))
        with pytest.raises(ValueError, match="sharded for"):
            fleet.SegmentedFleet(sh, mesh=gossip.make_mesh(2, device="cpu"))


def _ring_parts(cols, m):
    devs = mesh_mod.entries(m)
    return [[_t(np.asarray(cols[k])[i:i + 1]).to(dev)
             for i, dev in enumerate(devs)] for k in delta.COL_NAMES]


class TestRingDelta:
    @pytest.mark.parametrize("budget", [4, 6, 8])
    @pytest.mark.parametrize("seed", [3, 4])
    def test_matches_reference(self, budget, seed):
        R, shared, fresh = 8, 40, 6
        cols = delta.synth_resident_columns(R, shared, fresh, seed=seed)
        # a replica that already holds its successor's rows ships less
        cols["valid"][2, shared + 3:] = False
        m = gossip.make_mesh(R, device="cpu")
        got = delta.make_ring_delta_step(m, num_clients=R + 2,
                                         budget=budget)(
            *_ring_parts(cols, m))
        want = ref_delta.make_ring_delta_step(
            ref_gossip.make_mesh(R), num_clients=R + 2, budget=budget)(
            *[np.asarray(cols[k]) for k in ref_delta.COL_NAMES])
        assert len(got) == len(want) == 10
        for i, (g, w) in enumerate(zip(got, want)):
            w = np.asarray(w)
            g = g.numpy()
            assert g.shape == w.shape, i
            assert (g.astype(np.int64) == w.astype(np.int64)).all(), i
        sent = got[0].numpy()
        assert sent[2] == 3  # replica 2 holds 3 of its fresh rows
        assert (sent[[0, 1, 3, 4, 5, 6, 7]] == fresh).all()

    def test_rejects_a_budget_past_the_rows(self):
        m = gossip.make_mesh(2, device="cpu")
        cols = delta.synth_resident_columns(2, 2, 2)
        with pytest.raises(ValueError, match="budget"):
            delta.make_ring_delta_step(m, 4, 8)(*_ring_parts(cols, m))


class TestFaultPlan:
    @pytest.mark.parametrize("seed,drop,every,groups", [
        (5, 0.4, 2, 2), (0, 0.0, 0, 2), (11, 0.9, 3, 3)])
    @pytest.mark.parametrize("R", [8, 13])
    def test_decisions_match_reference(self, seed, drop, every, groups, R):
        plan = gossip.GossipFaultPlan(seed, drop=drop,
                                      partition_every=every, groups=groups)
        ref = ref_gossip.GossipFaultPlan(seed, drop=drop,
                                         partition_every=every,
                                         groups=groups)
        for rnd in range(7):
            assert (plan.delivered_mask(rnd, R)
                    == ref.delivered_mask(rnd, R)).all()
            got, want = plan.partition_masks(rnd, R), \
                ref.partition_masks(rnd, R)
            assert (got is None) == (want is None)
            if got is not None:
                assert len(got) == len(want)
                for a, b in zip(got, want):
                    assert (a == b).all()

    def test_recorder_events_match_reference(self):
        mine, theirs = recorder.get_recorder(), ref_recorder.get_recorder()
        recorder.set_recorder(recorder.FlightRecorder(enabled=True))
        ref_recorder.set_recorder(ref_recorder.FlightRecorder(enabled=True))
        try:
            gossip.GossipFaultPlan(5, drop=0.4, partition_every=2
                                   ).partition_masks(2, 8)
            gossip.GossipFaultPlan(5, drop=0.4).delivered_mask(0, 8)
            ref_gossip.GossipFaultPlan(5, drop=0.4, partition_every=2
                                       ).partition_masks(2, 8)
            ref_gossip.GossipFaultPlan(5, drop=0.4).delivered_mask(0, 8)
            got = [(e["kind"], {k: v for k, v in e.items()
                                if k not in ("t", "ts", "seq")})
                   for e in recorder.get_recorder().events()]
            want = [(e["kind"], {k: v for k, v in e.items()
                                 if k not in ("t", "ts", "seq")})
                    for e in ref_recorder.get_recorder().events()]
        finally:
            recorder.set_recorder(mine)
            ref_recorder.set_recorder(theirs)
        assert got == want and len(got) == 2

    @pytest.mark.parametrize("kind", ["flat", "2x2"])
    def test_drop_and_partition_heal_to_fault_free(self, kind):
        R, N = 8, 16
        cols, dels = ref_gossip.synth_columns(R, N, num_maps=2,
                                              keys_per_map=8, num_lists=2,
                                              seed=3)
        packed, dels_p = gossip.pack_cols(cols), gossip.pack_dels(dels)
        S, C = R * N, R + 1
        if kind == "flat":
            step0 = gossip.make_gossip_step(S, C, device="cpu")

            def step(blk):
                return step0(_t(blk), _t(dels_p)).numpy()
        else:
            m = gossip.make_mesh2d(2, 2, device="cpu")
            step1 = gossip.make_hierarchical_gossip_step(m, S, C)

            def step(blk):
                parts = [_t(blk[:, k * 2:(k + 1) * 2]) for k in range(4)]
                return step1(parts, _t(dels_p)).numpy()
        ref_step = ref_gossip.make_gossip_step(
            ref_gossip.make_mesh(1), num_segments=S, num_clients=C)
        reference = step(packed)
        assert (reference == np.asarray(ref_step(packed, dels_p))).all()

        plan = gossip.GossipFaultPlan(seed=5, drop=0.4, partition_every=2,
                                      groups=2)
        keep = plan.delivered_mask(0, R)
        assert 0 < keep.sum() < R
        masked = gossip.mask_packed(packed, keep)
        assert (masked == ref_gossip.mask_packed(packed, keep)).all()
        lossy = step(masked)
        assert not np.array_equal(lossy, reference)
        assert (lossy == np.asarray(ref_step(masked, dels_p))).all()
        masks = plan.partition_masks(2, R)
        assert masks is not None and sum(m.sum() for m in masks) == R
        for msk in masks:
            blk = gossip.mask_packed(packed, msk)
            assert (step(blk) == np.asarray(ref_step(blk, dels_p))).all()
        # heal: the full columns re-presented give the fault-free round
        assert np.array_equal(step(packed), reference)
        assert (packed == gossip.pack_cols(cols)).all()  # untouched
        assert plan.partition_masks(1, R) is None


class TestLoadTraceKnobs:
    @pytest.mark.parametrize("multiple,bucket", [
        (1, None), (4, None), (8, 64), (3, 32)])
    def test_knobs_match_reference(self, multiple, bucket):
        blobs = build_round_blobs(6, 9, seed=60)
        got = fleet.load_trace(blobs, replicas_multiple=multiple,
                               ops_bucket=bucket)
        want = ref_fleet.load_trace(blobs, replicas_multiple=multiple,
                                    ops_bucket=bucket)
        assert got.row_map.shape == want.row_map.shape
        assert got.n_replicas % multiple == 0
        assert (got.row_map == want.row_map).all()
        for k, v in want.cols.items():
            assert got.cols[k].dtype == v.dtype and (got.cols[k] == v).all()
        assert (got.num_clients, got.num_segments, got.n_ops) == \
            (want.num_clients, want.num_segments, want.n_ops)

    def test_ops_bucket_below_a_replica_raises(self):
        blobs = build_round_blobs(4, 9, seed=61)
        with pytest.raises(ValueError, match="ops_bucket"):
            fleet.load_trace(blobs, ops_bucket=2)
        with pytest.raises(ValueError, match="ops_bucket"):
            ref_fleet.load_trace(blobs, ops_bucket=2)

    def test_shared_bucket_serves_two_traces(self):
        b1 = build_round_blobs(8, 8, seed=6)
        b2 = build_round_blobs(8, 8, seed=7)
        t1 = fleet.load_trace(b1, replicas_multiple=4, ops_bucket=64)
        t2 = fleet.load_trace(b2, replicas_multiple=4, ops_bucket=64)
        f = fleet.fleet_for_trace(t1, mesh=gossip.make_mesh(4,
                                                            device="cpu"))
        for blobs, tr in ((b1, t1), (b2, t2)):
            if tr.num_clients <= f.num_clients and \
                    tr.num_segments <= f.num_segments:
                out = fleet.fleet_replay(blobs, trace=tr, fleet=f)
                assert out.cache == oracle_cache(blobs)
