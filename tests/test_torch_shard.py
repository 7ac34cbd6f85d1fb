"""The port's sharded converge against the reference, on the CPU.

``crdt_tpu_torch.ops.shard`` (partition, per-shard staging through the
stager's ``_sections`` seam, the common-bucket encode, the mesh step
and the boundary exchange) and every route that takes it
(``replay_trace``, the stream route, ``fleet_replay(shard="sharded")``,
``MultiDocServer(shards=...)``) held against ``crdt_tpu`` on the same
inputs. The reference runs on the tests' eight virtual CPU devices, the
port on a K-entry ``cpu`` mesh. Everything here is integer: plans,
results, caches, snapshots and digests must be identical.
"""

import numpy as np
import pytest

from crdt_tpu.codec import v1
from crdt_tpu.core.ids import DeleteSet
from crdt_tpu.core.records import ItemRecord
from crdt_tpu.models import fleet as ref_fleet
from crdt_tpu.models import replay as ref_rp
from crdt_tpu.models import streaming as ref_streaming
from crdt_tpu.models.multidoc import MultiDocServer as RefServer
from crdt_tpu.ops import shard as ref_shard
from crdt_tpu.parallel import gossip as ref_gossip
from crdt_tpu_torch.models import fleet, streaming
from crdt_tpu_torch.models import replay as rp
from crdt_tpu_torch.models.multidoc import MultiDocServer
from crdt_tpu_torch.obs import Tracer, get_tracer, set_tracer
from crdt_tpu_torch.ops import kernels, packed, shard, staging
from crdt_tpu_torch.parallel import gossip
from tests.test_multidoc import doc_blobs
from tests.test_pooled import delta_blobs
from tests.test_shard import chains_trace
from tests.test_subtree_split import conflict_trace


@pytest.fixture(autouse=True)
def _no_ambient_sharding(monkeypatch):
    # the port reads the reference's env names; each test opts in
    for name in (shard.SHARD_ENV, shard.MIN_ROWS_ENV,
                 staging._CHAIN_SPLIT_ENV, "CRDT_TPU_WIDE_STAGING"):
        monkeypatch.delenv(name, raising=False)


def _both(blobs):
    dec = rp.decode(blobs)
    cols, ds = rp.stage(dec)
    rdec = ref_rp.decode(blobs)
    rcols, rds = ref_rp.stage(rdec)
    return (dec, cols, ds), (rdec, rcols, rds)


def _same(a, b, what):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert np.array_equal(a, b), what
    else:
        assert a == b, what


def _assert_same_plan(got, want):
    assert got._fields == want._fields
    for f in got._fields:
        x, y = getattr(got, f), getattr(want, f)
        if f == "plans":
            assert len(x) == len(y)
            for k, (p, q) in enumerate(zip(x, y)):
                assert p._fields == q._fields
                for g in p._fields:
                    u, v = getattr(p, g), getattr(q, g)
                    if u is None or v is None:
                        assert u is None and v is None, (k, g)
                    else:
                        _same(u, v, (k, g))
        elif f == "row_maps":
            assert len(x) == len(y)
            for k, (p, q) in enumerate(zip(x, y)):
                _same(p, q, ("row_maps", k))
        else:
            _same(x, y, f)


def _assert_same_result(got, want):
    assert got._fields == want._fields
    for f in got._fields:
        _same(getattr(got, f), getattr(want, f), f)


def _sharded_both(port, ref, K):
    """Stage and converge one union through both packages' sharded
    route at K shards; returns (port plan, port result, port cache,
    reference cache), asserting plan and result field by field."""
    dec, cols, ds = port
    rdec, rcols, rds = ref
    splan = shard.stage(cols, n_shards=K, device="cpu")
    rplan = ref_shard.stage(rcols, n_shards=K)
    assert splan is not None and rplan is not None, K
    _assert_same_plan(splan, rplan)
    res = shard.converge(splan, device="cpu")
    rres = ref_shard.converge(rplan)
    _assert_same_result(res, rres)
    w, v, o = rp.gather(dec, ds, ("packed", res), device="cpu")
    got = rp.materialize(dec, ds, w, v, o)
    w, v, o = ref_rp.gather(rdec, rds, ("packed", rres))
    want = ref_rp.materialize(rdec, rds, w, v, o)
    assert got == want, K
    return splan, res, got


def _single(port):
    dec, cols, ds = port
    res = packed.converge(staging.stage(cols), device="cpu")
    w, v, o = rp.gather(dec, ds, ("packed", res), device="cpu")
    return rp.materialize(dec, ds, w, v, o)


def _straddle_blobs():
    recs = []
    prev = None
    for k in range(900):  # the giant: one list, one chain
        recs.append(ItemRecord(
            client=1, clock=k, parent_root="big",
            origin=(1, prev) if prev is not None else None, content=k,
        ))
        prev = k
    for k in range(120):  # 40 tiny segments
        recs.append(ItemRecord(client=1, clock=900 + k,
                               parent_root=f"s{k % 40}", content=k))
    return [v1.encode_update(recs, DeleteSet())]


def _few_segments_blobs():
    recs = [ItemRecord(client=1, clock=k, parent_root="only",
                       origin=(1, k - 1) if k else None, content=k)
            for k in range(64)]
    recs += [ItemRecord(client=2, clock=k, parent_root="m",
                        key=f"k{k % 3}", content=k) for k in range(16)]
    return [v1.encode_update(recs, DeleteSet())]


def _delete_tail_blobs():
    blobs = chains_trace(n_chains=4, chain_len=40, seed=3)
    ds_only = DeleteSet()
    for k in range(5):
        ds_only.add(1, k)
    return blobs + [v1.encode_update([], ds_only)]


def _dominating_chain_blobs():
    """One list of 4,600 chained appends over two clients (a sequence
    segment past max(2048, rows / K): the cross-shard pre-cut spreads
    its DFS-suffix pieces) beside maps and small lists."""
    recs = []
    prev = None
    for k in range(4600):
        c = 1 + (k // 50) % 2
        clock = k
        recs.append(ItemRecord(
            client=c, clock=clock, parent_root="hot",
            origin=prev, content=k,
        ))
        prev = (c, clock)
    for k in range(200):
        recs.append(ItemRecord(client=3, clock=k, parent_root=f"m{k % 4}",
                               key=f"k{k % 9}", content=k))
        recs.append(ItemRecord(client=4, clock=k, parent_root=f"s{k % 7}",
                               content=k))
    return [v1.encode_update(recs, DeleteSet())]


UNIONS = {
    "chains": lambda: chains_trace(seed=1),
    "boundary_straddling": _straddle_blobs,
    "empty_shards": _few_segments_blobs,
    "delete_only_tail": _delete_tail_blobs,
    "right_origins": lambda: chains_trace(n_chains=6, chain_len=60,
                                          rights=True, seed=4),
    "conflict_fuzz_3": lambda: conflict_trace(seed=3),
    "conflict_fuzz_4": lambda: conflict_trace(seed=4),
}


class TestShardPlanAndResult:
    @pytest.mark.parametrize("K", [2, 4, 8])
    @pytest.mark.parametrize("name", sorted(UNIONS))
    def test_plan_result_cache_match_reference(self, name, K):
        port, ref = _both(UNIONS[name]())
        _, res, got = _sharded_both(port, ref, K)
        assert got == _single(port), (name, K)
        # the boundary exchange's merged vector is the host truth
        cols = port[1]
        valid = np.asarray(cols["valid"], bool)
        cl = np.asarray(cols["client"])[valid]
        ck = np.asarray(cols["clock"])[valid]
        for i, c in enumerate(res.sv_clients):
            assert res.global_sv[i] == ck[cl == c].max() + 1

    def test_empty_shards_are_empty_plans(self):
        port, ref = _both(_few_segments_blobs())
        splan, _, _ = _sharded_both(port, ref, 8)
        empty = [k for k, rm in enumerate(splan.row_maps) if not len(rm)]
        assert empty, "fewer segments than shards leaves shards empty"
        for k in empty:
            assert splan.plans[k].n == 0
            assert (splan.sv_host[k] == 0).all()

    def test_fully_delete_only_union_refuses_in_both(self):
        ds_only = DeleteSet()
        for k in range(5):
            ds_only.add(1, k)
        port, ref = _both([v1.encode_update([], ds_only)])
        assert shard.stage(port[1], n_shards=4, device="cpu") is None
        assert ref_shard.stage(ref[1], n_shards=4) is None

    def test_duplicate_ids_across_segments_dedup_globally(self):
        n = 64
        cols = {
            "client": np.full(n, 7, np.int64),
            "clock": np.arange(n, dtype=np.int64) % (n // 2),
            "parent_is_root": np.ones(n, bool),
            # the second half repeats the first half's ids under
            # another root: another segment, another shard
            "parent_a": np.r_[np.zeros(n // 2, np.int64),
                              np.ones(n // 2, np.int64)],
            "parent_b": np.full(n, -1, np.int64),
            "key_id": np.full(n, -1, np.int64),
            "origin_client": np.full(n, -1, np.int64),
            "origin_clock": np.full(n, -1, np.int64),
            "valid": np.ones(n, bool),
        }
        parts, tag = shard._partition(cols, 2)
        rparts, rtag = ref_shard._partition(cols, 2)
        assert tag is None and rtag is None
        for a, b in zip(parts, rparts):
            assert np.array_equal(a, b)
        assert sum(len(p) for p in parts) == n // 2
        splan = shard.stage(cols, n_shards=2, device="cpu")
        _assert_same_plan(splan, ref_shard.stage(cols, n_shards=2))
        got = shard.converge(splan, device="cpu")
        want = packed.converge(staging.stage(cols), device="cpu")
        assert np.array_equal(np.sort(got.stream_row[got.stream_row >= 0]),
                              np.sort(want.stream_row[want.stream_row >= 0]))


def _wide_clock_cols(offset: int, n: int = 96):
    """Map and list rows of three clients whose clocks start at
    ``offset``: the boundary wire's narrow modes switch on the largest
    clock + 1."""
    client = np.repeat(np.arange(1, 4, dtype=np.int64), n // 3)
    clock = offset + np.tile(np.arange(n // 3, dtype=np.int64), 3)
    kid = np.where(np.arange(n) % 2 == 0, np.arange(n) % 5, -1)
    oc = np.full(n, -1, np.int64)
    ock = np.full(n, -1, np.int64)
    seq = kid < 0
    # each client's list rows chain onto that client's previous one
    for c in range(1, 4):
        rows = np.flatnonzero(seq & (client == c))
        oc[rows[1:]] = c
        ock[rows[1:]] = clock[rows[:-1]]
    return {
        "client": client,
        "clock": clock,
        "parent_is_root": np.ones(n, bool),
        "parent_a": (np.arange(n) % 4).astype(np.int64),
        "parent_b": np.full(n, -1, np.int64),
        "key_id": kid.astype(np.int64),
        "origin_client": oc,
        "origin_clock": ock,
        "valid": np.ones(n, bool),
    }


class TestWireModes:
    @pytest.mark.parametrize("offset,mode", [
        (0, "i16"), ((1 << 15) + 3, "hilo"), ((1 << 31) + 5, "wide"),
    ])
    @pytest.mark.parametrize("K", [2, 4])
    def test_wire_mode_and_exchange_match_reference(self, offset, mode, K):
        cols = _wide_clock_cols(offset)
        splan = shard.stage(cols, n_shards=K, device="cpu")
        rplan = ref_shard.stage(cols, n_shards=K)
        assert splan.sv_mode == mode
        _assert_same_plan(splan, rplan)
        res = shard.converge(splan, device="cpu")
        _assert_same_result(res, ref_shard.converge(rplan))
        assert np.array_equal(res.global_sv, splan.sv_host.max(axis=0))

    def test_wide_staging_env(self, monkeypatch):
        monkeypatch.setenv("CRDT_TPU_WIDE_STAGING", "1")
        port, ref = _both(chains_trace(n_chains=4, chain_len=40, seed=12))
        splan, _, _ = _sharded_both(port, ref, 4)
        assert splan.sv_mode == "wide"
        assert set(splan.encs) == {"i32"}


class TestBoundaryAudit:
    def test_corrupted_wire_fails_loudly(self):
        port, _ = _both(chains_trace(n_chains=4, chain_len=30, seed=11))
        splan = shard.stage(port[1], n_shards=2, device="cpu")
        bad_wire = np.array(splan.wire, copy=True)
        # bump the dominating entry of client 0 (a non-max one would be
        # masked by the max-merge)
        bad_wire[int(np.argmax(bad_wire[:, 0])), 0] += 1
        with pytest.raises(RuntimeError, match="boundary exchange"):
            shard.converge(splan._replace(wire=bad_wire), device="cpu")

    def test_hilo_widens_before_the_shift(self):
        # a clock whose low half biases negative: an int16 shift would
        # lose it, the int64 widening keeps it
        cols = _wide_clock_cols((1 << 20) + 0x7FF0)
        splan = shard.stage(cols, n_shards=2, device="cpu")
        assert splan.sv_mode == "hilo"
        res = shard.converge(splan, device="cpu")
        assert np.array_equal(res.global_sv, splan.sv_host.max(axis=0))


def _three_segments(n=128):
    """Three equal-row segments: one deep append chain (client 1, every
    row chained to its predecessor) and two wide root-attached ones
    (clients 2 and 3, no origins) — tests/test_shard.py's shape."""
    total = 3 * n
    oc = np.full(total, -1, np.int64)
    ock = np.full(total, -1, np.int64)
    oc[1:n] = 1
    ock[1:n] = np.arange(n - 1)
    return {
        "client": np.repeat(np.arange(1, 4, dtype=np.int64), n),
        "clock": np.tile(np.arange(n, dtype=np.int64), 3),
        "parent_is_root": np.ones(total, bool),
        "parent_a": np.repeat(np.arange(3, dtype=np.int64), n),
        "parent_b": np.full(total, -1, np.int64),
        "key_id": np.full(total, -1, np.int64),
        "origin_client": oc,
        "origin_clock": ock,
        "valid": np.ones(total, bool),
    }


class TestPartition:
    def test_depth_weighted_cut_matches_reference(self):
        cols = _three_segments(128)
        parts, tag = shard._partition(cols, 2)
        rparts, rtag = ref_shard._partition(cols, 2)
        assert tag is None and rtag is None
        for a, b in zip(parts, rparts):
            assert np.array_equal(a, b)
        # the deep chain alone on its shard, the two wide ones paired
        by_client = [set(np.asarray(cols["client"])[r].tolist())
                     for r in parts]
        assert {1} in by_client and {2, 3} in by_client
        splan = shard.stage(cols, n_shards=2, device="cpu")
        _assert_same_plan(splan, ref_shard.stage(cols, n_shards=2))

    def test_chain_weights(self):
        counts = np.asarray([128, 128, 7, 1])
        origins = np.asarray([127, 0, 6, 0])
        assert shard._chain_weights(counts, origins).tolist() == \
            ref_shard._chain_weights(counts, origins).tolist() == \
            [128 * 7, 128, 7 * 3, 1]

    @pytest.mark.parametrize("K", [2, 4])
    def test_cross_shard_precut(self, K):
        port, ref = _both(_dominating_chain_blobs())
        parts, tag = shard._partition(port[1], K)
        rparts, rtag = ref_shard._partition(ref[1], K)
        assert tag is not None and np.array_equal(tag, rtag)
        for a, b in zip(parts, rparts):
            assert np.array_equal(a, b)
        # the hot list's pieces spread over more than one shard
        hot = np.flatnonzero(tag)
        assert sum(bool(np.isin(hot, p).any()) for p in parts) > 1
        # the tags ride a copy: the caller's parent_b is untouched
        before = np.array(port[1]["parent_b"], copy=True)
        _, _, got = _sharded_both(port, ref, K)
        assert np.array_equal(port[1]["parent_b"], before)
        assert got == _single(port)

    @pytest.mark.parametrize("width", ["1", "63", "256"])
    def test_chain_split_seams(self, width, monkeypatch):
        port, ref = _both(chains_trace(n_chains=3, chain_len=257, seed=6))
        monkeypatch.setenv(staging._CHAIN_SPLIT_ENV, "0")
        want = _single(port)
        monkeypatch.setenv(staging._CHAIN_SPLIT_ENV, width)
        _, _, got = _sharded_both(port, ref, 4)
        assert got == want


class TestCounters:
    def test_shard_counters_live(self):
        port, _ = _both(chains_trace(n_chains=4, chain_len=40, seed=10))
        prev = get_tracer()
        tracer = set_tracer(Tracer(enabled=True))
        try:
            shard.converge(shard.stage(port[1], n_shards=2, device="cpu"),
                           device="cpu")
            counters = tracer.counters()
            gauges = tracer.report()["gauges"]
        finally:
            set_tracer(prev)
        assert counters.get("shard.dispatches") == 1
        assert counters.get("shard.boundary_bytes", 0) > 0
        assert gauges.get("shard.shards") == 2
        assert any(k.startswith("xfer.h2d_bytes_by") for k in counters)

    def test_one_launch_sequence_a_shard(self, monkeypatch):
        # on the CPU the wrappers run their plain versions; count the
        # calls the fused body makes instead
        calls = {"seg_argmax_scan": 0, "stream_scatter": 0}
        for name in calls:
            real = getattr(packed, name)

            def spy(*a, _real=real, _name=name):
                calls[_name] += 1
                return _real(*a)
            monkeypatch.setattr(packed, name, spy)
        port, _ = _both(chains_trace(seed=1))
        kernels.reset_launches()
        shard.converge(shard.stage(port[1], n_shards=4, device="cpu"),
                       device="cpu")
        assert calls == {"seg_argmax_scan": 4, "stream_scatter": 4}
        assert not any(kernels.launch_counts().values())

    def test_default_count_is_one_a_cpu(self):
        assert shard.shard_count(device="cpu") == 1
        assert not shard.active_for(1 << 20, device="cpu")
        assert shard.shard_count(3, device="cpu") == 3


def _route_env(monkeypatch, k=4):
    for name in (shard.SHARD_ENV,):
        monkeypatch.setenv(name, str(k))
    monkeypatch.setenv(shard.MIN_ROWS_ENV, "1")


def _count_dispatches(run):
    prev = get_tracer()
    tracer = set_tracer(Tracer(enabled=True))
    try:
        out = run()
        n = tracer.counters().get("shard.dispatches", 0)
    finally:
        set_tracer(prev)
    return out, n


class TestRoutes:
    @pytest.mark.parametrize("seed", [2, 13])
    def test_replay_trace_sharded(self, seed, monkeypatch):
        blobs = chains_trace(n_chains=8, chain_len=80, seed=seed)
        base = rp.replay_trace(blobs, device="cpu")
        _route_env(monkeypatch)
        got, n = _count_dispatches(
            lambda: rp.replay_trace(blobs, device="cpu"))
        want = ref_rp.replay_trace(blobs)
        assert n == 1
        assert got.cache == want.cache == base.cache
        assert got.snapshot == want.snapshot == base.snapshot

    def test_stream_route_sharded(self, monkeypatch):
        blobs = chains_trace(n_chains=10, chain_len=100, seed=8)
        kw = dict(chunk_blobs=3, max_shards=3, min_shard_rows=1)
        base = streaming.stream_replay(blobs, device="cpu", **kw)
        _route_env(monkeypatch)
        got, n = _count_dispatches(
            lambda: streaming.stream_replay(blobs, device="cpu", **kw))
        want = ref_streaming.stream_replay(blobs, **kw)
        assert n >= 2 and got.path == want.path == "stream"
        assert got.cache == want.cache == base.cache
        assert got.snapshot == want.snapshot == base.snapshot

    @pytest.mark.parametrize("K", [2, 8])
    def test_fleet_replay_sharded(self, K):
        blobs = chains_trace(n_chains=8, chain_len=24, seed=9)
        mesh = gossip.make_mesh(K, device="cpu")
        got = fleet.fleet_replay(blobs, mesh=mesh, shard="sharded")
        want = ref_fleet.fleet_replay(blobs, mesh=ref_gossip.make_mesh(K),
                                      shard="sharded")
        replicated = fleet.fleet_replay(blobs, device="cpu",
                                        shard="replicas")
        assert got.path == want.path == "fleet-sharded"
        assert got.cache == want.cache == replicated.cache
        assert got.snapshot == want.snapshot == replicated.snapshot

    def test_fleet_replay_auto_resolution(self, monkeypatch):
        blobs = chains_trace(n_chains=8, chain_len=24, seed=9)
        mesh = gossip.make_mesh(4, device="cpu")
        # below the size gate auto takes the replicated round on the
        # mesh, reusing the decoded union
        small = fleet.fleet_replay(blobs, mesh=mesh)
        rsmall = ref_fleet.fleet_replay(blobs,
                                        mesh=ref_gossip.make_mesh(4))
        assert small.path == rsmall.path == "fleet"
        monkeypatch.setenv(shard.MIN_ROWS_ENV, "1")
        big = fleet.fleet_replay(blobs, mesh=mesh)
        rbig = ref_fleet.fleet_replay(blobs, mesh=ref_gossip.make_mesh(4))
        assert big.path == rbig.path == "fleet-sharded"
        for a in (small, big):
            assert a.cache == rsmall.cache and a.snapshot == rsmall.snapshot
        # one entry (the CPU's default mesh) stays replicated
        assert fleet.fleet_replay(blobs, device="cpu").path == "fleet"


def _mt_servers(pool: bool, shards=2, **kw):
    return {
        "ref": RefServer(delta_ticks=True, pool=pool, shards=shards, **kw),
        "port": MultiDocServer(delta_ticks=True, pool=pool, shards=shards,
                               device="cpu", **kw),
        "port_oracle": MultiDocServer(delta_ticks=True, pool=False,
                                      device="cpu"),
    }


class TestMultiDoc:
    @pytest.mark.parametrize("pool", [True, False])
    def test_shards_2_tick_by_tick(self, pool, monkeypatch):
        monkeypatch.setenv("CRDT_TPU_DEVICE_MIN", "1")
        monkeypatch.setenv(shard.MIN_ROWS_ENV, "1")
        doc_sets = {i: doc_blobs(i, K=16, rights=(i % 2 == 1),
                                 deletes=True) for i in range(5)}
        srvs = _mt_servers(pool)
        sharded_ticks = 0
        rounds = [doc_sets] + [
            {i: delta_blobs(i, 16 + 6 * r) for i in doc_sets}
            for r in range(2)
        ]
        for rnd, blobs_of in enumerate(rounds):
            reps = {}
            for name, srv in srvs.items():
                for d, blobs in blobs_of.items():
                    srv.submit_many(d, blobs)
                if name == "port":
                    reps[name], n = _count_dispatches(srv.tick)
                    sharded_ticks += bool(n)
                else:
                    reps[name] = srv.tick()
            assert tuple(reps["port"]) == tuple(reps["ref"]), rnd
            for d in doc_sets:
                want = srvs["ref"].digest(d)
                for name in ("port", "port_oracle"):
                    assert srvs[name].digest(d) == want, (rnd, name, d)
                    assert srvs[name].cache(d) == srvs["ref"].cache(d)
        assert sharded_ticks >= 1, "no cold batch went sharded"
        if pool:
            p, r = srvs["port"].pool, srvs["ref"].pool
            assert (p.dispatches, p.doc_count()) == \
                (r.dispatches, r.doc_count())

    def test_one_shard_is_the_one_device_route(self, monkeypatch):
        monkeypatch.setenv(shard.MIN_ROWS_ENV, "1")
        srv = MultiDocServer(shards=1, device="cpu")
        for i in range(3):
            srv.submit_many(i, doc_blobs(i, K=8))
        _, n = _count_dispatches(srv.tick)
        assert n == 0
