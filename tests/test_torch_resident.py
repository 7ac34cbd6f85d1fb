"""The port's resident full-converge (``crdt_tpu_torch.ops.resident.
ResidentColumns``) and the resident fallback of every replay route,
against the reference's, on the CPU.

``ResidentColumns(device="cpu")`` runs the cases of
``tests/test_resident.py`` step by step beside the reference's
``ResidentColumns``: after every step ``capacity``, ``n``,
``device_bytes()`` and the dense client table must agree, and every
output tensor of a converge (``maps_out`` and ``seq_out``) must be
equal, element for element. Then every route is forced onto the
resident fallback, as ``tests/test_packed.py`` forces the reference
(the packed stager patched to refuse in both packages): caches and
snapshots must equal the reference's byte for byte, with and without
``clients=``.
"""

import json

import numpy as np
import pytest

from crdt_tpu.models import replay as ref_rp
from crdt_tpu.models import streaming as ref_sm
from crdt_tpu.models.multidoc import MultiDocServer as RefServer
from crdt_tpu.ops import packed as ref_packed
from crdt_tpu.ops import resident as ref_resident
from crdt_tpu.ops import shard as ref_shard
from crdt_tpu_torch import replay_trace
from crdt_tpu_torch.models import replay as rp
from crdt_tpu_torch.models import stream_replay, traces
from crdt_tpu_torch.models.multidoc import MultiDocServer
from crdt_tpu_torch.ops import resident, staging
from tests.test_multidoc import doc_blobs
from tests.test_streaming import mixed_blobs, nested_blobs, text_blobs


@pytest.fixture(autouse=True)
def _interpret_kernels(monkeypatch):
    monkeypatch.setenv("CRDT_TPU_PALLAS", "interpret")
    monkeypatch.delenv("CRDT_TPU_WIDE_STAGING", raising=False)
    monkeypatch.delenv(ref_shard.SHARD_ENV, raising=False)
    monkeypatch.delenv(ref_shard.MIN_ROWS_ENV, raising=False)


def _map_cols(client, clocks, parents, keys):
    n = len(clocks)
    return {
        "client": np.full(n, client, np.int32),
        "clock": np.asarray(clocks, np.int64),
        "parent_is_root": np.ones(n, bool),
        "parent_a": np.asarray(parents, np.int64),
        "parent_b": np.full(n, -1, np.int64),
        "key_id": np.asarray(keys, np.int32),
        "origin_client": np.full(n, -1, np.int32),
        "origin_clock": np.full(n, -1, np.int64),
        "valid": np.ones(n, bool),
    }


def _seq_cols(client, n):
    cols = _map_cols(client, range(n), [0] * n, [0] * n)
    cols["key_id"] = np.full(n, -1, np.int32)
    cols["origin_client"] = np.asarray([-1] + [client] * (n - 1), np.int32)
    cols["origin_clock"] = np.asarray([-1] + list(range(n - 1)), np.int64)
    return cols


class Pair:
    """One reference and one port ``ResidentColumns``, driven in step."""

    def __init__(self, capacity=512, clients=None):
        self.ref = ref_resident.ResidentColumns(capacity=capacity,
                                                clients=clients)
        self.port = resident.ResidentColumns(capacity=capacity,
                                             clients=clients, device="cpu")

    def same_state(self):
        r, p = self.ref, self.port
        assert p.capacity == r.capacity
        assert p.n == r.n
        assert p.device_bytes() == r.device_bytes()
        assert p._seen == r._seen
        for raw in r._seen:
            assert p.dense_client(raw) == r.dense_client(raw)
        for (name, _), rb, pb in zip(resident.COLUMNS, r._bufs, p._bufs):
            assert np.array_equal(np.asarray(rb), pb.numpy()), name

    def append(self, cols):
        self.ref.append(cols)
        self.port.append(cols)
        self.same_state()

    def converge(self, **kw):
        return self.outputs(self.ref.converge(**kw), self.port.converge(**kw))

    def append_converge(self, cols, **kw):
        return self.outputs(self.ref.append_converge(cols, **kw),
                            self.port.append_converge(cols, **kw))

    def outputs(self, want, got):
        self.same_state()
        assert len(got) == len(want) == 2
        for w_out, g_out in zip(want, got):
            assert len(g_out) == len(w_out)
            for w, g in zip(w_out, g_out):
                w = np.asarray(w)
                assert g.shape == w.shape
                assert np.array_equal(w, g.numpy())
        return got


class TestResidentColumns:
    def test_append_and_converge_rounds(self):
        p = Pair()
        p.append(_map_cols(1, range(8), [0] * 8, range(8)))
        p.append(_map_cols(2, range(4), [0] * 4, range(4)))
        maps_out, _ = p.converge(num_segments=512)
        order, winners = maps_out[0].numpy(), maps_out[2].numpy()
        won = {int(order[w]) for w in winners if w >= 0}
        assert len(won) == 8 and {8, 9, 10, 11, 4, 5, 6, 7} <= won

    def test_growth_preserves_rows(self):
        p = Pair()
        for r in range(5):
            p.append(_map_cols(r + 1, range(200), [0] * 200, range(200)))
        assert p.port.n == 1000 and p.port.capacity >= 1024
        p.converge()
        p.converge(num_segments=2048)

    def test_sequences_converge_resident(self):
        p = Pair()
        for client in (1, 2):
            p.append(_seq_cols(client, 6))
        _, seq_out = p.converge(num_segments=512)
        assert int((seq_out[2] >= 0).sum()) == 12
        assert int(seq_out[3].sum()) == 12

    def test_large_ids_and_out_of_order_arrival(self):
        p = Pair()
        big, mid, small = 2**31 - 1, 2**20 + 7, 5
        p.append(_map_cols(big, [0], [0], [3]))
        p.append(_map_cols(small, [0], [0], [3]))
        p.append(_map_cols(mid, [0], [0], [3]))  # relabels in place
        assert [p.port.dense_client(c) for c in (small, mid, big)] == \
            [0, 1, 2]
        maps_out, _ = p.converge(num_segments=512)
        order, winners = maps_out[0].numpy(), maps_out[2].numpy()
        assert [int(order[w]) for w in winners if w >= 0] == [0]

    def test_relabel_keeps_origins_and_their_nulls(self):
        p = Pair()
        a = _seq_cols(2**31 - 3, 5)
        b = _seq_cols(2**30, 4)
        b["origin_client"][0] = 2**31 - 3  # an origin in a's chain
        b["origin_clock"][0] = 4
        p.append(a)
        p.append(_seq_cols(7, 3))
        p.append(b)  # lands between: relabels clients and origins
        p.converge(num_segments=512)

    def test_preregistered_clients_never_relabel(self, monkeypatch):
        def boom(*a, **k):
            raise AssertionError("relabel ran despite pre-registration")

        monkeypatch.setattr(resident, "_relabel", boom)
        monkeypatch.setattr(ref_resident, "_relabel", boom)
        clients = [2**30 + 11, 17, 2**25]
        p = Pair(clients=clients)
        for c in clients:
            p.append(_map_cols(c, [0], [0], [1]))
        maps_out, _ = p.converge(num_segments=512)
        assert int((maps_out[2] >= 0).sum()) == 1

    def test_fused_matches_append_then_converge(self):
        cols = _map_cols(1, range(12), [0] * 12, list(range(6)) * 2)
        sep = Pair()
        sep.append(cols)
        want = sep.converge(num_segments=512)
        fused = Pair()
        got = fused.append_converge(cols, num_segments=512)
        for w_out, g_out in zip(want, got):
            for w, g in zip(w_out, g_out):
                assert np.array_equal(w.numpy(), g.numpy())

    def test_empty_delta_falls_back_to_converge(self):
        p = Pair()
        p.append(_map_cols(1, range(4), [0] * 4, range(4)))
        out = p.append_converge(
            {k: v[:0] for k, v in _map_cols(1, [], [], []).items()},
            num_segments=512)
        assert int((out[0][2] >= 0).sum()) == 4

    def test_growing_fused_append_keeps_segment_default(self):
        p = Pair()
        p.append(_map_cols(1, range(512), [0] * 512, range(512)))
        grow = _map_cols(2, range(600), [1] * 600, range(600))
        fused = p.append_converge(grow)  # default num_segments
        ref = resident.ResidentColumns(capacity=512, device="cpu")
        ref.append(_map_cols(1, range(512), [0] * 512, range(512)))
        ref.append(grow)
        for x, y in zip(ref.converge(), fused):
            for a, b in zip(x, y):
                assert np.array_equal(a.numpy(), b.numpy())

    def test_delete_ranges_reach_ds_mask(self):
        p = Pair()
        p.append(_map_cols(3, range(40), [0] * 40, list(range(8)) * 5))
        dc = np.asarray([0, 0, -1, -1], np.int32)  # dense client 0
        ds = np.asarray([5, 20, -1, -1], np.int64)
        de = np.asarray([9, 33, -1, -1], np.int64)
        want = p.ref.converge(num_segments=64, d_client=dc, d_start=ds,
                              d_end=de)
        import torch

        got = p.port.converge(
            num_segments=64, d_client=torch.from_numpy(dc),
            d_start=torch.from_numpy(ds), d_end=torch.from_numpy(de))
        p.outputs(want, got)
        assert int(got[0][4].sum()) == 17

    def test_no_card_raises_at_construction(self, monkeypatch):
        import torch

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resident.ResidentColumns()


# ---------------------------------------------------------------------------
# the resident fallback of every route
# ---------------------------------------------------------------------------


@pytest.fixture
def refuse_staging(monkeypatch):
    """The packed stager refuses every union in both packages, as a
    union past its bounds would."""
    monkeypatch.setattr(ref_packed, "stage", lambda *a, **kw: None)
    monkeypatch.setattr(staging, "stage", lambda *a, **kw: None)


TRACES = {
    "trace": lambda: traces.build_trace(12, 20, seed=1),
    "conflict": lambda: traces.build_conflict_trace(10, 16),
    "text": lambda: traces.build_text_trace(8, 20),
    "nested": nested_blobs,
    "mixed": lambda: mixed_blobs(R=6, K=14),
    "rights": lambda: text_blobs(R=6, K=12),
}


def _clients(blobs):
    dec = rp.decode(blobs)
    return sorted(set(int(c) for c in dec["client"]))


def _same(got, want):
    assert json.dumps(got.cache, sort_keys=True, default=repr) == \
        json.dumps(want.cache, sort_keys=True, default=repr)
    assert got.snapshot == want.snapshot
    assert got.n_ops == want.n_ops


@pytest.mark.parametrize("with_clients", [False, True],
                         ids=["no-clients", "clients"])
@pytest.mark.parametrize("name", sorted(TRACES))
def test_device_route_fallback_matches_reference(name, with_clients,
                                                 refuse_staging):
    blobs = TRACES[name]()
    kw = {"clients": _clients(blobs)} if with_clients else {}
    want = ref_rp.replay_trace(blobs, route="device", **kw)
    got = replay_trace(blobs, device="cpu", **kw)
    assert got.path == want.path == "device"
    _same(got, want)


def test_fallback_equals_the_packed_route():
    # the two converge engines of the port, one union
    blobs = traces.build_trace(16, 24, seed=5)
    packed_res = replay_trace(blobs, device="cpu")
    cols, _ = rp.stage(rp.decode(blobs))
    handle = rp.converge(cols, device="cpu")
    assert handle[0] == "packed"
    res = rp._converge_resident(cols, None, device="cpu")
    dec = rp.decode(blobs)
    ds = rp.stage(dec)[1]
    w, v, o = rp.gather(dec, ds, ("resident", res), device="cpu")
    assert rp.materialize(dec, ds, w, v, o) == packed_res.cache


def test_clients_superset_seeds_the_table(refuse_staging, monkeypatch):
    blobs = traces.build_trace(6, 10, seed=2)
    seen = []
    orig = resident.ResidentColumns.__init__

    def spy(self, capacity=1 << 15, clients=None, *, device="cuda"):
        seen.append(list(clients))
        orig(self, capacity, clients, device=device)

    monkeypatch.setattr(resident.ResidentColumns, "__init__", spy)
    extra = [0, 2**31 - 1] + _clients(blobs)
    want = ref_rp.replay_trace(blobs, clients=extra)
    got = replay_trace(blobs, clients=extra, device="cpu")
    _same(got, want)
    assert seen == [extra]


@pytest.mark.parametrize("with_clients", [False, True],
                         ids=["no-clients", "clients"])
def test_stream_route_fallback_matches_reference(with_clients,
                                                 refuse_staging):
    blobs = mixed_blobs(R=8, K=12)
    kw = {"clients": _clients(blobs)} if with_clients else {}
    ref_phases, phases = {}, {}
    want = ref_sm.stream_replay(blobs, max_shards=3, min_shard_rows=1,
                                phases=ref_phases, **kw)
    got = stream_replay(blobs, max_shards=3, min_shard_rows=1,
                        phases=phases, device="cpu", **kw)
    assert got.path == want.path == "stream-fallback"
    assert phases["fallback"] is ref_phases["fallback"] is True
    _same(got, want)
    via_route = replay_trace(blobs, route="stream", device="cpu", **kw)
    _same(via_route, want)


def test_multidoc_tick_that_refuses_staging(refuse_staging, monkeypatch):
    # the server's per-doc converge (rp.converge) reaches the fallback
    calls = []
    orig = rp._converge_resident

    def spy(cols, clients, *, device):
        calls.append(len(cols["client"]))
        return orig(cols, clients, device=device)

    monkeypatch.setattr(rp, "_converge_resident", spy)
    docs = {f"d{i}": doc_blobs(i, K=10 + i, rights=(i == 1),
                               deletes=(i % 2 == 0)) for i in range(3)}
    ref = RefServer(max_rows_per_dispatch=160)
    port = MultiDocServer(max_rows_per_dispatch=160, device="cpu")
    for srv in (ref, port):
        for d, bs in docs.items():
            srv.submit_many(d, bs)
    assert tuple(port.tick()) == tuple(ref.tick())
    for d in docs:
        assert port.digest(d) == ref.digest(d)
        assert port.cache(d) == ref.cache(d)
    assert port.doc_digests() == ref.doc_digests()
    assert len(calls) == len(docs)


# ---------------------------------------------------------------------------
# chip_smoke's wide-key union and its independent answer, at a small size
# ---------------------------------------------------------------------------


def _wide_key_records(n_writers, n_ops, n_shared, seed):
    """The wide-key union written out op by op as records, through the
    Python encoder: the specification ``build_wide_key_trace`` must
    reproduce byte for byte from numpy columns."""
    from crdt_tpu_torch.codec import v1
    from crdt_tpu_torch.core.ids import DeleteSet
    from crdt_tpu_torch.core.records import ItemRecord

    rng = np.random.default_rng(seed)
    blobs = []
    for r in range(n_writers):
        client = r + 1
        shared_j = [j for j in range(n_ops) if j % 10 != 9 and j % 16 == 0]
        hs = dict(zip(shared_j, rng.integers(0, n_shared,
                                             len(shared_j)).tolist()))
        recs, last_push, last_set = [], {}, {}
        for j in range(n_ops):
            content = r * n_ops + j
            if j % 10 == 9:
                lst = (r + j) % 8
                prev = last_push.get(lst)
                last_push[lst] = j
                recs.append(ItemRecord(
                    client=client, clock=j, parent_root=f"l{lst}",
                    origin=None if prev is None else (client, prev),
                    content=content))
            elif j % 16 == 0:
                h = hs[j]
                prev = last_set.get(h)
                last_set[h] = j
                recs.append(ItemRecord(
                    client=client, clock=j, parent_root="m", key=f"s{h}",
                    origin=None if prev is None else (client, prev),
                    content=content))
            else:
                recs.append(ItemRecord(client=client, clock=j,
                                       parent_root="m", key=f"k{r}-{j}",
                                       content=content))
        ds = DeleteSet()
        for k in rng.choice(n_ops, size=max(1, n_ops // 20), replace=False):
            ds.add(client, int(k))
        blobs.append(v1.encode_update(recs, ds))
    return blobs


@pytest.mark.parametrize("shape", [(3, 200, 8, 0), (2, 2600, 64, 5)])
def test_wide_key_generator_matches_the_record_encoder(shape):
    import chip_smoke

    assert chip_smoke.build_wide_key_trace(*shape) == \
        _wide_key_records(*shape)


def test_wide_key_union_halves_give_the_resident_answer(monkeypatch):
    # the key bound lowered to 2^13 so that 4 writers' 8,708 fresh keys
    # pass it and each half's 4,354 do not
    import chip_smoke

    blobs = chip_smoke.build_wide_key_trace(4, 2600, 64, 1)
    monkeypatch.setattr(staging, "_KID_BITS", 13)
    dec = rp.decode(blobs)
    cols, ds = rp.stage(dec)
    assert staging.stage(cols) is None
    got = replay_trace(blobs, device="cpu")
    halves = []
    for half in chip_smoke.split_union_by_writers(dec, cols):
        handle = rp.converge(half, device="cpu")
        assert handle[0] == "packed"
        w, v, o = rp.gather(dec, ds, handle, device="cpu")
        halves.append(rp.materialize(dec, ds, w, v, o))
    assert chip_smoke.merge_half_caches(*halves) == got.cache
    # the reference stages the whole union (its bound is 2^21)
    want = ref_rp.replay_trace(blobs, route="device")
    _same(got, want)
