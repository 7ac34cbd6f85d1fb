"""The port's live replica (``IncrementalReplay``) against the
reference's, on the CPU.

The same blobs go through ``crdt_tpu.models.incremental.
IncrementalReplay`` and ``crdt_tpu_torch.models.incremental.
IncrementalReplay(device="cpu")`` with the same ``device_min_rows``:
forced to the device round (``0``: splice + ``_converge_core`` +
``stream_scatter``'s plain version) or to the host path (``1 << 62``).
After EVERY apply both replicas must agree on the cache, the state
vector, the full-state and a diff ``encode_state_as_update``, every
sequence segment's order, every map winner, the pending stash, the
evicted ranges and the number of device rounds.
"""

import json

import numpy as np
import pytest
import torch

import bench
from crdt_tpu.codec import v1 as ref_v1
from crdt_tpu.core.engine import Engine as RefEngine
from crdt_tpu.core.ids import DeleteSet
from crdt_tpu.core.records import ItemRecord
from crdt_tpu.core.store import K_TYPE, TYPE_ARRAY, TYPE_MAP
from crdt_tpu.models import replay as ref_rp
from crdt_tpu.models.incremental import IncrementalReplay as RefReplay
from crdt_tpu.ops import packed as ref_pk
from crdt_tpu_torch.core.ids import StateVector
from crdt_tpu_torch.models import replay as rp
from crdt_tpu_torch.models.incremental import IncrementalReplay
from crdt_tpu_torch.obs import Tracer, set_tracer
from crdt_tpu_torch.ops import _build, kernels
from crdt_tpu_torch.ops import device as dev_mod
from crdt_tpu_torch.ops import packed as pk
from tests.test_grand_differential import _random_trace

DEVICE, HOST = 0, 1 << 62
MODES = [pytest.param(DEVICE, id="device"), pytest.param(HOST, id="host")]
CAP = 1 << 11  # one resident width for most cases: few reference shapes


def _blob(recs, ds=None):
    return ref_v1.encode_update(recs, ds or DeleteSet())


def _cache(inc):
    return json.dumps(inc.cache, sort_keys=True, default=repr)


class Pair:
    """A reference replica and the port's, fed the same blobs."""

    def __init__(self, thr, capacity=CAP):
        self.ref = RefReplay(capacity=capacity, device_min_rows=thr)
        self.got = IncrementalReplay(capacity=capacity, device_min_rows=thr,
                                     device="cpu")
        self.svs = []  # the reference's state vector after each apply
        self.ref_rounds0 = ref_pk.device_dispatch_count
        self.got_rounds0 = pk.device_dispatch_count

    def set_mode(self, thr):
        self.ref.device_min_rows = self.got.device_min_rows = thr

    def apply(self, blob, where=""):
        self.ref.apply(blob)
        self.got.apply(blob)
        self.svs.append(self.ref.state_vector())
        self.check(where)

    def device_rounds(self):
        return (pk.device_dispatch_count - self.got_rounds0,
                ref_pk.device_dispatch_count - self.ref_rounds0)

    def check(self, where=""):
        ref, got = self.ref, self.got
        assert _cache(got) == _cache(ref), where
        assert got.cache == ref.cache, where
        assert got.state_vector().clocks == ref.state_vector().clocks, where
        assert got.encode_state_as_update() == \
            ref.encode_state_as_update(), where
        mid = self.svs[len(self.svs) // 2]
        assert got.encode_state_as_update(StateVector(dict(mid.clocks))) \
            == ref.encode_state_as_update(mid), where
        seqs = sorted(sk for sk, kid in ref._seg_kid.items() if kid < 0)
        assert sorted(sk for sk, kid in got._seg_kid.items() if kid < 0) \
            == seqs, where
        for sk in seqs:
            assert got.order_list(sk) == ref.order_list(sk), (where, sk)
        assert got._win == ref._win, where
        assert sorted(got._pending) == sorted(ref._pending), where
        assert got.take_evicted_ranges() == ref.take_evicted_ranges(), where
        assert got.n_dev == ref.n_dev, where
        a, b = self.device_rounds()
        assert a == b, (where, a, b)


# ---------------------------------------------------------------------------
# the scenarios of tests/test_incremental.py::TestIncrementalRounds, each a
# list of rounds; a round is a list of blobs (or of (blobs, mode) where the
# scenario forces the mode per round)
# ---------------------------------------------------------------------------


def map_rounds():
    return [[_blob([
        ItemRecord(client=c, clock=rnd * 4 + j, parent_root="m",
                   key=f"k{j % 3}", content=(c, rnd, j))
        for c in (1, 2) for j in range(4)
    ])] for rnd in range(4)]


def sequence_append_rounds():
    rounds, prev = [], {}
    for rnd in range(4):
        recs = []
        for c in (1, 2, 3):
            for j in range(5):
                k = rnd * 5 + j
                recs.append(ItemRecord(
                    client=c, clock=k, parent_root="lst",
                    origin=(c, prev[c]) if c in prev else None,
                    content=(c, k)))
                prev[c] = k
        rounds.append([_blob(recs)])
    return rounds


def mixed_with_deletes_and_redelivery():
    rng = np.random.default_rng(3)
    blobs, rounds, clk, prev = [], [], {}, {}
    for rnd in range(6):
        recs, ds = [], DeleteSet()
        for c in (1, 2, 3, 4):
            for _ in range(6):
                k = clk[c] = clk.get(c, -1) + 1
                if rng.random() < 0.5:
                    recs.append(ItemRecord(
                        client=c, clock=k, parent_root="m",
                        key=f"x{rng.integers(0, 5)}", content=k))
                else:
                    key = (c, rng.integers(0, 2))
                    recs.append(ItemRecord(
                        client=c, clock=k, parent_root=f"l{key[1]}",
                        origin=(c, prev[key]) if key in prev else None,
                        content=k))
                    prev[key] = k
        if rnd >= 2:
            ds.add(1, int(rng.integers(0, clk[1])))
        blobs.append(_blob(recs, ds))
        rnd_blobs = [blobs[-1]]
        if rnd >= 1:  # redeliver an old blob: must be a no-op
            rnd_blobs.append(blobs[int(rng.integers(0, len(blobs)))])
        rounds.append(rnd_blobs)
    return rounds


def shared_anchor_conflict_rounds():
    rounds = [[_blob([ItemRecord(client=1, clock=j, parent_root="L",
                                 content=("a", j)) for j in range(3)])]]
    for c in (2, 3, 4):
        rounds.append([_blob([
            ItemRecord(client=c, clock=j, parent_root="L",
                       origin=(1, j % 3), content=(c, j))
            for j in range(4)])])
    return rounds


def right_bearing_rounds():
    rounds = [[_blob([ItemRecord(client=1, clock=j, parent_root="t",
                                 origin=(1, j - 1) if j else None,
                                 content=j) for j in range(5)])]]
    for c in (2, 3):
        rounds.append([_blob([
            ItemRecord(client=c, clock=0, parent_root="t", origin=(1, 1),
                       right=(1, 2), content=(c, 0)),
            ItemRecord(client=c, clock=1, parent_root="t", origin=(c, 0),
                       right=(1, 2), content=(c, 1))])])
    return rounds


def nested_collections():
    return [
        [_blob([
            ItemRecord(client=1, clock=0, parent_root="root", key="list",
                       kind=K_TYPE, type_ref=TYPE_ARRAY),
            ItemRecord(client=1, clock=1, parent_item=(1, 0), content="a"),
        ])],
        [_blob([ItemRecord(client=2, clock=0, parent_item=(1, 0),
                           origin=(1, 1), content="b")])],
    ]


def child_arrives_before_parent_type():
    return [
        [_blob([ItemRecord(client=2, clock=0, parent_item=(1, 0), key="a",
                           content=5)])],
        [_blob([ItemRecord(client=1, clock=0, parent_root="r", key="sub",
                           kind=K_TYPE, type_ref=TYPE_MAP)])],
    ]


def growth_across_capacity():
    rounds, prev = [], {}
    for rnd in range(4):
        recs = []
        for c in (1, 2):
            for j in range(40):
                k = rnd * 40 + j
                recs.append(ItemRecord(
                    client=c, clock=k, parent_root="big",
                    origin=(c, prev[c]) if c in prev else None, content=k))
                prev[c] = k
        rounds.append([_blob(recs)])
    return rounds


def late_small_client_relabel():
    return [
        [_blob([ItemRecord(client=50, clock=0, parent_root="m", key="k",
                           content="big")])],
        # a smaller client id arrives later: dense ranks shift and the
        # resident matrix relabels
        [_blob([ItemRecord(client=7, clock=0, parent_root="m", key="k",
                           content="small")])],
        [_blob([ItemRecord(client=3, clock=0, parent_root="s",
                           content="x"),
                ItemRecord(client=50, clock=1, parent_root="s",
                           origin=(3, 0), content="y")])],
    ]


def hostile_parent_cycle_terminates():
    return [[_blob([
        ItemRecord(client=1, clock=0, parent_item=(2, 0), key="a",
                   kind=K_TYPE, type_ref=TYPE_MAP),
        ItemRecord(client=2, clock=0, parent_item=(1, 0), key="b",
                   kind=K_TYPE, type_ref=TYPE_MAP),
    ])]]


def redelivered_deletes_do_not_grow():
    ds = DeleteSet()
    for k in range(10):
        ds.add(1, k)
    blob = _blob([ItemRecord(client=1, clock=k, parent_root="m",
                             key=f"k{k}", content=k) for k in range(12)], ds)
    return [[blob], [blob], [blob, blob]]


def bulk_delete_range():
    ds = DeleteSet()
    ds.add(1, 0, 45)  # one compacted range -> vectorized scan path
    return [
        [_blob([ItemRecord(client=1, clock=k, parent_root="m",
                           key=f"k{k % 7}", content=k) for k in range(50)])],
        [_blob([], ds)],
    ]


def out_of_order_delivery():
    recs, prev = [], None
    for kk in range(9):
        recs.append(ItemRecord(client=1, clock=kk, parent_root="s",
                               origin=prev, content=kk))
        prev = (1, kk)
    for j, kk in enumerate(range(9, 12)):
        recs.append(ItemRecord(client=1, clock=kk, parent_root="m",
                               key=f"k{j}", content=kk))
    return [[_blob(chunk)] for chunk in (recs[8:], recs[4:8], recs[:4])]


def cross_client_dependency_ordering():
    return [
        [_blob([ItemRecord(client=2, clock=0, parent_root="s",
                           origin=(1, 1), content="late")])],
        [_blob([
            ItemRecord(client=1, clock=0, parent_root="s", content="a"),
            ItemRecord(client=1, clock=1, parent_root="s", origin=(1, 0),
                       content="b"),
        ])],
    ]


def random_shuffled_delivery():
    rng = np.random.default_rng(23)
    blobs, clk, chains = [], {}, {}
    for _ in range(10):
        recs = []
        for c in (1, 2, 3):
            for _ in range(5):
                k = clk[c] = clk.get(c, -1) + 1
                if rng.random() < 0.4:
                    recs.append(ItemRecord(
                        client=c, clock=k, parent_root="m",
                        key=f"q{rng.integers(0, 5)}", content=k))
                else:
                    recs.append(ItemRecord(
                        client=c, clock=k, parent_root="s",
                        origin=chains.get(c), content=k))
                    chains[c] = (c, k)
        blobs.append(_blob(recs))
    return [[blobs[i]] for i in rng.permutation(len(blobs))]


def _grand_rounds(seed, n_rounds, writers, per, frac_map, frac_tail,
                  force_modes):
    rng = np.random.default_rng(seed)
    blobs, rounds, clk, own = [], [], {}, {}
    for rnd in range(n_rounds):
        recs, ds = [], DeleteSet()
        for c in writers:
            for _ in range(per):
                k = clk[c] = clk.get(c, -1) + 1
                p = rng.random()
                chain = own.setdefault(c, [])
                if p < frac_map:
                    recs.append(ItemRecord(
                        client=c, clock=k, parent_root="m",
                        key=f"q{rng.integers(0, 6)}", content=k))
                elif p < frac_tail or not chain:
                    recs.append(ItemRecord(
                        client=c, clock=k, parent_root="s",
                        origin=chain[-1] if chain else None, content=k))
                    chain.append((c, k))
                else:
                    j = int(rng.integers(0, len(chain)))
                    recs.append(ItemRecord(
                        client=c, clock=k, parent_root="s",
                        origin=chain[j - 1] if j else None,
                        right=chain[j], content=k))
                    chain.insert(j, (c, k))
        if rnd >= 2 and rng.random() < 0.6:
            ds.add(int(rng.integers(1, len(writers) + 1)),
                   int(rng.integers(0, 10)))
        blobs.append(_blob(recs, ds))
        rnd_blobs = [blobs[-1]]
        if force_modes and rng.random() < 0.4:
            rnd_blobs.append(blobs[int(rng.integers(0, len(blobs)))])
        if force_modes:
            # even rounds host (incremental links), odd rounds device
            # (wholesale reconvergence)
            rnd_blobs = [(b, HOST if rnd % 2 == 0 else DEVICE)
                         for b in rnd_blobs]
        rounds.append(rnd_blobs)
    return rounds


def random_grand_rounds():
    return _grand_rounds(11, 8, (1, 2, 3), 8, 0.35, 0.85, False)


def forced_host_device_alternation_with_rights():
    return _grand_rounds(23, 10, (1, 2, 3, 4), 6, 0.25, 0.6, True)


SCENARIOS = {f.__name__: f for f in (
    map_rounds, sequence_append_rounds, mixed_with_deletes_and_redelivery,
    shared_anchor_conflict_rounds, right_bearing_rounds, nested_collections,
    child_arrives_before_parent_type, growth_across_capacity,
    late_small_client_relabel, hostile_parent_cycle_terminates,
    redelivered_deletes_do_not_grow, bulk_delete_range,
    out_of_order_delivery, cross_client_dependency_ordering,
    random_shuffled_delivery, random_grand_rounds,
    forced_host_device_alternation_with_rights,
)}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_rounds_match_reference(name, mode):
    capacity = 64 if name == "growth_across_capacity" else CAP
    pair = Pair(mode, capacity=capacity)
    forced = 0
    for i, rnd in enumerate(SCENARIOS[name]()):
        for j, blob in enumerate(rnd):
            if isinstance(blob, tuple):
                blob, m = blob
                pair.set_mode(m)
                forced += m == DEVICE
            pair.apply(blob, f"{name} round {i} blob {j}")
    got_rounds, _ = pair.device_rounds()
    if mode == HOST and not forced:
        assert got_rounds == 0 and pair.got._mat is None
    elif name not in ("hostile_parent_cycle_terminates",
                      "redelivered_deletes_do_not_grow"):
        assert got_rounds > 0


def test_late_small_client_relabels_the_resident_matrix():
    pair = Pair(DEVICE)
    for rnd in late_small_client_relabel():
        pair.apply(rnd[0])
    assert pair.got.cache["m"]["k"] == "big"  # client 50 still wins
    dense = pair.got._mat[0, :pair.got.n_dev].tolist()
    assert dense == [pair.got._dense[c] for c in
                     pair.got.cols.col("client").tolist()]


def test_host_and_device_modes_converge_identically():
    base = bench.build_trace(40, 40, seed=3)
    deltas = [
        bench.build_trace(4, 40, seed=60 + i, client_base=900 + 4 * i,
                          map_frac=0.5)
        for i in range(3)
    ]
    host = Pair(HOST, capacity=1 << 13)
    dev = Pair(DEVICE, capacity=1 << 13)
    for p in (host, dev):
        p.apply(base)
        for i, d in enumerate(deltas):
            p.apply(d, f"delta {i}")
    assert host.got.cache == dev.got.cache
    # and a mode FLIP mid-stream converges too (lazy tail flushes)
    flip = Pair(HOST, capacity=1 << 13)
    flip.apply(base)
    flip.apply(deltas[0])
    flip.set_mode(DEVICE)
    flip.apply(deltas[1], "flip to device")
    flip.set_mode(HOST)
    flip.apply(deltas[2], "flip to host")
    assert flip.got.cache == dev.got.cache


@pytest.mark.parametrize("mode", MODES)
def test_shuffled_delivery_pends_like_the_engine(mode):
    """Blobs out of causal order: rows stash until their gaps fill, so
    every intermediate state equals the scalar engine's."""
    pair = Pair(mode)
    eng = RefEngine(0)
    for i, (blob,) in enumerate(random_shuffled_delivery()):
        pair.apply(blob, f"blob {i}")
        rr, _ = ref_v1.decode_update(blob)
        eng.apply_records(rr)
        assert pair.got.cache == eng.to_json(), f"blob {i}"
    assert not pair.got._pending


@pytest.mark.parametrize("mode", MODES)
def test_pending_limit_evicts_like_the_reference(mode):
    # client 1's chain delivered newest first with a stash budget of 3:
    # the deepest-queued ids are evicted and their ranges recorded
    recs, prev = [], None
    for k in range(12):
        recs.append(ItemRecord(client=1, clock=k, parent_root="s",
                               origin=prev, content=k))
        prev = (1, k)
    pair = Pair(mode)
    pair.ref.pending_limit = pair.got.pending_limit = 3
    ref_ev, got_ev = [], []
    for i, chunk in enumerate((recs[8:], recs[4:8])):
        pair.ref.apply(_blob(chunk))
        pair.got.apply(_blob(chunk))
        ref_ev.append(pair.ref.take_evicted_ranges())
        got_ev.append(pair.got.take_evicted_ranges())
        pair.svs.append(pair.ref.state_vector())
        pair.check(f"chunk {i}")
    assert got_ev == ref_ev and any(got_ev)
    assert len(pair.got._pending) == 3
    pair.apply(_blob(recs), "whole chain")
    assert pair.got.cache["s"] == list(range(12))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", range(6))
def test_grand_differential_trace(seed, mode):
    blobs = _random_trace(seed)
    pair = Pair(mode)
    step = max(1, len(blobs) // 5)
    for i in range(0, len(blobs), step):
        pair.apply(blobs[i:i + step], f"seed {seed} blobs {i}")
    want = ref_rp.replay_trace(blobs)
    assert pair.got.cache == want.cache


class TestFaultLadder:
    def _pair_with_base(self):
        pair = Pair(DEVICE)
        for rnd in sequence_append_rounds()[:2]:
            pair.apply(rnd[0])
        return pair

    def test_injected_faults_route_the_round_host_side(self):
        pair = self._pair_with_base()
        rounds = sequence_append_rounds()
        tracer = set_tracer(Tracer(enabled=True))
        seen = []

        def hook(stage, attempt):
            seen.append((stage, attempt))
            raise RuntimeError("injected device fault")

        old = dev_mod.set_device_fault_hook(hook)
        try:
            before = pk.device_dispatch_count
            pair.got.apply(rounds[2][0])
        finally:
            dev_mod.set_device_fault_hook(old)
            set_tracer(Tracer(enabled=False))
        assert seen == [("incremental.converge", 0),
                        ("incremental.converge", 1)]
        assert pk.device_dispatch_count == before  # no device round
        counts = tracer.counters("device.")
        assert counts["device.dispatch_errors"] == 2
        assert counts["device.retries"] == 1
        assert counts["device.fallback"] == 1
        assert counts['device.fallback_by{route="host"}'] == 1
        # the ladder dropped the matrix: the round went host-side, with
        # the reference's answer, and the next round re-splices all
        assert pair.got._mat is None and pair.got.n_dev == 0
        pair.ref.apply(rounds[2][0])
        assert pair.got.cache == pair.ref.cache
        pair.ref.apply(rounds[3][0])
        pair.got.apply(rounds[3][0])
        assert pair.got.n_dev == pair.got.cols.n
        assert pair.got.cache == pair.ref.cache
        assert pair.got.cache == ref_rp.replay_trace(
            [r[0] for r in rounds]).cache

    def test_one_injected_fault_retries_on_the_device(self):
        pair = self._pair_with_base()
        rounds = sequence_append_rounds()
        faults = iter([True])

        def hook(stage, attempt):
            if next(faults, False):
                raise RuntimeError("transient")

        old = dev_mod.set_device_fault_hook(hook)
        try:
            before = pk.device_dispatch_count
            pair.got.apply(rounds[2][0])
        finally:
            dev_mod.set_device_fault_hook(old)
        assert pk.device_dispatch_count == before + 1
        pair.ref.apply(rounds[2][0])
        assert pair.got.cache == pair.ref.cache

    def test_kernel_errors_propagate_out_of_apply(self, monkeypatch):
        pair = self._pair_with_base()

        def broken(pos, n_out):
            raise _build.KernelError("stream_scatter launch: CUDA error 700")

        monkeypatch.setattr(pk, "stream_scatter", broken)
        before = pk.device_dispatch_count
        with pytest.raises(_build.KernelError, match="CUDA error"):
            pair.got.apply(sequence_append_rounds()[2][0])
        assert pk.device_dispatch_count == before
        # the attempt that failed part-way dropped its matrix
        assert pair.got._mat is None and pair.got.n_dev == 0

    def test_other_runtime_errors_are_not_hidden(self, monkeypatch):
        pair = self._pair_with_base()

        def broken(*a, **kw):
            raise RuntimeError("CUDA error: an illegal memory access")

        monkeypatch.setattr(pk, "_converge_core", broken)
        with pytest.raises(RuntimeError, match="illegal memory access"):
            pair.got.apply(sequence_append_rounds()[2][0])

    def test_out_of_memory_propagates_out_of_apply(self, monkeypatch):
        # the matrix lives on the card: an out-of-memory must not move
        # the round to the host unseen, so it skips every rung
        pair = self._pair_with_base()

        def oom(*a, **kw):
            raise torch.OutOfMemoryError("CUDA out of memory")

        monkeypatch.setattr(pk, "_converge_core", oom)
        tracer = set_tracer(Tracer(enabled=True))
        try:
            before = pk.device_dispatch_count
            with pytest.raises(torch.OutOfMemoryError):
                pair.got.apply(sequence_append_rounds()[2][0])
        finally:
            set_tracer(Tracer(enabled=False))
        assert pk.device_dispatch_count == before
        assert tracer.counters("device.") == {}
        # the attempt that failed part-way dropped its matrix
        assert pair.got._mat is None and pair.got.n_dev == 0


class TestEngineSurface:
    def test_no_card_raises_at_construction(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            IncrementalReplay()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rp.replay_trace(bench.build_trace(3, 4), route="replica")
        # the host route never asks for the card
        rp.replay_trace(bench.build_trace(3, 4), route="host")

    def test_pool_is_not_ported_yet(self):
        with pytest.raises(NotImplementedError, match="item 6"):
            IncrementalReplay(pool=object(), device="cpu")

    def test_matrix_allocates_lazily(self):
        inc = IncrementalReplay(device_min_rows=0, device="cpu")
        assert inc._mat is None
        inc.apply(map_rounds()[0][0])
        assert inc._mat.shape == (7, 1 << 14)
        assert inc._mat.dtype == torch.int64

    def test_resident_bytes_and_estimate(self):
        ref, got = RefReplay(), IncrementalReplay(device="cpu")
        assert got.resident_bytes() == ref.resident_bytes()
        blob = _blob([ItemRecord(client=1, clock=k, parent_root="m",
                                 key=f"k{k % 4}", content=k)
                      for k in range(3000)])
        ref.apply(blob)
        got.apply(blob)
        assert got.resident_bytes() == ref.resident_bytes()
        assert IncrementalReplay.estimate_resident_bytes(3000) == \
            RefReplay.estimate_resident_bytes(3000)
        assert IncrementalReplay.estimate_resident_bytes(3000) >= \
            got.resident_bytes()

    def test_env_and_explicit_crossover(self, monkeypatch):
        monkeypatch.delenv("CRDT_TPU_DEVICE_MIN", raising=False)
        assert IncrementalReplay(device="cpu").device_min_rows is None
        assert IncrementalReplay(device_min_rows=7,
                                 device="cpu").device_min_rows == 7
        monkeypatch.setenv("CRDT_TPU_DEVICE_MIN", "123")
        assert IncrementalReplay(device="cpu").device_min_rows == 123

    def test_calibration_on_the_cpu(self, monkeypatch):
        monkeypatch.setattr(IncrementalReplay, "_calib", {})
        info = IncrementalReplay.calibration_info(device="cpu")
        assert info["threshold"] >= 4096
        assert info["t_interact_ms"] >= 0
        assert info["host_us_per_row"] > 0
        assert info["dev_us_per_row"] >= 0
        assert IncrementalReplay.calibration_info(device="cpu") == info
        assert IncrementalReplay.crossover_use_host(100, device="cpu")
        assert list(IncrementalReplay._calib) == ["cpu"]

    def test_auto_rule_uses_the_calibrated_threshold(self, monkeypatch):
        monkeypatch.setattr(IncrementalReplay, "_calib", {"cpu": {
            "t_interact_ms": 1.0, "host_us_per_row": 1.0,
            "dev_us_per_row": 0.0, "threshold": 20_000}})
        assert IncrementalReplay.crossover_use_host(16_383, "cpu")
        assert IncrementalReplay.crossover_use_host(19_999, "cpu")
        assert not IncrementalReplay.crossover_use_host(20_000, "cpu")
        pair = Pair(None)
        pair.ref.device_min_rows = HOST  # the reference's probe is its own
        pair.got.device_min_rows = None
        big = bench.build_trace(25, 900, seed=1)
        pair.got.apply(big)
        pair.ref.apply(big)
        assert pair.got.cache == pair.ref.cache
        assert pair.got._mat is not None  # 22,500 rows: a device round

    def test_admit_local_fast_path(self):
        pair = Pair(HOST)
        pair.apply(sequence_append_rounds()[0][0])
        recs = [ItemRecord(client=1, clock=5, parent_root="lst",
                           origin=(1, 4), content="tail"),
                ItemRecord(client=1, clock=6, parent_root="m", key="a",
                           content=1)]
        pair.ref.admit_local(recs)
        pair.got.admit_local(recs)
        pair.svs.append(pair.ref.state_vector())
        pair.check("admit_local")
        assert pair.got.last_touched_roots == pair.ref.last_touched_roots
        assert pair.got.last_touched_keys == pair.ref.last_touched_keys

    def test_decode_delta_and_admissibility(self):
        pair = Pair(DEVICE)
        rounds = sequence_append_rounds()
        pair.apply(rounds[0][0])
        for blobs in (rounds[1][0], rounds[3][0], rounds[0][0]):
            dec = IncrementalReplay.decode_delta(blobs)
            assert pair.got.delta_admissible(dec) == \
                pair.ref.delta_admissible(RefReplay.decode_delta(blobs))
        dec = IncrementalReplay.decode_delta(rounds[1][0])
        pair.got.apply_decoded(dec)
        pair.ref.apply(rounds[1][0])
        pair.svs.append(pair.ref.state_vector())
        pair.check("apply_decoded")

    def test_order_epoch_and_iteration(self):
        pair = Pair(HOST)
        for rnd in right_bearing_rounds():
            pair.apply(rnd[0])
        for sk, kid in pair.ref._seg_kid.items():
            if kid >= 0:
                continue
            got, ref = pair.got, pair.ref
            assert list(got.iter_order(sk)) == list(ref.iter_order(sk))
            assert list(got.iter_order_reversed(sk)) == \
                list(ref.iter_order_reversed(sk))
            row = got.order_list(sk)[1]
            assert list(got.iter_order_after(sk, row)) == \
                list(ref.iter_order_after(sk, row))
            assert list(got.iter_order_before(sk, row)) == \
                list(ref.iter_order_before(sk, row))
            assert got.order_position(sk, row) == ref.order_position(sk, row)
            assert got.order_next_row(sk, row) == ref.order_next_row(sk, row)
            assert got.order_epoch(sk) == ref.order_epoch(sk)

    def test_to_decoded_columns_field_by_field(self):
        pair = Pair(DEVICE)
        for rnd in mixed_with_deletes_and_redelivery():
            for b in rnd:
                pair.apply(b)
        a = pair.got.to_decoded_columns()
        b = pair.ref.to_decoded_columns()
        assert sorted(a) == sorted(b)
        for k in a:
            if isinstance(a[k], np.ndarray):
                np.testing.assert_array_equal(a[k], b[k])
                assert a[k].dtype == b[k].dtype, k
            else:
                assert a[k] == b[k], k

    def test_records_since(self):
        pair = Pair(HOST)
        for rnd in sequence_append_rounds():
            pair.apply(rnd[0])
        sv = pair.ref.state_vector()
        mid = pair.svs[1]
        for want_sv, got_sv in ((None, None),
                                (mid, StateVector(dict(mid.clocks))),
                                (sv, StateVector(dict(sv.clocks)))):
            got = [r.__dict__ for r in pair.got.records_since(got_sv)]
            ref = [r.__dict__ for r in pair.ref.records_since(want_sv)]
            assert got == ref

    def test_stream_scatter_runs_once_per_device_round(self, monkeypatch):
        calls = []
        real = pk.stream_scatter

        def counting(pos, n_out):
            calls.append((pos.shape[0], n_out))
            return real(pos, n_out)

        monkeypatch.setattr(pk, "stream_scatter", counting)
        pair = Pair(DEVICE)
        for rnd in map_rounds() + sequence_append_rounds():
            pair.apply(rnd[0])
        rounds, _ = pair.device_rounds()
        assert len(calls) == rounds == 8
        # B = n_out = sel_bucket: the octave bucket capped at the width
        assert all(b == n == CAP for b, n in calls)
        assert kernels.stream_scatter.launches == 0  # CPU: plain version
