"""The port's packed converge (crdt_tpu_torch.ops.staging / .packed)
against the reference (crdt_tpu.ops.packed), on the CPU.

Two layers, both with zero tolerance (every output is an integer):

1. **Staging.** The port's numpy stager must equal the reference's
   field by field — the flat staged array, its per-section encodings,
   every translation table and static bound — on the cases of
   tests/test_packed.py, tests/test_transfer_diet.py and
   tests/test_subtree_split.py: chain-split widths {1, odd, default},
   int16 / hi-lo staging edges, clocks at 2^15-1 and 2^31-1, wide
   staging, hostile cyclic origins, and the eager ``put=`` seam.
2. **Converge.** One reference plan carried across with
   :func:`plan_from_reference` and converged by both bodies (the
   reference's kernels in interpret mode) gives an identical
   ``PackedResult``.
"""

import numpy as np
import pytest
import torch

from crdt_tpu.models import replay as ref_rp
from crdt_tpu.ops import packed as ref_packed
from crdt_tpu_torch.models import replay as rp
from crdt_tpu_torch.ops import packed, staging
from tests.test_packed import _cols
from tests.test_sort_diet import sort_diet_blobs
from tests.test_subtree_split import conflict_trace
from tests.test_transfer_diet import boundary_blobs


@pytest.fixture(autouse=True)
def _interpret_kernels(monkeypatch):
    # the reference converges through its Pallas kernels in interpret
    # mode, as its own tests run them on the CPU
    monkeypatch.setenv("CRDT_TPU_PALLAS", "interpret")
    monkeypatch.delenv("CRDT_TPU_WIDE_STAGING", raising=False)
    monkeypatch.delenv(ref_packed._CHAIN_SPLIT_ENV, raising=False)


def _blob_cols(blobs):
    """The kernel columns of one decoded union (reference decode; the
    port's decode is held equal to it in tests/test_torch_replay.py)."""
    dec = ref_rp.decode(blobs)
    cols, _ = ref_rp.stage(dec)
    return cols


def _assert_same_plan(got, want):
    assert got is not None and want is not None
    assert got._fields == want._fields
    for name in want._fields:
        a, b = getattr(got, name), getattr(want, name)
        if isinstance(b, np.ndarray):
            assert isinstance(a, np.ndarray), name
            assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
            assert np.array_equal(a, b), name
        elif b is None:
            assert a is None, name
        elif name == "dev":
            assert len(a) == len(b), name
            for x, y in zip(a, b):
                assert np.array_equal(np.asarray(x), np.asarray(y)), name
                assert np.asarray(x).dtype == np.asarray(y).dtype, name
        else:
            assert a == b, name


def _assert_same_result(got, want):
    for name in ("win_rows", "stream_seg", "stream_row"):
        a, b = getattr(got, name), getattr(want, name)
        assert np.array_equal(np.asarray(a), np.asarray(b)), name
    assert tuple(got.hard_rows) == tuple(want.hard_rows)


def _packed_cases():
    # (id, columns builder) — builders run inside the test
    n = 600
    seq_heavy = _cols(n, clients=np.ones(n), seq=True)
    seq_heavy["key_id"][:8] = 0
    hilo = _cols(6, clients=np.ones(6))
    hilo["origin_client"][3] = 1  # self-referential origin: hi/lo
    hilo["origin_clock"][3] = 3
    return [
        ("tiny_map", lambda: _cols(8)),
        ("wide_clock", lambda: _cols(8, clock_base=1 << 33)),
        ("seq_chain", lambda: _cols(200, clients=np.ones(200), seq=True)),
        ("seq_heavy_map_bucket", lambda: seq_heavy),
        ("interned_clients", lambda: _cols(3, clients=np.array([900, 5, 37]))),
        ("hilo_self_origin", lambda: hilo),
        ("boundary_small", lambda: _blob_cols(boundary_blobs(0))),
        ("boundary_i16_edge",
         lambda: _blob_cols(boundary_blobs((1 << 15) - 10))),
        ("boundary_i31_edge",
         lambda: _blob_cols(boundary_blobs((1 << 31) - 10))),
        ("ties_i16_edge",
         lambda: _blob_cols(sort_diet_blobs((1 << 15) - 8, tie=True))),
        ("ties_i31_edge",
         lambda: _blob_cols(sort_diet_blobs((1 << 31) - 8, tie=True))),
        ("subtree_seed0", lambda: _blob_cols(conflict_trace(seed=0))),
        ("subtree_cycles", lambda: _blob_cols(
            conflict_trace(seed=3, cycles=True))),
    ]


CASES = _packed_cases()


class TestStaging:
    @pytest.mark.parametrize("case", [c[1] for c in CASES],
                             ids=[c[0] for c in CASES])
    @pytest.mark.parametrize("wide", [None, True])
    def test_plan_equals_reference(self, case, wide):
        cols = case()
        _assert_same_plan(staging.stage(cols, wide=wide),
                          ref_packed.stage(cols, wide=wide))

    @pytest.mark.parametrize("width", ["1", "13", None])
    @pytest.mark.parametrize("seed", [1, 2])
    def test_chain_split_widths(self, width, seed, monkeypatch):
        if width is not None:
            monkeypatch.setenv(ref_packed._CHAIN_SPLIT_ENV, width)
        cols = _blob_cols(conflict_trace(seed=seed, rights=False))
        got, want = staging.stage(cols), ref_packed.stage(cols)
        _assert_same_plan(got, want)
        if width == "1":
            assert got.seam_rows  # the split really cut

    def test_eager_put_seam(self):
        # stage(put=...) ships the three section groups as they finish;
        # an identity put exposes exactly what each side ships
        cols = _blob_cols(boundary_blobs(0, R=8, K=30))
        got = staging.stage(cols, put=lambda a: a)
        want = ref_packed.stage(cols, put=lambda a: a)
        assert got.mat is None and len(got.dev) == 3
        _assert_same_plan(got, want)

    @pytest.mark.parametrize("mutate", ["empty", "key_bound", "clock_bound"])
    def test_bound_fallbacks_agree(self, mutate):
        cols = _cols(4)
        if mutate == "empty":
            cols["valid"][:] = False
        elif mutate == "key_bound":
            cols["key_id"][:] = 1 << staging._KID_BITS
        else:
            cols["clock"][:] = 1 << 40
        assert staging.stage(cols) is None
        assert ref_packed.stage(cols) is None


class TestConverge:
    @pytest.mark.parametrize("case", [c[1] for c in CASES],
                             ids=[c[0] for c in CASES])
    def test_carried_plan_converges_identically(self, case):
        cols = case()
        ref_plan = ref_packed.stage(cols)
        carried = packed.plan_from_reference(ref_plan._asdict())
        got = packed.converge(carried, device="cpu")
        want = ref_packed.converge(ref_plan)
        _assert_same_result(got, want)

    @pytest.mark.parametrize("width", ["1", "13"])
    def test_split_plans_converge_identically(self, width, monkeypatch):
        monkeypatch.setenv(ref_packed._CHAIN_SPLIT_ENV, width)
        cols = _blob_cols(conflict_trace(seed=0, rights=False))
        want = ref_packed.converge(ref_packed.stage(cols))
        got = packed.converge(staging.stage(cols), device="cpu")
        _assert_same_result(got, want)

    def test_eager_plan_converges_like_matrix_plan(self):
        cols = _blob_cols(boundary_blobs(0, R=8, K=30))
        put = lambda a: torch.from_numpy(a)  # noqa: E731
        got = packed.converge(staging.stage(cols, put=put), device="cpu")
        want = ref_packed.converge(ref_packed.stage(cols))
        _assert_same_result(got, want)

    def test_widening_prelude_is_exact(self):
        # every encoding kind decodes to the staged int32 values
        rng = np.random.default_rng(3)
        vals = [
            np.r_[-1, rng.integers(0, 1 << 15, 40)],          # i16
            np.r_[rng.integers(-1, 200, 41)],                  # d16 refs
            np.r_[-1, rng.integers(-(1 << 31), 1 << 31, 40)],  # hilo
        ]
        named = [("seq_seg", vals[0].astype(np.int64)),
                 ("seq_parent", vals[1].astype(np.int64)),
                 ("seg_off", vals[2].astype(np.int64))]
        for wide in (False, True):
            flat, encs, _ = staging._encode_sections(named, wide)
            secs = packed._decode_sections(
                torch.from_numpy(flat), [41, 41, 41], encs)
            for (_, want), got in zip(named, secs):
                assert got.dtype == torch.int32
                assert np.array_equal(got.numpy(), want.astype(np.int32))

    def test_plan_from_reference_rejects_eager_plans(self):
        cols = _cols(8)
        fields = ref_packed.stage(cols)._asdict()
        fields["mat"] = None
        with pytest.raises(ValueError):
            packed.plan_from_reference(fields)
        fields = ref_packed.stage(cols)._asdict()
        del fields["seq_back"]
        with pytest.raises(ValueError):
            packed.plan_from_reference(fields)

    def test_replay_converge_uses_eager_seam_above_threshold(
            self, monkeypatch):
        # the 1.6M-op replay ships eagerly; exercise that branch small
        blobs = boundary_blobs(0, R=8, K=30)
        dec = rp.decode(blobs)
        cols, _ = rp.stage(dec)
        want = rp.converge(cols, device="cpu")[1]
        monkeypatch.setattr(staging, "EAGER_PUT_MIN_ROWS", 1)
        got = rp.converge(cols, device="cpu")[1]
        _assert_same_result(got, want)
