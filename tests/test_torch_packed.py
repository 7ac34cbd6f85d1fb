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


# ---------------------------------------------------------------------------
# the incremental device round: splice + select + _converge_core
# ---------------------------------------------------------------------------


def _resident_rows(blobs):
    """A decoded union as the live replica's resident columns: dense
    client ids, root parent refs, key ids, dense origin clients (-1
    none) — what ``IncrementalReplay._dispatch_round`` stages."""
    dec = ref_rp.decode(blobs)
    clients = np.unique(np.concatenate([
        dec["client"], dec["origin_client"][dec["origin_client"] >= 0]]))
    oc = dec["origin_client"]
    return dict(
        client=np.searchsorted(clients, dec["client"]),
        clock=dec["clock"].astype(np.int64),
        pref=dec["parent_root"].astype(np.int64),
        kid=dec["key_id"].astype(np.int64),
        oc=np.where(oc >= 0, np.searchsorted(clients, np.maximum(oc, 0)),
                    -1),
        ock=dec["origin_clock"].astype(np.int64),
    )


def _delta_of(rows, lo, hi, kpad, extra_segs=()):
    cols = {k: v[lo:hi] for k, v in rows.items()}
    segs = staging.segkey_of(cols["pref"], cols["kid"])
    touched = np.unique(np.concatenate([segs, np.asarray(extra_segs,
                                                         np.int64)]))
    args = (cols["client"], cols["clock"], cols["pref"], cols["kid"],
            cols["oc"], cols["ock"], touched, kpad)
    got = packed.stage_resident_delta(*args)
    want = ref_packed.stage_resident_delta(*args)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    return got, touched


class TestIncrementalRound:
    @pytest.mark.parametrize("seed,map_frac", [(0, 0.6), (5, 0.2)])
    def test_two_deltas_over_a_resident_base(self, seed, map_frac):
        import jax.numpy as jnp

        import bench
        from crdt_tpu.compat import enable_x64

        rows = _resident_rows(bench.build_trace(6, 24, seed=seed,
                                                map_frac=map_frac))
        n = len(rows["client"])
        cuts = [0, n * 3 // 5, n * 4 // 5, n]
        S, cap = 1 << 10, 1 << 12
        got_mat = packed.new_resident_mat(cap, "cpu")
        with enable_x64(True):
            ref_mat = jnp.zeros((7, cap), jnp.int64).at[3:6, :].set(-1)
        base_segs = staging.segkey_of(rows["pref"][:cuts[1]],
                                      rows["kid"][:cuts[1]])
        for step, (lo, hi) in enumerate(zip(cuts[:-1], cuts[1:])):
            # each later delta also re-converges one base-only segment
            extra = base_segs[:1] if step else ()
            delta, touched = _delta_of(rows, lo, hi, S, extra)
            seg_all = staging.segkey_of(rows["pref"][:hi],
                                        rows["kid"][:hi])
            n_sel = int(np.isin(seg_all, touched).sum())
            sel_bucket = min(8192 if n_sel <= 8192 else 65536, cap)
            kw = dict(num_segments=S, sel_bucket=sel_bucket,
                      seq_bucket=sel_bucket, rank_rounds=None,
                      map_rounds=None)
            got = packed._splice_select_converge(
                got_mat, torch.from_numpy(delta), lo, **kw).numpy()
            with enable_x64(True):
                ref_mat, want = ref_packed._splice_select_converge(
                    ref_mat, jnp.asarray(delta), jnp.int32(lo),
                    mode=ref_packed.kernel_mode_for(sel_bucket), **kw)
            want = np.asarray(want)
            assert got.dtype == want.dtype == np.int32
            b = sel_bucket
            for name, a, z in (("win_rows", 0, S), ("stream_seg", S, S + b),
                               ("stream_row", S + b, S + 2 * b),
                               ("sel_rows", S + 2 * b, S + 3 * b)):
                np.testing.assert_array_equal(got[a:z], want[a:z],
                                              err_msg=f"step {step} {name}")
            assert got.shape == want.shape
            np.testing.assert_array_equal(got_mat.numpy(),
                                          np.asarray(ref_mat))
            assert (got[S + 2 * b:] >= 0).sum() == n_sel

    def test_delta_past_the_matrix_raises(self):
        mat = packed.new_resident_mat(512, "cpu")
        delta = torch.zeros((8, 64), dtype=torch.int64)
        with pytest.raises(ValueError, match="overflows"):
            packed._splice_select_converge(
                mat, delta, 500, num_segments=1024, sel_bucket=512,
                seq_bucket=512)

    def test_grow_mat(self):
        import jax.numpy as jnp

        from crdt_tpu.compat import enable_x64

        rng = np.random.default_rng(7)
        base = rng.integers(-1, 1 << 20, (7, 512)).astype(np.int64)
        got = packed._grow_mat(torch.from_numpy(base.copy()), 2048)
        with enable_x64(True):
            want = np.asarray(ref_packed._grow_mat(jnp.asarray(base),
                                                   new_cap=2048))
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            packed.new_resident_mat(512, "cpu").numpy(),
            np.asarray(ref_packed._grow_mat(
                jnp.zeros((7, 0), jnp.int64), new_cap=512)))

    def test_relabel_mat_in_place(self):
        import jax.numpy as jnp

        from crdt_tpu.compat import enable_x64

        rng = np.random.default_rng(9)
        base = rng.integers(0, 1 << 30, (7, 1024)).astype(np.int64)
        base[0] = rng.integers(0, 40, 1024)
        base[4] = rng.integers(-1, 40, 1024)
        perm = rng.permutation(40).astype(np.int32)
        mat = torch.from_numpy(base.copy())
        out = packed._relabel_mat(mat, torch.from_numpy(perm))
        assert out.data_ptr() == mat.data_ptr()  # in place
        with enable_x64(True):
            want = np.asarray(ref_packed._relabel_mat(jnp.asarray(base),
                                                      jnp.asarray(perm)))
        np.testing.assert_array_equal(mat.numpy(), want)

    @pytest.mark.parametrize("pref,kid", [(0, -1), (3, 0), (7, 5),
                                          ((1 << 25) - 1, (1 << 21) - 1)])
    def test_segkey_int(self, pref, kid):
        want = int(ref_packed.segkey_of(np.int64(pref), np.int64(kid)))
        assert staging.segkey_int(pref, kid) == want
        assert int(staging.segkey_of(np.int64(pref), np.int64(kid))) == want
        assert int(staging.segkey_of(torch.tensor(pref),
                                     torch.tensor(kid))) == want
