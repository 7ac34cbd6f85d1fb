"""The port's kernels (crdt_tpu_torch.ops.kernels) on the CPU.

On a CPU tensor each wrapper runs its plain PyTorch version; these
tests hold that plain version against the reference's Pallas kernel in
interpret mode and against its jnp oracle, position by position, with
exact integer equality: random run layouts, ties, padding tails,
dropped (negative, past-the-end) scatter targets, disjoint and
overlapping delete ranges, and state vectors on both sides of the
reference deficit kernel's 2**31 envelope. The CUDA kernels themselves
are held against the same plain versions on the card by
``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from crdt_tpu.ops import deleteset as ref_ds
from crdt_tpu.ops import pallas_kernels as pk
from crdt_tpu.ops import statevec as ref_sv
from crdt_tpu_torch.ops import _build, kernels


def _run_layout(rng, n, runs):
    """Random (client, flags) with ``runs`` run-start positions."""
    client = rng.integers(0, 1 << 14, n).astype(np.int32)
    flags = np.zeros(n, np.int32)
    flags[0] = 1
    if runs > 1:
        starts = rng.choice(np.arange(1, n), size=min(runs - 1, n - 1),
                            replace=False)
        flags[starts] = 1
    return client, flags


def _scan_all(client: np.ndarray, flags: np.ndarray):
    """(port wrapper on CPU, reference interpret kernel, jnp oracle)."""
    got = kernels.seg_argmax_scan(torch.from_numpy(client),
                                  torch.from_numpy(flags)).numpy()
    interp = np.asarray(pk.seg_argmax_scan(
        jnp.asarray(client), jnp.asarray(flags), mode="interpret"))
    oracle = np.asarray(pk.seg_argmax_scan_jnp(
        jnp.asarray(client), jnp.asarray(flags)))
    return got, interp, oracle


def _scatter_all(pos: np.ndarray, n_out: int):
    got = kernels.stream_scatter(torch.from_numpy(pos), n_out).numpy()
    interp = np.asarray(pk.stream_scatter(
        jnp.asarray(pos), n_out, mode="interpret"))
    oracle = np.asarray(pk.stream_scatter_jnp(jnp.asarray(pos), n_out))
    return got, interp, oracle


class TestSegArgmaxScan:
    @pytest.mark.parametrize("n,runs", [
        (1, 1),             # single row
        (7, 7),             # every row its own run
        (128, 1),           # one whole run
        (1000, 37),         # ragged length, random runs
        (8 * 128 + 3, 96),  # past one sublane tile, ragged
        (2049, 5),          # past one CUDA tile, runs span tiles
    ])
    def test_matches_reference(self, n, runs):
        rng = np.random.default_rng(n * 1000 + runs)
        client, flags = _run_layout(rng, n, runs)
        got, interp, oracle = _scan_all(client, flags)
        assert got.dtype == np.int32
        assert (got == interp).all()
        assert (got == oracle).all()

    def test_ties_keep_earlier_position(self):
        rng = np.random.default_rng(5)
        client = rng.integers(0, 3, 700).astype(np.int32)
        flags = (rng.random(700) < 0.05).astype(np.int32)
        flags[0] = 1
        got, interp, oracle = _scan_all(client, flags)
        assert (got == interp).all() and (got == oracle).all()
        # all-equal run: every position keeps the run's first row
        got, _, oracle = _scan_all(np.full(9, 5, np.int32),
                                   np.r_[1, np.zeros(8, np.int32)].astype(
                                       np.int32))
        assert (got == 0).all() and (oracle == 0).all()

    def test_padding_tail_forms_own_runs(self):
        # the map block's padding: client -1, each its own run
        rng = np.random.default_rng(8)
        client, flags = _run_layout(rng, 300, 20)
        client[250:] = -1
        flags[250:] = 1
        got, interp, oracle = _scan_all(client, flags)
        assert (got == interp).all() and (got == oracle).all()
        assert (got[250:] == np.arange(250, 300)).all()

    def test_nonbinary_flags_and_no_opening_flag(self):
        # any nonzero flag opens a run; position 0 needs no flag
        rng = np.random.default_rng(9)
        client, _ = _run_layout(rng, 500, 1)
        flags = (rng.random(500) < 0.1).astype(np.int32) * 3
        flags[0] = 0
        got, _, oracle = _scan_all(client, flags)
        assert (got == oracle).all()

    def test_run_boundaries_isolate(self):
        client = np.asarray([999, 1, 3, 2], np.int32)
        flags = np.asarray([1, 0, 1, 0], np.int32)
        got, interp, _ = _scan_all(client, flags)
        assert list(got) == list(interp) == [0, 0, 2, 2]

    def test_empty(self):
        out = kernels.seg_argmax_scan(torch.zeros(0, dtype=torch.int32),
                                      torch.zeros(0, dtype=torch.int32))
        assert out.shape == (0,)

    @settings(max_examples=20, deadline=None, derandomize=True)
    @given(data=st.data())
    def test_plain_matches_the_oracle_across_card_tiles_hypothesis(self,
                                                                   data):
        # one shape (4,500 rows: past four of the card's 1,024-row tiles)
        # keeps one compiled oracle; runs as long as the whole block or a
        # few rows, clients over all of int32 or a few values (ties),
        # and a padding tail of own-run -1 rows vary
        n = 4500
        rng = np.random.default_rng(data.draw(st.integers(0, 2**32 - 1)))
        lo, hi = data.draw(st.sampled_from([(-2**31, 2**31), (0, 3)]))
        client = rng.integers(lo, hi, n, dtype=np.int64).astype(np.int32)
        rate = data.draw(st.sampled_from([0.0, 1e-3, 0.05, 0.5]))
        flags = (rng.random(n) < rate).astype(np.int32)
        flags[0] = data.draw(st.integers(0, 1))
        pad = data.draw(st.integers(0, 2100))
        if pad:
            client[n - pad:] = -1
            flags[n - pad:] = 1
        got = kernels.seg_argmax_scan(torch.from_numpy(client),
                                      torch.from_numpy(flags)).numpy()
        oracle = np.asarray(pk.seg_argmax_scan_jnp(jnp.asarray(client),
                                                   jnp.asarray(flags)))
        assert (got == oracle).all()


class TestStreamScatter:
    @pytest.mark.parametrize("n", [1, 5, 128, 700, 8 * 128 + 9])
    def test_permutation_round_trip(self, n):
        rng = np.random.default_rng(n)
        pos = rng.permutation(n).astype(np.int32)
        got, interp, oracle = _scatter_all(pos, n)
        assert (got == interp).all() and (got == oracle).all()
        assert (np.sort(got) == np.arange(n)).all()

    def test_dropped_targets_and_holes(self):
        # -1 (invalid) and past-the-end targets drop; a negative target
        # never wraps to the last slot
        pos = np.asarray([3, -1, 0, 99, 5, -8], np.int32)
        got, interp, oracle = _scatter_all(pos, 8)
        assert (got == interp).all() and (got == oracle).all()
        assert got[3] == 0 and got[0] == 2 and got[5] == 4
        assert (got[[1, 2, 4, 6, 7]] == -1).all()

    @pytest.mark.parametrize("n_in,n_out", [(50, 20), (20, 50), (0, 4),
                                            (4, 0)])
    def test_output_width_differs(self, n_in, n_out):
        rng = np.random.default_rng(n_in * 7 + n_out)
        pos = rng.permutation(max(n_in, 1))[:n_in].astype(np.int32)
        got, _, oracle = _scatter_all(pos, n_out)
        assert got.shape == (n_out,)
        assert (got == oracle).all()


class TestWrappers:
    def test_cpu_tensor_takes_plain_version_without_launching(self):
        kernels.reset_launches()
        client = torch.arange(10, dtype=torch.int32)
        flags = torch.ones(10, dtype=torch.int32)
        assert torch.equal(kernels.seg_argmax_scan(client, flags),
                           kernels.seg_argmax_scan_plain(client, flags))
        assert torch.equal(kernels.stream_scatter(client, 10),
                           kernels.stream_scatter_plain(client, 10))
        d = torch.tensor([2], dtype=torch.int32)
        assert torch.equal(
            kernels.ds_mask(client, client.long(), flags > 0, d, d, d + 1),
            kernels.ds_mask_plain(client, client.long(), flags > 0, d, d,
                                  d + 1))
        svs = torch.arange(12, dtype=torch.int64).reshape(3, 4)
        assert torch.equal(kernels.sv_deficit(svs),
                           kernels.sv_deficit_plain(svs))
        assert kernels.launch_counts() == {
            "seg_argmax_scan": 0, "stream_scatter": 0, "ds_mask": 0,
            "sv_deficit": 0,
        }

    @pytest.mark.parametrize("offset", [0, 1, 2, 3, 4])
    def test_aligned16_gives_an_aligned_equal_tensor(self, offset):
        # the kernels' 16-byte loads: a view at an odd offset comes back
        # as an aligned copy, an aligned tensor as itself
        base = torch.arange(40, dtype=torch.int32)
        assert base.data_ptr() % 16 == 0
        view = base[offset:offset + 33]
        got = kernels.aligned16(view)
        assert got.data_ptr() % 16 == 0
        assert torch.equal(got, view)
        assert (got.data_ptr() == view.data_ptr()) == (offset % 4 == 0)
        strided = kernels.aligned16(base[offset::3])
        assert strided.is_contiguous() and strided.data_ptr() % 16 == 0
        assert torch.equal(strided, base[offset::3])

    def test_odd_offset_views_take_the_same_answer(self):
        # what the card wrapper hands its kernel for a view, the plain
        # version answers alike
        rng = np.random.default_rng(12)
        client, flags = _run_layout(rng, 301, 9)
        c, f = torch.from_numpy(client), torch.from_numpy(flags)
        want = kernels.seg_argmax_scan(c[1:].clone(), f[1:].clone())
        assert torch.equal(kernels.seg_argmax_scan(c[1:], f[1:]), want)
        assert torch.equal(
            kernels.seg_argmax_scan(kernels.aligned16(c[1:]),
                                    kernels.aligned16(f[1:])), want)
        pos = torch.from_numpy(rng.permutation(300).astype(np.int32))
        assert torch.equal(kernels.stream_scatter(pos[1:], 300),
                           kernels.stream_scatter(pos[1:].clone(), 300))

    def test_build_name_covers_sources_and_headers(self, tmp_path,
                                                   monkeypatch):
        # an edited header (or source) names another library, so a
        # stale build is never loaded; no nvcc needed
        monkeypatch.setattr(_build, "CSRC", tmp_path)
        for name, (src, _) in _build.KERNELS.items():
            (tmp_path / src).write_text(f"// {name}\n")
        (tmp_path / "lookback.cuh").write_text("// v1\n")
        before = {name: _build._target(name) for name in _build.KERNELS}
        (tmp_path / "lookback.cuh").write_text("// v2\n")
        after = {name: _build._target(name) for name in _build.KERNELS}
        assert all(before[k] != after[k] for k in before)
        assert all(p.name.startswith(f"lib{k}-") for k, p in after.items())
        (tmp_path / "extra.cuh").write_text("// new header\n")
        assert _build._target("ds_mask") != after["ds_mask"]
        (tmp_path / "extra.cuh").unlink()
        assert _build._target("ds_mask") == after["ds_mask"]
        (tmp_path / "ds_mask.cu").write_text("// edited\n")
        assert _build._target("ds_mask") != after["ds_mask"]
        assert _build._target("sv_deficit") == after["sv_deficit"]

    @pytest.mark.parametrize("bad", [
        torch.zeros(4, dtype=torch.int64),
        torch.zeros((2, 2), dtype=torch.int32),
    ])
    def test_rejects_wrong_dtype_or_rank(self, bad):
        with pytest.raises(ValueError):
            kernels.seg_argmax_scan(bad, bad)
        with pytest.raises(ValueError):
            kernels.stream_scatter(bad, 4)


def _items(rng, n, base, clients=6):
    """[N] item columns: clients (some -1), clocks from ``base``, and a
    random valid mask."""
    client = rng.integers(-1, clients, n).astype(np.int32)
    clock = (base + rng.integers(0, 400, n)).astype(np.int64)
    valid = rng.random(n) < 0.8
    return client, clock, valid


def _ranges(rng, d, base, clients=6, *, disjoint, nulls=0):
    """[D] delete ranges (client, start, end), shuffled, plus ``nulls``
    null fillers (-1, -1, -1). Disjoint ranges are cut per client from
    one sorted set of breakpoints; overlapping ones are random, nested
    and crossing ones included."""
    if disjoint:
        rc = rng.integers(0, clients, d)
        rs = np.empty(d, np.int64)
        re = np.empty(d, np.int64)
        for c in np.unique(rc):
            idx = np.flatnonzero(rc == c)
            pts = np.sort(rng.choice(np.arange(0, 800), 2 * len(idx),
                                     replace=False))
            rs[idx] = base + pts[0::2]
            re[idx] = base + pts[1::2]
    else:
        rc = rng.integers(0, clients, d)
        rs = base + rng.integers(0, 400, d)
        re = rs + rng.integers(0, 120, d)
    perm = rng.permutation(d)
    cols = [np.r_[x[perm], np.full(nulls, -1)].astype(t)
            for x, t in ((rc, np.int32), (rs, np.int64), (re, np.int64))]
    return tuple(cols)


def _mask_all(items, ranges):
    """(port wrapper on CPU, reference interpret kernel, reference jnp
    search)."""
    client, clock, valid = items
    dc, ds_, de = ranges
    t = [torch.from_numpy(np.asarray(x)) for x in (*items, *ranges)]
    got = kernels.ds_mask(*t).numpy()
    j = [jnp.asarray(x) for x in (*items, *ranges)]
    interp = np.asarray(pk.ds_mask_static(*j, interpret=True))
    search = np.asarray(ref_ds.apply_mask_static(*j, mode="jnp"))
    return got, interp, search


class TestDsMask:
    @pytest.mark.parametrize("n,d,base", [
        (1, 1, 0),
        (300, 5, 0),
        (1000, 64, 1 << 31),         # at the reference's crossover
        (1000, 65, (1 << 31) - 200),  # past it, clocks around 2**31
        (2049, 300, (1 << 40) - 2000),  # clocks near the packing bound
    ])
    def test_disjoint_ranges_match_both_reference_paths(self, n, d, base):
        rng = np.random.default_rng(n + d)
        items = _items(rng, n, base)
        ranges = _ranges(rng, d, base, disjoint=True, nulls=7)
        got, interp, search = _mask_all(items, ranges)
        assert got.dtype == np.bool_
        assert (got == interp).all()
        assert (got == search).all()
        if n > 100:
            assert got.any() and not got.all()

    @pytest.mark.parametrize("d,base", [(3, 0), (40, 1 << 33), (200, 0)])
    def test_overlapping_ranges_match_the_dense_kernel(self, d, base):
        # overlapping and nested ranges: the port keeps the TPU
        # kernel's dense meaning (ROADMAP.md section C)
        rng = np.random.default_rng(d)
        items = _items(rng, 1500, base)
        ranges = _ranges(rng, d, base, disjoint=False, nulls=3)
        got, interp, _ = _mask_all(items, ranges)
        assert (got == interp).all()

    def test_nested_range_the_search_path_misses(self):
        # one long range covering a short later one: the reference's
        # binary search looks only at the last range starting at or
        # before the clock, so it misses clock 8; the dense kernel and
        # the port mark it
        items = (np.asarray([1, 1, 1], np.int32),
                 np.asarray([2, 6, 8], np.int64), np.ones(3, bool))
        ranges = (np.asarray([1, 1], np.int32), np.asarray([0, 5], np.int64),
                  np.asarray([10, 7], np.int64))
        got, interp, search = _mask_all(items, ranges)
        assert list(got) == list(interp) == [True, True, True]
        assert list(search) == [True, True, False]

    def test_no_ranges_and_all_null_ranges(self):
        rng = np.random.default_rng(3)
        client, clock, valid = _items(rng, 200, 0)
        t = [torch.from_numpy(x) for x in (client, clock, valid)]
        empty = torch.zeros(0, dtype=torch.int64)
        assert not kernels.ds_mask(*t, empty.int(), empty, empty).any()
        null = torch.full((512,), -1, dtype=torch.int64)
        assert not kernels.ds_mask(*t, null.int(), null, null).any()

    @pytest.mark.parametrize("layout", [
        "fleet",             # normalized set in search order, nulls last
        "in_order_nested",   # search order, overlapping and nested
        "shuffled",          # the same disjoint set, any order
        "duplicates",        # every range twice, shuffled
        "duplicates_in_order",
        "all_null",
    ])
    def test_range_layouts_match_the_reference(self, layout):
        # the layouts the card's preparation tells apart (taken as given
        # or sorted on the device) give the reference kernel's answer
        rng = np.random.default_rng(len(layout))
        items = _items(rng, 1200, 1 << 33)
        disjoint = "nested" not in layout
        dc, ds_, de = _ranges(rng, 90, 1 << 33, disjoint=disjoint)
        if layout.startswith("duplicates"):
            dc, ds_, de = (np.r_[x, x] for x in (dc, ds_, de))
            order = rng.permutation(len(dc))
            dc, ds_, de = dc[order], ds_[order], de[order]
        if layout == "all_null":
            dc, ds_, de = (np.full(64, -1, x.dtype) for x in (dc, ds_, de))
        if layout in ("fleet", "in_order_nested", "duplicates_in_order"):
            order = np.lexsort((ds_, dc))
            dc, ds_, de = dc[order], ds_[order], de[order]
        nulls = 13 if layout in ("fleet", "in_order_nested") else 0
        ranges = tuple(np.r_[x, np.full(nulls, -1)].astype(x.dtype)
                       for x in (dc, ds_, de))
        got, interp, search = _mask_all(items, ranges)
        assert (got == interp).all()
        if disjoint:
            assert (got == search).all()
        if layout != "all_null":
            assert got.any() and not got.all()
        else:
            assert not got.any()

    def test_ranges_in_search_order_are_not_sorted(self, monkeypatch):
        # the in-order branch never reaches the sort; shuffled ranges do
        def no_sort(keys):
            raise AssertionError("lexsort called")

        monkeypatch.setattr(kernels, "lexsort", no_sort)
        rng = np.random.default_rng(11)
        items = [torch.from_numpy(x) for x in _items(rng, 500, 0)]
        dc, ds_, de = _ranges(rng, 40, 0, disjoint=False, nulls=5)
        order = np.lexsort((ds_, dc.astype(np.int64) & 0xFFFFFFFFFFFF))
        ranges = [torch.from_numpy(x[order]) for x in (dc, ds_, de)]
        assert (dc[order][-5:] == -1).all()  # nulls last in search order
        kernels.ds_mask_plain(*items, *ranges)
        rc, rs, run_max = kernels.ds_sorted_ranges(*ranges)
        assert torch.equal(rs, ranges[1].long())
        shuffled = [r.flip(0) for r in ranges]
        with pytest.raises(AssertionError, match="lexsort called"):
            kernels.ds_mask_plain(*items, *shuffled)

    @settings(max_examples=20, deadline=None, derandomize=True)
    @given(data=st.data())
    def test_matches_the_reference_kernel_hypothesis(self, data):
        # fixed shapes (64 items, 16 ranges) keep one compiled
        # reference; clients, clocks, lengths, nulls and the order vary
        small = st.integers(0, 40)
        rc = np.asarray(data.draw(st.lists(st.integers(-1, 3), min_size=16,
                                           max_size=16)), np.int32)
        rs = np.asarray(data.draw(st.lists(small, min_size=16,
                                           max_size=16)), np.int64)
        re = rs + np.asarray(data.draw(st.lists(st.integers(0, 12),
                                                min_size=16, max_size=16)))
        if data.draw(st.booleans()):  # search order: nulls last
            order = np.lexsort((rs, rc.astype(np.uint32)))
            rc, rs, re = rc[order], rs[order], re[order]
        base = data.draw(st.sampled_from([0, (1 << 31) - 20, 1 << 40]))
        items = (np.asarray(data.draw(st.lists(st.integers(-1, 3),
                                               min_size=64, max_size=64)),
                            np.int32),
                 base + np.asarray(data.draw(st.lists(
                     small, min_size=64, max_size=64)), np.int64),
                 np.asarray(data.draw(st.lists(st.booleans(), min_size=64,
                                               max_size=64))))
        got, interp, _ = _mask_all(items, (rc, base + rs, base + re))
        assert (got == interp).all()

    def test_sorted_ranges_running_max(self):
        dc = torch.tensor([2, 1, 1, 2, 1], dtype=torch.int32)
        ds_ = torch.tensor([0, 9, 0, 5, 3], dtype=torch.int64)
        de = torch.tensor([8, 10, 20, 6, 4], dtype=torch.int64)
        rc, rs, run_max = kernels.ds_sorted_ranges(dc, ds_, de)
        assert rc.tolist() == [1, 1, 1, 2, 2]
        assert rs.tolist() == [0, 3, 9, 0, 5]
        assert run_max.tolist() == [20, 20, 20, 8, 8]


def _svs(rng, r, c, base, spread):
    return (base + rng.integers(0, spread, (r, c))).astype(np.int64)


class TestSvDeficit:
    @pytest.mark.parametrize("r,c", [(1, 1), (7, 3), (9, 128), (64, 130),
                                     (65, 5)])
    def test_inside_the_reference_envelope(self, r, c):
        # summed column spread < 2**31: the reference's i32 tiles run
        rng = np.random.default_rng(r * 1000 + c)
        svs = _svs(rng, r, c, 1 << 40, 1000)
        got = kernels.sv_deficit(torch.from_numpy(svs)).numpy()
        interp = np.asarray(pk.sv_deficit_static(jnp.asarray(svs),
                                                 interpret=True))
        exact = np.asarray(ref_sv.exact_missing(jnp.asarray(svs)))
        assert got.dtype == np.int64
        assert (got == interp).all() and (got == exact).all()

    @pytest.mark.parametrize("r,c", [(5, 3), (33, 40)])
    def test_past_the_reference_envelope(self, r, c):
        # one replica lags the rest by ~2**31 clocks: the reference
        # takes its exact fallback, the port's int64 sum needs none
        rng = np.random.default_rng(r + c)
        svs = _svs(rng, r, c, 0, 50)
        svs[0] += 1 << 32
        got = kernels.sv_deficit(torch.from_numpy(svs)).numpy()
        interp = np.asarray(pk.sv_deficit_static(jnp.asarray(svs),
                                                 interpret=True))
        assert (got == interp).all()
        assert got[0].max() >= 1 << 32

    def test_zero_and_identical_rows(self):
        svs = np.zeros((6, 4), np.int64)
        svs[3:] = [5, 0, 7, 1]
        got = kernels.sv_deficit(torch.from_numpy(svs)).numpy()
        exact = np.asarray(ref_sv.exact_missing(jnp.asarray(svs)))
        assert (got == exact).all()
        assert (np.diag(got) == 0).all() and got[3, 0] == 13

    @pytest.mark.parametrize("r,c,row,col,delta", [
        (45, 70, 40, 35, 1 << 24),          # just past the int32 envelope
        (45, 70, 3, 64, -(1 << 24) - 1),    # below it, in a ragged chunk
        (45, 70, 31, 10, (1 << 24) - 1),    # at its edge: stays int32
        (33, 40, 32, 0, 1 << 33),           # past the reference's 2**31
    ])
    def test_plain_where_a_card_chunk_straddles_the_envelope(
            self, r, c, row, col, delta):
        # the plain version (these tensors lie on the CPU) on inputs
        # where one staged chunk of the card kernel (32 clients of a
        # 32-row tile pair) leaves its int32 envelope of 2**24 around
        # its tile pair's first row; R is no multiple of the tile. The
        # card kernel's int64 branch itself is held against the plain
        # version by chip_smoke.py's sv_edge_cases.
        rng = np.random.default_rng(r + c + row)
        svs = _svs(rng, r, c, 1 << 40, 300)
        svs[row, col] = svs[(row // 32) * 32, col] + delta
        got = kernels.sv_deficit(torch.from_numpy(svs)).numpy()
        interp = np.asarray(pk.sv_deficit_static(jnp.asarray(svs),
                                                 interpret=True))
        exact = np.asarray(ref_sv.exact_missing(jnp.asarray(svs)))
        assert (got == interp).all() and (got == exact).all()

    @settings(max_examples=20, deadline=None, derandomize=True)
    @given(st.lists(st.integers(0, 60), min_size=45, max_size=45),
           st.sampled_from([0, 1 << 20, 1 << 24, 1 << 33]),
           st.integers(0, 44), st.integers(-(1 << 40), 1 << 40))
    def test_plain_matches_exact_missing_hypothesis(self, vals, spread, at,
                                                    base):
        # the plain version on [9, 5] clocks at any int64 base, one cell
        # lagging or leading by up to 2**33
        svs = base + np.asarray(vals, np.int64).reshape(9, 5)
        svs.flat[at] += spread
        got = kernels.sv_deficit(torch.from_numpy(svs)).numpy()
        exact = np.asarray(ref_sv.exact_missing(jnp.asarray(svs)))
        assert (got == exact).all()

    def test_plain_chunks_rows(self, monkeypatch):
        monkeypatch.setattr(kernels, "_SV_PLAIN_TERMS", 7)
        rng = np.random.default_rng(4)
        svs = _svs(rng, 11, 3, 0, 30)
        got = kernels.sv_deficit_plain(torch.from_numpy(svs)).numpy()
        exact = np.asarray(ref_sv.exact_missing(jnp.asarray(svs)))
        assert (got == exact).all()
