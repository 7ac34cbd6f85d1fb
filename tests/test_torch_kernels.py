"""The port's converge kernels (crdt_tpu_torch.ops.kernels) on the CPU.

On a CPU tensor each wrapper runs its plain PyTorch version; these
tests hold that plain version against the reference's Pallas kernel in
interpret mode and against its jnp oracle, position by position, with
exact int32 equality: random run layouts, ties, padding tails, and
dropped (negative, past-the-end) scatter targets. The CUDA kernels
themselves are held against the same plain versions on the card by
``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_tpu.ops import pallas_kernels as pk
from crdt_tpu_torch.ops import kernels


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
        assert kernels.launch_counts() == {
            "seg_argmax_scan": 0, "stream_scatter": 0,
        }

    @pytest.mark.parametrize("bad", [
        torch.zeros(4, dtype=torch.int64),
        torch.zeros((2, 2), dtype=torch.int32),
    ])
    def test_rejects_wrong_dtype_or_rank(self, bad):
        with pytest.raises(ValueError):
            kernels.seg_argmax_scan(bad, bad)
        with pytest.raises(ValueError):
            kernels.stream_scatter(bad, 4)
