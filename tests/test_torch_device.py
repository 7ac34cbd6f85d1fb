"""The port's list ranking (crdt_tpu_torch.ops.device) against the
reference (crdt_tpu.ops.device), on the CPU.

The port runs a fixed number of doubling rounds where the reference
may exit a while-loop early at a fixpoint; the outputs must be
identical anyway, cyclic (hostile) inputs included. Inputs are made
with numpy from a seed and handed to both; tolerance is zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_tpu.compat import enable_x64
from crdt_tpu.ops import device as ref
from crdt_tpu_torch.ops import device as port


def _forest(rng, n, p_root=0.2):
    """Parent pointers of a random forest (parents precede children),
    terminals self-looping: the shape pointer_double climbs."""
    f = np.arange(n, dtype=np.int32)
    for i in range(1, n):
        if rng.random() >= p_root:
            f[i] = rng.integers(0, i)
    return f


def _cyclic(rng, n):
    """A forest with hostile cycles of lengths 2, 3 and 5 spliced in."""
    f = _forest(rng, n)
    for length, base in ((2, 0), (3, 10), (5, 20)):
        for j in range(length):
            f[base + j] = base + (j + 1) % length
    return f


class TestPointerDouble:
    @pytest.mark.parametrize("seed,n", [(0, 1), (1, 2), (2, 37), (3, 512),
                                        (4, 3000)])
    @pytest.mark.parametrize("max_iters", [None, 1, 3])
    def test_forest(self, seed, n, max_iters):
        f = _forest(np.random.default_rng(seed), n)
        want = np.asarray(ref.pointer_double(jnp.asarray(f),
                                             max_iters=max_iters))
        got = port.pointer_double(torch.from_numpy(f),
                                  max_iters=max_iters).numpy()
        assert (got == want).all()

    @pytest.mark.parametrize("seed", [0, 1, 2])
    @pytest.mark.parametrize("max_iters", [None, 2, 4, 64])
    def test_cyclic_input_matches_reference(self, seed, max_iters):
        # cycle members keep an in-cycle value; the fixed round count
        # lands on exactly the reference's early-exit value
        f = _cyclic(np.random.default_rng(seed), 200)
        want = np.asarray(ref.pointer_double(jnp.asarray(f),
                                             max_iters=max_iters))
        got = port.pointer_double(torch.from_numpy(f),
                                  max_iters=max_iters).numpy()
        assert (got == want).all()
        assert (got[:2] < 2).all() and (got[10:13] >= 10).all()

    def test_fixpoint_input_is_returned_unchanged(self):
        f = np.arange(16, dtype=np.int32)
        got = port.pointer_double(torch.from_numpy(f)).numpy()
        assert (got == f).all()


class TestWyllieDist:
    @pytest.mark.parametrize("seed,n", [(0, 1), (1, 9), (2, 400), (3, 2500)])
    def test_chains(self, seed, n):
        # successor = one random chain per node set; terminals self-loop
        rng = np.random.default_rng(seed)
        order = rng.permutation(n)
        succ = np.arange(n, dtype=np.int32)
        cut = rng.random(n) < 0.1
        for a, b in zip(order[:-1], order[1:]):
            if not cut[a]:
                succ[a] = b
        rounds = port._round_cap(n)
        with enable_x64(True):
            want = np.asarray(ref.wyllie_dist(jnp.asarray(succ),
                                              rounds=rounds))
        got = port.wyllie_dist(torch.from_numpy(succ), rounds).numpy()
        assert got.dtype == np.int32
        assert (got == want).all()

    def test_packed_word_keeps_high_pointers(self):
        # pointers past 2^16 exercise the 64-bit ~mask of the packed word
        n = 70_000
        succ = np.minimum(np.arange(n, dtype=np.int32) + 1, n - 1)
        got = port.wyllie_dist(torch.from_numpy(succ),
                               port._round_cap(n)).numpy()
        assert (got == (n - 1) - np.arange(n)).all()

    def test_cyclic_input(self):
        f = _cyclic(np.random.default_rng(7), 100)
        with enable_x64(True):
            want = np.asarray(ref.wyllie_dist(jnp.asarray(f), rounds=4))
        got = port.wyllie_dist(torch.from_numpy(f), 4).numpy()
        assert (got == want).all()


def _tree_tables(rng, B, S, n_dead):
    """Staging-shaped DFS inputs: B compact rows in S segments (the
    last ``n_dead`` rows are not items), parents within a segment,
    sibling order (parent, random key), first-child table over items
    and virtual roots."""
    seg = np.sort(rng.integers(0, S, B))
    item = np.ones(B, bool)
    if n_dead:
        item[-n_dead:] = False
    parent = np.empty(B, np.int32)
    for i in range(B):
        same = np.flatnonzero(item[:i] & (seg[:i] == seg[i]))
        if len(same) and rng.random() < 0.8:
            parent[i] = same[rng.integers(0, len(same))]
        else:
            parent[i] = B + seg[i]
    parent[~item] = B + S
    key = rng.permutation(B)
    order = np.lexsort((key, parent))
    ps = parent[order]
    nxt = np.full(B, -1, np.int32)
    same = ps[1:] == ps[:-1]
    nxt[order[:-1][same]] = order[1:][same]
    fc = np.full(B + S, -1, np.int32)
    starts = np.r_[0, np.flatnonzero(~same) + 1]
    live = ps[starts] < B + S
    fc[ps[starts][live]] = order[starts][live]
    nxt[~item] = -1
    return parent, nxt, fc, item


class TestDfsRanks:
    @pytest.mark.parametrize("seed,B,S,n_dead", [
        (0, 1, 1, 0), (1, 40, 3, 5), (2, 600, 17, 30), (3, 1500, 2, 0),
    ])
    @pytest.mark.parametrize("rounds", ["cap", "tight"])
    def test_matches_reference(self, seed, B, S, n_dead, rounds):
        rng = np.random.default_rng(seed)
        parent, nxt, fc, item = _tree_tables(rng, B, S, n_dead)
        # "cap" covers any path; "tight" is a smaller fixed round count
        # (a staged plan's rank_rounds), identical on both sides
        rr = port._round_cap(B + S) if rounds == "cap" else 3
        with enable_x64(True):
            want = np.asarray(ref.dfs_ranks(
                jnp.asarray(parent), jnp.asarray(nxt), jnp.asarray(fc),
                jnp.asarray(item), S, rank_rounds=rr))
        got = port.dfs_ranks(
            torch.from_numpy(parent), torch.from_numpy(nxt),
            torch.from_numpy(fc), torch.from_numpy(item), S,
            rank_rounds=rr).numpy()
        assert (got == want).all()


class TestHelpers:
    @pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 1000, 40_961, 1 << 20])
    def test_buckets_match_reference(self, n):
        assert port.bucket_grid(n, floor=6) == ref.bucket_grid(n, floor=6)
        assert port.bucket_pow2(n) == ref.bucket_pow2(n)

    def test_pack_id_matches_reference(self):
        c = np.asarray([-1, 0, 5, (1 << 22) - 1], np.int32)
        k = np.asarray([7, 0, (1 << 40) - 1, 3], np.int64)
        with enable_x64(True):
            want = np.asarray(ref.pack_id(jnp.asarray(c), jnp.asarray(k)))
        got = port.pack_id(torch.from_numpy(c), torch.from_numpy(k)).numpy()
        assert (got == want).all()

    def test_cuda_device_raises_without_a_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port.resolve_device("cuda")
        assert port.resolve_device("cpu") == torch.device("cpu")
