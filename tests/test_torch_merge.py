"""The fleet round's merge modules against the reference, on the CPU.

``crdt_tpu_torch.ops`` — ``device`` (the sorted-order primitives and
the early-exit Wyllie ranking), ``statevec``, ``lww``, ``merge`` and
``yata`` — held against ``crdt_tpu.ops`` on the same inputs, made with
numpy from a seed and handed to both. Every comparison is exact
integer equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_tpu.compat import enable_x64
from crdt_tpu.ops import device as ref_dev
from crdt_tpu.ops import lww as ref_lww
from crdt_tpu.ops import merge as ref_merge
from crdt_tpu.ops import statevec as ref_sv
from crdt_tpu.ops import yata as ref_yata
from crdt_tpu.parallel.gossip import synth_columns
from crdt_tpu_torch.ops import device as dev
from crdt_tpu_torch.ops import lww, merge, statevec, yata

COLS = ("client", "clock", "parent_is_root", "parent_a", "parent_b",
        "key_id", "origin_client", "origin_clock", "valid")


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _union(seed, R=6, N=48, num_lists=3):
    """A flattened fleet union with redelivered rows, invalid rows and
    a few clients past the state-vector width."""
    rng = np.random.default_rng(seed)
    cols, _ = synth_columns(R, N, num_lists=num_lists, keys_per_map=8,
                            seed=seed)
    # replica 1 re-carries part of replica 0's ops (gossip redelivery)
    for k in COLS:
        cols[k][1, : N // 3] = cols[k][0, : N // 3]
    cols["valid"] &= rng.random((R, N)) < 0.9
    return {k: v.reshape(-1) for k, v in cols.items()}


def _deletes(seed, n_clients, nulls=8):
    """Two disjoint delete ranges per client, null-padded."""
    rng = np.random.default_rng(seed + 100)
    rc = np.repeat(np.arange(1, n_clients + 1), 2)
    d = len(rc)
    rs = np.tile([3, 20], n_clients) + rng.integers(0, 3, d)
    re = rs + rng.integers(1, 9, d)
    pad = np.full(nulls, -1)
    return (np.r_[rc, pad].astype(np.int32), np.r_[rs, pad].astype(np.int64),
            np.r_[re, pad].astype(np.int64))


class TestDevicePrimitives:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_lexsort_and_dense_ranks(self, seed):
        rng = np.random.default_rng(seed)
        keys = [rng.integers(0, 4, 300), rng.integers(-3, 3, 300),
                rng.integers(0, 50, 300)]
        want = _np(ref_dev.lexsort([jnp.asarray(k) for k in keys]))
        got = dev.lexsort([_t(k) for k in keys]).numpy()
        assert (got == want).all()
        sk = np.sort(keys[0])
        assert (dev.dense_ranks_sorted(_t(sk)).numpy()
                == _np(ref_dev.dense_ranks_sorted(jnp.asarray(sk)))).all()

    def test_searchsorted_ids_and_unpack(self):
        rng = np.random.default_rng(2)
        ids = np.unique(rng.integers(0, 1 << 45, 200)).astype(np.int64)
        query = np.r_[ids[::3], rng.integers(0, 1 << 45, 50), -1, -7,
                      (1 << 62)].astype(np.int64)
        with enable_x64(True):
            want = _np(ref_dev.searchsorted_ids(jnp.asarray(ids),
                                                jnp.asarray(query)))
            wc, wk = ref_dev.unpack_id(jnp.asarray(query))
        got = dev.searchsorted_ids(_t(ids), _t(query)).numpy()
        assert (got == want).all()
        gc, gk = dev.unpack_id(_t(query))
        assert (gc.numpy() == _np(wc)).all() and (gk.numpy() == _np(wk)).all()

    @pytest.mark.parametrize("side", ["left", "right"])
    def test_run_edge_lookup_and_scatter_perm(self, side):
        rng = np.random.default_rng(3)
        slots = np.sort(rng.integers(0, 40, 120)).astype(np.int32)
        wpos, wfound = ref_dev.run_edge_lookup(jnp.asarray(slots), 50,
                                               side=side)
        gpos, gfound = dev.run_edge_lookup(_t(slots), 50, side=side)
        assert (gpos.numpy() == _np(wpos)).all()
        assert (gfound.numpy() == _np(wfound)).all()
        perm = rng.permutation(120).astype(np.int32)
        vals = rng.integers(0, 1000, 120).astype(np.int32)
        want = _np(ref_dev.scatter_perm(jnp.asarray(perm), jnp.asarray(vals)))
        assert (dev.scatter_perm(_t(perm), _t(vals)).numpy() == want).all()

    @pytest.mark.parametrize("length", [2, 3, 4, 8])
    def test_wyllie_early_exit_on_cycles(self, length):
        # a power-of-two cycle brings every pointer home while its
        # distances keep growing: only the early-exit loop matches
        n = 64
        succ = np.arange(n, dtype=np.int32)
        succ[10:40] = np.arange(11, 41)
        succ[40] = 40
        for j in range(length):
            succ[50 + j] = 50 + (j + 1) % length
        with enable_x64(True):
            want = _np(ref_dev.wyllie_dist(jnp.asarray(succ), rounds=None))
        got = dev.wyllie_dist(_t(succ), rounds=None).numpy()
        assert (got == want).all()


class TestStatevec:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_build_batched_merge_and_diff(self, seed):
        u = _union(seed)
        R, C = 6, 5  # clients 1..6 exist: client 5 and 6 fall off
        client = u["client"].reshape(R, -1).copy()
        client[2, :3] = -4  # negative clients drop too
        clock, valid = u["clock"].reshape(R, -1), u["valid"].reshape(R, -1)
        with enable_x64(True):
            want = _np(jax.vmap(
                lambda c, k, v: ref_sv.build(c, k, v, C)
            )(jnp.asarray(client), jnp.asarray(clock), jnp.asarray(valid)))
            wmerge = _np(ref_sv.merge(jnp.asarray(want)))
            floor = jnp.asarray(want).min(axis=0)
            wdiff = _np(ref_sv.diff_mask(
                jnp.asarray(u["client"]), jnp.asarray(u["clock"]),
                jnp.asarray(u["valid"]), floor))
        got = statevec.build(_t(client), _t(clock), _t(valid), C)
        assert got.dtype == torch.int64 and (got.numpy() == want).all()
        assert (statevec.merge(got).numpy() == wmerge).all()
        gdiff = statevec.diff_mask(_t(u["client"]), _t(u["clock"]),
                                   _t(u["valid"]), got.min(dim=0).values)
        assert (gdiff.numpy() == wdiff).all()
        # the [N] form is the [R, N] form's row
        one = statevec.build(_t(client[3]), _t(clock[3]), _t(valid[3]), C)
        assert (one.numpy() == want[3]).all()

    @pytest.mark.parametrize("mode", ["jnp", "interpret"])
    def test_missing(self, mode):
        rng = np.random.default_rng(7)
        svs = rng.integers(0, 90, (9, 11)).astype(np.int64)
        with enable_x64(True):
            want = _np(ref_sv.missing_static(jnp.asarray(svs), mode))
        assert (statevec.missing(_t(svs)).numpy() == want).all()
        assert (statevec.exact_missing(_t(svs)).numpy() == want).all()
        rows = statevec.exact_missing_rows(_t(svs[2:5]), _t(svs)).numpy()
        assert (rows == want[2:5]).all()


def _converge_args(u, dels):
    return [u[k] for k in COLS] + list(dels)


class TestConverge:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_converge_maps(self, seed):
        u = _union(seed)
        dels = _deletes(seed, 6)
        args = _converge_args(u, dels)
        with enable_x64(True):
            want = ref_merge.converge_maps(*(jnp.asarray(a) for a in args),
                                           num_segments=512, ds_mode="jnp")
        got = merge.converge_maps(*(_t(a) for a in args), num_segments=512)
        names = ("order", "seg", "winners", "winner_visible", "del_mask",
                 "uniq_valid")
        for name, g, w in zip(names, got, want):
            assert (g.numpy() == _np(w)).all(), name
        assert got[3].any() and not got[3].all()

    @pytest.mark.parametrize("seed", [0, 3])
    def test_converge_sequences(self, seed):
        u = _union(seed, num_lists=2)
        args = [u[k] for k in COLS]
        with enable_x64(True):
            want = ref_yata.converge_sequences(
                *(jnp.asarray(a) for a in args), num_segments=512)
        got = yata.converge_sequences(*(_t(a) for a in args),
                                      num_segments=512)
        for name, g, w in zip(("order", "seg", "rank", "seq_len"), got, want):
            assert (g.numpy() == _np(w)).all(), name
        assert (got[2].numpy() >= 0).sum() > 50

    @pytest.mark.parametrize("ranked", [False, True])
    @pytest.mark.parametrize("seed", [4, 5])
    def test_map_winners(self, ranked, seed):
        # id-sorted rows in random key chains; origins point at earlier
        # rows, some across segments (treated as chain roots)
        rng = np.random.default_rng(seed)
        n, S = 400, 64
        client = np.sort(rng.integers(0, 9, n)).astype(np.int32)
        clock = np.zeros(n, np.int64)
        for c in np.unique(client):
            idx = np.flatnonzero(client == c)
            clock[idx] = np.arange(len(idx))
        seg = rng.integers(-1, 20, n).astype(np.int32)
        origin = np.where(rng.random(n) < 0.7,
                          (rng.random(n) * np.arange(n)).astype(np.int32), -1)
        valid = rng.random(n) < 0.95
        args = (seg, client, clock, origin.astype(np.int32), valid)
        with enable_x64(True):
            want = _np(ref_lww.map_winners(
                *(jnp.asarray(a) for a in args), S, rows_id_ranked=ranked,
                client_bits=23))
        got = lww.map_winners(*(_t(a) for a in args), S,
                              rows_id_ranked=ranked, client_bits=23)
        assert got.dtype == torch.int32 and (got.numpy() == want).all()

    def test_tree_order_ranks(self):
        rng = np.random.default_rng(6)
        n, S = 300, 16
        seg = rng.integers(-1, 5, n).astype(np.int32)
        parent = np.where(rng.random(n) < 0.6,
                          (rng.random(n) * np.arange(n)).astype(np.int32), -1)
        parent = np.where((parent >= 0) & (seg[np.clip(parent, 0, None)]
                                           == seg), parent, -1)
        key1 = rng.integers(0, 5, n).astype(np.int64)
        key2 = -rng.integers(0, 100, n).astype(np.int64)
        valid = rng.random(n) < 0.9
        args = (seg, parent.astype(np.int32), key1, key2, valid)
        with enable_x64(True):
            wrank, wlen = ref_yata.tree_order_ranks(
                *(jnp.asarray(a) for a in args), num_segments=S)
        grank, glen = yata.tree_order_ranks(*(_t(a) for a in args),
                                            num_segments=S)
        assert (grank.numpy() == _np(wrank)).all()
        assert (glen.numpy() == _np(wlen)).all()
