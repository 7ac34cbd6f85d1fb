"""The benchmark's frozen, vectorised copy of the repository's fan-in
trace generator.

``build_trace`` makes the same random draws, records and bytes as the
program's generator of the same name (``models/traces.py``; held byte
for byte by ``benchmark/tests/test_portbench_gen.py``), but builds the
rows as NumPy arrays and encodes them in one vectorised pass
(:mod:`benchmark.gen.wire`), so a 1.6M-op trace costs set-up seconds,
not tens of them. It also returns its record table, which the plain
reference reads instead of decoding the wire.
"""

from __future__ import annotations

import numpy as np

from benchmark.gen import wire

NUM_MAPS = NUM_LISTS = 8
FANIN_ROOTS = [f"m{i}" for i in range(NUM_MAPS)] + \
    [f"l{i}" for i in range(NUM_LISTS)]


def _chain(group: np.ndarray, clock: np.ndarray) -> np.ndarray:
    """The origin clock of each row: the row before it, by clock, in
    the same ``group`` (-1 for the first of a group)."""
    order = np.lexsort((clock, group))
    g, k = group[order], clock[order]
    prev = np.full(len(order), -1, np.int64)
    same = np.zeros(len(order), bool)
    same[1:] = g[1:] == g[:-1]
    prev[1:][same[1:]] = k[:-1][same[1:]]
    out = np.empty_like(prev)
    out[order] = prev
    return out


def keys_per_map(R: int, K: int) -> int:
    return max(64, (R * K) // 64)


def build_trace(R: int, K: int, seed: int = 0, client_base: int = 0,
                map_frac: float = 0.6):
    """``build_trace``'s fan-in doc: R writers of K ops, ``map_frac``
    map sets over 8 maps (each chained to the writer's previous set of
    the key), the rest appends over 8 lists (chained to the writer's
    previous append there), 5% of each writer's ops tombstoned in its
    blob's delete set. Returns (blobs, table, (ds client, start, len))."""
    rng = np.random.default_rng(seed)
    kpm = keys_per_map(R, K)
    n_map = int(K * map_frac)
    n_list = K - n_map
    n_del = max(1, K // 20)
    maps = np.empty((R, n_map), np.int64)
    keys = np.empty((R, n_map), np.int64)
    lists = np.empty((R, n_list), np.int64)
    dels = np.empty((R, n_del), np.int64)
    for r in range(R):
        maps[r] = rng.integers(0, NUM_MAPS, n_map)
        keys[r] = rng.integers(0, kpm, n_map)
        lists[r] = rng.integers(0, NUM_LISTS, n_list)
        dels[r] = rng.choice(K, size=n_del, replace=False)
    rr = np.repeat(np.arange(R, dtype=np.int64), K)
    clock = np.tile(np.arange(K, dtype=np.int64), R)
    client = client_base + rr + 1
    is_map = clock < n_map
    root = np.empty(R * K, np.int64)
    key = np.full(R * K, -1, np.int64)
    root.reshape(R, K)[:, :n_map] = maps
    root.reshape(R, K)[:, n_map:] = NUM_MAPS + lists
    key.reshape(R, K)[:, :n_map] = keys
    group = np.where(is_map, (rr * (NUM_MAPS * kpm) + root * kpm + key),
                     R * NUM_MAPS * kpm + rr * NUM_LISTS + root)
    ok = _chain(group, clock)
    t = {
        "client": client, "clock": clock, "root": root, "key": key,
        "oc": np.where(ok >= 0, client, -1), "ok": ok,
        "content": rr * K + clock,
        "roots": FANIN_ROOTS, "keys": [f"k{i}" for i in range(kpm)],
    }
    ds_client = np.repeat(client_base + np.arange(R, dtype=np.int64) + 1,
                          n_del)
    ds_start = dels.ravel()
    ranges = [wire.normalize_ranges(ds_client[r * n_del:(r + 1) * n_del],
                                    dels[r], np.ones(n_del, np.int64))
              for r in range(R)]
    blobs = wire.encode_updates(t, np.arange(R + 1) * K, ranges)
    return blobs, t, (ds_client, ds_start, np.ones(len(ds_start), np.int64))
