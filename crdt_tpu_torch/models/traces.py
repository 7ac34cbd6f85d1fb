"""Seeded v1 wire traces for the cold replay, built without the
reference package.

The port's copies of ``bench.py:build_trace``,
``bench.py:build_conflict_trace``, ``bench.py:build_text_trace`` and the
multi-tenant generators ``bench.py:build_doc_trace`` and
``bench.py:_SteadyStream``: the same generators, seeds and record
shapes, so a trace built here is byte-identical to the benchmark's
(tests/test_torch_replay.py, tests/test_torch_multidoc.py).
``chip_smoke.py`` builds its inputs with these.
"""

from __future__ import annotations

import numpy as np

from crdt_tpu_torch.codec import v1
from crdt_tpu_torch.core.ids import DeleteSet
from crdt_tpu_torch.core.records import ItemRecord


def build_trace(R: int, K: int, seed: int = 0, client_base: int = 0,
                map_frac: float = 0.6):
    """Per-replica v1 update blobs: ``map_frac`` map sets over 8 maps,
    the rest concurrent list appends over 8 lists (own-chain origins),
    5% of each replica's ops tombstoned in its final blob's delete
    set. ``client_base`` offsets the client ids (steady-state rounds
    need fresh writers whose ids do not collide with the base doc's);
    ``map_frac=1.0`` makes delta rounds touch only per-key map
    segments instead of whole lists."""
    rng = np.random.default_rng(seed)
    num_maps, num_lists = 8, 8
    keys_per_map = max(64, (R * K) // 64)
    n_map = int(K * map_frac)
    blobs = []
    for r in range(R):
        client = client_base + r + 1
        recs = []
        maps = rng.integers(0, num_maps, n_map)
        keys = rng.integers(0, keys_per_map, n_map)
        last_set: dict = {}
        for k in range(n_map):
            mk = (int(maps[k]), int(keys[k]))
            prev = last_set.get(mk)
            recs.append(ItemRecord(
                client=client, clock=k, parent_root=f"m{maps[k]}",
                key=f"k{keys[k]}", content=int(r * K + k),
                # chained like real Yjs map sets: origin = this
                # replica's previous entry for the key
                origin=(client, prev) if prev is not None else None,
            ))
            last_set[mk] = k
        lists = rng.integers(0, num_lists, K - n_map)
        last: dict = {}
        for j, k in enumerate(range(n_map, K)):
            lst = int(lists[j])
            prev = last.get(lst)
            recs.append(ItemRecord(
                client=client, clock=k, parent_root=f"l{lst}",
                origin=(client, prev) if prev is not None else None,
                content=int(r * K + k),
            ))
            last[lst] = k
        ds = DeleteSet()
        for k in rng.choice(K, size=max(1, K // 20), replace=False):
            ds.add(client, int(k))
        blobs.append(v1.encode_update(recs, ds))
    return blobs


def build_conflict_trace(R: int, K: int, seed: int = 2):
    """The YATA hard case the append-only trace never triggers: every
    replica keeps attaching to a handful of SHARED origin items, so
    sibling groups grow R wide and the conflict scan (client-ordered
    sibling resolution) does real work on every insert. Right origins
    are absent, as in real concurrent appends, so both contenders stay
    exact. 70% sequence ops (vs 40% in the main trace)."""
    rng = np.random.default_rng(seed)
    num_lists = 4
    n_map = (K * 3) // 10
    # shared attachment points (client 1's first seq ops), clamped so
    # small K never references anchors client 1 does not emit
    hot = min(16, K - n_map)
    hot -= hot % num_lists  # equal anchors per list (0 = no anchors)
    blobs = []
    for r in range(R):
        client = r + 1
        recs = []
        last_set: dict = {}
        for k in range(n_map):
            key = int(rng.integers(0, 64))
            prev_set = last_set.get(key)
            recs.append(ItemRecord(
                client=client, clock=k, parent_root="m0",
                key=f"k{key}", content=k,
                # chained like real Yjs map sets
                origin=(client, prev_set) if prev_set is not None else None,
            ))
            last_set[key] = k
        hot_per_list = hot // num_lists
        prev: dict = {}
        for k in range(n_map, K):
            if client == 1 and k < n_map + hot:
                # the hot anchors: client 1 heads each list round-robin
                lst = (k - n_map) % num_lists
                origin = None
            else:
                lst = int(rng.integers(0, num_lists))
                if hot_per_list and rng.random() < 0.5:
                    # pile onto a shared anchor OF THIS LIST -> R-wide
                    # same-origin sibling group
                    j = lst + num_lists * int(rng.integers(0, hot_per_list))
                    origin = (1, n_map + j)
                else:
                    origin = (client, prev[lst]) if lst in prev else None
            recs.append(ItemRecord(
                client=client, clock=k, parent_root=f"l{lst}",
                origin=origin, content=k,
            ))
            prev[lst] = k
        blobs.append(v1.encode_update(recs, DeleteSet()))
    return blobs


def build_text_trace(R: int, K: int, seed: int = 3):
    """Collaborative-text shape: every replica types its own runs into
    one shared document; 20% of ops are mid-inserts carrying BOTH
    origins (left = predecessor, right = the character that followed
    at insert time) — the workload whose right origins route ordering
    through the exact host machinery on the fleet route, and through
    the stager's attachment-group ranks on the packed routes."""
    rng = np.random.default_rng(seed)
    blobs = []
    for r in range(R):
        client = r + 1
        recs = []
        chain: list = []  # own chars in own document order
        for k in range(K):
            if chain and rng.random() < 0.2:
                j = int(rng.integers(0, len(chain)))
                recs.append(ItemRecord(
                    client=client, clock=k, parent_root="text",
                    origin=chain[j - 1] if j > 0 else None,
                    right=chain[j], content=k))
                chain.insert(j, (client, k))
            else:
                recs.append(ItemRecord(
                    client=client, clock=k, parent_root="text",
                    origin=chain[-1] if chain else None, content=k))
                chain.append((client, k))
        blobs.append(v1.encode_update(recs, DeleteSet()))
    return blobs


def build_doc_trace(n_small: int, ops_small: int, n_big: int,
                    ops_big: int, seed: int = 17) -> dict:
    """Mixed-tenant trace: ``n_small`` single-writer docs of
    ``ops_small`` ops each (one map root + one list root + a few
    tombstones — the idle-tenant shape that dominates a production
    server's doc population) plus ``n_big`` multi-writer docs of
    ``ops_big`` ops (the shared build_trace shape). Returns
    ``{doc_id: [v1 update blobs]}``; doc ids sort small-docs-first."""
    docs = {}
    for i in range(n_small):
        rng = np.random.default_rng(seed + i)
        client = 1 + int(rng.integers(0, 1 << 20))
        recs = []
        chain: list = []
        n_map = ops_small // 3
        for k in range(n_map):
            recs.append(ItemRecord(
                client=client, clock=k, parent_root="m",
                key=f"k{int(rng.integers(0, 24))}",
                content=int(i * 31 + k),
            ))
        for k in range(n_map, ops_small):
            recs.append(ItemRecord(
                client=client, clock=k, parent_root="l",
                origin=chain[-1] if chain else None,
                content=int(i + k),
            ))
            chain.append((client, k))
        ds = DeleteSet()
        ds.add(client, n_map)
        docs[f"t{i:05d}"] = [v1.encode_update(recs, ds)]
    for j in range(n_big):
        docs[f"zbig{j}"] = build_trace(
            8, max(ops_big // 8, 1), seed=seed + 7000 + j
        )
    return docs


class _SteadyStream:
    """Single-writer doc generator whose every delta continues the
    client's clock contiguously — the SV-admissible steady-state shape
    the multi-tenant server's delta ticks serve (one map root + one
    chained list root, the small-tenant mix of build_doc_trace)."""

    def __init__(self, i: int):
        self.client = 1 + i
        self.i = i
        self.k = 0
        self.chain = None
        self.map_tail: dict = {}

    def delta(self, n_ops: int) -> bytes:
        recs = []
        for j in range(n_ops):
            k = self.k
            self.k += 1
            if j % 4 == 0:
                # a map set chains onto the key's previous value
                # (origin = prior item), the Yjs Y.Map wire shape
                key = f"k{(self.i + j) % 16}"
                recs.append(ItemRecord(
                    client=self.client, clock=k, parent_root="m",
                    key=key, origin=self.map_tail.get(key),
                    content=int(self.i * 31 + k),
                ))
                self.map_tail[key] = (self.client, k)
            else:
                recs.append(ItemRecord(
                    client=self.client, clock=k, parent_root="l",
                    origin=self.chain, content=int(self.i + k),
                ))
                self.chain = (self.client, k)
        return v1.encode_update(recs, DeleteSet())
