"""The swarm's per-peer views: what each of a swarm's peers holds when an
anti-entropy round starts.

Every peer is one writer of the fan-in document
(:func:`benchmark.gen.traces.build_trace`: the same ops, the same mix).
A peer holds all of its own writes and, from each of ``fanout`` other
peers drawn uniformly without replacement, a prefix of that sender's
ops: an in-order broadcast (crdt.js:385,445) that churn cut short, its
length uniform on 0..``prefix_max``. A writer's ops chain only to its
own earlier ops, so every prefix is a causal cut of the sender's
history; the deletes the sender made of ops inside the prefix come
with it. Each peer's view is one v1 update (clients descending, clocks
ascending), so the union of the views is the whole fan-in document and
most rows of the views are redeliveries.

It imports nothing of the program under test.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from benchmark.gen import traces, wire


def build(peers: int, ops_per_peer: int, fanout: int, prefix_max: int,
          seed: int, map_frac: float = 0.6):
    """(blobs, table, ds, views, info): one blob a peer; the fan-in
    record table of every op and its delete set ``(client, start,
    len)``; ``views``, the rows each peer holds (``peer`` and ``row``,
    an index into the table, in blob order, and ``held``, the [peers,
    peers] count of each writer's ops a peer holds); and the sizes."""
    P, K = peers, ops_per_peer
    _, t, ds = traces.build_trace(P, K, seed=seed, map_frac=map_frac)
    rng = np.random.default_rng([seed, 1])
    fan = min(fanout, P - 1)
    held = np.zeros((P, P), np.int64)
    held[np.arange(P), np.arange(P)] = K
    for p in range(P):
        others = rng.choice(P - 1, size=fan, replace=False)
        others = others + (others >= p)
        held[p, others] = rng.integers(0, prefix_max + 1, size=fan)
    blobs, peer, row = encode_views(t, ds, held, K)
    views: Dict[str, np.ndarray] = {"peer": peer, "row": row,
                                    "held": held}
    info = {"peers": P, "ops": len(t["client"]), "rows": len(row),
            "largest_peer": int(np.bincount(peer, minlength=P).max()),
            "bytes": sum(map(len, blobs))}
    return blobs, t, ds, views, info


def encode_views(t: Dict, ds, held: np.ndarray, ops_per_writer: int):
    """(blobs, peer, row): one v1 update a peer ``p`` holding writer
    ``w``'s first ``held[p, w]`` ops of the fan-in table ``t`` (writer
    w is client w + 1, its rows ``w * ops_per_writer`` on) and the
    writer's deletes of them; the rows of the blobs in order."""
    P, K = held.shape[0], ops_per_writer
    # writers by client descending, clocks ascending
    p_idx, w_idx = np.nonzero(held[:, ::-1])
    w_idx = held.shape[1] - 1 - w_idx
    n = held[p_idx, w_idx]
    starts = np.repeat(w_idx * K, n)
    within = np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)
    row = starts + within
    peer = np.repeat(p_idx, n)
    bounds = np.r_[0, np.cumsum(np.bincount(peer, minlength=P))]
    ds_client, ds_start, ds_len = ds
    writer = ds_client - 1
    ranges = []
    for p in range(P):
        keep = ds_start < held[p, writer]
        ranges.append(wire.normalize_ranges(ds_client[keep],
                                            ds_start[keep], ds_len[keep]))
    return wire.encode_updates(wire.take(t, row), bounds, ranges), peer, row
