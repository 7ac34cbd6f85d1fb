"""YATA sequence ordering over a union, as tensor ops.

The port's counterpart of ``crdt_tpu.ops.yata.tree_order_ranks`` and
``converge_sequences``. The document order of a sequence is the
depth-first traversal of its *origin tree* (every item hangs under its
left origin or the sequence's virtual root); siblings within one
origin group follow (client asc, clock DESC), which is exact for every
group without right-origin attachments. Attachment groups need the
reference's scalar host scan (``order_sequences``), which this slice
does not port: :func:`crdt_tpu_torch.models.replay.finish_assembly`
raises on right-bearing sequence rows instead.
"""

from __future__ import annotations

import torch

from crdt_tpu_torch.ops.device import (
    NULLI,
    dfs_ranks,
    lexsort,
    pack_id,
    run_edge_lookup,
    scatter_perm,
    searchsorted_ids,
)
from crdt_tpu_torch.ops.merge import dense_segments, sort_by_id


def tree_order_ranks(
    seg,         # [N] int32 dense sequence id (-1 = not a sequence item)
    parent_idx,  # [N] int32 origin-tree parent (item index), NULLI = root
    key1,        # [N] int64 primary sibling key (scan rank or client)
    key2,        # [N] int64 secondary sibling key (0 or NEGATED clock)
    valid,       # [N] bool
    num_segments: int,
):
    """DFS position of every item within its sequence (tombstones
    included). Returns (rank [N] int32, seq_len [num_segments] int32).
    The ranking runs the reference's early-exit doubling loops
    (``rank_rounds=None``)."""
    n = seg.shape[0]
    m = n + num_segments
    dev = seg.device
    is_seq = valid & (seg >= 0)

    seg64 = seg.to(torch.int64)
    parent = torch.where(is_seq & (parent_idx >= 0),
                         parent_idx.to(torch.int64), n + seg64.clamp(min=0))
    parent = torch.where(is_seq, parent, torch.full_like(parent, m))

    # sibling adjacency: sort by (parent, key1, key2); non-sequence rows
    # sit in the overflow slot m, so every run below m is one group
    order = lexsort([parent, key1, key2])
    p_s = parent[order]
    same_group = torch.zeros(n, dtype=torch.bool, device=dev)
    same_group[:-1] = p_s[1:] == p_s[:-1]
    nxt_sorted = torch.where(same_group, torch.roll(order, -1),
                             NULLI).to(torch.int32)
    next_sib = scatter_perm(order, nxt_sorted)

    # dense first-child table via one search over the run starts (the
    # gather clamps as the reference's does)
    first_pos, _ = run_edge_lookup(p_s, m, side="left")
    first_child = torch.where(
        first_pos >= 0, order[first_pos.long().clamp(0, max(n - 1, 0))],
        NULLI,
    ).to(torch.int32)

    dist_to_end = dfs_ranks(parent.to(torch.int32), next_sib, first_child,
                            is_seq, num_segments, rank_rounds=None)

    root_dist = dist_to_end[n + seg64.clamp(min=0)]
    rank = torch.where(is_seq, root_dist - dist_to_end[:n] - 1,
                       NULLI).to(torch.int32)
    return rank, dist_to_end[n:]


def converge_sequences(
    client,          # [N] int32
    clock,           # [N] int64
    parent_is_root,  # [N] bool
    parent_a,        # [N] int64  root name id | parent item client
    parent_b,        # [N] int64  -1           | parent item clock
    key_id,          # [N] int32  -1 for sequence rows (map rows skipped)
    origin_client,   # [N] int32
    origin_clock,    # [N] int64
    valid,           # [N] bool
    num_segments: int,
):
    """Union-level sequence ordering: dedup by packed id, dense
    per-parent segments, origin resolution by binary search, then the
    DFS rank kernel. Returns ``(order, seg, rank, seq_len)``; all but
    ``order`` live in id-sorted space and ``order[i]`` maps sorted
    position i back to the caller's row."""
    n = client.shape[0]
    order, ikey, cols, uniq_valid = sort_by_id(
        [client, clock, parent_is_root, parent_a, parent_b, key_id,
         origin_client, origin_clock, valid])
    (client, clock, parent_is_root, parent_a, parent_b, key_id,
     origin_client, origin_clock, _) = cols
    is_seq = uniq_valid & (key_id < 0)

    # dense per-parent segments (the composite-change scheme of
    # converge_maps, restricted to sequence rows)
    minus2 = torch.full((n,), -2, dtype=torch.int64, device=client.device)
    seg = dense_segments([
        (~is_seq).to(torch.int32),
        parent_is_root.to(torch.int32),
        torch.where(is_seq, parent_a.to(torch.int64), minus2),
        torch.where(is_seq, parent_b.to(torch.int64), minus2),
    ], is_seq)

    # origin rows; cross-segment / absent origins hang off the segment
    # root (the origin gather clamps as the reference's does)
    okey = pack_id(origin_client, origin_clock)
    origin_idx = searchsorted_ids(ikey, okey)
    oseg = seg[origin_idx.long().clamp(0, max(n - 1, 0))]
    oseg = torch.where(origin_idx >= 0, oseg, NULLI)
    parent_idx = torch.where((origin_idx >= 0) & (oseg == seg), origin_idx,
                             NULLI).to(torch.int32)

    rank, seq_len = tree_order_ranks(
        seg, parent_idx, client.to(torch.int64), -clock.to(torch.int64),
        is_seq, num_segments=num_segments,
    )
    return order, seg, rank, seq_len
