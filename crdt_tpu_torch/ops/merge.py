"""Batched fan-in merge — the device-side ``applyUpdate`` for N replicas.

The port's counterpart of ``crdt_tpu.ops.merge.converge_maps``: the
*union* of many replicas' op columns (duplicates included — full-state
gossip relies on idempotent merge) converges in one pass of tensor ops:

  1. dedup by packed (client, clock) id           (sort + adjacent-diff)
  2. origin resolution                            (binary search)
  3. dense (parent, key) map segments             (lexsort + rank scan)
  4. per-segment winner                           (lww.map_winners)
  5. tombstones from delete ranges                (deleteset.apply_mask)
  6. visibility of each winner

Content values never touch the device: the outputs are winner
*indices* into the caller's rows.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from crdt_tpu_torch.ops import deleteset as ds_ops
from crdt_tpu_torch.ops.device import (
    NULLI,
    lexsort,
    pack_id,
    scatter_perm,
    searchsorted_ids,
)
from crdt_tpu_torch.ops.lww import map_winners

_ID_SENTINEL = 1 << 62  # sorts invalid rows after every real id


def _pad_to(arr: np.ndarray, size: int, fill) -> np.ndarray:
    """``arr`` padded with ``fill`` to ``size`` (host helper of the
    bucketed host orderings)."""
    out = np.full(size, fill, dtype=arr.dtype)
    out[: len(arr)] = arr
    return out


def sort_by_id(cols):
    """Step 1, shared with ``yata.converge_sequences``: the nine union
    columns (client, clock, parent_is_root, parent_a, parent_b, key_id,
    origin_client, origin_clock, valid) stably sorted by packed
    (client, clock) id, invalid rows last. Returns (order, ikey, the
    sorted columns, uniq_valid): ``order[i]`` maps sorted position i
    back to the caller's row, and ``uniq_valid`` drops every repeat of
    an id but its first (idempotent merge of redelivered rows)."""
    client, clock, valid = cols[0], cols[1], cols[8]
    n = client.shape[0]
    ikey = torch.where(valid, pack_id(client, clock),
                       torch.full((n,), _ID_SENTINEL, dtype=torch.int64,
                                  device=client.device))
    ikey, order = torch.sort(ikey, stable=True)
    cols = [c[order] for c in cols]
    dup = torch.zeros(n, dtype=torch.bool, device=client.device)
    dup[1:] = ikey[1:] == ikey[:-1]
    return order, ikey, cols, cols[8] & ~dup


def dense_segments(segkey, member) -> torch.Tensor:
    """Dense segment id per row from a composite key (a list of [N]
    tensors, most significant first): rows sorted by the key, a new
    segment wherever any part changes. Rows outside ``member`` get
    NULLI."""
    n = member.shape[0]
    sorder = lexsort(segkey)
    changed = torch.zeros(n, dtype=torch.bool, device=member.device)
    if n:
        changed[0] = True
    for k in segkey:
        ks = k[sorder]
        changed[1:] |= ks[1:] != ks[:-1]
    seg_sorted = (torch.cumsum(changed.to(torch.int32), 0) - 1).to(
        torch.int32)
    seg = scatter_perm(sorder, seg_sorted)
    return torch.where(member, seg, NULLI).to(torch.int32)


def converge_maps(
    client,          # [N] int32
    clock,           # [N] int64
    parent_is_root,  # [N] bool
    parent_a,        # [N] int64  root name id | parent item client
    parent_b,        # [N] int64  -1           | parent item clock
    key_id,          # [N] int32  interned map key, -1 for non-map rows
    origin_client,   # [N] int32
    origin_clock,    # [N] int64
    valid,           # [N] bool
    d_client,        # [D] delete-range client
    d_start,         # [D]
    d_end,           # [D]
    num_segments: Optional[int] = None,
):
    """Returns (order, seg, winners, winner_visible, del_mask,
    uniq_valid).

    All outputs except `order` live in id-sorted space; `order[i]` maps
    sorted position i back to the caller's row index."""
    n = client.shape[0]
    if num_segments is None:
        num_segments = n

    # -- 1. sort by packed id, drop duplicates --------------------------
    order, ikey, cols, uniq_valid = sort_by_id(
        [client, clock, parent_is_root, parent_a, parent_b, key_id,
         origin_client, origin_clock, valid])
    (client, clock, parent_is_root, parent_a, parent_b, key_id,
     origin_client, origin_clock, _) = cols

    # -- 2. origin indices in sorted space ------------------------------
    okey = pack_id(origin_client, origin_clock)
    origin_idx = searchsorted_ids(ikey, okey)

    # -- 3. dense map segments -----------------------------------------
    is_map = uniq_valid & (key_id >= 0)
    minus2 = torch.full((n,), -2, dtype=torch.int64, device=client.device)
    seg = dense_segments([
        (~is_map).to(torch.int32),  # all non-map rows share one bucket
        parent_is_root.to(torch.int32),
        torch.where(is_map, parent_a.to(torch.int64), minus2),
        torch.where(is_map, parent_b.to(torch.int64), minus2),
        torch.where(is_map, key_id.to(torch.int64), minus2),
    ], is_map)

    # -- 4. per-segment winners ----------------------------------------
    # rows are id-sorted here (step 1), so the collapsed sibling key
    # applies at pack_id's true client width (23 bits)
    winners = map_winners(seg, client, clock, origin_idx, is_map,
                          num_segments, rows_id_ranked=True, client_bits=23)

    # -- 5. tombstones --------------------------------------------------
    del_mask = ds_ops.apply_mask(
        client, clock, uniq_valid, d_client, d_start, d_end,
    )

    # -- 6. winner visibility (the gather clamps as the reference's) ----
    wc = winners.long().clamp(0, max(n - 1, 0))
    winner_visible = (winners != NULLI) & ~del_mask[wc]

    return order, seg, winners, winner_visible, del_mask, uniq_valid
