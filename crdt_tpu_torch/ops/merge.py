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
*indices* into the caller's rows; :func:`merge_records` is the host
wrapper (records -> columns -> one ``converge_maps`` on a device the
caller names -> materialized map winners).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from crdt_tpu_torch.codec.native import resolve_parents  # noqa: F401 — the reference's name
from crdt_tpu_torch.core.ids import DeleteSet
from crdt_tpu_torch.core.records import ItemRecord
from crdt_tpu_torch.ops import deleteset as ds_ops
from crdt_tpu_torch.ops.device import (
    NULLI,
    lexsort,
    pack_id,
    resolve_device,
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
    changed[:1].fill_(True)  # a fill kernel: no host sync on the card
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


# ---------------------------------------------------------------------------
# host wrapper: records -> device columns -> materialized maps
# ---------------------------------------------------------------------------


class Interner:
    """Canonical string<->int tables shared across a merge batch."""

    def __init__(self):
        self.roots: Dict[str, int] = {}
        self.keys: Dict[str, int] = {}

    def root(self, name: str) -> int:
        return self.roots.setdefault(name, len(self.roots))

    def key(self, name: str) -> int:
        return self.keys.setdefault(name, len(self.keys))


def records_to_columns(
    records: List[ItemRecord], interner: Interner, pad: Optional[int] = None
) -> Dict[str, np.ndarray]:
    """Symbolic records -> padded integer columns for the kernel.

    Records whose parent/key is implicit (mid-run items) must have been
    resolved first — `Engine.records_since` always emits explicit rows;
    for raw decoded updates run :func:`resolve_parents`.
    """
    n = len(records)
    size = pad or max(1, n)
    cols = {
        "client": np.full(size, 0, np.int32),
        "clock": np.full(size, 0, np.int64),
        "parent_is_root": np.zeros(size, bool),
        "parent_a": np.full(size, -2, np.int64),
        "parent_b": np.full(size, -2, np.int64),
        "key_id": np.full(size, -1, np.int32),
        "origin_client": np.full(size, -1, np.int32),
        "origin_clock": np.full(size, -1, np.int64),
        "valid": np.zeros(size, bool),
    }
    for i, r in enumerate(records):
        cols["client"][i] = r.client
        cols["clock"][i] = r.clock
        if r.parent_root is not None:
            cols["parent_is_root"][i] = True
            cols["parent_a"][i] = interner.root(r.parent_root)
            cols["parent_b"][i] = -1
        elif r.parent_item is not None:
            cols["parent_a"][i] = r.parent_item[0]
            cols["parent_b"][i] = r.parent_item[1]
        cols["key_id"][i] = interner.key(r.key) if r.key is not None else -1
        if r.origin is not None:
            cols["origin_client"][i] = r.origin[0]
            cols["origin_clock"][i] = r.origin[1]
        cols["valid"][i] = True
    return cols


def merge_records(
    records: List[ItemRecord],
    delete_set: Optional[DeleteSet] = None,
    interner: Optional[Interner] = None,
    *,
    device="cuda",
) -> Dict[Tuple, Tuple[Optional[ItemRecord], bool]]:
    """Full host->device->host map merge of a record union, converged
    on ``device`` (the card unless the caller asks for the CPU).

    Returns {(parent, key): (winning record, visible)} where parent is
    ("root", name) or ("item", client, clock).
    """
    dev = resolve_device(device)
    records = resolve_parents(records)
    interner = interner or Interner()
    # pad to power-of-two buckets (floor 512), as the reference does
    pad = 1 << max(9, (len(records) - 1).bit_length())
    cols = records_to_columns(records, interner, pad=pad)
    ds = delete_set or DeleteSet()
    d_client, d_start, d_end = ds_ops.ranges_to_device(ds)
    # bucket-pad ranges as well (null client -1 ranges match nothing)
    dpad = 1 << max(6, (len(d_client) - 1).bit_length()) if d_client else 0
    d_client = list(d_client) + [-1] * (dpad - len(d_client))
    d_start = list(d_start) + [-1] * (dpad - len(d_start))
    d_end = list(d_end) + [-1] * (dpad - len(d_end))

    def put(arr):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)

    order, _, winners, visible, _, _ = converge_maps(
        *(put(cols[name]) for name in (
            "client", "clock", "parent_is_root", "parent_a", "parent_b",
            "key_id", "origin_client", "origin_clock", "valid")),
        put(np.asarray(d_client, np.int32)),
        put(np.asarray(d_start, np.int64)),
        put(np.asarray(d_end, np.int64)),
    )
    order = order.cpu().numpy()
    winners = winners.cpu().numpy()
    visible = visible.cpu().numpy()
    out: Dict[Tuple, Tuple[Optional[ItemRecord], bool]] = {}
    for w, vis in zip(winners, visible):
        if w == NULLI:
            continue
        rec = records[order[w]]
        parent = (
            ("root", rec.parent_root)
            if rec.parent_root is not None
            else ("item",) + tuple(rec.parent_item)
        )
        out[(parent, rec.key)] = (rec, bool(vis))
    return out
