"""Map last-writer-wins winner kernel.

The port's counterpart of ``crdt_tpu.ops.lww.map_winners``. A map key's
visible entry is the **tail of its YATA key chain**: the chain is a
tree (each item's origin is an earlier item of the same key or null),
sibling order is ascending client id and, within one client,
DESCENDING clock, so the tail is the node reached from the virtual
root by repeatedly stepping to the (max client, min clock) child.

Shape, all whole-tensor ops:

1. sort items by (parent slot, client, clock desc); each parent's run
   tail in this order is its last child, read off with one search over
   the run edges;
2. pointer doubling over the last-child function -> the chain tail of
   every node;
3. the winner of each segment is its virtual root's tail.
"""

from __future__ import annotations

import torch

from crdt_tpu_torch.ops.device import (
    _CLOCK_BITS,
    NULLI,
    lexsort,
    pointer_double,
    run_edge_lookup,
)


def map_winners(
    seg: torch.Tensor,         # [N] int32 dense segment id (-1 = not a map item)
    client: torch.Tensor,      # [N] int32
    clock: torch.Tensor,       # [N] int64 (may be None when rows_id_ranked fits)
    origin_idx: torch.Tensor,  # [N] int32 origin item index, NULLI if none
    valid: torch.Tensor,       # [N] bool
    num_segments: int,
    rows_id_ranked: bool = False,
    chain_rounds: int | None = None,
    client_bits: int = 22,
) -> torch.Tensor:
    """Winner item index per segment (NULLI for empty segments), [S]
    int32.

    ``origin_idx`` must point within the same segment; cross-segment or
    missing origins are treated as segment roots. ``rows_id_ranked``:
    rows are already in (client, clock) order, so within one client
    DESCENDING clock is DESCENDING row index and the sibling key
    collapses into one int64 when the widths fit (else the two-key
    lexsort, as in the reference). ``chain_rounds`` caps the tail
    pointer doubling."""
    n = client.shape[0]
    dev = client.device
    m = n + num_segments  # item nodes + one virtual root per segment
    is_map = valid & (seg >= 0)

    # child -> parent edges; roots hang off their segment's virtual
    # root (the origin gather clamps as the reference's does)
    origin_ok = (origin_idx >= 0) & is_map
    oseg = seg[origin_idx.long().clamp(0, max(n - 1, 0))]
    origin_seg = torch.where(origin_ok, oseg, torch.full_like(oseg, NULLI))
    same_seg = origin_ok & (origin_seg == seg)
    parent = torch.where(same_seg, origin_idx.to(torch.int64),
                         n + seg.to(torch.int64))
    parent = torch.where(is_map, parent, torch.full_like(parent, m))

    # last child per node = max child by (client, inverted clock)
    pbits = int(m).bit_length()
    qbits = int(max(n - 1, 1)).bit_length()
    if rows_id_ranked and pbits + client_bits + qbits <= 63:
        idx_desc = (n - 1) - torch.arange(n, dtype=torch.int64, device=dev)
        key = ((parent << (client_bits + qbits))
               | (client.to(torch.int64) << qbits) | idx_desc)
        corder = torch.argsort(key, stable=True)
    else:
        if clock is None:
            raise ValueError(
                "map_winners needs clock when the collapsed id-ranked "
                "key does not fit"
            )
        inv_clock = ((1 << _CLOCK_BITS) - 1) - clock.to(torch.int64)
        pack = (client.to(torch.int64) << _CLOCK_BITS) | inv_clock
        corder = lexsort([parent, pack])
    p_sorted = parent[corder]
    last_pos, _ = run_edge_lookup(p_sorted, m, side="right")
    child_idx = torch.where(
        last_pos >= 0, corder[last_pos.long().clamp(0, max(n - 1, 0))],
        NULLI,
    ).to(torch.int32)

    # last-child function with self-loops at leaves
    f = torch.where(child_idx >= 0, child_idx,
                    torch.arange(m, dtype=torch.int32, device=dev))
    tail = pointer_double(f, max_iters=chain_rounds)

    root_tail = tail[n:]
    roots = torch.arange(n, n + num_segments, dtype=torch.int32, device=dev)
    return torch.where(root_tail == roots, NULLI, root_tail).to(torch.int32)
