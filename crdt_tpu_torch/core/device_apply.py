"""Device-gated remote merge — the kernel path of ``Crdt.apply_update``.

The port's copy of ``crdt_tpu.core.device_apply``. Yjs merges every
incoming update through its scalar integrate loop (``Y.applyUpdate``,
crdt.js:294). Here the same batch is split into two phases:

1. **Admit** (host): dedup, per-client clock contiguity, dependency
   checks, pending stash, parent resolution, store append — pure
   bookkeeping, one dict/append pass per record via
   :meth:`Engine._try_admit`. No chain scans.
2. **Rebuild** (device): recompute the chain-derived state of every
   parent the batch touched from the columnar store, on the device the
   caller names —
   :func:`crdt_tpu_torch.ops.merge.converge_maps` for map (parent, key)
   winners (its delete mask runs the ``ds_mask`` kernel, here on 16
   null ranges) and :func:`crdt_tpu_torch.ops.yata.tree_order_ranks`
   for sequence document order (DFS ranking via lexsort + Wyllie) —
   then materialize the winners/order back into the engine's chain
   dicts. The map outputs cross in ONE packed int32 fetch.

The result is bit-identical engine state to the scalar path
(``Engine.apply_records``): same visible values, same chain order, same
delete set, same pending semantics — asserted against both packages'
scalar mode and the reference's device mode by
tests/test_torch_device_merge.py.

With the tracer on, each stage of a merge adds its seconds to a span:
``device_merge.admit`` (the host admission), ``device_merge.specs`` (the
O(new rows) parent-spec loop), and per rebuild pass
``device_merge.select`` (the affected rows, their remap and sibling
keys), ``device_merge.dispatch`` (uploads and kernel enqueue),
``device_merge.fetch`` (the wait and the fetches) and
``device_merge.link`` (winners, tombstones and chain links written back
to the engine).

Buffering is the point: ``Crdt.apply_updates`` admits a whole batch of
updates (a sync backlog, a persistence log replay, a gossip round) and
pays ONE rebuild — the north-star gate ("incoming peer updates buffered
into columnar tensors and applied as one vectorized applyUpdate").
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from crdt_tpu_torch.core.ids import DeleteSet
from crdt_tpu_torch.core.records import ItemRecord
from crdt_tpu_torch.core.store import K_GC, NO_KEY, NULL
from crdt_tpu_torch.obs.tracer import get_tracer
from crdt_tpu_torch.ops.device import (
    _CLOCK_BITS,
    NULLI,
    fetch_packed_i32,
    resolve_device,
    xfer_fetch,
    xfer_put,
)
from crdt_tpu_torch.ops.device import bucket_pow2 as _bucket


class _Laps:
    """Consecutive stage timings into tracer spans: each call charges
    the seconds since the previous one to the span it names (nothing
    when the tracer is off)."""

    def __init__(self):
        self.tracer = get_tracer()
        self.t = time.perf_counter()

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        if self.tracer.enabled:
            # crdtlint: emits=device_merge.admit,device_merge.specs,device_merge.select,device_merge.dispatch,device_merge.fetch,device_merge.link
            self.tracer.observe(name, now - self.t)
        self.t = now


def apply_records_device(engine, records: List[ItemRecord],
                         delete_set: Optional[DeleteSet] = None, *,
                         device="cuda") -> None:
    """Device-path equivalent of :meth:`Engine.apply_records`: the
    shared admission loop in admit-only mode, then one kernel-driven
    chain rebuild on ``device`` (the card unless the caller asks for
    the CPU; begins its own txn, like the scalar path)."""
    lap = _Laps()
    engine.apply_batch(records, delete_set, chain_integrate=False)
    lap("device_merge.admit")
    if not engine.last_txn_items:
        # no rows admitted (duplicate redelivery, or a delete-only
        # batch): chain-derived state — links, heads, tails, winners —
        # depends only on which rows EXIST, not on deleted flags, so
        # the O(doc) rebuild would reproduce it bit-identically.
        # Deletes were already applied to the flags above.
        return
    rebuild_chains(engine, device=device)


# ---------------------------------------------------------------------------
# chain rebuild from the columnar store
# ---------------------------------------------------------------------------


def _origin_rows(client, clock, ocl, ock) -> np.ndarray:
    """Row index of each row's origin (-1 if none/absent), vectorized:
    packed-id sort + binary search instead of n dict lookups."""
    n = len(client)
    pack = (client.astype(np.int64) << _CLOCK_BITS) | clock.astype(np.int64)
    order = np.argsort(pack)
    spack = pack[order]
    opack = np.where(
        ocl >= 0,
        (ocl.astype(np.int64) << _CLOCK_BITS) | ock.astype(np.int64),
        np.int64(-1),
    )
    pos = np.searchsorted(spack, opack)
    posc = np.clip(pos, 0, max(n - 1, 0))
    found = (opack >= 0) & (spack[posc] == opack)
    return np.where(found, order[posc], -1).astype(np.int32)


def _pad(arr: np.ndarray, size: int, fill) -> np.ndarray:
    out = np.full(size, fill, dtype=arr.dtype)
    out[: len(arr)] = arr
    return out




def _rebuild_state(engine) -> dict:
    """Persistent per-engine rebuild bookkeeping: an interned parent
    spec id per store row, extended incrementally (O(new rows) per
    rebuild). Spec ids let a rebuild select only the rows of AFFECTED
    parents instead of restaging the whole document."""
    st = getattr(engine, "_device_rebuild_state", None)
    if st is None:
        st = {
            "row_spec": np.full(256, -1, np.int64),
            "spec_table": {},
            "specs": [],
            "spec_rows": [],  # spec id -> [store rows], append-only
            "len": 0,
        }
        engine._device_rebuild_state = st
    return st


def rebuild_chains(engine, *, device="cuda") -> None:
    """Recompute chain-derived structures for every parent touched by
    newly admitted rows: ``_map_tail``/``_map_kids`` + LWW loser
    tombstones from ``converge_maps``; ``_seq_head``/``_next``/
    ``_prev`` sequence links from ``tree_order_ranks``.

    Incremental: only AFFECTED parents (those with new rows since the
    last rebuild) are recomputed — chain state depends solely on which
    rows exist under a parent, so untouched parents' chains stay valid
    verbatim. Host work and kernel dispatch size scale with the
    affected parents' rows, not the document (the device-resident union
    for the firehose path is :mod:`crdt_tpu_torch.ops.resident`).

    The kernel dispatches run on ``device`` under the guard layer's
    ladder (:func:`crdt_tpu_torch.guard.device.dispatch_guarded`): a
    fault injected through the device fault hook retries once, then
    splits the affected parents in half (independent work), then falls
    back to the exact scalar ordering (:func:`_rebuild_host`) —
    bit-identical state. A kernel error, a CUDA error or an
    out-of-memory propagates (the port's narrowed ladder contract).
    Each rung is idempotent: the rebuild clears the affected chains
    before recomputing, so a retry after a part-done rebuild converges
    to the same state."""
    dev = resolve_device(device)
    s = engine.store
    n = s.n
    if n == 0:
        return
    lap = _Laps()
    st = _rebuild_state(engine)

    # -- extend per-row spec ids for new rows (O(new)) -----------------
    row_spec = st["row_spec"]
    if len(row_spec) < n:
        grown = np.full(_bucket(n, floor=8), -1, np.int64)
        grown[: len(row_spec)] = row_spec
        st["row_spec"] = row_spec = grown
    affected: set = set()
    specs = st["specs"]
    spec_table = st["spec_table"]
    spec_rows = st["spec_rows"]
    for r in range(st["len"], n):
        if s.kind[r] == K_GC:
            row_spec[r] = -1
            continue
        spec = engine._parent_spec_of_row(r)
        sid = spec_table.get(spec)
        if sid is None:
            sid = len(specs)
            spec_table[spec] = sid
            specs.append(spec)
            spec_rows.append([])
        row_spec[r] = sid
        spec_rows[sid].append(r)
        affected.add(sid)
    st["len"] = n
    lap("device_merge.specs")
    if not affected:
        return  # only GC fillers admitted: no chain is touched

    from crdt_tpu_torch.guard.device import dispatch_guarded

    sids = sorted(affected)

    def halves():
        if len(sids) < 2:
            return None
        mid = len(sids) // 2
        lo, hi = sids[:mid], sids[mid:]
        return [
            (lambda: _rebuild_kernel(engine, lo, dev),
             lambda: _rebuild_host(engine, lo)),
            (lambda: _rebuild_kernel(engine, hi, dev),
             lambda: _rebuild_host(engine, hi)),
        ]

    dispatch_guarded(
        "engine.rebuild",
        lambda: _rebuild_kernel(engine, sids, dev),
        split=halves,
        host=lambda: _rebuild_host(engine, sids),
    )


def _clear_specs(engine, sids) -> None:
    """Drop chain-derived state for the given parents (shared by the
    kernel and host rebuild rungs; idempotent, so every ladder retry
    starts from the same cleared baseline)."""
    st = engine._device_rebuild_state
    specs, spec_rows = st["specs"], st["spec_rows"]
    for sid in sids:
        spec = specs[sid]
        engine._seq_head.pop(spec, None)
        engine._seq_tail.pop(spec, None)
        for k in engine._map_kids.pop(spec, {}):
            engine._map_head.pop((spec, k), None)
            engine._map_tail.pop((spec, k), None)
        for r in spec_rows[sid]:
            engine._next.pop(r, None)
            engine._prev.pop(r, None)


def _link(engine, spec, rows_in_order) -> None:
    """Materialize one parent's chain links from an ordered row list."""
    prev = None
    for row in rows_in_order:
        if prev is None:
            engine._seq_head[spec] = row
            engine._prev[row] = NULL
        else:
            engine._next[prev] = row
            engine._prev[row] = prev
        prev = row
    if prev is not None:
        engine._next[prev] = NULL
        engine._seq_tail[spec] = prev


def _rebuild_host(engine, sids) -> None:
    """The ladder's last rung: rebuild the given parents' chains
    entirely on host with the exact scalar ordering
    (``order_hard_segment`` — the same oracle the kernel's hostile-
    shape fallback already uses), so a dead device degrades to a
    slower bit-identical answer instead of an exception mid-merge."""
    from crdt_tpu_torch.ops.yata import order_hard_segment

    st = engine._device_rebuild_state
    specs, spec_rows = st["specs"], st["spec_rows"]
    s = engine.store
    _clear_specs(engine, sids)
    for sid in sids:
        spec = specs[sid]
        by_key: Dict[int, List[int]] = {}
        seq_rows: List[int] = []
        for r in spec_rows[sid]:
            k = int(s.key_id[r])
            if k != NO_KEY:
                by_key.setdefault(k, []).append(r)
            else:
                seq_rows.append(r)
        for k, rws in by_key.items():
            engine._map_kids.setdefault(spec, {})[k] = None
            recs = [engine.record_of_row(r) for r in rws]
            ordered = order_hard_segment(
                recs, ref_exists=lambda ref: s.has(*ref)
            )
            tail = s.find(*ordered[-1]) if ordered else None
            if tail is not None:
                engine._map_tail[(spec, k)] = tail
            for r in rws:
                if r != tail and not s.deleted[r]:
                    # LWW loser tombstones: same post-hoc invariant the
                    # kernel path enforces (Yjs Item.integrate)
                    engine._delete_row(r)
        if seq_rows:
            recs = [engine.record_of_row(r) for r in seq_rows]
            ordered = order_hard_segment(
                recs, ref_exists=lambda ref: s.has(*ref)
            )
            _link(engine, spec, [s.find(c, k) for c, k in ordered])


def _rebuild_kernel(engine, sids, device) -> None:
    """One kernel-driven rebuild pass over the given parents on
    ``device`` (the ladder's first rung; see :func:`rebuild_chains`)."""
    from crdt_tpu_torch.ops.merge import converge_maps
    from crdt_tpu_torch.ops.yata import tree_order_ranks

    def put(arr):
        return xfer_put(arr, device=device, label="rebuild")

    lap = _Laps()
    s = engine.store
    st = engine._device_rebuild_state
    specs, spec_rows = st["specs"], st["spec_rows"]
    row_spec = st["row_spec"]
    affected = set(sids)

    # -- select the affected parents' rows: O(their rows), not O(doc) --
    sel = np.sort(
        np.fromiter(
            (r for sid in affected for r in spec_rows[sid]),
            np.int64,
        )
    )
    m = len(sel)

    # -- clear derived state for affected parents only -----------------
    _clear_specs(engine, sids)

    raw_client = s.client[sel]
    clock = s.clock[sel]
    proot = s.parent_root[sel]
    pcl = s.parent_client[sel]
    pck = s.parent_clock[sel]
    kid = s.key_id[sel].astype(np.int32)
    kind = s.kind[sel]
    raw_ocl = s.origin_client[sel]
    ock = s.origin_clock[sel]
    rcl = s.right_client[sel]
    rck = s.right_clock[sel]

    # Dense, order-preserving client remap: real client ids are random
    # 31-bit values (net/replica.py:_random_client_id), which alias
    # the kernels' packed (client << 40 | clock) int64 ids — and every
    # YATA/LWW rule only ever COMPARES client ids, so a rank-dense
    # relabeling leaves all outcomes unchanged. An origin whose client
    # is absent from the subset (a GC'd or foreign origin) maps to -1;
    # same-client origins with out-of-subset clocks fail the packed-id
    # search below instead.
    uniq_clients, client = np.unique(raw_client, return_inverse=True)
    client = client.astype(np.int32)
    opos = np.searchsorted(uniq_clients, np.clip(raw_ocl, 0, None))
    opos_c = np.clip(opos, 0, max(len(uniq_clients) - 1, 0))
    o_found = (raw_ocl >= 0) & (uniq_clients[opos_c] == raw_ocl)
    ocl = np.where(o_found, opos_c, -1).astype(np.int32)

    origin_idx = _origin_rows(client, clock, ocl, ock)
    # an origin that names a row OUTSIDE the subset (GC filler, foreign
    # parent) is an ORPHANING origin for sequences: the scalar engine
    # splices such items after a chain-less row, invisible to the head
    # walk. Distinguish it from "no origin at all" (a chain root).
    orphan = (raw_ocl >= 0) & (origin_idx < 0)
    live = kind != K_GC
    is_map = live & (kid != NO_KEY)
    is_seq = live & (kid == NO_KEY)

    pad = _bucket(m)
    lap("device_merge.select")

    # ---- maps: winner (= chain tail) per (parent, key) segment --------
    if is_map.any():
        order_k, seg_k, winners, _, _, _ = converge_maps(
            put(_pad(client, pad, 0)),
            put(_pad(clock.astype(np.int64), pad, 0)),
            put(_pad(proot != NULL, pad, False)),
            put(_pad(np.where(proot != NULL, proot, pcl).astype(np.int64),
                     pad, -2)),
            put(_pad(np.where(proot != NULL, -1, pck).astype(np.int64),
                     pad, -2)),
            put(_pad(kid, pad, -1)),
            put(_pad(ocl, pad, -1)),
            put(_pad(ock.astype(np.int64), pad, -1)),
            put(np.arange(pad) < m),
            put(np.full(16, -1, np.int32)),
            put(np.full(16, -1, np.int64)),
            put(np.full(16, -1, np.int64)),
            num_segments=pad,
        )
        lap("device_merge.dispatch")
        order_k, seg_sorted, winners = fetch_packed_i32(
            order_k, seg_k, winners
        )
        lap("device_merge.fetch")
        # kernel outputs live in id-sorted SUBSET space; map back to
        # subset positions, then to store rows via `sel`
        seg_row = np.full(pad, NULLI, np.int32)
        seg_row[order_k] = seg_sorted
        winner_of_seg: Dict[int, int] = {}
        for sid in np.unique(seg_row[:m][is_map]):
            w = winners[sid]
            if w != NULLI:
                winner_of_seg[int(sid)] = int(order_k[w])
        # crafted rights on map rows (honest map sets never carry
        # them) shift chain tails in ways the argmax kernel cannot
        # express; those chains take the exact scalar tail instead
        hard_chains: Dict[Tuple, List[int]] = {}
        for j in np.flatnonzero(is_map & (rcl != NULL)):
            j = int(j)
            hard_chains[(int(row_spec[sel[j]]), int(kid[j]))] = []
        for j in np.flatnonzero(is_map):
            j = int(j)
            row = int(sel[j])
            gsid = int(row_spec[row])
            k = int(kid[j])
            if (gsid, k) in hard_chains:
                hard_chains[(gsid, k)].append(j)
                continue
            sid = int(seg_row[j])
            w = winner_of_seg.get(sid)
            spec = specs[gsid]
            engine._map_kids.setdefault(spec, {})[k] = None
            if w == j:
                engine._map_tail[(spec, k)] = row
            elif not s.deleted[row]:
                # LWW loser: the scalar integrate tombstones every
                # non-tail map entry (crdt.js via yjs Item.integrate);
                # enforcing the same invariant post-hoc yields the
                # identical delete set
                engine._delete_row(row)
        if hard_chains:
            from crdt_tpu_torch.ops.yata import order_hard_segment

            for (gsid, k), js in hard_chains.items():
                spec = specs[gsid]
                engine._map_kids.setdefault(spec, {})[k] = None
                # order_hard_segment rebuilds records without keys;
                # chain order depends only on origins/rights
                recs = [engine.record_of_row(int(sel[j])) for j in js]
                ordered = order_hard_segment(
                    recs, ref_exists=lambda ref: engine.store.has(*ref)
                )
                tail = (
                    engine.store.find(*ordered[-1]) if ordered else None
                )
                if tail is not None:
                    engine._map_tail[(spec, k)] = tail
                for j in js:
                    row = int(sel[j])
                    if row != tail and not s.deleted[row]:
                        engine._delete_row(row)
        lap("device_merge.link")

    # ---- sequences: document order per parent -------------------------
    # subset-local indices throughout; `sel` translates back to rows
    seq_rows = np.flatnonzero(is_seq & ~orphan)
    if len(seq_rows):
        local_seg_of: Dict[int, int] = {}  # global spec id -> dense
        seg = np.full(m, -1, np.int32)
        parent_arr = np.full(m, -1, np.int32)
        key1 = np.zeros(m, np.int64)
        key2 = np.zeros(m, np.int64)
        for j in seq_rows:
            j = int(j)
            gsid = int(row_spec[sel[j]])
            seg[j] = local_seg_of.setdefault(gsid, len(local_seg_of))
            if origin_idx[j] >= 0:
                parent_arr[j] = origin_idx[j]
            # raw client ids are safe here: sibling keys are plain
            # int64 lexsort keys, never packed. Clock is NEGATED:
            # same-client same-origin duplicates order clock-DESC
            # (the integrate break rule; see ops/yata.py)
            key1[j] = raw_client[j]
            key2[j] = -clock[j]

        from crdt_tpu_torch.ops.yata import drop_orphan_subtrees

        seg_all = seg.copy()  # pre-drop assignment (hard fallback)
        seq_list = drop_orphan_subtrees(
            (int(j) for j in seq_rows), seg, parent_arr
        )

        # groups whose sibling order the (client, ~clock) key cannot
        # express: right-origin attachments run the exact group-local
        # scan; segments with rights the sibling model cannot express
        # at all (hostile shapes) fall back to a scalar integrate
        hard_local = _rank_conflict_groups(
            engine, seq_list, seg, parent_arr, key1, key2,
            raw_client, clock, rcl, rck,
        )

        num_segments = _bucket(len(local_seg_of), floor=3)
        lap("device_merge.select")
        rank, _ = tree_order_ranks(
            put(_pad(seg, pad, -1)),
            put(_pad(parent_arr, pad, -1)),
            put(_pad(key1, pad, 0)),
            put(_pad(key2, pad, 0)),
            put(np.arange(pad) < m),
            num_segments=num_segments,
        )
        lap("device_merge.dispatch")
        rank = xfer_fetch(rank, label="rebuild.rank")[:m]
        lap("device_merge.fetch")

        by_seg: Dict[int, List[Tuple[int, int]]] = {}
        for j in seq_list:
            if int(seg[j]) in hard_local:
                continue  # linked by the scalar fallback below
            by_seg.setdefault(int(seg[j]), []).append((int(rank[j]), j))
        inv = {lsid: gsid for gsid, lsid in local_seg_of.items()}

        for lsid, pairs in by_seg.items():
            pairs.sort()
            _link(engine, specs[inv[lsid]],
                  [int(sel[j]) for _, j in pairs])

        if hard_local:
            from crdt_tpu_torch.ops.yata import order_hard_segment

            for lsid in hard_local:
                recs = [
                    engine.record_of_row(int(sel[j]))
                    for j in np.flatnonzero(seg_all == lsid)
                ]
                ordered = order_hard_segment(
                    recs, ref_exists=lambda ref: engine.store.has(*ref)
                )
                _link(
                    engine,
                    specs[inv[lsid]],
                    [engine.store.find(c, k) for c, k in ordered],
                )
        lap("device_merge.link")


def _rank_conflict_groups(
    engine, seq_list, seg, parent_arr, key1, key2, client, clock, rcl, rck
) -> set:
    """Replace (client, ~clock) sibling keys with exact scan ranks for
    groups containing right-origin attachments — the only case where
    the lexicographic key diverges from the Yjs integrate scan
    (attachment-free groups, duplicates included, are exact on the
    device key; see ops/yata.py). Returns the set of local segment ids
    whose rights the sibling model cannot express at all (dangling /
    cross-parent / inside-a-member's-subtree — hostile shapes): those
    sequences need the caller's scalar-integrate fallback."""
    from crdt_tpu_torch.ops.yata import _simulate_group

    groups: Dict[Tuple[int, int], List[int]] = {}
    for i in seq_list:
        groups.setdefault((int(seg[i]), int(parent_arr[i])), []).append(i)
    hard: set = set()
    row_of = None  # (client, clock) -> local idx, built on demand
    for (gseg, _), rows in groups.items():
        if gseg in hard:
            continue
        ids = {(int(client[i]), int(clock[i])) for i in rows}
        out_rights = [
            i for i in rows
            if rcl[i] != NULL and (int(rcl[i]), int(rck[i])) not in ids
        ]
        if out_rights:
            from crdt_tpu_torch.ops.yata import right_walk_is_hard

            if row_of is None:
                row_of = {
                    (int(client[j]), int(clock[j])): j
                    for j in range(len(client))
                    if seg[j] >= 0
                }
            for i in out_rights:
                if right_walk_is_hard(
                    (int(rcl[i]), int(rck[i])),
                    ids,
                    row_of.get,
                    lambda cur: int(seg[cur]),
                    gseg,
                    lambda cur: (int(client[cur]), int(clock[cur])),
                    lambda cur: (
                        int(parent_arr[cur]) if parent_arr[cur] >= 0 else None
                    ),
                    len(client),
                ):
                    hard.add(gseg)
                    break
        if gseg in hard:
            continue
        has_attachment = any(
            rcl[i] != NULL and (int(rcl[i]), int(rck[i])) in ids for i in rows
        )
        if not has_attachment:
            continue  # (client, ~clock) keys are exact (see ops/yata.py)
        sibs = [
            {
                "id": (int(client[i]), int(clock[i])),
                "client": int(client[i]),
                "clock": int(clock[i]),
                "right": (
                    (int(rcl[i]), int(rck[i])) if rcl[i] != NULL else None
                ),
            }
            for i in rows
        ]
        ordered = _simulate_group(sibs, ids)
        member_row = {(int(client[i]), int(clock[i])): i for i in rows}
        for pos, sid in enumerate(ordered):
            key1[member_row[sid]] = pos
            key2[member_row[sid]] = 0
    return hard
