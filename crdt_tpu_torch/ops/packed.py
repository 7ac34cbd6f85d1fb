"""Packed one-dispatch cold converge: the device half, in torch.

The port's counterpart of the device half of ``crdt_tpu.ops.packed``.
Host staging (:mod:`crdt_tpu_torch.ops.staging`) lays the union out as
eight int sections of one flat array; this module converges a staged
:class:`~crdt_tpu_torch.ops.staging.PackedPlan` in three device
interactions:

  1. ONE host->device upload of the flat staged array from pinned host
     memory (at its narrow width — the widening runs on the device);
     plans staged with ``put=`` (at >= ``EAGER_PUT_MIN_ROWS`` rows) have
     already shipped their three section groups during staging;
  2. ONE launch sequence on the current stream: the widening prelude,
     the LWW map block (the ``seg_argmax_scan`` kernel plus winner-chain
     pointer doubling) and the sequence side (DFS ranks by Wyllie list
     ranking, then the ``stream_scatter`` kernel into document order);
  3. ONE device->host fetch of a single packed int32 result.

There is no sort and no host sync inside step 2: every loop runs a
round count fixed on the host at staging (``rank_rounds``,
``map_rounds``).

The second half is the live replica's device round
(:class:`crdt_tpu_torch.models.incremental.IncrementalReplay`): the
packed delta of one round is spliced IN PLACE into the replica's
resident ``[7, cap]`` int64 matrix, the rows of the touched segments are
selected, and only they re-converge (:func:`_splice_select_converge` →
:func:`_converge_core` → :func:`_rank_compact`, which runs the
``stream_scatter`` kernel). JAX donated the matrix to the dispatch; the
port writes into it, so a round's one upload is the delta block.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from crdt_tpu_torch.obs.tracer import get_tracer
from crdt_tpu_torch.ops.device import (
    NULLI,
    bucket_grid,
    dense_ranks_sorted,
    dfs_ranks,
    lexsort,
    pack_id,
    pointer_double,
    record_staged_widths,
    resolve_device,
    run_edge_lookup,
    scatter_perm,
    searchsorted_ids,
    xfer_fetch,
    xfer_put,
)
from crdt_tpu_torch.ops.kernels import seg_argmax_scan, stream_scatter
from crdt_tpu_torch.ops.lww import map_winners
from crdt_tpu_torch.ops.staging import (
    _SECTION_GROUPS,
    PackedPlan,
    _section_sizes,
    segkey_of,
)

_I32 = torch.int32


def _join_hi_lo(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Device inverse of the stager's ``_split_hi_lo``."""
    return (hi.to(_I32) << 16) | ((lo.to(_I32) + 0x8000) & 0xFFFF)


def _widen_delta_ref(v: torch.Tensor) -> torch.Tensor:
    """Device inverse of the 'd16' encoding: 0 is the no-reference
    sentinel (-1), anything else is ``index - value``."""
    v = v.to(_I32)
    idx = torch.arange(v.shape[0], dtype=_I32, device=v.device)
    return torch.where(v == 0, torch.full_like(v, NULLI), idx - v)


def _decode_sections(flat: torch.Tensor, sizes, encs) -> list:
    """Device inverse of the stager's ``_encode_sections`` — the
    widening prelude. ``flat`` is the staged array as uploaded (int16
    narrow or int32 wide); each section widens to the exact int32
    values the stager encoded."""
    out = []
    off = 0
    for size, enc in zip(sizes, encs):
        if enc == "hilo":
            out.append(_join_hi_lo(flat[off:off + size],
                                   flat[off + size:off + 2 * size]))
            off += 2 * size
        elif enc == "d16":
            out.append(_widen_delta_ref(flat[off:off + size]))
            off += size
        else:  # 'i16' / 'i32': identity widen
            out.append(flat[off:off + size].to(_I32))
            off += size
    return out


def _map_block(mkey, cend, rend, *, map_rounds: int) -> torch.Tensor:
    """Map side of the fused converge: segmented Lamport argmax over
    chain-parent runs + winner-chain doubling, all at map-bucket width.
    Each node's children sit in one contiguous run (staging grouped
    them), ordered (client asc, clock asc); the scan's run-prefix
    argmax read at a run's END is the run's (max client, min clock)
    member — the last child of the Yjs sibling order. Every gather
    index is clamped exactly where the reference clamps it."""
    M = mkey.shape[0]
    dev = mkey.device
    live = mkey >= 0
    mflag = torch.where(live, mkey & 1, torch.ones_like(mkey)).to(_I32)
    mcl = torch.where(live, mkey >> 1, torch.full_like(mkey, NULLI)).to(_I32)
    arg = seg_argmax_scan(mcl, mflag)
    iota_m = torch.arange(M, dtype=_I32, device=dev)
    last = torch.where(cend >= 0, arg[cend.clamp(0, M - 1)], iota_m)
    tail = pointer_double(last, max_iters=map_rounds)
    start = torch.where(
        rend >= 0, arg[rend.clamp(0, M - 1)], torch.full_like(rend, NULLI)
    )
    return torch.where(
        start >= 0, tail[start.clamp(0, M - 1)], torch.full_like(start, NULLI)
    ).to(_I32)


def _converge_packed_body(sseg, soff, cp, nxt, fc, mkey, cend, rend, *,
                          num_segments: int, seq_bucket: int,
                          map_bucket: int, rank_rounds: int,
                          map_rounds: int) -> torch.Tensor:
    """The fused convergence over the staged layout sections. Returns
    one packed int32 tensor:

      [ win_pos[S] | stream_perm[B] ]

    - win_pos: grouped map-block position of each segment's winner
      (-1 for non-map / empty segments; the host maps back through
      ``plan.map_back``);
    - stream_perm: compact sequence index at each document-order
      position, grouped by segment id ascending (-1 padding at the
      tail; the host maps back through ``plan.seq_back``).
    """
    B, S = seq_bucket, num_segments
    dev = sseg.device

    win_pos = _map_block(mkey, cend, rend, map_rounds=map_rounds)

    # ---- sequence side: DFS ranks over the staged sibling tables,
    # then document order as the scatter out[off[seg] + rank] = row
    c_ok = sseg >= 0
    mB = B + S
    seg0 = sseg.clamp(min=0)
    parent = torch.where(c_ok & (cp >= 0), cp, B + seg0)
    parent = torch.where(c_ok, parent, torch.full_like(parent, mB)).to(_I32)
    dist = dfs_ranks(parent, nxt.to(_I32), fc.to(_I32), c_ok, S,
                     rank_rounds=rank_rounds)
    # staged segment ids are < S, so B + seg0 indexes a virtual root;
    # the clamp stands in for the reference's implicit gather clamp
    root_dist = dist[(B + seg0).clamp(max=mB - 1)]
    c_rank = torch.where(c_ok, root_dist - dist[:B] - 1,
                         torch.full_like(root_dist, NULLI))
    pos = torch.where(
        c_ok & (c_rank >= 0),
        soff[sseg.clamp(0, S - 1)] + c_rank,
        torch.full_like(c_rank, NULLI),
    )
    perm = stream_scatter(pos.to(_I32), B)
    return torch.cat([win_pos, perm.to(dev)])


class PackedResult(NamedTuple):
    win_rows: np.ndarray     # [S] original row of each map winner (-1 none)
    stream_seg: np.ndarray   # [B] doc-order segment ids (-1 padding)
    stream_row: np.ndarray   # [B] doc-order original rows (-1 padding)
    hard_rows: tuple = ()    # rows marking segments needing the scalar
                             # fallback (right shapes the sibling-rank
                             # model cannot express)


class ConvergeHandle(NamedTuple):
    """An enqueued converge: the plan, the device result, and (on the
    card) the CUDA event recorded after the launch sequence."""
    plan: PackedPlan
    out: torch.Tensor
    event: Optional[torch.cuda.Event]


def _plan_args(plan: PackedPlan) -> dict:
    return dict(
        num_segments=plan.num_segments,
        seq_bucket=plan.seq_bucket,
        map_bucket=plan.map_bucket,
        rank_rounds=plan.rank_rounds,
        map_rounds=plan.map_rounds,
    )


def _put_mat(plan: PackedPlan, device) -> torch.Tensor:
    """A matrix plan's ONE upload through the xfer seam, with the
    per-section width/savings record made at the same moment."""
    record_staged_widths(
        dict(plan.staged_widths), plan.mat.nbytes,
        5 * bucket_grid(plan.n, floor=6) * 4,
    )
    return xfer_put(plan.mat, device=device, label="converge.mat")


def _device_sections(plan: PackedPlan, device) -> list:
    """The eight widened int32 sections on ``device``."""
    sizes = _section_sizes(plan.num_segments, plan.seq_bucket,
                           plan.map_bucket)
    if not plan.dev:
        return _decode_sections(_put_mat(plan, device), sizes, plan.encs)
    secs = []
    for dref, (a, b) in zip(plan.dev, _SECTION_GROUPS):
        if dref.device != device:
            raise ValueError(
                f"plan was shipped to {dref.device}, converge asked "
                f"for {device}"
            )
        secs.extend(_decode_sections(dref, sizes[a:b], plan.encs[a:b]))
    return secs


def converge_async(plan: PackedPlan, *, device="cuda") -> ConvergeHandle:
    """ENQUEUE the fused convergence and return without waiting for
    the device. On the card every step is asynchronous on the current
    stream — the pinned upload, the widening prelude, both kernels and
    the doubling loops — and the handle carries a CUDA event recorded
    after the last launch; :func:`converge_fetch` is the only sync.

    Torch has no buffer donation: the uploaded staged array is
    referenced only until the widening prelude has read it, after
    which the caching allocator hands its block to the converge's
    temporaries (the reuse JAX got by donating the buffer)."""
    dev = resolve_device(device)
    with get_tracer().span("converge.dispatch"), \
            torch.profiler.record_function("crdt.converge.dispatch"):
        secs = _device_sections(plan, dev)
        out = _converge_packed_body(*secs, **_plan_args(plan))
        event = None
        if dev.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
    return ConvergeHandle(plan, out, event)


def converge_fetch(handle: ConvergeHandle) -> PackedResult:
    """Wait for an enqueued converge (the event), fetch its one packed
    result and assemble it into caller row space (the tracer's
    ``converge.fetch`` span: wait + transfer + assembly)."""
    with get_tracer().span("converge.fetch"), \
            torch.profiler.record_function("crdt.converge.fetch"):
        if handle.event is not None:
            handle.event.synchronize()  # execution wait, not transfer
        h = xfer_fetch(handle.out, label="converge.out")
        return _assemble_result(handle.plan, h)


def converge(plan: PackedPlan, *, device="cuda") -> PackedResult:
    """Stage -> single launch sequence -> single fetch."""
    return converge_fetch(converge_async(plan, device=device))


def _assemble_result(plan: PackedPlan, h: np.ndarray) -> PackedResult:
    """The one fetch -> caller-space result. The device returns
    block-local positions; the host maps them through the staged
    translation tables (``map_back``/``seq_back``) and rebuilds the
    per-segment stream boundaries from the host-known counts."""
    s = plan.num_segments
    b = plan.seq_bucket
    win = h[:s]
    if plan.win_src is not None:
        # map-chain split stitch: a split map segment's true winner
        # lives in the piece holding its max-root chain's bottom; the
        # first piece reads it from there and the other pieces mute
        src = plan.win_src
        win = np.where(src >= 0, win[np.clip(src, 0, s - 1)], -1)
    perm = h[s:s + b]
    counts = plan.seg_counts
    k = int(counts.sum())
    stream_seg = np.full(b, NULLI, np.int32)
    stream_seg[:k] = np.repeat(np.arange(s, dtype=np.int32), counts)
    mb = plan.map_back
    sb = plan.seq_back
    return PackedResult(
        win_rows=np.where(
            win >= 0, mb[np.clip(win, 0, len(mb) - 1)], NULLI
        ),
        stream_seg=stream_seg,
        stream_row=np.where(
            perm >= 0, sb[np.clip(perm, 0, len(sb) - 1)], NULLI
        ),
        hard_rows=plan.hard_rows,
    )


def plan_from_reference(fields: dict) -> PackedPlan:
    """A reference (``crdt_tpu``) plan, given as a dict of numpy
    arrays, tuples and static ints (``plan._asdict()``), as the port's
    plan — the state carried across, so one identical staged plan can
    run through both converge bodies. Only matrix-staged plans carry
    across: an eagerly shipped plan's sections live on the other
    framework's device."""
    names = PackedPlan._fields
    missing = [k for k in names if k not in fields]
    if missing:
        raise ValueError(f"reference plan lacks fields {missing}")
    if fields.get("dev") or fields.get("mat") is None:
        raise ValueError(
            "only a matrix-staged plan (stage(put=None)) carries across"
        )
    vals = {k: fields[k] for k in names}
    vals["mat"] = np.asarray(vals["mat"])
    for k in ("hard_rows", "staged_widths", "encs", "seam_rows"):
        vals[k] = tuple(vals[k])
    vals["dev"] = ()
    return PackedPlan(**vals)


# ---------------------------------------------------------------------------
# the incremental device round (the live replica's steady state)
# ---------------------------------------------------------------------------

_I64_MAX = (1 << 63) - 1


def _rank_compact(parent, c_client, pos_desc, c_seg, c_ok, row_of, *,
                  num_segments: int, rank_rounds: Optional[int],
                  client_bits: int, qbits: int, doc_off) -> tuple:
    """Sibling sort + tree tables + climb + Wyllie ranking + document
    order over the COMPACT sequence space (B rows + S virtual roots).
    ``row_of[i]`` is the caller-space row of compact row i, used only to
    label the output stream.

    Sibling order is (parent, client asc, clock DESC); ``pos_desc`` must
    be descending in clock within one (parent, client) group. ``doc_off``
    [S] is each segment's first compact position: document order is the
    ``stream_scatter`` kernel's out[doc_off[seg] + rank] = row. Every
    gather index is in range by construction or clamped where the
    reference's gather clamps."""
    B = parent.shape[0]
    S = num_segments
    mB = B + S
    dev = parent.device
    pbits = int(mB).bit_length()
    if pbits + client_bits + qbits <= 63:
        sibkey = ((parent.to(torch.int64) << (client_bits + qbits))
                  | (c_client.to(torch.int64) << qbits)
                  | pos_desc.to(torch.int64))
        sord2 = torch.argsort(sibkey, stable=True)
    else:
        sord2 = lexsort([
            parent.to(torch.int64),
            (c_client.to(torch.int64) << qbits) | pos_desc.to(torch.int64),
        ])
    p_s = parent[sord2]
    same_group = torch.cat([p_s[1:] == p_s[:-1],
                            torch.zeros(1, dtype=torch.bool, device=dev)])
    nxt_sorted = torch.where(same_group, torch.roll(sord2, -1),
                             NULLI).to(_I32)
    next_sib = scatter_perm(sord2, nxt_sorted)
    first_pos, _ = run_edge_lookup(p_s, mB, side="left")
    first_child = torch.where(
        first_pos >= 0, sord2[first_pos.long().clamp(0, B - 1)], NULLI
    ).to(_I32)

    dist_to_end = dfs_ranks(parent, next_sib, first_child, c_ok, S,
                            rank_rounds=rank_rounds)
    # c_seg < S on every compact row (at most S touched segments)
    root_dist = dist_to_end[B + c_seg.long().clamp(min=0)]
    c_rank = torch.where(c_ok, root_dist - dist_to_end[:B] - 1, NULLI)

    ranked = c_ok & (c_rank >= 0)
    pos = torch.where(
        ranked,
        doc_off[c_seg.long().clamp(0, S - 1)].to(_I32) + c_rank.to(_I32),
        NULLI,
    )
    perm = stream_scatter(pos.to(_I32), B)
    okp = perm >= 0
    permc = perm.long().clamp(0, B - 1)
    stream_seg = torch.where(okp, c_seg[permc], NULLI).to(_I32)
    stream_row = torch.where(okp, row_of[permc], NULLI).to(_I32)
    return stream_seg, stream_row


def _converge_core(client, clock, pref, kid, oc, ock, valid, *,
                   num_segments: int, seq_bucket: int,
                   rank_rounds: Optional[int] = None,
                   map_rounds: Optional[int] = None) -> torch.Tensor:
    """The GENERAL packed convergence: its own id sort, dedup, origin
    resolution and segment numbering on the device — the engine of the
    incremental touched-segment path, where rows live resident and no
    host staging precomputes the layout. Returns one int32 tensor

      [ win_rows[S] | stream_seg[B] | stream_row[B] ]

    whose row indices refer to the CALLER's row space."""
    n = client.shape[0]
    S = num_segments

    # shared id-sort + dedup + origin resolution
    ikey = torch.where(valid, pack_id(client, clock), 1 << 62)
    order = torch.argsort(ikey, stable=True)
    ikey = ikey[order]
    client = client[order]
    clock = clock[order]
    pref = pref[order]
    kid = kid[order]
    oc = oc[order]
    ock = ock[order]
    valid = valid[order]
    dup = torch.cat([torch.zeros(1, dtype=torch.bool, device=ikey.device),
                     ikey[1:] == ikey[:-1]])
    uniq_valid = valid & ~dup
    origin_idx = searchsorted_ids(ikey, pack_id(oc, ock))

    is_map = uniq_valid & (kid >= 0)
    is_seq = uniq_valid & (kid < 0)

    # one composite segment key covers maps AND sequences; sequence keys
    # sort below map keys (bit 62) and invalid rows (max)
    segkey = torch.where(uniq_valid, segkey_of(pref, kid.to(torch.int64)),
                         _I64_MAX)
    sorder = torch.argsort(segkey, stable=True)
    seg_sorted = dense_ranks_sorted(segkey[sorder])
    seg = scatter_perm(sorder, seg_sorted)
    seg_map = torch.where(is_map, seg, NULLI)

    winners = map_winners(
        seg_map, client, clock, origin_idx, is_map, S,
        rows_id_ranked=True, chain_rounds=map_rounds, client_bits=23,
    )
    win_rows = torch.where(
        winners >= 0, order[winners.long().clamp(0, n - 1)], NULLI
    ).to(_I32)

    # ---- sequence ranking in COMPACT space: sorder's prefix holds
    # exactly the sequence rows, and the bucket B >= n_seq covers them
    B = seq_bucket
    mB = B + S
    sub = sorder[:B]
    c_ok = is_seq[sub]
    c_seg = torch.where(c_ok, seg[sub], NULLI)
    # full-space row -> sorder position (compact index for seq rows)
    inv_sorder = torch.argsort(sorder, stable=True).to(_I32)
    o = origin_idx[sub].long()
    o_ok = c_ok & (o >= 0)
    o_c = o.clamp(0, n - 1)
    o_seg = torch.where(o_ok, seg[o_c], NULLI)
    same_seg = o_ok & (o_seg == c_seg)
    c_parent = torch.where(same_seg, inv_sorder[o_c], NULLI).to(_I32)
    parent = torch.where(c_ok & (c_parent >= 0), c_parent,
                         B + c_seg.clamp(min=0))
    parent = torch.where(c_ok, parent, mB).to(_I32)

    # sibling order by (parent, client asc, clock DESC): rows are in id
    # order here, so within one client the descending row index is the
    # descending clock
    c_client = client[sub]
    pos_desc = (n - 1) - sub
    # a segment's first sorted position IS its document-order offset
    doc_off, _ = run_edge_lookup(seg_sorted, S, side="left")
    stream_seg, stream_row = _rank_compact(
        parent, c_client, pos_desc, c_seg, c_ok, order[sub],
        num_segments=S, rank_rounds=rank_rounds, client_bits=23,
        qbits=int(max(n - 1, 1)).bit_length(), doc_off=doc_off,
    )
    return torch.cat([win_rows, stream_seg, stream_row])


def stage_resident_delta(client, clock, pref, kid, oc, ock,
                         dev_segs, kpad: int) -> np.ndarray:
    """Stage one incremental round's DELTA against a resident base: the
    ``[8, kpad]`` int64 block :func:`_splice_select_converge` consumes.
    Rows 0-6 are the packed delta columns (dense clients, clocks, parent
    refs; ``valid`` = resolvable parent), row 7 the touched-segment keys
    (ascending segkeys, int64-max padded). A warm round ships THIS block
    only; the doc's history is already resident."""
    k = len(client)
    delta = np.zeros((8, kpad), np.int64)
    delta[3:6, :] = -1
    delta[7, :] = np.iinfo(np.int64).max
    delta[7, : len(dev_segs)] = dev_segs
    pref = np.asarray(pref, np.int64)
    delta[0, :k] = client
    delta[1, :k] = clock
    delta[2, :k] = np.maximum(pref, 0)
    delta[3, :k] = kid
    delta[4, :k] = oc
    delta[5, :k] = ock
    delta[6, :k] = pref >= 0
    return delta


def _splice_select_converge(mat: torch.Tensor, delta8: torch.Tensor,
                            n_off: int, *, num_segments: int,
                            sel_bucket: int, seq_bucket: int,
                            rank_rounds: Optional[int] = None,
                            map_rounds: Optional[int] = None) -> torch.Tensor:
    """One incremental round on the device, with no host sync: splices
    the delta (``delta8`` rows 0-6) into the resident matrix at column
    ``n_off`` IN PLACE, selects the rows of the touched segments
    (``delta8`` row 7: ascending segkeys, int64-max padding) and
    re-converges only that compact subset. Returns

      [ out[S + 2B] | sel_rows[sel_bucket] ] int32

    where out's row indices are LOCAL to sel_rows; callers map back with
    sel_rows (resident row ids, -1 padding). The caller grows ``mat``
    first so that the delta fits."""
    kpad = delta8.shape[1]
    if n_off + kpad > mat.shape[1]:
        raise ValueError(
            f"delta of {kpad} columns at {n_off} overflows a resident "
            f"matrix of {mat.shape[1]}"
        )
    touched_sorted = delta8[7]
    mat[:, n_off:n_off + kpad] = delta8[:7]
    client = mat[0].to(_I32)
    clock = mat[1]
    pref = mat[2]
    kid = mat[3].to(_I32)
    oc = mat[4].to(_I32)
    ock = mat[5]
    valid = mat[6] != 0

    segkey = segkey_of(pref, kid.to(torch.int64))
    pos = torch.searchsorted(touched_sorted, segkey)
    pos_c = pos.clamp(0, touched_sorted.shape[0] - 1)
    sel = valid & (touched_sorted[pos_c] == segkey)
    skey = torch.where(sel, segkey, _I64_MAX)
    sel_rows = torch.argsort(skey, stable=True)[:sel_bucket]
    sub_valid = sel[sel_rows]
    out = _converge_core(
        client[sel_rows], clock[sel_rows], pref[sel_rows], kid[sel_rows],
        oc[sel_rows], ock[sel_rows], sub_valid,
        num_segments=num_segments, seq_bucket=seq_bucket,
        rank_rounds=rank_rounds, map_rounds=map_rounds,
    )
    return torch.cat([out, torch.where(sub_valid, sel_rows, NULLI).to(_I32)])


def new_resident_mat(cap: int, device) -> torch.Tensor:
    """An empty ``[7, cap]`` resident matrix: key-id and origin columns
    null (-1), the rest 0."""
    mat = torch.zeros((7, cap), dtype=torch.int64, device=device)
    mat[3:6] = -1
    return mat


def _grow_mat(mat: torch.Tensor, new_cap: int) -> torch.Tensor:
    """Capacity growth for the resident matrix: a new tensor on the same
    device with the old columns copied in."""
    big = new_resident_mat(new_cap, mat.device)
    big[:, :mat.shape[1]] = mat
    return big


def _relabel_mat(mat: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Rewrite dense client ids through an old->new permutation after a
    mid-table client insertion (order-preserving interning), in place:
    rows 0 (client) and 4 (origin client). Both new rows are computed
    before either is written."""
    perm = perm.to(device=mat.device, dtype=torch.int64)
    top = perm.shape[0] - 1
    cl = perm[mat[0].clamp(0, top)]
    oc = mat[4]
    oc = torch.where(oc >= 0, perm[oc.clamp(0, top)], oc)
    mat[0] = cl
    mat[4] = oc
    return mat


# running count of warm device-route converge dispatches (one per
# `_splice_select_converge` round): a plain module int, the same
# single-process pattern as the kernel wrappers' launch counts
device_dispatch_count = 0


def count_device_dispatch(n: int = 1) -> None:
    global device_dispatch_count
    device_dispatch_count += n
