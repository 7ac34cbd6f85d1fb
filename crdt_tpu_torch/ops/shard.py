"""The sharded converge — the staged packed pipeline spread over a
device mesh.

The port's counterpart of ``crdt_tpu.ops.shard``. The one-device cold
path (:mod:`crdt_tpu_torch.ops.packed`) stages the whole union into one
flat section array and converges it in one launch sequence. This module
cuts the SAME staged layout at segment granularity across a mesh
(:mod:`crdt_tpu_torch.parallel.mesh`):

1. **Partition** — the union's rows group by full segment identity
   (parent ref + key), and whole segments greedy-balance across K
   shards by depth-weighted row count. YATA origins and LWW key chains
   never cross segments, so every shard's converge is independent. A
   DOMINATING sequence segment is pre-cut at DFS-suffix subtree
   granularity (:func:`crdt_tpu_torch.ops.staging.dfs_suffix_boundaries`,
   the cut the staging split uses) and its pieces spread ACROSS shards.
   Multi-doc unions partition by whole docs first.
2. **Stage** — each shard runs the ordinary packed staging
   (layout-only, ``staging.stage(_sections=)``), then every shard's
   eight sections are padded to COMMON bucket sizes and narrow-encoded
   with ONE shared encoding tuple (``_encode_sections(force=)``),
   giving a [K, L] block.
3. **Converge** — :func:`crdt_tpu_torch.parallel.gossip.
   make_packed_shard_step`: mesh entry k widens row k of the block and
   runs the fused converge on its own rows (one ``seg_argmax_scan``
   and one ``stream_scatter`` launch a shard); the only traffic
   between entries is the **boundary exchange** — the per-shard state
   vectors on a narrow wire, gathered onto the first entry and
   max-merged (the fetch audits the merge against the host-staged
   vectors and raises on divergence).
4. **Assemble** — the host maps each shard's block-local results
   through its own translation tables and row map; concatenating the
   per-shard streams with disjoint segment ids reproduces the
   one-device result byte for byte (tests/test_torch_shard.py).

Route selection: ``CRDT_TPU_SHARDS`` (unset = one shard a visible device
of the converge's type: one card gives 1, the route off; ``0``/``1``
disables) and ``CRDT_TPU_SHARD_MIN_ROWS`` (default 2^15). An explicit
count above the visible devices places the shards round-robin
(:func:`crdt_tpu_torch.parallel.mesh.make_mesh`).

On a pod of processes (a ``torch.distributed`` group) every process
stages the whole union alike, agrees a digest of its plan with the
others, uploads only its own entries' rows of the block and the wire,
launches only their converges, and receives every shard's result and
wire through the pod's all-gathers: each process assembles the same
result and runs the same audit. The one-shot replay,
the streaming executor's stream shards, the multi-tenant server's cold
batches and the fleet replay take this route through
:func:`active_for`.

Evidence: the ``shard.dispatches`` / ``shard.boundary_bytes`` /
``shard.seam_rows`` counters and the ``shard.shards`` gauge.
"""

from __future__ import annotations

import os
import zlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from crdt_tpu_torch.obs.tracer import get_tracer
from crdt_tpu_torch.ops import packed, staging
from crdt_tpu_torch.ops.device import (
    NULLI,
    bucket_grid,
    record_staged_widths,
    wide_staging_forced,
    xfer_fetch,
    xfer_put,
)
from crdt_tpu_torch.parallel import mesh as mesh_ops
from crdt_tpu_torch.parallel.gossip import make_packed_shard_step

SHARD_ENV = "CRDT_TPU_SHARDS"
MIN_ROWS_ENV = "CRDT_TPU_SHARD_MIN_ROWS"
MIN_ROWS_DEFAULT = 1 << 15


def _visible_count(device) -> int:
    kind = torch.device(device).type
    if kind == "cuda" and not torch.cuda.is_available():
        return 0
    return mesh_ops.default_size(device)


def shard_count(n_shards: Optional[int] = None, *, device="cuda") -> int:
    """Resolved shard count: explicit arg, else ``CRDT_TPU_SHARDS``,
    else one shard a visible device of ``device``'s type (one card, or
    the CPU, gives 1; on a pod of processes, one a device of every
    process). 0/1 means the sharded route is off."""
    if n_shards is not None:
        return max(0, int(n_shards))
    raw = os.environ.get(SHARD_ENV, "")
    if raw != "":
        try:
            return max(0, int(raw))
        except ValueError:
            pass
    return _visible_count(device)


def min_rows() -> int:
    raw = os.environ.get(MIN_ROWS_ENV, "")
    if raw != "":
        try:
            return max(0, int(raw))
        except ValueError:
            pass
    return MIN_ROWS_DEFAULT


def active_for(n_rows: int, n_shards: Optional[int] = None, *,
               device="cuda") -> bool:
    """Should this union take the sharded route? >1 shard resolved
    AND the union is big enough to amortize the per-shard costs."""
    return (shard_count(n_shards, device=device) > 1
            and n_rows >= min_rows())


class ShardPlan(NamedTuple):
    """Host-side staging result of :func:`stage`: K repadded per-shard
    plans + the common-encoded [K, L] section block + the narrow
    boundary wire. Field for field the reference's."""

    plans: tuple            # per-shard PackedPlan (repadded metadata)
    row_maps: tuple         # per-shard caller-row index arrays
    block: np.ndarray       # [K, L] staged sections, shared encoding
    wire: np.ndarray        # [K, W] boundary wire (SV + meta)
    encs: tuple             # shared per-section encodings
    num_segments: int       # common S bucket
    seq_bucket: int         # common B bucket
    map_bucket: int         # common M bucket
    rank_rounds: int        # max over shards
    map_rounds: int         # max over shards
    sv_clients: np.ndarray  # dense rank -> raw client id
    sv_host: np.ndarray     # [K, C] host copy of the per-shard SVs
    sv_mode: str            # wire encoding: 'i16' / 'hilo' / 'wide'
    n_rows: int             # total valid rows staged
    widths: dict = {}       # per-section chosen widths (one record
                            # at upload, like packed._put_mat)
    wide_bytes: int = 0     # pre-diet byte baseline for the record


class ShardResult(NamedTuple):
    """Merged caller-space result — duck-compatible with
    :class:`~crdt_tpu_torch.ops.packed.PackedResult` (the replay gather
    consumes it unchanged), plus the boundary exchange's merged swarm
    state vector."""

    win_rows: np.ndarray
    stream_seg: np.ndarray
    stream_row: np.ndarray
    hard_rows: tuple = ()
    global_sv: Optional[np.ndarray] = None  # [C] dense-rank clocks+1
    sv_clients: Optional[np.ndarray] = None


def _chain_weights(counts: np.ndarray,
                   origin_counts: np.ndarray) -> np.ndarray:
    """Greedy-partition weights honoring CHAIN DEPTH, not just row
    count: a shard's converge runs ``ceil(log2(longest chain))``
    pointer-doubling rounds over ALL its rows, and depth is bounded
    above by the segment's origin-bearing rows + 1. Returns
    per-segment integer weights ``rows * max(1, ceil(log2(1 +
    origin_rows)))``."""
    depth = np.maximum(origin_counts, 0) + 1
    rounds = np.maximum(
        1, np.ceil(np.log2(np.maximum(depth, 1))).astype(np.int64)
    )
    return np.asarray(counts, np.int64) * rounds


def _partition(cols, K: int):
    """Whole-segment greedy partition of the union's valid rows into
    K depth-weighted shards. Returns ``(shard_rows, pb_tag)``: a list
    of caller-row index arrays (some possibly empty: fewer segments
    than shards) and the cross-shard pre-cut's parent-ref tag column
    (None when nothing was pre-cut), or None for an empty union.

    A DOMINATING sequence segment (more rows than ``total // K``) is
    pre-cut at DFS-suffix subtree granularity and the pieces assign
    MONOTONICALLY across shards. ``pb_tag`` carries per-piece offsets
    of ``(piece+1) << 45`` for the ``parent_b`` column: each piece
    becomes its own full segment identity inside its shard (the
    offsets cannot collide with real parent refs, all < 2^44 by the
    guard), pieces order by tag within a shard and by shard across
    shards — so the assembler's same-parent run merge stitches them
    back in exact document order.

    Duplicate ids are dropped GLOBALLY first (keep the first caller
    row, the stager's rule): equal-id rows under different parents
    would land in different shards, where no shard-local dedup could
    see the pair.

    Multi-doc unions (a ``doc`` column with >1 distinct doc) partition
    by DOC first: a doc's whole converge stays on one shard, docs
    greedy-balance across shards, and the duplicate drop is
    doc-scoped."""
    valid = np.asarray(cols["valid"], bool)
    idx = np.flatnonzero(valid)
    if not len(idx):
        return None
    dv = (np.asarray(cols["doc"], np.int64)[idx]
          if "doc" in cols else np.zeros(len(idx), np.int64))
    multi_doc = len(idx) > 0 and int(dv.max()) != int(dv.min())
    cl_v = np.asarray(cols["client"], np.int64)[idx]
    ck_v = np.asarray(cols["clock"], np.int64)[idx]
    so = np.lexsort((np.arange(len(idx)), ck_v, cl_v, dv))
    dup = np.r_[
        False,
        (cl_v[so][1:] == cl_v[so][:-1]) & (ck_v[so][1:] == ck_v[so][:-1])
        & (dv[so][1:] == dv[so][:-1]),
    ]
    if dup.any():
        keep = np.sort(so[~dup])
        idx, dv = idx[keep], dv[keep]
    oc_live = np.asarray(cols["origin_client"], np.int64)[idx] >= 0
    if multi_doc:
        # doc-first: greedy balance whole docs, heaviest first into
        # the lightest bin (fewer docs than shards leaves shards empty)
        docs_u, doc_inv, doc_counts = np.unique(
            dv, return_inverse=True, return_counts=True
        )
        doc_oc = np.bincount(
            doc_inv, weights=oc_live, minlength=len(docs_u)
        ).astype(np.int64)
        weights = _chain_weights(doc_counts, doc_oc)
        bins = np.zeros(len(docs_u), np.int64)
        loads = np.zeros(K, np.int64)
        for d in np.argsort(-weights, kind="stable"):
            b = int(np.argmin(loads))
            bins[d] = b
            loads[b] += int(weights[d])
        shard_of_row = bins[doc_inv]
        return [idx[shard_of_row == k] for k in range(K)], None
    pir = np.asarray(cols["parent_is_root"], bool)[idx]
    pa = np.asarray(cols["parent_a"], np.int64)[idx]
    pb = np.asarray(cols["parent_b"], np.int64)[idx]
    kid = np.asarray(cols["key_id"], np.int64)[idx]
    order = np.lexsort((kid, pb, pa, pir))
    same = (
        (pir[order][1:] == pir[order][:-1])
        & (pa[order][1:] == pa[order][:-1])
        & (pb[order][1:] == pb[order][:-1])
        & (kid[order][1:] == kid[order][:-1])
    )
    seg_sorted = np.cumsum(np.r_[True, ~same]) - 1
    seg = np.empty(len(idx), np.int64)
    seg[order] = seg_sorted
    counts = np.bincount(seg)
    seg_oc = np.bincount(
        seg, weights=oc_live, minlength=len(counts)
    ).astype(np.int64)

    # cross-shard subtree pre-cut: a dominating sequence segment's
    # DFS-suffix pieces spread across shards instead of bounding one.
    # The pieces' loads pre-seed the greedy bins; cut segments skip
    # the whole-segment loop below.
    pb_tag = None
    piece_of = {}     # seg id -> (rows_s, piece index per row)
    loads = np.zeros(K, np.int64)
    big = np.flatnonzero(
        counts > max(2048, len(idx) // max(K, 1))
    )
    if len(big):
        cl_i = np.asarray(cols["client"], np.int64)[idx]
        ck_i = np.asarray(cols["clock"], np.int64)[idx]
        rr_i = (np.asarray(cols["right_client"], np.int64)[idx]
                if "right_client" in cols
                else np.full(len(idx), -1, np.int64))
        oc_i = np.asarray(cols["origin_client"], np.int64)[idx]
        ock_i = np.asarray(cols["origin_clock"], np.int64)[idx]
        kid_i = np.asarray(cols["key_id"], np.int64)[idx]
        pb_i = np.asarray(cols["parent_b"], np.int64)[idx]
        uniq_cl = np.unique(cl_i)
        # id-key packing + tag-offset guards, the stager's bounds:
        # skip the pre-cut (never the route) when a bound trips
        feasible = (
            len(uniq_cl) < (1 << 22)
            and int(ck_i.max(initial=0)) < (1 << staging._CLOCK_BITS)
            and int(ock_i.max(initial=0)) < (1 << staging._CLOCK_BITS)
            and int(np.abs(pb_i).max(initial=0)) < (1 << 44)
        )
        for s in (big.tolist() if feasible else []):
            rows_s = np.flatnonzero(seg == s)
            if (kid_i[rows_s] >= 0).any() or (rr_i[rows_s] >= 0).any():
                continue  # map segments / right origins stay whole
            # compact-local forest, exactly as the stager builds it:
            # rows in id order, origins resolved same-segment
            so_l = np.lexsort((ck_i[rows_s], cl_i[rows_s]))
            rs = rows_s[so_l]
            cd = np.searchsorted(uniq_cl, cl_i[rs])
            ikey_l = (cd << staging._CLOCK_BITS) | ck_i[rs]
            ocd = np.searchsorted(uniq_cl, np.clip(oc_i[rs], 0, None))
            okey_l = np.where(
                oc_i[rs] >= 0,
                (ocd << staging._CLOCK_BITS) | ock_i[rs], np.int64(-1),
            )
            p = np.searchsorted(ikey_l, okey_l)
            pc = np.clip(p, 0, len(rs) - 1)
            par_l = np.where(
                (okey_l >= 0) & (ikey_l[pc] == okey_l), pc, -1
            )
            # hostile cyclic origins: leave the segment whole
            m = len(rs)
            f = np.where(par_l >= 0, par_l,
                         np.arange(m, dtype=np.int64))
            for _ in range(max(1, (max(m, 2) - 1).bit_length() + 1)):
                f = f[f]
            if (par_l[f] >= 0).any():
                continue
            width = -(-m // K)
            pos, cuts = staging.dfs_suffix_boundaries(
                par_l, cd, (m - 1) - np.arange(m, dtype=np.int64),
                width, max_pieces=2 * K + 2,
            )
            if len(cuts) < 2:
                continue
            piece = (np.searchsorted(cuts, pos, side="right")
                     - 1).astype(np.int64)
            np_c = len(cuts)
            pshard = (piece * K) // np_c  # monotone piece -> shard
            prows = np.bincount(piece, minlength=np_c)
            in_piece = (par_l >= 0) & (
                piece[np.clip(par_l, 0, m - 1)] == piece
            )
            poc = np.bincount(
                piece, weights=in_piece, minlength=np_c
            ).astype(np.int64)
            pw = _chain_weights(prows, poc)
            for j in range(np_c):
                loads[(j * K) // np_c] += int(pw[j])
            if pb_tag is None:
                pb_tag = np.zeros(
                    len(np.asarray(cols["valid"])), np.int64
                )
            pb_tag[idx[rs]] = (piece + 1) << 45
            piece_of[s] = (rs, pshard)

    # greedy balance by DEPTH-WEIGHTED load, heaviest segments first
    # into the lightest bin (pre-cut pieces are already seeded above)
    weights = _chain_weights(counts, seg_oc)
    bins = np.zeros(len(counts), np.int64)
    for s in np.argsort(-weights, kind="stable"):
        if s in piece_of:
            continue
        b = int(np.argmin(loads))
        bins[s] = b
        loads[b] += int(weights[s])
    shard_of_row = bins[seg]
    for s, (rs, pshard) in piece_of.items():
        shard_of_row[rs] = pshard
    return [idx[shard_of_row == k] for k in range(K)], pb_tag


# per-section pad values for the common-bucket repad (seg_off pads
# with 0: offsets of absent segments are never read through a live
# sseg)
_PAD_VALS = {"seg_off": 0}


def _repad_sections(secs, S: int, B: int, M: int,
                    S2: int, B2: int, M2: int):
    """Pad one shard's eight sections from its natural buckets to the
    common ones. Only ``seq_first`` is position-dependent (its root
    block sits at offset B, and moves to B2); every other section pads
    at the tail — values are block-local indices below their own
    bucket, unchanged by a wider block."""
    out = []
    for name, arr in secs:
        pad = _PAD_VALS.get(name, -1)
        if name == "seq_first":
            new = np.full(B2 + S2, -1, arr.dtype)
            new[:B] = arr[:B]
            new[B2:B2 + S] = arr[B:B + S]
        else:
            tgt = {"seq_seg": B2, "seg_off": S2, "seq_parent": B2,
                   "seq_next": B2, "map_key": M2, "map_chain_end": M2,
                   "map_root_end": S2}[name]
            new = np.full(tgt, pad, arr.dtype)
            new[: len(arr)] = arr
        out.append((name, new))
    return out


def _empty_sections(S2: int, B2: int, M2: int):
    """An all-padding shard (fewer segments than shards): the fused
    body on pure padding yields no winners and an all-hole stream."""
    z = np.int64
    return [
        ("seq_seg", np.full(B2, -1, z)),
        ("seg_off", np.zeros(S2, z)),
        ("seq_parent", np.full(B2, -1, z)),
        ("seq_next", np.full(B2, -1, z)),
        ("seq_first", np.full(B2 + S2, -1, z)),
        ("map_key", np.full(M2, -1, z)),
        ("map_chain_end", np.full(M2, -1, z)),
        ("map_root_end", np.full(S2, -1, z)),
    ]


def _empty_plan(S2: int, B2: int, M2: int) -> staging.PackedPlan:
    return staging.PackedPlan(
        mat=None, n=0, num_segments=S2, seq_bucket=B2, map_bucket=M2,
        order=np.empty(0, np.int32), clients=np.empty(0, np.int64),
        rank_rounds=2, map_rounds=2,
        map_back=np.full(M2, NULLI, np.int32),
        seq_back=np.full(B2, NULLI, np.int32),
        seg_counts=np.zeros(S2, np.int64),
    )


def stage(cols, n_shards: Optional[int] = None, *,
          device="cuda") -> Optional[ShardPlan]:
    """Partition + per-shard staging + common-bucket encode (the
    tracer's ``pack`` span covers the per-shard layout passes).
    ``device`` only resolves the default shard count. Returns None when
    the union cannot take the sharded route (a shard exceeded the
    packed bounds, no valid rows, or <2 shards resolved) — callers fall
    back to the one-device path."""
    K = shard_count(n_shards, device=device)
    if K <= 1:
        return None
    part = _partition(cols, K)
    if part is None:
        return None
    shard_rows, pb_tag = part

    col_arrays = {k: np.asarray(v) for k, v in cols.items()}
    if pb_tag is not None:
        # cross-shard pre-cut: the piece tags ride a COPY of the
        # parent_b column (the caller's cols stay untouched — a
        # fallback to the one-device path must see the original refs)
        col_arrays["parent_b"] = (
            col_arrays["parent_b"].astype(np.int64) + pb_tag
        )
    layouts = []  # (plan, secs, rows) per non-empty shard; None empty
    for rows_k in shard_rows:
        if not len(rows_k):
            layouts.append(None)
            continue
        sub = {k: v[rows_k] for k, v in col_arrays.items()}
        secs: list = []
        plan = staging.stage(sub, _sections=secs)
        if plan is None:
            return None
        layouts.append((plan, secs, rows_k))

    live = [lay for lay in layouts if lay is not None]
    if not live:
        return None
    S2 = max(lay[0].num_segments for lay in live)
    B2 = max(lay[0].seq_bucket for lay in live)
    M2 = max(lay[0].map_bucket for lay in live)
    rank2 = max(lay[0].rank_rounds for lay in live)
    map2 = max(lay[0].map_rounds for lay in live)

    wide = wide_staging_forced()
    padded = []
    for lay in layouts:
        if lay is None:
            padded.append(_empty_sections(S2, B2, M2))
        else:
            plan, secs, _ = lay
            padded.append(_repad_sections(
                secs, plan.num_segments, plan.seq_bucket,
                plan.map_bucket, S2, B2, M2,
            ))
    # ONE shared encoding tuple: a section narrows only when it
    # narrows on EVERY shard (forcing hilo elsewhere is exact)
    force = []
    for i, name in enumerate(staging.SECTION_NAMES):
        kind = "i32" if wide else staging._SECTION_NARROW[name]
        if not wide:
            for secs_k in padded:
                arr = secs_k[i][1]
                enc = (staging._narrow_ident(arr) if kind == "i16"
                       else staging._narrow_delta_ref(arr))
                if enc is None:
                    kind = "hilo"
                    break
        force.append(kind)
    flats = []
    encs = widths = None
    for secs_k in padded:
        flat, encs, widths = staging._encode_sections(
            secs_k, wide, force=None if wide else tuple(force)
        )
        flats.append(flat)
    block = np.stack(flats)

    # repadded per-shard plans (assembly metadata at common buckets)
    plans = []
    row_maps = []
    for lay in layouts:
        if lay is None:
            plans.append(_empty_plan(S2, B2, M2))
            row_maps.append(np.empty(0, np.int64))
            continue
        plan, _, rows_k = lay
        mb = np.full(M2, NULLI, np.int32)
        mb[: len(plan.map_back)] = plan.map_back
        sb = np.full(B2, NULLI, np.int32)
        sb[: len(plan.seq_back)] = plan.seq_back
        sc = np.zeros(S2, np.int64)
        sc[: len(plan.seg_counts)] = plan.seg_counts
        ws = plan.win_src
        if ws is not None:
            # identity pad to the common bucket (pad slots read their
            # own — always empty — winner)
            ws2 = np.arange(S2, dtype=np.int64)
            ws2[: len(ws)] = ws
            ws = ws2
        plans.append(plan._replace(
            num_segments=S2, seq_bucket=B2, map_bucket=M2,
            map_back=mb, seq_back=sb, seg_counts=sc, win_src=ws,
        ))
        row_maps.append(np.asarray(rows_k, np.int64))

    # the boundary wire: each shard's partial SV over one shared dense
    # client table — the whole payload between mesh entries
    client = col_arrays["client"].astype(np.int64)
    clock = col_arrays["clock"].astype(np.int64)
    valid = col_arrays["valid"].astype(bool)
    uniq = np.unique(client[valid])
    C = max(len(uniq), 1)
    svs = np.zeros((K, C), np.int64)
    n_rows = sum(len(rows_k) for rows_k in shard_rows)
    for k, rows_k in enumerate(shard_rows):
        if len(rows_k):
            r = np.searchsorted(uniq, client[rows_k])
            np.maximum.at(svs[k], r, clock[rows_k] + 1)
    # the wire narrows with the section codec: one identity int16
    # stretch when every clock fits, hi/lo below 2^31, int64 past it
    top = int(svs.max(initial=0))
    if wide or top >= (1 << 31):
        sv_mode = "wide"
        wire = svs
    elif top <= (1 << 15) - 1:
        sv_mode = "i16"
        wire = svs.astype(np.int16)
    else:
        sv_mode = "hilo"
        svh, svl = staging._split_hi_lo(svs)
        wire = np.concatenate([svh, svl], axis=1)

    return ShardPlan(
        plans=tuple(plans),
        row_maps=tuple(row_maps),
        block=block,
        wire=wire,
        encs=encs,
        num_segments=S2,
        seq_bucket=B2,
        map_bucket=M2,
        rank_rounds=rank2,
        map_rounds=map2,
        sv_clients=uniq,
        sv_host=svs,
        sv_mode=sv_mode,
        n_rows=n_rows,
        widths=dict(widths or {}),
        wide_bytes=sum(
            5 * bucket_grid(lay[0].n, floor=6) * 4 for lay in live
        ),
    )


class ShardHandle(NamedTuple):
    """An enqueued sharded converge: the plan, the per-shard results
    gathered onto the mesh's first entry (on a pod, this process's),
    the merged state vector there, and (on the card) the CUDA event
    recorded after the gather."""
    plan: ShardPlan
    out: torch.Tensor
    gsv: torch.Tensor
    event: Optional[torch.cuda.Event]


def _plan_digest(splan: ShardPlan) -> int:
    """A 32-bit digest of everything a pod process uploads or assembles
    from: the block, the wire, the host vectors, the row maps and the
    static shapes."""
    h = 0
    for arr in (splan.block, splan.wire, splan.sv_host, splan.sv_clients,
                *splan.row_maps):
        h = zlib.crc32(np.ascontiguousarray(arr).view(np.uint8), h)
    meta = (splan.encs, splan.num_segments, splan.seq_bucket,
            splan.map_bucket, splan.rank_rounds, splan.map_rounds,
            splan.sv_mode, splan.block.shape, splan.wire.shape)
    return zlib.crc32(repr(meta).encode(), h)


def converge_async(splan: ShardPlan, *, device="cuda",
                   mesh: Optional[mesh_ops.Mesh] = None) -> ShardHandle:
    """ENQUEUE the sharded converge on a K-entry mesh (``mesh``, else
    :func:`~crdt_tpu_torch.parallel.mesh.make_mesh` of K entries over
    ``device``'s type): one accounted upload of each shard's row of the
    block and wire onto its entry, the per-entry launch sequences, the
    boundary exchange and the gather of the results onto the first
    entry. On a pod the processes first agree the plan's digest (a
    process that staged another plan raises), and each uploads and
    launches only its own entries. On one controller nothing waits on a
    device; :func:`converge_fetch` is the one sync."""
    K = splan.block.shape[0]
    if mesh is None:
        mesh = mesh_ops.make_mesh(K, device=device)
    if mesh.devices.size != K:
        raise ValueError(f"a {K}-shard plan needs a {K}-entry mesh, "
                         f"got {mesh.devices.size}")
    local = mesh_ops.local_entries(mesh)
    dev0 = mesh_ops.home(mesh)
    step = make_packed_shard_step(
        mesh,
        num_segments=splan.num_segments,
        seq_bucket=splan.seq_bucket,
        map_bucket=splan.map_bucket,
        rank_rounds=splan.rank_rounds,
        map_rounds=splan.map_rounds,
        encs=splan.encs,
        sv_len=max(len(splan.sv_clients), 1),
        sv_mode=splan.sv_mode,
    )
    tracer = get_tracer()
    if mesh_ops.is_pod(mesh):
        # before the first upload: every process must hold this plan
        mesh_ops.agree(mesh, _plan_digest(splan))
    with tracer.span("converge.dispatch"), \
            torch.profiler.record_function("crdt.shard.dispatch"):
        record_staged_widths(
            splan.widths, splan.block.nbytes, splan.wide_bytes
        )
        blocks: list = [None] * K
        wires: list = [None] * K
        for k, dev in local:
            blocks[k] = xfer_put(splan.block[k], device=dev,
                                 label="shard.mat")
        for k, dev in local:
            wires[k] = xfer_put(splan.wire[k], device=dev,
                                label="shard.wire")
        outs, gsv = step(blocks, wires)
        out = mesh_ops.all_gather(outs, dev0, mesh)
        event = None
        if dev0.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev0))
    if tracer.enabled:
        tracer.count("shard.dispatches")
        tracer.gauge("shard.shards", K)
        # the boundary payload crossing the mesh a round
        tracer.count("shard.boundary_bytes", int(splan.wire.nbytes))
        n_seams = sum(len(p.seam_rows) for p in splan.plans)
        if n_seams:
            tracer.count("shard.seam_rows", n_seams)
    return ShardHandle(splan, out, gsv, event)


def converge_fetch(handle: ShardHandle) -> ShardResult:
    """Wait for an enqueued sharded converge and assemble the K
    per-shard results into ONE caller-space result (the tracer's
    ``converge.fetch`` span). Fails LOUDLY when the boundary exchange
    disagrees with the host staging — a shard that silently dropped
    rows or mis-decoded the wire must never propagate a wrong
    document."""
    splan = handle.plan
    S2, B2 = splan.num_segments, splan.seq_bucket
    with get_tracer().span("converge.fetch"), \
            torch.profiler.record_function("crdt.shard.fetch"):
        if handle.event is not None:
            handle.event.synchronize()  # execution wait, not transfer
        h = xfer_fetch(handle.out, label="shard.out")
        gs = xfer_fetch(handle.gsv, label="shard.sv")
    want = splan.sv_host.max(axis=0) if len(splan.sv_host) else gs
    if len(splan.sv_clients) and not np.array_equal(
            gs[: len(splan.sv_clients)], want):
        raise RuntimeError(
            "sharded converge boundary exchange diverged from the "
            "host-staged state vectors (wire codec or gather fault)"
        )
    win_parts = []
    seg_parts = []
    row_parts = []
    hard: list = []
    for k, plan in enumerate(splan.plans):
        rm = splan.row_maps[k]
        res = packed._assemble_result(plan, h[k])
        if len(rm):
            win_parts.append(np.where(
                res.win_rows >= 0,
                rm[np.clip(res.win_rows, 0, len(rm) - 1)], NULLI,
            ))
            row_parts.append(np.where(
                res.stream_row >= 0,
                rm[np.clip(res.stream_row, 0, len(rm) - 1)], NULLI,
            ))
            hard.extend(int(rm[r]) for r in res.hard_rows)
        else:
            win_parts.append(np.full(S2, NULLI, np.int64))
            row_parts.append(np.full(B2, NULLI, np.int64))
        # disjoint segment ids across shards: offset by the shard's
        # block position (values only cut runs in the assembler)
        seg_parts.append(np.where(
            res.stream_seg >= 0, res.stream_seg + k * S2, NULLI
        ))
    return ShardResult(
        win_rows=np.concatenate(win_parts),
        stream_seg=np.concatenate(seg_parts).astype(np.int32),
        stream_row=np.concatenate(row_parts),
        hard_rows=tuple(hard),
        global_sv=gs,
        sv_clients=splan.sv_clients,
    )


def converge(splan: ShardPlan, *, device="cuda",
             mesh: Optional[mesh_ops.Mesh] = None) -> ShardResult:
    """Stage -> one sharded launch sequence -> one fetch (the
    production two-step seam, synchronously)."""
    return converge_fetch(converge_async(splan, device=device, mesh=mesh))
