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
``map_rounds``). So on the card the torch glue before and after the
two kernels is captured once per plan signature as two CUDA graphs
(:class:`ConvergeGraphs`) and replayed: a dispatch is a few host calls
however many small ops the glue holds, and the kernels still launch
through this module's names on every converge.

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

import threading
from collections import OrderedDict
from functools import partial
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


def _map_keys(mkey):
    """The scan's inputs from the staged map keys: the Lamport client
    (-1 on padding rows) and the run-start flag (padding rows are their
    own runs)."""
    live = mkey >= 0
    mflag = torch.where(live, mkey & 1, torch.ones_like(mkey)).to(_I32)
    mcl = torch.where(live, mkey >> 1, torch.full_like(mkey, NULLI)).to(_I32)
    return mcl, mflag


def _map_tail(arg, cend, rend, *, map_rounds: int) -> torch.Tensor:
    """Map side of the fused converge after the scan, at map-bucket
    width: each chain's last child, winner-chain doubling and each
    segment's winner position. Each node's children sit in one
    contiguous run (staging grouped them), ordered (client asc, clock
    asc); the scan's run-prefix argmax ``arg`` read at a run's END is
    the run's (max client, min clock) member — the last child of the
    Yjs sibling order. Every gather index is clamped exactly where the
    reference clamps it."""
    M = arg.shape[0]
    iota_m = torch.arange(M, dtype=_I32, device=arg.device)
    last = torch.where(cend >= 0, arg[cend.clamp(0, M - 1)], iota_m)
    tail = pointer_double(last, max_iters=map_rounds)
    start = torch.where(
        rend >= 0, arg[rend.clamp(0, M - 1)], torch.full_like(rend, NULLI)
    )
    return torch.where(
        start >= 0, tail[start.clamp(0, M - 1)], torch.full_like(start, NULLI)
    ).to(_I32)


def _seq_positions(sseg, soff, cp, nxt, fc, *, num_segments: int,
                   seq_bucket: int, rank_rounds: int) -> torch.Tensor:
    """Sequence side up to the scatter: DFS ranks over the staged
    sibling tables, then each row's document-order target
    ``off[seg] + rank`` (-1 for rows outside every sequence)."""
    B, S = seq_bucket, num_segments
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
    return torch.where(
        c_ok & (c_rank >= 0),
        soff[sseg.clamp(0, S - 1)] + c_rank,
        torch.full_like(c_rank, NULLI),
    ).to(_I32)


def _converge_pre(sseg, soff, cp, nxt, fc, mkey, cend, rend, *,
                  num_segments: int, seq_bucket: int, map_bucket: int,
                  rank_rounds: int, map_rounds: int) -> tuple:
    """The torch glue before the two kernels: ``(mcl, mflag, pos)``,
    the scan's client and flag columns and the scatter's targets."""
    mcl, mflag = _map_keys(mkey)
    pos = _seq_positions(sseg, soff, cp, nxt, fc, num_segments=num_segments,
                         seq_bucket=seq_bucket, rank_rounds=rank_rounds)
    return mcl, mflag, pos


def _converge_post(arg, perm, cend, rend, *,
                   map_rounds: int) -> torch.Tensor:
    """The torch glue after the two kernels: the map tail from the
    scan's ``arg``, then the one packed result beside the scatter's
    ``perm``."""
    return torch.cat([_map_tail(arg, cend, rend, map_rounds=map_rounds),
                      perm])


def _converge_packed_body(sseg, soff, cp, nxt, fc, mkey, cend, rend, *,
                          num_segments: int, seq_bucket: int,
                          map_bucket: int, rank_rounds: int,
                          map_rounds: int) -> torch.Tensor:
    """The fused convergence over the staged layout sections:
    :func:`_converge_pre`, the two kernels, :func:`_converge_post`.
    Returns one packed int32 tensor:

      [ win_pos[S] | stream_perm[B] ]

    - win_pos: grouped map-block position of each segment's winner
      (-1 for non-map / empty segments; the host maps back through
      ``plan.map_back``);
    - stream_perm: compact sequence index at each document-order
      position, grouped by segment id ascending (-1 padding at the
      tail; the host maps back through ``plan.seq_back``).
    """
    mcl, mflag, pos = _converge_pre(
        sseg, soff, cp, nxt, fc, mkey, cend, rend,
        num_segments=num_segments, seq_bucket=seq_bucket,
        map_bucket=map_bucket, rank_rounds=rank_rounds,
        map_rounds=map_rounds)
    arg = seg_argmax_scan(mcl, mflag)
    perm = stream_scatter(pos, seq_bucket)
    return _converge_post(arg, perm, cend, rend, map_rounds=map_rounds)


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


def _put_mat(plan: PackedPlan, device, out=None) -> torch.Tensor:
    """A matrix plan's ONE upload through the xfer seam (into ``out``
    when given), with the per-section width/savings record made at the
    same moment."""
    record_staged_widths(
        dict(plan.staged_widths), plan.mat.nbytes,
        5 * bucket_grid(plan.n, floor=6) * 4,
    )
    return xfer_put(plan.mat, device=device, label="converge.mat", out=out)


def _staged_inputs(plan: PackedPlan, device) -> list:
    """The staged plan on ``device`` as uploaded: the one narrow matrix,
    or the three section groups staging shipped eagerly."""
    if not plan.dev:
        return [_put_mat(plan, device)]
    for dref in plan.dev:
        if dref.device != device:
            raise ValueError(
                f"plan was shipped to {dref.device}, converge asked "
                f"for {device}"
            )
    return list(plan.dev)


def _decode_staged(staged: list, plan: PackedPlan) -> list:
    """The eight widened int32 sections of :func:`_staged_inputs`'s
    tensors (the widening prelude)."""
    sizes = _section_sizes(plan.num_segments, plan.seq_bucket,
                           plan.map_bucket)
    if not plan.dev:
        return _decode_sections(staged[0], sizes, plan.encs)
    secs = []
    for dref, (a, b) in zip(staged, _SECTION_GROUPS):
        secs.extend(_decode_sections(dref, sizes[a:b], plan.encs[a:b]))
    return secs


def _device_sections(plan: PackedPlan, device) -> list:
    """The eight widened int32 sections on ``device``."""
    return _decode_staged(_staged_inputs(plan, device), plan)


# ---------------------------------------------------------------------------
# the card's route: the glue around the two kernels as two CUDA graphs
# ---------------------------------------------------------------------------

# signatures whose graphs stay captured; the least recently used one is
# dropped beyond this (a tenant server meets a handful of signatures, a
# replay one)
GRAPH_CACHE_SIZE = 8


def graph_key(plan: PackedPlan, device) -> tuple:
    """The static signature a captured converge is replayed for: the
    plan's buckets and round counts, its section sizes and encodings,
    the staged tensors' dtypes and shapes, and the device. Two plans of
    one key run the same launch sequence on inputs of the same
    layout."""
    if plan.dev:
        staged = tuple((str(t.dtype), tuple(t.shape)) for t in plan.dev)
    else:
        staged = ((str(plan.mat.dtype), tuple(plan.mat.shape)),)
    return (tuple(_plan_args(plan).items()),
            _section_sizes(plan.num_segments, plan.seq_bucket,
                           plan.map_bucket),
            tuple(plan.encs), staged, str(device))


class ConvergeGraphs:
    """One signature's converge as two captured halves around the two
    hand-written kernels: ``pre`` (widening prelude, the scan's inputs,
    the sequence side up to the scatter's targets) and ``post`` (the
    map tail and the packed result). The kernels stay ordinary calls
    through this module's names, so every converge launches and counts
    them as the eager body does.

    ``capture(fn)`` returns ``(graph, outputs)``: ``fn()``'s outputs,
    which every ``graph.replay()`` rewrites in place. The static inputs
    start as copies of ``plan``'s staged tensors (``staged``) and the
    kernels' outputs of no map row, so they hold a valid converge
    whether or not a capture runs what it records."""

    def __init__(self, plan: PackedPlan, staged: list, capture):
        self.ins = [t.clone() for t in staged]
        args = _plan_args(plan)
        self.seq_bucket = plan.seq_bucket
        dev = self.ins[0].device
        M = _section_sizes(plan.num_segments, plan.seq_bucket,
                           plan.map_bucket)[5]
        self.arg = torch.zeros(M, dtype=_I32, device=dev)
        self.perm = torch.full((plan.seq_bucket,), NULLI, dtype=_I32,
                               device=dev)
        # the stream and event of the last converge enqueued on it
        self.stream = self.event = None

        def pre():
            secs = _decode_staged(self.ins, plan)
            return (*_converge_pre(*secs, **args), secs[6], secs[7])

        self.pre, (self.mcl, self.mflag, self.pos, cend, rend) = \
            capture(pre)
        self.post, (self.out,) = capture(lambda: (_converge_post(
            self.arg, self.perm, cend, rend, map_rounds=plan.map_rounds),))

    def run(self, plan: PackedPlan) -> torch.Tensor:
        """Enqueue one converge of ``plan`` (of this signature) on the
        current stream; returns its own copy of the packed result, so a
        later run cannot overwrite a result not yet fetched."""
        dev = self.ins[0].device
        if plan.dev:
            for dst, src in zip(self.ins, plan.dev):
                dst.copy_(src, non_blocking=True)
        else:
            _put_mat(plan, dev, out=self.ins[0])
        self.pre.replay()
        arg = seg_argmax_scan(self.mcl, self.mflag)
        perm = stream_scatter(self.pos, self.seq_bucket)
        self.arg.copy_(arg)
        self.perm.copy_(perm)
        self.post.replay()
        return self.out.clone()

    def retire(self) -> None:
        """Wait for the last converge enqueued on these graphs, so that
        dropping them never frees memory the card still reads."""
        if self.event is not None:
            self.event.synchronize()


class GraphCache:
    """The captured converges by :func:`graph_key`, least recently used
    first; never more than ``GRAPH_CACHE_SIZE``. ``lock`` serializes
    the dispatches that use it (a cached pair's static tensors are
    shared)."""

    def __init__(self):
        self.lock = threading.Lock()
        self._entries: OrderedDict = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key):
        entry = self._entries.get(key)
        if entry is not None:
            self._entries.move_to_end(key)
        return entry

    def put(self, key, entry) -> None:
        self._entries[key] = entry
        self._entries.move_to_end(key)
        while len(self._entries) > GRAPH_CACHE_SIZE:
            _, old = self._entries.popitem(last=False)
            old.retire()


_GRAPHS = GraphCache()


def _cuda_capture(fn, *, pool, stream):
    """``fn()`` captured into a new CUDA graph on ``stream`` with the
    memory pool ``pool``. Errors raise: there is no eager fallback."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            outs = fn()
        finally:
            graph.capture_end()
    return graph, outs


def _graph_dispatch(plan: PackedPlan, dev: torch.device):
    """The card's converge: a replay of the plan's signature, or, the
    first time a signature is seen, the eager body (which serves the
    converge and warms both halves) and then its capture. Returns the
    result and the event recorded after it."""
    stream = torch.cuda.current_stream(dev)
    key = graph_key(plan, dev)
    entry = _GRAPHS.get(key)
    if entry is None:
        path = "capture"
        staged = _staged_inputs(plan, dev)
        out = _converge_packed_body(*_decode_staged(staged, plan),
                                    **_plan_args(plan))
        side = torch.cuda.Stream(dev)
        side.wait_stream(stream)
        entry = ConvergeGraphs(plan, staged, partial(
            _cuda_capture, pool=torch.cuda.graph_pool_handle(),
            stream=side))
        stream.wait_stream(side)
        _GRAPHS.put(key, entry)
    else:
        path = "replay"
        if entry.stream is not None and entry.stream != stream:
            # the static tensors' last user ran on another stream
            stream.wait_event(entry.event)
        out = entry.run(plan)
    event = torch.cuda.Event()
    # crdtlint: disable=CL203 (a CUDA event, not a recorder's)
    event.record(stream)
    entry.stream, entry.event = stream, event
    get_tracer().count("converge.graph", labels={"path": path})
    return out, event


def converge_async(plan: PackedPlan, *, device="cuda") -> ConvergeHandle:
    """ENQUEUE the fused convergence and return without waiting for
    the device; :func:`converge_fetch` is the only sync.

    On the card every step is asynchronous on the current stream: the
    pinned upload, the ``pre`` graph, both kernels, the ``post`` graph
    and the result's copy (:class:`ConvergeGraphs`, cached by
    :func:`graph_key`; a new signature runs the eager body once and is
    captured), and the handle carries a CUDA event recorded after them.
    Elsewhere the eager body runs and the handle has no event."""
    dev = resolve_device(device)
    with get_tracer().span("converge.dispatch"):
        if dev.type != "cuda":
            out = _converge_packed_body(*_device_sections(plan, dev),
                                        **_plan_args(plan))
            return ConvergeHandle(plan, out, None)
        with torch.cuda.device(dev), _GRAPHS.lock:
            out, event = _graph_dispatch(plan, dev)
    return ConvergeHandle(plan, out, event)


def converge_fetch(handle: ConvergeHandle) -> PackedResult:
    """Wait for an enqueued converge (the event), fetch its one packed
    result and assemble it into caller row space (the tracer's
    ``converge.fetch`` span: wait + transfer + assembly)."""
    with get_tracer().span("converge.fetch"):
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
# `_splice_select_converge` round, one per pooled flush): a plain module
# int, the same single-process pattern as the kernel wrappers' launch
# counts
device_dispatch_count = 0


def count_device_dispatch(n: int = 1) -> None:
    global device_dispatch_count
    device_dispatch_count += n


# ---------------------------------------------------------------------------
# the POOLED resident matrix (the multi-tenant server's warm docs)
# ---------------------------------------------------------------------------
#
# N warm docs co-located in ONE device allocation: rows carry their doc's
# POOL SLOT as lane 7 and store doc-LOCAL dense client / parent ids, and
# every dispatch composes DOC-COMPOSITE ids on the fly from per-slot base
# offsets (disjoint composite ranges keep dedup, origin resolution and
# segment numbering doc-local with no change to `_converge_core`). A doc
# joining or growing its id table never relabels any OTHER doc's rows.
# JAX donated the matrix to each of these functions; the port writes
# into it in place, except `_pool_grow` and `_pool_compact`, which
# return a new tensor.

_POOL_FILL = (0, 0, 0, -1, -1, -1, 0, -1)  # an empty column, per lane


def stage_pooled_delta(client, clock, pref, kid, oc, ock, slot,
                       pos, kpad: int, pool_cap: int):
    """Stage one POOLED round's delta: the ``[8, kpad]`` int64 block plus
    the ``[kpad]`` int32 scatter positions
    :func:`_pool_splice_select_converge` consumes. Rows 0-6 follow
    :func:`stage_resident_delta` (doc-LOCAL dense ids), row 7 is the
    doc's pool slot. Padding positions land at ``pool_cap`` and are
    dropped by the splice; the touched-segment keys travel as their own
    operand."""
    k = len(client)
    delta = np.zeros((8, kpad), np.int64)
    delta[3:6, :] = -1
    delta[7, :] = -1
    pref = np.asarray(pref, np.int64)
    delta[0, :k] = client
    delta[1, :k] = clock
    delta[2, :k] = np.maximum(pref, 0)
    delta[3, :k] = kid
    delta[4, :k] = oc
    delta[5, :k] = ock
    delta[6, :k] = pref >= 0
    delta[7, :k] = slot
    ppos = np.full(kpad, pool_cap, np.int32)
    ppos[:k] = pos
    return delta, ppos


def _pool_splice(mat: torch.Tensor, delta8: torch.Tensor,
                 pos: torch.Tensor) -> None:
    """``mat[:, pos] = delta8`` in place, DROPPING every column whose
    position lies outside the matrix (the stager's ``pool_cap`` padding)
    — JAX's ``mode="drop"`` scatter made explicit, with no host sync: a
    kept column adds ``new - old`` at its own (distinct) position, which
    is a set; a dropped one adds zero at column 0."""
    cap = mat.shape[1]
    keep = (pos >= 0) & (pos < cap)
    idx = torch.where(keep, pos.long(), 0)
    step = torch.where(keep, delta8.to(mat.dtype) - mat[:, idx], 0)
    mat.index_add_(1, idx, step)


def _pool_splice_body(mat, delta8, pos, touched_sorted, cbase, pbase, *,
                      num_segments: int, sel_bucket: int, seq_bucket: int,
                      rank_rounds: Optional[int] = None,
                      map_rounds: Optional[int] = None) -> torch.Tensor:
    """Shared body of the pooled splice+select+converge (see
    :func:`_pool_splice_select_converge` for the contract). Splices
    ``mat`` in place and returns the packed int32 result."""
    _pool_splice(mat, delta8, pos)
    live = mat[6] != 0
    # the dead slot -1 maps to 0 here; the live mask zeroes its bases
    slot = mat[7].clamp(0, cbase.shape[0] - 1)
    cb = torch.where(live, cbase[slot], 0)
    pb = torch.where(live, pbase[slot], 0)
    # composite ids are int64 until the base is added; only then does
    # the client narrow to int32, as in the reference
    client = (mat[0] + cb).to(_I32)
    clock = mat[1]
    pref = mat[2] + pb
    kid = mat[3].to(_I32)
    oc0 = mat[4]
    oc = torch.where(oc0 >= 0, oc0 + cb, oc0).to(_I32)
    ock = mat[5]

    segkey = segkey_of(pref, kid.to(torch.int64))
    tpos = torch.searchsorted(touched_sorted, segkey)
    tpos_c = tpos.clamp(0, touched_sorted.shape[0] - 1)
    sel = live & (touched_sorted[tpos_c] == segkey)
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


def _pool_splice_select_converge(mat, delta8, pos, touched_sorted,
                                 cbase, pbase, *, num_segments: int,
                                 sel_bucket: int, seq_bucket: int,
                                 rank_rounds: Optional[int] = None,
                                 map_rounds: Optional[int] = None):
    """One warm dispatch for EVERY pooled doc's delta: scatter-splice the
    combined delta block into the pooled matrix IN PLACE at the docs'
    extent positions, compose doc-composite client / origin / parent ids
    from the per-slot bases, select the rows of the touched COMPOSITE
    segments, and re-converge that compact subset — the
    :func:`_splice_select_converge` contract lifted from one doc to the
    whole warm set. Returns ``(mat, [ out[S + 2B] | sel_rows[sel_bucket]
    ])``; sel_rows are POOL positions (callers map back through their
    extents).

    ``touched_sorted`` must hold ascending composite segkeys
    (``sk_local + (pbase[slot] << _KID_BITS)``, int64-max padded) and
    ``cbase``/``pbase`` the per-slot id base offsets — disjoint ranges
    per doc, so every cross-doc comparison inside `_converge_core` is
    decided by the doc part of the key."""
    out = _pool_splice_body(
        mat, delta8, pos, touched_sorted, cbase, pbase,
        num_segments=num_segments, sel_bucket=sel_bucket,
        seq_bucket=seq_bucket, rank_rounds=rank_rounds,
        map_rounds=map_rounds,
    )
    return mat, out


def _pool_splice_select_converge_nodonate(mat, delta8, pos, touched_sorted,
                                          cbase, pbase, **static):
    """Twin of :func:`_pool_splice_select_converge` for repeat-dispatch
    consumers (a probe re-driving one staged pool): same contract, on a
    copy, so the input matrix is left as it was."""
    return _pool_splice_select_converge(
        mat.clone(), delta8, pos, touched_sorted, cbase, pbase, **static)


def new_pool_mat(cap: int, device) -> torch.Tensor:
    """An empty ``[8, cap]`` pooled matrix: every column the null
    pattern (key-id, origin and slot lanes -1, the rest 0)."""
    return torch.tensor(_POOL_FILL, dtype=torch.int64,
                        device=device)[:, None].repeat(1, cap)


def _pool_grow(mat: torch.Tensor, new_cap: int) -> torch.Tensor:
    """Capacity growth for the POOLED matrix: a new tensor on the same
    device with the old columns copied in."""
    big = new_pool_mat(new_cap, mat.device)
    big[:, :mat.shape[1]] = mat
    return big


def _check_window(mat: torch.Tensor, off: int, width: int,
                  what: str) -> None:
    """JAX clamps a ``dynamic_slice`` start whose window would run past
    the end (and so shifts the window); torch slicing truncates. The
    allocator keeps every window in bounds, so neither is copied: a
    window out of bounds is a bug and raises."""
    if off < 0 or off + width > mat.shape[1]:
        raise ValueError(
            f"pool {what} window [{off}, {off + width}) outside a matrix "
            f"of {mat.shape[1]} columns"
        )


def _pool_kill(mat: torch.Tensor, off: int, width: int) -> torch.Tensor:
    """Kill a released extent's columns (valid and slot lanes) in place
    so an evicted doc's stale rows can never be selected — and a reused
    slot can never alias them onto another doc's composite ids.
    Idempotent."""
    _check_window(mat, off, width, "kill")
    mat[6, off:off + width] = 0
    mat[7, off:off + width] = -1
    return mat


def _pool_move(mat: torch.Tensor, src_off: int, dst_off: int,
               width: int) -> torch.Tensor:
    """Relocate one doc's extent in place: copy the ``width`` columns at
    ``src_off`` to ``dst_off``, then kill the old extent (valid and slot
    lanes). The allocator guarantees the ranges never overlap (the
    destination is fresh tail space)."""
    _check_window(mat, src_off, width, "move source")
    _check_window(mat, dst_off, width, "move destination")
    mat[:, dst_off:dst_off + width] = mat[:, src_off:src_off + width].clone()
    return _pool_kill(mat, src_off, width)


def _pool_relabel_range(mat: torch.Tensor, perm: torch.Tensor, off: int,
                        n: int) -> torch.Tensor:
    """Per-DOC client relabel after a mid-table insertion, in place:
    rewrite dense ids through ``perm`` over the doc's extent columns
    ``[off, off+n)`` only — other docs' rows (doc-local id spaces) are
    untouched. Both new rows are computed before either is written."""
    perm = perm.to(device=mat.device, dtype=torch.int64)
    top = perm.shape[0] - 1
    win = mat[:, off:off + n]
    cl = perm[win[0].clamp(0, top)]
    oc = win[4]
    oc = torch.where(oc >= 0, perm[oc.clamp(0, top)], oc)
    win[0] = cl
    win[4] = oc
    return mat


def _pool_compact(mat: torch.Tensor, src: torch.Tensor,
                  keep: torch.Tensor) -> torch.Tensor:
    """Bounded pool compaction (eviction holes): one device gather
    through the host-computed ``src`` index array (new position -> old
    position) into a NEW tensor; positions outside any live extent reset
    to the null pattern. Both matrices are alive until the caller drops
    the old one, so the card's peak is the sum of the two."""
    out = mat[:, src.long()]
    fill = torch.tensor(_POOL_FILL, dtype=mat.dtype, device=mat.device)
    return torch.where(keep[None, :], out, fill[:, None])
