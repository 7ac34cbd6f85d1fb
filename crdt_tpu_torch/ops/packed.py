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
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from crdt_tpu_torch.obs.tracer import get_tracer
from crdt_tpu_torch.ops.device import (
    NULLI,
    bucket_grid,
    dfs_ranks,
    pointer_double,
    record_staged_widths,
    resolve_device,
    xfer_fetch,
    xfer_put,
)
from crdt_tpu_torch.ops.kernels import seg_argmax_scan, stream_scatter
from crdt_tpu_torch.ops.staging import (
    _SECTION_GROUPS,
    PackedPlan,
    _section_sizes,
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
