"""Overlapped streaming replay — host phases pipelined against the
in-flight device converge.

The port's counterpart of ``crdt_tpu.models.streaming``. The one-shot
replay (:mod:`crdt_tpu_torch.models.replay`) runs its phases strictly
in series: decode -> stage -> pack -> converge -> gather ->
materialize -> compact. This module runs the SAME computation as a
chunked, double-buffered pipeline:

1. **decode** — the blob stream splits into fixed-size chunks decoded
   on a small thread pool, then one
   :func:`crdt_tpu_torch.codec.native.merge_decoded` merge,
   byte-identical to the one-shot decode. The native codec holds the
   GIL through its pass (as the reference's does), so the chunks
   overlap only the merge tail of their neighbours;
2. **partition** — the union's segments group by their TOP-LEVEL root,
   so every shard owns whole root subtrees and can converge AND
   materialize on its own;
3. **converge** — a stager thread stages each shard, uploads it and
   enqueues :func:`crdt_tpu_torch.ops.packed.converge_async` on one of
   two side streams in turn (on the card), and hands the handle —
   which carries the CUDA event recorded after the launches — to the
   consumer over a bounded queue of two: the double buffer. The
   consumer waits on that event, on that stream, before it fetches;
4. **materialize** — the plain-JSON cache builds per shard
   (:func:`crdt_tpu_torch.models.replay.assemble_cache`) while later
   shards are still on the device; snapshot compaction runs on the
   stager thread inside the same window.

Exactness: every shard's result is the packed kernels' result for its
segments, and segments never split across shards, so the merged
winners and orders are the one-shot route's outputs re-ordered. Shapes
a shard cannot prove locally (right-bearing segments whose origin
chains leave the segment) go to the exact host machinery, like the
one-shot gather's hard rows. A shard past the packed stager's bounds
sends the whole union down the one-shot converge's resident fallback
(``path="stream-fallback"``). Differential-tested
byte-identical against the reference in tests/test_torch_streaming.py.

Phase accounting: ``phases`` (when passed) receives per-stage BUSY
seconds summed across lanes, plus ``wall_s``, ``busy_sum_s``, and
``overlap_efficiency`` = (busy - wall) / (busy - max_stage): 0 means
fully serial, 1 means the wall clock collapsed onto the single longest
stage.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from functools import partial
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from crdt_tpu_torch.codec import native
from crdt_tpu_torch.models import replay as rp
from crdt_tpu_torch.models.replay import ReplayResult
from crdt_tpu_torch.obs.profiling import device_annotation
from crdt_tpu_torch.obs.timeline import get_timeline
from crdt_tpu_torch.obs.tracer import get_tracer
from crdt_tpu_torch.ops import packed, staging
from crdt_tpu_torch.ops.device import resolve_device, xfer_put

# the reference's pipeline depth: enough chunks that decode streams,
# enough shards that fetch/materialize of shard k hides behind the
# converge of shard k+1, never so many that per-shard fixed costs (one
# upload, one launch sequence, one fetch) dominate
_DECODE_CHUNKS = 8
_MAX_SHARDS = 4
_MIN_SHARD_ROWS = 1 << 16


class _Phases:
    """Thread-safe busy-time accumulator (seconds per stage).

    Host stages are charged in per-thread CPU time, not wall time:
    the pipeline's lanes run concurrently, and a stage's wall span
    inflated by GIL/core contention would multiply-count the same
    second into the busy sum (whose contract is to reconstruct the
    SERIAL pipeline's cost). The device lane's occupancy is the one
    wall-clock entry, added explicitly by the consumer."""

    def __init__(self):
        self._lock = threading.Lock()
        self.t: Dict[str, float] = {}

    def add(self, name: str, dt: float) -> None:
        with self._lock:
            self.t[name] = self.t.get(name, 0.0) + dt

    def timed(self, name: str, fn, *a, **kw):
        t0 = time.thread_time()
        out = fn(*a, **kw)
        self.add(name, time.thread_time() - t0)
        return out


_IDLE_PHASES = ("converge_wait",)  # blocked time, not work: reported
                                   # as a diagnostic, excluded from
                                   # the busy sum (the device lane's
                                   # occupancy is charged as
                                   # "converge" instead)


def overlap_stats(phases: Dict[str, float], wall: float) -> Dict:
    """Pipeline accounting over per-stage busy seconds: how much of
    the total work the wall clock actually hid. The sum counts each
    lane's OCCUPANCY — host stages plus the device lane's
    non-overlapping converge span — and excludes blocked-wait
    diagnostics, so it reconstructs what the serial pipeline would
    cost. ``overlap_efficiency`` is (busy - wall) / (busy - max_stage)
    — the fraction of the maximally-hideable time that WAS hidden
    (1.0 = wall collapsed to the longest stage, 0.0 = fully serial);
    ``wall_vs_phases`` is the raw wall / sum-of-phases ratio."""
    phases = {
        k: v for k, v in phases.items() if k not in _IDLE_PHASES
    }
    busy = sum(v for v in phases.values())
    longest = max(phases.values(), default=0.0)
    hideable = busy - longest
    eff = (busy - wall) / hideable if hideable > 1e-9 else (
        1.0 if wall <= busy + 1e-9 else 0.0
    )
    return {
        "busy_sum_s": round(busy, 3),
        "wall_s": round(wall, 3),
        "wall_vs_phases": round(wall / busy, 3) if busy else 1.0,
        "overlap_efficiency": round(min(max(eff, 0.0), 1.0), 3),
        "longest_stage_s": round(longest, 3),
    }


# ---------------------------------------------------------------------------
# decode lane: chunked, thread-pooled
# ---------------------------------------------------------------------------


def stream_decode(blobs: Sequence[bytes], chunk_blobs: int,
                  ph: _Phases) -> Dict:
    """Chunked parallel decode -> the canonical (deduped) union,
    byte-identical to the one-shot ``replay.decode``."""
    blobs = list(blobs)
    chunks = [
        blobs[i:i + chunk_blobs]
        for i in range(0, len(blobs), chunk_blobs)
    ] or [[]]

    def _one(chunk):
        # runs on the pool: the tracer takes its lock per mutation
        with get_tracer().span("decode"):
            return ph.timed(
                "decode", native.decode_updates_columns_any, chunk
            )

    if len(chunks) == 1:
        decs = [_one(chunks[0])]
    else:
        workers = min(4, max(2, (os.cpu_count() or 2)))
        with ThreadPoolExecutor(max_workers=workers,
                                thread_name_prefix="stream-decode") as ex:
            decs = list(ex.map(_one, chunks))
    return ph.timed(
        "merge", lambda: native.dedup_columns(native.merge_decoded(decs))
    )


# ---------------------------------------------------------------------------
# partition: whole root subtrees per convergence shard
# ---------------------------------------------------------------------------


def partition_shards(cols: Dict[str, np.ndarray], max_shards: int):
    """Group the union's segments by TOP-LEVEL root and greedy-pack
    the roots into at most ``max_shards`` row-balanced shards.

    Returns ``(shard_rows, seg, extra_hard_rows)``:

    - ``shard_rows``: list of union-row index arrays (ascending), one
      per shard, covering every row exactly once. Whole segments — and
      whole root SUBTREES (nested type items and their collections) —
      stay co-located, so each shard converges and materializes
      independently of the others.
    - ``seg``: dense segment id per row (shared diagnostics).
    - ``extra_hard_rows``: representative union rows of right-bearing
      segments whose members' origin chains may LEAVE the segment —
      the shapes whose hardness the one-shot stager proves with
      union-wide walks that a shard cannot run. They are routed to the
      exact host ordering, a conservative superset of the one-shot
      path's hard set.
    """
    n = len(cols["client"])
    if n == 0:
        return [], np.empty(0, np.int64), []
    pir = np.asarray(cols["parent_is_root"], bool)
    pa = np.asarray(cols["parent_a"], np.int64)
    pb = np.asarray(cols["parent_b"], np.int64)
    kid = np.asarray(cols["key_id"], np.int64)

    # dense segment ids over (pir, pa, pb, kid)
    order = np.lexsort((kid, pb, pa, pir))
    same = (
        (pir[order][1:] == pir[order][:-1])
        & (pa[order][1:] == pa[order][:-1])
        & (pb[order][1:] == pb[order][:-1])
        & (kid[order][1:] == kid[order][:-1])
    )
    seg_sorted = np.cumsum(np.r_[True, ~same]) - 1
    seg = np.empty(n, np.int64)
    seg[order] = seg_sorted
    S = int(seg_sorted[-1]) + 1 if n else 0
    rep = np.empty(S, np.int64)
    rep[seg_sorted] = order  # any member row stands for its segment

    # climb each segment's parent chain to its top-level root (log-S
    # pointer-doubling rounds, host-vectorized, over the packed-id
    # index shared with the decode merge)
    index = native.id_index(cols["client"], cols["clock"])
    rep_pir = pir[rep]
    rep_pa = pa[rep]
    rep_pb = pb[rep]
    prow = native.id_lookup(
        index, np.where(~rep_pir, rep_pa, np.int64(-1)), rep_pb
    )
    # seg -> parent seg; terminal segments self-loop
    terminal = rep_pir | (prow < 0)
    f = np.where(terminal, np.arange(S), seg[np.clip(prow, 0, max(n - 1, 0))])
    for _ in range(max(1, (max(S, 2) - 1).bit_length() + 1)):
        f = f[f]
    # root id of each segment: the terminal ancestor's root (or -1 for
    # dangling/cyclic chains — those collect in shard 0; their specs
    # are non-root and unreachable from any root's nesting)
    top = f
    root_of_seg = np.where(
        rep_pir[top] & terminal[top], rep_pa[top], np.int64(-1)
    )

    # rows per segment / per root, then greedy-pack roots
    seg_rows_count = np.bincount(seg, minlength=S)
    roots_u, root_inv = np.unique(root_of_seg, return_inverse=True)
    root_load = np.bincount(root_inv, weights=seg_rows_count).astype(
        np.int64
    )
    n_shards = max(1, min(max_shards, len(roots_u)))
    bins = np.zeros(len(roots_u), np.int64)
    loads = np.zeros(n_shards, np.int64)
    for r in np.argsort(-root_load, kind="stable"):
        b = int(np.argmin(loads))
        bins[r] = b
        loads[b] += int(root_load[r])
    # dangling bucket (-1) pinned to shard 0 for determinism
    if len(roots_u) and roots_u[0] == -1:
        bins[0] = 0
    shard_of_seg = bins[root_inv]
    shard_of_row = shard_of_seg[seg]
    shard_rows = [
        np.flatnonzero(shard_of_row == b) for b in range(n_shards)
    ]
    shard_rows = [r for r in shard_rows if len(r)]

    # conservative hard set: right-bearing sequence segments with any
    # member whose origin resolves OUTSIDE the segment (the one-shot
    # stager's union-wide subtree walks can cross segments there; a
    # shard-local walk cannot follow them, so the exact host machinery
    # takes those segments in every case)
    extra_hard: List[int] = []
    rc = np.asarray(cols["right_client"], np.int64)
    rb = (rc >= 0) & (kid < 0)
    if rb.any():
        oc = np.asarray(cols["origin_client"], np.int64)
        ock = np.asarray(cols["origin_clock"], np.int64)
        orow = native.id_lookup(index, oc, ock)
        cross = (oc >= 0) & (orow >= 0) & (
            seg[np.clip(orow, 0, max(n - 1, 0))] != seg
        )
        hard_segs = np.intersect1d(
            np.unique(seg[rb]), np.unique(seg[cross])
        )
        extra_hard = [int(rep[s]) for s in hard_segs.tolist()]
    return shard_rows, seg, extra_hard


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------


def stream_replay(
    blobs: Sequence[bytes],
    *,
    chunk_blobs: Optional[int] = None,
    max_shards: int = _MAX_SHARDS,
    min_shard_rows: int = _MIN_SHARD_ROWS,
    clients: Optional[Sequence[int]] = None,
    phases: Optional[dict] = None,
    device="cuda",
) -> ReplayResult:
    """Chunked, double-buffered streaming replay on ``device`` (the
    card unless the caller asks for the CPU): blobs in, converged
    cache + compacted snapshot out — same outputs as
    ``replay_trace(route="device")``, pipelined (see module doc).

    ``chunk_blobs`` sets the decode chunk size (default: ~8 chunks);
    ``max_shards`` bounds the convergence/materialize pipeline depth.
    ``clients`` seeds the resident fallback's client table exactly as
    on the device route: a shard past the packed stager's bounds sends
    the whole union down the one-shot fallback (``path`` is
    ``"stream-fallback"``, ``phases["fallback"]`` True). ``phases``,
    when given, receives per-stage busy seconds plus the
    overlap accounting of :func:`overlap_stats`. The reference's
    multi-device shard route is not ported (ROADMAP.md queue A item 9):
    every shard converges on the one ``device``."""
    dev = resolve_device(device)
    t_wall0 = time.perf_counter()
    ph = _Phases()
    # one "stream" tick on the tick timeline: its dispatch windows are
    # the per-shard converges, the per-stage busy sums extra lanes
    tl = get_timeline()
    tl.tick_begin(0, label="stream")
    blobs = list(blobs)
    if chunk_blobs is None:
        chunk_blobs = max(1, -(-len(blobs) // _DECODE_CHUNKS))

    dec = stream_decode(blobs, chunk_blobs, ph)
    cols, ds = ph.timed("columns", rp.stage, dec)
    n = len(cols["client"])

    eff_shards = max(
        1, min(max_shards, n // max(min_shard_rows, 1) or 1)
    )
    shard_rows, _seg, extra_hard = ph.timed(
        "partition", partition_shards, cols, eff_shards
    )

    # crafted rights on MAP rows shift chain tails; repaired per shard
    # so every shard emits only its own segments' tails. The whole-
    # union id set the repair consults is built ONCE here (not per
    # shard) when any such rows exist at all.
    map_bad = np.flatnonzero(
        (np.asarray(cols["right_client"]) >= 0)
        & (np.asarray(cols["key_id"]) >= 0)
    )
    union_ids = None
    if len(map_bad):
        union_ids = set(
            zip(
                np.asarray(cols["client"]).tolist(),
                np.asarray(cols["clock"]).tolist(),
            )
        )

    # ---- staging/dispatch lane (background thread) -------------------
    # bounded queue = the double buffer: at most two converges in
    # flight behind the consumer. On the card the shards alternate
    # between two side streams: each shard's eager uploads, launches
    # and event stay on one stream, so the consumer's wait on the event
    # covers every write the fetch reads
    q: queue.Queue = queue.Queue(maxsize=2)
    snap_box: dict = {}
    streams = (
        [torch.cuda.Stream(dev) for _ in range(2)]
        if dev.type == "cuda" else None
    )

    def on_stream(g: int):
        return (torch.cuda.stream(streams[g % 2]) if streams
                else nullcontext())

    def stager():
        try:
            for g, rows_g in enumerate(shard_rows):
                sub = {k: v[rows_g] for k, v in cols.items()}
                # eager per-section shipping is gated on THIS shard's
                # row count, as the one-shot converge gates the union's
                put = None
                if len(rows_g) >= staging.EAGER_PUT_MIN_ROWS:
                    put = partial(xfer_put, device=dev)
                with on_stream(g):
                    plan = ph.timed("pack", staging.stage, sub, put=put)
                    if plan is None:
                        q.put(("unstageable", None, None))
                        return
                    with device_annotation(f"crdt.stream.shard{g}"):
                        handle = packed.converge_async(plan, device=dev)
                q.put(("shard", (g, handle, time.perf_counter()), rows_g))
            # compact is pure decode-side work: it runs here, inside
            # the window where the consumer is fetching/materializing
            snap_box["snap"] = ph.timed("compact", rp.compact, dec, ds)
            q.put(("done", None, None))
        except BaseException as exc:  # surfaced by the consumer
            q.put(("error", exc, None))

    worker = threading.Thread(target=stager, daemon=True,
                              name="stream-stager")
    worker.start()

    # ---- consumer: fetch -> gather -> incremental materialize --------
    cache: dict = {}
    ix_group: Dict[str, int] = {}
    failed: Optional[BaseException] = None
    unstageable = False
    extra_hard_left = list(extra_hard)
    last_fetch_done = 0.0
    try:
        while True:
            kind, payload, rows_g = q.get()
            if kind == "done":
                break
            if kind == "error":
                failed = payload
                break
            if kind == "unstageable":
                unstageable = True
                break
            g, handle, t_enq = payload
            tok = tl.dispatch_begin(t=t_enq)
            t0 = time.perf_counter()
            with on_stream(g):  # fetch on the shard's own stream
                res = packed.converge_fetch(handle)  # the shard's sync
            t1 = time.perf_counter()
            tl.dispatch_end(tok, t0, t1)
            ph.add("converge_wait", t1 - t0)
            # device-lane occupancy: this shard's span, net of any
            # part that overlapped the previous shard's execution
            ph.add("converge", t1 - max(t_enq, last_fetch_done))
            last_fetch_done = t1
            del handle  # its device buffers go back to the allocator

            t0 = time.thread_time()
            win_rows, seq_orders = rp._assemble_packed(
                dec, res, row_map=rows_g
            )
            # hard/right shapes are the exception path: each affected
            # shard pays one host pass over the union (the machinery
            # the one-shot gather uses once); benign unions skip it
            hard = [int(rows_g[int(r)]) for r in res.hard_rows]
            if extra_hard_left:
                in_shard = set(rows_g.tolist())
                mine = [r for r in extra_hard_left if r in in_shard]
                extra_hard_left = [
                    r for r in extra_hard_left if r not in in_shard
                ]
                hard.extend(mine)
            if hard:
                affected = {rp.parent_spec(dec, r) for r in hard}
                seq_orders.update(
                    rp._host_seq_orders(dec, affected, device=dev))
            if len(map_bad):
                shard_bad = map_bad[np.isin(map_bad, rows_g)]
                win_rows = rp._fix_map_chains_with_rights(
                    dec, win_rows, bad_rows=shard_bad,
                    chain_rows=rows_g, union_ids=union_ids,
                )
            win_vis = rp.visible_mask(dec, win_rows, ds)
            ph.add("gather", time.thread_time() - t0)

            part, ix_part = ph.timed(
                "materialize", rp.assemble_cache,
                dec, ds, win_rows, win_vis, seq_orders,
            )
            cache.update(part)
            ix_group.update(ix_part)
    finally:
        # never leave the stager blocked on a full queue (e.g. when
        # the consumer raised mid-shard): drain until it exits
        while worker.is_alive():
            try:
                q.get(timeout=0.05)
            except queue.Empty:
                pass
        worker.join()
    if failed is not None:
        raise failed
    if unstageable:
        # the union exceeds the packed layout's bounds: one-shot
        # fallback through the general path (exact, unpipelined;
        # ``clients`` seeds the resident table exactly as on the
        # device route)
        handle = rp.converge(cols, clients=clients, device=dev)
        win_rows, win_vis, seq_orders = rp.gather(dec, ds, handle,
                                                  device=dev)
        cache = rp.materialize(dec, ds, win_rows, win_vis, seq_orders)
        snap = rp.compact(dec, ds)
        if phases is not None:  # the contract holds on every exit
            wall = time.perf_counter() - t_wall0
            phases.update({k: round(v, 4) for k, v in ph.t.items()})
            phases.update(overlap_stats(ph.t, wall))
            phases["fallback"] = True
        tl.tick_end(extra_busy=_timeline_lanes(ph))
        return ReplayResult(
            cache=cache, snapshot=snap, n_ops=n, path="stream-fallback",
        )
    ph.timed("materialize", rp.finish_cache, cache, dec, ix_group)

    wall = time.perf_counter() - t_wall0
    if phases is not None:
        phases.update({k: round(v, 4) for k, v in ph.t.items()})
        phases.update(overlap_stats(ph.t, wall))
    tl.tick_end(extra_busy=_timeline_lanes(ph))
    return ReplayResult(
        cache=cache, snapshot=snap_box["snap"], n_ops=n, path="stream"
    )


def _timeline_lanes(ph: _Phases) -> Dict[str, float]:
    """The executor's host-stage busy sums as timeline lanes. The
    device lane is already covered exactly by the per-shard dispatch
    windows the consumer recorded, so the wall-clock ``converge``
    charge and the blocked-wait diagnostic are excluded (they would
    double-count the device's occupancy into the busy sum)."""
    return {
        k: v for k, v in ph.t.items()
        if k not in ("converge", *_IDLE_PHASES)
    }
