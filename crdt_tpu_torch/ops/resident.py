"""The pooled resident matrix: one device allocation for every warm doc
of the multi-tenant server.

The port's counterpart of the pooled half of ``crdt_tpu.ops.resident``
(:class:`ResidentPool`, :class:`_Extent`, :func:`_octave8`). The other
half of that module, ``ResidentColumns`` and its full-converge
``_converge_all`` (which reaches the ``ds_mask`` kernel through
``converge_maps``), is not ported here: it belongs to ROADMAP queue A
item 7, the resident full-converge path.

Each attached :class:`~crdt_tpu_torch.models.incremental.IncrementalReplay`
owns an extent (a pow2-bucketed column range) of one ``[8, cap]`` int64
matrix on the pool's device. Its device rounds DEFER here, and the
server's tick converges every deferred round in ONE dispatch
(:meth:`ResidentPool.flush` → ``packed._pool_splice_select_converge`` →
``_converge_core`` → ``_rank_compact``, which runs the ``stream_scatter``
kernel).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from crdt_tpu_torch.obs.tracer import get_tracer
from crdt_tpu_torch.ops import packed as pk
from crdt_tpu_torch.ops.device import bucket_pow2 as _bucket
from crdt_tpu_torch.ops.device import resolve_device
from crdt_tpu_torch.ops.staging import _KID_BITS


def _octave8(n: int, floor: int) -> int:
    """Factor-8 size bucket (the incremental dispatch's static-shape
    policy, see ``models.incremental._octave``)."""
    b = floor
    while b < n:
        b *= 8
    return b


_LANES = 8            # pooled matrix lanes (7 delta columns + slot)
_EXT_FLOOR = 1 << 10  # smallest extent, in rows (pow2 buckets above)
_CLIENT_BOUND = 1 << 22   # composite client must fit pack_id's width
_PREF_BOUND = 1 << 40     # composite pref must stay under segkey bit 62


class _Extent:
    """One doc's reserved column range in the pooled matrix. The
    invariant the splice relies on: device position of a doc's host row
    ``r`` is ``off + r`` (admission appends rows in order, and a
    relocation moves the WHOLE extent)."""

    __slots__ = ("off", "cap", "n", "slot", "move_from")

    def __init__(self, off: int, cap: int, slot: int):
        self.off = off
        self.cap = cap
        self.n = 0          # rows spliced so far (== engine.n_dev)
        self.slot = slot
        # (old off, old cap) awaiting the flush's device move — the copy
        # width must be the OLD bucket: the new cap can overrun the old
        # region into a neighbour's extent
        self.move_from = None


class ResidentPool:
    """ONE device allocation for every warm doc's resident matrix:
    per-doc extents co-locate the docs' columns, and all above-crossover
    deltas of a ``MultiDocServer`` tick batch into ONE scatter-splice +
    converge dispatch (:func:`crdt_tpu_torch.ops.packed.
    _pool_splice_select_converge`) instead of one per doc. Engines attach
    via the ``pool=`` argument of :class:`crdt_tpu_torch.models.
    incremental.IncrementalReplay`; their device rounds then DEFER here
    (:meth:`defer`) and the server's tick flushes once (:meth:`flush`).

    Geometry: extents are pow2-bucketed row ranges allocated at the
    tail; a doc outgrowing its extent relocates by an on-device copy
    (never a host restage), eviction frees the extent, and holes are
    squeezed by a bounded compaction (one device gather) when they
    exceed the live rows — or on demand, when an allocation would
    otherwise burst ``max_bytes``. ``max_bytes`` bounds the pooled
    ALLOCATION (``CRDT_TPU_MT_POOL_BYTES`` at the server); a doc that
    cannot fit even after compaction is refused and falls back to a
    private resident matrix — correctness never depends on pooling.

    The matrix lives on ``device`` (the card unless the caller asks for
    the CPU), resolved at construction.

    The flush's tracer spans: ``pool.stage`` (kills, moves, interning,
    host staging), ``pool.dispatch`` (the uploads and the launch
    sequence), ``pool.fetch`` (the wait and the one fetch) and
    ``pool.unpack``.

    Counters/gauges: ``tenant.pool_dispatches`` per pooled flush,
    ``tenant.pool_compactions`` per hole squeeze, ``tenant.pool_host_
    rounds`` per flush routed to the exact host path, and the
    ``tenant.pool_bytes`` / ``tenant.pool_docs`` gauges."""

    def __init__(self, max_bytes: Optional[int] = None,
                 capacity: int = 1 << 15, *, device="cuda"):
        self.device = resolve_device(device)
        self.max_bytes = None if max_bytes is None else int(max_bytes)
        self._cap0 = _bucket(capacity)
        self._mat: Optional[torch.Tensor] = None   # lazy [8, cap] int64
        self._ext: Dict[object, _Extent] = {}
        self._free_slots: List[int] = []
        self._next_slot = 0
        self._pending: Dict[object, set] = {}
        # released extents' (off, cap) whose columns are still LIVE on
        # the device: killed lazily at the next dispatch (or dropped
        # wholesale by a compaction's gather). Until then a reused slot
        # could alias the stale rows onto another doc's composite ids —
        # the kill runs BEFORE any splice.
        self._dead: List[Tuple[int, int]] = []
        self.dispatches = 0
        self.compactions = 0
        self.peak_bytes = 0
        # flushes routed to the exact host path by the packed-width
        # bound (``_CLIENT_BOUND`` / ``_PREF_BOUND``); not a device
        # fallback, but a detour a run can count
        self.host_rounds = 0
        # extent moves executed on the device (a doc outgrew its extent)
        self.relocations = 0

    # -- accounting ---------------------------------------------------
    def device_bytes(self) -> int:
        """Live pooled allocation — the ``tenant.pool_bytes`` gauge:
        lanes x capacity x int64 itemsize. A compaction briefly holds the
        old and the new matrix at once, so the card's peak can reach
        twice this (``torch.cuda.max_memory_allocated`` sees it)."""
        if self._mat is None:
            return 0
        return int(self._mat.shape[0]) * int(self._mat.shape[1]) * 8

    def doc_device_bytes(self, eng) -> int:
        """One doc's reserved share — what the engine's
        ``resident_bytes`` (and through it the server's resident ledger)
        accounts for a pooled doc."""
        ext = self._ext.get(eng)
        return 0 if ext is None else ext.cap * _LANES * 8

    def doc_count(self) -> int:
        return len(self._ext)

    def has_pending(self, eng=None) -> bool:
        return bool(self._pending) if eng is None \
            else eng in self._pending

    def take_pending(self, eng) -> set:
        """Pop an engine's deferred segments (the unpooling fallback
        host-routes them itself)."""
        return set(self._pending.pop(eng, ()))

    def _note_peak(self) -> None:
        self.peak_bytes = max(self.peak_bytes, self.device_bytes())

    def _tail(self) -> int:
        return max((e.off + e.cap for e in self._ext.values()),
                   default=0)

    def _live_rows(self) -> int:
        return sum(e.cap for e in self._ext.values())

    # -- membership ---------------------------------------------------
    def register(self, eng) -> None:
        """Attach an engine (host bookkeeping only — no extent, no
        device touch: a doc that never crosses to the device route costs
        the pool nothing)."""
        if eng in self._ext:
            return
        slot = (self._free_slots.pop()
                if self._free_slots else self._next_slot)
        if slot == self._next_slot:
            self._next_slot += 1
        self._ext[eng] = _Extent(0, 0, slot)

    def release(self, eng) -> None:
        """Detach an engine (eviction / fallback): free its extent and
        slot; squeeze holes when they outgrow the live rows. The last
        doc leaving drops the whole allocation."""
        ext = self._ext.pop(eng, None)
        self._pending.pop(eng, None)
        if ext is None:
            return
        self._free_slots.append(ext.slot)
        if self._mat is not None and ext.n:
            # the doc's columns are still live on the device (at the old
            # location when a relocation is still pending)
            self._dead.append(
                ext.move_from if ext.move_from is not None
                else (ext.off, ext.cap)
            )
        if not self._ext:
            self._mat = None
            self._free_slots.clear()
            self._next_slot = 0
            self._dead.clear()
        elif self._mat is not None and \
                self._tail() > 2 * self._live_rows():
            self.compact()
        tracer = get_tracer()
        if tracer.enabled:
            tracer.gauge("tenant.pool_bytes", self.device_bytes())
            tracer.gauge("tenant.pool_docs", self.doc_count())

    def _reset_all(self) -> None:
        """Drop the pooled matrix after a failed attempt (the port
        mutates it in place, so a failure part-way leaves none to
        trust): every attached engine restages its WHOLE host column set
        on the next flush (n_dev=0), the same full-rebuild contract the
        private matrix uses."""
        self._mat = None
        self._dead.clear()
        for eng, ext in self._ext.items():
            ext.n = 0
            ext.move_from = None
            eng.n_dev = 0

    # -- geometry -----------------------------------------------------
    def _fits_budget(self, cap_rows: int) -> bool:
        return self.max_bytes is None or \
            cap_rows * _LANES * 8 <= self.max_bytes

    def defer(self, eng, segs) -> bool:
        """Queue one engine device round for the batched flush: reserve
        (or pow2-grow) the doc's extent — host bookkeeping now, device
        moves at the flush — and merge its touched segments. Returns
        False when the pool cannot hold the doc within ``max_bytes``
        even after compaction: the caller falls back to a private
        resident matrix."""
        ext = self._ext.get(eng)
        if ext is None:
            self.register(eng)
            ext = self._ext[eng]
        need = _bucket(max(eng.cols.n, _EXT_FLOOR))
        if ext.cap < need:
            tail = self._tail()
            if not self._fits_budget(_bucket(tail + need)) and \
                    self._mat is not None and \
                    self._tail() > self._live_rows():
                self.compact()
                tail = self._tail()
            if not self._fits_budget(_bucket(tail + need)):
                return False
            if ext.cap and ext.n:
                # relocation: the device copy runs inside the flush's
                # guarded dispatch; splice positions already use the new
                # offset
                if ext.move_from is None:
                    ext.move_from = (ext.off, ext.cap)
            ext.off = tail
            ext.cap = need
        self._pending.setdefault(eng, set()).update(segs)
        return True

    def relabel(self, eng, perm: np.ndarray) -> None:
        """Per-doc client relabel after a mid-table insertion —
        :meth:`IncrementalReplay._intern_clients`'s pooled branch. Only
        the doc's spliced extent columns rewrite."""
        ext = self._ext.get(eng)
        if ext is None or not ext.n or self._mat is None:
            return
        pk._pool_relabel_range(
            self._mat,
            torch.as_tensor(np.asarray(perm, np.int64), device=self.device),
            ext.off, ext.n,
        )

    def _ensure_mat(self, need_cols: int) -> torch.Tensor:
        if self._mat is None:
            cap = _bucket(max(need_cols, self._cap0))
            if not self._fits_budget(cap):
                # a budget tighter than the default first bucket:
                # allocate only what the extents need
                cap = _bucket(max(need_cols, 1))
            self._mat = pk.new_pool_mat(cap, self.device)
        elif need_cols > self._mat.shape[1]:
            self._mat = pk._pool_grow(self._mat,
                                      new_cap=_bucket(need_cols))
        return self._mat

    def compact(self) -> None:
        """Squeeze eviction holes: repack live extents tight (in off
        order) with ONE device gather, shrinking the allocation to the
        covering pow2 bucket. Extents relocate wholesale, so the
        ``off + host_row`` position invariant is untouched. Bounded:
        O(pool) work, triggered only by releases and budget-pressed
        allocations — never on the steady path."""
        if self._mat is None or not self._ext:
            return
        exts = sorted(self._ext.values(), key=lambda e: e.off)
        tail = 0
        plan = []
        for e in exts:
            plan.append((e, tail))
            tail += e.cap
        # the default first bucket is only a FLOOR when it fits the
        # budget — a compaction must never re-grow a budget-clamped pool
        # past ``max_bytes``
        floor_cap = self._cap0 if self._fits_budget(self._cap0) else 1
        new_cap = _bucket(max(tail, floor_cap))
        src = np.zeros(new_cap, np.int32)
        keep = np.zeros(new_cap, bool)
        width = int(self._mat.shape[1])
        for e, new_off in plan:
            # a pending relocation's live rows are still at the OLD
            # location — gather from there (the compaction subsumes the
            # move); the new cap's surplus columns init dead. An extent
            # reserved at defer time and not flushed yet can lie past
            # the matrix: it holds no rows, so its columns start as the
            # null pattern (the reference's gather clamps those indices
            # into the last column instead; torch would fault on them)
            s_off, s_cap = (e.move_from if e.move_from is not None
                            else (e.off, e.cap))
            w = max(0, min(s_cap, e.cap, width - s_off))
            src[new_off: new_off + w] = np.arange(
                s_off, s_off + w, dtype=np.int32
            )
            keep[new_off: new_off + w] = True
        from crdt_tpu_torch.guard.device import dispatch_guarded
        from crdt_tpu_torch.ops.device import xfer_put

        def _gather():
            return pk._pool_compact(
                self._mat,
                xfer_put(src, device=self.device, label="pool.compact"),
                xfer_put(keep, device=self.device, label="pool.compact"),
            )

        # the gather writes a new tensor and leaves the old one intact,
        # so a failed attempt has nothing to undo; only an injected
        # fault climbs the ladder, anything else propagates
        res = dispatch_guarded("pool.compact", _gather, host=lambda: None)
        if res is None:
            self._reset_all()
            return
        self._mat = res
        self._dead.clear()  # the gather dropped every hole
        for e, new_off in plan:
            e.off = new_off
            e.move_from = None
        self.compactions += 1
        self._note_peak()
        tracer = get_tracer()
        if tracer.enabled:
            tracer.count("tenant.pool_compactions")
            tracer.gauge("tenant.pool_bytes", self.device_bytes())

    # -- the one pooled dispatch --------------------------------------
    def flush(self) -> int:
        """Converge EVERY deferred device round in one dispatch: execute
        pending extent moves, scatter-splice the combined delta block at
        the docs' extents, select the touched COMPOSITE segments,
        converge, and unpack winners/orders back to each engine. Returns
        the number of converge dispatches issued (0 when nothing pends,
        1 on the batched path).

        Composite id bases are recomputed per flush from the live
        engines' id tables; when the combined tables would overflow the
        kernel's packed widths the round routes host-side instead
        (exact, conservative; counted in ``host_rounds``). Device
        failure follows the guarded ladder: an injected fault retries,
        then host-routes the round and drops the pooled matrix for a
        full rebuild on the next flush."""
        if not self._pending:
            return 0
        pending = {e: sorted(s) for e, s in self._pending.items()}
        self._pending = {}

        # composite bases over ALL attached docs: disjoint, cumulative,
        # slot-indexed. A doc's client span carries HEADROOM for its
        # pending tail — the staging below interns the tail's clients
        # AFTER these bases are fixed, and the composite ranges only need
        # to be disjoint and order-preserving, not tight (each tail row
        # introduces at most one new client; origin clients always own a
        # row).
        by_slot = sorted(self._ext.items(), key=lambda kv: kv[1].slot)
        spad = _octave8(self._next_slot, floor=16)
        cbase = np.zeros(spad, np.int64)
        pbase = np.zeros(spad, np.int64)
        tot_c = tot_p = 0
        for eng, ext in by_slot:
            cbase[ext.slot] = tot_c
            pbase[ext.slot] = tot_p
            tail = eng.cols.n - eng.n_dev if eng in pending else 0
            tot_c += len(eng._clients) + tail + 1
            tot_p += len(eng._pref_spec) + 1
        if tot_c >= _CLIENT_BOUND or tot_p >= _PREF_BOUND:
            # packed-width overflow (thousands of docs x clients):
            # host-route this round — exact, never wrong
            self.host_rounds += 1
            tracer = get_tracer()
            if tracer.enabled:
                tracer.count("tenant.pool_host_rounds")
            self._host_fallback(pending)
            return 0

        from crdt_tpu_torch.guard.device import dispatch_guarded

        n_sel = sum(
            len(eng._seg_rows[sk])
            for eng, segs in pending.items() for sk in segs
        )
        n_touch = sum(len(segs) for segs in pending.values())
        k_tot = sum(eng.cols.n - eng.n_dev for eng in pending)
        tpad = _octave8(n_touch, floor=1 << 10)
        kpad = _octave8(max(k_tot, 1), floor=1 << 6)

        def _dispatch():
            # EVERY device interaction of the flush — interning
            # relabels, extent kills and moves, growth, the splice — runs
            # inside the guarded attempt. They all write the matrix in
            # place, so an attempt that fails part-way leaves none to
            # trust: it ends in _reset_all (every engine restages from
            # n_dev = 0) with the round queued again, and the error
            # propagates — the ladder retries only an injected fault,
            # which fires before the attempt touches anything, so
            # nothing retries over a half-mutated matrix.
            try:
                return self._dispatch_flush(pending, pbase, cbase, tpad,
                                            kpad, n_sel)
            except BaseException:
                self._reset_all()
                for eng, segs in pending.items():
                    self._pending.setdefault(eng, set()).update(segs)
                raise

        res = dispatch_guarded("pool.converge", _dispatch,
                               host=lambda: None)
        if res is None:
            self._reset_all()
            self._host_fallback(pending)
            return 0
        h, sel_bucket = res
        self._dead.clear()
        with get_tracer().span("pool.unpack"):
            self._unpack(pending, h, tpad, sel_bucket)
        for eng in pending:
            ext = self._ext[eng]
            eng.n_dev = eng.cols.n
            ext.n = eng.n_dev
        self.dispatches += 1
        pk.count_device_dispatch()
        self._note_peak()
        tracer = get_tracer()
        if tracer.enabled:
            tracer.count("tenant.pool_dispatches")
            tracer.gauge("tenant.pool_bytes", self.device_bytes())
            tracer.gauge("tenant.pool_docs", self.doc_count())
        return 1

    def _dispatch_flush(self, pending, pbase, cbase, tpad: int, kpad: int,
                        n_sel: int) -> Tuple[np.ndarray, int]:
        """One flush's device work: kills, moves, interning, staging,
        the ONE splice+converge launch sequence and the ONE fetch.
        Returns (the fetched packed result, sel_bucket)."""
        from crdt_tpu_torch.ops.device import xfer_fetch, xfer_put

        tracer = get_tracer()
        with tracer.span("pool.stage"):
            mat = self._ensure_mat(self._tail())
            # released extents' stale columns die FIRST — a reused slot
            # (or an extent re-allocated over the hole) must never see
            # them alive
            for d_off, d_cap in self._dead:
                pk._pool_kill(mat, d_off, width=d_cap)
            for eng in pending:
                ext = self._ext[eng]
                if ext.move_from is not None and ext.n:
                    s_off, s_cap = ext.move_from
                    pk._pool_move(mat, s_off, ext.off, width=s_cap)
                    self.relocations += 1
                ext.move_from = None
            parts = []
            touched = []
            for eng, segs in pending.items():
                ext = self._ext[eng]
                rows = np.arange(eng.n_dev, eng.cols.n)
                oc_tail = eng.cols.col("oc")[rows]
                eng._intern_clients(np.concatenate([
                    eng.cols.col("client")[rows],
                    oc_tail[oc_tail >= 0],
                ]))
                parts.append((
                    eng._dense_of(eng.cols.col("client")[rows]),
                    eng.cols.col("clock")[rows],
                    eng.cols.col("pref")[rows],
                    eng.cols.col("kid")[rows],
                    np.where(
                        oc_tail >= 0,
                        eng._dense_of(np.clip(
                            oc_tail,
                            eng._clients[0] if eng._clients else 0,
                            None,
                        )),
                        -1,
                    ),
                    eng.cols.col("ock")[rows],
                    np.full(len(rows), ext.slot, np.int64),
                    (ext.off + rows).astype(np.int64),
                ))
                pb = int(pbase[ext.slot])
                touched.extend(sk + (pb << _KID_BITS) for sk in segs)
            cat = [np.concatenate(c) for c in zip(*parts)]
            delta, ppos = pk.stage_pooled_delta(
                *cat[:7], cat[7], kpad, int(mat.shape[1]),
            )
            tarr = np.full(tpad, np.iinfo(np.int64).max, np.int64)
            tarr[: len(touched)] = np.sort(np.asarray(touched, np.int64))
            sel_bucket = min(_octave8(n_sel, floor=1 << 13),
                             int(mat.shape[1]))
        dev = self.device
        with tracer.span("pool.dispatch"):
            _, packed_out = pk._pool_splice_select_converge(
                mat,
                xfer_put(delta, device=dev, label="incremental.delta"),
                xfer_put(ppos, device=dev, label="incremental.delta"),
                xfer_put(tarr, device=dev, label="incremental.delta"),
                xfer_put(cbase, device=dev, label="incremental.delta"),
                xfer_put(pbase, device=dev, label="incremental.delta"),
                num_segments=tpad, sel_bucket=sel_bucket,
                seq_bucket=sel_bucket,
                # None = sel_bucket bound: device-side segment numbering
                # root-attaches in-flight-origin rows, so host
                # `_seg_rows` counts can undercount the device
                # populations (see the private round in
                # models/incremental.py)
                rank_rounds=None, map_rounds=None,
            )
        with tracer.span("pool.fetch"):
            h = xfer_fetch(packed_out, label="incremental.out")
        return h, sel_bucket

    def _unpack(self, pending, h, tpad: int, sel_bucket: int) -> None:
        """Split the fetch and route winners / orders back per doc: pool
        position -> (engine, host row) through the pending extents
        (position = off + host row, the extent invariant)."""
        exts = sorted(
            ((self._ext[eng].off, self._ext[eng].cap, eng)
             for eng in pending),
            key=lambda t: t[0],
        )
        offs = np.asarray([o for o, _, _ in exts], np.int64)
        engs = [e for _, _, e in exts]

        def locate(pos: int):
            i = int(np.searchsorted(offs, pos, side="right")) - 1
            return engs[i], pos - int(offs[i])

        s, b = tpad, sel_bucket
        win_local = h[:s]
        stream_seg = h[s: s + b]
        stream_row = h[s + b: s + 2 * b]
        sel_rows = h[s + 2 * b: s + 3 * b]
        for w in win_local[win_local >= 0]:
            eng, row = locate(int(sel_rows[w]))
            eng._win[eng._row_segkey(row)] = row
        m = stream_row >= 0
        rows_s, segs_s = stream_row[m], stream_seg[m]
        if len(rows_s):
            pool_rows = sel_rows[rows_s]
            cuts = np.r_[
                0, np.flatnonzero(segs_s[1:] != segs_s[:-1]) + 1,
                len(segs_s),
            ]
            for a, bnd in zip(cuts[:-1], cuts[1:]):
                eng, first = locate(int(pool_rows[a]))
                off = int(pool_rows[a]) - first
                chunk = (pool_rows[a:bnd] - off).tolist()
                eng._set_order(eng._row_segkey(chunk[0]), chunk)

    def _host_fallback(self, pending) -> None:
        """Exact host route for a flush that cannot (bounds) or could
        not (an injected device fault) dispatch: each pending segment
        re-derives against the host columns; the unspliced tails simply
        wait for the next healthy flush — latency, never state."""
        for eng, segs in pending.items():
            for sk in segs:
                eng._host_order_segment(sk)
