"""Device-resident columnar unions: the full-converge buffer and the
pooled matrix of the multi-tenant server.

The port's counterpart of ``crdt_tpu.ops.resident``, both halves:

- :class:`ResidentColumns`, the firehose path's growable device buffer
  of the nine union columns (:data:`COLUMNS`). ``append`` ships only the
  delta, padded to its power-of-two bucket, and splices it in place at
  offset ``n``; ``converge`` (or the fused ``append_converge``) runs the
  LWW map merge (``merge.converge_maps``, which reaches the ``ds_mask``
  kernel) and the YATA sequence order (``yata.converge_sequences``)
  over the resident buffers and returns DEVICE tensors. It is the
  resident fallback of every replay route for a union past the packed
  stager's bounds (:func:`crdt_tpu_torch.models.replay.converge`).
  Client ids are interned to DENSE, ORDER-PRESERVING values on append
  (the kernels pack ``client << 40 | clock`` into int64, which random
  31-bit replica ids would alias, and the sibling rules compare client
  ids): dense id = rank among all raw ids seen; a new id arriving
  BETWEEN existing ones shifts later ranks and relabels the resident
  client columns in place, once (never when the clients were
  registered up front with ``clients=``).
- :class:`ResidentPool` and :class:`_Extent`: ONE device allocation for
  every warm doc of the multi-tenant server. Each attached
  :class:`~crdt_tpu_torch.models.incremental.IncrementalReplay` owns an
  extent (a pow2-bucketed column range) of one ``[8, cap]`` int64
  matrix on the pool's device. Its device rounds DEFER here, and the
  server's tick converges every deferred round in ONE dispatch
  (:meth:`ResidentPool.flush` → ``packed._pool_splice_select_converge``
  → ``_converge_core`` → ``_rank_compact``, which runs the
  ``stream_scatter`` kernel).

JAX's donated buffers become in-place mutation here; the splice
asserts its window lies inside the buffer where JAX would clamp it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from crdt_tpu_torch.obs.tracer import get_tracer
from crdt_tpu_torch.ops import packed as pk
from crdt_tpu_torch.ops.device import bucket_pow2 as _bucket
from crdt_tpu_torch.ops.device import resolve_device, xfer_put
from crdt_tpu_torch.ops.staging import _KID_BITS

# (name, dtype) in kernel argument order
COLUMNS = (
    ("client", np.int32),
    ("clock", np.int64),
    ("parent_is_root", np.bool_),
    ("parent_a", np.int64),
    ("parent_b", np.int64),
    ("key_id", np.int32),
    ("origin_client", np.int32),
    ("origin_clock", np.int64),
    ("valid", np.bool_),
)

_FILL = {
    "client": 0,
    "clock": 0,
    "parent_is_root": False,
    "parent_a": -2,
    "parent_b": -2,
    "key_id": -1,
    "origin_client": -1,
    "origin_clock": -1,
    "valid": False,
}

_TORCH = {np.int32: torch.int32, np.int64: torch.int64,
          np.bool_: torch.bool}


def _null_ranges(device):
    """The 16 null delete ranges a converge without a delete set takes
    (client -1 matches nothing)."""
    return (torch.full((16,), -1, dtype=torch.int32, device=device),
            torch.full((16,), -1, dtype=torch.int64, device=device),
            torch.full((16,), -1, dtype=torch.int64, device=device))


def _converge_all(bufs, d_client, d_start, d_end, num_segments):
    """Map + sequence convergence over the resident buffers: the LWW
    merge (``ds_mask`` inside) and the YATA document order. Returns
    ``(maps_out, seq_out)`` as device tensors."""
    from crdt_tpu_torch.ops.merge import converge_maps
    from crdt_tpu_torch.ops.yata import converge_sequences

    maps_out = converge_maps(
        *bufs, d_client, d_start, d_end, num_segments=num_segments,
    )
    seq_out = converge_sequences(*bufs, num_segments=num_segments)
    return maps_out, seq_out


def _splice(bufs, delta, n: int):
    """In-place append of a padded delta at offset ``n``. The caller
    grew the buffers for ``n + len(delta)`` first; a window past the
    end (which JAX's ``dynamic_update_slice`` would clamp) is a bug."""
    for b, d in zip(bufs, delta):
        k = d.shape[0]
        assert n + k <= b.shape[0], (n, k, b.shape[0])
        b[n:n + k].copy_(d)
    return bufs


def _splice_and_converge(bufs, delta, n, d_client, d_start, d_end,
                         num_segments):
    """Append + full convergence in one call (the single-delta replay
    path)."""
    bufs = _splice(bufs, delta, n)
    maps_out, seq_out = _converge_all(
        bufs, d_client, d_start, d_end, num_segments=num_segments,
    )
    return bufs, maps_out, seq_out


def _relabel(bufs, perm: torch.Tensor):
    """Rewrite the client columns in place through an old-dense ->
    new-dense permutation (invalid rows hold 0, which perm covers; -1
    origins stay -1; the origin gather clips as the reference's)."""
    bufs[0].copy_(perm[bufs[0].long()].to(bufs[0].dtype))
    oc = bufs[6]
    hi = perm.shape[0] - 1
    oc.copy_(torch.where(oc >= 0, perm[oc.long().clamp(0, hi)],
                         oc.to(perm.dtype)).to(oc.dtype))
    return bufs


class ResidentColumns:
    """Growable device-resident op columns + in-place convergence, on
    ``device`` (the card unless the caller asks for the CPU; resolved
    at construction, so a CUDA request without a card raises here)."""

    def __init__(
        self,
        capacity: int = 1 << 15,
        clients: Optional[Sequence[int]] = None,
        *,
        device="cuda",
    ):
        self.device = resolve_device(device)
        cap = _bucket(capacity)
        self.n = 0
        self._seen: List[int] = []  # sorted raw client ids
        self._dense: Dict[int, int] = {}  # raw -> rank among seen
        if clients is not None and len(clients) > 0:
            self._intern(np.asarray(sorted(set(int(c) for c in clients))))
        self._bufs: List[torch.Tensor] = [
            torch.full((cap,), _FILL[name], dtype=_TORCH[dt],
                       device=self.device)
            for name, dt in COLUMNS
        ]

    @property
    def capacity(self) -> int:
        return int(self._bufs[0].shape[0])

    def device_bytes(self) -> int:
        """Device-memory footprint of the resident buffers (capacity x
        the column itemsizes, 46 bytes a row), the reference's unit."""
        cap = self.capacity
        return sum(cap * np.dtype(dt).itemsize for _, dt in COLUMNS)

    # -- client interning ---------------------------------------------
    def _intern(self, raw_ids: np.ndarray) -> Optional[np.ndarray]:
        """Register raw ids. Returns an old-dense->new-dense permutation
        when existing ranks shifted (caller must relabel the resident
        columns), else None."""
        new = sorted(set(int(c) for c in raw_ids) - self._dense.keys())
        if not new:
            return None
        shifted = bool(self._seen) and new[0] < self._seen[-1]
        old = dict(self._dense) if shifted else None
        self._seen = sorted(self._seen + new)
        self._seen_arr = np.asarray(self._seen)
        self._dense = {raw: i for i, raw in enumerate(self._seen)}
        if old and self.n:
            perm = np.zeros(len(old), np.int32)
            for raw, od in old.items():
                perm[od] = self._dense[raw]
            return perm
        return None

    def _map_clients(self, arr: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """Raw -> dense for the masked entries; others untouched."""
        out = arr.astype(np.int32).copy()
        if mask.any():
            vals = arr[mask]
            out[mask] = np.searchsorted(self._seen_arr, vals).astype(np.int32)
        return out

    # -- append / converge --------------------------------------------
    def _prepare_delta(self, cols: Dict[str, np.ndarray], k: int):
        """Shared append preamble: client interning (+ the in-place
        relabel when ranks shifted), capacity growth, and the padded
        delta tensors on the device."""
        valid = np.asarray(cols["valid"][:k], bool)
        raw_cl = np.asarray(cols["client"][:k])
        raw_ocl = np.asarray(cols["origin_client"][:k])
        perm = self._intern(
            np.concatenate([raw_cl[valid], raw_ocl[raw_ocl >= 0]])
        )
        if perm is not None:
            _relabel(self._bufs, torch.from_numpy(perm).to(self.device))
        if self.n + k > self.capacity:
            self._grow(self.n + k)
        kpad = min(_bucket(k, floor=6), self.capacity)
        if self.n + kpad > self.capacity:
            self._grow(self.n + kpad)

        delta = []
        for name, dt in COLUMNS:
            arr = np.full(kpad, _FILL[name], dtype=dt)
            if name == "client":
                arr[:k] = np.where(
                    valid, self._map_clients(raw_cl, valid), 0
                )
            elif name == "origin_client":
                arr[:k] = self._map_clients(raw_ocl, raw_ocl >= 0)
            else:
                arr[:k] = cols[name][:k]
            # only the delta crosses the link, accounted per column
            delta.append(xfer_put(arr, device=self.device,
                                  label="resident.delta"))
        return delta

    def append(self, cols: Dict[str, np.ndarray]) -> None:
        """Splice a host-side delta into the resident union. Only the
        delta (padded to its power-of-two bucket) crosses to the
        device; resident rows never re-upload."""
        k = len(cols["client"])
        if k == 0:
            return
        delta = self._prepare_delta(cols, k)
        _splice(self._bufs, delta, self.n)
        self.n += k

    def append_converge(
        self,
        cols: Dict[str, np.ndarray],
        num_segments: Optional[int] = None,
        d_client=None,
        d_start=None,
        d_end=None,
    ):
        """Fused append + convergence, the single-delta replay path.
        Equivalent to ``append(cols)`` then ``converge(...)``."""
        k = len(cols["client"])
        if k == 0:
            return self.converge(
                num_segments=num_segments, d_client=d_client,
                d_start=d_start, d_end=d_end,
            )
        delta = self._prepare_delta(cols, k)
        # default segments AFTER _prepare_delta: it may grow the
        # capacity, and a pre-growth default would alias segment ids
        # (diverging from append() + converge())
        segs = num_segments or self.capacity
        if d_client is None:
            d_client, d_start, d_end = _null_ranges(self.device)
        self._bufs, maps_out, seq_out = _splice_and_converge(
            self._bufs, delta, self.n, d_client, d_start, d_end,
            num_segments=segs,
        )
        self.n += k
        return maps_out, seq_out

    def _grow(self, need: int) -> None:
        new_cap = _bucket(need)
        grown = []
        for (name, dt), b in zip(COLUMNS, self._bufs):
            nb = torch.full((new_cap,), _FILL[name], dtype=_TORCH[dt],
                            device=self.device)
            nb[:b.shape[0]].copy_(b)
            grown.append(nb)
        self._bufs = grown

    def dense_client(self, raw: int) -> Optional[int]:
        """Dense id currently assigned to a raw client id."""
        return self._dense.get(int(raw))

    def converge(
        self,
        num_segments: Optional[int] = None,
        d_client=None,
        d_start=None,
        d_end=None,
    ):
        """One full applyUpdate over the resident union: map winners
        (``converge_maps``) + sequence order (``converge_sequences``).
        Returns the two kernels' raw outputs as DEVICE tensors.

        Delete ranges, when given, must use DENSE client ids
        (:meth:`dense_client`) and lie on the buffers' device.
        """
        segs = num_segments or self.capacity
        if d_client is None:
            d_client, d_start, d_end = _null_ranges(self.device)
        return _converge_all(
            self._bufs, d_client, d_start, d_end, num_segments=segs,
        )


# ---- the POOLED resident matrix --------------------------------------


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
