"""Incremental device replay — per-round cost scales with the delta.

The port's counterpart of ``crdt_tpu.models.incremental``. The cold
replay (:mod:`crdt_tpu_torch.models.replay`) re-stages and re-converges
the whole union every call; fine for one-shot trace ingestion, wasteful
for a long-lived replica consuming update batches forever (the
product's steady state, crdt.js:294 called per gossip round).
:class:`IncrementalReplay` keeps the op columns RESIDENT in device
memory and, per batch:

  1. ships ONLY the packed delta to the device;
  2. splices it into the resident matrix IN PLACE and re-converges ONLY
     the segments the delta touches (one launch sequence, no host sync
     until the one fetch — :func:`crdt_tpu_torch.ops.packed.
     _splice_select_converge`, whose document order is the
     ``stream_scatter`` kernel);
  3. updates host-side per-segment caches (map winners, sequence
     orders) and rebuilds just the affected root collections of the
     plain-JSON cache.

The engine lives on one device, named at construction (``device=``,
the card by default; with no card present construction raises). Host
rounds and the host bookkeeping run in numpy and plain Python whatever
the device.

Admission is vectorized AND engine-faithful: dedup, stable interning,
and the implicit-parent resolution of wire runs (origin-else-right
chains) run as numpy passes — resolution itself is host-side pointer
doubling, O(log chain) array rounds instead of a per-row walk.
Out-of-order delivery follows the engine's rule
(``Engine._blocker_of``): a row integrates only when its per-client
clock run is contiguous and its origin/right/item-parent have arrived;
blocked rows stash in ``_pending`` and retry on every apply, so
intermediate states match ``Engine.apply_records`` under the same
arrival order. (Hostile dependency CYCLES — impossible under causal
delivery — admit as a group, matching the cold replay's convention
rather than pending forever.)

Segments whose rows carry right origins re-order through the exact
host machinery (:func:`crdt_tpu_torch.ops.yata.order_sequences`, ranked
on the CPU) — same split as the cold path's gather. Delete sets only
change visibility, never winners or order, so delete-only batches
rebuild caches without any device work.

Host-path segments below the crossover converge INCREMENTALLY: each
sequence segment keeps an engine-style linked chain (``_lnk_next`` /
``_lnk_prev``, the same structure ``Engine._next/_prev`` uses), and a
remote delta integrates row by row through the verbatim YATA conflict
scan (``Engine._integrate_into_chain``, crdt.js:294) — O(delta x scan
window), independent of document size. Map deltas whose origin is the
current chain tail advance the winner in O(1). Any shape outside the
incremental preconditions (cross-segment/GC origins, unresolvable
refs, accounting mismatches) falls back to the exact whole-segment
machinery, so exactness never rests on the fast path.

The plain-JSON cache is LAZY: a round marks touched segments dirty and
the ``cache`` property flushes them on read, so a replica consuming a
firehose of updates pays zero materialization until someone actually
looks (local fast-path ops still patch it in place when it is fresh).

Held against the reference engine after every round, in forced-device
and forced-host modes, in tests/test_torch_incremental.py.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from crdt_tpu_torch.codec import native, v1
from crdt_tpu_torch.core.engine import evict_deepest
from crdt_tpu_torch.core.ids import DeleteSet, StateVector
from crdt_tpu_torch.core.records import ItemRecord
from crdt_tpu_torch.core.store import K_ANY, K_GC, K_TYPE, TYPE_MAP
from crdt_tpu_torch.guard.device import dispatch_guarded
from crdt_tpu_torch.models.replay import rows_visible
from crdt_tpu_torch.obs.tracer import get_tracer
from crdt_tpu_torch.ops import packed as pk
from crdt_tpu_torch.ops.device import (
    bucket_pow2,
    resolve_device,
    xfer_fetch,
    xfer_put,
)
from crdt_tpu_torch.ops.staging import (_KID_BITS, _PREF_BITS, segkey_int,
                                        segkey_of)
from crdt_tpu_torch.ops.yata import order_hard_segment, order_sequences

# where the pooled matrix (and the snapshot rehydrate) is queued
_POOL_ITEM = "ROADMAP.md queue A item 6 (multi-tenant server and pooled matrix)"


def _octave(n: int, floor: int) -> int:
    """Factor-8 size bucket for the incremental dispatch's shapes. A
    long-lived replica's touched-segment populations GROW monotonically;
    factor-8 steps keep the set of shapes small over the store's whole
    lifetime (the reference compiled one program per shape), and the
    buckets are the reference's, so a device round's outputs compare
    with the reference's directly."""
    b = floor
    while b < n:
        b *= 8
    return b


class _Cols:
    """Growing host-side row store (the union's metadata columns)."""

    INT_COLS = (
        "client", "clock", "kid", "pref", "oc", "ock",
        "right_client", "right_clock", "kind", "type_ref",
    )

    def __init__(self):
        self.n = 0
        self._cap = 1024
        self._a = {
            name: np.zeros(self._cap, np.int64) for name in self.INT_COLS
        }
        self.contents: List = []

    def col(self, name) -> np.ndarray:
        return self._a[name][: self.n]

    def append(self, arrays: Dict[str, np.ndarray], contents):
        k = len(contents)
        while self.n + k > self._cap:
            self._cap *= 2
        for name in self.INT_COLS:
            if len(self._a[name]) < self._cap:
                grown = np.zeros(self._cap, np.int64)
                grown[: self.n] = self._a[name][: self.n]
                self._a[name] = grown
            self._a[name][self.n : self.n + k] = arrays[name]
        self.contents.extend(contents)
        self.n += k

    def append_row(self, client, clock, kid, pref, oc, ock, rc, rk,
                   kind, tref, content) -> int:
        """Scalar append for the local-op fast path: one row, plain
        Python ints, no numpy temporaries."""
        i = self.n
        if i + 1 > self._cap:
            while i + 1 > self._cap:
                self._cap *= 2
            for name in self.INT_COLS:
                grown = np.zeros(self._cap, np.int64)
                grown[:i] = self._a[name][:i]
                self._a[name] = grown
        a = self._a
        a["client"][i] = client
        a["clock"][i] = clock
        a["kid"][i] = kid
        a["pref"][i] = pref
        a["oc"][i] = oc
        a["ock"][i] = ock
        a["right_client"][i] = rc
        a["right_clock"][i] = rk
        a["kind"][i] = kind
        a["type_ref"][i] = tref
        self.contents.append(content)
        self.n = i + 1
        return i


class IncrementalReplay:
    """A long-lived replica state fed by v1 update blobs, converging on
    ``device`` (the card unless the caller asks for the CPU).

    ``device_min_rows`` is the host/device crossover: when the rows of
    a round's touched segments total fewer than this, convergence runs
    through the exact host machinery against the resident columns and
    the round does ZERO device work — its rows accumulate, and the
    next device round splices the whole unspliced tail in its one
    upload (``n_dev`` marks the boundary; admission appends in order,
    so host row ids and device positions stay identical). The default
    (``device_min_rows=None``) AUTO-CALIBRATES once a process and device
    type: the probe on the first device-eligible round feeds the cost
    model in :meth:`_calibrate`. ``CRDT_TPU_DEVICE_MIN`` or the
    constructor argument pin it explicitly.

    ``pool=`` (the multi-tenant server's pooled matrix) is not ported
    yet and raises ``NotImplementedError``."""

    # process-wide host/device crossover calibration, one probe per
    # device type, filled lazily by _calibrate()
    _calib: Dict[str, Dict[str, Optional[float]]] = {}

    @classmethod
    def _calibrate(cls, device="cuda") -> Dict[str, Optional[float]]:
        """One-time probes on ``device`` -> the row count where a
        3-interaction device round beats the host path's per-row cost.
        Floored at 4096 so a fast device never takes keystroke rounds.

        Three measurements, all recorded (``calibration_info``):

        - ``t_interact_ms`` — median latency of one tiny launch and a
          wait for it (``torch.cuda.synchronize`` on the card);
        - ``host_us_per_row`` — a REAL 4096-op map blob ingested by a
          throwaway replica pinned to the host path (decode + admit +
          integrate, the exact code a host round runs; min of 2);
        - ``dev_us_per_row`` — the measured host->device->host copy
          bandwidth of 2 MiB, charged at the round's ~72 bytes/row (8
          int64 delta lanes up, one int64 result lane down); on-device
          kernel time per row is negligible against the transfer.
        """
        dev = resolve_device(device)
        calib = cls._calib.get(dev.type)
        if calib is not None:
            return calib

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        x = torch.arange(128, device=dev)
        x + 1
        sync()
        lat = []
        for _ in range(3):
            t0 = time.perf_counter()
            x + 1
            sync()
            lat.append(time.perf_counter() - t0)
        t_i = sorted(lat)[1]

        # host per-row: a real map-set blob through the pinned host
        # path of a throwaway replica (min of 2 fresh ingests)
        n_p = 4096
        recs = [
            ItemRecord(client=1, clock=k, parent_root="_calib",
                       key=f"k{k & 255}", content=k,
                       origin=(1, k - 256) if k >= 256 else None)
            for k in range(n_p)
        ]
        blob_p = v1.encode_update(recs, DeleteSet())
        best = float("inf")
        for _ in range(2):
            probe = cls(capacity=n_p + 64, device_min_rows=1 << 62,
                        device="cpu")
            t0 = time.perf_counter()
            probe.apply([blob_p])
            best = min(best, time.perf_counter() - t0)
        host_us = best * 1e6 / n_p

        # device per-row: measured round-trip bandwidth at the round's
        # bytes/row
        n_b = 1 << 18
        buf = torch.zeros(n_b, dtype=torch.int64)
        buf.to(dev).cpu()  # warm the path
        t0 = time.perf_counter()
        buf.to(dev).cpu()
        t_rt = time.perf_counter() - t0
        bw = (2 * 8 * n_b) / max(t_rt - t_i, 1e-6)  # bytes/s
        dev_us = 72.0 / bw * 1e6

        per_row_us = max(host_us - dev_us, 0.5)
        calib = cls._calib[dev.type] = {
            "t_interact_ms": round(t_i * 1e3, 4),
            # 6 decimals: a fast device's per-row transfer cost can be
            # ~1e-5 us, recorded as the tiny number it is
            "host_us_per_row": round(host_us, 6),
            "dev_us_per_row": round(dev_us, 6),
            "threshold": max(4096, int(3 * t_i * 1e9 / per_row_us
                                       / 1e3)),
        }
        return calib

    # static floor: below this, never pay the calibration probe just to
    # learn the work belongs on host
    _CROSSOVER_FLOOR = 16384

    @classmethod
    def crossover_use_host(cls, n_rows: int, device="cuda") -> bool:
        """The host/device crossover decision for ``n_rows`` of touched
        work on ``device`` — the ONE implementation shared by the live
        replica's rounds and the cold replay's "auto" route."""
        if n_rows < cls._CROSSOVER_FLOOR:
            return True
        return n_rows < cls._calibrate(device)["threshold"]

    @classmethod
    def calibration_info(cls, device="cuda") -> Dict[str, Optional[float]]:
        """The measured crossover on ``device`` (probing if needed)."""
        return dict(cls._calibrate(device))

    def __init__(self, capacity: int = 1 << 14,
                 device_min_rows: Optional[int] = None,
                 pool=None, *, device="cuda"):
        if pool is not None:
            raise NotImplementedError(
                f"IncrementalReplay(pool=...) is not ported yet ({_POOL_ITEM})"
            )
        # the device resolves HERE, outside any guarded dispatch: a
        # missing card raises at construction instead of sending every
        # round quietly down the host rung of the failure ladder
        self.device = resolve_device(device)
        if device_min_rows is None:
            env = os.environ.get("CRDT_TPU_DEVICE_MIN")
            # None = AUTO: calibrate on the first device-eligible round
            # (never at construction — replicas come up without
            # touching the device)
            device_min_rows = int(env) if env else None
        self.device_min_rows = device_min_rows
        self.cols = _Cols()
        self.ds = DeleteSet()
        self._cache: dict = {}
        self._dirty: set = set()  # segkeys whose cache view is stale
        self.last_touched_roots: List[str] = []
        self.last_touched_keys: Dict[str, set] = {}
        # stable interners
        self._keys: Dict[str, int] = {}
        self._key_names: List[str] = []
        self._prefs: Dict[Tuple, int] = {}
        self._pref_spec: List[Tuple] = []  # pref -> parent spec
        self._pref_item_c: List[int] = []  # pref -> item-parent id
        self._pref_item_k: List[int] = []  # (-1, -1 for root specs)
        self._next_clock: Dict[int, int] = {}
        self._clients: List[int] = []      # sorted raw ids
        self._dense: Dict[int, int] = {}
        self._id_row: Dict[Tuple[int, int], int] = {}
        # per-segment state (keyed by int segkey)
        self._seg_rows: Dict[int, List[int]] = {}
        self._seg_kid: Dict[int, int] = {}        # -1 for sequences
        self._seg_rights: Dict[int, bool] = {}
        self._win: Dict[int, int] = {}            # map segkey -> winner row
        self._order: Dict[int, List[int]] = {}    # seq segkey -> rows
        # lazy row->position maps over _order (O(1) anchor lookups for
        # the resident doc's local ops). Invalidated whenever a
        # segment's order is reassigned (_set_order) or mid-spliced;
        # rebuilt on demand.
        self._order_pos: Dict[int, Dict[int, int]] = {}
        # engine-style linked chains (Engine._next/_prev) for host-path
        # sequence segments: the incremental integrate scan splices
        # these in O(window); the _order list is then a stale
        # materialization rebuilt lazily by order_list()
        self._lnk_next: Dict[int, int] = {}
        self._lnk_prev: Dict[int, int] = {}
        self._lnk_head: Dict[int, int] = {}       # segkey -> first row
        self._lnk_tail: Dict[int, int] = {}
        self._linked: set = set()                 # segkeys with live links
        self._order_stale: set = set()            # linked, list out of date
        # per-segment ORDER EPOCH: bumped on every mutation that can
        # shift document positions or visibility (splices, wholesale
        # reorders, delete-touched rounds). Position caches held by
        # callers validate against it instead of guessing staleness.
        self._order_epoch: Dict[int, int] = {}
        self._root_segs: Dict[str, set] = {}      # root name -> segkeys
        self._spec_root: Dict[Tuple, str] = {}
        self._rootless: set = set()               # segkeys awaiting a root
        # engine-faithful admission: rows whose per-client clock run
        # has a gap, or whose origin/right has not arrived, stash here
        # (columns + content keyed by id) and retry on every apply
        self._pending: Dict[Tuple[int, int], Tuple] = {}
        # pending-stash budget — same contract as Engine.pending_limit:
        # None = unbounded; overflow evicts the largest-clock entries
        # and records the evicted ranges for the replica's targeted
        # re-probe (take_evicted_ranges)
        self.pending_limit: Optional[int] = None
        self.evicted_ranges: Dict[int, Tuple[int, int]] = {}
        # packed delete-RANGE cache over self.ds (client, start, end
        # arrays for rows_visible) — tombstones are never expanded to
        # per-clock ids: a few delete-set bytes can declare ranges
        # covering billions of clocks. Invalidated on every ds
        # mutation, rebuilt O(ranges) on demand.
        self._ds_pack = None
        # per-apply scratch: segkey -> this batch's admitted rows
        self._new_by_seg: Dict[int, List[int]] = {}
        # the resident device matrix allocates LAZILY on the first
        # device round: construction never touches the device (a swarm
        # of host-path replicas must not pay for a matrix just to exist)
        self._capacity = capacity
        self._mat: Optional[torch.Tensor] = None
        self.n_dev = 0
        # snapshot-rehydrated engines carry exact winner / order caches
        # but NO device state: their device rounds first try the
        # O(delta) host tail advances. The rehydrate that sets this is
        # not ported yet (the multi-tenant server's snapshot store);
        # the round keeps its branch for it.
        self._from_snapshot = False

    def _ensure_mat(self) -> torch.Tensor:
        if self._mat is None:
            self._mat = pk.new_resident_mat(bucket_pow2(self._capacity),
                                            self.device)
        return self._mat

    # -- interning ----------------------------------------------------
    def _intern_clients(self, raw_ids: np.ndarray) -> None:
        new = sorted(set(int(c) for c in raw_ids) - self._dense.keys())
        if not new:
            return
        shifted = bool(self._clients) and new[0] < self._clients[-1]
        old = dict(self._dense) if shifted else None
        clients = sorted(self._clients + new)
        dense = {raw: i for i, raw in enumerate(clients)}
        if old and self.n_dev:
            perm = np.zeros(len(old), np.int32)
            for raw, od in old.items():
                perm[od] = dense[raw]
            pk._relabel_mat(self._mat, xfer_put(
                perm, device=self.device, label="incremental.relabel"))
            # host columns keep RAW ids; only the device matrix embeds
            # dense ids, so no host fixups
        # the table commits only AFTER the device relabel succeeded
        self._clients = clients
        self._clients_arr = np.asarray(clients)
        self._dense = dense

    def _dense_of(self, raw: np.ndarray) -> np.ndarray:
        return np.searchsorted(self._clients_arr, raw).astype(np.int64)

    def _pref_of_spec(self, spec: Tuple) -> int:
        ref = self._prefs.get(spec)
        if ref is None:
            ref = len(self._prefs)
            if ref >= (1 << _PREF_BITS):
                raise OverflowError("parent-ref space exhausted")
            self._prefs[spec] = ref
            self._pref_spec.append(spec)
            if spec[0] == "item":
                self._pref_item_c.append(spec[1])
                self._pref_item_k.append(spec[2])
            else:
                self._pref_item_c.append(-1)
                self._pref_item_k.append(-1)
        return ref

    def _spec_of_row(self, row: int) -> Optional[Tuple]:
        pref = int(self.cols.col("pref")[row])
        return self._pref_spec[pref] if pref >= 0 else None

    def _kid_of_key(self, name: str) -> int:
        kid = self._keys.get(name)
        if kid is None:
            kid = len(self._keys)
            if kid >= (1 << _KID_BITS):
                # a silent overflow would bleed into the pref bits of
                # the composite segkey and merge unrelated segments
                raise OverflowError("map-key id space exhausted")
            self._keys[name] = kid
            self._key_names.append(name)
        return kid

    # -- apply --------------------------------------------------------
    def apply(self, blobs) -> None:
        """Consume a batch of update blobs. The JSON view is marked
        dirty, not rebuilt — read ``.cache`` for the flushed state."""
        if isinstance(blobs, (bytes, bytearray)):
            blobs = [bytes(blobs)]
        with get_tracer().span("incremental.decode"):
            dec = native.dedup_columns(
                native.decode_updates_columns_any(blobs))
        self.apply_decoded(dec)

    def apply_decoded(self, dec) -> None:
        """Consume an already-decoded (deduped) columnar union —
        the seam for callers that decoded once for their own purposes
        (replay_trace's host route) and must not pay the codec
        twice."""
        n_raw = len(dec["client"])
        touched: set = set()

        # delete ranges: visibility-only — record which segments they
        # tombstone so their cache entries rebuild. Spans already
        # fully covered by the recorded delete set are REDELIVERY and
        # mark nothing (a duplicate gossip delivery must not re-scan
        # the columns or rebuild every covered segment's cache); fresh
        # spans clamp at each client's admitted watermark — rows
        # cannot exist beyond it, so a hostile range covering clocks
        # that may never exist costs O(ranges), not O(declared
        # length); late rows check visibility against the range set
        # at admission.
        trips = np.asarray(dec["ds"]).reshape(-1, 3)
        if len(trips):
            batch_ds = DeleteSet()
            for c, k, length in trips:
                batch_ds.add(int(c), int(k), int(length))
            spans = []
            for c, s, length in batch_ds.iter_all():
                if self.ds.covers(c, s, length):
                    continue  # redelivered: already recorded
                end = min(s + length, self._next_clock.get(c, 0))
                if end > s:
                    spans.append((c, s, end))
            for c, k, length in trips:
                self.ds.add(int(c), int(k), int(length))
            self._ds_pack = None
            total = sum(e - s for _, s, e in spans)
            if spans and total * 4 > self.cols.n and self.cols.n:
                # bulk range: one vectorized scan over the id columns
                hit = ~rows_visible(
                    self.cols.col("client"), self.cols.col("clock"),
                    np.asarray([c for c, _, _ in spans], np.int64),
                    np.asarray([s for _, s, _ in spans], np.int64),
                    np.asarray([e for _, _, e in spans], np.int64),
                )
                rows_hit = np.flatnonzero(hit)
            else:
                rows_hit = [
                    r for r in (
                        self._id_row.get((c, kk))
                        for c, s, e in spans
                        for kk in range(s, e)
                    ) if r is not None
                ]
            for row in rows_hit:
                sk = self._row_segkey(int(row))
                if sk is not None:
                    touched.add(sk)

        self._new_by_seg = {}
        with get_tracer().span("incremental.admit"):
            new_rows = self._admit(dec) if n_raw else None
        # segments delivered before their parent item: retry now that
        # this batch may have supplied the missing ancestors
        if self._rootless:
            for sk in list(self._rootless):
                root = self._root_of(self._seg_spec(sk))
                if root is not None:
                    self._rootless.discard(sk)
                    self._root_segs.setdefault(root, set()).add(sk)
                    touched.add(sk)
        if new_rows is not None and len(new_rows):
            by_seg = self._new_by_seg
            touched.update(by_seg)
            self._device_round(by_seg)
        self._touch_bookkeeping(touched)
        self._dirty.update(
            sk for sk in touched if sk in self._seg_rows
        )

    # -- delta admissibility (the multi-doc server's probe) -----------
    @staticmethod
    def decode_delta(blobs) -> Dict:
        """Decode an update batch into the engine's columnar format
        WITHOUT touching replica state: the multi-doc server's
        admissibility probe decodes once, then feeds the same dec to
        :meth:`apply_decoded` (or discards it and cold-replays)."""
        if isinstance(blobs, (bytes, bytearray)):
            blobs = [bytes(blobs)]
        return native.dedup_columns(
            native.decode_updates_columns_any(list(blobs))
        )

    def delta_admissible(self, dec) -> bool:
        """Would this decoded batch admit WHOLE — no row stashed — so
        the incremental route stays byte-identical to a cold replay
        of the same history? Mirrors :meth:`_admit`'s gate,
        read-only and conservatively:

        - no outstanding stash (pending rows or rootless segments:
          only the full apply pass retries those);
        - every fresh row's clock extends its client's admitted run
          contiguously (offset clocks — a gap the cold replay would
          admit but the engine would stash — refuse);
        - every origin / right / explicit item-parent ref resolves to
          a resident row or another row of this same batch.

        A refusal costs the caller a cold replay, never bytes."""
        if self._pending or self._rootless:
            return False
        n = len(dec["client"])
        if n == 0:
            return True  # delete-only / empty: visibility work only
        client = np.asarray(dec["client"], np.int64)
        clock = np.asarray(dec["clock"], np.int64)
        fresh = np.fromiter(
            (t not in self._id_row
             for t in zip(client.tolist(), clock.tolist())),
            bool, count=n,
        )
        idx = np.flatnonzero(fresh)
        if len(idx) == 0:
            return True  # pure redelivery: dedup drops every row
        cl, ck = client[idx], clock[idx]
        in_batch = set(zip(cl.tolist(), ck.tolist()))
        order = np.lexsort((ck, cl))
        cl_s, ck_s = cl[order], ck[order]
        starts = np.flatnonzero(np.r_[True, cl_s[1:] != cl_s[:-1]])
        ends = np.r_[starts[1:], len(cl_s)]
        for s, e in zip(starts.tolist(), ends.tolist()):
            nxt = self._next_clock.get(int(cl_s[s]), 0)
            # post-dedup clocks are distinct, so run-span equality IS
            # contiguity from the resident watermark
            if int(ck_s[s]) != nxt or \
                    int(ck_s[e - 1]) - nxt != e - s - 1:
                return False
        for c_col, k_col in (
            ("origin_client", "origin_clock"),
            ("right_client", "right_clock"),
            ("parent_client", "parent_clock"),
        ):
            c_a = np.asarray(dec[c_col], np.int64)[idx]
            k_a = np.asarray(dec[k_col], np.int64)[idx]
            for j in np.flatnonzero(c_a >= 0).tolist():
                t = (int(c_a[j]), int(k_a[j]))
                if t not in self._id_row and t not in in_batch:
                    return False
        return True

    def resident_bytes(self) -> int:
        """Footprint of this replica's resident state: the device
        matrix (when materialized) plus the host integer column store —
        the allocations that scale with doc size and survive across
        rounds (content payloads live in the caller's blobs either
        way)."""
        dev = 0
        if self._mat is not None:
            dev = self._mat.numel() * self._mat.element_size()
        return dev + self.cols._cap * len(_Cols.INT_COLS) * 8

    @staticmethod
    def estimate_resident_bytes(n_rows: int) -> int:
        """Pre-promotion upper bound of :meth:`resident_bytes` for a
        doc of ``n_rows`` ops — the budget gate must refuse BEFORE
        building an over-budget engine, so it works from an estimate:
        the pow2 host column capacity plus a worst-case device matrix
        at the same bucket (host-path docs never allocate it; the
        bound errs toward refusing). The device term uses the
        reference's POOLED layout's 8 lanes — the wider of its two
        routes — so the estimate upper-bounds :meth:`resident_bytes`
        whichever way the doc lands."""
        cap = 1024
        while cap < max(n_rows, 1):
            cap *= 2
        return cap * len(_Cols.INT_COLS) * 8 + 8 * bucket_pow2(cap) * 8

    # -- local-op fast path -------------------------------------------
    def admit_local(self, recs, ds: Optional[DeleteSet] = None) -> None:
        """Direct admission for locally-born records — the resident
        doc's self-applied ops (crdt.js:294's integrate, local
        direction). The caller anchors every record on resident state
        (origins/rights/parents resident, per-client clocks
        contiguous), so the wire decode, the dedup pass, and the
        vectorized admission gate of :meth:`apply` are all skipped and
        the winner/order caches splice incrementally — O(delta) per op
        instead of a v1 encode/decode round-trip plus an O(segment)
        reorder. Any violated assumption falls
        back to the exact blob path; while stashed or rootless rows
        are outstanding the fast path is skipped entirely (only the
        full pass retries them)."""
        if self._pending or self._rootless or not self._can_fast(recs):
            self.apply([v1.encode_update(list(recs), ds or DeleteSet())])
            return

        touched: set = set()
        # delete ranges: visibility-only. Callers only delete rows that
        # are currently visible (checked against the live delete set
        # before building ``ds``), so these ids are never already in
        # the expanded arrays — the redelivery dedup scan of apply() is
        # unnecessary here.
        if ds is not None and ds.ranges:
            for c, k, length in ds.iter_all():
                self.ds.add(c, k, length)
                for kk in range(k, k + length):
                    row = self._id_row.get((c, kk))
                    if row is not None:
                        sk = self._row_segkey(row)
                        if sk is not None:
                            touched.add(sk)
            self._ds_pack = None

        runs: Dict[int, List[int]] = {}  # segkey -> rows, op order
        for rec in recs:
            spec = (
                ("root", rec.parent_root)
                if rec.parent_root is not None
                else ("item",) + tuple(rec.parent_item)
            )
            pref = self._pref_of_spec(spec)
            kid = self._kid_of_key(rec.key) if rec.key is not None else -1
            oc, ock = rec.origin if rec.origin is not None else (-1, -1)
            rc, rk = rec.right if rec.right is not None else (-1, -1)
            row = self.cols.append_row(
                rec.client, rec.clock, kid, pref, oc, ock, rc, rk,
                rec.kind, rec.type_ref, rec.content,
            )
            self._id_row[(rec.client, rec.clock)] = row
            self._next_clock[rec.client] = rec.clock + 1
            sk = segkey_int(pref, kid)
            seg_rows = self._seg_rows.get(sk)
            if seg_rows is None:
                seg_rows = self._seg_rows[sk] = []
                self._seg_kid[sk] = kid
                root = self._root_of(spec)
                if root is not None:
                    self._root_segs.setdefault(root, set()).add(sk)
                else:  # unreachable for local ops; mirrors _admit
                    self._rootless.add(sk)
            seg_rows.append(row)
            if rc >= 0:
                self._seg_rights[sk] = True
            runs.setdefault(sk, []).append(row)

        # convergence + cache: fast shapes (root-map K_ANY set, root-
        # list tail append) patch the plain-JSON cache directly; every
        # other segment goes through _rebuild_cache. Cache values are
        # the stored contents, same references _build_collection uses.
        # ``touched`` here holds ONLY delete-touched segments (the
        # record loop tracks its segments in ``runs``, not here) — a
        # visibility change always rebuilds fully
        slow: set = set(touched)
        fast_roots: Dict[str, set] = {}
        for sk, new_rows in runs.items():
            kid = self._seg_kid.get(sk, -1)
            if kid >= 0:
                ok = self._splice_map_local(sk, new_rows)
            else:
                ok = self._splice_seq_local(sk, new_rows)
            if not ok or sk in slow:
                slow.add(sk)
                continue
            spec = self._seg_spec(sk)
            root = spec[1] if spec is not None and spec[0] == "root" else None
            if root is None or root == "ix":
                slow.add(sk)  # nested / index: full bookkeeping path
                continue
            kinds = self.cols.col("kind")
            if kid >= 0:
                row = self._win[sk]
                tgt = self._cache.get(root)
                if (
                    row in new_rows
                    and int(kinds[row]) == K_ANY
                    and isinstance(tgt, dict)
                ):
                    kname = self._key_names[kid]
                    tgt[kname] = self.cols.contents[row]
                    fast_roots.setdefault(root, set()).add(kname)
                else:
                    slow.add(sk)
            else:
                tgt = self._cache.get(root)
                if (
                    ok == "append"
                    and isinstance(tgt, list)
                    and all(int(kinds[r]) == K_ANY for r in new_rows)
                ):
                    tgt.extend(self.cols.contents[r] for r in new_rows)
                    fast_roots.setdefault(root, set())
                else:
                    slow.add(sk)
        if slow:
            self._touch_bookkeeping(slow)
            self._dirty.update(sk for sk in slow if sk in self._seg_rows)
            roots = set(self.last_touched_roots)
            keys = self.last_touched_keys
        else:
            roots, keys = set(), {}
        for root, ks in fast_roots.items():
            roots.add(root)
            if ks:
                keys.setdefault(root, set()).update(ks)
        self.last_touched_roots = sorted(roots)
        self.last_touched_keys = keys

    def _can_fast(self, recs) -> bool:
        """Cheap preflight for :meth:`admit_local`: contiguous clocks
        and resident (or in-batch) dependencies for every record."""
        nxt: Dict[int, int] = {}
        batch_ids: set = set()
        for rec in recs:
            want = nxt.get(rec.client)
            if want is None:
                want = self._next_clock.get(rec.client, 0)
            if rec.clock != want:
                return False
            nxt[rec.client] = rec.clock + 1
            for dep in rec.dep_ids():
                if dep not in self._id_row and dep not in batch_ids:
                    return False
            batch_ids.add((rec.client, rec.clock))
        return True

    def _anchor_rows(self, row: int):
        """Resolve a row's declared origin/right to resident rows via
        the id index. Returns (left, right, left_declared,
        right_declared); a declared-but-unresolvable reference comes
        back None with its declared flag True (callers decide whether
        that is a fallback condition)."""
        c = self.cols
        o = int(c.col("oc")[row])
        left = (
            self._id_row.get((o, int(c.col("ock")[row])))
            if o >= 0 else None
        )
        r = int(c.col("right_client")[row])
        right = (
            self._id_row.get((r, int(c.col("right_clock")[row])))
            if r >= 0 else None
        )
        return left, right, o >= 0, r >= 0

    def _splice_map_local(self, sk: int, new_rows: List[int]) -> bool:
        """Local map sets share the remote path's O(1) tail advance
        (one rule, one implementation); a bent anchor re-derives the
        chain exactly — _host_order_segment repairs any partial _win
        advance wholesale."""
        if self._advance_map_tail(sk, new_rows):
            return True
        self._host_order_segment(sk)
        return False

    def _is_chained_run(self, new_rows: List[int]) -> bool:
        """Verify the contract both local seq splices rely on: the
        batch is ONE chained run at ONE insertion point — each row
        after the head declares the preceding new row as its origin
        and shares the head's right anchor. A caller that batches two
        independent inserts on the same segment into one call bends
        this; verifying here turns silent misordering into the exact
        fallback."""
        if len(new_rows) <= 1:
            return True
        c = self.cols
        cl, ck = c.col("client"), c.col("clock")
        oc, ock = c.col("oc"), c.col("ock")
        rc, rk = c.col("right_client"), c.col("right_clock")
        head = new_rows[0]
        hr = (int(rc[head]), int(rk[head]))
        prev = head
        for row in new_rows[1:]:
            if (int(oc[row]), int(ock[row])) != (int(cl[prev]), int(ck[prev])):
                return False
            if (int(rc[row]), int(rk[row])) != hr:
                return False
            prev = row
        return True

    def _advance_seq_tail(self, sk: int, new_rows: List[int]) -> bool:
        """Pure TAIL-append advance for a sequence segment: a chained
        run anchored on the current order tail with no right anchor —
        O(delta), exact, and side-effect free on refusal (unlike
        :meth:`_splice_seq_local`, which re-derives wholesale when its
        preconditions bend). The rehydrated-engine device rounds use
        this to skip the dispatch entirely for steady tail traffic."""
        if not self._is_chained_run(new_rows):
            return False
        head = new_rows[0]
        left_row, right_row, _, right_decl = self._anchor_rows(head)
        if right_decl or right_row is not None:
            return False
        if sk in self._linked:
            tail = self._lnk_tail.get(sk, -1)
            if (left_row if left_row is not None else -1) != tail:
                return False
            prev = left_row
            for row in new_rows:
                self._link_splice(sk, row, prev)
                prev = row
            self._order_stale.add(sk)
            return True
        order = self._order.get(sk)
        if order is None or \
                len(order) + len(new_rows) != len(self._seg_rows[sk]):
            return False
        if not ((left_row is None and not order)
                or (order and left_row == order[-1])):
            return False
        pos_map = self._order_pos.get(sk)
        if pos_map is not None:
            base = len(order)
            for i, row in enumerate(new_rows):
                pos_map[row] = base + i
        order.extend(new_rows)
        # tail append: existing positions unchanged, no epoch bump
        return True

    def _splice_seq_local(self, sk: int, new_rows: List[int]):
        """One local insert run: chained records sharing an insertion
        point. The caller read ``left``/``right`` as ADJACENT rows of
        the cached full order, so the YATA conflict scan between them
        is empty and the run splices verbatim at that point — exact
        regardless of how the surrounding rows were ordered. Moved
        anchors (contract bent) re-derive exactly. Returns "append" /
        "mid" for a fast splice, False after a full re-derive."""
        if not self._is_chained_run(new_rows):
            self._host_order_segment(sk)
            return False
        if sk in self._linked:
            return self._splice_seq_local_linked(sk, new_rows)
        order = self._order.get(sk)
        if order is None:
            order = []
            self._set_order(sk, order)
        if len(order) + len(new_rows) != len(self._seg_rows[sk]):
            # the cached order does not account for every admitted row
            # of this segment — never splice against a partial view
            self._host_order_segment(sk)
            return False
        head = new_rows[0]
        left_row, right_row, _, right_decl = self._anchor_rows(head)
        if right_decl and right_row is None:
            self._host_order_segment(sk)  # dangling right: full path
            return False
        if right_row is None:
            if (left_row is None and not order) or (
                order and left_row == order[-1]
            ):
                pos_map = self._order_pos.get(sk)
                if pos_map is not None:
                    base = len(order)
                    for i, row in enumerate(new_rows):
                        pos_map[row] = base + i
                order.extend(new_rows)
                # tail append: existing positions unchanged, no bump
                return "append"
        else:
            pos = self.order_position(sk, right_row)
            if pos is not None and (
                (pos == 0 and left_row is None)
                or (pos > 0 and left_row == order[pos - 1])
            ):
                # a mid-insert on the LIST form pays an O(segment)
                # memmove per op; the first one converts the segment
                # to its linked-chain form (one O(segment) pass), so
                # an editing run of mid-inserts is O(1) each after
                # (the keystroke regime)
                if self._build_links(sk, len(new_rows)):
                    return self._splice_seq_local_linked(sk, new_rows)
                order[pos:pos] = new_rows
                self._order_pos.pop(sk, None)  # positions shifted
                self._bump_epoch(sk)
                return "mid"
        self._host_order_segment(sk)
        return False

    def _splice_seq_local_linked(self, sk: int, new_rows: List[int]):
        """The linked-chain variant of the local splice: O(1) pointer
        surgery, same adjacency contract."""
        head = new_rows[0]
        left_row, right_row, _, right_decl = self._anchor_rows(head)
        if right_decl and right_row is None:
            self._host_order_segment(sk)  # dangling right: full path
            return False
        expected = (
            self._lnk_next.get(left_row, -1) if left_row is not None
            else self._lnk_head.get(sk, -1)
        )
        if expected != (right_row if right_row is not None else -1):
            self._host_order_segment(sk)  # anchors moved: re-derive
            return False
        prev = left_row
        for row in new_rows:
            self._link_splice(sk, row, prev)
            prev = row
        self._order_stale.add(sk)
        return "append" if right_row is None else "mid"

    def _row_segkey(self, row: int) -> Optional[int]:
        pref = int(self.cols.col("pref")[row])
        if pref < 0:
            return None
        return int(segkey_of(
            np.int64(pref), np.int64(self.cols.col("kid")[row])
        ))

    # -- admission (vectorized) ---------------------------------------
    def _admit(self, dec) -> np.ndarray:
        """Stable-intern a decoded batch, gate it through the engine's
        admission rule (per-client clock contiguity + origin/right/
        parent presence; failures stash in ``_pending`` and retry every
        apply), and append the admitted rows. Returns the new host row
        indices (np array, possibly empty)."""
        n = len(dec["client"])
        client = dec["client"].astype(np.int64)
        clock = dec["clock"].astype(np.int64)

        # dedup vs resident (bulk dict probes) — in-batch duplicates
        # were already dropped by native.dedup_columns
        tups = list(zip(client.tolist(), clock.tolist()))
        fresh = np.fromiter(
            (t not in self._id_row for t in tups), bool, count=n
        )
        idx = np.flatnonzero(fresh)
        k = len(idx)
        if k == 0 and not self._pending:
            return idx

        pr = dec["parent_root"][idx].astype(np.int64)
        pc = dec["parent_client"][idx].astype(np.int64)
        pkk = dec["parent_clock"][idx].astype(np.int64)
        bkid = dec["key_id"][idx].astype(np.int64)
        oc = dec["origin_client"][idx].astype(np.int64)
        ock = dec["origin_clock"][idx].astype(np.int64)
        rc = dec["right_client"][idx].astype(np.int64)
        rk = dec["right_clock"][idx].astype(np.int64)
        kind = dec["kind"][idx].astype(np.int64)
        cl = client[idx]
        ck = clock[idx]

        # stable key ids (batch table -> stable table)
        key_map = np.asarray(
            [self._kid_of_key(name) for name in dec["keys"]], np.int64
        )
        kid = np.full(k, -1, np.int64)
        mk_ = bkid >= 0
        if mk_.any():
            kid[mk_] = key_map[bkid[mk_]]

        # explicit parent refs
        root_map = np.asarray(
            [self._pref_of_spec(("root", name)) for name in dec["roots"]],
            np.int64,
        )
        pref = np.full(k, -1, np.int64)
        m_root = pr >= 0
        if m_root.any():
            pref[m_root] = root_map[pr[m_root]]
        m_item = (~m_root) & (pc >= 0)
        if m_item.any():
            pairs = np.stack([pc[m_item], pkk[m_item]], axis=1)
            uniq, inv = np.unique(pairs, axis=0, return_inverse=True)
            refs = np.asarray(
                [
                    self._pref_of_spec(("item", int(a), int(b)))
                    for a, b in uniq
                ],
                np.int64,
            )
            pref[m_item] = refs[inv]

        # merge the pending stash (retry with this batch), dropping
        # stashed ids redelivered in this very batch
        contents = [dec["contents"][i] for i in idx.tolist()]
        tref = dec["type_ref"][idx].astype(np.int64)
        if self._pending:
            fresh_ids = set(zip(cl.tolist(), ck.tolist()))
            pend = [
                (pid, row) for pid, row in self._pending.items()
                if pid not in fresh_ids
            ]
            if pend:
                parr = np.asarray([row[:9] for _, row in pend], np.int64)
                cl = np.concatenate([cl, parr[:, 0]])
                ck = np.concatenate([ck, parr[:, 1]])
                pref = np.concatenate([pref, parr[:, 2]])
                kid = np.concatenate([kid, parr[:, 3]])
                oc = np.concatenate([oc, parr[:, 4]])
                ock = np.concatenate([ock, parr[:, 5]])
                rc = np.concatenate([rc, parr[:, 6]])
                rk = np.concatenate([rk, parr[:, 7]])
                kind = np.concatenate([kind, parr[:, 8]])
                tref = np.concatenate(
                    [tref, np.asarray([row[9] for _, row in pend])]
                )
                contents.extend(row[10] for _, row in pend)
            self._pending = {}
        k = len(cl)
        if k == 0:
            return np.empty(0, np.int64)

        # (client, clock) -> batch index, shared by the implicit-parent
        # resolution and the admission gate's dependency lookups
        btups = {t: j for j, t in enumerate(zip(cl.tolist(), ck.tolist()))}

        # implicit parents/keys: pointer doubling over the
        # origin-else-right graph (in-batch hops; refs that hit the
        # resident union terminate with its pref/kid immediately)
        need = (pref < 0) & (kind != K_GC)
        if need.any():
            ref_c = np.where(oc >= 0, oc, rc)
            ref_k = np.where(oc >= 0, ock, rk)
            has_ref = ref_c >= 0
            ptr = np.arange(k)
            term_pref = pref.copy()
            term_kid = kid.copy()
            rlist = list(zip(ref_c.tolist(), ref_k.tolist()))
            for j in np.flatnonzero(need & has_ref):
                t = rlist[j]
                jj = btups.get(t)
                if jj is not None:
                    ptr[j] = jj
                else:
                    row = self._id_row.get(t)
                    if row is not None:
                        term_pref[j] = self.cols.col("pref")[row]
                        if term_kid[j] < 0:
                            term_kid[j] = self.cols.col("kid")[row]
            rounds = max(1, (max(k, 2) - 1).bit_length() + 1)
            for _ in range(rounds):
                gp = term_pref[ptr]
                gk = term_kid[ptr]
                upd = term_pref < 0
                term_pref = np.where(upd, gp, term_pref)
                term_kid = np.where(upd & (term_kid < 0), gk, term_kid)
                ptr = ptr[ptr]
            pref = np.where(need, term_pref, pref)
            kid = np.where(need & (kid < 0), term_kid, kid)

        # ---- admission gate: the ENGINE's rule ----------------------
        # a row integrates only when its clock is the next for its
        # client (contiguity) and its origin/right/item-parent are all
        # present (resident, or admitted in this same pass). Failures
        # stash in _pending and retry on every later apply.
        sort_ord = np.lexsort((ck, cl))
        cl_s, ck_s = cl[sort_ord], ck[sort_ord]
        run_starts = np.flatnonzero(np.r_[True, cl_s[1:] != cl_s[:-1]])
        run_ends = np.r_[run_starts[1:], k]
        nxt0 = np.asarray([
            self._next_clock.get(int(cl_s[s]), 0) for s in run_starts
        ])

        if self._pref_item_c:
            pic = np.asarray(self._pref_item_c, np.int64)
            pik = np.asarray(self._pref_item_k, np.int64)
            dep_pc = np.where(pref >= 0, pic[np.clip(pref, 0, None)], -1)
            dep_pk = np.where(pref >= 0, pik[np.clip(pref, 0, None)], -1)
        else:
            dep_pc = np.full(k, -1, np.int64)
            dep_pk = np.full(k, -1, np.int64)

        def dep_state(c_arr, k_arr):
            """(in_resident, in_batch_index) per row; -1 = no dep."""
            res = np.zeros(k, bool)
            bidx2 = np.full(k, -1, np.int64)
            for j in np.flatnonzero(c_arr >= 0):
                t = (int(c_arr[j]), int(k_arr[j]))
                if t in self._id_row:
                    res[j] = True
                else:
                    bidx2[j] = btups.get(t, -1)
            return res, bidx2

        deps = [
            dep_state(oc, ock),
            dep_state(rc, rk),
            dep_state(dep_pc, dep_pk),
        ]
        dep_c = [oc, rc, dep_pc]

        admit = np.ones(k, bool)
        while True:
            adm_s = admit[sort_ord]
            ok_s = np.zeros(k, bool)
            for r, (s, e) in enumerate(zip(run_starts, run_ends)):
                ok_s[s:e] = np.logical_and.accumulate(
                    adm_s[s:e]
                    & (ck_s[s:e] - nxt0[r] == np.arange(e - s))
                )
            new_admit = np.zeros(k, bool)
            new_admit[sort_ord] = ok_s
            for (res, bidx2), c_arr in zip(deps, dep_c):
                has = c_arr >= 0
                in_batch_ok = (bidx2 >= 0) & new_admit[
                    np.clip(bidx2, 0, None)
                ]
                new_admit &= ~has | res | in_batch_ok
            if (new_admit == admit).all():
                break
            admit = new_admit

        # stash the blocked rows
        blocked = np.flatnonzero(~admit)
        for j in blocked.tolist():
            self._pending[(int(cl[j]), int(ck[j]))] = (
                int(cl[j]), int(ck[j]), int(pref[j]), int(kid[j]),
                int(oc[j]), int(ock[j]), int(rc[j]), int(rk[j]),
                int(kind[j]), int(tref[j]), contents[j],
            )
        if (
            self.pending_limit is not None
            and len(self._pending) > self.pending_limit
        ):
            self._evict_pending()
        if not admit.any():
            return np.empty(0, np.int64)
        # bump per-client next clocks past the admitted runs
        adm_s = admit[sort_ord]
        for r, (s, e) in enumerate(zip(run_starts, run_ends)):
            cnt = int(adm_s[s:e].sum())
            if cnt:
                self._next_clock[int(cl_s[s])] = int(nxt0[r]) + cnt

        a = np.flatnonzero(admit)
        cl, ck, pref, kid = cl[a], ck[a], pref[a], kid[a]
        oc, ock, rc, rk = oc[a], ock[a], rc[a], rk[a]
        kind, tref = kind[a], tref[a]
        contents = [contents[j] for j in a.tolist()]
        k = len(a)

        rows = np.arange(self.cols.n, self.cols.n + k)
        self._id_row.update(zip(
            zip(cl.tolist(), ck.tolist()), rows.tolist()
        ))
        self.cols.append(
            {
                "client": cl, "clock": ck, "kid": kid, "pref": pref,
                "oc": oc, "ock": ock, "right_client": rc,
                "right_clock": rk, "kind": kind, "type_ref": tref,
            },
            contents,
        )

        # segment bookkeeping, grouped per distinct segkey
        live = (pref >= 0) & (kind != K_GC)
        if live.any():
            sks = segkey_of(pref[live], kid[live])
            live_rows = rows[live]
            order = np.argsort(sks, kind="stable")
            sks_s, rows_s = sks[order], live_rows[order]
            rights_s = (rc[live] >= 0)[order]
            cuts = np.r_[
                0, np.flatnonzero(sks_s[1:] != sks_s[:-1]) + 1, len(sks_s)
            ]
            for a, b in zip(cuts[:-1], cuts[1:]):
                sk = int(sks_s[a])
                grp = rows_s[a:b]
                grp_list = grp.tolist()
                # batch order within the segment (stable sort): the
                # incremental integrate's deferral loop relies on it
                self._seg_rows.setdefault(sk, []).extend(grp_list)
                self._new_by_seg[sk] = grp_list
                if sk not in self._seg_kid:
                    self._seg_kid[sk] = int(
                        self.cols.col("kid")[int(grp[0])]
                    )
                if rights_s[a:b].any():
                    self._seg_rights[sk] = True
                root = self._root_of(self._spec_of_row(int(grp[0])))
                if root is not None:
                    self._root_segs.setdefault(root, set()).add(sk)
                else:
                    self._rootless.add(sk)
        return rows

    def _evict_pending(self) -> None:
        """Shrink the stash to ``pending_limit``: drop the ids deepest
        in their own client's queue (the shared fairness/recovery
        policy — :func:`crdt_tpu_torch.core.engine.evict_deepest`) and
        record the evicted ranges for the replica's targeted
        re-probe."""
        evicted, ranges = evict_deepest(
            list(self._pending), self.pending_limit
        )
        for key in evicted:
            del self._pending[key]
        for c, (lo, hi) in ranges.items():
            plo, phi = self.evicted_ranges.get(c, (lo, hi))
            self.evicted_ranges[c] = (min(plo, lo), max(phi, hi))
        if evicted:
            get_tracer().count("engine.pending_evictions", len(evicted))

    def take_evicted_ranges(self) -> Dict[int, Tuple[int, int]]:
        """Drain evicted-range bookkeeping (Engine contract)."""
        ev, self.evicted_ranges = self.evicted_ranges, {}
        return ev

    # -- cache laziness -----------------------------------------------
    @property
    def cache(self) -> dict:
        """The plain-JSON view, flushed on read: rounds only mark
        touched segments dirty, so a replica that is never read pays
        no materialization (crdt.js's `c` equivalent)."""
        if self._dirty:
            dirty, self._dirty = self._dirty, set()
            try:
                with get_tracer().span("incremental.cache"):
                    self._rebuild_cache(dirty)
            except BaseException:
                # a failed rebuild must not mark the segments clean:
                # the JSON view would stay permanently stale while
                # reporting fresh
                self._dirty |= dirty
                raise
        return self._cache

    # -- order access (list, positions, linked chains) ----------------
    def _bump_epoch(self, sk: int) -> None:
        self._order_epoch[sk] = self._order_epoch.get(sk, 0) + 1

    def order_epoch(self, sk: int) -> int:
        """Monotone per-segment counter: unchanged value between two
        reads guarantees document positions and visibility in the
        segment did not move (callers key position caches on it)."""
        return self._order_epoch.get(sk, 0)

    def _set_order(self, sk: int, rows: List[int]) -> None:
        """Every whole-order reassignment goes through here so the
        lazy position map and the linked chain can never serve a
        stale view."""
        self._drop_links(sk)
        self._order[sk] = rows
        self._order_pos.pop(sk, None)
        self._bump_epoch(sk)

    def order_list(self, sk: int) -> List[int]:
        """The segment's document order as a list, materializing from
        the linked chain when the list is stale."""
        if sk in self._order_stale:
            out = []
            nxt = self._lnk_next
            cur = self._lnk_head.get(sk, -1)
            while cur != -1:
                out.append(cur)
                cur = nxt.get(cur, -1)
            self._order[sk] = out
            self._order_pos.pop(sk, None)
            self._order_stale.discard(sk)
        return self._order.get(sk, [])

    def order_position(self, sk: int, row: int) -> Optional[int]:
        """Position of ``row`` in segment ``sk``'s cached order, O(1)
        amortized via the lazy row->position map."""
        pos = self._order_pos.get(sk)
        if pos is None:
            pos = {r: i for i, r in enumerate(self.order_list(sk))}
            self._order_pos[sk] = pos
        return pos.get(row)

    def iter_order(self, sk: int):
        """Forward document-order iteration without materializing a
        stale list (O(1) per step on linked segments)."""
        if sk in self._linked:
            nxt = self._lnk_next
            cur = self._lnk_head.get(sk, -1)
            while cur != -1:
                yield cur
                cur = nxt.get(cur, -1)
        else:
            yield from self._order.get(sk, ())

    def iter_order_reversed(self, sk: int):
        if sk in self._linked:
            prv = self._lnk_prev
            cur = self._lnk_tail.get(sk, -1)
            while cur != -1:
                yield cur
                cur = prv.get(cur, -1)
        else:
            yield from reversed(self._order.get(sk, ()))

    def iter_order_after(self, sk: int, row: int):
        """Forward document-order iteration starting AFTER ``row``
        (O(1) per step on linked segments; empty when the row is
        unknown to the cached order)."""
        if sk in self._linked:
            nxt = self._lnk_next
            cur = nxt.get(row, -1)
            while cur != -1:
                yield cur
                cur = nxt.get(cur, -1)
        else:
            pos = self.order_position(sk, row)
            if pos is None:
                return
            lst = self._order.get(sk, [])
            for i in range(pos + 1, len(lst)):
                yield lst[i]

    def iter_order_before(self, sk: int, row: int):
        """Reverse document-order iteration starting BEFORE ``row``."""
        if sk in self._linked:
            prv = self._lnk_prev
            cur = prv.get(row, -1)
            while cur != -1:
                yield cur
                cur = prv.get(cur, -1)
        else:
            pos = self.order_position(sk, row)
            if pos is None:
                return
            lst = self._order.get(sk, [])
            for i in range(pos - 1, -1, -1):
                yield lst[i]

    def order_next_row(self, sk: int, row: int) -> Optional[int]:
        """The row immediately after ``row`` in full document order
        (None at the tail / when the row is unknown)."""
        if sk in self._linked:
            n = self._lnk_next.get(row, -1)
            return None if n == -1 else n
        rows = self._order.get(sk, [])
        i = self.order_position(sk, row)
        if i is None or i + 1 >= len(rows):
            return None
        return rows[i + 1]

    def _build_links(self, sk: int, n_new: int) -> bool:
        """Thread the linked chain through the current (fresh) order.
        False when the order does not account for every admitted row
        except the ``n_new`` incoming ones — callers then re-derive."""
        order = self._order.get(sk, [])
        if len(order) + n_new != len(self._seg_rows[sk]):
            return False
        nxt, prv = self._lnk_next, self._lnk_prev
        prev = -1
        for r in order:
            if prev == -1:
                self._lnk_head[sk] = r
            else:
                nxt[prev] = r
            prv[r] = prev
            prev = r
        if prev != -1:
            nxt[prev] = -1
            self._lnk_tail[sk] = prev
        self._linked.add(sk)
        return True

    def _drop_links(self, sk: int) -> None:
        if sk not in self._linked:
            return
        nxt, prv = self._lnk_next, self._lnk_prev
        cur = self._lnk_head.pop(sk, -1)
        while cur != -1:
            nn = nxt.pop(cur, -1)
            prv.pop(cur, None)
            cur = nn
        self._lnk_tail.pop(sk, None)
        self._linked.discard(sk)
        self._order_stale.discard(sk)

    def _link_splice(self, sk: int, row: int, left: Optional[int]) -> None:
        """Insert ``row`` immediately after ``left`` (None = head)."""
        nxt, prv = self._lnk_next, self._lnk_prev
        if left is None:
            n = self._lnk_head.get(sk, -1)
            self._lnk_head[sk] = row
            prv[row] = -1
        else:
            n = nxt.get(left, -1)
            nxt[left] = row
            prv[row] = left
        nxt[row] = n
        if n != -1:
            # a TAIL append leaves every existing position and
            # visibility intact — only non-tail splices invalidate
            # cached positions (the edit cursor survives append runs)
            self._bump_epoch(sk)
            prv[n] = row
        else:
            self._lnk_tail[sk] = row

    # -- incremental convergence (the steady-state core) --------------
    def _advance_map_tail(self, sk: int, new_rows: List[int]) -> bool:
        """Map delta whose every row chains onto the then-current
        winner: the tail has no children (or it would not be the
        walk's endpoint), so each row becomes the new tail — O(1),
        any client. Anything else returns False for the full walk."""
        c = self.cols
        oc = c.col("oc")
        ock = c.col("ock")
        cl = c.col("client")
        ck = c.col("clock")
        for row in new_rows:
            prev = self._win.get(sk)
            if prev is not None:
                if (
                    int(oc[row]) == int(cl[prev])
                    and int(ock[row]) == int(ck[prev])
                ):
                    self._win[sk] = row
                    continue
                return False
            if (
                int(oc[row]) < 0
                and len(self._seg_rows[sk]) <= len(new_rows)
            ):
                self._win[sk] = row  # first row of a fresh chain
                continue
            return False
        return True

    def _integrate_remote_seq(self, sk: int, new_rows: List[int]) -> bool:
        """Engine-verbatim YATA conflict scan (crdt.js:294 via
        core/engine.py ``_integrate_into_chain``) splicing a delta
        into this segment's linked chain: O(delta x scan window), not
        O(segment). Preconditions — every new row's declared origin
        and right must resolve to a row of THIS segment (or be an
        in-batch new row, handled by deferral) — keep cross-segment /
        GC / dangling-reference shapes on the full path, whose
        dropping conventions differ. Returns False untouched when any
        precondition fails."""
        c = self.cols
        cl = c.col("client")
        oc = c.col("oc")
        ock = c.col("ock")
        rc = c.col("right_client")
        rk = c.col("right_clock")
        newset = set(new_rows)
        resolved: Dict[int, Tuple[Optional[int], Optional[int]]] = {}
        for row in new_rows:
            left, right, left_decl, right_decl = self._anchor_rows(row)
            if left_decl and (
                left is None
                or (left not in newset and self._row_segkey(left) != sk)
            ):
                return False
            if right_decl and (
                right is None
                or (right not in newset and self._row_segkey(right) != sk)
            ):
                return False
            resolved[row] = (left, right)
        if sk not in self._linked and not self._build_links(
            sk, len(new_rows)
        ):
            return False

        nxt = self._lnk_next
        unplaced = set(new_rows)
        queue = list(new_rows)
        # total scan-step budget: the conflict scan walks the window
        # between a row's anchors, and for a COLD multi-writer backlog
        # (anchors thousands of items stale) that degenerates to the
        # scalar engine's quadratic cost — the exact wholesale reorder
        # handles that shape in one vectorized pass instead. Live
        # steady-state rounds never approach the budget (anchors are
        # near-adjacent when deltas are fresh).
        scan_budget = max(4096, 32 * len(new_rows))
        while queue:
            progress = False
            defer = []
            for row in queue:
                left0, right0 = resolved[row]
                if left0 in unplaced or right0 in unplaced:
                    defer.append(row)
                    continue
                x_client = int(cl[row])
                x_right = (int(rc[row]), int(rk[row]))
                left = left0
                o = (
                    nxt.get(left, -1) if left is not None
                    else self._lnk_head.get(sk, -1)
                )
                conflicting: set = set()
                before: set = set()
                while o != -1 and (right0 is None or o != right0):
                    scan_budget -= 1
                    if scan_budget < 0:
                        self._host_order_segment(sk)
                        return True
                    before.add(o)
                    conflicting.add(o)
                    o_oc = int(oc[o])
                    o_origin_row = (
                        self._id_row.get((o_oc, int(ock[o])))
                        if o_oc >= 0 else None
                    )
                    if o_origin_row == left0:
                        # case 1: same left origin -> client id order
                        if int(cl[o]) < x_client:
                            left = o
                            conflicting.clear()
                        elif (int(rc[o]), int(rk[o])) == x_right:
                            break
                    elif (
                        o_origin_row is not None
                        and o_origin_row in before
                    ):
                        # case 2: o's origin inside the scanned region
                        if o_origin_row not in conflicting:
                            left = o
                            conflicting.clear()
                    else:
                        break
                    o = nxt.get(o, -1)
                self._link_splice(sk, row, left)
                unplaced.discard(row)
                progress = True
            if not progress:
                # in-batch reference cycle: the full path's conventions
                # decide (links now hold a prefix; re-derive wholesale)
                self._host_order_segment(sk)
                return True
            queue = defer
        self._order_stale.add(sk)
        return True

    def _seg_spec(self, sk: int) -> Optional[Tuple]:
        rows = self._seg_rows.get(sk)
        return self._spec_of_row(rows[0]) if rows else None

    def _root_of(self, spec) -> Optional[str]:
        if spec is None:
            return None
        if spec in self._spec_root:
            return self._spec_root[spec]
        seen = []
        seen_set = set()
        cur = spec
        root = None
        while cur is not None and cur not in self._spec_root:
            if cur in seen_set:
                break  # hostile parent-item cycle: no root, no memo
            seen.append(cur)
            seen_set.add(cur)
            if cur[0] == "root":
                root = cur[1]
                break
            row = self._id_row.get((cur[1], cur[2]))
            cur = self._spec_of_row(row) if row is not None else None
        else:
            root = self._spec_root.get(cur)
        if root is not None:
            # an unresolvable chain (parent item not delivered yet)
            # must NOT be memoized: the parent may arrive in a later
            # batch, and _admit retries rootless segments then
            for s in seen:
                self._spec_root[s] = root
        return root

    # -- device round -------------------------------------------------
    def _device_round(self, by_seg: Dict[int, List[int]]) -> None:
        touched = set(by_seg)

        # split touched: device-convergeable vs right-bearing (host)
        dev_segs = sorted(
            sk for sk in touched
            if sk in self._seg_rows and not self._seg_rights.get(sk)
        )
        if self._from_snapshot and dev_segs:
            # snapshot-rehydrated engine: the restored winner/order
            # caches are exact, so a tail-shaped delta advances
            # host-side in O(delta) instead of an O(doc) re-splice of
            # the whole column set into a fresh matrix. Rows handled
            # here stay in the unspliced backlog; the first round the
            # fast shapes refuse dispatches them all at once.
            still = []
            for sk in dev_segs:
                new = by_seg.get(sk)
                if new:
                    if self._seg_kid.get(sk, -1) >= 0:
                        if self._advance_map_tail(sk, new):
                            continue
                    elif self._advance_seq_tail(sk, new):
                        continue
                still.append(sk)
            dev_segs = still
        host_segs = [
            sk for sk in touched
            if sk in self._seg_rows and self._seg_rights.get(sk)
        ]
        # host/device crossover: small rounds are exact on host against
        # the resident columns (the fixed per-round device cost
        # dominates below the threshold). Host rounds do ZERO device
        # work — their rows accumulate, and the next device round
        # splices the whole unspliced tail (n_dev marks the boundary:
        # admission appends rows in order, so host row ids and device
        # positions stay identical)
        if dev_segs:
            n_sel = sum(len(self._seg_rows[sk]) for sk in dev_segs)
            thr = self.device_min_rows
            if thr is None:
                go_host = self.crossover_use_host(n_sel, self.device)
            else:
                go_host = n_sel < thr
            if go_host:
                host_segs.extend(dev_segs)
                dev_segs = []

        if dev_segs:
            tpad = _octave(len(dev_segs), floor=1 << 10)

            def _dispatch():
                # EVERY device interaction of the round — client
                # interning (which may relabel the resident matrix),
                # matrix allocation and growth, the splice, the
                # converge and the fetch — runs inside the guarded
                # attempt. The relabel and the splice write into the
                # matrix in place, so an attempt that fails part-way
                # leaves none to trust: it is dropped, and the retry
                # (or the next device round) re-splices every host row
                # into a fresh one.
                try:
                    return self._dispatch_round(dev_segs, tpad, n_sel)
                except BaseException:
                    self._mat = None
                    self.n_dev = 0
                    raise

            # device failure ladder (crdt_tpu_torch/guard): an injected
            # fault retries once, then the WHOLE round routes host-side
            # — host segments converge against the resident columns
            # with zero device work, and the unspliced tail waits for
            # the next healthy device round (the same contract the
            # crossover uses). A kernel error, a CUDA error or an
            # out-of-memory is not caught: it propagates out of apply().
            with get_tracer().span("incremental.dispatch"):
                res = dispatch_guarded(
                    "incremental.converge", _dispatch, host=lambda: None
                )
            if res is None:
                # ladder exhausted: drop the matrix — the next device
                # round re-splices the ENTIRE host column set into a
                # fresh one (n_dev=0)
                self._mat = None
                self.n_dev = 0
                host_segs.extend(dev_segs)
                dev_segs = []
        if dev_segs:
            with get_tracer().span("incremental.readback"):
                self._read_back(res, tpad)
        # host rounds: no device work at all — the unspliced tail
        # waits for the next device round (see the crossover comment).
        # Each segment first tries the INCREMENTAL path (O(delta));
        # shapes outside its preconditions re-derive wholesale.
        with get_tracer().span("incremental.host_order"):
            for sk in host_segs:
                self._host_round_segment(sk, by_seg.get(sk))

    def _read_back(self, res, tpad: int) -> None:
        """A device round's one fetch -> map winners and sequence
        orders of the touched segments."""
        h, sel_bucket, k = res
        pk.count_device_dispatch()
        # advance by the REAL row count: the padded tail is invalid
        # and the next splice overwrites it, keeping device
        # positions identical to host row ids
        self.n_dev += k
        s = tpad
        b = sel_bucket
        win_local = h[:s]
        stream_seg = h[s : s + b]
        stream_row = h[s + b : s + 2 * b]
        sel_rows = h[s + 2 * b : s + 3 * b]
        # map winners: local -> resident row -> segkey
        for w in win_local[win_local >= 0]:
            row = int(sel_rows[w])
            sk = self._row_segkey(row)
            self._win[sk] = row
        # sequence orders: split the stream on segment change
        m = stream_row >= 0
        rows_s, segs_s = stream_row[m], stream_seg[m]
        if len(rows_s):
            res_rows = sel_rows[rows_s]
            cuts = np.r_[
                0, np.flatnonzero(segs_s[1:] != segs_s[:-1]) + 1,
                len(segs_s),
            ]
            for a, bnd in zip(cuts[:-1], cuts[1:]):
                chunk = res_rows[a:bnd].tolist()
                self._set_order(self._row_segkey(chunk[0]), chunk)

    def _host_round_segment(self, sk: int, new: Optional[List[int]]) -> None:
        """One segment of a host round: the INCREMENTAL path first
        (O(delta)), the exact whole-segment machinery otherwise."""
        if new:
            if self._seg_kid.get(sk, -1) >= 0:
                if self._advance_map_tail(sk, new):
                    return
            else:
                existing = len(self._seg_rows[sk]) - len(new)
                # bulk deltas (cold merge, long catch-up) have anchors
                # stale by construction: the budgeted conflict scan
                # would exhaust its whole budget and THEN re-derive.
                # When the delta rivals the resident segment, re-derive
                # directly.
                if len(new) <= max(256, existing // 2) and \
                        self._integrate_remote_seq(sk, new):
                    return
        self._host_order_segment(sk)

    def _dispatch_round(self, dev_segs: List[int], tpad: int,
                        n_sel: int) -> Tuple[np.ndarray, int, int]:
        """One device round's device work: stage the UNSPLICED TAIL
        (this batch + any rows host rounds left behind) as one packed
        ``[8, kpad]`` block whose row 7 carries the touched-segment
        keys, then ONE upload, one launch sequence and ONE fetch.
        Returns (the fetched packed result, sel_bucket, rows spliced)."""
        rows = np.arange(self.n_dev, self.cols.n)
        k = len(rows)
        kpad = max(_octave(k, floor=1 << 6), tpad)
        cl_raw = self.cols.col("client")[rows]
        oc_raw = self.cols.col("oc")[rows]
        self._intern_clients(np.concatenate([cl_raw, oc_raw[oc_raw >= 0]]))
        # rows without a resolvable parent (incl. GC fillers) stay
        # invalid on the device — origin lookups that miss them fall
        # back to root attachment, the cold path's convention
        delta = pk.stage_resident_delta(
            self._dense_of(cl_raw),
            self.cols.col("clock")[rows],
            self.cols.col("pref")[rows],
            self.cols.col("kid")[rows],
            np.where(oc_raw >= 0, self._dense_of(
                np.clip(oc_raw, self._clients[0] if self._clients else 0,
                        None)
            ), -1),
            self.cols.col("ock")[rows],
            dev_segs, kpad,
        )
        mat = self._ensure_mat()
        need = self.n_dev + kpad
        if need > mat.shape[1]:
            mat = self._mat = pk._grow_mat(mat, new_cap=bucket_pow2(need))
        sel_bucket = min(_octave(n_sel, floor=1 << 13), mat.shape[1])
        # the round's ONE upload: the delta block only — the resident
        # matrix is updated in place, so steady-state bytes on the link
        # scale with the delta, never the doc (xfer.h2d_bytes)
        packed_out = pk._splice_select_converge(
            mat, xfer_put(delta, device=self.device,
                          label="incremental.delta"),
            self.n_dev,
            num_segments=tpad, sel_bucket=sel_bucket, seq_bucket=sel_bucket,
            # rounds stay at the sel_bucket bound (None, the early-exit
            # loops): the splice numbers segments ON THE DEVICE, and
            # rows whose origins are still in flight root-attach there,
            # so device segment populations can exceed any host-side
            # count
            rank_rounds=None, map_rounds=None,
        )
        # the round's ONE fetch
        return xfer_fetch(packed_out, label="incremental.out"), sel_bucket, k

    def _host_order_segment(self, sk: int) -> None:
        """Exact ordering for one right-bearing segment via the host
        machinery (same split as the cold gather), on the CPU."""
        rows = self._seg_rows[sk]
        if not self._seg_rights.get(sk):
            # right-free segment on the host path (below the device
            # crossover): the exact sibling model — (client asc,
            # clock DESC) under origin trees — in plain Python, with
            # no kernel dispatch and no throwaway engine. This is the
            # keystroke path: a replica's own op or a peer's small
            # delta costs O(segment), not a device round-trip.
            self._host_order_fast(sk, rows)
            return
        if self._seg_kid.get(sk, -1) >= 0:
            # right-bearing MAP chain: exact tail via chain order
            recs = [self._record_of(r, parent_root="x") for r in rows]
            ordered = order_hard_segment(
                recs, ref_exists=lambda ref: ref in self._id_row
            )
            if ordered:
                self._win[sk] = self._id_row[ordered[-1]]
            return
        spec = self._seg_spec(sk)
        recs = [self._record_of(r) for r in rows]
        sub_ids = {r.id for r in recs}
        stubs = {
            ref
            for r in recs
            for ref in (r.origin, r.right)
            if ref is not None and ref not in sub_ids
            and ref in self._id_row
        }
        recs += [ItemRecord(client=c, clock=k, kind=K_GC) for c, k in stubs]
        orders = order_sequences(recs, device="cpu")
        ids = orders.get(
            spec if spec[0] == "root" else ("item", spec[1], spec[2]), []
        )
        self._set_order(sk, [self._id_row[i] for i in ids])

    def _host_order_fast(self, sk: int, rows: List[int]) -> None:
        """Exact convergence of one RIGHT-FREE segment in plain
        Python: origins resolved within the segment form the tree
        (missing/cross-segment origins attach to the root, the shared
        GC'd-origin convention), siblings order by (client asc, clock
        DESC). Maps take the last-child walk to the chain tail
        (= ``map_winners``); sequences take the DFS pre-order
        (= ``tree_order_ranks`` with the same keys)."""
        c = self.cols
        cl = c.col("client")
        ck = c.col("clock")
        oc = c.col("oc")
        ock = c.col("ock")
        rowset = set(rows)

        def parent_of(r: int):
            o = int(oc[r])
            if o < 0:
                return None
            p = self._id_row.get((o, int(ock[r])))
            return p if p is not None and p in rowset else None

        children: Dict[Optional[int], list] = {}
        for r in rows:
            children.setdefault(parent_of(r), []).append(r)

        if self._seg_kid.get(sk, -1) >= 0:
            # chain tail: repeatedly step to the (max client, min
            # clock) child
            cur: Optional[int] = None
            while True:
                kids = children.get(cur)
                if not kids:
                    break
                cur = max(kids, key=lambda r: (int(cl[r]), -int(ck[r])))
            if cur is not None:
                self._win[sk] = cur
            return
        # sequence DFS pre-order with the sibling key
        for kids in children.values():
            kids.sort(key=lambda r: (int(cl[r]), -int(ck[r])))
        out: List[int] = []
        stack = list(reversed(children.get(None, [])))
        while stack:
            r = stack.pop()
            out.append(r)
            kids = children.get(r)
            if kids:
                stack.extend(reversed(kids))
        # every row sits in exactly one children list, so the DFS
        # visits each reachable row once. Admission leaves pref < 0 on
        # origin-cycle members (they never reach _seg_rows), so
        # normally nothing is unreachable — but if that invariant ever
        # bends, rank the leftovers at the tail DETERMINISTICALLY by
        # (client, clock) — arbitrary residual order could silently
        # diverge from a device-round replica in the same swarm
        # — and log that the invariant bent
        if len(out) != len(rows):
            import logging

            emitted = set(out)
            leftovers = sorted(
                (r for r in rows if r not in emitted),
                key=lambda r: (int(cl[r]), int(ck[r])),
            )
            logging.getLogger(__name__).warning(
                "host-order fast path: %d unreachable rows in segment "
                "%d ranked at tail by (client, clock) — cyclic-origin "
                "admission invariant bent", len(leftovers), sk,
            )
            out.extend(leftovers)
        self._set_order(sk, out)

    def _record_of(self, row: int, parent_root: Optional[str] = None):
        c = self.cols
        spec = self._spec_of_row(row)
        oc = int(c.col("oc")[row])
        rc = int(c.col("right_client")[row])
        return ItemRecord(
            client=int(c.col("client")[row]),
            clock=int(c.col("clock")[row]),
            parent_root=(
                parent_root if parent_root is not None
                else (spec[1] if spec and spec[0] == "root" else None)
            ),
            parent_item=(
                (spec[1], spec[2])
                if parent_root is None and spec and spec[0] == "item"
                else None
            ),
            key=(
                None if int(c.col("kid")[row]) < 0
                else self._key_names[int(c.col("kid")[row])]
            ),
            origin=(oc, int(c.col("ock")[row])) if oc >= 0 else None,
            right=(rc, int(c.col("right_clock")[row])) if rc >= 0 else None,
            kind=int(c.col("kind")[row]),
            type_ref=int(c.col("type_ref")[row]),
            content=c.contents[row],
        )

    # -- sync protocol surface ----------------------------------------
    # The live replica answers ready probes, anti-entropy deficits, and
    # compaction FROM THIS RESIDENT STATE — the scalar engine is never
    # materialized. Semantics mirror Engine exactly:
    # the state vector is the contiguous admitted watermark, diffs
    # carry rows above the requester's watermark plus the full delete
    # set, and _pending rows are excluded (they are not integrated
    # state; the protocol re-supplies them). Match: crdt.js:288,294.

    def state_vector(self) -> StateVector:
        return StateVector(dict(self._next_clock))

    def records_since(self, sv=None) -> List:
        """Records with clock >= sv[client] (full state when None),
        O(deficit) via the id-row index — admitted runs are contiguous
        per client by the admission rule."""
        if sv is None:
            return [self._record_of(r) for r in range(self.cols.n)]
        out = []
        for client, nxt in self._next_clock.items():
            wm = sv.get(int(client))
            for ck in range(wm, nxt):
                row = self._id_row.get((int(client), ck))
                if row is not None:
                    out.append(self._record_of(row))
        return out

    def to_decoded_columns(self) -> Dict:
        """The full resident union in the decode column schema
        (client-grouped, clock-ascending — the wire's run order), the
        seam for the native ``encode_from_columns`` snapshot path:
        compaction of a resident doc never walks a scalar engine.
        Match: crdt.js:79-98 (what compaction replaces)."""
        c = self.cols
        n = c.n
        order = np.lexsort((c.col("clock"), c.col("client")))
        roots: List[str] = []
        root_idx: Dict[str, int] = {}
        pr = np.full(n, -1, np.int64)
        pc = np.full(n, -1, np.int64)
        pk_ = np.full(n, -1, np.int64)
        pref_col = c.col("pref")
        # pref -> (root index | item id) tables, then one gather
        n_pref = len(self._pref_spec)
        t_root = np.full(n_pref + 1, -1, np.int64)
        t_pc = np.full(n_pref + 1, -1, np.int64)
        t_pk = np.full(n_pref + 1, -1, np.int64)
        for ref, spec in enumerate(self._pref_spec):
            if spec[0] == "root":
                ix = root_idx.get(spec[1])
                if ix is None:
                    ix = root_idx[spec[1]] = len(roots)
                    roots.append(spec[1])
                t_root[ref] = ix
            else:
                t_pc[ref] = spec[1]
                t_pk[ref] = spec[2]
        has = pref_col >= 0
        pr[has] = t_root[pref_col[has]]
        pc[has] = t_pc[pref_col[has]]
        pk_[has] = t_pk[pref_col[has]]
        return {
            "client": c.col("client")[order],
            "clock": c.col("clock")[order],
            "parent_root": pr[order].astype(np.int32),
            "parent_client": pc[order],
            "parent_clock": pk_[order],
            "key_id": c.col("kid")[order].astype(np.int32),
            "origin_client": c.col("oc")[order],
            "origin_clock": c.col("ock")[order],
            "right_client": c.col("right_client")[order],
            "right_clock": c.col("right_clock")[order],
            "kind": c.col("kind")[order].astype(np.int32),
            "type_ref": c.col("type_ref")[order].astype(np.int32),
            "contents": [c.contents[int(r)] for r in order],
            "roots": roots,
            "keys": list(self._key_names),
            "ds": native.ds_to_triples(self.ds),
        }

    def encode_state_as_update(self, sv=None) -> bytes:
        """Diff (or full-state when ``sv`` is None) v1 blob from the
        resident columns. Deficit-sized diffs go through the record
        path (O(deficit)); full state goes through the native
        column encoder in one C pass when the toolchain allows."""
        if sv is None:
            return native.encode_from_columns_any(
                self.to_decoded_columns(), self.ds
            )
        return v1.encode_update(self.records_since(sv), self.ds)

    def _top_key_of_seg(self, sk: int) -> Optional[str]:
        """Top-level map key holding this segment's subtree (None for
        direct sequence members of a root array) — the per-key
        observer rollup the engine-backed doc computes via
        ``Crdt._classify_row``."""
        spec = self._seg_spec(sk)
        seen = set()
        kid = self._seg_kid.get(sk, -1)
        while spec is not None and spec not in seen:
            seen.add(spec)
            if spec[0] == "root":
                return self._key_names[kid] if kid >= 0 else None
            row = self._id_row.get((spec[1], spec[2]))
            if row is None:
                return None
            kid = int(self.cols.col("kid")[row])
            spec = self._spec_of_row(row)
        return None

    # -- cache --------------------------------------------------------
    def _touch_bookkeeping(self, touched: set) -> None:
        """Observer bookkeeping for a round's touched segments —
        separated from cache materialization so rounds can stay lazy."""
        t_roots: set = set()
        t_keys: Dict[str, set] = {}
        for sk in touched:
            # a touched segment may have changed order OR visibility
            # (delete ranges land here too): position caches must drop
            self._bump_epoch(sk)
            if sk not in self._seg_rows:
                continue
            root = self._root_of(self._seg_spec(sk))
            if root is None:
                continue
            t_roots.add(root)
            key = self._top_key_of_seg(sk)
            if key is not None:
                t_keys.setdefault(root, set()).add(key)
        self.last_touched_roots = sorted(t_roots)
        self.last_touched_keys = t_keys

    def _rebuild_cache(self, touched: set) -> None:
        # root-level map keys patch IN PLACE (a delta touching a few
        # hundred keys of a 25k-key map must not pay a full-collection
        # python rebuild); sequences, nested collections, and roots
        # not yet materialized rebuild whole
        full_roots: set = set()
        patches: List[Tuple[str, int]] = []
        for sk in touched:
            if sk not in self._seg_rows:
                continue
            spec = self._seg_spec(sk)
            root = self._root_of(spec)
            if root is None or root == "ix":
                continue
            if (
                spec == ("root", root)
                and self._seg_kid.get(sk, -1) >= 0
                and isinstance(self._cache.get(root), dict)
            ):
                patches.append((root, sk))
            else:
                full_roots.add(root)
        patches = [(r, sk) for r, sk in patches if r not in full_roots]

        # vectorized visibility for every ordered sequence row of the
        # fully-rebuilt roots (the per-row DeleteSet walk dominates
        # python rebuild time otherwise)
        seq_rows = sorted({
            r
            for root in full_roots
            for sk in self._root_segs.get(root, ())
            for r in self.order_list(sk)
        })
        self._vis = dict(zip(seq_rows, self._visible(seq_rows)))
        for root in full_roots:
            built = self._build_collection_root(root)
            if built == {}:
                # the cold materialize surfaces a map root only while
                # it has a visible winner (ix-registered empties come
                # back through the ix pass below)
                self._cache.pop(root, None)
            else:
                self._cache[root] = built

        c = self.cols
        maybe_empty: set = set()
        for root, sk in patches:
            key = self._key_names[self._seg_kid[sk]]
            tgt = self._cache.setdefault(root, {})
            row = self._win.get(sk)
            if row is None or self.ds.contains(
                int(c.col("client")[row]), int(c.col("clock")[row])
            ):
                tgt.pop(key, None)
                maybe_empty.add(root)  # pop AFTER all patches applied
                continue
            if c.col("kind")[row] == K_TYPE:
                sub = ("item", int(c.col("client")[row]),
                       int(c.col("clock")[row]))
                tgt[key] = self._build_collection(
                    sub, c.col("type_ref")[row] == TYPE_MAP,
                    self._root_segs.get(root, set()), 1,
                )
            else:
                tgt[key] = c.contents[row]
        for root in maybe_empty:
            if self._cache.get(root) == {}:
                self._cache.pop(root, None)  # same rule as above
        # ix-registered collections with no visible content still
        # materialize (empty), exactly like the cold materialize
        for sk in self._root_segs.get("ix", ()):
            row = self._win.get(sk)
            if row is None:
                continue
            name = self._key_names[int(self.cols.col("kid")[row])]
            if name not in self._cache and name != "ix":
                self._cache[name] = (
                    [] if self.cols.contents[row] == "array" else {}
                )

    def _ds_ranges(self):
        """Packed (client, start, end) arrays over the accumulated
        delete set — O(ranges), rebuilt only after a ds mutation."""
        if self._ds_pack is None:
            trip = list(self.ds.iter_all())
            self._ds_pack = (
                np.asarray([c for c, _, _ in trip], np.int64),
                np.asarray([s for _, s, _ in trip], np.int64),
                np.asarray([s + n for _, s, n in trip], np.int64),
            )
        return self._ds_pack

    def _visible(self, rows: List[int]) -> List[bool]:
        if not rows:
            return []
        idx = np.asarray(rows)
        del_c, del_s, del_e = self._ds_ranges()
        return list(rows_visible(
            self.cols.col("client")[idx],
            self.cols.col("clock")[idx],
            del_c,
            del_s,
            del_e,
        ))

    def _build_collection_root(self, root: str):
        spec = ("root", root)
        segs = self._root_segs.get(root, set())
        has_map = any(
            self._seg_spec(sk) == spec and self._seg_kid[sk] >= 0
            for sk in segs
        )
        return self._build_collection(spec, has_map, segs, 0)

    def _build_collection(self, spec, is_map: bool, segs, depth: int):
        if depth > 64:
            return None
        c = self.cols

        def value_of(row):
            if c.col("kind")[row] == K_TYPE:
                sub = ("item", int(c.col("client")[row]),
                       int(c.col("clock")[row]))
                return self._build_collection(
                    sub, c.col("type_ref")[row] == TYPE_MAP, segs,
                    depth + 1,
                )
            return c.contents[row]

        if is_map:
            out = {}
            for sk in segs:
                if self._seg_spec(sk) != spec or self._seg_kid[sk] < 0:
                    continue
                row = self._win.get(sk)
                if row is None:
                    continue
                if self.ds.contains(
                    int(c.col("client")[row]), int(c.col("clock")[row])
                ):
                    continue
                out[self._key_names[self._seg_kid[sk]]] = value_of(row)
            return out
        def vis(r):
            if r in self._vis:
                return self._vis[r]
            return not self.ds.contains(
                int(c.col("client")[r]), int(c.col("clock")[r])
            )

        for sk in segs:
            if self._seg_spec(sk) == spec and self._seg_kid[sk] < 0:
                return [
                    value_of(r)
                    for r in self.order_list(sk)
                    if vis(r)
                ]
        return []
