"""Multi-tenant batched serving: one converge dispatch for many docs,
and delta-cost ticks for the docs the server already holds.

The port's counterpart of ``crdt_tpu.models.multidoc``, on ``device``
(the card unless the caller asks for the CPU). Every converge dispatch
pays a fixed launch-and-fetch floor, so a server hosting thousands of
SMALL independent docs pays almost pure overhead when each doc
converges in its own dispatch. This module amortizes the floor by
packing many docs' histories into ONE fused converge per tick, and
makes the STEADY STATE — a small delta landing on a large doc the
server already converged — cost a delta, not a cold replay.

``shards=`` (above 1) sends a big enough cold batch down the sharded
route (:mod:`crdt_tpu_torch.ops.shard`): whole docs partitioned over
the entries of a mesh of ``device``'s type, one launch sequence an
entry, per-doc outputs unchanged. On a pod of processes (a
``torch.distributed`` group) every process runs a server on the same
tenants and ticks, and a sharded cold batch spans the pod: each process
converges its own entries' docs and every server ends the tick with
the same digests.

The cold engine is the round-14 staging tentpole: doc-id is a
first-class segment column in :mod:`crdt_tpu_torch.ops.packed` (client ids
fold into doc-composite ids, parent refs intern doc-major), so a whole
tenant batch converges in one program with per-doc outputs
byte-identical to each doc converged alone (tests/test_torch_multidoc.py
pins {2, 3, 17} docs with mixed LWW/YATA ops, deletes, and empty docs
against the reference server).

The warm engine is the round-15 tentpole — **delta ticks**: each doc
the server keeps serving holds RESIDENT state across ticks (an
:class:`crdt_tpu_torch.models.incremental.IncrementalReplay`: device-side
converged matrix above the crossover, host winner/order caches always)
and a dirty doc whose new ops are **SV-admissible** to the incremental
route (per-client clocks contiguous with the resident state vector,
every origin/right/parent ref resolvable — the engine's own admission
gate, probed read-only by :meth:`IncrementalReplay.delta_admissible`)
stages ONLY its delta: the host path splices winners/orders in
O(delta), the device path ships the delta block against the resident
matrix (:func:`crdt_tpu_torch.ops.packed.stage_resident_delta` +
``_splice_select_converge`` — history never restages). Anything else
falls back PER DOC to the stock cold replay through the round-14
packed batch: offset clocks (a gap the cold oracle would admit but the
engine would stash), an evicted resident, first sight. Fallbacks are
conservative — they cost a cold replay, never bytes — and the two
routes are digest-identical by construction (differential-pinned).

Resident memory is bounded: :class:`crdt_tpu_torch.guard.tenant.
ResidentBudget` (``CRDT_TPU_MT_RESIDENT_BYTES``) ledgers each doc's
resident bytes; overflow evicts the least-recently-served docs'
resident state back to cold replay (``tenant.resident_evictions``),
enforced at every commit so the ledger never exceeds the budget —
evicted docs reconverge byte-identically on their next touch.

Serving discipline per tick:

- **submit** — per-tenant admission queues under the
  :class:`crdt_tpu_torch.guard.tenant.TenantBudget` byte/count budget:
  a flooding tenant's own backlog is trimmed oldest-first
  (keep-the-newest), other tenants' queues and converged bytes are
  untouched (the round-10 "degrade, don't die" rule, tenant-scoped).
- **prepare** — the ingest-side work runs per doc OFF the tick:
  resident docs decode only their PENDING delta (plus the
  admissibility probe); cold docs decode their full history and
  stage kernel columns as before. ``tick()`` prepares any stale doc
  itself, so calling ``prepare()`` is an optimization, never a
  correctness requirement.
- **tick** — dirty docs order least-recently-served-first
  (:func:`crdt_tpu_torch.guard.tenant.fair_order`) and route: admissible
  deltas splice into their resident engines (zero dispatches below
  the host/device crossover); docs served before but not resident
  PROMOTE (one engine build over the full history, budget
  permitting — the one-time warm cost that buys every later delta
  tick); the rest bin-pack into the round-14 cold dispatch batches
  (``max_rows_per_dispatch``, double-buffered async dispatches,
  vectorized unpack with the stock gather as exact fallback).
- **serve** — the live-ingest scheduler (round 15): a bounded tick
  loop over a STREAM of updates whose ingest hook drains the next
  batches while a tick's converge dispatches are in flight, so
  steady-state throughput is bounded by delta size, not doc size.

Per-doc digests are canonical (dict keys sorted at every depth — the
delta route builds map dicts in integration order, the cold
materialize in winner order) and LAZY: converging never digests;
:meth:`MultiDocServer.digest` / :meth:`doc_digests` compute on read
and cache per (op count, serve tick), so a beacon over a mostly-clean
doc population costs digest work only for the docs that moved
(``sentinel.doc_digest_skips``). They feed the multi-doc divergence
sentinel (:class:`crdt_tpu_torch.obs.sentinel.MultiDocSentinel`), which
attributes a fork to the ONE doc that diverged.

Evidence: ``converge.docs_packed`` (docs per staged plan, counted at
the staging seam), ``tenant.*`` counters/gauges (README
"Observability" registry — round 15 adds ``tenant.delta_docs`` /
``delta_rows`` / ``promotions`` / ``delta_fallbacks`` /
``resident_evictions`` and the ``tenant.resident_bytes`` /
``resident_docs`` gauges), and the ``bench.py --multitenant`` legs:
round-14 packing (``docs_converged_per_s`` vs the one-dispatch-per-doc
baseline) plus the round-15 steady-state leg (N ticks of small deltas
on large resident docs vs the full-replay tick, ``steady.speedup``),
both digest-asserted against the cold oracle and regression-gated in
``tools/metrics_diff.py``.

Observability v2 (round 18): every admitted blob is SLO-stamped at
submit; the settle path closes its ingest-to-converged clock and the
tick end its ingest-to-served clock into the per-tenant ledger at
:attr:`MultiDocServer.slo` (:class:`crdt_tpu_torch.obs.slo.SLOLedger` —
breach counters against ``slo_ms=`` / ``CRDT_TPU_SLO_MS``, burn-rate
gauges, delta/cold/fallback/shed route mix; a shed blob is a breach
by definition). Each tick also records its phase intervals and
dispatch in-flight windows into the process-global tick timeline
(:mod:`crdt_tpu_torch.obs.timeline` — per-tick ``overlap_efficiency`` /
``stall_ms``, Perfetto export).

Env knobs: ``CRDT_TPU_MT_MAX_ROWS`` (dispatch row cap, default
2^16), ``CRDT_TPU_MT_PENDING_BYTES`` / ``CRDT_TPU_MT_PENDING_UPDATES``
(per-tenant admission budget defaults), ``CRDT_TPU_MT_RESIDENT_BYTES``
(resident-state budget; unset = unbounded), ``CRDT_TPU_MT_DELTA_TICKS``
(``0`` pins every tick to the round-14 full-replay path),
``CRDT_TPU_SLO_MS`` (ingest-to-served objective, default 250).
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from collections import deque
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np

from crdt_tpu_torch.guard.tenant import (
    ResidentBudget,
    TenantBudget,
    fair_order,
    pack_batches,
)
from crdt_tpu_torch.models import replay as rp
from crdt_tpu_torch.models.incremental import IncrementalReplay
from crdt_tpu_torch.obs.slo import SLOLedger
from crdt_tpu_torch.obs.timeline import get_timeline
from crdt_tpu_torch.obs.tracer import get_tracer
from crdt_tpu_torch.ops import packed, staging
from crdt_tpu_torch.ops import shard as shard_ops
from crdt_tpu_torch.ops.device import resolve_device

_MAX_ROWS_ENV = "CRDT_TPU_MT_MAX_ROWS"
_PENDING_BYTES_ENV = "CRDT_TPU_MT_PENDING_BYTES"
_PENDING_UPDATES_ENV = "CRDT_TPU_MT_PENDING_UPDATES"
_RESIDENT_BYTES_ENV = "CRDT_TPU_MT_RESIDENT_BYTES"
_DELTA_TICKS_ENV = "CRDT_TPU_MT_DELTA_TICKS"
_POOL_BYTES_ENV = "CRDT_TPU_MT_POOL_BYTES"


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "")
    if raw == "":
        return default
    try:
        return max(1, int(raw))
    except ValueError:
        return default


def _canon(v, out: List[str]) -> None:
    if isinstance(v, dict):
        out.append("{")
        for k in sorted(v, key=str):
            out.append("%r:" % (k,))
            _canon(v[k], out)
            out.append(",")
        out.append("}")
    elif isinstance(v, (list, tuple)):
        # sequences of plain scalars (the overwhelming cache shape —
        # a 100k-element text stream) repr whole at C speed; only a
        # sequence that can reach a dict needs per-element recursion
        # for the key sort
        if not any(isinstance(x, (dict, list, tuple)) for x in v):
            out.append(repr(list(v) if isinstance(v, tuple) else v))
            return
        out.append("[")
        for x in v:
            _canon(x, out)
            out.append(",")
        out.append("]")
    else:
        out.append(repr(v))


def cache_digest(cache: dict) -> str:
    """Canonical digest of a converged cache: dict keys sorted at
    EVERY depth, sequence order preserved. Round 15 made the
    canonicalization recursive — the delta route's incremental
    engine builds its map dicts in integration order while the cold
    materialize builds them in winner order, and equal converged
    STATES must digest equal regardless of which route produced
    them. Document order (lists) is itself the converged output, so
    it stays order-sensitive."""
    out: List[str] = []
    _canon(cache, out)
    return hashlib.sha1("".join(out).encode()).hexdigest()[:16]


def _fast_unpack_ok(dec) -> bool:
    """May this doc take the vectorized unpack? Only the plain shape
    the tight cache build reproduces bit-for-bit: every row a
    root-parented content row (JSON/binary/string/any), no right
    origins, no reserved ``ix`` index root. Everything else routes
    through the stock replay gather/materialize."""
    from crdt_tpu_torch.core.store import K_ANY, K_BINARY, K_JSON, K_STRING

    kind = np.asarray(dec["kind"])
    if len(kind) == 0:
        return True
    if not np.isin(kind, (K_JSON, K_BINARY, K_STRING, K_ANY)).all():
        return False
    if (np.asarray(dec["right_client"]) >= 0).any():
        return False
    if not (np.asarray(dec["parent_root"]) >= 0).all():
        return False
    return "ix" not in dec["roots"]


class _DocState:
    __slots__ = ("blobs", "pending", "in_flight", "cache", "n_ops",
                 "dirty_since", "latency_s", "served_tick",
                 "dec", "cols", "ds", "fast_ok", "stale",
                 "resident", "delta_dec", "delta_ok", "no_promote_len",
                 "pending_ts", "in_flight_ts",
                 "_digest", "_digest_key")

    def __init__(self):
        self.blobs: List[bytes] = []      # admitted, converged history
        self.pending: deque = deque()     # admitted, awaiting prepare
        # SLO stamps (round 18): one submit timestamp per pending /
        # in-flight blob, moved in lockstep with the blob queues so
        # the settle path can close each blob's ingest-to-converged
        # clock and the tick end its ingest-to-served clock
        self.pending_ts: deque = deque()
        self.in_flight_ts: List[float] = []
        # admitted blobs a prepared decode COVERS, still unconverged.
        # Live ingest (the serve() hook) can append to ``pending``
        # while this tick's dispatches are in flight; settle moves
        # exactly ``in_flight`` into history, so a mid-tick arrival
        # can never be marked converged without being converged.
        self.in_flight: List[bytes] = []
        self.cache: dict = {}
        self.n_ops: int = 0
        self.dirty_since: Optional[float] = None
        self.latency_s: Optional[float] = None
        self.served_tick: int = -1
        self.dec = None                   # prepared decode (full history)
        self.cols = None                  # prepared kernel columns
        self.ds = None                    # prepared delete set
        self.fast_ok = False
        self.stale = True                 # prepared state out of date
        # round 15: the delta-tick route
        self.resident: Optional[IncrementalReplay] = None
        self.delta_dec = None             # prepared PENDING-only decode
        self.delta_ok = False             # delta admissible this tick
        # history length (blob count) at which the engine last
        # refused this doc (stash leftovers / an inadmissible delta):
        # promotion retries only once the history has GROWN past it —
        # a later delta may fill the clock gap, so the pin is not
        # permanent, but an unchanged history is never re-attempted
        self.no_promote_len = -1
        self._digest: Optional[str] = None
        self._digest_key = None

    def history_len(self) -> int:
        return len(self.blobs) + len(self.in_flight) + \
            len(self.pending)


class TickReport(NamedTuple):
    docs: int              # docs converged this tick
    dispatches: int        # converge dispatches issued
    rows: int              # total staged rows (cold history + deltas)
    fallback_docs: int     # docs that fell back to per-doc dispatch
    batches: tuple = ()    # docs per dispatch, in dispatch order
    delta_docs: int = 0    # docs served via the resident delta route
    delta_rows: int = 0    # delta rows those docs staged (their whole
    #                        staging cost — history stayed resident)
    promotions: int = 0    # docs promoted to resident this tick
    pool_dispatches: int = 0  # pooled flush dispatches (round 20:
    #                           0 or 1 — every warm doc's device-route
    #                           delta batched into one converge)


class ServeReport(NamedTuple):
    ticks: int
    docs: int              # doc-serves summed over all ticks
    delta_docs: int
    cold_docs: int         # cold-replay serves (incl. promotions)
    promotions: int
    dispatches: int
    submitted: int         # updates admitted from the source


class MultiDocServer:
    """Tick-batched multi-tenant converge server (see module doc).

    A tick serves each dirty doc by the cheapest EXACT route: an
    SV-admissible delta splices into the doc's resident incremental
    engine (delta-cost — the steady state); otherwise the doc
    re-converges its full admitted history through the round-14
    packed cold path (the same replay semantics every differential
    suite oracles against), so per-doc outputs are always exactly
    what ``replay_trace`` of the same blobs yields.
    ``delta_ticks=False`` (or ``pack_docs=False`` for the
    one-dispatch-per-doc shape) degrades to the stock full-replay
    tick — the baselines the bench legs measure against.

    Everything the server converges — cold batches, resident engines,
    the pooled matrix, rehydrated snapshots — lives on ``device``,
    resolved at construction (no card: it raises there)."""

    def __init__(self, *, max_rows_per_dispatch: Optional[int] = None,
                 tenant_max_pending_bytes: Optional[int] = None,
                 tenant_max_pending_updates: Optional[int] = None,
                 shards: Optional[int] = None,
                 pack_docs: bool = True,
                 delta_ticks: Optional[bool] = None,
                 resident_max_bytes: Optional[int] = None,
                 slo_ms: Optional[float] = None,
                 pool: Optional[bool] = None,
                 pool_max_bytes: Optional[int] = None,
                 snap_store=None,
                 control=None,
                 checkpoint_every_ticks: Optional[int] = None,
                 checkpoint_every_bytes: Optional[int] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.max_rows = (max_rows_per_dispatch
                         if max_rows_per_dispatch is not None
                         else _env_int(_MAX_ROWS_ENV, 1 << 16))
        self.budget = TenantBudget(
            max_bytes=(tenant_max_pending_bytes
                       if tenant_max_pending_bytes is not None
                       else _env_int(_PENDING_BYTES_ENV, 1 << 22)),
            max_updates=(tenant_max_pending_updates
                         if tenant_max_pending_updates is not None
                         else _env_int(_PENDING_UPDATES_ENV, 4096)),
        )
        if delta_ticks is None:
            delta_ticks = os.environ.get(_DELTA_TICKS_ENV, "1") != "0"
        self.delta_ticks = bool(delta_ticks)
        if resident_max_bytes is None:
            env = os.environ.get(_RESIDENT_BYTES_ENV, "")
            resident_max_bytes = int(env) if env else None
        self.rbudget = ResidentBudget(resident_max_bytes)
        # pooled resident matrix (round 20): every promoted engine
        # shares ONE device allocation, and the tick's above-crossover
        # deltas batch into ONE flush dispatch. ``pool=False`` (or
        # CRDT_TPU_MT_POOL_BYTES=0) keeps the per-doc private
        # matrices — the unpooled oracle the differential suite and
        # the bench baseline measure against. Construction is host
        # bookkeeping only; the matrix allocates on the first flush.
        if pool_max_bytes is None:
            env = os.environ.get(_POOL_BYTES_ENV, "")
            pool_max_bytes = int(env) if env else None
        if pool is None:
            pool = pool_max_bytes != 0
        self.pool = None
        if self.delta_ticks and pool and pool_max_bytes != 0:
            from crdt_tpu_torch.ops.resident import ResidentPool

            self.pool = ResidentPool(max_bytes=pool_max_bytes,
                                     device=self.device)
        # snapshot store (round 21): when attached (explicitly or
        # via CRDT_TPU_SNAP_DIR), evicted residents write a snapshot
        # on the way out and promotions rehydrate from it instead of
        # rebuilding over the full history; checkpoint()/restore()
        # round-trip the WHOLE resident set through it. Absent store
        # = every path below is stock round-15 behavior.
        if snap_store is None:
            from crdt_tpu_torch.storage.snapshot import store_from_env

            snap_store = store_from_env()
        self.snap_store = snap_store
        self.shards = shards
        self.pack_docs = pack_docs
        self.ticks = 0
        self.shed_count = 0
        self.shed_bytes = 0
        self.eviction_count = 0
        self.delta_fallback_count = 0
        self._docs: Dict = {}
        # docs already served by the CURRENT tick (aliased to the
        # tick loop's set): protected best-effort from budget sweeps
        self._serving: set = set()
        # live-ingest hook (serve()): called while a tick's converge
        # dispatches are in flight, so the NEXT tick's decode overlaps
        # this tick's device work
        self._ingest_hook: Optional[Callable[[], int]] = None
        # running pending-queue byte total: the gauge (and the
        # public accessor) must not re-scan every tenant's deque on
        # each admitted blob — ingest stays O(1) per update
        self._pending_total = 0
        # per-tenant SLO ledger (round 18): submit stamps close at
        # settle (ingest-to-converged) and tick end (ingest-to-
        # served); sheds fold into the breach ledger. ``slo_ms=None``
        # reads CRDT_TPU_SLO_MS (default 250 ms).
        self.slo = SLOLedger(slo_ms)
        # (tenant, submit stamps) settled this tick, awaiting the
        # tick-end served stamp
        self._served_buf: List = []
        # control plane (round 22): a deterministic per-tick rule
        # engine over the sensors above (burn rates, queue pressure,
        # settled bytes) actuating the knobs above (tenant budget
        # overrides, LRU protection, max_rows pacing, checkpoint
        # cadence). ``control=True`` builds the default
        # :class:`crdt_tpu_torch.obs.control.Controller`; a Controller
        # instance is adopted as-is; ``None``/``False`` with no
        # cadence params disables the whole phase (zero tick cost).
        # ``checkpoint_every_ticks=``/``checkpoint_every_bytes=``
        # ride the controller's actuation path (ROADMAP item 4c) —
        # setting either implies a controller.
        if control is True or (
            control is None
            and (checkpoint_every_ticks or checkpoint_every_bytes)
        ):
            from crdt_tpu_torch.obs.control import Controller

            control = Controller()
        self.control = control or None
        if self.control is not None:
            if checkpoint_every_ticks is not None:
                self.control.checkpoint_every_ticks = int(
                    checkpoint_every_ticks)
            if checkpoint_every_bytes is not None:
                self.control.checkpoint_every_bytes = int(
                    checkpoint_every_bytes)
        # docs on control-squeezed tenants: shielded from the LRU
        # sweep (best-effort, like ``_serving`` — the budget bound
        # stays hard)
        self._protected: set = set()
        # settled-byte odometer for the bytes-based cadence rule
        self._settled_since_ckpt = 0
        self.cadence_checkpoints = 0
        # deterministic snapshot-fallback odometer (the tracer's
        # ``snap.fallbacks`` counter is enabled-gated; the control
        # sensor must not be)
        self.snap_fallback_count = 0

    # ---- admission (the ingest side) ---------------------------------

    def submit(self, doc_id, blob: bytes) -> int:
        """Admit one update blob for ``doc_id``. Returns how many of
        the tenant's pending updates were SHED to fit its budget (0 =
        admitted with room)."""
        st = self._docs.setdefault(doc_id, _DocState())
        now = time.perf_counter()
        if st.dirty_since is None:
            st.dirty_since = now
        st.pending.append(bytes(blob))
        st.pending_ts.append(now)
        self._pending_total += len(blob)
        st.stale = True
        tracer = get_tracer()
        if tracer.enabled:
            tracer.count("tenant.submitted")
        shed_n = self._trim_tenant(doc_id, st)
        if tracer.enabled:
            tracer.gauge("tenant.pending_bytes", self.pending_bytes())
        return shed_n

    def _trim_tenant(self, doc_id, st) -> int:
        """Apply the tenant's admission budget — the static one, or
        a control-plane override (:meth:`crdt_tpu_torch.guard.tenant.
        TenantBudget.limits`) — to its pending queue, with the full
        shed bookkeeping: shed counters, SLO breaches, submit-stamp
        lockstep. Called per submit, and by the control phase right
        after a squeeze (immediate containment: the flooder's
        backlog shrinks THIS tick, not on its next submit)."""
        shed = self.budget.trim(st.pending, tenant=doc_id)
        if not shed:
            return 0
        nbytes = sum(len(b) for b in shed)
        self.shed_count += len(shed)
        self.shed_bytes += nbytes
        self._pending_total -= nbytes
        # trim pops oldest-first; the stamp queue follows in
        # lockstep, and every shed blob is an SLO breach (it will
        # never be served)
        for _ in shed:
            st.pending_ts.popleft()
        self.slo.shed(doc_id, len(shed))
        tracer = get_tracer()
        if tracer.enabled:
            tracer.count("tenant.shed", len(shed))
            tracer.count("tenant.shed_bytes", nbytes)
        return len(shed)

    def submit_many(self, doc_id, blobs: Sequence[bytes]) -> int:
        if not blobs:
            # registering an empty doc: a NEW state, already settled
            # (nothing to decode, cache/digest default to empty). An
            # EXISTING doc is left completely untouched — clearing
            # its stale flag here would make prepare() skip a dirty
            # doc and tick() read outdated columns
            if doc_id not in self._docs:
                st = _DocState()
                st.stale = False
                self._docs[doc_id] = st
            return 0
        return sum(self.submit(doc_id, b) for b in blobs)

    def prepare(self) -> int:
        """Run the ingest-side work for every stale doc: resident
        docs decode only their PENDING delta and probe admissibility;
        cold docs decode + stage their full admitted history. Docs
        that will PROMOTE this tick are left to the tick (the engine
        build decodes for itself — a throwaway cold staging would be
        pure waste). Idempotent; the tick calls it for anything the
        ingest thread has not covered. Returns the number of docs
        prepared."""
        n = 0
        for d, st in list(self._docs.items()):
            if not st.stale:
                continue
            st.delta_ok = False
            if self.delta_ticks and (st.pending or st.in_flight):
                if st.resident is not None:
                    self._take_pending(st)
                    dec = IncrementalReplay.decode_delta(st.in_flight)
                    if st.resident.delta_admissible(dec):
                        st.delta_dec = dec
                        st.delta_ok = True
                        st.stale = False
                        n += 1
                        continue
                    # inadmissible (offset clocks, unresolvable
                    # refs): the resident engine cannot absorb this
                    # delta exactly — release it, cold-replay
                    self._drop_resident(d)
                if self._promotable(st):
                    # leave stale: the tick's promotion decodes for
                    # itself, or cold-prepares on a budget refusal
                    continue
            self._prepare_cold_one(st)
            n += 1
        return n

    @staticmethod
    def _take_pending(st) -> None:
        """Move the admission queue into the in-flight window a
        prepared decode will cover (see ``_DocState.in_flight``)."""
        if st.pending:
            st.in_flight.extend(st.pending)
            st.pending.clear()
            st.in_flight_ts.extend(st.pending_ts)
            st.pending_ts.clear()

    def _prepare_cold_one(self, st) -> None:
        self._take_pending(st)
        dec = rp.decode(st.blobs + st.in_flight)
        st.cols, st.ds = rp.stage(dec)
        st.dec = dec
        st.fast_ok = _fast_unpack_ok(dec)
        st.stale = False

    def _promotable(self, st) -> bool:
        return (self.delta_ticks and st.resident is None
                and st.history_len() != st.no_promote_len
                and st.served_tick >= 0)

    def pending_bytes(self) -> int:
        return self._pending_total

    def dirty_docs(self) -> List:
        return [d for d, st in self._docs.items()
                if st.pending or st.in_flight]

    # ---- results -----------------------------------------------------

    def doc_ids(self) -> List:
        return list(self._docs)

    def cache(self, doc_id) -> dict:
        return self._cache_of(self._docs[doc_id])

    @staticmethod
    def _cache_of(st) -> dict:
        # resident docs serve the engine's LAZY view: a delta tick
        # never materializes (the engine only marks touched segments
        # dirty); the flush happens here, on read — the engine's own
        # cache contract, surfaced through the server
        return st.resident.cache if st.resident is not None \
            else st.cache

    def digest(self, doc_id) -> str:
        """Canonical digest of the doc's converged cache, computed
        LAZILY and cached per (op count, serve tick): converging
        never digests, and a clean doc re-beacons at zero digest
        cost (round-15 satellite). The tracer's ``digest`` span, one
        a read."""
        with get_tracer().span("digest"):
            return self._digest_of(self._docs[doc_id])

    def _digest_of(self, st) -> str:
        key = (st.n_ops, st.served_tick)
        if st._digest is None or st._digest_key != key:
            st._digest = cache_digest(self._cache_of(st))
            st._digest_key = key
        return st._digest

    def latency_s(self, doc_id) -> Optional[float]:
        """Submit-to-converged latency of the doc's last service."""
        return self._docs[doc_id].latency_s

    def is_resident(self, doc_id) -> bool:
        """Does this doc currently hold resident incremental state
        (vs. cold-replaying on its next touch)?"""
        return self._docs[doc_id].resident is not None

    def resident_doc_count(self) -> int:
        return self.rbudget.docs()

    def resident_bytes_total(self) -> int:
        return self.rbudget.total

    def resident_peak_bytes(self) -> int:
        return self.rbudget.peak

    def doc_digests(self) -> Dict:
        """The multi-doc sentinel's beacon source: per-doc digest +
        op count (the count is the lag guard — unequal counts are
        propagation lag, not a fork). Digests cached per (op count,
        serve tick): docs untouched since the last beacon are
        SKIPPED, counted as ``sentinel.doc_digest_skips`` — a beacon
        over a mostly-clean population costs digest work only for
        the docs that moved."""
        tracer = get_tracer()
        skips = 0
        out = {}
        for d, st in self._docs.items():
            if (st._digest is not None
                    and st._digest_key == (st.n_ops, st.served_tick)):
                skips += 1
            out[d] = {"digest": self._digest_of(st), "ops": st.n_ops}
        if tracer.enabled and skips:
            tracer.count("sentinel.doc_digest_skips", skips)
        return out

    # ---- the tick loop -----------------------------------------------

    def tick(self) -> TickReport:
        """Converge every dirty doc: fairness-ordered admission, then
        per doc the cheapest exact route — admissible deltas through
        the resident engines, promotions for warm docs without one,
        bin-packed cold dispatch batches for the rest (see module
        doc). One tick fully drains the dirty set — fairness decides
        WHO goes first, the row cap decides how many dispatches."""
        self.ticks += 1
        tl = get_timeline()
        tl.tick_begin(self.ticks)
        # control phase (round 22) FIRST: the rules read the sensor
        # state the PREVIOUS tick settled (burn rates, queue bytes),
        # actuate the knobs this tick runs under, and fire BEFORE the
        # idle early-return so the checkpoint cadence covers quiet
        # ticks too
        if self.control is not None:
            with tl.phase("control"):
                self._run_control(tl)
        with tl.phase("prepare"):
            self.prepare()
        with tl.phase("fair_order"):
            dirty = fair_order(self.dirty_docs(),
                               {d: self._docs[d].served_tick
                                for d in self._docs})
        if not dirty:
            tl.tick_end()
            return TickReport(0, 0, 0, 0)
        tracer = get_tracer()
        # route decision per dirty doc. Promotion-time eviction must
        # not thrash docs ALREADY served this tick (their resident
        # state is freshest), so those are protected from the
        # budget's LRU sweep; docs still waiting their turn are fair
        # game — they reroute to the cold path when it comes.
        served_set: set = set()
        self._serving = served_set
        delta_served: List = []
        cold: List = []
        delta_rows = 0
        promotions = 0
        try:
            with tl.phase("route"):
                for d in dirty:
                    st = self._docs[d]
                    if st.delta_ok and st.resident is not None:
                        delta_rows += self._apply_delta(d)
                        delta_served.append(d)
                        served_set.add(d)
                        continue
                    if st.stale:
                        if self._try_promote(
                            d,
                            protect=(served_set | {d}
                                     | self._protected),
                        ):
                            promotions += 1
                            served_set.add(d)
                            continue
                        self._prepare_cold_one(st)
                    cold.append(d)
        finally:
            self._serving = set()
        pool_disp = 0
        if self.pool is not None and self.pool.has_pending():
            # the tick's ONE pooled dispatch (round 20): every warm
            # doc's above-crossover delta deferred during routing
            # splices + converges here, before anything settles or
            # reads — O(1) device-route dispatches per tick however
            # many docs went warm
            with tl.phase("pool"):
                pool_disp = self.pool.flush()
        with tl.phase("settle"):
            for d in delta_served:
                self._settle([d], route="delta")
        n_delta = len(delta_served)

        staged = [(d, len(self._docs[d].dec["client"])) for d in cold]
        batches = (pack_batches(staged, self.max_rows)
                   if self.pack_docs else [[d] for d, _ in staged])
        dispatches = pool_disp
        fallback = 0
        rows = delta_rows
        sizes = []
        # double-buffered pipeline (the streaming executor's overlap
        # pattern): while batch i executes on device, the host stages
        # + dispatches batch i+1, unpacks batch i-1, and drains the
        # live-ingest hook — the fetch is the only synchronization
        # point
        inflight: deque = deque()
        for batch in batches:
            with tl.phase("pack"):
                n_disp, n_fb, handle = self._converge_batch(batch)
            dispatches += n_disp
            fallback += n_fb
            rows += sum(len(self._docs[d].dec["client"]) for d in batch)
            sizes.append(len(batch))
            if handle is not None:
                inflight.append((batch, handle, tl.dispatch_begin()))
                hook = self._ingest_hook
                if hook is not None:
                    # ingest overlaps the in-flight dispatch
                    with tl.phase("ingest"):
                        hook()
                if len(inflight) > 1:
                    self._finish_batch(*inflight.popleft())
            else:
                with tl.phase("settle"):
                    self._settle(
                        batch, route="fallback" if n_fb else "cold"
                    )
        while inflight:
            self._finish_batch(*inflight.popleft())
        self.rbudget.note_peak()
        # SLO: everything settled this tick became READABLE now —
        # the ingest-to-served clock closes at the tick boundary,
        # not at each batch's settle (a reader sees tick state)
        if self._served_buf:
            t_served = time.perf_counter()
            for tenant, stamps in self._served_buf:
                self.slo.served(
                    tenant, (t_served - t for t in stamps)
                )
            self._served_buf.clear()
            self.slo.publish_worst()
        tl.tick_end()
        if tracer.enabled:
            tracer.count("tenant.docs_converged", len(dirty))
            tracer.gauge("tenant.dispatch_docs",
                         max(sizes) if sizes else 0)
            tracer.gauge("tenant.pending_bytes", self.pending_bytes())
            tracer.gauge("tenant.resident_bytes", self.rbudget.total)
            tracer.gauge("tenant.resident_docs", self.rbudget.docs())
            if self.pool is not None:
                tracer.gauge("tenant.pool_bytes",
                             self.pool.device_bytes())
                tracer.gauge("tenant.pool_docs",
                             self.pool.doc_count())
            if n_delta:
                tracer.count("tenant.delta_docs", n_delta)
            if delta_rows:
                tracer.count("tenant.delta_rows", delta_rows)
            if promotions:
                tracer.count("tenant.promotions", promotions)
            if fallback:
                tracer.count("tenant.fallback_docs", fallback)
        return TickReport(len(dirty), dispatches, rows, fallback,
                          tuple(sizes), n_delta, delta_rows,
                          promotions, pool_disp)

    # ---- the control plane (round 22) --------------------------------

    def _run_control(self, tl) -> None:
        """One controller consult per tick: build the JSON-ready
        sensor snapshot (per-tenant burn/shed from the SLO ledger,
        queue + pool + resident pressure, the settled-byte odometer),
        run the deterministic rules, apply the actuation — budget
        overrides with an IMMEDIATE trim of the squeezed backlog,
        the LRU protection set, the ``max_rows`` setpoint, a cadence
        checkpoint — and annotate every decision into the tick
        timeline as a Perfetto instant."""
        slo = self.slo.control_snapshot()
        tenants = {}
        byname = {}
        for d, s in slo.items():
            st = self._docs.get(d)
            pend = 0
            if st is not None:
                pend = (sum(len(b) for b in st.pending)
                        + sum(len(b) for b in st.in_flight))
            name = str(d)
            byname[name] = d
            tenants[name] = {
                "burn": s["burn"],
                "shed": int(s["shed"]),
                "breaches": int(s["breaches"]),
                "pending_bytes": pend,
            }
        sensors = {
            "tick": self.ticks,
            "max_rows": self.max_rows,
            "pending_bytes": self._pending_total,
            "settled_bytes": self._settled_since_ckpt,
            "budget": {
                "max_bytes": self.budget.max_bytes,
                "max_updates": self.budget.max_updates,
            },
            "tenants": tenants,
            "pool_bytes": (self.pool.device_bytes()
                           if self.pool is not None else 0),
            "pool_compactions": (self.pool.compactions
                                 if self.pool is not None else 0),
            "resident_bytes": self.rbudget.total,
            "snap_fallbacks": self.snap_fallback_count,
        }
        act = self.control.observe(sensors)
        # reconcile the budget override set (controller answers the
        # FULL set, keyed by stringified tenant — map back to the
        # server's own doc ids)
        for t in list(self.budget.overrides()):
            if str(t) not in act.tenant_limits:
                self.budget.clear_override(t)
        for name in sorted(act.tenant_limits):
            mb, mu = act.tenant_limits[name]
            t = byname.get(name, name)
            self.budget.set_override(t, mb, mu)
            st = self._docs.get(t)
            if st is not None and st.pending:
                # immediate containment: the flooder's backlog
                # shrinks to the squeezed budget THIS tick
                self._trim_tenant(t, st)
        self._protected = {byname.get(n, n) for n in act.protect}
        if act.max_rows is not None:
            self.max_rows = int(act.max_rows)
        if act.checkpoint and self.snap_store is not None:
            # background cadence checkpoint (ROADMAP item 4c): a
            # restart replays at most one cadence of WAL tail
            self.checkpoint()
            self.cadence_checkpoints += 1
            tracer = get_tracer()
            if tracer.enabled:
                tracer.count("snap.cadence_writes")
        for row in act.rows:
            tl.instant("control:%s" % row["rule"], {
                "tenant": row["tenant"],
                "knob": row["knob"],
                "old": row["old"],
                "new": row["new"],
            })

    # ---- the live-ingest scheduler -----------------------------------

    def serve(self, source, *, max_ticks: Optional[int] = None,
              idle_ticks: int = 1) -> ServeReport:
        """Live-ingest tick loop (round 15): drive the server against
        a STREAM of updates instead of a pre-drained backlog.
        ``source`` is an iterator whose each ``next()`` yields an
        iterable of ``(doc_id, blob)`` pairs (or None for an idle
        poll); exhaustion means the stream drained. Each loop
        iteration admits one batch and ticks; while a tick's converge
        dispatches are IN FLIGHT the ingest hook drains further
        batches into the admission queues, so the next tick's decode
        overlaps this tick's device work (the streaming executor's
        overlap discipline at the server level). The loop is bounded:
        ``max_ticks`` caps it hard, and it stops after ``idle_ticks``
        consecutive empty ticks (immediately, once the source is
        exhausted and nothing is dirty)."""
        it = iter(source)
        state = {"exhausted": False, "submitted": 0}

        def pull() -> int:
            if state["exhausted"]:
                return 0
            try:
                batch = next(it)
            except StopIteration:
                state["exhausted"] = True
                return 0
            n = 0
            for doc_id, blob in (batch or ()):
                self.submit(doc_id, blob)
                n += 1
            state["submitted"] += n
            return n

        ticks = docs = delta = promo = disp = idle = 0
        while max_ticks is None or ticks < max_ticks:
            pull()
            self._ingest_hook = pull
            try:
                rep = self.tick()
            finally:
                self._ingest_hook = None
            ticks += 1
            docs += rep.docs
            delta += rep.delta_docs
            promo += rep.promotions
            disp += rep.dispatches
            if rep.docs == 0:
                if state["exhausted"] and not self.dirty_docs():
                    break
                idle += 1
                if idle >= idle_ticks:
                    break
            else:
                idle = 0
        return ServeReport(ticks, docs, delta, docs - delta, promo,
                           disp, state["submitted"])

    # ---- the delta route (round 15) ----------------------------------

    def _apply_delta(self, d) -> int:
        """One admissible delta through the doc's resident engine:
        the delta rows are the only staging this doc pays — host-
        exact splices below the crossover, a delta-only device
        splice against the resident matrix above it."""
        st = self._docs[d]
        dec, st.delta_dec, st.delta_ok = st.delta_dec, None, False
        k = int(len(dec["client"]))
        st.resident.apply_decoded(dec)
        self._adopt_engine(d)
        return k

    def _try_promote(self, d, *, protect=frozenset()) -> bool:
        """Build a resident engine over the doc's full history (the
        one-time warm cost that buys every later delta tick). Refused
        when the budget cannot fit the ESTIMATED footprint even after
        LRU eviction, or when the engine cannot settle the history
        exactly (stashed/rootless leftovers — offset clocks, refs
        that never arrive: such a doc stays cold until its history
        GROWS again, when a retry may find the gap filled)."""
        st = self._docs[d]
        if not self._promotable(st):
            return False
        self._take_pending(st)
        est_rows = (st.n_ops
                    + sum(len(b) for b in st.in_flight) // 8 + 1)
        est = IncrementalReplay.estimate_resident_bytes(est_rows)
        if not self.rbudget.fits(
            est, lru=self._lru_residents(protect),
            evict=self._evict_resident,
        ):
            return False
        eng = self._rehydrate_candidate(d, st)
        if eng is None:
            eng = IncrementalReplay(pool=self.pool, device=self.device)
            eng.apply(st.blobs + st.in_flight)
        if eng._pending or eng._rootless:
            st.no_promote_len = st.history_len()
            self._release_pool(eng)
            return False
        st.resident = eng
        self._adopt_engine(d)
        self._settle([d])
        return True

    def _rehydrate_candidate(self, d, st):
        """The round-21 promotion shortcut: a stored snapshot whose
        coverage is a PREFIX of the doc's admitted history
        rehydrates and applies only the uncovered tail — the
        eviction-then-resubmit case pays delta cost, not a full
        engine rebuild. Any problem (damage, coverage skew, a tail
        that stashes) returns None and the stock full-history build
        runs; correctness never depends on the snapshot."""
        if self.snap_store is None:
            return None
        loaded = self.snap_store.load_latest(d)
        if loaded is None:
            return None
        snap, seq = loaded
        if seq > len(st.blobs):
            self.snap_fallback_count += 1
            tracer = get_tracer()
            if tracer.enabled:
                tracer.count("snap.fallbacks",
                             labels={"reason": "coverage"})
            return None
        from crdt_tpu_torch.storage.snapshot import rehydrate

        eng = None
        try:
            eng = rehydrate(snap, pool=self.pool, device=self.device)
            eng.apply(st.blobs[seq:] + st.in_flight)
        except ValueError:
            if eng is not None:
                self._release_pool(eng)
            self.snap_fallback_count += 1
            tracer = get_tracer()
            if tracer.enabled:
                tracer.count("snap.fallbacks",
                             labels={"reason": "rehydrate"})
            return None
        if eng._pending or eng._rootless:
            # the tail did not settle over this snapshot (foreign or
            # skewed coverage): fall back to the stock build rather
            # than pinning no_promote_len on the doc
            self._release_pool(eng)
            self.snap_fallback_count += 1
            tracer = get_tracer()
            if tracer.enabled:
                tracer.count("snap.fallbacks",
                             labels={"reason": "tail_stash"})
            return None
        return eng

    def _adopt_engine(self, d) -> None:
        """Commit a doc's engine-converged state: op count from the
        engine, digest invalidated (the cache itself stays LAZY —
        reads flush it through :meth:`_cache_of`, so a delta tick
        pays zero materialization), resident bytes ledgered — and
        the budget enforced at the commit, so the ledger NEVER
        exceeds it (a doc that alone outgrows the whole budget is
        evicted on the spot and stays cold until its history
        grows)."""
        st = self._docs[d]
        st.n_ops = st.resident.cols.n
        st._digest = None
        self.rbudget.set_doc(d, st.resident.resident_bytes())
        if self.rbudget.max_bytes is not None:
            # protection is best-effort (docs already served this
            # tick hold the freshest state — evicting one buys a
            # full re-promotion on its next delta), the bound is
            # hard: if the protected sweep cannot reach it, sweep
            # again without protection, and a doc that ALONE
            # outgrows the whole budget is evicted on the spot (and
            # not re-attempted until its history grows)
            self._enforce_budget(
                protect={d} | self._serving | self._protected
            )
            if self.rbudget.total > self.rbudget.max_bytes:
                self._enforce_budget(protect={d})
            if self.rbudget.total > self.rbudget.max_bytes:
                self._evict_resident(d)
                st.no_promote_len = st.history_len()
        self.rbudget.note_peak()

    def _release_pool(self, eng) -> None:
        """Free a discarded engine's pooled extent (LRU eviction,
        delta fallback, failed promotion). Release may trigger the
        pool's bounded compaction — the hole squeeze the
        ``tenant.pool_compactions`` counter evidences. The engine's
        own read path already flushed any deferred round (cache
        materializes before every release site)."""
        if eng is not None and eng.pool is not None:
            eng.pool.release(eng)
            eng.pool = None

    def _lru_residents(self, protect=frozenset()) -> List:
        return sorted(
            (d for d, st in self._docs.items()
             if st.resident is not None and d not in protect),
            key=lambda d: (self._docs[d].served_tick, str(d)),
        )

    def _enforce_budget(self, protect=frozenset()) -> None:
        for d in self._lru_residents(protect):
            if self.rbudget.total <= self.rbudget.max_bytes:
                break
            self._evict_resident(d)

    def _evict_resident(self, d) -> None:
        """Budget pressure: release the doc's resident state back to
        cold replay. Its converged cache stays served; only the
        engine memory goes — the doc reconverges byte-identically
        (cold, or via a fresh promotion) on its next touch."""
        st = self._docs[d]
        if st.resident is None:
            return
        st.cache = st.resident.cache  # materialize the lazy view
        self._snapshot_on_evict(d, st)
        self._release_pool(st.resident)
        st.resident = None
        st.delta_dec = None
        st.delta_ok = False
        if st.pending or st.in_flight:
            st.stale = True  # re-route what was prepared as a delta
        self.rbudget.drop_doc(d)
        self.eviction_count += 1
        tracer = get_tracer()
        if tracer.enabled:
            tracer.count("tenant.resident_evictions")
            tracer.gauge("tenant.resident_bytes", self.rbudget.total)
            tracer.gauge("tenant.resident_docs", self.rbudget.docs())

    def _snapshot_on_evict(self, d, st) -> None:
        """Kill the eviction cold-start tax (round 21): a resident
        doc leaving the budget writes a snapshot covering its
        settled ``blobs`` prefix, so eviction-then-resubmit
        rehydrates + applies the delta instead of re-replaying the
        whole history. Budget-permitting and best-effort: a refused
        or failed write (counted inside the store) just means the
        next promotion pays the stock rebuild. Skipped when the
        engine's coverage is ambiguous (un-settled in-flight blobs)
        — a wrong coverage cursor would be corrected by the
        tail-stash fallback, but never writing it is cheaper."""
        if self.snap_store is None or st.in_flight:
            return
        from crdt_tpu_torch.storage.snapshot import encode_engine

        try:
            payload = encode_engine(st.resident, seq=len(st.blobs))
        except ValueError:
            return
        if self.snap_store.write(d, payload, len(st.blobs)):
            tracer = get_tracer()
            if tracer.enabled:
                tracer.count("snap.evict_writes")

    def _drop_resident(self, d) -> None:
        """Inadmissible delta: the resident engine cannot absorb it
        exactly — release it and fall back to the cold route (the
        conservative direction: a fallback costs a cold replay,
        never bytes). The refusal also stamps ``no_promote_len``: a
        promotion over this SAME history would stash the same rows
        the probe just refused, so the guaranteed-futile full engine
        build is skipped until new history arrives."""
        st = self._docs[d]
        if st.resident is None:
            return
        st.cache = st.resident.cache  # materialize the lazy view
        self._release_pool(st.resident)
        st.resident = None
        st.delta_dec = None
        st.delta_ok = False
        st.no_promote_len = st.history_len()
        self.rbudget.drop_doc(d)
        self.delta_fallback_count += 1
        tracer = get_tracer()
        if tracer.enabled:
            tracer.count("tenant.delta_fallbacks")

    # ---- checkpoint / restore (round 21) -----------------------------

    def checkpoint(self, store=None, *, fence=None) -> int:
        """Snapshot the WHOLE resident set into ``store`` (default:
        the attached ``snap_store``). Per resident doc: one snapshot
        generation covering its settled ``blobs`` prefix plus a
        sidecar history blob (``encode_state_as_update`` — the
        encode is paid NOW so a restore never decodes more than it
        must), tied together by a manifest sidecar. Docs with
        un-settled in-flight state are skipped (call between ticks
        for full coverage). Returns the number of docs
        checkpointed; counted ``tenant.checkpoint_docs``.

        ``fence`` (round 24): a lease view — ``.proc`` plus
        ``.epoch_of(doc)`` (``fleet.placement.LeaseTable`` or any
        duck-type) — stamps the checkpoint with the fencing epochs
        this process held per doc (a separate ``checkpoint.fence``
        blob; the manifest shape is unchanged). ``restore(fence=)``
        refuses docs stamped NEWER than the restoring process's
        lease."""
        from crdt_tpu_torch.storage.snapshot import encode_engine

        store = store if store is not None else self.snap_store
        if store is None:
            raise ValueError("checkpoint: no snapshot store attached")
        tracer = get_tracer()
        manifest = {}
        done = 0
        for d, st in sorted(self._docs.items(), key=lambda kv:
                            str(kv[0])):
            if st.resident is None or st.in_flight:
                continue
            seq = len(st.blobs)
            try:
                payload = encode_engine(st.resident, seq=seq)
            except ValueError:
                continue
            if not store.write(d, payload, seq):
                continue
            hist = st.resident.encode_state_as_update()
            store.put_blob("%s.hist" % d, hist)
            manifest[str(d)] = {"seq": seq, "n_ops": st.n_ops}
            done += 1
            if tracer.enabled:
                tracer.count("tenant.checkpoint_docs")
        store.put_blob(
            "checkpoint.manifest",
            json.dumps(manifest, sort_keys=True).encode())
        if fence is not None:
            store.put_blob(
                "checkpoint.fence",
                json.dumps({
                    "proc": str(getattr(fence, "proc", "")),
                    "epochs": {d: int(fence.epoch_of(d))
                               for d in sorted(manifest)},
                }, sort_keys=True).encode())
        return done

    def restore(self, store=None, *, fence=None) -> int:
        """Rehydrate the resident set a :meth:`checkpoint` wrote —
        the whole-server warm restart. Per manifest doc: snapshot ->
        live engine re-registered with the pool and the resident
        budget (ledgers rebuild through the stock ``_adopt_engine``
        commit), history re-seeded from the sidecar blob so every
        later route (re-promotion, cold fallback, digesting) sees an
        equivalent doc. A damaged snapshot falls back to the sidecar
        blob COLD (served correctly, promoted on its next touch);
        a missing sidecar skips the doc. Returns docs restored
        warm.

        ``fence`` (round 24): a doc stamped with a NEWER fencing
        epoch than this process holds is REFUSED, not silently
        adopted — the checkpoint belongs to a lease this process
        never held (a cross-wired store, a rolled-back lease
        table), and serving it would fork the doc past the fence.
        Counted ``snap.fallbacks{reason=stale_epoch}``."""
        from crdt_tpu_torch.storage.snapshot import rehydrate

        store = store if store is not None else self.snap_store
        if store is None:
            raise ValueError("restore: no snapshot store attached")
        raw = store.get_blob("checkpoint.manifest")
        if raw is None:
            return 0
        try:
            manifest = json.loads(raw)
        except ValueError:
            return 0
        stamped = {}
        if fence is not None:
            raw_f = store.get_blob("checkpoint.fence")
            if raw_f:
                try:
                    stamped = json.loads(raw_f).get("epochs") or {}
                except (ValueError, AttributeError):
                    stamped = {}
        tracer = get_tracer()
        warm = 0
        for d in sorted(manifest):
            if fence is not None and \
                    int(stamped.get(d, 0)) > int(fence.epoch_of(d)):
                self.snap_fallback_count += 1
                if tracer.enabled:
                    tracer.count("snap.fallbacks",
                                 labels={"reason": "stale_epoch"})
                continue
            hist = store.get_blob("%s.hist" % d)
            if hist is None:
                continue
            st = self._docs.setdefault(d, _DocState())
            st.blobs = [hist]
            st.pending.clear()
            st.pending_ts.clear()
            st.in_flight = []
            st.in_flight_ts = []
            st.stale = True
            st.no_promote_len = -1
            st._digest = None
            eng = None
            loaded = store.load_latest(d)
            if loaded is not None:
                snap, _seq = loaded
                try:
                    eng = rehydrate(snap, pool=self.pool,
                                    device=self.device)
                except ValueError:
                    self.snap_fallback_count += 1
                    if tracer.enabled:
                        tracer.count("snap.fallbacks",
                                     labels={"reason": "rehydrate"})
                    eng = None
            if eng is None:
                # cold rung: the doc serves from the sidecar blob
                # via the stock replay path on its next touch
                st.n_ops = int(manifest[d].get("n_ops", 0))
                continue
            st.resident = eng
            st.stale = False
            st.cache = {}
            self._adopt_engine(d)
            if st.resident is None:
                continue  # budget evicted it right back
            warm += 1
        if tracer.enabled:
            tracer.gauge("tenant.resident_docs", self.rbudget.docs())
            tracer.gauge("tenant.resident_bytes", self.rbudget.total)
        return warm

    # ---- converge engines (the round-14 cold path) -------------------

    def _finish_doc(self, doc_id, res) -> None:
        """One doc's packed result through the STOCK replay gather +
        materialize (res rows are local to the doc's decode) — the
        exact path, used for the per-doc baseline and every shape
        the vectorized unpack refuses."""
        st = self._docs[doc_id]
        dec, ds = st.dec, st.ds
        w, v, o = rp.gather(dec, ds, ("packed", res), device=self.device)
        st.cache = rp.materialize(dec, ds, w, v, o)
        st._digest = None
        st.n_ops = len(dec["client"])

    def _converge_one(self, doc_id) -> None:
        """Per-doc dispatch: the ordinary replay converge (exactly the
        one-shot pipeline of ``replay_trace``)."""
        st = self._docs[doc_id]
        if not len(st.dec["client"]):
            self._finish_empty(doc_id)
            return
        handle = rp.converge(st.cols, device=self.device)
        w, v, o = rp.gather(st.dec, st.ds, handle, device=self.device)
        st.cache = rp.materialize(st.dec, st.ds, w, v, o)
        st._digest = None
        st.n_ops = len(st.dec["client"])

    def _converge_batch(self, batch) -> tuple:
        """Stage + (async) dispatch one batch. Returns (dispatches,
        fallback_docs, in-flight handle or None when the batch was
        settled synchronously)."""
        live = [d for d in batch
                if len(self._docs[d].dec["client"])]
        live_set = set(live)
        for d in batch:
            if d not in live_set:
                self._finish_empty(d)
        if len(live) == 0:
            return 0, 0, None
        if len(live) == 1 or not self.pack_docs:
            for d in live:
                self._converge_one(d)
            return len(live), 0, None
        comb, row_off = _concat_cols(
            [self._docs[d].cols for d in live]
        )
        handle = self._dispatch_async(comb)
        if handle is None:
            # the batch exceeded the packed staging bounds: degrade
            # to per-doc dispatches (correct, just un-amortized),
            # and say so in the evidence
            for d in live:
                self._converge_one(d)
            return len(live), len(live), None
        return 1, 0, (live, comb, row_off, handle)

    def _finish_batch(self, batch, work, tok=None) -> None:
        """Fetch one in-flight batch dispatch, unpack per doc, stamp
        latencies/service bookkeeping. ``tok`` closes the dispatch's
        timeline window; the fetch span is the tick's stall."""
        live, comb, row_off, (route, h) = work
        fetch = (shard_ops.converge_fetch if route == "shard"
                 else packed.converge_fetch)
        tl = get_timeline()
        t0 = time.perf_counter()
        res = fetch(h)
        t1 = time.perf_counter()
        tl.dispatch_end(tok, t0, t1)
        with tl.phase("unpack"):
            self._unpack(live, comb, row_off, res)
        with tl.phase("settle"):
            self._settle(batch)

    def _settle(self, batch, route: str = "cold") -> None:
        done = time.perf_counter()
        for d in batch:
            st = self._docs[d]
            nbytes = sum(len(b) for b in st.in_flight)
            self._pending_total -= nbytes
            self._settled_since_ckpt += nbytes
            st.blobs.extend(st.in_flight)
            st.in_flight.clear()
            if st.in_flight_ts:
                # SLO: ingest-to-converged closes here per blob; the
                # submit stamps park until the tick end stamps
                # ingest-to-served (state readable)
                self.slo.converged(
                    d, (done - t for t in st.in_flight_ts), route,
                )
                self._served_buf.append((d, tuple(st.in_flight_ts)))
                st.in_flight_ts.clear()
            if st.dirty_since is not None:
                st.latency_s = done - st.dirty_since
            st.served_tick = self.ticks
            # mid-tick arrivals (live ingest overlapping this tick's
            # dispatches) stay pending: the doc remains dirty and its
            # latency clock restarts at this serve
            st.dirty_since = done if st.pending else None

    def _finish_empty(self, doc_id) -> None:
        st = self._docs[doc_id]
        st.cache, st.n_ops = {}, 0
        st._digest = None

    def _dispatch_async(self, comb):
        """Enqueue one converge dispatch over the combined multi-doc
        columns: the sharded route when active (partitioned by whole
        docs over ``shards`` mesh entries), the one-device packed plan
        otherwise. Returns a (route, handle) pair for
        :meth:`_finish_batch`, or None when staging refused. Nothing
        here waits on the device: the fetch in :meth:`_finish_batch`
        is the batch's one sync."""
        n = len(comb["client"])
        if shard_ops.active_for(n, self.shards, device=self.device):
            splan = shard_ops.stage(comb, n_shards=self.shards,
                                    device=self.device)
            if splan is not None:
                return ("shard", shard_ops.converge_async(
                    splan, device=self.device))
        plan = staging.stage(comb)
        if plan is None:
            return None
        return ("packed", packed.converge_async(plan, device=self.device))

    # ---- the multi-doc unpack ----------------------------------------

    def _unpack(self, live, comb, row_off, res) -> None:
        """Split one combined result into per-doc caches/digests.

        The global work is vectorized ONCE for the whole batch: the
        visibility of every row against its own doc's delete ranges
        (doc-composite clients, one interval search), and a stable
        partition of the winner/stream arrays by doc (segments never
        cross docs, so each doc's slice keeps its oracle order). Per doc, the plain shape gets
        the tight cache build; anything else replays its slice
        through the stock gather/materialize."""
        win_all = np.asarray(res.win_rows)
        win_all = win_all[win_all >= 0]
        srow_all = np.asarray(res.stream_row)
        sm = srow_all >= 0
        srow_all = srow_all[sm]
        sseg_all = np.asarray(res.stream_seg)[sm]
        wdoc = np.searchsorted(row_off, win_all, side="right") - 1
        worder = np.argsort(wdoc, kind="stable")
        win_all, wdoc = win_all[worder], wdoc[worder]
        sorder = np.argsort(sdoc := np.searchsorted(
            row_off, srow_all, side="right") - 1, kind="stable")
        srow_all, sseg_all, sdoc = (
            srow_all[sorder], sseg_all[sorder], sdoc[sorder]
        )
        D = len(live)
        wcut = np.searchsorted(wdoc, np.arange(D + 1))
        scut = np.searchsorted(sdoc, np.arange(D + 1))
        vis = _global_visibility(
            comb, [self._docs[d].ds for d in live]
        )
        hard = sorted(int(r) for r in res.hard_rows)
        hdocs = (set(
            (np.searchsorted(row_off, hard, side="right") - 1).tolist()
        ) if hard else frozenset())
        for i, d in enumerate(live):
            st = self._docs[d]
            lo, hi = int(row_off[i]), int(row_off[i + 1])
            has_hard = i in hdocs
            if st.fast_ok and not has_hard:
                st.cache = _fast_cache(
                    st.dec, lo,
                    win_all[wcut[i]:wcut[i + 1]],
                    srow_all[scut[i]:scut[i + 1]],
                    sseg_all[scut[i]:scut[i + 1]],
                    vis,
                )
                st._digest = None
                st.n_ops = len(st.dec["client"])
            else:
                self._finish_doc(d, packed.PackedResult(
                    win_rows=win_all[wcut[i]:wcut[i + 1]] - lo,
                    stream_seg=sseg_all[scut[i]:scut[i + 1]],
                    stream_row=srow_all[scut[i]:scut[i + 1]] - lo,
                    hard_rows=tuple(
                        r - lo for r in hard if lo <= r < hi
                    ),
                ))


def _concat_cols(cols_list):
    """Concatenate per-doc kernel columns into one multi-doc column
    set with the ``doc`` segment column, plus the caller-row offsets
    of each doc (``row_off[i] .. row_off[i+1]`` is doc i's range)."""
    comb = {
        k: np.concatenate([np.asarray(c[k]) for c in cols_list])
        for k in cols_list[0]
    }
    comb["doc"] = np.concatenate([
        np.full(len(c["client"]), i, np.int64)
        for i, c in enumerate(cols_list)
    ])
    row_off = np.cumsum(
        [0] + [len(c["client"]) for c in cols_list]
    )
    return comb, row_off


def _global_visibility(comb, ds_list):
    """Tombstone visibility for EVERY row of a combined batch in one
    interval search: clients compose with the doc column (one doc's
    delete ranges can never touch another doc's rows), delete
    triples from clients absent from the batch are dropped (they
    cannot cover any row). Returns a bool mask over the combined
    caller rows, or None when no doc carries tombstones (all
    visible)."""
    uniq = np.unique(np.asarray(comb["client"], np.int64))
    C = len(uniq) + 1
    dc: list = []
    dstart: list = []
    dend: list = []
    for i, ds in enumerate(ds_list):
        for c, s, n in ds.iter_all():
            r = int(np.searchsorted(uniq, c))
            if r < len(uniq) and uniq[r] == c:
                dc.append(i * C + r)
                dstart.append(s)
                dend.append(s + n)
    if not dc:
        return None
    comp = (
        np.asarray(comb["doc"], np.int64) * C
        + np.searchsorted(uniq, np.asarray(comb["client"], np.int64))
    )
    return rp.rows_visible(
        comp, np.asarray(comb["clock"], np.int64),
        np.asarray(dc, np.int64), np.asarray(dstart, np.int64),
        np.asarray(dend, np.int64),
    )


def _fast_cache(dec, lo, win, srow, sseg, vis) -> dict:
    """The tight cache build for a plain doc (see `_fast_unpack_ok`):
    map winners keyed into their root dicts, sequence streams cut at
    segment boundaries, tombstoned rows dropped — the exact cache the
    stock materialize produces for this shape (differential-pinned in
    tests/test_torch_multidoc.py). ``win``/``srow`` are combined-space rows
    (``lo`` rebases), ``vis`` the global visibility mask (None = all
    visible)."""
    roots = dec["roots"]
    keys_t = dec["keys"]
    pr = dec["parent_root"]
    kid = dec["key_id"]
    contents = dec["contents"]
    cache: dict = {}
    if vis is None:
        for g in win.tolist():
            r = g - lo
            root = roots[pr[r]]
            grp = cache.get(root)
            if grp is None:
                grp = cache[root] = {}
            grp[keys_t[kid[r]]] = contents[r]
    else:
        for g, ok in zip(win.tolist(), vis[win].tolist()):
            if not ok:
                continue
            r = g - lo
            root = roots[pr[r]]
            grp = cache.get(root)
            if grp is None:
                grp = cache[root] = {}
            grp[keys_t[kid[r]]] = contents[r]
    if len(srow):
        edges = np.flatnonzero(sseg[1:] != sseg[:-1]) + 1
        cuts = [0] + edges.tolist() + [len(sseg)]
        for a, b in zip(cuts[:-1], cuts[1:]):
            rows_g = srow[a:b]
            first = int(rows_g[0]) - lo
            root = roots[pr[first]]
            if vis is None:
                vals = [contents[r - lo] for r in rows_g.tolist()]
            else:
                vals = [
                    contents[r - lo]
                    for r, ok in zip(rows_g.tolist(),
                                     vis[rows_g].tolist())
                    if ok
                ]
            if root not in cache:
                cache[root] = vals
    return cache
