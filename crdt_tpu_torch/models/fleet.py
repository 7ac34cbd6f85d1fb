"""ReplicaFleet — the replica-fleet round on one card.

The port's counterpart of ``crdt_tpu.models.fleet`` (its replicated
mapping). The reference's scale axis is replica parallelism: N peers
full-mesh gossiping updates and converging by CRDT merge (propagate at
crdt.js:385,445; merge-on-receipt at crdt.js:294; the state-vector
handshake at crdt.js:237-291). Here that whole swarm round is one
launch sequence on the card, with the replica axis as a batch axis:

    fleet = ReplicaFleet(n_replicas=1000, ops_per_replica=128)
    out = fleet.step(cols, dels)      # one gossip + merge round

and :func:`fleet_replay` (``replay_trace(route="fleet")``) turns
per-replica v1 blobs into one such round and assembles its outputs
into the same cache and snapshot the cold replay gives. The
segment-sharded and packed-sharded mappings need several devices
(ROADMAP.md queue A item 9).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from crdt_tpu_torch.codec import native
from crdt_tpu_torch.models import replay
from crdt_tpu_torch.obs.tracer import get_tracer
from crdt_tpu_torch.ops.device import (
    _CLOCK_BITS,
    bucket_pow2,
    resolve_device,
    xfer_fetch,
    xfer_put,
)
from crdt_tpu_torch.parallel.delta import COL_NAMES, make_delta_gossip_step
from crdt_tpu_torch.parallel.gossip import (
    fleet_out_sizes,
    make_gossip_step,
    pack_cols,
    pack_dels,
    synth_columns,
    unpack_fleet_out,
)

_MULTI_DEVICE_ITEM = "ROADMAP.md queue A item 9 (multi-device)"


class FleetStep(NamedTuple):
    """Outputs of one gossip+merge round."""

    sv_local: np.ndarray        # [R, C] per-replica state vectors
    global_sv: np.ndarray       # [C] merged swarm vector
    deficit: np.ndarray         # [R, R] anti-entropy plan
    winners: np.ndarray         # [S] converged LWW winner indices
    winner_visible: np.ndarray  # [S] winner not tombstoned
    seq_order: np.ndarray       # [R*N] seq id-sort permutation (union rows)
    seq_seg: np.ndarray         # [R*N] dense sequence id (id-sorted space)
    seq_rank: np.ndarray        # [R*N] YATA document rank (id-sorted space)
    seq_len: np.ndarray         # [S] per-sequence lengths
    map_order: np.ndarray       # [R*N] MAP id-sort perm — winners decode here


class ReplicaFleet:
    """A batch of replicas on one card.

    Static shapes: `n_replicas` x `ops_per_replica` op columns,
    `num_clients`-wide state vectors, `num_segments` convergence
    slots."""

    def __init__(
        self,
        n_replicas: int,
        ops_per_replica: int,
        *,
        device="cuda",
        num_clients: Optional[int] = None,
        num_segments: Optional[int] = None,
    ):
        self.device = resolve_device(device)
        self.n_replicas = n_replicas
        self.ops_per_replica = ops_per_replica
        self.num_clients = num_clients or n_replicas + 2
        total = n_replicas * ops_per_replica
        self.num_segments = num_segments or (
            1 << max(9, (total - 1).bit_length()))
        self._step = make_gossip_step(
            self.num_segments, self.num_clients, device=self.device
        )

    def synth(
        self,
        *,
        num_maps: int = 4,
        keys_per_map: int = 64,
        num_lists: int = 0,
        seq_fraction: float = 0.5,
        seed: int = 0,
    ):
        """Synthetic concurrent-write workload in this fleet's shape."""
        return synth_columns(
            self.n_replicas,
            self.ops_per_replica,
            num_maps=num_maps,
            keys_per_map=keys_per_map,
            num_lists=num_lists,
            seq_fraction=seq_fraction,
            seed=seed,
        )

    def step(
        self,
        cols: Dict[str, np.ndarray],
        dels: Tuple[np.ndarray, np.ndarray, np.ndarray],
    ) -> FleetStep:
        """One full gossip round: fan-in, converge, handshake. One
        upload per operand, one launch sequence, one packed fetch."""
        tracer = get_tracer()
        with tracer.span("fleet.step"):
            out = self._step(
                xfer_put(pack_cols(cols), device=self.device,
                         label="fleet.cols"),
                xfer_put(pack_dels(dels), device=self.device,
                         label="fleet.dels"),
            )
            vec = xfer_fetch(out, label="fleet.out")
        if tracer.enabled:
            tracer.count(
                "fleet.ops_converged", int(np.asarray(cols["valid"]).sum())
            )
        R = self.n_replicas
        N = self.ops_per_replica
        parts = unpack_fleet_out(
            vec, R, N, self.num_clients, self.num_segments
        )
        return FleetStep(**{
            name: parts[name]
            for name, _ in fleet_out_sizes(
                R, N, self.num_clients, self.num_segments
            )
        })

    def delta_round(
        self,
        cols: Dict[str, np.ndarray],
        *,
        budget: int,
    ):
        """One TARGETED anti-entropy round: ship only rows above the
        swarm floor, capped at ``budget`` per replica (see
        :mod:`crdt_tpu_torch.parallel.delta`). One upload per column,
        one launch sequence, one packed fetch.

        Returns ``(svs, deficit, needed_count, delta_cols)`` where
        ``delta_cols`` is the gathered delta union as a column dict in
        the input columns' dtypes."""
        step = make_delta_gossip_step(
            self.num_clients, budget, device=self.device
        )
        out = step(*(
            xfer_put(cols[k], device=self.device, label="fleet.delta_cols")
            for k in COL_NAMES
        ))
        vec = xfer_fetch(
            torch.cat([x.reshape(-1).to(torch.int64) for x in out]),
            label="fleet.delta_out",
        )
        parts, off = [], 0
        for x in out:
            parts.append(vec[off:off + x.numel()].reshape(x.shape))
            off += x.numel()
        svs, deficit, needed = parts[:3]
        delta_cols = {
            name: part.astype(np.asarray(cols[name]).dtype)
            for name, part in zip(COL_NAMES, parts[3:])
        }
        return svs, deficit, needed, delta_cols


# ---------------------------------------------------------------------
# Real-trace ingestion: per-replica v1 wire blobs -> fleet columns.
# ---------------------------------------------------------------------


class FleetTrace(NamedTuple):
    """Per-replica wire blobs staged as fleet-shaped columns.

    - ``cols``: [R, N] kernel columns, client ids DENSELY interned
      (order-preserving, so every client comparison in the kernels is
      unchanged);
    - ``dels``: replicated delete-range triples, same interned space;
    - ``row_map``: [R, N] -> union decode row (-1 padding);
    - ``dec``/``ds``: the union decode + merged delete set (raw id
      space) that :func:`crdt_tpu_torch.models.replay.materialize`
      consumes;
    - ``clients``: interned-id -> raw-client table (interned id i maps
      to ``clients[i - 1]``);
    - ``num_clients``/``num_segments``: the round's static bounds.
    """

    cols: Dict[str, np.ndarray]
    dels: Tuple[np.ndarray, np.ndarray, np.ndarray]
    row_map: np.ndarray
    dec: Dict
    ds: object
    clients: np.ndarray
    num_clients: int
    num_segments: int

    @property
    def n_replicas(self) -> int:
        return self.row_map.shape[0]

    @property
    def ops_per_replica(self) -> int:
        return self.row_map.shape[1]

    @property
    def n_ops(self) -> int:
        return int((self.row_map >= 0).sum())


def load_trace(
    blobs: Sequence[bytes],
    *,
    dec: Optional[Dict] = None,
) -> FleetTrace:
    """Decode one v1 update blob PER REPLICA into the fleet's column
    layout: one row per blob, N the power-of-two bucket of the largest
    replica.

    Ops appearing in several blobs (gossip redelivery) are fine: the
    convergence keeps the first representative of a duplicated id. The
    union must be causally complete. ``dec`` reuses a caller-decoded
    union.

    Known cost: each blob is wire-decoded twice (once in the union for
    one consistent root/key interning, once alone for row
    attribution), as in the reference."""
    blobs = list(blobs)
    if dec is None:
        dec = replay.decode(blobs)
    kcols = native.kernel_columns(dec)
    ds = native.ds_from_triples(dec["ds"])
    n = len(dec["client"])

    # dense order-preserving client interning first: id packing shifts
    # the client by 40 bits, and a raw 32-bit client would alias
    uniq = np.unique(kcols["client"]) if n else np.zeros(1, np.int64)
    if len(uniq) >= (1 << 22):
        raise ValueError(
            f"{len(uniq)} distinct clients exceeds the id-packing bound"
        )

    def intern(a: np.ndarray) -> np.ndarray:
        a = np.asarray(a, np.int64)
        idx = np.searchsorted(uniq, np.clip(a, uniq[0], None))
        idxc = np.clip(idx, 0, len(uniq) - 1)
        return np.where(
            (a >= 0) & (uniq[idxc] == a), idxc + 1, np.where(a < 0, a, 0)
        )

    union_id = (
        intern(kcols["client"]) << _CLOCK_BITS
    ) | kcols["clock"].astype(np.int64)
    sort_idx = np.argsort(union_id, kind="stable")
    sorted_ids = union_id[sort_idx]

    # per-blob row attribution by id: dedup may have dropped a later
    # copy of an op, so every id in any blob resolves by search
    per_rows: List[np.ndarray] = []
    for blob in blobs:
        d = native.decode_updates_columns_any([blob])
        bid = (
            intern(d["client"]) << _CLOCK_BITS
        ) | d["clock"].astype(np.int64)
        if n == 0 or len(bid) == 0:
            per_rows.append(np.empty(0, np.int64))
            continue
        pos = np.clip(np.searchsorted(sorted_ids, bid), 0, n - 1)
        rows = sort_idx[pos]
        hit = union_id[rows] == bid
        per_rows.append(rows[hit].astype(np.int64))

    R = max(len(blobs), 1)
    N = bucket_pow2(max(max((len(r) for r in per_rows), default=1), 1))
    row_map = np.full((R, N), -1, np.int64)
    for r, rows in enumerate(per_rows):
        row_map[r, : len(rows)] = rows

    flat = row_map.reshape(-1)
    sel = np.clip(flat, 0, None)
    pad = flat < 0

    def take(col: np.ndarray, fill) -> np.ndarray:
        if n == 0:
            return np.full((R, N), fill, dtype=col.dtype)
        out = col[sel].copy()
        out[pad] = fill
        return out.reshape(R, N)

    cols = {
        "client": take(intern(kcols["client"]).astype(np.int32), 0),
        "clock": take(kcols["clock"].astype(np.int64), 0),
        "parent_is_root": take(kcols["parent_is_root"], False),
        "parent_a": take(kcols["parent_a"].astype(np.int64), -2),
        "parent_b": take(kcols["parent_b"].astype(np.int64), -2),
        "key_id": take(kcols["key_id"].astype(np.int32), -1),
        "origin_client": take(
            intern(kcols["origin_client"]).astype(np.int32), -1
        ),
        "origin_clock": take(kcols["origin_clock"].astype(np.int64), -1),
        "valid": take(kcols["valid"], False),
    }

    # replicated delete ranges in the interned space (device-side
    # winner visibility; host materialization reuses the RAW ds)
    triples = [
        (int(c), int(k), int(k + ln)) for c, k, ln in ds.iter_all()
    ]
    D = bucket_pow2(max(len(triples), 16))
    d_client = np.full(D, -1, np.int32)
    d_start = np.full(D, -1, np.int64)
    d_end = np.full(D, -1, np.int64)
    if triples:
        tc = intern(np.asarray([t[0] for t in triples], np.int64))
        d_client[: len(triples)] = tc.astype(np.int32)
        d_start[: len(triples)] = [t[1] for t in triples]
        d_end[: len(triples)] = [t[2] for t in triples]

    n_segs = replay.segment_bound(kcols)
    return FleetTrace(
        cols=cols,
        dels=(d_client, d_start, d_end),
        row_map=row_map,
        dec=dec,
        ds=ds,
        clients=uniq,
        num_clients=len(uniq) + 2,
        num_segments=bucket_pow2(max(n_segs, 16)),
    )


def fleet_for_trace(trace: FleetTrace, *, device="cuda") -> ReplicaFleet:
    """A fleet whose static shapes match ``trace``."""
    return ReplicaFleet(
        trace.n_replicas,
        trace.ops_per_replica,
        device=device,
        num_clients=trace.num_clients,
        num_segments=trace.num_segments,
    )


def gather_fleet(trace: FleetTrace, out: FleetStep, *,
                 device) -> Tuple[list, list, dict]:
    """Assemble a fleet round's outputs back into document form: winner
    rows, their visibility, and per-sequence document orders in the
    union decode's row space — the triple
    :func:`crdt_tpu_torch.models.replay.gather` produces, so
    materialization is shared. The round's kernels ignore right
    origins, so every parent with a right-bearing sequence row takes
    the host detour, ranking on ``device``."""
    dec, ds = trace.dec, trace.ds
    rm = trace.row_map.reshape(-1)
    win_rows = _winner_rows(
        rm, np.asarray(out.winners), np.asarray(out.map_order)
    )
    seq_orders = _seq_orders_from(
        dec, rm,
        np.asarray(out.seq_order),
        np.asarray(out.seq_seg),
        np.asarray(out.seq_rank),
    )
    return replay.finish_assembly(dec, ds, win_rows, seq_orders,
                                  device=device)


def _winner_rows(rm: np.ndarray, winners: np.ndarray,
                 map_order: np.ndarray) -> List[int]:
    """Union winner rows from one round's (winners, id-sort perm).
    Winner indices lie in [0, len(map_order)) by construction."""
    w = winners[winners >= 0]
    rows = rm[map_order[w].astype(np.int64)]
    return rows[rows >= 0].astype(np.int64).tolist()


def _seq_orders_from(dec, rm: np.ndarray, sorder: np.ndarray,
                     sseg: np.ndarray, srank: np.ndarray) -> dict:
    """Vectorized per-sequence document orders: ranked positions ->
    union rows grouped by segment, ordered by rank."""
    seq_orders: dict = {}
    pos = np.flatnonzero(srank >= 0)
    if not len(pos):
        return seq_orders
    rows = rm[sorder[pos].astype(np.int64)]
    keep = rows >= 0
    pos, rows = pos[keep], rows[keep]
    if not len(pos):
        return seq_orders
    order2 = np.lexsort((srank[pos], sseg[pos]))
    segs_s = sseg[pos][order2]
    rows_s = rows[order2]
    cuts = np.r_[
        0, np.flatnonzero(segs_s[1:] != segs_s[:-1]) + 1, len(segs_s)
    ]
    for a, b in zip(cuts[:-1], cuts[1:]):
        chunk = rows_s[a:b].astype(np.int64).tolist()
        seq_orders[replay.parent_spec(dec, chunk[0])] = chunk
    return seq_orders


def fleet_replay(
    blobs: Sequence[bytes],
    *,
    device="cuda",
    trace: Optional[FleetTrace] = None,
    fleet: Optional[ReplicaFleet] = None,
    shard: str = "auto",
) -> replay.ReplayResult:
    """One-shot PRODUCT entry: per-replica update blobs in, converged
    cache + compacted snapshot out, convergence computed as ONE gossip
    + merge round on ``device`` (the card unless the caller asks for
    the CPU). This is ``replay_trace(route="fleet")``'s engine.

    ``shard``: ``"auto"`` and ``"replicas"`` run the replicated round
    (on one card the reference's auto resolves to it too);
    ``"segments"`` and ``"sharded"`` divide the work over several
    devices and raise ``NotImplementedError`` until that is ported."""
    if shard in ("segments", "sharded"):
        raise NotImplementedError(
            f"shard={shard!r} divides the round over several devices, "
            f"which is not ported yet ({_MULTI_DEVICE_ITEM})"
        )
    if shard not in ("auto", "replicas"):
        raise ValueError(f"unknown shard mode {shard!r}")
    dev = fleet.device if fleet is not None else resolve_device(device)
    tracer = get_tracer()
    if trace is None:
        dec = replay.decode(blobs)
        with tracer.span("fleet.load"):
            trace = load_trace(blobs, dec=dec)
    if fleet is None:
        fleet = fleet_for_trace(trace, device=dev)
    elif (
        trace.num_clients > fleet.num_clients
        or trace.num_segments > fleet.num_segments
        or trace.row_map.shape != (fleet.n_replicas, fleet.ops_per_replica)
    ):
        # shapes alone can match a fleet whose client/segment tables are
        # too small; reuse requires the trace to fit its bounds
        raise ValueError(
            f"trace buckets (R,N)={trace.row_map.shape} "
            f"clients={trace.num_clients} "
            f"segments={trace.num_segments} do not fit the reused "
            f"fleet (R,N)=({fleet.n_replicas},{fleet.ops_per_replica}) "
            f"clients={fleet.num_clients} "
            f"segments={fleet.num_segments}"
        )
    out = fleet.step(trace.cols, trace.dels)
    with tracer.span("gather"):
        win_rows, win_vis, seq_orders = gather_fleet(trace, out, device=dev)
    cache = replay.materialize(trace.dec, trace.ds, win_rows, win_vis,
                               seq_orders)
    return replay.ReplayResult(
        cache=cache,
        snapshot=replay.compact(trace.dec, trace.ds),
        n_ops=trace.n_ops,
        path="fleet",
    )
