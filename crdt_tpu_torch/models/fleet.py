"""ReplicaFleet — the replica-fleet round, on one device or a mesh.

The port's counterpart of ``crdt_tpu.models.fleet``. The reference's
scale axis is replica parallelism: N peers full-mesh gossiping updates
and converging by CRDT merge (propagate at crdt.js:385,445;
merge-on-receipt at crdt.js:294; the state-vector handshake at
crdt.js:237-291). Here that whole swarm round is one launch sequence,
with the replica axis as a batch axis on one device, or spread over the
entries of a mesh (:mod:`crdt_tpu_torch.parallel.mesh`) and gathered in
two tiers on a (hosts, replicas) one:

    fleet = ReplicaFleet(n_replicas=1000, ops_per_replica=128)
    out = fleet.step(cols, dels)      # one gossip + merge round

:func:`fleet_replay` (``replay_trace(route="fleet")``) turns per-replica
v1 blobs into one such round and assembles its outputs into the same
cache and snapshot the cold replay gives, beside the round's
anti-entropy plan (:class:`FleetPlan`); its ``shard=`` picks the
mapping: the replicated round, the work-divided segment round
(:class:`SegmentedFleet`) or the sharded packed converge
(:mod:`crdt_tpu_torch.ops.shard`).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from crdt_tpu_torch.codec import native
from crdt_tpu_torch.models import replay
from crdt_tpu_torch.obs.tracer import get_tracer
from crdt_tpu_torch.ops.device import (
    bucket_pow2,
    resolve_device,
    xfer_fetch,
    xfer_put,
)
from crdt_tpu_torch.parallel.delta import COL_NAMES, make_delta_gossip_step
from crdt_tpu_torch.parallel.gossip import (
    HOST_AXIS,
    Mesh,
    entries,
    fleet_out_sizes,
    make_gossip_step,
    make_hierarchical_gossip_step,
    make_segment_sharded_step,
    pack_cols,
    pack_dels,
    segment_out_sizes,
    synth_columns,
    unpack_fleet_out,
)
from crdt_tpu_torch.parallel.mesh import home, local_entries, mesh_for


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


class FleetPlan(NamedTuple):
    """A swarm round's anti-entropy plan (the state-vector handshake,
    crdt.js:237-291), keyed by client id: column ``k`` of the vectors
    is client ``clients[k]``, row ``i`` is the peer of blob ``i``.
    Every field is :class:`FleetStep`'s, computed on the device."""

    clients: np.ndarray   # [C] raw client ids, ascending
    peer_sv: np.ndarray   # [R, C] next clock of each client a peer holds
    swarm_sv: np.ndarray  # [C] the swarm vector: the peers' max
    deficit: np.ndarray   # [R, R] clocks peer i holds that peer j lacks

    def vector(self, peer: int) -> Dict[int, int]:
        """Peer ``peer``'s state vector as Yjs writes it: client id ->
        next clock, for the clients it holds anything of."""
        row = self.peer_sv[peer]
        held = np.flatnonzero(row)
        return dict(zip(self.clients[held].tolist(), row[held].tolist()))


class ReplicaFleet:
    """A batch of replicas on one device or over a mesh.

    Static shapes: `n_replicas` x `ops_per_replica` op columns,
    `num_clients`-wide state vectors, `num_segments` convergence slots.
    ``mesh`` (default :func:`~crdt_tpu_torch.parallel.mesh.mesh_for`
    ``(device, n_devices)``: one entry on one card or on the CPU)
    spreads the replicas, which must divide over its entries: a
    one-entry mesh runs :func:`make_gossip_step` on that device, a
    (hosts, replicas) mesh the two-tier
    :func:`make_hierarchical_gossip_step`, and a 1D mesh of several
    entries the same step as one host of them (on a pod of processes,
    one host row a process). On a pod each process uploads only its
    own entries' replicas and every process returns the same step."""

    def __init__(
        self,
        n_replicas: int,
        ops_per_replica: int,
        *,
        mesh: Optional[Mesh] = None,
        n_devices: Optional[int] = None,
        device="cuda",
        num_clients: Optional[int] = None,
        num_segments: Optional[int] = None,
    ):
        self.mesh = mesh if mesh is not None else mesh_for(device,
                                                           n_devices)
        devs = entries(self.mesh)
        if n_replicas % len(devs):
            raise ValueError(
                f"n_replicas={n_replicas} must divide over {len(devs)} "
                "mesh entries"
            )
        self.device = resolve_device(home(self.mesh))
        self.n_replicas = n_replicas
        self.ops_per_replica = ops_per_replica
        self.num_clients = num_clients or n_replicas + 2
        total = n_replicas * ops_per_replica
        self.num_segments = num_segments or (
            1 << max(9, (total - 1).bit_length()))
        self._entries = None  # one device: no per-entry upload
        if len(self.mesh.axis_names) == 2 or len(devs) > 1:
            grid = self.mesh
            if len(grid.axis_names) == 1:
                # one host row, or on a pod one row a process
                rows = grid.pod.world if grid.pod is not None else 1
                grid = grid._replace(
                    devices=grid.devices.reshape(rows, -1),
                    axis_names=(HOST_AXIS, grid.axis_names[0]))
            self._entries = dict(local_entries(self.mesh))
            self._step = make_hierarchical_gossip_step(
                grid, self.num_segments, self.num_clients
            )
        else:
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
            blk = pack_cols(cols)
            if self._entries is None:
                blk_on = xfer_put(blk, device=self.device,
                                  label="fleet.cols")
            else:
                # each entry's replicas onto the entry, in mesh order
                # (on a pod, this process's entries only)
                nd = self.mesh.devices.size
                r = self.n_replicas // nd
                blk_on = [
                    xfer_put(blk[:, k * r:(k + 1) * r],
                             device=self._entries[k], label="fleet.cols")
                    if k in self._entries else None
                    for k in range(nd)
                ]
            out = self._step(
                blk_on,
                xfer_put(pack_dels(dels), device=self.device,
                         label="fleet.dels"),
            )
            vec = xfer_fetch(out, label="fleet.out")
        R = self.n_replicas
        N = self.ops_per_replica
        if tracer.enabled:
            tracer.count(
                "fleet.ops_converged", int(np.asarray(cols["valid"]).sum())
            )
            tracer.count("fleet.slots", R * N)
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
        one launch sequence on the mesh's first entry, one packed
        fetch. Requires a 1D mesh.

        Returns ``(svs, deficit, needed_count, delta_cols)`` where
        ``delta_cols`` is the gathered delta union as a column dict in
        the input columns' dtypes."""
        if len(self.mesh.axis_names) != 1:
            raise ValueError("delta rounds run on a 1D replica mesh")
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
    replicas_multiple: int = 1,
    ops_bucket: Optional[int] = None,
    dec: Optional[Dict] = None,
) -> FleetTrace:
    """Decode one v1 update blob PER REPLICA into the fleet's column
    layout: one row per blob, N the power-of-two bucket of the largest
    replica.

    Ops appearing in several blobs (gossip redelivery) are fine: the
    convergence keeps the first representative of a duplicated id. The
    union must be causally complete. ``replicas_multiple`` pads the
    replica count (empty all-invalid replicas) so R divides over a mesh
    of that many entries; ``ops_bucket`` pins N (padded per-replica op
    capacity) so several traces share one fleet's shapes. ``dec``
    reuses a caller-decoded union.

    A replica's rows come from the union's one parse: the codec reports
    each blob's row count (``blob_rows``) and dedup maps every parsed
    row to the union row that kept its id (``survivor``), so the layout
    is one array pass and no blob is decoded again. A ``dec`` that is
    not ``replay.decode(blobs)`` raises."""
    blobs = list(blobs)
    if dec is None:
        dec = replay.decode(blobs)
    kcols = native.kernel_columns(dec)
    ds = native.ds_from_triples(dec["ds"])
    n = len(dec["client"])
    # blob b's rows are rows[start[b]:start[b] + counts[b]]
    counts = dec.get("blob_rows")
    rows = dec.get("survivor", np.arange(n))
    if counts is None or len(counts) != len(blobs) \
            or int(counts.sum()) != len(rows):
        raise ValueError("dec is not the union of these blobs")

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

    tracer = get_tracer()
    if tracer.enabled:
        # rows every blob held past the union's one copy of each id
        tracer.count("fleet.redelivered", len(rows) - n)
    r_raw = max(len(blobs), 1)
    R = -(-r_raw // replicas_multiple) * replicas_multiple
    widest = int(counts.max()) if len(counts) else 0
    N = ops_bucket or bucket_pow2(max(widest, 1))
    if widest > N:
        raise ValueError(
            f"ops_bucket={N} below a replica's {widest} rows"
        )
    row_map = np.full((R, N), -1, np.int64)
    peer = np.repeat(np.arange(len(counts)), counts)
    start = np.cumsum(counts) - counts
    row_map[peer, np.arange(len(rows)) - start[peer]] = rows

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


def plan_of(trace: FleetTrace, out: FleetStep, n_peers: int) -> FleetPlan:
    """``out``'s handshake fields mapped back to client ids, for the
    first ``n_peers`` replicas (the blobs; the rest pad R to a mesh).
    Interned id ``i`` is client ``trace.clients[i - 1]``, so the
    vectors' columns 1..C are the clients in order."""
    c = len(trace.clients) if len(trace.dec["client"]) else 0
    return FleetPlan(
        clients=trace.clients[:c].astype(np.int64),
        peer_sv=out.sv_local[:n_peers, 1:c + 1].copy(),
        swarm_sv=out.global_sv[1:c + 1].copy(),
        deficit=out.deficit[:n_peers, :n_peers].copy(),
    )


def fleet_for_trace(trace: FleetTrace, *, mesh: Optional[Mesh] = None,
                    n_devices: Optional[int] = None,
                    device="cuda") -> ReplicaFleet:
    """A fleet whose static shapes match ``trace``."""
    return ReplicaFleet(
        trace.n_replicas,
        trace.ops_per_replica,
        mesh=mesh,
        n_devices=n_devices,
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
                     sseg: np.ndarray, srank: np.ndarray,
                     into: Optional[dict] = None) -> dict:
    """Vectorized per-sequence document orders: ranked positions ->
    union rows grouped by segment, ordered by rank (added to ``into``
    when given)."""
    seq_orders: dict = {} if into is None else into
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


class SegStep(NamedTuple):
    """Outputs of one segment-sharded round (local spaces per entry;
    see :func:`crdt_tpu_torch.parallel.gossip.make_segment_sharded_step`).
    ``svs``/``global_sv`` are the trace's host-built handshake vectors,
    carried here for parity with :class:`FleetStep`."""

    svs: np.ndarray             # [R, C] per-replica own-op vectors
    global_sv: np.ndarray       # [C]
    deficit: np.ndarray         # [R, R]
    winners: np.ndarray         # [nd, S] local id-sorted winner indices
    winner_visible: np.ndarray  # [nd, S]
    seq_order: np.ndarray       # [nd, N_d] local id-sort permutations
    seq_seg: np.ndarray         # [nd, N_d] per-entry dense sequence ids
    seq_rank: np.ndarray        # [nd, N_d]
    seq_len: np.ndarray         # [nd, S]
    map_order: np.ndarray       # [nd, N_d]


class ShardedTrace(NamedTuple):
    """A :class:`FleetTrace` re-partitioned BY SEGMENT over a mesh: one
    entry owns every row of each (parent, key) chain and each sequence,
    so convergence divides across entries instead of replicating.
    ``row_map`` is [nd, N_d] -> union decode row."""

    cols: Dict[str, np.ndarray]  # [nd, N_d], incl. "replica"
    dels: Tuple[np.ndarray, np.ndarray, np.ndarray]
    row_map: np.ndarray
    dec: Dict
    ds: object
    n_replicas: int
    num_clients: int
    num_segments: int  # per-entry bound
    svs: np.ndarray    # [R, C] host-built per-replica own-op vectors
    global_sv: np.ndarray  # [C]

    @property
    def n_devices(self) -> int:
        return self.row_map.shape[0]

    @property
    def n_ops(self) -> int:
        return int((self.row_map >= 0).sum())


def shard_trace(trace: FleetTrace, n_devices: int) -> ShardedTrace:
    """Partition a replica-sharded trace's union BY SEGMENT into
    ``n_devices`` balanced shards (greedy largest-first by row count).
    Rows keep a ``replica`` attribution column so the SV handshake can
    still produce every replica's own-op vector."""
    N = trace.ops_per_replica
    flat_valid = trace.cols["valid"].reshape(-1)
    idx = np.flatnonzero(flat_valid)
    replica = (idx // N).astype(np.int32)
    cf = {k: v.reshape(-1)[idx] for k, v in trace.cols.items()}
    union_rows = trace.row_map.reshape(-1)[idx]

    segkey = replay.segment_key(cf["parent_a"], cf["key_id"])
    uniq_sk, seg_inv, seg_counts = np.unique(
        segkey, return_inverse=True, return_counts=True
    )
    # greedy balance: largest segments first, always into the lightest
    # bin (a single huge sequence still bounds the critical path)
    bins = np.zeros(len(uniq_sk), np.int32)
    loads = np.zeros(n_devices, np.int64)
    segs_per = np.zeros(n_devices, np.int64)
    for s in np.argsort(-seg_counts):
        b = int(np.argmin(loads))
        bins[s] = b
        loads[b] += int(seg_counts[s])
        segs_per[b] += 1
    row_bin = bins[seg_inv]

    N_d = bucket_pow2(max(int(loads.max()), 16))
    nd = n_devices
    defaults = {
        "client": 0, "clock": 0, "parent_is_root": False,
        "parent_a": -2, "parent_b": -2, "key_id": -1,
        "origin_client": -1, "origin_clock": -1, "valid": False,
    }
    cols = {
        k: np.full((nd, N_d), fill, dtype=cf[k].dtype)
        for k, fill in defaults.items()
    }
    cols["replica"] = np.zeros((nd, N_d), np.int32)
    row_map = np.full((nd, N_d), -1, np.int64)
    for b in range(nd):
        sel = np.flatnonzero(row_bin == b)
        for k in defaults:
            cols[k][b, : len(sel)] = cf[k][sel]
        cols["replica"][b, : len(sel)] = replica[sel]
        row_map[b, : len(sel)] = union_rows[sel]
    # the handshake's per-replica own-op vectors: a pure O(rows)
    # function of the staged columns, built here once on the host; the
    # mesh keeps only the O(R^2 C) pairwise deficit, rows divided
    R = trace.n_replicas
    C = trace.num_clients
    svs = np.zeros((R, C), np.int64)
    if len(idx):
        np.maximum.at(
            svs,
            (replica, cf["client"].astype(np.int64)),
            cf["clock"].astype(np.int64) + 1,
        )
    return ShardedTrace(
        cols=cols,
        dels=trace.dels,
        row_map=row_map,
        dec=trace.dec,
        ds=trace.ds,
        n_replicas=R,
        num_clients=C,
        num_segments=bucket_pow2(max(int(segs_per.max()), 16)),
        svs=svs,
        global_sv=svs.max(axis=0) if R else np.zeros(C, np.int64),
    )


class SegmentedFleet:
    """The segment-sharded sibling of :class:`ReplicaFleet` — the mode
    where the mesh DIVIDES merge work instead of replicating it. Static
    shapes come from the staged trace; any trace staged with the same
    buckets reuses the fleet."""

    def __init__(
        self,
        sharded: ShardedTrace,
        *,
        mesh: Optional[Mesh] = None,
        n_devices: Optional[int] = None,
        device="cuda",
    ):
        self.mesh = mesh if mesh is not None else mesh_for(device,
                                                           n_devices)
        self._entries = dict(local_entries(self.mesh))
        nd = self.mesh.devices.size
        if sharded.n_devices != nd:
            raise ValueError(
                f"trace sharded for {sharded.n_devices} devices, "
                f"mesh has {nd}"
            )
        self.device = resolve_device(home(self.mesh))
        self.num_clients = sharded.num_clients
        self.num_segments = sharded.num_segments
        self.n_replicas = sharded.n_replicas
        self._step = make_segment_sharded_step(
            self.mesh,
            num_segments=sharded.num_segments,
            n_replicas=sharded.n_replicas,
        )

    def step(self, sharded: ShardedTrace) -> SegStep:
        """One upload of each entry's block onto it (and of the vectors
        and deletes onto the first entry), the per-entry launch
        sequences, one packed fetch (the entries' blocks gathered into
        one vector)."""
        # reuse is only sound when the trace fits the bounds this fleet
        # was built with: a larger segment bucket would overflow the
        # segment table, and a replica or mesh mismatch would unpack the
        # output vector at wrong offsets
        nd_mesh = self.mesh.devices.size
        if (
            sharded.n_devices != nd_mesh
            or sharded.n_replicas != self.n_replicas
            or sharded.num_segments > self.num_segments
        ):
            raise ValueError(
                f"sharded trace (devices={sharded.n_devices}, "
                f"replicas={sharded.n_replicas}, "
                f"segments={sharded.num_segments}) does not fit the "
                f"SegmentedFleet (devices={nd_mesh}, "
                f"replicas={self.n_replicas}, "
                f"segments={self.num_segments})"
            )
        tracer = get_tracer()
        nd, N_d = sharded.row_map.shape
        R = self.n_replicas
        blk = -(-R // nd)
        with tracer.span("fleet.seg_step"):
            packed = pack_cols(sharded.cols)  # [9, nd, N_d]
            parts = [
                xfer_put(packed[:, d], device=self._entries[d],
                         label="fleet.cols")
                if d in self._entries else None
                for d in range(nd)
            ]
            out = self._step(
                parts,
                xfer_put(sharded.svs, device=self.device,
                         label="fleet.svs"),
                xfer_put(pack_dels(sharded.dels), device=self.device,
                         label="fleet.dels"),
            )
            vec = xfer_fetch(out, label="fleet.out").reshape(nd, -1)
        sizes = segment_out_sizes(blk, R, N_d, self.num_segments)
        parts_out: Dict[str, np.ndarray] = {}
        off = 0
        for name, size in sizes:
            parts_out[name] = vec[:, off: off + size]
            off += size
        deficit = parts_out["deficit"].reshape(nd * blk, R)[:R]
        return SegStep(
            svs=sharded.svs,
            global_sv=sharded.global_sv,
            deficit=deficit,
            winners=parts_out["winners"],
            winner_visible=parts_out["winner_visible"],
            seq_order=parts_out["seq_order"],
            seq_seg=parts_out["seq_seg"],
            seq_rank=parts_out["seq_rank"],
            seq_len=parts_out["seq_len"],
            map_order=parts_out["map_order"],
        )


def gather_sharded(sharded: ShardedTrace, out: SegStep, *,
                   device) -> Tuple[list, list, dict]:
    """Assemble a segment-sharded round back into document form (the
    per-entry blocks are independent segment sets, so assembly is a
    concatenation keyed by (entry, local segment)); right-bearing
    parents take the host detour, ranking on ``device``."""
    dec, ds = sharded.dec, sharded.ds
    win_rows: List[int] = []
    seq_orders: dict = {}
    for d in range(sharded.n_devices):  # disjoint segments: no merging
        rm = sharded.row_map[d]
        win_rows.extend(_winner_rows(
            rm, np.asarray(out.winners[d]), np.asarray(out.map_order[d])
        ))
        _seq_orders_from(
            dec, rm,
            np.asarray(out.seq_order[d]),
            np.asarray(out.seq_seg[d]),
            np.asarray(out.seq_rank[d]),
            into=seq_orders,
        )
    return replay.finish_assembly(dec, ds, win_rows, seq_orders,
                                  device=device)


def fleet_replay(
    blobs: Sequence[bytes],
    *,
    device="cuda",
    mesh: Optional[Mesh] = None,
    n_devices: Optional[int] = None,
    trace: Optional[FleetTrace] = None,
    fleet: Optional[ReplicaFleet] = None,
    shard: str = "auto",
) -> replay.ReplayResult:
    """One-shot PRODUCT entry: per-replica update blobs in, converged
    cache + compacted snapshot out, convergence computed as ONE gossip
    + merge round over a mesh (``mesh``, else the fleet's, else
    :func:`~crdt_tpu_torch.parallel.mesh.mesh_for` ``(device,
    n_devices)``: one entry on one card or on the CPU). This is
    ``replay_trace(route="fleet")``'s engine.

    ``shard`` picks the mapping:

    - ``"auto"`` (default) — ``"sharded"`` when the mesh has more than
      one entry (and no prebuilt ``trace``/``fleet`` pins the
      replicated layout) and the union reaches
      ``CRDT_TPU_SHARD_MIN_ROWS``, else ``"replicas"``;
    - ``"sharded"`` — the union's staged PACKED layout partitions by
      whole segments over the mesh
      (:mod:`crdt_tpu_torch.ops.shard`); byte-identical to the one-device
      cold replay. A union the sharded stager refuses falls through to
      ``"replicas"``, reusing the decoded union;
    - ``"replicas"`` — the reference's full-mesh shape: every replica's
      columns gathered, the union converged once; the result's
      ``plan`` is the round's anti-entropy plan (:class:`FleetPlan`:
      each blob's peer's state vector, the swarm vector and the
      pairwise deficit, keyed by client id), ``None`` on the other
      mappings;
    - ``"segments"`` — the work-divided round over the general kernels
      (:class:`SegmentedFleet`): each entry converges only its segment
      shard."""
    if shard not in ("auto", "replicas", "sharded", "segments"):
        raise ValueError(f"unknown shard mode {shard!r}")
    if mesh is None and fleet is not None:
        mesh = fleet.mesh
    if mesh is None:
        mesh = mesh_for(device, n_devices)
    nd = mesh.devices.size
    dev = resolve_device(home(mesh))
    tracer = get_tracer()
    auto = shard == "auto"
    if auto:
        # a caller-prebuilt trace/fleet pins the replicated layout
        shard = ("sharded" if nd > 1 and fleet is None and trace is None
                 else "replicas")
    shared_dec = None
    if shard == "sharded":
        from crdt_tpu_torch.ops import shard as shard_ops

        # the sharded route needs only the decoded UNION, never the
        # replicated [R, N] layout load_trace builds
        dec = trace.dec if trace is not None else replay.decode(blobs)
        # an auto-resolved mapping honors the size gate BEFORE paying
        # the staging pass (an explicit "sharded" always shards)
        splan = None
        if not auto or shard_ops.active_for(len(dec["client"]), nd):
            cols, ds = replay.stage(dec)
            splan = shard_ops.stage(cols, n_shards=nd)
        if splan is not None:
            res = shard_ops.converge(splan, mesh=mesh)
            with tracer.span("gather"):
                win_rows, win_vis, seq_orders = replay.gather(
                    dec, ds, ("packed", res), device=dev)
            cache = replay.materialize(dec, ds, win_rows, win_vis,
                                       seq_orders)
            return replay.ReplayResult(
                cache=cache,
                snapshot=replay.compact(dec, ds),
                n_ops=len(dec["client"]),
                path="fleet-sharded",
            )
        # too small (auto) or past the packed bounds: the replicated
        # mapping, reusing the decoded union; its trace needs R padded
        # to the mesh
        shard = "replicas"
        if trace is None:
            shared_dec = dec
        elif trace.n_replicas % nd:
            trace = None
    plan = None
    if shard == "segments":
        if trace is None:
            dec = replay.decode(blobs)
            with tracer.span("fleet.load"):
                trace = load_trace(blobs, dec=dec)
        sharded = shard_trace(trace, nd)
        out = SegmentedFleet(sharded, mesh=mesh).step(sharded)
        with tracer.span("gather"):
            win_rows, win_vis, seq_orders = gather_sharded(
                sharded, out, device=dev)
    else:
        if trace is None:
            dec = shared_dec if shared_dec is not None else \
                replay.decode(blobs)
            with tracer.span("fleet.load"):
                trace = load_trace(blobs, replicas_multiple=nd, dec=dec)
        if fleet is None:
            fleet = fleet_for_trace(trace, mesh=mesh)
        elif (
            trace.num_clients > fleet.num_clients
            or trace.num_segments > fleet.num_segments
            or trace.row_map.shape
            != (fleet.n_replicas, fleet.ops_per_replica)
        ):
            # shapes alone can match a fleet whose client/segment
            # tables are too small; reuse requires the trace to fit
            raise ValueError(
                f"trace buckets (R,N)={trace.row_map.shape} "
                f"clients={trace.num_clients} "
                f"segments={trace.num_segments} do not fit the reused "
                f"fleet (R,N)=({fleet.n_replicas},"
                f"{fleet.ops_per_replica}) "
                f"clients={fleet.num_clients} "
                f"segments={fleet.num_segments}"
            )
        out = fleet.step(trace.cols, trace.dels)
        with tracer.span("fleet.plan"):
            plan = plan_of(trace, out,
                           min(len(blobs), trace.n_replicas))
        with tracer.span("gather"):
            win_rows, win_vis, seq_orders = gather_fleet(trace, out,
                                                         device=dev)
    cache = replay.materialize(trace.dec, trace.ds, win_rows, win_vis,
                               seq_orders)
    return replay.ReplayResult(
        cache=cache,
        snapshot=replay.compact(trace.dec, trace.ds),
        n_ops=trace.n_ops,
        path="fleet",
        plan=plan,
    )
