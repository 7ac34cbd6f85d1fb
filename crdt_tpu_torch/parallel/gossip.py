"""The gossip + merge rounds, on one device or over a mesh.

The port's counterpart of ``crdt_tpu.parallel.gossip``. On one device
(:func:`make_gossip_step`) the replica axis is a batch axis and the
all-gather is the identity, so the round is:

- per-replica state vectors (a batched scatter-max) and their merge;
- the pairwise anti-entropy plan (the ``sv_deficit`` kernel);
- ``propagate``: the union of every replica's op columns (a reshape);
- every peer's ``applyUpdate`` on that union: ``converge_maps`` (with
  the ``ds_mask`` kernel for tombstones) and ``converge_sequences``.

One packed int64 block comes in per operand and ONE flat int64 vector
goes out, at the reference's static offsets (:func:`fleet_out_sizes`).

Over a mesh (:mod:`crdt_tpu_torch.parallel.mesh`, re-exported here
under the reference's names) the steps run as the reference's one
``shard_map`` program does: one process drives every entry, or, on a
pod of processes (a ``torch.distributed`` group), each process runs the
same step on the same inputs, works only on its own entries and ends
holding the same replicated output:

- :func:`make_hierarchical_gossip_step` — the two-tier fan-in of a
  (hosts, replicas) mesh: per-entry state vectors, then the replicas
  axis and the hosts axis gathered in turn onto the first entry, where
  the union converges once (``ds_mask`` through ``converge_maps``,
  ``sv_deficit`` through ``statevec.missing``);
- :func:`make_segment_sharded_step` — the work-divided round: each
  entry converges only its segment shard (one ``ds_mask`` launch an
  entry) and scans its block of the deficit rows;
- :func:`make_packed_shard_step` — the sharded packed converge of
  :mod:`crdt_tpu_torch.ops.shard` (one ``seg_argmax_scan`` and one
  ``stream_scatter`` launch an entry) and its boundary exchange;
- :class:`GossipFaultPlan` / :func:`mask_packed` — seeded drops and
  partitions of fleet rounds.
"""

from __future__ import annotations

import zlib
from contextlib import nullcontext
from typing import Optional

import numpy as np
import torch

from crdt_tpu_torch.obs.recorder import get_recorder
from crdt_tpu_torch.ops import statevec
from crdt_tpu_torch.ops.device import resolve_device
from crdt_tpu_torch.ops.merge import converge_maps
from crdt_tpu_torch.ops.packed import _converge_packed_body, _decode_sections
from crdt_tpu_torch.ops.staging import _section_sizes
from crdt_tpu_torch.ops.yata import converge_sequences
from crdt_tpu_torch.parallel.mesh import (  # noqa: F401  (re-exports)
    HOST_AXIS,
    REPLICA_AXIS,
    Mesh,
    all_gather,
    all_gather2,
    RemoteEntry,
    broadcast,
    entries,
    home,
    local_entries,
    make_mesh,
    make_mesh2d,
)

COL_PACK_ORDER = (
    "client", "clock", "parent_is_root", "parent_a", "parent_b",
    "key_id", "origin_client", "origin_clock", "valid",
)


def pack_cols(cols) -> np.ndarray:
    """[9, R, N] int64 from the fleet column dict (host-side)."""
    return np.stack(
        [np.asarray(cols[k]).astype(np.int64) for k in COL_PACK_ORDER]
    )


def pack_dels(dels) -> np.ndarray:
    """[3, D] int64 from the delete triples (host-side)."""
    return np.stack([np.asarray(d).astype(np.int64) for d in dels])


def _unpack_cols(packed: torch.Tensor):
    """Device-side: the nine typed columns from one int64 block."""
    client = packed[0].to(torch.int32)
    clock = packed[1]
    pir = packed[2] != 0
    pa = packed[3]
    pb = packed[4]
    kid = packed[5].to(torch.int32)
    oc = packed[6].to(torch.int32)
    ock = packed[7]
    valid = packed[8] != 0
    return client, clock, pir, pa, pb, kid, oc, ock, valid


def fleet_out_sizes(R: int, N: int, C: int, S: int):
    """Static (name, size) layout of the round's one packed output
    vector."""
    RN = R * N
    return (
        ("sv_local", R * C),
        ("global_sv", C),
        ("deficit", R * R),
        ("winners", S),
        ("winner_visible", S),
        ("seq_order", RN),
        ("seq_seg", RN),
        ("seq_rank", RN),
        ("seq_len", S),
        ("map_order", RN),
    )


def unpack_fleet_out(vec: np.ndarray, R: int, N: int, C: int, S: int):
    """Host-side: named arrays (original shapes) from the one fetch."""
    out = {}
    off = 0
    for name, size in fleet_out_sizes(R, N, C, S):
        out[name] = vec[off: off + size]
        off += size
    out["sv_local"] = out["sv_local"].reshape(R, C)
    out["deficit"] = out["deficit"].reshape(R, R)
    return out


def make_gossip_step(num_segments: int, num_clients: int, *, device):
    """The full gossip + merge round for one card.

    Step input: ONE packed [9, R, N] int64 block (:func:`pack_cols`)
    holding every replica's pending op columns, plus one [3, D] delete
    block (:func:`pack_dels`), both on ``device``. Output: ONE flat
    int64 vector on the same device (:func:`unpack_fleet_out` slices
    it) holding ``sv_local`` [R, C], ``global_sv`` [C], ``deficit``
    [R, R], ``winners``/``winner_visible`` [S], ``seq_order``/
    ``seq_seg``/``seq_rank`` [R*N], ``seq_len`` [S] and ``map_order``
    [R*N] — field for field the reference's."""
    device = resolve_device(device)

    def step(packed: torch.Tensor, dels: torch.Tensor) -> torch.Tensor:
        if packed.device != device or dels.device != device:
            raise ValueError(f"the step was built for {device}, got "
                             f"{packed.device} and {dels.device}")
        cols = _unpack_cols(packed)
        client, clock, valid = cols[0], cols[1], cols[8]
        d_client, d_start, d_end = dels[0], dels[1], dels[2]

        # handshake: per-replica state vectors (the replica axis is a
        # batch axis), the swarm vector and the pairwise plan
        svs = statevec.build(client, clock, valid, num_clients)
        global_sv = statevec.merge(svs)
        deficit = statevec.missing(svs)

        # propagate: the union every replica holds after a full round
        union = [x.reshape(-1) for x in cols]
        map_order, _, winners, winner_visible, _, _ = converge_maps(
            *union, d_client, d_start, d_end, num_segments=num_segments,
        )
        seq_order, seq_seg, seq_rank, seq_len = converge_sequences(
            *union, num_segments=num_segments,
        )
        return torch.cat([
            x.reshape(-1).to(torch.int64)
            for x in (svs, global_sv, deficit, winners, winner_visible,
                      seq_order, seq_seg, seq_rank, seq_len, map_order)
        ])

    return step


def _on(dev: torch.device):
    """Make ``dev`` the current card for an entry's launches."""
    return torch.cuda.device(dev) if dev.type == "cuda" else nullcontext()


def _check_parts(parts, mesh: Mesh, what: str) -> None:
    """One part an entry of ``mesh``, each on its entry; on a pod a
    remote entry's slot is None (a process holds only its own)."""
    devs = entries(mesh)
    if len(parts) != len(devs):
        raise ValueError(f"{what}: {len(parts)} parts for a mesh of "
                         f"{len(devs)} entries")
    for k, (p, dev) in enumerate(zip(parts, devs)):
        if isinstance(dev, RemoteEntry):
            if p is not None:
                raise ValueError(f"{what}: entry {k} belongs to rank "
                                 f"{dev.rank}; this process holds no "
                                 "part of it")
        elif p is None or p.device != dev:
            raise ValueError(f"{what}: entry {k} lies on "
                             f"{None if p is None else p.device}, "
                             f"the mesh puts it on {dev}")


def make_hierarchical_gossip_step(mesh: Mesh, num_segments: int,
                                  num_clients: int):
    """Two-tier gossip over a (hosts, replicas) mesh: the fan-in is a
    gather over the replicas axis followed by one over the hosts axis
    (:func:`~crdt_tpu_torch.parallel.mesh.all_gather2`) — the
    reference's full-mesh swarm mapped onto a pod's fabric instead of
    one flat collective. The output vector equals
    :func:`make_gossip_step`'s on the same flattened columns.

    Step inputs: one packed [9, r, N] int64 block an entry (the
    entry's r = R / entries replicas, mesh order, on the entry) and
    the packed [3, D] deletes on the first entry (:func:`home`: on a
    pod, this process's first entry; a remote entry's block is None).
    Each entry builds its replicas' state vectors; the union and the
    vectors gather onto the first entry, which converges the union
    once (on a pod every process does: the reference's replicated
    compute): the output vector is the one the reference replicates
    on every device."""
    if len(mesh.axis_names) != 2:
        raise ValueError("the two-tier step runs on a (hosts, replicas) "
                         "mesh")
    dev0 = home(mesh)
    local = local_entries(mesh)

    def step(parts, dels: torch.Tensor) -> torch.Tensor:
        _check_parts(parts, mesh, "hierarchical step")
        if dels.device != dev0:
            raise ValueError(f"the deletes must lie on {dev0}")
        sv_parts = [None] * len(parts)
        for k, dev in local:
            with _on(dev):
                cols = _unpack_cols(parts[k])
                sv_parts[k] = statevec.build(cols[0], cols[1], cols[8],
                                             num_clients)
        with _on(dev0):
            svs = all_gather2(sv_parts, mesh).reshape(-1, num_clients)
            global_sv = statevec.merge(svs)
            deficit = statevec.missing(svs)
            # [entries, 9, r, N] -> [9, R, N] in the flat row order
            blk = all_gather2(parts, mesh)
            blk = blk.transpose(0, 1).reshape(9, -1, blk.shape[-1])
            union = [x.reshape(-1) for x in _unpack_cols(blk)]
            d_client, d_start, d_end = dels[0], dels[1], dels[2]
            map_order, _, winners, winner_visible, _, _ = converge_maps(
                *union, d_client, d_start, d_end,
                num_segments=num_segments,
            )
            seq_order, seq_seg, seq_rank, seq_len = converge_sequences(
                *union, num_segments=num_segments,
            )
            return torch.cat([
                x.reshape(-1).to(torch.int64)
                for x in (svs, global_sv, deficit, winners, winner_visible,
                          seq_order, seq_seg, seq_rank, seq_len, map_order)
            ])

    return step


def make_segment_sharded_step(mesh: Mesh, num_segments: int,
                              n_replicas: int):
    """Work-DIVIDED gossip round: the union arrives pre-partitioned by
    SEGMENT (one entry owns every row of each (parent, key) chain and
    each sequence), so each entry converges only its shard — one
    ``converge_maps`` (one ``ds_mask`` launch) and one
    ``converge_sequences`` an entry. Contrast
    :func:`make_hierarchical_gossip_step`, which gathers the union and
    converges it whole (``crdt_tpu_torch.models.fleet.shard_trace``
    builds the partition).

    The per-replica own-op state vectors arrive as an INPUT (the host
    computes them while partitioning); the entries divide the rows of
    the O(R^2 C) pairwise deficit, each scanning its own replica block
    against every vector (:func:`statevec.exact_missing_rows`).

    Inputs: one packed [9, N_d] int64 block an entry (on the entry),
    the [R, C] ``svs`` and the packed [3, D] deletes on the first entry
    (broadcast to every entry; on a pod, this process's first entry,
    and only its own entries' blocks). Output: ONE int64 vector on the
    first entry (on a pod, on every process's), the entries' [X]
    blocks in mesh order (X from
    :func:`segment_out_sizes`), so the host reshapes the fetch to
    [nd, X] and slices it."""
    nd = mesh.devices.size
    blk = -(-n_replicas // nd)  # deficit rows an entry
    dev0 = home(mesh)
    local = local_entries(mesh)

    def step(parts, svs: torch.Tensor, dels: torch.Tensor) -> torch.Tensor:
        _check_parts(parts, mesh, "segment step")
        if svs.shape[0] != n_replicas:
            raise ValueError(f"svs has {svs.shape[0]} rows, the step was "
                             f"built for {n_replicas} replicas")
        svs_on = broadcast(svs, mesh)
        dels_on = broadcast(dels, mesh)
        outs = [None] * nd
        for d, dev in local:
            with _on(dev):
                flat = [x.reshape(-1) for x in _unpack_cols(parts[d])]
                dl = dels_on[d]
                map_order, _, winners, winner_visible, _, _ = converge_maps(
                    *flat, dl[0], dl[1], dl[2], num_segments=num_segments,
                )
                seq_order, seq_seg, seq_rank, seq_len = converge_sequences(
                    *flat, num_segments=num_segments,
                )
                sv = svs_on[d]
                my_rows = sv[d * blk:(d + 1) * blk]
                if my_rows.shape[0] < blk:  # the zero-padded tail block
                    my_rows = torch.cat([my_rows, sv.new_zeros(
                        (blk - my_rows.shape[0], sv.shape[1]))])
                deficit_blk = statevec.exact_missing_rows(my_rows, sv)
                outs[d] = torch.cat([
                    x.reshape(-1).to(torch.int64)
                    for x in (deficit_blk, winners, winner_visible,
                              seq_order, seq_seg, seq_rank, seq_len,
                              map_order)
                ])
        return all_gather(outs, dev0, mesh).reshape(-1)

    return step


def make_packed_shard_step(mesh: Mesh, *, num_segments: int,
                           seq_bucket: int, map_bucket: int,
                           rank_rounds: int, map_rounds: int,
                           encs: tuple, sv_len: int, sv_mode: str):
    """The sharded converge of :mod:`crdt_tpu_torch.ops.shard` over a
    K-entry mesh: entry k widens ITS row of the staged [K, L] section
    block and runs the fused converge
    (:func:`crdt_tpu_torch.ops.packed._converge_packed_body` — one
    ``seg_argmax_scan`` and one ``stream_scatter`` launch) on its own
    rows, with nothing exchanged inside the converge: segments never
    cross shards.

    The only traffic between entries is the BOUNDARY EXCHANGE: each
    shard's narrow wire row (its partial state vector; ``sv_mode``
    ``'i16'`` one identity int16 stretch, ``'hilo'`` two exact int16
    stretches below 2^31, ``'wide'`` int64) gathered onto the first
    entry, widened in int64 before any shift, and max-merged into the
    swarm state vector.

    Step inputs: one block row and one wire row an entry, each on its
    entry, as lists (the step drops its reference to each block row
    once the widening prelude has read it: torch has no donation).
    Returns (the K per-shard int32 results [S+B], each on its entry;
    the merged [sv_len] int64 vector on the first entry). On a pod a
    process converges only its own entries' rows (the other slots stay
    None) and every process merges the gathered wires."""
    sizes = _section_sizes(num_segments, seq_bucket, map_bucket)
    dev0 = home(mesh)
    local = local_entries(mesh)

    def step(blocks: list, wires) -> tuple:
        _check_parts(blocks, mesh, "shard step")
        _check_parts(wires, mesh, "shard step wire")
        outs = [None] * len(blocks)
        for k, dev in local:
            blk, blocks[k] = blocks[k], None
            with _on(dev), torch.profiler.record_function(
                    "crdt.shard.converge"):
                secs = _decode_sections(blk, sizes, encs)
                del blk
                outs[k] = _converge_packed_body(
                    *secs, num_segments=num_segments,
                    seq_bucket=seq_bucket, map_bucket=map_bucket,
                    rank_rounds=rank_rounds, map_rounds=map_rounds,
                )
        with _on(dev0), torch.profiler.record_function(
                "crdt.shard.boundary_exchange"):
            w = all_gather(wires, dev0, mesh)
            if sv_mode == "hilo":
                hi = w[:, :sv_len].to(torch.int64)
                lo = w[:, sv_len:2 * sv_len].to(torch.int64)
                svs = (hi << 16) | ((lo + 0x8000) & 0xFFFF)
            else:  # 'i16' identity / 'wide' int64: plain widen
                svs = w[:, :sv_len].to(torch.int64)
            gsv = svs.amax(dim=0)
        return outs, gsv

    return step


def segment_out_sizes(blk: int, R: int, N_d: int, S: int):
    """Static (name, size) layout of ONE entry's block in the
    segment-sharded step's packed output."""
    return (
        ("deficit", blk * R),
        ("winners", S),
        ("winner_visible", S),
        ("seq_order", N_d),
        ("seq_seg", N_d),
        ("seq_rank", N_d),
        ("seq_len", S),
        ("map_order", N_d),
    )


class GossipFaultPlan:
    """Deterministic fault plan for FLEET gossip rounds — the mesh
    analogue of the router-seam fault fabric
    (:mod:`crdt_tpu_torch.net.faults`). A replica "dropped" in a round
    has its contribution withheld from the gather (its valid column
    zeroed — what a lost propagate broadcast looks like to everyone
    else); a partition splits the replica axis into groups that gossip
    separately. Because the converge is a merge over op unions, a later
    heal round over the full columns lands on EXACTLY the fault-free
    output.

    Decisions hash ``(seed, round, replica)`` — no RNG state, so any
    round replays in isolation, and equal the reference's for the same
    seed."""

    def __init__(self, seed: int = 0, *, drop: float = 0.0,
                 partition_every: int = 0, groups: int = 2):
        self.seed = seed
        self.drop = drop
        self.partition_every = partition_every
        self.groups = groups

    def _h(self, *key) -> float:
        return zlib.crc32(repr((self.seed,) + key).encode()) / 2**32

    def delivered_mask(self, round_idx: int, n_replicas: int) -> np.ndarray:
        """[R] bool: False = this replica's batch is lost this round."""
        mask = np.array(
            [self._h("drop", round_idx, r) >= self.drop
             for r in range(n_replicas)],
            dtype=bool,
        )
        rec = get_recorder()
        if rec.enabled and not mask.all():
            rec.record(
                "gossip.drop", round=round_idx,
                replicas=np.flatnonzero(~mask).tolist(),
            )
        return mask

    def partition_masks(self, round_idx: int,
                        n_replicas: int) -> Optional[list]:
        """List of [R] bool group masks when this round is partitioned
        (round index divisible by ``partition_every``), else None."""
        if not self.partition_every or round_idx % self.partition_every:
            return None
        assign = np.array(
            [int(self._h("part", round_idx, r) * self.groups)
             for r in range(n_replicas)]
        )
        rec = get_recorder()
        if rec.enabled:
            rec.record(
                "gossip.partition", round=round_idx,
                groups=assign.tolist(),
            )
        return [assign == g for g in range(self.groups)]


def mask_packed(packed: np.ndarray, keep: np.ndarray) -> np.ndarray:
    """Withhold replicas' contributions from one packed [9, R, N]
    gossip input: rows where ``keep`` is False get their valid column
    (pack index 8) zeroed. The original block is untouched — a heal
    round re-presents it in full."""
    out = np.array(packed, copy=True)
    out[8, ~np.asarray(keep, dtype=bool), :] = 0
    return out


def synth_columns(
    n_replicas: int,
    ops_per_replica: int,
    *,
    num_maps: int = 4,
    keys_per_map: int = 64,
    num_lists: int = 0,
    seq_fraction: float = 0.5,
    seed: int = 0,
):
    """Synthetic replica-parallel workload as padded columns.

    Each replica r (client id r+1) writes `ops_per_replica` ops: map
    sets over `num_maps` root maps x `keys_per_map` interned keys, and
    — when ``num_lists`` > 0 — concurrent appends to shared lists (each
    item's origin is the replica's previous item in that list). Returns
    a dict of [R, N] arrays plus empty delete ranges. List root ids
    live above the map ids (num_maps..num_maps+num_lists-1)."""
    rng = np.random.default_rng(seed)
    R, N = n_replicas, ops_per_replica
    n_seq = int(N * seq_fraction) if num_lists else 0
    n_map = N - n_seq
    cols = {
        "client": np.repeat(np.arange(1, R + 1, dtype=np.int32)[:, None], N, 1),
        "clock": np.repeat(np.arange(N, dtype=np.int64)[None, :], R, 0),
        "parent_is_root": np.ones((R, N), bool),
        "parent_a": np.empty((R, N), np.int64),
        "parent_b": np.full((R, N), -1, np.int64),
        "key_id": np.full((R, N), -1, np.int32),
        "origin_client": np.full((R, N), -1, np.int32),
        "origin_clock": np.full((R, N), -1, np.int64),
        "valid": np.ones((R, N), bool),
    }
    cols["parent_a"][:, :n_map] = rng.integers(0, num_maps, (R, n_map))
    cols["key_id"][:, :n_map] = rng.integers(0, keys_per_map, (R, n_map))
    if n_seq:
        lists = rng.integers(0, num_lists, (R, n_seq))
        for r in range(R):
            last_clock: dict = {}
            for j in range(n_seq):
                lst = int(lists[r, j])
                k = n_map + j
                cols["parent_a"][r, k] = num_maps + lst
                prev = last_clock.get(lst)
                if prev is not None:
                    cols["origin_client"][r, k] = r + 1
                    cols["origin_clock"][r, k] = prev
                last_clock[lst] = k  # this op's clock
    dels = (
        np.full(16, -1, np.int32),
        np.full(16, -1, np.int64),
        np.full(16, -1, np.int64),
    )
    return cols, dels
