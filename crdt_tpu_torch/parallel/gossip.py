"""The full gossip + merge round, on one card.

The port's counterpart of ``crdt_tpu.parallel.gossip`` for one device.
The reference shards the replica axis over a device mesh and
all-gathers it; on one card the replica axis is a batch axis and the
all-gather is the identity, so the round is:

- per-replica state vectors (a batched scatter-max) and their merge;
- the pairwise anti-entropy plan (the ``sv_deficit`` kernel);
- ``propagate``: the union of every replica's op columns (a reshape);
- every peer's ``applyUpdate`` on that union: ``converge_maps`` (with
  the ``ds_mask`` kernel for tombstones) and ``converge_sequences``.

One packed int64 block comes in per operand and ONE flat int64 vector
goes out, at the reference's static offsets (:func:`fleet_out_sizes`).
The hierarchical, segment-sharded and packed-shard steps and the
fault plan need several devices (ROADMAP.md queue A item 9).
"""

from __future__ import annotations

import numpy as np
import torch

from crdt_tpu_torch.ops import statevec
from crdt_tpu_torch.ops.device import resolve_device
from crdt_tpu_torch.ops.merge import converge_maps
from crdt_tpu_torch.ops.yata import converge_sequences

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
