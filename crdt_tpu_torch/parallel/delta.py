"""Targeted anti-entropy on one card — deltas, not full state.

The port's counterpart of ``crdt_tpu.parallel.delta`` for one device.
:func:`make_delta_gossip_step` is the ``propagate`` analogue driven by
the state vectors: every replica's vector, the pairwise plan (the
``sv_deficit`` kernel), the swarm floor (the componentwise MIN: clocks
every replica already holds) and, per replica, only the rows ABOVE
the floor, packed into a static ``budget``-sized buffer.
``needed_count`` reports the true deficit so a caller can loop rounds
or raise the budget until it reaches zero.

:func:`make_ring_delta_step` is the ``toPeer`` analogue (crdt.js:290)
over a mesh (:mod:`crdt_tpu_torch.parallel.mesh`: one process, or a
pod of processes), one replica an entry: each entry learns its ring
successor's state vector by a ``ppermute``, selects exactly the rows
that successor lacks, and a second ``ppermute`` ships them to it. R-1
rounds converge a ring the way repeated ``toPeer`` unicasts do.
"""

from __future__ import annotations

import numpy as np
import torch

from crdt_tpu_torch.ops import statevec
from crdt_tpu_torch.ops.device import resolve_device
from crdt_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather,
    home,
    local_entries,
    ppermute,
)

COL_NAMES = (
    "client",
    "clock",
    "parent_is_root",
    "parent_a",
    "parent_b",
    "key_id",
    "origin_client",
    "origin_clock",
    "valid",
)


def _pack_rows(cols, needed: torch.Tensor, budget: int):
    """Select each replica's `needed` rows into its first `budget`
    slots, in row order. Slots past the replica's needed count come
    back invalid. Returns ([R, budget] columns, [R] needed counts)."""
    # needed rows first, each group in row order (a stable sort)
    order = torch.argsort((~needed).to(torch.int8), dim=1, stable=True)
    take = order[:, :budget]
    n_needed = needed.sum(dim=1)
    in_budget = (torch.arange(budget, device=needed.device)[None, :]
                 < n_needed[:, None])
    out = [torch.gather(c, 1, take) for c in cols[:-1]]
    out.append(torch.gather(cols[-1], 1, take) & in_budget)
    return tuple(out), n_needed


def make_delta_gossip_step(num_clients: int, budget: int, *, device):
    """Deficit-driven gossip on one card: gather ONLY rows above the
    swarm floor. Returns a step over nine [R, N] column tensors (in
    :data:`COL_NAMES` order, on ``device``) yielding

    - ``svs``          [R, C] every replica's state vector
    - ``deficit``      [R, R] pairwise anti-entropy plan
    - ``needed_count`` [R] rows each replica had to ship
    - ``delta_*``      [R * budget] the gathered delta union columns
    """
    device = resolve_device(device)

    def step(*cols):
        if len(cols) != len(COL_NAMES):
            raise ValueError(f"expected {len(COL_NAMES)} columns")
        if any(c.device != device for c in cols):
            raise ValueError(f"the step was built for {device}")
        n = cols[0].shape[1]
        if budget > n:
            raise ValueError(f"budget={budget} exceeds the {n} rows a "
                             "replica holds")
        client, clock, valid = cols[0], cols[1], cols[8]
        svs = statevec.build(client, clock, valid, num_clients)
        deficit = statevec.missing(svs)

        # swarm floor: clocks EVERY replica holds; only rows above it
        # can be missing anywhere
        floor = svs.min(dim=0).values
        needed = statevec.diff_mask(client, clock, valid, floor)

        packed, n_needed = _pack_rows(cols, needed, budget)
        union = tuple(c.reshape(-1) for c in packed)
        return (svs, deficit, n_needed) + union

    return step


def make_ring_delta_step(mesh: Mesh, num_clients: int, budget: int):
    """Point-to-point delta exchange (the ``toPeer`` analogue): every
    replica ships its ring successor exactly the rows that successor
    lacks, by :func:`~crdt_tpu_torch.parallel.mesh.ppermute` between
    mesh entries. One replica an entry, as the reference requires.

    Step input: nine lists (in :data:`COL_NAMES` order), each of one
    [1, N] column tensor an entry, on the entry (on a pod, this
    process's entries only, None elsewhere: the ring's pairs that
    cross processes become sends and receives). Returns, gathered onto
    the first entry in mesh order (on a pod, onto every process's
    first entry),

    - ``sent_count`` [R] rows each replica shipped to its successor
    - ``recv_*``     [R, budget] columns each replica received from its
      predecessor
    """
    nd = mesh.devices.size
    fwd = [(i, (i + 1) % nd) for i in range(nd)]
    bwd = [(i, (i - 1) % nd) for i in range(nd)]
    local = local_entries(mesh)
    dev0 = home(mesh)

    def step(*cols):
        if len(cols) != len(COL_NAMES):
            raise ValueError(f"expected {len(COL_NAMES)} columns")
        for col in cols:
            if len(col) != nd or any(col[k] is None or col[k].device != dev
                                     for k, dev in local):
                raise ValueError("each column must hold one part on "
                                 "each of this process's mesh entries")
        n = cols[0][local[0][0]].shape[1]
        if budget > n:
            raise ValueError(f"budget={budget} exceeds the {n} rows a "
                             "replica holds")
        per = {k: tuple(col[k] for col in cols) for k, _ in local}
        sv_local = [None] * nd
        for k, p in per.items():
            sv_local[k] = statevec.build(p[0], p[1], p[8], num_clients)
        # learn the SUCCESSOR's vector: it travels backwards round the ring
        succ_sv = ppermute(sv_local, bwd, mesh)
        packed = [None] * nd
        sent = [None] * nd
        for k, p in per.items():
            needed = statevec.diff_mask(p[0], p[1], p[8], succ_sv[k])
            packed[k], sent[k] = _pack_rows(p, needed, budget)
        # ship the packed rows forward to the successor
        recv = [ppermute([None if rows is None else rows[i]
                          for rows in packed], fwd, mesh)
                for i in range(len(COL_NAMES))]
        return (all_gather(sent, dev0, mesh).reshape(-1),) + tuple(
            all_gather(col, dev0, mesh).reshape(nd, budget)
            for col in recv)

    return step


def synth_resident_columns(
    n_replicas: int,
    shared_ops: int,
    fresh_ops: int,
    *,
    num_maps: int = 4,
    keys_per_map: int = 32,
    seed: int = 0,
):
    """Anti-entropy workload: every replica already holds a shared
    history (`shared_ops` rows by client 1, fully replicated) plus its
    own `fresh_ops` unshared writes — the state after a settled swarm
    takes new local edits. The deficit is exactly the fresh rows."""
    rng = np.random.default_rng(seed)
    R, N = n_replicas, shared_ops + fresh_ops
    cols = {
        "client": np.empty((R, N), np.int32),
        "clock": np.empty((R, N), np.int64),
        "parent_is_root": np.ones((R, N), bool),
        "parent_a": rng.integers(0, num_maps, (R, N)).astype(np.int64),
        "parent_b": np.full((R, N), -1, np.int64),
        "key_id": rng.integers(0, keys_per_map, (R, N)).astype(np.int32),
        "origin_client": np.full((R, N), -1, np.int32),
        "origin_clock": np.full((R, N), -1, np.int64),
        "valid": np.ones((R, N), bool),
    }
    # shared history: identical rows on every replica (client 1)
    cols["client"][:, :shared_ops] = 1
    cols["clock"][:, :shared_ops] = np.arange(shared_ops)
    shared_pa = rng.integers(0, num_maps, shared_ops)
    shared_key = rng.integers(0, keys_per_map, shared_ops)
    cols["parent_a"][:, :shared_ops] = shared_pa
    cols["key_id"][:, :shared_ops] = shared_key
    # fresh per-replica rows (client r+2 so client 1 stays the history)
    for r in range(R):
        cols["client"][r, shared_ops:] = r + 2
        cols["clock"][r, shared_ops:] = np.arange(fresh_ops)
    return cols
