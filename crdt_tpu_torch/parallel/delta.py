"""Targeted anti-entropy on one card — deltas, not full state.

The port's counterpart of ``crdt_tpu.parallel.delta`` for one device.
:func:`make_delta_gossip_step` is the ``propagate`` analogue driven by
the state vectors: every replica's vector, the pairwise plan (the
``sv_deficit`` kernel), the swarm floor (the componentwise MIN: clocks
every replica already holds) and, per replica, only the rows ABOVE
the floor, packed into a static ``budget``-sized buffer.
``needed_count`` reports the true deficit so a caller can loop rounds
or raise the budget until it reaches zero. The ring step
(``make_ring_delta_step``) needs a device per replica (ROADMAP.md
queue A item 9).
"""

from __future__ import annotations

import numpy as np
import torch

from crdt_tpu_torch.ops import statevec
from crdt_tpu_torch.ops.device import resolve_device

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
