"""Delete-set application.

The port's counterpart of ``crdt_tpu.ops.deleteset``. A delete set is
three parallel tensors of half-open ranges; :func:`apply_mask` marks
every item that falls inside one. There is no ``mode`` argument and no
crossover: a CPU tensor takes the plain version of the ``ds_mask``
kernel, a CUDA tensor launches the kernel for every D
(:func:`crdt_tpu_torch.ops.kernels.ds_mask`).
"""

from __future__ import annotations

import torch

from crdt_tpu_torch.ops.kernels import ds_mask


def ranges_to_device(ds) -> tuple:
    """Host DeleteSet -> (client[D], start[D], end[D]) numpy-ready lists."""
    cs, ss, es = [], [], []
    for client, clock, length in ds.iter_all():
        cs.append(client)
        ss.append(clock)
        es.append(clock + length)
    return cs, ss, es


def apply_mask(
    client: torch.Tensor,    # [N] int32
    clock: torch.Tensor,     # [N] int64
    valid: torch.Tensor,     # [N] bool
    d_client: torch.Tensor,  # [D] range clients
    d_start: torch.Tensor,   # [D]
    d_end: torch.Tensor,     # [D]
) -> torch.Tensor:
    """True where a valid item falls inside any delete range.

    On disjoint ranges (every caller passes a normalized delete set
    plus null fillers) this equals the reference's binary search; on
    overlapping ranges it keeps the reference Pallas kernel's dense
    meaning, where the reference's binary search can miss an item
    covered only by an earlier, longer range."""
    return ds_mask(client, clock, valid, d_client, d_start, d_end)
