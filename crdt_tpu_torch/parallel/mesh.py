"""A device mesh for one controlling process, and its collectives.

The port's counterpart of the ``jax.sharding.Mesh`` the reference's
multi-device steps run under ``shard_map``. The reference is single
controller: one Python process drives every device of the mesh. Here a
mesh is a numpy object array of :class:`torch.device` entries, shaped
like the reference's ``mesh.devices`` (so ``mesh.devices.size`` reads
the same), plus its axis names. Entries may repeat: a K-way mesh on one
card puts all K entries on that card, on several cards entry k goes on
card ``k % n``, and on the CPU every entry is ``cpu``. Entry k's work
runs on its device's current stream.

A collective is a device-to-device copy (``Tensor.to(dev,
non_blocking=True)``; a peer copy between two cards, nothing at all
between two entries of one device):

- :func:`all_gather` — per-entry tensors stacked onto one entry, in
  mesh order;
- :func:`all_gather2` — the two-tier gather of a (hosts, replicas)
  mesh: the replicas axis first onto each host's first entry, then the
  hosts axis, in the flat gather's row order;
- :func:`broadcast` — one tensor onto every entry;
- :func:`ppermute` — point to point, entry ``src`` to entry ``dst``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import numpy as np
import torch

REPLICA_AXIS = "replicas"
HOST_AXIS = "hosts"


class Mesh(NamedTuple):
    devices: np.ndarray     # object array of torch.device, mesh-shaped
    axis_names: tuple


def visible_devices(device="cuda") -> List[torch.device]:
    """Every device of ``device``'s type this process sees: each card
    for ``"cuda"`` (raising when there is none: a mesh never falls back
    to the CPU on its own), the one host for ``"cpu"``."""
    kind = torch.device(device).type
    if kind == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "a CUDA mesh was requested but no CUDA device is "
                "available; pass device='cpu' to run on the host"
            )
        return [torch.device("cuda", i) for i in range(n)]
    if kind == "cpu":
        return [torch.device("cpu")]
    raise ValueError(f"no mesh over {kind!r} devices")


def make_mesh(n_devices=None, axis: str = REPLICA_AXIS, *,
              device="cuda") -> Mesh:
    """1D mesh of ``n_devices`` entries over the visible devices of
    ``device``'s type, round-robin (None: one entry a visible device)."""
    devs = visible_devices(device)
    n = len(devs) if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"a mesh needs at least one entry, got {n}")
    arr = np.empty(n, dtype=object)
    for k in range(n):
        arr[k] = devs[k % len(devs)]
    return Mesh(arr, (axis,))


def make_mesh2d(n_hosts: int, devices_per_host: int, *,
                device="cuda") -> Mesh:
    """2D (hosts, replicas) mesh: the reference's multi-host topology
    shape. In one process its entries are :func:`make_mesh`'s, row
    major; the multi-process pod form is not in the port."""
    need = n_hosts * devices_per_host
    flat = make_mesh(need, device=device).devices
    return Mesh(flat.reshape(n_hosts, devices_per_host),
                (HOST_AXIS, REPLICA_AXIS))


def entries(mesh: Mesh) -> List[torch.device]:
    """The mesh's entries in flat (row-major) order."""
    return list(mesh.devices.reshape(-1))


def _to(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    return t.to(dev, non_blocking=True)


def all_gather(parts: Sequence[torch.Tensor],
               dest: torch.device) -> torch.Tensor:
    """Stack one tensor an entry onto ``dest``, in mesh order:
    ``[K, *part.shape]``."""
    return torch.stack([_to(p, dest) for p in parts])


def all_gather2(parts: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """The two-tier gather of a (hosts, replicas) mesh: each host's
    entries onto its first entry (``[D, ...]``), then the hosts onto
    the mesh's first entry (``[H, D, ...]``), flattened to ``[H*D,
    ...]`` — the flat gather's row order."""
    grid = mesh.devices
    h, d = grid.shape
    per_host = [
        all_gather(parts[i * d:(i + 1) * d], grid[i, 0]) for i in range(h)
    ]
    both = all_gather(per_host, grid[0, 0])
    return both.reshape(h * d, *both.shape[2:])


def broadcast(t: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """``t`` on every entry (the replicated input of a mesh step)."""
    return [_to(t, dev) for dev in entries(mesh)]


def ppermute(parts: Sequence[torch.Tensor], perm, mesh: Mesh
             ) -> List[torch.Tensor]:
    """Point-to-point exchange: for each ``(src, dst)`` of ``perm``
    entry ``dst`` receives entry ``src``'s tensor; an entry no pair
    sends to receives zeros, as ``jax.lax.ppermute`` gives."""
    devs = entries(mesh)
    out: list = [None] * len(devs)
    for src, dst in perm:
        out[dst] = _to(parts[src], devs[dst])
    return [o if o is not None else torch.zeros_like(parts[k])
            for k, o in enumerate(out)]


def mesh_for(device="cuda", n_devices=None) -> Mesh:
    """An entry point's default mesh: :func:`make_mesh` of
    ``n_devices`` entries over ``device``'s type (every visible device
    when None), except that a device named with its index
    (``"cuda:1"``) and no count pins a one-entry mesh on that device."""
    dev = torch.device(device)
    if n_devices is None and dev.index is not None:
        visible_devices(dev)  # raises without a device of the type
        arr = np.empty(1, dtype=object)
        arr[0] = dev
        return Mesh(arr, (REPLICA_AXIS,))
    return make_mesh(n_devices, device=dev)
