"""A device mesh and its collectives: one controlling process, or a pod
of processes in a ``torch.distributed`` group.

The port's counterpart of the ``jax.sharding.Mesh`` the reference's
multi-device steps run under ``shard_map``. A mesh is a numpy object
array of entries, shaped like the reference's ``mesh.devices`` (so
``mesh.devices.size`` reads the same), plus its axis names. Entries may
repeat: a K-way mesh on one card puts all K entries on that card, on
several cards entry k goes on card ``k % n``, and on the CPU every
entry is ``cpu``. Entry k's work runs on its device's current stream.

**One controller** (no process group, or a group of one): every entry
is a :class:`torch.device` of this process, as the reference's one
``shard_map`` program drives every device of one host. It is the pod
of one process: it owns every entry, each collective skips its
cross-process half, and what is left is a device-to-device copy
(``Tensor.to(dev, non_blocking=True)``; a peer copy between two cards,
nothing at all between two entries of one device).

**A pod** (``torch.distributed`` initialized with more than one
process: the counterpart of ``jax.process_count() > 1``, the group set
up by the caller as the reference's callers run
``jax.distributed.initialize``). The mesh's entries are global and
rank-major: rank r owns the contiguous block ``[r * L, (r + 1) * L)``
of L = K / W entries, placed round-robin on its own cards, and an entry
of another rank is a :class:`RemoteEntry` naming that rank. Every
process runs the same program on the same inputs (SPMD): it works only
on :func:`local_entries`, and each collective brings its result to
every rank, as ``jax.lax.all_gather`` does. A pair of entries inside
one rank stays a ``Tensor.to``; a pair across ranks goes through
``torch.distributed`` on the group's own backend (never chosen here):
``nccl`` takes CUDA tensors as they are, ``gloo`` takes them staged
through host memory (the ``mesh.staged_bytes`` counter). Every pod
collective first agrees a header (a per-process sequence number, the
operation, the payload size) across the ranks and raises when one
differs: every rank must call the same collectives in the same order.
A pod mesh always spans the whole group, so its one cross-process axis
is the world group and no subgroup is built.

- :func:`all_gather` — per-entry tensors stacked onto one entry, in
  mesh order;
- :func:`all_gather2` — the two-tier gather of a (hosts, replicas)
  mesh: the replicas axis first onto each host's first entry, then the
  hosts axis, in the flat gather's row order;
- :func:`broadcast` — one tensor onto every entry (on a pod, the first
  entry's rank's copy);
- :func:`ppermute` — point to point, entry ``src`` to entry ``dst``;
- :func:`agree` — one integer every rank must hold alike.
"""

from __future__ import annotations

import os
import threading
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from crdt_tpu_torch.obs.tracer import get_tracer

REPLICA_AXIS = "replicas"
HOST_AXIS = "hosts"


class RemoteEntry(NamedTuple):
    """A pod mesh entry another process owns: its rank, and the device
    that rank places it on (on a pod of alike hosts)."""
    rank: int
    device: torch.device

    def __str__(self) -> str:
        return f"rank{self.rank}:{self.device}"


class Pod(NamedTuple):
    """The process group a pod mesh spans: this process's rank, the
    process count, the group's backend and the entries a rank owns."""
    rank: int
    world: int
    backend: str
    per_rank: int


class Mesh(NamedTuple):
    devices: np.ndarray     # object array of entries, mesh-shaped
    axis_names: tuple
    pod: Optional[Pod] = None


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


def _group():
    """(rank, world size, backend) of the initialized process group;
    ``(0, 1, None)`` with no group or a group of one process: the
    single controller, a pod of one process that owns every entry."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1, None
    world = dist.get_world_size()
    if world <= 1:
        return 0, 1, None
    return dist.get_rank(), world, str(dist.get_backend())


def check_backend(backend: Optional[str], kind: str, n_cards: int,
                  local_world: int, *, assumed: bool = False) -> None:
    """Refuse a pod the backend cannot run, before any collective:
    ``nccl`` moves only CUDA tensors and takes one card a rank, so a
    ``nccl`` group whose ranks on this host outnumber its cards (or a
    ``nccl`` mesh of CPU entries) raises. ``gloo`` runs any number of
    ranks on one card. ``assumed``: ``local_world`` is the whole group,
    taken to be on this host because ``LOCAL_WORLD_SIZE`` is unset."""
    if backend != "nccl":
        return
    if kind != "cuda":
        raise ValueError("a nccl process group moves only CUDA tensors; "
                         "a CPU mesh needs a gloo group")
    if local_world > n_cards:
        where = (
            f"LOCAL_WORLD_SIZE is unset, so all {local_world} ranks are "
            "taken to be on this host (torchrun sets it and LOCAL_RANK; "
            "a launcher that does not, such as srun or mpirun, must "
            "export both when the ranks span hosts)"
            if assumed else f"{local_world} ranks are on this host")
        raise RuntimeError(
            f"a nccl process group needs a card a rank, but {n_cards} "
            f"card(s) are visible and {where}: NCCL refuses two ranks on "
            "one card. On one host, initialize the group with "
            "backend='gloo' to run the pod on one card")


def _cards(device, rank: int, world: int, backend: Optional[str]):
    """``cards(r)``: the devices rank r places its entries on. A single
    controller places on every visible device. In a group the host's
    visible cards are split among its local ranks, read from torchrun's
    ``LOCAL_WORLD_SIZE`` (and this rank's ``LOCAL_RANK``); with those
    unset every rank is taken to be on this host. When the ranks
    outnumber the cards (``gloo`` only) they all share them. Another
    rank's are read as on a pod of alike hosts."""
    devs = visible_devices(device)
    if world == 1:
        return lambda r: devs
    env = os.environ.get("LOCAL_WORLD_SIZE")
    local_world = world if env is None else int(env)
    check_backend(backend, devs[0].type, len(devs), local_world,
                  assumed=env is None)

    def cards(r: int) -> List[torch.device]:
        if devs[0].type != "cuda" or local_world > len(devs):
            return devs
        local = r % local_world
        if r == rank:
            local = int(os.environ.get("LOCAL_RANK", local))
        return devs[local::local_world]

    return cards


def default_size(device="cuda") -> int:
    """Entries of :func:`make_mesh` with no count: one a visible device
    of ``device``'s type, on a pod one a device of every rank (the
    counterpart of ``len(jax.devices())`` across processes)."""
    rank, world, backend = _group()
    return world * len(_cards(device, rank, world, backend)(rank))


def make_mesh(n_devices=None, axis: str = REPLICA_AXIS, *,
              device="cuda") -> Mesh:
    """1D mesh of ``n_devices`` entries over the visible devices of
    ``device``'s type, round-robin (None: :func:`default_size`). On a
    pod the count must divide over the processes: rank r owns the r-th
    block of K / W entries. (The reference takes the first K global
    devices, which on a partial pod leaves a process with no device
    for its ``shard_map`` to run on.)"""
    rank, world, backend = _group()
    cards = _cards(device, rank, world, backend)
    n = world * len(cards(rank)) if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"a mesh needs at least one entry, got {n}")
    if n % world:
        raise ValueError(
            f"a pod mesh of {n} entries does not divide over {world} "
            "processes: every process must own the same number of "
            "entries")
    per = n // world
    arr = np.empty(n, dtype=object)
    for k in range(n):
        owner, j = divmod(k, per)
        own = cards(owner)
        dev = own[j % len(own)]
        arr[k] = dev if owner == rank else RemoteEntry(owner, dev)
    pod = Pod(rank, world, backend, per) if world > 1 else None
    return Mesh(arr, (axis,), pod)


def make_mesh2d(n_hosts: int, devices_per_host: int, *,
                device="cuda") -> Mesh:
    """2D (hosts, replicas) mesh: the reference's multi-host topology
    shape, its entries :func:`make_mesh`'s, row major. On a pod a host
    row is exactly one process's ``devices_per_host`` entries, so the
    inner axis never crosses a process (the reference's rule)."""
    world = _group()[1]
    if world > 1 and n_hosts != world:
        raise ValueError(
            f"n_hosts={n_hosts} must equal process_count()={world} "
            "on a multi-process pod: a host row is one process's "
            "entries")
    m = make_mesh(n_hosts * devices_per_host, device=device)
    return m._replace(devices=m.devices.reshape(n_hosts, devices_per_host),
                      axis_names=(HOST_AXIS, REPLICA_AXIS))


def entries(mesh: Mesh) -> list:
    """The mesh's entries in flat (row-major) order."""
    return list(mesh.devices.reshape(-1))


def is_pod(mesh: Mesh) -> bool:
    return mesh.pod is not None


def local_entries(mesh: Mesh) -> List[tuple]:
    """``(flat index, device)`` of each entry this process owns: every
    entry of a single-controller mesh."""
    return [(k, e) for k, e in enumerate(entries(mesh))
            if not isinstance(e, RemoteEntry)]


def home(mesh: Mesh) -> torch.device:
    """This process's first entry: where a gathered or replicated
    result lands (the mesh's first entry on one controller)."""
    return local_entries(mesh)[0][1]


def _to(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    return t.to(dev, non_blocking=True)


# ---------------------------------------------------------------------------
# the pod's cross-process half
# ---------------------------------------------------------------------------

_OPS = {"all_gather": 1, "all_gather2": 2, "broadcast": 3, "ppermute": 4,
        "agree": 5}


class _Order:
    """This process's pod collective count, restarted with each new
    default group: the sequence number every rank must agree on."""

    def __init__(self):
        self._lock = threading.Lock()
        self._group = None
        self._n = 0

    def next(self) -> int:
        import torch.distributed as dist

        group = dist.group.WORLD
        with self._lock:
            if group is not self._group:
                self._group, self._n = group, 0
            self._n += 1
            return self._n


_ORDER = _Order()


def _link(pod: Pod, dev: torch.device) -> torch.device:
    """Where a payload crosses the group: the host for ``gloo``, the
    entry's card for ``nccl``."""
    return torch.device("cpu") if pod.backend == "gloo" else dev


def _header(pod: Optional[Pod], dev: torch.device, op: str, nbytes: int,
            value: int = 0) -> None:
    """All-gather (sequence, op, payload bytes, value) and raise unless
    every rank sent this rank's: a rank that called its collectives in
    another order, or staged another plan, fails here instead of
    exchanging wrong bytes. Nothing on one controller."""
    if pod is None:
        return
    import torch.distributed as dist

    mine = torch.tensor([_ORDER.next(), _OPS[op], nbytes, value],
                        dtype=torch.int64)
    link = _link(pod, dev)
    heads = [torch.empty(4, dtype=torch.int64, device=link)
             for _ in range(pod.world)]
    dist.all_gather(heads, mine.to(link))
    got = torch.stack(heads).cpu()
    bad = [r for r in range(pod.world) if not torch.equal(got[r], mine)]
    if bad:
        raise RuntimeError(
            f"pod collectives diverged at rank {pod.rank}: it is at "
            f"(seq, op, bytes, value) {mine.tolist()}, rank {bad[0]} at "
            f"{got[bad[0]].tolist()}; every rank must call the same "
            "collectives, in the same order, on the same inputs")


def _bytes_on_link(t: torch.Tensor, pod: Pod) -> torch.Tensor:
    """``t``'s bytes (a flat uint8 tensor) where they cross the group;
    a CUDA tensor under ``gloo`` is staged to the host explicitly."""
    b = t.contiguous().reshape(-1).view(torch.uint8)
    if b.device != _link(pod, t.device):
        b = b.cpu()
        get_tracer().count("mesh.staged_bytes", b.numel())
    return b


def _bytes_back(b: torch.Tensor, dtype, shape, dev: torch.device
                ) -> torch.Tensor:
    if b.device != dev:
        get_tracer().count("mesh.staged_bytes", b.numel())
        b = b.to(dev)
    return b.view(dtype).reshape(shape)


def _pod_gather(mine: torch.Tensor, pod: Optional[Pod], op: str
                ) -> torch.Tensor:
    """Every rank's ``mine`` ([L, ...], alike in shape), concatenated
    in rank order on ``mine``'s device: [W * L, ...] (``mine`` itself
    on one controller)."""
    if pod is None:
        return mine
    import torch.distributed as dist

    payload = _bytes_on_link(mine, pod)
    _header(pod, mine.device, op, payload.numel())
    bufs = [torch.empty_like(payload) for _ in range(pod.world)]
    dist.all_gather(bufs, payload)
    return _bytes_back(torch.cat(bufs), mine.dtype,
                       (pod.world * mine.shape[0], *mine.shape[1:]),
                       mine.device)


def _pod_broadcast(t: torch.Tensor, pod: Optional[Pod]) -> torch.Tensor:
    """The first rank's ``t`` on every rank (``t`` itself on one
    controller)."""
    if pod is None:
        return t
    import torch.distributed as dist

    payload = _bytes_on_link(t, pod)
    if payload.data_ptr() == t.data_ptr():
        payload = payload.clone()  # the caller's tensor stays as it was
    _header(pod, t.device, "broadcast", payload.numel())
    dist.broadcast(payload, src=0)
    return _bytes_back(payload, t.dtype, t.shape, t.device)


def _span(name: str):
    tracer = get_tracer()
    tracer.count("mesh.collectives")
    # crdtlint: emits=mesh.agree,mesh.all_gather,mesh.all_gather2,mesh.broadcast,mesh.ppermute
    return tracer.span(name)


def agree(mesh: Mesh, value: int) -> None:
    """Raise unless every rank of a pod mesh holds the same ``value``
    (a digest of what each rank staged); nothing on one controller."""
    if mesh.pod is not None:
        with _span("mesh.agree"):
            _header(mesh.pod, home(mesh), "agree", 0, int(value))


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------


def all_gather(parts: Sequence[Optional[torch.Tensor]],
               dest: torch.device, mesh: Optional[Mesh] = None
               ) -> torch.Tensor:
    """Stack one tensor an entry onto ``dest``, in mesh order:
    ``[K, *part.shape]`` (no ``mesh``: every part is this process's).
    On a pod mesh ``parts`` holds this process's entries' tensors (None
    elsewhere), ``dest`` is one of its devices, and every rank receives
    the whole stack."""
    own = (range(len(parts)) if mesh is None
           else [k for k, _ in local_entries(mesh)])
    with _span("mesh.all_gather"):
        mine = torch.stack([_to(parts[k], dest) for k in own])
        return _pod_gather(mine, None if mesh is None else mesh.pod,
                           "all_gather")


def all_gather2(parts: Sequence[Optional[torch.Tensor]],
                mesh: Mesh) -> torch.Tensor:
    """The two-tier gather of a (hosts, replicas) mesh: each host's
    entries onto its first entry (``[D, ...]``), then the hosts onto
    the mesh's first entry (``[H, D, ...]``), flattened to ``[H*D,
    ...]`` — the flat gather's row order. On a pod a host is one
    process: the inner tier is its own copies, the outer an all-gather
    across the processes, landing on every rank's first entry."""
    grid = mesh.devices
    h, d = grid.shape
    rows = []
    for i in range(h):
        local = [not isinstance(e, RemoteEntry) for e in grid[i]]
        if any(local) and not all(local):
            raise ValueError(f"host row {i} of a pod mesh spans processes")
        if all(local):
            rows.append(i)
    dest = home(mesh)
    with _span("mesh.all_gather2"):
        mine = torch.stack([
            _to(all_gather(parts[i * d:(i + 1) * d], grid[i, 0]), dest)
            for i in rows])
        both = _pod_gather(mine, mesh.pod, "all_gather2")
    return both.reshape(h * d, *both.shape[2:])


def broadcast(t: torch.Tensor, mesh: Mesh) -> List[Optional[torch.Tensor]]:
    """``t`` on every entry (the replicated input of a mesh step). On a
    pod every rank passes its own ``t`` and receives the first entry's
    rank's; a remote entry's slot is None."""
    with _span("mesh.broadcast"):
        val = _pod_broadcast(t, mesh.pod)
    return [None if isinstance(dev, RemoteEntry) else _to(val, dev)
            for dev in entries(mesh)]


def ppermute(parts: Sequence[Optional[torch.Tensor]], perm, mesh: Mesh
             ) -> List[Optional[torch.Tensor]]:
    """Point-to-point exchange: for each ``(src, dst)`` of ``perm``
    entry ``dst`` receives entry ``src``'s tensor; an entry no pair
    sends to receives zeros, as ``jax.lax.ppermute`` gives. A pair
    inside one process is a copy; on a pod a pair across processes is
    one send and one receive (``batch_isend_irecv``, matched by the
    pair's index in ``perm``), and a remote entry's slot is None. Every
    rank calls it, even one that no pair involves."""
    import torch.distributed as dist

    devs = entries(mesh)
    pod = mesh.pod
    rank, per = (0, len(devs)) if pod is None else (pod.rank, pod.per_rank)
    like = parts[local_entries(mesh)[0][0]]
    out: list = [None] * len(devs)
    with _span("mesh.ppermute"):
        _header(pod, like.device, "ppermute",
                like.numel() * like.element_size())
        ops, recvs = [], []
        for i, (src, dst) in enumerate(perm):
            s_rank, d_rank = src // per, dst // per
            if s_rank == rank and d_rank == rank:
                out[dst] = _to(parts[src], devs[dst])
            elif s_rank == rank:
                ops.append(dist.P2POp(dist.isend,
                                      _bytes_on_link(parts[src], pod),
                                      d_rank, tag=i))
            elif d_rank == rank:
                buf = torch.empty(like.numel() * like.element_size(),
                                  dtype=torch.uint8,
                                  device=_link(pod, devs[dst]))
                ops.append(dist.P2POp(dist.irecv, buf, s_rank, tag=i))
                recvs.append((dst, buf))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        for dst, buf in recvs:
            out[dst] = _bytes_back(buf, like.dtype, like.shape, devs[dst])
    return [o if o is not None or isinstance(devs[k], RemoteEntry)
            else torch.zeros_like(like, device=devs[k])
            for k, o in enumerate(out)]


def mesh_for(device="cuda", n_devices=None) -> Mesh:
    """An entry point's default mesh: :func:`make_mesh` of
    ``n_devices`` entries over ``device``'s type (every visible device
    when None, on a pod every rank's), except that a device named with
    its index (``"cuda:1"``) and no count pins a one-entry mesh of this
    process on that device."""
    dev = torch.device(device)
    if n_devices is None and dev.index is not None:
        visible_devices(dev)  # raises without a device of the type
        arr = np.empty(1, dtype=object)
        arr[0] = dev
        return Mesh(arr, (REPLICA_AXIS,))
    return make_mesh(n_devices, device=dev)
