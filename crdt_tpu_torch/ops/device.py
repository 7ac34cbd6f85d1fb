"""Shared device-side helpers in torch: id packing, size buckets, the
host<->device transfer seam and pointer-doubling list ranking.

The port's counterpart of ``crdt_tpu.ops.device``. Conventions:

- Inputs are flat int32/int64/bool tensors of one device. Entry points
  take an explicit ``device=`` and default to the card
  (:func:`resolve_device`); with no card present they raise rather
  than quietly run on the CPU.
- Item IDs (client, clock) pack into one int64 (:func:`pack_id`):
  client < 2**22, clock < 2**40.
- ``NULLI = -1`` marks absent references.
- Gathers: a JAX gather clamps an out-of-range index and wraps a
  negative one; torch raises on the CPU and device-asserts on CUDA.
  Every gather below either clamps exactly where the reference clamps
  or reads an index that is in range by construction, and says which.
- The ranking loops run a FIXED number of rounds computed on the host,
  never a data-driven loop: a per-round ``any(changed)`` exit would
  cost one device-to-host sync per round on the card.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import torch

from crdt_tpu_torch.obs.tracer import get_tracer

NULLI = -1
_CLOCK_BITS = 40

_WIDE_ENV = "CRDT_TPU_WIDE_STAGING"


def resolve_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`, a bare ``"cuda"`` pinned
    to the current card's index (so devices compare equal to the ones
    tensors report); raises when it names the card and none is present
    (entry points never fall back to the CPU on their own — callers
    pass ``device="cpu"`` for that)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is "
            "available; pass device='cpu' to run on the host"
        )
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def wide_staging_forced() -> bool:
    """Debug knob: CRDT_TPU_WIDE_STAGING=1 forces every staged upload
    to the wide int32 layout, bypassing the narrow-section encodings."""
    return os.environ.get(_WIDE_ENV, "") not in ("", "0")


# ---------------------------------------------------------------------------
# device fault hook: the injection seam of the guarded-dispatch ladder
# (crdt_tpu_torch.guard.device). The hook fires before every guarded
# dispatch attempt and may raise RuntimeError to simulate a device fault
# (an OOM, a lost card), so tests drive the retry -> split -> host
# ladder without a failing device.
# ---------------------------------------------------------------------------

_DEVICE_FAULT_HOOK = None
# the swap-and-return-old contract is only right if the
# read-modify-write is atomic (the streaming decode pool reaches this
# module from other threads)
_HOOK_LOCK = threading.Lock()


def set_device_fault_hook(fn):
    """Install ``fn(stage, attempt)`` as the guarded-dispatch fault hook
    (None uninstalls). Returns the previous hook so callers can restore
    it."""
    global _DEVICE_FAULT_HOOK
    with _HOOK_LOCK:
        old = _DEVICE_FAULT_HOOK
        _DEVICE_FAULT_HOOK = fn
        return old


def device_fault_hook():
    return _DEVICE_FAULT_HOOK


# ---------------------------------------------------------------------------
# host<->device transfer seam: every staged upload and result fetch of
# the port routes through these two calls, under the reference's
# ``xfer.*`` counter names
# ---------------------------------------------------------------------------


def xfer_put(arr: np.ndarray, *, device, label: str = "stage",
             out: torch.Tensor | None = None):
    """The ONE host->device seam. The numpy array ships at its own
    width (an int16 staged section stays int16 on the link); for the
    card it is copied into pinned host memory and the upload is
    enqueued asynchronously on the current stream (the caching host
    allocator keeps the pinned block alive until the copy has run).
    With ``out`` (a tensor of the array's dtype and shape on
    ``device``) the upload lands there and ``out`` is returned.
    Records ``xfer.h2d_bytes`` / ``xfer.h2d_puts`` and the enqueue
    latency into the ``xfer.h2d`` histogram."""
    dev = resolve_device(device)
    tracer = get_tracer()
    t0 = time.perf_counter()
    host = torch.from_numpy(np.ascontiguousarray(arr))
    if dev.type == "cuda":
        host = host.pin_memory()
    if out is not None:
        out.copy_(host, non_blocking=dev.type == "cuda")
    elif dev.type == "cuda":
        out = host.to(dev, non_blocking=True)
    else:
        out = host.to(dev)
    if tracer.enabled:
        nbytes = int(arr.nbytes)
        tracer.observe("xfer.h2d", time.perf_counter() - t0)
        tracer.count("xfer.h2d_bytes", nbytes)
        tracer.count("xfer.h2d_puts")
        tracer.count("xfer.h2d_bytes_by", nbytes, labels={"path": label})
    return out


def xfer_fetch(t: torch.Tensor, *, label: str = "result") -> np.ndarray:
    """The ONE device->host seam: blocks until the tensor's producers
    have run (execution wait, excluded from the ``xfer.d2h``
    histogram), then copies it to a numpy array."""
    tracer = get_tracer()
    if t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()
    t0 = time.perf_counter()
    h = t.cpu().numpy()
    if tracer.enabled:
        tracer.observe("xfer.d2h", time.perf_counter() - t0)
        tracer.count("xfer.d2h_bytes", int(h.nbytes))
        tracer.count("xfer.d2h_fetches")
        tracer.count("xfer.d2h_bytes_by", int(h.nbytes),
                     labels={"path": label})
    return h


def fetch_packed_i32(*tensors) -> list:
    """Fetch several device index tensors in ONE int32 transfer: their
    int32 views are concatenated on the device and cross as one D2H
    copy (:func:`xfer_fetch`). Every kernel index/segment output fits
    int32 (values below the pad bucket, NULLI = -1). Returns host
    arrays in input order."""
    h = xfer_fetch(torch.cat([t.to(torch.int32) for t in tensors]),
                   label="packed_i32")
    out, off = [], 0
    for t in tensors:
        n = t.shape[0]
        out.append(h[off:off + n])
        off += n
    return out


def record_staged_widths(widths: dict, shipped_bytes: int,
                         wide_bytes: int) -> None:
    """Per-upload narrowing record: one ``xfer.col_width`` count per
    section at its chosen width and the ``xfer.narrowed_ratio`` gauge
    = shipped / wide-equivalent bytes (1.0 = no diet, 0.5 = halved)."""
    tracer = get_tracer()
    if not tracer.enabled:
        return
    for col, bits in widths.items():
        tracer.count("xfer.col_width", labels={"col": col, "bits": bits})
    if wide_bytes > 0:
        tracer.gauge(
            "xfer.narrowed_ratio", round(shipped_bytes / wide_bytes, 4)
        )
        tracer.count("xfer.staged_bytes", shipped_bytes)
        tracer.count("xfer.h2d_bytes_saved",
                     max(wide_bytes - shipped_bytes, 0))


# ---------------------------------------------------------------------------
# host helpers
# ---------------------------------------------------------------------------


def bucket_pow2(n: int, floor: int = 9) -> int:
    """Power-of-two size bucket (host helper)."""
    return 1 << max(floor, (max(n, 1) - 1).bit_length())


def bucket_grid(n: int, floor: int = 9) -> int:
    """Quarter-pow2 size bucket: smallest of {1, 1.25, 1.5, 1.75}*2^k
    >= n (caps padding waste at 25%)."""
    n = max(n, 1 << floor)
    k = (n - 1).bit_length() - 1  # candidate exponent: 2^k < n <= 2^(k+1)
    for num in (5, 6, 7, 8):
        cand = num << max(k - 2, 0)
        if cand >= n:
            return cand
    return 1 << (k + 1)


def pack_id(client: torch.Tensor, clock: torch.Tensor) -> torch.Tensor:
    """(client, clock) -> single sortable int64; null (-1,*) -> -1."""
    packed = (client.to(torch.int64) << _CLOCK_BITS) | clock.to(torch.int64)
    return torch.where(client < 0, torch.full_like(packed, NULLI), packed)


def unpack_id(packed: torch.Tensor):
    """Inverse of :func:`pack_id`: (client int32, clock int64), null
    (negative) ids -> (-1, -1)."""
    null = packed < 0
    client = torch.where(null, NULLI, packed >> _CLOCK_BITS).to(torch.int32)
    clock = torch.where(null, NULLI, packed & ((1 << _CLOCK_BITS) - 1))
    return client, clock.to(torch.int64)


# ---------------------------------------------------------------------------
# sorted-order primitives (the reference's method="sort" searches and
# its scatter-free permutation inverse were TPU workarounds; the results
# here are the same)
# ---------------------------------------------------------------------------


def lexsort(keys) -> torch.Tensor:
    """argsort by multiple keys; keys[0] is most significant. Iterated
    stable argsorts, least significant first."""
    order = torch.argsort(keys[-1], stable=True)
    for k in reversed(keys[:-1]):
        order = order[torch.argsort(k[order], stable=True)]
    return order


def dense_ranks_sorted(sorted_key: torch.Tensor) -> torch.Tensor:
    """Dense 0..S-1 rank per element of an ALREADY SORTED key array."""
    new_seg = torch.zeros(sorted_key.shape[0], dtype=torch.int32,
                          device=sorted_key.device)
    new_seg[1:] = (sorted_key[1:] != sorted_key[:-1]).to(torch.int32)
    return torch.cumsum(new_seg, 0).to(torch.int32)


def searchsorted_ids(sorted_ids: torch.Tensor,
                     query: torch.Tensor) -> torch.Tensor:
    """Index of each query id in sorted_ids, or NULLI if absent.
    Clamps the found position as the reference's gather does."""
    n = sorted_ids.shape[0]
    if n == 0:
        return torch.full(query.shape, NULLI, dtype=torch.int32,
                          device=query.device)
    pos = torch.searchsorted(sorted_ids, query.to(sorted_ids.dtype))
    pos_c = pos.clamp(0, n - 1)
    found = (sorted_ids[pos_c] == query) & (query >= 0)
    return torch.where(found, pos_c, NULLI).to(torch.int32)


def scatter_perm(perm: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """out[perm[i]] = vals[i] for a PERMUTATION perm of 0..N-1."""
    out = torch.empty_like(vals)
    out[perm.long()] = vals
    return out


def run_edge_lookup(slots_sorted: torch.Tensor, size: int, *, side: str):
    """For each dense slot j in [0, size): the index into `slots_sorted`
    of the FIRST (side='left') or LAST (side='right') element equal to
    j, or NULLI when j is absent; plus the found mask. `slots_sorted`
    must be ascending. The position is clamped as the reference's
    gather does."""
    n = slots_sorted.shape[0]
    dev = slots_sorted.device
    if n == 0:
        return (torch.full((size,), NULLI, dtype=torch.int32, device=dev),
                torch.zeros(size, dtype=torch.bool, device=dev))
    iota = torch.arange(size, dtype=slots_sorted.dtype, device=dev)
    pos = torch.searchsorted(slots_sorted, iota, side=side)
    if side == "right":
        pos = pos - 1
    pos_c = pos.clamp(0, n - 1)
    found = slots_sorted[pos_c] == iota
    return torch.where(found, pos_c, NULLI).to(torch.int32), found


def _round_cap(n: int) -> int:
    """ceil(log2 n) + 1: enough doubling rounds for any path in an
    n-node forest."""
    return max(1, (max(n, 2) - 1).bit_length() + 1)


# ---------------------------------------------------------------------------
# list ranking
# ---------------------------------------------------------------------------


def pointer_double(f: torch.Tensor,
                   max_iters: int | None = None) -> torch.Tensor:
    """Iterate f <- f∘f; returns the terminal reached from each node
    (``f`` maps node -> node with self-loops at terminals).

    Runs EXACTLY ``min(max_iters, ceil(log2 n) + 1)`` rounds, where the
    reference runs a while-loop that also exits once ``g∘g == g``. The
    outputs are identical: the reference exits only at a g with
    g∘g = g, and every further round maps such a g to g[g] = g, so the
    rounds this loop runs past that point change nothing. A cyclic
    input (hostile origins) has no such point before the cap, or
    reaches one and stays there, so both loops stop at the same value;
    tests/test_torch_device.py pins a cyclic input.

    Gathers: ``g`` holds node indices in [0, n) by construction (every
    caller builds ``f`` from in-range pointers and self-loops)."""
    n = f.shape[0]
    cap = _round_cap(n)
    rounds = cap if max_iters is None else max(1, min(max_iters, cap))
    g = f
    for _ in range(rounds):
        g = g[g]
    return g


# low 32 bits of the packed (pointer, distance) word hold the distance;
# ~_W_DIST is the 64-bit mask of the pointer half
_W_DIST = (1 << 32) - 1


def wyllie_dist(succ: torch.Tensor, rounds: int | None) -> torch.Tensor:
    """Distance-to-terminal along ``succ`` for every node (terminals
    are self-loops), by pointer doubling with the (pointer, distance)
    pair packed into ONE int64 per node: one random gather a round.

    With ``rounds`` given, runs ``min(rounds, ceil(log2 m) + 1)``
    rounds (the reference's fixed ``fori_loop`` form); callers
    guarantee 2**rounds >= the longest path. With ``rounds=None`` it
    reproduces the reference's early-exit while-loop without a host
    sync: every one of the ``ceil(log2 m) + 1`` rounds runs, but a
    device flag freezes the state from the first round in which no
    pointer moved. (Unlike in :func:`pointer_double`, rounds past that
    point are not no-ops on a cyclic input: a cycle whose length is a
    power of two brings every pointer home while its distances keep
    growing.) Gathers: the pointer half holds node indices in [0, m)
    by construction."""
    m = succ.shape[0]
    idx = torch.arange(m, dtype=torch.int32, device=succ.device)
    dist0 = (succ != idx).to(torch.int64)
    comb = (succ.to(torch.int64) << 32) | dist0
    cap = _round_cap(m)
    if rounds is not None:
        for _ in range(min(rounds, cap)):
            c2 = comb[comb >> 32]
            newd = (comb & _W_DIST) + (c2 & _W_DIST)
            comb = (c2 & ~_W_DIST) | newd
        return (comb & _W_DIST).to(torch.int32)
    ptr = comb >> 32
    active = (ptr[ptr] != ptr).any()
    for _ in range(cap):
        ptr = comb >> 32
        c2 = comb[ptr]
        newd = (comb & _W_DIST) + (c2 & _W_DIST)
        comb = torch.where(active, (c2 & ~_W_DIST) | newd, comb)
        active = active & ((c2 >> 32) != ptr).any()
    return (comb & _W_DIST).to(torch.int32)


def dfs_ranks(
    parent: torch.Tensor,       # [B] int32 tree parent (root children
                                #     point at B+seg; non-items at B+num_roots)
    next_sib: torch.Tensor,     # [B] int32 next sibling, NULLI at group end
    first_child: torch.Tensor,  # [B+num_roots] int32 first child per node
    is_item: torch.Tensor,      # [B] bool real tree members
    num_roots: int,
    rank_rounds: int | None,
) -> torch.Tensor:
    """Distance-to-end of the DFS traversal for every node (items and
    the virtual roots appended after them) via successor pointer
    doubling (Wyllie list ranking).

    The DFS successor of a node is its first child if any, else the
    next sibling of the nearest ancestor (itself included) that has
    one — the climb past last-child chains, itself a pointer doubling.
    ``rank_rounds`` (host-computed from the largest segment) fixes both
    doubling loops' round counts; ``None`` gives the reference's
    early-exit loops (see :func:`wyllie_dist`)."""
    B = parent.shape[0]
    m = B + num_roots
    dev = parent.device
    idx_m = torch.arange(m, dtype=torch.int32, device=dev)
    pad_next = torch.cat([
        next_sib.to(torch.int32),
        torch.full((num_roots,), NULLI, dtype=torch.int32, device=dev),
    ])
    pad_parent = torch.cat([
        parent.to(torch.int32),
        torch.zeros(num_roots, dtype=torch.int32, device=dev),
    ])
    pad_item = torch.cat([
        is_item, torch.zeros(num_roots, dtype=torch.bool, device=dev),
    ])

    # g: last children climb to their parent (an item's parent is a
    # node in [0, m)), every other node is a fixed point
    is_last_child = (idx_m < B) & (pad_next == NULLI) & pad_item
    g = torch.where(is_last_child, pad_parent, idx_m)
    climb_t = pointer_double(g, max_iters=rank_rounds)

    # clamp as the reference does
    y_next = pad_next[climb_t.clamp(0, m - 1)]
    succ = torch.where((climb_t >= B) | (y_next < 0), idx_m, y_next)
    succ = torch.where(
        first_child >= 0, first_child.clamp(0, m - 1), succ
    )
    succ = torch.where(pad_item | (idx_m >= B), succ, idx_m)

    return wyllie_dist(succ.to(torch.int32), rounds=rank_rounds)
