"""The port's four hand-written kernels: wrappers and plain versions.

The port's counterpart of ``crdt_tpu.ops.pallas_kernels``:

- :func:`seg_argmax_scan` — segmented inclusive argmax over contiguous
  runs, the LWW map-winner scan (``csrc/seg_argmax_scan.cu``);
- :func:`stream_scatter` — the document-order scatter
  ``out[pos[i]] = i`` (``csrc/stream_scatter.cu``);
- :func:`ds_mask` — delete-set membership of every item
  (``csrc/ds_mask.cu``);
- :func:`sv_deficit` — the pairwise state-vector deficit, the
  anti-entropy plan (``csrc/sv_deficit.cu``).

Each wrapper checks its input and dispatches on where the tensor
lies: a CPU tensor takes the plain PyTorch version beside it (the CPU
tests run that), a CUDA tensor launches the hand-written kernel on the
current stream or raises — there is no fallback from the card to the
plain version. Each wrapper counts its launches in ``.launches``,
incremented where the kernel is launched and nowhere else.

Unlike the TPU kernels, none has a width guard or a crossover: the
CUDA scan tiles the block and carries across tiles by decoupled
look-back, ``ds_mask`` binary searches the ranges for any D (sorting
them on the device only when they arrive out of order), and
``sv_deficit`` runs int32 tiles with an int64 path for any staged
chunk outside their envelope, so every size runs on the card.
"""

from __future__ import annotations

import torch

from crdt_tpu_torch.ops import _build
from crdt_tpu_torch.ops.device import lexsort

NULL_I32 = -1
_I64_MIN = -(1 << 63)


def _check_i32(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.int32 or t.dim() != 1:
        raise ValueError(f"{name} must be a 1-D int32 tensor, got "
                         f"{t.dtype} of shape {tuple(t.shape)}")


def _stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with its data 16-byte aligned, as the kernels'
    16-byte loads take it: ``t`` itself when it is, else a copy (a view
    at an odd offset keeps that offset under ``contiguous()``)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_i32_count(name: str, n: int) -> None:
    if n >= 1 << 31:
        raise ValueError(f"{name} takes fewer than 2**31 elements")


# ---------------------------------------------------------------------------
# segmented argmax scan
# ---------------------------------------------------------------------------


_LOW32 = (1 << 32) - 1


def seg_argmax_scan_plain(client: torch.Tensor,
                          flags: torch.Tensor) -> torch.Tensor:
    """Plain version: the kernel's combine on one int64 key a position,
    ``client * 2**32 + (2**32 - 1 - position)``, so that the larger key
    is the larger client and, among equal clients, the EARLIER
    position. In log-step shifted selects (Hillis–Steele): round s
    gives every position the max of its key and the window's ending s
    before it, unless a run start lies in its own window."""
    n = client.shape[0]
    pos = torch.arange(n, dtype=torch.int64, device=client.device)
    key = (client.to(torch.int64) << 32) | (_LOW32 - pos)
    f = flags != 0
    s = 1
    while s < n:
        key = torch.cat([key[:s], torch.where(
            f[s:], key[s:], torch.maximum(key[:-s], key[s:]))])
        f = torch.cat([f[:s], f[s:] | f[:-s]])
        s <<= 1
    return (_LOW32 - (key & _LOW32)).to(torch.int32)


def seg_argmax_scan(client: torch.Tensor,
                    flags: torch.Tensor) -> torch.Tensor:
    """Per-position inclusive argmax over contiguous runs.

    ``client`` [N] int32 (the Lamport major key; -1 on padding rows),
    ``flags`` [N] int32 (nonzero = run start; padding rows are their
    own runs). Returns [N] int32: the position holding the run-prefix
    argmax — read at a run's END it is the run's argmax."""
    _check_i32("client", client)
    _check_i32("flags", flags)
    if client.shape != flags.shape or client.device != flags.device:
        raise ValueError("client and flags must match in shape and device")
    if not client.is_cuda:
        return seg_argmax_scan_plain(client, flags)
    n = client.shape[0]
    _check_i32_count("seg_argmax_scan", n)
    lib = _build.library("seg_argmax_scan")
    client = aligned16(client)
    flags = aligned16(flags)
    out = torch.empty(n, dtype=torch.int32, device=client.device)
    scratch = torch.empty(lib.seg_argmax_scan_scratch_words(n),
                          dtype=torch.int64, device=client.device)
    _build.check(lib.seg_argmax_scan_launch(
        client.data_ptr(), flags.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), n, _stream_handle(client),
    ), "seg_argmax_scan launch")
    seg_argmax_scan.launches += 1
    return out


seg_argmax_scan.launches = 0


# ---------------------------------------------------------------------------
# document-order scatter
# ---------------------------------------------------------------------------


def stream_scatter_plain(pos: torch.Tensor, n_out: int) -> torch.Tensor:
    """Plain version: a masked ``index_put_``. Negative and
    past-the-end targets are dropped before the write, so a negative
    target never wraps."""
    out = torch.full((n_out,), NULL_I32, dtype=torch.int32,
                     device=pos.device)
    keep = (pos >= 0) & (pos < n_out)
    idx = torch.arange(pos.shape[0], dtype=torch.int32, device=pos.device)
    out.index_put_((pos[keep].long(),), idx[keep])
    return out


def stream_scatter(pos: torch.Tensor, n_out: int) -> torch.Tensor:
    """Document-order assembly: ``out[pos[i]] = i`` over int32
    positions (targets outside [0, n_out) are dropped — callers route
    invalid rows there). Returns [n_out] int32 with -1 holes. Targets
    must be unique."""
    _check_i32("pos", pos)
    if n_out < 0:
        raise ValueError(f"n_out must be >= 0, got {n_out}")
    if not pos.is_cuda:
        return stream_scatter_plain(pos, n_out)
    _check_i32_count("stream_scatter", max(pos.shape[0], n_out))
    lib = _build.library("stream_scatter")
    pos = pos.contiguous()
    out = torch.empty(n_out, dtype=torch.int32, device=pos.device)
    _build.check(lib.stream_scatter_launch(
        pos.data_ptr(), pos.shape[0], out.data_ptr(), n_out,
        _stream_handle(pos),
    ), "stream_scatter launch")
    stream_scatter.launches += 1
    return out


stream_scatter.launches = 0


# ---------------------------------------------------------------------------
# delete-set membership
# ---------------------------------------------------------------------------


def _search_key(client: torch.Tensor) -> torch.Tensor:
    """int64 whose signed order is the client's order as an UNSIGNED
    64-bit value (the sign bit flipped): negative clients, the null
    fillers among them, order after every real one."""
    return client.to(torch.int64) ^ _I64_MIN


def ds_sorted_ranges(d_client: torch.Tensor, d_start: torch.Tensor,
                     d_end: torch.Tensor):
    """The D ranges in search order, by (client compared unsigned,
    start), with the running max of ``end`` over each client's ranges
    so far: the preparation both versions of :func:`ds_mask` search.

    Ranges already in search order (the fleet's normalized delete set
    with its trailing null fillers) are taken as given; only ranges
    out of order are lexsorted. The running max is a log-step
    segmented max scan over runs of equal client, which lie together
    in search order. Returns (client, start, run_max), each [D] int64."""
    rc = d_client.to(torch.int64)
    rs = d_start.to(torch.int64)
    re = d_end.to(torch.int64)
    key = _search_key(rc)
    d = rc.shape[0]
    in_order = ((key[1:] > key[:-1])
                | ((key[1:] == key[:-1]) & (rs[1:] >= rs[:-1]))).all()
    if not bool(in_order):
        order = lexsort([key, rs])
        rc, rs, re, key = rc[order], rs[order], re[order], key[order]
    run_max = re.clone()
    s = 1
    while s < d:
        run_max[s:] = torch.where(key[s:] == key[:-s],
                                  torch.maximum(run_max[s:], run_max[:-s]),
                                  run_max[s:])
        s <<= 1
    return rc, rs, run_max


def ds_mask_plain(client: torch.Tensor, clock: torch.Tensor,
                  valid: torch.Tensor, d_client: torch.Tensor,
                  d_start: torch.Tensor,
                  d_end: torch.Tensor) -> torch.Tensor:
    """Plain version: the kernel's algorithm as whole-tensor torch ops
    — :func:`ds_sorted_ranges`, then per item a binary search
    (vectorized over the items, one round per halving) for the last
    range whose key (client, start) is <= the item's (client, clock),
    then the same-client and running-max-end test."""
    rc, rs, run_max = ds_sorted_ranges(d_client, d_start, d_end)
    d = rc.shape[0]
    if d == 0:
        return torch.zeros_like(valid, dtype=torch.bool)
    key = _search_key(rc)
    ci = _search_key(client)
    ti = clock.to(torch.int64)
    lo = torch.zeros_like(ci)
    hi = torch.full_like(ci, d)
    for _ in range(d.bit_length()):
        live = lo < hi
        mid = torch.div(lo + hi, 2, rounding_mode="floor").clamp(max=d - 1)
        cm = key[mid]
        le = (cm < ci) | ((cm == ci) & (rs[mid] <= ti))
        lo = torch.where(live & le, mid + 1, lo)
        hi = torch.where(live & ~le, mid, hi)
    p = lo - 1
    pc = p.clamp(min=0)
    return (valid.to(torch.bool) & (p >= 0) & (key[pc] == ci)
            & (run_max[pc] > ti))


def ds_mask_prepare(d_client: torch.Tensor, d_start: torch.Tensor,
                    d_end: torch.Tensor) -> torch.Tensor:
    """The card half of :func:`ds_sorted_ranges`: launches
    ``ds_mask.cu``'s preparation of the D CUDA ranges (order check,
    sort only when out of order, running max) and returns its int64
    scratch, which :func:`ds_mask_search` reads. No host sync."""
    lib = _build.library("ds_mask")
    dc, ds_, de = (t.to(torch.int64).contiguous()
                   for t in (d_client, d_start, d_end))
    d = dc.shape[0]
    scratch = torch.empty(lib.ds_mask_scratch_words(d), dtype=torch.int64,
                          device=dc.device)
    _build.check(lib.ds_mask_prepare(
        dc.data_ptr(), ds_.data_ptr(), de.data_ptr(), d, scratch.data_ptr(),
        _stream_handle(dc),
    ), "ds_mask prepare")
    return scratch


def ds_mask_in_order(scratch: torch.Tensor, d: int) -> bool:
    """Whether :func:`ds_mask_prepare` found its d ranges in search
    order, so that nothing was sorted: the kernel's ``disorder`` flag,
    the first int32 of the scratch (``Layout::head`` in ``ds_mask.cu``).
    Reads the card, so it syncs; the wrapper never calls it."""
    return d == 0 or int(scratch.view(torch.int32)[0]) == 0


def ds_mask_search(client: torch.Tensor, clock: torch.Tensor,
                   valid: torch.Tensor, d: int,
                   scratch: torch.Tensor) -> torch.Tensor:
    """Launches ``ds_mask.cu``'s search of N CUDA items against the d
    ranges :func:`ds_mask_prepare` left in ``scratch``; [N] bool."""
    lib = _build.library("ds_mask")
    client = client.contiguous()
    clock = clock.to(torch.int64).contiguous()
    valid = valid.to(torch.bool).contiguous()
    n = client.shape[0]
    out = torch.empty(n, dtype=torch.bool, device=client.device)
    _build.check(lib.ds_mask_search(
        client.data_ptr(), clock.data_ptr(), valid.data_ptr(), n, d,
        scratch.data_ptr(), out.data_ptr(), _stream_handle(client),
    ), "ds_mask search")
    return out


def ds_mask(client: torch.Tensor, clock: torch.Tensor, valid: torch.Tensor,
            d_client: torch.Tensor, d_start: torch.Tensor,
            d_end: torch.Tensor) -> torch.Tensor:
    """Delete-set membership: [N] bool, True where ``valid[i]`` and
    some range d has ``client[i] == d_client[d]`` and
    ``d_start[d] <= clock[i] < d_end[d]`` — the TPU kernel's dense
    semantics, exact over int64 and for overlapping ranges too.

    ``client`` [N] int32, ``clock`` [N] int64 (or int32), ``valid``
    [N] bool; the D ranges in any integer dtype, in any order (null
    fillers with client -1 and start = end match nothing). Ranges in
    search order (see :func:`ds_sorted_ranges`) are not sorted; on the
    card the kernel decides that itself, with no host sync. Any D runs
    on the card, 0 included."""
    _check_i32("client", client)
    n = client.shape[0]
    if clock.shape != (n,) or valid.shape != (n,):
        raise ValueError("client, clock and valid must be [N]")
    if not (d_client.shape == d_start.shape == d_end.shape) \
            or d_client.dim() != 1:
        raise ValueError("d_client, d_start and d_end must be [D]")
    tensors = (client, clock, valid, d_client, d_start, d_end)
    if any(t.device != client.device for t in tensors):
        raise ValueError("ds_mask inputs must share one device")
    if any(t.is_floating_point() or t.is_complex()
           for t in (clock, d_client, d_start, d_end)):
        raise ValueError("ds_mask clocks and ranges must be integers")
    if not client.is_cuda:
        return ds_mask_plain(*tensors)
    d = d_client.shape[0]
    if n >= 1 << 31 or d >= 1 << 31:
        raise ValueError("ds_mask takes fewer than 2**31 items and ranges")
    if n == 0:
        return torch.empty(0, dtype=torch.bool, device=client.device)
    out = ds_mask_search(client, clock, valid, d,
                         ds_mask_prepare(d_client, d_start, d_end))
    ds_mask.launches += 1
    return out


ds_mask.launches = 0


# ---------------------------------------------------------------------------
# pairwise state-vector deficit (the anti-entropy plan)
# ---------------------------------------------------------------------------

# row chunk of the plain version: at most ~16M live [chunk, R, C] terms
_SV_PLAIN_TERMS = 1 << 24


def deficit_rows(rows: torch.Tensor, svs: torch.Tensor) -> torch.Tensor:
    """[B, C] x [R, C] -> [B, R] int64: ``sum_c max(rows[b, c] -
    svs[r, c], 0)``, by a scan over chunks of ``rows`` that never
    builds [B, R, C] (the reference's ``exact_missing_rows`` takes one
    row a step; a chunk of rows is the same sum)."""
    b, c = rows.shape
    r = svs.shape[0]
    out = torch.empty((b, r), dtype=torch.int64, device=svs.device)
    s = svs.to(torch.int64)
    step = max(1, _SV_PLAIN_TERMS // max(r * c, 1))
    for i0 in range(0, b, step):
        blk = rows[i0:i0 + step].to(torch.int64)
        out[i0:i0 + step] = (blk[:, None, :] - s[None, :, :]).clamp_min(
            0).sum(dim=2)
    return out


def sv_deficit_plain(svs: torch.Tensor) -> torch.Tensor:
    """Plain version: :func:`deficit_rows` of every row against all."""
    return deficit_rows(svs, svs)


def sv_deficit(svs: torch.Tensor) -> torch.Tensor:
    """Pairwise deficit of [R, C] int64 state vectors:
    ``out[i, j] = sum_c max(svs[i, c] - svs[j, c], 0)``, [R, R] int64,
    exact for any clock values whose spread within a column is below
    2**63 (the kernel checks its int32 envelope per staged chunk on the
    card and takes int64 for a chunk outside it)."""
    if svs.dim() != 2 or svs.dtype != torch.int64:
        raise ValueError(f"svs must be a 2-D int64 tensor, got {svs.dtype} "
                         f"of shape {tuple(svs.shape)}")
    if not svs.is_cuda:
        return sv_deficit_plain(svs)
    r, c = svs.shape
    if r >= 1 << 31 or c >= 1 << 31:
        raise ValueError("sv_deficit takes fewer than 2**31 rows and columns")
    lib = _build.library("sv_deficit")
    svs = svs.contiguous()
    out = torch.empty((r, r), dtype=torch.int64, device=svs.device)
    if r == 0:
        return out
    sums = torch.empty(r, dtype=torch.int64, device=svs.device)
    _build.check(lib.sv_deficit_launch(
        svs.data_ptr(), r, c, sums.data_ptr(), out.data_ptr(),
        _stream_handle(svs),
    ), "sv_deficit launch")
    sv_deficit.launches += 1
    return out


sv_deficit.launches = 0


WRAPPERS = (seg_argmax_scan, stream_scatter, ds_mask, sv_deficit)


def reset_launches() -> None:
    """Set every wrapper's launch count to 0."""
    for w in WRAPPERS:
        w.launches = 0


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    return {w.__name__: w.launches for w in WRAPPERS}
