"""The converge hot path's two kernels: wrappers and plain versions.

The port's counterpart of the converge half of
``crdt_tpu.ops.pallas_kernels``:

- :func:`seg_argmax_scan` — segmented inclusive argmax over contiguous
  runs, the LWW map-winner scan (``csrc/seg_argmax_scan.cu``);
- :func:`stream_scatter` — the document-order scatter
  ``out[pos[i]] = i`` (``csrc/stream_scatter.cu``).

Each wrapper checks its input and dispatches on where the tensor
lies: a CPU tensor takes the plain PyTorch version beside it (the CPU
tests run that), a CUDA tensor launches the hand-written kernel on the
current stream or raises — there is no fallback from the card to the
plain version. Each wrapper counts its launches in ``.launches``,
incremented where the kernel is launched and nowhere else.

Unlike the TPU kernels, neither has a width guard: the CUDA scan tiles
the block and carries across tiles, so any length runs on the card.
"""

from __future__ import annotations

import torch

from crdt_tpu_torch.ops import _build

NULL_I32 = -1


def _check_i32(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.int32 or t.dim() != 1:
        raise ValueError(f"{name} must be a 1-D int32 tensor, got "
                         f"{t.dtype} of shape {tuple(t.shape)}")


def _stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# segmented argmax scan
# ---------------------------------------------------------------------------


def seg_argmax_scan_plain(client: torch.Tensor,
                          flags: torch.Tensor) -> torch.Tensor:
    """Plain version: the oracle's segmented-scan operator on
    (client, arg, flag) in log-step shifted selects (Hillis–Steele).
    Round s combines every position with the window ending s before
    it unless a run start lies in between; equal clients keep the
    EARLIER position."""
    n = client.shape[0]
    c = client.to(torch.int32)
    a = torch.arange(n, dtype=torch.int32, device=client.device)
    f = flags != 0
    s = 1
    while s < n:
        pc, pa, pf = c[:-s], a[:-s], f[:-s]
        cc, ca, cf = c[s:], a[s:], f[s:]
        take = ~cf & ((pc > cc) | ((pc == cc) & (pa < ca)))
        c = torch.cat([c[:s], torch.where(take, pc, cc)])
        a = torch.cat([a[:s], torch.where(take, pa, ca)])
        f = torch.cat([f[:s], cf | pf])
        s <<= 1
    return a


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
    lib = _build.library("seg_argmax_scan")
    client = client.contiguous()
    flags = flags.contiguous()
    n = client.shape[0]
    out = torch.empty_like(client)
    tiles = -(-n // lib.seg_argmax_scan_tile())
    scratch = torch.empty(
        max(tiles, 1) * lib.seg_argmax_scan_scratch_ints(),
        dtype=torch.int32, device=client.device,
    )
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


WRAPPERS = (seg_argmax_scan, stream_scatter)


def reset_launches() -> None:
    """Set every wrapper's launch count to 0."""
    for w in WRAPPERS:
        w.launches = 0


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    return {w.__name__: w.launches for w in WRAPPERS}
