"""The device side of a run: the card check, the traced window, the
kernels' rooflines and the idle share.

The peak is the published figure of one NVIDIA H100 SXM (NVIDIA's
data sheet, at the card's full 700 W): 3.35 TB/s of HBM3 bandwidth.
Both kernels the cells drive are bound by bytes; an instruction-bound
kernel (``sv_deficit``, whose int32 sums would be held against 132 SMs
x 64 lanes x 1.98 GHz = 16.7 T operations a second) gets its own count
with the cell that drives it. A kernel's roofline share is the least
time its inputs need at the peak over the device time the profiler
traced for it, in percent.
"""

from __future__ import annotations

import re
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

HBM_BYTES_PER_S = 3.35e12

# kernel -> pattern of the device functions its launches run (the
# demangled names the profiler records)
KERNELS = {
    "seg_argmax_scan": re.compile(r"scan_tiles|clear_words"),
    "stream_scatter": re.compile(
        r"\(anonymous namespace\)::(fill_holes|scatter)\("),
}


def seg_argmax_scan_bytes(rows: int) -> int:
    """Bytes the scan needs for ``rows`` live rows: the client and the
    run-start flag read (4 + 4), the argmax position written (4)."""
    return 12 * rows


def stream_scatter_bytes(targets: int) -> int:
    """Bytes the scatter needs for ``targets`` in-range targets: each
    target read (4) and the slot it fills written (4)."""
    return 8 * targets


BYTES = {"seg_argmax_scan": seg_argmax_scan_bytes,
         "stream_scatter": stream_scatter_bytes}


def require_cards(n: int) -> Tuple[str, int]:
    """(card name, cards) where at least ``n`` CUDA cards are present;
    raises SystemExit otherwise. Never falls back to the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: torch.cuda.is_available() is false")
    have = torch.cuda.device_count()
    if have < n:
        raise SystemExit(f"the cell needs {n} CUDA cards, {have} present")
    return torch.cuda.get_device_name(0), have


class KernelCalls:
    """Counts, during the traced window, the live rows of every call
    the program makes to the two converge kernels, by wrapping the
    names the packed converge calls them through. The counts are
    device scalars read after the window, so the window adds no host
    sync."""

    def __init__(self):
        self.pending: Dict[str, List] = {k: [] for k in BYTES}
        self._undo = []

    def __enter__(self):
        from crdt_tpu_torch.ops import packed

        scan, scatter = packed.seg_argmax_scan, packed.stream_scatter

        def counted_scan(client, flags):
            self.pending["seg_argmax_scan"].append((client >= 0).sum())
            return scan(client, flags)

        def counted_scatter(pos, n_out):
            self.pending["stream_scatter"].append(
                ((pos >= 0) & (pos < n_out)).sum())
            return scatter(pos, n_out)

        packed.seg_argmax_scan = counted_scan
        packed.stream_scatter = counted_scatter
        self._undo = [(packed, "seg_argmax_scan", scan),
                      (packed, "stream_scatter", scatter)]
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._undo:
            setattr(mod, name, fn)
        return False

    def totals(self) -> Dict[str, Dict[str, int]]:
        """{kernel: {"calls", "bytes"}} over the window."""
        out = {}
        for k, counts in self.pending.items():
            rows = [int(c) for c in counts]
            out[k] = {"calls": len(rows), "bytes": sum(BYTES[k](r)
                                                       for r in rows)}
        return out


def _union(spans: List[Tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


class Window:
    """The traced window's device record: every device activity the
    profiler saw (kernel, copy, set) between the window's start and end
    on the host clock, mapped onto that clock."""

    def __init__(self, events: List[Tuple[str, float, float]],
                 t0: float, t1: float):
        self.events = [(n, max(a, t0), min(b, t1)) for n, a, b in events
                       if b > t0 and a < t1]
        self.t0, self.t1 = t0, t1

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    @property
    def busy_s(self) -> float:
        return _union([(a, b) for _, a, b in self.events])

    def kernel_s(self, kernel: str) -> float:
        pat = KERNELS[kernel]
        return sum(b - a for n, a, b in self.events if pat.search(n))

    def top_ops(self, k: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for n, a, b in self.events:
            by[n] = by.get(n, 0.0) + (b - a)
        return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])
                [:k]]

    def idle_gaps(self, host_spans: List[Tuple[str, float, float]],
                  k: int = 10) -> List[List]:
        """The ``k`` longest stretches with nothing on the device, each
        named by the host span (the program's or the load driver's) whose
        intervals cover most of it in all."""
        gaps = []
        end = self.t0
        for _, a, b in sorted(self.events, key=lambda e: e[1]):
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if self.t1 > end:
            gaps.append((end, self.t1))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:k]:
            cover: Dict[str, float] = {}
            for name, s, e in host_spans:
                c = min(b, e) - max(a, s)
                if c > 0:
                    cover[name] = cover.get(name, 0.0) + c
            out.append([max(cover, key=cover.get) if cover else "host",
                        b - a])
        return out


def roofline_pct(kernel: str, calls: Dict, win: Window) -> Optional[float]:
    """The kernel's share of its roofline over the window, or None where
    it did not run there or moved no live bytes (a share of 0 would
    stand for a reading the run did not give)."""
    t = win.kernel_s(kernel)
    c = calls.get(kernel)
    if not c or not c["calls"] or not c["bytes"] or t <= 0:
        return None
    return 100.0 * (c["bytes"] / HBM_BYTES_PER_S) / t


@contextmanager
def traced(device: str):
    """Profile the block; yields a dict that holds, once the block has
    ended, ``window`` (a :class:`Window` on the host clock) and
    ``calls`` (the converge kernels' live rows). Only device activity
    is traced, and the raw events are read without building the
    profiler's per-op tables, so a traced window of a minute costs
    seconds to read, not minutes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA if device == "cuda"
            else ProfilerActivity.CPU]
    out: Dict = {}
    with KernelCalls() as kc:
        with profile(activities=acts) as prof:
            # the profiler stamps events in epoch nanoseconds
            base_ns = time.time_ns() - time.perf_counter_ns()
            t0 = time.perf_counter()
            yield out
            if device == "cuda":
                torch.cuda.synchronize()
            t1 = time.perf_counter()
    out["calls"] = kc.totals()
    dev = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        kind = e.activity_type() if hasattr(e, "activity_type") else ""
        # annotations are mirrored on the device's timeline; they are
        # not device work
        if e.is_user_annotation() or "annotation" in kind:
            continue
        a = (e.start_ns() - base_ns) / 1e9
        dev.append((e.name(), a, a + e.duration_ns() / 1e9))
    out["window"] = Window(dev, t0, t1)
