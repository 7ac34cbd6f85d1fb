"""The work of the replica-fleet round's two kernels, ``sv_deficit`` and
``ds_mask``, from the operand sizes the program counts at each call,
and their shares of the roofline over a traced window.

The peaks are those :mod:`benchmark.harness.device` names, for one
NVIDIA H100 SXM at its full 700 W: 3.35 TB/s of HBM3, and 64 INT32
lanes an SM (NVIDIA's H100 architecture white paper) x 132 SMs x the
1.98 GHz boost clock (the data sheet) = 16.7 T integer operations a
second outside the tensor cores.

``sv_deficit`` (``crdt_tpu_torch/csrc/sv_deficit.cu``) is bound by
operations: out[i, j] = sum_c max(svs[i, c] - svs[j, c], 0) over R
state vectors of C clients. The least work, as the kernel does it:
out[i, j] = M[i, j] - rowsum[j] with M[i, j] = sum_c max(svs[i, c],
svs[j, c]), symmetric, so M needs only the R(R + 1)/2 unordered pairs;
each of their C terms costs one max and half an add (IADD3 adds two
terms at once), 3/2 operations, so M is 3R(R + 1)C/4; the row sums
are R x C adds, and the subtractions R^2. At R = 1000, C = 1002 that is
754,253,500 operations, 0.0451 ms at the peak.

``ds_mask`` (``crdt_tpu_torch/csrc/ds_mask.cu``) is bound by bytes: an
item's client (4), clock (8) and valid flag (1) read and its mask (1)
written, 14 bytes; a range's client, start and end (24) read once. At
N = 2,048,000 items and D = 131,072 ranges that is 31,817,728 bytes,
0.0095 ms at the peak.

Each kernel's device time is the sum of the traced window's device
events whose names match its pattern: the launches its wrapper makes.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

from benchmark.harness.device import HBM_BYTES_PER_S

INT32_OPS_PER_S = 64 * 132 * 1.98e9

# kernel -> pattern of the device functions its launches run
SV_DEFICIT = re.compile(r"sv_deficit_tile|row_sums")
DS_MASK = re.compile(r"run_max_scan|order_tile|merge_runs|ds_search")


def sv_deficit_ops(rows: int, clients: int) -> int:
    """INT32 operations one launch over [rows, clients] needs."""
    r, c = rows, clients
    return 3 * r * (r + 1) * c // 4 + r * c + r * r


def ds_mask_bytes(items: int, ranges: int) -> int:
    """Bytes one launch over ``items`` items and ``ranges`` ranges
    needs."""
    return 14 * items + 24 * ranges


def sv_deficit_s(counters: Dict) -> Optional[float]:
    """Seconds the window's launches need at the peak, from the counters
    ``sv_deficit.cells`` (sum of R x R x C), ``.entries`` (sum of
    R x C) and ``.pairs`` (sum of R x R): :func:`sv_deficit_ops` summed
    over the launches, whatever their shapes; None where they are
    absent."""
    cells = counters.get("sv_deficit.cells")
    if not cells or "sv_deficit.entries" not in counters:
        return None
    entries = counters["sv_deficit.entries"]
    ops = 3 * (cells + entries) / 4 + entries + counters["sv_deficit.pairs"]
    return ops / INT32_OPS_PER_S


def ds_mask_s(counters: Dict) -> Optional[float]:
    """Seconds the window's launches need at the peak, from the
    counters ``ds_mask.items`` (sum of N) and ``ds_mask.ranges`` (sum
    of D); None where they are absent."""
    items = counters.get("ds_mask.items")
    if not items:
        return None
    return ds_mask_bytes(items, counters.get("ds_mask.ranges", 0)) \
        / HBM_BYTES_PER_S


def kernel_s(pattern: re.Pattern, window) -> float:
    """Device seconds of the window's events that match ``pattern``."""
    return sum(b - a for n, a, b in window.events if pattern.search(n))


def roofline_pct(need_s: Optional[float], pattern: re.Pattern,
                 window) -> Optional[float]:
    """``need_s`` over the kernel's traced device time, percent; None
    where either is missing."""
    if need_s is None or window is None:
        return None
    t = kernel_s(pattern, window)
    if t <= 0:
        return None
    return 100.0 * need_s / t
