#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the card.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and this checkout; imports nothing of
JAX or of the reference package. Phases, each fatal on failure:

  1. print the card's name and power limit (``nvidia-smi``);
  2. build every hand-written kernel from ``crdt_tpu_torch/csrc`` (one
     ``nvcc`` per source, all at once) and print the build time;
  3. hold each kernel against its plain PyTorch version on the card on
     edge cases, exact int32 equality;
  4. replay the benchmark's traces (1000 replicas x 100 ops, the
     conflict trace, and the 16x scale trace of 1000 x 1600 ops) with
     ``device="cuda"`` and ``device="cpu"``: caches (``json.dumps``
     with sorted keys) and snapshots must be identical, both kernels'
     launch counts must be > 0 in every card run (counts are zeroed
     just before each run and read just after), and each kernel must
     equal its plain version, exactly, on the inputs the run gave it;
     one more card replay of each trace under the profiler gives the
     share of it in which the card is busy;
  5. time each kernel on the inputs each card run gave it, against its
     byte bound, its plain version and (where one exists) one library
     call.

The line before the last is the kernels JSON object, at the scale
run's shapes; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero with no result line
when there is no card or the package is not beside this script.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, data sheet

ROOT = Path(__file__).resolve().parent

# the TPU kernel each CUDA kernel replaces
REPLACES = {
    "seg_argmax_scan": "crdt_tpu/ops/pallas_kernels.py:441",
    "stream_scatter": "crdt_tpu/ops/pallas_kernels.py:544",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int, batches: int = 5) -> float:
    """Median over ``batches`` of the mean device time of ``iters``
    back-to-back calls, by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(batches):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        e.synchronize()
        per.append(s.elapsed_time(e) / iters)
    return statistics.median(per)


def traced_device_us(torch, run) -> float:
    """Microseconds of device activity (every kernel, memset and copy)
    the profiler traces while ``run()`` runs and the card drains."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA)


def device_ms(torch, fn, iters: int) -> float:
    """Mean device time of one call: the traced device activity of
    ``iters`` calls over ``iters``. Unlike :func:`cuda_ms` it leaves out
    the gaps in which the card waits for the host to enqueue."""
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()

    us = traced_device_us(torch, run)
    if us <= 0:
        raise RuntimeError("the profiler traced no device time")
    return us / iters / 1e3


def timed(torch, fn, iters: int) -> tuple:
    """(device ms, wall ms, source of the device ms) of one call. The
    wall time (CUDA events around back-to-back calls) includes the host's
    enqueue when that is slower than the card; where the profiler
    traces nothing, the device time is the wall time, and says so."""
    wall = cuda_ms(torch, fn, iters)
    try:
        return device_ms(torch, fn, iters), wall, "profiler"
    except RuntimeError as e:
        log(f"profiler gave no device time ({e}); using CUDA events")
        return wall, wall, "events"


@contextmanager
def capture_kernel_inputs(packed_mod, seen: dict):
    """Record (a device copy of) every input the main path hands the
    two kernel wrappers, then call the real wrapper — the launch and
    its count are the main path's own."""
    orig_scan = packed_mod.seg_argmax_scan
    orig_scatter = packed_mod.stream_scatter

    def scan(client, flags):
        seen.setdefault("seg_argmax_scan", []).append(
            (client.clone(), flags.clone()))
        return orig_scan(client, flags)

    def scatter(pos, n_out):
        seen.setdefault("stream_scatter", []).append((pos.clone(), n_out))
        return orig_scatter(pos, n_out)

    packed_mod.seg_argmax_scan = scan
    packed_mod.stream_scatter = scatter
    try:
        yield
    finally:
        packed_mod.seg_argmax_scan = orig_scan
        packed_mod.stream_scatter = orig_scatter


def main() -> int:
    if not (ROOT / "crdt_tpu_torch" / "csrc").is_dir():
        return fail(f"crdt_tpu_torch/ not found beside {__file__}")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false")

    # ---- 1. the card ---------------------------------------------------
    smi = smi_line()
    log(f"card: {smi}")
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    from crdt_tpu_torch.models import replay as rp
    from crdt_tpu_torch.models import traces
    from crdt_tpu_torch.obs import Tracer, set_tracer
    from crdt_tpu_torch.ops import _build, kernels
    from crdt_tpu_torch.ops import packed as packed_mod

    # ---- 2. build ------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"build: {len(built)} kernels in "
        f"{time.perf_counter() - t0:.3f} s (parallel nvcc)")
    for name, b in built.items():
        ptxas = [ln.strip() for ln in b.log.splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"build {name}: {b.path.name} " + " | ".join(ptxas))
    for name in built:
        _build.library(name)

    dev = torch.device("cuda")
    max_err = {"seg_argmax_scan": 0, "stream_scatter": 0}

    def hold(name: str, got, want) -> None:
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(
                f"{name}: shape/dtype {tuple(got.shape)} {got.dtype} vs "
                f"{tuple(want.shape)} {want.dtype}")
        err = int((got.long() - want.long()).abs().max()) \
            if got.numel() else 0
        max_err[name] = max(max_err[name], err)
        if err:
            raise AssertionError(f"{name}: kernel != plain (max |d| {err})")

    def hold_scan(client, flags):
        hold("seg_argmax_scan", kernels.seg_argmax_scan(client, flags),
             kernels.seg_argmax_scan_plain(client, flags))

    def hold_scatter(pos, n_out):
        hold("stream_scatter", kernels.stream_scatter(pos, n_out),
             kernels.stream_scatter_plain(pos, n_out))

    # ---- 3. edge cases -------------------------------------------------
    g = torch.Generator(device="cpu").manual_seed(0)

    def ri(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=g,
                             dtype=torch.int32).to(dev)

    i32 = dict(dtype=torch.int32, device=dev)
    for n in (1, 2, 31, 2047, 2048, 2049, 70_001, 1_000_003):
        client = ri(0, 1 << 14, n)
        one_run = torch.zeros(n, **i32)
        one_run[0] = 1
        hold_scan(client, one_run)                        # all one run
        hold_scan(client, torch.ones(n, **i32))           # own runs
        hold_scan(torch.full((n,), 7, **i32), one_run)    # all ties
        flags = (ri(0, 50, n) == 0).to(torch.int32) * ri(1, 3, n)
        flags[0] = 1
        hold_scan(ri(0, 4, n), flags)                     # ties + runs
        pad = client.clone()
        pad_flags = flags.clone()
        tail = n // 3
        if tail:
            pad[n - tail:] = -1                           # padding tail
            pad_flags[n - tail:] = 1
        hold_scan(pad, pad_flags)
        no_start = flags.clone()
        no_start[0] = 0                                   # no opening flag
        hold_scan(client, no_start)
    hold_scan(torch.zeros(0, **i32), torch.zeros(0, **i32))
    for n in (1, 5, 2048, 40_961, 1_000_003):
        perm = torch.randperm(n, generator=g).to(torch.int32).to(dev)
        hold_scatter(perm, n)                             # permutation
        drop = perm.clone()
        drop[::7] = -1                                    # negative
        drop[3::11] = n + 5                               # past the end
        hold_scatter(drop, n)
        hold_scatter(perm, n // 2)                        # short output
    hold_scatter(torch.zeros(0, **i32), 4)
    hold_scatter(torch.arange(4, **i32), 0)
    log(f"kernel edge cases: kernel == plain on the card, exact "
        f"(max |d| {max_err})")
    # the first profiling session of a process may trace no device
    # activity while CUPTI starts up: open and discard one
    traced_device_us(torch, lambda: torch.ones(1, device=dev))

    # ---- 4. the main path ---------------------------------------------
    plans = [
        ("trace_1000x100", lambda: traces.build_trace(1000, 100, seed=0)),
        ("conflict_1000x100",
         lambda: traces.build_conflict_trace(1000, 100)),
        ("scale_1000x1600", lambda: traces.build_trace(1000, 1600, seed=0)),
    ]
    phase_names = ("decode", "pack", "converge.dispatch", "converge.fetch",
                   "gather", "materialize", "compact")
    launches = {"seg_argmax_scan": 0, "stream_scatter": 0}
    card_inputs: dict = {}
    for i, (label, build) in enumerate(plans):
        t0 = time.perf_counter()
        blobs = build()
        log(f"{label}: {len(blobs)} blobs, {sum(map(len, blobs))} bytes, "
            f"built in {time.perf_counter() - t0:.3f} s")
        if i == 0:
            # warm-up: CUDA context, library loads, allocator pools
            rp.replay_trace(blobs, device="cuda")
            torch.cuda.synchronize()
        runs = {}
        for device in ("cuda", "cpu"):
            tracer = set_tracer(Tracer(enabled=True))
            seen: dict = {}
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            with capture_kernel_inputs(packed_mod, seen):
                res = rp.replay_trace(blobs, device=device)
            wall = time.perf_counter() - t0
            counts = kernels.launch_counts()
            set_tracer(Tracer(enabled=False))
            spans = tracer.report()["spans"]
            phases = {p: round(spans[p]["total_s"], 6)
                      for p in phase_names if p in spans}
            log(f"{label} [{device}]: {res.n_ops} ops in {wall:.3f} s; "
                f"phases (s) {json.dumps(phases)}; launches {counts}")
            if device == "cuda":
                for name, c in counts.items():
                    if c <= 0:
                        raise AssertionError(
                            f"{label}: {name} never launched on the card")
                    launches[name] += c
                card_inputs[label] = seen
            elif any(counts.values()):
                raise AssertionError(f"{label}: CPU run launched {counts}")
            runs[device] = res
        a, b = runs["cuda"], runs["cpu"]
        if json.dumps(a.cache, sort_keys=True) != json.dumps(
                b.cache, sort_keys=True):
            raise AssertionError(f"{label}: card cache != CPU cache")
        if a.snapshot != b.snapshot:
            raise AssertionError(f"{label}: card snapshot != CPU snapshot")
        if not a.cache or not a.snapshot or a.n_ops != b.n_ops:
            raise AssertionError(f"{label}: empty or short result")
        log(f"{label}: card == CPU (cache {len(json.dumps(a.cache))} "
            f"chars, snapshot {len(a.snapshot)} bytes)")
        if i == 0:
            again = rp.replay_trace([a.snapshot], device="cuda")
            if again.cache != a.cache:
                raise AssertionError(f"{label}: snapshot replay differs")
            log(f"{label}: the compacted snapshot replays to the same cache")
        # one more card replay under the profiler: how much of it
        # the card is busy (the profiler slows the host a little)
        t0 = time.perf_counter()
        busy_us = traced_device_us(
            torch, lambda: rp.replay_trace(blobs, device="cuda"))
        wall = time.perf_counter() - t0
        log(f"{label}: device busy {busy_us / 1e3:.3f} ms of a "
            f"{wall * 1e3:.1f} ms profiled replay "
            f"(busy share {busy_us / 1e6 / wall:.5f})")
        # the kernels on exactly the inputs this run gave them
        for client, flags in card_inputs[label]["seg_argmax_scan"]:
            hold_scan(client, flags)
        for pos, n_out in card_inputs[label]["stream_scatter"]:
            hold_scatter(pos, n_out)
        log(f"{label}: kernel == plain on the run's own inputs")

    # ---- 5. timing at the main path's shapes ---------------------------
    for label, seen in card_inputs.items():
        rows = kernel_rows(torch, kernels, seen, launches, max_err)
        log(f"kernel times ({label}): " + json.dumps(rows))
    log(f"card: {smi}")
    # the kernels line carries the scale run's shapes (the last trace)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def kernel_rows(torch, kernels, seen: dict, launches: dict,
                max_err: dict) -> list:
    """One timed row per kernel on the inputs one card run gave it."""
    i32 = dict(dtype=torch.int32, device=torch.device("cuda"))
    client, flags = seen["seg_argmax_scan"][0]
    pos, n_out = seen["stream_scatter"][0]
    m, bsz = client.numel(), pos.numel()
    keep = (pos >= 0) & (pos < n_out)
    lib_idx = pos[keep].long()
    lib_val = torch.arange(bsz, **i32)[keep]
    lib_out = torch.full((n_out,), -1, **i32)

    def row(name, shape, kernel, plain, library, nbytes):
        ms, wall, src = timed(torch, kernel, 50)
        plain_ms, plain_wall, _ = timed(torch, plain, 5)
        lib = timed(torch, library, 50) if library else (None, None, None)
        return {
            "name": name,
            "shape": shape,
            "route": "cuda",
            "source": f"crdt_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": max_err[name],
            "ms": ms,
            "plain_ms": plain_ms,
            # each input read once, each output written once
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "library_ms": lib[0],
            "ms_source": src,
            "wall_ms": wall,
            "plain_wall_ms": plain_wall,
            "library_wall_ms": lib[1],
        }

    return [
        row("seg_argmax_scan", {"M": m},
            lambda: kernels.seg_argmax_scan(client, flags),
            lambda: kernels.seg_argmax_scan_plain(client, flags),
            None, 3 * 4 * m),
        row("stream_scatter", {"B": bsz, "n_out": n_out},
            lambda: kernels.stream_scatter(pos, n_out),
            lambda: kernels.stream_scatter_plain(pos, n_out),
            lambda: lib_out.index_put_((lib_idx,), lib_val),
            4 * (bsz + n_out)),
    ]


if __name__ == "__main__":
    sys.exit(main())
