#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the card.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and this checkout; imports nothing of
JAX or of the reference package. Phases, each fatal on failure:

  1. print the card's name and power limit (``nvidia-smi``);
  2. build every hand-written kernel from ``crdt_tpu_torch/csrc`` (one
     ``nvcc`` per source, all at once) and print the build time;
  3. hold each kernel against its plain PyTorch version on the card on
     edge cases, exact equality;
  4. replay the benchmark's traces (1000 replicas x 100 ops, the
     conflict trace, and the 16x scale trace of 1000 x 1600 ops) on the
     device route with ``device="cuda"`` and ``device="cpu"``: caches
     (``json.dumps`` with sorted keys) and snapshots must be identical;
  5. replay the same traces on the fleet route (one gossip + merge
     round over the blobs as replicas) on the card, and on the CPU for
     the two 1000 x 100 traces: each result must equal the CPU's and
     the card's device-route result; then one ``ReplicaFleet.
     delta_round`` on 1000 replicas, a budget below and one above the
     deficit, card against CPU field by field;
  6. replay the same traces on the streaming route (``stream_replay``:
     chunked decode, one converge per shard of whole root subtrees on
     two side streams, per-shard materialize) on the card, equal to the
     card's device route and, for the two 1000 x 100 traces, to the
     CPU's stream route; each of ``seg_argmax_scan`` and
     ``stream_scatter`` must launch once per shard (4 at 1000 x 1600).
     It prints the route's per-stage busy seconds, its
     ``overlap_efficiency`` and ``wall_vs_phases``, and the host syncs
     ``torch.cuda.set_sync_debug_mode("warn")`` reports in one more
     card run. Then the collaborative-text trace (200 writers x 100
     ops, 20% mid-inserts with right origins) on the device, stream
     and fleet routes: all three equal on the card and equal to the
     CPU;
  7. the live replica (``IncrementalReplay``, :func:`incremental_phase`):
     the 1000 x 1600 trace ingested in one device round, then the
     steady-state rounds of ``bench.py`` (map-only deltas of 1000, 16000
     and 64000 ops, each size forced to the host and to the device, and
     a 4000-op delta that appends to the doc's lists), each device round
     one ``stream_scatter`` launch at ``packed._rank_compact`` held
     against its plain version; the replica equals the cold device
     route on the union and its full-state encode replays to the same
     cache; the same procedure at 1000 x 100 equals the CPU byte for
     byte; ``route="auto"`` and ``route="replica"`` equal the device
     route;
  8. the document API and the replica swarm (:func:`replica_phase`):
     ``bench.py``'s product swarm through ``ypear_crdt`` at 12 x 25 in
     scalar and resident mode (resident on the card equal to the CPU
     byte for byte) and its mixed form at 16 x 200; then a resident
     replica restarts from a ``MemoryPersistence`` log of the 1000 x
     1600 trace, a late joiner ingests its full-state diff, both edit,
     the log is compacted and a third replica restarts from it: each of
     the three big rounds one device round with one ``stream_scatter``
     launch; A's and B's states equal the card's cold device route,
     and after the edits A's, B's and C's agree;
  9. time each kernel on the inputs each card run gave it (CUDA events
     around a CUDA-graph replay of the calls; a kernel wrapper that
     cannot be captured fails the run), against its bound, its plain
     version and (where one exists) one library call; then count how
     many of a known number of launches a profiler trace holds.

In phases 4 to 6 every kernel of the path must have launched in every
card run (counts are zeroed just before each run and read just after)
and none in a CPU run, each kernel must equal its plain version,
exactly, on the inputs the run gave it, and one more card replay of
each trace under the profiler gives the share of it in which the card
is busy (a lower bound where the trace loses activities).

The line before the last is the kernels JSON object, at the scale
run's device-route and fleet-route shapes, the live replica's ingest
shape (``"path": "incremental"``) and replica A's load shape
(``"path": "replica"``); the last line is
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
# INT32 instructions outside the tensor cores: 64 INT32 lanes per SM
# (NVIDIA H100 Tensor Core GPU architecture white paper) x 132 SMs x
# the 1.98 GHz boost clock (H100 SXM data sheet)
INT32_OPS_PER_S = 64 * 132 * 1.98e9

ROOT = Path(__file__).resolve().parent

# the TPU kernel each CUDA kernel replaces
REPLACES = {
    "seg_argmax_scan": "crdt_tpu/ops/pallas_kernels.py:441",
    "stream_scatter": "crdt_tpu/ops/pallas_kernels.py:544",
    "ds_mask": "crdt_tpu/ops/pallas_kernels.py:129",
    "sv_deficit": "crdt_tpu/ops/pallas_kernels.py:262",
}

# the kernels each replay route must launch on the card
ROUTE_KERNELS = {
    "device": ("seg_argmax_scan", "stream_scatter"),
    "stream": ("seg_argmax_scan", "stream_scatter"),
    "fleet": ("ds_mask", "sv_deficit"),
    # the live replica's device round: packed._rank_compact
    "incremental": ("stream_scatter",),
}

PHASES = {
    "device": ("decode", "pack", "converge.dispatch", "converge.fetch",
               "gather", "materialize", "compact"),
    "fleet": ("decode", "fleet.load", "fleet.step", "gather",
              "materialize", "compact"),
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


def traced_device(torch, run) -> tuple:
    """(microseconds, count) of the device activities (every kernel,
    memset and copy) the profiler traces while ``run()`` runs and the
    card drains. The trace may lose activities, so the time is a lower
    bound: kernel times come from :func:`graph_ms` instead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    spans = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    return sum(spans), len(spans)


def graph_ms(torch, fn, iters: int, batches: int = 5) -> float:
    """Median over ``batches`` of the mean device time of one call, by
    CUDA events around one replay of a CUDA graph that holds ``iters``
    calls: the host enqueues the graph once, so unlike :func:`cuda_ms`
    no host gap lies between the calls. Raises where ``fn`` cannot be
    captured (it waits on the host)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the capture stream, as capture asks
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    per = []
    for _ in range(batches):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        per.append(s.elapsed_time(e) / iters)
    return statistics.median(per)


def profiler_check(torch, fn, per_call: int, iters: int = 50,
                   sessions: int = 5) -> list:
    """(activities, device ms a call) of each of ``sessions`` profiler
    traces of ``iters`` calls of ``fn``, which launches ``per_call``
    kernels: a count below ``iters * per_call`` is a trace that lost
    activities, and its time reads low by as much."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(sessions):
        us, count = traced_device(
            torch, lambda: [fn() for _ in range(iters)])
        out.append((count, us / iters / 1e3))
    return out


def timed(torch, fn, iters: int, graph_required: bool = False) -> tuple:
    """(device ms, wall ms, source of the device ms) of one call. The
    wall time (CUDA events around back-to-back calls) includes the host's
    enqueue when that is slower than the card; where ``fn`` cannot be
    captured in a graph, the device time is the wall time, and says so,
    unless ``graph_required`` (a kernel wrapper: its launches must stay
    capturable), where that raises."""
    wall = cuda_ms(torch, fn, iters)
    try:
        return graph_ms(torch, fn, iters), wall, "cuda graph"
    except RuntimeError as e:
        torch.cuda.synchronize()
        if graph_required:
            raise AssertionError(
                f"a kernel wrapper broke CUDA-graph capture: {e}") from e
        log(f"no graph time ({str(e).splitlines()[0]}); using CUDA events")
        return wall, wall, "events"


@contextmanager
def capture_kernel_inputs(seen: dict, *sites):
    """Record (a device copy of) every input the main path hands the
    kernel wrappers named by ``sites`` — (module, wrapper name) pairs,
    the module being the caller that imported the wrapper — then call
    the real wrapper: the launch and its count are the main path's own."""
    originals = [(mod, name, getattr(mod, name)) for mod, name in sites]

    def recording(name, fn):
        def call(*args):
            seen.setdefault(name, []).append(tuple(
                a.clone() if hasattr(a, "clone") else a for a in args))
            return fn(*args)
        return call

    for mod, name, fn in originals:
        setattr(mod, name, recording(name, fn))
    try:
        yield
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)


def main() -> int:
    if not (ROOT / "crdt_tpu_torch" / "csrc").is_dir():
        return fail(f"crdt_tpu_torch/ not found beside {__file__}")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false")

    # seconds each phase took, for the run's time budget
    phase_s: dict = {}
    mark = [time.perf_counter()]

    def done(phase: str) -> None:
        now = time.perf_counter()
        phase_s[phase] = round(now - mark[0], 3)
        mark[0] = now

    # ---- 1. the card ---------------------------------------------------
    smi = smi_line()
    log(f"card: {smi}")
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    from crdt_tpu_torch.codec import native
    from crdt_tpu_torch.models import fleet, streaming
    from crdt_tpu_torch.models import replay as rp
    from crdt_tpu_torch.models import traces
    from crdt_tpu_torch.obs import (TickTimeline, Tracer, set_timeline,
                                    set_tracer)
    from crdt_tpu_torch.ops import _build, deleteset, kernels, statevec
    from crdt_tpu_torch.ops import packed as packed_mod
    from crdt_tpu_torch.parallel.delta import synth_resident_columns

    capture_sites = {
        "device": ((packed_mod, "seg_argmax_scan"),
                   (packed_mod, "stream_scatter")),
        # the stream route's launches come from its stager thread,
        # through the same module globals
        "stream": ((packed_mod, "seg_argmax_scan"),
                   (packed_mod, "stream_scatter")),
        "fleet": ((deleteset, "ds_mask"), (statevec, "sv_deficit")),
    }

    # every route decodes through the port's native codec; the Python
    # codec would give the same answers, slower, and hide a broken build
    if not native.available():
        return fail(f"native codec: {native._build_error}")
    log("native codec: built and loaded")

    done("1 card")

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
    max_err = {name: 0 for name in REPLACES}

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

    def hold_kernel(name: str, *args) -> None:
        hold(name, getattr(kernels, name)(*args),
             getattr(kernels, name + "_plain")(*args))

    done("2 build")

    # ---- 3. edge cases -------------------------------------------------
    g = torch.Generator(device="cpu").manual_seed(0)

    def ri(lo, hi, n, dtype=torch.int32):
        return torch.randint(lo, hi, (n,), generator=g,
                             dtype=dtype).to(dev)

    i32 = dict(dtype=torch.int32, device=dev)
    for n in (1, 2, 31, 2047, 2048, 2049, 70_001, 1_000_003):
        client = ri(0, 1 << 14, n)
        one_run = torch.zeros(n, **i32)
        one_run[0] = 1
        hold_kernel("seg_argmax_scan", client, one_run)   # all one run
        hold_kernel("seg_argmax_scan", client,
                    torch.ones(n, **i32))                 # own runs
        hold_kernel("seg_argmax_scan", torch.full((n,), 7, **i32),
                    one_run)                              # all ties
        flags = (ri(0, 50, n) == 0).to(torch.int32) * ri(1, 3, n)
        flags[0] = 1
        hold_kernel("seg_argmax_scan", ri(0, 4, n), flags)  # ties + runs
        pad = client.clone()
        pad_flags = flags.clone()
        tail = n // 3
        if tail:
            pad[n - tail:] = -1                           # padding tail
            pad_flags[n - tail:] = 1
        hold_kernel("seg_argmax_scan", pad, pad_flags)
        no_start = flags.clone()
        no_start[0] = 0                                   # no opening flag
        hold_kernel("seg_argmax_scan", client, no_start)
    hold_kernel("seg_argmax_scan", torch.zeros(0, **i32),
                torch.zeros(0, **i32))
    for n in (1, 5, 2048, 40_961, 1_000_003):
        perm = torch.randperm(n, generator=g).to(torch.int32).to(dev)
        hold_kernel("stream_scatter", perm, n)            # permutation
        drop = perm.clone()
        drop[::7] = -1                                    # negative
        drop[3::11] = n + 5                               # past the end
        hold_kernel("stream_scatter", drop, n)
        hold_kernel("stream_scatter", perm, n // 2)       # short output
    hold_kernel("stream_scatter", torch.zeros(0, **i32), 4)
    hold_kernel("stream_scatter", torch.arange(4, **i32), 0)
    scan_edge_cases(torch, dev, ri, hold_kernel,
                    _build.library("seg_argmax_scan").seg_argmax_scan_tile())
    scatter_edge_cases(torch, dev, g, ri, hold_kernel)
    ds_edge_cases(torch, dev, ri, hold_kernel)
    sv_edge_cases(torch, dev, g, hold_kernel)
    log(f"kernel edge cases: kernel == plain on the card, exact "
        f"(max |d| {max_err})")
    # the first profiling session of a process may trace no device
    # activity while CUPTI starts up: open and discard one
    traced_device(torch, lambda: torch.ones(1, device=dev))
    done("3 edge cases")

    plans = [
        ("trace_1000x100", lambda: traces.build_trace(1000, 100, seed=0)),
        ("conflict_1000x100",
         lambda: traces.build_conflict_trace(1000, 100)),
        ("scale_1000x1600", lambda: traces.build_trace(1000, 1600, seed=0)),
    ]
    launches = {name: 0 for name in REPLACES}
    card_inputs: dict = {label: {} for label, _ in plans}
    device_results: dict = {}

    def run_route(route: str, blobs, device: str, stream_phases=None):
        if route == "stream":
            # the entry point a user calls, with its phase accounting
            return streaming.stream_replay(blobs, device=device,
                                           phases=stream_phases)
        return rp.replay_trace(blobs, route=route, device=device)

    def replay_run(route: str, label: str, blobs, device: str,
                   key: str = None):
        """One replay on ``route``: counts zeroed just before, read
        just after; returns the result and records the run's kernel
        inputs (under ``key``, default ``label``), phase spans and
        transfer counters. A stream run logs its own per-stage busy
        seconds and its shard count (the timeline's dispatches), and on
        the card each of its kernels must launch once per shard."""
        tracer = set_tracer(Tracer(enabled=True))
        timeline = set_timeline(TickTimeline(enabled=True))
        seen: dict = {}
        stream_phases: dict = {}
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        with capture_kernel_inputs(seen, *capture_sites[route]):
            res = run_route(route, blobs, device, stream_phases)
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        set_tracer(Tracer(enabled=False))
        set_timeline(TickTimeline(enabled=False))
        rep = tracer.report()
        # the stream route reports its own per-stage busy seconds
        phases = stream_phases if route == "stream" else {
            p: round(rep["spans"][p]["total_s"], 6)
            for p in PHASES[route] if p in rep["spans"]}
        xfer = {k: v for k, v in rep["counters"].items()
                if k.startswith("xfer.d2h_bytes") or k.startswith(
                    "xfer.h2d_bytes") or k.startswith("xfer.h2d_puts")
                or k.startswith("xfer.d2h_fetches")}
        log(f"{label} [{route}, {device}]: {res.n_ops} ops in {wall:.3f} s; "
            f"phases (s) {json.dumps(phases)}; launches {counts}")
        log(f"{label} [{route}, {device}]: xfer {json.dumps(xfer)}")
        if route == "stream":
            (tick,) = timeline.records()
            shards = len(tick["dispatches"])
            log(f"{label} [stream, {device}]: {shards} shards; "
                f"overlap_efficiency {phases['overlap_efficiency']}, "
                f"wall_vs_phases {phases['wall_vs_phases']}")
            if device == "cuda":
                for name in ROUTE_KERNELS[route]:
                    if counts[name] != shards:
                        raise AssertionError(
                            f"{label} [stream]: {name} launched "
                            f"{counts[name]} times for {shards} shards")
        if device == "cuda":
            for name in ROUTE_KERNELS[route]:
                if counts[name] <= 0:
                    raise AssertionError(
                        f"{label} [{route}]: {name} never launched on "
                        "the card")
                launches[name] += counts[name]
            card_inputs.setdefault(key or label, {}).update(seen)
        elif any(counts.values()):
            raise AssertionError(
                f"{label} [{route}]: CPU run launched {counts}")
        return res

    def same(label: str, a, b, what: str) -> None:
        if json.dumps(a.cache, sort_keys=True) != json.dumps(
                b.cache, sort_keys=True):
            raise AssertionError(f"{label}: cache differs ({what})")
        if a.snapshot != b.snapshot:
            raise AssertionError(f"{label}: snapshot differs ({what})")
        if not a.cache or not a.snapshot or a.n_ops != b.n_ops:
            raise AssertionError(f"{label}: empty or short result ({what})")

    def busy_share(label: str, route: str, blobs) -> None:
        # one more card replay under the profiler: how much of it the
        # card is busy (the profiler slows the host a little)
        t0 = time.perf_counter()
        busy_us, _ = traced_device(
            torch, lambda: run_route(route, blobs, "cuda"))
        wall = time.perf_counter() - t0
        log(f"{label} [{route}]: device busy {busy_us / 1e3:.3f} ms of a "
            f"{wall * 1e3:.1f} ms profiled replay "
            f"(busy share {busy_us / 1e6 / wall:.5f})")

    def hold_run_inputs(label: str, route: str, key: str = None) -> None:
        # the kernels on exactly the inputs this run gave them
        for name in ROUTE_KERNELS[route]:
            for args in card_inputs[key or label][name]:
                hold_kernel(name, *args)
        log(f"{label} [{route}]: kernel == plain on the run's own inputs")

    # ---- 4. the device route -------------------------------------------
    blobs_of = {}
    for i, (label, build) in enumerate(plans):
        t0 = time.perf_counter()
        blobs = blobs_of[label] = build()
        log(f"{label}: {len(blobs)} blobs, {sum(map(len, blobs))} bytes, "
            f"built in {time.perf_counter() - t0:.3f} s")
        if i == 0:
            # warm-up: CUDA context, library loads, allocator pools
            rp.replay_trace(blobs, device="cuda")
            torch.cuda.synchronize()
        card = replay_run("device", label, blobs, "cuda")
        cpu = replay_run("device", label, blobs, "cpu")
        same(label, card, cpu, "device route, card vs CPU")
        log(f"{label} [device]: card == CPU (cache "
            f"{len(json.dumps(card.cache))} chars, snapshot "
            f"{len(card.snapshot)} bytes)")
        device_results[label] = card
        if i == 0:
            again = rp.replay_trace([card.snapshot], device="cuda")
            if again.cache != card.cache:
                raise AssertionError(f"{label}: snapshot replay differs")
            log(f"{label}: the compacted snapshot replays to the same cache")
        busy_share(label, "device", blobs)
        hold_run_inputs(label, "device")

    done("4 device route")

    # ---- 5. the fleet route and the delta round -------------------------
    for i, (label, _) in enumerate(plans):
        blobs = blobs_of[label]
        if i == 0:
            rp.replay_trace(blobs, route="fleet", device="cuda")  # warm-up
            torch.cuda.synchronize()
        card = replay_run("fleet", label, blobs, "cuda")
        if not label.startswith("scale"):
            cpu = replay_run("fleet", label, blobs, "cpu")
            same(label, card, cpu, "fleet route, card vs CPU")
        same(label, card, device_results[label],
             "fleet route vs device route, card")
        log(f"{label} [fleet]: card == "
            f"{'device route' if label.startswith('scale') else 'CPU == device route'}")
        busy_share(label, "fleet", blobs)
        hold_run_inputs(label, "fleet")
    delta_round_check(torch, fleet, kernels, synth_resident_columns)
    done("5 fleet route")

    # ---- 6. the stream route and the text trace --------------------------
    for i, (label, _) in enumerate(plans):
        blobs = blobs_of[label]
        if i == 0:
            streaming.stream_replay(blobs, device="cuda")  # warm-up
            torch.cuda.synchronize()
        key = f"{label} stream"
        card = replay_run("stream", label, blobs, "cuda", key=key)
        same(label, card, device_results[label],
             "stream route vs device route, card")
        if not label.startswith("scale"):
            cpu = replay_run("stream", label, blobs, "cpu")
            same(label, card, cpu, "stream route, card vs CPU")
        log(f"{label} [stream]: card == device route"
            f"{'' if label.startswith('scale') else ' == CPU stream route'}")
        busy_share(label, "stream", blobs)
        hold_run_inputs(label, "stream", key=key)
    sync_report(torch, streaming, blobs_of["scale_1000x1600"])

    label = "text_200x100"
    t0 = time.perf_counter()
    blobs = traces.build_text_trace(200, 100)
    log(f"{label}: {len(blobs)} blobs, {sum(map(len, blobs))} bytes, "
        f"built in {time.perf_counter() - t0:.3f} s")
    text_cpu = replay_run("device", label, blobs, "cpu")
    for route in ("device", "stream", "fleet"):
        key = f"{label} {route}"
        card = replay_run(route, label, blobs, "cuda", key=key)
        same(label, card, text_cpu, f"{route} route on the card vs CPU "
             "device route")
        if route == "fleet":
            same(label, replay_run("fleet", label, blobs, "cpu"),
                 text_cpu, "fleet route on the CPU vs CPU device route")
        busy_share(label, route, blobs)
        hold_run_inputs(label, route, key=key)
    log(f"{label}: device, stream and fleet routes on the card == CPU")
    done("6 stream route, text trace")

    # ---- 7. the live replica -------------------------------------------
    # the scatter's launches at this call site get a row of their own
    # in the kernels line, at this call site's shape
    inc_seen, inc_launches = incremental_phase(
        torch, rp, traces, kernels, packed_mod, blobs_of, device_results,
        same, hold_kernel)
    done("7 live replica")

    # ---- 8. the document API and the replica swarm ----------------------
    rep_seen, rep_launches = replica_phase(
        torch, kernels, packed_mod, blobs_of["scale_1000x1600"],
        json.dumps(device_results["scale_1000x1600"].cache, sort_keys=True),
        hold_kernel)
    done("8 replica")

    # ---- 9. timing at the main path's shapes ---------------------------
    for label, seen in card_inputs.items():
        if label.startswith("text"):
            continue  # held above; the text trace's shapes are small
        rows = kernel_rows(torch, kernels, seen, launches, max_err)
        log(f"kernel times ({label}): " + json.dumps(rows))
        if "ds_mask" in seen:
            log(f"ds_mask ({label}): device activities of 10 wrapper calls "
                + json.dumps(ds_mask_activities(torch, kernels,
                                                seen["ds_mask"][0])))
        if label == "scale_1000x1600":
            # the kernels line carries the scale run's device-route and
            # fleet-route shapes
            scale_rows = rows
        if label.endswith("stream"):
            shapes = {name: [[tuple(a.shape) if hasattr(a, "shape") else a
                              for a in args] for args in calls]
                      for name, calls in seen.items()}
            log(f"stream shard inputs ({label}): {json.dumps(shapes)}")
    # the scatter at the live replica's call site, at the ingest's shape
    inc_rows = kernel_rows(torch, kernels, {"stream_scatter": inc_seen},
                           {"stream_scatter": inc_launches}, max_err)
    for r in inc_rows:
        r["path"] = "incremental"
    log("kernel times (incremental ingest, packed._rank_compact): "
        + json.dumps(inc_rows))
    # ... and on the replica path, at replica A's load shape
    rep_rows = kernel_rows(torch, kernels, {"stream_scatter": rep_seen},
                           {"stream_scatter": rep_launches}, max_err)
    for r in rep_rows:
        r["path"] = "replica"
    log("kernel times (replica A's load, packed._rank_compact): "
        + json.dumps(rep_rows))
    # how far a profiler trace (the busy shares above) can be trusted
    client, flags = card_inputs["scale_1000x1600"]["seg_argmax_scan"][0]
    checks = profiler_check(
        torch, lambda: kernels.seg_argmax_scan(client, flags), 2)
    log("profiler check: 50 calls of seg_argmax_scan (2 launches each: "
        "clear_words and scan_tiles, 100 activities) traced (activities, "
        f"device ms a call) {json.dumps(checks)}")
    done("9 kernel times")
    log(f"seconds a phase: {json.dumps(phase_s)}; total "
        f"{sum(phase_s.values()):.1f} s")
    log(f"card: {smi}")
    print(json.dumps({"kernels": scale_rows + inc_rows + rep_rows}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def steady_rounds(traces, base_blobs, n_ops: int, n_replicas: int, sizes,
                  list_ops: int, device: str, sync_probe=None) -> dict:
    """The steady-state shape of ``bench.py``'s rounds leg through the
    port's live replica on ``device``: ingest ``base_blobs`` (``n_ops``
    ops from ``n_replicas`` writers) into ``IncrementalReplay`` under
    the auto rule, then for each delta size six map-only deltas (one
    warm round forced to the device, two forced to the host, one device
    round that flushes the host backlog, two timed device rounds), then
    one list-touching delta (``map_frac=0.6``) forced to the device.
    With ``sync_probe`` one more map-only delta runs forced to the
    device inside ``sync_probe(run)``. Fails when the ingest is not one
    device round. Returns the replica, the union of every blob it took,
    the rounds it ran on the device, the state vectors after the ingest
    and after each size, and the timings."""
    from crdt_tpu_torch.models.incremental import IncrementalReplay
    from crdt_tpu_torch.obs import get_tracer
    from crdt_tpu_torch.ops import packed as pk
    from crdt_tpu_torch.ops.device import bucket_pow2

    def h2d() -> int:
        return get_tracer().counters("xfer.h2d_bytes").get(
            "xfer.h2d_bytes", 0)

    def spans() -> dict:
        # the replica's own spans (incremental.decode, .admit, .dispatch,
        # .readback, .host_order, .cache), total seconds so far
        return {k: v["total_s"] for k, v in
                get_tracer().report()["spans"].items()
                if k.startswith("incremental.")}

    def timed_apply(inc, blobs) -> float:
        t0 = time.perf_counter()
        inc.apply(blobs)
        return time.perf_counter() - t0

    k_d = 50
    total = 6 * sum(sizes) + list_ops + (1000 if sync_probe else 0)
    cap = bucket_pow2(n_ops + 2 * total)
    d0 = pk.device_dispatch_count
    inc = IncrementalReplay(capacity=cap, device=device)
    ingest_s = timed_apply(inc, base_blobs)
    if pk.device_dispatch_count != d0 + 1:
        raise AssertionError(f"ingest on {device} was not one device round")
    svs = [inc.state_vector()]
    ingest_spans = spans()
    all_blobs = list(base_blobs)
    cbase = n_replicas + 1000
    table: dict = {}
    crossover = None

    def deltas(n, count, map_frac=1.0):
        # bench.py's deltas: fresh writers past every earlier client
        nonlocal cbase
        r_d = max(1, n // k_d)
        out = [traces.build_trace(r_d, k_d, seed=500 + cbase + i,
                                  client_base=cbase + i * r_d,
                                  map_frac=map_frac)
               for i in range(count)]
        cbase += count * r_d
        for d in out:
            all_blobs.extend(d)
        return out

    for d_ops in sizes:
        ds = deltas(d_ops, 6)
        inc.device_min_rows = 0
        inc.apply(ds[0])                          # warm
        inc.device_min_rows = 1 << 62             # forced to the host
        t_host = min(timed_apply(inc, d) for d in ds[1:3])
        inc.device_min_rows = 0
        inc.apply(ds[3])                          # flush the host backlog
        b0 = h2d()
        t_dev = min(timed_apply(inc, d) for d in ds[4:6])
        table[str(d_ops)] = {
            "host_round_s": t_host,
            "device_round_s": t_dev,
            "device_round_h2d_bytes": (h2d() - b0) // 2,
        }
        if crossover is None and t_dev < t_host:
            crossover = d_ops
        svs.append(inc.state_vector())
    (d,) = deltas(list_ops, 1, map_frac=0.6)
    inc.device_min_rows = 0
    b0 = h2d()
    table[f"{list_ops} list"] = {"device_round_s": timed_apply(inc, d),
                                 "device_round_h2d_bytes": h2d() - b0}
    device_rounds = 1 + 4 * len(sizes) + 1
    syncs = None
    if sync_probe is not None:
        (d,) = deltas(1000, 1)
        syncs = sync_probe(lambda: inc.apply(d))
        device_rounds += 1
    inc.device_min_rows = None  # back to the auto rule
    rounds_spans = {k: v - ingest_spans.get(k, 0.0)
                    for k, v in spans().items()}
    return dict(inc=inc, all_blobs=all_blobs, device_rounds=device_rounds,
                svs=svs, ingest_s=ingest_s, table=table, crossover=crossover,
                syncs=syncs, cap=cap, spans={"ingest": ingest_spans,
                                             "rounds": rounds_spans})


def incremental_phase(torch, rp, traces, kernels, packed_mod, blobs_of,
                      device_results, same, hold_kernel) -> tuple:
    """The live replica (``IncrementalReplay``) on the card.

    1. :func:`steady_rounds` at full width: the 1000 x 1600 scale trace
       ingested in one device round, map-only deltas of 1000, 16000 and
       64000 ops and a 4000-op list-touching delta, one more forced
       device round under the sync debug mode; then a second fresh
       ingest (warm). Counts are zeroed just before and read just
       after: ``stream_scatter`` must launch once per device round and
       no other kernel at all, ``count_device_dispatch`` must equal the
       rounds forced to the device, and ``device.dispatch_errors`` and
       ``device.fallback`` must be 0. The scatter must equal its plain
       version on every round's inputs.
    2. The replica's cache equals the card's cold device route on the
       union of every blob, and its full-state encode replays to the
       same cache.
    3. The same procedure on 1000 x 100 (delta sizes 250 and 1000, a
       1000-op list round) on the card and on the CPU: cache, state
       vector, full-state and diff encodes identical.
    4. ``route="auto"`` and ``route="replica"`` on 1000 x 100 on the
       card equal the device route.

    Returns the scatter's inputs of the first round (the ingest) and
    the scatter's launches."""
    from crdt_tpu_torch.core.ids import StateVector
    from crdt_tpu_torch.models.incremental import IncrementalReplay
    from crdt_tpu_torch.obs import Tracer, set_tracer

    label = "incremental_1000x1600"
    scale = blobs_of["scale_1000x1600"]
    tracer = set_tracer(Tracer(enabled=True))
    seen: dict = {}
    torch.cuda.synchronize()
    kernels.reset_launches()
    d0 = packed_mod.device_dispatch_count
    with capture_kernel_inputs(seen, (packed_mod, "stream_scatter")):
        run = steady_rounds(traces, scale, 1000 * 1600, 1000,
                            (1000, 16000, 64000), 4000, "cuda",
                            sync_probe=lambda f: sync_warnings(torch, f))
        warm = IncrementalReplay(capacity=run["cap"], device="cuda")
        t0 = time.perf_counter()
        warm.apply(scale)
        ingest_warm_s = time.perf_counter() - t0
        del warm
    device_rounds = run["device_rounds"] + 1
    counts = kernels.launch_counts()
    dispatches = packed_mod.device_dispatch_count - d0
    set_tracer(Tracer(enabled=False))
    guard = {k: v for k, v in tracer.report()["counters"].items()
             if k.startswith("device.")}
    inc = run["inc"]
    log(f"{label}: capacity {run['cap']}; ingest_s cold "
        f"{run['ingest_s']:.3f}, warm {ingest_warm_s:.3f}; rounds "
        f"{json.dumps(run['table'])}; crossover {run['crossover']}")
    log(f"{label}: spans (s) of the ingest and of the rounds after it "
        f"{json.dumps(run['spans'])}")
    log(f"{label}: {dispatches} device rounds ({device_rounds} forced); "
        f"launches {counts}; guard counters {json.dumps(guard)}")
    log(f"{label}: calibration_info on the card "
        f"{json.dumps(IncrementalReplay.calibration_info('cuda'))}")
    log(f"{label}: host syncs of one forced 1000-op device round (sync "
        f"debug mode), by thread and line: {json.dumps(run['syncs'])}")
    want = {name: 0 for name in counts}
    want.update(dict.fromkeys(ROUTE_KERNELS["incremental"], device_rounds))
    if dispatches != device_rounds or counts != want:
        raise AssertionError(
            f"{label}: {dispatches} device rounds and launches {counts} "
            f"for {device_rounds} rounds forced to the device")
    if len(seen.get("stream_scatter", ())) != device_rounds:
        raise AssertionError(f"{label}: scatter inputs not captured per round")
    if guard.get("device.dispatch_errors", 0) or guard.get(
            "device.fallback", 0):
        raise AssertionError(f"{label}: the failure ladder ran: {guard}")
    for args in seen["stream_scatter"]:
        hold_kernel("stream_scatter", *args)
    shapes = [[int(a.shape[0]), n] for a, n in seen["stream_scatter"]]
    log(f"{label}: stream_scatter == plain on every round's inputs; "
        f"(B, n_out) a round {json.dumps(shapes)}")

    # ---- 2. against the cold replay of the union
    t0 = time.perf_counter()
    cache = json.dumps(inc.cache, sort_keys=True)
    cache_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cold = rp.replay_trace(run["all_blobs"], device="cuda")
    cold_s = time.perf_counter() - t0
    if cache != json.dumps(cold.cache, sort_keys=True):
        raise AssertionError(f"{label}: cache != cold device route")
    t0 = time.perf_counter()
    snap = inc.encode_state_as_update()
    encode_s = time.perf_counter() - t0
    again = rp.replay_trace([snap], device="cuda")
    if json.dumps(again.cache, sort_keys=True) != cache:
        raise AssertionError(f"{label}: full-state encode replays differently")
    best = min(min(r["device_round_s"], r.get("host_round_s", float("inf")))
               for r in run["table"].values())
    log(f"{label}: cache == cold device route on the union "
        f"({cold.n_ops} ops; cold replay {cold_s:.3f} s against the best "
        f"round {best:.4f} s); cache read {cache_s:.3f} s; the full-state "
        f"encode ({len(snap)} bytes, {encode_s:.3f} s) replays to the same "
        "cache")

    # ---- 3. the same procedure at 1000 x 100, card against CPU
    small = blobs_of["trace_1000x100"]
    outs = {}
    for device in ("cuda", "cpu"):
        set_tracer(Tracer(enabled=True))  # counts the rounds' h2d bytes
        r = steady_rounds(traces, small, 1000 * 100, 1000, (250, 1000),
                          1000, device)
        set_tracer(Tracer(enabled=False))
        outs[device] = r
        log(f"trace_1000x100 [incremental, {device}]: ingest_s "
            f"{r['ingest_s']:.3f}; rounds {json.dumps(r['table'])}")
    a, b = outs["cuda"]["inc"], outs["cpu"]["inc"]
    mid = StateVector(dict(outs["cpu"]["svs"][1].clocks))
    checks = {
        "cache": (json.dumps(a.cache, sort_keys=True),
                  json.dumps(b.cache, sort_keys=True)),
        "state_vector": (a.state_vector().clocks, b.state_vector().clocks),
        "full_encode": (a.encode_state_as_update(),
                        b.encode_state_as_update()),
        "diff_encode": (a.encode_state_as_update(mid),
                        b.encode_state_as_update(mid)),
    }
    for name, (x, y) in checks.items():
        if x != y:
            raise AssertionError(f"trace_1000x100 [incremental]: {name} "
                                 "differs, card vs CPU")
    log("trace_1000x100 [incremental]: card == CPU (cache, state vector, "
        "full-state and diff encodes)")

    # ---- 4. the auto and replica routes
    for route in ("auto", "replica"):
        res = rp.replay_trace(small, route=route, device="cuda")
        same("trace_1000x100", res, device_results["trace_1000x100"],
             f"{route} route vs device route, card")
        log(f"trace_1000x100 [{route}]: path {res.path}; == device route")
    return seen["stream_scatter"][:1], counts["stream_scatter"]


def swarm_round(mode: str, n_reps: int, n_ops: int, mixed: bool = False,
                device=None) -> tuple:
    """``bench.py``'s product swarm (``swarm_round``, bench.py:4670-4707)
    through the port's ``ypear_crdt`` over the loopback router: fixed
    client ids, batched receive, the plain op mix (map sets and list
    pushes) or the mixed one (maps, list appends, mid-inserts at a live
    index, nested array-in-map, delivery interleaved every 8 replicas).
    Fails unless every replica's ``c`` is equal. Returns the replicas
    and the wall seconds of the ops and their delivery."""
    from crdt_tpu_torch.net import LoopbackNetwork, LoopbackRouter, ypear_crdt

    net = LoopbackNetwork()
    kw = {"device": device} if mode == "resident" else {}
    reps = [ypear_crdt(LoopbackRouter(net, f"pk{i}"), topic="b",
                       client_id=i + 1, merge_mode=mode,
                       batch_incoming=True, **kw)
            for i in range(n_reps)]
    net.run()
    t0 = time.perf_counter()
    for i, r in enumerate(reps):
        if mixed:
            mixed_ops(r, i, n_ops)
            if i % 8 == 7:
                net.run()  # interleaved delivery mid-stream
            continue
        for j in range(n_ops):
            if j % 2:
                r.set("m", f"k{i}-{j}", j)
            else:
                r.push("l", f"v{i}-{j}")
    net.run()
    dt = time.perf_counter() - t0
    first = dict(reps[0].c)
    if any(dict(r.c) != first for r in reps[1:]):
        raise AssertionError(f"swarm [{mode}, {device}]: replicas diverged")
    return reps, dt


def mixed_ops(r, i: int, n_ops: int, start: int = 0) -> None:
    """``bench.py``'s mixed op mix for replica ``i``, ops ``start`` to
    ``start + n_ops``, on the roots ``m``, ``l`` and ``nest``."""
    for j in range(start, start + n_ops):
        k = j % 5
        if k == 0:
            r.set("m", f"k{i % 16}-{j % 32}", [i, j])
        elif k == 1:
            r.push("l", f"v{i}-{j}")
        elif k == 2:  # nested array-in-map
            r.set("nest", f"arr{i % 8}", value=f"n{i}-{j}",
                  array_method="push")
        elif k == 3:  # mid-insert at a live index
            cur = r.get("l") or []
            r.insert("l", (i * 7 + j) % (len(cur) + 1), f"ins{i}-{j}")
        else:
            r.set("m", f"solo{i}", j)


# phase 8's product swarms, (replicas, ops a replica): the plain op mix
# and the mixed one
SWARMS = ((12, 25), (16, 200))
# the late joiner's ready-probe retry interval in phase 8, seconds
LATE_JOIN_PROBE_RETRY_S = 120.0


def replica_phase(torch, kernels, packed_mod, scale_blobs, want_cache: str,
                  hold_kernel) -> tuple:
    """The document API and the replica swarm: the port's user entry
    (``ypear_crdt`` -> ``Replica`` -> ``Crdt`` / ``ResidentCrdt``).

    1. The product swarm (:func:`swarm_round`) at 12 x 25 in
       ``"scalar"`` mode, in ``"resident"`` mode on the card and on
       the CPU, and the mixed form at 16 x 200 in both modes: every
       replica's ``c`` equal within and across modes, and at 12 x 25
       each resident replica on the card encodes the same full state
       and state vector as on the CPU, byte for byte.
    2. Replica A (resident, on the card) restarts from a
       ``MemoryPersistence`` log of ``scale_blobs`` (one update a
       writer): its load is one ``apply``, one device round; its ``c``
       equals ``want_cache`` (the cold device route on the same blobs).
    3. Replica B (resident, on the card, no log) joins late: A's
       ready-probe answer is its full-state diff, which B ingests in
       one device round; B's ``c`` and state vector equal A's.
    4. A and B each run the mixed op mix for 200 ops (roots ``m``,
       ``l``, ``nest``), delivery interleaved, then one forced
       ``anti_entropy()``: equal ``c``.
    5. ``A.compact()`` leaves one snapshot in the store, squashed from
       the resident columns; A closes and replica C restarts from the
       store in one device round: C's ``c`` equals A's and B's.

    Counts are zeroed before A's load and read after C's restart: on
    the card ``stream_scatter`` launches once a big round (A, B, C) and
    nowhere else, no other kernel launches, and every ``device.*``
    ladder counter is 0; every scatter input equals the plain version.
    Returns the scatter's inputs of A's load and its launch count."""
    from crdt_tpu_torch.net import (LoopbackNetwork, LoopbackRouter,
                                    MemoryPersistence, ypear_crdt)
    from crdt_tpu_torch.obs import Tracer, set_tracer

    label = "replica [cuda]"
    sync = torch.cuda.synchronize

    # ---- 1. the product swarm
    (n_small, k_small), (n_mixed, k_mixed) = SWARMS
    walls: dict = {}
    states: dict = {}
    small: dict = {}
    for mode, dev in (("scalar", None), ("resident", "cuda"),
                      ("resident", "cpu")):
        reps, walls[f"{n_small}x{k_small} {mode} {dev}"] = swarm_round(
            mode, n_small, k_small, device=dev)
        states[(n_small, mode, dev)] = dict(reps[0].c)
        small[(mode, dev)] = reps
    for mode, dev in (("scalar", None), ("resident", "cuda")):
        reps, walls[f"{n_mixed}x{k_mixed} mixed {mode} {dev}"] = \
            swarm_round(mode, n_mixed, k_mixed, mixed=True, device=dev)
        states[(n_mixed, mode, dev)] = dict(reps[0].c)
    for n in (n_small, n_mixed):
        got = [s for key, s in states.items() if key[0] == n]
        if any(s != got[0] for s in got[1:]):
            raise AssertionError(f"swarm {n} replicas: modes disagree")
    for card, cpu in zip(small[("resident", "cuda")],
                         small[("resident", "cpu")]):
        if card.encode_state_as_update() != cpu.encode_state_as_update() \
                or card.encode_state_vector() != cpu.encode_state_vector():
            raise AssertionError(
                f"swarm {n_small}x{k_small} resident: card != CPU")
    log(f"{label}: product swarm, wall s {json.dumps(walls)}; c equal "
        f"within and across modes; {n_small}x{k_small} resident on "
        "the card == CPU byte for byte (full state, state vector)")
    del small

    # ---- 2-5. the resident replica at full size
    tracer = set_tracer(Tracer(enabled=True))
    seen: dict = {}
    secs: dict = {}
    rounds: dict = {}

    def spans() -> dict:
        return {k: v["total_s"] for k, v in
                tracer.report()["spans"].items()
                if k.startswith("incremental.")}

    @contextmanager
    def step(name: str, big: bool = False):
        sync()
        s0, d0 = spans(), packed_mod.device_dispatch_count
        n0 = kernels.launch_counts()["stream_scatter"]
        t0 = time.perf_counter()
        yield
        sync()
        secs[name] = time.perf_counter() - t0
        if big:
            rounds[name] = {
                "device_rounds": packed_mod.device_dispatch_count - d0,
                "stream_scatter": kernels.launch_counts()["stream_scatter"]
                - n0,
                "spans": {k: round(v - s0.get(k, 0.0), 6)
                          for k, v in spans().items()},
            }
            if rounds[name]["device_rounds"] != 1:
                raise AssertionError(
                    f"{label}: {name} took {rounds[name]['device_rounds']}"
                    " device rounds, not one")

    net = LoopbackNetwork()
    store = MemoryPersistence()
    store.store_updates("doc", scale_blobs)

    def replica(pk, persistence=None, **options):
        return ypear_crdt(LoopbackRouter(net, pk), topic="doc",
                          merge_mode="resident", persistence=persistence,
                          device="cuda", **options)

    sync()
    kernels.reset_launches()
    with capture_kernel_inputs(seen, (packed_mod, "stream_scatter")):
        with step("A load", big=True):
            a = replica("A", store)
        t0 = time.perf_counter()
        a_cache = json.dumps(dict(a.c), sort_keys=True)
        secs["A first cache read"] = time.perf_counter() - t0
        if a_cache != want_cache:
            raise AssertionError(f"{label}: A's c != the cold device route")

        # B joins: A answers B's ready probe with its full-state diff
        answers: list = []
        a_encode = a.doc.encode_state_as_update

        def timed_encode(sv=None):
            t = time.perf_counter()
            out = a_encode(sv)
            answers.append((time.perf_counter() - t, len(out)))
            return out

        a.doc.encode_state_as_update = timed_encode
        with step("B join", big=True):
            # A's answer takes tens of seconds at full size: B's probe
            # retry waits past it (the default 0.5 s re-probes while A
            # encodes, and A encodes the whole diff twice)
            b = replica("B", probe_retry_s=LATE_JOIN_PROBE_RETRY_S)
            net.run()
        del a.doc.encode_state_as_update
        if not b.synced or b.state_vector() != a.state_vector():
            raise AssertionError(f"{label}: B's state vector != A's")
        t0 = time.perf_counter()
        b_cache = json.dumps(dict(b.c), sort_keys=True)
        secs["B first cache read"] = time.perf_counter() - t0
        if b_cache != a_cache:
            raise AssertionError(f"{label}: B's c != A's")

        # live editing on both, then one forced anti-entropy round
        with step("edits"):
            for n in range(4):
                mixed_ops(a, 0, 50, start=50 * n)
                mixed_ops(b, 1, 50, start=50 * n)
                net.run()
            sent = a.anti_entropy()
            net.run()
        if dict(a.c) != dict(b.c):
            raise AssertionError(f"{label}: A and B diverged after edits")

        # compaction, then C restarts from the compacted log
        with step("compact"):
            a.compact()
        if store.get_meta("doc")["count"] != 1:
            raise AssertionError(f"{label}: compaction left "
                                 f"{store.get_meta('doc')['count']} blobs")
        snap_bytes = store.get_meta("doc")["size"]
        a.self_close()
        net.run()
        with step("C restart", big=True):
            c = replica("C", store)
        net.run()
    counts = kernels.launch_counts()
    set_tracer(Tracer(enabled=False))
    guard = {k: v for k, v in tracer.report()["counters"].items()
             if k.startswith("device.")}
    c_cache = json.dumps(dict(c.c), sort_keys=True)
    if c_cache != json.dumps(dict(a.c), sort_keys=True) or \
            c_cache != json.dumps(dict(b.c), sort_keys=True):
        raise AssertionError(f"{label}: C's c != A's and B's")
    big = [r["stream_scatter"] for r in rounds.values()]
    want = {name: 0 for name in counts}
    want["stream_scatter"] = 3
    if counts != want or big != [1, 1, 1]:
        raise AssertionError(f"{label}: launches {counts}, "
                             f"a big round {big}")
    if any(guard.values()):
        raise AssertionError(f"{label}: the failure ladder ran: {guard}")
    calls = seen.get("stream_scatter", [])
    for args in calls:
        hold_kernel("stream_scatter", *args)
    log(f"{label}: A restarted from a log of {len(scale_blobs)} updates "
        f"({sum(map(len, scale_blobs))} bytes), B joined late, both "
        f"edited, C restarted from the compacted log ({snap_bytes} "
        "bytes): A's and B's c equal the cold device route, and after "
        "the edits A's, B's and C's agree")
    log(f"{label}: seconds {json.dumps(secs)}; probe answers to B "
        f"(s, bytes; B's probe retry {LATE_JOIN_PROBE_RETRY_S} s) "
        f"{json.dumps(answers)}; anti-entropy sent {json.dumps(sent)}")
    log(f"{label}: big rounds {json.dumps(rounds)}")
    log(f"{label}: launches {counts}; guard counters {json.dumps(guard)}; "
        f"stream_scatter == plain on all {len(calls)} inputs, (B, n_out) "
        f"{json.dumps([[int(p.shape[0]), n] for p, n in calls])}")
    return calls[:1], counts["stream_scatter"]


def sync_warnings(torch, run) -> dict:
    """Run ``run()`` on the card under
    ``torch.cuda.set_sync_debug_mode("warn")``: every host sync it
    reports, counted by the thread and the line that made it."""
    import threading
    import warnings

    found: dict = {}

    def show(message, category, filename, lineno, file=None, line=None):
        where = (f"{threading.current_thread().name}: "
                 f"{Path(filename).parent.name}/{Path(filename).name}:"
                 f"{lineno}: {str(message).splitlines()[0][:60]}")
        found[where] = found.get(where, 0) + 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return found


def sync_report(torch, streaming, blobs) -> None:
    """One more card stream replay under the sync debug mode (the
    stager thread's converge should make no host sync)."""
    found = sync_warnings(
        torch, lambda: streaming.stream_replay(blobs, device="cuda"))
    stager = sum(n for k, n in found.items()
                 if k.startswith("stream-stager"))
    log("host syncs of one 1000x1600 stream replay (sync debug mode), "
        f"by thread and line: {json.dumps(found)}; {stager} from the "
        "stager thread")


def scan_edge_cases(torch, dev, ri, hold_kernel, tile: int) -> None:
    """``seg_argmax_scan`` on the card against its plain version around
    its tile of ``tile`` elements: one tile less one, one, one more, and
    several tiles and one (33 and 65 tiles: a look-back past one window
    of 32); one run across every tile with its only run starts in the
    last tile; a run start on the first element of every tile; the
    maximum in tile 0 and ties across tile borders (the earliest
    position wins); all padding; and views at an odd offset."""
    i32 = dict(dtype=torch.int32, device=dev)
    for n in (tile - 1, tile, tile + 1, 2 * tile + 1, 33 * tile + 1,
              65 * tile + 1):
        client = ri(0, 1 << 14, n)
        last = torch.zeros(n, **i32)                      # starts: last tile
        t0 = (n - 1) // tile * tile                       # only
        last[t0:] = (ri(0, 9, n - t0) == 0).int()
        last[-1] = 1
        hold_kernel("seg_argmax_scan", client, last)
        hold_kernel("seg_argmax_scan", ri(0, 3, n), last)  # ties, one run
        heads = torch.zeros(n, **i32)
        heads[::tile] = 1                                 # a start per tile
        hold_kernel("seg_argmax_scan", client, heads)
        heads[1::tile] = 1                                # ... and after it
        hold_kernel("seg_argmax_scan", ri(0, 2, n), heads)
        one_run = torch.zeros(n, **i32)
        top = ri(0, 3, n)
        top[1] = 9                                        # max in tile 0
        hold_kernel("seg_argmax_scan", top, one_run)
        ties = ri(0, 3, n)
        ties[tile - 1::tile] = 7                          # ties across borders
        ties[tile::tile] = 7
        hold_kernel("seg_argmax_scan", ties, one_run)
        hold_kernel("seg_argmax_scan", ties, heads)
        hold_kernel("seg_argmax_scan", torch.full((n,), -1, **i32),
                    torch.ones(n, **i32))                 # all padding
        wide = ri(-(1 << 31), (1 << 31) - 1, n + 1)       # odd-offset views
        wide_flags = (ri(0, 40, n + 1) == 0).int()
        hold_kernel("seg_argmax_scan", wide[1:], wide_flags[1:])
        hold_kernel("seg_argmax_scan", wide[1:], one_run)
        hold_kernel("seg_argmax_scan", client, wide_flags[1:])


def scatter_edge_cases(torch, dev, g, ri, hold_kernel) -> None:
    """``stream_scatter`` on the card against its plain version: n_in
    not a multiple of 4, n_out above and below n_in, views of ``pos``
    at an odd offset, and every target dropped."""
    for n in (4097, 4098, 4099, 655_361, 655_363):
        perm = torch.randperm(n + 1, generator=g).to(torch.int32).to(dev)
        for n_out in (n, n - 5, n + 1, 2 * n + 3, n // 3):
            hold_kernel("stream_scatter", perm[:n], n_out)
            hold_kernel("stream_scatter", perm[1:], n_out)  # odd offset
            hold_kernel("stream_scatter", perm[3:], n_out)
        hold_kernel("stream_scatter", torch.full_like(perm[1:], -1), n)
        hold_kernel("stream_scatter", perm[1:] + (n + 1), n + 1)
        hold_kernel("stream_scatter", ri(-(1 << 31), 0, n), n)
    hold_kernel("stream_scatter", torch.arange(7, dtype=torch.int32,
                                               device=dev)[1:], 3)


def ds_edge_cases(torch, dev, ri, hold_kernel) -> None:
    """``ds_mask`` on the card against its plain version: no ranges,
    all-null ranges, D around the reference's old crossover (64) and up
    to the 1000x1600 run's 131,072, shuffled (sorted on the card) and in
    search order (not sorted), overlapping and nested ranges, clocks
    past 2**31 and near 2**40, invalid rows, N not a multiple of a
    block."""
    i64 = dict(dtype=torch.int64, device=dev)

    def items(n, base, span, clients):
        client = ri(-1, clients, n)
        clock = base + ri(0, span, n, torch.int64)
        valid = ri(0, 5, n) > 0
        return client, clock, valid

    def disjoint(d, base, step, clients, shuffle=True):
        # client k % clients, its (k // clients)-th range in its own
        # step window: disjoint; shuffled, or in search order (by
        # client, then start) as the fleet's normalized delete set
        k = torch.arange(d, **i64)
        rc = (k % clients).to(torch.int32)
        rs = base + (k // clients) * step + ri(0, step // 2, d, torch.int64)
        re = rs + ri(1, step // 2, d, torch.int64)
        order = (torch.randperm(d, device=dev) if shuffle
                 else torch.argsort((k % clients) * d + k // clients))
        return rc[order], rs[order], re[order]

    def with_nulls(ranges, nulls):
        fill = torch.full((nulls,), -1, **i64)
        rc, rs, re = ranges
        return (torch.cat([rc, fill.to(torch.int32)]), torch.cat([rs, fill]),
                torch.cat([re, fill]))

    empty = torch.zeros(0, **i64)
    for n in (1, 255, 257, 1_000_003):
        it = items(n, 0, 4096, 50)
        hold_kernel("ds_mask", *it, empty.to(torch.int32), empty, empty)
        null = torch.full((512,), -1, **i64)
        hold_kernel("ds_mask", *it, null.to(torch.int32), null, null)
    for d, n, base in ((1, 1000, 0), (64, 65_537, 0),
                       (65, 65_537, (1 << 31) - 5000),
                       (2049, 257_000, 1 << 31),
                       (8533, 1_000_003, (1 << 40) - (1 << 30)),
                       (8534, 1_000_003, 0),
                       (131_072, 2_048_000, (1 << 40) - (1 << 30))):
        clients, step = 97, 64
        span = (d // clients + 1) * step
        it = items(n, base, span, clients)
        hold_kernel("ds_mask", *it,
                    *with_nulls(disjoint(d, base, step, clients), 13))
        # overlapping: random starts, lengths up to a few strides
        rc = ri(0, clients, d)
        rs = base + ri(0, span, d, torch.int64)
        re = rs + ri(0, 4 * step, d, torch.int64)
        hold_kernel("ds_mask", *it, rc, rs, re)
    # the fleet's layout: in search order, disjoint, 13 trailing null
    # fillers, D in all (8,533 and 8,534 around the 200 KB bound of an
    # earlier shared-memory staging, and the 1000x1600 run's 131,072):
    # nothing is sorted, one or many scan tiles
    for d, n, base in ((8533, 1_000_003, 0), (8534, 1_000_003, 1 << 33),
                       (131_072, 2_048_000, (1 << 40) - (1 << 30))):
        clients, step = 97, 64
        it = items(n, base, ((d - 13) // clients + 1) * step, clients)
        hold_kernel("ds_mask", *it, *with_nulls(
            disjoint(d - 13, base, step, clients, shuffle=False), 13))
    # id-sorted items, N = 1 mod 1,024 (a last search block of one
    # item) whose last item lies just below a range of its own client,
    # right after a search of large keys
    big = items(1 << 20, 1 << 40, 1 << 20, 97)
    hold_kernel("ds_mask", *big, *disjoint(4096, 1 << 40, 512, 97))
    rc, rs, re = disjoint(4096, 0, 64, 97, shuffle=False)
    client = rc[torch.arange(4097, device=dev) * 4096 // 4097]
    clock = rs[torch.arange(4097, device=dev) * 4096 // 4097]
    clock[-1] = rs[-1] - 1
    client[-1] = rc[-1]
    valid = torch.ones(4097, dtype=torch.bool, device=dev)
    hold_kernel("ds_mask", client, clock, valid, rc, rs, re)
    # nested: one long range holding shorter later ones
    client = torch.ones(5, **i64).to(torch.int32)
    clock = torch.tensor([2, 6, 8, 10, 11], **i64)
    valid = torch.ones(5, dtype=torch.bool, device=dev)
    hold_kernel("ds_mask", client, clock, valid,
                torch.tensor([1, 1, 1], **i64).to(torch.int32),
                torch.tensor([0, 5, 9], **i64),
                torch.tensor([11, 7, 10], **i64))


def sv_edge_cases(torch, dev, g, hold_kernel) -> None:
    """``sv_deficit`` on the card against its plain version: ragged R
    and C around the 64-row tile, zero and identical rows, absolute
    clocks past 2**40, and summed column spreads past 2**31 (where the
    reference took its exact fallback)."""

    def svs(r, c, base, spread):
        return (base + torch.randint(0, spread, (r, c), generator=g,
                                     dtype=torch.int64)).to(dev)

    for r in (1, 7, 64, 65, 1000, 1030):
        for c in (1, 3, 128, 1002):
            hold_kernel("sv_deficit", svs(r, c, 1 << 40, 10_000))
    hold_kernel("sv_deficit", torch.zeros((1000, 1002), dtype=torch.int64,
                                          device=dev))
    same_rows = svs(1, 1002, 7, 500).repeat(1000, 1)
    same_rows[500:] += 3
    hold_kernel("sv_deficit", same_rows)
    lag = svs(1000, 1002, 0, 1000)
    lag[0] += 1 << 33
    lag[:, 5] += torch.arange(1000, device=dev) << 22
    hold_kernel("sv_deficit", lag)
    # one staged chunk (clients 32..63) outside the kernel's 2**24
    # envelope, in the tile pairs that hold row 500 only
    one = svs(1000, 1002, 1 << 40, 1000)
    one[500, 40] += 1 << 25
    hold_kernel("sv_deficit", one)
    # staged values at the envelope's edges, relative to each tile
    # pair's first row (a multiple of 32): -2**24 and 2**24 - 1 stay
    # int32, -2**24 - 1 and 2**24 do not
    edge = svs(96, 300, 7, 3)
    for row, col, dv in ((5, 3, (1 << 24) - 1), (37, 40, 1 << 24),
                         (10, 50, -(1 << 24)), (70, 260, -(1 << 24) - 1)):
        edge[row, col] = edge[(row // 32) * 32, col] + dv
    hold_kernel("sv_deficit", edge)
    # every staged value at the envelope: int32 sums of 128 terms reach
    # -2**31 and 2**31 - 128 between flushes
    top = torch.zeros((96, 1002), dtype=torch.int64, device=dev)
    top[1::2] = (1 << 24) - 1
    hold_kernel("sv_deficit", top)
    low = torch.zeros((96, 1002), dtype=torch.int64, device=dev)
    low[::32] = 1 << 24
    hold_kernel("sv_deficit", low)


# what a ds_mask wrapper call may launch: csrc/ds_mask.cu's kernels; no
# torch sort, scan or gather
DS_MASK_ACTIVITIES = ("clear_words", "run_max_scan", "order_tile",
                      "merge_runs", "ds_search")


def ds_mask_activities(torch, kernels, args) -> dict:
    """{activity: count} over a profiler trace of 10 ``ds_mask`` calls
    on one run's inputs (the trace may lose some); raises on any device
    activity that is not ``ds_mask.cu``'s own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    kernels.ds_mask(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            kernels.ds_mask(*args)
        torch.cuda.synchronize()
    counts: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = next((k for k in DS_MASK_ACTIVITIES if k in e.name),
                        e.name)
            counts[name] = counts.get(name, 0) + 1
    foreign = sorted(k for k in counts if k not in DS_MASK_ACTIVITIES)
    if foreign:
        raise AssertionError(f"ds_mask launched foreign work: {foreign}")
    return counts


def delta_round_check(torch, fleet, kernels, synth_resident_columns) -> None:
    """One targeted anti-entropy round on 1000 replicas (1002 clients,
    8 fresh rows each over a 96-row shared history), budgets 4 (below
    the deficit) and 16 (above): the card's outputs equal the CPU's
    field by field."""
    cols = synth_resident_columns(1000, 96, 8, seed=0)
    for budget in (4, 16):
        kernels.reset_launches()
        t0 = time.perf_counter()
        card = fleet.ReplicaFleet(1000, 104, device="cuda").delta_round(
            cols, budget=budget)
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        if counts["sv_deficit"] <= 0:
            raise AssertionError("delta round: sv_deficit never launched")
        cpu = fleet.ReplicaFleet(1000, 104, device="cpu").delta_round(
            cols, budget=budget)
        for name, a, b in zip(("svs", "deficit", "needed"), card[:3],
                              cpu[:3]):
            if a.shape != b.shape or not (a == b).all():
                raise AssertionError(f"delta round: {name} differs")
        for name, a in card[3].items():
            b = cpu[3][name]
            if a.dtype != b.dtype or not (a == b).all():
                raise AssertionError(f"delta round: delta {name} differs")
        if not (card[2] == 8).all() or int(card[3]["valid"].sum()) != \
                1000 * min(budget, 8):
            raise AssertionError("delta round: wrong deficit")
        log(f"delta round (1000 replicas, budget {budget}): card == CPU "
            f"field by field; {wall:.3f} s on the card; launches {counts}")


def kernel_rows(torch, kernels, seen: dict, launches: dict,
                max_err: dict) -> list:
    """One timed row per kernel on the inputs one card run gave it
    (the first call of each kernel in that run)."""
    from crdt_tpu_torch.ops.device import pack_id

    i32 = dict(dtype=torch.int32, device=torch.device("cuda"))

    def nbytes(*ts) -> int:
        return sum(t.numel() * t.element_size() for t in ts)

    def row(name, shape, args, library, nbytes_, ops=0):
        kernel = getattr(kernels, name)
        plain = getattr(kernels, name + "_plain")
        ms, wall, src = timed(torch, lambda: kernel(*args), 50,
                              graph_required=True)
        plain_ms, plain_wall, _ = timed(torch, lambda: plain(*args), 5)
        lib = timed(torch, library, 20) if library else (None, None, None)
        byte_ms = nbytes_ / HBM_BYTES_PER_S * 1e3
        op_ms = ops / INT32_OPS_PER_S * 1e3
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
            # each input read once, each output written once; the
            # operations at the non-tensor INT32 peak where counted
            "bound_ms": max(byte_ms, op_ms),
            "bound_by": "operations" if op_ms > byte_ms else "bytes",
            "library_ms": lib[0],
            "ms_source": src,
            "wall_ms": wall,
            "plain_wall_ms": plain_wall,
            "library_wall_ms": lib[1],
        }

    rows = []
    if "seg_argmax_scan" in seen:
        client, flags = seen["seg_argmax_scan"][0]
        m = client.numel()
        rows.append(row("seg_argmax_scan", {"M": m}, (client, flags), None,
                        3 * 4 * m))
    if "stream_scatter" in seen:
        pos, n_out = seen["stream_scatter"][0]
        bsz = pos.numel()
        keep = (pos >= 0) & (pos < n_out)
        lib_idx = pos[keep].long()
        lib_val = torch.arange(bsz, **i32)[keep]
        # like for like: the fill of the -1 holes is inside the call
        rows.append(row("stream_scatter", {"B": bsz, "n_out": n_out},
                        (pos, n_out),
                        lambda: torch.full((n_out,), -1, **i32).index_put_(
                            (lib_idx,), lib_val),
                        4 * (bsz + n_out)))
    if "ds_mask" in seen:
        args = seen["ds_mask"][0]
        client, clock, valid, dc, ds_, de = args
        n, d = client.numel(), dc.numel()
        # library yardstick, right only for disjoint ranges: one
        # searchsorted over the sorted packed starts and its two gathers
        rkey, order = torch.sort(pack_id(dc, ds_))
        rend = pack_id(dc, de)[order]
        ikey = pack_id(client, clock)

        def library():
            pos = torch.searchsorted(rkey, ikey, side="right") - 1
            pc = pos.clamp(min=0)
            return valid & (pos >= 0) & (ikey < rend[pc]) \
                & (ikey >= rkey[pc])

        rows.append(row("ds_mask", {"N": n, "D": d}, args, library,
                        nbytes(*args) + n))
        # the search kernel alone, on ranges prepared once outside the
        # timed calls: the rest of the wrapper's time is the preparation
        scratch = kernels.ds_mask_prepare(dc, ds_, de)
        # the kernel's own flag: were the run's ranges in search order,
        # so that nothing was sorted
        rows[-1]["ranges_in_order"] = kernels.ds_mask_in_order(scratch, d)
        rows[-1]["search_ms"] = timed(torch, lambda: kernels.ds_mask_search(
            client, clock, valid, d, scratch), 50, graph_required=True)[0]
    if "sv_deficit" in seen:
        (svs,) = seen["sv_deficit"][0]
        r, c = svs.shape
        x = svs.double()
        rsum = x.sum(dim=1)

        def library():
            # sum_c max(a - b, 0) = (sum_c |a - b| + sum_c (a - b)) / 2
            return (torch.cdist(x, x, p=1) + rsum[:, None]
                    - rsum[None, :]) / 2

        # the least work, in INT32 instructions: sum_c max(a - b, 0) =
        # sum_c max(a, b) - rowsum_b, and sum_c max(a, b) is symmetric:
        # one max and half an add a term (IADD3 adds two terms) for each
        # of the R(R+1)/2 unordered pairs, one R x C row sum, R^2
        # subtractions
        rows.append(row("sv_deficit", {"R": r, "C": c}, (svs,), library,
                        nbytes(svs) + 8 * r * r,
                        ops=3 * r * (r + 1) * c // 4 + r * c + r * r))
    return rows


if __name__ == "__main__":
    sys.exit(main())
