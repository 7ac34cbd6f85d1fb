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
  10. the multi-tenant server (``MultiDocServer``,
     :func:`multidoc_phase`), before the timing: ``bench.py``'s cold
     tenants (1000 docs of 64 ops and 4 of 4096) in one tick, packed, one
     dispatch a doc, and on the CPU, equal to each doc's own replay; 32
     warm docs of 32,768 ops through a pooled and an unpooled server,
     each pooled steady tick one pool dispatch and one ``stream_scatter``
     launch against 32 unpooled; eviction to snapshots with rehydrate
     (the first ``EVICT_TICKS`` ticks); checkpoint, restore and
     ``cold_start``;
  11. the resident engine and the device merge (:func:`resident_phase`),
     also before the timing: a wide-key union of 1000 writers x 2,600
     ops (:func:`build_wide_key_trace`; 2.18M distinct map keys, past
     the packed stager's 2^21 bound and no other) through
     ``replay_trace`` on the resident engine ``ResidentColumns`` with
     one ``ds_mask`` launch at N = 4,194,304, equal on the CPU, on the
     stream route's ``"stream-fallback"``, with ``clients=`` and on
     the packed route over two staged halves; the resident engine
     equal to the packed device route at 1000 x 1600 byte for byte;
     the device-merge swarms (12 x 25 card == CPU; 16 x 200 mixed on
     ``LogPersistence`` logs, one replica restarted from its log)
     equal to phase 8's scalar mode, each admitting round one rebuild
     pass; a device-merge replica restarting from a native log of the
     1000 x 100 trace in one ``apply_updates`` and one rebuild pass of
     100,000 rows, equal to the cold device route and to the CPU, then
     a remote batch rebuilding only the touched parents' rows;
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
shape (``"path": "incremental"``), replica A's load shape
(``"path": "replica"``), the largest cold multi-tenant batch
(``"path": "multidoc"``), a steady pooled flush (``"path": "pool"``),
and ``ds_mask`` on the resident engine (``"path": "resident"``) and in
the device merge's rebuild (``"path": "device_merge"``); the last line is
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
    from crdt_tpu_torch.ops import _build, deleteset, kernels, staging, statevec
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
    rep_seen, rep_launches, swarm_states = replica_phase(
        torch, kernels, packed_mod, blobs_of["scale_1000x1600"],
        json.dumps(device_results["scale_1000x1600"].cache, sort_keys=True),
        hold_kernel)
    done("8 replica")

    # ---- 10. the multi-tenant server (before the timing, which it feeds)
    mt = multidoc_phase(torch, rp, traces, kernels, packed_mod, hold_kernel)
    done("10 multi-tenant server")

    # ---- 11. the resident engine and the device merge (before the timing,
    # which it feeds)
    res11 = resident_phase(torch, rp, streaming, staging, kernels,
                           deleteset, blobs_of, device_results, same,
                           hold_kernel, swarm_states)
    done("11 resident engine, device merge")

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
    # ... and on the multi-tenant server: its largest cold batch, and
    # the pooled flush's call site (packed._rank_compact through
    # _pool_splice_body) at a steady tick's shape
    mt_rows = []
    for path, (seen, n) in mt.items():
        rows = kernel_rows(torch, kernels, seen, dict.fromkeys(seen, n),
                           max_err)
        for r in rows:
            r["path"] = path
        log(f"kernel times ({path}): " + json.dumps(rows))
        mt_rows += rows
    # ... and ds_mask at phase 11's two new call sites: the resident
    # engine's converge_maps on the wide-key union, and the device
    # merge's rebuild of the 1000 x 100 restart
    res_rows = []
    for path, calls in (("resident", res11["wide"]),
                        ("device_merge", res11["device_merge"])):
        rows = kernel_rows(torch, kernels, {"ds_mask": calls[:1]},
                           {"ds_mask": len(calls)}, max_err)
        for r in rows:
            r["path"] = path
        log(f"kernel times ({path}): " + json.dumps(rows))
        res_rows += rows
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
    print(json.dumps({"kernels": scale_rows + inc_rows + rep_rows + mt_rows
                      + res_rows}), flush=True)
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


# phase 10's deployment: bench.py's --multitenant legs at full size
# (bench.py:1106-1110 for the cold tenants, bench.py:1433 for the warm
# generator; the warm ops a doc scaled so the pool holds ~1.05M rows)
COLD_TENANTS = (1000, 64, 4, 4096)   # build_doc_trace(n_small, ops_small,
#                                      n_big, ops_big)
COLD_MAX_ROWS = 1 << 14
WARM_DOCS = 32
WARM_OPS = 32768
WARM_DELTA = 64
WARM_STEADY_TICKS = 4
# the eviction step replays the first ticks only (cold, promotion, warm
# delta, one steady), two half ticks each, for the run's time budget
EVICT_TICKS = 4


class _Log:
    """An in-script persistence over one doc's blob history, with the
    two calls ``cold_start`` makes."""

    def __init__(self, blobs):
        self.blobs = list(blobs)

    def get_updates_since(self, doc, seq: int):
        return self.blobs[seq:]

    def get_all_updates(self, doc):
        return list(self.blobs)


def multidoc_phase(torch, rp, traces, kernels, packed_mod,
                   hold_kernel) -> dict:
    """The multi-tenant server (``MultiDocServer``) on the card.

    1. Cold tenants: ``build_doc_trace(1000, 64, 4, 4096)`` through one
       tick of the server on the card (packed batches of at most 2^14
       rows), again with ``pack_docs=False`` (one dispatch a doc) and on
       the CPU: per-doc digests equal, and equal to each doc's own
       ``replay_trace`` on the card. Every packed dispatch launches
       ``seg_argmax_scan`` and ``stream_scatter`` once, each held against
       its plain version on its inputs; no doc falls back. One more card
       tick under the sync debug mode: no host sync between a batch's
       stage and its fetch.
    2. Warm tenants: 32 ``_SteadyStream`` docs of 32,768 ops through a
       pooled and an unpooled server (``CRDT_TPU_DEVICE_MIN=1``): a cold
       tick, a promotion tick, a warm delta tick, then 4 timed steady
       ticks of 64-op deltas. Each pooled steady tick is exactly one pool
       dispatch and one ``stream_scatter`` launch (held against its plain
       version); the unpooled server does 32 of each. Digests equal after
       every tick, and at the end equal to the card's cold replay of each
       doc's union.
    3. Eviction: a third pooled server whose resident budget is half the
       warm set's, with a snapshot store, fed the same blobs half the docs
       a tick: evictions write snapshots, re-touched docs rehydrate and
       apply their tail, digests equal step 2's, the resident peak stays
       within the budget.
    4. Checkpoint and restore: step 2's pooled server checkpointed and
       restored into a fresh server; one more tick on both (a steady delta
       and one concurrent map write a doc) is one pool dispatch on each,
       with equal digests; ``cold_start`` of one doc from the checkpoint
       store and an in-script log takes the snapshot rung with an equal
       cache.

    No counted host detour may fire: no cold fallback doc, no pool
    width overflow round, no pool-budget refusal, no snapshot fallback,
    no device ladder rung. Returns the kernel inputs and launches for
    the ``"multidoc"`` and ``"pool"`` rows of the kernels line."""
    import os
    import tempfile

    from crdt_tpu_torch.codec import v1
    from crdt_tpu_torch.core.ids import DeleteSet
    from crdt_tpu_torch.core.records import ItemRecord
    from crdt_tpu_torch.models.incremental import IncrementalReplay
    from crdt_tpu_torch.models.multidoc import MultiDocServer, cache_digest
    from crdt_tpu_torch.obs import (TickTimeline, Tracer, set_timeline,
                                    set_tracer)
    from crdt_tpu_torch.storage.snapshot import SnapshotStore

    sites = ((packed_mod, "seg_argmax_scan"), (packed_mod, "stream_scatter"))

    def counted(run, device: str):
        """``run()`` with the launch counts zeroed just before and read
        just after, the tracer and the timeline on, the kernels' inputs
        captured. Returns (result, wall s, launches, inputs, tracer
        report, timeline records, device dispatches)."""
        tracer = set_tracer(Tracer(enabled=True))
        tl = set_timeline(TickTimeline(enabled=True))
        seen: dict = {}
        torch.cuda.synchronize()
        kernels.reset_launches()
        d0 = packed_mod.device_dispatch_count
        t0 = time.perf_counter()
        with capture_kernel_inputs(seen, *sites):
            out = run()
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        disp = packed_mod.device_dispatch_count - d0
        set_tracer(Tracer(enabled=False))
        set_timeline(TickTimeline(enabled=False))
        rep = tracer.report()
        guard = {k: v for k, v in rep["counters"].items()
                 if k.startswith("device.") or k.startswith("snap.fallbacks")
                 or k.startswith("tenant.pool_refusals")
                 or k.startswith("tenant.pool_host_rounds")}
        if guard:
            raise AssertionError(f"multidoc: a host detour or device "
                                 f"fallback fired: {guard}")
        return out, wall, counts, seen, rep, tl.records(), disp

    def lanes(rec) -> dict:
        return {k: round(v, 6) for k, v in sorted(rec["lanes"].items())}

    # ---- 1. cold tenants
    label = "multidoc_cold"
    t0 = time.perf_counter()
    docs = traces.build_doc_trace(*COLD_TENANTS)
    rows = sum(len(rp.decode(b)["client"]) for b in docs.values())
    log(f"{label}: build_doc_trace{COLD_TENANTS}: {len(docs)} docs, {rows} "
        f"rows, built in {time.perf_counter() - t0:.3f} s")

    def cold_tick(device: str, **kw):
        srv = MultiDocServer(max_rows_per_dispatch=COLD_MAX_ROWS,
                             device=device, **kw)
        for d, blobs in docs.items():
            srv.submit_many(d, blobs)
        rep, wall, counts, seen, _, recs, _ = counted(srv.tick, device)
        digests = {d: srv.digest(d) for d in docs}
        if rep.docs != len(docs) or rep.fallback_docs:
            raise AssertionError(f"{label} [{device}, {kw}]: {rep}")
        return srv, rep, wall, counts, seen, recs[-1], digests

    # warm-up: CUDA context, allocator pools
    cold_tick("cuda")
    runs = {}
    for name, device, kw in (("packed", "cuda", {}),
                             ("per-doc", "cuda", {"pack_docs": False}),
                             ("packed", "cpu", {})):
        srv, rep, wall, counts, seen, rec, digests = cold_tick(device, **kw)
        runs[(name, device)] = (rep, seen, digests)
        log(f"{label} [{name}, {device}]: {len(docs)} docs in {wall:.3f} s "
            f"({len(docs) / wall:.1f} docs/s); {rep.dispatches} dispatches, "
            f"{len(rep.batches)} batches of {list(rep.batches)[:8]}...; "
            f"launches {counts}")
        log(f"{label} [{name}, {device}]: timeline lanes (s) "
            f"{json.dumps(lanes(rec))}; stall {rec['stall_ms']:.3f} ms; "
            f"overlap_efficiency {rec['overlap_efficiency']}")
        want = {k: 0 for k in counts}
        if device == "cuda":
            want.update(dict.fromkeys(ROUTE_KERNELS["device"],
                                      rep.dispatches))
        if counts != want:
            raise AssertionError(f"{label} [{name}, {device}]: launches "
                                 f"{counts} for {rep.dispatches} dispatches")
        for kname, calls in seen.items():
            for args in calls:
                hold_kernel(kname, *args)
    ref = runs[("packed", "cuda")][2]
    for key, (_, _, digests) in runs.items():
        if digests != ref:
            raise AssertionError(f"{label}: digests of {key} differ")
    t0 = time.perf_counter()
    for d, blobs in docs.items():
        if cache_digest(rp.replay_trace(blobs, device="cuda").cache) != ref[d]:
            raise AssertionError(f"{label}: {d} differs from replay_trace")
    log(f"{label}: packed == per-doc == CPU digests, == each doc's "
        f"replay_trace on the card ({time.perf_counter() - t0:.3f} s for "
        f"{len(docs)} replays); kernels == plain on every dispatch's inputs")
    cold_seen = runs[("packed", "cuda")][1]
    cold_launches = runs[("packed", "cuda")][0].dispatches

    # one more packed card tick: no host sync between a batch's stage
    # and its fetch (the dispatch is enqueued, the fetch is the sync)
    srv = MultiDocServer(max_rows_per_dispatch=COLD_MAX_ROWS, device="cuda")
    for d, blobs in docs.items():
        srv.submit_many(d, blobs)
    found: dict = {}
    enqueue = srv._dispatch_async

    def watched(comb):
        out = []
        for k, n in sync_warnings(
                torch, lambda: out.append(enqueue(comb))).items():
            # the mode's own notice, raised when it is switched on
            if "debug mode is a prototype" not in k:
                found[k] = found.get(k, 0) + n
        return out[0]

    srv._dispatch_async = watched
    srv.tick()
    log(f"{label}: host syncs between stage and fetch of every packed "
        f"batch (sync debug mode): {json.dumps(found)}")
    if found:
        raise AssertionError(f"{label}: a batch's dispatch synced the host")
    del srv, runs

    # ---- 2. warm tenants, pooled and unpooled
    label = "multidoc_warm"
    prev_min = os.environ.get("CRDT_TPU_DEVICE_MIN")
    os.environ["CRDT_TPU_DEVICE_MIN"] = "1"  # as bench.py's pooled leg
    try:
        t0 = time.perf_counter()
        streams = [traces._SteadyStream(500 + i) for i in range(WARM_DOCS)]
        names = [f"w{i:02d}" for i in range(WARM_DOCS)]
        ticks = [dict(zip(names, (s.delta(WARM_OPS) for s in streams)))]
        for _ in range(2 + WARM_STEADY_TICKS):
            ticks.append(dict(zip(names, (s.delta(WARM_DELTA)
                                          for s in streams))))
        log(f"{label}: {WARM_DOCS} docs x {WARM_OPS} ops, then "
            f"{len(ticks) - 1} deltas of {WARM_DELTA} ops a doc, built in "
            f"{time.perf_counter() - t0:.3f} s")
        torch.cuda.reset_peak_memory_stats()
        pooled = MultiDocServer(device="cuda", pool=True)
        private = MultiDocServer(device="cuda", pool=False)
        kinds = ("cold", "promotion", "warm delta") + ("steady",) * \
            WARM_STEADY_TICKS
        tick_digests = []
        pool_seen: list = []
        walls = {"pooled": [], "unpooled": []}
        for t, (kind, blobs) in enumerate(zip(kinds, ticks)):
            out = {}
            for name, srv in (("pooled", pooled), ("unpooled", private)):
                for d, b in blobs.items():
                    srv.submit(d, b)
                rep, wall, counts, seen, trep, recs, disp = counted(
                    srv.tick, "cuda")
                if rep.fallback_docs:
                    raise AssertionError(f"{label} [{name}] tick {t}: {rep}")
                spans = {k: round(v["total_s"], 6)
                         for k, v in trep["spans"].items()
                         if k.startswith("pool.") or k.startswith(
                             "incremental.")}
                h2d = trep["counters"].get("xfer.h2d_bytes", 0)
                log(f"{label} [{name}] tick {t} ({kind}): {wall:.4f} s; "
                    f"{rep}; device dispatches {disp}; launches {counts}; "
                    f"h2d bytes {h2d}; spans (s) {json.dumps(spans)}; "
                    f"lanes (s) {json.dumps(lanes(recs[-1]))}")
                if kind == "steady":
                    walls[name].append(wall)
                    want = {k: 0 for k in counts}
                    if name == "pooled":
                        want["stream_scatter"] = 1
                        ok = rep.pool_dispatches == 1 and disp == 1
                        pool_seen.extend(seen["stream_scatter"])
                    else:
                        want["stream_scatter"] = WARM_DOCS
                        ok = rep.pool_dispatches == 0 and disp == WARM_DOCS
                    if not ok or counts != want:
                        raise AssertionError(
                            f"{label} [{name}] tick {t}: {disp} dispatches, "
                            f"launches {counts}, {rep}")
                    for args in seen.get("stream_scatter", ()):
                        hold_kernel("stream_scatter", *args)
                t1 = time.perf_counter()
                out[name] = {d: srv.digest(d) for d in names}
                log(f"{label} [{name}] tick {t}: digests read in "
                    f"{time.perf_counter() - t1:.3f} s")
            if out["pooled"] != out["unpooled"]:
                raise AssertionError(f"{label}: tick {t}: pooled != unpooled")
            tick_digests.append(out["pooled"])
        pool = pooled.pool
        for srv in (pooled, private):
            for d in names:
                st = srv._docs[d]
                if st.resident is None or st.resident.pool_refusals or (
                        srv is pooled and st.resident.pool is not pool):
                    raise AssertionError(f"{label}: {d} left its route")
        if pool.host_rounds or pooled.snap_fallback_count:
            raise AssertionError(f"{label}: a counted host detour fired")
        # the rows one doc's steady round re-converges: the segments its
        # last delta touched
        eng = pooled._docs[names[0]].resident
        touched = {eng._row_segkey(r)
                   for r in range(eng.cols.n - WARM_DELTA, eng.cols.n)}
        n_sel = sum(len(eng._seg_rows[sk]) for sk in touched)
        log(f"{label}: steady tick wall (s) pooled {walls['pooled']}, "
            f"unpooled {walls['unpooled']}; pool device_bytes "
            f"{pool.device_bytes()}, peak_bytes {pool.peak_bytes}, "
            f"relocations {pool.relocations}, compactions "
            f"{pool.compactions}, dispatches {pool.dispatches}; "
            f"torch.cuda.max_memory_allocated "
            f"{torch.cuda.max_memory_allocated()}; sel_bucket (the "
            f"scatter's B) {[int(a.shape[0]) for a, _ in pool_seen]}")
        log(f"{label}: the auto rule at this tick's largest segment "
            f"({n_sel} rows a doc): crossover_use_host -> "
            f"{IncrementalReplay.crossover_use_host(n_sel, 'cuda')}; "
            f"calibration {json.dumps(IncrementalReplay.calibration_info('cuda'))}")
        t0 = time.perf_counter()
        for i, d in enumerate(names):
            union = [tk[d] for tk in ticks]
            got = cache_digest(rp.replay_trace(union, device="cuda").cache)
            if got != tick_digests[-1][d]:
                raise AssertionError(f"{label}: {d} != its cold replay")
        log(f"{label}: pooled == unpooled after every tick, == the cold "
            f"device replay of each doc's union ({time.perf_counter() - t0:.3f}"
            f" s); scatter == plain on every steady flush's inputs")
        warm_bytes = pooled.resident_bytes_total()
        del private

        # ---- 3. eviction and rehydrate
        label = "multidoc_evict"
        budget = warm_bytes // 2
        with tempfile.TemporaryDirectory() as tmp:
            third = MultiDocServer(device="cuda", pool=True,
                                   resident_max_bytes=budget,
                                   snap_store=SnapshotStore(tmp))
            tracer = set_tracer(Tracer(enabled=True))
            t0 = time.perf_counter()
            for t, blobs in enumerate(ticks[:EVICT_TICKS]):
                for half in (0, 1):
                    for d, b in blobs.items():
                        if int(d[1:]) % 2 == half:
                            third.submit(d, b)
                    rep = third.tick()
                    if rep.fallback_docs:
                        raise AssertionError(f"{label}: tick {t}: {rep}")
                if {d: third.digest(d) for d in names} != tick_digests[t]:
                    raise AssertionError(f"{label}: tick {t} != step 2")
            wall = time.perf_counter() - t0
            set_tracer(Tracer(enabled=False))
            snap = {k: v for k, v in tracer.report()["counters"].items()
                    if k.startswith("snap.") or k.startswith("tenant.")}
            log(f"{label}: budget {budget} bytes (half of {warm_bytes}); "
                f"{2 * EVICT_TICKS} half ticks in {wall:.3f} s; resident peak "
                f"{third.resident_peak_bytes()}; counters {json.dumps(snap)}")
            detours = [k for k in tracer.report()["counters"]
                       if k.startswith(("snap.fallbacks", "device.",
                                        "tenant.pool_refusals",
                                        "tenant.pool_host_rounds"))]
            if not snap.get("snap.evict_writes") or not snap.get(
                    "snap.loads") or detours or \
                    third.snap_fallback_count or \
                    third.resident_peak_bytes() > budget:
                raise AssertionError(f"{label}: evictions, rehydrates or "
                                     "the budget not as required")
            del third

        # ---- 4. checkpoint and restore
        label = "multidoc_restore"
        with tempfile.TemporaryDirectory() as tmp:
            store = SnapshotStore(tmp)
            t0 = time.perf_counter()
            n_ckpt = pooled.checkpoint(store)
            ckpt_s = time.perf_counter() - t0
            fresh = MultiDocServer(device="cuda")
            t0 = time.perf_counter()
            n_rest = fresh.restore(store)
            restore_s = time.perf_counter() - t0
            log(f"{label}: checkpoint of {n_ckpt} docs {ckpt_s:.3f} s; "
                f"restore of {n_rest} docs {restore_s:.3f} s")
            if n_ckpt != WARM_DOCS or n_rest != WARM_DOCS:
                raise AssertionError(f"{label}: {n_ckpt} / {n_rest} docs")
            # a steady delta and one concurrent map write a doc: the
            # rehydrated engines advance tail-shaped deltas on the host
            # (no dispatch, as in the reference); the concurrent write
            # needs the device
            extra = {
                d: [s.delta(WARM_DELTA), v1.encode_update([ItemRecord(
                    client=1_000_000 + i, clock=0, parent_root="m",
                    key="k0", content=-i)], DeleteSet())]
                for i, (d, s) in enumerate(zip(names, streams))}
            reps = {}
            for name, srv in (("checkpointed", pooled), ("restored", fresh)):
                for d, bl in extra.items():
                    for b in bl:
                        srv.submit(d, b)
                rep, wall, counts, _, _, _, disp = counted(srv.tick, "cuda")
                reps[name] = rep
                log(f"{label} [{name}]: tick {wall:.4f} s; {rep}; device "
                    f"dispatches {disp}; launches {counts}")
                if rep.pool_dispatches != 1 or disp != 1:
                    raise AssertionError(f"{label} [{name}]: {rep}")
            after = {d: pooled.digest(d) for d in names}
            if {d: fresh.digest(d) for d in names} != after:
                raise AssertionError(f"{label}: restored != checkpointed")
            d = names[0]
            hist = [tk[d] for tk in ticks] + extra[d]
            t0 = time.perf_counter()
            eng, path = rp.cold_start(d, _Log(hist), store, device="cuda")
            cs = time.perf_counter() - t0
            if path != "snapshot" or cache_digest(eng.cache) != after[d]:
                raise AssertionError(f"{label}: cold_start {path}")
            log(f"{label}: restored == checkpointed after one more tick; "
                f"cold_start({d}) path {path} in {cs:.3f} s, cache equal")
    finally:
        if prev_min is None:
            os.environ.pop("CRDT_TPU_DEVICE_MIN", None)
        else:
            os.environ["CRDT_TPU_DEVICE_MIN"] = prev_min

    # the largest cold batch's inputs and one steady flush's, first
    biggest = {k: sorted(v, key=lambda a: -int(a[0].shape[0]))
               for k, v in cold_seen.items()}
    return {"multidoc": (biggest, cold_launches),
            "pool": ({"stream_scatter": pool_seen}, len(pool_seen))}


def swarm_round(mode: str, n_reps: int, n_ops: int, mixed: bool = False,
                device=None, log_dir=None) -> tuple:
    """``bench.py``'s product swarm (``swarm_round``, bench.py:4670-4707)
    through the port's ``ypear_crdt`` over the loopback router: fixed
    client ids, batched receive, the plain op mix (map sets and list
    pushes) or the mixed one (maps, list appends, mid-inserts at a live
    index, nested array-in-map, delivery interleaved every 8 replicas).
    With ``log_dir``, replica ``i`` keeps its update log in
    ``{log_dir}/{i}.kvlog`` (``LogPersistence``). Fails unless every
    replica's ``c`` is equal. Returns the replicas and the wall seconds
    of the ops and their delivery."""
    from crdt_tpu_torch.net import LoopbackNetwork, LoopbackRouter, ypear_crdt
    from crdt_tpu_torch.storage import LogPersistence

    net = LoopbackNetwork()
    kw = {"device": device} if mode in ("resident", "device") else {}
    reps = [ypear_crdt(LoopbackRouter(net, f"pk{i}"), topic="b",
                       client_id=i + 1, merge_mode=mode,
                       batch_incoming=True,
                       persistence=(LogPersistence(f"{log_dir}/{i}.kvlog")
                                    if log_dir else None), **kw)
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
    Returns the scatter's inputs of A's load, its launch count and the
    swarms' final ``c`` by (replicas, mode, device)."""
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
    return calls[:1], counts["stream_scatter"], states


# ---------------------------------------------------------------------------
# phase 11: the resident engine and the device merge
# ---------------------------------------------------------------------------

# the wide-key union: writers x ops a writer, and the shared keys their
# sixteenth ops set; 2,177,000 fresh keys put it past the packed
# stager's 2^21 key bound
WIDE_WRITERS = 1000
WIDE_OPS = 2600
WIDE_SHARED = 4096
# the fresh writers of the remote batch after the 1000 x 100 restart
RESTART_BATCH_WRITERS = 50


def _prev_in_group(rows, groups):
    """For rows (ascending clocks) and their group ids: each row's
    previous row in its group, or -1."""
    import numpy as np

    order = np.lexsort((rows, groups))
    g, rr = groups[order], rows[order]
    prev = np.where(np.r_[False, g[1:] == g[:-1]], np.r_[-1, rr[:-1]], -1)
    out = np.empty(len(rows), np.int64)
    out[order] = prev
    return out


def build_wide_key_trace(n_writers: int = WIDE_WRITERS,
                         n_ops: int = WIDE_OPS,
                         n_shared: int = WIDE_SHARED, seed: int = 0):
    """One v1 blob a writer, built from numpy columns by the port's
    native encoder. Writer ``r`` (client ``r + 1``) emits ``n_ops`` ops;
    op ``j`` is a push to list ``l{(r + j) % 8}`` chained to the
    writer's previous push there when ``j % 10 == 9``, else, when
    ``j % 16 == 0``, a set in root map ``m`` of a shared key ``s{h}``
    (``h`` drawn from ``default_rng(seed)``) chained to the writer's
    previous set of that key, else a set of the fresh key ``k{r}-{j}``.
    Content is ``r * n_ops + j``; 5% of each writer's ops are deleted in
    its blob's delete set, as in ``build_trace``."""
    import numpy as np

    from crdt_tpu_torch.codec import native
    from crdt_tpu_torch.core.ids import DeleteSet
    from crdt_tpu_torch.core.store import K_ANY

    rng = np.random.default_rng(seed)
    j = np.arange(n_ops, dtype=np.int64)
    push = j % 10 == 9
    shared = ~push & (j % 16 == 0)
    fresh = ~push & ~shared
    n_fresh = int(fresh.sum())
    roots = ["m"] + [f"l{i}" for i in range(8)]
    none = np.full(n_ops, -1, np.int64)
    blobs = []
    for r in range(n_writers):
        client = r + 1
        h = rng.integers(0, n_shared, int(shared.sum()))
        lst = (r + j) % 8
        ock = none.copy()
        ock[push] = _prev_in_group(j[push], lst[push])
        ock[shared] = _prev_in_group(j[shared], h)
        uniq_h, h_inv = np.unique(h, return_inverse=True)
        kid = np.full(n_ops, -1, np.int32)
        kid[fresh] = np.arange(n_fresh)
        kid[shared] = n_fresh + h_inv
        dec = {
            "client": np.full(n_ops, client, np.int64),
            "clock": j,
            "parent_root": np.where(push, 1 + lst, 0).astype(np.int32),
            "parent_client": none,
            "parent_clock": none,
            "key_id": kid,
            "origin_client": np.where(ock >= 0, client, -1),
            "origin_clock": ock,
            "right_client": none,
            "right_clock": none,
            "kind": np.full(n_ops, K_ANY, np.int32),
            "type_ref": np.full(n_ops, -1, np.int32),
            "contents": list(range(r * n_ops, (r + 1) * n_ops)),
            "roots": roots,
            "keys": [f"k{r}-{x}" for x in j[fresh].tolist()]
            + [f"s{x}" for x in uniq_h.tolist()],
        }
        ds = DeleteSet()
        for k in rng.choice(n_ops, size=max(1, n_ops // 20), replace=False):
            ds.add(client, int(k))
        blobs.append(native.encode_from_columns(dec, ds))
    return blobs


def split_union_by_writers(dec: dict, cols: dict) -> list:
    """An independent answer for a union the packed stager refuses on
    its key bound: two copies of the kernel columns, each clearing
    ``valid`` on the fresh-key sets (keys ``k...``) of half the writers
    and keeping every shared-key set, every push and the delete set,
    with ``key_id`` re-densified over its valid rows. Each half stages
    with about half the keys."""
    import numpy as np

    kid = np.asarray(cols["key_id"], np.int64)
    is_fresh_key = np.asarray([k.startswith("k") for k in dec["keys"]],
                              bool)
    fresh = (kid >= 0) & is_fresh_key[np.clip(kid, 0, None)]
    clients = np.unique(cols["client"])
    upper = np.isin(cols["client"], clients[len(clients) // 2:])
    halves = []
    for drop in (upper, ~upper):
        half = dict(cols)
        valid = np.asarray(cols["valid"], bool) & ~(fresh & drop)
        keyed = valid & (kid >= 0)
        dense = kid.copy()
        dense[keyed] = np.unique(kid[keyed], return_inverse=True)[1]
        half["valid"] = valid
        half["key_id"] = dense.astype(np.asarray(cols["key_id"]).dtype)
        halves.append(half)
    return halves


def merge_half_caches(a: dict, b: dict, root: str = "m") -> dict:
    """The two halves' caches as one: their ``root`` maps are disjoint
    on fresh keys and equal on shared ones, every other root equal."""
    shared = set(a[root]) & set(b[root])
    if any(not k.startswith("s") or a[root][k] != b[root][k]
           for k in shared):
        raise AssertionError("halves disagree on a shared key or share "
                             "a fresh one")
    if {k: v for k, v in a.items() if k != root} != \
            {k: v for k, v in b.items() if k != root}:
        raise AssertionError("halves disagree outside the map")
    out = dict(a)
    out[root] = {**a[root], **b[root]}
    return out


@contextmanager
def timing(secs: dict, *sites):
    """Charge the wall seconds of each call of the functions named by
    ``sites`` — (module or class, attribute, label) triples — to
    ``secs[label]``; ``secs[label + " calls"]`` counts the calls and
    ``secs[label + " out"]`` keeps the last result."""
    originals = [(obj, name, getattr(obj, name)) for obj, name, _ in sites]

    def timed_call(fn, label, static):
        def call(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            secs[label] = secs.get(label, 0.0) + time.perf_counter() - t0
            secs[label + " calls"] = secs.get(label + " calls", 0) + 1
            secs[label + " out"] = out
            return out
        return staticmethod(call) if static else call

    for (obj, name, fn), (_, _, label) in zip(originals, sites):
        static = isinstance(obj, type) and isinstance(
            obj.__dict__.get(name), staticmethod)
        setattr(obj, name, timed_call(fn, label, static))
    try:
        yield
    finally:
        for obj, name, fn in originals:
            if isinstance(obj, type) and isinstance(
                    obj.__dict__.get(name), staticmethod):
                setattr(obj, name, staticmethod(fn))
            else:
                setattr(obj, name, fn)


def resident_phase(torch, rp, streaming, staging, kernels, deleteset,
                   blobs_of, device_results, same, hold_kernel,
                   scalar_states: dict, device: str = "cuda",
                   wide=(WIDE_WRITERS, WIDE_OPS, WIDE_SHARED)) -> dict:
    """Phase 11, the resident engine and the device merge on ``device``:

    1. the wide-key union (:func:`build_wide_key_trace`): the packed
       stager refuses it on its key bound alone; ``replay_trace``
       converges it through ``ResidentColumns`` with one ``ds_mask``
       launch at the resident capacity and no other kernel; the CPU,
       the stream route's ``"stream-fallback"`` and ``clients=`` give
       the same cache and snapshot; and so does the packed route over
       two staged halves (:func:`split_union_by_writers`);
    2. the resident engine against the packed one on the 1000 x 1600
       union: ``_converge_resident``'s gather, materialize and compact
       equal phase 4's device route byte for byte, one ``ds_mask``
       launch; once more under ``set_sync_debug_mode("warn")``;
    3. the device merge through the product (:func:`device_merge_checks`),
       held against phase 8's scalar swarms (``scalar_states``).

    Every kernel input is held against its plain version, and the
    guard ladder must not climb. Returns the ``ds_mask`` inputs of the
    wide-key union's device route and of the 1000 x 100 restart."""
    import numpy as np

    from crdt_tpu_torch.obs import Tracer, set_tracer

    label = f"resident [{device}]"
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    tracer = set_tracer(Tracer(enabled=True))
    out: dict = {}

    def run(fn, *, what: str, ds_mask=0, packed=0, dev=device):
        """``fn()`` with every count zeroed just before and read just
        after: on the card ``ds_mask`` launches (a number, or a callable
        read after the run), ``packed`` launches of each of the packed
        route's two kernels and no other kernel; on the CPU none. Each
        ``ds_mask`` input is held against the plain version. Returns
        ``fn()``'s result and those inputs."""
        seen: dict = {}
        card = torch.device(dev).type == "cuda"
        sync()
        kernels.reset_launches()
        with capture_kernel_inputs(seen, (deleteset, "ds_mask")):
            res = fn()
        sync()
        counts = kernels.launch_counts()
        want = {name: 0 for name in counts}
        if card:
            want["ds_mask"] = ds_mask() if callable(ds_mask) else ds_mask
            want["seg_argmax_scan"] = want["stream_scatter"] = packed
        if counts != want:
            raise AssertionError(f"{label} {what} [{dev}]: launches "
                                 f"{counts}, want {want}")
        calls = seen.get("ds_mask", [])
        if card:
            for args in calls:
                hold_kernel("ds_mask", *args)
        return res, calls

    # ---- 1. the wide-key union
    secs: dict = {}
    t0 = time.perf_counter()
    blobs = build_wide_key_trace(*wide)
    secs["build"] = time.perf_counter() - t0
    tr_secs: dict = {}
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    with timing(tr_secs, (rp, "_converge_resident", "_converge_resident"),
                (staging, "stage", "stage refusal"), (rp, "decode", "dec")):
        card, wide_seen = run(lambda: rp.replay_trace(blobs, device=device),
                              ds_mask=1, what="wide-key device route")
    peak = torch.cuda.max_memory_allocated() if on_card else None
    rc, dec = tr_secs["_converge_resident out"][0], tr_secs["dec out"]
    # why the stager refused the run's union: its key bound alone
    cols, ds = rp.stage(dec)
    valid = np.asarray(cols["valid"], bool)
    kid_max = int(cols["key_id"][valid].max())
    n_parents = len(np.unique(np.stack(
        [cols["parent_is_root"].astype(np.int64), cols["parent_a"],
         cols["parent_b"]]), axis=1))
    clock_max = int(cols["clock"][valid].max())
    key_bound = 1 << staging._KID_BITS  # 2^21
    if not (tr_secs["stage refusal out"] is None and kid_max >= key_bound
            and len(dec["keys"]) > kid_max and n_parents < 1 << 25
            and clock_max < 1 << 40):
        raise AssertionError(
            f"{label}: the union is not refused on its key bound alone "
            f"(key ids to {kid_max}, {n_parents} parents, clocks to "
            f"{clock_max})")
    log(f"{label}: wide-key union of {len(blobs)} blobs, "
        f"{len(dec['client'])} rows, {len(dec['keys'])} distinct keys "
        f"(largest key id {kid_max} >= {key_bound}), {n_parents} parents, "
        f"clocks below {clock_max + 1}: the packed stager refuses it")
    n = wide_seen[0][0].numel() if wide_seen else rc.capacity
    if card.path != "device" or rc.device.type != device or \
            n != rc.capacity:
        raise AssertionError(
            f"{label}: path {card.path} on {rc.device}, ds_mask N {n} "
            f"for capacity {rc.capacity}")
    spans = {k: round(v["total_s"], 6) for k, v in
             tracer.report()["spans"].items()
             if k in ("decode", "gather", "materialize", "compact")}
    log(f"{label}: wide-key device route {json.dumps(spans)}, stage "
        f"refusal {tr_secs['stage refusal']:.6f} s, _converge_resident "
        f"{tr_secs['_converge_resident']:.6f} s; capacity {rc.capacity}, "
        f"rc.device_bytes() {rc.device_bytes()}, max_memory_allocated "
        f"{peak}; ds_mask launches 1 at N {n}, D "
        f"{wide_seen[0][3].numel() if wide_seen else 16}")
    out["wide"] = wide_seen[:1]
    del rc, tr_secs

    if on_card:
        t0 = time.perf_counter()
        cpu = rp.replay_trace(blobs, device="cpu")
        secs["CPU replay"] = time.perf_counter() - t0
        same(label, card, cpu, "wide-key union, card vs CPU")
    phases: dict = {}
    t0 = time.perf_counter()
    stream, _ = run(lambda: streaming.stream_replay(
        blobs, device=device, phases=phases), ds_mask=1,
        what="stream fallback")
    secs["stream route"] = time.perf_counter() - t0
    if stream.path != "stream-fallback" or phases.get("fallback") is not True:
        raise AssertionError(f"{label}: stream route took {stream.path}")
    same(label, stream, card, "wide-key union, stream-fallback vs device")
    ids = sorted(set(int(c) for c in dec["client"]))
    t0 = time.perf_counter()
    seeded, _ = run(lambda: rp.replay_trace(blobs, clients=ids,
                                            device=device),
                    ds_mask=1, what="clients=")
    secs["clients= route"] = time.perf_counter() - t0
    same(label, seeded, card, "wide-key union, clients= vs device")

    t0 = time.perf_counter()
    halves = []
    for i, half in enumerate(split_union_by_writers(dec, cols)):
        if staging.stage(half) is None:
            raise AssertionError(f"{label}: half {i} does not stage")
        res, _ = run(lambda: rp.converge(half, device=device),
                     packed=1, what=f"half {i} (packed route)")
        if res[0] != "packed":
            raise AssertionError(f"{label}: half {i} took {res[0]}")
        w, v, o = rp.gather(dec, ds, res, device=device)
        halves.append(rp.materialize(dec, ds, w, v, o))
    merged = merge_half_caches(*halves)
    secs["two packed halves"] = time.perf_counter() - t0
    if json.dumps(merged, sort_keys=True) != json.dumps(card.cache,
                                                        sort_keys=True):
        raise AssertionError(f"{label}: the two packed halves != the "
                             "resident engine")
    log(f"{label}: wide-key union equal on the CPU, the stream route "
        "(stream-fallback), clients= and the packed route over two "
        f"staged halves ({len(halves[0]['m'])} and {len(halves[1]['m'])} "
        f"visible keys); seconds {json.dumps(secs)}")
    del blobs, dec, cols, halves, merged, card, stream, seeded

    # ---- 2. the resident engine against the packed one at 1000 x 1600
    big = "scale_1000x1600"
    dec = rp.decode(blobs_of[big])
    cols, ds = rp.stage(dec)

    def resident_replay():
        res = rp._converge_resident(cols, None, device=device)
        w, v, o = rp.gather(dec, ds, ("resident", res), device=device)
        return res[0], rp.materialize(dec, ds, w, v, o)

    t0 = time.perf_counter()
    (rc, cache), seen = run(resident_replay, ds_mask=1,
                            what="1000x1600 resident")
    wall = time.perf_counter() - t0
    snap = rp.compact(dec, ds)
    want = device_results[big]
    if json.dumps(cache, sort_keys=True) != json.dumps(
            want.cache, sort_keys=True) or snap != want.snapshot:
        raise AssertionError(f"{label}: resident engine != packed device "
                             "route at 1000x1600")
    n = seen[0][0].numel() if seen else rc.capacity
    log(f"{label}: 1000x1600 on the resident engine == the packed device "
        f"route byte for byte (cache and snapshot); {wall:.3f} s "
        f"converge + gather + materialize, capacity {rc.capacity}, "
        f"ds_mask N {n}")
    if on_card:
        syncs = sync_warnings(torch, resident_replay)
        log(f"{label}: host syncs of one resident converge + gather "
            f"(set_sync_debug_mode warn): {json.dumps(syncs)}")
    del dec, cols, rc, cache

    # ---- 3. the device merge through the product
    out["device_merge"] = device_merge_checks(
        torch, rp, blobs_of, device_results, scalar_states, run, label,
        device)
    guard = {k: v for k, v in tracer.report()["counters"].items()
             if k.startswith("device.")}
    set_tracer(Tracer(enabled=False))
    if any(guard.values()):
        raise AssertionError(f"{label}: the failure ladder ran: {guard}")
    return out



def _rebuild_spy(device_apply, calls: list):
    """Patch ``device_apply._rebuild_kernel`` to record, for each
    kernel rebuild pass, its row count, whether a map row is among them
    (only then does ``converge_maps``, and with it ``ds_mask``, run) and
    its device; returns the original, to restore."""
    import numpy as np

    from crdt_tpu_torch.core.store import K_GC, NO_KEY

    orig = device_apply._rebuild_kernel

    def spy(engine, sids, device):
        st = engine._device_rebuild_state
        rows = np.asarray([r for sid in sids for r in st["spec_rows"][sid]],
                          np.int64)
        s = engine.store
        has_map = bool(((s.key_id[rows] != NO_KEY)
                        & (s.kind[rows] != K_GC)).any())
        calls.append((len(rows), has_map, device.type))
        return orig(engine, sids, device)

    device_apply._rebuild_kernel = spy
    return orig


def _admitting_rounds(device_apply, rounds: list):
    """Patch ``device_apply.apply_records_device`` to count the remote
    rounds that admitted rows; returns the original, to restore."""
    orig = device_apply.apply_records_device

    def spy(engine, records, delete_set=None, *, device):
        n0 = engine.store.n
        orig(engine, records, delete_set, device=device)
        if engine.store.n > n0:
            rounds.append(engine.store.n - n0)

    device_apply.apply_records_device = spy
    return orig


def device_merge_checks(torch, rp, blobs_of, device_results,
                        scalar_states, run, label, device) -> list:
    """Phase 11's device merge (``Crdt(device_merge=True)`` under
    ``ypear_crdt(merge_mode="device")``) on ``device``:

    a. ``bench.py``'s product swarm at 12 x 25 in device mode, on
       ``device`` and on the CPU: equal to phase 8's scalar mode
       (``scalar_states``, by (replicas, mode, device)), every replica's
       full state equal card to CPU byte for byte; every remote round
       that admitted rows is one ``engine.rebuild`` kernel pass, with
       one ``ds_mask`` launch when its rows include a map row;
    b. BASELINE #3, the mixed swarm at 16 x 200, each replica on its
       own ``LogPersistence``: equal to scalar mode; a replica closed
       and restarted from its log in device mode keeps its cache;
    c. BASELINE #5 at its stated size: a device-merge replica restarts
       from a ``LogPersistence`` log of the 1000 x 100 trace in one
       ``apply_updates``, one rebuild pass over 100,000 rows and one
       ``ds_mask`` launch; its cache equals phase 4's device route, its
       full state replays to the same cache, and the same restart on
       the CPU encodes the same bytes. Then 100 local edits and one
       remote batch of 50 fresh map writers: that rebuild selects only
       the touched maps' rows.

    Returns the ``ds_mask`` inputs of the restart's rebuild."""
    import tempfile

    from crdt_tpu_torch.api.doc import Crdt
    from crdt_tpu_torch.core import device_apply
    from crdt_tpu_torch.models import traces
    from crdt_tpu_torch.net import (LoopbackNetwork, LoopbackRouter,
                                    ypear_crdt)
    from crdt_tpu_torch.obs import get_tracer
    from crdt_tpu_torch.storage import LogPersistence

    dev_type = torch.device(device).type
    walls: dict = {}
    passes: list = []
    rounds: list = []
    spies = (_rebuild_spy(device_apply, passes),
             _admitting_rounds(device_apply, rounds))

    def counted(what, fn, dev):
        """``fn()`` with its rebuild passes and admitting rounds: one
        pass a round, on ``dev``, and on the card one ``ds_mask`` launch
        a pass with map rows."""
        passes.clear()
        rounds.clear()
        res, seen = run(fn, what=what, dev=dev, ds_mask=lambda: sum(
            has_map for _, has_map, _ in passes))
        if len(passes) != len(rounds) or any(
                d != torch.device(dev).type for _, _, d in passes):
            raise AssertionError(
                f"{label} {what}: {len(rounds)} admitting rounds, "
                f"{len(passes)} rebuild passes on {set(passes)}")
        log(f"{label} {what} [{dev}]: {len(rounds)} admitting rounds, "
            f"one rebuild pass each, {sum(p[1] for p in passes)} with map "
            f"rows (rows a pass {sorted(p[0] for p in passes)[-3:]} at "
            "most)")
        return res, seen

    try:
        # ---- a. the product swarm at 12 x 25
        (n_small, k_small), (n_mixed, k_mixed) = SWARMS
        reps = {}
        for dev in (device, "cpu"):
            (reps[dev], walls[f"12x25 device {dev}"]), _ = counted(
                f"12x25 swarm", lambda: swarm_round(
                    "device", n_small, k_small, device=dev), dev)
        want = scalar_states[(n_small, "scalar", None)]
        for dev, rs in reps.items():
            if any(dict(r.c) != want for r in rs):
                raise AssertionError(f"{label}: 12x25 device [{dev}] != "
                                     "scalar")
        for a, b in zip(reps[device], reps["cpu"]):
            if a.encode_state_as_update() != b.encode_state_as_update():
                raise AssertionError(f"{label}: 12x25 device merge, card "
                                     "!= CPU")

        # ---- b. BASELINE #3: the mixed swarm on native logs
        with tempfile.TemporaryDirectory() as tmp:
            (mixed, walls["16x200 mixed device"]), _ = counted(
                "16x200 mixed swarm", lambda: swarm_round(
                    "device", n_mixed, k_mixed, mixed=True, device=device,
                    log_dir=tmp), device)
            if dict(mixed[0].c) != \
                    scalar_states[(n_mixed, "scalar", None)]:
                raise AssertionError(f"{label}: 16x200 device != scalar")
            before = dict(mixed[5].c)
            for r in mixed:
                r.self_close()
            t0 = time.perf_counter()
            (back, _), _ = counted("16x200 restart", lambda: (ypear_crdt(
                LoopbackRouter(LoopbackNetwork(), "back"), topic="b",
                merge_mode="device", device=device,
                persistence=LogPersistence(f"{tmp}/5.kvlog")), None),
                device)
            walls["16x200 restart from its log"] = time.perf_counter() - t0
            if dict(back.c) != before:
                raise AssertionError(f"{label}: restart from its log "
                                     "lost state")
            back.self_close()
        log(f"{label}: device-merge swarms == scalar (12x25 card == CPU "
            "byte for byte; 16x200 mixed on native logs, and a replica "
            f"restarted from its log); wall s {json.dumps(walls)}")

        # ---- c. BASELINE #5: restart from a 1000 x 100 native log
        small = "trace_1000x100"
        blobs = blobs_of[small]
        with tempfile.TemporaryDirectory() as tmp:
            log_path = f"{tmp}/doc.kvlog"
            store = LogPersistence(log_path)
            store.store_updates("doc", blobs)
            store.close()
            restarts = {}
            for dev in (device, "cpu"):
                secs: dict = {}
                tracer = get_tracer()
                s0 = {k: v["total_s"] for k, v in
                      tracer.report()["spans"].items()}
                with timing(secs, (LogPersistence, "get_all_updates",
                                   "log read"),
                            (Crdt, "_decode_batch", "decode"),
                            (Crdt, "_refresh_cache", "cache refresh"),
                            (Crdt, "apply_updates", "apply_updates")):
                    t0 = time.perf_counter()
                    (r, _), seen = counted("1000x100 restart", lambda: (
                        ypear_crdt(LoopbackRouter(LoopbackNetwork(), "D"),
                                   topic="doc", merge_mode="device",
                                   device=dev,
                                   persistence=LogPersistence(log_path)),
                        None), dev)
                    wall = time.perf_counter() - t0
                split = {k: round(secs[k], 6) for k in (
                    "log read", "decode", "cache refresh", "apply_updates")}
                split.update({k[len("device_merge."):]: round(
                    v["total_s"] - s0.get(k, 0.0), 6) for k, v in
                    tracer.report()["spans"].items()
                    if k.startswith("device_merge.")})
                pad = len(blobs) * 100
                pad = 1 << (pad - 1).bit_length()
                if secs["apply_updates calls"] != 1 or passes != [
                        (len(blobs) * 100, True, torch.device(dev).type)] \
                        or any(args[0].numel() != pad for args in seen):
                    raise AssertionError(
                        f"{label}: restart took {secs['apply_updates calls']}"
                        f" apply_updates and passes {passes}")
                restarts[dev] = r
                if dev == device:
                    restart_seen = seen
                log(f"{label}: 1000x100 restart [{dev}] from a native log "
                    f"of {len(blobs)} updates in {wall:.3f} s, one "
                    f"apply_updates, one rebuild pass over {passes[0][0]} "
                    f"rows; split s {json.dumps(split)}")
        r = restarts[device]
        want = device_results[small]
        if json.dumps(dict(r.c), sort_keys=True) != json.dumps(
                want.cache, sort_keys=True):
            raise AssertionError(f"{label}: restart != cold device route")
        full = r.encode_state_as_update()
        if full != restarts["cpu"].encode_state_as_update():
            raise AssertionError(f"{label}: restart, card != CPU")
        again = rp.replay_trace([full], device=device)
        if json.dumps(again.cache, sort_keys=True) != json.dumps(
                want.cache, sort_keys=True):
            raise AssertionError(f"{label}: the restart's full state "
                                 "replays to another cache")

        # edits, then a remote batch of fresh writers on the maps only
        for n in range(2):
            mixed_ops(r, 0, 50, start=50 * n)
        batch = traces.build_trace(RESTART_BATCH_WRITERS, 100, seed=9,
                                   client_base=10_000, map_frac=1.0)
        eng = r.doc.engine
        n0 = eng.store.n
        # rows since the last rebuild: the local edits' and the batch's
        since = eng._device_rebuild_state["len"]
        t0 = time.perf_counter()
        syncs, _ = counted("remote batch", lambda: sync_warnings(
            torch, lambda: r.doc.apply_updates(batch)) if dev_type == "cuda"
            else r.doc.apply_updates(batch), device)
        wall = time.perf_counter() - t0
        touched = {eng._parent_spec_of_row(i)
                   for i in range(since, eng.store.n)}
        want_m = sum(1 for i in range(eng.store.n)
                     if eng._parent_spec_of_row(i) in touched)
        if [p[0] for p in passes] != [want_m] or want_m >= eng.store.n:
            raise AssertionError(f"{label}: remote batch rebuilt "
                                 f"{passes} rows, want {want_m}")
        log(f"{label}: 100 local edits ({n0 - since} rows), then a remote "
            f"batch of {len(batch)} writers ({eng.store.n - n0} rows) in "
            f"{wall:.3f} s: one rebuild pass over m = {want_m} rows, those "
            f"of the {len(touched)} parents with rows since the last "
            f"rebuild, of the doc's {eng.store.n}; host syncs of the "
            f"merge (set_sync_debug_mode warn): {json.dumps(syncs)}")
        for x in restarts.values():
            x.self_close()
    finally:
        device_apply._rebuild_kernel, device_apply.apply_records_device = \
            spies
    return restart_seen


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
