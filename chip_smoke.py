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
  12. replica sync over the encrypted UDP transport (:func:`udp_phase`),
     also before the timing, every router under ``bench.py``'s
     fleet-trace fault schedule: a resident replica restarts from a
     native log of the 1000 x 100 trace (one device round, one
     ``stream_scatter`` launch) and serves a device-merge joiner that
     knows only the rendezvous its first state over the fragmented,
     reliable, encrypted transport (one rebuild pass, one ``ds_mask``
     launch); both equal the cold device route, edit, and converge; one
     device round runs under ``torch_profile``; two replicas behind
     symmetric NATs converge through the relay with a device fault
     injected; three processes on the card (this script with
     ``--udp-child``) are scraped live by a ``FleetCollector`` and meet
     ``bench.py``'s fleet-trace acceptance;
  13. the fleet control plane (:func:`fleet_control_phase`), also before
     the timing: ``bench.py --rebalance``'s leg (:func:`rebalance_leg`)
     with every node's server on the card, gated (no double serve or
     fork, recovery within budget, ON == OFF byte for byte, a completed
     migration) and equal field by field to the same leg on the CPU;
     then three fleet nodes on one card serve phase 10's tenants and
     the 100,000-op BASELINE #5 tenant (:func:`fleet_phase`): a cold
     tick equal to phase 10's digests and phase 4's cache, live
     migrations of "a"'s warm docs and the big tenant under the handoff
     chaos, every moved doc byte-equal to a migration-free oracle, each
     destination's next tick one pool dispatch and one
     ``stream_scatter`` launch, "a" checkpointed, killed and revived;
     then three processes (this script with ``--fleet-child``) hand a
     doc over sealed UDP, and exactly one serves it afterwards;
  14. multi-device on a mesh whose entries all lie on the card
     (:func:`multidevice_phase`), also before the timing: the 1000 x
     1600 union sharded 2, 4 and 8 ways (``ops.shard``: per-shard
     staging, one launch sequence a mesh entry, the boundary exchange
     of the shards' state vectors), each equal to phase 4 byte for byte
     with ``seg_argmax_scan`` and ``stream_scatter`` launched once a
     shard, and ``replay_trace`` with ``CRDT_TPU_SHARDS=4``; the stream
     route with every stream shard sharded two ways, equal to phase 6;
     ``fleet_replay`` sharded and segment-sharded on a 4-entry mesh and
     the two-tier round on a 2 x 2 mesh, equal to phase 5;
     ``MultiDocServer(shards=4)`` on phase 10's cold tenants, every
     digest equal and every batch past ``CRDT_TPU_SHARD_MIN_ROWS``
     sharded; the ring delta on 8 entries equal to the CPU; a
     ``GossipFaultPlan``'s drop and partition rounds, healed to the
     fault-free round;
  15. the multi-process pod (:func:`pod_phase`), also before the
     timing: this script again (``--pod-child``) as the ranks of
     ``gloo`` groups on the one card, each running the unchanged entry
     points on the same inputs, uploading and launching only its own
     mesh entries: ``replay_trace`` of 1000 x 1600 sharded over 4 ranks
     (K = 4, 8), the stream route over 2, ``fleet_replay`` sharded and
     segment-sharded over 4 and two-tier over 2 x 2, the ring delta
     and ``MultiDocServer(shards=4)``, every rank equal to the single
     controller's result; a ``nccl`` pair on one card refused before
     any collective, a one-process ``nccl`` group's collectives equal
     to the mesh's copies and, with two or more cards, a ``nccl``
     group one rank a card;
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
``ds_mask`` on the resident engine (``"path": "resident"``) and in the
device merge's rebuild (``"path": "device_merge"``), phase 12's
restart and join over UDP (``"path": "udp"``), and phase 13's largest
cold batch of a fleet node and a destination's first pooled flush after
it adopts a migrated doc (``"path": "fleet"``), and phase 14's: a shard
of the 4-way sharded converge (``"path": "shard"``), an entry of the
segment step (``"path": "segments"``) and the two-tier step's union
(``"path": "hierarchical"``), and phase 15's call sites in each rank of
the pod (``"path": "pod"``, ``"rank"``, ``"site"``); the last line is
``{"ok": true, "device": {...}}``. Exits non-zero with no result line
when there is no card or the package is not beside this script.

    python3 chip_smoke.py --rehearse-udp JOINS LEGS DEVICE

runs phase 12's late join JOINS times and its fleet leg LEGS times on
``DEVICE`` (``cuda`` or ``cpu``), without the kernel checks, and prints
one JSON line: each run's outcome, seconds, re-probes and re-dials (the
repairs of its stalls, ROADMAP §C). Exits non-zero if any run failed.
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
    if sys.argv[1:2] == ["--udp-child"] and len(sys.argv) == 3:
        return udp_child(sys.argv[2])
    if sys.argv[1:2] == ["--fleet-child"] and len(sys.argv) == 3:
        return fleet_child(sys.argv[2])
    if sys.argv[1:2] == ["--pod-child"] and len(sys.argv) == 3:
        return pod_child(sys.argv[2])
    if sys.argv[1:2] == ["--rehearse-udp"] and len(sys.argv) == 5:
        return rehearse_udp(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
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
    # phase 12's transport, built before any child process starts
    from crdt_tpu_torch.net import transport
    t0 = time.perf_counter()
    transport.random_bytes(1)
    log(f"build: native transport {transport._SO.name} in "
        f"{time.perf_counter() - t0:.3f} s (g++)")

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
    # the scale trace's card results on the fleet and stream routes,
    # which phase 14 holds its mesh mappings against
    route_results: dict = {}

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
        route_results[(label, "fleet")] = card
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
        route_results[(label, "stream")] = card
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
    mt, fleet_tenants = multidoc_phase(torch, rp, traces, kernels,
                                       packed_mod, hold_kernel)
    done("10 multi-tenant server")

    # ---- 11. the resident engine and the device merge (before the timing,
    # which it feeds)
    res11 = resident_phase(torch, rp, streaming, staging, kernels,
                           deleteset, blobs_of, device_results, same,
                           hold_kernel, swarm_states)
    done("11 resident engine, device merge")

    # ---- 12. replica sync over the encrypted UDP transport (before the
    # timing, which it feeds)
    udp = udp_phase(torch, kernels, packed_mod, deleteset, blobs_of,
                    device_results, hold_kernel)
    print(f"phase 12: B's late join took {udp.pop('join_reprobes')} "
          "re-probe(s) (each one the stall of a synced joiner that lost "
          "A's answers, ROADMAP §C) and the joins re-dialed "
          f"{json.dumps(udp.pop('join_redials'), sort_keys=True)} (each a "
          "one-shot join message lost to the schedule, ROADMAP §C)",
          flush=True)
    done("12 sync over UDP")

    # phase 14's tenants: phase 10's cold tenants and their digests
    mt_cold = (fleet_tenants["cold"], fleet_tenants["cold_digests"])

    # ---- 13. the fleet control plane (before the timing, which it feeds)
    fl = fleet_control_phase(
        torch, kernels, packed_mod, traces, hold_kernel, fleet_tenants,
        blobs_of["trace_1000x100"],
        json.dumps(device_results["trace_1000x100"].cache, sort_keys=True))
    del fleet_tenants
    done("13 fleet control plane")

    # ---- 14. multi-device on a mesh of the card (before the timing,
    # which it feeds)
    scale = "scale_1000x1600"
    mesh14 = multidevice_phase(
        torch, rp, streaming, fleet, kernels, packed_mod, deleteset,
        statevec, blobs_of,
        {"device": device_results[scale],
         "fleet": route_results[(scale, "fleet")],
         "stream": route_results[(scale, "stream")]},
        mt_cold, same, hold_kernel)
    done("14 multi-device mesh")

    # ---- 15. the multi-process pod on the card (before the timing, which
    # it feeds)
    pod_rows = pod_phase(
        torch, kernels, blobs_of[scale],
        {"device": device_results[scale],
         "fleet": route_results[(scale, "fleet")],
         "stream": route_results[(scale, "stream")]},
        mt_cold, hold_kernel, max_err)
    del mt_cold
    done("15 multi-process pod")

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
    # ... and phase 12's call sites over UDP: A's restart
    # (packed._rank_compact) and B's rebuild (converge_maps)
    udp_rows = kernel_rows(torch, kernels,
                           {name: calls[:1] for name, calls in udp.items()},
                           {name: len(calls) for name, calls in udp.items()},
                           max_err)
    for r in udp_rows:
        r["path"] = "udp"
    log("kernel times (udp: A's restart, B's join): " + json.dumps(udp_rows))
    # ... and phase 13's: a fleet node's largest cold batch, and a
    # destination's first pooled flush over its adopted docs
    fleet_rows = []
    for site, (seen, n) in (("largest cold batch", fl["fleet"]),
                            ("first flush after adoption",
                             fl["fleet_flush"])):
        rows = kernel_rows(torch, kernels, seen, dict.fromkeys(seen, n),
                           max_err)
        for r in rows:
            r["path"] = "fleet"
            r["site"] = site
        log(f"kernel times (fleet, {site}): " + json.dumps(rows))
        fleet_rows += rows
    # ... and phase 14's call sites on a mesh of the card: each shard of
    # the 4-way sharded converge at 1000 x 1600, each entry of the
    # 4-entry segment step, and the 2 x 2 two-tier step's union
    mesh_rows = []
    for path, (seen, n) in mesh14.items():
        counts = dict.fromkeys(seen, n) if isinstance(n, int) else n
        rows = kernel_rows(torch, kernels, seen, counts, max_err)
        for r in rows:
            r["path"] = path
        log(f"kernel times ({path}): " + json.dumps(rows))
        mesh_rows += rows
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
                      + res_rows + udp_rows + fleet_rows + mesh_rows
                      + pod_rows}),
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
    # phase 13's tenants: these blobs and this server's digests
    tenants = {"cold": docs, "cold_digests": ref, "names": names,
               "streams": streams, "ticks": ticks,
               "tick_digests": tick_digests, "extra": extra}
    return {"multidoc": (biggest, cold_launches),
            "pool": ({"stream_scatter": pool_seen}, len(pool_seen))}, tenants


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


# ---------------------------------------------------------------------------
# phase 12: replica sync over the encrypted UDP transport
# ---------------------------------------------------------------------------

# bench.py's --fleet-trace schedule (bench.py:3218-3222; its defaults at
# bench.py:3380-3384): every router drops 4%, duplicates 2% and delays
# 8% of its outbound messages by 1-3 polls, seeded
UDP_SEED = 7
UDP_FAULTS = {"drop": 0.04, "duplicate": 0.02, "delay": 0.08,
              "delay_polls": (1, 3)}
# bench.py's fleet-trace router knobs (bench.py:3192-3202): fast dial
# retries, an early relay, an announce refresh that repairs a dropped
# (one-shot) announce within a third of a second
UDP_ROUTER = {"relay_after_s": 0.25, "dial_retry_s": 0.1,
              "dial_retry_max_s": 0.5, "announce_ttl": 1.0}
# the late joiner's ready-probe retry: past the answer's transfer (the
# transport bursts every fragment and repairs the loss by RTO rounds),
# or the probe would fetch the whole answer again mid-transfer
UDP_JOIN_PROBE_RETRY_S = 30.0
# how long B's join may wait on an answer before a synced B that has
# applied nothing probes again (a join's answer lands in under 8 s),
# and the most re-probes that stall may take
UDP_REPROBE_S = 20.0
UDP_REPROBES_MAX = 2
# the replicas' client ids, clear of the trace's 1..1000
UDP_A, UDP_B, UDP_CANON = 5001, 5002, 5003
# bench.py's fleet-trace children: ops each, value bytes an op
UDP_FLEET_OPS, UDP_FLEET_VAL_BYTES = 10, 1024
UDP_FRAGMENT = 1200  # native/transport/transport.cc:588, FRAG_PAYLOAD


def _free_ports(n: int, *, udp: bool) -> list:
    """``n`` distinct free 127.0.0.1 ports (bind, read, release; the
    children bind them again)."""
    import socket

    socks, ports = [], []
    for _ in range(n):
        s = socket.socket(socket.AF_INET,
                          socket.SOCK_DGRAM if udp else socket.SOCK_STREAM)
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def udp_router(seed_byte: int, schedule=None, **kw):
    """A port ``UdpRouter`` with bench.py's fleet-trace knobs, a fixed
    identity, and ``schedule`` (by default bench.py's) at its seam.
    Returns the router and its faulty endpoint."""
    from crdt_tpu_torch.net import FaultSchedule, UdpRouter, install_faults

    r = UdpRouter(seed=bytes([seed_byte]) * 32, **{**UDP_ROUTER, **kw})
    return r, install_faults(r, schedule or FaultSchedule(UDP_SEED,
                                                          **UDP_FAULTS))


def pump_repair(routers, cond, repair, *, timeout_s: float) -> int:
    """``pump_until`` under faults: each second ``cond()`` does not
    hold, ``repair()`` runs. Returns how many times it ran."""
    from crdt_tpu_torch.net import pump_until

    deadline = time.monotonic() + timeout_s
    repairs = 0
    while True:
        try:
            pump_until(routers, cond, timeout_s=min(
                1.0, max(deadline - time.monotonic(), 0.01)))
            return repairs
        except TimeoutError:
            if time.monotonic() > deadline:
                raise
            repairs += 1
            repair()


def redial(routers, boot, topic=None, counts=None):
    """A repair: dial again where a one-shot message of a join was lost
    to the schedule (ROADMAP §C). Every router that hears no one yet,
    or has not proven ``boot``'s key, dials the rendezvous ``boot``
    (the bootstrap hello and the liveness challenge that makes ``boot``
    an introducer are each sent once, and only a router that proved it
    keeps its topic announcement fresh there; bench.py's children
    re-dial too). With ``topic``, every router also dials each direct
    peer whose announcement of ``topic`` it lacks (a re-dial makes both
    ends announce again). ``counts`` tallies the dials by kind."""
    counts = {} if counts is None else counts

    def dial(r, addr, kind: str) -> None:
        r.add_peer(*addr)
        counts[kind] = counts.get(kind, 0) + 1

    def run():
        for r in routers:
            if r is boot:
                continue
            if not r.peers or boot.public_key not in r._rendezvous_pks:
                dial(r, boot.addr, "rendezvous")
            if topic is None:
                continue
            for pk, p in list(r._peers.items()):
                if pk != boot.public_key and p.direct \
                        and topic not in p.topics:
                    dial(r, p.addr, "peer")
    return run


def anti_entropy(reps):
    """A repair: every replica runs one anti-entropy round and one
    ready probe (what the cadence of ``anti_entropy_s`` runs)."""
    def run():
        for r in reps:
            r.anti_entropy()
            r.probe()
    return run


def udp_endpoints(eps: dict, routers: dict) -> dict:
    """Each router's transport: failed and pending messages, the fault
    schedule's counts and the router's stats."""
    return {name: {"failed": ep.failed, "pending": ep.pending,
                   "faults": dict(ep.stats),
                   "router": {k: v for k, v in routers[name].stats.items()
                              if v}}
            for name, ep in eps.items()}


def udp_phase(torch, kernels, packed_mod, deleteset, blobs_of,
              device_results, hold_kernel, device: str = "cuda") -> dict:
    """Phase 12, replica sync over real, encrypted UDP on ``device``
    (:func:`udp_late_join`, :func:`udp_nat_relay`, :func:`udp_fleet`;
    the main path runs it on the card). Returns the kernel inputs of the
    late join's two call sites."""
    want = device_results["trace_1000x100"]
    out = udp_late_join(torch, kernels, packed_mod, deleteset,
                        blobs_of["trace_1000x100"], want.n_ops,
                        json.dumps(want.cache, sort_keys=True), hold_kernel,
                        device)
    udp_nat_relay(torch, kernels, device)
    udp_fleet(torch, device)
    return out


def udp_late_join(torch, kernels, packed_mod, deleteset, blobs, n_ops: int,
                  want_cache: str, hold_kernel, device: str = "cuda") -> dict:
    """Phase 12 (a): BASELINE #5 at its stated size over UDP.

    Three port routers on 127.0.0.1, each under bench.py's fleet-trace
    fault schedule: a rendezvous R that subscribes nothing; A, a
    resident replica on the card restarting from a ``LogPersistence``
    log of ``blobs`` (one device round, one ``stream_scatter`` launch);
    B, a device-merge replica on the card that knows only R and gets
    its first state from A through the fragmented, reliable, encrypted
    transport (one rebuild pass, one ``ds_mask`` launch). Both caches
    equal the cold device route; both then run phase 8's mixed op mix
    and end with equal ``state_digest``\\ s; one device round of A runs
    under ``torch_profile``. Returns the two call sites' inputs."""
    import tempfile

    from crdt_tpu_torch.api.doc import Crdt
    from crdt_tpu_torch.core import device_apply
    from crdt_tpu_torch.net import ypear_crdt
    from crdt_tpu_torch.obs import (PropagationLedger, Tracer,
                                    set_propagation, set_tracer,
                                    state_digest, torch_profile)
    from crdt_tpu_torch.storage import LogPersistence

    label = f"udp late join [{device}]"
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    tracer = set_tracer(Tracer(enabled=True))
    set_propagation(PropagationLedger())
    secs: dict = {}
    eps: dict = {}
    boot, eps["R"] = udp_router(1, rendezvous=True)
    ra, eps["A"] = udp_router(2, bootstrap=[boot.addr])
    rb, eps["B"] = udp_router(3, bootstrap=[boot.addr])
    routers = {"R": boot, "A": ra, "B": rb}

    def expect(what: str, **want) -> dict:
        counts = kernels.launch_counts()
        full = {name: 0 for name in counts}
        if on_card:
            full.update(want)
        if counts != full:
            raise AssertionError(f"{label}: {what} launched {counts}, "
                                 f"want {full}")
        return counts

    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/a.kvlog"
        log_ = LogPersistence(path)
        log_.store_updates("doc", blobs)
        log_.close()

        # ---- A restarts from its log: one device round
        a_seen: dict = {}
        sync()
        kernels.reset_launches()
        d0 = packed_mod.device_dispatch_count
        t0 = time.perf_counter()
        with capture_kernel_inputs(a_seen, (packed_mod, "stream_scatter")):
            a = ypear_crdt(ra, topic="doc", client_id=UDP_A,
                           merge_mode="resident", device=device,
                           persistence=LogPersistence(path))
        sync()
        secs["A restart"] = time.perf_counter() - t0
        expect("A's restart", stream_scatter=1)
        if on_card and packed_mod.device_dispatch_count - d0 != 1:
            raise AssertionError(f"{label}: A's restart took "
                                 f"{packed_mod.device_dispatch_count - d0}"
                                 " device rounds")
        if json.dumps(dict(a.c), sort_keys=True) != want_cache:
            raise AssertionError(f"{label}: A's c != the cold device route")
        # A has joined R when R lists A on the topic and A has proven
        # R's key: from then on A keeps its announcement fresh at R,
        # and R introduces A to whoever announces the topic next
        redials: dict = {}
        t0 = time.perf_counter()
        pump_repair([boot, ra], lambda: ra.public_key in boot.peers_on("doc")
                    and boot.public_key in ra._rendezvous_pks,
                    redial([ra], boot, "doc", redials), timeout_s=30.0)
        secs["A joins R"] = time.perf_counter() - t0

        # ---- B joins through R alone and gets A's state over UDP
        answers: list = []
        wire: list = []
        applies: list = []
        a_encode = a.doc.encode_state_as_update

        def timed_encode(sv=None):
            t = time.perf_counter()
            diff = a_encode(sv)
            answers.append({"s": time.perf_counter() - t,
                            "bytes": len(diff), "end": time.perf_counter(),
                            "head": diff[:256]})
            return diff

        raw_send = eps["A"]._inner.send

        def wire_send(ip, port, data):
            if len(data) > 8 * UDP_FRAGMENT:
                wire.append({"bytes": len(data), "kind": data[0],
                             "frame": data})
            return raw_send(ip, port, data)

        a.doc.encode_state_as_update = timed_encode
        eps["A"]._inner.send = wire_send
        passes: list = []
        rebuild = _rebuild_spy(device_apply, passes)
        b_seen: dict = {}
        sync()
        kernels.reset_launches()
        t_join = time.perf_counter()
        try:
            with capture_kernel_inputs(b_seen, (deleteset, "ds_mask")):
                b = ypear_crdt(rb, topic="doc", client_id=UDP_B,
                               merge_mode="device", device=device,
                               probe_retry_s=UDP_JOIN_PROBE_RETRY_S)
                # R and A stand still while B is built: R must not take
                # A for gone (past A's announce TTL) when B announces
                secs["B built"] = time.perf_counter() - t_join
                b_apply = b.doc.apply_updates

                def timed_apply(datas, origin="remote"):
                    t = time.perf_counter()
                    b_apply(datas, origin)
                    sync()
                    applies.append({"start": t, "s": time.perf_counter() - t,
                                    "bytes": sum(map(len, datas))})

                b.doc.apply_updates = timed_apply
                rejoin = redial([ra, rb], boot, "doc", redials)
                reprobes: list = []

                def join_repair():
                    rejoin()
                    # B built before it heard a peer takes itself for
                    # the solo first node and is synced with nothing
                    # (the reference's rule); when A joins, A's state
                    # reaches B only as its answers to the two
                    # peer_joined probes, and if the schedule drops
                    # them nothing retries a synced replica's probe
                    # (ROADMAP §C, pinned by tests/test_torch_udp.py::
                    # test_synced_joiner_that_loses_its_answers_stalls_
                    # until_probed). In just that stall (A answered, B
                    # synced and applied nothing, long after a join's
                    # answer would have landed) probe again, count it,
                    # and fail on a third: that is not this stall
                    now = time.perf_counter()
                    if b.synced and answers and not applies and now - max(
                            [t_join] + reprobes) > UDP_REPROBE_S:
                        if len(reprobes) == UDP_REPROBES_MAX:
                            raise AssertionError(
                                f"{label}: B's join lost A's answers "
                                f"after {len(reprobes)} re-probes")
                        reprobes.append(now)
                        log(f"{label}: B synced with nothing and A's "
                            f"{len(answers)} answer(s) lost: re-probe "
                            f"{len(reprobes)} at "
                            f"{now - t_join:.3f} s")
                        b.probe()

                try:
                    pump_repair(list(routers.values()),
                                lambda: b.synced
                                and b.state_vector() == a.state_vector(),
                                join_repair, timeout_s=120.0)
                except TimeoutError as e:
                    # what the next look at a stalled join needs, in the
                    # error itself (it reaches standard error)
                    raise TimeoutError(
                        f"{label}: B's join stalled: synced {b.synced}, "
                        f"A's answers {len(answers)}, B's applies "
                        f"{len(applies)}, re-dials {redials}; R lists "
                        f"{len(boot.peers_on('doc'))} on the topic, A "
                        f"{len(ra.peers_on('doc'))}, B "
                        f"{len(rb.peers_on('doc'))}; transport "
                        f"{json.dumps(udp_endpoints(eps, routers))}") from e
            sync()
        finally:
            device_apply._rebuild_kernel = rebuild
            del a.doc.encode_state_as_update
            eps["A"]._inner.send = raw_send
        secs["B join"] = time.perf_counter() - t_join
        del b.doc.apply_updates
        expect("B's join", ds_mask=1)
        if passes != [(n_ops, True, torch.device(device).type)]:
            raise AssertionError(f"{label}: B's join rebuilt {passes}")
        big = [w for w in wire if w["bytes"] >= answers[0]["bytes"]]
        if not big or any(w["kind"] != 1 for w in big) or any(
                ans["head"] in w["frame"] for ans in answers for w in big):
            raise AssertionError(f"{label}: A's answer did not leave as a "
                                 "sealed envelope")
        frags = [-(-w["bytes"] // UDP_FRAGMENT) for w in big]
        for name, rep in (("A", a), ("B", b)):
            if json.dumps(dict(rep.c), sort_keys=True) != want_cache:
                raise AssertionError(f"{label}: {name}'s c != the cold "
                                     "device route")
        first = applies[0]
        split = {"answer encode": answers[0]["s"],
                 "transfer": first["start"] - answers[0]["end"],
                 "rebuild": first["s"]}
        log(f"{label}: A restarted from a native log of {len(blobs)} "
            f"updates in {secs['A restart']:.3f} s (one device round, one "
            f"stream_scatter launch); B joined through R alone in "
            f"{secs['B join']:.3f} s: one rebuild pass over "
            f"{passes[0][0]} rows, one ds_mask launch; A's and B's c equal "
            "the cold device route")
        log(f"{label}: A's answers (encode s, diff bytes) "
            f"{json.dumps([[x['s'], x['bytes']] for x in answers])}; on the "
            f"wire (sealed envelope bytes, {UDP_FRAGMENT}-byte fragments) "
            f"{json.dumps([[w['bytes'], f] for w, f in zip(big, frags)])}; "
            f"B's applies (s, bytes) "
            f"{json.dumps([[x['s'], x['bytes']] for x in applies])}; join "
            f"split s {json.dumps(split)}")
        log(f"{label}: transport after the join "
            f"{json.dumps(udp_endpoints(eps, routers))}")

        # ---- both edit under the faults, then converge
        t0 = time.perf_counter()
        for n in range(4):
            mixed_ops(a, 0, 50, start=50 * n)
            mixed_ops(b, 1, 50, start=50 * n)
            for _ in range(20):
                for r in routers.values():
                    r.poll()
        repairs = pump_repair(list(routers.values()),
                              lambda: a.state_vector() == b.state_vector()
                              and a.state_vector().get(UDP_B) >= 200
                              and b.state_vector().get(UDP_A) >= 200,
                              anti_entropy([a, b]), timeout_s=60.0)
        secs["edits"] = time.perf_counter() - t0

        def digests() -> tuple:
            """A's and B's ``state_digest``: B's own, and A's through a
            fresh device-merge document fed A's full state (a resident
            document's full state leaves out the tombstones of
            overwritten map entries, as the reference's does, so its own
            bytes differ from an engine's for the same document)."""
            canon = Crdt(UDP_CANON, device_merge=True, device=device)
            canon.apply_updates([a.encode_state_as_update()])
            return state_digest(canon), state_digest(b.doc)

        t0 = time.perf_counter()
        da, db = digests()
        secs["digests"] = time.perf_counter() - t0
        if da != db or dict(a.c) != dict(b.c):
            raise AssertionError(f"{label}: A and B diverged after edits "
                                 f"({da} != {db})")

        # ---- one device round of A under torch_profile
        replay = a.doc._replay
        replay.device_min_rows = 1
        prof_dir = f"{tmp}/profile"
        profiled: list = []
        a_apply = a.doc.apply_updates

        def profiled_apply(datas, origin="remote"):
            # under duplication and delay a batch A applies may hold
            # nothing new: profile each apply, into a directory of its
            # own, until one dispatches
            if profiled and profiled[-1]:
                return a_apply(datas, origin)
            with torch_profile(f"{prof_dir}/{len(profiled)}"):
                r0 = packed_mod.device_dispatch_count
                a_apply(datas, origin)
                sync()
            profiled.append(packed_mod.device_dispatch_count - r0)

        a.doc.apply_updates = profiled_apply
        try:
            mixed_ops(b, 1, 5, start=200)
            pump_repair(list(routers.values()),
                        lambda: a.state_vector() == b.state_vector(),
                        anti_entropy([a, b]), timeout_s=30.0)
        finally:
            del a.doc.apply_updates
            replay.device_min_rows = None
        traces = sorted(Path(prof_dir, str(len(profiled) - 1)).glob(
            "*.pt.trace.json"))
        if not profiled or profiled[-1] != 1 or len(traces) != 1:
            raise AssertionError(f"{label}: profiled rounds {profiled}, "
                                 f"traces {traces}")
        events = json.loads(traces[0].read_text())["traceEvents"]
        names = {e.get("name") for e in events}
        ranges = ("crdt.incremental.dispatch", "crdt.incremental.readback")
        if not set(ranges) <= names:
            raise AssertionError(f"{label}: the trace lacks {ranges}")
        kernel_events = sum(1 for e in events if e.get("cat") == "kernel")
        if digests()[0] != state_digest(b.doc) or dict(a.c) != dict(b.c):
            raise AssertionError(f"{label}: A and B diverged after the "
                                 "profiled round")
        log(f"{label}: both edited 200 ops (mixed) under the faults and "
            f"converged to one state_digest {da} in {secs['edits']:.3f} s "
            f"({repairs} repair rounds; A's own resident bytes "
            f"{state_digest(a.doc)}); one device round of A under "
            f"torch_profile: {traces[0].stat().st_size} bytes of trace with "
            f"{', '.join(ranges)}; {kernel_events} kernel events (not "
            "asserted: the profiler may lose device activities)")
        log(f"{label}: transport at the end "
            f"{json.dumps(udp_endpoints(eps, routers))}; seconds "
            f"{json.dumps(secs)}")
        counters = {k: v for k, v in tracer.report()["counters"].items()
                    if k.startswith("device.")}
        if any(counters.values()):
            raise AssertionError(f"{label}: the failure ladder ran: "
                                 f"{counters}")
        for r in routers.values():
            r.close()
        set_tracer(Tracer(enabled=False))
    if not on_card:
        return {"join_reprobes": len(reprobes), "join_redials": redials}
    for args in a_seen["stream_scatter"]:
        hold_kernel("stream_scatter", *args)
    for args in b_seen["ds_mask"]:
        hold_kernel("ds_mask", *args)
    scatter = [[int(p.shape[0]), n] for p, n in a_seen["stream_scatter"]]
    mask = [[int(x[0].shape[0]), int(x[3].shape[0])]
            for x in b_seen["ds_mask"]]
    log(f"{label}: stream_scatter (B, n_out) {scatter} and ds_mask (N, D) "
        f"{mask} == plain on the run's own inputs")
    return {"stream_scatter": a_seen["stream_scatter"],
            "ds_mask": b_seen["ds_mask"], "join_reprobes": len(reprobes),
            "join_redials": redials}


def udp_nat_relay(torch, kernels, device: str = "cuda") -> None:
    """Phase 12 (b): two resident replicas on the card behind symmetric
    NATs in a ``NatFabric`` with port prediction off, so they converge
    only through the rendezvous relay (the reference's
    ``TestRelayFallback::test_converges_via_relay_with_prediction_disabled``
    setup). A's rounds all run on the card; one of them runs under a
    ``DeviceFaultPlan(fail_attempts=2)``: the ladder retries, then takes
    the host rung, and A still ends equal to the unfaulted B; the relayed
    leg shows in the propagation ledger."""
    from crdt_tpu_torch.guard import DeviceFaultPlan
    from crdt_tpu_torch.net import (NatFabric, SymmetricNat, UdpRouter,
                                    install_nat, pump_until, ypear_crdt)
    from crdt_tpu_torch.obs import (PropagationLedger, Tracer,
                                    get_propagation, set_propagation,
                                    set_tracer, state_digest)

    label = f"udp NAT relay [{device}]"
    tracer = set_tracer(Tracer(enabled=True))
    set_propagation(PropagationLedger())
    fabric = NatFabric()
    boot = UdpRouter(rendezvous=True)
    install_nat(boot, fabric)
    kw = {"bootstrap": [boot.addr], "dial_retry_s": 0.05,
          "port_prediction": False, "relay_after_s": 0.3}
    ra, rb = UdpRouter(**kw), UdpRouter(**kw)
    install_nat(ra, fabric, SymmetricNat(21000))
    install_nat(rb, fabric, SymmetricNat(23000))
    routers = [boot, ra, rb]
    t0 = time.perf_counter()
    a = ypear_crdt(ra, topic="room", client_id=1, merge_mode="resident",
                   device=device, device_min_rows=1, probe_retry_s=0.1,
                   anti_entropy_s=0.2)
    b = ypear_crdt(rb, topic="room", client_id=2, merge_mode="resident",
                   device=device, probe_retry_s=0.1, anti_entropy_s=0.2)

    def both_hold(n: int):
        return lambda: (a.state_vector().get(2) >= n
                        and b.state_vector().get(1) >= 20
                        and a.state_vector() == b.state_vector())

    mixed_ops(a, 0, 20)
    mixed_ops(b, 1, 20)
    pump_until(routers, both_hold(20), timeout_s=30.0)
    pa = ra._peers[rb.public_key]
    if pa.direct or pa.relay != boot.public_key or \
            not boot.stats["relay_frames_forwarded"]:
        raise AssertionError(f"{label}: not relayed (direct {pa.direct}, "
                             f"relay {pa.relay}, stats {boot.stats})")
    scatter0 = kernels.launch_counts()["stream_scatter"]
    with DeviceFaultPlan(fail_attempts=2) as plan:
        mixed_ops(b, 1, 10, start=20)
        pump_until(routers, both_hold(30), timeout_s=30.0)
    mixed_ops(b, 1, 10, start=30)
    mixed_ops(a, 0, 10, start=20)
    pump_until(routers, lambda: both_hold(40)()
               and a.state_vector().get(1) >= 30, timeout_s=30.0)
    wall = time.perf_counter() - t0
    counters = tracer.counters("device.")
    routes = get_propagation().report()["hop_lag_by_route"]
    set_tracer(Tracer(enabled=False))
    if plan.fired != 2 or counters.get("device.retries", 0) < 1 or \
            counters.get('device.fallback_by{route="host"}', 0) < 1:
        raise AssertionError(f"{label}: plan fired {plan.fired}, ladder "
                             f"{counters}")
    if state_digest(a.doc) != state_digest(b.doc) or dict(a.c) != dict(b.c):
        raise AssertionError(f"{label}: the faulted A != the unfaulted B")
    if "relayed" not in routes:
        raise AssertionError(f"{label}: no relayed leg in the ledger: "
                             f"{sorted(routes)}")
    scatters = kernels.launch_counts()["stream_scatter"] - scatter0
    log(f"{label}: A and B converged through the rendezvous relay "
        f"({boot.stats['relay_frames_forwarded']} frames, "
        f"{boot.stats['relay_bytes_forwarded']} bytes forwarded) in "
        f"{wall:.3f} s; a DeviceFaultPlan(fail_attempts=2) round climbed "
        f"the ladder {json.dumps(counters)}; A's later device rounds "
        f"launched stream_scatter {scatters} times; A == B "
        f"(state_digest {state_digest(a.doc)}); ledger routes "
        f"{json.dumps({r: h['count'] for r, h in routes.items()})}")
    for r in routers:
        r.close()


def udp_fleet(torch, device: str = "cuda") -> None:
    """Phase 12 (c): bench.py's ``--fleet-trace`` leg on the card: three
    OS processes (this script again, ``--udp-child``), each a resident
    port replica on the card over a ``UdpRouter`` under the schedule,
    children 1 and 2 permanently partitioned (relay-forced), each
    serving an ``ObsHTTPServer``. A ``FleetCollector`` here scrapes
    them live and holds bench.py's acceptance (bench.py:3463-3508)."""
    import os
    import subprocess
    import tempfile

    from crdt_tpu_torch.obs import FleetCollector

    label = f"udp fleet [{device}]"
    n_procs = 3
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as outdir:
        ports = _free_ports(n_procs, udp=True)
        obs_ports = _free_ports(n_procs, udp=False)
        procs = []
        logs = []
        try:
            for idx in range(n_procs):
                cfg = {"idx": idx, "seed": UDP_SEED, "ports": ports,
                       "obs_ports": obs_ports, "outdir": outdir,
                       "ops": UDP_FLEET_OPS,
                       "val_bytes": UDP_FLEET_VAL_BYTES, "device": device}
                out = open(os.path.join(outdir, f"child_{idx}.log"), "w")
                logs.append(out)
                procs.append(subprocess.Popen(
                    [sys.executable, str(ROOT / "chip_smoke.py"),
                     "--udp-child", json.dumps(cfg)],
                    cwd=ROOT, stdout=out, stderr=subprocess.STDOUT))
            done_paths = [os.path.join(outdir, f"done_{i}.json")
                          for i in range(n_procs)]
            deadline = time.monotonic() + 150.0
            while time.monotonic() < deadline and not all(
                    os.path.exists(p) for p in done_paths):
                if any(p.poll() not in (None, 0) for p in procs):
                    break
                time.sleep(0.05)
            missing = [p for p in done_paths if not os.path.exists(p)]
            if missing:
                for out in logs:
                    out.flush()
                tails = [Path(out.name).read_text()[-1500:] for out in logs]
                raise AssertionError(f"{label}: children incomplete "
                                     f"{missing}, rc "
                                     f"{[p.poll() for p in procs]}, logs "
                                     f"{tails}")
            t_done = time.perf_counter()
            # every child is done: they stop handling traffic, so no
            # frame is recorded between one child's scrape and the next
            # (a receive scraped after its origin's scrape would not
            # pair); they go on serving their obs surfaces
            with open(os.path.join(outdir, "quiet"), "w") as f:
                f.write("done")
            time.sleep(0.2)
            col = FleetCollector(events_limit=16384)
            for idx in range(n_procs):
                col.add_proc(f"p{idx}", f"http://127.0.0.1:{obs_ports[idx]}")
            ok = col.scrape()
            if not all(ok.values()):
                raise AssertionError(f"{label}: live scrape failed: {ok}")
            report = col.fleet_report()
            merged = col.merged_perfetto()
        finally:
            with open(os.path.join(outdir, "stop"), "w") as f:
                f.write("done")
            for p in procs:
                try:
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
            for out in logs:
                out.close()
        rcs = [p.returncode for p in procs]
        dones = [json.loads(Path(p).read_text()) for p in done_paths]
        child_logs = [Path(out.name).read_text()[-600:] for out in logs]

    # bench.py's acceptance, and every child on the card
    if rcs != [0] * n_procs:
        raise AssertionError(f"{label}: children exited {rcs}: {child_logs}")
    digests = {d["digest"] for d in dones}
    paths = report["paths"]
    routes = set(paths["routes"])
    ctx_bytes = sum(d["ledger"]["context_bytes"] for d in dones)
    upd_bytes = sum(d["ledger"]["traced_update_bytes"] for d in dones)
    overhead = ctx_bytes / upd_bytes if upd_bytes else 0.0
    relay_forwards = sum(d["relay"].get("relay_frames_forwarded", 0)
                         for d in dones)
    pids = {e.get("pid") for e in merged["traceEvents"]
            if isinstance(e, dict)}
    advice = report.get("advice") or []
    checks = {
        "one digest": len(digests) == 1,
        "traced": paths["traced_recvs"] > 0,
        "pair_rate == 1.0": paths["pair_rate"] == 1.0,
        "routes": {"direct", "relayed", "sync_answer",
                   "anti_entropy"} <= routes,
        "origin procs": sorted(paths["origin_procs"]) == ["p0", "p1", "p2"],
        "overhead < 5%": overhead < 0.05,
        "relayed frames": relay_forwards > 0,
        "three pids": len(pids) >= n_procs,
        "advice": any(a.get("proc") == "p1"
                      and a.get("action") == "rebalance_away"
                      for a in advice),
        "on the device": all(
            d["device"] == device
            and (d["launches"]["stream_scatter"] > 0) == (device == "cuda")
            for d in dones),
    }
    log(f"{label}: {n_procs} children converged and were scraped live in "
        f"{t_done - t_start:.3f} s (the whole leg "
        f"{time.perf_counter() - t_start:.3f} s): digests {sorted(digests)}, "
        f"pair_rate {paths['pair_rate']} over {paths['traced_recvs']} traced "
        f"receives, routes {json.dumps(paths['routes'])}, context overhead "
        f"{overhead:.5f}, relay frames {relay_forwards}, Perfetto pids "
        f"{sorted(p for p in pids if isinstance(p, int))}, advice rows "
        f"{len(advice)}; children's kernel launches "
        f"{json.dumps([d['launches'] for d in dones])}, transports "
        f"{json.dumps([d['transport'] for d in dones])}")
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"{label}: acceptance failed: {failed}; "
                             "first incomplete paths "
                             f"{json.dumps(paths.get('incomplete'))}")


def rehearse_udp(joins: int, legs: int, device: str) -> int:
    """``--rehearse-udp``: phase 12's late join ``joins`` times and its
    fleet leg ``legs`` times on ``device``; one JSON line of outcomes."""
    import traceback

    sys.path.insert(0, str(ROOT))
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        return fail("--rehearse-udp cuda: no CUDA card")
    from crdt_tpu_torch.models import replay as rp
    from crdt_tpu_torch.models import traces
    from crdt_tpu_torch.net import transport
    from crdt_tpu_torch.ops import deleteset, kernels
    from crdt_tpu_torch.ops import packed as packed_mod

    transport.random_bytes(1)
    blobs = traces.build_trace(1000, 100, seed=0)
    want = rp.replay_trace(blobs, device=device)
    runs = []
    for kind in ["join"] * joins + ["leg"] * legs:
        t0 = time.perf_counter()
        run = {"kind": kind}
        try:
            if kind == "join":
                out = udp_late_join(
                    torch, kernels, packed_mod, deleteset, blobs,
                    want.n_ops, json.dumps(want.cache, sort_keys=True),
                    lambda *args: None, device)
                run.update(reprobes=out["join_reprobes"],
                           redials=out["join_redials"])
            else:
                udp_fleet(torch, device)
            run["ok"] = True
        except Exception as e:  # a rehearsal counts each failure
            traceback.print_exc()
            run.update(ok=False, error=f"{type(e).__name__}: {e}"[:2000])
        run["s"] = time.perf_counter() - t0
        runs.append(run)
    print(json.dumps({"device": device, "runs": runs}), flush=True)
    return 0 if all(r["ok"] for r in runs) else 1


def udp_child(arg: str) -> int:
    """One child of :func:`udp_fleet` (bench.py:3148-3344,
    ``fleet_trace_child``, on the port): a resident replica on
    ``cfg["device"]`` (the parent asks for the card) over a
    ``UdpRouter`` under the schedule, tracing and recording on, serving
    its obs surfaces over HTTP while it edits and converges; children 1
    and 2 never hear each other directly. Writes ``done_<idx>.json`` and
    stays scrapeable until the parent's stop file appears."""
    import os

    import numpy as np

    cfg = json.loads(arg)
    sys.path.insert(0, str(ROOT))
    import torch

    idx = int(cfg["idx"])
    if cfg["device"] == "cuda" and not torch.cuda.is_available():
        print(json.dumps({"child": idx, "error": "no card"}),
              file=sys.stderr)
        return 2
    ports = cfg["ports"]
    outdir = cfg["outdir"]
    n_ops = int(cfg["ops"])
    val_bytes = int(cfg["val_bytes"])

    from crdt_tpu_torch.net import (FaultSchedule, Partition, Replica,
                                    install_faults)
    from crdt_tpu_torch.obs import (Controller, FlightRecorder,
                                    ObsHTTPServer, PropagationLedger,
                                    TickTimeline, Tracer, get_propagation,
                                    get_recorder, get_timeline,
                                    set_propagation, set_recorder,
                                    set_timeline, set_tracer, state_digest)
    from crdt_tpu_torch.ops import kernels

    tracer = set_tracer(Tracer(enabled=True))
    set_recorder(FlightRecorder(enabled=True, capacity=16384))
    set_propagation(PropagationLedger())
    set_timeline(TickTimeline(enabled=True))
    part = None
    if idx in (1, 2):
        part = Partition({int(ports[1])}, {int(ports[2])})
    router, ep = udp_router(
        int(cfg["seed"]) % 200 + 1 + idx, FaultSchedule(
            int(cfg["seed"]), **UDP_FAULTS, partition=part),
        port=int(ports[idx]), rendezvous=idx == 0,
        bootstrap=[] if idx == 0 else [("127.0.0.1", int(ports[0]))])
    rep = Replica(router, topic="fleet", client_id=101 + idx,
                  anti_entropy_s=0.2, batch_incoming=True,
                  merge_mode="resident", device=cfg["device"],
                  device_min_rows=1)
    ctrl = None
    if idx == 1:
        # child 1's control plane: a synthetic flood squeezes a budget,
        # whose advice row the parent's collector must see
        ctrl = Controller(cooldown_ticks=2)
        for ct in range(4):
            ctrl.observe({
                "tick": ct,
                "budget": {"max_bytes": 2048, "max_updates": 4},
                "tenants": {"flood!": {"burn": 1.0, "shed": 8 * (ct + 1),
                                       "pending_bytes": 4096}},
            })
    obs = ObsHTTPServer(port=int(cfg["obs_ports"][idx]),
                        snapshot_extra=lambda: {
                            "propagation": get_propagation().report()},
                        control=ctrl).start()

    def pump_for(seconds: float) -> None:
        deadline = time.monotonic() + seconds
        while time.monotonic() < deadline:
            router.poll()
            time.sleep(0.002)

    # join: both other peers on the topic, synced; each second a
    # one-shot join message lost to the schedule is dialed again (see
    # :func:`redial`): the rendezvous until the router has proven its
    # key, and each direct peer whose topic announcement is missing
    deadline = time.monotonic() + 60.0
    next_redial = time.monotonic() + 1.0
    while len(router.peers_on("fleet")) < 2 or not rep.synced:
        if time.monotonic() > deadline:
            print(json.dumps({"child": idx, "error": "join timeout",
                              "peers": router.peers_on("fleet")}),
                  file=sys.stderr)
            return 3
        router.poll()
        if idx and time.monotonic() >= next_redial:
            if not router.peers or not router._rendezvous_pks:
                router.add_peer("127.0.0.1", int(ports[0]))
            for p in list(router._peers.values()):
                if p.direct and "fleet" not in p.topics:
                    router.add_peer(*p.addr)
            next_redial = time.monotonic() + 1.0
        time.sleep(0.002)

    # seeded edits, one tick-timeline record an op window
    rng = np.random.default_rng(int(cfg["seed"]) * 31 + idx)
    tl = get_timeline()
    for j in range(n_ops):
        tl.tick_begin(j, label=f"ops[{idx}]")
        with tl.phase("edit"):
            rep.set("m", f"{idx}:{j}", "".join(
                chr(97 + int(c)) for c in rng.integers(0, 26, val_bytes)))
        with tl.phase("pump"):
            pump_for(0.02)
        tl.tick_end()

    # converge: every child's ops visible here
    cids = [101, 102, 103]
    deadline = time.monotonic() + 90.0
    while not all(rep.doc.state_vector().get(c) >= n_ops for c in cids):
        if time.monotonic() > deadline:
            print(json.dumps({"child": idx, "error": "converge timeout",
                              "sv": {c: rep.doc.state_vector().get(c)
                                     for c in cids}}), file=sys.stderr)
            return 4
        router.poll()
        time.sleep(0.002)
    # settle: stop originating repair frames, drain what is in flight
    rep._next_ae_at = None
    rep._resync_at = None
    pump_for(0.5)
    rep.flush_incoming()
    if cfg["device"] == "cuda":
        torch.cuda.synchronize()
    get_recorder().dump_jsonl(os.path.join(outdir, f"dump_{idx}.jsonl"))
    done = {
        "idx": idx,
        "digest": state_digest(rep.doc),
        "ledger": get_propagation().report(),
        "relay": {k: v for k, v in router.stats.items()
                  if k.startswith("relay")},
        "counters": tracer.report()["counters"],
        "device": rep.doc._replay.device.type,
        "launches": kernels.launch_counts(),
        "transport": {"failed": ep.failed, "pending": ep.pending,
                      "faults": dict(ep.stats)},
    }
    done_path = os.path.join(outdir, f"done_{idx}.json")
    with open(done_path + ".tmp", "w") as f:
        json.dump(done, f)
    os.replace(done_path + ".tmp", done_path)

    # stay scrapeable until the parent's stop file, then exit clean;
    # keep relaying for the children still converging until the parent's
    # quiet file (every child done)
    stop = os.path.join(outdir, "stop")
    quiet = os.path.join(outdir, "quiet")
    deadline = time.monotonic() + 90.0
    while not os.path.exists(stop) and time.monotonic() < deadline:
        if not os.path.exists(quiet):
            router.poll()
        time.sleep(0.01)
    obs.stop()
    router.close()
    return 0


# ---------------------------------------------------------------------------
# phase 13: the fleet control plane
# ---------------------------------------------------------------------------

# bench.py's --rebalance leg (bench.py:2207-2553) at its defaults:
# BENCH_RB_SEED, BENCH_RB_FLOOD_TICKS, BENCH_RB_SUSTAIN_TICKS,
# BENCH_RB_HYSTERESIS and BENCH_RB_RECOVERY_BUDGET
RB_SEED, RB_FLOOD_TICKS, RB_SUSTAIN_TICKS = 7, 8, 28
RB_HYSTERESIS, RB_RECOVERY_BUDGET = 10, 20
FLEET_MEMBERS = ["a", "b", "c"]
# the leg's handoff chaos, which every fleet of phase 13 runs under:
# every migration ack on c->a dropped (the source completes through the
# fenced probe), every commit on a->c duplicated (the destination
# re-acks idempotently)
HANDOFF_WINDOWS = (
    {"src": "c", "dst": "a", "kinds": ("ack",), "mode": "drop"},
    {"src": "a", "dst": "c", "kinds": ("commit",), "mode": "dup"},
)


def rebalance_leg(device: str = "cuda", *, seed: int = RB_SEED,
                  flood_ticks: int = RB_FLOOD_TICKS,
                  sustain_ticks: int = RB_SUSTAIN_TICKS,
                  warmup: bool = True) -> dict:
    """``bench.py --rebalance``'s leg (``rebalance_leg``) on the port,
    every node's server on ``device``: three fleet nodes on a
    ``MemFabric`` under :data:`HANDOFF_WINDOWS`, one flooding tenant
    beside small steady neighbours, identical submissions and static
    per-tenant budgets twice. OFF: the in-process controllers' squeeze
    alone. ON: a ``PlacementLoop`` consumes the controllers'
    ``rebalance_away`` advice, mangled by a seeded
    ``DuplicateAdviceSchedule``, and live-migrates the flooder; the
    identity doc "y" is live-migrated a->c mid-stream, then "a" is
    killed cold and revived from its snapshot store. A per-tick sweep
    over every doc and process counts double serves, and the identity
    doc and the steady neighbours must be byte-identical across ON and
    OFF. Returns bench.py's result dict, key for key."""
    import os
    import tempfile

    from crdt_tpu_torch.codec import v1
    from crdt_tpu_torch.core.ids import DeleteSet
    from crdt_tpu_torch.core.records import ItemRecord
    from crdt_tpu_torch.fleet import FleetNode, MemFabric, PlacementLoop
    from crdt_tpu_torch.models.traces import _SteadyStream
    from crdt_tpu_torch.net.faults import (DuplicateAdviceSchedule,
                                           HandoffFaultSchedule)
    from crdt_tpu_torch.obs import Tracer, set_tracer
    from crdt_tpu_torch.obs.control import Controller
    from crdt_tpu_torch.obs.slo import SLOLedger
    from crdt_tpu_torch.storage.snapshot import SnapshotStore, encode_engine

    settle_ticks = 8
    budget_bytes, budget_updates = 2048, 4
    burn_window = 16
    recover_lo = 0.25
    members = FLEET_MEMBERS
    flooder = "doc"        # ring arc: a
    ident = "y"            # ring arc: a, the migrated identity doc
    steady = ["w", "tenant-0"]   # ring arcs: b, c, never moved
    docs = [flooder, ident] + steady

    def flood_blob(i: int) -> bytes:
        # an independent single-record update: 4 fit the static byte
        # budget, and the squeezed cap of 1 update a tick sheds one of
        # every sustain pair
        return v1.encode_update([ItemRecord(
            client=10_000 + i, clock=0, parent_root="m",
            key=f"f{i}", content="f" * 400,
        )], DeleteSet())

    blob_len = len(flood_blob(0))
    assert budget_updates * blob_len <= budget_bytes, \
        "rebalance: a full update-cap tick must fit the byte budget"
    assert 2 * blob_len > budget_bytes // 4, \
        "rebalance: a sustain pair must breach the squeezed budget"

    def run(on: bool) -> dict:
        tracer = set_tracer(Tracer(enabled=True))
        tmp = tempfile.TemporaryDirectory()
        chaos = HandoffFaultSchedule(seed, windows=HANDOFF_WINDOWS)
        fab = MemFabric(faults=chaos)
        dead: set = set()
        nodes: dict = {}
        ctrls: dict = {}
        stores: dict = {}

        def make_hint(p):
            # never advise a process that squeezes the tenant or a dead
            # one
            def hint(t):
                excl = [p] + [q for q in members
                              if q in dead
                              or str(t) in {str(k) for k in
                                            ctrls[q].overrides()}]
                loads = {q: nodes[q].load() for q in members
                         if q not in dead}
                return nodes[p].ring.least_loaded_successor(
                    str(t), exclude=excl, loads=loads)
            return hint

        def build_node(p):
            ctrl = Controller(cooldown_ticks=4, restore_after=2)
            node = FleetNode(
                p, members, fab, store=stores[p],
                timeout_ticks=3, beacon_every=4,
                server_kw=dict(
                    tenant_max_pending_bytes=budget_bytes,
                    tenant_max_pending_updates=budget_updates,
                    slo_ms=1e9,   # sheds drive burn, never clocks
                    control=ctrl,
                ), device=device)
            node.server.slo = SLOLedger(1e9, burn_window=burn_window)
            ctrl.placement_hint = make_hint(p)
            nodes[p], ctrls[p] = node, ctrl
            return node

        for p in members:
            stores[p] = SnapshotStore(os.path.join(tmp.name, p))
            build_node(p)
        ring = nodes["a"].ring
        adv_chaos = DuplicateAdviceSchedule(seed, duplicate=0.5,
                                            replay=0.5)
        loop = PlacementLoop(
            ring, lambda p: None if p in dead else nodes.get(p),
            hysteresis=RB_HYSTERESIS, budget_per_tick=1) if on else None

        streams = {d: _SteadyStream(1 + i)
                   for i, d in enumerate([ident] + steady)}
        lost = {d: 0 for d in docs}

        def submit(doc, blob):
            # redirect-chasing client: each live process in order;
            # exactly one accepts, or (only for the flooder) the update
            # is lost for the tick
            for p in members:
                if p in dead:
                    continue
                r, _info = nodes[p].submit(doc, blob)
                if r in ("ok", "buffered"):
                    return r
            lost[doc] += 1
            return "lost"

        def flood_owner():
            for p in members:
                if p not in dead and nodes[p].lease.holds(flooder) \
                        and not nodes[p].migrator.migrating(flooder):
                    return p
            return None

        total = flood_ticks + sustain_ticks
        t_ident = flood_ticks + 2
        t_kill = total - 6
        t_revive = t_kill + 2
        nblob = 0
        recovery = None
        burn_flood_end = None
        burn_last = None
        double_serves = 0
        tail_restores = 0
        for t in range(total + settle_ticks):
            if t < total:
                for _ in range(10 if t < flood_ticks else 2):
                    submit(flooder, flood_blob(nblob))
                    nblob += 1
                for d in [ident] + steady:
                    assert submit(d, streams[d].delta(4)) != "lost", \
                        f"rebalance: steady update lost for {d}"
            if on:
                if t == t_ident:
                    assert nodes["a"].migrate(ident, "c"), \
                        "rebalance: identity migration refused"
                if t == t_kill - 1:
                    nodes["a"].checkpoint()
                if t == t_kill:
                    fab.kill("a")
                    dead.add("a")
                if t == t_revive:
                    dead.discard("a")
                    node = build_node("a")
                    fab.revive("a", node)
                    before = tracer.counters().get(
                        "migration.tail_restores", 0)
                    node.restore()
                    tail_restores += tracer.counters().get(
                        "migration.tail_restores", 0) - before
            for p in members:
                if p not in dead:
                    nodes[p].tick()
            if on:
                rows = [dict(r, proc=p)
                        for p in members if p not in dead
                        for r in ctrls[p].advice()]
                loop.observe(t, adv_chaos.mangle(t, rows))
            # the fork guard sweep: more than one server is a fork
            for d in docs:
                n_serving = sum(
                    1 for p in members
                    if p not in dead and nodes[p].digest(d) is not None)
                if n_serving > 1:
                    double_serves += 1
            owner = flood_owner()
            burn = None
            if owner is not None:
                burn = nodes[owner].server.slo.report()[
                    "tenants"].get(flooder, {}).get("burn_rate")
            if burn is not None:
                burn_last = burn
            if t == flood_ticks - 1:
                burn_flood_end = burn
            if (recovery is None and t >= flood_ticks
                    and burn is not None and burn <= recover_lo):
                recovery = t - flood_ticks + 1
        # re-warm the identity doc so both legs compare a resident engine
        assert submit(ident, streams[ident].delta(2)) == "ok"
        for p in members:
            if p not in dead:
                nodes[p].tick()
        serving_ident = [p for p in members if p not in dead
                         and nodes[p].digest(ident) is not None]
        assert len(serving_ident) == 1, \
            f"rebalance: identity doc served by {serving_ident}"
        out = {
            "nodes": nodes, "loop": loop, "fab": fab,
            "adv_chaos": adv_chaos, "counters": dict(tracer.counters()),
            "recovery": recovery, "burn_flood_end": burn_flood_end,
            "burn_last": burn_last, "double_serves": double_serves,
            "lost": lost, "tail_restores": tail_restores,
            "ident_proc": serving_ident[0], "tmp": tmp,
        }
        set_tracer(Tracer(enabled=False))
        return out

    if warmup:
        run(True)["tmp"].cleanup()
    on = run(True)
    off = run(False)

    def ident_state(leg):
        srv = leg["nodes"][leg["ident_proc"]].server
        eng = srv._docs[ident].resident
        assert eng is not None, "rebalance: identity doc went cold"
        return {"digest": srv.digest(ident), "sv": eng.state_vector().clocks,
                "update": eng.encode_state_as_update(),
                "snapshot": encode_engine(eng, seq=0)}

    s_on, s_off = ident_state(on), ident_state(off)
    identical = {
        "ident_digest": s_on["digest"] == s_off["digest"],
        "ident_sv": s_on["sv"] == s_off["sv"],
        "ident_update": s_on["update"] == s_off["update"],
        "ident_snapshot": s_on["snapshot"] == s_off["snapshot"],
    }
    for d in steady:
        a = [on["nodes"][p].digest(d) for p in members
             if on["nodes"][p].digest(d) is not None]
        b = [off["nodes"][p].digest(d) for p in members
             if off["nodes"][p].digest(d) is not None]
        identical[f"steady_{d}"] = bool(a) and a == b
    on["tmp"].cleanup()
    off["tmp"].cleanup()
    c_on = on["counters"]

    def csum(name: str) -> int:
        return sum(v for k, v in c_on.items()
                   if k == name or k.startswith(name + "{"))

    hops = [r for r in on["loop"].ledger.rows()
            if r.get("action") == "migrate"]
    return {
        "seed": seed,
        "flood_ticks": flood_ticks,
        "sustain_ticks": sustain_ticks,
        "recovery_ticks": on["recovery"],
        "recovery_ticks_off": off["recovery"],
        "recovery_budget_ticks": RB_RECOVERY_BUDGET,
        "burn_flood_end": on["burn_flood_end"],
        "burn_end_off": off["burn_last"],
        "migrations": on["loop"].migrations,
        "hops": [{"src": r["src"], "dst": r["dst"], "tick": r["tick"]}
                 for r in hops],
        "migrations_completed": csum("migration.completed"),
        "migration_recoveries": csum("migration.recovery"),
        "recoveries_by_step": {
            k.split('step="', 1)[1].rstrip('"}'): v
            for k, v in c_on.items() if k.startswith('migration.recovery{')},
        "fence_rejects": csum("fleet.fence_rejects"),
        "fork_refused": csum("fleet.fork_refused"),
        "forks": on["double_serves"] + off["double_serves"],
        "double_serves": on["double_serves"],
        "tail_blobs": csum("migration.tail_blobs"),
        "tail_restores": on["tail_restores"],
        "advice_dups": on["loop"].dup_drops,
        "advice_injected": on["adv_chaos"].injected,
        "ledger_rows": on["loop"].ledger.total,
        "frames_sent": on["fab"].sent,
        "frames_dropped": on["fab"].dropped,
        "frames_duplicated": on["fab"].duplicated,
        "lost_flood_updates": on["lost"][flooder],
        "identical": identical,
        "all_identical": all(identical.values()),
    }


# phase 13 (b): the BASELINE #5 tenant beside phase 10's, its name (ring
# arc b), and the ticks that follow the handoffs' completion
FLEET_BIG = "baseline5"
FLEET_TICKS_AFTER = 2
# the longest a handoff may take under HANDOFF_WINDOWS, in fleet ticks
FLEET_HANDOFF_TICKS = 16


def big_delta(traces, t: int) -> bytes:
    """The BASELINE #5 tenant's delta of fleet tick ``t``: ``WARM_DELTA``
    ops of a fresh writer (map sets and own-chain list appends over the
    trace's roots, clients clear of its 1..1000)."""
    return traces.build_trace(1, WARM_DELTA, seed=1000 + t,
                              client_base=5000 + t)[0]


def fleet_phase(torch, kernels, packed_mod, traces, hold_kernel,
                tenants: dict, big_blobs, big_cache: str,
                device: str = "cuda") -> dict:
    """Phase 13 (b): the fleet at real size, every node's server on
    ``device``.

    Three fleet nodes ("a", "b", "c", ``vnodes=64``) share one
    ``MemFabric`` under :data:`HANDOFF_WINDOWS`, each with a pooled
    server and its own ``SnapshotStore``; a redirect-chasing client (an
    update no process takes waits for the next tick, in order) feeds
    phase 10's tenants (``tenants``: the cold tenants, the 32 warm docs
    and their blobs, and the digests phase 10's single server gave) and
    the BASELINE #5 tenant :data:`FLEET_BIG` (``big_blobs``, 100,000
    ops). After every fleet tick a sweep asks every live node to serve
    every doc and counts double serves.

    1. One cold tick: each node's packed batches launch
       ``seg_argmax_scan`` and ``stream_scatter`` once a batch; every
       tenant's digest equals phase 10's, and the big tenant's cache
       ``big_cache`` (phase 4's device route).
    2. A promotion tick and steady ticks of 64-op deltas (digests equal
       phase 10's); then every warm doc "a" owns, and the big tenant, is
       live-migrated to its ring's least-loaded successor while deltas
       keep landing, so the tails ride the commit frames.
    3. After the handoffs exactly one node serves each doc, and each
       moved doc's digest, state vector, full-state update and engine
       snapshot equal a migration-free oracle's: one pooled server on
       ``device`` that takes each moved doc's blobs in the ticks the
       fleet's holder of the doc took them (a handoff's tail lands on
       the destination in one tick) and reads the doc's cache after
       every tick in which the fleet read it (a serve, the source's
       ship). The order of a lazily rebuilt cache's map keys, and so the
       engine snapshot's bytes, follows the reads (ROADMAP C).
    4. Each destination's next steady tick is one pool dispatch and one
       ``stream_scatter`` launch, over its adopted docs too.
    5. "a" is checkpointed, killed and revived with ``restore()``; its
       cold tenants come back from the client's blob log; one node
       serves each doc and every digest is unchanged.

    Returns the kernel inputs and launches of the ``"fleet"`` rows and
    the phase's record."""
    import os
    import tempfile
    from collections import Counter

    from crdt_tpu_torch.fleet import FleetNode, MemFabric, migration, wire
    from crdt_tpu_torch.models.incremental import IncrementalReplay
    from crdt_tpu_torch.models.multidoc import MultiDocServer
    from crdt_tpu_torch.net.faults import HandoffFaultSchedule
    from crdt_tpu_torch.obs import Tracer, set_tracer
    from crdt_tpu_torch.storage import snapshot

    label = f"fleet [{device}]"
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    cold, warm_ticks = tenants["cold"], tenants["ticks"]
    names, streams = tenants["names"], tenants["streams"]
    members = FLEET_MEMBERS
    server_kw = {"max_rows_per_dispatch": COLD_MAX_ROWS, "pool": True}
    tracer = set_tracer(Tracer(enabled=True))
    tmp = tempfile.TemporaryDirectory()
    chaos = HandoffFaultSchedule(RB_SEED, windows=HANDOFF_WINDOWS)
    fab = MemFabric(faults=chaos)
    stores = {p: snapshot.SnapshotStore(os.path.join(tmp.name, p))
              for p in members}
    nodes: dict = {}
    oracle = MultiDocServer(device=device, **server_kw)
    all_docs = list(cold) + names + [FLEET_BIG]
    moved: list = []
    applied: list = []   # (doc, blob) of moved docs a fleet server took
    read: set = set()    # moved docs the fleet read outside the sweep

    def build(p):
        node = FleetNode(p, members, fab, store=stores[p],
                         timeout_ticks=3, beacon_every=4,
                         server_kw=dict(server_kw), device=device)
        take = node.server.submit

        def submit(doc, blob):
            if doc in moved:
                applied.append((doc, bytes(blob)))
            return take(doc, blob)

        node.server.submit = submit
        return node

    for p in members:
        nodes[p] = build(p)
    ring = nodes["a"].ring
    moved += [d for d in names if ring.owner(d) == "a"] + [FLEET_BIG]
    backlog: dict = {}
    hint: dict = {}
    routes: Counter = Counter()

    def submit(doc, blob):
        backlog.setdefault(doc, []).append(blob)

    def flush_client():
        # each doc's backlog in order, to its believed owner first,
        # chasing redirects
        for doc in list(backlog):
            q = backlog[doc]
            while q:
                r = "retry"
                for p in dict.fromkeys([hint.get(doc, "a")] + members):
                    if p in fab.dead:
                        continue
                    r, info = nodes[p].submit(doc, q[0])
                    if r in ("ok", "buffered"):
                        hint[doc] = p
                        break
                    if r == "redirect" and info in nodes:
                        hint[doc] = info
                routes[r] += 1
                if r not in ("ok", "buffered"):
                    break
                q.pop(0)
            if not q:
                del backlog[doc]

    def warm_feed():
        # each warm doc's blobs after its cold tick, in phase 10's order:
        # its ticks, its checkpoint step's two blobs, then fresh deltas
        for t in range(1, len(warm_ticks)):
            yield {d: [warm_ticks[t][d]] for d in names}
        yield {d: list(tenants["extra"][d]) for d in names}
        while True:
            yield {d: [s.delta(WARM_DELTA)] for d, s in zip(names, streams)}

    feed = warm_feed()

    def submit_warm(t):
        for d, blobs in next(feed).items():
            for b in blobs:
                submit(d, b)
        submit(FLEET_BIG, big_delta(traces, t))

    def node_tick(p, seen=None):
        sync()
        kernels.reset_launches()
        d0 = packed_mod.device_dispatch_count
        t0 = time.perf_counter()
        if seen is None:
            rep = nodes[p].tick()
        else:
            with capture_kernel_inputs(
                    seen, (packed_mod, "seg_argmax_scan"),
                    (packed_mod, "stream_scatter")):
                rep = nodes[p].tick()
        sync()
        wall = time.perf_counter() - t0
        if rep.fallback_docs:
            raise AssertionError(f"{label}: {p} fell back: {rep}")
        return rep, wall, kernels.launch_counts(), \
            packed_mod.device_dispatch_count - d0

    double_serves = [0]
    # host seconds of the fleet ticks, part by part
    parts = Counter()

    def fleet_tick(exact: bool, seen_of=None):
        """Client, node ticks, the serving sweep, then the oracle's
        tick. Returns each node's (report, wall s, launches, device
        dispatches) and each doc's digest where one node serves it."""
        t0 = time.perf_counter()
        flush_client()
        t1 = time.perf_counter()
        out = {}
        for p in members:
            if p not in fab.dead:
                out[p] = node_tick(p, None if seen_of is None
                                   else seen_of.setdefault(p, {}))
        t2 = time.perf_counter()
        served = {}
        for d in all_docs:
            got = [(p, g) for p in members if p not in fab.dead
                   for g in [nodes[p].digest(d)] if g is not None]
            if len(got) > 1:
                double_serves[0] += 1
            if exact and len(got) != 1:
                raise AssertionError(f"{label}: {d} served by "
                                     f"{[p for p, _ in got]}")
            if len(got) == 1:
                served[d] = got[0][1]
        t3 = time.perf_counter()
        for d, b in applied:
            oracle.submit(d, b)
        applied.clear()
        oracle.tick()
        for d in moved:
            if d in served or d in read:
                oracle.digest(d)
        read.clear()
        sync()
        parts.update({"ticks": 1, "client_s": t1 - t0, "nodes_s": t2 - t1,
                      "sweep_s": t3 - t2,
                      "oracle_s": time.perf_counter() - t3})
        return out, served

    prev_min = os.environ.get("CRDT_TPU_DEVICE_MIN")
    os.environ["CRDT_TPU_DEVICE_MIN"] = "1"  # as phase 10
    t_phase = time.perf_counter()
    try:
        # ---- 1. one cold tick
        for d, blobs in cold.items():
            for b in blobs:
                submit(d, b)
        for d in names:
            submit(d, warm_ticks[0][d])
        for b in big_blobs:
            submit(FLEET_BIG, b)
        cold_seen: dict = {}
        res, served = fleet_tick(True, cold_seen)
        cold_launches = 0
        for p, (rep, wall, counts, _) in res.items():
            log(f"{label} cold tick [{p}]: {wall:.3f} s; {rep}; launches "
                f"{counts}")
            if device == "cuda" and not (
                    counts["seg_argmax_scan"] == counts["stream_scatter"]
                    == rep.dispatches > 0):
                raise AssertionError(f"{label}: {p}'s cold tick launched "
                                     f"{counts} for {rep.dispatches} "
                                     "dispatches")
            cold_launches += counts["seg_argmax_scan"]
            for kname, calls in cold_seen[p].items():
                for args in calls:
                    hold_kernel(kname, *args)
        want = dict(tenants["cold_digests"], **tenants["tick_digests"][0])
        if any(served[d] != want[d] for d in want):
            raise AssertionError(f"{label}: a digest after the cold tick "
                                 "differs from phase 10's")
        if json.dumps(nodes[ring.owner(FLEET_BIG)].server.cache(FLEET_BIG),
                      sort_keys=True) != big_cache:
            raise AssertionError(f"{label}: {FLEET_BIG} != the device route")
        log(f"{label}: cold tick: every tenant == phase 10's digests, "
            f"{FLEET_BIG} ({len(big_blobs)} blobs) == phase 4's device "
            f"route; docs a node "
            f"{dict(sorted(Counter(ring.owner(d) for d in all_docs).items()))}")

        # ---- 2. promotion and steady ticks, then the migrations
        steady_before = {p: [] for p in members}
        for t in range(1, 5):
            submit_warm(t)
            res, served = fleet_tick(True)
            if t >= 3:
                for p, r in res.items():
                    steady_before[p].append(round(r[1], 6))
            if {d: served[d] for d in names} != tenants["tick_digests"][t]:
                raise AssertionError(f"{label}: tick {t} != phase 10's")
        for d in moved:
            if nodes[ring.owner(d)].server._docs[d].resident is None:
                raise AssertionError(f"{label}: {d} is not resident")
        # what a migration costs on the host, doc by doc
        costs: dict = {d: {} for d in moved}
        current = [None]

        def timed_into(key, fn):
            def call(*a, **kw):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                sync()
                if current[0] is not None:
                    costs[current[0]][key] = round(
                        time.perf_counter() - t0, 6)
                return out
            return call

        def scoped(fn, doc_of):
            def call(*a, **kw):
                current[0] = doc_of(*a, **kw)
                read.add(current[0])
                try:
                    return fn(*a, **kw)
                finally:
                    current[0] = None
            return call

        patches = [
            (snapshot, "encode_engine", timed_into(
                "encode_engine_s", snapshot.encode_engine)),
            (snapshot, "rehydrate", timed_into(
                "rehydrate_s", snapshot.rehydrate)),
            (IncrementalReplay, "encode_state_as_update", timed_into(
                "encode_state_as_update_s",
                IncrementalReplay.encode_state_as_update)),
            (migration.Migrator, "_ship", scoped(
                migration.Migrator._ship, lambda self, m: m.doc)),
        ]
        saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
        adopt = migration.adopt_doc
        send = fab.send

        def adopting(server, doc, *a):
            # the destination's adoption, timed alone (it is no read)
            current[0] = doc
            try:
                return adopt(server, doc, *a)
            finally:
                current[0] = None

        def sending(src, dst, data):
            dec = wire.decode_frame(data)
            if dec and dec[0].get("kind") == "offer":
                costs[dec[0]["doc"]]["offer_bytes"] = len(data)
            return send(src, dst, data)

        for obj, name, fn in patches:
            setattr(obj, name, fn)
        migration.adopt_doc = adopting
        fab.send = sending
        try:
            loads = {p: nodes[p].load() for p in members}
            plan = {}
            for d in moved:
                src = ring.owner(d)
                dst = ring.least_loaded_successor(d, exclude=[src],
                                                  loads=loads)
                if not nodes[src].migrate(d, dst):
                    raise AssertionError(f"{label}: migrate({d}) refused")
                plan[d] = (src, dst, time.perf_counter())
            log(f"{label}: loads before the moves {json.dumps(loads)}; "
                f"moves {json.dumps({d: v[:2] for d, v in plan.items()})}")
            pending = dict(plan)
            t = 5
            while pending:
                if t > 5 + FLEET_HANDOFF_TICKS:
                    raise AssertionError(f"{label}: handoffs of "
                                         f"{sorted(pending)} incomplete")
                submit_warm(t)
                fleet_tick(False)
                now = time.perf_counter()
                for d, (src, dst, t0) in list(pending.items()):
                    if d not in nodes[src].migrator.outbound:
                        costs[d]["ticks"] = t - 4
                        costs[d]["seconds"] = round(now - t0, 6)
                        del pending[d]
                t += 1
        finally:
            for obj, name, fn in saved:
                setattr(obj, name, fn)
            migration.adopt_doc = adopt
            fab.send = send
        if backlog:
            raise AssertionError(f"{label}: updates still waiting "
                                 f"{ {d: len(v) for d, v in backlog.items()} }")
        for d, (src, dst, _) in plan.items():
            if nodes[dst].lease.lease(d) != (2, dst) or \
                    d in nodes[src].server._docs:
                raise AssertionError(f"{label}: {d} did not move to {dst}")

        # ---- 3 and 4. the destinations' next steady ticks
        dsts = sorted({v[1] for v in plan.values()})
        steady_after = {p: [] for p in members}
        flush_seen: dict = {}
        flush_launches = 0
        for k in range(FLEET_TICKS_AFTER):
            submit_warm(t + k)
            res, _ = fleet_tick(True, flush_seen if k == 0 else None)
            for p, (rep, wall, counts, disp) in res.items():
                steady_after[p].append(round(wall, 6))
                if k or p not in dsts:
                    continue
                adopted = [d for d, v in plan.items() if v[1] == p]
                srv = nodes[p].server
                log(f"{label}: {p}'s first tick over adopted {adopted}: "
                    f"{wall:.4f} s; {rep}; device dispatches {disp}; "
                    f"launches {counts}")
                want = dict.fromkeys(counts, 0)
                want["stream_scatter"] = int(device == "cuda")
                if rep.pool_dispatches != 1 or disp != 1 or counts != want \
                        or any(srv._docs[d].resident is None
                               or srv._docs[d].resident.pool is not srv.pool
                               for d in adopted):
                    raise AssertionError(f"{label}: {p}'s first tick after "
                                         f"adoption: {rep}, {counts}")
                flush_launches += counts["stream_scatter"]
                for args in flush_seen[p].get("stream_scatter", ()):
                    hold_kernel("stream_scatter", *args)
        for d, (_src, dst, _) in plan.items():
            got = nodes[dst].server
            a, b = got._docs[d].resident, oracle._docs[d].resident
            for what, x, y in (
                    ("digest", got.digest(d), oracle.digest(d)),
                    ("state vector", a.state_vector().clocks,
                     b.state_vector().clocks),
                    ("full-state update", a.encode_state_as_update(),
                     b.encode_state_as_update()),
                    ("engine snapshot", snapshot.encode_engine(a, seq=0),
                     snapshot.encode_engine(b, seq=0))):
                if x != y:
                    raise AssertionError(f"{label}: {d}'s {what} != the "
                                         "oracle's")
        log(f"{label}: after the handoffs one node serves each of "
            f"{len(all_docs)} docs; the {len(plan)} moved docs == the "
            "migration-free oracle (digest, state vector, full-state "
            "update, engine snapshot)")

        # ---- 5. checkpoint, kill and revive "a"
        _, before = fleet_tick(True)
        sync()
        t0 = time.perf_counter()
        n_ckpt = nodes["a"].checkpoint()
        ckpt_s = time.perf_counter() - t0
        fab.kill("a")
        for _ in range(2):
            fleet_tick(False)
        nodes["a"] = build("a")
        fab.revive("a", nodes["a"])
        t0 = time.perf_counter()
        n_rest = nodes["a"].restore()
        sync()
        restore_s = time.perf_counter() - t0
        relog = [d for d in cold if nodes["a"].lease.holds(d)
                 and d not in nodes["a"].server._docs]
        for d in relog:
            for b in cold[d]:
                submit(d, b)
        _, after = fleet_tick(True)
        if after != before or n_rest != n_ckpt:
            raise AssertionError(
                f"{label}: revived 'a' changed "
                f"{[d for d in before if after.get(d) != before[d]]} "
                f"({n_ckpt} checkpointed, {n_rest} restored)")
        log(f"{label}: 'a' checkpointed {n_ckpt} resident docs in "
            f"{ckpt_s:.3f} s, killed, revived with restore() of {n_rest} "
            f"in {restore_s:.3f} s, {len(relog)} cold tenants re-admitted "
            "from the client's blob log; one node serves each doc, every "
            "digest unchanged")
    finally:
        if prev_min is None:
            os.environ.pop("CRDT_TPU_DEVICE_MIN", None)
        else:
            os.environ["CRDT_TPU_DEVICE_MIN"] = prev_min
        set_tracer(Tracer(enabled=False))
        tmp.cleanup()
    counters = tracer.counters()
    if double_serves[0] or any(nodes[p].lease.fork_refused for p in members):
        raise AssertionError(f"{label}: {double_serves[0]} double serves")
    if not counters.get("migration.tail_blobs"):
        raise AssertionError(f"{label}: no update rode a commit frame")
    record = {
        "migrations": costs,
        "recoveries": {k: v for k, v in counters.items()
                       if k.startswith("migration.recovery")},
        "tail_blobs": counters.get("migration.tail_blobs", 0),
        "completed": counters.get("migration.completed", 0),
        "steady_tick_s_before": steady_before,
        "steady_tick_s_after": steady_after,
        "fabric": {"sent": fab.sent, "dropped": fab.dropped,
                   "duplicated": fab.duplicated},
        "client_routes": dict(routes),
        "fleet_tick_parts": {k: round(v, 6) for k, v in parts.items()},
        "double_serves": double_serves[0],
        "seconds": round(time.perf_counter() - t_phase, 3),
    }
    log(f"{label}: record {json.dumps(record, sort_keys=True)}")
    biggest: dict = {}
    for p in members:
        for kname, calls in cold_seen.get(p, {}).items():
            biggest.setdefault(kname, []).extend(calls)
    biggest = {k: sorted(v, key=lambda a: -int(a[0].shape[0]))
               for k, v in biggest.items()}
    flush = [a for p in dsts
             for a in flush_seen.get(p, {}).get("stream_scatter", ())]
    return {"rows": {"fleet": (biggest, cold_launches),
                     "fleet_flush": ({"stream_scatter": flush},
                                     flush_launches)},
            "record": record}


# phase 13 (c): bench.py's --rebalance --smoke children (its
# BENCH_RB_SMOKE_TICKS default), their tick sleep and the grace ticks
# after the handoff
FLEET_CHILD_TICKS = 30


def fleet_subprocess(device: str = "cuda") -> dict:
    """Phase 13 (c): ``bench.py --rebalance --smoke`` on the port
    (``rebalance_smoke``, bench.py:2701-2787): three OS processes (this
    script again, ``--fleet-child``), each a ``FleetNode`` with its
    server on ``device`` over a ``UdpFabric`` on the port's sealed
    ``UdpEndpoint``, X25519 identities from fixed seeds. Child "a"
    seeds the doc and live-migrates it to "c". Exactly one child serves
    afterwards, with "a"'s pre-migration digest; the losers' fence
    counts it; no child's transport failed a message."""
    import os
    import subprocess
    import tempfile

    label = f"fleet over UDP [{device}]"
    names = FLEET_MEMBERS
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as outdir:
        ports = _free_ports(len(names), udp=True)
        procs, logs = [], []
        try:
            for idx in range(len(names)):
                cfg = {"idx": idx, "names": names, "ports": ports,
                       "outdir": outdir, "ticks": FLEET_CHILD_TICKS,
                       "device": device}
                out = open(os.path.join(outdir, f"child_{idx}.log"), "w")
                logs.append(out)
                procs.append(subprocess.Popen(
                    [sys.executable, str(ROOT / "chip_smoke.py"),
                     "--fleet-child", json.dumps(cfg)],
                    cwd=ROOT, stdout=out, stderr=subprocess.STDOUT))
            done_paths = [os.path.join(outdir, f"done_{i}.json")
                          for i in range(len(names))]
            deadline = time.monotonic() + 150.0
            while time.monotonic() < deadline and not all(
                    os.path.exists(p) for p in done_paths):
                if any(p.poll() not in (None, 0) for p in procs):
                    break
                time.sleep(0.05)
            missing = [p for p in done_paths if not os.path.exists(p)]
            if missing:
                for out in logs:
                    out.flush()
                tails = [Path(out.name).read_text()[-1500:] for out in logs]
                raise AssertionError(f"{label}: children incomplete "
                                     f"{missing}, rc "
                                     f"{[p.poll() for p in procs]}, logs "
                                     f"{tails}")
            dones = {names[i]: json.loads(Path(p).read_text())
                     for i, p in enumerate(done_paths)}
        finally:
            with open(os.path.join(outdir, "stop"), "w") as f:
                f.write("done")
            for p in procs:
                try:
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
            for out in logs:
                out.close()
        rcs = [p.returncode for p in procs]
        child_logs = [Path(out.name).read_text()[-600:] for out in logs]
    servers = [n for n in names if dones[n]["digest"] is not None]
    leases = {n: dones[n]["lease"] for n in names}
    checks = {
        "children exited 0": rcs == [0] * len(names),
        "a migrated": dones["a"]["migrate_ok"] is True
        and dones["a"]["completed"] == 1,
        "one server, c": servers == ["c"],
        "c serves d0": dones["c"]["digest"] == dones["a"]["d0"],
        "leases at (2, c)": all(v == [2, "c"] for v in leases.values()),
        "a's fence counted": dones["a"]["fence_rejects"] >= 1,
        "no fork": sum(d["fork_refused"] for d in dones.values()) == 0,
        "udp_failed 0": all(d["udp_failed"] == 0 for d in dones.values()),
        "on the device": all(d["device"] == device for d in dones.values())
        and (dones["a"]["launches"]["stream_scatter"] > 0)
        == (device == "cuda"),
    }
    out = {"servers": servers, "leases": leases,
           "fence_rejects": {n: dones[n]["fence_rejects"] for n in names},
           "udp_failed": {n: dones[n]["udp_failed"] for n in names},
           "handoff_tick": dones["a"]["handoff_tick"],
           "launches": {n: dones[n]["launches"] for n in names},
           "seconds": round(time.perf_counter() - t_start, 3)}
    log(f"{label}: {json.dumps(out, sort_keys=True)}")
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"{label}: failed {failed}: {child_logs}")
    return out


def fleet_child(arg: str) -> int:
    """One child of :func:`fleet_subprocess` (bench.py's
    ``rebalance_child``, bench.py:2556-2698, on the port): a
    ``FleetNode`` whose server is on ``cfg["device"]`` and whose fabric
    is the sealed ``UdpEndpoint``. The run ends on a barrier: once "a"
    marks the handoff complete, every child runs a grace window (a
    beacon cadence, so "b" adopts the new owner), writes
    ``done_<idx>.json`` and drains its inbox until the parent's stop
    file appears."""
    import os

    cfg = json.loads(arg)
    sys.path.insert(0, str(ROOT))
    import torch

    idx = int(cfg["idx"])
    if cfg["device"] == "cuda" and not torch.cuda.is_available():
        print(json.dumps({"child": idx, "error": "no card"}),
              file=sys.stderr)
        return 2
    names = list(cfg["names"])
    me = names[idx]
    ports = cfg["ports"]
    outdir = cfg["outdir"]
    ticks = int(cfg["ticks"])

    from crdt_tpu_torch.codec import v1
    from crdt_tpu_torch.core.ids import DeleteSet
    from crdt_tpu_torch.core.records import ItemRecord
    from crdt_tpu_torch.fleet import FleetNode, UdpFabric
    from crdt_tpu_torch.net.transport import SecureBox, UdpEndpoint, keypair
    from crdt_tpu_torch.obs import Tracer, set_tracer
    from crdt_tpu_torch.ops import kernels
    from crdt_tpu_torch.storage.snapshot import SnapshotStore

    tracer = set_tracer(Tracer(enabled=True))
    keys = {n: keypair(bytes([j + 1]) * 32) for j, n in enumerate(names)}
    _pub, sec = keys[me]
    peers = {n: ("127.0.0.1", int(ports[j]), SecureBox(sec, keys[n][0]))
             for j, n in enumerate(names) if n != me}
    ep = UdpEndpoint("127.0.0.1", int(ports[idx]))
    node = FleetNode(me, names, UdpFabric(me, ep, peers),
                     store=SnapshotStore(os.path.join(outdir, me)),
                     timeout_ticks=25, beacon_every=8,
                     server_kw={"slo_ms": 1e9}, device=cfg["device"])

    # start barrier: frames to an unbound port are lost
    with open(os.path.join(outdir, f"ready_{idx}.json"), "w") as f:
        json.dump({"port": ep.port}, f)
    deadline = time.monotonic() + 60.0
    while time.monotonic() < deadline and not all(
            os.path.exists(os.path.join(outdir, f"ready_{j}.json"))
            for j in range(len(names))):
        time.sleep(0.01)

    def chain_blob(k0, n_ops=4):
        return v1.encode_update([ItemRecord(
            client=7, clock=k, parent_root="l",
            origin=(7, k - 1) if k else None, content=7000 + k,
        ) for k in range(k0, k0 + n_ops)], DeleteSet())

    doc = "doc"           # ring arc: a
    d0 = None
    migrate_ok = None
    handoff_path = os.path.join(outdir, "handoff.json")
    t = 0
    grace = None
    while True:
        if me == "a":
            if t < 4:
                r, _ = node.submit(doc, chain_blob(4 * t))
                assert r == "ok", f"seed submit: {r}"
            if t == 4:
                d0 = node.server.digest(doc)
            if t == 10:
                migrate_ok = node.migrate(doc, "c")
            if migrate_ok and node.migrator.completed >= 1 \
                    and not os.path.exists(handoff_path):
                with open(handoff_path + ".tmp", "w") as f:
                    json.dump({"tick": t}, f)
                os.replace(handoff_path + ".tmp", handoff_path)
        ep.poll()
        node.tick()
        time.sleep(0.02)
        t += 1
        if grace is None:
            if t >= ticks and os.path.exists(handoff_path):
                grace = 24
            elif t > 40 * ticks:   # runaway guard: fail loudly
                break
        else:
            grace -= 1
            if grace <= 0:
                break
    if cfg["device"] == "cuda":
        torch.cuda.synchronize()
    served = node.digest(doc)   # fence-refused (and counted) on losers
    counters = tracer.counters()

    def csum(name):
        return sum(v for k, v in counters.items()
                   if k == name or k.startswith(name + "{"))

    handoff = json.loads(Path(handoff_path).read_text()) \
        if os.path.exists(handoff_path) else {}
    done = {
        "proc": me, "digest": served, "d0": d0,
        "lease": list(node.lease.lease(doc)), "migrate_ok": migrate_ok,
        "completed": node.migrator.completed,
        "fence_rejects": csum("fleet.fence_rejects"),
        "fork_refused": csum("fleet.fork_refused"),
        "udp_failed": ep.failed, "handoff_tick": handoff.get("tick"),
        "device": node.server.device.type,
        "launches": kernels.launch_counts(),
    }
    done_path = os.path.join(outdir, f"done_{idx}.json")
    with open(done_path + ".tmp", "w") as f:
        json.dump(done, f)
    os.replace(done_path + ".tmp", done_path)
    deadline = time.monotonic() + 60.0
    while time.monotonic() < deadline and not os.path.exists(
            os.path.join(outdir, "stop")):
        ep.poll()
        node.drain_inbox()
        time.sleep(0.01)
    ep.close()
    return 0


def fleet_control_phase(torch, kernels, packed_mod, traces, hold_kernel,
                        tenants: dict, big_blobs, big_cache: str) -> dict:
    """Phase 13, the fleet control plane on the card: (a)
    :func:`rebalance_leg` with every server on the card, gated and held
    field by field against the same leg on the CPU; (b)
    :func:`fleet_phase`; (c) :func:`fleet_subprocess`. Returns the
    ``"fleet"`` rows' kernel inputs and launches."""
    t0 = time.perf_counter()
    leg = rebalance_leg("cuda")
    leg_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = rebalance_leg("cpu", warmup=False)
    cpu_s = time.perf_counter() - t0
    log(f"fleet rebalance leg [cuda]: {json.dumps(leg, sort_keys=True)}")
    log(f"fleet rebalance leg: {leg_s:.3f} s on the card (a warm-up leg, "
        f"ON and OFF), {cpu_s:.3f} s on the CPU (ON and OFF)")
    checks = {
        "double_serves == 0": leg["double_serves"] == 0,
        "forks == 0": leg["forks"] == 0,
        "recovery within budget": leg["recovery_ticks"] is not None
        and leg["recovery_ticks"] <= leg["recovery_budget_ticks"],
        "all_identical": leg["all_identical"],
        "migrations_completed >= 1": leg["migrations_completed"] >= 1,
        "card == CPU": leg == cpu,
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        diff = {k: (leg[k], cpu[k]) for k in leg if leg[k] != cpu.get(k)}
        raise AssertionError(f"fleet rebalance leg: failed {failed}; card "
                             f"vs CPU {diff}")
    out = fleet_phase(torch, kernels, packed_mod, traces, hold_kernel,
                      tenants, big_blobs, big_cache)
    fleet_subprocess("cuda")
    return out["rows"]


# ---------------------------------------------------------------------------
# phase 14: multi-device on a mesh of the card
# ---------------------------------------------------------------------------

# the sharded cold replay's shard counts; the mesh of the stream route's
# sharded stream shards; the mesh of the kernels line's sharded,
# segment and replicated rows (its hierarchical mesh is 2 x 2)
MESH_KS = (2, 4, 8)
MESH_STREAM_K = 2
MESH_K = 4
# the ring delta: one replica an entry, as the reference requires, 8
# fresh rows each over a 96-row shared history
RING_REPLICAS = 8
# the fleet fault plan (the reference's tests/test_faults.py:250)
FAULT_PLAN = dict(seed=5, drop=0.4, partition_every=2, groups=2)
# the spans a mesh mapping of fleet_replay reports
FLEET14_SPANS = PHASES["fleet"] + ("pack", "converge.dispatch",
                                   "converge.fetch", "fleet.seg_step")


@contextmanager
def env_set(name: str, value: str):
    """``os.environ[name] = value`` for the block, restored after."""
    import os

    prev = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = prev


def multidevice_phase(torch, rp, streaming, fleet, kernels, packed_mod,
                      deleteset, statevec, blobs: dict, results: dict,
                      mt_cold, same, hold_kernel,
                      device: str = "cuda") -> dict:
    """Phase 14: the multi-device layer on a mesh whose entries all lie
    on the one card (``device="cpu"`` runs the same checks on the host,
    at whatever size ``blobs`` holds). ``blobs`` holds the
    ``scale_1000x1600`` and ``trace_1000x100`` traces, ``results`` the
    ``"device"`` (phase 4), ``"fleet"`` (phase 5) and ``"stream"``
    (phase 6) results of the first, ``mt_cold`` phase 10's cold tenants
    and their digests.

    (a) the sharded cold replay: one decode, then ``shard.stage`` and
        ``converge`` at K = 2, 4, 8, each equal to phase 4 byte for
        byte, one ``shard.dispatches``, the device state vector equal to
        the host's, ``seg_argmax_scan`` and ``stream_scatter`` K calls
        each (K launches on the card), every input held against the
        plain version; then ``replay_trace`` with ``CRDT_TPU_SHARDS=4``;
    (b) the stream route with ``CRDT_TPU_SHARDS=2``: every stream shard
        sharded, equal to phase 6;
    (c) ``fleet_replay`` in three mappings — ``"sharded"`` and
        ``"segments"`` on a 4-entry mesh, the two-tier round on a 2 x 2
        ``make_mesh2d`` — each equal to phase 5, ``ds_mask`` and
        ``sv_deficit`` held on their inputs;
    (d) ``MultiDocServer(shards=4)``: phase 10's cold tenants in one
        tick, every digest equal to phase 10's, every batch of at least
        ``CRDT_TPU_SHARD_MIN_ROWS`` rows sharded and no other;
    (e) the ring delta on an 8-entry mesh, budgets below and above the
        deficit: the card equal to the CPU field by field;
    (f) ``GossipFaultPlan`` drop and partition rounds of the 1000 x 100
        fleet on the 2 x 2 mesh: the healed round equals the fault-free
        one field by field.

    Returns the kernel inputs and launches of the kernels line's
    ``"shard"``, ``"segments"`` and ``"hierarchical"`` rows."""
    import numpy as np

    from crdt_tpu_torch.models.multidoc import MultiDocServer
    from crdt_tpu_torch.obs import (TickTimeline, Tracer, set_timeline,
                                    set_tracer)
    from crdt_tpu_torch.ops import shard as shard_ops
    from crdt_tpu_torch.ops import staging
    from crdt_tpu_torch.parallel import delta, gossip

    on_card = device == "cuda"
    pk_sites = ((packed_mod, "seg_argmax_scan"),
                (packed_mod, "stream_scatter"))
    fl_sites = ((deleteset, "ds_mask"), (statevec, "sv_deficit"))
    t_phase = time.perf_counter()

    def sync() -> None:
        if on_card:
            torch.cuda.synchronize()

    def counted(run, sites):
        """``run()`` with the launch counts zeroed just before and read
        just after, the tracer and the timeline on and the kernels'
        inputs captured. Returns (result, wall s, launches, inputs,
        tracer report, timeline records)."""
        tracer = set_tracer(Tracer(enabled=True))
        tl = set_timeline(TickTimeline(enabled=True))
        seen: dict = {}
        sync()
        kernels.reset_launches()
        t0 = time.perf_counter()
        with capture_kernel_inputs(seen, *sites):
            out = run()
        sync()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        set_tracer(Tracer(enabled=False))
        set_timeline(TickTimeline(enabled=False))
        return out, wall, counts, seen, tracer.report(), tl.records()

    def expect(what: str, counts: dict, seen: dict, want: dict) -> None:
        """Each named kernel called ``want[name]`` times, and on the card
        launched as often; the CPU launches nothing."""
        calls = {k: len(seen.get(k, ())) for k in want}
        launched = {k: counts[k] for k in want}
        if calls != want or launched != (want if on_card
                                         else dict.fromkeys(want, 0)):
            raise AssertionError(f"{what}: calls {calls}, launches "
                                 f"{launched}, want {want}")
        for name, calls_ in seen.items():
            for args in calls_:
                hold_kernel(name, *args)

    def spans(rep, names) -> dict:
        return {n: round(rep["spans"][n]["total_s"], 6)
                for n in names if n in rep["spans"]}

    out: dict = {}
    label = "scale_1000x1600"
    scale = blobs[label]
    want = results["device"]

    def placed(mesh) -> list:
        return [str(d) for d in gossip.entries(mesh)]

    log(f"mesh entries: make_mesh({max(MESH_KS)}) on "
        f"{placed(gossip.make_mesh(max(MESH_KS), device=device))}, "
        f"make_mesh2d(2, 2) on "
        f"{placed(gossip.make_mesh2d(2, 2, device=device))}")

    # ---- (a) the sharded cold replay
    t0 = time.perf_counter()
    dec = rp.decode(scale)
    cols, ds = rp.stage(dec)
    n_rows = len(dec["client"])
    snap = rp.compact(dec, ds)
    log(f"mesh {label}: one decode + stage + compact for every K in "
        f"{time.perf_counter() - t0:.3f} s ({n_rows} rows)")
    if snap != want.snapshot:
        raise AssertionError(f"mesh {label}: the snapshot != phase 4's")
    for K in MESH_KS:
        secs: dict = {}

        def run():
            with timing(secs, (shard_ops, "_partition", "partition"),
                        (staging, "stage", "shard stage")):
                t0 = time.perf_counter()
                splan = shard_ops.stage(cols, n_shards=K, device=device)
                secs["stage"] = time.perf_counter() - t0
            if splan is None:
                raise AssertionError(f"mesh {label}: K={K} staging "
                                     "refused: the route was not taken")
            t0 = time.perf_counter()
            handle = shard_ops.converge_async(splan, device=device)
            secs["dispatch"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            res = shard_ops.converge_fetch(handle)
            secs["fetch"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            w, v, o = rp.gather(dec, ds, ("packed", res), device=device)
            cache = rp.materialize(dec, ds, w, v, o)
            secs["assembly"] = time.perf_counter() - t0
            return splan, res, cache

        (splan, res, cache), wall, counts, seen, rep, _ = counted(
            run, pk_sites)
        got = rp.ReplayResult(cache=cache, snapshot=snap, n_ops=n_rows,
                              path="shard")
        same(label, got, want, f"sharded converge K={K} vs phase 4")
        disp = rep["counters"].get("shard.dispatches", 0)
        if disp != 1:
            raise AssertionError(f"mesh {label}: K={K} shard.dispatches "
                                 f"{disp}")
        host_sv = splan.sv_host.max(axis=0)
        if not np.array_equal(res.global_sv[:len(res.sv_clients)],
                              host_sv):
            raise AssertionError(f"mesh {label}: K={K} device global_sv "
                                 "!= sv_host.max(0)")
        expect(f"mesh {label} K={K}", counts, seen,
               {"seg_argmax_scan": K, "stream_scatter": K})
        rows_k = [len(r) for r in splan.row_maps]
        log(f"mesh {label} K={K}: == phase 4 byte for byte in {wall:.3f} "
            f"s; partition {secs['partition']:.3f} s, {K} shard stages "
            f"{secs['shard stage']:.3f} s ({secs['shard stage'] / K:.3f} s "
            f"a shard), stage in all {secs['stage']:.3f} s, dispatch "
            f"{secs['dispatch']:.3f} s, fetch {secs['fetch']:.3f} s, "
            f"assembly {secs['assembly']:.3f} s; rows a shard {rows_k}; "
            f"buckets S {splan.num_segments} B {splan.seq_bucket} M "
            f"{splan.map_bucket}; wire {splan.sv_mode} "
            f"{splan.wire.nbytes} bytes; global_sv == host; launches "
            f"{counts}; kernels == plain on every shard's inputs")
        if K == MESH_K:
            out["shard"] = (seen, K)

    with env_set(shard_ops.SHARD_ENV, str(MESH_K)):
        res, wall, counts, seen, rep, _ = counted(
            lambda: rp.replay_trace(scale, device=device), pk_sites)
    same(label, res, want, f"replay_trace, CRDT_TPU_SHARDS={MESH_K}")
    if rep["counters"].get("shard.dispatches", 0) != 1:
        raise AssertionError(f"mesh {label}: replay_trace did not shard")
    expect(f"mesh {label} replay_trace", counts, seen,
           {"seg_argmax_scan": MESH_K, "stream_scatter": MESH_K})
    log(f"mesh {label} [replay_trace, CRDT_TPU_SHARDS={MESH_K}]: == phase "
        f"4 in {wall:.3f} s; phases (s) "
        f"{json.dumps(spans(rep, PHASES['device']))}")

    # ---- (b) the stream route with sharded stream shards
    phases: dict = {}
    with env_set(shard_ops.SHARD_ENV, str(MESH_STREAM_K)):
        res, wall, counts, seen, rep, recs = counted(
            lambda: streaming.stream_replay(scale, device=device,
                                            phases=phases), pk_sites)
    (tick,) = recs
    n_stream = len(tick["dispatches"])
    disp = rep["counters"].get("shard.dispatches", 0)
    same(label, res, results["stream"],
         f"stream route, CRDT_TPU_SHARDS={MESH_STREAM_K}, vs phase 6")
    if res.path != "stream" or disp != n_stream or n_stream < 2:
        raise AssertionError(f"mesh {label} [stream]: {disp} sharded of "
                             f"{n_stream} stream shards ({res.path})")
    each = MESH_STREAM_K * n_stream
    expect(f"mesh {label} [stream]", counts, seen,
           {"seg_argmax_scan": each, "stream_scatter": each})
    log(f"mesh {label} [stream, CRDT_TPU_SHARDS={MESH_STREAM_K}]: "
        f"{n_stream} stream shards, each sharded {MESH_STREAM_K} ways; == "
        f"phase 6 in {wall:.3f} s; phases (s) {json.dumps(phases)}")

    # ---- (c) fleet_replay in three mappings
    for name, mesh, shard, sites, want_calls in (
            ("sharded", gossip.make_mesh(MESH_K, device=device), "sharded",
             pk_sites, {"seg_argmax_scan": MESH_K,
                        "stream_scatter": MESH_K}),
            ("segments", gossip.make_mesh(MESH_K, device=device),
             "segments", fl_sites, {"ds_mask": MESH_K, "sv_deficit": 0}),
            ("hierarchical", gossip.make_mesh2d(2, 2, device=device),
             "replicas", fl_sites, {"ds_mask": 1, "sv_deficit": 1})):
        res, wall, counts, seen, rep, _ = counted(
            lambda: fleet.fleet_replay(scale, mesh=mesh, shard=shard),
            sites)
        same(label, res, results["fleet"], f"fleet_replay {name} vs phase 5")
        path = "fleet-sharded" if shard == "sharded" else "fleet"
        if res.path != path:
            raise AssertionError(f"mesh {label} [fleet {name}]: path "
                                 f"{res.path}")
        expect(f"mesh {label} [fleet {name}]", counts, seen, want_calls)
        shapes = {k: [[list(a.shape) if hasattr(a, "shape") else a
                       for a in args] for args in v[:1]]
                  for k, v in seen.items()}
        log(f"mesh {label} [fleet {name}, mesh "
            f"{list(mesh.devices.shape)}]: == phase 5 in {wall:.3f} s; "
            f"phases (s) {json.dumps(spans(rep, FLEET14_SPANS))}; "
            f"launches {counts}; first inputs {json.dumps(shapes)}")
        if name != "sharded":
            out[name] = (seen, want_calls)

    # ---- (d) MultiDocServer(shards=4) on phase 10's cold tenants
    docs, digests = mt_cold
    srv = MultiDocServer(shards=MESH_K, device=device)
    routes: list = []
    enqueue = srv._dispatch_async

    def spy(comb):
        got = enqueue(comb)
        routes.append((len(comb["client"]), got[0] if got else None))
        return got

    srv._dispatch_async = spy
    for d, b in docs.items():
        srv.submit_many(d, b)
    rep_t, wall, counts, seen, _, _ = counted(srv.tick, pk_sites)
    bad = [d for d in docs if srv.digest(d) != digests[d]]
    if bad or rep_t.docs != len(docs) or rep_t.fallback_docs:
        raise AssertionError(f"mesh multidoc: {len(bad)} digests != phase "
                             f"10's; {rep_t}")
    floor = shard_ops.min_rows()
    wrong = [(n, r) for n, r in routes if (r == "shard") != (n >= floor)]
    n_sh = sum(r == "shard" for _, r in routes)
    if wrong or not n_sh:
        raise AssertionError(f"mesh multidoc: batch routes {routes}")
    each = MESH_K * n_sh + (rep_t.dispatches - n_sh)
    expect("mesh multidoc", counts, seen,
           {"seg_argmax_scan": each, "stream_scatter": each})
    log(f"mesh multidoc [shards={MESH_K}]: {len(docs)} cold tenants in one "
        f"tick, {wall:.3f} s; batches (rows, route) {routes}; "
        f"{rep_t.dispatches} dispatches; every digest == phase 10's")
    del srv

    # ---- (e) the ring delta, card against CPU
    rcols = delta.synth_resident_columns(RING_REPLICAS, 96, 8, seed=0)
    names = ("sent_count",) + tuple(f"recv_{c}" for c in delta.COL_NAMES)
    for budget in (4, 16):
        outs = {}
        for dev in dict.fromkeys((device, "cpu")):
            mesh = gossip.make_mesh(RING_REPLICAS, device=dev)
            parts = [[torch.from_numpy(np.ascontiguousarray(
                rcols[c][i:i + 1])).to(e)
                for i, e in enumerate(gossip.entries(mesh))]
                for c in delta.COL_NAMES]
            t0 = time.perf_counter()
            got = delta.make_ring_delta_step(
                mesh, RING_REPLICAS + 2, budget)(*parts)
            outs[dev] = [g.cpu().numpy() for g in got]
            log(f"mesh ring delta [{dev}, budget {budget}]: "
                f"{time.perf_counter() - t0:.3f} s")
        a, b = outs[device], outs["cpu"]
        for nm, x, y in zip(names, a, b):
            if x.dtype != y.dtype or x.shape != y.shape or \
                    not (x == y).all():
                raise AssertionError(f"mesh ring delta: {nm} differs")
        sent, valid = a[0], a[-1]
        if not (sent == 8).all() or \
                not (valid.sum(axis=1) == min(budget, 8)).all():
            raise AssertionError(f"mesh ring delta: sent {sent}")
    log(f"mesh ring delta ({RING_REPLICAS} entries, budgets 4 and 16): "
        f"{device} == CPU field by field")

    # ---- (f) the fault plan on the 1000 x 100 fleet
    tr = fleet.load_trace(blobs["trace_1000x100"], replicas_multiple=4)
    f2 = fleet.fleet_for_trace(tr, mesh=gossip.make_mesh2d(2, 2,
                                                           device=device))
    f1 = fleet.fleet_for_trace(tr, device=device)
    R = tr.n_replicas

    def as_cols(blk):
        return {k: blk[i].astype(tr.cols[k].dtype)
                for i, k in enumerate(gossip.COL_PACK_ORDER)}

    def equal(a, b) -> bool:
        return all(np.array_equal(getattr(a, f), getattr(b, f))
                   for f in a._fields)

    t0 = time.perf_counter()
    clean = f2.step(tr.cols, tr.dels)
    if not equal(clean, f1.step(tr.cols, tr.dels)):
        raise AssertionError("mesh faults: the 2 x 2 round != one entry's")
    plan = gossip.GossipFaultPlan(**FAULT_PLAN)
    packed_cols = gossip.pack_cols(tr.cols)
    keep = plan.delivered_mask(0, R)
    lossy = f2.step(as_cols(gossip.mask_packed(packed_cols, keep)), tr.dels)
    if not 0 < keep.sum() < R or equal(lossy, clean):
        raise AssertionError("mesh faults: the drop round lost nothing")
    groups = plan.partition_masks(2, R)
    if groups is None or sum(int(g.sum()) for g in groups) != R:
        raise AssertionError("mesh faults: no partition round")
    for g in groups:
        f2.step(as_cols(gossip.mask_packed(packed_cols, g)), tr.dels)
    healed = f2.step(tr.cols, tr.dels)
    if not equal(healed, clean) or plan.partition_masks(1, R) is not None:
        raise AssertionError("mesh faults: the healed round != fault-free")
    log(f"mesh faults (1000 x 100, mesh [2, 2], {json.dumps(FAULT_PLAN)}): "
        f"drop round withheld {R - int(keep.sum())} of {R} replicas, "
        f"partition round {[int(g.sum()) for g in groups]}, healed round "
        f"== fault-free field by field; {time.perf_counter() - t0:.3f} s")
    log(f"phase 14: {time.perf_counter() - t_phase:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 15: the multi-process pod on the card
# ---------------------------------------------------------------------------

# the pod's groups, each (processes, backend, steps), run in this order;
# "nccl_cards" runs only where two or more cards are visible, one rank a
# card, and its steps are "a" and "c" at K = one entry a rank
POD_GROUPS = {
    "A": (4, "gloo", ("replay4", "replay8", "fleet_sharded",
                      "fleet_segments", "ring", "multidoc")),
    "B": (2, "gloo", ("stream", "hierarchical")),
    "nccl_refused": (2, "nccl", ("nccl_refused",)),
    "nccl_one": (1, "nccl", ("nccl_collectives",)),
}
POD_CARD_STEPS = ("replayW", "fleet_sharded", "fleet_segments", "ring")
# a group's collective timeout (a rank that dies fails the others in
# this long) and its deadline from spawn to the last rank's exit
POD_TIMEOUT_S = 60
POD_DEADLINE_S = 300
# the tracer spans and counters a rank reports for each step
POD_SPANS = PHASES["device"] + (
    "fleet.load", "fleet.step", "fleet.seg_step", "mesh.agree",
    "mesh.all_gather", "mesh.all_gather2", "mesh.broadcast",
    "mesh.ppermute")
POD_COUNTERS = ("shard.dispatches", "mesh.collectives", "mesh.staged_bytes",
                'xfer.h2d_bytes_by{path="shard.mat"}',
                'xfer.h2d_bytes_by{path="shard.wire"}',
                'xfer.h2d_bytes_by{path="fleet.cols"}')
# the steps whose first kernel inputs the parent times, each rank's
POD_TIMED = {"replay4": "sharded converge K=4, a rank's shard",
             "fleet_segments": "segment round, a rank's entry",
             "hierarchical": "two-tier round on 2 x 2, a rank's union"}


def _sha(data) -> str:
    import hashlib

    if not isinstance(data, bytes):
        data = json.dumps(data, sort_keys=True).encode()
    return hashlib.sha256(data).hexdigest()


def pod_child(arg: str) -> int:
    """One rank of phase 15 (``python3 chip_smoke.py --pod-child CFG``):
    join the group, run the group's steps in order (each the entry point
    a user calls, on the same inputs as every other rank), and write one
    JSON record: each step's digests, spans, counters, kernel calls and
    launches, and the largest kernel-vs-plain difference on the step's
    captured inputs; or the error that stopped the rank."""
    import datetime
    import os
    import pickle
    import traceback

    t_main = time.time()
    cfg = json.loads(arg)
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    import torch.distributed as dist

    rank, world = int(cfg["rank"]), int(cfg["world"])
    backend, device = cfg["backend"], cfg["device"]
    work = Path(cfg["workdir"])
    rec: dict = {"rank": rank, "start_s": t_main - cfg["spawned_at"],
                 "steps": {}}
    try:
        from crdt_tpu_torch.models import fleet, streaming
        from crdt_tpu_torch.models import replay as rp
        from crdt_tpu_torch.models.multidoc import MultiDocServer
        from crdt_tpu_torch.obs import (TickTimeline, Tracer, set_timeline,
                                        set_tracer)
        from crdt_tpu_torch.ops import deleteset, kernels, packed, statevec
        from crdt_tpu_torch.ops import shard as shard_ops
        from crdt_tpu_torch.parallel import delta, gossip
        from crdt_tpu_torch.parallel import mesh as mesh_ops

        rec["import_s"] = time.time() - t_main
        torch.set_num_threads(2)
        if device == "cuda":
            # the rank's own card (where there are several, a card a
            # rank, as the pod mesh places its entries)
            torch.cuda.set_device(rank % torch.cuda.device_count())
        t0 = time.perf_counter()
        dist.init_process_group(
            backend, init_method=f"file://{work / ('init_' + cfg['group'])}",
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=POD_TIMEOUT_S))
        rec["group_init_s"] = time.perf_counter() - t0
        on_card = device == "cuda"
        if on_card:
            t0 = time.perf_counter()
            torch.ones(1, device="cuda")
            torch.cuda.synchronize()
            rec["cuda_init_s"] = time.perf_counter() - t0
        inputs = pickle.loads((work / "inputs.pkl").read_bytes())
        scale = inputs["scale"]
        pk_sites = ((packed, "seg_argmax_scan"), (packed, "stream_scatter"))
        fl_sites = ((deleteset, "ds_mask"), (statevec, "sv_deficit"))

        def sync() -> None:
            if on_card:
                torch.cuda.synchronize()

        def counted(step: str, run, sites) -> tuple:
            """``run()`` with the launch counts zeroed just before and
            read just after, the tracer on and the kernels' inputs
            captured; each input then held against the plain version,
            the first of each kernel saved for the parent's timing."""
            tracer = set_tracer(Tracer(enabled=True))
            seen: dict = {}
            sync()
            kernels.reset_launches()
            t0 = time.perf_counter()
            with capture_kernel_inputs(seen, *sites):
                out = run()
            sync()
            wall = time.perf_counter() - t0
            launches = kernels.launch_counts()
            set_tracer(Tracer(enabled=False))
            rep = tracer.report()
            max_err: dict = {}
            for name, calls in seen.items():
                kern = getattr(kernels, name)
                plain = getattr(kernels, name + "_plain")
                for args in calls:
                    got, want = kern(*args), plain(*args)
                    if got.shape != want.shape or got.dtype != want.dtype:
                        raise AssertionError(f"{step}: {name} shape/dtype "
                                             "!= plain")
                    err = int((got.long() - want.long()).abs().max()) \
                        if got.numel() else 0
                    max_err[name] = max(max_err.get(name, 0), err)
            if step in POD_TIMED and seen:
                torch.save({name: [tuple(a.cpu() if hasattr(a, "cpu")
                                         else a for a in calls[0])]
                            for name, calls in seen.items()},
                           work / f"kin_{step}_rank{rank}.pt")
            return out, {
                "wall": wall,
                "spans": {n: rep["spans"][n]["total_s"] for n in POD_SPANS
                          if n in rep["spans"]},
                "counters": {n: rep["counters"].get(n, 0)
                             for n in POD_COUNTERS},
                "calls": {n: len(c) for n, c in seen.items()},
                "launches": {n: launches[n] for n in REPLACES},
                "max_err": max_err,
            }

        def replay(step: str, K: int) -> dict:
            with env_set(shard_ops.SHARD_ENV, str(K)):
                res, r = counted(step, lambda: rp.replay_trace(
                    scale, route="device", device=device), pk_sites)
            return dict(r, cache=_sha(res.cache), snapshot=_sha(res.snapshot),
                        n_ops=res.n_ops, path=res.path, K=K)

        def fleet_step(step: str, mesh, mode: str, sites) -> dict:
            res, r = counted(step, lambda: fleet.fleet_replay(
                scale, mesh=mesh, shard=mode), sites)
            return dict(r, cache=_sha(res.cache), snapshot=_sha(res.snapshot),
                        n_ops=res.n_ops, path=res.path,
                        mesh=list(mesh.devices.shape))

        def stream(step: str) -> dict:
            phases: dict = {}
            tl = set_timeline(TickTimeline(enabled=True))
            with env_set(shard_ops.SHARD_ENV, str(world)):
                res, r = counted(step, lambda: streaming.stream_replay(
                    scale, device=device, phases=phases), pk_sites)
            set_timeline(TickTimeline(enabled=False))
            (tick,) = tl.records()
            return dict(r, cache=_sha(res.cache), snapshot=_sha(res.snapshot),
                        n_ops=res.n_ops, path=res.path,
                        stream_shards=len(tick["dispatches"]),
                        phases=phases)

        def ring(step: str) -> dict:
            rcols = delta.synth_resident_columns(RING_REPLICAS, 96, 8,
                                                 seed=0)
            out: dict = {"wall": {}}
            # a nccl group moves no CPU tensor: its ring is held against
            # the single controller's by the parent alone
            devs = (device, "cpu") if backend == "gloo" else (device,)
            for budget in (4, 16):
                got = {}
                for dev in dict.fromkeys(devs):
                    mesh = gossip.make_mesh(RING_REPLICAS, device=dev)
                    local = dict(mesh_ops.local_entries(mesh))
                    parts = [[torch.from_numpy(np.ascontiguousarray(
                        rcols[c][k:k + 1])).to(local[k])
                        if k in local else None
                        for k in range(RING_REPLICAS)]
                        for c in delta.COL_NAMES]
                    sync()
                    t0 = time.perf_counter()
                    vals = delta.make_ring_delta_step(
                        mesh, RING_REPLICAS + 2, budget)(*parts)
                    got[dev] = [v.cpu().numpy() for v in vals]
                    out["wall"][f"{dev} {budget}"] = \
                        time.perf_counter() - t0
                a, b = got[device], got[devs[-1]]
                if any(x.dtype != y.dtype or x.shape != y.shape
                       or not (x == y).all() for x, y in zip(a, b)):
                    raise AssertionError(f"ring delta budget {budget}: "
                                         f"{device} != cpu")
                out[str(budget)] = _sha(b"".join(x.tobytes() for x in a))
            return out

        def multidoc(step: str) -> dict:
            docs = inputs["mt_docs"]
            srv = MultiDocServer(shards=MESH_K, device=device)
            for d, b in docs.items():
                srv.submit_many(d, b)
            rep_t, r = counted(step, srv.tick, pk_sites)
            return dict(r, digests={str(d): srv.digest(d) for d in docs},
                        dispatches=rep_t.dispatches,
                        fallback=rep_t.fallback_docs)

        def nccl_refused(step: str) -> dict:
            # no collective: make_mesh refuses before any
            try:
                gossip.make_mesh(world, device=device)
            except RuntimeError as exc:
                return {"refused": str(exc)}
            return {"refused": None}

        def nccl_collectives(step: str) -> dict:
            # the pod's own collective code under nccl, on CUDA tensors,
            # against the single-controller mesh's copies
            dev = torch.device("cuda", torch.cuda.current_device())
            K = 4
            single = gossip.make_mesh(K, device=device)
            flat = np.empty(K, dtype=object)
            flat[:] = [dev] * K
            pod = mesh_ops.Mesh(flat, (mesh_ops.REPLICA_AXIS,),
                                mesh_ops.Pod(0, 1, "nccl", K))
            grid = pod._replace(devices=flat.reshape(2, 2),
                                axis_names=(mesh_ops.HOST_AXIS,
                                            mesh_ops.REPLICA_AXIS))
            grid1 = gossip.make_mesh2d(2, 2, device=device)
            checked = []
            for dtype in (torch.int64, torch.int32, torch.int16,
                          torch.bool):
                parts = [(torch.arange(6, device=dev).reshape(2, 3) * 10
                          + k).to(dtype) for k in range(K)]
                ring_ = [(i, (i + 1) % K) for i in range(K)]
                pairs = (
                    ("all_gather", mesh_ops.all_gather(parts, dev, pod),
                     mesh_ops.all_gather(parts, dev, single)),
                    ("all_gather2", mesh_ops.all_gather2(parts, grid),
                     mesh_ops.all_gather2(parts, grid1)),
                    ("broadcast", torch.stack(mesh_ops.broadcast(
                        parts[2], pod)), torch.stack(mesh_ops.broadcast(
                            parts[2], single))),
                    ("ppermute", torch.stack(mesh_ops.ppermute(
                        parts, ring_, pod)), torch.stack(mesh_ops.ppermute(
                            parts, ring_, single))),
                )
                for name, got, want in pairs:
                    if got.dtype != want.dtype or not torch.equal(got, want):
                        raise AssertionError(f"nccl {name} {dtype} != the "
                                             "mesh's copies")
                    checked.append(f"{name} {dtype}")
            return {"checked": checked, "backend": dist.get_backend()}

        steps = {
            "replay4": lambda s: replay(s, 4),
            "replay8": lambda s: replay(s, 8),
            "replayW": lambda s: replay(s, world),
            "fleet_sharded": lambda s: fleet_step(
                s, gossip.make_mesh(world, device=device), "sharded",
                pk_sites),
            "fleet_segments": lambda s: fleet_step(
                s, gossip.make_mesh(world, device=device), "segments",
                fl_sites),
            "hierarchical": lambda s: fleet_step(
                s, gossip.make_mesh2d(2, 2, device=device), "replicas",
                fl_sites),
            "stream": stream,
            "ring": ring,
            "multidoc": multidoc,
            "nccl_refused": nccl_refused,
            "nccl_collectives": nccl_collectives,
        }
        for step in cfg["steps"]:
            t0 = time.perf_counter()
            rec["steps"][step] = steps[step](step)
            rec["steps"][step]["step_s"] = time.perf_counter() - t0
        dist.destroy_process_group()
    except Exception:  # the record carries it to the parent
        rec["error"] = traceback.format_exc()
    path = work / f"{cfg['group']}_rank{rank}.json"
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps(rec, default=str))
    os.replace(tmp, path)
    return 0 if "error" not in rec else 1


def run_pod_group(group: str, world: int, backend: str, steps, work: Path,
                  device: str) -> list:
    """Start one group's ranks (this script with ``--pod-child``), each
    logging to its own file; returns their (process, log) pairs."""
    import subprocess

    import os

    env = dict(os.environ)
    if group == "nccl_refused":
        env["CUDA_VISIBLE_DEVICES"] = "0"  # two ranks on one card
    procs = []
    for rank in range(world):
        cfg = {"group": group, "rank": rank, "world": world,
               "backend": backend, "steps": list(steps), "device": device,
               "workdir": str(work), "spawned_at": time.time()}
        out = open(work / f"{group}_rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--pod-child",
             json.dumps(cfg)], cwd=ROOT, stdout=out,
            stderr=subprocess.STDOUT, env=env), out))
    return procs


def wait_pod_groups(groups: dict, work: Path) -> dict:
    """Join every rank of ``groups`` (name -> processes) under one
    deadline, kill what is left, and read each rank's record; a rank
    that wrote none gets its log's tail as its error."""
    deadline = time.monotonic() + POD_DEADLINE_S
    for procs in groups.values():
        for p, _ in procs:
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass  # killed below
    out = {}
    for group, procs in groups.items():
        recs = []
        for rank, (p, log_f) in enumerate(procs):
            if p.poll() is None:
                p.kill()
                p.wait()
            log_f.close()
            path = work / f"{group}_rank{rank}.json"
            if path.exists():
                recs.append(json.loads(path.read_text()))
            else:
                tail = Path(log_f.name).read_text()[-2000:]
                recs.append({"rank": rank, "error": f"no record (rc "
                             f"{p.returncode}): {tail}"})
        out[group] = recs
    return out


def pod_phase(torch, kernels, scale, results: dict, mt_cold,
              hold_kernel, max_err: dict, device: str = "cuda") -> list:
    """Phase 15: the multi-process pod on the card. Every rank is this
    script again (``--pod-child``) on ``cuda:0``, joined to a ``gloo``
    group through a ``file://`` init in a temp directory, running the
    unchanged entry points on the same inputs; it uploads and launches
    only its own mesh entries, and each collective reaches every rank
    through the group (host-staged under ``gloo``).

    (a) ``replay_trace(route="device")`` of ``scale`` under
        ``CRDT_TPU_SHARDS`` = 4 and 8 on 4 ranks (1, then 2 entries a
        rank): one ``shard.dispatches`` and K/4 launches of each converge
        kernel in every rank;
    (b) the stream route with its stream shards sharded over 2 ranks;
    (c) ``fleet_replay`` sharded and segment-sharded on 4 ranks, and the
        two-tier round on ``make_mesh2d(2, 2)`` over 2 ranks;
    (d) the ring delta on 4 ranks x 2 entries, budgets 4 and 16, card
        == CPU field by field;
    (e) ``MultiDocServer(shards=4)`` on phase 10's cold tenants, 4 ranks;
    (f) NCCL: a one-process ``nccl`` group drives the pod's collective
        code on CUDA tensors against the mesh's copies; a ``nccl`` pod
        of 2 ranks on one card is refused before any collective; with
        two or more cards, (a) and (c) again under ``nccl``, one rank a
        card.

    Every rank's caches, snapshots, digests and vectors must equal every
    other rank's and the single-controller results (phases 4-6, 10 and
    14): ``results`` holds phase 4's ``"device"``, phase 5's ``"fleet"``
    and phase 6's ``"stream"`` results of ``scale``, ``mt_cold`` phase
    10's cold tenants and digests. Every captured kernel input equals
    the plain version. Returns the kernels line's per-rank rows (the
    parent times each rank's captured inputs, alone on the card)."""
    import pickle
    import tempfile

    on_card = device == "cuda"
    t_phase = time.perf_counter()
    want = {
        "device": (_sha(results["device"].cache),
                   _sha(results["device"].snapshot)),
        "fleet": (_sha(results["fleet"].cache),
                  _sha(results["fleet"].snapshot)),
        "stream": (_sha(results["stream"].cache),
                   _sha(results["stream"].snapshot)),
    }
    docs, digests = mt_cold
    n_cards = torch.cuda.device_count() if on_card else 0
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        t0 = time.perf_counter()
        (work / "inputs.pkl").write_bytes(pickle.dumps(
            {"scale": scale, "mt_docs": docs}))
        log(f"pod: inputs written in {time.perf_counter() - t0:.3f} s "
            f"({(work / 'inputs.pkl').stat().st_size} bytes)")
        t0 = time.perf_counter()
        w, b, s = POD_GROUPS["A"]
        recs = wait_pod_groups({"A": run_pod_group("A", w, b, s, work,
                                                   device)}, work)
        log(f"pod group A (4 ranks, gloo): {time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        later = [g for g in ("B", "nccl_refused", "nccl_one")
                 if on_card or POD_GROUPS[g][1] == "gloo"]
        if n_cards >= 2:
            later.append("nccl_cards")
        started = {}
        for g in later:
            w, b, s = (POD_GROUPS[g] if g != "nccl_cards"
                       else (min(n_cards, 4), "nccl", POD_CARD_STEPS))
            started[g] = run_pod_group(g, w, b, s, work, device)
        recs.update(wait_pod_groups(started, work))
        log(f"pod groups {later}: {time.perf_counter() - t0:.3f} s "
            "(concurrently)")
        if not on_card:
            log("pod (f): not run: the nccl groups need the card")
        elif n_cards < 2:
            log("pod (f): (a) and (c) under nccl, one rank a card: not "
                f"run: {n_cards} card visible (NCCL refuses two ranks on "
                "one card)")
        bad = {g: [(r["rank"], r["error"]) for r in rs if "error" in r]
               for g, rs in recs.items()}
        bad = {g: v for g, v in bad.items() if v}
        if bad:
            raise AssertionError(f"pod: ranks failed: {bad}")
        saved = {}
        for step in POD_TIMED:
            for rank in range(4):
                path = work / f"kin_{step}_rank{rank}.pt"
                if path.exists():
                    saved[step, rank] = torch.load(path)

    def per_rank(g: str, step: str) -> list:
        return [r["steps"][step] for r in recs[g]]

    def check(g: str, step: str, want_pair, calls: dict) -> None:
        for rank, r in enumerate(per_rank(g, step)):
            if (r["cache"], r["snapshot"]) != want_pair:
                raise AssertionError(f"pod {g} {step}: rank {rank}'s result "
                                     "!= the single controller's")
            if r["calls"] != {k: v for k, v in calls.items() if v} or \
                    r["launches"] != dict(
                        dict.fromkeys(REPLACES, 0),
                        **(calls if on_card else {})):
                raise AssertionError(f"pod {g} {step} rank {rank}: calls "
                                     f"{r['calls']}, launches "
                                     f"{r['launches']}, want {calls}")
            if any(r["max_err"].values()):
                raise AssertionError(f"pod {g} {step} rank {rank}: kernel "
                                     f"!= plain {r['max_err']}")

    def report(g: str, step: str) -> None:
        for rank, r in enumerate(per_rank(g, step)):
            rr = recs[g][rank]
            sp, c = r["spans"], r["counters"]
            launched = {k: v for k, v in r["launches"].items() if v}
            coll = sum(v for k, v in sp.items() if k.startswith("mesh."))
            up = sum(v for k, v in c.items() if k.startswith("xfer."))
            log(f"pod {g} {step} rank {rank}/{len(recs[g])}: process start "
                f"{rr['start_s']:.3f} s (imports {rr['import_s']:.3f}), "
                f"group init {rr['group_init_s']:.3f} s, cuda "
                f"{rr.get('cuda_init_s', 0):.3f} s; step {r['wall']:.3f} s: "
                f"stage {sp.get('pack', 0):.3f}, upload "
                f"{up} bytes, dispatch {sp.get('converge.dispatch', 0):.3f}"
                f", collectives {coll:.3f} s ({c['mesh.collectives']}, "
                f"host-staged {c['mesh.staged_bytes']} bytes), fetch "
                f"{sp.get('converge.fetch', 0):.3f}, assembly "
                f"{sp.get('gather', 0) + sp.get('materialize', 0):.3f}; "
                f"spans {json.dumps({k: round(v, 4) for k, v in sp.items()})}"
                f"; launches {json.dumps(launched)}")

    # (a) the sharded cold replay, every rank == phase 4
    for step in ("replay4", "replay8"):
        K = per_rank("A", step)[0]["K"]
        check("A", step, want["device"],
              {"seg_argmax_scan": K // 4, "stream_scatter": K // 4})
        for rank, r in enumerate(per_rank("A", step)):
            if r["counters"]["shard.dispatches"] != 1 or \
                    r["path"] != "device":
                raise AssertionError(f"pod A {step} rank {rank}: "
                                     f"dispatches {r['counters']}")
        report("A", step)
        log(f"pod (a) replay_trace, CRDT_TPU_SHARDS={K}, 4 ranks: every "
            "rank == phase 4 byte for byte, one shard.dispatches and "
            f"{K // 4} launch(es) of each converge kernel a rank")
    # (b) the stream route, its shards sharded over 2 ranks
    st = per_rank("B", "stream")
    n_stream = st[0]["stream_shards"]
    check("B", "stream", want["stream"],
          {"seg_argmax_scan": n_stream, "stream_scatter": n_stream})
    for rank, r in enumerate(st):
        if r["counters"]["shard.dispatches"] != n_stream or n_stream < 2 \
                or r["path"] != "stream":
            raise AssertionError(f"pod B stream rank {rank}: {r['path']}, "
                                 f"{r['counters']}, {n_stream} shards")
    report("B", "stream")
    log(f"pod (b) stream route, {n_stream} stream shards each sharded over "
        f"2 ranks: every rank == phase 6; phases (s) rank 0 "
        f"{json.dumps(st[0]['phases'])}")
    # (c) fleet_replay in three mappings, every rank == phase 5
    for g, step, calls in (
            ("A", "fleet_sharded", {"seg_argmax_scan": 1,
                                    "stream_scatter": 1}),
            ("A", "fleet_segments", {"ds_mask": 1}),
            ("B", "hierarchical", {"ds_mask": 1, "sv_deficit": 1})):
        check(g, step, want["fleet"], calls)
        report(g, step)
        log(f"pod (c) fleet_replay {step} mesh "
            f"{per_rank(g, step)[0]['mesh']} over {len(recs[g])} ranks: "
            f"every rank == phase 5; calls a rank {calls}")
    # (d) the ring delta: every rank card == CPU, and == one controller
    ring = per_rank("A", "ring")
    from crdt_tpu_torch.parallel import delta, gossip

    rcols = delta.synth_resident_columns(RING_REPLICAS, 96, 8, seed=0)
    m = gossip.make_mesh(RING_REPLICAS, device="cpu")
    for budget in (4, 16):
        parts = [[torch.from_numpy(rcols[c][i:i + 1].copy())
                  for i in range(RING_REPLICAS)] for c in delta.COL_NAMES]
        one = delta.make_ring_delta_step(m, RING_REPLICAS + 2, budget)(
            *parts)
        want_ring = _sha(b"".join(v.numpy().tobytes() for v in one))
        rings = ring + (per_rank("nccl_cards", "ring")
                        if "nccl_cards" in recs else [])
        if any(r[str(budget)] != want_ring for r in rings):
            raise AssertionError(f"pod (d) ring budget {budget}: a rank != "
                                 "the single controller")
    log("pod (d) ring delta, 4 ranks x 2 entries, budgets 4 and 16: every "
        "rank card == CPU field by field == one controller; walls rank 0 "
        f"{json.dumps({k: round(v, 4) for k, v in ring[0]['wall'].items()})}")
    # (e) MultiDocServer(shards=4), every digest == phase 10's
    want_dig = {str(d): v for d, v in digests.items()}
    for rank, r in enumerate(per_rank("A", "multidoc")):
        if r["digests"] != want_dig or r["fallback"]:
            raise AssertionError(f"pod (e) rank {rank}: digests != phase "
                                 "10's")
        n_sh = r["counters"]["shard.dispatches"]
        # a sharded batch launches once in each rank (one entry a rank),
        # a packed one in every rank
        each = n_sh + (r["dispatches"] - n_sh)
        want_l = dict.fromkeys(REPLACES, 0)
        if on_card:
            want_l.update(seg_argmax_scan=each, stream_scatter=each)
        if n_sh < 1 or r["launches"] != want_l or any(
                r["max_err"].values()):
            raise AssertionError(f"pod (e) rank {rank}: {n_sh} sharded of "
                                 f"{r['dispatches']} batches, launches "
                                 f"{r['launches']}")
    report("A", "multidoc")
    log(f"pod (e) MultiDocServer(shards={MESH_K}), 4 ranks: {len(docs)} "
        "cold tenants, every digest == phase 10's in every rank; "
        f"{per_rank('A', 'multidoc')[0]['counters']['shard.dispatches']} "
        "sharded batch(es) a tick")
    # (f) NCCL
    if on_card:
        for r in per_rank("nccl_refused", "nccl_refused"):
            if not r["refused"] or "gloo" not in r["refused"]:
                raise AssertionError(f"pod (f): a nccl pod of 2 ranks on one "
                                     f"card was not refused: {r}")
        one = per_rank("nccl_one", "nccl_collectives")[0]
        log("pod (f) nccl: a 2-rank nccl group seeing one card "
            "refused before any collective ("
            f"{per_rank('nccl_refused', 'nccl_refused')[0]['refused'][:80]}"
            f"...); a one-process {one['backend']} group: the pod's "
            f"collectives on CUDA tensors == the mesh's copies "
            f"({len(one['checked'])} checks)")
    if "nccl_cards" in recs:
        W = len(recs["nccl_cards"])
        check("nccl_cards", "replayW", want["device"],
              {"seg_argmax_scan": 1, "stream_scatter": 1})
        check("nccl_cards", "fleet_sharded", want["fleet"],
              {"seg_argmax_scan": 1, "stream_scatter": 1})
        check("nccl_cards", "fleet_segments", want["fleet"], {"ds_mask": 1})
        for step in POD_CARD_STEPS[:-1]:
            report("nccl_cards", step)
        log(f"pod (f) nccl, {W} ranks one a card: (a) and (c) == phases 4 "
            "and 5 in every rank, the ring delta (its pairs across ranks "
            "sent and received) == one controller")

    # each rank's call sites, timed here alone on the card
    rows = []
    if on_card:
        smi = smi_line()
        for (step, rank), seen in sorted(saved.items()):
            g = "B" if step == "hierarchical" else "A"
            r = recs[g][rank]["steps"][step]
            seen = {name: [tuple(a.to("cuda") if hasattr(a, "to") else a
                                 for a in args) for args in calls]
                    for name, calls in seen.items()}
            for name, calls in seen.items():
                for args in calls:
                    hold_kernel(name, *args)
            got = kernel_rows(torch, kernels, seen, r["launches"], max_err)
            for row in got:
                row["path"] = "pod"
                row["rank"] = rank
                row["site"] = POD_TIMED[step]
            log(f"kernel times (pod, rank {rank}, {POD_TIMED[step]}; card "
                f"{smi}): " + json.dumps(got))
            rows += got
    log(f"phase 15: {time.perf_counter() - t_phase:.1f} s")
    return rows


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
        # library yardstick: the run ids by one cumsum, then one cummax
        # of a packed int64 key (run, client + 1, 2^21 - 1 - position)
        # whose argmax is the larger client, then the earlier position;
        # right only where each field fits its 21 bits
        run = torch.cumsum(flags != 0, 0)
        fits = m <= 1 << 21 and (not m or (
            int(run[-1]) < 1 << 21 and int(client.min()) >= -1
            and int(client.max()) + 1 < 1 << 21))
        library = None
        if fits:
            pos = torch.arange(m, dtype=torch.int64, device=client.device)

            def library():
                r = torch.cumsum(flags != 0, 0)
                key = (r << 42) | ((client.long() + 1) << 21) \
                    | ((1 << 21) - 1 - pos)
                return torch.cummax(key, 0).indices

            got = library().to(torch.int32)
            if not torch.equal(got, kernels.seg_argmax_scan_plain(client,
                                                                  flags)):
                raise AssertionError("seg_argmax_scan: the cumsum + cummax "
                                     "yardstick != plain")
        rows.append(row("seg_argmax_scan", {"M": m}, (client, flags),
                        library, 3 * 4 * m))
        rows[-1]["library"] = (
            "cumsum + cummax of a packed int64 key" if fits else
            "none: the packed key's 21-bit fields do not fit these inputs")
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
