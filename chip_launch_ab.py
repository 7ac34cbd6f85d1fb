#!/usr/bin/env python3
"""A/B of the launch designs of ``seg_argmax_scan`` and
``stream_scatter`` on one CUDA card.

    python3 chip_launch_ab.py [--parent DIR] [--vary NAME=V,...] [--rounds N]

Builds variants of the two kernels from ``crdt_tpu_torch/csrc``:

  pdl      the sources as they stand: the scan launched as the
           programmatic dependent (PDL) of the kernel that clears its
           look-back state, the scatter as the dependent of the fill;
  plain    the same kernels with the PDL launch attribute off, so each
           launch waits for the one before it on the stream;
  NAME=V   with ``--vary NAME=V1,V2``: the sources with the constant
           ``constexpr int NAME`` set to each V in place of their own
           (``kItems``, elements a thread: the scan takes multiples of
           4; ``kFillBlocksPerSm``, the scatter's fill grid);
  coop     ``stream_scatter`` only: one cooperative kernel, fill, grid
           barrier, scatter (``cudaLaunchCooperativeKernel``);
  parent   with ``--parent DIR``: the two kernels of another checkout
           (such as the parent commit, unpacked by ``git archive``).

Each variant is held exactly against the plain PyTorch version on the
inputs the device route gives the kernels (captured from replays of the
1000 x 100 and 1000 x 1600 traces) and on short edge cases, then timed
by CUDA events around a CUDA-graph replay of 50 calls, in turns (the
order of the variants reverses every round), median over the rounds.
A profiler trace of 20 calls then splits each variant's device time
by kernel (a lower bound: the trace may lose activities; a PDL launch
counts its wait for the kernel before it). Prints the card, one JSON
line per kernel and shape, and writes them to
``chiprun_out/launch_ab.json``. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
AB_DIR = ROOT / "crdt_tpu_torch" / "build" / "launch_ab"

# one kernel: fill the holes, a grid barrier, scatter (a variant only)
COOP_SCATTER = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

constexpr int kThreads = 256;

__device__ __forceinline__ void put(int* out, int n_out, int t, int i) {
  if (static_cast<unsigned>(t) < static_cast<unsigned>(n_out)) out[t] = i;
}

__global__ void __launch_bounds__(kThreads)
fill_then_scatter(const int* pos, int n_in, int* out, int n_out) {
  const int stride = gridDim.x * kThreads;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int n4 = n_out >> 2;
  for (int i = t; i < n4; i += stride)
    reinterpret_cast<int4*>(out)[i] = make_int4(-1, -1, -1, -1);
  if (t < (n_out & 3)) out[(n4 << 2) + t] = -1;
  cg::this_grid().sync();
  for (int i = t; i < n_in; i += stride) put(out, n_out, pos[i], i);
}

extern "C" int stream_scatter_launch(const int* pos, int n_in, int* out,
                                     int n_out, void* stream) {
  if (n_out <= 0) return 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fill_then_scatter,
                                                kThreads, 0);
  const int most = n_in > n_out ? n_in : n_out;
  int blocks = ((most >> 2) + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > per_sm * sms) blocks = per_sm * sms;
  void* args[] = {&pos, &n_in, &out, &n_out};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(fill_then_scatter), blocks, kThreads, args, 0,
      static_cast<cudaStream_t>(stream));
  return e != cudaSuccess ? static_cast<int>(e)
                          : static_cast<int>(cudaGetLastError());
}
"""


def log(msg: str) -> None:
    print(msg, flush=True)


def edited_tree(variant: str, edits: dict) -> Path:
    """A copy of ``csrc`` under ``AB_DIR`` with ``edits``, {file:
    (pattern, replacement)} applied (each pattern must match once)."""
    tree = AB_DIR / f"{variant}_src"
    shutil.copytree(ROOT / "crdt_tpu_torch" / "csrc", tree)
    for name, (pattern, new) in edits.items():
        path = tree / name
        text, count = re.subn(pattern, new, path.read_text())
        if count != 1:
            raise RuntimeError(f"{name}: {pattern!r} matched {count} times")
        path.write_text(text)
    return tree


def variant_sources(parent, vary) -> dict:
    """{variant: {kernel: .cu path}}, the variant trees written under
    ``AB_DIR``."""
    csrc = ROOT / "crdt_tpu_torch" / "csrc"
    names = ("seg_argmax_scan", "stream_scatter")
    if AB_DIR.exists():
        shutil.rmtree(AB_DIR)
    out = {"pdl": {k: csrc / f"{k}.cu" for k in names}}
    plain = edited_tree("plain", {"lookback.cuh": (
        r"programmaticStreamSerializationAllowed = 1;",
        "programmaticStreamSerializationAllowed = 0;")})
    out["plain"] = {k: plain / f"{k}.cu" for k in names}
    for const, n in vary:
        variant = f"{const}={n}"
        new = f"constexpr int {const} = {n};"
        kernels = [k for k in names
                   if re.search(rf"constexpr int {const} = \d+;",
                                (csrc / f"{k}.cu").read_text())
                   and new not in (csrc / f"{k}.cu").read_text()
                   and not (k == "seg_argmax_scan" and const == "kItems"
                            and n % 4)]
        if kernels:
            tree = edited_tree(variant, {
                f"{k}.cu": (rf"constexpr int {const} = \d+;", new)
                for k in kernels})
            out[variant] = {k: tree / f"{k}.cu" for k in kernels}
    coop = AB_DIR / "coop_src" / "stream_scatter.cu"
    coop.parent.mkdir(parents=True)
    coop.write_text(COOP_SCATTER)
    out["coop"] = {"stream_scatter": coop}
    if parent:
        pdir = Path(parent) / "crdt_tpu_torch" / "csrc"
        out["parent"] = {k: pdir / f"{k}.cu" for k in names}
    return out


def build(sources: dict) -> dict:
    """{(variant, kernel): CDLL or the build error}: each library built
    by the port's own builder with the port's flags, one nvcc per
    library, all started together (a failed variant is then built
    alone, to tell it from the rest)."""
    from crdt_tpu_torch.ops import _build

    recipes = {
        (variant, name): _build.Recipe(
            f"{variant}_{name}", src, AB_DIR / variant, _build.NVCC_FLAGS,
            headers="*.cuh", compiler="nvcc", error=_build.KernelError)
        for variant, kernels in sources.items()
        for name, src in kernels.items()}
    try:
        built = _build.build(list(recipes.values()))
    except _build.KernelError:
        built = {}
        for r in recipes.values():
            try:
                built.update(_build.build([r]))
            except _build.KernelError as e:
                built[r.name] = f"build failed: {str(e)[-2000:]}"
    libs = {}
    for key, r in recipes.items():
        b = built[r.name]
        if isinstance(b, str):
            libs[key] = b
            continue
        regs = [ln.strip() for ln in b.log.splitlines() if "registers" in ln]
        log(f"build {key}: {' | '.join(regs)}")
        libs[key] = ctypes.CDLL(str(b.path))
    return libs


def caller(torch, name: str, lib):
    """The variant's launch as a wrapper like ``ops/kernels.py``'s,
    taking aligned contiguous inputs."""
    from crdt_tpu_torch.ops import _build

    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    stream = lambda t: torch.cuda.current_stream(t.device).cuda_stream
    launch = getattr(lib, f"{name}_launch")
    launch.restype = I
    if name == "stream_scatter":
        launch.argtypes = [P, I, P, I, P]

        def scatter(pos, n_out):
            out = torch.empty(n_out, dtype=torch.int32, device=pos.device)
            _build.check(launch(pos.data_ptr(), pos.numel(), out.data_ptr(),
                                n_out, stream(pos)), f"{name} launch")
            return out
        return scatter
    launch.argtypes = [P, P, P, P, I, P]
    if hasattr(lib, "seg_argmax_scan_scratch_words"):
        words = lib.seg_argmax_scan_scratch_words
        words.restype, words.argtypes = L, [I]
        scratch_of = lambda n, dev: torch.empty(words(n), dtype=torch.int64,
                                                device=dev)
    else:  # the three-kernel scan: tiles x scratch_ints int32
        lib.seg_argmax_scan_tile.restype = I
        lib.seg_argmax_scan_scratch_ints.restype = I
        tile = lib.seg_argmax_scan_tile()
        ints = lib.seg_argmax_scan_scratch_ints()
        scratch_of = lambda n, dev: torch.empty(
            max(-(-n // tile), 1) * ints, dtype=torch.int32, device=dev)

    def scan(client, flags):
        n = client.numel()
        out = torch.empty(n, dtype=torch.int32, device=client.device)
        scratch = scratch_of(n, client.device)
        _build.check(launch(client.data_ptr(), flags.data_ptr(),
                            out.data_ptr(), scratch.data_ptr(), n,
                            stream(client)), f"{name} launch")
        return out
    return scan


def kernel_split(torch, fn, calls: int = 20) -> dict:
    """{device kernel name: traced microseconds a call} over a profiler
    trace of ``calls`` calls of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0].split("::")[-1]
            split[name] = split.get(name, 0.0) + \
                e.time_range.elapsed_us() / calls
    return split


def main_path_inputs(torch) -> dict:
    """{kernel: [(label, args)]}: the first call of each kernel in a
    device-route replay of each trace."""
    import chip_smoke
    from crdt_tpu_torch.models import replay as rp
    from crdt_tpu_torch.models import traces
    from crdt_tpu_torch.ops import packed as packed_mod

    out: dict = {"seg_argmax_scan": [], "stream_scatter": []}
    for label, (r, ops) in (("1000x100", (1000, 100)),
                            ("1000x1600", (1000, 1600))):
        blobs = traces.build_trace(r, ops, seed=0)
        seen: dict = {}
        with chip_smoke.capture_kernel_inputs(
                seen, (packed_mod, "seg_argmax_scan"),
                (packed_mod, "stream_scatter")):
            rp.replay_trace(blobs, device="cuda")
        torch.cuda.synchronize()
        for name in out:
            out[name].append((label, seen[name][0]))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="checkout whose kernels to add")
    ap.add_argument("--vary", action="append", default=[],
                    help="NAME=V1,V2: variants with constexpr int NAME = V")
    ap.add_argument("--rounds", type=int, default=6)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("chip_launch_ab: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    from crdt_tpu_torch.ops import _build, kernels

    smi = chip_smoke.smi_line()
    log(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    vary = [(name, int(v)) for spec in args.vary
            for name, values in [spec.split("=", 1)]
            for v in values.split(",")]
    libs = build(variant_sources(args.parent, vary))
    dev = torch.device("cuda")
    inputs = main_path_inputs(torch)
    g = torch.Generator(device="cpu").manual_seed(1)

    def ri(lo, hi, n, dtype=torch.int32):
        return torch.randint(lo, hi, (n,), generator=g,
                             dtype=dtype).to(dev)

    fns, broken = {}, {}
    for (variant, name), lib in libs.items():
        if isinstance(lib, str):
            broken[(variant, name)] = lib
            continue
        fn = caller(torch, name, lib)
        plain = getattr(kernels, name + "_plain")

        def hold(kname, *a, fn=fn, plain=plain, variant=variant):
            a = [kernels.aligned16(x) if hasattr(x, "data_ptr") else x
                 for x in a]
            got, want = fn(*a), plain(*a)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{variant} {kname}: kernel != plain")
        try:
            for _, a in inputs[name]:
                hold(name, *a)
            if name == "seg_argmax_scan":
                lib.seg_argmax_scan_tile.restype = ctypes.c_int
                chip_smoke.scan_edge_cases(torch, dev, ri, hold,
                                           lib.seg_argmax_scan_tile())
            else:
                chip_smoke.scatter_edge_cases(torch, dev, g, ri, hold)
        except (AssertionError, RuntimeError, _build.KernelError) as e:
            broken[(variant, name)] = str(e).splitlines()[0]
            continue
        fns[(variant, name)] = fn
    for key, why in broken.items():
        log(f"variant {key} left out: {why}")

    # the first profiling session of a process may trace no device
    # activity while CUPTI starts up: open and discard one
    kernel_split(torch, lambda: torch.ones(1, device=dev), 1)
    rows = []
    for name in ("seg_argmax_scan", "stream_scatter"):
        variants = [v for (v, k) in fns if k == name]
        for label, a in inputs[name]:
            times = {v: [] for v in variants}
            for rnd in range(args.rounds):
                order = variants if rnd % 2 == 0 else variants[::-1]
                for v in order:
                    f = fns[(v, name)]
                    try:
                        times[v].append(chip_smoke.graph_ms(
                            torch, lambda: f(*a), 50, batches=3))
                    except RuntimeError as e:
                        torch.cuda.synchronize()
                        times[v] = f"capture failed: {str(e).splitlines()[0]}"
                        variants = [x for x in variants if x != v]
                        break
            shape = ({"M": a[0].numel()} if name == "seg_argmax_scan"
                     else {"B": a[0].numel(), "n_out": a[1]})
            split = {v: kernel_split(torch, lambda f=fns[(v, name)]: f(*a))
                     for v in variants}
            row = {"kernel": name, "trace": label, "shape": shape,
                   "card": smi, "ms_source": "cuda graph",
                   "median_ms": {v: (statistics.median(t)
                                     if isinstance(t, list) else t)
                                 for v, t in times.items()},
                   "traced_us_by_kernel": split, "ms": times}
            log(json.dumps(row))
            rows.append(row)
    out = ROOT / "chiprun_out" / "launch_ab.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(rows, indent=1))
    # the committed design must build, hold and time in a graph
    ok = all(("pdl", k) in fns for k in ("seg_argmax_scan", "stream_scatter"))
    ok = ok and all(isinstance(r["ms"].get("pdl"), list) for r in rows)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
