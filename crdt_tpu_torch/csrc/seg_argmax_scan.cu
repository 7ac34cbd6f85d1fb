// Segmented inclusive argmax scan for Hopper (sm_90a).
//
// Replaces: crdt_tpu/ops/pallas_kernels.py `_seg_argmax_kernel` (wrapper
// `seg_argmax_scan`, oracle `seg_argmax_scan_jnp`), the LWW map-winner
// scan of `ops/packed.py:_map_block`.
//
// Semantics: out[i] is the position of the (max client, earliest
// position) element of i's run prefix, where a run starts at every
// position whose flag is nonzero (position 0 always opens one). The
// combine operator on (client, arg, flag) is the oracle's:
//   combine(x, y) = y                      if y.flag
//                 = better(x, y), x.f|y.f  otherwise
// with better = larger client, ties to the smaller (earlier) arg.
//
// What bounds it on this card: bytes. Per element it reads 8 bytes
// (client, flag) and writes 4; there is no arithmetic to speak of.
// The TPU kernel held the whole block in VMEM and ran log2(N) roll
// rounds; VMEM capped it at 2^17 rows. Here the block is tiled:
//   1. tile_reduce: each block reduces one tile (kThreads * kItems
//      elements) to its aggregate (client, arg, flag);
//   2. carry_scan:  one block scans the tile aggregates into each
//      tile's exclusive carry (a few hundred tiles at the scale run);
//   3. tile_scan:   each block re-reads its tile, scans it (thread-
//      sequential over kItems, warp shuffles, then across warps in
//      shared memory) seeded with its carry, and writes the result.
// So any M works, and the input is read twice and the output written
// once: ~2.5x the byte bound, with no atomics and no look-back. A
// single-pass decoupled look-back is the known next step.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kCarryThreads = 1024;

struct State {
  int c;  // best client so far
  int a;  // its position
  int f;  // a run start lies inside the window
};

__device__ __forceinline__ State identity() { return {INT_MIN, INT_MAX, 0}; }

// x covers the positions before y's
__device__ __forceinline__ State combine(State x, State y) {
  if (y.f) return y;
  const bool take_x = (x.c > y.c) || (x.c == y.c && x.a < y.a);
  State r = take_x ? x : y;
  r.f = x.f | y.f;
  return r;
}

__device__ __forceinline__ State shfl_up(State v, int d) {
  v.c = __shfl_up_sync(0xffffffffu, v.c, d);
  v.a = __shfl_up_sync(0xffffffffu, v.a, d);
  v.f = __shfl_up_sync(0xffffffffu, v.f, d);
  return v;
}

__device__ __forceinline__ State warp_inclusive(State v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const State o = shfl_up(v, d);
    if (lane >= d) v = combine(o, v);
  }
  return v;
}

// Exclusive scan of one State per thread across the block; *total gets
// the combine of all of them. Every thread of the block must call it.
template <int kBlock>
__device__ State block_exclusive(State v, State* total) {
  constexpr int kWarps = kBlock / 32;
  __shared__ State warp_tot[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const State inc = warp_inclusive(v);
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    State w = lane < kWarps ? warp_tot[lane] : identity();
    w = warp_inclusive(w);
    if (lane < kWarps) warp_tot[lane] = w;
  }
  __syncthreads();
  State ex = shfl_up(inc, 1);
  if (lane == 0) ex = identity();
  const State prefix = warp == 0 ? identity() : warp_tot[warp - 1];
  *total = warp_tot[kWarps - 1];
  __syncthreads();  // warp_tot is reused by the next call
  return combine(prefix, ex);
}

__device__ __forceinline__ State load(const int* client, const int* flags,
                                      int i) {
  return {client[i], i, flags[i] != 0};
}

__global__ void __launch_bounds__(kThreads)
tile_reduce(const int* __restrict__ client, const int* __restrict__ flags,
            int n, State* __restrict__ agg) {
  const int start = blockIdx.x * kTile + threadIdx.x * kItems;
  State v = identity();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = start + k;
    if (i < n) v = combine(v, load(client, flags, i));
  }
  State total;
  block_exclusive<kThreads>(v, &total);
  if (threadIdx.x == 0) agg[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kCarryThreads)
carry_scan(const State* __restrict__ agg, int tiles,
           State* __restrict__ carry) {
  State run = identity();
  for (int base = 0; base < tiles; base += kCarryThreads) {
    const int t = base + threadIdx.x;
    const State v = t < tiles ? agg[t] : identity();
    State total;
    const State ex = block_exclusive<kCarryThreads>(v, &total);
    if (t < tiles) carry[t] = combine(run, ex);
    run = combine(run, total);
  }
}

__global__ void __launch_bounds__(kThreads)
tile_scan(const int* __restrict__ client, const int* __restrict__ flags,
          int n, const State* __restrict__ carry, int* __restrict__ out) {
  const int start = blockIdx.x * kTile + threadIdx.x * kItems;
  State items[kItems];
  State v = identity();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = start + k;
    items[k] = i < n ? load(client, flags, i) : identity();
    v = combine(v, items[k]);
  }
  State total;
  const State ex = block_exclusive<kThreads>(v, &total);
  State run = combine(carry[blockIdx.x], ex);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    run = combine(run, items[k]);
    if (start + k < n) out[start + k] = run.a;
  }
}

}  // namespace

extern "C" {

// Elements per tile; the wrapper sizes the scratch from it.
int seg_argmax_scan_tile() { return kTile; }

// Ints of scratch per tile (aggregate + carry, three ints each).
int seg_argmax_scan_scratch_ints() {
  return 2 * static_cast<int>(sizeof(State) / sizeof(int));
}

// client, flags, out: [n] int32 on the device. scratch: at least
// tiles * seg_argmax_scan_scratch_ints() int32, tiles = ceil(n / tile).
// Launches on `stream` and returns cudaGetLastError().
int seg_argmax_scan_launch(const int* client, const int* flags, int* out,
                           int* scratch, int n, void* stream) {
  if (n <= 0) return 0;
  const int tiles = (n + kTile - 1) / kTile;
  State* agg = reinterpret_cast<State*>(scratch);
  State* carry = agg + tiles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  tile_reduce<<<tiles, kThreads, 0, s>>>(client, flags, n, agg);
  carry_scan<<<1, kCarryThreads, 0, s>>>(agg, tiles, carry);
  tile_scan<<<tiles, kThreads, 0, s>>>(client, flags, n, carry, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
