// Delete-set membership for Hopper (sm_90a).
//
// Replaces: crdt_tpu/ops/pallas_kernels.py `_ds_mask_kernel` (wrapper
// `ds_mask_static`), the tombstone mask of `ops/deleteset.py:
// apply_mask_static`, which `ops/merge.py:converge_maps` runs on every
// fleet round.
//
// Semantics (the TPU kernel's dense ones): out[i] = valid[i] and some
// range d has client[i] == d_client[d] and d_start[d] <= clock[i] <
// d_end[d], exact over int64, overlapping ranges included.
//
// Design. The TPU kernel holds the ranges in SMEM and walks all D of
// them for every block of items: O(N * D), hopeless at the D = 131,072
// ranges of the 1000x1600 fleet round. Here a binary search finds, for
// each item, the last range whose key (client, start) is <= the item's
// (client, clock): the item is deleted iff that range has the
// item's client and the running max of `end` over that client's ranges
// up to it is > clock. That running max covers every same-client range
// starting at or before the clock, so the test is the dense one.
//
// Search order compares the client as an UNSIGNED 64-bit value, so a
// negative client (the null fillers, client -1) orders after every real
// range, and the fleet's [3, D] block (a normalized delete set, sorted
// by client and start, then trailing nulls) is already in search
// order. So the range preparation sorts nothing on the main path:
//   1. run_max_scan: one pass over the given ranges that checks their
//      order (a device flag, `disorder`) and takes the running max of
//      `end` as the prefix max of (client, end) compared
//      lexicographically: clients never decrease along a sorted order,
//      so the prefix max holds the current client and its largest end
//      so far. Single pass: tiles of 2,048 ranges chained by
//      decoupled look-back.
//   2. order_tile, merge_runs (log8(D / kSortTile) passes), then
//      run_max_scan again on the sorted copy: a merge sort by rank
//      (each element's place = its place in its run + the count of
//      keys before it in the other runs it merges with, found by
//      binary search), first two runs at a time in shared memory, then
//      eight at a time across tiles in device memory.
//      Every one of these kernels reads `disorder` first and returns at
//      once when it is 0, so in-order ranges pay a few empty launches.
//   Both scans write the search's arrays, keys (client, start) as one
//   16-byte load and the running max, so the sorted scan overwrites
//   the first one's and ds_search reads one set. The host never reads
//   the flag.
//
// What bounds it on this card: bytes (13 read, 1 written per item plus
// the ranges once), but a binary search adds log2(D) dependent loads
// per item (17 at D = 131,072), and the preparation a few launches.
// Sorting the ranges with library calls on every call took about 80
// device activities, far more than the search. Here the sort is
// skipped on the device when the ranges arrive in order. The search
// reads the prepared ranges from global memory: staging all D of them
// in shared memory would cost more than the search (at the 1000x100
// shapes, N = 512,000 and D = 8,192, every block would copy 192 KB,
// about 100 MB in all), and the upper levels of the search, which every
// item reads, stay in L1.

#include <cuda_runtime.h>

#include <climits>

#include "lookback.cuh"

namespace {

typedef long long i64;
typedef unsigned long long u64;

constexpr unsigned kFull = 0xffffffffu;

// Shared-memory slot of a tile's j-th range: one pad word every 16, so
// the blocked reads (a thread's kScanItems neighbours) and the striped
// ones (a warp's 32 neighbours) both meet few bank conflicts.
__host__ __device__ constexpr int slot(int j) { return j + (j >> 4); }

constexpr int kScanThreads = 256;
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kScanItems = 8;  // neighbouring ranges a scan thread takes
constexpr int kScanTile = kScanThreads * kScanItems;
constexpr int kSortThreads = 256;
constexpr int kSortTile = 1024;  // ranges a block sorts in shared memory
constexpr int kMergeThreads = 256;
constexpr int kMergeWays = 8;  // runs merged by one merge_runs pass
constexpr int kThreads = 256;
constexpr int kItems = 4;  // items a search thread takes
constexpr int kBlockItems = kThreads * kItems;

using lookback::kAggregate;
using lookback::kEmpty;
using lookback::kPrefix;
using lookback::publish;
using lookback::status_of;

__device__ __forceinline__ bool key_lt(u64 c1, i64 s1, u64 c2, i64 s2) {
  return c1 < c2 || (c1 == c2 && s1 < s2);
}

__device__ __forceinline__ bool key_le(u64 c1, i64 s1, u64 c2, i64 s2) {
  return c1 < c2 || (c1 == c2 && s1 <= s2);
}

// (client, end) under lexicographic max; the client compares unsigned
struct Pair {
  u64 c;
  i64 e;
};

__device__ __forceinline__ Pair pair_identity() { return {0ull, LLONG_MIN}; }

__device__ __forceinline__ Pair lexmax(Pair x, Pair y) {
  if (x.c != y.c) return x.c > y.c ? x : y;
  return {x.c, x.e > y.e ? x.e : y.e};
}

__device__ __forceinline__ Pair shfl_up(Pair v, int d) {
  v.c = __shfl_up_sync(kFull, v.c, d);
  v.e = __shfl_up_sync(kFull, v.e, d);
  return v;
}

__device__ __forceinline__ Pair shfl_idx(Pair v, int src) {
  v.c = __shfl_sync(kFull, v.c, src);
  v.e = __shfl_sync(kFull, v.e, src);
  return v;
}

// Inclusive lexmax scan of one Pair per lane across the warp.
__device__ __forceinline__ Pair warp_inclusive(Pair v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Pair o = shfl_up(v, d);
    if (lane >= d) v = lexmax(o, v);
  }
  return v;
}

__device__ __forceinline__ Pair load_cg(const Pair* p) {
  return {__ldcg(&p->c), __ldcg(&p->e)};
}

// The search's arrays from ranges in search order: keys[i] = (client,
// start) and run_max[i], the running max of `end` over the client's
// ranges up to i. With `check`, also sets *disorder when some range's
// key is below its predecessor's; with `only_if_disorder` it returns at
// once unless *disorder is set.
//
// The tile is loaded and stored in rows of kScanThreads neighbouring
// ranges (coalesced) and handed through shared memory to the scan, in
// which a thread takes kScanItems neighbours: a thread-sequential
// lexmax, one warp shuffle scan, warp totals scanned by warp 0, which
// also finds the tile's carry by decoupled look-back, 32 predecessors at
// a time. Tiles are numbered in launch order from *counter, so a tile's
// predecessors are already running when it looks back; a launch of one
// tile (d <= kScanTile) needs no look-back.
__global__ void __launch_bounds__(kScanThreads)
run_max_scan(const i64* __restrict__ c, const i64* __restrict__ s,
             const i64* __restrict__ e, int d, longlong2* __restrict__ keys,
             i64* __restrict__ run_max, int* counter, int* status,
             Pair* aggregate, Pair* inclusive, int* disorder, int check,
             int only_if_disorder) {
  if (only_if_disorder && *disorder == 0) return;
  // one tile needs no look-back, so no zeroed counter or status either
  __shared__ int tile_sh;
  __shared__ u64 c_sh[slot(kScanTile)];
  __shared__ i64 e_sh[slot(kScanTile)];  // ends, then running maxima
  __shared__ Pair warp_sh[kScanWarps];
  __shared__ Pair carry_sh;
  if (threadIdx.x == 0) tile_sh = gridDim.x > 1 ? atomicAdd(counter, 1) : 0;
  __syncthreads();
  const int tile = tile_sh;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int base = tile * kScanTile;

  bool bad = false;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    const int j = k * kScanThreads + threadIdx.x;
    const int i = base + j;
    const bool in = i < d;
    const u64 ci = in ? static_cast<u64>(c[i]) : 0;
    const i64 si = in ? s[i] : LLONG_MIN;
    c_sh[slot(j)] = ci;
    e_sh[slot(j)] = in ? e[i] : LLONG_MIN;
    if (in) keys[i] = make_longlong2(static_cast<i64>(ci), si);
    if (check) {
      u64 qc = __shfl_up_sync(kFull, ci, 1);
      i64 qs = __shfl_up_sync(kFull, si, 1);
      if (lane == 0 && in && i > 0) {
        qc = static_cast<u64>(c[i - 1]);
        qs = s[i - 1];
      }
      if (in && i > 0 && key_lt(ci, si, qc, qs)) bad = true;
    }
  }
  const int any = __syncthreads_or(bad);
  // a single tile writes the flag; several only raise it (zeroed)
  if (check && threadIdx.x == 0 && (any || gridDim.x == 1)) *disorder = any;

  const int first = threadIdx.x * kScanItems;
  Pair v = pair_identity();
#pragma unroll
  for (int k = 0; k < kScanItems; ++k)
    v = lexmax(v, {c_sh[slot(first + k)], e_sh[slot(first + k)]});
  const Pair inc = warp_inclusive(v);
  if (lane == 31) warp_sh[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const Pair w = warp_inclusive(lane < kScanWarps ? warp_sh[lane]
                                                    : pair_identity());
    const Pair total = shfl_idx(w, 31);
    Pair ex = shfl_up(w, 1);
    if (lane == 0) ex = pair_identity();
    if (lane < kScanWarps) warp_sh[lane] = ex;  // each warp's prefix
    Pair carry = pair_identity();
    if (gridDim.x > 1) {
      if (tile == 0) {
        if (lane == 0) publish(&inclusive[0], &status[0], total, kPrefix);
      } else {
        if (lane == 0)
          publish(&aggregate[tile], &status[tile], total, kAggregate);
        // lane 31 reads the nearest predecessor; stop at the nearest
        // tile that has published its inclusive prefix
        for (int end = tile;; end -= 32) {
          const int p = end - 32 + lane;
          int st = kAggregate;  // before tile 0: nothing to add
          do {
            if (p >= 0) st = status_of(&status[p]);
          } while (__any_sync(kFull, st == kEmpty));
          const unsigned prefixes = __ballot_sync(kFull, st == kPrefix);
          const int top = prefixes ? 31 - __clz(prefixes) : -1;
          Pair x = pair_identity();
          if (p >= 0 && lane >= top)
            x = load_cg(st == kPrefix ? &inclusive[p] : &aggregate[p]);
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
            Pair y;
            y.c = __shfl_xor_sync(kFull, x.c, o);
            y.e = __shfl_xor_sync(kFull, x.e, o);
            x = lexmax(x, y);
          }
          carry = lexmax(carry, x);
          if (top >= 0) break;
        }
        if (lane == 0)
          publish(&inclusive[tile], &status[tile], lexmax(carry, total),
                  kPrefix);
      }
    }
    if (lane == 0) carry_sh = carry;
  }
  __syncthreads();
  Pair ex = shfl_up(inc, 1);
  if (lane == 0) ex = pair_identity();
  Pair run = lexmax(lexmax(carry_sh, warp_sh[warp]), ex);
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    run = lexmax(run, {c_sh[slot(first + k)], e_sh[slot(first + k)]});
    e_sh[slot(first + k)] = run.e;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    const int j = k * kScanThreads + threadIdx.x;
    if (base + j < d) run_max[base + j] = e_sh[slot(j)];
  }
}

// Place of element `j` (of a run starting at r0) in the merge of its run
// with the partner run [p0, p1): its index in its own run plus the
// count of partner keys before it. Ties go to the left run, so equal
// keys keep their order and the places form a permutation.
__device__ __forceinline__ int merged_place(const i64* c, const i64* s, int i,
                                            int r0, int p0, int p1,
                                            bool left) {
  const u64 ci = static_cast<u64>(c[i]);
  const i64 si = s[i];
  int lo = p0, hi = p1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const u64 cm = static_cast<u64>(c[mid]);
    const bool before = left ? key_lt(cm, s[mid], ci, si)
                             : key_le(cm, s[mid], ci, si);
    if (before) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return (r0 < p0 ? r0 : p0) + (i - r0) + (lo - p0);
}

// Sorts each kSortTile-range tile of the given ranges by key in shared
// memory (merge passes of doubling width) into (xc, xs, xe).
__global__ void __launch_bounds__(kSortThreads)
order_tile(const i64* __restrict__ c, const i64* __restrict__ s,
           const i64* __restrict__ e, int d, i64* __restrict__ xc,
           i64* __restrict__ xs, i64* __restrict__ xe,
           const int* __restrict__ disorder) {
  if (*disorder == 0) return;
  extern __shared__ i64 buf[];  // [2][3][kSortTile]
  const int base = blockIdx.x * kSortTile;
  const int n = d - base < kSortTile ? d - base : kSortTile;
  i64* cur = buf;
  i64* nxt = buf + 3 * kSortTile;
  for (int i = threadIdx.x; i < n; i += kSortThreads) {
    cur[i] = c[base + i];
    cur[kSortTile + i] = s[base + i];
    cur[2 * kSortTile + i] = e[base + i];
  }
  __syncthreads();
  for (int w = 1; w < n; w <<= 1) {
    for (int i = threadIdx.x; i < n; i += kSortThreads) {
      const int run = i / w;
      const int r0 = run * w;
      const int p0 = (run ^ 1) * w;
      int to = i;
      if (p0 < n) {
        const int p1 = p0 + w < n ? p0 + w : n;
        to = merged_place(cur, cur + kSortTile, i, r0, p0, p1,
                          (run & 1) == 0);
      }
      nxt[to] = cur[i];
      nxt[kSortTile + to] = cur[kSortTile + i];
      nxt[2 * kSortTile + to] = cur[2 * kSortTile + i];
    }
    __syncthreads();
    i64* t = cur;
    cur = nxt;
    nxt = t;
  }
  for (int i = threadIdx.x; i < n; i += kSortThreads) {
    xc[base + i] = cur[i];
    xs[base + i] = cur[kSortTile + i];
    xe[base + i] = cur[2 * kSortTile + i];
  }
}

// One merge pass in device memory: groups of kMergeWays sorted runs of
// width w become one sorted run each. An element's place is its index
// in its run plus, for every other run of its group, the count of keys
// before it (ties go to the earlier run).
__global__ void __launch_bounds__(kMergeThreads)
merge_runs(const i64* __restrict__ c, const i64* __restrict__ s,
           const i64* __restrict__ e, int d, int w, i64* __restrict__ oc,
           i64* __restrict__ os, i64* __restrict__ oe,
           const int* __restrict__ disorder) {
  if (*disorder == 0) return;
  const int i = blockIdx.x * kMergeThreads + threadIdx.x;
  if (i >= d) return;
  const int run = i / w;
  const int first = run - run % kMergeWays;
  const u64 ci = static_cast<u64>(c[i]);
  const i64 si = s[i];
  long long place = static_cast<long long>(first) * w + (i - run * w);
  for (int q = first; q < first + kMergeWays; ++q) {
    const long long q0 = static_cast<long long>(q) * w;
    if (q0 >= d) break;
    if (q == run) continue;
    int lo = static_cast<int>(q0);
    int hi = d - q0 > w ? lo + w : d;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      const u64 cm = static_cast<u64>(c[mid]);
      const bool before = q < run ? key_le(cm, s[mid], ci, si)
                                  : key_lt(cm, s[mid], ci, si);
      if (before) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    place += lo - q0;
  }
  oc[place] = ci;
  os[place] = si;
  oe[place] = e[i];
}

// One thread per item, kItems items a thread a block's width apart: the
// count `pos` of ranges whose key is <= the item's (client, clock), by a
// branch-free binary search over all d ranges (log2(d) + 1 dependent
// loads; the upper levels are shared by every item and stay in L1),
// then the same-client and running-max test on range pos - 1. The
// answer depends on nothing but the item and the prepared ranges.
__global__ void __launch_bounds__(kThreads)
ds_search(const int* __restrict__ client, const i64* __restrict__ clock,
          const unsigned char* __restrict__ valid, int n,
          const longlong2* __restrict__ keys,
          const i64* __restrict__ run_max, int d,
          unsigned char* __restrict__ out) {
  const long long b0 = static_cast<long long>(blockIdx.x) * kBlockItems;
  int top = 1;  // the highest power of two <= d
  while (top <= d / 2) top <<= 1;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = b0 + j * kThreads + threadIdx.x;
    if (i >= n) continue;
    const u64 ci = static_cast<u64>(static_cast<i64>(client[i]));
    const i64 ti = clock[i];
    int pos = 0;
    for (int step = d > 0 ? top : 0; step > 0; step >>= 1) {
      const int q = pos + step;
      if (q <= d) {
        const longlong2 k = keys[q - 1];
        if (key_le(static_cast<u64>(k.x), k.y, ci, ti)) pos = q;
      }
    }
    const int p = pos - 1;
    out[i] = (valid[i] != 0 && p >= 0 && static_cast<u64>(keys[p].x) == ci &&
              run_max[p] > ti)
                 ? 1
                 : 0;
  }
}

// Scratch layout, in 64-bit words, for d ranges.
struct Layout {
  int tiles;       // scan tiles
  int sort_tiles;  // order_tile blocks
  long long head;     // [disorder, counter A, counter B, pad] as ints
  long long status;   // 2 x tiles ints (given, sorted)
  long long pairs;    // 4 x tiles Pairs (aggregate, inclusive; x2)
  long long keys;     // [d] (client, start), the search's keys
  long long run_max;  // [d] the search's running max of end
  long long buf;      // 2 x 3 x [d] sort buffers (c, s, e)
  long long words;
  long long zero_words;  // leading words the preparation zeroes
};

Layout layout(int d) {
  Layout l;
  l.tiles = (d + kScanTile - 1) / kScanTile;
  l.sort_tiles = (d + kSortTile - 1) / kSortTile;
  l.head = 0;
  l.status = 2;
  l.pairs = l.status + (2LL * l.tiles + 1) / 2;
  l.zero_words = l.pairs;
  l.keys = (l.pairs + 2LL * 4 * l.tiles + 1) & ~1LL;  // 16-byte aligned
  l.run_max = l.keys + 2LL * d;
  l.buf = l.run_max + d;
  l.words = l.buf + 6LL * d;
  return l;
}

}  // namespace

extern "C" {

// 64-bit words of device scratch the preparation and search of d
// ranges need.
long long ds_mask_scratch_words(int d) { return layout(d).words; }

// Prepares d ranges ([d] int64 each, any order) for ds_mask_search in
// `scratch` (ds_mask_scratch_words(d) int64). Launches on `stream` and
// returns cudaGetLastError().
int ds_mask_prepare(const i64* d_client, const i64* d_start, const i64* d_end,
                    int d, i64* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 0) return static_cast<int>(cudaGetLastError());
  const Layout l = layout(d);
  if (l.tiles > 1)  // the look-back's counters and status, the flag
    lookback::clear_words<<<1, 256, 0, st>>>(
        scratch, static_cast<int>(l.zero_words));
  int* head = reinterpret_cast<int*>(scratch + l.head);
  int* disorder = head;
  int* status = reinterpret_cast<int*>(scratch + l.status);
  Pair* pairs = reinterpret_cast<Pair*>(scratch + l.pairs);
  longlong2* keys = reinterpret_cast<longlong2*>(scratch + l.keys);
  i64* run_max = scratch + l.run_max;
  // the given order: check it and take its running max
  run_max_scan<<<l.tiles, kScanThreads, 0, st>>>(
      d_client, d_start, d_end, d, keys, run_max, head + 1, status, pairs,
      pairs + l.tiles, disorder, 1, 0);
  // out of order: sort a copy and scan it over the first scan's output
  // (each launch returns at once when the ranges were in order)
  i64* x = scratch + l.buf;
  i64* y = x + 3LL * d;
  constexpr int kSortSmem = 6 * kSortTile * sizeof(i64);
  const cudaError_t err = cudaFuncSetAttribute(
      order_tile, cudaFuncAttributeMaxDynamicSharedMemorySize, kSortSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  order_tile<<<l.sort_tiles, kSortThreads, kSortSmem, st>>>(
      d_client, d_start, d_end, d, x, x + d, x + 2LL * d, disorder);
  for (long long w = kSortTile; w < d; w *= kMergeWays) {
    merge_runs<<<(d + kMergeThreads - 1) / kMergeThreads, kMergeThreads, 0,
                 st>>>(x, x + d, x + 2LL * d, d, static_cast<int>(w), y,
                       y + d, y + 2LL * d, disorder);
    i64* t = x;
    x = y;
    y = t;
  }
  run_max_scan<<<l.tiles, kScanThreads, 0, st>>>(
      x, x + d, x + 2LL * d, d, keys, run_max, head + 2, status + l.tiles,
      pairs + 2 * l.tiles, pairs + 3 * l.tiles, disorder, 0, 1);
  return static_cast<int>(cudaGetLastError());
}

// client [n] int32, clock [n] int64, valid [n] bool (one byte), out [n]
// bool, all on the device; `scratch` as ds_mask_prepare filled it for d
// ranges. Launches on `stream` and returns cudaGetLastError().
int ds_mask_search(const int* client, const i64* clock,
                   const unsigned char* valid, int n, int d,
                   const i64* scratch, unsigned char* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const Layout l = layout(d);
  const longlong2* keys = reinterpret_cast<const longlong2*>(scratch + l.keys);
  const i64* run_max = scratch + l.run_max;
  ds_search<<<(n + kBlockItems - 1) / kBlockItems, kThreads, 0, st>>>(
      client, clock, valid, n, keys, run_max, d, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
