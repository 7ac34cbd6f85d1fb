// Segmented inclusive argmax scan for Hopper (sm_90a).
//
// Replaces: crdt_tpu/ops/pallas_kernels.py `_seg_argmax_kernel` (wrapper
// `seg_argmax_scan`, oracle `seg_argmax_scan_jnp`), the LWW map-winner
// scan of `ops/packed.py:_map_block`.
//
// Semantics: out[i] is the position of the (max client, earliest
// position) element of i's run prefix, where a run starts at every
// position whose flag is nonzero (position 0 always opens one). The
// oracle's combine operator on (client, arg, flag) is
//   combine(x, y) = y                      if y.flag
//                 = better(x, y), x.f|y.f  otherwise
// with better = larger client, ties to the smaller (earlier) arg.
//
// Here (client, arg) is one 64-bit key, the client with its sign bit
// flipped above the complement of the position, so `better` is an
// unsigned max (0 is the identity, below every element's key). The
// combine is then: a run start takes its own key, anything else the max
// of the carry and its key. Its scans shuffle a key (two 32-bit
// shuffles a step) and find each lane's run start with one ballot.
//
// What bounds it on this card: bytes. Per element it reads 8 bytes
// (client, flag) and writes 4; the arithmetic is a few integer
// instructions. The design reads the input once, in one pass:
//   - every block claims the next tile of kTile (1,024) elements from a
//     counter (so a tile's predecessors are already running; tiles of
//     2,048 and 4,096 measured slower), loads it with
//     coalesced 16-byte loads and hands it through shared memory to the
//     thread-blocked order the scan wants (kItems neighbours a thread);
//   - a thread-sequential pass, a warp scan and a scan of the warp
//     totals give the tile's aggregate, which it publishes at once; a
//     tile that holds a run start publishes it as its inclusive prefix,
//     since nothing before that start reaches past it;
//   - warp 0 then looks back over its predecessors, 32 at a time, to the
//     nearest one with an inclusive prefix (lookback.cuh). Between that
//     one and this tile no tile holds a run start, so the carry is the
//     plain max of their keys: the order of the fold does not matter;
//   - the tile is scanned seeded with the carry, and the positions go
//     back through shared memory to 16-byte stores.
// A scan of several tiles needs its counter and status zeroed: a
// one-block clear_words kernel runs first, and the scan is launched as
// its programmatic dependent, so the scan's blocks are resident and
// waiting (wait_for_prior_grid) when the clear ends. A scan of one tile
// needs neither. So two launches, one pass over the data.
//
// The launch takes 16-byte aligned pointers (the wrapper hands over an
// aligned copy of a view that is not); a ragged tail is read and written
// element by element.

#include <cuda_runtime.h>

#include <cstdint>

#include "lookback.cuh"

namespace {

typedef unsigned long long u64;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 4;  // neighbouring elements a thread scans
constexpr int kTile = kThreads * kItems;
constexpr int kVecs = kItems / 4;  // int4 loads a thread makes per array
// Blocks an SM must hold: 8 caps a thread at 32 registers, so the 1,024
// tiles of M = 2**20 fit the card's 132 SMs in one wave. At 40 registers
// (6 blocks an SM, two waves) the scan measured about 30% slower.
constexpr int kMinBlocks = 8;

// Shared-memory slot of a tile's j-th element: one pad word every 32, so
// the striped writes (4 neighbours a lane, lanes 4 apart) and the
// blocked reads (kItems neighbours a lane, lanes kItems apart, for
// kItems of 4, 8 or 16) meet no bank conflict.
__host__ __device__ constexpr int slot(int j) { return j + (j >> 5); }

// larger client, then earlier position, is the larger key
__device__ __forceinline__ u64 key_of(int client, int pos) {
  return (static_cast<u64>(static_cast<unsigned>(client) ^ 0x80000000u)
          << 32) |
         static_cast<unsigned>(~pos);
}

__device__ __forceinline__ int pos_of(u64 key) {
  return ~static_cast<int>(static_cast<unsigned>(key));
}

__device__ __forceinline__ u64 umax(u64 a, u64 b) { return a > b ? a : b; }

// Inclusive segmented max scan of one key per lane: lane l gets the max
// over lanes [s, l], s the last lane <= l whose `start` is set (lane 0
// when none is). `starts` is the warp's ballot of `start`.
__device__ __forceinline__ u64 warp_seg_max(u64 v, unsigned starts) {
  const int lane = threadIdx.x & 31;
  const unsigned upto = starts & (kFull >> (31 - lane));
  const int first = upto ? 31 - __clz(upto) : 0;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const u64 o = __shfl_up_sync(kFull, v, d);
    if (lane - d >= first) v = umax(v, o);
  }
  return v;
}

// the key before lane l in the warp (lane 0: the identity), and whether
// a run starts at some lane before l
__device__ __forceinline__ u64 lane_exclusive(u64 inclusive, unsigned starts,
                                              bool* started) {
  const int lane = threadIdx.x & 31;
  const u64 ex = __shfl_up_sync(kFull, inclusive, 1);
  *started = (starts & ((1u << lane) - 1u)) != 0;
  return lane == 0 ? 0ull : ex;
}

// Scratch layout in 64-bit words for a scan of `tiles` tiles.
struct Layout {
  long long counter;    // the tile counter (an int)
  long long status;     // [tiles] ints
  long long aggregate;  // [tiles] keys
  long long inclusive;  // [tiles] keys
  long long words;
  long long zero_words;  // leading words clear_words zeroes
};

__host__ __device__ Layout layout(int tiles) {
  Layout l;
  l.counter = 0;
  l.status = 1;
  l.aggregate = l.status + (tiles + 1) / 2;
  l.zero_words = l.aggregate;
  l.inclusive = l.aggregate + tiles;
  l.words = l.inclusive + tiles;
  return l;
}

int tiles_of(int n) { return n / kTile + (n % kTile != 0); }

__global__ void __launch_bounds__(kThreads, kMinBlocks)
scan_tiles(const int* __restrict__ client, const int* __restrict__ flags,
           int n, int* __restrict__ out, long long* __restrict__ scratch) {
  __shared__ int c_sh[slot(kTile)];
  __shared__ int f_sh[slot(kTile)];  // flags, then output positions
  __shared__ u64 warp_key[kWarps];   // warp totals, then warp seeds
  __shared__ int warp_start[kWarps];
  __shared__ int tile_sh;

  const bool chained = gridDim.x > 1;
  const Layout l = layout(gridDim.x);
  int* counter = reinterpret_cast<int*>(scratch + l.counter);
  int* status = reinterpret_cast<int*>(scratch + l.status);
  u64* aggregate = reinterpret_cast<u64*>(scratch + l.aggregate);
  u64* inclusive = reinterpret_cast<u64*>(scratch + l.inclusive);

  // the counter and status are zeroed by the kernel before this one
  if (chained) lookback::wait_for_prior_grid();
  if (threadIdx.x == 0) tile_sh = chained ? atomicAdd(counter, 1) : 0;
  __syncthreads();
  const int tile = tile_sh;
  const int base = tile * kTile;
  const int rem = n - base;  // elements of this tile that exist (> 0)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // striped 16-byte loads; elements past n read as client 0, no start
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int j = 4 * (k * kThreads + threadIdx.x);
    int4 c = make_int4(0, 0, 0, 0);
    int4 f = make_int4(0, 0, 0, 0);
    if (j + 4 <= rem) {
      c = __ldcs(reinterpret_cast<const int4*>(client + base + j));
      f = __ldcs(reinterpret_cast<const int4*>(flags + base + j));
    } else if (j < rem) {
      int cv[3] = {0, 0, 0};
      int fv[3] = {0, 0, 0};
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        if (j + e < rem) {
          cv[e] = client[base + j + e];
          fv[e] = flags[base + j + e];
        }
      }
      c = make_int4(cv[0], cv[1], cv[2], 0);
      f = make_int4(fv[0], fv[1], fv[2], 0);
    }
    c_sh[slot(j)] = c.x;
    c_sh[slot(j + 1)] = c.y;
    c_sh[slot(j + 2)] = c.z;
    c_sh[slot(j + 3)] = c.w;
    f_sh[slot(j)] = f.x;
    f_sh[slot(j + 1)] = f.y;
    f_sh[slot(j + 2)] = f.z;
    f_sh[slot(j + 3)] = f.w;
  }
  __syncthreads();

  // this thread's kItems neighbours: keys, run starts, and their
  // segmented max (past n: the identity, no start)
  const int first = threadIdx.x * kItems;
  u64 keys[kItems];
  unsigned starts = 0;
  u64 agg = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const bool in = first + k < rem;
    keys[k] = in ? key_of(c_sh[slot(first + k)], base + first + k) : 0ull;
    const bool s = in && f_sh[slot(first + k)] != 0;
    starts |= static_cast<unsigned>(s) << k;
    agg = s ? keys[k] : umax(agg, keys[k]);
  }
  const unsigned lane_starts = __ballot_sync(kFull, starts != 0);
  const u64 inc = warp_seg_max(agg, lane_starts);
  bool lane_started;
  const u64 ex = lane_exclusive(inc, lane_starts, &lane_started);
  if (lane == 31) {
    warp_key[warp] = inc;
    warp_start[warp] = lane_starts != 0;
  }
  __syncthreads();

  if (warp == 0) {
    const bool ws = lane < kWarps && warp_start[lane] != 0;
    const unsigned warp_starts = __ballot_sync(kFull, ws);
    const u64 w = warp_seg_max(lane < kWarps ? warp_key[lane] : 0ull,
                               warp_starts);
    const u64 total = __shfl_sync(kFull, w, kWarps - 1);
    bool warp_started;
    const u64 wex = lane_exclusive(w, warp_starts, &warp_started);
    u64 carry = 0;
    if (chained) {
      using lookback::kAggregate;
      using lookback::kEmpty;
      using lookback::kPrefix;
      // a tile that holds a run start (and tile 0) has its inclusive
      // prefix already: publish it before looking back
      const bool done = tile == 0 || warp_starts != 0;
      if (lane == 0) {
        if (done) {
          lookback::publish(&inclusive[tile], &status[tile], total, kPrefix);
        } else {
          lookback::publish(&aggregate[tile], &status[tile], total,
                            kAggregate);
        }
      }
      if (tile > 0) {
        // lane 31 reads the nearest predecessor; stop at the nearest
        // tile that has published its inclusive prefix
        for (int end = tile;; end -= 32) {
          const int p = end - 32 + lane;
          int st = kAggregate;  // before tile 0: nothing to add
          do {
            if (p >= 0) st = lookback::status_of(&status[p]);
          } while (__any_sync(kFull, st == kEmpty));
          const unsigned prefixes = __ballot_sync(kFull, st == kPrefix);
          const int top = prefixes ? 31 - __clz(prefixes) : -1;
          u64 x = 0;
          if (p >= 0 && lane >= top)
            x = __ldcg(st == kPrefix ? &inclusive[p] : &aggregate[p]);
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            x = umax(x, __shfl_xor_sync(kFull, x, o));
          carry = umax(carry, x);
          if (top >= 0) break;
        }
        if (!done && lane == 0)
          lookback::publish(&inclusive[tile], &status[tile],
                            umax(carry, total), kPrefix);
      }
    }
    // each warp's seed: the carry, cut off by a run start before it
    if (lane < kWarps) warp_key[lane] = warp_started ? wex : umax(carry, wex);
  }
  __syncthreads();

  u64 run = lane_started ? ex : umax(warp_key[warp], ex);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    run = (starts >> k) & 1u ? keys[k] : umax(run, keys[k]);
    f_sh[slot(first + k)] = pos_of(run);
  }
  __syncthreads();

#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int j = 4 * (k * kThreads + threadIdx.x);
    if (j + 4 <= rem) {
      __stcs(reinterpret_cast<int4*>(out + base + j),
             make_int4(f_sh[slot(j)], f_sh[slot(j + 1)], f_sh[slot(j + 2)],
                       f_sh[slot(j + 3)]));
    } else {
      for (int e = 0; j + e < rem; ++e) out[base + j + e] = f_sh[slot(j + e)];
    }
  }
}

}  // namespace

extern "C" {

// Elements per tile.
int seg_argmax_scan_tile() { return kTile; }

// 64-bit words of device scratch a scan of n elements needs.
long long seg_argmax_scan_scratch_words(int n) {
  return layout(tiles_of(n)).words;
}

// client, flags, out: [n] int32 on the device, each 16-byte aligned;
// scratch: seg_argmax_scan_scratch_words(n) int64 on the device.
// Launches on `stream` and returns cudaGetLastError() (or
// cudaErrorMisalignedAddress, launching nothing).
int seg_argmax_scan_launch(const int* client, const int* flags, int* out,
                           long long* scratch, int n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const uintptr_t any = reinterpret_cast<uintptr_t>(client) |
                        reinterpret_cast<uintptr_t>(flags) |
                        reinterpret_cast<uintptr_t>(out);
  if (any & 15) return static_cast<int>(cudaErrorMisalignedAddress);
  const int tiles = tiles_of(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tiles == 1) {
    scan_tiles<<<1, kThreads, 0, s>>>(client, flags, n, out, scratch);
    return static_cast<int>(cudaGetLastError());
  }
  lookback::clear_words<<<1, 256, 0, s>>>(
      scratch, static_cast<int>(layout(tiles).zero_words));
  const cudaError_t err = lookback::launch_dependent(
      scan_tiles, tiles, kThreads, s, client, flags, n, out, scratch);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
