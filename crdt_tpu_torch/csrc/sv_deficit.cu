// Pairwise state-vector deficit for Hopper (sm_90a): the anti-entropy
// plan.
//
// Replaces: crdt_tpu/ops/pallas_kernels.py `_sv_deficit_kernel`
// (wrapper `sv_deficit_static`), `ops/statevec.py:missing_static`, which
// the gossip and delta rounds run on every fleet step.
//
// Semantics: svs is [R, C] int64 row-major; out[i, j] =
// sum_c max(svs[i, c] - svs[j, c], 0), [R, R] int64 (exact, wrapping
// modulo 2^64 like the plain version, whenever no two clocks of one
// column differ by 2^63 or more).
//
// What bounds it on this card: operations on the integer pipes (64
// INT32 lanes an SM), not bytes: at R = 1000, C = 1002, 1e9 terms
// against 16 MB. A plain int64 tile kernel spends 6-8 int32
// instructions a term (int64 sub, compare, select, add), computes every
// unordered pair twice and, in 64 x 64 tiles, runs 256 blocks, a
// quarter of the card's thread slots.
//
// Design.
// - Max form and symmetry: out[i, j] = M[i, j] - rowsum[j] with
//   M[i, j] = sum_c max(svs[i, c], svs[j, c]), symmetric, so a block
//   computes one kTile x kTile tile of M for a tile pair I <= J and
//   writes both out[I, J] and out[J, I]; row_sums runs first.
// - int64 at staging only: M changes by sum_c base_c when every
//   clock of column c drops by base_c, so a block stages svs - base
//   with base = the tile pair's first row (one int64 subtraction a
//   staged value) and adds sum_c base_c = rowsum[i0] back at the end.
// - int32 inner loop: each term is one max and half an add (IADD3 adds
//   two terms at once) on the staged int32 values, into int32
//   accumulators flushed into int64 every kFlushChunks chunks.
// - The envelope is checked on the device per staged chunk: where some
//   staged value lies outside [-kEnvelope, kEnvelope) (a replica that
//   lags by more than 2^24 clocks), __syncthreads_or sends the whole
//   block through an int64 loop for that chunk alone. The result is
//   exact for any clocks; there is no host decision and no fallback
//   kernel.
// - Filling the card: 32 x 32 tiles of M, each split over two groups of
//   64 threads that take alternate halves of every 32-client chunk (4 x
//   4 outputs a thread), so R = 1000 runs 528 blocks of 128 threads,
//   four per SM.

#include <cuda_runtime.h>

namespace {

typedef long long i64;
typedef unsigned long long u64;

constexpr int kTile = 32;                     // M tile edge
constexpr int kChunk = 32;                    // clients staged per step
constexpr int kGroups = 2;                    // groups splitting a chunk
constexpr int kSide = 8;                      // threads along a tile edge
constexpr int kPer = kTile / kSide;           // outputs a thread per edge
constexpr int kThreads = kGroups * kSide * kSide;
constexpr int kGroupChunk = kChunk / kGroups;
constexpr int kStageRows = kTile / (kThreads / kChunk);  // rows a thread
constexpr int kPad = kTile + 4;  // int32 row stride: 16-byte aligned,
                                 // conflict-free 16-byte stores
constexpr int kFlushChunks = 8;
// kFlushChunks * kGroupChunk terms of magnitude <= kEnvelope stay
// inside int32
constexpr i64 kEnvelope = 1LL << 24;
static_assert(kFlushChunks * kGroupChunk * kEnvelope <= (1LL << 31),
              "int32 accumulators could overflow");
constexpr int kRowSumThreads = 256;

// rowsum[r] = sum_c svs[r, c] (wrapping), one warp a row
__global__ void __launch_bounds__(kRowSumThreads)
row_sums(const i64* __restrict__ svs, int r, int c, i64* __restrict__ sums) {
  const int row = blockIdx.x * (kRowSumThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= r) return;
  const i64* p = svs + static_cast<i64>(row) * c;
  u64 acc = 0;
  for (int k = lane; k < c; k += 32) acc += static_cast<u64>(p[k]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) sums[row] = static_cast<i64>(acc);
}

__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

__global__ void __launch_bounds__(kThreads, 4)
sv_deficit_tile(const i64* __restrict__ svs, int r, int c,
                const i64* __restrict__ sums, i64* __restrict__ out) {
  // staged chunk, [client][row]: int32 on the fast path, int64 for a
  // chunk outside the envelope (and, at the end, the group reduction)
  __shared__ __align__(16) int a32[kChunk][kPad];
  __shared__ __align__(16) int b32[kChunk][kPad];
  __shared__ i64 a64[kChunk][kTile];
  __shared__ i64 b64[kChunk][kTile];

  // tile pair bi <= bj from the linear block index
  const i64 blk = blockIdx.x;
  i64 bj = static_cast<i64>((sqrt(8.0 * static_cast<double>(blk) + 1.0) -
                             1.0) * 0.5);
  while (bj * (bj + 1) / 2 > blk) --bj;
  while ((bj + 1) * (bj + 2) / 2 <= blk) ++bj;
  const int bi = static_cast<int>(blk - bj * (bj + 1) / 2);
  const int i0 = bi * kTile;
  const int j0 = static_cast<int>(bj) * kTile;
  const i64* base_row = svs + static_cast<i64>(i0) * c;

  // staging: warp w takes rows w*kStageRows.. of both tiles, lane = client
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // compute: group g takes clients g*kGroupChunk.. of each chunk
  const int g = threadIdx.x / (kSide * kSide);
  const int tx = threadIdx.x % kSide;
  const int ty = (threadIdx.x / kSide) % kSide;

  int acc32[kPer][kPer];
  u64 acc64[kPer][kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u)
#pragma unroll
    for (int v = 0; v < kPer; ++v) {
      acc32[u][v] = 0;
      acc64[u][v] = 0;
    }

  int fast_chunks = 0;
  for (int c0 = 0; c0 < c; c0 += kChunk) {
    const int col = c0 + lane;
    i64 va[kStageRows], vb[kStageRows];
    bool ok = true;
    if (col < c) {
      const u64 base = static_cast<u64>(base_row[col]);
#pragma unroll
      for (int m = 0; m < kStageRows; ++m) {
        const int ra = i0 + warp * kStageRows + m;
        const int rb = j0 + warp * kStageRows + m;
        va[m] = ra < r ? static_cast<i64>(static_cast<u64>(
                             svs[static_cast<i64>(ra) * c + col]) - base)
                       : 0;
        vb[m] = rb < r ? static_cast<i64>(static_cast<u64>(
                             svs[static_cast<i64>(rb) * c + col]) - base)
                       : 0;
        ok = ok && va[m] >= -kEnvelope && va[m] < kEnvelope &&
             vb[m] >= -kEnvelope && vb[m] < kEnvelope;
      }
    } else {
#pragma unroll
      for (int m = 0; m < kStageRows; ++m) va[m] = vb[m] = 0;
    }
    // also the barrier after the previous chunk's reads
    const bool slow = __syncthreads_or(!ok);
    if (!slow) {
#pragma unroll
      for (int m = 0; m < kStageRows; m += 4) {
        const int row = warp * kStageRows + m;
        *reinterpret_cast<int4*>(&a32[lane][row]) =
            make_int4(static_cast<int>(va[m]), static_cast<int>(va[m + 1]),
                      static_cast<int>(va[m + 2]), static_cast<int>(va[m + 3]));
        *reinterpret_cast<int4*>(&b32[lane][row]) =
            make_int4(static_cast<int>(vb[m]), static_cast<int>(vb[m + 1]),
                      static_cast<int>(vb[m + 2]), static_cast<int>(vb[m + 3]));
      }
    } else {
#pragma unroll
      for (int m = 0; m < kStageRows; ++m) {
        a64[lane][warp * kStageRows + m] = va[m];
        b64[lane][warp * kStageRows + m] = vb[m];
      }
    }
    __syncthreads();

    const int k0 = g * kGroupChunk;
    if (!slow) {
#pragma unroll
      for (int k = k0; k < k0 + kGroupChunk; k += 2) {
        const int4 a0 = *reinterpret_cast<const int4*>(&a32[k][kPer * ty]);
        const int4 b0 = *reinterpret_cast<const int4*>(&b32[k][kPer * tx]);
        const int4 a1 = *reinterpret_cast<const int4*>(&a32[k + 1][kPer * ty]);
        const int4 b1 = *reinterpret_cast<const int4*>(&b32[k + 1][kPer * tx]);
        const int av0[kPer] = {a0.x, a0.y, a0.z, a0.w};
        const int bv0[kPer] = {b0.x, b0.y, b0.z, b0.w};
        const int av1[kPer] = {a1.x, a1.y, a1.z, a1.w};
        const int bv1[kPer] = {b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int u = 0; u < kPer; ++u)
#pragma unroll
          for (int v = 0; v < kPer; ++v)
            acc32[u][v] += imax(av0[u], bv0[v]) + imax(av1[u], bv1[v]);
      }
      if (++fast_chunks == kFlushChunks) {
        fast_chunks = 0;
#pragma unroll
        for (int u = 0; u < kPer; ++u)
#pragma unroll
          for (int v = 0; v < kPer; ++v) {
            acc64[u][v] += static_cast<u64>(static_cast<i64>(acc32[u][v]));
            acc32[u][v] = 0;
          }
      }
    } else {
      for (int k = k0; k < k0 + kGroupChunk; ++k)
#pragma unroll
        for (int u = 0; u < kPer; ++u)
#pragma unroll
          for (int v = 0; v < kPer; ++v) {
            const i64 x = a64[k][kPer * ty + u];
            const i64 y = b64[k][kPer * tx + v];
            acc64[u][v] += static_cast<u64>(x > y ? x : y);
          }
    }
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u)
#pragma unroll
    for (int v = 0; v < kPer; ++v)
      acc64[u][v] += static_cast<u64>(static_cast<i64>(acc32[u][v]));

  // sum the groups: group 1 hands its tile to group 0 through a64
  __syncthreads();
  u64* red = reinterpret_cast<u64*>(&a64[0][0]);
  const int slot = (ty * kSide + tx) * kPer * kPer;
  if (g == 1) {
#pragma unroll
    for (int u = 0; u < kPer; ++u)
#pragma unroll
      for (int v = 0; v < kPer; ++v) red[slot + u * kPer + v] = acc64[u][v];
  }
  __syncthreads();
  if (g != 0) return;
  const u64 base_sum = static_cast<u64>(sums[i0]);
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = i0 + kPer * ty + u;
    if (i >= r) continue;
#pragma unroll
    for (int v = 0; v < kPer; ++v) {
      const int j = j0 + kPer * tx + v;
      if (j >= r) continue;
      const u64 m = acc64[u][v] + red[slot + u * kPer + v] + base_sum;
      out[static_cast<i64>(i) * r + j] =
          static_cast<i64>(m - static_cast<u64>(sums[j]));
      if (bi != bj)
        out[static_cast<i64>(j) * r + i] =
            static_cast<i64>(m - static_cast<u64>(sums[i]));
    }
  }
}

}  // namespace

extern "C" {

// svs: [r, c] int64 row-major, out: [r, r] int64, sums: [r] int64
// scratch, all on the device. Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue when r needs more tile
// pairs than a grid holds).
int sv_deficit_launch(const i64* svs, int r, int c, i64* sums, i64* out,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (r <= 0) return static_cast<int>(cudaGetLastError());
  const i64 tiles = (r + kTile - 1) / kTile;
  const i64 pairs = tiles * (tiles + 1) / 2;
  if (pairs > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int warps = kRowSumThreads / 32;
  row_sums<<<(r + warps - 1) / warps, kRowSumThreads, 0, s>>>(svs, r, c, sums);
  sv_deficit_tile<<<static_cast<unsigned>(pairs), kThreads, 0, s>>>(
      svs, r, c, sums, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
