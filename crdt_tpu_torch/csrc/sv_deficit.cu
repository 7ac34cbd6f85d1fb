// Pairwise state-vector deficit for Hopper (sm_90a): the anti-entropy
// plan.
//
// Replaces: crdt_tpu/ops/pallas_kernels.py `_sv_deficit_kernel`
// (wrapper `sv_deficit_static`), `ops/statevec.py:missing_static`, which
// the gossip and delta rounds run on every fleet step.
//
// Semantics: svs is [R, C] int64 row-major; out[i, j] =
// sum_c max(svs[i, c] - svs[j, c], 0), [R, R] int64.
//
// Design. Shaped like a GEMM with (sub, max, add) in place of the
// multiply-add, so the [R, R, C] intermediate never exists. Each block
// owns one kTile x kTile output tile; the row tiles of svs for i and
// for j are staged through shared memory kChunk clients at a time
// (coalesced along C), and each of the 256 threads accumulates a 4 x 4
// block of outputs in int64 registers. Rows past R and clients past C
// are staged as 0, which adds max(0 - 0, 0) = 0, and their outputs are
// not written. The TPU kernel narrowed to int32 after centring every
// column on its minimum and fell back to an exact scan past a 2**31
// envelope (Mosaic workarounds); int64 here is exact for any clocks.
//
// What bounds it on this card: operations. R^2 * C (sub, max, add)
// terms in int64 on the non-tensor integer pipes, against 8 * R * C
// bytes read and 8 * R^2 written; at R = 1000, C = 1002 that is ~1e9
// terms against 16 MB. An int32 fast path under a checked envelope is
// the known next step.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;    // output tile edge
constexpr int kChunk = 16;   // clients staged per step
constexpr int kSide = 16;    // threads along each tile edge
constexpr int kPer = kTile / kSide;  // outputs per thread along an edge
constexpr int kThreads = kSide * kSide;

__global__ void __launch_bounds__(kThreads)
sv_deficit_tile(const long long* __restrict__ svs, int r, int c,
                long long* __restrict__ out) {
  // [client][row]; the +1 pad spreads the staging stores over banks
  __shared__ long long a[kChunk][kTile + 1];
  __shared__ long long b[kChunk][kTile + 1];
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % kSide;
  const int ty = threadIdx.x / kSide;
  long long acc[kPer][kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u)
#pragma unroll
    for (int v = 0; v < kPer; ++v) acc[u][v] = 0;

  for (int c0 = 0; c0 < c; c0 += kChunk) {
    for (int e = threadIdx.x; e < kTile * kChunk; e += kThreads) {
      const int row = e / kChunk;
      const int k = e % kChunk;
      const int col = c0 + k;
      long long va = 0, vb = 0;
      if (col < c) {
        if (i0 + row < r) va = svs[static_cast<long long>(i0 + row) * c + col];
        if (j0 + row < r) vb = svs[static_cast<long long>(j0 + row) * c + col];
      }
      a[k][row] = va;
      b[k][row] = vb;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      long long av[kPer], bv[kPer];
#pragma unroll
      for (int u = 0; u < kPer; ++u) av[u] = a[k][ty + kSide * u];
#pragma unroll
      for (int v = 0; v < kPer; ++v) bv[v] = b[k][tx + kSide * v];
#pragma unroll
      for (int u = 0; u < kPer; ++u)
#pragma unroll
        for (int v = 0; v < kPer; ++v) {
          const long long dlt = av[u] - bv[v];
          acc[u][v] += dlt > 0 ? dlt : 0;
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = i0 + ty + kSide * u;
    if (i >= r) continue;
#pragma unroll
    for (int v = 0; v < kPer; ++v) {
      const int j = j0 + tx + kSide * v;
      if (j < r) out[static_cast<long long>(i) * r + j] = acc[u][v];
    }
  }
}

}  // namespace

extern "C" {

// svs: [r, c] int64 row-major, out: [r, r] int64, both on the device.
// Launches on `stream` and returns cudaGetLastError().
int sv_deficit_launch(const long long* svs, int r, int c, long long* out,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (r > 0) {
    const int tiles = (r + kTile - 1) / kTile;
    sv_deficit_tile<<<dim3(tiles, tiles), kThreads, 0, s>>>(svs, r, c, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
