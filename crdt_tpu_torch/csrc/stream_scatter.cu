// Document-order scatter for Hopper (sm_90a): out[pos[i]] = i.
//
// Replaces: crdt_tpu/ops/pallas_kernels.py `_stream_scatter_kernel`
// (wrapper `stream_scatter`, oracle `stream_scatter_jnp`), the YATA
// document-order assembly of `ops/packed.py:_converge_packed_body`.
//
// Semantics: out is [n_out] int32, -1 where no input targets a slot;
// targets outside [0, n_out), negative ones included, are dropped (a
// negative target never wraps). Targets are unique by construction
// (per-segment DFS ranks plus exclusive segment offsets), so the
// writes never race.
//
// What bounds it on this card: bytes, 4 read and 4 written per input
// plus the 4-byte fill of every output slot; at the main path's sizes
// the output (2.6 MB at 1000x1600) lives in L2, which absorbs the
// random 4-byte stores. So the cost is two short passes and the gap
// between them: the fill must be complete and visible before any
// scatter store, since the two may hit one slot from different blocks.
// The design:
//   - fill_holes writes -1 as 16-byte stores, a few blocks per SM
//     striding over the output;
//   - scatter is launched as the fill's programmatic dependent: its
//     blocks start while the fill runs, load their targets, and only
//     then wait for the fill (wait_for_prior_grid) before they store.
//     A warp's loads and stores take neighbouring inputs: neighbouring
//     rows mostly target neighbouring slots, so a warp's 32 stores touch
//     few 32-byte sectors. Four neighbouring targets a thread, from one
//     16-byte load, spread each store over 4x the sectors and measured
//     slower than the two-kernel scatter it replaces; of kItems targets
//     a thread, kThreads apart, one measured fastest (4, 8, 16 slower).
// `out` must be 16-byte aligned (a fresh allocation is); `pos` need not
// be.

#include <cuda_runtime.h>

#include <cstdint>

#include "lookback.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 1;  // targets a scatter thread takes
constexpr int kBlockTargets = kThreads * kItems;
constexpr int kFillBlocksPerSm = 4;

__global__ void __launch_bounds__(kThreads)
fill_holes(int* __restrict__ out, int n_out) {
  lookback::launch_dependents();
  const int n4 = n_out >> 2;
  int4* out4 = reinterpret_cast<int4*>(out);
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n4;
       i += gridDim.x * kThreads)
    out4[i] = make_int4(-1, -1, -1, -1);
  if (blockIdx.x == 0 && threadIdx.x < (n_out & 3))
    out[(n4 << 2) + threadIdx.x] = -1;
}

__device__ __forceinline__ void put(int* out, int n_out, int target,
                                    unsigned i) {
  if (static_cast<unsigned>(target) < static_cast<unsigned>(n_out))
    out[target] = static_cast<int>(i);
}

__global__ void __launch_bounds__(kThreads)
scatter(const int* __restrict__ pos, int n_in, int* __restrict__ out,
        int n_out) {
  const int base = blockIdx.x * kBlockTargets;
  const int rem = n_in - base;  // targets of this block that exist (> 0)
  int p[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = k * kThreads + threadIdx.x;
    p[k] = j < rem ? __ldcs(pos + base + j) : -1;  // past n_in: dropped
  }
  // the holes are written and visible
  lookback::wait_for_prior_grid();
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    put(out, n_out, p[k],
        static_cast<unsigned>(base) + k * kThreads + threadIdx.x);
}

}  // namespace

extern "C" {

// pos: [n_in] int32, out: [n_out] int32 16-byte aligned, both on the
// device. Launches on `stream` and returns cudaGetLastError() (or
// cudaErrorMisalignedAddress, launching nothing).
int stream_scatter_launch(const int* pos, int n_in, int* out, int n_out,
                          void* stream) {
  if (reinterpret_cast<uintptr_t>(out) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (n_out <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec_blocks = ((n_out >> 2) + kThreads - 1) / kThreads;
  const int fill_blocks = vec_blocks < 1 ? 1
                          : vec_blocks < kFillBlocksPerSm * sms
                              ? vec_blocks
                              : kFillBlocksPerSm * sms;
  fill_holes<<<fill_blocks, kThreads, 0, s>>>(out, n_out);
  if (n_in > 0) {
    err = lookback::launch_dependent(
        scatter, n_in / kBlockTargets + (n_in % kBlockTargets != 0),
        kThreads, s, pos, n_in, out, n_out);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
