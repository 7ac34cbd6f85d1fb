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
// plus the 4-byte fill of every output slot. The TPU kernel walked the
// input with a sequential fori_loop of scalar VMEM stores; here every
// input is one thread. A fill kernel writes the -1 holes first, then
// the scatter kernel writes each in-range target, both on the
// caller's stream. Reads are coalesced; the writes are random 4-byte
// stores, which L2 absorbs at these sizes (the output fits in L2).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fill_holes(int* __restrict__ out, int n_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n_out) out[i] = -1;
}

__global__ void __launch_bounds__(kThreads)
scatter(const int* __restrict__ pos, int n_in, int* __restrict__ out,
        int n_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_in) return;
  const int p = pos[i];
  if (p >= 0 && p < n_out) out[p] = i;
}

}  // namespace

extern "C" {

// pos: [n_in] int32, out: [n_out] int32, both on the device. Launches
// on `stream` and returns cudaGetLastError().
int stream_scatter_launch(const int* pos, int n_in, int* out, int n_out,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_out > 0) {
    fill_holes<<<(n_out + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        out, n_out);
  }
  if (n_in > 0 && n_out > 0) {
    scatter<<<(n_in + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        pos, n_in, out, n_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
