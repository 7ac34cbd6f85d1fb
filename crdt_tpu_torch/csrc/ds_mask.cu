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
// ranges of the 1000x1600 fleet round. Here the wrapper sorts the
// ranges once by (client, start) and takes each client's running max
// of `end` over its sorted ranges (torch glue on D elements). Then one
// thread per item binary-searches the last range whose (client, start)
// is <= (client[i], clock[i]), compared lexicographically in native
// int64: the item is deleted iff that range has the item's client and
// its running-max end is > clock[i]. That range's running max covers
// every same-client range starting at or before clock[i], so the test
// is the dense one.
//
// What bounds it on this card: bytes (13 read, 1 written per item plus
// the ranges once); the search adds log2(D) dependent loads per item.
// When the sorted ranges fit in shared memory (24 bytes a range, up to
// kSharedMaxBytes) each block stages them once and walks the items in a
// grid-stride loop, one block per SM; beyond that the search reads them
// from global memory, where the top levels of every search stay in L1
// and L2.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSharedThreads = 1024;
constexpr int kSharedMaxBytes = 200 * 1024;

template <bool kShared>
__global__ void __launch_bounds__(kShared ? kSharedThreads : kThreads)
ds_mask_kernel(const int* __restrict__ client,
               const long long* __restrict__ clock,
               const unsigned char* __restrict__ valid, int n,
               const long long* __restrict__ r_client,
               const long long* __restrict__ r_start,
               const long long* __restrict__ r_max, int d,
               unsigned char* __restrict__ out) {
  extern __shared__ long long staged[];
  const long long* rc = r_client;
  const long long* rs = r_start;
  const long long* rm = r_max;
  if (kShared) {
    for (int e = threadIdx.x; e < d; e += blockDim.x) {
      staged[e] = r_client[e];
      staged[d + e] = r_start[e];
      staged[2 * d + e] = r_max[e];
    }
    __syncthreads();
    rc = staged;
    rs = staged + d;
    rm = staged + 2 * d;
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const long long ci = client[i];
    const long long ti = clock[i];
    int lo = 0, hi = d;  // count of ranges with (client, start) <= (ci, ti)
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      const long long cm = rc[mid];
      if (cm < ci || (cm == ci && rs[mid] <= ti)) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const int p = lo - 1;
    out[i] = (valid[i] != 0 && p >= 0 && rc[p] == ci && rm[p] > ti) ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// client [n] int32, clock [n] int64, valid [n] bool (one byte); the d
// ranges sorted by (client, start) with each client's running-max end,
// all [d] int64; out [n] bool. All on the device. Launches on `stream`
// and returns cudaGetLastError().
int ds_mask_launch(const int* client, const long long* clock,
                   const unsigned char* valid, int n,
                   const long long* r_client, const long long* r_start,
                   const long long* r_max, int d, unsigned char* out,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = static_cast<size_t>(d) * 3 * sizeof(long long);
  if (d > 0 && smem <= static_cast<size_t>(kSharedMaxBytes)) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaError_t err = cudaFuncSetAttribute(
        ds_mask_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int need = (n + kSharedThreads - 1) / kSharedThreads;
    const int blocks = need < sms ? need : sms;
    ds_mask_kernel<true><<<blocks, kSharedThreads, smem, s>>>(
        client, clock, valid, n, r_client, r_start, r_max, d, out);
  } else {
    ds_mask_kernel<false><<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        client, clock, valid, n, r_client, r_start, r_max, d, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
