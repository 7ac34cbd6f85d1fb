// Decoupled look-back state for the single-pass tile scans
// (ds_mask.cu's run_max_scan, seg_argmax_scan.cu's scan_tiles), the
// kernel that zeroes it, and the programmatic dependent launch (PDL)
// that lets a kernel start while the one before it on the stream runs.
//
// A scan tile publishes a value beside its status word: first its
// aggregate (kAggregate), then its inclusive prefix (kPrefix). The value
// is a plain store and the status a release store at device scope; a
// reader loads the status with acquire semantics and the value after it
// (through L2), so it never sees a status without its value. The status
// words and the tile counter must be zero when a scan of several tiles
// starts: clear_words zeroes them.

#pragma once

#include <cuda_runtime.h>

namespace lookback {

// tile status
constexpr int kEmpty = 0;
constexpr int kAggregate = 1;
constexpr int kPrefix = 2;

template <typename T>
__device__ __forceinline__ void publish(T* to, int* status, T v, int flag) {
  *to = v;
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(status), "r"(flag)
               : "memory");
}

__device__ __forceinline__ int status_of(const int* status) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v)
               : "l"(status)
               : "memory");
  return v;
}

// Lets the next kernel on the stream, when it was launched with
// launch_dependent, start now; it still waits in wait_for_prior_grid.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// Waits until the kernel before this one on the stream has finished and
// its writes are visible. Returns at once in a kernel launched without
// launch_dependent.
__device__ __forceinline__ void wait_for_prior_grid() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Zeroes the look-back's counter and status words before a scan of
// several tiles (a one-block kernel: a memset node costs more between
// kernels).
__global__ void clear_words(long long* __restrict__ p, int words) {
  launch_dependents();
  for (int i = threadIdx.x; i < words; i += blockDim.x) p[i] = 0;
}

// Launches `kernel` on `stream` as a programmatic dependent of the
// kernel before it: its blocks may start while that one runs, and must
// call wait_for_prior_grid before they read what it writes.
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), int blocks,
                             int threads, cudaStream_t stream,
                             Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

}  // namespace lookback
