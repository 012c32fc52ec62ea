// Shared helpers of the hand-written Hopper kernels (built for sm_90a).
//
// Every entry point has a plain C interface (loaded with ctypes), launches
// on the caller's stream (PyTorch's current stream, passed as a pointer),
// allocates nothing, never synchronises, and returns cudaGetLastError()
// right after its launches so the Python wrapper can raise on a refused
// launch.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

namespace repro {

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace repro
