// Block-ELL SpMV, y = A x, on Hopper — read in sliced-ELL form.
//
// Replaces the TPU kernel repro/kernels/spmv_bell.py::bell_spmv_pallas (its
// pallas_call at spmv_bell.py:66).  The TPU version multiplies dense
// (bm, bn) = (8, 128) tiles, one vreg-shaped MXU operand per slot of the
// block-ELL table.  At the ~1% fill of 2-D Poisson those tiles are ~50x the
// bytes of the nonzeros, and bytes are what bound a SpMV on this card.  So
// the plan's matrix is stored here as sliced ELL (core/sparse.py,
// build_sell, built once per pattern from the block-ELL table): slices of
// 32 consecutive rows, each padded to its longest row, entry j of row r at
// slice_ptr[r / 32] + 32 j + r % 32, with its int32 column beside it.
//
// One warp owns one slice and lane l owns row 32 s + l: at step j the warp
// reads 32 consecutive values and columns (coalesced), gathers x through
// the read-only cache (x, 8 MB at poisson2d(1024), stays in the 50 MB L2)
// and each lane stores its y[r] once.  The sum runs over a row's entries
// in a fixed order with no atomics, so every run gives the same bits.
//
// Bound: bytes.  12 B per padded entry (f64 value + int32 column; 8 B in
// f32), x read once, y written once, slice_ptr read once: 79.9 MB at
// poisson2d(1024) f64 (5,240,832 slots for 5,238,784 nonzeros), 0.0239 ms
// at 3.35 TB/s, against 83.8 MB (0.0250 ms) for CSR.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;            // slices per block

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
sell_spmv_kernel(const long long* __restrict__ slice_ptr,
                 const int32_t* __restrict__ cols, const T* __restrict__ vals,
                 const T* __restrict__ x, T* __restrict__ y, long long n) {
  const long long s = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const long long row = s * 32 + lane;
  if (s * 32 >= n) return;
  const long long p0 = __ldg(slice_ptr + s) + lane;
  const long long p1 = __ldg(slice_ptr + s + 1);
  T acc = T(0);
#pragma unroll 4
  for (long long p = p0; p < p1; p += 32)
    acc += __ldg(vals + p) * __ldg(x + __ldg(cols + p));
  if (row < n) y[row] = acc;
}

template <typename T>
int launch(const void* slice_ptr, const void* cols, const void* vals,
           const void* x, void* y, long long n, void* stream) {
  if (n <= 0) return 0;
  const long long n_slices = (n + 31) / 32;
  const long long blocks = (n_slices + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  sell_spmv_kernel<T><<<(unsigned)blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const long long*)slice_ptr, (const int32_t*)cols, (const T*)vals,
      (const T*)x, (T*)y, n);
  return (int)cudaGetLastError();
}

}  // namespace

REPRO_EXPORT int bell_spmv_f32(const void* slice_ptr, const void* cols,
                               const void* vals, const void* x, void* y,
                               long long n, void* stream) {
  return launch<float>(slice_ptr, cols, vals, x, y, n, stream);
}

REPRO_EXPORT int bell_spmv_f64(const void* slice_ptr, const void* cols,
                               const void* vals, const void* x, void* y,
                               long long n, void* stream) {
  return launch<double>(slice_ptr, cols, vals, x, y, n, stream);
}
