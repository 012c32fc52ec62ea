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
//
// Lanes (the reference's jax.vmap of the Pallas kernel, written out): one
// pattern, B value arrays and/or B right-hand sides.  sell_spmv_lanes_kernel
// keeps one warp per slice and one lane per row and gives each thread up to
// kLanes accumulators: at step j it reads the slot's column ONCE and applies
// it to every lane of its chunk (blockIdx.y picks the chunk of kLanes lanes),
// so cols and slice_ptr cross HBM once per chunk instead of once per lane.
// Three layouts share the kernel through two flags: batched values with
// batched x, batched values with one x (kXShared), and one value array
// with k right-hand sides (kValShared: an SpMM, each value read once and
// applied to k columns).  Lane b's sum runs over the same slots in the same
// order with the same fused multiply-add as sell_spmv_kernel, so lane b
// equals the single-vector kernel on lane b bit for bit.
//
// Bound (bytes), B lanes in chunks of kLanes: B value arrays (or one, SpMM),
// ceil(B / kLanes) reads of cols and slice_ptr, B x read and B y written.
// At poisson2d(1024) f64, B = 8: 335 + 21 + 67 + 67 MB = 490 MB, 0.146 ms;
// SpMM with k = 16: 42 + 21 + 134 + 134 MB = 331 MB, 0.099 ms.
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

constexpr int kLanes = 16;           // lanes per chunk (accumulators per thread)

template <typename T, bool kValShared, bool kXShared>
__global__ void __launch_bounds__(kWarps * 32)
sell_spmv_lanes_kernel(const long long* __restrict__ slice_ptr,
                       const int32_t* __restrict__ cols,
                       const T* __restrict__ vals, const T* __restrict__ x,
                       T* __restrict__ y, long long n, int lanes,
                       long long val_stride, long long x_stride) {
  const long long s = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const long long row = s * 32 + lane;
  if (s * 32 >= n) return;
  const int b0 = blockIdx.y * kLanes;
  const int nl = min(kLanes, lanes - b0);
  if (!kValShared) vals += (long long)b0 * val_stride;
  if (!kXShared) x += (long long)b0 * x_stride;
  y += (long long)b0 * n;
  const long long p0 = __ldg(slice_ptr + s) + lane;
  const long long p1 = __ldg(slice_ptr + s + 1);
  T acc[kLanes];
#pragma unroll
  for (int l = 0; l < kLanes; ++l) acc[l] = T(0);
  for (long long p = p0; p < p1; p += 32) {
    const int c = __ldg(cols + p);
    if (kValShared) {
      const T v = __ldg(vals + p);
#pragma unroll
      for (int l = 0; l < kLanes; ++l)
        if (l < nl) acc[l] += v * __ldg(x + l * x_stride + c);
    } else if (kXShared) {
      const T xc = __ldg(x + c);
#pragma unroll
      for (int l = 0; l < kLanes; ++l)
        if (l < nl) acc[l] += __ldg(vals + l * val_stride + p) * xc;
    } else {
#pragma unroll
      for (int l = 0; l < kLanes; ++l)
        if (l < nl) acc[l] += __ldg(vals + l * val_stride + p) * __ldg(x + l * x_stride + c);
    }
  }
  if (row < n) {
#pragma unroll
    for (int l = 0; l < kLanes; ++l)
      if (l < nl) y[l * n + row] = acc[l];
  }
}

template <typename T>
int launch_lanes(const void* slice_ptr, const void* cols, const void* vals,
                 const void* x, void* y, long long n, int lanes,
                 long long val_stride, long long x_stride, void* stream) {
  if (n <= 0 || lanes <= 0) return 0;
  if (val_stride == 0 && x_stride == 0) return (int)cudaErrorInvalidValue;
  const long long n_slices = (n + 31) / 32;
  const long long blocks = (n_slices + kWarps - 1) / kWarps;
  const long long chunks = (lanes + kLanes - 1) / kLanes;
  if (blocks > 0x7fffffffLL || chunks > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)blocks, (unsigned)chunks);
  const auto* sp = (const long long*)slice_ptr;
  const auto* cl = (const int32_t*)cols;
  const auto* vv = (const T*)vals;
  const auto* xx = (const T*)x;
  auto* yy = (T*)y;
  cudaStream_t st = (cudaStream_t)stream;
  if (val_stride == 0)
    sell_spmv_lanes_kernel<T, true, false><<<grid, kWarps * 32, 0, st>>>(
        sp, cl, vv, xx, yy, n, lanes, val_stride, x_stride);
  else if (x_stride == 0)
    sell_spmv_lanes_kernel<T, false, true><<<grid, kWarps * 32, 0, st>>>(
        sp, cl, vv, xx, yy, n, lanes, val_stride, x_stride);
  else
    sell_spmv_lanes_kernel<T, false, false><<<grid, kWarps * 32, 0, st>>>(
        sp, cl, vv, xx, yy, n, lanes, val_stride, x_stride);
  return (int)cudaGetLastError();
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

// lanes: y (lanes, n); val_stride / x_stride: elements between lanes' value
// arrays / right-hand sides (0: one array shared by every lane; not both)
REPRO_EXPORT int bell_spmv_lanes_f32(const void* slice_ptr, const void* cols,
                                     const void* vals, const void* x, void* y,
                                     long long n, int lanes, long long val_stride,
                                     long long x_stride, void* stream) {
  return launch_lanes<float>(slice_ptr, cols, vals, x, y, n, lanes, val_stride,
                             x_stride, stream);
}

REPRO_EXPORT int bell_spmv_lanes_f64(const void* slice_ptr, const void* cols,
                                     const void* vals, const void* x, void* y,
                                     long long n, int lanes, long long val_stride,
                                     long long x_stride, void* stream) {
  return launch_lanes<double>(slice_ptr, cols, vals, x, y, n, lanes, val_stride,
                              x_stride, stream);
}
