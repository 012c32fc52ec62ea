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
// the read-only cache and each lane stores its y[r] once.  The sum runs over
// a row's entries in a fixed order with no atomics, so every run gives the
// same bits.
//
// Bound: bytes.  12 B per padded entry (f64 value + int32 column; 8 B in
// f32), x read once, y written once, slice_ptr read once: 79.9 MB at
// poisson2d(1024) f64 (5,240,832 slots for 5,238,784 nonzeros), 0.0239 ms
// at 3.35 TB/s, against 83.8 MB (0.0250 ms) for CSR.
//
// Lanes (the reference's jax.vmap of the Pallas kernel, written out): one
// pattern, B value arrays and/or B right-hand sides, in three layouts that
// share sell_spmv_lanes_kernel through two flags: batched values with
// batched x, batched values with one x (kXShared), and one value array with
// k right-hand sides (kValShared: an SpMM).  It keeps one warp per slice and
// one lane per row; a thread carries NL accumulators, NL a template
// argument in {1, 2, 4, 8}.  B is split into chunks of those sizes
// (spmv_bell.lane_chunks: 8s, then the binary digits of the rest, so B 20
// = 2 x 8 + 4), all in one launch: block b takes chunk b % chunks of its
// block of slices and runs that chunk's NL-lane body, so no accumulator is
// dead and no lane step is predicated.  The kernel is instantiated for the
// largest chunk of the split, so its registers are that body's.  (A 16-lane chunk lost to two
// 8-lane ones by 12-30% at 16 and 32 lanes on an H100.)  The chunk is the
// fast grid axis: the chunks of one block of slices run next to each other
// and share its columns in L2.
//
// A thread walks its row in groups of U slots: it starts the group's
// column loads and, for batched values, the group's NL x U value loads,
// then the NL x U gathers of x, and only then the fused multiply-adds, so
// a warp keeps a group's loads in flight where a slot-at-a-time loop
// waited on each column before its gathers.  U gives about 16 loads a
// group where values and x are both per lane and 8 where one is shared (at
// most 8 slots).  All loads go through the read-only path with no cache
// policy: an L1 no-allocate, L2 evict-first policy on the values and
// columns gained 8-10% at B = 1 and lost 2-15% from B = 2 on (most in an
// SpMM, whose chunks share the values) on an H100.  Lane b's sum runs over
// the same slots in the same order with the same fused multiply-add as
// sell_spmv_kernel, so lane b equals the single-vector kernel on lane b
// bit for bit and B = 1 equals it outright.
//
// Bound (bytes), B lanes: B value arrays (or one, SpMM), the pattern once,
// B x read and B y written.  At poisson2d(1024) f64, B = 8: 335 + 21 + 67
// + 67 MB = 490 MB, 0.146 ms; SpMM with k = 16: 42 + 21 + 134 + 134 MB =
// 331 MB, 0.099 ms.
// The rows in flight at once gather x from a window of a few MB per lane
// (a banded pattern), so x crosses HBM about once however many lanes run:
// with batched values the rate stays at 76-88% of 3.35 TB/s from B 1 to 32
// on an H100 (8-268 MB of x), with no drop where the lanes' x outgrow the
// 50 MB L2 (tests/_torch_spmv_lanes_bench.py).
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

__device__ __forceinline__ float madd(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double madd(double a, double b, double c) { return fma(a, b, c); }

// slots a thread loads before it multiplies: 16 loads a group where both
// values and x are per lane (2 NL a slot), 8 where one of them is shared
// (NL + 1), at most 8 slots
template <int NL, bool kBoth>
constexpr int kGroupSlots = (kBoth ? 16 : 8) / NL < 8 ? (kBoth ? 16 : 8) / NL : 8;

// one chunk of NL lanes, from lane b0, of slice s
template <typename T, int NL, bool kValShared, bool kXShared>
__device__ __forceinline__ void lanes_chunk(
    const long long* __restrict__ slice_ptr, const int32_t* __restrict__ cols,
    const T* __restrict__ vals, const T* __restrict__ x, T* __restrict__ y,
    long long n, long long s, long long b0, long long val_stride,
    long long x_stride) {
  constexpr int U = kGroupSlots<NL, !kValShared && !kXShared>;
  constexpr int NV = kValShared ? 1 : NL;   // value loads a slot
  constexpr int NX = kXShared ? 1 : NL;     // x gathers a slot
  const int lane = threadIdx.x & 31;
  const long long row = s * 32 + lane;
  if (!kValShared) vals += b0 * val_stride;
  if (!kXShared) x += b0 * x_stride;
  y += b0 * n;
  const long long sp0 = __ldg(slice_ptr + s);
  const int steps = (int)((__ldg(slice_ptr + s + 1) - sp0) >> 5);
  const int32_t* cp = cols + sp0 + lane;
  const T* vp = vals + sp0 + lane;
  T acc[NL];
#pragma unroll
  for (int l = 0; l < NL; ++l) acc[l] = T(0);
  for (int j = 0; j < steps; j += U) {
    int c[U];
    T v[U][NV], xv[U][NX];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      c[u] = 0;
      if (j + u < steps) c[u] = __ldg(cp + 32 * (j + u));
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int l = 0; l < NV; ++l) {
        v[u][l] = T(0);
        if (j + u < steps) v[u][l] = __ldg(vp + l * val_stride + 32 * (j + u));
      }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int l = 0; l < NX; ++l) {
        xv[u][l] = T(0);
        if (j + u < steps) xv[u][l] = __ldg(x + l * x_stride + c[u]);
      }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (j + u < steps) {
#pragma unroll
        for (int l = 0; l < NL; ++l)
          acc[l] = madd(v[u][kValShared ? 0 : l], xv[u][kXShared ? 0 : l], acc[l]);
      }
  }
  if (row < n) {
#pragma unroll
    for (int l = 0; l < NL; ++l) y[l * n + row] = acc[l];
  }
}

// chunk k of the chunks smaller than C * 2: one per set bit of `rest`,
// largest first, from lane b0
template <typename T, int C, bool kValShared, bool kXShared>
__device__ __forceinline__ void rest_chunk(
    int k, int rest, long long b0, const long long* slice_ptr,
    const int32_t* cols, const T* vals, const T* x, T* y, long long n,
    long long s, long long val_stride, long long x_stride) {
  if constexpr (C > 0) {
    if (rest & C) {
      if (k == 0) {
        lanes_chunk<T, C, kValShared, kXShared>(slice_ptr, cols, vals, x, y, n,
                                                s, b0, val_stride, x_stride);
        return;
      }
      --k;
      b0 += C;
    }
    rest_chunk<T, C / 2, kValShared, kXShared>(k, rest, b0, slice_ptr, cols,
                                               vals, x, y, n, s, val_stride,
                                               x_stride);
  }
}

// `lanes` lanes in one launch: lanes / NL chunks of NL lanes, then one
// chunk per set bit of lanes % NL; block b takes chunk b % chunks of the
// block of slices b / chunks
template <typename T, int NL, bool kValShared, bool kXShared>
__global__ void __launch_bounds__(kWarps * 32)
sell_spmv_lanes_kernel(const long long* __restrict__ slice_ptr,
                       const int32_t* __restrict__ cols,
                       const T* __restrict__ vals, const T* __restrict__ x,
                       T* __restrict__ y, long long n, int lanes,
                       long long val_stride, long long x_stride) {
  const int full = lanes / NL, rest = lanes % NL;
  const int chunks = full + __popc(rest);
  const int chunk = blockIdx.x % chunks;
  const long long s = (long long)(blockIdx.x / chunks) * kWarps + (threadIdx.x >> 5);
  if (s * 32 >= n) return;
  if (chunk < full)
    lanes_chunk<T, NL, kValShared, kXShared>(slice_ptr, cols, vals, x, y, n, s,
                                             (long long)chunk * NL, val_stride,
                                             x_stride);
  else
    rest_chunk<T, NL / 2, kValShared, kXShared>(
        chunk - full, rest, (long long)full * NL, slice_ptr, cols, vals, x, y,
        n, s, val_stride, x_stride);
}

template <typename T, int NL>
void launch_chunk(dim3 grid, cudaStream_t st, const long long* sp,
                  const int32_t* cl, const T* vv, const T* xx, T* yy,
                  long long n, int lanes, long long val_stride,
                  long long x_stride) {
  if (val_stride == 0)
    sell_spmv_lanes_kernel<T, NL, true, false><<<grid, kWarps * 32, 0, st>>>(
        sp, cl, vv, xx, yy, n, lanes, val_stride, x_stride);
  else if (x_stride == 0)
    sell_spmv_lanes_kernel<T, NL, false, true><<<grid, kWarps * 32, 0, st>>>(
        sp, cl, vv, xx, yy, n, lanes, val_stride, x_stride);
  else
    sell_spmv_lanes_kernel<T, NL, false, false><<<grid, kWarps * 32, 0, st>>>(
        sp, cl, vv, xx, yy, n, lanes, val_stride, x_stride);
}

// one launch: `lanes` lanes in chunks of `chunk` (1, 2, 4 or 8) lanes and,
// for lanes % chunk, one smaller chunk per set bit
template <typename T>
int launch_lanes(const void* slice_ptr, const void* cols, const void* vals,
                 const void* x, void* y, long long n, int lanes, int chunk,
                 long long val_stride, long long x_stride, void* stream) {
  if (n <= 0 || lanes <= 0) return 0;
  if ((val_stride == 0 && x_stride == 0) || chunk <= 0 || chunk > 8 ||
      (chunk & (chunk - 1)))
    return (int)cudaErrorInvalidValue;
  const long long n_slices = (n + 31) / 32;
  const long long chunks = lanes / chunk + __builtin_popcount(lanes % chunk);
  const long long blocks = (n_slices + kWarps - 1) / kWarps * chunks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  const auto* sp = (const long long*)slice_ptr;
  const auto* cl = (const int32_t*)cols;
  const auto* vv = (const T*)vals;
  const auto* xx = (const T*)x;
  auto* yy = (T*)y;
  cudaStream_t st = (cudaStream_t)stream;
  switch (chunk) {
    case 1: launch_chunk<T, 1>(grid, st, sp, cl, vv, xx, yy, n, lanes, val_stride, x_stride); break;
    case 2: launch_chunk<T, 2>(grid, st, sp, cl, vv, xx, yy, n, lanes, val_stride, x_stride); break;
    case 4: launch_chunk<T, 4>(grid, st, sp, cl, vv, xx, yy, n, lanes, val_stride, x_stride); break;
    default: launch_chunk<T, 8>(grid, st, sp, cl, vv, xx, yy, n, lanes, val_stride, x_stride); break;
  }
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

// lanes: y (lanes, n), in one launch, in chunks of `chunk` lanes (1, 2, 4
// or 8) and one smaller chunk per set bit of lanes % chunk; val_stride /
// x_stride: elements between lanes' value arrays / right-hand sides (0: one
// array shared by every lane; not both)
REPRO_EXPORT int bell_spmv_lanes_f32(const void* slice_ptr, const void* cols,
                                     const void* vals, const void* x, void* y,
                                     long long n, int lanes, int chunk,
                                     long long val_stride, long long x_stride,
                                     void* stream) {
  return launch_lanes<float>(slice_ptr, cols, vals, x, y, n, lanes, chunk,
                             val_stride, x_stride, stream);
}

REPRO_EXPORT int bell_spmv_lanes_f64(const void* slice_ptr, const void* cols,
                                     const void* vals, const void* x, void* y,
                                     long long n, int lanes, int chunk,
                                     long long val_stride, long long x_stride,
                                     void* stream) {
  return launch_lanes<double>(slice_ptr, cols, vals, x, y, n, lanes, chunk,
                              val_stride, x_stride, stream);
}
