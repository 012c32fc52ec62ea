// Block-ELL SpMV, y = A x, on Hopper.
//
// Replaces the TPU kernel repro/kernels/spmv_bell.py::bell_spmv_pallas (its
// pallas_call at spmv_bell.py:66).  The TPU version runs a (n_rb, k) grid in
// order, scalar-prefetches the slot table into SMEM and accumulates each
// output band in place across the k slot steps.  CUDA blocks run in no
// order, so here ONE block owns one row band: it loops over the band's k
// slots itself, reads its own block_cols row, and writes its bm output rows
// once — no atomics, and the sum order is fixed, so the result is the same
// on every run.  Warp w of the block owns row w of the band; its 32 lanes
// stride the bn columns of the (bm, bn) tile, so every tile row is one
// coalesced read, and a shuffle reduction finishes the row.
//
// Bound: bytes.  The dense tiles dominate: n_rb*k*bm*bn words (f64 at
// poisson2d(1024): 4.29 GB, 1.28 ms at 3.35 TB/s), 2 flops per tile word.
// At the ~1% fill of 2-D Poisson that is ~30x the bytes of a CSR product of
// the same matrix; the layout is kept because it is the reference's
// contract (build_bell slot tables), not because it is fast here.
#include "common.cuh"

namespace {

template <typename T>
__global__ void bell_spmv_kernel(const int32_t* __restrict__ block_cols,
                                 const T* __restrict__ vals,
                                 const T* __restrict__ x, T* __restrict__ y,
                                 long long n, long long m, int k, int bm, int bn) {
  const long long r = blockIdx.x;
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  T acc = T(0);
  for (int s = 0; s < k; ++s) {
    const long long c0 = (long long)block_cols[r * k + s] * bn;
    const T* tile = vals + ((r * k + s) * bm + w) * (long long)bn;
    for (int l = lane; l < bn; l += 32) {
      const long long c = c0 + l;
      const T xv = c < m ? x[c] : T(0);
      acc += tile[l] * xv;
    }
  }
  acc = repro::warp_sum(acc);
  const long long row = r * bm + w;
  if (lane == 0 && row < n) y[row] = acc;
}

template <typename T>
int launch(const void* block_cols, const void* vals, const void* x, void* y,
           long long n, long long m, int n_rb, int k, int bm, int bn, void* stream) {
  if (n_rb <= 0) return 0;
  if (bm <= 0 || bm * 32 > 1024 || bn <= 0) return (int)cudaErrorInvalidValue;
  bell_spmv_kernel<T><<<n_rb, bm * 32, 0, (cudaStream_t)stream>>>(
      (const int32_t*)block_cols, (const T*)vals, (const T*)x, (T*)y, n, m, k, bm, bn);
  return (int)cudaGetLastError();
}

}  // namespace

REPRO_EXPORT int bell_spmv_f32(const void* block_cols, const void* vals, const void* x,
                               void* y, long long n, long long m, int n_rb, int k,
                               int bm, int bn, void* stream) {
  return launch<float>(block_cols, vals, x, y, n, m, n_rb, k, bm, bn, stream);
}

REPRO_EXPORT int bell_spmv_f64(const void* block_cols, const void* vals, const void* x,
                               void* y, long long n, long long m, int n_rb, int k,
                               int bm, int bn, void* stream) {
  return launch<double>(block_cols, vals, x, y, n, m, n_rb, k, bm, bn, stream);
}
