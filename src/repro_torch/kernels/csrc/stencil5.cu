// Variable-coefficient 5-point stencil SpMV, y = A x, on Hopper.
//
// Replaces the TPU kernel repro/kernels/stencil5.py::stencil5_pallas (its
// pallas_call at stencil5.py:77).  The TPU version tiles the grid into
// 8-row bands resident in VMEM, pads ny to 128 lanes and clamps the halo
// band index at the domain edge.  None of that carries over: here each
// thread owns one output cell, threads of a warp sit on neighbouring j so
// every plane read, the x reads and the y write coalesce, and the domain
// edge is masked in the kernel (no padding, no clamping).  The halo rows
// i-1 / i+1 are read straight from device memory; neighbouring blocks hit
// them in L2, so each x element crosses HBM about once.
//
// Bound: bytes.  Per cell 5 coefficients + x read + y written = 7 words
// (f64: 56 B); 9 flops per 56 B is far below the card's balance point.  At
// ng = 2048 that is 235 MB, 70 us at 3.35 TB/s.
//
// The same kernel applies A^T, given the transposed planes.
#include "common.cuh"

namespace {

constexpr int kBx = 32;   // threads along j (one warp → coalesced rows)
constexpr int kBy = 8;    // rows per block

template <typename T>
__global__ void __launch_bounds__(kBx * kBy)
stencil5_kernel(const T* __restrict__ val5, const T* __restrict__ x,
                T* __restrict__ y, int nx, int ny) {
  const int j = blockIdx.x * kBx + threadIdx.x;
  const int i = blockIdx.y * kBy + threadIdx.y;
  if (i >= nx || j >= ny) return;
  const size_t plane = (size_t)nx * ny;
  const size_t c = (size_t)i * ny + j;
  T acc = val5[c] * x[c];
  if (i > 0) acc += val5[plane + c] * x[c - ny];            // N: x[i-1, j]
  if (i < nx - 1) acc += val5[2 * plane + c] * x[c + ny];   // S: x[i+1, j]
  if (j > 0) acc += val5[3 * plane + c] * x[c - 1];         // W: x[i, j-1]
  if (j < ny - 1) acc += val5[4 * plane + c] * x[c + 1];    // E: x[i, j+1]
  y[c] = acc;
}

template <typename T>
int launch(const void* val5, const void* x, void* y, int nx, int ny, void* stream) {
  if (nx <= 0 || ny <= 0) return 0;
  dim3 block(kBx, kBy);
  dim3 grid((ny + kBx - 1) / kBx, (nx + kBy - 1) / kBy);
  stencil5_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)val5, (const T*)x, (T*)y, nx, ny);
  return (int)cudaGetLastError();
}

}  // namespace

REPRO_EXPORT int stencil5_f32(const void* val5, const void* x, void* y, int nx, int ny,
                              void* stream) {
  return launch<float>(val5, x, y, nx, ny, stream);
}

REPRO_EXPORT int stencil5_f64(const void* val5, const void* x, void* y, int nx, int ny,
                              void* stream) {
  return launch<double>(val5, x, y, nx, ny, stream);
}
