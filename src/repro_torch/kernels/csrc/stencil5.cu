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
//
// Lanes (the reference's jax.vmap of the Pallas kernel, written out): the
// grid's z axis is the lane.  Lane b reads its planes at val5 + b * v_stride
// (v_stride 0: one operator shared by k right-hand sides) and its x and y at
// b * nx * ny.  The single-vector entry point is the same kernel with one
// lane, so lane b equals it bit for bit.  Bound: B lanes move 7 words a cell
// (2 + 5/B with shared planes): at ng = 2048, B = 4, 940 MB, 0.280 ms.
#include "common.cuh"

namespace {

constexpr int kBx = 32;   // threads along j (one warp → coalesced rows)
constexpr int kBy = 8;    // rows per block

template <typename T>
__global__ void __launch_bounds__(kBx * kBy)
stencil5_kernel(const T* __restrict__ val5, const T* __restrict__ x,
                T* __restrict__ y, int nx, int ny, long long v_stride) {
  const int j = blockIdx.x * kBx + threadIdx.x;
  const int i = blockIdx.y * kBy + threadIdx.y;
  if (i >= nx || j >= ny) return;
  const size_t plane = (size_t)nx * ny;
  val5 += blockIdx.z * v_stride;
  x += blockIdx.z * plane;
  y += blockIdx.z * plane;
  const size_t c = (size_t)i * ny + j;
  T acc = val5[c] * x[c];
  if (i > 0) acc += val5[plane + c] * x[c - ny];            // N: x[i-1, j]
  if (i < nx - 1) acc += val5[2 * plane + c] * x[c + ny];   // S: x[i+1, j]
  if (j > 0) acc += val5[3 * plane + c] * x[c - 1];         // W: x[i, j-1]
  if (j < ny - 1) acc += val5[4 * plane + c] * x[c + 1];    // E: x[i, j+1]
  y[c] = acc;
}

template <typename T>
int launch(const void* val5, const void* x, void* y, int nx, int ny, int lanes,
           long long v_stride, void* stream) {
  if (nx <= 0 || ny <= 0 || lanes <= 0) return 0;
  if (lanes > 65535) return (int)cudaErrorInvalidValue;
  dim3 block(kBx, kBy);
  dim3 grid((ny + kBx - 1) / kBx, (nx + kBy - 1) / kBy, lanes);
  stencil5_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)val5, (const T*)x, (T*)y, nx, ny, v_stride);
  return (int)cudaGetLastError();
}

}  // namespace

REPRO_EXPORT int stencil5_f32(const void* val5, const void* x, void* y, int nx, int ny,
                              void* stream) {
  return launch<float>(val5, x, y, nx, ny, 1, 0, stream);
}

REPRO_EXPORT int stencil5_f64(const void* val5, const void* x, void* y, int nx, int ny,
                              void* stream) {
  return launch<double>(val5, x, y, nx, ny, 1, 0, stream);
}

// lanes: x, y (lanes, nx, ny); v_stride: elements between lanes' planes
// (5 nx ny, or 0 for one operator applied to every lane's x)
REPRO_EXPORT int stencil5_lanes_f32(const void* val5, const void* x, void* y, int nx,
                                    int ny, int lanes, long long v_stride,
                                    void* stream) {
  return launch<float>(val5, x, y, nx, ny, lanes, v_stride, stream);
}

REPRO_EXPORT int stencil5_lanes_f64(const void* val5, const void* x, void* y, int nx,
                                    int ny, int lanes, long long v_stride,
                                    void* stream) {
  return launch<double>(val5, x, y, nx, ny, lanes, v_stride, stream);
}
