// Fused CG / BiCGStab step passes on Hopper: one templated streaming kernel,
// one body functor per fused step.
//
// Replaces the TPU kernel family repro/kernels/solve_step.py (the
// pallas_call at solve_step.py:92, reached by fused_cg_update,
// fused_cg_direction, fused_cg_halfstep, fused_cheb_step, fused_dots2,
// fused_bicg_p, fused_bicg_s and fused_bicg_tail).  The TPU version views
// the vectors as zero-padded (nb, 8, 128) tiles, keeps scalars in SMEM and
// accumulates the dots in place over its in-order grid.  Here:
//
// * Each thread walks the n-vectors with a grid stride; the ragged tail is
//   masked by the loop bound, so there is no padding and the dots are exact.
// * Reductions run in two passes with no atomics: per-block partials (a
//   fixed shared-memory tree) into a scratch buffer the wrapper allocates,
//   then one block sums the partials in a fixed order.  The grid size only
//   depends on n, so a solve is bit-reproducible from run to run.
// * Scalars (alpha, beta, omega, restart) are read from DEVICE pointers and
//   the dots are written to device memory, so a Krylov loop never waits on
//   the host for a coefficient.
// * An optional device flag `active` gates the vector writes: once a solve
//   has converged, later launches of the same loop leave the state alone,
//   which lets the host check convergence only every few iterations.
//   Outputs may alias inputs element for element (in-place updates).
//
// * Lanes (the reference's jax.vmap of its while_loop, written out): the
//   grid is (n_blocks(n), B) and blockIdx.y is the lane.  Each input is
//   either (B, n) rows (stride n) or one (n,) vector shared by every lane
//   (stride 0, e.g. the Jacobi diagonal of a multi-rhs solve); outputs are
//   (B, n) rows; each scalar is one per lane or one for all; `active` is one
//   int32 flag per lane; partials are (B, nblocks, n_dot) and one finish
//   block per lane writes dots (B, n_dot).  A lane's blocks walk its row
//   exactly as the single-vector launch (B = 1) walks the vector, with the
//   same block count, so lane b's outputs and dots equal the single-vector
//   kernel's on lane b bit for bit.
//
// Bound: bytes.  Each body reads and writes its listed n-vectors once
// (e.g. fused_cg_update: 5 reads + 3 writes = 8 words per element, 268 MB
// at n = 4.19M in f64, 80 us at 3.35 TB/s); the dots add O(blocks).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxIn = 6, kMaxOut = 3, kMaxSc = 3, kMaxDot = 2;

template <typename T>
struct Args {
  const T* in[kMaxIn];
  T* out[kMaxOut];
  const T* sc[kMaxSc];
  long long in_stride[kMaxIn];  // elements between lanes: n, or 0 (shared)
  int sc_stride[kMaxSc];        // 1: one scalar per lane, 0: one for all
  const int32_t* active;        // one flag per lane, or null
  T* partials;
  long long n;
};

// ---- bodies: v = inputs at one index, s = scalars, o = outputs, d = dot terms
struct CgUpdate {  // x' = x + a p; r' = r - a s; z' = dinv r'; <r',z'>, <r',r'>
  static constexpr int kIn = 5, kOut = 3, kSc = 1, kDot = 2;
  template <typename T>
  __device__ static void apply(const T* v, const T* s, T* o, T* d) {
    const T xn = v[0] + s[0] * v[2];
    const T rn = v[1] - s[0] * v[3];
    const T zn = v[4] * rn;
    o[0] = xn; o[1] = rn; o[2] = zn;
    d[0] = rn * zn; d[1] = rn * rn;
  }
};

struct CgDirection {  // p' = z + b p; s' = w + b s; <w,z>
  static constexpr int kIn = 4, kOut = 2, kSc = 1, kDot = 1;
  template <typename T>
  __device__ static void apply(const T* v, const T* s, T* o, T* d) {
    o[0] = v[0] + s[0] * v[2];
    o[1] = v[1] + s[0] * v[3];
    d[0] = v[1] * v[0];
  }
};

struct CgHalfstep {  // x' = x + a p; r' = r - a s; <r',r'>
  static constexpr int kIn = 4, kOut = 2, kSc = 1, kDot = 1;
  template <typename T>
  __device__ static void apply(const T* v, const T* s, T* o, T* d) {
    const T rn = v[1] - s[0] * v[3];
    o[0] = v[0] + s[0] * v[2];
    o[1] = rn;
    d[0] = rn * rn;
  }
};

struct ChebStep {  // d' = c1 d + c2 r; x' = x + d'
  static constexpr int kIn = 3, kOut = 2, kSc = 2, kDot = 0;
  template <typename T>
  __device__ static void apply(const T* v, const T* s, T* o, T*) {
    const T dn = s[0] * v[1] + s[1] * v[2];
    o[0] = v[0] + dn;
    o[1] = dn;
  }
};

struct Dots2 {  // <u,v>, <u,u>
  static constexpr int kIn = 2, kOut = 0, kSc = 0, kDot = 2;
  template <typename T>
  __device__ static void apply(const T* v, const T*, T*, T* d) {
    d[0] = v[0] * v[1];
    d[1] = v[0] * v[0];
  }
};

struct BicgP {  // p' = r + b (p - w v)  (p' = r on restart); p^ = dinv p'
  static constexpr int kIn = 4, kOut = 2, kSc = 3, kDot = 0;
  template <typename T>
  __device__ static void apply(const T* v, const T* s, T* o, T*) {
    const T pn = (s[2] != T(0)) ? v[0] : v[0] + s[0] * (v[1] - s[1] * v[2]);
    o[0] = pn;
    o[1] = v[3] * pn;
  }
};

struct BicgS {  // s = r - a v; s^ = dinv s
  static constexpr int kIn = 3, kOut = 2, kSc = 1, kDot = 0;
  template <typename T>
  __device__ static void apply(const T* v, const T* s, T* o, T*) {
    const T sn = v[0] - s[0] * v[1];
    o[0] = sn;
    o[1] = v[2] * sn;
  }
};

struct BicgTail {  // x' = x + a p^ + w s^; r' = s - w t; <r^,r'>, <r',r'>
  static constexpr int kIn = 6, kOut = 2, kSc = 2, kDot = 2;
  template <typename T>
  __device__ static void apply(const T* v, const T* s, T* o, T* d) {
    const T xn = v[0] + s[0] * v[3] + s[1] * v[4];
    const T rn = v[1] - s[1] * v[2];
    o[0] = xn; o[1] = rn;
    d[0] = v[5] * rn; d[1] = rn * rn;
  }
};

// ---- the streaming template -------------------------------------------------
template <typename T, typename B>
__global__ void __launch_bounds__(kThreads) step_kernel(Args<T> a) {
  const int lane = blockIdx.y;
  T s[kMaxSc];
#pragma unroll
  for (int j = 0; j < B::kSc; ++j) s[j] = a.sc[j][lane * a.sc_stride[j]];
  const bool write = (a.active == nullptr) || (a.active[lane] != 0);
  const T* in[kMaxIn];
  T* out[kMaxOut];
#pragma unroll
  for (int j = 0; j < B::kIn; ++j) in[j] = a.in[j] + lane * a.in_stride[j];
#pragma unroll
  for (int j = 0; j < B::kOut; ++j) out[j] = a.out[j] + lane * a.n;
  T acc[kMaxDot];
#pragma unroll
  for (int j = 0; j < kMaxDot; ++j) acc[j] = T(0);
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < a.n; i += stride) {
    T v[kMaxIn], o[kMaxOut], d[kMaxDot];
#pragma unroll
    for (int j = 0; j < B::kIn; ++j) v[j] = in[j][i];
    B::apply(v, s, o, d);
    if (write) {
#pragma unroll
      for (int j = 0; j < B::kOut; ++j) out[j][i] = o[j];
    }
#pragma unroll
    for (int j = 0; j < B::kDot; ++j) acc[j] += d[j];
  }
  if constexpr (B::kDot > 0) {
    __shared__ T red[B::kDot][kThreads];
#pragma unroll
    for (int j = 0; j < B::kDot; ++j) red[j][threadIdx.x] = acc[j];
    __syncthreads();
    for (int w = kThreads / 2; w > 0; w >>= 1) {
      if (threadIdx.x < w) {
#pragma unroll
        for (int j = 0; j < B::kDot; ++j) red[j][threadIdx.x] += red[j][threadIdx.x + w];
      }
      __syncthreads();
    }
    if (threadIdx.x == 0) {
#pragma unroll
      for (int j = 0; j < B::kDot; ++j)
        a.partials[((long long)lane * gridDim.x + blockIdx.x) * B::kDot + j] = red[j][0];
    }
  }
}

// second pass: one block per lane sums its per-block partials in a fixed order
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
finish_kernel(const T* __restrict__ partials, int nblocks, T* __restrict__ dots) {
  partials += (long long)blockIdx.x * nblocks * D;
  dots += (long long)blockIdx.x * D;
  __shared__ T red[D][kThreads];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    T acc = T(0);
    for (int b = threadIdx.x; b < nblocks; b += kThreads) acc += partials[b * D + j];
    red[j][threadIdx.x] = acc;
  }
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) {
#pragma unroll
      for (int j = 0; j < D; ++j) red[j][threadIdx.x] += red[j][threadIdx.x + w];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < D; ++j) dots[j] = red[j][0];
  }
}

template <typename T, typename B>
int launch(void** in, void** out, void** sc, const long long* in_stride,
           const int* sc_stride, const void* active, void* partials, void* dots,
           long long n, int nblocks, int lanes, cudaStream_t stream) {
  Args<T> a = {};
  for (int j = 0; j < B::kIn; ++j) {
    a.in[j] = (const T*)in[j];
    a.in_stride[j] = in_stride[j];
  }
  for (int j = 0; j < B::kOut; ++j) a.out[j] = (T*)out[j];
  for (int j = 0; j < B::kSc; ++j) {
    a.sc[j] = (const T*)sc[j];
    a.sc_stride[j] = sc_stride[j];
  }
  a.active = (const int32_t*)active;
  a.partials = (T*)partials;
  a.n = n;
  if (nblocks < 1 || lanes < 1 || lanes > 65535) return (int)cudaErrorInvalidValue;
  step_kernel<T, B><<<dim3(nblocks, lanes), kThreads, 0, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if constexpr (B::kDot > 0) {
    finish_kernel<T, B::kDot><<<lanes, kThreads, 0, stream>>>((const T*)partials,
                                                              nblocks, (T*)dots);
    e = cudaGetLastError();
  }
  return (int)e;
}

#define STEP_ARGS in, out, sc, in_stride, sc_stride, active, partials, dots, n, nblocks, lanes, st

template <typename T>
int dispatch(int body, void** in, void** out, void** sc, const long long* in_stride,
             const int* sc_stride, const void* active, void* partials, void* dots,
             long long n, int nblocks, int lanes, cudaStream_t st) {
  switch (body) {
    case 0: return launch<T, CgUpdate>(STEP_ARGS);
    case 1: return launch<T, CgDirection>(STEP_ARGS);
    case 2: return launch<T, CgHalfstep>(STEP_ARGS);
    case 3: return launch<T, ChebStep>(STEP_ARGS);
    case 4: return launch<T, Dots2>(STEP_ARGS);
    case 5: return launch<T, BicgP>(STEP_ARGS);
    case 6: return launch<T, BicgS>(STEP_ARGS);
    case 7: return launch<T, BicgTail>(STEP_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// body: 0 cg_update, 1 cg_direction, 2 cg_halfstep, 3 cheb_step, 4 dots2,
//       5 bicg_p, 6 bicg_s, 7 bicg_tail;  dtype: 0 float32, 1 float64;
// lanes: rows of the outputs; in_stride / sc_stride: see Args
REPRO_EXPORT int fused_step(int body, int dtype, void** in, void** out, void** sc,
                            const long long* in_stride, const int* sc_stride,
                            const void* active, void* partials, void* dots, long long n,
                            int nblocks, int lanes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return dispatch<float>(body, STEP_ARGS);
  if (dtype == 1) return dispatch<double>(body, STEP_ARGS);
  return (int)cudaErrorInvalidValue;
}
