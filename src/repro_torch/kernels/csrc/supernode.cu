// Supernodal panel kernels of the sparse direct solver, on Hopper:
// panel_factor, schur_update and block_trsv.
//
// Replaces the TPU kernels of repro/kernels/supernode.py: panel_factor (its
// pallas_call at supernode.py:73), schur_update (:123) and block_trsv
// (:158).  The TPU versions run one supernode lane per grid step with the
// whole (wb+rb, wb) panel and its (wb, rb) U panel resident in VMEM and call
// the reference's single-lane bodies on them.  A Hopper block has at most
// 227 KB of shared memory, and the widest bucket of poisson2d(316) is
// (wb, rb) = (32, 1024): P is 270 KB and Q 262 KB in f64.  So:
//
// * panel_factor: one block per lane.  Only the masked (wb x wb) diagonal
//   block D sits in shared memory (<= 8 KB); it is factored in order over t,
//   1x1 or as a static 2x2 Bunch-Kaufman pair, exactly as the reference's
//   sn_panel_factor_body.  After that the rb sub-panel rows and the rb U
//   columns are independent of each other: one thread per sub-row replays
//   the column eliminations on its row (l = P[i,t]/d_t or the 2x2 solve,
//   P[i,j] -= l*U[t,j]) on a copy of the row in its slice of shared
//   memory (<= 34 KB per block), one thread per U column
//   replays Q[a,c] -= L[a,t]*Q[t,c].  Both read the final D (its row t past
//   the diagonal is U[t,:] as it stood at step t, its column t below the
//   diagonal is L[:,t]) and stream through device memory.  Pad rows,
//   columns and lanes are masked here, since gathered pad slots hold
//   garbage.  Each lane adds its count of clamped pivots to one device
//   scalar (nbad), read on the host once per factorization.
// * schur_update: a tiled batched GEMM S = L_sub (rb x wb) * U (wb x rb).
//   The grid runs over (lane group, 32x32 output tile); the L_sub rows and
//   U columns of a tile, for the whole depth wb <= 32, sit in shared memory
//   in one stage.  Buckets with rb < 32 put several lanes in one block.
// * block_trsv: one warp per (lane, right-hand side); thread i holds x[i]
//   (wb <= 32), the masked block D sits in shared memory, and x[t] is
//   broadcast with __shfl_sync.  Modes l / lt / u / ut and the pair branch
//   of the reference's sn_trsv_body; y is (k, wb, m) with m >= 1.
//
// The file is compiled with -fmad=false (see _build.py) so that no a - b*c
// is contracted into an FMA: the factor and solve keep the reference's
// per-element rounding.  schur_update sums with explicit fma().
//
// Bounds (f64 at 3.35 TB/s): panel_factor and block_trsv read and write
// their panels once and do O(wb) flops per word: bytes.  schur_update does
// 2*wb flops per output word; at wb = 32, 64 flops per 8 bytes written
// plus the panels read, below the card's f64 balance point: bytes as well.
#include "common.cuh"

#include <float.h>

namespace {

__device__ __forceinline__ float absv(float x) { return fabsf(x); }
__device__ __forceinline__ double absv(double x) { return fabs(x); }
__device__ __forceinline__ float maxv(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double maxv(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float fmav(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fmav(double a, double b, double c) { return fma(a, b, c); }

template <typename T> struct Lim;
template <> struct Lim<float> {
  static __device__ __forceinline__ float eps() { return FLT_EPSILON; }
  static __device__ __forceinline__ float tiny() { return FLT_MIN; }
};
template <> struct Lim<double> {
  static __device__ __forceinline__ double eps() { return DBL_EPSILON; }
  static __device__ __forceinline__ double tiny() { return DBL_MIN; }
};

// Clamped determinant of the 2x2 pivot [[a, b], [c, e]]: the floor is
// eps*max|E|^2 + tiny, computed the same way at factor and solve time.
template <typename T>
__device__ __forceinline__ T pair_det(T a, T b, T c, T e, bool* bad) {
  const T det = a * e - b * c;
  const T scale = maxv(maxv(absv(a), absv(e)), maxv(absv(b), absv(c)));
  const T fl = Lim<T>::eps() * scale * scale + Lim<T>::tiny();
  *bad = absv(det) < fl;
  return *bad ? (det < T(0) ? -fl : fl) : det;
}

// ---------------------------------------------------------------------------
// panel_factor
// ---------------------------------------------------------------------------

constexpr int kPfThreads = 128;
constexpr int kOneByOne = 0, kPairStart = 1, kPairSecond = 2;

template <typename T, int WBC, bool PAIRS>
__global__ void __launch_bounds__(kPfThreads)
panel_factor_kernel(const T* __restrict__ P, const T* __restrict__ Q,
                    T* __restrict__ Po, T* __restrict__ Qo,
                    const int32_t* __restrict__ wvec,
                    const int32_t* __restrict__ rvec,
                    const T* __restrict__ tau_p,
                    const uint8_t* __restrict__ bkm, T* __restrict__ nbad,
                    int wb, int rb, int guard) {
  __shared__ T D[WBC][WBC + 1];
  __shared__ T xs[kPfThreads][WBC + 1];      // f64, WBC = 32: 33.8 KB
  __shared__ T deff_s[WBC], dc_s[WBC], detc_s[WBC];
  __shared__ int kind_s[WBC];
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int w = wvec[lane];
  const int r = rvec[lane];
  const T tau = *tau_p;
  const size_t m = (size_t)wb + rb;
  const T* p = P + (size_t)lane * m * wb;
  const T* q = Q + (size_t)lane * wb * rb;
  T* po = Po + (size_t)lane * m * wb;
  T* qo = Qo + (size_t)lane * wb * rb;
  const uint8_t* bk = bkm + (size_t)lane * wb;

  // 1. the masked diagonal block: pad rows/cols zero, unit pad diagonal
  for (int e = tid; e < wb * wb; e += kPfThreads) {
    const int i = e / wb, j = e % wb;
    const T v = (i < w && j < w) ? p[e] : T(0);
    D[i][j] = v + ((i == j && j >= w) ? T(1) : T(0));
  }
  __syncthreads();

  // 2. factor D in order over t: thread 0 picks the step, all update
  constexpr int kPer = (WBC * WBC + kPfThreads - 1) / kPfThreads;
  T nb = T(0);
  for (int t = 0; t < wb; ++t) {
    if (tid == 0) {
      const bool start = PAIRS && bk[t] != 0;
      const bool second = PAIRS && t > 0 && bk[t - 1] != 0;
      const T d = D[t][t];
      const bool bad1 = guard && absv(d) < tau;
      const T dc = bad1 ? (d < T(0) ? -tau : tau) : d;
      dc_s[t] = dc;
      deff_s[t] = (start || second) ? T(1) : dc;
      if (start) {
        const int t1 = min(t + 1, wb - 1);
        bool bad2;
        detc_s[t] = pair_det(D[t][t], D[t][t1], D[t1][t], D[t1][t1], &bad2);
        kind_s[t] = kPairStart;
        nb += bad2 ? T(1) : T(0);
      } else if (second) {
        kind_s[t] = kPairSecond;
      } else {
        kind_s[t] = kOneByOne;
        nb += bad1 ? T(1) : T(0);
      }
    }
    __syncthreads();
    const int kind = kind_s[t];
    if (kind == kPairSecond) continue;   // uniform across the block
    T nv[kPer];
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int e = tid + c * kPfThreads;
      if (e >= wb * wb) break;
      const int i = e / wb, j = e % wb;
      T v;
      if (kind == kOneByOne) {
        const T colL = i > t ? D[i][t] / deff_s[t] : T(0);
        const T ur = j > t ? D[t][j] : T(0);
        v = D[i][j] - colL * ur;
        if (j == t) v = i > t ? colL : D[i][t];
        if (i == t && j == t) v = dc_s[t];
      } else {
        const int t1 = min(t + 1, wb - 1);
        const T a = D[t][t], b = D[t][t1], cc = D[t1][t], ee = D[t1][t1];
        const T dt = detc_s[t];
        const bool below = i > t1;
        const T u = below ? D[i][t] : T(0);
        const T vv = below ? D[i][t1] : T(0);
        const T lu = (u * ee - vv * cc) / dt;
        const T lv = (vv * a - u * b) / dt;
        const T u1 = j > t1 ? D[t][j] : T(0);
        const T u2 = j > t1 ? D[t1][j] : T(0);
        v = D[i][j] - lu * u1 - lv * u2;
        if (j == t) v = below ? lu : D[i][t];
        if (j == t1) v = below ? lv : D[i][t1];
      }
      nv[c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int e = tid + c * kPfThreads;
      if (e >= wb * wb) break;
      D[e / wb][e % wb] = nv[c];
    }
    __syncthreads();
  }
  // clamp counts are small integers: the atomic sum is exact in any order
  if (tid == 0 && nb != T(0)) atomicAdd(nbad, nb);
  for (int e = tid; e < wb * wb; e += kPfThreads) po[e] = D[e / wb][e % wb];

  // 3. sub-panel rows (items < rb) and U columns (items >= rb), independent
  //    of each other: each thread replays the eliminations on its own row
  //    or column, kept in its slice of shared memory (runtime-indexed, so
  //    registers would spill)
  T* x = xs[tid];
  for (int it = tid; it < 2 * rb; it += kPfThreads) {
    if (it < rb) {
      const int i = it;
      const T* prow = p + ((size_t)wb + i) * wb;
      const bool rok = i < r;
      for (int j = 0; j < wb; ++j)
        x[j] = (rok && j < w) ? prow[j] + T(0) : T(0);
      for (int t = 0; t < wb; ++t) {
        const int kind = kind_s[t];
        if (kind == kOneByOne) {
          const T colL = x[t] / deff_s[t];
          for (int j = 0; j < wb; ++j)
            x[j] = x[j] - colL * (j > t ? D[t][j] : T(0));
          x[t] = colL;
        } else if (PAIRS && kind == kPairStart) {
          const int t1 = min(t + 1, wb - 1);
          const T a = D[t][t], b = D[t][t1], cc = D[t1][t], ee = D[t1][t1];
          const T dt = detc_s[t];
          const T u = x[t], vv = x[t1];
          const T lu = (u * ee - vv * cc) / dt;
          const T lv = (vv * a - u * b) / dt;
          for (int j = 0; j < wb; ++j)
            x[j] = x[j] - lu * (j > t1 ? D[t][j] : T(0))
                   - lv * (j > t1 ? D[t1][j] : T(0));
          x[t] = lu;
          x[t1] = lv;
        }
      }
      T* orow = po + ((size_t)wb + i) * wb;
      for (int j = 0; j < wb; ++j) orow[j] = x[j];
    } else {
      const int c = it - rb;
      const bool cok = c < r;
      for (int a = 0; a < wb; ++a)
        x[a] = (a < w && cok) ? q[(size_t)a * rb + c] : T(0);
      for (int t = 0; t < wb; ++t) {
        const int kind = kind_s[t];
        if (kind == kOneByOne) {
          const T yt = x[t];
          for (int a = 0; a < wb; ++a)
            x[a] = x[a] - (a > t ? D[a][t] : T(0)) * yt;
        } else if (PAIRS && kind == kPairStart) {
          const int t1 = min(t + 1, wb - 1);
          const T yt = x[t], yt1 = x[t1];
          for (int a = 0; a < wb; ++a)
            x[a] = x[a] - (a > t1 ? D[a][t] : T(0)) * yt
                   - (a > t1 ? D[a][t1] : T(0)) * yt1;
        }
      }
      for (int a = 0; a < wb; ++a) qo[(size_t)a * rb + c] = x[a];
    }
  }
}

template <typename T, int WBC>
int launch_pf(const void* P, const void* Q, void* Po, void* Qo, const void* wvec,
              const void* rvec, const void* tau, const void* bkm, void* nbad, int k,
              int wb, int rb, int pairs, int guard, cudaStream_t s) {
  if (pairs)
    panel_factor_kernel<T, WBC, true><<<k, kPfThreads, 0, s>>>(
        (const T*)P, (const T*)Q, (T*)Po, (T*)Qo, (const int32_t*)wvec,
        (const int32_t*)rvec, (const T*)tau, (const uint8_t*)bkm, (T*)nbad, wb, rb,
        guard);
  else
    panel_factor_kernel<T, WBC, false><<<k, kPfThreads, 0, s>>>(
        (const T*)P, (const T*)Q, (T*)Po, (T*)Qo, (const int32_t*)wvec,
        (const int32_t*)rvec, (const T*)tau, (const uint8_t*)bkm, (T*)nbad, wb, rb,
        guard);
  return (int)cudaGetLastError();
}

template <typename T>
int panel_factor_t(const void* P, const void* Q, void* Po, void* Qo, const void* wvec,
                   const void* rvec, const void* tau, const void* bkm, void* nbad,
                   int k, int wb, int rb, int pairs, int guard, cudaStream_t s) {
  if (wb <= 2)
    return launch_pf<T, 2>(P, Q, Po, Qo, wvec, rvec, tau, bkm, nbad, k, wb, rb, pairs, guard, s);
  if (wb <= 4)
    return launch_pf<T, 4>(P, Q, Po, Qo, wvec, rvec, tau, bkm, nbad, k, wb, rb, pairs, guard, s);
  if (wb <= 8)
    return launch_pf<T, 8>(P, Q, Po, Qo, wvec, rvec, tau, bkm, nbad, k, wb, rb, pairs, guard, s);
  if (wb <= 16)
    return launch_pf<T, 16>(P, Q, Po, Qo, wvec, rvec, tau, bkm, nbad, k, wb, rb, pairs, guard, s);
  return launch_pf<T, 32>(P, Q, Po, Qo, wvec, rvec, tau, bkm, nbad, k, wb, rb, pairs, guard, s);
}

// ---------------------------------------------------------------------------
// schur_update
// ---------------------------------------------------------------------------

constexpr int kSchurThreads = 256;
constexpr int kTile = 32;
constexpr int kSchurSmem = 48 * 1024;

template <typename T>
__global__ void __launch_bounds__(kSchurThreads)
schur_kernel(const T* __restrict__ P, const T* __restrict__ Q, T* __restrict__ S,
             int k, int wb, int rb, int td, int tiles, int lpb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);     // [lpb][td][wb]: L_sub rows
  T* Bs = As + (size_t)lpb * td * wb;         // [lpb][wb][td]: U columns
  const int tid = threadIdx.x;
  const int lane0 = blockIdx.x * lpb;
  const int i0 = (blockIdx.y / tiles) * td;
  const int j0 = (blockIdx.y % tiles) * td;
  const size_t m = (size_t)wb + rb;
  const int na = lpb * td * wb;
  for (int e = tid; e < na; e += kSchurThreads) {
    const int l = e / (td * wb), rem = e % (td * wb);
    const int i = rem / wb, c = rem % wb;
    const int lane = lane0 + l;
    As[e] = (lane < k && i0 + i < rb)
                ? P[((size_t)lane * m + wb + i0 + i) * wb + c] : T(0);
  }
  for (int e = tid; e < na; e += kSchurThreads) {
    const int l = e / (wb * td), rem = e % (wb * td);
    const int c = rem / td, j = rem % td;
    const int lane = lane0 + l;
    Bs[e] = (lane < k && j0 + j < rb)
                ? Q[((size_t)lane * wb + c) * rb + j0 + j] : T(0);
  }
  __syncthreads();
  const int no = lpb * td * td;
  for (int e = tid; e < no; e += kSchurThreads) {
    const int l = e / (td * td), rem = e % (td * td);
    const int i = rem / td, j = rem % td;
    const int lane = lane0 + l;
    if (lane >= k || i0 + i >= rb || j0 + j >= rb) continue;
    const T* a = As + ((size_t)l * td + i) * wb;
    const T* b = Bs + (size_t)l * wb * td + j;
    T acc = T(0);
    for (int c = 0; c < wb; ++c) acc = fmav(a[c], b[(size_t)c * td], acc);
    S[((size_t)lane * rb + i0 + i) * rb + j0 + j] = acc;
  }
}

template <typename T>
int schur_t(const void* P, const void* Q, void* S, int k, int wb, int rb,
            cudaStream_t s) {
  const int td = rb < kTile ? rb : kTile;
  const int tiles = (rb + td - 1) / td;
  int lpb = 1;
  if (rb < kTile) {
    lpb = (kTile * kTile) / (rb * rb);
    const int cap = kSchurSmem / (2 * td * wb * (int)sizeof(T));
    if (lpb > cap) lpb = cap;
    if (lpb < 1) lpb = 1;
  }
  const size_t smem = (size_t)2 * lpb * td * wb * sizeof(T);
  if (smem > (size_t)kSchurSmem || (long long)tiles * tiles > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((k + lpb - 1) / lpb, tiles * tiles);
  schur_kernel<T><<<grid, kSchurThreads, smem, s>>>(
      (const T*)P, (const T*)Q, (T*)S, k, wb, rb, td, tiles, lpb);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// block_trsv
// ---------------------------------------------------------------------------

constexpr int kModeL = 0, kModeLT = 1, kModeU = 2, kModeUT = 3;
constexpr int kTrsvWarps = 4;

template <typename T, int MODE, bool PAIRS>
__global__ void __launch_bounds__(32 * kTrsvWarps)
block_trsv_kernel(const T* __restrict__ D, long long dstride,
                  const T* __restrict__ y, T* __restrict__ x,
                  const int32_t* __restrict__ wvec,
                  const uint8_t* __restrict__ bkm, int wb, int m) {
  __shared__ T Ds[32][33];
  __shared__ uint8_t bks[32];
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int w = wvec[lane];
  const T* d = D + (size_t)lane * dstride;
  const uint8_t* bk = bkm + (size_t)lane * wb;
  for (int e = tid; e < wb * wb; e += blockDim.x) {
    const int i = e / wb, j = e % wb;
    T v = (i < w && j < w) ? d[e] : T(0);
    v = v + ((i == j && i >= w) ? T(1) : T(0));
    // pair-start subdiagonal holds raw c: identity in the unit factor
    if (PAIRS && (MODE == kModeL || MODE == kModeLT) && i == j + 1 && bk[j])
      v = T(0);
    Ds[i][j] = v;
  }
  for (int e = tid; e < wb; e += blockDim.x) bks[e] = PAIRS ? bk[e] : 0;
  __syncthreads();
  const int li = tid & 31;
  const int col = blockIdx.y * (blockDim.x >> 5) + (tid >> 5);
  if (col >= m) return;                      // whole warps leave together
  const unsigned full = 0xffffffffu;
  const size_t base = (size_t)lane * wb * m + col;
  const bool in = li < wb;
  T xv = (in && li < w) ? y[base + (size_t)li * m] : T(0);
  if (MODE == kModeL) {
    for (int t = 0; t < wb; ++t) {
      const T xt = __shfl_sync(full, xv, t);
      xv = xv - ((in && li > t) ? Ds[li][t] : T(0)) * xt;
    }
  } else if (MODE == kModeLT) {
    for (int s = 0; s < wb; ++s) {
      const int t = wb - 1 - s;
      const T xt = __shfl_sync(full, xv, t);
      xv = xv - ((li < t) ? Ds[t][li] : T(0)) * xt;
    }
  } else {
    for (int s = 0; s < wb; ++s) {
      const int t = MODE == kModeU ? wb - 1 - s : s;
      const bool start = PAIRS && bks[t] != 0;
      const bool second = PAIRS && t > 0 && bks[t - 1] != 0;
      if (second) continue;                  // solved with its pair start
      if (!start) {
        const T xt1 = __shfl_sync(full, xv, t) / Ds[t][t];
        const T prop = MODE == kModeU ? ((li < t) ? Ds[li][t] : T(0))
                                      : ((in && li > t) ? Ds[t][li] : T(0));
        xv = xv - prop * xt1;
        if (li == t) xv = xt1;
      } else {
        const int t1 = min(t + 1, wb - 1);
        const T a = Ds[t][t], b = Ds[t][t1], c = Ds[t1][t], e = Ds[t1][t1];
        bool bad;
        const T dt = pair_det(a, b, c, e, &bad);
        const T rt = __shfl_sync(full, xv, t);
        const T rt1 = __shfl_sync(full, xv, t1);
        T xt, xtt, p1, p2;
        if (MODE == kModeU) {                // E [xt, xtt] = [rt, rt1]
          xt = (e * rt - b * rt1) / dt;
          xtt = (a * rt1 - c * rt) / dt;
          p1 = li < t ? Ds[li][t] : T(0);
          p2 = li < t ? Ds[li][t1] : T(0);
        } else {                             // E^T [xt, xtt] = [rt, rt1]
          xt = (e * rt - c * rt1) / dt;
          xtt = (a * rt1 - b * rt) / dt;
          p1 = (in && li > t1) ? Ds[t][li] : T(0);
          p2 = (in && li > t1) ? Ds[t1][li] : T(0);
        }
        xv = xv - p1 * xt - p2 * xtt;
        if (li == t) xv = xt;
        if (li == t1) xv = xtt;
      }
    }
  }
  if (in) x[base + (size_t)li * m] = xv;
}

template <typename T, int MODE>
void launch_trsv(bool pairs, dim3 grid, int threads, const void* D, long long dstride,
                 const void* y, void* x, const void* wvec, const void* bkm, int wb,
                 int m, cudaStream_t s) {
  if (pairs)
    block_trsv_kernel<T, MODE, true><<<grid, threads, 0, s>>>(
        (const T*)D, dstride, (const T*)y, (T*)x, (const int32_t*)wvec,
        (const uint8_t*)bkm, wb, m);
  else
    block_trsv_kernel<T, MODE, false><<<grid, threads, 0, s>>>(
        (const T*)D, dstride, (const T*)y, (T*)x, (const int32_t*)wvec,
        (const uint8_t*)bkm, wb, m);
}

template <typename T>
int block_trsv_t(int mode, int pairs, const void* D, long long dstride, const void* y,
                 void* x, const void* wvec, const void* bkm, int k, int wb, int m,
                 cudaStream_t s) {
  const int warps = m < kTrsvWarps ? m : kTrsvWarps;
  dim3 grid(k, (m + warps - 1) / warps);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const int threads = 32 * warps;
  switch (mode) {
    case kModeL:
      launch_trsv<T, kModeL>(pairs, grid, threads, D, dstride, y, x, wvec, bkm, wb, m, s);
      break;
    case kModeLT:
      launch_trsv<T, kModeLT>(pairs, grid, threads, D, dstride, y, x, wvec, bkm, wb, m, s);
      break;
    case kModeU:
      launch_trsv<T, kModeU>(pairs, grid, threads, D, dstride, y, x, wvec, bkm, wb, m, s);
      break;
    case kModeUT:
      launch_trsv<T, kModeUT>(pairs, grid, threads, D, dstride, y, x, wvec, bkm, wb, m, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

REPRO_EXPORT int sn_panel_factor(int f64, const void* P, const void* Q, void* Po,
                                 void* Qo, const void* wvec, const void* rvec,
                                 const void* tau, const void* bkm, void* nbad, int k,
                                 int wb, int rb, int pairs, int guard, void* stream) {
  if (k <= 0) return 0;
  if (wb < 1 || wb > 32 || rb < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return f64 ? panel_factor_t<double>(P, Q, Po, Qo, wvec, rvec, tau, bkm, nbad, k, wb,
                                      rb, pairs, guard, s)
             : panel_factor_t<float>(P, Q, Po, Qo, wvec, rvec, tau, bkm, nbad, k, wb,
                                     rb, pairs, guard, s);
}

REPRO_EXPORT int sn_schur_update(int f64, const void* P, const void* Q, void* S, int k,
                                 int wb, int rb, void* stream) {
  if (k <= 0 || rb <= 0) return 0;
  if (wb < 1 || wb > 32) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return f64 ? schur_t<double>(P, Q, S, k, wb, rb, s)
             : schur_t<float>(P, Q, S, k, wb, rb, s);
}

REPRO_EXPORT int sn_block_trsv(int f64, int mode, int pairs, const void* D,
                               long long dstride, const void* y, void* x,
                               const void* wvec, const void* bkm, int k, int wb, int m,
                               void* stream) {
  if (k <= 0 || m <= 0) return 0;
  if (wb < 1 || wb > 32) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return f64 ? block_trsv_t<double>(mode, pairs, D, dstride, y, x, wvec, bkm, k, wb, m, s)
             : block_trsv_t<float>(mode, pairs, D, dstride, y, x, wvec, bkm, k, wb, m, s);
}
