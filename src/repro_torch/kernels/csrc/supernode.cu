// Supernodal panel kernels of the sparse direct solver, on Hopper:
// panel_factor, schur_update (fused with the extend-add) and block_trsv.
//
// Replaces the TPU kernels of repro/kernels/supernode.py: panel_factor (its
// pallas_call at supernode.py:73), schur_update (:123) and block_trsv
// (:158).  The TPU versions run one supernode lane per grid step with the
// whole (wb+rb, wb) panel and its (wb, rb) U panel resident in VMEM; the
// reference's numeric loop gathers the panels from the factor vector C,
// scatters them back and scatter-adds the Schur product S into the
// ancestors' slots.  Here the two factorization kernels read and write C
// in place through the bucket's int32 slot tables (pidx (k, wb+rb, wb),
// qidx (k, wb, rb)): no panel is gathered or scattered by a separate pass,
// and no pad slot is written.
//
// * panel_factor: grid (lane, item tile).  A lane's rb sub-panel rows and
//   rb U columns are independent of each other once the (wb x wb) diagonal
//   block D is factored, so they are cut into tiles of up to 128 items, one
//   thread per item: a one-lane (32, 1024) bucket runs on 16 blocks, not one.
//   Each block first stages the slot tables of D and of its items in shared
//   memory with coalesced loads, then loads the values (each load level
//   issued unrolled, so a block waits for two memory latencies, not one per
//   element).  The block factors the masked D in shared memory, all threads
//   at once — per step t a column scale, a barrier, the rank-1 update of
//   the trailing block (one column a thread), a barrier — 1x1 with the
//   clamp or as a static 2x2 Bunch-Kaufman pair, exactly as the reference's
//   sn_panel_factor_body.  Then each thread keeps its row or column x[WBC]
//   in registers (the t/j loops unroll on the compile-time width, so
//   nothing is runtime-indexed) and replays the column eliminations against
//   the final D: l = x[t]/d_t or the 2x2 solve, x[j] -= l*U[t,j] for a row;
//   x[a] -= L[a,t]*x[t] for a column.  Consecutive items hold consecutive
//   slots, so the value loads and stores are coalesced.  Every block of a
//   lane reads D; the last one to have read it (a per-lane counter in
//   `work`, reset by that block) writes the factored D back and adds the
//   lane's clamped-pivot count to nbad.  No block reads C after it has
//   counted itself, and the items of a lane's blocks are disjoint slots, so
//   no block can read a value another block of the launch wrote.  What
//   bounds it on the card is not
//   bytes but the serial chain of its 2*wb dependent steps, each with an
//   f64 division, and the fixed cost of a launch (PERF.md, kernel table).
// * schur_update: C[tgt(l,i,j)] -= sum_c L_sub[l,i,c] * U[l,c,j] for every
//   live lane l and i, j < r_l.  The grid runs over (lane group, 32x32
//   output tile); tiles at or beyond r_l exit, buckets with rb < 32 put
//   several lanes in one block.  The tile's L_sub rows and U columns, for
//   the whole depth w <= 32, are gathered from C into shared memory; each
//   sum runs over c in order with explicit fma(), and goes out through
//   atomicAdd(&C[t], -s): sibling lanes may share a target.  The targets
//   are the live-only int32 table (per lane an r x r block at offset
//   toff[l]), so no pad product is formed and no atomic lands on the
//   scratch sink.  Atomics sum siblings in no fixed order: f64 factors can
//   differ in the last bits from run to run.
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
// 2*w flops per target, which it reads and writes once with its 4-byte
// index (20 bytes): 64 flops per 20 bytes at w = 32, below the card's f64
// balance point (~10 flops per byte), so bytes as well.  Tensor cores are
// not used: at wb <= 32 neither kernel is bound by its operations, and
// -fmad=false forbids the contraction an f64 mma would make of the factor's
// a - b*c updates.
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

constexpr int kPfMaxThreads = 128;

template <typename T, int WBC>
struct PanelShared {
  T D[WBC][WBC + 1];                   // the factored diagonal block
  T deff[WBC], detc[WBC];              // 1x1 divisor, clamped pair det
  unsigned one, pair;                  // steps t that are 1x1 / pair starts
  int last;                            // this block writes D back
  int32_t didx[WBC * WBC];             // D's slots in C
  int32_t idx[kPfMaxThreads][WBC + 1]; // each item's slots in C
};

// Grid (lane, tile of up to 128 items); thread it of a tile takes sub-row
// it, or U column it - rb, of the lane.  The slot tables of D and of the
// tile come in first, coalesced (consecutive threads on consecutive
// words), into shared memory; then the items' values and D, every load of
// a level independent and unrolled: a block waits for two memory
// latencies, not one per element.
template <typename T, int WBC, bool PAIRS>
__global__ void __launch_bounds__(kPfMaxThreads)
panel_factor_kernel(T* __restrict__ C, const int32_t* __restrict__ pidx,
                    const int32_t* __restrict__ qidx,
                    const int32_t* __restrict__ wvec,
                    const int32_t* __restrict__ rvec,
                    const T* __restrict__ tau_p,
                    const uint8_t* __restrict__ bkm, T* __restrict__ nbad,
                    int32_t* __restrict__ work, int wb, int rb, int guard) {
  __shared__ PanelShared<T, WBC> sm;
  const int lane = blockIdx.x;
  const int tile = blockIdx.y;
  const int tpb = blockDim.x;
  const int tid = threadIdx.x;
  const int w = wvec[lane];
  const int r = rvec[lane];
  // items: sub-rows 0..rb-1, then U columns rb..2rb-1; the first r of each
  // half are live
  auto holds = [&](int y) {
    const int a = y * tpb;
    return r > 0 && (a < r || (a < rb + r && a + tpb > rb));
  };
  if (tile != 0 && !holds(tile)) return;
  int npart = 0;                        // blocks of this lane that run
  for (int y = 0; y < (int)gridDim.y; ++y) npart += (y == 0 || holds(y));

  const size_t m = (size_t)wb + rb;
  const int32_t* pl = pidx + (size_t)lane * m * wb;
  const int32_t* ql = qidx + (size_t)lane * wb * rb;
  const int it0 = tile * tpb;
  const int it = it0 + tid;
  const bool is_row = it < rb;
  const int q = is_row ? it : it - rb;
  const bool has = it < 2 * rb && q < r;

  // 1. slot tables: D's, the tile's sub-rows' (one contiguous run), and this
  //    thread's U column (consecutive threads, consecutive columns)
  const int nd = wb * wb;
#pragma unroll
  for (int k = 0; k < (WBC * WBC + 31) / 32; ++k) {
    const int e = tid + k * tpb;
    if (e < nd) sm.didx[e] = pl[e];
  }
  const int nrow = max(0, min(it0 + tpb, r) - it0);    // live sub-rows of the tile
  const int32_t* prow = pl + ((size_t)wb + it0) * wb;
#pragma unroll
  for (int k = 0; k < WBC; ++k) {
    const int e = tid + k * tpb;
    if (e < nrow * wb) {
      const int i = wb == WBC ? e / WBC : e / wb;
      sm.idx[i][e - i * wb] = prow[e];
    }
  }
  if (!is_row && has) {
#pragma unroll
    for (int j = 0; j < WBC; ++j)
      if (j < w) sm.idx[tid][j] = ql[(size_t)j * rb + q];
  }
  const T tau = *tau_p;
  __syncthreads();

  // 2. values: this thread's item (masked as the plain version masks P, Q)
  //    and the block's share of the masked D (pad rows/cols zero, unit pad
  //    diagonal; zero past wb)
  T x[WBC];
#pragma unroll
  for (int j = 0; j < WBC; ++j) {
    const T v = (has && j < w) ? C[sm.idx[tid][j]] : T(0);
    x[j] = is_row ? v + T(0) : v;
  }
#pragma unroll
  for (int k = 0; k < (WBC * WBC + 31) / 32; ++k) {
    const int e = tid + k * tpb;
    if (e < WBC * WBC) {
      const int i = e / WBC, j = e % WBC;
      T v = T(0);
      if (i < wb && j < wb)
        v = ((i < w && j < w) ? C[sm.didx[i * wb + j]] : T(0))
            + ((i == j && j >= w) ? T(1) : T(0));
      sm.D[i][j] = v;
    }
  }
  __syncthreads();
  // This block has read all it reads of C (its values are in registers and
  // shared memory); from here on it only writes C, to its own items.  The
  // last block of the lane to count itself writes D back: by then every
  // block of the lane has counted itself, so has read D.  The fences make
  // the count a release (reads before it) and, in the last block, an
  // acquire (D's writes after it).  The last block resets the counter for
  // the next bucket, which runs after this launch in stream order.
  T nb = T(0);
  if (tid == 0) {
    int last = 1;
    if (npart > 1) {
      __threadfence();
      last = atomicAdd(work + lane, 1) == npart - 1;
      if (last) {
        work[lane] = 0;
        __threadfence();
      }
    }
    sm.last = last;
  }

  // 3. factor D by the whole block, in shared memory: per step a column
  //    scale, a barrier, the rank-1 (or pair: rank-2) update of the trailing
  //    block — thread (rg, tj) takes column t+1+tj of rows t+1+rg, t+1+rg+ng,
  //    ... — and a barrier
  {
    const int tj = tid & 31, rg = tid >> 5, ng = tpb >> 5;
    unsigned bk = 0u, one = 0u, pair = 0u;
    if (PAIRS) {
#pragma unroll
      for (int t = 0; t < WBC; ++t)
        if (t < wb && bkm[(size_t)lane * wb + t] != 0) bk |= 1u << t;
    }
    for (int t = 0; t < wb; ++t) {
      const bool start = PAIRS && ((bk >> t) & 1u);
      const bool second = PAIRS && t > 0 && ((bk >> (t - 1)) & 1u);
      if (second && !start) continue;          // eliminated with its start
      if (!start) {
        const T d = sm.D[t][t];
        const bool bad1 = guard && absv(d) < tau;
        const T dc = bad1 ? (d < T(0) ? -tau : tau) : d;
        nb += bad1 ? T(1) : T(0);
        const int i = t + 1 + tid;
        const T colL = i < wb ? sm.D[i][t] / dc : T(0);
        __syncthreads();                       // all have read D[t][t]
        if (i < wb) sm.D[i][t] = colL;
        if (tid == 0) {
          sm.D[t][t] = dc;
          sm.deff[t] = dc;
          sm.detc[t] = T(1);
        }
        __syncthreads();
        const int j = t + 1 + tj;
        if (j < wb) {
          const T u = sm.D[t][j];
          for (int ii = t + 1 + rg; ii < wb; ii += ng)
            sm.D[ii][j] = sm.D[ii][j] - sm.D[ii][t] * u;
        }
        one |= 1u << t;
      } else {
        // t1 = t + 1 inside the block; t itself at the last column, where
        // no row lies below the pair
        const int t1 = min(t + 1, wb - 1);
        const T a = sm.D[t][t], b = sm.D[t][t1];
        const T c = sm.D[t1][t], e = sm.D[t1][t1];
        bool bad2;
        const T dt = pair_det(a, b, c, e, &bad2);
        nb += bad2 ? T(1) : T(0);
        const int i = t1 + 1 + tid;
        T lu = T(0), lv = T(0);
        if (i < wb) {
          const T u = sm.D[i][t], v = sm.D[i][t1];
          lu = (u * e - v * c) / dt;
          lv = (v * a - u * b) / dt;
        }
        __syncthreads();
        if (i < wb) {
          sm.D[i][t] = lu;
          sm.D[i][t1] = lv;
        }
        if (tid == 0) {
          sm.deff[t] = T(1);
          sm.detc[t] = dt;
        }
        __syncthreads();
        const int j = t1 + 1 + tj;
        if (j < wb) {
          const T u1 = sm.D[t][j], u2 = sm.D[t1][j];
          for (int ii = t1 + 1 + rg; ii < wb; ii += ng)
            sm.D[ii][j] = sm.D[ii][j] - sm.D[ii][t] * u1 - sm.D[ii][t1] * u2;
        }
        pair |= 1u << t;
      }
      __syncthreads();
    }
    if (tid == 0) {
      sm.one = one;
      sm.pair = pair;
    }
  }
  __syncthreads();

  // eliminate this thread's row or column against the final D (row t past
  // the diagonal is U[t,:], column t below it L[:,t])
  if (has) {
    const unsigned one = sm.one, pair = PAIRS ? sm.pair : 0u;
    if (is_row) {
#pragma unroll
      for (int t = 0; t < WBC; ++t) {
        if (t < wb) {
          if ((one >> t) & 1u) {
            const T colL = x[t] / sm.deff[t];
#pragma unroll
            for (int j = t + 1; j < WBC; ++j) x[j] = x[j] - colL * sm.D[t][j];
            x[t] = colL;
          } else if (PAIRS && ((pair >> t) & 1u)) {
            // columns past t1 = t at the last column are beyond wb
            const int tn = t + 1 < WBC ? t + 1 : t;
            const bool nx = t + 1 < wb;
            const int t1 = nx ? t + 1 : t;
            const T a = sm.D[t][t], b = sm.D[t][t1];
            const T cc = sm.D[t1][t], ee = sm.D[t1][t1];
            const T dt = sm.detc[t];
            const T u = x[t], vv = nx ? x[tn] : x[t];
            const T lu = (u * ee - vv * cc) / dt;
            const T lv = (vv * a - u * b) / dt;
#pragma unroll
            for (int j = t + 2; j < WBC; ++j)
              x[j] = x[j] - lu * sm.D[t][j] - lv * sm.D[t1][j];
            x[t] = lu;
            if (nx) x[tn] = lv; else x[t] = lv;
          }
        }
      }
    } else {
#pragma unroll
      for (int t = 0; t < WBC; ++t) {
        if (t < wb) {
          if ((one >> t) & 1u) {
            const T yt = x[t];
#pragma unroll
            for (int a = t + 1; a < WBC; ++a) x[a] = x[a] - sm.D[a][t] * yt;
          } else if (PAIRS && ((pair >> t) & 1u)) {
            const int tn = t + 1 < WBC ? t + 1 : t;
            const bool nx = t + 1 < wb;
            const int t1 = nx ? t + 1 : t;
            const T yt = x[t], yt1 = nx ? x[tn] : x[t];
#pragma unroll
            for (int a = t + 2; a < WBC; ++a)
              x[a] = x[a] - sm.D[a][t] * yt - sm.D[a][t1] * yt1;
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < WBC; ++j)
      if (j < w) C[sm.idx[tid][j]] = x[j];
  }

  // the lane's last block writes D and the lane's clamp count (clamp counts
  // are small integers: the atomic sum is exact in any order)
  if (sm.last) {
    for (int e = tid; e < nd; e += tpb) {
      const int i = e / wb, j = e - i * wb;
      if (i < w && j < w) C[sm.didx[e]] = sm.D[i][j];
    }
    if (tid == 0 && nb != T(0)) atomicAdd(nbad, nb);
  }
}

template <typename T, int WBC>
int launch_pf(void* C, const void* pidx, const void* qidx, const void* wvec,
              const void* rvec, const void* tau, const void* bkm, void* nbad,
              void* work, int k, int wb, int rb, int pairs, int guard, cudaStream_t s) {
  int tpb = 32;
  while (tpb < 2 * rb && tpb < kPfMaxThreads) tpb *= 2;
  const int tiles = rb > 0 ? (2 * rb + tpb - 1) / tpb : 1;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(k, tiles);
  if (pairs)
    panel_factor_kernel<T, WBC, true><<<grid, tpb, 0, s>>>(
        (T*)C, (const int32_t*)pidx, (const int32_t*)qidx, (const int32_t*)wvec,
        (const int32_t*)rvec, (const T*)tau, (const uint8_t*)bkm, (T*)nbad,
        (int32_t*)work, wb, rb, guard);
  else
    panel_factor_kernel<T, WBC, false><<<grid, tpb, 0, s>>>(
        (T*)C, (const int32_t*)pidx, (const int32_t*)qidx, (const int32_t*)wvec,
        (const int32_t*)rvec, (const T*)tau, (const uint8_t*)bkm, (T*)nbad,
        (int32_t*)work, wb, rb, guard);
  return (int)cudaGetLastError();
}

template <typename T>
int panel_factor_t(void* C, const void* pidx, const void* qidx, const void* wvec,
                   const void* rvec, const void* tau, const void* bkm, void* nbad,
                   void* work, int k, int wb, int rb, int pairs, int guard,
                   cudaStream_t s) {
#define REPRO_PF(WBC)                                                          \
  return launch_pf<T, WBC>(C, pidx, qidx, wvec, rvec, tau, bkm, nbad, work, k, \
                           wb, rb, pairs, guard, s)
  if (wb <= 2) REPRO_PF(2);
  if (wb <= 4) REPRO_PF(4);
  if (wb <= 8) REPRO_PF(8);
  if (wb <= 16) REPRO_PF(16);
  REPRO_PF(32);
#undef REPRO_PF
}

// ---------------------------------------------------------------------------
// schur_update, fused with the extend-add
// ---------------------------------------------------------------------------

constexpr int kSchurThreads = 256;
constexpr int kTile = 32;
constexpr int kSchurOut = kTile * kTile / kSchurThreads;   // outputs a thread
constexpr int kSchurBatch = 8;                             // loads in flight
constexpr int kSchurSmem = 48 * 1024;

// Grid (lane group, output tile).  Output o = tid + q*256 of the block is
// (lane l, row i, column j) of its lanes' tiles; with 32 x 32 tiles (one
// lane per block) a thread's kSchurOut outputs share column j and read
// U[., j] once.  Every global load is issued in batches, so a block pays a few
// memory latencies, not one per element: the targets first (they need only
// r), then the panel slots, then the panel values.
template <typename T>
__global__ void __launch_bounds__(kSchurThreads)
schur_kernel(T* __restrict__ C, const int32_t* __restrict__ pidx,
             const int32_t* __restrict__ qidx, const int32_t* __restrict__ wvec,
             const int32_t* __restrict__ rvec, const int32_t* __restrict__ tgt,
             const long long* __restrict__ toff, int k, int wb, int rb, int td,
             int tiles, int lpb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int wp = wb + 1;
  T* As = reinterpret_cast<T*>(smem_raw);     // [lpb][td][wb+1]: L_sub rows
  T* Bs = As + (size_t)lpb * td * wp;         // [lpb][wb][td]: U columns
  const int tid = threadIdx.x;
  const int lane0 = blockIdx.x * lpb;
  const int i0 = (blockIdx.y / tiles) * td;
  const int j0 = (blockIdx.y % tiles) * td;
  if (lpb == 1) {                             // a tile past the lane's r
    const int r = rvec[lane0];
    if (i0 >= r || j0 >= r || wvec[lane0] == 0) return;
  }
  const size_t m = (size_t)wb + rb;

  // 1. this thread's outputs and their targets
  int ol[kSchurOut], oi[kSchurOut], oj[kSchurOut], ot[kSchurOut];
#pragma unroll
  for (int q = 0; q < kSchurOut; ++q) {
    const int e = tid + q * kSchurThreads;
    ol[q] = e / (td * td);
    const int rem = e % (td * td);
    oi[q] = rem / td;
    oj[q] = rem % td;
    const int lane = lane0 + ol[q];
    ot[q] = -1;
    if (ol[q] < lpb && lane < k) {
      const int r = rvec[lane];
      if (i0 + oi[q] < r && j0 + oj[q] < r)
        ot[q] = tgt[toff[lane] + (long long)(i0 + oi[q]) * r + j0 + oj[q]];
    }
  }

  // 2. gather the tile's L_sub rows and U columns from C (consecutive
  //    threads on consecutive slots)
  const int na = lpb * td * wb;
  for (int e0 = 0; e0 < 2 * na; e0 += kSchurBatch * kSchurThreads) {
    int sl[kSchurBatch];
#pragma unroll
    for (int q = 0; q < kSchurBatch; ++q) {
      const int e = e0 + q * kSchurThreads + tid;
      sl[q] = -1;
      if (e < na) {
        const int l = e / (td * wb), rem = e % (td * wb);
        const int c = rem / td, i = rem % td;
        const int lane = lane0 + l;
        if (lane < k && c < wvec[lane] && i0 + i < rvec[lane])
          sl[q] = pidx[((size_t)lane * m + wb + i0 + i) * wb + c];
      } else if (e < 2 * na) {
        const int f = e - na;
        const int l = f / (wb * td), rem = f % (wb * td);
        const int c = rem / td, j = rem % td;
        const int lane = lane0 + l;
        if (lane < k && c < wvec[lane] && j0 + j < rvec[lane])
          sl[q] = qidx[((size_t)lane * wb + c) * rb + j0 + j];
      }
    }
    T v[kSchurBatch];
#pragma unroll
    for (int q = 0; q < kSchurBatch; ++q) v[q] = sl[q] >= 0 ? C[sl[q]] : T(0);
#pragma unroll
    for (int q = 0; q < kSchurBatch; ++q) {
      const int e = e0 + q * kSchurThreads + tid;
      if (e < na) {
        const int l = e / (td * wb), rem = e % (td * wb);
        As[((size_t)l * td + rem % td) * wp + rem / td] = v[q];
      } else if (e < 2 * na) {
        Bs[e - na] = v[q];
      }
    }
  }
  __syncthreads();

  // 3. the sums, in order over c with explicit fma, out through atomics
  T acc[kSchurOut];
#pragma unroll
  for (int q = 0; q < kSchurOut; ++q) acc[q] = T(0);
  if (td == kTile) {                          // one lane: a column j per thread
    const int w = wvec[lane0];
    const T* b = Bs + oj[0];
    for (int c = 0; c < w; ++c) {
      const T bc = b[(size_t)c * td];
#pragma unroll
      for (int q = 0; q < kSchurOut; ++q)
        acc[q] = fmav(As[(size_t)oi[q] * wp + c], bc, acc[q]);
    }
  } else {
#pragma unroll
    for (int q = 0; q < kSchurOut; ++q) {
      if (ot[q] < 0) continue;
      const int w = wvec[lane0 + ol[q]];
      const T* a = As + ((size_t)ol[q] * td + oi[q]) * wp;
      const T* b = Bs + (size_t)ol[q] * wb * td + oj[q];
      for (int c = 0; c < w; ++c) acc[q] = fmav(a[c], b[(size_t)c * td], acc[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < kSchurOut; ++q)
    if (ot[q] >= 0) atomicAdd(C + ot[q], -acc[q]);
}

template <typename T>
int schur_t(void* C, const void* pidx, const void* qidx, const void* wvec,
            const void* rvec, const void* tgt, const void* toff, int k, int wb,
            int rb, cudaStream_t s) {
  const int td = rb < kTile ? rb : kTile;
  const int tiles = (rb + td - 1) / td;
  const size_t lane_smem = (size_t)td * (2 * wb + 1) * sizeof(T);
  int lpb = 1;
  if (rb < kTile) {                           // lpb * td^2 <= 1024 outputs
    lpb = (kTile * kTile) / (rb * rb);
    const int cap = (int)(kSchurSmem / lane_smem);
    if (lpb > cap) lpb = cap;
    if (lpb < 1) lpb = 1;
  }
  const size_t smem = lpb * lane_smem;
  if (smem > (size_t)kSchurSmem || (long long)tiles * tiles > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((k + lpb - 1) / lpb, tiles * tiles);
  schur_kernel<T><<<grid, kSchurThreads, smem, s>>>(
      (T*)C, (const int32_t*)pidx, (const int32_t*)qidx, (const int32_t*)wvec,
      (const int32_t*)rvec, (const int32_t*)tgt, (const long long*)toff, k, wb,
      rb, td, tiles, lpb);
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

REPRO_EXPORT int sn_panel_factor(int f64, void* C, const void* pidx, const void* qidx,
                                 const void* wvec, const void* rvec, const void* tau,
                                 const void* bkm, void* nbad, void* work, int k, int wb,
                                 int rb, int pairs, int guard, void* stream) {
  if (k <= 0) return 0;
  if (wb < 1 || wb > 32 || rb < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return f64 ? panel_factor_t<double>(C, pidx, qidx, wvec, rvec, tau, bkm, nbad, work,
                                      k, wb, rb, pairs, guard, s)
             : panel_factor_t<float>(C, pidx, qidx, wvec, rvec, tau, bkm, nbad, work,
                                     k, wb, rb, pairs, guard, s);
}

REPRO_EXPORT int sn_schur_update(int f64, void* C, const void* pidx, const void* qidx,
                                 const void* wvec, const void* rvec, const void* tgt,
                                 const void* toff, int k, int wb, int rb, void* stream) {
  if (k <= 0 || rb <= 0) return 0;
  if (wb < 1 || wb > 32) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return f64 ? schur_t<double>(C, pidx, qidx, wvec, rvec, tgt, toff, k, wb, rb, s)
             : schur_t<float>(C, pidx, qidx, wvec, rvec, tgt, toff, k, wb, rb, s);
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
