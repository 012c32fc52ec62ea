// Supernodal panel kernels of the sparse direct solver, on Hopper:
// panel_factor, schur_update (fused with the extend-add) and sn_sweep (the
// block solve fused with its panel GEMV and scatter / gather).
//
// Replaces the TPU kernels of repro/kernels/supernode.py: panel_factor (its
// pallas_call at supernode.py:73), schur_update (:123) and block_trsv
// (:158), with the reference's per-bucket sweep step around block_trsv
// (_sn_sweep_fn in repro/core/direct.py).  The TPU versions run one supernode lane per grid step with the
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
// * sn_sweep: one bucket of a triangular sweep, in place in the solution
//   y (n+1, m), the factors read from C through pidx / qidx and y through
//   the lanes' int32 row ids.  Modes l (x = L_D^-1 y_b, then y_s -= L_sub x)
//   and ut (x = U_D^-T y_b, then y_s -= U^T x) solve, then scatter; u
//   (x = U_D^-1 (y_b - U y_s)) and lt (x = L_D^-T (y_b - L_sub^T y_s))
//   gather, then solve.  Grid (lane, tile of up to 128 items, group of 4
//   right-hand sides); an item is a sub-row (l, lt) or a U column (u, ut),
//   one thread each, holding its w values in registers (unrolled on the
//   compile-time width WBC >= wb): consecutive items hold consecutive
//   slots, so the value loads are coalesced.  A block issues all its index
//   loads at once (L_sub's slot table as one coalesced run, staged in
//   shared memory), then all its value loads, so it waits for a few memory
//   latencies, not one per element.  Each block stages the triangle of D
//   its mode reads, and solves the wb <= 32 block one warp per right-hand
//   side (thread i holds x[i], x[t] broadcast with __shfl_sync; the pair
//   branch of the reference's sn_trsv_body).  To scatter, every block of a
//   lane solves, the last one to have read y[rows_b] (a per-lane counter
//   in `work`, as panel_factor's) writes x there, and each item subtracts
//   its dot product from y[rows_s] with atomicAdd: sibling lanes share
//   ancestor rows.  To gather, each warp sums its items' w products at once
//   by a transposing butterfly (31 shuffles at WBC = 32), each block then
//   over its warps in order, writes the sums to a workspace, and the lane's
//   last block adds them in tile order, solves and writes y[rows_b]: the
//   result does not depend on the order the blocks ran.  Within a launch
//   the lanes own disjoint rows_b and their rows_s lie in ancestors, on
//   other levels, so no block reads a row another block of the launch
//   writes.  Pads (w < wb, r < rb, all-pad lanes, rows naming the scratch
//   row) are masked in the kernel and never written.  What bounds it on
//   the card is a launch's fixed cost and the block solve's serial chain of
//   wb steps (each with an f64 division in u / ut), not its bytes.
//
// Lanes (the reference's jax.vmap of its kernels over B value arrays of one
// pattern, rows 4', 5' and 6' of the port's kernel table): every kernel
// takes nl lanes, each with its own factor vector at C + b*ldc and, for the
// sweep, its own solution at y + b*ldy.  The lane is blockIdx.z (folded with
// the right-hand-side group in sn_sweep), the slot tables are shared, and
// per-lane state (tau, the clamp count nbad, the work counters and the
// sweep's partial sums) sits at lane-strided offsets.  One launch per bucket
// serves every lane; a one-lane launch is the same code with b = 0.
//
// The file is compiled with -fmad=false (see _build.py) so that no a - b*c
// is contracted into an FMA: the factor and solve keep the reference's
// per-element rounding.  schur_update sums with explicit fma().
//
// Bounds (f64 at 3.35 TB/s): panel_factor and sn_sweep read (and write)
// their panels once and do O(wb) flops per word: bytes.  schur_update does
// 2*w flops per target, which it reads and writes once with its 4-byte
// index (20 bytes): 64 flops per 20 bytes at w = 32, below the card's f64
// balance point (~10 flops per byte), so bytes as well.  Tensor cores are
// not used: at wb <= 32 no kernel here is bound by its operations, and
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

// Grid (lane, tile of up to 128 items, value lane); thread it of a tile
// takes sub-row it, or U column it - rb, of the lane.  The slot tables of D
// and of the tile come in first, coalesced (consecutive threads on consecutive
// words), into shared memory; then the items' values and D, every load of
// a level independent and unrolled: a block waits for two memory
// latencies, not one per element.
template <typename T, int WBC, bool PAIRS>
__global__ void __launch_bounds__(kPfMaxThreads)
panel_factor_kernel(T* __restrict__ C, long long ldc,
                    const int32_t* __restrict__ pidx,
                    const int32_t* __restrict__ qidx,
                    const int32_t* __restrict__ wvec,
                    const int32_t* __restrict__ rvec,
                    const T* __restrict__ tau_p,
                    const uint8_t* __restrict__ bkm, T* __restrict__ nbad,
                    int32_t* __restrict__ work, int wb, int rb, int guard) {
  __shared__ PanelShared<T, WBC> sm;
  const int lane = blockIdx.x;
  const int tile = blockIdx.y;
  // value lane b: its factor vector, clamp, clamp count and counters
  const size_t vb = blockIdx.z;
  C += vb * ldc;
  tau_p += vb;
  nbad += vb;
  work += vb * gridDim.x;
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
int launch_pf(void* C, long long ldc, int nl, const void* pidx, const void* qidx,
              const void* wvec, const void* rvec, const void* tau, const void* bkm,
              void* nbad, void* work, int k, int wb, int rb, int pairs, int guard,
              cudaStream_t s) {
  int tpb = 32;
  while (tpb < 2 * rb && tpb < kPfMaxThreads) tpb *= 2;
  const int tiles = rb > 0 ? (2 * rb + tpb - 1) / tpb : 1;
  if (tiles > 65535 || nl > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(k, tiles, nl);
  if (pairs)
    panel_factor_kernel<T, WBC, true><<<grid, tpb, 0, s>>>(
        (T*)C, ldc, (const int32_t*)pidx, (const int32_t*)qidx, (const int32_t*)wvec,
        (const int32_t*)rvec, (const T*)tau, (const uint8_t*)bkm, (T*)nbad,
        (int32_t*)work, wb, rb, guard);
  else
    panel_factor_kernel<T, WBC, false><<<grid, tpb, 0, s>>>(
        (T*)C, ldc, (const int32_t*)pidx, (const int32_t*)qidx, (const int32_t*)wvec,
        (const int32_t*)rvec, (const T*)tau, (const uint8_t*)bkm, (T*)nbad,
        (int32_t*)work, wb, rb, guard);
  return (int)cudaGetLastError();
}

template <typename T>
int panel_factor_t(void* C, long long ldc, int nl, const void* pidx, const void* qidx,
                   const void* wvec, const void* rvec, const void* tau, const void* bkm,
                   void* nbad, void* work, int k, int wb, int rb, int pairs, int guard,
                   cudaStream_t s) {
#define REPRO_PF(WBC)                                                          \
  return launch_pf<T, WBC>(C, ldc, nl, pidx, qidx, wvec, rvec, tau, bkm, nbad, \
                           work, k, wb, rb, pairs, guard, s)
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

// Grid (lane group, output tile, value lane).  Output o = tid + q*256 of the block is
// (lane l, row i, column j) of its lanes' tiles; with 32 x 32 tiles (one
// lane per block) a thread's kSchurOut outputs share column j and read
// U[., j] once.  Every global load is issued in batches, so a block pays a few
// memory latencies, not one per element: the targets first (they need only
// r), then the panel slots, then the panel values.
template <typename T>
__global__ void __launch_bounds__(kSchurThreads)
schur_kernel(T* __restrict__ C, long long ldc, const int32_t* __restrict__ pidx,
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
  C += (size_t)blockIdx.z * ldc;              // value lane b's factors
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
int schur_t(void* C, long long ldc, int nl, const void* pidx, const void* qidx,
            const void* wvec, const void* rvec, const void* tgt, const void* toff,
            int k, int wb, int rb, cudaStream_t s) {
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
  if (smem > (size_t)kSchurSmem || (long long)tiles * tiles > 65535 || nl > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((k + lpb - 1) / lpb, tiles * tiles, nl);
  schur_kernel<T><<<grid, kSchurThreads, smem, s>>>(
      (T*)C, ldc, (const int32_t*)pidx, (const int32_t*)qidx, (const int32_t*)wvec,
      (const int32_t*)rvec, (const int32_t*)tgt, (const long long*)toff, k, wb,
      rb, td, tiles, lpb);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// sn_sweep: one bucket of a supernodal triangular sweep, in place in y
// ---------------------------------------------------------------------------

constexpr int kModeL = 0, kModeLT = 1, kModeU = 2, kModeUT = 3;
constexpr int kSwMaxThreads = 128;        // items (sub-rows / U columns) a block
constexpr int kSwWarps = kSwMaxThreads / 32;
constexpr int kSwRhs = 4;                 // right-hand sides a block

// entries of D a thread stages: a block has at least WBC^2 / value threads
template <int WBC>
struct SweepDPer {
  static constexpr int value = WBC * WBC <= 256 ? (WBC * WBC + 31) / 32 : 8;
};

template <typename T, int WBC>
struct SweepShared {
  T D[WBC][WBC + 1];                      // the masked diagonal block
  T x[kSwRhs][WBC];                       // x0, then x, per right-hand side
  T red[kSwWarps][kSwRhs][WBC];           // per-warp sums (u, lt)
  int32_t idx[kSwMaxThreads][WBC + 1];    // the tile's L_sub slots (l, lt)
  int last;                               // this block writes y[rows_b]
};

// The masked block solve of one right-hand side by one warp: thread li holds
// x[li] (wb <= WBC <= 32) and x[t] is broadcast with __shfl_sync.  Modes l /
// lt / u / ut and the pair branch of the reference's sn_trsv_body; D is the
// block as the caller staged it (pads zero with a unit diagonal, a pair
// start's subdiagonal zero in l / lt).
template <typename T, int WBC, int MODE, bool PAIRS>
__device__ __forceinline__ T warp_solve(T (*Ds)[WBC + 1], unsigned bk, T xv,
                                        int li, int wb) {
  const unsigned full = 0xffffffffu;
  const bool in = li < wb;
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
      const bool start = PAIRS && ((bk >> t) & 1u);
      const bool second = PAIRS && t > 0 && ((bk >> (t - 1)) & 1u);
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
  return xv;
}

// Sum over the warp's 32 lanes of v[t] * f for every t < WBC at once: lane
// li returns the sum for t = li mod WBC.  Each halving step keeps one half
// of a lane's values, sends the other to its partner and adds what it
// receives (WBC - 1 shuffles); a butterfly over the lane groups ends it.
// The order of the sums is fixed.
template <typename T, int WBC>
__device__ __forceinline__ T warp_transpose_sum(const T (&v)[WBC], T f, int li) {
  const unsigned full = 0xffffffffu;
  constexpr int kH = WBC / 2;             // WBC >= 2
  T a[kH];
  const bool up0 = li & kH;
#pragma unroll
  for (int j = 0; j < kH; ++j) {
    const T lo = v[j] * f, hi = v[j + kH] * f;
    a[j] = (up0 ? hi : lo) + __shfl_xor_sync(full, up0 ? lo : hi, kH);
  }
#pragma unroll
  for (int s = kH / 2; s >= 1; s >>= 1) {
    const bool up = li & s;
#pragma unroll
    for (int j = 0; j < s; ++j) {
      const T lo = a[j], hi = a[j + s];
      a[j] = (up ? hi : lo) + __shfl_xor_sync(full, up ? lo : hi, s);
    }
  }
#pragma unroll
  for (int o = WBC; o < 32; o <<= 1) a[0] = a[0] + __shfl_xor_sync(full, a[0], o);
  return a[0];
}

// Grid (lane, item tile, value lane x right-hand-side group): z = b*groups
// + group, value lane b's factors at C + b*ldc and its y at y + b*ldy; the
// work counters and partial sums are per (value lane, lane, group).  Item it
// of a tile is sub-row a = it of the lane (l, lt: a row of L_sub) or U
// column j = it (u, ut); a group is kSwRhs columns of y.  y is (n+1, m) row-major; rows
// (k, wb+rb) its row ids: the block's rows_b, then the sub-rows' rows_s.
// WBC is the compile-time width (wb <= WBC): the item's values live in
// registers, unrolled over it.
template <typename T, int WBC, int MODE, bool PAIRS>
__global__ void __launch_bounds__(kSwMaxThreads)
sn_sweep_kernel(const T* __restrict__ C, long long ldc, T* __restrict__ y,
                long long ldy, int groups,
                const int32_t* __restrict__ pidx, const int32_t* __restrict__ qidx,
                const int32_t* __restrict__ rows, const int32_t* __restrict__ wvec,
                const int32_t* __restrict__ rvec, const uint8_t* __restrict__ bkm,
                int32_t* __restrict__ work, T* __restrict__ part, int wb, int rb,
                int m) {
  constexpr bool kScatter = MODE == kModeL || MODE == kModeUT;
  constexpr bool kLower = MODE == kModeL || MODE == kModeLT;
  constexpr int kDPer = SweepDPer<WBC>::value;
  __shared__ SweepShared<T, WBC> sm;
  const int lane = blockIdx.x, tile = blockIdx.y;
  const int grp = blockIdx.z % groups;
  const size_t vb = blockIdx.z / groups;
  C += vb * ldc;
  y += vb * ldy;
  const size_t lid = vb * gridDim.x + lane;     // (value lane, lane)
  const int tpb = blockDim.x, tid = threadIdx.x;
  const int li = tid & 31, wid = tid >> 5, nw = tpb >> 5;
  const int w = wvec[lane], r = rvec[lane];
  const int it0 = tile * tpb;
  // an all-pad lane does nothing; a tile past the live items does not run
  if (w == 0 || (tile > 0 && it0 >= r)) return;
  const int npart = r > tpb ? (r + tpb - 1) / tpb : 1;    // blocks that run
  const int col0 = grp * kSwRhs;
  const int g = min(kSwRhs, m - col0);
  const size_t mw = (size_t)wb + rb;
  const int32_t* pl = pidx + (size_t)lane * mw * wb;
  const int32_t* rl = rows + (size_t)lane * mw;
  const int32_t* ql = qidx + (size_t)lane * wb * rb + it0 + tid;   // U[., item]
  const int item = it0 + tid;
  const bool live = item < r;
  const unsigned bk = PAIRS
      ? __ballot_sync(0xffffffffu, li < wb && bkm[(size_t)lane * wb + li] != 0)
      : 0u;

  // 1. every index load of the block at once: D's slots (only the triangle
  //    this mode reads), the tile's L_sub slots (one contiguous run,
  //    coalesced) or the item's U slots (consecutive items, consecutive
  //    slots), the block rows' ids and, to gather, the item's row id
  int32_t ds[kDPer];
#pragma unroll
  for (int q = 0; q < kDPer; ++q) {
    const int e = tid + q * tpb, i = e / wb, j = e - i * wb;
    const bool need = e < wb * wb && i < w && j < w
        && (kLower ? i > j : (i <= j || (PAIRS && i == j + 1)));
    ds[q] = need ? pl[e] : -1;
  }
  int32_t sl[WBC];
  if (kLower) {
    const int nrow = max(0, min(it0 + tpb, r) - it0);
    const int32_t* prow = pl + ((size_t)wb + it0) * wb;
#pragma unroll
    for (int k = 0; k < WBC; ++k) {
      const int e = tid + k * tpb;
      sl[k] = e < nrow * wb ? prow[e] : -1;
    }
  } else {
#pragma unroll
    for (int c = 0; c < WBC; ++c)
      sl[c] = (live && c < w) ? ql[(size_t)c * rb] : -1;
  }
  int32_t xr[kSwRhs];
#pragma unroll
  for (int q = 0; q < kSwRhs; ++q) {
    const int e = tid + q * tpb, t = e % wb;
    xr[q] = (e < g * wb && t < w) ? rl[t] : -1;
  }
  const int rs = (!kScatter && live) ? rl[wb + item] : -1;

  // 2. the tile's L_sub slots to their items (through shared memory)
  if (kLower) {
#pragma unroll
    for (int k = 0; k < WBC; ++k) {
      const int e = tid + k * tpb, i = e / wb;
      if (sl[k] >= 0) sm.idx[i][e - i * wb] = sl[k];
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < WBC; ++c) sl[c] = (live && c < w) ? sm.idx[tid][c] : -1;
  }

  // 3. every value load at once: D, y[rows_b], the item's w values (its row
  //    of L_sub or column of U) and, to gather, its y[rows_s]; then D and
  //    x0 = y_b into shared memory
  T dv[kDPer];
#pragma unroll
  for (int q = 0; q < kDPer; ++q) dv[q] = ds[q] >= 0 ? C[ds[q]] : T(0);
  T xv[kSwRhs];
#pragma unroll
  for (int q = 0; q < kSwRhs; ++q)
    xv[q] = xr[q] >= 0 ? y[(size_t)xr[q] * m + col0 + (tid + q * tpb) / wb]
                       : T(0);
  T v[WBC];
#pragma unroll
  for (int c = 0; c < WBC; ++c) v[c] = sl[c] >= 0 ? C[sl[c]] : T(0);
  T ys[kSwRhs];
#pragma unroll
  for (int q = 0; q < kSwRhs; ++q)
    ys[q] = (rs >= 0 && q < g) ? y[(size_t)rs * m + col0 + q] : T(0);
#pragma unroll
  for (int q = 0; q < kDPer; ++q) {
    const int e = tid + q * tpb, i = e / wb, j = e - i * wb;
    if (e < wb * wb) {
      T d = dv[q];
      if (i == j && i >= w) d = T(1);
      // a pair start's subdiagonal holds raw c: identity in the unit factor
      if (kLower && PAIRS && i == j + 1 && ((bk >> j) & 1u)) d = T(0);
      sm.D[i][j] = d;
    }
  }
#pragma unroll
  for (int q = 0; q < kSwRhs; ++q) {
    const int e = tid + q * tpb;
    if (e < g * wb) sm.x[e / wb][e % wb] = xv[q];
  }
  __syncthreads();

  if (kScatter) {
    // 4. solve: one warp per right-hand side
    for (int q = wid; q < g; q += nw) {
      const T xq = warp_solve<T, WBC, MODE, PAIRS>(
          sm.D, bk, li < wb ? sm.x[q][li] : T(0), li, wb);
      if (li < wb) sm.x[q][li] = xq;
    }
    __syncthreads();
    // 5. every block of the lane has read y[rows_b] before it counts itself
    //    (fenced); the last one writes x there and resets the counter for the
    //    next launch.  Nothing else of this launch reads or writes rows_b:
    //    the scatter targets rows_s are ancestors, on other levels.
    if (tid == 0) {
      int last = 1;
      if (npart > 1) {
        int32_t* cnt = work + lid * groups + grp;
        __threadfence();
        last = atomicAdd(cnt, 1) == npart - 1;
        if (last) {
          *cnt = 0;
          __threadfence();
        }
      }
      sm.last = last;
    }
    __syncthreads();
    if (sm.last)
      for (int e = tid; e < g * w; e += tpb) {
        const int q = e / w, t = e - q * w;
        y[(size_t)rl[t] * m + col0 + q] = sm.x[q][t];
      }
    // 6. this item's row of L_sub (or column of U) times x, subtracted from
    //    y[rows_s[item]] atomically: sibling lanes share ancestor rows
    if (live) {
      T acc[kSwRhs];
#pragma unroll
      for (int q = 0; q < kSwRhs; ++q) acc[q] = T(0);
#pragma unroll
      for (int c = 0; c < WBC; ++c) {
        if (c < w) {
#pragma unroll
          for (int q = 0; q < kSwRhs; ++q)
            if (q < g) acc[q] = acc[q] + v[c] * sm.x[q][c];
        }
      }
      T* yt = y + (size_t)rl[wb + item] * m + col0;
#pragma unroll
      for (int q = 0; q < kSwRhs; ++q)
        if (q < g) atomicAdd(yt + q, -acc[q]);
    }
    return;
  }

  // gather (u, lt): 4. the tile's sum over its items for each t < w and
  //    each right-hand side: within each warp by a transposing butterfly,
  //    then over the warps in order
  const bool warp_live = it0 + wid * 32 < r;
#pragma unroll
  for (int q = 0; q < kSwRhs; ++q) {
    if (q < g) {
      const T sum = warp_live ? warp_transpose_sum<T, WBC>(v, ys[q], li) : T(0);
      if (li < w) sm.red[wid][q][li] = sum;
    }
  }
  __syncthreads();
  T* pl_part = part + (lid * groups + grp) * gridDim.y * (kSwRhs * 32);
  for (int e = tid; e < g * w; e += tpb) {
    const int q = e / w, t = e - q * w;
    T s = T(0);
    for (int k = 0; k < nw; ++k) s = s + sm.red[k][q][t];
    if (npart == 1)
      sm.x[q][t] = sm.x[q][t] - s;
    else
      pl_part[(size_t)tile * (kSwRhs * 32) + q * 32 + t] = s;
  }
  // 5. several blocks: each writes its partial sums, counts itself (fenced)
  //    and leaves; the last one adds the partials in tile order (the result
  //    does not depend on which block came last) and goes on
  if (npart > 1) {
    __threadfence();                      // every writer's partials, then
    __syncthreads();                      // the count
    if (tid == 0) {
      int32_t* cnt = work + lid * groups + grp;
      const int last = atomicAdd(cnt, 1) == npart - 1;
      if (last) {
        *cnt = 0;
        __threadfence();
      }
      sm.last = last;
    }
    __syncthreads();
    if (!sm.last) return;
    for (int e = tid; e < g * w; e += tpb) {
      const int q = e / w, t = e - q * w;
      T s = T(0);
      for (int b = 0; b < npart; ++b)
        s = s + __ldcg(pl_part + (size_t)b * (kSwRhs * 32) + q * 32 + t);
      sm.x[q][t] = sm.x[q][t] - s;
    }
  }
  __syncthreads();
  // 6. solve x0 = y[rows_b] - sum, one warp per right-hand side; write x
  for (int q = wid; q < g; q += nw) {
    const T xq = warp_solve<T, WBC, MODE, PAIRS>(
        sm.D, bk, li < wb ? sm.x[q][li] : T(0), li, wb);
    if (li < w) y[(size_t)rl[li] * m + col0 + q] = xq;
  }
}

template <typename T, int WBC, int MODE>
int launch_sweep(bool pairs, const void* C, long long ldc, void* y, long long ldy,
                 int nl, const void* pidx,
                 const void* qidx, const void* rows, const void* wvec,
                 const void* rvec, const void* bkm, void* work, void* part, int k,
                 int wb, int rb, int m, cudaStream_t s) {
  // threads for the items (up to kSwMaxThreads) and enough for D's staging
  int tpb = 32;
  while ((tpb < rb || tpb * SweepDPer<WBC>::value < WBC * WBC) && tpb < kSwMaxThreads)
    tpb *= 2;
  const int tiles = rb > 0 ? (rb + tpb - 1) / tpb : 1;
  const int groups = (m + kSwRhs - 1) / kSwRhs;
  if (tiles > 65535 || (long long)groups * nl > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(k, tiles, groups * nl);
#define REPRO_SW(P)                                                             \
  sn_sweep_kernel<T, WBC, MODE, P><<<grid, tpb, 0, s>>>(                        \
      (const T*)C, ldc, (T*)y, ldy, groups, (const int32_t*)pidx,               \
      (const int32_t*)qidx, (const int32_t*)rows, (const int32_t*)wvec,        \
      (const int32_t*)rvec, (const uint8_t*)bkm, (int32_t*)work, (T*)part, wb,  \
      rb, m)
  if (pairs)
    REPRO_SW(true);
  else
    REPRO_SW(false);
#undef REPRO_SW
  return (int)cudaGetLastError();
}

template <typename T, int MODE>
int sweep_mode(bool pairs, const void* C, long long ldc, void* y, long long ldy,
               int nl, const void* pidx,
               const void* qidx, const void* rows, const void* wvec,
               const void* rvec, const void* bkm, void* work, void* part, int k,
               int wb, int rb, int m, cudaStream_t s) {
#define REPRO_SWW(WBC)                                                          \
  return launch_sweep<T, WBC, MODE>(pairs, C, ldc, y, ldy, nl, pidx, qidx, rows, \
                                    wvec, rvec, bkm, work, part, k, wb, rb, m, s)
  if (wb <= 2) REPRO_SWW(2);
  if (wb <= 4) REPRO_SWW(4);
  if (wb <= 8) REPRO_SWW(8);
  if (wb <= 16) REPRO_SWW(16);
  REPRO_SWW(32);
#undef REPRO_SWW
}

template <typename T>
int sweep_t(int mode, int pairs, const void* C, long long ldc, void* y, long long ldy,
            int nl, const void* pidx,
            const void* qidx, const void* rows, const void* wvec, const void* rvec,
            const void* bkm, void* work, void* part, int k, int wb, int rb, int m,
            cudaStream_t s) {
#define REPRO_SWM(M)                                                            \
  return sweep_mode<T, M>(pairs != 0, C, ldc, y, ldy, nl, pidx, qidx, rows,     \
                          wvec, rvec, bkm, work, part, k, wb, rb, m, s)
  switch (mode) {
    case kModeL: REPRO_SWM(kModeL);
    case kModeLT: REPRO_SWM(kModeLT);
    case kModeU: REPRO_SWM(kModeU);
    case kModeUT: REPRO_SWM(kModeUT);
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_SWM
}

}  // namespace

// nl value lanes: lane b's factors at C + b*ldc, its clamp at tau[b], its
// clamp count at nbad[b] and its k work counters at work + b*k.
REPRO_EXPORT int sn_panel_factor(int f64, void* C, long long ldc, int nl,
                                 const void* pidx, const void* qidx,
                                 const void* wvec, const void* rvec, const void* tau,
                                 const void* bkm, void* nbad, void* work, int k, int wb,
                                 int rb, int pairs, int guard, void* stream) {
  if (k <= 0 || nl <= 0) return 0;
  if (wb < 1 || wb > 32 || rb < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return f64 ? panel_factor_t<double>(C, ldc, nl, pidx, qidx, wvec, rvec, tau, bkm, nbad,
                                      work, k, wb, rb, pairs, guard, s)
             : panel_factor_t<float>(C, ldc, nl, pidx, qidx, wvec, rvec, tau, bkm, nbad,
                                     work, k, wb, rb, pairs, guard, s);
}

REPRO_EXPORT int sn_schur_update(int f64, void* C, long long ldc, int nl,
                                 const void* pidx, const void* qidx,
                                 const void* wvec, const void* rvec, const void* tgt,
                                 const void* toff, int k, int wb, int rb, void* stream) {
  if (k <= 0 || rb <= 0 || nl <= 0) return 0;
  if (wb < 1 || wb > 32) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return f64 ? schur_t<double>(C, ldc, nl, pidx, qidx, wvec, rvec, tgt, toff, k, wb, rb, s)
             : schur_t<float>(C, ldc, nl, pidx, qidx, wvec, rvec, tgt, toff, k, wb, rb, s);
}

// nl value lanes: lane b's factors at C + b*ldc and its (n+1, m) y at
// y + b*ldy; work holds nl*k*groups counters, part nl*k*groups*tiles partial
// blocks (sweep_buffers in supernode.py).
REPRO_EXPORT int sn_sweep(int f64, int mode, int pairs, const void* C, long long ldc,
                          void* y, long long ldy, int nl,
                          const void* pidx, const void* qidx, const void* rows,
                          const void* wvec, const void* rvec, const void* bkm,
                          void* work, void* part, int k, int wb, int rb, int m,
                          void* stream) {
  if (k <= 0 || m <= 0 || nl <= 0) return 0;
  if (wb < 1 || wb > 32 || rb < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return f64 ? sweep_t<double>(mode, pairs, C, ldc, y, ldy, nl, pidx, qidx, rows, wvec,
                               rvec, bkm, work, part, k, wb, rb, m, s)
             : sweep_t<float>(mode, pairs, C, ldc, y, ldy, nl, pidx, qidx, rows, wvec,
                              rvec, bkm, work, part, k, wb, rb, m, s);
}
