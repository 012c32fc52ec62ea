// Flash attention (online softmax, causal or bidirectional) on Hopper.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (its pallas_call at flash_attention.py:84, body _kernel at :27-65):
//     o = softmax(q k^T / sqrt(d)) v          per batch and query head,
// an optional causal mask "key j <= query i" in absolute indices (top-left
// aligned when T != S), masked scores set to -1e30, f32 running max /
// denominator / accumulator, the output divided by max(l, 1e-30) and
// written in q's dtype.  Any S and T >= 1; d in {16, 32, 64, 128, 256}.
// A sliding window (the reference model's local attention,
// repro/models/attention.py:118-123) keeps only keys i - window < j <= i:
// each block's KV walk starts at the tile of the first key its first query
// keeps (kv_tiles, the one function both kernels and the bf16 producer call),
// so compute and loads are O(S * window), and window 0 walks from tile 0.
//
// Layout (both kernels): q is (B, S, H, d) and k, v are (B, T, K, d), read
// in place through their strides (the head dim contiguous); query head h
// reads KV head h / (H / K), so grouped-query attention needs no expanded
// copies.  o is written (B, S, H, d) contiguous.  The (BH, S, d) form is
// the case B = BH, H = K = 1.
//
// The TPU version walks the KV blocks as the innermost, sequential grid
// axis and carries m / l / acc in VMEM scratch across grid steps.  On
// Hopper a block's KV walk is a loop inside the block, ragged tails are
// masked in the kernel, and in causal mode the loop stops at the block's
// last query (tiles above the diagonal are never loaded).  The grid is
// (B*H, query tiles) with the query tiles in reverse, so the heaviest
// causal tiles of every head are scheduled first.
//
// bf16: tensor cores (tc_kernel).  Bound: operations, 4 B H S T d flops
// (about halved by the causal mask at S = T) against q + k + v + o bytes:
// ~2,000 flops per byte at the prefill shape (B*H 128, S = T = 4096, d 64),
// so the bound is the bf16 tensor-core rate (989 TFLOP/s).  A block owns
// 128 queries and is warp-specialised into three warpgroups:
//   producer    one thread streams Q once and 64-key K / V tiles by TMA
//               (tensor maps of the strided 4-D views, 128-byte swizzle,
//               zeros past S, T and d) into a three-stage ring, each stage
//               guarded by a full and an empty mbarrier;
//   consumers   two warpgroups of 64 query rows, each per tile:
//     S = Q K^T   wgmma m64n64k16, Q and K from shared memory (K-major),
//     online softmax on S in registers (exp2 with the scale folded in,
//     row max and sum over the 4 lanes that share a row, O rescaled only
//     when a row max moved),
//     O += P V    wgmma m64n{d}k16 twice, P in registers as the A operand
//                 split into hi = bf16(p) and lo = bf16(p - hi) (the f32
//                 accumulator fragment of S is the bf16 A fragment, pair
//                 by pair), V an MN-major B operand (transposed by the
//                 descriptor),
//   with f32 accumulators.  Named barriers make the two consumers issue
//   their Q K^T in turn, so one's softmax overlaps the other's products.
// The producer gives its registers to the consumers (setmaxnreg).  The hi /
// lo split keeps ~16 bits of p, so the kernel computes the TPU kernel's
// f32-p function; with a single bf16 P (one rounding of p, as the reference
// model's jnp attention does) the bf16 decode == forward check of
// chip_smoke.py lost 3 greedy tokens of 256 on an H100 (94.5%, under its
// 95% floor).  The split costs 1.5x the tensor-core work of one pass.
// Head dims below 64 are zero-padded to one 128-byte row in shared memory.
// Head dim 256 takes 32-key K / V tiles (O alone is 128 f32 registers a
// consumer thread; 32 keys halve S and P) and runs P V as two n128 halves.
// The decode == forward check moves by a few greedy tokens with the last
// bits of the output, so tiles and rounding steps are kept as the check
// was first passed with.  Not done yet: a consumer's next Q K^T in flight
// during its own softmax (tried; ptxas serialised the wgmmas or spilled).
//
// f32: SIMT kernel (simt_kernel), all arithmetic f32 on the FMA pipes (no
// tensor cores, no TF32: the f32 decode == forward check needs f32
// scores).  Bound: the f32 FMA rate (67 TFLOP/s), 2 d FMAs per kept
// (query, key) pair.  A block of 256 threads takes `heads` query heads of
// one KV head (the largest of 8, 4, 2, 1 dividing H / K) at rows / heads
// query positions, so every K / V tile it loads serves all its rows (GQA
// tiles are loaded once per group, not once per query head).  Its rows: 128
// where that grid fills the SMs twice over, else 32, so small batches still
// cover the card (flash_attention.f32_tile, a pure function of the shapes,
// picks both; the launch code only checks them).  Shared memory holds the Q
// tile, two K buffers, one V buffer and the P tile, rows padded by 16 bytes
// against bank conflicts; all tiles arrive by 16-byte cp.async with zeros
// past S, T.  K(t + 1) loads while tile t runs its softmax and P V, and
// V(t + 1) while tile t + 1 runs Q K^T: three barriers a 64-key tile.
// Thread (ty, tx), ty < 16, tx < 16 (a half-warp), owns query rows
// ty + 16 i (i < TM), keys tx + 16 u of a tile (u < 4) and head dims
// 4 tx + 64 c (4-wide chunks; d 16 / 32: 1 / 2 dims at tx d / 16).  Q K^T
// reads float4 of Q and K along d, 16 TM FMAs per TM + 4 128-bit loads
// (10.7 a load at TM = 8); P V reads float4 of P along keys and V's row
// chunk, the same ratio.  Scores are scaled by log2(e) / sqrt(d) once and
// exponentiated by ex2; the mask is evaluated only on a tile that reaches
// past T or (causal) past the block's first query; the row max is reduced
// over the half-warp each tile, the row sums once at the end (each
// thread's partial sum rescaled with the row's max).  Masking and
// normalisation as the reference: -1e30 masked scores, max(l, 1e-30), the
// causal loop ending at the block's last query.  The large tile runs one
// block (8 warps, up to 254 registers a thread at d 128) an SM: blocks of
// 8 thread rows, two an SM, were no faster on an H100
// (tests/_torch_flash_f32_bench.py).  Head dim 256 runs the 32-row tile
// only, with 32-key tiles (136 KB of shared memory).
#include "common.cuh"

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr float kNegInf = -1e30f;    // the reference's mask value

// Where q, k, v and o live: strides in elements, the head dim contiguous.
struct Attn {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long sqb, sqs, sqh, skb, sks, skh, svb, svs, svh;
  int H, G;          // query heads; query heads per KV head (H / K)
  int S, T;
  float scale;       // 1 / sqrt(d)
  int causal;
  int window;        // > 0: keys i - window < j <= i only (causal)
};

// The KV tiles [t0, nt) of `bk` keys a block walks for its queries
// q0 .. qend - 1, one function for every loop over them (the bf16 kernel's
// producer and consumers must agree on the count, or its barriers stall).
// Causal: the walk ends at the block's last query.  WIN (a window > 0): the
// walk starts at the tile of the first key the block's first query keeps,
// so tiles wholly outside the band are never loaded.  Both kernels take WIN
// as a template argument that the launch picks from the window, so window 0
// runs the instantiation without any window code: the kernels as they were.
template <bool WIN>
__device__ __forceinline__ void kv_tiles(const Attn& a, int q0, int qend, int bk, int& t0,
                                         int& nt) {
  const int kend = a.causal ? min(a.T, qend) : a.T;
  nt = (kend + bk - 1) / bk;
  t0 = WIN ? max(0, q0 - a.window + 1) / bk : 0;
}

// ---------------------------------------------------------------------------
// f32: SIMT kernel
// ---------------------------------------------------------------------------

namespace simt {

constexpr int kTX = 16;              // thread columns (one half-warp)

// Shared memory (floats): Q tile, two K buffers, one V buffer, P tile.  Row
// strides of 16 bytes past a multiple of 128 keep the float4 reads of a
// quarter-warp on distinct banks.  Keys per K / V tile: 64, or 32 at head
// dim 256 (three 64-key tiles of 256 dims would take 200 KB).
template <int D, int TY, int TM>
struct Cfg {
  static constexpr int kBK = D > 128 ? 32 : 64;   // keys per K / V tile
  static constexpr int kTN = kBK / kTX;           // key columns per thread
  static constexpr int kThreads = TY * kTX;       // TY thread rows
  static constexpr int kRows = TY * TM;           // query rows a block
  static constexpr int kStride = D + 4;           // Q, K, V rows
  static constexpr int kPStride = kBK + 16;       // P rows
  static constexpr int kQ = kRows * kStride;
  static constexpr int kKV = kBK * kStride;
  static constexpr int kP = kRows * kPStride;
  static constexpr int kDT = D / kTX;             // head dims per thread in P V
  static constexpr size_t kBytes = sizeof(float) * (kQ + 3 * kKV + kP);
};

// the two tiles (thread rows x query rows a thread): 128 rows and 32
constexpr int kLargeTY = 16, kLargeTM = 8;
constexpr int kSmallTY = 16, kSmallTM = 2;

__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most one group (the newest) is in flight
__device__ __forceinline__ void cp_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// this thread's head dims of a row in P V: 4-wide chunks 4 tx + 64 c, or
// (d 16 / 32) dims tx d / 16 .. + d / 16
template <int DT>
__device__ __forceinline__ int dim_of(int tx, int c) {
  return DT >= 4 ? 4 * tx + kTX * 4 * (c / 4) + c % 4 : tx * DT + c;
}
template <int DT>
__device__ __forceinline__ void lds_dims(float (&r)[DT], const float* row, int tx) {
  if constexpr (DT >= 4) {
#pragma unroll
    for (int c = 0; c < DT; c += 4) {
      const float4 t = *reinterpret_cast<const float4*>(row + dim_of<DT>(tx, c));
      r[c] = t.x; r[c + 1] = t.y; r[c + 2] = t.z; r[c + 3] = t.w;
    }
  } else if constexpr (DT == 2) {
    const float2 t = *reinterpret_cast<const float2*>(row + 2 * tx);
    r[0] = t.x; r[1] = t.y;
  } else {
    r[0] = row[tx];
  }
}
__device__ __forceinline__ float comp(const float4& f, int u) {
  return u == 0 ? f.x : u == 1 ? f.y : u == 2 ? f.z : f.w;
}

template <int D, int TY, int TM, bool WIN>
__global__ void __launch_bounds__(TY * kTX, 256 / (TY * kTX) * (TM >= 8 ? 1 : 2))
simt_kernel(const Attn a, int heads, int bq) {
  using C = Cfg<D, TY, TM>;
  constexpr int kC4 = D / 4;         // 16-byte chunks a row
  constexpr int DT = C::kDT;
  constexpr int kBK = C::kBK, kTN = C::kTN;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* k_s = q_s + C::kQ;          // K buffers t % 2
  float* v_s = k_s + 2 * C::kKV;
  float* p_s = v_s + C::kKV;

  const int S = a.S, T = a.T;
  const int groups = a.G / heads;    // blocks per KV head and query tile
  const int K = a.H / a.G;
  const int bk = blockIdx.x / groups;
  const int b = bk / K, kvh = bk % K;
  const int h0 = kvh * a.G + (blockIdx.x % groups) * heads;
  const int q0 = (gridDim.y - 1 - (int)blockIdx.y) * bq;   // heaviest first
  const float* q = (const float*)a.q + b * a.sqb;
  const float* k = (const float*)a.k + b * a.skb + kvh * a.skh;
  const float* v = (const float*)a.v + b * a.svb + kvh * a.svh;
  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;

  // row r of the block: query position q0 + r / heads of head h0 + r % heads
  for (int e = tid; e < C::kRows * kC4; e += C::kThreads) {
    const int r = e / kC4, c = (e % kC4) * 4;
    const int qi = q0 + r / heads;
    const bool ok = qi < S;
    cp16(q_s + r * C::kStride + c,
         ok ? q + qi * a.sqs + (h0 + r % heads) * a.sqh + c : q, ok);
  }
  auto load_tile = [&](float* dst, const float* src, long long rs, int k0) {
    for (int e = tid; e < kBK * kC4; e += C::kThreads) {
      const int r = e / kC4, c = (e % kC4) * 4;
      const int kj = k0 + r;
      const bool ok = kj < T;
      cp16(dst + r * C::kStride + c, ok ? src + kj * rs + c : src, ok);
    }
  };
  // causal: keys j <= i <= the block's last query; later tiles lie above
  // the diagonal; a window: earlier tiles lie below the band
  int t0, nt;
  kv_tiles<WIN>(a, q0, min(S, q0 + bq), kBK, t0, nt);
  constexpr bool win = WIN;
  load_tile(k_s + (t0 & 1) * C::kKV, k, a.sks, t0 * kBK);
  cp_commit();                       // group: Q and K(t0)
  load_tile(v_s, v, a.svs, t0 * kBK);
  cp_commit();                       // group: V(t0)

  int qpos[TM];
  float m[TM], l[TM], acc[TM][DT];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    qpos[i] = q0 + (ty + TY * i) / heads;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DT; ++c) acc[i][c] = 0.f;
  }
  const float sl2 = a.scale * 1.4426950408889634f;   // scale * log2(e)

  for (int t = t0; t < nt; ++t) {
    const int k0 = t * kBK;
    const float* kb = k_s + (t & 1) * C::kKV;
    cp_wait_one();                   // K(t) landed (V(t) may be in flight)
    __syncthreads();

    float s[TM][kTN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int u = 0; u < kTN; ++u) s[i][u] = 0.f;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      float4 qf[TM], kf[kTN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        qf[i] = *reinterpret_cast<const float4*>(q_s + (ty + TY * i) * C::kStride + d);
#pragma unroll
      for (int u = 0; u < kTN; ++u)
        kf[u] = *reinterpret_cast<const float4*>(kb + (tx + kTX * u) * C::kStride + d);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int u = 0; u < kTN; ++u) {
          s[i][u] = fmaf(qf[i].x, kf[u].x, s[i][u]);
          s[i][u] = fmaf(qf[i].y, kf[u].y, s[i][u]);
          s[i][u] = fmaf(qf[i].z, kf[u].z, s[i][u]);
          s[i][u] = fmaf(qf[i].w, kf[u].w, s[i][u]);
        }
    }
    // K(t + 1) into the other buffer: its readers (tile t - 1) are past
    // that tile's barriers
    if (t + 1 < nt) load_tile(k_s + ((t + 1) & 1) * C::kKV, k, a.sks, k0 + kBK);
    cp_commit();

    // scale (log2 units), mask (only a tile that reaches past T or, causal,
    // past the block's first query, or below the band of its last query),
    // online softmax; P to shared memory
    const bool edge = k0 + kBK > T || (a.causal && k0 + kBK - 1 > q0) ||
                      (win && k0 <= q0 + bq - 1 - a.window);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < kTN; ++u) {
        const int kj = k0 + tx + kTX * u;
        const bool keep = !edge || (kj < T && (!a.causal || kj <= qpos[i]) &&
                                    (!win || kj > qpos[i] - a.window));
        s[i][u] = keep ? s[i][u] * sl2 : kNegInf;
        mx = fmaxf(mx, s[i][u]);
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);
      const float alpha = ex2(m[i] - mn);
      m[i] = mn;
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < kTN; ++u) {
        const float p = ex2(s[i][u] - mn);
        p_s[(ty + TY * i) * C::kPStride + tx + kTX * u] = p;
        sum += p;
      }
      l[i] = alpha * l[i] + sum;
#pragma unroll
      for (int c = 0; c < DT; ++c) acc[i][c] *= alpha;
    }
    cp_wait_one();                   // V(t) landed (K(t + 1) may be in flight)
    __syncthreads();                 // P complete

#pragma unroll 4
    for (int j = 0; j < kBK; j += 4) {
      float4 pf[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        pf[i] = *reinterpret_cast<const float4*>(p_s + (ty + TY * i) * C::kPStride + j);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[DT];
        lds_dims<DT>(vv, v_s + (j + u) * C::kStride, tx);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float p = comp(pf[i], u);
#pragma unroll
          for (int c = 0; c < DT; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
    __syncthreads();                 // V(t) and P reads done
    if (t + 1 < nt) load_tile(v_s, v, a.svs, k0 + kBK);
    cp_commit();
  }

  // the row sums over the half-warp; normalise and store
  float* o = (float*)a.o;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float lt = l[i];
#pragma unroll
    for (int off = kTX / 2; off > 0; off >>= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, off);
    const int r = ty + TY * i, qi = qpos[i];
    if (qi >= S) continue;
    const float denom = fmaxf(lt, 1e-30f);
    float* orow = o + (((long long)b * S + qi) * a.H + h0 + r % heads) * D;
#pragma unroll
    for (int c = 0; c < DT; ++c) orow[dim_of<DT>(tx, c)] = acc[i][c] / denom;
  }
}

template <int D, int TY, int TM, bool WIN>
int launch_tile(const Attn& a, int hx, int heads, void* stream) {
  using C = Cfg<D, TY, TM>;
  // above 48 KB a block's shared memory is granted only on request
  static bool granted = false;
  if (!granted) {
    cudaError_t e = cudaFuncSetAttribute(simt_kernel<D, TY, TM, WIN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::kBytes);
    if (e != cudaSuccess) return (int)e;
    granted = true;
  }
  const int bq = C::kRows / heads;
  const int tiles = (a.S + bq - 1) / bq;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(hx, tiles);
  simt_kernel<D, TY, TM, WIN><<<grid, C::kThreads, C::kBytes, (cudaStream_t)stream>>>(a, heads,
                                                                                     bq);
  return (int)cudaGetLastError();
}

// rows: query rows a block (the large or the small tile's); heads: query
// heads of a KV head a block takes (1, 2, 4 or 8, dividing H / K)
template <int D>
int launch(const Attn& a, int B, int K, int rows, int heads, void* stream) {
  if ((heads != 1 && heads != 2 && heads != 4 && heads != 8) || a.G % heads)
    return (int)cudaErrorInvalidValue;
  const long long hx = (long long)B * K * (a.G / heads);
  if (hx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool win = a.window > 0;
  // head dim 256: the small tile only (a 128-row Q tile takes 133 KB)
  if constexpr (D <= 128)
    if (rows == kLargeTY * kLargeTM)
      return win ? launch_tile<D, kLargeTY, kLargeTM, true>(a, (int)hx, heads, stream)
                 : launch_tile<D, kLargeTY, kLargeTM, false>(a, (int)hx, heads, stream);
  if (rows == kSmallTY * kSmallTM)
    return win ? launch_tile<D, kSmallTY, kSmallTM, true>(a, (int)hx, heads, stream)
               : launch_tile<D, kSmallTY, kSmallTM, false>(a, (int)hx, heads, stream);
  return (int)cudaErrorInvalidValue;
}

template <int D>
int smem_bytes(int rows) {
  if constexpr (D <= 128)
    if (rows == kLargeTY * kLargeTM) return (int)Cfg<D, kLargeTY, kLargeTM>::kBytes;
  return (int)Cfg<D, kSmallTY, kSmallTM>::kBytes;
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16: tensor-core kernel (wgmma)
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kBQ = 128;             // queries per block: two consumer warpgroups
constexpr int kStages = 3;           // K / V ring
constexpr int kThreads = 384;        // producer warpgroup + two consumers

template <int D>
struct Cfg {
  static constexpr int DP = D < 64 ? 64 : D;        // head dim in shared memory
  // keys per K / V tile: 64, or 32 at head dim 256, where O alone takes 128
  // f32 registers a consumer thread and S and P half as many as at 64 keys
  static constexpr int kBK = D > 128 ? 32 : 64;
  static constexpr int kQBytes = kBQ * DP * 2;
  static constexpr int kTileBytes = kBK * DP * 2;    // one K or V tile
  // + 1024 for the alignment of the swizzled tiles, + the mbarriers
  static constexpr int kSmem = kQBytes + 2 * kStages * kTileBytes + 1024 + 64;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t a, int n) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(a), "r"(n) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t a, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(a), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t a) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(a) : "memory");
}
// Wait for the phase of parity `parity` to complete; a wait of ~10 s
// means a lost arrival, so the kernel traps rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t a, uint32_t parity) {
  const long long t0 = clock64();
  while (true) {
    uint32_t done;
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n" : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > 20000000000LL) asm volatile("trap;");
  }
}
// TMA: the (64 head dims, 1, rows, 1) box at coordinates (c0, c1, c2, c3)
// of a 4-D (d, heads, rows, batch) tensor, swizzled into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, int c3, uint32_t bar) {
  asm volatile("cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
               :: "r"(dst), "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
               : "memory");
}
// named barriers 1 and 2 order the two consumers' wgmma issue
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; byte offsets
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accumulator reads across a wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// the two bf16 halves of a packed pair, as floats
__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// d (64 x 64, f32) (+)= A (64 x 16, shared, K-major) * B (16 x 64, shared, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}


// d (64 x 32, f32) (+)= A (64 x 16, shared, K-major) * B (16 x 32, shared, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16, registers) * B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// d (64 x 128, f32) += A (64 x 16, registers) * B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

template <int D, bool WIN>
__global__ void __launch_bounds__(kThreads, 1)
tc_kernel(const Attn a, const __grid_constant__ CUtensorMap tmq,
          const __grid_constant__ CUtensorMap tmk, const __grid_constant__ CUtensorMap tmv) {
  using C = Cfg<D>;
  constexpr int DP = C::DP;
  constexpr int kBK = C::kBK;
  constexpr int NS = kBK / 2;        // score registers per thread
  constexpr int NO = DP / 2;         // output registers per thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base;
  // ring slots and barriers by the walk's step i (tile t0 + i)
  auto k_s = [&](int i) { return base + C::kQBytes + (i % kStages) * 2 * C::kTileBytes; };
  auto v_s = [&](int i) { return k_s(i) + C::kTileBytes; };
  const uint32_t bars = base + C::kQBytes + 2 * kStages * C::kTileBytes;
  auto full = [&](int i) { return bars + 8 * (i % kStages); };
  auto empty = [&](int i) { return bars + 8 * (kStages + i % kStages); };
  const uint32_t qbar = bars + 8 * 2 * kStages;

  const int S = a.S, T = a.T;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H, kvh = h / a.G;
  const int q0 = (gridDim.y - 1 - (int)blockIdx.y) * kBQ;   // heaviest first
  int t0, nt;                        // the producer's and the consumers' walk
  kv_tiles<WIN>(a, q0, q0 + kBQ, kBK, t0, nt);
  const int steps = nt - t0;
  constexpr bool win = WIN;
  const int tid = threadIdx.x, wg = tid >> 7;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full(i), 1);
      mbar_init(empty(i), 256);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full; rows past S or T and head
    // dims past d arrive as zeros (TMA's out-of-bounds fill)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      mbar_expect(qbar, C::kQBytes);
#pragma unroll
      for (int j = 0; j < DP / 64; ++j) tma_load(q_s + j * (kBQ * 128), &tmq, 64 * j, h, q0, b, qbar);
      for (int i = 0; i < steps; ++i) {
        const int k0 = (t0 + i) * kBK;
        if (i >= kStages) mbar_wait(empty(i), (i / kStages - 1) & 1);
        mbar_expect(full(i), 2 * C::kTileBytes);
#pragma unroll
        for (int j = 0; j < DP / 64; ++j) {
          tma_load(k_s(i) + j * (kBK * 128), &tmk, 64 * j, kvh, k0, b, full(i));
          tma_load(v_s(i) + j * (kBK * 128), &tmv, 64 * j, kvh, k0, b, full(i));
        }
      }
    }
    return;
  }

  // consumers: warpgroup cw owns query rows 64 cw .. 64 cw + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = wg - 1;
  const int w = (tid >> 5) & 3, lane = tid & 31;
  const int rA = 64 * cw + 16 * w + (lane >> 2);   // this thread's rows rA, rA + 8
  const int cq = 2 * (lane & 3);                   // and columns cq, cq + 1 of 8
  const int my_bar = 1 + cw, other_bar = 2 - cw;

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float s[NS];
  uint32_t ph[NS / 2], pl[NS / 2];   // P = hi + lo, two bf16 A operands
  float mA = kNegInf, mB = kNegInf, lA = 0.f, lB = 0.f;
  const float sl2 = a.scale * 1.4426950408889634f;   // scale * log2(e)
  if (cw == 1) bar_arrive(1);        // consumer 0 issues first
  mbar_wait(qbar, 0);

  for (int t = 0; t < steps; ++t) {
    const int k0 = (t0 + t) * kBK;
    mbar_wait(full(t), (t / kStages) & 1);
    // S = Q K^T over the head dim, 16 at a time (K-major; 32 B along the
    // swizzled row per step, the next 64-column sub-tile every 4 steps),
    // issued in turn with the other consumer
    bar_sync(my_bar);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk & 3) << 5;
      const uint64_t da = desc(q_s + (kk >> 2) * (kBQ * 128) + cw * (64 * 128) + off, 16, 1024);
      const uint64_t db = desc(k_s(t) + (kk >> 2) * (kBK * 128) + off, 16, 1024);
      wgmma_ss(s, da, db, kk > 0);
    }
    wgmma_commit();
    bar_arrive(other_bar);
    wgmma_wait();
    fence_regs(s);

    // scale (log2 units), mask, online softmax
    const bool edge = k0 + kBK > T || (a.causal && k0 + kBK - 1 > q0) ||
                      (win && k0 <= q0 + kBQ - 1 - a.window);
    if (edge) {
      const int qa = q0 + rA, qb = qa + 8;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int kj = k0 + 8 * (i >> 2) + cq + (i & 1);
        const int qi = (i & 2) ? qb : qa;
        const bool keep = kj < T && (!a.causal || kj <= qi) && (!win || kj > qi - a.window);
        s[i] = keep ? s[i] * sl2 : kNegInf;
      }
    } else {
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] *= sl2;
    }
    float xA = kNegInf, xB = kNegInf;
#pragma unroll
    for (int i = 0; i < NS; i += 4) {
      xA = fmaxf(xA, fmaxf(s[i], s[i + 1]));
      xB = fmaxf(xB, fmaxf(s[i + 2], s[i + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      xA = fmaxf(xA, __shfl_xor_sync(0xffffffffu, xA, off));
      xB = fmaxf(xB, __shfl_xor_sync(0xffffffffu, xB, off));
    }
    const float nA = fmaxf(mA, xA), nB = fmaxf(mB, xB);
    const float alA = ex2(mA - nA), alB = ex2(mB - nB);
    mA = nA;
    mB = nB;
    float sumA = 0.f, sumB = 0.f;
#pragma unroll
    for (int i = 0; i < NS; i += 4) {
      const float p0 = ex2(s[i] - nA), p1 = ex2(s[i + 1] - nA);
      const float p2 = ex2(s[i + 2] - nB), p3 = ex2(s[i + 3] - nB);
      sumA += p0 + p1;
      sumB += p2 + p3;
      const uint32_t h01 = pack_bf16(p0, p1), h23 = pack_bf16(p2, p3);
      ph[i / 2] = h01;
      ph[i / 2 + 1] = h23;
      pl[i / 2] = pack_bf16(p0 - bf16_lo(h01), p1 - bf16_hi(h01));
      pl[i / 2 + 1] = pack_bf16(p2 - bf16_lo(h23), p3 - bf16_hi(h23));
    }
    lA = lA * alA + sumA;
    lB = lB * alB + sumB;
    if (__any_sync(0xffffffffu, alA != 1.f || alB != 1.f)) {   // a row max moved
#pragma unroll
      for (int i = 0; i < NO; i += 4) {
        o[i] *= alA;
        o[i + 1] *= alA;
        o[i + 2] *= alB;
        o[i + 3] *= alB;
      }
    }

    // O += P_hi V + P_lo V over the tile's keys, 16 at a time (V MN-major:
    // LBO the next 64 head dims, SBO the next 8 keys); head dim 256 as two
    // 128-column halves of O, the second from V's third 64-dim sub-tile
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t dv = desc(v_s(t) + kk * (16 * 128), DP > 64 ? kBK * 128 : 1024, 1024);
      if constexpr (NO == 128) {
        float(&o0)[64] = *reinterpret_cast<float(*)[64]>(o);
        float(&o1)[64] = *reinterpret_cast<float(*)[64]>(o + 64);
        const uint64_t dv1 = desc(v_s(t) + 2 * (kBK * 128) + kk * (16 * 128), kBK * 128, 1024);
        wgmma_rs(o0, ph[4 * kk], ph[4 * kk + 1], ph[4 * kk + 2], ph[4 * kk + 3], dv);
        wgmma_rs(o0, pl[4 * kk], pl[4 * kk + 1], pl[4 * kk + 2], pl[4 * kk + 3], dv);
        wgmma_rs(o1, ph[4 * kk], ph[4 * kk + 1], ph[4 * kk + 2], ph[4 * kk + 3], dv1);
        wgmma_rs(o1, pl[4 * kk], pl[4 * kk + 1], pl[4 * kk + 2], pl[4 * kk + 3], dv1);
      } else {
        wgmma_rs(o, ph[4 * kk], ph[4 * kk + 1], ph[4 * kk + 2], ph[4 * kk + 3], dv);
        wgmma_rs(o, pl[4 * kk], pl[4 * kk + 1], pl[4 * kk + 2], pl[4 * kk + 3], dv);
      }
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(o);
    mbar_arrive(empty(t));           // this stage may be refilled
  }
  if (cw == 0) bar_sync(1);          // consumer 1's last arrive

  // the row sums over the 4 lanes of a row; normalise and store
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    lA += __shfl_xor_sync(0xffffffffu, lA, off);
    lB += __shfl_xor_sync(0xffffffffu, lB, off);
  }
  const float iA = 1.f / fmaxf(lA, 1e-30f), iB = 1.f / fmaxf(lB, 1e-30f);
  const long long so = (long long)a.H * D;          // o's row stride
  __nv_bfloat16* out = (__nv_bfloat16*)a.o + ((long long)b * S * a.H + h) * D;
  const int qa = q0 + rA, qb = qa + 8;
#pragma unroll
  for (int i = 0; i < NO; i += 4) {
    const int c = 8 * (i >> 2) + cq;
    if (c >= D) break;
    if (qa < S)
      *reinterpret_cast<__nv_bfloat162*>(out + qa * so + c) =
          __floats2bfloat162_rn(o[i] * iA, o[i + 1] * iA);
    if (qb < S)
      *reinterpret_cast<__nv_bfloat162*>(out + qb * so + c) =
          __floats2bfloat162_rn(o[i + 2] * iB, o[i + 3] * iB);
  }
}

// cuTensorMapEncodeTiled from the driver, found at run time (no libcuda link)
PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess || q != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = (PFN_cuTensorMapEncodeTiled_v12000)p;
  }
  return fn;
}

// The 4-D (d, heads, rows, batch) view of q, k or v (strides in elements,
// the head dim contiguous), read in boxes of 64 head dims x `rows` rows
// with the 128-byte swizzle that the wgmma descriptors expect.
int make_map(CUtensorMap* m, const void* ptr, int d, int heads, int n, int B, long long s_row,
             long long s_head, long long s_b, int rows) {
  auto fn = encode_fn();
  if (!fn) return (int)cudaErrorNotSupported;
  cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)n, (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)s_head * 2, (cuuint64_t)s_row * 2, (cuuint64_t)s_b * 2};
  cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                  box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D, bool WIN>
int launch_win(const Attn& a, int B, int K, int BH, void* stream) {
  // above 48 KB a block's shared memory is granted only on request
  static bool granted = false;
  if (!granted) {
    cudaError_t e = cudaFuncSetAttribute(tc_kernel<D, WIN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Cfg<D>::kSmem);
    if (e != cudaSuccess) return (int)e;
    granted = true;
  }
  CUtensorMap mq, mk, mv;
  int rc = make_map(&mq, a.q, D, a.H, a.S, B, a.sqs, a.sqh, a.sqb, kBQ);
  if (!rc) rc = make_map(&mk, a.k, D, K, a.T, B, a.sks, a.skh, a.skb, Cfg<D>::kBK);
  if (!rc) rc = make_map(&mv, a.v, D, K, a.T, B, a.svs, a.svh, a.svb, Cfg<D>::kBK);
  if (rc) return rc;
  dim3 grid(BH, (a.S + kBQ - 1) / kBQ);
  tc_kernel<D, WIN><<<grid, kThreads, Cfg<D>::kSmem, (cudaStream_t)stream>>>(a, mq, mk, mv);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const Attn& a, int B, int K, int BH, void* stream) {
  return a.window > 0 ? launch_win<D, true>(a, B, K, BH, stream)
                      : launch_win<D, false>(a, B, K, BH, stream);
}

}  // namespace tc

// q, k, v, o and the 9 strides as an Attn; false on shapes the kernels
// do not take
// window > 0 needs causal and T >= S (every query then keeps its own key)
bool make_attn(Attn* a, const void* q, const void* k, const void* v, void* o,
               const long long* strides, int B, int H, int K, int S, int T, int d,
               int causal, int window) {
  if (T <= 0 || H <= 0 || K <= 0 || H % K != 0 || (long long)B * H > 0x7fffffffLL ||
      window < 0 || (window > 0 && (!causal || T < S)))
    return false;
  *a = Attn{q, k, v, o,
            strides[0], strides[1], strides[2], strides[3], strides[4],
            strides[5], strides[6], strides[7], strides[8],
            H, H / K, S, T, (float)(1.0 / sqrt((double)d)), causal, window};
  return true;
}

int launch_bf16(const void* q, const void* k, const void* v, void* o,
                const long long* strides, int B, int H, int K, int S, int T, int d,
                int causal, int window, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  Attn a;
  if (!make_attn(&a, q, k, v, o, strides, B, H, K, S, T, d, causal, window) ||
      (S + tc::kBQ - 1) / tc::kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  const int BH = B * H;
  switch (d) {
    case 16: return tc::launch<16>(a, B, K, BH, stream);
    case 32: return tc::launch<32>(a, B, K, BH, stream);
    case 64: return tc::launch<64>(a, B, K, BH, stream);
    case 128: return tc::launch<128>(a, B, K, BH, stream);
    case 256: return tc::launch<256>(a, B, K, BH, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* o,
               const long long* strides, int B, int H, int K, int S, int T, int d,
               int causal, int window, int rows, int heads, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  Attn a;
  if (!make_attn(&a, q, k, v, o, strides, B, H, K, S, T, d, causal, window))
    return (int)cudaErrorInvalidValue;
  switch (d) {
    case 16: return simt::launch<16>(a, B, K, rows, heads, stream);
    case 32: return simt::launch<32>(a, B, K, rows, heads, stream);
    case 64: return simt::launch<64>(a, B, K, rows, heads, stream);
    case 128: return simt::launch<128>(a, B, K, rows, heads, stream);
    case 256: return simt::launch<256>(a, B, K, rows, heads, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, S, H, d), k and v (B, T, K, d) with `strides` = the batch, row and
// head strides of q, k, v in elements (9 values); o (B, S, H, d) contiguous.
// window > 0: keys i - window < j <= i only (causal, T >= S); 0: none.
// f32: `rows` (128 or 32; 32 at d 256) and `heads` (1, 2, 4 or 8) pick the
// block's tile (flash_attention.f32_tile).
REPRO_EXPORT int flash_attention_f32(const void* q, const void* k, const void* v,
                                     void* o, const long long* strides, int B,
                                     int H, int K, int S, int T, int d, int causal,
                                     int window, int rows, int heads, void* stream) {
  return launch_f32(q, k, v, o, strides, B, H, K, S, T, d, causal, window, rows,
                    heads, stream);
}

REPRO_EXPORT int flash_attention_bf16(const void* q, const void* k, const void* v,
                                      void* o, const long long* strides, int B,
                                      int H, int K, int S, int T, int d, int causal,
                                      int window, void* stream) {
  return launch_bf16(q, k, v, o, strides, B, H, K, S, T, d, causal, window, stream);
}

// dynamic shared memory of the kernel for head dim d (tensor_cores: the
// bf16 kernel, else the f32 one with `rows` query rows a block), for reports
REPRO_EXPORT int flash_attention_smem(int d, int tensor_cores, int rows) {
  switch (d) {
    case 16: return tensor_cores ? tc::Cfg<16>::kSmem : simt::smem_bytes<16>(rows);
    case 32: return tensor_cores ? tc::Cfg<32>::kSmem : simt::smem_bytes<32>(rows);
    case 64: return tensor_cores ? tc::Cfg<64>::kSmem : simt::smem_bytes<64>(rows);
    case 128: return tensor_cores ? tc::Cfg<128>::kSmem : simt::smem_bytes<128>(rows);
    case 256: return tensor_cores ? tc::Cfg<256>::kSmem : simt::smem_bytes<256>(rows);
    default: return -1;
  }
}
