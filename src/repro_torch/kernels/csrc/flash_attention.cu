// Flash attention (online softmax, causal or bidirectional) on Hopper.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (its pallas_call at flash_attention.py:84, body _kernel at :27-65):
//     o = softmax(q k^T / sqrt(d)) v          per batch*head bh,
// an optional causal mask "key j <= query i" in absolute indices (top-left
// aligned when T != S), f32 running max / denominator / accumulator, the
// output divided by max(l, 1e-30) and written in q's dtype.  q: (BH, S, d),
// k and v: (BH, T, d) with the KV heads already expanded to query heads,
// all contiguous.  Inputs are float32 or bfloat16; all arithmetic is f32
// (p is never rounded to bf16).
//
// The TPU version walks the KV blocks as the innermost, sequential grid
// axis and carries m / l / acc in VMEM scratch from one grid step to the
// next, asserting that S and T are multiples of its blocks.  On Hopper the
// blocks of a grid run concurrently and in no order, so the KV walk is a
// loop inside the block: one block of 128 threads owns a 64-query tile of
// one bh, keeps its Q tile in shared memory and its m / l / acc in
// registers, and streams 64-key K and V tiles through one shared buffer.
// Ragged tails are masked in the kernel (queries past S are not stored,
// keys past T are masked like the causal mask), so any S and T work.  In
// causal mode the KV loop stops at the tile's last query: tiles strictly
// above the diagonal are never loaded.  The heaviest causal query tiles
// are scheduled first.
//
// Thread layout: 8 x 16 threads; thread (ty, tx) owns the 8 query rows
// ty*8 .. ty*8+7, key columns tx + 16 j of each score tile and head dims
// tx + 16 c of the accumulator, so the rows a thread rescales are the rows
// whose max and sum it helped reduce (a shuffle over the 16 lanes of its
// half-warp).  K is stored transposed with a padded stride and P and Q with
// padded strides, so the inner loops read shared memory without bank
// conflicts.
//
// Bound: operations.  4 * BH * S * T * d flops (halved by the causal mask
// at S = T) against (q + k + v + o) bytes: at the prefill shape (BH 128,
// S = T = 4096, d 64) about 2,000 flops per byte, far above the card's
// balance point.  This simple kernel runs on the f32 FMA pipes (no tensor
// cores, no TF32), so it sits far below the bf16 tensor-core bound; wgmma /
// TMA / warp specialisation are the redesign.
#include "common.cuh"

#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;              // queries per block
constexpr int kBK = 64;              // keys per KV tile
constexpr int kTY = 8;               // thread rows
constexpr int kTX = 16;              // thread columns (one half-warp)
constexpr int kThreads = kTY * kTX;  // 128
constexpr int kRows = kBQ / kTY;     // query rows per thread: 8
constexpr int kCols = kBK / kTX;     // key columns per thread: 4
constexpr float kNegInf = -1e30f;    // the reference's mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// shared-memory layout (floats): Q tile, one K^T / V buffer, P tile
template <int D>
struct Smem {
  static constexpr int kQStride = D + 1;
  static constexpr int kKtStride = kBK + 1;
  static constexpr int kPStride = kBK + 1;
  static constexpr int kQ = kBQ * kQStride;
  static constexpr int kKV = D * kKtStride > kBK * D ? D * kKtStride : kBK * D;
  static constexpr int kP = kBQ * kPStride;
  static constexpr size_t kBytes = sizeof(float) * (kQ + kKV + kP);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int S, int Tk,
             float scale, int causal) {
  using L = Smem<D>;
  constexpr int kDC = D / kTX;       // accumulator columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;
  float* kv_s = q_s + L::kQ;
  float* p_s = kv_s + L::kKV;

  const int nq = (S + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kBQ;   // heaviest tiles first
  const size_t qbase = (size_t)blockIdx.y * S * D;
  const size_t kbase = (size_t)blockIdx.y * Tk * D;
  const int tid = threadIdx.x;
  const int ty = tid / kTX, tx = tid % kTX;
  const int r0 = ty * kRows;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int qi = q0 + r;
    q_s[r * L::kQStride + c] = qi < S ? to_f32(q[qbase + (size_t)qi * D + c]) : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][kDC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDC; ++c) acc[i][c] = 0.f;
  }

  // causal: keys j <= i <= q0 + kBQ - 1; later tiles lie above the diagonal
  const int kend = causal ? min(Tk, q0 + kBQ) : Tk;
  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();                 // Q stored / last tile's V reads done
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, c = e % D;
      const int kj = k0 + r;
      kv_s[c * L::kKtStride + r] = kj < Tk ? to_f32(k[kbase + (size_t)kj * D + c]) : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float kk[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kk[j] = kv_s[d * L::kKtStride + tx + kTX * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float qv = q_s[(r0 + i) * L::kQStride + d];
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv, kk[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + r0 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kj = k0 + tx + kTX * j;
        const bool keep = kj < Tk && (!causal || kj <= qi);
        s[i][j] = keep ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        p_s[(r0 + i) * L::kPStride + tx + kTX * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kDC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();                 // K^T reads done, P complete

    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, c = e % D;
      const int kj = k0 + r;
      kv_s[r * D + c] = kj < Tk ? to_f32(v[kbase + (size_t)kj * D + c]) : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float vv[kDC];
#pragma unroll
      for (int c = 0; c < kDC; ++c) vv[c] = kv_s[j * D + tx + kTX * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = p_s[(r0 + i) * L::kPStride + j];
#pragma unroll
        for (int c = 0; c < kDC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + r0 + i;
    if (qi >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kDC; ++c)
      store(o + qbase + (size_t)qi * D + tx + kTX * c, acc[i][c] / denom);
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* o, int BH,
             int S, int Tk, int causal, void* stream) {
  // above 48 KB a block's shared memory is granted only on request
  static bool granted = false;
  if (!granted) {
    cudaError_t e = cudaFuncSetAttribute(flash_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Smem<D>::kBytes);
    if (e != cudaSuccess) return (int)e;
    granted = true;
  }
  const float scale = (float)(1.0 / sqrt((double)D));
  dim3 grid((S + kBQ - 1) / kBQ, BH);
  flash_kernel<T, D><<<grid, kThreads, Smem<D>::kBytes, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, S, Tk, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int BH, int S,
           int Tk, int d, int causal, void* stream) {
  if (BH <= 0 || S <= 0) return 0;
  if (Tk <= 0 || BH > 65535) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 16: return launch_d<T, 16>(q, k, v, o, BH, S, Tk, causal, stream);
    case 32: return launch_d<T, 32>(q, k, v, o, BH, S, Tk, causal, stream);
    case 64: return launch_d<T, 64>(q, k, v, o, BH, S, Tk, causal, stream);
    case 128: return launch_d<T, 128>(q, k, v, o, BH, S, Tk, causal, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

REPRO_EXPORT int flash_attention_f32(const void* q, const void* k, const void* v,
                                     void* o, int BH, int S, int T, int d,
                                     int causal, void* stream) {
  return launch<float>(q, k, v, o, BH, S, T, d, causal, stream);
}

REPRO_EXPORT int flash_attention_bf16(const void* q, const void* k, const void* v,
                                      void* o, int BH, int S, int T, int d,
                                      int causal, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, BH, S, T, d, causal, stream);
}
