// DeepSeek-V3.2 sparse attention (DSA): the lightning indexer and the
// top-k token selector, for Hopper (sm_90a). The third DSA kernel, the
// sparse MLA forward, is sparse_mla.cu.
//
// 1. tl_lightning_indexer replaces tilelang_mesh_tpu/ops/dsa.py ::
//    lightning_indexer_kernel. Same contract:
//      QI (B, S, HI, DI)  float32, bfloat16 or float16, contiguous
//      KI (B, Skv, DI)    same type
//      W  (B, S, HI)      float32
//      L  (B, S, Skv)     float32: sum_h W[b,t,h] relu(QI[b,t,h] . KI[b,j])
//                         where j <= q_offset + t, else -inf
//    Bound: operations (HI (2 DI + 3) flops per visible (t, j) pair against
//    a float32 logit written once: hundreds of flops a byte).
//    Design. The TPU kernel keeps all of KI and a (block_T x Skv) logits
//    tile in VMEM; at Skv = 8192 that is megabytes, past a block's 227 KB
//    of shared memory. So a block owns a 128 x 128 tile of (query, key)
//    and runs the head loop inside it: for each head the block tile loop
//    of gemm_tile.cuh computes QI[:, h] . KI^T over DI (FFMA in float32;
//    mma.sync m16n8k16 with float32 sums in bfloat16 and float16), and
//    the epilogue adds relu(.) * W[t, h] into a second register tile, in
//    float32, head after head. A tile wholly past the causal bound of its
//    last query is written -inf without a product.
//
// 2. tl_topk_selector replaces tilelang_mesh_tpu/ops/dsa.py ::
//    topk_selector_kernel. Same contract: for each row of L (Skv float32)
//    the ids of its topk largest entries in descending order, ties to the
//    smaller id; an entry at or below -1e30 (finite or not) is no
//    candidate, and slots past the candidates hold -1. A NaN entry is no
//    candidate either (the JAX kernel's contract leaves NaN out).
//    Bound: bytes (the row read once, the ids written once).
//    Design. The TPU kernel runs topk rounds of a full-row argmax (2048 x
//    8192 compares a row at DeepSeek-V3.2's widths). Here one block owns
//    a row, kept in shared memory as order-preserving uint32 keys (0 for
//    a non-candidate; -0.0 as +0.0, which the JAX kernel's == ties): a
//    radix select (four 8-bit digit histograms) finds the K-th largest
//    key, K = min(topk, candidates); the keys above it and the first
//    (by id) of those equal to it are gathered as 64-bit words (key << 32
//    | ~id) and bitonic-sorted descending, which puts equal keys in
//    ascending id order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gemm_tile.cuh"

namespace {

using tl_gemm::BM;
using tl_gemm::BN;
using tl_gemm::kThreads;

// ---------------------------------------------------------------------------
// 1. lightning indexer
// ---------------------------------------------------------------------------

// the block's (query t0 + r, key j0 + c) logit v, -inf past the causal
// bound, stored when inside (rows, Skv)
__device__ __forceinline__ void store_logit(float* o, int r, int c, int rows,
                                            int j0, int Skv, int bound0,
                                            float v) {
  if (r < rows && j0 + c < Skv)
    o[(long long)r * Skv + j0 + c] = j0 + c <= bound0 + r ? v : -INFINITY;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
lightning_indexer(const T* __restrict__ qi, const T* __restrict__ ki,
                  const float* __restrict__ w, float* __restrict__ out,
                  int S, int Skv, int HI, int DI, int q_offset, bool vec) {
  const int j0 = blockIdx.x * BN, t0 = blockIdx.y * BM, b = blockIdx.z;
  const int rows = min(BM, S - t0);
  const int bound0 = q_offset + t0;            // query t0's last key
  float* o = out + ((long long)b * S + t0) * Skv;
  if (j0 > bound0 + rows - 1) {                // every key past every query
    for (int i = threadIdx.x; i < rows * BN; i += kThreads)
      if (j0 + i % BN < Skv)
        o[(long long)(i / BN) * Skv + j0 + i % BN] = -INFINITY;
    return;
  }
  const T* q0 = qi + ((long long)b * S + t0) * HI * DI;
  const T* kb = ki + (long long)b * Skv * DI;
  const float* w0 = w + ((long long)b * S + t0) * HI;
  const long long lda = (long long)HI * DI;
  if constexpr (sizeof(T) == 4) {
    namespace g = tl_gemm::f32;
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    float sum[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sum[i][j] = 0.f;
    for (int h = 0; h < HI; ++h) {
      const g::Direct<false, true> src{q0 + h * DI, kb, lda, rows,
                                       j0,          DI, Skv, vec};
      g::Acc acc;
      g::loop<false, true>(src, (DI + g::BK - 1) / g::BK, acc);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = g::pos<false>(ty, i);
        const float wv = r < rows ? __ldg(w0 + (long long)r * HI + h) : 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          sum[i][j] = fmaf(fmaxf(acc[i][j], 0.f), wv, sum[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        store_logit(o, g::pos<false>(ty, i), g::pos<false>(tx, j), rows, j0,
                    Skv, bound0, sum[i][j]);
  } else {
    namespace g = tl_gemm::bf16;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int wm = (warp % 2) * 64, gr = lane / 4;
    g::Acc<float> sum;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[mi][ni][e] = 0.f;
    for (int h = 0; h < HI; ++h) {
      const tl_gemm::Direct<T, g::BK, g::PAD, false, true> src{
          q0 + h * DI, kb, lda, rows, j0, DI, Skv, vec};
      g::Acc<float> acc;
      g::loop<false, true>(src, (DI + g::BK - 1) / g::BK, acc);
      // acc[mi][ni][2 hh + e] sits at row wm + 16 mi + gr + 8 hh
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = wm + mi * 16 + gr + 8 * hh;
          const float wv =
              r < rows ? __ldg(w0 + (long long)r * HI + h) : 0.f;
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              sum[mi][ni][2 * hh + e] = fmaf(
                  fmaxf(acc[mi][ni][2 * hh + e], 0.f), wv,
                  sum[mi][ni][2 * hh + e]);
        }
    }
    g::for_each(sum, [&](int r, int c, float v) {
      store_logit(o, r, c, rows, j0, Skv, bound0, v);
    });
  }
}

template <typename T>
int launch_indexer(const void* qi, const void* ki, const float* w,
                   float* out, int B, int S, int Skv, int HI, int DI,
                   int q_offset, cudaStream_t stream) {
  const int esize = (int)sizeof(T);
  const bool vec = tl_gemm::vec_ok(qi, ki, DI, Skv, true, esize) &&
                   ((long long)HI * DI * esize) % 16 == 0;
  const dim3 grid((Skv + BN - 1) / BN, (S + BM - 1) / BM, B);
  lightning_indexer<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(qi), static_cast<const T*>(ki), w, out, S, Skv,
      HI, DI, q_offset, vec);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 2. top-k selector
// ---------------------------------------------------------------------------

constexpr int kSelThreads = 512;
constexpr int kSelWarps = kSelThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// order-preserving key of a logit: 0 for no candidate (<= -1e30, NaN),
// larger keys for larger values; -0.0 keys as +0.0
__device__ __forceinline__ uint32_t order_key(float f) {
  if (!(f > -1e30f)) return 0u;
  if (f == 0.f) f = 0.f;
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// block-wide sum of x (every thread gets it); `red` holds kSelWarps ints
__device__ __forceinline__ int block_sum(int x, int* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int i = 0; i < kSelWarps; ++i) s += red[i];
  return s;
}

// block-wide exclusive prefix sum of x in thread order
__device__ __forceinline__ int block_exclusive(int x, int* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int inc = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, inc, off);
    if (lane >= off) inc += y;
  }
  __syncthreads();
  if (lane == 31) red[warp] = inc;
  __syncthreads();
  int base = 0;
  for (int i = 0; i < warp; ++i) base += red[i];
  return base + inc - x;
}

__global__ void __launch_bounds__(kSelThreads)
topk_selector(const float* __restrict__ logits, int* __restrict__ ids,
              int Skv, int topk, int p2) {
  extern __shared__ __align__(16) unsigned char sel_smem[];
  uint64_t* cand = reinterpret_cast<uint64_t*>(sel_smem);     // [p2]
  uint32_t* keys = reinterpret_cast<uint32_t*>(cand + p2);    // [Skv]
  __shared__ int hist[256];
  __shared__ int red[kSelWarps];
  __shared__ uint32_t s_prefix;
  __shared__ int s_need, s_gt;
  const int tid = threadIdx.x;
  const float* row = logits + (long long)blockIdx.x * Skv;
  int* out = ids + (long long)blockIdx.x * topk;

  int mine = 0;
  for (int j = tid; j < Skv; j += kSelThreads) {
    const uint32_t k = order_key(__ldg(row + j));
    keys[j] = k;
    mine += k != 0u;
  }
  const int K = min(topk, block_sum(mine, red));   // also a barrier
  if (K == 0) {
    for (int s = tid; s < topk; s += kSelThreads) out[s] = -1;
    return;
  }

  // radix select: `prefix` gathers the K-th largest key's digits from the
  // top; `need` is its rank among the keys that share them
  uint32_t prefix = 0u;
  int need = K;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += kSelThreads) hist[i] = 0;
    __syncthreads();
    const uint32_t hi = shift == 24 ? 0u : ~0u << (shift + 8);
    for (int j = tid; j < Skv; j += kSelThreads) {
      const uint32_t k = keys[j];
      if (k != 0u && (k & hi) == prefix)
        atomicAdd(&hist[(k >> shift) & 255u], 1);
    }
    __syncthreads();
    if (tid < 32) {
      // lane l holds digits 255 - 8 l down to 248 - 8 l
      int c[8], tot = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) tot += c[i] = hist[255 - 8 * tid - i];
      int inc = tot;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(kFull, inc, off);
        if (tid >= off) inc += y;
      }
      int above = inc - tot;           // keys of larger digits
      if (above < need && need <= inc) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (need <= above + c[i]) {
            s_prefix = prefix | ((uint32_t)(255 - 8 * tid - i) << shift);
            s_need = need - above;
            break;
          }
          above += c[i];
        }
      }
    }
    __syncthreads();
    prefix = s_prefix;
    need = s_need;
  }
  const uint32_t kth = prefix;
  const int n_gt = K - need;           // keys above kth; `need` equal ones

  // gather: keys above kth anywhere in [0, n_gt), the first `need` equal
  // to kth by id after them
  if (tid == 0) s_gt = 0;
  const int chunk = (Skv + kSelThreads - 1) / kSelThreads;
  const int lo = min(Skv, tid * chunk), hi_ = min(Skv, lo + chunk);
  int eq = 0;
  for (int j = lo; j < hi_; ++j) eq += keys[j] == kth;
  int rank = block_exclusive(eq, red);   // also orders s_gt's reset
  for (int j = lo; j < hi_; ++j) {
    const uint32_t k = keys[j];
    const uint64_t word = ((uint64_t)k << 32) | (uint32_t)~(uint32_t)j;
    if (k > kth) {
      cand[atomicAdd(&s_gt, 1)] = word;
    } else if (k == kth) {
      if (rank < need) cand[n_gt + rank] = word;
      ++rank;
    }
  }
  for (int s = K + tid; s < p2; s += kSelThreads) cand[s] = 0ull;
  __syncthreads();

  // bitonic sort, descending
  for (int k = 2; k <= p2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < p2; i += kSelThreads) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const uint64_t a = cand[i], c = cand[ixj];
          if ((i & k) == 0 ? a < c : a > c) {
            cand[i] = c;
            cand[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int s = tid; s < topk; s += kSelThreads)
    out[s] = s < K ? (int)~(uint32_t)cand[s] : -1;
}

}  // namespace

// QI, KI of type code dt (0 float32, 1 bfloat16, 3 float16: ops/gemm.py's
// DTYPE_CODES), W and L float32, all contiguous. Launches on `stream`
// and returns cudaGetLastError() (0 = launched); cudaErrorInvalidValue
// for another type code.
extern "C" int tl_lightning_indexer(const void* qi, const void* ki,
                                    const void* w, void* out, int B, int S,
                                    int Skv, int HI, int DI, int q_offset,
                                    int dt, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  float* of = static_cast<float*>(out);
  switch (dt) {
    case 0:
      return launch_indexer<float>(qi, ki, wf, of, B, S, Skv, HI, DI,
                                   q_offset, st);
    case 1:
      return launch_indexer<__nv_bfloat16>(qi, ki, wf, of, B, S, Skv, HI,
                                           DI, q_offset, st);
    case 3:
      return launch_indexer<__half>(qi, ki, wf, of, B, S, Skv, HI, DI,
                                    q_offset, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// L (rows, Skv) float32 -> I (rows, topk) int32, contiguous. One block a
// row holds its Skv keys (4 bytes each) and the candidates (8 bytes each,
// the power of two at or above min(topk, Skv)) in shared memory; a row
// past 200 KB of them returns cudaErrorInvalidValue (ops/dsa.py's
// SELECTOR_SMEM_BYTES: the wrapper refuses it first).
extern "C" int tl_topk_selector(const void* logits, void* ids, int rows,
                                int Skv, int topk, void* stream) {
  int p2 = 1;
  while (p2 < min(topk, Skv)) p2 <<= 1;
  const size_t bytes = (size_t)p2 * 8 + (size_t)Skv * 4;
  if (bytes > 200 * 1024 || rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      topk_selector, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  topk_selector<<<rows, kSelThreads, bytes,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<int*>(ids), Skv, topk,
      p2);
  return (int)cudaGetLastError();
}
