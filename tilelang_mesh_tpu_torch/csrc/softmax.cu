// Row softmax of a 2-D array, for Hopper (sm_90a).
//
// Replaces the TPU kernel of tilelang_mesh_tpu/ops/softmax.py:
//   softmax_kernel (:29) -> tl_softmax
// Same contract:
//   X (M, N) float32, bfloat16 or float16, contiguous; Y (M, N) in the
//   output type (float32, bfloat16 or float16, the input's by default).
//   In float32 and the exp2 domain: m = rowmax(x);
//   y = exp2((x - m) * log2e) / sum_j exp2((x_j - m) * log2e).
//   A row that is all -inf, or holds +inf (or NaN), is NaN throughout, as
//   the TPU kernel's (x - m) makes it there.
//
// Bound: bytes. Each element is read once and written once, a few
// flops apiece, far below the card's balance point: the least time is
// M * N * (in + out bytes) over the memory rate.
//
// Design: the TPU kernel holds block_M whole rows in VMEM; a vocabulary
// row (N 201088, 786 KB in float32) fits in no block's 227 KB of shared
// memory. So each thread keeps an online (max, sum) over its strided
// share of the row in one read (the sum rescaled only when its max
// grows), the threads merge theirs with warp shuffles, and a second pass
// writes exp2((x - m) * log2e) / l. Two shapes:
//   * N <= 1024: one warp a row, eight rows a block; the second pass
//     re-reads the row from L1;
//   * wider: one block of 1024 threads a row. The row's first `cap`
//     elements are kept in shared memory as float32 as they are read
//     (each thread keeps, and later reads back, only its own elements,
//     so no barrier guards them): a row of up to 48K elements is read
//     from device memory once, a wider one re-reads its tail.
// No tensor cores and no TMA: plain coalesced loads, eight in flight a
// thread in each pass (one in flight left the second pass latency-bound:
// scripts/softmax_ab.py).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpRows = 8;         // rows a block in the narrow kernel
constexpr int kNarrowMax = 1024;     // widest row of the narrow kernel
constexpr int kThreads = 1024;       // threads a block in the wide kernel
constexpr int kStashMax = 48 * 1024; // float32 elements kept in shared
constexpr int kRed = 72;             // reduction slots before the stash
constexpr int kUnroll = 8;           // loads in flight a thread, each pass

__device__ __forceinline__ float ld(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float ld(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float ld(const __half* p, long long i) {
  return __half2float(p[i]);
}
__device__ __forceinline__ void st(float* p, long long i, float x) {
  p[i] = x;
}
__device__ __forceinline__ void st(__nv_bfloat16* p, long long i, float x) {
  p[i] = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void st(__half* p, long long i, float x) {
  p[i] = __float2half_rn(x);
}

// One element into a thread's running (m, l), l = sum exp2((x - m) c).
// Rescales only when the max grows. A +inf (or NaN) makes l NaN, as the
// TPU kernel's (inf - inf) does; a -inf adds nothing (and an all -inf
// row keeps m = -inf, l = 0, so the second pass gives NaN).
__device__ __forceinline__ void add(float& m, float& l, float x) {
  if (x > m) {
    l = fmaf(l, exp2f((m - x) * kLog2e), 1.f);
    m = x;
    if (x == INFINITY) l = NAN;
  } else if (x != -INFINITY) {
    l += exp2f((x - m) * kLog2e);
  }
}

// (m, l) <- the merge of two running pairs
__device__ __forceinline__ void merge(float& m, float& l, float m2,
                                      float l2) {
  const float mn = fmaxf(m, m2);
  const float a = m == -INFINITY ? 0.f : l * exp2f((m - mn) * kLog2e);
  const float b = m2 == -INFINITY ? 0.f : l2 * exp2f((m2 - mn) * kLog2e);
  m = mn;
  l = a + b;
}

__device__ __forceinline__ void warp_merge(float& m, float& l) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(kFull, m, off);
    const float l2 = __shfl_xor_sync(kFull, l, off);
    merge(m, l, m2, l2);
  }
}

__device__ __forceinline__ float prob(float x, float m, float l) {
  return exp2f((x - m) * kLog2e) / l;
}

template <typename TI, typename TO>
__global__ void __launch_bounds__(32 * kWarpRows)
softmax_warp_rows(const TI* __restrict__ x, TO* __restrict__ y, int M,
                  int N) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarpRows + threadIdx.x / 32;
  if (row >= M) return;  // the whole warp: `row` is the warp's
  const TI* xr = x + row * N;
  TO* yr = y + row * N;
  float m = -INFINITY, l = 0.f;
  for (int j = lane; j < N; j += 32) add(m, l, ld(xr, j));
  warp_merge(m, l);
  // lane 0's merge for every lane: one l for the whole row
  m = __shfl_sync(kFull, m, 0);
  l = __shfl_sync(kFull, l, 0);
  for (int j = lane; j < N; j += 32) st(yr, j, prob(ld(xr, j), m, l));
}

template <typename TI, typename TO>
__global__ void __launch_bounds__(kThreads)
softmax_block_rows(const TI* __restrict__ x, TO* __restrict__ y, int N,
                   int cap) {
  extern __shared__ float smem[];
  float* red = smem;          // [32][2] per warp, then the row's (m, l)
  float* stash = smem + kRed;  // [cap] the row's first elements, float32
  const int t = threadIdx.x, lane = t & 31, w = t / 32;
  const long long row = blockIdx.x;
  const TI* xr = x + row * N;
  TO* yr = y + row * N;

  float m = -INFINITY, l = 0.f;
  int j = t;
  for (; j + (kUnroll - 1) * kThreads < N; j += kUnroll * kThreads) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = ld(xr, j + u * kThreads);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j + u * kThreads < cap) stash[j + u * kThreads] = v[u];
      add(m, l, v[u]);
    }
  }
  for (; j < N; j += kThreads) {
    const float v = ld(xr, j);
    if (j < cap) stash[j] = v;
    add(m, l, v);
  }

  warp_merge(m, l);
  if (lane == 0) {
    red[2 * w] = m;
    red[2 * w + 1] = l;
  }
  __syncthreads();
  if (w == 0) {
    m = lane < kThreads / 32 ? red[2 * lane] : -INFINITY;
    l = lane < kThreads / 32 ? red[2 * lane + 1] : 0.f;
    warp_merge(m, l);
    if (lane == 0) {
      red[64] = m;
      red[65] = l;
    }
  }
  __syncthreads();
  m = red[64];
  l = red[65];

  for (j = t; j + (kUnroll - 1) * kThreads < N; j += kUnroll * kThreads) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = j + u * kThreads;
      v[u] = i < cap ? stash[i] : ld(xr, i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      st(yr, j + u * kThreads, prob(v[u], m, l));
  }
  for (; j < N; j += kThreads) {
    const float v = j < cap ? stash[j] : ld(xr, j);
    st(yr, j, prob(v, m, l));
  }
}

template <typename TI, typename TO>
int run(const void* x, void* y, int M, int N, cudaStream_t stream) {
  const TI* xi = static_cast<const TI*>(x);
  TO* yo = static_cast<TO*>(y);
  if (N <= kNarrowMax) {
    const int blocks = (M + kWarpRows - 1) / kWarpRows;
    softmax_warp_rows<TI, TO><<<blocks, 32 * kWarpRows, 0, stream>>>(
        xi, yo, M, N);
    return (int)cudaGetLastError();
  }
  const int cap = N < kStashMax ? N : kStashMax;
  const size_t bytes = sizeof(float) * (kRed + (size_t)cap);
  cudaError_t err = cudaFuncSetAttribute(
      softmax_block_rows<TI, TO>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  softmax_block_rows<TI, TO><<<M, kThreads, bytes, stream>>>(xi, yo, N, cap);
  return (int)cudaGetLastError();
}

template <typename TI>
int run_out(int out_code, const void* x, void* y, int M, int N,
            cudaStream_t st) {
  switch (out_code) {
    case 0:
      return run<TI, float>(x, y, M, N, st);
    case 1:
      return run<TI, __nv_bfloat16>(x, y, M, N, st);
    case 2:
      return run<TI, __half>(x, y, M, N, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches on `stream`; returns the first CUDA error (0 = launched), or
// cudaErrorInvalidValue for a type code outside 0 float32, 1 bfloat16,
// 2 float16. The Python wrapper checks shapes, types and contiguity.
extern "C" int tl_softmax(const void* x, void* y, int M, int N, int in_code,
                          int out_code, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (in_code) {
    case 0:
      return run_out<float>(out_code, x, y, M, N, st);
    case 1:
      return run_out<__nv_bfloat16>(out_code, x, y, M, N, st);
    case 2:
      return run_out<__half>(out_code, x, y, M, N, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
