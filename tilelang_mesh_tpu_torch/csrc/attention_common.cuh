// Shared pieces of the attention kernels (flash_attention.cu, gqa_bwd.cu).
//
// Every kernel runs 128 threads as a 16 x 8 grid: `ty` (0..15) picks
// rows, `tx` (0..7) columns. A thread owns rows ty + 16*a and columns
// tx + 8*c of each tile it computes, so the 8 lanes of one row group sit
// in one warp (lane bits 0-2 are tx) and a row reduction is three
// shuffles. Tiles live in shared memory as float32 with an odd row
// stride (width + 1): a column read by 8 lanes at stride `width + 1` and
// a row read by 8 lanes at stride 1 both hit 8 distinct banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace tl_attn {

constexpr int kThreads = 128;
constexpr int kTy = 16;
constexpr int kTx = 8;
constexpr unsigned kFull = 0xffffffffu;

// Element types of the inputs, by the codes the Python wrappers pass
// (ops/gemm.py's DTYPE_CODES, as gemm_tile.cuh's DType); the arithmetic
// is float32 for all three.
constexpr int kF32 = 0, kBF16 = 1, kF16 = 3;

template <int DT>
struct Elem;

template <>
struct Elem<kF32> {
  using T = float;
  static __device__ __forceinline__ float load(const T* p, long long i) {
    return p[i];
  }
  static __device__ __forceinline__ void store(T* p, long long i, float x) {
    p[i] = x;
  }
  // the value the JAX kernel keeps when it casts to the input dtype
  static __device__ __forceinline__ float round(float x) { return x; }
};

template <>
struct Elem<kBF16> {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ float load(const T* p, long long i) {
    return __bfloat162float(p[i]);
  }
  static __device__ __forceinline__ void store(T* p, long long i, float x) {
    p[i] = __float2bfloat16_rn(x);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

template <>
struct Elem<kF16> {
  using T = __half;
  static __device__ __forceinline__ float load(const T* p, long long i) {
    return __half2float(p[i]);
  }
  static __device__ __forceinline__ void store(T* p, long long i, float x) {
    p[i] = __float2half_rn(x);
  }
  static __device__ __forceinline__ float round(float x) {
    return __half2float(__float2half_rn(x));
  }
};

template <int DT>
using elem_t = std::integral_constant<int, DT>;

// f(elem_t<DT>{}) for the runtime code `dt`; cudaErrorInvalidValue for
// a code without an instance. A launcher instantiates its kernels
// through it: [&](auto e) { return run<D, decltype(e)::value>(...); }.
template <class F>
int with_elem(int dt, F f) {
  switch (dt) {
    case kF32:
      return f(elem_t<kF32>{});
    case kBF16:
      return f(elem_t<kBF16>{});
    case kF16:
      return f(elem_t<kF16>{});
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// rows [r0, r0 + R) of a row-major (S, D) matrix into the tile
// dst[R][D + 1] as float32, times `scale` and rounded to the input type
// when SCALE, zero past row S. Consecutive threads take consecutive
// columns: coalesced reads, conflict-free shared stores.
template <int R, int D, int DT, bool SCALE = false>
__device__ __forceinline__ void load_tile(float* dst,
                                          const typename Elem<DT>::T* src,
                                          int r0, int S, float scale = 1.f) {
  constexpr int LD = D + 1;
  for (int idx = threadIdx.x; idx < R * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    float x = 0.f;
    if (r0 + r < S) {
      x = Elem<DT>::load(src, (long long)(r0 + r) * D + c);
      if (SCALE) x = Elem<DT>::round(x * scale);
    }
    dst[r * LD + c] = x;
  }
}

// entries [r0, r0 + R) of a float32 vector of length S, zero past S
template <int R>
__device__ __forceinline__ void load_vec(float* dst, const float* src, int r0,
                                         int S) {
  for (int i = threadIdx.x; i < R; i += kThreads)
    dst[i] = r0 + i < S ? src[r0 + i] : 0.f;
}

// sum / max over the 8 lanes of a row group
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = kTx / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(kFull, x, off);
  return x;
}

__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = kTx / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

// Allows `bytes` of dynamic shared memory for `kernel` and launches it
// on `stream`; returns the first CUDA error (0 = launched).
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, size_t bytes, cudaStream_t stream,
           Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, bytes, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace tl_attn
