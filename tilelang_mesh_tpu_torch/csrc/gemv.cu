// GEMV for Hopper (sm_90a): c = B @ a.
//
// Replaces one TPU kernel of tilelang_mesh_tpu/ops/gemm_variants.py:
//   gemv_kernel (:169) -> tl_gemv
//     a (K,), B (N, K) row-major, both float32, bfloat16 or float16; c (N,)
//     in float32, bfloat16, float16 or float8 e4m3 (gemm_tile.cuh's
//     rounding): c[n] = sum_k B[n, k] a[k], products and sums in float32.
//
// Bound: bytes. Every element of B is read once and used once (2 flops a
// 2-byte element, far below the card's 295 a byte), so the kernel is a
// stream over B at the memory's rate: at LLaMA-2-7B's MLP (N 11008, K
// 4096, bf16) 90.2 MB, 27 us; its LM head (N 32000) 262 MB, 78 us.
// Design against it: no tensor cores. A warp owns kRows rows of B and
// reads them along K, 16 bytes a lane (kRows loads in flight an
// iteration, unrolled), against `a` staged in shared memory a chunk of
// 16 KB at a time; each lane keeps float32 partial sums, a warp shuffle
// reduces them. Where K * size is no multiple of 16 bytes (rows then do
// not start on 16 bytes) or a tensor is misaligned, lanes read one
// element at a time: correct for any K, at a fraction of the rate.

#include "gemm_tile.cuh"

namespace {

using tl_gemm::store_as;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 2;                      // rows of B a warp
constexpr int kChunkBytes = 16 * 1024;        // of `a` in shared memory

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

// sum of the products of the 16 bytes at w and x as T elements
__device__ __forceinline__ float dot16(const uint4& w, const uint4& x,
                                       const float*) {
  return __uint_as_float(w.x) * __uint_as_float(x.x) +
         __uint_as_float(w.y) * __uint_as_float(x.y) +
         __uint_as_float(w.z) * __uint_as_float(x.z) +
         __uint_as_float(w.w) * __uint_as_float(x.w);
}
template <typename H2, typename F>
__device__ __forceinline__ float dot16_h(const uint4& w, const uint4& x,
                                         F widen) {
  const H2* p = reinterpret_cast<const H2*>(&w);
  const H2* q = reinterpret_cast<const H2*>(&x);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = widen(p[i]), v = widen(q[i]);
    s = fmaf(u.x, v.x, s);
    s = fmaf(u.y, v.y, s);
  }
  return s;
}
__device__ __forceinline__ float dot16(const uint4& w, const uint4& x,
                                       const __nv_bfloat16*) {
  return dot16_h<__nv_bfloat162>(
      w, x, [](__nv_bfloat162 h) { return __bfloat1622float2(h); });
}
__device__ __forceinline__ float dot16(const uint4& w, const uint4& x,
                                       const __half*) {
  return dot16_h<__half2>(w, x,
                          [](__half2 h) { return __half22float2(h); });
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
gemv(const T* __restrict__ a, const T* __restrict__ b, void* __restrict__ c,
     int N, int K, int out) {
  constexpr int KC = kChunkBytes / sizeof(T);  // elements of a a chunk
  constexpr int V = 16 / sizeof(T);            // elements in 16 bytes
  __shared__ __align__(16) T a_s[KC];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = (blockIdx.x * kWarps + warp) * kRows;
  // rows past N read row N - 1 and are not stored
  const T* rows[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    rows[r] = b + (long long)min(n0 + r, N - 1) * K;
  float acc[kRows] = {};

  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kc = min(KC, K - k0);
    __syncthreads();                   // the last chunk's readers are done
    if (VEC) {
      for (int i = threadIdx.x * V; i < kc; i += kThreads * V)
        *reinterpret_cast<uint4*>(a_s + i) =
            *reinterpret_cast<const uint4*>(a + k0 + i);
    } else {
      for (int i = threadIdx.x; i < kc; i += kThreads) a_s[i] = a[k0 + i];
    }
    __syncthreads();
    if (VEC) {
#pragma unroll 4
      for (int i = lane * V; i < kc; i += 32 * V) {
        const uint4 x = *reinterpret_cast<const uint4*>(a_s + i);
        uint4 w[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          w[r] = __ldg(reinterpret_cast<const uint4*>(rows[r] + k0 + i));
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          acc[r] += dot16(w[r], x, static_cast<const T*>(nullptr));
      }
    } else {
      for (int i = lane; i < kc; i += 32) {
        const float x = to_f(a_s[i]);
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          acc[r] = fmaf(to_f(rows[r][k0 + i]), x, acc[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float v = acc[r];
#pragma unroll
    for (int o = 16; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0 && n0 + r < N) store_as(c, n0 + r, out, v);
  }
}

template <typename T>
void launch(const void* a, const void* b, void* c, int N, int K, int out,
            cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0 && K % V == 0;
  const unsigned blocks = (unsigned)((N + kWarps * kRows - 1) /
                                     (kWarps * kRows));
  const auto* pa = static_cast<const T*>(a);
  const auto* pb = static_cast<const T*>(b);
  if (vec)
    gemv<T, true><<<blocks, kThreads, 0, s>>>(pa, pb, c, N, K, out);
  else
    gemv<T, false><<<blocks, kThreads, 0, s>>>(pa, pb, c, N, K, out);
}

}  // namespace

// a (K,), b (N, K) of in_type (kF32, kBF16 or kF16: gemm_tile.cuh DType)
// -> c (N,) of out_type (kF32, kBF16, kF16 or kFP8). Launches on
// `stream` and returns cudaGetLastError() (0 = launched); the Python
// wrapper checks shapes, types and devices before calling.
extern "C" int tl_gemv(const void* a, const void* b, void* c, int N, int K,
                       int in_type, int out_type, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (in_type == tl_gemm::kF32)
    launch<float>(a, b, c, N, K, out_type, s);
  else if (in_type == tl_gemm::kBF16)
    launch<__nv_bfloat16>(a, b, c, N, K, out_type, s);
  else
    launch<__half>(a, b, c, N, K, out_type, s);
  return (int)cudaGetLastError();
}
