// Per-token int8 activation quantiser for Hopper (sm_90a).
//
// Replaces the TPU kernel of tilelang_mesh_tpu/quantize/quantization.py:
//   quantize_act_int8_kernel (:72) -> tl_quantize_act_int8
//     X (M, K) float32 -> Q (M, K) int8, S (M, 1) float32 with
//     S = max(absmax of the row, 1e-8) * float32(1/127)   (the dequant
//     scale, as the JAX kernel computes it: XLA turns its divide by the
//     constant 127 into a multiply by the rounded reciprocal)
//     Q = clamp(rint(x / S), -127, 127)   (an IEEE divide, round half to
//     even; S >= 1e-8 / 127 keeps an all-zero row at Q = 0, S finite)
//   The plain version (ops/quantize_act.py) computes the same bytes.
//
// Bound: bytes. Each element is read once (4 bytes) and written once
// (1 byte), one float a row more: at 4096 x 6912 that is 141.6 MB, 42 us
// at 3.35 TB/s; the arithmetic is a few operations a byte.
//
// Design: one block of 256 threads a row, the TPU's (block_M rows, K)
// tile turned into one row a block so that 4096 rows fill the card.
// Pass 1 reads the row (16-byte loads where the row starts on 16 bytes
// and K is a multiple of 4) and reduces |x| to its maximum with warp
// shuffles and one shared word a warp; pass 2 reads the row again (from
// L1/L2: a row is at most tens of KB) and writes four codes a thread as
// one 32-bit word where it can. The row is not kept in registers or
// shared memory, so any K works with one block size.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// the row's absmax, known to every thread of the block
__device__ __forceinline__ float block_max(float x) {
  __shared__ float part[kWarps];
  x = warp_max(x);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = x;
  __syncthreads();
  x = threadIdx.x < kWarps ? part[threadIdx.x] : 0.f;
  if (threadIdx.x < 32) x = warp_max(x);
  __shared__ float total;
  if (threadIdx.x == 0) total = x;
  __syncthreads();
  return total;
}

__device__ __forceinline__ int code(float x, float s) {
  return (int)fminf(fmaxf(rintf(__fdiv_rn(x, s)), -127.f), 127.f);
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
quantize_act(const float* __restrict__ x, int8_t* __restrict__ q,
             float* __restrict__ s, int K) {
  const long long row = blockIdx.x;
  const float* xr = x + row * K;
  int8_t* qr = q + row * K;
  float amax = 0.f;
  if (VEC) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    for (int i = threadIdx.x; i < K / 4; i += kThreads) {
      const float4 v = x4[i];
      amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                               fmaxf(fabsf(v.z), fabsf(v.w))));
    }
  } else {
    for (int i = threadIdx.x; i < K; i += kThreads)
      amax = fmaxf(amax, fabsf(xr[i]));
  }
  const float sc = fmaxf(block_max(amax), 1e-8f) * (1.0f / 127.0f);
  if (threadIdx.x == 0) s[row] = sc;
  if (VEC) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    uint32_t* q4 = reinterpret_cast<uint32_t*>(qr);
    for (int i = threadIdx.x; i < K / 4; i += kThreads) {
      const float4 v = x4[i];
      q4[i] = (uint32_t)(code(v.x, sc) & 0xFF) |
              (uint32_t)(code(v.y, sc) & 0xFF) << 8 |
              (uint32_t)(code(v.z, sc) & 0xFF) << 16 |
              (uint32_t)(code(v.w, sc) & 0xFF) << 24;
    }
  } else {
    for (int i = threadIdx.x; i < K; i += kThreads)
      qr[i] = (int8_t)code(xr[i], sc);
  }
}

}  // namespace

// x (M, K) float32 -> q (M, K) int8, s (M,) float32. Launches on
// `stream` and returns cudaGetLastError() (0 = launched); the Python
// wrapper checks shapes, types, devices and M >= 1, K >= 1 before
// calling.
extern "C" int tl_quantize_act_int8(const float* x, int8_t* q, float* s,
                                    int M, int K, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 4 == 0;
  if (vec)
    quantize_act<true><<<M, kThreads, 0, st>>>(x, q, s, K);
  else
    quantize_act<false><<<M, kThreads, 0, st>>>(x, q, s, K);
  return (int)cudaGetLastError();
}
