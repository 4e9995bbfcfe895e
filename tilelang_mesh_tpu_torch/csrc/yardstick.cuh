// Small device wrappers of the two yardstick kernels (yardstick_gemm.cu,
// yardstick_w4a16.cu): cp.async, ldmatrix, the mma.sync products they
// use, the epilogue's rounding store and the launch with opt-in shared
// memory. The yardsticks keep their own tile loops: they exist to time
// the library's GEMMs (gemm_tile.cuh) against an independent kernel.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace yardstick {

constexpr int kThreads = 256;

// element types by the codes the launchers take (ops/gemm.py DTYPE_CODES)
enum DType { kF32 = 0, kBF16 = 1, kFP8 = 2, kF16 = 3 };

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared (both 16-byte aligned)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The (R x W) elements at (row 0, col c0) of a row-major matrix with row
// stride ld, into dst[R][LD] of shared memory, 16 bytes a cp.async.
template <typename T, int R, int W, int LD>
__device__ __forceinline__ void copy_tile(T* dst, const T* src,
                                          long long ld) {
  constexpr int V = 16 / sizeof(T);
  for (int i = threadIdx.x; i < R * W / V; i += kThreads) {
    const int r = i / (W / V), c = (i % (W / V)) * V;
    cp_async16(dst + r * LD + c, src + r * ld + c);
  }
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a b, one m16n8k16 tile of 16-bit E (bf16 or f16), f32 sums
template <typename E>
__device__ __forceinline__ void mma16(float (&c)[4], const unsigned (&a)[4],
                                      unsigned b0, unsigned b1) {
  if constexpr (std::is_same_v<E, __half>)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b, one m16n8k32 tile of fp8 e4m3 operands, f32 sums
__device__ __forceinline__ void mma_e4m3(float (&c)[4],
                                         const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[at] = x rounded once, to nearest even, to the float type `type`; an
// e4m3 value past +-448 (|x| > 464, or infinite) is NaN, as the JAX
// package's cast gives it (e4m3 has no infinity)
__device__ __forceinline__ void store_as(void* c, long long at, int type,
                                         float x) {
  if (type == kF32)
    static_cast<float*>(c)[at] = x;
  else if (type == kBF16)
    static_cast<__nv_bfloat16*>(c)[at] = __float2bfloat16_rn(x);
  else if (type == kF16)
    static_cast<__half*>(c)[at] = __float2half_rn(x);
  else
    static_cast<__nv_fp8_e4m3*>(c)[at].__x =
        __nv_cvt_float_to_fp8(x, __NV_NOSAT, __NV_E4M3);
}

// kern<<<grid, kThreads, smem, s>>>(args...) with `smem` bytes of
// dynamic shared memory opted into; returns cudaGetLastError()
template <typename... P, typename... A>
int launch(void (*kern)(P...), int smem, dim3 grid, cudaStream_t s,
           A... args) {
  const cudaError_t e = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kern),
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, kThreads, smem, s>>>(static_cast<P>(args)...);
  return (int)cudaGetLastError();
}

}  // namespace yardstick
