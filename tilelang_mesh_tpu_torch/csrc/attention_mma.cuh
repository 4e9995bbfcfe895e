// Fragment helpers of the tensor-core attention kernels (gqa_bwd.cu's and
// nsa_bwd.cu's backward pairs, flash_attention.cu's and nsa.cu's
// forwards): bfloat16
// and float16 operands in shared memory, each row padded by kPad
// elements (an odd count of 16-byte chunks, so the 8 rows of an ldmatrix
// hit 8 bank groups), products on mma.sync m16n8k16 with float32 sums.
// In an m16n8
// accumulator lane (g, q2) = (lane / 4, 2 (lane % 4)) holds rows g and
// g + 8, columns q2 and q2 + 1: two n8 tiles are the A fragment of the
// next product's k16 step (to_frags), so a probability tile is rounded
// to the input type in registers and never touches shared memory.

#pragma once

#include "attention_common.cuh"
#include "gemm_tile.cuh"

namespace tl_attn {

namespace mma16 = tl_gemm::bf16;

constexpr int kPad = 8;  // elements of padding a shared row

// two floats rounded to E (bf16 or f16) in one register, `lo` in the low
// half: the operand layout of mma.sync
template <typename E>
__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  if constexpr (std::is_same_v<E, __half>) {
    const __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&h);
  } else {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&h);
  }
}

// rows [r0, r0 + R) of a row-major (S, D) matrix into dst[R][D + kPad]
// by cp.async, 16 bytes a thread, zero past row S
template <int R, int D, typename E>
__device__ __forceinline__ void issue_rows(E* dst, const E* src, int r0,
                                           int S) {
  constexpr int CH = D / 8;
  for (int idx = threadIdx.x; idx < R * CH; idx += kThreads) {
    const int r = idx / CH, c = idx % CH;
    const bool ok = r0 + r < S;
    tl_gemm::cp_async16(dst + r * (D + kPad) + c * 8,
                        ok ? src + (long long)(r0 + r) * D + c * 8 : src,
                        ok);
  }
}

// rows [r0, r0 + R) of a row-strided matrix (row r at src + r * stride,
// D contiguous elements) into dst[R][D + kPad] by cp.async, 16 bytes a
// copy, zero at row r1 and past: a gather from a strided view, no copy;
// issued by the n threads tid = 0 .. n - 1 (the block, or a warp's lanes)
template <int R, int D, typename E>
__device__ __forceinline__ void issue_rows_strided(E* dst, const E* src,
                                                   long long stride, int r0,
                                                   int r1, int tid, int n) {
  constexpr int CH = D / 8;
  for (int idx = tid; idx < R * CH; idx += n) {
    const int r = idx / CH, c = idx % CH;
    const bool ok = r0 + r < r1;
    tl_gemm::cp_async16(dst + r * (D + kPad) + c * 8,
                        ok ? src + (long long)(r0 + r) * stride + c * 8 : src,
                        ok);
  }
}

// rows r < R of two matrices that share their rows (Q and dO, each
// row-major with D elements a row) into dst0, dst1 [R][D + kPad] by
// cp.async, 16 bytes a copy: row r from row at(r) of src0, src1, zero
// where at(r) < 0. A gather of whole rows through a row table (`at`, a
// callable: rows of a group at token offsets); issued by the n threads
// tid = 0 .. n - 1
template <int R, int D, typename E, typename At>
__device__ __forceinline__ void issue_rows_at(E* dst0, const E* src0,
                                              E* dst1, const E* src1, At at,
                                              int tid, int n) {
  constexpr int CH = D / 8;
  for (int idx = tid; idx < R * CH; idx += n) {
    const int r = idx / CH, c = idx % CH;
    const long long a = at(r);
    const bool ok = a >= 0;
    const long long off = (ok ? a * D : 0) + c * 8;
    tl_gemm::cp_async16(dst0 + r * (D + kPad) + c * 8, src0 + off, ok);
    tl_gemm::cp_async16(dst1 + r * (D + kPad) + c * 8, src1 + off, ok);
  }
}

// 4 bytes global -> shared, zero-filled when !ok (src-size 0; `src` is
// then any valid address)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   tl_gemm::smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

// c (+)= a . b over D for 16 rows of A (row-major at `a`) and the N rows
// of B (row-major at `b`, so B^T is the product's k x n operand); N a
// multiple of 16
template <int D, int N, typename E>
__device__ __forceinline__ void rows_dot_rows(float (&c)[N / 8][4],
                                              const E* a, const E* b) {
  constexpr int LD = D + kPad;
  const int lane = threadIdx.x % 32, mat = lane / 8, mr = lane % 8;
#pragma unroll
  for (int ks = 0; ks < D; ks += 16) {
    unsigned af[4];
    mma16::ldmatrix_x4(af, a + (mr + 8 * (mat % 2)) * LD + ks + 8 * (mat / 2));
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      unsigned r[4];
      mma16::ldmatrix_x4(r, b + (np * 16 + mr + 8 * (mat / 2)) * LD + ks +
                                8 * (mat % 2));
      mma16::mma<E>(c[2 * np], af, r[0], r[1]);
      mma16::mma<E>(c[2 * np + 1], af, r[2], r[3]);
    }
  }
}

// max / sum over the 4 lanes of an m16n8 accumulator row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// c += A . B for the A fragments `af` of a 16 x K product (K / 16 k16
// steps) and B the K rows of a row-major (K, D) tile at `b` (read through
// ldmatrix.trans)
template <int D, int K, typename E>
__device__ __forceinline__ void frags_dot_tile(float (&c)[D / 8][4],
                                               const unsigned (&af)[K / 16][4],
                                               const E* b) {
  constexpr int LD = D + kPad;
  const int lane = threadIdx.x % 32, mat = lane / 8, mr = lane % 8;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      unsigned r[4];
      mma16::ldmatrix_x4_trans(r, b + (kk * 16 + mr + 8 * (mat % 2)) * LD +
                                      np * 16 + 8 * (mat / 2));
      mma16::mma<E>(c[2 * np], af[kk], r[0], r[1]);
      mma16::mma<E>(c[2 * np + 1], af[kk], r[2], r[3]);
    }
}

// the A fragments of a 16 x N accumulator (N / 8 n8 tiles): tiles 2 kk
// and 2 kk + 1 are k16 step kk's (a0, a1) and (a2, a3), rounded to E
template <int N, typename E>
__device__ __forceinline__ void to_frags(unsigned (&af)[N / 16][4],
                                         const float (&c)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      af[kk][2 * h] = pack2<E>(c[2 * kk + h][0], c[2 * kk + h][1]);
      af[kk][2 * h + 1] = pack2<E>(c[2 * kk + h][2], c[2 * kk + h][3]);
    }
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
}

// rows r0 + g and r0 + g + 8 (below S) of a (S, D) float32 output from a
// 16 x D accumulator
template <int D>
__device__ __forceinline__ void store_rows(float* out,
                                           const float (&c)[D / 8][4],
                                           int r0, int S) {
  const int lane = threadIdx.x % 32, g = lane / 4, q2 = (lane % 4) * 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    if (r >= S) continue;
    float* row = out + (long long)r * D + q2;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<float2*>(row + 8 * nt) =
          make_float2(c[nt][2 * h], c[nt][2 * h + 1]);
  }
}

}  // namespace tl_attn
