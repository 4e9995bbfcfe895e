// The float32 GEMM tile on the CUDA cores (FFMA, no TF32) that
// yardstick_gemm.cu (#42's f32 instances) and gemm.cu (#15's f32 path)
// share: C (M, N) = A (M, K) @ B (K, N), all row-major float32, one
// block of 256 threads a (BM, BN) tile, K in steps of BK, operand tiles
// staged by cp.async in two stages (16 bytes a copy: bases and rows on
// 16 bytes), each thread a (BM/16) x (BN/16) register tile. The block
// (a TL_SM90_BLOCKS entry) must divide M, N and K; the callers check.
//
// Bound: operations (4096^3 does 137 GFLOP against 67 TFLOP/s of FFMA,
// 2.05 ms; 201 MB at 3.35 TB/s is 0.06 ms).

#pragma once

#include "gemm_sm90.cuh"
#include "yardstick.cuh"

namespace tl_ffma {

using namespace yardstick;

template <int BM, int BN, int BK>
struct F32 {
  static constexpr int LDA = BK + 4;           // k-contiguous A rows
  static constexpr int LDB = BN + 4;
  static constexpr int A_ELEMS = BM * LDA;
  static constexpr int B_ELEMS = BK * LDB;
  static constexpr int SMEM = 2 * (A_ELEMS + B_ELEMS) * 4;
};

// Thread (ty, tx) of a 16 x 16 grid owns rows ty + 16 i (i < BM / 16)
// and the column runs tx * 4 + 64 j (j < BN / 64) of four. ReLU on the
// accumulator when relu (NaN stays NaN).
template <int BM, int BN, int BK>
__global__ void __launch_bounds__(kThreads, 1)
gemm_f32(const float* __restrict__ a, const float* __restrict__ b,
         float* __restrict__ c, int N, int K, int relu) {
  using L = F32<BM, BN, BK>;
  constexpr int TM = BM / 16, TJ = BN / 64;
  extern __shared__ __align__(16) char smem[];
  float* sA = reinterpret_cast<float*>(smem);  // [2][BM][LDA]
  float* sB = sA + 2 * L::A_ELEMS;             // [2][BK][LDB]
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const float* ag = a + (long long)m0 * K;
  const float* bg = b + n0;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  auto load_stage = [&](int stage, int kt) {
    copy_tile<float, BM, BK, L::LDA>(sA + stage * L::A_ELEMS, ag + kt * BK,
                                     K);
    copy_tile<float, BK, BN, L::LDB>(sB + stage * L::B_ELEMS,
                                     bg + (long long)kt * BK * N, N);
  };

  float acc[TM][TJ][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = K / BK;
  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load_stage((kt + 1) & 1, kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* As = sA + (kt & 1) * L::A_ELEMS;
    const float* Bs = sB + (kt & 1) * L::B_ELEMS;
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      float av[TM];
      float4 bv[TJ];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[(ty + 16 * i) * L::LDA + k];
#pragma unroll
      for (int j = 0; j < TJ; ++j)
        bv[j] = *reinterpret_cast<const float4*>(Bs + k * L::LDB + tx * 4 +
                                                 64 * j);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TJ; ++j) {
          acc[i][j][0] = fmaf(av[i], bv[j].x, acc[i][j][0]);
          acc[i][j][1] = fmaf(av[i], bv[j].y, acc[i][j][1]);
          acc[i][j][2] = fmaf(av[i], bv[j].z, acc[i][j][2]);
          acc[i][j][3] = fmaf(av[i], bv[j].w, acc[i][j][3]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TJ; ++j) {
      if (relu)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (acc[i][j][e] < 0.f) acc[i][j][e] = 0.f;
      *reinterpret_cast<float4*>(c + (long long)(m0 + ty + 16 * i) * N + n0 +
                                 tx * 4 + 64 * j) =
          make_float4(acc[i][j][0], acc[i][j][1], acc[i][j][2],
                      acc[i][j][3]);
    }
}

template <int BM, int BN, int BK>
int launch_f32(const void* a, const void* b, void* c, int M, int N, int K,
               int relu, cudaStream_t s) {
  return launch(gemm_f32<BM, BN, BK>, F32<BM, BN, BK>::SMEM,
                dim3(N / BN, M / BM), s, a, b, c, N, K, relu);
}

// launch_f32 at the block (bm, bn, bk) of TL_SM90_BLOCKS;
// cudaErrorInvalidValue for another
inline int dispatch_f32(const void* a, const void* b, void* c, int M, int N,
                        int K, int relu, int bm, int bn, int bk,
                        cudaStream_t s) {
#define TL_FFMA_CASE(m, n, k) \
  if (bm == m && bn == n && bk == k) \
    return launch_f32<m, n, k>(a, b, c, M, N, K, relu, s);
  TL_SM90_BLOCKS(TL_FFMA_CASE)
#undef TL_FFMA_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace tl_ffma
