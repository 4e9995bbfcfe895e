// The GEMM for Hopper (sm_90a): C = op(A) @ op(B), optional ReLU.
//
// Replaces one TPU kernel of tilelang_mesh_tpu/ops/gemm.py:
//   matmul_kernel (:18) -> tl_matmul
//     A (M, K), or (K, M) when trans_a; B (K, N), or (N, K) when
//     trans_b; C (M, N). Float inputs (float32, bfloat16, float16 or
//     float8 e4m3, both the same) are accumulated in float32 (no TF32),
//     ReLU on the accumulator, then rounded once to C's type: float32,
//     bfloat16, float16 or float8 e4m3 (round to nearest even; NaN past
//     e4m3's range, as the JAX package casts). int8 inputs are
//     gemm_s8.cu's.
//
// One block a 128 x 128 tile of C (gemm_dense.cuh: a one-dimensional
// grid in tile_of's grouped raster) on the block tile loop of
// gemm_tile.cuh: FFMA for float32, mma.sync m16n8k16 for bfloat16 and
// float16, fp8 widened exactly to bf16 in shared memory on the same mma
// path.
//
// Bound: operations at the shapes the library is run at. 8192 x 8192 x
// 4096 in bf16 does 2 M N K = 550 GFLOP on 201 MB, 2730 flops a byte,
// above the card's balance point in every type (bf16 989 TFLOP/s
// against 3.35 TB/s: 295 a byte; float32 on CUDA cores 67 TFLOP/s: 20).
// Design against it: a 128 x 128 block tile, operands staged by cp.async
// one K-tile ahead; wgmma and TMA are later work.

#include "gemm_dense.cuh"

namespace {

using namespace tl_gemm;

template <bool TA, bool TB>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
matmul_f32(const float* __restrict__ a, const float* __restrict__ b,
           void* __restrict__ c, int M, int N, int K, int out, int relu,
           int vec) {
  const DenseBlock k(M, N, K, TA);
  const f32::Direct<TA, TB> src{a + k.a_off, b, k.lda, k.rows, k.n0, K, N,
                                vec != 0};
  f32::Acc acc;
  f32::loop<TA, TB>(src, (K + f32::BK - 1) / f32::BK, acc);
  f32::for_each<TA, TB>(acc, DenseEpilogue{c, k.rows, k.m0, k.n0, N, out, relu});
}

// T: __nv_bfloat16 or __half
template <typename T, bool TA, bool TB>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
matmul_h16(const T* __restrict__ a, const T* __restrict__ b,
           void* __restrict__ c, int M, int N, int K, int out, int relu,
           int vec) {
  const DenseBlock k(M, N, K, TA);
  const Direct<T, bf16::BK, bf16::PAD, TA, TB> src{
      a + k.a_off, b, k.lda, k.rows, k.n0, K, N, vec != 0};
  bf16::Acc<float> acc;
  bf16::loop<TA, TB>(src, (K + bf16::BK - 1) / bf16::BK, acc);
  bf16::for_each(acc, DenseEpilogue{c, k.rows, k.m0, k.n0, N, out, relu});
}

template <bool TA, bool TB>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
matmul_fp8(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
           void* __restrict__ c, int M, int N, int K, int out, int relu,
           int vec) {
  const DenseBlock k(M, N, K, TA);
  const bf16::Fp8<TA, TB> src{a + k.a_off, b, k.lda, k.rows, k.n0, K, N,
                              vec != 0};
  bf16::Acc<float> acc;
  bf16::loop<TA, TB>(src, (K + bf16::BK - 1) / bf16::BK, acc);
  bf16::for_each(acc, DenseEpilogue{c, k.rows, k.m0, k.n0, N, out, relu});
}

// T: float, __nv_bfloat16, __half or uint8_t (fp8 e4m3)
template <typename T, bool TA, bool TB>
int launch(const void* a, const void* b, void* c, int M, int N, int K,
           int out, int relu, int vec, unsigned blocks, cudaStream_t s) {
  const auto* pa = static_cast<const T*>(a);
  const auto* pb = static_cast<const T*>(b);
  if constexpr (std::is_same_v<T, float>) {
    matmul_f32<TA, TB><<<blocks, kThreads, 0, s>>>(pa, pb, c, M, N, K, out,
                                                   relu, vec);
  } else if constexpr (sizeof(T) == 2) {
    matmul_h16<T, TA, TB><<<blocks, kThreads, 0, s>>>(pa, pb, c, M, N, K,
                                                      out, relu, vec);
  } else {
    matmul_fp8<TA, TB><<<blocks, kThreads, 0, s>>>(pa, pb, c, M, N, K, out,
                                                   relu, vec);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* a, const void* b, void* c, int M, int N, int K,
             int ta, int tb, int out, int relu, int vec, unsigned blocks,
             cudaStream_t s) {
  if (ta)
    return tb ? launch<T, true, true>(a, b, c, M, N, K, out, relu, vec,
                                      blocks, s)
              : launch<T, true, false>(a, b, c, M, N, K, out, relu, vec,
                                       blocks, s);
  return tb ? launch<T, false, true>(a, b, c, M, N, K, out, relu, vec,
                                     blocks, s)
            : launch<T, false, false>(a, b, c, M, N, K, out, relu, vec,
                                      blocks, s);
}

}  // namespace

// in_type, out_type: DType codes (gemm_tile.cuh): kF32, kBF16, kFP8 or
// kF16.
// Launches on `stream` and returns cudaGetLastError() (0 = launched);
// the Python wrapper checks shapes, types, devices and the grid's range
// before calling.
extern "C" int tl_matmul(const void* a, const void* b, void* c, int M,
                         int N, int K, int in_type, int trans_a, int trans_b,
                         int out_type, int relu, void* stream) {
  const unsigned blocks = tile_count(M, N);
  const int esize = in_type == kF32 ? 4
                    : in_type == kBF16 || in_type == kF16 ? 2 : 1;
  const int vec = dense_vec(a, b, M, N, K, trans_a, trans_b, esize);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (in_type) {
    case kF32:
      return dispatch<float>(a, b, c, M, N, K, trans_a, trans_b, out_type,
                             relu, vec, blocks, s);
    case kBF16:
      return dispatch<__nv_bfloat16>(a, b, c, M, N, K, trans_a, trans_b,
                                     out_type, relu, vec, blocks, s);
    case kF16:
      return dispatch<__half>(a, b, c, M, N, K, trans_a, trans_b, out_type,
                              relu, vec, blocks, s);
    default:
      return dispatch<uint8_t>(a, b, c, M, N, K, trans_a, trans_b, out_type,
                               relu, vec, blocks, s);
  }
}
