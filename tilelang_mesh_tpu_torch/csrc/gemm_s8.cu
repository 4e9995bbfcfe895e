// The exact int8 GEMM for Hopper (sm_90a): C (int32) = op(A) @ op(B).
//
// Replaces one case of tilelang_mesh_tpu/ops/gemm.py's TPU kernel:
//   matmul_kernel (:18) with in_dtype "int8", accum_dtype and out_dtype
//   "int32" -> tl_matmul_s8
//     A (M, K) int8, or (K, M) when trans_a; B (K, N), or (N, K) when
//     trans_b; C (M, N) int32 = the exact sums, ReLU optional.
//
// One block a 128 x 128 tile of C (gemm_dense.cuh's raster) on the int8
// loop of gemm_tile.cuh: mma.sync m16n8k32 s8 x s8 -> s32 from a
// k-contiguous A and an n-major B in shared memory; an m-contiguous A or
// a row-major B lands raw and is transposed there (`S8`). With both
// transposed the block needs 52 KB of shared memory, past the 48 KB a
// kernel has without opting in: that instance takes it dynamically.
// A source of its own (not gemm.cu) so that the two build in parallel.
//
// Bound: operations. At 4096^3 it does 137 GOP on 117 MB (1979 TOP/s
// int8 against 3.35 TB/s: 590 a byte, against 1170 here): 0.069 ms.
// Design against it: the bf16 loop's 128 x 128 block tile and warp
// layout with a byte for an element; wgmma and TMA are later work.

#include "gemm_dense.cuh"

namespace {

using namespace tl_gemm;

template <bool TA, bool TB>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
matmul_s8(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
          int* __restrict__ c, int M, int N, int K, int relu, int vec) {
  const DenseBlock k(M, N, K, TA);
  const s8::S8<TA, TB> src{a + k.a_off, b, k.lda, k.rows, k.n0, K, N,
                           vec != 0};
  s8::Acc acc;
  s8::loop(src, (K + s8::BK - 1) / s8::BK, acc);
  bf16::for_each(acc, DenseEpilogue{c, k.rows, k.m0, k.n0, N, kS32, relu});
}

template <bool TA, bool TB>
int launch(const int8_t* a, const int8_t* b, int* c, int M, int N, int K,
           int relu, int vec, cudaStream_t s) {
  constexpr int bytes = s8::kSmemBytes<s8::S8<TA, TB>>;
  constexpr int dyn = bytes > kStaticSmemBytes ? bytes : 0;
  if (dyn) {
    const cudaError_t e = cudaFuncSetAttribute(
        matmul_s8<TA, TB>, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
    if (e != cudaSuccess) return (int)e;
  }
  matmul_s8<TA, TB><<<tile_count(M, N), kThreads, dyn, s>>>(a, b, c, M, N, K,
                                                            relu, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// a, b int8 -> c (M, N) int32. Launches on `stream` and returns
// cudaGetLastError() (0 = launched); the Python wrapper checks shapes,
// types, devices and the grid's range before calling.
extern "C" int tl_matmul_s8(const void* a, const void* b, void* c, int M,
                            int N, int K, int trans_a, int trans_b, int relu,
                            void* stream) {
  const auto* pa = static_cast<const int8_t*>(a);
  const auto* pb = static_cast<const int8_t*>(b);
  auto* pc = static_cast<int*>(c);
  const int vec = dense_vec(a, b, M, N, K, trans_a, trans_b, 1);
  const auto s = static_cast<cudaStream_t>(stream);
  if (trans_a)
    return trans_b ? launch<true, true>(pa, pb, pc, M, N, K, relu, vec, s)
                   : launch<true, false>(pa, pb, pc, M, N, K, relu, vec, s);
  return trans_b ? launch<false, true>(pa, pb, pc, M, N, K, relu, vec, s)
                 : launch<false, false>(pa, pb, pc, M, N, K, relu, vec, s);
}
