// The hand-written GEMM yardstick for Hopper (sm_90a): C = A @ B.
//
// Replaces one TPU kernel of bench.py:
//   _hand_pallas_matmul (:262) -> tl_yardstick_gemm
//     A (M, K), B (K, N) row-major, C (M, N) row-major. The TPU kernel
//     walks a grid (M/bm, N/bn, K/bk), zeroes an f32 (bm, bn) scratch at
//     k = 0, adds dot(a, b) in f32 at each k and casts at the last k.
//     Here one block owns a (BM, BN) tile of C and loops over K in steps
//     of BK inside the block: the f32 accumulator lives in registers
//     (zeroing it is the k = 0 branch, the epilogue the last step).
//
// Inputs bf16, f16, fp8 e4m3 or f32 (both the same); C in the input type
// or f32, rounded once to nearest even (an e4m3 value past +-448 is NaN).
// bf16, f16 and fp8 run gemm_sm90.cuh's body, shared with gemm.cu's TMA
// path: TMA loads into a ring of stages, one producer warp, two consumer
// warpgroups on wgmma (A K-major, B MN-major). fp8 operands arrive
// widened exactly to float16 by the wrapper (ops/yardsticks.py, through
// gemm.cu's tl_widen_e4m3) and run the float16 instances: the fp8
// wgmma's own sums fall short of float32 (gemm_sm90.cuh). f32: the FFMA
// tile of gemm_ffma.cuh (CUDA cores, no TF32), which gemm.cu's f32 path
// shares.
//
// The block shape is a template parameter; the instances are
// gemm_sm90.cuh's TL_SM90_BLOCKS, the blocks carver/roller.py's
// MatmulTemplate proposes on the H100 (KERNEL_BLOCKS). The wrapper
// (ops/yardsticks.py) refuses any other block and any M, N, K its block
// does not divide.
//
// Bound: operations at bench.py's shapes. 8192 x 8192 x 4096 in bf16 is
// 550 GFLOP on 268 MB (2048 flops a byte, above the card's 295 a byte
// in bf16); fp8 -> f32 4096^3 137 GFLOP on 101 MB.

#include "gemm_ffma.cuh"

namespace {

using namespace yardstick;

template <int BM, int BN, int BK>
int dispatch(const void* a, const void* b, void* c, int M, int N, int K,
             int in_type, int out_type, cudaStream_t s) {
  switch (in_type) {
    case kF32:
      if (out_type != kF32) return (int)cudaErrorInvalidValue;
      return tl_ffma::launch_f32<BM, BN, BK>(a, b, c, M, N, K, 0, s);
    case kBF16:
      if (out_type != kBF16 && out_type != kF32)
        return (int)cudaErrorInvalidValue;
      return tl_sm90::launch_tma<__nv_bfloat16, BM, BN, BK>(
          a, b, c, M, N, K, K, N, in_type, 0, 1, out_type, 0, s);
    case kF16:
      if (out_type != kF16 && out_type != kF32)
        return (int)cudaErrorInvalidValue;
      return tl_sm90::launch_tma<__half, BM, BN, BK>(
          a, b, c, M, N, K, K, N, in_type, 0, 1, out_type, 0, s);
    case kFP8:                   // a, b: widened to float16 (exact)
      if (out_type != kFP8 && out_type != kF32)
        return (int)cudaErrorInvalidValue;
      return tl_sm90::launch_tma<__half, BM, BN, BK>(
          a, b, c, M, N, K, K, N, kF16, 0, 1, out_type, 0, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// (bm, bn, bk): one of TL_SM90_BLOCKS, dividing M, N and K; in_type,
// out_type: DType codes (out_type the input's or kF32); for fp8 inputs
// `a` and `b` are their float16 widenings. Launches on
// `stream` and returns cudaGetLastError() (0 = launched); an unknown
// block or type pair returns cudaErrorInvalidValue. The Python wrapper
// checks shapes, types, alignment and the grid's range first.
extern "C" int tl_yardstick_gemm(const void* a, const void* b, void* c,
                                 int M, int N, int K, int bm, int bn, int bk,
                                 int in_type, int out_type, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
#define YARDSTICK_CASE(m, n, k)                                          \
  if (bm == m && bn == n && bk == k)                                     \
    return dispatch<m, n, k>(a, b, c, M, N, K, in_type, out_type, s);
  TL_SM90_BLOCKS(YARDSTICK_CASE)
#undef YARDSTICK_CASE
  return (int)cudaErrorInvalidValue;
}
