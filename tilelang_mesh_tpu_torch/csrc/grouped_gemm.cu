// Grouped GEMMs for Hopper (sm_90a): dense and token-sorted.
//
// Replaces two TPU kernels of tilelang_mesh_tpu/ops/grouped_gemm.py:
//   grouped_gemm_kernel (:17)        -> tl_grouped_gemm
//     X (E, M, K) @ W (E, K, N) -> O (E, M, N) in X's type (float32,
//     bfloat16 or float16), float32 accumulation; grid (m-tile, n-tile,
//     expert) with the m-tile fastest, so the blocks that read one
//     column panel of W[e] run together and share it through L2.
//   varlen_grouped_gemm_kernel (:58) -> tl_varlen_grouped_gemm
//     A (sum sizes, K) holds every group's rows back to back; block bx
//     reads its expert BlkExp[bx] and first row BlkRow[bx] from device
//     int32 tables (the host's _varlen_meta, with block_M = 128), and
//     GroupEnd[e] (the end row of group e) masks the rows past the
//     group's end: they are loaded as zeros and never stored. C is
//     (sum sizes, N) float32, written in place; the TPU kernel instead
//     wrote a block-padded C (and read block_M zero rows appended to A)
//     that its wrapper compacted, with the same result. B is (E, K, N),
//     or (E, N, K) when trans_b.
// Both run the one block tile loop of gemm_tile.cuh; only how a block
// finds its operands differs.
//
// Bound: operations at the MoE layer's shapes. A (1280 x 4096) @
// (4096 x 14336) expert product does 2 M N K = 150 GFLOP on 352 MB
// (float32), about 430 flops a byte, above the card's balance point in
// float32 (67 TFLOP/s against 3.35 TB/s: 20 flops a byte) and in bf16
// (989 TFLOP/s: 295). Design against it: a 128 x 128 block tile, an
// 8 x 8 FFMA micro-tile a thread in float32 and 4 x 4 mma.sync tiles a
// warp in bf16, operands staged by cp.async one K-tile ahead.

#include "gemm_tile.cuh"

namespace {

using namespace tl_gemm;

template <typename T>
__global__ void __launch_bounds__(kThreads)
grouped_gemm(const T* __restrict__ x, const T* __restrict__ w,
             T* __restrict__ o, int M, int N, int K, int vec) {
  const long long e = blockIdx.z;
  const int m0 = blockIdx.x * BM;
  const Tile<T, T> t{x + (e * M + m0) * K, w + e * K * N,
                     o + (e * M + m0) * N, min(BM, M - m0),
                     (int)blockIdx.y * BN};
  gemm_tile<false>(t, K, N, vec != 0);
}

template <typename T, bool TRANS_B>
__global__ void __launch_bounds__(kThreads)
varlen_grouped_gemm(const T* __restrict__ a, const T* __restrict__ b,
                    const int* __restrict__ blk_exp,
                    const int* __restrict__ blk_row,
                    const int* __restrict__ group_end,
                    float* __restrict__ c, int N, int K, int vec) {
  const int e = blk_exp[blockIdx.x], r0 = blk_row[blockIdx.x];
  const Tile<T, float> t{a + (long long)r0 * K, b + (long long)e * K * N,
                         c + (long long)r0 * N, min(BM, group_end[e] - r0),
                         (int)blockIdx.y * BN};
  gemm_tile<TRANS_B>(t, K, N, vec != 0);
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, cudaStream_t stream, Args... args) {
  kernel<<<grid, kThreads, 0, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <typename T>
int run_varlen(const void* a, const void* b, const int* blk_exp,
               const int* blk_row, const int* group_end, float* out, int N,
               int K, int trans_b, int vec, dim3 grid, cudaStream_t s) {
  const auto* pa = static_cast<const T*>(a);
  const auto* pb = static_cast<const T*>(b);
  return trans_b ? launch(varlen_grouped_gemm<T, true>, grid, s, pa, pb,
                          blk_exp, blk_row, group_end, out, N, K, vec)
                 : launch(varlen_grouped_gemm<T, false>, grid, s, pa, pb,
                          blk_exp, blk_row, group_end, out, N, K, vec);
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError() (0 =
// launched); the Python wrapper checks shapes, types, devices and the
// grid's range before calling. `type` is the operands' DType code
// (gemm_tile.cuh): kF32, kBF16 or kF16.
extern "C" int tl_grouped_gemm(const void* x, const void* w, void* o, int E,
                               int M, int N, int K, int type, void* stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, E);
  const auto s = static_cast<cudaStream_t>(stream);
  const int vec = vec_ok(x, w, K, N, false, type == kF32 ? 4 : 2);
  if (type == kBF16)
    return launch(grouped_gemm<__nv_bfloat16>, grid, s,
                  static_cast<const __nv_bfloat16*>(x),
                  static_cast<const __nv_bfloat16*>(w),
                  static_cast<__nv_bfloat16*>(o), M, N, K, vec);
  if (type == kF16)
    return launch(grouped_gemm<__half>, grid, s,
                  static_cast<const __half*>(x), static_cast<const __half*>(w),
                  static_cast<__half*>(o), M, N, K, vec);
  return launch(grouped_gemm<float>, grid, s, static_cast<const float*>(x),
                static_cast<const float*>(w), static_cast<float*>(o), M, N,
                K, vec);
}

extern "C" int tl_varlen_grouped_gemm(const void* a, const void* b,
                                      const int* blk_exp, const int* blk_row,
                                      const int* group_end, void* c, int TB,
                                      int N, int K, int trans_b, int type,
                                      void* stream) {
  const dim3 grid(TB, (N + BN - 1) / BN);
  const auto s = static_cast<cudaStream_t>(stream);
  const int vec = vec_ok(a, b, K, N, trans_b != 0, type == kF32 ? 4 : 2);
  float* out = static_cast<float*>(c);
  if (type == kBF16)
    return run_varlen<__nv_bfloat16>(a, b, blk_exp, blk_row, group_end, out,
                                     N, K, trans_b, vec, grid, s);
  if (type == kF16)
    return run_varlen<__half>(a, b, blk_exp, blk_row, group_end, out, N, K,
                              trans_b, vec, grid, s);
  return run_varlen<float>(a, b, blk_exp, blk_row, group_end, out, N, K,
                           trans_b, vec, grid, s);
}
