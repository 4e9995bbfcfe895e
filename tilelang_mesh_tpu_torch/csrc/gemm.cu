// The GEMM for Hopper (sm_90a): C = op(A) @ op(B), optional ReLU.
//
// Replaces one TPU kernel of tilelang_mesh_tpu/ops/gemm.py:
//   matmul_kernel (:18) -> tl_matmul_tma, tl_matmul
//     A (M, K), or (K, M) when trans_a; B (K, N), or (N, K) when
//     trans_b; C (M, N). Float inputs (float32, bfloat16, float16 or
//     float8 e4m3, both the same) are accumulated in float32 (no TF32),
//     ReLU on the accumulator, then rounded once to C's type: float32,
//     bfloat16, float16 or float8 e4m3 (round to nearest even; NaN past
//     e4m3's range, as the JAX package casts). int8 inputs are
//     gemm_s8.cu's.
//
// Three paths, by a stated rule (ops/gemm.py::matmul_path):
//   tl_matmul_tma: bfloat16, float16 and fp8 inputs whose bases and row
//     strides are 16-byte aligned (gemm_dense.cuh's dense_vec): the
//     warp-specialised TMA + wgmma body of gemm_sm90.cuh at a block of
//     carver/roller.py's KERNEL_BLOCKS. fp8 operands are first widened
//     exactly to float16 by tl_widen_e4m3 (one launch for both, into
//     scratch the wrapper allocates) and run the float16 instances: the
//     fp8 wgmma's own sums fall short of the float32 contract
//     (gemm_sm90.cuh).
//   tl_matmul_ffma: float32 in and out, A and B row-major and aligned,
//     M, N and K multiples of the block: the FFMA tile of gemm_ffma.cuh
//     (#42's f32 body) at a block of KERNEL_BLOCKS.
//   tl_matmul: every other call (any M, N, K >= 1, transpose and
//     alignment): one block a 128 x 128 tile of C (gemm_dense.cuh: a
//     one-dimensional grid in tile_of's grouped raster) on the block tile
//     loop of gemm_tile.cuh: FFMA for float32, mma.sync m16n8k16 for
//     bfloat16 and float16, fp8 widened exactly to bf16 in shared memory
//     on the same mma path.
//
// Bound: operations at the shapes the library is run at. 8192 x 8192 x
// 4096 in bf16 does 2 M N K = 550 GFLOP on 201 MB, 2730 flops a byte,
// above the card's balance point in every type (bf16 989 TFLOP/s
// against 3.35 TB/s: 295 a byte; float32 on CUDA cores 67 TFLOP/s: 20).
// Design against it: wgmma fed by TMA through a ring of stages, one
// producer warp and two consumer warpgroups (gemm_sm90.cuh); the float32
// loop stages operands by cp.async one K-tile ahead.

#include "gemm_ffma.cuh"

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

// a16[i] = a[i] (i < na), b16[i] = b[i] (i < nb): fp8 e4m3 widened to
// float16, exact; blockIdx.y picks the operand, 16 values a thread and
// step (bases 16-byte aligned)
__global__ void __launch_bounds__(256)
widen_e4m3(const uint8_t* __restrict__ a, __half* __restrict__ a16,
           long long na, const uint8_t* __restrict__ b,
           __half* __restrict__ b16, long long nb) {
  const uint8_t* src = blockIdx.y ? b : a;
  uint16_t* dst = reinterpret_cast<uint16_t*>(blockIdx.y ? b16 : a16);
  const long long n = blockIdx.y ? nb : na;
  const long long step = (long long)gridDim.x * blockDim.x * 16;
  for (long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 16;
       i < n; i += step) {
    if (i + 16 <= n) {
      const uint4 v = *reinterpret_cast<const uint4*>(src + i);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
      uint32_t o[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
            static_cast<__nv_fp8x2_storage_t>(w[q / 2] >> 16 * (q % 2)),
            __NV_E4M3);
        o[q] = (uint32_t)h.x | (uint32_t)h.y << 16;
      }
      uint4* d = reinterpret_cast<uint4*>(dst + i);
      d[0] = make_uint4(o[0], o[1], o[2], o[3]);
      d[1] = make_uint4(o[4], o[5], o[6], o[7]);
    } else {
      for (long long j = i; j < n; ++j)
        dst[j] = __nv_cvt_fp8_to_halfraw(src[j], __NV_E4M3).x;
    }
  }
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

// The TMA path (gemm_sm90.cuh) at the block (bm, bn, bk) of
// KERNEL_BLOCKS: in_type kBF16 or kF16 (fp8 operands arrive widened by
// tl_widen_e4m3); A (M, K) row stride lda, or (K, M) when a_mn; B (N, K)
// row stride ldb, or (K, N) when b_mn. Bases and row strides must be
// 16-byte aligned. Returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for what the path does not take.
extern "C" int tl_matmul_tma(const void* a, const void* b, void* c, int M,
                             int N, int K, long long lda, long long ldb,
                             int in_type, int a_mn, int b_mn, int out_type,
                             int relu, int bm, int bn, int bk,
                             void* stream) {
  if (reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(b) % 16 || lda % 8 || ldb % 8 || M < 1 ||
      N < 1 || K < 1)
    return (int)cudaErrorInvalidValue;
  return tl_sm90::dispatch_tma(a, b, c, M, N, K, lda, ldb, in_type, a_mn,
                               b_mn, out_type, relu, bm, bn, bk,
                               static_cast<cudaStream_t>(stream));
}

// The float32 path (gemm_ffma.cuh) at the block (bm, bn, bk) of
// KERNEL_BLOCKS: A (M, K), B (K, N) and C row-major float32, the block
// dividing M, N and K, bases on 16 bytes; ReLU when relu. Returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for what
// the path does not take.
extern "C" int tl_matmul_ffma(const void* a, const void* b, void* c, int M,
                             int N, int K, int relu, int bm, int bn, int bk,
                             void* stream) {
  if (reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(b) % 16 || M < 1 || N < 1 || K < 1 ||
      bm < 1 || bn < 1 || bk < 1 || M % bm || N % bn || K % bk)
    return (int)cudaErrorInvalidValue;
  return tl_ffma::dispatch_f32(a, b, c, M, N, K, relu, bm, bn, bk,
                               static_cast<cudaStream_t>(stream));
}

// a16 (na values) and b16 (nb) = the fp8 e4m3 a and b widened to float16
// in one launch (bases 16-byte aligned)
extern "C" int tl_widen_e4m3(const void* a, void* a16, long long na,
                             const void* b, void* b16, long long nb,
                             void* stream) {
  const long long most = (na > nb ? na : nb) / 16 / 256 + 1;
  const dim3 grid((unsigned)(most < 1056 ? most : 1056), 2);
  widen_e4m3<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<__half*>(a16), na,
      static_cast<const uint8_t*>(b), static_cast<__half*>(b16), nb);
  return (int)cudaGetLastError();
}
