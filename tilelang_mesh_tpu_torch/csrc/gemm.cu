// The GEMM for Hopper (sm_90a): C = op(A) @ op(B), optional ReLU.
//
// Replaces one TPU kernel of tilelang_mesh_tpu/ops/gemm.py:
//   matmul_kernel (:18) -> tl_matmul
//     A (M, K), or (K, M) when trans_a; B (K, N), or (N, K) when
//     trans_b; C (M, N). Inputs float32, bfloat16 or float8 e4m3 (both
//     the same), accumulated in float32 (no TF32), ReLU on the
//     accumulator, then rounded once to C's type: float32, bfloat16 or
//     float8 e4m3 (round to nearest even; NaN past the range, as the
//     JAX package casts).
//
// One block a 128 x 128 tile of C on the block tile loop of
// gemm_tile.cuh: FFMA for float32, mma.sync m16n8k16 for bfloat16, and
// fp8 widened exactly to bf16 in shared memory on the same mma path.
// The grid is one-dimensional and walks the tiles in groups of 8 tile
// rows, column by column inside a group, so the blocks in flight share
// 8 row panels of A and a few column panels of B through L2.
//
// Bound: operations at the shapes the library is run at. 8192 x 8192 x
// 4096 in bf16 does 2 M N K = 550 GFLOP on 201 MB, 2730 flops a byte,
// above the card's balance point in every type (bf16 989 TFLOP/s
// against 3.35 TB/s: 295 a byte; float32 on CUDA cores 67 TFLOP/s: 20).
// Design against it: a 128 x 128 block tile, operands staged by cp.async
// one K-tile ahead; wgmma and TMA are later work.

#include "gemm_tile.cuh"

namespace {

using namespace tl_gemm;

enum OutType { kF32 = 0, kBF16 = 1, kFP8 = 2 };

// grouped raster: tile (mt, nt) of linear block id `pid`
__device__ __forceinline__ void tile_of(int pid, int tm, int tn, int& mt,
                                        int& nt) {
  constexpr int G = 8;
  const int per_group = G * tn;
  const int first = (pid / per_group) * G;
  const int gm = min(tm - first, G);
  mt = first + (pid % per_group) % gm;
  nt = (pid % per_group) / gm;
}

struct Epilogue {
  void* c;
  int rows, m0, n0, N, out, relu;

  __device__ __forceinline__ void operator()(int r, int j, float v) const {
    const int n = n0 + j;
    if (r >= rows || n >= N) return;
    if (relu && v < 0.f) v = 0.f;      // NaN stays NaN
    const long long at = (long long)(m0 + r) * N + n;
    if (out == kF32) store(static_cast<float*>(c) + at, v);
    else if (out == kBF16) store(static_cast<__nv_bfloat16*>(c) + at, v);
    else store(static_cast<__nv_fp8_e4m3*>(c) + at, v);
  }
};

// the block's tile, and where its operands start
struct Block {
  int m0, n0, rows;
  long long a_off, lda;

  __device__ Block(int M, int N, int K, bool trans_a) {
    int mt, nt;
    tile_of(blockIdx.x, (M + BM - 1) / BM, (N + BN - 1) / BN, mt, nt);
    m0 = mt * BM;
    n0 = nt * BN;
    rows = min(BM, M - m0);
    a_off = trans_a ? m0 : (long long)m0 * K;
    lda = trans_a ? M : K;
  }
};

template <bool TA, bool TB>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
matmul_f32(const float* __restrict__ a, const float* __restrict__ b,
           void* __restrict__ c, int M, int N, int K, int out, int relu,
           int vec) {
  const Block k(M, N, K, TA);
  const f32::Direct<TA, TB> src{a + k.a_off, b, k.lda, k.rows, k.n0, K, N,
                                vec != 0};
  f32::Acc acc;
  f32::loop<TA, TB>(src, (K + f32::BK - 1) / f32::BK, acc);
  f32::for_each<TA, TB>(acc, Epilogue{c, k.rows, k.m0, k.n0, N, out, relu});
}

template <bool TA, bool TB>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
matmul_bf16(const __nv_bfloat16* __restrict__ a,
            const __nv_bfloat16* __restrict__ b, void* __restrict__ c, int M,
            int N, int K, int out, int relu, int vec) {
  const Block k(M, N, K, TA);
  const bf16::Direct<TA, TB> src{a + k.a_off, b, k.lda, k.rows, k.n0, K, N,
                                 vec != 0};
  bf16::Acc<float> acc;
  bf16::loop<TA, TB>(src, (K + bf16::BK - 1) / bf16::BK, acc);
  bf16::for_each(acc, Epilogue{c, k.rows, k.m0, k.n0, N, out, relu});
}

template <bool TA, bool TB>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
matmul_fp8(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
           void* __restrict__ c, int M, int N, int K, int out, int relu,
           int vec) {
  const Block k(M, N, K, TA);
  const bf16::Fp8<TA, TB> src{a + k.a_off, b, k.lda, k.rows, k.n0, K, N,
                              vec != 0};
  bf16::Acc<float> acc;
  bf16::loop<TA, TB>(src, (K + bf16::BK - 1) / bf16::BK, acc);
  bf16::for_each(acc, Epilogue{c, k.rows, k.m0, k.n0, N, out, relu});
}

template <typename T, bool TA, bool TB>
int launch(const void* a, const void* b, void* c, int M, int N, int K,
           int out, int relu, int vec, unsigned blocks, cudaStream_t s) {
  const auto* pa = static_cast<const T*>(a);
  const auto* pb = static_cast<const T*>(b);
  if constexpr (sizeof(T) == 4)
    matmul_f32<TA, TB><<<blocks, kThreads, 0, s>>>(pa, pb, c, M, N, K, out,
                                                   relu, vec);
  else if constexpr (sizeof(T) == 2)
    matmul_bf16<TA, TB><<<blocks, kThreads, 0, s>>>(pa, pb, c, M, N, K, out,
                                                    relu, vec);
  else
    matmul_fp8<TA, TB><<<blocks, kThreads, 0, s>>>(pa, pb, c, M, N, K, out,
                                                   relu, vec);
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

// in_type: 0 float32, 1 bfloat16, 2 float8 e4m3; out_type likewise.
// Launches on `stream` and returns cudaGetLastError() (0 = launched);
// the Python wrapper checks shapes, types, devices and the grid's range
// before calling.
extern "C" int tl_matmul(const void* a, const void* b, void* c, int M,
                         int N, int K, int in_type, int trans_a, int trans_b,
                         int out_type, int relu, void* stream) {
  const unsigned blocks = (unsigned)((M + BM - 1) / BM) *
                          (unsigned)((N + BN - 1) / BN);
  const int esize = in_type == 0 ? 4 : in_type == 1 ? 2 : 1;
  const int v = 16 / esize;
  // every row of A and B starts on 16 bytes (the tiles start on 128
  // elements, so the base pointers and row strides decide)
  const int vec = reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
                  (trans_a ? M : K) % v == 0 && (trans_b ? K : N) % v == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (in_type == 0)
    return dispatch<float>(a, b, c, M, N, K, trans_a, trans_b, out_type,
                           relu, vec, blocks, s);
  if (in_type == 1)
    return dispatch<__nv_bfloat16>(a, b, c, M, N, K, trans_a, trans_b,
                                   out_type, relu, vec, blocks, s);
  return dispatch<uint8_t>(a, b, c, M, N, K, trans_a, trans_b, out_type,
                           relu, vec, blocks, s);
}
