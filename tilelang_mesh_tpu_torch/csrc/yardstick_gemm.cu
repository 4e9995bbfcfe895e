// The hand-written GEMM yardstick for Hopper (sm_90a): C = A @ B.
//
// Replaces one TPU kernel of bench.py:
//   _hand_pallas_matmul (:262) -> tl_yardstick_gemm
//     A (M, K), B (K, N) row-major, C (M, N) row-major. The TPU kernel
//     walks a grid (M/bm, N/bn, K/bk), zeroes an f32 (bm, bn) scratch at
//     k = 0, adds dot(a, b) in f32 at each k and casts at the last k.
//     Here one block owns a (BM, BN) tile of C and loops over K in steps
//     of BK inside the block: the f32 accumulator lives in registers
//     (zeroing it is the k = 0 branch, the epilogue the last step), the
//     operand tiles are staged in shared memory by cp.async, two stages,
//     the next tile in flight while the current one is multiplied.
//
// Inputs bf16, f16, fp8 e4m3 or f32 (both the same); C in the input type
// or f32, rounded once to nearest even (an e4m3 value past +-448 is NaN).
// Products: mma.sync m16n8k16 for bf16 and f16, m16n8k32 .e4m3 for fp8
// (B is transposed into an n-major tile in shared memory: ldmatrix .trans
// moves 16-bit elements only), FFMA on the CUDA cores for f32 (no TF32).
// Eight warps as 2 (m) x 4 (n); each thread of the f32 kernel owns a
// (BM/16) x (BN/16) register tile.
//
// The block shape is a template parameter; the instances are
// YARDSTICK_BLOCKS below, the blocks carver/roller.py's MatmulTemplate
// proposes on the H100 (KERNEL_BLOCKS). The wrapper (ops/yardsticks.py)
// refuses any other block and any M, N, K its block does not divide.
//
// Bound: operations at bench.py's shapes. 8192 x 8192 x 4096 in bf16 is
// 550 GFLOP on 268 MB (2048 flops a byte, above the card's 295 a byte
// in bf16); fp8 -> f32 4096^3 137 GFLOP on 101 MB. This is the simple form:
// mma.sync from ldmatrix fragments, no wgmma, TMA or warp
// specialisation.

#include "yardstick.cuh"

#define YARDSTICK_BLOCKS(X) \
  X(128, 128, 32)           \
  X(128, 128, 64)           \
  X(128, 256, 32)           \
  X(128, 256, 64)           \
  X(256, 128, 32)           \
  X(256, 128, 64)

namespace {

using namespace yardstick;

// ---------------------------------------------------------------------------
// bf16 / f16: mma.sync m16n8k16
// ---------------------------------------------------------------------------

template <typename T, int BM, int BN, int BK>
struct H16 {
  static constexpr int LDA = BK + 8;           // rows of 80 / 144 bytes
  static constexpr int LDB = BN + 8;           // rows of 272 / 528 bytes
  static constexpr int A_ELEMS = BM * LDA;
  static constexpr int B_ELEMS = BK * LDB;
  static constexpr int SMEM = 2 * (A_ELEMS + B_ELEMS) * (int)sizeof(T);
};

template <typename T, int BM, int BN, int BK>
__global__ void __launch_bounds__(kThreads, 1)
gemm_h16(const T* __restrict__ a, const T* __restrict__ b,
         void* __restrict__ c, int N, int K, int out) {
  using L = H16<T, BM, BN, BK>;
  constexpr int WM = BM / 2, WN = BN / 4, MI = WM / 16, NI = WN / 8;
  extern __shared__ __align__(16) char smem[];
  T* sA = reinterpret_cast<T*>(smem);          // [2][BM][LDA]
  T* sB = sA + 2 * L::A_ELEMS;                 // [2][BK][LDB]
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const T* ag = a + (long long)m0 * K;
  const T* bg = b + n0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp % 2) * WM, wn = (warp / 2) * WN;
  // the lane's row address in an x4 ldmatrix: matrix lane / 8, row lane % 8
  const int mat = lane / 8, mr = lane % 8;

  auto load_stage = [&](int stage, int kt) {
    copy_tile<T, BM, BK, L::LDA>(sA + stage * L::A_ELEMS, ag + kt * BK, K);
    copy_tile<T, BK, BN, L::LDB>(sB + stage * L::B_ELEMS,
                                 bg + (long long)kt * BK * N, N);
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;

  const int nk = K / BK;
  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load_stage((kt + 1) & 1, kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* As = sA + (kt & 1) * L::A_ELEMS;
    const T* Bs = sB + (kt & 1) * L::B_ELEMS;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      unsigned af[MI][4], bf[NI][2];
      // A 16 x 16: (rows 0-7 | 8-15) x (k 0-7 | 8-15), the mma's a0..a3
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        ldmatrix_x4(af[mi], As + (wm + mi * 16 + mr + 8 * (mat % 2)) *
                                     L::LDA + ks + 8 * (mat / 2));
      // B [k][n]: one x4.trans covers two n8 tiles, (k 0-7, k 8-15) each
#pragma unroll
      for (int np = 0; np < NI / 2; ++np) {
        unsigned r[4];
        ldmatrix_x4_trans(r, Bs + (ks + mr + 8 * (mat % 2)) * L::LDB + wn +
                                 np * 16 + 8 * (mat / 2));
        bf[2 * np][0] = r[0];
        bf[2 * np][1] = r[1];
        bf[2 * np + 1][0] = r[2];
        bf[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
          mma16<T>(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
    }
    __syncthreads();
  }

  // c0, c1 at (row g, cols 2q, 2q + 1) of an m16n8 tile, c2, c3 at g + 8
  const int g = lane / 4, q2 = (lane % 4) * 2;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = m0 + wm + mi * 16 + g + 8 * h;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          store_as(c, row * N + n0 + wn + ni * 8 + q2 + e, out,
                   acc[mi][ni][2 * h + e]);
    }
}

// ---------------------------------------------------------------------------
// fp8 e4m3: mma.sync m16n8k32, B transposed into an n-major tile
// ---------------------------------------------------------------------------

template <int BM, int BN, int BK>
struct E4M3 {
  static constexpr int LDA = BK + 16;          // rows of 48 / 80 bytes
  static constexpr int LDT = BK + 16;          // n-major B rows
  static constexpr int A_BYTES = BM * LDA;
  static constexpr int B_BYTES = BK * BN;      // raw (K, N) rows
  static constexpr int SMEM = 2 * (A_BYTES + B_BYTES) + BN * LDT;
};

// dst[n][k] = src[k][n] for the dense (BK x BN) bytes at src: a thread
// turns a 4 x 4 block of bytes around with byte permutes
template <int BK, int BN, int LDT>
__device__ __forceinline__ void transpose_bytes(const uint8_t* src,
                                                uint8_t* dst) {
  for (int i = threadIdx.x; i < (BK / 4) * (BN / 4); i += kThreads) {
    const int k4 = (i / (BN / 4)) * 4, n4 = (i % (BN / 4)) * 4;
    const uint32_t x0 = *reinterpret_cast<const uint32_t*>(src + k4 * BN + n4);
    const uint32_t x1 =
        *reinterpret_cast<const uint32_t*>(src + (k4 + 1) * BN + n4);
    const uint32_t x2 =
        *reinterpret_cast<const uint32_t*>(src + (k4 + 2) * BN + n4);
    const uint32_t x3 =
        *reinterpret_cast<const uint32_t*>(src + (k4 + 3) * BN + n4);
    // t0 = [x0.0 x1.0 x0.1 x1.1], t1 = [x0.2 x1.2 x0.3 x1.3], t2, t3 of
    // x2, x3 likewise; column j = byte j of x0..x3
    const uint32_t t0 = __byte_perm(x0, x1, 0x5140);
    const uint32_t t1 = __byte_perm(x0, x1, 0x7362);
    const uint32_t t2 = __byte_perm(x2, x3, 0x5140);
    const uint32_t t3 = __byte_perm(x2, x3, 0x7362);
    *reinterpret_cast<uint32_t*>(dst + n4 * LDT + k4) = __byte_perm(t0, t2, 0x5410);
    *reinterpret_cast<uint32_t*>(dst + (n4 + 1) * LDT + k4) =
        __byte_perm(t0, t2, 0x7632);
    *reinterpret_cast<uint32_t*>(dst + (n4 + 2) * LDT + k4) =
        __byte_perm(t1, t3, 0x5410);
    *reinterpret_cast<uint32_t*>(dst + (n4 + 3) * LDT + k4) =
        __byte_perm(t1, t3, 0x7632);
  }
}

template <int BM, int BN, int BK>
__global__ void __launch_bounds__(kThreads, 1)
gemm_e4m3(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
          void* __restrict__ c, int N, int K, int out) {
  using L = E4M3<BM, BN, BK>;
  constexpr int WM = BM / 2, WN = BN / 4, MI = WM / 16, NI = WN / 8;
  extern __shared__ __align__(16) char smem[];
  uint8_t* sA = reinterpret_cast<uint8_t*>(smem);    // [2][BM][LDA]
  uint8_t* sB = sA + 2 * L::A_BYTES;                 // [2][BK][BN]
  uint8_t* sT = sB + 2 * L::B_BYTES;                 // [BN][LDT]
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const uint8_t* ag = a + (long long)m0 * K;
  const uint8_t* bg = b + n0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp % 2) * WM, wn = (warp / 2) * WN;
  const int mat = lane / 8, mr = lane % 8;

  auto load_stage = [&](int stage, int kt) {
    copy_tile<uint8_t, BM, BK, L::LDA>(sA + stage * L::A_BYTES,
                                       ag + kt * BK, K);
    copy_tile<uint8_t, BK, BN, BN>(sB + stage * L::B_BYTES,
                                   bg + (long long)kt * BK * N, N);
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;

  const int nk = K / BK;
  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load_stage((kt + 1) & 1, kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    transpose_bytes<BK, BN, L::LDT>(sB + (kt & 1) * L::B_BYTES, sT);
    __syncthreads();
    const uint8_t* As = sA + (kt & 1) * L::A_BYTES;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      unsigned af[MI][4], bf[NI][2];
      // A 16 x 32 bytes: (rows 0-7 | 8-15) x (k 0-15 | 16-31)
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        ldmatrix_x4(af[mi], As + (wm + mi * 16 + mr + 8 * (mat % 2)) *
                                     L::LDA + ks + 16 * (mat / 2));
      // B [n][k]: one x4 covers two n8 tiles, (k 0-15, k 16-31) each
#pragma unroll
      for (int np = 0; np < NI / 2; ++np) {
        unsigned r[4];
        ldmatrix_x4(r, sT + (wn + np * 16 + mr + 8 * (mat / 2)) * L::LDT +
                           ks + 16 * (mat % 2));
        bf[2 * np][0] = r[0];
        bf[2 * np][1] = r[1];
        bf[2 * np + 1][0] = r[2];
        bf[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
          mma_e4m3(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
    }
    __syncthreads();
  }

  const int g = lane / 4, q2 = (lane % 4) * 2;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = m0 + wm + mi * 16 + g + 8 * h;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          store_as(c, row * N + n0 + wn + ni * 8 + q2 + e, out,
                   acc[mi][ni][2 * h + e]);
    }
}

// ---------------------------------------------------------------------------
// f32: FFMA, a (BM/16) x (BN/16) tile a thread
// ---------------------------------------------------------------------------

template <int BM, int BN, int BK>
struct F32 {
  static constexpr int LDA = BK + 4;           // k-contiguous A rows
  static constexpr int LDB = BN + 4;
  static constexpr int A_ELEMS = BM * LDA;
  static constexpr int B_ELEMS = BK * LDB;
  static constexpr int SMEM = 2 * (A_ELEMS + B_ELEMS) * 4;
};

// Thread (ty, tx) of a 16 x 16 grid owns rows ty + 16 i (i < BM / 16)
// and the column runs tx * 4 + 64 j (j < BN / 64) of four.
template <int BM, int BN, int BK>
__global__ void __launch_bounds__(kThreads, 1)
gemm_f32(const float* __restrict__ a, const float* __restrict__ b,
         float* __restrict__ c, int N, int K) {
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
    for (int j = 0; j < TJ; ++j)
      *reinterpret_cast<float4*>(c + (long long)(m0 + ty + 16 * i) * N + n0 +
                                 tx * 4 + 64 * j) =
          make_float4(acc[i][j][0], acc[i][j][1], acc[i][j][2],
                      acc[i][j][3]);
}

template <int BM, int BN, int BK>
int dispatch(const void* a, const void* b, void* c, int M, int N, int K,
             int in_type, int out_type, cudaStream_t s) {
  const dim3 grid(N / BN, M / BM);
  switch (in_type) {
    case kF32:
      if (out_type != kF32) return (int)cudaErrorInvalidValue;
      return launch(gemm_f32<BM, BN, BK>, F32<BM, BN, BK>::SMEM, grid, s,
                    a, b, c, N, K);
    case kBF16:
      if (out_type != kBF16 && out_type != kF32)
        return (int)cudaErrorInvalidValue;
      return launch(gemm_h16<__nv_bfloat16, BM, BN, BK>,
                    H16<__nv_bfloat16, BM, BN, BK>::SMEM, grid, s, a, b, c,
                    N, K, out_type);
    case kF16:
      if (out_type != kF16 && out_type != kF32)
        return (int)cudaErrorInvalidValue;
      return launch(gemm_h16<__half, BM, BN, BK>,
                    H16<__half, BM, BN, BK>::SMEM, grid, s, a, b, c, N, K,
                    out_type);
    case kFP8:
      if (out_type != kFP8 && out_type != kF32)
        return (int)cudaErrorInvalidValue;
      return launch(gemm_e4m3<BM, BN, BK>, E4M3<BM, BN, BK>::SMEM, grid, s,
                    a, b, c, N, K, out_type);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// (bm, bn, bk): one of YARDSTICK_BLOCKS, dividing M, N and K; in_type,
// out_type: DType codes (out_type the input's or kF32). Launches on
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
  YARDSTICK_BLOCKS(YARDSTICK_CASE)
#undef YARDSTICK_CASE
  return (int)cudaErrorInvalidValue;
}
