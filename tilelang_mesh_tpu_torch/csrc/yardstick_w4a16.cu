// The hand-written w4a16 yardstick for Hopper (sm_90a): a bf16 GEMM over
// int4 weights unpacked in the kernel.
//
// Replaces one TPU kernel of bench.py:
//   cfg_w4a16.hand_pallas (:1366) -> tl_yardstick_w4a16
//     alo = A[:, :K/2], ahi = A[:, K/2:] (M, K/2) bf16 (row stride lda);
//     packed (K/2, N) uint8 in the planar +8-bias pack (low nibble: B's
//     row k, high nibble: row K/2 + k); scales (2, G2, N) float32, one
//     row a group of gs packed rows; C (M, N) bf16 =
//       alo @ bl + ahi @ bh, bl = bf16(((p & 0xF) - 8) * s[0, k / gs]),
//                           bh = bf16((((p >> 4) & 0xF) - 8) * s[1, k / gs])
//     with f32 sums, rounded once to bf16. The TPU kernel's grid step is
//     one whole scale group (gs packed rows); at bench.py's gs = 512 the
//     two dequantised halves of one step alone are 2 x 512 x BN bf16
//     (256 KB at BN 128), over a block's 227 KB of shared memory. So the
//     K loop here steps by BK = 64 packed rows inside a group (gs a
//     multiple of 64) and reads the scale row k0 / gs.
//
// One block a (BM, BN) tile of C, 8 warps as 2 (m) x 4 (n) with an f32
// register accumulator; per K step both A halves, the packed bytes and
// the step's two scale rows arrive by cp.async (two stages), the block
// unpacks the bytes into two bf16 tiles in shared memory, rounding each
// weight as the TPU kernel does, and multiplies both halves with
// mma.sync m16n8k16. Instances: the (BM, BN) pairs of YARDSTICK_TILES.
//
// Bound: operations at bench.py's shape, 4096^3: 137 GFLOP on 76 MB.
// This is the simple form (mma.sync, no wgmma or TMA).

#include "yardstick.cuh"

#define YARDSTICK_TILES(X) \
  X(128, 128)              \
  X(128, 256)              \
  X(256, 128)

namespace {

using namespace yardstick;
using bf16 = __nv_bfloat16;

constexpr int BK = 64;          // packed rows a K step

template <int BM, int BN>
struct W4 {
  static constexpr int LDA = BK + 8;           // A rows of 144 bytes
  static constexpr int LDB = BN + 8;           // unpacked B rows
  static constexpr int A_ELEMS = BM * LDA;     // one half
  static constexpr int STAGE = 2 * A_ELEMS * 2 + BK * BN + 2 * BN * 4;
  static constexpr int SMEM = 2 * STAGE + 2 * BK * LDB * 2;
};

template <int BM, int BN>
__global__ void __launch_bounds__(kThreads, 1)
w4a16(const bf16* __restrict__ alo, const bf16* __restrict__ ahi,
      long long lda, const uint8_t* __restrict__ packed,
      const float* __restrict__ scales, bf16* __restrict__ c, int N, int K2,
      int gs) {
  using L = W4<BM, BN>;
  constexpr int WM = BM / 2, WN = BN / 4, MI = WM / 16, NI = WN / 8;
  extern __shared__ __align__(16) char smem[];
  // a stage: A lo [BM][LDA], A hi [BM][LDA] bf16, packed [BK][BN] bytes,
  // scales [2][BN] f32; after both stages the unpacked B lo, B hi
  // [BK][LDB] bf16
  bf16* bl = reinterpret_cast<bf16*>(smem + 2 * L::STAGE);
  bf16* bh = bl + BK * L::LDB;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int G2 = K2 / gs;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp % 2) * WM, wn = (warp / 2) * WN;
  const int mat = lane / 8, mr = lane % 8;

  auto stage_a = [&](int st) {
    return reinterpret_cast<bf16*>(smem + st * L::STAGE);
  };
  auto stage_p = [&](int st) {
    return reinterpret_cast<uint8_t*>(smem + st * L::STAGE) +
           2 * L::A_ELEMS * 2;
  };
  auto stage_s = [&](int st) {
    return reinterpret_cast<float*>(stage_p(st) + BK * BN);
  };
  auto load_stage = [&](int st, int kt) {
    const int k0 = kt * BK, grp = k0 / gs;
    bf16* sa = stage_a(st);
    copy_tile<bf16, BM, BK, L::LDA>(sa, alo + m0 * lda + k0, lda);
    copy_tile<bf16, BM, BK, L::LDA>(sa + L::A_ELEMS, ahi + m0 * lda + k0,
                                    lda);
    copy_tile<uint8_t, BK, BN, BN>(stage_p(st),
                                   packed + (long long)k0 * N + n0, N);
    // the two scale rows as a (2, BN) window of row stride G2 * N
    copy_tile<float, 2, BN, BN>(stage_s(st),
                                scales + (long long)grp * N + n0,
                                (long long)G2 * N);
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;

  const int nk = K2 / BK;
  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < nk) load_stage(st ^ 1, kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    // unpack: four bytes of a packed row a thread, each weight
    // (nibble - 8) * scale in f32, rounded to bf16
    {
      const uint8_t* p = stage_p(st);
      const float* s = stage_s(st);
      for (int i = threadIdx.x; i < BK * BN / 4; i += kThreads) {
        const int k = i / (BN / 4), n = (i % (BN / 4)) * 4;
        const uint32_t w = *reinterpret_cast<const uint32_t*>(p + k * BN + n);
        float lo[4], hi[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int byte = (w >> (8 * j)) & 0xFF;
          lo[j] = ((float)(byte & 0xF) - 8.f) * s[n + j];
          hi[j] = ((float)((byte >> 4) & 0xF) - 8.f) * s[BN + n + j];
        }
        __nv_bfloat162* dl =
            reinterpret_cast<__nv_bfloat162*>(bl + k * L::LDB + n);
        __nv_bfloat162* dh =
            reinterpret_cast<__nv_bfloat162*>(bh + k * L::LDB + n);
        dl[0] = __floats2bfloat162_rn(lo[0], lo[1]);
        dl[1] = __floats2bfloat162_rn(lo[2], lo[3]);
        dh[0] = __floats2bfloat162_rn(hi[0], hi[1]);
        dh[1] = __floats2bfloat162_rn(hi[2], hi[3]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const bf16* As = stage_a(st) + half * L::A_ELEMS;
      const bf16* Bs = half ? bh : bl;
#pragma unroll
      for (int ks = 0; ks < BK; ks += 16) {
        unsigned af[MI][4], bfr[NI][2];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
          ldmatrix_x4(af[mi], As + (wm + mi * 16 + mr + 8 * (mat % 2)) *
                                       L::LDA + ks + 8 * (mat / 2));
#pragma unroll
        for (int np = 0; np < NI / 2; ++np) {
          unsigned r[4];
          ldmatrix_x4_trans(r, Bs + (ks + mr + 8 * (mat % 2)) * L::LDB +
                                   wn + np * 16 + 8 * (mat / 2));
          bfr[2 * np][0] = r[0];
          bfr[2 * np][1] = r[1];
          bfr[2 * np + 1][0] = r[2];
          bfr[2 * np + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int ni = 0; ni < NI; ++ni)
            mma16<bf16>(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
      }
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
        *reinterpret_cast<__nv_bfloat162*>(c + row * N + n0 + wn + ni * 8 +
                                           q2) =
            __floats2bfloat162_rn(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
    }
}

}  // namespace

// (bm, bn): one of YARDSTICK_TILES dividing M and N; gs a multiple of
// 64 dividing K2. alo / ahi rows lda elements apart (16-byte aligned).
// Launches on `stream` and returns cudaGetLastError() (0 = launched); an
// unknown tile returns cudaErrorInvalidValue. The Python wrapper checks
// shapes, types, alignment and the grid's range first.
extern "C" int tl_yardstick_w4a16(const void* alo, const void* ahi,
                                  long long lda, const void* packed,
                                  const void* scales, void* c, int M, int N,
                                  int K2, int gs, int bm, int bn,
                                  void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
#define YARDSTICK_CASE(m, n)                                             \
  if (bm == m && bn == n)                                                \
    return launch(w4a16<m, n>, W4<m, n>::SMEM, dim3(N / n, M / m), s,    \
                  alo, ahi, lda, packed, scales, c, N, K2, gs);
  YARDSTICK_TILES(YARDSTICK_CASE)
#undef YARDSTICK_CASE
  return (int)cudaErrorInvalidValue;
}
