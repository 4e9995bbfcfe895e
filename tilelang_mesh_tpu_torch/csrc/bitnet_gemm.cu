// BitNet b1.58's int8 x ternary GEMM for Hopper (sm_90a).
//
// Replaces the TPU kernel of tilelang_mesh_tpu/ops/bitnet.py:
//   bitnet_gemm_kernel (:51) -> tl_bitnet_gemm
//     A (M, K) int8 row-major, Wp (K/4, N) int8: byte (g, n) holds the
//     ternary weights of rows 4g + p (p = 0..3) in bits 2p..2p+1, each
//     biased by +1 (0, 1, 2 for -1, 0, 1; ops/bitnet.py pack_ternary)
//     -> C (M, N) int32, the exact product of A and the unpacked weights.
//     Any M, N >= 1 and K a multiple of 4 (the wrapper refuses others).
//
// Bound: operations at a prefill, bytes at a decode step. At BitNet
// b1.58-2B-4T's gate/up product (M 4096, K 2560 -> N 6912) it does 145
// GOP on 14.9 MB in (A 10.5, the packed weights 4.4) and 113 MB out:
// 0.073 ms at 1979 TOP/s int8. At one token (M 1) it moves the 4.4 MB
// of packed weights for 35 MOP: 1.3 us.
//
// Design: the int8 loop of gemm_tile.cuh (mma.sync m16n8k32 s8 x s8 ->
// s32 on a 128 x 128 block tile, k-tiles of 64 bytes, double-buffered
// cp.async stages) with a converting source, as w4a8 in dequant_gemm.cu
// has for int4. A lands in its k-contiguous compute tile as it is. The
// 16 packed rows of a k-tile land raw; once they have arrived each
// thread unpacks one byte, column n and packed row g, into the four
// int8 weights of rows 4g .. 4g + 3 -- one 32-bit word of the n-major
// tile (ldmatrix `.trans`, which the row-major weights would need,
// moves 16-bit elements only). The unpack is a shift-and-mask spread of
// the four 2-bit fields into four bytes and a bytewise subtract of the
// bias (__vsub4), so a field never borrows from its neighbour. Packed
// rows past K/4 unpack to 0; A is zero past K in any case, so the int32
// sums are exact for every K. The 128-row tile leaves 127 of its rows
// idle at a decode step: right, far from the byte bound (gemv.cu's
// byte-bound design is the later fix).

#include "gemm_dense.cuh"

namespace {

using namespace tl_gemm;

// the four 2-bit fields of a packed byte as four int8 weights, row 4g + p
// in byte p
__device__ __forceinline__ uint32_t unpack4(uint32_t b) {
  const uint32_t f = (b & 0x03u) | ((b & 0x0Cu) << 6) | ((b & 0x30u) << 12) |
                     ((b & 0xC0u) << 18);
  return __vsub4(f, 0x01010101u);
}

struct Ternary {
  static constexpr int BKQ = s8::BK / 4;       // 16 packed rows a k-tile
  static constexpr int kA = s8::kTileBytes;
  static constexpr int kStageBytes = kA + BKQ * BN;
  static constexpr int kCvtBytes = s8::kTileBytes;
  static constexpr bool kConverts = true;
  const int8_t* a;            // row 0 of the block's rows
  const uint8_t* packed;
  int rows, n0, K, N;
  bool vec_a, vec_p;

  __device__ __forceinline__ void issue(char* stage, int kt) const {
    load_window<int8_t, BM, s8::BK, s8::LD>(reinterpret_cast<int8_t*>(stage),
                                            a, 0, kt * s8::BK, rows, K, K,
                                            vec_a);
    load_window<uint8_t, BKQ, BN, BN>(
        reinterpret_cast<uint8_t*>(stage + kA), packed, kt * BKQ, n0, K / 4,
        N, N, vec_p);
  }

  // thread: column j, packed row g -> one 4-byte word of the B tile
  __device__ __forceinline__ void view(char* stage, char* cvt, int kt,
                                       const int8_t*& As,
                                       const int8_t*& Bs) const {
    const uint8_t* p = reinterpret_cast<const uint8_t*>(stage + kA);
    int8_t* b = reinterpret_cast<int8_t*>(cvt);
    for (int i = threadIdx.x; i < BKQ * BN; i += kThreads) {
      const int g = i / BN, j = i % BN;
      const uint32_t w = kt * BKQ + g < K / 4 ? unpack4(p[g * BN + j]) : 0u;
      *reinterpret_cast<uint32_t*>(b + j * s8::LD + 4 * g) = w;
    }
    As = reinterpret_cast<const int8_t*>(stage);
    Bs = b;
  }
};

__global__ void __launch_bounds__(kThreads, kMinBlocks)
bitnet_gemm(const int8_t* __restrict__ a, const uint8_t* __restrict__ packed,
            int* __restrict__ c, int M, int N, int K, int vec_a, int vec_p) {
  const DenseBlock k(M, N, K, false);
  const Ternary src{a + k.a_off, packed, k.rows, k.n0, K, N, vec_a != 0,
                    vec_p != 0};
  s8::Acc acc;
  s8::loop(src, (K + s8::BK - 1) / s8::BK, acc);
  bf16::for_each(acc, DenseEpilogue{c, k.rows, k.m0, k.n0, N, kS32, 0});
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// a (M, K) int8, packed (K/4, N) int8 -> c (M, N) int32. Launches on
// `stream` and returns cudaGetLastError() (0 = launched); the Python
// wrapper checks shapes, types, devices, K % 4 == 0 and the grid's range
// before calling.
extern "C" int tl_bitnet_gemm(const void* a, const void* packed, void* c,
                              int M, int N, int K, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int vec_a = aligned(a) && K % 16 == 0;
  const int vec_p = aligned(packed) && N % 16 == 0;
  bitnet_gemm<<<tile_count(M, N), kThreads, 0, s>>>(
      static_cast<const int8_t*>(a), static_cast<const uint8_t*>(packed),
      static_cast<int*>(c), M, N, K, vec_a, vec_p);
  return (int)cudaGetLastError();
}
