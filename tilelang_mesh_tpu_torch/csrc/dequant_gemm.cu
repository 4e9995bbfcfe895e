// Low-bit GEMMs for Hopper (sm_90a): w4a16, the int4 unpack, w4a8.
//
// Replaces three TPU kernels of tilelang_mesh_tpu/ops/dequant_gemm.py.
// Weights are int4 in the planar +8-bias pack: byte (k2, n) of
// P (K/2, N) holds row k2 of B in its low nibble and row K/2 + k2 in its
// high nibble, each as q + 8; scale row g of half h is S[h G2 + g, n]
// with g = k2 / gs. One packed tile therefore feeds two products, the
// low half of A's columns with the low nibbles and the high half with
// the high ones.
//   dequant_gemm_kernel (:62) -> tl_dequant_gemm, tl_dequant_gemm_splitk
//     + tl_dequant_splitk_combine, tl_dequant_gemm_wgmma (w4a16, fused)
//     C (M, N) = A (M, K) @ B, A float32, bfloat16 or float16, C in A's
//     type. Each B element is ((b & 0xF) - 8) * s in float32, rounded to
//     A's type before the product, as the TPU kernel's B_lo / B_hi
//     fragments of A's type are; float32 sums. ops/dequant_gemm.py::
//     dequant_path picks the kernel by the shape, type and alignment.
//   dequant_int4_kernel (:127) -> tl_dequant_int4
//     Bd (K, N) in float32, bfloat16 or float16: rows [0, K/2) the low
//     nibbles, [K/2, K) the high, with the same float32 multiply and
//     rounding.
//   w4a8_gemm_kernel (:204) -> tl_w4a8_gemm
//     C (M, N) f32 = (A (M, K) int8 @ B int4, exact int32 sums) * Sa[m]
//     * Sw[n], on mma.sync m16n8k32 s8; the unpack writes B n-major into
//     shared memory (ldmatrix `.trans` moves 16-bit elements only).
//
// Bounds. At 4096^3 the fused GEMMs do 137 GFLOP (GOP) on 25-67 MB,
// above the card's balance point: operations bound them, 0.139 ms in
// bf16 and 0.069 ms in int8 (989 / 1979 T a second). At the decode shape
// (M 16, K 4096, N 11008) w4a16 moves 24.4 MB of weights and scales for
// 1.4 GFLOP: bytes bound it (7.3 us). The unpack is bytes: K/2 N in,
// 2 K/2 N out and the scales.
//
// w4a16 at up to 16 rows (tl_dequant_gemm_splitk, bf16 / f16): the
// weights are read once. A block owns 128 columns and rows_per_block
// packed rows (the host's plan, ops/dequant_gemm.py::dequant_splitk_plan:
// about two blocks an SM, as many as are resident at once); each warp
// takes a contiguous eighth of them in 8-row k-steps, copied by cp.async
// three steps ahead into its own ring in shared memory. The weights are
// the A operand of mma.sync m16n8k16 and A's rows its B operand, so one
// n8 tile covers up to 8 rows of A and two up to 16. The 16 k slots are
// any 16 k of the tile so long as both operands agree, and so are the
// 16 m slots: lane (q, g) = (lane % 4, lane / 4) holds 16 columns (16
// bytes) of packed rows r + q and r + 4 + q; m slots g and g + 8 of tile
// t are its columns 2t and 2t + 1, k slots 2q, 2q + 1, 2q + 8, 2q + 9
// the low and high nibbles of its two rows. The nibbles unpack in
// registers (a byte permute places a nibble under 0x4B000000, which is
// 2^23 + nibble as a float; one subtract gives nibble - 8 exactly), times
// the group's scales (32 registers, loaded again when the group changes),
// rounded in pairs. A's matching pairs (A[m, r], A[m, K/2 + r]) sit in
// shared memory as 32-bit words, bank-swizzled. The warps' sums meet in a
// fixed tree in shared memory; each block writes its float32 partial (M
// x 128) and tl_dequant_splitk_combine adds the splits in split order
// and rounds: no floating-point atomics, so two runs give the same bits.
// The unpack's instructions, not the bytes, set its pace (PERF.md).
//
// w4a16 at more rows (tl_dequant_gemm_wgmma, bf16 / f16, gs a multiple
// of 64): lowbit_sm90.cuh's TMA + wgmma pipeline at a 128 x 128 tile
// with 64 packed rows a stage, or 256 x 128 with 32 for many rows (the
// host's ops/dequant_gemm.py::dequant_wgmma_tile). An A k-tile is two
// TMA boxes of one map, at k0 and K/2 + k0 (the 128- or 64-byte swizzle
// of their width); the packed rows arrive raw. The consumers unpack them
// into two B tiles (the low and the high nibbles) MN-major, rows of 64
// columns with the 128-byte swizzle, which bf16 / f16 wgmma reads
// through its transpose bit; a thread unpacks 8 columns of a row at a
// time, its 16 scales loaded once a group (a stage's rows lie in one
// group). wgmma m64n128k16 on the low tiles, then the high ones. The
// epilogue stages the float32 sums in shared memory and stores 8
// elements a thread. The unpack runs once a TM-row tile, M / TM times in
// all, which with the A tiles' L2 traffic holds it behind the two-pass
// path at 4096^3 (PERF.md).
//
// The rest (tl_dequant_gemm: float32, misaligned operands, N off 16
// bytes, groups the new paths do not take): the block tile loop of
// gemm_tile.cuh, its k-tile BK/2 packed rows: the A tile the two (128 x
// BK/2) windows at k0 and K/2 + k0, the B tile the low and the high
// nibbles of one packed (BK/2 x 128) tile unpacked into shared memory.

#include "gemm_tile.cuh"
#include "lowbit_sm90.cuh"

namespace {

using namespace tl_gemm;

// two adjacent elements, each rounded to the element type
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// The w4a16 source of the float32 (BK 16) and 16-bit (BK 32) loops: A
// (M, K) of T as its two halves, B unpacked from P and S.
template <typename T, int BK, int PAD>
struct W4 {
  using L = Layout<BK, PAD, false, false>;
  using Elem = T;
  static constexpr int BKH = BK / 2;           // packed rows a k-tile
  static constexpr int kA = L::a_elems * sizeof(T);
  static constexpr int kStageBytes = kA + BKH * BN;
  static constexpr int kCvtBytes = L::b_elems * sizeof(T);
  static constexpr bool kConverts = true;
  const T* a;                 // row 0 of the block's rows
  const uint8_t* packed;
  const float* scales;
  int rows, n0, K2, N, gs, G2;
  bool vec_a, vec_p;

  __device__ __forceinline__ void issue(char* stage, int kt) const {
    T* As = reinterpret_cast<T*>(stage);
    const int k0 = kt * BKH;
    load_window<T, BM, BKH, L::a_ld>(As, a, 0, k0, rows, K2, 2LL * K2,
                                     vec_a);
    load_window<T, BM, BKH, L::a_ld>(As + BKH, a + K2, 0, k0, rows, K2,
                                     2LL * K2, vec_a);
    load_window<uint8_t, BKH, BN, BN>(
        reinterpret_cast<uint8_t*>(stage + kA), packed, k0, n0, K2, N, N,
        vec_p);
  }

  // thread: columns j, j + 1 of every fourth packed row, the pair's two
  // bytes at once; its group's scales load when the group changes
  __device__ __forceinline__ void view(char* stage, char* cvt, int kt,
                                       const T*& As, const T*& Bs) const {
    constexpr int kPairs = BN / 2, kRowStep = kThreads / kPairs;
    const uint8_t* p = reinterpret_cast<const uint8_t*>(stage + kA);
    T* b = reinterpret_cast<T*>(cvt);
    const int j = (threadIdx.x % kPairs) * 2, n = n0 + j;
    int g = -1;
    float sl0 = 0.f, sl1 = 0.f, sh0 = 0.f, sh1 = 0.f;
#pragma unroll
    for (int r = threadIdx.x / kPairs; r < BKH; r += kRowStep) {
      const int k2 = kt * BKH + r;
      float lo0 = 0.f, lo1 = 0.f, hi0 = 0.f, hi1 = 0.f;
      if (k2 < K2) {
        if (k2 / gs != g) {
          g = k2 / gs;
          const float* s = scales + (long long)g * N + n;
          const float* t = scales + (long long)(G2 + g) * N + n;
          sl0 = n < N ? __ldg(s) : 0.f;
          sh0 = n < N ? __ldg(t) : 0.f;
          sl1 = n + 1 < N ? __ldg(s + 1) : 0.f;
          sh1 = n + 1 < N ? __ldg(t + 1) : 0.f;
        }
        const unsigned w =
            *reinterpret_cast<const uint16_t*>(p + r * BN + j);
        lo0 = (float(w & 0xF) - 8.f) * sl0;
        hi0 = (float((w >> 4) & 0xF) - 8.f) * sh0;
        lo1 = (float((w >> 8) & 0xF) - 8.f) * sl1;
        hi1 = (float(w >> 12) - 8.f) * sh1;
      }
      store2(b + r * L::b_ld + j, lo0, lo1);
      store2(b + (BKH + r) * L::b_ld + j, hi0, hi1);
    }
    As = reinterpret_cast<const T*>(stage);
    Bs = b;
  }
};

// The w4a8 source of the int8 loop: A (M, K) int8 as its two halves, B
// unpacked to int8 q = nibble - 8, written n-major.
struct W4A8 {
  static constexpr int BKH = s8::BK / 2;       // 32 packed rows
  static constexpr int kA = s8::kTileBytes;
  static constexpr int kStageBytes = kA + BKH * BN;
  static constexpr int kCvtBytes = s8::kTileBytes;
  static constexpr bool kConverts = true;
  const int8_t* a;
  const uint8_t* packed;
  int rows, n0, K2, N;
  bool vec_a, vec_p;

  __device__ __forceinline__ void issue(char* stage, int kt) const {
    int8_t* As = reinterpret_cast<int8_t*>(stage);
    const int k0 = kt * BKH;
    load_window<int8_t, BM, BKH, s8::LD>(As, a, 0, k0, rows, K2, 2LL * K2,
                                         vec_a);
    load_window<int8_t, BM, BKH, s8::LD>(As + BKH, a + K2, 0, k0, rows, K2,
                                         2LL * K2, vec_a);
    load_window<uint8_t, BKH, BN, BN>(
        reinterpret_cast<uint8_t*>(stage + kA), packed, k0, n0, K2, N, N,
        vec_p);
  }

  // thread: column j, four packed rows -> one 4-byte word of each half
  __device__ __forceinline__ void view(char* stage, char* cvt, int kt,
                                       const int8_t*& As,
                                       const int8_t*& Bs) const {
    const uint8_t* p = reinterpret_cast<const uint8_t*>(stage + kA);
    int8_t* b = reinterpret_cast<int8_t*>(cvt);
    for (int i = threadIdx.x; i < BKH / 4 * BN; i += kThreads) {
      const int r4 = (i / BN) * 4, j = i % BN;
      uint32_t lo = 0, hi = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (kt * BKH + r4 + q < K2) {
          const int byte = p[(r4 + q) * BN + j];
          lo |= (uint32_t)(((byte & 0xF) - 8) & 0xFF) << (8 * q);
          hi |= (uint32_t)(((byte >> 4) - 8) & 0xFF) << (8 * q);
        }
      }
      *reinterpret_cast<uint32_t*>(b + j * s8::LD + r4) = lo;
      *reinterpret_cast<uint32_t*>(b + j * s8::LD + BKH + r4) = hi;
    }
    As = reinterpret_cast<const int8_t*>(stage);
    Bs = b;
  }
};

struct Block {
  int m0, n0, rows;

  __device__ Block(int M, int N) {
    int mt, nt;
    tile_of(blockIdx.x, (M + BM - 1) / BM, (N + BN - 1) / BN, mt, nt);
    m0 = mt * BM;
    n0 = nt * BN;
    rows = min(BM, M - m0);
  }
};

template <typename T>
struct Store {
  T* c;
  int rows, m0, n0, N;
  __device__ __forceinline__ void operator()(int r, int j, float v) const {
    if (r < rows && n0 + j < N) store(c + (long long)(m0 + r) * N + n0 + j,
                                      v);
  }
};

__global__ void __launch_bounds__(kThreads, kMinBlocks)
dequant_gemm_f32(const float* __restrict__ a,
                 const uint8_t* __restrict__ packed,
                 const float* __restrict__ scales, float* __restrict__ c,
                 int M, int N, int K2, int gs, int vec_a, int vec_p) {
  const Block k(M, N);
  const W4<float, f32::BK, f32::PAD> src{
      a + (long long)k.m0 * 2 * K2, packed, scales, k.rows, k.n0, K2, N,
      gs, K2 / gs, vec_a != 0, vec_p != 0};
  f32::Acc acc;
  f32::loop<false, false>(src, (K2 + src.BKH - 1) / src.BKH, acc);
  f32::for_each<false, false>(acc, Store<float>{c, k.rows, k.m0, k.n0, N});
}

// T: __nv_bfloat16 or __half (the mma.sync instruction follows it)
template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
dequant_gemm_h16(const T* __restrict__ a, const uint8_t* __restrict__ packed,
                 const float* __restrict__ scales, T* __restrict__ c, int M,
                 int N, int K2, int gs, int vec_a, int vec_p) {
  const Block k(M, N);
  const W4<T, bf16::BK, bf16::PAD> src{
      a + (long long)k.m0 * 2 * K2, packed, scales, k.rows, k.n0, K2, N,
      gs, K2 / gs, vec_a != 0, vec_p != 0};
  bf16::Acc<float> acc;
  bf16::loop<false, false>(src, (K2 + src.BKH - 1) / src.BKH, acc);
  bf16::for_each(acc, Store<T>{c, k.rows, k.m0, k.n0, N});
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
w4a8_gemm(const int8_t* __restrict__ a, const uint8_t* __restrict__ packed,
          const float* __restrict__ sw, const float* __restrict__ sa,
          float* __restrict__ c, int M, int N, int K2, int vec_a,
          int vec_p) {
  const Block k(M, N);
  const W4A8 src{a + (long long)k.m0 * 2 * K2, packed, k.rows, k.n0, K2, N,
                 vec_a != 0, vec_p != 0};
  s8::Acc acc;
  s8::loop(src, (K2 + W4A8::BKH - 1) / W4A8::BKH, acc);
  bf16::for_each(acc, [&](int r, int j, int v) {
    const int n = k.n0 + j;
    if (r < k.rows && n < N)
      c[(long long)(k.m0 + r) * N + n] = (float)v * sa[k.m0 + r] * sw[n];
  });
}

__device__ __forceinline__ void put8(float* p, const float (&v)[8]) {
  float4* d = reinterpret_cast<float4*>(p);
  d[0] = make_float4(v[0], v[1], v[2], v[3]);
  d[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void put8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 w;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&w);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    h[q] = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
  *reinterpret_cast<uint4*>(p) = w;
}
__device__ __forceinline__ void put8(__half* p, const float (&v)[8]) {
  uint4 w;
  __half2* h = reinterpret_cast<__half2*>(&w);
#pragma unroll
  for (int q = 0; q < 4; ++q) h[q] = __floats2half2_rn(v[2 * q], v[2 * q + 1]);
  *reinterpret_cast<uint4*>(p) = w;
}

// Eight consecutive bytes of a row of P a thread (V = 8: N a multiple of
// 8, 16-byte aligned tensors), or one; blockIdx.y strides over the rows,
// so a row's group and offsets are 32-bit arithmetic done once.
template <typename OutT, int V>
__global__ void __launch_bounds__(kThreads)
dequant_int4(const uint8_t* __restrict__ packed,
             const float* __restrict__ scales, OutT* __restrict__ out,
             int K2, int N, int gs) {
  const int n = (blockIdx.x * kThreads + threadIdx.x) * V;
  if (n >= N) return;
  const int G2 = K2 / gs;
  for (int k2 = blockIdx.y; k2 < K2; k2 += gridDim.y) {
    const int g = k2 / gs;
    const uint8_t* p = packed + (long long)k2 * N + n;
    const float* sl = scales + (long long)g * N + n;
    const float* sh = scales + (long long)(G2 + g) * N + n;
    OutT* lo = out + (long long)k2 * N + n;
    OutT* hi = out + (long long)(K2 + k2) * N + n;
    if (V == 8) {
      const uint2 w = *reinterpret_cast<const uint2*>(p);
      const float4 l0 = *reinterpret_cast<const float4*>(sl);
      const float4 l1 = *reinterpret_cast<const float4*>(sl + 4);
      const float4 h0 = *reinterpret_cast<const float4*>(sh);
      const float4 h1 = *reinterpret_cast<const float4*>(sh + 4);
      const float ls[8] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
      const float hs[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
      float vl[8], vh[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const unsigned b = ((q < 4 ? w.x : w.y) >> (8 * (q % 4))) & 0xFF;
        vl[q] = (float(b & 0xF) - 8.f) * ls[q];
        vh[q] = (float(b >> 4) - 8.f) * hs[q];
      }
      put8(lo, vl);
      put8(hi, vh);
    } else {
      const int b = p[0];
      store(lo, (float(b & 0xF) - 8.f) * sl[0]);
      store(hi, (float(b >> 4) - 8.f) * sh[0]);
    }
  }
}

// ---------------------------------------------------------------------------
// w4a16 at up to 16 rows: split K, the weights streamed once
// ---------------------------------------------------------------------------

constexpr int kSkCols = 128;                  // a block: 8 lane groups x 16
constexpr int kSkStages = 4;                  // a warp's ring of k-steps
// a block's dynamic shared memory at rpb packed rows
constexpr int sk_smem_bytes(int rpb) {
  return rpb * 64 + 8 * kSkStages * 1024;
}

// the pair of 16-bit T as one word, the first in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo,
                                                         float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  const __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The nibbles of a packed word x (bytes: four columns) as floats: lo
// and hi hold each byte's low and high nibble in place; nib(v, j) is
// nibble j of v minus 8, exactly (0x4B0000nn is 2^23 + nn as a float).
struct Nibbles {
  uint32_t lo, hi;
  __device__ __forceinline__ explicit Nibbles(uint32_t x)
      : lo(x & 0x0F0F0F0Fu), hi((x >> 4) & 0x0F0F0F0Fu) {}
};
__device__ __forceinline__ float nib(uint32_t v, int j) {
  return __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7440 | j)) -
         8388616.0f;
}

// A's pair word of row r (of the block), row m (< 16), bank-swizzled so
// that lanes (q, g) reading rows r0 + q (or r0 + 4 + q) and rows g or
// g + 8 hit 32 banks
__device__ __forceinline__ int pair_at(int r, int m) {
  return r * 16 + (m ^ (((r >> 1) & 1) << 3));
}

// grid (ceil(N / 128), splits); ws (splits, M, N) float32 partials. The
// weights are the mma's A operand (16 columns x 16 k), A's rows its B
// operand: NT n8 tiles cover the M <= 8 NT rows. Dynamic shared memory:
// A's pairs (rpb x 16 words), then each warp's ring of kSkStages slots of
// 1 KB (a lane's 2 x 16 bytes of a k-step), later the warps' partials.
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads, 2)
dequant_gemm_splitk(const T* __restrict__ a,
                    const uint8_t* __restrict__ packed,
                    const float* __restrict__ scales, float* __restrict__ ws,
                    int M, int N, int K2, int gs, int rpb) {
  extern __shared__ __align__(16) char sk_smem[];
  uint32_t* as = reinterpret_cast<uint32_t*>(sk_smem);
  char* rings = sk_smem + rpb * 64;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q = lane % 4, g = lane / 4;
  const int col0 = blockIdx.x * kSkCols, n = col0 + 16 * g;
  const int r0 = blockIdx.y * rpb;
  const int rows = min(rpb, K2 - r0);            // a multiple of 8
  // warp w: the k-steps (8 packed rows each) [s0, s1) of the block's
  // rows, copied by cp.async kSkStages - 1 steps ahead into the warp's
  // ring (a lane reads back only its own bytes: no barrier); every lane
  // runs the mma loop, and a lane whose 16 columns lie past N reads zeros
  const int per = rpb / 64;
  const int s0 = warp * per, s1 = min(s0 + per, rows / 8);
  const bool live = n < N;
  const uint8_t* pq = packed + (long long)(r0 + q) * N + n;
  char* mine = rings + warp * kSkStages * 1024 + lane * 32;
  auto fetch = [&](int st) {
    const bool ok = live && st < s1;
    char* dst = mine + (st - s0) % kSkStages * 1024;
    tl_gemm::cp_async16(dst, ok ? pq + 8LL * st * N : packed, ok);
    tl_gemm::cp_async16(dst + 16, ok ? pq + (8LL * st + 4) * N : packed, ok);
    tl_gemm::cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kSkStages - 1; ++i) fetch(s0 + i);
  // A's pairs (A[m, r0 + r], A[m, K2 + r0 + r]) of rows m < 8 NT (0 past M)
  const long long K = 2LL * K2;
  for (int i = threadIdx.x; i < rows / 8 * 8 * NT; i += kThreads) {
    const int m = i % (8 * NT), r = (i / (8 * NT)) * 8;
    uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
    if (m < M) {
      lo = __ldg(reinterpret_cast<const uint4*>(a + m * K + r0 + r));
      hi = __ldg(reinterpret_cast<const uint4*>(a + m * K + K2 + r0 + r));
    }
    const uint32_t l[4] = {lo.x, lo.y, lo.z, lo.w};
    const uint32_t h[4] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int e = 0; e < 8; ++e)
      as[pair_at(r + e, m)] = __byte_perm(l[e / 2], h[e / 2],
                                          e % 2 ? 0x7632 : 0x5410);
  }
  __syncthreads();

  // acc[t][nt]: columns 16 g + 2 t (c0, c1) and 16 g + 2 t + 1 (c2, c3)
  // of A's rows 8 nt + 2 q, + 1
  float acc[8][NT][4];
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][nt][e] = 0.f;
  const int G2 = K2 / gs;
  int grp = -1;
  float sl[16], sh[16];
  for (int st = s0; st < s1; ++st) {
    const int r = 8 * st;
    if ((r0 + r) / gs != grp) {
      grp = (r0 + r) / gs;
      const float4* lo4 = reinterpret_cast<const float4*>(
          scales + (long long)grp * N + n);
      const float4* hi4 = reinterpret_cast<const float4*>(
          scales + (long long)(G2 + grp) * N + n);
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 x = live ? __ldg(lo4 + v) : z;
        const float4 y = live ? __ldg(hi4 + v) : z;
        sl[4 * v] = x.x, sl[4 * v + 1] = x.y, sl[4 * v + 2] = x.z,
        sl[4 * v + 3] = x.w;
        sh[4 * v] = y.x, sh[4 * v + 1] = y.y, sh[4 * v + 2] = y.z,
        sh[4 * v + 3] = y.w;
      }
    }
    unsigned bf[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      bf[nt][0] = as[pair_at(r + q, 8 * nt + g)];
      bf[nt][1] = as[pair_at(r + 4 + q, 8 * nt + g)];
    }
    tl_gemm::cp_async_wait<kSkStages - 2>();    // this step's bytes
    const char* got = mine + (st - s0) % kSkStages * 1024;
    const uint4 v0 = *reinterpret_cast<const uint4*>(got);
    const uint4 v1 = *reinterpret_cast<const uint4*>(got + 16);
    fetch(st + kSkStages - 1);    // into the slot read one step ago
    const uint32_t w0[4] = {v0.x, v0.y, v0.z, v0.w};
    const uint32_t w1[4] = {v1.x, v1.y, v1.z, v1.w};
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const Nibbles x0(w0[v]), x1(w1[v]);
#pragma unroll
      for (int u = 0; u < 2; ++u) {          // tile t = 2 v + u
        const int t = 2 * v + u, j0 = 2 * u, j1 = 2 * u + 1;
        // slot g: column 16 g + 2 t (byte j0), slot g + 8: 2 t + 1
        const unsigned af[4] = {
            pack2<T>(nib(x0.lo, j0) * sl[2 * t], nib(x0.hi, j0) * sh[2 * t]),
            pack2<T>(nib(x0.lo, j1) * sl[2 * t + 1],
                     nib(x0.hi, j1) * sh[2 * t + 1]),
            pack2<T>(nib(x1.lo, j0) * sl[2 * t], nib(x1.hi, j0) * sh[2 * t]),
            pack2<T>(nib(x1.lo, j1) * sl[2 * t + 1],
                     nib(x1.hi, j1) * sh[2 * t + 1])};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          bf16::mma<T>(acc[t][nt], af, bf[nt][0], bf[nt][1]);
      }
    }
  }

  // the warps' sums in a fixed tree: (w, w + 4), (w, w + 2), (0, 1), in
  // the rings' space
  constexpr int kVals = 8 * NT * 4;
  tl_gemm::cp_async_wait<0>();
  float* red = reinterpret_cast<float*>(rings);
  float* flat = &acc[0][0][0];
  auto put = [&](int slot) {
#pragma unroll
    for (int i = 0; i < kVals; ++i)
      red[(slot * kVals + i) * 32 + lane] = flat[i];
  };
  auto add = [&](int slot) {
#pragma unroll
    for (int i = 0; i < kVals; ++i)
      flat[i] += red[(slot * kVals + i) * 32 + lane];
  };
  __syncthreads();
  if (warp >= 4) put(warp - 4);
  __syncthreads();
  if (warp < 4) add(warp);
  __syncthreads();
  if (warp == 2 || warp == 3) put(warp - 2);
  __syncthreads();
  if (warp < 2) add(warp);
  __syncthreads();
  if (warp == 1) put(0);
  __syncthreads();
  if (warp != 0) return;
  add(0);
  if (!live) return;
  // lane (q, g): A's rows 8 nt + 2 q + e, columns 16 g .. 16 g + 15
  float* out = ws + (long long)blockIdx.y * M * N + n;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = 8 * nt + 2 * q + e;
      if (m >= M) continue;
      float4* o = reinterpret_cast<float4*>(out + (long long)m * N);
#pragma unroll
      for (int v = 0; v < 4; ++v)
        o[v] = make_float4(acc[2 * v][nt][e], acc[2 * v][nt][2 + e],
                           acc[2 * v + 1][nt][e], acc[2 * v + 1][nt][2 + e]);
    }
}

template <typename T, int NT>
int launch_splitk_nt(const T* a, const uint8_t* packed, const float* scales,
                     float* ws, int M, int N, int K2, int gs, int rpb,
                     int splits, cudaStream_t s) {
  const int bytes = sk_smem_bytes(rpb);
  const auto kern = dequant_gemm_splitk<T, NT>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return (int)attr;
  kern<<<dim3((N + kSkCols - 1) / kSkCols, splits), kThreads, bytes, s>>>(
      a, packed, scales, ws, M, N, K2, gs, rpb);
  return (int)cudaGetLastError();
}

// NT n8 tiles of A's rows: one up to 8 rows, two up to 16
template <typename T>
int launch_splitk(const T* a, const uint8_t* packed, const float* scales,
                  float* ws, int M, int N, int K2, int gs, int rpb,
                  int splits, cudaStream_t s) {
  if (M <= 8)
    return launch_splitk_nt<T, 1>(a, packed, scales, ws, M, N, K2, gs, rpb,
                                  splits, s);
  return launch_splitk_nt<T, 2>(a, packed, scales, ws, M, N, K2, gs, rpb,
                                splits, s);
}

// C (M, N) = the sum of ws's splits, split 0 first, rounded to T; four
// elements a thread (N a multiple of 16)
template <typename T>
__global__ void __launch_bounds__(kThreads)
dequant_splitk_combine(const float* __restrict__ ws, T* __restrict__ c,
                       long long quads, int splits) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= quads) return;
  const float4* w = reinterpret_cast<const float4*>(ws);
  float4 s = w[i];
  for (int k = 1; k < splits; ++k) {
    const float4 x = w[k * quads + i];
    s.x += x.x;
    s.y += x.y;
    s.z += x.z;
    s.w += x.w;
  }
  *reinterpret_cast<uint2*>(c + 4 * i) =
      make_uint2(pack2<T>(s.x, s.y), pack2<T>(s.z, s.w));
}

// ---------------------------------------------------------------------------
// w4a16 at more rows: TMA + wgmma with the unpack in the kernel
// ---------------------------------------------------------------------------

// TM x TN block tile, TK2 packed rows a stage (A boxes of TK2 elements:
// the 128-byte swizzle at 64, the 64-byte one at 32); each consumer owns
// TM / 2 rows, MI = TM / 128 m64 slices
template <typename T, int TM, int TN, int TK2>
struct W4Tma {
  static constexpr int kTM = TM, kTN = TN, kTK2 = TK2;
  static constexpr int MI = TM / 128;
  static constexpr int kAh = TM * TK2 * 2;     // one half's A box
  static constexpr int kRaw = 2 * kAh + TK2 * TN;
  static constexpr int kBh = TK2 * TN * 2;     // one half's B tile
  static constexpr int kCvt = 2 * kBh;
  static constexpr int kLdC = TN + 8;          // staged C row, floats
  static constexpr int kEpi = TM * kLdC * 4;
  static constexpr int kC8 = TN / 8;           // 8-column groups
  static constexpr int kRowStep = 256 / kC8;   // rows a pass of threads
  static_assert(TK2 % kRowStep == 0, "a stage's rows split unevenly");
  CUtensorMap ma, mp;
  const float* scales;
  T* c;
  int M, N, K2, gs;

  __device__ __forceinline__ int k_tiles() const { return K2 / TK2; }

  __device__ __forceinline__ void issue(char* st, uint64_t* bar, int kt,
                                        int m0, int n0) const {
    tl_sm90::tma_load(st, &ma, bar, kt * TK2, m0);
    tl_sm90::tma_load(st + kAh, &ma, bar, K2 + kt * TK2, m0);
    tl_sm90::tma_load(st + 2 * kAh, &mp, bar, n0, kt * TK2);
  }

  struct Acc {
    float d[MI][TN / 2];
    __device__ __forceinline__ void zero() {
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int i = 0; i < TN / 2; ++i) d[mi][i] = 0.f;
    }
    __device__ __forceinline__ void fence() {
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) tl_sm90::fence_regs(d[mi]);
    }
  };

  // thread t: columns 8 c8 .. 8 c8 + 7 (c8 = t % kC8), packed rows t /
  // kC8 + kRowStep i; the 16 scales of its columns, loaded when the group
  // changes
  struct Conv {
    const float* lo;
    const float* hi;
    int c8, r0, N, tiles_a_group, g;
    bool live;
    float sl[8], sh[8];
    __device__ __forceinline__ Conv(const W4Tma& p, int n0, int t)
        : c8(t % kC8), r0(t / kC8), N(p.N), tiles_a_group(p.gs / TK2),
          g(-1) {
      const int n = n0 + 8 * c8;
      live = n < p.N;
      lo = p.scales + n;
      hi = p.scales + (long long)(p.K2 / p.gs) * p.N + n;
    }
    __device__ __forceinline__ void operator()(const char* st, char* cvt,
                                               int kt) {
      if (kt / tiles_a_group != g) {
        g = kt / tiles_a_group;
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
          const float4 x = live ? __ldg(reinterpret_cast<const float4*>(
                                      lo + (long long)g * N) + v) : z;
          const float4 y = live ? __ldg(reinterpret_cast<const float4*>(
                                      hi + (long long)g * N) + v) : z;
          sl[4 * v] = x.x, sl[4 * v + 1] = x.y, sl[4 * v + 2] = x.z,
          sl[4 * v + 3] = x.w;
          sh[4 * v] = y.x, sh[4 * v + 1] = y.y, sh[4 * v + 2] = y.z,
          sh[4 * v + 3] = y.w;
        }
      }
      const char* pk = st + 2 * kAh;
#pragma unroll
      for (int i = 0; i < TK2 / kRowStep; ++i) {
        const int r = r0 + kRowStep * i;
        const uint2 w = *reinterpret_cast<const uint2*>(pk + r * TN +
                                                        8 * c8);
        const Nibbles x[2] = {Nibbles(w.x), Nibbles(w.y)};
        uint32_t l[4], h[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const Nibbles& v = x[e / 2];
          const int j = 2 * (e % 2);
          l[e] = pack2<T>(nib(v.lo, j) * sl[2 * e],
                          nib(v.lo, j + 1) * sl[2 * e + 1]);
          h[e] = pack2<T>(nib(v.hi, j) * sh[2 * e],
                          nib(v.hi, j + 1) * sh[2 * e + 1]);
        }
        // MN-major: 64-column slices of TK2 rows of 128 bytes, swizzled
        const int at = (c8 >> 3) * (TK2 * 128) + r * 128 +
                       (((c8 & 7) ^ (r & 7)) << 4);
        *reinterpret_cast<uint4*>(cvt + at) = make_uint4(l[0], l[1], l[2],
                                                         l[3]);
        *reinterpret_cast<uint4*>(cvt + kBh + at) =
            make_uint4(h[0], h[1], h[2], h[3]);
      }
    }
  };

  __device__ __forceinline__ static void mma(Acc& acc, unsigned sa,
                                             unsigned ca, int cw) {
#pragma unroll
    for (int kk = 0; kk < TK2 / 16; ++kk) {
      const uint64_t bl = tl_sm90::mnmajor<TK2>(ca, 0, kk * 16);
      const uint64_t bh = tl_sm90::mnmajor<TK2>(ca + kBh, 0, kk * 16);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int r = cw * (TM / 2) + mi * 64;
        tl_sm90::wgmma16<T, TN, 0, 1>(
            acc.d[mi], tl_sm90::kmajor<T, TK2>(sa, r, kk * 32), bl);
        tl_sm90::wgmma16<T, TN, 0, 1>(
            acc.d[mi], tl_sm90::kmajor<T, TK2>(sa + kAh, r, kk * 32), bh);
      }
    }
  }

  // the accumulator staged as float32 rows, then each consumer's TM / 2
  // rows stored 8 elements (16 bytes) a thread (N a multiple of 16)
  __device__ __forceinline__ void epilogue(Acc& acc, char* buf, int m0,
                                           int n0, int cw) const {
    float* cs = reinterpret_cast<float*>(buf);
    const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
    const int row0 = cw * (TM / 2);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int j = 0; j < TN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + mi * 64 + 16 * w + lane / 4 + 8 * h;
          *reinterpret_cast<float2*>(cs + r * kLdC + 8 * j +
                                     2 * (lane % 4)) =
              make_float2(acc.d[mi][4 * j + 2 * h],
                          acc.d[mi][4 * j + 2 * h + 1]);
        }
    tl_sm90::named_sync(2 + cw, 128);
    for (int i = t; i < (TM / 2) * kC8; i += 128) {
      const int r = row0 + i / kC8, n = 8 * (i % kC8);
      if (m0 + r >= M || n0 + n >= N) continue;
      const float4 x = *reinterpret_cast<const float4*>(cs + r * kLdC + n);
      const float4 y =
          *reinterpret_cast<const float4*>(cs + r * kLdC + n + 4);
      *reinterpret_cast<uint4*>(c + (long long)(m0 + r) * N + n0 + n) =
          make_uint4(pack2<T>(x.x, x.y), pack2<T>(x.z, x.w),
                     pack2<T>(y.x, y.y), pack2<T>(y.z, y.w));
    }
  }
};

template <typename T, int TM, int TN, int TK2>
int launch_w4_tma(const void* a, const void* packed, const float* scales,
                  void* c, int M, int N, int K2, int gs, int type,
                  cudaStream_t s) {
  using P = W4Tma<T, TM, TN, TK2>;
  P p;
  const bool ok =
      tl_sm90::make_map(&p.ma, a, type, M, 2LL * K2, 2LL * K2, TK2, TM) &&
      tl_lowbit::make_map_bytes(&p.mp, packed, K2, N, N, TN, TK2, false);
  if (!ok) return (int)cudaErrorInvalidValue;
  p.scales = scales;
  p.c = static_cast<T*>(c);
  p.M = M;
  p.N = N;
  p.K2 = K2;
  p.gs = gs;
  return tl_lowbit::launch_cvt(p, s);
}

// the w4a16 TMA tiles (TM, TN, TK2) tl_dequant_gemm_wgmma takes
// (ops/dequant_gemm.py::dequant_wgmma_tile chooses by M)
#define TL_W4_TILES(X) \
  X(128, 128, 64)      \
  X(256, 128, 32)

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError() (0 =
// launched); the Python wrapper checks shapes, types, devices, the group
// size and the grid's range before calling.

// a (M, 2 K2) of the type code `type` (kF32, kBF16 or kF16), packed
// (K2, N) u8, scales (2 K2 / gs, N) f32, c (M, N) in a's type
extern "C" int tl_dequant_gemm(const void* a, const void* packed,
                               const float* scales, void* c, int M, int N,
                               int K2, int gs, int type, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int v = type == kF32 ? 4 : 8;
  const int vec_a = aligned(a) && K2 % v == 0;
  const int vec_p = aligned(packed) && N % 16 == 0;
  const auto* p = static_cast<const uint8_t*>(packed);
  if (type == kBF16)
    dequant_gemm_h16<<<tile_count(M, N), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a), p, scales,
        static_cast<__nv_bfloat16*>(c), M, N, K2, gs, vec_a, vec_p);
  else if (type == kF16)
    dequant_gemm_h16<<<tile_count(M, N), kThreads, 0, s>>>(
        static_cast<const __half*>(a), p, scales, static_cast<__half*>(c), M,
        N, K2, gs, vec_a, vec_p);
  else
    dequant_gemm_f32<<<tile_count(M, N), kThreads, 0, s>>>(
        static_cast<const float*>(a), p, scales, static_cast<float*>(c), M,
        N, K2, gs, vec_a, vec_p);
  return (int)cudaGetLastError();
}

// packed (K2, N) u8, scales (2 K2 / gs, N) f32 -> out (2 K2, N) of the
// type code `type` (kF32, kBF16 or kF16)
extern "C" int tl_dequant_int4(const void* packed, const float* scales,
                               void* out, int K2, int N, int gs, int type,
                               void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const uint8_t*>(packed);
  const bool v8 = N % 8 == 0 && aligned(packed) && aligned(scales) &&
                  aligned(out);
  const int per_block = kThreads * (v8 ? 8 : 1);
  const dim3 grid((N + per_block - 1) / per_block, min(K2, 65535));
  if (type == kBF16) {
    auto* o = static_cast<__nv_bfloat16*>(out);
    if (v8)
      dequant_int4<__nv_bfloat16, 8><<<grid, kThreads, 0, s>>>(p, scales, o,
                                                               K2, N, gs);
    else
      dequant_int4<__nv_bfloat16, 1><<<grid, kThreads, 0, s>>>(p, scales, o,
                                                               K2, N, gs);
  } else if (type == kF16) {
    auto* o = static_cast<__half*>(out);
    if (v8)
      dequant_int4<__half, 8><<<grid, kThreads, 0, s>>>(p, scales, o, K2, N,
                                                        gs);
    else
      dequant_int4<__half, 1><<<grid, kThreads, 0, s>>>(p, scales, o, K2, N,
                                                        gs);
  } else {
    auto* o = static_cast<float*>(out);
    if (v8)
      dequant_int4<float, 8><<<grid, kThreads, 0, s>>>(p, scales, o, K2, N,
                                                       gs);
    else
      dequant_int4<float, 1><<<grid, kThreads, 0, s>>>(p, scales, o, K2, N,
                                                       gs);
  }
  return (int)cudaGetLastError();
}

// a (M, 2 K2) int8, packed (K2, N) u8, sw (N,) f32, sa (M,) f32 -> c
// (M, N) f32
extern "C" int tl_w4a8_gemm(const void* a, const void* packed,
                            const float* sw, const float* sa, float* c,
                            int M, int N, int K2, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int vec_a = aligned(a) && K2 % 16 == 0;
  const int vec_p = aligned(packed) && N % 16 == 0;
  w4a8_gemm<<<tile_count(M, N), kThreads, 0, s>>>(
      static_cast<const int8_t*>(a), static_cast<const uint8_t*>(packed), sw,
      sa, c, M, N, K2, vec_a, vec_p);
  return (int)cudaGetLastError();
}

// w4a16 at up to 16 rows: a (M, 2 K2), packed (K2, N), scales (2 K2 /
// gs, N), all 16-byte aligned, N a multiple of 16, gs of 8, type kBF16
// or kF16 -> ws (splits, M, N) float32 partials; grid (ceil(N / 128),
// splits), rows_per_block packed rows a block (a multiple of 64, at most
// 768; ops/dequant_gemm.py::dequant_splitk_plan)
extern "C" int tl_dequant_gemm_splitk(const void* a, const void* packed,
                                      const float* scales, float* ws, int M,
                                      int N, int K2, int gs,
                                      int rows_per_block, int splits,
                                      int type, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const uint8_t*>(packed);
  if (type == kBF16)
    return launch_splitk(static_cast<const __nv_bfloat16*>(a), p, scales, ws,
                         M, N, K2, gs, rows_per_block, splits, s);
  if (type == kF16)
    return launch_splitk(static_cast<const __half*>(a), p, scales, ws, M, N,
                         K2, gs, rows_per_block, splits, s);
  return (int)cudaErrorInvalidValue;
}

// c (M, N) of the type code `type` (kBF16 or kF16) = the sum of ws
// (splits, M, N) float32 over its splits in order (N a multiple of 16)
extern "C" int tl_dequant_splitk_combine(const float* ws, void* c, int M,
                                         int N, int splits, int type,
                                         void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const long long quads = (long long)M * N / 4;
  const unsigned blocks = (unsigned)((quads + kThreads - 1) / kThreads);
  if (type == kBF16)
    dequant_splitk_combine<<<blocks, kThreads, 0, s>>>(
        ws, static_cast<__nv_bfloat16*>(c), quads, splits);
  else if (type == kF16)
    dequant_splitk_combine<<<blocks, kThreads, 0, s>>>(
        ws, static_cast<__half*>(c), quads, splits);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// w4a16 at more rows at the tile (tm, tn, tk2) of TL_W4_TILES: a (M, 2
// K2), packed (K2, N), scales, c, all 16-byte aligned, N a multiple of
// 16, gs a multiple of tk2, type kBF16 or kF16 -> c (M, N) in a's type.
// cudaErrorInvalidValue for another tile or type, or when a tensor map is
// refused.
extern "C" int tl_dequant_gemm_wgmma(const void* a, const void* packed,
                                     const float* scales, void* c, int M,
                                     int N, int K2, int gs, int type, int tm,
                                     int tn, int tk2, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
#define TL_W4_CASE(m, n, k)                                                \
  if (tm == m && tn == n && tk2 == k) {                                    \
    if (type == kBF16)                                                     \
      return launch_w4_tma<__nv_bfloat16, m, n, k>(a, packed, scales, c, M, \
                                                   N, K2, gs, type, s);    \
    if (type == kF16)                                                      \
      return launch_w4_tma<__half, m, n, k>(a, packed, scales, c, M, N, K2, \
                                            gs, type, s);                  \
  }
  TL_W4_TILES(TL_W4_CASE)
#undef TL_W4_CASE
  return (int)cudaErrorInvalidValue;
}
