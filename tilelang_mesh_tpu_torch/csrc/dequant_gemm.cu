// Low-bit GEMMs for Hopper (sm_90a): w4a16, the int4 unpack, w4a8.
//
// Replaces three TPU kernels of tilelang_mesh_tpu/ops/dequant_gemm.py.
// Weights are int4 in the planar +8-bias pack: byte (k2, n) of
// P (K/2, N) holds row k2 of B in its low nibble and row K/2 + k2 in its
// high nibble, each as q + 8; scale row g of half h is S[h G2 + g, n]
// with g = k2 / gs. One packed tile therefore feeds two products, the
// low half of A's columns with the low nibbles and the high half with
// the high ones.
//   dequant_gemm_kernel (:62) -> tl_dequant_gemm (w4a16, fused)
//     C (M, N) = A (M, K) @ B, A float32, bfloat16 or float16, C in A's
//     type. The
//     k-tile of the block tile loop is BK/2 packed rows: its A tile is
//     the two (128 x BK/2) windows at k0 and K/2 + k0, its B tile the
//     low and the high nibbles of one packed (BK/2 x 128) tile, each
//     ((b & 0xF) - 8) * s in float32 and rounded to A's type before the
//     product, as the TPU kernel's B_lo / B_hi fragments of A's type are.
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
// 1.4 GFLOP: bytes bound it (7.3 us); a 128-row block tile leaves 112 of
// its rows idle there and one block a column panel walks the whole of K,
// which is correct but far from the bound (split-K is later work). The
// unpack is bytes: K/2 N in, 2 K/2 N out and the scales.

#include "gemm_tile.cuh"

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
