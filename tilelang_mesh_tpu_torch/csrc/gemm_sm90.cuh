// The dense GEMM body for Hopper (sm_90a) that gemm.cu (#15, its TMA
// path) and yardstick_gemm.cu (#42) share: one output tile of
// C = op(A) @ op(B) a block, operands brought by TMA, products on
// wgmma.mma_async, a float32 accumulator in registers.
//
// A block of 384 threads: warpgroup 0 is the producer, warpgroups 1 and
// 2 the consumers, each owning TM / 2 rows of the TM x TN tile. One
// thread of the producer walks the K tiles: it waits for a stage of the
// shared-memory ring to be empty, arms the stage's full barrier with the
// stage's bytes and issues the TMA loads of A's (TM x TK) and B's (TK x
// TN) tiles into it. The consumers wait on the stage's full barrier, run
// their wgmmas on it, and arrive on its empty barrier (a warp each) once
// their products have read it. setmaxnreg moves registers from the
// producer (40) to the consumers (232).
//
// Operands in shared memory are in wgmma's canonical swizzled layouts,
// as TMA writes them:
//   K-major (A (M, K) row-major, B as (N, K)): a row of TK elements
//     (TK * 2 bytes: 128 or 64) with the swizzle of that width; one box
//     of TK x rows a tile. A wgmma reads 32 bytes of K (k16) at 32-byte
//     steps inside the row.
//   MN-major (A as (K, M), B (K, N) row-major): rows of 64 elements (128
//     bytes) of M or N, one per k, 128-byte swizzle; one box of 64 x TK
//     a 64-wide slice of the tile. LBO is the slices' stride, SBO the
//     1024 bytes of 8 k-rows.
//
// bfloat16 and float16 operands: wgmma m64nTNk16 (TN 128 or 256), each
// consumer one or two m64 slices, all of a stage's products issued and
// committed together, the stage released when the next stage's group is
// issued (wgmma.wait_group 1). fp8 e4m3 operands arrive widened to
// float16 (exact: 3 mantissa bits, exponents inside float16's) by the
// wrapper's pre-pass (gemm.cu's tl_widen_e4m3) and run the float16
// path: the fp8 wgmma (m64n128k32 .e4m3) keeps too few bits of its own
// 32-product sums for the float32 contract (4.4e-5 of max |C| from the
// exact sums at K 4096 with every product promoted into a float32
// accumulator, against the 1e-5 the GEMM is held to; PERF.md §6).
//
// TMA's zero fill handles ragged M, N and K: rows past M, columns past N
// and depth past K arrive as zeros and are never stored. The epilogue
// stages the accumulator through the (then idle) ring as float32 rows,
// then each consumer stores its rows a coalesced row at a time (ReLU,
// gemm_tile.cuh's rounding store of C's type, NaN past +-448 in e4m3).
//
// The host side builds the tensor maps with cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint (no -lcuda), and passes them
// as __grid_constant__ kernel parameters.

#pragma once

#include <cuda.h>

#include "gemm_dense.cuh"

// (TM, TN, TK): carver/roller.py's KERNEL_BLOCKS, the instances of both
// sources
#define TL_SM90_BLOCKS(X) \
  X(128, 128, 32)         \
  X(128, 128, 64)         \
  X(128, 256, 32)         \
  X(128, 256, 64)         \
  X(256, 128, 32)         \
  X(256, 128, 64)

namespace tl_sm90 {

using tl_gemm::smem_addr;
using tl_gemm::tile_of;

constexpr int kThreads = 384;            // producer + two consumers
constexpr int kSmemOptin = 232448;       // a block's opt-in shared memory
constexpr int kMaxStages = 8;

template <typename T, int TM, int TN, int TK>
struct Cfg {
  static constexpr int kStageA = TM * TK * (int)sizeof(T);
  static constexpr int kStageB = TN * TK * (int)sizeof(T);
  static constexpr int kStage = kStageA + kStageB;
  static constexpr int kStages =
      (kSmemOptin - 2048) / kStage < kMaxStages
          ? (kSmemOptin - 2048) / kStage : kMaxStages;
  static constexpr int kLdC = TN + 8;          // staged C rows, floats
  static constexpr int kCBytes = TM * kLdC * 4;
  static constexpr int kBuf =
      kStages * kStage > kCBytes ? kStages * kStage : kCBytes;
  // the ring (or staged C), its barriers, and room to align to 1024
  static constexpr int kSmem = kBuf + 2 * kStages * 8 + 1024;
  static_assert(kStages >= 2, "a tile's stage does not fit twice");
  static_assert(kSmem <= kSmemOptin, "tile past shared memory");
};

// ---------------------------------------------------------------------------
// mbarrier, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// until the phase of parity `parity` has completed; a wait past 2^34
// cycles (seconds) traps, so a lost arrival fails the launch instead of
// hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1LL << 34)) __trap();
  } while (!done);
}

// the box at (c0 inner, c1 outer) of `map` into dst, completing on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads of wgmma results above the wait
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// a shared-memory matrix descriptor: start, LBO, SBO (bytes) and the
// swizzle of `swizzle` bytes (128 or 64)
__device__ __forceinline__ uint64_t make_desc(unsigned addr, unsigned lbo,
                                              unsigned sbo, int swizzle) {
  const uint64_t layout = swizzle == 128 ? 1 : 2;
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

#define TL_D64                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "                \
  "%8, %9, %10, %11, %12, %13, %14, %15, "           \
  "%16, %17, %18, %19, %20, %21, %22, %23, "         \
  "%24, %25, %26, %27, %28, %29, %30, %31, "         \
  "%32, %33, %34, %35, %36, %37, %38, %39, "         \
  "%40, %41, %42, %43, %44, %45, %46, %47, "         \
  "%48, %49, %50, %51, %52, %53, %54, %55, "         \
  "%56, %57, %58, %59, %60, %61, %62, %63}"
#define TL_D128                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "                \
  "%8, %9, %10, %11, %12, %13, %14, %15, "           \
  "%16, %17, %18, %19, %20, %21, %22, %23, "         \
  "%24, %25, %26, %27, %28, %29, %30, %31, "         \
  "%32, %33, %34, %35, %36, %37, %38, %39, "         \
  "%40, %41, %42, %43, %44, %45, %46, %47, "         \
  "%48, %49, %50, %51, %52, %53, %54, %55, "         \
  "%56, %57, %58, %59, %60, %61, %62, %63, "         \
  "%64, %65, %66, %67, %68, %69, %70, %71, "         \
  "%72, %73, %74, %75, %76, %77, %78, %79, "         \
  "%80, %81, %82, %83, %84, %85, %86, %87, "         \
  "%88, %89, %90, %91, %92, %93, %94, %95, "         \
  "%96, %97, %98, %99, %100, %101, %102, %103, "     \
  "%104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, " \
  "%120, %121, %122, %123, %124, %125, %126, %127}"
#define TL_F8(i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),        \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define TL_F64                                                         \
  TL_F8(0), TL_F8(8), TL_F8(16), TL_F8(24), TL_F8(32), TL_F8(40),      \
      TL_F8(48), TL_F8(56)
#define TL_F128                                                        \
  TL_F64, TL_F8(64), TL_F8(72), TL_F8(80), TL_F8(88), TL_F8(96),       \
      TL_F8(104), TL_F8(112), TL_F8(120)

// d += A B, one m64nNk16 product of 16-bit operands; TA / TB: A / B
// MN-major
#define TL_WGMMA16(N, TY, DREGS, DLIST, IA, IB, IS, ITA, ITB)             \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IS ", 0;\n"            \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY \
               " " DREGS ", %" IA ", %" IB ", p, 1, 1, %" ITA ", %" ITB    \
               ";\n}\n"                                                    \
               : DLIST                                                     \
               : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB))

template <typename T, int N, int TA, int TB>
__device__ __forceinline__ void wgmma16(float (&d)[N / 2], uint64_t a,
                                        uint64_t b) {
  if constexpr (N == 128 && std::is_same_v<T, __half>)
    TL_WGMMA16(128, "f16", TL_D64, TL_F64, "64", "65", "66", "67", "68");
  else if constexpr (N == 128)
    TL_WGMMA16(128, "bf16", TL_D64, TL_F64, "64", "65", "66", "67", "68");
  else if constexpr (std::is_same_v<T, __half>)
    TL_WGMMA16(256, "f16", TL_D128, TL_F128, "128", "129", "130", "131",
               "132");
  else
    TL_WGMMA16(256, "bf16", TL_D128, TL_F128, "128", "129", "130", "131",
               "132");
}

#undef TL_WGMMA16
#undef TL_F128
#undef TL_F64
#undef TL_F8
#undef TL_D128
#undef TL_D64

// ---------------------------------------------------------------------------
// the consumers' main loops
// ---------------------------------------------------------------------------

// the descriptor of a K-major operand's `row`-th row at byte `kb` of K
// in a stage tile of TK-element rows
template <typename T, int TK>
__device__ __forceinline__ uint64_t kmajor(unsigned base, int row, int kb) {
  constexpr int row_bytes = TK * (int)sizeof(T);
  return make_desc(base + row * row_bytes + kb, 16, 8 * row_bytes,
                   row_bytes);
}

// the descriptor of an MN-major operand's 64-wide slice `slice` (and
// the next ones, LBO apart) at k-row k
template <int TK>
__device__ __forceinline__ uint64_t mnmajor(unsigned base, int slice,
                                            int k) {
  return make_desc(base + slice * TK * 128 + k * 128, TK * 128, 1024, 128);
}

// 16-bit operands: the consumer's MI m64 slices from `row0`, all TN
// columns; A MN-major when TA, B MN-major when TB
template <typename T, int TM, int TN, int TK, int TA, int TB>
__device__ __forceinline__ void mainloop16(float (&acc)[TM / 128][TN / 2],
                                           char* buf, uint64_t* full,
                                           uint64_t* empty, int nk,
                                           int row0) {
  using C = Cfg<T, TM, TN, TK>;
  constexpr int MI = TM / 128;
  const bool lead = threadIdx.x % 32 == 0;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % C::kStages;
    mbar_wait(&full[s], (kt / C::kStages) & 1);
    const unsigned a_base = smem_addr(buf + s * C::kStage);
    const unsigned b_base = a_base + C::kStageA;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      const uint64_t db = TB ? mnmajor<TK>(b_base, 0, kk * 16)
                             : kmajor<T, TK>(b_base, 0, kk * 32);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int r = row0 + mi * 64;
        const uint64_t da = TA ? mnmajor<TK>(a_base, r / 64, kk * 16)
                               : kmajor<T, TK>(a_base, r, kk * 32);
        wgmma16<T, TN, TA, TB>(acc[mi], da, db);
      }
    }
    wg_commit();
    wg_wait<1>();            // the previous stage's products are done
    if (kt > 0 && lead) mbar_arrive(&empty[(kt - 1) % C::kStages]);
  }
  wg_wait<0>();
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) fence_regs(acc[mi]);
}

// A consumer's TM / 2 staged rows from `row0` (rows of LDC floats at
// cs) into C of element type O, a row at a time: ReLU on the
// accumulator (NaN stays NaN), then gemm_tile.cuh's rounding store;
// rows past `rows` and columns past N are not stored. One loop a type:
// store_as's out-of-line float16 / fp8 stores cost a call an element.
template <int TM, int TN, int LDC, typename O>
__device__ __forceinline__ void store_rows(O* c, const float* cs, int rows,
                                           int row0, int m0, int n0, int N,
                                           int relu) {
  for (int i = threadIdx.x % 128; i < (TM / 2) * TN; i += 128) {
    const int r = row0 + i / TN, n = n0 + i % TN;
    if (r >= rows || n >= N) continue;
    float v = cs[r * LDC + i % TN];
    if (relu && v < 0.f) v = 0.f;
    tl_gemm::store(c + (long long)(m0 + r) * N + n, v);
  }
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// C (M, N) = op(A) op(B) through the maps `ma` (A's tiles: K-major, or
// MN-major when a_mn) and `mb` (B's: K-major, or MN-major when b_mn);
// C row-major in the float type `out`, ReLU when relu.
template <typename T, int TM, int TN, int TK>
__global__ void __launch_bounds__(kThreads, 1)
gemm_tma(const __grid_constant__ CUtensorMap ma,
         const __grid_constant__ CUtensorMap mb, void* __restrict__ c, int M,
         int N, int K, int a_mn, int b_mn, int out, int relu) {
  using C = Cfg<T, TM, TN, TK>;
  extern __shared__ __align__(1024) char smem_raw[];
  char* buf = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(buf + C::kBuf);
  uint64_t* empty = full + C::kStages;
  int mt, nt;
  tile_of(blockIdx.x, (M + TM - 1) / TM, (N + TN - 1) / TN, mt, nt);
  const int m0 = mt * TM, n0 = nt * TN;
  const int nk = (K + TK - 1) / TK;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);           // a consumer warp each
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {                          // producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % C::kStages;
        mbar_wait(&empty[s], ((kt / C::kStages) & 1) ^ 1);
        char* sa = buf + s * C::kStage;
        char* sb = sa + C::kStageA;
        mbar_expect_tx(&full[s], C::kStage);
        const int k0 = kt * TK;
        if (a_mn)
          for (int i = 0; i < TM / 64; ++i)
            tma_load(sa + i * TK * 128, &ma, &full[s], m0 + 64 * i, k0);
        else
          tma_load(sa, &ma, &full[s], k0, m0);
        if (b_mn)
          for (int j = 0; j < TN / 64; ++j)
            tma_load(sb + j * TK * 128, &mb, &full[s], n0 + 64 * j, k0);
        else
          tma_load(sb, &mb, &full[s], k0, n0);
      }
    }
    return;
  }

  setmaxnreg_inc<232>();                  // consumers
  constexpr int MI = TM / 128;
  const int cw = wg - 1;
  const int row0 = cw * (TM / 2);
  float acc[MI][TN / 2];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int e = 0; e < TN / 2; ++e) acc[mi][e] = 0.f;
  if (a_mn) {
    if (b_mn)
      mainloop16<T, TM, TN, TK, 1, 1>(acc, buf, full, empty, nk, row0);
    else
      mainloop16<T, TM, TN, TK, 1, 0>(acc, buf, full, empty, nk, row0);
  } else if (b_mn) {
    mainloop16<T, TM, TN, TK, 0, 1>(acc, buf, full, empty, nk, row0);
  } else {
    mainloop16<T, TM, TN, TK, 0, 0>(acc, buf, full, empty, nk, row0);
  }

  // epilogue: both consumers past the ring, then each stages its rows
  // as float32 and stores them a row at a time
  named_sync(1, 256);
  float* cs = reinterpret_cast<float*>(buf);
  const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int j = 0; j < TN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + mi * 64 + 16 * w + lane / 4 + 8 * h;
        *reinterpret_cast<float2*>(cs + r * C::kLdC + 8 * j +
                                   2 * (lane % 4)) =
            make_float2(acc[mi][4 * j + 2 * h], acc[mi][4 * j + 2 * h + 1]);
      }
  named_sync(2 + cw, 128);
  const int rows = min(TM, M - m0);
  constexpr int L = C::kLdC;
  if (out == tl_gemm::kF32)
    store_rows<TM, TN, L>(static_cast<float*>(c), cs, rows, row0, m0, n0, N,
                          relu);
  else if (out == tl_gemm::kBF16)
    store_rows<TM, TN, L>(static_cast<__nv_bfloat16*>(c), cs, rows, row0,
                          m0, n0, N, relu);
  else if (out == tl_gemm::kF16)
    store_rows<TM, TN, L>(static_cast<__half*>(c), cs, rows, row0, m0, n0,
                          N, relu);
  else
    store_rows<TM, TN, L>(static_cast<__nv_fp8_e4m3*>(c), cs, rows, row0,
                          m0, n0, N, relu);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time, or null
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The (rows x cols) row-major matrix at `base` (row stride ld elements
// of the DType `type`, kBF16 or kF16) as a map of (box_cols x box_rows)
// boxes with the swizzle of box_cols' bytes (128 or 64); false when the
// map is refused
inline bool make_map(CUtensorMap* map, const void* base, int type,
                     long long rows, long long cols, long long ld,
                     int box_cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const CUtensorMapDataType dt = type == tl_gemm::kBF16
                                     ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  const int esize = 2;
  const CUtensorMapSwizzle swz = box_cols * esize == 128
                                     ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : CU_TENSOR_MAP_SWIZZLE_64B;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(ld * esize)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  return encode(map, dt, 2, const_cast<void*>(base), dims, strides, box,
                step, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launches gemm_tma<T, TM, TN, TK> on `s`: A (M, K) with row stride lda,
// or (K, M) when a_mn; B (N, K) with row stride ldb, or (K, N) when
// b_mn. Returns cudaGetLastError(), or cudaErrorInvalidValue when a map
// is refused.
template <typename T, int TM, int TN, int TK>
int launch_tma(const void* a, const void* b, void* c, int M, int N, int K,
               long long lda, long long ldb, int type, int a_mn, int b_mn,
               int out, int relu, cudaStream_t s) {
  using C = Cfg<T, TM, TN, TK>;
  CUtensorMap ma, mb;
  const bool ok =
      (a_mn ? make_map(&ma, a, type, K, M, lda, 64, TK)
            : make_map(&ma, a, type, M, K, lda, TK, TM)) &&
      (b_mn ? make_map(&mb, b, type, K, N, ldb, 64, TK)
            : make_map(&mb, b, type, N, K, ldb, TK, TN));
  if (!ok) return (int)cudaErrorInvalidValue;
  // set on every launch: a function-local static here would be one
  // object across the libraries that include this header
  const auto kern = gemm_tma<T, TM, TN, TK>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (attr != cudaSuccess) return (int)attr;
  const unsigned tiles = (unsigned)((M + TM - 1) / TM) *
                         (unsigned)((N + TN - 1) / TN);
  kern<<<tiles, kThreads, C::kSmem, s>>>(ma, mb, c, M, N, K, a_mn, b_mn,
                                          out, relu);
  return (int)cudaGetLastError();
}

// launch_tma at the block (bm, bn, bk) of TL_SM90_BLOCKS for the DType
// `type` (kBF16 or kF16); cudaErrorInvalidValue for another. A template,
// so that a source including this header for its primitives alone
// (lowbit_sm90.cuh's users) compiles none of the instances.
template <int = 0>
int dispatch_tma(const void* a, const void* b, void* c, int M, int N,
                        int K, long long lda, long long ldb, int type,
                        int a_mn, int b_mn, int out, int relu, int bm,
                        int bn, int bk, cudaStream_t s) {
#define TL_SM90_CASE(m, n, k)                                              \
  if (bm == m && bn == n && bk == k) {                                     \
    if (type == tl_gemm::kBF16)                                            \
      return launch_tma<__nv_bfloat16, m, n, k>(a, b, c, M, N, K, lda, ldb, \
                                                type, a_mn, b_mn, out,     \
                                                relu, s);                  \
    if (type == tl_gemm::kF16)                                             \
      return launch_tma<__half, m, n, k>(a, b, c, M, N, K, lda, ldb, type, \
                                         a_mn, b_mn, out, relu, s);        \
    return (int)cudaErrorInvalidValue;                                     \
  }
  TL_SM90_BLOCKS(TL_SM90_CASE)
#undef TL_SM90_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace tl_sm90
