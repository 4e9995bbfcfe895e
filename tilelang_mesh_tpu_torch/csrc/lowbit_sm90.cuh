// The low-bit GEMMs' body for many rows on Hopper (sm_90a): gemm_sm90.cuh's
// TMA + wgmma pipeline with a converting stage, shared by bitnet_gemm.cu
// (#26, int8 x ternary) and dequant_gemm.cu (#22, w4a16; #24, w4a8).
//
// A block of 384 threads computes one TM x TN tile of C. Warpgroup 0 is
// the producer: one thread walks the K tiles, waits for a ring stage to
// be empty, arms its full barrier with the stage's bytes and issues the
// policy's TMA loads into it -- the activations' tile(s), already in
// wgmma's canonical swizzled layout, and the raw packed weight rows.
// Warpgroups 1 and 2 are the consumers; each owns TM / 2 rows of the tile
// and also converts. The choice: the consumers convert, not the
// producer's idle warps. wgmma is asynchronous, so a consumer issues the
// products of stage kt and, while the tensor cores run them, unpacks the
// packed rows of stage kt + 1 into the other of two converted tiles
// (the weights in wgmma's layout, written with the 128-byte swizzle by
// plain stores): the 256 consumer threads share the unpack, and the
// producer warpgroup keeps its 40 registers. Two named barriers a k
// tile order it: the first, after each consumer's wgmma.wait_group 1,
// frees the converted tile the products of kt - 1 read; the second,
// after fence.proxy.async, publishes the tile just written to the
// products of kt + 1. A ring stage is released (a consumer warp each on
// its empty barrier) once the products that read its activations are
// done. setmaxnreg gives the consumers 232 registers.
//
// The policy P (a __grid_constant__ kernel parameter holding its tensor
// maps and operands) supplies:
//   kTM, kTN          the block tile
//   kRaw, kCvt, kEpi  bytes of a ring stage, of one converted tile, and
//                     of the epilogue's staging (which reuses the ring)
//   Acc               the consumer's accumulator (zero(), fence())
//   Conv              a consumer thread's unpack state: Conv(p, n0, t),
//                     operator()(stage, cvt, kt) for t in 0..255
//   M, N, k_tiles()   the shape
//   issue(stage, bar, kt, m0, n0)   the producer's TMA loads
//   mma(acc, stage, cvt, cw)        consumer cw's wgmmas of one stage
//   epilogue(acc, buf, m0, n0, cw)  C from the accumulator
//
// The host builds byte tensor maps (make_map_bytes, make_map_planes) beside
// gemm_sm90.cuh's 16-bit ones.

#pragma once

#include "gemm_sm90.cuh"

namespace tl_lowbit {

using tl_gemm::smem_addr;
using tl_gemm::tile_of;
using namespace tl_sm90;

// generic-proxy writes to shared memory visible to the async proxy
// (wgmma's operand reads)
__device__ __forceinline__ void fence_view_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <class P>
struct CvtCfg {
  static constexpr int kFit = (kSmemOptin - 2048 - 2 * P::kCvt) / P::kRaw;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kRing = kStages * P::kRaw + 2 * P::kCvt;
  static constexpr int kBuf = kRing > P::kEpi ? kRing : P::kEpi;
  static constexpr int kSmem = kBuf + 2 * kStages * 8 + 1024;
  static_assert(kStages >= 2, "a stage does not fit twice");
  static_assert(kSmem <= kSmemOptin, "tile past shared memory");
};

template <class P>
__global__ void __launch_bounds__(kThreads, 1)
gemm_tma_cvt(const __grid_constant__ P p) {
  using C = CvtCfg<P>;
  constexpr int S = C::kStages;
  extern __shared__ __align__(1024) char smem_raw[];
  char* buf = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  char* cvt = buf + S * P::kRaw;
  uint64_t* full = reinterpret_cast<uint64_t*>(buf + C::kBuf);
  uint64_t* empty = full + S;
  int mt, nt;
  tile_of(blockIdx.x, (p.M + P::kTM - 1) / P::kTM,
          (p.N + P::kTN - 1) / P::kTN, mt, nt);
  const int m0 = mt * P::kTM, n0 = nt * P::kTN;
  const int nk = p.k_tiles();
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
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
        const int s = kt % S;
        mbar_wait(&empty[s], ((kt / S) & 1) ^ 1);
        mbar_expect_tx(&full[s], P::kRaw);
        p.issue(buf + s * P::kRaw, &full[s], kt, m0, n0);
      }
    }
    return;
  }

  setmaxnreg_inc<232>();                  // consumers
  const int cw = wg - 1;
  const bool lead = threadIdx.x % 32 == 0;
  typename P::Acc acc;
  acc.zero();
  typename P::Conv conv(p, n0, threadIdx.x - 128);
  mbar_wait(&full[0], 0);
  conv(buf, cvt, 0);
  fence_view_async();
  named_sync(1, 256);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % S;
    wg_fence();
    P::mma(acc, smem_addr(buf + s * P::kRaw),
           smem_addr(cvt + (kt & 1) * P::kCvt), cw);
    wg_commit();
    acc.fence();
    wg_wait<1>();            // this consumer's products of kt - 1 are done
    if (kt > 0 && lead) mbar_arrive(&empty[(kt - 1) % S]);
    if (kt + 1 < nk) {
      const int s1 = (kt + 1) % S;
      mbar_wait(&full[s1], ((kt + 1) / S) & 1);
      named_sync(1, 256);    // both consumers past kt - 1: its tile is free
      conv(buf + s1 * P::kRaw, cvt + ((kt + 1) & 1) * P::kCvt, kt + 1);
      fence_view_async();
      named_sync(1, 256);    // the tile of kt + 1 is written
    }
  }
  wg_wait<0>();
  acc.fence();
  named_sync(1, 256);        // both consumers past the ring
  p.epilogue(acc, buf, m0, n0, cw);
}

// Launches gemm_tma_cvt<P> over p's tiles on `s`; cudaGetLastError()
template <class P>
int launch_cvt(const P& p, cudaStream_t s) {
  using C = CvtCfg<P>;
  // set on every launch: a function-local static here would be one
  // object across the libraries that include this header
  const auto kern = gemm_tma_cvt<P>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (attr != cudaSuccess) return (int)attr;
  const unsigned tiles = (unsigned)((p.M + P::kTM - 1) / P::kTM) *
                         (unsigned)((p.N + P::kTN - 1) / P::kTN);
  kern<<<tiles, kThreads, C::kSmem, s>>>(p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// wgmma m64n256k32 s8 x s8 -> s32 (both operands K-major)
// ---------------------------------------------------------------------------

#define TL_R8(i)                                                     \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),        \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define TL_R64                                                         \
  TL_R8(0), TL_R8(8), TL_R8(16), TL_R8(24), TL_R8(32), TL_R8(40),      \
      TL_R8(48), TL_R8(56)
#define TL_R64B                                                        \
  TL_R8(64), TL_R8(72), TL_R8(80), TL_R8(88), TL_R8(96), TL_R8(104),   \
      TL_R8(112), TL_R8(120)

__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], uint64_t a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n}\n"
      : TL_R64, TL_R64B
      : "l"(a), "l"(b), "r"(1));
}

#undef TL_R64B
#undef TL_R64
#undef TL_R8

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// A byte tensor of `rank` dimensions (dims inner first, the outer ones'
// strides in bytes) as a map of `box` boxes, swizzled by `swizzle` bytes
// (128 or 64; 0: none); false when refused
inline bool encode_bytes(CUtensorMap* map, const void* base, int rank,
                         const cuuint64_t* dims, const cuuint64_t* strides,
                         const cuuint32_t* box, int swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank,
                const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                : swizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The (rows x cols) row-major byte matrix at `base` (row stride ld
// bytes) as a map of (box_cols x box_rows) boxes, swizzled by 128 bytes
// when swz128 (box_cols 128) or not at all; false when refused
inline bool make_map_bytes(CUtensorMap* map, const void* base,
                           long long rows, long long cols, long long ld,
                           int box_cols, int box_rows, bool swz128) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  return encode_bytes(map, base, 2, dims, strides, box, swz128 ? 128 : 0);
}

// `planes` (rows x cols) byte matrices, plane p at base + p * pld bytes,
// row stride ld bytes, as a 3-D map of (box_cols x 1 x box_rows) boxes
// (dims inner first: cols, planes, rows), swizzled by box_cols bytes (64
// or 128): a box past a plane's columns is zero-filled and never reads
// the next plane. false when refused.
inline bool make_map_planes(CUtensorMap* map, const void* base,
                            long long rows, long long planes, long long cols,
                            long long ld, long long pld, int box_cols,
                            int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)planes,
                              (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)pld, (cuuint64_t)ld};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, 1, (cuuint32_t)box_rows};
  return encode_bytes(map, base, 3, dims, strides, box, box_cols);
}

}  // namespace tl_lowbit
