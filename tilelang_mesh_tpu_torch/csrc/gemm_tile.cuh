// One output tile of C = op(A) @ op(B) for Hopper (sm_90a): the block
// tile loop the port's GEMM kernels share (grouped_gemm.cu, gemm.cu,
// dequant_gemm.cu).
//
// A block of 256 threads owns a BM x BN = 128 x 128 tile of C and loops
// over K with a double-buffered shared-memory stage. How the block finds
// its operands is the caller's business: it hands the loop a *source*
// (below) that fills a stage for k-tile kt and says where the tile's A
// and B sit in shared memory; the loop does the products into a
// register accumulator, and the caller's epilogue visits each element of
// it (`for_each`). The same loop serves a dense or grouped GEMM, where
// the grid names the tile, a token-sorted one, where device tables do,
// and the low-bit GEMMs, whose B tiles their source unpacks itself.
//
//   A  (rows, K) row-major, or (K, M) when TRANS_A (the block's rows are
//      columns m0 .. m0 + rows of it)
//   B  (K, N) row-major, or (N, K) when TRANS_B
//
// Sources. `Direct<T, TRANS_A, TRANS_B>` brings A and B as they are:
// where every row starts on 16 bytes a tile arrives by `cp.async`, 16
// bytes a thread, zero-filled past the edge (src-size 0), the next tile
// in flight while the current one is computed; otherwise each element is
// a predicated load stored by the thread (zero past the edge). Rows past
// `rows`, columns past N and depth past K are zeros in shared memory and
// never stored, so any M, N, K >= 1 works. A *converting* source
// (`Fp8` below, the int4 ones of dequant_gemm.cu) lands its raw bytes in
// the stage the same way and, once they have arrived, writes the tile
// the loop computes on into a buffer of its own (`kConverts`: one more
// barrier a k-tile). A source provides
//   kStageBytes, kCvtBytes, kConverts,
//   issue(stage, kt)                 start the loads of k-tile kt
//   view(stage, cvt, kt, As, Bs)     the tile's A and B in shared memory
//
// float32: FFMA on CUDA cores (no TF32: the reference's float32
// numerics), BK = 16. Thread (ty, tx) of a 16 x 16 grid owns an 8 x 8
// register micro-tile: rows ty + 16 i, or the two runs of four at
// ty * 4 and 64 + ty * 4 when TRANS_A (A then sits m-contiguous, [BK][BM
// + 4], and a k-step reads two float4); columns likewise by tx. A k-
// contiguous operand sits [row][BK + 4], so a thread reads four k-steps
// of a row in one 16-byte load.
//
// bfloat16 and float16: tensor cores through `mma.sync.aligned.m16n8k16`
// (bf16 or f16 in, float32 accumulate; the source's `Elem` picks the
// instruction), fragments loaded with `ldmatrix` (`.trans` for an
// m-contiguous A and a row-major B), BK = 32. Eight warps as 2 (m) x 4
// (n), each a 64 x 32 warp tile of 4 x 4 mma tiles; shared rows padded
// by 8 elements so the eight 16-byte rows of an ldmatrix hit eight
// distinct bank groups. fp8 e4m3 inputs (`Fp8`) are widened to bf16 in
// shared memory, which is exact (3 mantissa bits, exponents inside
// bf16's), and run on this loop: their products are exact in float32,
// as on the fp8 tensor-core path.
//
// int8: `mma.sync.aligned.m16n8k32` s8 x s8 -> s32, BK = 64 bytes, the
// same warp layout and ldmatrix addressing as bf16 with a byte for an
// element: A k-contiguous, B n-major (k-contiguous) in shared memory,
// since ldmatrix `.trans` moves 16-bit elements only. Exact int32 sums.
// `S8` brings int8 A and B in any transpose: an operand that arrives
// the other way (an m-contiguous A, a row-major B) lands raw and is
// transposed four bytes a thread into the compute tile.
//
// wgmma, TMA and warp specialisation are later work.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace tl_gemm {

constexpr int kThreads = 256;
constexpr int BM = 128;
constexpr int BN = 128;
// Blocks an SM the library GEMMs (gemm.cu, dequant_gemm.cu) ask the
// compiler for: two cap a thread at 128 registers, at the price of a
// few spilled words (L1) in the fp8, transposed and int4 variants, which
// otherwise take 150-230 registers and one block an SM
// (scripts/gemm_launch_bounds_ab.py times both).
constexpr int kMinBlocks = 2;

// What one block computes: C[r, n0 + j] = sum_k A[r, k] B[k, n0 + j] for
// r < rows (<= BM), j < BN, n0 + j < N.
template <typename T, typename OutT>
struct Tile {
  const T* a;     // row 0 of the block's A rows
  const T* b;     // the expert's B
  OutT* c;        // row 0 of the block's C rows
  int rows;       // real rows, 1..BM
  int n0;         // first column
};

// Grouped raster: the tile (mt, nt) of linear block id `pid` in a grid of
// tm x tn tiles, walked in groups of 8 tile rows, column by column inside
// a group, so the blocks in flight share 8 row panels of A and a few
// column panels of B through L2.
__device__ __forceinline__ void tile_of(int pid, int tm, int tn, int& mt,
                                        int& nt) {
  constexpr int G = 8;
  const int per_group = G * tn;
  const int first = (pid / per_group) * G;
  const int gm = min(tm - first, G);
  mt = first + (pid % per_group) % gm;
  nt = (pid % per_group) / gm;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !ok (src-size 0; the
// source address is then `base`, which is valid)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store(__half* p, float x) {
  *p = __float2half_rn(x);
}
__device__ __forceinline__ void store(int* p, int x) { *p = x; }
// round to nearest even; a value that rounds past +-448 (|x| > 464, or
// infinite) is NaN, as the JAX package's cast gives (e4m3 has no
// infinity)
__device__ __forceinline__ void store(__nv_fp8_e4m3* p, float x) {
  p->__x = __nv_cvt_float_to_fp8(x, __NV_NOSAT, __NV_E4M3);
}

// Element types by the codes the launchers take (the Python wrappers'
// DTYPE_CODES)
enum DType { kF32 = 0, kBF16 = 1, kFP8 = 2, kF16 = 3, kS8 = 4, kS32 = 5 };

// float16 and float8 e4m3 out of line: inlined beside float32 and bf16
// at each of a thread's 64-128 stores of a tile, the four conversions
// made gemm.cu's build several times as long
__device__ __noinline__ void store_narrow(void* c, long long at, int type,
                                          float x) {
  if (type == kF16) store(static_cast<__half*>(c) + at, x);
  else store(static_cast<__nv_fp8_e4m3*>(c) + at, x);
}

// c[at] = x rounded to the float type `type` (kF32, kBF16, kFP8, kF16)
__device__ __forceinline__ void store_as(void* c, long long at, int type,
                                         float x) {
  if (type == kF32) store(static_cast<float*>(c) + at, x);
  else if (type == kBF16) store(static_cast<__nv_bfloat16*>(c) + at, x);
  else store_narrow(c, at, type, x);
}

// A block's shared buffer of `Bytes`: static up to the 48 KB a kernel
// has without opting in, dynamic past it (the launch then passes Bytes
// and sets cudaFuncAttributeMaxDynamicSharedMemorySize)
constexpr int kStaticSmemBytes = 48 * 1024;
template <int Bytes>
__device__ __forceinline__ char* shared_buffer() {
  if constexpr (Bytes <= kStaticSmemBytes) {
    __shared__ __align__(16) char buf[Bytes];
    return buf;
  } else {
    extern __shared__ __align__(16) char dyn[];
    return dyn;
  }
}

// Copies the (R x W) window at (r0, c0) of a row-major (nr x nc) matrix
// with row stride `ld` into dst[R][LD] of shared memory, zero outside.
// VEC: 16-byte cp.async chunks (the caller guarantees nc and ld are
// multiples of the chunk, so a chunk is wholly inside or outside);
// otherwise one predicated load a element.
template <typename T, int R, int W, int LD>
__device__ __forceinline__ void load_window(T* dst, const T* src, int r0,
                                            int c0, int nr, int nc,
                                            long long ld, bool vec) {
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    for (int i = threadIdx.x; i < R * W / V; i += kThreads) {
      const int r = i / (W / V), c = (i % (W / V)) * V;
      const bool ok = r0 + r < nr && c0 + c < nc;
      const T* s = ok ? src + (long long)(r0 + r) * ld + c0 + c : src;
      cp_async16(dst + r * LD + c, s, ok);
    }
  } else {
    for (int i = threadIdx.x; i < R * W; i += kThreads) {
      const int r = i / W, c = i % W;
      const bool ok = r0 + r < nr && c0 + c < nc;
      dst[r * LD + c] =
          ok ? src[(long long)(r0 + r) * ld + c0 + c] : T(0.f);
    }
  }
}

// The k-tile window of an operand: A's (rows x K) at depth k0, or its
// (K x rows) when TRANS_A; B's (K x N) at (k0, n0), or its (N x K) when
// TRANS_B. Shared layout [BM][BK + pad] / [BK][BM + pad] for A,
// [BK][BN + pad] / [BN][BK + pad] for B, with row stride LD.
template <typename T, int BK, int LD, bool TRANS_A>
__device__ __forceinline__ void load_a(T* dst, const T* a, int k0, int rows,
                                       int K, long long lda, bool vec) {
  if (TRANS_A)
    load_window<T, BK, BM, LD>(dst, a, k0, 0, K, rows, lda, vec);
  else
    load_window<T, BM, BK, LD>(dst, a, 0, k0, rows, K, lda, vec);
}

template <typename T, int BK, int LD, bool TRANS_B>
__device__ __forceinline__ void load_b(T* dst, const T* b, int k0, int n0,
                                       int K, int N, bool vec) {
  if (TRANS_B)
    load_window<T, BN, BK, LD>(dst, b, n0, k0, N, K, K, vec);
  else
    load_window<T, BK, BN, LD>(dst, b, k0, n0, K, N, N, vec);
}

// Shared layout of the compute tile for element type T at depth BK:
// leading dimensions and element counts of A and B.
template <int BK, int PAD, bool TRANS_A, bool TRANS_B>
struct Layout {
  static constexpr int a_ld = TRANS_A ? BM + PAD : BK + PAD;
  static constexpr int a_elems = TRANS_A ? BK * a_ld : BM * a_ld;
  static constexpr int b_ld = TRANS_B ? BK + PAD : BN + PAD;
  static constexpr int b_elems = TRANS_B ? BN * b_ld : BK * b_ld;
};

// The direct source: A and B of type T as they are in device memory.
// `a` is row 0 of the block's A rows (row stride lda), or column 0 of
// them when TRANS_A (row stride lda = M).
template <typename T, int BK, int PAD, bool TRANS_A, bool TRANS_B>
struct Direct {
  using L = Layout<BK, PAD, TRANS_A, TRANS_B>;
  using Elem = T;
  static constexpr int kStageBytes = (L::a_elems + L::b_elems) * sizeof(T);
  static constexpr int kCvtBytes = 0;
  static constexpr bool kConverts = false;
  const T* a;
  const T* b;
  long long lda;
  int rows, n0, K, N;
  bool vec;

  __device__ __forceinline__ void issue(char* stage, int kt) const {
    T* As = reinterpret_cast<T*>(stage);
    load_a<T, BK, L::a_ld, TRANS_A>(As, a, kt * BK, rows, K, lda, vec);
    load_b<T, BK, L::b_ld, TRANS_B>(As + L::a_elems, b, kt * BK, n0, K, N,
                                    vec);
  }
  __device__ __forceinline__ void view(char* stage, char*, int, const T*& As,
                                       const T*& Bs) const {
    As = reinterpret_cast<const T*>(stage);
    Bs = As + L::a_elems;
  }
};

// ---------------------------------------------------------------------------
// float32: CUDA-core FFMA, 8 x 8 a thread
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int BK = 16;
constexpr int PAD = 4;
template <bool TRANS_A, bool TRANS_B>
using Layout = tl_gemm::Layout<BK, PAD, TRANS_A, TRANS_B>;
template <bool TRANS_A, bool TRANS_B>
using Direct = tl_gemm::Direct<float, BK, PAD, TRANS_A, TRANS_B>;

// row i (< 8) of thread ty / column j (< 8) of thread tx: a k-contiguous
// operand is read a row a thread at stride 16 (8 lanes of a quarter
// warp on 8 distinct bank groups); a row- or m-contiguous one as two
// float4 runs at t*4 and 64 + t*4
template <bool CONTIG>
__device__ __forceinline__ int pos(int t, int i) {
  return CONTIG ? (i / 4) * 64 + t * 4 + (i % 4) : t + 16 * i;
}

using Acc = float[8][8];

template <bool TRANS_A, bool TRANS_B, class Src>
__device__ __forceinline__ void loop(const Src& src, int nk, Acc& acc) {
  using L = Layout<TRANS_A, TRANS_B>;
  __shared__ __align__(16) char smem[2 * Src::kStageBytes + Src::kCvtBytes];
  char* cvt = smem + 2 * Src::kStageBytes;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  src.issue(smem, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) src.issue(smem + ((kt + 1) & 1) * Src::kStageBytes,
                               kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float *As, *Bs;
    src.view(smem + (kt & 1) * Src::kStageBytes, cvt, kt, As, Bs);
    if (Src::kConverts) __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      if (!TRANS_A) {
        float4 a[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          a[i] = *reinterpret_cast<const float4*>(
              As + pos<false>(ty, i) * L::a_ld + kk);
        if (TRANS_B) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float4 b = *reinterpret_cast<const float4*>(
                Bs + pos<false>(tx, j) * L::b_ld + kk);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
              acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
              acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
              acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
            }
          }
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float* brow = Bs + (kk + q) * L::b_ld;
            const float4 b0 =
                *reinterpret_cast<const float4*>(brow + tx * 4);
            const float4 b1 =
                *reinterpret_cast<const float4*>(brow + 64 + tx * 4);
            const float b[8] = {b0.x, b0.y, b0.z, b0.w,
                                b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float av = q == 0 ? a[i].x : q == 1 ? a[i].y
                             : q == 2 ? a[i].z : a[i].w;
#pragma unroll
              for (int j = 0; j < 8; ++j)
                acc[i][j] = fmaf(av, b[j], acc[i][j]);
            }
          }
        }
      } else {
        // A m-contiguous: each k-step is two float4 runs of the column
        float4 bk[8];             // TRANS_B: four k-steps of column j
        if (TRANS_B) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            bk[j] = *reinterpret_cast<const float4*>(
                Bs + pos<false>(tx, j) * L::b_ld + kk);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float* acol = As + (kk + q) * L::a_ld;
          const float4 a0 = *reinterpret_cast<const float4*>(acol + ty * 4);
          const float4 a1 =
              *reinterpret_cast<const float4*>(acol + 64 + ty * 4);
          const float a[8] = {a0.x, a0.y, a0.z, a0.w,
                              a1.x, a1.y, a1.z, a1.w};
          float b[8];
          if (TRANS_B) {
#pragma unroll
            for (int j = 0; j < 8; ++j)
              b[j] = q == 0 ? bk[j].x : q == 1 ? bk[j].y
                   : q == 2 ? bk[j].z : bk[j].w;
          } else {
            const float* brow = Bs + (kk + q) * L::b_ld;
            const float4 b0 =
                *reinterpret_cast<const float4*>(brow + tx * 4);
            const float4 b1 =
                *reinterpret_cast<const float4*>(brow + 64 + tx * 4);
            b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
            b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
          }
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
}

// fn(r, c, v) for each of the thread's accumulators: block-local row r
// and column c (both < 128)
template <bool TRANS_A, bool TRANS_B, class Fn>
__device__ __forceinline__ void for_each(const Acc& acc, Fn fn) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      fn(pos<TRANS_A>(ty, i), pos<!TRANS_B>(tx, j), acc[i][j]);
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bfloat16 and float16: mma.sync m16n8k16, ldmatrix
// ---------------------------------------------------------------------------

namespace bf16 {

using T = __nv_bfloat16;
constexpr int BK = 32;
constexpr int PAD = 8;                        // 80 / 272 B rows
template <bool TRANS_A, bool TRANS_B>
using Layout = tl_gemm::Layout<BK, PAD, TRANS_A, TRANS_B>;
template <bool TRANS_A, bool TRANS_B>
using Direct = tl_gemm::Direct<T, BK, PAD, TRANS_A, TRANS_B>;

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// the m16n8k16 product of 16-bit E (bf16 or f16) fragments, f32 sums
template <typename E>
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  if constexpr (std::is_same_v<E, __half>)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename AccT>
using Acc = AccT[4][4][4];

// One k16 step of the warp's 4 x 4 mma tiles from 16-bit tiles in
// shared memory (also the int8 loop's addressing: there E is two int8
// k-steps and `ks` counts 16-bit units).
template <bool TRANS_A, bool TRANS_B, int A_LD, int B_LD, typename E>
__device__ __forceinline__ void fragments(const E* As, const E* Bs, int ks,
                                          int wm, int wn, unsigned (&a)[4][4],
                                          unsigned (&b)[4][2]) {
  const int lane = threadIdx.x % 32;
  // the lane's row address in an x4 ldmatrix: matrix l / 8, its row l % 8
  const int mat = lane / 8, mr = lane % 8;
  // A 16 x 16: matrices (rows 0-7 | 8-15) x (k 0-7 | 8-15), in the order
  // of the mma's a0..a3 registers
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    if (TRANS_A)          // [k][m]: rows are k, transposed on load
      ldmatrix_x4_trans(a[mi], As + (ks + mr + 8 * (mat / 2)) * A_LD + wm +
                                   mi * 16 + 8 * (mat % 2));
    else
      ldmatrix_x4(a[mi], As + (wm + mi * 16 + mr + 8 * (mat % 2)) * A_LD +
                             ks + 8 * (mat / 2));
  }
  // B: one x4 covers two n8 tiles, registers (k 0-7, k 8-15) of each
#pragma unroll
  for (int np = 0; np < 2; ++np) {
    unsigned r[4];
    if (TRANS_B)          // [n][k]: rows are n
      ldmatrix_x4(r, Bs + (wn + np * 16 + mr + 8 * (mat / 2)) * B_LD + ks +
                         8 * (mat % 2));
    else                  // [k][n]: rows are k, transposed on load
      ldmatrix_x4_trans(r, Bs + (ks + mr + 8 * (mat % 2)) * B_LD + wn +
                               np * 16 + 8 * (mat / 2));
    b[2 * np][0] = r[0];
    b[2 * np][1] = r[1];
    b[2 * np + 1][0] = r[2];
    b[2 * np + 1][1] = r[3];
  }
}

// Src::Elem is bf16 or f16, the type of the tiles Src::view gives
template <bool TRANS_A, bool TRANS_B, class Src>
__device__ __forceinline__ void loop(const Src& src, int nk,
                                     Acc<float>& acc) {
  using L = Layout<TRANS_A, TRANS_B>;
  using E = typename Src::Elem;
  __shared__ __align__(16) char smem[2 * Src::kStageBytes + Src::kCvtBytes];
  char* cvt = smem + 2 * Src::kStageBytes;
  const int warp = threadIdx.x / 32;
  const int wm = (warp % 2) * 64, wn = (warp / 2) * 32;

#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;

  src.issue(smem, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) src.issue(smem + ((kt + 1) & 1) * Src::kStageBytes,
                               kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const E *As, *Bs;
    src.view(smem + (kt & 1) * Src::kStageBytes, cvt, kt, As, Bs);
    if (Src::kConverts) __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      unsigned a[4][4], b[4][2];
      fragments<TRANS_A, TRANS_B, L::a_ld, L::b_ld>(As, Bs, ks, wm, wn, a,
                                                    b);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma<E>(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
    __syncthreads();
  }
  cp_async_wait<0>();
}

// fn(r, c, v) for each of the thread's accumulators: block-local row r
// and column c. c0, c1 sit at (row g, cols 2q, 2q + 1), c2, c3 at row
// g + 8.
template <typename AccT, class Fn>
__device__ __forceinline__ void for_each(const Acc<AccT>& acc, Fn fn) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = (warp % 2) * 64, wn = (warp / 2) * 32;
  const int g = lane / 4, q2 = (lane % 4) * 2;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          fn(wm + mi * 16 + g + 8 * h, wn + ni * 8 + q2 + e,
             acc[mi][ni][2 * h + e]);
}

// fp8 e4m3 -> bf16, four at a time (exact: e4m3 -> half -> float ->
// bf16 each keep the value)
__device__ __forceinline__ void widen4(uint32_t x, T* dst) {
  const __half2 lo(__nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(x & 0xFFFF), __NV_E4M3));
  const __half2 hi(__nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(x >> 16), __NV_E4M3));
  const float2 fl = __half22float2(lo), fh = __half22float2(hi);
  __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(dst);
  d[0] = __floats2bfloat162_rn(fl.x, fl.y);
  d[1] = __floats2bfloat162_rn(fh.x, fh.y);
}

// the (R x W) bytes at src (dense rows) as bf16 into dst[R][LD]
template <int R, int W, int LD>
__device__ __forceinline__ void widen(const uint8_t* src, T* dst) {
  for (int i = threadIdx.x; i < R * W / 4; i += kThreads) {
    const int r = i / (W / 4), c = (i % (W / 4)) * 4;
    widen4(*reinterpret_cast<const uint32_t*>(src + r * W + c),
           dst + r * LD + c);
  }
}

// fp8 e4m3 operands: the raw bytes land as the direct source would lay
// them out with no padding, then widen into the bf16 tile.
template <bool TRANS_A, bool TRANS_B>
struct Fp8 {
  using L = Layout<TRANS_A, TRANS_B>;
  using Elem = T;
  static constexpr int kA = BM * BK, kB = BK * BN;   // bytes
  static constexpr int kStageBytes = kA + kB;
  static constexpr int kCvtBytes = (L::a_elems + L::b_elems) * sizeof(T);
  static constexpr bool kConverts = true;
  const uint8_t* a;
  const uint8_t* b;
  long long lda;
  int rows, n0, K, N;
  bool vec;

  __device__ __forceinline__ void issue(char* stage, int kt) const {
    uint8_t* s = reinterpret_cast<uint8_t*>(stage);
    load_a<uint8_t, BK, TRANS_A ? BM : BK, TRANS_A>(s, a, kt * BK, rows, K,
                                                    lda, vec);
    load_b<uint8_t, BK, TRANS_B ? BK : BN, TRANS_B>(s + kA, b, kt * BK, n0,
                                                    K, N, vec);
  }
  __device__ __forceinline__ void view(char* stage, char* cvt, int,
                                       const T*& As, const T*& Bs) const {
    const uint8_t* s = reinterpret_cast<const uint8_t*>(stage);
    T* a_t = reinterpret_cast<T*>(cvt);
    T* b_t = a_t + L::a_elems;
    if (TRANS_A) widen<BK, BM, L::a_ld>(s, a_t);
    else widen<BM, BK, L::a_ld>(s, a_t);
    if (TRANS_B) widen<BN, BK, L::b_ld>(s + kA, b_t);
    else widen<BK, BN, L::b_ld>(s + kA, b_t);
    As = a_t;
    Bs = b_t;
  }
};

}  // namespace bf16

// ---------------------------------------------------------------------------
// int8: mma.sync m16n8k32 s8, ldmatrix; A k-contiguous, B n-major
// ---------------------------------------------------------------------------

namespace s8 {

constexpr int BK = 64;                        // bytes of k a tile
constexpr int LD = BK + 16;                   // 80 B rows, as bf16's
constexpr int kTileBytes = BM * LD;           // A [BM][LD], B [BN][LD]

__device__ __forceinline__ void mma(int (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

using Acc = bf16::Acc<int>;

// shared bytes of the loop over source Src (dynamic past 48 KB: see
// shared_buffer)
template <class Src>
constexpr int kSmemBytes = 2 * Src::kStageBytes + Src::kCvtBytes;

// dst[c][r] = src[r][c] for the dense (R x C) bytes at src, into rows of
// LD bytes: a thread gathers four rows of a column into one word
template <int R, int C>
__device__ __forceinline__ void transpose(const uint8_t* src, int8_t* dst) {
  for (int i = threadIdx.x; i < R / 4 * C; i += kThreads) {
    const int r4 = (i / C) * 4, c = i % C;
    uint32_t w = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) w |= (uint32_t)src[(r4 + q) * C + c] << (8 * q);
    *reinterpret_cast<uint32_t*>(dst + c * LD + r4) = w;
  }
}

// int8 A and B as they are in device memory: A (rows, K) row-major, or
// its (K, M) when TRANS_A (`a` column m0, row stride lda = M); B (K, N),
// or (N, K) when TRANS_B. A k-contiguous A and an n-major B land in
// their compute tiles; the others land raw, [BK][BM] and [BK][BN], and
// are transposed into a buffer of their own.
template <bool TRANS_A, bool TRANS_B>
struct S8 {
  static constexpr int kA = TRANS_A ? BK * BM : kTileBytes;
  static constexpr int kB = TRANS_B ? kTileBytes : BK * BN;
  static constexpr int kStageBytes = kA + kB;
  static constexpr int kCvtBytes =
      (TRANS_A ? kTileBytes : 0) + (TRANS_B ? 0 : kTileBytes);
  static constexpr bool kConverts = TRANS_A || !TRANS_B;
  const int8_t* a;
  const int8_t* b;
  long long lda;
  int rows, n0, K, N;
  bool vec;

  __device__ __forceinline__ void issue(char* stage, int kt) const {
    int8_t* s = reinterpret_cast<int8_t*>(stage);
    load_a<int8_t, BK, TRANS_A ? BM : LD, TRANS_A>(s, a, kt * BK, rows, K,
                                                   lda, vec);
    load_b<int8_t, BK, TRANS_B ? LD : BN, TRANS_B>(s + kA, b, kt * BK, n0,
                                                   K, N, vec);
  }
  __device__ __forceinline__ void view(char* stage, char* cvt, int,
                                       const int8_t*& As,
                                       const int8_t*& Bs) const {
    const uint8_t* s = reinterpret_cast<const uint8_t*>(stage);
    int8_t* out = reinterpret_cast<int8_t*>(cvt);
    if (TRANS_A) {
      transpose<BK, BM>(s, out);
      As = out;
      out += kTileBytes;
    } else {
      As = reinterpret_cast<const int8_t*>(s);
    }
    if (TRANS_B) {
      Bs = reinterpret_cast<const int8_t*>(s + kA);
    } else {
      transpose<BK, BN>(s + kA, out);
      Bs = out;
    }
  }
};

// Src::view gives A [BM][LD] and B [BN][LD] int8 tiles (k-contiguous)
template <class Src>
__device__ __forceinline__ void loop(const Src& src, int nk, Acc& acc) {
  char* smem = shared_buffer<kSmemBytes<Src>>();
  char* cvt = smem + 2 * Src::kStageBytes;
  const int warp = threadIdx.x / 32;
  const int wm = (warp % 2) * 64, wn = (warp / 2) * 32;

#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0;

  src.issue(smem, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) src.issue(smem + ((kt + 1) & 1) * Src::kStageBytes,
                               kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int8_t *As, *Bs;
    src.view(smem + (kt & 1) * Src::kStageBytes, cvt, kt, As, Bs);
    if (Src::kConverts) __syncthreads();
    // 16-bit units: a row of LD bytes is LD / 2 of them, a k32 step 16
    const uint16_t* A16 = reinterpret_cast<const uint16_t*>(As);
    const uint16_t* B16 = reinterpret_cast<const uint16_t*>(Bs);
#pragma unroll
    for (int ks = 0; ks < BK / 2; ks += 16) {
      unsigned a[4][4], b[4][2];
      bf16::fragments<false, true, LD / 2, LD / 2>(A16, B16, ks, wm, wn, a,
                                                   b);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
    __syncthreads();
  }
  cp_async_wait<0>();
}

}  // namespace s8

// ---------------------------------------------------------------------------
// The grouped kernels' entry: one tile of C = A @ op(B), stored in OutT
// ---------------------------------------------------------------------------

template <bool TRANS_B, typename OutT>
__device__ __forceinline__ void gemm_tile(const Tile<float, OutT>& t, int K,
                                          int N, bool vec) {
  const f32::Direct<false, TRANS_B> src{t.a, t.b, K, t.rows, t.n0, K, N,
                                        vec};
  f32::Acc acc;
  f32::loop<false, TRANS_B>(src, (K + f32::BK - 1) / f32::BK, acc);
  f32::for_each<false, TRANS_B>(acc, [&](int r, int c, float v) {
    if (r < t.rows && t.n0 + c < N) store(t.c + (long long)r * N + t.n0 + c,
                                          v);
  });
}

// T: __nv_bfloat16 or __half (the mma.sync instruction follows it)
template <bool TRANS_B, typename T, typename OutT>
__device__ __forceinline__ std::enable_if_t<sizeof(T) == 2> gemm_tile(
    const Tile<T, OutT>& t, int K, int N, bool vec) {
  const Direct<T, bf16::BK, bf16::PAD, false, TRANS_B> src{
      t.a, t.b, K, t.rows, t.n0, K, N, vec};
  bf16::Acc<float> acc;
  bf16::loop<false, TRANS_B>(src, (K + bf16::BK - 1) / bf16::BK, acc);
  bf16::for_each(acc, [&](int r, int c, float v) {
    if (r < t.rows && t.n0 + c < N) store(t.c + (long long)r * N + t.n0 + c,
                                          v);
  });
}

// blocks of a grid of 128 x 128 tiles over an M x N output
inline unsigned tile_count(int M, int N) {
  return (unsigned)((M + BM - 1) / BM) * (unsigned)((N + BN - 1) / BN);
}

// the 16-byte path applies: every row of A and B starts on 16 bytes
inline bool vec_ok(const void* a, const void* b, int K, int N, bool trans_b,
                   int elem_bytes) {
  const int v = 16 / elem_bytes;
  return reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0 && K % v == 0 &&
         (trans_b || N % v == 0);
}

}  // namespace tl_gemm
