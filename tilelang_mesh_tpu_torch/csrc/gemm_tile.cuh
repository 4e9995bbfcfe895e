// One output tile of C = A @ B for Hopper (sm_90a): the block tile loop
// the port's GEMM kernels share (grouped_gemm.cu today).
//
// A block of 256 threads owns a BM x BN = 128 x 128 tile of C and loops
// over K with a double-buffered shared-memory stage. How the block finds
// its operands is the caller's business: it hands `gemm_tile` a `Tile`
// (pointers to the first row of A and of C the block owns, the expert's
// B, how many of its BM rows are real, and its first column). The loop
// itself is the same for a dense grouped GEMM, where the grid names the
// tile, and for a token-sorted one, where device tables do.
//
//   A  (rows, K) row-major, row stride K
//   B  (K, N) row-major, or (N, K) when TRANS_B
//   C  (rows, N) row-major, written once from the float32 accumulator
//
// Loads. Where every row of A and B starts on 16 bytes (K, and N unless
// TRANS_B, a multiple of 16 / sizeof(T)) a tile arrives by `cp.async`,
// 16 bytes a thread, zero-filled past the edge (src-size 0), the next
// tile in flight while the current one is computed. Otherwise each
// element is a predicated load stored to shared memory by the thread
// (zero past the edge). Rows past `rows`, columns past N and depth past
// K are zeros in shared memory and never stored, so any M, N, K >= 1
// works.
//
// float32: FFMA on CUDA cores (no TF32: the reference's float32
// numerics), BK = 16. Thread (ty, tx) of a 16 x 16 grid owns rows
// ty + 16 i (i < 8) and 8 columns, an 8 x 8 register micro-tile; A and,
// when TRANS_B, B sit k-contiguous in shared memory ([row][BK + 4]) so a
// thread reads four k-steps of a row in one 16-byte load.
//
// bfloat16: tensor cores through `mma.sync.aligned.m16n8k16` (bf16 in,
// float32 accumulate), fragments loaded with `ldmatrix` (`.trans` for a
// row-major B), BK = 32. Eight warps as 2 (m) x 4 (n), each a 64 x 32
// warp tile of 4 x 4 mma tiles; shared rows padded by 8 elements so the
// eight 16-byte rows of an ldmatrix hit eight distinct bank groups.
//
// wgmma, TMA and warp specialisation are later work.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tl_gemm {

constexpr int kThreads = 256;
constexpr int BM = 128;
constexpr int BN = 128;

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
      dst[r * LD + c] = ok ? src[(long long)(r0 + r) * ld + c0 + c] : T(0.f);
    }
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA-core FFMA, 8 x 8 a thread
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int BK = 16;
constexpr int LDA = BK + 4;                   // k-contiguous rows, 80 B
template <bool TRANS_B>
__host__ __device__ constexpr int b_rows() { return TRANS_B ? BN : BK; }
template <bool TRANS_B>
__host__ __device__ constexpr int b_ld() {
  return TRANS_B ? BK + 4 : BN + 4;
}
template <bool TRANS_B>
__host__ __device__ constexpr int stage_floats() {
  return BM * LDA + b_rows<TRANS_B>() * b_ld<TRANS_B>();
}

// column j (< 8) of thread tx: k-contiguous B is read a column a thread
// at stride 16 (8 lanes of a quarter warp on 8 distinct bank groups);
// row-major B as two float4 runs at tx*4 and 64 + tx*4
template <bool TRANS_B>
__device__ __forceinline__ int col(int tx, int j) {
  return TRANS_B ? tx + 16 * j : (j / 4) * 64 + tx * 4 + (j % 4);
}

template <bool TRANS_B, typename OutT>
__device__ __forceinline__ void gemm_tile(const Tile<float, OutT>& t, int K,
                                          int N, bool vec) {
  __shared__ __align__(16) float smem[2 * stage_floats<TRANS_B>()];
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int nk = (K + BK - 1) / BK;

  auto load = [&](int stage, int kt) {
    float* As = smem + stage * stage_floats<TRANS_B>();
    float* Bs = As + BM * LDA;
    const int k0 = kt * BK;
    load_window<float, BM, BK, LDA>(As, t.a, 0, k0, t.rows, K, K, vec);
    if (TRANS_B)
      load_window<float, BN, BK, b_ld<true>()>(Bs, t.b, t.n0, k0, N, K, K,
                                               vec);
    else
      load_window<float, BK, BN, b_ld<false>()>(Bs, t.b, k0, t.n0, K, N, N,
                                                vec);
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load((kt + 1) & 1, kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* As = smem + (kt & 1) * stage_floats<TRANS_B>();
    const float* Bs = As + BM * LDA;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(As + (ty + 16 * i) * LDA +
                                                kk);
      if (TRANS_B) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 b = *reinterpret_cast<const float4*>(
              Bs + col<true>(tx, j) * b_ld<true>() + kk);
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
          const float* brow = Bs + (kk + q) * b_ld<false>();
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
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
          }
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + 16 * i;
    if (r >= t.rows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = t.n0 + col<TRANS_B>(tx, j);
      if (n < N) store(t.c + (long long)r * N + n, acc[i][j]);
    }
  }
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bfloat16: mma.sync m16n8k16, ldmatrix
// ---------------------------------------------------------------------------

namespace bf16 {

using T = __nv_bfloat16;
constexpr int BK = 32;
constexpr int LDA = BK + 8;                   // 80 B rows
template <bool TRANS_B>
__host__ __device__ constexpr int b_rows() { return TRANS_B ? BN : BK; }
template <bool TRANS_B>
__host__ __device__ constexpr int b_ld() {   // 80 / 272 B rows
  return TRANS_B ? BK + 8 : BN + 8;
}
template <bool TRANS_B>
__host__ __device__ constexpr int stage_elems() {
  return BM * LDA + b_rows<TRANS_B>() * b_ld<TRANS_B>();
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const T* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const T* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <bool TRANS_B, typename OutT>
__device__ __forceinline__ void gemm_tile(const Tile<T, OutT>& t, int K,
                                          int N, bool vec) {
  __shared__ __align__(16) T smem[2 * stage_elems<TRANS_B>()];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = (warp % 2) * 64, wn = (warp / 2) * 32;
  const int nk = (K + BK - 1) / BK;

  auto load = [&](int stage, int kt) {
    T* As = smem + stage * stage_elems<TRANS_B>();
    T* Bs = As + BM * LDA;
    const int k0 = kt * BK;
    load_window<T, BM, BK, LDA>(As, t.a, 0, k0, t.rows, K, K, vec);
    if (TRANS_B)
      load_window<T, BN, BK, b_ld<true>()>(Bs, t.b, t.n0, k0, N, K, K, vec);
    else
      load_window<T, BK, BN, b_ld<false>()>(Bs, t.b, k0, t.n0, K, N, N, vec);
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;

  // the lane's row address in an x4 ldmatrix: matrix l / 8, its row l % 8
  const int mat = lane / 8, mr = lane % 8;

  load(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load((kt + 1) & 1, kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* As = smem + (kt & 1) * stage_elems<TRANS_B>();
    const T* Bs = As + BM * LDA;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      // A 16 x 16: matrices (rows 0-7 | 8-15) x (k 0-7 | 8-15), in the
      // order of the mma's a0..a3 registers
      unsigned a[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(a[mi], As + (wm + mi * 16 + mr + 8 * (mat % 2)) * LDA +
                               ks + 8 * (mat / 2));
      // B: one x4 covers two n8 tiles, registers (k 0-7, k 8-15) of each
      unsigned b[4][2];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        unsigned r[4];
        if (TRANS_B)      // [n][k]: rows are n
          ldmatrix_x4(r, Bs + (wn + np * 16 + mr + 8 * (mat / 2)) *
                                  b_ld<true>() + ks + 8 * (mat % 2));
        else              // [k][n]: rows are k, transposed on load
          ldmatrix_x4_trans(r, Bs + (ks + mr + 8 * (mat % 2)) *
                                        b_ld<false>() + wn + np * 16 +
                                        8 * (mat / 2));
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  // c0, c1 at (row g, cols 2q, 2q + 1), c2, c3 at row g + 8
  const int g = lane / 4, q2 = (lane % 4) * 2;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm + mi * 16 + g + 8 * h;
      if (r >= t.rows) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = t.n0 + wn + ni * 8 + q2 + e;
          if (n < N)
            store(t.c + (long long)r * N + n, acc[mi][ni][2 * h + e]);
        }
    }
}

}  // namespace bf16

// The tile loop of the element type
template <bool TRANS_B, typename OutT>
__device__ __forceinline__ void gemm_tile(const Tile<float, OutT>& t, int K,
                                          int N, bool vec) {
  f32::gemm_tile<TRANS_B>(t, K, N, vec);
}

template <bool TRANS_B, typename OutT>
__device__ __forceinline__ void gemm_tile(const Tile<__nv_bfloat16, OutT>& t,
                                          int K, int N, bool vec) {
  bf16::gemm_tile<TRANS_B>(t, K, N, vec);
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
