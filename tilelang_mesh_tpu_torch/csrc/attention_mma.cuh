// Fragment helpers of the tensor-core attention kernels (gqa_bwd.cu's and
// nsa_bwd.cu's backward pairs, flash_attention.cu's, nsa.cu's,
// blocksparse_attention.cu's, minference.cu's and
// flash_attention_varlen.cu's forwards): bfloat16
// and float16 operands in shared memory, each row padded by kPad
// elements (an odd count of 16-byte chunks, so the 8 rows of an ldmatrix
// hit 8 bank groups), products on mma.sync m16n8k16 with float32 sums.
// In an m16n8
// accumulator lane (g, q2) = (lane / 4, 2 (lane % 4)) holds rows g and
// g + 8, columns q2 and q2 + 1: two n8 tiles are the A fragment of the
// next product's k16 step (to_frags), so a probability tile is rounded
// to the input type in registers and never touches shared memory.

#pragma once

#include "attention_common.cuh"
#include "gemm_tile.cuh"

namespace tl_attn {

namespace mma16 = tl_gemm::bf16;

constexpr int kPad = 8;  // elements of padding a shared row

// two floats rounded to E (bf16 or f16) in one register, `lo` in the low
// half: the operand layout of mma.sync
template <typename E>
__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  if constexpr (std::is_same_v<E, __half>) {
    const __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&h);
  } else {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&h);
  }
}

// two E (bf16 or f16) of one register times `scale` in float32, rounded
// back to E: the prescaled Q of the forwards' contract (flash_attention.cu,
// flash_attention_varlen.cu)
template <typename E>
__device__ __forceinline__ unsigned scale2(unsigned x, float scale) {
  float2 f;
  if constexpr (std::is_same_v<E, __half>)
    f = __half22float2(*reinterpret_cast<const __half2*>(&x));
  else
    f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
  return pack2<E>(f.x * scale, f.y * scale);
}

// rows [r0, r0 + R) of a row-major (S, D) matrix into dst[R][D + kPad]
// by cp.async, 16 bytes a thread, zero past row S
template <int R, int D, typename E>
__device__ __forceinline__ void issue_rows(E* dst, const E* src, int r0,
                                           int S) {
  constexpr int CH = D / 8;
  for (int idx = threadIdx.x; idx < R * CH; idx += kThreads) {
    const int r = idx / CH, c = idx % CH;
    const bool ok = r0 + r < S;
    tl_gemm::cp_async16(dst + r * (D + kPad) + c * 8,
                        ok ? src + (long long)(r0 + r) * D + c * 8 : src,
                        ok);
  }
}

// rows [r0, r0 + R) of a row-strided matrix (row r at src + r * stride,
// D contiguous elements) into dst[R][D + kPad] by cp.async, 16 bytes a
// copy, zero at row r1 and past: a gather from a strided view, no copy;
// issued by the n threads tid = 0 .. n - 1 (the block, or a warp's lanes)
template <int R, int D, typename E>
__device__ __forceinline__ void issue_rows_strided(E* dst, const E* src,
                                                   long long stride, int r0,
                                                   int r1, int tid, int n) {
  constexpr int CH = D / 8;
  for (int idx = tid; idx < R * CH; idx += n) {
    const int r = idx / CH, c = idx % CH;
    const bool ok = r0 + r < r1;
    tl_gemm::cp_async16(dst + r * (D + kPad) + c * 8,
                        ok ? src + (long long)(r0 + r) * stride + c * 8 : src,
                        ok);
  }
}

// rows r < R of two matrices that share their rows (Q and dO, each
// row-major with D elements a row) into dst0, dst1 [R][D + kPad] by
// cp.async, 16 bytes a copy: row r from row at(r) of src0, src1, zero
// where at(r) < 0. A gather of whole rows through a row table (`at`, a
// callable: rows of a group at token offsets); issued by the n threads
// tid = 0 .. n - 1
template <int R, int D, typename E, typename At>
__device__ __forceinline__ void issue_rows_at(E* dst0, const E* src0,
                                              E* dst1, const E* src1, At at,
                                              int tid, int n) {
  constexpr int CH = D / 8;
  for (int idx = tid; idx < R * CH; idx += n) {
    const int r = idx / CH, c = idx % CH;
    const long long a = at(r);
    const bool ok = a >= 0;
    const long long off = (ok ? a * D : 0) + c * 8;
    tl_gemm::cp_async16(dst0 + r * (D + kPad) + c * 8, src0 + off, ok);
    tl_gemm::cp_async16(dst1 + r * (D + kPad) + c * 8, src1 + off, ok);
  }
}

// 4 bytes global -> shared, zero-filled when !ok (src-size 0; `src` is
// then any valid address)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   tl_gemm::smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

// c (+)= a . b over D for 16 rows of A (row-major at `a`) and the N rows
// of B (row-major at `b`, so B^T is the product's k x n operand); N a
// multiple of 16
template <int D, int N, typename E>
__device__ __forceinline__ void rows_dot_rows(float (&c)[N / 8][4],
                                              const E* a, const E* b) {
  constexpr int LD = D + kPad;
  const int lane = threadIdx.x % 32, mat = lane / 8, mr = lane % 8;
#pragma unroll
  for (int ks = 0; ks < D; ks += 16) {
    unsigned af[4];
    mma16::ldmatrix_x4(af, a + (mr + 8 * (mat % 2)) * LD + ks + 8 * (mat / 2));
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      unsigned r[4];
      mma16::ldmatrix_x4(r, b + (np * 16 + mr + 8 * (mat / 2)) * LD + ks +
                                8 * (mat % 2));
      mma16::mma<E>(c[2 * np], af, r[0], r[1]);
      mma16::mma<E>(c[2 * np + 1], af, r[2], r[3]);
    }
  }
}

// max / sum over the 4 lanes of an m16n8 accumulator row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// c += A . B for the A fragments `af` of a 16 x K product (K / 16 k16
// steps) and B the K rows of a row-major (K, D) tile at `b` (read through
// ldmatrix.trans)
template <int D, int K, typename E>
__device__ __forceinline__ void frags_dot_tile(float (&c)[D / 8][4],
                                               const unsigned (&af)[K / 16][4],
                                               const E* b) {
  constexpr int LD = D + kPad;
  const int lane = threadIdx.x % 32, mat = lane / 8, mr = lane % 8;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      unsigned r[4];
      mma16::ldmatrix_x4_trans(r, b + (kk * 16 + mr + 8 * (mat % 2)) * LD +
                                      np * 16 + 8 * (mat / 2));
      mma16::mma<E>(c[2 * np], af[kk], r[0], r[1]);
      mma16::mma<E>(c[2 * np + 1], af[kk], r[2], r[3]);
    }
}

// the A fragments of a 16 x N accumulator (N / 8 n8 tiles): tiles 2 kk
// and 2 kk + 1 are k16 step kk's (a0, a1) and (a2, a3), rounded to E
template <int N, typename E>
__device__ __forceinline__ void to_frags(unsigned (&af)[N / 16][4],
                                         const float (&c)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      af[kk][2 * h] = pack2<E>(c[2 * kk + h][0], c[2 * kk + h][1]);
      af[kk][2 * h + 1] = pack2<E>(c[2 * kk + h][2], c[2 * kk + h][3]);
    }
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
}

// the low n bits of a word (n in [0, 32])
__device__ __forceinline__ unsigned low_bits(int n) {
  return n >= 32 ? ~0u : (1u << max(n, 0)) - 1u;
}

// A key tile's row mask: bit t of a TN-bit word, held as NW = TN / 32
// words, says key t of the tile is visible to the row.
// Keeps bits [0, n) of w (n clamped to [0, 32 NW]).
template <int NW>
__device__ __forceinline__ void keep_bits(unsigned (&w)[NW], int n) {
#pragma unroll
  for (int k = 0; k < NW; ++k) w[k] &= low_bits(n - 32 * k);
}

// Sets bits [lo, hi) of w (clamped to [0, 32 NW]).
template <int NW>
__device__ __forceinline__ void set_bits(unsigned (&w)[NW], int lo, int hi) {
#pragma unroll
  for (int k = 0; k < NW; ++k)
    w[k] |= low_bits(hi - 32 * k) & ~low_bits(lo - 32 * k);
}

// Sets the bits of a tile of TN keys from k0 that a row's live cells
// cover: `row` is the row's cells of a (., nC) table of cells of bN keys,
// c0 .. c1 the cells the tile overlaps (one read a cell).
template <int NW>
__device__ __forceinline__ void cell_bits(unsigned (&w)[NW], const int* row,
                                          int c0, int c1, int bN, int k0) {
  for (int c = c0; c <= c1; ++c)
    if (row[c]) set_bits(w, c * bN - k0, (c + 1) * bN - k0);
}

// Q's A fragments of a warp's WM m16 row tiles, rows 16 (WM warp + wm)
// of sQ [.][D + kPad]: held in registers when QREG, else read from shared
// memory at each use; (*this)(f, wm, kd) gives row tile wm's at k16 step
// kd, the q_frag of attend_tile_mma.
template <int D, int WM, bool QREG, typename E>
struct QFrags {
  const E* sQ;
  int warp;
  unsigned held[QREG ? WM : 1][QREG ? D / 16 : 1][4];

  __device__ __forceinline__ QFrags(const E* sq, int w) : sQ(sq), warp(w) {
    if constexpr (QREG)
#pragma unroll
      for (int wm = 0; wm < WM; ++wm)
#pragma unroll
        for (int kd = 0; kd < D / 16; ++kd) load(held[wm][kd], wm, kd);
  }

  __device__ __forceinline__ void load(unsigned (&f)[4], int wm,
                                       int kd) const {
    const int lane = threadIdx.x % 32, mat = lane / 8, mr = lane % 8;
    mma16::ldmatrix_x4(f, sQ + (16 * (WM * warp + wm) + mr + 8 * (mat % 2)) *
                                   (D + kPad) + 16 * kd + 8 * (mat / 2));
  }

  __device__ __forceinline__ void operator()(unsigned (&f)[4], int wm,
                                             int kd) const {
    if constexpr (QREG) {
#pragma unroll
      for (int e = 0; e < 4; ++e) f[e] = held[wm][kd][e];
    } else {
      load(f, wm, kd);
    }
  }
};

// One key tile of the masked tensor-core forwards
// (blocksparse_attention.cu's, minference.cu's and
// flash_attention_varlen.cu's; attention_sink.cu's
// sink_fwd_mma loop body with the visibility test passed in, as
// attention_tile.cuh's attend_tile takes it on CUDA cores), for a warp's
// WM m16 row tiles: S = Q K^T over the TN keys of tK ([TN][D + kPad]),
// scaled into the exp2 domain in float32; where `masked`, -inf at each
// accumulator element (wm, h, nt, c) for which vis(wm, h, nt, c) is false
// (row 16 wm + g + 8 h of the warp's, key 8 nt + q2 + c of the tile);
// then the online softmax in the accumulator layout, m starting at -1e30
// (the floor that keeps a row that has seen only masked keys finite):
//   m_new = max(m, rowmax(S)); p = exp2(S - m_new)
//   l = l * exp2(m - m_new) + rowsum(p); acc = acc * exp2(m - m_new)
//   + dtype(p) V,
// l over the lane's own columns (quad_sum it at the end), P rounded to E
// straight into A fragments (to_frags) and P V through ldmatrix.trans of
// tV. q_frag(f, wm, kd) gives Q's A fragment of row tile wm at k16 step
// kd (QFrags: held registers or an ldmatrix).
template <int D, int TN, int WM, typename E, typename QFrag, typename Vis>
__device__ __forceinline__ void attend_tile_mma(
    const QFrag& q_frag, const E* tK, const E* tV, float scale, bool masked,
    Vis vis, float (&m)[WM][2], float (&l)[WM][2],
    float (&acc)[WM][D / 8][4]) {
  constexpr int LD = D + kPad;
  const int lane = threadIdx.x % 32, mat = lane / 8, mr = lane % 8;

  // S = Q K^T, each K fragment serving the warp's WM row tiles
  float s[WM][TN / 8][4];
#pragma unroll
  for (int wm = 0; wm < WM; ++wm) zero(s[wm]);
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    unsigned qa[WM][4];
#pragma unroll
    for (int wm = 0; wm < WM; ++wm) q_frag(qa[wm], wm, kd);
#pragma unroll
    for (int np = 0; np < TN / 16; ++np) {
      unsigned r[4];
      mma16::ldmatrix_x4(r, tK + (np * 16 + mr + 8 * (mat / 2)) * LD +
                                16 * kd + 8 * (mat % 2));
#pragma unroll
      for (int wm = 0; wm < WM; ++wm) {
        mma16::mma<E>(s[wm][2 * np], qa[wm], r[0], r[1]);
        mma16::mma<E>(s[wm][2 * np + 1], qa[wm], r[2], r[3]);
      }
    }
  }

  // scaled in float32; masked where the caller says
#pragma unroll
  for (int wm = 0; wm < WM; ++wm)
#pragma unroll
    for (int nt = 0; nt < TN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[wm][nt][e] * scale;
        s[wm][nt][e] =
            masked && !vis(wm, e >> 1, nt, e & 1) ? -INFINITY : x;
      }

  // online softmax
  unsigned pa[WM][TN / 16][4];
#pragma unroll
  for (int wm = 0; wm < WM; ++wm) {
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < TN / 8; ++nt)
        mx = fmaxf(mx, fmaxf(s[wm][nt][2 * h], s[wm][nt][2 * h + 1]));
      const float m_new = fmaxf(m[wm][h], quad_max(mx));
      alpha[h] = exp2f(m[wm][h] - m_new);
      m[wm][h] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int nt = 0; nt < TN / 8; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = exp2f(s[wm][nt][2 * h + c] - m_new);
          s[wm][nt][2 * h + c] = p;
          rs += p;
        }
      l[wm][h] = l[wm][h] * alpha[h] + rs;
    }
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[wm][nt][e] *= alpha[e >> 1];
    to_frags<TN, E>(pa[wm], s[wm]);
  }

  // O += dtype(P) V, each V fragment (ldmatrix.trans) serving WM tiles
#pragma unroll
  for (int kk = 0; kk < TN / 16; ++kk)
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      unsigned r[4];
      mma16::ldmatrix_x4_trans(r, tV + (kk * 16 + mr + 8 * (mat % 2)) * LD +
                                      np * 16 + 8 * (mat / 2));
#pragma unroll
      for (int wm = 0; wm < WM; ++wm) {
        mma16::mma<E>(acc[wm][2 * np], pa[wm][kk], r[0], r[1]);
        mma16::mma<E>(acc[wm][2 * np + 1], pa[wm][kk], r[2], r[3]);
      }
    }
}

// rows qw + 16 wm + g and + 8 (below S) of a (S, D) output in E from the
// warp's WM m16 accumulators: l > 0 ? acc / l : 0 (l the lane's partial
// sums, added over the quad here), so a row that saw no key is exactly 0
template <int D, int WM, typename E>
__device__ __forceinline__ void store_rows_div(E* out,
                                               const float (&acc)[WM][D / 8][4],
                                               const float (&l)[WM][2],
                                               int qw, int S) {
  const int lane = threadIdx.x % 32, g = lane / 4, q2 = (lane % 4) * 2;
#pragma unroll
  for (int wm = 0; wm < WM; ++wm)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = qw + 16 * wm + g + 8 * h;
      const float lt = quad_sum(l[wm][h]);
      if (i >= S) continue;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt)
        *reinterpret_cast<unsigned*>(out + (long long)i * D + 8 * nt + q2) =
            lt > 0.f ? pack2<E>(acc[wm][nt][2 * h] / lt,
                                acc[wm][nt][2 * h + 1] / lt)
                     : 0u;
    }
}

// rows r0 + g and r0 + g + 8 (below S) of a (S, D) float32 output from a
// 16 x D accumulator
template <int D>
__device__ __forceinline__ void store_rows(float* out,
                                           const float (&c)[D / 8][4],
                                           int r0, int S) {
  const int lane = threadIdx.x % 32, g = lane / 4, q2 = (lane % 4) * 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    if (r >= S) continue;
    float* row = out + (long long)r * D + q2;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<float2*>(row + 8 * nt) =
          make_float2(c[nt][2 * h], c[nt][2 * h + 1]);
  }
}

// Host side: the tensor-core instances a source builds, as (block_M,
// block_N) pairs. run_tile launches run.go<TM, TN>() for the pair
// (tm, tn) names among TM, TN, MORE...; (0, 0) names the first, the
// default; a pair without an instance gives cudaErrorInvalidValue.
template <int TM, int TN, int... MORE, typename Run>
int run_tile(int tm, int tn, const Run& run, bool first = true) {
  if ((first && tm == 0 && tn == 0) || (tm == TM && tn == TN))
    return run.template go<TM, TN>();
  if constexpr (sizeof...(MORE) > 0)
    return run_tile<MORE...>(tm, tn, run, false);
  return static_cast<int>(cudaErrorInvalidValue);
}

// flash_attention.cu's and attention_sink.cu's instances by head_dim,
// the default first (carver/roller.py's FLASH_KERNEL_TILES)
template <int D, typename Run>
int fwd_tiles(int tm, int tn, const Run& run) {
  if constexpr (D == 128)
    return run_tile<128, 64, 64, 64, 128, 32, 64, 32>(tm, tn, run);
  else if constexpr (D == 64)
    return run_tile<128, 64, 64, 64, 64, 128, 128, 32>(tm, tn, run);
  else
    return run_tile<64, 64>(tm, tn, run);
}

// blocksparse_attention.cu's, minference.cu's and
// flash_attention_varlen.cu's: fwd_tiles' pairs with block_N 64 (a row's
// mask is one 64-bit word; a tile over several cells ORs them in,
// cell_bits), the default first. The wrappers' BLOCKSPARSE_TILES,
// VS_TILES and VARLEN_TILES order them by timing.
template <int D, typename Run>
int mask_tiles(int tm, int tn, const Run& run) {
  if constexpr (D == 128)
    return run_tile<64, 64, 128, 64>(tm, tn, run);
  else if constexpr (D == 64)
    return run_tile<128, 64, 64, 64>(tm, tn, run);
  else
    return run_tile<64, 64>(tm, tn, run);
}

}  // namespace tl_attn
