// The attention tile step of attention_sink.cu, blocksparse_attention.cu and
// flash_attention_varlen.cu, on top of attention_common.cuh:
// csrc/flash_attention.cu's loop body (which keeps its own copy), with the
// visibility test given by the caller.
//
// A block of 128 threads holds BM query rows (Qs, unscaled, float32) and
// one tile of BN keys (Ks, Vs) in shared memory, odd row strides. Each
// thread owns rows ty + 16 a and keys tx + 8 c: it computes its 4 x 4
// scores with CUDA-core FMAs, scales them into the exp2 domain where
// vis(a, c) holds (-inf elsewhere), updates its rows' online softmax
// (ops/_online_softmax.py:39),
//   m_new = max(m, rowmax(S), -1e30); p = exp2(S - m_new)
//   l = l * exp2(m - m_new) + rowsum(p); acc = acc * exp2(m - m_new)
//   + dtype(p) @ V,
// with 8-lane shuffles, writes its P (rounded to the input type) to a
// shared tile only its own warp reads, and accumulates P @ V in registers.

#pragma once

#include "attention_common.cuh"

namespace tl_attn {

// shared memory of a block: Qs [BM][D + 1], Ks and Vs [BN][D + 1],
// Ps [BM][BN + 1], float32
template <int BM, int BN, int D>
constexpr size_t tile_smem_bytes() {
  return sizeof(float) * (BM * (D + 1) + 2 * BN * (D + 1) + BM * (BN + 1));
}

template <int BM, int BN, int D, int DT, typename Vis>
__device__ __forceinline__ void attend_tile(const float* Qs, const float* Ks,
                                            const float* Vs, float* Ps,
                                            float scale, Vis vis,
                                            float (&m)[BM / kTy],
                                            float (&l)[BM / kTy],
                                            float (&acc)[BM / kTy][D / kTx]) {
  constexpr int RM = BM / kTy;  // query rows per thread
  constexpr int CN = BN / kTx;  // keys per thread per tile
  constexpr int CD = D / kTx;   // output columns per thread
  constexpr int LD = D + 1, LP = BN + 1;
  const int ty = threadIdx.x / kTx, tx = threadIdx.x % kTx;

  float s[RM][CN];
#pragma unroll
  for (int a = 0; a < RM; ++a)
#pragma unroll
    for (int c = 0; c < CN; ++c) s[a][c] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float qa[RM], kc[CN];
#pragma unroll
    for (int a = 0; a < RM; ++a) qa[a] = Qs[(ty + kTy * a) * LD + d];
#pragma unroll
    for (int c = 0; c < CN; ++c) kc[c] = Ks[(tx + kTx * c) * LD + d];
#pragma unroll
    for (int a = 0; a < RM; ++a)
#pragma unroll
      for (int c = 0; c < CN; ++c) s[a][c] = fmaf(qa[a], kc[c], s[a][c]);
  }

#pragma unroll
  for (int a = 0; a < RM; ++a) {
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < CN; ++c) {
      s[a][c] = vis(a, c) ? s[a][c] * scale : -INFINITY;
      mx = fmaxf(mx, s[a][c]);
    }
    // the -1e30 floor keeps a row that has seen only masked keys finite
    const float m_new = fmaxf(m[a], fmaxf(group_max(mx), -1e30f));
    const float alpha = exp2f(m[a] - m_new);
    float rs = 0.f;
#pragma unroll
    for (int c = 0; c < CN; ++c) {
      const float p = exp2f(s[a][c] - m_new);
      rs += p;
      Ps[(ty + kTy * a) * LP + tx + kTx * c] = Elem<DT>::round(p);
    }
    l[a] = l[a] * alpha + group_sum(rs);
    m[a] = m_new;
#pragma unroll
    for (int e = 0; e < CD; ++e) acc[a][e] *= alpha;
  }
  __syncwarp();  // a row's P is written and read by the same 8 lanes

#pragma unroll 4
  for (int j = 0; j < BN; ++j) {
    float pa[RM], vc[CD];
#pragma unroll
    for (int a = 0; a < RM; ++a) pa[a] = Ps[(ty + kTy * a) * LP + j];
#pragma unroll
    for (int e = 0; e < CD; ++e) vc[e] = Vs[j * LD + tx + kTx * e];
#pragma unroll
    for (int a = 0; a < RM; ++a)
#pragma unroll
      for (int e = 0; e < CD; ++e) acc[a][e] = fmaf(pa[a], vc[e], acc[a][e]);
  }
}

}  // namespace tl_attn
