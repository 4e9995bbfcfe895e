// The dense GEMM's block and epilogue, shared by gemm.cu (float inputs)
// and gemm_s8.cu (int8 inputs): the grid is one-dimensional over the
// 128 x 128 tiles of C in tile_of's grouped raster.

#pragma once

#include "gemm_tile.cuh"

namespace tl_gemm {

// the block's tile, and where its operands start: A (M, K), or (K, M)
// when trans_a
struct DenseBlock {
  int m0, n0, rows;
  long long a_off, lda;

  __device__ DenseBlock(int M, int N, int K, bool trans_a) {
    int mt, nt;
    tile_of(blockIdx.x, (M + BM - 1) / BM, (N + BN - 1) / BN, mt, nt);
    m0 = mt * BM;
    n0 = nt * BN;
    rows = min(BM, M - m0);
    a_off = trans_a ? m0 : (long long)m0 * K;
    lda = trans_a ? M : K;
  }
};

// ReLU on the accumulator, then C[m0 + r, n0 + j]: V float into C of the
// float type `out`; V int into an int32 C
struct DenseEpilogue {
  void* c;
  int rows, m0, n0, N, out, relu;

  template <typename V>
  __device__ __forceinline__ void operator()(int r, int j, V v) const {
    const int n = n0 + j;
    if (r >= rows || n >= N) return;
    if (relu && v < V(0)) v = V(0);    // NaN stays NaN
    const long long at = (long long)(m0 + r) * N + n;
    if constexpr (std::is_same_v<V, int>) store(static_cast<int*>(c) + at, v);
    else store_as(c, at, out, v);
  }
};

// every row of A and B starts on 16 bytes: the base pointers and the row
// strides decide (the tiles start on 128 elements)
inline int dense_vec(const void* a, const void* b, int M, int N, int K,
                     int trans_a, int trans_b, int esize) {
  const int v = 16 / esize;
  return reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
         (trans_a ? M : K) % v == 0 && (trans_b ? K : N) % v == 0;
}

}  // namespace tl_gemm
