// Shared pieces of the varlen attention kernels (flash_attention_varlen.cu,
// varlen_bwd.cu), on top of attention_common.cuh.
//
// The packed operands carry per-token int32 sequence ids and local
// positions; query i sees key j when seq_q[i] == seq_k[j] (and, causal,
// pos_q[i] >= pos_k[j]). Pad tokens hold ids -1 (Q) and -2 (K), which
// never match; rows a kernel tile reads past the packed length get the
// same fills here.
//
// The liveness table BlockLive (nR, nC) int32 marks (query block, key
// block) pairs, of bR x bC tokens, that may hold a visible pair. Its
// blocks are the caller's (the JAX factory's block_M, block_N), not the
// kernels' tiles, so a kernel tile is a candidate when any cell it
// overlaps is live, and is computed when, besides, one of its pairs is
// visible (computes_tile); a skipped tile adds exactly nothing, and the
// elementwise mask keeps every result exact.

#pragma once

#include <limits.h>

#include "attention_common.cuh"

namespace tl_varlen {

using namespace tl_attn;

// entries [r0, r0 + R) of an int32 vector of length S, `fill` past S
template <int R>
__device__ __forceinline__ void load_ids(int* dst, const int* src, int r0,
                                         int S, int fill) {
  for (int i = threadIdx.x; i < R; i += kThreads)
    dst[i] = r0 + i < S ? src[r0 + i] : fill;
}

// the table's cells [a0, a1] of the tokens [t0, t1) of one axis
struct Cells {
  int a0, a1;
};

__device__ __forceinline__ Cells cells_of(int t0, int t1, int block) {
  return {t0 / block, (t1 - 1) / block};
}

// query i sees key j
__device__ __forceinline__ bool visible(int sq, int pq, int sk, int pk,
                                        int causal) {
  return sq == sk && (!causal || pq >= pk);
}

// Per thread: is a cell of rows r x columns c of the (., nC) table live?
__device__ __forceinline__ bool cells_live(const int* __restrict__ live,
                                           int nC, Cells r, Cells c) {
  for (int a = r.a0; a <= r.a1; ++a)
    for (int b = c.a0; b <= c.a1; ++b)
      if (live[(long long)a * nC + b]) return true;
  return false;
}

// Block-wide (one barrier): is a cell among rows r x columns c of the
// (., nC) table live? Each thread reads a share of the cells. (The
// block-sparse kernel's vote: every thread running cells_live into
// __syncthreads_or decides the same, bit for bit, but ptxas then gave
// its tile loop fewer registers and it ran slower on the card.)
__device__ __forceinline__ bool any_live(const int* __restrict__ live,
                                         int nC, Cells r, Cells c) {
  const int w = c.a1 - c.a0 + 1, n = (r.a1 - r.a0 + 1) * w;
  int hit = 0;
  for (int idx = threadIdx.x; idx < n && !hit; idx += kThreads)
    hit = live[(long long)(r.a0 + idx / w) * nC + c.a0 + idx % w] != 0;
  return __syncthreads_or(hit) != 0;
}

// Block-wide (three barriers): the first and last index along one axis
// of a live cell among rows r x columns c of the (., nC) table. COLS:
// the column index (the forward and dQ, row by row), else the row index
// (dK/dV, the table read transposed). `red` is two ints of shared
// memory. Returns lo > hi when no cell is live.
template <bool COLS>
__device__ __forceinline__ Cells live_span(const int* __restrict__ live,
                                           int nC, Cells r, Cells c,
                                           int* red) {
  if (threadIdx.x == 0) {
    red[0] = INT_MAX;
    red[1] = -1;
  }
  __syncthreads();
  const int w = c.a1 - c.a0 + 1, n = (r.a1 - r.a0 + 1) * w;
  int lo = INT_MAX, hi = -1;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int row = r.a0 + i / w, col = c.a0 + i % w;
    if (live[(long long)row * nC + col]) {
      const int at = COLS ? col : row;
      lo = min(lo, at);
      hi = max(hi, at);
    }
  }
  if (lo <= hi) {
    atomicMin(&red[0], lo);
    atomicMax(&red[1], hi);
  }
  __syncthreads();
  const Cells out{red[0], red[1]};
  __syncthreads();  // every thread has read `red` before it is reused
  return out;
}

// the kernel tiles of `tile` tokens, among n_tiles, that cover the
// table's cells s of `block` tokens (lo > hi when s is empty)
__device__ __forceinline__ Cells tiles_of(Cells s, int block, int tile,
                                          int n_tiles) {
  if (s.a0 > s.a1) return {1, 0};
  return {s.a0 * block / tile, min(n_tiles - 1, ((s.a1 + 1) * block - 1) / tile)};
}

// Block-wide (one barrier): does the block compute the next tile? It
// does when a cell of the tile's rows r x columns c of the table is live
// and one of the tile's pairs is visible: a live cell can hold kernel
// tiles with no visible pair (a tile of one document's rows against
// another's keys in a cell that straddles the boundary, a tile above a
// document's diagonal). The block's own R ids (own_s, own_p) are in
// shared memory; the tile's C ids are read from global memory from t0,
// `fill` past n: one per thread. OWN_Q: the block's ids are the queries
// (the forward, dQ), else the keys (dK/dV). The barrier is also the one
// the caller needs before it overwrites the previous tile's shared data.
template <int R, int C, bool OWN_Q>
__device__ __forceinline__ bool computes_tile(
    const int* __restrict__ live, int nC, Cells r, Cells c,
    const int* own_s, const int* own_p, const int* __restrict__ seq,
    const int* __restrict__ pos, int t0, int n, int fill, int causal) {
  static_assert(kThreads % C == 0, "a thread keeps one of the tile's ids");
  int hit = 0;
  if (cells_live(live, nC, r, c)) {
    const int t = t0 + threadIdx.x % C;
    const int ts = t < n ? seq[t] : fill, tp = t < n ? pos[t] : 0;
    for (int i = threadIdx.x / C; i < R; i += kThreads / C)
      hit |= OWN_Q ? visible(own_s[i], own_p[i], ts, tp, causal)
                   : visible(ts, tp, own_s[i], own_p[i], causal);
  }
  return __syncthreads_or(hit) != 0;
}

// The live key tiles of TN keys, in order, of a block whose query rows
// span the table's row cells r: tile kb < n (keys [kb TN, kb TN + TN)
// below Sk) is live when a cell of r x its column cells is live (one read
// when it lies in one cell). A warp tests 32 tiles at once (a ballot)
// and keeps the word; every warp of the block scans alike, so each knows
// the next live tile with no barrier and no list in shared memory. Call
// next() from warp-uniform code with `from` never decreasing.
// ROWS: the same scan along the other axis, the table read transposed
// (dK/dV): the tiles are of TN query rows below Sk = Tq, in the table's
// row cells of bN = bM rows, and r is the block's key (column) cells.
template <int TN, bool ROWS = false>
struct LiveTiles {
  const int* __restrict__ live;
  int nC, bN, Sk, n;
  Cells r;
  int base = -32;     // tiles [base, base + 32) are tested in `word`
  unsigned word = 0;

  // the first live tile at or after `from`, n when none is left
  __device__ __forceinline__ int next(int from) {
    while (from < n) {
      if (from >= base + 32) {
        base = from;
        const int kb = base + threadIdx.x % 32, k0 = kb * TN;
        word = __ballot_sync(
            kFull,
            kb < n &&
                (ROWS ? cells_live(live, nC,
                                   cells_of(k0, min(k0 + TN, Sk), bN), r)
                      : cells_live(live, nC, r,
                                   cells_of(k0, min(k0 + TN, Sk), bN))));
      }
      const unsigned w = word >> (from - base);
      if (w) return from + __ffs(w) - 1;
      from = base + 32;
    }
    return n;
  }
};

}  // namespace tl_varlen
