// GEMM scheduling variants for Hopper (sm_90a): split-K, stream-K and the
// block-sparse GEMM, on the block tile loop of gemm_tile.cuh.
//
// Replaces three TPU kernels of tilelang_mesh_tpu/ops/gemm_variants.py:
//   splitk_kernel (:36) -> tl_splitk_gemm (+ tl_splitk_reduce)
//     Cp (n_split, M, N) f32: Cp[s] = A[:, s L:(s+1) L] @ B[s L:(s+1) L]
//     with L = split_len, one block a (tile, split); the reduce sums Cp
//     over s in split order and rounds once to C's type (the JAX wrapper's
//     jnp.sum + astype, :83).
//   streamk_kernel (:104) -> tl_streamk_gemm (+ tl_streamk_fixup)
//     Part (n_seg, bm, bn) f32: segment s is the K range [k0, k0 + kl)
//     (in block_K units, host-planned) of output tile (tm, tn). One
//     block a stream-K program: it runs the program's segments (`prog`
//     (n_prog + 1) gives the runs) one after another, so every block has
//     the same K work; the TPU kernel's one grid step a segment would
//     leave the card ~2 blocks a program of unequal length. The fixup
//     sums each tile's segments in segment order (contiguous too: `first`
//     (n_tiles + 1)) and rounds once (the JAX wrapper's segment_sum,
//     :159).
//   blocksparse_gemm_kernel (:206) -> tl_blocksparse_gemm
//     C (M, N) = A @ B where the (M / bm, N / bn) mask cell is nonzero,
//     exactly 0 elsewhere. One block a 128 x 128 tile of C: a tile none
//     of whose cells is live writes zeros and skips the K loop; a live
//     one runs it and zeroes the elements of its dead cells, so any cell
//     size works.
//
// The TPU kernels write partials and leave the sums to XLA because the
// TPU has no global atomics; here a second small kernel sums them, in
// the same order, so the result does not depend on the blocks' timing.
// Float32 runs FFMA, bfloat16 and float16 mma.sync m16n8k16 (f32
// accumulate); a 128 x 128 block tile for every variant.
//
// Bounds. Split-K is for the skinny decode products: at M 16, K 4096, N
// 11008 in bf16 it moves 90.7 MB (B dominates) for 1.4 GFLOP, so bytes
// bound it (27 us); one block a column panel would leave 46 of 132 SMs
// idle and walk all of K alone, n_split blocks a panel fill the card.
// The workspace costs n_split M N 4 bytes each way (5.6 MB here). Stream-
// K at a 512-token prefill (M 512, K 4096, N 11008: 344 tiles, 2.6 waves
// of 132) is operations-bound (46 GFLOP, 47 us in bf16); with one
// program a block the card holds at once, every block does the same K
// work in one wave, with no partial last wave. Block-sparse
// at a 4096-token prefill is operations-bound on its live tiles.

#include "gemm_tile.cuh"

namespace {

using namespace tl_gemm;

// The block's product of A rows at `a` (rows of them, row stride lda)
// and B at `b` (row stride N, columns n0 .. n0 + BN, cut at N) over
// depth K; fn(r, j, v) for each accumulator (block-local row r, column
// j). T: float (FFMA), __nv_bfloat16 or __half (mma.sync).
template <typename T, class Fn>
__device__ __forceinline__ void tile_product(const T* a, long long lda,
                                             const T* b, int rows, int n0,
                                             int K, int N, bool vec, Fn fn) {
  if constexpr (std::is_same_v<T, float>) {
    const f32::Direct<false, false> src{a, b, lda, rows, n0, K, N, vec};
    f32::Acc acc;
    f32::loop<false, false>(src, (K + f32::BK - 1) / f32::BK, acc);
    f32::for_each<false, false>(acc, fn);
  } else {
    const Direct<T, bf16::BK, bf16::PAD, false, false> src{a, b, lda, rows,
                                                          n0, K, N, vec};
    bf16::Acc<float> acc;
    bf16::loop<false, false>(src, (K + bf16::BK - 1) / bf16::BK, acc);
    bf16::for_each(acc, fn);
  }
}

// blockIdx.y is the split: its K range is [s L, (s + 1) L)
template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
splitk_gemm(const T* __restrict__ a, const T* __restrict__ b,
            float* __restrict__ ws, int M, int N, int K, int split_len,
            int vec) {
  int mt, nt;
  tile_of(blockIdx.x, (M + BM - 1) / BM, (N + BN - 1) / BN, mt, nt);
  const int m0 = mt * BM, n0 = nt * BN, rows = min(BM, M - m0);
  const long long k0 = (long long)blockIdx.y * split_len;
  float* part = ws + (long long)blockIdx.y * M * N;
  tile_product<T>(a + (long long)m0 * K + k0, K, b + k0 * N, rows, n0,
                  split_len, N, vec != 0, [&](int r, int j, float v) {
                    if (r < rows && n0 + j < N)
                      part[(long long)(m0 + r) * N + n0 + j] = v;
                  });
}

// c[i] = sum over s (in order) of ws[s][i], rounded once to `out`
__global__ void __launch_bounds__(kThreads)
splitk_reduce(const float* __restrict__ ws, void* __restrict__ c,
              long long MN, int n_split, int out) {
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < MN;
       i += (long long)gridDim.x * kThreads) {
    float v = ws[i];
    for (int s = 1; s < n_split; ++s) v += ws[s * MN + i];
    store_as(c, i, out, v);
  }
}

// tables: tile_m, tile_n, k_start, k_len (k in block_K units), n_seg
// each; block p runs segments prog[p] .. prog[p + 1] in order (the tile
// loop ends with every thread past its last read of shared memory, so the
// next segment's first loads may land)
template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
streamk_gemm(const T* __restrict__ a, const T* __restrict__ b,
             const int* __restrict__ tile_m, const int* __restrict__ tile_n,
             const int* __restrict__ k_start, const int* __restrict__ k_len,
             const int* __restrict__ prog, float* __restrict__ part, int N,
             int K, int bm, int bn, int bk, int vec) {
  for (int s = prog[blockIdx.x]; s < prog[blockIdx.x + 1]; ++s) {
    const int m0 = tile_m[s] * bm, n0 = tile_n[s] * bn;
    const long long k0 = (long long)k_start[s] * bk;
    float* p = part + (long long)s * bm * bn;
    tile_product<T>(a + (long long)m0 * K + k0, K, b + k0 * N, bm, n0,
                    k_len[s] * bk, N, vec != 0, [&](int r, int j, float v) {
                      if (r < bm && j < bn) p[r * bn + j] = v;
                    });
  }
}

// c[m, n] = the sum of tile (m / bm, n / bn)'s segments, in order
__global__ void __launch_bounds__(kThreads)
streamk_fixup(const float* __restrict__ part, const int* __restrict__ first,
              void* __restrict__ c, int M, int N, int bm, int bn, int out) {
  const long long MN = (long long)M * N;
  const int n_tn = N / bn;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < MN;
       i += (long long)gridDim.x * kThreads) {
    const int m = (int)(i / N), n = (int)(i % N);
    const int t = (m / bm) * n_tn + n / bn;
    const long long at = (long long)(m % bm) * bn + n % bn;
    const long long tile = (long long)bm * bn;
    float v = part[first[t] * tile + at];
    for (int s = first[t] + 1; s < first[t + 1]; ++s) v += part[s * tile + at];
    store_as(c, i, out, v);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
blocksparse_gemm(const T* __restrict__ a, const T* __restrict__ b,
                 const int* __restrict__ mask, void* __restrict__ c, int M,
                 int N, int K, int bm, int bn, int out, int vec) {
  int mt, nt;
  tile_of(blockIdx.x, (M + BM - 1) / BM, (N + BN - 1) / BN, mt, nt);
  const int m0 = mt * BM, n0 = nt * BN;
  const int rows = min(BM, M - m0), cols = min(BN, N - n0);
  const int n_cn = N / bn;
  // the mask cells the tile overlaps: rows cr0..cr1, columns cc0..cc1
  const int cr0 = m0 / bm, cr1 = (m0 + rows - 1) / bm;
  const int cc0 = n0 / bn, cc1 = (n0 + cols - 1) / bn;
  const int ncc = cc1 - cc0 + 1;
  int any = 0;
  for (int i = threadIdx.x; i < (cr1 - cr0 + 1) * ncc; i += kThreads)
    any |= mask[(cr0 + i / ncc) * n_cn + cc0 + i % ncc] != 0;
  if (!__syncthreads_or(any)) {
    for (int i = threadIdx.x; i < rows * cols; i += kThreads)
      store_as(c, (long long)(m0 + i / cols) * N + n0 + i % cols, out, 0.f);
    return;
  }
  tile_product<T>(a + (long long)m0 * K, K, b, rows, n0, K, N, vec != 0,
                  [&](int r, int j, float v) {
                    const int m = m0 + r, n = n0 + j;
                    if (r >= rows || j >= cols) return;
                    const bool live = mask[(m / bm) * n_cn + n / bn] != 0;
                    store_as(c, (long long)m * N + n, out, live ? v : 0.f);
                  });
}

// blocks for an elementwise pass over n elements, kThreads a block
unsigned elementwise_blocks(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return (unsigned)(b < 65536 ? b : 65536);
}

// the 16-byte path: every row of A (stride K) and B (stride N), and every
// K offset the blocks start at (a multiple of `step`), on 16 bytes
int vec_of(const void* a, const void* b, int K, int N, int step, int esize) {
  return vec_ok(a, b, K, N, false, esize) && step % (16 / esize) == 0;
}

int esize_of(int in_type) { return in_type == kF32 ? 4 : 2; }

}  // namespace

// Each launches on `stream` and returns cudaGetLastError() (0 =
// launched). in_type: kF32, kBF16 or kF16 (gemm_tile.cuh DType); out:
// kF32, kBF16, kF16 or kFP8. The Python wrappers check shapes, types,
// devices and the grids' ranges before calling.

// a (M, K), b (K, N) -> ws (n_split, M, N) f32, split_len = K / n_split
extern "C" int tl_splitk_gemm(const void* a, const void* b, float* ws,
                              int M, int N, int K, int n_split,
                              int split_len, int in_type, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(tile_count(M, N), n_split);
  const int vec = vec_of(a, b, K, N, split_len, esize_of(in_type));
  if (in_type == kF32)
    splitk_gemm<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), ws, M, N,
        K, split_len, vec);
  else if (in_type == kBF16)
    splitk_gemm<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b), ws, M, N, K, split_len, vec);
  else
    splitk_gemm<__half><<<grid, kThreads, 0, s>>>(
        static_cast<const __half*>(a), static_cast<const __half*>(b), ws, M,
        N, K, split_len, vec);
  return (int)cudaGetLastError();
}

// ws (n_split, MN) f32 -> c (MN) in out_type
extern "C" int tl_splitk_reduce(const float* ws, void* c, long long MN,
                                int n_split, int out_type, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  splitk_reduce<<<elementwise_blocks(MN), kThreads, 0, s>>>(ws, c, MN,
                                                            n_split, out_type);
  return (int)cudaGetLastError();
}

// a (M, K), b (K, N), four int32 tables of n_seg, prog (n_prog + 1)
// int32 -> part (n_seg, bm, bn) f32; bm, bn <= 128
extern "C" int tl_streamk_gemm(const void* a, const void* b,
                               const int* tile_m, const int* tile_n,
                               const int* k_start, const int* k_len,
                               const int* prog, float* part, int n_prog,
                               int N, int K, int bm, int bn, int bk,
                               int in_type, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int vec = vec_of(a, b, K, N, bk, esize_of(in_type));
  if (in_type == kF32)
    streamk_gemm<float><<<n_prog, kThreads, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), tile_m,
        tile_n, k_start, k_len, prog, part, N, K, bm, bn, bk, vec);
  else if (in_type == kBF16)
    streamk_gemm<__nv_bfloat16><<<n_prog, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b), tile_m, tile_n, k_start, k_len,
        prog, part, N, K, bm, bn, bk, vec);
  else
    streamk_gemm<__half><<<n_prog, kThreads, 0, s>>>(
        static_cast<const __half*>(a), static_cast<const __half*>(b), tile_m,
        tile_n, k_start, k_len, prog, part, N, K, bm, bn, bk, vec);
  return (int)cudaGetLastError();
}

// part (n_seg, bm, bn) f32, first (M / bm * N / bn + 1) int32 -> c (M, N)
extern "C" int tl_streamk_fixup(const float* part, const int* first, void* c,
                                int M, int N, int bm, int bn, int out_type,
                                void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  streamk_fixup<<<elementwise_blocks((long long)M * N), kThreads, 0, s>>>(
      part, first, c, M, N, bm, bn, out_type);
  return (int)cudaGetLastError();
}

// Blocks of the stream-K kernel an SM holds at once, for in_type: the
// card runs SMs x this many programs in one wave. Returns the CUDA error.
extern "C" int tl_streamk_blocks_per_sm(int in_type, int* blocks) {
  cudaError_t e;
  if (in_type == kF32)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, streamk_gemm<float>, kThreads, 0);
  else if (in_type == kBF16)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, streamk_gemm<__nv_bfloat16>, kThreads, 0);
  else
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, streamk_gemm<__half>, kThreads, 0);
  return (int)e;
}

// a (M, K), b (K, N), mask (M / bm, N / bn) int32 -> c (M, N) in out_type
extern "C" int tl_blocksparse_gemm(const void* a, const void* b,
                                   const int* mask, void* c, int M, int N,
                                   int K, int bm, int bn, int in_type,
                                   int out_type, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int vec = vec_of(a, b, K, N, 0, esize_of(in_type));
  if (in_type == kF32)
    blocksparse_gemm<float><<<tile_count(M, N), kThreads, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), mask, c,
        M, N, K, bm, bn, out_type, vec);
  else if (in_type == kBF16)
    blocksparse_gemm<__nv_bfloat16><<<tile_count(M, N), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b), mask, c, M, N, K, bm, bn,
        out_type, vec);
  else
    blocksparse_gemm<__half><<<tile_count(M, N), kThreads, 0, s>>>(
        static_cast<const __half*>(a), static_cast<const __half*>(b), mask, c,
        M, N, K, bm, bn, out_type, vec);
  return (int)cudaGetLastError();
}
