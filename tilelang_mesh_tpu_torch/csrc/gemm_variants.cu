// GEMM scheduling variants for Hopper (sm_90a): split-K, stream-K and the
// block-sparse GEMM, on the block tile loop of gemm_tile.cuh, and
// stream-K and the block-sparse GEMM in bfloat16 / float16 on
// gemm_sm90.cuh's TMA + wgmma body.
//
// Replaces three TPU kernels of tilelang_mesh_tpu/ops/gemm_variants.py:
//   splitk_kernel (:36) -> tl_splitk_stream (+ tl_splitk_stream_combine)
//     at few rows, tl_splitk_gemm (+ tl_splitk_reduce) past them
//     Cp (n_split, M, N) f32: Cp[s] = A[:, s L:(s+1) L] @ B[s L:(s+1) L]
//     with L = split_len; C is the sum of Cp over s in split order,
//     rounded once to C's type (the JAX wrapper's jnp.sum + astype, :83).
//     ops/gemm_variants.py::splitk_path picks the kernel by the rows, the
//     type and the alignment.
//   streamk_kernel (:104) -> tl_streamk_tma or tl_streamk_gemm (+
//     tl_streamk_fixup)
//     Part (n_seg, bm, bn) f32: segment s is the K range [k0, k0 + kl)
//     (in block_K units, host-planned) of output tile (tm, tn). One
//     block a stream-K program: it runs the program's segments (`prog`
//     (n_prog + 1) gives the runs) one after another, so every block has
//     the same K work; the TPU kernel's one grid step a segment would
//     leave the card ~2 blocks a program of unequal length. The fixup
//     sums each tile's segments in segment order (contiguous too: `first`
//     (n_tiles + 1)) and rounds once (the JAX wrapper's segment_sum,
//     :159). ops/gemm_variants.py::streamk_path picks the kernel:
//     tl_streamk_tma (streamk_tma, below) for bfloat16 / float16 at the
//     tiles of TL_SM90_BLOCKS on 16-byte aligned operands, one block an
//     SM; tl_streamk_gemm (the tile loop, up to 128 x 128) for the rest.
//   blocksparse_gemm_kernel (:206) -> tl_blocksparse_tma or
//     tl_blocksparse_gemm
//     C (M, N) = A @ B where the (M / bm, N / bn) mask cell is nonzero,
//     exactly 0 elsewhere. One block a tile of C: a tile none of whose
//     cells is live writes zeros and skips the K loop; a live one runs it
//     and zeroes the elements of its dead cells, so any cell size works.
//     ops/gemm_variants.py::blocksparse_path picks the kernel:
//     tl_blocksparse_tma (blocksparse_tma, below: gemm_sm90.cuh's
//     producer warpgroup, two consumer warpgroups and ring at a 128 x
//     128 x 64 tile, which lies in one of the main path's 128-square
//     cells) for bfloat16 / float16 on 16-byte aligned operands;
//     tl_blocksparse_gemm (the tile loop, 128 x 128) for the rest.
//
// The TPU kernels write partials and leave the sums to XLA because the
// TPU has no global atomics; here a second small kernel sums them, in
// the same order, so the result does not depend on the blocks' timing.
// On the tile loop float32 runs FFMA, bfloat16 and float16 mma.sync
// m16n8k16 (f32 accumulate); a 128 x 128 block tile for every variant.
//
// Bounds. Split-K is for the skinny decode products: at M 16, K 4096, N
// 11008 in bf16 it moves 90.7 MB (B dominates) for 1.4 GFLOP, so bytes
// bound it (27 us; the down product, K 11008 -> N 4096, 26.9 us).
//
// Split-K at few rows (tl_splitk_stream, up to 64 rows; float32,
// bfloat16, float16): the weights B are read once, 16 bytes a thread.
// The grid is the host's plan (ops/gemm_variants.py::
// splitk_stream_plan), not the split count: a block owns a strip of 64
// columns of B and a sub-range of one split's K, as many sub-ranges as
// one wave of resident blocks takes (the down product's plan keeps 2
// splits of 5504 and cuts each into 4: 512 blocks for 528 slots; the
// gate/up product's 8 splits of 512 need no cut). Each of its four warps
// takes a contiguous run of the sub-range's 16-row k-steps and copies
// them by cp.async three steps ahead (two in float32) into its own ring:
// B's 16 x 64 tile (2 KB in 16 bits, 4 KB in float32, through L2 only)
// and A's rows of those 16 k (A is small: through L1, which the other
// strips' blocks on the SM share). HBM3 at 3.35 TB/s with about a
// microsecond of latency wants 3.35e12 x 1e-6 / 132 = 25 KB in flight
// an SM; four blocks of four warps with three 2 KB steps in flight hold
// 96 KB (float32 at 16 rows: three blocks, two 4 KB steps, 96 KB).
// 16-bit: mma.sync m16n8k16, A's rows the m16 operand (ldmatrix), B
// through ldmatrix.trans, R / 16 m16 tiles of rows. float32: FFMA, a
// lane owns two columns, A's four k of a row read as one float4. The
// warps' sums meet in a fixed order in shared memory (((w0 + w1) + w2) +
// w3), the block writes its float32 partial (M x 64) of the workspace
// (n_split x n_sub, M, N), and tl_splitk_stream_combine adds the
// partials in (split, sub-range) order: all of them, rounded once to C's
// type, for matmul_splitk; each split's own, in float32, for the factory's
// Cp. No floating-point atomics: two runs give the same bits. A's rows
// are read again by each of the 172 strips of the gate/up product, which
// makes 16 rows slower than one (PERF.md has both times).
//
// Past the rows (tl_splitk_gemm): one block a (128 x 128 tile, split) on
// gemm_tile.cuh's loop. The workspace costs n_split M N 4 bytes each way
// (5.6 MB at the gate/up shape, 8 splits). Stream-
// K at a 512-token prefill (M 512, K 4096, N 11008: 344 tiles, 2.6 waves
// of 132) is operations-bound (46 GFLOP, 47 us in bf16); with one
// program a block the card holds at once, every block does the same K
// work in one wave, with no partial last wave. On the TMA path that is
// 132 programs (one block an SM) and about 476 segments of 64 KB at the
// 128 x 128 tile: 31 MB of partials written and read back by the fixup,
// some 20 us of HBM time beside the 47 us of products. Block-sparse
// at a 4096-token prefill is operations-bound on its live tiles (LLaMA-
// 2-7B's gate/up, 128-square cells at density 0.5: 187 GFLOP, 0.19 ms
// at the bf16 peak, against 135 MB of operands and C, 0.04 ms); the TMA
// kernel runs the live tiles at gm.matmul's rate, and a dead tile costs
// its zeros' stores.

#include "gemm_sm90.cuh"
#include "gemm_tile.cuh"

namespace {

using namespace tl_gemm;
namespace sm90 = tl_sm90;

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

// ---------------------------------------------------------------------------
// split-K at few rows: the weights streamed once
// ---------------------------------------------------------------------------

constexpr int kStWarps = 4;                  // warps a block
constexpr int kStThreads = 32 * kStWarps;
constexpr int kStCols = 64;                  // B's columns a block (a strip)
constexpr int kStK = 16;                     // k rows a step, 16 a multiple
constexpr int kStStages16 = 4;               // a warp's ring: 16-bit types
constexpr int kStStages32 = 3;               //               float32

// gemm_tile.cuh's cp_async16 through L1 (.ca): A's rows, which the
// blocks of the other strips on the SM read too
__device__ __forceinline__ void cp_async16_ca(void* dst, const void* src,
                                              bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

// A stage of a warp's ring: B's rows [k, k + kStK) x the strip's
// columns, then A's R rows x those k; each row padded by one 16-byte
// chunk to an odd count of chunks (ldmatrix and the float2 / float4
// reads hit distinct banks).
template <typename T, int R>
struct Stream {
  static constexpr int V = 16 / sizeof(T);    // elements a 16-byte chunk
  static constexpr int kLdB = kStCols + V;
  static constexpr int kLdA = kStK + V;
  static constexpr int kStages = sizeof(T) == 4 ? kStStages32 : kStStages16;
  static constexpr int kStage = kStK * kLdB + R * kLdA;  // elements
  // a lane's sums: float32 R rows x its two columns; 16-bit the m16n8
  // tiles' (R / 16 x kStCols / 8 of them) four
  static constexpr int kVals = sizeof(T) == 4 ? 2 * R
                                              : R / 16 * kStCols / 8 * 4;
  static constexpr size_t kRing = (size_t)kStWarps * kStages * kStage *
                                  sizeof(T);
  static constexpr size_t kRed = (size_t)(kStWarps - 1) * kVals * 32 * 4;
  static constexpr size_t kSmem = kRing > kRed ? kRing : kRed;
};

// grid (ceil(N / kStCols), n_split * n_sub); block p is sub-range p %
// n_sub of split p / n_sub: K rows [k0, k1) with k0 = split L + sub
// sub_len, k1 = min(k0 + sub_len, (split + 1) L); it writes ws[p] (M x
// N) on its strip. Needs K, N and the split / sub-range starts on 16
// bytes of T, and the bases on 16 bytes (ops/gemm_variants.py::
// splitk_path).
template <typename T, int R>
__global__ void __launch_bounds__(kStThreads)
splitk_stream(const T* __restrict__ a, const T* __restrict__ b,
              float* __restrict__ ws, int M, int N, int K, int split_len,
              int n_sub, int sub_len) {
  using S = Stream<T, R>;
  constexpr int V = S::V, CB = kStCols / V, CA = kStK / V;
  extern __shared__ __align__(16) char st_smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * kStCols;
  const int split = blockIdx.y / n_sub, sub = blockIdx.y % n_sub;
  const int k0 = split * split_len + sub * sub_len;
  const int k1 = min(k0 + sub_len, (split + 1) * split_len);
  const int steps = (k1 - k0 + kStK - 1) / kStK;
  const int per = (steps + kStWarps - 1) / kStWarps;
  const int s0 = min(warp * per, steps), s1 = min(s0 + per, steps);
  T* ring = reinterpret_cast<T*>(st_smem) + warp * S::kStages * S::kStage;

  // step st into its slot: B's rows k.. of the strip, A's R rows of
  // those k; zeros past k1, past N and past M (an empty group past s1)
  auto fetch = [&](int st) {
    T* dst = ring + (st - s0) % S::kStages * S::kStage;
    const int k = k0 + st * kStK;
    if (st < s1) {
#pragma unroll
      for (int c = lane; c < kStK * CB; c += 32) {
        const int r = c / CB, col = n0 + (c % CB) * V;
        const bool ok = k + r < k1 && col < N;
        tl_gemm::cp_async16(dst + r * S::kLdB + (c % CB) * V,
                            ok ? b + (long long)(k + r) * N + col : b, ok);
      }
      T* As = dst + kStK * S::kLdB;
#pragma unroll
      for (int c = lane; c < R * CA; c += 32) {
        const int m = c / CA, kc = k + (c % CA) * V;
        const bool ok = m < M && kc < k1;
        cp_async16_ca(As + m * S::kLdA + (c % CA) * V,
                      ok ? a + (long long)m * K + kc : a, ok);
      }
    }
    tl_gemm::cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < S::kStages - 1; ++i) fetch(s0 + i);

  constexpr int MT = R / 16, NT = kStCols / 8;
  static_assert(kStCols == 64, "float32: a lane owns two of 64 columns");
  float acc[S::kVals];
#pragma unroll
  for (int i = 0; i < S::kVals; ++i) acc[i] = 0.f;
  for (int st = s0; st < s1; ++st) {
    tl_gemm::cp_async_wait<S::kStages - 2>();   // this lane's copies of st
    __syncwarp();   // the warp's copies of st; everyone done with st - 1
    fetch(st + S::kStages - 1);                 // into st - 1's slot
    const T* Bs = ring + (st - s0) % S::kStages * S::kStage;
    const T* As = Bs + kStK * S::kLdB;
    if constexpr (sizeof(T) == 4) {
      // lane: columns 2 lane, 2 lane + 1; acc[2 r + j] row r, column j
#pragma unroll
      for (int kq = 0; kq < kStK / 4; ++kq) {
        float2 bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          bv[i] = *reinterpret_cast<const float2*>(
              Bs + (4 * kq + i) * S::kLdB + 2 * lane);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 av = *reinterpret_cast<const float4*>(
              As + r * S::kLdA + 4 * kq);
          float x = acc[2 * r], y = acc[2 * r + 1];
          x = fmaf(av.x, bv[0].x, x);
          y = fmaf(av.x, bv[0].y, y);
          x = fmaf(av.y, bv[1].x, x);
          y = fmaf(av.y, bv[1].y, y);
          x = fmaf(av.z, bv[2].x, x);
          y = fmaf(av.z, bv[2].y, y);
          x = fmaf(av.w, bv[3].x, x);
          y = fmaf(av.w, bv[3].y, y);
          acc[2 * r] = x;
          acc[2 * r + 1] = y;
        }
      }
    } else {
      // acc[(mt NT + nt) 4 + e]: the m16n8 tile (mt, nt) of rows 16 mt
      // and columns 8 nt of the strip
      const int mat = lane / 8, mr = lane % 8;
#pragma unroll
      for (int kk = 0; kk < kStK / 16; ++kk) {
        unsigned af[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          bf16::ldmatrix_x4(af[mt], As + (16 * mt + mr + 8 * (mat % 2)) *
                                             S::kLdA + 16 * kk +
                                             8 * (mat / 2));
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          unsigned r[4];
          bf16::ldmatrix_x4_trans(
              r, Bs + (16 * kk + mr + 8 * (mat % 2)) * S::kLdB + 16 * np +
                     8 * (mat / 2));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            float(&c0)[4] =
                *reinterpret_cast<float(*)[4]>(acc + (mt * NT + 2 * np) * 4);
            float(&c1)[4] = *reinterpret_cast<float(*)[4]>(
                acc + (mt * NT + 2 * np + 1) * 4);
            bf16::mma<T>(c0, af[mt], r[0], r[1]);
            bf16::mma<T>(c1, af[mt], r[2], r[3]);
          }
        }
      }
    }
  }
  tl_gemm::cp_async_wait<0>();

  // the warps' sums in a fixed order, ((w0 + w1) + w2) + w3, in the
  // rings' space
  float* red = reinterpret_cast<float*>(st_smem);
  __syncthreads();
  if (warp > 0)
#pragma unroll
    for (int i = 0; i < S::kVals; ++i)
      red[((warp - 1) * S::kVals + i) * 32 + lane] = acc[i];
  __syncthreads();
  if (warp != 0) return;
#pragma unroll
  for (int w = 0; w < kStWarps - 1; ++w)
#pragma unroll
    for (int i = 0; i < S::kVals; ++i)
      acc[i] += red[(w * S::kVals + i) * 32 + lane];

  float* out = ws + (long long)blockIdx.y * M * N;
  if constexpr (sizeof(T) == 4) {
    const int n = n0 + 2 * lane;     // N even: n < N holds n + 1 too
    if (n >= N) return;
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r < M)
        *reinterpret_cast<float2*>(out + (long long)r * N + n) =
            make_float2(acc[2 * r], acc[2 * r + 1]);
  } else {
    const int g = lane / 4, q2 = (lane % 4) * 2;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = n0 + 8 * nt + q2;  // N a multiple of 8
        if (n >= N) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = 16 * mt + g + 8 * h;
          if (m < M)
            *reinterpret_cast<float2*>(out + (long long)m * N + n) =
                make_float2(acc[(mt * NT + nt) * 4 + 2 * h],
                            acc[(mt * NT + nt) * 4 + 2 * h + 1]);
        }
      }
  }
}

// c[g][i] = the sum of ws[g per + j][i] over j = 0 .. per - 1 in order,
// as `out`, for the `groups` outputs of MN elements each; four elements
// a thread (MN a multiple of 4: N is, on the few-row path)
__global__ void __launch_bounds__(kThreads)
splitk_stream_combine(const float* __restrict__ ws, void* __restrict__ c,
                      long long MN, int groups, int per, int out) {
  const long long quads = MN / 4 * groups;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
       i < quads; i += (long long)gridDim.x * kThreads) {
    const long long e = 4 * i, g = e / MN;
    const float4* w =
        reinterpret_cast<const float4*>(ws + g * per * MN + e % MN);
    float4 v = w[0];
    for (int k = 1; k < per; ++k) {
      const float4 x = w[k * MN / 4];
      v.x += x.x;
      v.y += x.y;
      v.z += x.z;
      v.w += x.w;
    }
    store_as(c, e, out, v.x);
    store_as(c, e + 1, out, v.y);
    store_as(c, e + 2, out, v.z);
    store_as(c, e + 3, out, v.w);
  }
}

// f(the instance whose R, a power of two from the first up to 64, holds
// M, its shared bytes, a null pointer of its element type);
// cudaErrorInvalidValue past 64 rows
template <typename T, int R, class F>
int stream_rows(int M, F f) {
  if (M <= R)
    return f(splitk_stream<T, R>, Stream<T, R>::kSmem,
             static_cast<const T*>(nullptr));
  if constexpr (R < 64) return stream_rows<T, 2 * R>(M, f);
  return (int)cudaErrorInvalidValue;
}

template <class F>
int stream_instance(int M, int in_type, F f) {
  if (M < 1) return (int)cudaErrorInvalidValue;
  if (in_type == kF32) return stream_rows<float, 4>(M, f);
  if (in_type == kBF16) return stream_rows<__nv_bfloat16, 16>(M, f);
  if (in_type == kF16) return stream_rows<__half, 16>(M, f);
  return (int)cudaErrorInvalidValue;
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

// ---------------------------------------------------------------------------
// stream-K on TMA + wgmma: one persistent block a program
// ---------------------------------------------------------------------------

// Block p runs segments prog[p] .. prog[p + 1] through one ring of
// gemm_sm90.cuh's stages (tile TM x TN: the plan's block, TK steps of
// K, bk / TK of them a k-block). Thread 0, the producer, loads every TK
// step of every segment in turn: A's (TK x TM) box K-major, B's TN / 64
// boxes of (64 x TK) MN-major; the ring's running count g gives each
// step its stage and parity, and the ring is never drained between
// segments. The consumers run a segment's wgmmas (mainloop16 from its
// first g, its last stage released too), store its float32 partial
// straight from their fragments (the ring is busy with the next
// segment's loads; a quad writes 32 contiguous bytes of a row) and zero
// the accumulator for the next segment.
template <typename T, int TM, int TN, int TK>
__global__ void __launch_bounds__(sm90::kThreads, 1)
streamk_tma(const __grid_constant__ CUtensorMap ma,
            const __grid_constant__ CUtensorMap mb,
            const int* __restrict__ tile_m, const int* __restrict__ tile_n,
            const int* __restrict__ k_start, const int* __restrict__ k_len,
            const int* __restrict__ prog, float* __restrict__ part,
            int bk) {
  using C = sm90::Cfg<T, TM, TN, TK>;
  extern __shared__ __align__(1024) char smem_raw[];
  char* buf = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(buf + C::kBuf);
  uint64_t* empty = full + C::kStages;
  const int s0 = prog[blockIdx.x], s1 = prog[blockIdx.x + 1];
  const int steps = bk / TK;                 // TK steps a k-block
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 8);       // a consumer warp each
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {                           // producer
    sm90::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int g = 0;
      for (int s = s0; s < s1; ++s) {
        const int m0 = tile_m[s] * TM, n0 = tile_n[s] * TN;
        const int k0 = k_start[s] * bk, nk = k_len[s] * steps;
        for (int kt = 0; kt < nk; ++kt, ++g) {
          const int st = g % C::kStages;
          sm90::mbar_wait(&empty[st], ((g / C::kStages) & 1) ^ 1);
          char* sa = buf + st * C::kStage;
          char* sb = sa + C::kStageA;
          sm90::mbar_expect_tx(&full[st], C::kStage);
          const int k = k0 + kt * TK;
          sm90::tma_load(sa, &ma, &full[st], k, m0);
          for (int j = 0; j < TN / 64; ++j)
            sm90::tma_load(sb + j * TK * 128, &mb, &full[st], n0 + 64 * j,
                           k);
        }
      }
    }
    return;
  }

  sm90::setmaxnreg_inc<232>();             // consumers
  constexpr int MI = TM / 128;
  const int row0 = (wg - 1) * (TM / 2);
  const int w = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  float acc[MI][TN / 2];
  int g = 0;
  for (int s = s0; s < s1; ++s) {
    const int nk = k_len[s] * steps;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int e = 0; e < TN / 2; ++e) acc[mi][e] = 0.f;
    sm90::mainloop16<T, TM, TN, TK, 0, 1, true>(acc, buf, full, empty, nk,
                                                row0, g);
    g += nk;
    float* p = part + (long long)s * TM * TN;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int j = 0; j < TN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + mi * 64 + 16 * w + lane / 4 + 8 * h;
          *reinterpret_cast<float2*>(p + r * TN + 8 * j + 2 * (lane % 4)) =
              make_float2(acc[mi][4 * j + 2 * h], acc[mi][4 * j + 2 * h + 1]);
        }
  }
}

// f(the streamk_tma instance of the tile (bm, bn) of TL_SM90_BLOCKS, TK
// 64 when bk is a multiple of 64, else 32, for in_type kBF16 or kF16; its
// shared bytes; TK); cudaErrorInvalidValue for another tile, bk or type
template <class F>
int streamk_tma_instance(int bm, int bn, int bk, int in_type, F f) {
  if (bk < 32 || bk % 32) return (int)cudaErrorInvalidValue;
  const int tk = bk % 64 == 0 ? 64 : 32;
#define TL_STREAMK_CASE(m, n, k)                                            \
  if (bm == m && bn == n && tk == k) {                                      \
    if (in_type == kBF16)                                                   \
      return f(streamk_tma<__nv_bfloat16, m, n, k>,                         \
               sm90::Cfg<__nv_bfloat16, m, n, k>::kSmem, k);                \
    if (in_type == kF16)                                                    \
      return f(streamk_tma<__half, m, n, k>,                                \
               sm90::Cfg<__half, m, n, k>::kSmem, k);                       \
  }
  TL_SM90_BLOCKS(TL_STREAMK_CASE)
#undef TL_STREAMK_CASE
  return (int)cudaErrorInvalidValue;
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

// The same sums four columns a thread (bn and N multiples of 4): one
// 16-byte load a segment, the tile's index and offset computed once for
// the four
__global__ void __launch_bounds__(kThreads)
streamk_fixup4(const float* __restrict__ part, const int* __restrict__ first,
               void* __restrict__ c, int M, int N, int bm, int bn,
               int out) {
  const int nq = N / 4, n_tn = N / bn;
  const long long quads = (long long)M * nq;
  const long long tile = (long long)bm * bn;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
       i < quads; i += (long long)gridDim.x * kThreads) {
    const int m = (int)(i / nq), n = (int)(i - (long long)m * nq) * 4;
    const int t = (m / bm) * n_tn + n / bn;
    const long long at = (long long)(m % bm) * bn + n % bn;
    float4 v = *reinterpret_cast<const float4*>(part + first[t] * tile + at);
    for (int s = first[t] + 1; s < first[t + 1]; ++s) {
      const float4 x = *reinterpret_cast<const float4*>(part + s * tile + at);
      v.x += x.x;
      v.y += x.y;
      v.z += x.z;
      v.w += x.w;
    }
    const long long e = (long long)m * N + n;
    store_as(c, e, out, v.x);
    store_as(c, e + 1, out, v.y);
    store_as(c, e + 2, out, v.z);
    store_as(c, e + 3, out, v.w);
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

// ---------------------------------------------------------------------------
// block-sparse on TMA + wgmma: one block a live output tile
// ---------------------------------------------------------------------------

// A consumer's TM / 2 staged rows from `row0` (rows of LDC floats at cs)
// into C of element type O, a row at a time, with gemm_tile.cuh's
// rounding store; 0 on the elements whose mask cell is dead (tested
// only when the tile spans several cells, `one_cell` false); rows past
// `rows` and columns past N are not stored
template <int TM, int TN, int LDC, typename O>
__device__ __forceinline__ void store_cells(O* c, const float* cs,
                                            const int* __restrict__ mask,
                                            int rows, int row0, int m0,
                                            int n0, int N, int bm, int bn,
                                            bool one_cell) {
  const int n_cn = N / bn;
  for (int i = threadIdx.x % 128; i < (TM / 2) * TN; i += 128) {
    const int r = row0 + i / TN, n = n0 + i % TN;
    if (r >= rows || n >= N) continue;
    const bool live = one_cell || mask[((m0 + r) / bm) * n_cn + n / bn];
    store(c + (long long)(m0 + r) * N + n, live ? cs[r * LDC + i % TN] : 0.f);
  }
}

// gemm_sm90.cuh's gemm_tma for A (M, K) K-major and B (K, N) MN-major
// (the maps `ma`, `mb`), over the live tiles: a block whose TM x TN tile
// of C overlaps no live cell of `mask` (M / bm, N / bn) stores its zeros
// and returns before the barriers exist; a live one runs the K loop and
// its epilogue stores 0 on the elements of dead cells (any cell size).
template <typename T, int TM, int TN, int TK>
__global__ void __launch_bounds__(sm90::kThreads, 1)
blocksparse_tma(const __grid_constant__ CUtensorMap ma,
                const __grid_constant__ CUtensorMap mb,
                const int* __restrict__ mask, void* __restrict__ c, int M,
                int N, int K, int bm, int bn, int out) {
  using C = sm90::Cfg<T, TM, TN, TK>;
  extern __shared__ __align__(1024) char smem_raw[];
  int mt, nt;
  tile_of(blockIdx.x, (M + TM - 1) / TM, (N + TN - 1) / TN, mt, nt);
  const int m0 = mt * TM, n0 = nt * TN;
  const int rows = min(TM, M - m0), cols = min(TN, N - n0);
  // the mask cells the tile overlaps: rows cr0..cr1, columns cc0..cc1
  const int n_cn = N / bn;
  const int cr0 = m0 / bm, cr1 = (m0 + rows - 1) / bm;
  const int cc0 = n0 / bn, cc1 = (n0 + cols - 1) / bn;
  const int ncc = cc1 - cc0 + 1;
  int any = 0;
  for (int i = threadIdx.x; i < (cr1 - cr0 + 1) * ncc && !any;
       i += sm90::kThreads)
    any = mask[(cr0 + i / ncc) * n_cn + cc0 + i % ncc] != 0;
  if (!__syncthreads_or(any)) {
    for (int i = threadIdx.x; i < rows * cols; i += sm90::kThreads)
      store_as(c, (long long)(m0 + i / cols) * N + n0 + i % cols, out, 0.f);
    return;
  }

  char* buf = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(buf + C::kBuf);
  uint64_t* empty = full + C::kStages;
  const int nk = (K + TK - 1) / TK;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 8);       // a consumer warp each
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {                           // producer
    sm90::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % C::kStages;
        sm90::mbar_wait(&empty[s], ((kt / C::kStages) & 1) ^ 1);
        char* sa = buf + s * C::kStage;
        char* sb = sa + C::kStageA;
        sm90::mbar_expect_tx(&full[s], C::kStage);
        const int k0 = kt * TK;
        sm90::tma_load(sa, &ma, &full[s], k0, m0);
        for (int j = 0; j < TN / 64; ++j)
          sm90::tma_load(sb + j * TK * 128, &mb, &full[s], n0 + 64 * j, k0);
      }
    }
    return;
  }

  sm90::setmaxnreg_inc<232>();             // consumers
  constexpr int MI = TM / 128;
  const int cw = wg - 1;
  const int row0 = cw * (TM / 2);
  float acc[MI][TN / 2];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int e = 0; e < TN / 2; ++e) acc[mi][e] = 0.f;
  sm90::mainloop16<T, TM, TN, TK, 0, 1>(acc, buf, full, empty, nk, row0);

  // epilogue: both consumers past the ring, then each stages its rows
  // as float32 and stores them a row at a time
  sm90::named_sync(1, 256);
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
  sm90::named_sync(2 + cw, 128);
  const bool one = cr0 == cr1 && cc0 == cc1;  // and that cell is live
  constexpr int L = C::kLdC;
  if (out == kF32)
    store_cells<TM, TN, L>(static_cast<float*>(c), cs, mask, rows, row0, m0,
                           n0, N, bm, bn, one);
  else if (out == kBF16)
    store_cells<TM, TN, L>(static_cast<__nv_bfloat16*>(c), cs, mask, rows,
                           row0, m0, n0, N, bm, bn, one);
  else if (out == kF16)
    store_cells<TM, TN, L>(static_cast<__half*>(c), cs, mask, rows, row0,
                           m0, n0, N, bm, bn, one);
  else
    store_cells<TM, TN, L>(static_cast<__nv_fp8_e4m3*>(c), cs, mask, rows,
                           row0, m0, n0, N, bm, bn, one);
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

// blocksparse_tma<T, TM, TN, TK> on `s` over every TM x TN tile of C;
// cudaErrorInvalidValue when a map is refused
template <typename T, int TM, int TN, int TK>
int launch_blocksparse_tma(const void* a, const void* b, const int* mask,
                           void* c, int M, int N, int K, int bm, int bn,
                           int type, int out, cudaStream_t s) {
  using C = sm90::Cfg<T, TM, TN, TK>;
  CUtensorMap ma, mb;
  if (!sm90::make_map(&ma, a, type, M, K, K, TK, TM) ||
      !sm90::make_map(&mb, b, type, K, N, N, 64, TK))
    return (int)cudaErrorInvalidValue;
  const auto kern = blocksparse_tma<T, TM, TN, TK>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (e != cudaSuccess) return (int)e;
  const unsigned tiles = (unsigned)((M + TM - 1) / TM) *
                         (unsigned)((N + TN - 1) / TN);
  kern<<<tiles, sm90::kThreads, C::kSmem, s>>>(ma, mb, mask, c, M, N, K, bm,
                                               bn, out);
  return (int)cudaGetLastError();
}

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

// a (M, K), b (K, N) -> ws (n_split n_sub, M, N) f32, 1 <= M <= 64; K,
// N, split_len and sub_len multiples of 16 bytes of the type, the bases
// on 16 bytes (ops/gemm_variants.py::splitk_path and splitk_stream_plan)
extern "C" int tl_splitk_stream(const void* a, const void* b, float* ws,
                                int M, int N, int K, int n_split,
                                int split_len, int n_sub, int sub_len,
                                int in_type, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int parts = n_split * n_sub;
  if (parts < 1 || parts > 65535) return (int)cudaErrorInvalidValue;
  return stream_instance(M, in_type, [&](auto kern, size_t bytes, auto t) {
    using P = decltype(t);
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    kern<<<dim3((N + kStCols - 1) / kStCols, parts), kStThreads, bytes, s>>>(
        static_cast<P>(a), static_cast<P>(b), ws, M, N, K, split_len, n_sub,
        sub_len);
    return (int)cudaGetLastError();
  });
}

// Blocks of the few-row split-K kernel for M rows of in_type an SM holds
// at once (its plan fills SMs x this many); returns the CUDA error.
extern "C" int tl_splitk_stream_blocks_per_sm(int M, int in_type,
                                              int* blocks) {
  return stream_instance(M, in_type, [&](auto kern, size_t bytes, auto) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern,
                                                        kStThreads, bytes);
    return (int)e;
  });
}

// ws (groups per, MN) f32 -> c (groups, MN) in out_type: each group the
// sum of its `per` partials in order; MN a multiple of 4
extern "C" int tl_splitk_stream_combine(const float* ws, void* c,
                                        long long MN, int groups, int per,
                                        int out_type, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (MN % 4) return (int)cudaErrorInvalidValue;
  splitk_stream_combine<<<elementwise_blocks(MN / 4 * groups), kThreads, 0,
                          s>>>(ws, c, MN, groups, per, out_type);
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

// The TMA path: a (M, K), b (K, N) of in_type kBF16 or kF16, both bases
// on 16 bytes, (bm, bn) a tile of TL_SM90_BLOCKS and bk a multiple of 32
// (ops/gemm_variants.py::streamk_path), the tables as tl_streamk_gemm's
// -> part (n_seg, bm, bn) f32. cudaErrorInvalidValue for another tile,
// bk or type, or when a tensor map is refused.
extern "C" int tl_streamk_tma(const void* a, const void* b,
                              const int* tile_m, const int* tile_n,
                              const int* k_start, const int* k_len,
                              const int* prog, float* part, int n_prog,
                              int M, int N, int K, int bm, int bn, int bk,
                              int in_type, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  return streamk_tma_instance(bm, bn, bk, in_type, [&](auto kern, int smem,
                                                       int tk) {
    CUtensorMap ma, mb;
    if (!sm90::make_map(&ma, a, in_type, M, K, K, tk, bm) ||
        !sm90::make_map(&mb, b, in_type, K, N, N, 64, tk))
      return (int)cudaErrorInvalidValue;
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<n_prog, sm90::kThreads, smem, s>>>(ma, mb, tile_m, tile_n,
                                              k_start, k_len, prog, part,
                                              bk);
    return (int)cudaGetLastError();
  });
}

// part (n_seg, bm, bn) f32, first (M / bm * N / bn + 1) int32 -> c (M, N);
// four columns a thread where bn and N are multiples of 4
extern "C" int tl_streamk_fixup(const float* part, const int* first, void* c,
                                int M, int N, int bm, int bn, int out_type,
                                void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (bn % 4 == 0 && N % 4 == 0)
    streamk_fixup4<<<elementwise_blocks((long long)M * N / 4), kThreads, 0,
                     s>>>(part, first, c, M, N, bm, bn, out_type);
  else
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

// The TMA path (ops/gemm_variants.py::blocksparse_path): a (M, K), b
// (K, N) of in_type kBF16 or kF16, both bases and rows on 16 bytes, mask
// (M / bm, N / bn) int32 -> c (M, N) in out_type, a block a 128 x 128
// tile of C. cudaErrorInvalidValue for another type, or when a tensor
// map is refused.
extern "C" int tl_blocksparse_tma(const void* a, const void* b,
                                  const int* mask, void* c, int M, int N,
                                  int K, int bm, int bn, int in_type,
                                  int out_type, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (in_type == kBF16)
    return launch_blocksparse_tma<__nv_bfloat16, 128, 128, 64>(
        a, b, mask, c, M, N, K, bm, bn, in_type, out_type, s);
  if (in_type == kF16)
    return launch_blocksparse_tma<__half, 128, 128, 64>(
        a, b, mask, c, M, N, K, bm, bn, in_type, out_type, s);
  return (int)cudaErrorInvalidValue;
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
