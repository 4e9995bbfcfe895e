// Block-sparse multi-head attention forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel of tilelang_mesh_tpu/ops/blocksparse_attention.py:
//   blocksparse_mha_kernel (:21) -> tl_blocksparse_mha
// Same contract:
//   Q (B, H, Sq, D), K, V (B, H, Sk, D) float32, bfloat16 or float16,
//   contiguous;
//   BlockMask (B, H, Sq / bM, Sk / bN) int32, nonzero = live, in the
//   caller's blocks of bM queries by bN keys (Sq % bM == Sk % bN == 0).
//   Scores in the exp2 domain: S = float(Q K^T) * scale, scale = sm_scale
//   * log2(e). Query i sees key j when the cell (i / bM, j / bN) is live
//   and, causal, j <= i (top-left). Online softmax per key tile
//   (ops/_online_softmax.py:39):
//     m_new = max(m, rowmax(S), -1e30); p = exp2(S - m_new)
//     l = l * exp2(m - m_new) + rowsum(p); acc = acc * exp2(m - m_new)
//     + dtype(p) @ V
//   O (B, H, Sq, D) in the input type, l > 0 ? acc / l : 0, so a row
//   whose every cell is dead is exactly 0 (:62-66).
//
// Bound: operations. Each visible (i, j) pair costs 4 * D flops (S and
// P @ V); at S 4096 and a mask of density 0.5 the pairs' flops over the
// type's rate (67 TFLOP/s for float32 outside the tensor cores, 989 for
// bf16 and f16 on them) are far above the bytes' time. A kernel that
// works tile by tile computes every pair of its live tiles.
//
// Design, float32 (blocksparse_mha, CUDA cores): csrc/flash_attention.cu's
// loop (left as it is; its tile step is attention_tile.cuh's attend_tile
// here). The mask's cells are the caller's blocks, not the kernel's 64 x
// 32 tiles, so liveness goes as in csrc/varlen_common.cuh: a key tile is
// a candidate when any cell its rows x keys overlap is live (the block
// votes, each thread reading a share of those cells; the vote is also
// the barrier before the tile's loads); a tile that is no candidate is
// skipped and adds exactly nothing; inside a candidate each pair's own
// cell decides its mask (read only when the tile spans more than one
// cell). Causal tiles wholly above the diagonal are not visited.
//
// Design, bfloat16 and float16 (blocksparse_mha_mma, tensor cores):
// mma.sync m16n8k16 with float32 sums, four warps a block per (TM-query
// tile, head, batch), each warp TM / 4 rows, Q held as A fragments; the
// tile step is attention_mma.cuh's attend_tile_mma (S scaled in
// registers, the online softmax in the accumulator layout, P rounded
// into A fragments). K and V tiles of TN keys arrive by cp.async in a
// ring of two stages over the *live* tiles only: the next live tile is
// found by varlen_common.cuh's LiveTiles (a warp ballot over 32 tiles'
// cells at a time, every warp alike), so a run of dead cells costs no
// stage and the next live tile is in flight while this one is computed.
// When a tile lies inside one cell (every tile, at cells a multiple of
// the tile) nothing in it is masked but the causal diagonal and keys
// past Sk; a tile that spans several cells builds each row's mask as a
// word of bits from its cells (one read a cell a row), and the
// elementwise test is a shift and an AND in registers. A warp skips a
// tile wholly above its rows' diagonal; when causal the heaviest query
// tiles go first. One block owns its output rows: no atomics, the same
// bits every call. The tile (TM, TN) is the host's choice
// (ops/blocksparse_attention.py::blocksparse_tile, by head_dim, cells and
// the causal flag) among attention_mma.cuh's mask_tiles.

#include "attention_mma.cuh"
#include "attention_tile.cuh"
#include "varlen_common.cuh"

namespace {

using namespace tl_varlen;

constexpr int BM = 64;  // query rows per block
constexpr int BN = 32;  // keys per tile

template <int D, int DT>
__global__ void __launch_bounds__(kThreads)
blocksparse_mha(const typename Elem<DT>::T* __restrict__ q,
                const typename Elem<DT>::T* __restrict__ k,
                const typename Elem<DT>::T* __restrict__ v,
                const int* __restrict__ mask,
                typename Elem<DT>::T* __restrict__ o, int H, int Sq,
                int Sk, int bM, int bN, int causal, float scale) {
  constexpr int RM = BM / kTy;  // query rows per thread
  constexpr int CD = D / kTx;   // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                // [BM][D + 1]
  float* Ks = Qs + BM * (D + 1);   // [BN][D + 1]
  float* Vs = Ks + BN * (D + 1);   // [BN][D + 1]
  float* Ps = Vs + BN * (D + 1);   // [BM][BN + 1]

  const int ty = threadIdx.x / kTx, tx = threadIdx.x % kTx;
  const int q0 = blockIdx.x * BM;
  const long long bh = (long long)blockIdx.z * H + blockIdx.y;
  const int nR = Sq / bM, nC = Sk / bN;
  const int* live = mask + bh * nR * nC;
  const auto* kg = k + bh * Sk * D;
  const auto* vg = v + bh * Sk * D;

  load_tile<BM, D, DT>(Qs, q + bh * Sq * D, q0, Sq);

  // the block's row cells, and each of this thread's rows' (rows past
  // Sq, never stored, take the last row's)
  const Cells r = cells_of(q0, min(q0 + BM, Sq), bM);
  int rc[RM];
#pragma unroll
  for (int a = 0; a < RM; ++a) rc[a] = min(q0 + ty + kTy * a, Sq - 1) / bM;

  float m[RM], l[RM], acc[RM][CD];
#pragma unroll
  for (int a = 0; a < RM; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.f;
#pragma unroll
    for (int e = 0; e < CD; ++e) acc[a][e] = 0.f;
  }

  int n_kv = (Sk + BN - 1) / BN;
  if (causal) n_kv = min(n_kv, (q0 + BM - 1) / BN + 1);
  for (int kb = 0; kb < n_kv; ++kb) {
    const int k0 = kb * BN;
    const Cells c = cells_of(k0, min(k0 + BN, Sk), bN);
    // the vote is the barrier before the previous tile's data is
    // overwritten
    if (!any_live(live, nC, r, c)) continue;
    const bool one_cell = r.a0 == r.a1 && c.a0 == c.a1;  // and it is live
    load_tile<BN, D, DT>(Ks, kg, k0, Sk);
    load_tile<BN, D, DT>(Vs, vg, k0, Sk);
    __syncthreads();
    attend_tile<BM, BN, D, DT>(
        Qs, Ks, Vs, Ps, scale,
        [&](int a, int cc) {
          const int i = q0 + ty + kTy * a, j = k0 + tx + kTx * cc;
          if (j >= Sk || (causal && j > i)) return false;
          return one_cell || live[(long long)rc[a] * nC + j / bN] != 0;
        },
        m, l, acc);
  }

#pragma unroll
  for (int a = 0; a < RM; ++a) {
    const int i = q0 + ty + kTy * a;
    if (i >= Sq) continue;
    const long long row = bh * Sq + i;
#pragma unroll
    for (int e = 0; e < CD; ++e)
      Elem<DT>::store(o, row * D + tx + kTx * e,
                      l[a] > 0.f ? acc[a][e] / l[a] : 0.f);
  }
}

// ---------------------------------------------------------------------------
// bfloat16 and float16: tensor cores
// ---------------------------------------------------------------------------

template <int D, int TM, int TN>
constexpr size_t mma_smem_bytes() {
  return 2 * (size_t)(TM + 4 * TN) * (D + kPad);  // Q, two stages of K, V
}

template <int D, typename E, int TM, int TN>
__global__ void __launch_bounds__(kThreads, 1)
blocksparse_mha_mma(const E* __restrict__ q, const E* __restrict__ k,
                    const E* __restrict__ v, const int* __restrict__ mask,
                    E* __restrict__ o, int H, int Sq, int Sk, int bM, int bN,
                    int causal, float scale) {
  constexpr int WM = TM / 64;  // m16 row tiles a warp: 4 warps a block
  // Q as held A fragments, else read from shared memory each k16 step
  constexpr bool QREG = WM == 1 || D <= 64;
  constexpr int LD = D + kPad, NW = TN / 32;
  static_assert(D % 16 == 0 && (LD / 8) % 2 == 1, "unsupported head_dim");
  static_assert((TM == 64 || TM == 128) && (TN == 32 || TN == 64),
                "unsupported tile");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* sQ = reinterpret_cast<E*>(smem_raw);  // [TM][LD]
  E* sK = sQ + TM * LD;                    // [2][TN][LD]
  E* sV = sK + 2 * TN * LD;                // [2][TN][LD]

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, q2 = (lane % 4) * 2;
  // the last query tiles see the most keys when causal: they go first
  const int q0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * TM;
  const int qw = q0 + 16 * WM * warp;  // the warp's first row
  const int qe = qw + 16 * WM - 1;     // and its last
  const long long bh = (long long)blockIdx.z * H + blockIdx.y;
  const int nC = Sk / bN;
  const int* live = mask + bh * (Sq / bM) * nC;
  const E* kg = k + bh * Sk * D;
  const E* vg = v + bh * Sk * D;
  int n_kv = (Sk + TN - 1) / TN;
  if (causal) n_kv = min(n_kv, (q0 + TM - 1) / TN + 1);
  const Cells r = cells_of(q0, min(q0 + TM, Sq), bM);
  LiveTiles<TN> tiles{live, nC, bN, Sk, n_kv, r};

  int kb = tiles.next(0);
  issue_rows<TM, D>(sQ, q + bh * Sq * D, q0, Sq);
  if (kb < n_kv) {
    issue_rows<TN, D>(sK, kg, kb * TN, Sk);
    issue_rows<TN, D>(sV, vg, kb * TN, Sk);
  }
  tl_gemm::cp_async_commit();
  tl_gemm::cp_async_wait<0>();
  __syncthreads();

  const QFrags<D, WM, QREG, E> q_frag(sQ, warp);

  // the lane's rows qw + 16 wm + g and + 8: running max, its partial sum
  float m[WM][2], l[WM][2], acc[WM][D / 8][4];
#pragma unroll
  for (int wm = 0; wm < WM; ++wm) {
    m[wm][0] = m[wm][1] = -1e30f;
    l[wm][0] = l[wm][1] = 0.f;
    zero(acc[wm]);
  }
  for (int it = 0; kb < n_kv; ++it) {
    if (it > 0) {
      tl_gemm::cp_async_wait<0>();
      __syncthreads();  // tile kb landed; the last tile's readers are done
    }
    const int nxt = tiles.next(kb + 1);
    if (nxt < n_kv) {
      const int st = (it + 1) & 1;
      issue_rows<TN, D>(sK + st * TN * LD, kg, nxt * TN, Sk);
      issue_rows<TN, D>(sV + st * TN * LD, vg, nxt * TN, Sk);
    }
    tl_gemm::cp_async_commit();
    const int k0 = kb * TN, k1 = k0 + TN - 1;
    // rows past Sq, or a tile wholly above the warp's diagonal: nothing
    // to add
    if (qw < Sq && !(causal && k0 > qe)) {
      const Cells c = cells_of(k0, min(k0 + TN, Sk), bN);
      const bool one_cell = r.a0 == r.a1 && c.a0 == c.a1;  // and live
      const bool masked = (causal && k1 > qw) || k1 >= Sk || !one_cell;
      // each row's visible keys as bits, shifted by the lane's column
      // q2: key 8 nt + q2 + c is bit 8 (nt % 4) + c of word nt / 4
      unsigned bits[WM][2][NW];
      if (masked) {
#pragma unroll
        for (int wm = 0; wm < WM; ++wm)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = qw + 16 * wm + g + 8 * h;
            unsigned (&w)[NW] = bits[wm][h];
#pragma unroll
            for (int t = 0; t < NW; ++t) w[t] = one_cell ? ~0u : 0u;
            // rows past Sq, never stored, take the last row's cells
            if (!one_cell)
              cell_bits(w, live + (long long)(min(i, Sq - 1) / bM) * nC,
                        c.a0, c.a1, bN, k0);
            keep_bits(w, (causal ? min(i, Sk - 1) : Sk - 1) - k0 + 1);
#pragma unroll
            for (int t = 0; t < NW; ++t) w[t] >>= q2;
          }
      }
      const int cur = it & 1;
      attend_tile_mma<D, TN, WM, E>(
          q_frag, sK + cur * TN * LD, sV + cur * TN * LD, scale, masked,
          [&](int wm, int h, int nt, int cc) {
            return (bits[wm][h][nt / 4] >> (8 * (nt % 4) + cc)) & 1u;
          },
          m, l, acc);
    }
    kb = nxt;
  }
  tl_gemm::cp_async_wait<0>();

  if (qw >= Sq) return;
  store_rows_div<D, WM>(o + bh * Sq * D, acc, l, qw, Sq);
}

struct Args {
  const void *q, *k, *v;
  const int* mask;
  void* o;
  int B, H, Sq, Sk, bM, bN, causal;
  float scale;
  cudaStream_t st;
};

template <int D, int DT>
int run(const Args& a) {
  using T = typename Elem<DT>::T;
  const dim3 grid((a.Sq + BM - 1) / BM, a.H, a.B);
  return launch(blocksparse_mha<D, DT>, grid, tile_smem_bytes<BM, BN, D>(),
                a.st, static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                static_cast<const T*>(a.v), a.mask, static_cast<T*>(a.o),
                a.H, a.Sq, a.Sk, a.bM, a.bN, a.causal, a.scale);
}

template <int D, typename E, int TM, int TN>
int run_mma(const Args& a) {
  const dim3 grid((a.Sq + TM - 1) / TM, a.H, a.B);
  return launch(blocksparse_mha_mma<D, E, TM, TN>, grid,
                mma_smem_bytes<D, TM, TN>(), a.st,
                static_cast<const E*>(a.q), static_cast<const E*>(a.k),
                static_cast<const E*>(a.v), a.mask, static_cast<E*>(a.o),
                a.H, a.Sq, a.Sk, a.bM, a.bN, a.causal, a.scale);
}

// run_tile's launcher of the tensor-core instance (TM, TN)
template <int D, typename E>
struct MmaRun {
  const Args& a;
  template <int TM, int TN>
  int go() const { return run_mma<D, E, TM, TN>(a); }
};

template <int D>
int dispatch(int dt, int tm, int tn, const Args& a) {
  switch (dt) {
    case kF32:  // one tile, (BM, BN)
      if (!(tm == 0 && tn == 0) && !(tm == BM && tn == BN))
        return static_cast<int>(cudaErrorInvalidValue);
      return run<D, kF32>(a);
    case kBF16:
      return mask_tiles<D>(tm, tn, MmaRun<D, __nv_bfloat16>{a});
    case kF16:
      return mask_tiles<D>(tm, tn, MmaRun<D, __half>{a});
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches on `stream` with the tile (block_M, block_N) of the 16-bit
// kernel, (0, 0) for the head_dim's default (float32 has one tile, 64 x
// 32); returns the first CUDA error (0 = launched), or
// cudaErrorInvalidValue for a head_dim, type or tile without an instance
// or blocks that do not divide Sq, Sk. `scale` is sm_scale * log2(e).
// The Python wrapper checks shapes, types and contiguity before calling.
extern "C" int tl_blocksparse_mha_tiled(const void* q, const void* k,
                                        const void* v, const void* mask,
                                        void* o, int B, int H, int Sq,
                                        int Sk, int D, int bM, int bN,
                                        int dt, int causal, float scale,
                                        int block_M, int block_N,
                                        void* stream) {
  if (bM < 1 || bN < 1 || Sq % bM || Sk % bN)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, static_cast<const int*>(mask), o, B, H, Sq, Sk, bM,
               bN, causal, scale, static_cast<cudaStream_t>(stream)};
  switch (D) {
    case 16:
      return dispatch<16>(dt, block_M, block_N, a);
    case 32:
      return dispatch<32>(dt, block_M, block_N, a);
    case 64:
      return dispatch<64>(dt, block_M, block_N, a);
    case 128:
      return dispatch<128>(dt, block_M, block_N, a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// tl_blocksparse_mha_tiled at the head_dim's default tile. The port calls
// the tiled entry; this one keeps the signature of the builds before the
// tile argument, so scripts/sparse_attn_ab.py calls an earlier build and
// this one alike.
extern "C" int tl_blocksparse_mha(const void* q, const void* k,
                                  const void* v, const void* mask, void* o,
                                  int B, int H, int Sq, int Sk, int D,
                                  int bM, int bN, int dt, int causal,
                                  float scale, void* stream) {
  return tl_blocksparse_mha_tiled(q, k, v, mask, o, B, H, Sq, Sk, D, bM, bN,
                                  dt, causal, scale, 0, 0, stream);
}
