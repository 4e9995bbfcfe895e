// MInference vertical-slash sparse attention forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel of tilelang_mesh_tpu/ops/minference.py:
//   vs_sparse_kernel (:31) -> tl_vs_sparse
// Same contract:
//   Q (B, H, Sq, D), K, V (B, H, Sk, D) float32, bfloat16 or float16
//   (`dt`: attention_common.cuh's codes), contiguous; Vmask (B, H, Sk)
//   int32, nonzero = a vertical column; Dmask (B, H, Sq) int32, nonzero
//   = a slash diagonal i - j; BlockMask (B, H, Sq / bM, Sk / bN) int32,
//   nonzero = live, in the caller's blocks (Sq % bM == Sk % bN == 0).
//   Query i sees key j when its cell is live, j <= i (top-left causal)
//   and Vmask[j] or Dmask[i - j]. Scores in the exp2 domain, S =
//   float(Q K^T) * scale, scale = sm_scale * log2(e); online softmax per
//   key tile (ops/_online_softmax.py:39), P rounded to the input type;
//   O (B, H, Sq, D) in the input type, l > 0 ? acc / l : 0, so a row
//   that sees nothing is exactly 0 (:80-83).
// The TPU kernel held the slash offsets and compared each pair of a
// live tile with all Ns of them (Ns compares a pair: 6096 at MInference's
// LLaMA-3 patterns). The wrapper instead scatters the slashes into
// Dmask once, so a pair costs one lookup: the same function, as a slash
// below 0 or at Sq or past it matches no causal pair.
//
// Bound: operations. Each visible (i, j) pair costs 4 * D flops (S and
// P @ V); at S 16384 with a thousand columns and thousands of slashes a
// row sees thousands of keys, far above the bytes' time. A kernel that
// works tile by tile computes every pair of its live tiles: at those
// patterns the whole causal triangle.
//
// Design, float32 (vs_sparse, CUDA cores): blocksparse_attention.cu's
// loop on attention_tile.cuh's attend_tile. A block of 128 threads takes
// 64 query rows of one head; key tiles of 32 wholly above the diagonal
// are not visited, and a tile that overlaps no live cell is skipped by
// the block vote (any_live, also the barrier before the tile's loads). A
// visited tile stages its 32 keys' Vmask entries and the 95 Dmask
// entries its pairs can reach (i - j from q0 - k0 - 31 to q0 - k0 + 63)
// in shared memory beside K and V, so the visibility test reads shared
// memory only.
//
// Design, bfloat16 and float16 (vs_sparse_mma, tensor cores):
// blocksparse_attention.cu's blocksparse_mha_mma (four warps of TM / 4
// rows a block, Q held as A fragments, attention_mma.cuh's
// attend_tile_mma, a cp.async ring of two stages over the live tiles
// that LiveTiles finds, the heaviest query tiles first), each stage also
// holding the tile's TN Vmask entries and the TM + TN - 1 Dmask entries
// its pairs can reach (cp_async4). Visibility is tested in registers: a
// warp turns the staged entries into bit words by ballots, TN column
// bits and (TN + 16 WM - 1) diagonal bits in reverse order, so row r's
// diagonals are the words shifted right by 16 WM - 1 - r (a funnel
// shift); a lane then ORs the column bits in, keeps keys j <= i and j <
// Sk, and (only where the tile spans more than one cell) the row's live
// cells, shifts by its column q2, and each accumulator element's test is
// a shift and an AND. A warp skips a tile wholly above its rows'
// diagonal or where none of its rows sees a key, and masks nothing on a
// tile where every row sees every key. The whole causal triangle's live
// tiles are computed: the visible pairs (41 % of the causal ones at
// MInference's LLaMA-3 patterns) are spread over every tile. The tile
// (TM, TN) is the host's choice (ops/minference.py::vs_tile) among
// attention_mma.cuh's mask_tiles.

#include "attention_mma.cuh"
#include "attention_tile.cuh"
#include "varlen_common.cuh"

namespace {

using namespace tl_varlen;

constexpr int BM = 64;           // query rows per block
constexpr int BN = 32;           // keys per tile
constexpr int ND = BM + BN - 1;  // diagonals a tile's pairs reach

template <int D>
constexpr size_t smem_bytes() {
  return tile_smem_bytes<BM, BN, D>() + sizeof(int) * (BN + ND);
}

template <int D, int DT>
__global__ void __launch_bounds__(kThreads)
vs_sparse(const typename Elem<DT>::T* __restrict__ q,
          const typename Elem<DT>::T* __restrict__ k,
          const typename Elem<DT>::T* __restrict__ v,
          const int* __restrict__ vmask, const int* __restrict__ dmask,
          const int* __restrict__ mask, typename Elem<DT>::T* __restrict__ o,
          int H, int Sq, int Sk, int bM, int bN, float scale) {
  constexpr int RM = BM / kTy;  // query rows per thread
  constexpr int CD = D / kTx;   // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                // [BM][D + 1]
  float* Ks = Qs + BM * (D + 1);   // [BN][D + 1]
  float* Vs = Ks + BN * (D + 1);   // [BN][D + 1]
  float* Ps = Vs + BN * (D + 1);   // [BM][BN + 1]
  int* vms = reinterpret_cast<int*>(Ps + BM * (BN + 1));   // [BN]
  int* dms = vms + BN;                                     // [ND]

  const int ty = threadIdx.x / kTx, tx = threadIdx.x % kTx;
  const int q0 = blockIdx.x * BM;
  const long long bh = (long long)blockIdx.z * H + blockIdx.y;
  const int nR = Sq / bM, nC = Sk / bN;
  const int* live = mask + bh * nR * nC;
  const int* vm = vmask + bh * Sk;
  const int* dm = dmask + bh * Sq;
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

  const int n_kv = min((Sk + BN - 1) / BN, (q0 + BM - 1) / BN + 1);
  for (int kb = 0; kb < n_kv; ++kb) {
    const int k0 = kb * BN;
    const Cells c = cells_of(k0, min(k0 + BN, Sk), bN);
    // the vote is the barrier before the previous tile's data is
    // overwritten
    if (!any_live(live, nC, r, c)) continue;
    const bool one_cell = r.a0 == r.a1 && c.a0 == c.a1;  // and it is live
    load_tile<BN, D, DT>(Ks, kg, k0, Sk);
    load_tile<BN, D, DT>(Vs, vg, k0, Sk);
    // diagonal d0 + t of the tile at dms[t]; none below 0 or at Sq
    const int d0 = q0 - k0 - (BN - 1);
    for (int t = threadIdx.x; t < BN + ND; t += kThreads) {
      if (t < BN) {
        vms[t] = k0 + t < Sk ? vm[k0 + t] : 0;
      } else {
        const int d = d0 + t - BN;
        dms[t - BN] = d >= 0 && d < Sq ? dm[d] : 0;
      }
    }
    __syncthreads();
    attend_tile<BM, BN, D, DT>(
        Qs, Ks, Vs, Ps, scale,
        [&](int a, int cc) {
          const int ri = ty + kTy * a, cj = tx + kTx * cc;
          const int i = q0 + ri, j = k0 + cj;
          if (j >= Sk || j > i) return false;
          if (!vms[cj] && !dms[ri - cj + BN - 1]) return false;
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

// a stage's Vmask and Dmask entries, padded to 16 bytes
template <int TM, int TN>
constexpr int kMaskInts = (TN + TM + TN - 1 + 3) / 4 * 4;

template <int D, int TM, int TN>
constexpr size_t mma_smem_bytes() {  // Q, two stages of K, V and masks
  return 2 * (size_t)(TM + 4 * TN) * (D + kPad) +
         2 * sizeof(int) * kMaskInts<TM, TN>;
}

template <int D, typename E, int TM, int TN>
__global__ void __launch_bounds__(kThreads, 1)
vs_sparse_mma(const E* __restrict__ q, const E* __restrict__ k,
              const E* __restrict__ v, const int* __restrict__ vmask,
              const int* __restrict__ dmask, const int* __restrict__ mask,
              E* __restrict__ o, int H, int Sq, int Sk, int bM, int bN,
              float scale) {
  constexpr int WM = TM / 64;  // m16 row tiles a warp: 4 warps a block
  // Q as held A fragments, else read from shared memory each k16 step
  constexpr bool QREG = WM == 1 || D <= 64;
  constexpr int LD = D + kPad, NW = TN / 32;
  constexpr int RW = 16 * WM;                 // rows a warp
  constexpr int NR = (TN + RW - 1 + 31) / 32;  // a warp's diagonal words
  constexpr int MI = kMaskInts<TM, TN>;
  static_assert(D % 16 == 0 && (LD / 8) % 2 == 1, "unsupported head_dim");
  static_assert((TM == 64 || TM == 128) && (TN == 32 || TN == 64),
                "unsupported tile");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* sQ = reinterpret_cast<E*>(smem_raw);  // [TM][LD]
  E* sK = sQ + TM * LD;                    // [2][TN][LD]
  E* sV = sK + 2 * TN * LD;                // [2][TN][LD]
  // [2][MI]: a stage's Vmask entries [TN], then its Dmask entries
  // [TM + TN - 1], diagonal d0 + e at e, d0 = q0 - k0 - (TN - 1)
  int* sM = reinterpret_cast<int*>(sV + 2 * TN * LD);

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, q2 = (lane % 4) * 2;
  // the last query tiles see the most keys: they go first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TM;
  const int qw = q0 + RW * warp;  // the warp's first row
  const int qe = qw + RW - 1;     // and its last
  const long long bh = (long long)blockIdx.z * H + blockIdx.y;
  const int nC = Sk / bN;
  const int* live = mask + bh * (Sq / bM) * nC;
  const int* vm = vmask + bh * Sk;
  const int* dm = dmask + bh * Sq;
  const E* kg = k + bh * Sk * D;
  const E* vg = v + bh * Sk * D;
  const int n_kv = min((Sk + TN - 1) / TN, (q0 + TM - 1) / TN + 1);
  const Cells r = cells_of(q0, min(q0 + TM, Sq), bM);
  LiveTiles<TN> tiles{live, nC, bN, Sk, n_kv, r};

  // tile kb's K, V and mask entries into stage st
  auto issue = [&](int kb, int st) {
    const int k0 = kb * TN, d0 = q0 - k0 - (TN - 1);
    issue_rows<TN, D>(sK + st * TN * LD, kg, k0, Sk);
    issue_rows<TN, D>(sV + st * TN * LD, vg, k0, Sk);
    int* ms = sM + st * MI;
    for (int t = threadIdx.x; t < TN + TM + TN - 1; t += kThreads) {
      const int at = t < TN ? k0 + t : d0 + t - TN;
      const bool ok = t < TN ? at < Sk : at >= 0 && at < Sq;
      cp_async4(ms + t, ok ? (t < TN ? vm : dm) + at : vm, ok);
    }
  };

  int kb = tiles.next(0);
  issue_rows<TM, D>(sQ, q + bh * Sq * D, q0, Sq);
  if (kb < n_kv) issue(kb, 0);
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
    if (nxt < n_kv) issue(nxt, (it + 1) & 1);
    tl_gemm::cp_async_commit();
    const int k0 = kb * TN, cur = it & 1;
    // rows past Sq, or a tile wholly above the warp's diagonal: nothing
    // to add
    if (qw >= Sq || k0 > qe) {
      kb = nxt;
      continue;
    }
    const int* tm = sM + cur * MI;
    // the staged entries as bits: column t in cols, and diagonal
    // (qe - k0) - e' in bit e' of diag (reverse order), so row r's
    // diagonals i - k0 - t are diag >> (RW - 1 - r)
    unsigned cols[NW], diag[NR];
#pragma unroll
    for (int t = 0; t < NW; ++t)
      cols[t] = __ballot_sync(kFull, tm[32 * t + lane] != 0);
    const int e_top = RW * warp + RW - 1 + TN - 1;  // diagonal qe - k0
#pragma unroll
    for (int t = 0; t < NR; ++t) {
      const int e = e_top - 32 * t - lane;
      diag[t] = __ballot_sync(kFull, e >= 0 && tm[TN + e] != 0);
    }
    const Cells c = cells_of(k0, min(k0 + TN, Sk), bN);
    const bool one_cell = r.a0 == r.a1 && c.a0 == c.a1;  // and live
    // each row's visible keys as bits, shifted by the lane's column q2:
    // key 8 nt + q2 + c is bit 8 (nt % 4) + c of word nt / 4
    unsigned bits[WM][2][NW];
    bool any = false, all = true;
#pragma unroll
    for (int wm = 0; wm < WM; ++wm)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = 16 * wm + g + 8 * h, i = qw + rr;
        unsigned (&w)[NW] = bits[wm][h];
#pragma unroll
        for (int t = 0; t < NW; ++t)
          w[t] = __funnelshift_r(diag[t], diag[t + 1], RW - 1 - rr) | cols[t];
        if (!one_cell) {
          // rows past Sq, never stored, take the last row's cells
          unsigned cw[NW] = {};
          cell_bits(cw, live + (long long)(min(i, Sq - 1) / bM) * nC, c.a0,
                    c.a1, bN, k0);
#pragma unroll
          for (int t = 0; t < NW; ++t) w[t] &= cw[t];
        }
        keep_bits(w, min(i, Sk - 1) - k0 + 1);  // j <= i, j < Sk
#pragma unroll
        for (int t = 0; t < NW; ++t) {
          any |= w[t] != 0;
          all &= w[t] == ~0u;
          w[t] >>= q2;
        }
      }
    // no row of the warp sees a key of the tile: nothing to add
    if (__any_sync(kFull, any))
      attend_tile_mma<D, TN, WM, E>(
          q_frag, sK + cur * TN * LD, sV + cur * TN * LD, scale,
          !__all_sync(kFull, all),
          [&](int wm, int h, int nt, int cc) {
            return (bits[wm][h][nt / 4] >> (8 * (nt % 4) + cc)) & 1u;
          },
          m, l, acc);
    kb = nxt;
  }
  tl_gemm::cp_async_wait<0>();

  if (qw >= Sq) return;
  store_rows_div<D, WM>(o + bh * Sq * D, acc, l, qw, Sq);
}

struct Args {
  const void *q, *k, *v;
  const int *vmask, *dmask, *mask;
  void* o;
  int B, H, Sq, Sk, bM, bN;
  float scale;
  cudaStream_t st;
};

template <int D, int DT>
int run(const Args& a) {
  using T = typename Elem<DT>::T;
  const dim3 grid((a.Sq + BM - 1) / BM, a.H, a.B);
  return launch(vs_sparse<D, DT>, grid, smem_bytes<D>(), a.st,
                static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                static_cast<const T*>(a.v), a.vmask, a.dmask, a.mask,
                static_cast<T*>(a.o), a.H, a.Sq, a.Sk, a.bM, a.bN, a.scale);
}

template <int D, typename E, int TM, int TN>
int run_mma(const Args& a) {
  const dim3 grid((a.Sq + TM - 1) / TM, a.H, a.B);
  return launch(vs_sparse_mma<D, E, TM, TN>, grid,
                mma_smem_bytes<D, TM, TN>(), a.st,
                static_cast<const E*>(a.q), static_cast<const E*>(a.k),
                static_cast<const E*>(a.v), a.vmask, a.dmask, a.mask,
                static_cast<E*>(a.o), a.H, a.Sq, a.Sk, a.bM, a.bN, a.scale);
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
extern "C" int tl_vs_sparse_tiled(const void* q, const void* k,
                                  const void* v, const void* vmask,
                                  const void* dmask, const void* mask,
                                  void* o, int B, int H, int Sq, int Sk,
                                  int D, int bM, int bN, int dt, float scale,
                                  int block_M, int block_N, void* stream) {
  if (bM < 1 || bN < 1 || Sq % bM || Sk % bN)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, static_cast<const int*>(vmask),
               static_cast<const int*>(dmask), static_cast<const int*>(mask),
               o, B, H, Sq, Sk, bM, bN, scale,
               static_cast<cudaStream_t>(stream)};
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

// tl_vs_sparse_tiled at the head_dim's default tile. The port calls the
// tiled entry; this one keeps the signature of the builds before the tile
// argument, so scripts/sparse_attn_ab.py calls an earlier build and this
// one alike.
extern "C" int tl_vs_sparse(const void* q, const void* k, const void* v,
                            const void* vmask, const void* dmask,
                            const void* mask, void* o, int B, int H, int Sq,
                            int Sk, int D, int bM, int bN, int dt,
                            float scale, void* stream) {
  return tl_vs_sparse_tiled(q, k, v, vmask, dmask, mask, o, B, H, Sq, Sk, D,
                            bM, bN, dt, scale, 0, 0, stream);
}
