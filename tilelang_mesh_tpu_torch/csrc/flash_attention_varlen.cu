// Packed ragged-batch (varlen) attention forward, MHA and GQA, for
// Hopper (sm_90a).
//
// Replaces the TPU kernels of tilelang_mesh_tpu/ops/flash_attention_varlen.py
// made by the factory varlen_fwd_kernel (:106):
//   varlen_fwd (:147)                -> tl_varlen_fwd_tiled(partial = 0)
//   varlen_fwd_partial (:123, return_partials)
//                                    -> tl_varlen_fwd_tiled(partial = 1)
// Same contract:
//   Q (Hq, Tq, D), K, V (Hkv, Tk, D) float32, bfloat16 or float16,
//   contiguous;
//   query head h reads KV head h / (Hq / Hkv); SeqQ, PosQ (Tq,) and
//   SeqK, PosK (Tk,) int32; BlockLive (Tq / bM, Tk / bN) int32.
//   Q is prescaled once: Qs = dtype(float(Q) * scale), scale = sm_scale *
//   log2(e), so every score is in the exp2 domain. Query i sees key j
//   when SeqQ[i] == SeqK[j] and, causal, PosQ[i] >= PosK[j] (local
//   positions: lens_q != lens_k works, and bottom-right alignment is a
//   shift of PosQ made by the caller). Online softmax per key tile
//   (_varlen_softmax_loop :50, ops/_online_softmax.py):
//     m_new = max(m, rowmax(S), -1e30); p = exp2(S - m_new)
//     l = l * exp2(m - m_new) + rowsum(p); acc = acc * exp2(m - m_new)
//     + dtype(p) @ V
//   partial = 0: O (Hq, Tq, D) in the input type, l > 0 ? acc / l : 0;
//   partial = 1: O float32 unnormalised acc, M and L (Hq, Tq) float32.
//   A row that sees no key (a pad row, or every key masked) has l = 0,
//   acc = 0 and M = -1e30 (the floor, whatever tiles were visited; the
//   TPU kernel leaves -inf where its q-block met no live block).
//
// Bound: operations. A document of L tokens does 4 * D flops per visible
// (i, j) pair (S and P @ V) against 2 * L * D elements read per head, far
// above the card's balance point at L in the thousands, so the least time
// is the visible pairs' flops over the type's rate (67 TFLOP/s for
// float32 outside the tensor cores, the float32 contract ruling out
// TF32; 989 for bf16 and f16 on them).
//
// Design, float32 (varlen_fwd, CUDA cores): csrc/flash_attention.cu's
// loop — one block of 128 threads per (64-query tile, query head), the
// prescaled Q tile in shared memory, 32-key tiles of K and V loaded into
// shared memory, and attention_tile.cuh's tile step (a 4 x 4 block of
// scores per thread with CUDA-core FMAs, (m, l) updated with 8-lane
// shuffles, P rounded to the input type and P @ V accumulated in
// registers). What differs is the mask and which key tiles are visited:
// the block first finds the span of key blocks with a live cell in its
// query rows' BlockLive rows (one scan of those rows); for each 32-key
// tile of that span it votes on whether the tile overlaps a live cell
// and holds a visible pair (each thread reads one key's ids; the vote is
// also the barrier before the tile's loads), and only then loads K, V
// and the keys' ids; each score is masked with the elementwise document
// test.
//
// Design, bfloat16 and float16 (varlen_fwd_mma, tensor cores):
// blocksparse_attention.cu's blocksparse_mha_mma with the document test
// in place of the cell bit. mma.sync m16n8k16 with float32 sums, four
// warps a block per (TM-query tile, query head), each warp TM / 4 rows,
// Q prescaled in shared memory and held as A fragments; the tile step is
// attention_mma.cuh's attend_tile_mma (scale 1: Q carries it). K and V
// tiles of TN keys arrive by cp.async in a ring of two stages over the
// *live* tiles only (varlen_common.cuh's LiveTiles: a warp ballot over
// 32 tiles' BlockLive cells, no barrier and no list), and each tile's TN
// key ids (SeqK, PosK) ride in the same stage. A warp classes each tile
// from the staged ids against its own rows' range (the lane's rows'
// ids are in registers): full (its rows and the tile's keys hold one
// sequence id and, causal, min PosQ >= max PosK: nothing masked), empty
// (no key has an id in the rows' range and, causal, a position at or
// before the rows' largest: the products are skipped) or masked, where
// each row's visible keys among the lane's 2 TN / 8 columns become a
// word of bits and the elementwise test is a shift and an AND. The classes are exact
// for ids in any order; on sorted packs of whole documents most live
// tiles are full and only the diagonal's and the document edges' are
// masked. One block owns its output rows: no atomics, the same bits
// every call. The tile (TM, TN) is the host's choice
// (ops/flash_attention_varlen.py::varlen_tile) among attention_mma.cuh's
// mask_tiles; `partial` is a runtime flag.

#include "attention_mma.cuh"
#include "attention_tile.cuh"
#include "varlen_common.cuh"

namespace {

using namespace tl_varlen;

constexpr int BM = 64;  // query rows per block
constexpr int BN = 32;  // keys per tile

template <int D>
constexpr size_t fwd_smem_bytes() {
  return tile_smem_bytes<BM, BN, D>() + sizeof(int) * (2 * BM + 2 * BN + 2);
}

template <int D, int DT, bool PARTIAL>
__global__ void __launch_bounds__(kThreads)
varlen_fwd(const typename Elem<DT>::T* __restrict__ q,
           const typename Elem<DT>::T* __restrict__ k,
           const typename Elem<DT>::T* __restrict__ v,
           const int* __restrict__ seq_q, const int* __restrict__ seq_k,
           const int* __restrict__ pos_q, const int* __restrict__ pos_k,
           const int* __restrict__ live, void* __restrict__ o,
           float* __restrict__ m_out, float* __restrict__ l_out, int group,
           int Tq, int Tk, int bM, int bN, int causal, float scale) {
  constexpr int RM = BM / kTy;  // query rows per thread
  constexpr int CD = D / kTx;   // output columns per thread
  constexpr int LD = D + 1, LP = BN + 1;
  extern __shared__ float smem[];
  float* Qs = smem;          // [BM][LD]
  float* Ks = Qs + BM * LD;  // [BN][LD]
  float* Vs = Ks + BN * LD;  // [BN][LD]
  float* Ps = Vs + BN * LD;  // [BM][LP]
  int* sq = reinterpret_cast<int*>(Ps + BM * LP);  // [BM]
  int* pq = sq + BM;                               // [BM]
  int* sk = pq + BM;                               // [BN]
  int* pk = sk + BN;                               // [BN]
  int* red = pk + BN;                              // [2]

  const int ty = threadIdx.x / kTx, tx = threadIdx.x % kTx;
  const int q0 = blockIdx.x * BM, h = blockIdx.y;
  const long long hkv = h / group;
  const auto* kg = k + hkv * Tk * D;
  const auto* vg = v + hkv * Tk * D;

  load_tile<BM, D, DT, true>(Qs, q + (long long)h * Tq * D, q0, Tq, scale);
  load_ids<BM>(sq, seq_q, q0, Tq, -1);
  load_ids<BM>(pq, pos_q, q0, Tq, 0);

  float m[RM], l[RM], acc[RM][CD];
#pragma unroll
  for (int a = 0; a < RM; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.f;
#pragma unroll
    for (int e = 0; e < CD; ++e) acc[a][e] = 0.f;
  }

  const int nC = Tk / bN, n_kv = (Tk + BN - 1) / BN;
  const Cells rows = cells_of(q0, min(q0 + BM, Tq), bM);
  const Cells span = tiles_of(
      live_span<true>(live, nC, rows, Cells{0, nC - 1}, red), bN, BN, n_kv);
  for (int kb = span.a0; kb <= span.a1; ++kb) {
    const int k0 = kb * BN;
    // the vote is also the barrier: the previous tile's readers are done
    if (!computes_tile<BM, BN, true>(live, nC, rows,
                                     cells_of(k0, min(k0 + BN, Tk), bN), sq,
                                     pq, seq_k, pos_k, k0, Tk, -2, causal))
      continue;
    load_tile<BN, D, DT>(Ks, kg, k0, Tk);
    load_tile<BN, D, DT>(Vs, vg, k0, Tk);
    load_ids<BN>(sk, seq_k, k0, Tk, -2);
    load_ids<BN>(pk, pos_k, k0, Tk, 0);
    __syncthreads();

    // Q is prescaled, so the tile step's scale is 1
    attend_tile<BM, BN, D, DT>(
        Qs, Ks, Vs, Ps, 1.f,
        [&](int a, int c) {
          const int ir = ty + kTy * a, jc = tx + kTx * c;
          return visible(sq[ir], pq[ir], sk[jc], pk[jc], causal);
        },
        m, l, acc);
  }

#pragma unroll
  for (int a = 0; a < RM; ++a) {
    const int i = q0 + ty + kTy * a;
    if (i >= Tq) continue;
    const long long row = (long long)h * Tq + i;
    if constexpr (PARTIAL) {
      float* of = static_cast<float*>(o);
#pragma unroll
      for (int e = 0; e < CD; ++e) of[row * D + tx + kTx * e] = acc[a][e];
      if (tx == 0) {
        m_out[row] = fmaxf(m[a], -1e30f);
        l_out[row] = l[a];
      }
    } else {
      // a row that sees no key gives 0 (the TPU kernel's select)
      const bool seen = l[a] > 0.f;
      auto* ot = static_cast<typename Elem<DT>::T*>(o);
#pragma unroll
      for (int e = 0; e < CD; ++e)
        Elem<DT>::store(ot, row * D + tx + kTx * e,
                        seen ? acc[a][e] / l[a] : 0.f);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 and float16: tensor cores
// ---------------------------------------------------------------------------

template <int D, int TM, int TN>
constexpr size_t mma_smem_bytes() {
  // Q, two stages of K and V, two stages of the keys' (seq, pos) ids
  return 2 * (size_t)(TM + 4 * TN) * (D + kPad) + 2 * 2 * TN * sizeof(int);
}

template <int D, typename E, int TM, int TN>
__global__ void __launch_bounds__(kThreads, 1)
varlen_fwd_mma(const E* __restrict__ q, const E* __restrict__ k,
               const E* __restrict__ v, const int* __restrict__ seq_q,
               const int* __restrict__ seq_k, const int* __restrict__ pos_q,
               const int* __restrict__ pos_k, const int* __restrict__ live,
               void* __restrict__ o, float* __restrict__ m_out,
               float* __restrict__ l_out, int group, int Tq, int Tk, int bM,
               int bN, int causal, int partial, float scale) {
  constexpr int WM = TM / 64;  // m16 row tiles a warp: 4 warps a block
  // Q as held A fragments, else read from shared memory each k16 step
  constexpr bool QREG = WM == 1 || D <= 64;
  constexpr int LD = D + kPad, KW = TN / 32;
  static_assert(D % 16 == 0 && (LD / 8) % 2 == 1, "unsupported head_dim");
  static_assert((TM == 64 || TM == 128) && (TN == 32 || TN == 64),
                "unsupported tile");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* sQ = reinterpret_cast<E*>(smem_raw);  // [TM][LD]
  E* sK = sQ + TM * LD;                    // [2][TN][LD]
  E* sV = sK + 2 * TN * LD;                // [2][TN][LD]
  int* sS = reinterpret_cast<int*>(sV + 2 * TN * LD);  // [2][TN] SeqK
  int* sP = sS + 2 * TN;                               // [2][TN] PosK

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, q2 = (lane % 4) * 2;
  const int q0 = blockIdx.x * TM, h = blockIdx.y;
  const int qw = q0 + 16 * WM * warp;  // the warp's first row
  const E* kg = k + (long long)(h / group) * Tk * D;
  const E* vg = v + (long long)(h / group) * Tk * D;
  const int n_kv = (Tk + TN - 1) / TN, nC = Tk / bN;
  LiveTiles<TN> tiles{live, nC, bN, Tk, n_kv,
                      cells_of(q0, min(q0 + TM, Tq), bM)};

  // tile kb's K, V rows and its keys' ids into stage st (zero past Tk:
  // the ids there are never read, key_ok masks them)
  auto issue = [&](int kb, int st) {
    const int k0 = kb * TN;
    issue_rows<TN, D>(sK + st * TN * LD, kg, k0, Tk);
    issue_rows<TN, D>(sV + st * TN * LD, vg, k0, Tk);
    for (int i = threadIdx.x; i < 2 * TN; i += kThreads) {
      const int j = k0 + i % TN;
      const bool ok = j < Tk;
      const int* src = i < TN ? seq_k : pos_k;
      cp_async4((i < TN ? sS : sP) + st * TN + i % TN, ok ? src + j : src,
                ok);
    }
  };

  int kb = tiles.next(0);
  issue_rows<TM, D>(sQ, q + (long long)h * Tq * D, q0, Tq);
  if (kb < n_kv) issue(kb, 0);
  tl_gemm::cp_async_commit();
  tl_gemm::cp_async_wait<0>();
  __syncthreads();
  // Qs = dtype(float(Q) * scale), in place
  for (int idx = threadIdx.x; idx < TM * D / 2; idx += kThreads) {
    unsigned* x = reinterpret_cast<unsigned*>(sQ + (idx / (D / 2)) * LD) +
                  idx % (D / 2);
    *x = scale2<E>(*x, scale);
  }
  __syncthreads();

  const QFrags<D, WM, QREG, E> q_frag(sQ, warp);

  // the lane's rows qw + 16 wm + g + 8 h: their ids (-1 past Tq, which
  // matches no key past Tk), running max, partial sum; and the range of
  // the warp's rows below Tq
  int rs[WM][2], rp[WM][2];
  int s_lo = INT_MAX, s_hi = INT_MIN, p_lo = INT_MAX, p_hi = INT_MIN;
  float m[WM][2], l[WM][2], acc[WM][D / 8][4];
#pragma unroll
  for (int wm = 0; wm < WM; ++wm) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = qw + 16 * wm + g + 8 * hh;
      rs[wm][hh] = i < Tq ? seq_q[i] : -1;
      rp[wm][hh] = i < Tq ? pos_q[i] : 0;
      if (i < Tq) {
        s_lo = min(s_lo, rs[wm][hh]);
        s_hi = max(s_hi, rs[wm][hh]);
        p_lo = min(p_lo, rp[wm][hh]);
        p_hi = max(p_hi, rp[wm][hh]);
      }
    }
    m[wm][0] = m[wm][1] = -1e30f;
    l[wm][0] = l[wm][1] = 0.f;
    zero(acc[wm]);
  }
  s_lo = __reduce_min_sync(kFull, s_lo);
  s_hi = __reduce_max_sync(kFull, s_hi);
  p_lo = __reduce_min_sync(kFull, p_lo);
  p_hi = __reduce_max_sync(kFull, p_hi);

  for (int it = 0; kb < n_kv; ++it) {
    if (it > 0) {
      tl_gemm::cp_async_wait<0>();
      __syncthreads();  // tile kb landed; the last tile's readers are done
    }
    const int nxt = tiles.next(kb + 1);
    if (nxt < n_kv) issue(nxt, (it + 1) & 1);
    tl_gemm::cp_async_commit();
    const int cur = it & 1, k0 = kb * TN;
    const int* ts = sS + cur * TN;
    const int* tp = sP + cur * TN;
    if (qw < Tq) {
      // the tile's class against the warp's rows, from each lane's KW keys
      bool all = true, any = false;
#pragma unroll
      for (int w = 0; w < KW; ++w) {
        const int t = lane + 32 * w, sk = ts[t], pk = tp[t];
        const bool key_ok = k0 + t < Tk;
        all &= key_ok && sk == s_lo && (!causal || pk <= p_lo);
        any |= key_ok && sk >= s_lo && sk <= s_hi && (!causal || pk <= p_hi);
      }
      const bool full = s_lo == s_hi && __all_sync(kFull, all);
      if (__any_sync(kFull, any)) {
        // each row's visible keys among the lane's columns 8 nt + q2 + c:
        // bit 2 nt + c
        unsigned bits[WM][2];
        if (!full) {
#pragma unroll
          for (int wm = 0; wm < WM; ++wm)
            bits[wm][0] = bits[wm][1] = 0u;
#pragma unroll
          for (int nt = 0; nt < TN / 8; ++nt) {
            const int t = 8 * nt + q2;
            const int2 sk = *reinterpret_cast<const int2*>(ts + t);
            const int2 pk = *reinterpret_cast<const int2*>(tp + t);
            const bool ok0 = k0 + t < Tk, ok1 = k0 + t + 1 < Tk;
#pragma unroll
            for (int wm = 0; wm < WM; ++wm)
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                const int sq = rs[wm][hh], pq = rp[wm][hh];
                const bool v0 = ok0 && sq == sk.x && (!causal || pq >= pk.x);
                const bool v1 = ok1 && sq == sk.y && (!causal || pq >= pk.y);
                bits[wm][hh] |= (unsigned)v0 << (2 * nt) |
                                (unsigned)v1 << (2 * nt + 1);
              }
          }
        }
        attend_tile_mma<D, TN, WM, E>(
            q_frag, sK + cur * TN * LD, sV + cur * TN * LD, 1.f, !full,
            [&](int wm, int hh, int nt, int c) {
              return (bits[wm][hh] >> (2 * nt + c)) & 1u;
            },
            m, l, acc);
      }
    }
    kb = nxt;
  }
  tl_gemm::cp_async_wait<0>();

  if (qw >= Tq) return;
  const long long base = (long long)h * Tq;
  if (!partial) {
    store_rows_div<D, WM>(static_cast<E*>(o) + base * D, acc, l, qw, Tq);
    return;
  }
#pragma unroll
  for (int wm = 0; wm < WM; ++wm) {
    const int r0 = qw + 16 * wm;
    store_rows<D>(static_cast<float*>(o) + base * D, acc[wm], r0, Tq);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float lt = quad_sum(l[wm][hh]);
      const int i = r0 + g + 8 * hh;
      if (q2 == 0 && i < Tq) {
        m_out[base + i] = m[wm][hh];  // >= -1e30: the floor is m's start
        l_out[base + i] = lt;
      }
    }
  }
}

struct Args {
  const void *q, *k, *v;
  const int *seq_q, *seq_k, *pos_q, *pos_k, *live;
  void* o;
  float *m, *l;
  int Hq, group, Tq, Tk, bM, bN, causal, partial;
  float scale;
  cudaStream_t st;
};

template <int D, int DT, bool PARTIAL>
int run(const Args& a) {
  using T = typename Elem<DT>::T;
  const dim3 grid((a.Tq + BM - 1) / BM, a.Hq);
  return launch(varlen_fwd<D, DT, PARTIAL>, grid, fwd_smem_bytes<D>(),
                a.st, static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                static_cast<const T*>(a.v), a.seq_q, a.seq_k, a.pos_q, a.pos_k,
                a.live, a.o, a.m, a.l, a.group, a.Tq, a.Tk, a.bM, a.bN,
                a.causal, a.scale);
}

template <int D, typename E, int TM, int TN>
int run_mma(const Args& a) {
  const dim3 grid((a.Tq + TM - 1) / TM, a.Hq);
  return launch(varlen_fwd_mma<D, E, TM, TN>, grid,
                mma_smem_bytes<D, TM, TN>(), a.st,
                static_cast<const E*>(a.q), static_cast<const E*>(a.k),
                static_cast<const E*>(a.v), a.seq_q, a.seq_k, a.pos_q,
                a.pos_k, a.live, a.o, a.m, a.l, a.group, a.Tq, a.Tk, a.bM,
                a.bN, a.causal, a.partial, a.scale);
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
      return a.partial ? run<D, kF32, true>(a) : run<D, kF32, false>(a);
    case kBF16:
      return mask_tiles<D>(tm, tn, MmaRun<D, __nv_bfloat16>{a});
    case kF16:
      return mask_tiles<D>(tm, tn, MmaRun<D, __half>{a});
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches on `stream` with the tile (tile_M, tile_N) of the 16-bit
// kernel, (0, 0) for the head_dim's default (float32 has one tile, 64 x
// 32); returns the first CUDA error (0 = launched), or
// cudaErrorInvalidValue for a head_dim, type or tile without an
// instance, Hkv that does not divide Hq, or a table that does not tile
// Tq x Tk. `m` and `l` are used only when `partial` is set. The Python
// wrapper checks shapes, types, alignment and contiguity before calling.
extern "C" int tl_varlen_fwd_tiled(const void* q, const void* k,
                                   const void* v, const void* seq_q,
                                   const void* seq_k, const void* pos_q,
                                   const void* pos_k, const void* live,
                                   void* o, void* m, void* l, int Hq,
                                   int Hkv, int Tq, int Tk, int D,
                                   int block_M, int block_N, int dt,
                                   int causal, int partial, int tile_M,
                                   int tile_N, float scale, void* stream) {
  if (Hkv < 1 || Hq % Hkv || block_M < 1 || block_N < 1 || Tq % block_M ||
      Tk % block_N)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,
               k,
               v,
               static_cast<const int*>(seq_q),
               static_cast<const int*>(seq_k),
               static_cast<const int*>(pos_q),
               static_cast<const int*>(pos_k),
               static_cast<const int*>(live),
               o,
               static_cast<float*>(m),
               static_cast<float*>(l),
               Hq,
               Hq / Hkv,
               Tq,
               Tk,
               block_M,
               block_N,
               causal,
               partial,
               scale,
               static_cast<cudaStream_t>(stream)};
  switch (D) {
    case 16:
      return dispatch<16>(dt, tile_M, tile_N, a);
    case 32:
      return dispatch<32>(dt, tile_M, tile_N, a);
    case 64:
      return dispatch<64>(dt, tile_M, tile_N, a);
    case 128:
      return dispatch<128>(dt, tile_M, tile_N, a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
