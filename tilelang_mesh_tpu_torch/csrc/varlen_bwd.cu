// Packed ragged-batch (varlen) attention backward, MHA and GQA, for
// Hopper (sm_90a).
//
// Replaces the TPU kernels of tilelang_mesh_tpu/ops/flash_attention_varlen.py:
//   varlen_bwd_dkdv_kernel (:192) -> tl_varlen_bwd_dkdv
//   varlen_bwd_dq_kernel (:274)   -> tl_varlen_bwd_dq
// Same contract:
//   Q, dO (Hq, Tq, D); K, V (Hkv, Tk, D), float32, bfloat16 or float16;
//   L = lse2 = m + log2(l) and Delta = sum(dO * O, -1), (Hq, Tq) f32;
//   SeqQ, PosQ (Tq,), SeqK, PosK (Tk,), BlockLive (Tq / bM, Tk / bN)
//   int32; query head h reads KV head h / (Hq / Hkv);
//   P = exp2(Q K^T * scale2 - L), scale2 = sm_scale * log2(e), where
//   query i sees key j (SeqQ[i] == SeqK[j] and, causal, PosQ[i] >=
//   PosK[j]: _varlen_p_recompute :172), else 0. The 0 is a select, as
//   the TPU kernel's if_then_else: L is -inf on a row that saw no key
//   (a pad row, a fully masked bottom-right row), where exp2 gives +inf,
//   and a multiply by a 0/1 mask would give inf * 0 = NaN;
//   dS = P * (dO V^T - Delta) * sm_scale;
//   dV = sum over the group of dtype(P)^T dO, dK = dtype(dS)^T Q,
//   dQ = dtype(dS) K; dK, dV (Hkv, Tk, D) and dQ (Hq, Tq, D) f32.
// P and dS are rounded to the input type before their products, as the
// TPU kernels hold them in dtype fragments.
//
// Bound: operations. Per visible (i, j) pair dK/dV do 8 * D flops
// (S, dP, dV, dK) and dQ 6 * D (S, dP, dQ), far above the balance point
// at documents of thousands of tokens, so the least time is the visible
// pairs' flops over the type's rate (float32 outside the tensor cores,
// bfloat16 and float16 on them).
//
// Design: csrc/gqa_bwd.cu's two kernels and its no-atomics split, so
// every output element is written once by one block and the result is
// deterministic; what differs is the document mask and the visited
// tiles, read from BlockLive as in the forward.
//
// float32 (`varlen_bwd_dkdv`, `varlen_bwd_dq`; CUDA-core FMAs):
// * dkdv: one block per (32-key tile, KV head) keeps its K and V tile in
//   shared memory and its dK, dV rows in registers. It finds the span of
//   query blocks with a live cell in its keys' BlockLive columns (the
//   table read transposed, the TPU kernel's BlockLive[qb, bx] :248),
//   then loops over the group's query heads and, for each, the 32-row Q
//   tiles of that span that overlap a live cell and hold a visible pair
//   (one block-wide vote, as in the forward) — the TPU's pipelined
//   (head-in-group, q-block) axis. Each step loads Q, dO, L, Delta and
//   the tile's ids, computes the transposed scores S^T and dP^T (4 x 2
//   per thread), forms P and dS, writes them to shared tiles read only
//   by the owning warp, and accumulates dV += P^T dO and dK += dS^T Q.
// * dq: one block per (64-query tile, query head) keeps Q, dO, L, Delta
//   in shared memory and dQ in registers, and loops over the 32-key tiles
//   of its rows' span that pass both votes, accumulating dQ += dS K.
//
// bfloat16 and float16 (`varlen_bwd_dkdv_mma`, `varlen_bwd_dq_mma`;
// tensor cores): gqa_bwd.cu's gqa_bwd_dkdv_mma / gqa_bwd_dq_mma over the
// live tiles. Operands sit in shared memory in the input type, rows
// padded by kPad; products are mma.sync m16n8k16 with float32 sums, and
// P and dS are rounded to the input type in registers (to_frags) as the
// A fragments of the next product. The live tiles come from
// varlen_common.cuh's LiveTiles (a warp ballot over 32 tiles' BlockLive
// cells: no barrier and no list), so the next step's cp.async is issued
// before this one is computed. A warp classes each tile against its own
// 16 ids from the tile's ids staged in shared memory, as the forward's
// varlen_fwd_mma does: full (one sequence id on both sides and, causal,
// every query at or after every key: no test), empty (the warp adds
// nothing) or masked (each own id's visible ids among the lane's columns
// a word of bits, the select a shift and an AND). Only the ids decide:
// positions are local to a document and ids may come in any order.
// * dkdv: one block per (64-key tile, KV head), four warps of 16 keys.
//   K and V arrive once; steps run over the live query tiles of kStep
//   rows (the table read transposed: LiveTiles<BM, true>) outer and the
//   group's heads inner, so a tile's ids and class serve `group` steps.
//   Q, dO, L, Delta (and, at a tile's first head, its ids) arrive by
//   cp.async into two stages. Each warp takes S^T = K Q^T and dP^T =
//   V dO^T on its 16 keys, forms P^T and dS^T on the fragments, and
//   accumulates dV += P^T dO and dK += dS^T Q (dO, Q by ldmatrix.trans).
// * dq: one block per (64-query tile, query head), four warps of 16 rows.
//   Q and dO are held as A fragments and each lane's L, Delta and row ids
//   in registers; the live key tiles of kStep keys and their ids arrive
//   by cp.async, double-buffered. Each warp takes S = Q K^T and dP =
//   dO V^T, forms dS, and accumulates dQ += dS K (K by ldmatrix.trans).
// kStep is 32 at D 128, where a thread already holds 128 floats of
// accumulators, 64 below.

#include "attention_mma.cuh"
#include "varlen_common.cuh"

namespace {

using namespace tl_varlen;

constexpr int KV_ROWS = 32;  // dkdv: keys per block
constexpr int KV_QT = 32;    // dkdv: query rows per step
constexpr int DQ_ROWS = 64;  // dq: query rows per block
constexpr int DQ_KT = 32;    // dq: keys per step

template <int D>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(float) * (2 * KV_ROWS * (D + 1) + 2 * KV_QT * (D + 1) +
                          2 * KV_ROWS * (KV_QT + 1) + 2 * KV_QT) +
         sizeof(int) * (2 * KV_ROWS + 2 * KV_QT + 2);
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (2 * DQ_ROWS * (D + 1) + 2 * DQ_KT * (D + 1) +
                          DQ_ROWS * (DQ_KT + 1) + 2 * DQ_ROWS) +
         sizeof(int) * (2 * DQ_ROWS + 2 * DQ_KT + 2);
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *L, *Delta;
  const int *seq_q, *seq_k, *pos_q, *pos_k, *live;
  int Hq, Hkv, Tq, Tk, bM, bN, causal;
  float scale2, sm_scale;
};

template <int D, int DT>
__global__ void __launch_bounds__(kThreads)
varlen_bwd_dkdv(const Args a, float* __restrict__ dk, float* __restrict__ dv) {
  using T = typename Elem<DT>::T;
  constexpr int RN = KV_ROWS / kTy;  // keys per thread
  constexpr int CQ = KV_QT / kTx;    // queries per thread per step
  constexpr int CD = D / kTx;        // output columns per thread
  constexpr int LD = D + 1, LQ = KV_QT + 1;
  extern __shared__ float smem[];
  float* Ks = smem;                // [KV_ROWS][LD]
  float* Vs = Ks + KV_ROWS * LD;   // [KV_ROWS][LD]
  float* Qs = Vs + KV_ROWS * LD;   // [KV_QT][LD]
  float* dOs = Qs + KV_QT * LD;    // [KV_QT][LD]
  float* Pt = dOs + KV_QT * LD;    // [KV_ROWS][LQ], P^T
  float* dSt = Pt + KV_ROWS * LQ;  // [KV_ROWS][LQ], dS^T
  float* Ls = dSt + KV_ROWS * LQ;  // [KV_QT]
  float* Ds = Ls + KV_QT;          // [KV_QT]
  int* sk = reinterpret_cast<int*>(Ds + KV_QT);  // [KV_ROWS]
  int* pk = sk + KV_ROWS;                        // [KV_ROWS]
  int* sq = pk + KV_ROWS;                        // [KV_QT]
  int* pq = sq + KV_QT;                          // [KV_QT]
  int* red = pq + KV_QT;                         // [2]

  const T* q = static_cast<const T*>(a.q);
  const T* dout = static_cast<const T*>(a.dout);
  const int ty = threadIdx.x / kTx, tx = threadIdx.x % kTx;
  const int k0 = blockIdx.x * KV_ROWS, hk = blockIdx.y;
  const int group = a.Hq / a.Hkv, Tq = a.Tq, Tk = a.Tk;
  const long long kv_off = (long long)hk * Tk * D;

  load_tile<KV_ROWS, D, DT>(Ks, static_cast<const T*>(a.k) + kv_off, k0,
                              Tk);
  load_tile<KV_ROWS, D, DT>(Vs, static_cast<const T*>(a.v) + kv_off, k0,
                              Tk);
  load_ids<KV_ROWS>(sk, a.seq_k, k0, Tk, -2);
  load_ids<KV_ROWS>(pk, a.pos_k, k0, Tk, 0);

  float dk_acc[RN][CD], dv_acc[RN][CD];
#pragma unroll
  for (int r = 0; r < RN; ++r)
#pragma unroll
    for (int e = 0; e < CD; ++e) dk_acc[r][e] = dv_acc[r][e] = 0.f;

  const int nR = Tq / a.bM, nC = Tk / a.bN, n_q = (Tq + KV_QT - 1) / KV_QT;
  const Cells cols = cells_of(k0, min(k0 + KV_ROWS, Tk), a.bN);
  const Cells span = tiles_of(
      live_span<false>(a.live, nC, Cells{0, nR - 1}, cols, red), a.bM, KV_QT,
      n_q);
  for (int g = 0; g < group; ++g) {
    const long long hq = (long long)hk * group + g;
    for (int qb = span.a0; qb <= span.a1; ++qb) {
      const int q0 = qb * KV_QT;
      // the vote is also the barrier: the previous step's readers are done
      if (!computes_tile<KV_ROWS, KV_QT, false>(
              a.live, nC, cells_of(q0, min(q0 + KV_QT, Tq), a.bM), cols, sk,
              pk, a.seq_q, a.pos_q, q0, Tq, -1, a.causal))
        continue;
      load_tile<KV_QT, D, DT>(Qs, q + hq * Tq * D, q0, Tq);
      load_tile<KV_QT, D, DT>(dOs, dout + hq * Tq * D, q0, Tq);
      load_vec<KV_QT>(Ls, a.L + hq * Tq, q0, Tq);
      load_vec<KV_QT>(Ds, a.Delta + hq * Tq, q0, Tq);
      load_ids<KV_QT>(sq, a.seq_q, q0, Tq, -1);
      load_ids<KV_QT>(pq, a.pos_q, q0, Tq, 0);
      __syncthreads();

      // S^T (j, i) = K_j . Q_i and dP^T (j, i) = V_j . dO_i
      float st[RN][CQ], dpt[RN][CQ];
#pragma unroll
      for (int r = 0; r < RN; ++r)
#pragma unroll
        for (int c = 0; c < CQ; ++c) st[r][c] = dpt[r][c] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        float ka[RN], va[RN], qc[CQ], oc[CQ];
#pragma unroll
        for (int r = 0; r < RN; ++r) {
          ka[r] = Ks[(ty + kTy * r) * LD + d];
          va[r] = Vs[(ty + kTy * r) * LD + d];
        }
#pragma unroll
        for (int c = 0; c < CQ; ++c) {
          qc[c] = Qs[(tx + kTx * c) * LD + d];
          oc[c] = dOs[(tx + kTx * c) * LD + d];
        }
#pragma unroll
        for (int r = 0; r < RN; ++r)
#pragma unroll
          for (int c = 0; c < CQ; ++c) {
            st[r][c] = fmaf(ka[r], qc[c], st[r][c]);
            dpt[r][c] = fmaf(va[r], oc[c], dpt[r][c]);
          }
      }
#pragma unroll
      for (int r = 0; r < RN; ++r) {
        const int jr = ty + kTy * r;
#pragma unroll
        for (int c = 0; c < CQ; ++c) {
          const int ic = tx + kTx * c;
          const float p = visible(sq[ic], pq[ic], sk[jr], pk[jr], a.causal)
                              ? exp2f(st[r][c] * a.scale2 - Ls[ic])
                              : 0.f;
          const float ds = p * (dpt[r][c] - Ds[ic]) * a.sm_scale;
          Pt[jr * LQ + ic] = Elem<DT>::round(p);
          dSt[jr * LQ + ic] = Elem<DT>::round(ds);
        }
      }
      __syncwarp();  // a key's P^T, dS^T row is written and read by its 8 lanes

#pragma unroll 4
      for (int i = 0; i < KV_QT; ++i) {
        float pa[RN], sa[RN], oc[CD], qc[CD];
#pragma unroll
        for (int r = 0; r < RN; ++r) {
          pa[r] = Pt[(ty + kTy * r) * LQ + i];
          sa[r] = dSt[(ty + kTy * r) * LQ + i];
        }
#pragma unroll
        for (int e = 0; e < CD; ++e) {
          oc[e] = dOs[i * LD + tx + kTx * e];
          qc[e] = Qs[i * LD + tx + kTx * e];
        }
#pragma unroll
        for (int r = 0; r < RN; ++r)
#pragma unroll
          for (int e = 0; e < CD; ++e) {
            dv_acc[r][e] = fmaf(pa[r], oc[e], dv_acc[r][e]);
            dk_acc[r][e] = fmaf(sa[r], qc[e], dk_acc[r][e]);
          }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RN; ++r) {
    const int j = k0 + ty + kTy * r;
    if (j >= Tk) continue;
    const long long row = kv_off + (long long)j * D;
#pragma unroll
    for (int e = 0; e < CD; ++e) {
      dk[row + tx + kTx * e] = dk_acc[r][e];
      dv[row + tx + kTx * e] = dv_acc[r][e];
    }
  }
}

// At least one block an SM is all the bound promises (shared memory
// holds two at D = 128 anyway): without it ptxas fits this kernel in 128
// registers and loses the dS loop's overlap of loads and FMAs.
template <int D, int DT>
__global__ void __launch_bounds__(kThreads, 1)
varlen_bwd_dq(const Args a, float* __restrict__ dq) {
  using T = typename Elem<DT>::T;
  constexpr int RM = DQ_ROWS / kTy;  // query rows per thread
  constexpr int CN = DQ_KT / kTx;    // keys per thread per step
  constexpr int CD = D / kTx;        // output columns per thread
  constexpr int LD = D + 1, LP = DQ_KT + 1;
  extern __shared__ float smem[];
  float* Qs = smem;                // [DQ_ROWS][LD]
  float* dOs = Qs + DQ_ROWS * LD;  // [DQ_ROWS][LD]
  float* Ks = dOs + DQ_ROWS * LD;  // [DQ_KT][LD]
  float* Vs = Ks + DQ_KT * LD;     // [DQ_KT][LD]
  float* dSs = Vs + DQ_KT * LD;    // [DQ_ROWS][LP]
  float* Ls = dSs + DQ_ROWS * LP;  // [DQ_ROWS]
  float* Ds = Ls + DQ_ROWS;        // [DQ_ROWS]
  int* sq = reinterpret_cast<int*>(Ds + DQ_ROWS);  // [DQ_ROWS]
  int* pq = sq + DQ_ROWS;                          // [DQ_ROWS]
  int* sk = pq + DQ_ROWS;                          // [DQ_KT]
  int* pk = sk + DQ_KT;                            // [DQ_KT]
  int* red = pk + DQ_KT;                           // [2]

  const int ty = threadIdx.x / kTx, tx = threadIdx.x % kTx;
  const int q0 = blockIdx.x * DQ_ROWS, h = blockIdx.y;
  const int Tq = a.Tq, Tk = a.Tk;
  const long long hq = h;
  const long long kv_off = (long long)(h / (a.Hq / a.Hkv)) * Tk * D;
  const T* kg = static_cast<const T*>(a.k) + kv_off;
  const T* vg = static_cast<const T*>(a.v) + kv_off;

  load_tile<DQ_ROWS, D, DT>(Qs, static_cast<const T*>(a.q) + hq * Tq * D,
                              q0, Tq);
  load_tile<DQ_ROWS, D, DT>(
      dOs, static_cast<const T*>(a.dout) + hq * Tq * D, q0, Tq);
  load_vec<DQ_ROWS>(Ls, a.L + hq * Tq, q0, Tq);
  load_vec<DQ_ROWS>(Ds, a.Delta + hq * Tq, q0, Tq);
  load_ids<DQ_ROWS>(sq, a.seq_q, q0, Tq, -1);
  load_ids<DQ_ROWS>(pq, a.pos_q, q0, Tq, 0);

  float dq_acc[RM][CD];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int e = 0; e < CD; ++e) dq_acc[r][e] = 0.f;

  const int nC = Tk / a.bN, n_kv = (Tk + DQ_KT - 1) / DQ_KT;
  const Cells rows = cells_of(q0, min(q0 + DQ_ROWS, Tq), a.bM);
  const Cells span = tiles_of(
      live_span<true>(a.live, nC, rows, Cells{0, nC - 1}, red), a.bN, DQ_KT,
      n_kv);
  for (int kb = span.a0; kb <= span.a1; ++kb) {
    const int k0 = kb * DQ_KT;
    // the vote is also the barrier: the previous step's readers are done
    if (!computes_tile<DQ_ROWS, DQ_KT, true>(
            a.live, nC, rows, cells_of(k0, min(k0 + DQ_KT, Tk), a.bN), sq, pq,
            a.seq_k, a.pos_k, k0, Tk, -2, a.causal))
      continue;
    load_tile<DQ_KT, D, DT>(Ks, kg, k0, Tk);
    load_tile<DQ_KT, D, DT>(Vs, vg, k0, Tk);
    load_ids<DQ_KT>(sk, a.seq_k, k0, Tk, -2);
    load_ids<DQ_KT>(pk, a.pos_k, k0, Tk, 0);
    __syncthreads();

    float s[RM][CN], dp[RM][CN];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < CN; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[RM], oa[RM], kc[CN], vc[CN];
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        qa[r] = Qs[(ty + kTy * r) * LD + d];
        oa[r] = dOs[(ty + kTy * r) * LD + d];
      }
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        kc[c] = Ks[(tx + kTx * c) * LD + d];
        vc[c] = Vs[(tx + kTx * c) * LD + d];
      }
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c < CN; ++c) {
          s[r][c] = fmaf(qa[r], kc[c], s[r][c]);
          dp[r][c] = fmaf(oa[r], vc[c], dp[r][c]);
        }
    }
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int ir = ty + kTy * r;
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        const int jc = tx + kTx * c;
        const float p = visible(sq[ir], pq[ir], sk[jc], pk[jc], a.causal)
                            ? exp2f(s[r][c] * a.scale2 - Ls[ir])
                            : 0.f;
        const float ds = p * (dp[r][c] - Ds[ir]) * a.sm_scale;
        dSs[ir * LP + jc] = Elem<DT>::round(ds);
      }
    }
    __syncwarp();  // a row's dS is written and read by its 8 lanes

#pragma unroll 4
    for (int j = 0; j < DQ_KT; ++j) {
      float sa[RM], kc[CD];
#pragma unroll
      for (int r = 0; r < RM; ++r) sa[r] = dSs[(ty + kTy * r) * LP + j];
#pragma unroll
      for (int e = 0; e < CD; ++e) kc[e] = Ks[j * LD + tx + kTx * e];
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int e = 0; e < CD; ++e)
          dq_acc[r][e] = fmaf(sa[r], kc[e], dq_acc[r][e]);
    }
  }

#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int i = q0 + ty + kTy * r;
    if (i >= Tq) continue;
    const long long row = (hq * Tq + i) * D;
#pragma unroll
    for (int e = 0; e < CD; ++e) dq[row + tx + kTx * e] = dq_acc[r][e];
  }
}

// ---------------------------------------------------------------------------
// bfloat16 and float16: tensor cores (fragment helpers in attention_mma.cuh)
// ---------------------------------------------------------------------------

constexpr int kRows = 64;  // dkdv: keys a block; dq: query rows a block

// query rows a dkdv step and keys a dq step: a thread holds 128 floats of
// accumulators at D 128 (dK and dV, or dQ and the Q, dO fragments)
template <int D>
constexpr int kStep = D > 64 ? 32 : 64;

template <int D>
constexpr size_t dkdv_mma_smem_bytes() {
  // K, V; two stages of Q, dO, of L, Delta and of the rows' (seq, pos)
  return 2 * (size_t)(2 * kRows + 4 * kStep<D>) * (D + kPad) +
         (sizeof(float) + sizeof(int)) * 4 * kStep<D>;
}

template <int D>
constexpr size_t dq_mma_smem_bytes() {
  // Q, dO; two stages of K, V and of the keys' (seq, pos)
  return 2 * (size_t)(2 * kRows + 4 * kStep<D>) * (D + kPad) +
         sizeof(int) * 4 * kStep<D>;
}

// entries [t0, t0 + R) of an int32 vector of length S into dst by
// cp.async, `fill` past S (a plain store), one per thread 0 <= tid < R
template <int R>
__device__ __forceinline__ void issue_ids(int* dst, const int* src, int t0,
                                          int S, int fill, int tid) {
  if (tid < 0 || tid >= R) return;
  if (t0 + tid < S)
    cp_async4(dst + tid, src + t0 + tid, true);
  else
    dst[tid] = fill;
}

// A warp's class of a tile against its own 16 ids (the warp's keys for
// dK/dV, its rows for dQ), from the tile's ids staged in shared memory;
// each lane tests N / 32 of the tile's N ids. The warp's ids that lie
// inside the packed axis span sequences [s_lo, s_hi] and positions
// [p_lo, p_hi]. OWN_Q: the warp's ids are queries (dQ). full: one
// sequence on both sides and, causal, every query at or after every key:
// nothing masked. any: some id of the tile may see (or be seen by) one
// of the warp's: else the tile adds nothing for the warp. Both exact for
// ids in any order; pad ids (-1 for queries, -2 for keys) are never full.
template <int N, bool OWN_Q>
__device__ __forceinline__ void tile_class(const int* ts, const int* tp,
                                           int s_lo, int s_hi, int p_lo,
                                           int p_hi, int causal, bool& full,
                                           bool& any) {
  const int lane = threadIdx.x % 32;
  bool all = true, hit = false;
#pragma unroll
  for (int w = 0; w < N / 32; ++w) {
    const int s = ts[lane + 32 * w], p = tp[lane + 32 * w];
    // a query sees a key when its position is at or after the key's
    all &= s == s_lo && (!causal || (OWN_Q ? p <= p_lo : p >= p_hi));
    hit |= s >= s_lo && s <= s_hi &&
           (!causal || (OWN_Q ? p <= p_hi : p >= p_lo));
  }
  full = s_lo == s_hi && __all_sync(kFull, all);
  any = __any_sync(kFull, hit);
}

// The lane's two own ids (accumulator rows g and g + 8 from r0: keys for
// dK/dV, queries for dQ) and the range of the warp's 16, over those below
// S; `fill` past S.
struct OwnIds {
  int s[2], p[2];
  int s_lo = INT_MAX, s_hi = INT_MIN, p_lo = INT_MAX, p_hi = INT_MIN;

  __device__ __forceinline__ OwnIds(const int* __restrict__ seq,
                                    const int* __restrict__ pos, int r0,
                                    int S, int fill) {
    const int g = threadIdx.x % 32 / 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = r0 + g + 8 * h;
      s[h] = i < S ? seq[i] : fill;
      p[h] = i < S ? pos[i] : 0;
      if (i < S) {
        s_lo = min(s_lo, s[h]);
        s_hi = max(s_hi, s[h]);
        p_lo = min(p_lo, p[h]);
        p_hi = max(p_hi, p[h]);
      }
    }
    s_lo = __reduce_min_sync(kFull, s_lo);
    s_hi = __reduce_max_sync(kFull, s_hi);
    p_lo = __reduce_min_sync(kFull, p_lo);
    p_hi = __reduce_max_sync(kFull, p_hi);
  }
};

// visible() as a 0 / 1 word, in integer arithmetic: from the predicate
// form, ptxas (CUDA 12.8, -O1 and above) packed a 64-wide tile's 16 bits
// into the wrong places (two columns' bits exchanged), which the card
// tests caught at kStep 64; this form gives the bits ptxas -O0 gave.
// Positions differ by less than 2^31.
__device__ __forceinline__ unsigned visible_bit(int sq, int pq, int sk,
                                                int pk, int causal) {
  const unsigned d = (unsigned)(sq ^ sk);
  const unsigned same = ((d | (0u - d)) >> 31) ^ 1u;              // sq == sk
  return causal ? same & (((unsigned)(pq - pk) >> 31) ^ 1u) : same;  // pq >= pk
}

// Each own id's visible ids among the lane's columns 8 nt + q2 + c of a
// tile of N staged ids: bit 2 nt + c of word h (own id h). OWN_Q: the
// own ids are queries.
template <int N, bool OWN_Q>
__device__ __forceinline__ void tile_bits(unsigned (&bits)[2],
                                          const OwnIds& own, const int* ts,
                                          const int* tp, int causal) {
  const int q2 = (threadIdx.x % 4) * 2;
  bits[0] = bits[1] = 0u;
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt) {
    const int2 s = *reinterpret_cast<const int2*>(ts + 8 * nt + q2);
    const int2 p = *reinterpret_cast<const int2*>(tp + 8 * nt + q2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned v0 =
          OWN_Q ? visible_bit(own.s[h], own.p[h], s.x, p.x, causal)
                : visible_bit(s.x, p.x, own.s[h], own.p[h], causal);
      const unsigned v1 =
          OWN_Q ? visible_bit(own.s[h], own.p[h], s.y, p.y, causal)
                : visible_bit(s.y, p.y, own.s[h], own.p[h], causal);
      bits[h] |= v0 << (2 * nt) | v1 << (2 * nt + 1);
    }
  }
}

template <int D, typename E>
__global__ void __launch_bounds__(kThreads)
varlen_bwd_dkdv_mma(const Args a, float* __restrict__ dk,
                    float* __restrict__ dv) {
  constexpr int BM = kStep<D>;
  constexpr int LD = D + kPad;
  static_assert(D % 16 == 0 && (LD / 8) % 2 == 1, "unsupported head_dim");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* sK = reinterpret_cast<E*>(smem_raw);                  // [kRows][LD]
  E* sV = sK + kRows * LD;                                 // [kRows][LD]
  E* sQ = sV + kRows * LD;                                 // [2][BM][LD]
  E* sO = sQ + 2 * BM * LD;                                // dO [2][BM][LD]
  float* sL = reinterpret_cast<float*>(sO + 2 * BM * LD);  // [2][BM]
  float* sDe = sL + 2 * BM;                                // [2][BM]
  int* sS = reinterpret_cast<int*>(sDe + 2 * BM);          // SeqQ [2][BM]
  int* sP = sS + 2 * BM;                                   // PosQ [2][BM]

  const E* q = static_cast<const E*>(a.q);
  const E* dout = static_cast<const E*>(a.dout);
  const int tid = threadIdx.x, warp = tid / 32;
  const int q2 = (tid % 4) * 2;
  const int k0 = blockIdx.x * kRows, hk = blockIdx.y;
  const int kw = k0 + 16 * warp;  // the warp's first key
  const int group = a.Hq / a.Hkv, Tq = a.Tq, Tk = a.Tk;
  const long long kv_off = (long long)hk * Tk * D;
  const int n_q = (Tq + BM - 1) / BM;
  LiveTiles<BM, true> tiles{a.live, Tk / a.bN, a.bM, Tq, n_q,
                            cells_of(k0, min(k0 + kRows, Tk), a.bN)};

  // step (query tile qb, head gi of the group): its Q, dO, L and Delta
  // rows into stage st, and with gi = 0 the tile's ids (-1, 0 past Tq)
  auto issue = [&](int qb, int gi, int st) {
    const int q0 = qb * BM;
    const long long hq = (long long)hk * group + gi;
    issue_rows<BM, D>(sQ + st * BM * LD, q + hq * Tq * D, q0, Tq);
    issue_rows<BM, D>(sO + st * BM * LD, dout + hq * Tq * D, q0, Tq);
    if (tid < 2 * BM) {
      const int r = tid % BM;
      const float* src = (tid < BM ? a.L : a.Delta) + hq * Tq;
      cp_async4((tid < BM ? sL : sDe) + st * BM + r,
                q0 + r < Tq ? src + q0 + r : src, q0 + r < Tq);
    }
    if (gi == 0) {
      issue_ids<BM>(sS + st * BM, a.seq_q, q0, Tq, -1, tid);
      issue_ids<BM>(sP + st * BM, a.pos_q, q0, Tq, 0, tid - BM);
    }
  };
  issue_rows<kRows, D>(sK, static_cast<const E*>(a.k) + kv_off, k0, Tk);
  issue_rows<kRows, D>(sV, static_cast<const E*>(a.v) + kv_off, k0, Tk);
  int qb = tiles.next(0), gi = 0;
  if (qb < n_q) issue(qb, 0, 0);
  tl_gemm::cp_async_commit();
  const OwnIds own(a.seq_k, a.pos_k, kw, Tk, -2);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  zero(dk_acc);
  zero(dv_acc);
  bool full = false, any = false;
  unsigned bits[2] = {0u, 0u};
  // live query tiles outer, the group's heads inner: a tile's ids and
  // class serve its `group` steps
  for (int t = 0; qb < n_q; ++t) {
    tl_gemm::cp_async_wait<0>();
    __syncthreads();  // step t landed; step t - 1's readers are done
    int nqb = qb, ngi = gi + 1;
    if (ngi == group) {
      ngi = 0;
      nqb = tiles.next(qb + 1);
    }
    if (nqb < n_q) issue(nqb, ngi, (t + 1) & 1);
    tl_gemm::cp_async_commit();
    const int st = t & 1;
    if (gi == 0) {
      tile_class<BM, false>(sS + st * BM, sP + st * BM, own.s_lo, own.s_hi,
                            own.p_lo, own.p_hi, a.causal, full, any);
      if (any && !full)
        tile_bits<BM, false>(bits, own, sS + st * BM, sP + st * BM,
                             a.causal);
    }
    qb = nqb;
    gi = ngi;
    // keys past Tk (any is false there), or no pair of the tile visible
    if (!any) continue;
    const E* tQ = sQ + st * BM * LD;
    const E* tO = sO + st * BM * LD;
    const float* tL = sL + st * BM;
    const float* tD = sDe + st * BM;

    // S^T (keys x queries) = K Q^T and dP^T = V dO^T
    float s[BM / 8][4], dp[BM / 8][4];
    zero(s);
    zero(dp);
    rows_dot_rows<D, BM>(s, sK + 16 * warp * LD, tQ);
    rows_dot_rows<D, BM>(dp, sV + 16 * warp * LD, tO);

    // P^T and dS^T; on a masked tile P is a select (L is -inf on a row
    // that sees no key, where exp2 gives +inf)
#pragma unroll
    for (int nt = 0; nt < BM / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ic = 8 * nt + q2 + (e & 1);
        float p = exp2f(s[nt][e] * a.scale2 - tL[ic]);
        if (!full && !((bits[e >> 1] >> (2 * nt + (e & 1))) & 1u)) p = 0.f;
        s[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - tD[ic]) * a.sm_scale;
      }
    unsigned pa[BM / 16][4], sa[BM / 16][4];
    to_frags<BM, E>(pa, s);
    to_frags<BM, E>(sa, dp);

    // dV += P^T dO, dK += dS^T Q
    frags_dot_tile<D, BM, E>(dv_acc, pa, tO);
    frags_dot_tile<D, BM, E>(dk_acc, sa, tQ);
  }
  tl_gemm::cp_async_wait<0>();

  store_rows<D>(dk + kv_off, dk_acc, kw, Tk);
  store_rows<D>(dv + kv_off, dv_acc, kw, Tk);
}

template <int D, typename E>
__global__ void __launch_bounds__(kThreads)
varlen_bwd_dq_mma(const Args a, float* __restrict__ dq) {
  constexpr int BN = kStep<D>;
  constexpr int LD = D + kPad;
  static_assert(D % 16 == 0 && (LD / 8) % 2 == 1, "unsupported head_dim");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* sQ = reinterpret_cast<E*>(smem_raw);              // [kRows][LD]
  E* sO = sQ + kRows * LD;                             // dO [kRows][LD]
  E* sK = sO + kRows * LD;                             // [2][BN][LD]
  E* sV = sK + 2 * BN * LD;                            // [2][BN][LD]
  int* sS = reinterpret_cast<int*>(sV + 2 * BN * LD);  // SeqK [2][BN]
  int* sP = sS + 2 * BN;                               // PosK [2][BN]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int mat = lane / 8, mr = lane % 8, g = lane / 4, q2 = (lane % 4) * 2;
  const int q0 = blockIdx.x * kRows, h = blockIdx.y;
  const int qw = q0 + 16 * warp;  // the warp's first row
  const int Tq = a.Tq, Tk = a.Tk;
  const long long hq = h;
  const long long kv_off = (long long)(h / (a.Hq / a.Hkv)) * Tk * D;
  const E* kg = static_cast<const E*>(a.k) + kv_off;
  const E* vg = static_cast<const E*>(a.v) + kv_off;
  const int n_kv = (Tk + BN - 1) / BN;
  LiveTiles<BN> tiles{a.live, Tk / a.bN, a.bN, Tk, n_kv,
                      cells_of(q0, min(q0 + kRows, Tq), a.bM)};

  // key tile kb's K, V rows and its keys' ids (-2, 0 past Tk) into stage st
  auto issue = [&](int kb, int st) {
    const int k0 = kb * BN;
    issue_rows<BN, D>(sK + st * BN * LD, kg, k0, Tk);
    issue_rows<BN, D>(sV + st * BN * LD, vg, k0, Tk);
    issue_ids<BN>(sS + st * BN, a.seq_k, k0, Tk, -2, tid);
    issue_ids<BN>(sP + st * BN, a.pos_k, k0, Tk, 0, tid - BN);
  };
  int kb = tiles.next(0);
  issue_rows<kRows, D>(sQ, static_cast<const E*>(a.q) + hq * Tq * D, q0, Tq);
  issue_rows<kRows, D>(sO, static_cast<const E*>(a.dout) + hq * Tq * D, q0,
                       Tq);
  if (kb < n_kv) issue(kb, 0);
  tl_gemm::cp_async_commit();

  // the lane's rows qw + g, qw + g + 8: their ids (-1 past Tq), L, Delta,
  // and the warp's Q and dO as A fragments
  const OwnIds own(a.seq_q, a.pos_q, qw, Tq, -1);
  float lr[2], dr[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = qw + g + 8 * hh;
    lr[hh] = i < Tq ? a.L[hq * Tq + i] : 0.f;
    dr[hh] = i < Tq ? a.Delta[hq * Tq + i] : 0.f;
  }
  tl_gemm::cp_async_wait<0>();
  __syncthreads();
  unsigned qf[D / 16][4], of[D / 16][4];
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    const int at = (16 * warp + mr + 8 * (mat % 2)) * LD + 16 * kd +
                   8 * (mat / 2);
    mma16::ldmatrix_x4(qf[kd], sQ + at);
    mma16::ldmatrix_x4(of[kd], sO + at);
  }

  float dq_acc[D / 8][4];
  zero(dq_acc);
  for (int it = 0; kb < n_kv; ++it) {
    if (it > 0) {
      tl_gemm::cp_async_wait<0>();
      __syncthreads();  // tile kb landed; the last tile's readers are done
    }
    const int nxt = tiles.next(kb + 1);
    if (nxt < n_kv) issue(nxt, (it + 1) & 1);
    tl_gemm::cp_async_commit();
    kb = nxt;
    const int st = it & 1;
    // rows past Tq (any is false there), or no pair of the tile visible
    bool full, any;
    tile_class<BN, true>(sS + st * BN, sP + st * BN, own.s_lo, own.s_hi,
                         own.p_lo, own.p_hi, a.causal, full, any);
    if (!any) continue;
    unsigned bits[2];
    if (!full) tile_bits<BN, true>(bits, own, sS + st * BN, sP + st * BN,
                                   a.causal);
    const E* tK = sK + st * BN * LD;
    const E* tV = sV + st * BN * LD;

    // S = Q K^T and dP = dO V^T from the held fragments
    float s[BN / 8][4], dp[BN / 8][4];
    zero(s);
    zero(dp);
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd)
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        const int at = (np * 16 + mr + 8 * (mat / 2)) * LD + 16 * kd +
                       8 * (mat % 2);
        unsigned r[4];
        mma16::ldmatrix_x4(r, tK + at);
        mma16::mma<E>(s[2 * np], qf[kd], r[0], r[1]);
        mma16::mma<E>(s[2 * np + 1], qf[kd], r[2], r[3]);
        mma16::ldmatrix_x4(r, tV + at);
        mma16::mma<E>(dp[2 * np], of[kd], r[0], r[1]);
        mma16::mma<E>(dp[2 * np + 1], of[kd], r[2], r[3]);
      }

    // dS; on a masked tile P is a select, as in dK/dV
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[nt][e] * a.scale2 - lr[e >> 1]);
        if (!full && !((bits[e >> 1] >> (2 * nt + (e & 1))) & 1u)) p = 0.f;
        dp[nt][e] = p * (dp[nt][e] - dr[e >> 1]) * a.sm_scale;
      }
    unsigned da[BN / 16][4];
    to_frags<BN, E>(da, dp);

    // dQ += dS K
    frags_dot_tile<D, BN, E>(dq_acc, da, tK);
  }
  tl_gemm::cp_async_wait<0>();

  store_rows<D>(dq + hq * Tq * D, dq_acc, qw, Tq);
}

// float32 on the CUDA-core kernels, bfloat16 and float16 on the tensor
// cores; no fallback between them
template <int D, int DT>
int run_dkdv(const Args& a, float* dk, float* dv, cudaStream_t st) {
  if constexpr (DT == kF32) {
    const dim3 grid((a.Tk + KV_ROWS - 1) / KV_ROWS, a.Hkv);
    return launch(varlen_bwd_dkdv<D, DT>, grid, dkdv_smem_bytes<D>(), st, a,
                  dk, dv);
  } else {
    const dim3 grid((a.Tk + kRows - 1) / kRows, a.Hkv);
    return launch(varlen_bwd_dkdv_mma<D, typename Elem<DT>::T>, grid,
                  dkdv_mma_smem_bytes<D>(), st, a, dk, dv);
  }
}

template <int D, int DT>
int run_dq(const Args& a, float* dq, cudaStream_t st) {
  if constexpr (DT == kF32) {
    const dim3 grid((a.Tq + DQ_ROWS - 1) / DQ_ROWS, a.Hq);
    return launch(varlen_bwd_dq<D, DT>, grid, dq_smem_bytes<D>(), st, a, dq);
  } else {
    const dim3 grid((a.Tq + kRows - 1) / kRows, a.Hq);
    return launch(varlen_bwd_dq_mma<D, typename Elem<DT>::T>, grid,
                  dq_mma_smem_bytes<D>(), st, a, dq);
  }
}

#define TL_HEAD_DIMS(X) X(16) X(32) X(64) X(128)

bool bad_args(int Hq, int Hkv, int Tq, int Tk, int block_M, int block_N) {
  return Hkv < 1 || Hq % Hkv || block_M < 1 || block_N < 1 || Tq % block_M ||
         Tk % block_N;
}

}  // namespace

// Both entry points launch on `stream` and return the first CUDA error
// (0 = launched), or cudaErrorInvalidValue for a head_dim without an
// instance, Hkv that does not divide Hq, or a table that does not tile
// Tq x Tk. The Python wrapper checks shapes, types and contiguity before
// calling.
extern "C" int tl_varlen_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* L, const void* Delta, const void* seq_q, const void* seq_k,
    const void* pos_q, const void* pos_k, const void* live, void* dk,
    void* dv, int Hq, int Hkv, int Tq, int Tk, int D, int block_M,
    int block_N, int dt, int causal, float scale2, float sm_scale,
    void* stream) {
  if (bad_args(Hq, Hkv, Tq, Tk, block_M, block_N))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, dout, static_cast<const float*>(L),
               static_cast<const float*>(Delta),
               static_cast<const int*>(seq_q), static_cast<const int*>(seq_k),
               static_cast<const int*>(pos_q), static_cast<const int*>(pos_k),
               static_cast<const int*>(live), Hq, Hkv, Tq, Tk, block_M,
               block_N, causal, scale2, sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
#define TL_CASE(DIM)                                                  \
  case DIM:                                                           \
    return with_elem(dt, [&](auto e) {                                \
      return run_dkdv<DIM, decltype(e)::value>(a, dkf, dvf, st);      \
    });
  switch (D) {
    TL_HEAD_DIMS(TL_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TL_CASE
}

extern "C" int tl_varlen_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* L, const void* Delta, const void* seq_q, const void* seq_k,
    const void* pos_q, const void* pos_k, const void* live, void* dq, int Hq,
    int Hkv, int Tq, int Tk, int D, int block_M, int block_N, int dt,
    int causal, float scale2, float sm_scale, void* stream) {
  if (bad_args(Hq, Hkv, Tq, Tk, block_M, block_N))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, dout, static_cast<const float*>(L),
               static_cast<const float*>(Delta),
               static_cast<const int*>(seq_q), static_cast<const int*>(seq_k),
               static_cast<const int*>(pos_q), static_cast<const int*>(pos_k),
               static_cast<const int*>(live), Hq, Hkv, Tq, Tk, block_M,
               block_N, causal, scale2, sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dqf = static_cast<float*>(dq);
#define TL_CASE(DIM)                                                  \
  case DIM:                                                           \
    return with_elem(dt, [&](auto e) {                                \
      return run_dq<DIM, decltype(e)::value>(a, dqf, st);             \
    });
  switch (D) {
    TL_HEAD_DIMS(TL_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TL_CASE
}
