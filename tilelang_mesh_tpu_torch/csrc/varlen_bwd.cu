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
// pairs' flops over the float32 rate.
//
// Design: csrc/gqa_bwd.cu's loops and its no-atomics split, so every
// output element is written once by one block and the result is
// deterministic; what differs is the document mask and the visited
// tiles, read from BlockLive as in the forward.
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
// Float32 CUDA-core FMAs throughout; tensor cores are later work.

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

template <int D, int DT>
int run_dkdv(const Args& a, float* dk, float* dv, cudaStream_t st) {
  const dim3 grid((a.Tk + KV_ROWS - 1) / KV_ROWS, a.Hkv);
  return launch(varlen_bwd_dkdv<D, DT>, grid, dkdv_smem_bytes<D>(), st, a,
                dk, dv);
}

template <int D, int DT>
int run_dq(const Args& a, float* dq, cudaStream_t st) {
  const dim3 grid((a.Tq + DQ_ROWS - 1) / DQ_ROWS, a.Hq);
  return launch(varlen_bwd_dq<D, DT>, grid, dq_smem_bytes<D>(), st, a, dq);
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
