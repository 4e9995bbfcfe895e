// Grouped-query attention backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of tilelang_mesh_tpu/ops/gqa_bwd.py:
//   gqa_bwd_dkdv_kernel (:29) -> tl_gqa_bwd_dkdv
//   gqa_bwd_dq_kernel (:103)  -> tl_gqa_bwd_dq
// MHA is group = 1 (ops/flash_attention_bwd.py:22). Same contract:
//   Q, dO (B, Hq, Sq, D); K, V (B, Hkv, Sk, D), float32, bfloat16 or float16;
//   L = lse2 = m + log2(l) and Delta = sum(dO * O, -1), (B, Hq, Sq) f32;
//   query head h reads KV head h / (Hq / Hkv);
//   P = exp2(Q K^T * scale2 - L), scale2 = sm_scale * log2(e), 0 where
//   masked (top-left causal i >= j, and the ragged edges);
//   dS = P * (dO V^T - Delta) * sm_scale;
//   dV = sum over the group of dtype(P)^T dO, dK = dtype(dS)^T Q,
//   dQ = dtype(dS) K; dK, dV (B, Hkv, Sk, D) and dQ (B, Hq, Sq, D) f32.
// P and dS are rounded to the input type before their products, as the
// TPU kernels hold them in dtype fragments.
//
// Bound: operations. Per visible (i, j) pair dK/dV do 8 * D flops
// (S, dP, dV, dK) and dQ 6 * D (S, dP, dQ), far above the balance point
// at S = 4096, so the least time is the flops over the float32 rate, or
// the bfloat16 / float16 tensor-core rate.
//
// Design: the TPU's no-atomics split is kept, so every output element is
// written once by one block and the result is deterministic.
//
// float32 (`gqa_bwd_dkdv`, `gqa_bwd_dq`; CUDA-core FMAs, the reference's
// float32 numerics):
// * dkdv: one block per (32-key tile, KV head, batch) keeps its K and V
//   tile in shared memory and its dK, dV rows in registers, and loops
//   over the group's query heads and their 32-row Q tiles (from the
//   diagonal on when causal) — the TPU's pipelined (head-in-group,
//   q-block) axis. Each step loads Q, dO, L, Delta, computes the
//   transposed scores S^T and dP^T (4 x 2 per thread), forms P and dS,
//   writes them to shared tiles read only by the owning warp, and
//   accumulates dV += P^T dO and dK += dS^T Q.
// * dq: one block per (64-query tile, query head, batch) keeps Q, dO, L,
//   Delta in shared memory and dQ in registers, and loops over 32-key
//   tiles up to the diagonal, accumulating dQ += dS K.
//
// bfloat16 and float16 (`gqa_bwd_dkdv_mma`, `gqa_bwd_dq_mma`; tensor
// cores): FlashAttention-2's backward, kept as two kernels. Operands sit
// in shared memory in the input type, each row padded by 8 elements (an
// odd count of 16-byte chunks, so the 8 rows of an ldmatrix hit 8 bank
// groups); products are mma.sync m16n8k16 with float32 sums. In an
// m16n8 accumulator lane (g, q2) = (lane / 4, 2 (lane % 4)) holds rows g
// and g + 8, columns q2 and q2 + 1: two n8 tiles of P or dS are the A
// fragment of the next product's k16 step, so P and dS are rounded to
// the input type in registers and never touch shared memory.
// * dkdv: one block per (64-key tile, KV head, batch), four warps of 16
//   keys. K and V arrive once; the group's Q, dO, L and Delta tiles
//   (BM query rows, from the diagonal tile on when causal) arrive by
//   cp.async into two stages, the next while this one is computed. Each
//   warp takes S^T = K Q^T and dP^T = V dO^T on its 16 keys, forms P and
//   dS on the fragments (the mask only on edge tiles; a warp whose keys
//   all follow the tile's queries skips it), and accumulates dV += P^T dO
//   and dK += dS^T Q (dO and Q through ldmatrix.trans).
// * dq: one block per (64-query tile, query head, batch), heaviest causal
//   tiles first, four warps of 16 rows. Q and dO are held as A fragments
//   and each lane's L and Delta in registers; K and V tiles of BN keys
//   arrive by cp.async, double-buffered, up to the diagonal. Each warp
//   takes S = Q K^T and dP = dO V^T, forms dS, and accumulates dQ += dS K
//   (K through ldmatrix.trans).
// BM = BN = 32 at D = 128, where a thread already holds 128 floats of
// accumulators (dK and dV, or dQ and the Q, dO fragments), 64 below.

#include "attention_common.cuh"
#include "attention_mma.cuh"

namespace {

using namespace tl_attn;

constexpr int KV_ROWS = 32;  // dkdv: keys per block
constexpr int KV_QT = 32;    // dkdv: query rows per step
constexpr int DQ_ROWS = 64;  // dq: query rows per block
constexpr int DQ_KT = 32;    // dq: keys per step

template <int D>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(float) * (2 * KV_ROWS * (D + 1) + 2 * KV_QT * (D + 1) +
                          2 * KV_ROWS * (KV_QT + 1) + 2 * KV_QT);
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (2 * DQ_ROWS * (D + 1) + 2 * DQ_KT * (D + 1) +
                          DQ_ROWS * (DQ_KT + 1) + 2 * DQ_ROWS);
}

template <int D, int DT>
__global__ void __launch_bounds__(kThreads)
gqa_bwd_dkdv(const typename Elem<DT>::T* __restrict__ q,
             const typename Elem<DT>::T* __restrict__ k,
             const typename Elem<DT>::T* __restrict__ v,
             const typename Elem<DT>::T* __restrict__ dout,
             const float* __restrict__ L, const float* __restrict__ Delta,
             float* __restrict__ dk, float* __restrict__ dv, int Hq, int Hkv,
             int Sq, int Sk, int causal, float scale2, float sm_scale) {
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

  const int ty = threadIdx.x / kTx, tx = threadIdx.x % kTx;
  const int k0 = blockIdx.x * KV_ROWS, hk = blockIdx.y, b = blockIdx.z;
  const int group = Hq / Hkv;
  const long long bhk = (long long)b * Hkv + hk;

  load_tile<KV_ROWS, D, DT>(Ks, k + bhk * Sk * D, k0, Sk);
  load_tile<KV_ROWS, D, DT>(Vs, v + bhk * Sk * D, k0, Sk);

  float dk_acc[RN][CD], dv_acc[RN][CD];
#pragma unroll
  for (int a = 0; a < RN; ++a)
#pragma unroll
    for (int e = 0; e < CD; ++e) dk_acc[a][e] = dv_acc[a][e] = 0.f;

  const int n_q = (Sq + KV_QT - 1) / KV_QT;
  const int q_first = causal ? k0 / KV_QT : 0;  // first tile with i >= k0
  for (int g = 0; g < group; ++g) {
    const long long bhq = (long long)b * Hq + hk * group + g;
    for (int qb = q_first; qb < n_q; ++qb) {
      const int q0 = qb * KV_QT;
      __syncthreads();  // the previous step's readers are done
      load_tile<KV_QT, D, DT>(Qs, q + bhq * Sq * D, q0, Sq);
      load_tile<KV_QT, D, DT>(dOs, dout + bhq * Sq * D, q0, Sq);
      load_vec<KV_QT>(Ls, L + bhq * Sq, q0, Sq);
      load_vec<KV_QT>(Ds, Delta + bhq * Sq, q0, Sq);
      __syncthreads();

      // S^T (j, i) = K_j . Q_i and dP^T (j, i) = V_j . dO_i
      float st[RN][CQ], dpt[RN][CQ];
#pragma unroll
      for (int a = 0; a < RN; ++a)
#pragma unroll
        for (int c = 0; c < CQ; ++c) st[a][c] = dpt[a][c] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        float ka[RN], va[RN], qc[CQ], oc[CQ];
#pragma unroll
        for (int a = 0; a < RN; ++a) {
          ka[a] = Ks[(ty + kTy * a) * LD + d];
          va[a] = Vs[(ty + kTy * a) * LD + d];
        }
#pragma unroll
        for (int c = 0; c < CQ; ++c) {
          qc[c] = Qs[(tx + kTx * c) * LD + d];
          oc[c] = dOs[(tx + kTx * c) * LD + d];
        }
#pragma unroll
        for (int a = 0; a < RN; ++a)
#pragma unroll
          for (int c = 0; c < CQ; ++c) {
            st[a][c] = fmaf(ka[a], qc[c], st[a][c]);
            dpt[a][c] = fmaf(va[a], oc[c], dpt[a][c]);
          }
      }
#pragma unroll
      for (int a = 0; a < RN; ++a) {
        const int j = k0 + ty + kTy * a;
#pragma unroll
        for (int c = 0; c < CQ; ++c) {
          const int ic = tx + kTx * c, i = q0 + ic;
          const bool live = i < Sq && j < Sk && (!causal || i >= j);
          const float p = live ? exp2f(st[a][c] * scale2 - Ls[ic]) : 0.f;
          const float ds = p * (dpt[a][c] - Ds[ic]) * sm_scale;
          Pt[(ty + kTy * a) * LQ + ic] = Elem<DT>::round(p);
          dSt[(ty + kTy * a) * LQ + ic] = Elem<DT>::round(ds);
        }
      }
      __syncwarp();  // a key's P^T, dS^T row is written and read by its 8 lanes

#pragma unroll 4
      for (int i = 0; i < KV_QT; ++i) {
        float pa[RN], sa[RN], oc[CD], qc[CD];
#pragma unroll
        for (int a = 0; a < RN; ++a) {
          pa[a] = Pt[(ty + kTy * a) * LQ + i];
          sa[a] = dSt[(ty + kTy * a) * LQ + i];
        }
#pragma unroll
        for (int e = 0; e < CD; ++e) {
          oc[e] = dOs[i * LD + tx + kTx * e];
          qc[e] = Qs[i * LD + tx + kTx * e];
        }
#pragma unroll
        for (int a = 0; a < RN; ++a)
#pragma unroll
          for (int e = 0; e < CD; ++e) {
            dv_acc[a][e] = fmaf(pa[a], oc[e], dv_acc[a][e]);
            dk_acc[a][e] = fmaf(sa[a], qc[e], dk_acc[a][e]);
          }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < RN; ++a) {
    const int j = k0 + ty + kTy * a;
    if (j >= Sk) continue;
    const long long row = (bhk * Sk + j) * D;
#pragma unroll
    for (int e = 0; e < CD; ++e) {
      dk[row + tx + kTx * e] = dk_acc[a][e];
      dv[row + tx + kTx * e] = dv_acc[a][e];
    }
  }
}

template <int D, int DT>
__global__ void __launch_bounds__(kThreads)
gqa_bwd_dq(const typename Elem<DT>::T* __restrict__ q,
           const typename Elem<DT>::T* __restrict__ k,
           const typename Elem<DT>::T* __restrict__ v,
           const typename Elem<DT>::T* __restrict__ dout,
           const float* __restrict__ L, const float* __restrict__ Delta,
           float* __restrict__ dq, int Hq, int Hkv, int Sq, int Sk, int causal,
           float scale2, float sm_scale) {
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

  const int ty = threadIdx.x / kTx, tx = threadIdx.x % kTx;
  const int q0 = blockIdx.x * DQ_ROWS, h = blockIdx.y, b = blockIdx.z;
  const long long bhq = (long long)b * Hq + h;
  const long long bhk = (long long)b * Hkv + h / (Hq / Hkv);
  const auto* kg = k + bhk * Sk * D;
  const auto* vg = v + bhk * Sk * D;

  load_tile<DQ_ROWS, D, DT>(Qs, q + bhq * Sq * D, q0, Sq);
  load_tile<DQ_ROWS, D, DT>(dOs, dout + bhq * Sq * D, q0, Sq);
  load_vec<DQ_ROWS>(Ls, L + bhq * Sq, q0, Sq);
  load_vec<DQ_ROWS>(Ds, Delta + bhq * Sq, q0, Sq);

  float dq_acc[RM][CD];
#pragma unroll
  for (int a = 0; a < RM; ++a)
#pragma unroll
    for (int e = 0; e < CD; ++e) dq_acc[a][e] = 0.f;

  int n_kv = (Sk + DQ_KT - 1) / DQ_KT;
  if (causal) n_kv = min(n_kv, (q0 + DQ_ROWS - 1) / DQ_KT + 1);
  for (int kb = 0; kb < n_kv; ++kb) {
    const int k0 = kb * DQ_KT;
    __syncthreads();  // the previous step's readers are done
    load_tile<DQ_KT, D, DT>(Ks, kg, k0, Sk);
    load_tile<DQ_KT, D, DT>(Vs, vg, k0, Sk);
    __syncthreads();

    float s[RM][CN], dp[RM][CN];
#pragma unroll
    for (int a = 0; a < RM; ++a)
#pragma unroll
      for (int c = 0; c < CN; ++c) s[a][c] = dp[a][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[RM], oa[RM], kc[CN], vc[CN];
#pragma unroll
      for (int a = 0; a < RM; ++a) {
        qa[a] = Qs[(ty + kTy * a) * LD + d];
        oa[a] = dOs[(ty + kTy * a) * LD + d];
      }
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        kc[c] = Ks[(tx + kTx * c) * LD + d];
        vc[c] = Vs[(tx + kTx * c) * LD + d];
      }
#pragma unroll
      for (int a = 0; a < RM; ++a)
#pragma unroll
        for (int c = 0; c < CN; ++c) {
          s[a][c] = fmaf(qa[a], kc[c], s[a][c]);
          dp[a][c] = fmaf(oa[a], vc[c], dp[a][c]);
        }
    }
#pragma unroll
    for (int a = 0; a < RM; ++a) {
      const int ir = ty + kTy * a, i = q0 + ir;
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        const int j = k0 + tx + kTx * c;
        const bool live = i < Sq && j < Sk && (!causal || i >= j);
        const float p = live ? exp2f(s[a][c] * scale2 - Ls[ir]) : 0.f;
        const float ds = p * (dp[a][c] - Ds[ir]) * sm_scale;
        dSs[ir * LP + tx + kTx * c] = Elem<DT>::round(ds);
      }
    }
    __syncwarp();  // a row's dS is written and read by its 8 lanes

#pragma unroll 4
    for (int j = 0; j < DQ_KT; ++j) {
      float sa[RM], kc[CD];
#pragma unroll
      for (int a = 0; a < RM; ++a) sa[a] = dSs[(ty + kTy * a) * LP + j];
#pragma unroll
      for (int e = 0; e < CD; ++e) kc[e] = Ks[j * LD + tx + kTx * e];
#pragma unroll
      for (int a = 0; a < RM; ++a)
#pragma unroll
        for (int e = 0; e < CD; ++e)
          dq_acc[a][e] = fmaf(sa[a], kc[e], dq_acc[a][e]);
    }
  }

#pragma unroll
  for (int a = 0; a < RM; ++a) {
    const int i = q0 + ty + kTy * a;
    if (i >= Sq) continue;
    const long long row = (bhq * Sq + i) * D;
#pragma unroll
    for (int e = 0; e < CD; ++e) dq[row + tx + kTx * e] = dq_acc[a][e];
  }
}

// ---------------------------------------------------------------------------
// bfloat16 and float16: tensor cores (fragment helpers in attention_mma.cuh)
// ---------------------------------------------------------------------------

constexpr int kRows = 64;  // dkdv: keys a block; dq: query rows a block

// query rows a dkdv step and keys a dq step
template <int D>
constexpr int kStep = D > 64 ? 32 : 64;

template <int D>
constexpr size_t dkdv_mma_smem_bytes() {
  return 2 * (size_t)(2 * kRows + 4 * kStep<D>) * (D + kPad) +
         sizeof(float) * 4 * kStep<D>;
}

template <int D>
constexpr size_t dq_mma_smem_bytes() {
  return 2 * (size_t)(2 * kRows + 4 * kStep<D>) * (D + kPad);
}

template <int D, typename E>
__global__ void __launch_bounds__(kThreads)
gqa_bwd_dkdv_mma(const E* __restrict__ q, const E* __restrict__ k,
                 const E* __restrict__ v, const E* __restrict__ dout,
                 const float* __restrict__ L,
                 const float* __restrict__ Delta, float* __restrict__ dk,
                 float* __restrict__ dv, int Hq, int Hkv, int Sq, int Sk,
                 int causal, float scale2, float sm_scale) {
  constexpr int BM = kStep<D>;
  constexpr int LD = D + kPad;
  static_assert(D % 16 == 0 && (LD / 8) % 2 == 1, "unsupported head_dim");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* sK = reinterpret_cast<E*>(smem_raw);              // [kRows][LD]
  E* sV = sK + kRows * LD;                             // [kRows][LD]
  E* sQ = sV + kRows * LD;                             // [2][BM][LD]
  E* sO = sQ + 2 * BM * LD;                            // dO [2][BM][LD]
  float* sL = reinterpret_cast<float*>(sO + 2 * BM * LD);  // [2][BM]
  float* sDe = sL + 2 * BM;                                // [2][BM]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q2 = (lane % 4) * 2;
  const int k0 = blockIdx.x * kRows, hk = blockIdx.y, b = blockIdx.z;
  const int kw = k0 + 16 * warp;  // the warp's first key
  const int group = Hq / Hkv;
  const long long bhk = (long long)b * Hkv + hk;
  const int n_q = (Sq + BM - 1) / BM;
  const int q_first = causal ? min(k0 / BM, n_q) : 0;  // first i >= k0
  const int n_qt = n_q - q_first;
  const int n_steps = group * n_qt;  // (head in group, query tile)

  // step t's Q, dO, L, Delta into stage t & 1
  auto issue = [&](int t) {
    const int st = t & 1, q0 = (q_first + t % n_qt) * BM;
    const long long bhq = (long long)b * Hq + hk * group + t / n_qt;
    issue_rows<BM, D>(sQ + st * BM * LD, q + bhq * Sq * D, q0, Sq);
    issue_rows<BM, D>(sO + st * BM * LD, dout + bhq * Sq * D, q0, Sq);
    if (tid < 2 * BM) {
      const int r = tid % BM;
      const float* src = (tid < BM ? L : Delta) + bhq * Sq;
      cp_async4((tid < BM ? sL : sDe) + st * BM + r,
                q0 + r < Sq ? src + q0 + r : src, q0 + r < Sq);
    }
  };
  issue_rows<kRows, D>(sK, k + bhk * Sk * D, k0, Sk);
  issue_rows<kRows, D>(sV, v + bhk * Sk * D, k0, Sk);
  if (n_steps > 0) issue(0);
  tl_gemm::cp_async_commit();

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  zero(dk_acc);
  zero(dv_acc);
  for (int t = 0; t < n_steps; ++t) {
    tl_gemm::cp_async_wait<0>();
    __syncthreads();  // step t landed; step t - 1's readers are done
    if (t + 1 < n_steps) issue(t + 1);
    tl_gemm::cp_async_commit();
    const int st = t & 1, q0 = (q_first + t % n_qt) * BM;
    // keys past Sk, or all after the tile's last query: nothing to add
    if (kw >= Sk || (causal && q0 + BM <= kw)) continue;
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

    // P^T and dS^T, masked on an edge tile (i < j, or i past Sq)
    const bool edge = (causal && q0 < kw + 16) || q0 + BM > Sq;
#pragma unroll
    for (int nt = 0; nt < BM / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ic = 8 * nt + q2 + (e & 1);
        float p = exp2f(s[nt][e] * scale2 - tL[ic]);
        if (edge) {
          const int i = q0 + ic, j = kw + g + 8 * (e >> 1);
          if (i >= Sq || (causal && i < j)) p = 0.f;
        }
        s[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - tD[ic]) * sm_scale;
      }
    unsigned pa[BM / 16][4], sa[BM / 16][4];
    to_frags<BM, E>(pa, s);
    to_frags<BM, E>(sa, dp);

    // dV += P^T dO, dK += dS^T Q
    frags_dot_tile<D, BM, E>(dv_acc, pa, tO);
    frags_dot_tile<D, BM, E>(dk_acc, sa, tQ);
  }
  tl_gemm::cp_async_wait<0>();

  store_rows<D>(dk + bhk * Sk * D, dk_acc, kw, Sk);
  store_rows<D>(dv + bhk * Sk * D, dv_acc, kw, Sk);
}

template <int D, typename E>
__global__ void __launch_bounds__(kThreads)
gqa_bwd_dq_mma(const E* __restrict__ q, const E* __restrict__ k,
               const E* __restrict__ v, const E* __restrict__ dout,
               const float* __restrict__ L, const float* __restrict__ Delta,
               float* __restrict__ dq, int Hq, int Hkv, int Sq, int Sk,
               int causal, float scale2, float sm_scale) {
  constexpr int BN = kStep<D>;
  constexpr int LD = D + kPad;
  static_assert(D % 16 == 0 && (LD / 8) % 2 == 1, "unsupported head_dim");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* sQ = reinterpret_cast<E*>(smem_raw);  // [kRows][LD]
  E* sO = sQ + kRows * LD;                 // dO [kRows][LD]
  E* sK = sO + kRows * LD;                 // [2][BN][LD]
  E* sV = sK + 2 * BN * LD;                // [2][BN][LD]

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int mat = lane / 8, mr = lane % 8, g = lane / 4, q2 = (lane % 4) * 2;
  // the last query tiles see the most keys when causal: they go first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int qw = q0 + 16 * warp;  // the warp's first row
  const long long bhq = (long long)b * Hq + h;
  const long long bhk = (long long)b * Hkv + h / (Hq / Hkv);
  const E* kg = k + bhk * Sk * D;
  const E* vg = v + bhk * Sk * D;
  int n_kv = (Sk + BN - 1) / BN;
  if (causal) n_kv = min(n_kv, (q0 + kRows - 1) / BN + 1);

  issue_rows<kRows, D>(sQ, q + bhq * Sq * D, q0, Sq);
  issue_rows<kRows, D>(sO, dout + bhq * Sq * D, q0, Sq);
  issue_rows<BN, D>(sK, kg, 0, Sk);
  issue_rows<BN, D>(sV, vg, 0, Sk);
  tl_gemm::cp_async_commit();

  // the lane's rows qw + g, qw + g + 8: L, Delta, and the warp's Q and dO
  // as A fragments
  float lr[2], dr[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = qw + g + 8 * hh;
    lr[hh] = i < Sq ? L[bhq * Sq + i] : 0.f;
    dr[hh] = i < Sq ? Delta[bhq * Sq + i] : 0.f;
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
  for (int kb = 0; kb < n_kv; ++kb) {
    tl_gemm::cp_async_wait<0>();
    __syncthreads();  // tile kb landed; tile kb - 1's readers are done
    if (kb + 1 < n_kv) {
      const int st = (kb + 1) & 1;
      issue_rows<BN, D>(sK + st * BN * LD, kg, (kb + 1) * BN, Sk);
      issue_rows<BN, D>(sV + st * BN * LD, vg, (kb + 1) * BN, Sk);
    }
    tl_gemm::cp_async_commit();
    const int k0 = kb * BN;
    // rows past Sq, or all before the tile's first key: nothing to add
    if (qw >= Sq || (causal && k0 > qw + 15)) continue;
    const E* tK = sK + (kb & 1) * BN * LD;
    const E* tV = sV + (kb & 1) * BN * LD;

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

    // dS, masked on an edge tile (i < j, or j past Sk)
    const bool edge = (causal && k0 + BN - 1 > qw) || k0 + BN > Sk;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[nt][e] * scale2 - lr[e >> 1]);
        if (edge) {
          const int i = qw + g + 8 * (e >> 1), j = k0 + 8 * nt + q2 + (e & 1);
          if (j >= Sk || (causal && i < j)) p = 0.f;
        }
        dp[nt][e] = p * (dp[nt][e] - dr[e >> 1]) * sm_scale;
      }
    unsigned da[BN / 16][4];
    to_frags<BN, E>(da, dp);

    // dQ += dS K
    frags_dot_tile<D, BN, E>(dq_acc, da, tK);
  }
  tl_gemm::cp_async_wait<0>();

  store_rows<D>(dq + bhq * Sq * D, dq_acc, qw, Sq);
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *L, *Delta;
  int B, Hq, Hkv, Sq, Sk, causal;
  float scale2, sm_scale;
};

template <int D>
int run_dkdv(const Args& a, int dt, float* dk, float* dv, cudaStream_t st) {
  const dim3 grid32((a.Sk + KV_ROWS - 1) / KV_ROWS, a.Hkv, a.B);
  const dim3 grid16((a.Sk + kRows - 1) / kRows, a.Hkv, a.B);
  auto go = [&](auto kernel, dim3 grid, size_t bytes, auto* e) {
    using T = std::remove_pointer_t<decltype(e)>;
    return launch(kernel, grid, bytes, st, static_cast<const T*>(a.q),
                  static_cast<const T*>(a.k), static_cast<const T*>(a.v),
                  static_cast<const T*>(a.dout), a.L, a.Delta, dk, dv, a.Hq,
                  a.Hkv, a.Sq, a.Sk, a.causal, a.scale2, a.sm_scale);
  };
  switch (dt) {
    case kF32:
      return go(gqa_bwd_dkdv<D, kF32>, grid32, dkdv_smem_bytes<D>(),
                (float*)nullptr);
    case kBF16:
      return go(gqa_bwd_dkdv_mma<D, __nv_bfloat16>, grid16,
                dkdv_mma_smem_bytes<D>(), (__nv_bfloat16*)nullptr);
    case kF16:
      return go(gqa_bwd_dkdv_mma<D, __half>, grid16,
                dkdv_mma_smem_bytes<D>(), (__half*)nullptr);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int D>
int run_dq(const Args& a, int dt, float* dq, cudaStream_t st) {
  const dim3 grid((a.Sq + DQ_ROWS - 1) / DQ_ROWS, a.Hq, a.B);
  static_assert(DQ_ROWS == kRows, "both designs take 64 query rows a block");
  auto go = [&](auto kernel, size_t bytes, auto* e) {
    using T = std::remove_pointer_t<decltype(e)>;
    return launch(kernel, grid, bytes, st, static_cast<const T*>(a.q),
                  static_cast<const T*>(a.k), static_cast<const T*>(a.v),
                  static_cast<const T*>(a.dout), a.L, a.Delta, dq, a.Hq,
                  a.Hkv, a.Sq, a.Sk, a.causal, a.scale2, a.sm_scale);
  };
  switch (dt) {
    case kF32:
      return go(gqa_bwd_dq<D, kF32>, dq_smem_bytes<D>(), (float*)nullptr);
    case kBF16:
      return go(gqa_bwd_dq_mma<D, __nv_bfloat16>, dq_mma_smem_bytes<D>(),
                (__nv_bfloat16*)nullptr);
    case kF16:
      return go(gqa_bwd_dq_mma<D, __half>, dq_mma_smem_bytes<D>(),
                (__half*)nullptr);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

#define TL_HEAD_DIMS(X) X(16) X(32) X(64) X(128)

}  // namespace

// Both entry points launch on `stream` and return the first CUDA error
// (0 = launched), or cudaErrorInvalidValue for a head_dim without an
// instance. The Python wrapper checks shapes, types, Hq % Hkv == 0 and
// contiguity before calling.
extern "C" int tl_gqa_bwd_dkdv(const void* q, const void* k, const void* v,
                               const void* dout, const void* L,
                               const void* Delta, void* dk, void* dv, int B,
                               int Hq, int Hkv, int Sq, int Sk, int D,
                               int dt, int causal, float scale2,
                               float sm_scale, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(L),
               static_cast<const float*>(Delta), B, Hq, Hkv, Sq, Sk, causal,
               scale2, sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
#define TL_CASE(DIM) \
  case DIM:          \
    return run_dkdv<DIM>(a, dt, dkf, dvf, st);
  switch (D) {
    TL_HEAD_DIMS(TL_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TL_CASE
}

extern "C" int tl_gqa_bwd_dq(const void* q, const void* k, const void* v,
                             const void* dout, const void* L,
                             const void* Delta, void* dq, int B, int Hq,
                             int Hkv, int Sq, int Sk, int D, int dt,
                             int causal, float scale2, float sm_scale,
                             void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(L),
               static_cast<const float*>(Delta), B, Hq, Hkv, Sq, Sk, causal,
               scale2, sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dqf = static_cast<float*>(dq);
#define TL_CASE(DIM) \
  case DIM:          \
    return run_dq<DIM>(a, dt, dqf, st);
  switch (D) {
    TL_HEAD_DIMS(TL_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TL_CASE
}
