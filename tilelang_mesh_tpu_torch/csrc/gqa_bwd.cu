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
// at S = 4096, so the least time is the flops over the float32 rate.
//
// Design: the TPU's no-atomics split is kept, so every output element is
// written once by one block and the result is deterministic.
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
// Float32 CUDA-core FMAs throughout; tensor cores are later work.

#include "attention_common.cuh"

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

struct Args {
  const void *q, *k, *v, *dout;
  const float *L, *Delta;
  int B, Hq, Hkv, Sq, Sk, causal;
  float scale2, sm_scale;
};

template <int D, int DT>
int run_dkdv(const Args& a, float* dk, float* dv, cudaStream_t st) {
  using T = typename Elem<DT>::T;
  const dim3 grid((a.Sk + KV_ROWS - 1) / KV_ROWS, a.Hkv, a.B);
  return launch(gqa_bwd_dkdv<D, DT>, grid, dkdv_smem_bytes<D>(), st,
                static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
                a.L, a.Delta, dk, dv, a.Hq, a.Hkv, a.Sq, a.Sk, a.causal,
                a.scale2, a.sm_scale);
}

template <int D, int DT>
int run_dq(const Args& a, float* dq, cudaStream_t st) {
  using T = typename Elem<DT>::T;
  const dim3 grid((a.Sq + DQ_ROWS - 1) / DQ_ROWS, a.Hq, a.B);
  return launch(gqa_bwd_dq<D, DT>, grid, dq_smem_bytes<D>(), st,
                static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
                a.L, a.Delta, dq, a.Hq, a.Hkv, a.Sq, a.Sk, a.causal, a.scale2,
                a.sm_scale);
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
