// Native Sparse Attention (DeepSeek NSA) training backward, for Hopper
// (sm_90a): dK / dV and dQ of the selected branch.
//
// Replaces the TPU kernels of tilelang_mesh_tpu/ops/nsa_bwd.py:
//   nsa_bwd_dkdv_kernel (:28) -> tl_nsa_bwd_dkdv + tl_nsa_bwd_dkdv_sum
//   nsa_bwd_dq_kernel (:99)   -> tl_nsa_bwd_dq
// Same contract:
//   Q, dO (B, T, H, G, D) in float32, bfloat16 or float16 (`dt`:
//   attention_common.cuh's codes), contiguous; K, V (B, H, Tk, D) of Q's
//   type as a strided view (element (b, h, r, d) at b sb + h sh + r sr +
//   d); L = lse2 = m + log2(l) and Delta = sum(dO * O, -1), (B, T, H, G)
//   float32. With scale2 = sm_scale * log2(e), a visible (query, key)
//   pair has P = exp2(Q K^T * scale2 - L) and dS = P * (dO V^T - Delta)
//   * sm_scale; P and dS are rounded to the input type before their
//   products, as the TPU kernels hold them in dtype fragments. Key j is
//   visible to token t when j <= t (and j < Tk).
//   * dK, dV (B, H, Tk, D) float32: each KV block sums over the tokens
//     whose multiplicity map Mask (B, T, H, NS) is nonzero; a block listed
//     m times by a token has m times the softmax mass in the forward, so
//     P (before its rounding, and so dS) is scaled by m (:72-80).
//   * dQ (B, T, H, G, D) float32: each token gathers its selected blocks
//     again, as the forward does (BI (B, T, H, S), Cnt (B, T, H) int32;
//     slot s < min(Cnt, S), id >= 0, id * BS <= t). A block listed twice
//     is visited twice, so dQ needs no multiplicity factor.
//
// Bound: operations. Per visible (query head, key) pair dK/dV do 8 * D
// flops (S, dP, dV, dK) and dQ 6 * D (S, dP, dQ). In 16 bits the
// gathers hold both above that bound: dK/dV read a token's group of Q
// and dO rows again for each block it selects (NSA's widths: ~4 GB a
// step, mostly from HBM), dQ a token's selected K and V rows (~16 GB,
// mostly from L2).
//
// Design, shared by both types.
// * dkdv. The TPU kernel gives each (KV block, KV head, batch) one
//   program that sweeps all T tokens in order, gated by Mask: no atomics
//   on the TPU. On the card that grid is badly unbalanced when many
//   tokens select one block (NSA's selections always include block 0:
//   its program would sweep every token while the rest sit idle). Here
//   the wrapper compacts Mask into per-(batch, head, block) lists of
//   (token, multiplicity), in token order, and cuts each list into chunks
//   of a fixed number of tokens; one block of 128 threads takes (chunk,
//   key tile of the block), keeps its K and V tile and its dK, dV rows,
//   and walks the chunk's (token, query head) rows a step at a time
//   (gqa_bwd.cu's step). Each chunk writes its float32 partial once to a
//   workspace (chunks, 2, BS, D); tl_nsa_bwd_dkdv_sum then adds each
//   block's partials in chunk order into dK and dV. No atomics: every
//   element is written once, in a fixed order, so two runs give the same
//   bits.
// * dq. Each (token, KV head, batch) gathers its selected blocks again,
//   as nsa.cu's forward: the group's G query rows padded with zero rows
//   to the row tile, dQ accumulated over the blocks' keys.
//
// float32 (nsa_bwd_dkdv, nsa_bwd_dq; CUDA-core FMAs, exact): dkdv takes
// 32-key tiles and 32 rows a step (2 keys x 4 rows a thread for S^T and
// dP^T, P and dS through shared tiles); dq one block a (token, KV head),
// the TPU grid (:125), Q and dO in shared memory (BM 16, or 64 for G up
// to 64), 32-key tiles, dS through a shared tile only its own warp reads.
//
// bfloat16 and float16 (nsa_bwd_dkdv_mma, nsa_bwd_dq_mma; tensor cores,
// mma.sync m16n8k16 with float32 sums on attention_mma.cuh's fragments,
// operands staged by cp.async; P and dS rounded to the input type in
// registers, as the A fragments of the next product):
// * dkdv_mma: a block takes (chunk, 64-key tile), four warps of 16 keys.
//   K and V arrive once; the chunk's rows arrive BM at a time (32 at D
//   128, 64 below) into two stages, the next while this one is computed:
//   Q and dO gathered through a row table (a token's G rows are one
//   contiguous run; issue_rows_at), L, Delta, the multiplicity and the
//   token beside them. Each warp forms S^T = K Q^T and dP^T = V dO^T on
//   its 16 keys, P (scaled by the row's multiplicity before its
//   rounding) and dS on the fragments, and accumulates dV += P^T dO and
//   dK += dS^T Q (dO and Q through ldmatrix.trans). A block's list holds
//   only tokens t >= its first key, in token order, so only a step whose
//   first token lies before the warp's last key needs the causal mask.
// * dq_mma: a team of MT warps takes one token, its group's MT m16 tiles
//   (MT 1 for G up to 16: four tokens a block, a warp a token, as nsa.cu's
//   nsa_fwd_tok_mma; MT 4 for G up to 64: a block a token). Q and dO are
//   held as A fragments, each lane's L and Delta in registers. The
//   token's selected blocks come in chunks of 16 keys through the team's
//   own cp.async ring of K and V (__syncwarp at MT 1); each chunk forms S
//   = Q K^T and dP = dO V^T, then dS, and accumulates dQ += dS K (K
//   through ldmatrix.trans). dQ is stored in float32 from the fragments.

#include <climits>

#include "attention_mma.cuh"

namespace {

using namespace tl_attn;

constexpr int KT = 32;  // dkdv: keys a block
constexpr int QT = 32;  // dkdv: (token, query head) rows a step
constexpr int BN = 32;  // dq: keys a step

struct Common {
  const void *q, *k, *v, *dout;
  const float *L, *Delta;
  long long sb, sh, sr;  // K and V strides of batch, head, row (elements)
  int T, H, G, Tk, BS;
  float scale2, sm_scale;
};

// rows [r0, r0 + n) of a row-strided (., D) matrix into dst[n][D + 1] as
// float32, zero at row r1 and past
template <int n, int D, int DT>
__device__ __forceinline__ void load_rows(float* dst,
                                          const typename Elem<DT>::T* src,
                                          long long stride, int r0, int r1) {
  constexpr int LD = D + 1;
  for (int idx = threadIdx.x; idx < n * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    dst[r * LD + c] =
        r0 + r < r1 ? Elem<DT>::load(src, (long long)(r0 + r) * stride + c)
                    : 0.f;
  }
}

template <int D>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(long long) * QT +
         sizeof(float) * (2 * KT * (D + 1) + 2 * QT * (D + 1) +
                          2 * KT * (QT + 1) + 3 * QT) +
         sizeof(int) * QT;
}

template <int BM, int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) *
         (2 * BM * (D + 1) + 2 * BN * (D + 1) + BM * (BN + 1) + 2 * BM);
}

// chunks[3 c .. 3 c + 2] = (segment, first entry, end entry); segment =
// (b H + h) NS + block; entries index tok and mult
template <int D, int DT>
__global__ void __launch_bounds__(kThreads)
nsa_bwd_dkdv(const Common p, const int* __restrict__ tok,
             const int* __restrict__ mult, const int* __restrict__ chunks,
             float* __restrict__ ws, int NS) {
  using T = typename Elem<DT>::T;
  constexpr int RN = KT / kTy;  // keys a thread
  constexpr int CQ = QT / kTx;  // rows a thread a step
  constexpr int CD = D / kTx;   // output columns a thread
  constexpr int LD = D + 1, LQ = QT + 1;
  extern __shared__ float smem[];
  // [QT], the row's (b, t, h, g) index into Q, dO, L, Delta (-1: pad)
  long long* Ro = reinterpret_cast<long long*>(smem);
  float* Ks = smem + 2 * QT;   // [KT][LD]
  float* Vs = Ks + KT * LD;    // [KT][LD]
  float* Qs = Vs + KT * LD;    // [QT][LD]
  float* dOs = Qs + QT * LD;   // [QT][LD]
  float* Pt = dOs + QT * LD;   // [KT][LQ], P^T
  float* dSt = Pt + KT * LQ;   // [KT][LQ], dS^T
  float* Ls = dSt + KT * LQ;   // [QT]
  float* Ds = Ls + QT;         // [QT]
  float* Ms = Ds + QT;         // [QT], the row's multiplicity (0: pad)
  int* Ts = reinterpret_cast<int*>(Ms + QT);  // [QT], the row's token

  const int ty = threadIdx.x / kTx, tx = threadIdx.x % kTx;
  const int c = blockIdx.x;
  const int seg = chunks[3 * c], e0 = chunks[3 * c + 1],
            e1 = chunks[3 * c + 2];
  const int blk = seg % NS, h = (seg / NS) % p.H, b = seg / (NS * p.H);
  const int kb = blk * p.BS;                // the block's first key
  const int j0 = kb + blockIdx.y * KT;      // this block's first key
  const int jend = min(kb + p.BS, p.Tk);    // past the KV block's last key
  const long long kv = b * p.sb + h * p.sh;

  load_rows<KT, D, DT>(Ks, static_cast<const T*>(p.k) + kv, p.sr, j0, jend);
  load_rows<KT, D, DT>(Vs, static_cast<const T*>(p.v) + kv, p.sr, j0, jend);

  float dk_acc[RN][CD], dv_acc[RN][CD];
#pragma unroll
  for (int a = 0; a < RN; ++a)
#pragma unroll
    for (int e = 0; e < CD; ++e) dk_acc[a][e] = dv_acc[a][e] = 0.f;

  const T* qg = static_cast<const T*>(p.q);
  const T* og = static_cast<const T*>(p.dout);
  const long long bh = (long long)b * p.T;
  const int rows = (e1 - e0) * p.G;  // (token, query head) rows, in order
  for (int r0 = 0; r0 < rows; r0 += QT) {
    __syncthreads();  // the previous step's readers are done
    // each row's token and index once, then Q and dO gathered by them
    for (int r = threadIdx.x; r < QT; r += kThreads) {
      const int rr = r0 + r;
      if (rr < rows) {
        const int e = e0 + rr / p.G, t = tok[e];
        const long long at = ((bh + t) * p.H + h) * p.G + rr % p.G;
        Ro[r] = at;
        Ls[r] = p.L[at];
        Ds[r] = p.Delta[at];
        Ms[r] = (float)mult[e];
        Ts[r] = t;
      } else {
        Ro[r] = -1;
        Ls[r] = Ds[r] = Ms[r] = 0.f;
        Ts[r] = -1;
      }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < QT * D; idx += kThreads) {
      const int r = idx / D, col = idx % D;
      const long long at = Ro[r];
      Qs[r * LD + col] = at >= 0 ? Elem<DT>::load(qg, at * D + col) : 0.f;
      dOs[r * LD + col] = at >= 0 ? Elem<DT>::load(og, at * D + col) : 0.f;
    }
    __syncthreads();

    // S^T (j, i) = K_j . Q_i and dP^T (j, i) = V_j . dO_i
    float st[RN][CQ], dpt[RN][CQ];
#pragma unroll
    for (int a = 0; a < RN; ++a)
#pragma unroll
      for (int cq = 0; cq < CQ; ++cq) st[a][cq] = dpt[a][cq] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float ka[RN], va[RN], qc[CQ], oc[CQ];
#pragma unroll
      for (int a = 0; a < RN; ++a) {
        ka[a] = Ks[(ty + kTy * a) * LD + d];
        va[a] = Vs[(ty + kTy * a) * LD + d];
      }
#pragma unroll
      for (int cq = 0; cq < CQ; ++cq) {
        qc[cq] = Qs[(tx + kTx * cq) * LD + d];
        oc[cq] = dOs[(tx + kTx * cq) * LD + d];
      }
#pragma unroll
      for (int a = 0; a < RN; ++a)
#pragma unroll
        for (int cq = 0; cq < CQ; ++cq) {
          st[a][cq] = fmaf(ka[a], qc[cq], st[a][cq]);
          dpt[a][cq] = fmaf(va[a], oc[cq], dpt[a][cq]);
        }
    }
#pragma unroll
    for (int a = 0; a < RN; ++a) {
      const int j = j0 + ty + kTy * a;
#pragma unroll
      for (int cq = 0; cq < CQ; ++cq) {
        const int ic = tx + kTx * cq;
        const bool live = Ms[ic] != 0.f && j < jend && j <= Ts[ic];
        // the multiplicity scales P before its rounding, and so dS
        const float pr =
            live ? exp2f(st[a][cq] * p.scale2 - Ls[ic]) * Ms[ic] : 0.f;
        const float ds = pr * (dpt[a][cq] - Ds[ic]) * p.sm_scale;
        Pt[(ty + kTy * a) * LQ + ic] = Elem<DT>::round(pr);
        dSt[(ty + kTy * a) * LQ + ic] = Elem<DT>::round(ds);
      }
    }
    __syncwarp();  // a key's P^T, dS^T row is written and read by its 8 lanes

#pragma unroll 4
    for (int i = 0; i < QT; ++i) {
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

  // this chunk's partial: rows of the KV block, dK then dV
  float* wk = ws + (long long)c * 2 * p.BS * D;
  float* wv = wk + (long long)p.BS * D;
#pragma unroll
  for (int a = 0; a < RN; ++a) {
    const int jl = blockIdx.y * KT + ty + kTy * a;  // key within the block
    if (kb + jl >= jend) continue;
#pragma unroll
    for (int e = 0; e < CD; ++e) {
      wk[(long long)jl * D + tx + kTx * e] = dk_acc[a][e];
      wv[(long long)jl * D + tx + kTx * e] = dv_acc[a][e];
    }
  }
}

// dK, dV element e (of n = B H NS BS D, segment-major) = the sum of its
// segment's chunk partials in chunk order; 0 for a block no token selects
__global__ void __launch_bounds__(kThreads)
nsa_bwd_dkdv_sum(const float* __restrict__ ws, const int* __restrict__ first,
                 float* __restrict__ dk, float* __restrict__ dv, long long n,
                 int per) {
  for (long long e = blockIdx.x * (long long)kThreads + threadIdx.x; e < n;
       e += (long long)gridDim.x * kThreads) {
    const long long seg = e / per, rem = e % per;
    float sk = 0.f, sv = 0.f;
    for (int c = first[seg]; c < first[seg + 1]; ++c) {
      const float* w = ws + (long long)c * 2 * per + rem;
      sk += w[0];
      sv += w[per];
    }
    dk[e] = sk;
    dv[e] = sv;
  }
}

template <int BM, int D, int DT>
__global__ void __launch_bounds__(kThreads)
nsa_bwd_dq(const Common p, const int* __restrict__ bi,
           const int* __restrict__ cnt, float* __restrict__ dq, int S) {
  using T = typename Elem<DT>::T;
  constexpr int RM = BM / kTy;  // query rows a thread
  constexpr int CN = BN / kTx;  // keys a thread a step
  constexpr int CD = D / kTx;   // output columns a thread
  constexpr int LD = D + 1, LP = BN + 1;
  extern __shared__ float smem[];
  float* Qs = smem;            // [BM][LD]
  float* dOs = Qs + BM * LD;   // [BM][LD]
  float* Ks = dOs + BM * LD;   // [BN][LD]
  float* Vs = Ks + BN * LD;    // [BN][LD]
  float* dSs = Vs + BN * LD;   // [BM][LP]
  float* Ls = dSs + BM * LP;   // [BM]
  float* Ds = Ls + BM;         // [BM]

  const int t = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / kTx, tx = threadIdx.x % kTx;
  const long long row = ((long long)b * p.T + t) * p.H + h;  // (b, t, h)
  const int hi = min(t + 1, p.Tk);  // the keys at most t
  const long long kv = b * p.sb + h * p.sh;
  const T* kg = static_cast<const T*>(p.k) + kv;
  const T* vg = static_cast<const T*>(p.v) + kv;

  load_tile<BM, D, DT>(Qs, static_cast<const T*>(p.q) + row * p.G * D, 0,
                       p.G);
  load_tile<BM, D, DT>(dOs, static_cast<const T*>(p.dout) + row * p.G * D,
                       0, p.G);
  load_vec<BM>(Ls, p.L + row * p.G, 0, p.G);
  load_vec<BM>(Ds, p.Delta + row * p.G, 0, p.G);

  float dq_acc[RM][CD];
#pragma unroll
  for (int a = 0; a < RM; ++a)
#pragma unroll
    for (int e = 0; e < CD; ++e) dq_acc[a][e] = 0.f;

  const int* ids = bi + row * S;
  const int n = min(cnt[row], S);
  for (int s = 0; s < n; ++s) {
    const int id = ids[s];
    const long long off = (long long)id * p.BS;
    if (id < 0 || off > t) continue;
    const int end = (int)min(off + p.BS, (long long)hi);
    for (int k0 = (int)off; k0 < end; k0 += BN) {
      __syncthreads();  // the previous tile is read before it is replaced
      load_rows<BN, D, DT>(Ks, kg, p.sr, k0, end);
      load_rows<BN, D, DT>(Vs, vg, p.sr, k0, end);
      __syncthreads();

      float sc[RM][CN], dp[RM][CN];
#pragma unroll
      for (int a = 0; a < RM; ++a)
#pragma unroll
        for (int cn = 0; cn < CN; ++cn) sc[a][cn] = dp[a][cn] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        float qa[RM], oa[RM], kc[CN], vc[CN];
#pragma unroll
        for (int a = 0; a < RM; ++a) {
          qa[a] = Qs[(ty + kTy * a) * LD + d];
          oa[a] = dOs[(ty + kTy * a) * LD + d];
        }
#pragma unroll
        for (int cn = 0; cn < CN; ++cn) {
          kc[cn] = Ks[(tx + kTx * cn) * LD + d];
          vc[cn] = Vs[(tx + kTx * cn) * LD + d];
        }
#pragma unroll
        for (int a = 0; a < RM; ++a)
#pragma unroll
          for (int cn = 0; cn < CN; ++cn) {
            sc[a][cn] = fmaf(qa[a], kc[cn], sc[a][cn]);
            dp[a][cn] = fmaf(oa[a], vc[cn], dp[a][cn]);
          }
      }
#pragma unroll
      for (int a = 0; a < RM; ++a) {
        const int ir = ty + kTy * a;
#pragma unroll
        for (int cn = 0; cn < CN; ++cn) {
          const bool live = ir < p.G && k0 + tx + kTx * cn < end;
          const float pr =
              live ? exp2f(sc[a][cn] * p.scale2 - Ls[ir]) : 0.f;
          const float ds = pr * (dp[a][cn] - Ds[ir]) * p.sm_scale;
          dSs[ir * LP + tx + kTx * cn] = Elem<DT>::round(ds);
        }
      }
      __syncwarp();  // a row's dS is written and read by its 8 lanes

#pragma unroll 4
      for (int j = 0; j < BN; ++j) {
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
  }

#pragma unroll
  for (int a = 0; a < RM; ++a) {
    const int ir = ty + kTy * a;
    if (ir >= p.G) continue;
    float* out = dq + (row * p.G + ir) * D;
#pragma unroll
    for (int e = 0; e < CD; ++e) out[tx + kTx * e] = dq_acc[a][e];
  }
}

// ---------------------------------------------------------------------------
// bfloat16 and float16: tensor cores (fragment helpers in attention_mma.cuh)
// ---------------------------------------------------------------------------

constexpr int kKeys = 64;     // dkdv_mma: keys a block, 16 a warp
constexpr int kChunk = 16;    // dq_mma: keys a step
constexpr int kDqStages = 2;  // dq_mma: chunks in a team's ring

// dkdv_mma: (token, query head) rows a step
template <int D>
constexpr int kRowsStep = D > 64 ? 32 : 64;

// K, V [kKeys][LD]; Q, dO [2][BM][LD]; L, Delta, multiplicity, token
// [2][BM] each
template <int D>
constexpr size_t dkdv_mma_smem_bytes() {
  return 2 * (size_t)(2 * kKeys + 4 * kRowsStep<D>) * (D + kPad) +
         4 * sizeof(float) * 2 * kRowsStep<D>;
}

// Q, dO [64][LD] (the teams' MT m16 tiles); K, V [kDqStages][4 / MT]
// [kChunk][LD]
template <int D, int MT>
constexpr size_t dq_mma_smem_bytes() {
  return 2 * (size_t)(2 * 64 + 2 * kDqStages * (4 / MT) * kChunk) *
         (D + kPad);
}

// chunks as nsa_bwd_dkdv's; grid (chunks, ceil(BS / kKeys))
template <int D, typename E>
__global__ void __launch_bounds__(kThreads)
nsa_bwd_dkdv_mma(const Common p, const int* __restrict__ tok,
                 const int* __restrict__ mult,
                 const int* __restrict__ chunks, float* __restrict__ ws,
                 int NS) {
  constexpr int BM = kRowsStep<D>;
  constexpr int LD = D + kPad;
  static_assert(D % 16 == 0 && (LD / 8) % 2 == 1, "unsupported head_dim");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* sK = reinterpret_cast<E*>(smem_raw);                  // [kKeys][LD]
  E* sV = sK + kKeys * LD;                                 // [kKeys][LD]
  E* sQ = sV + kKeys * LD;                                 // [2][BM][LD]
  E* sO = sQ + 2 * BM * LD;                                // dO [2][BM][LD]
  float* sL = reinterpret_cast<float*>(sO + 2 * BM * LD);  // [2][BM]
  float* sDe = sL + 2 * BM;                                // [2][BM]
  float* sM = sDe + 2 * BM;  // [2][BM], the row's multiplicity (0: pad)
  int* sT = reinterpret_cast<int*>(sM + 2 * BM);  // [2][BM], its token

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q2 = (lane % 4) * 2;
  const int c = blockIdx.x;
  const int seg = chunks[3 * c], e0 = chunks[3 * c + 1],
            e1 = chunks[3 * c + 2];
  const int blk = seg % NS, h = (seg / NS) % p.H, b = seg / (NS * p.H);
  const int kb = blk * p.BS;                // the KV block's first key
  const int j0 = kb + blockIdx.y * kKeys;   // this block's first key
  const int jend = min(kb + p.BS, p.Tk);    // past the KV block's last key
  const int kw = j0 + 16 * warp;            // the warp's first key
  const long long kv = b * p.sb + h * p.sh;
  const E* qg = static_cast<const E*>(p.q);
  const E* og = static_cast<const E*>(p.dout);
  const long long bt = (long long)b * p.T;
  const int rows = (e1 - e0) * p.G;  // (token, query head) rows, in order
  const int n_steps = (rows + BM - 1) / BM;

  // the (b, t, h, g) index of the chunk's row rr, -1 past its rows
  auto row_at = [&](int rr) -> long long {
    if (rr >= rows) return -1;
    return ((bt + tok[e0 + rr / p.G]) * p.H + h) * p.G + rr % p.G;
  };
  // step s's rows into stage s & 1
  auto issue = [&](int s) {
    const int st = s & 1, r0 = s * BM;
    issue_rows_at<BM, D>(sQ + st * BM * LD, qg, sO + st * BM * LD, og,
                         [&](int r) { return row_at(r0 + r); }, tid,
                         kThreads);
    if (tid < BM) {
      const int rr = r0 + tid, e = e0 + rr / p.G;
      const long long at = row_at(rr);
      const bool ok = at >= 0;
      cp_async4(sL + st * BM + tid, p.L + (ok ? at : 0), ok);
      cp_async4(sDe + st * BM + tid, p.Delta + (ok ? at : 0), ok);
      sM[st * BM + tid] = ok ? (float)mult[e] : 0.f;
      sT[st * BM + tid] = ok ? tok[e] : INT_MAX;
    }
  };
  const int jhi = min(j0 + kKeys, jend);
  issue_rows_strided<kKeys, D>(sK, static_cast<const E*>(p.k) + kv, p.sr,
                               j0, jhi, tid, kThreads);
  issue_rows_strided<kKeys, D>(sV, static_cast<const E*>(p.v) + kv, p.sr,
                               j0, jhi, tid, kThreads);
  if (n_steps > 0) issue(0);
  tl_gemm::cp_async_commit();

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  zero(dk_acc);
  zero(dv_acc);
  for (int s = 0; s < n_steps; ++s) {
    tl_gemm::cp_async_wait<0>();
    __syncthreads();  // step s landed; step s - 1's readers are done
    if (s + 1 < n_steps) issue(s + 1);
    tl_gemm::cp_async_commit();
    if (kw >= jend) continue;  // the warp's keys lie past the block
    const int st = s & 1;
    const E* tQ = sQ + st * BM * LD;
    const E* tO = sO + st * BM * LD;
    const float* tL = sL + st * BM;
    const float* tD = sDe + st * BM;
    const float* tM = sM + st * BM;
    const int* tT = sT + st * BM;

    // S^T (keys x rows) = K Q^T and dP^T = V dO^T
    float sc[BM / 8][4], dp[BM / 8][4];
    zero(sc);
    zero(dp);
    rows_dot_rows<D, BM>(sc, sK + 16 * warp * LD, tQ);
    rows_dot_rows<D, BM>(dp, sV + 16 * warp * LD, tO);

    // P^T (times the multiplicity, then rounded) and dS^T; the rows are in
    // token order, so only a step whose first token precedes the warp's
    // last key holds a row that must not see one of its keys
    const bool edge = tT[0] < kw + 15;
#pragma unroll
    for (int nt = 0; nt < BM / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ic = 8 * nt + q2 + (e & 1);
        float pr = exp2f(sc[nt][e] * p.scale2 - tL[ic]) * tM[ic];
        if (edge && kw + g + 8 * (e >> 1) > tT[ic]) pr = 0.f;
        sc[nt][e] = pr;
        dp[nt][e] = pr * (dp[nt][e] - tD[ic]) * p.sm_scale;
      }
    unsigned pa[BM / 16][4], sa[BM / 16][4];
    to_frags<BM, E>(pa, sc);
    to_frags<BM, E>(sa, dp);

    // dV += P^T dO, dK += dS^T Q
    frags_dot_tile<D, BM, E>(dv_acc, pa, tO);
    frags_dot_tile<D, BM, E>(dk_acc, sa, tQ);
  }
  tl_gemm::cp_async_wait<0>();

  // this chunk's partial: rows of the KV block, dK then dV
  float* wk = ws + (long long)c * 2 * p.BS * D;
  const int kl = blockIdx.y * kKeys + 16 * warp;  // the warp's first row
  store_rows<D>(wk, dk_acc, kl, jend - kb);
  store_rows<D>(wk + (long long)p.BS * D, dv_acc, kl, jend - kb);
}

// The key chunks of one token's selected blocks, in slot order: each slot
// s < n with id = ids[s] >= 0 and off = id * BS <= t gives the keys [off,
// min(off + BS, hi)), cut into chunks of at most kChunk keys (nsa.cu's
// walk without the window). The next slot's id is loaded a slot ahead.
struct KeyChunks {
  const int* ids;
  int s, n, BS, t, hi;
  int r, end;  // the current range's next key and its end
  int id;      // ids[s] while s < n

  __device__ __forceinline__ KeyChunks(const int* ids_, int n_, int BS_,
                                       int t_, int hi_)
      : ids(ids_), s(0), n(n_), BS(BS_), t(t_), hi(hi_), r(0), end(0),
        id(n_ > 0 ? ids_[0] : -1) {}

  // the next chunk [x, y), or x == y once there is none
  __device__ __forceinline__ int2 next() {
    while (r >= end) {
      if (s >= n) return make_int2(0, 0);
      const int cur = id;
      if (++s < n) id = ids[s];
      const long long off = (long long)cur * BS;
      if (cur < 0 || off > t) continue;
      r = (int)off;
      end = (int)min(off + BS, (long long)hi);
    }
    const int x = r;
    r = min(r + kChunk, end);
    return make_int2(x, r);
  }
};

// Team (warp / MT) takes token t = blockIdx.x (4 / MT) + team; its warp
// mt the group's rows 16 mt .. 16 mt + 15. The team's ring: stage j of
// kDqStages holds its chunk j, copied by the team's own threads, the
// range in rng[team][j]; MT 1 syncs the warp, MT 4 the block.
template <int D, typename E, int MT>
__global__ void __launch_bounds__(kThreads)
nsa_bwd_dq_mma(const Common p, const int* __restrict__ bi,
               const int* __restrict__ cnt, float* __restrict__ dq, int S) {
  constexpr int TEAMS = 4 / MT, TN = 32 * MT, LD = D + kPad;
  constexpr int CS = kChunk * LD;
  static_assert(D % 16 == 0 && (LD / 8) % 2 == 1, "unsupported head_dim");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int2 rng[TEAMS][kDqStages];
  E* sQ = reinterpret_cast<E*>(smem_raw);   // [64][LD], team at 16 MT team
  E* sO = sQ + 64 * LD;                     // dO [64][LD]
  E* sK = sO + 64 * LD;                     // [kDqStages][TEAMS][kChunk][LD]
  E* sV = sK + kDqStages * TEAMS * CS;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int team = warp / MT, mt = warp % MT, ttid = tid % TN;
  const int mat = lane / 8, mr = lane % 8, g = lane / 4, q2 = (lane % 4) * 2;
  const int h = blockIdx.y, b = blockIdx.z;
  const int t = blockIdx.x * TEAMS + team;
  const bool live = t < p.T;  // a token past T computes nothing stored
  const long long row = ((long long)b * p.T + t) * p.H + h;  // (b, t, h)
  const long long kv = b * p.sb + h * p.sh;
  const E* kg = static_cast<const E*>(p.k) + kv;
  const E* vg = static_cast<const E*>(p.v) + kv;
  const E* qg = static_cast<const E*>(p.q);
  const E* og = static_cast<const E*>(p.dout);
  auto team_sync = [] {
    if constexpr (MT == 1)
      __syncwarp();
    else
      __syncthreads();
  };

  // the team's rows, zero past G (all zero for a token past T): the
  // oldest cp.async group
  E* tq = sQ + 16 * MT * team * LD;
  E* to = sO + 16 * MT * team * LD;
  issue_rows_strided<16 * MT, D>(tq, live ? qg + row * p.G * D : qg, D, 0,
                                 live ? p.G : 0, ttid, TN);
  issue_rows_strided<16 * MT, D>(to, live ? og + row * p.G * D : og, D, 0,
                                 live ? p.G : 0, ttid, TN);
  tl_gemm::cp_async_commit();
  float lr[2], dr[2];  // L and Delta of the lane's rows g, g + 8
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = 16 * mt + g + 8 * hh;
    const bool ok = live && i < p.G;
    lr[hh] = ok ? p.L[row * p.G + i] : 0.f;
    dr[hh] = ok ? p.Delta[row * p.G + i] : 0.f;
  }

  KeyChunks ch(live ? bi + row * S : nullptr, live ? min(cnt[row], S) : 0,
               p.BS, t, min(t + 1, p.Tk));
  int queued = 0;  // chunks issued, a prefix of the ring's stages
  auto issue = [&](int j) {
    const int st = j % kDqStages;
    const int2 r = ch.next();
    if (ttid == 0) rng[team][st] = r;
    if (r.y > r.x) {
      ++queued;
      issue_rows_strided<kChunk, D>(sK + (st * TEAMS + team) * CS, kg, p.sr,
                                    r.x, r.y, ttid, TN);
      issue_rows_strided<kChunk, D>(sV + (st * TEAMS + team) * CS, vg, p.sr,
                                    r.x, r.y, ttid, TN);
    }
    tl_gemm::cp_async_commit();
  };
#pragma unroll 1
  for (int j = 0; j < kDqStages - 1; ++j) issue(j);
  tl_gemm::cp_async_wait<kDqStages - 1>();
  team_sync();  // the rows landed
  unsigned qf[D / 16][4], of[D / 16][4];
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    const int at =
        (16 * mt + mr + 8 * (mat % 2)) * LD + 16 * kd + 8 * (mat / 2);
    mma16::ldmatrix_x4(qf[kd], tq + at);
    mma16::ldmatrix_x4(of[kd], to + at);
  }

  float acc[D / 8][4];
  zero(acc);
#pragma unroll 1
  for (int j = 0; j < queued; ++j) {
    tl_gemm::cp_async_wait<kDqStages - 2>();
    team_sync();  // chunk j landed; chunk j - 1 read by the team
    issue(j + kDqStages - 1);
    const int st = j % kDqStages;
    const int2 r = rng[team][st];
    const E* tK = sK + (st * TEAMS + team) * CS;
    const E* tV = sV + (st * TEAMS + team) * CS;

    // S = Q K^T and dP = dO V^T from the held fragments
    float s[2][4], dp[2][4];
    zero(s);
    zero(dp);
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      const int at = (mr + 8 * (mat / 2)) * LD + 16 * kd + 8 * (mat % 2);
      unsigned kr[4];
      mma16::ldmatrix_x4(kr, tK + at);
      mma16::mma<E>(s[0], qf[kd], kr[0], kr[1]);
      mma16::mma<E>(s[1], qf[kd], kr[2], kr[3]);
      mma16::ldmatrix_x4(kr, tV + at);
      mma16::mma<E>(dp[0], of[kd], kr[0], kr[1]);
      mma16::mma<E>(dp[1], of[kd], kr[2], kr[3]);
    }

    // dS, the keys past the chunk (a block's or the causal bound's edge)
    // masked
    const bool edge = r.y - r.x < kChunk;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pr = exp2f(s[nt][e] * p.scale2 - lr[e >> 1]);
        if (edge && r.x + 8 * nt + q2 + (e & 1) >= r.y) pr = 0.f;
        dp[nt][e] = pr * (dp[nt][e] - dr[e >> 1]) * p.sm_scale;
      }
    unsigned da[1][4];
    to_frags<16, E>(da, dp);

    // dQ += dS K
    frags_dot_tile<D, 16, E>(acc, da, tK);
  }
  tl_gemm::cp_async_wait<0>();
  if (live) store_rows<D>(dq + row * p.G * D, acc, 16 * mt, p.G);
}

// ---------------------------------------------------------------------------
// launch: float32 on the CUDA-core kernels, 16 bits on the tensor cores
// ---------------------------------------------------------------------------

template <int D>
int run_dkdv(const Common& p, int dt, const int* tok, const int* mult,
             const int* chunks, float* ws, int n_chunks, int NS,
             cudaStream_t st) {
  const dim3 grid32(n_chunks, (p.BS + KT - 1) / KT);
  const dim3 grid64(n_chunks, (p.BS + kKeys - 1) / kKeys);
  switch (dt) {
    case kF32:
      return launch(nsa_bwd_dkdv<D, kF32>, grid32, dkdv_smem_bytes<D>(), st,
                    p, tok, mult, chunks, ws, NS);
    case kBF16:
      return launch(nsa_bwd_dkdv_mma<D, __nv_bfloat16>, grid64,
                    dkdv_mma_smem_bytes<D>(), st, p, tok, mult, chunks, ws,
                    NS);
    case kF16:
      return launch(nsa_bwd_dkdv_mma<D, __half>, grid64,
                    dkdv_mma_smem_bytes<D>(), st, p, tok, mult, chunks, ws,
                    NS);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int D, typename E>
int run_dq_mma(const Common& p, const int* bi, const int* cnt, float* dq,
               int B, int S, cudaStream_t st) {
  if (p.G <= 16)
    return launch(nsa_bwd_dq_mma<D, E, 1>, dim3((p.T + 3) / 4, p.H, B),
                  dq_mma_smem_bytes<D, 1>(), st, p, bi, cnt, dq, S);
  return launch(nsa_bwd_dq_mma<D, E, 4>, dim3(p.T, p.H, B),
                dq_mma_smem_bytes<D, 4>(), st, p, bi, cnt, dq, S);
}

template <int D>
int run_dq(const Common& p, int dt, const int* bi, const int* cnt,
           float* dq, int B, int S, cudaStream_t st) {
  const dim3 grid(p.T, p.H, B);
  switch (dt) {
    case kF32:
      return p.G <= 16
                 ? launch(nsa_bwd_dq<16, D, kF32>, grid,
                          dq_smem_bytes<16, D>(), st, p, bi, cnt, dq, S)
                 : launch(nsa_bwd_dq<64, D, kF32>, grid,
                          dq_smem_bytes<64, D>(), st, p, bi, cnt, dq, S);
    case kBF16:
      return run_dq_mma<D, __nv_bfloat16>(p, bi, cnt, dq, B, S, st);
    case kF16:
      return run_dq_mma<D, __half>(p, bi, cnt, dq, B, S, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

#define TL_HEAD_DIMS(X) X(16) X(32) X(64) X(128)

}  // namespace

// Each launches on `stream` and returns the first CUDA error (0 =
// launched), or cudaErrorInvalidValue for a head_dim or type without an
// instance, or a group of more than 64 query heads (dq). `scale2` is
// sm_scale * log2(e); sb, sh, sr are K's and V's strides (elements). The
// Python wrappers check shapes, types and contiguity, and build the chunk
// tables, before calling.

// one chunk's partial dK, dV a (chunk, key tile: 32 keys in float32, 64
// in 16 bits): ws (n_chunks, 2, BS, D)
extern "C" int tl_nsa_bwd_dkdv(const void* q, const void* k, const void* v,
                               const void* dout, const void* L,
                               const void* Delta, const void* tok,
                               const void* mult, const void* chunks,
                               void* ws, int n_chunks, int T, int H, int G,
                               int Tk, int D, int NS, int BS, long long sb,
                               long long sh, long long sr, int dt,
                               float scale2, float sm_scale, void* stream) {
  const Common p{q, k, v, dout, static_cast<const float*>(L),
                 static_cast<const float*>(Delta), sb, sh, sr, T, H, G, Tk,
                 BS, scale2, sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ti = static_cast<const int*>(tok);
  const int* mi = static_cast<const int*>(mult);
  const int* ci = static_cast<const int*>(chunks);
  float* w = static_cast<float*>(ws);
  if (n_chunks < 1 || G < 1 || BS < 1 || NS < 1)
    return static_cast<int>(cudaErrorInvalidValue);
#define TL_CASE(DIM) \
  case DIM:          \
    return run_dkdv<DIM>(p, dt, ti, mi, ci, w, n_chunks, NS, st);
  switch (D) {
    TL_HEAD_DIMS(TL_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TL_CASE
}

// dK, dV (B, H, NS BS, D) float32: each block's chunk partials summed in
// chunk order; `first` (n_seg + 1) holds each segment's first chunk
extern "C" int tl_nsa_bwd_dkdv_sum(const void* ws, const void* first,
                                   void* dk, void* dv, int n_seg, int BS,
                                   int D, void* stream) {
  const long long n = (long long)n_seg * BS * D;
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long want = (n + kThreads - 1) / kThreads;
  const dim3 grid((unsigned)(want < 132 * 16 ? want : 132 * 16));
  return launch(nsa_bwd_dkdv_sum, grid, 0,
                static_cast<cudaStream_t>(stream),
                static_cast<const float*>(ws),
                static_cast<const int*>(first), static_cast<float*>(dk),
                static_cast<float*>(dv), n, BS * D);
}

// dQ (B, T, H, G, D) float32
extern "C" int tl_nsa_bwd_dq(const void* q, const void* k, const void* v,
                             const void* dout, const void* L,
                             const void* Delta, const void* bi,
                             const void* cnt, void* dq, int B, int T, int H,
                             int G, int Tk, int D, int S, int BS,
                             long long sb, long long sh, long long sr, int dt,
                             float scale2, float sm_scale, void* stream) {
  const Common p{q, k, v, dout, static_cast<const float*>(L),
                 static_cast<const float*>(Delta), sb, sh, sr, T, H, G, Tk,
                 BS, scale2, sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* b = static_cast<const int*>(bi);
  const int* c = static_cast<const int*>(cnt);
  float* o = static_cast<float*>(dq);
  if (G < 1 || G > 64 || BS < 1 || S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
#define TL_CASE(DIM) \
  case DIM:          \
    return run_dq<DIM>(p, dt, b, c, o, B, S, st);
  switch (D) {
    TL_HEAD_DIMS(TL_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TL_CASE
}
