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
// flops (S, dP, dV, dK) and dQ 6 * D (S, dP, dQ).
//
// Design.
// * dkdv. The TPU kernel gives each (KV block, KV head, batch) one
//   program that sweeps all T tokens in order, gated by Mask: no atomics
//   on the TPU. On the card that grid is badly unbalanced when many
//   tokens select one block (NSA's selections always include block 0:
//   its program would sweep every token while the rest sit idle). Here
//   the wrapper compacts Mask into per-(batch, head, block) lists of
//   (token, multiplicity), in token order, and cuts each list into chunks
//   of a fixed number of tokens; one block of 128 threads takes (chunk,
//   32-key tile of the block). It keeps its K and V tile in shared memory
//   and its dK, dV rows in registers, and walks the chunk's (token, query
//   head) rows 32 at a time: gathers Q and dO, forms S^T and dP^T (2 keys
//   x 4 rows a thread), P and dS, and accumulates dV += P^T dO and dK +=
//   dS^T Q (gqa_bwd.cu's step). Each chunk writes its float32 partial
//   once to a workspace (chunks, 2, BS, D); tl_nsa_bwd_dkdv_sum then adds
//   each block's partials in chunk order into dK and dV. No atomics:
//   every element is written once, in a fixed order, so two runs give the
//   same bits.
// * dq. One block per (token, KV head, batch), the TPU grid (:125), as
//   nsa.cu's forward: the group's G query rows padded with zero rows to
//   the row tile BM (16, or 64 for G up to 64), Q and dO in shared memory,
//   the selected blocks walked in tiles of 32 keys; each tile forms S and
//   dP (per thread BM/16 rows x 4 keys), writes dS to a shared tile only
//   its own warp reads, and accumulates dQ += dS K in registers.
// Float32 CUDA-core FMAs throughout; tensor cores are later work.

#include "attention_common.cuh"

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

template <int D, int DT>
int run_dkdv(const Common& p, const int* tok, const int* mult,
             const int* chunks, float* ws, int n_chunks, int NS,
             cudaStream_t st) {
  const dim3 grid(n_chunks, (p.BS + KT - 1) / KT);
  return launch(nsa_bwd_dkdv<D, DT>, grid, dkdv_smem_bytes<D>(), st, p, tok,
                mult, chunks, ws, NS);
}

template <int BM, int D, int DT>
int run_dq(const Common& p, const int* bi, const int* cnt, float* dq, int B,
           int S, cudaStream_t st) {
  const dim3 grid(p.T, p.H, B);
  return launch(nsa_bwd_dq<BM, D, DT>, grid, dq_smem_bytes<BM, D>(), st, p,
                bi, cnt, dq, S);
}

#define TL_HEAD_DIMS(X) X(16) X(32) X(64) X(128)

}  // namespace

// Each launches on `stream` and returns the first CUDA error (0 =
// launched), or cudaErrorInvalidValue for a head_dim or type without an
// instance, or a group of more than 64 query heads (dq). `scale2` is
// sm_scale * log2(e); sb, sh, sr are K's and V's strides (elements). The
// Python wrappers check shapes, types and contiguity, and build the chunk
// tables, before calling.

// one chunk's partial dK, dV a (chunk, 32-key tile): ws (n_chunks, 2, BS, D)
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
#define TL_CASE(DIM)                                                    \
  case DIM:                                                             \
    return with_elem(dt, [&](auto e) {                                  \
      return run_dkdv<DIM, decltype(e)::value>(p, ti, mi, ci, w,        \
                                               n_chunks, NS, st);       \
    });
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
#define TL_CASE(DIM)                                                    \
  case DIM:                                                             \
    return with_elem(dt, [&](auto e) {                                  \
      constexpr int DT = decltype(e)::value;                            \
      return G <= 16 ? run_dq<16, DIM, DT>(p, b, c, o, B, S, st)        \
                     : run_dq<64, DIM, DT>(p, b, c, o, B, S, st);       \
    });
  switch (D) {
    TL_HEAD_DIMS(TL_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TL_CASE
}
