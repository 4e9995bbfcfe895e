// Native Sparse Attention (DeepSeek NSA) forwards: the fused forward, the
// packed varlen forward, decode and the training partial, for Hopper
// (sm_90a).
//
// Replaces four TPU kernels of tilelang_mesh_tpu/ops/nsa.py, which share
// the selected-branch gather _nsa_selected_prelude (:42-75); here they
// share one kernel body, nsa_fwd, and its gather attend_keys:
//   nsa_fwd_kernel (:79)          -> tl_nsa_fwd
//   nsa_fwd_partial_kernel (:127) -> tl_nsa_fwd_partial
//   nsa_varlen_fwd_kernel (:245)  -> tl_nsa_varlen_fwd
//   nsa_decode_kernel (:334)      -> tl_nsa_decode
// Same contract:
//   Q, O (B, T, H, G, D) in float32, bfloat16 or float16 (`dt`:
//   attention_common.cuh's codes), contiguous: the G = HQ / H query
//   heads of KV head h are one group. K, V (B, H, Tk, D) of Q's type, as
//   a strided view: element (b, h, r, d) at b sb + h sh + r sr + d (the
//   wrappers pass the (B, Tk, H, D) layout without a copy). BI (B, T, H,
//   S) int32, Cnt (B, T, H) int32, Gslc, Gswa (B, T, H, G) float32.
//   Token t of the group attends
//   - the selected branch: for each slot s < min(Cnt, S) with id =
//     BI[s] >= 0 and off = id * BS (the raw row offset id, varlen) at
//     most t, the keys off + j, j < BS, with off + j <= t; gated by Gslc;
//   - the window branch (window > 0, the fused forward): the keys
//     (t - window, t]; gated by Gswa,
//   each an online softmax in the exp2 domain (S = float(Q K^T) * scale,
//   scale = sm_scale * log2(e); ops/_online_softmax.py:39, P rounded to
//   the input type), normalised as acc / max(l, 1e-30), so a branch
//   that sees no key adds 0 (:103, :119). O = the gated sum, rounded to
//   the input type once.
//   The partial forward is the selected branch alone, without gates: it
//   writes the unnormalised float32 acc (B, T, H, G, D) and the exp2
//   statistics m (floored at -1e30) and l (B, T, H, G) instead of O, so
//   a row that sees no key has l = 0 (the backward kernels' residuals,
//   ops/nsa_bwd.py).
//   Decode is T = 1 with the causal bound Tk - 1 for its one token
//   (:337): Q, O (B, H, G, D), BI (B, H, S), Cnt (B, H), Gslc (B, H, G).
//   Varlen is B = 1 with raw packed row offsets: packed order is
//   position order, so the causal bound off + j <= t also keeps every
//   key inside the token's own sequence (:246-253).
// Every key read is also below Tk. The TPU kernel copies a whole block
// of BS rows from off, which on a ragged tail (Tk not a multiple of BS)
// runs past Tk and reads other rows (the JAX package's kernel then
// differs from its reference); the reference masks by position, and so
// does this kernel. Varlen therefore needs no zero block padded onto K
// and V.
//
// Bound: operations. A token's group does 4 * D flops per visible key
// and query head (S and P @ V): at the NSA paper's widths (G 16, 16
// selected blocks of 64, window 512, D 128) about 1.5k keys a token,
// against K and V of 16 MB that every token reuses.
//
// Design: one block of 128 threads per (token, KV head, batch), the TPU
// grid (:95). The group's G query rows, padded with zero rows to the row
// tile BM (16, or 64 for G up to 64), stay in shared memory (attend_tile
// gives one row to each `ty` at BM 16); the pad rows compute a softmax
// of their own that is never stored. Each branch walks its key ranges in
// tiles of 32 rows gathered from K and V into shared memory (zero past
// the range), each tile one attend_tile step, so a selected block of 64
// keys is two tiles; a tile wholly past the causal bound is not loaded.
// No tensor cores yet: this is the simple, exact version. Decode has B H
// blocks, too few to fill the card's 132 SMs at small batches.

#include "attention_tile.cuh"

namespace {

using namespace tl_attn;

constexpr int BN = 32;  // keys per tile

struct Args {
  const void *q, *k, *v;
  void* o;
  const int *bi, *cnt;
  const float *gs, *gw;
  long long sb, sh, sr;  // K and V strides of batch, head, row (elements)
  int T, H, G, Tk, S, BS, window, raw, t_fix;
  float scale;
};

// rows [r0, r0 + BN) of a row-strided (., D) matrix into dst[BN][D + 1]
// as float32, zero at row r1 and past
template <int D, int DT>
__device__ __forceinline__ void load_rows(float* dst,
                                          const typename Elem<DT>::T* src,
                                          long long stride, int r0, int r1) {
  constexpr int LD = D + 1;
  for (int idx = threadIdx.x; idx < BN * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    dst[r * LD + c] =
        r0 + r < r1 ? Elem<DT>::load(src, (r0 + r) * stride + c) : 0.f;
  }
}

// One online softmax over the keys [lo, hi) of one head (the gather both
// branches share): tiles of BN rows of K and V, each an attend_tile step.
template <int BM, int D, int DT>
__device__ __forceinline__ void attend_keys(
    const typename Elem<DT>::T* kg, const typename Elem<DT>::T* vg,
    long long sr, int lo, int hi, const float* Qs, float* Ks, float* Vs,
    float* Ps, float scale, float (&m)[BM / kTy], float (&l)[BM / kTy],
    float (&acc)[BM / kTy][D / kTx]) {
  const int tx = threadIdx.x % kTx;
  for (int k0 = lo; k0 < hi; k0 += BN) {
    __syncthreads();  // the previous tile is read before it is replaced
    load_rows<D, DT>(Ks, kg, sr, k0, hi);
    load_rows<D, DT>(Vs, vg, sr, k0, hi);
    __syncthreads();
    attend_tile<BM, BN, D, DT>(
        Qs, Ks, Vs, Ps, scale,
        [&](int, int c) { return k0 + tx + kTx * c < hi; }, m, l, acc);
  }
}

template <int BM, int D>
__device__ __forceinline__ void reset(float (&m)[BM / kTy],
                                      float (&l)[BM / kTy],
                                      float (&acc)[BM / kTy][D / kTx]) {
#pragma unroll
  for (int a = 0; a < BM / kTy; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.f;
#pragma unroll
    for (int e = 0; e < D / kTx; ++e) acc[a][e] = 0.f;
  }
}

// PARTIAL: the training partial, writing acc, m, l through o, gs, gw (it
// has no gates): instances of their own, so that the fused forward's
// code and Args stay as they were (a partial branch and three more Args
// fields cost the fused forward 5 %: scripts/nsa_ab.py)
template <int BM, int D, int DT, bool PARTIAL>
__global__ void __launch_bounds__(kThreads) nsa_fwd(const Args a) {
  using T = typename Elem<DT>::T;
  constexpr int RM = BM / kTy;  // query rows per thread
  constexpr int CD = D / kTx;   // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;               // [BM][D + 1]
  float* Ks = Qs + BM * (D + 1);  // [BN][D + 1]
  float* Vs = Ks + BN * (D + 1);  // [BN][D + 1]
  float* Ps = Vs + BN * (D + 1);  // [BM][BN + 1]

  const int t = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / kTx, tx = threadIdx.x % kTx;
  const long long row = ((long long)b * a.T + t) * a.H + h;  // (b, t, h)
  const int tpos = a.t_fix >= 0 ? a.t_fix : t;   // the causal bound
  const int hi = min(tpos + 1, a.Tk);            // keys below it
  const T* kg = static_cast<const T*>(a.k) + b * a.sb + h * a.sh;
  const T* vg = static_cast<const T*>(a.v) + b * a.sb + h * a.sh;

  load_tile<BM, D, DT>(Qs, static_cast<const T*>(a.q) + row * a.G * D, 0,
                       a.G);

  float m[RM], l[RM], acc[RM][CD], out[RM][CD];
  reset<BM, D>(m, l, acc);

  // the selected branch
  const int* ids = a.bi + row * a.S;
  const int n = min(a.cnt[row], a.S);
  for (int s = 0; s < n; ++s) {
    const int id = ids[s];
    const long long off = a.raw ? (long long)id : (long long)id * a.BS;
    if (id < 0 || off > tpos) continue;
    attend_keys<BM, D, DT>(kg, vg, a.sr, (int)off,
                           (int)min(off + a.BS, (long long)hi), Qs, Ks, Vs,
                           Ps, a.scale, m, l, acc);
  }
  if constexpr (PARTIAL) {  // no gate, no window
    float* pacc = static_cast<float*>(a.o);
    float* pm = const_cast<float*>(a.gs);
    float* pl = const_cast<float*>(a.gw);
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int i = ty + kTy * r;
      if (i >= a.G) continue;
      const long long gi = row * a.G + i;
#pragma unroll
      for (int e = 0; e < CD; ++e) pacc[gi * D + tx + kTx * e] = acc[r][e];
      if (tx == 0) {
        pm[gi] = fmaxf(m[r], -1e30f);
        pl[gi] = l[r];
      }
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int i = ty + kTy * r;
    const float g = i < a.G ? a.gs[row * a.G + i] : 0.f;
#pragma unroll
    for (int e = 0; e < CD; ++e) out[r][e] = acc[r][e] / fmaxf(l[r], 1e-30f) * g;
  }

  // the window branch
  if (a.window > 0) {
    reset<BM, D>(m, l, acc);
    attend_keys<BM, D, DT>(kg, vg, a.sr, max(0, t - a.window + 1), hi, Qs,
                           Ks, Vs, Ps, a.scale, m, l, acc);
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int i = ty + kTy * r;
      const float g = i < a.G ? a.gw[row * a.G + i] : 0.f;
#pragma unroll
      for (int e = 0; e < CD; ++e)
        out[r][e] += acc[r][e] / fmaxf(l[r], 1e-30f) * g;
    }
  }

  T* o = static_cast<T*>(a.o) + row * a.G * D;
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int i = ty + kTy * r;
    if (i >= a.G) continue;
#pragma unroll
    for (int e = 0; e < CD; ++e)
      Elem<DT>::store(o, (long long)i * D + tx + kTx * e, out[r][e]);
  }
}

template <int BM, int D, int DT, bool PARTIAL>
int run(const Args& a, int B, cudaStream_t st) {
  const dim3 grid(a.T, a.H, B);
  return launch(nsa_fwd<BM, D, DT, PARTIAL>, grid,
                tile_smem_bytes<BM, BN, D>(), st, a);
}

template <int D>
int dispatch(int dt, const Args& a, int B, bool partial, cudaStream_t st) {
  return with_elem(dt, [&](auto e) {
    constexpr int DT = decltype(e)::value;
    if (partial)
      return a.G <= 16 ? run<16, D, DT, true>(a, B, st)
                       : run<64, D, DT, true>(a, B, st);
    return a.G <= 16 ? run<16, D, DT, false>(a, B, st)
                     : run<64, D, DT, false>(a, B, st);
  });
}

int go(const Args& a, int B, int D, int dt, void* stream,
       bool partial = false) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.G < 1 || a.G > 64 || a.BS < 1 || a.S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 16:
      return dispatch<16>(dt, a, B, partial, st);
    case 32:
      return dispatch<32>(dt, a, B, partial, st);
    case 64:
      return dispatch<64>(dt, a, B, partial, st);
    case 128:
      return dispatch<128>(dt, a, B, partial, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Each launches on `stream` and returns the first CUDA error (0 =
// launched), or cudaErrorInvalidValue for a head_dim or type without an
// instance or a group of more than 64 query heads. `scale` is sm_scale *
// log2(e); sb, sh, sr are K's and V's strides (elements). The Python
// wrappers check shapes, types and contiguity before calling.

// the fused forward: Q, O (B, T, H, G, D); window <= 0 means none
extern "C" int tl_nsa_fwd(const void* q, const void* k, const void* v,
                          const void* bi, const void* cnt, const void* gs,
                          const void* gw, void* o, int B, int T, int H, int G,
                          int Tk, int D, int S, int BS, int window,
                          long long sb, long long sh, long long sr, int dt,
                          float scale, void* stream) {
  const Args a{q, k, v, o, static_cast<const int*>(bi),
               static_cast<const int*>(cnt), static_cast<const float*>(gs),
               static_cast<const float*>(gw), sb, sh, sr, T, H, G, Tk, S, BS,
               window, 0, -1, scale};
  return go(a, B, D, dt, stream);
}

// packed tokens: Q, O (1, T, H, G, D); BI holds raw packed row offsets
extern "C" int tl_nsa_varlen_fwd(const void* q, const void* k, const void* v,
                                 const void* offs, const void* cnt,
                                 const void* gs, void* o, int T, int H, int G,
                                 int Tk, int D, int S, int BS, long long sh,
                                 long long sr, int dt, float scale,
                                 void* stream) {
  const Args a{q, k, v, o, static_cast<const int*>(offs),
               static_cast<const int*>(cnt), static_cast<const float*>(gs),
               static_cast<const float*>(gs), 0, sh, sr, T, H, G, Tk, S, BS,
               0, 1, -1, scale};
  return go(a, 1, D, dt, stream);
}

// the training partial: acc (B, T, H, G, D), m, l (B, T, H, G) float32
extern "C" int tl_nsa_fwd_partial(const void* q, const void* k, const void* v,
                                  const void* bi, const void* cnt,
                                  void* acc, void* m, void* l, int B, int T,
                                  int H, int G, int Tk, int D, int S, int BS,
                                  long long sb, long long sh, long long sr,
                                  int dt, float scale, void* stream) {
  const Args a{q, k, v, acc, static_cast<const int*>(bi),
               static_cast<const int*>(cnt), static_cast<const float*>(m),
               static_cast<const float*>(l), sb, sh, sr, T, H, G, Tk, S, BS,
               0, 0, -1, scale};
  return go(a, B, D, dt, stream, true);
}

// one token: Q, O (B, H, G, D), causal bound Tk - 1
extern "C" int tl_nsa_decode(const void* q, const void* k, const void* v,
                             const void* bi, const void* cnt, const void* gs,
                             void* o, int B, int H, int G, int Tk, int D,
                             int S, int BS, long long sb, long long sh,
                             long long sr, int dt, float scale,
                             void* stream) {
  const Args a{q, k, v, o, static_cast<const int*>(bi),
               static_cast<const int*>(cnt), static_cast<const float*>(gs),
               static_cast<const float*>(gs), sb, sh, sr, 1, H, G, Tk, S, BS,
               0, 0, Tk - 1, scale};
  return go(a, B, D, dt, stream);
}
