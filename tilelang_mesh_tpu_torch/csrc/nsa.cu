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
//   (:337): Q (B, H, G, D), BI (B, H, S), Cnt (B, H), Gslc (B, H, G). It
//   runs in two launches: tl_nsa_decode splits each row's S slots into
//   `splits` runs of ceil(S / splits) and writes each run's partial
//   (acc, m, l), as the partial forward's, to a float32 workspace
//   (B, H, splits, G[, D]); tl_nsa_decode_combine merges a row's splits
//   in split order, m = max, acc and l summed at exp2(m_x - m), and
//   writes O (B, H, G, D) = gate * acc / max(l, 1e-30) in Q's type. A
//   split with no live slot has m = -1e30, l = 0 and weighs nothing.
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
// Bound: operations in float32, bytes in 16 bits. A token's group does
// 4 * D flops per visible key and query head (S and P @ V): at the NSA
// paper's widths (G 16, 16 selected blocks of 64, window 512, D 128)
// about 1.5k keys a token, against K and V of 16 MB that every token
// reuses. The 16-bit kernels are held by their gathers instead: each
// token's group reads its ~1.5k keys' K and V rows again, mostly from
// L2, and does only 16 query rows of work with each.
//
// Design, float32 (nsa_fwd): one block of 128 threads per (token, KV
// head, batch), the TPU grid (:95). The group's G query rows, padded
// with zero rows to the row tile BM (16, or 64 for G up to 64), stay in
// shared memory (attend_tile gives one row to each `ty` at BM 16); the
// pad rows compute a softmax of their own that is never stored. Each
// branch walks its key ranges in tiles of 32 rows gathered from K and V
// into shared memory (zero past the range), each tile one attend_tile
// step, so a selected block of 64 keys is two tiles; a tile wholly past
// the causal bound is not loaded. CUDA cores, exact: the simple version.
//
// Design, bfloat16 and float16: the tensor cores (mma.sync m16n8k16,
// float32 sums), on two kernels. A branch's keys are cut into chunks of
// kChunk keys, never across a selected block, in slot order, and come by
// cp.async, 16 bytes a copy, straight from the strided K and V views,
// stages of chunks in flight while earlier ones multiply. S = Q K^T reads
// K by ldmatrix, P stays in registers as the A fragments of P V
// (to_frags, rounded to the input type), V by ldmatrix.trans
// (attend_chunk). The group's rows, zero-padded, are one m16 tile for G
// up to 16.
// - nsa_fwd_tok_mma, the fused, varlen and partial forwards at G up to
//   16: a block of kTokens consecutive tokens, a warp a token. The window
//   branch (the fused forward) copies the tokens' common window once for
//   all four, so its loads fall by nearly 4x; the selected branch runs a
//   pipeline of the warp's own (no block barrier, no merge).
// - nsa_fwd_mma, decode's splits and groups of 17 to 64: a block a
//   token (a split), the group's MT m16 tiles (MT 1, or 4); chunk i goes
//   to key stream i % KS (KS = 4 / MT), the four warps are (tile, stream)
//   pairs with their own online softmax, KS chunks a stage copied by the
//   block, and the streams of a tile merge through shared memory in
//   stream order at the end.
// Every result is deterministic. Decode's splits (above) give B H splits
// blocks, as many as the card holds at once.

#include <climits>

#include "attention_mma.cuh"
#include "attention_tile.cuh"

namespace {

using namespace tl_attn;

constexpr int BN = 32;  // keys per tile (float32)

struct Args {
  const void *q, *k, *v;
  void* o;
  const int *bi, *cnt;
  const float *gs, *gw;
  long long sb, sh, sr;  // K and V strides of batch, head, row (elements)
  // window: the fused forward's window; the partial instances have none
  // and read this field as a decode split's slots, through split_slots
  // only (one field less keeps the f32 fused forward's registers)
  int T, H, G, Tk, S, BS, window, raw, t_fix;
  float scale;
};

// the slots of a decode split (blockIdx.x the split) in a partial
// instance, 0 for no split: tl_nsa_decode sets it, go() picks the
// instance by it, nsa_fwd and nsa_fwd_mma run their split by it
template <bool PARTIAL>
__host__ __device__ __forceinline__ int split_slots(const Args& a) {
  return PARTIAL ? a.window : 0;
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

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

// PARTIAL: the training partial or a decode split (a.window > 0), writing
// acc, m, l through o, gs, gw (it has no gates): instances of their own,
// so that the fused forward's code and Args stay as they were (a partial
// branch and three more Args fields cost the fused forward 5 %:
// scripts/nsa_ab.py)
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

  const int slots = split_slots<PARTIAL>(a);
  const bool split = slots > 0;
  const int t = split ? 0 : blockIdx.x, h = blockIdx.y, b = blockIdx.z;
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

  // the selected branch (a decode split: its run of slots)
  const int* ids = a.bi + row * a.S;
  const int n = min(a.cnt[row], a.S);
  const int s0 = split ? blockIdx.x * slots : 0;
  const int s1 = split ? min(n, s0 + slots) : n;
  for (int s = s0; s < s1; ++s) {
    const int id = ids[s];
    const long long off = a.raw ? (long long)id : (long long)id * a.BS;
    if (id < 0 || off > tpos) continue;
    attend_keys<BM, D, DT>(kg, vg, a.sr, (int)off,
                           (int)min(off + a.BS, (long long)hi), Qs, Ks, Vs,
                           Ps, a.scale, m, l, acc);
  }
  if constexpr (PARTIAL) {  // no gate, no window
    const long long orow = split ? row * gridDim.x + blockIdx.x : row;
    float* pacc = static_cast<float*>(a.o);
    float* pm = const_cast<float*>(a.gs);
    float* pl = const_cast<float*>(a.gw);
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int i = ty + kTy * r;
      if (i >= a.G) continue;
      const long long gi = orow * a.G + i;
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

// ---------------------------------------------------------------------------
// bfloat16 and float16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kChunk = 16;  // keys a warp takes at a time
constexpr int kStages = 3;  // sets of KS chunks in flight

// Q [16 MT][LD]; K and V [kStages][KS][kChunk][LD] each
template <int D, int MT>
constexpr size_t mma_smem_bytes() {
  return 2 * (size_t)(16 * MT + 2 * kStages * (4 / MT) * kChunk) *
         (D + kPad);
}

// The key chunks of one branch, in order: each valid slot in [s, s1) of
// `ids` (id >= 0 and its first key off = id * BS, or id itself when
// raw, at most tpos) gives the keys [off, min(off + BS, hi)), and the
// window (ids null) its one range [r, end); each range is cut into
// chunks of at most kChunk keys. Every thread of a block walks the same
// chunks. The next slot's id is loaded a slot ahead, so that issuing a
// stage does not wait on it.
struct Chunks {
  const int* ids;
  int s, s1, BS, raw, tpos, hi;
  int r, end;  // the current range's next key and its end
  int id;      // ids[s] while s < s1

  __device__ __forceinline__ Chunks(const int* ids_, int s_, int s1_,
                                    int BS_, int raw_, int tpos_, int hi_,
                                    int r_, int end_)
      : ids(ids_), s(s_), s1(s1_), BS(BS_), raw(raw_), tpos(tpos_),
        hi(hi_), r(r_), end(end_),
        id(ids_ != nullptr && s_ < s1_ ? ids_[s_] : -1) {}

  // the next chunk [x, y), or x == y once there is none
  __device__ __forceinline__ int2 next() {
    while (r >= end) {
      if (ids == nullptr || s >= s1) return make_int2(0, 0);
      const int cur = id;
      if (++s < s1) id = ids[s];
      const long long off = raw ? (long long)cur : (long long)cur * BS;
      if (cur < 0 || off > tpos) continue;
      r = (int)off;
      end = (int)min(off + BS, (long long)hi);
    }
    const int x = r;
    r = min(r + kChunk, end);
    return make_int2(x, r);
  }
};

// the weight of a state whose max is m under the merged max mx (a state
// that saw no key, m = -inf, weighs nothing)
__device__ __forceinline__ float weight(float m, float mx) {
  return m == -INFINITY ? 0.f : exp2f(m - mx);
}

// One chunk of kChunk keys k0 + j at tK, tV into the warp's online
// softmax over the m16 tile at q16 (row-padded as the stages), keys
// outside [lo, hi) masked: S = Q K^T on two n8 tiles, exp2-domain
// scores, the -1e30 floor (a row that has seen only masked keys stays
// finite), P rounded to E as the A fragments of P V.
template <int D, typename E>
__device__ __forceinline__ void attend_chunk(const E* q16, const E* tK,
                                             const E* tV, int k0, int lo,
                                             int hi, float scale,
                                             float (&m)[2], float (&l)[2],
                                             float (&acc)[D / 8][4]) {
  constexpr int LD = D + kPad;
  const int lane = threadIdx.x % 32;
  const int mat = lane / 8, mr = lane % 8, q2 = (lane % 4) * 2;
  float s[2][4];
  zero(s);
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    unsigned qa[4], kb[4];
    mma16::ldmatrix_x4(qa, q16 + (mr + 8 * (mat % 2)) * LD + 16 * kd +
                               8 * (mat / 2));
    mma16::ldmatrix_x4(kb, tK + (mr + 8 * (mat / 2)) * LD + 16 * kd +
                               8 * (mat % 2));
    mma16::mma<E>(s[0], qa, kb[0], kb[1]);
    mma16::mma<E>(s[1], qa, kb[2], kb[3]);
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = k0 + 8 * nt + q2 + (e & 1);
      s[nt][e] = j >= lo && j < hi ? s[nt][e] * scale : -INFINITY;
    }
  float alpha[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float mx = fmaxf(fmaxf(s[0][2 * h], s[0][2 * h + 1]),
                           fmaxf(s[1][2 * h], s[1][2 * h + 1]));
    const float m_new = fmaxf(m[h], fmaxf(quad_max(mx), -1e30f));
    alpha[h] = exp2f(m[h] - m_new);
    m[h] = m_new;
    float rsum = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float p = exp2f(s[nt][2 * h + c] - m_new);
        s[nt][2 * h + c] = p;
        rsum += p;
      }
    l[h] = l[h] * alpha[h] + rsum;
  }
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] *= alpha[e >> 1];
  unsigned pa[1][4];
  to_frags<16, E>(pa, s);
  frags_dot_tile<D, 16, E>(acc, pa, tV);
}

template <int D>
__device__ __forceinline__ void reset(float (&m)[2], float (&l)[2],
                                      float (&acc)[D / 8][4]) {
  m[0] = m[1] = -INFINITY;
  l[0] = l[1] = 0.f;
  zero(acc);
}

// One branch's online softmax over the chunks of `ch` on the tensor
// cores, a block's pipeline of NS stages: stage j holds the next KS
// chunks (buffer j % NS, their ranges in rs), copied by every thread. Q
// holds MT m16 tiles. Without SHARE (MT KS = 4) the warp (tile mt,
// stream ks) takes chunks ks, ks + KS, ...; at the end the KS streams of
// a tile merge, in stream order, into stream 0's warp, whose (m, l, acc)
// then hold the tile's rows g and g + 8. With SHARE (MT 4: a tile a
// warp) every warp takes every chunk, its keys outside [lo, hi) masked,
// and keeps its own state. l is summed over the quad. Every thread
// calls it; it returns with every copy landed and the stage area free.
template <int D, typename E, int MT, int KS, bool SHARE, int NS = kStages>
__device__ __forceinline__ void walk(Chunks ch, const E* sQ, E* sK, E* sV,
                                     int2 (*rs)[KS], const E* kg,
                                     const E* vg, long long sr, float scale,
                                     int lo, int hi, float (&m)[2],
                                     float (&l)[2], float (&acc)[D / 8][4]) {
  static_assert(SHARE ? MT == 4 : MT * KS == 4, "four warps");
  constexpr int LD = D + kPad, CS = kChunk * LD;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int mt = warp % MT, ks = SHARE ? 0 : warp / MT;
  const int g = lane / 4, q2 = (lane % 4) * 2;
  const E* q16 = sQ + 16 * mt * LD;
  reset<D>(m, l, acc);

  // `live` counts the stages that hold a chunk, a prefix of them
  int live = 0;
  auto issue = [&](int j) {
    const int st = j % NS;
    bool any = false;
#pragma unroll
    for (int w = 0; w < KS; ++w) {
      const int2 r = ch.next();
      if (threadIdx.x == 0) rs[st][w] = r;
      if (r.y > r.x) {
        any = true;
        issue_rows_strided<kChunk, D>(sK + (st * KS + w) * CS, kg, sr, r.x,
                                      r.y, threadIdx.x, kThreads);
        issue_rows_strided<kChunk, D>(sV + (st * KS + w) * CS, vg, sr, r.x,
                                      r.y, threadIdx.x, kThreads);
      }
    }
    tl_gemm::cp_async_commit();
    live += any;
  };

#pragma unroll 1
  for (int j = 0; j < NS - 1; ++j) issue(j);
#pragma unroll 1
  for (int j = 0; j < live; ++j) {
    tl_gemm::cp_async_wait<NS - 2>();
    __syncthreads();  // stage j landed; stage j - 1's readers are done
    issue(j + NS - 1);
    const int st = j % NS;
#pragma unroll
    for (int w = SHARE ? 0 : ks; w < (SHARE ? KS : ks + 1); ++w) {
      const int2 r = rs[st][w];
      // a warp-uniform skip: no chunk, or none of its keys this warp's
      if (r.y <= r.x || r.x >= hi || r.y <= lo) continue;
      attend_chunk<D, E>(q16, sK + (st * KS + w) * CS,
                         sV + (st * KS + w) * CS, r.x, max(r.x, lo),
                         min(r.y, hi), scale, m, l, acc);
    }
  }
  tl_gemm::cp_async_wait<0>();
  __syncthreads();  // every chunk read: the stage area is free

  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  if constexpr (!SHARE && KS > 1) {
    // streams 1.. through the stage area: acc [KS][MT][16][D], m, l
    float* xa = reinterpret_cast<float*>(sK);
    float* xm = xa + KS * MT * 16 * D;
    float* xl = xm + KS * MT * 16;
    if (ks > 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int at = (ks * MT + mt) * 16 + g + 8 * h;
        float* row = xa + (long long)at * D + q2;
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt)
          *reinterpret_cast<float2*>(row + 8 * nt) =
              make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
        if (q2 == 0) {
          xm[at] = m[h];
          xl[at] = l[h];
        }
      }
    }
    __syncthreads();
    if (ks == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mf = m[h];
#pragma unroll
        for (int w = 1; w < KS; ++w)
          mf = fmaxf(mf, xm[(w * MT + mt) * 16 + g + 8 * h]);
        float c = weight(m[h], mf);
        l[h] *= c;
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt) {
          acc[nt][2 * h] *= c;
          acc[nt][2 * h + 1] *= c;
        }
#pragma unroll
        for (int w = 1; w < KS; ++w) {
          const int at = (w * MT + mt) * 16 + g + 8 * h;
          c = weight(xm[at], mf);
          l[h] += xl[at] * c;
          const float* row = xa + (long long)at * D + q2;
#pragma unroll
          for (int nt = 0; nt < D / 8; ++nt) {
            const float2 y = *reinterpret_cast<const float2*>(row + 8 * nt);
            acc[nt][2 * h] += y.x * c;
            acc[nt][2 * h + 1] += y.y * c;
          }
        }
        m[h] = mf;
      }
    }
    __syncthreads();  // the merge is read before the area is reused
  }
}

// One branch's online softmax over the chunks of `ch`, a warp's own
// pipeline: its stages are slot `warp` of each of the block's NS
// stages, copied by its lanes, their ranges in rw[NS]; only __syncwarp.
template <int D, typename E, int NS = kStages>
__device__ __forceinline__ void walk_own(Chunks ch, const E* q16, E* sK,
                                         E* sV, int2* rw, const E* kg,
                                         const E* vg, long long sr,
                                         float scale, float (&m)[2],
                                         float (&l)[2],
                                         float (&acc)[D / 8][4]) {
  constexpr int CS = kChunk * (D + kPad);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  reset<D>(m, l, acc);
  int live = 0;
  auto issue = [&](int j) {
    const int st = j % NS;
    const int2 r = ch.next();
    if (lane == 0) rw[st] = r;
    if (r.y > r.x) {
      ++live;
      issue_rows_strided<kChunk, D>(sK + (st * 4 + warp) * CS, kg, sr, r.x,
                                    r.y, lane, 32);
      issue_rows_strided<kChunk, D>(sV + (st * 4 + warp) * CS, vg, sr, r.x,
                                    r.y, lane, 32);
    }
    tl_gemm::cp_async_commit();
  };
#pragma unroll 1
  for (int j = 0; j < NS - 1; ++j) issue(j);
#pragma unroll 1
  for (int j = 0; j < live; ++j) {
    tl_gemm::cp_async_wait<NS - 2>();
    __syncwarp();  // stage j landed; stage j - 1 read by every lane
    issue(j + NS - 1);
    const int st = j % NS;
    const int2 r = rw[st];
    attend_chunk<D, E>(q16, sK + (st * 4 + warp) * CS,
                       sV + (st * 4 + warp) * CS, r.x, r.x, r.y, scale, m, l,
                       acc);
  }
  tl_gemm::cp_async_wait<0>();
  __syncwarp();
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
}

// out (+)= gate * acc / max(l, 1e-30) on the tile's rows g, g + 8
template <int D>
__device__ __forceinline__ void gated(float (&out)[D / 8][4],
                                      const float (&acc)[D / 8][4],
                                      const float (&l)[2], const float* gate,
                                      int r0, int G, bool add) {
  const int g = (threadIdx.x % 32) / 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = r0 + g + 8 * h;
    const float gv = i < G ? gate[i] : 0.f;
    const float den = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float y = acc[nt][2 * h + c] / den * gv;
        out[nt][2 * h + c] = add ? out[nt][2 * h + c] + y : y;
      }
  }
}

// the partial's outputs of a tile's rows r0 + g, r0 + g + 8 below G:
// acc at row `orow` (in rows of D) of a.o, m (floored at -1e30) and l
// through a.gs, a.gw
template <int D>
__device__ __forceinline__ void store_partial(const Args& a, long long orow,
                                              int r0,
                                              const float (&acc)[D / 8][4],
                                              const float (&m)[2],
                                              const float (&l)[2]) {
  const int g = (threadIdx.x % 32) / 4, q2 = (threadIdx.x % 4) * 2;
  store_rows<D>(static_cast<float*>(a.o) + orow * D, acc, r0, a.G);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = r0 + g + 8 * h;
    if (q2 == 0 && i < a.G) {
      const_cast<float*>(a.gs)[orow + i] = fmaxf(m[h], -1e30f);
      const_cast<float*>(a.gw)[orow + i] = l[h];
    }
  }
}

// out rounded to E into rows r0 + g, r0 + g + 8 below G of o (G, D)
template <int D, typename E>
__device__ __forceinline__ void store_out(E* o, const float (&out)[D / 8][4],
                                          int r0, int G) {
  const int g = (threadIdx.x % 32) / 4, q2 = (threadIdx.x % 4) * 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = r0 + g + 8 * h;
    if (i >= G) continue;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<unsigned*>(o + (long long)i * D + 8 * nt + q2) =
          pack2<E>(out[nt][2 * h], out[nt][2 * h + 1]);
  }
}

// PARTIAL as nsa_fwd's: the training partial or a decode split
template <int D, typename E, int MT, bool PARTIAL>
__global__ void __launch_bounds__(kThreads) nsa_fwd_mma(const Args a) {
  constexpr int KS = 4 / MT, LD = D + kPad;
  static_assert(D % 16 == 0 && (LD / 8) % 2 == 1, "unsupported head_dim");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int2 rs[kStages][KS];
  E* sQ = reinterpret_cast<E*>(smem_raw);  // [16 MT][LD]
  E* sK = sQ + 16 * MT * LD;               // [kStages][KS][kChunk][LD]
  E* sV = sK + kStages * KS * kChunk * LD;

  const int slots = split_slots<PARTIAL>(a);
  const bool split = slots > 0;
  const int t = split ? 0 : blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const long long row = ((long long)b * a.T + t) * a.H + h;  // (b, t, h)
  const int tpos = a.t_fix >= 0 ? a.t_fix : t;   // the causal bound
  const int hi = min(tpos + 1, a.Tk);            // keys below it
  const E* kg = static_cast<const E*>(a.k) + b * a.sb + h * a.sh;
  const E* vg = static_cast<const E*>(a.v) + b * a.sb + h * a.sh;
  const int warp = threadIdx.x / 32, mt = warp % MT, ks = warp / MT;

  // the group's rows, zero past G: the oldest cp.async group, landed
  // before a walk reads its first chunk
  issue_rows<16 * MT, D>(sQ, static_cast<const E*>(a.q) + row * a.G * D, 0,
                         a.G);
  tl_gemm::cp_async_commit();

  // the selected branch (a decode split: its run of slots)
  const int n = min(a.cnt[row], a.S);
  const int s0 = split ? blockIdx.x * slots : 0;
  float m[2], l[2], acc[D / 8][4];
  walk<D, E, MT, KS, false>(
      Chunks(a.bi + row * a.S, s0, split ? min(n, s0 + slots) : n, a.BS,
             a.raw, tpos, hi, 0, 0),
      sQ, sK, sV, rs, kg, vg, a.sr, a.scale, INT_MIN, INT_MAX, m, l, acc);

  if constexpr (PARTIAL) {  // no gate, no window
    if (ks == 0)
      store_partial<D>(
          a, (split ? row * gridDim.x + blockIdx.x : row) * a.G, 16 * mt,
          acc, m, l);
    return;
  }
  float out[D / 8][4];
  gated<D>(out, acc, l, a.gs + row * a.G, 16 * mt, a.G, false);

  // the window branch
  if (a.window > 0) {
    walk<D, E, MT, KS, false>(
        Chunks(nullptr, 0, 0, a.BS, 0, tpos, hi, max(0, t - a.window + 1),
               hi),
        sQ, sK, sV, rs, kg, vg, a.sr, a.scale, INT_MIN, INT_MAX, m, l, acc);
    gated<D>(out, acc, l, a.gw + row * a.G, 16 * mt, a.G, true);
  }

  if (ks == 0)
    store_out<D, E>(static_cast<E*>(a.o) + row * a.G * D, out, 16 * mt, a.G);
}

// ---------------------------------------------------------------------------
// the forwards of many tokens at groups of up to 16: a warp a token, the
// window's loads shared
// ---------------------------------------------------------------------------

constexpr int kTokens = 4;     // consecutive tokens a block, one a warp
constexpr int kTokStages = 2;  // two blocks an SM at D 128

// Q [kTokens][16][LD]; K and V [kTokStages][4][kChunk][LD] each
template <int D>
constexpr size_t tok_smem_bytes() {
  return 2 * (size_t)(16 * kTokens + 2 * kTokStages * 4 * kChunk) *
         (D + kPad);
}

// Block (t0 / kTokens, h, b), warp w the token t = t0 + w (its group's
// rows one m16 tile): the fused forward (varlen too) or the training
// partial (PARTIAL; no decode split). The window branch first: the
// tokens' windows are one range but for kTokens - 1 keys at each end,
// so the block copies their union once, four chunks a stage (walk with
// SHARE), and each warp takes every chunk under its own token's bounds.
// Then the selected branch: each warp walks its own token's chunks in
// its own pipeline (walk_own), no merge, and adds (the two gated terms
// commute: O is the sum nsa_fwd_mma forms, rounded once).
template <int D, typename E, bool PARTIAL>
__global__ void __launch_bounds__(kThreads) nsa_fwd_tok_mma(const Args a) {
  constexpr int LD = D + kPad;
  static_assert(D % 16 == 0 && (LD / 8) % 2 == 1, "unsupported head_dim");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int2 rs[kTokStages][4];
  __shared__ int2 rw[kTokens][kTokStages];
  E* sQ = reinterpret_cast<E*>(smem_raw);  // [kTokens][16][LD]
  E* sK = sQ + 16 * kTokens * LD;          // [kTokStages][4][kChunk][LD]
  E* sV = sK + kTokStages * 4 * kChunk * LD;

  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int t0 = blockIdx.x * kTokens, t = t0 + warp;
  const bool live = t < a.T;  // a token past T computes nothing stored
  const long long row = ((long long)b * a.T + t) * a.H + h;  // (b, t, h)
  const E* kg = static_cast<const E*>(a.k) + b * a.sb + h * a.sh;
  const E* vg = static_cast<const E*>(a.v) + b * a.sb + h * a.sh;
  const E* q = static_cast<const E*>(a.q);

  // the warp's token's rows, zero past G (all zero for a token past T),
  // copied by the warp's own lanes: only that warp reads them, after its
  // lanes' waits (walk_own's __syncwarp, or walk's __syncthreads)
  issue_rows_strided<16, D>(sQ + 16 * warp * LD, live ? q + row * a.G * D : q,
                            D, 0, live ? a.G : 0, threadIdx.x % 32, 32);
  tl_gemm::cp_async_commit();

  // the window branch over the union (t0 - window, last token]
  float m[2], l[2], acc[D / 8][4], out[D / 8][4];
  const bool window = !PARTIAL && a.window > 0;
  if (window) {
    const int last = min(t0 + kTokens, a.T) - 1;
    walk<D, E, kTokens, 4, true, kTokStages>(
        Chunks(nullptr, 0, 0, a.BS, 0, 0, 0, max(0, t0 - a.window + 1),
               min(last + 1, a.Tk)),
        sQ, sK, sV, rs, kg, vg, a.sr, a.scale,
        live ? max(0, t - a.window + 1) : 0, live ? min(t + 1, a.Tk) : 0, m,
        l, acc);
    gated<D>(out, acc, l, a.gw + row * a.G, 0, live ? a.G : 0, false);
  }

  // the selected branch, each warp its own token's
  const int n = live ? min(a.cnt[row], a.S) : 0;
  walk_own<D, E, kTokStages>(
      Chunks(live ? a.bi + row * a.S : nullptr, 0, n, a.BS, a.raw, t,
             live ? min(t + 1, a.Tk) : 0, 0, 0),
      sQ + 16 * warp * LD, sK, sV, rw[warp], kg, vg, a.sr, a.scale, m, l,
      acc);
  if (!live) return;
  if constexpr (PARTIAL) {  // no gate
    store_partial<D>(a, row * a.G, 0, acc, m, l);
    return;
  }
  gated<D>(out, acc, l, a.gs + row * a.G, 0, a.G, window);
  store_out<D, E>(static_cast<E*>(a.o) + row * a.G * D, out, 0, a.G);
}

// ---------------------------------------------------------------------------
// decode: the fixed-order combine of the splits
// ---------------------------------------------------------------------------

// O = gate * sum_x acc_x w_x / max(sum_x l_x w_x, 1e-30), w_x =
// exp2(m_x - max m), summed in split order: one thread an element of
// (b, h) = blockIdx.y's (G, D) rows, the splits' loads unrolled so that
// several are in flight
template <int DT>
__global__ void __launch_bounds__(kThreads)
    nsa_decode_combine(const float* __restrict__ acc,
                       const float* __restrict__ pm,
                       const float* __restrict__ pl,
                       const float* __restrict__ gs, void* o, int G, int D,
                       int splits) {
  const long long bh = blockIdx.y;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= G * D) return;
  const int i = idx / D, c = idx % D;
  const float* m = pm + bh * splits * G + i;
  const float* l = pl + bh * splits * G + i;
  const float* ac = acc + (bh * splits * G + i) * D + c;
  float mx = -INFINITY;
#pragma unroll 8
  for (int x = 0; x < splits; ++x) mx = fmaxf(mx, m[x * G]);
  float num = 0.f, den = 0.f;
#pragma unroll 8
  for (int x = 0; x < splits; ++x) {
    const float w = weight(m[x * G], mx);
    num += ac[(long long)x * G * D] * w;
    den += l[x * G] * w;
  }
  Elem<DT>::store(static_cast<typename Elem<DT>::T*>(o), (bh * G + i) * D + c,
                  num / fmaxf(den, 1e-30f) * gs[bh * G + i]);
}

// ---------------------------------------------------------------------------
// instances and launch
// ---------------------------------------------------------------------------

struct Instance {
  void (*fn)(const Args);
  size_t smem;
  int tokens;  // tokens (or decode splits) a block
};

// 16-bit: many tokens at a group of up to 16 take a warp each
// (nsa_fwd_tok_mma); decode's splits and larger groups walk one token's
// keys with the four warps (nsa_fwd_mma)
template <int D, int DT, bool PARTIAL>
Instance instance(int G, bool split) {
  if constexpr (DT == kF32) {
    if (G <= 16)
      return {nsa_fwd<16, D, DT, PARTIAL>, tile_smem_bytes<16, BN, D>(), 1};
    return {nsa_fwd<64, D, DT, PARTIAL>, tile_smem_bytes<64, BN, D>(), 1};
  } else {
    using E = typename Elem<DT>::T;
    if (G <= 16 && !split)
      return {nsa_fwd_tok_mma<D, E, PARTIAL>, tok_smem_bytes<D>(), kTokens};
    if (G > 16)
      return {nsa_fwd_mma<D, E, 4, PARTIAL>, mma_smem_bytes<D, 4>(), 1};
    if constexpr (PARTIAL)
      return {nsa_fwd_mma<D, E, 1, true>, mma_smem_bytes<D, 1>(), 1};
    return {nullptr, 0, 1};
  }
}

template <int D>
Instance by_type(int dt, int G, bool partial, bool split) {
  switch (dt) {
    case kF32:
      return partial ? instance<D, kF32, true>(G, split)
                     : instance<D, kF32, false>(G, split);
    case kBF16:
      return partial ? instance<D, kBF16, true>(G, split)
                     : instance<D, kBF16, false>(G, split);
    case kF16:
      return partial ? instance<D, kF16, true>(G, split)
                     : instance<D, kF16, false>(G, split);
    default:
      return {nullptr, 0, 1};
  }
}

// the kernel of (D, type, group, partial, a decode split); fn null for
// none
Instance find(int D, int dt, int G, bool partial, bool split) {
  if (G < 1 || G > 64) return {nullptr, 0, 1};
  switch (D) {
    case 16:
      return by_type<16>(dt, G, partial, split);
    case 32:
      return by_type<32>(dt, G, partial, split);
    case 64:
      return by_type<64>(dt, G, partial, split);
    case 128:
      return by_type<128>(dt, G, partial, split);
    default:
      return {nullptr, 0, 1};
  }
}

// grid (gx / tokens a block, H, B): gx the tokens, or the decode splits
int go(const Args& a, int B, int D, int dt, int gx, void* stream,
       bool partial = false) {
  const Instance in =
      find(D, dt, a.G, partial, partial && split_slots<true>(a) > 0);
  if (in.fn == nullptr || a.BS < 1 || a.S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(in.fn, dim3((gx + in.tokens - 1) / in.tokens, a.H, B),
                in.smem, static_cast<cudaStream_t>(stream), a);
}

}  // namespace

// Each launches on `stream` and returns the first CUDA error (0 =
// launched), or cudaErrorInvalidValue for a head_dim or type without an
// instance or a group of more than 64 query heads. `scale` is sm_scale *
// log2(e); sb, sh, sr are K's and V's strides (elements). The Python
// wrappers check shapes, types, contiguity and (16-bit types) 16-byte
// alignment before calling.

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
  return go(a, B, D, dt, T, stream);
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
  return go(a, 1, D, dt, T, stream);
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
  return go(a, B, D, dt, T, stream, true);
}

// one token, causal bound Tk - 1, its slots in `splits` runs of
// ceil(S / splits): Q (B, H, G, D); each run's partial to acc (B, H,
// splits, G, D), m, l (B, H, splits, G) float32
extern "C" int tl_nsa_decode(const void* q, const void* k, const void* v,
                             const void* bi, const void* cnt, void* acc,
                             void* m, void* l, int B, int H, int G, int Tk,
                             int D, int S, int BS, int splits, long long sb,
                             long long sh, long long sr, int dt, float scale,
                             void* stream) {
  if (splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, acc, static_cast<const int*>(bi),
               static_cast<const int*>(cnt), static_cast<const float*>(m),
               static_cast<const float*>(l), sb, sh, sr, 1, H, G, Tk, S, BS,
               max(1, (S + splits - 1) / splits), 0, Tk - 1, scale};
  return go(a, B, D, dt, splits, stream, true);
}

// decode's second launch: O (BH, G, D) in the type `dt` from tl_nsa_decode's
// partials (BH = B H) and the gates Gslc (BH, G)
extern "C" int tl_nsa_decode_combine(const void* acc, const void* m,
                                     const void* l, const void* gs, void* o,
                                     int BH, int G, int D, int splits,
                                     int dt, void* stream) {
  if (BH < 1 || G < 1 || D < 1 || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return with_elem(dt, [&](auto e) {
    return launch(nsa_decode_combine<decltype(e)::value>,
                  dim3((G * D + kThreads - 1) / kThreads, BH), 0,
                  static_cast<cudaStream_t>(stream),
                  static_cast<const float*>(acc), static_cast<const float*>(m),
                  static_cast<const float*>(l), static_cast<const float*>(gs),
                  o, G, D, splits);
  });
}

// blocks of tl_nsa_decode's kernel for (G, D, dt) that an SM holds at once
// (the wrapper sizes its splits by it)
extern "C" int tl_nsa_decode_blocks_per_sm(int G, int D, int dt,
                                           int* blocks) {
  const Instance in = find(D, dt, G, true, true);
  if (in.fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      in.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)in.smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, in.fn,
                                                        kThreads, in.smem);
  return static_cast<int>(err);
}
