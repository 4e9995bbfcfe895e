// Causal / full multi-head and grouped-query attention forward, for
// Hopper (sm_90a).
//
// Replaces four TPU kernels, two of tilelang_mesh_tpu/ops/flash_attention.py
// and two of tilelang_mesh_tpu/ops/gqa.py, which share one loop:
//   _mha_fwd_kernel (:71)          -> tl_mha_fwd(Hkv = H, partial = 0)
//   _mha_fwd_partial_kernel (:124) -> tl_mha_fwd(Hkv = H, partial = 1)
//   gqa_fwd_kernel (:21)           -> tl_mha_fwd(Hkv | H, partial = 0)
//   gqa_fwd_partial_kernel (:63)   -> tl_mha_fwd(Hkv | H, partial = 1)
// Same contract:
//   Q (B, H, Sq, D), K, V (B, Hkv, Sk, D) float32 or bfloat16,
//   contiguous; query head h reads KV head h / (H / Hkv), so MHA is
//   Hkv = H (the same addresses as before KV heads were added)
//   Q is prescaled once: Qs = dtype(float(Q) * scale), scale =
//   sm_scale * log2(e), so every score is already in the exp2 domain.
//   Causal masking is top-left (query i sees keys j <= i); KV tiles
//   wholly above the diagonal are skipped, only diagonal tiles masked.
//   Online softmax per KV tile (ops/_online_softmax.py:39):
//     m_new = max(m, rowmax(S), -1e30); p = exp2(S - m_new)
//     l = l * exp2(m - m_new) + rowsum(p); acc = acc * exp2(m - m_new)
//     + dtype(p) @ V
//   partial = 0: O (B, H, Sq, D) in the input type, acc / max(l, 1e-30)
//   partial = 1: O float32 unnormalised acc, M and L (B, H, Sq) float32.
//
// Bound: operations. A causal (Sq, Sk) head does 4 * D flops per visible
// (i, j) pair against 2 * S * D elements read, far above the card's
// balance point at S = 4096, so the least time is the flops over the
// float32 rate (67 TFLOP/s outside the tensor cores; the float32
// contract rules out TF32).
//
// Design: one block of 128 threads per (64-query tile, head, batch), the
// TPU grid (ceil(Sq/BM), H, B) with its sequential KV axis turned into a
// loop inside the block. The prescaled Q tile stays in shared memory;
// each 32-key tile of K and V is loaded into shared memory (float32,
// odd row stride, zero past Sk), every thread computes a 4 x 4 block of
// scores with CUDA-core FMAs, masks the ragged edge (j >= Sk) and the
// diagonal, updates its rows' (m, l) with 8-lane shuffles, writes its
// probabilities (rounded to the input type, as the TPU kernel's P) to a
// shared tile that only its own warp reads, and accumulates its 4 rows x
// D/8 columns of P @ V in registers. Any Sq, Sk >= 1 works: query rows
// past Sq are computed on zeros and never stored. Under GQA the blocks
// of a group's H / Hkv query heads each load the same K and V tiles (the
// repeats come from L2; the TPU kernel's BlockSpec fetches them per
// head alike). No tensor cores yet
// (wgmma/TMA are later work): this is the simple, exact version.

#include "attention_common.cuh"

namespace {

using namespace tl_attn;

constexpr int BM = 64;  // query rows per block
constexpr int BN = 32;  // keys per tile

template <int D>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * (BM * (D + 1) + 2 * BN * (D + 1) + BM * (BN + 1));
}

template <int D, bool BF16, bool PARTIAL>
__global__ void __launch_bounds__(kThreads)
mha_fwd(const typename Elem<BF16>::T* __restrict__ q,
        const typename Elem<BF16>::T* __restrict__ k,
        const typename Elem<BF16>::T* __restrict__ v, void* __restrict__ o,
        float* __restrict__ m_out, float* __restrict__ l_out, int H,
        int group, int Sq, int Sk, int causal, float scale) {
  constexpr int RM = BM / kTy;  // query rows per thread
  constexpr int CN = BN / kTx;  // keys per thread per tile
  constexpr int CD = D / kTx;   // output columns per thread
  constexpr int LD = D + 1, LP = BN + 1;
  extern __shared__ float smem[];
  float* Qs = smem;          // [BM][LD]
  float* Ks = Qs + BM * LD;  // [BN][LD]
  float* Vs = Ks + BN * LD;  // [BN][LD]
  float* Ps = Vs + BN * LD;  // [BM][LP]

  const int ty = threadIdx.x / kTx, tx = threadIdx.x % kTx;
  const int q0 = blockIdx.x * BM;
  const long long bh = (long long)blockIdx.z * H + blockIdx.y;
  // KV head of query head (b, h): b * Hkv + h / group == bh / group
  const long long bkv = bh / group;
  const auto* kg = k + bkv * Sk * D;
  const auto* vg = v + bkv * Sk * D;

  load_tile<BM, D, BF16, true>(Qs, q + bh * Sq * D, q0, Sq, scale);

  float m[RM], l[RM], acc[RM][CD];
#pragma unroll
  for (int a = 0; a < RM; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.f;
#pragma unroll
    for (int e = 0; e < CD; ++e) acc[a][e] = 0.f;
  }

  int n_kv = (Sk + BN - 1) / BN;
  if (causal) n_kv = min(n_kv, (q0 + BM - 1) / BN + 1);
  for (int kb = 0; kb < n_kv; ++kb) {
    const int k0 = kb * BN;
    __syncthreads();  // the previous tile's readers are done
    load_tile<BN, D, BF16>(Ks, kg, k0, Sk);
    load_tile<BN, D, BF16>(Vs, vg, k0, Sk);
    __syncthreads();

    float s[RM][CN];
#pragma unroll
    for (int a = 0; a < RM; ++a)
#pragma unroll
      for (int c = 0; c < CN; ++c) s[a][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[RM], kc[CN];
#pragma unroll
      for (int a = 0; a < RM; ++a) qa[a] = Qs[(ty + kTy * a) * LD + d];
#pragma unroll
      for (int c = 0; c < CN; ++c) kc[c] = Ks[(tx + kTx * c) * LD + d];
#pragma unroll
      for (int a = 0; a < RM; ++a)
#pragma unroll
        for (int c = 0; c < CN; ++c) s[a][c] = fmaf(qa[a], kc[c], s[a][c]);
    }

    const bool diag = causal && k0 + BN - 1 > q0;
#pragma unroll
    for (int a = 0; a < RM; ++a) {
      const int i = q0 + ty + kTy * a;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        const int j = k0 + tx + kTx * c;
        if (j >= Sk || (diag && j > i)) s[a][c] = -INFINITY;
        mx = fmaxf(mx, s[a][c]);
      }
      // the -1e30 floor keeps a row that has seen only masked keys finite
      const float m_new = fmaxf(m[a], fmaxf(group_max(mx), -1e30f));
      const float alpha = exp2f(m[a] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        const float p = exp2f(s[a][c] - m_new);
        rs += p;
        Ps[(ty + kTy * a) * LP + tx + kTx * c] = Elem<BF16>::round(p);
      }
      l[a] = l[a] * alpha + group_sum(rs);
      m[a] = m_new;
#pragma unroll
      for (int e = 0; e < CD; ++e) acc[a][e] *= alpha;
    }
    __syncwarp();  // a row's P is written and read by the same 8 lanes

#pragma unroll 4
    for (int j = 0; j < BN; ++j) {
      float pa[RM], vc[CD];
#pragma unroll
      for (int a = 0; a < RM; ++a) pa[a] = Ps[(ty + kTy * a) * LP + j];
#pragma unroll
      for (int e = 0; e < CD; ++e) vc[e] = Vs[j * LD + tx + kTx * e];
#pragma unroll
      for (int a = 0; a < RM; ++a)
#pragma unroll
        for (int e = 0; e < CD; ++e) acc[a][e] = fmaf(pa[a], vc[e], acc[a][e]);
    }
  }

#pragma unroll
  for (int a = 0; a < RM; ++a) {
    const int i = q0 + ty + kTy * a;
    if (i >= Sq) continue;
    const long long row = bh * Sq + i;
    if constexpr (PARTIAL) {
      float* of = static_cast<float*>(o);
#pragma unroll
      for (int e = 0; e < CD; ++e) of[row * D + tx + kTx * e] = acc[a][e];
      if (tx == 0) {
        m_out[row] = m[a];
        l_out[row] = l[a];
      }
    } else {
      // clamped divide: a fully underflowed row gives 0, not 0/0
      const float den = fmaxf(l[a], 1e-30f);
      auto* ot = static_cast<typename Elem<BF16>::T*>(o);
#pragma unroll
      for (int e = 0; e < CD; ++e)
        Elem<BF16>::store(ot, row * D + tx + kTx * e, acc[a][e] / den);
    }
  }
}

template <int D, bool BF16, bool PARTIAL>
int run(const void* q, const void* k, const void* v, void* o, void* m,
        void* l, int B, int H, int group, int Sq, int Sk, int causal,
        float scale, cudaStream_t stream) {
  using T = typename Elem<BF16>::T;
  const dim3 grid((Sq + BM - 1) / BM, H, B);
  return launch(mha_fwd<D, BF16, PARTIAL>, grid, fwd_smem_bytes<D>(), stream,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), o, static_cast<float*>(m),
                static_cast<float*>(l), H, group, Sq, Sk, causal, scale);
}

template <int D>
int dispatch(int bf16, int partial, const void* q, const void* k,
             const void* v, void* o, void* m, void* l, int B, int H,
             int group, int Sq, int Sk, int causal, float scale,
             cudaStream_t st) {
  if (bf16)
    return partial ? run<D, true, true>(q, k, v, o, m, l, B, H, group, Sq,
                                        Sk, causal, scale, st)
                   : run<D, true, false>(q, k, v, o, m, l, B, H, group, Sq,
                                         Sk, causal, scale, st);
  return partial ? run<D, false, true>(q, k, v, o, m, l, B, H, group, Sq,
                                       Sk, causal, scale, st)
                 : run<D, false, false>(q, k, v, o, m, l, B, H, group, Sq,
                                        Sk, causal, scale, st);
}

}  // namespace

// Launches on `stream`; returns the first CUDA error (0 = launched), or
// cudaErrorInvalidValue for a head_dim without an instance or Hkv that
// does not divide H. `m` and `l` are used only when `partial` is set. The
// Python wrapper checks shapes, types and contiguity before calling.
extern "C" int tl_mha_fwd(const void* q, const void* k, const void* v,
                          void* o, void* m, void* l, int B, int H, int Hkv,
                          int Sq, int Sk, int D, int bf16, int causal,
                          int partial, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Hkv < 1 || H % Hkv) return static_cast<int>(cudaErrorInvalidValue);
  const int g = H / Hkv;
  switch (D) {
    case 16:
      return dispatch<16>(bf16, partial, q, k, v, o, m, l, B, H, g, Sq, Sk,
                          causal, scale, st);
    case 32:
      return dispatch<32>(bf16, partial, q, k, v, o, m, l, B, H, g, Sq, Sk,
                          causal, scale, st);
    case 64:
      return dispatch<64>(bf16, partial, q, k, v, o, m, l, B, H, g, Sq, Sk,
                          causal, scale, st);
    case 128:
      return dispatch<128>(bf16, partial, q, k, v, o, m, l, B, H, g, Sq, Sk,
                           causal, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
