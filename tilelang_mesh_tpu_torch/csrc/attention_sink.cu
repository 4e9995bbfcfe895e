// Attention with per-head sink logits and an optional sliding window,
// MHA and GQA, for Hopper (sm_90a).
//
// Replaces the TPU kernel of tilelang_mesh_tpu/ops/attention_sink.py:
//   sink_fwd_kernel (:30) -> tl_sink_fwd
// Same contract:
//   Q (B, Hq, Sq, D), K, V (B, Hkv, Sk, D) float32, bfloat16 or float16,
//   contiguous; query head h reads KV head h / (Hq / Hkv); Sinks (Hq,)
//   float32. Scores in the exp2 domain: S = float(Q K^T) * scale, scale =
//   sm_scale * log2(e). Query i sees key j when j < Sk and, causal, j <=
//   i (top-left) and, window > 0, j > i - window (the window counts the
//   key itself; without causal it bounds keys from below only). Online
//   softmax per key tile (ops/_online_softmax.py:39):
//     m_new = max(m, rowmax(S), -1e30); p = exp2(S - m_new)
//     l = l * exp2(m - m_new) + rowsum(p); acc = acc * exp2(m - m_new)
//     + dtype(p) @ V
//   then the sink joins the denominator as one value-less logit, against
//   the scores' running max m (:93): l += exp2(sink * log2(e) - m), and
//   O = acc / max(l, 1e-30) in the input type (:96).
//
// Bound: operations. Each visible (i, j) pair costs 4 * D flops (S and
// P @ V) against 2 * S * D elements read a head; at S 4096 under full
// causal that is far above the card's balance point, so the least time
// is the visible pairs' flops over the float32 rate (67 TFLOP/s outside
// the tensor cores). Under a 128-token window each row sees at most 128
// keys: the work, and the bound, shrink with the window.
//
// Design: csrc/flash_attention.cu's loop (left as it is; its tile step is
// attention_tile.cuh's attend_tile here), with the KV loop's bounds taken
// from causal and the window: a block of 128 threads per (64-query tile,
// query head, batch) visits only the 32-key tiles from the one holding
// key q0 - window + 1 (its oldest row's oldest visible key) to the one
// holding its newest row's diagonal (causal) or Sk's last; tiles outside
// are skipped, not masked, as the TPU kernel's _block_live (:37-51)
// skips them. At window 128 a 64-row tile visits at
// most 7 key tiles. Within a visited tile the elementwise test masks the
// ragged edge, the diagonal and the window's lower edge. Q is held
// unscaled in shared memory (the TPU kernel scales S, not Q); the sink
// term is one exp2 per row in the epilogue. No tensor cores yet: this is
// the simple, exact version.

#include "attention_tile.cuh"

namespace {

using namespace tl_attn;

constexpr int BM = 64;  // query rows per block
constexpr int BN = 32;  // keys per tile
constexpr float kLog2e = 1.44269504f;  // the TPU kernel's _LOG2E

// the key tiles [lo, hi] a block of query rows [q0, q0 + BM) visits
__device__ __forceinline__ void kv_span(int q0, int Sk, int causal,
                                        int window, int& lo, int& hi) {
  hi = (Sk + BN - 1) / BN - 1;
  if (causal) hi = min(hi, (q0 + BM - 1) / BN);
  lo = 0;
  if (window > 0 && q0 - window + 1 > 0) lo = (q0 - window + 1) / BN;
}

template <int D, int DT>
__global__ void __launch_bounds__(kThreads)
sink_fwd(const typename Elem<DT>::T* __restrict__ q,
         const typename Elem<DT>::T* __restrict__ k,
         const typename Elem<DT>::T* __restrict__ v,
         const float* __restrict__ sinks, typename Elem<DT>::T* __restrict__ o,
         int H, int group, int Sq, int Sk, int causal, int window,
         float scale) {
  constexpr int RM = BM / kTy;  // query rows per thread
  constexpr int CD = D / kTx;   // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                // [BM][D + 1]
  float* Ks = Qs + BM * (D + 1);   // [BN][D + 1]
  float* Vs = Ks + BN * (D + 1);   // [BN][D + 1]
  float* Ps = Vs + BN * (D + 1);   // [BM][BN + 1]

  const int ty = threadIdx.x / kTx, tx = threadIdx.x % kTx;
  const int q0 = blockIdx.x * BM;
  const long long bh = (long long)blockIdx.z * H + blockIdx.y;
  const long long bkv = bh / group;  // b * Hkv + h / group
  const auto* kg = k + bkv * Sk * D;
  const auto* vg = v + bkv * Sk * D;

  load_tile<BM, D, DT>(Qs, q + bh * Sq * D, q0, Sq);

  float m[RM], l[RM], acc[RM][CD];
#pragma unroll
  for (int a = 0; a < RM; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.f;
#pragma unroll
    for (int e = 0; e < CD; ++e) acc[a][e] = 0.f;
  }

  int kb_lo, kb_hi;
  kv_span(q0, Sk, causal, window, kb_lo, kb_hi);
  for (int kb = kb_lo; kb <= kb_hi; ++kb) {
    const int k0 = kb * BN;
    __syncthreads();  // the previous tile's readers are done
    load_tile<BN, D, DT>(Ks, kg, k0, Sk);
    load_tile<BN, D, DT>(Vs, vg, k0, Sk);
    __syncthreads();
    attend_tile<BM, BN, D, DT>(
        Qs, Ks, Vs, Ps, scale,
        [&](int a, int c) {
          const int i = q0 + ty + kTy * a, j = k0 + tx + kTx * c;
          return j < Sk && (!causal || j <= i) &&
                 (window <= 0 || j > i - window);
        },
        m, l, acc);
  }

  // the sink: one value-less logit in the denominator, against the
  // scores' max (a row that saw no tile has m = -inf, l = inf, O = 0)
  const float sink = sinks[blockIdx.y] * kLog2e;
#pragma unroll
  for (int a = 0; a < RM; ++a) {
    const int i = q0 + ty + kTy * a;
    if (i >= Sq) continue;
    const float den = fmaxf(l[a] + exp2f(sink - m[a]), 1e-30f);
    const long long row = bh * Sq + i;
#pragma unroll
    for (int e = 0; e < CD; ++e)
      Elem<DT>::store(o, row * D + tx + kTx * e, acc[a][e] / den);
  }
}

template <int D, int DT>
int run(const void* q, const void* k, const void* v, const float* sinks,
        void* o, int B, int H, int group, int Sq, int Sk, int causal,
        int window, float scale, cudaStream_t stream) {
  using T = typename Elem<DT>::T;
  const dim3 grid((Sq + BM - 1) / BM, H, B);
  return launch(sink_fwd<D, DT>, grid, tile_smem_bytes<BM, BN, D>(),
                stream,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), sinks, static_cast<T*>(o), H,
                group, Sq, Sk, causal, window, scale);
}

template <int D>
int dispatch(int dt, const void* q, const void* k, const void* v,
             const float* sinks, void* o, int B, int H, int group, int Sq,
             int Sk, int causal, int window, float scale, cudaStream_t st) {
  return with_elem(dt, [&](auto e) {
    return run<D, decltype(e)::value>(q, k, v, sinks, o, B, H, group, Sq, Sk,
                                      causal, window, scale, st);
  });
}

}  // namespace

// Launches on `stream`; returns the first CUDA error (0 = launched), or
// cudaErrorInvalidValue for a head_dim without an instance or Hkv that
// does not divide H. window <= 0 means no sliding window; `scale` is
// sm_scale * log2(e). The Python wrapper checks shapes, types and
// contiguity before calling.
extern "C" int tl_sink_fwd(const void* q, const void* k, const void* v,
                           const void* sinks, void* o, int B, int H, int Hkv,
                           int Sq, int Sk, int D, int dt, int causal,
                           int window, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Hkv < 1 || H % Hkv) return static_cast<int>(cudaErrorInvalidValue);
  const int g = H / Hkv;
  const float* sk = static_cast<const float*>(sinks);
  switch (D) {
    case 16:
      return dispatch<16>(dt, q, k, v, sk, o, B, H, g, Sq, Sk, causal,
                          window, scale, st);
    case 32:
      return dispatch<32>(dt, q, k, v, sk, o, B, H, g, Sq, Sk, causal,
                          window, scale, st);
    case 64:
      return dispatch<64>(dt, q, k, v, sk, o, B, H, g, Sq, Sk, causal,
                          window, scale, st);
    case 128:
      return dispatch<128>(dt, q, k, v, sk, o, B, H, g, Sq, Sk, causal,
                           window, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
