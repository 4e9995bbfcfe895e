// Attention with per-head sink logits and an optional sliding window,
// MHA and GQA, for Hopper (sm_90a).
//
// Replaces the TPU kernel of tilelang_mesh_tpu/ops/attention_sink.py:
//   sink_fwd_kernel (:30) -> tl_sink_fwd (tl_sink_fwd_tiled for a tile)
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
// is the visible pairs' flops over the type's rate (989 TFLOP/s for bf16
// and f16 on the tensor cores, 67 TFLOP/s for float32 outside them).
// Under a 128-token window each row sees at most 128 keys: the work
// shrinks with the window until the bytes (Q, K, V, O once) bound it.
//
// Design, bfloat16 and float16 (sink_fwd_mma): mma.sync m16n8k16 with
// float32 sums on attention_mma.cuh's fragment helpers, four warps a
// block per (TM-query tile, query head, batch), each warp TM / 4 rows.
// Q is held as A fragments, K and V tiles of TN keys arrive by cp.async
// into two stages (the next tile while this one is computed); S = Q K^T
// into float32 registers, scaled there by `scale` (the TPU kernel scales
// S, not Q, :80-86, so Q is not rounded after a multiply); P rounded to
// the input type straight into A fragments (to_frags); O += P V through
// ldmatrix.trans. The KV loop runs over kv_span's tiles only: from the
// tile holding key q0 - window + 1 to the tile holding the block's last
// diagonal (causal) or Sk's last key; a warp skips a tile that lies
// wholly above its rows' diagonal or wholly below their window, and
// masks only the edge tiles (the diagonal, j >= Sk, the window's lower
// edge j <= i - window). The sink joins the denominator once, after the
// loop: l = quad_sum(l) + exp2(sink * log2(e) - m), O = acc / max(l,
// 1e-30). When causal, the heaviest query tiles go first. The tile (TM,
// TN) is the host's choice (ops/attention_sink.py::sink_tile, by head_dim
// and window) among attention_mma.cuh's fwd_tiles.
//
// Design, float32 (sink_fwd, CUDA cores): csrc/flash_attention.cu's
// scalar loop (its tile step is attention_tile.cuh's attend_tile here)
// with the same span: a block of 128 threads per (64-query tile, query
// head, batch) visits the 32-key tiles of kv_span; the elementwise test
// masks the ragged edge, the diagonal and the window's lower edge. Q is
// held unscaled in shared memory; the sink is one exp2 per row in the
// epilogue.

#include "attention_mma.cuh"
#include "attention_tile.cuh"

namespace {

using namespace tl_attn;

constexpr int BM = 64;  // query rows per block
constexpr int BN = 32;  // keys per tile
constexpr float kLog2e = 1.44269504f;  // the TPU kernel's _LOG2E

// the key tiles [lo, hi] of TN keys a block of query rows [q0, q0 + TM)
// visits
template <int TM = BM, int TN = BN>
__device__ __forceinline__ void kv_span(int q0, int Sk, int causal,
                                        int window, int& lo, int& hi) {
  hi = (Sk + TN - 1) / TN - 1;
  if (causal) hi = min(hi, (q0 + TM - 1) / TN);
  lo = 0;
  if (window > 0 && q0 - window + 1 > 0) lo = (q0 - window + 1) / TN;
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

// ---------------------------------------------------------------------------
// bfloat16 and float16: tensor cores
// ---------------------------------------------------------------------------

template <int D, int TM, int TN>
constexpr size_t sink_mma_smem_bytes() {
  return 2 * (size_t)(TM + 4 * TN) * (D + kPad);  // Q, two stages of K, V
}

template <int D, typename E, int TM, int TN>
__global__ void __launch_bounds__(kThreads, 1)
sink_fwd_mma(const E* __restrict__ q, const E* __restrict__ k,
             const E* __restrict__ v, const float* __restrict__ sinks,
             E* __restrict__ o, int H, int group, int Sq, int Sk, int causal,
             int window, float scale) {
  constexpr int WM = TM / 64;  // m16 row tiles a warp: 4 warps a block
  // Q as held A fragments, else read from shared memory each k16 step
  constexpr bool QREG = WM == 1 || D <= 64;
  constexpr int LD = D + kPad;
  static_assert(D % 16 == 0 && (LD / 8) % 2 == 1, "unsupported head_dim");
  static_assert((TM == 64 || TM == 128) && TN % 16 == 0, "unsupported tile");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* sQ = reinterpret_cast<E*>(smem_raw);  // [TM][LD]
  E* sK = sQ + TM * LD;                    // [2][TN][LD]
  E* sV = sK + 2 * TN * LD;                // [2][TN][LD]

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int mat = lane / 8, mr = lane % 8, g = lane / 4, q2 = (lane % 4) * 2;
  // the last query tiles see the most keys when causal: they go first
  const int q0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * TM;
  const int qw = q0 + 16 * WM * warp;  // the warp's first row
  const int qe = qw + 16 * WM - 1;     // and its last
  const long long bh = (long long)blockIdx.z * H + blockIdx.y;
  // KV head of query head (b, h): b * Hkv + h / group == bh / group
  const long long bkv = bh / group;
  const E* kg = k + bkv * Sk * D;
  const E* vg = v + bkv * Sk * D;
  int lo, hi;
  kv_span<TM, TN>(q0, Sk, causal, window, lo, hi);

  issue_rows<TM, D>(sQ, q + bh * Sq * D, q0, Sq);
  if (lo <= hi) {
    issue_rows<TN, D>(sK + (lo & 1) * TN * LD, kg, lo * TN, Sk);
    issue_rows<TN, D>(sV + (lo & 1) * TN * LD, vg, lo * TN, Sk);
  }
  tl_gemm::cp_async_commit();
  tl_gemm::cp_async_wait<0>();
  __syncthreads();

  // the A fragment of the warp's m16 tile wm at k16 step kd
  auto q_frag = [&](unsigned (&f)[4], int wm, int kd) {
    mma16::ldmatrix_x4(f, sQ + (16 * (WM * warp + wm) + mr + 8 * (mat % 2)) *
                                   LD + 16 * kd + 8 * (mat / 2));
  };
  unsigned qf[QREG ? WM : 1][QREG ? D / 16 : 1][4];
  if constexpr (QREG)
#pragma unroll
    for (int wm = 0; wm < WM; ++wm)
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) q_frag(qf[wm][kd], wm, kd);

  // the lane's rows qw + 16 wm + g and + 8: running max, its partial sum
  float m[WM][2], l[WM][2], acc[WM][D / 8][4];
#pragma unroll
  for (int wm = 0; wm < WM; ++wm) {
    m[wm][0] = m[wm][1] = -1e30f;
    l[wm][0] = l[wm][1] = 0.f;
    zero(acc[wm]);
  }
  for (int kb = lo; kb <= hi; ++kb) {
    if (kb > lo) {
      tl_gemm::cp_async_wait<0>();
      __syncthreads();  // tile kb landed; tile kb - 1's readers are done
    }
    if (kb < hi) {
      const int st = (kb + 1) & 1;
      issue_rows<TN, D>(sK + st * TN * LD, kg, (kb + 1) * TN, Sk);
      issue_rows<TN, D>(sV + st * TN * LD, vg, (kb + 1) * TN, Sk);
    }
    tl_gemm::cp_async_commit();
    const int k0 = kb * TN, k1 = k0 + TN - 1;
    // rows past Sq; a tile wholly above the warp's diagonal or wholly
    // below its window: nothing to add
    if (qw >= Sq || (causal && k0 > qe) ||
        (window > 0 && k1 <= qw - window))
      continue;
    const E* tK = sK + (kb & 1) * TN * LD;
    const E* tV = sV + (kb & 1) * TN * LD;

    // S = Q K^T, each K fragment serving the warp's WM row tiles
    float s[WM][TN / 8][4];
#pragma unroll
    for (int wm = 0; wm < WM; ++wm) zero(s[wm]);
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      unsigned qa[WM][4];
#pragma unroll
      for (int wm = 0; wm < WM; ++wm) {
        if constexpr (QREG) {
#pragma unroll
          for (int r = 0; r < 4; ++r) qa[wm][r] = qf[wm][kd][r];
        } else {
          q_frag(qa[wm], wm, kd);
        }
      }
#pragma unroll
      for (int np = 0; np < TN / 16; ++np) {
        unsigned r[4];
        mma16::ldmatrix_x4(r, tK + (np * 16 + mr + 8 * (mat / 2)) * LD +
                                  16 * kd + 8 * (mat % 2));
#pragma unroll
        for (int wm = 0; wm < WM; ++wm) {
          mma16::mma<E>(s[wm][2 * np], qa[wm], r[0], r[1]);
          mma16::mma<E>(s[wm][2 * np + 1], qa[wm], r[2], r[3]);
        }
      }
    }

    // scaled in float32; masked on an edge tile only (j > i, j past Sk,
    // j <= i - window)
    const bool edge = (causal && k1 > qw) || k1 >= Sk ||
                      (window > 0 && k0 <= qe - window);
#pragma unroll
    for (int wm = 0; wm < WM; ++wm)
#pragma unroll
      for (int nt = 0; nt < TN / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[wm][nt][e] * scale;
          if (edge) {
            const int i = qw + 16 * wm + g + 8 * (e >> 1);
            const int j = k0 + 8 * nt + q2 + (e & 1);
            if (j >= Sk || (causal && j > i) ||
                (window > 0 && j <= i - window))
              x = -INFINITY;
          }
          s[wm][nt][e] = x;
        }

    // online softmax; the -1e30 floor keeps a row that has seen only
    // masked keys finite
    unsigned pa[WM][TN / 16][4];
#pragma unroll
    for (int wm = 0; wm < WM; ++wm) {
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < TN / 8; ++nt)
          mx = fmaxf(mx, fmaxf(s[wm][nt][2 * h], s[wm][nt][2 * h + 1]));
        const float m_new = fmaxf(m[wm][h], quad_max(mx));
        alpha[h] = exp2f(m[wm][h] - m_new);
        m[wm][h] = m_new;
        float rs = 0.f;
#pragma unroll
        for (int nt = 0; nt < TN / 8; ++nt)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float p = exp2f(s[wm][nt][2 * h + c] - m_new);
            s[wm][nt][2 * h + c] = p;
            rs += p;
          }
        l[wm][h] = l[wm][h] * alpha[h] + rs;
      }
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[wm][nt][e] *= alpha[e >> 1];
      to_frags<TN, E>(pa[wm], s[wm]);
    }

    // O += dtype(P) V, each V fragment (ldmatrix.trans) serving WM tiles
#pragma unroll
    for (int kk = 0; kk < TN / 16; ++kk)
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        unsigned r[4];
        mma16::ldmatrix_x4_trans(r, tV + (kk * 16 + mr + 8 * (mat % 2)) * LD +
                                        np * 16 + 8 * (mat / 2));
#pragma unroll
        for (int wm = 0; wm < WM; ++wm) {
          mma16::mma<E>(acc[wm][2 * np], pa[wm][kk], r[0], r[1]);
          mma16::mma<E>(acc[wm][2 * np + 1], pa[wm][kk], r[2], r[3]);
        }
      }
  }
  tl_gemm::cp_async_wait<0>();

  if (qw >= Sq) return;
  // the sink: one value-less logit in the denominator, against the
  // scores' max (a row that saw no key has m = -1e30: l = inf, O = 0)
  const float sink = sinks[blockIdx.y] * kLog2e;
  E* ot = o + bh * Sq * D;
#pragma unroll
  for (int wm = 0; wm < WM; ++wm)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = qw + 16 * wm + g + 8 * h;
      const float lt = quad_sum(l[wm][h]);
      if (i >= Sq) continue;
      const float den = fmaxf(lt + exp2f(sink - m[wm][h]), 1e-30f);
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt)
        *reinterpret_cast<unsigned*>(ot + (long long)i * D + 8 * nt + q2) =
            pack2<E>(acc[wm][nt][2 * h] / den, acc[wm][nt][2 * h + 1] / den);
    }
}

struct SinkArgs {
  const void *q, *k, *v;
  const float* sinks;
  void* o;
  int B, H, group, Sq, Sk, causal, window;
  float scale;
  cudaStream_t st;
};

template <int D, typename E, int TM, int TN>
int run_mma(const SinkArgs& a) {
  const dim3 grid((a.Sq + TM - 1) / TM, a.H, a.B);
  return launch(sink_fwd_mma<D, E, TM, TN>, grid,
                sink_mma_smem_bytes<D, TM, TN>(), a.st,
                static_cast<const E*>(a.q), static_cast<const E*>(a.k),
                static_cast<const E*>(a.v), a.sinks, static_cast<E*>(a.o),
                a.H, a.group, a.Sq, a.Sk, a.causal, a.window, a.scale);
}

// run_tile's launcher of the tensor-core instance (TM, TN)
template <int D, typename E>
struct MmaRun {
  const SinkArgs& a;
  template <int TM, int TN>
  int go() const { return run_mma<D, E, TM, TN>(a); }
};

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
int dispatch(int dt, int bm, int bn, const SinkArgs& a) {
  switch (dt) {
    case kF32:  // one tile, (BM, BN)
      if (!(bm == 0 && bn == 0) && !(bm == BM && bn == BN))
        return static_cast<int>(cudaErrorInvalidValue);
      return run<D, kF32>(a.q, a.k, a.v, a.sinks, a.o, a.B, a.H, a.group,
                          a.Sq, a.Sk, a.causal, a.window, a.scale, a.st);
    case kBF16:
      return fwd_tiles<D>(bm, bn, MmaRun<D, __nv_bfloat16>{a});
    case kF16:
      return fwd_tiles<D>(bm, bn, MmaRun<D, __half>{a});
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches on `stream` with the tile (block_M, block_N) of the 16-bit
// kernel, (0, 0) for the head_dim's default (float32 has one tile, 64 x
// 32); returns the first CUDA error (0 = launched), or
// cudaErrorInvalidValue for a head_dim, type or tile without an instance
// or Hkv that does not divide H. window <= 0 means no sliding window;
// `scale` is sm_scale * log2(e). The Python wrapper checks shapes, types
// and contiguity before calling.
extern "C" int tl_sink_fwd_tiled(const void* q, const void* k, const void* v,
                                 const void* sinks, void* o, int B, int H,
                                 int Hkv, int Sq, int Sk, int D, int dt,
                                 int causal, int window, float scale,
                                 int block_M, int block_N, void* stream) {
  if (Hkv < 1 || H % Hkv) return static_cast<int>(cudaErrorInvalidValue);
  const SinkArgs a{q, k, v, static_cast<const float*>(sinks), o, B, H,
                   H / Hkv, Sq, Sk, causal, window, scale,
                   static_cast<cudaStream_t>(stream)};
  switch (D) {
    case 16:
      return dispatch<16>(dt, block_M, block_N, a);
    case 32:
      return dispatch<32>(dt, block_M, block_N, a);
    case 64:
      return dispatch<64>(dt, block_M, block_N, a);
    case 128:
      return dispatch<128>(dt, block_M, block_N, a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// tl_sink_fwd_tiled at the head_dim's default tile
extern "C" int tl_sink_fwd(const void* q, const void* k, const void* v,
                           const void* sinks, void* o, int B, int H, int Hkv,
                           int Sq, int Sk, int D, int dt, int causal,
                           int window, float scale, void* stream) {
  return tl_sink_fwd_tiled(q, k, v, sinks, o, B, H, Hkv, Sq, Sk, D, dt,
                           causal, window, scale, 0, 0, stream);
}
