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
//   Q (B, H, Sq, D), K, V (B, Hkv, Sk, D) float32, bfloat16 or
//   float16 (`dt`: attention_common.cuh's codes), contiguous; query
//   head h reads KV head h / (H / Hkv), so MHA is Hkv = H (the same
//   addresses as before KV heads were added)
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
// contract rules out TF32), or the bfloat16 / float16 tensor-core rate.
//
// float32 (`mha_fwd`; CUDA-core FMAs, the reference's float32
// numerics): one block of 128 threads per (64-query tile, head, batch),
// the TPU grid (ceil(Sq/BM), H, B) with its sequential KV axis turned
// into a loop inside the block. The prescaled Q tile stays in shared
// memory; each 32-key tile of K and V is loaded into shared memory
// (float32, odd row stride, zero past Sk), every thread computes a 4 x 4
// block of scores with CUDA-core FMAs, masks the ragged edge (j >= Sk)
// and the diagonal, updates its rows' (m, l) with 8-lane shuffles, writes
// its probabilities to a shared tile that only its own warp reads, and
// accumulates its 4 rows x D/8 columns of P @ V in registers.
//
// bfloat16 and float16 (`mha_fwd_mma`; tensor cores): FlashAttention-2's
// forward on mma.sync m16n8k16 with float32 sums, on attention_mma.cuh's
// fragment map. One block of four warps per (TM-query tile, head, batch),
// heaviest causal tiles first; a warp owns TM / 4 rows, one m16 tile at
// TM = 64, two at TM = 128 (every K and V fragment then feeds two
// products: half the shared-memory reads a flop, which bound a warp of
// one tile). The Q tile arrives once by cp.async and is
// prescaled in place (float32, rounded to the input type); a warp holds
// it as A fragments, or at two tiles of D = 128 (registers: 128 floats
// of O) reads them from shared memory each k16 step. K and V tiles of TN
// keys (in the input type, rows padded by kPad) arrive by cp.async into
// two stages, the next while this one is computed, up to the diagonal
// when causal. Each warp takes S = Qs K^T into float32 accumulators,
// masks only on edge tiles (the diagonal, j >= Sk), updates its rows' m
// with quad shuffles (the 4 lanes of an m16n8 row; l stays a per-lane
// partial until the epilogue), rescales its O accumulators, rounds P
// straight into A fragments and accumulates O += P V, V through
// ldmatrix.trans; a warp whose rows all precede the tile's first key
// skips it. The tile (TM, TN) is one of attention_mma.cuh's `fwd_tiles`
// by head_dim (carver/roller.py's FLASH_KERNEL_TILES lists the same);
// `tl_mha_fwd` takes the first.
//
// Both: any Sq, Sk >= 1 works: query rows past Sq are computed on zeros
// and never stored. Under GQA the blocks of a group's H / Hkv query
// heads each load the same K and V tiles (the repeats come from L2; the
// TPU kernel's BlockSpec fetches them per head alike).

#include "attention_common.cuh"
#include "attention_mma.cuh"

namespace {

using namespace tl_attn;

constexpr int BM = 64;  // query rows per block
constexpr int BN = 32;  // keys per tile

template <int D>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * (BM * (D + 1) + 2 * BN * (D + 1) + BM * (BN + 1));
}

template <int D, int DT, bool PARTIAL>
__global__ void __launch_bounds__(kThreads)
mha_fwd(const typename Elem<DT>::T* __restrict__ q,
        const typename Elem<DT>::T* __restrict__ k,
        const typename Elem<DT>::T* __restrict__ v, void* __restrict__ o,
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

  load_tile<BM, D, DT, true>(Qs, q + bh * Sq * D, q0, Sq, scale);

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
    load_tile<BN, D, DT>(Ks, kg, k0, Sk);
    load_tile<BN, D, DT>(Vs, vg, k0, Sk);
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
        Ps[(ty + kTy * a) * LP + tx + kTx * c] = Elem<DT>::round(p);
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
      auto* ot = static_cast<typename Elem<DT>::T*>(o);
#pragma unroll
      for (int e = 0; e < CD; ++e)
        Elem<DT>::store(ot, row * D + tx + kTx * e, acc[a][e] / den);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 and float16: tensor cores
// ---------------------------------------------------------------------------

template <int D, int TM, int TN>
constexpr size_t fwd_mma_smem_bytes() {
  return 2 * (size_t)(TM + 4 * TN) * (D + kPad);  // Q, two stages of K, V
}

template <int D, typename E, int TM, int TN>
__global__ void __launch_bounds__(kThreads, 1)
mha_fwd_mma(const E* __restrict__ q, const E* __restrict__ k,
            const E* __restrict__ v, void* __restrict__ o,
            float* __restrict__ m_out, float* __restrict__ l_out, int H,
            int group, int Sq, int Sk, int causal, int partial,
            float scale) {
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
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TM;
  const int qw = q0 + 16 * WM * warp;  // the warp's first row
  const long long bh = (long long)blockIdx.z * H + blockIdx.y;
  // KV head of query head (b, h): b * Hkv + h / group == bh / group
  const long long bkv = bh / group;
  const E* kg = k + bkv * Sk * D;
  const E* vg = v + bkv * Sk * D;
  int n_kv = (Sk + TN - 1) / TN;
  if (causal) n_kv = min(n_kv, (q0 + TM - 1) / TN + 1);

  issue_rows<TM, D>(sQ, q + bh * Sq * D, q0, Sq);
  issue_rows<TN, D>(sK, kg, 0, Sk);
  issue_rows<TN, D>(sV, vg, 0, Sk);
  tl_gemm::cp_async_commit();
  tl_gemm::cp_async_wait<0>();
  __syncthreads();
  // Qs = dtype(float(Q) * scale), in place
  for (int idx = threadIdx.x; idx < TM * D / 2; idx += kThreads) {
    unsigned* x = reinterpret_cast<unsigned*>(sQ + (idx / (D / 2)) * LD) +
                  idx % (D / 2);
    *x = scale2<E>(*x, scale);
  }
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
    m[wm][0] = m[wm][1] = -INFINITY;
    l[wm][0] = l[wm][1] = 0.f;
    zero(acc[wm]);
  }
  for (int kb = 0; kb < n_kv; ++kb) {
    if (kb > 0) {
      tl_gemm::cp_async_wait<0>();
      __syncthreads();  // tile kb landed; tile kb - 1's readers are done
    }
    if (kb + 1 < n_kv) {
      const int st = (kb + 1) & 1;
      issue_rows<TN, D>(sK + st * TN * LD, kg, (kb + 1) * TN, Sk);
      issue_rows<TN, D>(sV + st * TN * LD, vg, (kb + 1) * TN, Sk);
    }
    tl_gemm::cp_async_commit();
    const int k0 = kb * TN;
    // rows past Sq, or all before the tile's first key: nothing to add
    if (qw >= Sq || (causal && k0 > qw + 16 * WM - 1)) continue;
    const E* tK = sK + (kb & 1) * TN * LD;
    const E* tV = sV + (kb & 1) * TN * LD;

    // S = Qs K^T, each K fragment serving the warp's WM row tiles
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

    // masked on an edge tile (j > i, or j past Sk)
    if ((causal && k0 + TN - 1 > qw) || k0 + TN > Sk) {
#pragma unroll
      for (int wm = 0; wm < WM; ++wm)
#pragma unroll
        for (int nt = 0; nt < TN / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = qw + 16 * wm + g + 8 * (e >> 1);
            const int j = k0 + 8 * nt + q2 + (e & 1);
            if (j >= Sk || (causal && j > i)) s[wm][nt][e] = -INFINITY;
          }
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
        const float m_new = fmaxf(m[wm][h], fmaxf(quad_max(mx), -1e30f));
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
#pragma unroll
  for (int wm = 0; wm < WM; ++wm) {
    const int r0 = qw + 16 * wm;
    const float lt[2] = {quad_sum(l[wm][0]), quad_sum(l[wm][1])};
    if (partial) {
      store_rows<D>(static_cast<float*>(o) + bh * Sq * D, acc[wm], r0, Sq);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = r0 + g + 8 * h;
        if (q2 == 0 && i < Sq) {
          m_out[bh * Sq + i] = m[wm][h];
          l_out[bh * Sq + i] = lt[h];
        }
      }
      continue;
    }
    E* ot = static_cast<E*>(o) + bh * Sq * D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = r0 + g + 8 * h;
      if (i >= Sq) continue;
      // clamped divide: a fully underflowed row gives 0, not 0/0
      const float den = fmaxf(lt[h], 1e-30f);
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt)
        *reinterpret_cast<unsigned*>(ot + (long long)i * D + 8 * nt + q2) =
            pack2<E>(acc[wm][nt][2 * h] / den, acc[wm][nt][2 * h + 1] / den);
    }
  }
}

struct FwdArgs {
  const void *q, *k, *v;
  void* o;
  float *m, *l;
  int B, H, group, Sq, Sk, causal, partial;
  float scale;
  cudaStream_t st;
};

template <int D, int DT, bool PARTIAL>
int run_f32(const FwdArgs& a) {
  using T = typename Elem<DT>::T;
  const dim3 grid((a.Sq + BM - 1) / BM, a.H, a.B);
  return launch(mha_fwd<D, DT, PARTIAL>, grid, fwd_smem_bytes<D>(), a.st,
                static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                static_cast<const T*>(a.v), a.o, a.m, a.l, a.H, a.group,
                a.Sq, a.Sk, a.causal, a.scale);
}

template <int D, typename E, int TM, int TN>
int run_mma(const FwdArgs& a) {
  const dim3 grid((a.Sq + TM - 1) / TM, a.H, a.B);
  return launch(mha_fwd_mma<D, E, TM, TN>, grid,
                fwd_mma_smem_bytes<D, TM, TN>(), a.st,
                static_cast<const E*>(a.q), static_cast<const E*>(a.k),
                static_cast<const E*>(a.v), a.o, a.m, a.l, a.H, a.group,
                a.Sq, a.Sk, a.causal, a.partial, a.scale);
}

// run_tile's launcher of the tensor-core instance (TM, TN)
template <int D, typename E>
struct MmaRun {
  const FwdArgs& a;
  template <int TM, int TN>
  int go() const { return run_mma<D, E, TM, TN>(a); }
};

template <int D>
int dispatch(int dt, int bm, int bn, const FwdArgs& a) {
  switch (dt) {
    case kF32:  // one tile, (BM, BN)
      if (!(bm == 0 && bn == 0) && !(bm == BM && bn == BN))
        return static_cast<int>(cudaErrorInvalidValue);
      return a.partial ? run_f32<D, kF32, true>(a) : run_f32<D, kF32, false>(a);
    case kBF16:
      return fwd_tiles<D>(bm, bn, MmaRun<D, __nv_bfloat16>{a});
    case kF16:
      return fwd_tiles<D>(bm, bn, MmaRun<D, __half>{a});
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches on `stream` with the tile (block_M, block_N), (0, 0) for the
// type's default; returns the first CUDA error (0 = launched), or
// cudaErrorInvalidValue for a head_dim, type or tile without an instance
// or Hkv that does not divide H. `m` and `l` are used only when `partial`
// is set. The Python wrapper checks shapes, types and contiguity before
// calling.
extern "C" int tl_mha_fwd_tiled(const void* q, const void* k, const void* v,
                                void* o, void* m, void* l, int B, int H,
                                int Hkv, int Sq, int Sk, int D, int dt,
                                int causal, int partial, float scale,
                                int block_M, int block_N, void* stream) {
  if (Hkv < 1 || H % Hkv) return static_cast<int>(cudaErrorInvalidValue);
  const FwdArgs a{q, k, v, o, static_cast<float*>(m), static_cast<float*>(l),
                  B, H, H / Hkv, Sq, Sk, causal, partial, scale,
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

// tl_mha_fwd_tiled at the type's default tile
extern "C" int tl_mha_fwd(const void* q, const void* k, const void* v,
                          void* o, void* m, void* l, int B, int H, int Hkv,
                          int Sq, int Sk, int D, int dt, int causal,
                          int partial, float scale, void* stream) {
  return tl_mha_fwd_tiled(q, k, v, o, m, l, B, H, Hkv, Sq, Sk, D, dt, causal,
                          partial, scale, 0, 0, stream);
}
