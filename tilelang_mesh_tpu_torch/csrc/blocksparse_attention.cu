// Block-sparse multi-head attention forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel of tilelang_mesh_tpu/ops/blocksparse_attention.py:
//   blocksparse_mha_kernel (:21) -> tl_blocksparse_mha
// Same contract:
//   Q (B, H, Sq, D), K, V (B, H, Sk, D) float32, bfloat16 or float16,
//   contiguous;
//   BlockMask (B, H, Sq / bM, Sk / bN) int32, nonzero = live, in the
//   caller's blocks of bM queries by bN keys (Sq % bM == Sk % bN == 0).
//   Scores in the exp2 domain: S = float(Q K^T) * scale, scale = sm_scale
//   * log2(e). Query i sees key j when the cell (i / bM, j / bN) is live
//   and, causal, j <= i (top-left). Online softmax per key tile
//   (ops/_online_softmax.py:39):
//     m_new = max(m, rowmax(S), -1e30); p = exp2(S - m_new)
//     l = l * exp2(m - m_new) + rowsum(p); acc = acc * exp2(m - m_new)
//     + dtype(p) @ V
//   O (B, H, Sq, D) in the input type, l > 0 ? acc / l : 0, so a row
//   whose every cell is dead is exactly 0 (:62-66).
//
// Bound: operations. Each visible (i, j) pair costs 4 * D flops (S and
// P @ V); at S 4096 and a mask of density 0.5 the pairs' flops over the
// float32 rate (67 TFLOP/s outside the tensor cores) are far above the
// bytes' time.
//
// Design: csrc/flash_attention.cu's loop (left as it is; its tile step is
// attention_tile.cuh's attend_tile here). The mask's cells are the
// caller's blocks, not the kernel's 64 x 32 tiles, so liveness goes as
// in csrc/varlen_common.cuh: a key tile is a candidate
// when any cell its rows x keys overlap is live (the block votes, each
// thread reading a share of those cells; the vote is also the barrier
// before the tile's loads); a tile that is no candidate is skipped and
// adds exactly nothing; inside a candidate each pair's own cell decides
// its mask (read only when the tile spans more than one cell). Causal
// tiles wholly above the diagonal are not visited. No tensor cores yet:
// this is the simple, exact version.

#include "attention_tile.cuh"
#include "varlen_common.cuh"

namespace {

using namespace tl_varlen;

constexpr int BM = 64;  // query rows per block
constexpr int BN = 32;  // keys per tile

template <int D, int DT>
__global__ void __launch_bounds__(kThreads)
blocksparse_mha(const typename Elem<DT>::T* __restrict__ q,
                const typename Elem<DT>::T* __restrict__ k,
                const typename Elem<DT>::T* __restrict__ v,
                const int* __restrict__ mask,
                typename Elem<DT>::T* __restrict__ o, int H, int Sq,
                int Sk, int bM, int bN, int causal, float scale) {
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
  const int nR = Sq / bM, nC = Sk / bN;
  const int* live = mask + bh * nR * nC;
  const auto* kg = k + bh * Sk * D;
  const auto* vg = v + bh * Sk * D;

  load_tile<BM, D, DT>(Qs, q + bh * Sq * D, q0, Sq);

  // the block's row cells, and each of this thread's rows' (rows past
  // Sq, never stored, take the last row's)
  const Cells r = cells_of(q0, min(q0 + BM, Sq), bM);
  int rc[RM];
#pragma unroll
  for (int a = 0; a < RM; ++a) rc[a] = min(q0 + ty + kTy * a, Sq - 1) / bM;

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
    const Cells c = cells_of(k0, min(k0 + BN, Sk), bN);
    // the vote is the barrier before the previous tile's data is
    // overwritten
    if (!any_live(live, nC, r, c)) continue;
    const bool one_cell = r.a0 == r.a1 && c.a0 == c.a1;  // and it is live
    load_tile<BN, D, DT>(Ks, kg, k0, Sk);
    load_tile<BN, D, DT>(Vs, vg, k0, Sk);
    __syncthreads();
    attend_tile<BM, BN, D, DT>(
        Qs, Ks, Vs, Ps, scale,
        [&](int a, int cc) {
          const int i = q0 + ty + kTy * a, j = k0 + tx + kTx * cc;
          if (j >= Sk || (causal && j > i)) return false;
          return one_cell || live[(long long)rc[a] * nC + j / bN] != 0;
        },
        m, l, acc);
  }

#pragma unroll
  for (int a = 0; a < RM; ++a) {
    const int i = q0 + ty + kTy * a;
    if (i >= Sq) continue;
    const long long row = bh * Sq + i;
#pragma unroll
    for (int e = 0; e < CD; ++e)
      Elem<DT>::store(o, row * D + tx + kTx * e,
                      l[a] > 0.f ? acc[a][e] / l[a] : 0.f);
  }
}

template <int D, int DT>
int run(const void* q, const void* k, const void* v, const int* mask,
        void* o, int B, int H, int Sq, int Sk, int bM, int bN, int causal,
        float scale, cudaStream_t stream) {
  using T = typename Elem<DT>::T;
  const dim3 grid((Sq + BM - 1) / BM, H, B);
  return launch(blocksparse_mha<D, DT>, grid,
                tile_smem_bytes<BM, BN, D>(), stream,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), mask, static_cast<T*>(o), H, Sq,
                Sk, bM, bN, causal, scale);
}

template <int D>
int dispatch(int dt, const void* q, const void* k, const void* v,
             const int* mask, void* o, int B, int H, int Sq, int Sk, int bM,
             int bN, int causal, float scale, cudaStream_t st) {
  return with_elem(dt, [&](auto e) {
    return run<D, decltype(e)::value>(q, k, v, mask, o, B, H, Sq, Sk, bM, bN,
                                      causal, scale, st);
  });
}

}  // namespace

// Launches on `stream`; returns the first CUDA error (0 = launched), or
// cudaErrorInvalidValue for a head_dim without an instance or blocks
// that do not divide Sq, Sk. `scale` is sm_scale * log2(e). The Python
// wrapper checks shapes, types and contiguity before calling.
extern "C" int tl_blocksparse_mha(const void* q, const void* k,
                                  const void* v, const void* mask, void* o,
                                  int B, int H, int Sq, int Sk, int D,
                                  int bM, int bN, int dt, int causal,
                                  float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bM < 1 || bN < 1 || Sq % bM || Sk % bN)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* mk = static_cast<const int*>(mask);
  switch (D) {
    case 16:
      return dispatch<16>(dt, q, k, v, mk, o, B, H, Sq, Sk, bM, bN, causal,
                          scale, st);
    case 32:
      return dispatch<32>(dt, q, k, v, mk, o, B, H, Sq, Sk, bM, bN, causal,
                          scale, st);
    case 64:
      return dispatch<64>(dt, q, k, v, mk, o, B, H, Sq, Sk, bM, bN, causal,
                          scale, st);
    case 128:
      return dispatch<128>(dt, q, k, v, mk, o, B, H, Sq, Sk, bM, bN,
                           causal, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
