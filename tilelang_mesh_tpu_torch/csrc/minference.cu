// MInference vertical-slash sparse attention forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel of tilelang_mesh_tpu/ops/minference.py:
//   vs_sparse_kernel (:31) -> tl_vs_sparse
// Same contract:
//   Q (B, H, Sq, D), K, V (B, H, Sk, D) float32, bfloat16 or float16
//   (`dt`: attention_common.cuh's codes), contiguous; Vmask (B, H, Sk)
//   int32, nonzero = a vertical column; Dmask (B, H, Sq) int32, nonzero
//   = a slash diagonal i - j; BlockMask (B, H, Sq / bM, Sk / bN) int32,
//   nonzero = live, in the caller's blocks (Sq % bM == Sk % bN == 0).
//   Query i sees key j when its cell is live, j <= i (top-left causal)
//   and Vmask[j] or Dmask[i - j]. Scores in the exp2 domain, S =
//   float(Q K^T) * scale, scale = sm_scale * log2(e); online softmax per
//   key tile (ops/_online_softmax.py:39), P rounded to the input type;
//   O (B, H, Sq, D) in the input type, l > 0 ? acc / l : 0, so a row
//   that sees nothing is exactly 0 (:80-83).
// The TPU kernel held the slash offsets and compared each pair of a
// live tile with all Ns of them (Ns compares a pair: 6096 at MInference's
// LLaMA-3 patterns). The wrapper instead scatters the slashes into
// Dmask once, so a pair costs one lookup: the same function, as a slash
// below 0 or at Sq or past it matches no causal pair.
//
// Bound: operations. Each visible (i, j) pair costs 4 * D flops (S and
// P @ V); at S 16384 with a thousand columns and thousands of slashes a
// row sees thousands of keys, far above the bytes' time.
//
// Design: blocksparse_attention.cu's loop on attention_tile.cuh's
// attend_tile. A block of 128 threads takes 64 query rows of one head;
// key tiles of 32 wholly above the diagonal are not visited, and a tile
// that overlaps no live cell is skipped by the block vote (any_live,
// also the barrier before the tile's loads). A visited tile stages its
// 32 keys' Vmask entries and the 95 Dmask entries its pairs can reach
// (i - j from q0 - k0 - 31 to q0 - k0 + 63) in shared memory beside K
// and V, so the visibility test reads shared memory only. No tensor
// cores yet: this is the simple, exact version.

#include "attention_tile.cuh"
#include "varlen_common.cuh"

namespace {

using namespace tl_varlen;

constexpr int BM = 64;           // query rows per block
constexpr int BN = 32;           // keys per tile
constexpr int ND = BM + BN - 1;  // diagonals a tile's pairs reach

template <int D>
constexpr size_t smem_bytes() {
  return tile_smem_bytes<BM, BN, D>() + sizeof(int) * (BN + ND);
}

template <int D, int DT>
__global__ void __launch_bounds__(kThreads)
vs_sparse(const typename Elem<DT>::T* __restrict__ q,
          const typename Elem<DT>::T* __restrict__ k,
          const typename Elem<DT>::T* __restrict__ v,
          const int* __restrict__ vmask, const int* __restrict__ dmask,
          const int* __restrict__ mask, typename Elem<DT>::T* __restrict__ o,
          int H, int Sq, int Sk, int bM, int bN, float scale) {
  constexpr int RM = BM / kTy;  // query rows per thread
  constexpr int CD = D / kTx;   // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                // [BM][D + 1]
  float* Ks = Qs + BM * (D + 1);   // [BN][D + 1]
  float* Vs = Ks + BN * (D + 1);   // [BN][D + 1]
  float* Ps = Vs + BN * (D + 1);   // [BM][BN + 1]
  int* vms = reinterpret_cast<int*>(Ps + BM * (BN + 1));   // [BN]
  int* dms = vms + BN;                                     // [ND]

  const int ty = threadIdx.x / kTx, tx = threadIdx.x % kTx;
  const int q0 = blockIdx.x * BM;
  const long long bh = (long long)blockIdx.z * H + blockIdx.y;
  const int nR = Sq / bM, nC = Sk / bN;
  const int* live = mask + bh * nR * nC;
  const int* vm = vmask + bh * Sk;
  const int* dm = dmask + bh * Sq;
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

  const int n_kv = min((Sk + BN - 1) / BN, (q0 + BM - 1) / BN + 1);
  for (int kb = 0; kb < n_kv; ++kb) {
    const int k0 = kb * BN;
    const Cells c = cells_of(k0, min(k0 + BN, Sk), bN);
    // the vote is the barrier before the previous tile's data is
    // overwritten
    if (!any_live(live, nC, r, c)) continue;
    const bool one_cell = r.a0 == r.a1 && c.a0 == c.a1;  // and it is live
    load_tile<BN, D, DT>(Ks, kg, k0, Sk);
    load_tile<BN, D, DT>(Vs, vg, k0, Sk);
    // diagonal d0 + t of the tile at dms[t]; none below 0 or at Sq
    const int d0 = q0 - k0 - (BN - 1);
    for (int t = threadIdx.x; t < BN + ND; t += kThreads) {
      if (t < BN) {
        vms[t] = k0 + t < Sk ? vm[k0 + t] : 0;
      } else {
        const int d = d0 + t - BN;
        dms[t - BN] = d >= 0 && d < Sq ? dm[d] : 0;
      }
    }
    __syncthreads();
    attend_tile<BM, BN, D, DT>(
        Qs, Ks, Vs, Ps, scale,
        [&](int a, int cc) {
          const int ri = ty + kTy * a, cj = tx + kTx * cc;
          const int i = q0 + ri, j = k0 + cj;
          if (j >= Sk || j > i) return false;
          if (!vms[cj] && !dms[ri - cj + BN - 1]) return false;
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
int run(const void* q, const void* k, const void* v, const int* vmask,
        const int* dmask, const int* mask, void* o, int B, int H, int Sq,
        int Sk, int bM, int bN, float scale, cudaStream_t stream) {
  using T = typename Elem<DT>::T;
  const dim3 grid((Sq + BM - 1) / BM, H, B);
  return launch(vs_sparse<D, DT>, grid, smem_bytes<D>(), stream,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), vmask, dmask, mask,
                static_cast<T*>(o), H, Sq, Sk, bM, bN, scale);
}

template <int D>
int dispatch(int dt, const void* q, const void* k, const void* v,
             const int* vmask, const int* dmask, const int* mask, void* o,
             int B, int H, int Sq, int Sk, int bM, int bN, float scale,
             cudaStream_t st) {
  return with_elem(dt, [&](auto e) {
    return run<D, decltype(e)::value>(q, k, v, vmask, dmask, mask, o, B, H,
                                      Sq, Sk, bM, bN, scale, st);
  });
}

}  // namespace

// Launches on `stream`; returns the first CUDA error (0 = launched), or
// cudaErrorInvalidValue for a head_dim or type without an instance or
// blocks that do not divide Sq, Sk. `scale` is sm_scale * log2(e). The
// Python wrapper checks shapes, types and contiguity before calling.
extern "C" int tl_vs_sparse(const void* q, const void* k, const void* v,
                            const void* vmask, const void* dmask,
                            const void* mask, void* o, int B, int H, int Sq,
                            int Sk, int D, int bM, int bN, int dt,
                            float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bM < 1 || bN < 1 || Sq % bM || Sk % bN)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* vm = static_cast<const int*>(vmask);
  const int* dm = static_cast<const int*>(dmask);
  const int* mk = static_cast<const int*>(mask);
  switch (D) {
    case 16:
      return dispatch<16>(dt, q, k, v, vm, dm, mk, o, B, H, Sq, Sk, bM, bN,
                          scale, st);
    case 32:
      return dispatch<32>(dt, q, k, v, vm, dm, mk, o, B, H, Sq, Sk, bM, bN,
                          scale, st);
    case 64:
      return dispatch<64>(dt, q, k, v, vm, dm, mk, o, B, H, Sq, Sk, bM, bN,
                          scale, st);
    case 128:
      return dispatch<128>(dt, q, k, v, vm, dm, mk, o, B, H, Sq, Sk, bM, bN,
                           scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
