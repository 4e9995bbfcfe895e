// Packed ragged-batch (varlen) attention forward, MHA and GQA, for
// Hopper (sm_90a).
//
// Replaces the TPU kernels of tilelang_mesh_tpu/ops/flash_attention_varlen.py
// made by the factory varlen_fwd_kernel (:106):
//   varlen_fwd (:147)                         -> tl_varlen_fwd(partial = 0)
//   varlen_fwd_partial (:123, return_partials) -> tl_varlen_fwd(partial = 1)
// Same contract:
//   Q (Hq, Tq, D), K, V (Hkv, Tk, D) float32, bfloat16 or float16,
//   contiguous;
//   query head h reads KV head h / (Hq / Hkv); SeqQ, PosQ (Tq,) and
//   SeqK, PosK (Tk,) int32; BlockLive (Tq / bM, Tk / bN) int32.
//   Q is prescaled once: Qs = dtype(float(Q) * scale), scale = sm_scale *
//   log2(e), so every score is in the exp2 domain. Query i sees key j
//   when SeqQ[i] == SeqK[j] and, causal, PosQ[i] >= PosK[j] (local
//   positions: lens_q != lens_k works, and bottom-right alignment is a
//   shift of PosQ made by the caller). Online softmax per key tile
//   (_varlen_softmax_loop :50, ops/_online_softmax.py):
//     m_new = max(m, rowmax(S), -1e30); p = exp2(S - m_new)
//     l = l * exp2(m - m_new) + rowsum(p); acc = acc * exp2(m - m_new)
//     + dtype(p) @ V
//   partial = 0: O (Hq, Tq, D) in the input type, l > 0 ? acc / l : 0;
//   partial = 1: O float32 unnormalised acc, M and L (Hq, Tq) float32.
//   A row that sees no key (a pad row, or every key masked) has l = 0,
//   acc = 0 and M = -1e30 (the floor, whatever tiles were visited; the
//   TPU kernel leaves -inf where its q-block met no live block).
//
// Bound: operations. A document of L tokens does 4 * D flops per visible
// (i, j) pair (S and P @ V) against 2 * L * D elements read per head, far
// above the card's balance point at L in the thousands, so the least time
// is the visible pairs' flops over the float32 rate (67 TFLOP/s outside
// the tensor cores; the float32 contract rules out TF32).
//
// Design: csrc/flash_attention.cu's loop — one block of 128 threads per
// (64-query tile, query head), the prescaled Q tile in shared memory,
// 32-key tiles of K and V loaded into shared memory, and
// attention_tile.cuh's tile step (a 4 x 4 block of scores per thread
// with CUDA-core FMAs, (m, l) updated with 8-lane shuffles, P rounded to
// the input type and P @ V accumulated in registers). What differs is
// the mask and which key tiles are visited: the block first finds the
// span of key blocks with a live cell in its query rows' BlockLive rows
// (one scan of those rows); for each 32-key tile of that span it votes
// on whether the tile overlaps a live cell and holds a visible pair
// (each thread reads one key's ids; the vote is also the barrier before
// the tile's loads), and only then loads K, V and the keys' ids; each
// score is masked with the elementwise document test. Live tiles form a
// near-diagonal band on the sorted packed axis, so the work follows the
// documents' visible pairs. No tensor cores, TMA or grid over
// cu_seqlens yet: this is the simple, exact version.

#include "attention_tile.cuh"
#include "varlen_common.cuh"

namespace {

using namespace tl_varlen;

constexpr int BM = 64;  // query rows per block
constexpr int BN = 32;  // keys per tile

template <int D>
constexpr size_t fwd_smem_bytes() {
  return tile_smem_bytes<BM, BN, D>() + sizeof(int) * (2 * BM + 2 * BN + 2);
}

template <int D, int DT, bool PARTIAL>
__global__ void __launch_bounds__(kThreads)
varlen_fwd(const typename Elem<DT>::T* __restrict__ q,
           const typename Elem<DT>::T* __restrict__ k,
           const typename Elem<DT>::T* __restrict__ v,
           const int* __restrict__ seq_q, const int* __restrict__ seq_k,
           const int* __restrict__ pos_q, const int* __restrict__ pos_k,
           const int* __restrict__ live, void* __restrict__ o,
           float* __restrict__ m_out, float* __restrict__ l_out, int group,
           int Tq, int Tk, int bM, int bN, int causal, float scale) {
  constexpr int RM = BM / kTy;  // query rows per thread
  constexpr int CD = D / kTx;   // output columns per thread
  constexpr int LD = D + 1, LP = BN + 1;
  extern __shared__ float smem[];
  float* Qs = smem;          // [BM][LD]
  float* Ks = Qs + BM * LD;  // [BN][LD]
  float* Vs = Ks + BN * LD;  // [BN][LD]
  float* Ps = Vs + BN * LD;  // [BM][LP]
  int* sq = reinterpret_cast<int*>(Ps + BM * LP);  // [BM]
  int* pq = sq + BM;                               // [BM]
  int* sk = pq + BM;                               // [BN]
  int* pk = sk + BN;                               // [BN]
  int* red = pk + BN;                              // [2]

  const int ty = threadIdx.x / kTx, tx = threadIdx.x % kTx;
  const int q0 = blockIdx.x * BM, h = blockIdx.y;
  const long long hkv = h / group;
  const auto* kg = k + hkv * Tk * D;
  const auto* vg = v + hkv * Tk * D;

  load_tile<BM, D, DT, true>(Qs, q + (long long)h * Tq * D, q0, Tq, scale);
  load_ids<BM>(sq, seq_q, q0, Tq, -1);
  load_ids<BM>(pq, pos_q, q0, Tq, 0);

  float m[RM], l[RM], acc[RM][CD];
#pragma unroll
  for (int a = 0; a < RM; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.f;
#pragma unroll
    for (int e = 0; e < CD; ++e) acc[a][e] = 0.f;
  }

  const int nC = Tk / bN, n_kv = (Tk + BN - 1) / BN;
  const Cells rows = cells_of(q0, min(q0 + BM, Tq), bM);
  const Cells span = tiles_of(
      live_span<true>(live, nC, rows, Cells{0, nC - 1}, red), bN, BN, n_kv);
  for (int kb = span.a0; kb <= span.a1; ++kb) {
    const int k0 = kb * BN;
    // the vote is also the barrier: the previous tile's readers are done
    if (!computes_tile<BM, BN, true>(live, nC, rows,
                                     cells_of(k0, min(k0 + BN, Tk), bN), sq,
                                     pq, seq_k, pos_k, k0, Tk, -2, causal))
      continue;
    load_tile<BN, D, DT>(Ks, kg, k0, Tk);
    load_tile<BN, D, DT>(Vs, vg, k0, Tk);
    load_ids<BN>(sk, seq_k, k0, Tk, -2);
    load_ids<BN>(pk, pos_k, k0, Tk, 0);
    __syncthreads();

    // Q is prescaled, so the tile step's scale is 1
    attend_tile<BM, BN, D, DT>(
        Qs, Ks, Vs, Ps, 1.f,
        [&](int a, int c) {
          const int ir = ty + kTy * a, jc = tx + kTx * c;
          return visible(sq[ir], pq[ir], sk[jc], pk[jc], causal);
        },
        m, l, acc);
  }

#pragma unroll
  for (int a = 0; a < RM; ++a) {
    const int i = q0 + ty + kTy * a;
    if (i >= Tq) continue;
    const long long row = (long long)h * Tq + i;
    if constexpr (PARTIAL) {
      float* of = static_cast<float*>(o);
#pragma unroll
      for (int e = 0; e < CD; ++e) of[row * D + tx + kTx * e] = acc[a][e];
      if (tx == 0) {
        m_out[row] = fmaxf(m[a], -1e30f);
        l_out[row] = l[a];
      }
    } else {
      // a row that sees no key gives 0 (the TPU kernel's select)
      const bool seen = l[a] > 0.f;
      auto* ot = static_cast<typename Elem<DT>::T*>(o);
#pragma unroll
      for (int e = 0; e < CD; ++e)
        Elem<DT>::store(ot, row * D + tx + kTx * e,
                        seen ? acc[a][e] / l[a] : 0.f);
    }
  }
}

struct Args {
  const void *q, *k, *v;
  const int *seq_q, *seq_k, *pos_q, *pos_k, *live;
  void* o;
  float *m, *l;
  int Hq, group, Tq, Tk, bM, bN, causal;
  float scale;
};

template <int D, int DT, bool PARTIAL>
int run(const Args& a, cudaStream_t stream) {
  using T = typename Elem<DT>::T;
  const dim3 grid((a.Tq + BM - 1) / BM, a.Hq);
  return launch(varlen_fwd<D, DT, PARTIAL>, grid, fwd_smem_bytes<D>(),
                stream, static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                static_cast<const T*>(a.v), a.seq_q, a.seq_k, a.pos_q, a.pos_k,
                a.live, a.o, a.m, a.l, a.group, a.Tq, a.Tk, a.bM, a.bN,
                a.causal, a.scale);
}

template <int D>
int dispatch(int dt, int partial, const Args& a, cudaStream_t st) {
  return with_elem(dt, [&](auto e) {
    constexpr int DT = decltype(e)::value;
    return partial ? run<D, DT, true>(a, st) : run<D, DT, false>(a, st);
  });
}

}  // namespace

// Launches on `stream`; returns the first CUDA error (0 = launched), or
// cudaErrorInvalidValue for a head_dim without an instance, Hkv that
// does not divide Hq, or a table that does not tile Tq x Tk. `m` and `l`
// are used only when `partial` is set. The Python wrapper checks shapes,
// types and contiguity before calling.
extern "C" int tl_varlen_fwd(const void* q, const void* k, const void* v,
                             const void* seq_q, const void* seq_k,
                             const void* pos_q, const void* pos_k,
                             const void* live, void* o, void* m, void* l,
                             int Hq, int Hkv, int Tq, int Tk, int D,
                             int block_M, int block_N, int dt, int causal,
                             int partial, float scale, void* stream) {
  if (Hkv < 1 || Hq % Hkv || block_M < 1 || block_N < 1 || Tq % block_M ||
      Tk % block_N)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,
               k,
               v,
               static_cast<const int*>(seq_q),
               static_cast<const int*>(seq_k),
               static_cast<const int*>(pos_q),
               static_cast<const int*>(pos_k),
               static_cast<const int*>(live),
               o,
               static_cast<float*>(m),
               static_cast<float*>(l),
               Hq,
               Hq / Hkv,
               Tq,
               Tk,
               block_M,
               block_N,
               causal,
               scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return dispatch<16>(dt, partial, a, st);
    case 32:
      return dispatch<32>(dt, partial, a, st);
    case 64:
      return dispatch<64>(dt, partial, a, st);
    case 128:
      return dispatch<128>(dt, partial, a, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
