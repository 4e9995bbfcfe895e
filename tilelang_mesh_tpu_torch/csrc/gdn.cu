// The Gated DeltaNet chunked forward for Hopper (sm_90a), in two launches.
//
// Replaces one TPU kernel of tilelang_mesh_tpu/ops/gdn.py:
//   gdn_chunk_fwd_kernel (:31) -> tl_gdn_chunk_wy + tl_gdn_chunk_state
//     q / k (B, H, T, K), v / o (B, H, T, V) in float32 or bfloat16,
//     g / beta (B, H, T) float32, T % C == 0. The gated delta rule in
//     the WY form, chunk by chunk, with gc = cumsum(g) inside a chunk:
//       A[i, j] = beta_i (k_i . k_j) exp(gc_i - gc_j), i > j
//       Tm      = (I + A)^-1, float32
//       w = Tm_c (beta e^gc k)_c,   u = Tm_c (beta v)_c
//       attn = (q_i . k_j) exp(gc_i - gc_j), j <= i
//       v_new = (u - w_c state_c)_c
//       o = scale ((e^gc q)_c state_c + attn_c v_new)
//       state = e^gc_last state + (e^(gc_last - gc) k)_c^T v_new
//     with _c the rounding to the input type at the TPU kernel's cast
//     points and a float32 (K, V) state.
//
// The TPU kernel runs all of it in one serial walk over the chunks; on
// 132 SMs that walk is the cost (one block a head and column block, a
// dozen barrier-separated steps a chunk, most of them on values that do
// not depend on the state). So, as the reference's TileLang example
// splits it (chunk_scaled_dot_kkt, wy_fast, chunk_delta_h, chunk_o):
//
// gdn_chunk_wy: one block a (chunk, head, batch), nothing carried. It
//   forms gc, A from k k^T, Tm by blocked substitution (each 16 x 16
//   diagonal block inverted by one warp, column by column, then the
//   blocks merged pairwise: [[T11, 0], [-T22 A21 T11, T22]], log2(C / 16)
//   levels of two float32 products), and writes to scratch what the
//   serial pass reads: w_c, (e^gc q)_c, (e^(gc_last - gc) k)_c and attn_c
//   in the input type, u in float32 and e^gc_last. One float32 C x C
//   buffer holds A below the diagonal, Tm on and below it after the
//   merges, and each merge's T22 A21 T11 operand above it.
// gdn_chunk_state: one block a (column block of V, head, batch), the
//   column block fastest. Per chunk two phases between two barriers:
//     A: v_new = (u - w_c state_c)_c, and (e^gc q)_c state_c into the
//        output tiles' registers;
//     B: o += attn_c v_new (depth up to the tile's diagonal) and out;
//        state = e^gc_last state + kd^T v_new.
//   The float32 state lives in the warps' registers (a warp a tile),
//   its rounding state_c in shared memory. The two phases read disjoint
//   tiles (w, e^gc q, u; kd, attn), so each group's next chunk lands by
//   cp.async while the other phase runs; where both groups do not fit
//   beside each other (the plan's `overlay`), they share one region and
//   each lands before its phase.
// bf16 operands reach mma.sync m16n8k16 through ldmatrix; float32
// products run FFMA (no TF32).
//
// Bound: at bench.py's shape (cfg_gdn_fwd: B 8, H 16, T 4096, K = V =
// 128, bf16) the function moves ~0.54 GB: ~0.16 ms at 3.35 TB/s. The
// scratch adds w, e^gc q, kd (the size of q each), u (twice v's in
// bf16) and attn, written once and read once (the V column blocks of a
// head re-read them from L2).

#include "seqmix.cuh"

namespace {

using namespace tl_seq;

template <typename T>
constexpr bool kF32 = sizeof(T) == 4;

// ---- gdn_chunk_wy ----------------------------------------------------------

template <typename T>
struct WySmem {
  T* ks;       // C x K: k, then (beta e^gc k)_c
  T* qv;       // C x max(K, V): q, then v, then (beta v)_c
  float* f;    // C x C: A, then Tm (see above)
  T* tm;       // C x C: Tm_c (bf16; float32 reads f)
  float* gc;   // C
  float* eg;   // C: g, then exp(gc)
  float* ek;   // C: exp(gc_last - gc)
  float* bt;   // C: beta
  float* stage;   // a warp's 16 x 32 output tile (store_tile)

  __host__ __device__ void carve(Carve& c, int C, int K, int V) {
    ks = c.take<T>(C, K);
    const long long q0 = c.off;
    qv = c.take<T>(C, K);
    const long long q1 = c.off;
    c.off = q0;
    c.take<T>(C, V);
    if (c.off < q1) c.off = q1;
    f = c.take<float>(C, C);
    tm = kF32<T> ? nullptr : c.take<T>(C, C);
    gc = c.take<float>(1, C);
    eg = c.take<float>(1, C);
    ek = c.take<float>(1, C);
    bt = c.take<float>(1, C);
    stage = c.take<float>(16 * kWarps, kStageW<float> - 4);
  }
};

template <typename T>
long long wy_smem(int C, int K, int V) {
  Carve c{nullptr, 0};
  WySmem<T> s;
  s.carve(c, C, K, V);
  return c.off;
}

// a unit-lower triangular block as a product's operand, zero above the
// diagonal (what lies there is scratch): as A, (i, k) at p[i * ld + k];
// as B, (n, k) at p[k * ld + n]
template <bool AS_A>
struct Lower {
  const float* p;
  int ld;
  __device__ __forceinline__ float at(int i, int k) const {
    if (AS_A) return k <= i ? p[i * ld + k] : 0.f;
    return i <= k ? p[k * ld + i] : 0.f;
  }
};

// (I + A)^-1 in place, A strictly below the diagonal of f (C x C, C a
// multiple of 16) on entry, Tm on and below it on return. Ends on a
// barrier.
__device__ void unit_lower_inverse(float* f, int lf, int C) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  // the diagonal blocks: lane j < 16 of a warp forms column j of its
  // block, x_i = [i == j] - sum_{l < i} A[i][l] x_l
  for (int blk = warp; blk < C / 16; blk += kWarps) {
    float* d = f + blk * 16 * (lf + 1);
    const int j = lane & 15;
    float x[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      float s = i == j ? 1.f : 0.f;
#pragma unroll
      for (int l = 0; l < i; ++l) s -= d[i * lf + l] * x[l];
      x[i] = s;
    }
    __syncwarp();
    if (lane < 16)
#pragma unroll
      for (int i = 0; i < 16; ++i) d[i * lf + j] = x[i];
    __syncwarp();
  }
  __syncthreads();
  // merge pairs of s x s blocks: Y = A21 T11 above the diagonal, then
  // T21 = -T22 Y in A21's place
  for (int s = 16; s < C; s *= 2) {
    const int tn = (s + 31) / 32, per = (s / 16) * tn, n = (C / (2 * s)) * per;
    for (int t = warp; t < n; t += kWarps) {
      const int base = 2 * s * (t / per), m0 = (t % per) / tn * 16,
                n0 = (t % per) % tn * 32;
      Frag<float> y;
      y.zero();
      y.mma(Mat<float, true>{f + (base + s) * lf + base, lf},
            Lower<false>{f + base * lf + base, lf}, m0, n0, s, s);
      y.each(m0, n0, s, [&](int i, int c, float& v) {
        f[(base + i) * lf + base + s + c] = v;
      });
    }
    __syncthreads();
    for (int t = warp; t < n; t += kWarps) {
      const int base = 2 * s * (t / per), m0 = (t % per) / tn * 16,
                n0 = (t % per) % tn * 32;
      Frag<float> z;
      z.zero();
      z.mma(Lower<true>{f + (base + s) * (lf + 1), lf},
            Mat<float, false>{f + base * lf + base + s, lf}, m0, n0, s, s);
      z.each(m0, n0, s, [&](int i, int c, float& v) {
        f[(base + s + i) * lf + base + c] = -v;
      });
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gdn_chunk_wy(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ g,
                 const float* __restrict__ beta, T* __restrict__ w_out,
                 float* __restrict__ u_out, T* __restrict__ qg_out,
                 T* __restrict__ kd_out, T* __restrict__ attn_out,
                 float* __restrict__ gate_out, int H, int Tt, int K, int V,
                 int C) {
  extern __shared__ __align__(16) char smem[];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, NC = Tt / C;
  Carve cv{smem, 0};
  WySmem<T> s;
  s.carve(cv, C, K, V);
  const int lk = ld_of<T>(K), lv = ld_of<T>(V), lf = ld_of<float>(C),
            lc = ld_of<T>(C);
  const long long bc = ((long long)b * H + h) * NC + c,
                  t0 = bc * C;      // the chunk's first row of (B H T)

  load_tile_async(s.ks, k + t0 * K, C, K, K);
  load_tile_async(s.qv, q + t0 * K, C, K, K);
  tl_gemm::cp_async_commit();
  for (int i = threadIdx.x; i < C; i += kThreads) {
    s.eg[i] = g[t0 + i];
    s.bt[i] = beta[t0 + i];
  }
  __syncthreads();
  warp_cumsum(s.eg, s.gc, C);
  if (threadIdx.x < 32) {        // warp 0 wrote gc; its lanes finish
    __syncwarp();
    const float last = s.gc[C - 1];
    for (int i = threadIdx.x; i < C; i += 32) {
      s.eg[i] = expf(s.gc[i]);
      s.ek[i] = expf(last - s.gc[i]);
    }
    if (threadIdx.x == 0) gate_out[bc] = expf(last);
  }
  tl_gemm::cp_async_wait<0>();
  __syncthreads();

  // A (strictly lower) and attn_c, the tiles that reach the diagonal;
  // attn's tiles above it are never read
  float* const stf = s.stage + threadIdx.x / 32 * 16 * kStageW<float>;
  T* const stt = reinterpret_cast<T*>(stf);
  const Mat<T, true> kk{s.ks, lk}, qq{s.qv, lk};
  tiles(C, C, [&](int m0, int n0) {
    if (n0 > m0 + 15) return;
    Acc<T> a, p;
    a.zero();
    p.zero();
    a.mma_ld(kk, kk, m0, n0, K, C);
    p.mma_ld(qq, kk, m0, n0, K, C);
    // each pair's decay formed once, in registers before the stores
    a.each2(p, m0, n0, C, [&](int i, int j, float& x, float& y) {
      const float d = expf(s.gc[i] - s.gc[j]);
      x = s.bt[i] * x * d;
      y = i >= j ? y * d : 0.f;
    });
    a.each(m0, n0, C, [&](int i, int j, float& x) {
      if (i > j) s.f[i * lf + j] = x;
    });
    store_tile(p, stt, attn_out + t0 * C, C, m0, n0, C);
  });
  // (e^gc q)_c and (e^(gc_last - gc) k)_c
  pieces<T>(C, K, [&](int r, int c) {
    Piece<T> a, b;
    a.load(s.qv + r * lk + c);
    b.load(s.ks + r * lk + c);
#pragma unroll
    for (int i = 0; i < Piece<T>::V; ++i) {
      a.v[i] *= s.eg[r];
      b.v[i] *= s.ek[r];
    }
    a.store(qg_out + (t0 + r) * K + c);
    b.store(kd_out + (t0 + r) * K + c);
  });
  __syncthreads();

  // v lands in q's place while Tm is formed
  load_tile_async(s.qv, v + t0 * V, C, V, V);
  tl_gemm::cp_async_commit();
  pieces<T>(C, K, [&](int r, int c) {
    Piece<T> a;
    a.load(s.ks + r * lk + c);
#pragma unroll
    for (int i = 0; i < Piece<T>::V; ++i)
      a.v[i] = a.v[i] * s.bt[r] * s.eg[r];
    a.store(s.ks + r * lk + c);
  });
  unit_lower_inverse(s.f, lf, C);
  tl_gemm::cp_async_wait<0>();
  __syncthreads();
  pieces<T>(C, V, [&](int r, int c) {
    Piece<T> a;
    a.load(s.qv + r * lv + c);
#pragma unroll
    for (int i = 0; i < Piece<T>::V; ++i) a.v[i] *= s.bt[r];
    a.store(s.qv + r * lv + c);
  });
  if constexpr (!kF32<T>)
    pieces<T>(C, C, [&](int r, int c) {
      Piece<T> a;
#pragma unroll
      for (int i = 0; i < Piece<T>::V; ++i)
        a.v[i] = c + i <= r ? s.f[r * lf + c + i] : 0.f;
      a.store(s.tm + r * lc + c);
    });
  __syncthreads();

  // w_c = Tm_c (beta e^gc k)_c, u = Tm_c (beta v)_c. Tm_c's rows m0 ..
  // m0 + 15 end at column m0 + 15: zeros up to it (the diagonal blocks'),
  // the merges' scratch only past it
  const Mat<T, true> tm{kF32<T> ? reinterpret_cast<T*>(s.f) : s.tm,
                        kF32<T> ? lf : lc};
  tiles(C, K, [&](int m0, int n0) {
    Acc<T> a;
    a.zero();
    a.mma_ld(tm, Mat<T, false>{s.ks, lk}, m0, n0, m0 + 16, K);
    store_tile(a, stt, w_out + t0 * K, K, m0, n0, K);
  });
  tiles(C, V, [&](int m0, int n0) {
    Acc<T> a;
    a.zero();
    a.mma_ld(tm, Mat<T, false>{s.qv, lv}, m0, n0, m0 + 16, V);
    store_tile(a, stf, u_out + t0 * V, V, m0, n0, V);
  });
}

// ---- gdn_chunk_state -------------------------------------------------------

constexpr int kMaxTiles = 2;   // output and state tiles a warp holds

template <typename T>
struct StateSmem {
  T* w;       // C x K: group A
  T* qg;      // C x K: group A
  float* u;   // C x VB: group A
  T* kd;      // C x K: group B (over group A when `overlay`)
  T* at;      // C x C: group B
  T* vn;      // C x VB: v_new_c
  T* sc;      // K x VB: state_c

  __host__ __device__ void carve(Carve& c, int C, int K, int VB,
                                 bool overlay) {
    const long long a0 = c.off;
    w = c.take<T>(C, K);
    qg = c.take<T>(C, K);
    u = c.take<float>(C, VB);
    const long long a1 = c.off;
    if (overlay) c.off = a0;
    kd = c.take<T>(C, K);
    at = c.take<T>(C, C);
    if (c.off < a1) c.off = a1;
    vn = c.take<T>(C, VB);
    sc = c.take<T>(K, VB);
  }
};

template <typename T>
long long state_smem(int C, int K, int VB, bool overlay) {
  Carve c{nullptr, 0};
  StateSmem<T> s;
  s.carve(c, C, K, VB, overlay);
  return c.off;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    gdn_chunk_state(const T* __restrict__ w, const float* __restrict__ u,
                    const T* __restrict__ qg, const T* __restrict__ kd,
                    const T* __restrict__ attn,
                    const float* __restrict__ gate, T* __restrict__ o, int H,
                    int Tt, int K, int V, int C, int VB, int overlay,
                    float scale) {
  extern __shared__ __align__(16) char smem[];
  const int v0 = blockIdx.x * VB, h = blockIdx.y, b = blockIdx.z,
            NC = Tt / C, warp = threadIdx.x / 32;
  Carve cv{smem, 0};
  StateSmem<T> s;
  s.carve(cv, C, K, VB, overlay != 0);
  const int lk = ld_of<T>(K), lu = ld_of<float>(VB), lc = ld_of<T>(C),
            lv = ld_of<T>(VB);
  const long long bh = (long long)b * H + h;
  // tiles of 16 x 32: no output tiles (C x VB), ns state tiles (K x VB)
  const int tn = (VB + 31) / 32, no = (C / 16) * tn, ns = (K / 16) * tn;
  const Mat<T, false> scv{s.sc, lv}, vnv{s.vn, lv};

  auto issue_a = [&](int c) {
    const long long r0 = bh * Tt + (long long)c * C;
    load_tile_async(s.w, w + r0 * K, C, K, K);
    load_tile_async(s.qg, qg + r0 * K, C, K, K);
    load_tile_async(s.u, u + r0 * V + v0, C, VB, V);
    tl_gemm::cp_async_commit();
  };
  auto issue_b = [&](int c) {
    const long long r0 = bh * Tt + (long long)c * C;
    load_tile_async(s.kd, kd + r0 * K, C, K, K);
    load_tile_async(s.at, attn + r0 * C, C, C, C);
    tl_gemm::cp_async_commit();
  };

  Acc<T> st[kMaxTiles], out[kMaxTiles];
#pragma unroll
  for (int j = 0; j < kMaxTiles; ++j) st[j].zero();
  for (int i = threadIdx.x; i < K * lv; i += kThreads) s.sc[i] = cvt<T>(0.f);
  if (!overlay) issue_a(0);

  for (int c = 0; c < NC; ++c) {
    if (overlay) issue_a(c);
    tl_gemm::cp_async_wait<0>();
    __syncthreads();              // group A landed; the last chunk is done
    if (!overlay) issue_b(c);

    // phase A: (e^gc q)_c state_c into the output tiles, v_new
#pragma unroll
    for (int j = 0; j < kMaxTiles; ++j) {
      const int t = warp + kWarps * j;
      if (t < no) {
        out[j].zero();
        out[j].mma_ld(Mat<T, true>{s.qg, lk}, scv, t / tn * 16, t % tn * 32,
                      K, VB);
      }
    }
    tiles_from(no, no, [&](int t) {
      const int m0 = t / tn * 16, n0 = t % tn * 32;
      Acc<T> a;
      a.zero();
      a.mma_ld(Mat<T, true>{s.w, lk}, scv, m0, n0, K, VB);
      a.each(m0, n0, VB,
             [&](int i, int n, float& x) { x = s.u[i * lu + n] - x; });
      a.put(m0, n0, VB, [&](int i, int n) { return s.vn + i * lv + n; });
    });
    if (overlay) {
      __syncthreads();            // group A's readers are done
      issue_b(c);
    }
    tl_gemm::cp_async_wait<0>();
    __syncthreads();              // group B landed, v_new written
    if (!overlay && c + 1 < NC) issue_a(c + 1);

    // phase B: o += attn_c v_new; state = e^gc_last state + kd^T v_new
    const long long r0 = bh * Tt + (long long)c * C;
#pragma unroll
    for (int j = 0; j < kMaxTiles; ++j) {
      const int t = warp + kWarps * j;
      if (t < no) {
        const int m0 = t / tn * 16, n0 = t % tn * 32;
        out[j].mma_ld(Mat<T, true>{s.at, lc}, vnv, m0, n0, m0 + 16, VB);
        out[j].each(m0, n0, VB, [&](int, int, float& x) { x *= scale; });
        out[j].put(m0, n0, VB,
                   [&](int i, int n) { return o + (r0 + i) * V + v0 + n; });
      }
    }
    const float gt = gate[bh * NC + c];
#pragma unroll
    for (int j = 0; j < kMaxTiles; ++j) {
      const int t = warp + kWarps * j;
      if (t < ns) {
        const int m0 = t / tn * 16, n0 = t % tn * 32;
        Acc<T> x;
        x.zero();
        x.mma_ld(Mat<T, false>{s.kd, lk}, vnv, m0, n0, C, VB);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            st[j].c[a][e] = st[j].c[a][e] * gt + x.c[a][e];
        st[j].put(m0, n0, VB,
                  [&](int d, int n) { return s.sc + d * lv + n; });
      }
    }
    if (overlay) __syncthreads();  // group B's readers are done
  }
}

template <typename T>
int run_wy(const void* q, const void* k, const void* v, const void* g,
           const void* beta, void* w, void* u, void* qg, void* kd,
           void* attn, void* gate, int B, int H, int Tt, int K, int V, int C,
           cudaStream_t st) {
  const dim3 grid(Tt / C, H, B);
  return launch(gdn_chunk_wy<T>, grid, wy_smem<T>(C, K, V), st,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<const float*>(g),
                static_cast<const float*>(beta), static_cast<T*>(w),
                static_cast<float*>(u), static_cast<T*>(qg),
                static_cast<T*>(kd), static_cast<T*>(attn),
                static_cast<float*>(gate), H, Tt, K, V, C);
}

template <typename T>
int run_state(const void* w, const void* u, const void* qg, const void* kd,
              const void* attn, const void* gate, void* o, int B, int H,
              int Tt, int K, int V, int C, int VB, int overlay, float scale,
              cudaStream_t st) {
  const dim3 grid(V / VB, H, B);
  return launch(gdn_chunk_state<T>, grid, state_smem<T>(C, K, VB, overlay),
                st, static_cast<const T*>(w), static_cast<const float*>(u),
                static_cast<const T*>(qg), static_cast<const T*>(kd),
                static_cast<const T*>(attn), static_cast<const float*>(gate),
                static_cast<T*>(o), H, Tt, K, V, C, VB, overlay, scale);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Shared memory a block of each kernel
// needs (ops/gdn.py reckons the same bytes; a card test holds them equal).
extern "C" long long tl_gdn_wy_smem(int dtype, int C, int K, int V) {
  return dtype == 0 ? wy_smem<float>(C, K, V) : wy_smem<bf16>(C, K, V);
}

extern "C" long long tl_gdn_state_smem(int dtype, int C, int K, int VB,
                                       int overlay) {
  return dtype == 0 ? state_smem<float>(C, K, VB, overlay != 0)
                    : state_smem<bf16>(C, K, VB, overlay != 0);
}

// Launch on `stream`; each returns cudaGetLastError() (0 = launched). The
// wrapper checks types, shapes (T % C == 0; C, K, V, VB multiples of 16;
// V % VB == 0; at most 16 output and 16 state tiles of 16 x 32 a block),
// devices, contiguity and 16-byte alignment, and allocates the scratch:
// w, qg, kd (B, H, T, K) and attn (B, H, T, C) in the input type, u
// (B, H, T, V) and gate (B, H, T / C) float32.
extern "C" int tl_gdn_chunk_wy(const void* q, const void* k, const void* v,
                               const void* g, const void* beta, void* w,
                               void* u, void* qg, void* kd, void* attn,
                               void* gate, int B, int H, int Tt, int K,
                               int V, int C, int dtype, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run_wy<float>(q, k, v, g, beta, w, u, qg, kd, attn, gate, B, H,
                         Tt, K, V, C, st);
  return run_wy<bf16>(q, k, v, g, beta, w, u, qg, kd, attn, gate, B, H, Tt,
                      K, V, C, st);
}

extern "C" int tl_gdn_chunk_state(const void* w, const void* u,
                                  const void* qg, const void* kd,
                                  const void* attn, const void* gate, void* o,
                                  int B, int H, int Tt, int K, int V, int C,
                                  int VB, int overlay, float scale, int dtype,
                                  void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run_state<float>(w, u, qg, kd, attn, gate, o, B, H, Tt, K, V, C,
                            VB, overlay, scale, st);
  return run_state<bf16>(w, u, qg, kd, attn, gate, o, B, H, Tt, K, V, C, VB,
                         overlay, scale, st);
}
