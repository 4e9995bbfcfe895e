// The Gated DeltaNet chunked forward for Hopper (sm_90a).
//
// Replaces one TPU kernel of tilelang_mesh_tpu/ops/gdn.py:
//   gdn_chunk_fwd_kernel (:31) -> tl_gdn_chunk_fwd
//     q / k (B, H, T, K), v / o (B, H, T, V) in float32 or bfloat16,
//     g / beta (B, H, T) float32, T % C == 0. The gated delta rule in
//     the WY form, chunk by chunk, with gc = cumsum(g) inside a chunk:
//       N[i, j] = -beta_i (k_i . k_j) exp(gc_i - gc_j), i > j
//       Tm      = (I - N)^-1 = (I + A)^-1 by Neumann doubling: S = I + N,
//                 P = N, then (P <- P P; S <- S + P S) bit_length(C-1) - 1
//                 times, all float32
//       w = Tm_c (beta e^gc k)_c,   u = Tm_c (beta v)_c
//       attn = (q_i . k_j) exp(gc_i - gc_j), j <= i
//       v_new = (u - w_c state_c)_c
//       o = scale ((e^gc q)_c state_c + attn_c v_new)
//       state = e^gc_last state + (e^(gc_last - gc) k)_c^T v_new
//     with _c the rounding to the input type at the TPU kernel's cast
//     points and a float32 (K, V) state.
//
// One block of 256 threads a (head, batch, column block of V): the V
// columns of the state, v_new and o are independent, so a block may take
// VB < V of them (the wrapper picks VB to fit shared memory; the key
// side, up to w and attn, is then computed by each of them). In shared
// memory: q (then e^gc q in place), k (then its decayed copy in place),
// the float32 state (K x VB), attn (C x C), and a work area that holds
// the four float32 C x C matrices of the doubling and then w, beta v and
// v_new, beside the last S (= Tm, read rounded where it is an operand).
// (beta e^gc k)_c is formed as the product reads it, from k. bf16
// products run mma.sync m16n8k16, float32 ones (the doubling, and every
// product in a float32 call) FFMA. Chunks up to 64 fit at K = V = 128;
// the doubling's four float32 C x C matrices alone exceed shared memory
// at C = 128.
//
// Bound: at bench.py's shape (cfg_gdn_fwd: B 8, H 16, T 4096, K = V =
// 128, bf16) the call moves ~0.54 GB and does ~60 GFLOP by bench's
// count: bytes, ~0.16 ms at 3.35 TB/s. With VB = V there are H B = 128
// blocks, under one wave of 132 SMs, each running 64 chunks in turn, ten
// products and the doubling's 2 log2(C) float32 ones each, between
// block-wide barriers: latency-bound by construction.

#include "seqmix.cuh"

namespace {

using namespace tl_seq;

template <typename T>
struct Smem {
  T* qs;          // C x K: q, then (e^gc q)_c
  T* ks;          // C x K: k, then (e^(gc_last - gc) k)_c
  float* state;   // K x VB
  T* attn;        // C x C
  float* gc;      // C
  float* eg;      // C: exp(gc)
  float* bt;      // C: beta
  float* f[4];    // C x C float32: P, P2, and the two S slots
  T* wc;          // C x K
  T* vb;          // C x VB
  T* vn;          // C x VB

  // f[3] is where the last S lands (n_double decides which
  // of f[2], f[3] holds the first); w, beta v and v_new overlay f[0..2]
  // when they fit there, else follow f[3]
  __host__ __device__ void carve(Carve& c, int C, int K, int VB) {
    qs = c.take<T>(C, K);
    ks = c.take<T>(C, K);
    state = c.take<float>(K, VB);
    attn = c.take<T>(C, C);
    gc = c.take<float>(1, C);
    eg = c.take<float>(1, C);
    bt = c.take<float>(1, C);
    const long long w0 = c.off, ccf = bytes_of<float>(C, C);
    for (int i = 0; i < 4; ++i) f[i] = c.take<float>(C, C);
    const long long need = bytes_of<T>(C, K) + 2 * bytes_of<T>(C, VB);
    if (need <= 3 * ccf) c.off = w0;
    wc = c.take<T>(C, K);
    vb = c.take<T>(C, VB);
    vn = c.take<T>(C, VB);
    if (c.off < w0 + 4 * ccf) c.off = w0 + 4 * ccf;
  }
};

template <typename T>
long long smem_bytes(int C, int K, int VB) {
  Carve c{nullptr, 0};
  Smem<T> s;
  s.carve(c, C, K, VB);
  return c.off;
}

// (beta e^gc k)_c as the B operand of Tm_c @ it: (i = d, k = j) is
// ((k[j][d] beta_j) e^gc_j) rounded to T
template <typename T>
struct Kb {
  const T* p;
  int ld;
  const float* bt;
  const float* eg;
  __device__ __forceinline__ T val(int d, int j) const {
    return cvt<T>(to_f(p[j * ld + d]) * bt[j] * eg[j]);
  }
  __device__ __forceinline__ float at(int d, int j) const {
    return to_f(val(d, j));
  }
  __device__ __forceinline__ uint32_t pair(int d, int j) const {
    return pack(val(d, j), val(d, j + 1));       // T = bf16
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gdn_chunk_fwd(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ g,
                  const float* __restrict__ beta, T* __restrict__ o, int H,
                  int Tt, int K, int V, int C, int VB, int n_double,
                  float scale) {
  extern __shared__ __align__(16) char smem[];
  const int h = blockIdx.x, b = blockIdx.y, v0 = blockIdx.z * VB;
  Carve cv{smem, 0};
  Smem<T> s;
  s.carve(cv, C, K, VB);
  const int lk = ld_of<T>(K), ls = ld_of<float>(VB), lc = ld_of<T>(C),
            lf = ld_of<float>(C), lv = ld_of<T>(VB);
  const long long bh = (long long)b * H + h;
  using TmV = typename AsT<T, true>::V;
  using StateV = typename AsT<T, false>::V;   // (i = n, k = d): state[d][n]

  for (int i = threadIdx.x; i < K * ls; i += kThreads) s.state[i] = 0.f;

  for (int c0 = 0; c0 < Tt; c0 += C) {
    __syncthreads();      // the last chunk's readers are done
    const long long t0 = bh * Tt + c0;
    load_tile(s.qs, q + t0 * K, C, K, K);
    load_tile(s.ks, k + t0 * K, C, K, K);
    for (int i = threadIdx.x; i < C; i += kThreads) {
      s.eg[i] = g[t0 + i];          // g, until the scan
      s.bt[i] = beta[t0 + i];
    }
    __syncthreads();
    warp_cumsum(s.eg, s.gc, C);
    __syncthreads();
    for (int i = threadIdx.x; i < C; i += kThreads) s.eg[i] = expf(s.gc[i]);
    __syncthreads();

    // the doubling's slots, so that the last S is f[3]
    float* pm = s.f[0];
    float* p2 = s.f[1];
    float* sm = (n_double % 2 == 0) ? s.f[3] : s.f[2];
    float* s2 = (n_double % 2 == 0) ? s.f[2] : s.f[3];

    // N (into P and S = I + N) and attn
    tiles(C, C, [&](int m0, int n0) {
      Frag<T> f;
      f.zero();
      f.mma(Mat<T, true>{s.ks, lk}, Mat<T, true>{s.ks, lk}, m0, n0, K, C);
      f.each(m0, n0, C, [&](int i, int j, float& x) {
        const float nm =
            i > j ? -s.bt[i] * x * expf(s.gc[i] - s.gc[j]) : 0.f;
        pm[i * lf + j] = nm;
        sm[i * lf + j] = nm + (i == j ? 1.f : 0.f);
      });
    });
    tiles(C, C, [&](int m0, int n0) {
      Frag<T> f;
      f.zero();
      f.mma(Mat<T, true>{s.qs, lk}, Mat<T, true>{s.ks, lk}, m0, n0, K, C);
      f.each(m0, n0, C, [&](int i, int j, float& x) {
        s.attn[i * lc + j] =
            cvt<T>(i >= j ? x * expf(s.gc[i] - s.gc[j]) : 0.f);
      });
    });
    __syncthreads();

    // Neumann doubling, float32
    for (int it = 0; it < n_double; ++it) {
      tiles(C, C, [&](int m0, int n0) {
        Frag<float> f;
        f.zero();
        f.mma(Mat<float, true>{pm, lf}, Mat<float, false>{pm, lf}, m0, n0, C,
              C);
        f.each(m0, n0, C, [&](int i, int j, float& x) { p2[i * lf + j] = x; });
      });
      __syncthreads();
      tiles(C, C, [&](int m0, int n0) {
        Frag<float> f;
        f.zero();
        f.mma(Mat<float, true>{p2, lf}, Mat<float, false>{sm, lf}, m0, n0, C,
              C);
        f.each(m0, n0, C, [&](int i, int j, float& x) {
          s2[i * lf + j] = sm[i * lf + j] + x;
        });
      });
      __syncthreads();
      float* t = pm; pm = p2; p2 = t;
      t = sm; sm = s2; s2 = t;
    }
    const TmV tm{sm, lf};

    // w_c = Tm_c (beta e^gc k)_c; (beta v)_c
    tiles(C, K, [&](int m0, int n0) {
      Frag<T> f;
      f.zero();
      f.mma(tm, Kb<T>{s.ks, lk, s.bt, s.eg}, m0, n0, C, K);
      f.each(m0, n0, K, [&](int i, int d, float& x) {
        s.wc[i * lk + d] = cvt<T>(x);
      });
    });
    for (int i = threadIdx.x; i < C * VB; i += kThreads) {
      const int r = i / VB, n = i % VB;
      s.vb[r * lv + n] = cvt<T>(to_f(v[(t0 + r) * V + v0 + n]) * s.bt[r]);
    }
    __syncthreads();

    // v_new = (u - w_c state_c)_c; k and q take their decayed forms
    tiles(C, VB, [&](int m0, int n0) {
      Frag<T> fu, fw;
      fu.zero();
      fw.zero();
      fu.mma(tm, Mat<T, false>{s.vb, lv}, m0, n0, C, VB);
      fw.mma(Mat<T, true>{s.wc, lk}, StateV{s.state, ls}, m0, n0, K, VB);
      fu.sub(fw);
      fu.each(m0, n0, VB, [&](int i, int n, float& x) {
        s.vn[i * lv + n] = cvt<T>(x);
      });
    });
    const float glast = s.gc[C - 1];
    for (int i = threadIdx.x; i < C * K; i += kThreads) {
      const int r = i / K, d = i % K;
      T& kv = s.ks[r * lk + d];
      kv = cvt<T>(to_f(kv) * expf(glast - s.gc[r]));
      T& qv = s.qs[r * lk + d];
      qv = cvt<T>(to_f(qv) * s.eg[r]);
    }
    __syncthreads();

    // o = scale ((e^gc q)_c state_c + attn_c v_new)
    tiles(C, VB, [&](int m0, int n0) {
      Frag<T> f;
      f.zero();
      f.mma(Mat<T, true>{s.qs, lk}, StateV{s.state, ls}, m0, n0, K, VB);
      f.mma(Mat<T, true>{s.attn, lc}, Mat<T, false>{s.vn, lv}, m0, n0, C, VB);
      f.each(m0, n0, VB, [&](int i, int n, float& x) {
        o[(t0 + i) * V + v0 + n] = cvt<T>(x * scale);
      });
    });
    __syncthreads();

    // state = e^gc_last state + kd_c^T v_new
    const float gate = expf(glast);
    tiles(K, VB, [&](int m0, int n0) {
      Frag<T> f;
      f.zero();
      f.mma(Mat<T, false>{s.ks, lk}, Mat<T, false>{s.vn, lv}, m0, n0, C, VB);
      f.each(m0, n0, VB, [&](int d, int n, float& x) {
        float& st = s.state[d * ls + n];
        st = st * gate + x;
      });
    });
  }
}

template <typename T>
int run(const void* q, const void* k, const void* v, const void* g,
        const void* beta, void* o, int B, int H, int Tt, int K, int V, int C,
        int VB, float scale, cudaStream_t st) {
  int n_double = 0;                 // bit_length(C - 1) - 1, at least 0
  for (int x = C - 1; x > 1; x >>= 1) ++n_double;
  const dim3 grid(H, B, V / VB);
  return launch(gdn_chunk_fwd<T>, grid, smem_bytes<T>(C, K, VB), st,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<const float*>(g),
                static_cast<const float*>(beta), static_cast<T*>(o), H, Tt,
                K, V, C, VB, n_double, scale);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Shared memory a block needs.
extern "C" long long tl_gdn_smem(int dtype, int C, int K, int VB) {
  return dtype == 0 ? smem_bytes<float>(C, K, VB)
                    : smem_bytes<bf16>(C, K, VB);
}

// Launches on `stream`; returns cudaGetLastError() (0 = launched). The
// wrapper checks types, shapes (T % C == 0; C, K, V, VB multiples of 16;
// V % VB == 0), devices, contiguity and 16-byte alignment.
extern "C" int tl_gdn_chunk_fwd(const void* q, const void* k, const void* v,
                                const void* g, const void* beta, void* o,
                                int B, int H, int Tt, int K, int V, int C,
                                int VB, float scale, int dtype,
                                void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(q, k, v, g, beta, o, B, H, Tt, K, V, C, VB, scale, st);
  return run<bf16>(q, k, v, g, beta, o, B, H, Tt, K, V, C, VB, scale, st);
}
