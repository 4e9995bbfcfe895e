// The other place for GDN's attn_c, for the A/B against csrc/gdn.cu
// (scripts/seqmix_ab.py builds it beside the port's sources and times it;
// the port does not call it).
//
// csrc/gdn.cu forms attn_c in the chunk-parallel gdn_chunk_wy and the
// serial gdn_chunk_state reads it from scratch. Here gdn_chunk_state_qk
// forms it itself, from q and k, which its load group B brings beside kd
// (g too: the block scans it for gc, as gdn_chunk_wy does, so attn_c has
// the same bits); the WY kernel then need not write it (seqmix_ab.py
// times a copy of gdn_chunk_wy without it). Per chunk, after group B
// lands: gc, then attn_c's tiles that reach the diagonal, then phase B
// as in gdn_chunk_state. Two barriers more a chunk, q and k (C x K each)
// read a column block in place of attn_c (C x C).

#include "gdn.cu"

namespace {

template <typename T>
struct QkSmem {
  T* w;       // C x K: group A
  T* qg;      // C x K: group A
  float* u;   // C x VB: group A
  T* kd;      // C x K: group B (over group A when `overlay`)
  T* q;       // C x K: group B
  T* k;       // C x K: group B
  float* g;   // C: group B
  T* at;      // C x C: attn_c, formed here
  T* vn;      // C x VB: v_new_c
  T* sc;      // K x VB: state_c
  float* gc;  // C

  __host__ __device__ void carve(Carve& c, int C, int K, int VB,
                                 bool overlay) {
    const long long a0 = c.off;
    w = c.take<T>(C, K);
    qg = c.take<T>(C, K);
    u = c.take<float>(C, VB);
    const long long a1 = c.off;
    if (overlay) c.off = a0;
    kd = c.take<T>(C, K);
    q = c.take<T>(C, K);
    k = c.take<T>(C, K);
    g = c.take<float>(1, C);
    if (c.off < a1) c.off = a1;
    at = c.take<T>(C, C);
    vn = c.take<T>(C, VB);
    sc = c.take<T>(K, VB);
    gc = c.take<float>(1, C);
  }
};

template <typename T>
long long qk_smem(int C, int K, int VB, bool overlay) {
  Carve c{nullptr, 0};
  QkSmem<T> s;
  s.carve(c, C, K, VB, overlay);
  return c.off;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    gdn_chunk_state_qk(const T* __restrict__ w, const float* __restrict__ u,
                       const T* __restrict__ qg, const T* __restrict__ kd,
                       const T* __restrict__ q, const T* __restrict__ k,
                       const float* __restrict__ g,
                       const float* __restrict__ gate, T* __restrict__ o,
                       int H, int Tt, int K, int V, int C, int VB,
                       int overlay, float scale) {
  extern __shared__ __align__(16) char smem[];
  const int v0 = blockIdx.x * VB, h = blockIdx.y, b = blockIdx.z,
            NC = Tt / C, warp = threadIdx.x / 32;
  Carve cv{smem, 0};
  QkSmem<T> s;
  s.carve(cv, C, K, VB, overlay != 0);
  const int lk = ld_of<T>(K), lu = ld_of<float>(VB), lc = ld_of<T>(C),
            lv = ld_of<T>(VB);
  const long long bh = (long long)b * H + h;
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
    load_tile_async(s.q, q + r0 * K, C, K, K);
    load_tile_async(s.k, k + r0 * K, C, K, K);
    load_tile_async(s.g, g + r0, 1, C, C);
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
    __syncthreads();
    if (!overlay) issue_b(c);

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
      __syncthreads();
      issue_b(c);
    }
    tl_gemm::cp_async_wait<0>();
    __syncthreads();              // group B landed, v_new written
    if (!overlay && c + 1 < NC) issue_a(c + 1);
    warp_cumsum(s.g, s.gc, C);
    __syncthreads();
    tiles(C, C, [&](int m0, int n0) {
      if (n0 > m0 + 15) return;
      Acc<T> p;
      p.zero();
      p.mma_ld(Mat<T, true>{s.q, lk}, Mat<T, true>{s.k, lk}, m0, n0, K, C);
      p.each(m0, n0, C, [&](int i, int j, float& x) {
        x = i >= j ? x * expf(s.gc[i] - s.gc[j]) : 0.f;
      });
      p.put(m0, n0, C, [&](int i, int j) { return s.at + i * lc + j; });
    });
    __syncthreads();              // attn_c formed

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
    if (overlay) __syncthreads();
  }
}

template <typename T>
int run_state_qk(const void* w, const void* u, const void* qg,
                 const void* kd, const void* q, const void* k, const void* g,
                 const void* gate, void* o, int B, int H, int Tt, int K,
                 int V, int C, int VB, int overlay, float scale,
                 cudaStream_t st) {
  return launch(gdn_chunk_state_qk<T>, dim3(V / VB, H, B),
                qk_smem<T>(C, K, VB, overlay), st,
                static_cast<const T*>(w), static_cast<const float*>(u),
                static_cast<const T*>(qg), static_cast<const T*>(kd),
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const float*>(g),
                static_cast<const float*>(gate), static_cast<T*>(o), H, Tt,
                K, V, C, VB, overlay, scale);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16
extern "C" long long tl_gdn_state_qk_smem(int dtype, int C, int K, int VB,
                                          int overlay) {
  return dtype == 0 ? qk_smem<float>(C, K, VB, overlay != 0)
                    : qk_smem<bf16>(C, K, VB, overlay != 0);
}

// gdn_chunk_state's launch with q, k (B, H, T, K) and g (B, H, T) in
// place of attn; the same checks as tl_gdn_chunk_state
extern "C" int tl_gdn_chunk_state_qk(const void* w, const void* u,
                                     const void* qg, const void* kd,
                                     const void* q, const void* k,
                                     const void* g, const void* gate,
                                     void* o, int B, int H, int Tt, int K,
                                     int V, int C, int VB, int overlay,
                                     float scale, int dtype, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run_state_qk<float>(w, u, qg, kd, q, k, g, gate, o, B, H, Tt, K,
                               V, C, VB, overlay, scale, st);
  return run_state_qk<bf16>(w, u, qg, kd, q, k, g, gate, o, B, H, Tt, K, V,
                            C, VB, overlay, scale, st);
}
