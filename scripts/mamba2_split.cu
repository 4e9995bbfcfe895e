// mamba_ssm's split of the Mamba2 SSD chunk scan, for the A/B against
// csrc/mamba2.cu's one serial walk (scripts/seqmix_ab.py builds it beside
// the port's sources and times it; the port does not call it).
//
// The same function and the same roundings as csrc/mamba2.cu, in three
// launches:
//   m2s_chunk_state  one block a (chunk, head, batch): the chunk's
//                    bdec^T X (N x P, float32) and cum_last, to scratch;
//   m2s_state_pass   one thread four (n, p) of a (head, batch): walks the
//                    chunks, writing state_c (the state before each
//                    chunk, rounded to the input type) and folding in
//                    state = exp(cum_last) state + bdec^T X;
//   m2s_chunk_scan   one block a (chunk, head, batch): y = att_c X +
//                    cdec state_c, att's rows in strips of R through a
//                    ring of two strips of C, as in csrc/mamba2.cu.
// Scratch at bench's shape (B 8, S 4096, H 80, P 64, N 128, chunk 128):
// 671 MB of float32 chunk states, 335 MB (bf16) of state_c.

#include "seqmix.cuh"

namespace {

using namespace tl_seq;

// ---- m2s_chunk_state --------------------------------------------------------

template <typename T>
struct CsSmem {
  T* xs;        // L x P
  T* bs;        // L x N: B, then bdec
  float* dt;    // L
  float* cum;   // L
  float* el;    // L: exp(cum_last - cum)
  float* stage;

  __host__ __device__ void carve(Carve& c, int L, int N, int P) {
    xs = c.take<T>(L, P);
    bs = c.take<T>(L, N);
    dt = c.take<float>(1, L);
    cum = c.take<float>(1, L);
    el = c.take<float>(1, L);
    stage = c.take<float>(16 * kWarps, kStageW<float> - 4);
  }
};

template <typename T>
long long cs_smem(int L, int N, int P) {
  Carve c{nullptr, 0};
  CsSmem<T> s;
  s.carve(c, L, N, P);
  return c.off;
}

// the chunk's scan by warp 0: cum = a cumsum(dt), el = exp(last - cum);
// ends on a barrier
__device__ void scan(float* dt, float* cum, float* el, float* ec, int L,
                     float a) {
  warp_cumsum(dt, cum, L);
  if (threadIdx.x < 32) {
    __syncwarp();
    for (int i = threadIdx.x; i < L; i += 32) cum[i] *= a;
    __syncwarp();
    const float last = cum[L - 1];
    for (int i = threadIdx.x; i < L; i += 32) {
      if (el) el[i] = expf(last - cum[i]);
      if (ec) ec[i] = expf(cum[i]);
    }
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    m2s_chunk_state(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    float* __restrict__ states, float* __restrict__ lasts,
                    int S, int H, int P, int N, int L, long long xsb,
                    long long xss, long long xsh) {
  extern __shared__ __align__(16) char smem[];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, NC = S / L;
  Carve cv{smem, 0};
  CsSmem<T> s;
  s.carve(cv, L, N, P);
  const int lx = ld_of<T>(P), lb = ld_of<T>(N), c0 = c * L;
  const long long bhc = ((long long)b * H + h) * NC + c;
  load_tile_async(s.xs, x + b * xsb + h * xsh + c0 * xss, L, P, xss);
  load_tile_async(s.bs, Bm + ((long long)b * S + c0) * N, L, N, N);
  tl_gemm::cp_async_commit();
  for (int i = threadIdx.x; i < L; i += kThreads)
    s.dt[i] = dt[((long long)b * S + c0 + i) * H + h];
  tl_gemm::cp_async_wait<0>();
  __syncthreads();
  scan(s.dt, s.cum, s.el, nullptr, L, A[h]);
  if (threadIdx.x == 0) lasts[bhc] = s.cum[L - 1];
  pieces<T>(L, N, [&](int r, int n) {
    Piece<T> p;
    p.load(s.bs + r * lb + n);
#pragma unroll
    for (int i = 0; i < Piece<T>::V; ++i) p.v[i] = p.v[i] * s.dt[r] * s.el[r];
    p.store(s.bs + r * lb + n);
  });
  __syncthreads();
  float* stf = s.stage + threadIdx.x / 32 * 16 * kStageW<float>;
  tiles(N, P, [&](int m0, int n0) {
    Acc<T> f;
    f.zero();
    f.mma_ld(Mat<T, false>{s.bs, lb}, Mat<T, false>{s.xs, lx}, m0, n0, L, P);
    store_tile(f, stf, states + bhc * N * P, P, m0, n0, P);
  });
}

// ---- m2s_state_pass ---------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
    m2s_state_pass(const float* __restrict__ states,
                   const float* __restrict__ lasts, T* __restrict__ st_out,
                   int H, int NC, int NP) {
  const int e = (blockIdx.x * kThreads + threadIdx.x) * 4;
  if (e >= NP) return;
  const long long bh = (long long)blockIdx.z * H + blockIdx.y;
  float st[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c = 0; c < NC; ++c) {
    const long long at = (bh * NC + c) * NP + e;
    const float4 add = *reinterpret_cast<const float4*>(states + at);
    const float gate = expf(lasts[bh * NC + c]);
#pragma unroll
    for (int i = 0; i < 4; ++i) st_out[at + i] = cvt<T>(st[i]);
    st[0] = st[0] * gate + add.x;
    st[1] = st[1] * gate + add.y;
    st[2] = st[2] * gate + add.z;
    st[3] = st[3] * gate + add.w;
  }
}

// ---- m2s_chunk_scan ---------------------------------------------------------

template <typename T>
struct ScSmem {
  T* xs;
  T* bs;
  float* dt;
  float* cum;
  float* ec;
  T* cr0;
  T* cr1;
  T* cd;
  T* att;
  T* st;

  __host__ __device__ void carve(Carve& c, int L, int N, int P, int R) {
    xs = c.take<T>(L, P);
    bs = c.take<T>(L, N);
    dt = c.take<float>(1, L);
    cum = c.take<float>(1, L);
    ec = c.take<float>(1, L);
    cr0 = c.take<T>(R, N);
    cr1 = c.take<T>(R, N);
    cd = c.take<T>(R, N);
    att = c.take<T>(R, L);
    st = c.take<T>(N, P);
  }
};

template <typename T>
long long sc_smem(int L, int N, int P, int R) {
  Carve c{nullptr, 0};
  ScSmem<T> s;
  s.carve(c, L, N, P, R);
  return c.off;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    m2s_chunk_scan(const T* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const T* __restrict__ Bm,
                   const T* __restrict__ Cm, const T* __restrict__ st_in,
                   T* __restrict__ y, int S, int H, int P, int N, int L,
                   int R, long long xsb, long long xss, long long xsh,
                   long long ysb, long long yss, long long ysh) {
  extern __shared__ __align__(16) char smem[];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, NC = S / L;
  Carve cv{smem, 0};
  ScSmem<T> s;
  s.carve(cv, L, N, P, R);
  const int lx = ld_of<T>(P), lb = ld_of<T>(N), la = ld_of<T>(L),
            c0 = c * L;
  const long long bhc = ((long long)b * H + h) * NC + c;
  const T* cb = Cm + ((long long)b * S + c0) * N;
  T* yb = y + b * ysb + h * ysh;
  auto issue_strip = [&](int gs) {
    load_tile_async(gs & 1 ? s.cr1 : s.cr0, cb + (long long)gs * R * N, R,
                    N, N);
    tl_gemm::cp_async_commit();
  };
  issue_strip(0);
  load_tile_async(s.xs, x + b * xsb + h * xsh + c0 * xss, L, P, xss);
  load_tile_async(s.bs, Bm + ((long long)b * S + c0) * N, L, N, N);
  load_tile_async(s.st, st_in + bhc * N * P, N, P, P);
  tl_gemm::cp_async_commit();
  for (int i = threadIdx.x; i < L; i += kThreads)
    s.dt[i] = dt[((long long)b * S + c0 + i) * H + h];
  tl_gemm::cp_async_wait<0>();
  __syncthreads();
  scan(s.dt, s.cum, nullptr, s.ec, L, A[h]);
  const Mat<T, false> xv{s.xs, lx}, stv{s.st, lx};
  for (int r0 = 0, gs = 0; r0 < L; r0 += R, ++gs) {
    if (r0 + R < L) {
      issue_strip(gs + 1);
      tl_gemm::cp_async_wait<1>();
    } else {
      tl_gemm::cp_async_wait<0>();
    }
    __syncthreads();
    const T* cs = gs & 1 ? s.cr1 : s.cr0;
    const int ncol = r0 + R;
    tiles(R, ncol, [&](int m0, int n0) {
      if (n0 > r0 + m0 + 15) return;
      Acc<T> f;
      f.zero();
      f.mma_ld(Mat<T, true>{cs, lb}, Mat<T, true>{s.bs, lb}, m0, n0, N,
               ncol);
      f.each(m0, n0, ncol, [&](int m, int n, float& v) {
        const int i = r0 + m;
        const float e =
            i >= n ? v * s.dt[n] * expf(fminf(s.cum[i] - s.cum[n], 0.f))
                   : 0.f;
        s.att[m * la + n] = cvt<T>(e);
      });
    });
    pieces<T>(R, N, [&](int m, int n) {
      Piece<T> p;
      p.load(cs + m * lb + n);
#pragma unroll
      for (int i = 0; i < Piece<T>::V; ++i) p.v[i] *= s.ec[r0 + m];
      p.store(s.cd + m * lb + n);
    });
    __syncthreads();
    tiles(R, P, [&](int m0, int n0) {
      Acc<T> f;
      f.zero();
      f.mma_ld(Mat<T, true>{s.att, la}, xv, m0, n0, r0 + m0 + 16, P);
      f.mma_ld(Mat<T, true>{s.cd, lb}, stv, m0, n0, N, P);
      f.each(m0, n0, P, [&](int m, int n, float& v) {
        yb[(long long)(c0 + r0 + m) * yss + n] = cvt<T>(v);
      });
    });
  }
}

}  // namespace

// kernel: 0 chunk_state, 1 chunk_scan; dtype 0 float32, 1 bfloat16
extern "C" long long tl_m2s_smem(int kernel, int dtype, int L, int N, int P,
                                 int R) {
  if (kernel == 0)
    return dtype == 0 ? cs_smem<float>(L, N, P) : cs_smem<bf16>(L, N, P);
  return dtype == 0 ? sc_smem<float>(L, N, P, R) : sc_smem<bf16>(L, N, P, R);
}

template <typename T>
int run_split(const void* x, const void* dt, const void* A, const void* Bm,
              const void* Cm, void* states, void* lasts, void* st, void* y,
              int B, int S, int H, int P, int N, int L, int R,
              const long long* xs, const long long* ys, int only,
              cudaStream_t s) {
  const int NC = S / L;
  int e = 0;
  if (only < 0 || only == 0)
    e = launch(m2s_chunk_state<T>, dim3(NC, H, B), cs_smem<T>(L, N, P), s,
               static_cast<const T*>(x), static_cast<const float*>(dt),
               static_cast<const float*>(A), static_cast<const T*>(Bm),
               static_cast<float*>(states), static_cast<float*>(lasts), S, H,
               P, N, L, xs[0], xs[1], xs[2]);
  if (e) return e;
  const int NP = N * P;
  if (only < 0 || only == 1)
    e = launch(m2s_state_pass<T>,
               dim3((NP / 4 + kThreads - 1) / kThreads, H, B), 0, s,
               static_cast<const float*>(states),
               static_cast<const float*>(lasts), static_cast<T*>(st), H, NC,
               NP);
  if (e) return e;
  if (only >= 0 && only != 2) return 0;
  return launch(m2s_chunk_scan<T>, dim3(NC, H, B), sc_smem<T>(L, N, P, R), s,
                static_cast<const T*>(x), static_cast<const float*>(dt),
                static_cast<const float*>(A), static_cast<const T*>(Bm),
                static_cast<const T*>(Cm), static_cast<const T*>(st),
                static_cast<T*>(y), S, H, P, N, L, R, xs[0], xs[1], xs[2],
                ys[0], ys[1], ys[2]);
}

// The three launches on `stream`; states (B, H, S / L, N, P) and lasts
// (B, H, S / L) float32, st (B, H, S / L, N, P) in x's type: scratch the
// caller allocates. `only` >= 0 launches that one of the three alone (for
// the breakdown). Returns the first cudaGetLastError() that is not 0.
extern "C" int tl_m2s_split(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm, void* states,
                            void* lasts, void* st, void* y, int B, int S,
                            int H, int P, int N, int L, int R,
                            const long long* x_st, const long long* y_st,
                            int only, int dtype, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run_split<float>(x, dt, A, Bm, Cm, states, lasts, st, y, B, S, H,
                            P, N, L, R, x_st, y_st, only, s);
  return run_split<bf16>(x, dt, A, Bm, Cm, states, lasts, st, y, B, S, H, P,
                         N, L, R, x_st, y_st, only, s);
}
