// The Mamba2 SSD chunk scan for Hopper (sm_90a).
//
// Replaces one TPU kernel of tilelang_mesh_tpu/ops/mamba2.py:
//   mamba2_chunk_scan_kernel (:25) -> tl_mamba2_chunk_scan
//     x (B, S, H, P) read through its strides, dt (B, S, H) float32,
//     A (H,) float32, Bm / Cm (B, S, N); y (B, S, H, P) in x's type
//     (float32 or bfloat16). Chunks of `chunk` steps in order; within a
//     chunk, with cum = A_h cumsum(dt) (inclusive, f32):
//       att[i, j] = (C_i . B_j) dt_j exp(min(cum_i - cum_j, 0)), i >= j
//       y_i       = att_c[i, :] @ X + (C_i exp(cum_i))_c @ state_c
//       state     = exp(cum_last) state + (B_j dt_j exp(cum_last - cum_j))_c^T X
//     where _c is a rounding to the input type at the TPU kernel's cast
//     points (att_c, cdec, state_c, bdec, the output) and the state is
//     float32. The pairwise decay is clamped and the mask is a select,
//     as in the TPU kernel, so a long chunk with strong decay cannot
//     overflow into inf * 0.
//
// One block of 256 threads a (head, batch, column block of P): the P
// columns of the state and the output are independent, so a block may
// take PB < P of them when the whole would not fit in shared memory (a
// float32 chunk of 256; the wrapper picks PB). Within a chunk the block
// holds X (chunk x PB), B (chunk x N; its bdec in place at the chunk's
// end) and the float32 state (N x PB), and walks the chunk's rows in
// strips of R: a strip of C lands, att's strip is the causal part of
// C B^T (columns below the strip's end only), C becomes cdec in place,
// and the strip's output is att @ X + cdec @ state_c, written straight
// to y. bf16 products run mma.sync m16n8k16 (f32 accumulate), float32
// ones FFMA.
//
// Bound: at bench.py's shape (cfg_mamba2_chunk: B 8, S 4096, H 80, P 64,
// N 128, bf16) the call moves ~0.7 GB (x, y, B, C, dt) and does ~86
// GFLOP by bench's count: bytes, ~0.21 ms at 3.35 TB/s. The block
// re-reads B and C from L2 for every head (80 heads share them), and
// each chunk's products run in turn between block-wide barriers, so the
// kernel is latency-bound well above that; a pipelined chunk prefetch
// and wgmma are later work.

#include "seqmix.cuh"

namespace {

using namespace tl_seq;

template <typename T>
struct Smem {
  T* xs;          // chunk x PB
  T* bs;          // chunk x N (B, then bdec)
  float* state;   // N x PB
  T* cs;          // R x N (a strip of C, then its cdec)
  T* att;         // R x chunk
  float* dt;      // chunk
  float* cum;     // chunk

  __host__ __device__ void carve(Carve& c, int chunk, int N, int PB, int R) {
    xs = c.take<T>(chunk, PB);
    bs = c.take<T>(chunk, N);
    state = c.take<float>(N, PB);
    cs = c.take<T>(R, N);
    att = c.take<T>(R, chunk);
    dt = c.take<float>(1, chunk);
    cum = c.take<float>(1, chunk);
  }
};

template <typename T>
long long smem_bytes(int chunk, int N, int PB, int R) {
  Carve c{nullptr, 0};
  Smem<T> s;
  s.carve(c, chunk, N, PB, R);
  return c.off;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    mamba2_chunk_scan(const T* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A, const T* __restrict__ Bm,
                      const T* __restrict__ Cm, T* __restrict__ y, int S,
                      int H, int P, int N, int chunk, int PB, int R) {
  extern __shared__ __align__(16) char smem[];
  const int h = blockIdx.x, b = blockIdx.y, p0 = blockIdx.z * PB;
  Carve cv{smem, 0};
  Smem<T> s;
  s.carve(cv, chunk, N, PB, R);
  const int lx = ld_of<T>(PB), lb = ld_of<T>(N), ls = ld_of<float>(PB),
            la = ld_of<T>(chunk);
  const float a = A[h];
  const long long xrow = (long long)H * P;    // x's step along S

  for (int i = threadIdx.x; i < N * ls; i += kThreads) s.state[i] = 0.f;

  for (int c0 = 0; c0 < S; c0 += chunk) {
    __syncthreads();      // the last chunk's readers are done
    const long long row0 = (long long)b * S + c0;
    load_tile(s.xs, x + row0 * xrow + (long long)h * P + p0, chunk, PB, xrow);
    load_tile(s.bs, Bm + row0 * N, chunk, N, N);
    for (int i = threadIdx.x; i < chunk; i += kThreads)
      s.dt[i] = dt[(row0 + i) * H + h];
    __syncthreads();
    warp_cumsum(s.dt, s.cum, chunk);
    __syncthreads();
    for (int i = threadIdx.x; i < chunk; i += kThreads) s.cum[i] *= a;
    __syncthreads();
    const float last = s.cum[chunk - 1];

    for (int r0 = 0; r0 < chunk; r0 += R) {
      load_tile(s.cs, Cm + (row0 + r0) * N, R, N, N);
      __syncthreads();
      const int ncol = r0 + R;              // att's columns j <= i
      tiles(R, ncol, [&](int m0, int n0) {
        Frag<T> f;
        f.zero();
        f.mma(Mat<T, true>{s.cs, lb}, Mat<T, true>{s.bs, lb}, m0, n0, N, ncol);
        f.each(m0, n0, ncol, [&](int m, int n, float& v) {
          const int i = r0 + m;
          const float e =
              i >= n ? v * s.dt[n] * expf(fminf(s.cum[i] - s.cum[n], 0.f))
                     : 0.f;
          s.att[m * la + n] = cvt<T>(e);
        });
      });
      __syncthreads();
      for (int i = threadIdx.x; i < R * N; i += kThreads) {
        const int m = i / N, n = i % N;
        T& c = s.cs[m * lb + n];
        c = cvt<T>(to_f(c) * expf(s.cum[r0 + m]));
      }
      __syncthreads();
      tiles(R, PB, [&](int m0, int n0) {
        Frag<T> f;
        f.zero();
        f.mma(Mat<T, true>{s.att, la}, Mat<T, false>{s.xs, lx}, m0, n0, ncol,
              PB);
        // state_c: (i = p, k = n) at state[n][p], rounded to T
        f.mma(Mat<T, true>{s.cs, lb}, typename AsT<T, false>::V{s.state, ls},
              m0, n0, N, PB);
        f.each(m0, n0, PB, [&](int m, int n, float& v) {
          y[(row0 + r0 + m) * xrow + (long long)h * P + p0 + n] = cvt<T>(v);
        });
      });
      __syncthreads();
    }

    // state = exp(last) state + bdec^T X
    for (int i = threadIdx.x; i < chunk * N; i += kThreads) {
      const int r = i / N, n = i % N;
      T& bv = s.bs[r * lb + n];
      bv = cvt<T>(to_f(bv) * s.dt[r] * expf(last - s.cum[r]));
    }
    __syncthreads();
    const float gate = expf(last);
    tiles(N, PB, [&](int m0, int n0) {
      Frag<T> f;
      f.zero();
      f.mma(Mat<T, false>{s.bs, lb}, Mat<T, false>{s.xs, lx}, m0, n0, chunk,
            PB);
      f.each(m0, n0, PB, [&](int m, int n, float& v) {
        float& st = s.state[m * ls + n];
        st = st * gate + v;
      });
    });
  }
}

template <typename T>
int run(const void* x, const void* dt, const void* A, const void* Bm,
        const void* Cm, void* y, int B, int S, int H, int P, int N,
        int chunk, int PB, int R, cudaStream_t st) {
  const dim3 grid(H, B, P / PB);
  return launch(mamba2_chunk_scan<T>, grid, smem_bytes<T>(chunk, N, PB, R),
                st, static_cast<const T*>(x), static_cast<const float*>(dt),
                static_cast<const float*>(A), static_cast<const T*>(Bm),
                static_cast<const T*>(Cm), static_cast<T*>(y), S, H, P, N,
                chunk, PB, R);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Shared memory a block needs for these
// sizes (the wrapper picks PB and R so that it fits).
extern "C" long long tl_mamba2_smem(int dtype, int chunk, int N, int PB,
                                    int R) {
  return dtype == 0 ? smem_bytes<float>(chunk, N, PB, R)
                    : smem_bytes<bf16>(chunk, N, PB, R);
}

// Launches on `stream`; returns cudaGetLastError() (0 = launched). The
// wrapper checks types, shapes (S % chunk == 0; chunk, P, N, PB, R
// multiples of 16; P % PB == 0, chunk % R == 0), devices, contiguity
// and 16-byte alignment before calling.
extern "C" int tl_mamba2_chunk_scan(const void* x, const void* dt,
                                    const void* A, const void* Bm,
                                    const void* Cm, void* y, int B, int S,
                                    int H, int P, int N, int chunk, int PB,
                                    int R, int dtype, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(x, dt, A, Bm, Cm, y, B, S, H, P, N, chunk, PB, R, st);
  return run<bf16>(x, dt, A, Bm, Cm, y, B, S, H, P, N, chunk, PB, R, st);
}
