// The Mamba2 SSD chunk scan for Hopper (sm_90a).
//
// Replaces one TPU kernel of tilelang_mesh_tpu/ops/mamba2.py:
//   mamba2_chunk_scan_kernel (:25) -> tl_mamba2_chunk_scan
//     x (B, S, H, P) read through its strides, dt (B, S, H) float32,
//     A (H,) float32, Bm / Cm (B, S, N); y (B, S, H, P) in x's type
//     (float32 or bfloat16), written through its strides. Chunks of
//     `chunk` steps in order; within a chunk, with cum = A_h cumsum(dt)
//     (inclusive, f32):
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
// take PB < P of them (the wrapper's plan picks PB and R). Per chunk the
// block holds X (chunk x PB) and B (chunk x N; its bdec in place at the
// chunk's end), both landing by cp.async with dt beside them, and walks
// the chunk's rows in strips of R through a ring of two strips of C: the
// next strip (of this chunk or the next) is in flight while a strip is
// computed. A strip is two phases: att's strip (the causal part of
// C B^T) and the strip's cdec, then its output att X + cdec state_c,
// written straight to y. The chunk's decays are formed once a row
// (exp(cum), exp(cum_last - cum)); only the pairwise clamp is an exp a
// score, formed in registers before any store. The float32 state lives
// in the warps' registers (a warp one or two 16 x 32 tiles), its
// rounding state_c in shared memory. bf16 operands reach mma.sync
// m16n8k16 through ldmatrix, and bf16 sums leave a column pair a store;
// float32 products run FFMA. The plan sizes the block so that two share
// an SM where a strip of 16 rows or more allows it (bench's bf16 chunk
// 128: PB 64, R 32, the strips in 16 x 16 tiles). X and B of the next
// chunk are not prefetched: a second copy of them would leave one block
// an SM.
//
// Bound: at bench.py's shape (cfg_mamba2_chunk: B 8, S 4096, H 80, P 64,
// N 128, bf16) the call moves ~0.7 GB (x, y, B, C, dt) and does ~86
// GFLOP by bench's count: bytes, ~0.21 ms at 3.35 TB/s. Each head's
// block re-reads B and C from L2 and forms its own C B^T (80 heads
// share them).

#include "seqmix.cuh"

namespace {

using namespace tl_seq;

constexpr int kMaxTiles = 2;   // state tiles a warp holds

// fn(m0, n0, n1) for every 16 x W tile (columns n0 .. n1) of a strip's
// M x N product, the block's warps taking them in turn. W is Frag's 32,
// or in bf16 16 (a pair of m16n8k16 products), which the plan takes
// where tiles of 32 would leave warps without one
template <int W, class Fn>
__device__ __forceinline__ void strip_tiles(int M, int N, Fn fn) {
  const int tn = (N + W - 1) / W, n = (M / 16) * tn;
  for (int t = threadIdx.x / 32; t < n; t += kWarps) {
    const int n0 = (t % tn) * W;
    fn((t / tn) * 16, n0, min(n0 + W, N));
  }
}

template <typename T>
struct Smem {
  T* xs;        // chunk x PB
  T* bs;        // chunk x N (B, then bdec)
  float* dt;    // chunk
  float* cum;   // chunk: A cumsum(dt)
  float* ec;    // chunk: exp(cum)
  float* el;    // chunk: exp(cum_last - cum)
  T* cr0;       // R x N: strips of C, even
  T* cr1;       // and odd
  T* cd;        // R x N: the strip's cdec
  T* att;       // R x chunk
  T* st;        // N x PB: state_c

  __host__ __device__ void carve(Carve& c, int chunk, int N, int PB, int R) {
    xs = c.take<T>(chunk, PB);
    bs = c.take<T>(chunk, N);
    dt = c.take<float>(1, chunk);
    cum = c.take<float>(1, chunk);
    ec = c.take<float>(1, chunk);
    el = c.take<float>(1, chunk);
    cr0 = c.take<T>(R, N);
    cr1 = c.take<T>(R, N);
    cd = c.take<T>(R, N);
    att = c.take<T>(R, chunk);
    st = c.take<T>(N, PB);
  }
};

template <typename T>
long long smem_bytes(int chunk, int N, int PB, int R) {
  Carve c{nullptr, 0};
  Smem<T> s;
  s.carve(c, chunk, N, PB, R);
  return c.off;
}

template <typename T, int W>
__global__ void __launch_bounds__(kThreads, 2)
    mamba2_chunk_scan(const T* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A, const T* __restrict__ Bm,
                      const T* __restrict__ Cm, T* __restrict__ y, int S,
                      int H, int P, int N, int chunk, int PB, int R,
                      long long xsb, long long xss, long long xsh,
                      long long ysb, long long yss, long long ysh) {
  extern __shared__ __align__(16) char smem[];
  const int h = blockIdx.x, b = blockIdx.y, p0 = blockIdx.z * PB,
            warp = threadIdx.x / 32;
  Carve cv{smem, 0};
  Smem<T> s;
  s.carve(cv, chunk, N, PB, R);
  const int lx = ld_of<T>(PB), lb = ld_of<T>(N), la = ld_of<T>(chunk);
  const float a = A[h];
  const T* xb = x + b * xsb + h * xsh + p0;    // row t at xb + t * xss
  T* yb = y + b * ysb + h * ysh + p0;
  const T* bb = Bm + (long long)b * S * N;
  const T* cb = Cm + (long long)b * S * N;
  const float* db = dt + (long long)b * S * H + h;   // row t at db[t * H]
  const int tn = (PB + 31) / 32, ns = (N / 16) * tn;
  const int strips = S / R;
  const Mat<T, false> xv{s.xs, lx}, stv{s.st, lx};

  auto issue_strip = [&](int gs) {
    load_tile_async(gs & 1 ? s.cr1 : s.cr0, cb + (long long)gs * R * N, R,
                    N, N);
    tl_gemm::cp_async_commit();
  };

  Acc<T> st[kMaxTiles];
#pragma unroll
  for (int j = 0; j < kMaxTiles; ++j) st[j].zero();
  for (int i = threadIdx.x; i < N * lx; i += kThreads) s.st[i] = cvt<T>(0.f);
  issue_strip(0);

  for (int c0 = 0, gs = 0; c0 < S; c0 += chunk) {
    load_tile_async(s.xs, xb + c0 * xss, chunk, PB, xss);
    load_tile_async(s.bs, bb + (long long)c0 * N, chunk, N, N);
    tl_gemm::cp_async_commit();
    for (int i = threadIdx.x; i < chunk; i += kThreads)
      s.dt[i] = db[(long long)(c0 + i) * H];
    tl_gemm::cp_async_wait<0>();
    __syncthreads();              // the chunk and its first strip landed
    warp_cumsum(s.dt, s.cum, chunk);
    if (threadIdx.x < 32) {       // warp 0 wrote cum; its lanes finish
      __syncwarp();
      for (int i = threadIdx.x; i < chunk; i += 32) s.cum[i] *= a;
      __syncwarp();
      const float last = s.cum[chunk - 1];
      for (int i = threadIdx.x; i < chunk; i += 32) {
        s.ec[i] = expf(s.cum[i]);
        s.el[i] = expf(last - s.cum[i]);
      }
    }
    __syncthreads();
    const float last = s.cum[chunk - 1];

    for (int r0 = 0; r0 < chunk; r0 += R, ++gs) {
      if (gs + 1 < strips) {
        issue_strip(gs + 1);
        tl_gemm::cp_async_wait<1>();
      } else {
        tl_gemm::cp_async_wait<0>();
      }
      __syncthreads();            // this strip landed; the last one is done
      const T* cs = gs & 1 ? s.cr1 : s.cr0;
      const int ncol = r0 + R;    // att's columns j <= i
      strip_tiles<W>(R, ncol, [&](int m0, int n0, int n1) {
        if (n0 > r0 + m0 + 15) return;
        Acc<T> f;
        f.zero();
        f.mma_ld(Mat<T, true>{cs, lb}, Mat<T, true>{s.bs, lb}, m0, n0, N,
                 n1);
        // the decays in registers, then the stores: no store between
        // the reads of dt and cum
        f.each(m0, n0, n1, [&](int m, int n, float& v) {
          const int i = r0 + m;
          v = i >= n ? v * s.dt[n] * expf(fminf(s.cum[i] - s.cum[n], 0.f))
                     : 0.f;
        });
        f.put(m0, n0, n1, [&](int m, int n) { return s.att + m * la + n; });
      });
      pieces<T>(R, N, [&](int m, int n) {
        Piece<T> c;
        c.load(cs + m * lb + n);
#pragma unroll
        for (int i = 0; i < Piece<T>::V; ++i) c.v[i] *= s.ec[r0 + m];
        c.store(s.cd + m * lb + n);
      });
      __syncthreads();
      // y = att_c X (depth to the tile's diagonal) + cdec state_c
      strip_tiles<W>(R, PB, [&](int m0, int n0, int n1) {
        Acc<T> f;
        f.zero();
        f.mma_ld(Mat<T, true>{s.att, la}, xv, m0, n0, r0 + m0 + 16, n1);
        f.mma_ld(Mat<T, true>{s.cd, lb}, stv, m0, n0, N, n1);
        f.put(m0, n0, n1, [&](int m, int n) {
          return yb + (long long)(c0 + r0 + m) * yss + n;
        });
      });
      if (r0 + R == chunk)        // B's last readers were this strip's
        pieces<T>(chunk, N, [&](int r, int n) {
          Piece<T> c;
          c.load(s.bs + r * lb + n);
#pragma unroll
          for (int i = 0; i < Piece<T>::V; ++i)
            c.v[i] = c.v[i] * s.dt[r] * s.el[r];
          c.store(s.bs + r * lb + n);
        });
    }
    __syncthreads();

    // state = exp(last) state + bdec^T X
    const float gate = expf(last);
#pragma unroll
    for (int j = 0; j < kMaxTiles; ++j) {
      const int t = warp + kWarps * j;
      if (t < ns) {
        const int m0 = t / tn * 16, n0 = t % tn * 32;
        Acc<T> u;
        u.zero();
        u.mma_ld(Mat<T, false>{s.bs, lb}, xv, m0, n0, chunk, PB);
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            st[j].c[e][q] = st[j].c[e][q] * gate + u.c[e][q];
        st[j].put(m0, n0, PB,
                  [&](int m, int n) { return s.st + m * lx + n; });
      }
    }
    __syncthreads();              // X and B are free for the next chunk
  }
}

template <typename T, int W>
int run(const void* x, const void* dt, const void* A, const void* Bm,
        const void* Cm, void* y, int B, int S, int H, int P, int N,
        int chunk, int PB, int R, const long long* xs, const long long* ys,
        cudaStream_t st) {
  const dim3 grid(H, B, P / PB);
  return launch(mamba2_chunk_scan<T, W>, grid, smem_bytes<T>(chunk, N, PB, R),
                st, static_cast<const T*>(x), static_cast<const float*>(dt),
                static_cast<const float*>(A), static_cast<const T*>(Bm),
                static_cast<const T*>(Cm), static_cast<T*>(y), S, H, P, N,
                chunk, PB, R, xs[0], xs[1], xs[2], ys[0], ys[1], ys[2]);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Shared memory a block needs for these
// sizes (ops/mamba2.py reckons the same bytes; a card test holds them
// equal).
extern "C" long long tl_mamba2_smem(int dtype, int chunk, int N, int PB,
                                    int R) {
  return dtype == 0 ? smem_bytes<float>(chunk, N, PB, R)
                    : smem_bytes<bf16>(chunk, N, PB, R);
}

// Launches on `stream`; returns cudaGetLastError() (0 = launched). x_st
// and y_st are the (B, S, H) strides of x and y in elements (P's is 1).
// W is the strips' tile width: 16 or 32 in bf16, 32 in float32. The
// wrapper checks types, shapes (S % chunk == 0; chunk, P, N, PB, R
// multiples of 16; P % PB == 0, chunk % R == 0; at most 16 state tiles
// of 16 x 32 a block), devices, the strides and 16-byte alignment of
// every row before calling.
extern "C" int tl_mamba2_chunk_scan(const void* x, const void* dt,
                                    const void* A, const void* Bm,
                                    const void* Cm, void* y, int B, int S,
                                    int H, int P, int N, int chunk, int PB,
                                    int R, int W, const long long* x_st,
                                    const long long* y_st, int dtype,
                                    void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float, 32>(x, dt, A, Bm, Cm, y, B, S, H, P, N, chunk, PB, R,
                          x_st, y_st, st);
  if (W == 16)
    return run<bf16, 16>(x, dt, A, Bm, Cm, y, B, S, H, P, N, chunk, PB, R,
                         x_st, y_st, st);
  return run<bf16, 32>(x, dt, A, Bm, Cm, y, B, S, H, P, N, chunk, PB, R,
                       x_st, y_st, st);
}
