// Chunked causal linear attention and RetNet retention for Hopper
// (sm_90a): one chunk loop, two kernels.
//
// Replaces two TPU kernels of tilelang_mesh_tpu/ops/linear_attention.py:
//   linear_attention_kernel (:20) -> tl_linear_attention
//     o_t = q_t sum_{s <= t} k_s^T v_s
//   retention_kernel (:122)       -> tl_retention
//     o_t = sum_{s <= t} gamma_h^(t - s) (q_t . k_s) v_s, gamma in (0, 1]
//   q / k (B, H, S, DK), v / o (B, H, S, DV), float32 or bfloat16, the
//   (DK, DV) state float32. Per chunk of c steps, rows i of the chunk:
//     out_i = q_i @ state                   (retention: x gamma^(i + 1))
//           + attn_c[i, :] @ v,  attn = mask(q k^T)   (x gamma^(i - j))
//     state = state + k^T v      (retention: gamma^c state + kd_c^T v,
//                                 kd = gamma^(c - 1 - j) k_j)
//   with _c the rounding to the input type and every power of gamma
//   taken as exp2(log2(gamma) n), as in the TPU kernel. The state is
//   never rounded: in bfloat16 the TPU kernel multiplies the bf16 q by
//   the float32 state at full float32 precision, so here q @ state runs
//   on the tensor cores as q @ hi + q @ lo, the state split into its
//   bf16 rounding and the bf16 remainder (about 2^-17 of the state).
//
// One block of 256 threads a (head, batch, column block of V): the
// state's and the output's V columns are independent, so a block may
// take VB < DV of them (the wrapper picks VB to fit shared memory). The
// block holds k (retention: then kd in place) and v of the chunk and the
// float32 state, and walks the chunk's rows in strips of R: a strip of q
// lands, attn's strip is the causal part of q k^T (columns below the
// strip's end), and the strip's output is written straight to o. bf16
// products run mma.sync m16n8k16 (f32 accumulate), float32 ones FFMA.
//
// Bound: at B 8, H 16, S 4096, DK = DV = 128 in float32 (chunk 128) the
// call moves ~1.07 GB and does the four products of every chunk, ~69
// GFLOP: operations, ~1.0 ms at 67 TFLOP/s on CUDA cores; in bf16 the
// bytes (~0.54 GB, 0.16 ms). With VB = DV there are H B = 128 blocks,
// under one wave, each running its chunks in turn between block-wide
// barriers: latency-bound.

#include "seqmix.cuh"

namespace {

using namespace tl_seq;

template <typename T>
struct Smem {
  T* ks;          // c x DK: k (retention: then kd)
  T* vs;          // c x VB
  float* state;   // DK x VB
  T* qs;          // R x DK
  T* att;         // R x c

  __host__ __device__ void carve(Carve& c, int chunk, int DK, int VB, int R) {
    ks = c.take<T>(chunk, DK);
    vs = c.take<T>(chunk, VB);
    state = c.take<float>(DK, VB);
    qs = c.take<T>(R, DK);
    att = c.take<T>(R, chunk);
  }
};

template <typename T>
long long smem_bytes(int chunk, int DK, int VB, int R) {
  Carve c{nullptr, 0};
  Smem<T> s;
  s.carve(c, chunk, DK, VB, R);
  return c.off;
}

// f += q @ state at float32 precision: (i = n, k = d) is state[d][n]
__device__ __forceinline__ void q_state(Frag<float>& f, const float* qs,
                                        int lq, const float* st, int ls,
                                        int m0, int n0, int DK, int VB) {
  f.mma(Mat<float, true>{qs, lq}, Mat<float, false>{st, ls}, m0, n0, DK, VB);
}
__device__ __forceinline__ void q_state(Frag<bf16>& f, const bf16* qs, int lq,
                                        const float* st, int ls, int m0,
                                        int n0, int DK, int VB) {
  f.mma(Mat<bf16, true>{qs, lq}, Rounded<false>{st, ls}, m0, n0, DK, VB);
  f.mma(Mat<bf16, true>{qs, lq}, Lo<false>{st, ls}, m0, n0, DK, VB);
}

template <typename T, bool RET>
__global__ void __launch_bounds__(kThreads)
    chunk_scan(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ gamma,
               T* __restrict__ o, int H, int S, int DK, int DV, int chunk,
               int VB, int R) {
  extern __shared__ __align__(16) char smem[];
  const int h = blockIdx.x, b = blockIdx.y, v0 = blockIdx.z * VB;
  Carve cv{smem, 0};
  Smem<T> s;
  s.carve(cv, chunk, DK, VB, R);
  const int lk = ld_of<T>(DK), lv = ld_of<T>(VB), ls = ld_of<float>(VB),
            la = ld_of<T>(chunk);
  const long long bh = (long long)b * H + h;
  const float lg = RET ? log2f(gamma[h]) : 0.f;

  for (int i = threadIdx.x; i < DK * ls; i += kThreads) s.state[i] = 0.f;

  for (int c0 = 0; c0 < S; c0 += chunk) {
    __syncthreads();      // the last chunk's readers are done
    const long long t0 = bh * S + c0;
    load_tile(s.ks, k + t0 * DK, chunk, DK, DK);
    load_tile(s.vs, v + t0 * DV + v0, chunk, VB, DV);

    for (int r0 = 0; r0 < chunk; r0 += R) {
      load_tile(s.qs, q + (t0 + r0) * DK, R, DK, DK);
      __syncthreads();
      const int ncol = r0 + R;              // attn's columns j <= i
      tiles(R, ncol, [&](int m0, int n0) {
        Frag<T> f;
        f.zero();
        f.mma(Mat<T, true>{s.qs, lk}, Mat<T, true>{s.ks, lk}, m0, n0, DK,
              ncol);
        f.each(m0, n0, ncol, [&](int m, int j, float& x) {
          const int i = r0 + m;
          float e = 0.f;
          if (i >= j) e = RET ? x * exp2f(lg * (float)(i - j)) : x;
          s.att[m * la + j] = cvt<T>(e);
        });
      });
      __syncthreads();
      tiles(R, VB, [&](int m0, int n0) {
        Frag<T> f;
        f.zero();
        q_state(f, s.qs, lk, s.state, ls, m0, n0, DK, VB);
        if (RET)
          f.each(m0, n0, VB, [&](int m, int, float& x) {
            x = x * exp2f(lg * (float)(r0 + m + 1));
          });
        f.mma(Mat<T, true>{s.att, la}, Mat<T, false>{s.vs, lv}, m0, n0, ncol,
              VB);
        f.each(m0, n0, VB, [&](int m, int n, float& x) {
          o[(t0 + r0 + m) * DV + v0 + n] = cvt<T>(x);
        });
      });
      __syncthreads();
    }

    if (RET) {
      for (int i = threadIdx.x; i < chunk * DK; i += kThreads) {
        const int r = i / DK, d = i % DK;
        T& kv = s.ks[r * lk + d];
        kv = cvt<T>(to_f(kv) * exp2f(lg * (float)(chunk - 1 - r)));
      }
      __syncthreads();
    }
    const float gate = RET ? exp2f(lg * (float)chunk) : 1.f;
    tiles(DK, VB, [&](int m0, int n0) {
      Frag<T> f;
      f.zero();
      f.mma(Mat<T, false>{s.ks, lk}, Mat<T, false>{s.vs, lv}, m0, n0, chunk,
            VB);
      f.each(m0, n0, VB, [&](int d, int n, float& x) {
        float& st = s.state[d * ls + n];
        st = RET ? st * gate + x : st + x;
      });
    });
  }
}

template <typename T, bool RET>
int run(const void* q, const void* k, const void* v, const void* gamma,
        void* o, int B, int H, int S, int DK, int DV, int chunk, int VB,
        int R, cudaStream_t st) {
  const dim3 grid(H, B, DV / VB);
  return launch(chunk_scan<T, RET>, grid, smem_bytes<T>(chunk, DK, VB, R),
                st, static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<const float*>(gamma),
                static_cast<T*>(o), H, S, DK, DV, chunk, VB, R);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Shared memory a block needs (both
// kernels).
extern "C" long long tl_linear_attention_smem(int dtype, int chunk, int DK,
                                              int VB, int R) {
  return dtype == 0 ? smem_bytes<float>(chunk, DK, VB, R)
                    : smem_bytes<bf16>(chunk, DK, VB, R);
}

// Launch on `stream`; return cudaGetLastError() (0 = launched). The
// wrapper checks types, shapes (S % chunk == 0; chunk, DK, DV, VB, R
// multiples of 16; DV % VB == 0, chunk % R == 0; gamma in (0, 1]),
// devices, contiguity and 16-byte alignment.
extern "C" int tl_linear_attention(const void* q, const void* k,
                                   const void* v, void* o, int B, int H,
                                   int S, int DK, int DV, int chunk, int VB,
                                   int R, int dtype, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float, false>(q, k, v, nullptr, o, B, H, S, DK, DV, chunk, VB,
                             R, st);
  return run<bf16, false>(q, k, v, nullptr, o, B, H, S, DK, DV, chunk, VB, R,
                          st);
}

extern "C" int tl_retention(const void* q, const void* k, const void* v,
                            const void* gamma, void* o, int B, int H, int S,
                            int DK, int DV, int chunk, int VB, int R,
                            int dtype, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float, true>(q, k, v, gamma, o, B, H, S, DK, DV, chunk, VB, R,
                            st);
  return run<bf16, true>(q, k, v, gamma, o, B, H, S, DK, DV, chunk, VB, R,
                         st);
}
