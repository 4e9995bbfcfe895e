// The pieces the port's sequence-mixing kernels share (mamba2.cu, gdn.cu,
// linear_attention.cu) on Hopper (sm_90a).
//
// Each of those kernels is a chunked recurrence: one block owns a (head,
// batch) pair (and a column block of the value side, which is
// independent), walks the chunks in order, and inside a chunk runs a few
// small matrix products between tiles that sit in shared memory, with
// elementwise work (decays, masks, roundings) between them. So the
// shared pieces are:
//
//   Carve     lays the block's shared matrices out one after another, on
//             the host (to size the launch) and on the device alike;
//   Mat, ...  views of a shared matrix as a product's operand: element
//             (i, k) of A (rows i) or of B transposed (columns i), k the
//             depth, stored k-contiguous (KC) or not, read as float or
//             as a pair of bf16 along k; `Rounded` reads float32 storage
//             rounded to bf16 (a float32 state used as a bf16 operand),
//             `Lo` the remainder of that rounding (a float32 operand
//             split hi + lo for the tensor cores);
//   Frag<T>   one warp's 16 x 32 tile of a product's float32 sum:
//             bf16 operands through `mma.sync.m16n8k16` (f32
//             accumulate), float32 ones by FFMA on CUDA cores (no TF32:
//             the TPU kernels ask for full float32 precision when an
//             operand is float32);
//   tiles     spreads the 16 x 32 tiles of an M x N product over the
//             block's warps;
//   load_tile global -> shared copies of a row window, 16 bytes a step;
//   warp_cumsum  an inclusive scan of a chunk's decays by one warp;
//   load_tile_async  the same copy by cp.async (the caller commits and
//             waits), so that a chunk's tiles are in flight together;
//   Acc<T>    Frag<T> whose products take Mat<T, KC> operands: bf16
//             fragments by ldmatrix (.trans where the operand is not
//             k-contiguous), one instruction for four 8 x 8 pieces;
//             float32 by Frag<float>'s FFMA; `each2` visits two tiles'
//             sums side by side, `put` stores the sums in T (bf16 a
//             column pair a store). gdn.cu and mamba2.cu run on these;
//             linear_attention.cu keeps Frag's word-wise reads.
//
// Shared rows are padded by 16 bytes (`ld_of`): with rows of 16 to 256
// elements the row stride is 4 (mod 32) words or spreads eight rows over
// distinct banks otherwise, so the fragment loads of both Frag kinds hit
// distinct banks whether the operand is k-contiguous or not.
//
// wgmma and TMA are later work.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_tile.cuh"   // cp_async16, ldmatrix_x4(_trans)

namespace tl_seq {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kSmemMax = 232448;   // a block's shared memory, sm_90

using bf16 = __nv_bfloat16;

template <typename S>
__host__ __device__ constexpr int ld_of(int w) {
  return w + 16 / (int)sizeof(S);
}

template <typename S>
__host__ __device__ constexpr long long bytes_of(int r, int w) {
  return ((long long)r * ld_of<S>(w) * (long long)sizeof(S) + 15) / 16 * 16;
}

// Lays shared matrices out one after another; with base == nullptr it
// only counts (the host sizes the launch with the same code).
struct Carve {
  char* base;
  long long off;
  template <typename S>
  __host__ __device__ S* take(int r, int w) {
    S* p = base ? reinterpret_cast<S*>(base + off) : nullptr;
    off += bytes_of<S>(r, w);
    return p;
  }
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T cvt(float x);
template <>
__device__ __forceinline__ float cvt<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 cvt<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// A shared matrix of S as an operand: (i, k) at p[i * ld + k] when KC,
// p[k * ld + i] otherwise.
template <typename S, bool KC>
struct Mat {
  const S* p;
  int ld;
  __device__ __forceinline__ S raw(int i, int k) const {
    return KC ? p[i * ld + k] : p[k * ld + i];
  }
  __device__ __forceinline__ float at(int i, int k) const {
    return to_f(raw(i, k));
  }
  // (i, k) and (i, k + 1) as bf16 (S = bf16; k even)
  __device__ __forceinline__ uint32_t pair(int i, int k) const {
    if (KC) return *reinterpret_cast<const uint32_t*>(p + i * ld + k);
    return pack(p[k * ld + i], p[(k + 1) * ld + i]);
  }
};

// float32 storage read as bf16, rounded to nearest even (the TPU
// kernels' cast of a float32 fragment to the input type)
template <bool KC>
struct Rounded {
  const float* p;
  int ld;
  __device__ __forceinline__ float raw(int i, int k) const {
    return KC ? p[i * ld + k] : p[k * ld + i];
  }
  __device__ __forceinline__ uint32_t pair(int i, int k) const {
    return pack(__float2bfloat16_rn(raw(i, k)),
                __float2bfloat16_rn(raw(i, k + 1)));
  }
};

// float32 storage as an operand of a product in T: as it is for float,
// rounded for bf16
template <typename T, bool KC>
struct AsT;
template <bool KC>
struct AsT<float, KC> {
  using V = Mat<float, KC>;
};
template <bool KC>
struct AsT<bf16, KC> {
  using V = Rounded<KC>;
};

// what float32 storage keeps beyond its bf16 rounding, as bf16: hi + lo
// carries the value to about 2^-17 of itself
template <bool KC>
struct Lo {
  const float* p;
  int ld;
  __device__ __forceinline__ bf16 lo(float x) const {
    return __float2bfloat16_rn(x - __bfloat162float(__float2bfloat16_rn(x)));
  }
  __device__ __forceinline__ uint32_t pair(int i, int k) const {
    const float a = KC ? p[i * ld + k] : p[k * ld + i];
    const float b = KC ? p[i * ld + k + 1] : p[(k + 1) * ld + i];
    return pack(lo(a), lo(b));
  }
};

template <typename T>
struct Frag;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16 operands: four m16n8k16 tiles side by side. Lane (g = lane / 4,
// q = 2 (lane % 4)) holds rows g, g + 8 and columns q, q + 1 of each.
template <>
struct Frag<bf16> {
  float c[4][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[t][e] = 0.f;
  }

  // c += A[m0 : m0 + 16, 0 : K] B[0 : K, n0 : n0 + 32]; columns >= N
  // are left out (K a multiple of 16, N of 8)
  template <class A, class B>
  __device__ __forceinline__ void mma(const A& a, const B& b, int m0, int n0,
                                      int K, int N) {
    const int lane = threadIdx.x & 31, g = lane >> 2, q = (lane & 3) * 2;
    for (int k = 0; k < K; k += 16) {
      const uint32_t ar[4] = {a.pair(m0 + g, k + q), a.pair(m0 + g + 8, k + q),
                              a.pair(m0 + g, k + q + 8),
                              a.pair(m0 + g + 8, k + q + 8)};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int n = n0 + 8 * t;
        if (n < N)
          mma_bf16(c[t], ar, b.pair(n + g, k + q), b.pair(n + g, k + q + 8));
      }
    }
  }

  __device__ __forceinline__ void sub(const Frag& o) {
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[t][e] -= o.c[t][e];
  }

  // fn(m, n, float& v) for each of the lane's sums (columns < N)
  template <class Fn>
  __device__ __forceinline__ void each(int m0, int n0, int N, Fn fn) {
    const int lane = threadIdx.x & 31, g = lane >> 2, q = (lane & 3) * 2;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int n = n0 + 8 * t + q;
      if (n0 + 8 * t >= N) continue;
      fn(m0 + g, n, c[t][0]);
      fn(m0 + g, n + 1, c[t][1]);
      fn(m0 + g + 8, n, c[t][2]);
      fn(m0 + g + 8, n + 1, c[t][3]);
    }
  }
};

// float32 operands, FFMA: lane (r = lane / 8, s = lane % 8) holds rows
// m0 + r + 4 i and columns n0 + s + 8 j, i, j < 4.
template <>
struct Frag<float> {
  float c[4][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
  }

  template <class A, class B>
  __device__ __forceinline__ void mma(const A& a, const B& b, int m0, int n0,
                                      int K, int N) {
    const int lane = threadIdx.x & 31, r = lane >> 3, s = lane & 7;
    bool ok[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) ok[j] = n0 + s + 8 * j < N;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a.at(m0 + r + 4 * i, k);
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = ok[j] ? b.at(n0 + s + 8 * j, k) : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) c[i][j] = fmaf(av[i], bv[j], c[i][j]);
    }
  }

  __device__ __forceinline__ void sub(const Frag& o) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[i][j] -= o.c[i][j];
  }

  template <class Fn>
  __device__ __forceinline__ void each(int m0, int n0, int N, Fn fn) {
    const int lane = threadIdx.x & 31, r = lane >> 3, s = lane & 7;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n0 + s + 8 * j < N) fn(m0 + r + 4 * i, n0 + s + 8 * j, c[i][j]);
  }
};

// fn(m0, n0) for every 16 x 32 tile of an M x N product (M a multiple
// of 16), the block's warps taking them in turn
template <class Fn>
__device__ __forceinline__ void tiles(int M, int N, Fn fn) {
  const int tn = (N + 31) / 32, n = (M / 16) * tn;
  for (int t = threadIdx.x / 32; t < n; t += kWarps)
    fn((t / tn) * 16, (t % tn) * 32);
}

// rows x W elements of S at src (row stride gld elements) into shared
// dst (row stride ld_of<S>(W)), 16 bytes a step: W * sizeof(S), gld *
// sizeof(S) and src's address are multiples of 16
template <typename S>
__device__ __forceinline__ void load_tile(S* dst, const S* src, int rows,
                                          int W, long long gld) {
  constexpr int V = 16 / sizeof(S);
  const int per = W / V, ld = ld_of<S>(W);
  for (int i = threadIdx.x; i < rows * per; i += kThreads) {
    const int r = i / per, c = (i % per) * V;
    *reinterpret_cast<uint4*>(dst + r * ld + c) =
        *reinterpret_cast<const uint4*>(src + r * gld + c);
  }
}

// out[i] = sum_{t <= i} in[t] for i < n, by warp 0 (the other warps
// return at once; the caller synchronises after)
__device__ __forceinline__ void warp_cumsum(const float* in, float* out,
                                            int n) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  float carry = 0.f;
  for (int base = 0; base < n; base += 32) {
    float v = base + lane < n ? in[base + lane] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    v += carry;
    if (base + lane < n) out[base + lane] = v;
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
}

// set the kernel's dynamic shared memory and launch it; returns
// cudaGetLastError() (0 = launched)
template <class K, class... Args>
int launch(K kernel, dim3 grid, long long smem, cudaStream_t s,
           Args... args) {
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kThreads, (size_t)smem, s>>>(args...);
  return (int)cudaGetLastError();
}

// load_tile by cp.async: 16 bytes a copy, the same layout; the caller
// commits the group and waits for it
template <typename S>
__device__ __forceinline__ void load_tile_async(S* dst, const S* src,
                                                int rows, int W,
                                                long long gld) {
  constexpr int V = 16 / sizeof(S);
  const int per = W / V, ld = ld_of<S>(W);
  for (int i = threadIdx.x; i < rows * per; i += kThreads) {
    const int r = i / per, c = (i % per) * V;
    tl_gemm::cp_async16(dst + r * ld + c, src + r * gld + c, true);
  }
}

// A warp's 16 x 32 float32 tile whose products read shared matrices in
// T through Mat views (K and N multiples of 16; the rows 16-byte aligned,
// as ld_of pads them)
template <typename T>
struct Acc;

template <>
struct Acc<float> : Frag<float> {
  template <bool KA, bool KB>
  __device__ __forceinline__ void mma_ld(Mat<float, KA> a, Mat<float, KB> b,
                                         int m0, int n0, int K, int N) {
    mma(a, b, m0, n0, K, N);
  }

  // fn(m, n, x, y) for each sum x of this tile and y of o's (columns
  // below N)
  template <class Fn>
  __device__ __forceinline__ void each2(Acc& o, int m0, int n0, int N,
                                        Fn fn) {
    const int lane = threadIdx.x & 31, r = lane >> 3, s = lane & 7;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n0 + s + 8 * j < N)
          fn(m0 + r + 4 * i, n0 + s + 8 * j, c[i][j], o.c[i][j]);
  }

  // each sum (columns below N) stored at at(m, n)
  template <class At>
  __device__ __forceinline__ void put(int m0, int n0, int N, At at) const {
    const int lane = threadIdx.x & 31, r = lane >> 3, s = lane & 7;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n0 + s + 8 * j < N) *at(m0 + r + 4 * i, n0 + s + 8 * j) = c[i][j];
  }
};

// lane l addresses row l % 8 of the x4 load's matrix l / 8
template <>
struct Acc<bf16> : Frag<bf16> {
  template <bool KA, bool KB>
  __device__ __forceinline__ void mma_ld(Mat<bf16, KA> a, Mat<bf16, KB> b,
                                         int m0, int n0, int K, int N) {
    const int lane = threadIdx.x & 31, j = lane >> 3, r = lane & 7;
    for (int k = 0; k < K; k += 16) {
      uint32_t ar[4];
      if (KA)   // (i, k) at p[i * ld + k]: matrices (rows, k) 0/8 x 0/8
        tl_gemm::bf16::ldmatrix_x4(
            ar, a.p + (m0 + (lane & 15)) * a.ld + k + (lane >> 4) * 8);
      else      // at p[k * ld + i]: the transposed pieces
        tl_gemm::bf16::ldmatrix_x4_trans(
            ar, a.p + (k + r + (j >> 1) * 8) * a.ld + m0 + (j & 1) * 8);
#pragma unroll
      for (int tp = 0; tp < 2; ++tp) {
        const int n = n0 + 16 * tp;
        if (n >= N) continue;
        uint32_t br[4];   // b0, b1 of columns n .. n + 7, then n + 8 ..
        if (KB)
          tl_gemm::bf16::ldmatrix_x4(
              br, b.p + (n + r + (j >> 1) * 8) * b.ld + k + (j & 1) * 8);
        else
          tl_gemm::bf16::ldmatrix_x4_trans(
              br, b.p + (k + r + (j & 1) * 8) * b.ld + n + (j >> 1) * 8);
        mma_bf16(c[2 * tp], ar, br[0], br[1]);
        mma_bf16(c[2 * tp + 1], ar, br[2], br[3]);
      }
    }
  }

  template <class Fn>
  __device__ __forceinline__ void each2(Acc& o, int m0, int n0, int N,
                                        Fn fn) {
    const int lane = threadIdx.x & 31, g = lane >> 2, q = (lane & 3) * 2;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (n0 + 8 * t >= N) continue;
      const int n = n0 + 8 * t + q;
      fn(m0 + g, n, c[t][0], o.c[t][0]);
      fn(m0 + g, n + 1, c[t][1], o.c[t][1]);
      fn(m0 + g + 8, n, c[t][2], o.c[t][2]);
      fn(m0 + g + 8, n + 1, c[t][3], o.c[t][3]);
    }
  }

  // the sums (columns below N) rounded to bf16 and stored a column pair
  // at a time at at(m, n), n even
  template <class At>
  __device__ __forceinline__ void put(int m0, int n0, int N, At at) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, q = (lane & 3) * 2;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (n0 + 8 * t >= N) continue;
      const int n = n0 + 8 * t + q;
      *reinterpret_cast<__nv_bfloat162*>(at(m0 + g, n)) =
          __floats2bfloat162_rn(c[t][0], c[t][1]);
      *reinterpret_cast<__nv_bfloat162*>(at(m0 + g + 8, n)) =
          __floats2bfloat162_rn(c[t][2], c[t][3]);
    }
  }
};

// tiles() for a warp's share of n tiles starting `off` warps on, so that
// two lists of tiles issued back to back spread over all the warps
template <class Fn>
__device__ __forceinline__ void tiles_from(int n, int off, Fn fn) {
  const int w = threadIdx.x / 32;
  for (int t = (w + kWarps - off % kWarps) % kWarps; t < n; t += kWarps)
    fn(t);
}

// fn(r, c) for each 16-byte piece of a rows x W tile of S (elements c ..
// c + 16 / sizeof(S) of row r), the block's threads taking them in turn
template <typename S, class Fn>
__device__ __forceinline__ void pieces(int rows, int W, Fn fn) {
  constexpr int V = 16 / sizeof(S);
  const int per = W / V;
  for (int i = threadIdx.x; i < rows * per; i += kThreads)
    fn(i / per, (i % per) * V);
}

// 16 bytes of S in shared memory as floats, and back rounded to S
template <typename S>
struct Piece {
  static constexpr int V = 16 / sizeof(S);
  float v[V];
  __device__ __forceinline__ void load(const S* p) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const S* e = reinterpret_cast<const S*>(&u);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = to_f(e[i]);
  }
  template <typename O>
  __device__ __forceinline__ void store(O* p) const {
    static_assert(sizeof(O) == sizeof(S), "same width");
    uint4 u;
    O* e = reinterpret_cast<O*>(&u);
#pragma unroll
    for (int i = 0; i < V; ++i) e[i] = cvt<O>(v[i]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};

// A warp's 16 x 32 tile of sums, rounded to O, written to dst (row
// stride ld elements; rows m0 .., columns n0 .. below N, N a multiple of
// 8) through the warp's staging tile `stage` (16 rows of kStageW O):
// whole 16-byte pieces a lane in place of a lane's scattered elements
template <typename O>
constexpr int kStageW = 32 + 16 / (int)sizeof(O);

template <typename O, class F>
__device__ __forceinline__ void store_tile(F& f, O* stage, O* dst,
                                           long long ld, int m0, int n0,
                                           int N) {
  constexpr int V = 16 / sizeof(O), LS = kStageW<O>;
  const int lane = threadIdx.x & 31, cols = min(32, N - n0);
  f.each(0, 0, cols, [&](int m, int n, float& x) {
    stage[m * LS + n] = cvt<O>(x);
  });
  __syncwarp();
  for (int i = lane; i < 16 * (32 / V); i += 32) {
    const int r = i / (32 / V), c = (i % (32 / V)) * V;
    if (c < cols)
      *reinterpret_cast<uint4*>(dst + (m0 + r) * ld + n0 + c) =
          *reinterpret_cast<const uint4*>(stage + r * LS + c);
  }
  __syncwarp();
}

}  // namespace tl_seq
