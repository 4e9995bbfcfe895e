// Row softmax of a 2-D array, for Hopper (sm_90a).
//
// Replaces the TPU kernel of tilelang_mesh_tpu/ops/softmax.py:
//   softmax_kernel (:29) -> tl_softmax
// Same contract:
//   X (M, N) float32, bfloat16 or float16, contiguous; Y (M, N) in the
//   output type (float32, bfloat16 or float16, the input's by default).
//   In float32 and the exp2 domain: m = rowmax(x);
//   y = exp2((x - m) * log2e) / sum_j exp2((x_j - m) * log2e).
//   A row that is all -inf, or holds +inf (or NaN), is NaN throughout, as
//   the TPU kernel's (x - m) makes it there.
//
// Bound: bytes. Each element is read once and written once, a few
// flops apiece, far below the card's balance point: the least time is
// M * N * (in + out bytes) over the memory rate.
//
// Design: the TPU kernel holds block_M whole rows in VMEM; a vocabulary
// row (N 201088, 786 KB in float32) fits in no block's 227 KB of shared
// memory. Three kernels, one a call, by the host's path rule
// (ops/softmax.py::softmax_path, passed here as its code):
//   0 softmax_rows, N <= 1024: a group of G lanes (a power of two) holds
//     a whole row in registers, E elements a lane, read with 16-byte
//     loads where the row's bytes allow; several rows share a warp. The
//     row is read once: its max and its sum by log2 G shuffle rounds
//     each, then one write. No online rescale: the row is at hand.
//   1 softmax_block_rows, rows up to kStashMax (and wider rows the
//     cluster kernel does not take): one block of 1024 threads a row,
//     an online (max, sum) in one read, the first `cap` elements kept in
//     shared memory as float32 as they are read (each thread keeps, and
//     later reads back, only its own elements, so no barrier guards
//     them); a wider row re-reads its tail. Eight loads in flight a
//     thread in each pass (one in flight left the second pass
//     latency-bound).
//   2 softmax_cluster, the vocabulary row: a cluster of C CTAs (2, 4 or
//     8) a row, each CTA a slice of at most kSliceMax bytes, so that two
//     CTAs share an SM and one's write phase overlaps the other's load.
//     One thread brings the slice into shared memory by bulk copies
//     (cp.async.bulk, kChunks of them, each on its own mbarrier, so the
//     (m, l) pass starts as the first lands); the CTA reduces its (m, l),
//     every CTA reads all C pairs through distributed shared memory and
//     merges them in rank order (the same bits in every CTA and every
//     call), then writes its slice from shared memory. The row is read
//     from device memory once.
// No tensor cores and no TMA tensor maps: plain coalesced loads, and
// bulk copies of contiguous bytes. scripts/softmax_decode_ab.py times
// the three against the earlier kernels and torch.softmax, and the
// cluster kernel at other CTA sizes and counts of bulk copies (a copy of
// this file with kClusterThreads or kChunks changed) against the values
// kept here.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gemm_sm90.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowsMax = 1024;       // widest row of the register kernel
constexpr int kRowsElems = 32;       // most elements a lane holds there
constexpr int kRowsThreads = 128;    // its block (256 timed 2-4 % slower)
constexpr int kThreads = 1024;       // threads a block in the wide kernel
constexpr int kStashMax = 48 * 1024; // float32 elements kept in shared
constexpr int kRed = 72;             // reduction slots before the stash
constexpr int kUnroll = 8;           // loads in flight a thread, each pass
constexpr int kClusterThreads = 256; // threads a CTA in the cluster kernel
constexpr int kSliceMax = 112 * 1024;  // bytes of a cluster CTA's slice
constexpr int kChunks = 2;           // its bulk copies (and mbarriers)
constexpr int kSliceAt = 512;        // the slice's offset in shared memory

enum Path { kRowsPath = 0, kBlockPath = 1, kClusterPath = 2 };

__device__ __forceinline__ float ld(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float ld(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float ld(const __half* p, long long i) {
  return __half2float(p[i]);
}
__device__ __forceinline__ void st(float* p, long long i, float x) {
  p[i] = x;
}
__device__ __forceinline__ void st(__nv_bfloat16* p, long long i, float x) {
  p[i] = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void st(__half* p, long long i, float x) {
  p[i] = __float2half_rn(x);
}

// One element into a thread's running (m, l), l = sum exp2((x - m) c).
// Rescales only when the max grows. A +inf (or NaN) makes l NaN, as the
// TPU kernel's (inf - inf) does; a -inf adds nothing (and an all -inf
// row keeps m = -inf, l = 0, so the second pass gives NaN).
__device__ __forceinline__ void add(float& m, float& l, float x) {
  if (x > m) {
    l = fmaf(l, exp2f((m - x) * kLog2e), 1.f);
    m = x;
    if (x == INFINITY) l = NAN;
  } else if (x != -INFINITY) {
    l += exp2f((x - m) * kLog2e);
  }
}

// (m, l) <- the merge of two running pairs. A pair with m = -inf adds
// l * 0: nothing, or NaN where it saw a NaN (its l is 0 or NaN).
__device__ __forceinline__ void merge(float& m, float& l, float m2,
                                      float l2) {
  const float mn = fmaxf(m, m2);
  const float a = m == -INFINITY ? l * 0.f : l * exp2f((m - mn) * kLog2e);
  const float b =
      m2 == -INFINITY ? l2 * 0.f : l2 * exp2f((m2 - mn) * kLog2e);
  m = mn;
  l = a + b;
}

__device__ __forceinline__ void warp_merge(float& m, float& l) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(kFull, m, off);
    const float l2 = __shfl_xor_sync(kFull, l, off);
    merge(m, l, m2, l2);
  }
}

// the larger of a and b, NaN where either is (fmaxf drops a NaN)
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float prob(float x, float m, float l) {
  return exp2f((x - m) * kLog2e) / l;
}

// ---------------------------------------------------------------------------
// V consecutive elements: 1, or 16 bytes (4 float32, 8 bfloat16 / float16),
// or 4 bfloat16 / float16 (8 bytes)
// ---------------------------------------------------------------------------

template <typename TI, int V>
__device__ __forceinline__ void ld_vec(const TI* p, float* f) {
  if constexpr (V == 1) {
    f[0] = ld(p, 0);
  } else if constexpr (sizeof(TI) == 4) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    f[0] = r.x;
    f[1] = r.y;
    f[2] = r.z;
    f[3] = r.w;
  } else {
    // element 0 is the low half of a word (little-endian); a bfloat16 is
    // the high half of a float32
    uint32_t w[4];
    if constexpr (V == 4) {
      const uint2 r = *reinterpret_cast<const uint2*>(p);
      w[0] = r.x;
      w[1] = r.y;
    } else {
      const uint4 r = *reinterpret_cast<const uint4*>(p);
      w[0] = r.x;
      w[1] = r.y;
      w[2] = r.z;
      w[3] = r.w;
    }
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      if constexpr (std::is_same<TI, __nv_bfloat16>::value) {
        f[2 * i] = __uint_as_float(w[i] << 16);
        f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      } else {
        f[2 * i] = __half2float(__ushort_as_half((unsigned short)w[i]));
        f[2 * i + 1] =
            __half2float(__ushort_as_half((unsigned short)(w[i] >> 16)));
      }
    }
  }
}

// two floats rounded to a 16-bit type, packed low first
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16*, float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t pack2(__half*, float a, float b) {
  const __half2 h = __floats2half2_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// V outputs from f, at p (aligned to V outputs), rounded as st() rounds
template <typename TO, int V>
__device__ __forceinline__ void st_vec(TO* p, const float* f) {
  if constexpr (V == 1) {
    st(p, 0, f[0]);
  } else if constexpr (sizeof(TO) == 4) {
#pragma unroll
    for (int i = 0; i < V / 4; ++i)
      reinterpret_cast<float4*>(p)[i] =
          make_float4(f[4 * i], f[4 * i + 1], f[4 * i + 2], f[4 * i + 3]);
  } else if constexpr (V == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(
        pack2((TO*)nullptr, f[0], f[1]), pack2((TO*)nullptr, f[2], f[3]));
  } else {
    *reinterpret_cast<uint4*>(p) = make_uint4(
        pack2((TO*)nullptr, f[0], f[1]), pack2((TO*)nullptr, f[2], f[3]),
        pack2((TO*)nullptr, f[4], f[5]), pack2((TO*)nullptr, f[6], f[7]));
  }
}

// ---------------------------------------------------------------------------
// 0: a row in the registers of G lanes
// ---------------------------------------------------------------------------

// Lane j of a row's group holds the V-element pieces c * G + j (c < E /
// V), -inf past the row (they add exp2(-inf) = 0). Every lane takes part
// in the shuffles, a row past M or not.
template <typename TI, typename TO, int E, int V>
__global__ void __launch_bounds__(kRowsThreads)
softmax_rows(const TI* __restrict__ x, TO* __restrict__ y, int M, int N,
             int G) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = t / G;
  const int j = threadIdx.x & (G - 1);
  const bool live = row < M;
  const TI* xr = x + row * N;
  TO* yr = y + row * N;
  float v[E];
#pragma unroll
  for (int c = 0; c < E / V; ++c) {
    const int i = (c * G + j) * V;
    if (live && i < N) {
      ld_vec<TI, V>(xr + i, v + c * V);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) v[c * V + e] = -INFINITY;
    }
  }
  float m = v[0];
#pragma unroll
  for (int e = 1; e < E; ++e) m = fmaxf(m, v[e]);
  for (int off = G >> 1; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  float l = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    v[e] = exp2f((v[e] - m) * kLog2e);
    l += v[e];
  }
  for (int off = G >> 1; off > 0; off >>= 1)
    l += __shfl_xor_sync(kFull, l, off);
#pragma unroll
  for (int e = 0; e < E; ++e) v[e] = v[e] / l;
#pragma unroll
  for (int c = 0; c < E / V; ++c) {
    const int i = (c * G + j) * V;
    if (live && i < N) st_vec<TO, V>(yr + i, v + c * V);
  }
}

// ---------------------------------------------------------------------------
// 1: a row a block
// ---------------------------------------------------------------------------

template <typename TI, typename TO>
__global__ void __launch_bounds__(kThreads)
softmax_block_rows(const TI* __restrict__ x, TO* __restrict__ y, int N,
                   int cap) {
  extern __shared__ float smem[];
  float* red = smem;          // [32][2] per warp, then the row's (m, l)
  float* stash = smem + kRed;  // [cap] the row's first elements, float32
  const int t = threadIdx.x, lane = t & 31, w = t / 32;
  const long long row = blockIdx.x;
  const TI* xr = x + row * N;
  TO* yr = y + row * N;

  float m = -INFINITY, l = 0.f;
  int j = t;
  for (; j + (kUnroll - 1) * kThreads < N; j += kUnroll * kThreads) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = ld(xr, j + u * kThreads);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j + u * kThreads < cap) stash[j + u * kThreads] = v[u];
      add(m, l, v[u]);
    }
  }
  for (; j < N; j += kThreads) {
    const float v = ld(xr, j);
    if (j < cap) stash[j] = v;
    add(m, l, v);
  }

  warp_merge(m, l);
  if (lane == 0) {
    red[2 * w] = m;
    red[2 * w + 1] = l;
  }
  __syncthreads();
  if (w == 0) {
    m = lane < kThreads / 32 ? red[2 * lane] : -INFINITY;
    l = lane < kThreads / 32 ? red[2 * lane + 1] : 0.f;
    warp_merge(m, l);
    if (lane == 0) {
      red[64] = m;
      red[65] = l;
    }
  }
  __syncthreads();
  m = red[64];
  l = red[65];

  for (j = t; j + (kUnroll - 1) * kThreads < N; j += kUnroll * kThreads) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = j + u * kThreads;
      v[u] = i < cap ? stash[i] : ld(xr, i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      st(yr, j + u * kThreads, prob(v[u], m, l));
  }
  for (; j < N; j += kThreads) {
    const float v = j < cap ? stash[j] : ld(xr, j);
    st(yr, j, prob(v, m, l));
  }
}

// ---------------------------------------------------------------------------
// 2: a row a cluster
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// CTA r of a row's cluster holds its elements [r * slice, (r + 1) *
// slice) (slice a multiple of V, the last CTA's cut at N). Shared memory:
// kChunks mbarriers at 0, the CTA's (m, l) at 64 (read by its peers), the
// row's at 72, the warps' pairs at 128, the slice at kSliceAt. The write
// multiplies by the row's 1 / l (one divide a thread, not one an element).
template <typename TI, typename TO>
__global__ void __launch_bounds__(kClusterThreads, 2)
softmax_cluster(const TI* __restrict__ x, TO* __restrict__ y, int N,
                int slice) {
  constexpr int V = 16 / (int)sizeof(TI);
  extern __shared__ __align__(128) unsigned char sm[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm);
  float* stat = reinterpret_cast<float*>(sm + 64);
  float* fin = stat + 2;
  float* red = reinterpret_cast<float*>(sm + 128);
  TI* buf = reinterpret_cast<TI*>(sm + kSliceAt);
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const long long row = blockIdx.x / C;
  const int lo = rank * slice;
  const int n = N - lo < slice ? (N - lo > 0 ? N - lo : 0) : slice;
  const int per = ((n + kChunks - 1) / kChunks + V - 1) / V * V;
  const int t = threadIdx.x, lane = t & 31, w = t / 32;
  const TI* src = x + row * N + lo;
  TO* dst = y + row * N + lo;

  if (t == 0) {
    for (int k = 0; k < kChunks; ++k) tl_sm90::mbar_init(&bar[k], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (t == 0) {
    for (int k = 0; k < kChunks; ++k) {
      const int a = k * per < n ? k * per : n;
      const int b = a + per < n ? a + per : n;
      const unsigned bytes = (unsigned)(b - a) * sizeof(TI);
      tl_sm90::mbar_expect_tx(&bar[k], bytes);
      if (bytes) tl_sm90::bulk_load(buf + a, src + a, bytes, &bar[k]);
    }
  }

  // this thread's (m, l): a chunk's max, then its sum under that max,
  // merged in; a chunk it saw only -inf in adds nothing, one with a NaN
  // makes l NaN
  float m = -INFINITY, l = 0.f;
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int a = k * per < n ? k * per : n;
    const int b = a + per < n ? a + per : n;
    tl_sm90::mbar_wait(&bar[k], 0);
    float mx = -INFINITY;
    for (int i = a + t * V; i < b; i += kClusterThreads * V) {
      float f[V];
      ld_vec<TI, V>(buf + i, f);
#pragma unroll
      for (int e = 0; e < V; ++e) mx = max_nan(mx, f[e]);
    }
    if (mx == -INFINITY) continue;
    float s = 0.f;
    for (int i = a + t * V; i < b; i += kClusterThreads * V) {
      float f[V];
      ld_vec<TI, V>(buf + i, f);
#pragma unroll
      for (int e = 0; e < V; ++e) s += exp2f((f[e] - mx) * kLog2e);
    }
    merge(m, l, mx, s);
  }
  warp_merge(m, l);
  if (lane == 0) {
    red[2 * w] = m;
    red[2 * w + 1] = l;
  }
  __syncthreads();
  if (w == 0) {
    m = lane < kClusterThreads / 32 ? red[2 * lane] : -INFINITY;
    l = lane < kClusterThreads / 32 ? red[2 * lane + 1] : 0.f;
    warp_merge(m, l);
    if (lane == 0) {
      stat[0] = m;
      stat[1] = l;
    }
  }
  cl.sync();  // every CTA's (m, l) is written

  // the row's (m, l): the C pairs merged in rank order, in every CTA
  if (w == 0) {
    float mr = -INFINITY, lr = 0.f;
    if (lane < C) {
      const float* p = cl.map_shared_rank(stat, lane);
      mr = p[0];
      lr = p[1];
    }
    m = -INFINITY;
    l = 0.f;
    for (int r = 0; r < C; ++r)
      merge(m, l, __shfl_sync(kFull, mr, r), __shfl_sync(kFull, lr, r));
    if (lane == 0) {
      fin[0] = m;
      fin[1] = l;
    }
  }
  __syncthreads();
  // done with the peers' shared memory; the wait before exit keeps ours
  // alive until they are done with it
  cluster_arrive();
  m = fin[0];
  const float rl = 1.f / fin[1];
  // 16 bytes a lane on the wider side, so that a warp's stores are
  // contiguous (16-bit in, float32 out: 8 bytes in, 16 out)
  constexpr int VW = 16 / (int)(sizeof(TI) > sizeof(TO) ? sizeof(TI)
                                                         : sizeof(TO));
  for (int i = t * VW; i < n; i += kClusterThreads * VW) {
    float f[VW];
    ld_vec<TI, VW>(buf + i, f);
#pragma unroll
    for (int e = 0; e < VW; ++e) f[e] = exp2f((f[e] - m) * kLog2e) * rl;
    st_vec<TO, VW>(dst + i, f);
  }
  cluster_wait();
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

template <typename TI, typename TO, int E, int V>
int launch_rows(const TI* x, TO* y, int M, int N, int G,
                cudaStream_t stream) {
  const long long blocks =
      ((long long)M * G + kRowsThreads - 1) / kRowsThreads;
  softmax_rows<TI, TO, E, V><<<(unsigned)blocks, kRowsThreads, 0, stream>>>(
      x, y, M, N, G);
  return (int)cudaGetLastError();
}

// E = the least power of two with G * E >= N; 16-byte pieces when the
// rows and the bases sit on 16 bytes and a lane holds one at least
template <typename TI, typename TO>
int run_rows(const TI* x, TO* y, int M, int N, int G,
             cudaStream_t stream) {
  constexpr int VEC = 16 / (int)sizeof(TI);
  if (N > kRowsMax || G < 1 || G > 32 || (G & (G - 1)))
    return (int)cudaErrorInvalidValue;
  const int E = pow2_at_least((N + G - 1) / G);
  if (E > kRowsElems) return (int)cudaErrorInvalidValue;
  const bool vec = ((uintptr_t)x % 16 == 0) && ((uintptr_t)y % 16 == 0) &&
                   (N * sizeof(TI)) % 16 == 0 && E >= VEC;
#define TL_ROWS(EE)                                                    \
  case EE:                                                             \
    if constexpr (EE >= VEC)                                           \
      if (vec) return launch_rows<TI, TO, EE, VEC>(x, y, M, N, G,      \
                                                   stream);            \
    return launch_rows<TI, TO, EE, 1>(x, y, M, N, G, stream);
  switch (E) {
    TL_ROWS(1)
    TL_ROWS(2)
    TL_ROWS(4)
    TL_ROWS(8)
    TL_ROWS(16)
    TL_ROWS(32)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef TL_ROWS
}

template <typename TI, typename TO>
int run_block(const TI* x, TO* y, int M, int N, cudaStream_t stream) {
  const int cap = N < kStashMax ? N : kStashMax;
  const size_t bytes = sizeof(float) * (kRed + (size_t)cap);
  cudaError_t err = cudaFuncSetAttribute(
      softmax_block_rows<TI, TO>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  softmax_block_rows<TI, TO><<<M, kThreads, bytes, stream>>>(x, y, N, cap);
  return (int)cudaGetLastError();
}

// elements of a cluster CTA's slice (a multiple of 16 bytes), or 0 when
// the row does not take the cluster kernel at C
template <typename TI>
int cluster_slice(int N, int C) {
  constexpr int VEC = 16 / (int)sizeof(TI);
  if ((C != 2 && C != 4 && C != 8) || N % VEC) return 0;
  const int slice = ((N + C - 1) / C + VEC - 1) / VEC * VEC;
  if ((long long)slice * sizeof(TI) > kSliceMax || (C - 1) * slice >= N)
    return 0;
  return slice;
}

template <typename TI, typename TO>
cudaLaunchConfig_t cluster_config(int M, int C, int slice,
                                  cudaLaunchAttribute* attr,
                                  cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((long long)M * C));
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = kSliceAt + (size_t)slice * sizeof(TI);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename TI, typename TO>
int run_cluster(const TI* x, TO* y, int M, int N, int C,
                cudaStream_t stream) {
  const int slice = cluster_slice<TI>(N, C);
  if (!slice || (uintptr_t)x % 16 || (uintptr_t)y % 16 ||
      (long long)M * C > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config<TI, TO>(M, C, slice, attr, stream);
  const auto kern = softmax_cluster<TI, TO>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)cfg.dynamicSmemBytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, kern, x, y, N, slice);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// (CTAs an SM, clusters the card runs at once) of the cluster kernel at
// (N, C)
template <typename TI, typename TO>
int cluster_fit(int N, int C, int* blocks_per_sm, int* clusters) {
  const int slice = cluster_slice<TI>(N, C);
  if (!slice) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config<TI, TO>(1024, C, slice, attr, nullptr);
  const auto kern = softmax_cluster<TI, TO>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)cfg.dynamicSmemBytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kern, kClusterThreads, cfg.dynamicSmemBytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(clusters, kern, &cfg);
  return (int)err;
}

struct Call {
  const void* x;
  void* y;
  int M, N, path, param;
  cudaStream_t stream;
  int* out0;
  int* out1;
};

template <typename TI, typename TO>
int run(const Call& c) {
  const TI* x = static_cast<const TI*>(c.x);
  TO* y = static_cast<TO*>(c.y);
  switch (c.path) {
    case kRowsPath:
      return run_rows<TI, TO>(x, y, c.M, c.N, c.param, c.stream);
    case kBlockPath:
      return run_block<TI, TO>(x, y, c.M, c.N, c.stream);
    case kClusterPath:
      if (c.out0) return cluster_fit<TI, TO>(c.N, c.param, c.out0, c.out1);
      return run_cluster<TI, TO>(x, y, c.M, c.N, c.param, c.stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename TI>
int run_out(int out_code, const Call& c) {
  switch (out_code) {
    case 0:
      return run<TI, float>(c);
    case 1:
      return run<TI, __nv_bfloat16>(c);
    case 2:
      return run<TI, __half>(c);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch(int in_code, int out_code, const Call& c) {
  switch (in_code) {
    case 0:
      return run_out<float>(out_code, c);
    case 1:
      return run_out<__nv_bfloat16>(out_code, c);
    case 2:
      return run_out<__half>(out_code, c);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches the kernel of `path` (0 rows in registers, `param` lanes a
// row; 1 a row a block; 2 a row a cluster of `param`
// CTAs) on `stream`; returns the first CUDA error (0 = launched), or
// cudaErrorInvalidValue for a type code outside 0 float32, 1 bfloat16,
// 2 float16, or a shape or alignment the path does not take. The Python
// wrapper checks shapes, types and contiguity and picks the path.
extern "C" int tl_softmax(const void* x, void* y, int M, int N, int in_code,
                          int out_code, int path, int param,
                          void* stream) {
  if (M < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(in_code, out_code,
                  Call{x, y, M, N, path, param,
                       static_cast<cudaStream_t>(stream), nullptr, nullptr});
}

// The cluster kernel's fit at a row of N elements over C CTAs: CTAs an SM
// (`blocks_per_sm`) and clusters the card runs at once (`clusters`), by
// the occupancy calculator. Launches nothing.
extern "C" int tl_softmax_cluster_fit(int N, int in_code, int out_code,
                                      int C, int* blocks_per_sm,
                                      int* clusters) {
  return dispatch(in_code, out_code,
                  Call{nullptr, nullptr, 1, N, kClusterPath, C, nullptr,
                       blocks_per_sm, clusters});
}
