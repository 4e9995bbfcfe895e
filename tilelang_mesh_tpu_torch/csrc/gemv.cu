// GEMV for Hopper (sm_90a): c = B @ a.
//
// Replaces one TPU kernel of tilelang_mesh_tpu/ops/gemm_variants.py:
//   gemv_kernel (:169) -> tl_gemv
//     a (K,), B (N, K) row-major, both float32, bfloat16 or float16; c (N,)
//     in float32, bfloat16, float16 or float8 e4m3 (gemm_tile.cuh's
//     rounding): c[n] = sum_k B[n, k] a[k], products and sums in float32.
//
// Bound: bytes. Every element of B is read once and used once (2 flops a
// 2-byte element, far below the card's 295 a byte), so the kernel is a
// stream over B at the memory's rate: at LLaMA-2-7B's MLP (N 11008, K
// 4096, bf16) 90.2 MB, 27 us; its LM head (N 32000) 262 MB, 78 us.
// Two kernels; the host's rule (ops/gemm_variants.py::gemv_path) picks
// one a call and passes its plan:
//
// `gemv_bulk` (16-byte aligned a and B, K * size a multiple of 16, at
// least one row a block): a grid of the card's SMs times a small
// multiple, block i owning the contiguous rows [i N / grid, (i + 1) N /
// grid), so every SM streams the same bytes and no block runs in a tail
// wave. One thread streams its span: 1-D bulk copies (cp.async.bulk) of
// `rows` whole rows a stage into a ring of `stages` stages under full /
// empty mbarriers, `a` by one more bulk copy into its own buffer. It
// issues `a` and the first stages before the block's one barrier (which
// makes the mbarriers' initialisation visible to the other warps), so
// the stream starts at once. Four consumer warps take a stage's rows in
// turn, 16 bytes a lane against `a` in shared memory, float32 partial
// sums and a shuffle reduction (the old kernel's order of sums), and
// release the stage. A block's stages come in one after another, about a
// microsecond each and little faster for more stages in flight, so the
// plan runs several blocks an SM (PERF.md, #18).

// `gemv` (every other call): a warp owns kRows rows of B and reads them
// along K, 16 bytes a lane (kRows loads in flight an iteration,
// unrolled), against `a` staged in shared memory a chunk of 16 KB at a
// time; each lane keeps float32 partial sums, a warp shuffle reduces
// them. Where K * size is no multiple of 16 bytes (rows then do not
// start on 16 bytes) or a tensor is misaligned, lanes read one element
// at a time: correct for any K, at a fraction of the rate.

#include "gemm_sm90.cuh"
#include "gemm_tile.cuh"

namespace {

using tl_gemm::store_as;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 2;                      // rows of B a warp
constexpr int kChunkBytes = 16 * 1024;        // of `a` in shared memory

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

// sum of the products of the 16 bytes at w and x as T elements
__device__ __forceinline__ float dot16(const uint4& w, const uint4& x,
                                       const float*) {
  return __uint_as_float(w.x) * __uint_as_float(x.x) +
         __uint_as_float(w.y) * __uint_as_float(x.y) +
         __uint_as_float(w.z) * __uint_as_float(x.z) +
         __uint_as_float(w.w) * __uint_as_float(x.w);
}
template <typename H2, typename F>
__device__ __forceinline__ float dot16_h(const uint4& w, const uint4& x,
                                         F widen) {
  const H2* p = reinterpret_cast<const H2*>(&w);
  const H2* q = reinterpret_cast<const H2*>(&x);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = widen(p[i]), v = widen(q[i]);
    s = fmaf(u.x, v.x, s);
    s = fmaf(u.y, v.y, s);
  }
  return s;
}
__device__ __forceinline__ float dot16(const uint4& w, const uint4& x,
                                       const __nv_bfloat16*) {
  return dot16_h<__nv_bfloat162>(
      w, x, [](__nv_bfloat162 h) { return __bfloat1622float2(h); });
}
__device__ __forceinline__ float dot16(const uint4& w, const uint4& x,
                                       const __half*) {
  return dot16_h<__half2>(w, x,
                          [](__half2 h) { return __half22float2(h); });
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
gemv(const T* __restrict__ a, const T* __restrict__ b, void* __restrict__ c,
     int N, int K, int out) {
  constexpr int KC = kChunkBytes / sizeof(T);  // elements of a a chunk
  constexpr int V = 16 / sizeof(T);            // elements in 16 bytes
  __shared__ __align__(16) T a_s[KC];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = (blockIdx.x * kWarps + warp) * kRows;
  // rows past N read row N - 1 and are not stored
  const T* rows[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    rows[r] = b + (long long)min(n0 + r, N - 1) * K;
  float acc[kRows] = {};

  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kc = min(KC, K - k0);
    __syncthreads();                   // the last chunk's readers are done
    if (VEC) {
      for (int i = threadIdx.x * V; i < kc; i += kThreads * V)
        *reinterpret_cast<uint4*>(a_s + i) =
            *reinterpret_cast<const uint4*>(a + k0 + i);
    } else {
      for (int i = threadIdx.x; i < kc; i += kThreads) a_s[i] = a[k0 + i];
    }
    __syncthreads();
    if (VEC) {
#pragma unroll 4
      for (int i = lane * V; i < kc; i += 32 * V) {
        const uint4 x = *reinterpret_cast<const uint4*>(a_s + i);
        uint4 w[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          w[r] = __ldg(reinterpret_cast<const uint4*>(rows[r] + k0 + i));
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          acc[r] += dot16(w[r], x, static_cast<const T*>(nullptr));
      }
    } else {
      for (int i = lane; i < kc; i += 32) {
        const float x = to_f(a_s[i]);
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          acc[r] = fmaf(to_f(rows[r][k0 + i]), x, acc[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float v = acc[r];
#pragma unroll
    for (int o = 16; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0 && n0 + r < N) store_as(c, n0 + r, out, v);
  }
}

// ---------------------------------------------------------------------------
// gemv_bulk
// ---------------------------------------------------------------------------

constexpr int kBulkWarps = 4;                  // consumer warps
constexpr int kBulkThreads = 32 * (kBulkWarps + 1);

// the dynamic shared memory of a plan: `a`, the ring, its barriers
__host__ __device__ constexpr size_t bulk_smem(int K, int esize, int rows,
                                               int stages) {
  return (size_t)K * esize + (size_t)stages * rows * K * esize +
         8 * (2 * (size_t)stages + 1);
}

template <typename T>
__global__ void __launch_bounds__(kBulkThreads)
gemv_bulk(const T* __restrict__ a, const T* __restrict__ b,
          void* __restrict__ c, int N, int K, int out, int rows,
          int stages) {
  constexpr int V = 16 / sizeof(T);             // elements in 16 bytes
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const unsigned row_bytes = (unsigned)K * sizeof(T);
  const T* a_s = reinterpret_cast<const T*>(smem_raw);
  unsigned char* ring = smem_raw + row_bytes;
  const unsigned stage_bytes = (unsigned)rows * row_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * stage_bytes);
  uint64_t* empty = full + stages;
  uint64_t* a_bar = empty + stages;
  // this block's rows: an equal share of N, the first N % grid one more
  const int base = N / gridDim.x, extra = N % gridDim.x;
  const int n0 = blockIdx.x * base + min((int)blockIdx.x, extra);
  const int span = base + ((int)blockIdx.x < extra);
  const int n_st = (span + rows - 1) / rows;    // stages of this span
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // stage st: rows n0 + st rows .. of B into slot st % stages
  auto issue = [&](int st) {
    const int s = st % stages;
    const unsigned bytes = (unsigned)min(rows, span - st * rows) * row_bytes;
    tl_sm90::mbar_expect_tx(&full[s], bytes);
    tl_sm90::bulk_load(ring + s * stage_bytes,
                       b + (long long)(n0 + st * rows) * K, bytes, &full[s]);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      tl_sm90::mbar_init(&full[s], 1);
      tl_sm90::mbar_init(&empty[s], kBulkWarps);   // a consumer warp each
    }
    tl_sm90::mbar_init(a_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    tl_sm90::mbar_expect_tx(a_bar, row_bytes);
    tl_sm90::bulk_load(smem_raw, a, row_bytes, a_bar);
    for (int st = 0; st < min(stages, n_st); ++st) issue(st);
  }
  __syncthreads();            // the barriers are initialised; B is in flight

  if (warp == 0) {            // the producer: the rest of the span
    if (lane == 0)
      for (int st = stages; st < n_st; ++st) {
        tl_sm90::mbar_wait(&empty[st % stages], ((st / stages) & 1) ^ 1);
        issue(st);
      }
    return;
  }
  // consumer warp cw takes rows cw, cw + kBulkWarps, ... of each stage
  const int cw = warp - 1;
  tl_sm90::mbar_wait(a_bar, 0);
  for (int st = 0; st < n_st; ++st) {
    const int s = st % stages;
    tl_sm90::mbar_wait(&full[s], (st / stages) & 1);
    const int nr = min(rows, span - st * rows);
    for (int r = cw; r < nr; r += kBulkWarps) {
      const T* row = reinterpret_cast<const T*>(ring + s * stage_bytes +
                                                r * row_bytes);
      float acc = 0.f;
#pragma unroll 4
      for (int i = lane * V; i < K; i += 32 * V)
        acc += dot16(*reinterpret_cast<const uint4*>(row + i),
                     *reinterpret_cast<const uint4*>(a_s + i),
                     static_cast<const T*>(nullptr));
#pragma unroll
      for (int o = 16; o > 0; o /= 2)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0) store_as(c, n0 + st * rows + r, out, acc);
    }
    __syncwarp();
    if (lane == 0) tl_sm90::mbar_arrive(&empty[s]);
  }
}

template <typename T>
void launch(const void* a, const void* b, void* c, int N, int K, int out,
            cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0 && K % V == 0;
  const unsigned blocks = (unsigned)((N + kWarps * kRows - 1) /
                                     (kWarps * kRows));
  const auto* pa = static_cast<const T*>(a);
  const auto* pb = static_cast<const T*>(b);
  if (vec)
    gemv<T, true><<<blocks, kThreads, 0, s>>>(pa, pb, c, N, K, out);
  else
    gemv<T, false><<<blocks, kThreads, 0, s>>>(pa, pb, c, N, K, out);
}

// the plan of gemv_bulk (ops/gemm_variants.py::gemv_bulk_plan): `blocks`
// blocks, `rows` rows of B a stage, `stages` stages; cudaErrorInvalidValue
// when the plan does not fit the call
template <typename T>
int launch_bulk(const void* a, const void* b, void* c, int N, int K, int out,
                int blocks, int rows, int stages, cudaStream_t s) {
  const size_t smem = bulk_smem(K, sizeof(T), rows, stages);
  if (blocks < 1 || blocks > N || rows < 1 || stages < 2 ||
      (K * sizeof(T)) % 16 || reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(b) % 16 || smem > tl_sm90::kSmemOptin)
    return (int)cudaErrorInvalidValue;
  const auto kern = gemv_bulk<T>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  kern<<<blocks, kBulkThreads, smem, s>>>(static_cast<const T*>(a),
                                          static_cast<const T*>(b), c, N, K,
                                          out, rows, stages);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* a, const void* b, void* c, int N, int K, int out,
             int path, int blocks, int rows, int stages, cudaStream_t s) {
  if (path == 1)
    return launch_bulk<T>(a, b, c, N, K, out, blocks, rows, stages, s);
  if (path != 0) return (int)cudaErrorInvalidValue;
  launch<T>(a, b, c, N, K, out, s);
  return (int)cudaGetLastError();
}

}  // namespace

// a (K,), b (N, K) of in_type (kF32, kBF16 or kF16: gemm_tile.cuh DType)
// -> c (N,) of out_type (kF32, kBF16, kF16 or kFP8). `path` 0 runs gemv,
// 1 gemv_bulk at the plan (blocks, rows a stage, stages; ignored by
// path 0). Launches on `stream` and returns cudaGetLastError() (0 =
// launched), cudaErrorInvalidValue for a path or plan the call does not
// take; the Python wrapper checks shapes, types and devices before
// calling.
extern "C" int tl_gemv(const void* a, const void* b, void* c, int N, int K,
                       int in_type, int out_type, int path, int blocks,
                       int rows, int stages, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (in_type == tl_gemm::kF32)
    return dispatch<float>(a, b, c, N, K, out_type, path, blocks, rows,
                           stages, s);
  if (in_type == tl_gemm::kBF16)
    return dispatch<__nv_bfloat16>(a, b, c, N, K, out_type, path, blocks,
                                   rows, stages, s);
  return dispatch<__half>(a, b, c, N, K, out_type, path, blocks, rows,
                          stages, s);
}
