// DeepSeek-MLA split-KV decode, for Hopper (sm_90a).
//
// Replaces the TPU kernel tilelang_mesh_tpu/ops/mla.py :: mla_decode_kernel.
// Same contract:
//   Qc  (B, H, DC)       float32, bfloat16 or float16, contiguous
//   Qr  (B, H, DR)       same type
//   CKV (B, S, DC)       same type; DC contiguous, batch and row strides
//   KPE (B, S, DR)       are arguments, so the serving path passes the two
//                        column slices of its gathered [ckv | kpe] rows
//   Op  (B, ns, H, DC)   float32 unnormalised sum of p * ckv
//   Mp  (B, ns, H)       float32 running max of the scores, exp2 domain
//   Lp  (B, ns, H)       float32 sum of exp2(score - Mp)
// with score = (qc . ckv + qr . kpe) * sm_scale * log2(e) and split s
// covering the keys [s*chunk, (s+1)*chunk), chunk = S / ns. The latent
// is both key and value. In bfloat16 and float16, p is rounded to the
// input type before p * ckv (the TPU kernel's copy of S_f to an
// input-typed fragment); l sums the unrounded p. No mask: every key of a
// split is live.
//
// Bound: operations in float32 (2*(DC+DR) + 2*DC flops per key and head
// against (DC+DR) * 4 bytes per key shared by all H heads: at H = 128
// that is ~500 flops a byte), bytes in bfloat16 on the tensor cores.
// This first kernel runs on the CUDA cores in both.
//
// Design. The TPU kernel keeps all H heads of one (batch, split) in one
// (H, block_N) score tile and an (H, DC) float32 accumulator; at
// DeepSeek-V3's H = 128, DC = 512 that accumulator is 256 KiB, more than
// a block's shared memory or an SM's registers. So a block owns a group
// of kG = 16 heads of one (batch, split), and the grid is (head group,
// split, batch) with the head group fastest: the H / kG blocks that
// stream the same latent rows run together and share them through L2, so
// device memory sees about one read of the cache. Per tile of kT = 32
// keys the block
//   1. stages the keys' [ckv | kpe] rows once in shared memory as float32
//      (16-byte loads; bfloat16 widened), and uses them for the scores
//      and for p * ckv;
//   2. scores: 32 threads each own 4 heads x 4 keys, and the 8 lanes of
//      a lane group split the DC + DR dot products (lane k takes the
//      16-byte columns k, k+8, ...; a quarter-warp then reads 128
//      contiguous bytes, free of bank conflicts) and merge by shuffles;
//   3. online softmax: one warp per 2 heads, one lane per key, exp2;
//   4. acc += p * ckv: each thread owns 8 heads x 4 latent columns.
// The accumulator lives in registers (32 floats a thread at DC = 512).
// No cp.async double buffering and no tensor cores yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "split_kv_decode.cuh"

namespace {

using tl_splitkv::kBF16;
using tl_splitkv::kF16;
using tl_splitkv::kF32;
using tl_splitkv::unpack;

constexpr int kThreads = 256;
constexpr int kG = 16;    // query heads per block
constexpr int kT = 32;    // keys per tile
constexpr unsigned kFull = 0xffffffffu;

// element i of an input of type code DT, as float
template <int DT>
__device__ __forceinline__ float load1(const void* p, long long i) {
  if constexpr (DT == kBF16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  else if constexpr (DT == kF16)
    return __half2float(static_cast<const __half*>(p)[i]);
  else
    return static_cast<const float*>(p)[i];
}

// p as the TPU kernel keeps it in an input-typed fragment
template <int DT>
__device__ __forceinline__ float round_to(float p) {
  if constexpr (DT == kBF16)
    return __bfloat162float(__float2bfloat16_rn(p));
  else if constexpr (DT == kF16)
    return __half2float(__float2half_rn(p));
  else
    return p;
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <int DC, int DR>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kT * (DC + DR) + (size_t)kG * (DC + DR) +
                          2 * kG * kT + 3 * kG);
}

template <int DC, int DR, int DT>
__global__ void __launch_bounds__(kThreads, 2)
mla_decode(const void* __restrict__ qc, const void* __restrict__ qr,
           const void* __restrict__ ckv, const void* __restrict__ kpe,
           float* __restrict__ op, float* __restrict__ mp,
           float* __restrict__ lp, int H, int n_split, int chunk,
           long long csb, long long csr, long long ksb, long long ksr,
           float scale) {
  constexpr int DK = DC + DR;            // floats per staged row
  constexpr int NC1 = DK / 4;            // float4 columns of a staged row
  constexpr int NC2 = DC / 4;            // float4 columns of the latent
  constexpr int VEC = DT == kF32 ? 4 : 8;   // elements per 16-byte load
  constexpr int NCC = DC / VEC, NCL = (DC + DR) / VEC;   // loads per row
  constexpr int LOADS = (kT * NCL + kThreads - 1) / kThreads;
  constexpr int BATCH = LOADS < 8 ? LOADS : 8;
  constexpr int NU = (kG / 8) * NC2;     // phase-2 units: 8 heads x float4
  constexpr int UPT = (NU + kThreads - 1) / kThreads;
  static_assert(DC % 8 == 0 && DR % 8 == 0, "unsupported latent widths");

  extern __shared__ float4 smem4[];
  float* s_kv = reinterpret_cast<float*>(smem4);   // [kT][DK]
  float* s_q = s_kv + kT * DK;                       // [kG][DK]
  float* s_s = s_q + kG * DK;                        // scores [kG][kT]
  float* s_p = s_s + kG * kT;                        // p [kT][kG]
  float* s_m = s_p + kT * kG;                        // [kG]
  float* s_l = s_m + kG;
  float* s_a = s_l + kG;                             // rescale of the tile
  const float4* kv4 = reinterpret_cast<const float4*>(s_kv);
  const float4* q4 = reinterpret_cast<const float4*>(s_q);
  const float4* p4 = reinterpret_cast<const float4*>(s_p);

  const int hg = blockIdx.x, s = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const long long key0 = (long long)s * chunk;

  // this block's query heads, zero past H
  for (int i = tid; i < kG * DK; i += kThreads) {
    const int h = hg * kG + i / DK, k = i % DK;
    float x = 0.f;
    if (h < H)
      x = k < DC ? load1<DT>(qc, ((long long)b * H + h) * DC + k)
                 : load1<DT>(qr, ((long long)b * H + h) * DR + k - DC);
    s_q[i] = x;
  }
  if (tid < kG) {
    s_m[tid] = -INFINITY;
    s_l[tid] = 0.f;
  }

  // phase-1 roles: 32 owners of 4 heads x 4 keys, 8 k-slices each
  const int ks = tid & 7, own = tid >> 3;
  const int h0 = (own & 3) * 4, r0 = (own >> 2) * 4;
  // softmax roles: warp w takes heads w*kG/8 .., lane = key
  const int warp = tid >> 5, lane = tid & 31;

  float acc[UPT][8][4];
#pragma unroll
  for (int u = 0; u < UPT; ++u)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[u][i][e] = 0.f;

  const uint4* c16 = static_cast<const uint4*>(ckv);
  const uint4* r16 = static_cast<const uint4*>(kpe);

  for (int t0 = 0; t0 < chunk; t0 += kT) {
    __syncthreads();   // the previous tile's readers are done
    // 1. stage rows [t0, t0 + kT) of [ckv | kpe], zero past the chunk
#pragma unroll
    for (int i0 = 0; i0 < LOADS; i0 += BATCH) {
      uint4 buf[BATCH];
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        const int idx = tid + (i0 + i) * kThreads;
        buf[i] = make_uint4(0u, 0u, 0u, 0u);
        if (i0 + i < LOADS && idx < kT * NCL) {
          const int r = idx / NCL, c = idx % NCL;
          if (t0 + r < chunk) {
            const long long key = key0 + t0 + r;
            buf[i] = c < NCC
                ? __ldg(c16 + (b * csb + key * csr) / VEC + c)
                : __ldg(r16 + (b * ksb + key * ksr) / VEC + (c - NCC));
          }
        }
      }
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        const int idx = tid + (i0 + i) * kThreads;
        if (i0 + i < LOADS && idx < kT * NCL) {
          const int r = idx / NCL, c = idx % NCL;
          float f[VEC];
          unpack<DT>(buf[i], f);
          float4* dst = reinterpret_cast<float4*>(s_kv + r * DK + c * VEC);
#pragma unroll
          for (int v = 0; v < VEC / 4; ++v)
            dst[v] = make_float4(f[4 * v], f[4 * v + 1], f[4 * v + 2],
                                 f[4 * v + 3]);
        }
      }
    }
    __syncthreads();

    // 2. scores of 4 heads x 4 keys over this lane's k-slice
    {
      float a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) a[i][j] = 0.f;
#pragma unroll 2
      for (int c = ks; c < NC1; c += 8) {
        float4 qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = q4[(h0 + i) * NC1 + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = kv4[(r0 + j) * NC1 + c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) a[i][j] = dot4(qv[i], kv[j], a[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            a[i][j] += __shfl_xor_sync(kFull, a[i][j], off);
#pragma unroll
      for (int e = 0; e < 16; ++e)
        if ((e >> 1) == ks)
          s_s[(h0 + e / 4) * kT + r0 + e % 4] = a[e / 4][e % 4];
    }
    __syncthreads();

    // 3. online softmax, exp2 domain
    {
      const bool live = t0 + lane < chunk;
#pragma unroll
      for (int i = 0; i < kG / 8; ++i) {
        const int h = warp * (kG / 8) + i;
        const float sc = live ? s_s[h * kT + lane] * scale : -INFINITY;
        float mx = sc;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
        const float m_old = s_m[h];
        const float m_new = fmaxf(m_old, mx);
        const float p = exp2f(sc - m_new);
        float ps = p;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          ps += __shfl_xor_sync(kFull, ps, off);
        s_p[lane * kG + h] = round_to<DT>(p);
        if (lane == 0) {
          const float alpha = exp2f(m_old - m_new);
          s_a[h] = alpha;
          s_l[h] = s_l[h] * alpha + ps;
          s_m[h] = m_new;
        }
      }
    }
    __syncthreads();

    // 4. acc = acc * alpha + p * ckv over the tile's live keys
    const int nt = min(kT, chunk - t0);
#pragma unroll
    for (int u = 0; u < UPT; ++u) {
      const int unit = tid + u * kThreads;
      if (UPT * kThreads > NU && unit >= NU) continue;
      const int c = unit % NC2, hq = unit / NC2;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float alpha = s_a[hq * 8 + i];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[u][i][e] *= alpha;
      }
      for (int t = 0; t < nt; ++t) {
        const float4 pa = p4[t * (kG / 4) + 2 * hq];
        const float4 pb = p4[t * (kG / 4) + 2 * hq + 1];
        const float4 v = kv4[t * NC1 + c];
        const float pv[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[u][i][0] = fmaf(pv[i], v.x, acc[u][i][0]);
          acc[u][i][1] = fmaf(pv[i], v.y, acc[u][i][1]);
          acc[u][i][2] = fmaf(pv[i], v.z, acc[u][i][2]);
          acc[u][i][3] = fmaf(pv[i], v.w, acc[u][i][3]);
        }
      }
    }
  }
  __syncthreads();

  const long long row = ((long long)b * n_split + s) * H;
#pragma unroll
  for (int u = 0; u < UPT; ++u) {
    const int unit = tid + u * kThreads;
    if (UPT * kThreads > NU && unit >= NU) continue;
    const int c = unit % NC2, hq = unit / NC2;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int h = hg * kG + hq * 8 + i;
      if (h < H)
        reinterpret_cast<float4*>(op + (row + h) * DC)[c] =
            make_float4(acc[u][i][0], acc[u][i][1], acc[u][i][2],
                        acc[u][i][3]);
    }
  }
  if (tid < kG && hg * kG + tid < H) {
    mp[row + hg * kG + tid] = s_m[tid];
    lp[row + hg * kG + tid] = s_l[tid];
  }
}

template <int DC, int DR, int DT>
int launch(const void* qc, const void* qr, const void* ckv, const void* kpe,
           void* op, void* mp, void* lp, int B, int H, int n_split, int chunk,
           long long csb, long long csr, long long ksb, long long ksr,
           float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<DC, DR>();
  auto kernel = mla_decode<DC, DR, DT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((H + kG - 1) / kG, n_split, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      qc, qr, ckv, kpe, static_cast<float*>(op), static_cast<float*>(mp),
      static_cast<float*>(lp), H, n_split, chunk, csb, csr, ksb, ksr, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// Returns cudaErrorInvalidValue for a (DC, DR) pair or a type code `dt`
// (split_kv_decode.cuh's) without an instance;
// the Python wrapper checks shapes, strides and alignment before calling.
// Strides are in elements.
extern "C" int tl_mla_decode(const void* qc, const void* qr, const void* ckv,
                             const void* kpe, void* op, void* mp, void* lp,
                             int B, int H, int S, int DC, int DR, int n_split,
                             long long csb, long long csr, long long ksb,
                             long long ksr, int dt, float scale,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunk = S / n_split;
#define TL_CASE(C, R)                                                   \
  if (DC == C && DR == R) {                                             \
    switch (dt) {                                                       \
      case kF32:                                                        \
        return launch<C, R, kF32>(qc, qr, ckv, kpe, op, mp, lp, B, H,   \
                                  n_split, chunk, csb, csr, ksb, ksr,   \
                                  scale, st);                           \
      case kBF16:                                                       \
        return launch<C, R, kBF16>(qc, qr, ckv, kpe, op, mp, lp, B, H,  \
                                   n_split, chunk, csb, csr, ksb, ksr,  \
                                   scale, st);                          \
      case kF16:                                                        \
        return launch<C, R, kF16>(qc, qr, ckv, kpe, op, mp, lp, B, H,   \
                                  n_split, chunk, csb, csr, ksb, ksr,   \
                                  scale, st);                           \
      default:                                                          \
        return static_cast<int>(cudaErrorInvalidValue);                 \
    }                                                                   \
  }
  TL_CASE(512, 64)
  TL_CASE(256, 32)
  TL_CASE(32, 16)
#undef TL_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
