// The split-KV decode loop shared by paged_decode.cu and decode.cu.
//
// One block of kWarps warps per (h, split, b) computes the exp2-domain
// partials of single-token attention over one split's rows:
//   Q   (B, H, D)        float32 (the wrappers flatten (B, H, 1, D))
//   K/V rows             float32, bfloat16 or float16 (the code DT, as
//                        attention_common.cuh's), D contiguous elements
//   Op  (B, ns, H, D)    float32 unnormalised sum of p * v
//   Mp  (B, ns, H)       float32 running max of the scores, exp2 domain
//   Lp  (B, ns, H)       float32 sum of exp2(score - Mp)
// with score = (q . k) * sm_scale * log2(e). Where row t (0 <= t < n_rows)
// of split s lies is the `Rows` type's business: `rows.cursor(b, h, s,
// VEC)` is made once per block, and `cursor(t)` returns the row's offset
// in 16-byte units from the K (and V) base. The paged kernel walks a page
// table there; the contiguous kernel adds strides.
//
// Bound: bytes. Each (b, h) reads its rows of K and of V once and does
// 4*D flops per row, far below the card's ~295 flops-per-byte balance
// point, so the least time is the K and V bytes over the memory rate.
//
// Design: each warp streams rows straight from device memory into
// registers with 16-byte loads (neighbouring lanes read neighbouring
// addresses of one row), takes the q.k dot product with warp shuffles,
// and keeps its own online-softmax state (m, l, acc) in f32. kUnroll
// rows per lane group are loaded before any arithmetic, so each warp
// keeps 2*kUnroll 16-byte loads in flight. At the end the row groups of
// a warp merge by shuffles and the warps merge through shared memory, in
// the exp2 domain. No tensor cores: a single query row gives a 1xD
// product per key, which the CUDA cores keep up with at this bound.

#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace tl_splitkv {

constexpr int kWarps = 4;
constexpr int kUnroll = 4;
constexpr unsigned kFull = 0xffffffffu;
// element type codes of K and V (ops/gemm.py's DTYPE_CODES)
constexpr int kF32 = 0, kBF16 = 1, kF16 = 3;

// 16 bytes -> float: 4 float32, or 8 bfloat16 or float16 (bf16 is the
// high half of a float32; little-endian: element 0 is the low 16 bits
// of a word)
template <int DT>
__device__ __forceinline__ void unpack(const uint4& v, float* out) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  if constexpr (DT == kBF16) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else if constexpr (DT == kF16) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __half2float(__ushort_as_half((unsigned short)w[i]));
      out[2 * i + 1] =
          __half2float(__ushort_as_half((unsigned short)(w[i] >> 16)));
    }
  } else {
    out[0] = __uint_as_float(v.x);
    out[1] = __uint_as_float(v.y);
    out[2] = __uint_as_float(v.z);
    out[3] = __uint_as_float(v.w);
  }
}

// weight of a partial whose max is m when merged under the max mx
// (a partial that saw no rows has m = -inf and weighs nothing)
__device__ __forceinline__ float merge_scale(float m, float mx) {
  return m == -INFINITY ? 0.f : exp2f(m - mx);
}

template <int D, int DT, class Rows>
__global__ void __launch_bounds__(kWarps * 32)
split_kv_decode(const float* __restrict__ q, const uint4* __restrict__ kp,
                const uint4* __restrict__ vp, float* __restrict__ op,
                float* __restrict__ mp, float* __restrict__ lp, int H,
                int n_split, int n_rows, float scale, Rows rows) {
  constexpr int VEC = DT == kF32 ? 4 : 8;   // elements per 16-byte load
  constexpr int CHUNKS = D / VEC;           // 16-byte chunks per row
  constexpr int LPR = CHUNKS < 32 ? CHUNKS : 32;   // lanes per row
  constexpr int NCH = CHUNKS / LPR;         // chunks per lane per row
  constexpr int RPW = 32 / LPR;             // rows a warp reads at once
  static_assert(D % VEC == 0 && CHUNKS % LPR == 0 && (LPR & (LPR - 1)) == 0,
                "unsupported head_dim");

  const int h = blockIdx.x, s = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / LPR, col = lane % LPR;
  const auto row_of = rows.cursor(b, h, s, VEC);

  // this lane's slice of q, prescaled into the exp2 domain
  float qr[NCH][VEC];
  const float* qb = q + ((long long)b * H + h) * D;
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      qr[c][e] = qb[(c * LPR + col) * VEC + e] * scale;

  float m = -INFINITY, l = 0.f;
  float acc[NCH][VEC];
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[c][e] = 0.f;

  constexpr int kRowsPerIter = kWarps * RPW * kUnroll;
  for (int base = 0; base < n_rows; base += kRowsPerIter) {
    uint4 kr[kUnroll][NCH], vr[kUnroll][NCH];
    bool valid[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + (u * kWarps + warp) * RPW + grp;
      valid[u] = t < n_rows;
      if (valid[u]) {
        const long long row = row_of(t);
        const uint4* kq = kp + row;
        const uint4* vq = vp + row;
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          kr[u][c] = __ldg(kq + c * LPR + col);
          vr[u][c] = __ldg(vq + c * LPR + col);
        }
      }
    }
    float sc[kUnroll];
    float mx = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float dot = 0.f;
      if (valid[u]) {
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          float kf[VEC];
          unpack<DT>(kr[u][c], kf);
#pragma unroll
          for (int e = 0; e < VEC; ++e) dot = fmaf(qr[c][e], kf[e], dot);
        }
      }
      // every lane takes part in the shuffles, valid row or not
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(kFull, dot, off);
      sc[u] = valid[u] ? dot : -INFINITY;
      mx = fmaxf(mx, sc[u]);
    }
    if (mx == -INFINITY) continue;   // this lane group saw no rows yet
    const float alpha = merge_scale(m, mx);
    l *= alpha;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[c][e] *= alpha;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!valid[u]) continue;
      const float p = exp2f(sc[u] - mx);
      l += p;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        float vf[VEC];
        unpack<DT>(vr[u][c], vf);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[c][e] = fmaf(p, vf[e], acc[c][e]);
      }
    }
    m = mx;
  }

  // merge the lane groups of this warp (they hold the same columns)
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
    const float mo = __shfl_xor_sync(kFull, m, off);
    const float lo = __shfl_xor_sync(kFull, l, off);
    const float mn = fmaxf(m, mo);
    const float a = merge_scale(m, mn), bo = merge_scale(mo, mn);
    l = l * a + lo * bo;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float ao = __shfl_xor_sync(kFull, acc[c][e], off);
        acc[c][e] = acc[c][e] * a + ao * bo;
      }
    m = mn;
  }

  // merge the warps through shared memory
  __shared__ float s_m[kWarps], s_l[kWarps];
  __shared__ float s_acc[kWarps][D];
  if (grp == 0) {
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        s_acc[warp][(c * LPR + col) * VEC + e] = acc[c][e];
    if (col == 0) {
      s_m[warp] = m;
      s_l[warp] = l;
    }
  }
  __syncthreads();
  float mb = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mb = fmaxf(mb, s_m[w]);
  float wsc[kWarps];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) wsc[w] = merge_scale(s_m[w], mb);
  const long long out = ((long long)b * n_split + s) * H + h;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o = fmaf(s_acc[w][d], wsc[w], o);
    op[out * D + d] = o;
  }
  if (threadIdx.x == 0) {
    float lb = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) lb = fmaf(s_l[w], wsc[w], lb);
    mp[out] = mb;
    lp[out] = lb;
  }
}

// Launches the kernel over the grid (H, n_split, B) on `stream` for the
// head_dim D (64, 128 or 256) and the K/V type code dt, and returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for a
// head_dim or type without an instance.
template <class Rows>
int launch(const void* q, const void* kp, const void* vp, void* op, void* mp,
           void* lp, int B, int H, int D, int n_split, int n_rows, int dt,
           float scale, Rows rows, cudaStream_t stream) {
  const dim3 grid(H, n_split, B);
#define TL_CASE(DIM, DT)                                                    \
  split_kv_decode<DIM, DT, Rows><<<grid, kWarps * 32, 0, stream>>>(         \
      static_cast<const float*>(q), static_cast<const uint4*>(kp),          \
      static_cast<const uint4*>(vp), static_cast<float*>(op),               \
      static_cast<float*>(mp), static_cast<float*>(lp), H, n_split, n_rows, \
      scale, rows)
  switch (D * 4 + dt) {
    case 64 * 4 + kF32: TL_CASE(64, kF32); break;
    case 64 * 4 + kBF16: TL_CASE(64, kBF16); break;
    case 64 * 4 + kF16: TL_CASE(64, kF16); break;
    case 128 * 4 + kF32: TL_CASE(128, kF32); break;
    case 128 * 4 + kBF16: TL_CASE(128, kBF16); break;
    case 128 * 4 + kF16: TL_CASE(128, kF16); break;
    case 256 * 4 + kF32: TL_CASE(256, kF32); break;
    case 256 * 4 + kBF16: TL_CASE(256, kBF16); break;
    case 256 * 4 + kF16: TL_CASE(256, kF16); break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TL_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tl_splitkv
