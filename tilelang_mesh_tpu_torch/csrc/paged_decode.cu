// Split-KV paged decode over an H-major page pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel tilelang_mesh_tpu/ops/flash_decoding.py ::
// paged_decode_kernel. Same contract:
//   Q   (B, H, D)        float32 (the wrapper flattens (B, H, 1, D))
//   KP  (H, rows, D)     float32 or bfloat16, rows = n_pages * PS
//   VP  (H, rows, D)     same type as KP
//   Tab (B, PP)          int32 page ids
//   Op  (B, ns, H, D)    float32 unnormalised sum of p * v
//   Mp  (B, ns, H)       float32 running max of the scores, exp2 domain
//   Lp  (B, ns, H)       float32 sum of exp2(score - Mp)
// with score = (q . k) * sm_scale * log2(e), split s covering the pages
// Tab[b, s*pps : (s+1)*pps], pps = PP / ns.
//
// Bound: bytes. Each (b, h) reads its PP*PS rows of K and of V once
// (2 * PP*PS*D*sizeof(T) bytes) and does 4*D flops per row, far below
// the card's ~295 flops-per-byte balance point, so the least time is
// the K and V bytes over the memory rate.
//
// Design: one block of kWarps warps per (h, split, b), as the TPU grid
// (H, n_split, B). The TPU kernel DMAs a whole page into VMEM and runs a
// 1xPS matrix product; here each warp streams rows straight from device
// memory into registers with 16-byte loads (a page's PS*D rows are
// contiguous in the H-major pool, so neighbouring lanes read
// neighbouring addresses), takes the q.k dot product with warp
// shuffles, and keeps its own online-softmax state (m, l, acc) in f32.
// kUnroll rows per lane group are loaded before any arithmetic, so each
// warp keeps 2*kUnroll 16-byte loads in flight. At the end the row
// groups of a warp merge by shuffles and the warps merge through shared
// memory, in the exp2 domain. The block reads its own page ids; there is
// no scalar prefetch. No tensor cores: a single query row gives a 1xD
// product per key, which the CUDA cores keep up with at this bound.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kUnroll = 4;
constexpr unsigned kFull = 0xffffffffu;

// 16 bytes -> float: 4 float32 or 8 bfloat16 (bf16 is the high half of
// a float32, little-endian: element 0 is the low 16 bits of a word)
template <bool BF16>
__device__ __forceinline__ void unpack(const uint4& v, float* out) {
  if constexpr (BF16) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
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

template <int D, bool BF16>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode(const float* __restrict__ q, const uint4* __restrict__ kp,
             const uint4* __restrict__ vp, const int* __restrict__ tab,
             float* __restrict__ op, float* __restrict__ mp,
             float* __restrict__ lp, int H, int PP, int PS, int n_split,
             long long rows, float scale) {
  constexpr int VEC = BF16 ? 8 : 4;         // elements per 16-byte load
  constexpr int CHUNKS = D / VEC;           // 16-byte chunks per row
  constexpr int LPR = CHUNKS < 32 ? CHUNKS : 32;   // lanes per row
  constexpr int NCH = CHUNKS / LPR;         // chunks per lane per row
  constexpr int RPW = 32 / LPR;             // rows a warp reads at once
  static_assert(D % VEC == 0 && CHUNKS % LPR == 0 && (LPR & (LPR - 1)) == 0,
                "unsupported head_dim");

  const int h = blockIdx.x, s = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / LPR, col = lane % LPR;
  const int pps = PP / n_split;
  const int n_rows = pps * PS;

  // this lane's slice of q, prescaled into the exp2 domain
  float qr[NCH][VEC];
  const float* qb = q + ((long long)b * H + h) * D;
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      qr[c][e] = qb[(c * LPR + col) * VEC + e] * scale;

  const long long head = (long long)h * rows * CHUNKS;   // in uint4 units
  const int* pages = tab + (long long)b * PP + (long long)s * pps;

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
        const long long row = (long long)__ldg(pages + t / PS) * PS + t % PS;
        const uint4* kq = kp + head + row * CHUNKS;
        const uint4* vq = vp + head + row * CHUNKS;
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
          unpack<BF16>(kr[u][c], kf);
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
        unpack<BF16>(vr[u][c], vf);
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

template <int D, bool BF16>
void launch(const void* q, const void* kp, const void* vp, const void* tab,
            void* op, void* mp, void* lp, int B, int H, int PP, int PS,
            int n_split, long long rows, float scale, cudaStream_t stream) {
  const dim3 grid(H, n_split, B);
  paged_decode<D, BF16><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const uint4*>(kp),
      static_cast<const uint4*>(vp), static_cast<const int*>(tab),
      static_cast<float*>(op), static_cast<float*>(mp),
      static_cast<float*>(lp), H, PP, PS, n_split, rows, scale);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// Returns cudaErrorInvalidValue for a head_dim without an instance;
// the Python wrapper checks shapes before calling.
extern "C" int tl_paged_decode(const void* q, const void* kp, const void* vp,
                               const void* tab, void* op, void* mp, void* lp,
                               int B, int H, int PP, int PS, int D,
                               int n_split, long long rows, int bf16,
                               float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TL_CASE(DIM)                                                        \
  case DIM:                                                                 \
    if (bf16)                                                               \
      launch<DIM, true>(q, kp, vp, tab, op, mp, lp, B, H, PP, PS, n_split,  \
                        rows, scale, st);                                   \
    else                                                                    \
      launch<DIM, false>(q, kp, vp, tab, op, mp, lp, B, H, PP, PS, n_split, \
                         rows, scale, st);                                  \
    break;
  switch (D) {
    TL_CASE(64)
    TL_CASE(128)
    TL_CASE(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TL_CASE
  return static_cast<int>(cudaGetLastError());
}
