// Split-KV decode over contiguous K/V rows, for Hopper (sm_90a).
//
// Replaces the TPU kernel tilelang_mesh_tpu/ops/flash_decoding.py ::
// decode_kernel. Same contract:
//   Q   (B, H, D)        float32 (the wrapper flattens (B, H, 1, D))
//   K   (B, H, S, D)     float32, bfloat16 or float16, D contiguous;
//                        batch, head and row strides are arguments, so
//                        the gather strategy's transposed view needs no
//                        copy
//   V   (B, H, S, D)     same type and strides as K
//   Op  (B, ns, H, D)    float32 unnormalised sum of p * v
//   Mp  (B, ns, H)       float32 running max of the scores, exp2 domain
//   Lp  (B, ns, H)       float32 sum of exp2(score - Mp)
// with score = (q . k) * sm_scale * log2(e), split s covering the keys
// [s*chunk, (s+1)*chunk), chunk = S / ns, p kept in float32 before p * v.
//
// Bound: bytes, as the paged kernel: K and V read once. Two kernels, by
// the host's path rule (ops/flash_decoding.py::decode_path):
//   * float32, tl_decode: the paged kernel's loop (split_kv_decode.cuh)
//     with the page walk replaced by strides. Each warp streams rows
//     into registers as they come, so any chunk length works; the TPU
//     kernel's block_N tiling does not apply.
//   * bfloat16 and float16, tl_decode_tma: decode_tma<D, DT>. The loop
//     above keeps only 2 * kUnroll 16-byte loads a lane in flight, one
//     round trip per 32 rows of a warp, so the bytes in flight are bound
//     by registers. Here one producer warp keeps TMA loads of K and V
//     tiles (kRows rows x D, through a 4-D tensor map (D, S, H, B) over
//     the caller's strides) in flight through a ring of mbarrier
//     stages, and the consumer warps read the rows from shared memory
//     with the loop's lane layout (LPR lanes a row, 16 bytes a lane),
//     keeping the online softmax in float32 and merging as the loop
//     does. Rows past the split in a tile (TMA fills zeros only past
//     the tensor) are masked. The ring's bytes (kRingBytes) and a
//     tile's (kTileBytes) set the bytes in flight and the blocks an SM;
//     scripts/softmax_decode_ab.py times other values (a copy of this
//     file with them changed) against these. The grid is the loop's,
//     head-fastest (H, ns, B).
// No tensor cores: a single query row gives a 1 x D product per key,
// which the CUDA cores keep up with at this bound.

#include "gemm_sm90.cuh"
#include "split_kv_decode.cuh"

namespace {

using tl_splitkv::kBF16;
using tl_splitkv::kF16;
using tl_splitkv::kF32;
using tl_splitkv::kFull;
using tl_splitkv::merge_scale;
using tl_splitkv::unpack;

// row t of split s of (b, h): key s*chunk + t
struct StridedRows {
  long long sb, sh, sr;   // batch, head and row strides, in elements
  int chunk;
  struct Cursor {
    long long base, step;   // in 16-byte units
    __device__ __forceinline__ long long operator()(int t) const {
      return base + t * step;
    }
  };
  __device__ __forceinline__ Cursor cursor(int b, int h, int s,
                                           int vec) const {
    return {(b * sb + h * sh + (long long)s * chunk * sr) / vec, sr / vec};
  }
};

constexpr int kRingBytes = 64 * 1024;             // a block's K / V ring
constexpr int kTileBytes = 8 * 1024;              // a K (or V) tile
constexpr int kConsumers = 4;                     // consumer warps
constexpr int kTmaThreads = 32 * (kConsumers + 1);  // and the producer

template <int D>
struct TmaCfg {
  static constexpr int kRows = kTileBytes / (2 * D);   // a tile's rows
  static constexpr int kTile = kRows * D * 2;              // its bytes
  static constexpr int kStages = kRingBytes / (2 * kTile);
  // the ring (K then V a stage), its full and empty barriers, and room
  // to align the ring to 128 bytes
  static constexpr int kSmem = kStages * 2 * kTile + 2 * kStages * 8 + 128;
  static_assert(kRows >= 8 && kRows <= 256, "a tile's rows out of range");
  static_assert(kStages >= 2, "a ring of fewer than two stages");
};

template <int D, int DT>
__global__ void __launch_bounds__(kTmaThreads)
decode_tma(const __grid_constant__ CUtensorMap mk,
           const __grid_constant__ CUtensorMap mv,
           const float* __restrict__ q, float* __restrict__ op,
           float* __restrict__ mp, float* __restrict__ lp, int H,
           int n_split, int chunk, float scale) {
  using C = TmaCfg<D>;
  constexpr int VEC = 8;                    // elements per 16 bytes
  constexpr int CHUNKS = D / VEC;           // 16-byte chunks per row
  constexpr int LPR = CHUNKS < 32 ? CHUNKS : 32;   // lanes per row
  constexpr int NCH = CHUNKS / LPR;         // chunks per lane per row
  constexpr int RPW = 32 / LPR;             // rows a warp reads at once
  constexpr int U = C::kRows / (kConsumers * RPW);  // a lane's rows a tile
  static_assert(D % VEC == 0 && CHUNKS % LPR == 0 && U >= 1 &&
                    C::kRows % (kConsumers * RPW) == 0,
                "unsupported head_dim or tile");

  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((128 - (tl_gemm::smem_addr(smem_raw) & 127)) & 127);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::kStages * 2 *
                                               C::kTile);
  uint64_t* empty = full + C::kStages;
  const int h = blockIdx.x, s = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tiles = (chunk + C::kRows - 1) / C::kRows;

  if (threadIdx.x == 0) {
    for (int i = 0; i < C::kStages; ++i) {
      tl_sm90::mbar_init(&full[i], 1);
      tl_sm90::mbar_init(&empty[i], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  __shared__ float s_m[kConsumers], s_l[kConsumers];
  __shared__ float s_acc[kConsumers][D];
  if (warp == kConsumers) {                  // the producer
    if (lane == 0) {
      const int row0 = s * chunk;
      for (int i = 0; i < tiles; ++i) {
        const int st = i % C::kStages;
        tl_sm90::mbar_wait(&empty[st], ((i / C::kStages) & 1) ^ 1);
        unsigned char* kt = ring + st * 2 * C::kTile;
        tl_sm90::mbar_expect_tx(&full[st], 2 * C::kTile);
        tl_sm90::tma_load4(kt, &mk, &full[st], 0, row0 + i * C::kRows, h,
                           b);
        tl_sm90::tma_load4(kt + C::kTile, &mv, &full[st], 0,
                           row0 + i * C::kRows, h, b);
      }
    }
  } else {                                   // a consumer
    const int grp = lane / LPR, col = lane % LPR;
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

    for (int i = 0; i < tiles; ++i) {
      const int st = i % C::kStages;
      tl_sm90::mbar_wait(&full[st], (i / C::kStages) & 1);
      const uint4* kt = reinterpret_cast<const uint4*>(ring + st * 2 *
                                                       C::kTile);
      const uint4* vt = kt + C::kTile / 16;
      float sc[U];
      float mx = m;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = (u * kConsumers + warp) * RPW + grp;
        const bool valid = i * C::kRows + t < chunk;
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          float kf[VEC];
          unpack<DT>(kt[t * CHUNKS + c * LPR + col], kf);
#pragma unroll
          for (int e = 0; e < VEC; ++e) dot = fmaf(qr[c][e], kf[e], dot);
        }
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(kFull, dot, off);
        sc[u] = valid ? dot : -INFINITY;
        mx = fmaxf(mx, sc[u]);
      }
      if (mx != -INFINITY) {   // else this lane group saw no rows yet
        const float alpha = merge_scale(m, mx);
        l *= alpha;
#pragma unroll
        for (int c = 0; c < NCH; ++c)
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[c][e] *= alpha;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int t = (u * kConsumers + warp) * RPW + grp;
          if (i * C::kRows + t >= chunk) continue;
          const float p = exp2f(sc[u] - mx);
          l += p;
#pragma unroll
          for (int c = 0; c < NCH; ++c) {
            float vf[VEC];
            unpack<DT>(vt[t * CHUNKS + c * LPR + col], vf);
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[c][e] = fmaf(p, vf[e], acc[c][e]);
          }
        }
        m = mx;
      }
      __syncwarp();
      if (lane == 0) tl_sm90::mbar_arrive(&empty[st]);
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
  }

  // merge the consumer warps through shared memory
  __syncthreads();
  float mb = -INFINITY;
#pragma unroll
  for (int w = 0; w < kConsumers; ++w) mb = fmaxf(mb, s_m[w]);
  float wsc[kConsumers];
#pragma unroll
  for (int w = 0; w < kConsumers; ++w) wsc[w] = merge_scale(s_m[w], mb);
  const long long out = ((long long)b * n_split + s) * H + h;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kConsumers; ++w) o = fmaf(s_acc[w][d], wsc[w], o);
    op[out * D + d] = o;
  }
  if (threadIdx.x == 0) {
    float lb = 0.f;
#pragma unroll
    for (int w = 0; w < kConsumers; ++w) lb = fmaf(s_l[w], wsc[w], lb);
    mp[out] = mb;
    lp[out] = lb;
  }
}

template <int D, int DT>
int launch_tma(const void* q, const void* k, const void* v, void* op,
               void* mp, void* lp, int B, int H, int S, int n_split,
               long long sb, long long sh, long long sr, float scale,
               cudaStream_t stream) {
  using C = TmaCfg<D>;
  const long long dims[4] = {D, S, H, B};
  const long long strides[3] = {sr * 2, sh * 2, sb * 2};
  CUtensorMap mk, mv;
  if (!tl_sm90::make_map4(&mk, k, DT, dims, strides, D, C::kRows) ||
      !tl_sm90::make_map4(&mv, v, DT, dims, strides, D, C::kRows))
    return (int)cudaErrorInvalidValue;
  const auto kern = decode_tma<D, DT>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (attr != cudaSuccess) return (int)attr;
  kern<<<dim3(H, n_split, B), kTmaThreads, C::kSmem, stream>>>(
      mk, mv, static_cast<const float*>(q), static_cast<float*>(op),
      static_cast<float*>(mp), static_cast<float*>(lp), H, n_split,
      S / n_split, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// float32 K/V: the split-KV loop. Launches on `stream` and returns
// cudaGetLastError() (0 = launched); cudaErrorInvalidValue for a
// head_dim without an instance or a type other than float32 (code 0).
// The Python wrapper checks shapes and strides before calling.
extern "C" int tl_decode(const void* q, const void* k, const void* v,
                         void* op, void* mp, void* lp, int B, int H, int S,
                         int D, int n_split, long long sb, long long sh,
                         long long sr, int dt, float scale, void* stream) {
  const int chunk = S / n_split;
  const StridedRows rows{sb, sh, sr, chunk};
  const dim3 grid(H, n_split, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dt != kF32) return (int)cudaErrorInvalidValue;
#define TL_CASE(DIM)                                                        \
  case DIM:                                                                 \
    tl_splitkv::split_kv_decode<DIM, kF32, StridedRows>                     \
        <<<grid, tl_splitkv::kWarps * 32, 0, st>>>(                         \
            static_cast<const float*>(q), static_cast<const uint4*>(k),     \
            static_cast<const uint4*>(v), static_cast<float*>(op),          \
            static_cast<float*>(mp), static_cast<float*>(lp), H, n_split,   \
            chunk, scale, rows);                                            \
    break;
  switch (D) {
    TL_CASE(64)
    TL_CASE(128)
    TL_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef TL_CASE
  return (int)cudaGetLastError();
}

// bfloat16 (code 1) and float16 (code 3) K/V: decode_tma. Launches on
// `stream` and returns cudaGetLastError() (0 = launched);
// cudaErrorInvalidValue for a head_dim or type without an instance or a
// tensor map that cuTensorMapEncodeTiled refuses (strides must be
// multiples of 16 bytes).
extern "C" int tl_decode_tma(const void* q, const void* k, const void* v,
                             void* op, void* mp, void* lp, int B, int H,
                             int S, int D, int n_split, long long sb,
                             long long sh, long long sr, int dt,
                             float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TL_CASE(DIM, DT)                                                  \
  if (D == DIM && dt == DT)                                               \
    return launch_tma<DIM, DT>(q, k, v, op, mp, lp, B, H, S, n_split, sb, \
                               sh, sr, scale, st);
  TL_CASE(64, kBF16)
  TL_CASE(64, kF16)
  TL_CASE(128, kBF16)
  TL_CASE(128, kF16)
  TL_CASE(256, kBF16)
  TL_CASE(256, kF16)
#undef TL_CASE
  return (int)cudaErrorInvalidValue;
}
