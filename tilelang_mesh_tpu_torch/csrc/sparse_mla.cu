// DeepSeek-V3.2 sparse MLA forward (DSA), for Hopper (sm_90a).
//
// Replaces the TPU kernel tilelang_mesh_tpu/ops/dsa.py ::
// sparse_mla_fwd_kernel. Same contract:
//   Q   (B, S, H, D + DT)  float32, bfloat16 or float16, contiguous
//   KV  (B, Skv, D + DT)   same type: the shared latent (key and value)
//                          and its rope tail
//   Ind (B, S, topk)       int32 latent row ids (-1: none)
//   O   (B, S, H, D)       q's type: softmax(scores) @ KV[:, :D]
//   Lse (B, S, H)          float32, natural log
// with score = Q[b,t,h] . KV[b,idx] * sm_scale over the ids that satisfy
// 0 <= idx <= q_offset + t (and idx < Skv), in the exp2 domain (`scale`
// is sm_scale * log2(e)). The running max is floored at -1e30, so a row
// with no valid id gives O = 0 / max(0, 1e-30) = 0 and Lse = (-1e30 +
// log2(1e-30)) / log2(e), as the TPU kernel's. In bfloat16 and float16 p
// is rounded to the input type before p * kv (the TPU kernel's P
// fragment); l sums the unrounded p.
//
// Bound: operations. Each (token, head, selected id) costs 2 (D + DT) +
// 2 D flops against a latent row that all H heads share and that stays
// in L2 (DeepSeek-V3.2's 8192-row cache is 19 MB in float32).
//
// The TPU kernel keeps all H heads of a token in one (H, BI) score tile
// and an (H, D) float32 accumulator (256 KiB at H = 128, D = 512), more
// than a block's shared memory or registers. Both kernels below split
// the heads into groups, with the grid (head group, token, batch) and
// the head group fastest, so the blocks that gather the same rows run
// together and share them through L2.
//
// float32 (`sparse_mla_fwd`, CUDA cores): mla_decode.cu's loop with the
// keys taken from the indices. A block owns kG = 16 heads of one token;
// per tile of kT = 32 slots it
//   0. reads the slots' ids, marks the invalid ones (-1, past the causal
//      bound, at or past Skv) and skips a tile with none valid;
//   1. gathers the valid rows [latent | rope] into shared memory as
//      float32 (16-byte loads), zeros for an invalid slot: its row is
//      never read;
//   2. scores: 32 threads each own 4 heads x 4 slots, 8 lanes split the
//      D + DT dot products and merge by shuffles;
//   3. online softmax, one warp per 2 heads, one lane per slot, exp2; an
//      invalid slot scores -inf, so its p is exactly 0;
//   4. acc += p * latent: each thread owns 8 heads x 4 latent columns.
// The block normalises at the end (acc / max(l, 1e-30)) and writes the
// natural-log Lse.
//
// bfloat16 and float16 at D a multiple of 128 (`sparse_mla_fwd_wgmma`,
// wgmma): a block of two consumer warpgroups and a producer warp owns 64
// heads of one token. The
// host's rule (ops/dsa.py::sparse_mla_path) picks it and passes its code.
//   * Q: the block's 64 x (D + DT) tile, loaded once by TMA through a 2-D
//     map over (B S H, D + DT) into the 128-byte swizzled K-major layout
//     (64-column blocks of 8 KB); rows past H are the next token's or
//     TMA's zeros, computed and never stored.
//   * A producer warpgroup gathers each tile of 64 slots: it reads the
//     slots' ids, marks the invalid ones in a 64-bit mask, copies each
//     valid row with 16-byte cp.async straight into the same swizzled
//     layout, a warp a row at a time, 512 contiguous bytes a warp
//     instruction (an invalid row zero-filled), waits for its copies,
//     fences them to the async proxy and arrives on the stage's full
//     mbarrier; two stages of 72 KB at D 512. (One producer warp gathered
//     at a quarter of the rate the consumers take: PERF.md, #41.)
//   * Consumer warpgroup g scores all 64 heads over slots 32 g .. 32 g +
//     31 only (wgmma m64n32k16 over D + DT, both operands in shared
//     memory): every score is computed once. The two exchange their row
//     maxima through shared memory under a named barrier and form the
//     same new max; each writes its p, rounded to the input type, into a
//     shared 64 x 64 P tile and keeps l over its own slots from the
//     unrounded p. After a second barrier each takes O[:, g D / 2 ..] +=
//     P . V with wgmma m64n(D/2)k16, V the first D columns of the same
//     staged rows read as an MN-major operand: one copy of the gathered
//     rows feeds both products. O is 128 floats a thread at D 512. The
//     consumers are warpgroups 0 and 1, the producer 2; ptxas holds every
//     thread of 384 to 168 registers (setmaxnreg 40 / 232 changed
//     nothing in its allocation, so the kernel does without it).
//   * At the end the two halves of l are summed through shared memory; O
//     = acc / max(l, 1e-30) and the natural-log Lse are stored.
// Bound: operations (2.36 ms at DeepSeek-V3.2's widths in bf16); each
// block gathers topk rows of (D + DT) elements from L2, 19 GB a call
// there for the two head groups of 4096 tokens.
//
// bfloat16 and float16 at the other widths (`sparse_mla_fwd_mma`,
// mma.sync; D 192, whose column halves are not whole 64-column blocks): a block
// owns 64 heads of one token, 8 warps, warp w heads 16 (w % 4) .. + 16
// and latent columns (w / 4) D / 2 .. + D / 2. The block's Q rows and
// two buffers of 32 gathered KV rows sit in shared memory as the input
// type, each row padded by 8 elements (an odd count of 16-byte chunks:
// the 8 rows of an ldmatrix hit 8 bank groups); the next tile's rows
// arrive by cp.async (zero-filled for an invalid slot) while the current
// one is computed. Per tile each warp takes the scores of its 16 heads
// over all 32 slots with mma.sync m16n8k16 (the two column halves
// compute the same scores, so nothing crosses warps), runs the online
// softmax on the accumulator fragments (a row's 32 slots on a lane quad:
// two shuffles), rounds p to the input type straight into the A
// fragments of P . V, and accumulates its 16 x D / 2 block of O in
// registers (128 floats a thread at D = 512). Bound by shared-memory
// reads (ldmatrix), not the tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gemm_sm90.cuh"
#include "gemm_tile.cuh"
#include "split_kv_decode.cuh"

namespace {

using tl_splitkv::kBF16;
using tl_splitkv::kF16;
using tl_splitkv::kF32;
using tl_splitkv::unpack;

constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.44269504f;   // the TPU kernel's constant

// the natural-log LSE of a row's exp2-domain (m, l), the max floored at
// -1e30 (a row that saw no valid id kept m = -inf)
__device__ __forceinline__ float natural_lse(float m, float l) {
  return (fmaxf(m, -1e30f) + log2f(fmaxf(l, 1e-30f))) / kLog2e;
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kG = 16;    // query heads per block
constexpr int kT = 32;    // index slots per tile

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <int D, int DR>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kT * (D + DR) + (size_t)kG * (D + DR) +
                          2 * kG * kT + 3 * kG + kT);
}

template <int D, int DR>
__global__ void __launch_bounds__(kThreads, 2)
sparse_mla_fwd(const float* __restrict__ q, const float* __restrict__ kv,
               const int* __restrict__ ind, float* __restrict__ o,
               float* __restrict__ lse, int S, int Skv, int H, int topk,
               int q_offset, float scale) {
  constexpr int DK = D + DR;             // floats per staged row
  constexpr int NC1 = DK / 4;            // float4 columns of a staged row
  constexpr int NC2 = D / 4;             // float4 columns of the latent
  constexpr int VEC = 4;                 // floats per 16-byte load
  constexpr int NCL = DK / VEC;          // loads per row
  constexpr int LOADS = (kT * NCL + kThreads - 1) / kThreads;
  constexpr int BATCH = LOADS < 8 ? LOADS : 8;
  constexpr int NU = (kG / 8) * NC2;     // phase-4 units: 8 heads x float4
  constexpr int UPT = (NU + kThreads - 1) / kThreads;
  static_assert(D % 8 == 0 && DR % 8 == 0, "unsupported latent widths");

  extern __shared__ float4 smem4[];
  float* s_kv = reinterpret_cast<float*>(smem4);   // [kT][DK]
  float* s_q = s_kv + kT * DK;                       // [kG][DK]
  float* s_s = s_q + kG * DK;                        // scores [kG][kT]
  float* s_p = s_s + kG * kT;                        // p [kT][kG]
  float* s_m = s_p + kT * kG;                        // [kG]
  float* s_l = s_m + kG;
  float* s_a = s_l + kG;                             // rescale of the tile
  int* s_id = reinterpret_cast<int*>(s_a + kG);      // [kT], -1: invalid
  const float4* kv4 = reinterpret_cast<const float4*>(s_kv);
  const float4* q4 = reinterpret_cast<const float4*>(s_q);
  const float4* p4 = reinterpret_cast<const float4*>(s_p);

  const int hg = blockIdx.x, t = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const long long tok = (long long)b * S + t;
  const int bound = q_offset + t;        // the token's last visible row
  const int* ids = ind + tok * topk;

  // this block's query heads, zero past H
  for (int i = tid; i < kG * DK; i += kThreads) {
    const int h = hg * kG + i / DK;
    s_q[i] = h < H ? q[(tok * H + h) * DK + i % DK] : 0.f;
  }
  if (tid < kG) {
    s_m[tid] = -INFINITY;
    s_l[tid] = 0.f;
  }

  // phase-2 roles: 32 owners of 4 heads x 4 slots, 8 k-slices each
  const int ks = tid & 7, own = tid >> 3;
  const int h0 = (own & 3) * 4, r0 = (own >> 2) * 4;
  // softmax roles: warp w takes heads w*kG/8 .., lane = slot
  const int warp = tid >> 5, lane = tid & 31;

  float acc[UPT][8][4];
#pragma unroll
  for (int u = 0; u < UPT; ++u)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[u][i][e] = 0.f;

  const uint4* kv16 = reinterpret_cast<const uint4*>(kv);
  const long long row0 = (long long)b * Skv;

  for (int t0 = 0; t0 < topk; t0 += kT) {
    __syncthreads();   // the previous tile's readers are done
    // 0. the tile's ids; skip a tile with no valid one (uniform)
    bool ok = false;
    if (tid < kT) {
      const int id = t0 + tid < topk ? ids[t0 + tid] : -1;
      ok = id >= 0 && id <= bound && id < Skv;
      s_id[tid] = ok ? id : -1;
    }
    if (!__syncthreads_or(ok)) continue;

    // 1. gather the valid rows of [latent | rope], zeros elsewhere
#pragma unroll
    for (int i0 = 0; i0 < LOADS; i0 += BATCH) {
      uint4 buf[BATCH];
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        const int idx = tid + (i0 + i) * kThreads;
        buf[i] = make_uint4(0u, 0u, 0u, 0u);
        if (i0 + i < LOADS && idx < kT * NCL) {
          const int id = s_id[idx / NCL];
          if (id >= 0)
            buf[i] = __ldg(kv16 + (row0 + id) * NCL + idx % NCL);
        }
      }
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        const int idx = tid + (i0 + i) * kThreads;
        if (i0 + i < LOADS && idx < kT * NCL) {
          const int r = idx / NCL, c = idx % NCL;
          float f[VEC];
          unpack<kF32>(buf[i], f);
          float4* dst = reinterpret_cast<float4*>(s_kv + r * DK + c * VEC);
#pragma unroll
          for (int v = 0; v < VEC / 4; ++v)
            dst[v] = make_float4(f[4 * v], f[4 * v + 1], f[4 * v + 2],
                                 f[4 * v + 3]);
        }
      }
    }
    __syncthreads();

    // 2. scores of 4 heads x 4 slots over this lane's k-slice
    {
      float a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) a[i][j] = 0.f;
#pragma unroll 2
      for (int c = ks; c < NC1; c += 8) {
        float4 qv[4], kr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = q4[(h0 + i) * NC1 + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) kr[j] = kv4[(r0 + j) * NC1 + c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) a[i][j] = dot4(qv[i], kr[j], a[i][j]);
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

    // 3. online softmax, exp2 domain, the max floored at -1e30
    {
      const bool live = s_id[lane] >= 0;
#pragma unroll
      for (int i = 0; i < kG / 8; ++i) {
        const int h = warp * (kG / 8) + i;
        const float sc = live ? s_s[h * kT + lane] * scale : -INFINITY;
        float mx = sc;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
        const float m_old = s_m[h];
        const float m_new = fmaxf(m_old, fmaxf(mx, -1e30f));
        const float p = exp2f(sc - m_new);
        float ps = p;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          ps += __shfl_xor_sync(kFull, ps, off);
        s_p[lane * kG + h] = p;
        if (lane == 0) {
          const float alpha = exp2f(m_old - m_new);
          s_a[h] = alpha;
          s_l[h] = s_l[h] * alpha + ps;
          s_m[h] = m_new;
        }
      }
    }
    __syncthreads();

    // 4. acc = acc * alpha + p * latent over the tile's slots
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
      for (int r = 0; r < kT; ++r) {
        const float4 pa = p4[r * (kG / 4) + 2 * hq];
        const float4 pb = p4[r * (kG / 4) + 2 * hq + 1];
        const float4 v = kv4[r * NC1 + c];
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

  // O = acc / max(l, 1e-30); Lse in natural log
#pragma unroll
  for (int u = 0; u < UPT; ++u) {
    const int unit = tid + u * kThreads;
    if (UPT * kThreads > NU && unit >= NU) continue;
    const int c = unit % NC2, hq = unit / NC2;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int h = hg * kG + hq * 8 + i;
      if (h < H) {
        const float inv = 1.f / fmaxf(s_l[hq * 8 + i], 1e-30f);
        const long long at = (tok * H + h) * D + 4 * c;
#pragma unroll
        for (int e = 0; e < 4; ++e) o[at + e] = acc[u][i][e] * inv;
      }
    }
  }
  if (tid < kG && hg * kG + tid < H)
    lse[tok * H + hg * kG + tid] = natural_lse(s_m[tid], s_l[tid]);
}

// Sets the kernel's dynamic shared memory and launches it on `stream`;
// returns the first CUDA error (0 = launched).
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, int threads, size_t bytes,
           cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, bytes, stream>>>(args...);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16 and float16: tensor cores
// ---------------------------------------------------------------------------

namespace mma16 = tl_gemm::bf16;

constexpr int kMmaThreads = 256;   // 8 warps
constexpr int kMmaHeads = 64;      // query heads per block
constexpr int kMmaSlots = 32;      // index slots per tile

template <int D, int DR>
constexpr size_t mma_smem_bytes() {
  return 2 * (size_t)(kMmaHeads + 2 * kMmaSlots) * (D + DR + 8) +
         sizeof(int) * 2 * kMmaSlots;
}

// two floats rounded to E (bf16 or f16) in one register, `lo` in the low
// half: the operand layout of mma.sync
template <typename E>
__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  if constexpr (std::is_same_v<E, __half>) {
    const __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&h);
  } else {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&h);
  }
}

template <int D, int DR, typename E>
__global__ void __launch_bounds__(kMmaThreads, 1)
sparse_mla_fwd_mma(const E* __restrict__ q, const E* __restrict__ kv,
                   const int* __restrict__ ind, E* __restrict__ o,
                   float* __restrict__ lse, int S, int Skv, int H, int topk,
                   int q_offset, float scale) {
  constexpr int DK = D + DR;
  constexpr int LD = DK + 8;        // elements a shared row
  constexpr int CH = DK / 8;        // 16-byte chunks a row
  constexpr int NT = D / 16;        // n8 tiles of a warp's D / 2 columns
  static_assert(DK % 16 == 0 && D % 32 == 0 && (LD / 8) % 2 == 1,
                "unsupported latent widths");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* sQ = reinterpret_cast<E*>(smem_raw);                      // [64][LD]
  E* sKV = sQ + kMmaHeads * LD;                                 // [2][32][LD]
  int* sId = reinterpret_cast<int*>(sKV + 2 * kMmaSlots * LD);  // [2][32]

  const int hg = blockIdx.x, t = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const long long tok = (long long)b * S + t;
  const int bound = q_offset + t;       // the token's last visible row
  const int* ids = ind + tok * topk;
  const E* kvb = kv + (long long)b * Skv * DK;
  const int n_tiles = (topk + kMmaSlots - 1) / kMmaSlots;

  // the block's Q rows, zero past H
  for (int i = tid; i < kMmaHeads * CH; i += kMmaThreads) {
    const int r = i / CH, c = i % CH, h = hg * kMmaHeads + r;
    tl_gemm::cp_async16(sQ + r * LD + c * 8,
                        h < H ? q + (tok * H + h) * DK + c * 8 : q, h < H);
  }
  // tile `tile`'s rows into buffer `buf` (zeros for an invalid slot) and
  // its ids into sId[buf] (-1: invalid)
  auto gather_tile = [&](int tile, int buf) {
    const int s0 = tile * kMmaSlots;
    for (int i = tid; i < kMmaSlots * CH; i += kMmaThreads) {
      const int r = i / CH, c = i % CH;
      const int id = s0 + r < topk ? __ldg(ids + s0 + r) : -1;
      const bool ok = id >= 0 && id <= bound && id < Skv;
      tl_gemm::cp_async16(sKV + (buf * kMmaSlots + r) * LD + c * 8,
                          ok ? kvb + (long long)id * DK + c * 8 : kvb, ok);
    }
    if (tid < kMmaSlots) {
      const int id = s0 + tid < topk ? __ldg(ids + s0 + tid) : -1;
      sId[buf * kMmaSlots + tid] =
          id >= 0 && id <= bound && id < Skv ? id : -1;
    }
  };
  gather_tile(0, 0);
  tl_gemm::cp_async_commit();

  // warp roles: heads 16 rg .., latent columns half * D / 2 ..; in a
  // fragment, lane (g, q2) holds rows g and g + 8, columns q2, q2 + 1
  const int rg = warp % 4, half = warp / 4;
  const int mat = lane / 8, mr = lane % 8, g = lane / 4, q2 = (lane % 4) * 2;
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int buf = tile & 1;
    tl_gemm::cp_async_wait<0>();
    __syncthreads();   // tile's rows and ids landed; tile - 1 is done
    if (tile + 1 < n_tiles) gather_tile(tile + 1, buf ^ 1);
    tl_gemm::cp_async_commit();
    const int* sid = sId + buf * kMmaSlots;
    // every warp reads the same ids: a uniform skip of a dead tile
    if (!__any_sync(kFull, sid[lane] >= 0)) continue;
    const E* sK = sKV + buf * kMmaSlots * LD;

    // 1. scores of the warp's 16 heads over the tile's 32 slots
    float sc[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll 4
    for (int ks = 0; ks < DK; ks += 16) {
      unsigned a[4];
      mma16::ldmatrix_x4(a, sQ + (16 * rg + mr + 8 * (mat % 2)) * LD + ks +
                                8 * (mat / 2));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        unsigned r[4];
        mma16::ldmatrix_x4(r, sK + (np * 16 + mr + 8 * (mat / 2)) * LD + ks +
                                  8 * (mat % 2));
        mma16::mma<E>(sc[2 * np], a, r[0], r[1]);
        mma16::mma<E>(sc[2 * np + 1], a, r[2], r[3]);
      }
    }

    // 2. online softmax in the exp2 domain, the max floored at -1e30; a
    // row's 32 slots lie on a lane quad. p is rounded to E into the A
    // fragments of P . V (two k16 steps); l sums the unrounded p.
    unsigned pa[2][4];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float v[4][2], mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[nt][e] = sid[8 * nt + q2 + e] >= 0 ? sc[nt][2 * hh + e] * scale
                                               : -INFINITY;
          mx = fmaxf(mx, v[nt][e]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m[hh], fmaxf(mx, -1e30f));
      const float alpha = exp2f(m[hh] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[nt][e] = exp2f(v[nt][e] - m_new);
          ps += v[nt][e];
        }
      ps += __shfl_xor_sync(kFull, ps, 1);
      ps += __shfl_xor_sync(kFull, ps, 2);
      l[hh] = l[hh] * alpha + ps;
      m[hh] = m_new;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        acc[nt][2 * hh] *= alpha;
        acc[nt][2 * hh + 1] *= alpha;
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        pa[kk][hh] = pack2<E>(v[2 * kk][0], v[2 * kk][1]);
        pa[kk][2 + hh] = pack2<E>(v[2 * kk + 1][0], v[2 * kk + 1][1]);
      }
    }

    // 3. acc += P . latent over the warp's D / 2 columns
    const E* sV = sK + half * (D / 2);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        unsigned r[4];
        mma16::ldmatrix_x4_trans(r, sV + (kk * 16 + mr + 8 * (mat % 2)) * LD +
                                        np * 16 + 8 * (mat / 2));
        mma16::mma<E>(acc[2 * np], pa[kk], r[0], r[1]);
        mma16::mma<E>(acc[2 * np + 1], pa[kk], r[2], r[3]);
      }
  }
  tl_gemm::cp_async_wait<0>();

  // O = acc / max(l, 1e-30) in E; Lse from the first column half
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int h = hg * kMmaHeads + 16 * rg + g + 8 * hh;
    if (h >= H) continue;
    const float den = fmaxf(l[hh], 1e-30f);
    E* orow = o + (tok * H + h) * D + half * (D / 2) + q2;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      *reinterpret_cast<unsigned*>(orow + 8 * nt) =
          pack2<E>(acc[nt][2 * hh] / den, acc[nt][2 * hh + 1] / den);
    if (half == 0 && lane % 4 == 0) lse[tok * H + h] = natural_lse(m[hh], l[hh]);
  }
}

// ---------------------------------------------------------------------------
// bfloat16 and float16 on wgmma
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 384;    // two consumer warpgroups, a producer
constexpr int kWgSlots = 64;       // index slots a tile
constexpr int kWgStages = 2;

// shared memory: Q | the KV stages | P | ids | masks | maxima | l | barriers
template <int D, int DR>
struct WgLayout {
  static constexpr int DK = D + DR;
  static constexpr int kTile = kWgSlots * DK * 2;     // 64 rows of DK
  static constexpr int kKV = kTile;
  static constexpr int kP = kTile * (1 + kWgStages);
  static constexpr int kIds = kP + 64 * 64 * 2;
  static constexpr int kMask = kIds + kWgStages * kWgSlots * 4;
  static constexpr int kMax = kMask + kWgStages * 8;
  static constexpr int kL = kMax + 2 * 64 * 4;
  static constexpr int kBar = kL + 2 * 64 * 4;
  // and room to align the start to 1024 bytes (the swizzle's period)
  static constexpr int kSmem = kBar + (2 * kWgStages + 1) * 8 + 1024;
  static_assert(DK % 64 == 0 && D % 128 == 0, "unsupported latent widths");
  static_assert(kSmem <= tl_sm90::kSmemOptin, "tiles past shared memory");
};

// the descriptor of a 128-byte swizzled K-major tile at addr (rows of 128
// bytes, 8-row groups 1024 apart)
__device__ __forceinline__ uint64_t kdesc(unsigned addr) {
  return tl_sm90::make_desc(addr, 16, 1024, 128);
}

template <int D, int DR, typename E>
__global__ void __launch_bounds__(kWgThreads, 1)
sparse_mla_fwd_wgmma(const __grid_constant__ CUtensorMap qmap,
                     const E* __restrict__ kv, const int* __restrict__ ind,
                     E* __restrict__ o, float* __restrict__ lse, int S,
                     int Skv, int H, int topk, int q_offset, float scale) {
  using L = WgLayout<D, DR>;
  constexpr int DK = D + DR;
  constexpr int NB = DK / 64;        // 64-column blocks of a row, 8 KB each
  constexpr int CH = DK / 8;         // 16-byte chunks of a row
  constexpr int NV = D / 2;          // a consumer's columns of O
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* buf =
      smem_raw + ((1024 - (tl_gemm::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = buf;
  unsigned char* sKV = buf + L::kKV;
  unsigned char* sP = buf + L::kP;
  int* sIds = reinterpret_cast<int*>(buf + L::kIds);
  unsigned* sMask = reinterpret_cast<unsigned*>(buf + L::kMask);
  float* sMax = reinterpret_cast<float*>(buf + L::kMax);
  float* sL = reinterpret_cast<float*>(buf + L::kL);
  uint64_t* full = reinterpret_cast<uint64_t*>(buf + L::kBar);
  uint64_t* empty = full + kWgStages;
  uint64_t* q_bar = empty + kWgStages;

  const int hg = blockIdx.x, t = blockIdx.y, b = blockIdx.z;
  const long long tok = (long long)b * S + t;
  const int bound = q_offset + t;       // the token's last visible row
  const int* ids = ind + tok * topk;
  const E* kvb = kv + (long long)b * Skv * DK;
  const int n_tiles = (topk + kWgSlots - 1) / kWgSlots;
  const int cg = threadIdx.x / 128;            // 2: the producer
  const int warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      tl_sm90::mbar_init(&full[s], 128);      // a producer thread each
      tl_sm90::mbar_init(&empty[s], 8);       // a consumer warp each
    }
    tl_sm90::mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (cg == 2) {                               // the producer
    if (threadIdx.x == 256) {
      tl_sm90::mbar_expect_tx(q_bar, L::kTile);
      for (int j = 0; j < NB; ++j)
        tl_sm90::tma_load(sQ + j * 8192, &qmap, q_bar, 64 * j,
                          (int)(tok * H) + hg * 64);
    }
    for (int tile = 0; tile < n_tiles; ++tile) {
      const int s = tile % kWgStages;
      tl_sm90::mbar_wait(&empty[s], ((tile / kWgStages) & 1) ^ 1);
      int* sid = sIds + s * kWgSlots;
      if (warp < 2) {                            // slots 32 warp + lane
        const int slot = tile * kWgSlots + 32 * warp + lane;
        const int id = slot < topk ? __ldg(ids + slot) : -1;
        const bool ok = id >= 0 && id <= bound && id < Skv;
        sid[32 * warp + lane] = ok ? id : -1;
        const unsigned live = __ballot_sync(kFull, ok);
        if (lane == 0) sMask[2 * s + warp] = live;
      }
      tl_sm90::named_sync(1, 128);               // the ids are in
      // warp w copies rows w, w + 4, ...: row r's chunks lane + 32 k, all
      // at chunk lane % 8 of their 128-byte row, swizzled to (lane % 8)
      // ^ (r % 8)
      unsigned char* dst = sKV + s * L::kTile + (lane / 8) * 8192;
      for (int r = warp; r < kWgSlots; r += 4) {
        const int id = sid[r];
        const E* src = (id >= 0 ? kvb + (long long)id * DK : kvb) + lane * 8;
        unsigned char* d = dst + r * 128 + (((lane % 8) ^ (r % 8)) << 4);
#pragma unroll
        for (int k = 0; k < (CH + 31) / 32; ++k)
          if (32 * k + lane < CH)
            tl_gemm::cp_async16(d + k * 4 * 8192, src + k * 256, id >= 0);
      }
      tl_gemm::cp_async_commit();
      tl_gemm::cp_async_wait<0>();
      // the rows, written through the generic proxy, for wgmma's reads
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      tl_sm90::mbar_arrive(&full[s]);
    }
    return;
  }

  // the consumers: warpgroup cg
  const int r0 = 16 * warp + lane / 4;         // rows r0 and r0 + 8
  const int q2 = (lane % 4) * 2;               // columns q2, q2 + 1 of 8
  float acc[NV / 2];
#pragma unroll
  for (int i = 0; i < NV / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const unsigned q_base = tl_gemm::smem_addr(sQ);
  const unsigned p_base = tl_gemm::smem_addr(sP);
  tl_sm90::mbar_wait(q_bar, 0);

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int s = tile % kWgStages;
    tl_sm90::mbar_wait(&full[s], (tile / kWgStages) & 1);
    const unsigned mk0 = sMask[2 * s], mk1 = sMask[2 * s + 1];
    if ((mk0 | mk1) == 0) {                    // no valid slot: both skip
      if (lane == 0) tl_sm90::mbar_arrive(&empty[s]);
      continue;
    }
    const unsigned mine = cg ? mk1 : mk0;
    const unsigned kv_base = tl_gemm::smem_addr(sKV + s * L::kTile);

    // 1. the scores of the 64 heads over this consumer's 32 slots
    // the descriptors of Q's and this consumer's first rows; a k16 step
    // is 32 bytes on along a 128-byte row, a 64-column block 8 KB on
    const uint64_t qd = kdesc(q_base);
    const uint64_t kd = kdesc(kv_base + cg * 32 * 128);
    float sc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) sc[i] = 0.f;
    tl_sm90::fence_regs(sc);
    tl_sm90::wg_fence();
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        tl_sm90::wgmma16<E, 32, 0, 0>(
            sc, qd + (uint64_t)((j * 8192 + kk * 32) >> 4),
            kd + (uint64_t)((j * 8192 + kk * 32) >> 4));
    tl_sm90::wg_commit();
    tl_sm90::wg_wait<0>();
    tl_sm90::fence_regs(sc);

    // 2. online softmax in the exp2 domain over both consumers' slots, the
    // max floored at -1e30; a row's 32 slots here lie on a lane quad
    float mx[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * j + 2 * h + e];
          x = (mine >> (8 * j + q2 + e)) & 1u ? x * scale : -INFINITY;
          v = fmaxf(v, x);
        }
      v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
      mx[h] = fmaxf(v, __shfl_xor_sync(kFull, v, 2));
    }
    if (lane % 4 == 0) {
      sMax[64 * cg + r0] = mx[0];
      sMax[64 * cg + r0 + 8] = mx[1];
    }
    tl_sm90::named_sync(2, 256);               // both consumers' maxima
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float other = sMax[64 * (1 - cg) + r0 + 8 * h];
      const float m_new = fmaxf(m[h], fmaxf(fmaxf(mx[h], other), -1e30f));
      const float alpha = exp2f(m[h] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * j + 2 * h + e];
          x = exp2f(x - m_new);
          ps += x;
        }
      ps += __shfl_xor_sync(kFull, ps, 1);
      ps += __shfl_xor_sync(kFull, ps, 2);
      l[h] = l[h] * alpha + ps;
      m[h] = m_new;
#pragma unroll
      for (int j = 0; j < NV / 8; ++j) {
        acc[4 * j + 2 * h] *= alpha;
        acc[4 * j + 2 * h + 1] *= alpha;
      }
      // p rounded to E into P's columns 32 cg + 8 j + q2 (K-major, the
      // 128-byte swizzle: chunk 4 cg + j of row r sits at chunk ^ r % 8)
      const int r = r0 + 8 * h;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<unsigned*>(
            sP + r * 128 + (((4 * cg + j) ^ (r % 8)) << 4) + 2 * q2) =
            pack2<E>(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    tl_sm90::named_sync(2, 256);               // P is whole

    // 3. O[:, cg NV ..] += P . V, V MN-major: the staged rows' first D
    // columns, 64-column blocks 8 KB apart
    tl_sm90::fence_regs(acc);
    tl_sm90::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      tl_sm90::wgmma16<E, NV, 0, 1>(
          acc, kdesc(p_base + kk * 32),
          tl_sm90::make_desc(kv_base + cg * (NV / 64) * 8192 + kk * 16 * 128,
                             8192, 1024, 128));
    tl_sm90::wg_commit();
    tl_sm90::wg_wait<0>();
    tl_sm90::fence_regs(acc);
    if (lane == 0) tl_sm90::mbar_arrive(&empty[s]);
  }

  // l over both consumers' slots; O = acc / max(l, 1e-30) in E; Lse
  if (lane % 4 == 0) {
    sL[64 * cg + r0] = l[0];
    sL[64 * cg + r0 + 8] = l[1];
  }
  tl_sm90::named_sync(2, 256);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h, head = hg * 64 + r;
    if (head >= H) continue;
    const float lt = l[h] + sL[64 * (1 - cg) + r];
    const float den = fmaxf(lt, 1e-30f);
    E* orow = o + (tok * H + head) * D + cg * NV + q2;
#pragma unroll
    for (int j = 0; j < NV / 8; ++j)
      *reinterpret_cast<unsigned*>(orow + 8 * j) =
          pack2<E>(acc[4 * j + 2 * h] / den, acc[4 * j + 2 * h + 1] / den);
    if (cg == 0 && lane % 4 == 0) lse[tok * H + head] = natural_lse(m[h], lt);
  }
}

// Launches sparse_mla_fwd_wgmma on `st`: Q's map over (B S H, D + DT)
// in boxes of 64 x 64; cudaErrorInvalidValue when the map is refused
template <int D, int DR, typename E>
int launch_wgmma(const void* q, const void* kv, const int* ind, void* o,
                 float* lse, int B, int S, int Skv, int H, int topk,
                 int q_offset, float scale, cudaStream_t st) {
  CUtensorMap qmap;
  const int type =
      std::is_same_v<E, __half> ? tl_gemm::kF16 : tl_gemm::kBF16;
  if (!tl_sm90::make_map(&qmap, q, type, (long long)B * S * H, D + DR,
                         D + DR, 64, 64))
    return (int)cudaErrorInvalidValue;
  const auto kern = sparse_mla_fwd_wgmma<D, DR, E>;
  constexpr int smem = WgLayout<D, DR>::kSmem;
  const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  kern<<<dim3((H + 63) / 64, S, B), kWgThreads, smem, st>>>(
      qmap, static_cast<const E*>(kv), ind, static_cast<E*>(o), lse, S, Skv,
      H, topk, q_offset, scale);
  return (int)cudaGetLastError();
}

// the kernels' codes (ops/dsa.py::sparse_mla_path)
constexpr int kPathF32 = 0, kPathMma = 1, kPathWgmma = 2;

template <int D, int DR>
int launch_widths(const void* q, const void* kv, const int* ind, void* o,
                  float* lse, int B, int S, int Skv, int H, int topk,
                  int q_offset, int dt, int path, float scale,
                  cudaStream_t st) {
  if ((dt == kF32) != (path == kPathF32))
    return static_cast<int>(cudaErrorInvalidValue);
  if (path == kPathWgmma) {
    if constexpr (D % 128 == 0) {
      if (dt == kBF16)
        return launch_wgmma<D, DR, __nv_bfloat16>(
            q, kv, ind, o, lse, B, S, Skv, H, topk, q_offset, scale, st);
      if (dt == kF16)
        return launch_wgmma<D, DR, __half>(q, kv, ind, o, lse, B, S, Skv, H,
                                           topk, q_offset, scale, st);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (path != kPathF32 && path != kPathMma)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dt) {
    case kF32:
      return launch(sparse_mla_fwd<D, DR>, dim3((H + kG - 1) / kG, S, B),
                    kThreads, smem_bytes<D, DR>(), st,
                    static_cast<const float*>(q),
                    static_cast<const float*>(kv), ind,
                    static_cast<float*>(o), lse, S, Skv, H, topk, q_offset,
                    scale);
    case kBF16:
      return launch(sparse_mla_fwd_mma<D, DR, __nv_bfloat16>,
                    dim3((H + kMmaHeads - 1) / kMmaHeads, S, B), kMmaThreads,
                    mma_smem_bytes<D, DR>(), st,
                    static_cast<const __nv_bfloat16*>(q),
                    static_cast<const __nv_bfloat16*>(kv), ind,
                    static_cast<__nv_bfloat16*>(o), lse, S, Skv, H, topk,
                    q_offset, scale);
    case kF16:
      return launch(sparse_mla_fwd_mma<D, DR, __half>,
                    dim3((H + kMmaHeads - 1) / kMmaHeads, S, B), kMmaThreads,
                    mma_smem_bytes<D, DR>(), st,
                    static_cast<const __half*>(q),
                    static_cast<const __half*>(kv), ind,
                    static_cast<__half*>(o), lse, S, Skv, H, topk, q_offset,
                    scale);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches the kernel of code `path` (0 sparse_mla_fwd, float32; 1
// sparse_mla_fwd_mma, 2 sparse_mla_fwd_wgmma, bfloat16 / float16) on
// `stream` and returns cudaGetLastError() (0 = launched);
// cudaErrorInvalidValue for a (D, DT) pair, a type code `dt` (0 float32,
// 1 bfloat16, 3 float16) or a path without an instance. All operands
// contiguous, Q and KV on 16 bytes; the Python wrapper checks shapes and
// types first.
extern "C" int tl_sparse_mla_fwd(const void* q, const void* kv,
                                 const void* ind, void* o, void* lse, int B,
                                 int S, int Skv, int H, int D, int DT,
                                 int topk, int q_offset, int dt, int path,
                                 float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* id = static_cast<const int*>(ind);
  float* l = static_cast<float*>(lse);
#define TL_CASE(C, R)                                                    \
  if (D == C && DT == R)                                                 \
    return launch_widths<C, R>(q, kv, id, o, l, B, S, Skv, H, topk,      \
                               q_offset, dt, path, scale, st);
  TL_CASE(512, 64)
  TL_CASE(256, 64)
  TL_CASE(192, 64)
  TL_CASE(128, 64)
#undef TL_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
