// Grouped GEMMs for Hopper (sm_90a): dense and token-sorted.
//
// Replaces two TPU kernels of tilelang_mesh_tpu/ops/grouped_gemm.py:
//   grouped_gemm_kernel (:17)        -> tl_grouped_gemm_tma,
//                                       tl_grouped_gemm_tf32x3,
//                                       tl_grouped_gemm
//     X (E, M, K) @ W (E, K, N) -> O (E, M, N) in X's type (float32,
//     bfloat16 or float16), float32 accumulation.
//   varlen_grouped_gemm_kernel (:58) -> tl_varlen_grouped_gemm_tma,
//                                       tl_varlen_grouped_gemm_tf32x3,
//                                       tl_varlen_grouped_gemm
//     A (sum sizes, K) holds every group's rows back to back; a block
//     reads its expert and first row from device int32 tables (the
//     host's _varlen_meta at the kernel's block rows), and the end row
//     of its group bounds what it stores: rows past it belong to the
//     next group and are never written. C is (sum sizes, N) float32,
//     written in place; the TPU kernel instead wrote a block-padded C
//     (and read block_M zero rows appended to A) that its wrapper
//     compacted, with the same result. B is (E, K, N), or (E, N, K) when
//     trans_b.
//
// The host rule (ops/grouped_gemm.py::grouped_path) picks one of three
// kernels a call, before the launch:
//
// * bfloat16 / float16 with 16-byte aligned bases and row strides:
//   grouped_tma, gemm_sm90.cuh's pipeline (a TMA producer warpgroup, two
//   wgmma consumer warpgroups, mainloop16) at a block of TL_SM90_BLOCKS,
//   the accumulator stored straight from registers (store_acc: staging
//   it through shared memory was slower for float32 outputs and no
//   faster for 16-bit ones). Each expert's operand is
//   a plane of a 3-D tensor map: W as (N, K, E) MN-major, or (K, N, E)
//   K-major when trans_b; X of the dense product as (K, M, E). A box past
//   a plane's K or M is zero-filled inside that expert: a 2-D map over
//   (E * K, N) would read expert e + 1's first rows as e's K tail. The
//   token-sorted A is a 2-D map over (sum sizes, K): rows past the
//   group's end are loaded and multiplied, and not stored.
// * float32, aligned the same way: grouped_tf32x3, the products on the
//   tensor cores in three TF32 passes. Each operand element x splits
//   into big, x cut to TF32 (toward zero, clamped to TF32's largest),
//   and small = tf32(x - big) (cvt.rna), and big_a big_b + big_a small_b
//   + small_a big_b accumulate in float32 (small_a small_b, under 2^-20
//   relative, is dropped): float32's accuracy, where one TF32 pass keeps
//   about three digits. wgmma takes a TF32 B K-major only, and W (K, N)
//   is MN-major: so the same pipeline runs with a converting stage (as
//   lowbit_sm90.cuh's): the TMA ring holds the operands as loaded; the
//   consumers split (and transpose) stage kt + 1's B into K-major big and
//   small tiles, a quarter after each k8 step's wgmmas of stage kt, and
//   split A's fragments in registers (wgmma's A from registers: with A
//   and B both converted there, shared memory's bandwidth, not the
//   tensor cores, set the pace); no pre-pass writes a split W. The
//   tensor cores' own float32 sums drop about half an ulp of the running
//   sum a product, always toward zero: summed over K 4096 into one
//   accumulator that drifted 3e-5 of max |C| off on an H100, three times
//   the 1e-5 gate. So each K tile's (32 deep) products sum into a
//   partial of their own, added into the accumulator by rounding float32
//   adds. inf and NaN come out where a float32 product gives them
//   (x::split).
// * everything else (odd widths, unaligned views): the block tile loop
//   of gemm_tile.cuh.
//
// Tile order: expert outermost, then the N panels, the M tiles fastest,
// so the blocks in flight share a panel of W[e] through L2 (a 256-column
// bf16 panel at K 4096 is 2 MB; W[e] whole at N 14336 is 117 MB).
//
// Bound: operations at the MoE layer's shapes. A (1280 x 4096) @
// (4096 x 14336) expert product does 2 M N K = 150 GFLOP on 352 MB
// (float32), about 430 flops a byte, above the card's balance point in
// bf16 (989 TFLOP/s against 3.35 TB/s: 295). In float32 the three TF32
// passes (495 TFLOP/s each) run the product at up to 165 TFLOP/s, past
// the 67 of FFMA. (mma.sync's TF32 rate leaves three passes no faster
// than cuBLAS's FFMA SGEMM; hence wgmma.)

#include "gemm_sm90.cuh"

namespace {

using namespace tl_gemm;
namespace sm90 = tl_sm90;

template <typename T>
__global__ void __launch_bounds__(kThreads)
grouped_gemm(const T* __restrict__ x, const T* __restrict__ w,
             T* __restrict__ o, int M, int N, int K, int vec) {
  const long long e = blockIdx.z;
  const int m0 = blockIdx.x * BM;
  const Tile<T, T> t{x + (e * M + m0) * K, w + e * K * N,
                     o + (e * M + m0) * N, min(BM, M - m0),
                     (int)blockIdx.y * BN};
  gemm_tile<false>(t, K, N, vec != 0);
}

template <typename T, bool TRANS_B>
__global__ void __launch_bounds__(kThreads)
varlen_grouped_gemm(const T* __restrict__ a, const T* __restrict__ b,
                    const int* __restrict__ blk_exp,
                    const int* __restrict__ blk_row,
                    const int* __restrict__ group_end,
                    float* __restrict__ c, int N, int K, int vec) {
  const int e = blk_exp[blockIdx.x], r0 = blk_row[blockIdx.x];
  const Tile<T, float> t{a + (long long)r0 * K, b + (long long)e * K * N,
                         c + (long long)r0 * N, min(BM, group_end[e] - r0),
                         (int)blockIdx.y * BN};
  gemm_tile<TRANS_B>(t, K, N, vec != 0);
}

// ---------------------------------------------------------------------------
// where a block of the new kernels works
// ---------------------------------------------------------------------------

// The block's expert e, its first row m0 (of X[e], or of the token-sorted
// A), its real rows (1..TM) and its first column n0. Dense: the grid
// (M tiles, N panels, experts). Token-sorted: a one-dimensional grid of
// TB * tn blocks over the tables [blk_row (TB) | first (E + 1) |
// group_end (E)], expert e owning table blocks first[e] ..
// first[e + 1] - 1, each taken in every one of the tn N panels.
struct Place {
  int e, m0, rows, n0;
};

template <bool VARLEN, int TM, int TN>
__device__ __forceinline__ Place place(const int* __restrict__ tables,
                                       int M, int N, int E, int TB) {
  if constexpr (!VARLEN) {
    const int m0 = blockIdx.x * TM;
    return {(int)blockIdx.z, m0, min(TM, M - m0), (int)blockIdx.y * TN};
  } else {
    const int* first = tables + TB;
    const int* end = first + E + 1;
    const int tn = (N + TN - 1) / TN;
    int pid = blockIdx.x, e = 0, b0 = 0, nb = 0;
    for (; e < E; ++e) {
      b0 = first[e];
      nb = first[e + 1] - b0;
      if (pid < nb * tn) break;
      pid -= nb * tn;
    }
    const int m0 = tables[b0 + pid % nb];
    return {e, m0, min(TM, end[e] - m0), (pid / nb) * TN};
  }
}

// ---------------------------------------------------------------------------
// the TMA pipeline of both new kernels
// ---------------------------------------------------------------------------

// The ring's barriers (thread 0), then the block waits for them: full[s]
// when stage s's TMA bytes have landed, empty[s] when its eight consumer
// warps are done with it
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty,
                                          int stages) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 8);     // a consumer warp each
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The producer warpgroup, its thread 0 loading: K tile kt's A and B into
// ring stage kt % S of `stage` bytes once the consumers have freed it,
// A's TK x TM box at the stage's head (at (k0, m0), or (k0, m0, e) when
// dense) and B `stage_a` bytes on: one TK x TN box at (k0, n0, e) when
// TRANS_B, else TN / BOX_N boxes of BOX_N columns by TK rows, `box` bytes
// apart, at (n0 + BOX_N j, k0, e)
template <bool VARLEN, bool TRANS_B, int TK, int TN, int BOX_N>
__device__ __forceinline__ void produce(const CUtensorMap* ma,
                                        const CUtensorMap* mb, char* buf,
                                        uint64_t* full, uint64_t* empty,
                                        int S, int stage, int stage_a,
                                        int box, const Place& p, int nk) {
  sm90::setmaxnreg_dec<40>();
  if (threadIdx.x != 0) return;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % S;
    sm90::mbar_wait(&empty[s], ((kt / S) & 1) ^ 1);
    char* sa = buf + s * stage;
    char* sb = sa + stage_a;
    sm90::mbar_expect_tx(&full[s], stage);
    const int k0 = kt * TK;
    if constexpr (VARLEN)
      sm90::tma_load(sa, ma, &full[s], k0, p.m0);
    else
      sm90::tma_load3(sa, ma, &full[s], k0, p.m0, p.e);
    if constexpr (TRANS_B)
      sm90::tma_load3(sb, mb, &full[s], k0, p.n0, p.e);
    else
      for (int j = 0; j < TN / BOX_N; ++j)
        sm90::tma_load3(sb + j * box, mb, &full[s], p.n0 + BOX_N * j, k0,
                        p.e);
  }
}

// two neighbouring columns of C in one store
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// A consumer warpgroup's wgmma accumulator (MI slices of 64 rows from
// row0, TN columns from n0) straight into C of the float type O at rows
// m0 + ...: a thread's two neighbouring columns a store when N is even
// (a warp's store then covers 8 rows of 32 bytes in float32), one at a
// time otherwise; rows past `rows` and columns past N are not stored
template <int MI, int TN, typename O>
__device__ __forceinline__ void store_acc(O* c,
                                          const float (&acc)[MI][TN / 2],
                                          int rows, int row0, int m0, int n0,
                                          int N) {
  const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
  const bool pairs = N % 2 == 0;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int j = 0; j < TN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + mi * 64 + 16 * w + lane / 4 + 8 * h;
        const int n = n0 + 8 * j + 2 * (lane % 4);
        if (r >= rows || n >= N) continue;
        O* p = c + (long long)(m0 + r) * N + n;
        const float v0 = acc[mi][4 * j + 2 * h];
        const float v1 = acc[mi][4 * j + 2 * h + 1];
        if (pairs) {
          store2(p, v0, v1);
        } else {
          store(p, v0);
          if (n + 1 < N) store(p + 1, v1);
        }
      }
}

// ---------------------------------------------------------------------------
// bfloat16 / float16: TMA + wgmma
// ---------------------------------------------------------------------------

// One TM x TN tile of C through the maps `ma` (X's (K, M, E), or the
// token-sorted A's (K, rows) when VARLEN; K-major) and `mb` (W's (N, K,
// E) MN-major, or (K, N, E) K-major when TRANS_B). C: O (E, M, N) in T,
// or (rows, N) float32 when VARLEN.
template <typename T, int TM, int TN, int TK, bool VARLEN, bool TRANS_B>
__global__ void __launch_bounds__(sm90::kThreads, 1)
grouped_tma(const __grid_constant__ CUtensorMap ma,
            const __grid_constant__ CUtensorMap mb, void* __restrict__ c,
            const int* __restrict__ tables, int M, int N, int K, int E,
            int TB) {
  using C = sm90::Cfg<T, TM, TN, TK>;
  extern __shared__ __align__(1024) char smem_raw[];
  char* buf = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(buf + C::kBuf);
  uint64_t* empty = full + C::kStages;
  const Place p = place<VARLEN, TM, TN>(tables, M, N, E, TB);
  const int nk = (K + TK - 1) / TK;
  const int wg = threadIdx.x / 128;
  init_ring(full, empty, C::kStages);
  if (wg == 0) {                          // producer
    produce<VARLEN, TRANS_B, TK, TN, 64>(&ma, &mb, buf, full, empty,
                                         C::kStages, C::kStage, C::kStageA,
                                         64 * TK * (int)sizeof(T), p, nk);
    return;
  }

  sm90::setmaxnreg_inc<232>();            // consumers
  constexpr int MI = TM / 128;
  const int cw = wg - 1;
  const int row0 = cw * (TM / 2);
  float acc[MI][TN / 2];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int i = 0; i < TN / 2; ++i) acc[mi][i] = 0.f;
  sm90::mainloop16<T, TM, TN, TK, 0, TRANS_B ? 0 : 1>(acc, buf, full, empty,
                                                      nk, row0);

  if constexpr (VARLEN)
    store_acc<MI, TN>(static_cast<float*>(c), acc, p.rows, row0, p.m0, p.n0,
                      N);
  else
    store_acc<MI, TN>(static_cast<T*>(c) + (long long)p.e * M * N, acc,
                      p.rows, row0, p.m0, p.n0, N);
}

// ---------------------------------------------------------------------------
// float32: 3xTF32 on wgmma
// ---------------------------------------------------------------------------

namespace x3 {

constexpr int TM = 128, TN = 128, TK = 32;  // TK: a 128-byte float32 row
constexpr int kTile = TM * TK * 4;          // 16 KB: an A or B tile
constexpr int kRaw = 2 * kTile;             // a ring stage: A, B as loaded
constexpr int kCvt = 2 * kTile;             // B big, B small
static_assert(kTile / 16 / 256 == TK / 8,
              "a consumer thread splits one 16-byte B chunk a k8 step");
constexpr int kStages = (sm90::kSmemOptin - 2048 - 2 * kCvt) / kRaw;
constexpr int kRing = kStages * kRaw;
constexpr int kSmem = kRing + 2 * kCvt + 2 * kStages * 8 + 1024;
static_assert(TM == TN && kStages >= 2 && kSmem <= sm90::kSmemOptin,
              "tiles past shared memory");

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

// x = big + small to about 2^-21 relative, both TF32: big is x cut to
// TF32 (its low 13 bits cleared), its magnitude clamped to TF32's
// largest; small = x - big (exact), rounded to TF32. Three integer
// operations and no branch: a branch here, between wgmmas in flight,
// doubled the kernel's time. Cut toward zero, small has x's sign or is
// zero, so an infinite x splits as (+-TF32 max, x) and each of the three
// products is of the sign of a b or zero: inf and NaN come out where
// float32 products give them. (Rounding big to nearest would leave small
// of either sign, and a huge big times it could overflow to the opposite
// infinity.) A NaN x has a finite big and a NaN small.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  const uint32_t bits = __float_as_uint(x);
  big = min(bits & 0x7fffe000u, 0x7f7fe000u) | (bits & 0x80000000u);
  small = tf32(x - __uint_as_float(big));
}

// generic-proxy writes to shared memory visible to wgmma's reads
__device__ __forceinline__ void fence_view_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void split4(float4 v, float4* big, float4* small) {
  uint32_t b[4], s[4];
  split(v.x, b[0], s[0]);
  split(v.y, b[1], s[1]);
  split(v.z, b[2], s[2]);
  split(v.w, b[3], s[3]);
  *big = make_float4(__uint_as_float(b[0]), __uint_as_float(b[1]),
                     __uint_as_float(b[2]), __uint_as_float(b[3]));
  *small = make_float4(__uint_as_float(s[0]), __uint_as_float(s[1]),
                       __uint_as_float(s[2]), __uint_as_float(s[3]));
}

// Consumer thread t (0..255)'s share j (0..TK / 8 - 1) of a stage's B
// split: `raw` holds A (K-major, TMA's 128-byte swizzle) and B, `cvt`
// gets B big and B small, K-major in wgmma's canonical 128-byte-swizzled
// layout (row n's 16-byte chunk c at n * 128 + (c ^ n % 8) * 16). A
// K-major B keeps its places; an MN-major B ([TK][TN] as loaded, rows of
// 512 bytes) is transposed: 8 consecutive lanes take 8 consecutive
// columns n and one chunk c, loads of 128 contiguous bytes and 16-byte
// stores to 8 distinct bank groups.
template <bool TRANS_B>
__device__ __forceinline__ void convert(const char* raw, char* cvt, int t,
                                        int j) {
  float4* bb = reinterpret_cast<float4*>(cvt);
  float4* bs = bb + kTile / 16;
  if constexpr (TRANS_B) {
    const float4* rb = reinterpret_cast<const float4*>(raw + kTile);
    const int q = t + 256 * j;
    split4(rb[q], bb + q, bs + q);
  } else {
    const float* rb = reinterpret_cast<const float*>(raw + kTile);
    const int i = t + 256 * j, n = i % TN, c = i / TN;
    const float* col = rb + 4 * c * TN + n;
    const int at = n * (TK / 4) + (c ^ (n & 7));
    split4(make_float4(col[0], col[TN], col[2 * TN], col[3 * TN]), bb + at,
           bs + at);
  }
}

// Consumer cw's products of one stage into `part`, the first zeroing it:
// per k8 step A's fragment (rows of the raw, 128-byte-swizzled A tile)
// split into big and small in registers, then small_a big_b, big_a
// small_b, big_a big_b; two register sets alternate, a set rewritten
// only once the products that read it are done (wait_group 1)
template <bool TRANS_B>
__device__ __forceinline__ void products(float (&part)[64], const float* ra,
                                         unsigned cvt, int cw,
                                         const char* next_raw,
                                         char* next_cvt) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r = cw * 64 + 16 * (threadIdx.x % 128 / 32) + g;
  uint32_t big[2][4], small[2][4];
#pragma unroll
  for (int kk = 0; kk < TK / 8; ++kk) {
    if (kk >= 2) sm90::wg_wait<1>();
    uint32_t(&ab)[4] = big[kk & 1];
    uint32_t(&as)[4] = small[kk & 1];
    const int c0 = ((2 * kk) ^ g) * 4 + t, c1 = ((2 * kk + 1) ^ g) * 4 + t;
    split(ra[r * 32 + c0], ab[0], as[0]);
    split(ra[(r + 8) * 32 + c0], ab[1], as[1]);
    split(ra[r * 32 + c1], ab[2], as[2]);
    split(ra[(r + 8) * 32 + c1], ab[3], as[3]);
    const uint64_t b_big = sm90::kmajor<float, TK>(cvt, 0, kk * 32);
    const uint64_t b_small =
        sm90::kmajor<float, TK>(cvt + kTile, 0, kk * 32);
    sm90::wg_fence();
    sm90::wgmma_tf32_rs_n128(part, as, b_big, kk);
    sm90::wgmma_tf32_rs_n128(part, ab, b_small, 1);
    sm90::wgmma_tf32_rs_n128(part, ab, b_big, 1);
    sm90::wg_commit();
    if (next_raw)
      convert<TRANS_B>(next_raw, next_cvt, threadIdx.x - 128, kk);
  }
}

}  // namespace x3

// One 128 x 128 tile of C (float32) = A @ op(B) of float32 operands on
// gemm_sm90.cuh's pipeline with a converting stage: the producer's TMA
// loads (the maps of grouped_tma, in float32: A K-major with the
// 128-byte swizzle; B MN-major unswizzled, or K-major swizzled when
// TRANS_B); the two consumer warpgroups split (and transpose) stage kt +
// 1's B into one of two converted tiles between their wgmmas of stage kt
// (on the other tile, A's fragments split in registers), release a ring
// stage once its A is read and its B split, and add each stage's
// partial sums (a register set of its own, zeroed by the stage's first
// wgmma) into the accumulator once its products are done. C: O (E, M,
// N), or (rows, N) when VARLEN.
template <bool VARLEN, bool TRANS_B>
__global__ void __launch_bounds__(sm90::kThreads, 1)
grouped_tf32x3(const __grid_constant__ CUtensorMap ma,
               const __grid_constant__ CUtensorMap mb, void* __restrict__ c,
               const int* __restrict__ tables, int M, int N, int K, int E,
               int TB) {
  using namespace x3;
  constexpr int S = kStages;
  extern __shared__ __align__(1024) char smem_raw[];
  char* buf = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  char* cvt = buf + kRing;
  uint64_t* full = reinterpret_cast<uint64_t*>(cvt + 2 * kCvt);
  uint64_t* empty = full + S;
  const Place p = place<VARLEN, TM, TN>(tables, M, N, E, TB);
  const int nk = (K + TK - 1) / TK;
  const int wg = threadIdx.x / 128;
  init_ring(full, empty, S);
  if (wg == 0) {                          // producer
    produce<VARLEN, TRANS_B, TK, TN, TN>(&ma, &mb, buf, full, empty, S, kRaw,
                                         kTile, kTile, p, nk);
    return;
  }

  sm90::setmaxnreg_inc<232>();            // consumers
  const int cw = wg - 1, t = threadIdx.x - 128;
  const bool lead = threadIdx.x % 32 == 0;
  float acc[1][64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[0][i] = 0.f;
  sm90::mbar_wait(&full[0], 0);
#pragma unroll
  for (int j = 0; j < TK / 8; ++j) convert<TRANS_B>(buf, cvt, t, j);
  fence_view_async();
  sm90::named_sync(1, 256);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % S, s1 = (kt + 1) % S;
    const bool next = kt + 1 < nk;
    if (next) {
      sm90::mbar_wait(&full[s1], ((kt + 1) / S) & 1);
      sm90::named_sync(1, 256);  // both consumers past kt - 1: its tile free
    }
    products<TRANS_B>(part, reinterpret_cast<const float*>(buf + s * kRaw),
                      smem_addr(cvt + (kt & 1) * kCvt), cw,
                      next ? buf + s1 * kRaw : nullptr,
                      cvt + ((kt + 1) & 1) * kCvt);
    __syncwarp();
    if (lead) sm90::mbar_arrive(&empty[s]);   // A read, B split: free
    if (next) {
      fence_view_async();
      sm90::named_sync(1, 256);  // the tile of kt + 1 is written
    }
    sm90::wg_wait<0>();
    sm90::fence_regs(part);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[0][i] += part[i];
  }

  store_acc<1, TN>(static_cast<float*>(c) +
                       (VARLEN ? 0 : (long long)p.e * M * N),
                   acc, p.rows, cw * 64, p.m0, p.n0, N);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, cudaStream_t stream, Args... args) {
  kernel<<<grid, kThreads, 0, stream>>>(args...);
  return (int)cudaGetLastError();
}

// a kernel of `smem` bytes of dynamic shared memory (set on every
// launch, as gemm_sm90.cuh's launch_tma does)
template <typename Kernel, typename... Args>
int launch_smem(Kernel kernel, dim3 grid, int threads, int smem,
                cudaStream_t stream, Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <typename T>
int run_varlen(const void* a, const void* b, const int* blk_exp,
               const int* blk_row, const int* group_end, float* out, int N,
               int K, int trans_b, int vec, dim3 grid, cudaStream_t s) {
  const auto* pa = static_cast<const T*>(a);
  const auto* pb = static_cast<const T*>(b);
  return trans_b ? launch(varlen_grouped_gemm<T, true>, grid, s, pa, pb,
                          blk_exp, blk_row, group_end, out, N, K, vec)
                 : launch(varlen_grouped_gemm<T, false>, grid, s, pa, pb,
                          blk_exp, blk_row, group_end, out, N, K, vec);
}

// The maps of both new kernels: A K-major by TK x TM boxes, as a 2-D
// (rows, K) map when varlen, else a 3-D (E, M, K) one; B as (E, N, K)
// K-major by TK x TN boxes when trans_b, else as (E, K, N) by box_n x TK
// boxes
bool make_maps(CUtensorMap* ma, CUtensorMap* mb, const void* a,
               const void* b, int type, int E, int M, int rows, int N, int K,
               int varlen, int trans_b, int TM, int TN, int TK, int box_n) {
  return (varlen ? sm90::make_map(ma, a, type, rows, K, K, TK, TM)
                 : sm90::make_map3(ma, a, type, E, M, K, K, (long long)M * K,
                                   TK, TM)) &&
         (trans_b ? sm90::make_map3(mb, b, type, E, N, K, K,
                                    (long long)N * K, TK, TN)
                  : sm90::make_map3(mb, b, type, E, K, N, N,
                                    (long long)K * N, box_n, TK));
}

// One of a new kernel's three instances, each of grouped_tma's
// signature, at `smem` bytes: dense X (E, M, K), O (E, M, N), grid (M
// tiles, N panels, E); or token-sorted A (rows, K), C (rows, N) float32,
// TB * tn blocks, `sorted_t` when B is transposed
template <typename Kernel>
int launch_grouped(Kernel dense, Kernel sorted, Kernel sorted_t, int smem,
                   int TM, int TN, const CUtensorMap& ma,
                   const CUtensorMap& mb, void* c, const int* tables, int E,
                   int M, int N, int K, int TB, int varlen, int trans_b,
                   cudaStream_t s) {
  const int tn = (N + TN - 1) / TN;
  const dim3 grid = varlen ? dim3((unsigned)TB * (unsigned)tn)
                           : dim3((M + TM - 1) / TM, tn, E);
  return launch_smem(varlen ? (trans_b ? sorted_t : sorted) : dense, grid,
                     sm90::kThreads, smem, s, ma, mb, c, tables, M, N, K, E,
                     TB);
}

// grouped_tma at (TM, TN, TK) in T: B MN-major by 64-column boxes
template <typename T, int TM, int TN, int TK>
int run_tma(const void* a, const void* b, void* c, const int* tables, int E,
            int M, int rows, int N, int K, int TB, int varlen, int trans_b,
            int type, cudaStream_t s) {
  CUtensorMap ma, mb;
  if (!make_maps(&ma, &mb, a, b, type, E, M, rows, N, K, varlen, trans_b,
                 TM, TN, TK, 64))
    return (int)cudaErrorInvalidValue;
  return launch_grouped(grouped_tma<T, TM, TN, TK, false, false>,
                        grouped_tma<T, TM, TN, TK, true, false>,
                        grouped_tma<T, TM, TN, TK, true, true>,
                        sm90::Cfg<T, TM, TN, TK>::kSmem, TM, TN, ma, mb, c,
                        tables, E, M, N, K, TB, varlen, trans_b, s);
}

// run_tma at the block (bm, bn, bk) of TL_SM90_BLOCKS for the DType
// `type` (kBF16 or kF16); cudaErrorInvalidValue for another block or type
int dispatch_tma(const void* a, const void* b, void* c, const int* tables,
                 int E, int M, int rows, int N, int K, int TB, int varlen,
                 int trans_b, int type, int bm, int bn, int bk,
                 cudaStream_t s) {
#define TL_GROUPED_CASE(m, n, k)                                            \
  if (bm == m && bn == n && bk == k) {                                      \
    if (type == kBF16)                                                      \
      return run_tma<__nv_bfloat16, m, n, k>(a, b, c, tables, E, M, rows,   \
                                             N, K, TB, varlen, trans_b,     \
                                             type, s);                      \
    if (type == kF16)                                                       \
      return run_tma<__half, m, n, k>(a, b, c, tables, E, M, rows, N, K,    \
                                      TB, varlen, trans_b, type, s);        \
    return (int)cudaErrorInvalidValue;                                      \
  }
  TL_SM90_BLOCKS(TL_GROUPED_CASE)
#undef TL_GROUPED_CASE
  return (int)cudaErrorInvalidValue;
}

// grouped_tf32x3: float32 maps, A's 32 x 128 boxes swizzled; B by 128
// (N) x 32 (K) boxes unswizzled, or 32 x 128 swizzled when trans_b
int run_tf32x3(const float* a, const float* b, float* c, const int* tables,
               int E, int M, int rows, int N, int K, int TB, int varlen,
               int trans_b, cudaStream_t s) {
  using namespace x3;
  CUtensorMap ma, mb;
  if (!make_maps(&ma, &mb, a, b, kF32, E, M, rows, N, K, varlen, trans_b,
                 TM, TN, TK, TN))
    return (int)cudaErrorInvalidValue;
  return launch_grouped(grouped_tf32x3<false, false>,
                        grouped_tf32x3<true, false>,
                        grouped_tf32x3<true, true>, kSmem, TM, TN, ma, mb, c,
                        tables, E, M, N, K, TB, varlen, trans_b, s);
}

// bases on 16 bytes and row strides (K; ldb) multiples of 16 bytes
bool aligned16(const void* a, const void* b, int K, int ldb, int esize) {
  return reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
         (long long)K * esize % 16 == 0 && (long long)ldb * esize % 16 == 0;
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError() (0 =
// launched), or cudaErrorInvalidValue for what its path does not take;
// the Python wrapper checks shapes, types, devices and the grid's range
// before calling. `type` is the operands' DType code (gemm_tile.cuh):
// kF32, kBF16 or kF16.

// the block tile loop (any alignment and type)
extern "C" int tl_grouped_gemm(const void* x, const void* w, void* o, int E,
                               int M, int N, int K, int type, void* stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, E);
  const auto s = static_cast<cudaStream_t>(stream);
  const int vec = vec_ok(x, w, K, N, false, type == kF32 ? 4 : 2);
  if (type == kBF16)
    return launch(grouped_gemm<__nv_bfloat16>, grid, s,
                  static_cast<const __nv_bfloat16*>(x),
                  static_cast<const __nv_bfloat16*>(w),
                  static_cast<__nv_bfloat16*>(o), M, N, K, vec);
  if (type == kF16)
    return launch(grouped_gemm<__half>, grid, s,
                  static_cast<const __half*>(x), static_cast<const __half*>(w),
                  static_cast<__half*>(o), M, N, K, vec);
  return launch(grouped_gemm<float>, grid, s, static_cast<const float*>(x),
                static_cast<const float*>(w), static_cast<float*>(o), M, N,
                K, vec);
}

// blk_exp, blk_row (TB each), group_end (E): _varlen_meta at 128 rows
extern "C" int tl_varlen_grouped_gemm(const void* a, const void* b,
                                      const int* blk_exp, const int* blk_row,
                                      const int* group_end, void* c, int TB,
                                      int N, int K, int trans_b, int type,
                                      void* stream) {
  const dim3 grid(TB, (N + BN - 1) / BN);
  const auto s = static_cast<cudaStream_t>(stream);
  const int vec = vec_ok(a, b, K, N, trans_b != 0, type == kF32 ? 4 : 2);
  float* out = static_cast<float*>(c);
  if (type == kBF16)
    return run_varlen<__nv_bfloat16>(a, b, blk_exp, blk_row, group_end, out,
                                     N, K, trans_b, vec, grid, s);
  if (type == kF16)
    return run_varlen<__half>(a, b, blk_exp, blk_row, group_end, out, N, K,
                              trans_b, vec, grid, s);
  return run_varlen<float>(a, b, blk_exp, blk_row, group_end, out, N, K,
                           trans_b, vec, grid, s);
}

// TMA + wgmma at the block (bm, bn, bk) of TL_SM90_BLOCKS: bf16 / f16
extern "C" int tl_grouped_gemm_tma(const void* x, const void* w, void* o,
                                   int E, int M, int N, int K, int type,
                                   int bm, int bn, int bk, void* stream) {
  if (!aligned16(x, w, K, N, 2) || E < 1 || M < 1 || N < 1 || K < 1)
    return (int)cudaErrorInvalidValue;
  return dispatch_tma(x, w, o, nullptr, E, M, 0, N, K, 0, 0, 0, type, bm,
                      bn, bk, static_cast<cudaStream_t>(stream));
}

// tables: [blk_row (TB) | first (E + 1) | group_end (E)] at bm rows a
// block (ops/grouped_gemm.py::_varlen_tables); rows = sum of the sizes
extern "C" int tl_varlen_grouped_gemm_tma(const void* a, const void* b,
                                          const int* tables, void* c, int TB,
                                          int rows, int E, int N, int K,
                                          int trans_b, int type, int bm,
                                          int bn, int bk, void* stream) {
  if (!aligned16(a, b, K, trans_b ? K : N, 2) || TB < 1 || rows < 1 ||
      E < 1 || N < 1 || K < 1)
    return (int)cudaErrorInvalidValue;
  return dispatch_tma(a, b, c, tables, E, 0, rows, N, K, TB, 1, trans_b,
                      type, bm, bn, bk, static_cast<cudaStream_t>(stream));
}

// 3xTF32 on wgmma: float32
extern "C" int tl_grouped_gemm_tf32x3(const void* x, const void* w, void* o,
                                      int E, int M, int N, int K,
                                      void* stream) {
  if (!aligned16(x, w, K, N, 4) || E < 1 || M < 1 || N < 1 || K < 1)
    return (int)cudaErrorInvalidValue;
  return run_tf32x3(static_cast<const float*>(x),
                    static_cast<const float*>(w), static_cast<float*>(o),
                    nullptr, E, M, 0, N, K, 0, 0, 0,
                    static_cast<cudaStream_t>(stream));
}

// tables as tl_varlen_grouped_gemm_tma's, at 128 rows a block
extern "C" int tl_varlen_grouped_gemm_tf32x3(const void* a, const void* b,
                                             const int* tables, void* c,
                                             int TB, int rows, int E, int N,
                                             int K, int trans_b,
                                             void* stream) {
  if (!aligned16(a, b, K, trans_b ? K : N, 4) || TB < 1 || rows < 1 ||
      E < 1 || N < 1 || K < 1)
    return (int)cudaErrorInvalidValue;
  return run_tf32x3(static_cast<const float*>(a),
                    static_cast<const float*>(b), static_cast<float*>(c),
                    tables, E, 0, rows, N, K, TB, 1, trans_b,
                    static_cast<cudaStream_t>(stream));
}
