// BitNet b1.58's int8 x ternary GEMM for Hopper (sm_90a).
//
// Replaces the TPU kernel of tilelang_mesh_tpu/ops/bitnet.py:
//   bitnet_gemm_kernel (:51) -> tl_bitnet_gemm, tl_bitnet_gemm_splitk,
//   tl_bitnet_gemm_wgmma
//     A (M, K) int8 row-major, Wp (K/4, N) int8: byte (g, n) holds the
//     ternary weights of rows 4g + p (p = 0..3) in bits 2p..2p+1, each
//     biased by +1 (0, 1, 2 for -1, 0, 1; ops/bitnet.py pack_ternary)
//     -> C (M, N) int32, the exact product of A and the unpacked weights.
//     ops/bitnet.py::bitnet_path picks one of three kernels by the shape
//     and the operands' alignment.
//
// Bound: operations at a prefill, bytes at a decode step. At BitNet
// b1.58-2B-4T's gate/up product (M 4096, K 2560 -> N 6912) it does 145
// GOP on 14.9 MB in (A 10.5, the packed weights 4.4) and 113 MB out:
// 0.073 ms at 1979 TOP/s int8. At one token (M 1) it moves the 4.4 MB
// of packed weights for 35 MOP: 1.3 us.
//
// Few rows (tl_bitnet_gemm_splitk): the weights are read once, at the
// memory's rate. A block owns 512 columns and rows_per_block packed rows
// of K (the host's plan, ops/bitnet.py::bitnet_splitk_plan, spreads the
// blocks over every SM); each lane streams 16 columns with 16-byte loads,
// 8 packed rows of a warp in flight at once. A packed word (4 columns)
// splits into its four 2-bit fields by shifts and masks and a 4 x 4 byte
// transpose (prmt) gives each column its 4 biased weights as one word,
// whose product with A's 4 int8 values is one dp4a (unsigned x signed);
// the bias comes off as the sum of A's values (one more dp4a a row). The
// warps' sums meet in shared memory and the K splits by integer atomics
// into C, zeroed first: integer sums are exact in any order, so C is the
// plain version's exactly. Rows of A go in passes of up to 4.
//
// Many rows (tl_bitnet_gemm_wgmma): lowbit_sm90.cuh's TMA + wgmma
// pipeline at a 128 x 256 tile, k tiles of 128 bytes. TMA brings A's
// (128 x 128) tile in the 128-byte swizzle and the 32 packed rows raw;
// the consumers unpack them into the signed int8 B tile n-major (K-major:
// the only layout 8-bit wgmma reads), 128 bytes of K a column, 128-byte
// swizzled, then run wgmma m64n256k32 s8 x s8 -> s32. A thread unpacks 4
// columns x 16 rows of K: four packed words, each split into fields and
// transposed as above, the bias taken off bytewise ((f + 0x7F) ^ 0x80
// never borrows), one 16-byte store a column; the words are rotated by
// a lane-dependent byte count so that the 8 lanes of each store phase
// hit 8 different 16-byte bank groups. TMA's zero fill covers ragged M
// and K (A's zeros meet any weight); columns past N are not stored.
//
// The rest (tl_bitnet_gemm: misaligned operands, N or K off 16 bytes):
// the int8 loop of gemm_tile.cuh (mma.sync m16n8k32 s8 x s8 -> s32 on a
// 128 x 128 block tile, k-tiles of 64 bytes, double-buffered cp.async
// stages) with a converting source, as w4a8 in dequant_gemm.cu has for
// int4. A lands in its k-contiguous compute tile as it is. The 16 packed
// rows of a k-tile land raw; once they have arrived each thread unpacks
// one byte, column n and packed row g, into the four int8 weights of
// rows 4g .. 4g + 3 -- one 32-bit word of the n-major tile (ldmatrix
// `.trans`, which the row-major weights would need, moves 16-bit
// elements only). The unpack is a shift-and-mask spread of the four
// 2-bit fields into four bytes and a bytewise subtract of the bias
// (__vsub4), so a field never borrows from its neighbour. Packed rows
// past K/4 unpack to 0; A is zero past K in any case, so the int32 sums
// are exact for every K.

#include "gemm_dense.cuh"
#include "lowbit_sm90.cuh"

namespace {

using namespace tl_gemm;

// the four 2-bit fields of a packed byte as four int8 weights, row 4g + p
// in byte p
__device__ __forceinline__ uint32_t unpack4(uint32_t b) {
  const uint32_t f = (b & 0x03u) | ((b & 0x0Cu) << 6) | ((b & 0x30u) << 12) |
                     ((b & 0xC0u) << 18);
  return __vsub4(f, 0x01010101u);
}

struct Ternary {
  static constexpr int BKQ = s8::BK / 4;       // 16 packed rows a k-tile
  static constexpr int kA = s8::kTileBytes;
  static constexpr int kStageBytes = kA + BKQ * BN;
  static constexpr int kCvtBytes = s8::kTileBytes;
  static constexpr bool kConverts = true;
  const int8_t* a;            // row 0 of the block's rows
  const uint8_t* packed;
  int rows, n0, K, N;
  bool vec_a, vec_p;

  __device__ __forceinline__ void issue(char* stage, int kt) const {
    load_window<int8_t, BM, s8::BK, s8::LD>(reinterpret_cast<int8_t*>(stage),
                                            a, 0, kt * s8::BK, rows, K, K,
                                            vec_a);
    load_window<uint8_t, BKQ, BN, BN>(
        reinterpret_cast<uint8_t*>(stage + kA), packed, kt * BKQ, n0, K / 4,
        N, N, vec_p);
  }

  // thread: column j, packed row g -> one 4-byte word of the B tile
  __device__ __forceinline__ void view(char* stage, char* cvt, int kt,
                                       const int8_t*& As,
                                       const int8_t*& Bs) const {
    const uint8_t* p = reinterpret_cast<const uint8_t*>(stage + kA);
    int8_t* b = reinterpret_cast<int8_t*>(cvt);
    for (int i = threadIdx.x; i < BKQ * BN; i += kThreads) {
      const int g = i / BN, j = i % BN;
      const uint32_t w = kt * BKQ + g < K / 4 ? unpack4(p[g * BN + j]) : 0u;
      *reinterpret_cast<uint32_t*>(b + j * s8::LD + 4 * g) = w;
    }
    As = reinterpret_cast<const int8_t*>(stage);
    Bs = b;
  }
};

__global__ void __launch_bounds__(kThreads, kMinBlocks)
bitnet_gemm(const int8_t* __restrict__ a, const uint8_t* __restrict__ packed,
            int* __restrict__ c, int M, int N, int K, int vec_a, int vec_p) {
  const DenseBlock k(M, N, K, false);
  const Ternary src{a + k.a_off, packed, k.rows, k.n0, K, N, vec_a != 0,
                    vec_p != 0};
  s8::Acc acc;
  s8::loop(src, (K + s8::BK - 1) / s8::BK, acc);
  bf16::for_each(acc, DenseEpilogue{c, k.rows, k.m0, k.n0, N, kS32, 0});
}

// ---------------------------------------------------------------------------
// the two byte-level helpers of the new paths
// ---------------------------------------------------------------------------

// The four 2-bit fields of each byte of w (four columns, byte j column
// j): g[j] holds column j's fields, field p in byte p (the biased weights
// of rows 4g + p). Shifts and masks, then a 4 x 4 byte transpose.
__device__ __forceinline__ void fields4(uint32_t w, uint32_t (&g)[4]) {
  const uint32_t f0 = w & 0x03030303u, f1 = (w >> 2) & 0x03030303u;
  const uint32_t f2 = (w >> 4) & 0x03030303u, f3 = (w >> 6) & 0x03030303u;
  const uint32_t t0 = __byte_perm(f0, f1, 0x5140);
  const uint32_t t1 = __byte_perm(f0, f1, 0x7362);
  const uint32_t t2 = __byte_perm(f2, f3, 0x5140);
  const uint32_t t3 = __byte_perm(f2, f3, 0x7362);
  g[0] = __byte_perm(t0, t2, 0x5410);
  g[1] = __byte_perm(t0, t2, 0x7632);
  g[2] = __byte_perm(t1, t3, 0x5410);
  g[3] = __byte_perm(t1, t3, 0x7632);
}

// c + the dot product of the unsigned bytes of u and the signed bytes of a
__device__ __forceinline__ int dp4a_us(uint32_t u, uint32_t a, int c) {
  int d;
  asm("dp4a.u32.s32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(u), "r"(a), "r"(c));
  return d;
}

// ---------------------------------------------------------------------------
// few rows: split K, the weights streamed once
// ---------------------------------------------------------------------------

constexpr int kSkCols = 512;                  // a block: 32 lanes x 16
constexpr int kSkRows = 8;                    // packed rows a warp loads

// grid (ceil(N / 512), splits); block y owns packed rows [y rpb, (y + 1)
// rpb), warp w the w-th eighth of them; MR rows of A a pass
template <int MR>
__global__ void __launch_bounds__(kThreads)
bitnet_gemm_splitk(const int8_t* __restrict__ a,
                   const uint8_t* __restrict__ packed, int* __restrict__ c,
                   int M, int N, int K, int rpb) {
  __shared__ int red[MR][16 * 33];       // column 16 l + j at j * 33 + l
  const int G = K / 4;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col0 = blockIdx.x * kSkCols, n = col0 + 16 * lane;
  const int rpw = rpb / 8;
  const int g0 = blockIdx.y * rpb + warp * rpw;
  const int g1 = min(g0 + rpw, G);
  const uint32_t* a32 = reinterpret_cast<const uint32_t*>(a);
  for (int m0 = 0; m0 < M; m0 += MR) {
    for (int i = threadIdx.x; i < MR * 16 * 33; i += kThreads)
      (&red[0][0])[i] = 0;
    __syncthreads();
    int acc[MR][16], cor[MR];
#pragma unroll
    for (int mm = 0; mm < MR; ++mm) {
      cor[mm] = 0;
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[mm][j] = 0;
    }
    if (n < N) {
      for (int g = g0; g < g1; g += kSkRows) {
        uint4 w[kSkRows];
#pragma unroll
        for (int i = 0; i < kSkRows; ++i)
          w[i] = g + i < g1 ? __ldg(reinterpret_cast<const uint4*>(
                                  packed + (long long)(g + i) * N + n))
                            : make_uint4(0, 0, 0, 0);
#pragma unroll
        for (int i = 0; i < kSkRows; ++i) {
          if (g + i < g1) {
            uint32_t av[MR];
#pragma unroll
            for (int mm = 0; mm < MR; ++mm) {
              av[mm] = m0 + mm < M
                           ? __ldg(a32 + (long long)(m0 + mm) * G + g + i)
                           : 0u;
              cor[mm] = __dp4a(0x01010101, (int)av[mm], cor[mm]);
            }
            const uint32_t ws[4] = {w[i].x, w[i].y, w[i].z, w[i].w};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              uint32_t u[4];
              fields4(ws[q], u);
#pragma unroll
              for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int mm = 0; mm < MR; ++mm)
                  acc[mm][4 * q + j] = dp4a_us(u[j], av[mm],
                                               acc[mm][4 * q + j]);
            }
          }
        }
      }
#pragma unroll
      for (int mm = 0; mm < MR; ++mm)
#pragma unroll
        for (int j = 0; j < 16; ++j)
          atomicAdd(&red[mm][j * 33 + lane], acc[mm][j] - cor[mm]);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < MR * kSkCols; i += kThreads) {
      const int mm = i / kSkCols, col = i % kSkCols;
      if (m0 + mm < M && col0 + col < N)
        atomicAdd(c + (long long)(m0 + mm) * N + col0 + col,
                  red[mm][(col % 16) * 33 + col / 16]);
    }
    __syncthreads();                     // before red is zeroed again
  }
}

// ---------------------------------------------------------------------------
// many rows: TMA + wgmma with the unpack in the kernel (lowbit_sm90.cuh)
// ---------------------------------------------------------------------------

struct TernaryTma {
  static constexpr int kTM = 128, kTN = 256;
  static constexpr int kTK = 128;              // bytes of K a stage
  static constexpr int kA = kTM * kTK;         // A's tile, swizzled
  static constexpr int kRaw = kA + kTK / 4 * kTN;   // + 32 packed rows
  static constexpr int kCvt = kTN * kTK;       // B, n-major, swizzled
  static constexpr int kLdC = kTN + 8;         // staged C row, ints
  static constexpr int kEpi = kTM * kLdC * 4;
  CUtensorMap ma, mp;
  int* c;
  int M, N, K;

  __device__ __forceinline__ int k_tiles() const {
    return (K + kTK - 1) / kTK;
  }

  __device__ __forceinline__ void issue(char* st, uint64_t* bar, int kt,
                                        int m0, int n0) const {
    tl_sm90::tma_load(st, &ma, bar, kt * kTK, m0);
    tl_sm90::tma_load(st + kA, &mp, bar, n0, kt * (kTK / 4));
  }

  struct Acc {
    int d[128];
    __device__ __forceinline__ void zero() {
#pragma unroll
      for (int i = 0; i < 128; ++i) d[i] = 0;
    }
    __device__ __forceinline__ void fence() {
#pragma unroll
      for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i])::"memory");
    }
  };

  // thread t: column quad q = t % 64 (columns 4q..4q+3) and chunks c =
  // t / 64 and c + 4 (16 bytes of K: packed rows 4c..4c+3)
  struct Conv {
    int q, c0;
    uint32_t rot;
    __device__ __forceinline__ Conv(const TernaryTma&, int, int t)
        : q(t % 64), c0(t / 64) {
      const uint32_t r = (q >> 1) & 3;   // byte s of a rotated word:
      rot = r | ((r + 1) & 3) << 4 |     // column (s + r) & 3
            ((r + 2) & 3) << 8 | ((r + 3) & 3) << 12;
    }
    __device__ __forceinline__ void operator()(const char* st, char* cvt,
                                               int) const {
      const char* pk = st + kA;
      const uint32_t r = (q >> 1) & 3;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ch = c0 + 4 * h;
        uint32_t out[4][4];              // [column s][packed row i]
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t w = __byte_perm(
              *reinterpret_cast<const uint32_t*>(pk + (4 * ch + i) * kTN +
                                                 4 * q),
              0, rot);
          uint32_t g[4];
          fields4(w, g);
#pragma unroll
          for (int s = 0; s < 4; ++s)
            out[s][i] = (g[s] + 0x7F7F7F7Fu) ^ 0x80808080u;
        }
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int n = 4 * q + ((s + r) & 3);
          *reinterpret_cast<uint4*>(cvt + n * kTK +
                                    ((ch ^ (n & 7)) << 4)) =
              make_uint4(out[s][0], out[s][1], out[s][2], out[s][3]);
        }
      }
    }
  };

  __device__ __forceinline__ static void mma(Acc& acc, unsigned sa,
                                             unsigned ca, int cw) {
#pragma unroll
    for (int kk = 0; kk < kTK / 32; ++kk)
      tl_lowbit::wgmma_s8_n256(
          acc.d, tl_sm90::kmajor<int8_t, kTK>(sa, cw * 64, kk * 32),
          tl_sm90::kmajor<int8_t, kTK>(ca, 0, kk * 32));
  }

  // the accumulator staged as int32 rows, then each consumer's 64 rows
  // stored 16 bytes a thread (N a multiple of 16: a quad is all in)
  __device__ __forceinline__ void epilogue(Acc& acc, char* buf, int m0,
                                           int n0, int cw) const {
    int* cs = reinterpret_cast<int*>(buf);
    const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
    const int row0 = cw * 64;
#pragma unroll
    for (int j = 0; j < kTN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + 16 * w + lane / 4 + 8 * h;
        *reinterpret_cast<int2*>(cs + r * kLdC + 8 * j + 2 * (lane % 4)) =
            make_int2(acc.d[4 * j + 2 * h], acc.d[4 * j + 2 * h + 1]);
      }
    tl_sm90::named_sync(2 + cw, 128);
    for (int i = t; i < 64 * (kTN / 4); i += 128) {
      const int r = row0 + i / (kTN / 4), n = 4 * (i % (kTN / 4));
      if (m0 + r < M && n0 + n < N)
        *reinterpret_cast<int4*>(c + (long long)(m0 + r) * N + n0 + n) =
            *reinterpret_cast<const int4*>(cs + r * kLdC + n);
    }
  }
};

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// a (M, K) int8, packed (K/4, N) int8 -> c (M, N) int32. Launches on
// `stream` and returns cudaGetLastError() (0 = launched); the Python
// wrapper checks shapes, types, devices, K % 4 == 0 and the grid's range
// before calling.
extern "C" int tl_bitnet_gemm(const void* a, const void* packed, void* c,
                              int M, int N, int K, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int vec_a = aligned(a) && K % 16 == 0;
  const int vec_p = aligned(packed) && N % 16 == 0;
  bitnet_gemm<<<tile_count(M, N), kThreads, 0, s>>>(
      static_cast<const int8_t*>(a), static_cast<const uint8_t*>(packed),
      static_cast<int*>(c), M, N, K, vec_a, vec_p);
  return (int)cudaGetLastError();
}

// The split-K path: a (M, K) int8 (4-byte aligned), packed (K/4, N)
// (16-byte aligned, N a multiple of 16) -> c (M, N) int32, zeroed here
// first; grid (ceil(N / 512), splits), rows_per_block packed rows a
// block, a multiple of 64 (ops/bitnet.py::bitnet_splitk_plan).
extern "C" int tl_bitnet_gemm_splitk(const void* a, const void* packed,
                                     void* c, int M, int N, int K,
                                     int rows_per_block, int splits,
                                     void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t z = cudaMemsetAsync(c, 0, (size_t)M * N * 4, s);
  if (z != cudaSuccess) return (int)z;
  const dim3 grid((N + kSkCols - 1) / kSkCols, splits);
  const auto* a8 = static_cast<const int8_t*>(a);
  const auto* p = static_cast<const uint8_t*>(packed);
  auto* c32 = static_cast<int*>(c);
  if (M == 1)
    bitnet_gemm_splitk<1><<<grid, kThreads, 0, s>>>(a8, p, c32, M, N, K,
                                                    rows_per_block);
  else if (M == 2)
    bitnet_gemm_splitk<2><<<grid, kThreads, 0, s>>>(a8, p, c32, M, N, K,
                                                    rows_per_block);
  else
    bitnet_gemm_splitk<4><<<grid, kThreads, 0, s>>>(a8, p, c32, M, N, K,
                                                    rows_per_block);
  return (int)cudaGetLastError();
}

// The TMA + wgmma path: a (M, K) int8, packed (K/4, N), both 16-byte
// aligned, K and N multiples of 16 -> c (M, N) int32 (16-byte aligned).
// cudaErrorInvalidValue when a tensor map is refused.
extern "C" int tl_bitnet_gemm_wgmma(const void* a, const void* packed,
                                    void* c, int M, int N, int K,
                                    void* stream) {
  TernaryTma p;
  const bool ok =
      tl_lowbit::make_map_bytes(&p.ma, a, M, K, K, TernaryTma::kTK,
                                TernaryTma::kTM, true) &&
      tl_lowbit::make_map_bytes(&p.mp, packed, K / 4, N, N, TernaryTma::kTN,
                                TernaryTma::kTK / 4, false);
  if (!ok) return (int)cudaErrorInvalidValue;
  p.c = static_cast<int*>(c);
  p.M = M;
  p.N = N;
  p.K = K;
  return tl_lowbit::launch_cvt(p, static_cast<cudaStream_t>(stream));
}
