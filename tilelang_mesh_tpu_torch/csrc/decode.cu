// Split-KV decode over contiguous K/V rows, for Hopper (sm_90a).
//
// Replaces the TPU kernel tilelang_mesh_tpu/ops/flash_decoding.py ::
// decode_kernel. Same contract:
//   Q   (B, H, D)        float32 (the wrapper flattens (B, H, 1, D))
//   K   (B, H, S, D)     float32 or bfloat16, D contiguous; batch, head
//                        and row strides are arguments, so the gather
//                        strategy's transposed view needs no copy
//   V   (B, H, S, D)     same type and strides as K
//   Op  (B, ns, H, D)    float32 unnormalised sum of p * v
//   Mp  (B, ns, H)       float32 running max of the scores, exp2 domain
//   Lp  (B, ns, H)       float32 sum of exp2(score - Mp)
// with score = (q . k) * sm_scale * log2(e), split s covering the keys
// [s*chunk, (s+1)*chunk), chunk = S / ns.
//
// Bound: bytes, as the paged kernel: K and V read once. This is the
// paged kernel's loop (split_kv_decode.cuh) with the page walk replaced
// by strides; the TPU kernel's block_N tiling does not apply (each warp
// streams rows as they come, so any chunk length works).

#include "split_kv_decode.cuh"

namespace {

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

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// Returns cudaErrorInvalidValue for a head_dim without an instance;
// the Python wrapper checks shapes and strides before calling.
extern "C" int tl_decode(const void* q, const void* k, const void* v,
                         void* op, void* mp, void* lp, int B, int H, int S,
                         int D, int n_split, long long sb, long long sh,
                         long long sr, int dt, float scale, void* stream) {
  const int chunk = S / n_split;
  const StridedRows rows{sb, sh, sr, chunk};
  return tl_splitkv::launch(q, k, v, op, mp, lp, B, H, D, n_split, chunk,
                            dt, scale, rows,
                            static_cast<cudaStream_t>(stream));
}
