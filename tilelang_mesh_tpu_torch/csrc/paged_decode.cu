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
// Bound: bytes (see split_kv_decode.cuh, which holds the loop this
// kernel shares with decode.cu). The grid is the TPU grid (H, n_split,
// B), one block per (h, split, b). The TPU kernel DMAs a whole page into
// VMEM and runs a 1xPS matrix product; here each warp streams the rows of
// a page straight into registers (a page's PS*D rows are contiguous in
// the H-major pool, so neighbouring lanes read neighbouring addresses).
// The block reads its own page ids; there is no scalar prefetch.

#include "split_kv_decode.cuh"

namespace {

// row t of split s of (b, h): token t % PS of page Tab[b, s*pps + t/PS]
struct PagedRows {
  const int* tab;
  long long rows;   // pool rows per head
  int PP, PS, pps, D;
  struct Cursor {
    const int* pages;   // this split's page ids
    long long head;     // first pool row of head h
    int PS, chunks;     // 16-byte chunks per row
    __device__ __forceinline__ long long operator()(int t) const {
      return (head + (long long)__ldg(pages + t / PS) * PS + t % PS) * chunks;
    }
  };
  __device__ __forceinline__ Cursor cursor(int b, int h, int s,
                                           int vec) const {
    return {tab + (long long)b * PP + (long long)s * pps,
            (long long)h * rows, PS, D / vec};
  }
};

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// Returns cudaErrorInvalidValue for a head_dim without an instance;
// the Python wrapper checks shapes before calling.
extern "C" int tl_paged_decode(const void* q, const void* kp, const void* vp,
                               const void* tab, void* op, void* mp, void* lp,
                               int B, int H, int PP, int PS, int D,
                               int n_split, long long rows, int dt,
                               float scale, void* stream) {
  const int pps = PP / n_split;
  const PagedRows walk{static_cast<const int*>(tab), rows, PP, PS, pps, D};
  return tl_splitkv::launch(q, kp, vp, op, mp, lp, B, H, D, n_split,
                            pps * PS, dt, scale, walk,
                            static_cast<cudaStream_t>(stream));
}
