"""Flash decoding on the card: single-token attention against a long KV
cache with split-KV parallel reduction.

Counterpart of ``tilelang_mesh_tpu/ops/flash_decoding.py``. Two CUDA
kernels replace the TPU's, both built on the split-KV loop of
``csrc/split_kv_decode.cuh``; each emits per-split partials ``(o, m, l)``
in the exp2 domain (scores scaled by ``sm_scale * log2(e)``), and
``_combine_splits`` merges them with torch ops, as the JAX package left
the merge to XLA:

* ``decode_partials`` (``csrc/decode.cu``, the TPU's ``decode_kernel``):
  contiguous ``K/V (B, H, S, D)``, behind ``flash_decode`` and the
  GATHER strategy for paged KV, ``flash_decode_paged`` (pages gathered
  to contiguous form with torch indexing first). ``decode_path`` picks
  its kernel by the K/V type: float32 runs the split-KV loop,
  bfloat16 and float16 ``decode_tma`` (TMA loads of K/V tiles through
  a ring of shared-memory stages);
* ``paged_decode_partials`` (``csrc/paged_decode.cu``, the TPU's
  ``paged_decode_kernel``): the in-kernel page walk over an H-major
  pool, behind ``flash_decode_paged_pool``, with no gather pass.

Each wrapper launches its kernel on a CUDA tensor (a build or launch
failure raises) and runs its plain version (``*_plain``: gather plus
dense softmax in f32) on a CPU tensor; the tests and ``chip_smoke.py``
hold the kernels against them.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..resilience.errors import KernelLaunchError
from .gemm import DTYPE_CODES
from ._factory import bind
from .gemm import _as_dtype

# K / V types the decode kernels take
_DTYPES = (torch.float32, torch.bfloat16, torch.float16)

__all__ = ["decode_partials", "decode_partials_plain", "flash_decode",
           "flash_decode_paged", "pages_to_hmajor", "clamp_splits",
           "merge_splits",
           "paged_decode_partials", "paged_decode_partials_plain",
           "flash_decode_paged_pool", "launches", "kernel_launches",
           "reset_launches", "decode_path", "KERNEL_HEAD_DIMS",
           "decode_kernel", "paged_decode_kernel"]

_LOG2E = 1.44269504

# head_dim values csrc/decode.cu and csrc/paged_decode.cu instantiate
KERNEL_HEAD_DIMS = (64, 128, 256)

# kernel name -> launches through its wrapper (chip_smoke.py zeroes and
# reads these around a run to prove the path used the kernel)
launches = {"decode": 0, "paged_decode": 0}
# the "decode" launches by the kernel decode_path picked
kernel_launches = {"split_kv_decode": 0, "decode_tma": 0}


def reset_launches() -> None:
    for d in (launches, kernel_launches):
        for k in d:
            d[k] = 0


def decode_path(dtype) -> str:
    """The kernel of ``decode_partials`` on K/V of ``dtype``:
    ``split_kv_decode`` (the loop, float32) or ``decode_tma`` (bfloat16,
    float16)."""
    if dtype not in _DTYPES:
        raise TypeError(f"decode takes float32, bfloat16 or float16 K/V, "
                        f"got {dtype}")
    return "split_kv_decode" if dtype == torch.float32 else "decode_tma"


def _split_rows(page_table: torch.Tensor, page_size: int, n_split: int):
    """(B, ns, pps*PS) pool row ids of each split, in token order."""
    B, PP = page_table.shape
    pps = PP // n_split
    offs = torch.arange(page_size, device=page_table.device)
    rows = (page_table.long().reshape(B, n_split, pps, 1) * page_size
            + offs).reshape(B, n_split, pps * page_size)
    return rows


def paged_decode_partials_plain(q, kp, vp, page_table, page_size: int,
                                n_split: int, sm_scale: float):
    """Plain PyTorch version of the kernel: gather each split's rows,
    dense softmax in f32. Returns ``(op (B,ns,H,D), mp (B,ns,H,1),
    lp (B,ns,H,1))``, all float32."""
    B, H, _, D = q.shape
    scale = float(sm_scale) * _LOG2E
    rows = _split_rows(page_table, int(page_size), n_split)     # (B,ns,n)
    k = kp[:, rows].float()                          # (H, B, ns, n, D)
    v = vp[:, rows].float()
    qf = q.reshape(B, H, D).float()
    s = torch.einsum("bhd,hbsnd->bshn", qf, k) * scale   # (B, ns, H, n)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    lsum = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bshn,hbsnd->bshd", p, v)
    return o, m, lsum


def _check(q, kp, vp, page_table, page_size, n_split):
    B, H, one, D = q.shape
    if one != 1:
        raise ValueError(f"q must be (B, H, 1, D), got {tuple(q.shape)}")
    if kp.shape != vp.shape or kp.dim() != 3 or kp.shape[0] != H \
            or kp.shape[2] != D:
        raise ValueError(f"pools must be (H={H}, rows, D={D}), got "
                         f"{tuple(kp.shape)} / {tuple(vp.shape)}")
    if kp.dtype != vp.dtype or kp.dtype not in _DTYPES:
        raise TypeError(f"pools must share float32, bfloat16 or float16, got "
                        f"{kp.dtype} / {vp.dtype}")
    if page_table.dim() != 2 or page_table.shape[0] != B:
        raise ValueError(f"page_table must be (B={B}, PP), got "
                         f"{tuple(page_table.shape)}")
    PP = page_table.shape[1]
    if n_split < 1 or PP % n_split:
        raise ValueError(f"n_split={n_split} must divide PP={PP}")
    if kp.shape[1] % page_size:
        raise ValueError(f"pool rows {kp.shape[1]} not a multiple of "
                         f"page_size {page_size}")
    devs = {t.device for t in (q, kp, vp, page_table)}
    if len(devs) != 1:
        raise ValueError(f"q, pools and page_table must share a device, "
                         f"got {sorted(map(str, devs))}")


def _launch(q, kp, vp, page_table, page_size, n_split, sm_scale):
    from ._build import load
    B, H, _, D = q.shape
    PP = page_table.shape[1]
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"paged_decode kernel has no head_dim={D} "
                         f"instance (built: {KERNEL_HEAD_DIMS})")
    if not (kp.is_contiguous() and vp.is_contiguous()):
        raise ValueError("pools must be contiguous")
    for t in (kp, vp):
        if t.data_ptr() % 16:
            raise ValueError("pools must be 16-byte aligned")
    qf = q.reshape(B, H, D).to(torch.float32).contiguous()
    tab = page_table.to(torch.int32).contiguous()
    dev = kp.device
    op = torch.empty((B, n_split, H, D), dtype=torch.float32, device=dev)
    mp = torch.empty((B, n_split, H, 1), dtype=torch.float32, device=dev)
    lp = torch.empty((B, n_split, H, 1), dtype=torch.float32, device=dev)
    lib = load("paged_decode")
    fn = lib.tl_paged_decode
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    # the launch targets the pools' card even from a thread whose
    # current device is another one (the engine's step watchdog thread)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(qf.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                  tab.data_ptr(), op.data_ptr(), mp.data_ptr(),
                  lp.data_ptr(), B, H, PP, int(page_size), D, n_split,
                  kp.shape[1], DTYPE_CODES[kp.dtype],
                  float(sm_scale) * _LOG2E, stream)
    if code != 0:
        raise KernelLaunchError("paged_decode", code, site="serve.step")
    launches["paged_decode"] += 1
    return op, mp, lp


def paged_decode_partials(q, kp, vp, page_table, page_size: int,
                          n_split: int, sm_scale: float):
    """Split-KV partials ``(op, mp, lp)`` of single-token attention over
    the H-major pools ``kp``/``vp`` ``(H, rows, D)``, walked by
    ``page_table (B, PP)``. CUDA tensors launch the kernel; CPU tensors
    run the plain version."""
    _check(q, kp, vp, page_table, int(page_size), int(n_split))
    if kp.device.type == "cuda":
        return _launch(q, kp, vp, page_table, int(page_size),
                       int(n_split), sm_scale)
    if kp.device.type != "cpu":
        raise ValueError(f"unsupported device {kp.device}")
    return paged_decode_partials_plain(q, kp, vp, page_table,
                                       int(page_size), int(n_split),
                                       sm_scale)


def merge_splits(op, mp, lp) -> torch.Tensor:
    """Merge per-split partials ``op (B,ns,H,D)``, ``mp, lp (B,ns,H)`` in
    the exp2 domain: (B, H, D) float32 (flash decoding's and MLA's
    combine)."""
    m_max = mp.amax(dim=1, keepdim=True)                    # (B,1,H)
    alpha = torch.exp2(mp - m_max)                          # (B,ns,H)
    l_tot = (lp * alpha).sum(dim=1)                         # (B,H)
    o = (op * alpha[..., None]).sum(dim=1)                  # (B,H,D)
    return o / l_tot[..., None]


def _combine_splits(q, op, mp, lp):
    """Merge the (B,ns,H,1)-stat partials into (B, H, 1, D) in q's type."""
    return merge_splits(op, mp[..., 0], lp[..., 0])[:, :, None].to(q.dtype)


def flash_decode_paged_pool(q, kp, vp, page_table, page_size,
                            sm_scale=None, n_split=None):
    """In-kernel page walk over an H-major pool (H, rows, D):
    q (B, H, 1, D) -> (B, H, 1, D) in q's dtype."""
    B, H, _, D = q.shape
    PP = page_table.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    if n_split is None:
        n_split = max(1, min(8, PP))
    while PP % n_split:
        n_split -= 1
    op, mp, lp = paged_decode_partials(q, kp, vp, page_table, page_size,
                                       n_split, sm_scale)
    return _combine_splits(q, op, mp, lp)


# ---------------------------------------------------------------------------
# contiguous K/V: decode_kernel's counterpart, and the gather strategy
# ---------------------------------------------------------------------------


def clamp_splits(S: int, n_split, block_N: int):
    """``(n_split, block_N)`` as the JAX package's ``flash_decode`` and
    ``mla_decode`` pick them: at most 8 splits of ``block_N``-row tiles,
    lowered until the splits divide ``S`` and the tile divides a split.
    The partials' shape depends on it; the CUDA kernels pick their own
    tiles."""
    if n_split is None:
        n_split = max(1, min(8, S // max(block_N, 1)))
    while S % n_split or (S // n_split) % min(block_N, S // n_split):
        n_split -= 1
    return n_split, min(block_N, S // n_split)


def decode_partials_plain(q, k, v, n_split: int, sm_scale: float):
    """Plain PyTorch version of the contiguous kernel: dense softmax in
    f32 over each split's keys. Returns ``(op (B,ns,H,D), mp (B,ns,H,1),
    lp (B,ns,H,1))``, all float32."""
    B, H, _, D = q.shape
    S = k.shape[2]
    n = S // n_split
    s = torch.einsum("bhd,bhsd->bhs", q.reshape(B, H, D).float(),
                     k.float()) * (float(sm_scale) * _LOG2E)
    s = s.reshape(B, H, n_split, n).transpose(1, 2)       # (B, ns, H, n)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    lsum = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bshn,bhsnd->bshd", p,
                     v.float().reshape(B, H, n_split, n, D))
    return o, m, lsum


def _check_contiguous(q, k, v, n_split):
    B, H, one, D = q.shape
    if one != 1:
        raise ValueError(f"q must be (B, H, 1, D), got {tuple(q.shape)}")
    if k.shape != v.shape or k.dim() != 4 or tuple(k.shape[:2]) != (B, H) \
            or k.shape[3] != D or k.shape[2] < 1:
        raise ValueError(f"k, v must be (B={B}, H={H}, S, D={D}), got "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    if k.dtype != v.dtype or k.dtype not in _DTYPES:
        raise TypeError(f"k, v must share float32, bfloat16 or float16, got "
                        f"{k.dtype} / {v.dtype}")
    S = k.shape[2]
    if n_split < 1 or S % n_split:
        raise ValueError(f"n_split={n_split} must divide S={S}")
    devs = {t.device for t in (q, k, v)}
    if len(devs) != 1:
        raise ValueError(f"q, k, v must share a device, got "
                         f"{sorted(map(str, devs))}")


def _launch_contiguous(q, k, v, n_split, sm_scale):
    from ._build import load
    B, H, _, D = q.shape
    S = k.shape[2]
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"decode kernel has no head_dim={D} instance "
                         f"(built: {KERNEL_HEAD_DIMS})")
    path = decode_path(k.dtype)
    # a tensor map takes no zero stride: a broadcast view is copied
    if k.stride() != v.stride() or k.stride(3) != 1 or (
            path == "decode_tma" and 0 in k.stride()[:3]):
        k, v = k.contiguous(), v.contiguous()
    vec = 16 // k.element_size()
    if any(st % vec for st in k.stride()[:3]) or k.data_ptr() % 16 \
            or v.data_ptr() % 16:
        raise ValueError(f"k, v rows must be 16-byte aligned (strides "
                         f"{k.stride()})")
    qf = q.reshape(B, H, D).to(torch.float32).contiguous()
    dev = k.device
    op = torch.empty((B, n_split, H, D), dtype=torch.float32, device=dev)
    mp = torch.empty((B, n_split, H, 1), dtype=torch.float32, device=dev)
    lp = torch.empty((B, n_split, H, 1), dtype=torch.float32, device=dev)
    lib = load("decode")
    tma = path == "decode_tma"
    fn = lib.tl_decode_tma if tma else lib.tl_decode
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 3
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(qf.data_ptr(), k.data_ptr(), v.data_ptr(), op.data_ptr(),
                  mp.data_ptr(), lp.data_ptr(), B, H, S, D, n_split,
                  k.stride(0), k.stride(1), k.stride(2),
                  DTYPE_CODES[k.dtype], float(sm_scale) * _LOG2E,
                  stream)
    if code != 0:
        raise KernelLaunchError("decode", code)
    launches["decode"] += 1
    kernel_launches[path] += 1
    return op, mp, lp


def decode_partials(q, k, v, n_split: int, sm_scale: float):
    """Split-KV partials ``(op, mp, lp)`` of single-token attention over
    ``k, v (B, H, S, D)`` (any batch, head and row strides; D
    contiguous). CUDA tensors launch the kernel; CPU tensors run the
    plain version."""
    _check_contiguous(q, k, v, int(n_split))
    if k.device.type == "cuda":
        return _launch_contiguous(q, k, v, int(n_split), sm_scale)
    if k.device.type != "cpu":
        raise ValueError(f"unsupported device {k.device}")
    return decode_partials_plain(q, k, v, int(n_split), sm_scale)


def flash_decode(q, k, v, sm_scale=None, n_split=None, block_N=128):
    """q (B, H, 1, D); k/v (B, H, S, D) -> (B, H, 1, D) in q's type."""
    D = q.shape[-1]
    S = k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    n_split, _ = clamp_splits(S, n_split, block_N)
    op, mp, lp = decode_partials(q, k, v, n_split, sm_scale)
    return _combine_splits(q, op, mp, lp)


def pages_to_hmajor(pages: torch.Tensor) -> torch.Tensor:
    """(n_pages, page_size, H, D) -> the H-major pool layout
    (H, n_pages*page_size, D) that the in-kernel page walk wants."""
    n_pages, ps, H, D = pages.shape
    return pages.permute(2, 0, 1, 3).reshape(H, n_pages * ps, D).contiguous()


def flash_decode_paged(q, kv_pages, v_pages, page_table, sm_scale=None,
                       block_N=128, n_split=None):
    """Paged KV decode, GATHER strategy: pages (n_pages, page_size, H, D)
    and page_table (B, pages_per_seq) gathered to contiguous KV on the
    pages' device, then the contiguous split-KV kernel on the transposed
    view (no second copy). The alternative is ``flash_decode_paged_pool``,
    which walks an H-major pool in the kernel with no gather pass."""
    B, PP = page_table.shape
    n_pages, page_size, H, D = kv_pages.shape
    idx = page_table.to(device=kv_pages.device, dtype=torch.long)
    S = PP * page_size
    k = kv_pages[idx].reshape(B, S, H, D).transpose(1, 2)
    v = v_pages[idx].reshape(B, S, H, D).transpose(1, 2)
    return flash_decode(q, k, v, sm_scale=sm_scale, block_N=block_N,
                        n_split=n_split)


def decode_kernel(B, H, S, D, n_split, block_N, sm_scale, dtype,
                  num_stages=2):
    """The contiguous split-KV kernel bound to one shape (the JAX
    factory's arguments): ``fn(q (B, H, 1, D), k, v (B, H, S, D)) ->
    (op (B, ns, H, D), mp, lp (B, ns, H, 1))`` float32 partials."""
    dt = _as_dtype(dtype)
    return bind("decode_kernel", [((B, H, 1, D), dt), ((B, H, S, D), dt),
                                  ((B, H, S, D), dt)],
                lambda q, k, v: decode_partials(q, k, v, n_split, sm_scale))


def paged_decode_kernel(B, H, PP, PS, D, n_split, rows, sm_scale, dtype):
    """The page-walking kernel bound to one shape (the JAX factory's
    arguments): ``fn(q (B, H, 1, D), kp, vp (H, rows, D), tab (B, PP)
    int32) -> (op (B, ns, H, D), mp, lp (B, ns, H, 1))`` float32
    partials. The table may be a numpy array."""
    dt = _as_dtype(dtype)

    def op(q, kp, vp, tab):
        tab = torch.as_tensor(tab, dtype=torch.int32, device=kp.device)
        return paged_decode_partials(q, kp, vp, tab, PS, n_split, sm_scale)

    return bind("paged_decode_kernel",
                [((B, H, 1, D), dt), ((H, rows, D), dt), ((H, rows, D), dt),
                 ((B, PP), None)], op)
