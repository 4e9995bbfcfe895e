"""Flash decoding over an H-major paged KV pool, on the card.

Counterpart of ``tilelang_mesh_tpu/ops/flash_decoding.py``'s in-kernel
page walk (``flash_decode_paged_pool``). The split-KV kernel
(``csrc/paged_decode.cu``) emits per-split partials ``(o, m, l)`` in the
exp2 domain (scores scaled by ``sm_scale * log2(e)``); ``_combine_splits``
merges them with torch ops, as the JAX package left the merge to XLA.

``paged_decode_partials`` is the wrapper: a CUDA tensor always launches
the kernel (a build or launch failure raises), a CPU tensor takes
``paged_decode_partials_plain``, the gather-plus-dense-softmax version
of the same function that the tests and ``chip_smoke.py`` hold the
kernel against.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..resilience.errors import KernelLaunchError

__all__ = ["paged_decode_partials", "paged_decode_partials_plain",
           "flash_decode_paged_pool", "launches", "reset_launches",
           "KERNEL_HEAD_DIMS"]

_LOG2E = 1.44269504

# head_dim values csrc/paged_decode.cu instantiates
KERNEL_HEAD_DIMS = (64, 128, 256)

# kernel name -> launches through its wrapper (chip_smoke.py zeroes and
# reads these around the serving run to prove the path used the kernel)
launches = {"paged_decode": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


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
    if kp.dtype != vp.dtype or kp.dtype not in (torch.float32,
                                                torch.bfloat16):
        raise TypeError(f"pools must share float32 or bfloat16, got "
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
                  kp.shape[1], int(kp.dtype == torch.bfloat16),
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


def _combine_splits(q, op, mp, lp):
    """Merge per-split (o, m, l) partials in the exp2 domain."""
    mp = mp[..., 0]                                         # (B,ns,H)
    lp = lp[..., 0]
    m_max = mp.amax(dim=1, keepdim=True)                    # (B,1,H)
    alpha = torch.exp2(mp - m_max)                          # (B,ns,H)
    l_tot = (lp * alpha).sum(dim=1)[..., None]              # (B,H,1)
    o = (op * alpha[..., None]).sum(dim=1)                  # (B,H,D)
    return (o / l_tot)[:, :, None, :].to(q.dtype)


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
