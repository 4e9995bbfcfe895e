"""Block-sparse multi-head attention on the card.

Counterpart of ``tilelang_mesh_tpu/ops/blocksparse_attention.py``. One
CUDA kernel (``csrc/blocksparse_attention.cu``) replaces the TPU's:

* ``blocksparse_mha`` — ``blocksparse_mha_kernel``: attention where an
  int32 mask over (query block, key block) cells, in the caller's blocks
  of ``block_M`` queries by ``block_N`` keys, says which pairs may
  attend (nonzero = live); ``causal`` adds the elementwise top-left
  mask. The kernel skips key tiles that overlap no live cell; a row
  whose every cell is dead gives exactly 0 (``l > 0 ? acc / l : 0``).
  float32 runs ``blocksparse_mha`` on CUDA cores, bfloat16 and float16
  ``blocksparse_mha_mma`` on the tensor cores at the tile
  ``blocksparse_tile(D, block_M, block_N, causal)``.

The wrapper launches the kernel on CUDA tensors (a build or launch
failure raises; there is no fallback to another kernel) and runs its
plain version (dense exp2 scores under the cell mask, rounded where the
kernel rounds) on CPU tensors.
``blocksparse_reference`` is the JAX package's dense reference.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..resilience.errors import KernelLaunchError
from .flash_attention import _LOG2E, causal_mask, check_attention_args
from ._factory import bind
from .gemm import DTYPE_CODES, _as_dtype

__all__ = ["blocksparse_attention", "blocksparse_reference",
           "blocksparse_mha", "blocksparse_mha_plain",
           "blocksparse_mha_kernel", "dense_mask", "mask_tile",
           "blocksparse_tile",
           "BLOCKSPARSE_TILES", "launches", "reset_launches"]

# kernel name -> launches through its wrapper (both kernels of the source:
# blocksparse_mha for float32, blocksparse_mha_mma for bfloat16, float16)
launches = {"blocksparse_mha": 0}

# the tensor-core kernel's (block_M, block_N) instances by head_dim, in
# order of preference without and with the causal mask:
# csrc/attention_mma.cuh's mask_tiles (the carver.FLASH_KERNEL_TILES with
# block_N 64: a row's mask is one 64-bit word), ordered by timing each
# (scripts/sparse_attn_ab.py; PERF.md, #31: at D 128, 128 x 64 leads
# without causal, 64 x 64 with)
BLOCKSPARSE_TILES = {
    16: (((64, 64),),) * 2, 32: (((64, 64),),) * 2,
    64: (((128, 64), (64, 64)),) * 2,
    128: (((128, 64), (64, 64)), ((64, 64), (128, 64)))}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def dense_mask(block_mask, block_M: int, block_N: int,
               causal: bool) -> torch.Tensor:
    """(B, H, Sq, Sk) bool: each pair's cell is live and, causal, j <= i."""
    dense = (block_mask != 0).repeat_interleave(block_M, dim=2) \
        .repeat_interleave(block_N, dim=3)
    if causal:
        dense &= causal_mask(dense.shape[-2], dense.shape[-1], dense.device)
    return dense


def _check(q, k, v, block_mask, block_M, block_N):
    check_attention_args(q, k, v)
    B, H, Sq, _ = q.shape
    Sk = k.shape[2]
    if block_M < 1 or block_N < 1 or Sq % block_M or Sk % block_N:
        raise ValueError(
            f"blocksparse_attention needs Sq % block_M == 0 and "
            f"Sk % block_N == 0, got Sq={Sq}, Sk={Sk}, block_M={block_M}, "
            f"block_N={block_N}")
    expect = (B, H, Sq // block_M, Sk // block_N)
    if tuple(block_mask.shape) != expect:
        raise ValueError(f"block_mask shape {tuple(block_mask.shape)} does "
                         f"not match grid {expect}")
    if block_mask.device != q.device:
        raise ValueError(f"block_mask on {block_mask.device}, q on "
                         f"{q.device}")


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def blocksparse_mha_plain(q, k, v, block_mask, block_M: int, block_N: int,
                          causal: bool, sm_scale: float) -> torch.Tensor:
    """Plain version of the kernel: dense scores ``float(q k^T) *
    sm_scale * log2(e)`` masked to -inf off the live cells (and above the
    diagonal, causal), ``m = max(rowmax, -1e30)``, ``p = exp2(s - m)``,
    ``acc = dtype(p) @ v`` in float32, ``l > 0 ? acc / l : 0`` in q's
    type."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s.mul_(float(sm_scale) * _LOG2E)
    s.masked_fill_(~dense_mask(block_mask, block_M, block_N, causal),
                   -math.inf)
    m = s.amax(dim=-1).clamp_min_(-1e30)
    p = torch.exp2_(s.sub_(m[..., None]))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(q.dtype).float(), v.float())
    return torch.where(l > 0, acc / l, 0.0).to(q.dtype)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------


def mask_tile(tiles, block_M: int, block_N: int):
    """The tile ``(TM, TN)`` among ``tiles`` (in order of preference) for
    the caller's cells: the first whose TM divides ``block_M`` and TN
    divides ``block_N`` (a tile then lies in one cell, and only the
    diagonal and the ragged edge are masked), else the first whose TN
    divides ``block_N``, else the first whose TM divides ``block_M``,
    else the first."""
    for fits in (lambda tm, tn: block_M % tm == 0 and block_N % tn == 0,
                 lambda tm, tn: block_N % tn == 0,
                 lambda tm, tn: block_M % tm == 0):
        for tm, tn in tiles:
            if fits(tm, tn):
                return tm, tn
    return tiles[0]


def blocksparse_tile(D: int, block_M: int, block_N: int, causal: bool):
    """The tensor-core kernel's tile ``(TM, TN)`` for head_dim ``D``, the
    caller's cells and the causal flag: ``mask_tile`` over
    ``BLOCKSPARSE_TILES``; ``None`` for a head_dim without an instance."""
    tiles = BLOCKSPARSE_TILES.get(int(D))
    return None if tiles is None else mask_tile(tiles[bool(causal)],
                                                block_M, block_N)


def _launch(q, k, v, block_mask, block_M, block_N, causal, sm_scale):
    from ._build import aligned16, load, stream_call
    q, k, v = aligned16(q, k, v)
    mask = block_mask.to(torch.int32).contiguous()
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    o = torch.empty_like(q)
    tile = (0, 0)
    if q.dtype != torch.float32:
        tile = blocksparse_tile(D, block_M, block_N, causal) or (0, 0)
    fn = load("blocksparse_attention").tl_blocksparse_mha_tiled
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                   + [ctypes.c_float] + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    code = stream_call(fn, q.device, q.data_ptr(), k.data_ptr(),
                       v.data_ptr(), mask.data_ptr(), o.data_ptr(), B, H, Sq,
                       Sk, D, block_M, block_N,
                       DTYPE_CODES[q.dtype], int(bool(causal)),
                       float(sm_scale) * _LOG2E, *tile)
    if code != 0:
        raise KernelLaunchError("blocksparse_mha", code)
    launches["blocksparse_mha"] += 1
    return o


def blocksparse_mha(q, k, v, block_mask, block_M: int, block_N: int,
                    causal: bool, sm_scale: float) -> torch.Tensor:
    """Block-sparse attention output ``(B, H, Sq, D)`` in q's type. CUDA
    tensors launch the kernel; CPU tensors run the plain version."""
    _check(q, k, v, block_mask, block_M, block_N)
    if q.is_cuda:
        return _launch(q, k, v, block_mask, block_M, block_N, causal,
                       sm_scale)
    return blocksparse_mha_plain(q, k, v, block_mask, block_M, block_N,
                                 causal, sm_scale)


def blocksparse_mha_kernel(B, H, Sq, Sk, D, block_M, block_N, sm_scale,
                           dtype, num_stages=2, causal=False):
    """The kernel bound to one shape (the JAX factory's arguments):
    ``fn(q, k, v, block_mask) -> o``."""
    return bind("blocksparse_mha_kernel",
                [((B, H, Sq, D), _as_dtype(dtype)), ((B, H, Sk, D), None),
                 ((B, H, Sk, D), None),
                 ((B, H, Sq // block_M, Sk // block_N), None)],
                lambda q, k, v, block_mask: blocksparse_mha(
                    q, k, v, block_mask, block_M, block_N, bool(causal),
                    float(sm_scale)))


def blocksparse_attention(q, k, v, block_mask, sm_scale=None, block_M=128,
                          block_N=128, causal=False) -> torch.Tensor:
    """block_mask (B, H, Sq // block_M, Sk // block_N) int32, nonzero =
    attend (blocks clamped to Sq, Sk first); ``causal=True`` also applies
    the elementwise causal mask (the seer-attention configuration)."""
    Sq, D = q.shape[2], q.shape[3]
    Sk = k.shape[2]
    block_M, block_N = min(block_M, Sq), min(block_N, Sk)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    return blocksparse_mha(q, k, v, block_mask, block_M, block_N,
                           bool(causal), float(sm_scale))


def blocksparse_reference(q, k, v, block_mask, block_M, block_N,
                          sm_scale=None, causal=False) -> torch.Tensor:
    """The JAX package's dense reference: a natural-exp softmax in
    float32 over the live pairs, rows with none 0, ``dtype(p) @ v``."""
    D = q.shape[3]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    s = s.masked_fill(~dense_mask(block_mask, block_M, block_N, causal),
                      -math.inf)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(torch.isfinite(m), torch.exp(s - m), 0.0)
    denom = p.sum(dim=-1, keepdim=True)
    p = torch.where(denom > 0, p / denom, 0.0)
    return torch.matmul(p.to(q.dtype).float(), v.float()).to(q.dtype)
