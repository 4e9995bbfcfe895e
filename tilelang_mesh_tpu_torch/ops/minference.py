"""MInference vertical-slash sparse attention on the card.

Counterpart of ``tilelang_mesh_tpu/ops/minference.py``: causal attention
restricted to a per-head set of "vertical" key columns ``v_idx`` and a
per-head set of "slash" diagonals ``s_idx``, where a slash ``s`` makes
key ``j`` visible to query ``i`` when ``i - j == s`` (0 is the main
diagonal). One CUDA kernel (``csrc/minference.cu``) replaces the TPU's:

* ``vs_sparse`` — ``vs_sparse_kernel``: a pair (i, j) is visible when
  its (query block, key block) cell of ``block_mask`` is live, ``j <=
  i``, and ``vmask[j]`` or ``dmask[i - j]``; a row that sees nothing
  gives exactly 0 (``l > 0 ? acc / l : 0``). float32 runs ``vs_sparse``
  on CUDA cores, bfloat16 and float16 ``vs_sparse_mma`` on the tensor
  cores at the tile ``vs_tile(D, block_M, block_N)``.

The TPU kernel compares every pair of a live tile with all ``Ns``
slashes. Here the wrapper scatters ``s_idx`` once into the per-head
diagonal mask ``dmask (B, H, Sq)``, so a pair costs one lookup: the same
function, since a slash below 0 or at Sq or past it never matches.
``_build_masks`` gives the JAX package's ``vmask`` and ``block_mask``
integer for integer, by scatters and per-slash block bands (prefix sums
of the diagonal mask over each tile's range of ``i - j``) instead of the
JAX ``(B, H, nQ, nK, Ns)`` comparison, which at 32 heads of 16384
queries and 6096 slashes would hold 1.3e10 elements.

The wrapper launches the kernel on CUDA tensors (a build or launch
failure raises; there is no fallback to another kernel) and runs its plain version on CPU tensors: dense exp2
scores a block of query rows at a time, rounded where the kernel
rounds, so no call holds a ``(B, H, Sq, Sk)`` score tensor.
``vs_sparse_reference`` is the JAX package's dense reference.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ..resilience.errors import KernelLaunchError
from ._factory import bind
from .blocksparse_attention import mask_tile
from .flash_attention import _LOG2E, check_attention_args
from .gemm import DTYPE_CODES, _as_dtype

__all__ = ["vertical_slash_sparse_attention", "vs_sparse_reference",
           "vs_sparse", "vs_sparse_plain", "vs_sparse_kernel",
           "diagonal_mask", "vs_tile", "VS_TILES", "launches",
           "reset_launches"]

# kernel name -> launches through its wrapper (both kernels of the source:
# vs_sparse for float32, vs_sparse_mma for bfloat16 and float16)
launches = {"vs_sparse": 0}

# the tensor-core kernel's (block_M, block_N) instances by head_dim, in
# order of preference: csrc/attention_mma.cuh's mask_tiles (the
# carver.FLASH_KERNEL_TILES with block_N 64: a row's mask is one 64-bit
# word), ordered by timing each (scripts/sparse_attn_ab.py; PERF.md, #32:
# at D 128, 64 x 64 leads)
VS_TILES = {16: ((64, 64),), 32: ((64, 64),), 64: ((128, 64), (64, 64)),
            128: ((64, 64), (128, 64))}

# query rows a plain-version step scores at once
PLAIN_ROWS = 512


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _scatter_ones(idx, lo: int, n: int) -> torch.Tensor:
    """(B, H, n) int32: 1 at ``idx - lo`` for the entries of ``idx (B, H,
    m)`` in [lo, lo + n), 0 elsewhere."""
    i = idx.long() - lo
    i = torch.where((i >= 0) & (i < n), i, n)        # out of range -> slot n
    out = torch.zeros((*idx.shape[:2], n + 1), dtype=torch.int32,
                      device=idx.device)
    return out.scatter_(2, i, 1)[..., :n]


def diagonal_mask(s_idx, Sq: int) -> torch.Tensor:
    """(B, H, Sq) int32: 1 at the slashes ``s_idx`` in [0, Sq), the only
    ones a causal pair can match."""
    return _scatter_ones(s_idx, 0, Sq)


def _build_masks(v_idx, s_idx, Sq: int, Sk: int, block_M: int,
                 block_N: int):
    """``(vmask (B, H, Sk), block_mask (B, H, Sq // block_M, Sk //
    block_N))`` int32, integer for integer the JAX package's:
    ``vmask`` marks the columns ``v_idx`` names; a causal cell is live
    when a column of ``v_idx`` falls in its key block (ids clipped into
    the blocks, as JAX clips them) or a slash crosses it, i.e. lies in
    its range of ``i - j``, ``[qb bM - kb bN - (bN - 1), qb bM + bM - 1 -
    kb bN]``."""
    v_idx = torch.as_tensor(v_idx).to(torch.int32)
    s_idx = torch.as_tensor(s_idx, device=v_idx.device).to(torch.int32)
    B, H, _ = v_idx.shape
    nQ, nK = Sq // block_M, Sk // block_N
    dev = v_idx.device
    vmask = _scatter_ones(v_idx, 0, Sk)
    vb = torch.zeros((B, H, nK), dtype=torch.bool, device=dev)
    vb.scatter_(2, torch.div(v_idx.long(), block_N, rounding_mode="floor")
                .clamp(0, nK - 1), True)
    # a causal cell's range of i - j starts at -(bM - 1) - (bN - 1) at
    # the lowest; the range ends at Sq - 1 at the highest
    lo_d = -(block_M - 1) - (block_N - 1)
    hits = _scatter_ones(s_idx, lo_d, Sq - lo_d)
    cs = torch.nn.functional.pad(torch.cumsum(hits, -1, dtype=torch.int32),
                                 (1, 0))
    qb = torch.arange(nQ, device=dev)[:, None]
    kb = torch.arange(nK, device=dev)[None, :]
    base = qb * block_M - kb * block_N
    lo = (base - (block_N - 1)).clamp(lo_d, Sq - 1) - lo_d
    hi = (base + block_M - 1).clamp(lo_d, Sq - 1) - lo_d
    sblock = (cs[..., hi + 1] - cs[..., lo]) > 0
    sblock &= (base - (block_N - 1) <= Sq - 1) & (base + block_M - 1 >= lo_d)
    causal = kb * block_N <= qb * block_M + block_M - 1
    block_mask = (vb[:, :, None, :] | sblock) & causal
    return vmask, block_mask.to(torch.int32)


def _check(q, k, v, vmask, dmask, block_mask, block_M, block_N):
    check_attention_args(q, k, v)
    B, H, Sq, _ = q.shape
    Sk = k.shape[2]
    if block_M < 1 or block_N < 1 or Sq % block_M or Sk % block_N:
        raise ValueError("sequence length must divide the block size")
    for name, t, shape in (("vmask", vmask, (B, H, Sk)),
                           ("dmask", dmask, (B, H, Sq)),
                           ("block_mask", block_mask,
                            (B, H, Sq // block_M, Sk // block_N))):
        if tuple(t.shape) != shape or t.device != q.device:
            raise ValueError(f"{name} must be {shape} on {q.device}, got "
                             f"{tuple(t.shape)} on {t.device}")


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def vs_sparse_plain(q, k, v, vmask, dmask, block_mask, block_M: int,
                    block_N: int, sm_scale: float,
                    rows: int = PLAIN_ROWS) -> torch.Tensor:
    """Plain version of the kernel, ``rows`` query rows at a time: exp2
    scores ``float(q k^T) * sm_scale * log2(e)``, -inf off the visible
    pairs, ``m = max(rowmax, -1e30)``, ``p = exp2(s - m)``, ``acc =
    dtype(p) @ v`` in float32, ``l > 0 ? acc / l : 0`` in q's type."""
    Sq, Sk = q.shape[2], k.shape[2]
    kf, vf = k.float(), v.float()
    j = torch.arange(Sk, device=q.device)
    live_cols = (vmask != 0)[:, :, None, :]
    out = torch.empty_like(q)
    for i0 in range(0, Sq, rows):
        i = torch.arange(i0, min(i0 + rows, Sq), device=q.device)
        d = i[:, None] - j[None, :]
        vis = live_cols | (dmask != 0)[:, :, d.clamp_min(0)]
        vis &= (d >= 0)
        vis &= (block_mask != 0)[:, :, i // block_M][..., j // block_N]
        s = torch.matmul(q[:, :, i0:i0 + len(i)].float(), kf.transpose(-1, -2))
        s.mul_(float(sm_scale) * _LOG2E).masked_fill_(~vis, -math.inf)
        m = s.amax(dim=-1, keepdim=True).clamp_min_(-1e30)
        p = torch.exp2_(s.sub_(m))
        l = p.sum(dim=-1, keepdim=True)
        acc = torch.matmul(p.to(q.dtype).float(), vf)
        out[:, :, i0:i0 + len(i)] = torch.where(l > 0, acc / l, 0.0)
    return out


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------


def vs_tile(D: int, block_M: int, block_N: int):
    """The tensor-core kernel's tile ``(TM, TN)`` for head_dim ``D`` and
    the caller's cells: ``mask_tile`` over ``VS_TILES``; ``None`` for a
    head_dim without an instance."""
    tiles = VS_TILES.get(int(D))
    return None if tiles is None else mask_tile(tiles, block_M, block_N)


def _launch(q, k, v, vmask, dmask, block_mask, block_M, block_N, sm_scale):
    from ._build import aligned16, load, stream_call
    q, k, v = aligned16(q, k, v)
    masks = [t.to(torch.int32).contiguous() for t in (vmask, dmask,
                                                       block_mask)]
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    o = torch.empty_like(q)
    tile = (0, 0)
    if q.dtype != torch.float32:
        tile = vs_tile(D, block_M, block_N) or (0, 0)
    fn = load("minference").tl_vs_sparse_tiled
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                   + [ctypes.c_float] + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    code = stream_call(fn, q.device, q.data_ptr(), k.data_ptr(),
                       v.data_ptr(), *(t.data_ptr() for t in masks),
                       o.data_ptr(), B, H, Sq, Sk, D, block_M, block_N,
                       DTYPE_CODES[q.dtype], float(sm_scale) * _LOG2E,
                       *tile)
    if code != 0:
        raise KernelLaunchError("vs_sparse", code)
    launches["vs_sparse"] += 1
    return o


def vs_sparse(q, k, v, vmask, dmask, block_mask, block_M: int, block_N: int,
              sm_scale: float) -> torch.Tensor:
    """Vertical-slash attention ``(B, H, Sq, D)`` in q's type, from the
    column mask ``vmask (B, H, Sk)``, the diagonal mask ``dmask (B, H,
    Sq)`` and the cell mask ``block_mask``. CUDA tensors launch the
    kernel; CPU tensors run the plain version."""
    _check(q, k, v, vmask, dmask, block_mask, block_M, block_N)
    if q.is_cuda:
        return _launch(q, k, v, vmask, dmask, block_mask, block_M, block_N,
                       sm_scale)
    return vs_sparse_plain(q, k, v, vmask, dmask, block_mask, block_M,
                           block_N, sm_scale)


def vs_sparse_kernel(B, H, Sq, Sk, D, Ns, block_M, block_N, sm_scale,
                     dtype, num_stages=2):
    """The kernel bound to one shape (the JAX factory's arguments):
    ``fn(q, k, v, vmask (B, H, Sk), s_idx (B, H, Ns), block_mask) ->
    o``, the slashes as the JAX kernel takes them."""
    dt = _as_dtype(dtype)
    qkv = [((B, H, Sq, D), dt), ((B, H, Sk, D), dt), ((B, H, Sk, D), dt)]
    return bind("vs_sparse_kernel",
                qkv + [((B, H, Sk), None), ((B, H, Ns), None),
                       ((B, H, Sq // block_M, Sk // block_N), None)],
                lambda q, k, v, vmask, s_idx, block_mask: vs_sparse(
                    q, k, v, vmask, diagonal_mask(s_idx, Sq), block_mask,
                    block_M, block_N, float(sm_scale)))


def vertical_slash_sparse_attention(q, k, v, v_idx, s_idx,
                                    sm_scale: Optional[float] = None,
                                    block_M: int = 64,
                                    block_N: int = 64) -> torch.Tensor:
    """q, k, v (B, H, S, D); v_idx (B, H, Nv) selected key columns;
    s_idx (B, H, Ns) selected diagonals (``i - j`` distances); the
    indices may be numpy arrays or tensors. Blocks are clamped to the
    sequence lengths, which they must divide."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    block_M, block_N = min(block_M, Sq), min(block_N, Sk)
    if Sq % block_M or Sk % block_N:
        raise ValueError("sequence length must divide the block size")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    v_idx = torch.as_tensor(v_idx, device=q.device).to(torch.int32)
    s_idx = torch.as_tensor(s_idx, device=q.device).to(torch.int32)
    vmask, block_mask = _build_masks(v_idx, s_idx, Sq, Sk, block_M, block_N)
    return vs_sparse(q, k, v, vmask, diagonal_mask(s_idx, Sq), block_mask,
                     block_M, block_N, float(sm_scale))


def vs_sparse_reference(q, k, v, v_idx, s_idx,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """The JAX package's dense reference: a natural-exp softmax in
    float32 over the visible pairs, rows with none 0, ``dtype(p) @ v``."""
    Sq, D = q.shape[2], q.shape[3]
    Sk = k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    v_idx = torch.as_tensor(v_idx, device=q.device).long()
    s_idx = torch.as_tensor(s_idx, device=q.device).long()
    qi = torch.arange(Sq, device=q.device)[:, None]
    kj = torch.arange(Sk, device=q.device)[None, :]
    vmask = (torch.arange(Sk, device=q.device)[None, None, None, :]
             == v_idx[..., None]).any(2)
    smask = ((qi - kj)[None, None, :, :, None]
             == s_idx[:, :, None, None, :]).any(-1)
    vis = (vmask[:, :, None, :] | smask) & (qi >= kj)[None, None]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    s = s.masked_fill(~vis, -math.inf)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(torch.isfinite(m), torch.exp(s - m), 0.0)
    denom = p.sum(dim=-1, keepdim=True)
    p = torch.where(denom > 0, p / denom, 0.0)
    return torch.matmul(p.to(q.dtype).float(), v.float()).to(q.dtype)
