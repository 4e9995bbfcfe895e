"""Grouped (batched-expert) GEMMs on the card: dense and token-sorted.

Counterpart of ``tilelang_mesh_tpu/ops/grouped_gemm.py``. Two CUDA
kernels (``csrc/grouped_gemm.cu``, on the block tile loop of
``csrc/gemm_tile.cuh``) replace the TPU's:

* ``grouped_matmul`` — ``grouped_gemm_kernel``: ``out[e] = x[e] @ w[e]``
  for ``x (E, M, K)``, ``w (E, K, N)``, accumulated in float32 and
  returned in x's type. The MoE layer's expert FFN runs it twice.
* ``varlen_grouped_matmul`` — ``varlen_grouped_gemm_kernel``: the rows
  of ``a (sum(sizes), K)`` in groups of ``sizes``, group g times
  ``b[g]`` (``(E, K, N)``, or ``(E, N, K)`` with ``trans_b``), returned
  as ``(sum(sizes), N)`` float32. Each kernel block reads its expert and
  first row from the ``_varlen_meta`` tables, built with the kernel's
  128-row tile.

The ``block_*`` and ``num_stages`` arguments are the TPU's tiling hints;
they are accepted and ignored, since they do not change the result.

Each wrapper launches its kernel on CUDA tensors (a build or launch
failure raises; there is no fallback) and runs its plain PyTorch
version (``*_plain``: ``torch.bmm`` or a loop over the groups, in
float32) on CPU tensors. The tests and ``chip_smoke.py`` hold the
kernels against the plain versions.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from ..resilience.errors import KernelLaunchError
from .gemm import DTYPE_CODES
from ._factory import bind
from .gemm import _as_dtype

__all__ = ["grouped_matmul", "grouped_matmul_plain", "varlen_grouped_matmul",
           "varlen_grouped_matmul_plain", "varlen_grouped_matmul_reference",
           "launches", "reset_launches", "KERNEL_BLOCK_M",
           "grouped_gemm_kernel", "varlen_grouped_gemm_kernel"]

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# rows of the kernels' block tile (csrc/gemm_tile.cuh BM); the
# token-sorted tables are built with it
KERNEL_BLOCK_M = 128
_KERNEL_BLOCK_N = 128
_GRID_YZ_MAX = 65535        # gridDim.y / gridDim.z

# kernel name -> launches through its wrapper (chip_smoke.py zeroes and
# reads these around the MoE run to prove the path used the kernel)
launches = {"grouped_gemm": 0, "varlen_grouped_gemm": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _check_operands(a, b, what: str) -> None:
    if a.dtype != b.dtype or a.dtype not in _DTYPES:
        raise TypeError(f"{what}: operands must share float32, bfloat16 or "
                        f"float16, got {a.dtype}, {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"{what}: operands must share a device, got "
                         f"{a.device}, {b.device}")
    if a.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what}: unsupported device {a.device}")


# ---------------------------------------------------------------------------
# dense
# ---------------------------------------------------------------------------


def grouped_matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: ``torch.bmm`` in float32, cast to x's type."""
    return torch.bmm(x.float(), w.float()).to(x.dtype)


def _grouped_launch(x, w):
    from ._build import load, stream_call
    x, w = x.contiguous(), w.contiguous()
    E, M, K = x.shape
    N = w.shape[2]
    out = torch.empty((E, M, N), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if K == 0:
        return out.zero_()
    if -(-N // _KERNEL_BLOCK_N) > _GRID_YZ_MAX or E > _GRID_YZ_MAX:
        raise ValueError(f"grouped_matmul: N={N} or E={E} is past the "
                         f"kernel grid's range")
    fn = load("grouped_gemm").tl_grouped_gemm
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = stream_call(fn, x.device, x.data_ptr(), w.data_ptr(),
                        out.data_ptr(), E, M, N, K,
                        DTYPE_CODES[x.dtype])
    if code != 0:
        raise KernelLaunchError("grouped_gemm", code)
    launches["grouped_gemm"] += 1
    return out


def grouped_matmul(x, w, block_M=128, block_N=128, block_K=128,
                   num_stages=2):
    """x (E, M, K) @ w (E, K, N) -> (E, M, N) in x's type, accumulated in
    float32. CUDA tensors launch the kernel; CPU tensors run the plain
    version."""
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"grouped_matmul: want x (E, M, K) and w (E, K, N),"
                         f" got {tuple(x.shape)}, {tuple(w.shape)}")
    _check_operands(x, w, "grouped_matmul")
    if x.is_cuda:
        return _grouped_launch(x, w)
    return grouped_matmul_plain(x, w)


# ---------------------------------------------------------------------------
# token-sorted (ragged groups)
# ---------------------------------------------------------------------------


def _varlen_meta(sizes, block_M):
    """block -> (expert, row_start) tables + padded gather indices."""
    import numpy as np
    offs, row_of_block, exp_of_block, out_rows = [0], [], [], []
    for s in sizes:
        offs.append(offs[-1] + int(s))
    pad_base = 0
    for e, s in enumerate(sizes):
        nb = -(-int(s) // block_M) if s else 0
        for b in range(nb):
            exp_of_block.append(e)
            row_of_block.append(offs[e] + b * block_M)
        out_rows.extend(range(pad_base, pad_base + int(s)))
        pad_base += nb * block_M
    return (np.asarray(exp_of_block, np.int32),
            np.asarray(row_of_block, np.int32),
            np.asarray(out_rows, np.int64))


def varlen_grouped_matmul_plain(a, b, sizes: Sequence[int],
                                trans_b: bool = False) -> torch.Tensor:
    """Plain version: each group's rows times its expert's b, in
    float32, one matmul a group."""
    N = b.shape[1] if trans_b else b.shape[2]
    out = torch.empty((a.shape[0], N), dtype=torch.float32, device=a.device)
    off = 0
    for e, s in enumerate(sizes):
        w = b[e].T if trans_b else b[e]
        torch.matmul(a[off:off + s].float(), w.float(), out=out[off:off + s])
        off += s
    return out


# the JAX package's name for the same per-group float32 products
varlen_grouped_matmul_reference = varlen_grouped_matmul_plain


def _varlen_launch(a, b, sizes, trans_b):
    from ._build import load, stream_call
    a, b = a.contiguous(), b.contiguous()
    K = a.shape[1]
    N = b.shape[1] if trans_b else b.shape[2]
    out = torch.empty((a.shape[0], N), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    if K == 0:
        return out.zero_()
    if -(-N // _KERNEL_BLOCK_N) > _GRID_YZ_MAX:
        raise ValueError(f"varlen_grouped_matmul: N={N} is past the kernel "
                         f"grid's range")
    exp_blk, row_blk, _ = _varlen_meta(sizes, KERNEL_BLOCK_M)
    ends = np.cumsum(sizes).astype(np.int32)
    tables = torch.from_numpy(np.concatenate([exp_blk, row_blk, ends])).to(
        a.device, non_blocking=False)
    TB = len(exp_blk)
    fn = load("grouped_gemm").tl_varlen_grouped_gemm
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    base = tables.data_ptr()
    code = stream_call(fn, a.device, a.data_ptr(), b.data_ptr(), base,
                        base + 4 * TB, base + 8 * TB, out.data_ptr(), TB, N,
                        K, int(bool(trans_b)), DTYPE_CODES[a.dtype])
    if code != 0:
        raise KernelLaunchError("varlen_grouped_gemm", code)
    launches["varlen_grouped_gemm"] += 1
    return out


def varlen_grouped_matmul(a, b, sizes, block_M=128, block_N=128,
                          block_K=128, trans_b=False):
    """a (sum(sizes), K) x b (E, K, N) -> (sum(sizes), N) float32, group g
    of rows multiplying b[g] (b (E, N, K) with ``trans_b``). `sizes` must
    be a static python sequence. CUDA tensors launch the kernel; CPU
    tensors run the plain version."""
    sizes = tuple(int(s) for s in sizes)
    E = b.shape[0]
    K = a.shape[1]
    if len(sizes) != E:
        raise ValueError(f"len(sizes) ({len(sizes)}) != groups in b ({E})")
    if sum(sizes) != a.shape[0]:
        raise ValueError(f"sum(sizes) ({sum(sizes)}) != rows of a "
                         f"({a.shape[0]})")
    if min(sizes, default=0) < 0 or b.dim() != 3 \
            or (b.shape[2] if trans_b else b.shape[1]) != K:
        raise ValueError(f"varlen_grouped_matmul: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)} (trans_b={trans_b}) and sizes "
                         f"{sizes} do not fit")
    _check_operands(a, b, "varlen_grouped_matmul")
    if a.is_cuda:
        return _varlen_launch(a, b, sizes, trans_b)
    return varlen_grouped_matmul_plain(a, b, sizes, trans_b)


def grouped_gemm_kernel(E, M, N, K, block_M=128, block_N=128, block_K=128,
                        in_dtype="bfloat16", accum_dtype="float32",
                        out_dtype=None, num_stages=2):
    """The dense kernel bound to one shape (the JAX factory's arguments):
    ``fn(x (E, M, K), w (E, K, N)) -> (E, M, N)`` in the input type, with
    float32 accumulation (the only pair the kernel stores)."""
    in_dt = _as_dtype(in_dtype)
    if _as_dtype(out_dtype or in_dtype) != in_dt \
            or _as_dtype(accum_dtype) != torch.float32:
        raise TypeError(f"grouped_gemm_kernel: {in_dtype} -> {out_dtype} "
                        f"with a {accum_dtype} accumulator is not ported "
                        f"(the output is the input type, float32 sums)")
    return bind("grouped_gemm_kernel", [((E, M, K), in_dt),
                                        ((E, K, N), in_dt)], grouped_matmul)


def varlen_grouped_gemm_kernel(rows_pad, TB, E, K, N, block_M, block_N,
                               block_K, in_dtype, trans_b=False):
    """The token-sorted kernel bound to one shape (the JAX factory's
    arguments): ``fn(a (rows_pad, K), b, blk_exp (TB,), blk_row (TB,))
    -> c (TB * block_M, N)`` float32, block i of ``c`` being the
    ``block_M`` rows of ``a`` from ``blk_row[i]`` times expert
    ``blk_exp[i]`` of b ((E, K, N), or (E, N, K) with ``trans_b``), all
    of them, as the JAX kernel writes its block-padded output. The
    tables may be numpy arrays."""
    in_dt = _as_dtype(in_dtype)
    b_shape = (E, N, K) if trans_b else (E, K, N)

    def op(a, b, blk_exp, blk_row):
        exp = torch.as_tensor(np.asarray(blk_exp), device=a.device).long()
        row = torch.as_tensor(np.asarray(blk_row), device=a.device).long()
        if TB and int(row.max()) + block_M > rows_pad:
            raise ValueError(f"varlen_grouped_gemm_kernel: a block reads "
                             f"past the {rows_pad} rows of a")
        rows = row[:, None] + torch.arange(block_M, device=a.device)
        return varlen_grouped_matmul(a[rows.reshape(-1)], b[exp],
                                     [block_M] * TB, trans_b=trans_b)

    return bind("varlen_grouped_gemm_kernel",
                [((rows_pad, K), in_dt), (b_shape, in_dt), ((TB,), None),
                 ((TB,), None)], op)
