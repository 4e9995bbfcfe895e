"""Grouped (batched-expert) GEMMs on the card: dense and token-sorted.

Counterpart of ``tilelang_mesh_tpu/ops/grouped_gemm.py``. The kernels
of ``csrc/grouped_gemm.cu`` replace the TPU's:

* ``grouped_matmul`` — ``grouped_gemm_kernel``: ``out[e] = x[e] @ w[e]``
  for ``x (E, M, K)``, ``w (E, K, N)``, accumulated in float32 and
  returned in x's type. The MoE layer's expert FFN runs it twice.
* ``varlen_grouped_matmul`` — ``varlen_grouped_gemm_kernel``: the rows
  of ``a (sum(sizes), K)`` in groups of ``sizes``, group g times
  ``b[g]`` (``(E, K, N)``, or ``(E, N, K)`` with ``trans_b``), returned
  as ``(sum(sizes), N)`` float32. Each kernel block reads its expert and
  first row from the ``_varlen_meta`` tables, built at the kernel's
  block rows.

On the card each call takes one of three kernels by a stated rule
(``grouped_path``), decided before the launch: bfloat16 and float16
operands whose bases and row strides are 16-byte aligned take the TMA +
``wgmma`` kernel (``"tma"``, counted as ``grouped_gemm_tma`` /
``varlen_grouped_gemm_tma``) at a block of ``carver.KERNEL_BLOCKS``
(``kernel_block`` on the per-expert shape, the token-sorted one's rows
by ``varlen_rows``: the given ``block_M, block_N, block_K`` when they
are one, else the carver's first instance); float32 operands aligned
the same way the 3xTF32 tensor-core kernel (``"tf32x3"``: TMA +
``wgmma`` on operands split into TF32 big and small parts in the
kernel, one 128 x 128 x 32 tile, ``*_tf32x3``); everything else the
block tile loop of ``gemm_tile.cuh`` (``"loop"``, ``grouped_gemm`` /
``varlen_grouped_gemm``). ``num_stages`` is accepted and ignored: the
kernels take as many stages as shared memory holds.

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

from ..carver import auto_arch
from ..resilience.errors import KernelLaunchError
from ._factory import bind
from .gemm import DTYPE_CODES, _as_dtype, kernel_block

__all__ = ["grouped_matmul", "grouped_matmul_plain", "varlen_grouped_matmul",
           "varlen_grouped_matmul_plain", "varlen_grouped_matmul_reference",
           "launches", "reset_launches", "KERNEL_BLOCK_M", "TF32X3_BLOCK",
           "grouped_path", "grouped_block", "varlen_rows",
           "grouped_gemm_kernel", "varlen_grouped_gemm_kernel"]

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# rows of the block tile loop (csrc/gemm_tile.cuh BM); its token-sorted
# tables are built with it
KERNEL_BLOCK_M = 128
_KERNEL_BLOCK_N = 128
# the 3xTF32 kernel's one block (csrc/grouped_gemm.cu x3::TM, TN, TK)
TF32X3_BLOCK = (128, 128, 32)
_GRID_YZ_MAX = 65535        # gridDim.y / gridDim.z
_GRID_X_MAX = 2 ** 31 - 1

# kernel name -> launches through its wrapper (chip_smoke.py zeroes and
# reads these around the MoE run to prove the path used the kernel):
# "*_tma" the TMA + wgmma kernel, "*_tf32x3" the 3xTF32 one, the bare
# name the block tile loop
launches = {f"{k}{p}": 0 for k in ("grouped_gemm", "varlen_grouped_gemm")
            for p in ("", "_tma", "_tf32x3")}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def grouped_path(dtype, M: int, N: int, K: int, a_ptr: int = 0,
                 b_ptr: int = 0, trans_b: bool = False) -> str:
    """Which kernel of ``grouped_gemm.cu`` computes a grouped product on
    the card, for per-expert rows ``M`` (any count >= 1 for the
    token-sorted product), ``N`` and ``K``. The operands are aligned
    when their base addresses (``a_ptr``, ``b_ptr``) and row strides (A's
    ``K``; B's ``K`` with ``trans_b``, else ``N`` elements) are
    multiples of 16 bytes; an expert's stride is a multiple of its row
    stride:

    * ``"tma"``: bfloat16 or float16 operands, aligned;
    * ``"tf32x3"``: float32 operands, aligned;
    * ``"loop"``: everything else, and an empty dimension."""
    dtype = _as_dtype(dtype)
    if dtype not in _DTYPES or min(M, N, K) < 1:
        return "loop"
    esize = torch.empty((), dtype=dtype).element_size()
    ldb = K if trans_b else N
    if a_ptr % 16 or b_ptr % 16 or K * esize % 16 or ldb * esize % 16:
        return "loop"
    return "tf32x3" if dtype == torch.float32 else "tma"


def grouped_block(path: str, M: int, N: int, K: int, dtype, block_M=None,
                  block_N=None, block_K=None, arch=None):
    """The block (bm, bn, bk) a path's kernel runs at: ``kernel_block``
    on the per-expert shape for ``"tma"`` (the hints when they are an
    instance), ``TF32X3_BLOCK`` for ``"tf32x3"``, the loop's 128 x 128
    (depth 16 in float32, 32 in 16 bits) for ``"loop"``."""
    if path == "tma":
        return kernel_block(M, N, K, dtype, block_M, block_N, block_K,
                            arch=arch)
    if path == "tf32x3":
        return TF32X3_BLOCK
    return (KERNEL_BLOCK_M, _KERNEL_BLOCK_N,
            16 if _as_dtype(dtype) == torch.float32 else 32)


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


def _call(kernel, fn_name, argtypes, dev, *args):
    """``csrc/grouped_gemm.cu``'s ``fn_name`` on ``dev``'s stream; counts
    one launch of ``kernel``, or raises ``KernelLaunchError``."""
    from ._build import load, stream_call
    fn = getattr(load("grouped_gemm"), fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    code = stream_call(fn, dev, *args)
    if code != 0:
        raise KernelLaunchError(kernel, code)
    launches[kernel] += 1


_P, _I = ctypes.c_void_p, ctypes.c_int


def _grouped_launch(x, w, block):
    x, w = x.contiguous(), w.contiguous()
    E, M, K = x.shape
    N = w.shape[2]
    out = torch.empty((E, M, N), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if K == 0:
        return out.zero_()
    path = grouped_path(x.dtype, M, N, K, x.data_ptr(), w.data_ptr())
    bm, bn, bk = grouped_block(path, M, N, K, x.dtype, *block,
                               arch=auto_arch(x.device) if path == "tma"
                               else None)
    if -(-N // bn) > _GRID_YZ_MAX or E > _GRID_YZ_MAX:
        raise ValueError(f"grouped_matmul: N={N} or E={E} is past the "
                         f"kernel grid's range")
    ptrs = (x.data_ptr(), w.data_ptr(), out.data_ptr(), E, M, N, K)
    if path == "tma":
        _call("grouped_gemm_tma", "tl_grouped_gemm_tma",
              [_P] * 3 + [_I] * 8 + [_P], x.device, *ptrs,
              DTYPE_CODES[x.dtype], bm, bn, bk)
    elif path == "tf32x3":
        _call("grouped_gemm_tf32x3", "tl_grouped_gemm_tf32x3",
              [_P] * 3 + [_I] * 4 + [_P], x.device, *ptrs)
    else:
        _call("grouped_gemm", "tl_grouped_gemm", [_P] * 3 + [_I] * 5 + [_P],
              x.device, *ptrs, DTYPE_CODES[x.dtype])
    return out


def grouped_matmul(x, w, block_M=None, block_N=None, block_K=None,
                   num_stages=2):
    """x (E, M, K) @ w (E, K, N) -> (E, M, N) in x's type, accumulated in
    float32. CUDA tensors launch the kernel ``grouped_path`` names, the
    TMA kernel at ``kernel_block``'s block for the hints (``num_stages``
    is ignored); CPU tensors run the plain version. Every path gives inf
    and NaN where the plain version does: the 3xTF32 kernel splits an
    infinite operand so that each of its products meets it once."""
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"grouped_matmul: want x (E, M, K) and w (E, K, N),"
                         f" got {tuple(x.shape)}, {tuple(w.shape)}")
    _check_operands(x, w, "grouped_matmul")
    if x.is_cuda:
        return _grouped_launch(x, w, (block_M, block_N, block_K))
    return grouped_matmul_plain(x, w)


# ---------------------------------------------------------------------------
# token-sorted (ragged groups)
# ---------------------------------------------------------------------------


def _varlen_meta(sizes, block_M):
    """block -> (expert, row_start) tables + padded gather indices."""
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


def _varlen_tables(sizes, block_M):
    """The new kernels' int32 tables for groups of ``sizes`` at
    ``block_M`` rows a block: ``[blk_row (TB) | first (E + 1) | group_end
    (E)]`` (expert e's blocks are first[e] .. first[e + 1] - 1 of
    ``_varlen_meta``'s), and TB."""
    exp_blk, row_blk, _ = _varlen_meta(sizes, block_M)
    first = np.searchsorted(exp_blk, np.arange(len(sizes) + 1)).astype(
        np.int32)
    ends = np.cumsum(sizes, dtype=np.int64).astype(np.int32)
    return np.concatenate([row_blk, first, ends]), len(exp_blk)


def varlen_rows(sizes) -> int:
    """The per-expert rows the token-sorted product's block is chosen
    for: the largest group, rounded up to the 256 rows of the largest
    block (the carver proposes only blocks dividing M, and a group's last
    tile is ragged whatever the block)."""
    return -(-max(sizes) // 256) * 256


def _varlen_launch(a, b, sizes, trans_b, block):
    a, b = a.contiguous(), b.contiguous()
    K = a.shape[1]
    N = b.shape[1] if trans_b else b.shape[2]
    E, rows = len(sizes), a.shape[0]
    out = torch.empty((rows, N), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    if K == 0:
        return out.zero_()
    path = grouped_path(a.dtype, max(sizes), N, K, a.data_ptr(),
                        b.data_ptr(), trans_b)
    bm, bn, bk = grouped_block(path, varlen_rows(sizes), N, K, a.dtype,
                               *block, arch=auto_arch(a.device)
                               if path == "tma" else None)
    if path == "loop":
        if -(-N // bn) > _GRID_YZ_MAX:
            raise ValueError(f"varlen_grouped_matmul: N={N} is past the "
                             f"kernel grid's range")
        exp_blk, row_blk, _ = _varlen_meta(sizes, bm)
        ends = np.cumsum(sizes, dtype=np.int64).astype(np.int32)
        tables = torch.from_numpy(np.concatenate([exp_blk, row_blk, ends]))
        TB = len(exp_blk)
        base = tables.to(a.device).data_ptr()
        _call("varlen_grouped_gemm", "tl_varlen_grouped_gemm",
              [_P] * 6 + [_I] * 5 + [_P], a.device, a.data_ptr(),
              b.data_ptr(), base, base + 4 * TB, base + 8 * TB,
              out.data_ptr(), TB, N, K, int(bool(trans_b)),
              DTYPE_CODES[a.dtype])
        return out
    host, TB = _varlen_tables(sizes, bm)
    if TB * -(-N // bn) > _GRID_X_MAX:
        raise ValueError(f"varlen_grouped_matmul: {TB} row blocks of N={N} "
                         f"are past the kernel grid's range")
    tables = torch.from_numpy(host).to(a.device)
    if path == "tma":
        _call("varlen_grouped_gemm_tma", "tl_varlen_grouped_gemm_tma",
              [_P] * 4 + [_I] * 10 + [_P], a.device, a.data_ptr(),
              b.data_ptr(), tables.data_ptr(), out.data_ptr(), TB, rows, E,
              N, K, int(bool(trans_b)), DTYPE_CODES[a.dtype], bm, bn, bk)
    else:
        _call("varlen_grouped_gemm_tf32x3", "tl_varlen_grouped_gemm_tf32x3",
              [_P] * 4 + [_I] * 6 + [_P], a.device, a.data_ptr(),
              b.data_ptr(), tables.data_ptr(), out.data_ptr(), TB, rows, E,
              N, K, int(bool(trans_b)))
    return out


def varlen_grouped_matmul(a, b, sizes, block_M=None, block_N=None,
                          block_K=None, trans_b=False):
    """a (sum(sizes), K) x b (E, K, N) -> (sum(sizes), N) float32, group g
    of rows multiplying b[g] (b (E, N, K) with ``trans_b``). `sizes` must
    be a static python sequence. CUDA tensors launch the kernel
    ``grouped_path`` names (the TMA kernel at ``kernel_block``'s block for
    the hints and ``varlen_rows``); CPU tensors run the plain version."""
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
        return _varlen_launch(a, b, sizes, trans_b,
                              (block_M, block_N, block_K))
    return varlen_grouped_matmul_plain(a, b, sizes, trans_b)


def grouped_gemm_kernel(E, M, N, K, block_M=128, block_N=128, block_K=128,
                        in_dtype="bfloat16", accum_dtype="float32",
                        out_dtype=None, num_stages=2):
    """The dense kernel bound to one shape (the JAX factory's arguments):
    ``fn(x (E, M, K), w (E, K, N)) -> (E, M, N)`` in the input type, with
    float32 accumulation (the only pair the kernel stores), the block
    arguments passed on as ``grouped_matmul``'s hints."""
    in_dt = _as_dtype(in_dtype)
    if _as_dtype(out_dtype or in_dtype) != in_dt \
            or _as_dtype(accum_dtype) != torch.float32:
        raise TypeError(f"grouped_gemm_kernel: {in_dtype} -> {out_dtype} "
                        f"with a {accum_dtype} accumulator is not ported "
                        f"(the output is the input type, float32 sums)")
    def op(x, w):
        return grouped_matmul(x, w, block_M, block_N, block_K, num_stages)

    return bind("grouped_gemm_kernel", [((E, M, K), in_dt),
                                        ((E, K, N), in_dt)], op)


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
                                     [block_M] * TB, block_M, block_N,
                                     block_K, trans_b=trans_b)

    return bind("varlen_grouped_gemm_kernel",
                [((rows_pad, K), in_dt), (b_shape, in_dt), ((TB,), None),
                 ((TB,), None)], op)
