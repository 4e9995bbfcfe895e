"""The GEMM on the card: C = op(A) @ op(B), optional ReLU.

Counterpart of ``tilelang_mesh_tpu/ops/gemm.py``. One CUDA kernel
(``csrc/gemm.cu``, on the block tile loop of ``csrc/gemm_tile.cuh``)
replaces the TPU's ``matmul_kernel``:

* ``matmul(a, b, trans_A, trans_B, out_dtype, relu)`` — ``a (M, K)`` (or
  ``(K, M)`` with ``trans_A``) times ``b (K, N)`` (or ``(N, K)`` with
  ``trans_B``), both float32, bfloat16 or float8 e4m3, accumulated in
  float32 (no TF32), ReLU on the accumulator, returned in ``out_dtype``
  (default: the inputs' type), which is float32, bfloat16 or the
  inputs' type. Any other pair raises ``TypeError``. A float8 e4m3
  output is NaN where the sum rounds past the format's range (|c| >
  464), as in the JAX package.
* ``matmul_kernel(M, N, K, ...)`` — the JAX package's factory: the same
  product for fixed shapes and types, as a callable ``k(a, b)``.

The ``block_*`` and ``num_stages`` arguments are the TPU's tiling hints;
they are accepted and ignored, since they do not change the result.

The wrapper launches the kernel on CUDA tensors (a build or launch
failure raises; there is no fallback) and runs its plain PyTorch version
(``matmul_plain``: upcast to float32, ``torch.matmul``, ReLU, cast by
``to_out``) on
CPU tensors. The tests and ``chip_smoke.py`` hold the kernel against the
plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..resilience.errors import KernelLaunchError

__all__ = ["matmul", "matmul_plain", "matmul_kernel", "launches",
           "reset_launches", "to_out", "IN_DTYPES"]

# the kernel's input types, with their codes in tl_matmul
IN_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}
_KERNEL_BLOCK = 128           # csrc/gemm_tile.cuh BM = BN
_GRID_X_MAX = 2 ** 31 - 1

# kernel name -> launches through its wrapper (chip_smoke.py zeroes and
# reads it around each call to prove the path used the kernel)
launches = {"matmul": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _as_dtype(dt) -> torch.dtype:
    """A torch dtype, or the JAX package's name of one ("bfloat16")."""
    if isinstance(dt, torch.dtype):
        return dt
    got = getattr(torch, str(dt), None)
    if not isinstance(got, torch.dtype):
        raise TypeError(f"unknown dtype {dt!r}")
    return got


def _out_dtype(in_dtype: torch.dtype, out_dtype) -> torch.dtype:
    out = in_dtype if out_dtype is None else _as_dtype(out_dtype)
    if in_dtype not in IN_DTYPES or out not in (torch.float32,
                                                torch.bfloat16, in_dtype):
        raise TypeError(f"matmul: {in_dtype} -> {out} is not ported (inputs "
                        f"float32, bfloat16 or float8_e4m3fn; output "
                        f"float32, bfloat16 or the inputs' type)")
    return out


def _shapes(a, b, trans_A, trans_B):
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"matmul: want 2-D operands, got {tuple(a.shape)},"
                         f" {tuple(b.shape)}")
    M, K = (a.shape[1], a.shape[0]) if trans_A else a.shape
    Kb, N = (b.shape[1], b.shape[0]) if trans_B else b.shape
    if K != Kb:
        raise ValueError(f"matmul: a {tuple(a.shape)} (trans_A={trans_A}) "
                         f"and b {tuple(b.shape)} (trans_B={trans_B}) do "
                         f"not share K")
    return int(M), int(N), int(K)


def _check(a, b, what: str) -> None:
    if a.dtype != b.dtype:
        raise TypeError(f"{what}: operands must share a dtype, got "
                        f"{a.dtype}, {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"{what}: operands must share a device, got "
                         f"{a.device}, {b.device}")
    if a.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what}: unsupported device {a.device}")


def check_grid(M: int, N: int, what: str) -> None:
    """The kernels' one-dimensional grid holds every 128 x 128 tile."""
    if -(-M // _KERNEL_BLOCK) * -(-N // _KERNEL_BLOCK) > _GRID_X_MAX:
        raise ValueError(f"{what}: M={M}, N={N} is past the kernel grid's "
                         f"range")


def matmul_plain(a, b, trans_A: bool = False, trans_B: bool = False,
                 out_dtype=None, relu: bool = False) -> torch.Tensor:
    """Plain version: upcast to float32, ``torch.matmul``, ReLU, cast."""
    out = _out_dtype(a.dtype, out_dtype)
    c = torch.matmul(a.float().T if trans_A else a.float(),
                     b.float().T if trans_B else b.float())
    if relu:
        c = torch.relu(c)
    return to_out(c, out)


# |x| above which float8 e4m3 rounds past its largest value (448, whose
# neighbour 480 has no code): halfway, 464 itself rounds to even (448)
_E4M3_OVERFLOW = 464.0


def to_out(c: torch.Tensor, out: torch.dtype) -> torch.Tensor:
    """``c`` (float32) in ``out``. A float8 e4m3 output takes NaN, of
    c's sign, where c rounds past the format's range (|c| > 464, or
    infinite), as the JAX package's cast does: torch's own cast would
    saturate to +-448."""
    if out == torch.float8_e4m3fn:
        nan = torch.copysign(torch.full_like(c, float("nan")), c)
        c = torch.where(c.abs() > _E4M3_OVERFLOW, nan, c)
    return c.to(out)


def _launch(a, b, M, N, K, trans_A, trans_B, out, relu):
    from ._build import load, stream_call
    a, b = a.contiguous(), b.contiguous()
    c = torch.empty((M, N), dtype=out, device=a.device)
    if c.numel() == 0:
        return c
    if K == 0:
        return c.zero_()
    check_grid(M, N, "matmul")
    fn = load("gemm").tl_matmul
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = stream_call(fn, a.device, a.data_ptr(), b.data_ptr(),
                       c.data_ptr(), M, N, K, IN_DTYPES[a.dtype],
                       int(trans_A), int(trans_B), IN_DTYPES[out],
                       int(bool(relu)))
    if code != 0:
        raise KernelLaunchError("matmul", code)
    launches["matmul"] += 1
    return c


def matmul(a, b, trans_A: bool = False, trans_B: bool = False,
           out_dtype: Optional[object] = None, relu: bool = False,
           block_M=None, block_N=None, block_K=None) -> torch.Tensor:
    """C = op(A) @ op(B) (f32 accumulation, optional ReLU) in
    ``out_dtype`` (default: the inputs' type). CUDA tensors launch the
    kernel; CPU tensors run the plain version."""
    _check(a, b, "matmul")
    out = _out_dtype(a.dtype, out_dtype)
    M, N, K = _shapes(a, b, trans_A, trans_B)
    if a.is_cuda:
        return _launch(a, b, M, N, K, trans_A, trans_B, out, relu)
    return matmul_plain(a, b, trans_A, trans_B, out, relu)


def matmul_kernel(M, N, K, block_M=None, block_N=None, block_K=None,
                  in_dtype="bfloat16", out_dtype=None,
                  accum_dtype="float32", trans_A=False, trans_B=False,
                  relu=False, num_stages=2):
    """The JAX package's factory: a callable ``k(a, b)`` computing
    ``matmul`` for these shapes and types (float32 accumulation only)."""
    in_dt = _as_dtype(in_dtype)
    out = _out_dtype(in_dt, out_dtype)
    if _as_dtype(accum_dtype) != torch.float32:
        raise TypeError(f"matmul_kernel: accumulation in {accum_dtype} is "
                        f"not ported (float32 only)")
    a_shape = (K, M) if trans_A else (M, K)
    b_shape = (N, K) if trans_B else (K, N)

    def kernel(a, b):
        if tuple(a.shape) != a_shape or tuple(b.shape) != b_shape \
                or a.dtype != in_dt:
            raise ValueError(f"matmul_kernel: want a {a_shape}, b {b_shape}"
                             f" of {in_dt}, got {tuple(a.shape)}, "
                             f"{tuple(b.shape)} of {a.dtype}")
        return matmul(a, b, trans_A, trans_B, out, relu)

    return kernel
