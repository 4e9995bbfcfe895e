"""The GEMM on the card: C = op(A) @ op(B), optional ReLU.

Counterpart of ``tilelang_mesh_tpu/ops/gemm.py``. Two CUDA sources on the
block tile loop of ``csrc/gemm_tile.cuh`` replace the TPU's
``matmul_kernel``: ``csrc/gemm.cu`` for float inputs, ``csrc/gemm_s8.cu``
for int8:

* ``matmul(a, b, trans_A, trans_B, out_dtype, relu)`` — ``a (M, K)`` (or
  ``(K, M)`` with ``trans_A``) times ``b (K, N)`` (or ``(N, K)`` with
  ``trans_B``), both float32, bfloat16, float16 or float8 e4m3,
  accumulated in float32 (no TF32), ReLU on the accumulator, returned in
  ``out_dtype`` (default: the inputs' type): float32, bfloat16, float16
  or float8 e4m3. A float8 e4m3 output is NaN where the sum rounds past
  the format's range (|c| > 464), as in the JAX package.
* ``matmul_kernel(M, N, K, ...)`` — the JAX package's factory: the same
  product for fixed shapes and types, as a callable ``k(a, b)``; with
  ``in_dtype="int8", out_dtype="int32", accum_dtype="int32"`` the exact
  int32 product of int8 operands.

Every other combination raises ``TypeError`` (see ``_out_dtype``):
float64; int8 with a float accumulator or an output other than int32;
an integer output from float inputs; a float accumulator other than
float32, which the JAX package rounds after each of its carver's K
tiles, so that its result depends on a tiling that is no part of the
contract.

The ``block_*`` and ``num_stages`` arguments are the TPU's tiling hints;
they are accepted and ignored, since they do not change the result.

The wrapper launches the kernel on CUDA tensors (a build or launch
failure raises; there is no fallback) and runs its plain PyTorch version
(``matmul_plain``: upcast to float32, ``torch.matmul``, ReLU, cast by
``to_out``; int8 as an exact int64 product on the CPU, float64 on the
card) on CPU tensors. The tests and ``chip_smoke.py`` hold the kernel against the
plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..resilience.errors import KernelLaunchError

__all__ = ["matmul", "matmul_plain", "matmul_kernel", "launches",
           "reset_launches", "to_out", "DTYPE_CODES", "FLOAT_TYPES"]

# element types with their codes in the C launchers (gemm_tile.cuh DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2,
               torch.float16: 3, torch.int8: 4, torch.int32: 5}
# the float types the kernels take in and give out
FLOAT_TYPES = (torch.float32, torch.bfloat16, torch.float16,
               torch.float8_e4m3fn)
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


def _out_dtype(in_dtype: torch.dtype, out_dtype,
               accum_dtype=torch.float32) -> torch.dtype:
    """The output type of a product of ``in_dtype`` operands, or
    ``TypeError`` for a combination the kernels do not compute."""
    out = in_dtype if out_dtype is None else _as_dtype(out_dtype)
    accum = _as_dtype(accum_dtype)
    if in_dtype in FLOAT_TYPES:
        if accum != torch.float32:
            raise TypeError(f"matmul: accumulation in {accum} is not ported "
                            f"(float inputs accumulate in float32)")
        if out not in FLOAT_TYPES:
            raise TypeError(f"matmul: {in_dtype} -> {out} is not ported "
                            f"(float inputs give float32, bfloat16, "
                            f"float16 or float8_e4m3fn)")
        return out
    if in_dtype == torch.int8:
        if accum != torch.int32 or out != torch.int32:
            raise TypeError(f"matmul: int8 accumulated in {accum} into "
                            f"{out} is not ported (int8 takes "
                            f"accum_dtype='int32', out_dtype='int32')")
        return out
    raise TypeError(f"matmul: {in_dtype} inputs are not ported (float32, "
                    f"bfloat16, float16, float8_e4m3fn, or int8 with an "
                    f"int32 accumulator)")


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
    """Plain version: upcast to float32, ``torch.matmul``, ReLU, cast.
    int8 operands (int32 output): the exact product, in int64 on the CPU
    and in float64 on the card (exact while |sum| < 2**53)."""
    if a.dtype == torch.int8:
        out = _out_dtype(a.dtype, out_dtype, torch.int32)
        wide = torch.int64 if a.device.type == "cpu" else torch.float64
    else:
        out = _out_dtype(a.dtype, out_dtype)
        wide = torch.float32
    a, b = a.to(wide), b.to(wide)
    c = torch.matmul(a.T if trans_A else a, b.T if trans_B else b)
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
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    if a.dtype == torch.int8:            # csrc/gemm_s8.cu
        fn = load("gemm_s8").tl_matmul_s8
        fn.argtypes = [ptr] * 3 + [i32] * 6 + [ptr]
        args = (M, N, K, int(trans_A), int(trans_B), int(bool(relu)))
    else:
        fn = load("gemm").tl_matmul
        fn.argtypes = [ptr] * 3 + [i32] * 8 + [ptr]
        args = (M, N, K, DTYPE_CODES[a.dtype], int(trans_A), int(trans_B),
                DTYPE_CODES[out], int(bool(relu)))
    fn.restype = ctypes.c_int
    code = stream_call(fn, a.device, a.data_ptr(), b.data_ptr(),
                       c.data_ptr(), *args)
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
    return _run(a, b, trans_A, trans_B, out_dtype, torch.float32, relu)


def _run(a, b, trans_A, trans_B, out_dtype, accum_dtype, relu):
    _check(a, b, "matmul")
    out = _out_dtype(a.dtype, out_dtype, accum_dtype)
    M, N, K = _shapes(a, b, trans_A, trans_B)
    if a.is_cuda:
        return _launch(a, b, M, N, K, trans_A, trans_B, out, relu)
    return matmul_plain(a, b, trans_A, trans_B, out, relu)


def matmul_kernel(M, N, K, block_M=None, block_N=None, block_K=None,
                  in_dtype="bfloat16", out_dtype=None,
                  accum_dtype="float32", trans_A=False, trans_B=False,
                  relu=False, num_stages=2):
    """The JAX package's factory: a callable ``k(a, b)`` computing
    ``matmul`` for these shapes and types (a float32 accumulator for
    float inputs, int32 for int8)."""
    in_dt = _as_dtype(in_dtype)
    out = _out_dtype(in_dt, out_dtype, accum_dtype)
    a_shape = (K, M) if trans_A else (M, K)
    b_shape = (N, K) if trans_B else (K, N)

    def kernel(a, b):
        if tuple(a.shape) != a_shape or tuple(b.shape) != b_shape \
                or a.dtype != in_dt:
            raise ValueError(f"matmul_kernel: want a {a_shape}, b {b_shape}"
                             f" of {in_dt}, got {tuple(a.shape)}, "
                             f"{tuple(b.shape)} of {a.dtype}")
        return _run(a, b, trans_A, trans_B, out, accum_dtype, relu)

    return kernel
