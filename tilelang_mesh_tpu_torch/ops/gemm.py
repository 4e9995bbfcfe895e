"""The GEMM on the card: C = op(A) @ op(B), optional ReLU.

Counterpart of ``tilelang_mesh_tpu/ops/gemm.py``. ``csrc/gemm.cu``
replaces the TPU's ``matmul_kernel`` for float inputs, ``csrc/gemm_s8.cu``
for int8:

* ``matmul(a, b, trans_A, trans_B, out_dtype, relu, block_M, block_N,
  block_K)`` — ``a (M, K)`` (or ``(K, M)`` with ``trans_A``) times ``b
  (K, N)`` (or ``(N, K)`` with ``trans_B``), both float32, bfloat16,
  float16 or float8 e4m3, accumulated in float32 (no TF32), ReLU on the
  accumulator, returned in ``out_dtype`` (default: the inputs' type):
  float32, bfloat16, float16 or float8 e4m3. A float8 e4m3 output is NaN
  where the sum rounds past the format's range (|c| > 464), as in the
  JAX package.
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

On the card a float product takes one of three kernels of ``gemm.cu``
by a stated rule (``matmul_path``): bfloat16, float16 and fp8 operands
whose bases and row strides are 16-byte aligned take the TMA + wgmma
path (``tl_matmul_tma``, launches counted as ``matmul_tma``); float32
in and out, untransposed, aligned and divided by the block, the FFMA
tile the GEMM yardstick shares (``tl_matmul_ffma``, counted as
``matmul_ffma``); every other call (odd widths, unaligned views,
transposed or narrowed float32) the block tile loop of
``gemm_tile.cuh`` (``tl_matmul``, counted as ``matmul``, as int8 is).
The first two run at a block of ``carver.KERNEL_BLOCKS``
(``kernel_block``): the given ``block_M, block_N, block_K`` when they
are one, else the carver's first hint for the shape
(``MatmulTemplate(M, N, K, dtype).hints()``, as the JAX factory takes
its first) that is an instance, else ``DEFAULT_BLOCK``. fp8 operands on
the TMA path are first widened exactly to float16 by ``fp8_widen`` (one
launch for both, counted as ``fp8_widen``, into scratch the wrapper
allocates) and run the float16 kernel: the fp8 ``wgmma``'s own sums
fall short of the float32 contract (``csrc/gemm_sm90.cuh``).
``num_stages`` is accepted and ignored: the kernel takes as many stages
as a block's shared memory holds.

The wrapper launches the kernels on CUDA tensors (a build or launch
failure raises; there is no fallback) and runs the plain PyTorch version
(``matmul_plain``: upcast to float32, ``torch.matmul``, ReLU, cast by
``to_out``; int8 as an exact int64 product on the CPU, float64 on the
card) on CPU tensors. The tests and ``chip_smoke.py`` hold the kernels
against the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..carver import KERNEL_BLOCKS, MatmulTemplate, auto_arch
from ..resilience.errors import KernelLaunchError

__all__ = ["matmul", "matmul_plain", "matmul_kernel", "launches",
           "reset_launches", "to_out", "DTYPE_CODES", "FLOAT_TYPES",
           "matmul_path", "kernel_block", "DEFAULT_BLOCK", "fp8_widen",
           "fp8_widen_plain", "TMA_TYPES"]

# element types with their codes in the C launchers (gemm_tile.cuh DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2,
               torch.float16: 3, torch.int8: 4, torch.int32: 5}
# the float types the kernels take in and give out
FLOAT_TYPES = (torch.float32, torch.bfloat16, torch.float16,
               torch.float8_e4m3fn)
# the input types of the TMA path (csrc/gemm_sm90.cuh)
TMA_TYPES = (torch.bfloat16, torch.float16, torch.float8_e4m3fn)
_KERNEL_BLOCK = 128           # csrc/gemm_tile.cuh BM = BN
_GRID_X_MAX = 2 ** 31 - 1
# the block where the carver proposes no instance (no block of its space
# divides the shape): the JAX factory's fallback, (128, 128, 128), at the
# deepest K step of the instances
DEFAULT_BLOCK = (128, 128, 64)
_GRID_Y_MAX = 65535                     # tl_matmul_ffma's row blocks

# kernel name -> launches through its wrapper (chip_smoke.py zeroes and
# reads it around each call to prove the path used the kernel):
# "matmul" the block tile loop (gemm.cu's tl_matmul, gemm_s8.cu),
# "matmul_tma" the TMA + wgmma path, "fp8_widen" the widening of its
# fp8 operands, "matmul_ffma" the float32 FFMA tile
launches = {"matmul": 0, "matmul_tma": 0, "fp8_widen": 0,
            "matmul_ffma": 0}


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


def matmul_path(M: int, N: int, K: int, dtype, trans_A: bool = False,
                trans_B: bool = False, a_ptr: int = 0, b_ptr: int = 0,
                out_dtype=None, block=DEFAULT_BLOCK) -> str:
    """Which kernel of ``gemm.cu`` computes a float product on the card.
    The operands are aligned when their base addresses (``a_ptr``,
    ``b_ptr``) and row strides (A's ``M`` when ``trans_A`` else ``K``,
    B's ``K`` when ``trans_B`` else ``N`` elements) are multiples of 16
    bytes (``gemm_dense.cuh``'s ``dense_vec``):

    * ``"tma"`` (``tl_matmul_tma``): bfloat16, float16 or fp8 operands,
      aligned;
    * ``"ffma"`` (``tl_matmul_ffma``): float32 in and out, no transpose,
      aligned, and ``block`` (the call's ``kernel_block``) dividing M, N
      and K;
    * ``"loop"`` (``tl_matmul``): everything else."""
    dtype = _as_dtype(dtype)
    out = dtype if out_dtype is None else _as_dtype(out_dtype)
    if dtype not in TMA_TYPES + (torch.float32,) or min(M, N, K) < 1:
        return "loop"
    esize = torch.empty((), dtype=dtype).element_size()
    lda = M if trans_A else K
    ldb = K if trans_B else N
    aligned = (a_ptr % 16 == 0 and b_ptr % 16 == 0
               and lda * esize % 16 == 0 and ldb * esize % 16 == 0)
    if dtype in TMA_TYPES:
        return "tma" if aligned else "loop"
    bm, bn, bk = block
    tiles = (out == torch.float32 and not trans_A and not trans_B
             and M % bm == 0 and N % bn == 0 and K % bk == 0
             and M // bm <= _GRID_Y_MAX)
    return "ffma" if aligned and tiles else "loop"


# (M, N, K, dtype name, arch name) -> the carver's block (ranking the
# candidates on every call would cost more host time than a small GEMM)
_CARVER_BLOCKS = {}


def _carver_block(M, N, K, dtype_name, arch) -> Tuple[int, int, int]:
    key = (M, N, K, dtype_name, arch.name)
    if key not in _CARVER_BLOCKS:
        t = MatmulTemplate(M, N, K, dtype_name, arch=arch)
        # a dimension under the block space's least tile (a 16-row decode
        # step) gives candidates of its own width, which no kernel
        # instantiates: the first hint that is an instance
        blocks = [(h.config["block_M"], h.config["block_N"],
                   h.config["block_K"])
                  for h in t.hints(topk=len(t.candidates()))]
        _CARVER_BLOCKS[key] = next(
            (b for b in blocks if b in KERNEL_BLOCKS), DEFAULT_BLOCK)
    return _CARVER_BLOCKS[key]


def kernel_block(M: int, N: int, K: int, dtype, block_M=None,
                 block_N=None, block_K=None,
                 arch=None) -> Tuple[int, int, int]:
    """The block (bm, bn, bk) of the TMA and FFMA paths: the given block
    when it is one of ``KERNEL_BLOCKS``; otherwise (no block given, or
    one the kernels have no instance of) the carver's first hint for the
    shape on ``arch`` (default: the current card's) that is an instance,
    or ``DEFAULT_BLOCK`` where none is."""
    hint = (block_M, block_N, block_K)
    if hint in KERNEL_BLOCKS:
        return tuple(int(x) for x in hint)
    name = str(_as_dtype(dtype)).replace("torch.", "")
    return _carver_block(int(M), int(N), int(K), name, arch or auto_arch())


def fp8_widen_plain(a: torch.Tensor, b: torch.Tensor):
    """Plain version of ``fp8_widen``: both cast to float16 (exact)."""
    return a.to(torch.float16), b.to(torch.float16)


def fp8_widen(a: torch.Tensor, b: torch.Tensor):
    """fp8 e4m3 ``a`` and ``b`` as float16 tensors of the same shapes
    (exact: 3 mantissa bits, exponents inside float16's). On CUDA
    tensors (contiguous, 16-byte aligned) one launch of
    ``tl_widen_e4m3`` for both, into new tensors; on CPU tensors the
    plain version."""
    if a.dtype != torch.float8_e4m3fn or b.dtype != torch.float8_e4m3fn:
        raise TypeError(f"fp8_widen: want float8_e4m3fn operands, got "
                        f"{a.dtype}, {b.dtype}")
    if not a.is_cuda:
        return fp8_widen_plain(a, b)
    from ._build import load, stream_call
    a, b = a.contiguous(), b.contiguous()
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("fp8_widen: operands must start on 16 bytes")
    a16 = torch.empty(a.shape, dtype=torch.float16, device=a.device)
    b16 = torch.empty(b.shape, dtype=torch.float16, device=b.device)
    fn = load("gemm").tl_widen_e4m3
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong] * 2 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = stream_call(fn, a.device, a.data_ptr(), a16.data_ptr(),
                       a.numel(), b.data_ptr(), b16.data_ptr(), b.numel())
    if code != 0:
        raise KernelLaunchError("fp8_widen", code)
    launches["fp8_widen"] += 1
    return a16, b16


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


def _launch_tma(a, b, M, N, K, trans_A, trans_B, out, relu, blk, c):
    """The TMA path (``tl_matmul_tma``) into ``c``; fp8 operands widened
    to float16 first (``fp8_widen``)."""
    from ._build import load, stream_call
    if a.dtype == torch.float8_e4m3fn:
        a, b = fp8_widen(a, b)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = load("gemm").tl_matmul_tma
    fn.argtypes = [ptr] * 3 + [i32] * 3 + [i64] * 2 + [i32] * 8 + [ptr]
    fn.restype = ctypes.c_int
    code = stream_call(fn, a.device, a.data_ptr(), b.data_ptr(),
                       c.data_ptr(), M, N, K, M if trans_A else K,
                       K if trans_B else N, DTYPE_CODES[a.dtype],
                       int(trans_A), int(not trans_B), DTYPE_CODES[out],
                       int(bool(relu)), *blk)
    if code != 0:
        raise KernelLaunchError("matmul_tma", code)
    launches["matmul_tma"] += 1
    return c


def _launch_ffma(a, b, M, N, K, relu, blk, c):
    """The float32 FFMA tile (``tl_matmul_ffma``) into ``c``."""
    from ._build import load, stream_call
    fn = load("gemm").tl_matmul_ffma
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = stream_call(fn, a.device, a.data_ptr(), b.data_ptr(),
                       c.data_ptr(), M, N, K, int(bool(relu)), *blk)
    if code != 0:
        raise KernelLaunchError("matmul_ffma", code)
    launches["matmul_ffma"] += 1
    return c


def _launch(a, b, M, N, K, trans_A, trans_B, out, relu, block):
    from ._build import load, stream_call
    a, b = a.contiguous(), b.contiguous()
    c = torch.empty((M, N), dtype=out, device=a.device)
    if c.numel() == 0:
        return c
    if K == 0:
        return c.zero_()
    check_grid(M, N, "matmul")
    if a.dtype != torch.int8:
        blk = kernel_block(M, N, K, a.dtype, *block,
                           arch=auto_arch(a.device))
        path = matmul_path(M, N, K, a.dtype, trans_A, trans_B, a.data_ptr(),
                           b.data_ptr(), out, blk)
        if path == "tma":
            return _launch_tma(a, b, M, N, K, trans_A, trans_B, out, relu,
                               blk, c)
        if path == "ffma":
            return _launch_ffma(a, b, M, N, K, relu, blk, c)
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
    kernel ``matmul_path`` names, at ``kernel_block``'s block for the
    hints; CPU tensors run the plain version."""
    return _run(a, b, trans_A, trans_B, out_dtype, torch.float32, relu,
                (block_M, block_N, block_K))


def _run(a, b, trans_A, trans_B, out_dtype, accum_dtype, relu, block):
    _check(a, b, "matmul")
    out = _out_dtype(a.dtype, out_dtype, accum_dtype)
    M, N, K = _shapes(a, b, trans_A, trans_B)
    if a.is_cuda:
        return _launch(a, b, M, N, K, trans_A, trans_B, out, relu, block)
    return matmul_plain(a, b, trans_A, trans_B, out, relu)


def matmul_kernel(M, N, K, block_M=None, block_N=None, block_K=None,
                  in_dtype="bfloat16", out_dtype=None,
                  accum_dtype="float32", trans_A=False, trans_B=False,
                  relu=False, num_stages=2):
    """The JAX package's factory: a callable ``k(a, b)`` computing
    ``matmul`` for these shapes and types (a float32 accumulator for
    float inputs, int32 for int8), on the card at ``kernel_block``'s
    block for these hints."""
    in_dt = _as_dtype(in_dtype)
    out = _out_dtype(in_dt, out_dtype, accum_dtype)
    a_shape = (K, M) if trans_A else (M, K)
    b_shape = (N, K) if trans_B else (K, N)
    block = (block_M, block_N, block_K)

    def kernel(a, b):
        if tuple(a.shape) != a_shape or tuple(b.shape) != b_shape \
                or a.dtype != in_dt:
            raise ValueError(f"matmul_kernel: want a {a_shape}, b {b_shape}"
                             f" of {in_dt}, got {tuple(a.shape)}, "
                             f"{tuple(b.shape)} of {a.dtype}")
        return _run(a, b, trans_A, trans_B, out, accum_dtype, relu, block)

    return kernel
