"""Low-bit GEMMs on the card: w4a16 (fused and two-pass) and w4a8.

Counterpart of ``tilelang_mesh_tpu/ops/dequant_gemm.py``, with its weight
layout: int4 weights in the *planar +8-bias* pack, ``packed[k2, n] =
(q[K/2 + k2] + 8) << 4 | (q[k2] + 8)``, so the low nibbles are B's rows
[0, K/2) and the high nibbles rows [K/2, K); group scales ``(2 G2, N)``
float32, the low half's G2 rows first. CUDA kernels of
``csrc/dequant_gemm.cu`` replace the TPU's three:

* ``dequant_matmul`` — ``dequant_gemm_kernel``, fused w4a16: ``a (M,
  K)`` float32, bfloat16 or float16 times B unpacked in the kernel, each weight
  ``(nibble - 8) * scale`` in float32 rounded to a's type, float32
  accumulation, returned in a's type. ``dequant_path`` picks the kernel:
  for bfloat16 / float16 a split-K stream of the weights up to
  ``SPLITK_MAX_ROWS`` rows (``dequant_gemm_splitk``, planned by
  ``dequant_splitk_plan``, then ``dequant_splitk_combine`` adds the
  splits in order), TMA + ``wgmma`` with the unpack in the kernel for
  more (``dequant_gemm_wgmma``); float32 and operands neither takes run
  the block tile loop of ``csrc/gemm_tile.cuh`` (``dequant_gemm``).
* ``dequant_int4`` — ``dequant_int4_kernel``: the unpacked ``B (K, N)``
  in float32, bfloat16 or float16, the same values. ``dequant_matmul_twopass``
  runs it, then ``ops/gemm.py``'s ``matmul``.
* ``w4a8_matmul`` — ``w4a8_gemm_kernel``: per-token int8 activations
  (``ops/bitnet.py::quantize_activations``) times the int4 weights with
  exact int32 sums, then ``acc * s_act[m] * s_w[n]`` in float32, with
  per-channel weight scales from ``quantize_w4_per_channel``.
  ``w4a8_path`` picks the kernel: TMA + 8-bit ``wgmma`` with the unpack
  in the kernel on aligned operands at any row count (``w4a8_gemm_tma``),
  the block tile loop for the rest (``w4a8_gemm``); both give the same
  bits.

The host packers (``quantize_w4_per_channel``, ``pack_planar``,
``unpack_planar``, ``pack_reference``, ``repack_from_reference``) are
numpy copies of the JAX package's; ``dequant_gemm_kernel`` is its
shape-fixed factory. The group-size rules and their errors are the
JAX package's (``AssertionError``, ``TypeError`` for scales of the
wrong size, ``ValueError`` from the two-pass path). The ``block_*`` and
``num_stages`` arguments are the TPU's tiling hints: they are accepted
and ignored, except where the JAX package derives the group size from
them.

Each wrapper launches its kernel on CUDA tensors (a build or launch
failure raises; there is no fallback) and runs its plain PyTorch version
(``*_plain``) on CPU tensors. Weights and scales may be numpy arrays;
they move to the activations' device.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..resilience.errors import KernelLaunchError
from .bitnet import _cdiv, _sms, quantize_activations
from .gemm import DTYPE_CODES, _as_dtype, check_grid, matmul
from ._factory import bind

__all__ = ["dequant_matmul", "dequant_matmul_plain", "dequant_gemm_kernel",
           "dequant_int4", "dequant_int4_plain", "dequant_matmul_twopass",
           "w4a8_matmul", "w4a8_gemm", "w4a8_gemm_plain",
           "quantize_w4_per_channel", "pack_planar", "unpack_planar",
           "pack_reference", "repack_from_reference", "launches",
           "reset_launches", "dequant_int4_kernel", "w4a8_gemm_kernel",
           "dequant_path", "dequant_splitk_plan", "dequant_wgmma_tile",
           "SPLITK_MAX_ROWS", "WGMMA_WIDE_ROWS", "w4a8_path"]

_A_DTYPES = (torch.float32, torch.bfloat16, torch.float16)

# kernel name -> launches through its wrapper (chip_smoke.py zeroes and
# reads these around each call to prove the path used the kernels); the
# fused w4a16's block tile loop keeps the kernel's first name
launches = {"dequant_gemm": 0, "dequant_gemm_splitk": 0,
            "dequant_splitk_combine": 0, "dequant_gemm_wgmma": 0,
            "dequant_int4": 0, "w4a8_gemm_tma": 0, "w4a8_gemm": 0}

# A rows up to which dequant_path takes the split-K kernel: two n8 tiles
# of mma.sync (PERF.md, PR 19: timed against the TMA kernel)
SPLITK_MAX_ROWS = 16
# A rows up to which the TMA kernel takes its 128-row tile (PERF.md, PR
# 19: the 256-row tile is ahead from 1024 rows on, behind at 512)
WGMMA_WIDE_ROWS = 512
# packed rows a split-K block at most: A's pairs take 64 bytes a row of
# shared memory (48 KB), beside the warps' 48 KB of weight rings
_SPLITK_MAX_BLOCK_ROWS = 768


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _on(x, device: torch.device) -> torch.Tensor:
    """x (numpy or torch) as a tensor on ``device``; a tensor elsewhere
    raises."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)
    if x.device != device:
        raise ValueError(f"operands must share a device, got {x.device}, "
                         f"{device}")
    return x


def _check_device(dev: torch.device, what: str) -> None:
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{what}: unsupported device {dev}")


def _check_weights(packed, scales, what: str) -> None:
    if packed.dtype != torch.uint8 or scales.dtype != torch.float32:
        raise TypeError(f"{what}: want packed uint8 and scales float32, "
                        f"got {packed.dtype}, {scales.dtype}")


def _scales_2d(scales, G2: int, N: int) -> torch.Tensor:
    """scales as (2 G2, N), or the reshape error the JAX package's
    ``reshape(2, G2, N)`` raises."""
    if scales.numel() != 2 * G2 * N:
        raise TypeError(f"cannot reshape array of shape "
                        f"{tuple(scales.shape)} (size {scales.numel()}) "
                        f"into shape (2, {G2}, {N}) (size {2 * G2 * N})")
    return scales.reshape(2 * G2, N).contiguous()


# ---------------------------------------------------------------------------
# the int4 unpack (#23)
# ---------------------------------------------------------------------------


def dequant_int4_plain(packed, scales, group_size: int,
                       out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version: ``(nibble - 8) * scale`` in float32, the low
    nibbles as rows [0, K2), the high as [K2, 2 K2), cast to
    ``out_dtype``."""
    K2, N = packed.shape
    g = torch.arange(K2, device=packed.device) // group_size
    s = scales.reshape(2, -1, N).float()
    p = packed.to(torch.int32)
    lo = ((p & 0xF).float() - 8.0) * s[0][g]
    hi = (((p >> 4) & 0xF).float() - 8.0) * s[1][g]
    return torch.cat([lo, hi]).to(out_dtype)


def _dequant_int4_launch(packed, scales, gs, out_dtype):
    from ._build import load, stream_call
    K2, N = packed.shape
    out = torch.empty((2 * K2, N), dtype=out_dtype, device=packed.device)
    if out.numel() == 0:
        return out
    fn = load("dequant_gemm").tl_dequant_int4
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = stream_call(fn, packed.device, packed.data_ptr(),
                       scales.data_ptr(), out.data_ptr(), K2, N, gs,
                       DTYPE_CODES[out_dtype])
    if code != 0:
        raise KernelLaunchError("dequant_int4", code)
    launches["dequant_int4"] += 1
    return out


def dequant_int4(packed, scales, group_size: int,
                 out_dtype=torch.bfloat16) -> torch.Tensor:
    """packed (K2, N) uint8 planar + scales (2 K2 / group_size rows, N)
    float32 -> B (2 K2, N) in float32, bfloat16 or float16. CUDA tensors
    launch the kernel; CPU tensors run the plain version."""
    if out_dtype not in _A_DTYPES:
        raise TypeError(f"dequant_int4: output {out_dtype} is not ported "
                        f"(float32, bfloat16 or float16)")
    _check_device(packed.device, "dequant_int4")
    scales = _on(scales, packed.device)
    _check_weights(packed, scales, "dequant_int4")
    K2, N = packed.shape
    if group_size < 1 or K2 % group_size:
        raise ValueError(f"dequant_int4: group_size {group_size} does not "
                         f"divide K/2={K2}")
    scales = _scales_2d(scales, K2 // group_size, N)
    if packed.is_cuda:
        return _dequant_int4_launch(packed.contiguous(), scales, group_size,
                                    out_dtype)
    return dequant_int4_plain(packed, scales, group_size, out_dtype)


# ---------------------------------------------------------------------------
# fused w4a16 (#22)
# ---------------------------------------------------------------------------


def dequant_matmul_plain(a, packed, scales, group_size: int) -> torch.Tensor:
    """Plain version: B unpacked and rounded to a's type
    (``dequant_int4_plain``), then ``a @ B`` in float32, cast to a's
    type."""
    bd = dequant_int4_plain(packed, scales, group_size, a.dtype)
    return torch.matmul(a.float(), bd.float()).to(a.dtype)


def dequant_path(M: int, N: int, K2: int, gs: int, dtype, a_ptr: int = 0,
                 packed_ptr: int = 0, scales_ptr: int = 0) -> str:
    """Which kernel of ``dequant_gemm.cu`` computes the fused w4a16 on
    the card (a (M, 2 K2) of ``dtype`` at ``a_ptr``, packed (K2, N) at
    ``packed_ptr``, scales at ``scales_ptr``, group size ``gs``):

    * ``"splitk"`` (``tl_dequant_gemm_splitk``, then
      ``tl_dequant_splitk_combine``): bfloat16 or float16, M up to
      ``SPLITK_MAX_ROWS``, gs a multiple of 8;
    * ``"wgmma"`` (``tl_dequant_gemm_wgmma``): bfloat16 or float16, more
      rows, gs a multiple of 64 (a 64-row k tile lies in one group);
    * both need N a multiple of 16 and the three bases on 16 bytes;
    * ``"loop"`` (``tl_dequant_gemm``): everything else, float32
      included."""
    dtype = _as_dtype(dtype)
    if dtype not in (torch.bfloat16, torch.float16) \
            or min(M, N, K2, gs) < 1 or N % 16 \
            or (a_ptr | packed_ptr | scales_ptr) % 16:
        return "loop"
    if M <= SPLITK_MAX_ROWS:
        return "splitk" if gs % 8 == 0 else "loop"
    return "wgmma" if gs % 64 == 0 else "loop"


def dequant_wgmma_tile(M: int):
    """The TMA kernel's tile ``(TM, TN, TK2)``: 128 x 128 with 64 packed
    rows a stage up to ``WGMMA_WIDE_ROWS`` rows (more blocks in flight),
    256 x 128 with 32 past it (the unpack and the A traffic of a tile
    spread over twice the rows; PERF.md, PR 19)."""
    return (128, 128, 64) if M <= WGMMA_WIDE_ROWS else (256, 128, 32)


def dequant_splitk_plan(N: int, K2: int, sms: int):
    """The split-K kernel's grid: ``(strips, splits, rows_per_block)``. A
    block owns 128 columns (``strips = ceil(N / 128)``) and
    ``rows_per_block`` packed rows (a multiple of 64: 8 warps of 8-row
    steps; at most 768, A's pairs in 48 KB), about two blocks an SM in
    all: ``rows_per_block = ceil(K2 / max(1, 2 sms // strips))`` rounded
    up to 64 and clamped to [64, 768], ``splits = ceil(K2 /
    rows_per_block)``. The combine adds the splits in split order."""
    strips = _cdiv(N, 128)
    rows = _cdiv(K2, max(1, 2 * sms // strips))
    rows = min(_SPLITK_MAX_BLOCK_ROWS, max(64, _cdiv(rows, 64) * 64))
    return strips, _cdiv(K2, rows), rows


def _call(fn, name, dev, ptrs, ints):
    """``fn(*ptrs, *ints, stream)``; raises KernelLaunchError(name) on a
    refusal."""
    from ._build import stream_call
    fn.argtypes = [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * len(
        ints) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = stream_call(fn, dev, *ptrs, *ints)
    if code != 0:
        raise KernelLaunchError(name, code)


def _dequant_gemm_launch(a, packed, scales, gs):
    from ._build import load
    M, K = a.shape
    K2, N = packed.shape
    c = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if c.numel() == 0:
        return c
    if K2 == 0:
        return c.zero_()
    lib = load("dequant_gemm")
    code = DTYPE_CODES[a.dtype]
    path = dequant_path(M, N, K2, gs, a.dtype, a.data_ptr(),
                        packed.data_ptr(), scales.data_ptr())
    if path == "splitk":
        _, splits, rows = dequant_splitk_plan(N, K2, _sms(a.device))
        ws = torch.empty((splits, M, N), dtype=torch.float32,
                         device=a.device)
        _call(lib.tl_dequant_gemm_splitk, "dequant_gemm_splitk", a.device,
              (a.data_ptr(), packed.data_ptr(), scales.data_ptr(),
               ws.data_ptr()), (M, N, K2, gs, rows, splits, code))
        launches["dequant_gemm_splitk"] += 1
        _call(lib.tl_dequant_splitk_combine, "dequant_splitk_combine",
              a.device, (ws.data_ptr(), c.data_ptr()), (M, N, splits, code))
        launches["dequant_splitk_combine"] += 1
        return c
    ptrs = (a.data_ptr(), packed.data_ptr(), scales.data_ptr(), c.data_ptr())
    if path == "wgmma":
        _call(lib.tl_dequant_gemm_wgmma, "dequant_gemm_wgmma", a.device,
              ptrs, (M, N, K2, gs, code, *dequant_wgmma_tile(M)))
        launches["dequant_gemm_wgmma"] += 1
        return c
    check_grid(M, N, "dequant_matmul")
    _call(lib.tl_dequant_gemm, "dequant_gemm", a.device, ptrs,
          (M, N, K2, gs, code))
    launches["dequant_gemm"] += 1
    return c


def _dequant_gemm(a, packed, scales, gs):
    """a (M, K) @ unpack(packed, scales (2 G2, N)) at group size gs."""
    if a.dtype not in _A_DTYPES:
        raise TypeError(f"dequant_matmul: activations {a.dtype} are not "
                        f"ported (float32, bfloat16 or float16)")
    _check_device(a.device, "dequant_matmul")
    if a.is_cuda:
        return _dequant_gemm_launch(a.contiguous(), packed.contiguous(),
                                    scales, gs)
    return dequant_matmul_plain(a, packed, scales, gs)


def dequant_matmul(a, packed, scales, group_size=None, block_M=128,
                   block_N=128, block_K2=128):
    """a (M, K) float32, bfloat16 or float16; packed (K/2, N) uint8 planar;
    scales (2G, N) float32 -> (M, N) in a's type. The group size is
    ``min(block_K2, K/2)``, and ``group_size`` must agree with it (the
    JAX package's rule). CUDA tensors launch the kernel; CPU tensors run
    the plain version."""
    M, K = a.shape
    packed, scales = _on(packed, a.device), _on(scales, a.device)
    _check_weights(packed, scales, "dequant_matmul")
    K2, N = packed.shape
    if K != 2 * K2:
        raise AssertionError(f"dequant_matmul: K={K} is not 2 x K/2={K2}")
    bk2 = min(block_K2, K2)
    gs = min(group_size or bk2, K2)
    if gs != bk2:
        raise AssertionError("group_size must equal block_K2 (one scale row "
                             "per tile)")
    if K2 % bk2:
        raise AssertionError(f"K/2={K2} is not a multiple of block_K2="
                             f"{bk2}")
    return _dequant_gemm(a, packed, _scales_2d(scales, K2 // bk2, N), gs)


def dequant_gemm_kernel(M, N, K, block_M=128, block_N=128, block_K2=128,
                        group_size=None, in_dtype="bfloat16",
                        accum_dtype="float32", num_stages=2):
    """The JAX package's factory: ``k(A (M, 2, K/2), Bp (K/2, N), S (2,
    G2, N)) -> C (M, N)`` in ``in_dtype``, group size ``block_K2``."""
    K2 = K // 2
    gs = group_size or block_K2
    if gs != block_K2:
        raise AssertionError("group_size must equal block_K2 (one scale row "
                             "per tile)")
    if K2 % block_K2:
        raise AssertionError(f"K/2={K2} is not a multiple of block_K2="
                             f"{block_K2}")
    G2 = K2 // gs
    in_dt = _as_dtype(in_dtype)

    def kernel(a, packed, scales):
        if tuple(a.shape) != (M, 2, K2) or a.dtype != in_dt \
                or tuple(packed.shape) != (K2, N) \
                or tuple(scales.shape) != (2, G2, N):
            raise ValueError(f"dequant_gemm_kernel: want A {(M, 2, K2)} of "
                             f"{in_dt}, Bp {(K2, N)}, S {(2, G2, N)}; got "
                             f"{tuple(a.shape)} of {a.dtype}, "
                             f"{tuple(packed.shape)}, {tuple(scales.shape)}")
        packed, scales = _on(packed, a.device), _on(scales, a.device)
        _check_weights(packed, scales, "dequant_gemm_kernel")
        return _dequant_gemm(a.reshape(M, K), packed,
                             scales.reshape(2 * G2, N).contiguous(), gs)

    return kernel


# ---------------------------------------------------------------------------
# two-pass w4a16: #23, then ops/gemm.py's matmul (#15)
# ---------------------------------------------------------------------------


def dequant_matmul_twopass(a, packed, scales, block_M=1024, block_N=1024,
                           block_K=512, dq_block=512, num_stages=2):
    """Two-pass w4a16: B unpacked once into a's type (``dequant_int4``),
    then ``matmul(a, B)``. The group size is read from the scales' shape
    and must equal ``min(dq_block, K/2, group size)`` (the JAX package's
    rule). The fused ``dequant_matmul`` is the skinny-M (decode) kernel;
    this is the prefill one."""
    M, K = a.shape
    packed, scales = _on(packed, a.device), _on(scales, a.device)
    K2, N = packed.shape
    if K != 2 * K2:
        raise AssertionError(f"dequant_matmul_twopass: K={K} is not 2 x "
                             f"K/2={K2}")
    gs = 2 * K2 // scales.shape[0] if scales.dim() == 2 else \
        K2 // scales.shape[1]
    if K2 % gs:
        raise AssertionError(f"scales rows {tuple(scales.shape)} do not "
                             f"evenly group K/2={K2}")
    dq_blk = min(dq_block, K2, gs)
    if dq_blk != gs:
        raise ValueError(
            f"dequant_matmul_twopass needs group_size ({gs}) == dequant "
            f"tile ({dq_blk}); re-quantize with group_size={dq_blk} or "
            f"pass dq_block={gs}")
    if a.dtype not in _A_DTYPES:
        raise TypeError(f"dequant_matmul_twopass: activations {a.dtype} are"
                        f" not ported (float32, bfloat16 or float16)")
    bd = dequant_int4(packed, scales, gs, a.dtype)
    return matmul(a, bd)


# ---------------------------------------------------------------------------
# w4a8 (#24)
# ---------------------------------------------------------------------------


def w4a8_gemm_plain(q, packed, w_scales, a_scales) -> torch.Tensor:
    """Plain version: the exact integer product (in float64, exact for
    |sums| < 2**53), as float32, times ``a_scales[m]`` then
    ``w_scales[n]``."""
    M = q.shape[0]
    K2, N = packed.shape
    p = packed.to(torch.int32)
    wd = torch.cat([(p & 0xF) - 8, ((p >> 4) & 0xF) - 8]).double()
    acc = torch.matmul(q.reshape(M, 2 * K2).double(), wd).float()
    return acc * a_scales.reshape(M, 1).float() * \
        w_scales.reshape(1, N).float()


def w4a8_path(M: int, N: int, K2: int, q_ptr: int = 0, packed_ptr: int = 0,
              sw_ptr: int = 0) -> str:
    """Which kernel of ``dequant_gemm.cu`` computes w4a8 on the card (q
    (M, 2 K2) int8 at ``q_ptr``, packed (K2, N) at ``packed_ptr``, the
    weight scales at ``sw_ptr``):

    * ``"tma"`` (``tl_w4a8_gemm_wgmma``): K2 and N multiples of 16 and the
      three bases on 16 bytes (the tensor maps' strides, the 16-byte scale
      and output stores), at any row count: the sweep over M (1 to 4096
      at K = N = 4096, ``scripts/streamk_w4a8_ab.py``) found it ahead of
      the tile loop at every one on an H100 (PERF.md §6 row 24), so no
      row threshold;
    * ``"loop"`` (``tl_w4a8_gemm``): everything else."""
    if min(M, N, K2) < 1 or K2 % 16 or N % 16 \
            or (q_ptr | packed_ptr | sw_ptr) % 16:
        return "loop"
    return "tma"


def _w4a8_launch(q, packed, sw, sa):
    from ._build import load, stream_call
    M = q.shape[0]
    K2, N = packed.shape
    c = torch.empty((M, N), dtype=torch.float32, device=q.device)
    if c.numel() == 0:
        return c
    if K2 == 0:
        return c.zero_()
    check_grid(M, N, "w4a8_matmul")
    path = w4a8_path(M, N, K2, q.data_ptr(), packed.data_ptr(),
                     sw.data_ptr())
    entry, name = (("tl_w4a8_gemm_wgmma", "w4a8_gemm_tma") if path == "tma"
                   else ("tl_w4a8_gemm", "w4a8_gemm"))
    fn = getattr(load("dequant_gemm"), entry)
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = stream_call(fn, q.device, q.data_ptr(), packed.data_ptr(),
                       sw.data_ptr(), sa.data_ptr(), c.data_ptr(), M, N, K2)
    if code != 0:
        raise KernelLaunchError(name, code)
    launches[name] += 1
    return c


def w4a8_gemm(q, packed, w_scales, a_scales) -> torch.Tensor:
    """q (M, K) or (M, 2, K/2) int8 x packed (K/2, N) uint8 planar ->
    (M, N) float32 = int32 sums * a_scales[m] * w_scales[n] (both
    float32, (M,) or (M, 1) and (N,) or (1, N)). CUDA tensors launch the
    kernel; CPU tensors run the plain version."""
    _check_device(q.device, "w4a8_gemm")
    packed = _on(packed, q.device)
    w_scales, a_scales = _on(w_scales, q.device), _on(a_scales, q.device)
    M = q.shape[0]
    K2, N = packed.shape
    if q.dtype != torch.int8 or packed.dtype != torch.uint8 \
            or w_scales.dtype != torch.float32 \
            or a_scales.dtype != torch.float32:
        raise TypeError(f"w4a8_gemm: want int8, uint8, float32, float32; "
                        f"got {q.dtype}, {packed.dtype}, {w_scales.dtype}, "
                        f"{a_scales.dtype}")
    if q.numel() != M * 2 * K2 or w_scales.numel() != N \
            or a_scales.numel() != M:
        raise ValueError(f"w4a8_gemm: q {tuple(q.shape)}, packed "
                         f"{tuple(packed.shape)}, w_scales "
                         f"{tuple(w_scales.shape)} and a_scales "
                         f"{tuple(a_scales.shape)} do not fit")
    if q.is_cuda:
        return _w4a8_launch(q.reshape(M, 2 * K2).contiguous(),
                            packed.contiguous(),
                            w_scales.reshape(N).contiguous(),
                            a_scales.reshape(M).contiguous())
    return w4a8_gemm_plain(q, packed, w_scales, a_scales)


def w4a8_matmul(x, packed, w_scales, block_M=128, block_N=128,
                block_K2=256, num_stages=2):
    """x (M, K) float -> per-token int8 (``quantize_activations``) -> the
    w4a8 GEMM -> (M, N) float32. Weights come from
    :func:`quantize_w4_per_channel`."""
    M, K = x.shape
    packed = _on(packed, x.device)
    K2, N = packed.shape
    if K != 2 * K2:
        raise AssertionError(f"w4a8_matmul: K={K} is not 2 x K/2={K2}")
    w_scales = _on(w_scales, x.device)
    if w_scales.numel() != N:
        raise TypeError(f"cannot reshape array of shape "
                        f"{tuple(w_scales.shape)} (size {w_scales.numel()})"
                        f" into shape (1, {N}) (size {N})")
    q, a_scale = quantize_activations(x)
    return w4a8_gemm(q, packed, w_scales, (1.0 / a_scale).float())


# ---------------------------------------------------------------------------
# host packers (numpy)
# ---------------------------------------------------------------------------


def quantize_w4_per_channel(w):
    """Per-output-channel symmetric int4 quantization of (K, N) f32
    weights in the planar pack: returns (packed (K/2, N) uint8,
    scales (N,) f32) with rows [0, K/2) in the low nibble."""
    K, N = w.shape
    assert K % 2 == 0
    scales = np.maximum(np.abs(w).max(0), 1e-8) / 7.0
    q = np.clip(np.round(w / scales), -8, 7).astype(np.int32)
    return pack_planar(q), scales.astype(np.float32)


def pack_planar(q):
    """Pack (K, N) int4 values (``-8..7``) into the planar +8-bias
    layout: ``packed[k2, n] = (q[K/2+k2]+8) << 4 | (q[k2]+8)``."""
    q = np.asarray(q, np.int32)
    K = q.shape[0]
    assert K % 2 == 0
    lo, hi = q[:K // 2] + 8, q[K // 2:] + 8
    return ((hi << 4) | lo).astype(np.uint8)


def unpack_planar(packed):
    """Inverse of :func:`pack_planar`: (K/2, N) uint8 planar bytes back
    to (K, N) int32 values in ``-8..7``."""
    b = np.asarray(packed, np.int32)
    lo = (b & 0xF) - 8
    hi = ((b >> 4) & 0xF) - 8
    return np.concatenate([lo, hi], axis=0)


def pack_reference(q):
    """Pack (K, N) int4 values into the reference layout: per-row
    K-interleaved two's complement — ``packed[k, n]`` holds row ``2k``
    in the low nibble and row ``2k+1`` in the high nibble, each as the
    signed value's 4-bit two's-complement pattern. For tests and
    checkpoint export; the kernels never consume this layout."""
    q = np.asarray(q, np.int32)
    K = q.shape[0]
    assert K % 2 == 0
    even, odd = q[0::2] & 0xF, q[1::2] & 0xF
    return ((odd << 4) | even).astype(np.uint8)


def repack_from_reference(packed_ref):
    """Reference-packed int4 weights (see :func:`pack_reference`) in the
    planar +8-bias layout the kernels consume: a byte permutation plus
    the bias, no requantization, so it round-trips exactly."""
    b = np.asarray(packed_ref, np.int32)
    # two's-complement nibble -> signed: values >= 8 wrap negative
    even = (b & 0xF)
    odd = ((b >> 4) & 0xF)
    even = np.where(even >= 8, even - 16, even)
    odd = np.where(odd >= 8, odd - 16, odd)
    q = np.empty((2 * b.shape[0],) + b.shape[1:], np.int32)
    q[0::2] = even
    q[1::2] = odd
    return pack_planar(q)


def dequant_int4_kernel(K2, N, block_K2=512, block_N=512,
                        out_dtype="bfloat16"):
    """The unpack bound to one shape (the JAX factory's arguments, group
    size ``block_K2``): ``fn(Bp (K2, N) uint8, S (2, G2, N) float32) ->
    Bd (2 K2, N)`` in ``out_dtype``."""
    out_dt = _as_dtype(out_dtype)
    G2 = K2 // block_K2
    return bind("dequant_int4_kernel",
                [((K2, N), torch.uint8), ((2, G2, N), torch.float32)],
                lambda packed, scales: dequant_int4(
                    packed, scales.reshape(2 * G2, N), block_K2, out_dt))


def w4a8_gemm_kernel(M, N, K, block_M=128, block_N=128, block_K2=256,
                     num_stages=2):
    """The w4a8 kernel bound to one shape (the JAX factory's arguments):
    ``fn(A (M, 2, K/2) int8, Bp (K/2, N) uint8, Sw (1, N), Sa (M, 1)
    float32) -> C (M, N)`` float32."""
    K2 = K // 2
    return bind("w4a8_gemm_kernel",
                [((M, 2, K2), torch.int8), ((K2, N), torch.uint8),
                 ((1, N), torch.float32), ((M, 1), torch.float32)],
                w4a8_gemm)
