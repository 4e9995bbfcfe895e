"""The hand-written yardstick kernels that the headline GEMM comparison
(``tilelang_mesh_tpu_torch/bench.py``) times the library's GEMMs
against.

Counterparts of the two hand-written Pallas kernels of ``bench.py``:

* ``hand_matmul(M, N, K, bm, bn, bk, dtype, out_dtype)`` —
  ``_hand_pallas_matmul``: a callable ``fn(a (M, K), b (K, N)) -> C (M,
  N)``, f32 accumulation, C in ``out_dtype`` (default: the inputs'
  type; else float32). Inputs float32, bfloat16, float16 or float8
  e4m3; an e4m3 output is NaN past the format's range, as the JAX
  package's cast gives it. ``csrc/yardstick_gemm.cu``: one block a (bm,
  bn) tile of C looping over K in steps of bk, instantiated for the
  blocks of ``carver.KERNEL_BLOCKS``; any other block, or M, N, K that
  the block does not divide, raises ``ValueError``.
* ``hand_w4a16(M, N, K, gs, bm, bn)`` — ``cfg_w4a16.hand_pallas``: a
  callable ``fn(alo, ahi, packed, scales3) -> C (M, N)`` bfloat16 with
  the JAX kernel's operands: the two halves of A (M, K/2) bfloat16
  (views of A's rows are taken as they are), the planar int4 weights
  (K/2, N) uint8 and the group scales (2, G2, N) float32, group size
  ``gs`` packed rows. Each weight ``(nibble - 8) * scale`` in float32 is
  rounded to bfloat16 before its product, as on the TPU.
  ``csrc/yardstick_w4a16.cu``, at the (bm, bn) pairs of
  ``KERNEL_BLOCKS``; its K step is 64 packed rows, so ``gs`` must be a
  multiple of 64.

Each callable launches its kernel on CUDA tensors (a build or launch
failure raises; there is no fallback) and runs the plain PyTorch version
(``hand_matmul_plain``, ``hand_w4a16_plain``) on CPU tensors. The
launches are counted in ``launches``.
"""

from __future__ import annotations

import ctypes

import torch

from ..carver import KERNEL_BLOCKS
from ..resilience.errors import KernelLaunchError
from .gemm import DTYPE_CODES, _as_dtype, to_out

__all__ = ["hand_matmul", "hand_matmul_plain", "hand_w4a16",
           "hand_w4a16_plain", "KERNEL_BLOCKS", "W4A16_TILES", "W4A16_BK",
           "launches", "reset_launches"]

# the (bm, bn) instances of yardstick_w4a16.cu and its K step
W4A16_TILES = frozenset((bm, bn) for bm, bn, _ in KERNEL_BLOCKS)
W4A16_BK = 64
_IN_TYPES = (torch.float32, torch.bfloat16, torch.float16,
             torch.float8_e4m3fn)
_GRID_Y_MAX = 65535

# kernel name -> launches through its wrapper (chip_smoke.py zeroes and
# reads these around the headline phase)
launches = {"yardstick_gemm": 0, "yardstick_w4a16": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x contiguous, starting on 16 bytes (the kernels' cp.async)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _blocks_check(M, N, bm, bn, what: str) -> None:
    if M % bm or N % bn:
        raise ValueError(f"{what}: M={M}, N={N} are not multiples of the "
                         f"block ({bm}, {bn})")
    if M // bm > _GRID_Y_MAX:
        raise ValueError(f"{what}: M={M} is past the grid's range at "
                         f"bm={bm}")


# ---------------------------------------------------------------------------
# #42 the GEMM yardstick
# ---------------------------------------------------------------------------


def hand_matmul_plain(a, b, out_dtype=None) -> torch.Tensor:
    """Plain version: upcast to float32, ``torch.matmul``, cast once to
    ``out_dtype`` (default: a's type)."""
    out = a.dtype if out_dtype is None else out_dtype
    return to_out(torch.matmul(a.float(), b.float()), out)


def _gemm_launch(a, b, M, N, K, blk, out):
    from ._build import load, stream_call
    a, b = _aligned(a), _aligned(b)
    c = torch.empty((M, N), dtype=out, device=a.device)
    fn = load("yardstick_gemm").tl_yardstick_gemm
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = stream_call(fn, a.device, a.data_ptr(), b.data_ptr(),
                       c.data_ptr(), M, N, K, *blk, DTYPE_CODES[a.dtype],
                       DTYPE_CODES[out])
    if code != 0:
        raise KernelLaunchError("yardstick_gemm", code)
    launches["yardstick_gemm"] += 1
    return c


def hand_matmul(M, N, K, bm, bn, bk, dtype="bfloat16", out_dtype=None):
    """The GEMM yardstick for fixed shapes, types and block: a callable
    ``fn(a (M, K), b (K, N)) -> C (M, N)``."""
    in_dt = _as_dtype(dtype)
    out = in_dt if out_dtype is None else _as_dtype(out_dtype)
    if in_dt not in _IN_TYPES:
        raise TypeError(f"hand_matmul: {in_dt} inputs are not ported "
                        f"(float32, bfloat16, float16, float8_e4m3fn)")
    if out not in (in_dt, torch.float32):
        raise TypeError(f"hand_matmul: {in_dt} -> {out} is not ported "
                        f"(the inputs' type or float32)")
    blk = (int(bm), int(bn), int(bk))
    if blk not in KERNEL_BLOCKS:
        raise ValueError(f"hand_matmul: block {blk} is not one of the "
                         f"kernel's instances {sorted(KERNEL_BLOCKS)}")
    if K % bk:
        raise ValueError(f"hand_matmul: K={K} is not a multiple of "
                         f"bk={bk}")
    _blocks_check(M, N, bm, bn, "hand_matmul")

    def fn(a, b):
        if tuple(a.shape) != (M, K) or tuple(b.shape) != (K, N) \
                or a.dtype != in_dt or b.dtype != in_dt:
            raise ValueError(f"hand_matmul: want a {(M, K)}, b {(K, N)} "
                             f"of {in_dt}, got {tuple(a.shape)} of "
                             f"{a.dtype}, {tuple(b.shape)} of {b.dtype}")
        if a.device != b.device:
            raise ValueError(f"hand_matmul: operands must share a device,"
                             f" got {a.device}, {b.device}")
        if a.is_cuda:
            return _gemm_launch(a, b, M, N, K, blk, out)
        return hand_matmul_plain(a, b, out)

    return fn


# ---------------------------------------------------------------------------
# #43 the w4a16 yardstick
# ---------------------------------------------------------------------------


def hand_w4a16_plain(alo, ahi, packed, scales3, gs: int) -> torch.Tensor:
    """Plain version: each half's weights ``(nibble - 8) * scale`` in
    float32 rounded to bfloat16, ``alo @ bl + ahi @ bh`` in float32,
    cast once to bfloat16."""
    K2 = packed.shape[0]
    g = torch.arange(K2, device=packed.device) // gs
    s = scales3.float()
    p = packed.to(torch.int32)
    bl = (((p & 0xF).float() - 8.0) * s[0][g]).to(torch.bfloat16)
    bh = ((((p >> 4) & 0xF).float() - 8.0) * s[1][g]).to(torch.bfloat16)
    acc = torch.matmul(alo.float(), bl.float()) + torch.matmul(
        ahi.float(), bh.float())
    return acc.to(torch.bfloat16)


def _w4a16_launch(alo, ahi, packed, scales3, M, N, K2, gs, bm, bn):
    from ._build import load, stream_call
    lda = alo.stride(0)
    if (alo.stride(1) != 1 or ahi.stride(1) != 1 or ahi.stride(0) != lda
            or lda % 8 or alo.data_ptr() % 16 or ahi.data_ptr() % 16):
        alo, ahi = _aligned(alo), _aligned(ahi)
        lda = K2
    packed, scales3 = _aligned(packed), _aligned(scales3)
    c = torch.empty((M, N), dtype=torch.bfloat16, device=alo.device)
    fn = load("yardstick_w4a16").tl_yardstick_w4a16
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] + [
        ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = stream_call(fn, alo.device, alo.data_ptr(), ahi.data_ptr(), lda,
                       packed.data_ptr(), scales3.data_ptr(), c.data_ptr(),
                       M, N, K2, gs, bm, bn)
    if code != 0:
        raise KernelLaunchError("yardstick_w4a16", code)
    launches["yardstick_w4a16"] += 1
    return c


def hand_w4a16(M, N, K, gs, bm, bn):
    """The w4a16 yardstick for fixed shapes, group size and tile: a
    callable ``fn(alo, ahi, packed, scales3) -> C (M, N)`` bfloat16."""
    if K % 2:
        raise ValueError(f"hand_w4a16: K={K} is odd")
    K2 = K // 2
    if gs < 1 or K2 % gs:
        raise ValueError(f"hand_w4a16: group size {gs} does not divide "
                         f"K/2={K2}")
    if gs % W4A16_BK:
        raise ValueError(f"hand_w4a16: group size {gs} is not a multiple "
                         f"of the kernel's K step {W4A16_BK}")
    if (bm, bn) not in W4A16_TILES:
        raise ValueError(f"hand_w4a16: tile {(bm, bn)} is not one of the "
                         f"kernel's instances {sorted(W4A16_TILES)}")
    _blocks_check(M, N, bm, bn, "hand_w4a16")
    G2 = K2 // gs

    def fn(alo, ahi, packed, scales3):
        if tuple(alo.shape) != (M, K2) or tuple(ahi.shape) != (M, K2) \
                or alo.dtype != torch.bfloat16 \
                or ahi.dtype != torch.bfloat16 \
                or tuple(packed.shape) != (K2, N) \
                or packed.dtype != torch.uint8 \
                or tuple(scales3.shape) != (2, G2, N) \
                or scales3.dtype != torch.float32:
            raise ValueError(
                f"hand_w4a16: want alo, ahi {(M, K2)} bfloat16, packed "
                f"{(K2, N)} uint8, scales {(2, G2, N)} float32; got "
                f"{tuple(alo.shape)} {alo.dtype}, {tuple(ahi.shape)} "
                f"{ahi.dtype}, {tuple(packed.shape)} {packed.dtype}, "
                f"{tuple(scales3.shape)} {scales3.dtype}")
        if len({alo.device, ahi.device, packed.device,
                scales3.device}) != 1:
            raise ValueError("hand_w4a16: operands must share a device")
        if alo.is_cuda:
            return _w4a16_launch(alo, ahi, packed, scales3, M, N, K2, gs,
                                 bm, bn)
        return hand_w4a16_plain(alo, ahi, packed, scales3, gs)

    return fn
