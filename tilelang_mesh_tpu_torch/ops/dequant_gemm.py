"""Low-bit GEMMs on the card: w4a16 (fused and two-pass) and w4a8.

Counterpart of ``tilelang_mesh_tpu/ops/dequant_gemm.py``, with its weight
layout: int4 weights in the *planar +8-bias* pack, ``packed[k2, n] =
(q[K/2 + k2] + 8) << 4 | (q[k2] + 8)``, so the low nibbles are B's rows
[0, K/2) and the high nibbles rows [K/2, K); group scales ``(2 G2, N)``
float32, the low half's G2 rows first. Three CUDA kernels
(``csrc/dequant_gemm.cu``, on the block tile loop of
``csrc/gemm_tile.cuh``) replace the TPU's:

* ``dequant_matmul`` — ``dequant_gemm_kernel``, fused w4a16: ``a (M,
  K)`` float32, bfloat16 or float16 times B unpacked in the kernel, each weight
  ``(nibble - 8) * scale`` in float32 rounded to a's type, float32
  accumulation, returned in a's type.
* ``dequant_int4`` — ``dequant_int4_kernel``: the unpacked ``B (K, N)``
  in float32, bfloat16 or float16, the same values. ``dequant_matmul_twopass``
  runs it, then ``ops/gemm.py``'s ``matmul``.
* ``w4a8_matmul`` — ``w4a8_gemm_kernel``: per-token int8 activations
  (``ops/bitnet.py::quantize_activations``) times the int4 weights with
  exact int32 sums, then ``acc * s_act[m] * s_w[n]`` in float32, with
  per-channel weight scales from ``quantize_w4_per_channel``.

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
from .bitnet import quantize_activations
from .gemm import DTYPE_CODES, _as_dtype, check_grid, matmul
from ._factory import bind

__all__ = ["dequant_matmul", "dequant_matmul_plain", "dequant_gemm_kernel",
           "dequant_int4", "dequant_int4_plain", "dequant_matmul_twopass",
           "w4a8_matmul", "w4a8_gemm", "w4a8_gemm_plain",
           "quantize_w4_per_channel", "pack_planar", "unpack_planar",
           "pack_reference", "repack_from_reference", "launches",
           "reset_launches", "dequant_int4_kernel", "w4a8_gemm_kernel"]

_A_DTYPES = (torch.float32, torch.bfloat16, torch.float16)

# kernel name -> launches through its wrapper (chip_smoke.py zeroes and
# reads these around each call to prove the path used the kernels)
launches = {"dequant_gemm": 0, "dequant_int4": 0, "w4a8_gemm": 0}


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


def _dequant_gemm_launch(a, packed, scales, gs):
    from ._build import load, stream_call
    M, K = a.shape
    K2, N = packed.shape
    c = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if c.numel() == 0:
        return c
    if K2 == 0:
        return c.zero_()
    check_grid(M, N, "dequant_matmul")
    fn = load("dequant_gemm").tl_dequant_gemm
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = stream_call(fn, a.device, a.data_ptr(), packed.data_ptr(),
                       scales.data_ptr(), c.data_ptr(), M, N, K2, gs,
                       DTYPE_CODES[a.dtype])
    if code != 0:
        raise KernelLaunchError("dequant_gemm", code)
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
    fn = load("dequant_gemm").tl_w4a8_gemm
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = stream_call(fn, q.device, q.data_ptr(), packed.data_ptr(),
                       sw.data_ptr(), sa.data_ptr(), c.data_ptr(), M, N, K2)
    if code != 0:
        raise KernelLaunchError("w4a8_gemm", code)
    launches["w4a8_gemm"] += 1
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
