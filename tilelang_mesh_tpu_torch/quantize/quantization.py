"""Weight quantization helpers (host side, numpy).

Counterpart of ``tilelang_mesh_tpu/quantize/quantization.py``: the same
functions, byte for byte in behaviour, so the port builds its int4 and
MXFP4 weights without the JAX package. The in-kernel unpack lives in
``ops/dequant_gemm.py`` and ``csrc/dequant_gemm.cu``. The device-side
per-token int8 quantizer of the JAX package (``quantize_act_int8_kernel``)
is on no path yet and is not ported; its host reference
``quantize_act_int8_ref`` is.
"""

from __future__ import annotations

import numpy as np


def quantize_int4_groups(w: np.ndarray, group_size: int = 128):
    """Symmetric per-group int4 quantization along axis 0 (the K axis).

    Returns (packed uint8 (K//2, N), scales float32 (K//group_size, N)).
    """
    K, N = w.shape
    assert K % group_size == 0
    wg = w.reshape(K // group_size, group_size, N)
    scales = np.abs(wg).max(axis=1) / 7.0 + 1e-8            # (G, N)
    q = np.clip(np.round(wg / scales[:, None, :]), -8, 7)   # (G, gs, N)
    q = q.reshape(K, N).astype(np.int8)
    packed = pack_int4(q)
    return packed, scales.astype(np.float32)


def quantize_int4_planar(w: np.ndarray, group_size: int = 128):
    """Planar int4 pack for the TPU dequant-GEMM kernel
    (ops/dequant_gemm.py): byte (r, n) holds original rows r (lo nibble)
    and r + K/2 (hi nibble), so the in-kernel unpack is two full-tile
    mask/shift VPU ops with contiguous A halves — the TPU re-design of the
    reference's LOP3 bit-permutation trick (tilelang/quantize/lop3.py).

    Returns (packed uint8 (K/2, N), scales float32 (K//group_size, N))
    with scale groups laid out [lo-half groups..., hi-half groups...].
    """
    K, N = w.shape
    assert K % 2 == 0 and (K // 2) % group_size == 0, \
        "need K/2 divisible by group_size"
    K2 = K // 2
    halves = np.stack([w[:K2], w[K2:]])           # (2, K2, N)
    g = K2 // group_size
    wg = halves.reshape(2, g, group_size, N)
    scales = np.abs(wg).max(axis=2) / 7.0 + 1e-8  # (2, g, N)
    q = np.clip(np.round(wg / scales[:, :, None, :]), -8, 7)
    q = q.reshape(2, K2, N).astype(np.int8)
    u = (q.astype(np.int16) + 8).astype(np.uint8)
    packed = (u[0] | (u[1] << 4)).astype(np.uint8)  # (K2, N)
    return packed, scales.reshape(2 * g, N).astype(np.float32)


def dequantize_int4_planar_ref(packed: np.ndarray, scales: np.ndarray,
                               group_size: int = 128) -> np.ndarray:
    K2, N = packed.shape
    g = K2 // group_size
    lo = (packed & 0xF).astype(np.float32) - 8
    hi = ((packed >> 4) & 0xF).astype(np.float32) - 8
    s = scales.reshape(2, g, N)
    lo = (lo.reshape(g, group_size, N) * s[0][:, None, :]).reshape(K2, N)
    hi = (hi.reshape(g, group_size, N) * s[1][:, None, :]).reshape(K2, N)
    return np.concatenate([lo, hi], axis=0)


def quantize_act_int8_ref(x: np.ndarray):
    """Per-token symmetric int8 quantization (host): ``q`` and the
    dequant scale ``absmax / 127`` (the JAX package's
    ``quantize_act_int8_kernel`` computes the same on the device)."""
    absmax = np.maximum(np.abs(x).max(axis=-1, keepdims=True), 1e-8)
    s = (absmax / 127.0).astype(np.float32)
    q = np.clip(np.round(x / s), -127, 127).astype(np.int8)
    return q, s


def pack_int4(q: np.ndarray) -> np.ndarray:
    """Pack int8 values in [-8, 7] along axis 0, two per byte:
    byte = (q[2i+1]+8) << 4 | (q[2i]+8)."""
    K, N = q.shape
    assert K % 2 == 0
    u = (q.astype(np.int16) + 8).astype(np.uint8)
    return (u[0::2] | (u[1::2] << 4)).astype(np.uint8)


def unpack_int4_ref(packed: np.ndarray) -> np.ndarray:
    """Reference unpack (numpy): inverse of pack_int4."""
    lo = (packed & 0xF).astype(np.int16) - 8
    hi = ((packed >> 4) & 0xF).astype(np.int16) - 8
    K2, N = packed.shape
    out = np.empty((K2 * 2, N), np.int16)
    out[0::2] = lo
    out[1::2] = hi
    return out.astype(np.int8)


def dequantize_int4_ref(packed: np.ndarray, scales: np.ndarray,
                        group_size: int = 128) -> np.ndarray:
    q = unpack_int4_ref(packed).astype(np.float32)
    K, N = q.shape
    return (q.reshape(K // group_size, group_size, N) *
            scales[:, None, :]).reshape(K, N)


# ---------------------------------------------------------------------------
# MXFP4: e2m1 elements + e8m0 shared scale per 32-element K group
# (reference tilelang/quantize/mxfp.py; OCP MX spec)
# ---------------------------------------------------------------------------

_E2M1_VALUES = np.array([0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0],
                        dtype=np.float32)


def quantize_mxfp4(w: np.ndarray, group_size: int = 32):
    """Quantize (K, N) to MXFP4: returns (codes (K, N) uint8 in [0,16),
    scale_exp (K//group, N) uint8 e8m0 biased exponents)."""
    K, N = w.shape
    if K % group_size:
        raise ValueError(f"K must be a multiple of {group_size}")
    g = w.reshape(K // group_size, group_size, N)
    absmax = np.abs(g).max(axis=1)
    # e8m0 scale: power of two s.t. absmax/scale <= 6 (max e2m1 magnitude)
    exp = np.ceil(np.log2(np.maximum(absmax, 1e-30) / 6.0))
    exp = np.clip(exp, -127, 127)
    scale = 2.0 ** exp
    scaled = g / scale[:, None, :]
    mag = np.abs(scaled)
    # nearest e2m1 magnitude
    idx = np.argmin(np.abs(mag[..., None] - _E2M1_VALUES), axis=-1)
    sign = (scaled < 0).astype(np.uint8)
    codes = (sign << 3) | idx.astype(np.uint8)
    return (codes.reshape(K, N).astype(np.uint8),
            (exp + 127).astype(np.uint8))


def pack_mxfp4(codes: np.ndarray) -> np.ndarray:
    """Pack two fp4 codes per byte along K: (K, N) -> (K//2, N) int8."""
    K, N = codes.shape
    lo = codes[0::2].astype(np.uint8)
    hi = codes[1::2].astype(np.uint8)
    return (lo | (hi << 4)).view(np.int8)


def dequantize_mxfp4_ref(packed: np.ndarray, scale_exp: np.ndarray,
                         group_size: int = 32) -> np.ndarray:
    """Host reference inverse."""
    Kh, N = packed.shape
    u = packed.view(np.uint8)
    codes = np.empty((Kh * 2, N), np.uint8)
    codes[0::2] = u & 0xF
    codes[1::2] = u >> 4
    mag = _E2M1_VALUES[codes & 0x7]
    val = np.where(codes >> 3, -mag, mag)
    scale = 2.0 ** (scale_exp.astype(np.float32) - 127.0)
    K = Kh * 2
    return (val.reshape(K // group_size, group_size, N) *
            scale[:, None, :]).reshape(K, N).astype(np.float32)
