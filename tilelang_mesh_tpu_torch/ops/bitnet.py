"""BitNet b1.58 helpers: per-token int8 activations and ternary packing.

Counterpart of part of ``tilelang_mesh_tpu/ops/bitnet.py``:
``quantize_activations`` (which ``w4a8_matmul`` calls; plain torch, not a
kernel in the JAX package either) and the host packers ``pack_ternary``
/ ``unpack_ternary`` (numpy). The int8 x ternary GEMM
(``bitnet_gemm_kernel``) and ``bitnet_linear`` are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["quantize_activations", "pack_ternary", "unpack_ternary"]


def pack_ternary(w: np.ndarray) -> np.ndarray:
    """Pack a ternary (K, N) matrix into (K//4, N) int8, 2 bits per value,
    each stored biased (+1) as 0..2, row 4i + p in bits 2p."""
    K, N = w.shape
    if K % 4:
        raise ValueError(f"K must be a multiple of 4, got {K}")
    if not np.isin(w, (-1, 0, 1)).all():
        raise ValueError("weights must be ternary {-1, 0, 1}")
    biased = (w.astype(np.int32) + 1).reshape(K // 4, 4, N)
    packed = (biased[:, 0] | (biased[:, 1] << 2) | (biased[:, 2] << 4)
              | (biased[:, 3] << 6))
    return packed.astype(np.uint8).view(np.int8)


def unpack_ternary(packed: np.ndarray) -> np.ndarray:
    """Host inverse of :func:`pack_ternary`."""
    Kq, N = packed.shape
    u = packed.view(np.uint8).astype(np.int32)
    fields = np.stack([(u >> (2 * i)) & 3 for i in range(4)], axis=1)
    return (fields - 1).reshape(Kq * 4, N).astype(np.int8)


def quantize_activations(x: torch.Tensor):
    """Per-token absmax quantization to int8: ``scale = 127 /
    max(absmax, 1e-5)`` per row (in x's type), ``q = clip(round(x *
    scale), -128, 127)`` with round half to even. Returns ``(q int8,
    scale (..., 1))``."""
    absmax = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-5)
    # a true division (``127.0 / absmax`` is ``absmax.reciprocal() *
    # 127`` in PyTorch, which rounds twice)
    scale = torch.div(absmax.new_tensor(127.0), absmax)
    q = torch.round(x * scale).clamp(-128, 127).to(torch.int8)
    return q, scale
