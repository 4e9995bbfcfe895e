"""Standalone row softmax on the card.

Counterpart of ``tilelang_mesh_tpu/ops/softmax.py``. One CUDA kernel
(``csrc/softmax.cu``) replaces the TPU's:

* ``softmax`` — ``softmax_kernel``: ``X (M, N) -> Y (M, N)``, each row
  shifted by its max and normalised in the exp2 domain, in float32:
  ``p = exp2((x - m) * log2(e))``, ``y = p / sum(p)``, stored in
  ``out_dtype`` (the input's by default). A row that is all ``-inf``,
  or holds ``+inf``, is NaN, as the JAX kernel's ``x - m`` makes it.

The wrapper launches the kernel on a CUDA tensor (a build or launch
failure raises) and runs the plain version, the JAX kernel's four
phases in torch, on a CPU tensor. ``block_M`` is the TPU's row-block
hint; the kernel picks its own (one warp or one block a row).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..resilience.errors import KernelLaunchError

__all__ = ["softmax", "softmax_plain", "softmax_kernel", "launches",
           "reset_launches", "DTYPES"]

# log2(e), as the JAX kernel's float32 constant
_LOG2E = 1.4426950408889634

# the kernel's type codes (input and output)
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# kernel name -> launches through its wrapper
launches = {"softmax": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _dtype(d) -> torch.dtype:
    if isinstance(d, str):
        d = getattr(torch, d, None)
    if d not in DTYPES:
        raise TypeError(f"softmax takes float32, bfloat16 or float16, got "
                        f"{d}")
    return d


def softmax_plain(x: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version: the JAX kernel's shift, exp2, row sum and divide in
    float32, cast to ``out_dtype``."""
    xf = x.float()
    m = xf.amax(dim=1, keepdim=True)
    p = torch.exp2((xf - m) * _LOG2E)
    return (p / p.sum(dim=1, keepdim=True)).to(out_dtype)


def _launch(x: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    from ._build import load, stream_call
    M, N = x.shape
    y = torch.empty((M, N), dtype=out_dtype, device=x.device)
    fn = load("softmax").tl_softmax
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = stream_call(fn, x.device, x.data_ptr(), y.data_ptr(), M, N,
                       DTYPES[x.dtype], DTYPES[out_dtype])
    if code != 0:
        raise KernelLaunchError("softmax", code)
    launches["softmax"] += 1
    return y


def softmax(x: torch.Tensor, block_M: Optional[int] = None,
            out_dtype=None) -> torch.Tensor:
    """Row softmax of a 2-D array, ``out_dtype`` (a torch dtype or its
    name) defaulting to the input's. CUDA tensors launch the kernel; CPU
    tensors run the plain version."""
    if x.dim() != 2:
        raise ValueError(f"softmax takes a 2-D array, got shape "
                         f"{tuple(x.shape)}")
    _dtype(x.dtype)
    out = _dtype(out_dtype) if out_dtype is not None else x.dtype
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"softmax: unsupported device {x.device}")
    if x.numel() == 0:
        return torch.empty(x.shape, dtype=out, device=x.device)
    if x.is_cuda:
        return _launch(x.contiguous(), out)
    return softmax_plain(x, out)


def softmax_kernel(M, N, block_M=128, in_dtype="float32", out_dtype=None):
    """The kernel bound to one shape and type (the JAX factory's
    arguments): ``fn(x) -> y``."""
    in_dtype = _dtype(in_dtype)
    out = _dtype(out_dtype) if out_dtype is not None else in_dtype

    def fn(x):
        if tuple(x.shape) != (M, N) or x.dtype != in_dtype:
            raise ValueError(f"kernel bound to ({M}, {N}) {in_dtype}, "
                             f"called with {tuple(x.shape)} {x.dtype}")
        return softmax(x, block_M, out)

    return fn
