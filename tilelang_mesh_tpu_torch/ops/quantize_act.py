"""Per-token int8 activation quantiser on the card.

Counterpart of ``quantize_act_int8_kernel`` in
``tilelang_mesh_tpu/quantize/quantization.py``. The torch wrappers live
here so that ``quantize/`` stays host-only (numpy) at import time; its
``quantize_act_int8_kernel`` factory binds :func:`quantize_act_int8` to
one shape. One CUDA kernel (``csrc/quantize_act.cu``) replaces the TPU's:

* ``quantize_act_int8`` — ``X (M, K) float32 -> (Q (M, K) int8, S (M, 1)
  float32)``, S the dequantisation scale ``max(absmax, 1e-8) *
  float32(1/127)`` (as the JAX kernel computes it) and ``Q =
  clamp(rint(X / S), -127, 127)``. An all-zero row gives a finite S and
  Q = 0.

The wrapper launches the kernel on a CUDA tensor (a build or launch
failure raises) and runs the plain version, which computes the same
bytes, on a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from ..resilience.errors import KernelLaunchError

__all__ = ["quantize_act_int8", "quantize_act_int8_plain", "launches",
           "reset_launches"]

# kernel name -> launches through its wrapper
launches = {"quantize_act_int8": 0}

# float32(1/127): the JAX kernel's ``absmax / 127.0`` compiles to a
# multiply by this rounded reciprocal
_INV_127 = 1.0 / 127.0


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def quantize_act_int8_plain(x: torch.Tensor):
    """Plain version: ``S = max(absmax, 1e-8) * float32(1/127)`` per row,
    ``Q = clamp(round(x / S), -127, 127)`` (true division, round half to
    even), as int8."""
    absmax = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8)
    s = absmax * absmax.new_tensor(_INV_127)
    q = torch.round(torch.div(x, s)).clamp_(-127, 127).to(torch.int8)
    return q, s


def _launch(x):
    from ._build import load, stream_call
    M, K = x.shape
    q = torch.empty((M, K), dtype=torch.int8, device=x.device)
    s = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    if M == 0:
        return q, s
    fn = load("quantize_act").tl_quantize_act_int8
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = stream_call(fn, x.device, x.data_ptr(), q.data_ptr(),
                       s.data_ptr(), M, K)
    if code != 0:
        raise KernelLaunchError("quantize_act_int8", code)
    launches["quantize_act_int8"] += 1
    return q, s


def quantize_act_int8(x: torch.Tensor):
    """``x (M, K) float32 -> (Q (M, K) int8, S (M, 1) float32)`` for any
    M. CUDA tensors launch the kernel; CPU tensors run the plain
    version."""
    if x.dim() != 2 or x.dtype != torch.float32:
        raise TypeError(f"quantize_act_int8 takes X (M, K) float32, got "
                        f"{x.dtype} {tuple(x.shape)}")
    if x.shape[1] < 1:
        raise ValueError("quantize_act_int8: a row needs K >= 1 values")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"quantize_act_int8: unsupported device "
                         f"{x.device}")
    if x.is_cuda:
        return _launch(x.contiguous())
    return quantize_act_int8_plain(x)
