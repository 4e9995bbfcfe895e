"""Standalone row softmax on the card.

Counterpart of ``tilelang_mesh_tpu/ops/softmax.py``. The CUDA source
``csrc/softmax.cu`` replaces the TPU's kernel:

* ``softmax`` — ``softmax_kernel``: ``X (M, N) -> Y (M, N)``, each row
  shifted by its max and normalised in the exp2 domain, in float32:
  ``p = exp2((x - m) * log2(e))``, ``y = p / sum(p)``, stored in
  ``out_dtype`` (the input's by default). A row that is all ``-inf``,
  or holds ``+inf``, is NaN, as the JAX kernel's ``x - m`` makes it.

The wrapper launches one kernel a call on a CUDA tensor (a build or
launch failure raises), the one ``softmax_path`` names: ``softmax_rows``
(a row in the registers of a lane group, N <= 1024),
``softmax_block_rows`` (a row a block) or ``softmax_cluster`` (a row a
cluster of 2, 4 or 8 CTAs, for the vocabulary row). On a CPU tensor it
runs the plain version, the JAX kernel's four phases in torch.
``block_M`` is the TPU's row-block hint; the kernels pick their own.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ..resilience.errors import KernelLaunchError

__all__ = ["softmax", "softmax_plain", "softmax_kernel", "softmax_path",
           "SoftmaxPath", "cluster_fit", "launches", "kernel_launches",
           "reset_launches", "DTYPES"]

# log2(e), as the JAX kernel's float32 constant
_LOG2E = 1.4426950408889634

# the kernel's type codes (input and output)
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# the kernels of csrc/softmax.cu, in the order of tl_softmax's path code
KERNELS = ("softmax_rows", "softmax_block_rows", "softmax_cluster")
ROWS_MAX = 1024          # widest row of softmax_rows
STASH_MAX = 48 * 1024    # float32 elements softmax_block_rows keeps in
                         # shared memory: a row up to it is read once
SLICE_MAX = 112 * 1024   # bytes of a cluster CTA's slice: two CTAs share
                         # an SM (2 x (112 KB + 512 B) of its 228 KB)
CLUSTER_SIZES = (2, 4, 8)

# kernel name -> launches through its wrapper
launches = {"softmax": 0}
# the same launches by the kernel the path rule picked
kernel_launches = {k: 0 for k in KERNELS}


def reset_launches() -> None:
    for d in (launches, kernel_launches):
        for k in d:
            d[k] = 0


class SoftmaxPath(NamedTuple):
    """The kernel of a call: ``param`` is the lanes a row of
    ``softmax_rows``, the CTAs a row of ``softmax_cluster``, 0 for
    ``softmax_block_rows``."""
    kernel: str
    param: int = 0

    @property
    def code(self) -> int:
        return KERNELS.index(self.kernel)


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def rows_group(N: int, esize: int) -> int:
    """Lanes a row of ``softmax_rows``: 16 bytes a lane where the row
    allows, at most 32 elements a lane, at most a warp a row."""
    want = max(-(-N // 32), -(-N * esize // 16))
    return min(32, _pow2_at_least(want))


def cluster_slice(N: int, C: int, esize: int) -> int:
    """Elements of a cluster CTA's slice (16-byte pieces), 0 where the row
    does not take ``softmax_cluster`` at C (csrc/softmax.cu's
    ``cluster_slice``)."""
    vec = 16 // esize
    if N % vec:
        return 0
    per = -(-N // C)                       # ceil(N / C)
    slice_ = -(-per // vec) * vec          # up to 16 bytes
    if slice_ * esize > SLICE_MAX or (C - 1) * slice_ >= N:
        return 0
    return slice_


def softmax_path(N: int, in_dtype, aligned: bool = True) -> SoftmaxPath:
    """The kernel a row of N elements of ``in_dtype`` takes, decided from
    the arguments before any launch: the register kernel up to
    ``ROWS_MAX``; the block kernel up to ``STASH_MAX`` (it reads those
    rows once already); past it the cluster kernel at the least C whose
    slice fits ``SLICE_MAX``, when the row's bytes and its base
    (``aligned``) sit on 16 bytes; else the block kernel."""
    esize = _dtype(in_dtype).itemsize
    if N <= ROWS_MAX:
        return SoftmaxPath("softmax_rows", rows_group(N, esize))
    if N > STASH_MAX and aligned:
        for C in CLUSTER_SIZES:
            if cluster_slice(N, C, esize):
                return SoftmaxPath("softmax_cluster", C)
    return SoftmaxPath("softmax_block_rows")


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


def _launch(x: torch.Tensor, out_dtype: torch.dtype,
            path: Optional[SoftmaxPath] = None) -> torch.Tensor:
    from ._build import load, stream_call
    M, N = x.shape
    if path is None:
        path = softmax_path(N, x.dtype, x.data_ptr() % 16 == 0)
    y = torch.empty((M, N), dtype=out_dtype, device=x.device)
    fn = load("softmax").tl_softmax
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = stream_call(fn, x.device, x.data_ptr(), y.data_ptr(), M, N,
                       DTYPES[x.dtype], DTYPES[out_dtype], path.code,
                       path.param)
    if code != 0:
        raise KernelLaunchError("softmax", code)
    launches["softmax"] += 1
    kernel_launches[path.kernel] += 1
    return y


def cluster_fit(N: int, in_dtype, out_dtype, C: int):
    """``(CTAs an SM, clusters the card runs at once)`` of
    ``softmax_cluster`` at a row of N elements over C CTAs, by the
    occupancy calculator on the current card; launches nothing."""
    from ._build import load
    fn = load("softmax").tl_softmax_cluster_fit
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    blocks, clusters = ctypes.c_int(0), ctypes.c_int(0)
    code = fn(N, DTYPES[_dtype(in_dtype)], DTYPES[_dtype(out_dtype)], C,
              ctypes.byref(blocks), ctypes.byref(clusters))
    if code != 0:
        raise KernelLaunchError("softmax", code)
    return blocks.value, clusters.value


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
