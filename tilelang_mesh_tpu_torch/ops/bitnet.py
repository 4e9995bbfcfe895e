"""BitNet b1.58 ternary-weight linear ops.

Counterpart of ``tilelang_mesh_tpu/ops/bitnet.py``: weights are ternary
{-1, 0, 1} packed four to an int8 byte (``pack_ternary``, numpy),
activations per-token absmax int8 (``quantize_activations``: plain torch,
as it is plain ``jnp`` in the JAX package), and the GEMM runs int8 x
ternary -> exact int32, dequantised by ``activation_scale * w_scale``.

Three CUDA kernels (``csrc/bitnet_gemm.cu``) replace the TPU's:

* ``bitnet_gemm`` — ``bitnet_gemm_kernel``: ``A (M, K) int8 x Wp (K/4, N)
  int8 -> C (M, N) int32``, the exact product with the weights unpacked
  in the kernel, for any M, N and K a multiple of 4. ``bitnet_path``
  picks the kernel: a split-K stream of the weights for up to
  ``SPLITK_MAX_ROWS`` rows (``bitnet_gemm_splitk``, planned by
  ``bitnet_splitk_plan``), TMA + ``wgmma`` for more
  (``bitnet_gemm_wgmma``), and the block tile loop (``bitnet_gemm``) for
  operands neither takes.

``bitnet_linear`` is the entry point (quantise, ``bitnet_gemm``, then
``acc / (scale * w_scale)``, the JAX order); ``bitnet_linear_reference``
is its emulation on the unpacked ternary weights. The wrapper launches
the kernel on a CUDA tensor (a build or launch failure raises) and runs
its plain version (``bitnet_gemm_plain``: unpack, exact integer product)
on a CPU tensor.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..resilience.errors import KernelLaunchError
from .gemm import check_grid, matmul_plain

__all__ = ["quantize_activations", "pack_ternary", "unpack_ternary",
           "bitnet_gemm", "bitnet_gemm_plain", "bitnet_gemm_kernel",
           "bitnet_linear", "bitnet_linear_reference", "bitnet_path",
           "bitnet_splitk_plan", "SPLITK_MAX_ROWS", "launches",
           "reset_launches"]

# kernel name -> launches through its wrapper: one a path of bitnet_path
# (the block tile loop keeps the kernel's first name)
launches = {"bitnet_gemm": 0, "bitnet_gemm_splitk": 0,
            "bitnet_gemm_wgmma": 0}
PATH_KERNELS = {"loop": "bitnet_gemm", "splitk": "bitnet_gemm_splitk",
                "wgmma": "bitnet_gemm_wgmma"}

# A rows up to which bitnet_path takes the split-K kernel (PERF.md, PR 19:
# at BitFFN's gate/up width the TMA kernel is faster from 10 rows on)
SPLITK_MAX_ROWS = 8


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


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


# ---------------------------------------------------------------------------
# the int8 x ternary GEMM (#26)
# ---------------------------------------------------------------------------


def _on(x, device: torch.device) -> torch.Tensor:
    """x (numpy or torch) as a tensor on ``device``; a tensor elsewhere
    raises (``ops/dequant_gemm.py``'s, which imports this module)."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)
    if x.device != device:
        raise ValueError(f"operands must share a device, got {x.device}, "
                         f"{device}")
    return x


def _unpack(packed: torch.Tensor) -> torch.Tensor:
    """(K/4, N) packed bytes -> (K, N) int8 ternary weights."""
    u = packed.view(torch.uint8).to(torch.int32)
    fields = torch.stack([(u >> (2 * p)) & 3 for p in range(4)], dim=1)
    return (fields - 1).reshape(-1, packed.shape[1]).to(torch.int8)


def bitnet_gemm_plain(a: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """Plain version: unpack the weights, take the exact int32 product
    (``matmul_plain``'s int8 path: int64 on the CPU, float64 on the card,
    exact since a ternary product's |sum| <= 128 K < 2**53)."""
    return matmul_plain(a, _unpack(packed), out_dtype=torch.int32)


def _check_gemm(a, packed) -> None:
    if a.dim() != 2 or a.dtype != torch.int8:
        raise TypeError(f"bitnet_gemm takes A (M, K) int8, got {a.dtype} "
                        f"{tuple(a.shape)}")
    M, K = a.shape
    if K % 4:
        raise ValueError(f"K must be a multiple of 4, got {K}")
    if packed.dtype not in (torch.int8, torch.uint8) \
            or tuple(packed.shape[:1]) != (K // 4,) or packed.dim() != 2:
        raise ValueError(f"packed weights must be ({K // 4}, N) int8 for "
                         f"K={K}, got {packed.dtype} "
                         f"{tuple(packed.shape)}")
    if a.device.type not in ("cuda", "cpu"):
        raise ValueError(f"bitnet_gemm: unsupported device {a.device}")


def bitnet_path(M: int, N: int, K: int, a_ptr: int = 0,
                packed_ptr: int = 0) -> str:
    """Which kernel of ``bitnet_gemm.cu`` computes the product on the card
    (A (M, K) at ``a_ptr``, the packed (K/4, N) at ``packed_ptr``):

    * ``"splitk"`` (``tl_bitnet_gemm_splitk``): M up to
      ``SPLITK_MAX_ROWS``, N a multiple of 16, the packed rows on 16
      bytes and A on 4;
    * ``"wgmma"`` (``tl_bitnet_gemm_wgmma``): more rows, K and N multiples
      of 16 and both bases on 16 bytes (TMA's strides and addresses);
    * ``"loop"`` (``tl_bitnet_gemm``): everything else."""
    if min(M, N, K) < 1:
        return "loop"
    packed_ok = N % 16 == 0 and packed_ptr % 16 == 0
    if M <= SPLITK_MAX_ROWS:
        return "splitk" if packed_ok and a_ptr % 4 == 0 else "loop"
    return "wgmma" if packed_ok and K % 16 == 0 and a_ptr % 16 == 0 \
        else "loop"


def bitnet_splitk_plan(N: int, K: int, sms: int):
    """The split-K kernel's grid: ``(strips, splits, rows_per_block)``. A
    block owns 512 columns (``strips = ceil(N / 512)``) and
    ``rows_per_block`` packed rows of K (a multiple of 64: 8 warps of 8),
    as few as fill the card's ``sms`` SMs with about one block each:
    ``rows_per_block = max(64, ceil(K/4 / ceil(sms / strips)) rounded up
    to 64)``, ``splits = ceil(K/4 / rows_per_block)``."""
    G = K // 4
    strips = _cdiv(N, 512)
    rows = max(64, _cdiv(_cdiv(G, _cdiv(sms, strips)), 64) * 64)
    return strips, _cdiv(G, rows), rows


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def _sms(dev: torch.device) -> int:
    """The card's SM count (the split-K plans' parallelism)."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _launch(a, packed):
    from ._build import load, stream_call
    M, K = a.shape
    N = packed.shape[1]
    c = torch.empty((M, N), dtype=torch.int32, device=a.device)
    if c.numel() == 0:
        return c
    if K == 0:
        return c.zero_()
    path = bitnet_path(M, N, K, a.data_ptr(), packed.data_ptr())
    lib = load("bitnet_gemm")
    ptrs = (a.data_ptr(), packed.data_ptr(), c.data_ptr())
    if path == "splitk":
        _, splits, rows = bitnet_splitk_plan(N, K, _sms(a.device))
        fn = lib.tl_bitnet_gemm_splitk
        args = (*ptrs, M, N, K, rows, splits)
    elif path == "wgmma":
        fn = lib.tl_bitnet_gemm_wgmma
        args = (*ptrs, M, N, K)
    else:
        check_grid(M, N, "bitnet_gemm")
        fn = lib.tl_bitnet_gemm
        args = (*ptrs, M, N, K)
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * (len(args) - 3) \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    name = PATH_KERNELS[path]
    code = stream_call(fn, a.device, *args)
    if code != 0:
        raise KernelLaunchError(name, code)
    launches[name] += 1
    return c


def bitnet_gemm(a: torch.Tensor, packed) -> torch.Tensor:
    """``A (M, K) int8 x packed (K/4, N) int8 -> (M, N) int32``, the exact
    product with the ternary weights unpacked (``packed`` numpy or torch;
    K a multiple of 4). CUDA tensors launch the kernel; CPU tensors run
    the plain version."""
    packed = _on(packed, a.device)
    _check_gemm(a, packed)
    if a.is_cuda:
        return _launch(a.contiguous(), packed.contiguous())
    return bitnet_gemm_plain(a, packed)


def bitnet_gemm_kernel(M, N, K, block_M=128, block_N=128, block_K=256,
                       num_stages=2):
    """The kernel bound to one shape: ``fn(A (M, K) int8, Wp (K/4, N)
    int8) -> C (M, N) int32``. The ``block_*`` and ``num_stages``
    arguments are the TPU's hints; the kernel picks its own tiles."""
    if K % 4:
        raise ValueError(f"K must be a multiple of 4, got {K}")

    def fn(a, packed):
        got = (tuple(a.shape), tuple(packed.shape))
        if got != ((M, K), (K // 4, N)):
            raise ValueError(f"kernel bound to A ({M}, {K}) and Wp "
                             f"({K // 4}, {N}), called with {got}")
        return bitnet_gemm(a, packed)

    return fn


# ---------------------------------------------------------------------------
# BitLinear
# ---------------------------------------------------------------------------


def _dequant(acc, scale, w_scale, lead):
    """``acc / (scale * w_scale)`` in float32, the product of the scales
    first (the JAX order); ``(..., N)``."""
    y = acc.float() / (scale * float(w_scale))
    return y.reshape(*lead, acc.shape[1])


def bitnet_linear(x: torch.Tensor, packed_w, w_scale) -> torch.Tensor:
    """``y = x @ W / (act_scale * w_scale)`` with W ternary, int2-packed.

    x (..., K) float; packed_w (K/4, N) int8 (numpy or torch); w_scale a
    scalar, BitLinear's ``1 / mean(|w|)``. Per-token int8 activations
    (``quantize_activations``), then ``bitnet_gemm``. Returns float32
    (..., N).
    """
    q, scale = quantize_activations(x.reshape(-1, x.shape[-1]))
    return _dequant(bitnet_gemm(q, packed_w), scale, w_scale,
                    x.shape[:-1])


def bitnet_linear_reference(x: torch.Tensor, w_ternary,
                            w_scale) -> torch.Tensor:
    """Emulation of BitLinear on the unpacked (K, N) ternary weights:
    the same activations and epilogue, the exact product in plain torch
    (the JAX package's ``bitnet_linear_reference``)."""
    q, scale = quantize_activations(x.reshape(-1, x.shape[-1]))
    acc = matmul_plain(q, _on(w_ternary, x.device).to(torch.int8),
                       out_dtype=torch.int32)
    return _dequant(acc, scale, w_scale, x.shape[:-1])
