"""Multi-head attention forward on the card, and its autograd.

Counterpart of ``tilelang_mesh_tpu/ops/flash_attention.py``. Two CUDA
kernels (``csrc/flash_attention.cu``) replace the TPU's:

* ``mha_fwd`` — ``_mha_fwd_kernel``: the normalised output, used when no
  gradient is needed;
* ``mha_fwd_partial`` — ``_mha_fwd_partial_kernel``: the unnormalised
  float32 accumulator and per-row ``(m, l)`` in the exp2 domain, the
  mergeable form the autograd forward (and later ring attention) uses.

Both prescale Q by ``sm_scale * log2(e)`` in float32, rounded to the
input type once (``_prescale_q``), run the online softmax of
``ops/_online_softmax.py`` with its ``-1e30`` floor on the running max,
and mask top-left causal (query i sees keys j <= i).

``flash_attention`` is the differentiable entry: under autograd it runs
``_FlashAttention`` (the partial kernel forward, saving
``lse2 = m + log2(l)``; the backward kernels of ``ops/gqa_bwd.py``),
otherwise the forward kernel — as the JAX package's ``custom_vjp`` does.
``backward="reference"`` differentiates the dense ``_reference_attention``
instead. ``differentiable`` and ``launch_fwd`` are shared with
``ops/gqa.py``, whose kernels are the same source with fewer KV heads;
``differentiable`` also carries ``ops/flash_attention_varlen.py``, whose
document masks ride along as operands without gradients.

Each kernel's wrapper launches it on a CUDA tensor (a build or launch
failure raises) and runs its plain PyTorch version (``*_plain``: dense
softmax in the exp2 domain, rounded where the kernel rounds) on a CPU
tensor. The tests and ``chip_smoke.py`` hold the kernels against them.
float32 runs on the CUDA cores with one tile; bfloat16 and float16 run
on the tensor cores, with the tiles of ``carver.FLASH_KERNEL_TILES``:
``tile=(block_M, block_N)`` names one, ``None`` takes the kernel's
default, and the factory ``mha_fwd_kernel`` passes its ``block_M``,
``block_N`` when they name an instance for its type and head_dim.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ..carver.roller import FLASH_KERNEL_TILES
from ..resilience.errors import KernelLaunchError
from ._factory import bind
from .gemm import DTYPE_CODES, _as_dtype

__all__ = ["flash_attention", "flash_attention_partial", "mha_fwd",
           "mha_fwd_partial", "mha_fwd_plain", "mha_fwd_partial_plain",
           "mha_fwd_kernel", "launches", "reset_launches",
           "KERNEL_HEAD_DIMS", "kernel_tile"]

_LOG2E = 1.44269504

# head_dim values csrc/flash_attention.cu and csrc/gqa_bwd.cu instantiate
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = (torch.float32, torch.bfloat16, torch.float16)

# kernel name -> launches through its wrapper (chip_smoke.py zeroes and
# reads these around the model run to prove the path used the kernels)
launches = {"mha_fwd": 0, "mha_fwd_partial": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def check_attention_args(q, k, v, *, group: bool = False) -> None:
    """Shapes, types and device of ``q (B, Hq, Sq, D)`` against
    ``k, v (B, Hkv, Sk, D)``; ``Hq == Hkv`` unless ``group``."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B, H, Sq, D) and k, v one (B, H, Sk, "
                         f"D) shape, got {tuple(q.shape)}, {tuple(k.shape)},"
                         f" {tuple(v.shape)}")
    B, Hq, Sq, D = q.shape
    Bk, Hkv, Sk, Dk = k.shape
    if (Bk, Dk) != (B, D) or min(B, Hq, Sq, Sk, D) < 1:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} must "
                         f"share a non-empty batch and head_dim")
    if (Hq % Hkv) if group else (Hq != Hkv):
        raise ValueError(f"{Hq} query heads do not fit {Hkv} KV heads")
    if q.dtype != k.dtype or k.dtype != v.dtype or q.dtype not in _DTYPES:
        raise TypeError(f"q, k, v must share float32, bfloat16 or float16, "
                        f"got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    devs = {t.device for t in (q, k, v)}
    if len(devs) != 1:
        raise ValueError(f"q, k, v must share a device, got "
                         f"{sorted(map(str, devs))}")
    dev = q.device
    if dev.type == "cuda" and D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the attention kernels have no head_dim={D} "
                         f"instance (built: {KERNEL_HEAD_DIMS})")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and what the kernels are held against)
# ---------------------------------------------------------------------------


def _prescale_q(q: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """Q times ``sm_scale * log2(e)``, in float32, rounded to Q's type
    once (the TPU kernel's ``_prescale_q``)."""
    return (q.float() * (float(sm_scale) * _LOG2E)).to(q.dtype)


def causal_mask(Sq: int, Sk: int, device) -> torch.Tensor:
    """(Sq, Sk) bool, True where query i sees key j: j <= i (top-left)."""
    return torch.ones((Sq, Sk), dtype=torch.bool, device=device).tril()


def mha_fwd_partial_plain(q, k, v, causal: bool, sm_scale: float):
    """Plain version of the partial kernel: ``(acc f32 (B,H,Sq,D), m, l
    f32 (B,H,Sq))`` in the exp2 domain. Dense scores of the prescaled Q,
    masked to -inf; ``m = max(rowmax, -1e30)``; ``p = exp2(s - m)``;
    ``l = sum p``; ``acc = dtype(p) @ V`` in float32."""
    s = torch.matmul(_prescale_q(q, sm_scale).float(),
                     k.float().transpose(-1, -2))
    if causal:
        s.masked_fill_(~causal_mask(s.shape[-2], s.shape[-1], s.device),
                       -math.inf)
    m = s.amax(dim=-1).clamp_min_(-1e30)
    p = torch.exp2_(s.sub_(m[..., None]))
    l = p.sum(dim=-1)
    acc = torch.matmul(p.to(q.dtype).float(), v.float())
    return acc, m, l


def mha_fwd_plain(q, k, v, causal: bool, sm_scale: float) -> torch.Tensor:
    """Plain version of the forward kernel: ``acc / max(l, 1e-30)`` in
    q's type."""
    acc, _, l = mha_fwd_partial_plain(q, k, v, causal, sm_scale)
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def kernel_tile(dtype, D, block_M, block_N):
    """``(block_M, block_N)`` when it names a tensor-core instance for
    ``dtype`` and head_dim ``D``, else None (the kernel's default tile;
    float32 has one)."""
    if _as_dtype(dtype) == torch.float32:
        return None
    tile = (int(block_M), int(block_N))
    return tile if tile in FLASH_KERNEL_TILES.get(D, ()) else None


def launch_fwd(name, q, k, v, causal, sm_scale, partial, tile=None):
    """One launch of ``csrc/flash_attention.cu`` on checked CUDA tensors:
    the forward (``partial=False``) or the partial kernel, at ``tile``
    (an instance of ``FLASH_KERNEL_TILES``, bfloat16 / float16) or the
    kernel's default; query head h reads KV head ``h // (H // Hkv)``. The
    caller counts the launch under its own wrapper's name, ``name``,
    which a refused launch carries."""
    from ._build import load
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    dev = q.device
    if partial:
        o = torch.empty((B, H, Sq, D), dtype=torch.float32, device=dev)
        m = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
        l = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    else:
        o = torch.empty_like(q)
        m = l = None
    lib = load("flash_attention")
    # tl_mha_fwd_tiled takes (block_M, block_N) before the stream
    fn = lib.tl_mha_fwd if tile is None else lib.tl_mha_fwd_tiled
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                   + [ctypes.c_float]
                   + ([] if tile is None else [ctypes.c_int] * 2)
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  m.data_ptr() if partial else None,
                  l.data_ptr() if partial else None, B, H, Hkv, Sq, Sk, D,
                  DTYPE_CODES[q.dtype], int(bool(causal)),
                  int(partial), float(sm_scale) * _LOG2E,
                  *(() if tile is None else tile), stream)
    if code != 0:
        raise KernelLaunchError(name, code)
    return (o, m, l) if partial else o


def mha_fwd(q, k, v, causal: bool, sm_scale: float, *,
            tile=None) -> torch.Tensor:
    """Attention output ``(B, H, Sq, D)`` in q's type. CUDA tensors
    launch the forward kernel (at ``tile``, see ``launch_fwd``); CPU
    tensors run the plain version."""
    check_attention_args(q, k, v)
    if q.is_cuda:
        o = launch_fwd("mha_fwd", q, k, v, causal, sm_scale, partial=False,
                       tile=tile)
        launches["mha_fwd"] += 1
        return o
    return mha_fwd_plain(q, k, v, causal, sm_scale)


def mha_fwd_partial(q, k, v, causal: bool, sm_scale: float, *, tile=None):
    """Unnormalised ``(acc, m, l)`` in the exp2 domain, all float32.
    CUDA tensors launch the partial kernel (at ``tile``, see
    ``launch_fwd``); CPU tensors run the plain version."""
    check_attention_args(q, k, v)
    if q.is_cuda:
        out = launch_fwd("mha_fwd_partial", q, k, v, causal, sm_scale,
                         partial=True, tile=tile)
        launches["mha_fwd_partial"] += 1
        return out
    return mha_fwd_partial_plain(q, k, v, causal, sm_scale)


def flash_attention_partial(q, k, v, causal, sm_scale, block_M=128,
                            block_N=128, num_stages=2):
    """Unnormalised blockwise attention: ``(acc_f32, m, l)`` in the exp2
    domain for cross-shard merging. ``block_M``, ``block_N`` and
    ``num_stages`` are the TPU's tile hints: the kernel picks its own
    tiles."""
    return mha_fwd_partial(q, k, v, causal, sm_scale)


def mha_fwd_kernel(B, H, Sq, Sk, D, block_M=128, block_N=128, causal=False,
                   sm_scale=None, dtype="bfloat16", num_stages=2):
    """The forward kernel bound to one shape and type (the JAX factory's
    arguments, for benchmarking and inspection): returns ``fn(q, k, v) ->
    o``. ``dtype`` is a torch dtype or its name; ``(block_M, block_N)``
    picks the tensor-core tile when it names an instance (``kernel_tile``),
    else the kernel takes its default; ``num_stages`` is the TPU's hint."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    tile = kernel_tile(dtype, D, block_M, block_N)
    return bind("mha_fwd_kernel", [((B, H, Sq, D), _as_dtype(dtype)),
                                   ((B, H, Sk, D), None),
                                   ((B, H, Sk, D), None)],
                lambda q, k, v: mha_fwd(q, k, v, causal, sm_scale,
                                        tile=tile))


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


class _FlashAttention(torch.autograd.Function):
    """Kernel mode of ``_make_attention_vjp``: the forward normalises the
    ``partial`` op's ``(acc, m, l)`` (the MHA, GQA or varlen partial
    kernel), zeroing rows with ``l == 0``, and saves ``lse2 = m +
    log2(l)`` (``-inf`` on those rows); the backward runs ``bwd``, the
    dK/dV and dQ kernels. ``aux`` are trailing operands that are not
    differentiable (varlen's document masks): both ops take them after
    q, k, v, and their gradients are None."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, partial, bwd, *aux):
        acc, m, l = partial(q, k, v, *aux, causal, sm_scale)
        lv = l[..., None]
        o = torch.where(lv > 0, acc / lv, 0.0).to(q.dtype)
        ctx.save_for_backward(q, k, v, o, m + torch.log2(l), *aux)
        ctx.causal, ctx.sm_scale, ctx.bwd = causal, sm_scale, bwd
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse2, *aux = ctx.saved_tensors
        dq, dk, dv = ctx.bwd(q, k, v, *aux, o, lse2, g, ctx.causal,
                             ctx.sm_scale)
        return (dq, dk, dv) + (None,) * (4 + len(aux))


class _ReferenceAttention(torch.autograd.Function):
    """Reference mode: the ``fwd`` kernel op, and autograd through the
    dense ``reference`` for the backward (a debugging path)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, fwd, reference):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.sm_scale, ctx.reference = causal, sm_scale, reference
        return fwd(q, k, v, causal, sm_scale)

    @staticmethod
    def backward(ctx, g):
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            o = ctx.reference(*leaves, ctx.causal, ctx.sm_scale)
        return (*torch.autograd.grad(o, leaves, g), None, None, None, None)


def differentiable(q, k, v, causal, sm_scale, backward, fwd, partial,
                   reference, aux=(), bwd=None) -> torch.Tensor:
    """The JAX package's ``_make_attention_vjp`` for the attention ops:
    ``fwd`` alone when autograd needs no gradient of q, k or v; else
    ``backward="kernel"`` runs ``partial`` forward and ``bwd`` backward
    (by default the group-summing kernels of ``ops/gqa_bwd.py``),
    ``backward="reference"`` runs ``fwd`` forward and differentiates
    ``reference``. ``aux`` are operands after q, k, v that take no
    gradient; a dense ``reference`` cannot see them, so with ``aux`` the
    reference mode is refused."""
    if backward not in ("kernel", "reference"):
        raise ValueError(
            f"backward must be 'kernel' or 'reference', got {backward!r}")
    if backward == "reference" and aux:
        raise ValueError(
            "backward='reference' is not supported for ops with aux mask "
            "operands: a dense reference would let gradients cross them; "
            "use backward='kernel'")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    causal, sm_scale = bool(causal), float(sm_scale)
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in (q, k, v))):
        return fwd(q, k, v, *aux, causal, sm_scale)
    if backward == "kernel":
        if bwd is None:
            from .gqa_bwd import gqa_attention_bwd as bwd
        return _FlashAttention.apply(q, k, v, causal, sm_scale, partial,
                                     bwd, *aux)
    return _ReferenceAttention.apply(q, k, v, causal, sm_scale, fwd,
                                     reference)


def _reference_attention(q, k, v, causal: bool, sm_scale: float):
    """Dense attention with a natural-exp softmax in float32, cast back
    to q's type (the JAX package's ``_reference_attention``)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if causal:
        s = s.masked_fill(~causal_mask(s.shape[-2], s.shape[-1], s.device),
                          -math.inf)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.matmul(p.to(q.dtype).float(), v.float()).to(q.dtype)


def flash_attention(q, k, v, causal: bool = False,
                    sm_scale: Optional[float] = None, block_M: int = 128,
                    block_N: int = 128, num_stages: int = 2,
                    backward: str = "kernel") -> torch.Tensor:
    """Differentiable multi-head attention on the kernels.

    When autograd needs a gradient of q, k or v, ``backward="kernel"``
    (the default) runs the partial kernel forward and the dK/dV and dQ
    kernels backward; ``backward="reference"`` differentiates the dense
    reference. Otherwise the forward kernel runs alone. ``block_M``,
    ``block_N`` and ``num_stages`` are the TPU's tile hints (the JAX
    signature); the kernels pick their own tiles.
    """
    return differentiable(q, k, v, causal, sm_scale, backward, mha_fwd,
                          mha_fwd_partial, _reference_attention)
