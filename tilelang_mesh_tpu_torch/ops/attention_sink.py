"""Attention with per-head sink logits (gpt-oss / StreamingLLM style) on
the card, and its autograd.

Counterpart of ``tilelang_mesh_tpu/ops/attention_sink.py``. One CUDA
kernel (``csrc/attention_sink.cu``) replaces the TPU's:

* ``sink_fwd`` — ``sink_fwd_kernel``: blockwise online-softmax attention
  (Hq query heads over Hkv KV heads) where each head's sink logit joins
  the softmax denominator without a value, after the KV loop:
  ``l += exp2(sink * log2(e) - m)`` with ``m`` the scores' running max,
  ``O = acc / max(l, 1e-30)``. An optional sliding window (key j visible
  to query i when ``j > i - window``) makes the kernel skip the key
  tiles outside it. bfloat16 and float16 run on the tensor cores at the
  tile ``sink_tile(D, window)``; float32 on CUDA cores at one tile.

``attention_sink`` is the entry, as in the JAX package. With
``backward=None`` it runs the fused kernel. With ``backward="kernel"``
(no window) it is differentiable in q, k, v and the sinks: without
autograd the fused kernel runs; under autograd the forward is the GQA
partial kernel (``ops/gqa.py::gqa_fwd_partial``) plus the sink folded in
plain torch (``l' = l + exp2(sink * log2(e) - m)``, ``lse2 = m +
log2(l')``), the backward the dK/dV and dQ kernels of
``ops/gqa_bwd.py`` with ``delta = sum(g * o)`` and the closed form
``dsink = -sum_{b,t} exp2(sink * log2(e) - lse2) * delta``.

The wrapper launches the kernel on CUDA tensors (a build or launch
failure raises) and runs its plain version (dense exp2 scores, rounded
where the kernel rounds) on CPU tensors.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ..resilience.errors import KernelLaunchError
from .flash_attention import causal_mask, check_attention_args
from ._factory import bind
from .gemm import DTYPE_CODES, _as_dtype
from .gqa import _expand_kv, gqa_fwd_partial

__all__ = ["attention_sink", "attention_sink_reference", "sink_fwd",
           "sink_fwd_plain", "sink_fwd_kernel", "sink_stats", "sink_grad",
           "sink_tile", "SINK_TILES", "launches", "reset_launches"]

# the JAX kernel's float32 log2(e)
_LOG2E = 1.44269504

# kernel name -> launches through its wrapper (both kernels of the
# source: sink_fwd for float32, sink_fwd_mma for bfloat16 and float16)
launches = {"attention_sink": 0}

# the tensor-core kernel's (block_M, block_N) by head_dim: (full, window),
# the tile without a window (or past SINK_WINDOW_TILE_MAX) and the one
# under it, each of csrc/flash_attention.cu's set for that head_dim
# (carver.FLASH_KERNEL_TILES), chosen by timing each (PERF.md, #13)
SINK_TILES = {16: ((64, 64), (64, 64)), 32: ((64, 64), (64, 64)),
              64: ((128, 64), (64, 64)), 128: ((128, 64), (64, 64))}
SINK_WINDOW_TILE_MAX = 512


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _check_sinks(q, sinks) -> torch.Tensor:
    """The sinks as float32 (Hq,) on q's device (the JAX package's
    ``jnp.asarray(sinks, float32)``)."""
    if tuple(sinks.shape) != (q.shape[1],):
        raise ValueError(f"sinks must be ({q.shape[1]},), one logit a query "
                         f"head, got {tuple(sinks.shape)}")
    if sinks.device != q.device:
        raise ValueError(f"sinks on {sinks.device}, q on {q.device}")
    return sinks.float()


def visible(Sq: int, Sk: int, causal: bool, window: int, device):
    """(Sq, Sk) bool, True where query i sees key j: top-left causal,
    and ``j > i - window`` when ``window > 0``."""
    vis = (causal_mask(Sq, Sk, device) if causal
           else torch.ones((Sq, Sk), dtype=torch.bool, device=device))
    if window > 0:
        i = torch.arange(Sq, device=device)[:, None]
        j = torch.arange(Sk, device=device)[None, :]
        vis &= j > i - window
    return vis


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def sink_fwd_plain(q, k, v, sinks, causal: bool, window: int,
                   sm_scale: float) -> torch.Tensor:
    """Plain version of the kernel: dense scores ``float(q k^T) *
    sm_scale * log2(e)`` masked to -inf, ``m = max(rowmax, -1e30)``,
    ``p = exp2(s - m)``, ``acc = dtype(p) @ v`` in float32, then ``l =
    sum p + exp2(sink * log2(e) - m)`` and ``acc / max(l, 1e-30)`` in
    q's type."""
    ke, ve = _expand_kv(q, k, v)
    s = torch.matmul(q.float(), ke.float().transpose(-1, -2))
    s.mul_(float(sm_scale) * _LOG2E)
    s.masked_fill_(~visible(s.shape[-2], s.shape[-1], causal, window,
                            s.device), -math.inf)
    m = s.amax(dim=-1).clamp_min_(-1e30)
    p = torch.exp2_(s.sub_(m[..., None]))
    l = p.sum(dim=-1)
    acc = torch.matmul(p.to(q.dtype).float(), ve.float())
    del p, s
    l += torch.exp2(sinks.float().view(1, -1, 1) * _LOG2E - m)
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------


def sink_tile(D: int, window: int):
    """The tensor-core kernel's tile ``(block_M, block_N)`` for head_dim
    ``D``: ``SINK_TILES[D]``'s window tile when ``0 < window <=
    SINK_WINDOW_TILE_MAX`` (a block then visits a few tiles near its
    diagonal, where fewer wasted keys count for more), else its full
    tile. ``None`` for a head_dim without an instance."""
    tiles = SINK_TILES.get(int(D))
    if tiles is None:
        return None
    return tiles[1] if 0 < window <= SINK_WINDOW_TILE_MAX else tiles[0]


def _launch(q, k, v, sinks, causal, window, sm_scale):
    from ._build import load, stream_call
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    sinks = sinks.contiguous()
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    tile = (0, 0)
    if q.dtype != torch.float32:
        tile = sink_tile(D, window) or (0, 0)
    fn = load("attention_sink").tl_sink_fwd_tiled
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                   + [ctypes.c_float] + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    code = stream_call(fn, q.device, q.data_ptr(), k.data_ptr(),
                       v.data_ptr(), sinks.data_ptr(), o.data_ptr(), B, Hq,
                       Hkv, Sq, Sk, D, DTYPE_CODES[q.dtype],
                       int(bool(causal)), int(window),
                       float(sm_scale) * _LOG2E, *tile)
    if code != 0:
        raise KernelLaunchError("attention_sink", code)
    launches["attention_sink"] += 1
    return o


def sink_fwd(q, k, v, sinks, causal: bool, window: int,
             sm_scale: float) -> torch.Tensor:
    """Sink attention output ``(B, Hq, Sq, D)`` in q's type; ``window <=
    0`` means none. CUDA tensors launch the kernel; CPU tensors run the
    plain version."""
    check_attention_args(q, k, v, group=True)
    sinks = _check_sinks(q, sinks)
    if q.is_cuda:
        return _launch(q, k, v, sinks, causal, window, sm_scale)
    return sink_fwd_plain(q, k, v, sinks, causal, window, sm_scale)


def sink_fwd_kernel(B, Hq, Hkv, Sq, Sk, D, block_M, block_N, causal,
                    window, sm_scale, dtype, num_stages=2):
    """The kernel bound to one shape (the JAX factory's arguments; the
    tile sizes are the TPU's hints): ``fn(q, k, v, sinks) -> o``."""
    if Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not fit {Hkv} KV heads")
    return bind("sink_fwd_kernel",
                [((B, Hq, Sq, D), _as_dtype(dtype)), ((B, Hkv, Sk, D), None),
                 ((B, Hkv, Sk, D), None), ((Hq,), None)],
                lambda q, k, v, sinks: sink_fwd(q, k, v, sinks, bool(causal),
                                                int(window),
                                                float(sm_scale)))


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


def sink_stats(acc, m, l, sinks, dtype):
    """The sink folded into the sink-less partials ``(acc, m, l)`` (exp2
    domain): ``(o, lse2)`` with ``l' = l + exp2(sink * log2(e) - m)``,
    ``o = dtype(acc / l')``, ``lse2 = m + log2(l')``."""
    l_sink = l + torch.exp2(sinks.view(1, -1, 1) * _LOG2E - m)
    o = (acc / l_sink[..., None]).to(dtype)
    return o, m + torch.log2(l_sink)


def sink_grad(lse2, delta, sinks):
    """``dsink = -sum_{b,t} exp2(sink * log2(e) - lse2) * delta`` float32
    (Hq,): the sink has no value column, so d(o)/d(sink) = -p_sink o."""
    p_sink = torch.exp2(sinks.view(1, -1, 1) * _LOG2E - lse2)
    return -(p_sink * delta).sum(dim=(0, 2))


class _SinkAttention(torch.autograd.Function):
    """``backward="kernel"`` under autograd: the GQA partial kernel and
    the sink fold forward; the dK/dV and dQ kernels and the closed-form
    d(sink) backward."""

    @staticmethod
    def forward(ctx, q, k, v, sinks, causal, sm_scale):
        acc, m, l = gqa_fwd_partial(q, k, v, causal, sm_scale)
        o, lse2 = sink_stats(acc, m, l, sinks, q.dtype)
        ctx.save_for_backward(q, k, v, sinks, o, lse2)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, g):
        from .gqa_bwd import gqa_attention_bwd
        q, k, v, sinks, o, lse2 = ctx.saved_tensors
        g = g.contiguous()
        # delta once, shared by the recompute kernels and d(sink)
        delta = (g.float() * o.float()).sum(dim=-1)
        dq, dk, dv = gqa_attention_bwd(q, k, v, o, lse2, g, ctx.causal,
                                       ctx.sm_scale, delta=delta)
        return dq, dk, dv, sink_grad(lse2, delta, sinks), None, None


def attention_sink(q, k, v, sinks, causal: bool = True,
                   window_size: Optional[int] = None,
                   sm_scale: Optional[float] = None, block_M: int = 128,
                   block_N: int = 128, num_stages: int = 2,
                   backward: Optional[str] = None) -> torch.Tensor:
    """Sink attention: q (B, Hq, Sq, D); k, v (B, Hkv, Sk, D), Hkv | Hq;
    sinks (Hq,) per-head sink logits (cast to float32).
    ``window_size=None`` disables the sliding window.

    ``block_M``, ``block_N`` are the TPU's blocks: after clamping to Sq,
    Sk they must divide them, as in the JAX package; the kernel picks its
    own tiles. ``backward="kernel"`` (``window_size=None`` only) is
    differentiable in q, k, v and sinks; ``backward=None`` runs the
    fused kernel alone and returns no gradient.
    """
    check_attention_args(q, k, v, group=True)
    B, Hq, Sq, D = q.shape
    Sk = k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    window = 0 if window_size is None else int(window_size)
    block_M, block_N = min(block_M, Sq), min(block_N, Sk)
    if Sq % block_M or Sk % block_N:
        raise ValueError(
            f"attention_sink needs Sq % block_M == 0 and Sk % block_N == 0 "
            f"(got Sq={Sq}, Sk={Sk}, block_M={block_M}, block_N={block_N})")
    sinks = _check_sinks(q, sinks)
    causal, sm_scale = bool(causal), float(sm_scale)
    if backward is None:
        with torch.no_grad():
            return sink_fwd(q, k, v, sinks, causal, window, sm_scale)
    if backward != "kernel":
        raise ValueError(f"backward must be None or 'kernel', "
                         f"got {backward!r}")
    if window:
        raise ValueError(
            "attention_sink backward requires window_size=None (the "
            "dKdV/dQ recompute kernels carry no window mask)")
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in (q, k, v, sinks))):
        return sink_fwd(q, k, v, sinks, causal, 0, sm_scale)
    return _SinkAttention.apply(q, k, v, sinks, causal, sm_scale)


def attention_sink_reference(q, k, v, sinks, causal=True, window_size=None,
                             sm_scale=None):
    """Dense reference (the JAX package's): a natural-exp softmax over
    ``[scores, sink]`` in float32 where the sink column carries no value,
    cast to q's type; differentiable by autograd."""
    Hq, D = q.shape[1], q.shape[3]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    ke, ve = _expand_kv(q, k, v)
    s = torch.matmul(q.float(), ke.float().transpose(-1, -2)) * sm_scale
    window = 0 if window_size is None else int(window_size)
    s = s.masked_fill(~visible(s.shape[-2], s.shape[-1], bool(causal),
                               window, s.device), -math.inf)
    sink = sinks.float().reshape(1, Hq, 1, 1)
    m = torch.maximum(s.amax(dim=-1, keepdim=True), sink)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True) + torch.exp(sink - m)
    return torch.matmul(p / denom, ve.float()).to(q.dtype)
