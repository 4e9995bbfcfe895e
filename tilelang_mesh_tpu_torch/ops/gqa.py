"""Grouped-query attention forward on the card, and its autograd.

Counterpart of ``tilelang_mesh_tpu/ops/gqa.py``: Hq query heads share
Hkv KV heads (Hkv divides Hq), query head h reading KV head
``h // (Hq // Hkv)``. Two TPU kernels are replaced by the attention
loop of ``csrc/flash_attention.cu``, which takes the KV heads:

* ``gqa_fwd`` — ``gqa_fwd_kernel``: the normalised output, used when no
  gradient is needed;
* ``gqa_fwd_partial`` — ``gqa_fwd_partial_kernel``: the unnormalised
  float32 accumulator and per-row ``(m, l)`` in the exp2 domain, which
  the autograd forward normalises and saves as ``lse2 = m + log2(l)``.

``gqa_attention`` is the differentiable entry, as in the JAX package:
the forward kernel alone without autograd; under autograd with
``backward="kernel"`` the partial kernel forward and the group-summing
dK/dV and dQ kernels of ``ops/gqa_bwd.py`` backward;
``backward="reference"`` differentiates the dense ``_reference_gqa``.

Each kernel's wrapper launches it on a CUDA tensor (a build or launch
failure raises) and runs its plain version (``*_plain``: KV expanded by
``repeat_interleave``, then the MHA plain version, rounded where the
kernel rounds) on a CPU tensor.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import (_reference_attention, check_attention_args,
                              differentiable, launch_fwd,
                              mha_fwd_partial_plain, mha_fwd_plain)

__all__ = ["gqa_attention", "gqa_fwd", "gqa_fwd_partial", "gqa_fwd_plain",
           "gqa_fwd_partial_plain", "gqa_fwd_kernel",
           "gqa_fwd_partial_kernel", "launches", "reset_launches"]

# kernel name -> launches through its wrapper
launches = {"gqa_fwd": 0, "gqa_fwd_partial": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _expand_kv(q, k, v):
    group = q.shape[1] // k.shape[1]
    if group == 1:
        return k, v
    return (k.repeat_interleave(group, dim=1),
            v.repeat_interleave(group, dim=1))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def gqa_fwd_partial_plain(q, k, v, causal: bool, sm_scale: float):
    """Plain version of the partial kernel: ``(acc f32 (B, Hq, Sq, D),
    m, l f32 (B, Hq, Sq))`` in the exp2 domain."""
    return mha_fwd_partial_plain(q, *_expand_kv(q, k, v), causal, sm_scale)


def gqa_fwd_plain(q, k, v, causal: bool, sm_scale: float) -> torch.Tensor:
    """Plain version of the forward kernel: ``acc / max(l, 1e-30)`` in
    q's type."""
    return mha_fwd_plain(q, *_expand_kv(q, k, v), causal, sm_scale)


def _reference_gqa(q, k, v, causal: bool, sm_scale: float):
    """Dense GQA reference (the JAX package's ``_reference_gqa``):
    KV repeated to the query heads, then the dense attention; autograd
    through the repeat sums each KV head's group."""
    return _reference_attention(q, *_expand_kv(q, k, v), causal, sm_scale)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def gqa_fwd(q, k, v, causal: bool, sm_scale: float) -> torch.Tensor:
    """Attention output ``(B, Hq, Sq, D)`` in q's type. CUDA tensors
    launch the forward kernel; CPU tensors run the plain version."""
    check_attention_args(q, k, v, group=True)
    if q.is_cuda:
        o = launch_fwd("gqa_fwd", q, k, v, causal, sm_scale, partial=False)
        launches["gqa_fwd"] += 1
        return o
    return gqa_fwd_plain(q, k, v, causal, sm_scale)


def gqa_fwd_partial(q, k, v, causal: bool, sm_scale: float):
    """Unnormalised ``(acc, m, l)`` in the exp2 domain, all float32.
    CUDA tensors launch the partial kernel; CPU tensors run the plain
    version."""
    check_attention_args(q, k, v, group=True)
    if q.is_cuda:
        out = launch_fwd("gqa_fwd_partial", q, k, v, causal, sm_scale,
                         partial=True)
        launches["gqa_fwd_partial"] += 1
        return out
    return gqa_fwd_partial_plain(q, k, v, causal, sm_scale)


def _bound(op, B, Hq, Hkv, Sq, Sk, D, causal, sm_scale, dtype):
    """``op`` bound to one shape and type, with the JAX factories'
    argument list; the tile sizes are the TPU's hints and the kernel
    picks its own."""
    if Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not fit {Hkv} KV heads")
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    want = ((B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D))

    def fn(q, k, v):
        got = (tuple(q.shape), tuple(k.shape), tuple(v.shape))
        if got != want or q.dtype != dtype:
            raise ValueError(f"kernel bound to {want} {dtype}, called with "
                             f"{got} {q.dtype}")
        return op(q, k, v, bool(causal), float(sm_scale))

    return fn


def gqa_fwd_kernel(B, Hq, Hkv, Sq, Sk, D, block_M, block_N, causal,
                   sm_scale, dtype, num_stages=2):
    """The forward kernel bound to one shape: ``fn(q, k, v) -> o``."""
    return _bound(gqa_fwd, B, Hq, Hkv, Sq, Sk, D, causal, sm_scale, dtype)


def gqa_fwd_partial_kernel(B, Hq, Hkv, Sq, Sk, D, block_M, block_N, causal,
                           sm_scale, dtype, num_stages=2):
    """The partial kernel bound to one shape: ``fn(q, k, v) -> (acc, m,
    l)``."""
    return _bound(gqa_fwd_partial, B, Hq, Hkv, Sq, Sk, D, causal, sm_scale,
                  dtype)


def gqa_attention(q, k, v, causal: bool = False,
                  sm_scale: Optional[float] = None, block_M: int = 128,
                  block_N: int = 128, backward: str = "kernel"):
    """Differentiable grouped-query attention on the kernels.

    q (B, Hq, Sq, D); k, v (B, Hkv, Sk, D) with Hkv dividing Hq. Without
    autograd the forward kernel runs alone. Under autograd,
    ``backward="kernel"`` (the default) runs the partial kernel forward
    and the group-summing dK/dV and dQ kernels backward;
    ``backward="reference"`` differentiates the dense reference.
    ``block_M`` and ``block_N`` are the TPU's tile hints.
    """
    check_attention_args(q, k, v, group=True)
    return differentiable(q, k, v, causal, sm_scale, backward, gqa_fwd,
                          gqa_fwd_partial, _reference_gqa)
