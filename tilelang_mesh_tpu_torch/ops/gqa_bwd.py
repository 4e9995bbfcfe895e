"""Grouped-query attention backward on the card.

Counterpart of ``tilelang_mesh_tpu/ops/gqa_bwd.py``. Two CUDA kernels
(``csrc/gqa_bwd.cu``) replace the TPU's, keeping its no-atomics split so
each output element is written once and the result is deterministic
(float32 on CUDA cores; bfloat16 and float16 on the tensor cores,
``mma.sync`` with ``cp.async`` loads):

* ``gqa_bwd_dkdv`` — ``gqa_bwd_dkdv_kernel``: a block per KV tile loops
  over its group's query heads and their Q tiles;
* ``gqa_bwd_dq`` — ``gqa_bwd_dq_kernel``: a block per Q tile loops over
  the KV tiles.

Softmax is recomputed from the forward's ``lse2 = m + log2(l)`` in the
exp2 domain (``P = exp2(Q K^T * sm_scale * log2(e) - lse2)``), so
``dS = P * (dO V^T - delta) * sm_scale`` exactly. P and dS are rounded
to the input type before their products, as the TPU kernels do. Query
head h reads KV head ``h // (Hq // Hkv)``; MHA is group 1.

Each wrapper launches its kernel on CUDA tensors (a build or launch
failure raises) and runs its plain PyTorch version (dense recompute,
``*_plain``) on CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from ..resilience.errors import KernelLaunchError
from .flash_attention import _LOG2E, causal_mask, check_attention_args
from ._factory import bind
from .gemm import DTYPE_CODES, _as_dtype

__all__ = ["gqa_attention_bwd", "gqa_bwd_dkdv", "gqa_bwd_dq",
           "gqa_bwd_dkdv_plain", "gqa_bwd_dq_plain", "launches",
           "reset_launches", "gqa_bwd_dkdv_kernel", "gqa_bwd_dq_kernel"]

# kernel name -> launches through its wrapper
launches = {"gqa_bwd_dkdv": 0, "gqa_bwd_dq": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _check(q, k, v, do, lse2, delta):
    check_attention_args(q, k, v, group=True)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"dO must match q {tuple(q.shape)} {q.dtype}, got "
                         f"{tuple(do.shape)} {do.dtype}")
    for name, t in (("lse2", lse2), ("delta", delta)):
        if t.shape != q.shape[:3] or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {tuple(q.shape[:3])},"
                             f" got {t.dtype} {tuple(t.shape)}")
    if {t.device for t in (do, lse2, delta)} != {q.device}:
        raise ValueError("q, dO, lse2 and delta must share a device")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _expand_kv(t, group):
    return t if group == 1 else t.repeat_interleave(group, dim=1)


def _probs_and_dscores(q, k, v, do, lse2, delta, causal, sm_scale):
    """Dense recompute: ``(P, dS)`` (B, Hq, Sq, Sk) float32."""
    group = q.shape[1] // k.shape[1]
    s = torch.matmul(q.float(), _expand_kv(k, group).float().transpose(-1,
                                                                       -2))
    p = torch.exp2_(s.mul_(float(sm_scale) * _LOG2E).sub_(lse2[..., None]))
    if causal:
        p.masked_fill_(~causal_mask(p.shape[-2], p.shape[-1], p.device), 0.0)
    dp = torch.matmul(do.float(),
                      _expand_kv(v, group).float().transpose(-1, -2))
    ds = dp.sub_(delta[..., None]).mul_(p).mul_(float(sm_scale))
    return p, ds


def _sum_group(t, Hkv):
    B, Hq, S, D = t.shape
    return t if Hq == Hkv else t.view(B, Hkv, Hq // Hkv, S, D).sum(dim=2)


def gqa_bwd_dkdv_plain(q, k, v, do, lse2, delta, causal, sm_scale):
    """Plain version of the dK/dV kernel: ``(dK, dV)`` float32
    (B, Hkv, Sk, D), summed over each KV head's query heads."""
    p, ds = _probs_and_dscores(q, k, v, do, lse2, delta, causal, sm_scale)
    dt = q.dtype
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), do.float())
    dk = torch.matmul(ds.to(dt).float().transpose(-1, -2), q.float())
    return _sum_group(dk, k.shape[1]), _sum_group(dv, k.shape[1])


def gqa_bwd_dq_plain(q, k, v, do, lse2, delta, causal, sm_scale):
    """Plain version of the dQ kernel: dQ float32 (B, Hq, Sq, D)."""
    _, ds = _probs_and_dscores(q, k, v, do, lse2, delta, causal, sm_scale)
    group = q.shape[1] // k.shape[1]
    return torch.matmul(ds.to(q.dtype).float(),
                        _expand_kv(k, group).float())


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_PTR, _INT = ctypes.c_void_p, ctypes.c_int


def _launch(name, q, k, v, do, lse2, delta, outs, causal, sm_scale):
    from ._build import load
    # the tensor-core kernels read 16-byte pieces of rows by cp.async
    args = [t.contiguous() for t in (q, k, v, do, lse2, delta)]
    args = [t.clone() if t.data_ptr() % 16 else t for t in args]
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    fn = getattr(load("gqa_bwd"), f"tl_{name}")
    fn.argtypes = ([_PTR] * (6 + len(outs)) + [_INT] * 8
                   + [ctypes.c_float, ctypes.c_float, _PTR])
    fn.restype = _INT
    dev = q.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(*(t.data_ptr() for t in args),
                  *(t.data_ptr() for t in outs), B, Hq, Hkv, Sq, Sk, D,
                  DTYPE_CODES[q.dtype], int(bool(causal)),
                  float(sm_scale) * _LOG2E, float(sm_scale), stream)
    if code != 0:
        raise KernelLaunchError(name, code)
    launches[name] += 1


def gqa_bwd_dkdv(q, k, v, do, lse2, delta, causal, sm_scale):
    """``(dK, dV)`` float32 (B, Hkv, Sk, D). CUDA tensors launch the
    kernel; CPU tensors run the plain version."""
    _check(q, k, v, do, lse2, delta)
    if not q.is_cuda:
        return gqa_bwd_dkdv_plain(q, k, v, do, lse2, delta, causal, sm_scale)
    dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=v.device)
    _launch("gqa_bwd_dkdv", q, k, v, do, lse2, delta, (dk, dv), causal,
            sm_scale)
    return dk, dv


def gqa_bwd_dq(q, k, v, do, lse2, delta, causal, sm_scale):
    """dQ float32 (B, Hq, Sq, D). CUDA tensors launch the kernel; CPU
    tensors run the plain version."""
    _check(q, k, v, do, lse2, delta)
    if not q.is_cuda:
        return gqa_bwd_dq_plain(q, k, v, do, lse2, delta, causal, sm_scale)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _launch("gqa_bwd_dq", q, k, v, do, lse2, delta, (dq,), causal, sm_scale)
    return dq


def gqa_attention_bwd(q, k, v, o, lse2, g, causal, sm_scale, block_M=128,
                      block_N=128, delta=None):
    """``(dq, dk, dv)`` in the input types, from the forward's output
    ``o`` and ``lse2 = m + log2(l)`` (exp2 domain) and the incoming
    gradient ``g``. ``delta`` (= sum(g * o, -1), float32) may be passed
    by callers that already computed it. ``block_M`` and ``block_N`` are
    the TPU's tile hints (the JAX signature); the kernels pick their
    own tiles."""
    if delta is None:
        delta = (g.float() * o.float()).sum(dim=-1)
    dk, dv = gqa_bwd_dkdv(q, k, v, g, lse2, delta, causal, sm_scale)
    dq = gqa_bwd_dq(q, k, v, g, lse2, delta, causal, sm_scale)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bwd_specs(B, Hq, Hkv, Sq, Sk, D, dtype):
    dt = _as_dtype(dtype)
    return [((B, Hq, Sq, D), dt), ((B, Hkv, Sk, D), dt),
            ((B, Hkv, Sk, D), dt), ((B, Hq, Sq, D), dt),
            ((B, Hq, Sq), torch.float32), ((B, Hq, Sq), torch.float32)]


def gqa_bwd_dkdv_kernel(B, Hq, Hkv, Sq, Sk, D, block_M, block_N, causal,
                        sm_scale, dtype, num_stages=2):
    """The dK/dV kernel bound to one shape (the JAX factory's arguments):
    ``fn(q, k, v, do, lse2, delta) -> (dk, dv)`` float32."""
    return bind("gqa_bwd_dkdv_kernel",
                _bwd_specs(B, Hq, Hkv, Sq, Sk, D, dtype),
                lambda *a: gqa_bwd_dkdv(*a, bool(causal), float(sm_scale)))


def gqa_bwd_dq_kernel(B, Hq, Hkv, Sq, Sk, D, block_M, block_N, causal,
                      sm_scale, dtype, num_stages=2):
    """The dQ kernel bound to one shape (the JAX factory's arguments):
    ``fn(q, k, v, do, lse2, delta) -> dq`` float32."""
    return bind("gqa_bwd_dq_kernel",
                _bwd_specs(B, Hq, Hkv, Sq, Sk, D, dtype),
                lambda *a: gqa_bwd_dq(*a, bool(causal), float(sm_scale)))
