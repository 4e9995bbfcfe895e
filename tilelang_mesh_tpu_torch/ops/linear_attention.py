"""Chunked causal linear attention and RetNet retention on the card.

Counterpart of ``tilelang_mesh_tpu/ops/linear_attention.py``. One CUDA
source (``csrc/linear_attention.cu``) holds two kernels on one chunk
loop, replacing the TPU's ``linear_attention_kernel`` and
``retention_kernel``:

* ``linear_attention(q, k, v, chunk, backward)`` — o_t = q_t sum_{s<=t}
  k_s^T v_s; q / k (B, H, S, DK), v (B, H, S, DV) in float32 or
  bfloat16, o in q's type, a float32 (DK, DV) state. The chunk falls
  back by halving to a divisor of S. ``backward="kernel"`` makes it a
  ``torch.autograd.Function`` whose backward runs the same kernel three
  times on rearranged, time-flipped operands (suffix sums are prefix
  sums of the reversed sequence):
      dq = LA(g, v, k),  dk = flip(LA(flip v, flip g, flip q)),
      dv = flip(LA(flip k, flip q, flip g));
  ``backward=None`` is forward only; any other value raises
  ``ValueError``.
* ``retention(q, k, v, gamma, chunk)`` — o_t = sum_{s<=t} gamma_h^(t-s)
  (q_t . k_s) v_s with gamma (H,) in (0, 1] (``ValueError`` otherwise),
  every power taken as exp2(log2(gamma) n) as in the TPU kernel. The
  range is checked on the host: give gamma there to keep the call from
  waiting on the card.
* ``linear_attention_grads_plain`` — the kernel backward's three calls
  on the plain version.
* ``linear_attention_reference`` / ``retention_reference`` — the dense
  (S x S) causal forms, float32 inside.

CUDA tensors launch the kernels; CPU tensors run ``linear_attention_plain``
/ ``retention_plain``, the kernels' arithmetic in eager PyTorch with the
same roundings to q's type (the state is never rounded). On the card the
kernels take chunks and widths that are multiples of 16 whose block fits
in shared memory; ``ValueError`` names the chunks they take otherwise.
"""

from __future__ import annotations

import ctypes

import torch

from . import _seqmix as sm
from ._seqmix import norm_chunk as _norm_chunk
from ._factory import bind
from .gemm import _as_dtype

__all__ = ["linear_attention", "linear_attention_plain",
           "linear_attention_grads_plain", "linear_attention_reference",
           "retention", "retention_plain", "retention_reference", "launches",
           "reset_launches", "linear_attention_kernel", "retention_kernel"]

launches = {"linear_attention": 0, "retention": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _shapes(q, k, v, what):
    if q.dim() != 4:
        raise ValueError(f"{what}: q must be (B, H, S, DK), got "
                         f"{tuple(q.shape)}")
    B, H, S, DK = q.shape
    if tuple(k.shape) != (B, H, S, DK) or tuple(v.shape[:3]) != (B, H, S) \
            or v.dim() != 4:
        raise ValueError(f"{what}: k must be {(B, H, S, DK)} and v (B, H, "
                         f"S, DV), got {tuple(k.shape)}, {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what}: k and v must have q's type {q.dtype}, got "
                        f"{k.dtype}, {v.dtype}")
    return B, H, S, DK, v.shape[-1]


def _chunk_scan_plain(q, k, v, chunk: int, lg=None) -> torch.Tensor:
    """The kernels' arithmetic; ``lg`` (H,) is log2(gamma) for retention."""
    B, H, S, DK, DV = _shapes(q, k, v, "linear_attention")
    T, f32, dev = q.dtype, torch.float32, q.device
    state = torch.zeros((B, H, DK, DV), dtype=f32, device=dev)
    o = torch.empty((B, H, S, DV), dtype=T, device=dev)
    idx = torch.arange(chunk, device=dev)
    causal = idx[:, None] >= idx[None, :]
    if lg is not None:
        lg = lg.to(f32)[:, None, None]                     # (H, 1, 1)
        row = torch.exp2(lg * (idx + 1).to(f32)[:, None])  # (H, c, 1)
        pair = torch.exp2(lg * (idx[:, None] - idx[None, :]).to(f32))
        kdec = torch.exp2(lg * (chunk - 1 - idx).to(f32)[:, None])
        gate = torch.exp2(lg * float(chunk))
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        qs, ks, vs = (t[:, :, sl].to(f32) for t in (q, k, v))
        out = qs @ state
        attn = qs @ ks.transpose(-1, -2)
        if lg is not None:
            out = out * row
            attn = attn * pair
        attn = torch.where(causal, attn, 0.0).to(T).to(f32)
        o[:, :, sl] = (out + attn @ vs).to(T)
        if lg is not None:
            kd = (ks * kdec).to(T).to(f32)
            state = state * gate + kd.transpose(-1, -2) @ vs
        else:
            state = state + ks.transpose(-1, -2) @ vs
    return o


def linear_attention_plain(q, k, v, chunk: int) -> torch.Tensor:
    """The linear-attention kernel's arithmetic in eager PyTorch."""
    return _chunk_scan_plain(q, k, v, chunk)


def retention_plain(q, k, v, gamma, chunk: int) -> torch.Tensor:
    """The retention kernel's arithmetic in eager PyTorch."""
    return _chunk_scan_plain(q, k, v, chunk, torch.log2(torch.as_tensor(
        gamma, dtype=torch.float32).to(q.device)))


def _smem(code: int, DK: int):
    fn = sm.lib_fn("linear_attention", "tl_linear_attention_smem",
                   [ctypes.c_int] * 5, ctypes.c_longlong)
    return lambda chunk, vb, r: fn(code, chunk, DK, vb, r)


def _launch(q, k, v, chunk: int, gamma=None) -> torch.Tensor:
    what = "retention" if gamma is not None else "linear_attention"
    B, H, S, DK, DV = _shapes(q, k, v, what)
    code = sm.check_card(what, q.dtype, {"chunk": chunk, "DK": DK,
                                         "DV": DV})
    vb, r = sm.plan_or_raise(what, _smem(code, DK), chunk, DV, S)
    q, k, v = sm.ready(q), sm.ready(k), sm.ready(v)
    o = torch.empty((B, H, S, DV), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr()]
    if gamma is not None:
        gamma = sm.ready(gamma)
        ptrs.append(gamma.data_ptr())
    fn = sm.lib_fn("linear_attention", "tl_" + what,
                   [ctypes.c_void_p] * (len(ptrs) + 1) + [ctypes.c_int] * 9
                   + [ctypes.c_void_p])
    sm.call(what, fn, q.device, *ptrs, o.data_ptr(), B, H, S, DK, DV, chunk,
            vb, r, code)
    launches[what] += 1
    return o


def _la(q, k, v, chunk: int) -> torch.Tensor:
    """One linear-attention call: the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if sm.device_of("linear_attention", q, k, v).type == "cuda":
        return _launch(q, k, v, chunk)
    return linear_attention_plain(q, k, v, chunk)


class _LinearAttention(torch.autograd.Function):
    """Forward: the kernel; backward: the same kernel three times."""

    @staticmethod
    def forward(ctx, q, k, v, chunk):
        ctx.save_for_backward(q, k, v)
        ctx.chunk = chunk
        return _la(q, k, v, chunk)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*_grads(_la, q, k, v, g, ctx.chunk), None)


def _grads(la, q, k, v, g, c: int):
    """dq, dk, dv of linear attention for the output gradient ``g``,
    by three calls of the forward ``la`` on rearranged operands."""
    g = g.to(q.dtype)

    def flip(x):
        return x.flip(2)

    dq = la(g, v, k, c)
    dk = flip(la(flip(v), flip(g), flip(q), c))
    dv = flip(la(flip(k), flip(q), flip(g), c))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def linear_attention_grads_plain(q, k, v, g, chunk: int):
    """The kernel backward's gradients with each kernel call replaced by
    its plain version: what ``backward="kernel"`` gives, in eager
    PyTorch."""
    return _grads(linear_attention_plain, q, k, v, g, chunk)


def linear_attention(q, k, v, chunk: int = 128, backward=None):
    """Causal linear attention o_t = q_t @ sum_{s<=t} k_s^T v_s.
    ``backward="kernel"``: differentiable, the gradients by the same
    kernel on flipped operands; ``None``: forward only."""
    chunk = _norm_chunk(int(chunk), q.shape[2])
    if backward is None:
        return _la(q, k, v, chunk)
    if backward != "kernel":
        raise ValueError(f"backward must be None or 'kernel', "
                         f"got {backward!r}")
    return _LinearAttention.apply(q, k, v, chunk)


def linear_attention_reference(q, k, v) -> torch.Tensor:
    """The dense causal form (float32 inside, o in q's type)."""
    f32 = torch.float32
    s = q.to(f32) @ k.to(f32).transpose(-1, -2)
    S = q.shape[2]
    mask = torch.tril(torch.ones((S, S), dtype=torch.bool, device=q.device))
    return (torch.where(mask, s, 0.0) @ v.to(f32)).to(q.dtype)


def _gamma(gamma, H: int, dev) -> torch.Tensor:
    """gamma (H,) float32 on ``dev``, its range checked on the host: a
    gamma given on the host costs the card no wait, one given on the
    card is read back once."""
    g = torch.as_tensor(gamma, dtype=torch.float32).reshape(-1)
    if g.numel() != H:
        raise ValueError(f"retention: gamma must hold one value a head "
                         f"({H}), got {g.numel()}")
    host = g.cpu()
    if not bool(((host > 0) & (host <= 1)).all()):
        raise ValueError("retention: gamma must lie in (0, 1]")
    return g if g.device == dev else g.to(dev, non_blocking=True)


def retention(q, k, v, gamma, chunk: int = 64) -> torch.Tensor:
    """RetNet retention: o_t = sum_{s<=t} gamma^(t-s) (q_t . k_s) v_s,
    gamma (H,) in (0, 1]."""
    dev = sm.device_of("retention", q, k, v)
    chunk = _norm_chunk(int(chunk), q.shape[2])
    g = _gamma(gamma, q.shape[1], dev)
    if dev.type == "cuda":
        return _launch(q, k, v, chunk, g)
    return retention_plain(q, k, v, g, chunk)


def retention_reference(q, k, v, gamma) -> torch.Tensor:
    """The dense decayed causal form (float32 inside, o in q's type)."""
    f32 = torch.float32
    S = q.shape[2]
    s = q.to(f32) @ k.to(f32).transpose(-1, -2)
    t = torch.arange(S, device=q.device)
    n = (t[:, None] - t[None, :]).to(f32)
    g = torch.as_tensor(gamma, dtype=f32).to(q.device)[:, None, None]
    decay = torch.where(n >= 0, g ** n, 0.0)
    return ((s * decay) @ v.to(f32)).to(q.dtype)


def _chunked(name, B, H, S, DK, DV, chunk, dtype, extra=()):
    if S % chunk:
        raise ValueError(f"{name}: chunk={chunk} does not divide S={S}")
    dt = _as_dtype(dtype)
    return [((B, H, S, DK), dt), ((B, H, S, DK), dt),
            ((B, H, S, DV), dt), *extra]


def linear_attention_kernel(B, H, S, DK, DV, chunk, dtype="float32",
                            accum_dtype="float32"):
    """The forward kernel bound to one shape (the JAX factory's
    arguments): ``fn(q, k (B, H, S, DK), v (B, H, S, DV)) -> o``."""
    if _as_dtype(accum_dtype) != torch.float32:
        raise TypeError(f"linear_attention_kernel: a {accum_dtype} "
                        f"accumulator is not ported (float32)")
    return bind("linear_attention_kernel",
                _chunked("linear_attention_kernel", B, H, S, DK, DV, chunk,
                         dtype),
                lambda q, k, v: _la(q, k, v, int(chunk)))


def retention_kernel(B, H, S, DK, DV, chunk, dtype="float32"):
    """The retention kernel bound to one shape (the JAX factory's
    arguments): ``fn(q, k, v, gamma (H,)) -> o``; gamma may be a numpy
    array."""
    return bind("retention_kernel",
                _chunked("retention_kernel", B, H, S, DK, DV, chunk, dtype,
                         [((H,), None)]),
                lambda q, k, v, gamma: retention(q, k, v, gamma,
                                                 int(chunk)))
