"""DeepSeek-V3.2 sparse attention (DSA) on the card.

Counterpart of ``tilelang_mesh_tpu/ops/dsa.py``. Three kernels make the
inference pipeline (the first two in ``csrc/dsa.cu``, the third in
``csrc/sparse_mla.cu``):

1. ``lightning_indexer`` — ``lightning_indexer_kernel``:
   ``logits[b,t,j] = sum_h w[b,t,h] * relu(qI[b,t,h,:] . kI[b,j,:])`` in
   float32, ``-inf`` where ``j > q_offset + t`` (``q_offset`` defaults to
   ``Skv - S``: the queries are the tail of the cache);
2. ``topk_selector`` — ``topk_selector_kernel``: each row's ``topk`` ids
   of the largest logits in descending order, ties to the smaller id; an
   entry at or below -1e30 (finite or not) is invalid, and slots past the
   valid entries hold -1;
3. ``sparse_mla_fwd`` — ``sparse_mla_fwd_kernel``: each (token, head)
   attends the latent rows its indices name (``0 <= idx <= q_offset +
   t``, and below Skv), scores over all D + DT features, values the first
   D; returns O (B, S, H, D) in q's type and the natural-log LSE (B, S,
   H) float32. A row with no valid index gives O = 0 and LSE =
   (-1e30 + log2(1e-30)) / log2(e), as the JAX kernel does. One launch,
   counted as ``sparse_mla_fwd``, of the kernel ``sparse_mla_path``
   picks (counted by name in ``kernel_launches``): ``sparse_mla_fwd``
   (float32, CUDA cores), ``sparse_mla_fwd_wgmma`` (bfloat16 / float16 at
   the widths of ``WGMMA_WIDTHS``) or ``sparse_mla_fwd_mma`` (bfloat16 /
   float16 at the others).

``make_sparse_mla`` is the sparse fine-tuning op: its forward is the
kernel under a ``torch.autograd.Function``, its backward autograd through
``sparse_mla_reference`` (the JAX package has no backward kernel for
DSA; its ``custom_vjp`` differentiates the same reference).

Each wrapper launches its kernel on CUDA tensors (a build or launch
failure raises) and runs its plain version on CPU tensors. The entry
points take tensors, which stay where they are, or arrays, which go to
``device`` (``cuda`` unless the caller asks for the CPU). The TPU tile
hints (``block_T``, ``block_I``) are accepted and ignored by the CUDA
kernels; ``block_I`` must still divide ``topk`` (or be at least topk),
as the JAX wrapper requires.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..resilience.errors import KernelLaunchError
from ._factory import bind
from .gemm import DTYPE_CODES, _as_dtype

__all__ = ["lightning_indexer", "lightning_indexer_plain",
           "lightning_indexer_kernel", "topk_selector",
           "topk_selector_plain", "topk_selector_kernel", "sparse_mla_fwd",
           "sparse_mla_fwd_plain", "sparse_mla_fwd_kernel",
           "sparse_mla_reference", "make_sparse_mla", "launches",
           "reset_launches", "KERNEL_WIDTHS", "DEAD_ROW_LSE",
           "SELECTOR_SMEM_BYTES", "WGMMA_WIDTHS", "sparse_mla_path",
           "kernel_launches"]

_LOG2E = 1.44269504
_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# an entry at or below this is no candidate of the selector
_INVALID = -1e30
# the LSE of a row that sees no key, as the JAX kernel computes it
DEAD_ROW_LSE = float((np.float32(-1e30) + np.float32(math.log2(1e-30)))
                     / np.float32(_LOG2E))

# (D, DT) pairs csrc/sparse_mla.cu's kernel instantiates:
# DeepSeek-V3.2's (kv_lora_rank 512, qk_rope_head_dim 64) and the tests'
KERNEL_WIDTHS = ((512, 64), (256, 64), (192, 64), (128, 64))
# the (D, DT) pairs of the 16-bit wgmma kernel: D + DT whole 64-column
# blocks of the 128-byte swizzle, and each consumer's D / 2 columns of O
# too (D 192's halves are not: it stays on the mma.sync kernel)
WGMMA_WIDTHS = tuple((d, dt) for d, dt in KERNEL_WIDTHS
                     if d % 128 == 0 and (d + dt) % 64 == 0)
# tl_sparse_mla_fwd's kernel codes
_MLA_PATHS = {"sparse_mla_fwd": 0, "sparse_mla_fwd_mma": 1,
              "sparse_mla_fwd_wgmma": 2}

# tokens a plain-version step works on (bounds its gathered rows and
# score tensors)
PLAIN_TOKENS = 256
# shared memory the selector kernel may hold for a row: its Skv keys (4
# bytes each) and its candidates (8 bytes each, the power of two at or
# above min(topk, Skv)); csrc/dsa.cu refuses more
SELECTOR_SMEM_BYTES = 200 * 1024

# kernel name -> launches through its wrapper
launches = {"lightning_indexer": 0, "topk_selector": 0,
            "sparse_mla_fwd": 0}


# the sparse MLA forward's launches by kernel (each also counts once as
# "sparse_mla_fwd" above)
kernel_launches = dict.fromkeys(_MLA_PATHS, 0)


def reset_launches() -> None:
    for d in (launches, kernel_launches):
        for k in d:
            d[k] = 0


def _tensors(*xs, device=None):
    """``xs`` as tensors: a tensor stays on its device unless ``device``
    is given; an array goes to ``device`` (``cuda`` by default). All must
    end on one device."""
    dev = None if device is None else resolve_device(device)
    out = []
    for x in xs:
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x),
                                device=dev or resolve_device(None))
        elif dev is not None:
            x = x.to(dev)
        out.append(x)
    devs = {t.device for t in out}
    if len(devs) != 1:
        raise ValueError(f"operands on {sorted(map(str, devs))}")
    return out


def _launch(lib, name, entry, ptrs, ints, floats=()):
    """One launch of ``csrc/<lib>.cu``'s ``entry`` on the pointers of
    ``ptrs``, then ``ints`` and ``floats``; raises on a non-zero code."""
    from ._build import load, stream_call
    fn = getattr(load(lib), entry)
    fn.argtypes = ([ctypes.c_void_p] * len(ptrs)
                   + [ctypes.c_int] * len(ints)
                   + [ctypes.c_float] * len(floats) + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    code = stream_call(fn, ptrs[0].device, *(t.data_ptr() for t in ptrs),
                       *(int(i) for i in ints),
                       *(float(f) for f in floats))
    if code != 0:
        raise KernelLaunchError(name, code)
    launches[name] += 1


# ---------------------------------------------------------------------------
# 1. lightning indexer
# ---------------------------------------------------------------------------


def _check_indexer(qi, ki, w):
    if qi.dim() != 4 or ki.dim() != 3 or w.dim() != 3:
        raise ValueError("want q_index (B, S, HI, DI), k_index (B, Skv, "
                         "DI), weights (B, S, HI)")
    B, S, HI, DI = qi.shape
    if ki.shape[0] != B or ki.shape[2] != DI \
            or tuple(w.shape) != (B, S, HI) or min(B, S, HI, DI,
                                                   ki.shape[1]) < 1:
        raise ValueError(f"shapes do not fit: q_index {tuple(qi.shape)}, "
                         f"k_index {tuple(ki.shape)}, weights "
                         f"{tuple(w.shape)}")
    if qi.dtype != ki.dtype or qi.dtype not in _DTYPES \
            or w.dtype != torch.float32:
        raise TypeError(f"q_index and k_index must share float32, bfloat16 "
                        f"or float16 and weights be float32, got "
                        f"{qi.dtype}, {ki.dtype}, {w.dtype}")


def lightning_indexer_plain(qi, ki, w, q_offset: int) -> torch.Tensor:
    """Plain version of the indexer: float32 products of the widened
    inputs, relu, the weighted head sum, the causal mask; PLAIN_TOKENS
    queries a step."""
    B, S, HI, DI = qi.shape
    Skv = ki.shape[1]
    out = torch.empty((B, S, Skv), dtype=torch.float32, device=qi.device)
    kf = ki.float()
    j = torch.arange(Skv, device=qi.device)
    for t0 in range(0, S, PLAIN_TOKENS):
        t1 = min(t0 + PLAIN_TOKENS, S)
        s = torch.einsum("bthd,bjd->bthj", qi[:, t0:t1].float(), kf)
        lg = (s.clamp_min_(0) * w[:, t0:t1, :, None]).sum(2)
        bound = q_offset + torch.arange(t0, t1, device=qi.device)
        out[:, t0:t1] = lg.masked_fill_(j[None, None, :]
                                        > bound[None, :, None], -math.inf)
    return out


def _indexer(qi, ki, w, q_offset: int) -> torch.Tensor:
    """Index logits (B, S, Skv) float32 of checked operands: the kernel on
    CUDA tensors, the plain version on CPU tensors."""
    if not qi.is_cuda:
        return lightning_indexer_plain(qi, ki, w, q_offset)
    B, S, HI, DI = qi.shape
    Skv = ki.shape[1]
    qi, ki, w = qi.contiguous(), ki.contiguous(), w.contiguous()
    out = torch.empty((B, S, Skv), dtype=torch.float32, device=qi.device)
    _launch("dsa", "lightning_indexer", "tl_lightning_indexer",
            (qi, ki, w, out), (B, S, Skv, HI, DI, q_offset,
                               DTYPE_CODES[qi.dtype]))
    return out


def lightning_indexer(q_index, k_index, weights, block_T: int = 64,
                      q_offset: Optional[int] = None, device=None):
    """q_index (B, S, HI, DI), k_index (B, Skv, DI), weights (B, S, HI)
    (cast to float32) -> logits (B, S, Skv) float32. q_offset: absolute
    position of query 0 in the KV timeline; defaults to Skv - S (queries
    are the cache tail). ``block_T`` is the TPU's tile hint, ignored."""
    qi, ki, w = _tensors(q_index, k_index, weights, device=device)
    w = w.float()
    _check_indexer(qi, ki, w)
    if q_offset is None:
        q_offset = ki.shape[1] - qi.shape[1]
    return _indexer(qi, ki, w, int(q_offset))


def lightning_indexer_kernel(B, S, Skv, HI, DI, block_T, q_offset, dtype):
    """``fn(QI (B, S, HI, DI), KI (B, Skv, DI), W (B, S, HI) float32) ->
    L (B, S, Skv) float32``."""
    dt = _as_dtype(dtype)
    return bind("lightning_indexer_kernel",
                [((B, S, HI, DI), dt), ((B, Skv, DI), dt),
                 ((B, S, HI), torch.float32)],
                lambda qi, ki, w: _indexer(qi, ki, w, int(q_offset)))


# ---------------------------------------------------------------------------
# 2. top-k selector
# ---------------------------------------------------------------------------


def topk_selector_plain(logits, topk: int) -> torch.Tensor:
    """Plain version of the selector: entries at or below -1e30 (and NaN)
    set to -inf, a stable descending sort (ties keep the smaller id
    first), ids past the row's valid count -1; (B, S, topk) int32."""
    L = logits.float()
    valid = L > _INVALID
    n = valid.sum(-1, keepdim=True)
    k = min(int(topk), L.shape[-1])
    ids = torch.sort(torch.where(valid, L, -math.inf), dim=-1,
                     descending=True, stable=True)[1][..., :k]
    ids = torch.where(torch.arange(k, device=L.device) < n, ids, -1)
    out = torch.full((*L.shape[:-1], int(topk)), -1, dtype=torch.int32,
                     device=L.device)
    out[..., :k] = ids
    return out


def _selector(logits, topk: int) -> torch.Tensor:
    if not logits.is_cuda:
        return topk_selector_plain(logits, topk)
    B, S, Skv = logits.shape
    need = 8 * (1 << (min(topk, Skv) - 1).bit_length()) + 4 * Skv
    if need > SELECTOR_SMEM_BYTES:
        raise ValueError(f"topk_selector: a row of {Skv} keys with topk "
                         f"{topk} needs {need} bytes of shared memory, the "
                         f"kernel holds {SELECTOR_SMEM_BYTES}")
    logits = logits.contiguous()
    out = torch.empty((B, S, topk), dtype=torch.int32, device=logits.device)
    if B * S:
        _launch("dsa", "topk_selector", "tl_topk_selector",
                (logits, out), (B * S, Skv, topk))
    return out


def topk_selector(logits, topk: int, block_T: int = 64, device=None):
    """logits (B, S, Skv) float32 -> (B, S, topk) int32: each row's topk
    ids by descending logit, ties to the smaller id, -1 once the entries
    above -1e30 run out. ``block_T`` is the TPU's tile hint, ignored."""
    (L,) = _tensors(logits, device=device)
    if L.dim() != 3 or L.dtype != torch.float32 or L.shape[-1] < 1:
        raise ValueError(f"want float32 logits (B, S, Skv), got {L.dtype} "
                         f"{tuple(L.shape)}")
    if int(topk) < 1:
        raise ValueError(f"topk must be positive, got {topk}")
    return _selector(L, int(topk))


def topk_selector_kernel(B, S, Skv, topk, block_T):
    """``fn(L (B, S, Skv) float32) -> I (B, S, topk) int32``."""
    return bind("topk_selector_kernel", [((B, S, Skv), torch.float32)],
                lambda L: _selector(L, int(topk)))


# ---------------------------------------------------------------------------
# 3. sparse MLA forward
# ---------------------------------------------------------------------------


def _tail_split(Dfull, tail_dim):
    if tail_dim is None:
        if Dfull % 128 == 0:
            raise ValueError(
                f"q feature dim {Dfull} is a multiple of 128: pass "
                "tail_dim explicitly (the default heuristic — tail 64 when "
                "D+tail is not 128-aligned — cannot infer the rope split)")
        tail_dim = 64
    if not 0 <= tail_dim < Dfull:
        raise ValueError(f"tail_dim {tail_dim} out of range for feature "
                         f"dim {Dfull}")
    return Dfull - tail_dim, tail_dim


def _check_mla(q, kv, ind, D):
    if q.dim() != 4 or kv.dim() != 3 or ind.dim() != 3:
        raise ValueError("want q (B, S, H, D+DT), kv (B, Skv, D+DT), "
                         "indices (B, S, topk)")
    B, S, H, Dfull = q.shape
    if kv.shape[0] != B or kv.shape[2] != Dfull \
            or tuple(ind.shape[:2]) != (B, S) or min(q.shape) < 1 \
            or min(ind.shape) < 1 or kv.shape[1] < 1:
        raise ValueError(f"shapes do not fit: q {tuple(q.shape)}, kv "
                         f"{tuple(kv.shape)}, indices {tuple(ind.shape)}")
    if q.dtype != kv.dtype or q.dtype not in _DTYPES:
        raise TypeError(f"q and kv must share float32, bfloat16 or "
                        f"float16, got {q.dtype}, {kv.dtype}")
    if ind.dtype != torch.int32:
        raise TypeError(f"indices must be int32, got {ind.dtype}")
    if q.is_cuda and (D, Dfull - D) not in KERNEL_WIDTHS:
        raise ValueError(f"the sparse MLA kernel takes (D, DT) in "
                         f"{KERNEL_WIDTHS}, got {(D, Dfull - D)}")


def _token_gather(kv, ind, t0, t1, q_offset):
    """The latent rows ``g (B, n, topk, D+DT)`` indices ``t0 .. t1`` name
    (clamped into the cache) and the mask ``ok (B, n, topk)`` of the
    valid ones: ``0 <= idx <= q_offset + t`` and below Skv."""
    B, Skv = kv.shape[:2]
    ic = ind[:, t0:t1].long()
    bound = q_offset + torch.arange(t0, t1, device=kv.device)
    ok = (ic >= 0) & (ic <= bound[None, :, None]) & (ic < Skv)
    g = kv[torch.arange(B, device=kv.device)[:, None, None],
           ic.clamp(0, Skv - 1)]
    return g, ok


def sparse_mla_fwd_plain(q, kv, ind, D: int, sm_scale: float,
                         q_offset: int):
    """Plain version of the kernels, PLAIN_TOKENS queries a step: float32
    scores over all features in the exp2 domain, ``m = max(rowmax,
    -1e30)``, ``p = exp2(s - m)`` rounded to q's type before ``p @ v``
    (``l`` sums the unrounded ``p``), ``O = acc / max(l, 1e-30)`` in q's
    type, ``LSE = (m + log2(max(l, 1e-30))) / log2(e)``."""
    B, S, H, _ = q.shape
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, S, H), dtype=torch.float32, device=q.device)
    scale = float(sm_scale) * _LOG2E
    for t0 in range(0, S, PLAIN_TOKENS):
        t1 = min(t0 + PLAIN_TOKENS, S)
        g, ok = _token_gather(kv, ind, t0, t1, q_offset)
        s = torch.einsum("bthd,btkd->bthk", q[:, t0:t1].float(), g.float())
        s.mul_(scale).masked_fill_(~ok[:, :, None, :], -math.inf)
        m = s.amax(-1, keepdim=True).clamp_min_(_INVALID)
        p = torch.exp2_(s.sub_(m))
        l = p.sum(-1).clamp_min_(1e-30)
        acc = torch.einsum("bthk,btkd->bthd", p.to(q.dtype).float(),
                           g[..., :D].float())
        o[:, t0:t1] = (acc / l[..., None]).to(q.dtype)
        lse[:, t0:t1] = (m[..., 0] + torch.log2(l)) / _LOG2E
    return o, lse


def sparse_mla_path(D: int, DT: int, dtype) -> str:
    """Which kernel of ``sparse_mla.cu`` runs a forward of latent D, tail
    DT and ``dtype`` on the card, decided before any launch: float32
    ``sparse_mla_fwd`` (CUDA cores); bfloat16 / float16
    ``sparse_mla_fwd_wgmma`` at ``WGMMA_WIDTHS``, ``sparse_mla_fwd_mma``
    at the other widths."""
    if _as_dtype(dtype) == torch.float32:
        return "sparse_mla_fwd"
    return "sparse_mla_fwd_wgmma" if (D, DT) in WGMMA_WIDTHS \
        else "sparse_mla_fwd_mma"


def _sparse_mla(q, kv, ind, D: int, sm_scale: float, q_offset: int):
    if not q.is_cuda:
        return sparse_mla_fwd_plain(q, kv, ind, D, sm_scale, q_offset)
    B, S, H, Dfull = q.shape
    # the kernels read q and kv rows 16 bytes at a time
    q, kv = (t if t.data_ptr() % 16 == 0 else t.clone()
             for t in (q.contiguous(), kv.contiguous()))
    ind = ind.contiguous()
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, S, H), dtype=torch.float32, device=q.device)
    path = sparse_mla_path(D, Dfull - D, q.dtype)
    _launch("sparse_mla", "sparse_mla_fwd", "tl_sparse_mla_fwd",
            (q, kv, ind, o, lse),
            (B, S, kv.shape[1], H, D, Dfull - D, ind.shape[-1], q_offset,
             DTYPE_CODES[q.dtype], _MLA_PATHS[path]),
            (float(sm_scale) * _LOG2E,))
    kernel_launches[path] += 1
    return o, lse


def _mla_args(q, kv, indices, sm_scale, block_I, tail_dim, q_offset,
              device):
    q, kv, ind = _tensors(q, kv, indices, device=device)
    ind = ind.to(torch.int32)
    D, _ = _tail_split(q.shape[-1], tail_dim)
    _check_mla(q, kv, ind, D)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q_offset is None:
        q_offset = kv.shape[1] - q.shape[1]
    topk = ind.shape[-1]
    BI = min(block_I, topk)
    if topk % BI:
        raise ValueError(f"topk ({topk}) must be a multiple of block_I "
                         f"({BI})")
    return q, kv, ind, D, float(sm_scale), int(q_offset)


def sparse_mla_fwd(q, kv, indices, sm_scale=None, block_I: int = 64,
                   tail_dim=None, q_offset=None, device=None):
    """q (B, S, H, D+DT) with D = kv latent dim, DT = rope tail; kv
    (B, Skv, D+DT); indices (B, S, topk) (-1: none). q_offset: absolute
    position of query 0 in the KV timeline (default Skv - S). Returns
    (o (B, S, H, D) in q's type, lse (B, S, H) float32)."""
    q, kv, ind, D, sm, off = _mla_args(q, kv, indices, sm_scale, block_I,
                                       tail_dim, q_offset, device)
    return _sparse_mla(q, kv, ind, D, sm, off)


def sparse_mla_fwd_kernel(B, S, Skv, H, D, DT, topk, BI, q_offset,
                          sm_scale, dtype):
    """``fn(Q (B, S, H, D+DT), KV (B, Skv, D+DT), Ind (B, S, topk) int32)
    -> (O (B, S, H, D), Lse (B, S, H) float32)``."""
    dt = _as_dtype(dtype)
    return bind("sparse_mla_fwd_kernel",
                [((B, S, H, D + DT), dt), ((B, Skv, D + DT), dt),
                 ((B, S, topk), torch.int32)],
                lambda q, kv, ind: _sparse_mla(q, kv, ind, int(D),
                                               float(sm_scale),
                                               int(q_offset)))


def sparse_mla_reference(q, kv, indices, sm_scale=None, tail_dim=None,
                         q_offset=None, device=None):
    """The JAX package's dense gather reference (``ref_sparse_mla_fwd``),
    differentiable in q and kv: every token's rows gathered at once, a
    natural-exp softmax in float32 with no floor, so a row with no valid
    index gives NaN in O and LSE, as JAX's reference does. Indices are
    clamped into the cache before the gather. The rows are gathered from
    kv widened to float32 (exact, so the forward is JAX's), so the
    gather's backward sums a row's gradients in float32 before the one
    rounding to kv's type, not in a bfloat16 scatter-add."""
    q, kv, ind = _tensors(q, kv, indices, device=device)
    B, S, H, Dfull = q.shape
    Skv = kv.shape[1]
    D, _ = _tail_split(Dfull, tail_dim)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(Dfull)
    if q_offset is None:
        q_offset = Skv - S
    ic = ind.long()
    g = kv.float()[torch.arange(B, device=kv.device)[:, None, None],
                   ic.clamp(0, Skv - 1)]
    scores = torch.einsum("bshd,bskd->bshk", q.float(), g) * sm_scale
    t = torch.arange(S, device=q.device)[None, :, None]
    valid = (ic >= 0) & (ic <= q_offset + t)
    scores = torch.where(valid[:, :, None, :], scores, -math.inf)
    m = scores.amax(-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bshk,bskd->bshd", p / l.clamp_min(1e-30),
                     g[..., :D])
    lse = m[..., 0] + torch.log(l[..., 0].clamp_min(1e-30))
    return o.to(q.dtype), lse


# ---------------------------------------------------------------------------
# 4. differentiable sparse MLA (sparse fine-tuning)
# ---------------------------------------------------------------------------


class _SparseMLA(torch.autograd.Function):
    """Forward: the sparse MLA kernel (the plain version on CPU tensors).
    Backward: autograd through ``sparse_mla_reference`` with the same
    ``sm_scale`` and ``tail_dim`` and the default ``q_offset``; no
    gradient for the indices."""

    @staticmethod
    def forward(ctx, q, kv, ind, D, sm_scale, tail_dim):
        ctx.save_for_backward(q, kv, ind)
        ctx.sm_scale, ctx.tail_dim = sm_scale, tail_dim
        o, _ = _sparse_mla(q, kv, ind, D, sm_scale, kv.shape[1] - q.shape[1])
        return o

    @staticmethod
    def backward(ctx, do):
        q, kv, ind = ctx.saved_tensors
        with torch.enable_grad():
            qq, kk = (t.detach().requires_grad_() for t in (q, kv))
            o, _ = sparse_mla_reference(qq, kk, ind, sm_scale=ctx.sm_scale,
                                        tail_dim=ctx.tail_dim)
            dq, dkv = torch.autograd.grad(o, (qq, kk), do)
        return dq, dkv, None, None, None, None


def make_sparse_mla(sm_scale=None, block_I: int = 64, tail_dim=None):
    """Returns a differentiable ``sparse_mla(q, kv, indices) -> o``:
    gradients flow into q and kv (tensors that require them), the
    forward runs the kernel, the backward recomputes through the dense
    reference."""

    def sparse_mla(q, kv, indices):
        q, kv, ind, D, sm, _ = _mla_args(q, kv, indices, sm_scale, block_I,
                                         tail_dim, None, None)
        return _SparseMLA.apply(q, kv, ind, D, sm, tail_dim)

    return sparse_mla
