"""Packed ragged-batch (varlen) attention on the card, and its autograd.

Counterpart of ``tilelang_mesh_tpu/ops/flash_attention_varlen.py``. Q, K
and V are packed ``(total, heads, D)`` with ``cu_seqlens[b] ..
cu_seqlens[b + 1]`` marking sequence b; no attention crosses a sequence
boundary and rows past a sequence's end come back zero. As in the JAX
package the boundary rule is a document mask over the packed token axis:
per-token int32 sequence ids and local positions (``_seq_ids``) make it
the elementwise test ``seq_q[i] == seq_k[j]`` (and ``pos_q[i] >=
pos_k[j]`` when causal), and a block liveness table (``_block_live``)
lets a kernel skip (q-block, k-block) pairs that hold no visible pair.
Pad fills differ (-1 for Q, -2 for K), so padding never matches.

Three CUDA sources' kernels replace the TPU's four:

* ``varlen_fwd`` — ``varlen_fwd_kernel``: the normalised output
  ``l > 0 ? acc / l : 0``, used when no gradient is needed;
* ``varlen_fwd_partial`` — the same factory with ``return_partials``:
  the unnormalised float32 accumulator and per-row ``(m, l)`` in the
  exp2 domain, which the autograd forward normalises;
  (both ``csrc/flash_attention_varlen.cu``)
* ``varlen_bwd_dkdv`` — ``varlen_bwd_dkdv_kernel``: dK, dV over KV
  tiles, each KV head summing its query-head group;
* ``varlen_bwd_dq`` — ``varlen_bwd_dq_kernel``: dQ over KV tiles
  (both ``csrc/varlen_bwd.cu``).

``flash_attention_varlen`` is the entry: without autograd the forward
kernel alone; under autograd ``ops/flash_attention.py::differentiable``
runs the partial forward (saving ``lse2 = m + log2(l)``, ``-inf`` on
rows with ``l == 0``) and this module's backward, with the document
masks as operands that take no gradient. ``backward="reference"`` is
refused: a dense reference cannot see the masks.

The forward's float32 kernel runs on CUDA cores; bfloat16 and float16
run ``varlen_fwd_mma`` on the tensor cores at the tile
``varlen_tile(D)``, one kernel for both wrappers (``partial`` a runtime
flag), counted as ``varlen_fwd`` or ``varlen_fwd_partial``. The
backward's float32 kernels run on CUDA cores too; bfloat16 and float16
run ``varlen_bwd_dkdv_mma`` and ``varlen_bwd_dq_mma`` on the tensor
cores, counted as ``varlen_bwd_dkdv`` and ``varlen_bwd_dq``.

Each kernel's wrapper launches it on CUDA tensors (a build or launch
failure raises; there is no fallback to another kernel) and runs its
plain PyTorch version (``*_plain``: the
elementwise document mask over dense scores in the exp2 domain, a chunk
of query rows at a time, rounded where the kernel rounds) on CPU
tensors. The plain versions ignore the liveness table: it only skips
work the mask would zero.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..resilience.errors import KernelLaunchError
from .flash_attention import (_DTYPES, _LOG2E, KERNEL_HEAD_DIMS, _prescale_q,
                              differentiable)
from ._factory import bind
from .gemm import DTYPE_CODES, _as_dtype

__all__ = ["flash_attention_varlen", "pack_varlen", "varlen_fwd", "varlen_fwd_partial",
           "varlen_bwd_dkdv", "varlen_bwd_dq", "varlen_fwd_plain",
           "varlen_fwd_partial_plain", "varlen_bwd_dkdv_plain",
           "varlen_bwd_dq_plain", "varlen_fwd_kernel",
           "varlen_bwd_dkdv_kernel", "varlen_bwd_dq_kernel", "launches",
           "reset_launches", "PLAIN_ROWS", "VARLEN_TILES", "varlen_tile"]

# kernel name -> launches through its wrapper
launches = {"varlen_fwd": 0, "varlen_fwd_partial": 0, "varlen_bwd_dkdv": 0,
            "varlen_bwd_dq": 0}

# query rows a plain version scores at once: a dense (Hq, Tq, Tk) float32
# score matrix of a 16384-token pack at 20 heads would be 21 GB
PLAIN_ROWS = 1024


# the tensor-core forward's tile (block_M, block_N) by head_dim, one of
# csrc/attention_mma.cuh's mask_tiles instances: 128 x 64 where it is
# built (at D 128 it beat 64 x 64 on the prefill, 0.604 against 0.655 ms,
# and on the pack; scripts/varlen_sparse_gemm_ab.py, PERF.md #10)
VARLEN_TILES = {16: (64, 64), 32: (64, 64), 64: (128, 64), 128: (128, 64)}


def varlen_tile(D: int):
    """The tensor-core forward's tile ``(TM, TN)`` for head_dim ``D``,
    ``VARLEN_TILES[D]``; ``None`` for a head_dim without an instance.
    The table's cells do not enter: a tile over several cells reads
    each, and the document test masks inside a tile."""
    return VARLEN_TILES.get(int(D))


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ---------------------------------------------------------------------------
# host helpers: per-token ids and the block liveness table
# ---------------------------------------------------------------------------


def _cu_tensor(cu_seqlens, device=None) -> torch.Tensor:
    """``cu_seqlens`` (a numpy array, a sequence or a tensor) as an int32
    tensor on ``device`` (by default a tensor's own, else the CPU)."""
    if isinstance(cu_seqlens, torch.Tensor):
        return cu_seqlens.to(device=device or cu_seqlens.device,
                             dtype=torch.int32)
    return torch.as_tensor(np.asarray(cu_seqlens, np.int64),
                           device=device).to(torch.int32)


def _seq_ids(cu_seqlens, t_pad, t_real, fill, device=None):
    """Per-packed-token ``(sequence id, local position, validity)`` over
    ``t_pad`` rows: int32, int32, bool. Rows at or past ``cu[-1]`` or
    ``t_real`` are invalid, with id ``fill`` (-1 for Q, -2 for K, so
    padding never matches) and position 0."""
    cu = _cu_tensor(cu_seqlens, device)
    idx = torch.arange(t_pad, dtype=torch.int32, device=cu.device)
    sid = (torch.searchsorted(cu, idx, right=True).to(torch.int32) - 1)
    pos = idx - cu[sid.clamp(0, cu.shape[0] - 1).long()]
    valid = (idx < cu[-1]) & (idx < t_real)
    return (torch.where(valid, sid, fill).to(torch.int32),
            torch.where(valid, pos, 0).to(torch.int32), valid)


def _block_live(seq_q, valid_q, pos_q, seq_k, valid_k, pos_k, block_M,
                block_N, causal):
    """``(nQ, nK)`` int32 liveness: the blocks' sequence-id ranges
    overlap and, when causal, the pair is not provably all masked. The
    causal prune compares local positions and fires only when both
    blocks hold one common sequence; the elementwise mask in the kernel
    is exact either way."""
    big = 2 ** 30

    def rng(x, valid, block, fill, op):
        return getattr(torch.where(valid, x, fill).reshape(-1, block),
                       op)(1)

    qmin = rng(seq_q, valid_q, block_M, big, "amin")
    qmax = rng(seq_q, valid_q, block_M, -big, "amax")
    kmin = rng(seq_k, valid_k, block_N, big, "amin")
    kmax = rng(seq_k, valid_k, block_N, -big, "amax")
    live = (qmin[:, None] <= kmax[None, :]) & (qmax[:, None]
                                               >= kmin[None, :])
    if causal:
        pqmax = rng(pos_q, valid_q, block_M, -big, "amax")
        pkmin = rng(pos_k, valid_k, block_N, big, "amin")
        same_single = ((qmin == qmax)[:, None] & (kmin == kmax)[None, :]
                       & (qmin[:, None] == kmin[None, :]))
        live = live & ~(same_single & (pqmax[:, None] < pkmin[None, :]))
    return live.to(torch.int32)


def _bottom_right(pos_q, seq_q, cu_q, cu_k):
    """Each valid query's local position shifted by its sequence's
    ``len_k - len_q``, so the kernels' ``pos_q >= pos_k`` anchors the
    causal diagonal at the end of both sequences."""
    nb = cu_q.shape[0] - 1
    off = (cu_k[1:] - cu_k[:-1]) - (cu_q[1:] - cu_q[:-1])
    shift = off[seq_q.clamp(0, nb - 1).long()]
    return (pos_q + torch.where(seq_q >= 0, shift, 0)).to(torch.int32)


# ---------------------------------------------------------------------------
# argument checks
# ---------------------------------------------------------------------------


def _check(q, k, v, seq_q, seq_k, pos_q, pos_k, block_live, extra=()):
    """Shapes, types and devices of the packed kernel operands; returns
    the liveness table's ``(block_M, block_N)``."""
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"q must be (Hq, Tq, D) and k, v one (Hkv, Tk, D) "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    Hq, Tq, D = q.shape
    Hkv, Tk, Dk = k.shape
    if Dk != D or min(Hq, Hkv, Tq, Tk, D) < 1:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} must "
                         f"share a non-empty head_dim")
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} not a multiple of Hkv={Hkv}")
    if q.dtype != k.dtype or k.dtype != v.dtype or q.dtype not in _DTYPES:
        raise TypeError(f"q, k, v must share float32, bfloat16 or float16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    for name, t, n in (("seq_q", seq_q, Tq), ("seq_k", seq_k, Tk),
                       ("pos_q", pos_q, Tq), ("pos_k", pos_k, Tk)):
        if t.shape != (n,) or t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32 ({n},), got {t.dtype} "
                             f"{tuple(t.shape)}")
    if block_live.dim() != 2 or block_live.dtype != torch.int32:
        raise ValueError(f"block_live must be a 2-D int32 table, got "
                         f"{block_live.dtype} {tuple(block_live.shape)}")
    nQ, nK = block_live.shape
    if min(nQ, nK) < 1 or Tq % nQ or Tk % nK:
        raise ValueError(f"block_live {tuple(block_live.shape)} does not "
                         f"tile Tq={Tq}, Tk={Tk}")
    tensors = (q, k, v, seq_q, seq_k, pos_q, pos_k, block_live, *extra)
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"the operands must share a device, got "
                         f"{sorted(map(str, devs))}")
    dev = q.device
    if dev.type == "cuda" and D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the varlen kernels have no head_dim={D} instance "
                         f"(built: {KERNEL_HEAD_DIMS})")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return Tq // nQ, Tk // nK


def _check_bwd(q, k, v, do, lse2, delta, masks):
    bm = _check(q, k, v, *masks, extra=(do, lse2, delta))
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"dO must match q {tuple(q.shape)} {q.dtype}, got "
                         f"{tuple(do.shape)} {do.dtype}")
    for name, t in (("lse2", lse2), ("delta", delta)):
        if t.shape != q.shape[:2] or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {tuple(q.shape[:2])},"
                             f" got {t.dtype} {tuple(t.shape)}")
    return bm


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _expand_kv(t, group):
    return t if group == 1 else t.repeat_interleave(group, dim=0)


def _visible(seq_q, seq_k, pos_q, pos_k, causal):
    """(rows, Tk) bool: query i sees key j."""
    vis = seq_q[:, None] == seq_k[None, :]
    if causal:
        vis &= pos_q[:, None] >= pos_k[None, :]
    return vis


def varlen_fwd_partial_plain(q, k, v, seq_q, seq_k, pos_q, pos_k,
                             block_live, causal: bool, sm_scale: float):
    """Plain version of the partial kernel: ``(acc f32 (Hq, Tq, D), m, l
    f32 (Hq, Tq))`` in the exp2 domain. Dense scores of the prescaled Q,
    masked to -inf off the document mask; ``m = max(rowmax, -1e30)``;
    ``p = exp2(s - m)``; ``l = sum p``; ``acc = dtype(p) @ V`` in
    float32. A row that sees no key has ``l = 0``, ``acc = 0`` and ``m =
    -1e30``."""
    Hq, Tq, D = q.shape
    group = Hq // k.shape[0]
    kx = _expand_kv(k, group).float().transpose(-1, -2)
    vx = _expand_kv(v, group).float()
    qs = _prescale_q(q, sm_scale).float()
    acc = q.new_empty((Hq, Tq, D), dtype=torch.float32)
    m = q.new_empty((Hq, Tq), dtype=torch.float32)
    l = torch.empty_like(m)
    for r0 in range(0, Tq, PLAIN_ROWS):
        r1 = min(Tq, r0 + PLAIN_ROWS)
        s = torch.matmul(qs[:, r0:r1], kx)
        s.masked_fill_(~_visible(seq_q[r0:r1], seq_k, pos_q[r0:r1], pos_k,
                                 causal), -math.inf)
        mr = s.amax(dim=-1).clamp_min_(-1e30)
        p = torch.exp2_(s.sub_(mr[..., None]))
        m[:, r0:r1] = mr
        l[:, r0:r1] = p.sum(dim=-1)
        acc[:, r0:r1] = torch.matmul(p.to(q.dtype).float(), vx)
    return acc, m, l


def varlen_fwd_plain(q, k, v, seq_q, seq_k, pos_q, pos_k, block_live,
                     causal: bool, sm_scale: float) -> torch.Tensor:
    """Plain version of the forward kernel: ``l > 0 ? acc / l : 0`` in
    q's type."""
    acc, _, l = varlen_fwd_partial_plain(q, k, v, seq_q, seq_k, pos_q,
                                         pos_k, block_live, causal,
                                         sm_scale)
    lv = l[..., None]
    return torch.where(lv > 0, acc / lv, 0.0).to(q.dtype)


def _recompute(q, k, v, do, lse2, delta, seq_q, seq_k, pos_q, pos_k,
               causal, sm_scale):
    """Per chunk of query rows ``(r0, r1, P, dS)`` (Hq, rows, Tk) float32:
    ``P = exp2(Q K^T * sm_scale * log2(e) - lse2)`` where the mask sees
    the pair, else 0 (a select: ``lse2`` is -inf on rows that see no
    key); ``dS = P * (dO V^T - delta) * sm_scale``."""
    Tq = q.shape[1]
    group = q.shape[0] // k.shape[0]
    kx = _expand_kv(k, group).float().transpose(-1, -2)
    vx = _expand_kv(v, group).float().transpose(-1, -2)
    scale2 = float(sm_scale) * _LOG2E
    for r0 in range(0, Tq, PLAIN_ROWS):
        r1 = min(Tq, r0 + PLAIN_ROWS)
        s = torch.matmul(q[:, r0:r1].float(), kx)
        p = torch.exp2_(s.mul_(scale2).sub_(lse2[:, r0:r1, None]))
        p.masked_fill_(~_visible(seq_q[r0:r1], seq_k, pos_q[r0:r1], pos_k,
                                 causal), 0.0)
        dp = torch.matmul(do[:, r0:r1].float(), vx)
        ds = dp.sub_(delta[:, r0:r1, None]).mul_(p).mul_(float(sm_scale))
        yield r0, r1, p, ds


def varlen_bwd_dkdv_plain(q, k, v, do, lse2, delta, seq_q, seq_k, pos_q,
                          pos_k, block_live, causal, sm_scale):
    """Plain version of the dK/dV kernel: ``(dK, dV)`` float32 (Hkv, Tk,
    D), ``dV = sum dtype(P)^T dO`` and ``dK = sum dtype(dS)^T Q`` over
    each KV head's query heads."""
    Hq, _, D = q.shape
    Hkv, Tk = k.shape[:2]
    dt = q.dtype
    dk = q.new_zeros((Hq, Tk, D), dtype=torch.float32)
    dv = torch.zeros_like(dk)
    for r0, r1, p, ds in _recompute(q, k, v, do, lse2, delta, seq_q, seq_k,
                                    pos_q, pos_k, causal, sm_scale):
        dv += torch.matmul(p.to(dt).float().transpose(-1, -2),
                           do[:, r0:r1].float())
        dk += torch.matmul(ds.to(dt).float().transpose(-1, -2),
                           q[:, r0:r1].float())
    return (dk.view(Hkv, Hq // Hkv, Tk, D).sum(dim=1),
            dv.view(Hkv, Hq // Hkv, Tk, D).sum(dim=1))


def varlen_bwd_dq_plain(q, k, v, do, lse2, delta, seq_q, seq_k, pos_q,
                        pos_k, block_live, causal, sm_scale):
    """Plain version of the dQ kernel: dQ float32 (Hq, Tq, D) ``=
    dtype(dS) K``."""
    kx = _expand_kv(k, q.shape[0] // k.shape[0]).float()
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    for r0, r1, _, ds in _recompute(q, k, v, do, lse2, delta, seq_q, seq_k,
                                    pos_q, pos_k, causal, sm_scale):
        dq[:, r0:r1] = torch.matmul(ds.to(q.dtype).float(), kx)
    return dq


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_PTR, _INT = ctypes.c_void_p, ctypes.c_int


def _call(lib, symbol, name, ptrs, ints, floats, dev):
    """One launch of ``symbol`` in ``csrc/<lib>.cu`` (pointers, ints and
    floats in that order, then the stream), counted under the wrapper's
    ``name``, which a refused launch carries."""
    from ._build import load
    fn = getattr(load(lib), symbol)
    fn.argtypes = ([_PTR] * len(ptrs) + [_INT] * len(ints)
                   + [ctypes.c_float] * len(floats) + [_PTR])
    fn.restype = _INT
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(*(t.data_ptr() if t is not None else None for t in ptrs),
                  *ints, *floats, stream)
    if code != 0:
        raise KernelLaunchError(name, code)
    launches[name] += 1


def _launch_fwd(name, q, k, v, masks, blocks, causal, sm_scale, partial):
    from ._build import aligned16
    q, k, v = aligned16(q, k, v)
    masks = [t.contiguous() for t in masks]
    Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[:2]
    if partial:
        o = q.new_empty((Hq, Tq, D), dtype=torch.float32)
        m = q.new_empty((Hq, Tq), dtype=torch.float32)
        l = torch.empty_like(m)
    else:
        o, m, l = torch.empty_like(q), None, None
    tile = (0, 0) if q.dtype == torch.float32 else varlen_tile(D)
    _call("flash_attention_varlen", "tl_varlen_fwd_tiled", name,
          (q, k, v, *masks, o, m, l),
          (Hq, Hkv, Tq, Tk, D, *blocks, DTYPE_CODES[q.dtype],
           int(bool(causal)), int(partial), *tile),
          (float(sm_scale) * _LOG2E,), q.device)
    return (o, m, l) if partial else o


def varlen_fwd(q, k, v, seq_q, seq_k, pos_q, pos_k, block_live,
               causal: bool, sm_scale: float) -> torch.Tensor:
    """Attention output ``(Hq, Tq, D)`` in q's type over the packed
    operands of ``varlen_fwd_kernel``. CUDA tensors launch the forward
    kernel; CPU tensors run the plain version."""
    masks = (seq_q, seq_k, pos_q, pos_k, block_live)
    blocks = _check(q, k, v, *masks)
    if q.is_cuda:
        return _launch_fwd("varlen_fwd", q, k, v, masks, blocks, causal,
                           sm_scale, partial=False)
    return varlen_fwd_plain(q, k, v, *masks, causal, sm_scale)


def varlen_fwd_partial(q, k, v, seq_q, seq_k, pos_q, pos_k, block_live,
                       causal: bool, sm_scale: float):
    """Unnormalised ``(acc, m, l)`` in the exp2 domain, all float32.
    CUDA tensors launch the partial kernel; CPU tensors run the plain
    version."""
    masks = (seq_q, seq_k, pos_q, pos_k, block_live)
    blocks = _check(q, k, v, *masks)
    if q.is_cuda:
        return _launch_fwd("varlen_fwd_partial", q, k, v, masks, blocks,
                           causal, sm_scale, partial=True)
    return varlen_fwd_partial_plain(q, k, v, *masks, causal, sm_scale)


def _launch_bwd(name, q, k, v, do, lse2, delta, masks, blocks, outs, causal,
                sm_scale):
    from ._build import aligned16
    ins = [*aligned16(q, k, v, do),
           *(t.contiguous() for t in (lse2, delta, *masks))]
    Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[:2]
    _call("varlen_bwd", f"tl_{name}", name, (*ins, *outs),
          (Hq, Hkv, Tq, Tk, D, *blocks, DTYPE_CODES[q.dtype],
           int(bool(causal))), (float(sm_scale) * _LOG2E, float(sm_scale)),
          q.device)


def varlen_bwd_dkdv(q, k, v, do, lse2, delta, seq_q, seq_k, pos_q, pos_k,
                    block_live, causal, sm_scale):
    """``(dK, dV)`` float32 (Hkv, Tk, D). CUDA tensors launch the kernel;
    CPU tensors run the plain version."""
    masks = (seq_q, seq_k, pos_q, pos_k, block_live)
    blocks = _check_bwd(q, k, v, do, lse2, delta, masks)
    if not q.is_cuda:
        return varlen_bwd_dkdv_plain(q, k, v, do, lse2, delta, *masks,
                                     causal, sm_scale)
    dk = k.new_empty(k.shape, dtype=torch.float32)
    dv = torch.empty_like(dk)
    _launch_bwd("varlen_bwd_dkdv", q, k, v, do, lse2, delta, masks, blocks,
                (dk, dv), causal, sm_scale)
    return dk, dv


def varlen_bwd_dq(q, k, v, do, lse2, delta, seq_q, seq_k, pos_q, pos_k,
                  block_live, causal, sm_scale):
    """dQ float32 (Hq, Tq, D). CUDA tensors launch the kernel; CPU
    tensors run the plain version."""
    masks = (seq_q, seq_k, pos_q, pos_k, block_live)
    blocks = _check_bwd(q, k, v, do, lse2, delta, masks)
    if not q.is_cuda:
        return varlen_bwd_dq_plain(q, k, v, do, lse2, delta, *masks, causal,
                                   sm_scale)
    dq = q.new_empty(q.shape, dtype=torch.float32)
    _launch_bwd("varlen_bwd_dq", q, k, v, do, lse2, delta, masks, blocks,
                (dq,), causal, sm_scale)
    return dq


# ---------------------------------------------------------------------------
# the JAX package's factories: one shape, its argument and operand lists
# ---------------------------------------------------------------------------


def _bind(name, op, want, dtype):
    """``op`` behind a check that its operands have the bound shapes and
    q the bound type."""
    return bind(name, [(want[0], _as_dtype(dtype))]
                + [(w, None) for w in want[1:]], op)


def _shapes(Hq, Hkv, Tq, Tk, D, block_M, block_N):
    if Hq % Hkv or Tq % block_M or Tk % block_N:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}, Tq={Tq} "
                         f"of block_M={block_M} and Tk={Tk} of "
                         f"block_N={block_N}")
    return ((Tq,), (Tk,), (Tq,), (Tk,), (Tq // block_M, Tk // block_N))


def varlen_fwd_kernel(Hq, Hkv, Tq, Tk, D, block_M, block_N, causal,
                      sm_scale, dtype, num_stages=2, return_partials=False):
    """The forward kernel bound to one shape: ``fn(Q (Hq, Tq, D), K, V
    (Hkv, Tk, D), SeqQ, SeqK, PosQ, PosK, BlockLive)`` returns O in the
    input type, or ``(O f32, M, L (Hq, Tq) f32)`` with
    ``return_partials``. Tq and Tk are the padded packed lengths;
    ``num_stages`` is the TPU's pipelining hint."""
    want = ((Hq, Tq, D), (Hkv, Tk, D), (Hkv, Tk, D),
            *_shapes(Hq, Hkv, Tq, Tk, D, block_M, block_N))
    op = varlen_fwd_partial if return_partials else varlen_fwd
    return _bind("varlen_fwd_kernel",
                 lambda *a: op(*a, bool(causal), float(sm_scale)), want,
                 dtype)


def varlen_bwd_dkdv_kernel(Hq, Hkv, Tq, Tk, D, block_M, block_N, causal,
                           sm_scale, dtype, num_stages=2):
    """The dK/dV kernel bound to one shape: ``fn(Q, K, V, dO, L, Delta,
    SeqQ, SeqK, PosQ, PosK, BlockLive) -> (dK, dV)`` float32 (Hkv, Tk,
    D)."""
    want = ((Hq, Tq, D), (Hkv, Tk, D), (Hkv, Tk, D), (Hq, Tq, D), (Hq, Tq),
            (Hq, Tq), *_shapes(Hq, Hkv, Tq, Tk, D, block_M, block_N))
    return _bind("varlen_bwd_dkdv_kernel",
                 lambda *a: varlen_bwd_dkdv(*a, bool(causal),
                                            float(sm_scale)), want, dtype)


def varlen_bwd_dq_kernel(Hq, Hkv, Tq, Tk, D, block_M, block_N, causal,
                         sm_scale, dtype, num_stages=2):
    """The dQ kernel bound to one shape: ``fn(Q, K, V, dO, L, Delta,
    SeqQ, SeqK, PosQ, PosK, BlockLive) -> dQ`` float32 (Hq, Tq, D)."""
    want = ((Hq, Tq, D), (Hkv, Tk, D), (Hkv, Tk, D), (Hq, Tq, D), (Hq, Tq),
            (Hq, Tq), *_shapes(Hq, Hkv, Tq, Tk, D, block_M, block_N))
    return _bind("varlen_bwd_dq_kernel",
                 lambda *a: varlen_bwd_dq(*a, bool(causal),
                                          float(sm_scale)), want, dtype)


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------


def _varlen_bwd(q, k, v, seq_q, seq_k, pos_q, pos_k, live, o, lse2, g,
                causal, sm_scale):
    """The JAX package's ``_bwd``: ``delta = sum(f32(g) * f32(o), -1)``,
    dO in q's type, the dK/dV and dQ kernels, each gradient cast back to
    its input's type. ``lse2`` is -inf on rows that see no key, and the
    kernels' select makes their P exactly 0."""
    delta = (g.float() * o.float()).sum(dim=-1)
    do = g.to(q.dtype)
    masks = (seq_q, seq_k, pos_q, pos_k, live)
    dk, dv = varlen_bwd_dkdv(q, k, v, do, lse2, delta, *masks, causal,
                             sm_scale)
    dq = varlen_bwd_dq(q, k, v, do, lse2, delta, *masks, causal, sm_scale)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _pack(x, t_pad):
    """(T, H, D) -> (H, t_pad, D), zero rows past T."""
    return F.pad(x.transpose(0, 1), (0, 0, 0, t_pad - x.shape[0]))


def pack_varlen(q, k, v, cu_seqlens_q, cu_seqlens_k, causal: bool = False,
                block_M: int = 128, block_N: int = 128,
                causal_align: str = "top-left"):
    """The packed kernel operands of ``flash_attention_varlen``'s inputs:
    ``(Q (Hq, Tq, D), K, V (Hkv, Tk, D), (SeqQ, SeqK, PosQ, PosK,
    BlockLive))``, Tq and Tk padded to the blocks, which are clamped to
    ``min(block, max(T, 8))`` as in the JAX package (:420-427)."""
    if causal_align not in ("top-left", "bottom-right"):
        raise ValueError(
            f"causal_align must be 'top-left' or 'bottom-right', "
            f"got {causal_align!r}")
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError(f"q must be (total_q, Hq, D) and k, v (total_k, "
                         f"Hkv, D), got {tuple(q.shape)}, {tuple(k.shape)}")
    Tq, Hq = q.shape[:2]
    Tk, Hkv = k.shape[:2]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} not a multiple of Hkv={Hkv}")
    block_M = min(block_M, max(Tq, 8))
    block_N = min(block_N, max(Tk, 8))
    Tqp = -(-Tq // block_M) * block_M
    Tkp = -(-Tk // block_N) * block_N
    dev = q.device
    cu_q, cu_k = _cu_tensor(cu_seqlens_q, dev), _cu_tensor(cu_seqlens_k, dev)
    seq_q, pos_q, valid_q = _seq_ids(cu_q, Tqp, Tq, fill=-1)
    seq_k, pos_k, valid_k = _seq_ids(cu_k, Tkp, Tk, fill=-2)
    if causal and causal_align == "bottom-right":
        pos_q = _bottom_right(pos_q, seq_q, cu_q, cu_k)
    live = _block_live(seq_q, valid_q, pos_q, seq_k, valid_k, pos_k,
                       block_M, block_N, causal)
    return (_pack(q, Tqp), _pack(k, Tkp), _pack(v, Tkp),
            (seq_q, seq_k, pos_q, pos_k, live))


def flash_attention_varlen(q, k, v, cu_seqlens_q, cu_seqlens_k,
                           causal: bool = False,
                           sm_scale: Optional[float] = None,
                           block_M: int = 128, block_N: int = 128,
                           num_stages: int = 2,
                           causal_align: str = "top-left",
                           backward: str = "kernel") -> torch.Tensor:
    """Ragged-batch attention over packed tensors.

    q: (total_q, Hq, D); k, v: (total_k, Hkv, D) with Hkv dividing Hq
    (GQA when Hkv < Hq). ``cu_seqlens_*``: (B+1,) prefix sums delimiting
    each sequence, a numpy array or a tensor. Returns (total_q, Hq, D);
    rows at or past a sequence's end are zero, and no attention crosses
    a sequence boundary.

    causal_align: ``"top-left"`` masks on local positions, ``pos_q >=
    pos_k``; ``"bottom-right"`` anchors the diagonal at the end of both
    sequences (``pos_q + len_k - len_q >= pos_k``, FlashAttention >=
    2.1's convention), by shifting each sequence's query positions.
    Without autograd the forward kernel runs alone; under autograd
    (``backward="kernel"``, the only mode: a dense reference cannot see
    the document masks) the partial forward and the dK/dV and dQ
    kernels. ``block_M`` and ``block_N`` size the liveness table, as in
    the JAX package; the kernels tile by their own. ``num_stages`` is the
    TPU's pipelining hint.
    """
    qp, kp, vp, masks = pack_varlen(q, k, v, cu_seqlens_q, cu_seqlens_k,
                                    causal, block_M, block_N, causal_align)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    o = differentiable(qp, kp, vp, causal, sm_scale, backward, varlen_fwd,
                       varlen_fwd_partial, None, aux=masks, bwd=_varlen_bwd)
    return o[:, :q.shape[0]].transpose(0, 1).contiguous()
