"""Native Sparse Attention (DeepSeek NSA) on the card.

Counterpart of ``tilelang_mesh_tpu/ops/nsa.py`` (semantics of the
upstream ``naive_nsa``): every query token attends (a) a per-token set
of S selected KV blocks of ``block_size`` keys, gated by ``g_slc``, and
(b) an optional sliding window, gated by ``g_swa``. The G = HQ // H
query heads that share a KV head are one group. One CUDA source
(``csrc/nsa.cu``) replaces four TPU kernels, which share its gather:

* ``nsa_fwd`` — ``nsa_fwd_kernel``: both branches, gates applied, for
  ``nsa_attention``;
* ``nsa_varlen_fwd`` — ``nsa_varlen_fwd_kernel``: the selected branch
  over packed sequences, block ids turned into raw packed row offsets,
  for ``nsa_attention_varlen``;
* ``nsa_decode_fwd`` — ``nsa_decode_kernel``: one token, the causal
  bound the last key, for ``nsa_decode``, in two launches: the token's
  selected slots cut into runs (``decode_splits``, one block a run) that
  write float32 ``(acc, m, l)`` partials (``nsa_decode_partials``), then
  their fixed-order combine with the gate (``nsa_decode_combine``,
  counted as ``nsa_decode_combine``);
* ``nsa_fwd_partial`` — ``nsa_fwd_partial_kernel``: the selected branch
  without gates, its unnormalised ``(acc, m, l)`` in the exp2 domain,
  for ``nsa_attention(backward="kernel")`` under autograd.

Every key read lies below the key length: on a ragged tail (T not a
multiple of the block size) the TPU kernel's block copy runs past it and
reads other rows, so the JAX kernel differs from its own reference
there; the port follows the reference (``nsa_reference``). K and V are
taken in the callers' (B, T, H, D) layout as strided views, with no
copy. ``backward="kernel"`` is NSA training: the partial forward here,
its output normalised outside the kernel and the gate applied outside
the autograd Function (so d(g_slc) comes from autograd, as it comes
from jax AD), and the dK/dV and dQ kernels of ``ops/nsa_bwd.py``.

Each wrapper launches its kernel on CUDA tensors (a build or launch
failure raises) and runs its plain version on CPU tensors: each token's
keys gathered a chunk of tokens at a time (so no call holds all tokens'
gathered keys at once), an exp2 softmax rounded where the kernel rounds.
float32 runs on the CUDA cores; bfloat16 and float16 on the tensor
cores, which walk a branch's keys in chunks of ``KERNEL_CHUNK``: at a
group of up to 16 a warp takes a token (four tokens a block share the
window's loads); decode's splits and larger groups deal one token's
chunks out to ``KERNEL_STREAMS`` warps and merge their states in a fixed
order. ``nsa_fwd_streams_plain`` emulates that walk (one stream: a
warp's own), and ``nsa_decode_split_plain`` decode's split.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import numpy as np
import torch

from ..resilience.errors import KernelLaunchError
from ._factory import bind
from .flash_attention import _DTYPES, _LOG2E, KERNEL_HEAD_DIMS
from .flash_attention_varlen import _cu_tensor, _seq_ids
from .gemm import DTYPE_CODES, _as_dtype

__all__ = ["nsa_attention", "nsa_attention_varlen", "nsa_decode",
           "nsa_reference", "nsa_fwd", "nsa_fwd_plain", "nsa_fwd_kernel",
           "nsa_fwd_streams_plain", "nsa_varlen_fwd", "nsa_varlen_fwd_plain",
           "nsa_varlen_fwd_kernel", "nsa_decode_fwd", "nsa_decode_fwd_plain",
           "nsa_decode_kernel", "nsa_decode_partials",
           "nsa_decode_partials_plain", "nsa_decode_combine",
           "nsa_decode_combine_plain", "nsa_decode_split_plain",
           "decode_splits", "resident_blocks", "merge_partials",
           "nsa_fwd_partial", "nsa_fwd_partial_plain",
           "nsa_fwd_partial_kernel", "nsa_dense",
           "varlen_offsets", "launches", "reset_launches",
           "KERNEL_MAX_GROUP", "KERNEL_CHUNK", "KERNEL_STREAMS"]

# kernel name -> launches through its wrapper
launches = {"nsa_fwd": 0, "nsa_varlen_fwd": 0, "nsa_decode": 0,
            "nsa_decode_combine": 0, "nsa_fwd_partial": 0}

# the largest group (query heads a KV head) the kernel's row tile holds
KERNEL_MAX_GROUP = 64
# the 16-bit kernels (csrc/nsa.cu): keys a chunk, and the warps that walk
# one token's chunks side by side in decode's splits at a group of up to
# 16 (nsa_fwd_mma; the prefill forwards take a warp a token)
KERNEL_CHUNK = 16
KERNEL_STREAMS = 4
# tokens a plain-version step gathers keys for
PLAIN_TOKENS = 256


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _int32(x, device) -> torch.Tensor:
    """An int32 tensor on ``device`` from a tensor or an array."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x.to(device=device, dtype=torch.int32)


def _counts(block_counts, S: int, shape, device) -> torch.Tensor:
    """Slots each (token, KV head) reads: all S (None), an int, or an
    array of ``shape``."""
    if block_counts is None or isinstance(block_counts, int):
        n = S if block_counts is None else block_counts
        return torch.full(shape, n, dtype=torch.int32, device=device)
    return _int32(block_counts, device)


def _check(q, kh, vh, ids, cnt, gates, what: str) -> None:
    """q (..., G, D) of N tokens' groups; kh, vh (B, H, Tk, D) views;
    ids (N..., H, S), cnt (N..., H), gates (N..., H, G) or None."""
    if gates is None:                     # the partial forward has none
        gates = torch.empty(q.shape[:-1], device=q.device)
    if q.dtype != kh.dtype or kh.dtype != vh.dtype or q.dtype not in _DTYPES:
        raise TypeError(f"{what}: q, k, v must share float32, bfloat16 or "
                        f"float16, got {q.dtype}, {kh.dtype}, {vh.dtype}")
    if kh.shape != vh.shape or kh.stride() != vh.stride() \
            or kh.stride(-1) != 1:
        raise ValueError(f"{what}: k and v must share a shape and strides "
                         f"with contiguous head_dim")
    if ids.dtype != torch.int32 or cnt.dtype != torch.int32 \
            or gates.dtype != torch.float32:
        raise TypeError(f"{what}: ids and counts must be int32 and gates "
                        f"float32, got {ids.dtype}, {cnt.dtype}, "
                        f"{gates.dtype}")
    G, D = q.shape[-2:]
    H = kh.shape[1]
    if kh.shape[0] != q.shape[0] or kh.shape[-1] != D or q.shape[-3] != H \
            or ids.shape[:-1] != q.shape[:-2] or cnt.shape != q.shape[:-2] \
            or gates.shape != q.shape[:-1]:
        raise ValueError(f"{what}: shapes do not fit: q {tuple(q.shape)}, "
                         f"k {tuple(kh.shape)}, ids {tuple(ids.shape)}, "
                         f"counts {tuple(cnt.shape)}, gates "
                         f"{tuple(gates.shape)}")
    devs = {t.device for t in (q, kh, vh, ids, cnt, gates)}
    if len(devs) != 1:
        raise ValueError(f"{what}: operands on {sorted(map(str, devs))}")
    dev = q.device
    if dev.type == "cuda" and (D not in KERNEL_HEAD_DIMS
                               or G > KERNEL_MAX_GROUP):
        raise ValueError(f"{what}: the kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS} and groups of at most "
                         f"{KERNEL_MAX_GROUP}, got {D}, {G}")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{what}: unsupported device {dev}")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _key_index(kh, b, start, length: int, bound):
    """The gather of the keys ``start[n, h, s] + j``, j < ``length``, of
    batch ``b[n]``: ``(at, ok)``, ``kh[at]`` the (N, H, S * length, D)
    keys and ``ok`` those at most ``bound[n]``, below Tk and of slots
    with ``start >= 0``."""
    N, H = start.shape[:2]
    Tk = kh.shape[2]
    dev = kh.device
    keys = start[..., None] + torch.arange(length, device=dev)
    ok = (start >= 0)[..., None] & (keys <= bound[:, None, None, None]) \
        & (keys < Tk)
    keys, ok = keys.reshape(N, H, -1), ok.reshape(N, H, -1)
    at = (b[:, None, None], torch.arange(H, device=dev)[None, :, None],
          keys.clamp(0, Tk - 1))
    return at, ok


def _branch(q, kh, vh, b, start, length: int, bound, sm_scale: float):
    """One branch for N tokens' groups ``q (N, H, G, D)`` over the keys of
    ``_key_index``. Exp2 scores, ``m = max(rowmax, -1e30)``, ``p =
    exp2(s - m)``, ``acc = dtype(p) @ v``: returns the unnormalised
    ``(acc, m, l)`` float32, acc (N, H, G, D), m and l (N, H, G)."""
    at, ok = _key_index(kh, b, start, length, bound)
    return _softmax(q, kh, vh, at, ok, sm_scale)


def _softmax(q, kh, vh, at, ok, sm_scale: float):
    """``_branch``'s online softmax over the keys ``kh[at]`` where ``ok``."""
    s = torch.einsum("nhgd,nhld->nhgl", q.float(), kh[at].float())
    s.mul_(float(sm_scale) * _LOG2E).masked_fill_(~ok[:, :, None, :],
                                                  -math.inf)
    m = s.amax(dim=-1, keepdim=True).clamp_min_(-1e30)
    p = torch.exp2_(s.sub_(m))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("nhgl,nhld->nhgd", p.to(q.dtype).float(),
                       vh[at].float())
    return acc, m[..., 0], l[..., 0]


def _normalised(acc, l):
    return acc / l.clamp_min(1e-30)[..., None]


def merge_partials(acc, m, l, dim: int):
    """The fixed-order merge of exp2-domain states along ``dim`` of ``m``,
    ``l`` (and of ``acc``, which has one more, last, dimension): the
    merged max, each state weighed by ``exp2(m_x - max)`` (0 where
    ``m_x`` is -inf: a state that saw nothing) and ``acc``, ``l`` summed
    in index order, as the kernels merge. Returns ``(acc, m, l)``."""
    mx = m.amax(dim=dim)
    a = torch.zeros_like(acc.select(dim, 0))
    s = torch.zeros_like(mx)
    for mx_, a_, l_ in zip(m.unbind(dim), acc.unbind(dim), l.unbind(dim)):
        w = torch.where(mx_ == -math.inf, 0.0, torch.exp2(mx_ - mx))
        a = a + a_ * w[..., None]
        s = s + l_ * w
    return a, mx, s


def _branch_streams(q, kh, vh, b, start, length: int, bound,
                    sm_scale: float, streams: int, chunk: int):
    """``_branch`` as the 16-bit kernels walk it: each slot's visible keys
    (a prefix of its ``length``) cut into chunks of ``chunk`` in slot
    order, chunk i to stream ``i % streams``, an online softmax each,
    merged in stream order."""
    at, ok = _key_index(kh, b, start, length, bound)
    N, H, S = start.shape
    seen = ok.reshape(N, H, S, length).sum(-1)
    chunks = (seen + chunk - 1) // chunk
    first = torch.cumsum(chunks, -1) - chunks
    j = torch.arange(length, device=kh.device)
    stream = ((first[..., None] + j // chunk) % streams).reshape(N, H, -1)
    parts = [_softmax(q, kh, vh, at, ok & (stream == w), sm_scale)
             for w in range(streams)]
    return merge_partials(*(torch.stack(x, 2) for x in zip(*parts)), 2)


def _token_chunks(q, starts, cnt, bound, tokens: int):
    """``(t0, t1, qc, b, bd, st)`` for each chunk of ``tokens`` tokens of
    ``q (B, T, H, G, D)``: its N = B (t1 - t0) groups ``qc (N, H, G,
    D)``, their batches ``b`` and causal bounds ``bd``, and their slots'
    first keys ``st (N, H, S)``, -1 past the count."""
    B, T, H, G, D = q.shape
    S = starts.shape[-1]
    slot = torch.arange(S, device=q.device)
    for t0 in range(0, T, tokens):
        t1 = min(t0 + tokens, T)
        n = B * (t1 - t0)
        b = torch.arange(B, device=q.device).repeat_interleave(t1 - t0)
        st = starts[:, t0:t1].reshape(n, H, S)
        st = torch.where(slot < cnt[:, t0:t1].reshape(n, H, 1), st, -1)
        yield (t0, t1, q[:, t0:t1].reshape(n, H, G, D), b,
               bound[t0:t1].repeat(B), st)


def _nsa_plain(q, kh, vh, starts, cnt, g_slc, g_swa, block_size: int,
               window: int, bound, sm_scale: float,
               tokens: int = PLAIN_TOKENS, branch=_branch) -> torch.Tensor:
    """The three kernels' plain version over ``q (B, T, H, G, D)``:
    ``starts (B, T, H, S)`` the selected blocks' first keys (-1: none),
    ``bound (T,)`` each token's causal bound, ``tokens`` tokens a step;
    ``branch`` computes a branch's ``(acc, m, l)``."""
    B, T, H, G, D = q.shape
    out = torch.empty_like(q)
    for t0, t1, qc, b, bd, st in _token_chunks(q, starts, cnt, bound,
                                               tokens):
        n = qc.shape[0]
        acc, _, l = branch(qc, kh, vh, b, st, block_size, bd, sm_scale)
        o = _normalised(acc, l) * g_slc[:, t0:t1].reshape(n, H, G, 1)
        if window > 0:
            w0 = (bd - window + 1)[:, None, None].expand(n, H, 1)
            acc, _, l = branch(qc, kh, vh, b, w0.clamp_min(0), window, bd,
                               sm_scale)
            o += _normalised(acc, l) * g_swa[:, t0:t1].reshape(n, H, G, 1)
        out[:, t0:t1] = o.reshape(B, t1 - t0, H, G, D).to(q.dtype)
    return out


def _block_starts(bi, block_size: int) -> torch.Tensor:
    return torch.where(bi >= 0, bi.long() * block_size, -1)


def nsa_fwd_plain(q, kh, vh, bi, cnt, g_slc, g_swa, block_size: int,
                  window: int, sm_scale: float) -> torch.Tensor:
    """Plain version of the fused forward: ``q (B, T, H, G, D)``, ``kh,
    vh (B, H, Tk, D)``; O in q's type."""
    T = q.shape[1]
    return _nsa_plain(q, kh, vh, _block_starts(bi, block_size), cnt, g_slc,
                      g_swa, block_size, window,
                      torch.arange(T, device=q.device), sm_scale)


def nsa_fwd_streams_plain(q, kh, vh, bi, cnt, g_slc, g_swa, block_size: int,
                          window: int, sm_scale: float,
                          streams: int = KERNEL_STREAMS,
                          chunk: int = KERNEL_CHUNK) -> torch.Tensor:
    """``nsa_fwd_plain`` with each branch walked as the 16-bit kernels walk
    it (``_branch_streams``: ``chunk`` keys a chunk dealt to ``streams``
    warps, merged in a fixed order). One stream is the prefill kernel's
    selected branch (its window's chunks start at four tokens' common
    window, here at the token's own); four, a decode split's."""
    T = q.shape[1]
    return _nsa_plain(q, kh, vh, _block_starts(bi, block_size), cnt, g_slc,
                      g_swa, block_size, window,
                      torch.arange(T, device=q.device), sm_scale,
                      branch=functools.partial(_branch_streams,
                                               streams=streams, chunk=chunk))


def nsa_varlen_fwd_plain(q, kh, vh, offs, cnt, g_slc, block_size: int,
                         sm_scale: float) -> torch.Tensor:
    """Plain version of the varlen forward: ``q (1, T, H, G, D)``, ``offs
    (1, T, H, S)`` raw packed row offsets (-1: none)."""
    T = q.shape[1]
    return _nsa_plain(q, kh, vh, torch.where(offs >= 0, offs.long(), -1),
                      cnt, g_slc, g_slc, block_size, 0,
                      torch.arange(T, device=q.device), sm_scale)


def nsa_decode_fwd_plain(q, kh, vh, bi, cnt, g_slc, block_size: int,
                         sm_scale: float) -> torch.Tensor:
    """Plain version of decode: ``q (B, H, G, D)``, ``bi (B, H, S)``, the
    causal bound the last key."""
    Tk = kh.shape[2]
    bound = torch.full((1,), Tk - 1, dtype=torch.long, device=q.device)
    return _nsa_plain(q[:, None], kh, vh,
                      _block_starts(bi, block_size)[:, None], cnt[:, None],
                      g_slc[:, None], g_slc[:, None], block_size, 0, bound,
                      sm_scale)[:, 0]


def decode_splits(B: int, H: int, S: int, resident: int) -> int:
    """Runs the decode kernel cuts each row's S slots into: the most (of
    ``ceil(S / splits)`` slots each) whose ``B H splits`` blocks the card
    holds at once, ``resident`` blocks: ``per = max(1, ceil(B H S /
    resident))``, ``splits = ceil(S / per)`` (at least 1)."""
    per = max(1, -(-B * H * S // max(resident, 1)))
    return max(1, -(-S // per))


def nsa_decode_partials_plain(q, kh, vh, bi, cnt, block_size: int,
                              sm_scale: float, splits: int):
    """Plain version of decode's first launch: ``q (B, H, G, D)``, ``bi
    (B, H, S)``; the selected branch of each run of ``ceil(S / splits)``
    slots, unnormalised, ``(acc (B, H, splits, G, D), m, l (B, H, splits,
    G))`` float32 in the exp2 domain (a run with no live slot: m -1e30,
    l 0, acc 0)."""
    B, H, G, D = q.shape
    S = bi.shape[-1]
    dev = q.device
    per = max(1, -(-S // splits))
    starts = torch.where(torch.arange(S, device=dev) < cnt[..., None],
                         _block_starts(bi, block_size), -1)
    starts = torch.cat([starts, starts.new_full((B, H, splits * per - S),
                                                -1)], -1)
    st = starts.reshape(B, H, splits, per).transpose(1, 2).reshape(
        B * splits, H, per)
    qn = q[:, None].expand(B, splits, H, G, D).reshape(B * splits, H, G, D)
    b = torch.arange(B, device=dev).repeat_interleave(splits)
    bound = torch.full((B * splits,), kh.shape[2] - 1, dtype=torch.long,
                       device=dev)
    acc, m, l = _branch(qn, kh, vh, b, st, block_size, bound, sm_scale)
    return (acc.reshape(B, splits, H, G, D).transpose(1, 2).contiguous(),
            m.reshape(B, splits, H, G).transpose(1, 2).contiguous(),
            l.reshape(B, splits, H, G).transpose(1, 2).contiguous())


def nsa_decode_combine_plain(acc, m, l, g_slc, dtype) -> torch.Tensor:
    """Plain version of decode's combine: the partials' fixed-order merge
    over the splits, normalised and gated by ``g_slc (B, H, G)``, in
    ``dtype``."""
    a, _, s = merge_partials(acc, m, l, 2)
    return (_normalised(a, s) * g_slc[..., None]).to(dtype)


def nsa_decode_split_plain(q, kh, vh, bi, cnt, g_slc, block_size: int,
                           sm_scale: float, splits: int) -> torch.Tensor:
    """The two decode launches' plain versions in turn."""
    return nsa_decode_combine_plain(
        *nsa_decode_partials_plain(q, kh, vh, bi, cnt, block_size, sm_scale,
                                   splits), g_slc, q.dtype)


def nsa_fwd_partial_plain(q, kh, vh, bi, cnt, block_size: int,
                          sm_scale: float):
    """Plain version of the partial forward: the selected branch of ``q
    (B, T, H, G, D)`` without gates, ``(acc (B, T, H, G, D), m, l (B, T,
    H, G))`` float32 in the exp2 domain, m floored at -1e30 (l = 0 on a
    row that sees no key)."""
    B, T, H, G, D = q.shape
    dev = q.device
    acc = torch.empty(q.shape, dtype=torch.float32, device=dev)
    m = torch.empty(q.shape[:-1], dtype=torch.float32, device=dev)
    l = torch.empty_like(m)
    for t0, t1, qc, b, bd, st in _token_chunks(
            q, _block_starts(bi, block_size), cnt,
            torch.arange(T, device=dev), PLAIN_TOKENS):
        a_, m_, l_ = _branch(qc, kh, vh, b, st, block_size, bd, sm_scale)
        acc[:, t0:t1] = a_.reshape(B, t1 - t0, H, G, D)
        m[:, t0:t1] = m_.reshape(B, t1 - t0, H, G)
        l[:, t0:t1] = l_.reshape(B, t1 - t0, H, G)
    return acc, m, l


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _aligned(q, kh, vh):
    """q contiguous; for the 16-bit kernels, which read rows 16 bytes a
    copy, k and v copied into new contiguous tensors (16-byte aligned,
    one layout for both) where a row or a base is not 16-byte aligned
    (never for the wrappers' own views)."""
    q = q.contiguous()
    if q.dtype == torch.float32:
        return q, kh, vh
    if q.data_ptr() % 16:
        q = q.clone()
    es = kh.element_size()
    if any(t.data_ptr() % 16 or any(st * es % 16 for st in t.stride()[:3])
           for t in (kh, vh)):
        kh, vh = (t.clone(memory_format=torch.contiguous_format)
                  for t in (kh, vh))
    return q, kh, vh


def _call(name, entry, dev, argtypes, *args):
    """``entry`` of ``csrc/nsa.cu`` on ``dev``'s current stream; raises if
    it refused, else counts a launch of ``name``."""
    from ._build import load, stream_call
    fn = getattr(load("nsa"), entry)
    fn.argtypes = list(argtypes) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = stream_call(fn, dev, *args)
    if code != 0:
        raise KernelLaunchError(name, code)
    launches[name] += 1


def _launch(name, entry, q, kh, vh, operands, dims, strides, sm_scale,
            outs=None):
    """One launch of ``csrc/nsa.cu``'s ``entry``: the pointers of q, k,
    v (``_aligned``), ``operands`` and the outputs (``outs``, by default a
    new o, which is returned); then ``dims`` (ints), K's and V's strides
    (elements; ``strides`` selects them from ``kh.stride()``), the type
    code and the exp2 scale."""
    q, kh, vh = _aligned(q, kh, vh)
    o = (torch.empty_like(q),) if outs is None else outs
    ptrs = [q, kh, vh, *(t.contiguous() for t in operands), *o]
    st = kh.stride()[strides]
    _call(name, entry, q.device,
          [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * len(dims)
          + [ctypes.c_longlong] * len(st) + [ctypes.c_int, ctypes.c_float],
          *(t.data_ptr() for t in ptrs), *dims, *st, DTYPE_CODES[q.dtype],
          float(sm_scale) * _LOG2E)
    return o[0] if outs is None else o


def nsa_fwd(q, kh, vh, bi, cnt, g_slc, g_swa, block_size: int, window: int,
            sm_scale: float) -> torch.Tensor:
    """NSA forward ``(B, T, H, G, D)`` in q's type: ``q (B, T, H, G, D)``,
    ``kh, vh (B, H, Tk, D)`` (any strides, head_dim contiguous), ``bi (B,
    T, H, S)`` block ids, ``cnt (B, T, H)``, gates ``(B, T, H, G)``
    float32. CUDA tensors launch the kernel; CPU tensors run the plain
    version."""
    _check(q, kh, vh, bi, cnt, g_slc, "nsa_fwd")
    if not q.is_cuda:
        return nsa_fwd_plain(q, kh, vh, bi, cnt, g_slc, g_swa, block_size,
                             window, sm_scale)
    B, T, H, G, D = q.shape
    return _launch("nsa_fwd", "tl_nsa_fwd", q, kh, vh,
                   (bi, cnt, g_slc, g_swa),
                   (B, T, H, G, kh.shape[2], D, bi.shape[-1], block_size,
                    window), slice(0, 3), sm_scale)


def nsa_varlen_fwd(q, kh, vh, offs, cnt, g_slc, block_size: int,
                   sm_scale: float) -> torch.Tensor:
    """The selected branch over packed tokens, ``(1, T, H, G, D)`` in q's
    type: ``offs (1, T, H, S)`` raw packed row offsets of the selected
    blocks (-1: none), ``kh, vh (1, H, Tk, D)``. CUDA tensors launch the
    kernel; CPU tensors run the plain version."""
    _check(q, kh, vh, offs, cnt, g_slc, "nsa_varlen_fwd")
    if not q.is_cuda:
        return nsa_varlen_fwd_plain(q, kh, vh, offs, cnt, g_slc,
                                    block_size, sm_scale)
    _, T, H, G, D = q.shape
    return _launch("nsa_varlen_fwd", "tl_nsa_varlen_fwd", q, kh, vh,
                   (offs, cnt, g_slc),
                   (T, H, G, kh.shape[2], D, offs.shape[-1], block_size),
                   slice(1, 3), sm_scale)


@functools.lru_cache(maxsize=None)
def resident_blocks(dev: torch.device, G: int, D: int, dtype) -> int:
    """Decode blocks the card holds at once: its SMs times the decode
    kernel's blocks an SM (CUDA's occupancy calculator)."""
    from ._build import load
    fn = load("nsa").tl_nsa_decode_blocks_per_sm
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    with torch.cuda.device(dev):
        code = fn(G, D, DTYPE_CODES[dtype], ctypes.byref(blocks))
    if code != 0:
        raise KernelLaunchError("nsa_decode", code)
    return torch.cuda.get_device_properties(dev).multi_processor_count \
        * max(1, blocks.value)


def nsa_decode_partials(q, kh, vh, bi, cnt, block_size: int,
                        sm_scale: float, splits: int):
    """Decode's first launch: the selected branch of each run of
    ``ceil(S / splits)`` slots of ``bi (B, H, S)``, unnormalised, ``(acc
    (B, H, splits, G, D), m, l (B, H, splits, G))`` float32 (see
    ``nsa_decode_partials_plain``). CUDA tensors launch the kernel; CPU
    tensors run the plain version."""
    _check(q, kh, vh, bi, cnt, None, "nsa_decode")
    if splits < 1:
        raise ValueError(f"nsa_decode: splits must be at least 1, got "
                         f"{splits}")
    if not q.is_cuda:
        return nsa_decode_partials_plain(q, kh, vh, bi, cnt, block_size,
                                         sm_scale, splits)
    B, H, G, D = q.shape
    acc = torch.empty((B, H, splits, G, D), dtype=torch.float32,
                      device=q.device)
    outs = (acc, torch.empty_like(acc[..., 0]), torch.empty_like(acc[..., 0]))
    return _launch("nsa_decode", "tl_nsa_decode", q, kh, vh, (bi, cnt),
                   (B, H, G, kh.shape[2], D, bi.shape[-1], block_size,
                    splits), slice(0, 3), sm_scale, outs=outs)


def nsa_decode_combine(acc, m, l, g_slc, dtype) -> torch.Tensor:
    """Decode's second launch: the partials' fixed-order merge over the
    splits, normalised, times ``g_slc (B, H, G)``, as ``(B, H, G, D)`` in
    ``dtype``. CUDA tensors launch the kernel (counted as
    ``nsa_decode_combine``); CPU tensors run the plain version."""
    if not acc.is_cuda:
        return nsa_decode_combine_plain(acc, m, l, g_slc, dtype)
    B, H, splits, G, D = acc.shape
    ops = [t.contiguous() for t in (acc, m, l, g_slc.float())]
    o = torch.empty((B, H, G, D), dtype=dtype, device=acc.device)
    _call("nsa_decode_combine", "tl_nsa_decode_combine", acc.device,
          [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5,
          *(t.data_ptr() for t in ops), o.data_ptr(), B * H, G, D, splits,
          DTYPE_CODES[dtype])
    return o


def nsa_decode_fwd(q, kh, vh, bi, cnt, g_slc, block_size: int,
                   sm_scale: float) -> torch.Tensor:
    """One decode step ``(B, H, G, D)`` in q's type: ``q (B, H, G, D)``,
    ``kh, vh (B, H, Tk, D)``, ``bi (B, H, S)``, ``cnt (B, H)``, ``g_slc
    (B, H, G)``; every selected key up to the last is visible. CUDA
    tensors launch two kernels: ``nsa_decode_partials`` over
    ``decode_splits`` runs of slots (sized by the card's resident
    blocks) and ``nsa_decode_combine``; CPU tensors run the plain
    version."""
    _check(q, kh, vh, bi, cnt, g_slc, "nsa_decode")
    if not q.is_cuda:
        return nsa_decode_fwd_plain(q, kh, vh, bi, cnt, g_slc, block_size,
                                    sm_scale)
    B, H, G, D = q.shape
    splits = decode_splits(B, H, bi.shape[-1],
                           resident_blocks(q.device, G, D, q.dtype))
    acc, m, l = nsa_decode_partials(q, kh, vh, bi, cnt, block_size,
                                    sm_scale, splits)
    return nsa_decode_combine(acc, m, l, g_slc, q.dtype)


def nsa_fwd_partial(q, kh, vh, bi, cnt, block_size: int, sm_scale: float):
    """The selected branch without gates, unnormalised: ``(acc (B, T, H,
    G, D), m, l (B, T, H, G))`` float32 in the exp2 domain, for ``q (B,
    T, H, G, D)``, ``kh, vh (B, H, Tk, D)`` (any strides, head_dim
    contiguous), ``bi (B, T, H, S)``, ``cnt (B, T, H)``. m is floored at
    -1e30 and l is 0 on a row that sees no key. CUDA tensors launch the
    kernel; CPU tensors run the plain version."""
    _check(q, kh, vh, bi, cnt, None, "nsa_fwd_partial")
    if not q.is_cuda:
        return nsa_fwd_partial_plain(q, kh, vh, bi, cnt, block_size,
                                     sm_scale)
    B, T, H, G, D = q.shape
    acc = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    outs = (acc, torch.empty_like(acc[..., 0]), torch.empty_like(acc[..., 0]))
    return _launch("nsa_fwd_partial", "tl_nsa_fwd_partial", q, kh, vh,
                   (bi, cnt), (B, T, H, G, kh.shape[2], D, bi.shape[-1],
                               block_size), slice(0, 3), sm_scale,
                   outs=outs)


# ---------------------------------------------------------------------------
# factories (the JAX package's arguments and kernel-side layouts)
# ---------------------------------------------------------------------------


def nsa_fwd_kernel(B, Tq, H, G, Tk, D, S, BS, window, sm_scale, dtype):
    """``fn(Q (B, Tq, H, G, D), K, V (B, H, Tk, D), BI (B, Tq, H, S),
    Cnt (B, Tq, H), Gslc, Gswa (B, Tq, H, G)) -> O``."""
    dt = _as_dtype(dtype)
    kv = ((B, H, Tk, D), dt)
    return bind("nsa_fwd_kernel",
                [((B, Tq, H, G, D), dt), kv, kv, ((B, Tq, H, S), None),
                 ((B, Tq, H), None), ((B, Tq, H, G), torch.float32),
                 ((B, Tq, H, G), torch.float32)],
                lambda q, k, v, bi, cnt, gs, gw: nsa_fwd(
                    q, k, v, _int32(bi, q.device), _int32(cnt, q.device),
                    gs, gw, int(BS), int(window), float(sm_scale)))


def nsa_varlen_fwd_kernel(Tq, H, G, Tk, D, S, BS, sm_scale, dtype):
    """``fn(Q (1, Tq, H, G, D), K, V (1, H, Tk, D), Offs (1, Tq, H, S),
    Cnt (1, Tq, H), Gslc (1, Tq, H, G)) -> O``; Offs are raw packed row
    offsets."""
    dt = _as_dtype(dtype)
    kv = ((1, H, Tk, D), dt)
    return bind("nsa_varlen_fwd_kernel",
                [((1, Tq, H, G, D), dt), kv, kv, ((1, Tq, H, S), None),
                 ((1, Tq, H), None), ((1, Tq, H, G), torch.float32)],
                lambda q, k, v, offs, cnt, gs: nsa_varlen_fwd(
                    q, k, v, _int32(offs, q.device), _int32(cnt, q.device),
                    gs, int(BS), float(sm_scale)))


def nsa_fwd_partial_kernel(B, Tq, H, G, Tk, D, S, BS, sm_scale, dtype):
    """``fn(Q (B, Tq, H, G, D), K, V (B, H, Tk, D), BI (B, Tq, H, S),
    Cnt (B, Tq, H)) -> (O, M, L)``: the unnormalised accumulator and the
    exp2-domain statistics, float32."""
    dt = _as_dtype(dtype)
    kv = ((B, H, Tk, D), dt)
    return bind("nsa_fwd_partial_kernel",
                [((B, Tq, H, G, D), dt), kv, kv, ((B, Tq, H, S), None),
                 ((B, Tq, H), None)],
                lambda q, k, v, bi, cnt: nsa_fwd_partial(
                    q, k, v, _int32(bi, q.device), _int32(cnt, q.device),
                    int(BS), float(sm_scale)))


def nsa_decode_kernel(B, H, G, Tk, D, S, BS, sm_scale, dtype):
    """``fn(Q (B, H, G, D), K, V (B, H, Tk, D), BI (B, H, S), Cnt (B, H),
    Gslc (B, H, G)) -> O``."""
    dt = _as_dtype(dtype)
    kv = ((B, H, Tk, D), dt)
    return bind("nsa_decode_kernel",
                [((B, H, G, D), dt), kv, kv, ((B, H, S), None),
                 ((B, H), None), ((B, H, G), torch.float32)],
                lambda q, k, v, bi, cnt, gs: nsa_decode_fwd(
                    q, k, v, _int32(bi, q.device), _int32(cnt, q.device),
                    gs, int(BS), float(sm_scale)))


# ---------------------------------------------------------------------------
# entry points (the reference layout)
# ---------------------------------------------------------------------------


def _group(HQ: int, H: int) -> int:
    if H < 1 or HQ % H:
        raise ValueError(f"{HQ} query heads do not fit {H} KV heads")
    return HQ // H


def nsa_attention(q, k, v, g_slc, g_swa, block_indices, block_counts=None,
                  block_size: int = 64, window_size: int = 0,
                  scale: Optional[float] = None,
                  backward: Optional[str] = None) -> torch.Tensor:
    """NSA forward, the reference layout (``naive_nsa``, head_first
    False): q (B, T, HQ, D); k, v (B, Tk, H, D); g_slc, g_swa (B, T, HQ);
    block_indices (B, T, H, S) block ids (-1: none); block_counts None
    (all S), an int or (B, T, H).

    ``backward=None``: the fused inference kernel, gates and window in
    the kernel, not differentiable. ``backward="kernel"``: differentiable
    in q, k, v and g_slc through the partial forward and the dK/dV and dQ
    kernels (``ops/nsa_bwd.py``); without a gradient to compute it still
    runs the partial forward, normalised outside the kernel and rounded
    to q's type before the gate multiplies (in float32, then cast). It
    requires ``window_size == 0`` and Tk a multiple of ``block_size``
    (``ValueError`` otherwise, as the JAX package raises); there is no
    ``backward="reference"`` for this op."""
    B, T, HQ, D = q.shape
    Tk, H = k.shape[1], k.shape[2]
    G = _group(HQ, H)
    dev = q.device
    bi = _int32(block_indices, dev)
    cnt = _counts(block_counts, bi.shape[-1], (B, T, H), dev)
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    q5, kh, vh = q.reshape(B, T, H, G, D), k.transpose(1, 2), \
        v.transpose(1, 2)
    gs = torch.as_tensor(g_slc, device=dev).float().reshape(B, T, H, G)
    if backward is None:
        gw = torch.as_tensor(g_swa, device=dev).float().reshape(B, T, H, G)
        o = nsa_fwd(q5, kh, vh, bi, cnt, gs, gw, int(block_size),
                    int(window_size), float(scale))
        return o.reshape(B, T, HQ, D)

    BS = int(block_size)
    if window_size:
        raise ValueError(
            "nsa_attention backward requires window_size == 0 (the "
            "reference backward asserts the same)")
    if Tk % BS:
        raise ValueError(
            f"nsa_attention backward requires the KV length ({Tk}) to "
            f"be a multiple of block_size ({block_size}): the dKdV "
            f"sweep writes full KV blocks")
    if backward == "reference":
        raise ValueError("backward='reference' is not available for this op")
    from .flash_attention import differentiable
    from .nsa_bwd import nsa_attention_bwd, nsa_block_mask
    mask = nsa_block_mask(bi, cnt, T, Tk // BS, BS)

    def partial(q5, kh, vh, bi, cnt, mask, causal, sm_scale):
        return nsa_fwd_partial(q5, kh, vh, bi, cnt, BS, sm_scale)

    def primal(q5, kh, vh, bi, cnt, mask, causal, sm_scale):
        acc, _, l = partial(q5, kh, vh, bi, cnt, mask, causal, sm_scale)
        lv = l[..., None]
        return torch.where(lv > 0, acc / lv, 0.0).to(q5.dtype)

    # the gate multiplies outside the Function: d(g_slc) from autograd;
    # dK and dV flow back through the (B, Tk, H, D) -> (B, H, Tk, D) views
    o_slc = differentiable(q5, kh, vh, True, float(scale), backward, primal,
                           partial, None, aux=(bi, cnt, mask),
                           bwd=nsa_attention_bwd)
    return (o_slc * gs[..., None]).reshape(B, T, HQ, D).to(q.dtype)


def varlen_offsets(block_indices, counts, cu_seqlens, block_size: int):
    """``(offs, counts)`` int32 of packed tokens: each sequence-local
    block id as its packed row offset ``cu[seq] + id * block_size`` (-1
    for none), and the counts with 0 for rows past ``cu[-1]``."""
    T = block_indices.shape[0]
    dev = block_indices.device
    cu = _cu_tensor(cu_seqlens, dev)
    sid, _, valid = _seq_ids(cu, T, T, fill=-1, device=dev)
    start = cu[sid.clamp(0, cu.shape[0] - 2).long()]
    offs = torch.where(block_indices >= 0, start[:, None, None]
                       + block_indices * int(block_size), -1)
    return (offs.to(torch.int32),
            torch.where(valid[:, None], counts, 0).to(torch.int32))


def nsa_attention_varlen(q, k, v, g_slc, block_indices, cu_seqlens,
                         block_counts=None, block_size: int = 64,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Ragged-batch NSA, the selected branch: q (total, HQ, D); k, v
    (total, H, D); g_slc (total, HQ); block_indices (total, H, S) with
    sequence-local block ids; cu_seqlens (B + 1,), numpy or a tensor.
    Each id becomes the packed row offset ``cu[seq] + id * block_size``;
    packed order is position order, so the causal bound keeps a token's
    keys inside its own sequence. Rows past ``cu[-1]`` select nothing
    and give 0."""
    T, HQ, D = q.shape
    H = k.shape[1]
    G = _group(HQ, H)
    BS = int(block_size)
    dev = q.device
    bi = _int32(block_indices, dev)
    cnt = _counts(block_counts, bi.shape[-1], (T, H), dev)
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    offs, cnt = varlen_offsets(bi, cnt, cu_seqlens, BS)
    gs = torch.as_tensor(g_slc, device=dev).float().reshape(1, T, H, G)
    o = nsa_varlen_fwd(q.reshape(1, T, H, G, D), k.permute(1, 0, 2)[None],
                       v.permute(1, 0, 2)[None], offs[None], cnt[None], gs,
                       BS, float(scale))
    return o.reshape(T, HQ, D)


def nsa_decode(q, k, v, g_slc, block_indices, block_counts=None,
               block_size: int = 64,
               scale: Optional[float] = None) -> torch.Tensor:
    """Decode step: q (B, HQ, D) attends the selected blocks of k, v (B,
    Tk, H, D); block_indices (B, H, S); g_slc (B, HQ)."""
    B, HQ, D = q.shape
    Tk, H = k.shape[1], k.shape[2]
    G = _group(HQ, H)
    dev = q.device
    bi = _int32(block_indices, dev)
    cnt = _counts(block_counts, bi.shape[-1], (B, H), dev)
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    gs = torch.as_tensor(g_slc, device=dev).float().reshape(B, H, G)
    o = nsa_decode_fwd(q.reshape(B, H, G, D), k.transpose(1, 2),
                       v.transpose(1, 2), bi, cnt, gs, int(block_size),
                       float(scale))
    return o.reshape(B, HQ, D)


def nsa_dense(q, k, v, g_slc, block_indices, block_counts=None,
              block_size: int = 64,
              scale: Optional[float] = None) -> torch.Tensor:
    """The selected branch as a dense graph that autograd differentiates:
    q (B, T, HQ, D), k, v (B, Tk, H, D), g_slc (B, T, HQ). Each key
    weighs as often as its block is validly selected (slot below the
    count, id >= 0, first key at most t), keys past t weigh 0; a natural
    exp softmax over the weighted keys in float32, 0 on a row that sees
    nothing. Equal to the tests' dense JAX graph where no block is
    listed twice. Holds B T HQ Tk scores: for reduced shapes."""
    B, T, HQ, D = q.shape
    Tk, H = k.shape[1], k.shape[2]
    G = _group(HQ, H)
    BS = int(block_size)
    dev = q.device
    bi = _int32(block_indices, dev).long()
    S = bi.shape[-1]
    cnt = _counts(block_counts, S, (B, T, H), dev)
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    t = torch.arange(T, device=dev)[None, :, None, None]
    ok = (bi >= 0) & (bi * BS <= t) \
        & (torch.arange(S, device=dev) < cnt[..., None])
    NS = -(-Tk // BS)
    ok &= bi < NS
    weight = torch.zeros((B, T, H, NS + 1), device=dev).scatter_add_(
        -1, torch.where(ok, bi, NS), ok.float())[..., :NS]
    weight = weight.repeat_interleave(BS, -1)[..., :Tk]
    weight = weight * (torch.arange(Tk, device=dev) <= t).float()
    s = torch.einsum("bthgd,bkhd->bthgk", q.float().reshape(B, T, H, G, D),
                     k.float()) * scale
    w = weight[:, :, :, None, :]
    s = s.masked_fill(w == 0, -math.inf)
    m = s.amax(-1, keepdim=True).detach()     # a shift: no gradient
    p = w * torch.exp(s - torch.where(torch.isfinite(m), m, 0.0))
    den = p.sum(-1, keepdim=True)
    p = torch.where(den > 0, p / den.clamp_min(1e-30), 0.0)
    o = torch.einsum("bthgk,bkhd->bthgd", p, v.float())
    gs = torch.as_tensor(g_slc, device=dev).float().reshape(B, T, H, G, 1)
    return (o * gs).reshape(B, T, HQ, D)


def nsa_reference(q, k, v, g_slc, g_swa, block_indices, block_counts=None,
                  block_size: int = 64, window_size: int = 0,
                  scale: Optional[float] = None) -> torch.Tensor:
    """The JAX package's dense reference of ``naive_nsa``, token by token
    in float32 numpy with a natural-exp softmax; keys masked by position
    (``0 <= idx <= t``), the output in q's type."""
    B, Tq, HQ, D = q.shape
    H = k.shape[2]
    G = HQ // H
    BS = block_size
    S = block_indices.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)

    def host(x, dtype):
        if isinstance(x, torch.Tensor):
            x = x.detach().float().cpu().numpy()
        return np.asarray(x, dtype)

    qf, kf, vf, gsl, gsw = (host(t, np.float32)
                            for t in (q, k, v, g_slc, g_swa))
    bi = host(block_indices, np.int64)
    if block_counts is None:
        cnts = np.full((B, Tq, H), S)
    elif isinstance(block_counts, int):
        cnts = np.full((B, Tq, H), block_counts)
    else:
        cnts = host(block_counts, np.int64)
    out = np.zeros((B, Tq, HQ, D), np.float32)
    for b in range(B):
        for t in range(Tq):
            for h in range(HQ):
                hk = h // G
                sel = bi[b, t, hk][:cnts[b, t, hk]]
                idx = (sel[:, None] * BS + np.arange(BS)[None, :]).ravel()
                valid = (idx >= 0) & (idx <= t) & (sel >= 0).repeat(BS)
                at = np.clip(idx, 0, Tq - 1)
                sc = qf[b, t, h] @ kf[b, at, hk].T
                sc = np.where(valid, sc * scale, -np.inf)
                if np.any(valid):
                    p = np.exp(sc - sc.max())
                    p = p / p.sum()
                    out[b, t, h] = (p @ vf[b, at, hk]) * gsl[b, t, h]
                if window_size > 0:
                    lo = max(0, t - window_size + 1)
                    sw = qf[b, t, h] @ kf[b, lo:t + 1, hk].T * scale
                    pw = np.exp(sw - sw.max())
                    pw = pw / pw.sum()
                    out[b, t, h] += (pw @ vf[b, lo:t + 1, hk]) * gsw[b, t, h]
    return torch.from_numpy(out).to(q.dtype)
