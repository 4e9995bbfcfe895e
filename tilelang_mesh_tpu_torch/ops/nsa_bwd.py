"""Native Sparse Attention training backward on the card.

Counterpart of ``tilelang_mesh_tpu/ops/nsa_bwd.py`` (the selected branch;
the reference backward, like the JAX package's, takes no window). One
CUDA source (``csrc/nsa_bwd.cu``) replaces its two TPU kernels:

* ``nsa_bwd_dkdv`` — ``nsa_bwd_dkdv_kernel``: dK and dV of each KV block
  over the tokens that select it, gated and scaled by the multiplicity
  map of :func:`nsa_block_mask`;
* ``nsa_bwd_dq`` — ``nsa_bwd_dq_kernel``: dQ, each token's selected
  blocks gathered again, as the forward gathers them.

The TPU kernel sweeps all T tokens in one program per (KV block, KV
head, batch), in order, so that every dK / dV block is written once
without atomics. On the card that grid is unbalanced when many tokens
select one block (NSA's selections always include block 0). So
:func:`dkdv_plan` compacts the map into per-(batch, head, block) lists
of (token, multiplicity) in token order and cuts each into chunks of
about ``DKDV_CHUNK_ROWS`` (token, query head) rows; each chunk's float32
partial is written once and a second kernel (``nsa_bwd_dkdv_sum``) adds
a block's partials in chunk order. No atomics: two runs give the same
bits.

Softmax is recomputed from the forward's ``lse2 = m + log2(l)`` in the
exp2 domain, ``P = exp2(Q K^T sm_scale log2(e) - lse2)``, ``dS = P (dO
V^T - delta) sm_scale``; P and dS are rounded to the input type before
their products, as the TPU kernels do. A block listed m times by a token
holds m times the softmax mass in the forward: dK / dV scale P (before
its rounding) by m, and dQ visits the block m times.

Each wrapper launches its kernels on CUDA tensors (a build or launch
failure raises) and runs its plain PyTorch version on CPU tensors: dQ a
chunk of tokens at a time, dK / dV a chunk of (token, block) pairs at a
time, so no call holds every token's gathered keys at once. On the card
the element type picks the kernel (``run_dkdv`` / ``run_dq`` in the
source): float32 runs the CUDA-core kernels, bfloat16 and float16 the
tensor-core ones (``nsa_bwd_dkdv_mma``, ``nsa_bwd_dq_mma``: ``mma.sync``
fragments, ``cp.async`` gathers), for every head_dim of
``KERNEL_HEAD_DIMS`` and group of up to ``KERNEL_MAX_GROUP`` (dQ); the
counters are the same.
:func:`nsa_bwd_dkdv_steps_plain` emulates the tensor-core dK / dV
kernel's order: a chunk's rows a step at a time, the causal mask on a
group of 16 keys only where the step's first token precedes the group's
last key.
"""

from __future__ import annotations

import ctypes

import torch

from ..resilience.errors import KernelLaunchError
from ._factory import bind
from .flash_attention import _DTYPES, _LOG2E, KERNEL_HEAD_DIMS
from .gemm import DTYPE_CODES, _as_dtype
from .nsa import (KERNEL_MAX_GROUP, _aligned, _block_starts, _int32,
                  _key_index, _token_chunks)

__all__ = ["nsa_block_mask", "dkdv_plan", "nsa_bwd_dkdv", "dkdv_partials",
           "dkdv_sum", "nsa_bwd_dkdv_plain", "nsa_bwd_dkdv_steps_plain",
           "nsa_bwd_dq", "nsa_bwd_dq_plain", "nsa_attention_bwd",
           "nsa_bwd_dkdv_kernel", "nsa_bwd_dq_kernel",
           "launches", "reset_launches", "DKDV_CHUNK_ROWS"]

# kernel name -> launches through its wrapper
launches = {"nsa_bwd_dkdv": 0, "nsa_bwd_dkdv_sum": 0, "nsa_bwd_dq": 0}

# (token, query head) rows a dK / dV program sweeps at most
DKDV_CHUNK_ROWS = 2048
# tokens a plain dQ step gathers keys for; (token, block) pairs a plain
# dK / dV step gathers
PLAIN_TOKENS = 256
PLAIN_PAIRS = 2048


def mma_rows_step(D: int) -> int:
    """(token, query head) rows the tensor-core dK / dV kernel gathers a
    step: csrc/nsa_bwd.cu's kRowsStep."""
    return 32 if D > 64 else 64


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def nsa_block_mask(bi, cnt, Tq: int, NS: int, BS: int) -> torch.Tensor:
    """The per-token selection inverted into a (B, Tq, H, NS) int32
    multiplicity map: entry (b, t, h, n) counts the slots s < cnt of
    token t whose id is n, with ``n >= 0`` and ``n BS <= t`` (0: not
    selected; ids at or past NS are dropped), integer-equal to the JAX
    package's ``one_hot`` sum."""
    bi = bi.long()
    t = torch.arange(Tq, device=bi.device)[None, :, None, None]
    s_idx = torch.arange(bi.shape[-1], device=bi.device)
    valid = (bi >= 0) & (bi * BS <= t) & (s_idx < cnt[..., None]) \
        & (bi < NS)
    mask = torch.zeros((*bi.shape[:-1], NS + 1), dtype=torch.int32,
                       device=bi.device)
    mask.scatter_add_(-1, torch.where(valid, bi, NS),
                      torch.ones_like(bi, dtype=torch.int32))
    return mask[..., :NS]


def _pairs(mask):
    """The nonzero entries of ``mask (B, T, H, NS)`` ordered by segment
    ``(b H + h) NS + n`` and then token: ``(segment, token,
    multiplicity)``, int64."""
    B, T, H, NS = mask.shape
    m = mask.permute(0, 2, 3, 1).contiguous()          # (B, H, NS, T)
    b, h, n, t = torch.nonzero(m).unbind(1)
    return (b * H + h) * NS + n, t, m[b, h, n, t].long()


def dkdv_plan(mask, G: int, max_pairs: int | None = None):
    """The dK / dV kernel's work list: ``(tok, mult, chunks, first)``
    int32. ``tok`` and ``mult`` are the map's nonzero (token,
    multiplicity) pairs by segment (``(b H + h) NS + n``), tokens in
    order; ``chunks (C, 3)`` holds each chunk's (segment, first pair, end
    pair), a segment's list cut every ``max(1, DKDV_CHUNK_ROWS // G)``
    tokens; ``first (B H NS + 1)`` each segment's first chunk, so its
    chunks are ``first[s]:first[s + 1]`` (none for a block no token
    selects).

    Built on the map's device: pair i is found in the running count of
    the map's nonzeros (``searchsorted``), chunk c in the running count
    of chunks. Without ``max_pairs`` one host sync reads the pair and
    chunk counts. With it (a bound on the map's nonzeros, such as the
    selections' slots B T H S of :func:`nsa_block_mask`'s ids) nothing
    waits for the card: ``tok`` and ``mult`` hold ``min(max_pairs,
    B T H NS)`` entries, those past the map's nonzeros unused, and
    ``chunks`` holds ``B H NS + ceil(max_pairs / per)`` rows, those past
    ``first[-1]`` (0, 0, 0): a kernel program there writes a zero partial
    that the sum never reads."""
    B, T, H, NS = mask.shape
    dev = mask.device
    n_seg = B * H * NS
    m = mask.permute(0, 2, 3, 1).reshape(-1)           # (B H NS T) order
    hit = m > 0
    per = max(1, DKDV_CHUNK_ROWS // G)
    run = hit.cumsum(0)                       # nonzeros up to and with p
    start = torch.zeros(n_seg + 1, dtype=torch.long, device=dev)
    start[1:] = hit.view(n_seg, T).sum(1).cumsum(0)
    n_ch = (start[1:] - start[:-1] + per - 1) // per
    first = torch.zeros(n_seg + 1, dtype=torch.long, device=dev)
    first[1:] = n_ch.cumsum(0)
    if max_pairs is None:
        n_pairs, n_chunks = torch.stack([start[-1], first[-1]]).tolist()
    else:
        n_pairs = min(int(max_pairs), m.numel())
        n_chunks = n_seg + -(-n_pairs // per)
    pos = torch.searchsorted(run, torch.arange(
        1, n_pairs + 1, device=dev)).clamp_(max=max(m.numel() - 1, 0))
    c = torch.arange(n_chunks, device=dev)
    cseg = torch.searchsorted(first, c, right=True) - 1
    pad = cseg >= n_seg                       # past the last real chunk
    cseg.masked_fill_(pad, 0)
    # clamped to the pairs held, whatever map a caller's bound misjudges
    e0 = (start[cseg] + (c - first[cseg]) * per).clamp_(max=n_pairs)
    e1 = torch.minimum(e0 + per, start[cseg + 1]).clamp_(max=n_pairs)
    chunks = torch.stack([cseg, e0, e1], 1).masked_fill_(pad[:, None], 0)
    return ((pos % T).to(torch.int32), m[pos], chunks.to(torch.int32),
            first.to(torch.int32))


def _check(q, kh, vh, do, lse2, delta, ints, what: str) -> None:
    """q, dO (B, T, H, G, D); kh, vh (B, H, Tk, D) views of q's type;
    lse2, delta (B, T, H, G) float32; ``ints`` int32 (B, T, H, ...)."""
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype
                                     for t in (kh, vh, do)):
        raise TypeError(f"{what}: q, k, v, dO must share float32, bfloat16 "
                        f"or float16, got {q.dtype}, {kh.dtype}, "
                        f"{vh.dtype}, {do.dtype}")
    if kh.shape != vh.shape or kh.stride() != vh.stride() \
            or kh.stride(-1) != 1:
        raise ValueError(f"{what}: k and v must share a shape and strides "
                         f"with contiguous head_dim")
    B, T, H, G, D = q.shape
    if tuple(kh.shape[:2]) != (B, H) or kh.shape[3] != D \
            or do.shape != q.shape:
        raise ValueError(f"{what}: shapes do not fit: q {tuple(q.shape)}, "
                         f"k {tuple(kh.shape)}, dO {tuple(do.shape)}")
    for name, t in (("lse2", lse2), ("delta", delta)):
        if t.shape != q.shape[:-1] or t.dtype != torch.float32:
            raise ValueError(f"{what}: {name} must be float32 "
                             f"{tuple(q.shape[:-1])}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    for t in ints:
        if t.dtype != torch.int32 or t.shape[:3] != q.shape[:3]:
            raise ValueError(f"{what}: ids, counts and masks must be int32 "
                             f"({B}, {T}, {H}, ...), got {t.dtype} "
                             f"{tuple(t.shape)}")
    devs = {t.device for t in (q, kh, vh, do, lse2, delta, *ints)}
    if len(devs) != 1:
        raise ValueError(f"{what}: operands on {sorted(map(str, devs))}")
    dev = q.device
    if dev.type == "cuda" and D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{what}: the kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {D}")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{what}: unsupported device {dev}")


def _block_count(kh, mask, block_size: int) -> int:
    NS = mask.shape[-1]
    if NS * block_size != kh.shape[2]:
        raise ValueError(f"nsa_bwd_dkdv: {NS} blocks of {block_size} keys "
                         f"do not cover the KV length {kh.shape[2]}")
    return NS


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def nsa_bwd_dkdv_plain(q, kh, vh, do, lse2, delta, mask, block_size: int,
                       sm_scale: float):
    """Plain version of the dK / dV kernels: ``(dK, dV)`` float32 (B, H,
    Tk, D), each (token, block) pair of the map's ``PLAIN_PAIRS`` at a
    time: P scaled by the multiplicity and rounded before ``dV += P^T
    dO``, dS rounded before ``dK += dS^T Q``."""
    B, T, H, G, D = q.shape
    BS, Tk = int(block_size), kh.shape[2]
    NS = _block_count(kh, mask, BS)
    dev = q.device
    seg, tok, mult = _pairs(mask)
    b, h, n = seg // (H * NS), (seg // NS) % H, seg % NS
    dk = torch.zeros((B * H * NS, BS, D), dtype=torch.float32, device=dev)
    dv = torch.zeros_like(dk)
    j = torch.arange(BS, device=dev)
    scale2 = float(sm_scale) * _LOG2E
    for p0 in range(0, seg.numel(), PLAIN_PAIRS):
        sl = slice(p0, p0 + PLAIN_PAIRS)
        at = (b[sl], tok[sl], h[sl])
        qq, oo = q[at].float(), do[at].float()              # (n, G, D)
        keys = n[sl, None] * BS + j                         # (n, BS)
        kat = (b[sl, None], h[sl, None], keys)
        kk, vv = kh[kat].float(), vh[kat].float()           # (n, BS, D)
        s = torch.bmm(qq, kk.transpose(1, 2))
        p = torch.exp2_(s.mul_(scale2).sub_(lse2[at][..., None])) \
            * mult[sl, None, None]
        p = torch.where((keys <= tok[sl, None])[:, None, :], p, 0.0)
        dv.index_add_(0, seg[sl], torch.bmm(
            p.to(q.dtype).float().transpose(1, 2), oo))
        dp = torch.bmm(oo, vv.transpose(1, 2))
        ds = (p * (dp - delta[at][..., None]) * float(sm_scale)).to(
            q.dtype).float()
        dk.index_add_(0, seg[sl], torch.bmm(ds.transpose(1, 2), qq))
    return dk.view(B, H, Tk, D), dv.view(B, H, Tk, D)


def nsa_bwd_dkdv_steps_plain(q, kh, vh, do, lse2, delta, mask,
                             block_size: int, sm_scale: float):
    """The tensor-core dK / dV kernel's order, in plain PyTorch: each
    chunk of :func:`dkdv_plan` walks its (token, query head) rows
    ``mma_rows_step(D)`` at a time, gathered by the row table (token e0 +
    r // G, head r % G), pad rows zero; P is scaled by the row's
    multiplicity before its rounding; the causal mask applies to a group
    of 16 keys (a warp's) only where the step's first token precedes the
    group's last key (the rows are in token order and every token of the
    list is at or past the block's first key); each chunk's partial goes
    to a workspace and a block's partials are added in chunk order.
    ``(dK, dV)`` as :func:`nsa_bwd_dkdv_plain`."""
    B, T, H, G, D = q.shape
    BS, Tk = int(block_size), kh.shape[2]
    NS = _block_count(kh, mask, BS)
    tok, mult, chunks, first = dkdv_plan(mask, G)
    BM, scale2 = mma_rows_step(D), float(sm_scale) * _LOG2E
    ws = torch.zeros((chunks.shape[0], 2, BS, D), dtype=torch.float32,
                     device=q.device)
    for c, (seg, e0, e1) in enumerate(chunks.tolist()):
        blk, h, b = seg % NS, (seg // NS) % H, seg // (NS * H)
        keys = torch.arange(blk * BS, min(blk * BS + BS, Tk),
                            device=q.device)
        kk, vv = kh[b, h, keys].float(), vh[b, h, keys].float()
        t = tok[e0:e1].long()
        rows = (e1 - e0) * G
        pad = -rows % BM
        qq, oo = (torch.cat([x[b, t, h].float().reshape(rows, D),
                             x.new_zeros((pad, D), dtype=torch.float32)])
                  for x in (q, do))
        ll, dd = (torch.cat([x[b, t, h].reshape(rows),
                             x.new_zeros(pad)]) for x in (lse2, delta))
        mm = torch.cat([mult[e0:e1].float().repeat_interleave(G),
                        torch.zeros(pad, device=q.device)])
        tt = torch.cat([t.repeat_interleave(G),
                        torch.full((pad,), T, device=q.device)])
        for r0 in range(0, rows, BM):
            sl = slice(r0, r0 + BM)
            p = torch.exp2((kk @ qq[sl].T) * scale2 - ll[sl]) * mm[sl]
            edge = tt[r0] < (keys | 15)     # the key's group needs the mask
            p = torch.where(~edge[:, None] | (keys[:, None] <= tt[None, sl]),
                            p, 0.0)
            ws[c, 1, :keys.numel()] += p.to(q.dtype).float() @ oo[sl]
            ds = p * ((vv @ oo[sl].T) - dd[sl]) * float(sm_scale)
            ws[c, 0, :keys.numel()] += ds.to(q.dtype).float() @ qq[sl]
    out = torch.zeros((B * H * NS, 2, BS, D), dtype=torch.float32,
                      device=q.device)
    n = first[1:] - first[:-1]
    for i in range(int(n.max()) if n.numel() else 0):
        has = n > i
        out[has] += ws[first[:-1][has].long() + i]
    out = out.view(B, H, NS, 2, BS, D).transpose(2, 3).reshape(B, H, 2, Tk,
                                                                 D)
    return out[:, :, 0], out[:, :, 1]


def nsa_bwd_dq_plain(q, kh, vh, do, lse2, delta, bi, cnt, block_size: int,
                     sm_scale: float):
    """Plain version of the dQ kernel: dQ float32 (B, T, H, G, D), each
    token's selected blocks gathered again (a block listed twice twice),
    ``PLAIN_TOKENS`` tokens a step."""
    B, T, H, G, D = q.shape
    BS = int(block_size)
    dev = q.device
    dq = torch.empty(q.shape, dtype=torch.float32, device=dev)
    scale2 = float(sm_scale) * _LOG2E
    for t0, t1, qc, b, bd, st in _token_chunks(
            q, _block_starts(bi, BS), cnt, torch.arange(T, device=dev),
            PLAIN_TOKENS):
        n = qc.shape[0]
        at, ok = _key_index(kh, b, st, BS, bd)
        kk = kh[at].float()                                 # (n, H, L, D)
        s = torch.einsum("nhgd,nhld->nhgl", qc.float(), kk)
        p = torch.exp2_(s.mul_(scale2).sub_(
            lse2[:, t0:t1].reshape(n, H, G, 1)))
        p.masked_fill_(~ok[:, :, None, :], 0.0)
        dp = torch.einsum("nhgd,nhld->nhgl",
                          do[:, t0:t1].reshape(n, H, G, D).float(),
                          vh[at].float())
        ds = (p * (dp - delta[:, t0:t1].reshape(n, H, G, 1))
              * float(sm_scale)).to(q.dtype).float()
        dq[:, t0:t1] = torch.einsum("nhgl,nhld->nhgd", ds, kk).reshape(
            B, t1 - t0, H, G, D)
    return dq


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _call(entry: str, name: str, dev, argtypes, *args) -> None:
    from ._build import load, stream_call
    fn = getattr(load("nsa_bwd"), entry)
    fn.argtypes = list(argtypes) + [_P]
    fn.restype = _I
    code = stream_call(fn, dev, *args)
    if code != 0:
        raise KernelLaunchError(name, code)
    launches[name] += 1


def dkdv_partials(q, kh, vh, do, lse2, delta, plan, block_size: int,
                  sm_scale: float) -> torch.Tensor:
    """The dK / dV kernel alone, on operands :func:`nsa_bwd_dkdv` has
    checked and aligned and its ``plan`` (:func:`dkdv_plan`): each
    chunk's float32 partial, ``ws (chunks, 2, BS, D)`` (dK then dV rows
    of the chunk's KV block). One launch; nothing for an empty plan."""
    tok, mult, chunks, first = plan
    B, T, H, G, D = q.shape
    BS, n_chunks = int(block_size), chunks.shape[0]
    ws = torch.empty((max(n_chunks, 1), 2, BS, D), dtype=torch.float32,
                     device=q.device)
    if n_chunks:
        _call("tl_nsa_bwd_dkdv", "nsa_bwd_dkdv", q.device,
              [_P] * 10 + [_I] * 8 + [_L] * 3 + [_I, ctypes.c_float,
                                                 ctypes.c_float],
              q.data_ptr(), kh.data_ptr(), vh.data_ptr(), do.data_ptr(),
              lse2.contiguous().data_ptr(), delta.contiguous().data_ptr(),
              tok.data_ptr(), mult.data_ptr(), chunks.data_ptr(),
              ws.data_ptr(), n_chunks, T, H, G, kh.shape[2], D,
              (first.numel() - 1) // (B * H), BS, *kh.stride()[:3],
              DTYPE_CODES[q.dtype], float(sm_scale) * _LOG2E,
              float(sm_scale))
    return ws


def dkdv_sum(ws, first, B: int, H: int, Tk: int, D: int):
    """``(dK, dV)`` float32 (B, H, Tk, D): each KV block's chunk partials
    in ``ws`` (:func:`dkdv_partials`) added in chunk order, ``first``
    (:func:`dkdv_plan`) giving each block's chunks; 0 for a block no
    token selects. One launch."""
    dk = torch.empty((B, H, Tk, D), dtype=torch.float32, device=ws.device)
    dv = torch.empty_like(dk)
    if dk.numel():
        _call("tl_nsa_bwd_dkdv_sum", "nsa_bwd_dkdv_sum", ws.device,
              [_P] * 4 + [_I] * 3, ws.data_ptr(), first.data_ptr(),
              dk.data_ptr(), dv.data_ptr(), first.numel() - 1, ws.shape[2],
              D)
    return dk, dv


def nsa_bwd_dkdv(q, kh, vh, do, lse2, delta, mask, block_size: int,
                 sm_scale: float, max_pairs: int | None = None):
    """``(dK, dV)`` float32 (B, H, Tk, D) for ``q, do (B, T, H, G, D)``,
    ``kh, vh (B, H, Tk, D)`` (any strides, head_dim contiguous), ``lse2,
    delta (B, T, H, G)`` float32 and the multiplicity map ``mask (B, T,
    H, NS)`` int32, NS blocks of ``block_size`` covering Tk. CUDA tensors
    launch the kernel of q's type (a program a chunk of
    :func:`dkdv_plan` and key tile: :func:`dkdv_partials`) and its
    fixed-order sum (:func:`dkdv_sum`); the 16-bit kernels read K and V
    16 bytes a copy, so views whose rows or base are not 16-byte aligned
    are copied first; ``max_pairs`` goes to the plan (a bound on the
    map's nonzeros: no host sync). CPU tensors run the plain version."""
    _check(q, kh, vh, do, lse2, delta, (mask,), "nsa_bwd_dkdv")
    _block_count(kh, mask, int(block_size))
    if not q.is_cuda:
        return nsa_bwd_dkdv_plain(q, kh, vh, do, lse2, delta, mask,
                                  block_size, sm_scale)
    B, T, H, G, D = q.shape
    q, kh, vh = _aligned(q, kh, vh)
    do = _aligned(do, kh, vh)[0]
    plan = dkdv_plan(mask, G, max_pairs)
    ws = dkdv_partials(q, kh, vh, do, lse2, delta, plan, block_size,
                       sm_scale)
    return dkdv_sum(ws, plan[3], B, H, kh.shape[2], D)


def nsa_bwd_dq(q, kh, vh, do, lse2, delta, bi, cnt, block_size: int,
               sm_scale: float):
    """dQ float32 (B, T, H, G, D) for the operands of
    :func:`nsa_bwd_dkdv` with the selections ``bi (B, T, H, S)`` and
    ``cnt (B, T, H)`` int32. CUDA tensors launch the kernel of q's type
    (K and V aligned as for
    :func:`nsa_bwd_dkdv`); CPU tensors run the plain version."""
    _check(q, kh, vh, do, lse2, delta, (bi, cnt), "nsa_bwd_dq")
    if bi.dim() != 4 or cnt.dim() != 3:
        raise ValueError(f"nsa_bwd_dq: ids (B, T, H, S) and counts (B, T, "
                         f"H), got {tuple(bi.shape)}, {tuple(cnt.shape)}")
    if not q.is_cuda:
        return nsa_bwd_dq_plain(q, kh, vh, do, lse2, delta, bi, cnt,
                                block_size, sm_scale)
    B, T, H, G, D = q.shape
    if G > KERNEL_MAX_GROUP:
        raise ValueError(f"nsa_bwd_dq: the kernel takes groups of at most "
                         f"{KERNEL_MAX_GROUP}, got {G}")
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    q, kh, vh = _aligned(q, kh, vh)
    do = _aligned(do, kh, vh)[0]
    _call("tl_nsa_bwd_dq", "nsa_bwd_dq", q.device,
          [_P] * 9 + [_I] * 8 + [_L] * 3 + [_I, ctypes.c_float,
                                            ctypes.c_float],
          q.data_ptr(), kh.data_ptr(), vh.data_ptr(), do.data_ptr(),
          lse2.contiguous().data_ptr(), delta.contiguous().data_ptr(),
          bi.contiguous().data_ptr(), cnt.contiguous().data_ptr(),
          dq.data_ptr(), B, T, H, G, kh.shape[2], D, bi.shape[-1],
          int(block_size), *kh.stride()[:3], DTYPE_CODES[q.dtype],
          float(sm_scale) * _LOG2E, float(sm_scale))
    return dq


def nsa_attention_bwd(q, kh, vh, bi, cnt, mask, o, lse2, g, causal: bool,
                      sm_scale: float):
    """``(dq, dk, dv)`` in the input types: the backward ``nsa_attention``
    gives ``ops/flash_attention.py::differentiable``, called as
    ``bwd(q, k, v, *aux, o, lse2, g, causal, sm_scale)`` with ``aux = (bi,
    cnt, mask)``. ``delta = sum(g o)`` in float32, then g in q's type to
    both kernels; the block size is Tk over the map's NS blocks. NSA is
    causal by its selections: ``causal`` is ignored."""
    BS = kh.shape[2] // mask.shape[-1]
    delta = (g.float() * o.float()).sum(-1)
    g_ = g.to(q.dtype)
    # dQ first, so that its kernel runs while the host queues dK / dV's
    # plan; the selections' slots bound the map's pairs: no host sync
    dq = nsa_bwd_dq(q, kh, vh, g_, lse2, delta, bi, cnt, BS, sm_scale)
    dk, dv = nsa_bwd_dkdv(q, kh, vh, g_, lse2, delta, mask, BS, sm_scale,
                          max_pairs=bi.numel())
    return dq.to(q.dtype), dk.to(kh.dtype), dv.to(vh.dtype)


# ---------------------------------------------------------------------------
# factories (the JAX package's arguments and kernel-side layouts)
# ---------------------------------------------------------------------------


def _grad_specs(B, Tq, H, G, Tk, D, dtype):
    dt = _as_dtype(dtype)
    qs, kv, st = ((B, Tq, H, G, D), dt), ((B, H, Tk, D), dt), \
        ((B, Tq, H, G), torch.float32)
    return [qs, kv, kv, qs, st, st]


def nsa_bwd_dkdv_kernel(B, Tq, H, G, Tk, D, NS, BS, sm_scale, dtype):
    """``fn(Q, K, V, dO, L, Delta, Mask (B, Tq, H, NS)) -> (dK, dV)``
    float32 (B, H, Tk, D)."""
    return bind("nsa_bwd_dkdv_kernel",
                _grad_specs(B, Tq, H, G, Tk, D, dtype)
                + [((B, Tq, H, NS), None)],
                lambda q, k, v, do, L, De, mask: nsa_bwd_dkdv(
                    q, k, v, do, L, De, _int32(mask, q.device), int(BS),
                    float(sm_scale)))


def nsa_bwd_dq_kernel(B, Tq, H, G, Tk, D, S, BS, sm_scale, dtype):
    """``fn(Q, K, V, dO, L, Delta, BI (B, Tq, H, S), Cnt (B, Tq, H)) ->
    dQ`` float32 (B, Tq, H, G, D)."""
    return bind("nsa_bwd_dq_kernel",
                _grad_specs(B, Tq, H, G, Tk, D, dtype)
                + [((B, Tq, H, S), None), ((B, Tq, H), None)],
                lambda q, k, v, do, L, De, bi, cnt: nsa_bwd_dq(
                    q, k, v, do, L, De, _int32(bi, q.device),
                    _int32(cnt, q.device), int(BS), float(sm_scale)))
