"""Fused MoE sharded over an expert-parallel process group.

Counterpart of ``tilelang_mesh_tpu/parallel/moe.py``, step for step:
capacity-limited top-k routing, token dispatch to the experts' ranks by
a tiled all-to-all over the group, each rank's expert FFN on the grouped
GEMM kernel (``ops/grouped_gemm.py``, two launches a call), the return
all-to-all and the weighted combine. The JAX layer is one ``shard_map``
over a mesh axis; here each rank runs ``moe_ffn_local`` on its token
and expert shards, and the axis is a ``torch.distributed`` group
(``None``: one rank, every collective the identity; see
``device_mesh.py``). The router product and the dispatch and combine
einsums are plain products that the JAX package leaves to XLA; they stay
``torch`` calls.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.grouped_gemm import grouped_matmul
from .device_mesh import axis_index, axis_size

__all__ = ["moe_ffn_local", "make_moe_layer", "moe_reference", "route",
           "shard_rows", "weights_from_numpy"]


def _pick_block(dim: int, pref: int) -> int:
    b = min(pref, dim)
    while b > 1 and dim % b:
        b -= 1
    return max(1, b)


def route(x, w_router, top_k: int, capacity: int):
    """Capacity-limited top-k routing of tokens ``x (T, d)``:
    ``(combine (T, E, C) float32, dispatch (T, E, C) in x's type)``.
    Token t's slot-th choice e takes place ``pos`` in expert e's queue,
    counted over the tokens before it in this slot plus every earlier
    slot's takers of e (float32 cumulative sums, exact below 2**24); a
    place at or past ``capacity`` drops the pair (a zero row, as
    ``jax.nn.one_hot`` gives out of range)."""
    T_local = x.shape[0]
    E = w_router.shape[1]
    C = capacity
    logits = x.float() @ w_router.float()
    probs = torch.softmax(logits, -1)
    top_p, top_e = torch.topk(probs, top_k, dim=-1)       # (T, k)

    combine = torch.zeros((T_local, E, C), dtype=torch.float32,
                          device=x.device)
    base = torch.zeros((E,), dtype=torch.float32, device=x.device)
    for slot in range(top_k):
        onehot = F.one_hot(top_e[:, slot], E).float()     # (T, E)
        ranks = (torch.cumsum(onehot, 0) - 1.0 + base[None, :]) * onehot
        pos = ranks.sum(1).long()                         # (T,)
        keep = pos < C
        # class C catches every dropped place and is cut away
        cap_onehot = F.one_hot(pos.clamp(max=C), C + 1)[:, :C].float() \
            * keep[:, None]
        combine = combine + top_p[:, slot][:, None, None] * \
            onehot[:, :, None] * cap_onehot[:, None, :]
        base = base + onehot.sum(0)
    return combine, (combine > 0).to(x.dtype)


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Chunk p of ``t``'s first axis to rank p; chunk q of the result from
    rank q."""
    if axis_size(group) == 1:
        return t
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t.contiguous(), group=group)
    return out


def moe_ffn_local(x, w_router, w1, w2, top_k: int, capacity: int,
                  group: Optional["dist.ProcessGroup"] = None,
                  use_tile_kernel: bool = True):
    """One rank's fused MoE FFN.

    x (T_local, d) token shard; w_router (d, E) replicated;
    w1 (E_local, d, f), w2 (E_local, f, d) this rank's expert shards
    (experts r * E_local ... (r + 1) * E_local - 1 on rank r).
    """
    T_local, d = x.shape
    E = w_router.shape[1]
    E_local = w1.shape[0]
    P = axis_size(group)
    if E_local * P != E:
        raise ValueError(f"{E_local} local experts on each of {P} ranks "
                         f"are not the router's {E}")
    C = capacity

    # --- route and build the capacity-limited dispatch (T, E, C) ----------
    combine, dispatch = route(x, w_router, top_k, C)

    # --- dispatch tokens to the experts' ranks -----------------------------
    xe = torch.einsum("td,tec->ecd", x, dispatch)         # (E, C, d)
    # tiled all_to_all(split_axis=0, concat_axis=1): expert block p to
    # rank p; the blocks received stack on the capacity axis by source
    xe = _all_to_all(xe, group).view(P, E_local, C, d)
    xe = xe.permute(1, 0, 2, 3).reshape(E_local, P * C, d)

    # --- expert FFN (grouped tile GEMM) ------------------------------------
    M = xe.shape[1]
    f = w1.shape[-1]
    if use_tile_kernel:
        h = grouped_matmul(xe, w1, block_M=_pick_block(M, 128),
                           block_N=_pick_block(f, 128),
                           block_K=_pick_block(d, 512))
        h = F.silu(h.float()).to(x.dtype)
        ye = grouped_matmul(h, w2, block_M=_pick_block(M, 128),
                            block_N=_pick_block(d, 128),
                            block_K=_pick_block(f, 512))
    else:
        h = F.silu(torch.einsum("ecd,edf->ecf", xe, w1))
        ye = torch.einsum("ecf,efd->ecd", h, w2).to(x.dtype)

    # --- return + combine --------------------------------------------------
    # tiled all_to_all(split_axis=1, concat_axis=0): capacity block p back
    # to rank p, stacked on the expert axis by source
    ye = ye.view(E_local, P, C, d).permute(1, 0, 2, 3)
    ye = _all_to_all(ye.contiguous(), group).view(E, C, d)
    out = torch.einsum("ecd,tec->td", ye.float(), combine)
    return out.to(x.dtype)


def make_moe_layer(group: Optional["dist.ProcessGroup"] = None,
                   top_k: int = 2, capacity_factor: float = 1.25,
                   use_tile_kernel: bool = True):
    """The MoE layer over ``group``: ``fn(x_local (T_local, d), w_router
    (d, E), w1_local (E_local, d, f), w2_local (E_local, f, d)) ->
    (T_local, d)``, each rank passing its token and expert shards
    (``shard_rows``, ``weights_from_numpy``). Capacity per expert is
    ``max(4, ceil(T_local * top_k * capacity_factor / E))``."""

    def fn(x, wr, w1, w2):
        T_local = x.shape[0]
        E = wr.shape[1]
        cap = int(math.ceil(T_local * top_k * capacity_factor / E))
        cap = max(4, cap)
        return moe_ffn_local(x, wr, w1, w2, top_k, cap, group,
                             use_tile_kernel)

    return fn


def moe_reference(x, w_router, w1_full, w2_full, top_k: int):
    """Dense reference: every token through its top-k experts, no capacity
    limit (tests use capacity large enough to avoid drops)."""
    logits = x.float() @ w_router.float()
    probs = torch.softmax(logits, -1)
    top_p, top_e = torch.topk(probs, top_k, dim=-1)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    E = w_router.shape[1]
    for slot in range(top_k):
        for e in range(E):
            sel = (top_e[:, slot] == e).float()
            h = F.silu(x.float() @ w1_full[e].float())
            y = h @ w2_full[e].float()
            out = out + y * (sel * top_p[:, slot])[:, None]
    return out.to(x.dtype)


def shard_rows(a, group: Optional["dist.ProcessGroup"] = None,
               device=None) -> torch.Tensor:
    """This rank's block of the first axis of numpy ``a`` (the JAX
    package's ``P(axis)`` sharding), as a tensor on ``device`` (default
    the card)."""
    P, r = axis_size(group), axis_index(group)
    if a.shape[0] % P:
        raise ValueError(f"{a.shape[0]} rows do not split over {P} ranks")
    n = a.shape[0] // P
    return torch.from_numpy(np.ascontiguousarray(a[r * n:(r + 1) * n])).to(
        resolve_device(device))


def weights_from_numpy(w_router, w1, w2,
                       group: Optional["dist.ProcessGroup"] = None,
                       device=None):
    """The JAX layer's full arrays, as numpy, to this rank's tensors on
    ``device``: ``(w_router (d, E), w1 (E_local, d, f), w2 (E_local, f,
    d))`` with the router replicated and rank r holding experts
    ``r * E_local ... (r + 1) * E_local - 1``."""
    wr = torch.from_numpy(np.ascontiguousarray(w_router)).to(
        resolve_device(device))
    return (wr, shard_rows(w1, group, device), shard_rows(w2, group, device))
