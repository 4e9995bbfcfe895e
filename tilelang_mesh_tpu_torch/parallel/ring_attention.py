"""Ring attention: sequence-parallel attention over a ring of ranks.

Counterpart of ``tilelang_mesh_tpu/parallel/ring_attention.py``. Q, K
and V are sharded on the sequence axis, one shard a rank of a
``torch.distributed`` group (``None``: one rank). Each step runs the
partial attention kernel (``ops/flash_attention.py``,
``mha_fwd_partial``: unnormalised float32 acc and exp2-domain (m, l)) on
the local Q against the KV shard held now, merges it into the running
state, and passes the KV shard one hop round the ring
(``dist.batch_isend_irecv``: to rank r + 1, from rank r - 1, the JAX
``ppermute``'s ``perm``). Causality across shards: the diagonal step is
causal within the shard, earlier shards are seen in full, later ones
are left out. The JAX layer computes a left-out step and merges it
masked to (-inf, 0), which leaves the state as it was; here it is
neither computed nor merged.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from ..ops.flash_attention import flash_attention_partial
from .device_mesh import axis_index, axis_size, peer_rank

__all__ = ["ring_attention_local", "make_ring_attention"]


def _merge(state, part):
    """Merge a new partial (o, m, l) into the running state (the JAX
    ``_merge`` with ``include`` true)."""
    o, m, l = state
    oi, mi, li = part
    m_new = torch.maximum(m, mi)
    alpha = torch.exp2(m - m_new)
    beta = torch.exp2(mi - m_new)
    o_new = o * alpha[..., None] + oi * beta[..., None]
    l_new = l * alpha + li * beta
    return (o_new, m_new, l_new)


def _rotate(kv, group):
    """Send each tensor of ``kv`` to the next rank of the ring and take
    the previous rank's in its place."""
    P, r = axis_size(group), axis_index(group)
    nxt, prv = peer_rank(group, (r + 1) % P), peer_rank(group, (r - 1) % P)
    recv = tuple(torch.empty_like(t) for t in kv)
    ops = []
    for t, buf in zip(kv, recv):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), nxt, group))
        ops.append(dist.P2POp(dist.irecv, buf, prv, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


def ring_attention_local(q, k, v, group: Optional["dist.ProcessGroup"] = None,
                         causal: bool = True,
                         sm_scale: Optional[float] = None,
                         block_M: int = 128, block_N: int = 128):
    """This rank's ring attention: q, k, v are its sequence shards
    (B, H, S_local, D); returns its output shard in q's type. The block
    sizes are the TPU's tiling hints, ignored (the kernel picks its
    tiles)."""
    B, H, S, D = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    P = axis_size(group)
    r = axis_index(group)

    # step 0: the diagonal block (always included; causal within the shard)
    o, m, l = flash_attention_partial(q, k, v, causal, sm_scale)
    kv = (k, v)
    for s in range(1, P):
        kv = _rotate(kv, group)
        src = (r - s) % P
        if src < r or not causal:
            part = flash_attention_partial(q, kv[0], kv[1], False, sm_scale)
            o, m, l = _merge((o, m, l), part)
    return (o / l[..., None]).to(q.dtype)


def make_ring_attention(group: Optional["dist.ProcessGroup"] = None,
                        causal: bool = True,
                        sm_scale: Optional[float] = None,
                        block_M: int = 128, block_N: int = 128):
    """Ring attention over ``group``: ``fn(q, k, v)`` on this rank's
    sequence shards (B, H, S_local, D); rank r holds positions
    ``r * S_local ... (r + 1) * S_local - 1``."""

    def fn(q, k, v):
        return ring_attention_local(q, k, v, group, causal, sm_scale,
                                    block_M, block_N)

    return fn
