"""Seer attention: learned-gate block-sparse causal attention.

Counterpart of ``tilelang_mesh_tpu/ops/seer_attention.py``, host code
only: a pooled gate score per (query block, key block) picks, by top-k,
the key blocks each query block attends (``seer_block_mask``, integer
for integer the JAX package's mask, ties included); the attention itself
is the block-sparse kernel (``ops/blocksparse_attention.py``, causal).
"""

from __future__ import annotations

from typing import Optional

import torch

from .blocksparse_attention import (blocksparse_attention,
                                    blocksparse_reference)

__all__ = ["seer_block_mask", "seer_attention", "seer_reference"]


def seer_block_mask(gate_logits, topk: int, block_M: int, block_N: int,
                    causal: bool = True) -> torch.Tensor:
    """gate_logits (B, H, nQ, nK) -> int32 mask selecting the top-k key
    blocks per query block (causally valid blocks only): a block is kept
    when its gate is at least the k-th largest of its row, and finite."""
    nQ, nK = gate_logits.shape[-2:]
    g = gate_logits.float()
    if causal:
        # key block kb is (partly) visible to query block qb when its
        # first key is at most the block's newest query row
        qb = torch.arange(nQ, device=g.device)[:, None]
        kb = torch.arange(nK, device=g.device)[None, :]
        g = torch.where(kb * block_N <= qb * block_M + block_M - 1, g,
                        -torch.inf)
    k = min(topk, nK)
    thresh = torch.sort(g, dim=-1).values[..., nK - k:nK - k + 1]
    return ((g >= thresh) & torch.isfinite(g)).to(torch.int32)


def seer_attention(q, k, v, gate_logits, topk: int = 4,
                   sm_scale: Optional[float] = None, block_M: int = 128,
                   block_N: int = 128) -> torch.Tensor:
    """q, k, v (B, H, S, D); gate_logits (B, H, S // block_M, S //
    block_N) learned block-level gates; each query block attends its
    top-k gated key blocks, causally masked, on the block-sparse
    kernel."""
    block_M = min(block_M, q.shape[2])
    block_N = min(block_N, k.shape[2])
    mask = seer_block_mask(gate_logits, topk, block_M, block_N, causal=True)
    return blocksparse_attention(q, k, v, mask, sm_scale=sm_scale,
                                 block_M=block_M, block_N=block_N,
                                 causal=True)


def seer_reference(q, k, v, gate_logits, topk, block_M, block_N,
                   sm_scale: Optional[float] = None) -> torch.Tensor:
    mask = seer_block_mask(gate_logits, topk, block_M, block_N, causal=True)
    return blocksparse_reference(q, k, v, mask, block_M, block_N,
                                 sm_scale=sm_scale, causal=True)
