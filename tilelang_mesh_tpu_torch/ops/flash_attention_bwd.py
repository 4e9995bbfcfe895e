"""Multi-head attention backward: the group = 1 case of ``gqa_bwd``.

Counterpart of ``tilelang_mesh_tpu/ops/flash_attention_bwd.py``. Softmax
is recomputed from the forward's ``lse2 = m + log2(l)`` (exp2 domain); the
chain rule's ``ln 2 * log2(e) == 1`` makes ``dS = P * (dP - delta) *
sm_scale`` exact. The dK/dV and dQ kernels of ``ops/gqa_bwd.py`` are the
single home of the backward loops, so this module only delegates.
"""

from .gqa_bwd import (gqa_attention_bwd, gqa_bwd_dkdv_kernel,
                      gqa_bwd_dq_kernel)

__all__ = ["flash_attention_bwd", "mha_bwd_dkdv_kernel", "mha_bwd_dq_kernel"]


def mha_bwd_dkdv_kernel(B, H, Sq, Sk, D, block_M, block_N, causal, sm_scale,
                        dtype, num_stages=2):
    """``gqa_bwd_dkdv_kernel`` with Hkv = H (the JAX factory's
    arguments)."""
    return gqa_bwd_dkdv_kernel(B, H, H, Sq, Sk, D, block_M, block_N, causal,
                               sm_scale, dtype, num_stages)


def mha_bwd_dq_kernel(B, H, Sq, Sk, D, block_M, block_N, causal, sm_scale,
                      dtype, num_stages=2):
    """``gqa_bwd_dq_kernel`` with Hkv = H (the JAX factory's
    arguments)."""
    return gqa_bwd_dq_kernel(B, H, H, Sq, Sk, D, block_M, block_N, causal,
                             sm_scale, dtype, num_stages)


def flash_attention_bwd(q, k, v, o, lse2, g, causal, sm_scale, block_M=128,
                        block_N=128):
    """``(dq, dk, dv)`` in the input types; q, k, v share their heads.
    ``block_M`` and ``block_N`` are the TPU's tile hints."""
    return gqa_attention_bwd(q, k, v, o, lse2, g, causal, sm_scale, block_M,
                             block_N)
