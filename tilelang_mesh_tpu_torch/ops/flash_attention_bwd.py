"""Multi-head attention backward: the group = 1 case of ``gqa_bwd``.

Counterpart of ``tilelang_mesh_tpu/ops/flash_attention_bwd.py``. Softmax
is recomputed from the forward's ``lse2 = m + log2(l)`` (exp2 domain); the
chain rule's ``ln 2 * log2(e) == 1`` makes ``dS = P * (dP - delta) *
sm_scale`` exact. The dK/dV and dQ kernels of ``ops/gqa_bwd.py`` are the
single home of the backward loops, so this module only delegates.
"""

from .gqa_bwd import gqa_attention_bwd

__all__ = ["flash_attention_bwd"]


def flash_attention_bwd(q, k, v, o, lse2, g, causal, sm_scale):
    """``(dq, dk, dv)`` in the input types; q, k, v share their heads."""
    return gqa_attention_bwd(q, k, v, o, lse2, g, causal, sm_scale)
