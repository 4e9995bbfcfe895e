"""The port's attention backward (tilelang_mesh_tpu_torch/ops/gqa_bwd.py)
against the JAX package's kernels in each input type.

``gqa_bwd_dkdv_plain`` and ``gqa_bwd_dq_plain`` are the functions the
card kernels (``csrc/gqa_bwd.cu``: CUDA cores in float32, tensor cores in
bfloat16 and float16) are held to by tests/test_torch_cuda.py. Here they
run on CPU tensors against ``gqa_bwd_dkdv_kernel`` and
``gqa_bwd_dq_kernel`` of the JAX package, run as its own tests run them
on the CPU (Pallas interpret mode), on the same inputs in the same type:
numpy-seeded standard normal Q, K, V, dO rounded to the type once, and
the forward's ``lse2`` and ``delta`` (float32) from the port's plain
partial forward, handed to both sides. Both round P and dS to the input
type before their products. Tolerance rtol 3e-2, atol 3e-1, the
reference's backward tolerance (tests/test_flash_bwd.py:34).
"""

import importlib
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

ref = importlib.import_module("tilelang_mesh_tpu.ops.gqa_bwd")
port = importlib.import_module("tilelang_mesh_tpu_torch.ops.gqa_bwd")
port_fa = importlib.import_module(
    "tilelang_mesh_tpu_torch.ops.flash_attention")

RTOL, ATOL = 3e-2, 3e-1
D = 32
BLOCK = 64                    # the JAX kernels' block_M and block_N
_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16),
           "float16": (jnp.float16, torch.float16)}

CASES = [  # (B, Hq, Hkv, Sq, Sk)
    (1, 2, 2, 128, 128),      # group 1 (MHA)
    (1, 4, 2, 128, 128),      # group 2
    (1, 4, 1, 128, 128),      # group 4
    (1, 4, 2, 64, 128),       # Sq != Sk
]


def _inputs(B, Hq, Hkv, Sq, Sk, dtype, causal, seed=0):
    """(JAX operands, port operands, sm_scale): Q, K, V, dO in ``dtype``
    with the same values on both sides, lse2 and delta float32."""
    jd, td = _DTYPES[dtype]
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D),
                        (B, Hq, Sq, D))]
    js = [jnp.asarray(a, jd) for a in arrays]
    q, k, v, do = (torch.from_numpy(np.array(j, np.float32)).to(td)
                   for j in js)
    sm = 1.0 / math.sqrt(D)
    group = Hq // Hkv
    acc, m, l = port_fa.mha_fwd_partial_plain(
        q, k.repeat_interleave(group, 1), v.repeat_interleave(group, 1),
        causal, sm)
    lse2 = m + torch.log2(l)
    delta = (do.float() * (acc / l[..., None]).to(td).float()).sum(-1)
    js += [jnp.asarray(t.numpy()) for t in (lse2, delta)]
    return js, (q, k, v, do, lse2, delta), sm


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_backward_matches_jax(case, causal, dtype):
    """dK, dV summed over the group and dQ, float32, against the JAX
    factories at the same shape and type."""
    B, Hq, Hkv, Sq, Sk = case
    js, ts, sm = _inputs(B, Hq, Hkv, Sq, Sk, dtype, causal)
    args = (B, Hq, Hkv, Sq, Sk, D, BLOCK, BLOCK, causal, sm, dtype)
    want_dk, want_dv = ref.gqa_bwd_dkdv_kernel(*args)(*js)
    want_dq = ref.gqa_bwd_dq_kernel(*args)(*js)
    got_dk, got_dv = port.gqa_bwd_dkdv_plain(*ts, causal, sm)
    got_dq = port.gqa_bwd_dq_plain(*ts, causal, sm)
    for name, got, want in (("dK", got_dk, want_dk), ("dV", got_dv, want_dv),
                            ("dQ", got_dq, want_dq)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name} ({dtype})")
