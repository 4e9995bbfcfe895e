"""Gradients of the port's packed varlen attention against ``jax.grad``
through the JAX package's kernel path (its partial forward and its dK/dV
and dQ kernels in Pallas interpret mode on the CPU), on the same
numpy-seeded inputs, at the JAX package's own backward tolerance, 3e-2
(tests/test_flash_varlen.py:199). The port runs on CPU tensors: its
partial forward and backward kernels' plain versions.

Kept apart from tests/test_torch_flash_varlen.py so that pytest-xdist's
``--dist loadfile`` runs the two files on two workers.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

ref = importlib.import_module("tilelang_mesh_tpu.ops.flash_attention_varlen")
port = importlib.import_module(
    "tilelang_mesh_tpu_torch.ops.flash_attention_varlen")

GRAD_TOL = 3e-2

CASES = {  # lens_q, lens_k, Hq, Hkv, causal, causal_align
    "mha_causal": ([33, 47, 21], [33, 47, 21], 2, 2, True, "top-left"),
    "gqa_causal": ([33, 47, 21], [33, 47, 21], 4, 2, True, "top-left"),
    "gqa_unequal_lens": ([20, 35, 11], [44, 17, 52], 4, 2, False,
                         "top-left"),
    "causal_unequal_lens_bottom_right": ([18, 30], [41, 26], 2, 2, True,
                                         "bottom-right"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_jax(case):
    lens_q, lens_k, Hq, Hkv, causal, align = CASES[case]
    cu_q = np.concatenate([[0], np.cumsum(lens_q)]).astype(np.int32)
    cu_k = np.concatenate([[0], np.cumsum(lens_k)]).astype(np.int32)
    tq, tk, D = int(cu_q[-1]), int(cu_k[-1]), 64
    rng = np.random.default_rng(len(case))
    q, k, v, g = (rng.standard_normal(s).astype(np.float32)
                  for s in ((tq, Hq, D), (tk, Hkv, D), (tk, Hkv, D),
                            (tq, Hq, D)))
    kw = dict(causal=causal, block_M=32, block_N=32, causal_align=align)

    def loss(q, k, v):
        return jnp.sum(ref.flash_attention_varlen(q, k, v, cu_q, cu_k, **kw)
                       * jnp.asarray(g))

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    port.flash_attention_varlen(*leaves, cu_q, cu_k, **kw).backward(
        torch.from_numpy(g))
    for name, t, w in zip(("dQ", "dK", "dV"), leaves, want):
        assert t.grad.shape == t.shape
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=f"{name} ({case})")
