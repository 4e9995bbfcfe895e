"""The port's attention forward in bfloat16 and float16
(tilelang_mesh_tpu_torch/ops/flash_attention.py, gqa.py) against the JAX
package's kernels in the same type.

``mha_fwd_plain``, ``mha_fwd_partial_plain``, ``gqa_fwd_plain`` and
``gqa_fwd_partial_plain`` are the functions the card's tensor-core
forward (``csrc/flash_attention.cu``'s ``mha_fwd_mma``) is held to by
tests/test_torch_cuda.py. Here they run on CPU tensors against
``mha_fwd_kernel`` (``_mha_fwd_kernel``), its partial form
(``_mha_fwd_partial_kernel``), ``gqa_fwd_kernel`` and
``gqa_fwd_partial_kernel`` of the JAX package, run as its own tests run
them on the CPU (Pallas interpret mode), on the same inputs in the same
type: numpy-seeded standard normal Q, K, V rounded to the type once.
Lengths are no multiple of the card kernel's 64-row tiles; the JAX
kernels take 32-row tiles where 32 divides both lengths, else one tile a
length (on a partial last tile they read past Sk and give NaN). GQA at
group 4. Tolerance 2e-2, the reference's forward tolerance
(tests/test_torch_flash_attention.py, tests/test_model.py:37), on O and
on the partials' m, l and acc / l: the unnormalised acc sums l's order
of values per row, and both sides round P to the type against another
running max (JAX's per 32-key tile, the plain version's over the row).
"""

import importlib
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

ref_fa = importlib.import_module("tilelang_mesh_tpu.ops.flash_attention")
ref_gqa = importlib.import_module("tilelang_mesh_tpu.ops.gqa")
port_fa = importlib.import_module(
    "tilelang_mesh_tpu_torch.ops.flash_attention")
port_gqa = importlib.import_module("tilelang_mesh_tpu_torch.ops.gqa")

TOL = 2e-2
_DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16),
           "float16": (jnp.float16, torch.float16)}

SHAPES = [  # (Sq, Sk, D)
    (96, 160, 32),            # Sq < Sk
    (160, 96, 64),            # Sq > Sk
    (100, 77, 32),            # neither a multiple of 32
]


def _blocks(Sq, Sk):
    return (32, 32) if Sq % 32 == 0 and Sk % 32 == 0 else (Sq, Sk)


def _jax_op(op, B, Hq, Hkv, Sq, Sk, D, causal, sm, dtype):
    bm, bn = _blocks(Sq, Sk)
    if op == "mha_fwd":
        return ref_fa.mha_fwd_kernel(B, Hq, Sq, Sk, D, bm, bn, causal, sm,
                                     dtype)
    if op == "mha_fwd_partial":
        return ref_fa._mha_fwd_kernel(B, Hq, Sq, Sk, D, bm, bn, causal, sm,
                                      dtype, 2, return_partials=True)
    kern = {"gqa_fwd": ref_gqa.gqa_fwd_kernel,
            "gqa_fwd_partial": ref_gqa.gqa_fwd_partial_kernel}[op]
    return kern(B, Hq, Hkv, Sq, Sk, D, bm, bn, causal, sm, dtype)


_PLAIN = {"mha_fwd": port_fa.mha_fwd_plain,
          "mha_fwd_partial": port_fa.mha_fwd_partial_plain,
          "gqa_fwd": port_gqa.gqa_fwd_plain,
          "gqa_fwd_partial": port_gqa.gqa_fwd_partial_plain}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("op", sorted(_PLAIN))
def test_forward_plain_matches_jax_kernel(op, dtype, causal, shape):
    Sq, Sk, D = shape
    B, Hq, Hkv = (1, 8, 2) if op.startswith("gqa") else (1, 2, 2)
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D))]
    jd, td = _DTYPES[dtype]
    js = [jnp.asarray(a, jd) for a in arrays]
    ts = [torch.from_numpy(np.array(j, np.float32)).to(td) for j in js]
    sm = 1.0 / math.sqrt(D)

    want = _jax_op(op, B, Hq, Hkv, Sq, Sk, D, causal, sm, dtype)(*js)
    got = _PLAIN[op](*ts, causal, sm)
    if op.endswith("partial"):
        assert all(g.dtype == torch.float32 for g in got)
        got = [g.numpy() for g in got]
        want = [np.asarray(w) for w in want]
        # acc is a sum of l's order over the row: each side's acc / l
        got[0], want[0] = (a / x[..., None] for a, x in ((got[0], got[2]),
                                                          (want[0], want[2])))
        names = ("acc / l", "m", "l")
    else:
        assert got.dtype == td and got.shape == ts[0].shape
        got = [got.float().numpy()]
        want = [np.asarray(jnp.asarray(want, jnp.float32))]
        names = ("o",)
    for name, g, w in zip(names, got, want):
        assert np.isfinite(w).all()
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_factory_tile_hints_name_instances(dtype, D):
    """A factory's (block_M, block_N) picks the tensor-core tile only
    when it names one of the kernel's instances for the type and
    head_dim; any other hint, and every float32 hint, leaves the
    kernel's default (None)."""
    from tilelang_mesh_tpu_torch.carver import FLASH_KERNEL_TILES
    for bm, bn in [(64, 64), (128, 64), (64, 128), (128, 128), (64, 32),
                   (128, 32), (256, 64), (128, 256), (512, 512)]:
        want = (bm, bn) if (dtype != "float32" and
                            (bm, bn) in FLASH_KERNEL_TILES[D]) else None
        assert port_fa.kernel_tile(dtype, D, bm, bn) == want
        assert port_fa.kernel_tile(getattr(torch, dtype), D, bm, bn) == want
    assert port_fa.KERNEL_HEAD_DIMS == tuple(sorted(FLASH_KERNEL_TILES))
