"""The port's grouped GEMMs (tilelang_mesh_tpu_torch/ops/grouped_gemm.py)
against the JAX package's (ops/grouped_gemm.py) on the same
numpy-seeded inputs.

The JAX kernels run in Pallas interpret mode on the CPU, as
tests/test_parallel_ops.py and tests/test_gemm_variants.py run them; the
port's run on CPU tensors, i.e. the kernels' plain versions. Tolerance:
1e-4 normwise (max |port - jax| over max |jax|) in float32, the same
float32 arithmetic in another order (the JAX grouped GEMM sits 3.4e-7
from float64 at (4, 128, 256) @ (4, 256, 128)); 1e-2 in bfloat16, where
both round a float32 sum to bf16 and one ulp is 2**-8. The reference's
own bounds (2e-2 / 2e-1 and 1e-2 / 1e-1) are only an upper limit. The
CUDA kernels are held against the plain versions on the card by
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tilelang_mesh_tpu.ops import grouped_gemm as ref
from tilelang_mesh_tpu_torch.ops import grouped_gemm as port

TOL = 1e-4
BF16_TOL = 1e-2
SIZES = (130, 0, 64, 257)        # tests/test_gemm_variants.py:86


def _normwise(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


# test_parallel_ops.py:16's shape, and one ragged in M and N (the JAX
# kernel needs K to be a multiple of its 128-deep tile: at K = 200 its
# output is NaN, see test_plain_handles_any_depth)
@pytest.mark.parametrize("shape", [(4, 128, 256, 128), (3, 200, 256, 150),
                                   (2, 5, 64, 48)])
def test_grouped_matmul_matches_jax(shape):
    E, M, K, N = shape
    rng = np.random.default_rng(0)
    x, w = _rand(rng, (E, M, K)), _rand(rng, (E, K, N))
    want = np.asarray(ref.grouped_matmul(jnp.asarray(x), jnp.asarray(w)))
    before = dict(port.launches)
    got = port.grouped_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert tuple(got.shape) == (E, M, N) and got.dtype == torch.float32
    assert _normwise(got.numpy(), want) <= TOL
    assert port.launches == before          # CPU tensors launch nothing


def test_grouped_matmul_bf16_matches_jax():
    rng = np.random.default_rng(1)
    x, w = _rand(rng, (2, 64, 128)), _rand(rng, (2, 128, 96))
    want = np.asarray(ref.grouped_matmul(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)),
        np.float32)
    got = port.grouped_matmul(torch.from_numpy(x).bfloat16(),
                              torch.from_numpy(w).bfloat16())
    assert got.dtype == torch.bfloat16
    assert _normwise(got.float().numpy(), want) <= BF16_TOL


def test_plain_handles_any_depth():
    """K = 200 and M, N off any tile, against float64 numpy."""
    rng = np.random.default_rng(2)
    x, w = _rand(rng, (3, 77, 200)), _rand(rng, (3, 200, 150))
    got = port.grouped_matmul(torch.from_numpy(x), torch.from_numpy(w))
    want = np.einsum("emk,ekn->emn", x.astype(np.float64), w)
    assert _normwise(got.numpy(), want) <= TOL


@pytest.mark.parametrize("trans_b", [False, True])
def test_varlen_matches_jax(trans_b):
    """test_gemm_variants.py:81-100, both layouts of b."""
    rng = np.random.default_rng(3)
    K = N = 128
    a = _rand(rng, (sum(SIZES), K))
    b = _rand(rng, (len(SIZES), K, N))
    if trans_b:
        b = np.ascontiguousarray(b.transpose(0, 2, 1))
    want = np.asarray(ref.varlen_grouped_matmul(
        jnp.asarray(a), jnp.asarray(b), SIZES, trans_b=trans_b,
        block_N=128, block_K=64 if trans_b else 128))
    got = port.varlen_grouped_matmul(torch.from_numpy(a), torch.from_numpy(b),
                                     SIZES, trans_b=trans_b)
    assert tuple(got.shape) == (sum(SIZES), N) and got.dtype == torch.float32
    assert _normwise(got.numpy(), want) <= TOL
    plain = port.varlen_grouped_matmul_reference(
        torch.from_numpy(a), torch.from_numpy(b), SIZES, trans_b)
    assert _normwise(plain.numpy(), np.asarray(
        ref.varlen_grouped_matmul_reference(jnp.asarray(a), jnp.asarray(b),
                                            SIZES, trans_b))) <= TOL


def test_varlen_bf16_is_float32_out():
    rng = np.random.default_rng(4)
    sizes = (3, 0, 40)
    a, b = _rand(rng, (43, 64)), _rand(rng, (3, 64, 32))
    want = np.asarray(ref.varlen_grouped_matmul(
        jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16), sizes,
        block_K=64, block_N=32))
    got = port.varlen_grouped_matmul(torch.from_numpy(a).bfloat16(),
                                     torch.from_numpy(b).bfloat16(), sizes)
    assert got.dtype == torch.float32
    assert _normwise(got.numpy(), want) <= TOL


@pytest.mark.parametrize("sizes,block_M", [(SIZES, 128), ((5, 7, 0), 4),
                                           ((), 8), ((0, 0), 16),
                                           ((1280, 977, 0, 3), 128)])
def test_varlen_meta_tables_equal_jax(sizes, block_M):
    for got, want in zip(port._varlen_meta(sizes, block_M),
                         ref._varlen_meta(sizes, block_M)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sizes,match", [((4, 4), "sum"),
                                         ((10,), "len"),
                                         ((4, 3, 3), "len")])
def test_varlen_validates_as_jax(sizes, match):
    """test_gemm_variants.py:102-108: the same ValueErrors."""
    with pytest.raises(ValueError, match=match):
        ref.varlen_grouped_matmul(jnp.zeros((10, 32), jnp.float32),
                                  jnp.zeros((2, 32, 32), jnp.float32), sizes)
    with pytest.raises(ValueError, match=match):
        port.varlen_grouped_matmul(torch.zeros((10, 32)),
                                   torch.zeros((2, 32, 32)), sizes)


def test_wrappers_refuse_mixed_types_and_shapes():
    x = torch.zeros((2, 4, 8))
    with pytest.raises(TypeError):
        port.grouped_matmul(x, torch.zeros((2, 8, 3), dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        port.grouped_matmul(x, torch.zeros((2, 7, 3)))
    with pytest.raises(ValueError):
        port.varlen_grouped_matmul(torch.zeros((4, 8)),
                                   torch.zeros((2, 7, 3)), (2, 2))
