"""The port's row softmax (tilelang_mesh_tpu_torch/ops/softmax.py) against
the JAX package's on the same numpy-seeded inputs.

The JAX side runs its kernel in Pallas interpret mode on the CPU; the
port side runs on CPU tensors, i.e. the kernel's plain PyTorch version.
Tolerances: 1e-5 for a float32 output (the same float32 shift, exp2,
sum and divide; the sums in another order); one bfloat16 ulp for a
bfloat16 output (a 1e-7 difference at a rounding boundary flips one
ulp). NaN rows (all -inf, or holding +inf) sit at the same positions.
The CUDA kernel is held against the plain version on the card by
tests/test_torch_cuda.py.
"""

import importlib
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

ref = importlib.import_module("tilelang_mesh_tpu.ops.softmax")
port = importlib.import_module("tilelang_mesh_tpu_torch.ops.softmax")

TOL = 1e-5
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
        "float16": jnp.float16}


def _x(M, N, seed, scale=4.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal((M, N))).astype(np.float32)


def _both(x, dtype):
    """The same values on both sides: rounded to ``dtype`` by JAX, copied
    to torch as float32 and cast back (exact)."""
    j = jnp.asarray(x, _JNP[dtype])
    return j, torch.from_numpy(np.array(j, np.float32)).to(
        getattr(torch, dtype))


def _within_one_ulp(got, want):
    """|got - want| <= one bfloat16 ulp of want, elementwise."""
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 2.0 ** -126))) - 7)
    assert np.all(np.abs(g - w) <= ulp), float(np.abs(g - w).max())


@pytest.mark.parametrize("M,N,block_M", [(64, 256, None), (200, 96, 128),
                                         (4096, 8, None), (3, 1500, 2),
                                         (1, 1, None)])
def test_float32_matches_jax(M, N, block_M):
    """Ragged M (200 rows, blocks of 128), Mixtral's router width (8),
    a row wider than a warp's kernel (1500) and one element."""
    x = _x(M, N, seed=M + N)
    jx, tx = _both(x, "float32")
    want = np.asarray(ref.softmax(jx, block_M=block_M))
    got = port.softmax(tx, block_M=block_M)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
def test_bfloat16_output_within_one_ulp(in_dtype):
    x = _x(96, 300, seed=5)
    jx, tx = _both(x, in_dtype)
    want = ref.softmax(jx, out_dtype="bfloat16")
    got = port.softmax(tx, out_dtype="bfloat16")
    assert got.dtype == torch.bfloat16
    _within_one_ulp(got, np.asarray(want.astype(jnp.float32)))
    if in_dtype == "bfloat16":    # the default output is the input's type
        assert port.softmax(tx).dtype == torch.bfloat16


def test_bfloat16_in_float32_out():
    """The vocabulary case's types: a bfloat16 row, a float32 output."""
    x = _x(128, 1000, seed=6, scale=8.0)
    jx, tx = _both(x, "bfloat16")
    want = np.asarray(ref.softmax(jx, out_dtype="float32"))
    got = port.softmax(tx, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_nan_rows_match_jax():
    """A row that is all -inf, or holds +inf, is NaN on both sides; a row
    with some -inf is finite, 0 at the -inf."""
    x = _x(8, 40, seed=7)
    x[1] = -np.inf
    x[3, 5] = np.inf
    x[4, :3] = -np.inf
    x[6, 0] = np.inf
    x[6, 1] = -np.inf
    jx, tx = _both(x, "float32")
    want = np.asarray(ref.softmax(jx))
    got = port.softmax(tx).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[[1, 3, 6]]).all()
    assert not np.isnan(got[[0, 2, 4, 5, 7]]).any()
    assert not got[4, :3].any()
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=TOL, atol=TOL)


def test_nan_inputs_match_jax():
    """A NaN makes its row NaN on both sides: among finite values, inside
    a run of -inf, and in a row that is otherwise all -inf."""
    x = _x(4, 40, seed=8)
    x[0, 7] = np.nan
    x[1, :20] = -np.inf
    x[1, 0] = np.nan
    x[2] = -np.inf
    x[2, 39] = np.nan
    jx, tx = _both(x, "float32")
    want = np.asarray(ref.softmax(jx))
    got = port.softmax(tx).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[:3]).all() and not np.isnan(got[3]).any()


def test_factory_matches_jax():
    M, N = 48, 64
    x = _x(M, N, seed=8)
    want = np.asarray(ref.softmax_kernel(M, N, 16, "float32")(
        jnp.asarray(x)))
    fn = port.softmax_kernel(M, N, 16, "float32")
    np.testing.assert_allclose(fn(torch.from_numpy(x)).numpy(), want,
                               rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="bound to"):
        fn(torch.zeros((M, N + 1)))


def test_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="2-D"):
        port.softmax(torch.zeros(4))
    with pytest.raises(TypeError):
        port.softmax(torch.zeros((2, 3), dtype=torch.float64))
    with pytest.raises(TypeError):
        port.softmax(torch.zeros((2, 3)), out_dtype="int8")


@pytest.mark.parametrize("N,dtype,kernel,param", [
    (1, "float32", "softmax_rows", 1),
    (8, "float32", "softmax_rows", 2),        # Mixtral's router width
    (1024, "float32", "softmax_rows", 32),
    (1025, "float32", "softmax_block_rows", 0),
    (49152, "float32", "softmax_block_rows", 0),   # the stash holds it
    (60001, "float32", "softmax_block_rows", 0),   # rows off 16 bytes
    (201088, "float32", "softmax_cluster", 8),     # gpt-oss's vocabulary
    (201088, "bfloat16", "softmax_cluster", 4)])
def test_path_rule(N, dtype, kernel, param):
    """softmax_path: the register kernel up to 1024, the block kernel to
    the stash's 48K, then the least cluster whose slices fit 112 KB (two
    CTAs an SM) where rows sit on 16 bytes; the path code and C are what
    tl_softmax takes."""
    path = port.softmax_path(N, dtype)
    assert (path.kernel, path.param) == (kernel, param)
    assert port.KERNELS[path.code] == kernel
    if kernel == "softmax_cluster":
        esize = 4 if dtype == "float32" else 2
        slice_ = port.cluster_slice(N, param, esize)
        assert 0 < slice_ * esize <= port.SLICE_MAX
        assert (slice_ * esize) % 16 == 0 and (param - 1) * slice_ < N
        assert not port.cluster_slice(N, param // 2, esize)
        # a base off 16 bytes keeps the block kernel
        assert port.softmax_path(N, dtype, aligned=False).kernel == \
            "softmax_block_rows"


def _source_const(name):
    """The value of ``constexpr int name`` in csrc/softmax.cu."""
    src = (Path(port.__file__).parents[1] / "csrc" / "softmax.cu").read_text()
    m = re.search(rf"constexpr int {name} = ([0-9 *]+);", src)
    assert m, name
    return math.prod(int(f) for f in m.group(1).split("*"))


def test_path_rule_matches_the_source():
    """softmax_path's bounds are the C entry's: the widest register row,
    the stash, a cluster CTA's slice and the cluster sizes it takes (else
    the rule picks what tl_softmax refuses)."""
    assert port.ROWS_MAX == _source_const("kRowsMax")
    assert port.STASH_MAX == _source_const("kStashMax")
    assert port.SLICE_MAX == _source_const("kSliceMax")
    src = (Path(port.__file__).parents[1] / "csrc" / "softmax.cu").read_text()
    sizes = re.search(r"if \(\(C != (\d+) && C != (\d+) && C != (\d+)\)",
                      src)
    assert sizes and tuple(map(int, sizes.groups())) == port.CLUSTER_SIZES
    assert "(long long)slice * sizeof(TI) > kSliceMax || (C - 1) * slice " \
           ">= N" in src
