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
from tilelang_mesh_tpu_torch.carver import H100_SXM, KERNEL_BLOCKS
from tilelang_mesh_tpu_torch.carver import MatmulTemplate
from tilelang_mesh_tpu_torch.ops import grouped_gemm as port
from tilelang_mesh_tpu_torch.parallel.moe import _pick_block

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
                                           ((1280, 977, 0, 3), 128),
                                           (SIZES, 256),
                                           ((1280, 977, 0, 3), 256)])
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


@pytest.mark.parametrize("sizes,block_M", [(SIZES, 128), (SIZES, 256),
                                           ((0, 300, 0, 77, 0), 128),
                                           ((0, 0), 256)])
def test_varlen_tables_walk_the_meta_blocks(sizes, block_M):
    """The new kernels' tables: blk_row as _varlen_meta's, expert e's
    blocks first[e] .. first[e + 1] - 1 (all of them e's), group ends."""
    exp_blk, row_blk, _ = port._varlen_meta(sizes, block_M)
    tables, TB = port._varlen_tables(sizes, block_M)
    E = len(sizes)
    assert tables.dtype == np.int32 and TB == len(exp_blk)
    assert len(tables) == TB + 2 * E + 1
    np.testing.assert_array_equal(tables[:TB], row_blk)
    first, ends = tables[TB:TB + E + 1], tables[TB + E + 1:]
    np.testing.assert_array_equal(ends, np.cumsum(sizes))
    assert first[0] == 0 and first[-1] == TB
    for e in range(E):
        assert (exp_blk[first[e]:first[e + 1]] == e).all()
        assert first[e + 1] - first[e] == -(-sizes[e] // block_M)


# (dtype, M, N, K, a_ptr, b_ptr, trans_b) -> the kernel the rule names
@pytest.mark.parametrize("case,path", [
    ((torch.bfloat16, 1280, 14336, 4096, 0, 256, False), "tma"),
    ((torch.float16, 77, 264, 1000, 16, 32, False), "tma"),
    ((torch.float32, 1280, 4096, 14336, 0, 0, False), "tf32x3"),
    ((torch.float32, 77, 264, 1000, 0, 0, True), "tf32x3"),
    # trans_b takes B's row stride from K, not N
    ((torch.bfloat16, 5, 7, 64, 0, 0, True), "tma"),
    ((torch.bfloat16, 5, 7, 64, 0, 0, False), "loop"),
    ((torch.float32, 5, 150, 64, 0, 0, False), "loop"),
    ((torch.float32, 5, 152, 64, 0, 0, False), "tf32x3"),
    # K off 16 bytes, a base off 16 bytes
    ((torch.bfloat16, 128, 128, 1001, 0, 0, False), "loop"),
    ((torch.float32, 128, 128, 1002, 0, 0, True), "loop"),
    ((torch.bfloat16, 128, 128, 256, 2, 0, False), "loop"),
    ((torch.float32, 128, 128, 256, 0, 8, False), "loop"),
    # an empty dimension
    ((torch.bfloat16, 0, 128, 256, 0, 0, False), "loop"),
    ((torch.float32, 128, 128, 0, 0, 0, False), "loop"),
    # types no fast kernel takes
    ((torch.float64, 128, 128, 256, 0, 0, False), "loop"),
    (("bfloat16", 128, 128, 256, 0, 0, False), "tma"),
])
def test_grouped_path_rule(case, path):
    dtype, M, N, K, a_ptr, b_ptr, trans_b = case
    assert port.grouped_path(dtype, M, N, K, a_ptr, b_ptr, trans_b) == path


def test_grouped_block_for_the_moe_and_bench_hints():
    """The MoE layer's hints (parallel/moe.py: _pick_block(M, 128),
    _pick_block(N, 128), _pick_block(K, 512)) are no instance at
    Mixtral's expert widths: both products take the carver's first
    instance. moe_grouped's candidates (the carver's hints and the
    Hopper set) each reach the kernel as they are."""
    for M, N, K in ((1280, 14336, 4096), (1280, 4096, 14336)):
        hints = (_pick_block(M, 128), _pick_block(N, 128),
                 _pick_block(K, 512))
        assert hints == (128, 128, 512) and hints not in KERNEL_BLOCKS
        first = next(b for b in ((h.config["block_M"], h.config["block_N"],
                                  h.config["block_K"]) for h in
                                 MatmulTemplate(M, N, K, "bfloat16",
                                                arch=H100_SXM).hints(20))
                     if b in KERNEL_BLOCKS)
        got = port.grouped_block("tma", M, N, K, torch.bfloat16, *hints,
                                 arch=H100_SXM)
        assert got == first == (128, 256, 64)
        assert port.grouped_block("tf32x3", M, N, K, torch.float32,
                                  *hints) == port.TF32X3_BLOCK
    M = N = K = 2048
    cands = [(h.config["block_M"], h.config["block_N"], h.config["block_K"])
             for h in MatmulTemplate(512, N, K, "bfloat16",
                                     arch=H100_SXM).hints(3)]
    for blk in cands + sorted(KERNEL_BLOCKS):
        assert blk in KERNEL_BLOCKS
        assert port.grouped_block("tma", 512, N, K, torch.bfloat16, *blk,
                                  arch=H100_SXM) == blk
    assert port.grouped_block("loop", 77, 150, 1000, torch.float32) == (
        128, 128, 16)


def _split_tf32(x):
    """The 3xTF32 kernel's split of float32 x (csrc/grouped_gemm.cu
    x3::split), emulated on the bits: (big, small) with big = x cut to
    TF32 (10 mantissa bits, its low 13 bits cleared) and its magnitude
    clamped to TF32's largest, and small = x - big rounded to TF32 (to
    nearest, ties away from zero, as cvt.rna.tf32.f32); big + small is x
    to about 2**-21 relative, and an infinite x splits as (+-TF32 max,
    x)."""
    def bits(v):                     # unsigned 32-bit patterns, in int64
        return v.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF

    def f32(b):
        return (b - ((b & 0x80000000) << 1)).to(torch.int32).view(
            torch.float32)

    x = x.float()
    b = bits(x)
    big = f32(torch.clamp(b & 0x7FFFE000, max=0x7F7FE000)
              | (b & 0x80000000))
    d = bits(x - big)
    small = f32((((d & 0x7FFFFFFF) + 0x1000) & ~0x1FFF) | (d & 0x80000000))
    return big, small


def _three(a, b):
    """big_a big_b + big_a small_b + small_a big_b, summed in float32"""
    ab, as_ = _split_tf32(a)
    bb, bs = _split_tf32(b)
    return ab @ bb + ab @ bs + as_ @ bb


@pytest.mark.parametrize("K", [4096, 14336])
def test_split_tf32_holds_float32(K):
    """The 3xTF32 split (an emulation of the kernel's): big + small is x
    to 2**-21 relative, and big_a big_b + big_a small_b + small_a
    big_b summed in float32 stays within 1e-6 of max |C| from float64 at
    (256, K) @ (K, 256), as a float32 product does; one TF32 pass misses
    the grouped GEMM's 1e-5 gate."""
    rng = np.random.default_rng(K)
    a = torch.from_numpy(_rand(rng, (256, K)))
    b = torch.from_numpy(_rand(rng, (K, 256)))
    ab, as_ = _split_tf32(a)
    bb, bs = _split_tf32(b)
    for big, small, x in ((ab, as_, a), (bb, bs, b)):
        for t in (big, small):       # 10 mantissa bits: the low 13 clear
            assert not (t.view(torch.int32) & 0x1FFF).any()
        assert float(((big + small) - x).abs().max()) <= \
            2.0 ** -21 * float(x.abs().max())
    exact = a.double() @ b.double()
    scale = float(exact.abs().max())
    three = ab @ bb + ab @ bs + as_ @ bb
    assert float((three.double() - exact).abs().max()) / scale <= 1e-6
    assert float((three - a @ b).abs().max()) / float(
        (a @ b).abs().max()) <= 1e-5
    one = ab @ bb
    assert float((one.double() - exact).abs().max()) / scale > 1e-5


def test_split_tf32_keeps_infinities():
    """Infinite operands through the split's three products: inf and NaN
    where the float32 product has them, with its signs (every product of
    the sign of a b, or zero); a finite
    operand past TF32's largest (FLT_MAX, whose big part would round to
    inf) gives its row's finite entries within 1e-5 of that row; the rest
    within 1e-5 normwise."""
    rng = np.random.default_rng(7)
    a = torch.from_numpy(_rand(rng, (64, 96)))
    b = torch.from_numpy(_rand(rng, (96, 80)))
    a[5, 17] = float("inf")
    a[9, 30] = float("-inf")
    b[30, 40] = float("-inf")         # meets a[9, 30]: +inf at (9, 40)
    b[60, 7] = float("inf")
    a[20, 3] = torch.finfo(torch.float32).max
    b[3] *= 0.25                      # row 20 stays inside float32
    big, _ = _split_tf32(a[20, 3:4])
    assert torch.isfinite(big).all()
    got, want = _three(a, b), a @ b
    nan = torch.isnan(want)
    assert nan.any() and torch.equal(torch.isnan(got), nan)
    inf = torch.isinf(want)
    assert inf.any() and torch.equal(torch.isinf(got), inf)
    assert torch.equal(got[inf], want[inf])
    assert float(want[9, 40]) == float("inf")
    fin = torch.isfinite(want)
    row = fin[20].clone()
    assert float(want[20][row].abs().max()) > 1e37
    assert _normwise(got[20][row], want[20][row]) <= 1e-5
    fin[20] = False
    assert _normwise(got[fin], want[fin]) <= 1e-5
