"""The port's GEMM (tilelang_mesh_tpu_torch/ops/gemm.py) against the JAX
package's (ops/gemm.py) on the same numpy-seeded inputs.

The JAX kernel runs in Pallas interpret mode on the CPU, as
tests/test_kernel_gemm.py and tests/test_quantize.py run it; the port's
runs on CPU tensors, i.e. the kernel's plain version. Tolerances are the
JAX package's own tests': rtol = atol = 2e-2 for float32
(tests/test_kernel_gemm.py:65), rtol 5e-2 / atol 5e-1 for bfloat16 with
float32 accumulation (:79) and for fp8 e4m3 -> float32
(tests/test_quantize.py:61). The plain version is held against float64
numpy at 1e-5 normwise (max |port - numpy| over max |numpy|): float32
sums of 256 products carry ~1e-7 relative error. The JAX kernel gives NaN
when K is not a multiple of its tile (see ROADMAP Queue 3), so ragged
shapes are held against numpy only. The CUDA kernel is held against the
plain version on the card by tests/test_torch_cuda.py.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tilelang_mesh_tpu.ops import gemm as ref
from tilelang_mesh_tpu_torch.ops import gemm as port

TRANS = [(False, False), (False, True), (True, False), (True, True)]


def _normwise(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _operands(rng, M, N, K, trans_A, trans_B, scale=1.0):
    a = rng.standard_normal((K, M) if trans_A else (M, K)) * scale
    b = rng.standard_normal((N, K) if trans_B else (K, N)) * scale
    return a.astype(np.float32), b.astype(np.float32)


def _fp8(x):
    """x as float8 e4m3 bytes: the same values for JAX (ml_dtypes) and
    torch (a uint8 view)."""
    q = x.astype(ml_dtypes.float8_e4m3fn)
    return q, torch.from_numpy(q.view(np.uint8)).view(torch.float8_e4m3fn)


@pytest.mark.parametrize("trans_A,trans_B", TRANS)
def test_matmul_transposes_match_jax(trans_A, trans_B):
    rng = np.random.default_rng(0)
    a, b = _operands(rng, 256, 256, 256, trans_A, trans_B)
    want = np.asarray(ref.matmul(jnp.asarray(a), jnp.asarray(b),
                                 trans_A=trans_A, trans_B=trans_B))
    before = dict(port.launches)
    got = port.matmul(torch.from_numpy(a), torch.from_numpy(b),
                      trans_A=trans_A, trans_B=trans_B)
    assert got.dtype == torch.float32 and tuple(got.shape) == (256, 256)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2)
    assert port.launches == before          # CPU tensors launch nothing


def test_matmul_bf16_accum_f32_matches_jax():
    rng = np.random.default_rng(1)
    a, b = _operands(rng, 256, 256, 256, False, False)
    ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    want = np.asarray(ref.matmul_kernel(256, 256, 256, 128, 128, 128,
                                        in_dtype="bfloat16")(ja, jb),
                      np.float32)
    ta = torch.from_numpy(np.asarray(ja, np.float32)).bfloat16()
    tb = torch.from_numpy(np.asarray(jb, np.float32)).bfloat16()
    got = port.matmul(ta, tb)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=5e-2,
                               atol=5e-1)
    f32 = port.matmul(ta, tb, out_dtype="float32")
    assert f32.dtype == torch.float32
    np.testing.assert_allclose(f32.numpy(), want, rtol=5e-2, atol=5e-1)


def test_matmul_fp8_to_f32_matches_jax():
    rng = np.random.default_rng(3)
    a8, ta = _fp8(rng.standard_normal((256, 256)) * 0.3)
    b8, tb = _fp8(rng.standard_normal((256, 256)) * 0.3)
    want = np.asarray(ref.matmul_kernel(
        256, 256, 256, 128, 128, 128, in_dtype="float8_e4m3fn",
        out_dtype="float32")(jnp.asarray(a8), jnp.asarray(b8)))
    got = port.matmul(ta, tb, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-2, atol=5e-1)
    # the default output is the inputs' type, as in the JAX package
    got8 = port.matmul(ta, tb)
    jax8 = ref.matmul(jnp.asarray(a8), jnp.asarray(b8))
    assert got8.dtype == torch.float8_e4m3fn and str(jax8.dtype) == \
        "float8_e4m3fn"
    assert torch.equal(got8.view(torch.uint8),
                       got.to(torch.float8_e4m3fn).view(torch.uint8))


def test_matmul_fp8_overflow_gives_jax_nan_bytes():
    """An fp8 e4m3 output past the format's range is NaN, as the JAX
    package's cast gives it (torch's own cast saturates to +-448): on
    4-scaled operands, 186 of 16,384 sums round past 448 (|c| > 464);
    the port's bytes equal JAX's bit for bit, NaN signs included."""
    rng = np.random.default_rng(0)
    a = (4 * rng.standard_normal((128, 128))).astype(np.float32)
    b = (4 * rng.standard_normal((128, 128))).astype(np.float32)
    ja, jb = jnp.asarray(a).astype(jnp.float8_e4m3fn), \
        jnp.asarray(b).astype(jnp.float8_e4m3fn)
    want = np.asarray(ref.matmul(ja, jb)).view(np.uint8)
    to8 = lambda x: torch.from_numpy(np.asarray(x).view(np.uint8).copy()) \
        .view(torch.float8_e4m3fn)
    got = port.matmul(to8(ja), to8(jb))
    assert got.dtype == torch.float8_e4m3fn
    got_bytes = got.view(torch.uint8).numpy()
    nan = (want & 0x7F) == 0x7F
    assert int(nan.sum()) == 186
    np.testing.assert_array_equal(got_bytes, want)


@pytest.mark.parametrize("out_dtype", [None, "bfloat16"])
def test_matmul_relu_matches_jax(out_dtype):
    rng = np.random.default_rng(4)
    a, b = _operands(rng, 256, 256, 256, False, True)
    want = np.asarray(ref.matmul(jnp.asarray(a), jnp.asarray(b),
                                 trans_B=True, out_dtype=out_dtype,
                                 relu=True), np.float32)
    got = port.matmul(torch.from_numpy(a), torch.from_numpy(b),
                      trans_B=True, out_dtype=out_dtype, relu=True)
    assert got.dtype == (torch.bfloat16 if out_dtype else torch.float32)
    assert float(got.float().min()) == 0.0
    tol = 5e-2 if out_dtype else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("in_dtype,out_dtype", [
    (torch.float64, None), (torch.int8, None), (torch.int8, torch.int32),
    (torch.float32, torch.int32), (torch.float16, torch.int8),
    (torch.bfloat16, torch.float64)])
def test_matmul_unported_types_raise(in_dtype, out_dtype):
    """float64; int8 with its default float32 accumulator; an integer or
    float64 output from float inputs."""
    a = torch.zeros((4, 8)).to(in_dtype)
    b = torch.zeros((8, 3)).to(in_dtype)
    with pytest.raises(TypeError):
        port.matmul(a, b, out_dtype=out_dtype)
    with pytest.raises(TypeError):
        port.matmul_kernel(4, 3, 8, in_dtype=str(in_dtype).split(".")[1],
                           out_dtype=out_dtype)


@pytest.mark.parametrize("in_dtype,out_dtype,accum_dtype", [
    ("float32", None, "float16"), ("bfloat16", None, "bfloat16"),
    ("float16", "float16", "float16"), ("float32", None, "int32"),
    ("int8", "int8", "int32"), ("int8", "float32", "int32"),
    ("int8", "int32", "float32")])
def test_matmul_kernel_unported_accumulators_raise(in_dtype, out_dtype,
                                                   accum_dtype):
    """A float accumulator other than float32 (the JAX package rounds it
    after each of its carver's K tiles); int8 with anything but an int32
    accumulator into an int32 output."""
    with pytest.raises(TypeError):
        port.matmul_kernel(4, 3, 8, in_dtype=in_dtype, out_dtype=out_dtype,
                           accum_dtype=accum_dtype)


@pytest.mark.parametrize("trans_A,trans_B", TRANS)
def test_matmul_float16_matches_jax(trans_A, trans_B):
    """float16 in and out, as bf16 is held (rtol = atol = 2e-2)."""
    rng = np.random.default_rng(7)
    a, b = _operands(rng, 128, 256, 256, trans_A, trans_B)
    ja, jb = jnp.asarray(a, jnp.float16), jnp.asarray(b, jnp.float16)
    want = ref.matmul(ja, jb, trans_A=trans_A, trans_B=trans_B)
    assert str(want.dtype) == "float16"
    got = port.matmul(torch.from_numpy(a).half(), torch.from_numpy(b).half(),
                      trans_A=trans_A, trans_B=trans_B)
    assert got.dtype == torch.float16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16",
                                      "float8_e4m3fn"])
def test_matmul_float16_output_matches_jax(in_dtype):
    """Any float input type may ask for a float16 output."""
    rng = np.random.default_rng(8)
    a8, ta = _fp8(rng.standard_normal((128, 256)) * 0.3)
    b8, tb = _fp8(rng.standard_normal((256, 128)) * 0.3)
    ja, jb = jnp.asarray(a8).astype(in_dtype), jnp.asarray(b8).astype(
        in_dtype)
    want = ref.matmul_kernel(128, 128, 256, 128, 128, 128, in_dtype=in_dtype,
                             out_dtype="float16")(ja, jb)
    dt = getattr(torch, in_dtype)
    got = port.matmul_kernel(128, 128, 256, in_dtype=in_dtype,
                             out_dtype="float16")(ta.to(dt), tb.to(dt))
    assert got.dtype == torch.float16 and str(want.dtype) == "float16"
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16", "float16"])
def test_matmul_fp8_output_gives_jax_bytes(in_dtype):
    """A float8 e4m3 output from float32, bfloat16 or float16 inputs,
    byte-equal to JAX's, NaNs included: integer operands in [-8, 8] make
    every product and sum exact in float32 in any order, so both round the
    same sums (many past +-464: NaN)."""
    rng = np.random.default_rng(9)
    a = rng.integers(-8, 9, (128, 128)).astype(np.float32)
    b = rng.integers(-8, 9, (128, 128)).astype(np.float32)
    want = np.asarray(ref.matmul(jnp.asarray(a, in_dtype),
                                 jnp.asarray(b, in_dtype),
                                 out_dtype="float8_e4m3fn")).view(np.uint8)
    dt = getattr(torch, in_dtype)
    got = port.matmul(torch.from_numpy(a).to(dt), torch.from_numpy(b).to(dt),
                      out_dtype=torch.float8_e4m3fn)
    assert got.dtype == torch.float8_e4m3fn
    nan = (want & 0x7F) == 0x7F
    assert 0 < int(nan.sum()) < nan.size
    np.testing.assert_array_equal(got.view(torch.uint8).numpy(), want)


@pytest.mark.parametrize("trans_A,trans_B", TRANS)
@pytest.mark.parametrize("relu", [False, True])
def test_matmul_int8_int32_equals_jax(trans_A, trans_B, relu):
    """int8 x int8 with accum_dtype and out_dtype int32: the exact
    product, equal to JAX's and to int64 numpy."""
    rng = np.random.default_rng(10)
    M, N, K = 128, 256, 256
    a = rng.integers(-128, 128, (K, M) if trans_A else (M, K)).astype(
        np.int8)
    b = rng.integers(-128, 128, (N, K) if trans_B else (K, N)).astype(
        np.int8)
    kw = dict(in_dtype="int8", out_dtype="int32", accum_dtype="int32",
              trans_A=trans_A, trans_B=trans_B, relu=relu)
    want = np.asarray(ref.matmul_kernel(M, N, K, 128, 128, 128, **kw)(
        jnp.asarray(a), jnp.asarray(b)))
    got = port.matmul_kernel(M, N, K, **kw)(torch.from_numpy(a),
                                            torch.from_numpy(b))
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)
    a64 = (a.T if trans_A else a).astype(np.int64)
    b64 = (b.T if trans_B else b).astype(np.int64)
    exact = a64 @ b64
    np.testing.assert_array_equal(want, np.maximum(exact, 0) if relu
                                  else exact)


def test_matmul_operand_checks():
    with pytest.raises(TypeError):
        port.matmul(torch.zeros((4, 8)), torch.zeros((8, 3)).bfloat16())
    with pytest.raises(ValueError):
        port.matmul(torch.zeros((4, 8)), torch.zeros((7, 3)))
    with pytest.raises(ValueError):
        port.matmul(torch.zeros((4, 8)), torch.zeros((8, 3, 1)))
    k = port.matmul_kernel(4, 3, 8, in_dtype="float32")
    assert tuple(k(torch.ones((4, 8)), torch.ones((8, 3))).shape) == (4, 3)
    with pytest.raises(ValueError):
        k(torch.ones((8, 4)), torch.ones((8, 3)))


@pytest.mark.parametrize("trans_A,trans_B", TRANS)
@pytest.mark.parametrize("shape", [(100, 77, 200), (1, 1, 1),
                                   (130, 257, 129), (256, 128, 384)])
def test_plain_matches_float64(trans_A, trans_B, shape):
    """Any M, N, K (none a multiple of 128 in the first three)."""
    M, N, K = shape
    rng = np.random.default_rng(5)
    a, b = _operands(rng, M, N, K, trans_A, trans_B)
    got = port.matmul(torch.from_numpy(a), torch.from_numpy(b),
                      trans_A=trans_A, trans_B=trans_B, relu=True)
    a64 = a.T.astype(np.float64) if trans_A else a.astype(np.float64)
    b64 = b.T.astype(np.float64) if trans_B else b.astype(np.float64)
    want = np.maximum(a64 @ b64, 0.0)
    if not want.any():                   # all clipped: exact zeros
        assert not got.any()
        return
    assert _normwise(got.numpy(), want) <= 1e-5


def test_plain_fp8_matches_float64():
    """fp8 products are exact in float32; only the sum order differs."""
    rng = np.random.default_rng(6)
    a8, ta = _fp8(rng.standard_normal((130, 200)) * 0.3)
    b8, tb = _fp8(rng.standard_normal((200, 77)) * 0.3)
    got = port.matmul(ta, tb, out_dtype="float32")
    want = a8.astype(np.float64) @ b8.astype(np.float64)
    assert _normwise(got.numpy(), want) <= 1e-5


# ---------------------------------------------------------------------------
# the card's block choice and path rule (host functions)
# ---------------------------------------------------------------------------

# (block_M, block_N, block_K) hints of the JAX factory with M and N off
# every block and K a multiple of block_K (the JAX kernel gives NaN
# otherwise; ragged K is held against numpy above)
HINT_CASES = [((64, 64, 32), (77, 150, 96)), ((128, 128, 64), (200, 136, 192)),
              ((256, 128, 64), (130, 300, 256)),
              ((128, 256, 128), (257, 129, 256))]


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-2)])
@pytest.mark.parametrize("hint,shape", HINT_CASES)
def test_matmul_kernel_block_hints_match_jax(dtype, tol, hint, shape):
    """The JAX factory with block hints (interpret mode) against the
    port's factory with the same hints on CPU tensors: normwise, float32
    1e-5 (float32 sums in another order), bfloat16 out 1e-2 (one bf16
    ulp at a rounding boundary)."""
    M, N, K = shape
    rng = np.random.default_rng(7)
    a, b = _operands(rng, M, N, K, False, False)
    ja, jb = jnp.asarray(a, dtype), jnp.asarray(b, dtype)
    want = np.asarray(ref.matmul_kernel(M, N, K, *hint, in_dtype=dtype)(
        ja, jb), np.float32)
    ta = torch.from_numpy(np.array(ja, np.float32)).to(getattr(torch, dtype))
    tb = torch.from_numpy(np.array(jb, np.float32)).to(getattr(torch, dtype))
    got = port.matmul_kernel(M, N, K, *hint, in_dtype=dtype)(ta, tb)
    assert got.dtype == getattr(torch, dtype)
    assert _normwise(got.float().numpy(), want) <= tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16",
                                   "float8_e4m3fn"])
def test_kernel_block_is_the_carver_s(dtype):
    """No hint: the carver's first hint for the shape (as the JAX factory
    takes it); a hint in KERNEL_BLOCKS: kept; a hint outside: the
    carver's top block; a shape no block divides: DEFAULT_BLOCK."""
    from tilelang_mesh_tpu_torch.carver import (H100_SXM, KERNEL_BLOCKS,
                                                MatmulTemplate)
    for M, N, K in ((8192, 8192, 4096), (1024, 1024, 1024),
                    (512, 11008, 4096)):
        c = MatmulTemplate(M, N, K, dtype, arch=H100_SXM).hints(1)[0].config
        top = (c["block_M"], c["block_N"], c["block_K"])
        assert port.kernel_block(M, N, K, dtype, arch=H100_SXM) == top
        for blk in KERNEL_BLOCKS:
            assert port.kernel_block(M, N, K, dtype, *blk,
                                     arch=H100_SXM) == blk
        for hint in ((64, 64, 32), (256, 256, 64), (128, 128, 128),
                     (128, 128, None)):
            assert port.kernel_block(M, N, K, dtype, *hint,
                                     arch=H100_SXM) == top
    assert port.kernel_block(77, 150, 1000, dtype, arch=H100_SXM) == \
        port.DEFAULT_BLOCK
    assert port.DEFAULT_BLOCK in KERNEL_BLOCKS


# (dtype, (M, N, K), (trans_A, trans_B), (a_ptr, b_ptr), out, block, path)
PATH_CASES = [
    ("bfloat16", (256, 128, 384), (False, False), (0, 0), None, None, "tma"),
    ("bfloat16", (256, 128, 384), (True, True), (0, 256), None, None, "tma"),
    ("float16", (77, 150, 1000), (False, False), (0, 0), None, None, "loop"),
    ("float16", (77, 150, 1000), (False, True), (0, 0), None, None, "tma"),
    ("float16", (256, 128, 384), (False, False), (8, 0), None, None, "loop"),
    ("float16", (256, 128, 384), (False, False), (0, 2), None, None, "loop"),
    ("float8_e4m3fn", (300, 272, 1008), (False, False), (0, 0), "float32",
     None, "tma"),
    ("float8_e4m3fn", (300, 272, 1008), (True, False), (0, 0), "float32",
     None, "loop"),
    ("float8_e4m3fn", (304, 272, 1000), (False, False), (0, 0), "float32",
     None, "loop"),
    ("float8_e4m3fn", (304, 272, 1000), (True, False), (0, 0), None, None,
     "tma"),
    ("float32", (512, 512, 256), (False, False), (0, 0), None,
     (128, 128, 64), "ffma"),
    ("float32", (512, 512, 256), (False, False), (0, 0), None,
     (256, 128, 64), "ffma"),
    ("float32", (384, 512, 256), (False, False), (0, 0), None,
     (256, 128, 64), "loop"),
    ("float32", (512, 512, 256), (False, False), (0, 0), "bfloat16",
     (128, 128, 64), "loop"),
    ("float32", (512, 512, 256), (True, False), (0, 0), None,
     (128, 128, 64), "loop"),
    ("float32", (512, 512, 256), (False, False), (4, 0), None,
     (128, 128, 64), "loop"),
    ("int8", (256, 128, 384), (False, False), (0, 0), "int32", None, "loop"),
    ("bfloat16", (0, 128, 384), (False, False), (0, 0), None, None, "loop"),
]


@pytest.mark.parametrize("case", PATH_CASES, ids=lambda c: "-".join(
    map(str, (c[0],) + c[1] + c[2] + c[3] + (c[4],))))
def test_matmul_path_rule(case):
    """The stated rule that picks gemm.cu's kernel on the card: the TMA
    path for 16-bit and fp8 operands with 16-byte aligned bases and row
    strides, the FFMA tile for untransposed aligned float32 -> float32
    that the block divides, the tile loop for the rest."""
    dtype, (M, N, K), (ta, tb), (pa, pb), out, block, want = case
    kw = {} if block is None else {"block": block}
    assert port.matmul_path(M, N, K, dtype, ta, tb, pa, pb, out,
                            **kw) == want


def test_fp8_widen_plain_matches_numpy():
    """Every e4m3 code widened to float16 as ml_dtypes converts it (exact;
    the two NaN codes NaN), in any shape."""
    codes = np.arange(256, dtype=np.uint8)
    q = codes.view(ml_dtypes.float8_e4m3fn)
    want = q.astype(np.float16)
    x = torch.from_numpy(codes.copy()).view(torch.float8_e4m3fn)
    y = x.reshape(16, 16).t()
    gx, gy = port.fp8_widen(x, y)
    assert gx.dtype == gy.dtype == torch.float16
    for got, w in ((gx.numpy(), want), (gy.numpy(), want.reshape(16, 16).T)):
        assert np.array_equal(np.isnan(got), np.isnan(w))
        assert np.array_equal(np.nan_to_num(got), np.nan_to_num(w))
    assert int(np.isnan(want).sum()) == 2
    with pytest.raises(TypeError):
        port.fp8_widen(x.view(torch.uint8), y)
