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
