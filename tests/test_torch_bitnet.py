"""The port's BitNet path (tilelang_mesh_tpu_torch/ops/bitnet.py,
ops/quantize_act.py, models/bitnet.py) against the JAX package's on the
same numpy-seeded inputs.

The JAX kernels run in Pallas interpret mode on the CPU, as
tests/test_bitnet.py and tests/test_numerics.py run them; the port's run
on CPU tensors, i.e. the kernels' plain versions. Tolerances: the int8 x
ternary GEMM gives the same int32 (exact sums on both sides); the int8
activation quantiser the same bytes (Q and S); ``bitnet_linear`` rtol =
atol = 1e-5 and the BitFFN block rtol = atol = 1e-4, the JAX package's
own bounds (tests/test_bitnet.py:41, example_bitnet.py:61). The CUDA
kernels are held against the plain versions on the card by
tests/test_torch_cuda.py.
"""

import pathlib
import runpy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tilelang_mesh_tpu.ops import bitnet as ref
from tilelang_mesh_tpu.quantize import quantization as ref_q
from tilelang_mesh_tpu_torch.models import bitnet as port_model
from tilelang_mesh_tpu_torch.ops import bitnet as port
from tilelang_mesh_tpu_torch.ops import quantize_act as port_qa
from tilelang_mesh_tpu_torch.quantize import quantization as port_q

EXAMPLE = (pathlib.Path(__file__).resolve().parents[1] / "examples"
           / "bitnet-1.58b" / "example_bitnet.py")


def _operands(seed, M, N, K):
    rng = np.random.default_rng(seed)
    w = rng.integers(-1, 2, (K, N)).astype(np.int8)
    a = rng.integers(-128, 128, (M, K)).astype(np.int8)
    return a, w


# tests/test_bitnet.py:23's three shapes, then ragged M (100, 200) and N
# (200), and a 16-row step; every K a multiple of the JAX kernel's
# 256-deep K tile
@pytest.mark.parametrize("M,N,K", [(1, 128, 256), (64, 128, 256),
                                   (128, 256, 512), (100, 128, 512),
                                   (200, 256, 512), (64, 200, 256),
                                   (16, 256, 512)])
def test_bitnet_gemm_matches_jax(M, N, K):
    a, w = _operands(1, M, N, K)
    packed = port.pack_ternary(w)
    want = np.asarray(ref.bitnet_gemm_kernel(M, N, K)(a, packed))
    got = port.bitnet_gemm_kernel(M, N, K)(torch.from_numpy(a), packed)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        want, a.astype(np.int64) @ w.astype(np.int64))


# K no multiple of 256: the JAX kernel's product is wrong there (up to
# 8192 off at these shapes; ROADMAP "Not port faults"), so the port is
# held against the exact numpy int64 product only
@pytest.mark.parametrize("M,N,K", [(64, 128, 384), (128, 128, 640),
                                   (3, 5, 4), (7, 33, 100)])
def test_bitnet_gemm_ragged_k_is_exact(M, N, K):
    a, w = _operands(3, M, N, K)
    got = port.bitnet_gemm(torch.from_numpy(a), port.pack_ternary(w))
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int64) @ w.astype(np.int64))


def test_bitnet_gemm_plain_unpacks_as_the_host():
    rng = np.random.default_rng(4)
    w = rng.integers(-1, 2, (64, 9)).astype(np.int8)
    packed = torch.from_numpy(port.pack_ternary(w))
    np.testing.assert_array_equal(port._unpack(packed).numpy(), w)
    np.testing.assert_array_equal(port._unpack(packed).numpy(),
                                  ref.unpack_ternary(packed.numpy()))


def test_bitnet_gemm_refusals():
    a = torch.zeros((4, 8), dtype=torch.int8)
    packed = torch.zeros((2, 3), dtype=torch.int8)
    with pytest.raises(ValueError, match="multiple of 4"):
        port.bitnet_gemm(torch.zeros((4, 6), dtype=torch.int8), packed)
    with pytest.raises(ValueError, match="multiple of 4"):
        port.bitnet_gemm_kernel(4, 3, 6)
    with pytest.raises(TypeError, match="int8"):
        port.bitnet_gemm(a.float(), packed)
    with pytest.raises(ValueError, match="packed"):
        port.bitnet_gemm(a, torch.zeros((3, 3), dtype=torch.int8))
    with pytest.raises(ValueError, match="packed"):
        port.bitnet_gemm(a, torch.zeros((2, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="bound"):
        port.bitnet_gemm_kernel(4, 3, 8)(a, torch.zeros((2, 4),
                                                        dtype=torch.int8))


# ---------------------------------------------------------------------------
# the path rule and the split-K plan (host code; the kernels run on the card)
# ---------------------------------------------------------------------------

T = port.SPLITK_MAX_ROWS


# (M, N, K, A's base, the packed base) -> the kernel: BitFFN b1.58-2B-4T's
# decode and prefill products, the threshold and its neighbours, ragged N
# and K, misaligned bases
@pytest.mark.parametrize("M,N,K,a_ptr,p_ptr,path", [
    (1, 6912, 2560, 0, 0, "splitk"),       # decode gate / up
    (1, 2560, 6912, 0, 0, "splitk"),       # decode down
    (4096, 6912, 2560, 0, 0, "wgmma"),     # prefill gate / up
    (4096, 2560, 6912, 0, 0, "wgmma"),     # prefill down
    (T - 1, 6912, 2560, 0, 0, "splitk"),
    (T, 6912, 2560, 0, 0, "splitk"),
    (T + 1, 6912, 2560, 0, 0, "wgmma"),
    (16, 6912, 2560, 0, 0, "wgmma"),
    (17, 6912, 2560, 0, 0, "wgmma"),
    (1, 16, 4, 0, 0, "splitk"),            # one packed row
    (1, 6912, 20, 0, 0, "splitk"),         # K off 16: split-K reads words
    (128, 6912, 20, 0, 0, "loop"),         # ... TMA's strides need 16 B
    (1, 150, 1000, 0, 0, "loop"),          # N off 16
    (4096, 6920, 2560, 0, 0, "loop"),
    (1, 6912, 2560, 4, 0, "splitk"),       # A on 4 bytes is enough
    (1, 6912, 2560, 2, 0, "loop"),
    (1, 6912, 2560, 0, 8, "loop"),
    (4096, 6912, 2560, 4, 0, "loop"),
    (4096, 6912, 2560, 0, 8, "loop"),
    (0, 6912, 2560, 0, 0, "loop"),
])
def test_bitnet_path_rule(M, N, K, a_ptr, p_ptr, path):
    assert port.bitnet_path(M, N, K, a_ptr, p_ptr) == path


@pytest.mark.parametrize("N,K,sms,want", [
    (6912, 2560, 132, (14, 10, 64)),       # decode gate / up: 140 blocks
    (2560, 6912, 132, (5, 27, 64)),        # decode down: 135 blocks
    (16, 4, 132, (1, 1, 64)),
    (6912, 16384, 132, (14, 10, 448)),     # a long K: fewer, deeper blocks
    (6912, 2564, 132, (14, 6, 128)),       # K/4 off the split
    (6912, 2560, 1, (14, 1, 640)),
])
def test_bitnet_splitk_plan(N, K, sms, want):
    assert port.bitnet_splitk_plan(N, K, sms) == want


@pytest.mark.parametrize("N", [16, 512, 513, 2560, 6912, 6928])
@pytest.mark.parametrize("K", [4, 256, 2560, 2564, 6912, 20000])
@pytest.mark.parametrize("sms", [1, 66, 132])
def test_bitnet_splitk_plan_covers_k_once(N, K, sms):
    """Every packed row in exactly one split, every column in one strip;
    a block's rows a multiple of 64 (8 warps of 8-row loads)."""
    strips, splits, rows = port.bitnet_splitk_plan(N, K, sms)
    G = K // 4
    assert rows % 64 == 0 and rows >= 64
    assert (splits - 1) * rows < G <= splits * rows
    assert (strips - 1) * 512 < N <= strips * 512
    assert splits <= 65535


@pytest.mark.parametrize("shape,w_scale", [((2, 8, 256), 3.0),
                                           ((5, 128), 0.7)])
def test_bitnet_linear_matches_jax(shape, w_scale):
    """tests/test_bitnet.py:33's case, and a 2-D one."""
    rng = np.random.default_rng(2)
    K, N = shape[-1], 128
    w = rng.integers(-1, 2, (K, N)).astype(np.int8)
    x = rng.standard_normal(shape).astype(np.float32)
    want = np.asarray(ref.bitnet_linear(x, ref.pack_ternary(w), w_scale))
    got = port.bitnet_linear(torch.from_numpy(x), port.pack_ternary(w),
                             w_scale)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    emul = port.bitnet_linear_reference(torch.from_numpy(x),
                                        torch.from_numpy(w), w_scale)
    np.testing.assert_allclose(
        emul.numpy(), np.asarray(ref.bitnet_linear_reference(x, w, w_scale)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.numpy(), emul.numpy())


@pytest.fixture(scope="module")
def jax_ffn():
    """The JAX example's BitFFN at its own size and input."""
    mod = runpy.run_path(str(EXAMPLE))
    ffn = mod["BitFFN"](512, 1024)
    x = np.random.default_rng(1).standard_normal((4, 32, 512),
                                                 dtype=np.float32)
    return mod, ffn, x


@pytest.mark.parametrize("reference", [False, True])
def test_bitffn_matches_jax(jax_ffn, reference):
    _, ffn, x = jax_ffn
    want = np.asarray(ffn(jnp.asarray(x), reference=reference))
    mine = port_model.bitffn_from_jax(ffn.packed, ffn.scales, ffn.ternary,
                                      device="cpu")
    port.reset_launches()
    got = mine(torch.from_numpy(x), reference=reference)
    assert not any(port.launches.values())      # CPU: the plain versions
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_bitffn_draws_the_examples_weights(jax_ffn):
    mod, ffn, _ = jax_ffn
    mine = port_model.BitFFN(512, 1024, seed=0, device="cpu")
    for name in ("gate", "up", "down"):
        np.testing.assert_array_equal(
            getattr(mine, f"packed_{name}").numpy(), ffn.packed[name])
        np.testing.assert_array_equal(
            getattr(mine, f"ternary_{name}").numpy(), ffn.ternary[name])
        assert mine.scales[name] == float(ffn.scales[name])
    w = np.random.default_rng(5).standard_normal((64, 32)).astype(np.float32)
    for got, want in zip(port_model.weight_quant_ternary(w),
                         mod["weight_quant_ternary"](w)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="do not fit"):
        port_model.bitffn_from_jax(
            ffn.packed, ffn.scales,
            {**ffn.ternary, "up": ffn.ternary["up"][:, :-4]}, device="cpu")


def test_bitffn_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_model.BitFFN(8, 16)


def _x(seed, M, K, scale=3.0, zero_rows=()):
    x = np.random.default_rng(seed).standard_normal((M, K)).astype(
        np.float32) * scale
    x[list(zero_rows)] = 0.0
    return x


@pytest.mark.parametrize("M,K,block_M,zero_rows", [
    (64, 128, 32, ()),              # tests/test_numerics.py:434's case
    (50, 256, 128, ()),             # M under one TPU block
    (64, 128, 32, (0, 17, 63)),     # all-zero rows among others
])
def test_quantize_act_int8_matches_jax_bytes(M, K, block_M, zero_rows):
    x = _x(0, M, K, zero_rows=zero_rows)
    q, s = (np.asarray(t) for t in
            ref_q.quantize_act_int8_kernel(M, K, block_M=block_M)(x))
    tq, ts = port_q.quantize_act_int8_kernel(M, K, block_M=block_M)(
        torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert ts.shape == (M, 1) and tq.shape == (M, K)
    np.testing.assert_array_equal(tq.numpy(), q)
    np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                  s.view(np.uint32))
    for r in zero_rows:
        assert np.isfinite(ts[r].item()) and not tq[r].any()


def test_quantize_act_int8_all_zero():
    q, s = port_qa.quantize_act_int8(torch.zeros((5, 7)))
    assert torch.isfinite(s).all() and not q.any()
    rq, rs = ref_q.quantize_act_int8_kernel(64, 128)(
        np.zeros((64, 128), np.float32))
    np.testing.assert_array_equal(np.asarray(rs)[:5], s.numpy())


def test_quantize_act_int8_host_reference_differs_by_an_ulp_at_most():
    """The port's copy of the host reference (``absmax / 127``) stays as
    the JAX one is: S within one ulp of the kernel's, Q equal."""
    x = _x(0, 64, 256)
    rq, rs = port_q.quantize_act_int8_ref(x)
    jq, js = ref_q.quantize_act_int8_ref(x)
    np.testing.assert_array_equal(rq, jq)
    np.testing.assert_array_equal(rs, js)
    tq, ts = port_qa.quantize_act_int8(torch.from_numpy(x))
    ulps = np.abs(ts.numpy().view(np.int32) - rs.view(np.int32))
    assert ulps.max() <= 1
    np.testing.assert_array_equal(tq.numpy(), rq)


def test_quantize_act_int8_refusals():
    with pytest.raises(TypeError):
        port_qa.quantize_act_int8(torch.zeros((2, 3), dtype=torch.float64))
    with pytest.raises(TypeError):
        port_qa.quantize_act_int8(torch.zeros(3))
    with pytest.raises(ValueError):
        port_qa.quantize_act_int8(torch.zeros((2, 0)))
    with pytest.raises(ValueError, match="bound"):
        port_q.quantize_act_int8_kernel(4, 8)(torch.zeros((4, 9)))
