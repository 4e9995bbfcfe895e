"""The port's low-bit GEMMs and quantization helpers
(tilelang_mesh_tpu_torch/ops/dequant_gemm.py, ops/bitnet.py, quantize/)
against the JAX package's on the same numpy-seeded inputs.

The JAX kernels run in Pallas interpret mode on the CPU, as
tests/test_quantize.py and tests/test_w4a8.py run them; the port's run on
CPU tensors, i.e. the kernels' plain versions. Tolerances: the host
packers and the int8 activation codes must give the same bytes; the
unpacked weights (dequant_int4) the same values, bit for bit (the same
float32 multiply, then the same rounding); w4a16 rtol 2e-2 / atol 2e-1,
the JAX package's own bound (tests/test_quantize.py:48); w4a8 1e-5
normwise (max |port - ref| over max |ref|), the JAX package's bound
against the exact integer reference (tests/test_w4a8.py:40), held both
against the JAX op and against that reference. The plain w4a16 is held
against float64 numpy at 1e-5 normwise on shapes the JAX kernel does not
take. The CUDA kernels are held against the plain versions on the card
by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tilelang_mesh_tpu.ops import bitnet as ref_bitnet
from tilelang_mesh_tpu.ops import dequant_gemm as ref
from tilelang_mesh_tpu.quantize import quantization as ref_q
from tilelang_mesh_tpu_torch.ops import bitnet as port_bitnet
from tilelang_mesh_tpu_torch.ops import dequant_gemm as port
from tilelang_mesh_tpu_torch.ops import gemm as port_gemm
from tilelang_mesh_tpu_torch.quantize import quantization as port_q

_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _normwise(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _weights(seed, K, N, scale=1.0):
    return (np.random.default_rng(seed).standard_normal((K, N))
            * scale).astype(np.float32)


def _activations(seed, M, K, dtype, zero_rows=()):
    """The same values on both sides: drawn in float32 (``zero_rows``
    set to 0), rounded to ``dtype`` by JAX, copied to torch as float32
    and cast back."""
    jd, td = _DTYPES[dtype]
    x = np.random.default_rng(seed).standard_normal((M, K))
    x[list(zero_rows)] = 0.0
    x = jnp.asarray(x, jd)
    return x, torch.from_numpy(np.array(x, np.float32)).to(td)


# ---------------------------------------------------------------------------
# host helpers: the same bytes
# ---------------------------------------------------------------------------

_Q_CASES = {
    "quantize_int4_groups": lambda m: m.quantize_int4_groups(
        _weights(0, 256, 48), 64),
    "quantize_int4_planar": lambda m: m.quantize_int4_planar(
        _weights(1, 512, 40), 128),
    "dequantize_int4_planar_ref": lambda m: m.dequantize_int4_planar_ref(
        *ref_q.quantize_int4_planar(_weights(2, 256, 24), 64), 64),
    "quantize_act_int8_ref": lambda m: m.quantize_act_int8_ref(
        np.concatenate([_weights(3, 7, 96), np.zeros((1, 96), np.float32)])),
    "pack_int4": lambda m: m.pack_int4(np.random.default_rng(4).integers(
        -8, 8, (64, 32)).astype(np.int8)),
    "unpack_int4_ref": lambda m: m.unpack_int4_ref(np.random.default_rng(
        5).integers(0, 256, (32, 16)).astype(np.uint8)),
    "dequantize_int4_ref": lambda m: m.dequantize_int4_ref(
        *ref_q.quantize_int4_groups(_weights(6, 256, 16), 128), 128),
    "quantize_mxfp4": lambda m: m.quantize_mxfp4(_weights(7, 128, 24), 32),
    "pack_mxfp4": lambda m: m.pack_mxfp4(
        ref_q.quantize_mxfp4(_weights(8, 64, 8))[0]),
    "dequantize_mxfp4_ref": lambda m: m.dequantize_mxfp4_ref(
        ref_q.pack_mxfp4(ref_q.quantize_mxfp4(_weights(9, 64, 8))[0]),
        ref_q.quantize_mxfp4(_weights(9, 64, 8))[1]),
}


@pytest.mark.parametrize("name", sorted(_Q_CASES))
def test_quantization_helpers_match_jax_package(name):
    _same(_Q_CASES[name](port_q), _Q_CASES[name](ref_q))


def test_quantize_package_exports_the_same_names():
    import tilelang_mesh_tpu.quantize as ref_pkg
    import tilelang_mesh_tpu_torch.quantize as port_pkg
    names = [n for n in dir(ref_pkg) if not n.startswith("_")
             and callable(getattr(ref_pkg, n))]
    assert names and all(callable(getattr(port_pkg, n)) for n in names)


_PACK_CASES = {
    "quantize_w4_per_channel": lambda m: m.quantize_w4_per_channel(
        _weights(10, 128, 40, 0.1)),
    "pack_planar": lambda m: m.pack_planar(np.random.default_rng(
        11).integers(-8, 8, (64, 24))),
    "unpack_planar": lambda m: m.unpack_planar(np.random.default_rng(
        12).integers(0, 256, (32, 24)).astype(np.uint8)),
    "pack_reference": lambda m: m.pack_reference(np.random.default_rng(
        13).integers(-8, 8, (64, 24))),
    "repack_from_reference": lambda m: m.repack_from_reference(
        np.random.default_rng(14).integers(0, 256, (32, 24)).astype(
            np.uint8)),
}


@pytest.mark.parametrize("name", sorted(_PACK_CASES))
def test_packers_match_jax_package(name):
    _same(_PACK_CASES[name](port), _PACK_CASES[name](ref))


def test_repack_from_reference_round_trips_every_value():
    """Every int4 value -8..7 in every nibble position survives."""
    rng = np.random.default_rng(15)
    q = rng.integers(-8, 8, size=(64, 48)).astype(np.int32)
    edge = np.repeat(np.tile(np.arange(-8, 8, dtype=np.int32), 2).reshape(
        2, 16), 8, axis=0)
    for w in (q, edge):
        planar = port.repack_from_reference(port.pack_reference(w))
        np.testing.assert_array_equal(planar, port.pack_planar(w))
        np.testing.assert_array_equal(port.unpack_planar(planar), w)


def test_ternary_packers_match_jax_package():
    w = np.random.default_rng(16).integers(-1, 2, (64, 24))
    packed = port_bitnet.pack_ternary(w)
    _same(packed, ref_bitnet.pack_ternary(w))
    _same(port_bitnet.unpack_ternary(packed),
          ref_bitnet.unpack_ternary(packed))
    with pytest.raises(ValueError):
        port_bitnet.pack_ternary(np.full((4, 2), 2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_activations_match_jax(dtype):
    """The same int8 codes, bit for bit; the scales to the last bit in
    float32 (an all-zero row takes the 1e-5 floor)."""
    x, tx = _activations(17, 63, 300, dtype, zero_rows=(5,))
    q, s = ref_bitnet.quantize_activations(x)
    tq, ts = port_bitnet.quantize_activations(tx)
    assert tq.dtype == torch.int8 and ts.dtype == _DTYPES[dtype][1]
    np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
    np.testing.assert_array_equal(ts.float().numpy(),
                                  np.asarray(s, np.float32))


# ---------------------------------------------------------------------------
# w4a16: fused (#22), the unpack (#23), two-pass (#23 then #15)
# ---------------------------------------------------------------------------


def _w4(seed, K, N, gs):
    packed, scales = port_q.quantize_int4_planar(_weights(seed, K, N), gs)
    return packed, scales


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequant_matmul_matches_jax(dtype):
    """tests/test_quantize.py:33-50's case, in both activation types."""
    M, N, K, gs = 128, 128, 512, 128
    x, tx = _activations(18, M, K, dtype)
    packed, scales = _w4(19, K, N, gs)
    want = np.asarray(ref.dequant_matmul(x, jnp.asarray(packed),
                                         jnp.asarray(scales), group_size=gs,
                                         block_K2=gs), np.float32)
    before = dict(port.launches)
    got = port.dequant_matmul(tx, torch.from_numpy(packed),
                              torch.from_numpy(scales), group_size=gs,
                              block_K2=gs)
    assert got.dtype == tx.dtype and tuple(got.shape) == (M, N)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-1)
    assert port.launches == before          # CPU tensors launch nothing


# decode rows: one token, and the 16 of the split-K kernel's two n8 tiles
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [1, 16])
def test_dequant_matmul_decode_rows_match_jax(M, dtype):
    N, K, gs = 128, 512, 128
    x, tx = _activations(25, M, K, dtype)
    packed, scales = _w4(26, K, N, gs)
    want = np.asarray(ref.dequant_matmul(x, jnp.asarray(packed),
                                         jnp.asarray(scales), group_size=gs,
                                         block_K2=gs), np.float32)
    got = port.dequant_matmul(tx, torch.from_numpy(packed),
                              torch.from_numpy(scales), group_size=gs,
                              block_K2=gs)
    assert got.dtype == tx.dtype and tuple(got.shape) == (M, N)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-1)


# ---------------------------------------------------------------------------
# the path rule, the TMA tile and the split-K plan (host code)
# ---------------------------------------------------------------------------

_T = port.SPLITK_MAX_ROWS
_BF, _F16, _F32 = torch.bfloat16, torch.float16, torch.float32


# (M, N, K2, gs, type, A's base) -> the kernel: bench's decode step and
# 4096^3, the threshold and its neighbours, group sizes below, at and
# above the TMA kernel's 64-row stage and the split-K's 8-row step, ragged
# N, misaligned bases, float32
@pytest.mark.parametrize("M,N,K2,gs,dtype,a_ptr,path", [
    (16, 11008, 2048, 128, _BF, 0, "splitk"),     # bench's decode step
    (16, 11008, 2048, 128, _F16, 0, "splitk"),
    (16, 11008, 2048, 128, _F32, 0, "loop"),
    (1, 11008, 2048, 128, _BF, 0, "splitk"),
    (4096, 4096, 2048, 512, _BF, 0, "wgmma"),     # bench's w4a16
    (4096, 4096, 2048, 512, _F16, 0, "wgmma"),
    (4096, 4096, 2048, 512, _F32, 0, "loop"),
    (_T - 1, 11008, 2048, 128, _BF, 0, "splitk"),
    (_T, 11008, 2048, 128, _BF, 0, "splitk"),
    (_T + 1, 11008, 2048, 128, _BF, 0, "wgmma"),
    (17, 11008, 2048, 128, _BF, 0, "wgmma"),
    (4096, 4096, 2048, 32, _BF, 0, "loop"),       # gs under the stage
    (4096, 4096, 2048, 64, _BF, 0, "wgmma"),      # gs the stage
    (4096, 4096, 2048, 128, _BF, 0, "wgmma"),     # gs above it
    (16, 11008, 2048, 4, _BF, 0, "loop"),         # gs under the k-step
    (16, 11008, 2048, 8, _BF, 0, "splitk"),
    (16, 300, 2048, 128, _BF, 0, "loop"),         # N off 16
    (4096, 4104, 2048, 512, _BF, 0, "loop"),
    (16, 11008, 2048, 128, _BF, 8, "loop"),       # A off 16 bytes
    (4096, 4096, 2048, 512, _BF, 2, "loop"),
    (0, 11008, 2048, 128, _BF, 0, "loop"),
])
def test_dequant_path_rule(M, N, K2, gs, dtype, a_ptr, path):
    assert port.dequant_path(M, N, K2, gs, dtype, a_ptr) == path
    assert port.dequant_path(M, N, K2, gs, str(dtype)[6:], a_ptr) == path


@pytest.mark.parametrize("ptrs", [(0, 4, 0), (0, 0, 4), (0, 8, 8)])
def test_dequant_path_rule_wants_16_byte_bases(ptrs):
    for M in (1, 4096):
        assert port.dequant_path(M, 4096, 2048, 512, _BF, *ptrs) == "loop"


@pytest.mark.parametrize("M,tile", [
    (17, (128, 128, 64)), (128, (128, 128, 64)),
    (port.WGMMA_WIDE_ROWS, (128, 128, 64)),
    (port.WGMMA_WIDE_ROWS + 1, (256, 128, 32)), (4096, (256, 128, 32))])
def test_dequant_wgmma_tile(M, tile):
    """A tile's stage lies in one group for every gs the rule admits (a
    multiple of 64)."""
    assert port.dequant_wgmma_tile(M) == tile
    assert 64 % tile[2] == 0


@pytest.mark.parametrize("N,K2,sms,want", [
    (11008, 2048, 132, (86, 3, 704)),    # bench's decode: 258 blocks
    (4096, 2048, 132, (32, 8, 256)),
    (11008, 1000, 132, (86, 3, 384)),    # K/2 off the split
    (11008, 8192, 132, (86, 11, 768)),   # capped: A's pairs in 48 KB
    (16, 8, 132, (1, 1, 64)),
    (11008, 2048, 1, (86, 3, 768)),      # one SM: the cap
])
def test_dequant_splitk_plan(N, K2, sms, want):
    assert port.dequant_splitk_plan(N, K2, sms) == want


@pytest.mark.parametrize("N", [16, 128, 144, 4096, 11008])
@pytest.mark.parametrize("K2", [8, 64, 1000, 2048, 5504, 8192])
@pytest.mark.parametrize("sms", [1, 132])
def test_dequant_splitk_plan_covers_k_once(N, K2, sms):
    """Every packed row in one split (the combine adds splits 0, 1, ... in
    order), every column in one strip; a block's rows a multiple of 64 (8
    warps of 8-row steps), at most 768."""
    strips, splits, rows = port.dequant_splitk_plan(N, K2, sms)
    assert rows % 64 == 0 and 64 <= rows <= 768
    assert (splits - 1) * rows < K2 <= splits * rows
    assert (strips - 1) * 128 < N <= strips * 128


def test_dequant_gemm_kernel_factory_matches_jax():
    M, N, K, gs = 64, 96, 256, 64
    x, tx = _activations(20, M, K, "float32")
    packed, scales = _w4(21, K, N, gs)
    s3 = scales.reshape(2, -1, N)
    want = np.asarray(ref.dequant_gemm_kernel(
        M, N, K, block_K2=gs, in_dtype="float32")(
        x.reshape(M, 2, K // 2), jnp.asarray(packed), jnp.asarray(s3)))
    got = port.dequant_gemm_kernel(M, N, K, block_K2=gs, in_dtype="float32")(
        tx.reshape(M, 2, K // 2), packed, s3)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K2,N,gs", [(256, 128, 128), (128, 96, 32)])
def test_dequant_int4_equals_jax_bit_for_bit(dtype, K2, N, gs):
    packed, scales = _w4(22, 2 * K2, N, gs)
    jd, td = _DTYPES[dtype]
    want = np.asarray(ref.dequant_int4_kernel(
        K2, N, block_K2=gs, block_N=N, out_dtype=dtype)(
        jnp.asarray(packed), jnp.asarray(scales.reshape(2, -1, N))))
    got = port.dequant_int4(torch.from_numpy(packed),
                            torch.from_numpy(scales), gs, td)
    assert got.dtype == td and tuple(got.shape) == (2 * K2, N)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16))
    else:
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequant_matmul_twopass_matches_jax(dtype):
    M, N, K, gs = 128, 128, 512, 128
    x, tx = _activations(23, M, K, dtype)
    packed, scales = _w4(24, K, N, gs)
    want = np.asarray(ref.dequant_matmul_twopass(
        x, jnp.asarray(packed), jnp.asarray(scales)), np.float32)
    got = port.dequant_matmul_twopass(tx, packed, scales)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-1)
    # the same arithmetic as the fused path: B rounded to x's type, f32 sums
    fused = port.dequant_matmul(tx, packed, scales, group_size=gs)
    assert _normwise(got.float().numpy(), fused.float().numpy()) <= (
        1e-5 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("M,K2,N,gs", [(5, 96, 77, 32), (130, 64, 200, 64),
                                       (1, 8, 3, 8)])
def test_plain_dequant_matmul_matches_float64(M, K2, N, gs):
    """K/2 over several groups, N and M off any tile (the JAX kernel
    takes neither)."""
    packed, scales = _w4(25, 2 * K2, N, gs)
    x = np.random.default_rng(26).standard_normal((M, 2 * K2)).astype(
        np.float32)
    got = port.dequant_matmul(torch.from_numpy(x), packed, scales,
                              group_size=gs, block_K2=gs)
    w = ref_q.dequantize_int4_planar_ref(packed, scales, gs)
    want = x.astype(np.float64) @ w.astype(np.float64)
    assert _normwise(got.numpy(), want) <= 1e-5


def test_dequant_errors_match_jax():
    """The JAX package's group-size rules, raised as it raises them."""
    x = np.random.default_rng(27).standard_normal((4, 512)).astype(
        np.float32)
    packed, scales = _w4(28, 512, 128, 128)
    cases = [
        (AssertionError, dict(group_size=64)),      # != block_K2
        (TypeError, dict(block_K2=64, group_size=64)),   # scales rows
    ]
    for exc, kw in cases:
        with pytest.raises(exc):
            ref.dequant_matmul(jnp.asarray(x), jnp.asarray(packed),
                               jnp.asarray(scales), **kw)
        with pytest.raises(exc):
            port.dequant_matmul(torch.from_numpy(x), packed, scales, **kw)
    with pytest.raises(AssertionError):
        ref.dequant_matmul(jnp.asarray(x[:, :256]), jnp.asarray(packed),
                           jnp.asarray(scales))
    with pytest.raises(AssertionError):
        port.dequant_matmul(torch.from_numpy(x[:, :256]), packed, scales)
    # two-pass: a group of 1024 is larger than the 512-row unpack tile
    p2, s2 = _w4(29, 2048, 16, 1024)
    x2 = np.zeros((4, 2048), np.float32)
    with pytest.raises(ValueError, match="group_size"):
        ref.dequant_matmul_twopass(jnp.asarray(x2), jnp.asarray(p2),
                                   jnp.asarray(s2))
    with pytest.raises(ValueError, match="group_size"):
        port.dequant_matmul_twopass(torch.from_numpy(x2), p2, s2)
    assert tuple(port.dequant_matmul_twopass(
        torch.from_numpy(x2), p2, s2, dq_block=1024).shape) == (4, 16)
    # float16 activations compute what the JAX package computes in
    # float16 (they raised before the float16 repair), at the w4a16 bound
    x16 = x.astype(np.float16)
    want16 = ref.dequant_matmul(jnp.asarray(x16), jnp.asarray(packed),
                                jnp.asarray(scales))
    got16 = port.dequant_matmul(torch.from_numpy(x16), packed, scales)
    assert got16.dtype == torch.float16
    np.testing.assert_allclose(got16.float().numpy(),
                               np.asarray(want16, np.float32), rtol=2e-2,
                               atol=2e-1)
    # a weight type the kernels do not take
    with pytest.raises(TypeError):
        port.dequant_matmul(torch.from_numpy(x), packed.astype(np.int8),
                            scales)


# ---------------------------------------------------------------------------
# w4a8 (#24)
# ---------------------------------------------------------------------------


def _int_reference(x, packed, sw):
    """tests/test_w4a8.py:22-28: the exact integer product, then the
    scales, in float64."""
    q, s = ref_bitnet.quantize_activations(jnp.asarray(x))
    wd = np.concatenate([(packed.astype(np.int32) & 0xF) - 8,
                         (packed.astype(np.int32) >> 4) - 8], 0)
    acc = np.asarray(q, np.int64) @ wd
    return acc.astype(np.float64) / np.asarray(s, np.float64) * sw


@pytest.mark.parametrize("M,N,K", [(128, 256, 512), (64, 128, 256)])
def test_w4a8_matches_jax_and_the_integer_reference(M, N, K):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32) * 0.1
    packed, sw = port.quantize_w4_per_channel(w)
    want = np.asarray(ref.w4a8_matmul(jnp.asarray(x), packed, sw))
    before = dict(port.launches)
    got = port.w4a8_matmul(torch.from_numpy(x), packed, sw)
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
    assert _normwise(got.numpy(), want) <= 1e-5
    assert _normwise(got.numpy(), _int_reference(x, packed, sw)) <= 1e-5
    assert port.launches == before


def test_w4a8_gemm_takes_the_planar_view_and_raises_as_jax():
    """The GEMM on the JAX kernel's operand shapes (A (M, 2, K/2), Sw
    (1, N), Sa (M, 1)) equals the entry point; bad K and scales raise."""
    rng = np.random.default_rng(30)
    M, N, K = 16, 40, 96
    x = rng.standard_normal((M, K)).astype(np.float32)
    packed, sw = port.quantize_w4_per_channel(
        rng.standard_normal((K, N)).astype(np.float32))
    q, s = port_bitnet.quantize_activations(torch.from_numpy(x))
    sa = (1.0 / s).float()
    got = port.w4a8_gemm(q.reshape(M, 2, K // 2), packed, sw.reshape(1, N),
                         sa)
    assert torch.equal(got, port.w4a8_matmul(torch.from_numpy(x), packed,
                                             sw))
    assert _normwise(got.numpy(), _int_reference(x, packed, sw)) <= 1e-5
    with pytest.raises(AssertionError):
        ref.w4a8_matmul(jnp.asarray(x[:, :64]), packed, sw)
    with pytest.raises(AssertionError):
        port.w4a8_matmul(torch.from_numpy(x[:, :64]), packed, sw)
    with pytest.raises(TypeError):
        ref.w4a8_matmul(jnp.asarray(x), packed, sw[:-1])
    with pytest.raises(TypeError):
        port.w4a8_matmul(torch.from_numpy(x), packed, sw[:-1])


@pytest.mark.parametrize("M,N,K2,ptrs,want", [
    (4096, 4096, 2048, (0, 0, 0), "tma"),
    (128, 256, 256, (0, 0, 0), "tma"),
    (1, 4096, 2048, (0, 0, 0), "tma"),           # every row count
    (77, 16, 16, (0, 0, 0), "tma"),
    (4096, 4104, 2048, (0, 0, 0), "loop"),       # N off 16 bytes
    (4096, 4096, 2056, (0, 0, 0), "loop"),       # K/2 off 16 bytes
    (4096, 4096, 10, (0, 0, 0), "loop"),
    (4096, 4096, 2048, (8, 0, 0), "loop"),       # q's base off
    (4096, 4096, 2048, (0, 4, 0), "loop"),       # packed's base off
    (4096, 4096, 2048, (0, 0, 4), "loop"),       # the scales' base off
    (4096, 4096, 2048, (256, 512, 1024), "tma"),
    (0, 4096, 2048, (0, 0, 0), "loop"), (4096, 0, 2048, (0, 0, 0), "loop"),
    (4096, 4096, 0, (0, 0, 0), "loop")])
def test_w4a8_path_rule(M, N, K2, ptrs, want):
    """K/2 and N multiples of 16 and the bases on 16 bytes take the TMA
    kernel at any row count (no row threshold: it led at every M of the
    card's sweep); the rest the tile loop."""
    assert port.w4a8_path(M, N, K2, *ptrs) == want


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm: byte i of the result is byte (sel >> 4 i) & 7
    of the 8 bytes y:x."""
    b = int(x).to_bytes(4, "little") + int(y).to_bytes(4, "little")
    return int.from_bytes(bytes(b[(sel >> 4 * i) & 7] for i in range(4)),
                          "little")


def _w4a8_unpack_stage(stage):
    """dequant_gemm.cu's W4A8Tma::Conv on one stage of 64 packed rows x
    256 columns (bytes), thread by thread: (B_lo, B_hi) as the 16 KB
    tiles it writes (n-major, 64 bytes of K a column, the 64-byte swizzle),
    and for each warp and store the 16-byte bank groups its 8-lane phases
    hit."""
    words = stage.view(np.uint32)               # (64, 64): 4 columns a word
    tiles = [np.zeros(256 * 64, np.uint8), np.zeros(256 * 64, np.uint8)]
    groups = {}
    for t in range(256):
        q, c = t % 64, t // 64
        r = (q >> 1) & 3
        rot = r | ((r + 1) & 3) << 4 | ((r + 2) & 3) << 8 | ((r + 3) & 3) << 12
        lo = [[0] * 4 for _ in range(4)]
        hi = [[0] * 4 for _ in range(4)]
        for j in range(4):
            w = [_byte_perm(words[16 * c + 4 * j + i, q], 0, rot)
                 for i in range(4)]
            t0, t1 = _byte_perm(w[0], w[1], 0x5140), _byte_perm(w[0], w[1],
                                                                0x7362)
            t2, t3 = _byte_perm(w[2], w[3], 0x5140), _byte_perm(w[2], w[3],
                                                                0x7362)
            col = [_byte_perm(t0, t2, 0x5410), _byte_perm(t0, t2, 0x7632),
                   _byte_perm(t1, t3, 0x5410), _byte_perm(t1, t3, 0x7632)]
            for s in range(4):
                lo[s][j] = (((col[s] & 0x0F0F0F0F) + 0x78787878)
                            ^ 0x80808080) & 0xFFFFFFFF
                hi[s][j] = ((((col[s] >> 4) & 0x0F0F0F0F) + 0x78787878)
                            ^ 0x80808080) & 0xFFFFFFFF
        for s in range(4):
            n = 4 * q + ((s + r) & 3)
            at = n * 64 + ((c ^ ((n >> 1) & 3)) << 4)
            for tile, v in zip(tiles, (lo[s], hi[s])):
                tile[at:at + 16] = np.array(v, np.uint32).view(np.uint8)
            groups.setdefault((t // 32, s, (t % 32) // 8), []).append(
                (at // 16) % 8)
    return tiles, groups


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_w4a8_unpack_layout_equals_unpack_planar(seed):
    """The TMA kernel's unpack, emulated on the CPU: read back through the
    64-byte swizzle (16-byte chunk c of column n at chunk c ^ ((n >> 1) &
    3)), B_lo holds the stage's low nibbles less 8 and B_hi the high
    ones, K-major, equal to unpack_planar's rows; every 8-lane phase of a
    16-byte store hits 8 different bank groups."""
    stage = np.random.default_rng(seed).integers(0, 256, (64, 256),
                                                 dtype=np.uint8)
    tiles, groups = _w4a8_unpack_stage(stage)
    want = port.unpack_planar(stage)                      # (128, 256)
    n = np.arange(256)[:, None]
    k = np.arange(64)[None, :]
    at = n * 64 + (((k // 16) ^ ((n >> 1) & 3)) << 4) + k % 16
    for h, tile in enumerate(tiles):
        got = tile.view(np.int8)[at].astype(np.int32)      # (n, k)
        np.testing.assert_array_equal(got.T, want[64 * h:64 * h + 64])
    assert want.min() >= -8 and want.max() <= 7
    assert all(sorted(g) == list(range(8)) for g in groups.values())


def test_ops_package_exports_the_jax_names():
    import tilelang_mesh_tpu.ops as ref_ops
    import tilelang_mesh_tpu_torch.ops as port_ops
    for name in ("matmul", "matmul_kernel", "dequant_matmul",
                 "dequant_gemm_kernel", "w4a8_matmul",
                 "quantize_w4_per_channel"):
        assert callable(getattr(ref_ops, name))
        assert callable(getattr(port_ops, name))
    assert port_ops.matmul is port_gemm.matmul
