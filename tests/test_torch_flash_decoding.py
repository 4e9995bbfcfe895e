"""The port's flash decoding (tilelang_mesh_tpu_torch/ops/flash_decoding.py):
the in-kernel page walk, the contiguous decode and the gather strategy,
against the JAX package's (ops/flash_decoding.py) on the same
numpy-seeded inputs.

The JAX side runs as tests/test_decoding.py runs it (Pallas interpret
mode on the CPU); the port side runs on CPU tensors, i.e. the kernel's
plain PyTorch version. Tolerance: rtol = atol = 2e-2, the reference's
own for decode (tests/test_decoding.py:25). The CUDA kernel itself is
held against the plain version by tests/test_torch_cuda.py on the
card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tilelang_mesh_tpu.ops import flash_decoding as ref
from tilelang_mesh_tpu_torch.ops import flash_decoding as port

# the shapes of tests/test_decoding.py:80
B, H, D, PS, PP, NP = 2, 4, 64, 32, 4, 12
TOL = 2e-2


def _inputs(seed=0, dtype=np.float32):
    """q (B,H,1,D), H-major pools (H, NP*PS, D), table (B, PP)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, 1, D)).astype(np.float32)
    kpages = rng.standard_normal((NP, PS, H, D)).astype(dtype)
    vpages = rng.standard_normal((NP, PS, H, D)).astype(dtype)
    table = np.stack([rng.choice(NP, PP, replace=False)
                      for _ in range(B)]).astype(np.int32)
    kp = np.ascontiguousarray(kpages.transpose(2, 0, 1, 3)).reshape(
        H, NP * PS, D)
    vp = np.ascontiguousarray(vpages.transpose(2, 0, 1, 3)).reshape(
        H, NP * PS, D)
    return q, kp, vp, table


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("n_split", [1, 2, 4])
def test_paged_pool_decode_matches_reference(n_split):
    q, kp, vp, table = _inputs()
    want = np.asarray(ref.flash_decode_paged_pool(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), table, PS,
        n_split=n_split))
    got = port.flash_decode_paged_pool(*_t(q, kp, vp, table), PS,
                                       n_split=n_split)
    assert tuple(got.shape) == (B, H, 1, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n_split", [1, 2, 4])
def test_partials_and_combine_match_reference(n_split):
    """The exp2-domain (o, m, l) partials of each split, and the
    combine epilogue on the SAME partials (to 1e-6)."""
    q, kp, vp, table = _inputs(seed=1)
    sm_scale = 1.0 / np.sqrt(D)
    kern = ref.paged_decode_kernel(B, H, PP, PS, D, n_split, NP * PS,
                                   float(sm_scale), "float32")
    op_r, mp_r, lp_r = (np.asarray(a) for a in kern(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table)))
    op, mp, lp = port.paged_decode_partials(*_t(q, kp, vp, table), PS,
                                            n_split, sm_scale)
    assert tuple(op.shape) == (B, n_split, H, D)
    assert tuple(mp.shape) == tuple(lp.shape) == (B, n_split, H, 1)
    np.testing.assert_allclose(mp.numpy(), mp_r, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lp.numpy(), lp_r, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(op.numpy(), op_r, rtol=TOL, atol=TOL)

    qj = jnp.asarray(q)
    want = np.asarray(ref._combine_splits(qj, jnp.asarray(op_r),
                                          jnp.asarray(mp_r),
                                          jnp.asarray(lp_r)))
    got = port._combine_splits(torch.from_numpy(q), *_t(op_r, mp_r, lp_r))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_split_clamp_matches_reference():
    """n_split is clamped to a divisor of the page count (:232-235):
    a request for 3 splits of 4 pages runs 2, as the reference does."""
    q, kp, vp, table = _inputs(seed=2)
    want = np.asarray(ref.flash_decode_paged_pool(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), table, PS,
        n_split=3))
    got = port.flash_decode_paged_pool(*_t(q, kp, vp, table), PS,
                                       n_split=3)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_bf16_pool_plain_matches_f32_on_rounded_values():
    """A bfloat16 pool decodes like a float32 pool holding the same
    (bf16-rounded) values: the plain version computes in f32."""
    q, kp, vp, table = _inputs(seed=3)
    kb = torch.from_numpy(kp).to(torch.bfloat16)
    vb = torch.from_numpy(vp).to(torch.bfloat16)
    qt, tt = _t(q, table)
    got = port.flash_decode_paged_pool(qt, kb, vb, tt, PS)
    want = port.flash_decode_paged_pool(qt, kb.float(), vb.float(), tt, PS)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    q, kp, vp, table = _inputs(seed=4)
    before = dict(port.launches)
    port.flash_decode_paged_pool(*_t(q, kp, vp, table), PS)
    assert port.launches == before


def test_wrapper_rejects_bad_arguments():
    q, kp, vp, table = _t(*_inputs(seed=5))
    with pytest.raises(ValueError):
        port.paged_decode_partials(q, kp, vp, table, PS, 3, 0.125)
    with pytest.raises(ValueError):
        port.paged_decode_partials(q, kp[:2], vp[:2], table, PS, 1, 0.125)
    with pytest.raises(TypeError):
        port.paged_decode_partials(q, kp.double(), vp.double(), table, PS,
                                   1, 0.125)
    with pytest.raises(ValueError):
        port.paged_decode_partials(q, kp, vp, table, 7, 1, 0.125)


# ---------------------------------------------------------------------------
# contiguous decode (decode_kernel's counterpart) and the gather strategy
# ---------------------------------------------------------------------------


def _contiguous(seed, b, h, s, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, h, 1, d), (b, h, s, d), (b, h, s, d)))


@pytest.mark.parametrize("b,h,s,d,n_split", [(2, 4, 512, 64, 4),
                                             (1, 2, 128, 128, 1)])
def test_flash_decode_matches_reference(b, h, s, d, n_split):
    """tests/test_decoding.py:16-36's two cases."""
    q, k, v = _contiguous(n_split, b, h, s, d)
    want = np.asarray(ref.flash_decode(*map(jnp.asarray, (q, k, v)),
                                       n_split=n_split))
    got = port.flash_decode(*_t(q, k, v), n_split=n_split)
    assert tuple(got.shape) == (b, h, 1, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n_split", [1, 2, 4])
def test_contiguous_partials_match_reference(n_split):
    """decode_kernel's (o, m, l) partials, split by split."""
    q, k, v = _contiguous(11, 2, 4, 512, 64)
    sm_scale = 1.0 / np.sqrt(64)
    kern = ref.decode_kernel(2, 4, 512, 64, n_split, 128, float(sm_scale),
                             "float32")
    want = [np.asarray(a) for a in kern(*map(jnp.asarray, (q, k, v)))]
    got = port.decode_partials(*_t(q, k, v), n_split, sm_scale)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("n_split", [1, 4])
def test_contiguous_partials_match_reference_16bit(dtype, n_split):
    """decode_kernel's partials on 16-bit Q, K and V (the same rounded
    values on both sides). o differs by more than m and l: the JAX kernel
    rounds P to the input type before P @ V (T.copy(S_f, P_f)), while the
    port keeps p in float32 (csrc/decode.cu's contract), so o is held
    normwise to 1e-2 (1.6e-3 measured in bfloat16, 2.1e-4 in float16)
    and m, l to 1e-5 (3.5e-7 measured)."""
    q, k, v = _contiguous(11, 2, 4, 512, 64)
    sm_scale = 1.0 / np.sqrt(64)
    jq, jk, jv = (jnp.asarray(a, dtype) for a in (q, k, v))
    kern = ref.decode_kernel(2, 4, 512, 64, n_split, 128, float(sm_scale),
                             dtype)
    want = [np.asarray(a, np.float32) for a in kern(jq, jk, jv)]
    tq, tk, tv = (torch.from_numpy(np.array(a, np.float32)).to(
        getattr(torch, dtype)) for a in (jq, jk, jv))
    got = port.decode_partials(tq, tk, tv, n_split, sm_scale)
    for g, w, tol in zip(got, want, (1e-2, 1e-5, 1e-5)):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert err <= tol, err


@pytest.mark.parametrize("dtype,kernel", [
    (torch.float32, "split_kv_decode"), (torch.bfloat16, "decode_tma"),
    (torch.float16, "decode_tma")])
def test_decode_path(dtype, kernel):
    """float32 K/V keep the split-KV loop; 16-bit K/V take the TMA ring."""
    assert port.decode_path(dtype) == kernel
    assert kernel in port.kernel_launches


def test_flash_decode_split_clamp_matches_reference(monkeypatch):
    """The (n_split, block_N) of flash_decoding.py:100-104, for requested
    and default splits over S that 8 does or does not divide evenly."""
    seen = []
    kernel = ref.decode_kernel

    def spy(B_, H_, S_, D_, n_split, block_N, *rest):
        seen.append((n_split, block_N))
        return kernel(B_, H_, S_, D_, n_split, block_N, *rest)

    monkeypatch.setattr(ref, "decode_kernel", spy)
    for s, requested in ((384, 8), (1000, 8), (384, None), (640, 3)):
        q, k, v = _contiguous(s, 1, 2, s, 64)
        want = np.asarray(ref.flash_decode(*map(jnp.asarray, (q, k, v)),
                                           n_split=requested))
        assert port.clamp_splits(s, requested, 128) == seen[-1]
        got = port.flash_decode(*_t(q, k, v), n_split=requested)
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def _pages(seed, b, h, d, ps, pp, n_pages):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, 1, d)).astype(np.float32)
    kp = rng.standard_normal((n_pages, ps, h, d)).astype(np.float32)
    vp = rng.standard_normal((n_pages, ps, h, d)).astype(np.float32)
    table = np.stack([rng.choice(n_pages, pp, replace=False)
                      for _ in range(b)]).astype(np.int32)
    return q, kp, vp, table


def test_flash_decode_paged_matches_reference():
    """tests/test_decoding.py:39-56's case, the gather strategy."""
    q, kp, vp, table = _pages(2, 2, 2, 64, 128, 4, 16)
    want = np.asarray(ref.flash_decode_paged(
        *map(jnp.asarray, (q, kp, vp, table))))
    got = port.flash_decode_paged(*_t(q, kp, vp, table))
    assert tuple(got.shape) == (2, 2, 1, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_pages_to_hmajor_is_exact():
    _, kp, _, _ = _pages(12, 1, 3, 16, 8, 2, 5)
    want = np.asarray(ref.pages_to_hmajor(jnp.asarray(kp)))
    got = port.pages_to_hmajor(torch.from_numpy(kp))
    assert tuple(got.shape) == (3, 5 * 8, 16)
    np.testing.assert_array_equal(got.numpy(), want)


def test_inkernel_walk_matches_gather():
    """tests/test_decoding.py:72-98: the page walk over the H-major pool,
    the gather strategy and the contiguous decode of the gathered KV
    agree, in the port and against the JAX package's contiguous decode."""
    q, kpages, vpages, table = _pages(0, B, H, D, PS, PP, NP)
    qt, kt, vt, tt = _t(q, kpages, vpages, table)
    o_gather = port.flash_decode_paged(qt, kt, vt, tt)
    o_pool = port.flash_decode_paged_pool(
        qt, port.pages_to_hmajor(kt), port.pages_to_hmajor(vt), tt, PS)
    k = kpages[table].reshape(B, PP * PS, H, D).transpose(0, 2, 1, 3)
    v = vpages[table].reshape(B, PP * PS, H, D).transpose(0, 2, 1, 3)
    want = np.asarray(ref.flash_decode(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v)))
    got = port.flash_decode(*_t(q, k, v))
    for o in (o_gather, o_pool, got):
        np.testing.assert_allclose(o.numpy(), want, rtol=TOL, atol=TOL)
    torch.testing.assert_close(o_gather, got, rtol=0, atol=0)


def test_contiguous_cpu_path_counts_nothing_and_rejects_bad_arguments():
    q, k, v = _t(*_contiguous(13, 1, 2, 256, 64))
    before = dict(port.launches)
    port.flash_decode(q, k, v)
    assert port.launches == before
    with pytest.raises(ValueError):             # 3 does not divide 256
        port.decode_partials(q, k, v, 3, 0.125)
    with pytest.raises(ValueError):
        port.decode_partials(q, k[:, :1], v[:, :1], 1, 0.125)
    with pytest.raises(TypeError):
        port.decode_partials(q, k.double(), v.double(), 1, 0.125)
