"""The port's MLA decode (tilelang_mesh_tpu_torch/ops/mla.py) against the
JAX package's (ops/mla.py) on the same numpy-seeded inputs.

The JAX side runs as tests/test_decoding.py runs it (Pallas interpret
mode on the CPU, which emulates the TPU's bf16 matrix products); the
port side runs on CPU tensors, i.e. the kernel's plain PyTorch version.
Tolerances: rtol = atol = 2e-2 against the Pallas kernel, the
reference's own for MLA decode (tests/test_decoding.py:69); 1e-5
between the two dense float32 references. The CUDA kernel itself is held
against the plain version by tests/test_torch_cuda.py on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tilelang_mesh_tpu.ops import mla as ref
from tilelang_mesh_tpu_torch.ops import flash_decoding as port_fd
from tilelang_mesh_tpu_torch.ops import mla as port

# the shapes of tests/test_decoding.py:60
B, H, S, DC, DR = 2, 8, 512, 256, 32
TOL = 2e-2


def _inputs(seed=3, S=S, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple((rng.standard_normal(shape) * 0.3).astype(dtype)
                 for shape in ((B, H, DC), (B, H, DR), (B, S, DC),
                               (B, S, DR)))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def test_mla_decode_matches_reference():
    """test_decoding.py:60-69's case: the port against the JAX kernel."""
    qc, qr, ckv, kpe = _inputs()
    want = np.asarray(ref.mla_decode(*map(jnp.asarray, (qc, qr, ckv, kpe)),
                                     n_split=4))
    got = port.mla_decode(*_t(qc, qr, ckv, kpe), n_split=4)
    assert tuple(got.shape) == (B, H, DC) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_plain_matches_dense_reference():
    """The split partials plus the combine against JAX's dense f32
    mla_decode_reference, and the port's own dense reference."""
    qc, qr, ckv, kpe = _inputs(seed=4)
    want = np.asarray(ref.mla_decode_reference(
        *map(jnp.asarray, (qc, qr, ckv, kpe))))
    got = port.mla_decode(*_t(qc, qr, ckv, kpe), n_split=4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    dense = port.mla_decode_reference(*_t(qc, qr, ckv, kpe))
    np.testing.assert_allclose(dense.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_split", [1, 2, 4])
def test_partials_and_combine_match_reference(n_split):
    """The exp2-domain (o, m, l) partials of each split against the
    Pallas kernel's, and the combine on the SAME partials (to 1e-6)."""
    qc, qr, ckv, kpe = _inputs(seed=5)
    sm_scale = 1.0 / np.sqrt(DC + DR)
    kern = ref.mla_decode_kernel(B, H, S, DC, DR, n_split,
                                 min(128, S // n_split), float(sm_scale),
                                 "float32")
    op_r, mp_r, lp_r = (np.asarray(a) for a in kern(
        *map(jnp.asarray, (qc, qr, ckv, kpe))))
    op, mp, lp = port.mla_decode_partials(*_t(qc, qr, ckv, kpe), n_split,
                                          sm_scale)
    assert tuple(op.shape) == (B, n_split, H, DC)
    assert tuple(mp.shape) == tuple(lp.shape) == (B, n_split, H)
    np.testing.assert_allclose(mp.numpy(), mp_r, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lp.numpy(), lp_r, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(op.numpy(), op_r, rtol=TOL, atol=TOL)

    # the combine of mla.py:106-110, on the reference's partials
    m_max = mp_r.max(axis=1, keepdims=True)
    alpha = np.exp2(mp_r - m_max)
    want = (op_r * alpha[..., None]).sum(1) / (lp_r * alpha).sum(1)[..., None]
    got = port_fd.merge_splits(*_t(op_r, mp_r, lp_r))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seq", [384, 1000])
def test_split_clamp_matches_reference(seq, monkeypatch):
    """The same n_split and tile as the JAX package's mla_decode picks
    (mla.py:95-101) for 8 requested splits and for the default."""
    seen = []
    kernel = ref.mla_decode_kernel

    def spy(B_, H_, S_, dc, dr, n_split, block_N, *rest):
        seen.append((n_split, block_N))
        return kernel(B_, H_, S_, dc, dr, n_split, block_N, *rest)

    monkeypatch.setattr(ref, "mla_decode_kernel", spy)
    qc, qr, ckv, kpe = _inputs(seed=6, S=seq)
    for requested in (8, None):
        if requested is None and seq % 128:
            continue       # the reference's clamp runs n_split down to 0
        want = np.asarray(ref.mla_decode(
            *map(jnp.asarray, (qc, qr, ckv, kpe)), n_split=requested))
        assert port_fd.clamp_splits(seq, requested, 128) == seen[-1]
        got = port.mla_decode(*_t(qc, qr, ckv, kpe), n_split=requested)
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_bf16_rounds_p_like_the_reference():
    """bfloat16 inputs: the plain version rounds p to bf16 before p @ ckv
    (the TPU kernel's P_f copy), so it equals the f32 computation on the
    rounded inputs only up to that rounding, and agrees with the JAX
    kernel run in bfloat16."""
    qc, qr, ckv, kpe = _inputs(seed=7)
    tb = [t.to(torch.bfloat16) for t in _t(qc, qr, ckv, kpe)]
    got = port.mla_decode(*tb, n_split=4)
    assert got.dtype == torch.bfloat16
    want = np.asarray(ref.mla_decode(
        *(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in tb),
        n_split=4)).astype(np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL, atol=TOL)
    f32 = port.mla_decode(*(t.float() for t in tb), n_split=4)
    np.testing.assert_allclose(got.float().numpy(), f32.numpy(), rtol=TOL,
                               atol=TOL)
    _, _, lp = port.mla_decode_partials(*tb, 4, 0.1)
    _, _, lp32 = port.mla_decode_partials(*(t.float() for t in tb), 4, 0.1)
    torch.testing.assert_close(lp, lp32, rtol=1e-6, atol=1e-6)


def test_strided_views_match_copies():
    """The serving path hands the kernel wrapper column views of one
    (B, S, dc + dr) tensor; they give what contiguous copies give."""
    qc, qr, ckv, kpe = _t(*_inputs(seed=8))
    rows = torch.cat([ckv, kpe], dim=-1)
    got = port.mla_decode(qc, qr, rows[..., :DC], rows[..., DC:],
                          n_split=2)
    want = port.mla_decode(qc, qr, ckv, kpe, n_split=2)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    before = dict(port.launches)
    port.mla_decode(*_t(*_inputs(seed=9)))
    assert port.launches == before == {"mla_decode": before["mla_decode"]}


def test_wrapper_rejects_bad_arguments():
    qc, qr, ckv, kpe = _t(*_inputs(seed=10))
    with pytest.raises(ValueError):            # 3 does not divide 512
        port.mla_decode_partials(qc, qr, ckv, kpe, 3, 0.1)
    with pytest.raises(ValueError):            # kpe width != q_rope's
        port.mla_decode_partials(qc, qr, ckv, kpe[..., :16], 1, 0.1)
    with pytest.raises(TypeError):
        port.mla_decode_partials(qc.double(), qr.double(), ckv.double(),
                                 kpe.double(), 1, 0.1)
    with pytest.raises(TypeError):             # mixed types
        port.mla_decode_partials(qc, qr, ckv.bfloat16(), kpe, 1, 0.1)
