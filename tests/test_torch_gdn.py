"""The port's Gated DeltaNet forward (tilelang_mesh_tpu_torch/ops/gdn.py)
against the JAX package's (ops/gdn.py) on the same numpy-seeded inputs.

The JAX tile kernel runs in Pallas interpret mode on the CPU, as
tests/test_gdn.py runs it; the port's ``gdn_chunk_fwd_tl`` runs on CPU
tensors, i.e. the kernel's plain version (the Neumann-doubling inverse
and the same roundings). Tolerances: the tile kernel at rtol = atol =
2e-2, the JAX test's own (tests/test_gdn.py:28), also in bfloat16 where
both round at the same points; the chunk-parallel WY form and its stages
at 1e-4 (float32, the same algorithm in another summation order); the
sequential reference at 1e-5 (the same steps). The CUDA kernel is held
against the plain version on the card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tilelang_mesh_tpu.ops import gdn as ref
from tilelang_mesh_tpu_torch.ops import gdn as port


def _inputs(B, H, T, K, V, seed=0):
    """tests/test_gdn.py's draws (l2-normalised keys), float32 numpy."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, T, K)).astype(np.float32)
    k = rng.standard_normal((B, H, T, K)).astype(np.float32)
    k = k / np.linalg.norm(k, axis=-1, keepdims=True)
    v = rng.standard_normal((B, H, T, V)).astype(np.float32)
    g = rng.uniform(-0.2, 0.0, (B, H, T)).astype(np.float32)
    beta = rng.uniform(0.0, 1.0, (B, H, T)).astype(np.float32)
    return q, k, v, g, beta


def _both(arrays, dtype=jnp.float32):
    q, k, v, g, beta = arrays
    j = tuple(jnp.asarray(a, dtype) for a in (q, k, v)) + (
        jnp.asarray(g), jnp.asarray(beta))
    t = [torch.from_numpy(np.array(a, np.float32)) for a in j]
    if dtype == jnp.bfloat16:
        t[:3] = [a.bfloat16() for a in t[:3]]
    return j, tuple(t)


# tests/test_gdn.py:60-89: (B, H, T, K, V), seed, chunk; and bench's
# widths at chunk 128, which the card takes
TL_CASES = [((1, 2, 128, 32, 32), 5, 32), ((1, 1, 128, 32, 16), 6, 16),
            ((1, 1, 128, 32, 16), 6, 64), ((2, 2, 256, 64, 64), 7, 64),
            ((1, 1, 256, 128, 128), 13, 128)]


@pytest.mark.parametrize("shape,seed,chunk", TL_CASES)
def test_tile_kernel_matches_jax(shape, seed, chunk):
    j, t = _both(_inputs(*shape, seed=seed))
    want = np.asarray(ref.gdn_chunk_fwd_tl(*j, chunk_size=chunk))
    before = dict(port.launches)
    got = port.gdn_chunk_fwd_tl(*t, chunk_size=chunk)
    assert port.launches == before          # CPU tensors launch nothing
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        ref.gdn_reference(*j)), rtol=2e-2, atol=2e-2)


def test_tile_kernel_bf16_matches_jax():
    j, t = _both(_inputs(1, 2, 128, 32, 32, seed=8), jnp.bfloat16)
    want = np.asarray(ref.gdn_chunk_fwd_tl(*j, chunk_size=32), np.float32)
    got = port.gdn_chunk_fwd_tl(*t, chunk_size=32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("initial", [False, True])
def test_chunked_matches_jax_with_states(initial):
    """gdn_chunk_fwd with an initial state and the final state returned."""
    j, t = _both(_inputs(2, 2, 128, 32, 16, seed=9))
    h0 = (np.random.default_rng(3).standard_normal((2, 2, 32, 16)) * 0.1
          ).astype(np.float32) if initial else None
    jh = None if h0 is None else jnp.asarray(h0)
    th = None if h0 is None else torch.from_numpy(h0)
    want_o, want_h = ref.gdn_chunk_fwd(*j, chunk_size=32, initial_state=jh,
                                       output_final_state=True)
    got_o, got_h = port.gdn_chunk_fwd(*t, chunk_size=32, initial_state=th,
                                      output_final_state=True)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=1e-4,
                               atol=1e-4)
    only_o = port.gdn_chunk_fwd(*t, chunk_size=32, initial_state=th)
    assert torch.equal(only_o, got_o)


def test_chunked_stages_match_jax():
    """gdn_chunk_cumsum, gdn_scaled_dot_kkt and gdn_wy_fast stage by
    stage."""
    q, k, v, g, beta = _inputs(1, 2, 64, 16, 16, seed=10)
    C, N = 16, 4
    jgc = ref.gdn_chunk_cumsum(jnp.asarray(g), C)
    tgc = port.gdn_chunk_cumsum(torch.from_numpy(g), C)
    np.testing.assert_allclose(tgc.numpy(), np.asarray(jgc), rtol=1e-6,
                               atol=1e-6)
    kf, vf = k.reshape(1, 2, N, C, 16), v.reshape(1, 2, N, C, 16)
    bf = beta.reshape(1, 2, N, C)
    jA = ref.gdn_scaled_dot_kkt(jnp.asarray(kf), jnp.asarray(bf), jgc)
    tA = port.gdn_scaled_dot_kkt(torch.from_numpy(kf), torch.from_numpy(bf),
                                 tgc)
    np.testing.assert_allclose(tA.numpy(), np.asarray(jA), rtol=1e-5,
                               atol=1e-5)
    jw = ref.gdn_wy_fast(jnp.asarray(kf), jnp.asarray(vf), jnp.asarray(bf),
                         jgc, jA)
    tw = port.gdn_wy_fast(torch.from_numpy(kf), torch.from_numpy(vf),
                          torch.from_numpy(bf), tgc, tA)
    for got, want in zip(tw, jw):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("initial", [False, True])
def test_reference_matches_jax(initial):
    j, t = _both(_inputs(1, 2, 64, 16, 16, seed=11))
    h0 = (np.random.default_rng(12).standard_normal((1, 2, 16, 16)) * 0.1
          ).astype(np.float32) if initial else None
    want_o, want_h = ref.gdn_reference(
        *j, initial_state=None if h0 is None else jnp.asarray(h0),
        output_final_state=True)
    got_o, got_h = port.gdn_reference(
        *t, initial_state=None if h0 is None else torch.from_numpy(h0),
        output_final_state=True)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=1e-5,
                               atol=1e-5)


def test_chunk_must_divide_t():
    _, t = _both(_inputs(1, 1, 48, 16, 16))
    with pytest.raises(ValueError):
        port.gdn_chunk_fwd_tl(*t, chunk_size=32)
    with pytest.raises(ValueError):
        port.gdn_chunk_fwd(*t, chunk_size=32)


# bench's shape (B 8, H 16, T 4096, K = V = 128): chunk, bytes an element
# -> the serial pass's column block, overlay, grid, shared memory and
# blocks an SM
PLANS = {
    (64, 2): (64, False, (2, 16, 8), 106496, 2),
    (128, 2): (64, False, (2, 16, 8), 210944, 1),
    (64, 4): (64, False, (2, 16, 8), 188416, 1),
    (128, 4): (32, True, (4, 16, 8), 190464, 1),
}


@pytest.mark.parametrize("C,esize", sorted(PLANS))
def test_kernel_plan_at_bench_shape(C, esize):
    """The card's two launches are a pure function of the shapes and the
    type: the widest column block of at most 16 output and state tiles,
    its load groups apart where they fit, each block within 232448
    bytes."""
    plan = port.gdn_plan(8, 16, 4096, 128, 128, C, esize)
    assert (plan.vb, plan.overlay, plan.state_grid, plan.state_smem,
            plan.resident) == PLANS[(C, esize)]
    assert plan.wy_grid == (4096 // C, 16, 8)
    assert plan.wy_smem == port.gdn_wy_smem(esize, C, 128, 128) <= 232448
    assert plan.state_smem <= 232448


def test_kernel_plan_small_widths_and_refusal():
    """Rectangular widths take the widest column block that fits; chunk
    256 at K = V = 128 does not fit (the WY kernel's float32 C x C
    matrix alone)."""
    plan = port.gdn_plan(2, 2, 256, 64, 32, 64, 2)
    assert (plan.vb, plan.overlay, plan.state_grid) == (32, False, (1, 2, 2))
    for esize in (2, 4):
        assert port.gdn_plan(8, 16, 4096, 128, 128, 256, esize) is None
