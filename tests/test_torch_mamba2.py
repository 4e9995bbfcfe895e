"""The port's Mamba2 SSD chunk scan (tilelang_mesh_tpu_torch/ops/mamba2.py)
against the JAX package's (ops/mamba2.py) on the same numpy-seeded
inputs.

The JAX kernel runs in Pallas interpret mode on the CPU, as
tests/test_mamba2.py runs it; the port's ``mamba2_chunk_scan`` runs on
CPU tensors, i.e. the kernel's plain version. Tolerances: the kernel at
rtol = atol = 2e-2, the JAX test's own (tests/test_mamba2.py:23), also
in bfloat16, where both sides round att, cdec, state, bdec and y to
bf16 at the same points; the chunk-parallel port against
``mamba2_chunk_scan_xla`` at 1e-4 (float32, the same algorithm in
another summation order); the sequential reference at 1e-5 (the same
recurrence step by step). The CUDA kernel is held against the plain
version on the card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tilelang_mesh_tpu.ops import mamba2 as ref
from tilelang_mesh_tpu_torch.ops import mamba2 as port


def _inputs(B, S, H, P, N, seed, dt_range=(0.01, 0.1), A=None):
    """tests/test_mamba2.py's draws, as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, S, H, P)) * 0.5).astype(np.float32)
    dt = rng.uniform(*dt_range, (B, S, H)).astype(np.float32)
    a = (np.asarray(A, np.float32) if A is not None
         else (-rng.uniform(0.5, 1.5, (H,))).astype(np.float32))
    bm = (rng.standard_normal((B, S, N)) * 0.3).astype(np.float32)
    cm = (rng.standard_normal((B, S, N)) * 0.3).astype(np.float32)
    return x, dt, a, bm, cm


# tests/test_mamba2.py:12-55: (B, S, H, P, N), seed, dt range, A, chunk
CASES = {
    "recurrence_chunk128": ((1, 512, 2, 64, 64), 0, (0.01, 0.1), None, 128),
    "state_carry_chunk64": ((1, 256, 1, 32, 32), 1, (0.05, 0.2), [-1.0], 64),
    "no_overflow_chunk256": ((1, 256, 1, 32, 32), 2, (0.4, 0.6), [-1.0],
                             256),
}


def _both(arrays, dtype):
    """The same values for JAX and torch, in ``dtype`` where the kernel
    takes it (x, Bm, Cm)."""
    x, dt, a, bm, cm = arrays
    jx, jb, jc = (jnp.asarray(t, dtype) for t in (x, bm, cm))
    j = (jx, jnp.asarray(dt), jnp.asarray(a), jb, jc)
    t = tuple(torch.from_numpy(np.array(v, np.float32)) for v in j)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    return j, (t[0].to(tdt), t[1], t[2], t[3].to(tdt), t[4].to(tdt))


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunk_scan_matches_jax(case):
    shape, seed, dt_range, A, chunk = CASES[case]
    j, t = _both(_inputs(*shape, seed, dt_range, A), jnp.float32)
    want = np.asarray(ref.mamba2_chunk_scan(*j, chunk=chunk))
    before = dict(port.launches)
    got = port.mamba2_chunk_scan(*t, chunk=chunk)
    assert port.launches == before          # CPU tensors launch nothing
    assert got.dtype == torch.float32 and tuple(got.shape) == shape[:4]
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2)
    # and the sequential recurrence, as the JAX test holds its kernel
    np.testing.assert_allclose(got.numpy(), np.asarray(
        ref.mamba2_reference(*j)), rtol=2e-2, atol=2e-2)


def test_chunk_scan_bf16_matches_jax():
    j, t = _both(_inputs(1, 256, 2, 32, 32, 4), jnp.bfloat16)
    want = np.asarray(ref.mamba2_chunk_scan(*j, chunk=64), np.float32)
    got = port.mamba2_chunk_scan(*t, chunk=64)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("chunk", [128, 64, 96])
def test_chunk_parallel_matches_jax_xla(chunk):
    """The port of mamba2_chunk_scan_xla (bench.py's baseline), chunk 96
    falling back to 64 by halving as the JAX rule does."""
    j, t = _both(_inputs(2, 512, 2, 64, 64, 3), jnp.float32)
    want = np.asarray(ref.mamba2_chunk_scan_xla(*j, chunk=chunk))
    got = port.mamba2_chunk_scan_torch(*t, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_reference_matches_jax():
    j, t = _both(_inputs(2, 128, 3, 16, 8, 5), jnp.float32)
    want = np.asarray(ref.mamba2_reference(*j))
    got = port.mamba2_reference(*t)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_chunk_falls_back_by_halving():
    """S = 192 with chunk 128: the JAX rule halves to 64."""
    j, t = _both(_inputs(1, 192, 1, 16, 16, 6), jnp.float32)
    want = np.asarray(ref.mamba2_chunk_scan(*j, chunk=128))
    got = port.mamba2_chunk_scan(*t, chunk=128)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2)
    assert port._norm_chunk(128, 192) == 64


def test_bad_shapes_raise():
    _, t = _both(_inputs(1, 64, 2, 16, 16, 7), jnp.float32)
    x, dt, a, bm, cm = t
    with pytest.raises(ValueError):
        port.mamba2_chunk_scan(x, dt[:, :, :1], a, bm, cm)
    with pytest.raises(TypeError):
        port.mamba2_chunk_scan(x, dt, a, bm.bfloat16(), cm)


# bench's widths (B 8, H 80, P 64, N 128): chunk, bytes an element ->
# (PB, R, the strips' tile width, grid, shared memory, blocks an SM)
PLANS = {
    (128, 2): (64, 32, 16, (80, 8, 1), 108608, 2),
    (256, 2): (64, 64, 32, (80, 8, 1), 215104, 1),
    (512, 2): (32, 16, 16, (80, 8, 2), 228416, 1),
    (128, 4): (64, 32, 32, (80, 8, 1), 206912, 1),
    (256, 4): (16, 16, 32, (80, 8, 4), 212032, 1),
}


@pytest.mark.parametrize("chunk,esize", sorted(PLANS))
def test_kernel_plan_at_bench_widths(chunk, esize):
    """The card's launch is a pure function of the shapes and the type:
    two blocks an SM at bf16 chunk 128, each block within a block's
    shared memory (232448 bytes); tiles 16 wide only in bf16, where a
    strip has fewer output tiles of 32 than the block has warps."""
    plan = port.mamba2_plan(8, 80, 64, 128, chunk, esize)
    assert tuple(plan) == PLANS[(chunk, esize)]
    assert plan.smem == port.mamba2_smem(esize, chunk, 128, plan.pb, plan.r)
    assert plan.smem <= 232448


def test_kernel_plan_refuses_what_does_not_fit():
    """float32 at chunk 512: B alone passes a block's shared memory."""
    assert port.mamba2_plan(8, 80, 64, 128, 512, 4) is None
    assert port.mamba2_plan(8, 80, 64, 128, 256, 4) is not None
