"""The port's ring attention (tilelang_mesh_tpu_torch/parallel/
ring_attention.py) against the JAX package's (parallel/ring_attention.py)
on the same numpy-seeded inputs.

Four gloo ranks on the CPU (``torch_gloo.run_ranks``, one process a
rank) against the JAX layer on four of the conftest's eight virtual
devices, at tests/test_parallel_ops.py:24-40's shapes and seed, causal
and not; one rank against the port's own ``flash_attention``. The JAX
partial kernel runs in Pallas interpret mode; the port's on CPU tensors
runs its plain version. Tolerance: 1e-4 normwise (max |port - jax| over
max |jax|), the same float32 arithmetic in another order; the
reference's own 2e-2 is only an upper limit.
"""

import numpy as np
import pytest
import torch

from tilelang_mesh_tpu_torch.ops.flash_attention import flash_attention
from tilelang_mesh_tpu_torch.parallel import make_ring_attention
from tilelang_mesh_tpu_torch.parallel.ring_attention import _merge
from torch_gloo import ring_rank, run_ranks

TOL = 1e-4
B, H, S, D = 1, 2, 512, 64          # tests/test_parallel_ops.py:32
CAUSALS = (True, False)


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, H, S, D)).astype(np.float32)
                 for _ in range(3))


def _normwise(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    ranks = run_ranks(ring_rank, 4, tmp_path_factory.mktemp("ring4"),
                      *_inputs(), CAUSALS)
    return {c: np.concatenate([r[i] for r in ranks], axis=2)
            for i, c in enumerate(CAUSALS)}


@pytest.mark.parametrize("causal", CAUSALS)
def test_four_ranks_match_jax(four_ranks, causal):
    import jax
    import jax.numpy as jnp

    from tilelang_mesh_tpu.parallel.ring_attention import \
        make_ring_attention as jax_ring
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]), ("sp",))
    want = np.asarray(jax_ring(mesh, "sp", causal=causal)(
        *map(jnp.asarray, _inputs())))
    got = four_ranks[causal]
    assert got.shape == (B, H, S, D) and got.dtype == np.float32
    assert _normwise(got, want) <= TOL


@pytest.mark.parametrize("causal", CAUSALS)
def test_one_rank_is_flash_attention(causal):
    q, k, v = (torch.from_numpy(a) for a in _inputs())
    got = make_ring_attention(None, causal=causal)(q, k, v)
    want = flash_attention(q, k, v, causal=causal)
    assert _normwise(got.numpy(), want.numpy()) <= TOL


def test_merge_matches_jax():
    import jax.numpy as jnp

    from tilelang_mesh_tpu.parallel.ring_attention import _merge as jax_merge
    rng = np.random.default_rng(5)

    def part():
        return (rng.standard_normal((1, 2, 8, 4)).astype(np.float32),
                rng.standard_normal((1, 2, 8)).astype(np.float32) * 4,
                rng.random((1, 2, 8)).astype(np.float32) + 0.5)

    state, new = part(), part()
    want = jax_merge(tuple(map(jnp.asarray, state)),
                     tuple(map(jnp.asarray, new)), jnp.asarray(True))
    got = _merge(tuple(map(torch.from_numpy, state)),
                 tuple(map(torch.from_numpy, new)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    # a left-out step: the JAX merge leaves the state as it was, which is
    # what skipping it does
    kept = jax_merge(tuple(map(jnp.asarray, state)),
                     tuple(map(jnp.asarray, new)), jnp.asarray(False))
    for s, w in zip(state, kept):
        np.testing.assert_array_equal(s, np.asarray(w))
