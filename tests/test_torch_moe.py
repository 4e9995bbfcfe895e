"""The port's expert-parallel MoE layer (tilelang_mesh_tpu_torch/parallel/
moe.py) against the JAX package's (parallel/moe.py) on the same
numpy-seeded inputs.

One rank (group ``None``) is held against the JAX layer on a one-device
mesh; four gloo ranks on the CPU (``torch_gloo.run_ranks``, one process
a rank) against the JAX layer on four of the conftest's eight virtual
devices, at tests/test_parallel_ops.py:43-60's shapes and seed. The JAX
grouped GEMM runs in Pallas interpret mode; the port's on CPU tensors
runs its plain version (``torch.bmm`` in float32). Capacity factor 1.25
drops tokens, so matching outputs also mean matching kept sets: a pair
kept on one side and dropped on the other moves its token's row by a
whole expert's contribution.

Tolerance: 1e-4 normwise (max |port - jax| over max |jax|) against the
JAX layer: the same float32 arithmetic in another order (the JAX
grouped GEMM sits 3.4e-7 from float64 at these sizes). The reference's
own bounds (rtol 3e-2 / atol 3e-1, test_parallel_ops.py:60) are only an
upper limit.
"""

import numpy as np
import pytest
import torch

from tilelang_mesh_tpu_torch.parallel import moe
from torch_gloo import moe_rank, run_ranks

TOL = 1e-4
# tests/test_parallel_ops.py:48-54
T, D, F, E, TOP_K = 256, 64, 128, 8, 2
CFS = (1.25, 8.0)


def _inputs(seed=2):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((T, D)) * 0.5).astype(np.float32)
    wr = (rng.standard_normal((D, E)) * 0.5).astype(np.float32)
    w1 = (rng.standard_normal((E, D, F)) * 0.2).astype(np.float32)
    w2 = (rng.standard_normal((E, F, D)) * 0.2).astype(np.float32)
    return x, wr, w1, w2


def _normwise(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _jax_layer(n, arrays, **kw):
    import jax
    import jax.numpy as jnp

    from tilelang_mesh_tpu.parallel.moe import make_moe_layer
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:n]), ("ep",))
    layer = make_moe_layer(mesh, "ep", **kw)
    return np.asarray(layer(*map(jnp.asarray, arrays)))


def _port_layer(arrays, **kw):
    x, wr, w1, w2 = (torch.from_numpy(a) for a in arrays)
    return moe.make_moe_layer(None, **kw)(x, wr, w1, w2).numpy()


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The port's layer on four gloo ranks, at each capacity factor."""
    cases = [(TOP_K, cf, True, 1) for cf in CFS]
    ranks = run_ranks(moe_rank, 4, tmp_path_factory.mktemp("moe4"),
                      *_inputs(), cases)
    outs = {cf: np.concatenate([r["outs"][i][0] for r in ranks])
            for i, cf in enumerate(CFS)}
    return outs, ranks


@pytest.mark.parametrize("cf", CFS)
def test_one_rank_matches_jax(cf):
    arrays = _inputs()
    got = _port_layer(arrays, top_k=TOP_K, capacity_factor=cf)
    want = _jax_layer(1, arrays, top_k=TOP_K, capacity_factor=cf,
                      use_tile_kernel=True)
    assert got.shape == (T, D) and got.dtype == np.float32
    assert _normwise(got, want) <= TOL


@pytest.mark.parametrize("cf", CFS)
def test_four_ranks_match_jax(four_ranks, cf):
    want = _jax_layer(4, _inputs(), top_k=TOP_K, capacity_factor=cf,
                      use_tile_kernel=True)
    got = four_ranks[0][cf]
    assert got.shape == (T, D)
    assert _normwise(got, want) <= TOL


def test_capacity_drops_tokens_as_jax_does(four_ranks):
    """At 1.25 the layer drops pairs on both sides, and the same tokens
    lose both choices (all-zero rows)."""
    want = _jax_layer(4, _inputs(), top_k=TOP_K, capacity_factor=1.25,
                      use_tile_kernel=True)
    got = four_ranks[0][1.25]
    np.testing.assert_array_equal(np.abs(got).max(1) == 0,
                                  np.abs(want).max(1) == 0)
    full = four_ranks[0][8.0]
    assert _normwise(got, full) > 1e-2      # 1.25 really drops


def test_layers_match_dense_reference_without_drops(four_ranks):
    import jax.numpy as jnp

    from tilelang_mesh_tpu.parallel.moe import moe_reference as jax_ref
    arrays = _inputs()
    ref = moe.moe_reference(*(torch.from_numpy(a) for a in arrays),
                            TOP_K).numpy()
    assert _normwise(ref, np.asarray(jax_ref(*map(jnp.asarray, arrays),
                                             TOP_K))) <= TOL
    one = _port_layer(arrays, top_k=TOP_K, capacity_factor=8.0)
    assert _normwise(one, ref) <= TOL
    assert _normwise(four_ranks[0][8.0], ref) <= TOL


def test_weights_from_numpy_are_the_jax_shards(four_ranks):
    """Rank r's token and expert shards equal the JAX P("ep") shards on
    device r."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    x, wr, w1, w2 = _inputs()
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]), ("ep",))
    for name, full in (("x", x), ("w1", w1), ("w2", w2)):
        arr = jax.device_put(full, NamedSharding(mesh, PartitionSpec("ep")))
        shards = {s.device: np.asarray(s.data)
                  for s in arr.addressable_shards}
        for r, rank in enumerate(four_ranks[1]):
            np.testing.assert_array_equal(rank[name],
                                          shards[mesh.devices[r]])
        assert four_ranks[1][0][name].shape[0] == full.shape[0] // 4
    for rank in four_ranks[1]:
        np.testing.assert_array_equal(rank["wr"], wr)


def test_drops_are_deterministic_on_two_ranks(tmp_path):
    """tests/test_parallel_ops.py:63-80: top-1, capacity factor 0.5, the
    einsum expert path, twice on two ranks: bit-equal, finite, and equal
    to the JAX layer on two devices."""
    rng = np.random.default_rng(3)
    t, d, f, e = 64, 32, 64, 4
    arrays = (rng.standard_normal((t, d)).astype(np.float32),
              rng.standard_normal((d, e)).astype(np.float32),
              (rng.standard_normal((e, d, f)) * 0.2).astype(np.float32),
              (rng.standard_normal((e, f, d)) * 0.2).astype(np.float32))
    ranks = run_ranks(moe_rank, 2, tmp_path, *arrays, [(1, 0.5, False, 2)])
    a = np.concatenate([r["outs"][0][0] for r in ranks])
    b = np.concatenate([r["outs"][0][1] for r in ranks])
    np.testing.assert_array_equal(a, b)
    assert np.isfinite(a).all()
    want = _jax_layer(2, arrays, top_k=1, capacity_factor=0.5,
                      use_tile_kernel=False)
    assert _normwise(a, want) <= TOL


def test_einsum_path_matches_tile_path():
    arrays = _inputs()
    a = _port_layer(arrays, top_k=TOP_K, capacity_factor=1.25)
    b = _port_layer(arrays, top_k=TOP_K, capacity_factor=1.25,
                    use_tile_kernel=False)
    assert _normwise(a, b) <= TOL


def test_route_keeps_the_first_capacity_takers():
    """Every token picks expert 0 first: only the first C tokens keep
    slot 0, the rest drop to zero rows (no one_hot error), and the kept
    count is recorded."""
    t, c = 10, 4
    x = torch.ones((t, 2))
    wr = torch.tensor([[3.0, 0.0, 1.0], [3.0, 0.0, 1.0]])
    combine, dispatch = moe.route(x, wr, 2, c)
    assert combine.shape == (t, 3, c) and dispatch.dtype == x.dtype
    kept0 = dispatch[:, 0].sum(1)
    assert kept0.tolist() == [1.0] * c + [0.0] * (t - c)
    # slot 1 goes to expert 2 with places 0..9, of which 4 fit
    assert dispatch[:, 2].sum(1).tolist() == [1.0] * c + [0.0] * (t - c)
    assert dispatch[:, 1].sum() == 0
    assert int(dispatch.count_nonzero()) == 2 * c
    out = moe.moe_ffn_local(x, wr, torch.zeros((3, 2, 4)),
                            torch.zeros((3, 4, 2)), 2, c)
    assert out.shape == x.shape and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("dim,pref", [(1280, 128), (14336, 512), (20, 128),
                                      (7, 128), (5, 512), (1, 4)])
def test_pick_block_matches_jax(dim, pref):
    from tilelang_mesh_tpu.parallel.moe import _pick_block
    assert moe._pick_block(dim, pref) == _pick_block(dim, pref)
