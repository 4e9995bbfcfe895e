"""The port's MInference vertical-slash sparse attention
(tilelang_mesh_tpu_torch/ops/minference.py) against the JAX package's
(ops/minference.py) on the same numpy-seeded inputs.

The JAX kernel runs in Pallas interpret mode on the CPU, as
tests/test_sparse_attention.py:160 runs it; the port's on CPU tensors,
i.e. the kernel's plain version. Tolerance 2e-2, the JAX test's own;
``_build_masks`` integer for integer. The CUDA kernel is held against
the plain version on the card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tilelang_mesh_tpu.ops import minference as ref
from tilelang_mesh_tpu_torch import ops as port_ops
from tilelang_mesh_tpu_torch.carver import FLASH_KERNEL_TILES
from tilelang_mesh_tpu_torch.ops import minference as port

from test_torch_blocksparse import mask_tile_instances

TOL = 2e-2
_TYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}


def _inputs(B=1, H=2, S=256, D=32, nv=8, ns=3):
    """tests/test_sparse_attention.py:160-172: distinct columns, the main
    diagonal and ``ns`` other slashes per head."""
    rng = np.random.default_rng(40)
    q, k, v = (rng.standard_normal((B, H, S, D)).astype(np.float32)
               for _ in range(3))
    rng = np.random.default_rng(44)
    v_idx = np.stack([rng.choice(S, nv, replace=False)
                      for _ in range(B * H)]).reshape(B, H, nv)
    s_idx = np.stack([np.concatenate([[0], rng.choice(np.arange(1, S), ns,
                                                      replace=False)])
                      for _ in range(B * H)]).reshape(B, H, ns + 1)
    return q, k, v, v_idx.astype(np.int32), s_idx.astype(np.int32)


def _both(q, k, v, dtype):
    jt, tt = _TYPES[dtype]
    j = [jnp.asarray(a, jt) for a in (q, k, v)]
    return j, [torch.from_numpy(np.array(a, np.float32)).to(tt) for a in j]


# the JAX test's square blocks and a rectangular pair each way
BLOCKS = [(64, 64), (64, 32), (32, 64)]


@pytest.mark.parametrize("dtype", sorted(_TYPES))
@pytest.mark.parametrize("blocks", BLOCKS)
def test_vertical_slash_matches_jax(blocks, dtype):
    q, k, v, v_idx, s_idx = _inputs()
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v, dtype)
    want = ref.vertical_slash_sparse_attention(
        jq, jk, jv, jnp.asarray(v_idx), jnp.asarray(s_idx),
        block_M=blocks[0], block_N=blocks[1])
    before = dict(port.launches)
    got = port.vertical_slash_sparse_attention(
        tq, tk, tv, v_idx, torch.from_numpy(s_idx), block_M=blocks[0],
        block_N=blocks[1])
    assert port.launches == before          # CPU tensors launch nothing
    assert got.dtype == _TYPES[dtype][1]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("blocks", BLOCKS + [(16, 128), (128, 16)])
def test_build_masks_integer_equal(blocks):
    """The scatter / band construction gives the JAX package's vmask and
    block mask, integer for integer, also for ids out of range: columns
    below 0 or at S and past, slashes below 0 (which JAX counts for the
    cells whose range of i - j reaches them) and at S or past."""
    _, _, _, v_idx, s_idx = _inputs()
    odd_v = np.array([[[-1, 0, 300, 64], [255, 256, -64, 7]]], np.int32)
    odd_s = np.array([[[-5, -70, 300, 3], [0, -1, 255, 256]]], np.int32)
    for vi, si in ((v_idx, s_idx), (odd_v, odd_s)):
        want = ref._build_masks(jnp.asarray(vi), jnp.asarray(si), 256, 256,
                                *blocks)
        got = port._build_masks(torch.from_numpy(vi), torch.from_numpy(si),
                                256, 256, *blocks)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_diagonal_mask_and_rows_that_see_nothing():
    """A slash past S or below 0 matches nothing; a row with no slash
    and no column at or before it gives exactly 0, as the JAX kernel's
    ``l > 0 ? acc / l : 0``."""
    q, k, v, _, _ = _inputs(H=1)
    v_idx = np.array([[[200]]], np.int32)
    s_idx = np.array([[[5, -3, 256, 400]]], np.int32)
    dm = port.diagonal_mask(torch.from_numpy(s_idx), 256)
    assert dm.sum().item() == 1 and dm[0, 0, 5].item() == 1
    want = ref.vertical_slash_sparse_attention(
        *map(jnp.asarray, (q, k, v, v_idx, s_idx)))
    got = port.vertical_slash_sparse_attention(
        *map(torch.from_numpy, (q, k, v)), v_idx, s_idx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    assert bool((got[0, 0, :5] == 0).all())
    assert bool((got[0, 0, 5:] != 0).any(dim=-1).all())


def test_plain_version_takes_rows_in_chunks(monkeypatch):
    q, k, v, v_idx, s_idx = _inputs()
    t = [torch.from_numpy(a) for a in (q, k, v)]
    whole = port.vertical_slash_sparse_attention(*t, v_idx, s_idx)
    monkeypatch.setattr(port, "PLAIN_ROWS", 48)
    torch.testing.assert_close(
        port.vertical_slash_sparse_attention(*t, v_idx, s_idx), whole)


def test_factory_and_reference_match_jax():
    """vs_sparse_kernel with the JAX factory's arguments and operands
    (the slashes as indices, the masks from _build_masks), and the dense
    reference."""
    q, k, v, v_idx, s_idx = _inputs()
    vmask, bmask = ref._build_masks(jnp.asarray(v_idx), jnp.asarray(s_idx),
                                    256, 256, 64, 32)
    args = (1, 2, 256, 256, 32, s_idx.shape[-1], 64, 32, 0.2, "float32")
    ops = (q, k, v, np.array(vmask), s_idx, np.array(bmask))
    want = ref.vs_sparse_kernel(*args)(*map(jnp.asarray, ops))
    got = port.vs_sparse_kernel(*args)(*map(torch.from_numpy, ops))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    want = ref.vs_sparse_reference(*map(jnp.asarray, (q, k, v, v_idx,
                                                      s_idx)))
    got = port.vs_sparse_reference(*map(torch.from_numpy, (q, k, v, v_idx,
                                                           s_idx)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert port_ops.vertical_slash_sparse_attention is \
        port.vertical_slash_sparse_attention


def test_refusals():
    q, k, v, v_idx, s_idx = _inputs()
    t = [torch.from_numpy(a) for a in (q, k, v)]
    with pytest.raises(ValueError, match="divide"):
        port.vertical_slash_sparse_attention(*t, v_idx, s_idx, block_M=96)
    with pytest.raises(TypeError):
        port.vertical_slash_sparse_attention(t[0].double(), t[1], t[2],
                                             v_idx, s_idx)


@pytest.mark.parametrize("D", [16, 32, 48, 64, 128, 256])
@pytest.mark.parametrize("cells", [(64, 64), (64, 32), (32, 64), (16, 128),
                                   (40, 40), (128, 128), (100, 60)])
def test_vs_tile_rule(D, cells):
    """The tensor-core kernel's tile: an instance for the head_dim (the
    pairs the C source's mask_tiles builds: carver.FLASH_KERNEL_TILES
    with block_N 64), the first in order of preference that divides both
    cell sides where one does, else one whose block_N divides the cells'
    where one does; None for a head_dim without an instance."""
    tile = port.vs_tile(D, *cells)
    if D not in FLASH_KERNEL_TILES:
        assert tile is None and D not in port.VS_TILES
        return
    tiles = port.VS_TILES[D]
    assert sorted(tiles) == sorted(mask_tile_instances(D))
    assert sorted(tiles) == sorted(t for t in FLASH_KERNEL_TILES[D]
                                   if t[1] == 64)
    assert tile in tiles
    bM, bN = cells
    both = [t for t in tiles if bM % t[0] == 0 and bN % t[1] == 0]
    if both:
        assert tile == both[0]
    elif any(bN % t[1] == 0 for t in tiles):
        assert bN % tile[1] == 0
