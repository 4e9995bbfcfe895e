"""The port's block-sparse and seer attention
(tilelang_mesh_tpu_torch/ops/blocksparse_attention.py, seer_attention.py)
against the JAX package's on the same numpy-seeded inputs.

The JAX side runs as tests/test_blocksparse.py and
tests/test_sparse_attention.py run it (Pallas interpret mode on the
CPU); the port side runs on CPU tensors, i.e. the kernel's plain
PyTorch version. Tolerance 2e-2 (tests/test_blocksparse.py:22, which
absorbs the interpreter's bf16-like emulation of float32 products); a
row whose every cell is dead is exactly 0 on both sides; the seer mask
is integer-equal to JAX's. The CUDA kernel is held against the plain
version on the card by tests/test_torch_cuda.py.
"""

import importlib
import math
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tilelang_mesh_tpu_torch.carver import FLASH_KERNEL_TILES
from tilelang_mesh_tpu_torch.ops._build import CSRC

ref = importlib.import_module("tilelang_mesh_tpu.ops.blocksparse_attention")
port = importlib.import_module(
    "tilelang_mesh_tpu_torch.ops.blocksparse_attention")
ref_seer = importlib.import_module("tilelang_mesh_tpu.ops.seer_attention")
port_seer = importlib.import_module(
    "tilelang_mesh_tpu_torch.ops.seer_attention")

TOL = 2e-2


def mask_tile_instances(D):
    """The (block_M, block_N) pairs that csrc/attention_mma.cuh's
    mask_tiles builds at head_dim D, read from its source."""
    src = (CSRC / "attention_mma.cuh").read_text()
    body = src[src.index("int mask_tiles("):]
    body = body[:body.index("\n}\n")]
    by_d = {}
    for d, pairs in re.findall(
            r"(?:D == (\d+)\)|else)\s*return run_tile<([\d, ]+)>", body):
        n = [int(x) for x in pairs.split(",")]
        by_d[int(d) if d else None] = list(zip(n[::2], n[1::2]))
    return by_d.get(D, by_d[None])


def _qkv(B, H, S, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, S, D)).astype(np.float32)
            for _ in range(3)]


def _mask(kind, shape, seed):
    rng = np.random.default_rng(seed)
    if kind == "zeros":
        return np.zeros(shape, np.int32)
    m = rng.integers(0, 2, shape).astype(np.int32)
    if kind == "dead_rows":    # whole query blocks with no live cell
        m[..., ::3, :] = 0
    return m


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kind", ["random", "dead_rows", "zeros"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("block", [32, 128])
def test_forward_matches_jax(block, causal, kind):
    """Random, causal and all-zero masks in blocks of 32 (under the
    kernel's 64-row tiles) and 128; a query block whose cells are all
    dead is exactly 0 on both sides."""
    B, H, S, D = 1, 2, 256, 64
    q, k, v = _qkv(B, H, S, D, seed=block)
    m = _mask(kind, (B, H, S // block, S // block), seed=block + 1)
    want = ref.blocksparse_attention(*map(jnp.asarray, (q, k, v, m)),
                                     block_M=block, block_N=block,
                                     causal=causal)
    got = port.blocksparse_attention(*map(torch.from_numpy, (q, k, v, m)),
                                     block_M=block, block_N=block,
                                     causal=causal)
    assert got.dtype == torch.float32 and got.shape == (B, H, S, D)
    _close(got, want)
    _close(got, ref.blocksparse_reference(*map(jnp.asarray, (q, k, v, m)),
                                          block, block, causal=causal))
    dead = ~m.any(axis=-1).repeat(block, axis=-1)          # (B, H, S)
    assert not got.numpy()[dead].any()
    assert not np.asarray(want)[dead].any()
    if kind == "zeros":
        assert not got.any()


def test_rectangular_blocks_and_bfloat16():
    """block_M != block_N (64 x 32) in bfloat16, causal."""
    B, H, S, D, bm, bn = 1, 2, 128, 32, 64, 32
    q, k, v = _qkv(B, H, S, D, seed=3)
    m = _mask("random", (B, H, S // bm, S // bn), seed=4)
    m[..., np.arange(S // bm), 2 * np.arange(S // bm)] = 1
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(np.array(a, np.float32)).bfloat16()
                  for a in (jq, jk, jv))
    want = ref.blocksparse_attention(jq, jk, jv, jnp.asarray(m), block_M=bm,
                                     block_N=bn, causal=True)
    got = port.blocksparse_attention(tq, tk, tv, torch.from_numpy(m),
                                     block_M=bm, block_N=bn, causal=True)
    assert got.dtype == torch.bfloat16
    _close(got, want)


def test_all_ones_causal_is_causal_attention():
    """An all-ones mask under causal gives the port's plain causal
    attention."""
    fa = importlib.import_module("tilelang_mesh_tpu_torch.ops.flash_attention")
    q, k, v = map(torch.from_numpy, _qkv(1, 2, 128, 64, seed=5))
    ones = torch.ones((1, 2, 4, 4), dtype=torch.int32)
    got = port.blocksparse_attention(q, k, v, ones, block_M=32, block_N=32,
                                     causal=True)
    torch.testing.assert_close(got, fa.mha_fwd_plain(q, k, v, True, 0.125),
                               rtol=1e-5, atol=1e-5)


def test_factory_matches_jax():
    B, H, S, D, bm, bn = 1, 2, 128, 64, 64, 32
    q, k, v = _qkv(B, H, S, D, seed=6)
    m = _mask("random", (B, H, S // bm, S // bn), seed=7)
    sm = 1.0 / math.sqrt(D)
    want = ref.blocksparse_mha_kernel(B, H, S, S, D, bm, bn, sm, "float32")(
        *map(jnp.asarray, (q, k, v, m)))
    fn = port.blocksparse_mha_kernel(B, H, S, S, D, bm, bn, sm, "float32")
    _close(fn(*map(torch.from_numpy, (q, k, v, m))), want)


def test_value_errors_match_jax():
    q = np.zeros((1, 2, 128, 32), np.float32)
    for m, kw in ((np.zeros((1, 2, 2, 2), np.int32), dict(block_M=48)),
                  (np.zeros((1, 2, 2, 3), np.int32), dict(block_M=64,
                                                           block_N=64))):
        with pytest.raises(ValueError) as jerr:
            ref.blocksparse_attention(jnp.asarray(q), jnp.asarray(q),
                                      jnp.asarray(q), jnp.asarray(m), **kw)
        with pytest.raises(ValueError) as terr:
            port.blocksparse_attention(*map(torch.from_numpy, (q, q, q, m)),
                                       **kw)
        assert str(jerr.value).split()[:2] == str(terr.value).split()[:2]


# ------------------------------------------------------------------ seer --


@pytest.mark.parametrize("bm,bn,topk", [(32, 32, 2), (64, 32, 3),
                                        (32, 64, 8), (128, 128, 8)])
def test_seer_mask_is_jax_integer_for_integer(bm, bn, topk):
    """Random gates and gates with ties (values from a few levels, so the
    k-th largest is shared): the same int32 mask."""
    S = 512
    rng = np.random.default_rng(bm + bn + topk)
    shape = (2, 3, S // bm, S // bn)
    for gates in (rng.standard_normal(shape).astype(np.float32),
                  rng.integers(0, 3, shape).astype(np.float32)):
        want = np.asarray(ref_seer.seer_block_mask(jnp.asarray(gates), topk,
                                                   bm, bn))
        got = port_seer.seer_block_mask(torch.from_numpy(gates), topk, bm,
                                        bn)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bm,bn", [(32, 32), (64, 32)])
def test_seer_attention_matches_jax(bm, bn):
    B, H, S, D = 1, 2, 128, 32
    q, k, v = _qkv(B, H, S, D, seed=20)
    gates = np.random.default_rng(23).standard_normal(
        (B, H, S // bm, S // bn)).astype(np.float32)
    j = [jnp.asarray(a) for a in (q, k, v, gates)]
    t = [torch.from_numpy(a) for a in (q, k, v, gates)]
    want = ref_seer.seer_attention(*j, topk=2, block_M=bm, block_N=bn)
    got = port_seer.seer_attention(*t, topk=2, block_M=bm, block_N=bn)
    _close(got, want)
    _close(port_seer.seer_reference(*t, 2, bm, bn),
           ref_seer.seer_reference(*j, 2, bm, bn))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [16, 32, 48, 64, 128, 256])
@pytest.mark.parametrize("cells", [(128, 128), (64, 64), (32, 32), (40, 24),
                                   (16, 80), (100, 60), (192, 64), (64, 16)])
def test_blocksparse_tile_rule(D, cells, causal):
    """The tensor-core kernel's tile: an instance for the head_dim (the
    pairs the C source's mask_tiles builds: carver.FLASH_KERNEL_TILES
    with block_N 64), the first in its order of preference (by the
    causal flag) that divides both cell sides where one does, else one
    whose block_N divides the cells' where one does; None for a head_dim
    without an instance."""
    tile = port.blocksparse_tile(D, *cells, causal)
    if D not in FLASH_KERNEL_TILES:
        assert tile is None and D not in port.BLOCKSPARSE_TILES
        return
    tiles = port.BLOCKSPARSE_TILES[D][causal]
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
