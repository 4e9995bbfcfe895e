"""The bench yardsticks of the port (tilelang_mesh_tpu_torch/ops/
yardsticks.py) against the hand-written Pallas kernels of bench.py on
the same numpy-seeded inputs.

The JAX kernels run in Pallas interpret mode: ``pallas_call`` is wrapped
with ``interpret=True`` for the test (bench.py looks it up when the
kernel is built), and ``cfg_w4a16``'s ``hand_pallas`` closure is reached
by a spy on ``bench._pick_best``, which receives the candidate list. The
port's callables run on CPU tensors, i.e. the kernels' plain versions.
Tolerances, normwise (max |port - JAX| over max |JAX|): 1e-2 for a
bfloat16 output (both sum the same exact products in f32 and round once;
a sum at a rounding boundary flips one ulp, 2**-8), 1e-5 for float32 from
float32 inputs (the same f32 products summed in another order), 1e-6 for
fp8 e4m3 -> float32 (products of e4m3 values are exact in f32; only the
order of the sum differs). The CUDA kernels are held against the plain
versions on the card by tests/test_torch_cuda.py.
"""

import functools
import pathlib
import re
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from tilelang_mesh_tpu_torch.carver import KERNEL_BLOCKS
from tilelang_mesh_tpu_torch.ops import yardsticks as ys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


@pytest.fixture
def interpret(monkeypatch):
    """bench.py's pallas_call in interpret mode; returns the module."""
    import bench
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    return bench


def _normwise(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _operand(x, dtype):
    """x (float32 numpy) in ``dtype``: the JAX array and a torch tensor
    of the same values (fp8 as the same e4m3 bytes)."""
    if dtype == "float8_e4m3fn":
        q = x.astype(ml_dtypes.float8_e4m3fn)
        return (jnp.asarray(q),
                torch.from_numpy(q.view(np.uint8)).view(torch.float8_e4m3fn))
    j = jnp.asarray(x, jnp.dtype(dtype))
    return j, torch.from_numpy(np.array(j, np.float32)).to(
        getattr(torch, dtype))


@pytest.mark.parametrize("dtype,out,tol", [("bfloat16", None, 1e-2),
                                           ("float8_e4m3fn", "float32", 1e-6),
                                           ("float32", None, 1e-5)])
@pytest.mark.parametrize("blk", [(128, 128, 32), (128, 256, 64)],
                         ids=lambda b: "x".join(map(str, b)))
def test_hand_matmul_matches_jax(interpret, dtype, out, tol, blk):
    M, N, K = 256, 256, 512
    rng = np.random.default_rng(0)
    a = (rng.standard_normal((M, K)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((K, N)) * 0.1).astype(np.float32)
    (ja, ta), (jb, tb) = _operand(a, dtype), _operand(b, dtype)
    want = np.asarray(interpret._hand_pallas_matmul(
        M, N, K, *blk, dtype, out)(ja, jb), np.float32)
    before = dict(ys.launches)
    got = ys.hand_matmul(M, N, K, *blk, dtype=dtype, out_dtype=out)(ta, tb)
    assert ys.launches == before             # CPU tensors launch nothing
    assert got.dtype == getattr(torch, out or dtype)
    assert tuple(got.shape) == (M, N)
    assert _normwise(got.float().numpy(), want) <= tol


def _w4a16_candidates(bench, monkeypatch, M, N, K, gs):
    """cfg_w4a16's baseline candidates ``{name: (build, args)}``, from a
    spy on ``_pick_best`` that times nothing (it returns each sweep's
    first candidate)."""
    seen = {}

    def spy(cands, check, what, rounds=1):
        seen[what] = {name: (build, args) for name, build, args in cands}
        name, build, args = cands[0]
        return name, build(), args

    monkeypatch.setattr(bench, "_pick_best", spy)
    bench.cfg_w4a16(M, N, K, gs=gs)
    return seen["w4a16 baseline"]


def _torch(x, dtype=None):
    t = torch.from_numpy(np.array(np.asarray(x, np.float32) if dtype
                                  else np.asarray(x)))
    return t.to(dtype) if dtype else t


@pytest.mark.parametrize("gs", [64, 128])
@pytest.mark.parametrize("tile", [(128, 128), (128, 256)],
                         ids=lambda t: "x".join(map(str, t)))
def test_hand_w4a16_matches_jax(interpret, monkeypatch, gs, tile):
    M = N = K = 256
    cands = _w4a16_candidates(interpret, monkeypatch, M, N, K, gs)
    build, (alo, ahi, packed, s3) = cands["hand-pallas-fused"]
    want = np.asarray(build(*tile)(alo, ahi, packed, s3), np.float32)
    args = (_torch(alo, torch.bfloat16), _torch(ahi, torch.bfloat16),
            _torch(packed), _torch(s3))
    got = ys.hand_w4a16(M, N, K, gs, *tile)(*args)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (M, N)
    assert _normwise(got.float().numpy(), want) <= 1e-2
    # the plain version on A's halves as strided views of A's rows
    a = torch.cat([args[0], args[1]], dim=1)
    view = ys.hand_w4a16(M, N, K, gs, *tile)(a[:, :K // 2], a[:, K // 2:],
                                             *args[2:])
    assert torch.equal(view, got)


def test_hand_matmul_refuses_other_blocks_and_shapes():
    with pytest.raises(ValueError, match="instances"):
        ys.hand_matmul(1024, 1024, 1024, 256, 256, 512)     # the TPU's
    with pytest.raises(ValueError, match="instances"):
        ys.hand_matmul(1024, 1024, 1024, 64, 128, 32)
    with pytest.raises(ValueError, match="multiple"):
        ys.hand_matmul(1000, 1024, 1024, 128, 128, 32)
    with pytest.raises(ValueError, match="multiple"):
        ys.hand_matmul(1024, 1024, 1000, 128, 128, 32)
    with pytest.raises(TypeError):
        ys.hand_matmul(256, 256, 256, 128, 128, 32, "bfloat16", "float16")
    with pytest.raises(TypeError):
        ys.hand_matmul(256, 256, 256, 128, 128, 32, "int8")
    fn = ys.hand_matmul(256, 256, 256, 128, 128, 32)
    x = torch.zeros((256, 256), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="want"):
        fn(x.float(), x.float())
    with pytest.raises(ValueError, match="want"):
        fn(x[:128], x)


def test_hand_w4a16_refuses_other_tiles_and_groups():
    with pytest.raises(ValueError, match="instances"):
        ys.hand_w4a16(1024, 1024, 1024, 512, 512, 512)      # the TPU's
    with pytest.raises(ValueError, match="K step"):
        ys.hand_w4a16(1024, 1024, 1024, 32, 128, 128)
    with pytest.raises(ValueError, match="divide"):
        ys.hand_w4a16(1024, 1024, 1024, 384, 128, 128)
    with pytest.raises(ValueError, match="multiple"):
        ys.hand_w4a16(1000, 1024, 1024, 128, 128, 128)
    fn = ys.hand_w4a16(256, 256, 256, 64, 128, 128)
    a = torch.zeros((256, 128), dtype=torch.bfloat16)
    p = torch.zeros((128, 256), dtype=torch.uint8)
    with pytest.raises(ValueError, match="want"):
        fn(a, a, p, torch.zeros((2, 1, 256)))


def test_kernel_instances_are_the_carver_space():
    """The CUDA sources instantiate exactly KERNEL_BLOCKS (and their
    (bm, bn) pairs for #43): #42 and #15's TMA path at the blocks of
    gemm_sm90.cuh's TL_SM90_BLOCKS."""
    csrc = ROOT / "tilelang_mesh_tpu_torch" / "csrc"
    sm90 = (csrc / "gemm_sm90.cuh").read_text()
    w4 = (csrc / "yardstick_w4a16.cu").read_text()
    blocks = re.search(r"#define TL_SM90_BLOCKS\(X\)(.*?)\n\n", sm90,
                       re.S).group(1)
    for src in ("yardstick_gemm.cu", "gemm.cu"):
        assert "TL_SM90_BLOCKS(" in (csrc / src).read_text() or \
            "dispatch_tma(" in (csrc / src).read_text()
    tiles = re.search(r"#define YARDSTICK_TILES\(X\)(.*?)\n\n", w4,
                      re.S).group(1)
    assert {tuple(map(int, m)) for m in re.findall(
        r"X\((\d+), (\d+), (\d+)\)", blocks)} == set(KERNEL_BLOCKS)
    assert {tuple(map(int, m)) for m in re.findall(
        r"X\((\d+), (\d+)\)", tiles)} == set(ys.W4A16_TILES)
    assert re.search(rf"constexpr int BK = {ys.W4A16_BK};", w4)
