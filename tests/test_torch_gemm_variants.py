"""The port's GEMM scheduling variants
(tilelang_mesh_tpu_torch/ops/gemm_variants.py) against the JAX package's
(ops/gemm_variants.py) on the same numpy-seeded inputs.

The JAX kernels run in Pallas interpret mode on the CPU, as
tests/test_gemm_variants.py runs them; the port's run on CPU tensors,
i.e. the kernels' plain versions. Tolerances: float32 rtol = atol = 1e-4,
the JAX package's own (tests/test_gemm_variants.py:24); bfloat16 and
float16 rtol = atol = 2e-2 (both round the same float32 sums once to the
output type; a sum that differs in its last float32 bits can land one
16-bit ulp apart). Block-sparse dead tiles are exactly 0. The stream-K
segments and the split-K plan must equal the JAX package's. The CUDA
kernels are held against the plain versions on the card by
tests/test_torch_cuda.py.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tilelang_mesh_tpu.layout import python_impl as ref_layout
from tilelang_mesh_tpu.ops import gemm_variants as ref
from tilelang_mesh_tpu_torch.ops import gemm_variants as port

_DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
           "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2),
           "float16": (jnp.float16, torch.float16, 2e-2)}


def _pair(shape, seed, dtype):
    """standard_normal * 0.1 as the JAX tests draw it, rounded to ``dtype``
    once: (jax array, torch tensor) with the same values."""
    jdt, tdt, _ = _DTYPES[dtype]
    x = jnp.asarray(np.random.default_rng(seed).standard_normal(shape) * 0.1,
                    jdt)
    return x, torch.from_numpy(np.array(x, np.float32)).to(tdt)


def _close(got, want, dtype):
    tol = _DTYPES[dtype][2]
    assert got.dtype == _DTYPES[dtype][1]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors run the plain versions: no kernel is launched."""
    before = dict(port.launches)
    yield
    assert port.launches == before


@pytest.mark.parametrize("dtype", list(_DTYPES))
@pytest.mark.parametrize("M,N,K,n_split", [(256, 256, 1024, 4),
                                           (128, 128, 384, 5),
                                           (1, 256, 1024, 8),
                                           (16, 192, 2816, 8)])
def test_splitk_matches_jax(dtype, M, N, K, n_split):
    """The JAX tests' shapes; K 384 with 5 asked splits takes 3; decode
    rows (1 and 16: the card's few-row path), K 2816 taking 2 of 8
    splits as the down product's K does."""
    ja, ta = _pair((M, K), 0, dtype)
    jb, tb = _pair((K, N), 1, dtype)
    want = ref.matmul_splitk(ja, jb, n_split=n_split)
    got = port.matmul_splitk(ta, tb, n_split=n_split)
    _close(got, want, dtype)
    f32 = port.matmul_splitk(ta, tb, n_split=n_split, out_dtype="float32")
    np.testing.assert_allclose(
        f32.numpy(), np.asarray(ref.matmul_splitk(ja, jb, n_split=n_split,
                                                  out_dtype="float32")),
        rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", list(_DTYPES))
@pytest.mark.parametrize("M,N,K,block_M,block_N,block_K", [
    (256, 384, 512, 128, 128, 128),
    # the card's TMA tiles past 128 (any block on the plain version)
    (256, 512, 512, 128, 256, 128), (512, 256, 384, 256, 128, 64)])
def test_streamk_matches_jax(dtype, M, N, K, block_M, block_N, block_K):
    ja, ta = _pair((M, K), 4, dtype)
    jb, tb = _pair((K, N), 5, dtype)
    blocks = dict(block_M=block_M, block_N=block_N, block_K=block_K)
    want = ref.matmul_streamk(ja, jb, n_programs=6, **blocks)
    _close(port.matmul_streamk(ta, tb, n_programs=6, **blocks), want, dtype)


@pytest.mark.parametrize("dtype", list(_DTYPES))
def test_gemv_matches_jax(dtype):
    N, K = 384, 512
    ja, ta = _pair((K,), 6, dtype)
    jb, tb = _pair((N, K), 7, dtype)
    got = port.gemv(ta, tb)
    assert tuple(got.shape) == (N,)
    _close(got, ref.gemv(ja, jb), dtype)


def _dense_mask(mask, bm, bn):
    return np.kron(mask, np.ones((bm, bn))) != 0


@pytest.mark.parametrize("dtype", list(_DTYPES))
@pytest.mark.parametrize("block", [128, 64])
def test_blocksparse_matches_jax(dtype, block):
    M = N = K = 256
    ja, ta = _pair((M, K), 8, dtype)
    jb, tb = _pair((K, N), 9, dtype)
    mask = np.random.default_rng(10).integers(
        0, 2, (M // block, N // block)).astype(np.int32)
    want = np.asarray(ref.blocksparse_matmul(
        ja, jb, jnp.asarray(mask), block_M=block, block_N=block), np.float32)
    got = port.blocksparse_matmul(ta, tb, torch.from_numpy(mask),
                                  block_M=block, block_N=block)
    _close(got, want, dtype)
    live = _dense_mask(mask, block, block)
    assert live.any() and (~live).any()
    assert not got.float().numpy()[~live].any()        # exactly 0
    assert np.abs(got.float().numpy()[live]).min() > 0


@pytest.mark.parametrize("dtype", list(_DTYPES))
@pytest.mark.parametrize("M,N,K,cells", [(512, 384, 256, (256, 128)),
                                         (320, 576, 128, (64, 192)),
                                         (192, 320, 128, (64, 64))])
def test_blocksparse_card_shapes_match_jax(dtype, M, N, K, cells):
    """The shapes and cells the card tests give the TMA kernel (cells of
    256 x 128 and 64 x 192, M and N off its 128 x 128 tile), its plain
    version against the JAX kernel; K a multiple of the JAX block_K."""
    bm, bn = cells
    ja, ta = _pair((M, K), 11, dtype)
    jb, tb = _pair((K, N), 12, dtype)
    mask = np.random.default_rng(13).integers(
        0, 2, (M // bm, N // bn)).astype(np.int32)
    want = np.asarray(ref.blocksparse_matmul(
        ja, jb, jnp.asarray(mask), block_M=bm, block_N=bn), np.float32)
    got = port.blocksparse_matmul(ta, tb, torch.from_numpy(mask),
                                  block_M=bm, block_N=bn)
    _close(got, want, dtype)
    live = _dense_mask(mask, bm, bn)
    assert live.any() and (~live).any()
    assert not got.float().numpy()[~live].any()        # exactly 0


def _blocks(source, macro):
    """The (TM, TN, TK) list of a csrc macro of X(TM, TN, TK) entries,
    read from its source, in order."""
    from tilelang_mesh_tpu_torch.ops._build import CSRC
    src = (CSRC / source).read_text()
    body = src[src.index(f"#define {macro}"):]
    body = body[:body.index("\n\n")]
    return [tuple(int(x) for x in t)
            for t in re.findall(r"X\((\d+), (\d+), (\d+)\)", body)]


@pytest.mark.parametrize("ctype", ["__nv_bfloat16", "__half"])
def test_blocksparse_tma_instance(ctype):
    """The TMA kernel is built once a 16-bit type, at 128 x 128 x 64 (a
    block of TL_SM90_BLOCKS, the one gm.matmul's all-ones comparison on
    the card uses), read from the C source."""
    from tilelang_mesh_tpu_torch.ops._build import CSRC
    src = (CSRC / "gemm_variants.cu").read_text()
    found = re.findall(rf"launch_blocksparse_tma<{ctype}, (\d+), (\d+), "
                       r"(\d+)>", src)
    assert found == [("128", "128", "64")]
    assert (128, 128, 64) in _blocks("gemm_sm90.cuh", "TL_SM90_BLOCKS")


@pytest.mark.parametrize("dtype", list(_DTYPES))
@pytest.mark.parametrize("M,N,K,ptrs", [
    (4096, 11008, 4096, (0, 0)), (4096, 11008, 4096, (256, 1024)),
    (4096, 11008, 4096, (8, 0)), (4096, 11008, 4096, (0, 2)),
    (4096, 11008, 4100, (0, 0)), (4096, 11004, 4096, (0, 0)),
    (192, 320, 200, (0, 0)), (0, 11008, 4096, (0, 0)),
    (4096, 0, 4096, (0, 0)), (4096, 11008, 0, (0, 0)),
    (1, 8, 8, (0, 0)), (4096, 11008, 4104, (0, 0)),
    (4096, 11008, 4096, (1024, 8))])
def test_blocksparse_path_by_type_and_alignment(dtype, M, N, K, ptrs):
    """bfloat16 / float16 with both bases and both row strides on 16
    bytes take the TMA kernel; float32, misaligned or empty operands the
    tile loop."""
    tma = dtype != "float32" and min(M, N, K) > 0 and K % 8 == 0 \
        and N % 8 == 0 and ptrs[0] % 16 == 0 and ptrs[1] % 16 == 0
    for dt in (dtype, _DTYPES[dtype][1]):
        assert port.blocksparse_path(M, N, K, dt, *ptrs) == \
            ("tma" if tma else "loop")


@pytest.mark.parametrize("n_tiles", [1, 7, 12, 344])
@pytest.mark.parametrize("k_iters", [1, 5, 32])
@pytest.mark.parametrize("n_programs", [1, 4, 6, 8, 264])
def test_streamk_segments_equal_jax(n_tiles, k_iters, n_programs):
    want = ref._streamk_segments(n_tiles, k_iters, n_programs)
    assert [tuple(s) for s in want] == \
        ref_layout.streamk_partition(n_tiles, k_iters, n_programs)
    assert port._streamk_segments(n_tiles, k_iters, n_programs) == \
        [tuple(s) for s in want]


@pytest.mark.parametrize("n_tiles,k_iters,n_programs", [
    (344, 32, 264), (7, 5, 4), (1, 1, 300), (12, 3, 5), (86, 43, 132)])
def test_streamk_programs_own_their_segments(n_tiles, k_iters, n_programs):
    """The card's kernel runs one block a program: the program table
    gives each program exactly the segments the planner made for it, in
    order, and each tile's run of segments."""
    nN = 2 if n_tiles % 2 == 0 else 1
    tables, first, prog = port._streamk_tables(
        n_tiles // nN * 128, nN * 128, k_iters * 128, n_programs, 128, 128,
        128, torch.device("cpu"))
    rows = [tuple(r) for r in tables.T.tolist()]
    total = n_tiles * k_iters
    per = -(-total // n_programs)
    for p in range(n_programs):
        want = port._streamk_segments(n_tiles, k_iters, n_programs)
        want = [s for s in want if p * per <= s[0] * k_iters + s[1]
                < (p + 1) * per]
        got = rows[prog[p]:prog[p + 1]] if p + 1 < len(prog) else []
        assert [(tm * nN + tn, k0, kl) for tm, tn, k0, kl in got] == want
    tile_of = [tm * nN + tn for tm, tn, _, _ in rows]
    for t in range(n_tiles):
        assert set(tile_of[first[t]:first[t + 1]]) == {t}


@pytest.mark.parametrize("K", [384, 1024, 4096, 11008])
@pytest.mark.parametrize("n_split", [1, 2, 4, 5, 8])
@pytest.mark.parametrize("block_K", [128, 256])
def test_split_plan_equals_jax(monkeypatch, K, n_split, block_K):
    """The split count and block_K the JAX wrapper hands its kernel."""
    seen = []

    def record(M, N, K_, n, bm, bn, bk, in_dtype, num_stages=2):
        seen.append((n, bk))
        return lambda a, b: jnp.zeros((n, M, N), jnp.float32)

    monkeypatch.setattr(ref, "splitk_kernel", record)
    a = jnp.zeros((8, K), jnp.float32)
    ref.matmul_splitk(a, jnp.zeros((K, 8), jnp.float32), n_split=n_split,
                      block_K=block_K)
    n, split_len, bk = port.splitk_plan(K, n_split, block_K)
    assert seen == [(n, bk)] and n * split_len == K


@pytest.mark.parametrize("M,N,K,n", [(128, 128, 512, 4), (1, 256, 1024, 8),
                                     (16, 192, 2816, 2)])
def test_splitk_kernel_partials_match_jax(M, N, K, n):
    ja, ta = _pair((M, K), 11, "float32")
    jb, tb = _pair((K, N), 12, "float32")
    want = ref.splitk_kernel(M, N, K, n, 128, 128, 128, "float32")(ja, jb)
    got = port.splitk_kernel(M, N, K, n, 128, 128, 128, "float32")(ta, tb)
    assert tuple(got.shape) == (n, M, N) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_streamk_kernel_partials_match_jax():
    M, N, K, bk = 256, 128, 384, 128
    segs = ref._streamk_segments(2, K // bk, 4)      # two tiles down M
    cols = [np.asarray(c, np.int32) for c in zip(*segs)]
    tm, tn = cols[0], np.zeros_like(cols[0])
    ja, ta = _pair((M, K), 13, "float32")
    jb, tb = _pair((K, N), 14, "float32")
    want = ref.streamk_kernel(M, N, K, len(segs), 128, 128, bk, "float32")(
        ja, jb, jnp.asarray(tm), jnp.asarray(tn), jnp.asarray(cols[1]),
        jnp.asarray(cols[2]))
    got = port.streamk_kernel(M, N, K, len(segs), 128, 128, bk, "float32")(
        ta, tb, torch.from_numpy(tm), torch.from_numpy(tn),
        torch.from_numpy(cols[1]), torch.from_numpy(cols[2]))
    assert tuple(got.shape) == (len(segs), 128, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_gemv_and_blocksparse_factories_match_jax():
    N, K = 256, 384
    ja, ta = _pair((1, K), 15, "bfloat16")
    jb, tb = _pair((N, K), 16, "bfloat16")
    want = ref.gemv_kernel(N, K, 128, 128, "bfloat16", "float32")(ja, jb)
    got = port.gemv_kernel(N, K, 128, 128, "bfloat16", "float32")(ta, tb)
    assert tuple(got.shape) == (1, N) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    M = 128
    jc, tc = _pair((M, K), 17, "float32")
    jd, td = _pair((K, N), 18, "float32")
    mask = np.array([[0, 1]], np.int32)
    want = ref.blocksparse_gemm_kernel(M, N, K, 128, 128, 128, "float32",
                                       "float32")(jc, jd, jnp.asarray(mask))
    got = port.blocksparse_gemm_kernel(M, N, K, 128, 128, 128, "float32",
                                       "float32")(tc, td,
                                                  torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    assert not got[:, :128].any()


def test_plain_versions_match_float64():
    """Ragged shapes the JAX kernels do not take: the plain versions
    against float64 numpy, 1e-5 normwise (float32 sums of 200 terms)."""
    rng = np.random.default_rng(19)
    a = rng.standard_normal((100, 200)).astype(np.float32)
    b = rng.standard_normal((200, 77)).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for got in (port.matmul_splitk(ta, tb, n_split=3),
                port.matmul_streamk(ta, tb, n_programs=5,
                                    block_M=25, block_N=7, block_K=8)):
        assert np.abs(got.numpy() - want).max() / np.abs(want).max() <= 1e-5
    v = rng.standard_normal(4097).astype(np.float32)
    m = rng.standard_normal((33, 4097)).astype(np.float32)
    got = port.gemv(torch.from_numpy(v), torch.from_numpy(m)).numpy()
    want = m.astype(np.float64) @ v.astype(np.float64)
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-5


def test_streamk_refuses_ragged_shapes():
    a, b = torch.zeros((256, 384)), torch.zeros((384, 256))
    with pytest.raises(ValueError):
        port.matmul_streamk(a[:200], b)                 # M % block_M
    with pytest.raises(ValueError):
        port.matmul_streamk(a[:, :300], b[:300])        # K % block_K
    with pytest.raises(ValueError):
        port.matmul_streamk(a, b[:, :100])              # N % block_N
    with pytest.raises(ValueError):
        port.matmul_streamk(a, b, n_programs=0)


def test_blocksparse_refuses_bad_masks():
    a, b = torch.zeros((256, 256)), torch.zeros((256, 256))
    with pytest.raises(ValueError):
        port.blocksparse_matmul(a, b, torch.ones((2, 3), dtype=torch.int32))
    with pytest.raises(ValueError):
        port.blocksparse_matmul(a, b, torch.ones((2, 2), dtype=torch.int32),
                                block_M=100)
    with pytest.raises(TypeError):
        port.blocksparse_matmul(a, b, torch.ones((2, 2)))
    # a bool mask is taken as its int32 values
    got = port.blocksparse_matmul(a + 1, b + 1,
                                  torch.tensor([[True, False],
                                                [False, False]]))
    assert float(got[0, 0]) == 256.0 and not got[:, 128:].any()


@pytest.mark.parametrize("dtype", [torch.float64, torch.int8,
                                   torch.float8_e4m3fn])
def test_variants_refuse_unported_types(dtype):
    a = torch.zeros((128, 128)).to(dtype)
    with pytest.raises(TypeError):
        port.matmul_splitk(a, a)
    with pytest.raises(TypeError):
        port.matmul_streamk(a, a)
    with pytest.raises(TypeError):
        port.gemv(a[0], a)
    with pytest.raises(TypeError):
        port.blocksparse_matmul(a, a, torch.ones((1, 1), dtype=torch.int32))


def test_variants_take_matmul_output_types():
    """float16 and float8 e4m3 outputs, rounded once from the f32 sums
    (512 is a float16 value and past e4m3's range: NaN)."""
    a = torch.full((128, 256), 0.5, dtype=torch.bfloat16)
    b = torch.full((256, 128), 4.0, dtype=torch.bfloat16)
    c16 = port.matmul_splitk(a, b, n_split=2, out_dtype=torch.float16)
    assert c16.dtype == torch.float16 and bool((c16 == 512).all())
    c8 = port.matmul_splitk(a, b, n_split=2, out_dtype=torch.float8_e4m3fn)
    assert c8.dtype == torch.float8_e4m3fn
    assert bool(torch.isnan(c8.float()).all())
    c16 = port.matmul_streamk(a, b, out_dtype=torch.float16)
    assert bool((c16 == 512).all())
    with pytest.raises(TypeError):
        port.matmul_splitk(a, b, out_dtype=torch.int32)


# -- the card's few-row path: its rule and its plan, on the CPU ----------

_THRESHOLD = port.SPLITK_STREAM_MAX_ROWS


@pytest.mark.parametrize("dtype", list(_DTYPES))
@pytest.mark.parametrize("M", [1, 16, 17, _THRESHOLD - 1, _THRESHOLD,
                               _THRESHOLD + 1, 128])
def test_splitk_path_by_rows(dtype, M):
    """Up to the threshold the weights are streamed once, past it the
    tile loop runs; at LLaMA-2-7B's decode widths every type is
    aligned."""
    want = "stream" if M <= _THRESHOLD else "tile"
    for K, N in ((4096, 11008), (11008, 4096)):
        assert port.splitk_path(M, N, K, dtype) == want
        assert port.splitk_path(M, N, K, _DTYPES[dtype][1], 256, 512) == want


@pytest.mark.parametrize("M,N,K,dtype,ptrs,want", [
    (16, 300, 1024, "bfloat16", (0, 0), "tile"),    # N off 16 bytes
    (16, 300, 1024, "float32", (0, 0), "stream"),   # 300 floats: 16 B
    (16, 512, 4100, "float16", (0, 0), "tile"),     # K off 16 bytes
    (16, 512, 4104, "float16", (0, 0), "stream"),
    (16, 512, 1024, "bfloat16", (8, 0), "tile"),    # a's base off
    (16, 512, 1024, "bfloat16", (0, 4), "tile"),    # b's base off
    (0, 512, 1024, "bfloat16", (0, 0), "tile"),
    (16, 512, 1024, "int8", (0, 0), "tile")])
def test_splitk_path_needs_16_byte_copies(M, N, K, dtype, ptrs, want):
    assert port.splitk_path(M, N, K, dtype, *ptrs) == want


def _ranges(K, n_ask, N, slots):
    """The K range of each block row p (split p // n_sub, sub-range p %
    n_sub) of the few-row plan, in the order the combine sums them."""
    n, L, _ = port.splitk_plan(K, n_ask)
    strips, n_sub, sub = port.splitk_stream_plan(N, n, L, slots)
    return n, L, strips, n_sub, sub, [
        (s * L + j * sub, min(s * L + (j + 1) * sub, (s + 1) * L))
        for s in range(n) for j in range(n_sub)]


@pytest.mark.parametrize("K,n_ask,taken", [(11008, 8, 2), (4096, 8, 8),
                                           (4096, 1, 1), (200, 4, 1),
                                           (384, 5, 3), (2816, 8, 2)])
@pytest.mark.parametrize("N", [4096, 11008, 300, 64, 8])
@pytest.mark.parametrize("slots", [528, 396, 132, 1])
def test_stream_plan_cuts_each_split_in_order(K, n_ask, taken, N, slots):
    """Every split cut into whole 64-row multiples, the sub-ranges in
    split-major order tiling [0, K) with none empty or across a split's
    end; at most one wave of ``slots`` blocks unless each split is one
    sub-range."""
    n, L, strips, n_sub, sub, ranges = _ranges(K, n_ask, N, slots)
    assert n == taken and strips == -(-N // 64)
    assert sub % 64 == 0 and n_sub == -(-L // sub)
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    assert all(lo < hi for lo, hi in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    for p, (lo, hi) in enumerate(ranges):
        s = p // n_sub
        assert s * L <= lo and hi <= (s + 1) * L
    assert strips * n * n_sub <= slots or n_sub == 1
    assert n * n_sub <= 65535


def test_stream_plan_at_the_decode_products():
    """On an H100 (132 SMs, four blocks an SM at 16 rows): the down
    product's 2 splits of 5504 cut into 4 sub-ranges of 1408 (512 blocks);
    the gate/up product's 8 splits of 512 kept whole (1376 blocks)."""
    assert port.splitk_stream_plan(4096, 2, 5504, 528) == (64, 4, 1408)
    assert port.splitk_stream_plan(11008, 8, 512, 528) == (172, 1, 512)


@pytest.mark.parametrize("M,N,K,n_ask,slots", [(16, 192, 2816, 8, 24),
                                               (1, 256, 1024, 8, 64),
                                               (3, 64, 704, 2, 40)])
def test_stream_sum_order_matches_the_plain_version(M, N, K, n_ask, slots):
    """The plan's partials (float32, one a block row) summed in (split,
    sub-range) order give the plain version's C, and each split's run of
    sub-ranges its partial Cp[s]: the orders the combine keeps for
    ``matmul_splitk`` and for the factory."""
    n, L, _, n_sub, _, ranges = _ranges(K, n_ask, N, slots)
    assert n_sub > 1
    _, ta = _pair((M, K), 15, "float32")
    _, tb = _pair((K, N), 16, "float32")
    parts = [ta[:, lo:hi] @ tb[lo:hi] for lo, hi in ranges]
    total = parts[0].clone()
    for x in parts[1:]:
        total += x
    np.testing.assert_allclose(
        total.numpy(), port.matmul_splitk(ta, tb, n_split=n_ask).numpy(),
        rtol=1e-5, atol=1e-5)
    want = port._splitk_partials_plain(ta, tb, n)
    for s in range(n):
        cp = parts[s * n_sub].clone()
        for x in parts[s * n_sub + 1:(s + 1) * n_sub]:
            cp += x
        np.testing.assert_allclose(cp.numpy(), want[s].numpy(), rtol=1e-5,
                                   atol=1e-5)


# -- stream-K's path rule and its programs, on the CPU --------------------


@pytest.mark.parametrize("dtype", list(_DTYPES))
@pytest.mark.parametrize("blocks", [(128, 128, 128), (128, 256, 64),
                                    (256, 128, 32), (128, 128, 192),
                                    (128, 128, 96), (128, 64, 128),
                                    (64, 64, 64), (256, 256, 64),
                                    (128, 128, 16), (128, 128, 48)])
def test_streamk_path_by_type_and_block(dtype, blocks):
    """bfloat16 / float16 at a TMA tile with block_K a multiple of 32 take
    the TMA kernel; float32, the other tiles and depths the loop."""
    bm, bn, bk = blocks
    tma = dtype != "float32" and (bm, bn) in port.STREAMK_TMA_TILES \
        and bk % 32 == 0
    for dt in (dtype, _DTYPES[dtype][1]):
        assert port.streamk_path(512, 11008, 4096, dt, *blocks) == \
            ("tma" if tma else "loop")


@pytest.mark.parametrize("M,N,K,ptrs,want", [
    (512, 11008, 4096, (0, 0), "tma"),
    (512, 11008, 4096, (256, 1024), "tma"),
    (512, 11008, 4096, (8, 0), "loop"),          # a's base off 16 bytes
    (512, 11008, 4096, (0, 2), "loop"),          # b's base off
    (512, 11008, 4100, (0, 0), "loop"),          # K: rows off 16 bytes
    (512, 11004, 4096, (0, 0), "loop"),          # N: rows off 16 bytes
    (0, 11008, 4096, (0, 0), "loop"), (512, 0, 4096, (0, 0), "loop"),
    (512, 11008, 0, (0, 0), "loop")])
def test_streamk_path_needs_aligned_operands(M, N, K, ptrs, want):
    assert port.streamk_path(M, N, K, torch.bfloat16, 128, 128, 128,
                             *ptrs) == want


class _OccupancyLib:
    """``gemm_variants``' occupancy entry of the tile loop: records its
    arguments and answers ``blocks``."""

    def __init__(self, blocks):
        self.calls = []
        outer = self

        class Fn:
            def __call__(self, *args):
                outer.calls.append(args[:-1])
                args[-1]._obj.value = blocks
                return 0

        self.tl_streamk_blocks_per_sm = Fn()


@pytest.mark.parametrize("dtype,blocks,a_ptr,want,want_calls", [
    (torch.bfloat16, (128, 128, 128), 0, 132, []),
    (torch.float16, (128, 256, 64), 0, 132, []),
    (torch.bfloat16, (256, 128, 96), 0, 132, []),
    (torch.bfloat16, (128, 128, 128), 4, 264, [(1,)]),
    (torch.float32, (128, 128, 128), 0, 264, [(0,)]),
    (torch.bfloat16, (64, 64, 64), 0, 264, [(1,)]),
    (torch.float16, (256, 256, 64), 0, 264, [(3,)])])
def test_streamk_programs_ask_the_kernel_of_the_call(monkeypatch, dtype,
                                                     blocks, a_ptr, want,
                                                     want_calls):
    """The co-resident blocks of the kernel the call will run: the TMA
    kernel's one an SM without asking, or the loop's occupancy entry
    with the type (a misaligned base included); times the card's SMs
    (the occupancy call and the card stubbed)."""
    from contextlib import nullcontext
    from types import SimpleNamespace

    from tilelang_mesh_tpu_torch.ops import _build
    lib = _OccupancyLib(2)
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: nullcontext())
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: SimpleNamespace(
                            multi_processor_count=132))
    bm, bn, bk = blocks
    got = port.streamk_programs("cuda", dtype, block_M=bm, block_N=bn,
                                block_K=bk, a_ptr=a_ptr)
    assert got == want
    assert lib.calls == want_calls


@pytest.mark.parametrize("blocks,slots,want", [
    ((128, 128, 128), 132, 128), ((128, 256, 128), 132, 128),
    ((256, 128, 128), 132, 128), ((128, 128, 128), 264, 256)])
def test_streamk_phase_programs_at_the_prefill(blocks, slots, want):
    """LLaMA-2-7B's 512-token gate/up (M 512, K 4096 -> N 11008): 128 of
    the TMA kernel's 132 slots at each of its tiles, 256 of the loop's
    264 (float32 at 128 x 128)."""
    assert port.streamk_phase_programs(512, 11008, 4096, *blocks,
                                       slots) == want


@pytest.mark.parametrize("M,N,K,bm,bn,bk,slots", [
    (512, 11008, 4096, 128, 128, 128, 132), (512, 11008, 4096, 256, 128,
                                             64, 132),
    (1024, 4096, 4096, 128, 256, 64, 132), (384, 640, 512, 128, 128, 128,
                                            7),
    (4096, 4096, 4096, 128, 128, 128, 264), (768, 11008, 4096, 128, 128,
                                             128, 132),
    (2176, 11008, 4096, 128, 128, 128, 132)])
def test_streamk_phase_programs_run_the_tile_rows_in_phase(M, N, K, bm, bn,
                                                           bk, slots):
    """At the count it gives (at most ``slots``, more than half of them)
    the plan's program p + j R / per runs tile row tm + j's copy of
    program p's segments: the same tile columns and k ranges, in the same
    order (R a tile row's iterations, per a program's share)."""
    n = port.streamk_phase_programs(M, N, K, bm, bn, bk, slots)
    nM, nN, k_it = M // bm, N // bn, K // bk
    total = nM * nN * k_it
    assert 2 * n > min(slots, total) and n <= slots
    per = -(-total // n)
    row = nN * k_it
    assert row % per == 0
    segs = port._streamk_segments(nM * nN, k_it, n)
    by_prog = {}
    for tile, k0, kl in segs:
        by_prog.setdefault(((tile * k_it + k0) // per), []).append(
            (tile, k0, kl))
    shift = row // per
    for p, runs in by_prog.items():
        if p + shift in by_prog:
            assert by_prog[p + shift] == [(t + nN, k0, kl)
                                          for t, k0, kl in runs]


@pytest.mark.parametrize("M,N,K,slots", [
    (128, 11008, 4096, 132),       # one tile row: nothing to align
    (512, 128, 128 * 43, 132),     # in phase: 4 programs of 132
    (256, 384, 640, 4),            # in phase: 2 programs of 4
    (32768, 11008, 4096, 132)])    # 256 tile rows on 132 slots
def test_streamk_phase_programs_keep_the_slots_otherwise(M, N, K, slots):
    assert port.streamk_phase_programs(M, N, K, 128, 128, 128, slots) == \
        slots


# ------------------------------------------------------------- GEMV paths --

@pytest.mark.parametrize("N,K,dtype,ptrs,sms,want", [
    (11008, 4096, "bfloat16", (0, 0), 132, "gemv_bulk"),
    (11008, 4096, "float32", (0, 0), 132, "gemv_bulk"),
    (32000, 4096, "float16", (256, 4096), 132, "gemv_bulk"),
    (4096, 11008, "bfloat16", (0, 0), 132, "gemv_bulk"),
    (132, 4096, "bfloat16", (0, 0), 132, "gemv_bulk"),   # a row a block
    (131, 4096, "bfloat16", (0, 0), 132, "gemv"),        # fewer rows
    (11008, 4096, "bfloat16", (2, 0), 132, "gemv"),      # a's base off
    (11008, 4096, "bfloat16", (0, 8), 132, "gemv"),      # b's base off
    (11008, 4097, "bfloat16", (0, 0), 132, "gemv"),      # rows off 16 B
    (11008, 4100, "float16", (0, 0), 132, "gemv"),
    (11008, 4100, "float32", (0, 0), 132, "gemv_bulk"),  # 16400 bytes
    (300, 40000, "float32", (0, 0), 132, "gemv"),        # a row too wide
    (100, 4096, "float32", (0, 0), 78, "gemv_bulk")])
def test_gemv_path_by_alignment_rows_and_card(N, K, dtype, ptrs, sms, want):
    """gemv_bulk needs both bases on 16 bytes, rows of a multiple of 16
    bytes, a row a block and a plan that fits; everything else takes the
    old kernel."""
    for dt in (dtype, _DTYPES[dtype][1]):
        assert port.gemv_path(N, K, dt, *ptrs, sms=sms) == want


@pytest.mark.parametrize("N,K,dtype,want", [
    (11008, 4096, "bfloat16", (528, 2, 2, 41000)),   # gate/up, 4 an SM
    (11008, 4096, "float32", (528, 1, 2, 49192)),
    (32000, 4096, "bfloat16", (528, 2, 2, 41000)),   # the LM head
    (4096, 11008, "bfloat16", (396, 1, 2, 66088)),   # down: 3 an SM fit
    (4096, 11008, "float32", (132, 1, 2, 132136)),   # one an SM fits
    (527, 4096, "float16", (396, 2, 2, 41000)),      # 4 an SM: a row short
    (132, 4096, "float16", (132, 1, 2, 24616))])     # a row a block
def test_gemv_bulk_plan_at_the_model_widths(N, K, dtype, want):
    """blocks, rows a stage, stages and shared memory on 132 SMs: the most
    blocks an SM up to GEMV_BULK_BLOCKS_PER_SM that give each a row and
    fit two stages; a stage the whole rows of GEMV_BULK_STAGE_BYTES."""
    assert tuple(port.gemv_bulk_plan(N, K, dtype, 132)) == want


@pytest.mark.parametrize("N,K,dtype,sms", [
    (11008, 4096, torch.bfloat16, 132),     # gate/up: 4 blocks an SM
    (11008, 4096, torch.float32, 132),
    (32000, 4096, torch.float32, 132),      # the LM head
    (4096, 11008, torch.float32, 132),      # a 44 KB row: one block an SM
    (4096, 11008, torch.bfloat16, 132),     # three an SM
    (1000, 512, torch.float16, 132),        # 32 rows a stage, spans of 1-2
    (133, 256, torch.float32, 132),         # a row a block, one more
    (527, 4096, torch.float16, 132),        # 4 an SM a row short
    (11008, 4100, torch.float32, 132),      # a row past the stage bytes
    (20001, 1000, torch.bfloat16, 114),
    (100, 4096, torch.float32, 78)])
def test_gemv_bulk_spans_cover_every_row_once(N, K, dtype, sms):
    """The kernel's walk, block by block and stage by stage, as
    csrc/gemv.cu computes it from the plan: each block owns one
    contiguous span of N // blocks or one more rows, the spans tile
    0 .. N in order, each stage holds ``rows`` rows (the last of a span
    fewer), and the shared memory fits a block and the blocks an SM."""
    plan = port.gemv_bulk_plan(N, K, dtype, sms)
    row = K * torch.empty((), dtype=dtype).element_size()
    assert plan.blocks % sms == 0 and plan.blocks <= N
    per_sm = plan.blocks // sms
    assert plan.smem <= min(232448, 228 * 1024 // per_sm - 1024)
    assert plan.smem == row + plan.stages * plan.rows * row \
        + 8 * (2 * plan.stages + 1)
    base, extra = divmod(N, plan.blocks)
    seen = []
    for blk in range(plan.blocks):
        n0 = blk * base + min(blk, extra)
        span = base + (blk < extra)
        assert n0 == len(seen)
        for st in range(-(-span // plan.rows)):
            nr = min(plan.rows, span - st * plan.rows)
            assert 1 <= nr <= plan.rows
            seen += range(n0 + st * plan.rows, n0 + st * plan.rows + nr)
    assert seen == list(range(N))


def test_gemv_bulk_smem_matches_the_source():
    """gemv_bulk_plan's shared memory is the C entry's: csrc/gemv.cu's
    bulk_smem formula and gemm_sm90.cuh's kSmemOptin, which tl_gemv
    holds a plan to (else the rule picks a plan tl_gemv refuses)."""
    csrc = Path(port.__file__).parents[1] / "csrc"
    optin = re.search(r"constexpr int kSmemOptin = (\d+);",
                      (csrc / "gemm_sm90.cuh").read_text())
    assert optin and int(optin.group(1)) == port._SMEM_BLOCK_MAX
    src = (csrc / "gemv.cu").read_text()
    body = re.search(r"size_t bulk_smem\(int K, int esize, int rows,\s*"
                     r"int stages\) \{\s*return (.*?);", src, re.S)
    assert body and "smem > tl_sm90::kSmemOptin" in src
    formula = " ".join(body.group(1).replace("(size_t)", "").split())
    for K, esize, rows, stages in [(4096, 2, 2, 2), (11008, 4, 1, 2),
                                   (512, 2, 32, 3), (4100, 4, 1, 8)]:
        assert eval(formula, {}, dict(K=K, esize=esize, rows=rows,
                                      stages=stages)) == \
            port.gemv_bulk_smem(K, esize, rows, stages)


def test_gemv_kernel_counters_reset_together():
    """kernel_launches names both GEMV kernels and reset_launches zeroes
    it with the launch counters; a CPU call counts nothing."""
    assert set(port.kernel_launches) == {"gemv", "gemv_bulk"}
    port.kernel_launches["gemv_bulk"] += 3
    port.reset_launches()
    assert set(port.kernel_launches.values()) == {0}
    a = torch.ones(64)
    port.gemv(a, torch.ones((8, 64)))
    assert set(port.kernel_launches.values()) == {0}
