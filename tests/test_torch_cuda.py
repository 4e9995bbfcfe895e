"""The port's CUDA kernels on the card (marker ``cuda``).

Each kernel is held against its plain PyTorch version on the same CUDA
inputs, and the serving engine and the flagship model on the card
against the same code on CPU tensors (the plain versions). These tests
need an NVIDIA card and skip without one; they import neither JAX nor
the JAX package, so they run where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: paged and contiguous decode rtol = atol = 1e-4 — the kernel
and the plain version do the same float32 arithmetic (bfloat16 K/V are
widened to float32 in both) in another order. MLA decode, normwise:
1e-5 in float32 (same arithmetic, another order); 2e-2 in bfloat16,
where both round p to bf16 before p @ ckv and a 1e-7 difference at a
rounding boundary flips one bf16 ulp. Attention kernels, normwise
(max |kernel - plain| over max |plain|): 1e-5 in float32 (same
arithmetic, another order); 2e-2 in bfloat16, where both round P and dS
to bf16 before their products but a 1e-7 difference at a rounding
boundary flips one bf16 ulp; two calls of an attention kernel give the
same bits (no atomics). The model on the card against the model on
the CPU: 1e-4 normwise (float32, different kernels and libraries).
Grouped GEMMs, normwise: 1e-5 in float32 (the same float32 sums in
another order); 1e-2 in bfloat16, where an output rounded to bf16 may
flip one ulp (2**-8). The MoE layer on the card against the same layer
on the CPU: 1e-4 normwise (float32; the routing must keep the same
pairs). The GEMM and the low-bit GEMMs, normwise: 1e-5 for a float32
output (float32 sums in another order; fp8 and int4 x bf16 products are
exact in float32); 1e-2 for a bfloat16 output (one bf16 ulp, 2**-8, at
a rounding boundary); an fp8 e4m3 output within one e4m3 ulp (1/8 of
the value, or 2**-9 below the normal range) elementwise; the int4
unpack bit for bit (the same float32 multiply and rounding); w4a8 1e-6
(exact int32 sums, the same float32 epilogue in the same order); an
int8 x int8 -> int32 product equal to its plain version (exact sums);
a float16 output 1e-2 as bfloat16's. An fp8 e4m3 output past the
format's range is NaN at the plain version's positions. The GEMM
variants (split-K, stream-K, GEMV, block-sparse) at the same normwise
bounds as the GEMM: their float32 partials and sums are those of the
plain version in another order within a partial; block-sparse dead
tiles exactly 0. The sequence-mixing kernels (Mamba2 SSD, Gated DeltaNet,
linear attention, retention), normwise: 1e-4 in float32 (the same
float32 arithmetic in another order; linear attention's backward the
same kernel on flipped operands); 1e-2 in bfloat16, where both round to
bf16 at the same points but a 1e-7 difference at a rounding boundary
flips one bf16 ulp (2**-8), and bf16 linear attention's q @ state runs
as q @ hi + q @ lo on the tensor cores (about 2**-17 of the state).
float16 through the attention, decode, MLA, grouped and w4a16 kernels
at the bounds of bfloat16 (2e-2 attention and MLA, 1e-2 a GEMM output;
decode 1e-4, float32 arithmetic on widened K/V). Vertical-slash and NSA
attention at the attention kernels' bounds, with rows that see nothing
exactly 0. BitNet: the int8 x ternary GEMM equal to its plain version (exact int32
sums); the int8 activation quantiser the same bytes (Q and S: the same
IEEE divide and rounding); BitLinear and the BitFFN block on the card
equal to the same module's reference mode on the card (the same int32
sums, the same torch epilogue). Grouped-query attention at the
attention kernels' bounds above, and its autograd on the card against
the same Function on the CPU at 1e-4 normwise. Packed varlen attention
at the attention kernels' bounds, with M compared where l > 0 (a row that
sees no key has l = 0, acc = 0 and M = -1e30 in both), and its autograd
on the card against the CPU at 1e-4 normwise. Sink attention and
block-sparse attention at the attention kernels' bounds, with rows whose
every cell is dead exactly 0; the sink autograd on the card against the
CPU at 1e-4 normwise. The row softmax, normwise: 1e-5 for a float32
output (the same float32 shift, exp2 and divide; the row sum in another
order), 1e-2 for a bfloat16 output (one ulp, 2**-8, at a rounding
boundary); NaN rows at the plain version's positions. DSA: the lightning
indexer normwise 1e-5 in float32 (the same float32 products in another
order) and 1e-2 in bfloat16 and float16 (exact products of the 16-bit
inputs, float32 sums in another order), -inf at the same places; the
top-k selector's ids equal; sparse MLA at the attention kernels' bounds,
its LSE 1e-5 of the largest, a row with no valid id exactly O = 0 and
LSE -6.931472e29; the pipeline and a fine-tuning step's gradients on the
card against the CPU at 1e-4 normwise. The bench yardsticks: the GEMM
(#42) at the GEMM's bounds above; on integer operands in [-4, 4], whose
f32 sums are exact in any order, bit-equal to its plain version at every
instance; the w4a16 kernel (#43) 1e-2 normwise (bf16 output), and on
integer activations with power-of-two scales (every product and sum
exact) bit-equal.
"""

import dataclasses
import importlib
import math
import re

import numpy as np
import pytest
import torch

from tilelang_mesh_tpu_torch.carver import FLASH_KERNEL_TILES
from tilelang_mesh_tpu_torch.models import bitnet as bitnet_model
from tilelang_mesh_tpu_torch.ops import _build
from tilelang_mesh_tpu_torch.ops import bitnet
from tilelang_mesh_tpu_torch.ops import dequant_gemm as dqg
from tilelang_mesh_tpu_torch.ops import flash_decoding as fd
from tilelang_mesh_tpu_torch.ops import gemm as gm
from tilelang_mesh_tpu_torch.ops import gemm_variants as gv
from tilelang_mesh_tpu_torch.ops import gqa_bwd as gb
from tilelang_mesh_tpu_torch.ops import grouped_gemm as gg
from tilelang_mesh_tpu_torch.ops import gdn
from tilelang_mesh_tpu_torch.ops import mamba2
from tilelang_mesh_tpu_torch.ops import mla
from tilelang_mesh_tpu_torch.ops import quantize_act as qa
from tilelang_mesh_tpu_torch.ops import yardsticks as ys
from tilelang_mesh_tpu_torch.resilience.errors import KernelLaunchError
from tilelang_mesh_tpu_torch.resilience import faults
from tilelang_mesh_tpu_torch.resilience.retry import global_breaker

fa = importlib.import_module("tilelang_mesh_tpu_torch.ops.flash_attention")
la = importlib.import_module("tilelang_mesh_tpu_torch.ops.linear_attention")
gqa = importlib.import_module("tilelang_mesh_tpu_torch.ops.gqa")
vl = importlib.import_module(
    "tilelang_mesh_tpu_torch.ops.flash_attention_varlen")
sink = importlib.import_module("tilelang_mesh_tpu_torch.ops.attention_sink")
smx = importlib.import_module("tilelang_mesh_tpu_torch.ops.softmax")
bsa = importlib.import_module(
    "tilelang_mesh_tpu_torch.ops.blocksparse_attention")
seer = importlib.import_module("tilelang_mesh_tpu_torch.ops.seer_attention")
mi = importlib.import_module("tilelang_mesh_tpu_torch.ops.minference")
nsa = importlib.import_module("tilelang_mesh_tpu_torch.ops.nsa")

pytestmark = pytest.mark.cuda

TOL = 1e-4
ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "mode")
    global_breaker().reset()
    faults._overrides.clear()
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, b, h, d, ps, pp, n_pages, dtype, seed=0):
    rng = np.random.default_rng(seed)

    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev)

    q = t((b, h, 1, d))
    kp = t((h, n_pages * ps, d)).to(dtype)
    vp = t((h, n_pages * ps, d)).to(dtype)
    table = torch.from_numpy(np.stack([
        rng.choice(n_pages, pp, replace=False) for _ in range(b)]).astype(
            np.int32)).to(dev)
    return q, kp, vp, table


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("ps,pp,n_split", [(16, 8, 1), (16, 8, 8),
                                           (8, 2, 2), (128, 4, 4)])
def test_kernel_matches_plain(cuda, dtype, d, ps, pp, n_split):
    q, kp, vp, table = _case(cuda, 3, 4, d, ps, pp, 40, dtype)
    before = fd.launches["paged_decode"]
    got = fd.paged_decode_partials(q, kp, vp, table, ps, n_split,
                                   d ** -0.5)
    want = fd.paged_decode_partials_plain(q, kp, vp, table, ps, n_split,
                                          d ** -0.5)
    torch.cuda.synchronize()
    assert fd.launches["paged_decode"] == before + 1
    for g, w in zip(got, want):
        assert g.is_cuda and bool(torch.isfinite(g).all())
        torch.testing.assert_close(g, w, rtol=TOL, atol=TOL)


def test_wrapper_raises_on_mixed_devices(cuda):
    q, kp, vp, table = _case(cuda, 2, 4, 64, 16, 4, 8, torch.float32)
    with pytest.raises(ValueError):
        fd.paged_decode_partials(q.cpu(), kp, vp, table, 16, 1, 0.125)
    with pytest.raises(ValueError):
        fd.paged_decode_partials(q[..., :48].contiguous(), kp[..., :48],
                                 vp[..., :48], table, 16, 1, 0.125)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("s,n_split", [(512, 4), (1000, 8), (77, 1)])
def test_contiguous_kernel_matches_plain(cuda, dtype, d, s, n_split):
    """decode.cu on contiguous K/V and on the gather strategy's
    transposed view, ragged chunks included (1000 / 8 = 125 rows)."""
    q, k, v = (torch.randn(shape, generator=torch.Generator(
        device=cuda).manual_seed(i), device=cuda)
        for i, shape in enumerate(((3, 4, 1, d), (3, 4, s, d),
                                   (3, 4, s, d))))
    k, v = k.to(dtype), v.to(dtype)
    kt = k.transpose(1, 2).contiguous().transpose(1, 2)   # (B, H, S, D)
    vt = v.transpose(1, 2).contiguous().transpose(1, 2)   # row-strided
    for kk, vv in ((k, v), (kt, vt)):
        before = fd.launches["decode"]
        got = fd.decode_partials(q, kk, vv, n_split, d ** -0.5)
        want = fd.decode_partials_plain(q, kk, vv, n_split, d ** -0.5)
        torch.cuda.synchronize()
        assert fd.launches["decode"] == before + 1
        for g, w in zip(got, want):
            assert g.is_cuda and bool(torch.isfinite(g).all())
            torch.testing.assert_close(g, w, rtol=TOL, atol=TOL)


def test_gather_strategy_matches_walk(cuda):
    """flash_decode_paged (gather + decode.cu) against
    flash_decode_paged_pool (paged_decode.cu) on the same pages."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn((2, 4, 1, 128), generator=g, device=cuda)
    pages = [torch.randn((12, 16, 4, 128), generator=g, device=cuda)
             for _ in range(2)]
    table = torch.stack([torch.randperm(12, generator=g, device=cuda)[:8]
                         for _ in range(2)]).to(torch.int32)
    fd.reset_launches()
    gather = fd.flash_decode_paged(q, *pages, table)
    walk = fd.flash_decode_paged_pool(
        q, *(fd.pages_to_hmajor(p) for p in pages), table, 16)
    torch.cuda.synchronize()
    assert fd.launches == {"decode": 1, "paged_decode": 1}
    torch.testing.assert_close(gather, walk, rtol=TOL, atol=TOL)


MLA_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [2, 8, 128])
@pytest.mark.parametrize("dc,dr", mla.KERNEL_WIDTHS)
@pytest.mark.parametrize("s,n_split", [(512, 4), (1000, 8), (77, 1)])
def test_mla_kernel_matches_plain(cuda, dtype, h, dc, dr, s, n_split):
    """mla_decode.cu against its plain version; ragged chunks (125 and
    77 keys, no multiple of the 32-key tile) and head groups cut by H."""
    g = torch.Generator(device=cuda).manual_seed(h + s)
    qc, qr = (torch.randn((2, h, w), generator=g, device=cuda).to(dtype)
              for w in (dc, dr))
    rows = torch.randn((2, s, dc + dr), generator=g, device=cuda).to(dtype)
    ckv, kpe = rows[..., :dc], rows[..., dc:]      # row-strided views
    before = mla.launches["mla_decode"]
    got = mla.mla_decode_partials(qc, qr, ckv, kpe, n_split, 0.1)
    want = mla.mla_decode_partials_plain(qc, qr, ckv, kpe, n_split, 0.1)
    torch.cuda.synchronize()
    assert mla.launches["mla_decode"] == before + 1
    assert _normwise(got, want) <= MLA_TOL[dtype]
    out = mla.mla_decode(qc, qr, ckv, kpe, n_split=n_split)
    assert out.dtype == dtype and tuple(out.shape) == (2, h, dc)
    assert _normwise(out.float(), mla.mla_decode_reference(
        qc, qr, ckv, kpe).float()) <= MLA_TOL[dtype]


def test_decode_kernels_refuse_loudly(cuda):
    """A grid the card refuses (65536 batches > gridDim.z) raises
    KernelLaunchError; a width without an instance raises ValueError."""
    z = torch.zeros((65536, 1, 1, 64), device=cuda)
    with pytest.raises(KernelLaunchError):
        fd.decode_partials(z, z, z, 1, 0.125)
    qc = torch.zeros((65536, 1, 32), device=cuda)
    qr = torch.zeros((65536, 1, 16), device=cuda)
    with pytest.raises(KernelLaunchError):
        mla.mla_decode_partials(qc, qr, qc, qr, 1, 0.1)
    with pytest.raises(ValueError):
        mla.mla_decode_partials(qc[:1, :, :24], qr[:1], qc[:1, :, :24],
                                qr[:1], 1, 0.1)


# tie-free seeds of tests/test_torch_serving.py (H=2, D=64, PS=8)
STREAM = [(32, 4, 13), (24, 3, 20), (16, 4, 12), (40, 3, 14), (32, 3, 13),
          (20, 4, 12)]


def _serve(device, step_timeout_ms=None):
    from tilelang_mesh_tpu_torch import serving
    alloc = serving.PagedKVAllocator(n_pages=96, page_size=8, heads=2,
                                     head_dim=64, device=device)
    wl = serving.FlashDecodeWorkload(alloc, batch_buckets=(1, 2, 4),
                                     page_buckets=(2, 4),
                                     prefix_cache=False)
    eng = serving.ServingEngine(wl, step_timeout_ms=step_timeout_ms)
    eng.warmup()
    reqs = [eng.submit(context_tokens=c, new_tokens=n, seed=s)
            for c, n, s in STREAM]
    eng.run()
    return reqs, wl


@pytest.mark.parametrize("step_timeout_ms", [None, 60_000.0])
def test_engine_on_card_matches_engine_on_cpu(cuda, step_timeout_ms):
    """The whole serving path on the card (the step on the watchdog's
    worker thread too) against the same path on CPU tensors."""
    fd.reset_launches()
    on_card, wl = _serve(None, step_timeout_ms)
    assert fd.launches["paged_decode"] == wl.dispatches > 0
    assert wl.allocator.kp.is_cuda
    on_cpu, _ = _serve("cpu")
    assert [r.outcome for r in on_card] == ["result"] * len(STREAM)
    assert [r.generated for r in on_card] == [r.generated for r in on_cpu]
    for a, b in zip(on_card, on_cpu):
        np.testing.assert_allclose(a.result, b.result, rtol=TOL, atol=TOL)
    assert wl.allocator.in_use == 0 and wl.allocator.leak_check() == {}


def _serve_mla(device):
    from tilelang_mesh_tpu_torch import serving
    alloc = serving.PagedKVAllocator(n_pages=96, page_size=8, heads=1,
                                     head_dim=48, device=device)
    wl = serving.MLADecodeWorkload(alloc, heads=2, latent_dim=32,
                                   rope_dim=16, prefix_cache=False)
    eng = serving.ServingEngine(wl, name="mla")
    eng.warmup()
    # tie-free seeds of tests/test_torch_serving_mla.py
    reqs = [eng.submit(context_tokens=c, new_tokens=n, seed=s)
            for c, n, s in ((32, 4, 1), (24, 3, 4), (16, 4, 14), (40, 3, 3),
                            (32, 3, 1), (20, 4, 14))]
    eng.run()
    return reqs, wl


def test_mla_engine_on_card_matches_engine_on_cpu(cuda, monkeypatch):
    monkeypatch.setenv("TL_TPU_SERVE_VOCAB", "64")
    mla.reset_launches()
    on_card, wl = _serve_mla(None)
    assert mla.launches["mla_decode"] == wl.dispatches > 0
    assert wl.allocator.kp.is_cuda
    on_cpu, _ = _serve_mla("cpu")
    assert [r.outcome for r in on_card] == ["result"] * 6
    assert [r.generated for r in on_card] == [r.generated for r in on_cpu]
    for a, b in zip(on_card, on_cpu):
        np.testing.assert_allclose(a.result, b.result, rtol=TOL, atol=TOL)
    assert wl.allocator.in_use == 0 and wl.allocator.leak_check() == {}


# ---------------------------------------------------------------------------
# attention kernels (csrc/flash_attention.cu, csrc/gqa_bwd.cu)
# ---------------------------------------------------------------------------


def _normwise(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.is_cuda and g.dtype == w.dtype and g.shape == w.shape
        assert bool(torch.isfinite(g).all())
    return max(float((g.float() - w.float()).abs().max())
               / max(float(w.float().abs().max()), 1e-30)
               for g, w in zip(got, want))


def _attn_inputs(dev, B, Hq, Hkv, Sq, Sk, D, dtype, causal, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    q, do = rnd(B, Hq, Sq, D), rnd(B, Hq, Sq, D)
    k, v = rnd(B, Hkv, Sk, D), rnd(B, Hkv, Sk, D)
    sm = 1.0 / math.sqrt(D)
    group = Hq // Hkv
    acc, m, l = fa.mha_fwd_partial_plain(
        q, k.repeat_interleave(group, 1), v.repeat_interleave(group, 1),
        causal, sm)
    o = (acc / l[..., None]).to(dtype)
    delta = (do.float() * o.float()).sum(-1)
    return q, k, v, do, m + torch.log2(l), delta, sm


ATTN_CASES = [  # (B, Hq, Hkv, Sq, Sk) at each D
    (2, 2, 2, 192, 192),      # whole tiles
    (1, 3, 3, 77, 77),        # ragged, under one tile
    (1, 2, 2, 100, 260),      # Sq != Sk, ragged
    (1, 2, 2, 260, 100),
]


# beyond one 64-row tile of the tensor-core kernels, neither S a multiple
# of 64, group 4
BWD_CASES = ATTN_CASES + [(2, 4, 2, 150, 150), (1, 4, 2, 64, 200),
                          (1, 8, 2, 200, 330), (1, 8, 2, 330, 200)]


def _fwd_ops(Hq, Hkv):
    """(module, forward, partial, their plain versions) of the attention
    forward: the MHA wrappers when Hq == Hkv, else the GQA ones (the same
    kernel)."""
    if Hq == Hkv:
        return fa, "mha_fwd", fa.mha_fwd_plain, fa.mha_fwd_partial_plain
    return gqa, "gqa_fwd", gqa.gqa_fwd_plain, gqa.gqa_fwd_partial_plain


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("shape", BWD_CASES)
def test_forward_kernels_match_plain(cuda, dtype, causal, d, shape):
    """The forward and the partial kernel at the default tile, MHA and
    GQA groups 2 and 4 (float32 on CUDA cores, bfloat16 and float16 on
    the tensor cores)."""
    q, k, v, _, _, _, sm = _attn_inputs(cuda, *shape, d, dtype, causal)
    mod, name, plain, partial_plain = _fwd_ops(shape[1], shape[2])
    before = dict(mod.launches)
    o = getattr(mod, name)(q, k, v, causal, sm)
    part = getattr(mod, name + "_partial")(q, k, v, causal, sm)
    torch.cuda.synchronize()
    assert mod.launches[name] == before[name] + 1
    assert mod.launches[name + "_partial"] == before[name + "_partial"] + 1
    assert o.dtype == dtype and all(t.dtype == torch.float32 for t in part)
    assert _normwise(o, plain(q, k, v, causal, sm)) <= ATTN_TOL[dtype]
    assert _normwise(part, partial_plain(q, k, v, causal, sm)) \
        <= ATTN_TOL[dtype]


FWD_TILES = [(d, tile) for d, tiles in FLASH_KERNEL_TILES.items()
             for tile in tiles]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d,tile", FWD_TILES)
@pytest.mark.parametrize("shape", [(1, 2, 2, 200, 330), (1, 8, 2, 330, 200)])
def test_forward_kernel_tiles_match_plain(cuda, dtype, causal, d, tile,
                                          shape):
    """Every (block_M, block_N) instance of the tensor-core forward,
    through the factories that name it (``mha_fwd_kernel`` or
    ``gqa_fwd_kernel``, and the GQA partial factory), launches once and
    agrees with the plain version."""
    B, Hq, Hkv, Sq, Sk = shape
    q, k, v, _, _, _, sm = _attn_inputs(cuda, *shape, d, dtype, causal)
    mod, name, plain, partial_plain = _fwd_ops(Hq, Hkv)
    before = dict(mod.launches)
    if Hq == Hkv:
        o = fa.mha_fwd_kernel(B, Hq, Sq, Sk, d, *tile, causal, sm,
                              dtype)(q, k, v)
        part = fa.mha_fwd_partial(q, k, v, causal, sm, tile=tile)
    else:
        o = gqa.gqa_fwd_kernel(B, Hq, Hkv, Sq, Sk, d, *tile, causal, sm,
                               dtype)(q, k, v)
        part = gqa.gqa_fwd_partial_kernel(B, Hq, Hkv, Sq, Sk, d, *tile,
                                          causal, sm, dtype)(q, k, v)
    torch.cuda.synchronize()
    assert mod.launches[name] == before[name] + 1
    assert mod.launches[name + "_partial"] == before[name + "_partial"] + 1
    assert _normwise(o, plain(q, k, v, causal, sm)) <= ATTN_TOL[dtype]
    assert _normwise(part, partial_plain(q, k, v, causal, sm)) \
        <= ATTN_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_forward_default_tile_is_the_first_instance(cuda, dtype, d):
    """No tile (``tl_mha_fwd``) launches FLASH_KERNEL_TILES[d][0]: the
    same bits; a tile the kernel lacks is refused by the C entry."""
    q, k, v, _, _, _, sm = _attn_inputs(cuda, 1, 4, 2, 150, 270, d, dtype,
                                        True)
    first = FLASH_KERNEL_TILES[d][0]
    assert torch.equal(gqa.gqa_fwd(q, k, v, True, sm),
                       gqa.gqa_fwd(q, k, v, True, sm, tile=first))
    for a, b in zip(fa.mha_fwd_partial(q[:, :2], k, v, True, sm),
                    fa.mha_fwd_partial(q[:, :2], k, v, True, sm,
                                       tile=first)):
        assert torch.equal(a, b)
    with pytest.raises(KernelLaunchError):
        fa.mha_fwd(q[:, :2], k, v, True, sm, tile=(96, 48))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal", [False, True])
def test_forward_kernels_are_deterministic(cuda, dtype, causal):
    """Two calls give the same bits: O, and the partial's acc, m and l."""
    q, k, v, _, _, _, sm = _attn_inputs(cuda, 1, 8, 2, 330, 200, 128,
                                        dtype, causal)
    first = (gqa.gqa_fwd(q, k, v, causal, sm),
             *gqa.gqa_fwd_partial(q, k, v, causal, sm))
    second = (gqa.gqa_fwd(q, k, v, causal, sm),
              *gqa.gqa_fwd_partial(q, k, v, causal, sm))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("shape", BWD_CASES)
def test_backward_kernels_match_plain(cuda, dtype, causal, d, shape):
    """dK/dV and dQ, MHA, group 2 and group 4 (float32 on CUDA cores,
    bfloat16 and float16 on the tensor cores)."""
    args = _attn_inputs(cuda, *shape, d, dtype, causal)
    q, k, v, do, lse2, delta, sm = args
    before = dict(gb.launches)
    dkdv = gb.gqa_bwd_dkdv(q, k, v, do, lse2, delta, causal, sm)
    dq = gb.gqa_bwd_dq(q, k, v, do, lse2, delta, causal, sm)
    torch.cuda.synchronize()
    assert gb.launches["gqa_bwd_dkdv"] == before["gqa_bwd_dkdv"] + 1
    assert gb.launches["gqa_bwd_dq"] == before["gqa_bwd_dq"] + 1
    assert _normwise(dkdv, gb.gqa_bwd_dkdv_plain(q, k, v, do, lse2, delta,
                                                 causal, sm)) \
        <= ATTN_TOL[dtype]
    assert _normwise(dq, gb.gqa_bwd_dq_plain(q, k, v, do, lse2, delta,
                                             causal, sm)) <= ATTN_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal", [False, True])
def test_backward_kernels_are_deterministic(cuda, dtype, causal):
    """Two calls give the same bits: every output element is written
    once by one block, no atomics."""
    args = _attn_inputs(cuda, 1, 8, 2, 200, 330, 128, dtype, causal)
    first = (*gb.gqa_bwd_dkdv(*args[:6], causal, args[6]),
             gb.gqa_bwd_dq(*args[:6], causal, args[6]))
    second = (*gb.gqa_bwd_dkdv(*args[:6], causal, args[6]),
              gb.gqa_bwd_dq(*args[:6], causal, args[6]))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_attention_autograd_on_card_matches_cpu(cuda):
    """flash_attention's kernel backward on the card against the same
    Function on CPU tensors (the plain versions)."""
    q, k, v, do, _, _, _ = _attn_inputs("cpu", 2, 2, 2, 130, 130, 64,
                                        torch.float32, True)
    grads = []
    for dev in ("cpu", cuda):
        leaves = [t.detach().to(dev).requires_grad_() for t in (q, k, v)]
        fa.flash_attention(*leaves, causal=True).backward(do.to(dev))
        grads.append([t.grad.cpu() for t in leaves])
    for a, b in zip(*grads):
        assert _normwise(b.cuda(), a.cuda()) <= ATTN_TOL[torch.float32]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_refused_launch_raises(cuda, dtype):
    """A grid the card refuses (65536 batches > gridDim.z) comes back as
    a KernelLaunchError, never as a silent no-op."""
    q = torch.zeros((65536, 1, 1, 16), device=cuda, dtype=dtype)
    lse2 = torch.zeros((65536, 1, 1), device=cuda)
    for call in (lambda: fa.mha_fwd(q, q, q, True, 0.25),
                 lambda: fa.mha_fwd_partial(q, q, q, True, 0.25),
                 lambda: gb.gqa_bwd_dkdv(q, q, q, q, lse2, lse2, True, 0.25),
                 lambda: gb.gqa_bwd_dq(q, q, q, q, lse2, lse2, True, 0.25)):
        with pytest.raises(KernelLaunchError) as e:
            call()
        assert e.value.kind == "deterministic"
    with pytest.raises(ValueError):     # no head_dim=48 instance
        fa.mha_fwd(*(torch.zeros((1, 1, 8, 48), device=cuda),) * 3, True,
                   0.1)


def test_model_on_card_matches_model_on_cpu(cuda):
    """The tiny config's forward and one training step on the card
    against the same weights and tokens on the CPU."""
    from tilelang_mesh_tpu_torch.entry import TINY
    from tilelang_mesh_tpu_torch.models import (forward, init_params,
                                                make_train_step,
                                                params_from_jax,
                                                params_to_numpy)
    cpu = init_params(TINY, torch.Generator().manual_seed(0), device="cpu")
    card = params_from_jax(params_to_numpy(cpu), TINY)     # default: card
    assert card.embed.is_cuda
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        0, TINY.vocab, (8, TINY.max_seq + 1)))
    fa.reset_launches()
    with torch.no_grad():
        got = forward(card, tok[:2, :-1].cuda())
    assert fa.launches["mha_fwd"] == TINY.n_layers
    assert _normwise(got, forward(cpu, tok[:2, :-1]).cuda()) <= 1e-4
    gb.reset_launches()
    losses = []
    for model, t in ((cpu, tok), (card, tok.cuda())):
        init, step = make_train_step(TINY, lr=1e-3)
        _, _, loss = step(model, init(model), t)
        losses.append(float(loss))
    assert fa.launches["mha_fwd_partial"] == TINY.n_layers
    assert gb.launches == {"gqa_bwd_dkdv": TINY.n_layers,
                           "gqa_bwd_dq": TINY.n_layers}
    assert losses[1] == pytest.approx(losses[0], rel=1e-5)
    for a, b in zip(cpu.parameters(), card.parameters()):
        torch.testing.assert_close(b.detach().cpu(), a.detach(), rtol=5e-2,
                                   atol=5e-3)
    cfg = dataclasses.replace(TINY, use_flash=False)
    with torch.no_grad():
        dense = forward(card, tok[:2, :-1].cuda(), cfg)
    assert _normwise(dense, forward(card, tok[:2, :-1].cuda())) <= 1e-4


GEMM_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _randn(dev, shape, dtype, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dev).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 77, 1000, 150), (2, 128, 256, 128),
                                   (1, 300, 19, 7), (4, 1, 1, 1),
                                   (2, 129, 64, 257)])
def test_grouped_gemm_matches_plain(cuda, dtype, shape):
    """Ragged M, N and K (K = 1000 is no multiple of 16 or 32; 19 and 7
    take the predicated, unaligned path)."""
    E, M, K, N = shape
    x = _randn(cuda, (E, M, K), dtype, 0)
    w = _randn(cuda, (E, K, N), dtype, 1)
    before = gg.launches["grouped_gemm"]
    got = gg.grouped_matmul(x, w)
    torch.cuda.synchronize()
    assert gg.launches["grouped_gemm"] == before + 1
    assert _normwise(got, gg.grouped_matmul_plain(x, w)) <= GEMM_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("sizes,K,N", [((77, 0, 300, 1), 1000, 150),
                                       ((130, 0, 64, 257), 128, 128),
                                       ((5, 0, 9), 19, 7)])
def test_varlen_grouped_gemm_matches_plain(cuda, dtype, trans_b, sizes, K,
                                           N):
    """Groups of every size, one empty; rows past a group's end belong
    to the next group and must not be written by this one's blocks."""
    a = _randn(cuda, (sum(sizes), K), dtype, 2)
    b = _randn(cuda, (len(sizes), N, K) if trans_b else (len(sizes), K, N),
               dtype, 3)
    before = gg.launches["varlen_grouped_gemm"]
    got = gg.varlen_grouped_matmul(a, b, sizes, trans_b=trans_b)
    torch.cuda.synchronize()
    assert gg.launches["varlen_grouped_gemm"] == before + 1
    want = gg.varlen_grouped_matmul_plain(a, b, sizes, trans_b)
    assert _normwise(got, want) <= GEMM_TOL[dtype]


def test_grouped_gemm_refuses_mixed_devices(cuda):
    x = torch.zeros((2, 4, 8), device=cuda)
    with pytest.raises(ValueError):
        gg.grouped_matmul(x, torch.zeros((2, 8, 3)))
    with pytest.raises(ValueError):
        gg.varlen_grouped_matmul(torch.zeros((4, 8)),
                                 torch.zeros((2, 8, 3), device=cuda), (2, 2))


def test_moe_layer_on_card_matches_cpu(cuda):
    """The layer at small widths (T 256, d 64, f 128, E 8, top-2,
    capacity factor 0.75, so C = 48 against ~64 pairs an expert: drops)
    on the card, two grouped launches, against the same layer on CPU
    tensors, keeping the same number of pairs."""
    from tilelang_mesh_tpu_torch.parallel import moe
    rng = np.random.default_rng(2)
    arrays = [(rng.standard_normal(s) * sc).astype(np.float32)
              for s, sc in (((256, 64), 0.5), ((64, 8), 0.5),
                            ((8, 64, 128), 0.2), ((8, 128, 64), 0.2))]
    layer = moe.make_moe_layer(None, top_k=2, capacity_factor=0.75)
    cpu = [torch.from_numpy(a) for a in arrays]
    card = [t.to(cuda) for t in cpu]
    want = layer(*cpu)
    before = gg.launches["grouped_gemm"]
    got = layer(*card)
    torch.cuda.synchronize()
    assert gg.launches["grouped_gemm"] == before + 2
    kept = [int(moe.route(x, wr, 2, 48)[1].count_nonzero())
            for x, wr, _, _ in (cpu, card)]
    assert kept[0] == kept[1] < 512
    assert _normwise(got, want.to(cuda)) <= 1e-4


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_on_card_matches_cpu(cuda, causal):
    """make_ring_attention on one rank (group None): the partial kernel
    once, then the layer's normalisation, against the same layer on CPU
    tensors (the plain partial)."""
    from tilelang_mesh_tpu_torch.parallel import make_ring_attention
    q, k, v, _, _, _, _ = _attn_inputs("cpu", 1, 2, 2, 300, 300, 64,
                                       torch.float32, causal, seed=5)
    layer = make_ring_attention(None, causal=causal)
    want = layer(q, k, v)
    before = fa.launches["mha_fwd_partial"]
    got = layer(q.to(cuda), k.to(cuda), v.to(cuda))
    torch.cuda.synchronize()
    assert fa.launches["mha_fwd_partial"] == before + 1
    assert _normwise(got, want.to(cuda)) <= ATTN_TOL[torch.float32]


# matmul's dtype pairs: every input type with each output it takes
MM_PAIRS = [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
            (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
            (torch.float8_e4m3fn, torch.float32),
            (torch.float8_e4m3fn, torch.bfloat16),
            (torch.float8_e4m3fn, torch.float8_e4m3fn),
            (torch.float16, torch.float16), (torch.float16, torch.float32),
            (torch.bfloat16, torch.float16), (torch.float32, torch.float16),
            (torch.float16, torch.float8_e4m3fn),
            (torch.float32, torch.float8_e4m3fn),
            (torch.bfloat16, torch.float8_e4m3fn),
            (torch.float8_e4m3fn, torch.float16)]


def _close(got, want):
    """The tolerance of the output's type (module docstring)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.float8_e4m3fn:
        g, w = got.float(), want.float()
        assert bool(((g - w).abs() <= 0.125 * w.abs() + 2 ** -9).all())
    else:
        tol = 1e-5 if got.dtype == torch.float32 else 1e-2   # bf16, f16
        assert _normwise(got, want) <= tol


def _operand(dev, shape, dtype, seed):
    scale = 0.3 if dtype == torch.float8_e4m3fn else 1.0
    return (_randn(dev, shape, torch.float32, seed) * scale).to(dtype)


# matmul_path's answer -> the counters one float matmul call adds
_PATH_LAUNCHES = {"tma": ("matmul_tma",), "ffma": ("matmul_ffma",),
                  "loop": ("matmul",)}


def _matmul_counted(a, b, trans_A, trans_B, out, relu, block=(None,) * 3):
    """gm.matmul(...) and the path it took: exactly one launch of that
    path's kernel (and one fp8 widening for fp8 operands on the TMA path),
    none of the others."""
    M, N, K = gm._shapes(a, b, trans_A, trans_B)
    blk = gm.kernel_block(M, N, K, a.dtype, *block)
    path = gm.matmul_path(M, N, K, a.dtype, trans_A, trans_B, a.data_ptr(),
                          b.data_ptr(), out, blk)
    before = dict(gm.launches)
    got = gm.matmul(a, b, trans_A, trans_B, out_dtype=out, relu=relu,
                    block_M=block[0], block_N=block[1], block_K=block[2])
    torch.cuda.synchronize()
    want = set(_PATH_LAUNCHES[path])
    if path == "tma" and a.dtype == torch.float8_e4m3fn:
        want.add("fp8_widen")
    assert {k: gm.launches[k] - before[k] for k in before} == {
        k: int(k in want) for k in before}
    return got, path


@pytest.mark.parametrize("pair", MM_PAIRS, ids=lambda p: "-".join(
    str(d).split(".")[1] for d in p))
@pytest.mark.parametrize("trans_A,trans_B", [(False, False), (False, True),
                                             (True, False), (True, True)])
@pytest.mark.parametrize("shape", [(77, 150, 1000), (300, 7, 19), (1, 1, 1),
                                   (256, 128, 384)])
@pytest.mark.parametrize("relu", [False, True])
def test_matmul_matches_plain(cuda, pair, trans_A, trans_B, shape, relu):
    """Every dtype pair and transpose, ReLU or not; M, N, K off the tile
    (K = 1000 and 19 take no 16-byte path for some types, 7 and 1 none):
    one launch of the path matmul_path names (the odd shapes take the
    tile loop; 256 x 128 x 384 the TMA path, or for float32 the FFMA
    tile when untransposed)."""
    (dt, out), (M, N, K) = pair, shape
    a = _operand(cuda, (K, M) if trans_A else (M, K), dt, 7)
    b = _operand(cuda, (N, K) if trans_B else (K, N), dt, 8)
    got, _ = _matmul_counted(a, b, trans_A, trans_B, out, relu)
    _close(got, gm.matmul_plain(a, b, trans_A, trans_B, out, relu))


# float inputs of the TMA path with each output they take
TMA_PAIRS = [(torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
             (torch.float16, torch.float16), (torch.float16, torch.float32),
             (torch.float8_e4m3fn, torch.float32),
             (torch.float8_e4m3fn, torch.float8_e4m3fn),
             (torch.bfloat16, torch.float8_e4m3fn)]


@pytest.mark.parametrize("pair", TMA_PAIRS, ids=lambda p: "-".join(
    str(d).split(".")[1] for d in p))
@pytest.mark.parametrize("trans_A,trans_B", [(False, False), (False, True),
                                             (True, False), (True, True)])
@pytest.mark.parametrize("shape", [(304, 272, 1008), (144, 400, 96)])
@pytest.mark.parametrize("relu", [False, True])
def test_matmul_tma_path_matches_plain(cuda, pair, trans_A, trans_B, shape,
                                       relu):
    """The TMA path in every transpose: M ragged against every block, N
    and K off the block with rows on 16 bytes; within the output type's
    tolerance of the plain version."""
    (dt, out), (M, N, K) = pair, shape
    a = _operand(cuda, (K, M) if trans_A else (M, K), dt, 17)
    b = _operand(cuda, (N, K) if trans_B else (K, N), dt, 18)
    got, path = _matmul_counted(a, b, trans_A, trans_B, out, relu)
    assert path == "tma"
    _close(got, gm.matmul_plain(a, b, trans_A, trans_B, out, relu))


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float16,
                                torch.float8_e4m3fn, torch.float32])
@pytest.mark.parametrize("blk", sorted(ys.KERNEL_BLOCKS),
                         ids=lambda b: "x".join(map(str, b)))
def test_matmul_takes_each_block(cuda, dt, blk):
    """matmul at each block of KERNEL_BLOCKS (a block_M / N / K hint of
    the instances is kept): the TMA path with M ragged and K off bk, and
    float32 on the FFMA tile at a shape the block divides; f32 outputs
    within 1e-5 of the plain version."""
    M, N, K = (384, 512, 336) if dt != torch.float32 else (512, 512, 256)
    a = _operand(cuda, (M, K), dt, 19)
    b = _operand(cuda, (K, N), dt, 20)
    assert gm.kernel_block(M, N, K, dt, *blk) == blk
    got, path = _matmul_counted(a, b, False, False, torch.float32, True, blk)
    assert path == ("ffma" if dt == torch.float32 else "tma")
    _close(got, gm.matmul_plain(a, b, out_dtype=torch.float32, relu=True))


@pytest.mark.parametrize("trans_A,trans_B", [(False, False), (True, True)])
def test_matmul_fp8_k4096_within_float32(cuda, trans_A, trans_B):
    """fp8 -> float32 at K 4096 (#15 and #42): within 1e-5 normwise of the
    exact-product float32 plain version; one fp8 widening a call, none
    for bfloat16."""
    M = N = 512
    K = 4096
    dt = torch.float8_e4m3fn
    a = _operand(cuda, (K, M) if trans_A else (M, K), dt, 27)
    b = _operand(cuda, (N, K) if trans_B else (K, N), dt, 28)
    got, path = _matmul_counted(a, b, trans_A, trans_B, torch.float32,
                                False)
    assert path == "tma"
    want = gm.matmul_plain(a, b, trans_A, trans_B, torch.float32)
    assert _normwise(got, want) <= 1e-5
    if not trans_A:
        for blk in sorted(ys.KERNEL_BLOCKS):
            before = dict(gm.launches)
            got = ys.hand_matmul(M, N, K, *blk, dtype=dt,
                                 out_dtype=torch.float32)(a, b)
            torch.cuda.synchronize()
            assert gm.launches["fp8_widen"] == before["fp8_widen"] + 1
            assert _normwise(got, want) <= 1e-5
    x = _operand(cuda, (256, 256), torch.bfloat16, 31)
    before = gm.launches["fp8_widen"]
    gm.matmul(x, x)
    assert gm.launches["fp8_widen"] == before


def test_matmul_path_rule_on_the_card(cuda):
    """A bfloat16 operand whose base is off 16 bytes takes the tile loop;
    the same values aligned take the TMA path; the two agree."""
    x = _operand(cuda, (256, 256), torch.bfloat16, 29)
    b = _operand(cuda, (256, 128), torch.bfloat16, 30)
    flat = torch.empty(256 * 256 + 8, dtype=torch.bfloat16, device=cuda)
    unaligned = flat[1:1 + 256 * 256].view(256, 256)
    unaligned.copy_(x)
    got_loop, p1 = _matmul_counted(unaligned, b, False, False,
                                   torch.float32, False)
    got_tma, p2 = _matmul_counted(x, b, False, False, torch.float32, False)
    assert (p1, p2) == ("loop", "tma")
    assert _normwise(got_tma, got_loop) <= 1e-5


@pytest.mark.parametrize("trans_A,trans_B", [(False, False), (False, True),
                                             (True, False), (True, True)])
@pytest.mark.parametrize("shape", [(77, 150, 1000), (300, 7, 19), (1, 1, 1),
                                   (256, 128, 384), (130, 272, 4096)])
@pytest.mark.parametrize("relu", [False, True])
def test_matmul_int8_matches_plain(cuda, trans_A, trans_B, shape, relu):
    """int8 x int8 -> int32 (accum_dtype int32), every transpose: equal
    to the plain version's exact sums; 19, 7 and 1 take no 16-byte path,
    K 4096 sums up to 2**26."""
    M, N, K = shape
    g = torch.Generator(device=cuda).manual_seed(13)
    a = torch.randint(-128, 128, (K, M) if trans_A else (M, K), generator=g,
                      device=cuda, dtype=torch.int8)
    b = torch.randint(-128, 128, (N, K) if trans_B else (K, N), generator=g,
                      device=cuda, dtype=torch.int8)
    kern = gm.matmul_kernel(M, N, K, in_dtype="int8", out_dtype="int32",
                            accum_dtype="int32", trans_A=trans_A,
                            trans_B=trans_B, relu=relu)
    before = gm.launches["matmul"]
    got = kern(a, b)
    torch.cuda.synchronize()
    assert gm.launches["matmul"] == before + 1
    want = gm.matmul_plain(a, b, trans_A, trans_B, torch.int32, relu)
    assert got.dtype == torch.int32 and torch.equal(got, want)


# ---------------------------------------------------------------------------
# GEMM variants
# ---------------------------------------------------------------------------

VARIANT_DTYPES = [torch.float32, torch.bfloat16, torch.float16]
VARIANT_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2,
               torch.float16: 1e-2}


def _variant_close(got, want, dtype):
    assert got.dtype == want.dtype == dtype
    assert _normwise(got, want) <= VARIANT_TOL[dtype]


@pytest.mark.parametrize("dtype", VARIANT_DTYPES)
@pytest.mark.parametrize("M,N,K,n_split,taken", [
    (100, 77, 200, 4, 1),           # no 128-multiple chunk: one split
    (16, 300, 1024, 8, 8), (130, 257, 768, 4, 3), (3, 5, 384, 5, 3),
    (64, 136, 4104, 2, 1)])
def test_splitk_matches_plain(cuda, dtype, M, N, K, n_split, taken):
    """Two launches a call (the partials, their sum); the split the
    plan takes; ragged M, N and a single-split fallback."""
    assert gv.splitk_plan(K, n_split)[0] == taken
    a = _randn(cuda, (M, K), dtype, 20)
    b = _randn(cuda, (K, N), dtype, 21)
    before = dict(gv.launches)
    got = gv.matmul_splitk(a, b, n_split=n_split)
    torch.cuda.synchronize()
    assert gv.launches["splitk_gemm"] == before["splitk_gemm"] + 1
    assert gv.launches["splitk_reduce"] == before["splitk_reduce"] + 1
    _variant_close(got, gv.matmul_splitk_plain(a, b, n_split=n_split), dtype)
    parts = gv.splitk_kernel(M, N, K, taken, 128, 128, K // taken, dtype)(
        a, b)
    torch.cuda.synchronize()
    assert tuple(parts.shape) == (taken, M, N)
    assert _normwise(parts.sum(0), got.float()) <= VARIANT_TOL[dtype]


@pytest.mark.parametrize("dtype", VARIANT_DTYPES)
@pytest.mark.parametrize("M,N,K,n_programs,block", [
    (256, 384, 512, 6, 128),        # the JAX test's shape
    (256, 384, 640, 4, 128),        # 7.5 k-blocks a program: mid-tile cuts
    (192, 320, 448, 5, 64),         # 64-cells: a 128-tile holds 4 of them
    (128, 128, 128, 300, 128),      # more programs than work
    (96, 32, 96, 7, 32)])
def test_streamk_matches_plain(cuda, dtype, M, N, K, n_programs, block):
    a = _randn(cuda, (M, K), dtype, 22)
    b = _randn(cuda, (K, N), dtype, 23)
    before = dict(gv.launches)
    got = gv.matmul_streamk(a, b, n_programs=n_programs, block_M=block,
                            block_N=block, block_K=block)
    torch.cuda.synchronize()
    assert gv.launches["streamk_gemm"] == before["streamk_gemm"] + 1
    assert gv.launches["streamk_fixup"] == before["streamk_fixup"] + 1
    want = gv.matmul_streamk_plain(a, b, n_programs, block, block, block)
    _variant_close(got, want, dtype)


def test_streamk_refuses_tiles_past_the_card(cuda):
    a = _randn(cuda, (256, 256), torch.bfloat16, 24)
    before = dict(gv.launches)
    with pytest.raises(ValueError, match="128 x 128"):
        gv.matmul_streamk(a, a, block_M=256)
    assert gv.launches == before


@pytest.mark.parametrize("dtype", VARIANT_DTYPES)
@pytest.mark.parametrize("N,K", [(77, 200), (300, 4097), (1, 1), (33, 8),
                                 (1000, 4096), (16, 20000)])
def test_gemv_matches_plain(cuda, dtype, N, K):
    """K 4097 and 1 take the element-wise path, the others 16 bytes a
    lane; K 20000 spans several staged chunks of a."""
    a = _randn(cuda, (K,), dtype, 25)
    b = _randn(cuda, (N, K), dtype, 26)
    before = gv.launches["gemv"]
    got = gv.gemv(a, b)
    torch.cuda.synchronize()
    assert gv.launches["gemv"] == before + 1
    _variant_close(got, gv.gemv_plain(a, b), dtype)
    f32 = gv.gemv(a, b, out_dtype=torch.float32)
    assert _normwise(f32, gv.gemv_plain(a, b, torch.float32)) <= 1e-5


@pytest.mark.parametrize("dtype", VARIANT_DTYPES)
@pytest.mark.parametrize("mask_kind", ["random", "zeros", "ones"])
@pytest.mark.parametrize("M,N,K,block", [(256, 384, 200, 128),
                                         (192, 320, 96, 64),
                                         (96, 160, 1000, 32)])
def test_blocksparse_matches_plain(cuda, dtype, mask_kind, M, N, K, block):
    """Dead cells exactly 0 (a 128-tile may hold live and dead cells);
    an all-ones mask is the dense product."""
    a = _randn(cuda, (M, K), dtype, 27)
    b = _randn(cuda, (K, N), dtype, 28)
    shape = (M // block, N // block)
    g = torch.Generator(device=cuda).manual_seed(29)
    mask = {"random": (torch.rand(shape, generator=g, device=cuda)
                       > 0.5).to(torch.int32),
            "zeros": torch.zeros(shape, dtype=torch.int32, device=cuda),
            "ones": torch.ones(shape, dtype=torch.int32, device=cuda)}[
                mask_kind]
    before = gv.launches["blocksparse_gemm"]
    got = gv.blocksparse_matmul(a, b, mask, block_M=block, block_N=block)
    torch.cuda.synchronize()
    assert gv.launches["blocksparse_gemm"] == before + 1
    live = (mask != 0).repeat_interleave(block, 0).repeat_interleave(block, 1)
    assert not got[~live].float().any()
    if mask_kind == "zeros":
        return
    want = gv.blocksparse_matmul_plain(a, b, mask, block, block)
    assert _normwise(got[live], want[live]) <= VARIANT_TOL[dtype]
    if mask_kind == "ones":
        assert _normwise(got, gm.matmul(a, b)) <= VARIANT_TOL[dtype]


def _w4_card(dev, K2, N, gs, seed):
    from tilelang_mesh_tpu_torch.quantize import quantize_int4_planar
    w = np.random.default_rng(seed).standard_normal((2 * K2, N)).astype(
        np.float32)
    packed, scales = quantize_int4_planar(w, gs)
    return torch.from_numpy(packed).to(dev), torch.from_numpy(scales).to(dev)


# (M, K/2, N, group size): several groups a half, N and M off the tile;
# K/2 = 10 takes no 16-byte path
W4_CASES = [(77, 96, 150, 32), (1, 8, 3, 8), (130, 256, 128, 128),
            (16, 512, 300, 128), (3, 10, 5, 5)]

# dequant_path's answer -> the launches of one fused w4a16 call
W4_PATH_LAUNCHES = {
    "splitk": {"dequant_gemm_splitk": 1, "dequant_splitk_combine": 1},
    "wgmma": {"dequant_gemm_wgmma": 1}, "loop": {"dequant_gemm": 1}}


def _w4_launches(a, packed, scales, gs):
    """The launches dequant_path promises for this call."""
    path = dqg.dequant_path(a.shape[0], packed.shape[1], packed.shape[0], gs,
                            a.dtype, a.data_ptr(), packed.data_ptr(),
                            scales.data_ptr())
    return W4_PATH_LAUNCHES[path]


def _moved(before, after, want):
    """Each counter moved by want's count (0 where want names none)."""
    assert {k: after[k] - before[k] for k in after} == {
        k: want.get(k, 0) for k in after}


def _offset(t, nbytes):
    """A contiguous copy of t whose base lies nbytes past a 16-byte
    boundary."""
    e = t.element_size()
    flat = torch.empty(t.numel() + 16 // e, dtype=t.dtype, device=t.device)
    out = flat[nbytes // e:nbytes // e + t.numel()].view(t.shape)
    out.copy_(t)
    return out


# the fused w4a16's two new paths and the loop beside them, in bf16, f16
# and f32: the split-K up to SPLITK_MAX_ROWS (16) rows, the TMA kernel
# past it (and its wide tile past WGMMA_WIDE_ROWS); ragged N (a strip or
# tile partly past N), K/2 off a block's rows, groups of 8 and 64, and a
# misaligned base (the loop)
W4_PATH_CASES = [
    # (M, K/2, N, group size, A's base offset in bytes)
    (1, 2048, 4096, 128, 0), (2, 2048, 4096, 128, 0),
    (15, 2048, 4096, 128, 0), (16, 2048, 4096, 128, 0),
    (17, 2048, 4096, 128, 0), (128, 2048, 4096, 128, 0),
    (1, 1000, 4112, 8, 0), (16, 1000, 272, 8, 0), (9, 64, 4096, 64, 0),
    (17, 512, 4112, 64, 0), (1100, 512, 272, 64, 0),
    (4096, 2048, 4096, 512, 0), (16, 2048, 4096, 128, 2),
    (4096, 512, 512, 64, 2)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("M,K2,N,gs,off", W4_PATH_CASES)
def test_dequant_paths_match_plain(cuda, dtype, M, K2, N, gs, off):
    """Each path within the type's bound of the plain version, with its
    own launches; on one-hot rows of A each picks B's rows bit for bit
    (the same float32 multiply and rounding as dequant_int4_plain); two
    runs give the same bits (the split-K's combine adds in a fixed
    order)."""
    packed, scales = _w4_card(cuda, K2, N, gs, 31)
    a = _offset(_randn(cuda, (M, 2 * K2), dtype, 32) * 0.1, off)
    want_launches = _w4_launches(a, packed, scales, gs)
    path = next(k for k, v in W4_PATH_LAUNCHES.items()
                if v == want_launches)
    assert (path == "loop") == (dtype == torch.float32 or off != 0)
    before = dict(dqg.launches)
    got = dqg.dequant_matmul(a, packed, scales, group_size=gs, block_K2=gs)
    torch.cuda.synchronize()
    _moved(before, dqg.launches, want_launches)
    _close(got, dqg.dequant_matmul_plain(a, packed, scales, gs))
    again = dqg.dequant_matmul(a, packed, scales, group_size=gs, block_K2=gs)
    assert torch.equal(got.view(torch.uint8), again.view(torch.uint8))
    rows = torch.arange(M, device=cuda) * 37 % (2 * K2)
    onehot = torch.zeros((M, 2 * K2), dtype=dtype, device=cuda)
    onehot[torch.arange(M, device=cuda), rows] = 1
    onehot = _offset(onehot, off)
    bd = dqg.dequant_int4_plain(packed, scales, gs, dtype)
    pick = dqg.dequant_matmul(onehot, packed, scales, group_size=gs,
                              block_K2=gs)
    assert torch.equal(pick.view(torch.uint8), bd[rows].view(torch.uint8))


def test_dequant_wgmma_tiles_agree(cuda):
    """Both TMA tiles on one product: within the bf16 bound of each other
    and of the plain version (M past WGMMA_WIDE_ROWS takes the wide one)."""
    step = dqg.WGMMA_WIDE_ROWS
    M, K2, N, gs = step + 128, 1024, 1024, 128
    packed, scales = _w4_card(cuda, K2, N, gs, 33)
    a = _randn(cuda, (M, 2 * K2), torch.bfloat16, 34) * 0.1
    want = dqg.dequant_matmul_plain(a, packed, scales, gs)
    wide = dqg.dequant_matmul(a, packed, scales, group_size=gs, block_K2=gs)
    narrow = torch.cat([dqg.dequant_matmul(
        a[i:i + step], packed, scales, group_size=gs, block_K2=gs)
        for i in range(0, M, step)])
    torch.cuda.synchronize()
    _close(wide, want)
    _close(narrow, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K2,N,gs", W4_CASES)
def test_dequant_kernels_match_plain(cuda, dtype, M, K2, N, gs):
    """The fused w4a16 kernel, the unpack (bit for bit) and the two-pass
    path (one unpack and one matmul launch)."""
    packed, scales = _w4_card(cuda, K2, N, gs, 9)
    a = _randn(cuda, (M, 2 * K2), dtype, 10)
    before = dict(dqg.launches)
    got = dqg.dequant_matmul(a, packed, scales, group_size=gs, block_K2=gs)
    torch.cuda.synchronize()
    _moved(before, dqg.launches, _w4_launches(a, packed, scales, gs))
    _close(got, dqg.dequant_matmul_plain(a, packed, scales, gs))

    bd = dqg.dequant_int4(packed, scales, gs, dtype)
    torch.cuda.synchronize()
    assert dqg.launches["dequant_int4"] == before["dequant_int4"] + 1
    want = dqg.dequant_int4_plain(packed, scales, gs, dtype)
    assert torch.equal(bd.view(torch.uint8), want.view(torch.uint8))

    mm = sum(gm.launches[k] for k in ("matmul", "matmul_tma",
                                      "matmul_ffma"))
    two = dqg.dequant_matmul_twopass(a, packed, scales, dq_block=gs)
    torch.cuda.synchronize()
    assert dqg.launches["dequant_int4"] == before["dequant_int4"] + 2
    assert sum(gm.launches[k] for k in ("matmul", "matmul_tma",
                                        "matmul_ffma")) == mm + 1
    _close(two, gm.matmul_plain(a, want))


@pytest.mark.parametrize("M,K,N", [(77, 192, 150), (1, 16, 3),
                                   (130, 512, 256), (5, 20, 7)])
def test_w4a8_kernel_matches_plain(cuda, M, K, N):
    """Exact int32 sums and the same epilogue: equal to the plain
    version up to 1e-6 normwise; K/2 = 10 takes no 16-byte path."""
    rng = np.random.default_rng(11)
    w = rng.standard_normal((K, N)).astype(np.float32)
    packed, sw = dqg.quantize_w4_per_channel(w)
    x = _randn(cuda, (M, K), torch.float32, 12)
    before = dqg.launches["w4a8_gemm"]
    got = dqg.w4a8_matmul(x, packed, sw)
    torch.cuda.synchronize()
    assert dqg.launches["w4a8_gemm"] == before + 1
    q, s = dqg.quantize_activations(x)
    want = dqg.w4a8_gemm_plain(q, torch.from_numpy(packed).to(cuda),
                               torch.from_numpy(sw).to(cuda),
                               (1.0 / s).float())
    assert _normwise(got, want) <= 1e-6


class _RefusingLib:
    """A kernel library whose every launch reports
    cudaErrorInvalidConfiguration (9)."""

    def __getattr__(self, name):
        def refuse(*args):
            return 9
        return refuse


def _gemm_calls(dev):
    x = torch.zeros((4, 8), device=dev)
    p = torch.zeros((4, 3), dtype=torch.uint8, device=dev)
    s = torch.ones((2, 3), device=dev)
    x16 = torch.zeros((32, 128), dtype=torch.bfloat16, device=dev)
    p16 = torch.zeros((64, 16), dtype=torch.uint8, device=dev)
    s16 = torch.ones((2, 16), device=dev)
    return [lambda: gm.matmul(x, x.T.contiguous()),
            lambda: dqg.dequant_matmul(x, p, s),
            lambda: dqg.dequant_matmul(x16[:1], p16, s16),     # split-K
            lambda: dqg.dequant_matmul(x16, p16, s16),         # TMA
            lambda: dqg.dequant_int4(p, s, 4, torch.float32),
            lambda: dqg.dequant_matmul_twopass(x, p, s),
            lambda: dqg.w4a8_matmul(x, p, torch.ones(3, device=dev))]


def test_gemm_wrappers_raise_on_build_or_launch_failure(cuda, monkeypatch):
    """No fallback: a build failure is the build's error, a refused
    launch a KernelLaunchError, and neither counts a launch."""
    def no_build(name):
        raise RuntimeError(f"nvcc failed building {name}")

    before = (dict(gm.launches), dict(dqg.launches))
    monkeypatch.setattr(_build, "load", no_build)
    for call in _gemm_calls(cuda):
        with pytest.raises(RuntimeError, match="nvcc failed"):
            call()
    monkeypatch.setattr(_build, "load", lambda name: _RefusingLib())
    for call in _gemm_calls(cuda):
        with pytest.raises(KernelLaunchError):
            call()
    assert (dict(gm.launches), dict(dqg.launches)) == before


def test_gemm_wrappers_refuse_mixed_devices(cuda):
    x = torch.zeros((4, 8), device=cuda)
    with pytest.raises(ValueError):
        gm.matmul(x, torch.zeros((8, 3)))
    with pytest.raises(ValueError):
        dqg.dequant_matmul(x, torch.zeros((4, 3), dtype=torch.uint8),
                           torch.ones((2, 3), device=cuda))


def test_matmul_fp8_overflow_nan_matches_plain(cuda):
    """4-scaled e4m3 operands: sums past the format's range give NaN in
    the kernel's fp8 output exactly where the plain version's cast gives
    it (|c| > 464); the rest within one e4m3 ulp."""
    for (M, N, K), seed in (((128, 128, 128), 0), ((77, 150, 200), 1)):
        rng = np.random.default_rng(seed)
        a, b = ((torch.from_numpy((4 * rng.standard_normal(s)).astype(
            np.float32)).to(cuda).to(torch.float8_e4m3fn))
            for s in ((M, K), (K, N)))
        got = gm.matmul(a, b)
        want = gm.matmul_plain(a, b)
        torch.cuda.synchronize()
        g, w = got.float(), want.float()
        nan = torch.isnan(w)
        assert int(nan.sum()) > 0
        assert torch.equal(torch.isnan(g), nan)
        assert bool(((g - w).abs()[~nan] <= 0.125 * w.abs()[~nan]
                     + 2 ** -9).all())


SEQ_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _seq_close(got, want, dtype):
    assert _normwise(got, want) <= SEQ_TOL[dtype]


def _mamba2_inputs(dev, B, S, H, P, N, dtype, seed, dt_range=(0.01, 0.1),
                   a=None):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal((B, S, H, P)) * 0.5).astype(
        np.float32)).to(dev).to(dtype)
    dt = torch.from_numpy(rng.uniform(*dt_range, (B, S, H)).astype(
        np.float32)).to(dev)
    A = torch.from_numpy(np.asarray(a if a is not None else -rng.uniform(
        0.5, 1.5, (H,)), np.float32)).to(dev)
    bm, cm = (torch.from_numpy((rng.standard_normal((B, S, N)) * 0.3).astype(
        np.float32)).to(dev).to(dtype) for _ in range(2))
    return x, dt, A, bm, cm


# every chunk the kernels take at these widths: float32 up to 256,
# bfloat16 up to 512 (the sequence)
SEQ_CHUNKS = [(dt, c) for dt in (torch.float32, torch.bfloat16)
              for c in (16, 32, 64, 128, 256)] + [(torch.bfloat16, 512)]


@pytest.mark.parametrize("dtype,chunk", SEQ_CHUNKS)
def test_mamba2_kernel_matches_plain(cuda, dtype, chunk):
    """bench's state and head widths (N 128, P 64) at every chunk the
    card takes; the largest run on column blocks of P."""
    args = _mamba2_inputs(cuda, 2, 512, 3, 64, 128, dtype, chunk)
    before = mamba2.launches["mamba2_chunk_scan"]
    got = mamba2.mamba2_chunk_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert mamba2.launches["mamba2_chunk_scan"] == before + 1
    _seq_close(got, mamba2.mamba2_chunk_scan_plain(*args, chunk), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba2_kernel_long_chunk_no_overflow(cuda, dtype):
    """tests/test_mamba2.py's strong-decay case (|A| sum dt ~ 128 over a
    chunk of 256): finite, and the plain version's values."""
    args = _mamba2_inputs(cuda, 1, 256, 1, 32, 32, dtype, 2, (0.4, 0.6),
                          [-1.0])
    got = mamba2.mamba2_chunk_scan(*args, chunk=256)
    _seq_close(got, mamba2.mamba2_chunk_scan_plain(*args, 256), dtype)
    if dtype == torch.float32:      # the JAX test's own check, in float32
        assert _normwise(got, mamba2.mamba2_reference(*args)) <= 2e-2


def _gdn_inputs(dev, B, H, T, K, V, dtype, seed):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)
    q = t(rng.standard_normal((B, H, T, K)) * 0.3).to(dtype)
    k = rng.standard_normal((B, H, T, K))
    k = t(k / np.linalg.norm(k, axis=-1, keepdims=True)).to(dtype)
    v = t(rng.standard_normal((B, H, T, V)) * 0.3).to(dtype)
    g = t(rng.uniform(-0.2, 0.0, (B, H, T)))
    beta = t(rng.uniform(0.1, 0.9, (B, H, T)))
    return q, k, v, g, beta


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,K,V", [(16, 128, 128), (32, 128, 128),
                                   (64, 128, 128), (64, 64, 32),
                                   (32, 32, 96)])
def test_gdn_kernel_matches_plain(cuda, dtype, C, K, V):
    """bench's widths (K = V = 128) at every chunk the card takes, and
    rectangular key / value widths."""
    args = _gdn_inputs(cuda, 2, 2, 256, K, V, dtype, C + K)
    before = gdn.launches["gdn_chunk_fwd"]
    got = gdn.gdn_chunk_fwd_tl(*args, chunk_size=C)
    torch.cuda.synchronize()
    assert gdn.launches["gdn_chunk_fwd"] == before + 1
    _seq_close(got, gdn.gdn_chunk_fwd_tl_plain(*args, C, K ** -0.5), dtype)


def _la_inputs(dev, B, H, S, DK, DV, dtype, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy((rng.standard_normal(s) * 0.2).astype(
        np.float32)).to(dev).to(dtype)
        for s in ((B, H, S, DK), (B, H, S, DK), (B, H, S, DV)))


@pytest.mark.parametrize("dtype,chunk,DK,DV",
                         [(dt, c, 128, 128) for dt, c in SEQ_CHUNKS]
                         + [(dt, c, dk, dv) for dt in (torch.float32,
                                                       torch.bfloat16)
                            for c, dk, dv in ((64, 64, 128),
                                              (128, 128, 64))])
def test_linear_attention_kernel_matches_plain(cuda, dtype, chunk, DK, DV):
    q, k, v = _la_inputs(cuda, 2, 2, 512, DK, DV, dtype, chunk + DV)
    before = la.launches["linear_attention"]
    got = la.linear_attention(q, k, v, chunk=chunk)
    torch.cuda.synchronize()
    assert la.launches["linear_attention"] == before + 1
    _seq_close(got, la.linear_attention_plain(q, k, v, chunk), dtype)


@pytest.mark.parametrize("DK,DV", [(64, 64), (64, 128)])
def test_linear_attention_backward_three_launches(cuda, DK, DV):
    """backward="kernel" on the card: one launch forward, three backward
    (dq at the (DV, DK) widths), the gradients those of the same
    autograd Function on CPU tensors (the plain version)."""
    ins = _la_inputs("cpu", 1, 2, 256, DK, DV, torch.float32, 7)
    go = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (1, 2, 256, DV)).astype(np.float32))
    grads = {}
    for dev in ("cpu", cuda):
        t = [a.detach().to(dev).requires_grad_() for a in ins]
        before = la.launches["linear_attention"]
        out = la.linear_attention(*t, chunk=64, backward="kernel")
        if dev == cuda:
            torch.cuda.synchronize()
            assert la.launches["linear_attention"] == before + 1
        (out * go.to(dev)).sum().backward()
        if dev == cuda:
            torch.cuda.synchronize()
            assert la.launches["linear_attention"] == before + 4
        grads[str(dev)] = [a.grad for a in t]
    for g, w in zip(grads[str(cuda)], grads["cpu"]):
        assert _normwise(g, w.to(cuda)) <= SEQ_TOL[torch.float32]


@pytest.mark.parametrize("dtype,chunk", SEQ_CHUNKS)
def test_retention_kernel_matches_plain(cuda, dtype, chunk):
    q, k, v = _la_inputs(cuda, 2, 4, 512, 128, 128, dtype, chunk)
    gamma = torch.tensor([1.0 - 2.0 ** (-5.0 - h) for h in range(4)],
                         device=cuda)        # one decay a head, in (0, 1)
    before = la.launches["retention"]
    got = la.retention(q, k, v, gamma, chunk=chunk)
    torch.cuda.synchronize()
    assert la.launches["retention"] == before + 1
    _seq_close(got, la.retention_plain(q, k, v, gamma, chunk), dtype)


def test_retention_decay_powers(cuda):
    """Strong and no decay (gamma 0.05 ... 1): the powers gamma^(i+1),
    gamma^(i-j), gamma^(c-1-j) and gamma^c by exp2(log2 gamma n), as the
    plain version takes them, and the dense reference."""
    q, k, v = _la_inputs(cuda, 1, 4, 256, 64, 64, torch.float32, 9)
    gamma = [0.05, 0.5, 0.99, 1.0]
    got = la.retention(q, k, v, gamma, chunk=64)
    g = torch.tensor(gamma, device=cuda)
    _seq_close(got, la.retention_plain(q, k, v, g, 64), torch.float32)
    assert _normwise(got, la.retention_reference(q, k, v, gamma)) <= 1e-4


def test_retention_host_gamma_does_not_wait_on_the_card(cuda):
    """A gamma given on the host is range-checked there: the call
    enqueues its copy and its launch and never waits on the card."""
    q, k, v = _la_inputs(cuda, 1, 4, 256, 64, 64, torch.float32, 10)
    gamma = torch.tensor([0.5, 0.9, 0.99, 1.0])
    want = la.retention(q, k, v, gamma, chunk=64)       # builds, warms up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = la.retention(q, k, v, gamma, chunk=64)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got, want)


@pytest.mark.parametrize("op", ["mamba2", "gdn", "linear_attention",
                                "retention"])
def test_seqmix_kernels_name_the_chunks_they_take(cuda, op):
    """A chunk whose block does not fit in shared memory (float32 at 512;
    GDN at 128, its four float32 C x C matrices alone) raises ValueError
    naming the chunks the card takes, and launches nothing."""
    f32 = torch.float32
    if op == "mamba2":
        args = _mamba2_inputs(cuda, 1, 512, 1, 64, 128, f32, 1)
        call = lambda: mamba2.mamba2_chunk_scan(*args, chunk=512)
        takes, counter = "[16, 32, 64, 128, 256]", mamba2.launches
    elif op == "gdn":
        args = _gdn_inputs(cuda, 1, 1, 256, 128, 128, torch.bfloat16, 3)
        call = lambda: gdn.gdn_chunk_fwd_tl(*args, chunk_size=128)
        takes, counter = "[16, 32, 64]", gdn.launches
    else:
        q, k, v = _la_inputs(cuda, 1, 1, 512, 128, 128, f32, 2)
        call = (lambda: la.linear_attention(q, k, v, chunk=512)) \
            if op == "linear_attention" \
            else (lambda: la.retention(q, k, v, [0.9], chunk=512))
        takes, counter = "[16, 32, 64, 128, 256]", la.launches
    before = dict(counter)
    with pytest.raises(ValueError, match=re.escape(f"takes chunks {takes}")):
        call()
    assert counter == before


# ---------------------------------------------------------------------------
# BitNet b1.58: the int8 activation quantiser and the int8 x ternary GEMM
# ---------------------------------------------------------------------------


def _bitnet_launches(a, packed):
    """The launch bitnet_path promises for this call."""
    path = bitnet.bitnet_path(a.shape[0], packed.shape[1], a.shape[1],
                              a.data_ptr(), packed.data_ptr())
    return {bitnet.PATH_KERNELS[path]: 1}


# the int8 x ternary GEMM's paths: the split-K up to SPLITK_MAX_ROWS (8)
# rows and its neighbours, the TMA kernel past it, BitNet b1.58-2B-4T's
# widths, ragged N and K (K off 16 takes the split-K but not TMA; a strip
# or tile partly past N), misaligned bases (the loop)
BITNET_PATH_CASES = [
    # (M, N, K, A's base offset in bytes)
    (1, 6912, 2560, 0), (2, 6912, 2560, 0), (7, 6912, 2560, 0),
    (8, 6912, 2560, 0), (9, 6912, 2560, 0), (15, 2560, 6912, 0),
    (16, 2560, 6912, 0), (17, 2560, 6912, 0), (128, 6912, 2560, 0),
    (4096, 6912, 2560, 0), (4096, 2560, 6912, 0), (1, 4112, 1000, 0),
    (3, 272, 20, 0), (300, 4112, 1008, 0), (33, 272, 2576, 0),
    (1, 6912, 2560, 2), (8, 6912, 2560, 4), (128, 6912, 2560, 4)]


@pytest.mark.parametrize("M,N,K,off", BITNET_PATH_CASES)
def test_bitnet_paths_match_plain(cuda, M, N, K, off):
    """Each path equal to the plain version (exact int32 sums), with its
    own launch; two runs equal."""
    rng = np.random.default_rng(M + N + K)
    a = _offset(torch.from_numpy(rng.integers(-128, 128, (M, K)).astype(
        np.int8)).to(cuda), off)
    w = rng.integers(-1, 2, (K, N)).astype(np.int8)
    packed = torch.from_numpy(bitnet.pack_ternary(w)).to(cuda)
    want = _bitnet_launches(a, packed)
    name = next(iter(want))
    if off % 4:
        assert name == "bitnet_gemm"
    elif off or N % 16:
        assert name != "bitnet_gemm_wgmma"
    before = dict(bitnet.launches)
    got = bitnet.bitnet_gemm(a, packed)
    torch.cuda.synchronize()
    _moved(before, bitnet.launches, want)
    assert got.dtype == torch.int32 and got.shape == (M, N)
    assert torch.equal(got, bitnet.bitnet_gemm_plain(a, packed))
    assert torch.equal(got, bitnet.bitnet_gemm(a, packed))


@pytest.mark.parametrize("M,N,K", [(77, 150, 1000), (1, 130, 256),
                                   (1, 3, 4), (200, 257, 644),
                                   (128, 128, 64), (5, 7, 20),
                                   (130, 6912, 2560)])
def test_bitnet_gemm_matches_plain(cuda, M, N, K):
    """Exact int32 sums at ragged M, N and K (K a multiple of 4; 20 and
    644 take no 16-byte path for A, N 150 / 257 none for the weights)."""
    rng = np.random.default_rng(20)
    a = torch.from_numpy(rng.integers(-128, 128, (M, K)).astype(
        np.int8)).to(cuda)
    w = rng.integers(-1, 2, (K, N)).astype(np.int8)
    packed = torch.from_numpy(bitnet.pack_ternary(w)).to(cuda)
    before = dict(bitnet.launches)
    got = bitnet.bitnet_gemm(a, packed)
    torch.cuda.synchronize()
    _moved(before, bitnet.launches, _bitnet_launches(a, packed))
    assert got.dtype == torch.int32 and got.shape == (M, N)
    assert torch.equal(got, bitnet.bitnet_gemm_plain(a, packed))
    assert torch.equal(got.cpu(), bitnet.bitnet_gemm_plain(
        a.cpu(), packed.cpu()))


@pytest.mark.parametrize("M,K", [(77, 1000), (5, 7), (3, 2561),
                                 (128, 6912), (1, 1)])
def test_quantize_act_int8_matches_plain_bytes(cuda, M, K):
    """Q and S byte for byte; an all-zero row gives a finite S and Q = 0;
    K 7, 2561 and 1 take the one-element path."""
    x = _randn(cuda, (M, K), torch.float32, 21) * 3
    x[M // 2] = 0.0
    before = qa.launches["quantize_act_int8"]
    q, s = qa.quantize_act_int8(x)
    torch.cuda.synchronize()
    assert qa.launches["quantize_act_int8"] == before + 1
    pq, ps = qa.quantize_act_int8_plain(x)
    assert q.dtype == torch.int8 and s.shape == (M, 1)
    assert torch.equal(q, pq)
    assert torch.equal(s.view(torch.int32), ps.view(torch.int32))
    assert bool(torch.isfinite(s).all()) and not q[M // 2].any()
    cq, cs = qa.quantize_act_int8_plain(x.cpu())
    assert torch.equal(q.cpu(), cq) and torch.equal(s.cpu(), cs)


def test_bitffn_on_card_matches_reference_on_card(cuda):
    """Three bitnet_gemm launches a forward, equal to the module's
    reference mode (the exact product in float64 on the card), and to
    the same module on the CPU."""
    ffn = bitnet_model.BitFFN(256, 512, seed=3, device=cuda)
    x = _randn(cuda, (2, 33, 256), torch.float32, 22)
    before = dict(bitnet.launches)
    y = ffn(x)
    torch.cuda.synchronize()
    _moved(before, bitnet.launches, {"bitnet_gemm_wgmma": 3})   # 66 rows
    before = dict(bitnet.launches)
    ffn(x[:1, :1])
    torch.cuda.synchronize()
    _moved(before, bitnet.launches, {"bitnet_gemm_splitk": 3})  # a token
    assert torch.equal(y, ffn(x, reference=True))
    cpu = bitnet_model.BitFFN(256, 512, seed=3, device="cpu")
    assert _normwise(y, cpu(x.cpu()).to(cuda)) <= 1e-6


def _bitnet_calls(dev):
    a = torch.zeros((4, 8), dtype=torch.int8, device=dev)
    p = torch.zeros((2, 3), dtype=torch.int8, device=dev)
    p16 = torch.zeros((4, 16), dtype=torch.int8, device=dev)
    a64 = torch.zeros((64, 16), dtype=torch.int8, device=dev)
    x = torch.zeros((4, 8), device=dev)
    q = torch.zeros((1, 4, 8, 16), device=dev)
    kv = torch.zeros((1, 2, 8, 16), device=dev)
    return [(bitnet.launches, lambda: bitnet.bitnet_gemm(a, p)),
            (bitnet.launches, lambda: bitnet.bitnet_gemm(a64[:1], p16)),
            (bitnet.launches, lambda: bitnet.bitnet_gemm(a64, p16)),
            (qa.launches, lambda: qa.quantize_act_int8(x)),
            (gqa.launches, lambda: gqa.gqa_fwd(q, kv, kv, True, 0.25)),
            (gqa.launches, lambda: gqa.gqa_fwd_partial(q, kv, kv, True,
                                                       0.25))]


def test_new_wrappers_raise_on_build_or_launch_failure(cuda, monkeypatch):
    """No fallback: a build failure is the build's error, a refused
    launch a KernelLaunchError, and neither counts a launch."""
    def no_build(name):
        raise RuntimeError(f"nvcc failed building {name}")

    before = [dict(c) for c, _ in _bitnet_calls(cuda)]
    monkeypatch.setattr(_build, "load", no_build)
    for _, call in _bitnet_calls(cuda):
        with pytest.raises(RuntimeError, match="nvcc failed"):
            call()
    monkeypatch.setattr(_build, "load", lambda name: _RefusingLib())
    for _, call in _bitnet_calls(cuda):
        with pytest.raises(KernelLaunchError):
            call()
    assert [dict(c) for c, _ in _bitnet_calls(cuda)] == before


# ---------------------------------------------------------------------------
# grouped-query attention forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("group", [1, 2, 4, 5])
@pytest.mark.parametrize("Sq,Sk", [(77, 77), (100, 260), (192, 130)])
def test_gqa_forward_kernels_match_plain(cuda, dtype, causal, d, group, Sq,
                                         Sk):
    Hkv = 2
    q, k, v, _, _, _, sm = _attn_inputs(cuda, 1, Hkv * group, Hkv, Sq, Sk,
                                        d, dtype, causal)
    before = dict(gqa.launches)
    o = gqa.gqa_fwd(q, k, v, causal, sm)
    part = gqa.gqa_fwd_partial(q, k, v, causal, sm)
    torch.cuda.synchronize()
    assert gqa.launches == {"gqa_fwd": before["gqa_fwd"] + 1,
                            "gqa_fwd_partial": before["gqa_fwd_partial"] + 1}
    assert o.dtype == dtype and all(t.dtype == torch.float32 for t in part)
    assert _normwise(o, gqa.gqa_fwd_plain(q, k, v, causal, sm)) \
        <= ATTN_TOL[dtype]
    assert _normwise(part, gqa.gqa_fwd_partial_plain(q, k, v, causal, sm)) \
        <= ATTN_TOL[dtype]


def test_gqa_group_one_kernel_equals_mha_kernel(cuda):
    """With as many KV heads as query heads the GQA wrapper launches the
    MHA kernel's instance: the same bytes."""
    q, k, v, _, _, _, sm = _attn_inputs(cuda, 2, 3, 3, 150, 150, 64,
                                        torch.bfloat16, True)
    assert torch.equal(gqa.gqa_fwd(q, k, v, True, sm),
                       fa.mha_fwd(q, k, v, True, sm))
    for a, b in zip(gqa.gqa_fwd_partial(q, k, v, True, sm),
                    fa.mha_fwd_partial(q, k, v, True, sm)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("causal", [False, True])
def test_gqa_autograd_on_card_matches_cpu(cuda, causal):
    """gqa_attention's kernel backward on the card (the partial forward,
    then dK/dV and dQ at group 4) against the same Function on CPU
    tensors."""
    q, k, v, do, _, _, _ = _attn_inputs("cpu", 2, 8, 2, 130, 130, 64,
                                        torch.float32, causal)
    outs, grads = [], []
    for dev in ("cpu", cuda):
        leaves = [t.detach().to(dev).requires_grad_() for t in (q, k, v)]
        before = (dict(gqa.launches), dict(gb.launches))
        o = gqa.gqa_attention(*leaves, causal=causal)
        o.backward(do.to(dev))
        if dev == cuda:
            torch.cuda.synchronize()
            assert gqa.launches["gqa_fwd_partial"] == \
                before[0]["gqa_fwd_partial"] + 1
            assert gb.launches == {k_: n + 1 for k_, n in before[1].items()}
        outs.append(o.detach().cpu())
        grads.append([t.grad.cpu() for t in leaves])
    assert _normwise(outs[1].cuda(), outs[0].cuda()) <= 1e-4
    for a, b in zip(*grads):
        assert _normwise(b.cuda(), a.cuda()) <= 1e-4


# ---------------------------------------------------------------------------
# packed varlen attention (csrc/flash_attention_varlen.cu, varlen_bwd.cu)
# ---------------------------------------------------------------------------


def _varlen_inputs(dev, lens_q, lens_k, Hq, Hkv, D, dtype, causal, align,
                   block_M, block_N, seed=0):
    """Packed kernel operands as the entry point builds them
    (``pack_varlen``), with a ragged tail of 3 query and 2 key rows past
    cu_seqlens[-1], and the backward's lse2 and delta from the plain
    partial forward."""
    cu_q = np.concatenate([[0], np.cumsum(lens_q)]).astype(np.int32)
    cu_k = np.concatenate([[0], np.cumsum(lens_k)]).astype(np.int32)
    tq, tk = int(cu_q[-1]) + 3, int(cu_k[-1]) + 2
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    q, k, v, masks = vl.pack_varlen(rnd(tq, Hq, D), rnd(tk, Hkv, D),
                                    rnd(tk, Hkv, D), cu_q, cu_k, causal,
                                    block_M, block_N, align)
    do = rnd(*q.shape)
    sm = 1.0 / math.sqrt(D)
    acc, m, l = vl.varlen_fwd_partial_plain(q, k, v, *masks, causal, sm)
    lv = l[..., None]
    o = torch.where(lv > 0, acc / lv, 0.0).to(dtype)
    delta = (do.float() * o.float()).sum(-1)
    return q, k, v, do, m + torch.log2(l), delta, masks, sm, tq


VARLEN_CASES = [  # lens_q, lens_k, block_M, block_N
    ([100, 37, 260], [100, 37, 260], 128, 128),
    ([20, 35, 11], [44, 17, 52], 32, 32),      # lens_q != lens_k
    ([70, 1, 90], [30, 100, 20], 40, 56),      # no multiple of the tiles
    ([300], [300], 128, 64),
]
VARLEN_MODES = [(False, "top-left"), (True, "top-left"),
                (True, "bottom-right")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,align", VARLEN_MODES)
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("Hq,Hkv", [(2, 2), (8, 2)])
@pytest.mark.parametrize("case", VARLEN_CASES)
def test_varlen_forward_kernels_match_plain(cuda, dtype, causal, align, d,
                                            Hq, Hkv, case):
    """Both forward kernels, MHA and group 4: dead tiles skipped, rows
    that see no key (the pad tail, bottom-right rows of a sequence with
    more queries than keys) 0 in O, l and acc and -1e30 in M."""
    lens_q, lens_k, bM, bN = case
    q, k, v, _, _, _, masks, sm, tq = _varlen_inputs(
        cuda, lens_q, lens_k, Hq, Hkv, d, dtype, causal, align, bM, bN)
    before = dict(vl.launches)
    o = vl.varlen_fwd(q, k, v, *masks, causal, sm)
    acc, m, l = vl.varlen_fwd_partial(q, k, v, *masks, causal, sm)
    torch.cuda.synchronize()
    assert vl.launches == {**before,
                           "varlen_fwd": before["varlen_fwd"] + 1,
                           "varlen_fwd_partial":
                               before["varlen_fwd_partial"] + 1}
    pacc, pm, pl = vl.varlen_fwd_partial_plain(q, k, v, *masks, causal, sm)
    assert o.dtype == dtype
    assert _normwise(o, vl.varlen_fwd_plain(q, k, v, *masks, causal, sm)) \
        <= ATTN_TOL[dtype]
    assert _normwise((acc, l), (pacc, pl)) <= ATTN_TOL[dtype]
    seen = pl > 0
    assert _normwise(m[seen], pm[seen]) <= ATTN_TOL[dtype]
    assert bool((m[~seen] == -1e30).all()) and not l[~seen].any()
    assert not acc[~seen].any() and not o[~seen].any()
    assert not o[:, tq:].any() and not l[:, tq:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,align", VARLEN_MODES)
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("Hq,Hkv", [(2, 2), (8, 2)])
@pytest.mark.parametrize("case", VARLEN_CASES)
def test_varlen_backward_kernels_match_plain(cuda, dtype, causal, align, d,
                                             Hq, Hkv, case):
    """dK/dV (the table read transposed, the group summed) and dQ: lse2
    is -inf on rows that see no key, and the kernels' select keeps their
    P at 0 (no NaN)."""
    lens_q, lens_k, bM, bN = case
    q, k, v, do, lse2, delta, masks, sm, _ = _varlen_inputs(
        cuda, lens_q, lens_k, Hq, Hkv, d, dtype, causal, align, bM, bN)
    assert bool(torch.isinf(lse2).any())
    before = dict(vl.launches)
    dkdv = vl.varlen_bwd_dkdv(q, k, v, do, lse2, delta, *masks, causal, sm)
    dq = vl.varlen_bwd_dq(q, k, v, do, lse2, delta, *masks, causal, sm)
    torch.cuda.synchronize()
    assert vl.launches == {**before,
                           "varlen_bwd_dkdv": before["varlen_bwd_dkdv"] + 1,
                           "varlen_bwd_dq": before["varlen_bwd_dq"] + 1}
    assert _normwise(dkdv, vl.varlen_bwd_dkdv_plain(
        q, k, v, do, lse2, delta, *masks, causal, sm)) <= ATTN_TOL[dtype]
    assert _normwise(dq, vl.varlen_bwd_dq_plain(
        q, k, v, do, lse2, delta, *masks, causal, sm)) <= ATTN_TOL[dtype]


@pytest.mark.parametrize("causal,align", VARLEN_MODES)
def test_varlen_autograd_on_card_matches_cpu(cuda, causal, align):
    """flash_attention_varlen's kernel path on the card (one partial, one
    dK/dV and one dQ launch) against the same entry on CPU tensors, at
    group 4 with a ragged tail."""
    lens_q, lens_k = [70, 130, 9], [90, 120, 9]
    rng = np.random.default_rng(1)
    tq, tk = sum(lens_q) + 5, sum(lens_k) + 3
    q, k, v, g = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  for s in ((tq, 8, 64), (tk, 2, 64), (tk, 2, 64),
                            (tq, 8, 64)))
    cu_q = np.concatenate([[0], np.cumsum(lens_q)]).astype(np.int32)
    cu_k = np.concatenate([[0], np.cumsum(lens_k)]).astype(np.int32)
    outs, grads = [], []
    for dev in ("cpu", cuda):
        leaves = [t.detach().to(dev).requires_grad_() for t in (q, k, v)]
        before = dict(vl.launches)
        o = vl.flash_attention_varlen(*leaves, cu_q, cu_k, causal=causal,
                                      causal_align=align, block_M=64,
                                      block_N=64)
        o.backward(g.to(dev))
        if dev == cuda:
            torch.cuda.synchronize()
            assert vl.launches == {**before,
                                   "varlen_fwd_partial":
                                       before["varlen_fwd_partial"] + 1,
                                   "varlen_bwd_dkdv":
                                       before["varlen_bwd_dkdv"] + 1,
                                   "varlen_bwd_dq":
                                       before["varlen_bwd_dq"] + 1}
        outs.append(o.detach().cpu())
        grads.append([t.grad.cpu() for t in leaves])
    assert _normwise(outs[1].cuda(), outs[0].cuda()) <= 1e-4
    for a, b in zip(*grads):
        assert _normwise(b.cuda(), a.cuda()) <= 1e-4


def _varlen_calls(dev):
    q, k, v, do, lse2, delta, masks, sm, _ = _varlen_inputs(
        dev, [9, 20], [9, 20], 4, 2, 16, torch.float32, True, "top-left",
        16, 16)
    return [lambda: vl.varlen_fwd(q, k, v, *masks, True, sm),
            lambda: vl.varlen_fwd_partial(q, k, v, *masks, True, sm),
            lambda: vl.varlen_bwd_dkdv(q, k, v, do, lse2, delta, *masks,
                                       True, sm),
            lambda: vl.varlen_bwd_dq(q, k, v, do, lse2, delta, *masks, True,
                                     sm)]


def test_varlen_wrappers_raise_on_build_or_launch_failure(cuda, monkeypatch):
    """No fallback: a build failure is the build's error, a refused
    launch a KernelLaunchError naming the wrapper, and neither counts a
    launch; a head_dim without an instance is refused before."""
    calls = _varlen_calls(cuda)
    before = dict(vl.launches)

    def no_build(name):
        raise RuntimeError(f"nvcc failed building {name}")

    monkeypatch.setattr(_build, "load", no_build)
    for call in calls:
        with pytest.raises(RuntimeError, match="nvcc failed"):
            call()
    monkeypatch.setattr(_build, "load", lambda name: _RefusingLib())
    for call, name in zip(calls, vl.launches):
        with pytest.raises(KernelLaunchError, match=name):
            call()
    assert vl.launches == before
    x = torch.zeros((1, 8, 48), device=cuda)
    ids = torch.zeros(8, dtype=torch.int32, device=cuda)
    live = torch.ones((1, 1), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        vl.varlen_fwd(x, x, x, ids, ids, ids, ids, live, True, 0.1)


# ---------------------------------------------------------------------------
# the row softmax (csrc/softmax.cu)
# ---------------------------------------------------------------------------


SOFTMAX_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2,
               torch.float16: 1e-2}


def _softmax_close(got, want):
    """Normwise within the output type's bound, NaN where the plain
    version has NaN."""
    assert got.is_cuda and got.dtype == want.dtype and got.shape == want.shape
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    g, w = got.float()[~nan], want.float()[~nan]
    if w.numel():
        err = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        assert err <= SOFTMAX_TOL[want.dtype], err


@pytest.mark.parametrize("din,dout", [(torch.float32, torch.float32),
                                      (torch.bfloat16, torch.float32),
                                      (torch.float32, torch.bfloat16),
                                      (torch.float16, torch.float16)])
@pytest.mark.parametrize("M,N", [(4096, 8), (37, 1), (9, 1024), (5, 1025),
                                 (3, 49152), (3, 60001), (4, 201088)])
def test_softmax_kernel_matches_plain(cuda, din, dout, M, N):
    """Narrow rows (a warp a row: Mixtral's router width 8), rows a
    block holds in shared memory, and rows wider than it (gpt-oss's
    vocabulary, 201088: an online pass and a normalising pass)."""
    g = torch.Generator(device=cuda).manual_seed(M + N)
    x = (4 * torch.randn((M, N), generator=g, device=cuda)).to(din)
    before = smx.launches["softmax"]
    y = smx.softmax(x, out_dtype=dout)
    torch.cuda.synchronize()
    assert smx.launches["softmax"] == before + 1
    _softmax_close(y, smx.softmax_plain(x, dout))


@pytest.mark.parametrize("N", [40, 3000, 60001])
def test_softmax_kernel_nan_rows(cuda, N):
    """All -inf and +inf rows are NaN, a row with some -inf is finite, in
    both the warp and the block kernels."""
    x = torch.randn((6, N), device=cuda)
    x[0] = -math.inf
    x[1, N // 2] = math.inf
    x[2, : N // 2] = -math.inf
    x[3, -1] = math.inf
    x[3, 0] = -math.inf
    y = smx.softmax(x)
    _softmax_close(y, smx.softmax_plain(x, torch.float32))
    assert torch.isnan(y[[0, 1, 3]]).all()
    assert not torch.isnan(y[[2, 4, 5]]).any() and not y[2, : N // 2].any()


# ---------------------------------------------------------------------------
# attention with sinks (csrc/attention_sink.cu)
# ---------------------------------------------------------------------------


def _sink_inputs(dev, B, Hq, Hkv, Sq, Sk, D, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    return (rnd(B, Hq, Sq, D).to(dtype), rnd(B, Hkv, Sk, D).to(dtype),
            rnd(B, Hkv, Sk, D).to(dtype), rnd(Hq))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 1, 48, 128])
@pytest.mark.parametrize("Hq,Hkv", [(2, 2), (8, 1)])
@pytest.mark.parametrize("Sq,Sk", [(77, 77), (100, 260), (260, 100),
                                   (192, 64)])
def test_sink_kernel_matches_plain(cuda, dtype, causal, window, Hq, Hkv,
                                   Sq, Sk):
    """The window's edges (1: the key itself only; 48 inside a tile; 128),
    causal and not (the window bounds keys from below only), ragged S,
    Sq > Sk (rows whose window lies past Sk see no key: O = 0)."""
    q, k, v, s = _sink_inputs(cuda, 1, Hq, Hkv, Sq, Sk, 64, dtype)
    sm = 0.125
    before = sink.launches["attention_sink"]
    o = sink.sink_fwd(q, k, v, s, causal, window, sm)
    torch.cuda.synchronize()
    assert sink.launches["attention_sink"] == before + 1
    assert o.dtype == dtype
    assert _normwise(o, sink.sink_fwd_plain(q, k, v, s, causal, window,
                                            sm)) <= ATTN_TOL[dtype]


@pytest.mark.parametrize("d", [16, 32, 128])
def test_sink_kernel_head_dims(cuda, d):
    q, k, v, s = _sink_inputs(cuda, 2, 4, 2, 150, 150, d, torch.float32)
    o = sink.sink_fwd(q, k, v, s, True, 40, d ** -0.5)
    assert _normwise(o, sink.sink_fwd_plain(q, k, v, s, True, 40,
                                            d ** -0.5)) <= 1e-5


def test_sink_bfloat16_sinks_on_card(cuda):
    q, k, v, s = _sink_inputs(cuda, 1, 4, 2, 64, 64, 64, torch.float32)
    sb = s.to(torch.bfloat16)
    assert torch.equal(sink.attention_sink(q, k, v, sb),
                       sink.attention_sink(q, k, v, sb.float()))


@pytest.mark.parametrize("causal", [True, False])
def test_sink_autograd_on_card_matches_cpu(cuda, causal):
    """backward="kernel" on the card (one GQA partial, one dK/dV and one
    dQ launch, no sink launch) against the same Function on CPU tensors,
    dSinks included."""
    q, k, v, s = _sink_inputs("cpu", 1, 8, 2, 128, 128, 64, torch.float32)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(3))
    outs, grads = [], []
    for dev in ("cpu", cuda):
        leaves = [t.detach().to(dev).requires_grad_() for t in (q, k, v, s)]
        before = (dict(gqa.launches), dict(gb.launches),
                  dict(sink.launches))
        o = sink.attention_sink(*leaves, causal=causal, block_M=64,
                                block_N=64, backward="kernel")
        o.backward(g.to(dev))
        if dev == cuda:
            torch.cuda.synchronize()
            assert gqa.launches["gqa_fwd_partial"] == \
                before[0]["gqa_fwd_partial"] + 1
            assert gb.launches == {k_: n + 1 for k_, n in before[1].items()}
            assert sink.launches == before[2]
        outs.append(o.detach().cpu())
        grads.append([t.grad.cpu() for t in leaves])
    assert _normwise(outs[1].cuda(), outs[0].cuda()) <= 1e-4
    for a, b in zip(*grads):
        assert _normwise(b.cuda(), a.cuda()) <= 1e-4


# ---------------------------------------------------------------------------
# block-sparse attention (csrc/blocksparse_attention.cu)
# ---------------------------------------------------------------------------


BLOCKSPARSE_CASES = [  # Sq, Sk, block_M, block_N: cells under, at and
    (128, 128, 32, 32),    # over the kernel's 64 x 32 tiles, unaligned
    (192, 128, 64, 16),    # ones, and a ragged S
    (120, 120, 40, 24),
    (256, 256, 128, 128),
    (100, 60, 100, 60),
    (96, 160, 16, 80),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", ["random", "dead_rows", "zeros"])
@pytest.mark.parametrize("case", BLOCKSPARSE_CASES)
def test_blocksparse_kernel_matches_plain(cuda, dtype, causal, kind, case):
    """Liveness by the caller's cells: a tile overlapping a live cell is
    computed, each pair masked by its own cell; a row whose every cell
    is dead (or, causal, whose live cells lie above it) is exactly 0."""
    Sq, Sk, bM, bN = case
    q, k, v, _ = _sink_inputs(cuda, 2, 2, 2, Sq, Sk, 64, dtype, seed=1)
    g = torch.Generator(device=cuda).manual_seed(2)
    m = torch.randint(0, 2, (2, 2, Sq // bM, Sk // bN), generator=g,
                      device=cuda, dtype=torch.int32)
    if kind == "zeros":
        m.zero_()
    if kind == "dead_rows":
        m[..., ::2, :] = 0
    before = bsa.launches["blocksparse_mha"]
    o = bsa.blocksparse_mha(q, k, v, m, bM, bN, causal, 0.125)
    torch.cuda.synchronize()
    assert bsa.launches["blocksparse_mha"] == before + 1
    want = bsa.blocksparse_mha_plain(q, k, v, m, bM, bN, causal, 0.125)
    assert _normwise(o, want) <= ATTN_TOL[dtype]
    dead = ~bsa.dense_mask(m, bM, bN, causal).any(-1)
    assert not o[dead].any() and torch.equal(o[dead], want[dead])


def test_blocksparse_all_ones_causal_is_causal_attention(cuda):
    q, k, v, _ = _sink_inputs(cuda, 1, 4, 4, 256, 256, 128, torch.float32)
    ones = torch.ones((1, 4, 8, 8), dtype=torch.int32, device=cuda)
    o = bsa.blocksparse_attention(q, k, v, ones, block_M=32, block_N=32,
                                  causal=True)
    assert _normwise(o, fa.mha_fwd_plain(q, k, v, True, 128 ** -0.5)) <= 1e-5


def test_seer_attention_on_card_matches_cpu(cuda):
    q, k, v, _ = _sink_inputs("cpu", 1, 2, 2, 256, 256, 64, torch.float32)
    gates = torch.randn((1, 2, 8, 8), generator=torch.Generator()
                        .manual_seed(5))
    want = seer.seer_attention(q, k, v, gates, topk=3, block_M=32,
                               block_N=32)
    got = seer.seer_attention(*(t.to(cuda) for t in (q, k, v, gates)),
                              topk=3, block_M=32, block_N=32)
    assert _normwise(got, want.to(cuda)) <= 1e-4


def _slice10_calls(dev):
    q, k, v, s = _sink_inputs(dev, 1, 2, 2, 64, 64, 16, torch.float32)
    m = torch.ones((1, 2, 2, 2), dtype=torch.int32, device=dev)
    x = torch.zeros((4, 8), device=dev)
    return [(sink.launches, "attention_sink",
             lambda: sink.sink_fwd(q, k, v, s, True, 0, 0.25)),
            (smx.launches, "softmax", lambda: smx.softmax(x)),
            (bsa.launches, "blocksparse_mha",
             lambda: bsa.blocksparse_mha(q, k, v, m, 32, 32, False, 0.25))]


def test_slice10_wrappers_raise_on_build_or_launch_failure(cuda,
                                                           monkeypatch):
    """No fallback: a build failure is the build's error, a refused
    launch a KernelLaunchError naming the wrapper, and neither counts a
    launch; a head_dim outside KERNEL_HEAD_DIMS is refused before."""
    calls = _slice10_calls(cuda)
    before = [dict(c) for c, _, _ in calls]

    def no_build(name):
        raise RuntimeError(f"nvcc failed building {name}")

    monkeypatch.setattr(_build, "load", no_build)
    for _, _, call in calls:
        with pytest.raises(RuntimeError, match="nvcc failed"):
            call()
    monkeypatch.setattr(_build, "load", lambda name: _RefusingLib())
    for _, name, call in calls:
        with pytest.raises(KernelLaunchError, match=name):
            call()
    assert [dict(c) for c, _, _ in calls] == before
    x = torch.zeros((1, 2, 64, 48), device=cuda)
    m = torch.ones((1, 2, 1, 1), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        sink.sink_fwd(x, x, x, torch.zeros(2, device=cuda), True, 0, 0.1)
    with pytest.raises(ValueError, match="head_dim"):
        bsa.blocksparse_mha(x, x, x, m, 64, 64, False, 0.1)


# ---------------------------------------------------------------------------
# float16 through the repaired kernels
# ---------------------------------------------------------------------------


def _f16_attention_cases(dev):
    """(name, kernel call, plain call) of each attention kernel in
    float16."""
    f16 = torch.float16
    q, k, v, do, lse2, delta, sm = _attn_inputs(dev, 2, 4, 2, 100, 130, 64,
                                                f16, True)
    qm, km, vm, dom, lse2m, deltam, _ = _attn_inputs(dev, 2, 4, 4, 100, 130,
                                                     64, f16, True)
    q1, k1, v1, s1 = _sink_inputs(dev, 1, 4, 2, 150, 150, 64, f16)
    mask = torch.randint(0, 2, (1, 4, 150 // 30, 150 // 50),
                         generator=torch.Generator(device=dev).manual_seed(4),
                         device=dev, dtype=torch.int32)
    qb, kb, vb = q1, k1.repeat_interleave(2, 1), v1.repeat_interleave(2, 1)
    cu = np.array([0, 40, 128], np.int32)
    qv, kv_, vv = (t[0].transpose(0, 1)[:128].contiguous()
                   for t in (qm, km, vm))
    return [
        ("mha_fwd", lambda: fa.mha_fwd(qm, km, vm, True, sm),
         lambda: fa.mha_fwd_plain(qm, km, vm, True, sm)),
        ("mha_fwd_partial", lambda: fa.mha_fwd_partial(qm, km, vm, True, sm),
         lambda: fa.mha_fwd_partial_plain(qm, km, vm, True, sm)),
        ("gqa_fwd", lambda: gqa.gqa_fwd(q, k, v, False, sm),
         lambda: gqa.gqa_fwd_plain(q, k, v, False, sm)),
        ("gqa_bwd_dkdv",
         lambda: gb.gqa_bwd_dkdv(q, k, v, do, lse2, delta, True, sm),
         lambda: gb.gqa_bwd_dkdv_plain(q, k, v, do, lse2, delta, True, sm)),
        ("gqa_bwd_dq",
         lambda: gb.gqa_bwd_dq(q, k, v, do, lse2, delta, True, sm),
         lambda: gb.gqa_bwd_dq_plain(q, k, v, do, lse2, delta, True, sm)),
        ("varlen", lambda: vl.flash_attention_varlen(qv, kv_, vv, cu, cu,
                                                     causal=True),
         lambda: vl.flash_attention_varlen(qv.cpu(), kv_.cpu(), vv.cpu(),
                                           cu, cu, causal=True).to(dev)),
        ("attention_sink", lambda: sink.sink_fwd(q1, k1, v1, s1, True, 48,
                                                 0.125),
         lambda: sink.sink_fwd_plain(q1, k1, v1, s1, True, 48, 0.125)),
        ("blocksparse_mha",
         lambda: bsa.blocksparse_mha(qb, kb, vb, mask, 30, 50, True, 0.125),
         lambda: bsa.blocksparse_mha_plain(qb, kb, vb, mask, 30, 50, True,
                                           0.125)),
    ]


@pytest.mark.parametrize("case", range(8))
def test_attention_kernels_float16(cuda, case):
    """Each attention kernel in float16 (Q, K, V, P and O in the input
    type, float32 arithmetic) against its plain version."""
    name, kernel, plain = _f16_attention_cases(cuda)[case]
    got = kernel()
    torch.cuda.synchronize()
    want = plain()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert got[0].dtype == want[0].dtype
    assert _normwise(got, want) <= ATTN_TOL[torch.float16], name


def test_attention_autograd_float16_on_card_matches_cpu(cuda):
    """flash_attention's kernel path in float16 (partial forward, dK/dV
    and dQ) against the same Function on CPU tensors."""
    q, k, v, do, *_ = _attn_inputs("cpu", 1, 2, 2, 128, 128, 64,
                                   torch.float16, True)
    outs = []
    for dev in ("cpu", cuda):
        leaves = [t.detach().to(dev).requires_grad_() for t in (q, k, v)]
        o = fa.flash_attention(*leaves, causal=True)
        o.backward(do.to(dev))
        outs.append([o.detach()] + [t.grad for t in leaves])
    for a, b in zip(*outs):
        assert _normwise(b, a.to(cuda)) <= 2e-2


@pytest.mark.parametrize("d", [64, 128, 256])
def test_decode_kernels_float16(cuda, d):
    q, kp, vp, table = _case(cuda, 3, 4, d, 16, 8, 40, torch.float16)
    got = fd.paged_decode_partials(q, kp, vp, table, 16, 4, 0.1)
    torch.cuda.synchronize()
    want = fd.paged_decode_partials_plain(q, kp, vp, table, 16, 4, 0.1)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=TOL, atol=TOL)
    k = kp[:, :256].reshape(4, 2, 128, d).transpose(0, 1).contiguous()
    v = vp[:, :256].reshape(4, 2, 128, d).transpose(0, 1).contiguous()
    qq = q[:2]
    got = fd.decode_partials(qq, k, v, 2, 0.1)
    want = fd.decode_partials_plain(qq, k, v, 2, 0.1)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=TOL, atol=TOL)


def test_mla_decode_float16(cuda):
    g = torch.Generator(device=cuda).manual_seed(6)
    qc, qr, ckv, kpe = (torch.randn(s, generator=g, device=cuda)
                        .to(torch.float16)
                        for s in ((2, 16, 512), (2, 16, 64), (2, 256, 512),
                                  (2, 256, 64)))
    got = mla.mla_decode_partials(qc, qr, ckv, kpe, 2, 0.05)
    torch.cuda.synchronize()
    want = mla.mla_decode_partials_plain(qc, qr, ckv, kpe, 2, 0.05)
    assert _normwise(got, want) <= 2e-2


def test_gemm_kernels_float16(cuda):
    """The grouped GEMMs and the w4a16 kernels in float16."""
    g = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn((3, 130, 96), generator=g, device=cuda).half()
    w = torch.randn((3, 96, 72), generator=g, device=cuda).half()
    assert _normwise(gg.grouped_matmul(x, w),
                     gg.grouped_matmul_plain(x, w)) <= 1e-2
    a = x[0]
    got = gg.varlen_grouped_matmul(torch.cat([a, a]), w[:2], [130, 130])
    want = gg.varlen_grouped_matmul_plain(torch.cat([a, a]), w[:2],
                                          [130, 130])
    assert _normwise(got, want) <= 1e-5
    packed = torch.randint(0, 256, (64, 136), generator=g, device=cuda,
                           dtype=torch.uint8)
    scales = torch.rand((4, 136), generator=g, device=cuda)
    act = torch.randn((40, 128), generator=g, device=cuda).half()
    assert torch.equal(dqg.dequant_int4(packed, scales, 32, torch.float16),
                       dqg.dequant_int4_plain(packed, scales, 32,
                                              torch.float16))
    assert _normwise(dqg.dequant_matmul(act, packed, scales, block_K2=32),
                     dqg.dequant_matmul_plain(act, packed, scales, 32)) \
        <= 1e-2


# ---------------------------------------------------------------------------
# vertical-slash sparse attention (csrc/minference.cu)
# ---------------------------------------------------------------------------


def _vs_case(dev, H, S, D, dtype, bM, bN, nv, ns, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((1, H, S, D), generator=g, device=dev).to(dtype)
               for _ in range(3))
    v_idx = torch.randint(0, S, (1, H, nv), generator=g, device=dev)
    # slashes past S and below 0 too: they never match
    s_idx = torch.randint(-8, S + 8, (1, H, ns), generator=g, device=dev)
    vmask, bmask = mi._build_masks(v_idx, s_idx, S, S, bM, bN)
    return q, k, v, vmask, mi.diagonal_mask(s_idx, S), bmask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("blocks", [(64, 64), (64, 32), (32, 64), (16, 128)])
def test_vs_sparse_kernel_matches_plain(cuda, dtype, d, blocks):
    q, k, v, vm, dm, bm = _vs_case(cuda, 2, 256, d, dtype, *blocks, 12, 9)
    before = mi.launches["vs_sparse"]
    o = mi.vs_sparse(q, k, v, vm, dm, bm, *blocks, d ** -0.5)
    torch.cuda.synchronize()
    assert mi.launches["vs_sparse"] == before + 1
    assert _normwise(o, mi.vs_sparse_plain(q, k, v, vm, dm, bm, *blocks,
                                           d ** -0.5)) <= ATTN_TOL[dtype]


def test_vs_sparse_rows_that_see_nothing_are_zero(cuda):
    """Slash 5 only and one column at 200: rows 0-4 see no key (O
    exactly 0), and a slash at S or past matches nothing."""
    q, k, v, *_ = _vs_case(cuda, 1, 256, 64, torch.float32, 64, 64, 1, 1)
    v_idx = torch.tensor([[[200]]], device=cuda)
    s_idx = torch.tensor([[[5, 256, 300]]], device=cuda)
    o = mi.vertical_slash_sparse_attention(q, k, v, v_idx, s_idx)
    want = mi.vs_sparse_reference(q, k, v, v_idx, s_idx)
    assert not o[0, 0, :5].any()
    assert _normwise(o, want) <= 1e-5


def test_vs_sparse_all_diagonals_is_causal_attention(cuda):
    q, k, v, *_ = _vs_case(cuda, 2, 192, 64, torch.float32, 64, 64, 1, 1)
    s_idx = torch.arange(192, device=cuda).expand(1, 2, 192)
    o = mi.vertical_slash_sparse_attention(q, k, v, s_idx[..., :1], s_idx)
    assert _normwise(o, fa.mha_fwd_plain(q, k, v, True, 0.125)) <= 1e-5


# ---------------------------------------------------------------------------
# NSA inference (csrc/nsa.cu)
# ---------------------------------------------------------------------------


def _nsa_case(dev, B, T, G, H, D, S, BS, dtype, counts=None, seed=0):
    """Every token selects its own block, block 0 and random earlier ones
    (or -1); ``counts`` below S where given."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, T, H, G, D), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((B, T, H, D), generator=g, device=dev).to(dtype)
            for _ in range(2))
    own = (torch.arange(T, device=dev) // BS)[None, :, None, None]
    r = torch.randint(0, 1 << 20, (B, T, H, S), generator=g, device=dev)
    bi = torch.where(r % 5 == 0, -1, r % (own + 1))
    bi[..., 0] = own[..., 0]
    bi[..., -1] = 0
    gs, gw = (torch.rand((B, T, H, G), generator=g, device=dev) * 0.8 + 0.2
              for _ in range(2))
    cnt = torch.full((B, T, H), S, device=dev, dtype=torch.int32) \
        if counts is None else torch.randint(
            0, S + 1, (B, T, H), generator=g, device=dev, dtype=torch.int32)
    return (q, k.transpose(1, 2), v.transpose(1, 2), bi.to(torch.int32),
            cnt, gs, gw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("T,BS,window", [(64, 16, 0), (40, 16, 24),
                                         (100, 32, 48), (96, 64, 300)])
@pytest.mark.parametrize("G,H", [(2, 2), (4, 1), (16, 2), (24, 1),
                                 (64, 1)])
def test_nsa_fwd_kernel_matches_plain(cuda, dtype, T, BS, window, G, H):
    """Ragged T (40, 100: the last block partial), groups padded to the
    row tile (2, 4, 16, and 24 and 64 in the 64-row tile), a window past
    T, T not a multiple of the 16-bit prefill kernel's four tokens a
    block (100); a second call gives the same bits (the 16-bit kernels'
    key streams merge in a fixed order); without a window the 16-bit
    kernel walks the keys as its emulation does."""
    q, kh, vh, bi, cnt, gs, gw = _nsa_case(cuda, 2, T, G, H, 32, 4, BS,
                                           dtype)
    before = nsa.launches["nsa_fwd"]
    o = nsa.nsa_fwd(q, kh, vh, bi, cnt, gs, gw, BS, window, 0.2)
    torch.cuda.synchronize()
    assert nsa.launches["nsa_fwd"] == before + 1
    want = nsa.nsa_fwd_plain(q, kh, vh, bi, cnt, gs, gw, BS, window, 0.2)
    assert _normwise(o, want) <= ATTN_TOL[dtype]
    assert torch.equal(o, nsa.nsa_fwd(q, kh, vh, bi, cnt, gs, gw, BS,
                                      window, 0.2))
    if dtype != torch.float32 and G <= 16 and window == 0:
        # a warp a token: one stream
        streams = nsa.nsa_fwd_streams_plain(q, kh, vh, bi, cnt, gs, gw, BS,
                                            window, 0.2, streams=1)
        assert _normwise(o, streams) <= ATTN_TOL[dtype]


def _unaligned(t):
    """``t (B, H, Tk, D)`` as the (B, Tk, H, D) layout's view, 3
    elements into a buffer: no row 16-byte aligned."""
    x = t.transpose(1, 2)
    buf = torch.empty(x.numel() + 3, dtype=t.dtype, device=t.device)
    y = buf[3:].view(x.shape)
    y.copy_(x)
    return y.transpose(1, 2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("H", [2, 1])
def test_nsa_kernels_take_unaligned_views(cuda, dtype, H):
    """K and V whose rows are not 16-byte aligned: the 16-bit kernels'
    wrappers copy them first, with the same result. One KV head makes
    the (B, H, Tk, D) view contiguous with its base unaligned."""
    q, kh, vh, bi, cnt, gs, gw = _nsa_case(cuda, 1, 64, 4, H, 32, 3, 16,
                                           dtype)
    kh2, vh2 = _unaligned(kh), _unaligned(vh)
    assert kh2.data_ptr() % 16 and torch.equal(kh2, kh)
    assert torch.equal(nsa.nsa_fwd(q, kh2, vh2, bi, cnt, gs, gw, 16, 20, 0.2),
                       nsa.nsa_fwd(q, kh, vh, bi, cnt, gs, gw, 16, 20, 0.2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_nsa_kernels_head_dims_and_counts(cuda, d, dtype):
    """Each head_dim; block counts below S, 0 included: a token with no
    slot and no window gives exactly 0."""
    q, kh, vh, bi, cnt, gs, gw = _nsa_case(cuda, 1, 80, 4, 2, d, 3, 16,
                                           dtype, counts=True)
    o = nsa.nsa_fwd(q, kh, vh, bi, cnt, gs, gw, 16, 0, d ** -0.5)
    want = nsa.nsa_fwd_plain(q, kh, vh, bi, cnt, gs, gw, 16, 0, d ** -0.5)
    assert _normwise(o, want) <= ATTN_TOL[dtype]
    empty = cnt == 0
    assert bool(empty.any()) and not o[empty].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("G", [2, 16])
def test_nsa_varlen_kernel_matches_plain(cuda, dtype, G):
    """Packed sequences of 37, 64 and 27 tokens plus 8 pad rows, through
    the entry point: each token's keys stay in its sequence."""
    lens, H, D, S, BS = [37, 64, 27], 2, 64, 3, 16
    cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    T = int(cu[-1]) + 8
    q, kh, vh, bi, cnt, gs, _ = _nsa_case(cuda, 1, T, G, H, D, S, BS, dtype)
    args = (q.reshape(T, H * G, D), kh[0].transpose(0, 1),
            vh[0].transpose(0, 1), gs.reshape(T, H * G), bi[0] % 2)
    before = nsa.launches["nsa_varlen_fwd"]
    o = nsa.nsa_attention_varlen(*args, cu, block_size=BS)
    torch.cuda.synchronize()
    assert nsa.launches["nsa_varlen_fwd"] == before + 1
    want = nsa.nsa_attention_varlen(*(t.cpu() for t in args), cu,
                                    block_size=BS)
    assert _normwise(o, want.to(cuda)) <= ATTN_TOL[dtype]
    assert not o[int(cu[-1]):].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("Tk,BS,G", [(64, 16, 4), (1000, 64, 16),
                                     (77, 32, 2), (200, 16, 64)])
@pytest.mark.parametrize("splits", [None, 1, 2, 5, 8])
def test_nsa_decode_kernel_matches_plain(cuda, dtype, Tk, BS, G, splits):
    """The split decode: the card's own split count (None), one run,
    runs of several slots, one slot a run (5) and more runs than slots
    (8: runs that hold no slot); ragged Tk (1000 and 77: the last block
    partial), G up to 64, counts below S (0 included: exactly 0). Each
    launch counted under its name; the partials equal the split's plain
    version, the output the unsplit one."""
    q, kh, vh, bi, cnt, gs, _ = _nsa_case(cuda, 3, Tk, G, 2, 128, 5, BS,
                                          dtype, counts=True)
    args = (q[:, -1], kh, vh, bi[:, -1], cnt[:, -1], gs[:, -1], BS, 0.09)
    before = dict(nsa.launches)
    o = nsa.nsa_decode_fwd(*args) if splits is None else \
        nsa.nsa_decode_combine(*nsa.nsa_decode_partials(
            *args[:5], BS, 0.09, splits), args[5], dtype)
    torch.cuda.synchronize()
    assert nsa.launches == {**before,
                            "nsa_decode": before["nsa_decode"] + 1,
                            "nsa_decode_combine":
                                before["nsa_decode_combine"] + 1}
    tol = ATTN_TOL[dtype]
    assert _normwise(o, nsa.nsa_decode_fwd_plain(*args)) <= tol
    assert not o[cnt[:, -1] == 0].any()
    n = splits or nsa.decode_splits(3, 2, 5, nsa.resident_blocks(
        q.device, G, 128, dtype))
    assert _normwise(o, nsa.nsa_decode_split_plain(*args, n)) <= tol
    parts = nsa.nsa_decode_partials(*args[:5], BS, 0.09, n)
    want = nsa.nsa_decode_partials_plain(*args[:5], BS, 0.09, n)
    assert _normwise(parts[0], want[0]) <= tol
    assert _normwise(parts[2], want[2]) <= tol
    seen = want[2] > 0
    assert torch.equal(parts[1][~seen], want[1][~seen])   # -1e30
    assert _normwise(parts[1][seen], want[1][seen]) <= tol
    assert torch.equal(nsa.nsa_decode_combine(*parts, args[5], dtype), o)


def test_nsa_decode_splits_the_card(cuda):
    """At chip_smoke.py's widths (B 8, 4 KV heads of a group of 16, 16
    slots) decode runs more than B H blocks."""
    for dtype in (torch.float32, torch.bfloat16):
        n = nsa.decode_splits(8, 4, 16, nsa.resident_blocks(
            torch.device(cuda), 16, 128, dtype))
        assert 8 * 4 * n > 8 * 4


def _slice11_calls(dev):
    q, k, v, vm, dm, bm = _vs_case(dev, 1, 64, 16, torch.float32, 32, 32,
                                   2, 2)
    nq, kh, vh, bi, cnt, gs, gw = _nsa_case(dev, 1, 32, 2, 1, 16, 2, 8,
                                            torch.float32)
    return [(mi.launches, "vs_sparse",
             lambda: mi.vs_sparse(q, k, v, vm, dm, bm, 32, 32, 0.25)),
            (nsa.launches, "nsa_fwd",
             lambda: nsa.nsa_fwd(nq, kh, vh, bi, cnt, gs, gw, 8, 4, 0.25)),
            (nsa.launches, "nsa_varlen_fwd",
             lambda: nsa.nsa_varlen_fwd(nq, kh, vh, bi, cnt, gs, 8, 0.25)),
            (nsa.launches, "nsa_decode",
             lambda: nsa.nsa_decode_fwd(nq[:, 0], kh, vh, bi[:, 0],
                                        cnt[:, 0], gs[:, 0], 8, 0.25))]


def test_slice11_wrappers_raise_on_build_or_launch_failure(cuda,
                                                           monkeypatch):
    """No fallback: a build failure is the build's error, a refused
    launch a KernelLaunchError naming the wrapper, and neither counts a
    launch; a head_dim or group the kernel lacks is refused before."""
    calls = _slice11_calls(cuda)
    before = [dict(c) for c, _, _ in calls]

    def no_build(name):
        raise RuntimeError(f"nvcc failed building {name}")

    monkeypatch.setattr(_build, "load", no_build)
    for _, _, call in calls:
        with pytest.raises(RuntimeError, match="nvcc failed"):
            call()
    monkeypatch.setattr(_build, "load", lambda name: _RefusingLib())
    for _, name, call in calls:
        with pytest.raises(KernelLaunchError, match=name):
            call()
    assert [dict(c) for c, _, _ in calls] == before
    nq, kh, vh, bi, cnt, gs, gw = _nsa_case(cuda, 1, 16, 65, 1, 16, 2, 8,
                                            torch.float32)
    with pytest.raises(ValueError, match="groups"):
        nsa.nsa_fwd(nq, kh, vh, bi, cnt, gs, gw, 8, 0, 0.25)


# ---------------------------------------------------------------------------
# NSA training (csrc/nsa.cu's partial forward, csrc/nsa_bwd.cu)
# ---------------------------------------------------------------------------

nsa_bwd = importlib.import_module("tilelang_mesh_tpu_torch.ops.nsa_bwd")


def _nsa_grad_case(dev, B, T, G, H, D, S, BS, dtype, counts=None, seed=0):
    """``_nsa_case``'s inputs (-1 slots, duplicate ids, block 0 in every
    token's last slot) and the backward's: an incoming gradient, lse2 and
    delta from the plain partial forward, the multiplicity map."""
    q, kh, vh, bi, cnt, _, _ = _nsa_case(dev, B, T, G, H, D, S, BS, dtype,
                                         counts, seed)
    acc, m, l = nsa.nsa_fwd_partial_plain(q, kh, vh, bi, cnt, BS, 0.2)
    o = torch.where(l[..., None] > 0, acc / l[..., None], 0.0).to(dtype)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    do = torch.randn(q.shape, generator=g, device=dev).to(dtype)
    delta = (do.float() * o.float()).sum(-1)
    mask = nsa_bwd.nsa_block_mask(bi, cnt, T, -(-T // BS), BS)
    return q, kh, vh, bi, cnt, do, m + torch.log2(l), delta, mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("T,BS", [(64, 16), (40, 16), (100, 32), (96, 64)])
@pytest.mark.parametrize("G,H", [(1, 3), (2, 2), (16, 1), (24, 1), (64, 1)])
def test_nsa_fwd_partial_kernel_matches_plain(cuda, dtype, T, BS, G, H):
    """(acc, m, l) of the selected branch: ragged T, groups 1 to 64,
    counts below S (0 included: l = 0, m = -1e30, acc = 0)."""
    q, kh, vh, bi, cnt, _, _ = _nsa_case(cuda, 2, T, G, H, 32, 4, BS, dtype,
                                         counts=True)
    before = nsa.launches["nsa_fwd_partial"]
    acc, m, l = nsa.nsa_fwd_partial(q, kh, vh, bi, cnt, BS, 0.2)
    torch.cuda.synchronize()
    assert nsa.launches["nsa_fwd_partial"] == before + 1
    wa, wm, wl = nsa.nsa_fwd_partial_plain(q, kh, vh, bi, cnt, BS, 0.2)
    assert _normwise((acc, l), (wa, wl)) <= ATTN_TOL[dtype]
    seen = wl > 0
    assert bool(seen.any()) and bool((~seen).any())
    assert _normwise(m[seen], wm[seen]) <= 1e-5
    assert bool((m[~seen] == -1e30).all()) and not l[~seen].any() \
        and not acc[~seen].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("G,H", [(1, 3), (2, 2), (16, 1), (64, 1)])
@pytest.mark.parametrize("chunk_rows", [2048, 40])
def test_nsa_bwd_kernels_match_plain(cuda, monkeypatch, dtype, G, H,
                                     chunk_rows):
    """dK / dV (and its fixed-order sum) and dQ against the plain
    versions: -1 slots, duplicate ids, counts below S; chunks of 40 rows
    cut each block's tokens into many partials."""
    monkeypatch.setattr(nsa_bwd, "DKDV_CHUNK_ROWS", chunk_rows)
    q, kh, vh, bi, cnt, do, lse2, delta, mask = _nsa_grad_case(
        cuda, 2, 96, G, H, 32, 4, 16, dtype, counts=True)
    assert int(mask.max()) >= 2
    before = dict(nsa_bwd.launches)
    dk, dv = nsa_bwd.nsa_bwd_dkdv(q, kh, vh, do, lse2, delta, mask, 16, 0.2)
    dq = nsa_bwd.nsa_bwd_dq(q, kh, vh, do, lse2, delta, bi, cnt, 16, 0.2)
    torch.cuda.synchronize()
    assert nsa_bwd.launches == {k: n + 1 for k, n in before.items()}
    assert _normwise((dk, dv), nsa_bwd.nsa_bwd_dkdv_plain(
        q, kh, vh, do, lse2, delta, mask, 16, 0.2)) <= ATTN_TOL[dtype]
    assert _normwise(dq, nsa_bwd.nsa_bwd_dq_plain(
        q, kh, vh, do, lse2, delta, bi, cnt, 16, 0.2)) <= ATTN_TOL[dtype]
    # no atomics: the same bits again
    assert all(torch.equal(a, b) for a, b in zip(
        (dk, dv), nsa_bwd.nsa_bwd_dkdv(q, kh, vh, do, lse2, delta, mask,
                                       16, 0.2)))


@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_nsa_training_kernels_head_dims(cuda, d):
    q, kh, vh, bi, cnt, do, lse2, delta, mask = _nsa_grad_case(
        cuda, 1, 128, 4, 2, d, 3, 32, torch.float32, counts=True)
    acc, _, l = nsa.nsa_fwd_partial(q, kh, vh, bi, cnt, 32, 0.2)
    wa, _, wl = nsa.nsa_fwd_partial_plain(q, kh, vh, bi, cnt, 32, 0.2)
    assert _normwise((acc, l), (wa, wl)) <= 1e-5
    got = nsa_bwd.nsa_bwd_dkdv(q, kh, vh, do, lse2, delta, mask, 32, 0.2)
    assert _normwise(got, nsa_bwd.nsa_bwd_dkdv_plain(
        q, kh, vh, do, lse2, delta, mask, 32, 0.2)) <= 1e-5
    got = nsa_bwd.nsa_bwd_dq(q, kh, vh, do, lse2, delta, bi, cnt, 32, 0.2)
    assert _normwise(got, nsa_bwd.nsa_bwd_dq_plain(
        q, kh, vh, do, lse2, delta, bi, cnt, 32, 0.2)) <= 1e-5


def test_nsa_bwd_dkdv_block0_of_every_token(cuda):
    """The unbalanced case: every token selects block 0 (1024 tokens of
    16 query heads: eight chunks of 2048 rows for block 0, one or two for
    the others), summed in chunk order; the same bits on a second call."""
    T, G, H, D, BS = 1024, 16, 2, 128, 64
    q, kh, vh, bi, cnt, do, lse2, delta, mask = _nsa_grad_case(
        cuda, 1, T, G, H, D, 4, BS, torch.float32)
    assert bool((mask[..., 0] >= 1).all())
    _, _, chunks, first = nsa_bwd.dkdv_plan(mask, G)
    assert int(first[1] - first[0]) == T * G // nsa_bwd.DKDV_CHUNK_ROWS
    got = nsa_bwd.nsa_bwd_dkdv(q, kh, vh, do, lse2, delta, mask, BS, 0.2)
    assert _normwise(got, nsa_bwd.nsa_bwd_dkdv_plain(
        q, kh, vh, do, lse2, delta, mask, BS, 0.2)) <= 1e-5
    again = nsa_bwd.nsa_bwd_dkdv(q, kh, vh, do, lse2, delta, mask, BS, 0.2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nsa_training_autograd_on_card_matches_cpu(cuda, dtype):
    """nsa_attention(backward="kernel") under autograd: one partial, one
    dK / dV and its sum, one dQ; output and dQ, dK, dV, dG against the
    same step on CPU tensors (the plain versions)."""
    B, T, HQ, H, D, S, BS = 1, 192, 8, 2, 64, 4, 32
    g = torch.Generator().manual_seed(3)
    base = [torch.randn(s, generator=g) for s in
            ((B, T, HQ, D), (B, T, H, D), (B, T, H, D), (B, T, HQ, D))]
    gs = torch.rand((B, T, HQ), generator=g) * 0.8 + 0.2
    own = torch.arange(T)[None, :, None, None] // BS
    bi = torch.where(torch.rand((B, T, H, S), generator=g) < 0.2, -1,
                     torch.randint(0, 1 << 20, (B, T, H, S), generator=g)
                     % (own + 1))
    bi[..., 0] = own[..., 0]
    bi = bi.to(torch.int32)
    grads = {}
    for dev in ("cpu", cuda):
        leaves = [t.to(dev, dtype, copy=True).requires_grad_()
                  for t in base[:3]]
        leaves.append(gs.to(dev, copy=True).requires_grad_())
        nsa.reset_launches()
        nsa_bwd.reset_launches()
        o = nsa.nsa_attention(*leaves[:3], leaves[3], leaves[3], bi.to(dev),
                              block_size=BS, backward="kernel")
        o.backward(base[3].to(dev).to(dtype))
        if dev != "cpu":
            torch.cuda.synchronize()
            assert nsa.launches["nsa_fwd_partial"] == 1
            assert nsa_bwd.launches == {"nsa_bwd_dkdv": 1,
                                        "nsa_bwd_dkdv_sum": 1,
                                        "nsa_bwd_dq": 1}
        grads[str(dev)] = [o.detach()] + [t.grad for t in leaves]
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for got, want in zip(grads["cuda"], grads["cpu"]):
        assert _normwise(got, want.to(cuda)) <= tol


def _slice12_calls(dev):
    q, kh, vh, bi, cnt, do, lse2, delta, mask = _nsa_grad_case(
        dev, 1, 32, 2, 1, 16, 2, 8, torch.float32)
    return [(nsa.launches, "nsa_fwd_partial",
             lambda: nsa.nsa_fwd_partial(q, kh, vh, bi, cnt, 8, 0.25)),
            (nsa_bwd.launches, "nsa_bwd_dkdv",
             lambda: nsa_bwd.nsa_bwd_dkdv(q, kh, vh, do, lse2, delta, mask,
                                          8, 0.25)),
            (nsa_bwd.launches, "nsa_bwd_dq",
             lambda: nsa_bwd.nsa_bwd_dq(q, kh, vh, do, lse2, delta, bi, cnt,
                                        8, 0.25))]


def test_slice12_wrappers_raise_on_build_or_launch_failure(cuda,
                                                           monkeypatch):
    """No fallback: a build failure is the build's error, a refused
    launch a KernelLaunchError naming the wrapper, and neither counts a
    launch; a head_dim the kernels lack is refused before."""
    calls = _slice12_calls(cuda)
    before = [dict(c) for c, _, _ in calls]

    def no_build(name):
        raise RuntimeError(f"nvcc failed building {name}")

    monkeypatch.setattr(_build, "load", no_build)
    for _, _, call in calls:
        with pytest.raises(RuntimeError, match="nvcc failed"):
            call()
    monkeypatch.setattr(_build, "load", lambda name: _RefusingLib())
    for _, name, call in calls:
        with pytest.raises(KernelLaunchError, match=name):
            call()
    assert [dict(c) for c, _, _ in calls] == before
    q, kh, vh, bi, cnt, do, lse2, delta, mask = _nsa_grad_case(
        cuda, 1, 32, 2, 1, 24, 2, 8, torch.float32)
    with pytest.raises(ValueError, match="head_dim"):
        nsa_bwd.nsa_bwd_dq(q, kh, vh, do, lse2, delta, bi, cnt, 8, 0.25)


# ---------------------------------------------------------------------------
# DSA (csrc/dsa.cu: indexer and selector; csrc/sparse_mla.cu)
# ---------------------------------------------------------------------------

dsa = importlib.import_module("tilelang_mesh_tpu_torch.ops.dsa")

DSA_INDEXER_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2,
                   torch.float16: 1e-2}


def _finite_normwise(got, want):
    """-inf at the same places, the finite entries normwise."""
    assert got.is_cuda and got.dtype == want.dtype and got.shape == want.shape
    inf = torch.isinf(want)
    assert torch.equal(torch.isinf(got), inf)
    assert bool((got[inf] == want[inf]).all())
    g, w = got[~inf], want[~inf]
    return float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("B,S,Skv,HI,DI,q_offset", [
    (1, 64, 128, 4, 32, None), (2, 200, 333, 3, 48, 17),
    (1, 130, 130, 2, 36, None), (1, 300, 1000, 8, 128, 500)])
def test_lightning_indexer_kernel_matches_plain(cuda, dtype, B, S, Skv, HI,
                                                DI, q_offset):
    """Ragged S and Skv (no multiple of the 128 x 128 tile), a head width
    off the 16-byte path (36 in 16-bit types), whole tiles past the
    causal bound; -inf exactly where the plain version has it."""
    qi = _randn(cuda, (B, S, HI, DI), dtype, 0)
    ki = _randn(cuda, (B, Skv, DI), dtype, 1)
    w = _randn(cuda, (B, S, HI), torch.float32, 2)
    before = dsa.launches["lightning_indexer"]
    got = dsa.lightning_indexer(qi, ki, w, q_offset=q_offset)
    torch.cuda.synchronize()
    assert dsa.launches["lightning_indexer"] == before + 1
    off = Skv - S if q_offset is None else q_offset
    want = dsa.lightning_indexer_plain(qi, ki, w, off)
    assert _finite_normwise(got, want) <= DSA_INDEXER_TOL[dtype]


def _selector_case(dev, B, S, Skv, seed):
    """Small integers (ties), finite entries at and below -1e30, -inf,
    NaN-free; a row with three candidates."""
    g = torch.Generator(device=dev).manual_seed(seed)
    L = torch.randint(-3, 4, (B, S, Skv), generator=g, device=dev).float()
    u = torch.rand((B, S, Skv), generator=g, device=dev)
    L[u < 0.1] = -2e30
    L[(u >= 0.1) & (u < 0.15)] = -1e30
    L[(u >= 0.15) & (u < 0.25)] = -math.inf
    L[(u >= 0.25) & (u < 0.3)] = -0.0
    L[0, 0, 3:] = -math.inf
    return L


@pytest.mark.parametrize("B,S,Skv,topk,ties", [
    (2, 80, 96, 32, True), (1, 17, 1000, 300, True),
    (1, 4, 8192, 2048, True), (1, 3, 50, 64, True),
    (2, 33, 8192, 2048, False), (1, 5, 777, 1, False)])
def test_topk_selector_kernel_equals_plain(cuda, B, S, Skv, topk, ties):
    """Ids equal to the plain version's, ties to the smaller id, -1 past
    the candidates; topk above Skv; continuous logits of the indexer."""
    if ties:
        L = _selector_case(cuda, B, S, Skv, Skv)
    else:
        qi = _randn(cuda, (B, S, 4, 32), torch.float32, 3)
        ki = _randn(cuda, (B, Skv, 32), torch.float32, 4)
        L = dsa.lightning_indexer(qi, ki, _randn(cuda, (B, S, 4),
                                                 torch.float32, 5),
                                  q_offset=Skv // 2)
    before = dsa.launches["topk_selector"]
    got = dsa.topk_selector(L, topk)
    torch.cuda.synchronize()
    assert dsa.launches["topk_selector"] == before + 1
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, S, topk)
    assert torch.equal(got, dsa.topk_selector_plain(L, topk))


def _sparse_mla_case(dev, B, S, Skv, H, D, DT, topk, dtype, seed=0):
    """Causal draws of ids with duplicates, -1 slots, ids past the causal
    bound and at or past Skv, and one row with no valid id."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, S, H, D + DT), generator=g, device=dev).to(dtype)
    kv = torch.randn((B, Skv, D + DT), generator=g, device=dev).to(dtype)
    bound = (Skv - S) + torch.arange(S, device=dev)
    u = torch.rand((B, S, topk), generator=g, device=dev)
    ind = (u * (bound[None, :, None] + 1).float()).long()
    ind[..., 1::7] = ind[..., 0::7][..., :ind[..., 1::7].shape[-1]]
    ind[..., 2::9] = -1
    ind[..., 3::11] = Skv + 5
    ind[:, :, 4::13] = (bound[None, :, None] + 1) % Skv
    ind[0, S // 2] = -1
    return q, kv, ind.to(torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("D,DT", dsa.KERNEL_WIDTHS)
@pytest.mark.parametrize("B,S,Skv,H,topk", [(1, 64, 128, 8, 32),
                                            (2, 37, 101, 20, 40)])
def test_sparse_mla_kernel_matches_plain(cuda, dtype, D, DT, B, S, Skv, H,
                                         topk):
    """O normwise at the attention bounds, LSE 1e-5 of its largest live
    value; the row with no valid id O exactly 0 and LSE the JAX kernel's
    -6.931472e29. H not a multiple of the 16-head group, topk not a
    multiple of the 32-slot tile."""
    q, kv, ind = _sparse_mla_case(cuda, B, S, Skv, H, D, DT, topk, dtype)
    sm = 1 / math.sqrt(D + DT)
    before = dsa.launches["sparse_mla_fwd"]
    o, lse = dsa.sparse_mla_fwd(q, kv, ind, tail_dim=DT, block_I=topk)
    torch.cuda.synchronize()
    assert dsa.launches["sparse_mla_fwd"] == before + 1
    want_o, want_lse = dsa.sparse_mla_fwd_plain(q, kv, ind, D, sm, Skv - S)
    assert _normwise(o, want_o) <= ATTN_TOL[dtype]
    assert bool((o[0, S // 2] == 0).all())
    dead = torch.zeros_like(lse, dtype=torch.bool)
    dead[0, S // 2] = True
    assert bool((lse[dead] == torch.tensor(dsa.DEAD_ROW_LSE)).all())
    assert bool((want_lse[dead] == lse[dead]).all())
    err = (lse[~dead] - want_lse[~dead]).abs().max()
    assert float(err) <= 1e-5 * float(want_lse[~dead].abs().max())


def test_dsa_chain_and_finetune_on_card_match_cpu(cuda):
    """The pipeline (indexer, selector, sparse MLA) and a fine-tuning
    step's gradients on the card against the same calls on the CPU, 1e-4
    normwise (float32; the CPU runs the plain versions); the ids equal."""
    B, S, Skv, HI, DI, H, D, DT, topk = 1, 64, 256, 4, 32, 16, 512, 64, 32
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in (
        (B, S, HI, DI), (B, Skv, DI), (B, S, HI), (B, S, H, D + DT),
        (B, Skv, D + DT), (B, S, H, D))]
    outs = {}
    for dev in ("cpu", "cuda"):
        qi, ki, w, q, kv, do = (torch.from_numpy(a).to(dev) for a in arrays)
        ind = dsa.topk_selector(dsa.lightning_indexer(qi, ki, w), topk)
        o, lse = dsa.sparse_mla_fwd(q, kv, ind)
        qg, kvg = q.requires_grad_(), kv.requires_grad_()
        dsa.make_sparse_mla()(qg, kvg, ind).backward(do)
        outs[dev] = [t.detach().cpu() for t in (ind, o, lse, qg.grad,
                                                kvg.grad)]
    assert torch.equal(outs["cuda"][0], outs["cpu"][0])
    for g, w in zip(outs["cuda"][1:], outs["cpu"][1:]):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())


def test_dsa_wrappers_raise_on_build_or_launch_failure(cuda, monkeypatch):
    """No fallback: a build failure is the build's error, a refused
    launch a KernelLaunchError naming the wrapper, and neither counts a
    launch; a row past the selector's shared memory and a latent width
    without an instance are refused before."""
    qi = torch.zeros((1, 8, 2, 32), device=cuda)
    ki = torch.zeros((1, 8, 32), device=cuda)
    w = torch.zeros((1, 8, 2), device=cuda)
    L = torch.zeros((1, 8, 8), device=cuda)
    q = torch.zeros((1, 8, 16, 192), device=cuda)
    kv = torch.zeros((1, 8, 192), device=cuda)
    ind = torch.zeros((1, 8, 16), dtype=torch.int32, device=cuda)
    calls = [("lightning_indexer", lambda: dsa.lightning_indexer(qi, ki, w)),
             ("topk_selector", lambda: dsa.topk_selector(L, 4)),
             ("sparse_mla_fwd",
              lambda: dsa.sparse_mla_fwd(q, kv, ind, block_I=16))]
    before = dict(dsa.launches)

    def no_build(name):
        raise RuntimeError(f"nvcc failed building {name}")

    monkeypatch.setattr(_build, "load", no_build)
    for _, call in calls:
        with pytest.raises(RuntimeError, match="nvcc failed"):
            call()
    monkeypatch.setattr(_build, "load", lambda name: _RefusingLib())
    for name, call in calls:
        with pytest.raises(KernelLaunchError, match=name):
            call()
    assert dsa.launches == before
    with pytest.raises(ValueError, match="shared memory"):
        dsa.topk_selector(torch.zeros((1, 1, 60000), device=cuda), 2048)
    with pytest.raises(ValueError, match="takes"):
        dsa.sparse_mla_fwd(torch.zeros((1, 8, 4, 96), device=cuda),
                           torch.zeros((1, 8, 96), device=cuda), ind,
                           block_I=16)


# ---------------------------------------------------------------------------
# the bench yardsticks (#42, #43)
# ---------------------------------------------------------------------------

# the GEMM yardstick's (input, output) types
YS_PAIRS = [(torch.float32, torch.float32),
            (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
            (torch.float16, torch.float16), (torch.float16, torch.float32),
            (torch.float8_e4m3fn, torch.float8_e4m3fn),
            (torch.float8_e4m3fn, torch.float32)]


def _bit_equal(got, want):
    """Equal bytes; an e4m3 output NaN at the same places, its finite
    values equal."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.float8_e4m3fn:
        g, w = got.float(), want.float()
        assert torch.equal(g.isnan(), w.isnan())
        assert torch.equal(g.nan_to_num(0.0), w.nan_to_num(0.0))
    else:
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


@pytest.mark.parametrize("pair", YS_PAIRS, ids=lambda p: "-".join(
    str(d).split(".")[1] for d in p))
@pytest.mark.parametrize("blk", sorted(ys.KERNEL_BLOCKS),
                         ids=lambda b: "x".join(map(str, b)))
@pytest.mark.parametrize("shape", [(512, 512, 512), (256, 768, 192)])
def test_yardstick_gemm_matches_plain(cuda, pair, blk, shape):
    """#42 at every instance in every type pair: one launch a call,
    within the output type's tolerance of the plain version."""
    (dt, out), (M, N, K) = pair, shape
    a = _operand(cuda, (M, K), dt, 21)
    b = _operand(cuda, (K, N), dt, 22)
    fn = ys.hand_matmul(M, N, K, *blk, dtype=dt, out_dtype=out)
    before = ys.launches["yardstick_gemm"]
    got = fn(a, b)
    torch.cuda.synchronize()
    assert ys.launches["yardstick_gemm"] == before + 1
    _close(got, ys.hand_matmul_plain(a, b, out))


@pytest.mark.parametrize("pair", YS_PAIRS, ids=lambda p: "-".join(
    str(d).split(".")[1] for d in p))
def test_yardstick_gemm_exact_on_integers(cuda, pair):
    """Integer operands in [-4, 4] make every f32 sum exact in any order:
    #42 bit-equal to the plain version at every instance (an e4m3 output
    past its range NaN at the same places)."""
    dt, out = pair
    M = N = 512
    K = 256
    g = torch.Generator(device=cuda).manual_seed(23)
    a = torch.randint(-4, 5, (M, K), generator=g, device=cuda).to(dt)
    b = torch.randint(-4, 5, (K, N), generator=g, device=cuda).to(dt)
    want = ys.hand_matmul_plain(a, b, out)
    for blk in sorted(ys.KERNEL_BLOCKS):
        _bit_equal(ys.hand_matmul(M, N, K, *blk, dtype=dt,
                                  out_dtype=out)(a, b), want)


def _w4a16_card(dev, M, K, N, gs, seed, exact=False):
    """A (M, K) bf16, packed (K/2, N), scales (2, G2, N); ``exact``:
    integer activations in [-2, 2] and power-of-two scales, so every
    product and sum is exact in f32."""
    from tilelang_mesh_tpu_torch.quantize import quantize_int4_planar
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((K, N)).astype(np.float32)
    packed, scales = quantize_int4_planar(w, gs)
    if exact:
        a = rng.integers(-2, 3, (M, K)).astype(np.float32)
        scales = np.exp2(rng.integers(-6, 0, scales.shape)).astype(
            np.float32)
    else:
        a = rng.standard_normal((M, K)).astype(np.float32)
    K2 = K // 2
    return (torch.from_numpy(a).to(dev).to(torch.bfloat16),
            torch.from_numpy(packed).to(dev),
            torch.from_numpy(scales).to(dev).reshape(2, K2 // gs, N))


@pytest.mark.parametrize("gs", [128, 512])
@pytest.mark.parametrize("tile", sorted(ys.W4A16_TILES),
                         ids=lambda t: "x".join(map(str, t)))
def test_yardstick_w4a16_matches_plain(cuda, gs, tile):
    """#43 on A's two halves as views of A's rows (row stride K): one
    launch a call, 1e-2 normwise of the plain version; on exact inputs
    bit-equal."""
    M, K, N = 512, 2048, 512
    for exact in (False, True):
        a, packed, s3 = _w4a16_card(cuda, M, K, N, gs, 24, exact)
        planar = a.reshape(M, 2, K // 2)
        alo, ahi = planar[:, 0, :], planar[:, 1, :]
        fn = ys.hand_w4a16(M, N, K, gs, *tile)
        before = ys.launches["yardstick_w4a16"]
        got = fn(alo, ahi, packed, s3)
        torch.cuda.synchronize()
        assert ys.launches["yardstick_w4a16"] == before + 1
        want = ys.hand_w4a16_plain(alo, ahi, packed, s3, gs)
        if exact:
            _bit_equal(got, want)
        else:
            assert _normwise(got, want) <= 1e-2


def test_yardsticks_refuse_and_raise(cuda, monkeypatch):
    """Blocks and shapes the kernels do not take raise ValueError; a
    build failure is the build's error and a refused launch a
    KernelLaunchError, neither counting a launch (no fallback)."""
    with pytest.raises(ValueError, match="instances"):
        ys.hand_matmul(512, 512, 512, 64, 64, 32)
    with pytest.raises(ValueError, match="multiple"):
        ys.hand_matmul(500, 512, 512, 128, 128, 32)
    with pytest.raises(ValueError, match="instances"):
        ys.hand_w4a16(512, 512, 1024, 128, 512, 512)
    with pytest.raises(ValueError, match="K step"):
        ys.hand_w4a16(512, 512, 1024, 32, 128, 128)
    x = torch.zeros((256, 256), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="want"):
        ys.hand_matmul(256, 256, 128, 128, 128, 32)(x, x)
    a, packed, s3 = _w4a16_card(cuda, 128, 256, 128, 64, 25)
    calls = [("yardstick_gemm",
              lambda: ys.hand_matmul(256, 256, 256, 128, 128, 32)(x, x)),
             ("yardstick_w4a16",
              lambda: ys.hand_w4a16(128, 128, 256, 64, 128, 128)(
                  a[:, :128], a[:, 128:], packed, s3))]
    before = dict(ys.launches)

    def no_build(name):
        raise RuntimeError(f"nvcc failed building {name}")

    monkeypatch.setattr(_build, "load", no_build)
    for _, call in calls:
        with pytest.raises(RuntimeError, match="nvcc failed"):
            call()
    monkeypatch.setattr(_build, "load", lambda name: _RefusingLib())
    for name, call in calls:
        with pytest.raises(KernelLaunchError, match=name):
            call()
    assert ys.launches == before


def test_bench_raises_when_a_yardstick_fails(cuda, monkeypatch):
    """The headline configs on the card: a yardstick that does not build,
    whose launch is refused, or whose result disagrees fails its config;
    no other block and no torch composition takes its place."""
    from tilelang_mesh_tpu_torch import bench as tb
    load = _build.load
    builds = {"gemm": lambda: tb.cfg_gemm(512, 512, 512, target_s=0.02),
              "fp8_gemm": lambda: tb.cfg_fp8_gemm(512, 512, 512,
                                                  target_s=0.02),
              "w4a16_gemm": lambda: tb.cfg_w4a16(512, 512, 512, gs=128,
                                                 target_s=0.02)}

    def no_build(name):
        if name.startswith("yardstick"):
            raise RuntimeError(f"nvcc failed building {name}")
        return load(name)

    def refusing(name):
        return _RefusingLib() if name.startswith("yardstick") \
            else load(name)

    for patch, err, match in ((no_build, RuntimeError, "nvcc failed"),
                              (refusing, KernelLaunchError, "yardstick")):
        monkeypatch.setattr(_build, "load", patch)
        for build in builds.values():
            with pytest.raises(err, match=match):
                build()
    monkeypatch.setattr(_build, "load", load)
    gemm_launch, w4a16_launch = ys._gemm_launch, ys._w4a16_launch
    monkeypatch.setattr(ys, "_gemm_launch",
                        lambda *a: gemm_launch(*a) + 1.0)
    monkeypatch.setattr(ys, "_w4a16_launch",
                        lambda *a: w4a16_launch(*a) + 1.0)
    for build in builds.values():
        with pytest.raises(tb.BenchError, match="numeric mismatch"):
            build()


def test_do_bench_events_replays_a_graph(cuda):
    """The events backend captures ``rep`` launches once (after one
    warm-up launch) and replays them: per-call samples, one a round, a
    launch counted where it is captured and no more."""
    from tilelang_mesh_tpu_torch import profiler
    a = _operand(cuda, (1024, 1024), torch.bfloat16, 26)
    fn = ys.hand_matmul(1024, 1024, 1024, 128, 128, 64)
    before = ys.launches["yardstick_gemm"]
    st = profiler.do_bench_stats(fn, a, a, warmup=2, rep=8, rounds=4)
    assert ys.launches["yardstick_gemm"] == before + 1 + 8
    assert st["samples"] == 4 and st["reps"] == 8
    assert 0 < st["min_ms"] <= st["p50_ms"] <= st["max_ms"] < 100
    assert 0 < profiler.do_bench(fn, a, a, rep=8) < 100
