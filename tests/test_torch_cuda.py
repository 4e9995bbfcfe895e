"""The port's CUDA kernels on the card (marker ``cuda``).

Each kernel is held against its plain PyTorch version on the same CUDA
inputs, and the serving engine and the flagship model on the card
against the same code on CPU tensors (the plain versions). These tests
need an NVIDIA card and skip without one; they import neither JAX nor
the JAX package, so they run where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: paged decode rtol = atol = 1e-4 — the kernel and the plain
version do the same float32 arithmetic (bfloat16 pools are widened to
float32 in both) in another order. Attention kernels, normwise
(max |kernel - plain| over max |plain|): 1e-5 in float32 (same
arithmetic, another order); 2e-2 in bfloat16, where both round P and dS
to bf16 before their products but a 1e-7 difference at a rounding
boundary flips one bf16 ulp. The model on the card against the model on
the CPU: 1e-4 normwise (float32, different kernels and libraries).
"""

import dataclasses
import importlib
import math

import numpy as np
import pytest
import torch

from tilelang_mesh_tpu_torch.ops import flash_decoding as fd
from tilelang_mesh_tpu_torch.ops import gqa_bwd as gb
from tilelang_mesh_tpu_torch.resilience.errors import KernelLaunchError
from tilelang_mesh_tpu_torch.resilience import faults
from tilelang_mesh_tpu_torch.resilience.retry import global_breaker

fa = importlib.import_module("tilelang_mesh_tpu_torch.ops.flash_attention")

pytestmark = pytest.mark.cuda

TOL = 1e-4
ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("shape", ATTN_CASES)
def test_forward_kernels_match_plain(cuda, dtype, causal, d, shape):
    B, H, _, Sq, Sk = shape
    q, k, v, _, _, _, sm = _attn_inputs(cuda, B, H, H, Sq, Sk, d, dtype,
                                        causal)
    before = dict(fa.launches)
    o = fa.mha_fwd(q, k, v, causal, sm)
    part = fa.mha_fwd_partial(q, k, v, causal, sm)
    torch.cuda.synchronize()
    assert fa.launches["mha_fwd"] == before["mha_fwd"] + 1
    assert fa.launches["mha_fwd_partial"] == before["mha_fwd_partial"] + 1
    assert o.dtype == dtype and all(t.dtype == torch.float32 for t in part)
    assert _normwise(o, fa.mha_fwd_plain(q, k, v, causal, sm)) \
        <= ATTN_TOL[dtype]
    assert _normwise(part, fa.mha_fwd_partial_plain(q, k, v, causal, sm)) \
        <= ATTN_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("shape", ATTN_CASES + [(2, 4, 2, 150, 150),
                                                (1, 4, 2, 64, 200)])
def test_backward_kernels_match_plain(cuda, dtype, causal, d, shape):
    """dK/dV and dQ, MHA and group 2 (4 query heads over 2 KV heads)."""
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


def test_refused_launch_raises(cuda):
    """A grid the card refuses (65536 batches > gridDim.z) comes back as
    a KernelLaunchError, never as a silent no-op."""
    q = torch.zeros((65536, 1, 1, 16), device=cuda)
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
