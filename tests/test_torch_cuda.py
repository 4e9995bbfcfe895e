"""The port's CUDA kernels on the card (marker ``cuda``).

Each kernel is held against its plain PyTorch version on the same CUDA
inputs, and the serving engine on the card against the same engine on
CPU tensors (the plain version). These tests need an NVIDIA card and
skip without one; they import neither JAX nor the JAX package, so they
run where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerance: rtol = atol = 1e-4 — the kernel and the plain version do the
same float32 arithmetic (bfloat16 pools are widened to float32 in both)
in another order.
"""

import numpy as np
import pytest
import torch

from tilelang_mesh_tpu_torch.ops import flash_decoding as fd
from tilelang_mesh_tpu_torch.resilience import faults
from tilelang_mesh_tpu_torch.resilience.retry import global_breaker

pytestmark = pytest.mark.cuda

TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "mode")
    global_breaker().reset()
    faults._overrides.clear()
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
