"""The port's serving engine (tilelang_mesh_tpu_torch/serving/) against the
JAX package's (serving/), end to end on the same request stream.

Both engines get the same geometry (H=2, D=64, PS=8 as in
tests/test_serving.py:42), the same buckets, their own explicit prefix
cache, and the same submissions in the same order. Held equal: every
outcome, per-request page counts, allocator books and zero leaks,
prefix hits and prefix-cache keys (byte-equal), per-step decode outputs
(within 2e-2, the decode tolerance of tests/test_decoding.py:25) and
the greedy tokens. The stream's seeds are ones for which the
reference's top-2 logit gap exceeds 4e-2 at every step, so a token
mismatch is a fault and not a tie; the test asserts that first.

The JAX engine runs its kernel in Pallas interpret mode on the CPU; the
port's runs the plain version of its CUDA kernel on CPU tensors.
"""

import time

import numpy as np
import pytest

from tilelang_mesh_tpu import serving as ref
from tilelang_mesh_tpu_torch import serving as port
from tilelang_mesh_tpu_torch.resilience import KernelLaunchError, inject
from tilelang_mesh_tpu_torch.resilience.retry import global_breaker

H, D, PS = 2, 64, 8
TOL = 2e-2
GAP = 4e-2

# (context_tokens, new_tokens, seed) — wave 1, then wave 2 whose first
# request repeats wave 1's first prompt and whose second extends the
# 16-token prompt of the same seed (two prefix-cache hits)
WAVE1 = [(32, 4, 13), (24, 3, 20), (16, 4, 12), (40, 3, 14)]
WAVE2 = [(32, 3, 13), (20, 4, 12)]


@pytest.fixture(autouse=True)
def _fresh_port_state():
    """The port's process-global breaker and fault overrides start clean
    in every test (the conftest resets the JAX package's)."""
    from tilelang_mesh_tpu_torch.resilience import faults
    global_breaker().reset()
    faults._overrides.clear()
    yield


def _drive(mod, tmp_path, **alloc_kw):
    """Serve WAVE1 then WAVE2 through one package's engine; returns the
    requests, the per-step batch outputs, page counts at admission and
    the workload."""
    alloc = mod.PagedKVAllocator(n_pages=96, page_size=PS, heads=H,
                                 head_dim=D, **alloc_kw)
    cache = mod.PrefixKVCache(root=tmp_path / mod.__name__)
    wl = mod.FlashDecodeWorkload(alloc, batch_buckets=(1, 2, 4),
                                 page_buckets=(2, 4), prefix_cache=cache)
    eng = mod.ServingEngine(wl)
    eng.warmup()
    steps = []
    run_batch = wl.run_batch

    def recording(batch):
        outs = run_batch(batch)
        steps.append(([r.seed for r in batch], np.stack(outs)))
        return outs

    wl.run_batch = recording
    reqs, pages = [], []
    for wave in (WAVE1, WAVE2):
        for ctx, new, seed in wave:
            r = eng.submit(context_tokens=ctx, new_tokens=new, seed=seed)
            reqs.append(r)
            pages.append(len(r.pages))
        eng.run()
    return reqs, steps, pages, wl


@pytest.fixture
def both(tmp_path, monkeypatch):
    # 16-token prefill chunks: the 24..40-token prompts prefill over
    # several engine steps in both packages (the knob has one name)
    monkeypatch.setenv("TL_TPU_SERVE_PREFILL_CHUNK", "16")
    return (_drive(ref, tmp_path), _drive(port, tmp_path, device="cpu"))


def test_engines_agree_end_to_end(both):
    (rr, rsteps, rpages, rwl), (pr, psteps, ppages, pwl) = both
    # the stream has no near-ties: greedy tokens are well defined
    for _, out in rsteps:
        logits = np.sort(out.reshape(out.shape[0], -1)[:, :rwl.vocab],
                         axis=1)
        assert (logits[:, -1] - logits[:, -2] > GAP).all()

    assert [r.outcome for r in rr] == ["result"] * len(rr)
    assert [r.outcome for r in pr] == [r.outcome for r in rr]
    assert ppages == rpages
    assert [r.generated for r in pr] == [r.generated for r in rr]
    assert [r.prefix_tokens for r in pr] == [r.prefix_tokens for r in rr]
    assert len(psteps) == len(rsteps)
    for (ps_, pout), (rs_, rout) in zip(psteps, rsteps):
        assert ps_ == rs_
        np.testing.assert_allclose(pout, rout, rtol=TOL, atol=TOL)
    for r, p in zip(rr, pr):
        np.testing.assert_allclose(np.asarray(p.result),
                                   np.asarray(r.result), rtol=TOL,
                                   atol=TOL)
        assert p.trace.complete and r.trace.complete


def test_books_and_prefix_cache_agree(both):
    (rr, _, _, rwl), (pr, _, _, pwl) = both
    ra, pa = rwl.allocator, pwl.allocator
    assert pa.in_use == ra.in_use == 0
    assert pa.leak_check() == ra.leak_check() == {}
    assert (pa.alloc_count, pa.free_count) == (ra.alloc_count,
                                               ra.free_count)
    rs, ps_ = rwl.prefix_cache.stats(), pwl.prefix_cache.stats()
    assert ps_ == rs and ps_["hits"] >= 1
    assert pwl.prefix_geometry() == rwl.prefix_geometry()
    assert list(pwl.prefix_cache._mem) == list(rwl.prefix_cache._mem)
    for (_, p_ent), (_, r_ent) in zip(pwl.prefix_cache._mem.items(),
                                      rwl.prefix_cache._mem.items()):
        assert p_ent.checksum == r_ent.checksum
    toks = rr[0].prompt_tokens
    assert port.PrefixKVCache.prefix_keys(pwl.prefix_geometry(), toks,
                                          PS) == \
        ref.PrefixKVCache.prefix_keys(rwl.prefix_geometry(), toks, PS)


def _engine(**kw):
    alloc = port.PagedKVAllocator(n_pages=64, page_size=PS, heads=H,
                                  head_dim=D, device="cpu")
    wl = port.FlashDecodeWorkload(alloc, batch_buckets=(4,),
                                  page_buckets=(2, 4), prefix_cache=False)
    return port.ServingEngine(wl, **kw), alloc


def _failing(eng, exc, times):
    """Make the next ``times`` decode steps raise ``exc``."""
    orig = eng.workload.run_batch
    left = [times]

    def run_batch(batch):
        if left[0] > 0:
            left[0] -= 1
            raise exc
        return orig(batch)

    eng.workload.run_batch = run_batch


def test_kernel_fault_retries_then_completes():
    """A device-side CUDA fault (classified device_loss) is retried
    within the budget; the requests then complete. No CPU re-run."""
    eng, alloc = _engine(retry_max=2)
    reqs = [eng.submit(context_tokens=16, seed=i) for i in range(3)]
    _failing(eng, KernelLaunchError("paged_decode", 700), times=1)
    eng.run()
    assert [r.outcome for r in reqs] == ["result"] * 3
    assert all(r.retries == 1 for r in reqs)
    assert alloc.in_use == 0 and eng.step_failures == 1


def test_kernel_fault_past_budget_fails_or_sheds_and_frees():
    eng, alloc = _engine(retry_max=1)
    plain = eng.submit(context_tokens=16, seed=1)
    timed = eng.submit(context_tokens=16, seed=2, deadline_ms=60_000)
    _failing(eng, KernelLaunchError("paged_decode", 719), times=10)
    eng.run()
    assert plain.outcome == "failed" and "retry budget" in plain.error
    assert timed.outcome == "shed" and timed.shed_reason == "retry_budget"
    assert alloc.in_use == 0 and alloc.leak_check() == {}


def test_refused_launch_is_deterministic_and_feeds_breaker():
    eng, alloc = _engine()
    r = eng.submit(context_tokens=16, seed=3)
    _failing(eng, KernelLaunchError("paged_decode", 9), times=1)
    eng.run()
    assert r.outcome == "failed" and r.retries == 0
    assert global_breaker()._failures["serve.step"] == 1
    assert alloc.in_use == 0


def test_injected_step_fault_and_step_watchdog():
    eng, alloc = _engine(retry_max=1)
    reqs = [eng.submit(context_tokens=16, seed=i) for i in range(2)]
    with inject("serve.step", kind="transient", times=1):
        eng.run()
    assert [r.outcome for r in reqs] == ["result", "result"]
    assert all(r.retries == 1 for r in reqs)
    # a step that always outlasts its watchdog: retried, then shed
    eng, alloc = _engine(step_timeout_ms=30.0, retry_max=1)
    slow = eng.submit(context_tokens=16, deadline_ms=60_000, seed=9)
    orig = eng.workload.run_batch

    def late(batch):
        time.sleep(0.12)
        return orig(batch)

    eng.workload.run_batch = late
    eng.run()
    assert slow.outcome == "shed" and slow.shed_reason == "retry_budget"
    assert alloc.in_use == 0


def test_stream_and_cancel():
    eng, alloc = _engine()
    toks = [ev["token"] for ev in eng.stream(context_tokens=16,
                                             new_tokens=3, seed=4)]
    assert len(toks) == 3
    it = iter(eng.stream(context_tokens=16, new_tokens=5, seed=5))
    next(it)
    it.close()
    assert eng.outcomes()["canceled"] == 1 and alloc.in_use == 0
