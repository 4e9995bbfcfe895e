"""The port's MLA serving path (serving.MLADecodeWorkload on the MLA
kernel) against the JAX package's, end to end on the same request
stream.

Both engines get the same geometry (2 query heads over a latent-major
pool of dc = 32 latent and dr = 16 rope columns, page size 8), the same
buckets, their own explicit prefix cache, and the same submissions in
the same order. Held equal: every outcome, per-request page counts,
allocator books and zero leaks, prefix hits and prefix-cache keys
(byte-equal), per-step decode outputs (within 2e-2, the tolerance of
tests/test_serving.py:528) and the greedy tokens. The stand-in
vocabulary is the output's 64 values (H * dc), so no logit repeats; the
stream's seeds are ones for which the reference's top-2 logit gap
exceeds 4e-2 at every step, so a token mismatch is a fault and not a
tie; the test asserts that first.

The JAX engine runs its kernel in Pallas interpret mode on the CPU; the
port's runs the plain version of its CUDA kernel on CPU tensors.
"""

import numpy as np
import pytest

from tilelang_mesh_tpu import serving as ref
from tilelang_mesh_tpu_torch import serving as port

HEADS, DC, DR, PS = 2, 32, 16, 8
TOL = 2e-2
GAP = 4e-2

# (context_tokens, new_tokens, seed): wave 2's first request repeats
# wave 1's first prompt, its second extends a 16-token prompt of wave 1
# (two prefix-cache hits)
WAVE1 = [(32, 4, 1), (24, 3, 4), (16, 4, 14), (40, 3, 3)]
WAVE2 = [(32, 3, 1), (20, 4, 14)]


@pytest.fixture(autouse=True)
def _fresh_port_state():
    """The port's process-global breaker and fault overrides start clean
    (the conftest resets the JAX package's)."""
    from tilelang_mesh_tpu_torch.resilience import faults
    from tilelang_mesh_tpu_torch.resilience.retry import global_breaker
    global_breaker().reset()
    faults._overrides.clear()
    yield


def _drive(mod, tmp_path, **alloc_kw):
    alloc = mod.PagedKVAllocator(n_pages=96, page_size=PS, heads=1,
                                 head_dim=DC + DR, **alloc_kw)
    cache = mod.PrefixKVCache(root=tmp_path / mod.__name__)
    wl = mod.MLADecodeWorkload(alloc, heads=HEADS, latent_dim=DC,
                               rope_dim=DR, prefix_cache=cache)
    eng = mod.ServingEngine(wl, name="mla")
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


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    # 16-token prefill chunks (the longer prompts prefill over several
    # engine steps in both packages) and a vocabulary of H * dc logits
    mp.setenv("TL_TPU_SERVE_PREFILL_CHUNK", "16")
    mp.setenv("TL_TPU_SERVE_VOCAB", str(HEADS * DC))
    try:
        tmp = tmp_path_factory.mktemp("mla")
        yield (_drive(ref, tmp), _drive(port, tmp, device="cpu"))
    finally:
        mp.undo()


def test_engines_agree_end_to_end(both):
    (rr, rsteps, rpages, rwl), (pr, psteps, ppages, pwl) = both
    assert rwl.vocab == pwl.vocab == HEADS * DC
    # the stream has no near-ties: greedy tokens are well defined
    for _, out in rsteps:
        logits = np.sort(out.reshape(out.shape[0], -1), axis=1)
        assert (logits[:, -1] - logits[:, -2] > GAP).all()

    assert [r.outcome for r in rr] == ["result"] * len(rr)
    assert [r.outcome for r in pr] == [r.outcome for r in rr]
    assert ppages == rpages
    assert [r.generated for r in pr] == [r.generated for r in rr]
    assert [r.prefix_tokens for r in pr] == [r.prefix_tokens for r in rr]
    assert len(psteps) == len(rsteps)
    for (ps_, pout), (rs_, rout) in zip(psteps, rsteps):
        assert ps_ == rs_
        assert pout.shape == rout.shape and pout.shape[1:] == (HEADS, DC)
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
    geo = pwl.prefix_geometry()
    assert geo == rwl.prefix_geometry()
    assert geo.startswith(f"MLADecodeWorkload:v1:h1:d{DC + DR}:")
    assert list(pwl.prefix_cache._mem) == list(rwl.prefix_cache._mem)
    for (_, p_ent), (_, r_ent) in zip(pwl.prefix_cache._mem.items(),
                                      rwl.prefix_cache._mem.items()):
        assert p_ent.checksum == r_ent.checksum
    toks = rr[0].prompt_tokens
    assert port.PrefixKVCache.prefix_keys(geo, toks, PS) == \
        ref.PrefixKVCache.prefix_keys(rwl.prefix_geometry(), toks, PS)


def test_workload_dispatches_and_kernel_inputs():
    """A step's output is (H, dc); the workload counts its dispatches;
    the plain version, recomputed on the gathered rows, gives the same
    output (the strided column views change nothing)."""
    import torch

    from tilelang_mesh_tpu_torch.ops.mla import mla_decode_reference
    alloc = port.PagedKVAllocator(n_pages=16, page_size=PS, heads=1,
                                  head_dim=DC + DR, device="cpu")
    wl = port.MLADecodeWorkload(alloc, heads=HEADS, latent_dim=DC,
                                rope_dim=DR, batch_buckets=(1,),
                                page_buckets=(2,), prefix_cache=False)
    eng = port.ServingEngine(wl, name="mla")
    # one dispatch per bucket, and one timed warm step
    assert eng.warmup() == 1 and wl.dispatches == 2
    r = eng.submit(context_tokens=16, new_tokens=1, seed=9)
    rows = alloc.kp[0].clone()
    pages = list(r.pages)
    eng.run()
    assert r.outcome == "result" and wl.dispatches == 3
    assert np.asarray(r.result).shape == (HEADS, DC)
    assert alloc.in_use == 0
    idx = (torch.tensor(pages[:2])[:, None] * PS
           + torch.arange(PS)).reshape(-1)
    seq = rows[idx][None]
    q = torch.from_numpy(np.random.default_rng((9, 1, 0)).standard_normal(
        (1, HEADS, DC + DR)).astype(np.float32))
    want = mla_decode_reference(q[..., :DC], q[..., DC:], seq[..., :DC],
                                seq[..., DC:], sm_scale=wl.sm_scale)
    np.testing.assert_allclose(np.asarray(r.result), want[0].numpy(),
                               rtol=1e-5, atol=1e-5)


def test_mla_requires_latent_major_allocator():
    """tests/test_serving.py:532-535."""
    alloc = port.PagedKVAllocator(n_pages=8, page_size=PS, heads=2,
                                  head_dim=64, device="cpu")
    with pytest.raises(ValueError):
        port.MLADecodeWorkload(alloc, heads=2, latent_dim=32, rope_dim=16)
