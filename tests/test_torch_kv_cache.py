"""The port's paged KV allocator (tilelang_mesh_tpu_torch/serving/kv_cache.py)
against the JAX package's (serving/kv_cache.py).

Accounting is held op for op (the sequences of tests/test_serving.py
:101-150), snapshots byte for byte: a ``KVSnapshot`` taken by either
package carries the same sha256 over the same content and restores into
the other. The port's pools live on CPU tensors here.
"""

import numpy as np
import pytest

from tilelang_mesh_tpu.resilience import inject as ref_inject
from tilelang_mesh_tpu.serving import kv_cache as ref
from tilelang_mesh_tpu_torch.resilience import inject as port_inject
from tilelang_mesh_tpu_torch.serving import kv_cache as port

H, D, PS = 2, 64, 8


def _pair(n_pages=8, dtype="float32"):
    return (ref.PagedKVAllocator(n_pages, PS, H, D, dtype=dtype),
            port.PagedKVAllocator(n_pages, PS, H, D, dtype=dtype,
                                  device="cpu"))


def _books(a):
    return (a.in_use, a.free_pages, a.alloc_count, a.free_count,
            a.leak_check())


def test_alloc_free_balance_matches_reference():
    for a in _pair():
        pages = a.alloc(3, owner=1)
        assert len(pages) == 3 and a.in_use == 3 and a.free_pages == 5
        assert a.holdings(1) == pages
        assert a.free(1) == 3
        assert a.in_use == 0 and a.alloc_count == a.free_count == 3
        assert a.leak_check() == {}
    r, p = _pair()
    for a in (r, p):
        a.alloc(2, owner=1)
        a.alloc(3, owner=2)
        a.free(1)
        a.alloc(1, owner=3)
    assert _books(r) == _books(p)
    assert r.holdings(2) == p.holdings(2) and r.holdings(3) == p.holdings(3)


def test_exhaustion_is_atomic_like_reference():
    for a, exc in zip(_pair(4), (ref.KVCacheExhausted,
                                 port.KVCacheExhausted)):
        a.alloc(3, owner=1)
        with pytest.raises(exc):
            a.alloc(2, owner=2)
        assert a.free_pages == 1 and a.holdings(2) == []


def test_double_and_foreign_free_rejected_like_reference():
    for a in _pair(4):
        p = a.alloc(2, owner=1)
        a.free(1, [p[0]])
        with pytest.raises(ValueError):
            a.free(1, [p[0]])          # double free
        with pytest.raises(ValueError):
            a.free(2, [p[1]])          # foreign free
        assert a.leak_check() == {1: [p[1]]}
        a.free(1)


def test_hmajor_layout_and_write_like_reference():
    k = np.full((H, D), 2.0, np.float32)
    v = np.full((H, D), 3.0, np.float32)
    r, p = _pair(4)
    for a in (r, p):
        page = a.alloc(1, owner=1)[0]
        a.write_token(page, 5, k, v)
        with pytest.raises(IndexError):
            a.write_token(page, PS, k, v)
    np.testing.assert_array_equal(p.kp.numpy(), r.kp)
    np.testing.assert_array_equal(p.vp.numpy(), r.vp)
    assert p.kp.device.type == "cpu" and tuple(p.kp.shape) == r.kp.shape


def test_kv_fault_site_like_reference():
    r, p = _pair(4)
    for a, inject in ((r, ref_inject), (p, port_inject)):
        with inject("serve.kv", kind="transient"):
            with pytest.raises(Exception):
                a.alloc(1, owner=1)
        assert a.in_use == 0


def _fill_same(r, p, seed):
    """The same content written into both allocators' live pages."""
    rng = np.random.default_rng(seed)
    for owner, n in ((7, 2), (9, 3)):
        pr, pp = r.alloc(n, owner), p.alloc(n, owner)
        assert pr == pp
        for page in pr:
            k = rng.standard_normal((H, PS, D)).astype(np.float32)
            v = rng.standard_normal((H, PS, D)).astype(np.float32)
            r.fill_page(page, k, v)
            p.fill_page(page, k, v)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_snapshot_checksum_equals_reference(dtype):
    r, p = _pair(dtype=dtype)
    _fill_same(r, p, seed=0)
    sr, sp = r.snapshot(), p.snapshot()
    assert sp.checksum == sr.checksum and sp.nbytes == sr.nbytes
    assert sp.owners == sr.owners and str(sp.dtype) == str(sr.dtype)
    for page in sr.pages:
        for a, b in zip(sp.pages[page], sr.pages[page]):
            assert a.tobytes() == np.ascontiguousarray(b).tobytes()
    sp.verify()


def test_reference_snapshot_restores_into_port():
    r, _ = _pair()
    _, p = _pair(n_pages=6)
    _fill_same(r, ref.PagedKVAllocator(8, PS, H, D), seed=1)
    snap = r.snapshot()
    mapping = p.restore(snap)
    assert snap.consumed and sorted(mapping) == sorted(snap.pages)
    for old, new in mapping.items():
        r0 = new * PS
        np.testing.assert_array_equal(p.kp[:, r0:r0 + PS].numpy(),
                                      snap.pages[old][0])
        np.testing.assert_array_equal(p.vp[:, r0:r0 + PS].numpy(),
                                      snap.pages[old][1])
    assert p.snapshot().owners == {o: [mapping[x] for x in pages]
                                   for o, pages in snap.owners.items()}


def test_port_snapshot_restores_into_reference():
    _, p = _pair()
    r = ref.PagedKVAllocator(6, PS, H, D)
    _fill_same(ref.PagedKVAllocator(8, PS, H, D), p, seed=2)
    snap = p.snapshot()
    mapping = r.restore(snap)
    assert snap.consumed
    for old, new in mapping.items():
        r0 = new * PS
        np.testing.assert_array_equal(r.kp[:, r0:r0 + PS],
                                      snap.pages[old][0])
    # and the checksum survives the round trip back
    assert r.snapshot().nbytes == snap.nbytes


def test_bf16_reference_snapshot_restores_into_port():
    """bfloat16 pages cross as bit patterns: the port's pool holds the
    reference snapshot's bytes exactly."""
    r, p = _pair(dtype="bfloat16")
    _fill_same(r, ref.PagedKVAllocator(8, PS, H, D, dtype="bfloat16"),
               seed=3)
    snap = r.snapshot()
    mapping = p.restore(snap)
    olds = sorted(snap.pages)
    for old, (k, v) in zip(olds, p.host_pages([mapping[o] for o in olds])):
        rk, rv = (np.ascontiguousarray(a) for a in snap.pages[old])
        assert k.dtype == np.uint16
        assert k.tobytes() == rk.tobytes() and v.tobytes() == rv.tobytes()


def test_restore_rejects_corrupt_and_double_restore():
    r, p = _pair()
    _fill_same(ref.PagedKVAllocator(8, PS, H, D), p, seed=4)
    snap = p.snapshot()
    target = port.PagedKVAllocator(8, PS, H, D, device="cpu")
    target.restore(snap)
    with pytest.raises(ValueError):
        target.restore(snap)                       # exactly once
    snap2 = p.snapshot()
    k, _ = snap2.pages[next(iter(snap2.pages))]
    k.flat[0] += 1.0                               # bit rot
    with pytest.raises(ValueError):
        port.PagedKVAllocator(8, PS, H, D, device="cpu").restore(snap2)


def test_allocator_from_reference():
    r, _ = _pair()
    _fill_same(r, ref.PagedKVAllocator(8, PS, H, D), seed=5)
    p = port.allocator_from_reference(r.kp, r.vp, PS, r.leak_check(),
                                      device="cpu")
    assert _books(p)[:2] == _books(r)[:2]
    assert p.leak_check() == r.leak_check()
    np.testing.assert_array_equal(p.kp.numpy(), r.kp)
    np.testing.assert_array_equal(p.vp.numpy(), r.vp)
    sr, sp = r.snapshot(), p.snapshot()
    assert sp.checksum == sr.checksum
    # the port's books keep working from there
    new = p.alloc(p.free_pages, owner=11)
    assert not set(new) & {x for v in r.leak_check().values() for x in v}
    with pytest.raises(ValueError):
        port.allocator_from_reference(r.kp, r.vp, PS, {1: [0], 2: [0]},
                                      device="cpu")


def test_missing_card_raises_unless_cpu_is_asked():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError):
        port.PagedKVAllocator(4, PS, H, D)
