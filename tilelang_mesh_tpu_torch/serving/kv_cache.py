"""Paged KV-cache allocator: a slab freelist over H-major page pools.

The pools are persistent ``(H, n_pages * page_size, D)`` torch tensors
on the serving device — on the card, the kernel
(``ops/flash_decoding.py``) reads them in place at table-driven row
offsets, and ``write_token``/``write_span``/``fill_page`` write into them
in place. No step copies a pool between host and device; what crosses
is one token's or one chunk's K/V on the way in, and page copies on the
way out (``snapshot()`` and the prefix cache's publication), which say
so.

Accounting contract (as the JAX package's):

- every ``alloc`` names an owner (request id); ``free`` checks the
  pages back in against that owner — freeing a page twice or freeing
  someone else's page raises instead of corrupting the freelist;
- ``leak_check()`` lists owners still holding pages — after every
  request has retired, it must be empty and ``in_use == 0``;
- ``serve.kv`` is the fault site on the alloc path;
- allocs/frees land in ``serve.kv.alloc_pages`` / ``serve.kv.free_pages``
  counters.

Snapshot contract: ``snapshot()`` captures the live pages + owner map
with a sha256 over the page bytes, ``restore()`` repacks them into a
target allocator, re-verifies the checksum on the bytes it actually
wrote, and returns the old-page -> new-page mapping. A snapshot restores
exactly once. Host copies of pages are numpy arrays: float32 pools give
float32 arrays, bfloat16 pools give ``uint16`` arrays of the same bit
patterns, so the bytes hashed are the JAX package's bytes and a
``KVSnapshot`` moves between the two packages (a JAX-side bfloat16
restore views the ``uint16`` arrays as ``ml_dtypes.bfloat16``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..observability import tracer as _trace
from ..resilience import faults as _faults
from ..resilience.errors import TLError

__all__ = ["KVCacheExhausted", "KVSnapshot", "PagedKVAllocator",
           "allocator_from_reference", "TORCH_DTYPES"]

# pool dtype names (the spelling prefix-cache geometry keys carry)
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class KVCacheExhausted(TLError):
    """No free slabs left. Transient at admission time (the request is
    shed, capacity frees as in-flight work retires)."""
    kind = "transient"


def _page_digest(h, page: int, k: np.ndarray, v: np.ndarray) -> int:
    """Feed one page's identity + bytes into a running sha256."""
    h.update(str(page).encode())
    k = np.ascontiguousarray(k)
    v = np.ascontiguousarray(v)
    h.update(k.tobytes())
    h.update(v.tobytes())
    return k.nbytes + v.nbytes


@dataclasses.dataclass
class KVSnapshot:
    """Checksummed capture of every LIVE slab of one allocator.
    ``owners`` preserves each request's page ORDER (page sequence is
    token order); ``pages`` maps page id -> host ``(k, v)`` copies of
    shape ``(H, page_size, D)``. ``dtype`` is the pool dtype's name."""

    page_size: int
    heads: int
    head_dim: int
    dtype: str
    owners: Dict[int, List[int]]
    pages: Dict[int, Tuple[np.ndarray, np.ndarray]]
    checksum: str
    nbytes: int
    consumed: bool = False

    @property
    def n_pages(self) -> int:
        return len(self.pages)

    def verify(self) -> None:
        """Recompute the checksum over the held bytes; raises on a
        corrupted snapshot."""
        h = hashlib.sha256()
        n = 0
        for page in sorted(self.pages):
            k, v = self.pages[page]
            n += _page_digest(h, page, k, v)
        if h.hexdigest() != self.checksum or n != self.nbytes:
            raise ValueError(
                f"KV snapshot corrupted: checksum mismatch over "
                f"{len(self.pages)} page(s) ({n} bytes)")


class PagedKVAllocator:
    """Slab freelist over two H-major page pools (K and V) that live on
    ``device`` (default: the card)."""

    def __init__(self, n_pages: int, page_size: int, heads: int,
                 head_dim: int, dtype: str = "float32", device=None):
        if n_pages <= 0 or page_size <= 0:
            raise ValueError("n_pages and page_size must be positive")
        dtype = str(dtype)
        if dtype not in TORCH_DTYPES:
            raise ValueError(f"pool dtype must be one of "
                             f"{sorted(TORCH_DTYPES)}, got {dtype!r}")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.heads = int(heads)
        self.head_dim = int(head_dim)
        self.dtype = dtype
        self.torch_dtype = TORCH_DTYPES[dtype]
        self.device = resolve_device(device)
        rows = self.n_pages * self.page_size
        shape = (self.heads, rows, self.head_dim)
        self.kp = torch.zeros(shape, dtype=self.torch_dtype,
                              device=self.device)
        self.vp = torch.zeros(shape, dtype=self.torch_dtype,
                              device=self.device)
        self._lock = threading.Lock()
        self._free: List[int] = list(range(self.n_pages - 1, -1, -1))
        self._owned: Dict[int, List[int]] = {}    # owner -> page ids
        self.alloc_count = 0
        self.free_count = 0

    # -- capacity ------------------------------------------------------
    @property
    def free_pages(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def in_use(self) -> int:
        with self._lock:
            return self.n_pages - len(self._free)

    # -- alloc / free --------------------------------------------------
    def alloc(self, n: int, owner: int) -> List[int]:
        """Check out ``n`` pages for ``owner`` (a request id). Raises
        :class:`KVCacheExhausted` when fewer than ``n`` are free —
        atomically, so a partially satisfied alloc can never leak."""
        _faults.maybe_fail("serve.kv", owner=owner, pages=n)
        with self._lock:
            if len(self._free) < n:
                raise KVCacheExhausted(
                    f"KV cache exhausted: {n} page(s) requested, "
                    f"{len(self._free)}/{self.n_pages} free",
                    site="serve.kv")
            pages = [self._free.pop() for _ in range(n)]
            self._owned.setdefault(owner, []).extend(pages)
            self.alloc_count += n
        _trace.inc("serve.kv.alloc_pages", n)
        return pages

    def free(self, owner: int,
             pages: Optional[List[int]] = None) -> int:
        """Return ``pages`` (default: everything ``owner`` holds) to the
        freelist. Freeing a page the owner does not hold raises."""
        with self._lock:
            held = self._owned.get(owner, [])
            if pages is None:
                pages = list(held)
            for p in pages:
                if p not in held:
                    raise ValueError(
                        f"request {owner} does not hold page {p} "
                        f"(double free or foreign free)")
            for p in pages:
                held.remove(p)
                self._free.append(p)
            if not held:
                self._owned.pop(owner, None)
            self.free_count += len(pages)
        if pages:
            _trace.inc("serve.kv.free_pages", len(pages))
        return len(pages)

    # -- page filling --------------------------------------------------
    def row0(self, page: int) -> int:
        """First pool row of ``page`` (token t of the page is row0+t)."""
        if not 0 <= page < self.n_pages:
            raise IndexError(f"page {page} out of range")
        return page * self.page_size

    def _to_pool(self, x) -> torch.Tensor:
        """Host or device data -> a tensor of the pool's dtype on its
        device. Two-byte non-float16 numpy arrays (``uint16`` host
        copies, ``ml_dtypes.bfloat16``) into a bfloat16 pool carry bit
        patterns and are reinterpreted, never converted."""
        if isinstance(x, np.ndarray):
            if self.torch_dtype == torch.bfloat16 and x.dtype.itemsize == 2 \
                    and x.dtype != np.float16:
                x = torch.from_numpy(
                    np.ascontiguousarray(x).view(np.int16)).view(
                        torch.bfloat16)
            else:
                x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(device=self.device, dtype=self.torch_dtype)

    def write_token(self, page: int, offset: int, k, v) -> None:
        """Write one token's per-head K/V vectors ``(H, D)`` into
        ``page`` at token ``offset`` — the in-place append a decode
        step performs."""
        if not 0 <= offset < self.page_size:
            raise IndexError(f"token offset {offset} out of page "
                             f"(size {self.page_size})")
        row = self.row0(page) + offset
        self.kp[:, row, :] = self._to_pool(k)
        self.vp[:, row, :] = self._to_pool(v)

    def write_span(self, page: int, offset: int, k, v) -> None:
        """Write ``n`` consecutive tokens' ``(H, n, D)`` K/V blocks into
        ``page`` starting at token ``offset`` — the bulk write one
        prefill chunk performs."""
        n = int(k.shape[1])
        if not (0 <= offset and offset + n <= self.page_size):
            raise IndexError(
                f"token span [{offset}, {offset + n}) out of page "
                f"(size {self.page_size})")
        row = self.row0(page) + offset
        self.kp[:, row:row + n, :] = self._to_pool(k)
        self.vp[:, row:row + n, :] = self._to_pool(v)

    def fill_page(self, page: int, k, v) -> None:
        """Bulk-fill one page from ``(H, page_size, D)`` arrays."""
        r0 = self.row0(page)
        self.kp[:, r0:r0 + self.page_size, :] = self._to_pool(k)
        self.vp[:, r0:r0 + self.page_size, :] = self._to_pool(v)

    def host_pages(self, pages: List[int]
                   ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Copies of ``pages`` on the host, ``(k, v)`` each
        ``(H, page_size, D)`` — one device-to-host copy for the lot.
        bfloat16 pages come back as ``uint16`` bit patterns."""
        if not pages:
            return []
        ps = self.page_size
        idx = torch.tensor(pages, device=self.device)
        rows = (idx[:, None] * ps
                + torch.arange(ps, device=self.device)).reshape(-1)
        k = self.kp[:, rows].reshape(self.heads, len(pages), ps,
                                     self.head_dim).transpose(0, 1)
        v = self.vp[:, rows].reshape(self.heads, len(pages), ps,
                                     self.head_dim).transpose(0, 1)
        if self.torch_dtype == torch.bfloat16:
            k, v = k.view(torch.int16), v.view(torch.int16)
        k = k.contiguous().cpu().numpy()
        v = v.contiguous().cpu().numpy()
        if self.torch_dtype == torch.bfloat16:
            k, v = k.view(np.uint16), v.view(np.uint16)
        return [(k[i], v[i]) for i in range(len(pages))]

    # -- snapshot / restore --------------------------------------------
    def snapshot(self) -> KVSnapshot:
        """Checksummed host copy of every live slab + the owner map (a
        device-to-host copy of every live page). Free pages are not
        captured (their contents are garbage by contract)."""
        with self._lock:
            owners = {o: list(p) for o, p in self._owned.items() if p}
        ids = sorted(p for held in owners.values() for p in held)
        h = hashlib.sha256()
        nbytes = 0
        pages: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        for page, (k, v) in zip(ids, self.host_pages(ids)):
            nbytes += _page_digest(h, page, k, v)
            pages[page] = (k, v)
        return KVSnapshot(page_size=self.page_size, heads=self.heads,
                          head_dim=self.head_dim, dtype=self.dtype,
                          owners=owners, pages=pages,
                          checksum=h.hexdigest(), nbytes=nbytes)

    def restore(self, snap: KVSnapshot) -> Dict[int, int]:
        """Repack a snapshot's live slabs into THIS allocator: allocate
        fresh pages per owner (order preserved), write the bytes back,
        re-verify the checksum on what was actually written (read back
        from the device), and return the old-page -> new-page mapping.
        A snapshot restores exactly once. Takes the port's snapshots
        and the JAX package's alike."""
        if snap.consumed:
            raise ValueError(
                "KV snapshot already restored; restoring it twice would "
                "hand the same slabs to two allocators")
        if (snap.page_size, snap.heads, snap.head_dim) != \
                (self.page_size, self.heads, self.head_dim) or \
                str(snap.dtype) != self.dtype:
            raise ValueError(
                f"KV snapshot geometry (ps={snap.page_size}, "
                f"H={snap.heads}, D={snap.head_dim}, {snap.dtype}) does "
                f"not match this allocator (ps={self.page_size}, "
                f"H={self.heads}, D={self.head_dim}, {self.dtype})")
        snap.verify()
        need = snap.n_pages
        if self.free_pages < need:
            raise KVCacheExhausted(
                f"cannot restore KV snapshot: {need} live page(s), "
                f"{self.free_pages}/{self.n_pages} free in the target",
                site="serve.kv")
        mapping: Dict[int, int] = {}
        restored: List[Tuple[int, int]] = []   # (owner, new page) undo log
        try:
            for owner in sorted(snap.owners):
                for old in snap.owners[owner]:
                    new = self.alloc(1, owner)[0]
                    restored.append((owner, new))
                    k, v = snap.pages[old]
                    self.fill_page(new, k, v)
                    mapping[old] = new
            # byte conservation, asserted on the WRITTEN bytes: read the
            # target pages back and re-derive the digest under the OLD
            # page ids
            olds = sorted(mapping)
            h = hashlib.sha256()
            nbytes = 0
            written = self.host_pages([mapping[o] for o in olds])
            for old, (k, v) in zip(olds, written):
                nbytes += _page_digest(h, old, k, v)
            if h.hexdigest() != snap.checksum or nbytes != snap.nbytes:
                raise ValueError(
                    f"KV migration corrupted {need} page(s) in flight: "
                    f"restored bytes do not match the snapshot checksum")
        except Exception:
            # a mid-restore failure (injected serve.kv fault, a
            # corrupted write) must not leak half the migration
            for owner, new in restored:
                self.free(owner, [new])
            raise
        snap.consumed = True
        _trace.inc("serve.kv.migrated_pages", need)
        _trace.inc("serve.kv.migrated_bytes", nbytes)
        return mapping

    # -- accounting ----------------------------------------------------
    def holdings(self, owner: int) -> List[int]:
        with self._lock:
            return list(self._owned.get(owner, []))

    def leak_check(self) -> Dict[int, List[int]]:
        """owner -> still-held pages. Empty after every request retired,
        or the retirement path leaked slabs."""
        with self._lock:
            return {o: list(p) for o, p in self._owned.items() if p}

    def stats(self) -> dict:
        with self._lock:
            return {
                "n_pages": self.n_pages,
                "page_size": self.page_size,
                "free": len(self._free),
                "in_use": self.n_pages - len(self._free),
                "alloc_count": self.alloc_count,
                "free_count": self.free_count,
                "owners": len(self._owned),
            }


def allocator_from_reference(kp: np.ndarray, vp: np.ndarray,
                             page_size: int,
                             owners: Dict[int, List[int]],
                             device=None) -> PagedKVAllocator:
    """The port's allocator holding the same state as a JAX allocator:
    its numpy pools ``kp``/``vp`` ``(H, rows, D)`` (copied to ``device``
    once) and its owner map (``leak_check()``), page ids unchanged.
    bfloat16 pools may come as ``ml_dtypes.bfloat16`` or ``uint16``."""
    H, rows, D = kp.shape
    if rows % int(page_size):
        raise ValueError(f"pool rows {rows} not a multiple of "
                         f"page_size {page_size}")
    dtype = "float32" if kp.dtype == np.float32 else "bfloat16"
    if dtype == "bfloat16" and kp.dtype.itemsize != 2:
        raise TypeError(f"unsupported pool dtype {kp.dtype}")
    al = PagedKVAllocator(rows // int(page_size), page_size, H, D,
                          dtype=dtype, device=device)
    al.kp.copy_(al._to_pool(kp))
    al.vp.copy_(al._to_pool(vp))
    held = {p for pages in owners.values() for p in pages}
    if len(held) != sum(len(p) for p in owners.values()) or \
            any(not 0 <= p < al.n_pages for p in held):
        raise ValueError("owner map holds a page twice or out of range")
    with al._lock:
        al._free = [p for p in al._free if p not in held]
        al._owned = {int(o): [int(p) for p in pages]
                     for o, pages in owners.items() if pages}
    return al
