"""Content-addressed prefix KV cache: prefill shared prompts once.

A fleet serving millions of users sees the same system prompt in front
of thousands of requests; recomputing its KV context per request is the
largest untapped throughput lever in the stack. This module caches the
KV pages of **whole-page token prefixes**, content-addressed on a
sha256 of (pool geometry, token ids), so a prefix hit converts
O(prompt) prefill compute into an O(pages) checksummed restore:

- **Entries are KVSnapshot-format pages** (the allocator's migration unit): an
  entry's pages + checksum reconstruct a :class:`~.kv_cache.KVSnapshot`
  with synthetic page ids ``0..n-1``, so a hit restores through the
  allocator's existing ``restore()`` — checksum verified, byte
  conservation asserted on the written bytes, undo-logged on mid-restore
  failure. The cache adds NO second restore path to audit.
- **Two tiers**: an in-process LRU (shared by every engine in the
  process) over a disk tier committed with the crash-safe kernel
  cache's atomic tmp+rename discipline, so a prefix prefilled by one
  process warm-starts every other fleet member pointed at the same
  ``TL_TPU_SERVE_PREFIX_DIR``. Disk serialization is DEFERRED to an
  entry's first reuse (a memory hit): single-use prompts — most
  traffic — never pay the base64+JSON write on the serving path, while
  a genuinely shared prefix reaches the fleet tier on its second
  in-process request (``flush()`` force-publishes, for offline
  seeders).
- **Corruption quarantines, never serves**: disk reads visit the
  ``cache.disk.read`` fault site and verify the entry checksum; a torn,
  corrupt, or injected-fault entry moves to ``.quarantine/`` (counted,
  logged) and reads as a miss — the damage stays inspectable, the
  request falls back to cold prefill.
- **Bounded by a page budget** (``TL_TPU_SERVE_PREFIX_PAGES``):
  least-recently-used entries evict — memory entry and its disk file
  together — counted in ``prefix_cache.evicted``.

Counters: ``prefix_cache.{hit,miss,bytes_saved,evicted,insert,
quarantined,write_errors}`` — and the ``/slo`` window stats read the
hit/miss pair.
"""

from __future__ import annotations

import base64
import hashlib
import json
import logging
import os
import threading
from collections import OrderedDict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..env import env
from ..observability import tracer as _trace
from ..resilience import faults as _faults
from .kv_cache import KVSnapshot, _page_digest

__all__ = ["PREFIX_SCHEMA", "PrefixEntry", "PrefixKVCache",
           "get_prefix_cache", "reset_prefix_cache"]

logger = logging.getLogger("tilelang_mesh_tpu_torch.serving")

PREFIX_SCHEMA = 1
QUARANTINE_DIR = ".quarantine"


def _entry_checksum(pages: List[Tuple[np.ndarray, np.ndarray]]):
    """KVSnapshot-format digest over synthetic page ids ``0..n-1`` —
    the SAME bytes ``KVSnapshot.verify`` and ``restore()`` recompute,
    so one checksum covers the entry on disk, in memory, and on the
    pages actually written into an allocator."""
    h = hashlib.sha256()
    nbytes = 0
    for i, (k, v) in enumerate(pages):
        nbytes += _page_digest(h, i, k, v)
    return h.hexdigest(), nbytes


class PrefixEntry:
    """The cached KV pages of one whole-page token prefix."""

    __slots__ = ("key", "n_tokens", "page_size", "heads", "head_dim",
                 "dtype", "pages", "checksum", "nbytes")

    def __init__(self, key: str, n_tokens: int, page_size: int,
                 heads: int, head_dim: int, dtype: str,
                 pages: List[Tuple[np.ndarray, np.ndarray]],
                 checksum: Optional[str] = None,
                 nbytes: Optional[int] = None):
        self.key = key
        self.n_tokens = int(n_tokens)
        self.page_size = int(page_size)
        self.heads = int(heads)
        self.head_dim = int(head_dim)
        self.dtype = str(dtype)          # pool dtype name
        self.pages = pages
        if checksum is None:
            checksum, nbytes = _entry_checksum(pages)
        self.checksum = checksum
        self.nbytes = int(nbytes)

    @property
    def n_pages(self) -> int:
        return len(self.pages)

    def to_snapshot(self, owner: int) -> KVSnapshot:
        """A fresh one-shot KVSnapshot over synthetic page ids, owned
        entirely by ``owner`` — ``allocator.restore()`` verifies the
        checksum, allocates, writes, and re-verifies byte conservation;
        the returned mapping's values (in id order 0..n-1) ARE the
        request's page list in token order."""
        return KVSnapshot(
            page_size=self.page_size, heads=self.heads,
            head_dim=self.head_dim, dtype=self.dtype,
            owners={owner: list(range(self.n_pages))},
            pages={i: self.pages[i] for i in range(self.n_pages)},
            checksum=self.checksum, nbytes=self.nbytes)

    def to_json(self) -> str:
        def b64(a: np.ndarray) -> str:
            return base64.b64encode(
                np.ascontiguousarray(a).tobytes()).decode()
        return json.dumps({
            "schema": PREFIX_SCHEMA, "key": self.key,
            "n_tokens": self.n_tokens, "page_size": self.page_size,
            "heads": self.heads, "head_dim": self.head_dim,
            "dtype": str(self.dtype), "checksum": self.checksum,
            "nbytes": self.nbytes,
            "pages": [{"k": b64(k), "v": b64(v)} for k, v in self.pages],
        })

    @classmethod
    def from_json(cls, text: str) -> "PrefixEntry":
        doc = json.loads(text)
        if doc.get("schema") != PREFIX_SCHEMA:
            raise ValueError(f"unknown prefix-cache schema "
                             f"{doc.get('schema')!r}")
        # bfloat16 pages travel as their uint16 bit patterns (the
        # port's host copies; the same bytes the JAX package writes)
        dt = np.dtype(np.uint16 if doc["dtype"] == "bfloat16"
                      else doc["dtype"])
        shape = (doc["heads"], doc["page_size"], doc["head_dim"])

        def arr(b: str) -> np.ndarray:
            a = np.frombuffer(base64.b64decode(b), dtype=dt)
            return a.reshape(shape).copy()

        ent = cls(doc["key"], doc["n_tokens"], doc["page_size"],
                  doc["heads"], doc["head_dim"], dt,
                  [(arr(p["k"]), arr(p["v"])) for p in doc["pages"]],
                  checksum=doc["checksum"], nbytes=doc["nbytes"])
        # content-address integrity: the held bytes must hash to the
        # stored checksum or the entry is corrupt (quarantined by the
        # caller)
        got, gb = _entry_checksum(ent.pages)
        if got != ent.checksum or gb != ent.nbytes:
            raise ValueError("prefix-cache entry checksum mismatch")
        return ent


class PrefixKVCache:
    """LRU memory tier over an atomic-commit disk tier, bounded by a
    total page budget."""

    def __init__(self, root: Optional[Path] = None,
                 page_budget: Optional[int] = None):
        self._explicit_root = Path(root) if root is not None else None
        self._budget = page_budget
        self._lock = threading.Lock()
        self._mem: "OrderedDict[str, PrefixEntry]" = OrderedDict()
        # keys inserted but not yet serialized to the disk tier: the
        # base64+JSON+atomic-write cost is paid on an entry's FIRST
        # REUSE (a memory hit), so single-use prompts — most traffic —
        # never pay disk serialization on the serving path
        self._pending_disk: set = set()
        self.hits = 0
        self.misses = 0
        self.inserts = 0
        self.evictions = 0
        self.quarantined = 0
        self.write_errors = 0
        self.bytes_saved = 0

    # -- configuration -------------------------------------------------
    @property
    def root(self) -> Path:
        if self._explicit_root is not None:
            self._explicit_root.mkdir(parents=True, exist_ok=True)
            return self._explicit_root
        return env.prefix_cache_dir()

    @property
    def page_budget(self) -> int:
        return self._budget if self._budget is not None \
            else max(1, env.TL_TPU_SERVE_PREFIX_PAGES)

    def _count(self, attr: str, n: int = 1) -> None:
        """Counter bump under the cache lock: the cache is shared by
        every engine in the process, and the stats feed gates
        (serve_prefill_smoke's hit count) that must not lose
        concurrent read-modify-write updates."""
        with self._lock:
            setattr(self, attr, getattr(self, attr) + n)

    # -- keying --------------------------------------------------------
    @staticmethod
    def key(geometry: str, tokens) -> str:
        """Content address of one token prefix under one pool geometry
        (two workloads with different pool shapes must never share an
        entry, whatever their token ids)."""
        h = hashlib.sha256()
        h.update(geometry.encode())
        h.update(np.asarray(tokens, np.int64).tobytes())
        return h.hexdigest()

    @staticmethod
    def prefix_keys(geometry: str, tokens, page_size: int):
        """Content addresses of EVERY whole-page prefix of ``tokens``,
        shortest first, in one incremental hashing pass (each prefix's
        byte stream is a prefix of the next one's, so one running
        sha256 plus a ``copy()`` per page boundary yields the same
        digests ``key()`` would — O(tokens) total instead of
        O(pages x tokens))."""
        toks = np.asarray(list(tokens), np.int64)
        ps = int(page_size)
        h = hashlib.sha256()
        h.update(geometry.encode())
        out = []
        for n_pages in range(1, len(toks) // ps + 1):
            h.update(toks[(n_pages - 1) * ps:n_pages * ps].tobytes())
            out.append((n_pages, h.copy().hexdigest()))
        return out

    # -- lookup --------------------------------------------------------
    def lookup(self, geometry: str, tokens, page_size: int
               ) -> Optional[PrefixEntry]:
        """The LONGEST cached whole-page prefix of ``tokens``, or None.
        One miss is counted per failed lookup (not per probed length);
        a hit counts once. ``bytes_saved`` is NOT counted here — the
        restore path calls :meth:`note_restored` once the entry's
        pages actually landed in an allocator, so the savings metric
        can never be satisfied by an entry that failed validation."""
        for n_pages, key in reversed(
                self.prefix_keys(geometry, tokens, page_size)):
            ent = self._get(key)
            if ent is not None:
                self._count("hits")
                _trace.inc("prefix_cache.hit")
                return ent
        self._count("misses")
        _trace.inc("prefix_cache.miss")
        return None

    def note_restored(self, ent: PrefixEntry) -> None:
        """Account one SUCCESSFUL restore of ``ent`` (checksum + byte
        conservation already verified by the allocator)."""
        self._count("bytes_saved", ent.nbytes)
        _trace.inc("prefix_cache.bytes_saved", ent.nbytes)

    def _get(self, key: str) -> Optional[PrefixEntry]:
        with self._lock:
            ent = self._mem.get(key)
            pending = ent is not None and key in self._pending_disk
            if pending:
                self._pending_disk.discard(key)
            if ent is not None:
                self._mem.move_to_end(key)      # LRU touch
        if pending:
            # first reuse proves the prefix is shared: NOW it earns
            # its place in the fleet disk tier (deferred publication)
            self._disk_store(ent)
        if ent is not None:
            return ent
        ent = self._disk_load(key)
        if ent is not None:
            with self._lock:
                self._mem[key] = ent
                self._mem.move_to_end(key)
            # a disk promotion grows the memory tier exactly like an
            # insert: the page budget bounds BOTH paths
            self._evict_over_budget()
        return ent

    # -- insert / evict ------------------------------------------------
    def insert(self, geometry: str, tokens,
               pages: List[Tuple[np.ndarray, np.ndarray]],
               page_size: int, heads: int, head_dim: int,
               dtype) -> Optional[PrefixEntry]:
        """Cache the whole-page prefix ``tokens`` (length must be
        ``len(pages) * page_size``) backed by ``pages`` COPIES. A key
        already present is not re-written (content addressing: same key
        = same bytes). The entry lands in the MEMORY tier immediately;
        disk serialization is deferred to its first reuse (``_get``) —
        single-use prompts never pay the write on the serving path.
        ``flush()`` forces pending entries out (fleet seeding)."""
        toks = list(tokens)
        if not pages or len(toks) != len(pages) * int(page_size):
            raise ValueError(
                f"prefix insert must be whole-page: {len(toks)} tokens "
                f"vs {len(pages)} page(s) x {page_size}")
        key = self.key(geometry, toks)
        with self._lock:
            if key in self._mem:
                self._mem.move_to_end(key)
                return self._mem[key]
        ent = PrefixEntry(key, len(toks), page_size, heads, head_dim,
                          str(dtype), pages)
        with self._lock:
            self._mem[key] = ent
            self._pending_disk.add(key)
        self._count("inserts")
        _trace.inc("prefix_cache.insert")
        self._evict_over_budget()
        return ent

    def drop(self, key: str, reason: str = "corrupt") -> None:
        """Remove an entry that failed at RESTORE time (the allocator's
        checksum/geometry rejection): the memory entry dies, the disk
        file quarantines, and the key reads as a miss until a clean
        prefill re-inserts it."""
        with self._lock:
            self._mem.pop(key, None)
        path = self.root / f"{key}.json"
        if path.is_file():
            self._quarantine(path, reason)
        else:
            self._count("quarantined")
            _trace.inc("prefix_cache.quarantined")
            _trace.event("prefix_cache.quarantine", "serving",
                         entry=key, reason=reason)

    def _evict_over_budget(self) -> None:
        """LRU eviction down to the page budget; a memory entry and its
        disk file leave together (the budget bounds the WHOLE tier)."""
        while True:
            with self._lock:
                total = sum(e.n_pages for e in self._mem.values())
                if total <= self.page_budget or len(self._mem) <= 1:
                    return
                key, ent = self._mem.popitem(last=False)
                pending = key in self._pending_disk
                self._pending_disk.discard(key)
            if not pending:     # a never-published entry has no file
                try:
                    (self.root / f"{key}.json").unlink(missing_ok=True)
                except OSError:
                    pass
            self._count("evictions")
            _trace.inc("prefix_cache.evicted")
            _trace.event("prefix_cache.evicted", "serving", key=key,
                         pages=ent.n_pages)

    # -- disk tier -----------------------------------------------------
    def _disk_store(self, ent: PrefixEntry) -> None:
        try:
            from ..cache.kernel_cache import atomic_write
            _faults.maybe_fail("cache.disk.write",
                               key=f"prefix:{ent.key}")
            atomic_write(self.root / f"{ent.key}.json", ent.to_json())
        except Exception as e:  # noqa: BLE001 — write failures degrade
            # to a process-local entry, never a serving failure
            self._count("write_errors")
            _trace.inc("prefix_cache.write_errors")
            logger.warning("prefix cache: disk write of %s failed "
                           "(%s: %s)", ent.key[:12], type(e).__name__, e)

    def _disk_load(self, key: str) -> Optional[PrefixEntry]:
        path = self.root / f"{key}.json"
        if not path.is_file():
            return None
        try:
            _faults.maybe_fail("cache.disk.read", key=f"prefix:{key}")
            return PrefixEntry.from_json(path.read_text())
        except Exception as e:  # noqa: BLE001 — corruption quarantines
            self._quarantine(path, f"{type(e).__name__}: {e}")
            return None

    def _quarantine(self, path: Path, reason: str) -> None:
        """Move a corrupt/unreadable entry aside — the evidence stays
        inspectable, the key reads as a miss, and the next completed
        prefill re-inserts a clean entry (the kernel cache's
        never-rebuild-in-place discipline)."""
        qdir = self.root / QUARANTINE_DIR
        try:
            qdir.mkdir(parents=True, exist_ok=True)
            dst = qdir / path.name
            n = 0
            while dst.exists():
                n += 1
                dst = qdir / f"{path.name}.{n}"
            os.replace(path, dst)
        except OSError:
            try:
                path.unlink(missing_ok=True)
            except OSError:
                pass
        self._count("quarantined")
        _trace.inc("prefix_cache.quarantined")
        _trace.event("prefix_cache.quarantine", "serving",
                     entry=path.name, reason=reason)
        logger.warning("prefix cache: quarantined corrupt entry %s "
                       "(%s)", path.name, reason)

    # -- accounting ----------------------------------------------------
    def stats(self) -> Dict[str, int]:
        with self._lock:
            entries = len(self._mem)
            pages = sum(e.n_pages for e in self._mem.values())
        return {"entries": entries, "pages": pages,
                "page_budget": self.page_budget, "hits": self.hits,
                "misses": self.misses, "inserts": self.inserts,
                "evictions": self.evictions,
                "quarantined": self.quarantined,
                "write_errors": self.write_errors,
                "bytes_saved": self.bytes_saved}

_CACHE: Optional[PrefixKVCache] = None
_CACHE_LOCK = threading.Lock()


def get_prefix_cache() -> PrefixKVCache:
    """The process-wide cache every workload in this process shares
    (the in-memory tier is the fast path; the disk tier is the fleet
    tier)."""
    global _CACHE
    with _CACHE_LOCK:
        if _CACHE is None:
            _CACHE = PrefixKVCache()
        return _CACHE


def reset_prefix_cache() -> None:
    global _CACHE
    with _CACHE_LOCK:
        _CACHE = None
