"""Shape-bucketed continuous batching over the decode kernels.

Every dispatch is quantized onto a small grid of (batch, pages) buckets,
as in the JAX package:

- **batch buckets** — a batch of ``n`` live requests pads up to the
  smallest configured bucket ``B >= n`` (padding rows replicate the
  last request's page table; their outputs are discarded);
- **page buckets** — requests are grouped by their *attention window*
  in whole pages (``(context + generated) // page_size``); a window
  larger than the biggest configured bucket attends over the most
  recent ``max_bucket`` pages (a sliding suffix window).

On the card the buckets bound the number of distinct launch shapes; the
CUDA kernel itself takes any shape, so ``warmup()`` is what builds the
kernel library (``nvcc``, at first use) and launches it once per bucket,
before any request can pay that time.

:class:`FlashDecodeWorkload` walks the allocator's H-major pools in the
kernel (``ops/flash_decoding.flash_decode_paged_pool``);
:class:`MLADecodeWorkload` gathers its latent rows on the pools' device
and runs the MLA kernel (``ops/mla.mla_decode``). The pools stay on the
device, and a step moves only the queries and the page table to the
card and the decode output back (that copy is the step's
synchronisation point, so a step's measured latency includes the
kernel).

Full-lifecycle pieces, as in the JAX package:

- **Chunked prefill** — ``ingest()`` fills at most ONE chunk
  (``TL_TPU_SERVE_PREFILL_CHUNK`` tokens) of the prompt's KV
  synchronously; the rest is schedulable work the engine drives via
  ``prefill_chunk()`` between decode steps. KV content is a pure
  function of ``(token id, position)``, drawn with numpy exactly as the
  JAX package draws it, so the port's pools hold the reference's bytes.
- **Prefix reuse** — ``ingest()`` first asks the :mod:`.prefix_cache`
  for the longest cached whole-page prefix of the prompt and restores
  it through the allocator's checksummed ``restore()``; a completed
  prefill publishes its whole-page prefix back (a device-to-host copy
  of those pages).
- **Sampling** — ``sample()`` projects the decode output onto a logit
  vector and draws one token id (temperature/top-p, :mod:`.sampling`).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..env import env
from ..observability import tracer as _trace
from .kv_cache import PagedKVAllocator
from .request import Request

__all__ = ["DecodeWorkload", "FlashDecodeWorkload", "MLADecodeWorkload",
           "PREFILL_CONTENT_VERSION"]

# bump when the (token, position) -> KV content derivation changes:
# part of the prefix-cache geometry key (the JAX package's value, so
# the two packages' keys stay byte-equal)
PREFILL_CONTENT_VERSION = 1


class DecodeWorkload:
    """Common bucketing/warm-up/prefill logic; subclasses supply the
    kernel and the (token, position) -> KV content derivation."""

    def __init__(self, allocator: PagedKVAllocator,
                 batch_buckets: Sequence[int] = (1, 2, 4, 8),
                 page_buckets: Sequence[int] = (2, 4),
                 prefix_cache=None):
        if not batch_buckets or not page_buckets:
            raise ValueError("batch_buckets and page_buckets must be "
                             "non-empty")
        self.allocator = allocator
        self.batch_buckets = tuple(sorted(set(int(b)
                                              for b in batch_buckets)))
        self.page_buckets = tuple(sorted(set(int(p)
                                             for p in page_buckets)))
        if self.page_buckets[0] < 1:
            raise ValueError("page buckets must be >= 1")
        self._warm: set = set()
        # every kernel dispatch this workload made (warm-up included):
        # chip_smoke.py holds the kernel's launch count against it
        self.dispatches = 0
        # stand-in sampler vocabulary (serving/sampling.py)
        self.vocab = max(2, env.TL_TPU_SERVE_VOCAB)
        # content-addressed prefix KV cache: None = the env-gated
        # process cache (TL_TPU_SERVE_PREFIX), False = disabled, or an
        # explicit PrefixKVCache instance (tests, benches)
        if prefix_cache is None:
            if env.TL_TPU_SERVE_PREFIX:
                from .prefix_cache import get_prefix_cache
                self.prefix_cache = get_prefix_cache()
            else:
                self.prefix_cache = None
        elif prefix_cache is False:
            self.prefix_cache = None
        else:
            self.prefix_cache = prefix_cache

    # -- bucketing -----------------------------------------------------
    @property
    def max_batch(self) -> int:
        return self.batch_buckets[-1]

    def batch_bucket(self, n: int) -> int:
        """Smallest configured batch bucket holding ``n`` requests."""
        for b in self.batch_buckets:
            if b >= n:
                return b
        return self.batch_buckets[-1]

    def window_pages(self, req: Request) -> int:
        """The request's attention window in whole pages, clamped onto
        the configured page buckets (sliding suffix window above the
        top bucket; the smallest bucket below the bottom one)."""
        total = req.context_tokens + req.steps_done
        full = total // self.allocator.page_size
        for p in reversed(self.page_buckets):
            if full >= p:
                return p
        return self.page_buckets[0]

    def bucket_of(self, req: Request) -> int:
        return self.window_pages(req)

    def pages_needed(self, context_tokens: int,
                     new_tokens: int) -> int:
        """Worst-case page footprint of a request (context + every
        generated token) — what admission checks against capacity."""
        ps = self.allocator.page_size
        return math.ceil((context_tokens + new_tokens) / ps)

    # -- request ingestion / prefill / growth --------------------------
    def ingest(self, req: Request) -> None:
        """Admit the request's KV context: restore the longest cached
        whole-page prefix, then fill at most ONE prefill chunk
        synchronously; a longer prompt leaves ``req.needs_prefill`` set
        and the engine drives the remaining chunks between decode
        steps."""
        ps = self.allocator.page_size
        if req.context_tokens < self.page_buckets[0] * ps:
            raise ValueError(
                f"request #{req.req_id}: context_tokens="
                f"{req.context_tokens} is below the smallest page "
                f"bucket ({self.page_buckets[0]} page(s) x {ps})")
        req.pages = []
        req.tail_tokens = 0
        req.prefill_pos = 0
        if self.prefix_cache is not None:
            ent = self.prefix_cache.lookup(
                self.prefix_geometry(), req.prompt_tokens, ps)
            if ent is not None:
                self._restore_prefix(req, ent)
        self.prefill_chunk(req)

    def _restore_prefix(self, req: Request, ent) -> None:
        """Restore a prefix-cache hit through the allocator's
        checksummed ``restore()``. A corrupt entry is dropped +
        quarantined and the request falls back to cold prefill;
        capacity exhaustion propagates."""
        try:
            mapping = self.allocator.restore(ent.to_snapshot(req.req_id))
        except ValueError as e:
            self.prefix_cache.drop(ent.key, reason=f"restore rejected: "
                                                   f"{e}")
            return
        req.pages = [mapping[i] for i in range(ent.n_pages)]
        req.prefill_pos = ent.n_tokens
        req.prefix_tokens = ent.n_tokens
        req.tail_tokens = 0
        self.prefix_cache.note_restored(ent)
        req.trace.mark("prefix.hit", tokens=ent.n_tokens,
                       pages=ent.n_pages, bytes=ent.nbytes)

    def prefill_chunk(self, req: Request,
                      max_tokens: Optional[int] = None) -> int:
        """Fill up to one chunk of the prompt's KV (allocating pages as
        the fill crosses page boundaries — the ``serve.kv`` fault site
        is visited per page). Returns the number of tokens filled; on
        completion the whole-page prefix is published to the prefix
        cache and the request becomes decode-eligible."""
        ps = self.allocator.page_size
        chunk = int(max_tokens if max_tokens is not None
                    else env.TL_TPU_SERVE_PREFILL_CHUNK)
        end = min(req.context_tokens, req.prefill_pos + max(1, chunk))
        start = req.prefill_pos
        while req.prefill_pos < end:
            off = req.prefill_pos % ps
            if off == 0 and len(req.pages) * ps <= req.prefill_pos:
                req.pages.extend(self.allocator.alloc(1, req.req_id))
            n = min(ps - off, end - req.prefill_pos)
            k, v = self._prompt_block(req, req.prefill_pos, n)
            self.allocator.write_span(req.pages[req.prefill_pos // ps],
                                      off, k, v)
            req.prefill_pos += n
        req.tail_tokens = req.prefill_pos % ps
        if not req.needs_prefill:
            self._publish_prefix(req)
        return req.prefill_pos - start

    def prefill_chunks_needed(self, context_tokens: int) -> int:
        """Worst-case chunk units a prompt needs (no prefix hit) — what
        admission folds into deadline feasibility."""
        return math.ceil(int(context_tokens)
                         / max(1, env.TL_TPU_SERVE_PREFILL_CHUNK))

    def _prompt_block(self, req: Request, start: int,
                      n: int) -> Tuple[np.ndarray, np.ndarray]:
        """(H, n, D) float32 K/V blocks for prompt tokens
        [start, start+n) — pure in (token id, position), the prefix-cache
        contract. The allocator casts to the pool dtype on write."""
        al = self.allocator
        k = np.empty((al.heads, n, al.head_dim), np.float32)
        v = np.empty((al.heads, n, al.head_dim), np.float32)
        for i in range(n):
            pos = start + i
            ki, vi = self._content_kv(req.prompt_tokens[pos], pos)
            k[:, i, :] = ki
            v[:, i, :] = vi
        return k, v

    def _publish_prefix(self, req: Request) -> None:
        """Insert the prompt's whole-page prefix into the prefix cache —
        host copies of the pages (one device-to-host copy), since the
        live pages keep mutating as the request decodes. Skipped when
        the cache is off, the prompt has no full page, or the full
        prefix itself came from the cache."""
        if self.prefix_cache is None:
            return
        ps = self.allocator.page_size
        full = req.context_tokens // ps
        if full < 1 or req.prefix_tokens >= full * ps:
            return
        pages = self.allocator.host_pages(req.pages[:full])
        try:
            self.prefix_cache.insert(
                self.prefix_geometry(), req.prompt_tokens[:full * ps],
                pages, ps, self.allocator.heads, self.allocator.head_dim,
                self.allocator.dtype)
        except Exception:  # noqa: BLE001 — caching is advisory, never
            pass           # a prefill failure

    def prefix_geometry(self) -> str:
        """The geometry half of the prefix-cache content address (the
        JAX package's spelling, byte for byte)."""
        al = self.allocator
        return (f"{type(self).__name__}:v{PREFILL_CONTENT_VERSION}"
                f":h{al.heads}:d{al.head_dim}:ps{al.page_size}"
                f":{al.dtype}")

    def append_token(self, req: Request) -> None:
        """Append the just-sampled token's KV in place; allocates a
        fresh page exactly when the tail page is full."""
        ps = self.allocator.page_size
        if req.tail_tokens == 0:
            req.pages.extend(self.allocator.alloc(1, req.req_id))
        page = req.pages[-1]
        k, v = self._token_kv(req)
        self.allocator.write_token(page, req.tail_tokens, k, v)
        req.tail_tokens = (req.tail_tokens + 1) % ps

    # -- sampling ------------------------------------------------------
    def sample(self, req: Request, out) -> int:
        """One token id from a decode step's output: project onto the
        stand-in vocabulary, then temperature/top-p sample with a
        (seed, step)-derived rng."""
        from .sampling import sample_token
        rng = np.random.default_rng((req.seed, 3, req.steps_done))
        return sample_token(self._logits(out),
                            temperature=req.temperature,
                            top_p=req.top_p, rng=rng)

    def _logits(self, out) -> np.ndarray:
        """Deterministic projection of the decode output onto ``vocab``
        logits (the stand-in for an LM head)."""
        flat = np.asarray(out, np.float32).ravel()
        if flat.size >= self.vocab:
            return flat[:self.vocab]
        return np.resize(flat, self.vocab)

    def retire(self, req: Request) -> int:
        """Release every slab the request holds (called on ANY terminal
        transition of an ingested request)."""
        freed = self.allocator.free(req.req_id)
        req.pages = []
        req.tail_tokens = 0
        return freed

    # -- dispatch ------------------------------------------------------
    def run_batch(self, requests: List[Request]) -> List[np.ndarray]:
        """One decode step for every request (all in one page bucket):
        pad to the batch bucket, dispatch the kernel, copy the output to
        the host (the step's synchronisation) and slice per-request
        outputs."""
        if not requests:
            return []
        if any(r.needs_prefill for r in requests):
            raise ValueError("batch contains a mid-prefill request "
                             "(scheduler bug)")
        pp = self.bucket_of(requests[0])
        if any(self.bucket_of(r) != pp for r in requests):
            raise ValueError("batch mixes page buckets (scheduler bug)")
        bb = self.batch_bucket(len(requests))
        table = np.zeros((bb, pp), np.int32)
        for i in range(bb):
            r = requests[min(i, len(requests) - 1)]   # pad = replicate
            # suffix window: the most recent pp FULL pages
            total = r.context_tokens + r.steps_done
            full = total // self.allocator.page_size
            full_pages = r.pages[:full]
            table[i, :] = full_pages[-pp:]
        q = np.stack([self._query(requests[min(i, len(requests) - 1)])
                      for i in range(bb)])
        _trace.event("serve.dispatch", "serving",
                     workload=type(self).__name__, batch=bb, pages=pp)
        out = self._dispatch(q, table, bb, pp).cpu().numpy()
        return [out[i] for i in range(len(requests))]

    # -- warm-up -------------------------------------------------------
    def warmup(self) -> int:
        """Dispatch every (batch, pages) bucket once, so no serving
        request pays the kernel build or a first launch. Returns the
        number of buckets warmed."""
        n = 0
        for bb in self.batch_buckets:
            for pp in self.page_buckets:
                if (bb, pp) in self._warm:
                    continue
                with _trace.span("serve.warmup", "serving", batch=bb,
                                 pages=pp, workload=type(self).__name__):
                    q = np.zeros(self._query_shape(bb), np.float32)
                    table = np.zeros((bb, pp), np.int32)
                    self._dispatch(q, table, bb, pp).cpu()
                self._warm.add((bb, pp))
                _trace.inc("serve.warmup.kernels")
                n += 1
        return n

    # -- subclass surface ----------------------------------------------
    def _query_shape(self, bb: int) -> tuple:
        raise NotImplementedError

    def _query(self, req: Request) -> np.ndarray:
        raise NotImplementedError

    def _content_kv(self, token: int, pos: int):
        """One token's ``(k, v)`` pair, each ``(heads, head_dim)`` —
        MUST be pure in (token, pos)."""
        raise NotImplementedError

    def _token_kv(self, req: Request):
        """The just-generated token's KV: content derives from the
        SAMPLED token id at its absolute position."""
        pos = req.context_tokens + req.steps_done - 1
        tok = req.generated[-1] if req.generated else \
            int(np.random.default_rng((req.seed, 2,
                                       req.steps_done)).integers(1 << 30))
        return self._content_kv(tok, pos)

    def _dispatch(self, q: np.ndarray, table: np.ndarray, bb: int,
                  pp: int) -> torch.Tensor:
        raise NotImplementedError


class FlashDecodeWorkload(DecodeWorkload):
    """Single-token attention over the paged pool, walked in the CUDA
    kernel (``flash_decode_paged_pool``: table-driven row offsets, no
    gather pass)."""

    def __init__(self, allocator: PagedKVAllocator, *,
                 batch_buckets: Sequence[int] = (1, 2, 4, 8),
                 page_buckets: Sequence[int] = (2, 4),
                 sm_scale: float = None, prefix_cache=None):
        super().__init__(allocator, batch_buckets, page_buckets,
                         prefix_cache=prefix_cache)
        self.sm_scale = (sm_scale if sm_scale is not None
                         else 1.0 / math.sqrt(allocator.head_dim))

    def _query_shape(self, bb: int) -> tuple:
        return (bb, self.allocator.heads, 1, self.allocator.head_dim)

    def _query(self, req: Request) -> np.ndarray:
        rng = np.random.default_rng((req.seed, 1, req.steps_done))
        return rng.standard_normal(
            (self.allocator.heads, 1, self.allocator.head_dim)
        ).astype(np.float32)

    def _content_kv(self, token: int, pos: int):
        rng = np.random.default_rng((int(token) % (1 << 31), int(pos)))
        shape = (self.allocator.heads, self.allocator.head_dim)
        return (rng.standard_normal(shape).astype(np.float32),
                rng.standard_normal(shape).astype(np.float32))

    def _dispatch(self, q, table, bb: int, pp: int) -> torch.Tensor:
        from ..ops.flash_decoding import flash_decode_paged_pool
        al = self.allocator
        qt = torch.from_numpy(np.ascontiguousarray(q)).to(al.device)
        tt = torch.from_numpy(np.ascontiguousarray(table)).to(al.device)
        self.dispatches += 1
        return flash_decode_paged_pool(qt, al.kp, al.vp, tt, al.page_size,
                                       sm_scale=self.sm_scale)


class MLADecodeWorkload(DecodeWorkload):
    """DeepSeek-MLA decode over paged latent rows: each pool row holds
    ``[ckv (dc) | kpe (dr)]`` for one token (one shared latent cache
    for all heads; ``heads`` is the query-head count). A step gathers
    the window's rows to contiguous ``(B, S, dc + dr)`` on the pools'
    device (the gather strategy of the paged-decode pair), then
    ``mla_decode`` runs the split-KV latent kernel on the ``ckv`` and
    ``kpe`` column views of those rows, with no further copy."""

    def __init__(self, allocator: PagedKVAllocator, *, heads: int,
                 latent_dim: int, rope_dim: int,
                 batch_buckets: Sequence[int] = (1, 2, 4),
                 page_buckets: Sequence[int] = (2, 4),
                 sm_scale: float = None, prefix_cache=None):
        if allocator.heads != 1 or \
                allocator.head_dim != latent_dim + rope_dim:
            raise ValueError(
                "MLA pools are latent-major: construct the allocator "
                "with heads=1, head_dim=latent_dim+rope_dim")
        super().__init__(allocator, batch_buckets, page_buckets,
                         prefix_cache=prefix_cache)
        self.heads = int(heads)
        self.dc = int(latent_dim)
        self.dr = int(rope_dim)
        self.sm_scale = (sm_scale if sm_scale is not None
                         else 1.0 / math.sqrt(self.dc + self.dr))

    def _query_shape(self, bb: int) -> tuple:
        return (bb, self.heads, self.dc + self.dr)

    def _query(self, req: Request) -> np.ndarray:
        rng = np.random.default_rng((req.seed, 1, req.steps_done))
        return rng.standard_normal(
            (self.heads, self.dc + self.dr)).astype(np.float32)

    def _content_kv(self, token: int, pos: int):
        rng = np.random.default_rng((int(token) % (1 << 31), int(pos)))
        shape = (1, self.dc + self.dr)
        return (rng.standard_normal(shape).astype(np.float32),
                np.zeros(shape, np.float32))    # vp unused for MLA

    def _dispatch(self, q, table, bb: int, pp: int) -> torch.Tensor:
        from ..ops.mla import mla_decode
        al = self.allocator
        ps = al.page_size
        qt = torch.from_numpy(np.ascontiguousarray(q)).to(al.device)
        tt = torch.from_numpy(np.ascontiguousarray(table)).to(al.device)
        # pool rows of the window, in token order: (bb, pp * ps)
        idx = (tt.long()[:, :, None] * ps
               + torch.arange(ps, device=al.device)).reshape(bb, pp * ps)
        seq = al.kp[0][idx]                             # (B, S, dc+dr)
        self.dispatches += 1
        return mla_decode(qt[..., :self.dc], qt[..., self.dc:],
                          seq[..., :self.dc], seq[..., self.dc:],
                          sm_scale=self.sm_scale)
