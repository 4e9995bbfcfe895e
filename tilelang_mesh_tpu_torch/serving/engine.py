"""ServingEngine: continuous batching with a failure-handling contract.

The port of the JAX package's engine, over the CUDA paged-decode kernel
(via :mod:`.batcher`). Its contract is the same:

1. **Every submitted request reaches a terminal outcome** (``result`` /
   ``shed`` / ``deadline_exceeded`` / ``failed`` / ``canceled``): no
   silent drops, no unbounded waits. Retry budgets are bounded and
   expiry sweeps run before every batch.
2. **Deadlines propagate.** A request's deadline caps admission
   feasibility, its retry budget, and the batch step watchdog: a batch
   carrying deadlines is waited for under a wall-clock bound of the
   tightest remaining deadline plus grace.
3. **Failures are classified, never hidden.** A step that raises (an
   injected fault, a CUDA kernel fault, a refused launch) goes through
   ``classify()``: deterministic failures fail the batch and feed the
   circuit breaker; transient, timeout and device-loss failures retry
   within the retry budget, then retire the request (``failed``, or
   ``shed`` when it carries a deadline), its KV slabs freed. A step is
   never re-run on the CPU: the port has no second backend.
   ``drain()`` finishes in-flight work while shedding new arrivals.
4. **Full lifecycle**: every ``step()`` interleaves a BOUNDED prefill
   quantum (at most ``TL_TPU_SERVE_PREFILL_PER_STEP`` chunk units of
   ``TL_TPU_SERVE_PREFILL_CHUNK`` tokens) with one decode batch; decode
   outputs are temperature/top-p sampled into token ids (TTFT recorded
   in ``serve.ttft`` at the first one); ``stream()`` yields tokens as
   they land and closing the stream cancels; ``cancel()`` retires a
   request as ``canceled`` and frees its KV slabs wherever it was in
   the lifecycle — including mid-prefill.

Fault sites: ``serve.admit`` (admission bookkeeping), ``serve.step``
(one batch dispatch), ``serve.kv`` (slab allocation — lives in
:mod:`.kv_cache`).
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional

from ..env import env
from ..observability import flight as _flight
from ..observability import histogram as _hist
from ..observability import reqtrace as _reqtrace
from ..observability import slo as _slo
from ..observability import tracer as _trace
from ..resilience import faults as _faults
from ..resilience.errors import TLError, classify, error_signature
from ..resilience.retry import global_breaker
from .admission import (STEP_HIST_KERNEL, SERVE_BREAKER_SIG,
                        AdmissionController)
from .batcher import DecodeWorkload
from .kv_cache import KVCacheExhausted
from .request import Request, publish_gauges

__all__ = ["ServingEngine", "TokenStream"]

logger = logging.getLogger("tilelang_mesh_tpu_torch.serving")


def _bounded_step(fn, budget_s: float, what: str):
    """Wait for a dispatch under a wall-clock bound; the dispatch runs on
    a daemon thread that is abandoned on expiry, so the scheduler keeps
    moving. On the card the bound is on WAITING, not on the kernel: a
    launched kernel cannot be abandoned, and a late step's kernel still
    occupies the stream ahead of the next step's. A result that lands
    late is still returned: per-request expiry decides who missed their
    deadline."""
    import queue
    import threading
    qq: "queue.Queue" = queue.Queue(maxsize=1)

    def _t():
        try:
            qq.put((True, fn()))
        except BaseException as e:  # noqa: BLE001 — relayed to caller
            qq.put((False, e))

    t = threading.Thread(target=_t, daemon=True,
                         name=f"tl-serve-step-{int(budget_s * 1e3)}ms")
    t.start()
    try:
        ok, val = qq.get(timeout=max(budget_s, 1e-3))
    except queue.Empty:
        from ..resilience.errors import TLTimeoutError
        raise TLTimeoutError(
            f"{what} exceeded its step budget ({budget_s * 1e3:.0f}ms); "
            f"worker {t.name} abandoned", site="serve.step") from None
    if not ok:
        raise val
    return val


class ServingEngine:
    """Synchronous continuous-batching scheduler (deterministic by
    construction: drive it with ``step()``/``run()``; a thread pumping
    ``run()`` makes it a background server)."""

    def __init__(self, workload: DecodeWorkload, *,
                 admission: Optional[AdmissionController] = None,
                 max_batch: Optional[int] = None,
                 grace_ms: Optional[float] = None,
                 step_timeout_ms: Optional[float] = None,
                 retry_max: Optional[int] = None,
                 default_deadline_ms: Optional[float] = None,
                 tenant_weights: Optional[Dict[str, int]] = None,
                 name: str = "serve"):
        self.workload = workload
        self.admission = admission or AdmissionController()
        self.max_batch = min(
            max_batch if max_batch is not None else env.TL_TPU_SERVE_MAX_BATCH,
            workload.max_batch)
        self.grace_ms = (grace_ms if grace_ms is not None
                         else env.TL_TPU_SERVE_GRACE_MS)
        self.step_timeout_ms = (step_timeout_ms if step_timeout_ms is not None
                                else env.TL_TPU_SERVE_STEP_TIMEOUT_MS)
        self.retry_max = (retry_max if retry_max is not None
                          else env.TL_TPU_SERVE_RETRY_MAX)
        self.default_deadline_ms = default_deadline_ms
        # chunked prefill: chunk units processed per step (bounds the
        # prefill work wedged between two decode dispatches)
        self.prefill_per_step = env.TL_TPU_SERVE_PREFILL_PER_STEP
        self.name = name
        # per-tenant batch weights (picks per round-robin round in
        # _form_batch); unlisted tenants weigh 1
        self.tenant_weights = dict(tenant_weights or {})
        self.requests: List[Request] = []    # every submission, in order
        self._queue: List[Request] = []      # admitted, awaiting a batch
        self._draining = False
        self._steps = 0
        self._step_failures = 0   # every _on_step_failure entry
        # the engine's own causal trace — batch-step spans live here,
        # linked to every member request's trace — plus the
        # sliding-window SLO engine.
        # max_spans bounds the never-terminal engine chain (one batch
        # span lands per step, forever): recent history stays, ancient
        # steps evict — the same keep-the-tail policy as the tracer ring
        self.trace = _reqtrace.start_trace("engine", kind="engine",
                                           engine=name, max_spans=1024)
        self._slo = _slo.get_slo()

    # -- submission / admission ----------------------------------------
    def submit(self, context_tokens: int, new_tokens: int = 1,
               deadline_ms: Optional[float] = None, seed: int = 0,
               payload: Optional[dict] = None,
               prompt_tokens: Optional[list] = None,
               temperature: float = 0.0,
               top_p: float = 1.0,
               tenant: Optional[str] = None) -> Request:
        """Admit or shed one request; ALWAYS returns the request with a
        state transition recorded (shed requests come back terminal).
        ``prompt_tokens`` is the prompt's token ids (default: derived
        from ``seed`` — identical seeds share a prefix-cache address);
        ``temperature``/``top_p`` are the sampling knobs (0 = greedy);
        ``tenant`` is the fairness label admission shares and batch
        round-robin key on (None = "default")."""
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        req = Request(context_tokens, new_tokens, deadline_ms=deadline_ms,
                      seed=seed, payload=payload,
                      prompt_tokens=prompt_tokens,
                      temperature=temperature, top_p=top_p,
                      tenant=tenant)
        self.requests.append(req)
        try:
            _faults.maybe_fail("serve.admit", req=req.req_id)
        except Exception as e:  # noqa: BLE001 — admission must not crash
            return self._shed(req, "admit_fault",
                              error=f"{type(e).__name__}: {e}")
        ok, reason = self.admission.decide(
            draining=self._draining,
            queue_depth=len(self._queue),
            free_pages=self.workload.allocator.free_pages,
            pages_needed=self.workload.pages_needed(context_tokens,
                                                    new_tokens),
            remaining_s=req.remaining_s(),
            steps_requested=new_tokens,
            prefill_chunks=self.workload.prefill_chunks_needed(
                context_tokens),
            tenant_inflight=sum(1 for r in self._queue
                                if r.tenant == req.tenant))
        if not ok:
            return self._shed(req, reason)
        try:
            self.workload.ingest(req)
        except ValueError:
            # misconfigured request: a caller bug, not load — it was
            # never accepted, so it must not linger non-terminal in
            # self.requests (the all-terminal contract audits that list)
            self.requests.remove(req)
            raise
        except (TLError, OSError) as e:
            # injected serve.kv fault or organic allocation failure
            # during context ingestion: terminal shed, never a crash
            return self._shed(req, "kv_exhausted",
                              error=f"{type(e).__name__}: {e}")
        req.admit()
        self._queue.append(req)
        _trace.inc("serve.admitted")
        self._gauges()
        return req

    def _shed(self, req: Request, reason: str,
              error: Optional[str] = None) -> Request:
        req.finish("shed", shed_reason=reason, error=error)
        self._retire_slabs(req)
        _trace.inc("serve.shed", reason=reason)
        _trace.inc("serve.tenant", tenant=req.tenant, outcome="shed")
        _trace.event("serve.shed", "serving", req=req.req_id,
                     reason=reason, error=error)
        self._observe_e2e(req)
        return req

    # -- warm-up -------------------------------------------------------
    def warmup(self) -> int:
        """Build the kernel library and dispatch every bucket BEFORE
        traffic, and seed the step-latency histogram admission reads its
        estimates from."""
        with _trace.span("serve.warmup_all", "serving", engine=self.name):
            t0 = time.perf_counter()
            n = self.workload.warmup()
            if n:
                # the first dispatch pays the kernel build; seed the step
                # estimate with one extra measured warm dispatch instead
                per = self._measured_warm_step()
                logger.info("serving engine %s: warmed %d bucket "
                            "kernel(s) in %.2fs (warm step ~%.2fms)",
                            self.name, n, time.perf_counter() - t0,
                            per * 1e3)
        return n

    def _measured_warm_step(self) -> float:
        """One post-build dispatch of the smallest bucket, timed to its
        host copy (the device work included), so the admission estimates
        start from a WARM step latency (folding build time in would shed
        every deadlined request at startup)."""
        import numpy as np
        bb = self.workload.batch_buckets[0]
        pp = self.workload.page_buckets[0]
        q = np.zeros(self.workload._query_shape(bb), np.float32)
        table = np.zeros((bb, pp), np.int32)
        t0 = time.perf_counter()
        self.workload._dispatch(q, table, bb, pp).cpu()
        dt = time.perf_counter() - t0
        _hist.observe("kernel.latency", dt, kernel=STEP_HIST_KERNEL,
                      source="serving")
        return dt

    # -- scheduling ----------------------------------------------------
    def _expire_queue(self, now: Optional[float] = None) -> int:
        grace_s = self.grace_ms / 1e3
        expired = [r for r in self._queue if r.expired(grace_s, now)]
        for r in expired:
            self._queue.remove(r)
            self._finish(r, "deadline_exceeded")
        return len(expired)

    def _form_batch(self) -> List[Request]:
        """FIFO head defines the page bucket; same-bucket followers fill
        the batch up to ``max_batch`` — interleaved weighted round-robin
        across tenants (FIFO within a tenant, the head's tenant picked
        first) so one tenant's backlog cannot monopolize every batch
        slot while another waits. With a single tenant this degenerates
        to the original FIFO fill; the head is always served — no
        starvation. Requests still mid-prefill are not decode-eligible
        and are skipped (their chunk units run in the prefill quantum
        instead)."""
        ready = [r for r in self._queue
                 if not r.needs_prefill and not r.cancel_requested]
        if not ready:
            return []
        head_bucket = self.workload.bucket_of(ready[0])
        by_tenant: Dict[str, List[Request]] = {}
        for r in ready:
            if self.workload.bucket_of(r) == head_bucket:
                by_tenant.setdefault(r.tenant, []).append(r)
        order = list(by_tenant)   # first-seen order: head's tenant first
        batch: List[Request] = []
        while len(batch) < self.max_batch and \
                any(by_tenant[t] for t in order):
            for t in order:
                take = max(1, int(self.tenant_weights.get(t, 1)))
                while take > 0 and by_tenant[t] \
                        and len(batch) < self.max_batch:
                    batch.append(by_tenant[t].pop(0))
                    take -= 1
                if len(batch) >= self.max_batch:
                    break
        for r in batch:
            self._queue.remove(r)
            r.batch()
        return batch

    def _cancel_sweep(self) -> int:
        """Retire queued requests whose cancellation was requested:
        terminal ``canceled``, KV slabs freed — the batcher never sees
        them again."""
        victims = [r for r in self._queue if r.cancel_requested]
        for r in victims:
            self._queue.remove(r)
            self._finish(r, "canceled")
        return len(victims)

    def _prefill_quantum(self) -> bool:
        """Run at most ``prefill_per_step`` prefill chunk units — the
        bounded wedge of prompt work between two decode dispatches. The
        FIFO-first mid-prefill request is re-picked per unit, so the
        queue head may consume several units in one step (it finishes
        — and becomes decode-eligible — sooner) and the whole budget
        is spent whenever work exists. ``prefill_per_step<=0`` is
        unthrottled: every pending chunk runs this step. Returns True
        when any chunk ran."""
        budget = (self.prefill_per_step if self.prefill_per_step > 0
                  else float("inf"))
        units = 0
        while units < budget:
            r = next((x for x in self._queue
                      if x.needs_prefill and not x.cancel_requested),
                     None)
            if r is None:
                break
            sid = r.trace.span("prefill.chunk", pos=r.prefill_pos)
            t0 = time.perf_counter()
            try:
                n = self.workload.prefill_chunk(r)
            except Exception as e:  # noqa: BLE001 — classified below
                r.trace.close_span(sid, error=f"{type(e).__name__}: {e}")
                self._queue.remove(r)
                if isinstance(e, (TLError, OSError)):
                    # injected serve.kv fault or organic KV pressure
                    # mid-prefill: terminal shed, slabs freed
                    self._finish(r, "shed", shed_reason="kv_exhausted",
                                 error=f"{type(e).__name__}: {e}")
                else:
                    self._finish(r, "failed",
                                 error=f"{type(e).__name__}: {e}")
                continue
            dt = time.perf_counter() - t0
            r.trace.close_span(sid, tokens=n,
                               done=not r.needs_prefill)
            _hist.observe("serve.prefill.latency", dt)
            _trace.inc("serve.prefill.chunks")
            _trace.inc("serve.prefill.tokens", n)
            units += 1
        return units > 0

    def _step_budget_s(self, batch: List[Request]) -> Optional[float]:
        """Deadline propagation into the step watchdog: the tightest
        remaining deadline (plus grace) caps the dispatch, as does the
        static ``TL_TPU_SERVE_STEP_TIMEOUT_MS`` when set."""
        budgets = []
        if self.step_timeout_ms > 0:
            budgets.append(self.step_timeout_ms / 1e3)
        rem = [r.remaining_s() for r in batch
               if r.remaining_s() is not None]
        if rem:
            budgets.append(max(min(rem), 0.0) + self.grace_ms / 1e3)
        return min(budgets) if budgets else None

    def step(self) -> bool:
        """Run one scheduling step — a bounded prefill quantum plus one
        decode batch; False when the queue is idle (no prefill ran and
        no batch formed)."""
        self._expire_queue()
        self._cancel_sweep()
        prefilled = self._prefill_quantum()
        batch = self._form_batch()
        if not batch:
            self._gauges()
            if prefilled:
                self._slo_tick()
            return prefilled
        now = time.monotonic()
        for r in batch:
            if r.first_batch_t is not None and len(r.timeline) <= 3:
                _hist.observe("serve.queue.wait", now - r.submit_t)
        budget = self._step_budget_s(batch)
        # tl-scope: the batch step is one span in the ENGINE's causal
        # trace, linked to every member request's trace_id; binding its
        # context around the dispatch tags every span/event recorded
        # underneath (kernel dispatches, collectives, faults) with
        # trace_id/parent_span — the connected arrow chain in the
        # Chrome trace
        member_ids = [r.trace_id for r in batch]
        batch_no = self._steps + 1
        step_sid = self.trace.span("serve.batch", batch=batch_no,
                                   size=len(batch), links=member_ids)
        t0 = time.perf_counter()
        try:
            with _trace.span("serve.batch", "serving", engine=self.name,
                             batch=batch_no, size=len(batch),
                             links=member_ids), \
                    _reqtrace.bind(self.trace.trace_id, step_sid):
                _faults.maybe_fail("serve.step", batch=len(batch))
                if budget is not None:
                    outs = _bounded_step(
                        lambda: self.workload.run_batch(batch), budget,
                        f"{self.name} batch of {len(batch)}")
                else:
                    outs = self.workload.run_batch(batch)
        except Exception as e:  # noqa: BLE001 — classified below
            self.trace.close_span(step_sid,
                                  error=f"{type(e).__name__}: {e}")
            self._on_step_failure(batch, e)
            self._gauges()
            self._slo_tick()
            return True
        dt = time.perf_counter() - t0
        self.trace.close_span(step_sid)
        self._steps += 1
        _trace.inc("serve.batches")
        _trace.inc("serve.steps", len(batch))
        _hist.observe("kernel.latency", dt, kernel=STEP_HIST_KERNEL,
                      source="serving")
        self._retire_or_requeue(batch, outs)
        self._gauges()
        self._slo_tick()
        return True

    def _slo_tick(self) -> None:
        """Feed the sliding-window SLO engine (throttled) and fire ONE
        flight-recorder dump per breach episode (docs/observability.md)."""
        try:
            if self._slo.tick():
                breach = self._slo.check_breach()
                if breach is not None:
                    _trace.event("slo.breach", "serving",
                                 engine=self.name,
                                 reasons=breach["breach_reasons"])
                    _flight.dump("slo_breach", engine=self.name,
                                 reasons=breach["breach_reasons"])
        except Exception:  # noqa: BLE001 — SLO math must not kill a step
            logger.warning("serving engine %s: SLO tick failed",
                           self.name, exc_info=True)

    def pump_bound(self) -> int:
        """The finite pump bound ``run()``/``TokenStream`` share: 20x
        the total outstanding work (decode steps + worst-case prefill
        chunk units) plus slack. Recomputed per call — submissions
        arriving mid-pump extend it; a scheduler bug still cannot pump
        forever."""
        total = sum(r.new_tokens
                    + self.workload.prefill_chunks_needed(
                        r.context_tokens)
                    for r in self.requests) or 1
        return 20 * total + 100

    def run(self, max_steps: Optional[int] = None) -> int:
        """Pump ``step()`` until idle; returns steps executed. The
        default bound is generous but FINITE — the no-unbounded-waits
        contract holds even against a scheduler bug."""
        if max_steps is None:
            max_steps = self.pump_bound()
        n = 0
        while n < max_steps:
            if not self.step():
                return n
            n += 1
        # the bound tripping means requests would otherwise wait forever:
        # retire everything still queued as failed, honoring the contract
        for r in list(self._queue):
            self._queue.remove(r)
            self._finish(r, "failed",
                         error=f"scheduler exceeded {max_steps} steps")
        logger.error("serving engine %s: scheduler bound (%d steps) hit; "
                     "queue force-retired", self.name, max_steps)
        self._gauges()
        return n

    def drain(self) -> None:
        """Stop admitting; ``run()`` finishes the in-flight work."""
        self._draining = True
        _trace.event("serve.drain", "serving", engine=self.name,
                     queued=len(self._queue))

    # -- cancellation / streaming --------------------------------------
    def cancel(self, req: Request) -> bool:
        """Cancel one request: queued (incl. mid-prefill) requests
        retire ``canceled`` immediately with their KV slabs freed; a
        request currently inside a batch dispatch is flagged and
        retired when the step returns (its in-flight work is not
        interruptible, its slabs still free the same step). False when
        the request is already terminal."""
        if req.is_terminal:
            return False
        req.cancel_requested = True
        req.trace.mark("cancel", steps_done=req.steps_done,
                       mid_prefill=req.needs_prefill)
        if req in self._queue:
            self._queue.remove(req)
            self._finish(req, "canceled")
            self._gauges()
        return True

    def stream(self, context_tokens: int, new_tokens: int = 1,
               deadline_ms: Optional[float] = None, seed: int = 0,
               payload: Optional[dict] = None,
               prompt_tokens: Optional[list] = None,
               temperature: float = 0.0,
               top_p: float = 1.0,
               tenant: Optional[str] = None) -> "TokenStream":
        """The streaming front-end: submit + an iterator yielding one
        event dict per sampled token (``{"token", "index", "req",
        "trace_id"}``) as decode steps land. The iterator pumps
        ``step()`` itself, so a plain ``for`` loop serves the request
        end to end; closing it early (``break``, ``.close()``)
        CANCELS the request and frees its KV slabs — the
        client-disconnect contract."""
        req = self.submit(context_tokens, new_tokens,
                          deadline_ms=deadline_ms, seed=seed,
                          payload=payload, prompt_tokens=prompt_tokens,
                          temperature=temperature, top_p=top_p,
                          tenant=tenant)
        return TokenStream(self, req)

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    # -- retirement ----------------------------------------------------
    def _retire_or_requeue(self, batch: List[Request], outs) -> None:
        now = time.monotonic()
        for r, out in zip(batch, outs):
            r.steps_done += 1
            r.result = out
            # real sampling (serving/sampling.py): the decode output
            # becomes ONE token id — what stream() yields and what the
            # appended KV content derives from
            try:
                tok = self.workload.sample(r, out)
            except Exception as e:  # noqa: BLE001 — a sampler bug fails
                self._finish(r, "failed",        # the request, never
                             error=f"{type(e).__name__}: {e}")  # a hang
                continue
            r.generated.append(tok)
            if r.first_token_t is None:
                # TTFT: submit -> first sampled token, the latency a
                # streaming client actually feels
                r.first_token_t = now
                _hist.observe("serve.ttft", now - r.submit_t)
                r.trace.mark("first_token", token=tok,
                             ttft_ms=round((now - r.submit_t) * 1e3, 3))
            if r.cancel_requested:
                # canceled while in flight: the step's work is done but
                # the client is gone — retire now, free the slabs
                self._finish(r, "canceled")
                continue
            if r.steps_done >= r.new_tokens:
                self._finish(r, "result")
                continue
            try:
                self.workload.append_token(r)
            except (KVCacheExhausted, TLError, OSError) as e:
                # mid-flight KV pressure (or an injected serve.kv
                # fault): the request cannot grow its context — shed
                # it terminally rather than serve corrupt attention
                self._finish(r, "shed", shed_reason="kv_exhausted",
                             error=f"{type(e).__name__}: {e}")
                continue
            r.requeue()
            self._queue.append(r)

    def _finish(self, req: Request, outcome: str, *,
                shed_reason: Optional[str] = None,
                error: Optional[str] = None) -> None:
        req.finish(outcome, shed_reason=shed_reason, error=error)
        self._retire_slabs(req)
        if outcome == "result":
            _trace.inc("serve.completed")
        elif outcome == "deadline_exceeded":
            _trace.inc("serve.deadline_exceeded")
            _trace.event("serve.deadline_exceeded", "serving",
                         req=req.req_id, steps_done=req.steps_done)
        elif outcome == "failed":
            _trace.inc("serve.failed")
            _trace.event("serve.request_failed", "serving",
                         req=req.req_id, error=error)
        elif outcome == "canceled":
            _trace.inc("serve.canceled")
            _trace.event("serve.canceled", "serving", req=req.req_id,
                         steps_done=req.steps_done,
                         mid_prefill=req.needs_prefill)
        else:
            _trace.inc("serve.shed", reason=shed_reason)
            _trace.event("serve.shed", "serving", req=req.req_id,
                         reason=shed_reason, error=error)
        _trace.inc("serve.tenant", tenant=req.tenant, outcome=outcome)
        self._observe_e2e(req)

    def _retire_slabs(self, req: Request) -> None:
        """Leak-checked slab release on EVERY terminal transition."""
        if req.pages:
            self.workload.retire(req)

    def _observe_e2e(self, req: Request) -> None:
        if req.terminal_t is not None:
            _hist.observe("serve.e2e.latency",
                          req.terminal_t - req.submit_t,
                          outcome=req.outcome)

    # -- failure handling ----------------------------------------------
    def _on_step_failure(self, batch: List[Request], exc: Exception) -> None:
        kind = classify(exc)
        self._step_failures += 1
        _trace.inc("serve.step_failures", kind=kind)
        _trace.event("serve.step_failure", "serving", kind=kind,
                     batch=[r.req_id for r in batch],
                     error=f"{type(exc).__name__}: {exc}")
        # the black box: a step failure dumps the flight ring with the
        # victim batch's member trace ids, so the post-mortem names
        # exactly which requests were in flight when the step died
        _flight.dump("step_failure", engine=self.name, kind=kind,
                     batch=[r.req_id for r in batch],
                     batch_trace_ids=[r.trace_id for r in batch],
                     error=f"{type(exc).__name__}: {exc}")
        if kind == "deterministic":
            # feed the shared breaker under both the per-error signature
            # (the stack-wide convention) and the rolled-up serve.step
            # signature admission checks
            breaker = global_breaker()
            breaker.record_failure(error_signature(exc))
            breaker.record_failure(SERVE_BREAKER_SIG)
            for r in batch:
                self._finish(r, "failed",
                             error=f"{type(exc).__name__}: {exc}")
            return
        # transient / timeout / device_loss: retry within budget
        grace_s = self.grace_ms / 1e3
        for r in batch:
            if r.expired(grace_s):
                self._finish(r, "deadline_exceeded")
            elif r.retries < self.retry_max:
                r.retries += 1
                _trace.inc("serve.retries")
                r.requeue()
                # retries go to the queue FRONT: their deadline budget
                # is already partly spent
                self._queue.insert(0, r)
            elif r.deadline is not None:
                self._finish(r, "shed", shed_reason="retry_budget",
                             error=f"{type(exc).__name__}: {exc}")
            else:
                self._finish(r, "failed",
                             error=f"retry budget exhausted: "
                                   f"{type(exc).__name__}: {exc}")

    # -- accounting ----------------------------------------------------
    def _gauges(self) -> None:
        alloc = self.workload.allocator
        publish_gauges(queue_depth=len(self._queue),
                       kv_pages_in_use=alloc.in_use,
                       kv_pages_free=alloc.free_pages,
                       draining=float(self._draining))

    def outcomes(self) -> Dict[str, int]:
        out = {"result": 0, "shed": 0, "deadline_exceeded": 0,
               "failed": 0, "canceled": 0, "pending": 0}
        for r in self.requests:
            out[r.outcome or "pending"] += 1
        return out

    @property
    def step_failures(self) -> int:
        """Step failures handled INTERNALLY (``_on_step_failure``
        swallows the exception to keep the scheduler moving)."""
        return self._step_failures

    def stats(self) -> dict:
        alloc = self.workload.allocator
        out = {
            "engine": self.name,
            "requests": len(self.requests),
            "outcomes": self.outcomes(),
            "queue_depth": len(self._queue),
            "steps": self._steps,
            "step_failures": self._step_failures,
            "draining": self._draining,
            "kv": alloc.stats(),
            "kv_leaks": {str(k): v
                         for k, v in alloc.leak_check().items()},
        }
        return out


class TokenStream:
    """Token-at-a-time iterator over one request (the ``stream()``
    front-end): yields an event dict per sampled token, pumping the
    host's synchronous ``step()`` underneath. Closing the iterator
    before the request retires cancels it — the generator-``close()``
    analog of a dropped client connection.

    The host is anything with the pump protocol — ``step()``,
    ``cancel(req)``, ``pump_bound()``. Tokens are read off
    ``req.generated``, never off a particular engine's queue."""

    def __init__(self, engine, request: Request):
        self.engine = engine     # the pump host
        self.request = request

    def cancel(self) -> bool:
        return self.engine.cancel(self.request)

    def __iter__(self):
        eng, req = self.engine, self.request
        delivered = 0

        def pending():
            return req.generated[delivered:]

        # same finite-bound discipline as run(), over the WHOLE host's
        # work: the stream pumps every request's steps, so a bound
        # scaled only to this request would spuriously cancel a
        # healthy stream queued behind a long-running neighbor.
        # Recomputed per pump — submissions arriving mid-stream extend
        # it, a scheduler bug still cannot pump forever.
        try:
            pumps = 0
            while not req.is_terminal and pumps < eng.pump_bound():
                progressed = eng.step()
                pumps += 1
                for tok in pending():
                    delivered += 1
                    yield {"token": int(tok), "index": delivered,
                           "req": req.req_id, "trace_id": req.trace_id}
                if not progressed and not req.is_terminal:
                    break      # idle queue with a live request: a
                # scheduler bug — the finally clause cancels it so the
                # contract (every request terminal) still holds
            for tok in pending():
                delivered += 1
                yield {"token": int(tok), "index": delivered,
                       "req": req.req_id, "trace_id": req.trace_id}
        finally:
            if not req.is_terminal:
                eng.cancel(req)
