"""Request lifecycle for the serving engine.

The state machine is the product (docs/serving.md):

    queued -> admitted -> batched -> terminal

with exactly five terminal outcomes — ``result`` (the request finished
its decode steps), ``shed`` (admission control rejected it, with a
named reason), ``deadline_exceeded`` (its deadline + grace passed while
queued, in flight, or during a retry), ``failed`` (a deterministic
error retired it), ``canceled`` (the client abandoned it — a closed
stream, an explicit ``engine.cancel()`` — and its KV slabs were freed
mid-request). The engine's contract is that EVERY submitted request
reaches one of the five: no silent drops, no unbounded waits.
``batched`` flips back to ``admitted`` between decode steps — that
re-queueing is what makes the batching *continuous* (a half-finished
request shares its next batch with newly admitted ones). A request
with a prompt longer than one prefill chunk additionally spends time
``admitted`` while its context fills chunk by chunk (the engine
interleaves those chunk units with decode steps).

Every transition is stamped (monotonic clock) into ``timeline`` so the
chaos soak can prove the zero-hang guarantee per request instead of
globally.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Dict, List, Optional

from ..observability import reqtrace as _reqtrace

__all__ = ["Request", "STATES", "OUTCOMES", "SHED_REASONS"]

# non-terminal states, in lifecycle order
STATES = ("queued", "admitted", "batched", "terminal")

# the five terminal outcomes — the whole vocabulary; accounting keys on
# these strings, so they never grow ad hoc
OUTCOMES = ("result", "shed", "deadline_exceeded", "failed", "canceled")

# the admission-control shed vocabulary (admission.py decides, the
# engine records ``serve.shed{reason=}``); ``retry_budget`` is the one
# mid-flight shed: a transient step failure whose deadline headroom
# cannot absorb another attempt; ``tenant_share`` is the per-tenant
# fairness gate (one tenant holding more than its configured share of
# the queue); ``failover`` is the fleet's last resort — an engine died
# and no healthy peer could adopt the request
SHED_REASONS = ("draining", "queue_full", "breaker_open", "kv_exhausted",
                "deadline_infeasible", "overload", "admit_fault",
                "retry_budget", "tenant_share", "failover")

_req_seq = itertools.count(1)


def default_prompt(seed: int, n: int) -> list:
    """Deterministic seed-derived prompt token ids (the stand-in for a
    tokenizer): identical ``(seed, n)`` pairs share a prompt — and
    therefore a prefix-cache content address — by construction."""
    import numpy as np
    rng = np.random.default_rng((int(seed), 0x70))
    return [int(t) for t in rng.integers(0, 1 << 30, size=int(n))]


class Request:
    """One inference request: a paged KV context plus ``new_tokens``
    decode steps to run. ``deadline_ms`` is relative to submission and
    converted to an absolute monotonic stamp at construction so it can
    propagate (retry budgets, step watchdog caps) without re-reading
    clocks ambiguously."""

    __slots__ = ("req_id", "context_tokens", "new_tokens", "deadline",
                 "submit_t", "seed", "state", "outcome", "shed_reason",
                 "error", "result", "steps_done", "retries", "pages",
                 "tail_tokens", "timeline", "terminal_t", "first_batch_t",
                 "payload", "trace", "_step_span", "prompt_tokens",
                 "temperature", "top_p", "generated", "prefill_pos",
                 "prefix_tokens", "cancel_requested", "first_token_t",
                 "tenant")

    def __init__(self, context_tokens: int, new_tokens: int = 1,
                 deadline_ms: Optional[float] = None, seed: int = 0,
                 payload: Optional[Dict[str, Any]] = None,
                 prompt_tokens: Optional[List[int]] = None,
                 temperature: float = 0.0, top_p: float = 1.0,
                 tenant: Optional[str] = None):
        if context_tokens <= 0:
            raise ValueError("context_tokens must be positive")
        if new_tokens <= 0:
            raise ValueError("new_tokens must be positive")
        if not (0.0 < top_p <= 1.0):
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        self.req_id = next(_req_seq)
        self.context_tokens = int(context_tokens)
        self.new_tokens = int(new_tokens)
        self.submit_t = time.monotonic()
        self.deadline = (self.submit_t + deadline_ms / 1e3
                         if deadline_ms is not None else None)
        self.seed = int(seed)
        self.payload = payload or {}
        # fairness label: admission shares and batch round-robin key on
        # it; untagged callers all land in "default" (exactly the old
        # single-tenant behavior)
        self.tenant = str(tenant) if tenant else "default"
        # the prompt as token ids — the content address of the prefix
        # cache and the input of the stand-in KV derivation; defaults
        # to a seed-derived deterministic prompt so every pre-prompt
        # caller keeps its exact behavior
        if prompt_tokens is None:
            prompt_tokens = default_prompt(self.seed, self.context_tokens)
        prompt_tokens = [int(t) for t in prompt_tokens]
        if len(prompt_tokens) != self.context_tokens:
            raise ValueError(
                f"prompt_tokens has {len(prompt_tokens)} token(s) but "
                f"context_tokens={self.context_tokens}")
        self.prompt_tokens = prompt_tokens
        # sampling knobs (serving/sampling.py): temperature 0 = greedy
        self.temperature = float(temperature)
        self.top_p = float(top_p)
        self.generated: List[int] = []   # sampled token ids, in order
        self.state = "queued"
        self.outcome: Optional[str] = None
        self.shed_reason: Optional[str] = None
        self.error: Optional[str] = None
        self.result = None           # last decode step's output (np array)
        self.steps_done = 0
        self.retries = 0
        self.pages: List[int] = []   # allocator page ids owned right now
        self.tail_tokens = 0         # tokens in the (uncommitted) tail page
        self.prefill_pos = 0         # prompt tokens whose KV is filled
        self.prefix_tokens = 0       # of those, restored from the cache
        self.cancel_requested = False
        self.timeline: List[tuple] = [("queued", self.submit_t)]
        self.terminal_t: Optional[float] = None
        self.first_batch_t: Optional[float] = None
        self.first_token_t: Optional[float] = None   # TTFT stamp
        # tl-scope causal chain (observability/reqtrace.py): every
        # lifecycle transition below lands in it, so a terminal
        # request's whole story — submit, admit, every decode step,
        # every requeue/retry, the outcome — is reconstructible even
        # with TL_TPU_TRACE off. The root "submit" span closes at the
        # admission decision; step spans open at batch() and close at
        # requeue()/finish().
        self.trace = _reqtrace.start_trace(
            "request", req=self.req_id, ctx=self.context_tokens,
            steps=self.new_tokens, deadline_ms=deadline_ms)
        self._step_span: Optional[int] = self.trace.span("submit")

    @property
    def trace_id(self) -> str:
        return self.trace.trace_id

    @property
    def needs_prefill(self) -> bool:
        """True while prompt tokens remain to fill — the request sits
        ``admitted`` in the queue as schedulable prefill-chunk work and
        is not yet eligible for a decode batch."""
        return self.prefill_pos < self.context_tokens

    # -- transitions ---------------------------------------------------
    def _stamp(self, state: str) -> None:
        self.state = state
        self.timeline.append((state, time.monotonic()))

    def _close_step(self, **attrs) -> None:
        if self._step_span is not None:
            self.trace.close_span(self._step_span, **attrs)
            self._step_span = None

    def admit(self) -> None:
        self._close_step(outcome="admitted")
        self._stamp("admitted")

    def batch(self) -> None:
        if self.first_batch_t is None:
            self.first_batch_t = time.monotonic()
        self._close_step()    # defensive: a step span must never nest
        self._step_span = self.trace.span("decode.step",
                                          step=self.steps_done + 1)
        self._stamp("batched")

    def requeue(self) -> None:
        """Back to the queue — between decode steps (continuous
        batching) or on a retryable step failure."""
        self._close_step(outcome="requeue")
        self.trace.mark("requeue", steps_done=self.steps_done,
                        retries=self.retries)
        self._stamp("admitted")

    def finish(self, outcome: str, *, shed_reason: Optional[str] = None,
               error: Optional[str] = None) -> None:
        if outcome not in OUTCOMES:
            raise ValueError(f"unknown outcome {outcome!r}")
        if self.is_terminal:
            raise RuntimeError(
                f"request {self.req_id} already terminal "
                f"({self.outcome}); double retirement is a scheduler bug")
        self.outcome = outcome
        self.shed_reason = shed_reason
        self.error = error
        self.terminal_t = time.monotonic()
        self._close_step(outcome=outcome)
        self.trace.finish(outcome, shed_reason=shed_reason, error=error,
                          steps_done=self.steps_done)
        self._stamp("terminal")

    # -- deadline arithmetic -------------------------------------------
    @property
    def is_terminal(self) -> bool:
        return self.outcome is not None

    def remaining_s(self, now: Optional[float] = None) -> Optional[float]:
        """Seconds until the deadline (negative = past it); None when
        the request has no deadline."""
        if self.deadline is None:
            return None
        return self.deadline - (time.monotonic() if now is None else now)

    def expired(self, grace_s: float = 0.0,
                now: Optional[float] = None) -> bool:
        r = self.remaining_s(now)
        return r is not None and r < -grace_s

    def __repr__(self):
        tail = self.outcome or self.state
        return (f"Request(#{self.req_id}, ctx={self.context_tokens}, "
                f"new={self.new_tokens}, steps={self.steps_done}, {tail})")


# process-wide live-gauge snapshot the engines publish into and the
# flight recorder dumps (tracer counters are monotonic;
# queue depth / slabs-in-use are levels, so they live here)
_GAUGE_LOCK = threading.Lock()
_GAUGES: Dict[str, float] = {}


def publish_gauges(**values: float) -> None:
    with _GAUGE_LOCK:
        _GAUGES.update(values)


def gauges() -> Dict[str, float]:
    with _GAUGE_LOCK:
        return dict(_GAUGES)


def reset_gauges() -> None:
    with _GAUGE_LOCK:
        _GAUGES.clear()
