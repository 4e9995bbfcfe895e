"""Admission control + load shedding for the serving engine.

Reject-at-admit is the cheapest place to protect the system: a request
that cannot possibly be served (dead backend chain, full queue, no KV
capacity, infeasible deadline) is shed with a named reason BEFORE it
holds any resource. Decisions are wired to the machinery that already
exists instead of new heuristics:

- **circuit breaker** — the engine feeds every deterministic step
  failure into ``global_breaker()`` under the rolled-up signature
  ``serve.step`` (alongside the per-error signature the rest of the
  stack uses); once that circuit opens, admission sheds new arrivals
  until the operator resets it (``breaker_open``).
- **queue depth** — bounded by ``TL_TPU_SERVE_MAX_QUEUE``
  (``queue_full``).
- **p99 pressure** — the ``kernel.latency`` histograms: the
  engine records every batch step under ``kernel=serve.step,
  source=serving``; when the observed p99 exceeds
  ``TL_TPU_SERVE_P99_BUDGET_MS`` (opt-in), new arrivals shed
  (``overload``).
- **KV capacity** — the slab freelist must cover the request's
  worst-case page footprint (``kv_exhausted``).
- **deadline feasibility** — a request whose deadline cannot be met
  even at the observed p50 step latency (queue wait included) is shed
  immediately (``deadline_infeasible``) instead of burning a slot and
  expiring later.
- **drain mode** — a draining engine finishes in-flight work and sheds
  every new arrival (``draining``).
- **tenant share** — opt-in fairness cap
  (``TL_TPU_SERVE_TENANT_MAX_SHARE`` < 1.0): a tenant already holding
  that fraction of the queue capacity sheds its new arrivals
  (``tenant_share``) so one hot tenant cannot crowd every slot.

``serve.admit`` is the fault site on this path: an injected fault is
accounted as ``admit_fault`` shedding, never an exception to the
caller — admission itself must not become a crash surface.
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..env import env
from ..observability import histogram as _hist
from ..resilience.retry import global_breaker

__all__ = ["AdmissionController", "SERVE_BREAKER_SIG", "STEP_HIST_KERNEL"]

# the rolled-up breaker signature serving feeds and checks (per-error
# signatures additionally flow through error_signature() as everywhere)
SERVE_BREAKER_SIG = "serve.step"

# the kernel.latency label serving's batch steps record under — the
# histogram admission reads its p50/p99 from
STEP_HIST_KERNEL = "serve.step"


def step_histogram() -> Optional["_hist.Histogram"]:
    return _hist.get_histogram("kernel.latency", kernel=STEP_HIST_KERNEL,
                               source="serving")


def observed_step_ms(q: float, default_ms: float = 0.0) -> float:
    """Quantile ``q`` of the recorded serve.step latency, in ms
    (``default_ms`` until anything was recorded — warm-up records one
    dispatch per bucket, so a warmed engine always has an estimate)."""
    h = step_histogram()
    if h is None or h.count == 0:
        return default_ms
    v = h.quantile(q)
    return v * 1e3 if v is not None else default_ms


class AdmissionController:
    """Pure decision logic; the engine owns state transitions."""

    def __init__(self, *, max_queue: Optional[int] = None,
                 p99_budget_ms: Optional[float] = None,
                 grace_ms: Optional[float] = None):
        self.max_queue = (max_queue if max_queue is not None
                          else env.TL_TPU_SERVE_MAX_QUEUE)
        self.p99_budget_ms = (p99_budget_ms if p99_budget_ms is not None
                              else env.TL_TPU_SERVE_P99_BUDGET_MS)
        self.grace_ms = (grace_ms if grace_ms is not None
                         else env.TL_TPU_SERVE_GRACE_MS)
        self.tenant_max_share = env.TL_TPU_SERVE_TENANT_MAX_SHARE

    def decide(self, *, draining: bool, queue_depth: int,
               free_pages: int, pages_needed: int,
               remaining_s: Optional[float],
               steps_requested: int,
               prefill_chunks: int = 0,
               tenant_inflight: int = 0) -> Tuple[bool, Optional[str]]:
        """(admit?, shed reason). Ordered so the cheapest checks run
        first and the reason names the FIRST gate that failed.
        ``tenant_inflight`` is how many queued requests the arriving
        request's tenant already holds."""
        if draining:
            return False, "draining"
        if queue_depth >= self.max_queue:
            return False, "queue_full"
        if self.tenant_max_share < 1.0 and \
                tenant_inflight >= self.tenant_max_share * self.max_queue:
            return False, "tenant_share"
        if global_breaker().is_open(SERVE_BREAKER_SIG):
            return False, "breaker_open"
        if free_pages < pages_needed:
            return False, "kv_exhausted"
        if self.p99_budget_ms > 0:
            p99 = observed_step_ms(0.99)
            if p99 > self.p99_budget_ms:
                return False, "overload"
        if env.TL_TPU_SLO_ADMIT and self._slo_burning():
            return False, "overload"
        if remaining_s is not None:
            # feasibility at the OBSERVED p50: the queue ahead (in
            # batches, optimistically one step each) plus this
            # request's own steps AND its worst-case prefill chunk
            # units (deadline propagation into the chunked-prefill
            # path — a prompt too long for its deadline sheds at the
            # door instead of expiring mid-prefill) must fit in
            # deadline + grace
            p50_s = observed_step_ms(0.50) / 1e3
            need_s = p50_s * (queue_depth + steps_requested
                              + max(0, prefill_chunks - 1))
            if remaining_s + self.grace_ms / 1e3 < need_s or \
                    remaining_s <= 0:
                return False, "deadline_infeasible"
        return True, None

    @staticmethod
    def _slo_burning() -> bool:
        """Opt-in (``TL_TPU_SLO_ADMIT=1``) windowed overload gate: shed
        while the SLO engine's fast-burn window spends error budget
        faster than ``TL_TPU_SLO_BURN_MAX`` — the multi-window sibling
        of the lifetime-p99 gate above (docs/observability.md)."""
        try:
            from ..observability.slo import get_slo
            burn = get_slo().fast_burn_rate()   # cached per SLO tick
            return burn is not None and burn > env.TL_TPU_SLO_BURN_MAX
        except Exception:  # noqa: BLE001 — a broken SLO gate must
            return False   # never shed (fail open, like admit_fault)
