"""Per-failure-signature circuit breaker.

The serving engine feeds every deterministic step failure into the
process-wide breaker (``global_breaker()``) under the rolled-up
signature ``serve.step``; once that circuit opens, admission sheds new
arrivals (``breaker_open``) until the breaker is reset. The threshold
comes from ``TL_TPU_BREAKER_THRESHOLD``. Every trip emits
``resilience.breaker_open``. (The JAX package's ``retry_call`` backoff
loop has no caller in the port yet: the engine's retry budget is its
own.)
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, Optional

from ..env import env
from ..observability import tracer as _trace

__all__ = ["CircuitBreaker", "global_breaker"]

logger = logging.getLogger("tilelang_mesh_tpu_torch.resilience")


class CircuitBreaker:
    """Per-failure-signature breaker. ``record_failure`` counts identical
    failures; at ``threshold`` the signature's circuit opens and
    ``is_open`` reports it until ``reset``. Thread-safe — the engine's
    step watchdog threads share one instance."""

    def __init__(self, threshold: Optional[int] = None):
        self.threshold = threshold if threshold is not None \
            else max(1, env.TL_TPU_BREAKER_THRESHOLD)
        self._lock = threading.Lock()
        self._failures: Dict[str, int] = {}

    def record_failure(self, signature: str) -> bool:
        """Count one failure; returns True the moment this signature's
        circuit opens (exactly once, so callers can log/trace the trip)."""
        with self._lock:
            n = self._failures.get(signature, 0) + 1
            self._failures[signature] = n
        if n == self.threshold:
            _trace.inc("resilience.breaker_open")
            _trace.event("resilience.breaker_open", "resilience",
                         signature=signature, failures=n)
            logger.warning("circuit breaker OPEN for %r after %d identical "
                           "failures", signature, n)
            return True
        return False

    def is_open(self, signature: str) -> bool:
        with self._lock:
            return self._failures.get(signature, 0) >= self.threshold

    def reset(self, signature: Optional[str] = None) -> None:
        with self._lock:
            if signature is None:
                self._failures.clear()
            else:
                self._failures.pop(signature, None)


_GLOBAL_BREAKER: Optional[CircuitBreaker] = None
_GLOBAL_LOCK = threading.Lock()


def global_breaker() -> CircuitBreaker:
    """The process-wide breaker shared by every serving engine, so
    repeated deterministic failures are recognized across call sites."""
    global _GLOBAL_BREAKER
    with _GLOBAL_LOCK:
        if _GLOBAL_BREAKER is None:
            _GLOBAL_BREAKER = CircuitBreaker()
        return _GLOBAL_BREAKER

