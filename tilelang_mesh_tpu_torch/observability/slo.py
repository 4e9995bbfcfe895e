"""Live SLO engine (tl-scope, part 3 of 4).

Computes serving SLO signals from the state the stack already records —
the ``serve.*`` tracer counters and the ``kernel.latency{kernel=
serve.step,source=serving}`` histogram — over *sliding windows* instead
of process lifetime:

- **availability**: the non-shed fraction of submissions inside the
  window (1 - shed/submitted);
- **p99 vs budget**: the step p99 of the window (histogram delta
  between the window edge's snapshot and now) against
  ``TL_TPU_SLO_P99_BUDGET_MS`` (falling back to
  ``TL_TPU_SERVE_P99_BUDGET_MS``);
- **error-budget burn rate**: (1 - availability) / (1 - target) per
  window — burn 1.0 spends the budget exactly at the target rate, the
  classic multi-window rule reads the shortest window as fast burn.

The engine is sample-based: ``tick()`` (called by the serving engine
once per batch step, throttled) appends one cheap snapshot — counter
totals plus a copy of the step histogram — and ``summary()`` diffs the
newest snapshot against each window's edge. A breach transition (burn
over ceiling or p99 over budget, where it was clean before) fires one
flight-recorder dump per episode.

Window math is pure over the sample ring, so tests drive ``add()``
with synthetic samples and assert exact numbers.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import List, Optional

from ..env import env
from . import histogram as _hist

__all__ = ["SLOEngine", "get_slo", "parse_windows",
           "reset"]


def parse_windows(spec: Optional[str] = None) -> List[float]:
    """``TL_TPU_SLO_WINDOWS_S`` -> sorted window lengths in seconds
    (shortest first = the fast-burn window). A typo raises — a silent
    default would hide a misconfigured SLO."""
    raw = spec if spec is not None else env.TL_TPU_SLO_WINDOWS_S
    try:
        out = sorted(float(w) for w in str(raw).split(",") if w.strip())
    except ValueError:
        raise ValueError(
            f"TL_TPU_SLO_WINDOWS_S must be a comma list of seconds, "
            f"got {raw!r}") from None
    if not out or any(w <= 0 for w in out):
        raise ValueError(
            f"TL_TPU_SLO_WINDOWS_S needs positive windows, got {raw!r}")
    return out


def _p99_budget_ms() -> float:
    b = env.TL_TPU_SLO_P99_BUDGET_MS
    return b if b > 0 else env.TL_TPU_SERVE_P99_BUDGET_MS


# hard bound on the sample ring (each sample carries a step-histogram
# snapshot): with the default 0.1s tick throttle this covers the 300s
# default long window with room to spare, and caps resident memory no
# matter how the knobs are set
_MAX_SAMPLES = 4096


class SLOEngine:
    """Sliding-window SLO computation over counter/histogram samples."""

    def __init__(self, windows: Optional[List[float]] = None,
                 target: Optional[float] = None):
        self.windows = windows if windows is not None else parse_windows()
        self.target = target if target is not None else env.TL_TPU_SLO_TARGET
        self._lock = threading.Lock()
        self._samples: deque = deque()
        self._last_tick = 0.0
        self._breached = False     # episode edge detector
        self.breaches = 0
        # fast-burn cache for the per-request admission consult: the
        # burn rate only changes when a tick lands, so admission must
        # never pay the O(ring) window scan per submitted request
        self._burn_cache: Optional[float] = None
        self._burn_cache_t = -1.0

    # -- sampling ------------------------------------------------------
    @staticmethod
    def sample_now(now: Optional[float] = None) -> dict:
        """One snapshot of the live serving totals (lazy imports keep
        this module importable from every layer)."""
        t = time.monotonic() if now is None else now
        submitted = shed = completed = failed = deadline = 0.0
        try:
            from .tracer import get_tracer
            from .export import shed_reason_from_counter
            counters = get_tracer().counters()
            for k, v in counters.items():
                if shed_reason_from_counter(k) is not None:
                    shed += v
            completed = counters.get("serve.completed", 0)
            failed = counters.get("serve.failed", 0)
            deadline = counters.get("serve.deadline_exceeded", 0)
            # submissions = every admission decision: admitted arrivals
            # plus admission-or-midflight sheds (a midflight shed counts
            # once in each total; the availability definition is the
            # non-shed fraction of DECISIONS, documented)
            submitted = counters.get("serve.admitted", 0) + shed
        except Exception:  # noqa: BLE001 — a torn snapshot beats a crash
            pass
        h = _hist.get_histogram("kernel.latency", kernel="serve.step",
                                source="serving")
        hist = None
        if h is not None and h.count:
            hist = _hist.Histogram(h.bounds)
            hist.merge(h)
        # full-lifecycle signals (docs/serving.md): TTFT histogram
        # snapshot + prefix-cache hit/miss totals, window-diffed like
        # the step histogram so /slo reports the LIVE hit rate and
        # first-token latency, not lifetime averages
        th = _hist.get_histogram("serve.ttft")
        ttft = None
        if th is not None and th.count:
            ttft = _hist.Histogram(th.bounds)
            ttft.merge(th)
        prefix_hits = prefix_misses = 0.0
        try:
            from .tracer import get_tracer
            counters = get_tracer().counters()
            prefix_hits = counters.get("prefix_cache.hit", 0)
            prefix_misses = counters.get("prefix_cache.miss", 0)
        except Exception:  # noqa: BLE001 — a torn snapshot beats a crash
            pass
        return {"t": t, "submitted": submitted, "shed": shed,
                "completed": completed, "failed": failed,
                "deadline_exceeded": deadline, "hist": hist,
                "ttft_hist": ttft, "prefix_hits": prefix_hits,
                "prefix_misses": prefix_misses}

    def add(self, sample: dict) -> None:
        """Append one sample (tests drive this directly with synthetic
        dicts); the ring is pruned past the longest window and hard-
        bounded by ``_MAX_SAMPLES``. Any add invalidates the admission
        burn cache."""
        horizon = max(self.windows) * 1.5
        with self._lock:
            self._samples.append(sample)
            t = sample["t"]
            while len(self._samples) > 1 and \
                    (t - self._samples[0]["t"] > horizon
                     or len(self._samples) > _MAX_SAMPLES):
                self._samples.popleft()
            self._burn_cache_t = -1.0

    def tick(self, now: Optional[float] = None,
             min_interval_s: float = 0.1) -> bool:
        """Sample the live state, throttled (the serving engine calls
        this every step; sub-interval calls are free no-ops)."""
        t = time.monotonic() if now is None else now
        if t - self._last_tick < min_interval_s:
            return False
        self._last_tick = t
        self.add(self.sample_now(t))
        return True

    def fast_burn_rate(self) -> Optional[float]:
        """The shortest window's burn rate, cached per ``add()`` — the
        per-request admission consult reads this instead of paying the
        window scan on every submission."""
        with self._lock:
            cached_t, cached = self._burn_cache_t, self._burn_cache
        if cached_t >= 0:
            return cached
        burn = self.window_stats(self.windows[0]).get("burn_rate")
        with self._lock:
            self._burn_cache = burn
            self._burn_cache_t = time.monotonic()
        return burn

    # -- window math ---------------------------------------------------
    def _edge(self, samples: List[dict], now: float,
              window: float) -> Optional[dict]:
        """The newest sample at or before the window's left edge (the
        delta baseline); None when the ring does not reach back that
        far, in which case the OLDEST sample is the honest baseline."""
        edge = None
        for s in samples:
            if s["t"] <= now - window:
                edge = s
            else:
                break
        return edge if edge is not None else \
            (samples[0] if samples else None)

    def window_stats(self, window: float,
                     now: Optional[float] = None) -> dict:
        with self._lock:
            samples = list(self._samples)
        if not samples:
            return {"window_s": window, "samples": 0}
        cur = samples[-1]
        t = cur["t"] if now is None else now
        if len(samples) < 2:
            # one sample is a point, not a window: its totals may carry
            # arbitrary pre-window history, so reporting them as the
            # window's traffic would be dishonest — say "no data" until
            # a second sample gives a real delta baseline
            return {"window_s": window, "samples": 1, "span_s": 0.0,
                    "submitted": 0.0, "shed": 0.0, "completed": 0.0,
                    "availability": None, "burn_rate": None,
                    "p99_ms": None,
                    "p99_budget_ms": _p99_budget_ms() or None,
                    "p99_over_budget": False,
                    "ttft_p99_ms": None, "prefix_hit_rate": None}
        base = self._edge(samples[:-1], t, window)
        d_sub = max(0.0, cur["submitted"] - base["submitted"])
        d_shed = max(0.0, cur["shed"] - base["shed"])
        availability = 1.0 - d_shed / d_sub if d_sub else None
        burn = None
        if availability is not None:
            burn = round((1.0 - availability)
                         / max(1e-9, 1.0 - self.target), 4)
        p99_ms = None
        cur_h, base_h = cur.get("hist"), base.get("hist")
        if cur_h is not None:
            wh = cur_h.minus(base_h) if base_h is not None else cur_h
            if wh.count:
                q = wh.quantile(0.99)
                p99_ms = round(q * 1e3, 4) if q is not None else None
        # windowed TTFT p99 (same snapshot-delta rule as the step p99)
        ttft_p99_ms = None
        cur_t, base_t = cur.get("ttft_hist"), base.get("ttft_hist")
        if cur_t is not None:
            wt = cur_t.minus(base_t) if base_t is not None else cur_t
            if wt.count:
                q = wt.quantile(0.99)
                ttft_p99_ms = round(q * 1e3, 4) if q is not None else None
        # windowed prefix-cache hit rate (None until a lookup landed)
        d_hit = max(0.0, cur.get("prefix_hits", 0.0)
                    - base.get("prefix_hits", 0.0))
        d_miss = max(0.0, cur.get("prefix_misses", 0.0)
                     - base.get("prefix_misses", 0.0))
        prefix_hit_rate = (round(d_hit / (d_hit + d_miss), 4)
                           if d_hit + d_miss else None)
        budget = _p99_budget_ms()
        return {
            "window_s": window,
            "samples": len(samples),
            "span_s": round(cur["t"] - base["t"], 3),
            "submitted": d_sub,
            "shed": d_shed,
            "completed": max(0.0, cur["completed"] - base["completed"]),
            "availability": (round(availability, 6)
                             if availability is not None else None),
            "burn_rate": burn,
            "p99_ms": p99_ms,
            "p99_budget_ms": budget or None,
            "p99_over_budget": (p99_ms is not None and budget > 0
                                and p99_ms > budget),
            "ttft_p99_ms": ttft_p99_ms,
            "prefix_hit_rate": prefix_hit_rate,
        }

    def summary(self, now: Optional[float] = None) -> dict:
        wins = {f"{w:g}s": self.window_stats(w, now)
                for w in self.windows}
        fast = wins[f"{self.windows[0]:g}s"]
        burn = fast.get("burn_rate")
        breach_reasons = []
        if burn is not None and burn > env.TL_TPU_SLO_BURN_MAX:
            breach_reasons.append(
                f"burn_rate {burn} > {env.TL_TPU_SLO_BURN_MAX:g} over "
                f"{self.windows[0]:g}s")
        if fast.get("p99_over_budget"):
            breach_reasons.append(
                f"p99 {fast['p99_ms']}ms > budget "
                f"{fast['p99_budget_ms']}ms over {self.windows[0]:g}s")
        return {
            "target": self.target,
            "windows": wins,
            "fast_burn_rate": burn,
            "breach": bool(breach_reasons),
            "breach_reasons": breach_reasons,
            "breaches_total": self.breaches,
        }

    def check_breach(self, now: Optional[float] = None) -> Optional[dict]:
        """Edge-triggered breach detection: returns the summary ONCE per
        breach episode (entering breach), None otherwise. The serving
        engine turns that into one flight-recorder dump per episode."""
        s = self.summary(now)
        if s["breach"] and not self._breached:
            self._breached = True
            self.breaches += 1
            s["breaches_total"] = self.breaches
            return s
        if not s["breach"]:
            self._breached = False
        return None

    def reset(self) -> None:
        with self._lock:
            self._samples.clear()
            self._burn_cache = None
            self._burn_cache_t = -1.0
        self._breached = False
        self._last_tick = 0.0
        self.breaches = 0


_SLO: Optional[SLOEngine] = None
_SLO_LOCK = threading.Lock()


def get_slo() -> SLOEngine:
    global _SLO
    with _SLO_LOCK:
        if _SLO is None:
            _SLO = SLOEngine()
        return _SLO


def reset() -> None:
    global _SLO
    with _SLO_LOCK:
        _SLO = None
