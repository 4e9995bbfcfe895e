"""Histogram metric type: log-spaced latency distributions.

The runtime half of the observability subsystem. The tracer's
counters answer "how many"; histograms answer "how slow, and how wide is
the tail". One ``Histogram`` is a fixed set of log-spaced bucket
boundaries plus per-bucket counts, a running sum/count, and observed
min/max — enough to estimate p50/p90/p99 without storing samples, to
merge shards from concurrent recorders, and to render the classic
Prometheus ``_bucket``/``_sum``/``_count`` exposition series.

Import-cycle discipline matches ``tracer.py``: this module depends on
the stdlib only, so every layer can record into it.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["Histogram", "HistogramRegistry", "default_bounds",
           "get_registry", "observe", "get_histogram", "reset"]

# Default latency bounds in SECONDS: factor-2 log spacing from 1us to
# ~67s (27 finite buckets + overflow). Wide enough for a sub-ms kernel
# dispatch and a wedged multi-second compile alike; coarse enough that a
# registry of hundreds of kernels stays tiny.
_DEFAULT_LO = 1e-6
_DEFAULT_N = 27


def default_bounds() -> Tuple[float, ...]:
    return tuple(_DEFAULT_LO * (2.0 ** i) for i in range(_DEFAULT_N))


class Histogram:
    """Fixed-bucket histogram. ``counts[i]`` holds observations with
    ``value <= bounds[i]`` (Prometheus ``le`` semantics, non-cumulative
    storage); ``counts[-1]`` is the +Inf overflow bucket."""

    __slots__ = ("bounds", "counts", "count", "sum", "min", "max")

    def __init__(self, bounds: Optional[Iterable[float]] = None):
        self.bounds: Tuple[float, ...] = \
            tuple(sorted(bounds)) if bounds is not None else default_bounds()
        if not self.bounds:
            raise ValueError("histogram needs at least one finite bound")
        self.counts: List[int] = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    # -- recording -----------------------------------------------------------
    def observe(self, value: float) -> None:
        v = float(value)
        if not math.isfinite(v):
            return   # a NaN/inf timing is a broken measurement, not data
        self.counts[self._bucket_index(v)] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def _bucket_index(self, v: float) -> int:
        lo, hi = 0, len(self.bounds)
        while lo < hi:          # first bound >= v (bisect_left on <=)
            mid = (lo + hi) // 2
            if self.bounds[mid] < v:
                lo = mid + 1
            else:
                hi = mid
        return lo               # len(bounds) == overflow bucket

    # -- queries -------------------------------------------------------------
    def quantile(self, q: float) -> Optional[float]:
        """Estimated value at quantile ``q`` in [0, 1]: find the bucket
        holding the target rank, interpolate geometrically inside it
        (the honest interpolation for log-spaced bounds), and clamp to
        the observed min/max so estimates never leave the data range."""
        if self.count == 0:
            return None
        if q <= 0:
            return self.min
        if q >= 1:
            return self.max
        rank = q * self.count
        seen = 0.0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c >= rank:
                frac = (rank - seen) / c
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i] if i < len(self.bounds) else self.max
                est = self._interp(lo, hi, frac)
                return min(max(est, self.min), self.max)
            seen += c
        return self.max

    @staticmethod
    def _interp(lo: float, hi: float, frac: float) -> float:
        if lo <= 0.0 or hi <= lo:
            return lo + (hi - lo) * frac
        return lo * (hi / lo) ** frac

    @property
    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None

    # -- merge / serialization ----------------------------------------------
    def merge(self, other: "Histogram") -> "Histogram":
        """Fold ``other`` into self (same bounds required) — shards from
        parallel recorders or bench child processes combine losslessly."""
        if self.bounds != other.bounds:
            raise ValueError("cannot merge histograms with different "
                             f"bounds ({len(self.bounds)} vs "
                             f"{len(other.bounds)} buckets)")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        return self

    def minus(self, earlier: Optional["Histogram"]) -> "Histogram":
        """A new histogram holding only the observations recorded since
        ``earlier`` (an older snapshot of this same series; None means
        everything counts). The registry accumulates forever, so a
        measurement window over a shared histogram is a count delta —
        this is how ``Profiler.dispatch_overhead`` isolates its calls.
        min/max cannot be un-merged and carry over from self, which only
        widens the clamp range of quantile estimates."""
        if earlier is None:
            out = Histogram(self.bounds)
            out.merge(self)
            return out
        if self.bounds != earlier.bounds:
            raise ValueError("cannot diff histograms with different "
                             "bounds")
        out = Histogram(self.bounds)
        out.counts = [max(0, a - b)
                      for a, b in zip(self.counts, earlier.counts)]
        out.count = max(0, self.count - earlier.count)
        out.sum = max(0.0, self.sum - earlier.sum)
        out.min = self.min
        out.max = self.max
        return out

    def __repr__(self):
        if not self.count:
            return "Histogram(empty)"
        return (f"Histogram(n={self.count}, p50={self.quantile(0.5):.3e}, "
                f"p99={self.quantile(0.99):.3e}, max={self.max:.3e})")


LabelKey = Tuple[str, Tuple[Tuple[str, str], ...]]


class HistogramRegistry:
    """Process-wide named histograms, keyed like the tracer's counters:
    ``(name, sorted (label, value) pairs)``. Thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._hists: Dict[LabelKey, Histogram] = {}

    @staticmethod
    def _key(name: str, labels: dict) -> LabelKey:
        return (name, tuple(sorted((k, str(v)) for k, v in labels.items())))

    def observe(self, name: str, value: float, **labels) -> None:
        key = self._key(name, labels)
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = Histogram()
            h.observe(value)

    def get(self, name: str, **labels) -> Optional[Histogram]:
        with self._lock:
            return self._hists.get(self._key(name, labels))

    def reset(self) -> None:
        with self._lock:
            self._hists.clear()


_REGISTRY = HistogramRegistry()


def get_registry() -> HistogramRegistry:
    return _REGISTRY


def observe(name: str, value: float, **labels) -> None:
    _REGISTRY.observe(name, value, **labels)


def get_histogram(name: str, **labels) -> Optional[Histogram]:
    return _REGISTRY.get(name, **labels)


def reset() -> None:
    _REGISTRY.reset()
