"""Span/event recorder: the core of the observability subsystem.

Every layer of the serving path records *spans* (named, nested,
monotonic-clocked intervals), *events* (instant markers: sheds, prefix
hits, dispatches) and *counters* (monotonic totals: admissions, KV
pages allocated). The recorder is deliberately import-cycle-free — its
only intra-package dependencies are ``env.py`` and its two stdlib-only
siblings — so every module of the package can use it.

Cost model:

- **Disabled** (default, ``TL_TPU_TRACE`` unset): ``span()`` returns a
  shared no-op context manager and ``event()`` returns immediately after
  one cached env check — no allocation, no lock, no clock read. The
  tier-1 acceptance bound is < 3% wall-time regression with tracing off.
- **Counters are always on** (cheap, and never inside a kernel launch),
  so an untraced run still reports its accounting.

Spans nest per-thread (a thread-local stack provides parent/depth), so
the engine's step-watchdog threads produce well-formed per-thread lanes
instead of interleaved garbage.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ..env import env
# both stdlib+env-only siblings, so importing them here preserves the
# no-layering-violations property: reqtrace supplies the active
# request-trace context merged into every recorded span/event, and
# flight captures events/counters into its always-on ring BEFORE the
# trace gate (the black box works untraced)
from . import flight as _flight
from . import reqtrace as _reqtrace

__all__ = ["Span", "Tracer", "get_tracer", "span", "event", "inc",
           "reset", "trace_enabled"]


def trace_enabled() -> bool:
    """One env read — the single gate every recording path checks."""
    return bool(env.TL_TPU_TRACE)


class _NullSpan:
    """Shared no-op returned when tracing is disabled: zero allocation
    per call site, ``set()`` accepted and dropped."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


_NULL_SPAN = _NullSpan()


class Span:
    """One live (then finished) interval. Use as a context manager via
    ``tracer.span(...)``; add attributes mid-flight with ``set()``."""

    __slots__ = ("tracer", "name", "cat", "attrs", "ts_ns", "dur_ns",
                 "tid", "depth", "epoch")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 attrs: Dict[str, Any]):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.attrs = attrs
        self.ts_ns = 0
        self.dur_ns = 0
        self.tid = 0
        self.depth = 0
        self.epoch = 0

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        t = self.tracer
        stack = t._stack()
        self.depth = len(stack)
        self.tid = threading.get_ident()
        self.epoch = t._epoch
        stack.append(self)
        # tl-scope: a span opened under a bound request-trace context
        # inherits trace_id/parent_span (explicit attrs win)
        ctx = _reqtrace.current_attrs()
        if ctx:
            for k, v in ctx.items():
                self.attrs.setdefault(k, v)
        self.ts_ns = time.monotonic_ns() - t._t0_ns
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.dur_ns = max(0, time.monotonic_ns() - self.tracer._t0_ns
                          - self.ts_ns)
        stack = self.tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        if exc_type is not None:
            # a failed run must be attributable to its span: record the
            # error on the span itself, then let it propagate
            self.attrs["error"] = f"{exc_type.__name__}: {exc_val}"
        _flight.note_span(self.name, self.cat, self.dur_ns / 1e3,
                          self.attrs)
        self.tracer._record({
            "type": "span", "name": self.name, "cat": self.cat,
            "ts_us": self.ts_ns / 1e3, "dur_us": self.dur_ns / 1e3,
            "tid": self.tid, "depth": self.depth, "attrs": self.attrs,
        }, epoch=self.epoch)
        return False


class Tracer:
    """Process-wide recorder: bounded event list + counter map.

    Thread-safe: events append under a lock; the live-span stack is
    thread-local. The event list is bounded by ``TL_TPU_TRACE_MAX_EVENTS``
    — overflow evicts the OLDEST record (ring semantics: a long traced
    serving soak keeps its most recent history, which is the half a
    post-mortem wants) and counts each eviction in the
    ``trace.dropped`` counter instead of growing without bound.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._events: deque = deque()
        self._counters: Dict[Tuple[str, Tuple[Tuple[str, str], ...]],
                             float] = {}
        self._tls = threading.local()
        self._t0_ns = time.monotonic_ns()
        # bumped by reset(): a span that straddles a reset (e.g. on an
        # abandoned watchdog thread) carries the OLD epoch and is
        # dropped on record instead of landing, with a clock origin it
        # predates, in the next consumer's event list
        self._epoch = 0

    # -- recording -----------------------------------------------------------
    def _stack(self) -> list:
        s = getattr(self._tls, "stack", None)
        if s is None:
            s = self._tls.stack = []
        return s

    def _record(self, ev: dict, epoch: Optional[int] = None) -> None:
        cap = max(1, env.TL_TPU_TRACE_MAX_EVENTS)
        with self._lock:
            if epoch is not None and epoch != self._epoch:
                return   # span from before a reset(): stale, drop
            self._events.append(ev)
            while len(self._events) > cap:
                self._events.popleft()     # oldest-first eviction
                self.inc("trace.dropped", _locked=True)

    def span(self, name: str, cat: str = "compile", **attrs):
        """A nested timed interval; no-op (shared instance) when tracing
        is disabled."""
        if not trace_enabled():
            return _NULL_SPAN
        return Span(self, name, cat, attrs)

    def event(self, name: str, cat: str = "compile", **attrs) -> None:
        """An instant marker (Chrome-trace 'i' phase); dropped from the
        TRACE when tracing is disabled — but always offered to the
        flight recorder's ring first, so the black box captures the
        same instrumentation sites untraced."""
        ctx = _reqtrace.current_attrs()
        if ctx:
            for k, v in ctx.items():
                attrs.setdefault(k, v)
        _flight.note_event(name, cat, attrs)
        if not trace_enabled():
            return
        self._record({
            "type": "event", "name": name, "cat": cat,
            "ts_us": (time.monotonic_ns() - self._t0_ns) / 1e3,
            "tid": threading.get_ident(), "attrs": attrs,
        })

    def inc(self, name: str, value: float = 1, _locked: bool = False,
            **labels) -> None:
        """Increment a monotonic counter. ALWAYS on (cheap, never in a
        kernel-call hot path) so hit rates survive untraced runs."""
        key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
        if _locked:     # already under self._lock (overflow accounting)
            self._counters[key] = self._counters.get(key, 0) + value
            return
        _flight.note_counter(name, value, labels)   # always-on delta ring
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + value

    # -- snapshots -----------------------------------------------------------
    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def counters(self) -> Dict[str, float]:
        """Flat name -> value map; labelled counters render as
        ``name{k=v,...}``."""
        with self._lock:
            out: Dict[str, float] = {}
            for (name, labels), v in self._counters.items():
                if labels:
                    name = (name + "{"
                            + ",".join(f"{k}={val}" for k, val in labels)
                            + "}")
                out[name] = v
            return out

    def counters_raw(self) -> Dict[Tuple[str, Tuple[Tuple[str, str], ...]],
                                   float]:
        with self._lock:
            return dict(self._counters)

    def reset(self) -> None:
        """Drop every recorded event and counter (tests, bench children).
        Spans still open across the reset are invalidated: their epoch
        no longer matches, so their eventual close records nothing."""
        with self._lock:
            self._events.clear()
            self._counters.clear()
            self._epoch += 1
            self._t0_ns = time.monotonic_ns()


_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


# module-level conveniences bound to the process tracer -- the form the
# instrumentation sites use: ``from ..observability.tracer import span``
def span(name: str, cat: str = "compile", **attrs):
    return _TRACER.span(name, cat, **attrs)


def event(name: str, cat: str = "compile", **attrs) -> None:
    _TRACER.event(name, cat, **attrs)


def inc(name: str, value: float = 1, **labels) -> None:
    _TRACER.inc(name, value, **labels)


def reset() -> None:
    _TRACER.reset()
