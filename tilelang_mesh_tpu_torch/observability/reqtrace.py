"""Per-request causal tracing.

The tracer (``tracer.py``) sees the world per-span; serving sees it
per-*request*. This module owns the join: every ``Request`` gets a
``trace_id`` at submission and a :class:`RequestTrace` — an ordered
chain of spans (``submit -> admitted -> decode.step* -> terminal``)
whose parent links reconstruct the causal story of one request across
re-queues and retries. The chains are recorded ALWAYS (independent of
``TL_TPU_TRACE``): they are tiny, and ``complete`` audits one.

A contextvar carries the *active* trace context (``trace_id``,
``span_id``). ``tracer.py`` merges it into every span/event recorded
while a context is bound, so an event that fires inside ``bind(...)``
is tagged with ``trace_id``/``parent_span`` for free. The serving
engine binds its own engine-trace context around each batch step (the
step span carries ``links=[member trace ids]``).

Layering: this module depends only on the stdlib — the tracer imports
it.
"""

from __future__ import annotations

import contextvars
import itertools
import os
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

__all__ = ["RequestTrace", "TraceSpan", "new_trace_id", "start_trace",
           "bind", "current_attrs"]

_seq = itertools.count(1)
_proc_tag = os.urandom(4).hex()


def new_trace_id(prefix: str = "req") -> str:
    """Process-unique, collision-resistant across processes (bench
    children, chaos seeds) via a per-process random tag."""
    return f"{prefix}-{_proc_tag}-{next(_seq):06d}"


class TraceSpan:
    """One span of a request chain. ``parent`` is the span_id of the
    causally-preceding span (None only for the root)."""

    __slots__ = ("span_id", "name", "parent", "t0", "t1", "attrs")

    def __init__(self, span_id: int, name: str, parent: Optional[int],
                 attrs: dict):
        self.span_id = span_id
        self.name = name
        self.parent = parent
        self.t0 = time.monotonic()
        self.t1: Optional[float] = None
        self.attrs = attrs

    @property
    def open(self) -> bool:
        return self.t1 is None

class RequestTrace:
    """The causal chain of one request (or one engine — ``kind``
    distinguishes them; completeness audits only ``kind="request"``).

    Chain discipline: each new span's parent defaults to the chain
    tail, so the spans form one connected path by construction;
    ``finish()`` records the terminal outcome and force-closes anything
    still open, COUNTING the leak — a chain is *causally complete* only
    when it reached a terminal outcome with every span closed by its
    owner and every parent link resolving to an earlier span."""

    __slots__ = ("trace_id", "name", "kind", "attrs", "spans", "terminal",
                 "terminal_attrs", "max_spans", "dropped", "_tail",
                 "_open", "_leaked", "_sseq", "_lock")

    def __init__(self, name: str, kind: str = "request",
                 trace_id: Optional[str] = None, max_spans: int = 0,
                 **attrs):
        self.trace_id = trace_id or new_trace_id(
            "req" if kind == "request" else kind)
        self.name = name
        self.kind = kind
        self.attrs = attrs
        self.spans: List[TraceSpan] = []
        self.terminal: Optional[str] = None
        self.terminal_attrs: dict = {}
        # span-count bound for LONG-LIVED chains (the engine trace
        # records one batch span per step forever): 0 = unbounded (the
        # right default for request chains, which are short and evicted
        # wholesale by the registry). Oldest CLOSED spans evict first,
        # counted in ``dropped``; chain_ok treats an evicted parent as
        # resolved.
        self.max_spans = max_spans
        self.dropped = 0
        self._tail: Optional[int] = None
        self._open: Dict[int, TraceSpan] = {}
        self._leaked = 0
        self._sseq = itertools.count(1)
        self._lock = threading.Lock()

    # -- recording -----------------------------------------------------
    def span(self, name: str, parent: Optional[int] = None,
             **attrs) -> int:
        """Open a span; returns its span_id (pass to ``close_span``).
        Parent defaults to the current chain tail."""
        with self._lock:
            sid = next(self._sseq)
            sp = TraceSpan(sid, name,
                           parent if parent is not None else self._tail,
                           attrs)
            self.spans.append(sp)
            self._open[sid] = sp
            self._tail = sid
            if self.max_spans:
                while len(self.spans) > self.max_spans \
                        and not self.spans[0].open:
                    self.spans.pop(0)
                    self.dropped += 1
            return sid

    def close_span(self, span_id: int, **attrs) -> None:
        with self._lock:
            sp = self._open.pop(span_id, None)
            if sp is None:
                return      # double close: idempotent, never a crash
            sp.t1 = time.monotonic()
            if attrs:
                sp.attrs.update(attrs)

    def mark(self, name: str, **attrs) -> int:
        """An instant annotation: a zero-duration span in the chain
        (``requeue``, ``retry``, ``reshard``, ``admitted``)."""
        sid = self.span(name, **attrs)
        self.close_span(sid)
        return sid

    def finish(self, outcome: str, **attrs) -> None:
        """Terminal transition: the chain ends here. Spans the owner
        forgot to close are force-closed and counted as leaks (they
        fail the causal-completeness audit)."""
        with self._lock:
            if self.terminal is not None:
                return      # idempotent: double retirement is the
            # engine's bug to raise, not the trace's
            self.terminal = outcome
            self.terminal_attrs = attrs
            for sp in list(self._open.values()):
                sp.t1 = time.monotonic()
                sp.attrs["leaked"] = True
                self._leaked += 1
            self._open.clear()

    # -- audits --------------------------------------------------------
    @property
    def complete(self) -> bool:
        """Causally complete: terminal reached, every span closed by
        its owner (no leaks), and every parent link resolves to an
        earlier span of this chain."""
        return (self.terminal is not None and self._leaked == 0
                and not self._open and self.chain_ok())

    def chain_ok(self) -> bool:
        seen: set = set()
        min_retained = self.spans[0].span_id if self.spans else 1
        for sp in self.spans:
            if sp.parent is not None and sp.parent not in seen \
                    and sp.parent >= min_retained:
                return False    # forged parent; an evicted one resolves
            seen.add(sp.span_id)
        return True


def start_trace(name: str, kind: str = "request", max_spans: int = 0,
                **attrs) -> RequestTrace:
    """Create a trace. The JAX package also keeps a bounded registry of
    traces for its exporters; the port has no exporter yet, so the
    owner (a request, the engine) holds its trace alone."""
    return RequestTrace(name, kind=kind, max_spans=max_spans, **attrs)


# -- contextvar propagation ------------------------------------------------

_CTX: "contextvars.ContextVar[Optional[Tuple[str, Optional[int]]]]" = \
    contextvars.ContextVar("tl_tpu_trace_ctx", default=None)


@contextmanager
def bind(trace_id: str, span_id: Optional[int] = None):
    """Make (trace_id, span_id) the active trace context: every tracer
    span/event recorded inside is tagged ``trace_id``/``parent_span``."""
    token = _CTX.set((trace_id, span_id))
    try:
        yield
    finally:
        _CTX.reset(token)


def current_attrs() -> dict:
    """The tag dict the tracer merges into spans/events recorded under
    an active context ({} when none is bound — the common case)."""
    ctx = _CTX.get()
    if ctx is None:
        return {}
    tid, sid = ctx
    return {"trace_id": tid} if sid is None else \
        {"trace_id": tid, "parent_span": sid}
