"""Always-on flight recorder (tl-scope, part 2 of 4).

Post-mortems used to depend on having remembered to set
``TL_TPU_TRACE=1`` *before* the failure. The flight recorder removes
that dependency: a bounded ring of recent events and counter deltas is
recorded ALWAYS (default on; ``TL_TPU_FLIGHT=0`` off), cheaply enough
to run untraced — ``tracer.event()`` and ``tracer.inc()`` feed it
before their trace gate, so every instrumentation site already in the
codebase is captured with zero per-site changes. Spans additionally
land in the ring when tracing is on (untraced spans are no-ops by
design and stay that way).

On a failure worth a black box — a serving step failure (device loss,
watchdog timeout, a kernel fault) or an SLO breach —
``dump(reason, **attrs)`` writes a
timestamped post-mortem JSONL (ring contents + full counter snapshot +
live gauges) using the crash-safe cache's atomic tmp+rename discipline
and visiting the same ``cache.disk.write`` fault site, so chaos tests
can prove a torn dump is impossible. Write failures are non-fatal
(``flight.dump_errors`` counts them); dumps land in
``TL_TPU_FLIGHT_DIR`` (default ``<TL_TPU_TRACE_DIR>/flight``).

Layering: stdlib + ``env.py`` only (the tracer imports this module).
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from pathlib import Path
from typing import Any, Dict, List, Optional

from ..env import env

__all__ = ["FLIGHT_SCHEMA", "FlightRecorder", "get_flight", "enabled",
           "note_event", "note_counter", "note_span", "dump", "records",
           "reset"]

FLIGHT_SCHEMA = 1


def enabled() -> bool:
    """One env read — the gate every recording path checks."""
    return bool(env.TL_TPU_FLIGHT)


class FlightRecorder:
    """Bounded ring + atomic dumper. Thread-safe; ring capacity tracks
    ``TL_TPU_FLIGHT_RING`` live (tests shrink it mid-process)."""

    # per-reason dump ceiling per process: a flapping backend or a
    # sustained outage must not fill the disk with black boxes — the
    # first N per reason carry the post-mortem, the rest are counted
    MAX_DUMPS_PER_REASON = 64

    def __init__(self):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(8, env.TL_TPU_FLIGHT_RING))
        self._dump_seq = itertools.count(1)
        self._per_reason: Dict[str, int] = {}
        self.dumps = 0
        self.dump_errors = 0
        self.dumps_capped = 0

    # -- recording -----------------------------------------------------
    def _append(self, rec: dict) -> None:
        cap = max(8, env.TL_TPU_FLIGHT_RING)
        with self._lock:
            if self._ring.maxlen != cap:
                self._ring = deque(self._ring, maxlen=cap)
            self._ring.append(rec)

    def note_event(self, name: str, cat: str, attrs: dict) -> None:
        if not enabled():
            return
        self._append({"k": "event", "t": time.time(), "name": name,
                      "cat": cat, "attrs": attrs})

    def note_span(self, name: str, cat: str, dur_us: float,
                  attrs: dict) -> None:
        if not enabled():
            return
        self._append({"k": "span", "t": time.time(), "name": name,
                      "cat": cat, "dur_us": dur_us, "attrs": attrs})

    def note_counter(self, name: str, value: float, labels: dict) -> None:
        if not enabled():
            return
        rec: Dict[str, Any] = {"k": "counter", "t": time.time(),
                               "name": name, "inc": value}
        if labels:
            rec["labels"] = labels
        self._append(rec)

    # -- snapshots -----------------------------------------------------
    def records(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    # -- dumping -------------------------------------------------------

    def dump(self, reason: str, **attrs) -> Optional[Path]:
        """Atomically write the black box: a versioned header line,
        the ring contents, every counter, and the live serving gauges.
        Returns the written path, or None (disabled / write failure —
        a dying process must never die harder because its black box
        could not be written)."""
        if not enabled():
            return None
        with self._lock:
            n = self._per_reason.get(reason, 0)
            if n >= self.MAX_DUMPS_PER_REASON:
                self.dumps_capped += 1
                return None
            self._per_reason[reason] = n + 1
        seq = next(self._dump_seq)
        lines = [json.dumps({
            "type": "flight", "schema": FLIGHT_SCHEMA, "reason": reason,
            "seq": seq, "ts": time.time(), "pid": os.getpid(),
            "attrs": _json_safe(attrs),
        })]
        lines += [json.dumps({"type": "flight_record", **_json_safe(r)})
                  for r in self.records()]
        lines += self._state_lines()
        name = f"flight_{seq:03d}_{_slug(reason)}_{int(time.time())}.jsonl"
        try:
            # the crash-safe cache's commit discipline, same fault site:
            # an injected cache.disk.write fault proves a torn dump is
            # impossible (tmp+rename or nothing)
            from ..resilience import faults as _faults
            _faults.maybe_fail("cache.disk.write", key=f"flight:{reason}")
            d = env.flight_dir()
            d.mkdir(parents=True, exist_ok=True)
            path = d / name
            from ..cache.kernel_cache import atomic_write
            atomic_write(path, "\n".join(lines) + "\n")
        except Exception:  # noqa: BLE001 — non-fatal by contract
            self.dump_errors += 1
            return None
        self.dumps += 1
        return path

    def _state_lines(self) -> List[str]:
        out: List[str] = []
        try:
            from .tracer import get_tracer
            for cname, cval in sorted(get_tracer().counters().items()):
                out.append(json.dumps({"type": "counter", "name": cname,
                                       "value": cval}))
        except Exception:  # noqa: BLE001 — partial black box beats none
            pass
        try:
            from ..serving.request import gauges
            out.append(json.dumps({"type": "gauges",
                                   "values": _json_safe(gauges())}))
        except Exception:  # noqa: BLE001
            pass
        try:
            from .slo import get_slo
            out.append(json.dumps({"type": "slo",
                                   **_json_safe(get_slo().summary())}))
        except Exception:  # noqa: BLE001
            pass
        return out

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._per_reason.clear()
        self.dumps = 0
        self.dump_errors = 0
        self.dumps_capped = 0


def _slug(s: str) -> str:
    return "".join(c if c.isalnum() or c in "-_" else "_" for c in s)[:48]


def _json_safe(obj):
    if isinstance(obj, dict):
        return {str(k): _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, (str, int, bool)) or obj is None:
        return obj
    if isinstance(obj, float):
        return obj if obj == obj and obj not in (float("inf"),
                                                 float("-inf")) else repr(obj)
    return repr(obj)


_FLIGHT = FlightRecorder()


def get_flight() -> FlightRecorder:
    return _FLIGHT


# module-level conveniences bound to the process recorder
def note_event(name: str, cat: str, attrs: dict) -> None:
    _FLIGHT.note_event(name, cat, attrs)


def note_counter(name: str, value: float, labels: dict) -> None:
    _FLIGHT.note_counter(name, value, labels)


def note_span(name: str, cat: str, dur_us: float, attrs: dict) -> None:
    _FLIGHT.note_span(name, cat, dur_us, attrs)


def dump(reason: str, **attrs) -> Optional[Path]:
    return _FLIGHT.dump(reason, **attrs)


def records() -> List[dict]:
    return _FLIGHT.records()


def reset() -> None:
    _FLIGHT.reset()
