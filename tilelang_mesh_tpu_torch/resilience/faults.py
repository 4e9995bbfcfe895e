"""Deterministic fault injection.

The serving path's recovery code (retry, shedding, quarantine of corrupt
cache entries) is only trustworthy if it can be exercised on demand.
This module puts a named *fault site* at every place the path touches
something that can fail in production — disk, the KV allocator, the
batch step — and arms them from a spec string, so a chaos run is one env
var away:

    TL_TPU_FAULTS="serve.step:p=0.3:seed=7;serve.kv:p=0.1:kind=oserror"

Grammar (``;``-separated clauses, ``:``-separated fields)::

    site[:p=<float>][:seed=<int>][:kind=<kind>][:times=<int>]

- ``site``  — a fault-site name or fnmatch glob. Known sites:
  ``FAULT_SITES``.
- ``p``     — per-visit injection probability (default 1.0).
- ``seed``  — seeds the clause's private RNG, so a chaos run replays
  exactly (default 0). The RNG advances once per matching visit.
- ``kind``  — ``transient`` (default) / ``timeout`` / ``deterministic``
  / ``oserror`` / ``unreachable``, each raising the matching exception
  of the errors taxonomy (``unreachable`` raises
  :class:`~.errors.DeviceLossError`).
- ``times`` — inject at most N times, then the clause goes inert.

Tests use the ``inject(...)`` context manager instead of the env var.
Every injection emits a ``fault.injected`` tracer event and increments
the ``fault.injected{site=...}`` counter; with ``TL_TPU_FAULTS`` unset
and no active ``inject()`` scope, ``maybe_fail`` is a two-branch no-op.
"""

from __future__ import annotations

import contextlib
import fnmatch
import logging
import random
import threading
from typing import List, Optional, Tuple

from ..env import env
from ..observability import tracer as _trace
from .errors import InjectedFault

__all__ = ["FAULT_SITES", "FaultSpec", "maybe_fail", "inject",
           "parse_fault_spec", "active_specs"]

logger = logging.getLogger("tilelang_mesh_tpu_torch.resilience")

# every armable site of the port, in pipeline order
FAULT_SITES = (
    "cache.disk.read",
    "cache.disk.write",
    "serve.admit",
    "serve.step",
    "serve.kv",
)

_KINDS = ("transient", "timeout", "deterministic", "oserror", "unreachable")


class FaultSpec:
    """One armed clause: a site pattern plus its private, seeded RNG."""

    __slots__ = ("pattern", "p", "seed", "kind", "times", "_rng", "_fired")

    def __init__(self, pattern: str, p: float = 1.0, seed: int = 0,
                 kind: str = "transient", times: Optional[int] = None):
        if kind not in _KINDS:
            raise ValueError(
                f"TL_TPU_FAULTS: unknown kind {kind!r} (one of {_KINDS})")
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"TL_TPU_FAULTS: p={p} outside [0, 1]")
        self.pattern = pattern
        self.p = p
        self.seed = seed
        self.kind = kind
        self.times = times
        self._rng = random.Random(seed)
        self._fired = 0

    def matches(self, site: str) -> bool:
        return fnmatch.fnmatchcase(site, self.pattern)

    def should_fire(self) -> bool:
        """Advance the clause RNG once; decide. An exhausted ``times``
        budget is checked first, so the injection sequence depends only
        on the visit order."""
        if self.times is not None and self._fired >= self.times:
            return False
        if self._rng.random() >= self.p:
            return False
        self._fired += 1
        return True

    def __repr__(self):
        return (f"FaultSpec({self.pattern!r}, p={self.p}, seed={self.seed}, "
                f"kind={self.kind!r}, times={self.times})")


def parse_fault_spec(raw: str) -> List[FaultSpec]:
    """Parse a ``TL_TPU_FAULTS`` string into clauses. Raises ValueError
    on malformed input — a silently mis-parsed chaos spec would report a
    falsely green run."""
    specs: List[FaultSpec] = []
    for clause in raw.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        fields = clause.split(":")
        site = fields[0].strip()
        if not site:
            raise ValueError(f"TL_TPU_FAULTS: empty site in {clause!r}")
        kwargs: dict = {}
        for f in fields[1:]:
            if "=" not in f:
                raise ValueError(
                    f"TL_TPU_FAULTS: field {f!r} in {clause!r} is not "
                    f"key=value")
            k, v = (s.strip() for s in f.split("=", 1))
            if k == "kind":
                kwargs["kind"] = v
                continue
            if k not in ("p", "seed", "times"):
                raise ValueError(
                    f"TL_TPU_FAULTS: unknown field {k!r} in {clause!r} "
                    f"(p / seed / kind / times)")
            try:
                kwargs[k] = float(v) if k == "p" else int(v)
            except ValueError:
                raise ValueError(
                    f"TL_TPU_FAULTS: {k}={v!r} in {clause!r} is not a "
                    f"number") from None
        specs.append(FaultSpec(site, **kwargs))
    return specs


# parsed-spec cache keyed by the raw env string, so a monkeypatched env
# takes effect on the next visit while the steady state parses once.
# Clause RNG state lives in the cached FaultSpec objects: re-parsing on
# every call would reset the sequence and break determinism.
_env_lock = threading.Lock()
_env_cache: Tuple[Optional[str], List[FaultSpec]] = (None, [])

# programmatic injections (tests): a process-global stack so faults reach
# worker threads (the engine's step watchdog) too
_overrides: List[FaultSpec] = []


def _env_specs() -> List[FaultSpec]:
    global _env_cache
    raw = env.TL_TPU_FAULTS
    if not raw:
        return []
    with _env_lock:
        if _env_cache[0] != raw:
            _env_cache = (raw, parse_fault_spec(raw))
        return _env_cache[1]


def active_specs() -> List[FaultSpec]:
    """Every clause currently armed (env + inject() scopes)."""
    return _env_specs() + list(_overrides)


def maybe_fail(site: str, **ctx) -> None:
    """The hook each fault site calls. No-op unless a clause matches and
    its seeded coin lands; then records the injection and raises the
    clause's error kind."""
    if not _overrides and not env.TL_TPU_FAULTS:
        return
    for spec in active_specs():
        if not spec.matches(site) or not spec.should_fire():
            continue
        _trace.inc("fault.injected", site=site)
        _trace.event("fault.injected", "resilience", site=site,
                     kind=spec.kind, pattern=spec.pattern, **ctx)
        logger.debug("fault injected at %s (kind=%s, pattern=%s)",
                     site, spec.kind, spec.pattern)
        raise InjectedFault.as_kind(spec.kind, site)


@contextlib.contextmanager
def inject(site: str, p: float = 1.0, seed: int = 0,
           kind: str = "transient", times: Optional[int] = None):
    """Arm one clause for the duration of a ``with`` block (tests)::

        with inject("serve.step", p=0.5, seed=3, times=2):
            engine.run()

    Process-global (worker threads see it); yields the FaultSpec so the
    test can assert on ``spec._fired``.
    """
    spec = FaultSpec(site, p=p, seed=seed, kind=kind, times=times)
    _overrides.append(spec)
    try:
        yield spec
    finally:
        _overrides.remove(spec)
