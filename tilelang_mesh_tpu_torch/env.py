"""Environment knobs of the PyTorch/CUDA port.

The names are the JAX package's (``TL_TPU_*``), so one deployment
environment means the same thing to both packages. Only the knobs the
port's modules read are declared here.
"""

from __future__ import annotations

import os
from pathlib import Path


class EnvVar:
    """Descriptor reading an environment variable with a default, read on
    every access so tests can monkeypatch ``os.environ``."""

    def __init__(self, key: str, default, cast=str):
        self.key = key
        self.default = default
        self.cast = cast

    def __get__(self, obj, objtype=None):
        raw = os.environ.get(self.key)
        if raw is None:
            return self.default
        if self.cast is bool:
            return raw.lower() in ("1", "true", "yes", "on")
        return self.cast(raw)

    def __set__(self, obj, value):
        os.environ[self.key] = str(value)


class Environment:
    # on-disk tiers (the prefix cache derives its root from this)
    TL_TPU_CACHE_DIR = EnvVar(
        "TL_TPU_CACHE_DIR", str(Path.home() / ".tilelang_mesh_tpu" / "cache"))
    # resilience: fault-spec string (resilience/faults.py grammar) and the
    # circuit-breaker threshold
    TL_TPU_FAULTS = EnvVar("TL_TPU_FAULTS", "")
    TL_TPU_BREAKER_THRESHOLD = EnvVar("TL_TPU_BREAKER_THRESHOLD", 3, int)
    # observability: tracing gate, bounded event ring, flight recorder
    TL_TPU_TRACE = EnvVar("TL_TPU_TRACE", False, bool)
    TL_TPU_TRACE_DIR = EnvVar(
        "TL_TPU_TRACE_DIR", str(Path.home() / ".tilelang_mesh_tpu" / "trace"))
    TL_TPU_TRACE_MAX_EVENTS = EnvVar("TL_TPU_TRACE_MAX_EVENTS", 100_000, int)
    TL_TPU_FLIGHT = EnvVar("TL_TPU_FLIGHT", True, bool)
    TL_TPU_FLIGHT_RING = EnvVar("TL_TPU_FLIGHT_RING", 2048, int)
    # where flight dumps land; empty derives <TL_TPU_TRACE_DIR>/flight
    TL_TPU_FLIGHT_DIR = EnvVar("TL_TPU_FLIGHT_DIR", "")
    # SLO engine: availability target, sliding windows (comma seconds,
    # shortest first = the fast-burn window), p99 budget (0 falls back to
    # TL_TPU_SERVE_P99_BUDGET_MS), opt-in burn-rate admission gate
    TL_TPU_SLO_TARGET = EnvVar("TL_TPU_SLO_TARGET", 0.999, float)
    TL_TPU_SLO_WINDOWS_S = EnvVar("TL_TPU_SLO_WINDOWS_S", "30,300")
    TL_TPU_SLO_P99_BUDGET_MS = EnvVar("TL_TPU_SLO_P99_BUDGET_MS",
                                      0.0, float)
    TL_TPU_SLO_ADMIT = EnvVar("TL_TPU_SLO_ADMIT", False, bool)
    TL_TPU_SLO_BURN_MAX = EnvVar("TL_TPU_SLO_BURN_MAX", 14.0, float)
    # serving engine: queue bound checked at admit
    TL_TPU_SERVE_MAX_QUEUE = EnvVar("TL_TPU_SERVE_MAX_QUEUE", 256, int)
    # batch-size ceiling (clamped to the workload's batch buckets)
    TL_TPU_SERVE_MAX_BATCH = EnvVar("TL_TPU_SERVE_MAX_BATCH", 8, int)
    # overload shedding: reject new admits while the observed serve.step
    # p99 exceeds this budget (0 = no p99-based shedding)
    TL_TPU_SERVE_P99_BUDGET_MS = EnvVar("TL_TPU_SERVE_P99_BUDGET_MS",
                                        0.0, float)
    # grace window past a request deadline before the scheduler expires it
    TL_TPU_SERVE_GRACE_MS = EnvVar("TL_TPU_SERVE_GRACE_MS", 50.0, float)
    # wall-clock bound on waiting for one batch step (0 = unbounded unless
    # the batch carries deadlines)
    TL_TPU_SERVE_STEP_TIMEOUT_MS = EnvVar("TL_TPU_SERVE_STEP_TIMEOUT_MS",
                                          0.0, float)
    # per-request retry ceiling for transient/timeout/device-loss failures
    TL_TPU_SERVE_RETRY_MAX = EnvVar("TL_TPU_SERVE_RETRY_MAX", 2, int)
    # chunked prefill: tokens per chunk, chunk units per engine step
    TL_TPU_SERVE_PREFILL_CHUNK = EnvVar("TL_TPU_SERVE_PREFILL_CHUNK",
                                        256, int)
    TL_TPU_SERVE_PREFILL_PER_STEP = EnvVar(
        "TL_TPU_SERVE_PREFILL_PER_STEP", 2, int)
    # content-addressed prefix KV cache: on/off, page budget, root
    # (empty derives <TL_TPU_CACHE_DIR>/prefix)
    TL_TPU_SERVE_PREFIX = EnvVar("TL_TPU_SERVE_PREFIX", True, bool)
    TL_TPU_SERVE_PREFIX_PAGES = EnvVar("TL_TPU_SERVE_PREFIX_PAGES",
                                       512, int)
    TL_TPU_SERVE_PREFIX_DIR = EnvVar("TL_TPU_SERVE_PREFIX_DIR", "")
    # stand-in sampler vocabulary: the decode output is projected onto
    # this many logits before temperature/top-p sampling
    TL_TPU_SERVE_VOCAB = EnvVar("TL_TPU_SERVE_VOCAB", 128, int)
    # the largest fraction of TL_TPU_SERVE_MAX_QUEUE one tenant may hold
    # before its new arrivals shed "tenant_share"; 1.0 (default) = off
    TL_TPU_SERVE_TENANT_MAX_SHARE = EnvVar(
        "TL_TPU_SERVE_TENANT_MAX_SHARE", 1.0, float)

    def flight_dir(self) -> Path:
        raw = self.TL_TPU_FLIGHT_DIR
        p = Path(raw) if raw else Path(self.TL_TPU_TRACE_DIR) / "flight"
        p.mkdir(parents=True, exist_ok=True)
        return p

    def prefix_cache_dir(self) -> Path:
        raw = self.TL_TPU_SERVE_PREFIX_DIR
        p = Path(raw) if raw else Path(self.TL_TPU_CACHE_DIR) / "prefix"
        p.mkdir(parents=True, exist_ok=True)
        return p


env = Environment()
