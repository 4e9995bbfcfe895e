"""Observability: tracer spans/events/counters, latency histograms,
per-request causal traces, the flight recorder and the SLO engine (the
port of the stdlib-only half of ``tilelang_mesh_tpu.observability``)."""

from . import flight, histogram, reqtrace, slo, tracer  # noqa: F401

__all__ = ["flight", "histogram", "reqtrace", "slo", "tracer"]
