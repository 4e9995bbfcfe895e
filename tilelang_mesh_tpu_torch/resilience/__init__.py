"""Resilience subsystem: fault injection, the error taxonomy and the
circuit breaker (the port of ``tilelang_mesh_tpu.resilience``)."""

from .errors import (DeterministicError, DeviceLossError,  # noqa: F401
                     InjectedFault, KernelLaunchError, TLError,
                     TLTimeoutError, TransientError, classify,
                     error_signature, is_device_loss)
from .faults import (FAULT_SITES, FaultSpec, active_specs,  # noqa: F401
                     inject, maybe_fail, parse_fault_spec)
from .retry import CircuitBreaker, global_breaker  # noqa: F401

__all__ = [
    "TLError", "TransientError", "DeterministicError", "TLTimeoutError",
    "DeviceLossError", "InjectedFault", "KernelLaunchError", "classify",
    "error_signature", "is_device_loss",
    "FAULT_SITES", "FaultSpec", "maybe_fail", "inject", "parse_fault_spec",
    "active_specs",
    "CircuitBreaker", "global_breaker",
]
