"""Structured error taxonomy for the resilience subsystem.

Every fault the serving path can recover from is classified into one of
four kinds, and the retry machinery keys its decisions on that kind:

- ``transient``     — worth retrying (flaky I/O, injected chaos, resource
                      pressure that clears).
- ``timeout``       — the operation wedged past its wall-clock budget.
- ``deterministic`` — retrying cannot help (type errors, a kernel launch
                      the card refuses for its configuration). Never
                      retried; repeated occurrences of one signature trip
                      the circuit breaker.
- ``device_loss``   — the device under the operation failed (an illegal
                      address or launch failure inside a CUDA kernel, a
                      lost card). The serving engine retries the batch
                      within its retry budget and then retires it; the
                      port has no second backend to fail over to.

``TLError`` subclasses carry ``site`` (the fault-site name, e.g.
``serve.step``) and ``phase`` so a failure deep in a worker thread is
still attributable in logs and traces. Foreign exceptions are mapped by
``classify()``.
"""

from __future__ import annotations

import concurrent.futures
from typing import Optional

__all__ = [
    "TLError", "TransientError", "DeterministicError", "TLTimeoutError",
    "DeviceLossError", "InjectedFault", "KernelLaunchError", "classify",
    "error_signature", "is_device_loss",
]


class TLError(Exception):
    """Base of the structured error hierarchy. Carries enough context
    (kind / site / phase) that the retry machinery and the tracer never
    have to parse messages."""

    kind = "deterministic"

    def __init__(self, message: str, *, site: Optional[str] = None,
                 phase: Optional[str] = None):
        super().__init__(message)
        self.site = site
        self.phase = phase

    def __str__(self):
        base = super().__str__()
        ctx = ", ".join(f"{k}={v}" for k, v in
                        (("site", self.site), ("phase", self.phase)) if v)
        return f"{base} [{ctx}]" if ctx else base


class TransientError(TLError):
    """A failure that is expected to clear on retry."""
    kind = "transient"


class DeterministicError(TLError):
    """A failure retrying cannot fix; trips the circuit breaker."""
    kind = "deterministic"


class DeviceLossError(TLError):
    """The device died under the operation."""
    kind = "device_loss"


class TLTimeoutError(TLError, concurrent.futures.TimeoutError):
    """An operation exceeded its wall-clock budget. Also a
    ``concurrent.futures.TimeoutError`` so generic callers keep catching
    it."""
    kind = "timeout"


# cudaError_t codes a launch returns when the card refuses the launch
# configuration itself: the same launch fails again, so they are
# deterministic. Every other non-zero code (illegal address, launch
# failure, a lost device) is classified device_loss.
_CUDA_CONFIG_ERRORS = {
    1: "cudaErrorInvalidValue",
    7: "cudaErrorLaunchOutOfResources",
    9: "cudaErrorInvalidConfiguration",
    98: "cudaErrorInvalidDeviceFunction",
    209: "cudaErrorNoKernelImageForDevice",
}


class KernelLaunchError(TLError):
    """A hand-written CUDA kernel's launch returned a non-zero
    ``cudaError_t``. ``kind`` follows the code: a refused configuration
    is deterministic, a fault on the device is device_loss."""

    def __init__(self, kernel: str, code: int, *,
                 site: Optional[str] = None):
        name = _CUDA_CONFIG_ERRORS.get(code, "cudaError")
        super().__init__(f"CUDA kernel {kernel} failed: {name} ({code})",
                         site=site)
        self.code = int(code)
        self.kind = ("deterministic" if code in _CUDA_CONFIG_ERRORS
                     else "device_loss")


class InjectedFault(TransientError):
    """Raised by the fault-injection registry. Subtyped per spec ``kind``
    via ``as_kind()`` so injected faults flow through the exact same
    classification path as organic ones."""

    @staticmethod
    def as_kind(kind: str, site: str) -> TLError:
        msg = f"injected fault at {site}"
        if kind == "timeout":
            return TLTimeoutError(msg, site=site)
        if kind == "deterministic":
            return DeterministicError(msg, site=site)
        if kind == "oserror":
            return _InjectedOSError(msg)
        if kind == "unreachable":
            return DeviceLossError(f"injected device loss at {site}",
                                   site=site)
        return InjectedFault(msg, site=site)


class _InjectedOSError(OSError):
    """An injected I/O failure — a plain OSError so the organic OSError
    handling is what gets exercised."""


# exception types that are transient regardless of message: I/O pressure
# and wedged-worker timeouts
_TRANSIENT_TYPES = (OSError, IOError, ConnectionError, MemoryError)
_TIMEOUT_TYPES = (concurrent.futures.TimeoutError, TimeoutError)

# message signatures of a failing device as PyTorch's CUDA runtime
# surfaces them (``torch.AcceleratorError`` / ``RuntimeError`` text).
# Matched case-insensitively on FOREIGN exceptions only (TLErrors
# self-classify). Deliberately narrow phrases: "CUDA out of memory" and
# shape/dtype errors are not device loss.
_DEVICE_LOSS_MARKERS = (
    "an illegal memory access was encountered",
    "illegal instruction was encountered",
    "unspecified launch failure",
    "misaligned address",
    "device-side assert triggered",
    "the launch timed out and was terminated",
    "uncorrectable ecc error",
    "cuda-capable device(s) is/are busy or unavailable",
    "device lost",
)


def is_device_loss(exc: BaseException) -> bool:
    """Does this exception look like the device itself failed (as
    opposed to the program on it being wrong)?"""
    if isinstance(exc, TLError):
        return exc.kind == "device_loss"
    msg = str(exc).lower()
    return any(m in msg for m in _DEVICE_LOSS_MARKERS)


def classify(exc: BaseException) -> str:
    """Map any exception to ``transient`` / ``timeout`` /
    ``deterministic`` / ``device_loss``. TLErrors self-classify; foreign
    exceptions fall back to message signatures (device loss) then
    type-based rules (I/O errors are transient, everything else —
    TypeError, ValueError — is deterministic)."""
    if isinstance(exc, TLError):
        return exc.kind
    if is_device_loss(exc):
        return "device_loss"
    if isinstance(exc, _TIMEOUT_TYPES):
        return "timeout"
    if isinstance(exc, _TRANSIENT_TYPES):
        return "transient"
    return "deterministic"


def error_signature(exc: BaseException, limit: int = 80) -> str:
    """A stable signature for circuit-breaker bucketing: exception type
    plus the head of its message."""
    return f"{type(exc).__name__}:{str(exc)[:limit]}"
