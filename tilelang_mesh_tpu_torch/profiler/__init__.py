"""Latency measurement on the card.

Counterpart of ``tilelang_mesh_tpu/profiler/__init__.py`` (``_stats_ms``,
``do_bench_stats``, ``do_bench``). ``Timer`` is the port's one device
timer: ``bench.py``'s calibrated slopes and the ``"events"`` backend
below both read it. Two backends:

  backend="events" — ``rep`` calls captured once in a CUDA graph (after
                     one warm-up call); ``warmup`` replays, then each of
                     ``rounds`` replays between two CUDA events gives one
                     per-call sample (elapsed / rep). The counterpart of
                     the JAX package's in-graph ``"loop"`` backend: the
                     card's time for the calls, without the host's time
                     between the Python wrappers' launches. ``fn`` must
                     be capturable (no host sync, no host read-back).
  backend="wall"   — per-call host wall time, each call synchronised
                     (on a CUDA device) before the clock stops; runs on
                     CPU tensors as well.

``PerfReport`` and ``Profiler``, which read compiled DSL kernels, are
not ported yet.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Sequence

import numpy as np

__all__ = ["Timer", "do_bench", "do_bench_stats"]


def _stats_ms(samples_ms: Sequence[float], reps: int) -> Dict[str, float]:
    """Latency digest of per-iteration samples (ms): percentiles, MAD,
    and the rep counts perf-diff needs to judge noise."""
    s = np.asarray(sorted(samples_ms), np.float64)
    med = float(np.median(s))
    return {
        "p50_ms": med,
        "p90_ms": float(np.percentile(s, 90)),
        "p99_ms": float(np.percentile(s, 99)),
        "mean_ms": float(s.mean()),
        "min_ms": float(s[0]),
        "max_ms": float(s[-1]),
        "mad_ms": float(np.median(np.abs(s - med))),
        "samples": int(len(s)),
        "reps": int(reps),
    }


class Timer:
    """``t(n)``: seconds that n repetitions of ``calls`` calls of
    fn(*args) take. With ``cuda`` the calls are captured once in a CUDA
    graph (after one warm-up call off the capture) and a repetition is
    one replay, the n replays timed by two CUDA events; without, a
    repetition is ``calls`` calls on the host clock, after one warm-up
    call."""

    def __init__(self, fn: Callable, args: Sequence = (), calls: int = 1,
                 cuda: bool = False):
        self.fn, self.args, self.calls, self.cuda = fn, tuple(args), \
            int(calls), bool(cuda)
        if not self.cuda:
            fn(*self.args)                      # warm-up
            return
        import torch
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):           # warm-up off the capture
            fn(*self.args)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, capture_error_mode="relaxed"):
            for _ in range(self.calls):
                fn(*self.args)
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)

    def __call__(self, n: int) -> float:
        if not self.cuda:
            t0 = time.perf_counter()
            for _ in range(n * self.calls):
                self.fn(*self.args)
            return time.perf_counter() - t0
        self.start.record()
        for _ in range(n):
            self.graph.replay()
        self.end.record()
        self.end.synchronize()
        return self.start.elapsed_time(self.end) / 1e3


def _sync_all() -> None:
    import torch
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def do_bench_stats(fn: Callable, *args, warmup: int = 3, rep: int = 30,
                   backend: str = "events", rounds: int = 5
                   ) -> Dict[str, float]:
    """Latency distribution of fn(*args): p50/p90/p99/mean/min/max/MAD
    in ms plus sample/rep counts.

    backend="wall": each of ``rep`` per-call wall timings is a sample.
    backend="events": each of ``rounds`` event-timed replays of a graph
    of ``rep`` calls yields one per-call sample (elapsed / rep).
    """
    if backend == "wall":
        for _ in range(warmup):
            fn(*args)
        _sync_all()
        times = []
        for _ in range(rep):
            t0 = time.perf_counter()
            fn(*args)
            _sync_all()
            times.append((time.perf_counter() - t0) * 1e3)
        return _stats_ms(times, reps=rep)
    if backend != "events":
        raise ValueError(f"do_bench: backend {backend!r} (want 'events' "
                         f"or 'wall')")
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("do_bench: the events backend needs a CUDA "
                           "device; backend='wall' times the CPU")
    timer = Timer(fn, args, calls=rep, cuda=True)
    for _ in range(warmup):
        timer(1)
    samples = [timer(1) * 1e3 / rep for _ in range(max(1, rounds))]
    return _stats_ms(samples, reps=rep)


def do_bench(fn: Callable, *args, warmup: int = 3, rep: int = 30,
             backend: str = "events") -> float:
    """Median latency of fn(*args) in milliseconds (scalar form of
    ``do_bench_stats``; the events backend keeps the JAX package's
    best-of-3 rounds)."""
    if backend == "wall":
        return do_bench_stats(fn, *args, warmup=warmup, rep=rep,
                              backend="wall")["p50_ms"]
    stats = do_bench_stats(fn, *args, warmup=warmup, rep=rep,
                           backend=backend, rounds=3)
    return stats["min_ms"]
