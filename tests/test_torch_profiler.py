"""The port's profiler (tilelang_mesh_tpu_torch/profiler) against the
JAX package's: the same latency digest on the same samples (exact: the
same numpy expressions), and the wall-clock backend on CPU tensors. The
events backend needs a card; without one it raises instead of timing
the CPU."""

import numpy as np
import pytest
import torch

from tilelang_mesh_tpu import profiler as ref
from tilelang_mesh_tpu_torch import profiler as port


@pytest.mark.parametrize("n", [1, 2, 3, 10, 101])
def test_stats_ms_matches_jax(n):
    samples = list(np.random.default_rng(n).gamma(2.0, 0.3, n))
    assert port._stats_ms(samples, reps=7) == ref._stats_ms(samples, reps=7)


def test_do_bench_wall_on_cpu_tensors():
    a = torch.randn(64, 64)
    calls = []

    def fn(x):
        calls.append(1)
        return x @ x

    st = port.do_bench_stats(fn, a, warmup=2, rep=5, backend="wall")
    assert set(st) == set(ref._stats_ms([1.0], reps=1))
    assert st["samples"] == 5 and st["reps"] == 5 and len(calls) == 7
    assert 0 < st["min_ms"] <= st["p50_ms"] <= st["max_ms"]
    ms = port.do_bench(fn, a, warmup=1, rep=3, backend="wall")
    assert isinstance(ms, float) and ms > 0


def test_timer_counts_calls_on_the_host_clock():
    """Without a card the timer runs one warm-up call, then ``calls``
    calls a repetition."""
    calls = []
    t = port.Timer(lambda x: calls.append(x), (1,), calls=3)
    assert len(calls) == 1
    assert t(4) >= 0 and len(calls) == 1 + 12


def test_events_backend_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.do_bench(lambda: None)
    with pytest.raises(ValueError, match="backend"):
        port.do_bench_stats(lambda: None, backend="loop")
