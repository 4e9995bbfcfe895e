"""The port's headline GEMM comparison (tilelang_mesh_tpu_torch/bench.py)
on the CPU: the four configs at tiny sizes through ``run_config`` with
loose peaks, as tests/test_bench_configs.py runs bench.py's (the ops run
their plain versions; the numbers are host times and mean nothing), the
cross-check equal to bench.py's, the candidate sweep skipping only a
wrong or failing torch composition and raising a kernel's failure, and
the timing core on a clock the test controls."""

import math
import pathlib
import sys

import numpy as np
import pytest
import torch

from tilelang_mesh_tpu_torch import bench as port
from tilelang_mesh_tpu_torch.carver import H100_SXM

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

_PEAKS = {"bf16": 1e6, "f32": 5e5, "i8": 2e6, "hbm_gbs": 1e6}
_TARGET_S = 0.1
# the fields of bench.py's run_config record
_FIELDS = {"metric", "value", "unit", "vs_baseline", "latency_ms",
           "baseline_ms", "latency_p50_ms", "latency_p90_ms",
           "latency_p99_ms", "latency_mad_ms", "latency_samples", "reps",
           "baseline_mad_ms", "peak", "utilization", "config"}

_CONFIGS = {
    "gemm_quickstart": lambda: port.cfg_gemm(
        256, 256, 256, device="cpu", arch=H100_SXM, target_s=_TARGET_S),
    "gemm_large": lambda: port.cfg_gemm(
        512, 256, 256, device="cpu", arch=H100_SXM, target_s=_TARGET_S),
    "fp8_gemm": lambda: port.cfg_fp8_gemm(256, 256, 256, device="cpu",
                                          arch=H100_SXM,
                                          target_s=_TARGET_S),
    "w4a16_gemm": lambda: port.cfg_w4a16(256, 256, 256, gs=64, device="cpu",
                                         arch=H100_SXM, target_s=_TARGET_S),
}


@pytest.mark.parametrize("name", sorted(_CONFIGS))
def test_config_runs_on_cpu(name):
    rec = port.run_config(name, _CONFIGS[name], _PEAKS, rounds=1,
                          target_s=_TARGET_S)
    assert _FIELDS <= set(rec)
    assert rec["config"] == name and rec["unit"] == "TFLOPS"
    assert rec["device"] == "cpu"
    assert rec["latency_ms"] > 0 and rec["baseline_ms"] > 0
    assert rec["vs_baseline"] > 0 and rec["reps"] > 0


def test_config_names_and_headline_are_bench_py_s():
    import bench as ref
    names = [n for n, _ in port._config_builders(True)]
    assert names == ["gemm_quickstart", "gemm_large", "fp8_gemm",
                     "w4a16_gemm"]
    assert set(names) <= {n for n, _ in ref._config_builders(True)}
    recs = [{"config": n, "vs_baseline": v}
            for n, v in zip(names, (0.5, 2.0, 1.25, 0.8))]
    head = port.headline(recs)
    assert head["config"] == "gemm_large"
    geo = math.exp(sum(math.log(r["vs_baseline"]) for r in recs) / 4)
    assert head["geomean_vs_baseline"] == round(geo, 4)


@pytest.mark.parametrize("case", ["equal", "close", "far", "nan", "zero"])
def test_check_close_matches_bench_py(case):
    import bench as ref
    rng = np.random.default_rng(4)
    want = rng.standard_normal((32, 16)).astype(np.float32)
    got = {"equal": want, "close": want * (1 + 1e-3),
           "far": want + 1.0, "nan": np.where(want > 1, np.nan, want),
           "zero": np.zeros_like(want)}[case]
    if case == "zero":
        want = np.zeros_like(want)

    def outcome(mod, ours, ref_):
        try:
            mod._check_close(ours, ref_, 1e-2)
            return None
        except mod.BenchError as e:
            return str(e)
    assert outcome(port, torch.from_numpy(got), torch.from_numpy(want)) \
        == outcome(ref, got, want)


def test_pick_best_skips_wrong_and_failing_candidates(capsys):
    """Only the candidates named optional (torch compositions) are
    skipped when wrong or failing; a kernel's wrong result or failure
    is raised, never left to the next candidate."""
    a = torch.randn(64, 64)
    want = a @ a

    def check(out):
        port._check_close(out, want, 1e-3)

    def boom():
        raise ValueError("does not build")
    wrong = ("wrong", lambda: (lambda x: x @ x + 1), (a,))
    broken = ("broken", boom, (a,))
    right = ("right", lambda: (lambda x: x @ x), (a,))
    name, fn, args = port._pick_best(
        [wrong, broken, right], check, "sweep", target_s=0.02,
        optional={"wrong", "broken"})
    assert name == "right" and args == (a,)
    err = capsys.readouterr().err
    assert "# sweep 'wrong' failed: numeric mismatch" in err
    assert "# sweep 'broken' failed: does not build" in err
    with pytest.raises(port.BenchError, match="numeric mismatch"):
        port._pick_best([wrong, right], check, "sweep", target_s=0.02)
    with pytest.raises(ValueError, match="does not build"):
        port._pick_best([broken, right], check, "sweep", target_s=0.02,
                        optional={"wrong"})
    assert capsys.readouterr().err == ""
    with pytest.raises(port.BenchError, match="no sweep candidate ran"):
        port._pick_best([broken], check, "sweep", optional={"broken"})


@pytest.mark.parametrize("config", ["gemm", "fp8_gemm", "w4a16_gemm"])
def test_config_raises_when_a_yardstick_fails(monkeypatch, config):
    """A yardstick that disagrees fails its config: the w4a16 baseline
    does not fall back to the torch composition, and no other block of
    the sweep takes the failing one's place."""
    from tilelang_mesh_tpu_torch.ops import yardsticks as ys

    def off(*args, **kw):
        return plain(*args, **kw) + 1.0
    name = "hand_w4a16_plain" if config == "w4a16_gemm" \
        else "hand_matmul_plain"
    plain = getattr(ys, name)
    monkeypatch.setattr(ys, name, off)
    build = {"gemm": lambda: port.cfg_gemm(
                 256, 256, 256, device="cpu", arch=H100_SXM,
                 target_s=0.02),
             "fp8_gemm": lambda: port.cfg_fp8_gemm(
                 256, 256, 256, device="cpu", arch=H100_SXM,
                 target_s=0.02),
             "w4a16_gemm": lambda: port.cfg_w4a16(
                 256, 256, 256, gs=64, device="cpu", arch=H100_SXM,
                 target_s=0.02)}[config]
    with pytest.raises(port.BenchError, match="numeric mismatch"):
        build()


def test_pick_best_raises_a_device_fault():
    def lost():
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")
    with pytest.raises(RuntimeError, match="illegal memory access"):
        port._pick_best([("lost", lost, ())], None, "sweep")


class _Clock:
    """A runner whose n repetitions take fixed + n * per seconds."""
    calls = 1

    def __init__(self, fixed, per, first=0.0):
        self.fixed, self.per, self.first, self.seen = fixed, per, first, []

    def __call__(self, n):
        self.seen.append(n)
        t = self.fixed + n * self.per + (self.first if len(self.seen) == 1
                                         else 0.0)
        return t


def test_calibrate_and_slope_on_a_controlled_clock():
    run = _Clock(fixed=0.05, per=1e-3)
    n = port._calibrate(run, target_s=0.2)
    assert (n - 1) * 1e-3 >= 0.2 and n < port._MAX_REP
    assert run.seen[:3] == [1, 1, 1] and run.seen[3] == 8
    assert port._slope(run, n) == pytest.approx(1e-3)
    # a slow first call (warm-up) does not send the count to the cap
    slow = _Clock(fixed=0.0, per=1e-3, first=5.0)
    assert port._calibrate(slow, target_s=0.2) < 1000
    # a loop that never grows clamps at the floor
    flat = _Clock(fixed=0.01, per=0.0)
    assert port._slope(flat, 64) == port._SLOPE_FLOOR


def test_main_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.main(["--quick"])
