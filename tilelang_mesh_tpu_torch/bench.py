"""The headline GEMM comparison on the card: the library's GEMMs against
hand-written yardstick kernels, timed in interleaved A/B rounds.

    python -m tilelang_mesh_tpu_torch.bench [--quick] [--config NAME ...]

Counterpart of the GEMM part of ``bench.py``. Four configs:

* ``gemm_quickstart`` (1024^3) and ``gemm_large`` (8192 x 8192 x 4096;
  2048^3 with ``--quick``), bf16: ``ops/gemm.py``'s ``matmul_kernel``
  against the best of ``hand_matmul`` (``csrc/yardstick_gemm.cu``) over
  the carver's top two blocks;
* ``fp8_gemm`` (4096^3; 1024^3 quick): ``matmul_kernel`` in fp8 e4m3 ->
  f32 against the best of ``hand_matmul`` over the carver's top two
  blocks;
* ``w4a16_gemm`` (4096^3, group 512; 1024^3 quick): the better of
  ``dequant_matmul_twopass`` and the fused ``dequant_gemm_kernel``
  against the strongest of ``hand_w4a16`` (``csrc/yardstick_w4a16.cu``)
  at the carver's top two tiles and a plain torch unpack +
  ``torch.matmul``.

Prints one JSON line a config (``metric``, ``value`` TFLOP/s,
``vs_baseline`` = baseline ms / ours ms, ``latency_ms``,
``baseline_ms``, the p50/p90/p99/MAD digest, ``peak``, ``utilization``,
``device``), then the headline line (``gemm_large``'s record with
``geomean_vs_baseline`` over every config that ran). Exits 2 if a config
failed.

Method (the JAX package's): every candidate is checked against a float32
reference before it may be timed; a time is the slope of elapsed time
over the repetition count, T(hi) - T(lo) over hi - lo, with the count
calibrated until the loop takes ``target_s`` (the calibration's first
call is the warm-up); the two sides are sampled back to back in each
round and ``vs_baseline`` is the median of the rounds' ratios; a slope
at the clamp floor or a rate above the card's peak raises
``BenchError``. Times come from the profiler's ``Timer``: on the card a
repetition is one replay of a CUDA graph of ``_GRAPH_CALLS`` calls,
timed by CUDA events: the graph keeps the host's time between the Python
wrappers' launches out of the device time, which it would dominate at
1024^3. On CPU tensors (the tests) a repetition is one call on the host
clock. A kernel (the port's or a yardstick) that fails to build, launch
or check raises; only the torch composition among w4a16's baselines is
skipped when it fails.

Not ported: ``bench.py``'s child / probe / failover process machinery
(for a tunneled TPU worker), ``_attach_sol`` and
``_attach_observability``, and its other configs.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import sys
import time

import numpy as np
import torch

from .carver import MatmulTemplate, auto_arch
from .profiler import Timer, _stats_ms

__all__ = ["BenchError", "run_config", "cfg_gemm", "cfg_fp8_gemm",
           "cfg_w4a16", "main"]

_TARGET_LOOP_S = 0.6   # in-loop work per timed call; >> fixed-cost noise
_MAX_REP = 200_000
_SLOPE_FLOOR = 1e-9    # clamp floor: a slope here means the measurement broke
_GRAPH_CALLS = 10      # calls a CUDA graph replay runs


class BenchError(RuntimeError):
    pass


def _chip_peak_tflops(arch=None):
    """Dense peak TFLOP/s by class (+ HBM GB/s) of the card's model."""
    arch = arch or auto_arch()
    return {**arch.peak_tflops, "hbm_gbs": arch.hbm_gbps}


# ---------------------------------------------------------------------------
# timing core
# ---------------------------------------------------------------------------

def _on_cuda(args) -> bool:
    return any(isinstance(x, torch.Tensor) and x.is_cuda for x in args)


def _runner(fn, args):
    """The profiler's ``Timer`` for one candidate: on the card a
    repetition replays a CUDA graph of ``_GRAPH_CALLS`` calls; on CPU
    tensors it is one call on the host clock."""
    cuda = _on_cuda(args)
    return Timer(fn, args, calls=_GRAPH_CALLS if cuda else 1, cuda=cuda)


def _calibrate(run, target_s=_TARGET_LOOP_S):
    """Grow n until the loop accounts for ~target_s beyond the fixed
    per-call cost. The first call is the warm-up."""
    run(1)  # warm-up — NEVER skip
    t1 = min(run(1) for _ in range(2))
    n = 8
    while n < _MAX_REP:
        tn = run(n)
        if tn - t1 >= target_s:
            return n
        # a first call slower than n (host warm-up) would make the
        # fixed cost look negative: take the whole mean then
        dt = max((tn - t1) / (n - 1) if tn > t1 else tn / n, 1e-7)
        n = min(max(int(1.3 * target_s / dt), n * 4), _MAX_REP)
    return _MAX_REP


def _slope(run, rep_hi):
    """One per-call sample: (T(hi) - T(lo)) / (hi - lo) repetitions of
    ``run.calls`` calls, cancelling every fixed cost of a timed run."""
    rep_lo = max(1, rep_hi // 4)
    t_lo = run(rep_lo)
    t_hi = run(rep_hi)
    return max((t_hi - t_lo) / ((rep_hi - rep_lo) * run.calls),
               _SLOPE_FLOOR)


def _time_fn(fn, args, rounds=3, target_s=_TARGET_LOOP_S):
    """Median per-call time (s) of fn(*args) over ``rounds`` slopes."""
    run = _runner(fn, args)
    rep_hi = _calibrate(run, target_s)
    samples = sorted(_slope(run, rep_hi) for _ in range(rounds))
    dt = samples[len(samples) // 2]
    if dt <= _SLOPE_FLOOR * 2:
        raise BenchError(f"slope clamped ({dt:.2e}s): measurement broken")
    return dt


def _slope_stats(samples_s, rep):
    """Latency digest of per-call slope samples: p50/p90/p99/MAD in ms
    plus sample/rep counts, through the profiler's ``_stats_ms``."""
    st = _stats_ms([x * 1e3 for x in samples_s], reps=rep)
    return {
        "p50_ms": round(st["p50_ms"], 5),
        "p90_ms": round(st["p90_ms"], 5),
        "p99_ms": round(st["p99_ms"], 5),
        "mad_ms": round(st["mad_ms"], 6),
        "samples": st["samples"],
        "reps": st["reps"],
    }


def _compare(ours_fn, ref_fn, args, rounds=3, ref_args=None,
             target_s=_TARGET_LOOP_S):
    """Interleaved A/B timing: per-round (ours, ref) slope pairs taken
    back to back so the card's drift cancels in the ratio; returns
    (dt_ours, dt_ref, vs_baseline, stats_ours, stats_ref) with the
    per-round median ratio and the per-side latency digests."""
    ref_args = args if ref_args is None else ref_args
    run_o = _runner(ours_fn, args)
    run_r = _runner(ref_fn, ref_args)
    rep_o = _calibrate(run_o, target_s)
    rep_r = _calibrate(run_r, target_s)
    pairs = [(_slope(run_o, rep_o), _slope(run_r, rep_r))
             for _ in range(rounds)]
    for o, r in pairs:
        if o <= _SLOPE_FLOOR * 2 or r <= _SLOPE_FLOOR * 2:
            raise BenchError(
                f"slope clamped (ours={o:.2e}s ref={r:.2e}s): "
                "measurement broken")
    ratios = sorted(r / o for o, r in pairs)
    vs = ratios[len(ratios) // 2]
    dts_o = sorted(o for o, _ in pairs)
    dts_r = sorted(r for _, r in pairs)
    st_o = _slope_stats((o for o, _ in pairs), rep_o * run_o.calls)
    st_r = _slope_stats((r for _, r in pairs), rep_r * run_r.calls)
    return (dts_o[len(dts_o) // 2], dts_r[len(dts_r) // 2], vs, st_o, st_r)


def _pick_best(cands, check, what, rounds=1, target_s=_TARGET_LOOP_S,
               optional=()):
    """Shared candidate sweep: each (name, build, args) entry is built
    lazily (build() -> fn) and checked by check(out) BEFORE it may win on
    speed. Returns the fastest (name, fn, args). Only a candidate named
    in ``optional`` (a torch composition, no kernel of the port) is
    skipped, with a line on stderr, when it fails to build or check; any
    other failure (a kernel's build, launch or check, a device fault) is
    raised, so a failing kernel never leaves its place to a plain
    version."""
    best = None
    for name, build, args in cands:
        try:
            fn = build()
            if check is not None:
                check(fn(*args))
        except Exception as e:
            if name not in optional:
                raise
            print(f"# {what} '{name}' failed: {str(e)[:200]}",
                  file=sys.stderr)
            continue
        dt = _time_fn(fn, args, rounds=rounds, target_s=target_s)
        if best is None or dt < best[1]:
            best = ((name, fn, args), dt)
    if best is None:
        raise BenchError(f"no {what} candidate ran")
    return best[0]


def _check_close(ours, ref, rel_tol):
    """Relative Frobenius error — a wrong kernel's latency is
    meaningless, so every config cross-checks before timing."""
    a = _host_f32(ours)
    b = _host_f32(ref)
    denom = float(np.linalg.norm(b.ravel())) or 1.0
    err = float(np.linalg.norm((a - b).ravel())) / denom
    if not math.isfinite(err) or err > rel_tol:
        raise BenchError(f"numeric mismatch: rel err {err:.3e} > {rel_tol}")


def _host_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# configs — each returns dict(metric, flops, peak_class, ours, ref, args,
#                             [ref_args], rel_tol, [checked])
# ---------------------------------------------------------------------------

def _draw(seed, device, dtype, *shapes):
    """``standard_normal(shape) * 0.1`` from one ``default_rng(seed)``,
    in order, as ``dtype`` tensors on ``device``."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.standard_normal(s) * 0.1).astype(
        np.float32)).to(device).to(dtype) for s in shapes]


def _top_blocks(M, N, K, dtype, arch):
    """The carver's top two (bm, bn, bk) blocks for the yardstick,
    deduplicated (two hints may tie, as 128 x 256 and 256 x 128 do on a
    square shape, so the sweep times both)."""
    blocks = list(dict.fromkeys(
        (h.config["block_M"], h.config["block_N"], h.config["block_K"])
        for h in MatmulTemplate(M, N, K, dtype, arch=arch).hints(2)))
    if not blocks:
        raise BenchError(f"no block of the yardstick divides {M}x{N}x{K}")
    return blocks


def cfg_gemm(M, N, K, dtype="bfloat16", device="cuda", arch=None,
             target_s=_TARGET_LOOP_S):
    from .ops.gemm import matmul_kernel
    from .ops.yardsticks import hand_matmul
    arch = arch or auto_arch()
    a, b = _draw(0, device, getattr(torch, dtype), (M, K), (K, N))
    want = torch.matmul(a.float(), b.float())
    check = functools.partial(_check_close, ref=want, rel_tol=3e-2)

    # the library's GEMM has one tile, so it is built and checked once
    ours = matmul_kernel(M, N, K, in_dtype=dtype)
    check(ours(a, b))
    _, ref, _ = _pick_best(
        [(str(blk), lambda blk=blk: hand_matmul(M, N, K, *blk, dtype),
          (a, b)) for blk in _top_blocks(M, N, K, dtype, arch)],
        check, "hand-written gemm", target_s=target_s)
    return dict(metric=f"{dtype} GEMM {M}x{N}x{K} (matmul_kernel vs "
                       f"hand-written CUDA)",
                flops=2.0 * M * N * K, peak_class=arch.peak_class(dtype),
                ours=ours, ref=ref, args=(a, b), rel_tol=3e-2, checked=True)


def cfg_fp8_gemm(M=4096, N=4096, K=4096, device="cuda", arch=None,
                 target_s=_TARGET_LOOP_S):
    from .ops.gemm import matmul_kernel
    from .ops.yardsticks import hand_matmul
    arch = arch or auto_arch()
    a, b = _draw(2, device, torch.float8_e4m3fn, (M, K), (K, N))
    want = torch.matmul(a.float(), b.float())
    check = functools.partial(_check_close, ref=want, rel_tol=1e-1)

    ours = matmul_kernel(M, N, K, in_dtype="float8_e4m3fn",
                         out_dtype="float32")
    check(ours(a, b))
    _, ref, _ = _pick_best(
        [(str(blk), lambda blk=blk: hand_matmul(
            M, N, K, *blk, "float8_e4m3fn", out_dtype="float32"), (a, b))
         for blk in _top_blocks(M, N, K, "float8_e4m3fn", arch)],
        check, "hand-written fp8 gemm", target_s=target_s)
    return dict(metric=f"fp8(e4m3) GEMM {M}x{N}x{K} (matmul_kernel vs "
                       f"hand-written CUDA)",
                flops=2.0 * M * N * K, peak_class="i8",
                ours=ours, ref=ref, args=(a, b), rel_tol=1e-1, checked=True)


def cfg_w4a16(M=4096, N=4096, K=4096, gs=512, device="cuda", arch=None,
              target_s=_TARGET_LOOP_S):
    from .ops.dequant_gemm import (dequant_gemm_kernel,
                                   dequant_matmul_twopass)
    from .ops.yardsticks import hand_w4a16
    from .quantize.quantization import (dequantize_int4_planar_ref,
                                        quantize_int4_planar)
    arch = arch or auto_arch()
    rng = np.random.default_rng(3)
    a = torch.from_numpy((rng.standard_normal((M, K)) * 0.1).astype(
        np.float32)).to(device).to(torch.bfloat16)
    w = rng.standard_normal((K, N)).astype(np.float32) * 0.1
    gs = min(gs, K // 2)
    packed_np, scales_np = quantize_int4_planar(w, group_size=gs)
    packed = torch.from_numpy(packed_np).to(device)
    scales = torch.from_numpy(scales_np).to(device)

    K2 = K // 2
    G2 = K2 // gs
    a_planar = a.reshape(M, 2, K2)
    s3 = scales.reshape(2, G2, N)
    want = torch.matmul(a.float(), torch.from_numpy(
        dequantize_int4_planar_ref(packed_np, scales_np,
                                   group_size=gs)).to(device))
    check = functools.partial(_check_close, ref=want, rel_tol=4e-2)

    # the library's side: two-pass (unpack kernel + GEMM) or fused (one
    # kernel); their tiles are fixed, so each is one candidate
    o_name, ours, args = _pick_best(
        [("twopass", lambda: dequant_matmul_twopass, (a, packed, scales)),
         ("fused",
          lambda: dequant_gemm_kernel(M, N, K, block_K2=gs, group_size=gs,
                                      in_dtype="bfloat16"),
          (a_planar, packed, s3))],
        check, "w4a16 framework", target_s=target_s)

    # the baseline side: the hand-written fused kernel at the carver's
    # top two tiles, or a plain torch unpack + matmul — the stronger
    def torch_ref(a_, p_, s_):
        p = p_.to(torch.int32)
        lo = (p & 0xF).float() - 8.0
        hi = ((p >> 4) & 0xF).float() - 8.0
        sl = s_[0].repeat_interleave(gs, dim=0)
        sh = s_[1].repeat_interleave(gs, dim=0)
        bd = torch.cat([(lo * sl).to(torch.bfloat16),
                        (hi * sh).to(torch.bfloat16)])
        return torch.matmul(a_, bd)

    halves = (a_planar[:, 0, :], a_planar[:, 1, :], packed, s3)
    tiles = dict.fromkeys(blk[:2] for blk in
                          _top_blocks(M, N, K, "bfloat16", arch))
    cands = [(f"hand-w4a16 {tile}",
              lambda tile=tile: hand_w4a16(M, N, K, gs, *tile), halves)
             for tile in tiles]
    cands.append(("torch-dequant-matmul", lambda: torch_ref,
                  (a, packed, s3)))
    r_name, ref, ref_args = _pick_best(
        cands, check, "w4a16 baseline", target_s=target_s,
        optional={"torch-dequant-matmul"})

    return dict(metric=f"w4a16 dequant GEMM {M}x{N}x{K} gs={gs} (port "
                       f"[{o_name}] vs strongest of hand-written CUDA / "
                       f"torch [{r_name}])",
                flops=2.0 * M * N * K, peak_class="bf16",
                ours=ours, ref=ref, args=args, ref_args=ref_args,
                rel_tol=4e-2, checked=True)


def _device_name(args) -> str:
    if _on_cuda(args):
        return torch.cuda.get_device_name(
            next(x for x in args if isinstance(x, torch.Tensor)
                 and x.is_cuda).device)
    return "cpu"


def run_config(name, build, peaks, rounds=3, target_s=_TARGET_LOOP_S):
    """Build, cross-check, time, validate, and report one config."""
    spec = build()
    args = spec["args"]
    ref_args = spec.get("ref_args", args)
    if not spec.get("checked"):
        _check_close(spec["ours"](*args), spec["ref"](*ref_args),
                     spec["rel_tol"])

    dt_o, dt_r, vs, st_o, st_r = _compare(spec["ours"], spec["ref"], args,
                                          rounds=rounds, ref_args=ref_args,
                                          target_s=target_s)
    val = spec["flops"] / dt_o / 1e12
    ref_val = spec["flops"] / dt_r / 1e12
    cap = peaks[spec["peak_class"]] * 1.1
    if val > cap or ref_val > cap:
        raise BenchError(
            f"{val:.1f} / {ref_val:.1f} (baseline) TFLOPS exceeds "
            f"physical peak {cap:.0f}: measurement broken")
    peak = cap / 1.1
    return {
        "metric": spec["metric"],
        "value": round(val, 2),
        "unit": "TFLOPS",
        "vs_baseline": round(vs, 4),
        "latency_ms": round(dt_o * 1e3, 4),
        "baseline_ms": round(dt_r * 1e3, 4),
        # latency distribution + noise (perf-diff gate inputs)
        "latency_p50_ms": st_o["p50_ms"],
        "latency_p90_ms": st_o["p90_ms"],
        "latency_p99_ms": st_o["p99_ms"],
        "latency_mad_ms": st_o["mad_ms"],
        "latency_samples": st_o["samples"],
        "reps": st_o["reps"],
        "baseline_mad_ms": st_r["mad_ms"],
        # roofline: achieved fraction of this card's relevant peak
        "peak": round(peak, 1),
        "utilization": round(val / peak, 4) if peak else None,
        "config": name,
        "device": _device_name(args),
    }


def _config_builders(q: bool, device="cuda", arch=None,
                     target_s=_TARGET_LOOP_S):
    """The headline configs; ``q`` takes bench.py's ``--quick`` sizes."""
    kw = dict(device=device, arch=arch)
    return [
        ("gemm_quickstart", lambda: cfg_gemm(1024, 1024, 1024,
                                             target_s=target_s, **kw)),
        ("gemm_large", lambda: cfg_gemm(*(2048, 2048, 2048) if q
                                        else (8192, 8192, 4096),
                                        target_s=target_s, **kw)),
        ("fp8_gemm", lambda: cfg_fp8_gemm(*(1024,) * 3 if q
                                          else (4096,) * 3,
                                          target_s=target_s, **kw)),
        ("w4a16_gemm", lambda: cfg_w4a16(*(1024,) * 3 if q
                                         else (4096,) * 3,
                                         target_s=target_s, **kw)),
    ]


def headline(records):
    """``gemm_large``'s record (else the first) with the geomean of
    ``vs_baseline`` over ``records``."""
    geo = math.exp(sum(math.log(max(r["vs_baseline"], 1e-6))
                       for r in records) / len(records))
    head = dict(next((r for r in records if r["config"] == "gemm_large"),
                     records[0]))
    head["geomean_vs_baseline"] = round(geo, 4)
    return head


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tilelang_mesh_tpu_torch.bench",
        description="the headline GEMM comparison on the card")
    ap.add_argument("--quick", action="store_true",
                    help="small shapes (smoke test, not a benchmark)")
    ap.add_argument("--config", action="append", default=None,
                    help="a config name (repeatable; default: all)")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    peaks = _chip_peak_tflops()            # raises without a known card
    configs = _config_builders(args.quick)
    names = [n for n, _ in configs]
    unknown = set(args.config or ()) - set(names)
    if unknown:
        ap.error(f"unknown config(s) {sorted(unknown)}; have {names}")
    configs = [(n, b) for n, b in configs
               if args.config is None or n in args.config]
    results, n_failed = [], 0
    for name, build in configs:
        try:
            rec = run_config(name, build, peaks, rounds=1 if args.quick
                             else 3)
        except Exception as e:      # noqa: BLE001 — report, run the rest
            n_failed += 1
            print(f"# config {name} FAILED: {type(e).__name__}: {e}",
                  file=sys.stderr, flush=True)
            print(json.dumps({"config": name, "error": str(e)[:300]}),
                  flush=True)
            continue
        print(json.dumps(rec), flush=True)
        results.append(rec)
    if not results:
        print(json.dumps({"metric": "bench", "value": 0.0,
                          "unit": "TFLOPS", "vs_baseline": 0.0,
                          "error": "every config failed"}), flush=True)
        return 1
    head = headline(results)
    head["n_configs_ok"] = len(results)
    head["n_configs_failed"] = n_failed
    print(json.dumps(head), flush=True)
    return 2 if n_failed else 0


if __name__ == "__main__":
    sys.exit(main())
