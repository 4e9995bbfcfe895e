#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device   — the card's name and power limit (nvidia-smi);
2. build    — nvcc builds every kernel of the port from csrc/ (sm_90a)
              into build/cuda/;
3. kernels  — each kernel against its plain PyTorch version on the card
              at the serving path's shapes (LLaMA-2-7B attention: H=32,
              D=128, page 128, 8192-token windows, batch 8, 8 splits), in
              float32 and bfloat16, with its time, the plain version's,
              a PyTorch library call's on the same inputs, and the bound;
4. serving  — the main path: a ServingEngine over a 1024-page float32
              pool (4 GiB on the card) answers two waves of four
              requests (8192- and 2048-token prompts, 16 greedy tokens
              each; two wave-2 requests reuse a wave-1 prompt). Every
              outcome must be ``result``, no page may leak, the prefix
              cache must hit, the kernel's launches must equal the
              workload's dispatches, and one step's output must agree
              with the plain version recomputed on a copy of the pool.

Prints a ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``. Without a card it exits non-zero and
prints no result.
"""

import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the serving path's geometry (bench.py cfg_paged_decode's decode shape)
H, D, PS = 32, 128, 128
B, PP, N_SPLIT = 8, 64, 8            # 8192-token windows
N_PAGES = 1024
PEAK_BYTES_S = 3.35e12               # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12               # H100 SXM, f32 outside tensor cores
# kernel vs plain: the same f32 arithmetic in another order
RTOL = ATOL = 1e-4


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def phase(name):
    print(f"== {name}", flush=True)


def cuda_ms(torch, fn, iters):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_rel_excess(got, want):
    """max |got - want| / (ATOL + RTOL |want|): <= 1 means within."""
    return float(((got - want).abs() / (ATOL + RTOL * want.abs())).max())


def kernel_phase(torch, fd, dtype):
    """paged_decode against its plain version at the serving shapes."""
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = N_PAGES * PS
    kp = torch.randn((H, rows, D), generator=g, device="cuda").to(dtype)
    vp = torch.randn((H, rows, D), generator=g, device="cuda").to(dtype)
    q = torch.randn((B, H, 1, D), generator=g, device="cuda")
    table = torch.stack([torch.randperm(N_PAGES, generator=g,
                                        device="cuda")[:PP]
                         for _ in range(B)]).to(torch.int32)
    scale = 1.0 / math.sqrt(D)

    def kern():
        return fd.paged_decode_partials(q, kp, vp, table, PS, N_SPLIT,
                                        scale)

    def plain():
        return fd.paged_decode_partials_plain(q, kp, vp, table, PS,
                                              N_SPLIT, scale)

    got, want = kern(), plain()
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    excess = max(max_rel_excess(a, b) for a, b in zip(got, want))
    for a in got:
        check(bool(torch.isfinite(a).all()), "non-finite kernel output")
    check(excess <= 1.0, f"paged_decode ({dtype}) disagrees with its plain "
                         f"version: max abs err {err:.3e}, "
                         f"{excess:.2f}x the tolerance")
    out_k = fd._combine_splits(q, *got)
    out_p = fd._combine_splits(q, *want)
    check(max_rel_excess(out_k, out_p) <= 1.0, "combined output disagrees")

    # library yardstick: one fused attention call on the same KV,
    # gathered contiguous beforehand (timed only; the port never calls it)
    idx = (table.long()[:, :, None] * PS
           + torch.arange(PS, device="cuda")).reshape(B, PP * PS)
    kc = kp[:, idx].permute(1, 0, 2, 3).contiguous()       # (B,H,S,D)
    vc = vp[:, idx].permute(1, 0, 2, 3).contiguous()
    qc = q.to(dtype)
    lib_out = F.scaled_dot_product_attention(qc, kc, vc)
    check(float((lib_out.float() - out_p).abs().max()) < 2e-2,
          "library yardstick disagrees with the plain version")

    ms = cuda_ms(torch, kern, 20)
    plain_ms = cuda_ms(torch, plain, 3)
    # the kernel at each (batch, pages) bucket the serving phase uses
    bucket_ms = {}
    for b in (1, 2, 4, 8):
        for pp in (16, 32, 64):
            qb, tb = q[:b], table[:b, :pp].contiguous()
            bucket_ms[f"b{b}p{pp}"] = cuda_ms(
                torch, lambda: fd.paged_decode_partials(
                    qb, kp, vp, tb, PS, min(N_SPLIT, pp), scale), 20)
    library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qc, kc, vc), 20)
    esize = torch.empty((), dtype=dtype).element_size()
    n_rows = B * PP * PS                 # distinct rows this table reads
    bytes_moved = (2 * n_rows * H * D * esize      # K and V, once
                   + q.numel() * 4 + table.numel() * 4
                   + sum(t.numel() * 4 for t in got))
    flops = 4 * n_rows * H * D           # q.k and p.v per row and head
    t_bytes = bytes_moved / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    res = {"dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
           "tolerance": f"rtol={RTOL} atol={ATOL}", "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": bytes_moved, "flops": flops, "bucket_ms": bucket_ms}
    print(json.dumps(res), flush=True)
    del kp, vp, kc, vc
    torch.cuda.empty_cache()
    return res


def serving_phase(torch, fd, cache_root):
    import numpy as np

    from tilelang_mesh_tpu_torch.observability import histogram
    from tilelang_mesh_tpu_torch.serving import (FlashDecodeWorkload,
                                                 PagedKVAllocator,
                                                 PrefixKVCache,
                                                 ServingEngine)
    alloc = PagedKVAllocator(n_pages=N_PAGES, page_size=PS, heads=H,
                             head_dim=D)
    check(alloc.kp.is_cuda and alloc.vp.is_cuda, "pools not on the card")
    wl = FlashDecodeWorkload(alloc, batch_buckets=(1, 2, 4, 8),
                             page_buckets=(16, 32, 64),
                             prefix_cache=PrefixKVCache(root=cache_root))
    # keep one full-window dispatch (inputs, output, a copy of the pages
    # it read, renumbered 0..) to recompute with the plain version later
    kept = {}
    dispatch = wl._dispatch

    def keeping(q, table, bb, pp):
        out = dispatch(q, table, bb, pp)
        if not kept and pp == wl.page_buckets[-1] and q.any():
            rows = (torch.from_numpy(table).long().cuda()[:, :, None] * PS
                    + torch.arange(PS, device="cuda")).reshape(-1)
            kept.update(q=q.copy(), out=out.clone(),
                        table=np.arange(bb * pp, dtype=np.int32).reshape(
                            bb, pp),
                        kp=alloc.kp[:, rows], vp=alloc.vp[:, rows])
        return out

    wl._dispatch = keeping
    eng = ServingEngine(wl)

    fd.reset_launches()                  # the main path starts here
    histogram.reset()
    t0 = time.perf_counter()
    n_warm = eng.warmup()
    warm_s = time.perf_counter() - t0
    waves = [[(8192, 1), (8192, 2), (2048, 3), (2048, 4)],
             [(8192, 1), (8192, 1), (2048, 5), (2048, 6)]]
    reqs, wave_s, submit_s = [], [], 0.0
    for wave in waves:
        t0 = time.perf_counter()
        batch = [eng.submit(context_tokens=ctx, new_tokens=16, seed=seed)
                 for ctx, seed in wave]
        submit_s += time.perf_counter() - t0
        eng.run()
        wave_s.append(time.perf_counter() - t0)
        reqs += batch
    launches = fd.launches["paged_decode"]      # read right after
    stats = eng.stats()

    check([r.outcome for r in reqs] == ["result"] * len(reqs),
          f"outcomes {[(r.outcome, r.shed_reason, r.error) for r in reqs]}")
    check(alloc.in_use == 0 and not alloc.leak_check(),
          f"leaked pages: {alloc.leak_check()}")
    pc = wl.prefix_cache.stats()
    check(pc["hits"] >= 1, f"no prefix-cache hit: {pc}")
    check(launches == wl.dispatches and launches > 0,
          f"kernel launches {launches} != decode dispatches "
          f"{wl.dispatches}")
    for r in reqs:
        out = r.result
        check(out.shape == (H, 1, D) and bool(abs(out).max() < 1e30)
              and not (out != out).any(), f"bad output of {r}")
        check(len(r.generated) == 16, f"{r} sampled {len(r.generated)}")
    check(bool(kept), "no full-window step was kept for the recheck")
    qt = torch.from_numpy(kept["q"]).cuda()
    tt = torch.from_numpy(kept["table"]).cuda()
    want = fd._combine_splits(qt, *fd.paged_decode_partials_plain(
        qt, kept["kp"], kept["vp"], tt, PS, N_SPLIT, wl.sm_scale))
    step_err = float((kept["out"] - want).abs().max())
    check(max_rel_excess(kept["out"], want) <= 1.0,
          f"served step disagrees with the plain version ({step_err:.3e})")

    steps_ms = sorted((s.t1 - s.t0) * 1e3 for s in eng.trace.spans
                      if s.name == "serve.batch" and s.t1 is not None)
    ttft_ms = sorted((r.first_token_t - r.submit_t) * 1e3 for r in reqs)
    prefill = histogram.get_histogram("serve.prefill.latency")
    # where the waves' wall time went: admission (prefix restore + the
    # first prefill chunk), later prefill chunks (host KV derivation, its
    # copy to the card, prefix publication), decode steps, the rest
    # (scheduling, sampling, token appends)
    split = {"submit_s": submit_s,
             "prefill_chunks_s": prefill.sum if prefill else 0.0,
             "decode_steps_s": sum(steps_ms) / 1e3}
    split["other_s"] = sum(wave_s) - sum(split.values())

    def pct(xs, p):
        return xs[min(len(xs) - 1, int(round(p / 100 * (len(xs) - 1))))]

    res = {"requests": len(reqs), "warmup_buckets": n_warm,
           "warmup_s": warm_s, "wave_s": wave_s,
           "req_per_s": len(reqs) / sum(wave_s),
           "tokens_per_s": 16 * len(reqs) / sum(wave_s),
           "decode_steps": stats["steps"], "dispatches": wl.dispatches,
           "launches": launches,
           "step_ms_p50": pct(steps_ms, 50), "step_ms_p99": pct(steps_ms, 99),
           "ttft_ms_p50": pct(ttft_ms, 50), "ttft_ms_max": ttft_ms[-1],
           "prefix_cache": {k: pc[k] for k in ("hits", "misses",
                                                "bytes_saved")},
           "step_recheck_max_abs_err": step_err, "wall_split": split}
    print(json.dumps(res), flush=True)
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from tilelang_mesh_tpu_torch.ops import _build
    from tilelang_mesh_tpu_torch.ops import flash_decoding as fd

    scratch = ROOT / "build" / "chip_smoke"
    shutil.rmtree(scratch, ignore_errors=True)
    scratch.mkdir(parents=True)
    os.environ["TL_TPU_TRACE_DIR"] = str(scratch / "trace")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"nvidia-smi: {smi_line}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind}", flush=True)

    phase("build")
    t0 = time.perf_counter()
    _build.load("paged_decode")
    build_s = time.perf_counter() - t0
    nvcc_s, log = _build.build_log("paged_decode")
    print(f"paged_decode: built in {nvcc_s:.2f}s (load {build_s:.2f}s)")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    phase("kernels")
    f32 = kernel_phase(torch, fd, torch.float32)
    bf16 = kernel_phase(torch, fd, torch.bfloat16)

    phase("serving")
    srv = serving_phase(torch, fd, scratch / "prefix")
    shutil.rmtree(scratch, ignore_errors=True)

    kernels = [{
        "name": "paged_decode", "route": "cuda",
        "source": "tilelang_mesh_tpu_torch/csrc/paged_decode.cu",
        "replaces": "tilelang_mesh_tpu/ops/flash_decoding.py:113",
        "launches": srv["launches"], "max_abs_err": f32["max_abs_err"],
        "ms": f32["ms"], "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"],
        "library_ms": f32["library_ms"],
        "bf16": {k: bf16[k] for k in ("max_abs_err", "ms", "plain_ms",
                                      "bound_ms", "library_ms")},
    }]
    print(smi_line)                      # the card, as nvidia-smi names it
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
