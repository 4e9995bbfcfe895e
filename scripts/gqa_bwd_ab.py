#!/usr/bin/env python3
"""Hold the attention backward pair (csrc/gqa_bwd.cu: dK/dV and dQ)
against another version of its source: each against the plain version,
the float32 outputs bit for bit, and the time of each.

    python3 scripts/gqa_bwd_ab.py EARLIER_CSRC [LATER_CSRC] [--out DIR]

``EARLIER_CSRC`` (and ``LATER_CSRC``, by default this checkout's
``tilelang_mesh_tpu_torch/csrc``) are directories holding ``gqa_bwd.cu``
with its headers and the same C entry points, for example a parent
commit's ``csrc`` from ``git archive`` unpacked under ``build/``. Both
are built with nvcc into ``DIR`` (default ``build/gqa_bwd_ab``) and
called through ``ops/gqa_bwd.py``'s ``gqa_bwd_dkdv`` and ``gqa_bwd_dq``
at chip_smoke.py's attention phase shape (B 4, H 16, S 4096, D 128,
causal; 5.37e8 visible pairs) in float32, bfloat16 and float16, on that
phase's draws (a seeded card generator, seed 1; lse2 and delta from the
plain partial forward). Each build's dK, dV and dQ are held against the
plain version (normwise, within chip_smoke.py's ``ATTN_TOL``); the two
builds' float32 outputs must be equal bit for bit. Each build's pair is
timed with CUDA events behind a spin, in turns (earlier, later, later,
earlier), beside SDPA's backward (dq, dk, dv) and the bound (8 D and
6 D flops a pair over the card's peak for the type). Prints one JSON
line with the card's name and power limit, each instance's registers
and spill stores, and each build's nvcc time; exits 1 if a check fails.
Needs one NVIDIA card; exits non-zero without one.
"""

import argparse
import ctypes
import importlib
import json
import math
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
B, H, S, D = 4, 16, 4096, 128


def build(src_dir, out_dir, tag):
    """The loaded library of ``gqa_bwd.cu`` in one source directory, its
    nvcc seconds and the compiler's output."""
    from tilelang_mesh_tpu_torch.ops import _build
    d = out_dir / tag
    d.mkdir(parents=True, exist_ok=True)
    for f in src_dir.glob("*.cu*"):
        shutil.copy(f, d / f.name)
    lib = d / "libgqa_bwd.so"
    t0 = time.perf_counter()
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                          str(d / "gqa_bwd.cu")], capture_output=True,
                         text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {tag}:\n{res.stderr}")
    return ctypes.CDLL(str(lib)), time.perf_counter() - t0, \
        res.stdout + res.stderr


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("earlier", type=Path)
    ap.add_argument("later", type=Path, nargs="?",
                    default=ROOT / "tilelang_mesh_tpu_torch" / "csrc")
    ap.add_argument("--out", type=Path, default=ROOT / "build" /
                    "gqa_bwd_ab")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gqa_bwd_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import torch.nn.functional as F
    from tilelang_mesh_tpu_torch.ops import _build
    from tilelang_mesh_tpu_torch.ops import gqa_bwd as gb
    fa = importlib.import_module("tilelang_mesh_tpu_torch.ops.flash_attention")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    shutil.rmtree(args.out, ignore_errors=True)
    libs, builds = {}, {}
    with ThreadPoolExecutor(max_workers=2) as pool:     # both nvccs at once
        done = pool.map(lambda t: build(t[1], args.out, t[0]),
                        (("earlier", args.earlier), ("later", args.later)))
    for tag, (lib, secs, log) in zip(("earlier", "later"), done):
        libs[tag] = lib
        builds[tag] = {"nvcc_s": secs,
                       "registers_spills": cs.kernel_registers(log)}
    load = _build.load
    which = ["later"]
    _build.load = lambda name: (libs[which[0]] if name == "gqa_bwd"
                                else load(name))

    pairs = cs.causal_pairs(S, S) * B * H
    out = {"card": smi, "shape": [B, H, S, D], "causal": True,
           "pairs": pairs, "builds": builds}
    failed = []
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        name = str(dtype)[6:]
        tol = cs.ATTN_TOL[name]
        peak = cs.PEAK_F32_FLOPS if dtype == torch.float32 else \
            cs.PEAK_BF16_FLOPS
        gen = torch.Generator(device="cuda").manual_seed(1)
        q, k, v, do = (torch.randn((B, H, S, D), generator=gen,
                                   device="cuda").to(dtype)
                       for _ in range(4))
        sm = 1.0 / math.sqrt(D)
        acc, m, l = fa.mha_fwd_partial_plain(q, k, v, True, sm)
        o = (acc / l[..., None]).to(dtype)
        lse2 = m + torch.log2(l)
        delta = (do.float() * o.float()).sum(-1)
        del acc, m, l
        ops = (q, k, v, do, lse2, delta)
        want = (*gb.gqa_bwd_dkdv_plain(*ops, True, sm),
                gb.gqa_bwd_dq_plain(*ops, True, sm))
        case, got = {"tolerance": f"normwise {tol}"}, {}
        for tag in ("earlier", "later"):
            which[0] = tag
            got[tag] = (*gb.gqa_bwd_dkdv(*ops, True, sm),
                        gb.gqa_bwd_dq(*ops, True, sm))
            torch.cuda.synchronize()
            errs = [cs.normwise_err(a, b)[1] for a, b in zip(got[tag],
                                                            want)]
            case[f"{tag}_normwise"] = dict(zip(("dk", "dv", "dq"), errs))
            if not (max(errs) <= tol and all(
                    bool(torch.isfinite(a).all()) for a in got[tag])):
                failed.append(f"{name} {tag}: {errs} > {tol}")
        case["bit_equal"] = all(torch.equal(a, b) for a, b in
                                zip(got["earlier"], got["later"]))
        if dtype == torch.float32 and not case["bit_equal"]:
            failed.append("float32: the builds' outputs differ")
        del got, want
        torch.cuda.empty_cache()

        calls = {"dkdv": lambda: gb.gqa_bwd_dkdv(*ops, True, sm),
                 "dq": lambda: gb.gqa_bwd_dq(*ops, True, sm)}
        calls["pair"] = lambda: (calls["dkdv"](), calls["dq"]())
        times = {tag: {c: [] for c in calls} for tag in ("earlier", "later")}
        for tag in ("earlier", "later", "later", "earlier"):
            which[0] = tag
            for c, fn in calls.items():
                times[tag][c].append(cs.device_ms(torch, fn, 3))
        case["ms"] = times
        case["speedup_pair"] = (min(times["earlier"]["pair"])
                                / max(times["later"]["pair"]))
        case["bound_ms"] = {"dkdv": 8 * D * pairs / peak * 1e3,
                            "dq": 6 * D * pairs / peak * 1e3}
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        res = F.scaled_dot_product_attention(*leaves, is_causal=True)
        case["sdpa_backward_ms"] = cs.device_ms(
            torch, lambda: torch.autograd.grad(res, leaves, do,
                                               retain_graph=True), 3)
        del leaves, res, ops, q, k, v, do, lse2, delta, o
        torch.cuda.empty_cache()
        out[name] = case
        print(json.dumps({name: case}), flush=True)
    out["failed"] = failed
    print(json.dumps(out))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
