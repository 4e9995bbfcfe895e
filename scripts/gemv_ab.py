#!/usr/bin/env python3
"""Hold the GEMV (csrc/gemv.cu, #18) against another version of its
source: each build against the plain version, the SASS of the kernel
that must not change, the time of each in turns beside ``torch.mv``,
and the bulk kernel's plan at other blocks, stage sizes and stage
counts.

    python3 scripts/gemv_ab.py EARLIER_CSRC [LATER_CSRC] [--out DIR]
        [--build DIR] [--others]

``EARLIER_CSRC`` and ``LATER_CSRC`` (by default this checkout's
``tilelang_mesh_tpu_torch/csrc``) are directories holding ``gemv.cu``
with its headers, for example a parent commit's ``csrc`` from ``git
archive`` unpacked under ``build/``. The earlier build is called through
its own C signature (``tl_gemv(a, b, c, N, K, in, out, stream)``); the
later one through ``tl_gemv``'s path and plan arguments, at the path
``ops/gemm_variants.py::gemv_path`` names and the plan
``gemv_bulk_plan`` gives. Both build at once (nvcc, the port's flags).

Cases, at chip_smoke.py's gemm_variants phase's shapes and draws
(LLaMA-2-7B: one token's gate/up, N 11008, K 4096, bfloat16 and
float32; the LM head, N 32000, bfloat16): each build held against
``gemv_plain`` (normwise, chip_smoke.py's GEMM_TOL), timed with
chip_smoke.py's ``device_ms`` (CUDA events behind a spin) in the order
earlier, later, torch.mv, later, earlier. The later build's bulk kernel
is then timed at each plan of ``PLANS`` (blocks an SM, stage bytes,
stages: turned here into ``tl_gemv``'s blocks, rows a stage and stages,
which it refuses where they do not fit; the kept plan timed in turns
beside them), and its old kernel on the same aligned operands (path 0),
whose float32 sums are taken in the same order: its output is compared
bit for bit.

The SASS of ``gemv<T, VEC>`` (the old kernel, every instance) must be
the same in both builds; with ``--others`` every other source whose
header closure differs is built from both directories and compared in
full (``scripts/nsa_ab.py``'s helpers; the first differences go to
DIR/sass_diffs). Bounds are bytes over 3.35 TB/s. Prints one JSON line
with the card's name and power limit and each build's registers, and
writes DIR/result.json; exits 1 when a check fails. Needs one NVIDIA
card; exits non-zero without one.
"""

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (label, N, dtype name, draw seed): chip_smoke.py's GEMV cases
CASES = (("decode_gate_up_bf16", 11008, "bfloat16", 33),
         ("decode_gate_up_f32", 11008, "float32", 33),
         ("lm_head_bf16", 32000, "bfloat16", 34))
# the bulk kernel's plans timed beside the kept one: (blocks an SM,
# stage bytes, stages), passed to tl_gemv as (blocks, whole rows a
# stage, stages)
PLANS = ((1, 32 * 1024, 4), (1, 16 * 1024, 8), (2, 32 * 1024, 2),
         (2, 16 * 1024, 4), (3, 32 * 1024, 2), (4, 8 * 1024, 4),
         (4, 16 * 1024, 3))
# the old kernel's functions, whose SASS must not change
KEPT = r"gemvI"


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("earlier", type=Path)
    ap.add_argument("later", type=Path, nargs="?",
                    default=ROOT / "tilelang_mesh_tpu_torch" / "csrc")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "gemv_ab" / "out")
    ap.add_argument("--build", type=Path,
                    default=ROOT / "build" / "gemv_ab")
    ap.add_argument("--others", action="store_true",
                    help="also compare the SASS of every other source "
                         "whose header closure differs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gemv_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    import chip_smoke as cs
    import nsa_ab
    from softmax_decode_ab import nvcc_build
    from tilelang_mesh_tpu_torch.ops import gemm_variants as gv
    from tilelang_mesh_tpu_torch.ops.gemm import DTYPE_CODES
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    shutil.rmtree(args.build, ignore_errors=True)
    dirs = {"earlier": args.earlier, "later": args.later}
    for tag, src in dirs.items():
        (args.build / tag).mkdir(parents=True)
        for f in src.glob("*.cu*"):
            shutil.copy(f, args.build / tag / f.name)
    others = []
    if args.others:
        others = sorted(p.stem for p in args.later.glob("*.cu")
                        if p.stem != "gemv"
                        and nsa_ab.closure(args.earlier, p.stem)
                        != nsa_ab.closure(args.later, p.stem))
    jobs = {(tag, n): (args.build / tag, n, args.build / tag / f"lib{n}.so")
            for tag in dirs for n in ("gemv",) + tuple(others)}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(jobs)) as ex:
        built = dict(zip(jobs, ex.map(nvcc_build, jobs.values())))
    out = {"card": smi, "build_s": round(time.perf_counter() - t0, 1),
           "builds": {t: {"nvcc_s": round(built[t, "gemv"][2], 1),
                          "registers_spills":
                              cs.kernel_registers(built[t, "gemv"][1])}
                      for t in dirs}}
    failed = []

    # -- SASS ---------------------------------------------------------------
    kept = {}
    for n in ("gemv",) + tuple(others):
        a, b = (nsa_ab.sass(built[tag, n][0]) for tag in dirs)
        pat = KEPT if n == "gemv" else r"."
        # the functions both builds hold (a source with kernels of its
        # own added, as sparse_mla.cu's, is held by its own A/B); those
        # of one build alone are counted
        keep = [fn for fn in sorted(set(a) & set(b)) if re.search(pat, fn)]
        same = nsa_ab.same_sass({f: a[f] for f in keep},
                                {f: b[f] for f in keep},
                                args.out / "sass_diffs" / f"{n}.diff")
        kept[n] = {"functions": len(keep), "same_sass": same,
                   "earlier_only": len(set(a) - set(b)),
                   "later_only": len(set(b) - set(a))}
        if not keep or not same or (n == "gemv" and set(a) - set(b)):
            failed.append(f"{n}: {len(keep)} kept functions, SASS "
                          f"{'same' if same else 'differs'}")
    out["kept_sass"] = kept

    libs = {t: ctypes.CDLL(str(built[t, "gemv"][0])) for t in dirs}
    P, I = ctypes.c_void_p, ctypes.c_int
    libs["earlier"].tl_gemv.argtypes = [P] * 3 + [I] * 4 + [P]
    libs["later"].tl_gemv.argtypes = [P] * 3 + [I] * 8 + [P]
    for lib in libs.values():
        lib.tl_gemv.restype = I
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def call(tag, x, w, c, path=None, plan=None):
        N, K = w.shape
        st = torch.cuda.current_stream().cuda_stream
        codes = (DTYPE_CODES[x.dtype], DTYPE_CODES[c.dtype])
        if tag == "earlier":
            rc = libs[tag].tl_gemv(x.data_ptr(), w.data_ptr(), c.data_ptr(),
                                   N, K, *codes, st)
        else:
            rc = libs[tag].tl_gemv(x.data_ptr(), w.data_ptr(), c.data_ptr(),
                                   N, K, *codes, path,
                                   *(plan[:3] if plan else (0, 0, 0)), st)
        if rc:
            raise RuntimeError(f"gemv {tag}: launch refused ({rc})")
        return c

    for label, N, tname, seed in CASES:
        dtype = getattr(torch, tname)
        K = cs.LLAMA2["hidden"]
        x, w = (torch.from_numpy(t).cuda().to(dtype)
                for t in cs.draw_np(seed, (K,), (N, K)))
        path = gv.gemv_path(N, K, dtype, x.data_ptr(), w.data_ptr(), sms)
        plan = gv.gemv_bulk_plan(N, K, dtype, sms)
        code = {"gemv": 0, "gemv_bulk": 1}[path]
        want = gv.gemv_plain(x, w)
        c = torch.empty((N,), dtype=dtype, device="cuda")
        case = {"shape": [N, K], "dtype": tname, "path": path,
                "plan": plan._asdict() if plan else None}
        got = {}
        for tag in dirs:
            got[tag] = call(tag, x, w, torch.empty_like(c), code,
                            plan).clone()
            torch.cuda.synchronize()
            rel = cs.normwise_err(got[tag], want)[1]
            case[f"{tag}_normwise"] = rel
            if not rel <= cs.GEMM_TOL[tname]:
                failed.append(f"{label} {tag}: {rel:.3e} of the plain")
        old = call("later", x, w, torch.empty_like(c), 0, plan)
        torch.cuda.synchronize()
        case["bulk_equals_old_kernel_bits"] = bool(torch.equal(old,
                                                               got["later"]))
        calls = {"earlier": lambda: call("earlier", x, w, c),
                 "later": lambda: call("later", x, w, c, code, plan),
                 "library": lambda: torch.mv(w, x)}
        times = {}
        for tag in ("earlier", "later", "library", "later", "earlier"):
            times.setdefault(tag, []).append(
                cs.device_ms(torch, calls[tag], 50))
        case["ms"] = times
        nbytes = (K + N * K + N) * x.element_size()
        case["bound_ms"] = nbytes / cs.PEAK_BYTES_S * 1e3
        sweep = {}
        row = K * x.element_size()
        for bps, sb, ns in PLANS if path == "gemv_bulk" else ():
            alt = (bps * sms, max(1, sb // row), ns)
            key = f"blocks{bps}x_stage{sb // 1024}K_stages{ns}"
            try:
                call("later", x, w, c, 1, alt)
            except RuntimeError:
                sweep[key] = {"plan": alt, "refused": True}
                continue
            kept_ms = cs.device_ms(torch, calls["later"], 50)
            alt_ms = cs.device_ms(
                torch, lambda: call("later", x, w, c, 1, alt), 50)
            sweep[key] = {"plan": alt, "ms": alt_ms, "kept_ms": kept_ms}
        case["plans"] = sweep
        out[label] = case
        print(json.dumps({label: case}), flush=True)
        del x, w, c, want, got, old
        torch.cuda.empty_cache()

    out["failed"] = failed
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "result.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
