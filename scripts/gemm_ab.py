#!/usr/bin/env python3
"""Hold the dense GEMMs (#15 ``csrc/gemm.cu``, #42 ``csrc/yardstick_gemm.cu``)
against another version of their sources: the time of each, in turns,
at the headline's and chip_smoke.py's gemm-phase shapes.

    python3 scripts/gemm_ab.py EARLIER_CSRC [LATER_CSRC] [--out DIR]

``EARLIER_CSRC`` (and ``LATER_CSRC``, by default this checkout's
``tilelang_mesh_tpu_torch/csrc``) are directories holding ``gemm.cu``
and ``yardstick_gemm.cu`` with their headers, for example a parent
commit's ``csrc`` from ``git archive`` unpacked under ``build/``. Both
sources are built from both directories with nvcc into ``DIR`` (default
``build/gemm_ab``), all four builds at once. The later build is called
through the port's wrappers (``ops/gemm.py::matmul``,
``ops/yardsticks.py::hand_matmul``: the path rule, the block choice and
the fp8 widening inside the timed call); the earlier build through its
C entry points as they were (``tl_matmul`` at its one tile,
``tl_yardstick_gemm`` with B row-major), so an earlier ``csrc`` needs
those two entries with their earlier arguments.

Cases, on operands ``standard_normal * 0.1`` from ``default_rng`` (as
``bench.py`` draws them): #15 bf16 at 1024^3 and 8192 x 8192 x 4096,
bf16 at 4096^3 in every transpose, f16, fp8 e4m3 -> f32 and f32 at
4096^3; #42 at the carver's two top blocks in bf16 at 8192 x 8192 x
4096, fp8 -> f32, f16 and f32 at 4096^3. Each output is held against its
plain version (normwise: 1e-5 for a float32 output, 1e-2 for a 16-bit
one); each is timed with chip_smoke.py's ``device_ms`` in turns
(earlier, later, later, earlier), beside one PyTorch call computing the
same product (``torch.matmul``; ``torch._scaled_mm`` with unit scales
for fp8) and the bound (chip_smoke.py's ``mm_bound``).

The other sources on the shared GEMM headers (``SHARED``: the users of
``gemm_tile.cuh`` / ``gemm_dense.cuh`` and of ``yardstick.cuh``) must
compile to the same code: a source whose bytes, with the headers it
includes, are equal in both directories is reported "same bytes"; one
that differs is built from both and its SASS compared (as
``scripts/nsa_ab.py`` does). Prints one JSON line with the card's name
and power limit, each build's nvcc seconds and each kernel's registers
and spill stores (``-Xptxas -v``); exits 1 when an output disagrees
with its plain version or a shared source's code differs. Needs one
NVIDIA card; exits non-zero without one.
"""

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SOURCES = ("gemm", "yardstick_gemm")
# the other sources on gemm_tile.cuh / gemm_dense.cuh and yardstick.cuh
SHARED = ("grouped_gemm", "gemm_s8", "dequant_gemm", "gemm_variants",
          "bitnet_gemm", "dsa", "gemv", "yardstick_w4a16")
TOL = {"float32": 1e-5, "bfloat16": 1e-2, "float16": 1e-2}


def draw(torch, seed, dtype, *shapes):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.standard_normal(s) * 0.1).astype(
        np.float32)).cuda().to(dtype) for s in shapes]


def old_matmul(torch, lib, a, b, ta, tb, out):
    """An earlier build's ``tl_matmul`` (the tile loop) into a new C."""
    from tilelang_mesh_tpu_torch.ops.gemm import DTYPE_CODES, _shapes
    M, N, K = _shapes(a, b, ta, tb)
    c = torch.empty((M, N), dtype=out, device=a.device)
    fn = lib.tl_matmul
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), M, N, K,
              DTYPE_CODES[a.dtype], int(ta), int(tb), DTYPE_CODES[out], 0,
              torch.cuda.current_stream().cuda_stream)
    if code:
        raise RuntimeError(f"earlier tl_matmul refused: {code}")
    return c


def old_yardstick(torch, lib, a, b, blk, out):
    """An earlier build's ``tl_yardstick_gemm`` (B row-major in every
    type) into a new C."""
    from tilelang_mesh_tpu_torch.ops.gemm import DTYPE_CODES
    M, K = a.shape
    N = b.shape[1]
    c = torch.empty((M, N), dtype=out, device=a.device)
    fn = lib.tl_yardstick_gemm
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), M, N, K, *blk,
              DTYPE_CODES[a.dtype], DTYPE_CODES[out],
              torch.cuda.current_stream().cuda_stream)
    if code:
        raise RuntimeError(f"earlier tl_yardstick_gemm refused: {code}")
    return c


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("earlier", type=Path)
    ap.add_argument("later", type=Path, nargs="?",
                    default=ROOT / "tilelang_mesh_tpu_torch" / "csrc")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "gemm_ab")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gemm_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    import chip_smoke as cs
    from nsa_ab import build, closure, same_sass, sass
    from tilelang_mesh_tpu_torch.carver import MatmulTemplate, auto_arch
    from tilelang_mesh_tpu_torch.ops import _build
    from tilelang_mesh_tpu_torch.ops import gemm as gm
    from tilelang_mesh_tpu_torch.ops import yardsticks as ys
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    shutil.rmtree(args.out, ignore_errors=True)
    dirs = {"earlier": args.earlier, "later": args.later}
    for tag, src in dirs.items():
        (args.out / tag).mkdir(parents=True)
        for f in src.glob("*.cu*"):
            shutil.copy(f, args.out / tag / f.name)
    shared = {n: ("same bytes" if closure(args.earlier, n)
                  == closure(args.later, n) else None) for n in SHARED}
    jobs = [(tag, dirs[tag], n, args.out) for n in list(SOURCES) + [
        n for n, v in shared.items() if v is None] for tag in dirs]
    with ThreadPoolExecutor(max_workers=len(jobs)) as ex:
        built = dict(zip([(j[0], j[2]) for j in jobs], ex.map(build, jobs)))
    for n, v in shared.items():
        if v is None:
            shared[n] = ("same SASS" if same_sass(
                sass(built["earlier", n][0]), sass(built["later", n][0]),
                args.out / "sass_diffs" / f"{n}.diff") else "SASS differs")
    libs = {n: {tag: ctypes.CDLL(str(built[tag, n][0])) for tag in dirs}
            for n in SOURCES}
    builds = {n: {tag: {"nvcc_s": round(built[tag, n][2], 1),
                        "registers_spills": cs.kernel_registers(
                            built[tag, n][1])} for tag in dirs}
              for n in SOURCES}
    load = _build.load
    _build.load = lambda name: (libs[name]["later"] if name in libs
                                else load(name))
    arch = auto_arch()
    out = {"card": smi, "shared_sources": shared, "builds": builds}
    ok = all(v != "SASS differs" for v in shared.values())
    one = torch.ones((), device="cuda")

    def library(a, b, dt, ta=False, tb=False):
        lhs, rhs = (a.T if ta else a), (b.T if tb else b)
        if dt == torch.float8_e4m3fn:
            bcol = rhs.T.contiguous().T
            return lambda: torch._scaled_mm(lhs, bcol, scale_a=one,
                                            scale_b=one,
                                            out_dtype=torch.float32)
        return lambda: torch.matmul(lhs, rhs)

    def bound(M, N, K, dt, out_dt):
        peak = {torch.float32: cs.PEAK_F32_FLOPS}.get(
            dt, cs.PEAK_8BIT_OPS if dt == torch.float8_e4m3fn
            else cs.PEAK_BF16_FLOPS)
        nb = (M * K + K * N) * torch.empty((), dtype=dt).element_size() \
            + M * N * torch.empty((), dtype=out_dt).element_size()
        return cs.mm_bound(2 * M * N * K, nb, peak)

    def run(name, calls, plain, lib_call, M, N, K, dt, out_dt, iters=5):
        """Hold both builds' outputs against the plain version, time them
        in turns and the library call once."""
        nonlocal ok
        want = plain()
        rec = {"shape": [M, N, K], "dtype": str(dt)[6:],
               "out": str(out_dt)[6:]}
        tol = TOL[rec["out"]]
        for tag in ("earlier", "later"):
            rec[f"{tag}_normwise"] = cs.normwise_err(calls[tag](), want)[1]
        ok &= rec["later_normwise"] <= tol
        del want
        times = {"earlier": [], "later": []}
        for tag in ("earlier", "later", "later", "earlier"):
            times[tag].append(cs.device_ms(torch, calls[tag], iters))
        rec["ms"] = times
        rec["library_ms"] = cs.device_ms(torch, lib_call, iters)
        rec["bound_ms"], rec["bound_by"] = bound(M, N, K, dt, out_dt)
        out[name] = rec
        print(name, json.dumps(rec), flush=True)
        torch.cuda.empty_cache()

    gemm_old = libs["gemm"]["earlier"]
    # #15
    cases = [("bf16_1024", 0, (1024,) * 3, torch.bfloat16, None, (0, 0)),
             ("bf16_8192x8192x4096", 0, (8192, 8192, 4096), torch.bfloat16,
              None, (0, 0))]
    cases += [(f"bf16_4096_{ta}{tb}", 1, (4096,) * 3, torch.bfloat16, None,
               (ta, tb)) for ta in (0, 1) for tb in (0, 1)]
    cases += [("f16_4096", 1, (4096,) * 3, torch.float16, None, (0, 0)),
              ("fp8_f32_4096", 2, (4096,) * 3, torch.float8_e4m3fn,
               torch.float32, (0, 0)),
              ("f32_4096", 1, (4096,) * 3, torch.float32, None, (0, 0))]
    for label, seed, (M, N, K), dt, o, (ta, tb) in cases:
        a, b = draw(torch, seed, dt, (K, M) if ta else (M, K),
                    (N, K) if tb else (K, N))
        o = o or dt
        calls = {"earlier": lambda: old_matmul(torch, gemm_old, a, b, ta,
                                                tb, o),
                 "later": lambda: gm.matmul(a, b, ta, tb, out_dtype=o)}
        rec_path = gm.matmul_path(M, N, K, dt, ta, tb, a.data_ptr(),
                                  b.data_ptr(), o, gm.kernel_block(M, N, K,
                                                                   dt))
        run(f"matmul_{label}", calls,
            lambda: gm.matmul_plain(a, b, ta, tb, o),
            library(a, b, dt, ta, tb), M, N, K, dt, o)
        out[f"matmul_{label}"].update(
            path=rec_path, block=list(gm.kernel_block(M, N, K, dt)))
        del a, b
    # the fp8 pre-pass alone
    a, b = draw(torch, 2, torch.float8_e4m3fn, (4096, 4096), (4096, 4096))
    out["fp8_widen_4096"] = {
        "ms": cs.device_ms(torch, lambda: gm.fp8_widen(a, b), 20),
        "bound_ms": cs.mm_bound(0, 6 * a.numel(), cs.PEAK_BF16_FLOPS)[0]}
    del a, b
    # #42 at the carver's two top blocks
    ys_old = libs["yardstick_gemm"]["earlier"]
    for label, seed, (M, N, K), dt, o in (
            ("bf16_8192x8192x4096", 0, (8192, 8192, 4096), torch.bfloat16,
             torch.bfloat16),
            ("fp8_f32_4096", 2, (4096,) * 3, torch.float8_e4m3fn,
             torch.float32),
            ("f16_4096", 1, (4096,) * 3, torch.float16, torch.float16),
            ("f32_4096", 1, (4096,) * 3, torch.float32, torch.float32)):
        a, b = draw(torch, seed, dt, (M, K), (K, N))
        for h in MatmulTemplate(M, N, K, str(dt)[6:], arch=arch).hints(2):
            blk = (h.config["block_M"], h.config["block_N"],
                   h.config["block_K"])
            fn = ys.hand_matmul(M, N, K, *blk, dtype=dt, out_dtype=o)
            calls = {"earlier": lambda: old_yardstick(torch, ys_old, a, b,
                                                      blk, o),
                     "later": lambda: fn(a, b)}
            name = f"yardstick_gemm_{label}_{'x'.join(map(str, blk))}"
            run(name, calls, lambda: ys.hand_matmul_plain(a, b, o),
                library(a, b, dt), M, N, K, dt, o)
        del a, b
    out["ok"] = bool(ok)
    print(json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
