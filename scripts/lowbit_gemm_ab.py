#!/usr/bin/env python3
"""Hold the low-bit GEMMs (#26 ``csrc/bitnet_gemm.cu``, #22
``csrc/dequant_gemm.cu``) against another version of their sources: the
time of each, in turns, at BitNet b1.58-2B-4T's FFN products and at
``bench.py``'s w4a16 shapes.

    python3 scripts/lowbit_gemm_ab.py EARLIER_CSRC [LATER_CSRC] [--out DIR]

``EARLIER_CSRC`` (and ``LATER_CSRC``, by default this checkout's
``tilelang_mesh_tpu_torch/csrc``) are directories holding both sources
with their headers, for example a parent commit's ``csrc`` from ``git
archive`` unpacked under ``build/``. Both sources are built from both
directories with nvcc into ``DIR`` (default ``build/lowbit_gemm_ab``), all
four builds at once. The later build is called through the port's
wrappers (``ops/bitnet.py::bitnet_gemm``, ``ops/dequant_gemm.py::
dequant_matmul``: the path rule, the split-K plan and the combine inside
the timed call); the earlier build through its C entry points as they
were (``tl_bitnet_gemm``, ``tl_dequant_gemm``: the block tile loop for
every shape), so an earlier ``csrc`` needs those two entries with their
earlier arguments.

Cases: #26 on int8 activations and ternary weights drawn from
``default_rng`` at the FFN's prefill gate/up (M 4096, K 2560 -> N 6912)
and down (K 6912 -> N 2560) and its decode gate/up (M 1); #22 in bf16 and
f16 at the decode step (M 16, K 4096 -> N 11008, group 128; chip_smoke's
``LLAMA2_MLP``) and at 4096^3 group 512 (``cfg_w4a16``'s draw, seed 3).
Each output is held against its plain version (#26 equal, #22 1e-2
normwise) and timed with chip_smoke.py's ``device_ms`` in turns (earlier,
later, later, earlier), beside one PyTorch call computing the same
product (``torch._int_mm`` on the unpacked weight, 32 padded rows at
decode; ``torch.matmul`` on the dequantised weight, which reads four
times the weight bytes and does no unpack), the port's two-pass path for
#22 (``dequant_matmul_twopass``: #23 then #15's TMA kernel) and the bound
(chip_smoke's ``mm_bound``). Then the later build alone, each path forced
through the wrappers' rule functions, over the rows around each
threshold: #26's split-K against its TMA kernel, #22's split-K against
its TMA kernel, and the TMA kernel's two tiles.

The earlier build's kernels that these sources keep (the block tile
loops, #23 ``dequant_int4``, #24 ``w4a8_gemm``) must compile to the same
code or run as fast: each function present in both builds is compared in
``cuobjdump -sass`` (``scripts/nsa_ab.py``'s ``sass``; the differing
lines go to ``DIR/sass_diffs``), and each kept kernel is timed through
both builds' C entry points in turns (#23 at bench's 4096^3 group 512 in
bf16, #24 at 4096^3, the w4a16 loop in f32 at the decode step and in
bf16 at 4096^3, the ternary loop at the prefill gate/up), within 2 % of
the earlier build where the code differs. The other sources on the
shared GEMM headers are "same bytes" when their include closure is
unchanged, and compared in SASS otherwise. Prints one JSON line with the
card's name and power limit, each build's nvcc seconds and each kernel's
registers and spill stores (``-Xptxas -v``); exits 1 when an output
disagrees with its plain version or a kept kernel's code differs and its
time too. Needs one NVIDIA card; exits non-zero without one.
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
SOURCES = ("bitnet_gemm", "dequant_gemm")
# the other sources on the GEMM headers bitnet_gemm.cu and dequant_gemm.cu
# include (gemm_tile.cuh, gemm_dense.cuh, gemm_sm90.cuh)
SHARED = ("gemm", "yardstick_gemm", "grouped_gemm", "gemm_s8",
          "gemm_variants", "dsa", "gemv", "sparse_mla", "yardstick_w4a16")
BITNET_CASES = (("prefill_gate_up", 4096, 2560, 6912),
                ("prefill_down", 4096, 6912, 2560),
                ("decode_gate_up", 1, 2560, 6912))


def old_bitnet(torch, lib, a, packed):
    """An earlier build's ``tl_bitnet_gemm`` into a new C."""
    M, K = a.shape
    N = packed.shape[1]
    c = torch.empty((M, N), dtype=torch.int32, device=a.device)
    fn = lib.tl_bitnet_gemm
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = fn(a.data_ptr(), packed.data_ptr(), c.data_ptr(), M, N, K,
              torch.cuda.current_stream().cuda_stream)
    if code:
        raise RuntimeError(f"earlier tl_bitnet_gemm refused: {code}")
    return c


def old_dequant(torch, lib, a, packed, scales, gs):
    """An earlier build's ``tl_dequant_gemm`` into a new C."""
    from tilelang_mesh_tpu_torch.ops.gemm import DTYPE_CODES
    M = a.shape[0]
    K2, N = packed.shape
    c = torch.empty((M, N), dtype=a.dtype, device=a.device)
    fn = lib.tl_dequant_gemm
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = fn(a.data_ptr(), packed.data_ptr(), scales.data_ptr(),
              c.data_ptr(), M, N, K2, gs, DTYPE_CODES[a.dtype],
              torch.cuda.current_stream().cuda_stream)
    if code:
        raise RuntimeError(f"earlier tl_dequant_gemm refused: {code}")
    return c


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("earlier", type=Path)
    ap.add_argument("later", type=Path, nargs="?",
                    default=ROOT / "tilelang_mesh_tpu_torch" / "csrc")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "lowbit_gemm_ab")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("lowbit_gemm_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    import chip_smoke as cs
    from nsa_ab import build, closure, same_sass, sass
    from tilelang_mesh_tpu_torch.ops import _build
    from tilelang_mesh_tpu_torch.ops import bitnet as bn
    from tilelang_mesh_tpu_torch.ops import dequant_gemm as dq
    from tilelang_mesh_tpu_torch.quantize import quantize_int4_planar
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print("card:", smi, flush=True)
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
    # the kernels both builds of a source hold: the same code
    kept = {}
    for n in SOURCES:
        old, new = sass(built["earlier", n][0]), sass(built["later", n][0])
        common = sorted(set(old) & set(new))
        kept[n] = {"functions": len(common), "same_sass": same_sass(
            {f: old[f] for f in common}, {f: new[f] for f in common},
            args.out / "sass_diffs" / f"{n}_kept.diff")}
    libs = {n: {tag: ctypes.CDLL(str(built[tag, n][0])) for tag in dirs}
            for n in SOURCES}
    builds = {n: {tag: {"nvcc_s": round(built[tag, n][2], 1),
                        "registers_spills": cs.kernel_registers(
                            built[tag, n][1])} for tag in dirs}
              for n in SOURCES}
    load = _build.load
    _build.load = lambda name: (libs[name]["later"] if name in libs
                                else load(name))
    out = {"card": smi, "shared_sources": shared, "kept_kernels": kept,
           "builds": builds}
    ok = all(v != "SASS differs" for v in shared.values())
    print("sources:", json.dumps({"shared": shared, "kept": kept}),
          flush=True)

    def turns(calls, iters):
        times = {"earlier": [], "later": []}
        for tag in ("earlier", "later", "later", "earlier"):
            times[tag].append(cs.device_ms(torch, calls[tag], iters))
        return times

    # -- the kept kernels through both builds' C entries, in turns -------
    kept_times = {}
    stream = torch.cuda.current_stream().cuda_stream
    P, I = ctypes.c_void_p, ctypes.c_int

    def entry(src, name, nptr, nint):
        fns = {}
        for tag in dirs:
            fn = getattr(libs[src][tag], name)
            fn.argtypes = [P] * nptr + [I] * nint + [P]
            fn.restype = I
            fns[tag] = fn
        return fns

    def kept_case(label, src, name, nptr, nint, args, iters):
        """``name`` of ``src`` through both builds, in turns."""
        fns = entry(src, name, nptr, nint)

        def call(tag):
            code = fns[tag](*args(), stream)
            if code:
                raise RuntimeError(f"{tag} {label} refused: {code}")
        t = turns({tag: (lambda tag=tag: call(tag)) for tag in dirs}, iters)
        mean = {k: sum(v) / len(v) for k, v in t.items()}
        kept_times[label] = {"source": src, "ms": t, "later_over_earlier":
                             mean["later"] / mean["earlier"]}
        print("kept", label, json.dumps(kept_times[label]), flush=True)

    rng = np.random.default_rng(5)
    K2, N, gs = 2048, 4096, 512
    p_np, s_np = quantize_int4_planar(rng.standard_normal(
        (2 * K2, N)).astype(np.float32) * 0.1, group_size=gs)
    kp, ks = torch.from_numpy(p_np).cuda(), torch.from_numpy(s_np).cuda()
    bd = torch.empty((2 * K2, N), dtype=torch.bfloat16, device="cuda")
    kept_case("dequant_int4_4096_gs512", "dequant_gemm", "tl_dequant_int4",
              3, 4, lambda: (kp.data_ptr(), ks.data_ptr(), bd.data_ptr(),
                             K2, N, gs, 1), 20)
    q = torch.from_numpy(rng.integers(-128, 128, (4096, 2 * K2)).astype(
        np.int8)).cuda()
    sw = torch.rand(N, device="cuda")
    sa = torch.rand(4096, device="cuda")
    c32 = torch.empty((4096, N), device="cuda")
    kept_case("w4a8_gemm_4096", "dequant_gemm", "tl_w4a8_gemm", 5, 3,
              lambda: (q.data_ptr(), kp.data_ptr(), sw.data_ptr(),
                       sa.data_ptr(), c32.data_ptr(), 4096, N, K2), 5)
    a16 = (torch.randn((4096, 2 * K2), device="cuda") * 0.1).to(
        torch.bfloat16)
    c16 = torch.empty((4096, N), dtype=torch.bfloat16, device="cuda")
    loop = ("dequant_gemm", "tl_dequant_gemm", 4, 5)
    kept_case("dequant_gemm_loop_bf16_4096_gs512", *loop,
              lambda: (a16.data_ptr(), kp.data_ptr(), ks.data_ptr(),
                       c16.data_ptr(), 4096, N, K2, gs, 1), 5)
    mlp = cs.LLAMA2_MLP
    p_np, s_np = quantize_int4_planar(rng.standard_normal(
        (mlp["K"], mlp["N"])).astype(np.float32) * 0.1,
        group_size=mlp["gs"])
    dp, ds = torch.from_numpy(p_np).cuda(), torch.from_numpy(s_np).cuda()
    a32 = torch.randn((mlp["M"], mlp["K"]), device="cuda") * 0.1
    cd = torch.empty((mlp["M"], mlp["N"]), device="cuda")
    kept_case("dequant_gemm_loop_f32_decode", *loop,
              lambda: (a32.data_ptr(), dp.data_ptr(), ds.data_ptr(),
                       cd.data_ptr(), mlp["M"], mlp["N"], mlp["K"] // 2,
                       mlp["gs"], 0), 20)
    a8 = torch.from_numpy(rng.integers(-128, 128, (4096, 2560)).astype(
        np.int8)).cuda()
    t8 = torch.from_numpy(bn.pack_ternary(rng.integers(
        -1, 2, (2560, 6912)).astype(np.int8))).cuda()
    ci = torch.empty((4096, 6912), dtype=torch.int32, device="cuda")
    kept_case("bitnet_gemm_loop_prefill_gate_up", "bitnet_gemm",
              "tl_bitnet_gemm", 3, 3, lambda: (
                  a8.data_ptr(), t8.data_ptr(), ci.data_ptr(), 4096, 6912,
                  2560), 5)
    out["kept_times"] = kept_times
    for n, v in kept.items():
        # the same code, or every kept kernel of the source within 2 %
        within = all(abs(t["later_over_earlier"] - 1) <= 0.02
                     for t in kept_times.values() if t["source"] == n)
        v["within_2_percent"] = within
        ok &= v["same_sass"] or within
    del kp, ks, bd, q, sw, sa, c32, a16, c16, dp, ds, a32, cd, a8, t8, ci
    torch.cuda.empty_cache()

    # -- #26 at the FFN's three products ---------------------------------
    rng = np.random.default_rng(0)
    for label, M, K, N in BITNET_CASES:
        a = torch.from_numpy(rng.integers(-128, 128, (M, K)).astype(
            np.int8)).cuda()
        w8 = rng.integers(-1, 2, (K, N)).astype(np.int8)
        packed = torch.from_numpy(bn.pack_ternary(w8)).cuda()
        want = bn.bitnet_gemm_plain(a, packed)
        rec = {"shape": [M, N, K], "path": bn.bitnet_path(
            M, N, K, a.data_ptr(), packed.data_ptr())}
        calls = {"earlier": lambda: old_bitnet(torch, libs["bitnet_gemm"][
            "earlier"], a, packed), "later": lambda: bn.bitnet_gemm(a, packed)}
        for tag, call in calls.items():
            rec[f"{tag}_equal"] = bool(torch.equal(call(), want))
        ok &= rec["earlier_equal"] and rec["later_equal"]
        rec["ms"] = turns(calls, 5 if M > 1 else 50)
        a_lib = a if M > 16 else torch.cat([a, a.new_zeros((32 - M, K))])
        w_lib = torch.from_numpy(w8).cuda().T.contiguous().T
        rec["library_ms"] = cs.device_ms(
            torch, lambda: torch._int_mm(a_lib, w_lib), 5 if M > 1 else 50)
        rec["library"] = "torch._int_mm on the unpacked int8 weight" + (
            "" if M > 16 else " (padded to 32 rows)")
        rec["bound_ms"], rec["bound_by"] = cs.mm_bound(
            2 * M * N * K, M * K + K // 4 * N + 4 * M * N, cs.PEAK_8BIT_OPS)
        out[f"bitnet_gemm_{label}"] = rec
        print(f"bitnet_gemm_{label}", json.dumps(rec), flush=True)
        del a, packed, want, w_lib, a_lib
        torch.cuda.empty_cache()

    # -- #22 in bf16 and f16 at the decode step and at 4096^3 ------------
    mlp = cs.LLAMA2_MLP
    for label, (M, K, N, gs), seed in (
            ("decode_m16_k4096_n11008_gs128",
             (mlp["M"], mlp["K"], mlp["N"], mlp["gs"]), 14),
            ("4096_gs512", (4096, 4096, 4096, 512), 3)):
        rng = np.random.default_rng(seed)
        a32 = (rng.standard_normal((M, K)) * 0.1).astype(np.float32)
        w = rng.standard_normal((K, N)).astype(np.float32) * 0.1
        p_np, s_np = quantize_int4_planar(w, group_size=gs)
        packed = torch.from_numpy(p_np).cuda()
        scales = torch.from_numpy(s_np).cuda()
        del w
        for dt in (torch.bfloat16, torch.float16):
            a = torch.from_numpy(a32).cuda().to(dt)
            want = dq.dequant_matmul_plain(a, packed, scales, gs)
            rec = {"shape": [M, N, K], "group_size": gs,
                   "dtype": str(dt)[6:], "path": dq.dequant_path(
                       M, N, K // 2, gs, dt, a.data_ptr(), packed.data_ptr(),
                       scales.data_ptr())}
            calls = {"earlier": lambda: old_dequant(
                torch, libs["dequant_gemm"]["earlier"], a, packed, scales,
                gs), "later": lambda: dq.dequant_matmul(
                    a, packed, scales, group_size=gs, block_K2=gs)}
            for tag, call in calls.items():
                rec[f"{tag}_normwise"] = cs.normwise_err(call(), want)[1]
            ok &= rec["later_normwise"] <= 1e-2
            iters = 20 if M <= 16 else 5
            rec["ms"] = turns(calls, iters)
            bd = dq.dequant_int4_plain(packed, scales, gs, dt)
            rec["library_ms"] = cs.device_ms(
                torch, lambda: torch.matmul(a, bd), iters)
            rec["library"] = ("torch.matmul on the dequantised weight (no "
                              "unpack)")
            rec["twopass_ms"] = cs.device_ms(
                torch, lambda: dq.dequant_matmul_twopass(
                    a, packed, scales, dq_block=gs), iters)
            nbytes = (M * K * 2 + K // 2 * N + scales.numel() * 4
                      + M * N * 2)
            rec["bound_ms"], rec["bound_by"] = cs.mm_bound(
                2 * M * N * K, nbytes, cs.PEAK_BF16_FLOPS)
            name = f"dequant_gemm_{label}_{str(dt)[6:]}"
            out[name] = rec
            print(name, json.dumps(rec), flush=True)
            del a, want, bd
            torch.cuda.empty_cache()
        del packed, scales

    # -- the later build around each threshold, paths forced -------------
    def forced(mod, rule, path, call, iters):
        keep = getattr(mod, rule)
        setattr(mod, rule, lambda *x, **k: path)
        try:
            return cs.device_ms(torch, call, iters)
        finally:
            setattr(mod, rule, keep)

    sweep = {}
    rng = np.random.default_rng(1)
    K, N = 2560, 6912
    packed = torch.from_numpy(bn.pack_ternary(rng.integers(
        -1, 2, (K, N)).astype(np.int8))).cuda()
    for M in (1, 2, 4, 8, 9, 10, 12, 16, 32):
        a = torch.from_numpy(rng.integers(-128, 128, (M, K)).astype(
            np.int8)).cuda()
        sweep[f"bitnet_M{M}"] = {p: forced(bn, "bitnet_path", p, lambda:
                                           bn.bitnet_gemm(a, packed), 20)
                                 for p in ("splitk", "wgmma")}
    rng = np.random.default_rng(2)
    K, N, gs = 4096, 11008, 128
    p_np, s_np = quantize_int4_planar(rng.standard_normal((K, N)).astype(
        np.float32) * 0.1, group_size=gs)
    packed, scales = torch.from_numpy(p_np).cuda(), torch.from_numpy(
        s_np).cuda()
    for M in (1, 8, 16, 17, 32, 128):
        a = (torch.from_numpy(rng.standard_normal((M, K)).astype(
            np.float32)).cuda() * 0.1).to(torch.bfloat16)
        call = lambda: dq.dequant_matmul(a, packed, scales, group_size=gs,
                                         block_K2=gs)
        sweep[f"dequant_M{M}"] = {p: forced(dq, "dequant_path", p, call, 20)
                                  for p in (("splitk", "wgmma") if M <= 16
                                            else ("wgmma",))}
    K = N = 4096
    gs = 512
    p_np, s_np = quantize_int4_planar(rng.standard_normal((K, N)).astype(
        np.float32) * 0.1, group_size=gs)
    packed, scales = torch.from_numpy(p_np).cuda(), torch.from_numpy(
        s_np).cuda()
    for M in (512, 1024, 2048, 4096):
        a = (torch.from_numpy(rng.standard_normal((M, K)).astype(
            np.float32)).cuda() * 0.1).to(torch.bfloat16)
        call = lambda: dq.dequant_matmul(a, packed, scales, group_size=gs,
                                         block_K2=gs)
        sweep[f"dequant_tile_M{M}"] = {
            "x".join(map(str, t)): forced(dq, "dequant_wgmma_tile", t, call,
                                          10)
            for t in ((128, 128, 64), (256, 128, 32))}
    out["sweep"] = sweep
    print("sweep", json.dumps(sweep), flush=True)
    out["ok"] = bool(ok)
    print(json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
