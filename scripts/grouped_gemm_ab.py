#!/usr/bin/env python3
"""Hold the grouped GEMMs (#20 and #21, ``csrc/grouped_gemm.cu``) against
another version of their source: the time of each, in turns, at the MoE
layer's expert products (Mixtral-8x7B's widths, chip_smoke.py's
``MOE_FULL``), and the layer's forward.

    python3 scripts/grouped_gemm_ab.py EARLIER_CSRC [LATER_CSRC] [--out DIR]
                                       [--wrappers]

``EARLIER_CSRC`` (and ``LATER_CSRC``, by default this checkout's
``tilelang_mesh_tpu_torch/csrc``) are directories holding
``grouped_gemm.cu`` with its headers, for example a parent commit's
``csrc`` from ``git archive`` unpacked under ``build/``. Both are built
with nvcc into ``DIR`` (default ``build/grouped_gemm_ab``), at once. The
later build is called through the port's wrappers
(``ops/grouped_gemm.py``: the path rule, the block and the tables inside
the timed call); the earlier build through its C entry points
``tl_grouped_gemm`` and ``tl_varlen_grouped_gemm`` as they were (the
block tile loop, tables at 128 rows), so an earlier source needs those
entries with their earlier arguments. With ``--wrappers`` the earlier
build is called through the port's wrappers too, each call's kernel
taken from its own build: for an earlier source with this one's C
entries, so that the kernels each path rule names are held against
their earlier versions.

Cases, in float32, bfloat16 and float16: the dense product at the
layer's two expert shapes, (8, 1280, 4096) @ (8, 4096, 14336) and (8,
1280, 14336) @ (8, 14336, 4096), inputs ``torch.randn`` from a seeded
generator on the card (W scaled by K^-1/2); the token-sorted product on
the routed rows of the ``MOE_FULL`` batch (8192 rows in eight groups, K
4096, N 14336), B in both layouts. Each output is held against its plain
version (chip_smoke.py's ``GEMM_TOL``: 1e-5 normwise in float32, 1e-2 in
16 bits) and timed with chip_smoke.py's ``device_ms`` in turns (earlier,
later, later, earlier), beside one PyTorch call computing the same
function (``torch.bmm``; ``torch.matmul`` a group on the routed rows) in
the operands' type and the bound: chip_smoke.py's ``gemm_bound``, for
float32 the lesser of the FFMA time and three TF32 passes. Then the
later build alone: the bf16 dense products at each block of
``TL_SM90_BLOCKS`` (the hint forced through ``grouped_matmul``); and
the MoE layer's forward (``make_moe_layer``, one rank) at ``MOE_FULL`` in
float32 and bfloat16 on each build in turns (the earlier one's grouped
GEMM swapped in through ``parallel/moe.py``'s ``grouped_matmul``), the
median of five calls on the host clock, after a warm-up.

The earlier build's kernels that the later source keeps (the loop's
``grouped_gemm`` and ``varlen_grouped_gemm`` instances) must compile to
the same code: each function present in both builds is compared in
``cuobjdump -sass`` (``scripts/nsa_ab.py``'s ``sass``; the differing
lines go to ``DIR/sass_diffs``), and their outputs at a misaligned shape
(K 4095, whose bf16 rows are off 16 bytes) must be bit-equal, and their
times in turns within 2 % where the code differs. Prints one JSON line
with the card's name and power limit, each build's nvcc seconds, each
kernel's registers and spill stores (``-Xptxas -v``) and ptxas's
warnings (a serialised ``wgmma`` among them); exits 1 when an
output disagrees with its plain version or a kept kernel differs. Needs
one NVIDIA card; exits non-zero without one.
"""

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KEPT = ("12grouped_gemmI", "19varlen_grouped_gemmI")
P, I = ctypes.c_void_p, ctypes.c_int
TYPES = ("float32", "bfloat16", "float16")


def old_dense(torch, lib, x, w):
    """An earlier build's ``tl_grouped_gemm`` into a new O."""
    from tilelang_mesh_tpu_torch.ops.gemm import DTYPE_CODES
    x, w = x.contiguous(), w.contiguous()
    E, M, K = x.shape
    N = w.shape[2]
    o = torch.empty((E, M, N), dtype=x.dtype, device=x.device)
    fn = lib.tl_grouped_gemm
    fn.argtypes = [P] * 3 + [I] * 5 + [P]
    fn.restype = I
    code = fn(x.data_ptr(), w.data_ptr(), o.data_ptr(), E, M, N, K,
              DTYPE_CODES[x.dtype], torch.cuda.current_stream().cuda_stream)
    if code:
        raise RuntimeError(f"earlier tl_grouped_gemm refused: {code}")
    return o


def old_varlen(torch, lib, a, b, sizes, trans_b, tables):
    """An earlier build's ``tl_varlen_grouped_gemm`` on the device tables
    [blk_exp | blk_row | ends] at 128 rows a block."""
    from tilelang_mesh_tpu_torch.ops.gemm import DTYPE_CODES
    K = a.shape[1]
    N = b.shape[1] if trans_b else b.shape[2]
    TB = (tables.numel() - len(sizes)) // 2
    c = torch.empty((a.shape[0], N), device=a.device)
    fn = lib.tl_varlen_grouped_gemm
    fn.argtypes = [P] * 6 + [I] * 5 + [P]
    fn.restype = I
    base = tables.data_ptr()
    code = fn(a.data_ptr(), b.data_ptr(), base, base + 4 * TB,
              base + 8 * TB, c.data_ptr(), TB, N, K, int(trans_b),
              DTYPE_CODES[a.dtype], torch.cuda.current_stream().cuda_stream)
    if code:
        raise RuntimeError(f"earlier tl_varlen_grouped_gemm refused: {code}")
    return c


def main() -> int:
    import numpy as np
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("earlier", type=Path)
    ap.add_argument("later", type=Path, nargs="?",
                    default=ROOT / "tilelang_mesh_tpu_torch" / "csrc")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "grouped_gemm_ab")
    ap.add_argument("--wrappers", action="store_true",
                    help="call the earlier build through the wrappers too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("grouped_gemm_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    import chip_smoke as cs
    from nsa_ab import build, same_sass, sass
    from tilelang_mesh_tpu_torch.carver import KERNEL_BLOCKS
    from tilelang_mesh_tpu_torch.ops import _build
    from tilelang_mesh_tpu_torch.ops import grouped_gemm as gg
    from tilelang_mesh_tpu_torch.parallel import moe
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
    jobs = [(tag, dirs[tag], "grouped_gemm", args.out) for tag in dirs]
    with ThreadPoolExecutor(max_workers=len(jobs)) as ex:
        built = dict(zip(dirs, ex.map(build, jobs)))
    old_f, new_f = sass(built["earlier"][0]), sass(built["later"][0])
    common = sorted(f for f in set(old_f) & set(new_f)
                    if any(k in f for k in KEPT))
    kept = {"functions": len(common), "same_sass": same_sass(
        {f: old_f[f] for f in common}, {f: new_f[f] for f in common},
        args.out / "sass_diffs" / "grouped_gemm_kept.diff")}
    libs = {tag: ctypes.CDLL(str(built[tag][0])) for tag in dirs}
    load = _build.load
    current = ["later"]             # the build the wrappers call
    _build.load = lambda name: (libs[current[0]] if name == "grouped_gemm"
                                else load(name))

    def via(tag, call):
        """call() with the wrappers on build ``tag``."""
        current[0] = tag
        try:
            return call()
        finally:
            current[0] = "later"
    out = {"card": smi, "wrappers": args.wrappers,
           "kept_kernels": kept, "builds": {
        tag: {"nvcc_s": round(built[tag][2], 1),
              "registers_spills": cs.kernel_registers(built[tag][1]),
              "ptxas_warnings": [ln for ln in built[tag][1].splitlines()
                                 if "warning" in ln.lower()]}
        for tag in dirs}}
    print("kept:", json.dumps(kept), flush=True)
    ok = True

    def turns(calls, iters):
        times = {"earlier": [], "later": []}
        for tag in ("earlier", "later", "later", "earlier"):
            times[tag].append(cs.device_ms(torch, calls[tag], iters))
        return times

    c = cs.MOE_FULL
    E, d, f, C = c["experts"], c["d"], c["f"], cs.moe_capacity()
    x, wr = cs.moe_inputs(torch, weights=False)
    _, dispatch = moe.route(x, wr, c["top_k"], C)
    sizes = [int(s) for s in dispatch.sum((0, 2)).long().tolist()]
    routed = torch.einsum("td,tec->ecd", x, dispatch)
    routed = torch.cat([routed[e, :s] for e, s in enumerate(sizes)])
    del x, wr, dispatch
    exp_blk, row_blk, _ = gg._varlen_meta(sizes, 128)
    old_tables = torch.from_numpy(np.concatenate(
        [exp_blk, row_blk, np.cumsum(sizes).astype(np.int32)])).cuda()
    starts = [sum(sizes[:e]) for e in range(E)]
    out["sizes"] = sizes
    g = torch.Generator(device="cuda").manual_seed(4)

    def rnd(shape, dt, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda")
                * scale).to(dt)

    for name in TYPES:
        dt = getattr(torch, name)
        tol = cs.GEMM_TOL[name]
        esize = torch.empty((), dtype=dt).element_size()
        for label, (M, K, N) in (("w1", (C, d, f)), ("w2", (C, f, d))):
            a, b = rnd((E, M, K), dt), rnd((E, K, N), dt, K ** -0.5)
            want = gg.grouped_matmul_plain(a, b)
            calls = {"earlier": lambda: via(
                "earlier", lambda: gg.grouped_matmul(a, b))
                if args.wrappers else old_dense(torch, libs["earlier"], a, b),
                     "later": lambda: gg.grouped_matmul(a, b)}
            rec = {"shape": [E, M, K, N], "dtype": name,
                   "path": gg.grouped_path(dt, M, N, K, a.data_ptr(),
                                           b.data_ptr())}
            rec["block"] = list(gg.grouped_block(rec["path"], M, N, K, dt))
            for tag, call in calls.items():
                rec[f"{tag}_normwise"] = cs.normwise_err(call(), want)[1]
            ok &= rec["later_normwise"] <= tol
            rec["ms"] = turns(calls, 3)
            rec["library_ms"] = cs.device_ms(torch, lambda: torch.bmm(a, b),
                                             3)
            rec["library"] = f"torch.bmm in {name}"
            flops = 2 * E * M * N * K
            nbytes = (E * M * K + E * K * N + E * M * N) * esize
            rec["bound_ms"], rec["bound_by"] = cs.gemm_bound(
                torch, dt, flops, nbytes)
            out[f"grouped_gemm_{label}_{name}"] = rec
            print(f"grouped_gemm_{label}_{name}", json.dumps(rec),
                  flush=True)
            if name == "bfloat16":      # each block of the set, forced
                blocks = {}
                for blk in sorted(KERNEL_BLOCKS):
                    blocks["x".join(map(str, blk))] = cs.device_ms(
                        torch, lambda: gg.grouped_matmul(a, b, *blk), 3)
                out[f"grouped_gemm_{label}_blocks"] = blocks
                print("blocks", label, json.dumps(blocks), flush=True)
            del a, b, want
            torch.cuda.empty_cache()

        A = routed.to(dt)
        rows = A.shape[0]
        B = rnd((E, d, f), dt, d ** -0.5)
        for trans_b in (False, True):
            Bb = B.transpose(1, 2).contiguous() if trans_b else B
            want = gg.varlen_grouped_matmul_plain(A, Bb, sizes, trans_b)
            calls = {"earlier": lambda: via(
                "earlier", lambda: gg.varlen_grouped_matmul(
                    A, Bb, sizes, trans_b=trans_b))
                if args.wrappers else old_varlen(
                    torch, libs["earlier"], A, Bb, sizes, trans_b,
                    old_tables),
                "later": lambda: gg.varlen_grouped_matmul(
                    A, Bb, sizes, trans_b=trans_b)}
            rec = {"rows": rows, "K": d, "N": f, "dtype": name,
                   "trans_b": trans_b,
                   "path": gg.grouped_path(dt, max(sizes), f, d,
                                           A.data_ptr(), Bb.data_ptr(),
                                           trans_b)}
            rec["block"] = list(gg.grouped_block(
                rec["path"], gg.varlen_rows(sizes), f, d, dt))
            for tag, call in calls.items():
                rec[f"{tag}_normwise"] = cs.normwise_err(call(), want)[1]
            ok &= rec["later_normwise"] <= tol
            rec["ms"] = turns(calls, 3)
            rec["library_ms"] = cs.device_ms(torch, lambda: [
                A[s0:s0 + n] @ (Bb[e].t() if trans_b else Bb[e])
                for e, (s0, n) in enumerate(zip(starts, sizes)) if n], 3)
            rec["library"] = f"torch.matmul a group in {name}"
            flops = 2 * rows * d * f
            nbytes = (rows * d + E * d * f) * esize + rows * f * 4
            rec["bound_ms"], rec["bound_by"] = cs.gemm_bound(
                torch, dt, flops, nbytes)
            key = f"varlen_{'trans_' if trans_b else ''}{name}"
            out[key] = rec
            print(key, json.dumps(rec), flush=True)
            del want, Bb
        del A, B
        torch.cuda.empty_cache()

    # the kept loop at a misaligned shape: the same bits, the same time
    kept_times = {}
    a = rnd((E, C, d - 1), torch.bfloat16)
    b = rnd((E, d - 1, f), torch.bfloat16, d ** -0.5)
    check = gg.grouped_path(torch.bfloat16, C, f, d - 1, a.data_ptr(),
                            b.data_ptr())
    calls = {tag: (lambda tag=tag: old_dense(torch, libs[tag], a, b))
             for tag in dirs}
    kept["loop_path"] = check
    kept["bit_equal"] = bool(torch.equal(calls["earlier"](),
                                         calls["later"]()))
    before = gg.launches["grouped_gemm"]
    kept["entry_bit_equal"] = bool(torch.equal(calls["earlier"](),
                                               gg.grouped_matmul(a, b)))
    kept["entry_loop_launches"] = gg.launches["grouped_gemm"] - before
    t = turns(calls, 3)
    mean = {k: sum(v) / len(v) for k, v in t.items()}
    kept_times["grouped_gemm_loop_bf16_k4095"] = t
    kept["later_over_earlier"] = mean["later"] / mean["earlier"]
    kept["within_2_percent"] = abs(kept["later_over_earlier"] - 1) <= 0.02
    ok &= check == "loop" and kept["bit_equal"] and kept["entry_bit_equal"]
    ok &= kept["entry_loop_launches"] == 1
    ok &= kept["same_sass"] or kept["within_2_percent"]
    out["kept_times"] = kept_times
    del a, b
    torch.cuda.empty_cache()
    print("kept:", json.dumps(kept), flush=True)

    # the MoE layer's forward on each build, in turns
    layer_ms = {}
    for name in ("float32", "bfloat16"):
        dt = getattr(torch, name)
        x, wr, w1, w2 = (t.to(dt) for t in cs.moe_inputs(torch))
        layer = moe.make_moe_layer(None, top_k=c["top_k"],
                                   capacity_factor=c["capacity_factor"])
        kernel_gemm = moe.grouped_matmul
        gemms = {"earlier": lambda a, b, **kw: via(
            "earlier", lambda: kernel_gemm(a, b, **kw)) if args.wrappers
            else old_dense(torch, libs["earlier"], a, b),
            "later": kernel_gemm}

        def forward(tag):
            moe.grouped_matmul = gemms[tag]
            try:
                layer(x, wr, w1, w2)          # warm-up
                times = []
                for _ in range(5):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    layer(x, wr, w1, w2)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                return sorted(times)[2]
            finally:
                moe.grouped_matmul = kernel_gemm

        layer_ms[name] = {"earlier": [], "later": []}
        for tag in ("earlier", "later", "later", "earlier"):
            layer_ms[name][tag].append(forward(tag))
        print("moe forward", name, json.dumps(layer_ms[name]), flush=True)
        del x, wr, w1, w2
        torch.cuda.empty_cache()
    out["moe_forward_ms_median"] = layer_ms
    out["ok"] = bool(ok)
    print(json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
