#!/usr/bin/env python3
"""Hold stream-K (#17, ``csrc/gemm_variants.cu``) and w4a8 (#24,
``csrc/dequant_gemm.cu``) against another version of their sources: the
time of each, in turns, at LLaMA-2-7B's 512-token prefill gate/up and at
``bench.py``'s w4a8 shape, and the w4a8 kernels' sweep over the rows.

    python3 scripts/streamk_w4a8_ab.py EARLIER_CSRC [LATER_CSRC] [--out DIR]

``EARLIER_CSRC`` (and ``LATER_CSRC``, by default this checkout's
``tilelang_mesh_tpu_torch/csrc``) are directories holding both sources
with their headers, for example a parent commit's ``csrc`` from ``git
archive`` unpacked under ``build/``. Both sources are built from both
directories with nvcc into ``DIR`` (default ``build/streamk_w4a8_ab``),
every build at once, beside the other sources on the changed headers
whose include closure differs. The later build is called through the
port's wrappers (``ops/gemm_variants.py::matmul_streamk``,
``ops/dequant_gemm.py::w4a8_gemm``: the path rules inside the timed
call); the earlier build through its C entry points as they were
(``tl_streamk_gemm`` + ``tl_streamk_fixup`` at its co-resident
programs, ``tl_w4a8_gemm``: the tile loops), so an earlier ``csrc``
needs those entries with their earlier arguments.

Cases: #17 in bf16 and f16 at M 512, K 4096 -> N 11008 (chip_smoke's
``LLAMA2``, draw seed 32), the later build at 128 x 128, 128 x 256 and
256 x 128 blocks (block_K 128), each against the earlier build's 128 x
128 (its largest tile), with the programs, segments and partial bytes,
the partials' and the fixup's times apart (the fixup's output equal to
the earlier build's on the same partials), and again at
``streamk_phase_programs``' count (the tile rows in phase); #24 at
4096^3 (``cfg_w4a8``'s draw, seed 9), the later TMA kernel's output
equal to the earlier loop's bits. Each output held against its plain
version (#17 1e-2 normwise, #24 1e-6), timed with chip_smoke.py's
``device_ms`` in turns (earlier, later, later, earlier), beside
``torch.matmul`` (#17), ``torch._int_mm`` on the unpacked weight and
bench's whole torch composition (#24), and the bound (chip_smoke's
``mm_bound``). Then the later build alone: #24 over the rows (1 to 4096
at K = N = 4096) on each path, forced through ``w4a8_path`` (the sweep
its rule rests on).

The kept kernels (the tile loops ``streamk_gemm``, ``w4a8_gemm``, and
every other function both builds of a source hold) must compile to the
same code or run as fast: each is compared in ``cuobjdump -sass``
(``scripts/nsa_ab.py``'s ``sass``; the differing lines go to
``DIR/sass_diffs``), and the two loops are timed through both builds' C
entries in turns (stream-K in f32 at the prefill, w4a8 at 4096^3),
within 2 % where the code differs. The other sources on the changed
headers (``gemm_sm90.cuh``, ``lowbit_sm90.cuh``) are compared in SASS;
one whose SASS differs is timed through its wrapper on both builds in
turns. Prints one JSON line with the card's name and power limit, each
build's nvcc seconds and each kernel's registers and spill stores
(``-Xptxas -v``); exits 1 when an output disagrees or a kept kernel's
code differs and its time too. Needs one NVIDIA card; exits non-zero
without one.
"""

import argparse
import contextlib
import ctypes
import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SOURCES = ("gemm_variants", "dequant_gemm")
# the other sources on the headers this change touches
SHARED = ("gemm", "yardstick_gemm", "grouped_gemm", "bitnet_gemm",
          "gemm_s8", "gemv", "dsa", "sparse_mla", "yardstick_w4a16")
STREAMK_BLOCKS = ((128, 128), (128, 256), (256, 128))
SWEEP_ROWS = (1, 16, 64, 128, 256, 512, 1024, 2048, 4096)

P, I = ctypes.c_void_p, ctypes.c_int


def entry(lib, name, argtypes):
    fn = getattr(lib, name)
    fn.argtypes = list(argtypes) + [P]
    fn.restype = I
    return fn


def old_streamk(torch, lib, a, b, n_prog, bm=128, bn=128, bk=128):
    """An earlier build's stream-K: ``tl_streamk_gemm`` over the port's
    plan at ``n_prog`` programs, then ``tl_streamk_fixup``, into a new
    C of a's type."""
    from tilelang_mesh_tpu_torch.ops import gemm_variants as gv
    from tilelang_mesh_tpu_torch.ops.gemm import DTYPE_CODES
    M, K = a.shape
    N = b.shape[1]
    tables, first, prog = gv._streamk_tables(M, N, K, n_prog, bm, bn, bk,
                                             a.device)
    part = torch.empty((tables.shape[1], bm, bn), device=a.device)
    c = torch.empty((M, N), dtype=a.dtype, device=a.device)
    s = torch.cuda.current_stream().cuda_stream
    code = entry(lib, "tl_streamk_gemm", [P] * 8 + [I] * 7)(
        a.data_ptr(), b.data_ptr(), *(tables[i].data_ptr() for i in
                                      range(4)), prog.data_ptr(),
        part.data_ptr(), prog.numel() - 1, N, K, bm, bn, bk,
        DTYPE_CODES[a.dtype], s)
    code = code or entry(lib, "tl_streamk_fixup", [P] * 3 + [I] * 5)(
        part.data_ptr(), first.data_ptr(), c.data_ptr(), M, N, bm, bn,
        DTYPE_CODES[a.dtype], s)
    if code:
        raise RuntimeError(f"earlier stream-K refused: {code}")
    return c


def old_programs(torch, lib, dtype):
    from tilelang_mesh_tpu_torch.ops.gemm import DTYPE_CODES
    fn = getattr(lib, "tl_streamk_blocks_per_sm")
    fn.argtypes = [I, ctypes.POINTER(ctypes.c_int)]
    fn.restype = I
    blocks = ctypes.c_int(0)
    if fn(DTYPE_CODES[dtype], ctypes.byref(blocks)):
        raise RuntimeError("earlier tl_streamk_blocks_per_sm refused")
    return torch.cuda.get_device_properties(0).multi_processor_count \
        * blocks.value


def old_w4a8(torch, lib, q, packed, sw, sa):
    """An earlier build's ``tl_w4a8_gemm`` (the tile loop) into a new C."""
    M = q.shape[0]
    K2, N = packed.shape
    c = torch.empty((M, N), device=q.device)
    code = entry(lib, "tl_w4a8_gemm", [P] * 5 + [I] * 3)(
        q.data_ptr(), packed.data_ptr(), sw.data_ptr(), sa.data_ptr(),
        c.data_ptr(), M, N, K2, torch.cuda.current_stream().cuda_stream)
    if code:
        raise RuntimeError(f"earlier tl_w4a8_gemm refused: {code}")
    return c


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("earlier", type=Path)
    ap.add_argument("later", type=Path, nargs="?",
                    default=ROOT / "tilelang_mesh_tpu_torch" / "csrc")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "streamk_w4a8_ab")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("streamk_w4a8_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    import chip_smoke as cs
    from nsa_ab import build, closure, same_sass, sass
    from tilelang_mesh_tpu_torch.ops import _build
    from tilelang_mesh_tpu_torch.ops import bitnet as bn
    from tilelang_mesh_tpu_torch.ops import dequant_gemm as dq
    from tilelang_mesh_tpu_torch.ops import gemm as gm
    from tilelang_mesh_tpu_torch.ops import gemm_variants as gv
    from tilelang_mesh_tpu_torch.ops import grouped_gemm as gg
    from tilelang_mesh_tpu_torch.ops import yardsticks as ys
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
    kept = {}
    for n in SOURCES:
        old, new = sass(built["earlier", n][0]), sass(built["later", n][0])
        common = sorted(set(old) & set(new))
        kept[n] = {"functions": len(common), "same_sass": same_sass(
            {f: old[f] for f in common}, {f: new[f] for f in common},
            args.out / "sass_diffs" / f"{n}_kept.diff")}
    timed_libs = list(SOURCES) + [n for n, v in shared.items()
                                  if v == "SASS differs"]
    libs = {n: {tag: ctypes.CDLL(str(built[tag, n][0])) for tag in dirs}
            for n in timed_libs}
    builds = {n: {tag: {"nvcc_s": round(built[tag, n][2], 1),
                        "registers_spills": cs.kernel_registers(
                            built[tag, n][1])} for tag in dirs}
              for n in SOURCES}
    load = _build.load
    use = {n: "later" for n in libs}
    _build.load = lambda name: (libs[name][use[name]] if name in libs
                                else load(name))
    out = {"card": smi, "shared_sources": shared, "kept_kernels": kept,
           "builds": builds}
    ok = True
    print("sources:", json.dumps({"shared": shared, "kept": kept}),
          flush=True)

    def turns(calls, iters):
        times = {"earlier": [], "later": []}
        for tag in ("earlier", "later", "later", "earlier"):
            times[tag].append(cs.device_ms(torch, calls[tag], iters))
        return times

    def ratio(t):
        return (sum(t["later"]) / len(t["later"])) / (
            sum(t["earlier"]) / len(t["earlier"]))

    @contextlib.contextmanager
    def on(name, tag):
        """The wrappers call ``tag``'s build of ``name``."""
        use[name] = tag
        try:
            yield
        finally:
            use[name] = "later"

    # -- the kept loops through both builds' C entries, in turns ---------
    kept_times = {}
    M, K, N = cs.LLAMA2["prefill_chunk"], cs.LLAMA2["hidden"], \
        cs.LLAMA2["inter"]
    a32, b32 = (torch.from_numpy(x).cuda() for x in cs.draw_np(
        32, (M, K), (K, N)))
    n_old = old_programs(torch, libs["gemm_variants"]["earlier"],
                         torch.float32)
    t = turns({tag: (lambda tag=tag: old_streamk(
        torch, libs["gemm_variants"][tag], a32, b32, n_old))
        for tag in dirs}, 5)
    kept_times["streamk_gemm_f32_prefill"] = {
        "source": "gemm_variants", "ms": t, "later_over_earlier": ratio(t)}
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((4096, 4096)).astype(
        np.float32)).cuda()
    p_np, sw_np = dq.quantize_w4_per_channel(
        rng.standard_normal((4096, 4096)).astype(np.float32) * 0.1)
    packed, sw = torch.from_numpy(p_np).cuda(), torch.from_numpy(
        sw_np).cuda()
    q, s = dq.quantize_activations(x)
    sa = (1.0 / s).float()
    t = turns({tag: (lambda tag=tag: old_w4a8(
        torch, libs["dequant_gemm"][tag], q, packed, sw, sa))
        for tag in dirs}, 5)
    kept_times["w4a8_gemm_loop_4096"] = {
        "source": "dequant_gemm", "ms": t, "later_over_earlier": ratio(t)}
    for n, v in kept.items():
        within = all(abs(k["later_over_earlier"] - 1) <= 0.02
                     for k in kept_times.values() if k["source"] == n)
        v["within_2_percent"] = within
        ok &= v["same_sass"] or within
    # a shared source whose SASS differs: its wrapper on both builds
    shared_calls = {
        "gemm": lambda: gm.matmul(a16, b16),
        "yardstick_gemm": lambda: yard(a16, b16),
        "grouped_gemm": lambda: gg.grouped_matmul(xe, we),
        "bitnet_gemm": lambda: bn.bitnet_gemm(a8, t8)}
    a16, b16 = (torch.from_numpy(v).cuda().to(torch.bfloat16)
                for v in cs.draw_np(0, (4096, 4096), (4096, 4096)))
    yard = ys.hand_matmul(4096, 4096, 4096, 128, 256, 64, "bfloat16")
    xe, we = (torch.from_numpy(v).cuda().to(torch.bfloat16)
              for v in cs.draw_np(6, (8, 512, 2048), (8, 2048, 2048)))
    a8 = torch.from_numpy(rng.integers(-128, 128, (4096, 2560)).astype(
        np.int8)).cuda()
    t8 = torch.from_numpy(bn.pack_ternary(rng.integers(
        -1, 2, (2560, 6912)).astype(np.int8))).cuda()
    for n, v in shared.items():
        if v != "SASS differs":
            continue
        if n not in shared_calls:
            ok = False          # differs, and no wrapper here to time it
            continue

        def call(tag, n=n):
            with on(n, tag):
                return shared_calls[n]()
        t = turns({tag: (lambda tag=tag: call(tag)) for tag in dirs}, 5)
        kept_times[f"{n}_wrapper"] = {"source": n, "ms": t,
                                      "later_over_earlier": ratio(t)}
        ok &= abs(ratio(t) - 1) <= 0.02
    out["kept_times"] = kept_times
    print("kept", json.dumps(kept_times), flush=True)
    del a32, b32, a16, b16, xe, we, a8, t8
    torch.cuda.empty_cache()

    # -- #17 in bf16 and f16: the TMA path's three tiles -----------------
    for dt in (torch.bfloat16, torch.float16):
        a, b = (torch.from_numpy(v).cuda().to(dt)
                for v in cs.draw_np(32, (M, K), (K, N)))
        n_old = old_programs(torch, libs["gemm_variants"]["earlier"], dt)
        old_plain = gv.matmul_streamk_plain(a, b, n_old)
        earlier = cs.normwise_err(old_streamk(
            torch, libs["gemm_variants"]["earlier"], a, b, n_old),
            old_plain)[1]
        del old_plain
        lib_ms = cs.device_ms(torch, lambda: torch.matmul(a, b), 5)
        bound, by = cs.mm_bound(2 * M * N * K, (M * K + K * N + M * N) * 2,
                                cs.PEAK_BF16_FLOPS)
        for bm, bn_ in STREAMK_BLOCKS:
            blocks = dict(block_M=bm, block_N=bn_, block_K=128)
            n_prog = gv.streamk_programs(a.device, dt, **blocks)
            tables, first, prog = gv._streamk_tables(
                M, N, K, n_prog, bm, bn_, 128, a.device)
            n_seg = int(tables.shape[1])
            path = gv.streamk_path(M, N, K, dt, bm, bn_, 128, a.data_ptr(),
                                   b.data_ptr())
            got = gv.matmul_streamk(a, b, n_programs=n_prog, **blocks)
            rec = {"shape": [M, N, K], "dtype": str(dt)[6:],
                   "block": [bm, bn_, 128], "path": path,
                   "n_programs": n_prog, "n_segments": n_seg,
                   "partial_bytes": n_seg * bm * bn_ * 4,
                   "earlier_block": [128, 128, 128],
                   "earlier_n_programs": n_old,
                   "earlier_normwise": earlier,
                   "later_normwise": cs.normwise_err(
                       got, gv.matmul_streamk_plain(
                           a, b, n_prog, bm, bn_, 128))[1]}
            ok &= rec["later_normwise"] <= 1e-2 and earlier <= 1e-2
            del got
            rec["ms"] = turns({
                "earlier": lambda: old_streamk(
                    torch, libs["gemm_variants"]["earlier"], a, b, n_old),
                "later": lambda: gv.matmul_streamk(
                    a, b, n_programs=n_prog, **blocks)}, 10)
            part = gv._streamk_partials_launch(a, b, tables, prog, bm, bn_,
                                               128)
            rec["partials_ms"] = cs.device_ms(
                torch, lambda: gv._streamk_partials_launch(
                    a, b, tables, prog, bm, bn_, 128), 10)
            c = torch.empty((M, N), dtype=dt, device="cuda")
            fix = entry(libs["gemm_variants"]["later"], "tl_streamk_fixup",
                        [P] * 3 + [I] * 5)
            rec["fixup_ms"] = cs.device_ms(torch, lambda: fix(
                part.data_ptr(), first.data_ptr(), c.data_ptr(), M, N, bm,
                bn_, 1 if dt == torch.bfloat16 else 3,
                torch.cuda.current_stream().cuda_stream), 10)
            # the earlier build's fixup on the same partials, and the
            # programs in phase across the tile rows
            old_fix = entry(libs["gemm_variants"]["earlier"],
                            "tl_streamk_fixup", [P] * 3 + [I] * 5)
            c_old = torch.empty_like(c)
            rec["earlier_fixup_ms"] = cs.device_ms(torch, lambda: old_fix(
                part.data_ptr(), first.data_ptr(), c_old.data_ptr(), M, N,
                bm, bn_, 1 if dt == torch.bfloat16 else 3,
                torch.cuda.current_stream().cuda_stream), 10)
            rec["fixup_equal_bits"] = bool(torch.equal(c, c_old))
            ok &= rec["fixup_equal_bits"]
            n_ph = gv.streamk_phase_programs(M, N, K, bm, bn_, 128, n_prog)
            tph, fph, pph = gv._streamk_tables(M, N, K, n_ph, bm, bn_, 128,
                                               a.device)
            rec["phase_n_programs"] = n_ph
            rec["phase_n_segments"] = int(tph.shape[1])
            rec["phase_ms"] = cs.device_ms(torch, lambda: gv.matmul_streamk(
                a, b, n_programs=n_ph, **blocks), 10)
            rec["phase_partials_ms"] = cs.device_ms(
                torch, lambda: gv._streamk_partials_launch(
                    a, b, tph, pph, bm, bn_, 128), 10)
            rec["phase_normwise"] = cs.normwise_err(gv.matmul_streamk(
                a, b, n_programs=n_ph, **blocks), gv.matmul_streamk_plain(
                    a, b, n_ph, bm, bn_, 128))[1]
            ok &= rec["phase_normwise"] <= 1e-2
            rec.update(library_ms=lib_ms, library=f"torch.matmul in "
                       f"{str(dt)[6:]}", bound_ms=bound, bound_by=by)
            name = f"streamk_{str(dt)[6:]}_{bm}x{bn_}"
            out[name] = rec
            print(name, json.dumps(rec), flush=True)
            del part, c, c_old
        del a, b
        torch.cuda.empty_cache()

    # -- #24 at 4096^3: the TMA kernel against the earlier loop ----------
    Mw = Nw = Kw = 4096
    want = dq.w4a8_gemm_plain(q, packed, sw, sa)
    old_c = old_w4a8(torch, libs["dequant_gemm"]["earlier"], q, packed, sw,
                     sa)
    new_c = dq.w4a8_gemm(q, packed, sw, sa)
    rec = {"shape": [Mw, Nw, Kw], "path": dq.w4a8_path(
        Mw, Nw, Kw // 2, q.data_ptr(), packed.data_ptr(), sw.data_ptr()),
        "earlier_normwise": cs.normwise_err(old_c, want)[1],
        "later_normwise": cs.normwise_err(new_c, want)[1],
        "equal_bits": bool(torch.equal(old_c, new_c))}
    ok &= rec["later_normwise"] <= 1e-6 and rec["equal_bits"]
    del want, old_c, new_c
    rec["ms"] = turns({
        "earlier": lambda: old_w4a8(torch, libs["dequant_gemm"]["earlier"],
                                    q, packed, sw, sa),
        "later": lambda: dq.w4a8_gemm(q, packed, sw, sa)}, 10)
    p32 = packed.to(torch.int32)
    lo, hi = ((p32 & 0xF) - 8).to(torch.int8), ((p32 >> 4) - 8).to(
        torch.int8)
    wd8 = torch.cat([lo, hi]).T.contiguous().T
    rec["library_ms"] = cs.device_ms(torch, lambda: torch._int_mm(q, wd8),
                                     10)
    rec["library"] = ("torch._int_mm on the unpacked int8 weight (no "
                      "unpack, no epilogue)")
    K2 = Kw // 2

    def composition():        # bench.py's reference, as cfg_w4a8 runs it
        p = packed.to(torch.int32)
        lo_ = ((p & 0xF) - 8).to(torch.int8).T.contiguous().T
        hi_ = ((p >> 4) - 8).to(torch.int8).T.contiguous().T
        acc = torch._int_mm(q[:, :K2], lo_) + torch._int_mm(q[:, K2:], hi_)
        return acc.float() * sa.reshape(-1, 1) * sw.reshape(1, -1)
    rec["torch_composition_ms"] = cs.device_ms(torch, composition, 10)
    rec["bound_ms"], rec["bound_by"] = cs.mm_bound(
        2 * Mw * Nw * Kw, Mw * Kw + Kw * Nw // 2 + 4 * (Nw + Mw)
        + 4 * Mw * Nw, cs.PEAK_8BIT_OPS)
    out["w4a8_4096"] = rec
    print("w4a8_4096", json.dumps(rec), flush=True)
    del lo, hi, wd8, p32

    # -- the later build over the rows, each path forced -----------------
    sweep = {}
    keep = dq.w4a8_path
    for Mr in SWEEP_ROWS:
        qr = q[:Mr].contiguous()
        sr = sa[:Mr].contiguous()
        times = {}
        for path in ("loop", "tma"):
            dq.w4a8_path = lambda *x, path=path: path
            try:
                times[path] = cs.device_ms(torch, lambda: dq.w4a8_gemm(
                    qr, packed, sw, sr), 20 if Mr <= 256 else 10)
            finally:
                dq.w4a8_path = keep
        sweep[f"w4a8_M{Mr}"] = times
    out["sweep"] = sweep
    print("sweep", json.dumps(sweep), flush=True)
    out["ok"] = bool(ok)
    print(json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
