#!/usr/bin/env python3
"""Hold the row softmax (csrc/softmax.cu, #14) and the contiguous split-KV
decode (csrc/decode.cu, #7) against another version of their sources:
each against its plain version, the float32 decode bit for bit, the SASS
of the kernels that must not change, and the time of each in turns.

    python3 scripts/softmax_decode_ab.py EARLIER_CSRC [LATER_CSRC]
        [--out DIR] [--build DIR] [--others]

``EARLIER_CSRC`` and ``LATER_CSRC`` (by default this checkout's
``tilelang_mesh_tpu_torch/csrc``) are directories holding ``softmax.cu``,
``decode.cu`` and ``paged_decode.cu`` with their headers, for example a
parent commit's ``csrc`` from ``git archive`` unpacked under ``build/``.
The earlier build is called through its own C signatures
(``tl_softmax(x, y, M, N, in, out, stream)``, ``tl_decode`` for every
type); the later one through ``tl_softmax``'s path arguments and
``tl_decode_tma``. All builds run at once (nvcc, the port's flags).

Cases, at chip_smoke.py's main-path shapes and seeds:

* softmax (GPT_OSS): 4096 x 201088 float32 -> float32, 1024 x 201088
  bfloat16 -> float32, the router 4096 x 8 float32; each build held
  against ``softmax_plain`` (normwise 1e-5), timed in the order earlier,
  later, torch.softmax, later, earlier. The later build's register
  kernel is also timed at each lane group G of 1, 2, 4 and 8 at the
  router; its cluster kernel's fit (CTAs an SM, clusters at once) is read
  at both vocabulary cases, and the kernel timed there at each larger C
  and in the builds of ``SOFTMAX_VARIANTS`` (a copy of the later
  softmax.cu with another CTA size or count of bulk copies), in turns
  with the kept values; each build's cluster kernels' SASS is counted by
  opcode (``SASS_OPS``). The block kernel's rows (``BLOCK_CASES``) must
  give the same bits in both builds.
* decode (chip_smoke.py's decode_phase: B 8, H 32, S 8192, D 128, 8
  splits, K/V pages drawn by a device generator of seed 2 and gathered
  to contiguous rows) in float32, bfloat16 and float16, each build held
  against ``decode_partials_plain`` (rtol = atol = 1e-4), float32
  bit-equal across builds; timed earlier, later, SDPA, later, earlier;
  the 16-bit kernel also on the gather strategy's transposed view, and
  in the builds of ``VARIANTS`` (a copy of the later decode.cu with
  another ring or tile), in turns with the kept values. On the host's
  clock: each build's C call alone (``host_us``: the mean time a call
  takes to return, 200 calls queued back to back) and the gather
  strategy end to end (``gather_host_ms``: ``flash_decode_paged`` with
  its page gather and combine, its ``decode`` from each build, synced
  once after 20 calls), in the order earlier, later, later, earlier.

The SASS of ``split_kv_decode<D, 0, ...>`` (decode.cu's float32
instances) and of every function of ``paged_decode.cu`` must be the same
in both builds; with ``--others``
every other source whose header closure differs is built from both
directories and compared too (``scripts/nsa_ab.py``'s helpers; the first
differences go to DIR/sass_diffs). Bounds are bytes over 3.35 TB/s
(chip_smoke.py's). Prints one JSON line with the card's name and power
limit and each build's registers, and writes DIR/result.json; exits 1
when a check fails. Needs one NVIDIA card; exits non-zero without one.
"""

import argparse
import ctypes
import importlib
import json
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCES = ("softmax", "decode", "paged_decode")
# functions whose SASS must not change, by source (all of
# paged_decode.cu; softmax_block_rows changed with merge's NaN rule, so
# its bits are compared instead, at BLOCK_CASES)
KEPT = {"decode": r"split_kv_decodeILi\d+ELi0E",
        "paged_decode": r"."}
# (M, N, input type) of the block kernel, bit-equal across the builds
BLOCK_CASES = ((64, 60001, "float32"), (64, 49152, "bfloat16"),
               (64, 3000, "float32"))
# decode_tma builds timed beside the kept values: (label, the constants
# of decode.cu rewritten)
VARIANTS = (("ring48K_tile8K", {"kRingBytes": "48 * 1024"}),
            ("ring96K_tile16K", {"kRingBytes": "96 * 1024",
                                 "kTileBytes": "16 * 1024"}))
# softmax_cluster builds timed beside the kept values: (label, the
# constants of softmax.cu rewritten)
SOFTMAX_VARIANTS = (("threads128", {"kClusterThreads": "128"}),
                    ("threads512", {"kClusterThreads": "512"}),
                    ("chunks1", {"kChunks": "1"}),
                    ("chunks4", {"kChunks": "4"}))
# opcodes counted in each build's cluster kernels
SASS_OPS = ("MUFU.EX2", "LDS", "STG", "SYNCS", "BRA")
ROUTER_GROUPS = (1, 2, 4, 8)


def variant_dir(src_dir, name, label, consts, root):
    """A copy of ``src_dir`` under ``root/label`` whose ``name``.cu has
    each ``constexpr int`` of ``consts`` set to its value."""
    dst = root / label
    shutil.copytree(src_dir, dst)
    src = (dst / f"{name}.cu").read_text()
    for const, value in consts.items():
        src, n = re.subn(rf"(constexpr int {const} = )[^;]+;",
                         rf"\g<1>{value};", src)
        if n != 1:
            raise RuntimeError(f"{name}.cu: {n} definitions of {const}")
    (dst / f"{name}.cu").write_text(src)
    return dst


def nvcc_build(job):
    """(library, ptxas log, seconds) of one (src_dir, name, out)."""
    from tilelang_mesh_tpu_torch.ops import _build
    src_dir, name, out = job
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                          "-o", str(out), str(src_dir / f"{name}.cu")],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {out}:\n{res.stderr}")
    return out, res.stdout + res.stderr, time.perf_counter() - t0


def turns(cs, torch, calls, iters):
    """{tag: [ms, ...]} of ``calls`` timed earlier, later, library,
    later, earlier (the tags present)."""
    times = {}
    for tag in ("earlier", "later", "library", "later", "earlier"):
        if tag in calls:
            times.setdefault(tag, []).append(
                cs.device_ms(torch, calls[tag], iters))
    return times


def main() -> int:
    import torch
    import torch.nn.functional as F
    ap = argparse.ArgumentParser()
    ap.add_argument("earlier", type=Path)
    ap.add_argument("later", type=Path, nargs="?",
                    default=ROOT / "tilelang_mesh_tpu_torch" / "csrc")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "softmax_decode_ab" / "out")
    ap.add_argument("--build", type=Path,
                    default=ROOT / "build" / "softmax_decode_ab")
    ap.add_argument("--others", action="store_true",
                    help="also compare the SASS of every other source "
                         "whose header closure differs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("softmax_decode_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    import chip_smoke as cs
    import nsa_ab
    smx = importlib.import_module("tilelang_mesh_tpu_torch.ops.softmax")
    from tilelang_mesh_tpu_torch.ops import _build
    from tilelang_mesh_tpu_torch.ops import flash_decoding as fd
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
                        if p.stem not in SOURCES
                        and nsa_ab.closure(args.earlier, p.stem)
                        != nsa_ab.closure(args.later, p.stem))
    jobs = {(tag, n): (args.build / tag, n,
                       args.build / tag / f"lib{n}.so")
            for tag in dirs for n in SOURCES + tuple(others)}
    for src, variants in (("decode", VARIANTS),
                          ("softmax", SOFTMAX_VARIANTS)):
        for label, consts in variants:
            d = variant_dir(args.build / "later", src, f"{src}_{label}",
                            consts, args.build / "variants")
            jobs["later", f"{src}_{label}"] = (d, src,
                                               d / f"lib{src}.so")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(jobs)) as ex:
        built = dict(zip(jobs, ex.map(nvcc_build, jobs.values())))
    out = {"card": smi, "build_s": round(time.perf_counter() - t0, 1),
           "builds": {f"{t}/{n}": {"nvcc_s": round(b[2], 1),
                                   "registers_spills":
                                       cs.kernel_registers(b[1])}
                      for (t, n), b in built.items()
                      if n != "paged_decode" and n in SOURCES
                      or n.startswith(("decode_", "softmax_"))}}
    failed = []

    # -- SASS ---------------------------------------------------------------
    diff_dir = args.out / "sass_diffs"
    kept = {}
    for n in tuple(KEPT) + tuple(others):
        a, b = (nsa_ab.sass(built[tag, n][0]) for tag in dirs)
        pat = KEPT.get(n, r".")
        keep = [fn for fn in sorted(set(a) | set(b)) if re.search(pat, fn)]
        same = nsa_ab.same_sass({f: a.get(f) for f in keep},
                                {f: b.get(f) for f in keep},
                                diff_dir / f"{n}.diff")
        kept[n] = {"functions": len(keep), "same_sass": same}
        if not keep or not same:
            failed.append(f"{n}: {len(keep)} kept functions, SASS "
                          f"{'same' if same else 'differs'}")
    out["kept_sass"] = kept

    libs = {k: ctypes.CDLL(str(b[0])) for k, b in built.items()}
    out["cluster_sass"] = {}
    for (t, n), b in built.items():
        if t == "later" and n.startswith("softmax"):
            for fn, lines in nsa_ab.sass(b[0]).items():
                if "softmax_cluster" in fn:
                    out["cluster_sass"].setdefault(n, {})[fn[-60:]] = {
                        "lines": len(lines),
                        **{op: sum(op in ln for ln in lines)
                           for op in SASS_OPS}}

    def stream():
        return torch.cuda.current_stream().cuda_stream

    # -- softmax ------------------------------------------------------------
    def softmax_call(tag, x, out_dtype, path=None, lib="softmax"):
        M, N = x.shape
        y = torch.empty((M, N), dtype=out_dtype, device=x.device)
        fn = libs[tag, lib].tl_softmax
        codes = (smx.DTYPES[x.dtype], smx.DTYPES[out_dtype])
        if tag == "earlier":
            fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                           + [ctypes.c_void_p])
            extra = ()
        else:
            path = path or smx.softmax_path(N, x.dtype)
            fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
                           + [ctypes.c_void_p])
            extra = (path.code, path.param)
        fn.restype = ctypes.c_int
        code = fn(x.data_ptr(), y.data_ptr(), M, N, *codes, *extra,
                  stream())
        if code:
            raise RuntimeError(f"softmax {tag}: CUDA error {code}")
        return y

    c = cs.GPT_OSS
    gen = torch.Generator(device="cuda").manual_seed(9)
    out["softmax"] = {}
    for case, M, N, din in (
            ("vocab", c["vocab_rows"], c["vocab"], torch.float32),
            ("vocab_bf16", c["vocab_rows_bf16"], c["vocab"], torch.bfloat16),
            ("router", c["router_rows"], c["router_width"], torch.float32)):
        x = (4 * torch.randn((M, N), generator=gen, device="cuda")).to(din)
        want = smx.softmax_plain(x, torch.float32)
        path = smx.softmax_path(N, din)
        res = {"shape": [M, N], "in": str(din).replace("torch.", ""),
               "path": path.kernel, "param": path.param,
               "bound_ms": M * N * (x.element_size() + 4)
               / cs.PEAK_BYTES_S * 1e3, "bound_by": "bytes"}
        for tag in dirs:
            res[f"{tag}_normwise"] = cs.normwise_err(
                softmax_call(tag, x, torch.float32), want)[1]
            if not res[f"{tag}_normwise"] <= 1e-5:
                failed.append(f"softmax {case} {tag}: "
                              f"{res[f'{tag}_normwise']}")
        iters = 5 if N > 8 else 50
        res["ms"] = turns(cs, torch, {
            "earlier": lambda: softmax_call("earlier", x, torch.float32),
            "later": lambda: softmax_call("later", x, torch.float32),
            "library": lambda: torch.softmax(x, 1, dtype=torch.float32)},
            iters)
        if path.kernel == "softmax_cluster":
            res["cluster_fit"] = dict(zip(
                ("ctas_an_sm", "clusters"),
                smx.cluster_fit(N, din, torch.float32, path.param)))
            # the other builds of the cluster kernel, and every larger C
            others = {label: (f"softmax_{label}", path)
                      for label, _ in SOFTMAX_VARIANTS}
            others.update({f"C{C}": ("softmax", smx.SoftmaxPath(
                "softmax_cluster", C)) for C in smx.CLUSTER_SIZES
                if C > path.param})
            var = {}
            for label, (lib, p) in others.items():
                err = cs.normwise_err(softmax_call(
                    "later", x, torch.float32, p, lib), want)[1]
                if not err <= 1e-5:
                    failed.append(f"softmax {case} {label}: {err}")
                t = turns(cs, torch, {
                    "earlier": lambda: softmax_call("later", x,
                                                    torch.float32),
                    "later": lambda lib=lib, p=p: softmax_call(
                        "later", x, torch.float32, p, lib)}, iters)
                var[label] = {"variant_ms": t["later"],
                              "default_ms": t["earlier"]}
            res["variants"] = var
        if case == "router":
            sweep = {}
            for rnd in range(2):
                for g in ROUTER_GROUPS:
                    p = smx.SoftmaxPath("softmax_rows", g)
                    err = cs.normwise_err(softmax_call(
                        "later", x, torch.float32, p), want)[1]
                    if not err <= 1e-5:
                        failed.append(f"router G {g}: {err}")
                    sweep.setdefault(f"G{g}", []).append(
                        cs.device_ms(torch, lambda: softmax_call(
                            "later", x, torch.float32, p), 50))
            res["rows_sweep_ms"] = sweep
        out["softmax"][case] = res
        print(json.dumps({f"softmax_{case}": res}), flush=True)
        del x, want
        torch.cuda.empty_cache()

    out["block_bits_equal"] = {}
    for M, N, din in BLOCK_CASES:
        x = (4 * torch.randn((M, N), generator=gen, device="cuda")).to(
            getattr(torch, din))
        kernel = smx.softmax_path(N, x.dtype).kernel
        same = kernel == "softmax_block_rows" and torch.equal(
            *(softmax_call(tag, x, torch.float32) for tag in dirs))
        out["block_bits_equal"][f"{M}x{N} {din}"] = same
        if not same:
            failed.append(f"softmax block {M}x{N} {din} ({kernel}): the "
                          f"builds' outputs differ")

    # -- decode -------------------------------------------------------------
    def decode_call(key, q, k, v):
        B, H, _, D = q.shape
        S = k.shape[2]
        qf = q.reshape(B, H, D).float().contiguous()
        op = torch.empty((B, cs.N_SPLIT, H, D), device="cuda")
        mp = torch.empty((B, cs.N_SPLIT, H, 1), device="cuda")
        lp = torch.empty((B, cs.N_SPLIT, H, 1), device="cuda")
        lib = libs[key]
        tma = key[0] == "later" and k.dtype != torch.float32
        fn = lib.tl_decode_tma if tma else lib.tl_decode
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 3
                       + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        code = fn(qf.data_ptr(), k.data_ptr(), v.data_ptr(), op.data_ptr(),
                  mp.data_ptr(), lp.data_ptr(), B, H, S, D, cs.N_SPLIT,
                  *k.stride()[:3], DTYPE_CODES[k.dtype],
                  D ** -0.5 * 1.44269504, stream())
        if code:
            raise RuntimeError(f"decode {key}: CUDA error {code}")
        return op, mp, lp

    def host_us(call, n=200):
        """Mean host time of one call returning, n queued back to back."""
        call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            call()
        t = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        return t

    def host_ms(call, n=20):
        """Mean host time of a call, synced once after n."""
        call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            call()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    def gather_with(tag, q, kpages, vpages, table):
        """flash_decode_paged, its decode from ``tag``'s build (the
        earlier build's tl_decode takes every type)."""
        load, path = _build.load, fd.decode_path
        _build.load = lambda n: libs[tag, n] if n == "decode" else load(n)
        if tag == "earlier":
            fd.decode_path = lambda dtype: "split_kv_decode"
        try:
            return fd.flash_decode_paged(q, kpages, vpages, table,
                                         n_split=cs.N_SPLIT)
        finally:
            _build.load, fd.decode_path = load, path

    B, H, D, PS, PP = cs.B, cs.H, cs.D, cs.PS, cs.PP
    S = PP * PS
    out["decode"] = {}
    for name in ("float32", "bfloat16", "float16"):
        dtype = getattr(torch, name)
        g = torch.Generator(device="cuda").manual_seed(2)
        q = torch.randn((B, H, 1, D), generator=g, device="cuda")
        kpages, vpages = (torch.randn((cs.N_PAGES, PS, H, D), generator=g,
                                      device="cuda").to(dtype)
                          for _ in range(2))
        table = torch.stack([torch.randperm(cs.N_PAGES, generator=g,
                                            device="cuda")[:PP]
                             for _ in range(B)])
        kt = kpages[table].reshape(B, S, H, D).transpose(1, 2)   # gather
        vt = vpages[table].reshape(B, S, H, D).transpose(1, 2)   # view
        k, v = kt.contiguous(), vt.contiguous()
        want = fd.decode_partials_plain(q, k, v, cs.N_SPLIT, D ** -0.5)
        esize = k.element_size()
        nbytes = (2 * B * H * S * D * esize + q.numel() * 4
                  + sum(t.numel() * 4 for t in want))
        res = {"shape": [B, H, S, D], "n_split": cs.N_SPLIT,
               "path": fd.decode_path(dtype),
               "bound_ms": nbytes / cs.PEAK_BYTES_S * 1e3,
               "bound_by": "bytes"}
        got = {}
        for tag in dirs:
            got[tag] = decode_call((tag, "decode"), q, k, v)
            torch.cuda.synchronize()
            res[f"{tag}_max_rel_excess"] = max(
                cs.max_rel_excess(a, b) for a, b in zip(got[tag], want))
            if not res[f"{tag}_max_rel_excess"] <= 1.0:
                failed.append(f"decode {name} {tag}: "
                              f"{res[f'{tag}_max_rel_excess']}")
        res["bit_equal"] = all(torch.equal(a, b) for a, b in
                               zip(got["earlier"], got["later"]))
        if dtype == torch.float32 and not res["bit_equal"]:
            failed.append("decode float32: the builds' outputs differ")
        qd = q.to(dtype)
        res["ms"] = turns(cs, torch, {
            "earlier": lambda: decode_call(("earlier", "decode"), q, k, v),
            "later": lambda: decode_call(("later", "decode"), q, k, v),
            "library": lambda: F.scaled_dot_product_attention(qd, k, v)},
            20)
        if dtype != torch.float32:
            ex = max(cs.max_rel_excess(a, b) for a, b in zip(
                decode_call(("later", "decode"), q, kt, vt), want))
            if not ex <= 1.0:
                failed.append(f"decode {name} gather view: {ex}")
            res["gather_view_ms"] = turns(cs, torch, {
                "earlier": lambda: decode_call(("earlier", "decode"), q, kt,
                                               vt),
                "later": lambda: decode_call(("later", "decode"), q, kt,
                                             vt)}, 20)
        res["host_us"] = {}
        res["gather_host_ms"] = {}
        for tag in ("earlier", "later", "later", "earlier"):
            res["host_us"].setdefault(tag, []).append(host_us(
                lambda: decode_call((tag, "decode"), q, k, v)))
            res["gather_host_ms"].setdefault(tag, []).append(host_ms(
                lambda: gather_with(tag, q, kpages, vpages, table)))
        ex = max(cs.max_rel_excess(a, b) for a, b in zip(
            gather_with("later", q, kpages, vpages, table),
            gather_with("earlier", q, kpages, vpages, table)))
        if not ex <= 1.0:
            failed.append(f"decode {name} gather strategy: the builds "
                          f"differ by {ex}x the tolerance")
        if dtype != torch.float32:
            var = {}
            for label, _ in VARIANTS:
                key = ("later", f"decode_{label}")
                ex = max(cs.max_rel_excess(a, b) for a, b in
                         zip(decode_call(key, q, k, v), want))
                if not ex <= 1.0:
                    failed.append(f"decode variant {key[1]}: {ex}")
                t = turns(cs, torch, {
                    "earlier": lambda: decode_call(("later", "decode"), q, k,
                                                   v),
                    "later": lambda key=key: decode_call(key, q, k, v)}, 20)
                var[label] = {"variant_ms": t["later"],
                              "default_ms": t["earlier"]}
            res["variants"] = var
        out["decode"][name] = res
        print(json.dumps({f"decode_{name}": res}), flush=True)
        del q, k, v, kt, vt, kpages, vpages, want, got
        torch.cuda.empty_cache()

    out["failed"] = failed
    out["ok"] = not failed
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "result.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
