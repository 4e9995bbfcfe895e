#!/usr/bin/env python3
"""Hold attention with sinks (#13 ``csrc/attention_sink.cu``) and split-K
(#16 ``csrc/gemm_variants.cu``) against another version of their
sources: the time of each, in turns, at gpt-oss-20b's attention and at
LLaMA-2-7B's decode MLP products.

    python3 scripts/sink_splitk_ab.py EARLIER_CSRC [LATER_CSRC] [--out DIR]

``EARLIER_CSRC`` (and ``LATER_CSRC``, by default this checkout's
``tilelang_mesh_tpu_torch/csrc``) are directories holding both sources
with their headers, for example a parent commit's ``csrc`` from ``git
archive`` unpacked under ``build/``. Both sources are built from both
directories with nvcc into ``DIR`` (default ``build/sink_splitk_ab``), all
four builds at once. The later build is called through the port's
wrappers (``ops/attention_sink.py::sink_fwd``, ``ops/gemm_variants.py::
matmul_splitk``: the tile rule, the path rule, the plan and the combine
inside the timed call); the earlier build through its C entry points as
they were (``tl_sink_fwd``; ``tl_splitk_gemm`` then ``tl_splitk_reduce``),
so an earlier ``csrc`` needs those entries with their earlier arguments.

Cases: #13 at chip_smoke.py's ``GPT_OSS`` widths (B 1, Hq 64 / Hkv 8, S
4096, D 64; inputs standard_normal from default_rng(5)), full causal and
window 128, in bf16 and f16; #16 at ``LLAMA2``'s decode step (M 16): the
gate/up product (K 4096 -> N 11008) in bf16 and f32 and the down product
(K 11008 -> N 4096) in bf16, 8 splits asked. Each output is held against
its plain version (#13 2e-2 normwise; #16 1e-2 in 16 bits, 1e-5 in f32)
and timed with chip_smoke.py's ``device_ms`` in turns (earlier, later,
later, earlier), beside one PyTorch call computing the same function
(SDPA with a zero sink key and the sinks in its mask, chip_smoke.py's
``sink_sdpa``; ``torch.matmul``) and the bound (chip_smoke.py's
``mm_bound``). Then the later build alone: #13 at each tile of D 64's
tensor-core set, full causal and window 128 (the tile rule forced
through ``sink_tile``); #16's two paths forced through ``splitk_path``
over M 1, 8, 16, 32, 48 and 64 at both products, bf16 and f32; and the
few-row path's two launches timed apart (``tl_splitk_stream`` and
``tl_splitk_stream_combine`` through ctypes at the wrapper's plan) at M 1
and 16, bf16, with the weights' rate in the first.

The earlier build's kernels that these sources keep (f32 ``sink_fwd``,
``splitk_gemm``, ``splitk_reduce``, ``streamk_gemm``, ``streamk_fixup``,
``blocksparse_gemm``) must compile to the same code or run as fast: each
function present in both builds is compared in ``cuobjdump -sass``
(``scripts/nsa_ab.py``'s ``sass``; the differing lines go to
``DIR/sass_diffs``), and f32 ``sink_fwd`` (full causal) and the
``splitk_gemm`` loop (M 128 at the gate/up product, bf16) are timed
through both builds' C entry points in turns, within 2 % where the code
differs. Prints one JSON line with the card's name and power limit, each
build's nvcc seconds and each kernel's registers and spill stores
(``-Xptxas -v``); exits 1 when an output disagrees with its plain version
or a kept kernel's code differs and its time too. Needs one NVIDIA card;
exits non-zero without one.
"""

import argparse
import ctypes
import importlib
import json
import math
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SOURCES = ("attention_sink", "gemm_variants")
# the kept kernels by their mangled names' length-prefixed fragments
KEPT = ("8sink_fwdI", "11splitk_gemmI", "13splitk_reduce", "12streamk_gemmI",
        "13streamk_fixup", "16blocksparse_gemmI")
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def old_sink(torch, lib, q, k, v, sinks, causal, window, sm_scale):
    """An earlier build's ``tl_sink_fwd`` into a new O."""
    from tilelang_mesh_tpu_torch.ops.gemm import DTYPE_CODES
    B, Hq, Sq, D = q.shape
    o = torch.empty_like(q)
    fn = lib.tl_sink_fwd
    fn.argtypes = [P] * 5 + [I] * 9 + [F, P]
    fn.restype = I
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), sinks.data_ptr(),
              o.data_ptr(), B, Hq, k.shape[1], Sq, k.shape[2], D,
              DTYPE_CODES[q.dtype], int(causal), int(window),
              float(sm_scale) * 1.44269504,
              torch.cuda.current_stream().cuda_stream)
    if code:
        raise RuntimeError(f"earlier tl_sink_fwd refused: {code}")
    return o


def old_splitk(torch, lib, a, b, n_split, out):
    """An earlier build's ``tl_splitk_gemm`` and ``tl_splitk_reduce``."""
    from tilelang_mesh_tpu_torch.ops.gemm import DTYPE_CODES
    M, K = a.shape
    N = b.shape[1]
    ws = torch.empty((n_split, M, N), device=a.device)
    c = torch.empty((M, N), dtype=out, device=a.device)
    st = torch.cuda.current_stream().cuda_stream
    g = lib.tl_splitk_gemm
    g.argtypes = [P] * 3 + [I] * 6 + [P]
    g.restype = I
    r = lib.tl_splitk_reduce
    r.argtypes = [P, P, ctypes.c_longlong, I, I, P]
    r.restype = I
    code = g(a.data_ptr(), b.data_ptr(), ws.data_ptr(), M, N, K, n_split,
             K // n_split, DTYPE_CODES[a.dtype], st) or r(
        ws.data_ptr(), c.data_ptr(), M * N, n_split, DTYPE_CODES[out], st)
    if code:
        raise RuntimeError(f"earlier split-K refused: {code}")
    return c


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("earlier", type=Path)
    ap.add_argument("later", type=Path, nargs="?",
                    default=ROOT / "tilelang_mesh_tpu_torch" / "csrc")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "sink_splitk_ab")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sink_splitk_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    import chip_smoke as cs
    from nsa_ab import build, same_sass, sass
    from tilelang_mesh_tpu_torch.ops import _build
    # ops/__init__ shadows the attention_sink module with its function
    sk = importlib.import_module("tilelang_mesh_tpu_torch.ops.attention_sink")
    gv = importlib.import_module("tilelang_mesh_tpu_torch.ops.gemm_variants")
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
    jobs = [(tag, dirs[tag], n, args.out) for n in SOURCES for tag in dirs]
    with ThreadPoolExecutor(max_workers=len(jobs)) as ex:
        built = dict(zip([(j[0], j[2]) for j in jobs], ex.map(build, jobs)))
    kept = {}
    for n in SOURCES:
        old, new = sass(built["earlier", n][0]), sass(built["later", n][0])
        common = sorted(f for f in set(old) & set(new)
                        if any(k in f for k in KEPT))
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
    out = {"card": smi, "kept_kernels": kept, "builds": builds}
    print("kept:", json.dumps(kept), flush=True)
    ok = True

    def turns(calls, iters):
        times = {"earlier": [], "later": []}
        for tag in ("earlier", "later", "later", "earlier"):
            times[tag].append(cs.device_ms(torch, calls[tag], iters))
        return times

    def forced(mod, rule, value, call, iters):
        keep = getattr(mod, rule)
        setattr(mod, rule, lambda *x, **k: value)
        try:
            return cs.device_ms(torch, call, iters)
        finally:
            setattr(mod, rule, keep)

    # -- #13 at gpt-oss-20b's attention ----------------------------------
    c = cs.GPT_OSS
    Hq, Hkv, D, S, W = (c["heads"], c["kv_heads"], c["head_dim"], c["seq"],
                        c["window"])
    sm = 1.0 / math.sqrt(D)
    rng = np.random.default_rng(5)
    base = [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
            for shape in ((1, Hq, S, D), (1, Hkv, S, D), (1, Hkv, S, D),
                          (1, Hq, S, D), (Hq,))]
    sinks = base[4].cuda()
    pairs = {0: cs.causal_pairs(S, S),
             W: sum(min(i + 1, W) for i in range(S))}
    kept_times = {}
    tiles = {}
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        name = str(dt)[6:]
        q, k, v = (t.cuda().to(dt) for t in base[:3])
        esize = q.element_size()
        io_bytes = (2 * Hq + 2 * Hkv) * S * D * esize + 4 * Hq
        peak = cs.PEAK_F32_FLOPS if dt == torch.float32 else \
            cs.PEAK_BF16_FLOPS
        for window in (0, W):
            label = f"attention_sink_{'window128' if window else 'causal'}"
            want = sk.sink_fwd_plain(q, k, v, sinks, True, window, sm)
            calls = {"earlier": lambda: old_sink(
                torch, libs["attention_sink"]["earlier"], q, k, v, sinks,
                True, window, sm), "later": lambda: sk.sink_fwd(
                    q, k, v, sinks, True, window, sm)}
            rec = {"shape": [1, Hq, Hkv, S, D], "window": window,
                   "dtype": name}
            for tag, call in calls.items():
                rec[f"{tag}_normwise"] = cs.normwise_err(call(), want)[1]
            if dt == torch.float32:     # the kept kernel: the same bits
                rec["bit_equal"] = bool(torch.equal(calls["earlier"](),
                                                    calls["later"]()))
                ok &= rec["bit_equal"]
            ok &= rec["later_normwise"] <= cs.ATTN_TOL[name]
            rec["ms"] = turns(calls, 5 if window == 0 else 20)
            if dt == torch.float32:
                mean = {t: sum(x) / len(x) for t, x in rec["ms"].items()}
                kept_times[f"sink_fwd_f32_{window}"] = \
                    mean["later"] / mean["earlier"]
            else:
                rec["tile"] = list(sk.sink_tile(D, window))
            rec.update(cs.sink_sdpa(torch, sk, q, k, v, sinks, window,
                                    want))
            rec["bound_ms"], rec["bound_by"] = cs.mm_bound(
                4 * D * pairs[window] * Hq, io_bytes, peak)
            out[f"{label}_{name}"] = rec
            print(f"{label}_{name}", json.dumps(rec), flush=True)
            del want
            torch.cuda.empty_cache()
            if dt == torch.bfloat16:    # every tile of the set, forced
                call = lambda: sk.sink_fwd(q, k, v, sinks, True, window, sm)
                tiles[f"{name}_{window}"] = {
                    f"{bm}x{bn}": forced(sk, "sink_tile", (bm, bn), call,
                                         5 if window == 0 else 20)
                    for bm, bn in ((128, 64), (64, 64), (64, 128),
                                   (128, 32))}
                print("tiles", name, window, json.dumps(
                    tiles[f"{name}_{window}"]), flush=True)
        del q, k, v
    out["sink_tiles"] = tiles

    # -- #16 at LLaMA-2-7B's decode step ---------------------------------
    M, hid, inter = cs.LLAMA2["decode"], cs.LLAMA2["hidden"], \
        cs.LLAMA2["inter"]
    n_ask = cs.LLAMA2["n_split"]
    tol = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
    for label, (K, N), dt, seed in (
            ("decode_gate_up_bf16", (hid, inter), torch.bfloat16, 30),
            ("decode_down_bf16", (inter, hid), torch.bfloat16, 31),
            ("decode_gate_up_f32", (hid, inter), torch.float32, 30)):
        a, b = [torch.from_numpy(x).cuda().to(dt)
                for x in cs.draw_np(seed, (M, K), (K, N))]
        want = gv.matmul_splitk_plain(a, b, n_split=n_ask)
        n_split = gv.splitk_plan(K, n_ask)[0]
        calls = {"earlier": lambda: old_splitk(
            torch, libs["gemm_variants"]["earlier"], a, b, n_split, dt),
            "later": lambda: gv.matmul_splitk(a, b, n_split=n_ask)}
        rec = {"shape": [M, N, K], "n_split": n_split, "path":
               gv.splitk_path(M, N, K, dt, a.data_ptr(), b.data_ptr()),
               "plan": gv.splitk_stream_plan(
                   N, n_split, K // n_split, gv.stream_slots(a.device, M, dt))}
        for tag, call in calls.items():
            rec[f"{tag}_normwise"] = cs.normwise_err(call(), want)[1]
        ok &= rec["later_normwise"] <= tol[dt]
        rec["bit_equal_twice"] = bool(torch.equal(calls["later"](),
                                                  calls["later"]()))
        ok &= rec["bit_equal_twice"]
        rec["ms"] = turns(calls, 20)
        rec["library_ms"] = cs.device_ms(torch, lambda: torch.matmul(a, b),
                                         20)
        rec["library"] = f"torch.matmul in {str(dt)[6:]}"
        peak = cs.PEAK_F32_FLOPS if dt == torch.float32 else \
            cs.PEAK_BF16_FLOPS
        rec["bound_ms"], rec["bound_by"] = cs.mm_bound(
            2 * M * N * K, (M * K + K * N + M * N) * a.element_size(), peak)
        out[f"splitk_{label}"] = rec
        print(f"splitk_{label}", json.dumps(rec), flush=True)
        del a, b, want
    # the kept tile loop past the threshold, both builds in turns
    a, b = [torch.from_numpy(x).cuda().to(torch.bfloat16)
            for x in cs.draw_np(32, (128, hid), (hid, inter))]
    t = turns({"earlier": lambda: old_splitk(
        torch, libs["gemm_variants"]["earlier"], a, b, 8, torch.bfloat16),
        "later": lambda: old_splitk(torch, libs["gemm_variants"]["later"],
                                    a, b, 8, torch.bfloat16)}, 20)
    mean = {k: sum(x) / len(x) for k, x in t.items()}
    kept_times["splitk_gemm_loop_m128"] = mean["later"] / mean["earlier"]
    out["kept_times"] = kept_times
    for n, v in kept.items():
        v["within_2_percent"] = all(
            abs(r - 1) <= 0.02 for key, r in kept_times.items()
            if (key.startswith("sink") == (n == "attention_sink")))
        ok &= v["same_sass"] or v["within_2_percent"]
    print("kept times", json.dumps(kept_times), flush=True)

    # -- the later build's two paths around the threshold ----------------
    sweep = {}
    for label, (K, N), dt in (("gate_up_bf16", (hid, inter), torch.bfloat16),
                              ("down_bf16", (inter, hid), torch.bfloat16),
                              ("gate_up_f32", (hid, inter), torch.float32)):
        b = torch.randn((K, N), device="cuda").to(dt)
        for m in (1, 8, 16, 32, 48, 64):
            a = torch.randn((m, K), device="cuda").to(dt)
            call = lambda: gv.matmul_splitk(a, b, n_split=n_ask)
            sweep[f"{label}_M{m}"] = {
                p: forced(gv, "splitk_path", p, call, 20)
                for p in ("stream", "tile")}
            sweep[f"{label}_M{m}"]["library"] = cs.device_ms(
                torch, lambda: torch.matmul(a, b), 20)
        print("sweep", label, json.dumps(
            {k: v for k, v in sweep.items() if k.startswith(label)}),
            flush=True)
    out["sweep"] = sweep

    # -- the later build's few-row path in its two launches --------------
    lib = libs["gemm_variants"]["later"]
    kern = lib.tl_splitk_stream
    kern.argtypes = [P] * 3 + [I] * 8 + [P]
    kern.restype = I
    comb = lib.tl_splitk_stream_combine
    comb.argtypes = [P, P, ctypes.c_longlong, I, I, I, P]
    comb.restype = I
    stream = torch.cuda.current_stream().cuda_stream
    from tilelang_mesh_tpu_torch.ops.gemm import DTYPE_CODES

    def checked(code):
        if code:
            raise RuntimeError(f"split-K stream launch refused: {code}")

    split = {}
    for label, (K, N) in (("gate_up_bf16", (hid, inter)),
                          ("down_bf16", (inter, hid))):
        b = torch.randn((K, N), device="cuda").to(torch.bfloat16)
        for m in (1, 16):
            a = torch.randn((m, K), device="cuda").to(torch.bfloat16)
            n, L, _ = gv.splitk_plan(K, n_ask)
            _, n_sub, sub = gv.splitk_stream_plan(
                N, n, L, gv.stream_slots(a.device, m, a.dtype))
            ws = torch.empty((n * n_sub, m, N), device="cuda")
            c = torch.empty((m, N), dtype=a.dtype, device="cuda")
            code = DTYPE_CODES[a.dtype]
            k_ms = cs.device_ms(torch, lambda: checked(kern(
                a.data_ptr(), b.data_ptr(), ws.data_ptr(), m, N, K, n, L,
                n_sub, sub, code, stream)), 20)
            c_ms = cs.device_ms(torch, lambda: checked(comb(
                ws.data_ptr(), c.data_ptr(), m * N, 1, n * n_sub, code,
                stream)), 20)
            split[f"{label}_M{m}"] = {
                "partials": n * n_sub, "kernel_ms": k_ms, "combine_ms": c_ms,
                "call_ms": cs.device_ms(torch, lambda: gv.matmul_splitk(
                    a, b, n_split=n_ask), 20),
                "kernel_weight_tb_s": K * N * 2 / k_ms / 1e9}
        print("split", label, json.dumps(
            {k: v for k, v in split.items() if k.startswith(label)}),
            flush=True)
    out["stream_split"] = split
    out["ok"] = bool(ok)
    print(json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
