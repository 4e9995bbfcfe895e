#!/usr/bin/env python3
"""Hold the attention forward (csrc/flash_attention.cu: #1, #2, #8, #9)
against another version of its source: each against the plain version,
the float32 outputs bit for bit, and the time of each, in turns.

    python3 scripts/flash_attention_mma_ab.py EARLIER_CSRC [LATER_CSRC]
        [--out DIR]

``EARLIER_CSRC`` (and ``LATER_CSRC``, by default this checkout's
``tilelang_mesh_tpu_torch/csrc``) are directories holding
``flash_attention.cu`` and ``gqa_bwd.cu`` with their headers and the same
C entry points (``tl_mha_fwd``, ``tl_gqa_bwd_dkdv``, ``tl_gqa_bwd_dq``),
for example a parent commit's ``csrc`` from ``git archive`` unpacked
under ``build/``. Both sources of both directories are built with nvcc
into ``DIR`` (default ``build/flash_attention_mma_ab``), all four at
once, and called through the wrappers of ``ops/flash_attention.py``,
``ops/gqa.py`` and ``ops/gqa_bwd.py`` at the default tile, on draws of a
seeded card generator (seed 1):

* the forward (``partial = 0``) and the partial kernel in float32,
  bfloat16 and float16 at the MHA shape (B 2, H 16, S 4096, D 128,
  causal: chip_smoke.py's attention phase), the GQA shape (B 2, 20 / 5
  heads, the same S and D: its bitnet_gqa phase) and a ragged D 16,
  S 1000 (B 2, H 2), each held against the plain version (normwise,
  within chip_smoke.py's ``ATTN_TOL``); the two builds' float32 outputs
  must be equal bit for bit;
* the backward pair (``gqa_bwd.cu``, whose tensor-core helpers moved to
  ``attention_mma.cuh``) at B 1, 8 / 2 heads, S 1000, D 128 and at
  D 16: both builds' dK, dV and dQ equal bit for bit in every type.

Each build's forward and partial kernel are timed with CUDA events
behind a spin, in turns (earlier, later, later, earlier), at the MHA and
GQA shapes in every type, beside SDPA (``enable_gqa`` at the GQA shape;
the memory-efficient kernel with its log-sum-exp for the partial) and
the bound (4 D flops a visible pair over the card's peak for the type).
Then the later build's tensor-core tiles (``carver.FLASH_KERNEL_TILES``)
are timed one by one in bfloat16, at the MHA and GQA shapes, at
chip_smoke.py's sink attention widths (gpt-oss-20b: B 1, 64 / 8 heads
of 64, S 4096, causal) and at bench.py's flash shapes (B 2, H 16,
S 2048, D 64 and 128, causal and full). Prints one JSON line with the card's name and power limit, each
instance's registers and spill stores, and each build's nvcc time, and
writes it to ``chiprun_out/flash_attention_mma_ab.json``; exits 1 if a
check fails. Needs one NVIDIA card; exits non-zero without one.
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
SOURCES = ("flash_attention", "gqa_bwd")
TAGS = ("earlier", "later")
# (B, Hq, Hkv, S, D), all causal
SHAPES = {"mha": (2, 16, 16, 4096, 128), "gqa": (2, 20, 5, 4096, 128),
          "ragged_d16": (2, 2, 2, 1000, 16)}
BWD_SHAPES = ((1, 8, 2, 1000, 128), (1, 8, 2, 1000, 16))
BENCH_SHAPES = {"flash_d64": (64, True), "flash_d128": (128, True),
                "flash_d128_full": (128, False)}   # B 2, H 16, S 2048


def build(out_dir, tag, name):
    """The loaded library of ``name``.cu in ``out_dir / tag`` (a copy of
    one source directory), its nvcc seconds and the compiler's output."""
    from tilelang_mesh_tpu_torch.ops import _build
    d = out_dir / tag
    lib = d / f"lib{name}.so"
    t0 = time.perf_counter()
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                          str(d / f"{name}.cu")], capture_output=True,
                         text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {tag} {name}:\n{res.stderr}")
    return ctypes.CDLL(str(lib)), time.perf_counter() - t0, \
        res.stdout + res.stderr


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("earlier", type=Path)
    ap.add_argument("later", type=Path, nargs="?",
                    default=ROOT / "tilelang_mesh_tpu_torch" / "csrc")
    ap.add_argument("--out", type=Path, default=ROOT / "build" /
                    "flash_attention_mma_ab")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_attention_mma_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import torch.nn.functional as F
    from tilelang_mesh_tpu_torch.carver import FLASH_KERNEL_TILES
    from tilelang_mesh_tpu_torch.ops import _build
    from tilelang_mesh_tpu_torch.ops import gqa_bwd as gb
    fa = importlib.import_module("tilelang_mesh_tpu_torch.ops.flash_attention")
    gq = importlib.import_module("tilelang_mesh_tpu_torch.ops.gqa")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    shutil.rmtree(args.out, ignore_errors=True)
    for tag, src in zip(TAGS, (args.earlier, args.later)):
        (args.out / tag).mkdir(parents=True)
        for f in src.glob("*.cu*"):
            shutil.copy(f, args.out / tag / f.name)
    jobs = [(tag, name) for tag in TAGS for name in SOURCES]
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:   # all at once
        done = list(pool.map(lambda j: build(args.out, *j), jobs))
    libs, builds = {}, {tag: {} for tag in TAGS}
    for (tag, name), (lib, secs, log) in zip(jobs, done):
        libs[tag, name] = lib
        builds[tag][name] = {"nvcc_s": secs,
                             "registers_spills": cs.kernel_registers(log)}
    load = _build.load
    which = ["later"]
    _build.load = lambda name: (libs[which[0], name] if name in SOURCES
                                else load(name))

    out = {"card": smi, "shapes": SHAPES, "causal": True, "builds": builds}
    failed = []

    def check(cond, msg):
        if not cond:
            failed.append(msg)

    def rnd(gen, dtype, *shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    dtypes = (torch.float32, torch.bfloat16, torch.float16)
    for dtype in dtypes:
        name = str(dtype)[6:]
        tol = cs.ATTN_TOL[name]
        peak = cs.PEAK_F32_FLOPS if dtype == torch.float32 else \
            cs.PEAK_BF16_FLOPS
        res = {"tolerance": f"normwise {tol}"}
        for label, (B, Hq, Hkv, S, D) in SHAPES.items():
            gen = torch.Generator(device="cuda").manual_seed(1)
            q, k, v = (rnd(gen, dtype, B, h, S, D) for h in (Hq, Hkv, Hkv))
            sm = 1.0 / math.sqrt(D)
            mod, op = (fa, "mha_fwd") if Hq == Hkv else (gq, "gqa_fwd")
            calls = {"fwd": lambda: getattr(mod, op)(q, k, v, True, sm),
                     "partial": lambda: getattr(mod, op + "_partial")(
                         q, k, v, True, sm)}
            plain = {"fwd": getattr(mod, op + "_plain"),
                     "partial": getattr(mod, op + "_partial_plain")}
            case = {}
            for mode, call in calls.items():
                want = plain[mode](q, k, v, True, sm)
                want = want if isinstance(want, tuple) else (want,)
                got = {}
                for tag in TAGS:
                    which[0] = tag
                    g = call()
                    got[tag] = g if isinstance(g, tuple) else (g,)
                    torch.cuda.synchronize()
                    err = max(cs.normwise_err(a, b)[1]
                              for a, b in zip(got[tag], want))
                    case[f"{mode}_{tag}_normwise"] = err
                    check(err <= tol and all(bool(torch.isfinite(a).all())
                                             for a in got[tag]),
                          f"{name} {label} {mode} {tag}: {err:.3e} > {tol}")
                eq = all(torch.equal(a, b) for a, b in
                         zip(got["earlier"], got["later"]))
                case[f"{mode}_bit_equal"] = eq
                if dtype == torch.float32:
                    check(eq, f"float32 {label} {mode}: the builds differ")
                del want, got
            torch.cuda.empty_cache()
            if label != "ragged_d16":
                pairs = cs.causal_pairs(S, S) * B * Hq
                case["bound_ms"] = 4 * D * pairs / peak * 1e3
                times = {tag: {m: [] for m in calls} for tag in TAGS}
                for tag in ("earlier", "later", "later", "earlier"):
                    which[0] = tag
                    for mode, call in calls.items():
                        times[tag][mode].append(cs.device_ms(torch, call, 3))
                case["ms"] = times
                for mode in calls:
                    case[f"speedup_{mode}"] = (min(times["earlier"][mode])
                                               / max(times["later"][mode]))
                gqa_kw = {} if Hq == Hkv else {"enable_gqa": True}
                case["sdpa_ms"] = cs.device_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        q, k, v, is_causal=True, **gqa_kw), 3)
                kx, vx = (k, v) if Hq == Hkv else (
                    k.repeat_interleave(Hq // Hkv, 1),
                    v.repeat_interleave(Hq // Hkv, 1))
                case["sdpa_lse_ms"] = cs.device_ms(
                    torch, lambda: torch.ops.aten.
                    _scaled_dot_product_efficient_attention(
                        q, kx, vx, None, True, 0.0, True), 3)
                del kx, vx
            res[label] = case
            del q, k, v
            torch.cuda.empty_cache()

        # the backward pair, both builds bit for bit
        for B, Hq, Hkv, S, D in BWD_SHAPES:
            gen = torch.Generator(device="cuda").manual_seed(1)
            q, do = (rnd(gen, dtype, B, Hq, S, D) for _ in range(2))
            k, v = (rnd(gen, dtype, B, Hkv, S, D) for _ in range(2))
            sm = 1.0 / math.sqrt(D)
            acc, m, l = gq.gqa_fwd_partial_plain(q, k, v, True, sm)
            o = (acc / l[..., None]).to(dtype)
            ops = (q, k, v, do, m + torch.log2(l),
                   (do.float() * o.float()).sum(-1))
            got = {}
            for tag in TAGS:
                which[0] = tag
                got[tag] = (*gb.gqa_bwd_dkdv(*ops, True, sm),
                            gb.gqa_bwd_dq(*ops, True, sm))
            torch.cuda.synchronize()
            eq = all(torch.equal(a, b) for a, b in zip(*got.values()))
            res[f"gqa_bwd_D{D}_bit_equal"] = eq
            check(eq, f"{name} gqa_bwd D {D}: the builds differ")
            del q, k, v, do, o, ops, got, acc, m, l
        out[name] = res
        print(json.dumps({name: res}), flush=True)

    # the later build's tensor-core tiles, bfloat16
    which[0] = "later"
    tiles = {}
    shapes = {label: (*SHAPES[label], True) for label in ("mha", "gqa")}
    shapes["sink_d64"] = (1, 64, 8, 4096, 64, True)
    shapes.update({label: (2, 16, 16, 2048, D, causal)
                   for label, (D, causal) in BENCH_SHAPES.items()})
    for label, (B, Hq, Hkv, S, D, causal) in shapes.items():
        gen = torch.Generator(device="cuda").manual_seed(1)
        q, k, v = (rnd(gen, torch.bfloat16, B, h, S, D)
                   for h in (Hq, Hkv, Hkv))
        sm = 1.0 / math.sqrt(D)
        mod, op = (fa, "mha_fwd") if Hq == Hkv else (gq, "gqa_fwd")
        row = {}
        for tile in FLASH_KERNEL_TILES[D]:
            row[str(tile)] = {
                mode: cs.device_ms(torch, lambda: getattr(mod, op + suffix)(
                    q, k, v, causal, sm, tile=tile), 5)
                for mode, suffix in (("fwd", ""), ("partial", "_partial"))}
        row["sdpa_ms"] = cs.device_ms(
            torch, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal,
                **({} if Hq == Hkv else {"enable_gqa": True})), 5)
        tiles[label] = row
        del q, k, v
        torch.cuda.empty_cache()
    out["tiles_bf16"] = tiles
    print(json.dumps({"tiles_bf16": tiles}), flush=True)
    out["failed"] = failed
    line = json.dumps(out)
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "flash_attention_mma_ab.json").write_text(line + "\n")
    print(line)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
