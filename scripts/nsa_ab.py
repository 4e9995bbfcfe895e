#!/usr/bin/env python3
"""Hold the NSA kernels against another version of their sources: the
same bytes, and the time of each.

    python3 scripts/nsa_ab.py EARLIER_CSRC [LATER_CSRC] [--out DIR]

``EARLIER_CSRC`` (and ``LATER_CSRC``, by default this checkout's
``tilelang_mesh_tpu_torch/csrc``) are directories holding ``nsa.cu``
and / or ``nsa_bwd.cu`` with their headers and the same C entry points,
for example a parent commit's ``csrc`` from ``git archive`` unpacked
under ``build/``. Each source the earlier directory holds is built from
both with nvcc into ``DIR`` (default ``build/nsa_ab``) and called
through the port's wrappers at chip_smoke.py's NSA widths (NSA: T 8192,
64 / 4 heads of 128, 16 selected blocks of 64), float32 and bfloat16, on
q, k, v (and dO) standard normal from default_rng(12) (``nsa.cu``: the
fused forward, ``nsa_fwd``, with the 512-token window and gates uniform
in [0.2, 1]) or default_rng(14) (``nsa_bwd.cu``: ``nsa_bwd_dkdv``,
window 0, its residuals from this checkout's partial forward), the
selections from ``nsa_selections`` on the same generator. Outputs must
be bit-equal; each wrapper is timed with CUDA events behind a spin, the
two builds in turns (earlier, later, later, earlier). Prints one JSON
line with the card's name and power limit and the registers each build
reports, with its nvcc time (one build at a time). Needs one NVIDIA
card; exits non-zero without one.
"""

import argparse
import ctypes
import importlib
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SOURCES = ("nsa", "nsa_bwd")


def build(src_dir, out_dir, tag, name):
    """The loaded library of ``name``.cu in one source directory and its
    ptxas register lines."""
    from tilelang_mesh_tpu_torch.ops import _build
    d = out_dir / tag
    d.mkdir(parents=True, exist_ok=True)
    for f in src_dir.glob("*.cu*"):
        shutil.copy(f, d / f.name)
    lib = d / f"lib{name}.so"
    t0 = time.perf_counter()
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                          str(d / f"{name}.cu")], capture_output=True,
                         text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {tag} {name}:\n{res.stderr}")
    regs = [line.split(":")[-1].strip()
            for line in (res.stdout + res.stderr).splitlines()
            if "registers" in line]
    return ctypes.CDLL(str(lib)), {"nvcc_s": time.perf_counter() - t0,
                                   "registers": regs}


def inputs(torch, cs, seed, n, n_gates):
    """``n`` standard normal tensors at NSA's q / k / v / q shapes, then
    ``n_gates`` gates and the selections, from default_rng(seed) (the
    order chip_smoke.py's sparse_inference phase draws in)."""
    c = cs.NSA
    HQ, Hk, D, S, BS, T = (c["heads"], c["kv_heads"], c["head_dim"],
                           c["selected"], c["block"], c["seq"])
    rng = np.random.default_rng(seed)
    shapes = ((1, T, HQ, D), (1, T, Hk, D), (1, T, Hk, D), (1, T, HQ, D))
    base = [torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
            for s in shapes[:n]]
    gates = torch.from_numpy(rng.uniform(0.2, 1.0, (n_gates, 1, T, HQ))
                             .astype(np.float32)).cuda()
    bi = torch.from_numpy(cs.nsa_selections(rng, np.arange(T), Hk, S, BS))[
        None].cuda()
    return base, gates, bi


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("earlier", type=Path)
    ap.add_argument("later", type=Path, nargs="?",
                    default=ROOT / "tilelang_mesh_tpu_torch" / "csrc")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "nsa_ab")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("nsa_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from tilelang_mesh_tpu_torch.ops import _build
    from tilelang_mesh_tpu_torch.ops import nsa_bwd as nb
    nsa = importlib.import_module("tilelang_mesh_tpu_torch.ops.nsa")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    shutil.rmtree(args.out, ignore_errors=True)
    libs, regs = {}, {}
    for name in SOURCES:
        if (args.earlier / f"{name}.cu").is_file():
            libs[name], regs[name] = {}, {}
            for tag, src in (("earlier", args.earlier),
                             ("later", args.later)):
                libs[name][tag], regs[name][tag] = build(src, args.out, tag,
                                                         name)
    load = _build.load
    which = ["later"]
    _build.load = lambda name: (libs[name][which[0]] if name in libs
                                else load(name))

    c = cs.NSA
    HQ, Hk, D, BS, S, T, W = (c["heads"], c["kv_heads"], c["head_dim"],
                              c["block"], c["selected"], c["seq"],
                              c["window"])
    G, sm = HQ // Hk, D ** -0.5
    cnt = torch.full((1, T, Hk), S, dtype=torch.int32, device="cuda")
    out = {"card": smi, "registers": regs}
    cases = []
    if "nsa" in libs:
        base, gates, bi = inputs(torch, cs, 12, 3, 2)
        gs, gw = (g.reshape(1, T, Hk, G) for g in gates)

        def fused(dtype):
            q, k, v = (t.cuda().to(dtype) for t in base)
            q5, kh, vh = (q.reshape(1, T, Hk, G, D), k.transpose(1, 2),
                          v.transpose(1, 2))
            return lambda: (nsa.nsa_fwd(q5, kh, vh, bi, cnt, gs, gw, BS, W,
                                        sm),)

        cases.append(("nsa_fwd", fused))
    if "nsa_bwd" in libs:
        base_b, _, bi_b = inputs(torch, cs, 14, 4, 1)
        mask = nb.nsa_block_mask(bi_b, cnt, T, T // BS, BS)

        def dkdv(dtype):
            q, k, v, do = (t.cuda().to(dtype) for t in base_b)
            q5, do5 = (q.reshape(1, T, Hk, G, D), do.reshape(1, T, Hk, G, D))
            kh, vh = k.transpose(1, 2), v.transpose(1, 2)
            which[0] = "later"
            acc, m, l = nsa.nsa_fwd_partial(q5, kh, vh, bi_b, cnt, BS, sm)
            o = torch.where(l[..., None] > 0, acc / l[..., None],
                            0.0).to(dtype)
            lse2 = m + torch.log2(l)
            delta = (do5.float() * o.float()).sum(-1)
            return lambda: nb.nsa_bwd_dkdv(q5, kh, vh, do5, lse2, delta,
                                           mask, BS, sm)

        cases.append(("nsa_bwd_dkdv", dkdv))
    for kname, make in cases:
        for dtype in (torch.float32, torch.bfloat16):
            call = make(dtype)
            got = {}
            for tag in ("earlier", "later"):
                which[0] = tag
                got[tag] = call()
            torch.cuda.synchronize()
            equal = all(torch.equal(a, b) for a, b in zip(got["earlier"],
                                                          got["later"]))
            del got
            times = {"earlier": [], "later": []}
            for tag in ("earlier", "later", "later", "earlier"):
                which[0] = tag
                times[tag].append(cs.device_ms(torch, call, 5))
            out[f"{kname}_{str(dtype)[6:]}"] = {"bit_equal": equal,
                                                "ms": times}
    print(json.dumps(out))
    return 0 if all(v["bit_equal"] for k, v in out.items()
                    if isinstance(v, dict) and "bit_equal" in v) else 1


if __name__ == "__main__":
    sys.exit(main())
