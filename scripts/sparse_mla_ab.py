#!/usr/bin/env python3
"""Hold the sparse MLA kernel (csrc/sparse_mla.cu) against another
version of its source: each against the plain version, and the time of
each.

    python3 scripts/sparse_mla_ab.py EARLIER_CSRC [LATER_CSRC] [--out DIR]

``EARLIER_CSRC`` (and ``LATER_CSRC``, by default this checkout's
``tilelang_mesh_tpu_torch/csrc``) are directories holding
``sparse_mla.cu`` with its headers and the same C entry point, for
example a parent commit's ``csrc`` from ``git archive`` unpacked under
``build/``. Both are built with nvcc into ``DIR`` (default
``build/sparse_mla_ab``) and called through ``ops/dsa.py``'s
``sparse_mla_fwd`` at chip_smoke.py's DSA widths (a 4096-query chunk
over an 8192-token cache, 128 heads, latent 512 + rope 64, top 2048),
in float32, bfloat16 and float16, on the phase's draws (a seeded card
generator, seed 21) with ids from this checkout's indexer and selector.
Each build's O and LSE are held against the plain version (normwise,
printed; the float32 outputs of the two builds compared bit for bit);
each build is timed with CUDA events behind a spin, in turns (earlier,
later, later, earlier). Prints one JSON line with the card's name and
power limit and each build's registers and nvcc time. Needs one NVIDIA
card; exits non-zero without one.
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
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def build(src_dir, out_dir, tag):
    """The loaded library of ``sparse_mla.cu`` in one source directory
    and its ptxas register lines."""
    from tilelang_mesh_tpu_torch.ops import _build
    d = out_dir / tag
    d.mkdir(parents=True, exist_ok=True)
    for f in src_dir.glob("*.cu*"):
        shutil.copy(f, d / f.name)
    lib = d / "libsparse_mla.so"
    t0 = time.perf_counter()
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                          str(d / "sparse_mla.cu")], capture_output=True,
                         text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {tag}:\n{res.stderr}")
    regs = [line.split(":")[-1].strip()
            for line in (res.stdout + res.stderr).splitlines()
            if "registers" in line]
    return ctypes.CDLL(str(lib)), {"nvcc_s": time.perf_counter() - t0,
                                   "registers": regs}


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("earlier", type=Path)
    ap.add_argument("later", type=Path, nargs="?",
                    default=ROOT / "tilelang_mesh_tpu_torch" / "csrc")
    ap.add_argument("--out", type=Path, default=ROOT / "build" /
                    "sparse_mla_ab")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sparse_mla_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from tilelang_mesh_tpu_torch.ops import _build
    dsa = importlib.import_module("tilelang_mesh_tpu_torch.ops.dsa")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    shutil.rmtree(args.out, ignore_errors=True)
    libs, regs = {}, {}
    for tag, src in (("earlier", args.earlier), ("later", args.later)):
        libs[tag], regs[tag] = build(src, args.out, tag)
    load = _build.load
    which = ["later"]
    _build.load = lambda name: (libs[which[0]] if name == "sparse_mla"
                                else load(name))

    c = cs.DSA
    H, D, DT, HI, DI, topk = (c["heads"], c["latent"], c["rope"],
                              c["index_heads"], c["index_dim"], c["topk"])
    S, Skv = c["seq"], c["cache"]
    sm = 1.0 / math.sqrt(D + DT)
    out = {"card": smi, "builds": regs}
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        gen = torch.Generator(device="cuda").manual_seed(21)
        qi, ki, q, kv = (torch.randn(shape, generator=gen, device="cuda")
                         .to(dtype) for shape in (
                             (1, S, HI, DI), (1, Skv, DI), (1, S, H, D + DT),
                             (1, Skv, D + DT)))
        w = torch.randn((1, S, HI), generator=gen, device="cuda")
        ind = dsa.topk_selector(dsa.lightning_indexer(qi, ki, w), topk)
        del qi, ki, w
        o_p, lse_p = dsa.sparse_mla_fwd_plain(q, kv, ind, D, sm, Skv - S)
        got, case = {}, {}
        for tag in ("earlier", "later"):
            which[0] = tag
            got[tag] = dsa.sparse_mla_fwd(q, kv, ind)
            torch.cuda.synchronize()
            case[f"{tag}_o_normwise"] = cs.normwise_err(got[tag][0], o_p)[1]
            case[f"{tag}_lse_normwise"] = cs.normwise_err(got[tag][1],
                                                          lse_p)[1]
        case["bit_equal"] = all(torch.equal(a, b) for a, b in
                                zip(got["earlier"], got["later"]))
        del got, o_p, lse_p
        times = {"earlier": [], "later": []}
        for tag in ("earlier", "later", "later", "earlier"):
            which[0] = tag
            times[tag].append(cs.device_ms(
                torch, lambda: dsa.sparse_mla_fwd(q, kv, ind), 3))
        case["ms"] = times
        out[str(dtype)[6:]] = case
        print(json.dumps({str(dtype)[6:]: case}), flush=True)
        del q, kv, ind
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
