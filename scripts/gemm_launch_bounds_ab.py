#!/usr/bin/env python3
"""Time the library GEMM kernels at two and at one block an SM.

    python3 scripts/gemm_launch_bounds_ab.py [--out DIR]

``csrc/gemm_tile.cuh``'s ``kMinBlocks`` (the second argument of the
``__launch_bounds__`` of ``gemm.cu`` and ``dequant_gemm.cu``) caps a
thread at 128 registers when it is 2. This builds both sources twice
with nvcc, as they are and with ``kMinBlocks = 1`` (a copy of
``csrc/`` under ``DIR``), prints each kernel's registers and spilled
bytes, then times each case at ``bench.py``'s shapes with CUDA events,
the two builds in turns (as is, 1, 1, as is), checks that both give the
same output, and prints one JSON line with the card's name and power
limit. Needs one NVIDIA card; exits non-zero without one.
"""

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def build(src_dir, out_dir, name, min_blocks):
    from tilelang_mesh_tpu_torch.ops import _build
    d = out_dir / f"{name}_min_blocks_{min_blocks}"
    d.mkdir(parents=True, exist_ok=True)
    for f in src_dir.glob("*.cu*"):
        shutil.copy(f, d / f.name)
    header = d / "gemm_tile.cuh"
    text, line = header.read_text(), "constexpr int kMinBlocks = 2;"
    assert line in text
    header.write_text(text.replace(line, line.replace("2", str(min_blocks))))
    lib = d / f"lib{name}.so"
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                          str(d / f"{name}.cu")], capture_output=True,
                         text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{res.stderr}")
    return ctypes.CDLL(str(lib)), res.stdout + res.stderr


def cases(torch, gm, dqg):
    """(label, call) at bench.py's shapes (see chip_smoke.py)."""
    import numpy as np
    from tilelang_mesh_tpu_torch.quantize import quantize_int4_planar
    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, dt=torch.bfloat16, scale=0.1):
        return (torch.randn(shape, generator=g, device="cuda")
                * scale).to(dt)

    out = []
    for dt in (torch.float32, torch.bfloat16):
        a, b = rnd(4096, 4096, dt=dt), rnd(4096, 4096, dt=dt)
        for ta in (False, True):
            for tb in (False, True):
                out.append((f"matmul {str(dt)[6:]} {int(ta)}{int(tb)} 4096^3",
                            lambda a=a, b=b, ta=ta, tb=tb: gm.matmul(
                                a, b, ta, tb)))
    a8 = rnd(4096, 4096, dt=torch.float8_e4m3fn, scale=0.3)
    b8 = rnd(4096, 4096, dt=torch.float8_e4m3fn, scale=0.3)
    out.append(("matmul fp8->f32 4096^3",
                lambda: gm.matmul(a8, b8, out_dtype=torch.float32)))
    A, B = rnd(8192, 4096), rnd(4096, 8192)
    out.append(("matmul bf16 8192x8192x4096", lambda: gm.matmul(A, B)))
    for M, K, N, gs, dt in ((4096, 4096, 4096, 512, torch.bfloat16),
                            (16, 4096, 11008, 128, torch.bfloat16),
                            (4096, 4096, 4096, 512, torch.float32)):
        w = (np.random.default_rng(3).standard_normal((K, N))
             * 0.1).astype(np.float32)
        p, s = (torch.from_numpy(t).cuda()
                for t in quantize_int4_planar(w, gs))
        x = rnd(M, K, dt=dt)
        out.append((f"dequant_gemm {str(dt)[6:]} M{M} N{N} gs{gs}",
                    lambda x=x, p=p, s=s, gs=gs: dqg.dequant_matmul(
                        x, p, s, group_size=gs, block_K2=gs)))
    w = (np.random.default_rng(9).standard_normal((4096, 4096))
         * 0.1).astype(np.float32)
    pk, sw = (torch.from_numpy(t).cuda()
              for t in dqg.quantize_w4_per_channel(w))
    q, sc = dqg.quantize_activations(rnd(4096, 4096, dt=torch.float32,
                                         scale=1.0))
    sa = (1.0 / sc).float()
    out.append(("w4a8 4096^3", lambda: dqg.w4a8_gemm(q, pk, sw, sa)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "launch_bounds"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from tilelang_mesh_tpu_torch.ops import _build
    from tilelang_mesh_tpu_torch.ops import dequant_gemm as dqg
    from tilelang_mesh_tpu_torch.ops import gemm as gm
    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = Path(args.out)
    jobs = [(n, mb) for mb in (2, 1) for n in ("gemm", "dequant_gemm")]
    with ThreadPoolExecutor(len(jobs)) as ex:
        built = list(ex.map(lambda j: build(_build.CSRC, out_dir, *j), jobs))
    libs = {1: {}, 2: {}}
    registers = {}
    for (name, mb), (lib, log) in zip(jobs, built):
        libs[mb][name] = lib
        registers[f"{name} min_blocks={mb}"] = chip_smoke.kernel_registers(
            log)
    print(json.dumps({"registers": registers}), flush=True)

    def use(mb):
        _build.load = lambda n: libs[mb][n]

    res = {}
    for label, fn in cases(torch, gm, dqg):
        use(2)
        a = fn().float()
        use(1)
        b = fn().float()
        same = float((a - b).abs().max())
        del a, b
        t = {2: [], 1: []}
        for mb in (2, 1, 1, 2):
            use(mb)
            t[mb].append(chip_smoke.cuda_ms(torch, fn, 5))
        res[label] = {"min_blocks_2_ms": t[2], "min_blocks_1_ms": t[1],
                      "max_abs_diff": same}
        print(f"{label:40s} min_blocks 2: {t[2][0]:.3f} {t[2][1]:.3f} ms  "
              f"1: {t[1][0]:.3f} {t[1][1]:.3f} ms  diff {same:.1e}",
              flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    print(json.dumps({"device": smi, "cases": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
