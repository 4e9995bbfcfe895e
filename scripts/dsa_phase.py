#!/usr/bin/env python3
"""Run chip_smoke.py's ``dsa`` phase alone: DeepSeek-V3.2's sparse
attention at DeepSeek-V3.2-Exp's widths (chip_smoke.DSA), f32 and bf16.

    python3 scripts/dsa_phase.py

Builds ``csrc/dsa.cu`` and ``csrc/sparse_mla.cu``, runs
``chip_smoke.dsa_phase`` (every gate of the phase) and prints the card's
name and power limit, the phase's JSON line, its seconds and the three
kernels' ``kernels`` entries. Needs one NVIDIA card; exits non-zero
without one.
"""

import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("dsa_phase: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from tilelang_mesh_tpu_torch.ops import _build
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all(["dsa", "sparse_mla"])
    for src in ("dsa", "sparse_mla"):
        secs, log = _build.build_log(src)
        print(f"{src}: nvcc {secs:.1f}s", json.dumps(
            cs.kernel_registers(log)))
    dsa = importlib.import_module("tilelang_mesh_tpu_torch.ops.dsa")
    t0 = time.perf_counter()
    res = cs.dsa_phase(torch, dsa)
    print(f"dsa phase: {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"kernels": cs.kernel_entries(res, cs.DSA_KERNELS)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
