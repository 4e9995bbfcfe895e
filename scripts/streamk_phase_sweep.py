#!/usr/bin/env python3
"""Time stream-K (#17, ``csrc/gemm_variants.cu``) at the program count
that runs its tile rows in phase against the count of every co-resident
block, over prefill chunks whose in-phase count keeps between half and
all of the slots busy: the measurement ``streamk_phase_programs``' rule
(in phase only where that keeps more than half the slots busy) rests
on.

    python3 scripts/streamk_phase_sweep.py

Cases: bf16 at the default 128 x 128 x 128 blocks (the TMA kernel
``streamk_tma``), LLaMA-2-7B's gate/up (K 4096 -> N 11008) and its
attention output (K 4096 -> N 4096) at the rows ``ROWS`` lists, drawn as
chip_smoke.py's ``draw_np`` (seed 32). For each: the co-resident slots
(``streamk_programs``), the in-phase count (``_in_phase_programs``), its
share of the slots and the iterations a program runs at each count; the
whole call (partials and fixup) at both counts, timed with chip_smoke's
``device_ms`` in turns (in phase, all, all, in phase), beside
``torch.matmul``; each output held within 1e-2 normwise of the float32
product. Prints one JSON line with the card's name and power limit and
exits 1 when an output disagrees. Needs one NVIDIA card; exits non-zero
without one.
"""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (N, K, rows): the in-phase count's share of 132 slots is in brackets
ROWS = ((11008, 4096, (512, 640, 768, 896, 1152, 1408, 1664, 2176, 2432)),
        # (0.97, 0.61, 0.73, 0.85, 0.55, 0.67, 0.79, 0.52, 0.58)
        (4096, 4096, (640, 768, 896, 1408, 1664)))
        # (0.61, 0.73, 0.85, 0.67, 0.79)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("streamk_phase_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from tilelang_mesh_tpu_torch.ops import gemm_variants as gv
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print("card:", smi, flush=True)
    dt, bm, bn, bk = torch.bfloat16, 128, 128, 128
    blocks = dict(block_M=bm, block_N=bn, block_K=bk)
    slots = gv.streamk_programs("cuda", dt, **blocks)
    out = {"card": smi, "dtype": "bfloat16", "block": [bm, bn, bk],
           "slots": slots, "cases": []}
    ok = True
    for N, K, rows in ROWS:
        for M in rows:
            a, b = (torch.from_numpy(x).cuda().to(dt)
                    for x in cs.draw_np(32, (M, K), (K, N)))
            n_in = gv._in_phase_programs(M, N, K, bm, bn, bk, slots)
            total = (M // bm) * (N // bn) * (K // bk)
            counts = {"in_phase": n_in, "all": slots}
            rec = {"shape": [M, N, K], "n_in_phase": n_in,
                   "share": n_in / slots, "rule_takes": (
                       "in_phase" if gv.streamk_phase_programs(
                           M, N, K, bm, bn, bk, slots) == n_in
                       else "all"),
                   "iterations_a_program": {
                       k: -(-total // n) for k, n in counts.items()}}
            want = a.float() @ b.float()
            for tag, n in counts.items():
                rec[f"{tag}_normwise"] = cs.normwise_err(gv.matmul_streamk(
                    a, b, n_programs=n, **blocks), want)[1]
                ok &= rec[f"{tag}_normwise"] <= 1e-2
            del want
            times = {"in_phase": [], "all": []}
            for tag in ("in_phase", "all", "all", "in_phase"):
                n = counts[tag]
                times[tag].append(cs.device_ms(
                    torch, lambda: gv.matmul_streamk(a, b, n_programs=n,
                                                     **blocks), 10))
            rec.update({f"{tag}_ms": t for tag, t in times.items()})
            rec["all_over_in_phase"] = sum(times["all"]) / sum(
                times["in_phase"])
            rec["library_ms"] = cs.device_ms(
                torch, lambda: torch.matmul(a, b), 10)
            print(json.dumps(rec), flush=True)
            out["cases"].append(rec)
            del a, b
            torch.cuda.empty_cache()
    out["ok"] = ok
    print(json.dumps(out), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
