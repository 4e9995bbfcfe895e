#!/usr/bin/env python3
"""Count the short profiled runs for which torch.profiler hands back no
device record, and exercise both ways chip_smoke.py's
``device_breakdown`` reads a run: from the profiler's records, and from
CUDA events when no profiled run had a record.

    python3 scripts/profiler_records.py [RUNS]

The window is about as long as the MLA serving phase's profiled decode
step (a millisecond or two): five bf16 4096 x 4096 products and a copy
of a row to the host. ``RUNS`` (default 200) such windows are profiled
one at a time with chip_smoke's ``_profiled_run``; the script counts
those with no device record. Then ``device_breakdown`` on the same
window, once as chip_smoke calls it and once with ``runs=0`` (straight
to CUDA events). Prints one JSON line with the card's name and power
limit and exits 1 where a reading has no device time. Needs one NVIDIA
card; exits non-zero without one.
"""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profiler_records: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    runs = int(sys.argv[1]) if len(sys.argv) > 1 else 200
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print("card:", smi, flush=True)
    x = torch.randn(4096, 4096, device="cuda", dtype=torch.bfloat16)

    def window():
        y = x
        for _ in range(5):
            y = y @ x
        return y[0].cpu()

    window()
    empty = sum(not any(t1 > t0 for t0, t1, _ in
                        cs._profiled_run(torch, window)[1])
                for _ in range(runs))
    prof = cs.device_breakdown(torch, window)
    events = cs.device_breakdown(torch, window, runs=0)
    out = {"card": smi, "torch": torch.__version__, "runs": runs,
           "runs_without_device_records": empty,
           "profiler": prof, "cuda_events": events}
    out["ok"] = bool(
        (prof["source"] != "profiler" or prof["device_busy_ms"] > 0)
        and events["source"] == "cuda_events"
        and events["device_span_ms"] > 0)
    print(json.dumps(out), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
