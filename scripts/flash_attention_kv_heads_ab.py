#!/usr/bin/env python3
"""Hold the MHA path of ``csrc/flash_attention.cu`` against an earlier
version of the same source: the same bytes, and the time of each.

    python3 scripts/flash_attention_kv_heads_ab.py PARENT_CSRC [--out DIR]

``PARENT_CSRC`` is the ``csrc/`` directory of a checkout from before the
kernel took KV heads (its ``tl_mha_fwd`` has no ``Hkv`` argument; e.g. a
``git archive`` of the parent commit unpacked under ``build/``). Both
sources are built with nvcc into ``DIR`` (default ``build/kv_heads_ab``)
and called with ``Hkv == H`` on the same inputs: the forward and the
partial kernel in float32 and bfloat16 at the flagship model's attention
shape (B 2, H 16, S 4096, D 128, causal) and at a ragged D 16, S 1000.
Every output must be bit-equal; each case is timed with CUDA events,
the two builds in turns (earlier, current, current, earlier). Prints one
JSON line with the card's name and power limit. Needs one NVIDIA card;
exits non-zero without one.
"""

import argparse
import ctypes
import json
import math
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LOG2E = 1.44269504


def build(src_dir, out_dir, tag):
    from tilelang_mesh_tpu_torch.ops import _build
    d = out_dir / tag
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    for f in src_dir.glob("*.cu*"):
        shutil.copy(f, d / f.name)
    lib = d / "libflash_attention.so"
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                          str(d / "flash_attention.cu")],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {tag}:\n{res.stderr}")
    return ctypes.CDLL(str(lib))


def caller(torch, lib, kv_heads):
    """fn(q, k, v, causal, partial) through one build's tl_mha_fwd."""
    fn = lib.tl_mha_fwd
    n_int = 9 if kv_heads else 8
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * n_int
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def call(q, k, v, causal, partial):
        B, H, S, D = q.shape
        if partial:
            o = torch.empty((B, H, S, D), device="cuda")
            m = torch.empty((B, H, S), device="cuda")
            l = torch.empty((B, H, S), device="cuda")
        else:
            o, m, l = torch.empty_like(q), None, None
        heads = (B, H, H) if kv_heads else (B, H)
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  m.data_ptr() if partial else None,
                  l.data_ptr() if partial else None, *heads, S, S, D,
                  int(q.dtype == torch.bfloat16), int(causal), int(partial),
                  LOG2E / math.sqrt(D),
                  torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"launch refused ({code})")
        return (o, m, l) if partial else (o,)

    return call


def events_ms(torch, fn, iters=5):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("parent_csrc", type=Path)
    ap.add_argument("--out", type=Path, default=ROOT / "build" /
                    "kv_heads_ab")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    with ThreadPoolExecutor(2) as ex:
        libs = list(ex.map(lambda a: build(*a), (
            (args.parent_csrc, args.out, "earlier"),
            (ROOT / "tilelang_mesh_tpu_torch" / "csrc", args.out,
             "current"))))
    earlier, current = caller(torch, libs[0], False), caller(torch, libs[1],
                                                             True)
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = {}
    for (B, H, S, D) in ((2, 16, 4096, 128), (2, 2, 1000, 16)):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn((B, H, S, D), generator=g,
                                   device="cuda").to(dtype)
                       for _ in range(3))
            for partial in (False, True):
                label = (f"{'partial' if partial else 'fwd'}_"
                         f"{str(dtype)[6:]}_B{B}_H{H}_S{S}_D{D}")
                a = earlier(q, k, v, True, partial)
                b = current(q, k, v, True, partial)
                torch.cuda.synchronize()
                same = all(torch.equal(x, y) for x, y in zip(a, b))
                run = [(name, fn) for name, fn in (
                    ("earlier", earlier), ("current", current),
                    ("current", current), ("earlier", earlier))]
                times = {"earlier": [], "current": []}
                for name, fn in run:
                    times[name].append(events_ms(
                        torch, lambda: fn(q, k, v, True, partial)))
                cases[label] = {"bit_equal": same, "ms": times}
                if not same:
                    print(json.dumps({"case": label, "bit_equal": False}))
    print(json.dumps({"device": smi, "cases": cases}))
    return 0 if all(c["bit_equal"] for c in cases.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
