#!/usr/bin/env python3
"""Hold the varlen attention kernels against an earlier version of their
sources: the same bytes, the tiles each visits, and the time of each.

    python3 scripts/varlen_tile_vote_ab.py EARLIER_CSRC [--out DIR]

``EARLIER_CSRC`` is a ``csrc/`` directory holding another
``flash_attention_varlen.cu``, ``varlen_bwd.cu`` and their headers with
the same C entry points: for a change to these kernels, the parent
commit's, from ``git archive <parent> tilelang_mesh_tpu_torch/csrc``
unpacked under ``build/``; this checkout's own ``csrc/`` gives the tile
counts alone. Both versions are built with nvcc into ``DIR`` (default
``build/varlen_ab``) and called through the port's wrappers on the same
inputs: chip_smoke.py's packed training batch
(VARLEN: 20 / 5 heads of 128, a 16384-token pack of whole documents,
causal), the four kernels in float32 and bfloat16, and its chunked
prefill step (8 x 512 queries, bottom-right), the forward in bfloat16.
Every output must be bit-equal; each kernel is timed with CUDA events
behind a spin, the two builds in turns (earlier, current, current,
earlier). Beside the times, the forward's 64 x 32 tiles under two
rules, counted on the host from the same masks, with the visible pairs:
a tile overlapping a live cell of the liveness table, and, besides,
holding a visible pair. Prints one JSON line with the card's name and
power limit. Needs one NVIDIA card; exits non-zero without one.
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
SOURCES = ("flash_attention_varlen", "varlen_bwd")


def build(src_dir, out_dir, tag):
    """{source: loaded library} of one csrc directory."""
    from tilelang_mesh_tpu_torch.ops import _build
    d = out_dir / tag
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    for f in src_dir.glob("*.cu*"):
        shutil.copy(f, d / f.name)

    def one(name):
        lib = d / f"lib{name}.so"
        res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                              str(lib), str(d / f"{name}.cu")],
                             capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"nvcc failed on {tag} {name}:\n{res.stderr}")
        return name, ctypes.CDLL(str(lib))

    with ThreadPoolExecutor(len(SOURCES)) as ex:
        return dict(ex.map(one, SOURCES))


def forward_tiles(masks, BM=64, BN=32):
    """The forward's 64 x 32 tiles for one head (causal masks): those
    overlapping a live cell and those of them holding a visible pair,
    in all and in the block (64-row tile) with the most, and the visible
    pairs."""
    seq_q, seq_k, pos_q, pos_k, live = (t.cpu().numpy() for t in masks)
    Tq, Tk = seq_q.size, seq_k.size
    bM, bN = Tq // live.shape[0], Tk // live.shape[1]
    cand, comp, pairs = [], [], 0
    for q0 in range(0, Tq, BM):
        q1 = min(q0 + BM, Tq)
        rows = live[q0 // bM:(q1 - 1) // bM + 1]
        cand.append(0)
        comp.append(0)
        for k0 in range(0, Tk, BN):
            k1 = min(k0 + BN, Tk)
            if not rows[:, k0 // bN:(k1 - 1) // bN + 1].any():
                continue
            cand[-1] += 1
            vis = int(((seq_q[q0:q1, None] == seq_k[None, k0:k1])
                       & (pos_q[q0:q1, None] >= pos_k[None, k0:k1])).sum())
            comp[-1] += vis > 0
            pairs += vis
    return {"live_cell": sum(cand), "visible_pair": sum(comp),
            "blocks": len(cand), "most_in_a_block": [max(cand), max(comp)],
            "pairs": pairs}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("earlier_csrc", type=Path)
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "varlen_ab")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from tilelang_mesh_tpu_torch.ops import _build
    vl = importlib.import_module(
        "tilelang_mesh_tpu_torch.ops.flash_attention_varlen")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    libs = {"earlier": build(args.earlier_csrc, args.out, "earlier"),
            "current": build(ROOT / "tilelang_mesh_tpu_torch" / "csrc",
                             args.out, "current")}

    def use(tag):
        _build.load = lambda name: libs[tag][name]

    cfg = chip_smoke.VARLEN
    Hq, Hkv, D = cfg["heads"], cfg["kv_heads"], cfg["head_dim"]
    lens = chip_smoke.varlen_pack_lengths(cfg)
    cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    total = int(cu[-1])
    sm = 1.0 / math.sqrt(D)
    rng = np.random.default_rng(3)
    base = [torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
            for s in ((total, Hq, D), (total, Hkv, D), (total, Hkv, D),
                      (total, Hq, D))]
    out = {"device": smi, "documents": len(lens), "tokens": total}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        q, k, v, g = (t.cuda().to(dtype) for t in base)
        qp, kp, vp, masks = vl.pack_varlen(q, k, v, cu, cu, causal=True)
        acc, m, l = vl.varlen_fwd_partial_plain(qp, kp, vp, *masks, True, sm)
        o = torch.where(l[..., None] > 0, acc / l[..., None], 0.0)
        gp = vl._pack(g, qp.shape[1])
        delta = (gp.float() * o).sum(-1)
        bwd = (qp, kp, vp, gp, m + torch.log2(l), delta, *masks, True, sm)
        del acc, o
        calls = {
            "varlen_fwd": lambda: vl.varlen_fwd(qp, kp, vp, *masks, True,
                                                sm),
            "varlen_fwd_partial": lambda: vl.varlen_fwd_partial(
                qp, kp, vp, *masks, True, sm),
            "varlen_bwd_dkdv": lambda: vl.varlen_bwd_dkdv(*bwd),
            "varlen_bwd_dq": lambda: vl.varlen_bwd_dq(*bwd)}
        for kname, call in calls.items():
            outs = {}
            for tag in ("earlier", "current"):
                use(tag)
                r = call()
                outs[tag] = r if isinstance(r, tuple) else (r,)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(outs["earlier"],
                                                          outs["current"])):
                raise SystemExit(f"{kname} {name}: the two builds differ")
            times = {"earlier": [], "current": []}
            for tag in ("earlier", "current", "current", "earlier"):
                use(tag)
                times[tag].append(chip_smoke.device_ms(torch, call, 3))
            out[f"{kname}_{name}"] = {"bit_equal": True, "ms": times}
        del q, k, v, g, qp, kp, vp, gp, bwd
        torch.cuda.empty_cache()
    out["forward_tiles_per_head"] = forward_tiles(masks)

    # the chunked-prefill step, bottom-right, bf16
    chunk, n = cfg["chunk"], cfg["chunks"]
    lens_k = [int(x) for x in np.random.default_rng(1).integers(
        chunk, cfg["context"] + 1, size=n)]
    cu_q = np.arange(n + 1, dtype=np.int32) * chunk
    cu_k = np.concatenate([[0], np.cumsum(lens_k)]).astype(np.int32)
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               .cuda().to(torch.bfloat16)
               for s in ((n * chunk, Hq, D), (int(cu_k[-1]), Hkv, D),
                         (int(cu_k[-1]), Hkv, D)))
    qp, kp, vp, masks = vl.pack_varlen(q, k, v, cu_q, cu_k, causal=True,
                                       causal_align="bottom-right")

    def call():
        return vl.varlen_fwd(qp, kp, vp, *masks, True, sm)

    outs = {}
    for tag in ("earlier", "current"):
        use(tag)
        outs[tag] = call()
    torch.cuda.synchronize()
    if not torch.equal(outs["earlier"], outs["current"]):
        raise SystemExit("the prefill forward: the two builds differ")
    times = {"earlier": [], "current": []}
    for tag in ("earlier", "current", "current", "earlier"):
        use(tag)
        times[tag].append(chip_smoke.device_ms(torch, call, 3))
    out["varlen_fwd_prefill_bfloat16"] = {"bit_equal": True, "ms": times}
    out["prefill_forward_tiles_per_head"] = forward_tiles(masks)
    print(json.dumps({"varlen_tile_vote_ab": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
