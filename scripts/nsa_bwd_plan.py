#!/usr/bin/env python3
"""Time NSA training's dK / dV work list (``dkdv_plan``) and what holds it.

    python3 scripts/nsa_bwd_plan.py [--tree DIR] [--label NAME] [--reps N]
                                   [--profile]

``DIR`` (default: this checkout) is the root of a checkout whose
``tilelang_mesh_tpu_torch`` is measured, for example a parent commit
unpacked under ``build/`` by ``git archive``; the shapes and helpers come
from this checkout's ``chip_smoke.py`` (its NSA widths: T 8192, 64 / 4
heads of 128, 16 selected blocks of 64, window 0; q, k, v and dO drawn
on the card from a generator seeded 14, the selections from
``nsa_selections`` on ``default_rng(14)``). Run it once a tree, in turns
(earlier, later, later, earlier), to compare two trees on one card.

Each of ``--reps`` rounds times, on an idle card:

* ``plan_host_ms``: one ``dkdv_plan(mask, G)`` call to its end on the
  host's clock (its host syncs included); ``plan_bounded_host_ms`` the
  same with ``max_pairs`` the selections' slots, where the tree's plan
  takes a bound;
* ``plan_ms``, ``plan_bounded_ms``, ``dkdv_ms``, ``bwd_ms``:
  ``chip_smoke.device_ms`` (three calls queued behind a spin of the
  card) of the plan both ways, of ``nsa_bwd_dkdv`` as the step calls it
  (bounded where the tree takes a bound) and of ``nsa_attention_bwd``
  (dQ and dK / dV), in bfloat16 and float16;
* ``step_ms``: one NSA training step (``nsa_attention(...,
  backward="kernel")`` forward and backward) in bfloat16, as
  chip_smoke.py's nsa_training phase times it.

With ``--profile`` one backward and one step in bfloat16 also run under
``torch.profiler`` (``chip_smoke._profiled_run``): the host's wall time,
the device's busy time (the union of its activity) and its share.

Prints one JSON object: the tree, the card (``nvidia-smi``'s name and
power limit) and, per type and measure, the list of the rounds' values.
"""

from __future__ import annotations

import argparse
import inspect
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path[:0] = [str(tree), str(ROOT)]
    import numpy as np
    import torch
    import chip_smoke as cs
    from tilelang_mesh_tpu_torch.ops import nsa, nsa_bwd as nb
    if not torch.cuda.is_available():
        print("nsa_bwd_plan: no CUDA device", file=sys.stderr)
        return 2
    assert Path(nb.__file__).resolve().is_relative_to(tree), nb.__file__
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    c = cs.NSA
    HQ, Hk, D, BS, S, T = (c["heads"], c["kv_heads"], c["head_dim"],
                           c["block"], c["selected"], c["seq"])
    G, NS, sm = HQ // Hk, T // BS, 1.0 / math.sqrt(D)
    gen = torch.Generator(device="cuda").manual_seed(14)
    base = [torch.randn(shape, generator=gen, device="cuda")
            for shape in ((1, T, HQ, D), (1, T, Hk, D), (1, T, Hk, D),
                          (1, T, HQ, D))]
    rng = np.random.default_rng(14)
    gates = torch.from_numpy(rng.uniform(0.2, 1.0, (1, T, HQ)).astype(
        np.float32)).cuda()
    bi = torch.from_numpy(cs.nsa_selections(rng, np.arange(T), Hk, S, BS))[
        None].cuda()
    cnt = torch.full((1, T, Hk), S, dtype=torch.int32, device="cuda")
    mask = nb.nsa_block_mask(bi, cnt, T, NS, BS)
    out = {"tree": str(tree), "label": args.label, "card": smi,
           "chunks": int(nb.dkdv_plan(mask, G)[2].shape[0])}
    # the selections' slots bound the map's pairs, where the plan takes one
    bound = ({"max_pairs": bi.numel()} if "max_pairs" in
             inspect.signature(nb.dkdv_plan).parameters else None)

    def host_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    for dtype in (torch.bfloat16, torch.float16):
        q, k, v, go = (t.to(dtype) for t in base)
        q5 = q.reshape(1, T, Hk, G, D)
        kh, vh = k.transpose(1, 2), v.transpose(1, 2)
        acc, m, l = nsa.nsa_fwd_partial(q5, kh, vh, bi, cnt, BS, sm)
        o = torch.where(l[..., None] > 0, acc / l[..., None], 0.0).to(dtype)
        do5 = go.reshape(o.shape)
        lse2 = m + torch.log2(l)
        delta = (do5.float() * o.float()).sum(-1)
        a = (q5, kh, vh, do5, lse2, delta)
        del acc
        calls = {
            "plan_ms": lambda: nb.dkdv_plan(mask, G),
            "dkdv_ms": lambda: nb.nsa_bwd_dkdv(*a, mask, BS, sm,
                                               **(bound or {})),
            "bwd_ms": lambda: nb.nsa_attention_bwd(
                q5, kh, vh, bi, cnt, mask, o, lse2, do5, True, sm)}
        leaves = [t.detach().clone().requires_grad_()
                  for t in (q, k, v, gates)]

        def step():
            for t in leaves:
                t.grad = None
            y = nsa.nsa_attention(*leaves, leaves[3], bi, block_size=BS,
                                  backward="kernel")
            y.backward(go)

        if bound:
            calls["plan_bounded_ms"] = lambda: nb.dkdv_plan(mask, G,
                                                            **bound)
        rec = {"plan_host_ms": []}
        if bound:
            rec["plan_bounded_host_ms"] = []
        rec.update({k: [] for k in calls})
        if dtype == torch.bfloat16:
            rec["step_ms"] = []
        for _ in range(args.reps):
            rec["plan_host_ms"].append(host_ms(calls["plan_ms"]))
            if bound:
                rec["plan_bounded_host_ms"].append(
                    host_ms(calls["plan_bounded_ms"]))
            for key, fn in calls.items():
                rec[key].append(cs.device_ms(torch, fn, 3))
            if "step_ms" in rec:
                rec["step_ms"].append(cs.device_ms(torch, step, 3))
        rec["median"] = {k: statistics.median(v) for k, v in rec.items()}
        if args.profile and dtype == torch.bfloat16:
            for key, fn in (("bwd", calls["bwd_ms"]), ("step", step)):
                wall_us, spans = cs._profiled_run(torch, fn)
                busy, end = 0.0, -math.inf
                for t0, t1, _ in sorted(spans):
                    busy += max(0.0, t1 - max(t0, end))
                    end = max(end, t1)
                rec[f"{key}_profile"] = {
                    "wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
                    "device_busy_share": busy / wall_us,
                    "device_records": len(spans)}
        out[str(dtype)[6:]] = rec
        del q, k, v, go, q5, kh, vh, o, do5, a, leaves, calls
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
