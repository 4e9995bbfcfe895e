#!/usr/bin/env python3
"""Hold the packed varlen attention backward pair (csrc/varlen_bwd.cu: #11
dK/dV and #12 dQ) against another version of its source: each against
the plain version, the float32 outputs bit for bit, and the time of each.

    python3 scripts/varlen_bwd_ab.py EARLIER_CSRC [LATER_CSRC]
        [--out DIR] [--build DIR]

``EARLIER_CSRC`` and ``LATER_CSRC`` (by default this checkout's
``tilelang_mesh_tpu_torch/csrc``) are directories holding
``varlen_bwd.cu`` with its headers and the C entry points
``tl_varlen_bwd_dkdv`` and ``tl_varlen_bwd_dq``, for example a parent
commit's ``csrc`` from ``git archive`` unpacked under ``build/``. Both
are built with nvcc, all builds at once, and called through the port's
wrappers (``varlen_bwd_dkdv``, ``varlen_bwd_dq``) at chip_smoke.py's
main-path shape: the 16384-token pack of whole documents (VARLEN:
lengths from default_rng(0), 20 / 5 heads of 128, causal, top-left; q,
k, v and the incoming gradient standard normal from default_rng(3);
lse2 and delta from the plain partial forward, as the varlen phase
makes them), in float32, bfloat16 and float16.

Each build's dK, dV and dQ are held against the plain version
(normwise, chip_smoke.py's ``ATTN_TOL``); the two builds' float32
outputs must be equal bit for bit. Each kernel and the pair are timed
with CUDA events behind a spin (chip_smoke.py's ``device_ms``) in turns:
earlier, later, library, later, earlier; the library call is SDPA's
backward (dq, dk, dv) over the dense bool document mask, cuDNN with
``enable_gqa`` in 16 bits and the memory-efficient kernel on K and V
expanded by the group in float32 (chip_smoke.py's yardstick). The bound
is the visible pairs' flops (8 D for dK/dV, 6 D for dQ) at the type's
peak.

The float32 functions of ``varlen_bwd.cu`` (``varlen_bwd_dkdv<D, 0>``,
``varlen_bwd_dq<D, 0>``) must compile to the same SASS in both builds,
and so must every other source whose header closure differs between the
directories (``scripts/nsa_ab.py``'s helpers; the first differences go
to DIR/sass_diffs). Prints one JSON line with the card's name and power
limit, each build's registers and spill stores (``-Xptxas -v``) and
nvcc time; exits 1 when a check fails. Needs one NVIDIA card; exits
non-zero without one.
"""

import argparse
import contextlib
import ctypes
import importlib
import json
import math
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SOURCE = "varlen_bwd"
TYPES = ("float32", "bfloat16", "float16")
# the float32 functions of varlen_bwd.cu, whose SASS must not change
F32 = r"varlen_bwd_(dkdv|dq)ILi\d+ELi0E"


def turns(cs, torch, calls, iters):
    """{tag: [ms, ...]} of ``calls`` (tag -> fn) timed in the order
    earlier, later, library, later, earlier (the tags present)."""
    times = {}
    for tag in ("earlier", "later", "library", "later", "earlier"):
        if tag in calls:
            times.setdefault(tag, []).append(
                cs.device_ms(torch, calls[tag], iters))
    return times


def main() -> int:
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    ap = argparse.ArgumentParser()
    ap.add_argument("earlier", type=Path)
    ap.add_argument("later", type=Path, nargs="?",
                    default=ROOT / "tilelang_mesh_tpu_torch" / "csrc")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "varlen_bwd_ab" / "out")
    ap.add_argument("--build", type=Path,
                    default=ROOT / "build" / "varlen_bwd_ab")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("varlen_bwd_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    import chip_smoke as cs
    import nsa_ab
    from tilelang_mesh_tpu_torch.ops import _build
    # the package's ops/__init__ shadows the module with the function
    vl = importlib.import_module(
        "tilelang_mesh_tpu_torch.ops.flash_attention_varlen")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    shutil.rmtree(args.build, ignore_errors=True)
    dirs = {"earlier": args.earlier, "later": args.later}
    for tag, src in dirs.items():
        (args.build / tag).mkdir(parents=True)
        for f in src.glob("*.cu*"):
            shutil.copy(f, args.build / tag / f.name)
    others = sorted(p.stem for p in args.later.glob("*.cu")
                    if p.stem != SOURCE)
    shared = {n: ("same bytes" if nsa_ab.closure(args.earlier, n)
                  == nsa_ab.closure(args.later, n) else None)
              for n in others}
    jobs = [(tag, dirs[tag], n, args.build) for n in (SOURCE,) + tuple(
        n for n, v in shared.items() if v is None) for tag in dirs]
    with ThreadPoolExecutor(max_workers=len(jobs)) as ex:
        built = dict(zip([(j[0], j[2]) for j in jobs],
                         ex.map(nsa_ab.build, jobs)))
    diff_dir = args.out / "sass_diffs"
    for n, v in shared.items():
        if v is None:
            shared[n] = ("same SASS" if nsa_ab.same_sass(
                nsa_ab.sass(built["earlier", n][0]),
                nsa_ab.sass(built["later", n][0]),
                diff_dir / f"{n}.diff") else "SASS differs")
    a, b = (nsa_ab.sass(built[tag, SOURCE][0]) for tag in dirs)
    keep = [fn for fn in sorted(set(a) & set(b)) if re.search(F32, fn)]
    kept_sass = {fn: a[fn] == b[fn] for fn in keep}
    nsa_ab.same_sass({fn: a[fn] for fn in keep}, {fn: b[fn] for fn in keep},
                     diff_dir / f"{SOURCE}_kept.diff")
    libs = {tag: ctypes.CDLL(str(built[tag, SOURCE][0])) for tag in dirs}
    builds = {tag: {"nvcc_s": round(built[tag, SOURCE][2], 1),
                    "registers_spills": cs.kernel_registers(
                        built[tag, SOURCE][1])} for tag in dirs}
    load = _build.load
    which = ["later"]
    _build.load = lambda name: (libs[which[0]] if name == SOURCE
                                else load(name))
    out = {"card": smi, "shared_sources": shared, "builds": builds,
           "kept_functions_same_sass": kept_sass}
    failed = [f"{n}: {v}" for n, v in shared.items() if v == "SASS differs"]
    failed += [f"{fn}: SASS differs" for fn, same in kept_sass.items()
               if not same]
    if not keep:
        failed.append("no float32 function of varlen_bwd.cu in both builds")

    c = cs.VARLEN
    Hq, Hkv, D = c["heads"], c["kv_heads"], c["head_dim"]
    sm = 1.0 / math.sqrt(D)
    lens = cs.varlen_pack_lengths(c)
    cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    tq = int(cu[-1])
    rng = np.random.default_rng(3)
    base = [torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
            for s in ((tq, Hq, D), (tq, Hkv, D), (tq, Hkv, D), (tq, Hq, D))]
    out["pack"] = {"documents": len(lens), "tokens": tq, "pack": c["pack"]}
    for name in TYPES:
        dtype = getattr(torch, name)
        tol = cs.ATTN_TOL[name]
        q, k, v, g = (t.cuda().to(dtype) for t in base)
        qp, kp, vp, masks = vl.pack_varlen(q, k, v, cu, cu, True)
        Tq = qp.shape[1]
        pacc, pm, pl = vl.varlen_fwd_partial_plain(qp, kp, vp, *masks, True,
                                                    sm)
        lv = pl[..., None]
        o = torch.where(lv > 0, pacc / lv, 0.0).to(dtype)
        lse2 = pm + torch.log2(pl)
        gp = vl._pack(g, Tq)
        delta = (gp.float() * o.float()).sum(-1)
        del pacc, pm, pl, lv
        ops = (qp, kp, vp, gp, lse2, delta, *masks, True, sm)
        want = (*vl.varlen_bwd_dkdv_plain(*ops), vl.varlen_bwd_dq_plain(*ops))
        mask = vl._visible(*(t[:tq] for t in masks[:4]), True)
        pairs = int(mask.sum(dtype=torch.int64)) * Hq
        case = {"kernel": ("CUDA cores" if dtype == torch.float32 else
                           "mma.sync"), "visible_pairs": pairs,
                "tolerance": f"normwise {tol}"}
        got = {}
        for tag in ("earlier", "later"):
            which[0] = tag
            got[tag] = (*vl.varlen_bwd_dkdv(*ops), vl.varlen_bwd_dq(*ops))
            torch.cuda.synchronize()
            errs = [cs.normwise_err(x, w)[1] for x, w in zip(got[tag], want)]
            case[f"{tag}_normwise"] = dict(zip(("dk", "dv", "dq"), errs))
            if not max(errs) <= tol:
                failed.append(f"{name} {tag}: {errs} > {tol}")
        case["bit_equal"] = all(torch.equal(x, y) for x, y in
                                zip(got["earlier"], got["later"]))
        if dtype == torch.float32 and not case["bit_equal"]:
            failed.append("float32: the builds' outputs differ")
        del got, want

        # SDPA's backward over the dense document mask
        q4, k4, v4, g4 = (t.transpose(0, 1)[None] for t in (q, k, v, g))
        if dtype == torch.float32:
            k4, v4 = (t.repeat_interleave(Hq // Hkv, 1) for t in (k4, v4))
            ctx, kw = sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]), {}
        else:
            ctx, kw = contextlib.nullcontext(), {"enable_gqa": True}
        # the backward runs on the backend the forward took
        leaves = [t.detach().requires_grad_() for t in (q4, k4, v4)]
        with ctx:
            res = F.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                                 **kw)
        peak = (cs.PEAK_F32_FLOPS if dtype == torch.float32
                else cs.PEAK_BF16_FLOPS)
        case["bound_ms"] = {"dkdv": 8 * D * pairs / peak * 1e3,
                            "dq": 6 * D * pairs / peak * 1e3}
        case["bound_ms"]["pair"] = sum(case["bound_ms"].values())
        case["ms"] = {}
        for part in ("dkdv", "dq", "pair"):
            calls = {}
            for tag in ("earlier", "later"):
                def kern(tag=tag, part=part):
                    which[0] = tag
                    if part != "dq":
                        vl.varlen_bwd_dkdv(*ops)
                    if part != "dkdv":
                        vl.varlen_bwd_dq(*ops)
                calls[tag] = kern
            if part == "pair":
                def library():
                    torch.autograd.grad(res, leaves, g4, retain_graph=True)
                calls["library"] = library
            case["ms"][part] = turns(cs, torch, calls, 3)
        lib_ms = case["ms"]["pair"]["library"][0]
        case["pair_vs_library"] = max(case["ms"]["pair"]["later"]) / lib_ms
        case["speedup_pair"] = (min(case["ms"]["pair"]["earlier"])
                                / max(case["ms"]["pair"]["later"]))
        out[name] = case
        print(json.dumps({name: case}), flush=True)
        del res, leaves, q4, k4, v4, g4, mask, ops, q, k, v, g, qp, kp, vp
        del gp, lse2, delta, o, masks
        torch.cuda.empty_cache()
    out["failed"] = failed
    out["ok"] = not failed
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "result.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
