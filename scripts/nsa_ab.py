#!/usr/bin/env python3
"""Hold the NSA kernels against another version of their sources: the
same bytes where they must be, and the time of each.

    python3 scripts/nsa_ab.py EARLIER_CSRC [LATER_CSRC] [--out DIR]
                              [--cases nsa_fwd,nsa_decode,...]

``EARLIER_CSRC`` (and ``LATER_CSRC``, by default this checkout's
``tilelang_mesh_tpu_torch/csrc``) are directories holding ``nsa.cu``
and / or ``nsa_bwd.cu`` with their headers and the same C entry points,
for example a parent commit's ``csrc`` from ``git archive`` unpacked
under ``build/``. Each source the earlier directory holds is built from
both with nvcc into ``DIR`` (default ``build/nsa_ab``), all builds at
once, and called through the port's wrappers at chip_smoke.py's NSA
widths (NSA: T 8192, 64 / 4 heads of 128, 16 selected blocks of 64;
decode B 8 over 65536 keys), float32, bfloat16 and float16, on q, k, v
(and dO) standard normal from default_rng(12) (``nsa.cu``) or
default_rng(14) (``nsa_bwd.cu``), the selections from
``nsa_selections`` on the same generator:

* ``nsa.cu``: the fused forward ``nsa_fwd`` (the 512-token window,
  gates uniform in [0.2, 1]), ``nsa_fwd_partial`` (window 0),
  ``nsa_varlen_fwd`` (chip_smoke.py's packed documents) and
  ``nsa_decode``. An earlier ``tl_nsa_decode`` without
  ``tl_nsa_decode_combine`` beside it has the one-launch contract (O
  written directly) and is called so; the later build's decode is also
  timed at each split count of ``SPLIT_SWEEP`` (``nsa_decode_partials``
  and ``nsa_decode_combine`` called directly).
* ``nsa_bwd.cu``: ``nsa_bwd_dkdv`` and ``nsa_bwd_dq`` (window 0, their
  residuals from the later build's partial forward, the incoming
  gradient standard normal). dK / dV is also timed by its parts
  (``dkdv_plan``, the kernel alone through ``dkdv_partials``, the sum
  through ``dkdv_sum``) in both builds, and the later build's call at
  each chunk size of ``CHUNK_SWEEP`` (``DKDV_CHUNK_ROWS``, bfloat16: the
  kernel and the sum, without the plan, whose host syncs vary by more
  than the sizes do).

float32 ``nsa_fwd``, ``nsa_fwd_partial``, ``nsa_varlen_fwd``,
``nsa_bwd_dkdv`` and ``nsa_bwd_dq`` must be bit-equal between the
builds; every other output is held against its plain version (normwise,
chip_smoke.py's ATTN_TOL), the float32 ones too. ``--cases`` runs only
the named cases (all by default). Each wrapper is timed with CUDA events
behind a spin, the two builds in turns (earlier, later, later, earlier).

The other users of the attention headers (``SHARED``: the users of
``attention_tile.cuh`` and of ``attention_mma.cuh``) must compile to
the same code: a source whose bytes (with the headers it includes) are
equal in both directories is reported "same bytes"; one that differs is
built from both and its SASS (``cuobjdump -sass``, instructions only)
compared. So are every function of ``nsa.cu`` and the float32
instances of ``nsa_bwd.cu`` that both builds hold (``nsa_bwd_dkdv<D,
0>``, ``nsa_bwd_dq<BM, D, 0>`` and the sum): each must be the same SASS.
Prints one JSON line with the card's name and power limit,
each build's registers and spill stores (``-Xptxas -v``) and nvcc time;
exits 1 when a required equality fails. Needs one NVIDIA card; exits
non-zero without one.
"""

import argparse
import ctypes
import hashlib
import importlib
import json
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SOURCES = ("nsa", "nsa_bwd")
# the other sources built on the headers nsa.cu includes
SHARED = ("attention_sink", "blocksparse_attention",
          "flash_attention_varlen", "minference", "flash_attention",
          "gqa_bwd")
TYPES = ("float32", "bfloat16", "float16")
# decode's split counts timed beside the card's own choice
SPLIT_SWEEP = (1, 2, 4, 8, 16)
# dK / dV's chunk sizes ((token, query head) rows) timed beside the
# port's DKDV_CHUNK_ROWS
CHUNK_SWEEP = (512, 1024, 2048, 4096, 8192)
# the float32 functions of nsa_bwd.cu whose SASS must not change
F32_BWD = r"nsa_bwd_dkdvILi\d+ELi0E|nsa_bwd_dqILi\d+ELi\d+ELi0E|nsa_bwd_dkdv_sum"


def closure(src_dir, name):
    """sha256 of ``name``.cu and every header it includes, transitively."""
    h, seen, todo = hashlib.sha256(), set(), [f"{name}.cu"]
    while todo:
        f = todo.pop(0)
        if f in seen or not (src_dir / f).is_file():
            continue
        seen.add(f)
        text = (src_dir / f).read_bytes()
        h.update(f.encode() + text)
        todo += re.findall(r'#include "([^"]+)"', text.decode())
    return h.hexdigest()


def build(job):
    """(library path, ptxas log, seconds) of one (tag, src_dir, name,
    out_dir) job."""
    from tilelang_mesh_tpu_torch.ops import _build
    tag, src_dir, name, out_dir = job
    d = out_dir / tag
    lib = d / f"lib{name}.so"
    t0 = time.perf_counter()
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                          str(d / f"{name}.cu")], capture_output=True,
                         text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {tag} {name}:\n{res.stderr}")
    return lib, res.stdout + res.stderr, time.perf_counter() - t0


def sass(lib):
    """{function: its instruction lines} of ``cuobjdump -sass``; the
    anonymous namespace's name, which hashes the source's path, cut out
    of the function names, and each run of blanks made one (the dump pads
    its columns to the library's longest instruction, so a kernel added
    beside a function would change its every line)."""
    from tilelang_mesh_tpu_torch.ops import _build
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    funcs, cur = {}, None
    for ln in out.splitlines():
        ln = re.sub(r"\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "ANON", ln.strip())
        ln = re.sub(r"\s+", " ", ln)
        if "Function :" in ln:
            cur = funcs.setdefault(ln.split("Function :")[1].strip(), [])
        elif cur is not None and re.search(r"/\*[0-9a-f]{4}\*/", ln):
            cur.append(ln)
    return funcs


def same_sass(a, b, out_file):
    """Whether two builds' SASS agree, function by function; the first
    differing lines of each function that differs go to ``out_file``
    (under ``--out``)."""
    import difflib
    diffs = []
    for name in sorted(set(a) | set(b)):
        if a.get(name) != b.get(name):
            diffs += [f"== {name}"] + list(difflib.unified_diff(
                a.get(name, []), b.get(name, []), lineterm="", n=0))[:40]
    if diffs:
        out_file.parent.mkdir(parents=True, exist_ok=True)
        out_file.write_text("\n".join(diffs) + "\n")
    return not diffs


def inputs(torch, cs, seed, n, n_gates):
    """``n`` standard normal tensors at NSA's q / k / v / q shapes, then
    ``n_gates`` gates and the selections, from default_rng(seed) (the
    order chip_smoke.py's sparse_inference phase draws in); the
    generator, for more draws."""
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
    return base, gates, bi, rng


def old_decode(torch, lib, q4, kh, vh, bi, cnt, gs, BS, sm):
    """An earlier build's one-launch ``tl_nsa_decode`` (O written by the
    kernel: the contract before the split)."""
    from tilelang_mesh_tpu_torch.ops.gemm import DTYPE_CODES
    fn = lib.tl_nsa_decode
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 3
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    B, H, G, D = q4.shape
    o = torch.empty_like(q4)
    code = fn(q4.data_ptr(), kh.data_ptr(), vh.data_ptr(), bi.data_ptr(),
              cnt.data_ptr(), gs.data_ptr(), o.data_ptr(), B, H, G,
              kh.shape[2], D, bi.shape[-1], BS, *kh.stride()[:3],
              DTYPE_CODES[q4.dtype], sm * 1.4426950408889634,
              torch.cuda.current_stream().cuda_stream)
    if code:
        raise RuntimeError(f"earlier tl_nsa_decode refused: {code}")
    return o


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("earlier", type=Path)
    ap.add_argument("later", type=Path, nargs="?",
                    default=ROOT / "tilelang_mesh_tpu_torch" / "csrc")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "nsa_ab")
    ap.add_argument("--cases", default=None,
                    help="comma-separated case names (default: all)")
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
    dirs = {"earlier": args.earlier, "later": args.later}
    for tag, src in dirs.items():
        (args.out / tag).mkdir(parents=True)
        for f in src.glob("*.cu*"):
            shutil.copy(f, args.out / tag / f.name)
    names = [n for n in SOURCES if (args.earlier / f"{n}.cu").is_file()]
    shared = {n: ("same bytes" if closure(args.earlier, n)
                  == closure(args.later, n) else None) for n in SHARED}
    jobs = [(tag, dirs[tag], n, args.out) for n in names + [
        n for n, v in shared.items() if v is None] for tag in dirs]
    with ThreadPoolExecutor(max_workers=len(jobs)) as ex:
        built = dict(zip([(j[0], j[2]) for j in jobs], ex.map(build, jobs)))
    diff_dir = args.out / "sass_diffs"
    for n, v in shared.items():
        if v is None:
            shared[n] = ("same SASS" if same_sass(
                sass(built["earlier", n][0]), sass(built["later", n][0]),
                diff_dir / f"{n}.diff") else "SASS differs")
    # every function of nsa.cu, and the float32 instances of nsa_bwd.cu
    # that both builds have: the same SASS (the first differences to
    # DIR/sass_diffs)
    kept_sass = {}
    for n in names:
        a, b = (sass(built[tag, n][0]) for tag in dirs)
        keep = [fn for fn in sorted(set(a) & set(b))
                if n == "nsa" or re.search(F32_BWD, fn)]
        kept_sass.update({fn: a[fn] == b[fn] for fn in keep})
        same_sass({fn: a[fn] for fn in keep}, {fn: b[fn] for fn in keep},
                  diff_dir / f"{n}_kept.diff")
        if n == "nsa":
            kept_sass["nsa.cu: the same functions"] = set(a) == set(b)
    libs = {n: {tag: ctypes.CDLL(str(built[tag, n][0])) for tag in dirs}
            for n in names}
    regs = {n: {tag: {"nvcc_s": round(built[tag, n][2], 1),
                      "registers_spills": cs.kernel_registers(
                          built[tag, n][1])} for tag in dirs}
            for n in names}
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
    out = {"card": smi, "shared_sources": shared, "builds": regs,
           "kept_functions_same_sass": kept_sass}
    # (name, make(dtype) -> (call(tag), plain() or None), bit-equal in f32)
    cases = []
    if "nsa" in libs:
        base, gates, bi, rng = inputs(torch, cs, 12, 3, 2)
        gs, gw = (g.reshape(1, T, Hk, G) for g in gates)

        def views(dtype):
            q, k, v = (t.cuda().to(dtype) for t in base)
            return q.reshape(1, T, Hk, G, D), k.transpose(1, 2), \
                v.transpose(1, 2)

        def fused(dtype):
            q5, kh, vh = views(dtype)
            return (lambda tag: (nsa.nsa_fwd(q5, kh, vh, bi, cnt, gs, gw, BS,
                                             W, sm),),
                    lambda: (nsa.nsa_fwd_plain(q5, kh, vh, bi, cnt, gs, gw,
                                               BS, W, sm),))

        def partial(dtype):
            q5, kh, vh = views(dtype)
            return (lambda tag: nsa.nsa_fwd_partial(q5, kh, vh, bi, cnt, BS,
                                                    sm),
                    lambda: nsa.nsa_fwd_partial_plain(q5, kh, vh, bi, cnt,
                                                      BS, sm))

        lens = cs.nsa_documents()
        cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
        pos = np.concatenate([np.arange(n) for n in lens])
        vbi = torch.from_numpy(cs.nsa_selections(rng, pos, Hk, S, BS)).cuda()
        offs, vcnt = nsa.varlen_offsets(vbi, cnt[0], cu, BS)

        def varlen(dtype):
            q5, kh, vh = views(dtype)
            a = (q5, kh, vh, offs[None], vcnt[None], gs, BS, sm)
            return (lambda tag: (nsa.nsa_varlen_fwd(*a),),
                    lambda: (nsa.nsa_varlen_fwd_plain(*a),))

        Bd, Tk = c["decode_batch"], c["decode_context"]
        dbase = [torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
                 for s in ((Bd, HQ, D), (Bd, Tk, Hk, D), (Bd, Tk, Hk, D))]
        dg = torch.from_numpy(rng.uniform(0.2, 1.0, (Bd, Hk, G)).astype(
            np.float32)).cuda()
        dbi = torch.from_numpy(cs.nsa_selections(
            rng, np.full(Bd, Tk - 1), Hk, S, BS)).cuda()
        dcnt = torch.full((Bd, Hk), S, dtype=torch.int32, device="cuda")
        split_earlier = hasattr(libs["nsa"]["earlier"],
                                "tl_nsa_decode_combine")

        def decode(dtype, splits=None):
            q, k, v = (t.cuda().to(dtype) for t in dbase)
            a = (q.reshape(Bd, Hk, G, D), k.transpose(1, 2),
                 v.transpose(1, 2), dbi, dcnt, dg, BS, sm)

            def call(tag):
                if tag == "earlier" and not split_earlier:
                    return (old_decode(torch, libs["nsa"]["earlier"], *a),)
                if splits is None:
                    return (nsa.nsa_decode_fwd(*a),)
                return (nsa.nsa_decode_combine(*nsa.nsa_decode_partials(
                    *a[:5], BS, sm, splits), dg, dtype),)
            return call, lambda: (nsa.nsa_decode_fwd_plain(*a),)

        cases += [("nsa_fwd", fused, True), ("nsa_fwd_partial", partial, True),
                  ("nsa_varlen_fwd", varlen, True),
                  ("nsa_decode", decode, False)]
    if "nsa_bwd" in libs:
        base_b, _, bi_b, _ = inputs(torch, cs, 14, 4, 1)
        mask = nb.nsa_block_mask(bi_b, cnt, T, T // BS, BS)

        def residuals(dtype):
            q, k, v, do = (t.cuda().to(dtype) for t in base_b)
            q5, do5 = (q.reshape(1, T, Hk, G, D), do.reshape(1, T, Hk, G, D))
            kh, vh = k.transpose(1, 2), v.transpose(1, 2)
            which[0] = "later"
            acc, m, l = nsa.nsa_fwd_partial(q5, kh, vh, bi_b, cnt, BS, sm)
            o = torch.where(l[..., None] > 0, acc / l[..., None],
                            0.0).to(dtype)
            delta = (do5.float() * o.float()).sum(-1)
            return q5, kh, vh, do5, m + torch.log2(l), delta

        def dkdv(dtype):
            a = residuals(dtype)
            return (lambda tag: nb.nsa_bwd_dkdv(*a, mask, BS, sm),
                    lambda: nb.nsa_bwd_dkdv_plain(*a, mask, BS, sm))

        def dq(dtype):
            a = residuals(dtype)
            return (lambda tag: (nb.nsa_bwd_dq(*a, bi_b, cnt, BS, sm),),
                    lambda: (nb.nsa_bwd_dq_plain(*a, bi_b, cnt, BS, sm),))

        def dkdv_parts(dtype):
            """{part: call} of dK / dV: the plan, the kernel, the sum."""
            a = residuals(dtype)
            plan = nb.dkdv_plan(mask, G)
            ws = nb.dkdv_partials(*a, plan, BS, sm)
            return {"plan": lambda: nb.dkdv_plan(mask, G),
                    "kernel": lambda: nb.dkdv_partials(*a, plan, BS, sm),
                    "sum": lambda: nb.dkdv_sum(ws, plan[3], 1, Hk, T, D)}

        cases += [("nsa_bwd_dkdv", dkdv, True), ("nsa_bwd_dq", dq, True)]
    if args.cases:
        cases = [c for c in cases if c[0] in args.cases.split(",")]
    ok = all(v != "SASS differs" for v in shared.values()) \
        and all(kept_sass.values())
    tol = cs.ATTN_TOL
    for kname, make, exact in cases:
        for dtype in (getattr(torch, t) for t in TYPES):
            call, plain = make(dtype)
            got = {}
            for tag in ("earlier", "later"):
                which[0] = tag
                got[tag] = call(tag)
            torch.cuda.synchronize()
            name = str(dtype)[6:]
            rec = {}
            if exact and dtype == torch.float32:
                rec["bit_equal"] = all(torch.equal(a, b) for a, b in
                                       zip(got["earlier"], got["later"]))
                ok &= rec["bit_equal"]
            if plain is not None:
                want = plain()
                for tag in ("earlier", "later"):
                    rec[f"{tag}_normwise"] = max(
                        cs.normwise_err(a, b)[1]
                        for a, b in zip(got[tag], want))
                ok &= rec["later_normwise"] <= tol[name]
                del want
            del got
            times = {"earlier": [], "later": []}
            for tag in ("earlier", "later", "later", "earlier"):
                which[0] = tag
                times[tag].append(cs.device_ms(torch, lambda: call(tag),
                                               20 if kname == "nsa_decode"
                                               else 3))
            rec["ms"] = times
            if kname == "nsa_bwd_dkdv":
                fns = dkdv_parts(dtype)
                parts = {"earlier": {}, "later": {}}
                for tag in ("earlier", "later", "later", "earlier"):
                    which[0] = tag
                    for part, fn in fns.items():
                        parts[tag].setdefault(part, []).append(
                            cs.device_ms(torch, fn, 3))
                rec["parts_ms"] = parts
                del fns
            if kname == "nsa_bwd_dkdv" and dtype == torch.bfloat16:
                which[0] = "later"
                rows = nb.DKDV_CHUNK_ROWS
                rec["kernel_sum_ms_by_chunk_rows"] = {}
                for n in CHUNK_SWEEP:
                    nb.DKDV_CHUNK_ROWS = n
                    fns = dkdv_parts(dtype)
                    rec["kernel_sum_ms_by_chunk_rows"][n] = {
                        "chunks": nb.dkdv_plan(mask, G)[2].shape[0],
                        "ms": cs.device_ms(torch, lambda: (
                            fns["kernel"](), fns["sum"]()), 3)}
                    del fns
                nb.DKDV_CHUNK_ROWS = rows
            if kname == "nsa_decode":
                which[0] = "later"
                rec["splits"] = nsa.decode_splits(
                    Bd, Hk, S, nsa.resident_blocks(torch.device("cuda", 0),
                                                   G, D, dtype))
                rec["ms_by_splits"] = {}
                for n in SPLIT_SWEEP:
                    one = make(dtype, splits=n)[0]
                    rec["ms_by_splits"][n] = cs.device_ms(
                        torch, lambda: one("later"), 20)
            out[f"{kname}_{name}"] = rec
            torch.cuda.empty_cache()
    out["ok"] = bool(ok)
    print(json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
