#!/usr/bin/env python3
"""Hold the packed varlen attention forward and the block-sparse GEMM
against another version of their sources: the same bytes where they must
be, and the time of each.

    python3 scripts/varlen_sparse_gemm_ab.py EARLIER_CSRC [LATER_CSRC]
        [--out DIR] [--build DIR] [--cases prefill,pack,gemm]

``EARLIER_CSRC`` and ``LATER_CSRC`` (by default this checkout's
``tilelang_mesh_tpu_torch/csrc``) are directories holding
``flash_attention_varlen.cu`` and ``gemm_variants.cu`` with their
headers; the earlier one's have the C entry points ``tl_varlen_fwd``
(without tile arguments) and ``tl_blocksparse_gemm``, as a parent
commit's ``csrc`` from ``git archive`` unpacked under ``build/`` does
(the commits before the tensor-core varlen forward). Both sources are built from
both directories with nvcc, all builds at once. The earlier build is
called through those two entry points (the default tile; the tile loop
for the GEMM), the later one through the port's wrappers (``varlen_fwd``,
``varlen_fwd_partial``, ``blocksparse_matmul``), at chip_smoke.py's
main-path shapes:

* ``prefill``: the chunked-prefill step (VARLEN: 8 chunks of 512
  queries at the end of key lengths from default_rng(1), bottom-right,
  20 / 5 heads of 128; q, k, v standard normal from default_rng(4)),
  ``varlen_fwd``;
* ``pack``: the 16384-token pack of whole documents (lengths from
  default_rng(0), top-left causal; q, k, v from default_rng(3)),
  ``varlen_fwd`` and ``varlen_fwd_partial`` (#10p);
* ``gemm``: the block-sparse GEMM at LLaMA-2-7B's prefill gate/up (M
  4096, K 4096 -> N 11008, 128-square cells live where default_rng(0)'s
  draw after the operands' exceeds 0.5, as chip_smoke.py draws them).

In float32, bfloat16 and float16. float32 outputs must be bit-equal
between the builds; every output is held against the plain version
(normwise, chip_smoke.py's ATTN_TOL and GEMM_TOL). Each call is timed
with CUDA events behind a spin (chip_smoke.py's ``device_ms``) in turns:
earlier, later, library, later, earlier; the library call is SDPA over
the bool document mask with ``enable_gqa`` (attention) or the dense
``torch.matmul`` (the GEMM, which does 1 / density of the masked
product's work), and the GEMM is also timed on the port's ``matmul``.
Each 16-bit attention case is also timed at every tile that the later
build's ``mask_tiles`` (``attention_mma.cuh``) instantiates at its
head_dim, the wrapper's ``VARLEN_TILES`` entry set to each in turn; the
16-bit GEMM also at an all-ones mask and the port's ``matmul`` at the
TMA kernel's block (128 x 128 x 64). Each case has its bound: the
visible pairs' (the live cells') flops at the type's peak.

The float32 instances of the attention source (``varlen_fwd<D, 0, *>``)
and every function of the GEMM source that both builds hold must
compile to the same SASS, and so must every other source whose header
closure differs between the directories (a source whose bytes, with its
headers, are equal is reported "same bytes"; one that differs is built
from both and its SASS compared: ``scripts/nsa_ab.py``'s helpers; the
first differences go to DIR/sass_diffs, which holds nothing else; the
builds go to ``--build``, by default ``build/varlen_sparse_gemm_ab``).
Prints one JSON line with the card's name and power limit, each build's
registers and spill stores (``-Xptxas -v``) and nvcc time; exits 1 when
a required equality fails. Needs one NVIDIA card; exits non-zero
without one.
"""

import argparse
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
SOURCES = ("flash_attention_varlen", "gemm_variants")
TYPES = ("float32", "bfloat16", "float16")
# the attention source's float32 functions, whose SASS must not change
F32 = r"varlen_fwdILi\d+ELi0E"


def mask_tile_instances(csrc, D):
    """The (block_M, block_N) pairs that ``csrc``'s attention_mma.cuh
    instantiates in mask_tiles at head_dim D."""
    src = (csrc / "attention_mma.cuh").read_text()
    body = src[src.index("int mask_tiles("):]
    body = body[:body.index("\n}\n")]
    by_d = {}
    for d, pairs in re.findall(
            r"(?:D == (\d+)\)|else)\s*return run_tile<([\d, ]+)>", body):
        n = [int(x) for x in pairs.split(",")]
        by_d[int(d) if d else None] = list(zip(n[::2], n[1::2]))
    return by_d.get(D, by_d[None])


def earlier_varlen(torch, lib, q, k, v, masks, causal, sm, partial):
    """An earlier build's tl_varlen_fwd (its default tile) on the packed
    operands: O, or (acc, M, L) when ``partial``."""
    from tilelang_mesh_tpu_torch.ops.gemm import DTYPE_CODES
    # pack_varlen's F.pad leaves a transposed view where no row is padded
    q, k, v = (t.contiguous() for t in (q, k, v))
    Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[:2]
    nQ, nK = masks[4].shape
    if partial:
        o = q.new_empty((Hq, Tq, D), dtype=torch.float32)
        m = q.new_empty((Hq, Tq), dtype=torch.float32)
        l = torch.empty_like(m)
    else:
        o, m, l = torch.empty_like(q), None, None
    fn = lib.tl_varlen_fwd
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    code = fn(*(t.data_ptr() if t is not None else None
                for t in (q, k, v, *masks, o, m, l)),
              Hq, Hkv, Tq, Tk, D, Tq // nQ, Tk // nK, DTYPE_CODES[q.dtype],
              int(causal), int(partial), sm * 1.4426950408889634,
              torch.cuda.current_stream().cuda_stream)
    if code:
        raise RuntimeError(f"earlier tl_varlen_fwd refused: {code}")
    return (o, m, l) if partial else o


def earlier_gemm(torch, lib, a, b, mask, bm, bn):
    """An earlier build's tl_blocksparse_gemm (the tile loop)."""
    from tilelang_mesh_tpu_torch.ops.gemm import DTYPE_CODES
    M, K = a.shape
    N = b.shape[1]
    c = torch.empty((M, N), dtype=a.dtype, device=a.device)
    fn = lib.tl_blocksparse_gemm
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = fn(a.data_ptr(), b.data_ptr(), mask.data_ptr(), c.data_ptr(), M,
              N, K, bm, bn, DTYPE_CODES[a.dtype], DTYPE_CODES[a.dtype],
              torch.cuda.current_stream().cuda_stream)
    if code:
        raise RuntimeError(f"earlier tl_blocksparse_gemm refused: {code}")
    return c


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
    ap = argparse.ArgumentParser()
    ap.add_argument("earlier", type=Path)
    ap.add_argument("later", type=Path, nargs="?",
                    default=ROOT / "tilelang_mesh_tpu_torch" / "csrc")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "varlen_sparse_gemm_ab" / "out")
    ap.add_argument("--build", type=Path,
                    default=ROOT / "build" / "varlen_sparse_gemm_ab")
    ap.add_argument("--cases", default="prefill,pack,gemm",
                    help="comma-separated case names (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("varlen_sparse_gemm_ab: no CUDA device", file=sys.stderr)
        return 2
    cases = args.cases.split(",")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    import chip_smoke as cs
    import nsa_ab
    from tilelang_mesh_tpu_torch.ops import _build
    from tilelang_mesh_tpu_torch.ops import gemm as gm
    from tilelang_mesh_tpu_torch.ops import gemm_variants as gv
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
                    if p.stem not in SOURCES)
    shared = {n: ("same bytes" if nsa_ab.closure(args.earlier, n)
                  == nsa_ab.closure(args.later, n) else None)
              for n in others}
    jobs = [(tag, dirs[tag], n, args.build) for n in SOURCES + tuple(
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
    kept_sass = {}
    for n in SOURCES:
        a, b = (nsa_ab.sass(built[tag, n][0]) for tag in dirs)
        keep = [fn for fn in sorted(set(a) & set(b))
                if n == "gemm_variants" or re.search(F32, fn)]
        kept_sass.update({fn: a[fn] == b[fn] for fn in keep})
        nsa_ab.same_sass({fn: a[fn] for fn in keep},
                         {fn: b[fn] for fn in keep},
                         diff_dir / f"{n}_kept.diff")
    libs = {n: {tag: ctypes.CDLL(str(built[tag, n][0])) for tag in dirs}
            for n in SOURCES}
    regs = {n: {tag: {"nvcc_s": round(built[tag, n][2], 1),
                      "registers_spills": {
                          k: v for k, v in cs.kernel_registers(
                              built[tag, n][1]).items()
                          if "varlen" in k or "blocksparse" in k}}
                for tag in dirs} for n in SOURCES}
    load = _build.load
    _build.load = lambda name: (libs[name]["later"] if name in libs
                                else load(name))
    out = {"card": smi, "shared_sources": shared, "builds": regs,
           "kept_functions_same_sass": kept_sass}
    ok = (all(v != "SASS differs" for v in shared.values())
          and all(kept_sass.values()))

    c = cs.VARLEN
    Hq, Hkv, D = c["heads"], c["kv_heads"], c["head_dim"]
    sm = 1.0 / math.sqrt(D)

    def cu_of(lens):
        return np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)

    varlen_cases = {}
    if "prefill" in cases:
        lens_k = [int(n) for n in np.random.default_rng(1).integers(
            c["chunk"], c["context"] + 1, size=c["chunks"])]
        varlen_cases["prefill"] = ([c["chunk"]] * c["chunks"], lens_k, 4,
                                   "bottom-right", (False,))
    if "pack" in cases:
        lens = cs.varlen_pack_lengths(c)
        varlen_cases["pack"] = (lens, lens, 3, "top-left", (False, True))
    for case, (lens_q, lens_k, seed, align, partials) in \
            varlen_cases.items():
        cu_q, cu_k = cu_of(lens_q), cu_of(lens_k)
        tq, tk = int(cu_q[-1]), int(cu_k[-1])
        rng = np.random.default_rng(seed)
        base = [torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
                for s in ((tq, Hq, D), (tk, Hkv, D), (tk, Hkv, D))]
        for tname in TYPES:
            dtype = getattr(torch, tname)
            q, k, v = (t.cuda().to(dtype) for t in base)
            qp, kp, vp, masks = vl.pack_varlen(q, k, v, cu_q, cu_k, True,
                                               causal_align=align)
            vis = vl._visible(*(t[:n] for t, n in zip(
                masks[:4], (tq, tk, tq, tk))), True)
            pairs = int(vis.sum(dtype=torch.int64)) * Hq
            q4, k4, v4 = (t.transpose(0, 1)[None] for t in (q, k, v))
            for partial in partials:
                key = f"{case}_{'partial_' if partial else ''}{tname}"
                op = vl.varlen_fwd_partial if partial else vl.varlen_fwd

                def later():
                    return op(qp, kp, vp, *masks, True, sm)

                def earlier():
                    return earlier_varlen(torch, libs[SOURCES[0]]["earlier"],
                                          qp, kp, vp, masks, True, sm,
                                          partial)

                def library():
                    return F.scaled_dot_product_attention(
                        q4, k4, v4, attn_mask=vis, enable_gqa=True)
                got = {"earlier": earlier(), "later": later()}
                torch.cuda.synchronize()
                plain = (vl.varlen_fwd_partial_plain if partial
                         else vl.varlen_fwd_plain)(qp, kp, vp, *masks, True,
                                                   sm)
                rec = {"kernel": ("varlen_fwd (CUDA cores)"
                                  if dtype == torch.float32 else
                                  "varlen_fwd_mma %dx%d"
                                  % vl.varlen_tile(D)),
                       "visible_pairs": pairs}
                outs = {t: (g if isinstance(g, tuple) else (g,))
                        for t, g in got.items()}
                want = plain if isinstance(plain, tuple) else (plain,)
                if dtype == torch.float32:
                    rec["bit_equal"] = all(
                        torch.equal(a, b) for a, b in zip(
                            outs["earlier"], outs["later"]))
                    ok &= rec["bit_equal"]
                for tag, o in outs.items():
                    if partial:   # acc and l; M where l > 0
                        seen = want[2] > 0
                        errs = [cs.normwise_err(o[0], want[0])[1],
                                cs.normwise_err(o[2], want[2])[1],
                                cs.normwise_err(o[1][seen],
                                                want[1][seen])[1]]
                        if tag == "later":
                            dead_ok = (bool((o[1][~seen] == -1e30).all())
                                       and not o[2][~seen].any()
                                       and not o[0][~seen].any())
                            rec["dead_rows_exact"] = dead_ok
                            ok &= dead_ok
                        rec[f"{tag}_normwise"] = max(errs)
                    else:
                        rec[f"{tag}_normwise"] = cs.normwise_err(
                            o[0], want[0])[1]
                ok &= rec["later_normwise"] <= cs.ATTN_TOL[tname]
                calls = {"earlier": earlier, "later": later}
                if not partial:
                    rec["pad_tail_zero"] = not outs["later"][0][:, tq:].any()
                    ok &= rec["pad_tail_zero"]
                if dtype != torch.float32:
                    calls["library"] = library
                    rec["library"] = "SDPA, bool document mask, enable_gqa"
                    if not partial:
                        rec["library_normwise"] = cs.normwise_err(
                            library()[0], want[0][:, :tq])[1]
                del got, outs, want, plain
                rec["ms"] = turns(cs, torch, calls, 3 if case == "pack"
                                  else 5)
                peak = (cs.PEAK_F32_FLOPS if dtype == torch.float32
                        else cs.PEAK_BF16_FLOPS)
                rec["bound_ms"] = 4 * D * pairs / peak * 1e3
                if dtype != torch.float32:
                    rec["by_tile"] = {}
                    keep = vl.VARLEN_TILES[D]
                    for tile in mask_tile_instances(args.later, D):
                        vl.VARLEN_TILES[D] = tile
                        rec["by_tile"]["x".join(map(str, tile))] = \
                            cs.device_ms(torch, later, 3)
                    vl.VARLEN_TILES[D] = keep
                out[key] = rec
            del q, k, v, qp, kp, vp, masks, vis, q4, k4, v4
            torch.cuda.empty_cache()

    if "gemm" in cases:
        L = cs.LLAMA2
        M, K, N = L["prefill"], L["hidden"], L["inter"]
        rng = np.random.default_rng(0)
        a32 = torch.from_numpy((rng.standard_normal((M, K)) * 0.1).astype(
            np.float32)).cuda()
        b32 = torch.from_numpy((rng.standard_normal((K, N)) * 0.1).astype(
            np.float32)).cuda()
        mask = torch.from_numpy((rng.random((M // 128, N // 128)) > 0.5)
                                .astype(np.int32)).cuda()
        ones = torch.ones_like(mask)
        density = float(mask.float().mean())
        flops = 2 * M * N * K * density
        out["gemm_density"] = density
        for tname in TYPES:
            dtype = getattr(torch, tname)
            a, b = a32.to(dtype), b32.to(dtype)

            def later(m=mask):
                return gv.blocksparse_matmul(a, b, m)

            def earlier():
                return earlier_gemm(torch, libs[SOURCES[1]]["earlier"], a,
                                    b, mask, 128, 128)
            got = {"earlier": earlier(), "later": later()}
            want = gv.blocksparse_matmul_plain(a, b, mask)
            rec = {"kernel": gv.blocksparse_path(M, N, K, dtype,
                                                 a.data_ptr(), b.data_ptr())}
            if rec["kernel"] == "tma":
                rec["tile"] = [128, 128, 64]
            live = (mask != 0).repeat_interleave(128, 0).repeat_interleave(
                128, 1)
            rec["dead_cells_zero"] = not bool(got["later"][~live].any())
            ok &= rec["dead_cells_zero"]
            if dtype == torch.float32:
                rec["bit_equal"] = torch.equal(got["earlier"], got["later"])
                ok &= rec["bit_equal"]
            for tag, o in got.items():
                rec[f"{tag}_normwise"] = cs.normwise_err(o, want)[1]
            ok &= rec["later_normwise"] <= cs.GEMM_TOL[tname]
            dense = later(ones)
            rec["all_ones_vs_matmul_normwise"] = cs.normwise_err(
                dense, gm.matmul(a, b))[1]
            ok &= rec["all_ones_vs_matmul_normwise"] <= cs.GEMM_TOL[tname]
            del got, want, dense, live
            rec["ms"] = turns(cs, torch, {
                "earlier": earlier, "later": later,
                "library": lambda: torch.matmul(a, b)}, 3)
            rec["matmul_ms"] = cs.device_ms(torch, lambda: gm.matmul(a, b),
                                            3)
            peak = (cs.PEAK_F32_FLOPS if dtype == torch.float32
                    else cs.PEAK_BF16_FLOPS)
            rec["bound_ms"] = max(flops / peak,
                                  (M * K + K * N + M * N)
                                  * a.element_size() / cs.PEAK_BYTES_S) * 1e3
            if dtype != torch.float32:
                rec["all_ones_ms"] = cs.device_ms(torch,
                                                  lambda: later(ones), 3)
                rec["matmul_same_block_ms"] = cs.device_ms(
                    torch, lambda: gm.matmul(a, b, block_M=128, block_N=128,
                                             block_K=64), 3)
            out[f"gemm_{tname}"] = rec
            del a, b
            torch.cuda.empty_cache()
    out["ok"] = bool(ok)
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "result.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
