#!/usr/bin/env python3
"""Hold the sparse-mask attention forwards against another version of
their sources: the same bytes where they must be, and the time of each.

    python3 scripts/sparse_attn_ab.py EARLIER_CSRC [LATER_CSRC] [--out DIR]
                                      [--build DIR] [--cases random,...]

``EARLIER_CSRC`` (and ``LATER_CSRC``, by default this checkout's
``tilelang_mesh_tpu_torch/csrc``) are directories holding
``blocksparse_attention.cu`` and ``minference.cu`` with their headers
and the C entry points ``tl_blocksparse_mha`` and ``tl_vs_sparse``, for
example a parent commit's ``csrc`` from ``git archive`` unpacked under
``build/``. Both sources are built from both directories with nvcc, all
builds at once. The
earlier build is called through those two entry points (the default
tile), the later one through the port's wrappers (``blocksparse_mha``,
``vs_sparse``), at chip_smoke.py's main-path shapes, in float32,
bfloat16 and float16:

* ``random``: block-sparse attention at SPARSE_ATTN (B 1, 32 heads of
  128, S 4096, 128-square cells live at random at density 0.5, not
  causal; q, k, v standard normal from default_rng(8), the mask from
  default_rng(6));
* ``seer``: the same q, k, v under seer's top-8 causal mask of
  default_rng(7)'s gate logits;
* ``vs_sparse``: vertical-slash attention at MINFERENCE (32 heads of
  128, S 16384, cells of 64, 1000 columns and 6096 slashes from
  chip_smoke.py's estimator; q, k, v from default_rng(11)).

float32 outputs must be bit-equal between the builds; every output is
held against the plain version (normwise, chip_smoke.py's ATTN_TOL).
Each call is timed with CUDA events behind a spin (chip_smoke.py's
``device_ms``) in turns: earlier, later, SDPA over the dense bool mask
(the library yardstick, as chip_smoke.py times it), later, earlier.
Each 16-bit case is also timed at every tile of the later build's
instances (``BLOCKSPARSE_TILES`` / ``VS_TILES`` narrowed to one), each
with the pairs its live tiles compute (``chip_smoke.tile_pairs``) and
that work's time at the peak.

The float32 instances of the two sources (``blocksparse_mha<D, 0>``,
``vs_sparse<D, 0>``) must compile to the same SASS in both builds, and
so must every other source that includes a header these two do
(``SHARED``): a source whose bytes (with its headers) are equal in both
directories is reported "same bytes", one that differs is built from
both and its SASS compared (``scripts/nsa_ab.py``'s helpers; the first
differences go to DIR/sass_diffs, which holds nothing else, so DIR
stays small; the builds go to ``--build``, by default
``build/sparse_attn_ab``). Prints one JSON line with the card's
name and power limit, each build's registers and spill stores
(``-Xptxas -v``) and nvcc time; exits 1 when a required equality fails.
Needs one NVIDIA card; exits non-zero without one.
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
SOURCES = ("blocksparse_attention", "minference")
# the other sources built on the headers the two include
# (attention_mma.cuh, attention_tile.cuh, varlen_common.cuh)
SHARED = ("attention_sink", "flash_attention", "gqa_bwd", "nsa", "nsa_bwd",
          "flash_attention_varlen", "varlen_bwd")
TYPES = ("float32", "bfloat16", "float16")
# the float32 functions of the two sources whose SASS must not change
F32 = r"blocksparse_mhaILi\d+ELi0E|vs_sparseILi\d+ELi0E"


def earlier_call(torch, lib, name, q, k, v, masks, blk, causal, sm):
    """An earlier build's entry point (the default tile) on q, k, v."""
    from tilelang_mesh_tpu_torch.ops.gemm import DTYPE_CODES
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    o = torch.empty_like(q)
    scale = sm * 1.4426950408889634
    stream = torch.cuda.current_stream().cuda_stream
    if name == "vs_sparse":
        fn = lib.tl_vs_sparse
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                *(m.data_ptr() for m in masks), o.data_ptr(), B, H, Sq, Sk,
                D, blk, blk, DTYPE_CODES[q.dtype], scale, stream)
    else:
        fn = lib.tl_blocksparse_mha
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), masks[0].data_ptr(),
                o.data_ptr(), B, H, Sq, Sk, D, blk, blk,
                DTYPE_CODES[q.dtype], int(causal), scale, stream)
    fn.restype = ctypes.c_int
    code = fn(*args)
    if code:
        raise RuntimeError(f"earlier {name} refused: {code}")
    return o


def main() -> int:
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    ap = argparse.ArgumentParser()
    ap.add_argument("earlier", type=Path)
    ap.add_argument("later", type=Path, nargs="?",
                    default=ROOT / "tilelang_mesh_tpu_torch" / "csrc")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "sparse_attn_ab" / "out")
    ap.add_argument("--build", type=Path,
                    default=ROOT / "build" / "sparse_attn_ab")
    ap.add_argument("--cases", default=None,
                    help="comma-separated case names (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sparse_attn_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    import chip_smoke as cs
    import nsa_ab
    from tilelang_mesh_tpu_torch.ops import _build
    # the package's ops/__init__ shadows these modules with functions
    bsa, mi, seer = (importlib.import_module(
        f"tilelang_mesh_tpu_torch.ops.{m}") for m in (
            "blocksparse_attention", "minference", "seer_attention"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    shutil.rmtree(args.build, ignore_errors=True)
    dirs = {"earlier": args.earlier, "later": args.later}
    for tag, src in dirs.items():
        (args.build / tag).mkdir(parents=True)
        for f in src.glob("*.cu*"):
            shutil.copy(f, args.build / tag / f.name)
    shared = {n: ("same bytes" if nsa_ab.closure(args.earlier, n)
                  == nsa_ab.closure(args.later, n) else None) for n in SHARED}
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
        keep = [fn for fn in sorted(set(a) | set(b)) if re.search(F32, fn)]
        kept_sass.update({fn: a.get(fn) == b.get(fn) for fn in keep})
        nsa_ab.same_sass({fn: a.get(fn) for fn in keep},
                         {fn: b.get(fn) for fn in keep},
                         diff_dir / f"{n}_f32.diff")
    libs = {n: {tag: ctypes.CDLL(str(built[tag, n][0])) for tag in dirs}
            for n in SOURCES}
    regs = {n: {tag: {"nvcc_s": round(built[tag, n][2], 1),
                      "registers_spills": cs.kernel_registers(
                          built[tag, n][1])} for tag in dirs}
            for n in SOURCES}
    _build.load = lambda name: libs[name]["later"]
    out = {"card": smi, "shared_sources": shared, "builds": regs,
           "f32_functions_same_sass": kept_sass}
    ok = (all(v != "SASS differs" for v in shared.values())
          and all(kept_sass.values()))

    # the main paths' inputs, drawn as chip_smoke.py draws them
    c = cs.SPARSE_ATTN
    H, D, S, blk = c["heads"], c["head_dim"], c["seq"], c["block"]
    rng = np.random.default_rng(8)
    base_bs = [torch.from_numpy(rng.standard_normal((1, H, S, D),
                                                    dtype=np.float32))
               for _ in range(3)]
    n = S // blk
    rand_mask = torch.from_numpy(
        (np.random.default_rng(6).random((1, H, n, n)) < c["density"])
        .astype(np.int32)).cuda()
    gates = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (1, H, n, n)).astype(np.float32)).cuda()
    seer_mask = seer.seer_block_mask(gates, c["topk"], blk, blk)
    cases = {"random": ("blocksparse_mha", base_bs, [rand_mask], blk, False),
             "seer": ("blocksparse_mha", base_bs, [seer_mask], blk, True)}
    c = cs.MINFERENCE
    if not args.cases or "vs_sparse" in args.cases.split(","):
        Hv, Dv, Sv, bv = c["heads"], c["head_dim"], c["seq"], c["block"]
        rng = np.random.default_rng(11)
        rep = Hv // c["kv_heads"]
        base_vs = [torch.from_numpy(rng.standard_normal(shape,
                                                        dtype=np.float32))
                   for shape in ((1, Hv, Sv, Dv), (1, c["kv_heads"], Sv, Dv),
                                 (1, c["kv_heads"], Sv, Dv))]
        base_vs[1:] = [t.repeat_interleave(rep, 1) for t in base_vs[1:]]
        q, k = (t.cuda() for t in base_vs[:2])
        v_idx, s_idx = cs.vs_estimate(torch, q, k, c["vertical"],
                                      c["slash"], c["last_q"])
        del q, k
        # contiguous, as the earlier build's entry point reads them
        vm, bm = (t.contiguous() for t in mi._build_masks(
            v_idx, s_idx, Sv, Sv, bv, bv))
        dm = mi.diagonal_mask(s_idx, Sv).contiguous()
        cases["vs_sparse"] = ("vs_sparse", base_vs, [vm, dm, bm], bv, True)
    if args.cases:
        cases = {k: v for k, v in cases.items()
                 if k in args.cases.split(",")}

    for case, (name, base, masks, blk, causal) in cases.items():
        Sc, Dc = base[0].shape[2], base[0].shape[3]
        sm = 1.0 / math.sqrt(Dc)
        lib = libs["minference" if name == "vs_sparse"
                   else "blocksparse_attention"]["earlier"]
        tiles = mi.VS_TILES if name == "vs_sparse" else bsa.BLOCKSPARSE_TILES
        # the dense bool mask SDPA takes (row chunks for the 8.6e9-entry
        # vertical-slash one)
        dense = torch.empty((1, base[0].shape[1], Sc, Sc), dtype=torch.bool,
                            device="cuda")
        if name == "vs_sparse":
            vm, dm, bm = masks
            j = torch.arange(Sc, device="cuda")
            for i0 in range(0, Sc, 1024):
                i = j[i0:i0 + 1024]
                d = i[:, None] - j[None, :]
                dense[:, :, i0:i0 + 1024] = (
                    ((vm != 0)[:, :, None, :] | (dm != 0)[:, :, d.clamp_min(0)])
                    & (d >= 0) & (bm != 0)[:, :, i // blk][..., j // blk])
            seen = dense.any(-1)
        else:
            dense.copy_(bsa.dense_mask(masks[0], blk, blk, causal))
            seen = None
        iters = 3 if name == "vs_sparse" else 5
        for tname in TYPES:
            dtype = getattr(torch, tname)
            q, k, v = (t.cuda().to(dtype) for t in base)
            if name == "vs_sparse":
                def later():
                    return mi.vs_sparse(q, k, v, *masks, blk, blk, sm)

                def plain():
                    return mi.vs_sparse_plain(q, k, v, *masks, blk, blk, sm)
                backends = ([SDPBackend.EFFICIENT_ATTENTION]
                            if dtype == torch.float32 else
                            [SDPBackend.CUDNN_ATTENTION,
                             SDPBackend.EFFICIENT_ATTENTION])
            else:
                def later():
                    return bsa.blocksparse_mha(q, k, v, masks[0], blk, blk,
                                               causal, sm)

                def plain():
                    return bsa.blocksparse_mha_plain(q, k, v, masks[0], blk,
                                                     blk, causal, sm)
                backends = None

            def earlier():
                return earlier_call(torch, lib, name, q, k, v, masks, blk,
                                    causal, sm)

            def library():
                if backends is None:
                    return F.scaled_dot_product_attention(q, k, v,
                                                          attn_mask=dense)
                with sdpa_kernel(backends):
                    return F.scaled_dot_product_attention(q, k, v,
                                                          attn_mask=dense)
            got = {"earlier": earlier(), "later": later()}
            torch.cuda.synchronize()
            want = plain()
            rec = {"tile": (list(mi.vs_tile(Dc, blk, blk) if name ==
                                 "vs_sparse" else bsa.blocksparse_tile(
                                     Dc, blk, blk, causal))
                            if dtype != torch.float32 else "CUDA cores")}
            if dtype == torch.float32:
                rec["bit_equal"] = torch.equal(got["earlier"], got["later"])
                ok &= rec["bit_equal"]
            for tag, o in got.items():
                rec[f"{tag}_normwise"] = cs.normwise_err(o, want)[1]
            if seen is not None:
                rec["dead_rows_zero"] = not got["later"][~seen].any()
                ok &= rec["dead_rows_zero"]
            lib_got = library()
            rows = seen if seen is not None else slice(None)
            rec["library_normwise"] = cs.normwise_err(lib_got[rows],
                                                      want[rows])[1]
            ok &= rec["later_normwise"] <= cs.ATTN_TOL[tname]
            del got, want, lib_got
            times = {"earlier": [], "later": [], "library": []}
            for tag, call in (("earlier", earlier), ("later", later),
                              ("library", library), ("later", later),
                              ("earlier", earlier)):
                times[tag].append(cs.device_ms(torch, call, iters))
            rec["ms"] = times
            if dtype != torch.float32:
                peak = cs.PEAK_BF16_FLOPS
                rec["by_tile"] = {}
                keep = tiles[Dc]
                for tile in dict.fromkeys(mi.VS_TILES[Dc]):
                    # the instances narrowed to one (with and without the
                    # causal mask for blocksparse_mha)
                    tiles[Dc] = ((tile,) if name == "vs_sparse"
                                 else ((tile,), (tile,)))
                    pairs = cs.tile_pairs(torch, masks[-1], blk, blk, Sc, Sc,
                                          tile, causal)
                    rec["by_tile"]["x".join(map(str, tile))] = {
                        "ms": cs.device_ms(torch, later, iters),
                        "tile_pairs": pairs,
                        "tile_work_at_peak_ms": 4 * Dc * pairs / peak * 1e3}
                tiles[Dc] = keep
            out[f"{case}_{tname}"] = rec
            del q, k, v
            torch.cuda.empty_cache()
        out[f"{case}_visible_pairs"] = int(dense.sum(dtype=torch.int64)) \
            if name != "vs_sparse" else sum(
                int(dense[:, :, i0:i0 + 1024].sum(dtype=torch.int64))
                for i0 in range(0, Sc, 1024))
        del dense, seen
        torch.cuda.empty_cache()
    out["ok"] = bool(ok)
    print(json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
