#!/usr/bin/env python3
"""Hold the sparse MLA forward (csrc/sparse_mla.cu, #41) against another
version of its source: each build against the plain version, the
float32 outputs bit for bit, the SASS of the kernels that must not
change, and the time of each in turns.

    python3 scripts/sparse_mla_ab.py EARLIER_CSRC [LATER_CSRC] [--out DIR]
        [--build DIR]

``EARLIER_CSRC`` and ``LATER_CSRC`` (by default this checkout's
``tilelang_mesh_tpu_torch/csrc``) are directories holding
``sparse_mla.cu`` with its headers, for example a parent commit's
``csrc`` from ``git archive`` unpacked under ``build/``. Each build is
called through its own C signature: ``tl_sparse_mla_fwd`` with the path
code (``ops/dsa.py::sparse_mla_path``'s kernel) where the later source
takes one, without it where it does not. All builds run at once (nvcc,
the port's flags), with two copies of the later source for the
bottleneck: ``no_gather`` (the 16-bit wgmma kernel's producer issues no
copy: the tiles' rows are what the stage held) and ``no_mma`` (its
consumers issue no wgmma: the scores are 0), timed in bfloat16 beside
the whole kernel; their outputs are not checked.

At chip_smoke.py's DSA widths (a 4096-query chunk over an 8192-token
cache, 128 heads, latent 512 + rope 64, top 2048), in float32, bfloat16
and float16, on the phase's draws (a seeded card generator, seed 21)
with ids from this checkout's indexer and selector: each build's O and
LSE against the plain version (normwise, printed; a check fails past
chip_smoke.py's DSA_TOL), the float32 outputs of the builds compared
bit for bit; each build timed with chip_smoke.py's ``device_ms`` (CUDA
events behind a spin) in turns (earlier, later, later, earlier). Prints
each build's path, registers and spill bytes (``nvcc -Xptxas -v``) and
the wgmma kernel's dynamic shared memory, the bytes a call gathers and
the rate that makes at each time, and the card's name and power limit;
writes DIR/result.json. The SASS of the float32 kernel and of the
mma.sync kernel must be the same in both builds. Exits 1 when a check
fails. Needs one NVIDIA card; exits non-zero without one.
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
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the kernels whose SASS must not change: float32 and mma.sync
KEPT = r"sparse_mla_fwdILi|sparse_mla_fwd_mmaI"
# copies of the later source for the bottleneck: (label, [(text, its
# replacement)])
VARIANTS = (
    ("no_gather", [("tl_gemm::cp_async16(d + k * 4 * 8192, src + k * 256, "
                    "id >= 0);", ";")]),
    ("no_mma", [("tl_sm90::wgmma16<E, 32, 0, 0>(", "(void)("),
                ("tl_sm90::wgmma16<E, NV, 0, 1>(", "(void)(")]))


def variant_dir(src_dir, label, subs, root):
    """A copy of ``src_dir`` under ``root/label`` whose sparse_mla.cu has
    each text of ``subs`` replaced."""
    dst = root / label
    shutil.copytree(src_dir, dst)
    f = dst / "sparse_mla.cu"
    src = f.read_text()
    for old, new in subs:
        if old not in src:
            raise RuntimeError(f"{label}: {old!r} not in sparse_mla.cu")
        src = src.replace(old, new)
    f.write_text(src)
    return dst


def wgmma_smem(D, DT):
    """The wgmma kernel's dynamic shared memory (sparse_mla.cu's
    WgLayout): Q and two stages of 64 rows, P, ids, masks, maxima, l,
    the barriers and 1024 bytes of alignment."""
    return (3 * 64 * (D + DT) * 2 + 64 * 64 * 2 + 2 * 64 * 4 + 2 * 8
            + 2 * 2 * 64 * 4 + 5 * 8 + 1024)


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("earlier", type=Path)
    ap.add_argument("later", type=Path, nargs="?",
                    default=ROOT / "tilelang_mesh_tpu_torch" / "csrc")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "sparse_mla_ab" / "out")
    ap.add_argument("--build", type=Path,
                    default=ROOT / "build" / "sparse_mla_ab")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sparse_mla_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    import chip_smoke as cs
    import nsa_ab
    from softmax_decode_ab import nvcc_build
    from tilelang_mesh_tpu_torch.ops.gemm import DTYPE_CODES
    dsa = importlib.import_module("tilelang_mesh_tpu_torch.ops.dsa")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    shutil.rmtree(args.build, ignore_errors=True)
    dirs = {"earlier": args.earlier, "later": args.later}
    for tag, src in dirs.items():
        (args.build / tag).mkdir(parents=True)
        for f in src.glob("*.cu*"):
            shutil.copy(f, args.build / tag / f.name)
    srcs = {tag: args.build / tag for tag in dirs}
    for label, subs in VARIANTS:
        srcs[label] = variant_dir(args.build / "later", label, subs,
                                  args.build / "variants")
    jobs = {tag: (d, "sparse_mla", d / "libsparse_mla.so")
            for tag, d in srcs.items()}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(jobs)) as ex:
        built = dict(zip(jobs, ex.map(nvcc_build, jobs.values())))
    libs = {tag: ctypes.CDLL(str(b[0])) for tag, b in built.items()}
    # a build takes the path code where its source says so
    takes_path = {tag: "int dt, int path," in (d / "sparse_mla.cu")
                  .read_text() for tag, d in srcs.items()}
    P, I = ctypes.c_void_p, ctypes.c_int
    for tag, lib in libs.items():
        lib.tl_sparse_mla_fwd.argtypes = (
            [P] * 5 + [I] * (10 if takes_path[tag] else 9)
            + [ctypes.c_float, P])
        lib.tl_sparse_mla_fwd.restype = I

    c = cs.DSA
    H, D, DT, HI, DI, topk = (c["heads"], c["latent"], c["rope"],
                              c["index_heads"], c["index_dim"], c["topk"])
    S, Skv = c["seq"], c["cache"]
    sm = 1.0 / math.sqrt(D + DT)
    out = {"card": smi, "build_s": round(time.perf_counter() - t0, 1),
           "builds": {tag: {"nvcc_s": round(b[2], 1),
                            "takes_path": takes_path[tag],
                            "registers_spills":
                                cs.kernel_registers(b[1])}
                      for tag, b in built.items()},
           "wgmma_dynamic_smem_bytes": wgmma_smem(D, DT)}
    failed = []

    # -- SASS of the kernels that must not change ---------------------------
    a, b = (nsa_ab.sass(built[tag][0]) for tag in ("earlier", "later"))
    keep = [fn for fn in sorted(set(a) | set(b)) if re.search(KEPT, fn)]
    same = nsa_ab.same_sass({f: a.get(f) for f in keep},
                            {f: b.get(f) for f in keep},
                            args.out / "sass_diffs" / "sparse_mla.diff")
    out["kept_sass"] = {"functions": len(keep), "same_sass": same}
    if len(keep) < 12 or not same:
        failed.append(f"sparse_mla: {len(keep)} kept functions, SASS "
                      f"{'same' if same else 'differs'}")

    def call(tag, q, kv, ind):
        o = torch.empty((1, S, H, D), dtype=q.dtype, device="cuda")
        lse = torch.empty((1, S, H), dtype=torch.float32, device="cuda")
        path = dsa._MLA_PATHS[dsa.sparse_mla_path(D, DT, q.dtype)]
        ints = [1, S, Skv, H, D, DT, topk, Skv - S, DTYPE_CODES[q.dtype]]
        if takes_path[tag]:
            ints.append(path)
        rc = libs[tag].tl_sparse_mla_fwd(
            q.data_ptr(), kv.data_ptr(), ind.data_ptr(), o.data_ptr(),
            lse.data_ptr(), *ints, sm * 1.44269504,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"sparse_mla {tag}: launch refused ({rc})")
        return o, lse

    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        name = str(dtype)[6:]
        gen = torch.Generator(device="cuda").manual_seed(21)
        qi, ki, q, kv = (torch.randn(shape, generator=gen, device="cuda")
                         .to(dtype) for shape in (
                             (1, S, HI, DI), (1, Skv, DI), (1, S, H, D + DT),
                             (1, Skv, D + DT)))
        w = torch.randn((1, S, HI), generator=gen, device="cuda")
        ind = dsa.topk_selector(dsa.lightning_indexer(qi, ki, w), topk)
        del qi, ki, w
        o_p, lse_p = dsa.sparse_mla_fwd_plain(q, kv, ind, D, sm, Skv - S)
        tol = cs.DSA_TOL["mla"]["float32" if dtype == torch.float32
                                else "bfloat16"]
        case = {"path": dsa.sparse_mla_path(D, DT, dtype)}
        got = {}
        for tag in ("earlier", "later"):
            got[tag] = call(tag, q, kv, ind)
            torch.cuda.synchronize()
            e_o = cs.normwise_err(got[tag][0], o_p)[1]
            e_l = cs.normwise_err(got[tag][1], lse_p)[1]
            case[f"{tag}_o_normwise"], case[f"{tag}_lse_normwise"] = e_o, e_l
            if not (e_o <= tol and e_l <= cs.DSA_TOL["lse"]):
                failed.append(f"{name} {tag}: O {e_o:.3e}, LSE {e_l:.3e}")
        case["bit_equal"] = all(torch.equal(x, y) for x, y in
                                zip(got["earlier"], got["later"]))
        if dtype == torch.float32 and not case["bit_equal"]:
            failed.append("float32: the builds' outputs differ")
        del got, o_p, lse_p
        times = {"earlier": [], "later": []}
        for tag in ("earlier", "later", "later", "earlier"):
            times[tag].append(cs.device_ms(
                torch, lambda: call(tag, q, kv, ind), 3))
        case["ms"] = times
        if dtype == torch.bfloat16:
            for label, _ in VARIANTS:
                case[f"{label}_ms"] = [cs.device_ms(
                    torch, lambda: call(label, q, kv, ind), 3)
                    for _ in range(2)]
            # the rows a call gathers: every slot of each token's two
            # 64-head blocks, live or not (a dead slot's copy is a
            # zero fill)
            nbytes = S * ((H + 63) // 64) * topk * (D + DT) * 2
            case["gathered_bytes"] = nbytes
            case["gather_tb_s"] = {
                "whole": nbytes / min(times["later"]) * 1e-9,
                "no_mma": nbytes / min(case["no_mma_ms"]) * 1e-9}
        out[name] = case
        print(json.dumps({name: case}), flush=True)
        del q, kv, ind
        torch.cuda.empty_cache()
    out["failed"] = failed
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "result.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
