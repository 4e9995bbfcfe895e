#!/usr/bin/env python3
"""Hold the GDN forward (csrc/gdn.cu, #30) and the Mamba2 SSD scan
(csrc/mamba2.cu, #29) against another version of their sources: each
build against the plain versions, the SASS of linear_attention.cu (which
shares seqmix.cuh), and the time of each in turns.

    python3 scripts/seqmix_ab.py EARLIER_CSRC [LATER_CSRC] [--out DIR]
        [--build DIR]

``EARLIER_CSRC`` is a directory holding the earlier ``gdn.cu``,
``mamba2.cu`` and ``linear_attention.cu`` with their headers (the parent
commit's ``csrc`` from ``git archive``, unpacked under ``build/``): one
launch ``tl_gdn_chunk_fwd(..., VB, scale, dtype, stream)`` a GDN call,
at the widest column block that fits, and ``tl_mamba2_chunk_scan(...,
PB, R, dtype, stream)``. ``LATER_CSRC`` (by default this checkout's
``tilelang_mesh_tpu_torch/csrc``) has the two GDN launches
(``tl_gdn_chunk_wy``, ``tl_gdn_chunk_state``) at ``ops/gdn.py::gdn_plan``
and the Mamba2 launch with its tile width and strides at
``ops/mamba2.py::mamba2_plan``. Copies of the earlier source, not
checked, take the earlier calls apart (``EXPERIMENTS``: the Neumann
doubling skipped; a chunk's loads issued for the first chunk only), and
copies of the later source take the later ones apart
(``LATER_EXPERIMENTS``). Two designs that lost are built beside the
later source from ``scripts/``: mamba_ssm's split of the SSD scan
(``mamba2_split.cu``, timed whole and by kernel) and GDN's attn_c
formed in the serial pass (``gdn_attn_state.cu``, after a WY kernel that
does not write it, at each column block and layout that fits).

At chip_smoke.py's shapes and draws (GDN: B 8, H 16, T 4096, K = V =
128, default_rng(8); Mamba2: B 8, S 4096, H 80, P 64, N 128,
default_rng(7)): GDN bf16 and f32 at chunk 64 and 128 (the earlier
build takes 64 only); Mamba2 bf16 at chunks 128 and 256, f32 at 128.
Each build's output against the plain version (normwise, chip_smoke.py's
SEQ_TOL; a failure fails the run); each case timed with chip_smoke.py's
``device_ms`` in turns (earlier, later, eager, later, earlier), the
eager chunk-parallel port (``gdn_chunk_fwd``, ``mamba2_chunk_scan_torch``)
in the same turns, the later GDN call's two kernels alone, the serial
pass at every column block and layout that fits, the Mamba2 strips at
both tile widths (bf16), and the experiment copies once beside. Prints
each build's kernels, registers and spill stores (``nvcc -Xptxas -v``;
the logs under DIR/ptxas), each plan's shared memory, the card's name
and power limit; writes DIR/result.json. linear_attention.cu's
functions must have the same SASS in both builds. Exits 1 when a check
fails. Needs one NVIDIA card; exits non-zero without one.
"""

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCES = ("gdn", "mamba2", "linear_attention")
# copies of the earlier source that take its calls apart: (label, source,
# [(text, its replacement)])
EXPERIMENTS = (
    ("gdn_no_double", "gdn", [
        ("for (int x = C - 1; x > 1; x >>= 1) ++n_double;", ";")]),
    ("gdn_no_load", "gdn", [
        ("    load_tile(s.qs, q + t0 * K, C, K, K);\n"
         "    load_tile(s.ks, k + t0 * K, C, K, K);\n",
         "    if (c0 == 0) {\n"
         "    load_tile(s.qs, q + t0 * K, C, K, K);\n"
         "    load_tile(s.ks, k + t0 * K, C, K, K);\n    }\n"),
        ("      s.eg[i] = g[t0 + i];", "      s.eg[i] = g[bh * Tt + i];"),
        ("      s.bt[i] = beta[t0 + i];", "      s.bt[i] = beta[bh * Tt + i];"),
        ("v[(t0 + r) * V + v0 + n]", "v[(bh * Tt + r) * V + v0 + n]")]),
    ("mamba2_no_load", "mamba2", [
        ("    load_tile(s.xs, x + row0 * xrow + (long long)h * P + p0, chunk, "
         "PB, xrow);\n    load_tile(s.bs, Bm + row0 * N, chunk, N, N);\n",
         "    if (c0 == 0) {\n"
         "    load_tile(s.xs, x + row0 * xrow + (long long)h * P + p0, chunk, "
         "PB, xrow);\n    load_tile(s.bs, Bm + row0 * N, chunk, N, N);\n"
         "    }\n"),
        ("      s.dt[i] = dt[(row0 + i) * H + h];",
         "      s.dt[i] = dt[((long long)b * S + i) * H + h];"),
        ("      load_tile(s.cs, Cm + (row0 + r0) * N, R, N, N);",
         "      if (c0 == 0) load_tile(s.cs, Cm + (row0 + r0) * N, R, N, N);")]),
)
# copies of the later source for its breakdown, timed once beside it
LATER_EXPERIMENTS = (
    ("wy_no_inverse", "gdn", [("  unit_lower_inverse(s.f, lf, C);\n", "")]),
    ("wy_no_attn", "gdn", [
        ("    p.mma_ld(qq, kk, m0, n0, K, C);\n", ""),
        ("      y = i >= j ? y * d : 0.f;\n", ""),
        ("    store_tile(p, stt, attn_out + t0 * C, C, m0, n0, C);\n", "")]),
    ("wy_no_out", "gdn", [
        ("    store_tile(p, stt, attn_out + t0 * C, C, m0, n0, C);\n", ""),
        ("    a.store(qg_out + (t0 + r) * K + c);\n"
         "    b.store(kd_out + (t0 + r) * K + c);\n", ""),
        ("    store_tile(a, stt, w_out + t0 * K, K, m0, n0, K);\n", ""),
        ("    store_tile(a, stf, u_out + t0 * V, V, m0, n0, V);\n", "")]),
    ("m2_no_elementwise", "mamba2", [
        ("        c.store(s.cd + m * lb + n);\n", ""),
        ("          c.store(s.bs + r * lb + n);\n", "")]),
    ("m2_no_att", "mamba2", [("        if (n0 > r0 + m0 + 15) return;\n",
                              "        return;\n")]),
    ("m2_no_chunk_load", "mamba2", [
        ("    load_tile_async(s.xs, xb + c0 * xss, chunk, PB, xss);\n"
         "    load_tile_async(s.bs, bb + (long long)c0 * N, chunk, N, N);\n",
         "    if (c0 == 0) {\n"
         "    load_tile_async(s.xs, xb + c0 * xss, chunk, PB, xss);\n"
         "    load_tile_async(s.bs, bb + (long long)c0 * N, chunk, N, N);\n"
         "    }\n"),
        ("      s.dt[i] = db[(long long)(c0 + i) * H];",
         "      s.dt[i] = db[(long long)i * H];")]),
    ("m2_no_strip_load", "mamba2", [
        ("    load_tile_async(gs & 1 ? s.cr1 : s.cr0,",
         "    if (gs < 2) load_tile_async(gs & 1 ? s.cr1 : s.cr0,")]),
    ("m2_no_state", "mamba2", [
        ("    const float gate = expf(last);\n#pragma unroll\n"
         "    for (int j = 0; j < kMaxTiles; ++j) {\n"
         "      const int t = warp + kWarps * j;\n      if (t < ns) {",
         "    const float gate = expf(last);\n#pragma unroll\n"
         "    for (int j = 0; j < kMaxTiles; ++j) {\n"
         "      const int t = warp + kWarps * j;\n      if (t < 0) {")]),
    ("state_no_load", "gdn", [
        ("if (overlay) issue_a(c);", "if (overlay && c == 0) issue_a(c);"),
        ("if (!overlay) issue_b(c);", "if (!overlay && c == 0) issue_b(c);"),
        ("      issue_b(c);\n", "      if (c == 0) issue_b(c);\n"),
        ("if (!overlay && c + 1 < NC) issue_a(c + 1);", ";")]),
    ("m2_no_y", "mamba2", [
        ("        f.mma_ld(Mat<T, true>{s.att, la}, xv, m0, n0, r0 + m0 + 16, "
         "n1);\n        f.mma_ld(Mat<T, true>{s.cd, lb}, stv, m0, n0, N, "
         "n1);\n", "")]),
    ("m2_att_no_exp", "mamba2", [
        ("expf(fminf(s.cum[i] - s.cum[n], 0.f))", "1.f")]),
    ("m2_fast_exp", "mamba2", [
        ("expf(fminf(s.cum[i] - s.cum[n], 0.f))",
         "__expf(fminf(s.cum[i] - s.cum[n], 0.f))")]),
    ("m2_att_no_mma", "mamba2", [
        ("        f.mma_ld(Mat<T, true>{cs, lb}, Mat<T, true>{s.bs, lb}, m0, "
         "n0, N,\n                 n1);\n", "")]),
    ("wy_fast_exp", "gdn", [
        ("const float d = expf(s.gc[i] - s.gc[j]);",
         "const float d = __expf(s.gc[i] - s.gc[j]);")]),
)
GDN_CASES = (("bf16_chunk64", "bfloat16", 64), ("f32_chunk64", "float32", 64),
             ("bf16_chunk128", "bfloat16", 128),
             ("f32_chunk128", "float32", 128))
MAMBA2_CASES = (("bf16_chunk128", "bfloat16", 128),
                ("bf16_chunk256", "bfloat16", 256),
                ("f32_chunk128", "float32", 128))
P = ctypes.c_void_p
I = ctypes.c_int


def experiment_dir(src_dir, label, name, subs, root):
    """A copy of ``src_dir`` under ``root/label`` whose ``name``.cu has
    each text of ``subs`` replaced."""
    dst = root / label
    shutil.copytree(src_dir, dst)
    f = dst / f"{name}.cu"
    src = f.read_text()
    for old, new in subs:
        if old not in src:
            raise RuntimeError(f"{label}: {old!r} not in {name}.cu")
        src = src.replace(old, new)
    f.write_text(src)
    return dst


def nvcc_build(job):
    """(library, ptxas log, seconds) of one (src_dir, name, out)."""
    from tilelang_mesh_tpu_torch.ops import _build
    src_dir, name, out = job
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                          "-o", str(out), str(src_dir / f"{name}.cu")],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {out}:\n{res.stderr}")
    return out, res.stdout + res.stderr, time.perf_counter() - t0


def fn(lib, name, argtypes, restype=ctypes.c_int):
    f = getattr(lib, name)
    f.argtypes, f.restype = list(argtypes), restype
    return f


def main() -> int:
    import numpy as np
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("earlier", type=Path)
    ap.add_argument("later", type=Path, nargs="?",
                    default=ROOT / "tilelang_mesh_tpu_torch" / "csrc")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "seqmix_ab" / "out")
    ap.add_argument("--build", type=Path,
                    default=ROOT / "build" / "seqmix_ab")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("seqmix_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    import chip_smoke as cs
    import nsa_ab
    from tilelang_mesh_tpu_torch.ops import _seqmix as sm
    from tilelang_mesh_tpu_torch.ops import gdn as gd
    from tilelang_mesh_tpu_torch.ops import mamba2 as m2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    shutil.rmtree(args.build, ignore_errors=True)
    dirs = {"earlier": args.earlier, "later": args.later}
    for tag, src in dirs.items():
        (args.build / tag).mkdir(parents=True)
        for f in src.glob("*.cu*"):
            shutil.copy(f, args.build / tag / f.name)
    jobs = {(tag, n): (args.build / tag, n, args.build / tag / f"lib{n}.so")
            for tag in dirs for n in SOURCES}
    # mamba_ssm's split of the SSD scan, and GDN's serial pass forming
    # attn_c itself, beside the later source
    for name in ("mamba2_split", "gdn_attn_state"):
        shutil.copy(ROOT / "scripts" / f"{name}.cu", args.build / "later")
        jobs["later", name] = (args.build / "later", name,
                               args.build / "later" / f"lib{name}.so")
    for tag, exps in (("earlier", EXPERIMENTS), ("later", LATER_EXPERIMENTS)):
        for label, name, subs in exps:
            d = experiment_dir(args.build / tag, label, name, subs,
                               args.build / "experiments")
            jobs[label, name] = (d, name, d / f"lib{name}.so")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(jobs)) as ex:
        built = dict(zip(jobs, ex.map(nvcc_build, jobs.values())))
    out = {"card": smi, "build_s": round(time.perf_counter() - t0, 1),
           "builds": {f"{t}/{n}": {"nvcc_s": round(b[2], 1),
                                   "registers_spills":
                                       cs.kernel_registers(b[1])}
                      for (t, n), b in built.items()}}
    for k, v in out["builds"].items():
        print(f"{k}: {json.dumps(v)}", flush=True)
    (args.out / "ptxas").mkdir(parents=True, exist_ok=True)
    for (t, n), b in built.items():
        (args.out / "ptxas" / f"{t}_{n}.log").write_text(b[1])
    failed = []

    # -- linear_attention.cu keeps its SASS -------------------------------
    a, b = (nsa_ab.sass(built[tag, "linear_attention"][0]) for tag in dirs)
    same = nsa_ab.same_sass(a, b, args.out / "sass_diffs" /
                            "linear_attention.diff")
    out["linear_attention_sass"] = {"functions": len(a), "same": same}
    if not a or not same:
        failed.append(f"linear_attention: {len(a)} functions, SASS "
                      f"{'same' if same else 'differs'}")

    libs = {k: ctypes.CDLL(str(v[0])) for k, v in built.items()}
    dev = torch.device("cuda")

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def call(f, *a):
        code = f(*a, stream())
        if code:
            raise RuntimeError(f"launch refused: {code}")

    def turns(calls, iters):
        times = {}
        for tag in ("earlier", "later", "eager", "later", "earlier"):
            if tag in calls:
                times.setdefault(tag, []).append(
                    round(cs.device_ms(torch, calls[tag], iters), 4))
        return times

    # -- GDN -----------------------------------------------------------------
    B, H, T, K, V = (cs.GDN[k] for k in "BHTKV")
    rng = np.random.default_rng(8)

    def put(x, dtype=torch.float32):
        return torch.from_numpy(np.asarray(x, np.float32)).to(dev).to(dtype)
    q = put(rng.standard_normal((B, H, T, K)) * 0.3)
    k = rng.standard_normal((B, H, T, K)).astype(np.float32)
    k = put(k / np.linalg.norm(k, axis=-1, keepdims=True))
    v = put(rng.standard_normal((B, H, T, V)) * 0.3)
    g = put(rng.uniform(-0.2, 0.0, (B, H, T)))
    beta = put(rng.uniform(0.1, 0.9, (B, H, T)))
    scale = K ** -0.5
    res = out["gdn"] = {}
    for label, dname, C in GDN_CASES:
        dtype = getattr(torch, dname)
        code = sm.DTYPES[dtype]
        qs, ks, vs = (t.to(dtype) for t in (q, k, v))
        o = torch.empty((B, H, T, V), dtype=dtype, device=dev)
        plan = gd.gdn_plan(B, H, T, K, V, C, qs.element_size())

        def old_call(lib, C=C, code=code, qs=qs, ks=ks, vs=vs, o=o):
            # the earlier plan: the widest column block that fits
            sm_fn = fn(lib, "tl_gdn_smem", [I] * 4, ctypes.c_longlong)
            got = next(((vb, 0) for vb in sm.blocks(V)
                        if sm_fn(code, C, K, vb) <= sm.SMEM_MAX), None)
            if got is None:
                return None
            f = fn(lib, "tl_gdn_chunk_fwd", [P] * 6 + [I] * 7
                   + [ctypes.c_float, I, P])
            return lambda: call(f, qs.data_ptr(), ks.data_ptr(),
                                vs.data_ptr(), g.data_ptr(), beta.data_ptr(),
                                o.data_ptr(), B, H, T, K, V, C, got[0],
                                scale, code)
        lib = libs["later", "gdn"]
        f_wy = fn(lib, "tl_gdn_chunk_wy", [P] * 11 + [I] * 7 + [P])
        f_st = fn(lib, "tl_gdn_chunk_state", [P] * 7 + [I] * 8
                  + [ctypes.c_float, I, P])
        scr = gd._scratch(qs, C, V)

        def wy(C=C, code=code, qs=qs, ks=ks, vs=vs, scr=scr):
            call(f_wy, qs.data_ptr(), ks.data_ptr(), vs.data_ptr(),
                 g.data_ptr(), beta.data_ptr(), *(t.data_ptr() for t in scr),
                 B, H, T, K, V, C, code)

        def state(C=C, code=code, scr=scr, o=o, plan=plan):
            call(f_st, *(t.data_ptr() for t in scr), o.data_ptr(), B, H, T,
                 K, V, C, plan.vb, int(plan.overlay), scale, code)

        def new_call():
            wy()
            state()
        calls = {"later": new_call,
                 "eager": lambda C=C, qs=qs, ks=ks, vs=vs: gd.gdn_chunk_fwd(
                     qs, ks, vs, g, beta, chunk_size=C)}
        old = old_call(libs["earlier", "gdn"])
        if old is not None:
            calls["earlier"] = old
        want = gd.gdn_chunk_fwd_tl_plain(qs, ks, vs, g, beta, C, scale)
        r = res[label] = {"plan": plan._asdict(),
                          "earlier_runs": old is not None}
        for tag, c in calls.items():
            if tag == "eager":
                continue
            c()
            torch.cuda.synchronize()
            err = cs.normwise_err(o, want)[1]
            r[f"{tag}_normwise_err"] = err
            if not err <= cs.SEQ_TOL[dname]:
                failed.append(f"gdn {label} {tag}: {err:.3e}")
        del want
        r["ms"] = turns(calls, 5 if dname == "bfloat16" else 3)
        r["later_split_ms"] = {"gdn_chunk_wy": round(cs.device_ms(
            torch, wy, 5), 4), "gdn_chunk_state": round(cs.device_ms(
                torch, state, 5), 4)}
        # the serial pass at every column block and buffer layout that
        # fits (the plan's choice among them)
        sweep = r["state_sweep_ms"] = {}
        for vb in sm.blocks(V):
            for ov in (False, True):
                tiles = (max(C, K) // 16) * sm.col_tiles(vb)
                smem = gd.gdn_state_smem(qs.element_size(), C, K, vb, ov)
                if tiles > gd.TILES_MAX or smem > sm.SMEM_MAX:
                    continue
                sweep[f"vb{vb}_{'overlay' if ov else 'apart'}"] = round(
                    cs.device_ms(torch, lambda vb=vb, ov=ov: call(
                        f_st, *(t.data_ptr() for t in scr), o.data_ptr(), B,
                        H, T, K, V, C, vb, int(ov), scale, code), 5), 4)
        # attn_c formed by the serial pass from q, k and g (its best
        # column block and layout) after a WY kernel that does not write
        # it: the other place for attn_c
        lib_qk = libs["later", "gdn_attn_state"]
        f_qk = fn(lib_qk, "tl_gdn_chunk_state_qk", [P] * 9 + [I] * 8
                  + [ctypes.c_float, I, P])
        qk_smem = fn(lib_qk, "tl_gdn_state_qk_smem", [I] * 5,
                     ctypes.c_longlong)
        f_wy_na = fn(libs["wy_no_attn", "gdn"], "tl_gdn_chunk_wy",
                     [P] * 11 + [I] * 7 + [P])
        qk = r["attn_in_state"] = {"sweep_ms": {}}
        for vb in sm.blocks(V):
            for ov in (False, True):
                tiles = (max(C, K) // 16) * sm.col_tiles(vb)
                if tiles > gd.TILES_MAX or qk_smem(
                        code, C, K, vb, int(ov)) > sm.SMEM_MAX:
                    continue

                def qk_call(vb=vb, ov=ov, scr=scr, o=o, qs=qs, ks=ks):
                    w_, u_, qg_, kd_, _at, gate_ = scr
                    call(f_qk, w_.data_ptr(), u_.data_ptr(), qg_.data_ptr(),
                         kd_.data_ptr(), qs.data_ptr(), ks.data_ptr(),
                         g.data_ptr(), gate_.data_ptr(), o.data_ptr(), B, H,
                         T, K, V, C, vb, int(ov), scale, code)
                wy()
                o.zero_()
                qk_call()
                torch.cuda.synchronize()
                err = cs.normwise_err(o, gd.gdn_chunk_fwd_tl_plain(
                    qs, ks, vs, g, beta, C, scale))[1]
                if not err <= cs.SEQ_TOL[dname]:
                    failed.append(f"gdn {label} attn_in_state vb{vb} "
                                  f"{ov}: {err:.3e}")
                qk["sweep_ms"][f"vb{vb}_{'overlay' if ov else 'apart'}"] = \
                    round(cs.device_ms(torch, qk_call, 5), 4)
        qk["wy_without_attn_ms"] = round(cs.device_ms(torch, lambda: call(
            f_wy_na, qs.data_ptr(), ks.data_ptr(), vs.data_ptr(),
            g.data_ptr(), beta.data_ptr(), *(t.data_ptr() for t in scr), B,
            H, T, K, V, C, code), 5), 4)
        if qk["sweep_ms"]:
            qk["best_total_ms"] = round(qk["wy_without_attn_ms"]
                                        + min(qk["sweep_ms"].values()), 4)
        if label == "bf16_chunk64":
            for label_x, name_x, _subs in LATER_EXPERIMENTS:
                if name_x == "gdn" and label_x != "wy_no_attn":
                    f_x = fn(libs[label_x, "gdn"], "tl_gdn_chunk_wy",
                             [P] * 11 + [I] * 7 + [P])
                    if label_x.startswith("state_"):
                        f_x = fn(libs[label_x, "gdn"], "tl_gdn_chunk_state",
                                 [P] * 7 + [I] * 8 + [ctypes.c_float, I, P])
                        r[f"{label_x}_ms"] = round(cs.device_ms(
                            torch, lambda f_x=f_x: call(
                                f_x, *(t.data_ptr() for t in scr),
                                o.data_ptr(), B, H, T, K, V, C, plan.vb,
                                int(plan.overlay), scale, code), 5), 4)
                        continue
                    r[f"{label_x}_ms"] = round(cs.device_ms(
                        torch, lambda f_x=f_x: call(
                            f_x, qs.data_ptr(), ks.data_ptr(), vs.data_ptr(),
                            g.data_ptr(), beta.data_ptr(),
                            *(t.data_ptr() for t in scr), B, H, T, K, V, C,
                            code), 5), 4)
        if C == 64:
            for label_x, _name, _subs in EXPERIMENTS[:2]:
                c = old_call(libs[label_x, "gdn"])
                r[f"{label_x}_ms"] = round(cs.device_ms(torch, c, 3), 4)
        print(f"gdn {label}: {json.dumps(r)}", flush=True)
        del qs, ks, vs, o, scr
        torch.cuda.empty_cache()
    del q, k, v, g, beta

    # -- Mamba2 --------------------------------------------------------------
    B, S, H, Pd, N = (cs.MAMBA2[k] for k in "BSHPN")
    rng = np.random.default_rng(7)
    x = put(rng.standard_normal((B, S, H, Pd)) * 0.3)
    dt = put(rng.uniform(0.01, 0.1, (B, S, H)))
    A = put(-rng.uniform(0.5, 1.5, (H,)))
    Bm = put(rng.standard_normal((B, S, N)) * 0.3)
    Cm = put(rng.standard_normal((B, S, N)) * 0.3)
    res = out["mamba2"] = {}
    for label, dname, chunk in MAMBA2_CASES:
        dtype = getattr(torch, dname)
        code = sm.DTYPES[dtype]
        xs, bs, cs_ = (t.to(dtype) for t in (x, Bm, Cm))
        y = torch.empty_like(xs)
        plan = m2.mamba2_plan(B, H, Pd, N, chunk, xs.element_size())

        def old_call(lib, chunk=chunk, code=code, xs=xs, bs=bs, cs_=cs_, y=y):
            sm_fn = fn(lib, "tl_mamba2_smem", [I] * 5, ctypes.c_longlong)
            pb, rr = sm.plan(lambda c, pb, r: sm_fn(code, c, N, pb, r),
                             chunk, Pd)
            f = fn(lib, "tl_mamba2_chunk_scan", [P] * 6 + [I] * 9 + [P])
            return lambda: call(f, xs.data_ptr(), dt.data_ptr(),
                                A.data_ptr(), bs.data_ptr(), cs_.data_ptr(),
                                y.data_ptr(), B, S, H, Pd, N, chunk, pb, rr,
                                code)
        f_new = fn(libs["later", "mamba2"], "tl_mamba2_chunk_scan",
                   [P] * 6 + [I] * 9 + [P, P, I, P])
        st = (ctypes.c_longlong * 3)(*xs.stride()[:3])

        def new_call(chunk=chunk, code=code, xs=xs, bs=bs, cs_=cs_, y=y,
                     plan=plan, st=st, w=0):
            call(f_new, xs.data_ptr(), dt.data_ptr(), A.data_ptr(),
                 bs.data_ptr(), cs_.data_ptr(), y.data_ptr(), B, S, H, Pd, N,
                 chunk, plan.pb, plan.r, w or plan.w, ctypes.addressof(st),
                 ctypes.addressof(st), code)
        f_split = fn(libs["later", "mamba2_split"], "tl_m2s_split",
                     [P] * 9 + [I] * 7 + [P, P, I, I, P])
        NC = S // chunk
        split_scratch = (
            torch.empty((B, H, NC, N, Pd), device=dev),
            torch.empty((B, H, NC), device=dev),
            torch.empty((B, H, NC, N, Pd), dtype=dtype, device=dev))

        def split_call(chunk=chunk, code=code, xs=xs, bs=bs, cs_=cs_, y=y,
                       plan=plan, st=st, scr=split_scratch, only=-1):
            call(f_split, xs.data_ptr(), dt.data_ptr(), A.data_ptr(),
                 bs.data_ptr(), cs_.data_ptr(), *(t.data_ptr() for t in scr),
                 y.data_ptr(), B, S, H, Pd, N, chunk, plan.r,
                 ctypes.addressof(st), ctypes.addressof(st), only, code)
        calls = {"earlier": old_call(libs["earlier", "mamba2"]),
                 "later": new_call, "split": split_call,
                 "eager": lambda chunk=chunk, xs=xs, bs=bs, cs_=cs_:
                     m2.mamba2_chunk_scan_torch(xs, dt, A, bs, cs_,
                                                chunk=chunk)}
        want = m2.mamba2_chunk_scan_plain(xs, dt, A, bs, cs_, chunk)
        r = res[label] = {"plan": plan._asdict()}
        for tag in ("earlier", "later", "split"):
            calls[tag]()
            torch.cuda.synchronize()
            err = cs.normwise_err(y, want)[1]
            r[f"{tag}_normwise_err"] = err
            if not err <= cs.SEQ_TOL[dname]:
                failed.append(f"mamba2 {label} {tag}: {err:.3e}")
        del want
        r["ms"] = turns(calls, 5)
        r["split_ms"] = [round(cs.device_ms(torch, split_call, 5), 4)
                         for _ in range(2)]
        if dname == "bfloat16":     # the strips' tile width (the plan's)
            r["tile_sweep_ms"] = {
                f"w{w}": round(cs.device_ms(
                    torch, lambda w=w: new_call(w=w), 5), 4)
                for w in (16, 32)}
        r["split_kernels_ms"] = {
            name: round(cs.device_ms(torch, lambda i=i: split_call(only=i),
                                     5), 4)
            for i, name in enumerate(("m2s_chunk_state", "m2s_state_pass",
                                      "m2s_chunk_scan"))}
        r["split_scratch_bytes"] = sum(t.numel() * t.element_size()
                                       for t in split_scratch)
        del split_scratch
        if label.startswith("bf16"):
            r["mamba2_no_load_ms"] = round(cs.device_ms(
                torch, old_call(libs["mamba2_no_load", "mamba2"]), 3), 4)
            for label_x, name_x, _subs in LATER_EXPERIMENTS:
                if name_x == "mamba2":
                    f_x = fn(libs[label_x, "mamba2"], "tl_mamba2_chunk_scan",
                             [P] * 6 + [I] * 9 + [P, P, I, P])
                    r[f"{label_x}_ms"] = round(cs.device_ms(
                        torch, lambda f_x=f_x: call(
                            f_x, xs.data_ptr(), dt.data_ptr(), A.data_ptr(),
                            bs.data_ptr(), cs_.data_ptr(), y.data_ptr(), B,
                            S, H, Pd, N, chunk, plan.pb, plan.r, plan.w,
                            ctypes.addressof(st), ctypes.addressof(st),
                            code), 3), 4)
        print(f"mamba2 {label}: {json.dumps(r)}", flush=True)
        del xs, bs, cs_, y
        torch.cuda.empty_cache()

    out["failed"] = failed
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "result.json").write_text(json.dumps(out, indent=1))
    print(json.dumps({"failed": failed, "card": smi}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
