"""Gated DeltaNet (GDN) chunked forward on the card.

Counterpart of ``tilelang_mesh_tpu/ops/gdn.py``: the gated delta rule

    h_t = a_t h_{t-1} + k_t (x) beta_t (v_t - (a_t h_{t-1})^T k_t),
    o_t = scale q_t^T h_t,            a_t = exp(g_t),

evaluated chunk by chunk in the WY form. Two CUDA kernels
(``csrc/gdn.cu``) replace the TPU's ``gdn_chunk_fwd_kernel``: the
chunk-parallel ``gdn_chunk_wy`` (gc, A, (I + A)^-1, w, u, attn and the
decayed q and k of every chunk at once, into scratch) and the serial
``gdn_chunk_state`` (v_new, o and the state, chunk by chunk):

* ``gdn_chunk_fwd_tl(q, k, v, g, beta, chunk_size, scale)`` — q / k (B,
  H, T, K), v (B, H, T, V) in float32 or bfloat16, g / beta (B, H, T)
  float32, T % chunk_size == 0; o (B, H, T, V) in q's type. CUDA tensors
  launch the two kernels (:func:`gdn_plan` picks the serial pass's
  column block and buffers), CPU tensors run ``gdn_chunk_fwd_tl_plain``:
  the kernels' arithmetic in eager PyTorch, as ``gdn_chunk_wy_plain``
  (the (I + A)^-1 by Neumann doubling in float32, where the kernel
  substitutes, and the roundings to q's type where the kernels round)
  and ``gdn_chunk_state_plain``.
* ``gdn_chunk_fwd`` — the chunk-parallel WY form in eager PyTorch
  (the port of the JAX function of that name, bench.py's baseline), with
  ``initial_state`` and ``output_final_state``; its stages
  ``gdn_chunk_cumsum``, ``gdn_scaled_dot_kkt`` and ``gdn_wy_fast`` (a
  unit-lower triangular solve).
* ``gdn_reference`` — the sequential delta rule, float32.

On the card the kernels take chunks and widths that are multiples of 16
whose blocks fit in shared memory: at K = V = 128 chunks up to 128 (the
first kernel's float32 C x C matrix passes the limit at 256);
``ValueError`` names the chunks they take otherwise.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

from . import _seqmix as sm
from ._factory import bind
from .gemm import _as_dtype

__all__ = ["gdn_chunk_fwd_tl", "gdn_chunk_fwd_tl_plain", "gdn_chunk_fwd",
           "gdn_chunk_cumsum", "gdn_scaled_dot_kkt", "gdn_wy_fast",
           "gdn_reference", "launches", "reset_launches",
           "gdn_chunk_fwd_kernel", "gdn_chunk_wy_plain",
           "gdn_chunk_state_plain", "gdn_plan", "GdnPlan"]

# calls of gdn_chunk_fwd_tl on the card, and launches of each kernel
# (one of each a call); chip_smoke.py zeroes and reads them
launches = {"gdn_chunk_fwd": 0, "gdn_chunk_wy": 0, "gdn_chunk_state": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _shapes(q, k, v, g, beta):
    if q.dim() != 4:
        raise ValueError(f"gdn: q must be (B, H, T, K), got "
                         f"{tuple(q.shape)}")
    B, H, Tt, K = q.shape
    V = v.shape[-1]
    want = {"k": (B, H, Tt, K), "v": (B, H, Tt, V), "g": (B, H, Tt),
            "beta": (B, H, Tt)}
    for name, t in (("k", k), ("v", v), ("g", g), ("beta", beta)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"gdn: {name} must be {want[name]}, got "
                             f"{tuple(t.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"gdn: k and v must have q's type {q.dtype}, got "
                        f"{k.dtype}, {v.dtype}")
    return B, H, Tt, K, V


def _n_double(C: int) -> int:
    """Doubling steps so that the powers of N below 2^(n+1) >= C are
    covered (N^C = 0)."""
    return max(0, (C - 1).bit_length() - 1)


def gdn_chunk_wy_plain(q, k, v, g, beta, chunk_size: int):
    """``gdn_chunk_wy``'s arithmetic, every chunk at once: (w, u, qg, kd,
    attn, gate) — w = (Tm_c (beta e^gc k)_c)_c, qg = (e^gc q)_c, kd =
    (e^(gc_last - gc) k)_c (B, H, T, K) and attn_c (B, H, T, C) in q's
    type; u = Tm_c (beta v)_c (B, H, T, V) and gate = e^gc_last (B, H,
    T / C) float32; Tm by Neumann doubling in float32."""
    B, H, Tt, K, V = _shapes(q, k, v, g, beta)
    C, T, f32, dev = chunk_size, q.dtype, torch.float32, q.device
    NC = Tt // C
    strict = torch.tril(torch.ones((C, C), dtype=torch.bool, device=dev), -1)
    causal = torch.tril(torch.ones((C, C), dtype=torch.bool, device=dev))
    eye = torch.eye(C, dtype=f32, device=dev)

    def rnd(t):
        return t.to(T).to(f32)

    qs, ks, vs = (t.to(f32).reshape(B, H, NC, C, -1) for t in (q, k, v))
    gc = torch.cumsum(g.to(f32).reshape(B, H, NC, C), -1)
    bs = beta.to(f32).reshape(B, H, NC, C)
    dec = torch.exp(gc[..., :, None] - gc[..., None, :])
    nm = torch.where(strict, -bs[..., :, None]
                     * (ks @ ks.transpose(-1, -2)) * dec, 0.0)
    sm_, pm = nm + eye, nm
    for _ in range(_n_double(C)):
        pm = pm @ pm
        sm_ = sm_ + pm @ sm_
    tm = rnd(sm_)
    eg = torch.exp(gc)[..., None]
    kb = rnd(ks * bs[..., None] * eg)
    vb = rnd(vs * bs[..., None])
    w = (tm @ kb).to(T)
    u = tm @ vb
    attn = torch.where(causal, (qs @ ks.transpose(-1, -2)) * dec,
                       0.0).to(T)
    qg = (qs * eg).to(T)
    glast = gc[..., -1:]
    kd = (ks * torch.exp(glast - gc)[..., None]).to(T)
    return tuple(t.reshape(B, H, Tt, -1) for t in (w, u, qg, kd, attn)) \
        + (torch.exp(glast[..., 0]),)


def gdn_chunk_state_plain(w, u, qg, kd, attn, gate, scale: float):
    """``gdn_chunk_state``'s arithmetic: a loop over chunks, vectorised
    over (B, H), on ``gdn_chunk_wy_plain``'s outputs; products in
    float32, state_c, v_new and the output rounded to w's type."""
    B, H, Tt, K = w.shape
    V, C, T, f32 = u.shape[-1], attn.shape[-1], w.dtype, torch.float32
    state = torch.zeros((B, H, K, V), dtype=f32, device=w.device)
    o = torch.empty((B, H, Tt, V), dtype=T, device=w.device)

    def rnd(t):
        return t.to(T).to(f32)

    for n, c0 in enumerate(range(0, Tt, C)):
        sl = slice(c0, c0 + C)
        st_c = rnd(state)
        vn = rnd(u[:, :, sl] - w[:, :, sl].to(f32) @ st_c)
        o[:, :, sl] = ((qg[:, :, sl].to(f32) @ st_c
                        + attn[:, :, sl].to(f32) @ vn) * scale).to(T)
        state = state * gate[:, :, n, None, None] \
            + kd[:, :, sl].to(f32).transpose(-1, -2) @ vn
    return o


def gdn_chunk_fwd_tl_plain(q, k, v, g, beta, chunk_size: int,
                           scale: float) -> torch.Tensor:
    """The kernels' arithmetic: ``gdn_chunk_state_plain`` on
    ``gdn_chunk_wy_plain``'s scratch."""
    return gdn_chunk_state_plain(
        *gdn_chunk_wy_plain(q, k, v, g, beta, chunk_size), scale)


TILES_MAX = 16       # output or state tiles of 16 x 32 a block (gdn.cu:
                     # kMaxTiles a warp, 8 warps)


class GdnPlan(NamedTuple):
    """The launches of one call: ``gdn_chunk_wy``'s grid and shared
    memory; ``gdn_chunk_state``'s column block, whether its two load
    groups share one region, its grid and shared memory, and the
    blocks an SM holds."""
    wy_grid: Tuple[int, int, int]
    wy_smem: int
    vb: int
    overlay: bool
    state_grid: Tuple[int, int, int]
    state_smem: int
    resident: int


def gdn_wy_smem(esize: int, C: int, K: int, V: int) -> int:
    """``gdn.cu``'s ``wy_smem``: k, q / v, the float32 C x C matrix,
    Tm_c (bf16), four float32 vectors of C and the warps' float32
    staging tiles."""
    tb = sm.tile_bytes
    return (tb(esize, C, K) + max(tb(esize, C, K), tb(esize, C, V))
            + tb(4, C, C) + (tb(esize, C, C) if esize == 2 else 0)
            + 4 * tb(4, 1, C) + tb(4, 16 * 8, 32))


def gdn_state_smem(esize: int, C: int, K: int, VB: int,
                   overlay: bool) -> int:
    """``gdn.cu``'s ``state_smem``: group A (w, e^gc q, u), group B (kd,
    attn) beside it or over it, v_new and state_c."""
    tb = sm.tile_bytes
    a = 2 * tb(esize, C, K) + tb(4, C, VB)
    b = tb(esize, C, K) + tb(esize, C, C)
    return (max(a, b) if overlay else a + b) + tb(esize, C, VB) \
        + tb(esize, K, VB)


def gdn_plan(B: int, H: int, Tt: int, K: int, V: int, C: int,
             esize: int) -> Optional[GdnPlan]:
    """The launches for these shapes and element size, or None when a
    block does not fit. The serial pass's column block VB is the widest
    of the halvings of V with at most ``TILES_MAX`` output and state
    tiles a block that fits, its two load groups side by side where
    they fit, else over each other: on the card that beat every
    narrower block and two blocks an SM at bench's shape
    (``scripts/seqmix_ab.py``'s sweep: the K-side tiles are read once a
    column block)."""
    wy = gdn_wy_smem(esize, C, K, V)
    if wy > sm.SMEM_MAX:
        return None
    tn = sm.col_tiles
    for vb in sm.blocks(V):
        if max(C, K) // 16 * tn(vb) > TILES_MAX:
            continue
        for overlay in (False, True):
            smem = gdn_state_smem(esize, C, K, vb, overlay)
            if smem <= sm.SMEM_MAX:
                return GdnPlan((Tt // C, H, B), wy, vb, overlay,
                               (V // vb, H, B), smem,
                               sm.SMEM_SM // (smem + sm.SMEM_RESERVED))
    return None


def _scratch(q, C: int, V: int):
    """The scratch gdn_chunk_wy writes: w, qg, kd, attn in q's type; u,
    gate float32."""
    B, H, Tt, K = q.shape
    f32, T, dev = torch.float32, q.dtype, q.device
    return (torch.empty((B, H, Tt, K), dtype=T, device=dev),
            torch.empty((B, H, Tt, V), dtype=f32, device=dev),
            torch.empty((B, H, Tt, K), dtype=T, device=dev),
            torch.empty((B, H, Tt, K), dtype=T, device=dev),
            torch.empty((B, H, Tt, C), dtype=T, device=dev),
            torch.empty((B, H, Tt // C), dtype=f32, device=dev))


def _plan_or_raise(q, v, C: int) -> Tuple[GdnPlan, int]:
    B, H, Tt, K = q.shape
    V = v.shape[-1]
    code = sm.check_card("gdn_chunk_fwd_tl", q.dtype,
                         {"chunk_size": C, "K": K, "V": V})
    esize = q.element_size()
    got = gdn_plan(B, H, Tt, K, V, C, esize)
    if got is None:
        raise sm.refuse("gdn_chunk_fwd_tl", C, Tt, lambda c: gdn_plan(
            B, H, Tt, K, V, c, esize) is not None)
    return got, code


def _launch_wy(q, k, v, g, beta, C: int, code: int):
    """``gdn_chunk_wy`` into fresh scratch: (w, u, qg, kd, attn, gate)."""
    B, H, Tt, K, V = _shapes(q, k, v, g, beta)
    out = _scratch(q, C, V)
    fn = sm.lib_fn("gdn", "tl_gdn_chunk_wy",
                   [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    sm.call("gdn_chunk_wy", fn, q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), g.data_ptr(), beta.data_ptr(),
            *(t.data_ptr() for t in out), B, H, Tt, K, V, C, code)
    launches["gdn_chunk_wy"] += 1
    return out


def _launch_state(scratch, plan: GdnPlan, scale: float, code: int):
    """``gdn_chunk_state`` on ``gdn_chunk_wy``'s scratch: o."""
    w, u, qg, kd, attn, gate = scratch
    B, H, Tt, K = w.shape
    V, C = u.shape[-1], attn.shape[-1]
    o = torch.empty((B, H, Tt, V), dtype=w.dtype, device=w.device)
    fn = sm.lib_fn("gdn", "tl_gdn_chunk_state",
                   [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    sm.call("gdn_chunk_state", fn, w.device,
            *(t.data_ptr() for t in scratch), o.data_ptr(), B, H, Tt, K, V,
            C, plan.vb, int(plan.overlay), float(scale), code)
    launches["gdn_chunk_state"] += 1
    return o


def _launch(q, k, v, g, beta, C: int, scale: float) -> torch.Tensor:
    B, H, Tt, K, V = _shapes(q, k, v, g, beta)
    plan, code = _plan_or_raise(q, v, C)
    if B * H * Tt * K * V == 0:
        return torch.empty((B, H, Tt, V), dtype=q.dtype, device=q.device)
    q, k, v = sm.ready(q), sm.ready(k), sm.ready(v)
    g = sm.ready(g.to(torch.float32))
    beta = sm.ready(beta.to(torch.float32))
    o = _launch_state(_launch_wy(q, k, v, g, beta, C, code), plan, scale,
                      code)
    launches["gdn_chunk_fwd"] += 1
    return o


def gdn_chunk_fwd_tl(q, k, v, g, beta, chunk_size: int = 64,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Tile-kernel GDN forward: q/k (B, H, T, K), v (B, H, T, V), g
    log-decay, beta write strengths (B, H, T); T % chunk_size == 0.
    CUDA tensors launch the kernel; CPU tensors run the plain version."""
    dev = sm.device_of("gdn_chunk_fwd_tl", q, k, v, g, beta)
    Tt, K = q.shape[2], q.shape[3]
    if Tt % chunk_size:
        raise ValueError(f"T={Tt} not divisible by chunk={chunk_size}")
    if scale is None:
        scale = 1.0 / math.sqrt(K)
    if dev.type == "cuda":
        return _launch(q, k, v, g, beta, int(chunk_size), float(scale))
    return gdn_chunk_fwd_tl_plain(q, k, v, g, beta, int(chunk_size),
                                  float(scale))


def gdn_chunk_cumsum(g, chunk: int) -> torch.Tensor:
    """Within-chunk inclusive log-decay cumsum: g (B, H, T) -> gc (B, H,
    NC, chunk), float32."""
    B, H, Tt = g.shape
    return torch.cumsum(g.to(torch.float32).reshape(B, H, Tt // chunk,
                                                    chunk), -1)


def gdn_scaled_dot_kkt(kf, bf, gc, decay=None) -> torch.Tensor:
    """A[i, j] = beta_i (k_i . k_j) exp(gc_i - gc_j) for i > j, else 0;
    kf (B, H, NC, C, K) float32, bf / gc (B, H, NC, C)."""
    C = kf.shape[-2]
    kk = kf @ kf.transpose(-1, -2)
    if decay is None:
        decay = torch.exp(gc[..., :, None] - gc[..., None, :])
    strict = torch.tril(torch.ones((C, C), dtype=torch.bool,
                                   device=kf.device), -1)
    return torch.where(strict, bf[..., :, None] * kk * decay, 0.0)


def gdn_wy_fast(kf, vf, bf, gc, A):
    """WY factors: T_mat = (I + A)^-1 by a unit-lower triangular solve,
    w = T_mat (beta e^gc k), u = T_mat (beta v). Returns (w, u, T_mat)."""
    C = A.shape[-1]
    eye = torch.eye(C, dtype=torch.float32, device=A.device).expand(
        A.shape)
    T_mat = torch.linalg.solve_triangular(A, eye, upper=False,
                                          unitriangular=True)
    w = T_mat @ (bf[..., None] * torch.exp(gc)[..., None] * kf)
    u = T_mat @ (bf[..., None] * vf)
    return w, u, T_mat


def gdn_chunk_fwd(q, k, v, g, beta, chunk_size: int = 64,
                  scale: Optional[float] = None, initial_state=None,
                  output_final_state: bool = False):
    """Chunk-parallel WY form in eager PyTorch (the JAX function of this
    name): q/k (B, H, T, K); v (B, H, T, V); g (B, H, T) log-decay; beta
    (B, H, T) write strengths; T % chunk_size == 0. Returns o in q's
    type, and the float32 final state (B, H, K, V) when asked."""
    B, H, Tt, K, V = _shapes(q, k, v, g, beta)
    C = chunk_size
    if Tt % C:
        raise ValueError(f"T={Tt} must be divisible by chunk_size={C}")
    if scale is None:
        scale = 1.0 / math.sqrt(K)
    N, f32 = Tt // C, torch.float32
    qf = q.to(f32).reshape(B, H, N, C, K)
    kf = k.to(f32).reshape(B, H, N, C, K)
    vf = v.to(f32).reshape(B, H, N, C, V)
    bf = beta.to(f32).reshape(B, H, N, C)
    gc = gdn_chunk_cumsum(g, C)
    decay = torch.exp(gc[..., :, None] - gc[..., None, :])
    A = gdn_scaled_dot_kkt(kf, bf, gc, decay=decay)
    w, u, _ = gdn_wy_fast(kf, vf, bf, gc, A)
    causal = torch.tril(torch.ones((C, C), dtype=torch.bool,
                                   device=q.device))
    attn = torch.where(causal, (qf @ kf.transpose(-1, -2)) * decay, 0.0)
    g_tot = gc[..., -1]
    k_out = torch.exp(g_tot[..., None] - gc)[..., None] * kf
    qg = torch.exp(gc)[..., None] * qf
    h = torch.zeros((B, H, K, V), dtype=f32, device=q.device) \
        if initial_state is None else initial_state.to(f32)
    o = torch.empty((B, H, N, C, V), dtype=f32, device=q.device)
    for n in range(N):
        v_new = u[:, :, n] - w[:, :, n] @ h
        o[:, :, n] = (qg[:, :, n] @ h + attn[:, :, n] @ v_new) * scale
        h = torch.exp(g_tot[:, :, n])[..., None, None] * h \
            + k_out[:, :, n].transpose(-1, -2) @ v_new
    o = o.reshape(B, H, Tt, V).to(q.dtype)
    if output_final_state:
        return o, h
    return o


def gdn_reference(q, k, v, g, beta, scale: Optional[float] = None,
                  initial_state=None, output_final_state: bool = False):
    """Sequential gated delta rule (ground truth), float32; o in q's
    type, and the final state when asked."""
    B, H, Tt, K, V = _shapes(q, k, v, g, beta)
    if scale is None:
        scale = 1.0 / math.sqrt(K)
    f32 = torch.float32
    qf, kf, vf = q.to(f32), k.to(f32), v.to(f32)
    gf, bf = g.to(f32), beta.to(f32)
    h = torch.zeros((B, H, K, V), dtype=f32, device=q.device) \
        if initial_state is None else initial_state.to(f32).clone()
    o = torch.empty((B, H, Tt, V), dtype=f32, device=q.device)
    for t in range(Tt):
        h = h * torch.exp(gf[:, :, t])[..., None, None]
        kv = torch.einsum("bhkv,bhk->bhv", h, kf[:, :, t])
        v_new = bf[:, :, t][..., None] * (vf[:, :, t] - kv)
        h = h + torch.einsum("bhk,bhv->bhkv", kf[:, :, t], v_new)
        o[:, :, t] = scale * torch.einsum("bhkv,bhk->bhv", h, qf[:, :, t])
    out = o.to(q.dtype)
    if output_final_state:
        return out, h
    return out


def gdn_chunk_fwd_kernel(B, H, Tt, K, V, chunk, scale, dtype="float32"):
    """The GDN kernel bound to one shape (the JAX factory's arguments):
    ``fn(q, k (B, H, T, K), v (B, H, T, V), g, beta (B, H, T) float32)
    -> o (B, H, T, V)``."""
    dt = _as_dtype(dtype)
    return bind("gdn_chunk_fwd_kernel",
                [((B, H, Tt, K), dt), ((B, H, Tt, K), dt), ((B, H, Tt, V), dt),
                 ((B, H, Tt), torch.float32), ((B, H, Tt), torch.float32)],
                lambda q, k, v, g, beta: gdn_chunk_fwd_tl(
                    q, k, v, g, beta, int(chunk), float(scale)))
