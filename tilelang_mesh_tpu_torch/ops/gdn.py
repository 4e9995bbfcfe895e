"""Gated DeltaNet (GDN) chunked forward on the card.

Counterpart of ``tilelang_mesh_tpu/ops/gdn.py``: the gated delta rule

    h_t = a_t h_{t-1} + k_t (x) beta_t (v_t - (a_t h_{t-1})^T k_t),
    o_t = scale q_t^T h_t,            a_t = exp(g_t),

evaluated chunk by chunk in the WY form. One CUDA kernel
(``csrc/gdn.cu``) replaces the TPU's ``gdn_chunk_fwd_kernel``:

* ``gdn_chunk_fwd_tl(q, k, v, g, beta, chunk_size, scale)`` — q / k (B,
  H, T, K), v (B, H, T, V) in float32 or bfloat16, g / beta (B, H, T)
  float32, T % chunk_size == 0; o (B, H, T, V) in q's type. CUDA tensors
  launch the kernel, CPU tensors run ``gdn_chunk_fwd_tl_plain``: the
  kernel's arithmetic (the (I + A)^-1 by Neumann doubling in float32,
  the roundings to q's type where the kernel rounds) in eager PyTorch.
* ``gdn_chunk_fwd`` — the chunk-parallel WY form in eager PyTorch
  (the port of the JAX function of that name, bench.py's baseline), with
  ``initial_state`` and ``output_final_state``; its stages
  ``gdn_chunk_cumsum``, ``gdn_scaled_dot_kkt`` and ``gdn_wy_fast`` (a
  unit-lower triangular solve).
* ``gdn_reference`` — the sequential delta rule, float32.

On the card the kernel takes chunks and widths that are multiples of 16
whose block fits in shared memory: at K = V = 128 chunks up to 64 (the
doubling's four float32 C x C matrices alone pass the limit at 128);
``ValueError`` names the chunks it takes otherwise.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _seqmix as sm
from ._factory import bind
from .gemm import _as_dtype

__all__ = ["gdn_chunk_fwd_tl", "gdn_chunk_fwd_tl_plain", "gdn_chunk_fwd",
           "gdn_chunk_cumsum", "gdn_scaled_dot_kkt", "gdn_wy_fast",
           "gdn_reference", "launches", "reset_launches",
           "gdn_chunk_fwd_kernel"]

launches = {"gdn_chunk_fwd": 0}


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


def gdn_chunk_fwd_tl_plain(q, k, v, g, beta, chunk_size: int,
                           scale: float) -> torch.Tensor:
    """The kernel's arithmetic: a loop over chunks, vectorised over (B,
    H); products in float32; Tm, kb, vb, w, attn, state_c, v_new, qg, kd
    and the output rounded to q's type where the kernel rounds."""
    B, H, Tt, K, V = _shapes(q, k, v, g, beta)
    C, T, f32, dev = chunk_size, q.dtype, torch.float32, q.device
    state = torch.zeros((B, H, K, V), dtype=f32, device=dev)
    o = torch.empty((B, H, Tt, V), dtype=T, device=dev)
    strict = torch.tril(torch.ones((C, C), dtype=torch.bool, device=dev), -1)
    causal = torch.tril(torch.ones((C, C), dtype=torch.bool, device=dev))
    eye = torch.eye(C, dtype=f32, device=dev)

    def rnd(t):
        return t.to(T).to(f32)

    for c0 in range(0, Tt, C):
        sl = slice(c0, c0 + C)
        qs, ks, vs = (t[:, :, sl].to(f32) for t in (q, k, v))
        gc = torch.cumsum(g[:, :, sl].to(f32), -1)
        bs = beta[:, :, sl].to(f32)
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
        w = rnd(tm @ kb)
        u = tm @ vb
        attn = rnd(torch.where(causal, (qs @ ks.transpose(-1, -2)) * dec,
                               0.0))
        st_c = rnd(state)
        vn = rnd(u - w @ st_c)
        qg = rnd(qs * eg)
        o[:, :, sl] = ((qg @ st_c + attn @ vn) * scale).to(T)
        glast = gc[..., -1:]
        kd = rnd(ks * torch.exp(glast - gc)[..., None])
        state = state * torch.exp(glast)[..., None] \
            + kd.transpose(-1, -2) @ vn
    return o


def _smem(code: int, K: int):
    fn = sm.lib_fn("gdn", "tl_gdn_smem", [ctypes.c_int] * 4,
                   ctypes.c_longlong)
    return lambda C, vb, _r: fn(code, C, K, vb)


def _launch(q, k, v, g, beta, C: int, scale: float) -> torch.Tensor:
    B, H, Tt, K, V = _shapes(q, k, v, g, beta)
    code = sm.check_card("gdn_chunk_fwd_tl", q.dtype,
                         {"chunk_size": C, "K": K, "V": V})
    vb, _ = sm.plan_or_raise("gdn_chunk_fwd_tl", _smem(code, K), C, V, Tt,
                             strips=False)
    q, k, v = sm.ready(q), sm.ready(k), sm.ready(v)
    g = sm.ready(g.to(torch.float32))
    beta = sm.ready(beta.to(torch.float32))
    o = torch.empty((B, H, Tt, V), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    fn = sm.lib_fn("gdn", "tl_gdn_chunk_fwd",
                   [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    sm.call("gdn_chunk_fwd_tl", fn, q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), g.data_ptr(), beta.data_ptr(), o.data_ptr(), B, H,
            Tt, K, V, C, vb, float(scale), code)
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
