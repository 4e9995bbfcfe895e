"""The Mamba2 SSD chunk scan on the card.

Counterpart of ``tilelang_mesh_tpu/ops/mamba2.py``. One CUDA kernel
(``csrc/mamba2.cu``) replaces the TPU's ``mamba2_chunk_scan_kernel``:

* ``mamba2_chunk_scan(x, dt, A, Bm, Cm, chunk)`` — x (B, S, H, P), dt
  (B, S, H) float32, A (H,) float32 (negative), Bm / Cm (B, S, N); y (B,
  S, H, P) in x's type (float32 or bfloat16). The chunk falls back by
  halving to a divisor of S (:func:`_norm_chunk`). CUDA tensors launch
  the kernel, CPU tensors run ``mamba2_chunk_scan_plain``, the kernel's
  arithmetic in eager PyTorch with the same roundings to x's type.
* ``mamba2_chunk_scan_torch`` — the chunk-parallel SSD in eager PyTorch,
  the port of the JAX package's ``mamba2_chunk_scan_xla`` (bench.py's
  baseline): every chunk's products at once, a loop over chunks for the
  state only, float32 throughout, rounded once at the end.
* ``mamba2_reference`` — the sequential recurrence h_t = exp(A dt_t)
  h_{t-1} + dt_t B_t x_t, y_t = C_t h_t, float32.

On the card the kernel takes chunks and widths that are multiples of 16
and chunks whose block fits in shared memory (``ValueError`` names the
chunks it takes otherwise); it reads x in its (B, S, H, P) layout.
"""

from __future__ import annotations

import ctypes

import torch

from . import _seqmix as sm
from ._seqmix import norm_chunk as _norm_chunk
from ._factory import bind
from .gemm import _as_dtype

__all__ = ["mamba2_chunk_scan", "mamba2_chunk_scan_plain",
           "mamba2_chunk_scan_torch", "mamba2_reference", "launches",
           "reset_launches", "mamba2_chunk_scan_kernel",
           "mamba2_chunk_scan_xla"]

# kernel name -> launches through its wrapper (chip_smoke.py zeroes and
# reads it around the main path's calls)
launches = {"mamba2_chunk_scan": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _shapes(x, dt, A, Bm, Cm):
    if x.dim() != 4:
        raise ValueError(f"mamba2_chunk_scan: x must be (B, S, H, P), got "
                         f"{tuple(x.shape)}")
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    want = {"dt": (B, S, H), "A": (H,), "Bm": (B, S, N), "Cm": (B, S, N)}
    for name, t in (("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"mamba2_chunk_scan: {name} must be "
                             f"{want[name]}, got {tuple(t.shape)}")
    if Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"mamba2_chunk_scan: Bm and Cm must have x's type "
                        f"{x.dtype}, got {Bm.dtype}, {Cm.dtype}")
    return B, S, H, P, N


def mamba2_chunk_scan_plain(x, dt, A, Bm, Cm, chunk: int) -> torch.Tensor:
    """The kernel's arithmetic: a loop over chunks, vectorised over (B,
    H); products in float32 on values of x's type; att, cdec, state_c,
    bdec and the output rounded to x's type where the kernel rounds."""
    B, S, H, P, N = _shapes(x, dt, A, Bm, Cm)
    T, f32 = x.dtype, torch.float32
    dev = x.device
    state = torch.zeros((B, H, N, P), dtype=f32, device=dev)
    y = torch.empty_like(x)
    a = A.to(f32)[None, :, None]
    tril = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=dev))
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        xs = x[:, sl].permute(0, 2, 1, 3).to(f32)              # (B,H,c,P)
        dts = dt[:, sl].permute(0, 2, 1).to(f32)               # (B,H,c)
        bs = Bm[:, sl].to(f32)                                 # (B,c,N)
        cs = Cm[:, sl].to(f32)
        cum = torch.cumsum(dts, -1) * a
        cb = (cs @ bs.transpose(-1, -2))[:, None]              # (B,1,c,c)
        att = cb * dts[:, :, None, :] * torch.exp(torch.clamp(
            cum[..., :, None] - cum[..., None, :], max=0.0))
        att = torch.where(tril, att, 0.0).to(T).to(f32)
        cdec = (cs[:, None] * torch.exp(cum)[..., None]).to(T).to(f32)
        out = att @ xs + cdec @ state.to(T).to(f32)
        y[:, sl] = out.to(T).permute(0, 2, 1, 3)
        last = cum[..., -1:]
        bdec = (bs[:, None] * dts[..., None]
                * torch.exp(last - cum)[..., None]).to(T).to(f32)
        state = state * torch.exp(last)[..., None] \
            + bdec.transpose(-1, -2) @ xs
    return y


def _smem(code: int, N: int):
    fn = sm.lib_fn("mamba2", "tl_mamba2_smem", [ctypes.c_int] * 5,
                   ctypes.c_longlong)
    return lambda chunk, pb, r: fn(code, chunk, N, pb, r)


def _launch(x, dt, A, Bm, Cm, chunk: int) -> torch.Tensor:
    B, S, H, P, N = _shapes(x, dt, A, Bm, Cm)
    code = sm.check_card("mamba2_chunk_scan", x.dtype,
                         {"chunk": chunk, "P": P, "N": N})
    pb, r = sm.plan_or_raise("mamba2_chunk_scan", _smem(code, N), chunk, P,
                             S)
    x, Bm, Cm = sm.ready(x), sm.ready(Bm), sm.ready(Cm)
    dt = sm.ready(dt.to(torch.float32))
    A = sm.ready(A.to(torch.float32))
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    fn = sm.lib_fn("mamba2", "tl_mamba2_chunk_scan",
                   [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                   + [ctypes.c_void_p])
    sm.call("mamba2_chunk_scan", fn, x.device, x.data_ptr(), dt.data_ptr(),
            A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(), B, S,
            H, P, N, chunk, pb, r, code)
    launches["mamba2_chunk_scan"] += 1
    return y


def mamba2_chunk_scan(x, dt, A, Bm, Cm, chunk: int = 128) -> torch.Tensor:
    """x (B, S, H, P); dt (B, S, H); A (H,); Bm/Cm (B, S, N) -> y (B, S,
    H, P) in x's type. CUDA tensors launch the kernel; CPU tensors run
    the plain version."""
    dev = sm.device_of("mamba2_chunk_scan", x, dt, A, Bm, Cm)
    chunk = _norm_chunk(int(chunk), x.shape[1])
    if dev.type == "cuda":
        return _launch(x, dt, A, Bm, Cm, chunk)
    return mamba2_chunk_scan_plain(x, dt, A, Bm, Cm, chunk)


def mamba2_chunk_scan_torch(x, dt, A, Bm, Cm, chunk: int = 128):
    """Chunk-parallel SSD in eager PyTorch: the port of the JAX package's
    ``mamba2_chunk_scan_xla`` (bench.py's baseline). Every chunk's
    decay-masked products at once in float32, the cross-chunk (N, P)
    state carried by a loop over chunks; y in x's type."""
    B, S, H, P, N = _shapes(x, dt, A, Bm, Cm)
    chunk = _norm_chunk(int(chunk), S)
    NC = S // chunk
    f32 = torch.float32
    xc = x.to(f32).reshape(B, NC, chunk, H, P)
    dtc = dt.to(f32).reshape(B, NC, chunk, H)
    bc = Bm.to(f32).reshape(B, NC, chunk, N)
    cc = Cm.to(f32).reshape(B, NC, chunk, N)
    cum = torch.cumsum(dtc, 2) * A.to(f32)[None, None, None, :]
    cb = torch.einsum("bcim,bcjm->bcij", cc, bc)[..., None]
    dec = torch.exp(torch.clamp(cum[:, :, :, None, :]
                                - cum[:, :, None, :, :], max=0.0))
    tril = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))[None, None, ..., None]
    att = torch.where(tril, cb * dec * dtc[:, :, None, :, :], 0.0)
    intra = torch.einsum("bcijh,bcjhp->bcihp", att, xc)
    del cb, dec, att
    last = cum[:, :, -1:, :]
    bdec = bc[..., None] * (dtc * torch.exp(last - cum))[..., None, :]
    inject = torch.einsum("bcimh,bcihp->bchmp", bdec, xc)
    gate = torch.exp(last[:, :, 0, :])                          # (B,NC,H)
    out_dec = torch.exp(cum)                                    # (B,NC,c,H)
    state = torch.zeros((B, H, N, P), dtype=f32, device=x.device)
    inter = torch.empty_like(intra)
    for n in range(NC):
        inter[:, n] = torch.einsum("bim,bhmp,bih->bihp", cc[:, n], state,
                                   out_dec[:, n])
        state = state * gate[:, n, :, None, None] + inject[:, n]
    return (intra + inter).reshape(B, S, H, P).to(x.dtype)


def mamba2_reference(x, dt, A, Bm, Cm) -> torch.Tensor:
    """Sequential SSM recurrence: h_t = exp(A dt_t) h_{t-1} + dt_t B_t
    x_t; y_t = C_t h_t (float32; y in x's type)."""
    B, S, H, P, N = _shapes(x, dt, A, Bm, Cm)
    f32 = torch.float32
    xf, dtf = x.to(f32), dt.to(f32)
    bf, cf = Bm.to(f32), Cm.to(f32)
    a = A.to(f32)[None, :]
    h = torch.zeros((B, H, N, P), dtype=f32, device=x.device)
    ys = torch.empty((B, S, H, P), dtype=f32, device=x.device)
    for t in range(S):
        decay = torch.exp(a * dtf[:, t])                        # (B,H)
        inject = torch.einsum("bn,bh,bhp->bhnp", bf[:, t], dtf[:, t],
                              xf[:, t])
        h = h * decay[..., None, None] + inject
        ys[:, t] = torch.einsum("bn,bhnp->bhp", cf[:, t], h)
    return ys.to(x.dtype)


# the JAX package's name of the eager chunk-parallel baseline
mamba2_chunk_scan_xla = mamba2_chunk_scan_torch


def mamba2_chunk_scan_kernel(B, S, H, P, N, chunk, dtype="float32"):
    """The SSD kernel bound to one shape (the JAX factory's arguments and
    its head-major layout): ``fn(x (B, H, S, P), dt (B, H, S) float32,
    A (H,) float32, Bm, Cm (B, S, N)) -> y (B, H, S, P)``; ``chunk``
    divides S."""
    dt_ = _as_dtype(dtype)
    if S % chunk:
        raise ValueError(f"chunk={chunk} does not divide S={S}")
    return bind("mamba2_chunk_scan_kernel",
                [((B, H, S, P), dt_), ((B, H, S), torch.float32),
                 ((H,), torch.float32), ((B, S, N), dt_), ((B, S, N), dt_)],
                lambda x, dt, A, Bm, Cm: mamba2_chunk_scan(
                    x.transpose(1, 2), dt.transpose(1, 2), A, Bm, Cm,
                    chunk).transpose(1, 2))
