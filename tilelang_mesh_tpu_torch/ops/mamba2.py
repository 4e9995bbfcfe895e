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
chunks it takes otherwise: float32 up to 256, bfloat16 up to 512 at
bench's widths); :func:`mamba2_plan` picks its column block and row
strip. It reads x and writes y through their strides (a transposed view
is not copied) where every row starts on 16 bytes.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from . import _seqmix as sm
from ._seqmix import norm_chunk as _norm_chunk
from ._factory import bind
from .gemm import _as_dtype

__all__ = ["mamba2_chunk_scan", "mamba2_chunk_scan_plain",
           "mamba2_chunk_scan_torch", "mamba2_reference", "launches",
           "reset_launches", "mamba2_chunk_scan_kernel",
           "mamba2_chunk_scan_xla", "mamba2_plan", "Mamba2Plan"]

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


TILES_MAX = 16       # state tiles of 16 x 32 a block (mamba2.cu:
                     # kMaxTiles a warp, 8 warps)
WARPS = 8            # a block's warps (seqmix.cuh: kWarps)


class Mamba2Plan(NamedTuple):
    """A launch: the column block of P, the row strip, the strips' tile
    width, the grid, the shared memory and the blocks an SM holds."""
    pb: int
    r: int
    w: int
    grid: Tuple[int, int, int]
    smem: int
    resident: int


def mamba2_smem(esize: int, chunk: int, N: int, PB: int, R: int) -> int:
    """``mamba2.cu``'s ``smem_bytes``: X, B, four float32 vectors of the
    chunk, two strips of C and the strip's cdec, att's strip, state_c."""
    tb = sm.tile_bytes
    return (tb(esize, chunk, PB) + tb(esize, chunk, N)
            + 4 * tb(4, 1, chunk) + 3 * tb(esize, R, N)
            + tb(esize, R, chunk) + tb(esize, N, PB))


def mamba2_plan(B: int, H: int, P: int, N: int, chunk: int,
                esize: int) -> Optional[Mamba2Plan]:
    """The launch for these shapes and element size, or None when no
    block fits: the widest column block PB (the halvings of P, at most
    ``TILES_MAX`` state tiles) that fits with some row strip R (64, 32,
    16, dividing the chunk); at that PB the largest R with which two
    blocks share an SM, else the largest that fits. The strips' tiles
    are 16 x 32, or 16 x 16 in bf16 where a strip's output has fewer
    tiles of 32 than the block has warps (on the card the narrower tiles
    win at bf16 chunk 128 and lose at 256, where the strip has eight
    tiles of 32; float32's FFMA tile keeps 32 columns: ``scripts/
    seqmix_ab.py``'s tile sweep)."""
    for pb in sm.blocks(P):
        if (N // 16) * sm.col_tiles(pb) > TILES_MAX:
            continue
        fit = [r for r in sm.STRIPS if r <= chunk and chunk % r == 0
               and mamba2_smem(esize, chunk, N, pb, r) <= sm.SMEM_MAX]
        if not fit:
            continue
        r = next((r for r in fit if mamba2_smem(esize, chunk, N, pb, r)
                  <= sm.SMEM_TWO), fit[0])
        smem = mamba2_smem(esize, chunk, N, pb, r)
        w = 16 if esize == 2 and (r // 16) * sm.col_tiles(pb) < WARPS \
            else 32
        return Mamba2Plan(pb, r, w, (H, B, P // pb), smem,
                          sm.SMEM_SM // (smem + sm.SMEM_RESERVED))
    return None


def _rows_on_16(t: torch.Tensor) -> bool:
    """P contiguous and every (b, s, h) row on 16 bytes, as the kernel
    reads x and writes y."""
    e = t.element_size()
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(t.stride(i) * e % 16 == 0 for i in range(3)))


def _launch(x, dt, A, Bm, Cm, chunk: int) -> torch.Tensor:
    B, S, H, P, N = _shapes(x, dt, A, Bm, Cm)
    code = sm.check_card("mamba2_chunk_scan", x.dtype,
                         {"chunk": chunk, "P": P, "N": N})
    esize = x.element_size()
    plan = mamba2_plan(B, H, P, N, chunk, esize)
    if plan is None:
        raise sm.refuse("mamba2_chunk_scan", chunk, S, lambda c: mamba2_plan(
            B, H, P, N, c, esize) is not None)
    if not _rows_on_16(x):
        x = sm.ready(x)
    Bm, Cm = sm.ready(Bm), sm.ready(Cm)
    dt = sm.ready(dt.to(torch.float32))
    A = sm.ready(A.to(torch.float32))
    y = torch.empty_like(x)          # x's strides where x is dense
    if not _rows_on_16(y):
        y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    fn = sm.lib_fn("mamba2", "tl_mamba2_chunk_scan",
                   [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p])
    xs = (ctypes.c_longlong * 3)(*x.stride()[:3])
    ys = (ctypes.c_longlong * 3)(*y.stride()[:3])
    sm.call("mamba2_chunk_scan", fn, x.device, x.data_ptr(), dt.data_ptr(),
            A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(), B, S,
            H, P, N, chunk, plan.pb, plan.r, plan.w, ctypes.addressof(xs),
            ctypes.addressof(ys), code)
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
