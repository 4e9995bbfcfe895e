"""DeepSeek MLA (multi-head latent attention) decode on the card.

Counterpart of ``tilelang_mesh_tpu/ops/mla.py``: queries are absorbed
into the latent space, so all heads attend over one shared latent cache
``ckv (B, S, dc)`` plus a small rope channel ``kpe (B, S, dr)``, and the
latent is both key and value. The split-KV kernel
(``csrc/mla_decode.cu``) emits per-split partials ``(o, m, l)`` in the
exp2 domain; ``mla_decode`` merges them with torch ops
(``flash_decoding.merge_splits``), as the JAX package left the merge to
XLA.

``mla_decode_partials`` is the wrapper: a CUDA tensor always launches
the kernel (a build or launch failure raises), a CPU tensor takes
``mla_decode_partials_plain``, the dense version of the same function
that the tests and ``chip_smoke.py`` hold the kernel against.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..resilience.errors import KernelLaunchError
from .flash_decoding import clamp_splits, merge_splits
from .gemm import DTYPE_CODES
from ._factory import bind
from .gemm import _as_dtype

__all__ = ["mla_decode", "mla_decode_partials", "mla_decode_partials_plain",
           "mla_decode_reference", "launches", "reset_launches",
           "KERNEL_WIDTHS", "mla_decode_kernel"]

_LOG2E = 1.44269504
_DTYPES = (torch.float32, torch.bfloat16, torch.float16)

# (dc, dr) pairs csrc/mla_decode.cu instantiates: DeepSeek-V2/V3's, and
# the tests' two
KERNEL_WIDTHS = ((512, 64), (256, 32), (32, 16))

# kernel name -> launches through its wrapper (chip_smoke.py zeroes and
# reads these around the MLA serving run to prove it used the kernel)
launches = {"mla_decode": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _check(qc, qr, ckv, kpe, n_split):
    if qc.dim() != 3 or qr.dim() != 3 or ckv.dim() != 3 or kpe.dim() != 3:
        raise ValueError("q_latent, q_rope, ckv, kpe must be 3-d")
    B, H, dc = qc.shape
    dr = qr.shape[-1]
    S = ckv.shape[1]
    if tuple(qr.shape) != (B, H, dr) or tuple(ckv.shape) != (B, S, dc) \
            or tuple(kpe.shape) != (B, S, dr) or min(B, H, S, dc, dr) < 1:
        raise ValueError(
            f"want q_latent (B, H, dc), q_rope (B, H, dr), ckv (B, S, dc), "
            f"kpe (B, S, dr); got {tuple(qc.shape)}, {tuple(qr.shape)}, "
            f"{tuple(ckv.shape)}, {tuple(kpe.shape)}")
    dts = {t.dtype for t in (qc, qr, ckv, kpe)}
    if len(dts) != 1 or qc.dtype not in _DTYPES:
        raise TypeError(f"inputs must share float32, bfloat16 or float16, "
                        f"got "
                        f"{sorted(map(str, dts))}")
    if n_split < 1 or S % n_split:
        raise ValueError(f"n_split={n_split} must divide S={S}")
    devs = {t.device for t in (qc, qr, ckv, kpe)}
    if len(devs) != 1:
        raise ValueError(f"inputs must share a device, got "
                         f"{sorted(map(str, devs))}")


def mla_decode_partials_plain(qc, qr, ckv, kpe, n_split: int,
                              sm_scale: float):
    """Plain PyTorch version of the kernel: dense scores in f32, a
    softmax per split in the exp2 domain, ``p`` rounded to the input
    type before ``p @ ckv``. Returns ``(op (B,ns,H,dc), mp (B,ns,H),
    lp (B,ns,H))``, all float32."""
    B, H, dc = qc.shape
    S = ckv.shape[1]
    n = S // n_split
    c = ckv.float()
    s = (torch.einsum("bhc,bsc->bhs", qc.float(), c)
         + torch.einsum("bhr,bsr->bhs", qr.float(), kpe.float())) \
        * (float(sm_scale) * _LOG2E)
    s = s.reshape(B, H, n_split, n).transpose(1, 2)       # (B, ns, H, n)
    m = s.amax(dim=-1)
    p = torch.exp2(s - m[..., None])
    lsum = p.sum(dim=-1)
    o = torch.einsum("bshn,bsnc->bshc", p.to(qc.dtype).float(),
                     c.reshape(B, n_split, n, dc))
    return o, m, lsum


def _launch(qc, qr, ckv, kpe, n_split, sm_scale):
    from ._build import load
    B, H, dc = qc.shape
    dr = qr.shape[-1]
    S = ckv.shape[1]
    if (dc, dr) not in KERNEL_WIDTHS:
        raise ValueError(f"mla_decode kernel has no (dc, dr)=({dc}, {dr}) "
                         f"instance (built: {KERNEL_WIDTHS})")
    vec = 16 // ckv.element_size()
    for name, t in (("ckv", ckv), ("kpe", kpe)):
        if t.stride(2) != 1 or t.stride(0) % vec or t.stride(1) % vec \
                or t.data_ptr() % 16:
            raise ValueError(f"{name} rows must be contiguous and 16-byte "
                             f"aligned (strides {t.stride()})")
    qc, qr = qc.contiguous(), qr.contiguous()
    dev = ckv.device
    op = torch.empty((B, n_split, H, dc), dtype=torch.float32, device=dev)
    mp = torch.empty((B, n_split, H), dtype=torch.float32, device=dev)
    lp = torch.empty((B, n_split, H), dtype=torch.float32, device=dev)
    fn = load("mla_decode").tl_mla_decode
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 4
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(qc.data_ptr(), qr.data_ptr(), ckv.data_ptr(),
                  kpe.data_ptr(), op.data_ptr(), mp.data_ptr(),
                  lp.data_ptr(), B, H, S, dc, dr, n_split,
                  ckv.stride(0), ckv.stride(1), kpe.stride(0), kpe.stride(1),
                  DTYPE_CODES[ckv.dtype],
                  float(sm_scale) * _LOG2E, stream)
    if code != 0:
        raise KernelLaunchError("mla_decode", code, site="serve.step")
    launches["mla_decode"] += 1
    return op, mp, lp


def mla_decode_partials(qc, qr, ckv, kpe, n_split: int, sm_scale: float):
    """Split-KV partials ``(op, mp, lp)`` of MLA decode: ``qc (B, H,
    dc)``, ``qr (B, H, dr)`` against ``ckv (B, S, dc)``, ``kpe (B, S,
    dr)``, all of one type. ``ckv`` and ``kpe`` may be row-strided views
    (the column slices of one ``(B, S, dc + dr)`` tensor). CUDA tensors
    launch the kernel; CPU tensors run the plain version."""
    _check(qc, qr, ckv, kpe, int(n_split))
    if ckv.device.type == "cuda":
        return _launch(qc, qr, ckv, kpe, int(n_split), sm_scale)
    if ckv.device.type != "cpu":
        raise ValueError(f"unsupported device {ckv.device}")
    return mla_decode_partials_plain(qc, qr, ckv, kpe, int(n_split),
                                     sm_scale)


def mla_decode(q_latent, q_rope, ckv, kpe, sm_scale=None, n_split=None,
               block_N=128):
    """q_latent (B, H, dc); q_rope (B, H, dr); ckv (B, S, dc);
    kpe (B, S, dr) -> attention output in latent space (B, H, dc), in
    q_latent's type. The queries are cast to the cache's type."""
    dc = q_latent.shape[-1]
    dr = q_rope.shape[-1]
    S = ckv.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(dc + dr)
    n_split, _ = clamp_splits(S, n_split, block_N)
    op, mp, lp = mla_decode_partials(q_latent.to(ckv.dtype),
                                     q_rope.to(ckv.dtype), ckv, kpe,
                                     n_split, float(sm_scale))
    return merge_splits(op, mp, lp).to(q_latent.dtype)


def mla_decode_reference(q_latent, q_rope, ckv, kpe, sm_scale=None):
    """Dense MLA decode with a natural-exp softmax in float32, cast to
    q_latent's type (the JAX package's ``mla_decode_reference``)."""
    dc = q_latent.shape[-1]
    dr = q_rope.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(dc + dr)
    s = (torch.einsum("bhc,bsc->bhs", q_latent.float(), ckv.float())
         + torch.einsum("bhr,bsr->bhs", q_rope.float(), kpe.float())) \
        * sm_scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhs,bsc->bhc", p,
                        ckv.float()).to(q_latent.dtype)


def mla_decode_kernel(B, H, S, dc, dr, n_split, block_N, sm_scale, dtype,
                      num_stages=2):
    """The MLA kernel bound to one shape (the JAX factory's arguments):
    ``fn(qc (B, H, dc), qr (B, H, dr), ckv (B, S, dc), kpe (B, S, dr))
    -> (op (B, ns, H, dc), mp, lp (B, ns, H))`` float32 partials."""
    dt = _as_dtype(dtype)
    return bind("mla_decode_kernel",
                [((B, H, dc), dt), ((B, H, dr), dt), ((B, S, dc), dt),
                 ((B, S, dr), dt)],
                lambda qc, qr, ckv, kpe: mla_decode_partials(
                    qc, qr, ckv, kpe, n_split, sm_scale))
