"""What the sequence-mixing wrappers (``mamba2``, ``gdn``,
``linear_attention``) share on the card: the type and shape checks of
their kernels (``csrc/seqmix.cuh``), the choice of a block's column
block and row strip that fits in shared memory, and the launch."""

from __future__ import annotations

import ctypes
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ..resilience.errors import KernelLaunchError

# the kernels' input types, with their codes in the C launchers
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_MAX = 232448            # shared memory a block may use on sm_90
SMEM_SM = 233472             # an SM's shared memory; each resident block
SMEM_RESERVED = 1024         # also takes this much of it
SMEM_TWO = SMEM_SM // 2 - SMEM_RESERVED    # a block's bytes, two an SM
STEP = 16                    # every chunk and width is a multiple of it
STRIPS = (64, 32, 16)        # row strips, largest first


def norm_chunk(chunk: int, S: int) -> int:
    """Largest divisor of S that is <= chunk, by halving (the JAX
    package's rule, shared by every sequence-mixing wrapper)."""
    chunk = min(chunk, S)
    while S % chunk:
        chunk //= 2
    return chunk


def device_of(what: str, *tensors: torch.Tensor) -> torch.device:
    """The one device of ``tensors``: CUDA or CPU, else ``ValueError``."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{what}: operands must share a device, got "
                         f"{sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{what}: unsupported device {dev}")
    return dev


def check_card(what: str, dtype: torch.dtype, dims: dict) -> int:
    """The kernel's type code; ``TypeError`` / ``ValueError`` for what
    the kernel does not take (the CPU's plain version takes anything)."""
    if dtype not in DTYPES:
        raise TypeError(f"{what}: the kernel takes float32 or bfloat16, "
                        f"got {dtype}")
    bad = {k: v for k, v in dims.items() if v % STEP}
    if bad:
        raise ValueError(f"{what}: the kernel takes sizes that are "
                         f"multiples of {STEP}, got {bad}")
    return DTYPES[dtype]


def blocks(width: int) -> List[int]:
    """Column blocks of ``width``: itself, then halves while they divide
    it and stay multiples of ``STEP``."""
    out, b = [width], width
    while b % 2 == 0 and (b // 2) % STEP == 0:
        b //= 2
        out.append(b)
    return out


def plan(smem: Callable[..., int], chunk: int,
         width: int) -> Optional[Tuple[int, int]]:
    """The first (column block, row strip) whose block fits in shared
    memory, widest block first: ``smem(chunk, block, strip)`` gives the
    bytes."""
    rows = [r for r in STRIPS if r <= chunk and chunk % r == 0]
    for b in blocks(width):
        for r in rows:
            if smem(chunk, b, r) <= SMEM_MAX:
                return b, r
    return None


def refuse(what: str, chunk: int, length: int,
           fits: Callable[[int], bool]) -> ValueError:
    """The ``ValueError`` for a chunk whose block does not fit, naming
    the chunks (dividing ``length``) for which ``fits`` holds."""
    took = [c for c in (16, 32, 64, 128, 256, 512)
            if c <= length and length % c == 0 and fits(c)]
    return ValueError(f"{what}: chunk {chunk} does not fit in a block's "
                      f"shared memory on the card at these widths; it "
                      f"takes chunks {took}")


def plan_or_raise(what: str, smem: Callable[..., int], chunk: int,
                  width: int, length: int) -> Tuple[int, int]:
    """:func:`plan`, or ``ValueError`` naming the chunks that fit."""
    got = plan(smem, chunk, width)
    if got is None:
        raise refuse(what, chunk, length,
                     lambda c: plan(smem, c, width) is not None)
    return got


def tile_bytes(esize: int, rows: int, width: int) -> int:
    """``seqmix.cuh``'s ``bytes_of``: a rows x width matrix of elements
    of ``esize`` bytes, each row padded by 16 bytes, the whole rounded
    up to 16."""
    return (rows * (width + 16 // esize) * esize + 15) // 16 * 16


def col_tiles(width: int) -> int:
    """16 x 32 tiles across ``width`` columns."""
    return (width + 31) // 32


def ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and on 16 bytes, as the kernels read it."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def lib_fn(lib: str, name: str, argtypes: Sequence, restype=ctypes.c_int):
    from ._build import load
    fn = getattr(load(lib), name)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn


def call(what: str, fn, dev: torch.device, *args) -> None:
    """Launch through ``fn`` on ``dev``'s current stream; raise
    :class:`KernelLaunchError` when the launch was refused."""
    from ._build import stream_call
    code = stream_call(fn, dev, *args)
    if code != 0:
        raise KernelLaunchError(what, code)
