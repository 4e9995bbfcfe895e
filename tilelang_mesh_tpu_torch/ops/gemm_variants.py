"""GEMM scheduling variants on the card: split-K, stream-K, GEMV,
block-sparse GEMM.

Counterpart of ``tilelang_mesh_tpu/ops/gemm_variants.py``, with its names
and signatures. Two CUDA sources replace its four TPU kernels:
``csrc/gemm_variants.cu`` (split-K, stream-K and block-sparse, on the
block tile loop of ``csrc/gemm_tile.cuh``) and ``csrc/gemv.cu``.

* ``matmul_splitk(a, b, n_split, ...)`` — C = A @ B with K cut into
  ``n_split`` chunks, one float32 partial (M, N) a chunk, summed in
  split order and rounded once to ``out_dtype`` (default: a's type). The
  split is the JAX wrapper's (``splitk_plan``): only where the chunk is a
  multiple of 128, else fewer splits, down to one full-K chunk. That rule
  is the TPU's (Mosaic's lane rule), kept so that both packages sum the
  same partials in the same order. Two launches, by ``splitk_path``: up
  to ``SPLITK_STREAM_MAX_ROWS`` rows (aligned operands) the weights are
  streamed once over ``splitk_stream_plan``'s grid, each split cut into
  sub-ranges (``splitk_stream``), then every partial summed in (split,
  sub-range) order (``splitk_stream_combine``); past them one block a
  (128 x 128 tile, split) (``splitk_gemm``) and the splits' sum
  (``splitk_reduce``).
* ``matmul_streamk(a, b, n_programs, ...)`` — the same product over
  host-planned segments ``(tile, k0, k_len)`` (``_streamk_segments``, the
  JAX planner's copy) that split the (tile, K-block) work evenly over
  ``n_programs``: one float32 partial tile a segment, each tile's
  segments summed in order. M, N and K must be multiples of their blocks
  (``ValueError``). Two launches: the partials, one block a program
  running its segments in order (``streamk_path`` picks the kernel:
  ``streamk_tma``, TMA + ``wgmma`` for bfloat16 / float16 at the tiles
  of ``STREAMK_TMA_TILES``, or ``streamk_gemm``, the tile loop), then
  ``streamk_fixup``.
* ``gemv(a, b, out_dtype, ...)`` — c = B @ a for a (K,) and B (N, K),
  float32 products and sums. One launch, counted as ``gemv``, of the
  kernel ``gemv_path`` picks (counted by name in ``kernel_launches``):
  ``gemv_bulk`` (a few blocks an SM, each streaming an equal span of B's
  rows by bulk copies, at ``gemv_bulk_plan``'s plan) or ``gemv`` (a warp
  a pair of rows, for misaligned operands and the rest).
* ``blocksparse_matmul(a, b, block_mask, ...)`` — A @ B on the output
  tiles whose (M / block_M, N / block_N) int32 mask cell is nonzero,
  exactly 0 elsewhere. One launch, counted as ``blocksparse_gemm``, of
  the kernel ``blocksparse_path`` picks: ``blocksparse_tma`` (TMA +
  ``wgmma``, a block a 128 x 128 tile, a dead tile its zeros) for
  aligned bfloat16 / float16, or ``blocksparse_gemm`` (the tile loop).
* The factories ``splitk_kernel`` (its callable gives the partials),
  ``streamk_kernel`` (the segment partials), ``gemv_kernel`` and
  ``blocksparse_gemm_kernel``: the same computations for fixed shapes and
  types.

Inputs are float32, bfloat16 or float16 (any other type raises
``TypeError``); outputs float32, bfloat16, float16 or float8 e4m3
(``ops/gemm.py::to_out``'s rounding). The ``block_*`` and ``num_stages``
arguments are the TPU's tiling hints, accepted and ignored except where
the JAX package derives the result's structure from them: split-K's
split, stream-K's segments and block-sparse's mask cells. On the card a
stream-K tile is one of ``STREAMK_TMA_TILES`` in bfloat16 / float16, or
at most 128 x 128 (``ValueError`` for any other); the plain versions
take any.

Each wrapper launches its kernel on CUDA tensors (a build or launch
failure raises; there is no fallback) and runs its plain PyTorch version
(``*_plain``, the kernel's arithmetic in torch eager) on CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Tuple

import torch

from ..resilience.errors import KernelLaunchError
from .bitnet import _cdiv
from .gemm import DTYPE_CODES, _as_dtype, _check, _out_dtype, check_grid, \
    to_out

__all__ = ["matmul_splitk", "matmul_splitk_plain", "splitk_plan",
           "splitk_kernel", "matmul_streamk", "matmul_streamk_plain",
           "streamk_kernel", "streamk_programs", "gemv", "gemv_plain",
           "gemv_kernel", "blocksparse_matmul", "blocksparse_matmul_plain",
           "blocksparse_gemm_kernel", "launches", "reset_launches",
           "IN_TYPES", "splitk_path", "splitk_stream_plan",
           "stream_slots", "SPLITK_STREAM_MAX_ROWS", "streamk_path",
           "STREAMK_TMA_TILES", "streamk_phase_programs",
           "blocksparse_path", "gemv_path", "gemv_bulk_plan",
           "gemv_bulk_smem", "GemvBulkPlan", "kernel_launches"]

# the input types the variants' kernels take
IN_TYPES = (torch.float32, torch.bfloat16, torch.float16)
_KERNEL_TILE = 128              # csrc/gemm_tile.cuh BM = BN
_GRID_Y_MAX = 65535
# the few-row split-K path (csrc/gemm_variants.cu splitk_stream): rows up
# to which it runs (its largest instance; PERF.md, #16, has the sweep),
# the columns of a block's strip (kStCols) and the rows a sub-range is a
# multiple of (four warps of 16-row steps)
SPLITK_STREAM_MAX_ROWS = 64
_STREAM_COLS = 64
_STREAM_K_UNIT = 64
# the stream-K TMA kernel's tiles (block_M, block_N): gemm_sm90.cuh's
# TL_SM90_BLOCKS; its K step is 64 where block_K is a multiple of 64,
# else 32
STREAMK_TMA_TILES = ((128, 128), (128, 256), (256, 128))

# kernel name -> launches through its wrapper (chip_smoke.py zeroes and
# reads these around each call to prove the path used the kernels)
launches = {"splitk_gemm": 0, "splitk_reduce": 0, "splitk_stream": 0,
            "splitk_stream_combine": 0, "streamk_tma": 0,
            "streamk_gemm": 0, "streamk_fixup": 0, "gemv": 0,
            "blocksparse_gemm": 0}


# the GEMV's launches by kernel (each also counts once as "gemv" above)
kernel_launches = {"gemv": 0, "gemv_bulk": 0}


def reset_launches() -> None:
    for d in (launches, kernel_launches):
        for k in d:
            d[k] = 0


def _types(a, b, out_dtype, what: str) -> torch.dtype:
    """The output type for float32, bfloat16 or float16 operands."""
    _check(a, b, what)
    if a.dtype not in IN_TYPES:
        raise TypeError(f"{what}: {a.dtype} inputs are not ported (float32,"
                        f" bfloat16 or float16)")
    return _out_dtype(a.dtype, out_dtype)


def _mk(a, b, what: str) -> Tuple[int, int, int]:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"{what}: want a (M, K) and b (K, N), got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    return int(a.shape[0]), int(b.shape[1]), int(a.shape[1])


def _call(lib: str, fn_name: str, kernel: str, dev, argtypes, *args):
    """Launch the C entry ``fn_name`` of ``csrc/<lib>.cu`` on ``dev``'s
    current stream; raise if it refused; count it."""
    from ._build import load, stream_call
    fn = getattr(load(lib), fn_name)
    fn.argtypes = list(argtypes) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = stream_call(fn, dev, *args)
    if code != 0:
        raise KernelLaunchError(kernel, code)
    launches[kernel] += 1


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


# ---------------------------------------------------------------------------
# split-K
# ---------------------------------------------------------------------------

def splitk_plan(K: int, n_split: int = 4,
                block_K: int = 128) -> Tuple[int, int, int]:
    """``(n_split, split_len, block_K)`` as the JAX wrapper chooses them
    (``ops/gemm_variants.py:71-79``): the largest split count up to
    ``n_split`` whose chunk is a multiple of 128 (Mosaic's lane rule on
    the TPU), else one full-K chunk; block_K the largest multiple of 128
    up to the asked one that divides the chunk, or the chunk itself."""
    if n_split < 1:
        raise ValueError(f"matmul_splitk: n_split must be >= 1, got "
                         f"{n_split}")
    while n_split > 1 and (K % n_split or (K // n_split) % 128):
        n_split -= 1
    split_len = K // n_split
    if split_len % 128 == 0:
        block_K = max(128, min(block_K, split_len) // 128 * 128)
        while split_len % block_K:
            block_K -= 128
    else:
        block_K = split_len
    return n_split, split_len, block_K


def _splitk_partials_plain(a, b, n_split: int) -> torch.Tensor:
    M, K = a.shape
    L = K // n_split
    a3 = a.float()[:, :n_split * L].reshape(M, n_split, L).transpose(0, 1)
    return torch.bmm(a3, b.float()[:n_split * L].reshape(n_split, L, -1))


def _sum_in_order(parts: torch.Tensor) -> torch.Tensor:
    c = parts[0].clone()
    for p in parts[1:]:
        c += p
    return c


def matmul_splitk_plain(a, b, n_split: int = 4, block_M=128, block_N=128,
                        block_K=128, out_dtype=None) -> torch.Tensor:
    """Plain version: the plan's float32 partials (``torch.bmm``) summed in
    split order, rounded once."""
    out = _types(a, b, out_dtype, "matmul_splitk")
    M, N, K = _mk(a, b, "matmul_splitk")
    n, _, _ = splitk_plan(K, n_split, block_K)
    if K == 0:
        return to_out(torch.zeros((M, N), device=a.device), out)
    return to_out(_sum_in_order(_splitk_partials_plain(a, b, n)), out)


def splitk_path(M: int, N: int, K: int, dtype, a_ptr: int = 0,
                b_ptr: int = 0) -> str:
    """Which kernel of ``gemm_variants.cu`` computes a split-K product
    of a (M, K) at ``a_ptr`` and b (K, N) at ``b_ptr`` on the card:

    * ``"stream"`` (``tl_splitk_stream``, then
      ``tl_splitk_stream_combine``): 1 to ``SPLITK_STREAM_MAX_ROWS`` rows
      of float32, bfloat16 or float16, K and N multiples of 16 bytes of
      the type and both bases on 16 bytes (every copy is 16 bytes);
    * ``"tile"`` (``tl_splitk_gemm``, then ``tl_splitk_reduce``):
      everything else."""
    dtype = _as_dtype(dtype)
    if dtype not in IN_TYPES or not 1 <= M <= SPLITK_STREAM_MAX_ROWS \
            or min(N, K) < 1:
        return "tile"
    v = 16 // torch.empty((), dtype=dtype).element_size()
    if K % v or N % v or (a_ptr | b_ptr) % 16:
        return "tile"
    return "stream"


def splitk_stream_plan(N: int, n_split: int, split_len: int, slots: int):
    """The few-row kernel's grid: ``(strips, n_sub, sub_len)``. A block
    owns ``_STREAM_COLS`` columns (``strips = ceil(N / 64)``) and a
    sub-range of ``sub_len`` rows (a multiple of 64) of one split's
    ``split_len``. Each split is cut into ``n_sub = ceil(split_len /
    sub_len)`` sub-ranges (the last may be shorter), as many as one wave
    of the ``slots`` blocks the card holds at once takes: ``sub_len =
    ceil(split_len / want)`` rounded up to 64 with ``want = max(1, slots
    // (strips n_split))`` (a grid past one wave by a fraction would
    leave its last wave mostly idle). Block p of the grid's ``n_split
    n_sub`` runs sub-range ``p % n_sub`` of split ``p // n_sub``; the
    partials are summed in that order."""
    strips = _cdiv(N, _STREAM_COLS)
    want = max(1, slots // (strips * n_split))
    sub_len = max(_STREAM_K_UNIT, _cdiv(_cdiv(split_len, want),
                                        _STREAM_K_UNIT) * _STREAM_K_UNIT)
    return strips, _cdiv(split_len, sub_len), sub_len


@functools.lru_cache(maxsize=None)
def stream_slots(device, M: int, dtype) -> int:
    """The few-row kernel's blocks the card holds at once for M rows of
    ``dtype``: its SMs times the kernel's blocks an SM (CUDA's occupancy
    calculator)."""
    from ._build import load
    fn = load("gemm_variants").tl_splitk_stream_blocks_per_sm
    fn.argtypes = [_I, _I, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        code = fn(M, DTYPE_CODES[dtype], ctypes.byref(blocks))
    if code != 0:
        raise KernelLaunchError("splitk_stream", code)
    return torch.cuda.get_device_properties(device).multi_processor_count \
        * blocks.value


def _stream_launch(a, b, n_split: int) -> Tuple[torch.Tensor, int]:
    """The few-row kernel's partials ``(n_split n_sub, M, N)`` float32
    (split-major) and ``n_sub``."""
    M, N, K = _mk(a, b, "matmul_splitk")
    split_len = K // n_split
    _, n_sub, sub_len = splitk_stream_plan(
        N, n_split, split_len, stream_slots(a.device, M, a.dtype))
    if n_split * n_sub > _GRID_Y_MAX:
        raise ValueError(f"matmul_splitk: {n_split} x {n_sub} partials "
                         f"are past the kernel grid's range")
    ws = torch.empty((n_split * n_sub, M, N), dtype=torch.float32,
                     device=a.device)
    _call("gemm_variants", "tl_splitk_stream", "splitk_stream", a.device,
          [_P, _P, _P] + [_I] * 8, a.data_ptr(), b.data_ptr(),
          ws.data_ptr(), M, N, K, n_split, split_len, n_sub, sub_len,
          DTYPE_CODES[a.dtype])
    return ws, n_sub


def _stream_combine_launch(ws, groups: int, out: torch.dtype):
    """``(groups, M, N)`` in ``out``: each group the sum of its
    ``len(ws) // groups`` consecutive partials, in order."""
    parts, M, N = ws.shape
    c = torch.empty((groups, M, N), dtype=out, device=ws.device)
    _call("gemm_variants", "tl_splitk_stream_combine",
          "splitk_stream_combine", ws.device, [_P, _P, _L, _I, _I, _I],
          ws.data_ptr(), c.data_ptr(), M * N, groups, parts // groups,
          DTYPE_CODES[out])
    return c


def _splitk_partials_launch(a, b, n_split: int) -> torch.Tensor:
    """Cp (n_split, M, N) float32 by ``splitk_path``'s kernel: the
    stream path's sub-ranges of each split summed in order (no second
    launch when each split is one sub-range)."""
    M, N, K = _mk(a, b, "matmul_splitk")
    a, b = a.contiguous(), b.contiguous()
    if M * N == 0 or K == 0:
        return torch.zeros((n_split, M, N), dtype=torch.float32,
                           device=a.device)
    if splitk_path(M, N, K, a.dtype, a.data_ptr(),
                   b.data_ptr()) == "stream":
        ws, n_sub = _stream_launch(a, b, n_split)
        return ws if n_sub == 1 else _stream_combine_launch(
            ws, n_split, torch.float32)
    return _tile_partials_launch(a, b, n_split)


def _tile_partials_launch(a, b, n_split: int) -> torch.Tensor:
    M, N, K = _mk(a, b, "matmul_splitk")
    check_grid(M, N, "matmul_splitk")
    if n_split > _GRID_Y_MAX:
        raise ValueError(f"matmul_splitk: n_split {n_split} is past the "
                         f"kernel grid's range")
    ws = torch.empty((n_split, M, N), dtype=torch.float32, device=a.device)
    _call("gemm_variants", "tl_splitk_gemm", "splitk_gemm", a.device,
          [_P, _P, _P] + [_I] * 6, a.data_ptr(), b.data_ptr(),
          ws.data_ptr(), M, N, K, n_split, K // n_split,
          DTYPE_CODES[a.dtype])
    return ws


def _splitk_reduce_launch(ws, out: torch.dtype) -> torch.Tensor:
    n_split, M, N = ws.shape
    c = torch.empty((M, N), dtype=out, device=ws.device)
    _call("gemm_variants", "tl_splitk_reduce", "splitk_reduce", ws.device,
          [_P, _P, _L, _I, _I], ws.data_ptr(), c.data_ptr(), M * N, n_split,
          DTYPE_CODES[out])
    return c


def matmul_splitk(a, b, n_split: int = 4, block_M=128, block_N=128,
                  block_K=128, out_dtype=None) -> torch.Tensor:
    """C = A @ B over ``splitk_plan``'s K chunks, the float32 partials
    summed in split order, in ``out_dtype`` (default: a's type). CUDA
    tensors launch the kernels (``splitk_path`` picks them); CPU tensors
    run the plain version."""
    out = _types(a, b, out_dtype, "matmul_splitk")
    M, N, K = _mk(a, b, "matmul_splitk")
    if not a.is_cuda:
        return matmul_splitk_plain(a, b, n_split, block_K=block_K,
                                   out_dtype=out)
    n, _, _ = splitk_plan(K, n_split, block_K)
    a, b = a.contiguous(), b.contiguous()
    if M * N == 0:
        return torch.empty((M, N), dtype=out, device=a.device)
    if K == 0:
        return to_out(torch.zeros((M, N), device=a.device), out)
    if splitk_path(M, N, K, a.dtype, a.data_ptr(),
                   b.data_ptr()) == "stream":
        ws, _ = _stream_launch(a, b, n)
        return _stream_combine_launch(ws, 1, out)[0]
    return _splitk_reduce_launch(_tile_partials_launch(a, b, n), out)


def splitk_kernel(M, N, K, n_split, block_M, block_N, block_K, in_dtype,
                  num_stages=2):
    """The JAX package's factory: a callable ``k(a, b)`` giving the
    partials ``Cp (n_split, M, N)`` float32, ``Cp[s] = A[:, s L:(s+1) L]
    @ B[s L:(s+1) L]`` with ``L = K // n_split``. K must split into
    chunks that are multiples of ``block_K``, as the JAX wrapper's plan
    always gives (``ValueError`` otherwise)."""
    in_dt = _as_dtype(in_dtype)
    if in_dt not in IN_TYPES:
        raise TypeError(f"splitk_kernel: {in_dt} inputs are not ported "
                        f"(float32, bfloat16 or float16)")
    if n_split < 1 or K % n_split or (K // n_split) % block_K:
        raise ValueError(f"splitk_kernel: K={K} does not split into "
                         f"{n_split} chunks of whole {block_K}-blocks")

    def kernel(a, b):
        if tuple(a.shape) != (M, K) or tuple(b.shape) != (K, N) \
                or a.dtype != in_dt:
            raise ValueError(f"splitk_kernel: want a ({M}, {K}), b ({K}, "
                             f"{N}) of {in_dt}, got {tuple(a.shape)}, "
                             f"{tuple(b.shape)} of {a.dtype}")
        _types(a, b, None, "splitk_kernel")
        if a.is_cuda:
            return _splitk_partials_launch(a, b, n_split)
        return _splitk_partials_plain(a, b, n_split)

    return kernel


# ---------------------------------------------------------------------------
# stream-K
# ---------------------------------------------------------------------------

def _streamk_segments(n_tiles: int, k_iters: int,
                      n_programs: int) -> List[Tuple[int, int, int]]:
    """Balance the flat (tile, k-block) iteration space over
    ``n_programs`` programs and cut each program's contiguous range at
    tile boundaries: ``[(tile, k0, k_len)]`` in flat order (a copy of the
    JAX package's ``layout/python_impl.py::streamk_partition``)."""
    total = n_tiles * k_iters
    per = -(-total // n_programs)
    segs = []
    for p in range(n_programs):
        s, e = p * per, min(total, (p + 1) * per)
        while s < e:
            tile, k0 = divmod(s, k_iters)
            klen = min(k_iters - k0, e - s)
            segs.append((tile, k0, klen))
            s += klen
    return segs


def _streamk_shapes(a, b, n_programs, block_M, block_N, block_K):
    M, N, K = _mk(a, b, "matmul_streamk")
    if n_programs < 1:
        raise ValueError(f"matmul_streamk: n_programs must be >= 1, got "
                         f"{n_programs}")
    if M % block_M or N % block_N or K % block_K:
        raise ValueError(f"matmul_streamk: M={M}, N={N}, K={K} must be "
                         f"multiples of block_M={block_M}, block_N="
                         f"{block_N}, block_K={block_K}")
    return M, N, K


@functools.lru_cache(maxsize=64)
def _streamk_tables(M, N, K, n_programs, block_M, block_N, block_K,
                    device: torch.device):
    """On ``device``, built on the host once a shape: tables (4, n_seg)
    int32 (tile_m, tile_n, k_start, k_len); first (n_tiles + 1) int32,
    tile t's segments first[t] .. first[t + 1]; prog (n_prog + 1) int32,
    program p's segments prog[p] .. prog[p + 1] (the programs with
    work)."""
    nN = N // block_N
    k_iters = K // block_K
    n_tiles = (M // block_M) * nN
    segs = _streamk_segments(n_tiles, k_iters, n_programs)
    tiles = torch.tensor([s[0] for s in segs], dtype=torch.int64)
    k0 = torch.tensor([s[1] for s in segs], dtype=torch.int64)
    tables = torch.stack([tiles // nN, tiles % nN, k0,
                          torch.tensor([s[2] for s in segs])]).to(
                              torch.int32)
    first = torch.searchsorted(tiles, torch.arange(n_tiles + 1))
    # a segment's program: where its flat start falls among the programs'
    # equal ranges (the planner's `per`)
    per = -(-n_tiles * k_iters // n_programs)
    program = (tiles * k_iters + k0) // per
    prog = torch.searchsorted(program, torch.arange(int(program[-1]) + 2))
    return (tables.to(device), first.to(torch.int32).to(device),
            prog.to(torch.int32).to(device))


def _streamk_partials_plain(a, b, tables, block_M, block_N, block_K):
    a32, b32 = a.float(), b.float()
    parts = []
    for tm, tn, k0, kl in tables.T.tolist():
        ks = slice(k0 * block_K, (k0 + kl) * block_K)
        parts.append(a32[tm * block_M:(tm + 1) * block_M, ks]
                     @ b32[ks, tn * block_N:(tn + 1) * block_N])
    return torch.stack(parts)


def matmul_streamk_plain(a, b, n_programs: int = 8, block_M=128,
                         block_N=128, block_K=128,
                         out_dtype=None) -> torch.Tensor:
    """Plain version: each segment's float32 partial tile, each tile's
    segments summed in segment order, rounded once."""
    out = _types(a, b, out_dtype, "matmul_streamk")
    M, N, K = _streamk_shapes(a, b, n_programs, block_M, block_N, block_K)
    if M * N == 0:
        return torch.empty((M, N), dtype=out, device=a.device)
    if K == 0:
        return to_out(torch.zeros((M, N), device=a.device), out)
    tables, first, _ = _streamk_tables(M, N, K, n_programs, block_M,
                                       block_N, block_K, a.device)
    part = _streamk_partials_plain(a, b, tables, block_M, block_N, block_K)
    # tile t's r-th segment is first[t] + r; each round adds one segment
    # to every tile that has one, so every tile sums in segment order
    first = first.long()
    count = first[1:] - first[:-1]
    fixed = part[first[:-1]]
    for r in range(1, int(count.max())):
        t = torch.nonzero(count > r).flatten()
        fixed[t] += part[first[t] + r]
    nM, nN = M // block_M, N // block_N
    c = fixed.reshape(nM, nN, block_M, block_N).transpose(1, 2)
    return to_out(c.reshape(M, N), out)


def streamk_path(M: int, N: int, K: int, dtype, block_M: int = 128,
                 block_N: int = 128, block_K: int = 128, a_ptr: int = 0,
                 b_ptr: int = 0) -> str:
    """Which kernel of ``gemm_variants.cu`` computes a stream-K call's
    partials on the card for a (M, K) at ``a_ptr`` and b (K, N) at
    ``b_ptr`` (the rule of ``ops/gemm.py::matmul_path``):

    * ``"tma"`` (``tl_streamk_tma``): bfloat16 or float16, ``(block_M,
      block_N)`` one of ``STREAMK_TMA_TILES``, ``block_K`` a multiple of
      32, both bases and both row strides on 16 bytes;
    * ``"loop"`` (``tl_streamk_gemm``, the tile loop): everything else,
      float32 included (it takes tiles up to 128 x 128).

    The rule decides before the launch; a kernel that fails on either
    path raises."""
    dtype = _as_dtype(dtype)
    if dtype not in (torch.bfloat16, torch.float16) or min(M, N, K) < 1 \
            or (block_M, block_N) not in STREAMK_TMA_TILES \
            or block_K < 32 or block_K % 32 or K % 8 or N % 8 \
            or (a_ptr | b_ptr) % 16:
        return "loop"
    return "tma"


def _streamk_partials_launch(a, b, tables, prog, block_M, block_N,
                             block_K):
    """Part (n_seg, block_M, block_N): one block a program, running
    segments prog[p] .. prog[p + 1], on ``streamk_path``'s kernel."""
    M, N, K = _mk(a, b, "matmul_streamk")
    a, b, tables = a.contiguous(), b.contiguous(), tables.contiguous()
    path = streamk_path(M, N, K, a.dtype, block_M, block_N, block_K,
                        a.data_ptr(), b.data_ptr())
    if path == "loop" and (block_M > _KERNEL_TILE
                           or block_N > _KERNEL_TILE):
        raise ValueError(
            f"matmul_streamk: the card's tiles are up to {_KERNEL_TILE} x "
            f"{_KERNEL_TILE} (the tile loop), and "
            + ", ".join(f"{m} x {n}" for m, n in STREAMK_TMA_TILES)
            + f" in bfloat16 / float16 (the TMA kernel); block_M="
            f"{block_M}, block_N={block_N} in {a.dtype} is none of them")
    n_seg, n_prog = int(tables.shape[1]), int(prog.numel()) - 1
    part = torch.empty((n_seg, block_M, block_N), dtype=torch.float32,
                       device=a.device)
    if n_seg == 0:
        return part
    ptrs = (a.data_ptr(), b.data_ptr(),
            *(tables[i].data_ptr() for i in range(4)), prog.data_ptr(),
            part.data_ptr())
    code = DTYPE_CODES[a.dtype]
    if path == "tma":
        _call("gemm_variants", "tl_streamk_tma", "streamk_tma", a.device,
              [_P] * 8 + [_I] * 8, *ptrs, n_prog, M, N, K, block_M,
              block_N, block_K, code)
    else:
        _call("gemm_variants", "tl_streamk_gemm", "streamk_gemm", a.device,
              [_P] * 8 + [_I] * 7, *ptrs, n_prog, N, K, block_M, block_N,
              block_K, code)
    return part


def matmul_streamk(a, b, n_programs: int = 8, block_M=128, block_N=128,
                   block_K=128, out_dtype=None) -> torch.Tensor:
    """C = A @ B over ``n_programs`` balanced stream-K programs' segments,
    each tile's float32 partials summed in segment order, in
    ``out_dtype`` (default: a's type). CUDA tensors launch the kernels;
    CPU tensors run the plain version."""
    out = _types(a, b, out_dtype, "matmul_streamk")
    M, N, K = _streamk_shapes(a, b, n_programs, block_M, block_N, block_K)
    if not a.is_cuda:
        return matmul_streamk_plain(a, b, n_programs, block_M, block_N,
                                    block_K, out)
    c = torch.empty((M, N), dtype=out, device=a.device)
    if c.numel() == 0:
        return c
    if K == 0:
        return c.zero_()
    tables, first, prog = _streamk_tables(M, N, K, n_programs, block_M,
                                          block_N, block_K, a.device)
    part = _streamk_partials_launch(a, b, tables, prog, block_M, block_N,
                                    block_K)
    _call("gemm_variants", "tl_streamk_fixup", "streamk_fixup", a.device,
          [_P] * 3 + [_I] * 5, part.data_ptr(), first.data_ptr(),
          c.data_ptr(), M, N, block_M, block_N, DTYPE_CODES[out])
    return c


def streamk_kernel(M, N, K, n_seg, block_M, block_N, block_K, in_dtype):
    """The JAX package's factory: a callable ``k(a, b, tile_m, tile_n,
    k_start, k_len)`` (int32 tables of ``n_seg``, k in block_K units)
    giving the segment partials ``Part (n_seg, block_M, block_N)``
    float32."""
    in_dt = _as_dtype(in_dtype)
    if in_dt not in IN_TYPES:
        raise TypeError(f"streamk_kernel: {in_dt} inputs are not ported "
                        f"(float32, bfloat16 or float16)")

    def kernel(a, b, tile_m, tile_n, k_start, k_len):
        if tuple(a.shape) != (M, K) or tuple(b.shape) != (K, N) \
                or a.dtype != in_dt:
            raise ValueError(f"streamk_kernel: want a ({M}, {K}), b ({K}, "
                             f"{N}) of {in_dt}, got {tuple(a.shape)}, "
                             f"{tuple(b.shape)} of {a.dtype}")
        _types(a, b, None, "streamk_kernel")
        _streamk_shapes(a, b, 1, block_M, block_N, block_K)
        tables = torch.stack([torch.as_tensor(t, device=a.device).to(
            torch.int32).reshape(-1) for t in (tile_m, tile_n, k_start,
                                               k_len)])
        if tables.shape[1] != n_seg:
            raise ValueError(f"streamk_kernel: want {n_seg} segments, got "
                             f"{tables.shape[1]}")
        if a.is_cuda:                   # one block a segment
            prog = torch.arange(n_seg + 1, dtype=torch.int32,
                                device=a.device)
            return _streamk_partials_launch(a, b, tables, prog, block_M,
                                            block_N, block_K)
        return _streamk_partials_plain(a, b, tables, block_M, block_N,
                                       block_K)

    return kernel


def _in_phase_programs(M: int, N: int, K: int, block_M: int,
                       block_N: int, block_K: int, slots: int):
    """The most programs up to ``slots`` whose equal share of the (tile,
    k-block) iterations divides a tile row's (N / block_N * K / block_K),
    or None where there are none: one tile row, or a share past a tile
    row (more tile rows than slots)."""
    nM = M // block_M
    row = (N // block_N) * (K // block_K)
    if nM < 2 or row < 1 or slots < 1:
        return None
    total = nM * row
    per = next((p for p in range(-(-total // slots), row + 1)
                if row % p == 0), None)
    return None if per is None else total // per


def streamk_phase_programs(M: int, N: int, K: int, block_M: int = 128,
                           block_N: int = 128, block_K: int = 128,
                           slots: int = 132) -> int:
    """A program count for ``matmul_streamk`` up to ``slots`` (the
    co-resident blocks, ``streamk_programs``) at which the tile rows run
    in phase: the most programs whose equal share of the (tile, k-block)
    iterations divides a tile row's (N / block_N * K / block_K). Program
    p starts at p times its share, so the programs of every tile row then
    read the same k-block of B at the same time and L2 serves it to all
    but the first; at 132 programs on LLaMA-2-7B's prefill gate/up the
    four 128-row tile rows read B 64 of 84 steps apart, four times from
    HBM (PERF.md §6 row 17). ``slots`` itself where there is no such
    count (one tile row, or more tile rows than slots) or it would keep
    half the slots busy or fewer: from 0.52 to 0.97 of 132 slots the
    count in phase ran from 5 % behind to 1.5x ahead of all slots on an
    H100 (``scripts/streamk_phase_sweep.py``); below half it was not
    measured, and a program's share grows as the count shrinks."""
    n = _in_phase_programs(M, N, K, block_M, block_N, block_K, slots)
    if n is None:
        return slots
    total = (M // block_M) * (N // block_N) * (K // block_K)
    return n if 2 * n > min(slots, total) else slots


def streamk_programs(device=None, dtype=torch.bfloat16, block_M: int = 128,
                     block_N: int = 128, block_K: int = 128, a_ptr: int = 0,
                     b_ptr: int = 0) -> int:
    """The stream-K blocks the card holds at once for a call of ``dtype``
    at these blocks on operands at ``a_ptr`` and ``b_ptr`` (by default
    aligned), on the kernel ``streamk_path`` gives it: the TMA kernel
    holds one block an SM (its launch bounds and its ring's shared
    memory), so the card's SMs; the tile loop, the SMs times its blocks
    an SM for ``dtype`` (CUDA's occupancy calculator)."""
    from ._build import load
    dev = torch.device("cuda" if device is None else device)
    dtype = _as_dtype(dtype)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if streamk_path(block_M, block_N, block_K, dtype, block_M, block_N,
                    block_K, a_ptr, b_ptr) == "tma":
        return sms
    fn = load("gemm_variants").tl_streamk_blocks_per_sm
    fn.argtypes = [_I, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    with torch.cuda.device(dev):
        code = fn(DTYPE_CODES[dtype], ctypes.byref(blocks))
    if code != 0:
        raise KernelLaunchError("streamk_gemm", code)
    return sms * blocks.value


# ---------------------------------------------------------------------------
# GEMV
# ---------------------------------------------------------------------------

def _gemv_checks(a, b, out_dtype) -> torch.dtype:
    out = _types(a, b, out_dtype, "gemv")
    if a.dim() != 1 or b.dim() != 2 or b.shape[1] != a.shape[0]:
        raise ValueError(f"gemv: want a (K,) and b (N, K), got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    return out


# gemv_bulk (csrc/gemv.cu): the most blocks an SM it tries, the bytes of
# B a stage holds (whole rows, at least one) and its stages (PERF.md,
# #18, has the sweep); an SM's shared memory for blocks, a block's opt-in
# maximum (gemm_sm90.cuh's kSmemOptin) and the runtime's reservation a
# block (an H100's)
GEMV_BULK_BLOCKS_PER_SM = 4
GEMV_BULK_STAGE_BYTES = 16 * 1024
GEMV_BULK_STAGES = 2
_SMEM_PER_SM = 228 * 1024
_SMEM_BLOCK_MAX = 232448
_SMEM_RESERVED = 1024
# tl_gemv's path codes
_GEMV_PATHS = {"gemv": 0, "gemv_bulk": 1}


class GemvBulkPlan(NamedTuple):
    """gemv_bulk's launch: ``blocks`` blocks, block i owning rows
    ``[i * base + min(i, extra), ...)``, ``base + (i < extra)`` of them
    (``base, extra = divmod(N, blocks)``); ``rows`` rows of B a stage,
    ``stages`` stages; ``smem`` bytes of shared memory (``a``, the ring,
    its barriers)."""
    blocks: int
    rows: int
    stages: int
    smem: int


def gemv_bulk_smem(K: int, esize: int, rows: int, stages: int) -> int:
    """gemv_bulk's dynamic shared memory, as csrc/gemv.cu's ``bulk_smem``
    computes it: ``a``, ``stages`` stages of ``rows`` rows, the full and
    empty barriers of each stage and ``a``'s."""
    return K * esize + stages * rows * K * esize + 8 * (2 * stages + 1)


def gemv_bulk_plan(N: int, K: int, dtype,
                   sms: int) -> Optional[GemvBulkPlan]:
    """The plan of ``gemv_bulk`` for B (N, K) of ``dtype`` on a card of
    ``sms`` SMs, or None where it does not apply: rows of K * size bytes
    (a multiple of 16); the most blocks an SM, from
    ``GEMV_BULK_BLOCKS_PER_SM`` down to one, that give every block a row
    and hold ``GEMV_BULK_STAGES`` stages in their share of the SM's shared
    memory; a stage the whole rows that fit ``GEMV_BULK_STAGE_BYTES`` (at
    least one, at most a block's span)."""
    esize = torch.empty((), dtype=_as_dtype(dtype)).element_size()
    row = K * esize
    if row <= 0 or row % 16:
        return None
    for bps in range(GEMV_BULK_BLOCKS_PER_SM, 0, -1):
        blocks = bps * sms
        if N < blocks:
            continue
        rows = min(max(1, GEMV_BULK_STAGE_BYTES // row), _cdiv(N, blocks))
        smem = gemv_bulk_smem(K, esize, rows, GEMV_BULK_STAGES)
        room = min(_SMEM_BLOCK_MAX, _SMEM_PER_SM // bps - _SMEM_RESERVED)
        if smem <= room:
            return GemvBulkPlan(blocks, rows, GEMV_BULK_STAGES, smem)
    return None


def gemv_path(N: int, K: int, dtype, a_ptr: int = 0, b_ptr: int = 0,
              sms: int = 132) -> str:
    """Which kernel of ``gemv.cu`` computes B (N, K) @ a (K,) of
    ``dtype`` at ``a_ptr`` and ``b_ptr`` on a card of ``sms`` SMs, decided
    before any launch: ``"gemv_bulk"`` where both bases sit on 16 bytes
    and ``gemv_bulk_plan`` has a plan; ``"gemv"`` otherwise."""
    if _as_dtype(dtype) not in IN_TYPES or (a_ptr | b_ptr) % 16 \
            or gemv_bulk_plan(N, K, dtype, sms) is None:
        return "gemv"
    return "gemv_bulk"


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def gemv_plain(a, b, out_dtype=None, block_N=128,
               block_K=512) -> torch.Tensor:
    """Plain version: the float32 dot of each row of B with a."""
    out = _gemv_checks(a, b, out_dtype)
    return to_out(torch.mv(b.float(), a.float()), out)


def gemv(a, b, out_dtype=None, block_N=128, block_K=512) -> torch.Tensor:
    """c = B @ a with a (K,), B (N, K) -> (N,) in ``out_dtype`` (default:
    a's type), float32 products and sums. CUDA tensors launch the kernel;
    CPU tensors run the plain version."""
    out = _gemv_checks(a, b, out_dtype)
    if not a.is_cuda:
        return gemv_plain(a, b, out)
    N, K = int(b.shape[0]), int(b.shape[1])
    c = torch.empty((N,), dtype=out, device=a.device)
    if N == 0:
        return c
    if K == 0:
        return c.zero_()
    a, b = a.contiguous(), b.contiguous()
    sms = _sm_count(a.device)
    path = gemv_path(N, K, a.dtype, a.data_ptr(), b.data_ptr(), sms)
    plan = gemv_bulk_plan(N, K, a.dtype, sms) if path == "gemv_bulk" \
        else GemvBulkPlan(0, 0, 0, 0)
    _call("gemv", "tl_gemv", "gemv", a.device, [_P] * 3 + [_I] * 8,
          a.data_ptr(), b.data_ptr(), c.data_ptr(), N, K,
          DTYPE_CODES[a.dtype], DTYPE_CODES[out], _GEMV_PATHS[path],
          *plan[:3])
    kernel_launches[path] += 1
    return c


def gemv_kernel(N, K, block_N, block_K, in_dtype, out_dtype, num_stages=2):
    """The JAX package's factory: a callable ``k(a, b)`` with a (1, K), B
    (N, K) giving (1, N) in ``out_dtype``."""
    in_dt = _as_dtype(in_dtype)
    out = _out_dtype(in_dt, out_dtype)
    if in_dt not in IN_TYPES:
        raise TypeError(f"gemv_kernel: {in_dt} inputs are not ported "
                        f"(float32, bfloat16 or float16)")

    def kernel(a, b):
        if tuple(a.shape) != (1, K) or tuple(b.shape) != (N, K) \
                or a.dtype != in_dt:
            raise ValueError(f"gemv_kernel: want a (1, {K}), b ({N}, {K}) "
                             f"of {in_dt}, got {tuple(a.shape)}, "
                             f"{tuple(b.shape)} of {a.dtype}")
        return gemv(a.reshape(K), b, out).reshape(1, N)

    return kernel


# ---------------------------------------------------------------------------
# block-sparse GEMM
# ---------------------------------------------------------------------------

def _blocksparse_checks(a, b, block_mask, block_M, block_N, out_dtype):
    out = _types(a, b, out_dtype, "blocksparse_matmul")
    M, N, K = _mk(a, b, "blocksparse_matmul")
    if block_M < 1 or block_N < 1 or M % block_M or N % block_N:
        raise ValueError(f"blocksparse_matmul: M={M}, N={N} must be "
                         f"multiples of block_M={block_M}, block_N="
                         f"{block_N}")
    want = (M // block_M, N // block_N)
    if tuple(block_mask.shape) != want:
        raise ValueError(f"blocksparse_matmul: block_mask must be {want} "
                         f"(M / block_M, N / block_N), got "
                         f"{tuple(block_mask.shape)}")
    if block_mask.device != a.device:
        raise ValueError(f"blocksparse_matmul: block_mask on "
                         f"{block_mask.device}, operands on {a.device}")
    if block_mask.dtype.is_floating_point or block_mask.is_complex():
        raise TypeError(f"blocksparse_matmul: block_mask must be int32, "
                        f"got {block_mask.dtype}")
    return out, M, N, K


def blocksparse_matmul_plain(a, b, block_mask, block_M=128, block_N=128,
                             block_K=128, out_dtype=None) -> torch.Tensor:
    """Plain version: the float32 product, 0 outside the live cells."""
    out, M, N, K = _blocksparse_checks(a, b, block_mask, block_M, block_N,
                                       out_dtype)
    live = (block_mask != 0).repeat_interleave(block_M, 0) \
        .repeat_interleave(block_N, 1)
    c = torch.matmul(a.float(), b.float())
    return to_out(torch.where(live, c, torch.zeros((), device=c.device)),
                  out)


def blocksparse_path(M: int, N: int, K: int, dtype, a_ptr: int = 0,
                     b_ptr: int = 0) -> str:
    """Which kernel of ``gemm_variants.cu`` computes a block-sparse call
    on the card for a (M, K) at ``a_ptr`` and b (K, N) at ``b_ptr``
    (``streamk_path``'s rule):

    * ``"tma"`` (``tl_blocksparse_tma``): bfloat16 or float16, both bases
      and both row strides (K, N elements) on 16 bytes;
    * ``"loop"`` (``tl_blocksparse_gemm``, the tile loop): everything
      else, float32 included.

    The rule decides before the launch; a kernel that fails on either
    path raises."""
    dtype = _as_dtype(dtype)
    if dtype not in (torch.bfloat16, torch.float16) or min(M, N, K) < 1 \
            or K % 8 or N % 8 or (a_ptr | b_ptr) % 16:
        return "loop"
    return "tma"


def blocksparse_matmul(a, b, block_mask, block_M=128, block_N=128,
                       block_K=128, out_dtype=None) -> torch.Tensor:
    """C tiles where ``block_mask`` (M / block_M, N / block_N) is nonzero
    hold A @ B (float32 sums), every other element is exactly 0; in
    ``out_dtype`` (default: a's type). CUDA tensors launch the kernel;
    CPU tensors run the plain version."""
    out, M, N, K = _blocksparse_checks(a, b, block_mask, block_M, block_N,
                                       out_dtype)
    if not a.is_cuda:
        return blocksparse_matmul_plain(a, b, block_mask, block_M, block_N,
                                        block_K, out)
    c = torch.empty((M, N), dtype=out, device=a.device)
    if c.numel() == 0:
        return c
    check_grid(M, N, "blocksparse_matmul")
    a, b = a.contiguous(), b.contiguous()
    mask = block_mask.to(torch.int32).contiguous()
    args = (a.data_ptr(), b.data_ptr(), mask.data_ptr(), c.data_ptr(), M, N,
            K, block_M, block_N, DTYPE_CODES[a.dtype], DTYPE_CODES[out])
    if blocksparse_path(M, N, K, a.dtype, a.data_ptr(),
                        b.data_ptr()) == "tma":
        _call("gemm_variants", "tl_blocksparse_tma", "blocksparse_gemm",
              a.device, [_P] * 4 + [_I] * 7, *args)
    else:
        _call("gemm_variants", "tl_blocksparse_gemm", "blocksparse_gemm",
              a.device, [_P] * 4 + [_I] * 7, *args)
    return c


def blocksparse_gemm_kernel(M, N, K, block_M, block_N, block_K, in_dtype,
                            out_dtype, num_stages=2):
    """The JAX package's factory: a callable ``k(a, b, block_mask)``
    computing ``blocksparse_matmul`` for these shapes and types."""
    in_dt = _as_dtype(in_dtype)
    out = _out_dtype(in_dt, out_dtype)
    if in_dt not in IN_TYPES:
        raise TypeError(f"blocksparse_gemm_kernel: {in_dt} inputs are not "
                        f"ported (float32, bfloat16 or float16)")

    def kernel(a, b, block_mask):
        if tuple(a.shape) != (M, K) or tuple(b.shape) != (K, N) \
                or a.dtype != in_dt:
            raise ValueError(f"blocksparse_gemm_kernel: want a ({M}, {K}), "
                             f"b ({K}, {N}) of {in_dt}, got "
                             f"{tuple(a.shape)}, {tuple(b.shape)} of "
                             f"{a.dtype}")
        return blocksparse_matmul(a, b, block_mask, block_M, block_N,
                                  block_K, out)

    return kernel
