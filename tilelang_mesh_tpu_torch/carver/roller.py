"""Tile-config recommendation ("roller") for the card.

Counterpart of ``tilelang_mesh_tpu/carver/roller.py`` (``Hint``,
``Candidate``, ``DefaultPolicy``, ``_tile_candidates``,
``MatmulTemplate``, ``recommend_hints``). The ranking is the JAX
package's: a candidate's predicted latency is the roofline maximum of
its product time and its HBM time plus a per-step overhead, ties broken
toward squarer tiles and then a deeper K step. What bounds a candidate
is Hopper's, not a TPU core's: its double-buffered operand tiles must
fit the shared memory a block can opt into, its float32 accumulator the
register budget of one block, and utilisation is counted against the
``mma.sync`` tile.

``MatmulTemplate`` proposes blocks from a fixed space, the instances of
the hand-written GEMM yardstick (``csrc/yardstick_gemm.cu``): bm and bn
from 128 (a block's 8 warps as 2 x 4, each at least a 64 x 32 warp tile
of 4 x 4 m16n8 products) to 256, bk from 32 (two k16 steps of a 16-bit
mma, one k32 step of an fp8 one) to 64. ``KERNEL_BLOCKS`` is the set it
can propose on the H100; ``ops/yardsticks.py`` refuses any other block.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Tuple

from .arch import H100_SXM, HopperArch, auto_arch, dtype_bytes

__all__ = ["Hint", "Candidate", "DefaultPolicy", "MatmulTemplate",
           "recommend_hints", "KERNEL_BLOCKS", "proposable_blocks"]


@dataclass
class Hint:
    config: Dict[str, int]
    score: float          # higher = better (1 / predicted_ms)
    predicted_ms: float = 0.0

    def __repr__(self):
        return (f"Hint({self.config}, score={self.score:.3g}, "
                f"~{self.predicted_ms:.4f} ms)")


@dataclass
class Candidate:
    """One tiling choice in roofline terms: total work, total HBM
    traffic, a block's shared-memory and accumulator bytes, the grid's
    step count and the fraction of the mma tile the block shape keeps
    busy."""
    config: Dict[str, int]
    flops: float            # total useful FLOPs of the problem
    hbm_bytes: float        # total HBM traffic
    smem_bytes: int = 0     # a block's double-buffered operand tiles
    acc_bytes: int = 0      # a block's float32 accumulator
    n_tiles: int = 1        # output tiles x K steps
    utilization: float = 1.0


class DefaultPolicy:
    """Roofline-ranked tile policy (the JAX package's ``DefaultPolicy``
    on the card's limits). Ranks a template's candidates by

        t = max(flops / (peak * util), hbm_bytes / bw)
            + n_tiles * step_overhead

    and drops those whose operand tiles overflow a block's opt-in shared
    memory or whose accumulator overflows its register budget."""

    def __init__(self, arch: Optional[HopperArch] = None,
                 peak_class: str = "bf16"):
        self.arch = arch or auto_arch()
        self.peak_class = peak_class

    def predicted_ms(self, c: Candidate) -> float:
        arch = self.arch
        peak = arch.peak_tflops[self.peak_class] * 1e12
        t_mma = c.flops / (peak * max(c.utilization, 1e-3))
        t_hbm = c.hbm_bytes / (arch.hbm_gbps * 1e9)
        return (max(t_mma, t_hbm) + c.n_tiles * arch.step_overhead_s) * 1e3

    def fits(self, c: Candidate) -> bool:
        return (c.smem_bytes <= self.arch.smem_per_block
                and c.acc_bytes <= self.arch.acc_budget_bytes())

    def rank(self, candidates: List[Candidate],
             topk: int = 10) -> List[Hint]:
        hints = []
        for c in candidates:
            if not self.fits(c):
                continue
            ms = self.predicted_ms(c)
            hints.append(Hint(c.config, 1.0 / max(ms, 1e-9), ms))

        def key(h):
            dims = [v for k, v in h.config.items() if k.startswith("block")]
            return (round(h.predicted_ms, 7),
                    -min(dims) if dims else 0,
                    -dims[-1] if dims else 0)
        hints.sort(key=key)
        return hints[:topk]


def _tile_candidates(dim: int, minimum: int, cap: int = 1024) -> List[int]:
    out = []
    t = minimum
    while t <= min(dim, cap):
        if dim % t == 0:
            out.append(t)
        t *= 2
    return out or [min(dim, minimum)]


# the yardstick kernel's block space (see the module docstring)
BLOCK_MN = (128, 256)
BLOCK_K = (32, 64)


@dataclass
class MatmulTemplate:
    """GEMM M/N/K tiling over the yardstick's block space."""
    M: int
    N: int
    K: int
    in_dtype: str = "bfloat16"
    accum_dtype: str = "float32"
    arch: Optional[HopperArch] = None

    def candidate(self, bm: int, bn: int, bk: int) -> Candidate:
        """The (bm, bn, bk) tiling of this problem in roofline terms."""
        arch = self.arch or auto_arch()
        ib = dtype_bytes(self.in_dtype)
        ab = dtype_bytes(self.accum_dtype)
        # A streams once per N-block, B once per M-block
        n_m, n_n = self.M // bm, self.N // bn
        hbm = (self.M * self.K * n_n * ib + self.K * self.N * n_m * ib
               + self.M * self.N * ab)
        mm, mn = arch.mma_shape
        return Candidate(
            {"block_M": bm, "block_N": bn, "block_K": bk},
            2.0 * self.M * self.N * self.K, hbm,
            smem_bytes=2 * (bm * bk + bk * bn) * ib,
            acc_bytes=bm * bn * 4, n_tiles=n_m * n_n * (self.K // bk),
            utilization=min(bm / mm, 1.0) * min(bn / mn, 1.0))

    def candidates(self) -> List[Candidate]:
        """Every block of the space that divides M, N and K."""
        kmin = max(BLOCK_K[0], (self.arch or auto_arch()).mma_k(
            self.in_dtype))
        return [self.candidate(bm, bn, bk)
                for bm in _tile_candidates(self.M, *BLOCK_MN)
                for bn in _tile_candidates(self.N, *BLOCK_MN)
                for bk in _tile_candidates(self.K, kmin, BLOCK_K[1])
                if self.M % bm == 0 and self.N % bn == 0
                and self.K % bk == 0]

    def hints(self, topk: int = 10) -> List[Hint]:
        arch = self.arch or auto_arch()
        return DefaultPolicy(arch, arch.peak_class(self.in_dtype)).rank(
            self.candidates(), topk)


def recommend_hints(template, topk: int = 10) -> List[Hint]:
    return template.hints(topk)


def proposable_blocks(arch: HopperArch, dtype) -> FrozenSet[
        Tuple[int, int, int]]:
    """Every (bm, bn, bk) ``MatmulTemplate`` can propose on ``arch`` for
    ``dtype`` operands (at a shape every block of the space divides)."""
    side = BLOCK_MN[1] * BLOCK_K[1]
    t = MatmulTemplate(side, side, side, str(dtype).replace("torch.", ""),
                       arch=arch)
    return frozenset((h.config["block_M"], h.config["block_N"],
                      h.config["block_K"])
                     for h in t.hints(topk=len(t.candidates())))


# the blocks the H100 template proposes for any of the yardstick's input
# types: the kernel's instances
KERNEL_BLOCKS = frozenset().union(*(
    proposable_blocks(H100_SXM, dt)
    for dt in ("float32", "bfloat16", "float16", "float8_e4m3fn")))
