"""What bounds a tile on the card, for the tile-config recommender.

Counterpart of ``tilelang_mesh_tpu/carver/arch.py``, whose ``TPUArch``
models a TPU core. Here the model is one Hopper card: a block's tile is
bounded by the shared memory it can opt into and by the registers that
hold its accumulator, its products run on ``mma.sync`` tiles, and the
roofline reads the card's peak by operand class and its HBM rate.

Numbers of ``H100_SXM`` are the NVIDIA H100 SXM datasheet's (dense
tensor-core rates, no sparsity, at the card's 700 W power limit) and the
CUDA programming guide's limits for compute capability 9.0; none is a
measurement. A card set below 700 W runs slower than these peaks.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

__all__ = ["HopperArch", "H100_SXM", "auto_arch", "dtype_bytes"]

_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2,
                "float8_e4m3fn": 1, "int8": 1}


def dtype_bytes(dtype) -> int:
    """Bytes of one element of ``dtype`` (a name, or a torch dtype)."""
    name = str(dtype).replace("torch.", "")
    if name not in _DTYPE_BYTES:
        raise TypeError(f"no tile model for dtype {dtype!r} (have "
                        f"{sorted(_DTYPE_BYTES)})")
    return _DTYPE_BYTES[name]


@dataclass(frozen=True)
class HopperArch:
    name: str
    sm_count: int
    # shared memory one block can opt into (cudaFuncAttribute-
    # MaxDynamicSharedMemorySize), of the SM's 256 KB shared with L1
    smem_per_block: int
    regs_per_sm: int                      # 32-bit registers
    # mma.sync tile (m, n); its k is ``mma_k(dtype)``
    mma_shape: Tuple[int, int]
    hbm_gbps: float
    # dense peak TFLOP/s by operand class: "bf16" (bf16 and f16 on the
    # tensor cores), "f32" (FFMA on the CUDA cores, no TF32), "i8"
    # (int8 and fp8 on the tensor cores, as bench.py files fp8)
    peak_tflops: Dict[str, float] = field(default_factory=dict)
    # a k-step of one block (its barrier and the start of the next
    # stage's copies, ~500 cycles at the 1980 MHz boost clock) over the
    # sm_count blocks that run at once: a model constant that breaks
    # ties toward fewer steps, not a measurement
    step_overhead_s: float = 0.0

    def mma_k(self, dtype) -> int:
        """Depth of one ``mma.sync`` for ``dtype`` operands: 16 for
        16-bit types, 32 for 8-bit ones (m16n8k32); float32 runs FFMA,
        one k at a time."""
        b = dtype_bytes(dtype)
        return {2: 16, 1: 32}.get(b, 1)

    def min_tile(self, dtype) -> Tuple[int, int, int]:
        """The smallest (m, n, k) tile a block computes in ``dtype``:
        one ``mma.sync``."""
        return (*self.mma_shape, self.mma_k(dtype))

    def peak_class(self, dtype) -> str:
        """The ``peak_tflops`` key of products of ``dtype`` operands."""
        return {4: "f32", 2: "bf16", 1: "i8"}[dtype_bytes(dtype)]

    def acc_budget_bytes(self) -> int:
        """Register bytes a block's float32 accumulator may take: half
        the SM's register file (the rest holds operand fragments and
        addresses), so one block of 256 threads keeps it at 128
        registers a thread."""
        return self.regs_per_sm * 4 // 2


# NVIDIA H100 SXM5 80 GB: 132 SMs, 227 KB opt-in shared memory a block,
# 64 K registers an SM, HBM3 3.35 TB/s; 989 TFLOP/s
# bf16 / fp16, 67 TFLOP/s float32 (CUDA cores), 1979 TFLOP/s fp8 and
# 1979 TOP/s int8 (datasheet, dense, 700 W)
H100_SXM = HopperArch(
    "h100_sxm", sm_count=132, smem_per_block=232448, regs_per_sm=65536,
    mma_shape=(16, 8), hbm_gbps=3350.0,
    peak_tflops={"bf16": 989.0, "f32": 67.0, "i8": 1979.0},
    step_overhead_s=500 / 1.98e9 / 132)

# torch.cuda.get_device_name of the SXM part ("NVIDIA H100 80GB HBM3");
# the PCIe and NVL parts have other clocks and rates and no model here
_BY_NAME = {"h100 80gb hbm3": H100_SXM, "h100 sxm": H100_SXM}


def auto_arch(device: Optional[object] = None) -> HopperArch:
    """The model of the card ``device`` (default: the current CUDA
    device), by ``torch.cuda.get_device_name``. Raises on a machine
    without a card or on a card it has no model of: a default would
    hide which device the numbers are for."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("auto_arch: no CUDA device; pass an arch "
                           "(carver.H100_SXM) explicitly")
    name = torch.cuda.get_device_name(device).lower()
    for key, arch in _BY_NAME.items():
        if key in name:
            return arch
    raise RuntimeError(f"auto_arch: no model of {name!r} (have "
                       f"{sorted(_BY_NAME)})")
