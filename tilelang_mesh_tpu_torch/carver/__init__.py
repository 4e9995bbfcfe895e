"""Tile-config recommender for the card (counterpart of
``tilelang_mesh_tpu/carver``): the H100 model and the GEMM template.
The JAX package's other templates (flash attention, conv2d, GEMV,
elementwise, reduction) and ``node.py``, which reads the DSL's IR, are
not ported yet."""

from .arch import H100_SXM, HopperArch, auto_arch, dtype_bytes
from .roller import (KERNEL_BLOCKS, Candidate, DefaultPolicy, Hint,
                     MatmulTemplate, proposable_blocks, recommend_hints)

__all__ = ["HopperArch", "H100_SXM", "auto_arch", "dtype_bytes",
           "MatmulTemplate", "DefaultPolicy", "Candidate", "Hint",
           "recommend_hints", "KERNEL_BLOCKS", "proposable_blocks"]
