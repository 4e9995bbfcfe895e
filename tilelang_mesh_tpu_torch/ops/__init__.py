"""Ported ops. Each kernel's wrapper launches its CUDA kernel on a CUDA
tensor and runs its plain PyTorch version on a CPU tensor."""

from .flash_decoding import (flash_decode_paged_pool,  # noqa: F401
                             paged_decode_partials,
                             paged_decode_partials_plain)

__all__ = ["flash_decode_paged_pool", "paged_decode_partials",
           "paged_decode_partials_plain"]
