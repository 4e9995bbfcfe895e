"""Ported ops. Each kernel's wrapper launches its CUDA kernel on a CUDA
tensor and runs its plain PyTorch version on a CPU tensor."""

from .flash_decoding import (decode_partials,  # noqa: F401
                             decode_partials_plain, flash_decode,
                             flash_decode_paged, flash_decode_paged_pool,
                             pages_to_hmajor, paged_decode_partials,
                             paged_decode_partials_plain)
from .grouped_gemm import (grouped_matmul,  # noqa: F401
                           grouped_matmul_plain, varlen_grouped_matmul,
                           varlen_grouped_matmul_plain,
                           varlen_grouped_matmul_reference)
from .mla import (mla_decode, mla_decode_partials,  # noqa: F401
                  mla_decode_partials_plain, mla_decode_reference)

__all__ = ["decode_partials", "decode_partials_plain", "flash_decode",
           "flash_decode_paged", "flash_decode_paged_pool",
           "pages_to_hmajor", "paged_decode_partials",
           "paged_decode_partials_plain", "mla_decode",
           "mla_decode_partials", "mla_decode_partials_plain",
           "mla_decode_reference", "grouped_matmul", "grouped_matmul_plain",
           "varlen_grouped_matmul", "varlen_grouped_matmul_plain",
           "varlen_grouped_matmul_reference"]
