"""Ported ops. Each kernel's wrapper launches its CUDA kernel on a CUDA
tensor and runs its plain PyTorch version on a CPU tensor."""

from .dequant_gemm import (dequant_gemm_kernel,  # noqa: F401
                           dequant_matmul, dequant_matmul_twopass,
                           quantize_w4_per_channel, w4a8_matmul)
from .flash_decoding import (decode_partials,  # noqa: F401
                             decode_partials_plain, flash_decode,
                             flash_decode_paged, flash_decode_paged_pool,
                             pages_to_hmajor, paged_decode_partials,
                             paged_decode_partials_plain)
from .gemm import matmul, matmul_kernel  # noqa: F401
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
           "varlen_grouped_matmul_reference", "matmul", "matmul_kernel",
           "dequant_matmul", "dequant_gemm_kernel", "dequant_matmul_twopass",
           "w4a8_matmul", "quantize_w4_per_channel"]
