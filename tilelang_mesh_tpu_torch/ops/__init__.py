"""Ported ops. Each kernel's wrapper launches its CUDA kernel on a CUDA
tensor and runs its plain PyTorch version on a CPU tensor."""

from .attention_sink import (attention_sink,  # noqa: F401
                             attention_sink_reference, sink_fwd,
                             sink_fwd_kernel, sink_fwd_plain)
from .bitnet import (bitnet_gemm, bitnet_gemm_kernel,  # noqa: F401
                     bitnet_gemm_plain, bitnet_linear,
                     bitnet_linear_reference)
from .blocksparse_attention import (blocksparse_attention,  # noqa: F401
                                    blocksparse_mha, blocksparse_mha_kernel,
                                    blocksparse_mha_plain,
                                    blocksparse_reference)
from .dequant_gemm import (dequant_gemm_kernel,  # noqa: F401
                           dequant_matmul, dequant_matmul_twopass,
                           quantize_w4_per_channel, w4a8_matmul)
from .dsa import (lightning_indexer,  # noqa: F401
                  lightning_indexer_kernel, make_sparse_mla,
                  sparse_mla_fwd, sparse_mla_fwd_kernel,
                  sparse_mla_reference, topk_selector, topk_selector_kernel)
from .flash_attention import (flash_attention,  # noqa: F401
                              flash_attention_partial, mha_fwd_kernel)
from .flash_attention_bwd import flash_attention_bwd  # noqa: F401
from .flash_attention_varlen import (flash_attention_varlen,  # noqa: F401
                                     varlen_bwd_dkdv_kernel,
                                     varlen_bwd_dq_kernel,
                                     varlen_fwd_kernel)
from .flash_decoding import (decode_partials,  # noqa: F401
                             decode_partials_plain, flash_decode,
                             flash_decode_paged, flash_decode_paged_pool,
                             pages_to_hmajor, paged_decode_partials,
                             paged_decode_partials_plain)
from .gdn import (gdn_chunk_fwd, gdn_chunk_fwd_tl,  # noqa: F401
                  gdn_chunk_fwd_tl_plain, gdn_reference)
from .gemm import matmul, matmul_kernel  # noqa: F401
from .gqa import (gqa_attention, gqa_fwd, gqa_fwd_kernel,  # noqa: F401
                  gqa_fwd_partial, gqa_fwd_partial_kernel,
                  gqa_fwd_partial_plain, gqa_fwd_plain)
from .gemm_variants import (blocksparse_gemm_kernel,  # noqa: F401
                            blocksparse_matmul, gemv, gemv_kernel,
                            matmul_splitk, matmul_streamk, splitk_kernel,
                            streamk_kernel)
from .grouped_gemm import (grouped_gemm_kernel,  # noqa: F401
                           grouped_matmul, grouped_matmul_plain,
                           varlen_grouped_matmul,
                           varlen_grouped_matmul_plain,
                           varlen_grouped_matmul_reference)
from .linear_attention import (linear_attention,  # noqa: F401
                               linear_attention_plain,
                               linear_attention_reference, retention,
                               retention_plain, retention_reference)
from .mamba2 import (mamba2_chunk_scan,  # noqa: F401
                     mamba2_chunk_scan_plain, mamba2_chunk_scan_torch,
                     mamba2_reference)
from .minference import (vertical_slash_sparse_attention,  # noqa: F401
                         vs_sparse, vs_sparse_kernel, vs_sparse_plain,
                         vs_sparse_reference)
from .mla import (mla_decode, mla_decode_partials,  # noqa: F401
                  mla_decode_partials_plain, mla_decode_reference)
from .nsa import (nsa_attention, nsa_attention_varlen,  # noqa: F401
                  nsa_decode, nsa_decode_kernel, nsa_fwd_kernel,
                  nsa_fwd_partial_kernel, nsa_reference,
                  nsa_varlen_fwd_kernel)
from .quantize_act import (quantize_act_int8,  # noqa: F401
                           quantize_act_int8_plain)
from .seer_attention import (seer_attention, seer_block_mask,  # noqa: F401
                             seer_reference)
from .softmax import softmax, softmax_kernel, softmax_plain  # noqa: F401

__all__ = ["flash_attention", "flash_attention_partial", "mha_fwd_kernel",
           "flash_attention_bwd", "decode_partials",
           "decode_partials_plain", "flash_decode",
           "flash_decode_paged", "flash_decode_paged_pool",
           "pages_to_hmajor", "paged_decode_partials",
           "paged_decode_partials_plain", "mla_decode",
           "mla_decode_partials", "mla_decode_partials_plain",
           "mla_decode_reference", "grouped_matmul", "grouped_matmul_plain",
           "varlen_grouped_matmul", "varlen_grouped_matmul_plain",
           "varlen_grouped_matmul_reference", "grouped_gemm_kernel",
           "matmul", "matmul_kernel",
           "matmul_splitk", "splitk_kernel", "matmul_streamk",
           "streamk_kernel", "gemv", "gemv_kernel", "blocksparse_matmul",
           "blocksparse_gemm_kernel",
           "dequant_matmul", "dequant_gemm_kernel", "dequant_matmul_twopass",
           "w4a8_matmul", "quantize_w4_per_channel", "mamba2_chunk_scan",
           "mamba2_chunk_scan_plain", "mamba2_chunk_scan_torch",
           "mamba2_reference", "gdn_chunk_fwd_tl", "gdn_chunk_fwd_tl_plain",
           "gdn_chunk_fwd", "gdn_reference", "linear_attention",
           "linear_attention_plain", "linear_attention_reference",
           "retention", "retention_plain", "retention_reference",
           "bitnet_gemm", "bitnet_gemm_kernel", "bitnet_gemm_plain",
           "bitnet_linear", "bitnet_linear_reference", "gqa_attention",
           "gqa_fwd", "gqa_fwd_kernel", "gqa_fwd_partial",
           "gqa_fwd_partial_kernel", "gqa_fwd_partial_plain",
           "gqa_fwd_plain", "quantize_act_int8", "quantize_act_int8_plain",
           "flash_attention_varlen", "varlen_fwd_kernel",
           "varlen_bwd_dkdv_kernel", "varlen_bwd_dq_kernel",
           "attention_sink", "attention_sink_reference", "sink_fwd",
           "sink_fwd_kernel", "sink_fwd_plain", "softmax", "softmax_kernel",
           "softmax_plain", "blocksparse_attention", "blocksparse_mha",
           "blocksparse_mha_kernel", "blocksparse_mha_plain",
           "blocksparse_reference", "seer_attention", "seer_block_mask",
           "seer_reference",
           "vertical_slash_sparse_attention", "vs_sparse", "vs_sparse_kernel",
           "vs_sparse_plain", "vs_sparse_reference", "nsa_attention",
           "nsa_attention_varlen", "nsa_decode", "nsa_decode_kernel",
           "nsa_fwd_kernel", "nsa_fwd_partial_kernel", "nsa_reference",
           "nsa_varlen_fwd_kernel", "lightning_indexer",
           "lightning_indexer_kernel", "topk_selector",
           "topk_selector_kernel", "sparse_mla_fwd", "sparse_mla_fwd_kernel",
           "sparse_mla_reference", "make_sparse_mla"]
