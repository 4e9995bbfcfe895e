"""tilelang_mesh_tpu_torch — the PyTorch/CUDA port of tilelang_mesh_tpu.

The JAX package (``tilelang_mesh_tpu``) is the reference; this package
runs the same system on one NVIDIA Hopper card, with each TPU kernel on
a ported path replaced by a CUDA kernel written for ``sm_90a``
(``csrc/``, built at first use by ``ops/_build.py``). It imports neither
JAX nor the JAX package.

Ported so far: the paged-KV serving engine (``serving/``) over the
paged-decode kernel (``ops/flash_decoding.py``), with the resilience
and observability modules it uses; the flagship transformer
(``models/``, ``entry.py``), its forward and single-device training
step, over the attention kernels (``ops/flash_attention.py``,
``ops/gqa_bwd.py``); DeepSeek-MLA decode serving (``ops/mla.py``);
the expert-parallel MoE layer and ring attention on
``torch.distributed`` (``parallel/``) over the grouped GEMM kernels
(``ops/grouped_gemm.py``); the GEMM entry points, sequence mixing and
the GEMM variants; BitNet b1.58's BitLinear and FFN block
(``ops/bitnet.py``, ``models/bitnet.py``) over the int8 activation
quantiser and the int8 x ternary GEMM, and grouped-query attention
(``ops/gqa.py``). Entry points run on the card unless the caller
passes ``device="cpu"``.
"""

__version__ = "0.1.0"
