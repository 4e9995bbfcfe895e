#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device   — the card's name and power limit (nvidia-smi);
2. build    — nvcc builds every kernel of the port from csrc/ (sm_90a)
              into build/cuda/, one nvcc per source, all at once, and
              prints each source's registers and spills;
3. kernels  — each kernel against its plain PyTorch version on the card
              in float32 and bfloat16, with its time, the plain
              version's, a PyTorch library call's on the same inputs, and
              the bound: paged decode at the serving path's shapes
              (LLaMA-2-7B attention: H=32, D=128, page 128, 8192-token
              windows, batch 8, 8 splits); the contiguous decode kernel at
              the same shape, and the two paged strategies end to end
              there (the in-kernel walk against gather + contiguous
              decode, in turns); MLA decode at DeepSeek-V3's attention
              widths (H=128, dc=512, dr=64; B=4, S=4096, 1/2/4/8 splits,
              and S=8192, 8 splits); the four attention kernels at the
              model's (H=16, D=128, S=4096, causal; batch 2 for the
              forward kernel, 4 for the training kernels), and each once
              more at D=16 on a ragged S=1000; the dense grouped GEMM at
              the MoE layer's two expert products (Mixtral-8x7B widths,
              see MOE_FULL) and the token-sorted one on that batch's
              routed per-expert counts, both layouts of B, in float32
              (3xTF32), bfloat16 and float16 (TMA + wgmma), each call's
              path and block reported, and both once more at K = d - 1
              on the block tile loop (rows off 16 bytes);
4. model    — the first main path, the flagship transformer at the
              published widths of Ouro-2.6B (see FULL): the entry's
              forward on 2 x 4096 tokens without autograd (the forward
              kernel, once per layer; logits against the dense plain
              path on the same weights), then three AdamW steps on
              4 x 4097 tokens (the partial forward and both backward
              kernels, once per layer and step; step 1's loss and one
              layer's wq / wo gradients against the plain path), then one
              more forward and step under torch.profiler (the device's
              busy share, device time by kind);
5. serving  — the second main path: a ServingEngine over a 1024-page float32
              pool (4 GiB on the card) answers two waves of four
              requests (8192- and 2048-token prompts, 16 greedy tokens
              each; two wave-2 requests reuse a wave-1 prompt). Every
              outcome must be ``result``, no page may leak, the prefix
              cache must hit, the kernel's launches must equal the
              workload's dispatches, and one step's output must agree
              with the plain version recomputed on a copy of the pool;
6. mla      — the third main path: the same engine over MLADecodeWorkload
              at DeepSeek-V3's attention widths (see MLA_SERVE), the same
              two waves and the same gates, on the MLA kernel;
7. moe      — the fourth main path: the expert-parallel MoE layer
              (make_moe_layer, one rank) at Mixtral-8x7B's expert widths
              (see MOE_FULL) on 4096 tokens: two launches of the 3xTF32
              grouped GEMM a call, the output and the kept-token count
              against the same layer with the plain grouped GEMM, the
              forward's median time, peak memory, and one call under
              torch.profiler; then the layer in bfloat16 (two launches of
              the TMA grouped GEMM a call) against the same layer on the
              plain GEMMs in bfloat16, and its median time;
8. ring     — the fifth main path: ring attention (make_ring_attention,
              one rank) at the model's attention shapes (B=2, H=16,
              S=4096, D=128), causal and not: one partial-kernel launch a
              call, the output against the plain attention on the card;
9. gemm     — the sixth main path: the library's GEMM entry points at
              bench.py's shapes (see GEMM_OPS_TOL): matmul in bf16 at
              1024^3 and 8192 x 8192 x 4096, in f32 and bf16 at 4096^3
              in every transpose, once with ReLU, fp8 e4m3 -> f32, f16
              and int8 -> int32 (accum_dtype int32) at 4096^3;
              dequant_matmul (w4a16) in bf16 and f16 at 4096^3 (group
              size 512, with dequant_matmul_twopass in bf16) and at a
              LLaMA-2-7B MLP decode step (M 16, K 4096, N 11008, group
              128), there in f32 too; w4a8_matmul at 4096^3 and at a
              16-token decode step (the TMA kernel of ops/dequant_gemm.py
              ::w4a8_path) and at N 4104 (off 16 bytes: the tile loop).
              Each call
              the launches its stated rule names, read right after:
              matmul's kernel is the one ops/gemm.py::matmul_path names,
              and every bf16, f16 and fp8 shape takes the TMA path (fp8
              with one fp8_widen, also held bit-equal to its plain
              version and timed); dequant_matmul's the kernel(s) of
              ops/dequant_gemm.py::dequant_path (TMA + wgmma at 4096^3,
              the split-K and its combine at the decode step, the tile
              loop in f32); two-pass one unpack, one matmul; its output
              against the plain version on the card; kernel, plain and
              library times and the bound;
10. seqmix  — the seventh main path: the sequence-mixing entry points at
              bench.py's widths (see MAMBA2, GDN, LINATTN):
              mamba2_chunk_scan (Mamba2-2.7B's SSD widths, chunks 128 and
              256 in bf16, 128 in f32) and gdn_chunk_fwd_tl (chunks 64 and
              128 in bf16 and f32: its two kernels, gdn_chunk_wy and
              gdn_chunk_state, each also held and timed alone against its
              plain stage), each also against the sequential recurrence
              by bench's own check; linear_attention and retention in f32
              and bf16; linear attention's kernel backward (one forward
              and three backward launches, its gradients against autograd
              through the dense reference at a reduced S). Each call one
              launch of its kernel, read right after; its output against
              the plain version on the card; kernel, plain and the eager
              chunk-parallel port's times and the bound;
11. gemm_variants — the eighth main path: the GEMM scheduling variants at
              LLaMA-2-7B's MLP and head widths (see LLAMA2): split-K at a
              16-token decode step's gate/up (bf16 and f32) and down
              products (the few-row path splitk_stream and its combine,
              two calls bit-equal) and past its rows at a 128-token
              chunk's gate/up (the tile loop splitk_gemm and
              splitk_reduce), stream-K at a 512-token prefill chunk's
              gate/up at streamk_phase_programs' count (the tile rows in
              phase, up to the blocks the card holds at once): bf16 at
              128 x 128 and 128 x 256 on the TMA kernel streamk_tma, f32
              and bf16 with A's base off 16 bytes on the tile loop
              streamk_gemm, as ops/gemm_variants.py::streamk_path names,
              each with its programs, segments and partial bytes; GEMV at a
              single token's gate/up (bf16, f32) and LM head, block-sparse
              at a 4096-token prefill's gate/up under a random half-dense
              128 x 128 cell mask. Each call's launches (the split-K and
              stream-K sums named) read right after; its output against
              the plain version on the card; block-sparse dead cells
              exactly 0 and an all-ones mask against matmul; kernel,
              plain, library and matmul times and the bound.
12. bitnet_gqa — the ninth main path: BitNet b1.58-2B-4T's FFN block and
              grouped-query attention (see BITNET): the BitFFN on a
              4096-token prefill and a decode step (three launches a
              call of the kernel ops/bitnet.py::bitnet_path names:
              bitnet_gemm_wgmma at the prefill, bitnet_gemm_splitk at
              the decode step; equal to the module's reference mode on
              the card, the forward's median time), quantize_act_int8 on
              the FFN's input and hidden activation (one launch each,
              the plain version's bytes, a zero row), gqa_attention at 20
              query over 5 KV heads, S 4096, causal, f32 and bf16 (one
              gqa_fwd launch without autograd; one partial, one dK/dV,
              one dQ with it; output and gradients against the plain
              versions); then bitnet_gemm at the FFN's three products
              and at the decode product on a misaligned copy of its
              activations (the block tile loop, which the FFN's aligned
              shapes no longer reach), each kernel's time, its plain
              version's, a library call's and the bound.
13. varlen  — the tenth main path: packed varlen attention at BitNet
              b1.58-2B-4T's attention widths (see VARLEN): a 16384-token
              pack of whole documents, causal, f32, bf16 and f16 (one
              varlen_fwd without autograd; one varlen_fwd_partial, one
              dK/dV and one dQ with it, on tensor cores in 16 bits: each
              record names its kernel; output and gradients against the
              plain versions; one document's gradient exactly 0 outside
              it), and a chunked-prefill step of 8 x 512 queries over
              ragged keys, bottom-right, bf16 (one varlen_fwd). Each
              kernel against its plain version at the path's shapes, the
              pad tail exactly 0 in O and l; kernel, plain and SDPA (bool
              document mask; bf16 enable_gqa, f32 the memory-efficient
              kernel on KV expanded by the group) times and the bound by
              the documents' visible pairs.
14. attention_family — the eleventh main path: attention with sinks at
              gpt-oss-20b's attention widths (see GPT_OSS: 64 query over 8
              KV heads of 64, S 4096, f32, bf16 and f16; f32 on CUDA
              cores, bf16 and f16 on the tensor-core kernel at its tile):
              attention_sink at full causal and at the 128-token window
              (one attention_sink launch each; the windowed time printed
              beside the full one and gated under a fifth of it; two
              calls bit-equal; the key tiles a block visits counted at
              each type's tile), and (f32, bf16) its training step
              (backward="kernel": one GQA partial, one dK/dV, one dQ; the
              output and dQ, dK, dV, dSinks against the plain versions
              and against autograd through the dense reference);
              the row softmax at the vocabulary row (4096 f32 and 1024
              bf16 rows of 201088 -> f32) and the MoE router's width
              (4096 x 8), one launch each, rows summing to 1;
              block-sparse attention at LLaMA-2-7B's widths (see
              SPARSE_ATTN: 32 heads of 128, S 4096, blocks 128, a random
              mask of density 0.5) and seer attention (top-8 gates,
              causal), f32 on CUDA cores, bf16 and f16 on the tensor
              cores, one blocksparse_mha launch each (16-bit: the tile,
              its live tiles' pairs at the peak beside the bound); a row
              of dead cells exactly 0, an all-ones causal mask equal to
              plain causal attention, in each type. Each against its
              plain version; kernel,
              plain, library (torch.softmax; SDPA over the dense bool
              mask; for the sink, SDPA with a zero sink key and the sink
              logits in an additive mask, and SDPA without sinks as
              context, named apart) times and the bound.
15. sparse_inference — the twelfth main path: sparse-attention
              inference. vertical_slash_sparse_attention at LLaMA-3-8B-
              Instruct-262k's attention widths (see MINFERENCE: 32 heads
              of 128, K and V repeated from 8 KV heads, S 16384, blocks
              64, 1000 columns and 6096 slashes picked by a copy of the
              example's estimator from the last 32 queries), f32 on
              CUDA cores, bf16 and f16 on the tensor cores (the tile,
              its live tiles' pairs at the peak beside the bound);
              nsa_attention (prefill, T 8192, selected blocks
              and the 512-token window), nsa_attention_varlen (the same
              widths over seeded documents summing to 8192 tokens) and
              nsa_decode (B 8, 65536 keys) at the NSA paper's widths (see
              NSA: 64 query heads in 4 groups of 16, D 128, blocks of 64,
              16 selected), f32 and bf16. Each call one launch of its
              kernel (decode: its split kernel and the splits' combine
              nsa_decode_combine), read right after; each output against
              its plain version on the card (decode also against the
              plain version of its own split); a row that sees nothing
              exactly 0; kernel, plain and library (SDPA over the dense
              bool masks; for NSA decode over the blocks gathered
              outside the timed call, and with the gather inside it)
              times and the bound by the visible pairs.
16. nsa_training — the thirteenth main path: NSA training at the NSA
              paper's widths (see NSA, window 0): nsa_attention(
              backward="kernel") forward and backward under autograd, T
              8192, f32 and bf16 (one nsa_fwd_partial, one nsa_bwd_dkdv
              and its fixed-order sum nsa_bwd_dkdv_sum, one nsa_bwd_dq a
              step); the output against the fused inference kernel, dQ,
              dK, dV, dG against the same step on the plain versions on
              the card and against autograd through the dense graph at T
              2048 (printed); a second step's gradients bit-equal; each
              kernel against its plain version at the path's shapes;
              kernel, plain and library (SDPA over the dense selected
              bool mask: its forward, its backward, both) times and the
              bound by the selected pairs.
17. dsa     — the fourteenth main path: DeepSeek-V3.2 sparse attention at
              DeepSeek-V3.2-Exp's attention widths (see DSA: 128 heads,
              latent 512, rope 64, indexer 64 heads of 128, top-2048; a
              4096-query chunk over an 8192-token cache), f32 and bf16:
              lightning_indexer -> topk_selector -> sparse_mla_fwd, one
              launch each; each kernel against its plain version on the
              same inputs (ids equal, -inf exactly), the kernel chain's O
              against the plain chain's (rows that select the same set;
              near-ties on the others), a dead row and a ragged shape;
              kernel, plain and library (none; torch.topk; SDPA over the
              dense selected mask) times and the bound; then the sparse
              fine-tuning step (make_sparse_mla, S 1024 over 4096): dq and
              dkv against autograd through the dense reference, three
              Adam steps whose loss falls, the step's time.
18. headline — the fifteenth main path: bench.py's headline
              comparison as the port runs it (tilelang_mesh_tpu_torch.
              bench): gemm_quickstart (1024^3), gemm_large (8192 x 8192 x
              4096), flash_d64, flash_d128 and flash_d128_full (bf16,
              B 2, H 16, S 2048; mha_fwd_kernel at the carver's best
              tile against SDPA), fp8_gemm (4096^3), mla_decode (B 4, H
              128, S 4096, dc 512, dr 64: the best of four split
              candidates against the torch reference), moe_grouped (E 8,
              512 x 2048 x 2048, bf16: grouped_matmul at the best of the
              carver's top three blocks and the Hopper set, against
              torch.bmm), paged_decode (B
              4, H 32, S 8192, D 128, pages of 128: the page walk and
              the gather each timed, the faster against the torch
              gather + softmax, KV GB/s), mamba2_chunk (B 8, S 4096, H
              80, P 64, N 128: mamba2_chunk_scan at chunks 128 and 256
              against the eager chunk-parallel port), gdn_fwd (B 8, H 16,
              T 4096, K = V = 128: gdn_chunk_fwd_tl at chunks 64 and 128
              against the eager chunk-parallel WY form), w4a8_gemm
              (4096^3) and w4a16_gemm (4096^3, group 512) through
              run_config at a 0.1 s loop target (bench's own is 0.6 s),
              each record printed, then the headline geomean line, the
              geomeans of the twelve configs without gdn_fwd, of the
              eight without the decode ones, moe_grouped, mamba2_chunk
              and gdn_fwd, of the ten without the last three, of the
              eleven without mamba2_chunk and gdn_fwd and of the five
              GEMM configs; the two yardsticks', mha_fwd's,
              mla_decode's, both decode strategies', the TMA grouped
              GEMM's, mamba2_chunk_scan's, the two GDN kernels' and the
              TMA w4a8 kernel's launches counted over the thirteen
              configs (a CUDA graph's
              where it is captured), every GEMM of them on #15's TMA
              path (moe_grouped's on the TMA grouped kernel). Then the
              GEMM yardstick (hand_matmul) in bf16 -> bf16 at 8192 x 8192
              x 4096 and fp8 -> f32 at 4096^3, and the w4a16 yardstick
              (hand_w4a16) at 4096^3, group 512, each at the carver's two
              top blocks, against their plain versions on the same inputs
              (normwise: f32 1e-5, bf16 1e-2); kernel, plain and library
              (torch.matmul; torch._scaled_mm with unit scales;
              torch.matmul on the dequantised weight) times and the
              bound.

The peak device memory printed at the end is the script's: each phase
that reads its own peak adds it to the script's before zeroing the
counter. Prints a ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``. Without a card it exits non-zero and
prints no result.
"""

import contextlib
import importlib
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()

# the serving path's geometry (bench.py cfg_paged_decode's decode shape)
H, D, PS = 32, 128, 128
B, PP, N_SPLIT = 8, 64, 8            # 8192-token windows
N_PAGES = 1024
PEAK_BYTES_S = 3.35e12               # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12               # H100 SXM, f32 outside tensor cores
PEAK_BF16_FLOPS = 989e12             # H100 SXM, bf16 tensor cores, dense
PEAK_TF32_FLOPS = 495e12             # H100 SXM, tf32 tensor cores, dense
PEAK_8BIT_OPS = 1979e12              # H100 SXM, fp8 / int8 tensor cores
# kernel vs plain: the same f32 arithmetic in another order
RTOL = ATOL = 1e-4

# MLA decode at DeepSeek-V3's attention widths
# (https://huggingface.co/deepseek-ai/DeepSeek-V3/blob/main/config.json:
# num_attention_heads 128, kv_lora_rank 512, qk_rope_head_dim 64), at
# bench.py:1495's shape (cfg_mla_decode: B=4, S=4096)
MLA_H, MLA_DC, MLA_DR = 128, 512, 64
MLA_B, MLA_S = 4, 4096
# MLA kernel vs plain, normwise: float32 the same arithmetic in another
# order; bfloat16 both round p to bf16 before p @ ckv, and a 1e-7
# difference at a rounding boundary flips one bf16 ulp
MLA_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# The MLA serving phase: MLADecodeWorkload at those widths over a
# latent-major float32 pool of 1024 pages of 128 tokens (one [ckv | kpe]
# row of 576 floats per token). Departures, so this is not DeepSeek-V3:
# sm_scale is the workload's default 1/sqrt(576) (DeepSeek scales by
# 1/sqrt(192) with a YaRN factor); queries and latent rows are the
# workload's seeded draws (the JAX workload has no weights); the pool is
# float32, the JAX default (DeepSeek serves bf16); one attention op a
# step, not 61 layers.
MLA_SERVE = dict(heads=MLA_H, latent_dim=MLA_DC, rope_dim=MLA_DR,
                 n_pages=1024, page_size=128, batch_buckets=(1, 2, 4),
                 page_buckets=(16, 32, 64))

# The repo's architecture (LLaMA-style dense MHA decoder: pre-RMSNorm with
# eps 1e-6, half-split RoPE, SwiGLU, tied embeddings) at the published
# widths of Ouro-2.6B
# (https://huggingface.co/ByteDance/Ouro-2.6B/blob/main/config.json):
# hidden 2048, 16 heads x 128, 16 KV heads, SwiGLU 5632, vocab 49152,
# rope_theta 1e6. Departures, so this is not Ouro: depth cut to 4 of its
# 48 layers, its 4 loop steps (total_ut_steps) not run (the block runs
# once), the head tied to the embedding (Ouro's is not); random weights
# from seed 0. float32, as the repo's model runs.
FULL = dict(vocab=49152, d_model=2048, n_layers=4, n_heads=16, d_ff=5632,
            max_seq=4096, dtype="float32", rope_theta=1e6, use_flash=True)
TRAIN_BATCH = 4
# attention kernel vs plain version, normwise: max |kernel - plain| <=
# tol * max |plain| per output. float32: the same arithmetic in another
# order. bfloat16: both round P (and dS) to bf16 before their products,
# but at a rounding boundary a 1e-7 difference in p flips one bf16 ulp
# (2**-8 relative), a few flips per row in 4096 keys.
ATTN_TOL = {"float32": 1e-5, "bfloat16": 2e-2, "float16": 2e-2}
# the sink training step against autograd through the dense reference
# (natural exp, float32 throughout, P not rounded), normwise: the CPU
# tests' tolerances for the same comparison
SINK_REF_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# the model path against the dense plain path on the same weights
# (float32 both; softmax in another form and order, 4 layers deep)
MODEL_TOL = {"logits": 1e-4, "loss": 1e-5, "grad": 1e-3}

# The repo's expert-parallel MoE layer (parallel/moe.py make_moe_layer,
# one rank: ep = 1 on one card) at the widths of Mixtral-8x7B's MoE layer
# (https://huggingface.co/mistralai/Mixtral-8x7B-v0.1/blob/main/config.json:
# hidden_size 4096, intermediate_size 14336, num_local_experts 8,
# num_experts_per_tok 2) on one 4096-token prefill chunk, capacity factor
# 1.25 (make_moe_layer's default: C = ceil(4096 * 2 * 1.25 / 8) = 1280),
# float32 as dryrun_multichip runs the layer, then again in bfloat16, as
# Mixtral serves (the float32 draws cast). Departures, so this is not
# Mixtral: the repo's expert is silu(x W1) W2, not SwiGLU with W3; the
# router is a softmax over all 8 experts, then top-2 without
# renormalising; capacity drops tokens; one layer of 32, no attention.
# Weights from seeded torch.Generators on the card: x ~ N(0, 1), the
# router N(0, 1/d), W1 N(0, 1/d), W2 N(0, 1/f) (unit-scale activations).
MOE_FULL = dict(tokens=4096, d=4096, f=14336, experts=8, top_k=2,
                capacity_factor=1.25)
# grouped GEMM vs plain, normwise: float32 the same sums in another
# order (or three TF32 passes); bfloat16 / float16 an output rounded to
# 16 bits may flip one ulp (2**-8 in bf16)
GEMM_TOL = {"float32": 1e-5, "bfloat16": 1e-2, "float16": 1e-2}
MOE_TOL = 1e-5          # the layer on the kernel vs on the plain GEMM
# the same in bfloat16: both round the expert products' outputs (and the
# hidden activation) to bf16, where a flipped ulp is 2**-8
MOE_BF16_TOL = 1e-2

# The library's GEMM entry points at bench.py's shapes (_config_builders,
# bench.py:2102-2134): gemm_quickstart 1024^3 and gemm_large 8192 x 8192
# x 4096 in bf16 (cfg_gemm, seed 0), fp8 e4m3 -> f32 at 4096^3
# (cfg_fp8_gemm, seed 2), w4a16 at 4096^3 with group size 512 (cfg_w4a16,
# seed 3), w4a8 at 4096^3 (cfg_w4a8, seed 9); inputs are the same seeded
# numpy draws (standard_normal * 0.1; w4a8's activations unscaled). The
# GEMM also in f32 at 4096^3 and in every transpose; and w4a16 at one
# decode step of LLaMA-2-7B's MLP (hidden 4096, intermediate 11008:
# huggingface.co/meta-llama/Llama-2-7b-hf/blob/main/config.json), 16
# tokens, group size 128, the skinny-M case the fused kernel is for.
# Kernel vs plain, normwise: a float32 output the same float32 sums in
# another order; bf16 one output ulp; the int4 unpack the same multiply
# and rounding (0); w4a8 exact int32 sums and the same epilogue.
GEMM_OPS_TOL = {"float32": 1e-5, "bfloat16": 1e-2, "float16": 1e-2,
                "int32": 0.0, "dequant_int4": 0.0, "w4a8": 1e-6}
LLAMA2_MLP = dict(M=16, K=4096, N=11008, gs=128)

# The GEMM variants at LLaMA-2-7B's widths (the config above: hidden 4096,
# intermediate 11008, vocab 32000): split-K at a 16-token decode step
# (gate/up K 4096 -> N 11008; down K 11008 -> N 4096, where the JAX
# split rule takes 2 of 8 asked splits), stream-K at a 512-token prefill
# chunk's gate/up (4 x 86 = 344 tiles), GEMV at one token's gate/up and
# LM head, block-sparse at a 4096-token prefill's gate/up with a
# 128 x 128 cell mask drawn as examples/blocksparse_gemm draws it (rng
# 0: a, b, then random() > 0.5). Draws standard_normal * 0.1, bf16 unless
# named; nothing cut. Kernel vs plain at GEMM_TOL's bounds.
LLAMA2 = dict(hidden=4096, inter=11008, vocab=32000, decode=16,
              prefill_chunk=512, prefill=4096, n_split=8)

# Sequence mixing at bench.py's widths (_config_builders, :2125-2127):
# mamba2_chunk (cfg_mamba2_chunk, :1616) at Mamba2-2.7B's SSD widths
# (huggingface.co/state-spaces/mamba2-2.7b/blob/main/config.json: d_model
# 2560, expand 2, head dim 64 -> 80 heads, d_state 128, one group), B 8,
# S 4096, chunks 128 and 256 in bf16 and 128 in f32; gdn_fwd (cfg_gdn_fwd,
# :1667) at B 8, H 16, T 4096, K = V = 128, chunks 64 and 128 (bench's
# candidates) in bf16 and f32; bench's seeded numpy draws, nothing cut.
# Linear attention and retention have no
# bench config: the GDN cell's widths, the JAX defaults' chunks (128, 64),
# draws standard_normal * 0.2 from default_rng(10), retention's decay
# 1 - 2^(-5 - 4 h / H) a head.
MAMBA2 = dict(B=8, S=4096, H=80, P=64, N=128)
GDN = dict(B=8, H=16, T=4096, K=128, V=128)
LINATTN = dict(B=8, H=16, S=4096, DK=128, DV=128, grad_S=1024)
# kernel vs plain, normwise: float32 the same arithmetic in another order;
# bf16 one flipped ulp (2**-8) at a rounding boundary
SEQ_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# against the sequential recurrence: bench.py's own rel_tol (:1651, :1680)
SEQ_REF_TOL = {"mamba2": 5e-2, "gdn": 6e-2}
# the kernel backward's gradients against autograd through the dense
# reference, float32 (the same sums in another order and grouping)
LA_GRAD_TOL = 1e-4


# BitNet b1.58 at the widths of BitNet b1.58-2B-4T
# (huggingface.co/microsoft/bitnet-b1.58-2B-4T/blob/main/config.json:
# hidden_size 2560, intermediate_size 6912, 20 attention heads over 5 KV
# heads of 128, hidden_act relu2, max_position_embeddings 4096). The JAX
# package has no BitNet transformer: its paths are the BitFFN block of
# examples/bitnet-1.58b (gate/up/down BitLinears, squared ReLU) and
# ops/gqa.py's gqa_attention, both taken here at those widths. Cut to one
# FFN block and one attention call of the model's 30 layers; the FFN's
# weights drawn as the example draws them (standard_normal / sqrt(fan_in)
# from default_rng(0), absmean-ternarised), its input standard_normal
# from default_rng(1): a 4096-token prefill and a one-token decode step.
# Attention at B 2, S 4096, causal, in f32 and bf16, q, k, v and the
# incoming gradient standard_normal from default_rng(2).
BITNET = dict(hidden=2560, inter=6912, heads=20, kv_heads=5, head_dim=128,
              seq=4096, attn_batch=2)

# Packed varlen attention (ops/flash_attention_varlen.py) at BitNet
# b1.58-2B-4T's attention widths (BITNET's source: 20 query heads over 5
# KV heads of 128, 4096 positions), one attention call of the model's 30
# layers, in the two ways users run it. A packed training batch: four
# 4096-token contexts make a 16384-token pack of whole documents, lengths
# default_rng(0).integers(64, 4097) drawn until the next would overflow
# the pack (the rows past the last document are pad); causal, top-left,
# f32, bf16 and f16: the forward without autograd, and a backward through
# it.
# A chunked-prefill step: 8 sequences, each a 512-token query chunk at
# the end of its keys, key lengths default_rng(1).integers(512, 4097);
# causal, bottom-right, bf16, forward only. q, k, v and the incoming
# gradient standard_normal from default_rng(3) (the pack) and
# default_rng(4) (the prefill step); the op has no weights.
VARLEN = dict(heads=20, kv_heads=5, head_dim=128, pack=16384, context=4096,
              min_doc=64, chunks=8, chunk=512)


# Attention with sinks (ops/attention_sink.py) at gpt-oss-20b's attention
# widths (https://huggingface.co/openai/gpt-oss-20b/blob/main/config.json:
# num_attention_heads 64, num_key_value_heads 8, head_dim 64,
# sliding_window 128, initial_context_length 4096, vocab_size 201088): one
# attention call of the model's 24 layers, which alternate a 128-token
# window and full causal attention, B 1, S 4096, f32 and bf16; the
# training step (backward="kernel") at full causal. q, k, v, the incoming
# gradient and the per-head sinks standard_normal from default_rng(5);
# the op has no weights. The row softmax (ops/softmax.py) at the
# vocabulary row: 4096 f32 rows -> f32, 1024 bf16 rows -> f32 (logits
# 4 * standard_normal from a seeded device generator), and at the MoE
# router's width (Mixtral-8x7B's 8 experts, 4096 tokens, as MOE_FULL).
GPT_OSS = dict(heads=64, kv_heads=8, head_dim=64, seq=4096, window=128,
               vocab=201088, vocab_rows=4096, vocab_rows_bf16=1024,
               router_rows=4096, router_width=8)
# Block-sparse and seer attention (ops/blocksparse_attention.py,
# ops/seer_attention.py) at LLaMA-2-7B's attention widths (LLAMA2's
# source: 32 heads of 128, 4096 positions), B 1, blocks of 128: a random
# mask of density 0.5 (default_rng(6).random(cells) < 0.5), not causal;
# seer's top-8 of default_rng(7).standard_normal gate logits, causal. q,
# k, v standard_normal from default_rng(8).
SPARSE_ATTN = dict(heads=32, head_dim=128, seq=4096, block=128,
                   density=0.5, topk=8)
# MInference vertical-slash attention at LLaMA-3-8B-Instruct-262k's
# attention widths (huggingface.co/gradientai/Llama-3-8B-Instruct-262k/
# blob/main/config.json: 32 query over 8 KV heads of 128), the model for
# which microsoft/MInference ships its vertical_and_slash patterns of
# 1000 columns and 6096 slashes; K and V repeated to the 32 query heads,
# as MInference does before its kernel. S is cut from 262144 to 16384 so
# that SDPA's dense bool mask (8.6 GB) fits beside the rest. q, k, v
# standard_normal from default_rng(11); the indices from the example's
# estimator (examples/minference/example_vertical_slash_sparse_attn.py)
# on the last 32 queries.
MINFERENCE = dict(heads=32, kv_heads=8, head_dim=128, seq=16384, block=64,
                  vertical=1000, slash=6096, last_q=32)
# NSA at the widths of the NSA paper (Yuan et al. 2025, "Native Sparse
# Attention", arXiv:2502.11089, section 4.1): 64 query heads in 4 GQA
# groups, selection blocks of 64, 16 selected blocks, a 512-token window.
# D 128 is the paper's d_v: the op takes one head width for q, k and v,
# and the paper's d_k of 192 has no kernel instance (a cut). Prefill and
# varlen at the pretraining length 8192 (B 1; the varlen documents'
# lengths from default_rng(13), none a multiple of 64), decode at B 8
# over the longest decoding context, 65536 keys. Each token selects block
# 0, its own block, the one before and 13 more drawn from default_rng(12)
# (all its blocks, -1 padded, when it has fewer than 16); gates
# uniform(0.2, 1).
NSA = dict(heads=64, kv_heads=4, head_dim=128, block=64, selected=16,
           window=512, seq=8192, decode_batch=8, decode_context=65536,
           min_doc=300, max_doc=3000)


# DSA (DeepSeek sparse attention) at DeepSeek-V3.2-Exp's attention widths
# (https://huggingface.co/deepseek-ai/DeepSeek-V3.2-Exp/blob/main/config.json:
# num_attention_heads 128, kv_lora_rank 512 (the latent D),
# qk_rope_head_dim 64 (the tail DT), index_n_heads 64, index_head_dim 128,
# index_topk 2048), B 1: a 4096-query prefill chunk at the tail of an
# 8192-token cache (q_offset 4096, so every query sees at least 4097 keys
# and all 2048 slots are live), f32 and bf16. Departures, so this is not
# DeepSeek-V3.2: one attention op, not 61 layers; activations drawn from
# seeded generators on the card, no projections and no RoPE; sm_scale
# the JAX default 1/sqrt(576), not DeepSeek's YaRN-scaled one; f32 and
# bf16 where upstream runs the indexer in fp8 (the JAX kernel has no fp8
# path). The sparse fine-tuning step (make_sparse_mla) at the same widths
# with S cut to 1024 over a 4096-token cache: its backward is autograd
# through the dense reference, whose gather at S 4096 would hold 19 GB in
# f32.
DSA = dict(heads=128, latent=512, rope=64, index_heads=64, index_dim=128,
           topk=2048, seq=4096, cache=8192, ft_seq=1024, ft_cache=4096)
# kernel vs plain, normwise: the indexer f32 the same products in another
# order, bf16 exact products of bf16 inputs summed in f32 in another
# order; sparse MLA as MLA decode (bf16 rounds p before p @ v); LSE 1e-5;
# the kernel chain against the plain chain at sparse MLA's bound on the
# rows that select the same set, near-ties on the others (see
# dsa_phase); the fine-tuning gradients against autograd through the
# dense reference at MLA's bounds
DSA_TOL = {"indexer": {"float32": 1e-5, "bfloat16": 1e-2},
           "mla": {"float32": 1e-5, "bfloat16": 2e-2}, "lse": 1e-5}


def varlen_pack_lengths(cfg):
    """The packed training batch's document lengths: drawn from
    default_rng(0) in [min_doc, context] until the next would overflow
    the pack."""
    import numpy as np
    rng = np.random.default_rng(0)
    lens = []
    while True:
        n = int(rng.integers(cfg["min_doc"], cfg["context"] + 1))
        if sum(lens) + n > cfg["pack"]:
            return lens
        lens.append(n)


# the script's peak device memory over the phases whose counters were
# zeroed (see reset_peak)
SCRIPT_PEAK = [0]


def reset_peak(torch):
    """Zero the device's peak-memory counter for a phase of its own,
    keeping the peak so far in the script's."""
    SCRIPT_PEAK[0] = max(SCRIPT_PEAK[0], torch.cuda.max_memory_allocated())
    torch.cuda.reset_peak_memory_stats()


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def phase(name):
    print(f"== {name} (at {time.perf_counter() - T_START:.1f}s)",
          flush=True)


def cuda_ms(torch, fn, iters):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls after
    a warm-up, free of the host's time between launches: the card first
    spins (``torch.cuda._sleep``, ~25 ms) while the host enqueues every
    call, then CUDA events time the calls run end to end. (Events around
    calls the host issues one by one count its time between launches,
    which a kernel of tens of microseconds cannot hide.)"""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def normwise_err(got, want):
    """(max |got - want|, that over max |want|)."""
    err = float((got.float() - want.float()).abs().max())
    return err, err / max(float(want.float().abs().max()), 1e-30)


def max_rel_excess(got, want):
    """max |got - want| / (ATOL + RTOL |want|): <= 1 means within."""
    return float(((got - want).abs() / (ATOL + RTOL * want.abs())).max())


def kernel_phase(torch, fd, dtype):
    """paged_decode against its plain version at the serving shapes."""
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = N_PAGES * PS
    kp = torch.randn((H, rows, D), generator=g, device="cuda").to(dtype)
    vp = torch.randn((H, rows, D), generator=g, device="cuda").to(dtype)
    q = torch.randn((B, H, 1, D), generator=g, device="cuda")
    table = torch.stack([torch.randperm(N_PAGES, generator=g,
                                        device="cuda")[:PP]
                         for _ in range(B)]).to(torch.int32)
    scale = 1.0 / math.sqrt(D)

    def kern():
        return fd.paged_decode_partials(q, kp, vp, table, PS, N_SPLIT,
                                        scale)

    def plain():
        return fd.paged_decode_partials_plain(q, kp, vp, table, PS,
                                              N_SPLIT, scale)

    got, want = kern(), plain()
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    excess = max(max_rel_excess(a, b) for a, b in zip(got, want))
    for a in got:
        check(bool(torch.isfinite(a).all()), "non-finite kernel output")
    check(excess <= 1.0, f"paged_decode ({dtype}) disagrees with its plain "
                         f"version: max abs err {err:.3e}, "
                         f"{excess:.2f}x the tolerance")
    out_k = fd._combine_splits(q, *got)
    out_p = fd._combine_splits(q, *want)
    check(max_rel_excess(out_k, out_p) <= 1.0, "combined output disagrees")

    # library yardstick: one fused attention call on the same KV,
    # gathered contiguous beforehand (timed only; the port never calls it)
    idx = (table.long()[:, :, None] * PS
           + torch.arange(PS, device="cuda")).reshape(B, PP * PS)
    kc = kp[:, idx].permute(1, 0, 2, 3).contiguous()       # (B,H,S,D)
    vc = vp[:, idx].permute(1, 0, 2, 3).contiguous()
    qc = q.to(dtype)
    lib_out = F.scaled_dot_product_attention(qc, kc, vc)
    check(float((lib_out.float() - out_p).abs().max()) < 2e-2,
          "library yardstick disagrees with the plain version")

    ms = cuda_ms(torch, kern, 20)
    plain_ms = cuda_ms(torch, plain, 3)
    # the kernel at each (batch, pages) bucket the serving phase uses
    bucket_ms = {}
    for b in (1, 2, 4, 8):
        for pp in (16, 32, 64):
            qb, tb = q[:b], table[:b, :pp].contiguous()
            bucket_ms[f"b{b}p{pp}"] = cuda_ms(
                torch, lambda: fd.paged_decode_partials(
                    qb, kp, vp, tb, PS, min(N_SPLIT, pp), scale), 20)
    library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qc, kc, vc), 20)
    esize = torch.empty((), dtype=dtype).element_size()
    n_rows = B * PP * PS                 # distinct rows this table reads
    bytes_moved = (2 * n_rows * H * D * esize      # K and V, once
                   + q.numel() * 4 + table.numel() * 4
                   + sum(t.numel() * 4 for t in got))
    flops = 4 * n_rows * H * D           # q.k and p.v per row and head
    t_bytes = bytes_moved / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    res = {"dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
           "tolerance": f"rtol={RTOL} atol={ATOL}", "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": bytes_moved, "flops": flops, "bucket_ms": bucket_ms}
    print(json.dumps(res), flush=True)
    del kp, vp, kc, vc
    torch.cuda.empty_cache()
    return res


def decode_phase(torch, fd, dtype):
    """The contiguous decode kernel against its plain version at the
    serving decode shape, then the two paged strategies end to end there:
    flash_decode_paged_pool (the in-kernel walk) against
    flash_decode_paged (gather + the contiguous kernel), in turns."""
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(2)
    S = PP * PS
    q = torch.randn((B, H, 1, D), generator=g, device="cuda")
    kpages = torch.randn((N_PAGES, PS, H, D), generator=g,
                         device="cuda").to(dtype)
    vpages = torch.randn((N_PAGES, PS, H, D), generator=g,
                         device="cuda").to(dtype)
    table = torch.stack([torch.randperm(N_PAGES, generator=g,
                                        device="cuda")[:PP]
                         for _ in range(B)]).to(torch.int32)
    idx = table.long()
    k = kpages[idx].reshape(B, S, H, D).transpose(1, 2).contiguous()
    v = vpages[idx].reshape(B, S, H, D).transpose(1, 2).contiguous()
    scale = 1.0 / math.sqrt(D)

    def kern():
        return fd.decode_partials(q, k, v, N_SPLIT, scale)

    def plain():
        return fd.decode_partials_plain(q, k, v, N_SPLIT, scale)

    got, want = kern(), plain()
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    excess = max(max_rel_excess(a, b) for a, b in zip(got, want))
    for a in got:
        check(bool(torch.isfinite(a).all()), "non-finite kernel output")
    check(excess <= 1.0, f"decode ({dtype}) disagrees with its plain "
                         f"version: max abs err {err:.3e}, "
                         f"{excess:.2f}x the tolerance")
    out_p = fd._combine_splits(q, *want)
    qd = q.to(dtype)
    lib_out = F.scaled_dot_product_attention(qd, k, v)
    check(float((lib_out.float() - out_p).abs().max()) < 2e-2,
          "library yardstick disagrees with the plain version")
    ms = cuda_ms(torch, kern, 20)
    plain_ms = cuda_ms(torch, plain, 3)
    library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qd, k, v), 20)
    esize = torch.empty((), dtype=dtype).element_size()
    bytes_moved = (2 * B * H * S * D * esize + q.numel() * 4
                   + sum(t.numel() * 4 for t in got))
    flops = 4 * B * H * S * D
    t_bytes = bytes_moved / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    del k, v
    torch.cuda.empty_cache()

    # the two paged strategies, end to end with their combine
    kp = fd.pages_to_hmajor(kpages)
    vp = fd.pages_to_hmajor(vpages)

    def walk():
        return fd.flash_decode_paged_pool(q, kp, vp, table, PS,
                                          n_split=N_SPLIT)

    def gather():
        return fd.flash_decode_paged(q, kpages, vpages, table,
                                     n_split=N_SPLIT)

    check(max_rel_excess(gather(), walk()) <= 1.0,
          "gather and walk strategies disagree")
    fd.reset_launches()                  # the gather strategy's runs
    turns = {"walk_ms": [], "gather_ms": []}
    for name, fn in (("walk_ms", walk), ("gather_ms", gather),
                     ("gather_ms", gather), ("walk_ms", walk)):
        turns[name].append(cuda_ms(torch, fn, 20))
    launches = fd.launches["decode"]     # read right after
    check(launches == 42, f"gather strategy launched decode {launches} "
                          f"times, want 42")
    check(fd.kernel_launches[fd.decode_path(dtype)] == 42,
          f"gather strategy ({dtype}) ran {fd.kernel_launches}, want 42 "
          f"{fd.decode_path(dtype)}")
    res = {"dtype": str(dtype).replace("torch.", ""),
           "kernel": fd.decode_path(dtype), "max_abs_err": err,
           "tolerance": f"rtol={RTOL} atol={ATOL}", "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": bytes_moved, "flops": flops, "launches": launches,
           "strategies": turns}
    print(json.dumps(res), flush=True)
    del kpages, vpages, kp, vp
    torch.cuda.empty_cache()
    return res


def mla_bound(torch, dtype, b, s, ns):
    """(bound ms, what binds it, flops, bytes) of MLA decode partials:
    the latent and the queries read once, the partials written once."""
    esize = torch.empty((), dtype=dtype).element_size()
    dk = MLA_DC + MLA_DR
    flops = 2 * b * MLA_H * s * dk + 2 * b * MLA_H * s * MLA_DC
    nbytes = (b * s * dk * esize + b * MLA_H * dk * esize
              + b * ns * MLA_H * (MLA_DC + 2) * 4)
    peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / peak * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", flops, nbytes)


def mla_kernel_phase(torch, mla, dtype):
    """mla_decode against its plain version at bench.py:1495's shape for
    1, 2, 4 and 8 splits, then at the serving window (S=8192, 8 splits).
    The latent comes as the [ckv | kpe] column views of one tensor, as
    the serving path passes it."""
    import torch.nn.functional as F

    from tilelang_mesh_tpu_torch.ops.flash_decoding import merge_splits
    name = str(dtype).replace("torch.", "")
    tol = MLA_TOL[name]
    g = torch.Generator(device="cuda").manual_seed(3)
    sm = 1.0 / math.sqrt(MLA_DC + MLA_DR)
    res = {"dtype": name, "tolerance": f"normwise {tol}", "cases": []}
    for s, splits in ((MLA_S, (1, 2, 4, 8)), (2 * MLA_S, (8,))):
        q = torch.randn((MLA_B, MLA_H, MLA_DC + MLA_DR), generator=g,
                        device="cuda").to(dtype)
        rows = torch.randn((MLA_B, s, MLA_DC + MLA_DR), generator=g,
                           device="cuda").to(dtype)
        qc, qr = q[..., :MLA_DC], q[..., MLA_DC:]
        ckv, kpe = rows[..., :MLA_DC], rows[..., MLA_DC:]
        for ns in splits:
            def kern():
                return mla.mla_decode_partials(qc, qr, ckv, kpe, ns, sm)

            def plain():
                return mla.mla_decode_partials_plain(qc, qr, ckv, kpe, ns,
                                                     sm)

            got, want = kern(), plain()
            torch.cuda.synchronize()
            for a in got:
                check(bool(torch.isfinite(a).all()),
                      "mla_decode: non-finite kernel output")
            errs = [normwise_err(a, b) for a, b in zip(got, want)]
            rel = max(e[1] for e in errs)
            check(rel <= tol, f"mla_decode ({name}, S={s}, {ns} splits) "
                              f"disagrees with its plain version: "
                              f"{rel:.3e} of max |plain| > {tol}")
            bound, by, flops, nbytes = mla_bound(torch, dtype, MLA_B, s, ns)
            res["cases"].append({
                "S": s, "n_split": ns,
                "max_abs_err": max(e[0] for e in errs),
                "normwise_err": rel, "ms": cuda_ms(torch, kern, 20),
                "plain_ms": cuda_ms(torch, plain, 3), "bound_ms": bound,
                "bound_by": by, "flops": flops, "bytes": nbytes})
        # library yardstick, timed only: one SDPA call with the heads as
        # the query rows of a single head over the shared latent (the
        # same function; q/k 576 wide, v 512)
        out_p = merge_splits(*mla.mla_decode_partials_plain(
            qc, qr, ckv, kpe, 8, sm))
        qh, kh, vh = q[:, None], rows[:, None], rows[:, None, :, :MLA_DC]

        def lib():
            return F.scaled_dot_product_attention(qh, kh, vh, scale=sm)

        lib_err = normwise_err(lib()[:, 0], out_p)[1]
        check(lib_err < 2e-2, f"library yardstick disagrees with the plain "
                              f"version ({lib_err:.3e})")
        res[f"library_ms_S{s}"] = cuda_ms(torch, lib, 20)
        del q, rows
        torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)
    return res


def causal_pairs(Sq, Sk):
    """(i, j) pairs a top-left causal mask keeps: sum_i min(i + 1, Sk)."""
    n = min(Sq, Sk)
    return n * (n + 1) // 2 + max(0, Sq - Sk) * Sk


def tile_pairs(torch, mask, bM, bN, Sq, Sk, tile, causal):
    """(i, j) pairs the masked tensor-core forwards (blocksparse_mha_mma,
    vs_sparse_mma) compute for the cell mask ``mask (B, H, Sq // bM, Sk
    // bN)`` at the tile ``(TM, TN)``: every pair of each warp's TM / 4
    rows in each live key tile (one that overlaps a live cell), but for a
    warp whose rows start past Sq or, causal, whose rows lie wholly
    below the tile's first key; rows past Sq and keys past Sk count, as
    the kernels compute them."""
    import torch.nn.functional as F
    TM, TN = tile
    RW = TM // 4
    dev = mask.device
    cs = F.pad((mask != 0).int().cumsum(-1).cumsum(-2), (1, 0, 1, 0))
    a = torch.arange(-(-Sq // TM), device=dev)
    b = torch.arange(-(-Sk // TN), device=dev)
    r0, r1 = a * TM // bM, ((a * TM + TM).clamp(max=Sq) - 1) // bM + 1
    c0, c1 = b * TN // bN, ((b * TN + TN).clamp(max=Sk) - 1) // bN + 1
    hits = (cs[..., r1, :][..., c1] - cs[..., r0, :][..., c1]
            - cs[..., r1, :][..., c0] + cs[..., r0, :][..., c0])
    live = hits > 0
    pairs = 0
    for w in range(4):
        qw = a[:, None] * TM + RW * w
        ok = qw < Sq
        if causal:
            ok = ok & (b[None, :] * TN <= qw + RW - 1)
        pairs += int((live & ok).sum()) * RW * TN
    return pairs


def attention_phase(torch, fa, gb, dtype):
    """The four attention kernels against their plain versions on the
    card: at the model's shapes (timed, with their bounds and a library
    yardstick), then at D=16 on a ragged S."""
    import torch.nn.functional as F
    name = str(dtype).replace("torch.", "")
    tol = ATTN_TOL[name]
    esize = torch.empty((), dtype=dtype).element_size()
    peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
    g = torch.Generator(device="cuda").manual_seed(1)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    def inputs(B, H, S, D):
        q, k, v, do = (rnd(B, H, S, D) for _ in range(4))
        sm = 1.0 / math.sqrt(D)
        acc, m, l = fa.mha_fwd_partial_plain(q, k, v, True, sm)
        o = (acc / l[..., None]).to(dtype)
        lse2 = m + torch.log2(l)
        delta = (do.float() * o.float()).sum(-1)
        return q, k, v, do, lse2, delta, sm

    def compare(label, kern, plain):
        got, want = kern(), plain()
        torch.cuda.synchronize()
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        errs = [normwise_err(a, b) for a, b in zip(got, want)]
        for a in got:
            check(bool(torch.isfinite(a).all()), f"{label}: non-finite "
                                                 f"kernel output")
        worst = max(e[1] for e in errs)
        check(worst <= tol, f"{label} ({name}) disagrees with its plain "
                            f"version: {worst:.3e} of max |plain| > {tol}")
        return max(e[0] for e in errs), worst

    res = {}
    H, S, D = 16, 4096, 128
    for B in (2, TRAIN_BATCH):
        q, k, v, do, lse2, delta, sm = inputs(B, H, S, D)
        bhsd, bhs = B * H * S * D, B * H * S
        pairs = causal_pairs(S, S) * B * H
        if B == 2:
            cases = {"mha_fwd": (
                lambda: fa.mha_fwd(q, k, v, True, sm),
                lambda: fa.mha_fwd_plain(q, k, v, True, sm),
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       is_causal=True),
                4 * D * pairs, 4 * bhsd * esize)}
        else:
            cases = {
                "mha_fwd_partial": (
                    lambda: fa.mha_fwd_partial(q, k, v, True, sm),
                    lambda: fa.mha_fwd_partial_plain(q, k, v, True, sm),
                    # returns the natural-log LSE, not (m, l) in exp2
                    lambda: torch.ops.aten._scaled_dot_product_efficient_attention(
                        q, k, v, None, True, 0.0, True),
                    4 * D * pairs, 3 * bhsd * esize + 4 * bhsd + 8 * bhs),
                "gqa_bwd_dkdv": (
                    lambda: gb.gqa_bwd_dkdv(q, k, v, do, lse2, delta, True,
                                            sm),
                    lambda: gb.gqa_bwd_dkdv_plain(q, k, v, do, lse2, delta,
                                                  True, sm),
                    None, 8 * D * pairs,
                    4 * bhsd * esize + 8 * bhs + 8 * bhsd),
                "gqa_bwd_dq": (
                    lambda: gb.gqa_bwd_dq(q, k, v, do, lse2, delta, True,
                                          sm),
                    lambda: gb.gqa_bwd_dq_plain(q, k, v, do, lse2, delta,
                                                True, sm),
                    None, 6 * D * pairs,
                    4 * bhsd * esize + 8 * bhs + 4 * bhsd)}
        for kname, (kern, plain, lib, flops, nbytes) in cases.items():
            err, rel = compare(kname, kern, plain)
            t_bytes = nbytes / PEAK_BYTES_S * 1e3
            t_ops = flops / peak * 1e3
            res[kname] = {
                "max_abs_err": err, "normwise_err": rel,
                "tolerance": f"normwise {tol}",
                "ms": cuda_ms(torch, kern, 5),
                "plain_ms": cuda_ms(torch, plain, 2),
                "library_ms": cuda_ms(torch, lib, 5) if lib else None,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "flops": flops, "bytes": nbytes,
                "shape": [B, H, S, D]}
        if B == 2:
            out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
            _, rel = normwise_err(out, fa.mha_fwd_plain(q, k, v, True, sm))
            check(rel < 2e-2, f"library yardstick disagrees with the "
                              f"plain version ({rel:.3e})")
        else:
            # SDPA's backward: dq, dk and dv together, for the pair
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = F.scaled_dot_product_attention(*leaves, is_causal=True)
            bwd_ms = cuda_ms(torch, lambda: torch.autograd.grad(
                out, leaves, do, retain_graph=True), 5)
            for kname in ("gqa_bwd_dkdv", "gqa_bwd_dq"):
                res[kname]["library_ms"] = bwd_ms
                res[kname]["library"] = "SDPA backward (dq, dk, dv)"
            del leaves, out
        del q, k, v, do, lse2, delta
        torch.cuda.empty_cache()

    # every kernel once more at D=16 on a ragged S (no multiple of a tile)
    q, k, v, do, lse2, delta, sm = inputs(2, 2, 1000, 16)
    for kname, kern, plain in (
            ("mha_fwd", lambda: fa.mha_fwd(q, k, v, True, sm),
             lambda: fa.mha_fwd_plain(q, k, v, True, sm)),
            ("mha_fwd_partial", lambda: fa.mha_fwd_partial(q, k, v, True, sm),
             lambda: fa.mha_fwd_partial_plain(q, k, v, True, sm)),
            ("gqa_bwd_dkdv", lambda: gb.gqa_bwd_dkdv(
                q, k, v, do, lse2, delta, True, sm),
             lambda: gb.gqa_bwd_dkdv_plain(q, k, v, do, lse2, delta, True,
                                           sm)),
            ("gqa_bwd_dq", lambda: gb.gqa_bwd_dq(
                q, k, v, do, lse2, delta, True, sm),
             lambda: gb.gqa_bwd_dq_plain(q, k, v, do, lse2, delta, True,
                                         sm))):
        res[kname]["ragged_d16_err"] = compare(f"{kname} D=16 S=1000",
                                               kern, plain)[1]
    print(json.dumps({"attention": name, **res}), flush=True)
    return res


def _profiled_run(torch, fn):
    """Run ``fn`` once under torch.profiler: the wall time (us) and the
    device's activity records, each (start us, end us, name)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return wall_us, [(e.time_range.start, e.time_range.end, e.name)
                     for e in prof.events() if e.device_type.name == "CUDA"]


def device_breakdown(torch, fn, runs=3):
    """Run ``fn`` once under torch.profiler: the wall time, the device's
    busy time (union of its activity intervals) and share, and device ms
    by kind: the port's attention and decode kernels, its grouped GEMM
    kernels, other GEMMs (cuBLAS), everything else.

    CUPTI has been seen to hand the profiler no device record for a run
    of a millisecond or two. Such a run is made again, up to ``runs``
    runs (``profiler_runs`` says how many were made). If none has a
    record, one more run is timed with CUDA events around it: its
    ``device_span_ms`` is the time from the first of its work on the
    stream to the last, idle gaps included, and the busy time, its share
    and the kinds are not measured (None)."""
    for n in range(1, runs + 1):
        wall_us, spans = _profiled_run(torch, fn)
        if any(t1 > t0 for t0, t1, _ in spans):
            break
    else:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        span_ms = start.elapsed_time(stop)
        check(span_ms > 0, "CUDA events saw no device time")
        return {"wall_ms": wall_us / 1e3, "device_busy_ms": None,
                "device_busy_share": None, "attention_kernels_ms": None,
                "grouped_gemm_ms": None, "gemm_ms": None, "other_ms": None,
                "device_span_ms": span_ms, "profiler_runs": runs,
                "source": "cuda_events"}
    kinds = {"attention_kernels_ms": 0.0, "grouped_gemm_ms": 0.0,
             "gemm_ms": 0.0, "other_ms": 0.0}
    for t0, t1, name in spans:
        kind = ("attention_kernels_ms" if any(
            k in name for k in ("mha_fwd", "gqa_bwd", "decode")) else
                "grouped_gemm_ms" if any(
                    k in name for k in ("grouped_gemm", "grouped_tma",
                                        "grouped_tf32x3")) else
                "gemm_ms" if "gemm" in name else "other_ms")
        kinds[kind] += (t1 - t0) / 1e3
    busy, end = 0.0, -math.inf
    for t0, t1, _ in sorted(spans):
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / wall_us, **kinds,
            "profiler_runs": n, "source": "profiler"}


def _launch_counts(fa, gb):
    return {**fa.launches, **gb.launches}


def model_phase(torch, fa, gb):
    """The flagship transformer at FULL widths: the entry's forward, then
    three training steps, each against the dense plain path."""
    import dataclasses

    import numpy as np

    from tilelang_mesh_tpu_torch.entry import entry
    from tilelang_mesh_tpu_torch.models import (ModelConfig, forward,
                                                make_train_step)
    from tilelang_mesh_tpu_torch.models import transformer as tm
    from torch.utils.checkpoint import checkpoint

    cfg = ModelConfig(**FULL)
    L = cfg.n_layers
    plain_cfg = dataclasses.replace(cfg, use_flash=False)
    fn, (model, tokens) = entry(cfg=cfg)
    check(tuple(tokens.shape) == (2, cfg.max_seq), "entry tokens")

    # forward: the main path, no autograd, so the forward kernel
    fa.reset_launches()
    gb.reset_launches()
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = fn(model, tokens)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
    fwd_launches = _launch_counts(fa, gb)          # read right after
    check(fwd_launches == {"mha_fwd": L, "mha_fwd_partial": 0,
                           "gqa_bwd_dkdv": 0, "gqa_bwd_dq": 0},
          f"forward launches {fwd_launches}, want mha_fwd = {L}")
    check(tuple(logits.shape) == (2, cfg.max_seq, cfg.vocab)
          and bool(torch.isfinite(logits).all()), "bad forward logits")
    with torch.no_grad():
        want = forward(model, tokens, plain_cfg)
    logits_err = normwise_err(logits, want)
    check(logits_err[1] <= MODEL_TOL["logits"],
          f"logits disagree with the plain path: {logits_err}")
    del logits, want
    torch.cuda.empty_cache()

    rng = np.random.default_rng(1)
    train_tok = torch.from_numpy(rng.integers(
        0, cfg.vocab, (TRAIN_BATCH, cfg.max_seq + 1))).cuda()
    lp0 = model.layers[0]

    # the plain path's loss and gradients at the same initial weights. Its
    # dense attention saves four (B, H, S, S) float32 tensors a layer, too
    # many for the card at once, so each layer's attention is recomputed
    # in the backward (activation checkpointing).
    attention = tm._attention
    tm._attention = lambda x, lp, c: checkpoint(attention, x, lp, c,
                                                use_reentrant=False)
    try:
        model.zero_grad(set_to_none=True)
        plain_loss = tm.loss_fn(model, train_tok, plain_cfg)
        plain_loss.backward()
    finally:
        tm._attention = attention
    plain_loss = float(plain_loss.detach())
    plain_grads = (lp0.wq.grad.clone(), lp0.wo.grad.clone())
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()

    init, step = make_train_step(cfg, lr=1e-3)
    opt = init(model)
    reset_peak(torch)
    fa.reset_launches()                  # the training path starts here
    gb.reset_launches()
    losses, step_ms = [], []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, opt, loss = step(model, opt, train_tok)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        if i == 0:
            grads = (lp0.wq.grad.clone(), lp0.wo.grad.clone())
    train_launches = _launch_counts(fa, gb)        # read right after
    peak_bytes = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(train_launches == {"mha_fwd": 0, "mha_fwd_partial": 3 * L,
                             "gqa_bwd_dkdv": 3 * L, "gqa_bwd_dq": 3 * L},
          f"training launches {train_launches}, want {3 * L} each")
    loss_err = abs(losses[0] - plain_loss) / abs(plain_loss)
    check(loss_err <= MODEL_TOL["loss"],
          f"step-1 loss {losses[0]} vs plain {plain_loss}")
    grad_err = [normwise_err(a, b)[1] for a, b in zip(grads, plain_grads)]
    check(max(grad_err) <= MODEL_TOL["grad"],
          f"layer-0 wq / wo gradients disagree with the plain path: "
          f"{grad_err}")
    # where the time goes: one more forward and step, profiled, after
    # the counted runs
    with torch.no_grad():
        fwd_profile = device_breakdown(torch, lambda: fn(model, tokens))
    step_profile = device_breakdown(
        torch, lambda: step(model, opt, train_tok))
    step_med = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    n_tok = TRAIN_BATCH * cfg.max_seq
    res = {"config": {k: v for k, v in FULL.items()},
           "forward_ms": fwd_s * 1e3,
           "forward_tokens_per_s": 2 * cfg.max_seq / fwd_s,
           "forward_launches": fwd_launches,
           "logits_err": logits_err[0], "logits_normwise_err": logits_err[1],
           "losses": losses, "plain_loss": plain_loss,
           "loss_rel_err": loss_err, "grad_normwise_err": grad_err,
           "step_ms": step_ms, "step_ms_median_after_first": step_med,
           "train_tokens_per_s": n_tok / (step_med / 1e3),
           "train_launches": train_launches,
           "max_memory_allocated_bytes": peak_bytes,
           "forward_profile": fwd_profile, "step_profile": step_profile,
           "tolerance": MODEL_TOL}
    print(json.dumps(res), flush=True)
    del model, opt, grads, plain_grads
    torch.cuda.empty_cache()
    return res


def keep_full_window(wl, grab):
    """Wrap the workload's dispatch so that the first full-window step
    with a non-zero query keeps ``grab(q, table, bb, pp, out)``: its
    inputs, output and a copy of the rows it read, to recompute with
    the plain version after the run."""
    kept = {}
    dispatch = wl._dispatch

    def keeping(q, table, bb, pp):
        out = dispatch(q, table, bb, pp)
        if not kept and pp == wl.page_buckets[-1] and q.any():
            kept.update(grab(q.copy(), table, bb, pp, out.clone()))
        return out

    wl._dispatch = keeping
    return kept


def table_rows(torch, table, ps):
    """Pool row ids of a page table, in token order: (bb * pp * ps,)."""
    return (torch.from_numpy(table).long().cuda()[:, :, None] * ps
            + torch.arange(ps, device="cuda")).reshape(-1)


def serve_waves(torch, wl, counter, name, out_shape):
    """The main serving path: an engine over ``wl`` warms up and answers
    two waves of four requests (8192- and 2048-token prompts, 16 greedy
    tokens each; two wave-2 requests repeat a wave-1 prompt). ``counter``
    is the kernels' launch-count dict: zeroed just before, ``name``'s
    count read just after. Checks the outcomes, the books, the prefix
    cache, launches against dispatches and the outputs' shape; returns
    the metrics."""
    from tilelang_mesh_tpu_torch.observability import histogram
    from tilelang_mesh_tpu_torch.serving import ServingEngine
    alloc = wl.allocator
    eng = ServingEngine(wl)
    for k in counter:                    # the main path starts here
        counter[k] = 0
    histogram.reset()
    t0 = time.perf_counter()
    n_warm = eng.warmup()
    warm_s = time.perf_counter() - t0
    waves = [[(8192, 1), (8192, 2), (2048, 3), (2048, 4)],
             [(8192, 1), (8192, 1), (2048, 5), (2048, 6)]]
    reqs, wave_s, submit_s = [], [], 0.0
    for wave in waves:
        t0 = time.perf_counter()
        batch = [eng.submit(context_tokens=ctx, new_tokens=16, seed=seed)
                 for ctx, seed in wave]
        submit_s += time.perf_counter() - t0
        eng.run()
        wave_s.append(time.perf_counter() - t0)
        reqs += batch
    launches = counter[name]             # read right after
    stats = eng.stats()
    dispatches = wl.dispatches

    check([r.outcome for r in reqs] == ["result"] * len(reqs),
          f"outcomes {[(r.outcome, r.shed_reason, r.error) for r in reqs]}")
    check(alloc.in_use == 0 and not alloc.leak_check(),
          f"leaked pages: {alloc.leak_check()}")
    pc = wl.prefix_cache.stats()
    check(pc["hits"] >= 1, f"no prefix-cache hit: {pc}")
    check(launches == dispatches and launches > 0,
          f"{name} launches {launches} != decode dispatches {dispatches}")
    for r in reqs:
        out = r.result
        check(out.shape == out_shape and bool(abs(out).max() < 1e30)
              and not (out != out).any(), f"bad output of {r}")
        check(len(r.generated) == 16, f"{r} sampled {len(r.generated)}")
    # one more step at the top bucket, profiled: how much of a step's
    # wall time the card is busy, and with what
    import numpy as np
    bb, pp = wl.batch_buckets[-1], wl.page_buckets[-1]
    q = np.random.default_rng(0).standard_normal(
        wl._query_shape(bb)).astype(np.float32)
    table = np.arange(bb * pp, dtype=np.int32).reshape(bb, pp)
    step_profile = device_breakdown(
        torch, lambda: wl._dispatch(q, table, bb, pp).cpu())
    # the host's share of a step outside the dispatch: drawing the
    # batch's queries (numpy, as the JAX package draws them)
    t0 = time.perf_counter()
    np.stack([wl._query(reqs[i % len(reqs)]) for i in range(bb)])
    step_profile["query_draw_ms"] = (time.perf_counter() - t0) * 1e3

    steps_ms = sorted((s.t1 - s.t0) * 1e3 for s in eng.trace.spans
                      if s.name == "serve.batch" and s.t1 is not None)
    ttft_ms = sorted((r.first_token_t - r.submit_t) * 1e3 for r in reqs)
    prefill = histogram.get_histogram("serve.prefill.latency")
    # where the waves' wall time went: admission (prefix restore + the
    # first prefill chunk), later prefill chunks (host KV derivation, its
    # copy to the card, prefix publication), decode steps, the rest
    # (scheduling, sampling, token appends)
    split = {"submit_s": submit_s,
             "prefill_chunks_s": prefill.sum if prefill else 0.0,
             "decode_steps_s": sum(steps_ms) / 1e3}
    split["other_s"] = sum(wave_s) - sum(split.values())

    def pct(xs, p):
        return xs[min(len(xs) - 1, int(round(p / 100 * (len(xs) - 1))))]

    return {"requests": len(reqs), "warmup_buckets": n_warm,
            "warmup_s": warm_s, "wave_s": wave_s,
            "req_per_s": len(reqs) / sum(wave_s),
            "tokens_per_s": 16 * len(reqs) / sum(wave_s),
            "decode_steps": stats["steps"], "dispatches": dispatches,
            "launches": launches,
            "step_ms_p50": pct(steps_ms, 50), "step_ms_p99": pct(steps_ms, 99),
            "ttft_ms_p50": pct(ttft_ms, 50), "ttft_ms_max": ttft_ms[-1],
            "prefix_cache": {k: pc[k] for k in ("hits", "misses",
                                                 "bytes_saved")},
            "wall_split": split, "top_bucket_step_profile": step_profile}


def serving_phase(torch, fd, cache_root):
    import numpy as np

    from tilelang_mesh_tpu_torch.serving import (FlashDecodeWorkload,
                                                 PagedKVAllocator,
                                                 PrefixKVCache)
    alloc = PagedKVAllocator(n_pages=N_PAGES, page_size=PS, heads=H,
                             head_dim=D)
    check(alloc.kp.is_cuda and alloc.vp.is_cuda, "pools not on the card")
    wl = FlashDecodeWorkload(alloc, batch_buckets=(1, 2, 4, 8),
                             page_buckets=(16, 32, 64),
                             prefix_cache=PrefixKVCache(root=cache_root))

    def grab(q, table, bb, pp, out):     # the pages it read, renumbered
        rows = table_rows(torch, table, PS)
        return dict(q=q, out=out, kp=alloc.kp[:, rows],
                    vp=alloc.vp[:, rows],
                    table=np.arange(bb * pp, dtype=np.int32).reshape(bb, pp))

    kept = keep_full_window(wl, grab)
    res = serve_waves(torch, wl, fd.launches, "paged_decode", (H, 1, D))
    check(bool(kept), "no full-window step was kept for the recheck")
    qt = torch.from_numpy(kept["q"]).cuda()
    tt = torch.from_numpy(kept["table"]).cuda()
    want = fd._combine_splits(qt, *fd.paged_decode_partials_plain(
        qt, kept["kp"], kept["vp"], tt, PS, N_SPLIT, wl.sm_scale))
    step_err = float((kept["out"] - want).abs().max())
    check(max_rel_excess(kept["out"], want) <= 1.0,
          f"served step disagrees with the plain version ({step_err:.3e})")
    res["step_recheck_max_abs_err"] = step_err
    print(json.dumps(res), flush=True)
    return res


def mla_serving_phase(torch, mla, cache_root):
    """MLADecodeWorkload at DeepSeek-V3's attention widths (MLA_SERVE)
    through the same engine, waves and gates as the serving phase."""
    from tilelang_mesh_tpu_torch.ops.flash_decoding import (clamp_splits,
                                                            merge_splits)
    from tilelang_mesh_tpu_torch.serving import (MLADecodeWorkload,
                                                 PagedKVAllocator,
                                                 PrefixKVCache)
    cfg = MLA_SERVE
    dc, ps = cfg["latent_dim"], cfg["page_size"]
    alloc = PagedKVAllocator(n_pages=cfg["n_pages"], page_size=ps, heads=1,
                             head_dim=dc + cfg["rope_dim"])
    check(alloc.kp.is_cuda, "pools not on the card")
    wl = MLADecodeWorkload(alloc, heads=cfg["heads"], latent_dim=dc,
                           rope_dim=cfg["rope_dim"],
                           batch_buckets=cfg["batch_buckets"],
                           page_buckets=cfg["page_buckets"],
                           prefix_cache=PrefixKVCache(root=cache_root))

    def grab(q, table, bb, pp, out):     # the latent rows it read
        rows = table_rows(torch, table, ps)
        return dict(q=q, out=out, seq=alloc.kp[0][rows].reshape(
            bb, pp * ps, -1))

    kept = keep_full_window(wl, grab)
    res = serve_waves(torch, wl, mla.launches, "mla_decode",
                      (cfg["heads"], dc))
    check(bool(kept), "no full-window step was kept for the recheck")
    q, seq = torch.from_numpy(kept["q"]).cuda(), kept["seq"]
    ns, _ = clamp_splits(seq.shape[1], None, 128)
    want = merge_splits(*mla.mla_decode_partials_plain(
        q[..., :dc], q[..., dc:], seq[..., :dc], seq[..., dc:], ns,
        wl.sm_scale))
    step_err, rel = normwise_err(kept["out"], want)
    check(rel <= MLA_TOL["float32"],
          f"served MLA step disagrees with the plain version ({rel:.3e})")
    res.update(config=cfg, step_recheck_max_abs_err=step_err,
               step_recheck_normwise_err=rel,
               pool_bytes=alloc.kp.numel() * alloc.kp.element_size() * 2)
    print(json.dumps(res), flush=True)
    return res


def moe_inputs(torch, weights=True):
    """MOE_FULL's tokens, router and (with ``weights``) expert weights,
    each from its own seeded generator on the card."""
    c = MOE_FULL
    T, d, f, E = c["tokens"], c["d"], c["f"], c["experts"]

    def draw(seed, shape, scale):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return torch.randn(shape, generator=g, device="cuda") * scale

    x = draw(10, (T, d), 1.0)
    wr = draw(11, (d, E), d ** -0.5)
    if not weights:
        return x, wr
    return (x, wr, draw(12, (E, d, f), d ** -0.5),
            draw(13, (E, f, d), f ** -0.5))


def moe_capacity():
    c = MOE_FULL
    return max(4, math.ceil(c["tokens"] * c["top_k"] * c["capacity_factor"]
                            / c["experts"]))


def gemm_bound(torch, dtype, flops, nbytes):
    """The grouped GEMM's bound: bytes over HBM's rate or operations over
    the type's peak. float32 products run as three TF32 passes on the
    tensor cores (the 3xTF32 kernel) or as FFMA: their operations take
    the lesser time, 3 flops / 495 TFLOP/s or 1 / 67 ("operations
    (3xTF32)")."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    ops = "operations"
    if dtype == torch.float32:
        t_ops = min(flops / PEAK_F32_FLOPS, 3 * flops / PEAK_TF32_FLOPS) * 1e3
        ops = "operations (3xTF32)"
    else:
        t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else ops


def gemm_phase(torch, gg, dtype):
    """The dense grouped GEMM at the MoE layer's two expert products, and
    the token-sorted one on the MOE_FULL batch's routed per-expert
    counts (K = d, N = f, B in both layouts), against their plain
    versions; times, bounds and a torch.bmm yardstick. Each call's path
    (``grouped_path``) and block are reported, and each takes exactly one
    launch of its path's kernel (counters zeroed before, read right
    after). The block tile loop is driven the same way at K = d - 1,
    whose rows are off 16 bytes in every type (the dense w1 product, and
    the token-sorted one with B in both layouts); the token-sorted
    product is on no main path, so its driven launches here are its entry
    point's."""
    from tilelang_mesh_tpu_torch.parallel import moe
    name = str(dtype).replace("torch.", "")
    tol = GEMM_TOL[name]
    esize = torch.empty((), dtype=dtype).element_size()
    c = MOE_FULL
    E, d, f, C = c["experts"], c["d"], c["f"], moe_capacity()
    x, wr = moe_inputs(torch, weights=False)
    _, dispatch = moe.route(x, wr, c["top_k"], C)
    sizes = [int(s) for s in dispatch.sum((0, 2)).long().tolist()]
    # the routed tokens, sorted by expert (the capacity layout's filled
    # rows): the token-sorted GEMM's A
    xe = torch.einsum("td,tec->ecd", x, dispatch)
    del dispatch
    g = torch.Generator(device="cuda").manual_seed(4)
    kernel = {"loop": "", "tma": "_tma", "tf32x3": "_tf32x3"}
    entry = {f"{k}{p}": 0 for k in ("grouped_gemm", "varlen_grouped_gemm")
             for p in kernel.values()}

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda")
                * scale).to(dtype)

    def compare(label, kern, plain):
        got, want = kern(), plain()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
        err, rel = normwise_err(got, want)
        check(rel <= tol, f"{label} ({name}) disagrees with its plain "
                          f"version: {rel:.3e} of max |plain| > {tol}")
        return err, rel

    def driven(label, base, path, kern):
        """One call of the entry point, its counters zeroed before and
        read right after: exactly one launch, of its path's kernel."""
        want = base + kernel[path]
        torch.cuda.synchronize()
        gg.reset_launches()
        kern()
        torch.cuda.synchronize()
        moved = {k: v for k, v in gg.launches.items() if v}
        check(moved == {want: 1}, f"{label} ({name}, path {path}): "
                                  f"launches {moved}, want one {want}")
        entry[want] += 1

    res = {"dtype": name, "tolerance": f"normwise {tol}", "sizes": sizes}
    for label, (M, K, N) in (("w1", (C, d, f)), ("w2", (C, f, d)),
                             ("w1_loop", (C, d - 1, f))):
        a, b = rnd(E, M, K), rnd(E, K, N, scale=K ** -0.5)
        path = gg.grouped_path(dtype, M, N, K, a.data_ptr(), b.data_ptr())
        check((path == "loop") == label.endswith("loop"),
              f"grouped_gemm {label} ({name}) takes the {path} path")
        block = gg.grouped_block(path, M, N, K, dtype)
        driven(f"grouped_gemm {label}", "grouped_gemm", path,
               lambda: gg.grouped_matmul(a, b))
        err, rel = compare(f"grouped_gemm {label}",
                           lambda: gg.grouped_matmul(a, b),
                           lambda: gg.grouped_matmul_plain(a, b))
        flops = 2 * E * M * N * K
        nbytes = (E * M * K + E * K * N + E * M * N) * esize
        bound, by = gemm_bound(torch, dtype, flops, nbytes)
        res[label] = {
            "shape": [E, M, K, N], "path": path, "block": list(block),
            "max_abs_err": err, "normwise_err": rel,
            "ms": cuda_ms(torch, lambda: gg.grouped_matmul(a, b), 5),
            "plain_ms": cuda_ms(torch, lambda: gg.grouped_matmul_plain(a, b),
                                3),
            "library_ms": cuda_ms(torch, lambda: torch.bmm(a, b), 5),
            "bound_ms": bound, "bound_by": by, "flops": flops,
            "bytes": nbytes}
        del a, b
        torch.cuda.empty_cache()

    xpad = xe.to(dtype)                  # the capacity-padded layout
    rows = sum(sizes)
    live = sum(1 for s in sizes if s)
    starts = [sum(sizes[:e]) for e in range(E)]
    for K in (d, d - 1):
        a = torch.cat([xe[e, :s, :K] for e, s in enumerate(sizes)]).to(dtype)
        b = rnd(E, K, f, scale=K ** -0.5)
        flops = 2 * rows * K * f
        for trans_b in (False, True):
            bb = b.transpose(1, 2).contiguous() if trans_b else b
            path = gg.grouped_path(dtype, max(sizes), f, K, a.data_ptr(),
                                   bb.data_ptr(), trans_b)
            block = gg.grouped_block(path, gg.varlen_rows(sizes), f, K,
                                     dtype)
            TB = len(gg._varlen_meta(sizes, block[0])[0])
            nbytes = (rows * K + live * K * f) * esize + rows * f * 4 \
                + 4 * (2 * TB + 2 * E + 1)
            bound, by = gemm_bound(torch, dtype, flops, nbytes)

            def kern():
                return gg.varlen_grouped_matmul(a, bb, sizes,
                                                trans_b=trans_b)

            def plain():
                return gg.varlen_grouped_matmul_plain(a, bb, sizes, trans_b)

            def library():               # the same work: the routed rows
                return [a[s0:s0 + n] @ (bb[e].t() if trans_b else bb[e])
                        for e, (s0, n) in enumerate(zip(starts, sizes))
                        if n]

            key = ("varlen_trans" if trans_b else "varlen") + (
                "" if K == d else "_loop")
            check((path == "loop") == key.endswith("loop"),
                  f"varlen_grouped_gemm {key} ({name}) takes the {path} "
                  f"path")
            # the entry point's own path (the MoE layer does not call it):
            # one call at the routed counts; the comparison's launches
            # below do not count
            driven(f"varlen_grouped_matmul {key}", "varlen_grouped_gemm",
                   path, kern)
            err, rel = compare(f"varlen_grouped_gemm {key}", kern, plain)
            res[key] = {
                "rows": rows, "K": K, "path": path, "block": list(block),
                "max_abs_err": err, "normwise_err": rel,
                "ms": cuda_ms(torch, kern, 5),
                "plain_ms": cuda_ms(torch, plain, 3),
                "library_ms": cuda_ms(torch, library, 5),
                "library": "torch.matmul per group on the routed rows",
                "bound_ms": bound, "bound_by": by, "flops": flops,
                "bytes": nbytes}
            if K == d and not trans_b:
                # cuBLAS on the padded layout does C·E rows
                res[key]["bmm_padded_ms"] = cuda_ms(
                    torch, lambda: torch.bmm(xpad, b), 5)
            del bb
        del a, b
    del xe, xpad
    torch.cuda.empty_cache()
    res["entry_launches"] = entry
    print(json.dumps({"grouped_gemm": name, **res}), flush=True)
    return res


def moe_phase(torch, gg):
    """The MoE layer at MOE_FULL on one card: the main path's call with
    its launch count (two of the 3xTF32 grouped kernel), then the same
    layer on the plain grouped GEMM, the forward's median time, and one
    call under torch.profiler; then the layer again in bfloat16, as
    Mixtral serves (two launches of the TMA grouped kernel), against the
    same layer on the plain GEMMs in bfloat16, and its median time."""
    from tilelang_mesh_tpu_torch.parallel import moe
    c = MOE_FULL
    x, wr, w1, w2 = moe_inputs(torch)
    layer = moe.make_moe_layer(None, top_k=c["top_k"],
                               capacity_factor=c["capacity_factor"])

    def main_path(args, kernel):
        """One call, counters zeroed before and read right after: two
        launches of ``kernel`` and no other grouped launch."""
        torch.cuda.synchronize()
        gg.reset_launches()
        t0 = time.perf_counter()
        out = layer(*args)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = {k: v for k, v in gg.launches.items() if v}
        check(launches == {kernel: 2},
              f"grouped launches {launches} in one layer call, want two "
              f"{kernel}")
        check(tuple(out.shape) == (c["tokens"], c["d"])
              and bool(torch.isfinite(out).all()), "bad MoE output")
        return out, first_s, dict(gg.launches)

    def plain_layer(args):
        kernel_gemm = moe.grouped_matmul     # the same layer, plain GEMMs
        moe.grouped_matmul = lambda a, b, **_: gg.grouped_matmul_plain(a, b)
        try:
            return layer(*args)
        finally:
            moe.grouped_matmul = kernel_gemm

    def median_ms(args, kernel):
        layer(*args)                         # warm-up
        gg.reset_launches()
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            layer(*args)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        check(gg.launches[kernel] == 10,
              f"{gg.launches[kernel]} {kernel} launches in 5 calls")
        return times, sorted(times)[len(times) // 2]

    args = (x, wr, w1, w2)
    torch.cuda.synchronize()
    reset_peak(torch)
    out, first_s, launches = main_path(args, "grouped_gemm_tf32x3")
    call_peak = torch.cuda.max_memory_allocated()
    want = plain_layer(args)
    # the (token, slot) pairs the dispatch keeps, against what the
    # capacity allows: expert e's takers fill places 0, 1, ... in slot
    # order, so it keeps min(takers, C) of them
    C = moe_capacity()
    kept = int(moe.route(x, wr, c["top_k"], C)[1].count_nonzero())
    takers = torch.bincount(torch.topk(x.float() @ wr.float(), c["top_k"],
                                       dim=-1)[1].flatten(),
                            minlength=c["experts"])
    allowed = int(takers.clamp(max=C).sum())
    check(kept == allowed, f"the dispatch keeps {kept} pairs, the "
                           f"capacity allows {allowed}")
    err, rel = normwise_err(out, want)
    check(rel <= MOE_TOL, f"MoE layer disagrees with the plain path: "
                          f"{rel:.3e} of max |plain| > {MOE_TOL}")
    del out, want
    times, med = median_ms(args, "grouped_gemm_tf32x3")
    profile = device_breakdown(torch, lambda: layer(*args))
    res = {"config": {**c, "capacity": moe_capacity()},
           "first_call_ms": first_s * 1e3, "forward_ms": times,
           "forward_ms_median": med,
           "tokens_per_s": c["tokens"] / (med / 1e3),
           "launches": launches, "kept_pairs": kept,
           "kept_pairs_allowed": allowed,
           "dropped_pairs": c["tokens"] * c["top_k"] - kept,
           "max_abs_err": err, "normwise_err": rel,
           "tolerance": f"normwise {MOE_TOL}",
           # the main-path call alone, then the whole phase (the plain
           # path's call, the timed calls and the profiled one too)
           "max_memory_allocated_bytes": call_peak,
           "phase_max_memory_allocated_bytes":
               torch.cuda.max_memory_allocated(),
           "profile": profile}

    # -- the layer in bfloat16 ---------------------------------------------
    args = tuple(t.bfloat16() for t in args)
    del x, wr, w1, w2
    torch.cuda.empty_cache()
    out, first_s, launches = main_path(args, "grouped_gemm_tma")
    err, rel = normwise_err(out, plain_layer(args))
    check(rel <= MOE_BF16_TOL, f"MoE layer in bfloat16 disagrees with the "
                               f"plain path: {rel:.3e} of max |plain| > "
                               f"{MOE_BF16_TOL}")
    del out
    times, med = median_ms(args, "grouped_gemm_tma")
    res["bfloat16"] = {"first_call_ms": first_s * 1e3, "forward_ms": times,
                       "forward_ms_median": med,
                       "tokens_per_s": c["tokens"] / (med / 1e3),
                       "launches": launches, "max_abs_err": err,
                       "normwise_err": rel,
                       "tolerance": f"normwise {MOE_BF16_TOL}"}
    print(json.dumps(res), flush=True)
    del args
    torch.cuda.empty_cache()
    return res


def ring_phase(torch, fa):
    """Ring attention on one rank at the model's attention shapes, causal
    and not: each call the main path (one partial-kernel launch, read
    right after), against the plain attention on the card, then timed."""
    from tilelang_mesh_tpu_torch.parallel import make_ring_attention
    B, H, S, D = 2, 16, 4096, 128
    g = torch.Generator(device="cuda").manual_seed(6)
    q, k, v = (torch.randn((B, H, S, D), generator=g, device="cuda")
               for _ in range(3))
    sm = 1.0 / math.sqrt(D)
    tol = ATTN_TOL["float32"]
    res = {"shape": [B, H, S, D], "dtype": "float32",
           "tolerance": f"normwise {tol}"}
    for causal in (True, False):
        layer = make_ring_attention(None, causal=causal)
        torch.cuda.synchronize()
        fa.reset_launches()              # the main path starts here
        out = layer(q, k, v)
        torch.cuda.synchronize()
        launches = dict(fa.launches)               # read right after
        check(launches == {"mha_fwd": 0, "mha_fwd_partial": 1},
              f"ring attention (causal={causal}) launches {launches}, "
              f"want one partial launch")
        want = fa.mha_fwd_plain(q, k, v, causal, sm)
        err, rel = normwise_err(out, want)
        check(bool(torch.isfinite(out).all()) and rel <= tol,
              f"ring attention (causal={causal}) disagrees with the plain "
              f"attention: {rel:.3e} of max |plain| > {tol}")
        del out, want
        res["causal" if causal else "full"] = {
            "launches": launches["mha_fwd_partial"], "max_abs_err": err,
            "normwise_err": rel, "ms": cuda_ms(torch, lambda: layer(q, k, v),
                                               5)}
    print(json.dumps({"ring": res}), flush=True)
    del q, k, v
    torch.cuda.empty_cache()
    return res


def draw_np(seed, *shapes):
    """cfg_gemm's inputs: ``standard_normal(shape) * 0.1`` from one
    ``default_rng(seed)``, in order, as float32 numpy arrays."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * 0.1).astype(np.float32)
            for s in shapes]


def mm_bound(flops, nbytes, peak):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def gemm_ops_phase(torch, gm, dqg):
    """The GEMM entry points at bench.py's shapes: each call the main
    path (counters zeroed before it, read right after: exactly one launch
    of its kernel, the two-pass path one unpack and one matmul), its
    output against the plain version on the card, then the device times
    of the kernel, the plain version and a library yardstick, and the
    bound."""
    import ctypes

    import numpy as np
    from tilelang_mesh_tpu_torch.ops._build import load as _load_lib
    from tilelang_mesh_tpu_torch.ops.gemm import DTYPE_CODES
    from tilelang_mesh_tpu_torch.quantize import quantize_int4_planar
    counted = {**dict.fromkeys(gm.launches, 0),
               **dict.fromkeys(dqg.launches, 0)}
    res = {}

    def drive(label, call, want_launches):
        """One main-path call; its launches, read right after."""
        torch.cuda.synchronize()
        gm.reset_launches()
        dqg.reset_launches()
        out = call()
        torch.cuda.synchronize()
        got = {**gm.launches, **dqg.launches}
        want = {k: want_launches.get(k, 0) for k in got}
        check(got == want, f"{label}: launches {got}, want {want}")
        for k, n in got.items():
            counted[k] += n
        return out

    def hold(label, got, want, tol):
        check(tuple(got.shape) == tuple(want.shape)
              and got.dtype == want.dtype, f"{label}: {got.dtype} "
              f"{tuple(got.shape)}, plain {want.dtype} {tuple(want.shape)}")
        check(bool(torch.isfinite(got.float()).all()),
              f"{label}: non-finite output")
        err, rel = normwise_err(got, want)
        check(rel <= tol, f"{label} disagrees with its plain version: "
                          f"{rel:.3e} of max |plain| > {tol}")
        return {"max_abs_err": err, "normwise_err": rel,
                "tolerance": f"normwise {tol}"}

    def timed(kern, plain, library, iters=5):
        """Device times (kernel, plain, library; ``device_ms``) and the
        kernel's wrapper calls timed as issued (``call_ms``: the host's
        time between launches included)."""
        return {"ms": device_ms(torch, kern, iters),
                "call_ms": cuda_ms(torch, kern, iters),
                "plain_ms": device_ms(torch, plain, 3),
                "library_ms": (None if library is None
                               else device_ms(torch, library, iters))}

    def fp8(x):
        return torch.from_numpy(x).cuda().to(torch.float8_e4m3fn)

    # -- #15 matmul ------------------------------------------------------
    cases = [("bf16_1024", 0, (1024, 1024, 1024), torch.bfloat16, None,
              (False, False), False),
             ("bf16_8192x8192x4096", 0, (8192, 8192, 4096), torch.bfloat16,
              None, (False, False), False)]
    cases += [(f"f32_4096_{int(ta)}{int(tb)}", 1, (4096,) * 3,
               torch.float32, None, (ta, tb), False)
              for ta in (False, True) for tb in (False, True)]
    cases += [(f"bf16_4096_{int(ta)}{int(tb)}", 1, (4096,) * 3,
               torch.bfloat16, None, (ta, tb), False)
              for ta in (False, True) for tb in (False, True)]
    cases += [("f32_4096_relu", 1, (4096,) * 3, torch.float32, None,
               (False, True), True),
              ("fp8_f32_4096", 2, (4096,) * 3, torch.float8_e4m3fn,
               torch.float32, (False, False), False),
              ("f16_4096", 1, (4096,) * 3, torch.float16, None,
               (False, False), False),
              ("int8_i32_4096", 1, (4096,) * 3, torch.int8, torch.int32,
               (False, False), False)]
    for label, seed, (M, N, K), dt, out, (ta, tb), relu in cases:
        a_shape, b_shape = (K, M) if ta else (M, K), (N, K) if tb else (K, N)
        if dt == torch.int8:
            rng = np.random.default_rng(seed)
            a, b = (torch.from_numpy(rng.integers(-128, 128, s).astype(
                np.int8)).cuda() for s in (a_shape, b_shape))
        else:
            a_np, b_np = draw_np(seed, a_shape, b_shape)
            if dt == torch.float8_e4m3fn:
                a, b = fp8(a_np), fp8(b_np)
            else:
                a = torch.from_numpy(a_np).cuda().to(dt)
                b = torch.from_numpy(b_np).cuda().to(dt)
            del a_np, b_np
        out_dt = out or dt
        # the int8 product is matmul_kernel's, with its int32 accumulator
        kern = gm.matmul_kernel(
            M, N, K, in_dtype=dt, out_dtype=out_dt,
            accum_dtype=torch.int32 if dt == torch.int8 else torch.float32,
            trans_A=ta, trans_B=tb, relu=relu)
        path = "loop" if dt == torch.int8 else gm.matmul_path(
            M, N, K, dt, ta, tb, a.data_ptr(), b.data_ptr(), out_dt,
            gm.kernel_block(M, N, K, dt))
        # every 16-bit and fp8 shape at the bench widths takes the TMA path
        check(path == "tma" or dt not in gm.TMA_TYPES,
              f"matmul {label}: took the {path} path")
        kname = MATMUL_PATH_KERNELS[path]
        want_launches = {kname: 1}
        if dt == torch.float8_e4m3fn:
            want_launches["fp8_widen"] = 1
        got = drive(f"matmul {label}", lambda: kern(a, b), want_launches)
        want = gm.matmul_plain(a, b, ta, tb, out_dt, relu)
        name = str(out_dt).replace("torch.", "")
        r = hold(f"matmul {label}", got, want, GEMM_OPS_TOL[name])
        if dt == torch.int8:
            check(torch.equal(got, want), f"matmul {label}: int32 sums "
                                          f"differ from the plain version")
        del got, want
        lhs = a.T if ta else a
        rhs = b.T if tb else b
        if dt == torch.int8:              # cuBLASLt int8, column-major B
            bcol = rhs.T.contiguous().T

            def library():
                return torch._int_mm(lhs, bcol)
            lib_name = "torch._int_mm"
        elif dt == torch.float8_e4m3fn:   # cuBLASLt fp8, unit scales
            one = torch.ones((), device="cuda")
            bcol = rhs.T.contiguous().T               # column-major

            def library():
                return torch._scaled_mm(lhs, bcol, scale_a=one, scale_b=one,
                                        out_dtype=torch.float32)
            lib_name = "torch._scaled_mm (unit scales)"
        else:
            def library():
                return torch.matmul(lhs, rhs)
            lib_name = f"torch.matmul in {dt}"
        esize = a.element_size()
        peak = {torch.float32: PEAK_F32_FLOPS, torch.bfloat16:
                PEAK_BF16_FLOPS, torch.float16: PEAK_BF16_FLOPS}.get(
                    dt, PEAK_8BIT_OPS)
        flops = 2 * M * N * K
        nbytes = (M * K + K * N) * esize + M * N * torch.empty(
            (), dtype=out_dt).element_size()
        bound, by = mm_bound(flops, nbytes, peak)
        res[f"{kname}_{label}"] = {
            "shape": [M, N, K], "dtype": str(dt), "out": name,
            "trans": [ta, tb], "relu": relu, "path": path, **r,
            **timed(lambda: kern(a, b),
                    lambda: gm.matmul_plain(a, b, ta, tb, out_dt, relu),
                    library),
            "library": lib_name, "bound_ms": bound, "bound_by": by,
            "flops": flops, "bytes": nbytes}
        if dt == torch.float8_e4m3fn:     # the TMA path's fp8 pre-pass
            got = drive("fp8_widen 4096", lambda: gm.fp8_widen(a, b),
                        {"fp8_widen": 1})
            want = gm.fp8_widen_plain(a, b)
            check(all(torch.equal(g.view(torch.int16), w.view(torch.int16))
                      for g, w in zip(got, want)),
                  "fp8_widen is not bit-equal to its plain version")
            nb = 3 * (a.numel() + b.numel())
            wb, wby = mm_bound(0, nb, PEAK_BF16_FLOPS)
            res["fp8_widen_4096"] = {
                "shape": [list(a.shape), list(b.shape)], "max_abs_err": 0.0,
                **timed(lambda: gm.fp8_widen(a, b),
                        lambda: gm.fp8_widen_plain(a, b), None),
                "bound_ms": wb, "bound_by": wby, "bytes": nb}
            del got, want
        del a, b, lhs, rhs
        torch.cuda.empty_cache()

    # -- #22, #23, two-pass: w4a16 ---------------------------------------
    # dequant_path's kernels a call: the TMA kernel at 4096^3, the split-K
    # and its combine at the decode step, the block tile loop in f32
    w4_launches = {"wgmma": {"dequant_gemm_wgmma": 1},
                   "splitk": {"dequant_gemm_splitk": 1,
                              "dequant_splitk_combine": 1},
                   "loop": {"dequant_gemm": 1}}
    for label, (M, K, N, gs), seed, dtypes in (
            ("4096_gs512", (4096, 4096, 4096, 512), 3,
             (torch.bfloat16, torch.float16)),
            ("decode_m16_k4096_n11008_gs128",
             tuple(LLAMA2_MLP[k] for k in ("M", "K", "N", "gs")), 14,
             (torch.bfloat16, torch.float16, torch.float32))):
        rng = np.random.default_rng(seed)      # as cfg_w4a16 draws them
        a_np = (rng.standard_normal((M, K)) * 0.1).astype(np.float32)
        w_np = rng.standard_normal((K, N)).astype(np.float32) * 0.1
        packed_np, scales_np = quantize_int4_planar(w_np, group_size=gs)
        del w_np
        packed = torch.from_numpy(packed_np).cuda()
        scales = torch.from_numpy(scales_np).cuda()
        K2 = K // 2
        for dt in dtypes:
            a = torch.from_numpy(a_np).cuda().to(dt)
            path = dqg.dequant_path(M, N, K2, gs, dt, a.data_ptr(),
                                    packed.data_ptr(), scales.data_ptr())
            want_path = ("loop" if dt == torch.float32 else
                         "splitk" if M <= dqg.SPLITK_MAX_ROWS else "wgmma")
            check(path == want_path, f"dequant_matmul {label} {dt}: path "
                                     f"{path}, want {want_path}")
            kname = {"wgmma": "dequant_gemm_wgmma",
                     "splitk": "dequant_gemm_splitk",
                     "loop": "dequant_gemm"}[path]
            case = label + ("" if dt == torch.bfloat16 else
                            "_" + str(dt)[6:])
            got = drive(f"dequant_matmul {case}", lambda: dqg.dequant_matmul(
                a, packed, scales, group_size=gs, block_K2=gs),
                w4_launches[path])
            want = dqg.dequant_matmul_plain(a, packed, scales, gs)
            r = hold(f"dequant_matmul {case}", got, want,
                     GEMM_OPS_TOL[str(dt)[6:]])
            if path == "splitk":      # the combine's fixed order: two runs
                again = dqg.dequant_matmul(a, packed, scales, group_size=gs,
                                           block_K2=gs)
                check(torch.equal(got.view(torch.uint8),
                                  again.view(torch.uint8)),
                      f"dequant_matmul {case}: two runs differ")
                del again
            del got, want
            bd = dqg.dequant_int4_plain(packed, scales, gs, dt)
            flops = 2 * M * N * K
            esize = a.element_size()
            nbytes = (M * K * esize + K2 * N + scales.numel() * 4
                      + M * N * esize)
            bound, by = mm_bound(flops, nbytes, PEAK_F32_FLOPS
                                 if dt == torch.float32 else PEAK_BF16_FLOPS)
            res[f"{kname}_{case}"] = {
                "shape": [M, N, K], "group_size": gs, "dtype": str(dt)[6:],
                "path": path, **r,
                **timed(lambda: dqg.dequant_matmul(
                    a, packed, scales, group_size=gs, block_K2=gs),
                    lambda: dqg.dequant_matmul_plain(a, packed, scales, gs),
                    lambda: torch.matmul(a, bd)),
                "library": f"torch.matmul on the dequantised {str(dt)[6:]} "
                           f"weight (excludes the dequant)",
                "bound_ms": bound, "bound_by": by, "flops": flops,
                "bytes": nbytes}
            if path == "splitk":      # the combine alone, on the partials
                _, splits, rows = dqg.dequant_splitk_plan(
                    N, K2, torch.cuda.get_device_properties(
                        0).multi_processor_count)
                ws = torch.randn((splits, M, N), device="cuda")
                lib = _load_lib("dequant_gemm")
                comb = lib.tl_dequant_splitk_combine
                comb.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 \
                    + [ctypes.c_void_p]
                comb.restype = ctypes.c_int
                c_out = torch.empty((M, N), dtype=dt, device="cuda")

                def combine():
                    code = comb(ws.data_ptr(), c_out.data_ptr(), M, N,
                                splits, DTYPE_CODES[dt],
                                torch.cuda.current_stream().cuda_stream)
                    check(code == 0, f"tl_dequant_splitk_combine: {code}")
                    return c_out

                def combine_plain():
                    return ws.sum(0).to(dt)

                rc = hold(f"dequant_splitk_combine {case}", combine().clone(),
                          combine_plain(), GEMM_OPS_TOL[str(dt)[6:]])
                nb = ws.numel() * 4 + M * N * esize
                cb, cby = mm_bound(0, nb, PEAK_BF16_FLOPS)
                res[f"dequant_splitk_combine_{case}"] = {
                    "shape": [splits, M, N], **rc,
                    **timed(combine, combine_plain, None),
                    "bound_ms": cb, "bound_by": cby, "bytes": nb}
                del ws, c_out
            if label.startswith("4096") and dt == torch.bfloat16:
                # bench's w4a16: the two-pass path
                two = drive(f"dequant_matmul_twopass {label}",
                            lambda: dqg.dequant_matmul_twopass(a, packed,
                                                               scales),
                            {"dequant_int4": 1, "matmul_tma": 1})
                r2 = hold(f"dequant_matmul_twopass {label}", two,
                          gm.matmul_plain(a, bd), GEMM_OPS_TOL["bfloat16"])
                del two
                got = dqg.dequant_int4(packed, scales, gs, torch.bfloat16)
                r3 = hold(f"dequant_int4 {label}", got, bd,
                          GEMM_OPS_TOL["dequant_int4"])
                check(torch.equal(got.view(torch.int16),
                                  bd.view(torch.int16)),
                      "dequant_int4 is not bit-equal to its plain version")
                del got
                nb3 = K2 * N + scales.numel() * 4 + K * N * 2
                b3, by3 = mm_bound(0, nb3, PEAK_BF16_FLOPS)
                res[f"dequant_int4_{label}"] = {
                    "shape": [K2, N], "group_size": gs, **r3,
                    **timed(lambda: dqg.dequant_int4(packed, scales, gs,
                                                     torch.bfloat16),
                            lambda: dqg.dequant_int4_plain(
                                packed, scales, gs, torch.bfloat16),
                            None),
                    "bound_ms": b3, "bound_by": by3, "bytes": nb3}
                res[f"twopass_{label}"] = {
                    **r2, **timed(lambda: dqg.dequant_matmul_twopass(
                        a, packed, scales), lambda: gm.matmul_plain(
                            a, dqg.dequant_int4_plain(packed, scales, gs,
                                                      torch.bfloat16)),
                        None)}
            del a, bd
            torch.cuda.empty_cache()
        del packed, scales
        torch.cuda.empty_cache()

    # -- #24 w4a8: bench's 4096^3 and a 16-token decode step (the TMA
    # kernel) and N 4104 (off 16 bytes: the tile loop) ------------------
    for label, (M, N, K), want_path in (
            ("4096", (4096, 4096, 4096), "tma"),
            ("decode_m16", (16, 4096, 4096), "tma"),
            ("m4096_n4104", (4096, 4104, 4096), "loop")):
        rng = np.random.default_rng(9)          # as cfg_w4a8 draws them
        x_np = rng.standard_normal((M, K)).astype(np.float32)
        w_np = rng.standard_normal((K, N)).astype(np.float32) * 0.1
        packed_np, sw_np = dqg.quantize_w4_per_channel(w_np)
        del w_np
        x = torch.from_numpy(x_np).cuda()
        packed = torch.from_numpy(packed_np).cuda()
        sw = torch.from_numpy(sw_np).cuda()
        path = dqg.w4a8_path(M, N, K // 2)
        check(path == want_path,
              f"w4a8 {label}: w4a8_path {path}, want {want_path}")
        kname = {"tma": "w4a8_gemm_tma", "loop": "w4a8_gemm"}[path]
        got = drive(f"w4a8_matmul {label}", lambda: dqg.w4a8_matmul(
            x, packed, sw), {kname: 1})
        q, s = dqg.quantize_activations(x)
        sa = (1.0 / s).float()
        want = dqg.w4a8_gemm_plain(q, packed, sw, sa)
        r = hold(f"w4a8_matmul {label}", got, want, GEMM_OPS_TOL["w4a8"])
        del got, want
        p32 = packed.to(torch.int32)
        # the unpacked weight, column-major as cuBLASLt's int8 path takes
        # it (which wants more than 16 rows: none at the decode step)
        wd8 = torch.cat([(p32 & 0xF) - 8, (p32 >> 4) - 8]).to(
            torch.int8).T.contiguous().T
        del p32
        flops = 2 * M * N * K
        nbytes = M * K + K * N // 2 + 4 * (N + M) + 4 * M * N
        bound, by = mm_bound(flops, nbytes, PEAK_8BIT_OPS)
        res[f"{kname}_{label}"] = {
            "shape": [M, N, K], "path": path, **r,
            **timed(lambda: dqg.w4a8_gemm(q, packed, sw, sa),
                    lambda: dqg.w4a8_gemm_plain(q, packed, sw, sa),
                    None if M <= 16 else lambda: torch._int_mm(q, wd8)),
            "library": "torch._int_mm on the unpacked int8 weight "
                       "(excludes the epilogue)" if M > 16 else None,
            "bound_ms": bound, "bound_by": by, "flops": flops,
            "bytes": nbytes}
        if label == "4096":
            res[f"{kname}_{label}"]["entry_ms"] = device_ms(
                torch, lambda: dqg.w4a8_matmul(x, packed, sw), 5)
        del x, packed, sw, q, s, sa, wd8
        torch.cuda.empty_cache()
    res["launches"] = counted
    print(json.dumps({"gemm": res}), flush=True)
    return res


# matmul_path's answer -> the kernel (launch counter) of ops/gemm.py
MATMUL_PATH_KERNELS = {"tma": "matmul_tma", "ffma": "matmul_ffma",
                       "loop": "matmul"}
# the gemm phase's kernels: (name, source, replaced TPU kernel, headline
# case); the kernel's other cases are nested under "variants". #15 is
# three kernels of gemm.cu, one a path of matmul_path (int8 on the tile
# loop's counter, gemm_s8.cu); #22 three of dequant_gemm.cu and the
# split-K's combine, by dequant_path; #24 two, by w4a8_path
GEMM_OPS_KERNELS = (
    ("matmul_tma", "gemm.cu", "tilelang_mesh_tpu/ops/gemm.py:18",
     "bf16_8192x8192x4096"),
    ("matmul_ffma", "gemm.cu", "tilelang_mesh_tpu/ops/gemm.py:18",
     "f32_4096_00"),
    ("matmul", "gemm.cu", "tilelang_mesh_tpu/ops/gemm.py:18",
     "f32_4096_01"),
    ("dequant_gemm_wgmma", "dequant_gemm.cu",
     "tilelang_mesh_tpu/ops/dequant_gemm.py:62", "4096_gs512"),
    ("dequant_gemm_splitk", "dequant_gemm.cu",
     "tilelang_mesh_tpu/ops/dequant_gemm.py:62",
     "decode_m16_k4096_n11008_gs128"),
    ("dequant_splitk_combine", "dequant_gemm.cu",
     "tilelang_mesh_tpu/ops/dequant_gemm.py:62",
     "decode_m16_k4096_n11008_gs128"),
    ("dequant_gemm", "dequant_gemm.cu",
     "tilelang_mesh_tpu/ops/dequant_gemm.py:62",
     "decode_m16_k4096_n11008_gs128_float32"),
    ("dequant_int4", "dequant_gemm.cu",
     "tilelang_mesh_tpu/ops/dequant_gemm.py:127", "4096_gs512"),
    ("w4a8_gemm_tma", "dequant_gemm.cu",
     "tilelang_mesh_tpu/ops/dequant_gemm.py:204", "4096"),
    ("w4a8_gemm", "dequant_gemm.cu",
     "tilelang_mesh_tpu/ops/dequant_gemm.py:204", "m4096_n4104"))


def kernel_entries(res, kernels):
    """The ``kernels`` line's entries of a phase's kernels: ``kernels``
    holds (name, source, replaced TPU kernel, headline case); the
    phase's other timed cases of a kernel are nested under "variants",
    and a case's library call and the port's ``matmul`` on the same
    operands come along where the phase took them."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    out = []
    for name, source, replaces, head in kernels:
        prefix = f"{name}_"
        # cases of another kernel whose name extends this one's
        theirs = tuple(f"{n}_" for n, *_ in kernels
                       if n != name and n.startswith(prefix))
        top = res[prefix + head]
        entry = {
            "name": name, "route": "cuda",
            "source": "tilelang_mesh_tpu_torch/csrc/" + source,
            "replaces": replaces, "launches": res["launches"][name],
            **{k: top[k] for k in keys}, "case": head,
            "variants": {c[len(prefix):]: {k: v[k] for k in keys
                                           + ("matmul_ms",) if k in v}
                         for c, v in res.items() if c.startswith(prefix)
                         and not c.startswith(theirs)
                         and c != prefix + head and "ms" in v}}
        entry.update({k: top[k] for k in ("library", "matmul_ms")
                      if k in top})
        out.append(entry)
    return out


def gemm_variants_phase(torch, gv, gm):
    """The GEMM scheduling variants at LLaMA-2-7B's widths (LLAMA2): each
    main-path call with the counters zeroed before it and read right
    after (split-K and stream-K two launches a call: the partials and
    their sum; GEMV and block-sparse one), its output against the plain
    version on the card, block-sparse's dead cells exactly 0 and its
    all-ones mask against matmul; then the device times of the kernel,
    the plain version, a library call and the port's matmul on the same
    operands, and the bound."""
    import numpy as np
    # the counters by kernel: the GEMV's by name (kernel_launches["gemv"],
    # the old kernel, in place of launches["gemv"], every GEMV call)
    counted = dict.fromkeys({**gv.launches, **gv.kernel_launches}, 0)
    res = {}
    reset_peak(torch)
    hid, inter = LLAMA2["hidden"], LLAMA2["inter"]

    def drive(label, call, want_launches, main=True, kernel=None):
        torch.cuda.synchronize()
        gv.reset_launches()
        gm.reset_launches()
        out = call()
        torch.cuda.synchronize()
        got = {**gv.launches, "matmul": gm.launches["matmul"]}
        want = {k: want_launches.get(k, 0) for k in got}
        check(got == want, f"{label}: launches {got}, want {want}")
        ran = [k for k, n in gv.kernel_launches.items() if n]
        check(kernel is None or ran == [kernel],
              f"{label}: launched {ran}, the path rule names {kernel}")
        got.update(gv.kernel_launches)
        for k in counted:
            counted[k] += got[k] if main else 0
        return out

    def hold(label, got, want):
        tol = GEMM_TOL[str(want.dtype).replace("torch.", "")]
        check(tuple(got.shape) == tuple(want.shape)
              and got.dtype == want.dtype, f"{label}: {got.dtype} "
              f"{tuple(got.shape)}, plain {want.dtype} {tuple(want.shape)}")
        check(bool(torch.isfinite(got.float()).all()),
              f"{label}: non-finite output")
        err, rel = normwise_err(got, want)
        check(rel <= tol, f"{label} disagrees with its plain version: "
                          f"{rel:.3e} of max |plain| > {tol}")
        return {"max_abs_err": err, "normwise_err": rel,
                "tolerance": f"normwise {tol}"}

    def timed(kern, plain, library, matmul=None, iters=5):
        out = {"ms": device_ms(torch, kern, iters),
               "plain_ms": device_ms(torch, plain, 2),
               "library_ms": device_ms(torch, library, iters)}
        if matmul is not None:
            out["matmul_ms"] = device_ms(torch, matmul, iters)
        return out

    def operands(seed, *shapes, dtype=torch.bfloat16):
        return [torch.from_numpy(x).cuda().to(dtype)
                for x in draw_np(seed, *shapes)]

    def bound(dtype, flops, nbytes):
        peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
        t, by = mm_bound(flops, nbytes, peak)
        return {"bound_ms": t, "bound_by": by, "flops": flops,
                "bytes": nbytes}

    # -- #16 split-K: a 16-token decode step's MLP products (the few-row
    # path, splitk_stream), and past its rows a 128-token chunk (the tile
    # loop, splitk_gemm) ---------------------------------------------------
    for label, (M, K, N), dt, seed in (
            ("decode_gate_up_bf16", (LLAMA2["decode"], hid, inter),
             torch.bfloat16, 30),
            ("decode_down_bf16", (LLAMA2["decode"], inter, hid),
             torch.bfloat16, 31),
            ("decode_gate_up_f32", (LLAMA2["decode"], hid, inter),
             torch.float32, 30),
            ("m128_gate_up_bf16", (128, hid, inter), torch.bfloat16, 35)):
        a, b = operands(seed, (M, K), (K, N), dtype=dt)
        n_ask = LLAMA2["n_split"]
        n_split, split_len, _ = gv.splitk_plan(K, n_ask)
        path = gv.splitk_path(M, N, K, dt, a.data_ptr(), b.data_ptr())
        check(path == ("stream" if M <= gv.SPLITK_STREAM_MAX_ROWS
                       else "tile"), f"split-K {label}: path {path}")
        kname, fix = {"stream": ("splitk_stream", "splitk_stream_combine"),
                      "tile": ("splitk_gemm", "splitk_reduce")}[path]
        parts = n_split
        if path == "stream":
            parts *= gv.splitk_stream_plan(
                N, n_split, split_len, gv.stream_slots(a.device, M, dt))[1]
        print(f"split-K {label}: {n_ask} splits asked, {n_split} taken "
              f"(chunks of {split_len}), {kname}, {parts} partials",
              flush=True)
        got = drive(f"matmul_splitk {label}", lambda: gv.matmul_splitk(
            a, b, n_split=n_ask), {kname: 1, fix: 1})
        r = hold(f"matmul_splitk {label}", got,
                 gv.matmul_splitk_plain(a, b, n_split=n_ask))
        if path == "stream":    # the fixed order of sums: the same bits
            check(torch.equal(got, gv.matmul_splitk(a, b, n_split=n_ask)),
                  f"matmul_splitk {label}: two calls differ")
        del got
        res[f"{kname}_{label}"] = {
            "shape": [M, N, K], "dtype": str(dt), "n_split_asked": n_ask,
            "n_split": n_split, "path": path, "partials": parts,
            "launches_a_call": 2, **r,
            **timed(lambda: gv.matmul_splitk(a, b, n_split=n_ask),
                    lambda: gv.matmul_splitk_plain(a, b, n_split=n_ask),
                    lambda: torch.matmul(a, b), lambda: gm.matmul(a, b),
                    iters=20 if M <= 16 else 5),
            "library": "torch.matmul in " + str(dt).replace("torch.", ""),
            "workspace_bytes": parts * M * N * 4,
            **bound(dt, 2 * M * N * K,
                    (M * K + K * N + M * N) * a.element_size())}
        del a, b

    # -- #17 stream-K: a 512-token prefill chunk's gate/up, bf16 at the
    # default 128 x 128 blocks and at 128 x 256 (the TMA kernel); f32 at
    # 128 x 128, and bf16 with A's base 4 bytes off 16 (the tile loop) ---
    M, K, N = LLAMA2["prefill_chunk"], hid, inter
    for label, dt, (bm, bn), off, want_path in (
            ("prefill_gate_up_bf16", torch.bfloat16, (128, 128), 0, "tma"),
            ("prefill_gate_up_bf16_128x256", torch.bfloat16, (128, 256), 0,
             "tma"),
            ("prefill_gate_up_f32", torch.float32, (128, 128), 0, "loop"),
            ("prefill_gate_up_bf16_misaligned", torch.bfloat16, (128, 128),
             2, "loop")):
        a, b = operands(32, (M, K), (K, N), dtype=dt)
        if off:      # the same values, ``off`` elements into their storage
            buf = torch.empty(M * K + off, dtype=dt, device=a.device)
            a = buf[off:].view(M, K).copy_(a)
            del buf
        blocks = dict(block_M=bm, block_N=bn, block_K=128)
        path = gv.streamk_path(M, N, K, dt, bm, bn, 128, a.data_ptr(),
                               b.data_ptr())
        check(path == want_path, f"stream-K {label}: path {path}")
        kname = {"tma": "streamk_tma", "loop": "streamk_gemm"}[path]
        slots = gv.streamk_programs(a.device, dt, **blocks,
                                    a_ptr=a.data_ptr(), b_ptr=b.data_ptr())
        n_prog = gv.streamk_phase_programs(M, N, K, bm, bn, 128, slots)
        n_tiles = (M // bm) * (N // bn)
        n_seg = len(gv._streamk_segments(n_tiles, K // 128, n_prog))
        part_bytes = n_seg * bm * bn * 4
        print(f"stream-K {label}: {kname}, {n_prog} programs (the tile "
              f"rows in phase; {slots} co-resident blocks), {n_seg} "
              f"segments over {n_tiles} tiles, {part_bytes} partial bytes",
              flush=True)
        got = drive(f"matmul_streamk {label}", lambda: gv.matmul_streamk(
            a, b, n_programs=n_prog, **blocks),
            {kname: 1, "streamk_fixup": 1})
        r = hold(f"matmul_streamk {label}", got,
                 gv.matmul_streamk_plain(a, b, n_programs=n_prog, **blocks))
        del got
        res[f"{kname}_{label}"] = {
            "shape": [M, N, K], "dtype": str(dt), "block": [bm, bn, 128],
            "path": path, "a_offset_bytes": off * a.element_size(),
            "slots": slots, "n_programs": n_prog, "n_segments": n_seg,
            "partial_bytes": part_bytes, "launches_a_call": 2, **r,
            **timed(lambda: gv.matmul_streamk(a, b, n_programs=n_prog,
                                              **blocks),
                    lambda: gv.matmul_streamk_plain(a, b, n_programs=n_prog,
                                                    **blocks),
                    lambda: torch.matmul(a, b), lambda: gm.matmul(a, b)),
            "library": "torch.matmul in " + str(dt).replace("torch.", ""),
            **bound(dt, 2 * M * N * K, (M * K + K * N + M * N)
                    * a.element_size())}
        del a, b

    # -- #18 GEMV: one token's gate/up and LM head (gemv_bulk), and the
    # gate/up with the activation's base 2 bytes off 16 (the old kernel) --
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, N, dt, seed, off in (
            ("decode_gate_up_bf16", inter, torch.bfloat16, 33, 0),
            ("decode_gate_up_f32", inter, torch.float32, 33, 0),
            ("lm_head_bf16", LLAMA2["vocab"], torch.bfloat16, 34, 0),
            ("decode_gate_up_bf16_misaligned", inter, torch.bfloat16, 33,
             1)):
        x, w = operands(seed, (hid,), (N, hid), dtype=dt)
        if off:      # the same values, ``off`` elements into their storage
            buf = torch.empty(hid + off, dtype=dt, device=x.device)
            x = buf[off:].copy_(x)
            del buf
        kname = gv.gemv_path(N, hid, dt, x.data_ptr(), w.data_ptr(), sms)
        check(kname == ("gemv" if off else "gemv_bulk"),
              f"gemv {label}: path {kname}")
        plan = gv.gemv_bulk_plan(N, hid, dt, sms)
        got = drive(f"gemv {label}", lambda: gv.gemv(x, w), {"gemv": 1},
                    kernel=kname)
        r = hold(f"gemv {label}", got, gv.gemv_plain(x, w))
        del got
        res[f"{kname}_{label}"] = {
            "shape": [N, hid], "dtype": str(dt), "kernel": kname,
            "x_offset_bytes": off * x.element_size(),
            "plan": plan._asdict() if kname == "gemv_bulk" else None, **r,
            **timed(lambda: gv.gemv(x, w), lambda: gv.gemv_plain(x, w),
                    lambda: torch.mv(w, x)),
            "library": "torch.mv in " + str(dt).replace("torch.", ""),
            **bound(dt, 2 * N * hid, (hid + N * hid + N) * x.element_size())}
        del x, w

    # -- #19 block-sparse: a 4096-token prefill's gate/up ------------------
    M, K, N = LLAMA2["prefill"], hid, inter
    rng = np.random.default_rng(0)    # as examples/blocksparse_gemm draws
    a = torch.from_numpy((rng.standard_normal((M, K)) * 0.1).astype(
        np.float32)).cuda().to(torch.bfloat16)
    b = torch.from_numpy((rng.standard_normal((K, N)) * 0.1).astype(
        np.float32)).cuda().to(torch.bfloat16)
    mask = torch.from_numpy((rng.random((M // 128, N // 128)) > 0.5).astype(
        np.int32)).cuda()
    density = float(mask.float().mean())
    # aligned bf16: the TMA kernel, at the tile of the 128-square cells
    check(gv.blocksparse_path(M, N, K, a.dtype, a.data_ptr(), b.data_ptr())
          == "tma", "blocksparse_matmul prefill: not on the TMA kernel")
    got = drive("blocksparse_matmul prefill", lambda: gv.blocksparse_matmul(
        a, b, mask), {"blocksparse_gemm": 1})
    r = hold("blocksparse_matmul prefill", got,
             gv.blocksparse_matmul_plain(a, b, mask))
    live = (mask != 0).repeat_interleave(128, 0).repeat_interleave(128, 1)
    check(not bool(got[~live].float().any()),
          "blocksparse_matmul: a dead cell holds a nonzero")
    del got, live
    ones = torch.ones_like(mask)
    dense = drive("blocksparse_matmul all-ones", lambda: gv.blocksparse_matmul(
        a, b, ones), {"blocksparse_gemm": 1}, main=False)
    err, rel = normwise_err(dense, gm.matmul(a, b))
    check(rel <= GEMM_TOL["bfloat16"], f"blocksparse_matmul all-ones: "
          f"{rel:.3e} of max |matmul| > {GEMM_TOL['bfloat16']}")
    del dense
    res["blocksparse_gemm_prefill_gate_up_bf16"] = {
        "shape": [M, N, K], "density": density, **r,
        "kernel": "blocksparse_tma (TMA + wgmma)",
        "tile": [128, 128, 64],
        "all_ones_vs_matmul_normwise": rel,
        **timed(lambda: gv.blocksparse_matmul(a, b, mask),
                lambda: gv.blocksparse_matmul_plain(a, b, mask),
                lambda: torch.matmul(a, b), lambda: gm.matmul(a, b)),
        "library": f"dense torch.matmul in bf16: 1/{density:.4f} of the "
                   f"masked product's work",
        **bound(torch.bfloat16, round(2 * M * N * K * density),
                (M * K + K * N + M * N) * 2)}
    del a, b, mask, ones
    torch.cuda.empty_cache()
    res["launches"] = counted
    res["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    print(json.dumps({"gemm_variants": res}), flush=True)
    return res


# the gemm_variants phase's kernels: (name, source, replaced TPU kernel,
# headline case), and the kernels that sum split-K's and stream-K's
# partials, named under "fixup"
VARIANT_KERNELS = (
    ("splitk_stream", "gemm_variants.cu",
     "tilelang_mesh_tpu/ops/gemm_variants.py:36", "decode_gate_up_bf16"),
    ("splitk_gemm", "gemm_variants.cu",
     "tilelang_mesh_tpu/ops/gemm_variants.py:36", "m128_gate_up_bf16"),
    ("streamk_tma", "gemm_variants.cu",
     "tilelang_mesh_tpu/ops/gemm_variants.py:104", "prefill_gate_up_bf16"),
    ("streamk_gemm", "gemm_variants.cu",
     "tilelang_mesh_tpu/ops/gemm_variants.py:104", "prefill_gate_up_f32"),
    ("gemv_bulk", "gemv.cu", "tilelang_mesh_tpu/ops/gemm_variants.py:169",
     "decode_gate_up_bf16"),
    ("gemv", "gemv.cu", "tilelang_mesh_tpu/ops/gemm_variants.py:169",
     "decode_gate_up_bf16_misaligned"),
    ("blocksparse_gemm", "gemm_variants.cu",
     "tilelang_mesh_tpu/ops/gemm_variants.py:206", "prefill_gate_up_bf16"))
VARIANT_FIXUPS = {"splitk_stream": "splitk_stream_combine",
                  "splitk_gemm": "splitk_reduce",
                  "streamk_tma": "streamk_fixup",
                  "streamk_gemm": "streamk_fixup"}


def rel_frobenius(got, want):
    """bench.py's check (_check_close): ||got - want||_F / ||want||_F."""
    d = (got.float() - want.float()).double()
    return float(d.norm() / want.float().double().norm())


def mamba2_flops(B, S, H, P, N, c):
    """Operations the SSD chunk scan needs at chunk c: the lower triangle
    of C B^T once a batch row (no head changes it); for each head the
    masked scores' lower triangle times X, C times the carried (N, P)
    state, and B^T X into it."""
    return 2.0 * B * S * ((c + 1) / 2 * N
                          + H * ((c + 1) / 2 * P + 2 * N * P))


def gdn_wy_flops(B, H, T, K, V, c):
    """The operations of gdn_flops that gdn_chunk_wy does: k k^T's
    strict lower triangle, the triangular solve for w and u, the lower
    triangle of q k^T."""
    return 2.0 * B * H * T * ((c - 1) / 2 * (2 * K + V) + (c + 1) / 2 * K)


def gdn_state_flops(B, H, T, K, V, c):
    """The rest, gdn_chunk_state's: attn's lower triangle times the new
    values and the three (K, V) state products."""
    return 2.0 * B * H * T * ((c + 1) / 2 * V + 3 * K * V)


def gdn_flops(B, H, T, K, V, c):
    """Operations the gated delta rule needs at chunk c, a token and a
    head: k k^T's strict lower triangle, the unit-lower triangular solve
    for w and u by substitution (the kernel's blocked inverse is more),
    the lower triangles of q k^T and of its product with the new values,
    and the three (K, V) state products."""
    return gdn_wy_flops(B, H, T, K, V, c) + gdn_state_flops(B, H, T, K, V, c)


def gdn_scratch_bytes(B, H, T, K, V, c, esize):
    """What gdn_chunk_wy writes and gdn_chunk_state reads: w, e^gc q and
    kd (each q's size), attn_c in the input type, u and the gates in
    float32."""
    return B * H * T * (3 * K * esize + c * esize + 4 * V) \
        + B * H * (T // c) * 4


def chunk_scan_flops(B, H, S, DK, DV, c):
    """Operations linear attention or retention needs at chunk c, a
    token and a head: q times the (DK, DV) state and k^T v into it, and
    the lower triangles of q k^T and of its product with v (the decays
    are elementwise). No bfloat16 term for the kernel's hi + lo split of
    the state: that is the kernel's choice, not the function's work."""
    return 2.0 * B * H * S * (2 * DK * DV + (c + 1) / 2 * (DK + DV))


def seqmix_phase(torch, m2, gd, la):
    """The sequence-mixing entry points at bench.py's widths: each
    main-path call with the counters zeroed before it and read right
    after (one launch a call; linear attention's kernel backward one
    forward and three backward launches), its output against the plain
    version on the card and, for Mamba2 and GDN, against the sequential
    recurrence by bench's own check; then the device times of the
    kernel, the plain version and the chunk-parallel eager port of
    bench's baseline, and the bound."""
    import numpy as np
    counted = {"mamba2_chunk_scan": 0, "gdn_chunk_fwd": 0,
               "gdn_chunk_wy": 0, "gdn_chunk_state": 0,
               "linear_attention": 0, "retention": 0}
    res = {}
    reset_peak(torch)

    def drive(label, call, want_launches, main=True):
        """``call`` with the counters zeroed before it and read after;
        a call off the main path (``main=False``) is checked but not
        counted."""
        torch.cuda.synchronize()
        for mod in (m2, gd, la):
            mod.reset_launches()
        out = call()
        torch.cuda.synchronize()
        got = {**m2.launches, **gd.launches, **la.launches}
        want = {k: want_launches.get(k, 0) for k in got}
        check(got == want, f"{label}: launches {got}, want {want}")
        for k, n in got.items():
            counted[k] += n if main else 0
        return out

    def hold(label, got, want, dtype):
        tol = SEQ_TOL[str(dtype).replace("torch.", "")]
        check(tuple(got.shape) == tuple(want.shape)
              and got.dtype == want.dtype, f"{label}: {got.dtype} "
              f"{tuple(got.shape)}, plain {want.dtype} {tuple(want.shape)}")
        check(bool(torch.isfinite(got.float()).all()),
              f"{label}: non-finite output")
        err, rel = normwise_err(got, want)
        check(rel <= tol, f"{label} disagrees with its plain version: "
                          f"{rel:.3e} of max |plain| > {tol}")
        return {"max_abs_err": err, "normwise_err": rel,
                "tolerance": f"normwise {tol}"}

    def against_reference(label, got, ref, tol):
        rel = rel_frobenius(got, ref)
        check(math.isfinite(rel) and rel <= tol,
              f"{label}: {rel:.3e} from the sequential recurrence > {tol}")
        return {"reference_rel_err": rel, "reference_tolerance":
                f"relative Frobenius {tol} (bench.py's rel_tol)"}

    def timed(kern, plain, eager=None, iters=5):
        out = {"ms": device_ms(torch, kern, iters),
               "plain_ms": device_ms(torch, plain, 2),
               "library_ms": None}
        if eager is not None:
            out["eager_chunked_ms"] = device_ms(torch, eager, 2)
        return out

    def bf16(a):
        return torch.from_numpy(a).cuda().to(torch.bfloat16)

    # -- #29 Mamba2 SSD (cfg_mamba2_chunk's draws, default_rng(7)) --------
    B, S, H, P, N = (MAMBA2[k] for k in "BSHPN")
    rng = np.random.default_rng(7)
    x = bf16((rng.standard_normal((B, S, H, P)) * 0.3).astype(np.float32))
    dt = torch.from_numpy(rng.uniform(0.01, 0.1, (B, S, H)).astype(
        np.float32)).cuda()
    A = torch.from_numpy((-rng.uniform(0.5, 1.5, (H,))).astype(
        np.float32)).cuda()
    Bm = bf16((rng.standard_normal((B, S, N)) * 0.3).astype(np.float32))
    Cm = bf16((rng.standard_normal((B, S, N)) * 0.3).astype(np.float32))
    t0 = time.perf_counter()
    ref = m2.mamba2_reference(x, dt, A, Bm, Cm)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    for label, chunk, dtype in (("bf16_chunk128", 128, torch.bfloat16),
                                ("bf16_chunk256", 256, torch.bfloat16),
                                ("f32_chunk128", 128, torch.float32)):
        xs, bs, cs = (t.to(dtype) for t in (x, Bm, Cm))
        got = drive(f"mamba2_chunk_scan {label}", lambda: m2.mamba2_chunk_scan(
            xs, dt, A, bs, cs, chunk=chunk), {"mamba2_chunk_scan": 1})
        r = hold(f"mamba2_chunk_scan {label}", got,
                 m2.mamba2_chunk_scan_plain(xs, dt, A, bs, cs, chunk), dtype)
        r.update(against_reference(f"mamba2_chunk_scan {label}", got, ref,
                                   SEQ_REF_TOL["mamba2"]))
        del got
        esize = xs.element_size()
        nbytes = 2 * x.numel() * esize + 2 * Bm.numel() * esize \
            + dt.numel() * 4 + A.numel() * 4
        flops = mamba2_flops(B, S, H, P, N, chunk)
        bound, by = mm_bound(flops, nbytes, PEAK_BF16_FLOPS
                             if dtype == torch.bfloat16 else PEAK_F32_FLOPS)
        res[f"mamba2_chunk_scan_{label}"] = {
            "shape": [B, S, H, P, N], "chunk": chunk, **r,
            **timed(lambda: m2.mamba2_chunk_scan(xs, dt, A, bs, cs,
                                                 chunk=chunk),
                    lambda: m2.mamba2_chunk_scan_plain(xs, dt, A, bs, cs,
                                                       chunk),
                    lambda: m2.mamba2_chunk_scan_torch(xs, dt, A, bs, cs,
                                                       chunk=chunk)),
            "bound_ms": bound, "bound_by": by, "flops": flops,
            "bytes": nbytes, "plan": m2.mamba2_plan(
                B, H, P, N, chunk, esize)._asdict(), "reference_s": ref_s}
        del xs, bs, cs
        torch.cuda.empty_cache()
    del x, dt, A, Bm, Cm, ref
    torch.cuda.empty_cache()

    # -- #30 Gated DeltaNet (cfg_gdn_fwd's draws, default_rng(8)) ----------
    B, H, T, K, V = (GDN[k] for k in "BHTKV")
    rng = np.random.default_rng(8)
    q = bf16((rng.standard_normal((B, H, T, K)) * 0.3).astype(np.float32))
    k = rng.standard_normal((B, H, T, K)).astype(np.float32)
    k = bf16(k / np.linalg.norm(k, axis=-1, keepdims=True))
    v = bf16((rng.standard_normal((B, H, T, V)) * 0.3).astype(np.float32))
    g = torch.from_numpy(rng.uniform(-0.2, 0.0, (B, H, T)).astype(
        np.float32)).cuda()
    beta = torch.from_numpy(rng.uniform(0.1, 0.9, (B, H, T)).astype(
        np.float32)).cuda()
    t0 = time.perf_counter()
    ref = gd.gdn_reference(q, k, v, g, beta)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    scale = 1.0 / math.sqrt(K)
    gdn_calls = {"gdn_chunk_fwd": 1, "gdn_chunk_wy": 1, "gdn_chunk_state": 1}
    for label, chunk, dtype in (("bf16_chunk64", 64, torch.bfloat16),
                                ("bf16_chunk128", 128, torch.bfloat16),
                                ("f32_chunk64", 64, torch.float32),
                                ("f32_chunk128", 128, torch.float32)):
        qs, ks, vs = (t.to(dtype) for t in (q, k, v))
        got = drive(f"gdn_chunk_fwd_tl {label}", lambda: gd.gdn_chunk_fwd_tl(
            qs, ks, vs, g, beta, chunk_size=chunk), gdn_calls)
        r = hold(f"gdn_chunk_fwd_tl {label}", got, gd.gdn_chunk_fwd_tl_plain(
            qs, ks, vs, g, beta, chunk, scale), dtype)
        r.update(against_reference(f"gdn_chunk_fwd_tl {label}", got, ref,
                                   SEQ_REF_TOL["gdn"]))
        del got
        esize = qs.element_size()
        nbytes = 4 * q.numel() * esize + 2 * g.numel() * 4
        flops = gdn_flops(B, H, T, K, V, chunk)
        bound, by = mm_bound(flops, nbytes, PEAK_BF16_FLOPS
                             if dtype == torch.bfloat16 else PEAK_F32_FLOPS)
        plan, code = gd._plan_or_raise(qs, vs, chunk)
        scratch_bytes = gdn_scratch_bytes(B, H, T, K, V, chunk, esize)
        res[f"gdn_chunk_fwd_{label}"] = {
            "shape": [B, H, T, K, V], "chunk": chunk, **r,
            **timed(lambda: gd.gdn_chunk_fwd_tl(qs, ks, vs, g, beta,
                                                chunk_size=chunk),
                    lambda: gd.gdn_chunk_fwd_tl_plain(qs, ks, vs, g, beta,
                                                      chunk, scale),
                    lambda: gd.gdn_chunk_fwd(qs, ks, vs, g, beta,
                                             chunk_size=chunk)),
            "bound_ms": bound, "bound_by": by, "flops": flops,
            "bytes": nbytes, "scratch_bytes": scratch_bytes,
            "plan": plan._asdict(), "reference_s": ref_s}
        # each kernel alone against its plain stage on the same inputs
        # (off the main path): the WY kernel's scratch (attn on and below
        # each chunk's diagonal, where the serial pass reads it), the
        # serial pass on the plain stage's scratch
        want = gd.gdn_chunk_wy_plain(qs, ks, vs, g, beta, chunk)
        got = drive(f"gdn_chunk_wy {label}", lambda: gd._launch_wy(
            qs, ks, vs, g, beta, chunk, code), {"gdn_chunk_wy": 1},
            main=False)
        low = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                    device=q.device))
        parts = []
        for i, (a, w) in enumerate(zip(got, want)):
            if i == 4:
                a, w = (t.reshape(B, H, -1, chunk, chunk)[..., low]
                        for t in (a, w))
            parts.append(hold(f"gdn_chunk_wy {label} output {i}", a, w,
                              dtype))
        del got
        worst = max(parts, key=lambda x: x["normwise_err"])
        wy_bytes = nbytes - q.numel() * esize + scratch_bytes
        wy_flops = gdn_wy_flops(B, H, T, K, V, chunk)
        bound, by = mm_bound(wy_flops, wy_bytes, PEAK_BF16_FLOPS
                             if dtype == torch.bfloat16 else PEAK_F32_FLOPS)
        res[f"gdn_chunk_wy_{label}"] = {
            "chunk": chunk, **worst,
            **timed(lambda: gd._launch_wy(qs, ks, vs, g, beta, chunk, code),
                    lambda: gd.gdn_chunk_wy_plain(qs, ks, vs, g, beta,
                                                  chunk)),
            "bound_ms": bound, "bound_by": by, "flops": wy_flops,
            "bytes": wy_bytes}
        got = drive(f"gdn_chunk_state {label}", lambda: gd._launch_state(
            want, plan, scale, code), {"gdn_chunk_state": 1}, main=False)
        r = hold(f"gdn_chunk_state {label}", got,
                 gd.gdn_chunk_state_plain(*want, scale), dtype)
        del got
        st_bytes = scratch_bytes + q.numel() * esize
        st_flops = gdn_state_flops(B, H, T, K, V, chunk)
        bound, by = mm_bound(st_flops, st_bytes, PEAK_BF16_FLOPS
                             if dtype == torch.bfloat16 else PEAK_F32_FLOPS)
        res[f"gdn_chunk_state_{label}"] = {
            "chunk": chunk, **r,
            **timed(lambda: gd._launch_state(want, plan, scale, code),
                    lambda: gd.gdn_chunk_state_plain(*want, scale)),
            "bound_ms": bound, "bound_by": by, "flops": st_flops,
            "bytes": st_bytes}
        del qs, ks, vs, want
        torch.cuda.empty_cache()
    del q, k, v, g, beta, ref
    torch.cuda.empty_cache()

    # -- #27, #28 linear attention and retention (the GDN cell's widths) --
    B, H, S, DK, DV = (LINATTN[k] for k in ("B", "H", "S", "DK", "DV"))
    rng = np.random.default_rng(10)
    q32, k32, v32 = (torch.from_numpy((rng.standard_normal((B, H, S, d))
                                       * 0.2).astype(np.float32)).cuda()
                     for d in (DK, DK, DV))
    go = torch.from_numpy(rng.standard_normal((B, H, S, DV)).astype(
        np.float32)).cuda()
    # gamma stays on the host: the wrapper checks its range there, with
    # no wait on the card inside the timed calls
    gamma = torch.tensor([1.0 - 2.0 ** (-5.0 - 4.0 * h / H)
                          for h in range(H)])
    for kname, chunk in (("linear_attention", 128), ("retention", 64)):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            qs, ks, vs = (t.to(dtype) for t in (q32, k32, v32))
            if kname == "linear_attention":
                def kern():
                    return la.linear_attention(qs, ks, vs, chunk=chunk)

                def plain():
                    return la.linear_attention_plain(qs, ks, vs, chunk)
            else:
                def kern():
                    return la.retention(qs, ks, vs, gamma, chunk=chunk)

                def plain():
                    return la.retention_plain(qs, ks, vs, gamma, chunk)
            got = drive(f"{kname} {name}", kern, {kname: 1})
            r = hold(f"{kname} {name}", got, plain(), dtype)
            del got
            esize = qs.element_size()
            nbytes = (2 * q32.numel() + 2 * v32.numel()) * esize
            flops = chunk_scan_flops(B, H, S, DK, DV, chunk)
            bound, by = mm_bound(flops, nbytes, PEAK_BF16_FLOPS
                                 if dtype == torch.bfloat16
                                 else PEAK_F32_FLOPS)
            res[f"{kname}_{name}_chunk{chunk}"] = {
                "shape": [B, H, S, DK, DV], "chunk": chunk, **r,
                **timed(kern, plain), "bound_ms": bound, "bound_by": by,
                "flops": flops, "bytes": nbytes}
            del qs, ks, vs
            torch.cuda.empty_cache()

    # linear attention's kernel backward: one forward launch, three
    # backward ones, at full width, its gradients against the same three
    # calls on the plain version; then, off the main path, against
    # autograd through the dense reference at S = LINATTN["grad_S"] (it
    # is S^2)
    def fwd_bwd(qq, kk, vv, gg):
        t = [a.detach().requires_grad_() for a in (qq, kk, vv)]
        out = la.linear_attention(*t, chunk=128, backward="kernel")
        (out * gg).sum().backward()
        return [a.grad for a in t]

    got = drive("linear_attention backward", lambda: fwd_bwd(
        q32, k32, v32, go), {"linear_attention": 4})
    bwd = {"launches": 4, "grad_plain": {}}
    for gname, a, w in zip(("dq", "dk", "dv"), got,
                           la.linear_attention_grads_plain(
                               q32, k32, v32, go, 128)):
        bwd["grad_plain"][gname] = hold(
            f"linear_attention {gname}", a, w, torch.float32)
    del got
    bwd["fwd_bwd_ms"] = device_ms(torch, lambda: fwd_bwd(q32, k32, v32, go),
                                  3)
    Sg = LINATTN["grad_S"]
    qg, kg, vg, gg = (t[:, :, :Sg].contiguous() for t in (q32, k32, v32, go))
    got = drive("linear_attention backward (reduced S)",
                lambda: fwd_bwd(qg, kg, vg, gg), {"linear_attention": 4},
                main=False)
    t = [a.detach().requires_grad_() for a in (qg, kg, vg)]
    (la.linear_attention_reference(*t) * gg).sum().backward()
    errs = {}
    for gname, a, w in zip(("dq", "dk", "dv"), got, (x.grad for x in t)):
        err, rel = normwise_err(a, w)
        check(bool(torch.isfinite(a).all()) and rel <= LA_GRAD_TOL,
              f"linear_attention {gname}: {rel:.3e} of max |autograd| > "
              f"{LA_GRAD_TOL}")
        errs[gname] = rel
    bwd.update({"grad_S": Sg, "grad_normwise_err": errs,
                "grad_tolerance": f"normwise {LA_GRAD_TOL} against "
                                  f"autograd through the dense reference"})
    res["linear_attention_backward"] = bwd
    del q32, k32, v32, go, qg, kg, vg, gg, got, t
    torch.cuda.empty_cache()
    res["launches"] = counted
    res["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    print(json.dumps({"seqmix": res}), flush=True)
    return res


# the seqmix phase's kernels: (name, source, replaced TPU kernel, headline
# case); the kernel's other cases are nested under "variants"
SEQMIX_KERNELS = (
    ("mamba2_chunk_scan", "mamba2.cu",
     "tilelang_mesh_tpu/ops/mamba2.py:25", "bf16_chunk128"),
    ("gdn_chunk_fwd", "gdn.cu", "tilelang_mesh_tpu/ops/gdn.py:31",
     "bf16_chunk64"),
    ("gdn_chunk_wy", "gdn.cu", "tilelang_mesh_tpu/ops/gdn.py:31",
     "bf16_chunk64"),
    ("gdn_chunk_state", "gdn.cu", "tilelang_mesh_tpu/ops/gdn.py:31",
     "bf16_chunk64"),
    ("linear_attention", "linear_attention.cu",
     "tilelang_mesh_tpu/ops/linear_attention.py:20", "float32_chunk128"),
    ("retention", "linear_attention.cu",
     "tilelang_mesh_tpu/ops/linear_attention.py:122", "float32_chunk64"))
SEQMIX_LIBRARY = ("none: no single PyTorch call computes the SSD scan, "
                  "the gated delta rule or chunked linear attention")


def bitnet_gqa_phase(torch, bn, qa, gq, gb):
    """BitNet b1.58-2B-4T's FFN block and grouped-query attention
    (BITNET): each main-path call with the counters zeroed before it and
    read right after (the FFN three launches a call of bitnet_path's
    kernel, bitnet_gemm_wgmma at the prefill and bitnet_gemm_splitk at
    decode; the tile loop bitnet_gemm once, on a misaligned copy of the
    decode activations; quantize_act_int8 one; gqa_attention one gqa_fwd
    without autograd, one gqa_fwd_partial, one dK/dV and one dQ with it);
    the FFN equal to the same module's reference mode on the card (the
    plain path: the exact product in float64, the same epilogue), its
    forward's median time; each kernel against its plain version on the
    card at the path's shapes, with kernel, plain and library times and
    the bound."""
    import numpy as np
    import torch.nn.functional as F
    from tilelang_mesh_tpu_torch.models.bitnet import BitFFN
    counters = (bn.launches, qa.launches, gq.launches, gb.launches)
    counted = {k: 0 for c in counters for k in c}
    res = {}
    reset_peak(torch)
    c = BITNET
    hid, inter = c["hidden"], c["inter"]

    def drive(label, call, want_launches, main=True):
        torch.cuda.synchronize()
        for m in (bn, qa, gq, gb):
            m.reset_launches()
        out = call()
        torch.cuda.synchronize()
        got = {k: n for cnt in counters for k, n in cnt.items()}
        want = {k: want_launches.get(k, 0) for k in got}
        check(got == want, f"{label}: launches {got}, want {want}")
        for k in counted:
            counted[k] += got[k] if main else 0
        return out

    def median_ms(fn, n=5):
        fn()
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return sorted(times)[n // 2], times

    def bound(flops, nbytes, peak):
        t, by = mm_bound(flops, nbytes, peak)
        return {"bound_ms": t, "bound_by": by, "ops": flops,
                "bytes": nbytes}

    # -- the FFN block: a 4096-token prefill and a decode step -----------
    ffn = BitFFN(hid, inter, seed=0, device="cuda")
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(
        (1, c["seq"], hid), dtype=np.float32)).cuda()
    x1 = torch.from_numpy(rng.standard_normal(
        (1, 1, hid), dtype=np.float32)).cuda()
    # bitnet_path's kernel: TMA + wgmma at the prefill, split-K at decode
    for label, xx, kname in (("prefill", x, "bitnet_gemm_wgmma"),
                             ("decode", x1, "bitnet_gemm_splitk")):
        y = drive(f"BitFFN {label}", lambda: ffn(xx), {kname: 3})
        want = drive(f"BitFFN {label} reference", lambda: ffn(
            xx, reference=True), {}, main=False)
        check(tuple(y.shape) == tuple(xx.shape) and y.dtype == torch.float32
              and bool(torch.isfinite(y).all()), f"BitFFN {label}: bad "
              f"output {y.dtype} {tuple(y.shape)}")
        check(torch.equal(y, want), f"BitFFN {label} differs from its "
              f"plain path by {float((y - want).abs().max()):.3e}")
        med, times = median_ms(lambda: ffn(xx))
        plain_med, _ = median_ms(lambda: ffn(xx, reference=True), 3)
        res[f"bitffn_{label}"] = {
            "shape": list(xx.shape), "forward_ms_median": med,
            "forward_ms": times, "plain_forward_ms_median": plain_med,
            "tokens_per_s": xx.shape[1] / (med / 1e3),
            "equal_to_plain": True}
        del y, want

    # -- bitnet_gemm alone on the FFN's own activations ------------------
    x2, x12 = x.reshape(-1, hid), x1.reshape(-1, hid)
    q_in, s_in = bn.quantize_activations(x2)
    g = torch.clamp_min(bn.bitnet_linear(x2, ffn.packed_gate,
                                         ffn.scales["gate"]), 0.0)
    h = torch.square(g) * bn.bitnet_linear(x2, ffn.packed_up,
                                           ffn.scales["up"])
    del g
    q_h, _ = bn.quantize_activations(h)
    q_dec, _ = bn.quantize_activations(x12)
    # the decode activations 2 bytes past a 16-byte boundary: the block
    # tile loop, which the FFN's aligned shapes no longer reach (a main
    # path call, so that the loop's launches count)
    q_odd = torch.empty(q_dec.numel() + 16, dtype=torch.int8,
                        device="cuda")[2:2 + q_dec.numel()].view(q_dec.shape)
    q_odd.copy_(q_dec)
    for label, a, name, kname, main in (
            ("prefill_gate_up", q_in, "gate", "bitnet_gemm_wgmma", False),
            ("prefill_down", q_h, "down", "bitnet_gemm_wgmma", False),
            ("decode_gate_up", q_dec, "gate", "bitnet_gemm_splitk", False),
            ("decode_gate_up_unaligned", q_odd, "gate", "bitnet_gemm",
             True)):
        packed = getattr(ffn, f"packed_{name}")
        w8 = getattr(ffn, f"ternary_{name}")
        M, K = a.shape
        N = packed.shape[1]
        check(bn.PATH_KERNELS[bn.bitnet_path(
            M, N, K, a.data_ptr(), packed.data_ptr())] == kname,
            f"bitnet_gemm {label}: bitnet_path names another kernel")
        got = drive(f"bitnet_gemm {label}", lambda: bn.bitnet_gemm(
            a, packed), {kname: 1}, main=main)
        want = bn.bitnet_gemm_plain(a, packed)
        check(got.dtype == torch.int32 and torch.equal(got, want),
              f"bitnet_gemm {label} differs from its plain version")
        del got, want
        # torch._int_mm asks M > 16: the decode row padded to 32 rows;
        # cuBLASLt's int8 path takes a column-major B
        a_lib = a if M > 16 else torch.cat(
            [a, a.new_zeros((32 - M, K))])
        w_lib = w8.T.contiguous().T
        check(torch.equal(torch._int_mm(a_lib, w_lib)[:M],
                          bn.bitnet_gemm_plain(a, packed)),
              f"the library yardstick disagrees at {label}")
        res[f"{kname}_{label}"] = {
            "shape": [M, N, K], "max_abs_err": 0, "tolerance": "equal",
            "ms": device_ms(torch, lambda: bn.bitnet_gemm(a, packed), 5),
            "plain_ms": device_ms(torch, lambda: bn.bitnet_gemm_plain(
                a, packed), 2),
            "library_ms": device_ms(torch, lambda: torch._int_mm(
                a_lib, w_lib), 5),
            "library": "torch._int_mm on the unpacked int8 weight"
                       + ("" if M > 16 else f" ({M} row padded to 32: "
                                             f"_int_mm asks M > 16)"),
            **bound(2 * M * N * K, M * K + K // 4 * N + 4 * M * N,
                    PEAK_8BIT_OPS)}
    del q_in, q_h, q_dec, q_odd

    # -- quantize_act_int8 on the FFN's input and hidden activation ------
    for label, t in (("ffn_input", x2), ("ffn_hidden", h)):
        t = t.clone()
        t[123] = 0.0                       # one all-zero row
        q, s = drive(f"quantize_act_int8 {label}",
                     lambda: qa.quantize_act_int8(t),
                     {"quantize_act_int8": 1})
        pq, ps = qa.quantize_act_int8_plain(t)
        check(torch.equal(q, pq) and torch.equal(
            s.view(torch.int32), ps.view(torch.int32)),
            f"quantize_act_int8 {label}: Q or S differ from the plain "
            f"version's bytes")
        check(bool(torch.isfinite(s).all()) and not bool(q[123].any()),
              f"quantize_act_int8 {label}: the zero row's S or Q")
        M, K = t.shape
        res[f"quantize_act_int8_{label}"] = {
            "shape": [M, K], "max_abs_err": 0, "tolerance": "equal bytes",
            "ms": device_ms(torch, lambda: qa.quantize_act_int8(t), 5),
            "plain_ms": device_ms(torch, lambda: qa.quantize_act_int8_plain(
                t), 3),
            "library_ms": None,
            "library": "none: no single PyTorch call computes per-row "
                       "absmax int8 codes and their scales",
            **bound(3 * M * K, 4 * M * K + M * K + 4 * M, PEAK_F32_FLOPS)}
        del t, q, s, pq, ps
    del x, x1, x2, x12, h, ffn
    torch.cuda.empty_cache()

    # -- gqa_attention: no grad (gqa_fwd), grad (partial + backward) -----
    B, Hq, Hkv, S, D = (c["attn_batch"], c["heads"], c["kv_heads"],
                        c["seq"], c["head_dim"])
    group = Hq // Hkv
    sm = 1.0 / math.sqrt(D)
    pairs = causal_pairs(S, S) * B * Hq
    rng = np.random.default_rng(2)
    base = [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
            for shape in ((B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D),
                          (B, Hq, S, D))]
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        tol = ATTN_TOL[name]
        esize = torch.empty((), dtype=dtype).element_size()
        peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
        q, k, v, do = (t.cuda().to(dtype) for t in base)

        def within(label, got, want):
            check(bool(torch.isfinite(got.float()).all()),
                  f"{label} ({name}): non-finite output")
            err, rel = normwise_err(got, want)
            check(rel <= tol, f"{label} ({name}) disagrees with its plain "
                              f"version: {rel:.3e} of max |plain| > {tol}")
            return err, rel

        with torch.no_grad():
            o = drive(f"gqa_attention {name}", lambda: gq.gqa_attention(
                q, k, v, causal=True), {"gqa_fwd": 1})
        err_o, rel_o = within("gqa_fwd", o, gq.gqa_fwd_plain(q, k, v, True,
                                                              sm))
        del o
        part = gq.gqa_fwd_partial(q, k, v, True, sm)
        want = gq.gqa_fwd_partial_plain(q, k, v, True, sm)
        errs = [within("gqa_fwd_partial", a, b) for a, b in zip(part, want)]
        del part

        # the autograd call against the plain versions of every kernel
        acc, m, l = want
        o_plain = torch.where(l[..., None] > 0, acc / l[..., None],
                              0.0).to(dtype)
        lse2 = m + torch.log2(l)
        delta = (do.float() * o_plain.float()).sum(-1)
        dk, dv = gb.gqa_bwd_dkdv_plain(q, k, v, do, lse2, delta, True, sm)
        dq = gb.gqa_bwd_dq_plain(q, k, v, do, lse2, delta, True, sm)
        del want, acc, m, l, lse2, delta
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]

        def fwd_bwd():
            out = gq.gqa_attention(*leaves, causal=True)
            out.backward(do)
            return out

        out = drive(f"gqa_attention grad {name}", fwd_bwd, {
            "gqa_fwd_partial": 1, "gqa_bwd_dkdv": 1, "gqa_bwd_dq": 1})
        within("gqa_attention grad output", out.detach(), o_plain)
        grad_errs = {lbl: within(f"gqa_attention {lbl}", t.grad,
                                 w.to(dtype))[1]
                     for lbl, t, w in zip(("dq", "dk", "dv"), leaves,
                                          (dq, dk, dv))}
        # the training step's attention: forward and backward, against
        # SDPA's (enable_gqa) on the same leaves
        sdpa = [t.detach().requires_grad_() for t in (q, k, v)]
        step = {"autograd_step_ms": cuda_ms(torch, fwd_bwd, 3),
                "sdpa_step_ms": cuda_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        *sdpa, is_causal=True, enable_gqa=True).backward(do),
                    3)}
        del out, leaves, sdpa, o_plain, dq, dk, dv
        torch.cuda.empty_cache()

        bhsd, kvsd = B * Hq * S * D, B * Hkv * S * D
        kx, vx = (t.repeat_interleave(group, 1) for t in (k, v))
        res[f"gqa_fwd_{name}"] = {
            "shape": [B, Hq, Hkv, S, D], "max_abs_err": err_o,
            "normwise_err": rel_o, "tolerance": f"normwise {tol}",
            "grad_normwise_err": grad_errs,
            "ms": cuda_ms(torch, lambda: gq.gqa_fwd(q, k, v, True, sm), 5),
            "plain_ms": cuda_ms(torch, lambda: gq.gqa_fwd_plain(
                q, k, v, True, sm), 2),
            "library_ms": cuda_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True), 5),
            "library": "SDPA, is_causal, enable_gqa",
            **bound(4 * D * pairs, (2 * bhsd + 2 * kvsd) * esize, peak)}
        res[f"gqa_fwd_partial_{name}"] = {
            "shape": [B, Hq, Hkv, S, D],
            "max_abs_err": max(e[0] for e in errs),
            "normwise_err": max(e[1] for e in errs),
            "tolerance": f"normwise {tol}",
            "ms": cuda_ms(torch, lambda: gq.gqa_fwd_partial(
                q, k, v, True, sm), 5),
            "plain_ms": cuda_ms(torch, lambda: gq.gqa_fwd_partial_plain(
                q, k, v, True, sm), 2),
            # the natural-log LSE, not (m, l) in exp2; KV expanded
            "library_ms": cuda_ms(
                torch, lambda: torch.ops.aten._scaled_dot_product_efficient_attention(
                    q, kx, vx, None, True, 0.0, True), 5),
            "library": "SDPA efficient attention with LSE on the expanded "
                       "KV", **step,
            **bound(4 * D * pairs, (bhsd + 2 * kvsd) * esize + 4 * bhsd
                    + 8 * B * Hq * S, peak)}
        del q, k, v, do, kx, vx
        torch.cuda.empty_cache()

    res["launches"] = counted
    res["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    print(json.dumps({"bitnet_gqa": res}), flush=True)
    return res


# the bitnet_gqa phase's kernels: (name, source, replaced TPU kernel,
# headline case)
BITNET_GQA_KERNELS = (
    ("gqa_fwd", "flash_attention.cu", "tilelang_mesh_tpu/ops/gqa.py:21",
     "float32"),
    ("gqa_fwd_partial", "flash_attention.cu",
     "tilelang_mesh_tpu/ops/gqa.py:63", "float32"),
    ("quantize_act_int8", "quantize_act.cu",
     "tilelang_mesh_tpu/quantize/quantization.py:72", "ffn_hidden"),
    ("bitnet_gemm_wgmma", "bitnet_gemm.cu",
     "tilelang_mesh_tpu/ops/bitnet.py:51", "prefill_gate_up"),
    ("bitnet_gemm_splitk", "bitnet_gemm.cu",
     "tilelang_mesh_tpu/ops/bitnet.py:51", "decode_gate_up"),
    ("bitnet_gemm", "bitnet_gemm.cu", "tilelang_mesh_tpu/ops/bitnet.py:51",
     "decode_gate_up_unaligned"))


def varlen_phase(torch, vl, fa, gq, gb):
    """Packed varlen attention at BitNet b1.58-2B-4T's attention widths
    (VARLEN): each main-path call with every attention counter zeroed
    before it and read right after (the pack: one varlen_fwd without
    autograd; one varlen_fwd_partial, one dK/dV and one dQ through
    autograd; the prefill step: one varlen_fwd); each output against the
    plain versions on the card; each kernel against its plain version at
    the path's shapes, with the pad tail exactly zero in O and l; one
    document's gradient reaching no other document; kernel, plain and
    SDPA times and the bound by the documents' visible pairs."""
    import numpy as np
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    mods = (vl, fa, gq, gb)
    counted = {k: 0 for k in vl.launches}
    res = {}
    reset_peak(torch)
    c = VARLEN
    Hq, Hkv, D = c["heads"], c["kv_heads"], c["head_dim"]
    sm = 1.0 / math.sqrt(D)

    def drive(label, call, want_launches, main=True):
        torch.cuda.synchronize()
        for m in mods:
            m.reset_launches()
        out = call()
        torch.cuda.synchronize()
        got = {k: n for m in mods for k, n in m.launches.items()}
        want = {k: want_launches.get(k, 0) for k in got}
        check(got == want, f"{label}: launches {got}, want {want}")
        for k in counted:
            counted[k] += got[k] if main else 0
        return out

    def cu_of(lens):
        return np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)

    def visible_pairs(lens_q, lens_k, bottom_right):
        """(i, j) pairs the causal mask keeps, summed over sequences."""
        n = 0
        for lq, lk in zip(lens_q, lens_k):
            shift = lk - lq if bottom_right else 0
            n += int(np.clip(np.arange(lq) + shift + 1, 0, lk).sum())
        return n

    def draw(seed, total_q, total_k):
        rng = np.random.default_rng(seed)
        return [torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
                for s in ((total_q, Hq, D), (total_k, Hkv, D),
                          (total_k, Hkv, D), (total_q, Hq, D))]

    def library(q4, k4, v4, mask, g4, dtype, grad, want):
        """SDPA with the bool document mask (T_q, T_k): forward ms and,
        with ``grad``, its backward's (dq, dk, dv). bfloat16 on the
        grouped heads (``enable_gqa``, the backend PyTorch picks);
        float32 on K and V expanded by the group outside the timed
        calls, on the memory-efficient kernel (with ``enable_gqa`` a
        float32 mask takes only the math path, which materialises the
        (Hq, T, T) float32 scores). Its output is held against the plain
        version's ``want`` (1, Hq, T_q, D)."""
        if dtype == torch.float32:
            group = q4.shape[1] // k4.shape[1]
            k4, v4 = (t.repeat_interleave(group, 1) for t in (k4, v4))
            ctx, kw = sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]), {}
            name = ("SDPA memory-efficient kernel, bool document mask "
                    "(T_q, T_k), K and V expanded by the group")
        else:
            ctx, kw = contextlib.nullcontext(), {"enable_gqa": True}
            name = "SDPA, bool document mask (T_q, T_k), enable_gqa"

        def call(*a):
            return F.scaled_dot_product_attention(*a, attn_mask=mask, **kw)

        with ctx:
            rel = normwise_err(call(q4, k4, v4), want)[1]
            check(rel < 2e-2, f"the library yardstick ({name}) disagrees "
                              f"with the plain version: {rel:.3e}")
            out = {"library_ms": device_ms(torch, lambda: call(q4, k4, v4),
                                           3),
                   "library": name, "library_normwise_err": rel}
            if grad:
                leaves = [t.detach().requires_grad_() for t in (q4, k4, v4)]
                o = call(*leaves)
                out["library_bwd_ms"] = device_ms(
                    torch, lambda: torch.autograd.grad(
                        o, leaves, g4, retain_graph=True), 3)
                del o, leaves
        return out

    def bound(flops, nbytes, peak):
        t, by = mm_bound(flops, nbytes, peak)
        return {"bound_ms": t, "bound_by": by, "ops": flops,
                "bytes": nbytes}

    def median_ms(fn, n=3):
        """Median host-clock ms of ``fn`` ending in a synchronize (the
        entry point end to end: packing, kernels, slicing)."""
        fn()
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return sorted(times)[n // 2]

    def run(cfg, lens_q, lens_k, seed, dtype, align, grad):
        name = str(dtype).replace("torch.", "")
        tol = ATTN_TOL[name]
        esize = torch.empty((), dtype=dtype).element_size()
        peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
        cu_q, cu_k = cu_of(lens_q), cu_of(lens_k)
        tq, tk = int(cu_q[-1]), int(cu_k[-1])
        q, k, v, g = (t.cuda().to(dtype) for t in draw(seed, tq, tk))
        kw = dict(causal=True, causal_align=align)
        tag = f"varlen {cfg} {name}"

        def within(label, got, want):
            check(bool(torch.isfinite(got.float()).all()),
                  f"{tag} {label}: non-finite output")
            err, rel = normwise_err(got, want)
            check(rel <= tol, f"{tag} {label} disagrees with its plain "
                              f"version: {rel:.3e} of max |plain| > {tol}")
            return err, rel

        with torch.no_grad():
            o = drive(f"{tag} forward", lambda: vl.flash_attention_varlen(
                q, k, v, cu_q, cu_k, **kw), {"varlen_fwd": 1})
            entry = {"forward_ms_median": median_ms(
                lambda: vl.flash_attention_varlen(q, k, v, cu_q, cu_k, **kw))}
        check(tuple(o.shape) == tuple(q.shape) and o.dtype == dtype,
              f"{tag}: output {o.dtype} {tuple(o.shape)}")
        qp, kp, vp, masks = vl.pack_varlen(q, k, v, cu_q, cu_k, **kw)
        Tq, Tk = qp.shape[1], kp.shape[1]
        want_o = vl.varlen_fwd_plain(qp, kp, vp, *masks, True, sm)
        within("entry output", o, want_o[:, :tq].transpose(0, 1))
        del o
        ko = drive(f"{tag} varlen_fwd", lambda: vl.varlen_fwd(
            qp, kp, vp, *masks, True, sm), {"varlen_fwd": 1}, main=False)
        err_o = within("varlen_fwd", ko, want_o)
        check(not ko[:, tq:].any(), f"{tag}: varlen_fwd's pad tail is not 0")
        del ko

        pairs = visible_pairs(lens_q, lens_k, align == "bottom-right") * Hq
        ids = 4 * (2 * Tq + 2 * Tk) + masks[4].numel() * 4
        q_el, kv_el = Hq * Tq * D, Hkv * Tk * D
        mask = vl._visible(*(t[:n] for t, n in zip(masks[:4], (tq, tk, tq,
                                                               tk))), True)
        q4, k4, v4, g4 = (t.transpose(0, 1)[None] for t in (q, k, v, g))
        lib = library(q4, k4, v4, mask, g4, dtype, grad,
                      want_o[None, :, :tq])
        case = {"shape": [tq, tk, Hq, Hkv, D], "visible_pairs": pairs,
                "tolerance": f"normwise {tol}"}
        # the forward's kernel by type (one counter for both), and the
        # 16-bit kernel's tile
        if dtype == torch.float32:
            case["kernel"] = "varlen_fwd (CUDA cores)"
        else:
            case.update(kernel="varlen_fwd_mma (mma.sync)",
                        tile=list(vl.varlen_tile(D)))
        res[f"varlen_fwd_{cfg}{name}"] = {
            **case, "max_abs_err": err_o[0], "normwise_err": err_o[1],
            "ms": device_ms(torch, lambda: vl.varlen_fwd(
                qp, kp, vp, *masks, True, sm), 5),
            "plain_ms": device_ms(torch, lambda: vl.varlen_fwd_plain(
                qp, kp, vp, *masks, True, sm), 2),
            **{k_: lib[k_] for k_ in ("library_ms", "library",
                                      "library_normwise_err")},
            **bound(4 * D * pairs, (2 * q_el + 2 * kv_el) * esize + ids,
                    peak)}
        del want_o
        res[f"entry_{cfg}{name}"] = entry
        if not grad:
            return

        part = drive(f"{tag} varlen_fwd_partial",
                     lambda: vl.varlen_fwd_partial(qp, kp, vp, *masks, True,
                                                   sm),
                     {"varlen_fwd_partial": 1}, main=False)
        pacc, pm, pl = vl.varlen_fwd_partial_plain(qp, kp, vp, *masks, True,
                                                    sm)
        seen = pl > 0
        acc, m, l = part
        check(bool((m[~seen] == -1e30).all()) and not l[~seen].any()
              and not acc[~seen].any(), f"{tag}: a row that sees no key "
              f"has l, acc != 0 or M != -1e30")
        check(not l[:, tq:].any(), f"{tag}: l's pad tail is not 0")
        errs = [within("varlen_fwd_partial acc", acc, pacc),
                within("varlen_fwd_partial l", l, pl),
                within("varlen_fwd_partial m", m[seen], pm[seen])]
        del part, acc, m, l
        lv = pl[..., None]
        o_plain = torch.where(lv > 0, pacc / lv, 0.0).to(dtype)
        lse2 = pm + torch.log2(pl)
        gp = vl._pack(g, Tq)
        delta = (gp.float() * o_plain.float()).sum(-1)
        del pacc, pm, pl, lv, seen
        bwd_args = (qp, kp, vp, gp, lse2, delta, *masks, True, sm)
        dkdv = drive(f"{tag} varlen_bwd_dkdv",
                     lambda: vl.varlen_bwd_dkdv(*bwd_args),
                     {"varlen_bwd_dkdv": 1}, main=False)
        want_dkdv = vl.varlen_bwd_dkdv_plain(*bwd_args)
        err_dkdv = [within(f"varlen_bwd_dkdv {n}", a, b)
                    for n, a, b in zip("kv", dkdv, want_dkdv)]
        del dkdv
        dq = drive(f"{tag} varlen_bwd_dq", lambda: vl.varlen_bwd_dq(
            *bwd_args), {"varlen_bwd_dq": 1}, main=False)
        want_dq = vl.varlen_bwd_dq_plain(*bwd_args)
        err_dq = within("varlen_bwd_dq", dq, want_dq)
        del dq

        # the autograd call against the plain versions of every kernel
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]

        def fwd_bwd(grad_out):
            out = vl.flash_attention_varlen(*leaves, cu_q, cu_k, **kw)
            out.backward(grad_out)
            return out

        train = {"varlen_fwd_partial": 1, "varlen_bwd_dkdv": 1,
                 "varlen_bwd_dq": 1}
        out = drive(f"{tag} grad", lambda: fwd_bwd(g), train)
        within("grad output", out.detach(), o_plain[:, :tq].transpose(0, 1))
        grad_errs = {
            lbl: within(f"d{lbl}", t.grad, w[:, :n].transpose(0, 1).to(
                dtype))[1]
            for lbl, t, w, n in (("q", leaves[0], want_dq, tq),
                                 ("k", leaves[1], want_dkdv[0], tk),
                                 ("v", leaves[2], want_dkdv[1], tk))}
        del out, want_dq, want_dkdv, o_plain
        if dtype == torch.float32:
            # one document's gradient reaches no other document
            d0, d1 = int(cu_q[1]), int(cu_q[2])
            g1 = torch.zeros_like(g)
            g1[d0:d1] = g[d0:d1]
            for t in leaves:
                t.grad = None
            drive(f"{tag} one document's gradient", lambda: fwd_bwd(g1),
                  train, main=False)
            for lbl, t in zip("qkv", leaves):
                check(not t.grad[:d0].any() and not t.grad[d1:].any(),
                      f"{tag}: document 1's d{lbl} reaches another document")
                check(bool(t.grad[d0:d1].any()),
                      f"{tag}: document 1's d{lbl} is 0")
            res["no_cross_document_gradient"] = {
                "document": 1, "rows": [d0, d1], "outside_exactly_zero": True}
        entry["forward_backward_ms_median"] = median_ms(lambda: fwd_bwd(g))
        del leaves
        torch.cuda.empty_cache()

        lq_el = Hq * Tq
        res[f"varlen_fwd_{cfg}{name}"]["grad_normwise_err"] = grad_errs
        res[f"varlen_fwd_partial_{cfg}{name}"] = {
            **case, "max_abs_err": max(e[0] for e in errs),
            "normwise_err": max(e[1] for e in errs),
            "ms": device_ms(torch, lambda: vl.varlen_fwd_partial(
                qp, kp, vp, *masks, True, sm), 5),
            "plain_ms": device_ms(torch, lambda: vl.varlen_fwd_partial_plain(
                qp, kp, vp, *masks, True, sm), 2),
            **{k_: lib[k_] for k_ in ("library_ms", "library",
                                      "library_normwise_err")},
            **bound(4 * D * pairs, (q_el + 2 * kv_el) * esize + ids
                    + 4 * q_el + 8 * lq_el, peak)}
        bwd_in = (2 * q_el + 2 * kv_el) * esize + 8 * lq_el + ids
        lib_bwd = {"library_ms": lib["library_bwd_ms"],
                   "library": lib["library"] + ": its backward (dq, dk, dv)"}
        # the backward's kernels by type, and the 16-bit kernels' tiles:
        # (keys a block, query rows a step) and (query rows a block, keys
        # a step), csrc/varlen_bwd.cu's kRows and kStep
        tile = [64, 32 if D > 64 else 64]
        bwd_case = {kname: ({"kernel": f"{kname} (CUDA cores)"}
                            if dtype == torch.float32 else
                            {"kernel": f"{kname}_mma (mma.sync)",
                             "tile": tile})
                    for kname in ("varlen_bwd_dkdv", "varlen_bwd_dq")}
        res[f"varlen_bwd_dkdv_{cfg}{name}"] = {
            **case, **bwd_case["varlen_bwd_dkdv"],
            "max_abs_err": max(e[0] for e in err_dkdv),
            "normwise_err": max(e[1] for e in err_dkdv),
            "ms": device_ms(torch, lambda: vl.varlen_bwd_dkdv(*bwd_args), 3),
            "plain_ms": device_ms(torch, lambda: vl.varlen_bwd_dkdv_plain(
                *bwd_args), 1),
            **lib_bwd, **bound(8 * D * pairs, bwd_in + 8 * kv_el, peak)}
        res[f"varlen_bwd_dq_{cfg}{name}"] = {
            **case, **bwd_case["varlen_bwd_dq"],
            "max_abs_err": err_dq[0], "normwise_err": err_dq[1],
            "ms": device_ms(torch, lambda: vl.varlen_bwd_dq(*bwd_args), 3),
            "plain_ms": device_ms(torch, lambda: vl.varlen_bwd_dq_plain(
                *bwd_args), 1),
            **lib_bwd, **bound(6 * D * pairs, bwd_in + 4 * q_el, peak)}

    # -- the packed training batch ----------------------------------------
    lens = varlen_pack_lengths(c)
    res["pack"] = {"documents": len(lens), "lengths": lens,
                   "tokens": sum(lens), "pack": c["pack"]}
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        run("", lens, lens, 3, dtype, "top-left", grad=True)
        torch.cuda.empty_cache()

    # -- the chunked-prefill step -------------------------------------------
    lens_k = [int(n) for n in np.random.default_rng(1).integers(
        c["chunk"], c["context"] + 1, size=c["chunks"])]
    res["prefill"] = {"chunk": c["chunk"], "key_lengths": lens_k}
    run("prefill_", [c["chunk"]] * c["chunks"], lens_k, 4, torch.bfloat16,
        "bottom-right", grad=False)
    torch.cuda.empty_cache()

    res["launches"] = counted
    res["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    print(json.dumps({"varlen": res}), flush=True)
    return res


# the varlen phase's kernels: (name, source, replaced TPU kernel, headline
# case)
VARLEN_KERNELS = (
    ("varlen_fwd", "flash_attention_varlen.cu",
     "tilelang_mesh_tpu/ops/flash_attention_varlen.py:147", "float32"),
    ("varlen_fwd_partial", "flash_attention_varlen.cu",
     "tilelang_mesh_tpu/ops/flash_attention_varlen.py:123", "float32"),
    ("varlen_bwd_dkdv", "varlen_bwd.cu",
     "tilelang_mesh_tpu/ops/flash_attention_varlen.py:192", "float32"),
    ("varlen_bwd_dq", "varlen_bwd.cu",
     "tilelang_mesh_tpu/ops/flash_attention_varlen.py:274", "float32"))


def sink_sdpa(torch, sk, q, k, v, sinks, window, want):
    """SDPA computing attention with sinks, timed: K and V expanded
    by the group, then per head one key and value row of zeros (the
    sink) and 15 pad rows, 16-aligned; an additive mask (1, Hq, S, S
    + 16) in q's type, 0 where the causal / window mask keeps a pair,
    the head's sink logit in the zero key's column, -inf elsewhere.
    softmax([scores, sink]) @ [V; 0] is then the sink kernel's
    function. The operands are built outside the timed calls. float32
    on the memory-efficient kernel; bfloat16 and float16 on cuDNN where
    it takes the mask, else memory-efficient. Held within 2e-2 normwise of the
    plain version's ``want`` (``sk`` is ops/attention_sink.py)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    Hq, S, D = q.shape[1], q.shape[2], q.shape[3]
    pad = torch.zeros((1, Hq, 16, D), dtype=q.dtype, device=q.device)
    kx, vx = (torch.cat([t.repeat_interleave(Hq // k.shape[1], 1), pad],
                        2) for t in (k, v))
    bias = torch.full((1, Hq, S, S + 16), -math.inf, dtype=q.dtype,
                      device=q.device)
    bias[..., :S].masked_fill_(sk.visible(S, S, True, window, q.device),
                               0.0)
    bias[..., S] = sinks.to(q.dtype).view(Hq, 1)
    backends = ([SDPBackend.EFFICIENT_ATTENTION] if q.dtype ==
                torch.float32 else [SDPBackend.CUDNN_ATTENTION,
                                    SDPBackend.EFFICIENT_ATTENTION])

    def call():
        return F.scaled_dot_product_attention(q, kx, vx, attn_mask=bias)

    for backend in backends:
        try:
            with sdpa_kernel([backend]):
                rel = normwise_err(call(), want)[1]
        except RuntimeError:             # this backend refuses the call
            continue
        check(rel < 2e-2, f"the library yardstick (SDPA with a zero "
                          f"sink key, {backend.name}) disagrees with "
                          f"the plain version: {rel:.3e}")
        with sdpa_kernel([backend]):
            ms = device_ms(torch, call, 3)
        return {"library_ms": ms, "library_normwise_err": rel,
                "library": f"SDPA ({backend.name}), K and V expanded by "
                           f"the group with a zero sink key, the sink "
                           f"logits in an additive mask (1, Hq, S, "
                           f"S + 16)"}
    check(False, f"no SDPA backend of {backends} takes the sink "
                 f"yardstick's float mask")


def attention_family_phase(torch, sk, smx, bsa, seer, fa, gq, gb):
    """Sink attention at gpt-oss-20b's attention widths (GPT_OSS), the
    row softmax at its vocabulary row and the MoE router's width, and
    block-sparse and seer attention at LLaMA-2-7B's (SPARSE_ATTN): each
    main-path call through the public entry point with every counter
    zeroed before it and read right after (attention_sink, softmax,
    blocksparse_attention, seer_attention: one launch of their kernel;
    the sink training step: one GQA partial, one dK/dV, one dQ); each
    output (and the step's gradients) against the plain versions on the
    card, the step's also against autograd through the dense reference;
    the windowed sink beside the full-causal one; kernel, plain and
    library times (for the sink, SDPA with a zero sink key and the sink
    logits in its mask; SDPA on the sink-less attention as context,
    named apart) and the bound by the visible pairs or the bytes; a dead
    block-sparse row exactly 0 and an all-ones causal mask equal to
    plain causal attention."""
    import numpy as np
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    mods = (sk, smx, bsa, fa, gq, gb)
    counted = {k: 0 for m in (sk, smx, bsa, gq, gb) for k in m.launches}
    res = {}
    reset_peak(torch)

    def drive(label, call, want_launches, main=True):
        torch.cuda.synchronize()
        for m in mods:
            m.reset_launches()
        out = call()
        torch.cuda.synchronize()
        got = {k: n for m in mods for k, n in m.launches.items()}
        want = {k: want_launches.get(k, 0) for k in got}
        check(got == want, f"{label}: launches {got}, want {want}")
        for k in counted:
            counted[k] += got[k] if main else 0
        return out

    def within(label, got, want, tol):
        check(tuple(got.shape) == tuple(want.shape)
              and got.dtype == want.dtype, f"{label}: {got.dtype} "
              f"{tuple(got.shape)}, want {want.dtype} {tuple(want.shape)}")
        check(bool(torch.isfinite(got.float()).all()),
              f"{label}: non-finite output")
        err, rel = normwise_err(got, want)
        check(rel <= tol, f"{label} disagrees with its plain version: "
                          f"{rel:.3e} of max |plain| > {tol}")
        return err, rel

    def bound(flops, nbytes, peak):
        t, by = mm_bound(flops, nbytes, peak)
        return {"bound_ms": t, "bound_by": by, "ops": flops,
                "bytes": nbytes}

    def tname(dtype):
        return str(dtype).replace("torch.", "")

    def sink_library(q, k, v, sinks, window, want):
        return sink_sdpa(torch, sk, q, k, v, sinks, window, want)

    # -- attention with sinks at gpt-oss-20b's widths ----------------------
    c = GPT_OSS
    Hq, Hkv, D, S, W = (c["heads"], c["kv_heads"], c["head_dim"], c["seq"],
                        c["window"])
    sm = 1.0 / math.sqrt(D)
    rng = np.random.default_rng(5)
    base = [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
            for shape in ((1, Hq, S, D), (1, Hkv, S, D), (1, Hkv, S, D),
                          (1, Hq, S, D), (Hq,))]
    full_pairs = causal_pairs(S, S)
    win_pairs = sum(min(i + 1, W) for i in range(S))
    # the key tiles a block visits, by the kernel's loop bounds
    # (csrc/attention_sink.cu kv_span) at each type's tile: float32's 64 x
    # 32, the tensor-core kernel's sink_tile (its warps skip more)
    def span_tiles(tm, tn, window):
        return [min((S - 1) // tn, (q0 + tm - 1) // tn)
                - (max(0, q0 - window + 1) // tn if window else 0) + 1
                for q0 in range(0, S, tm)]

    res["sink_tiles_per_block"] = {}
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for case, window in (("full", 0), ("window", W)):
            tm, tn = ((64, 32) if dtype == torch.float32
                      else sk.sink_tile(D, window))
            v = span_tiles(tm, tn, window)
            res["sink_tiles_per_block"][f"{case}_{tname(dtype)}"] = {
                "tile": [tm, tn], "blocks": len(v), "max": max(v),
                "mean": sum(v) / len(v)}
    sinks = base[4].cuda()
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        name = tname(dtype)
        tol = ATTN_TOL[name]
        esize = torch.empty((), dtype=dtype).element_size()
        peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
        q, k, v, g = (t.cuda().to(dtype) for t in base[:4])
        io_bytes = (2 * Hq + 2 * Hkv) * S * D * esize + 4 * Hq
        sdpa = device_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), 3)
        for case, window, pairs in (("causal", None, full_pairs),
                                    ("window128", W, win_pairs)):
            wn = window or 0
            with torch.no_grad():
                o = drive(f"attention_sink {case} {name}",
                          lambda: sk.attention_sink(q, k, v, sinks,
                                                    window_size=window),
                          {"attention_sink": 1})
            want = sk.sink_fwd_plain(q, k, v, sinks, True, wn, sm)
            err = within(f"attention_sink {case} {name}", o, want, tol)
            del o
            lib = sink_library(q, k, v, sinks, wn, want)
            del want
            torch.cuda.empty_cache()
            entry = {
                "shape": [1, Hq, Hkv, S, D], "window": window,
                "visible_pairs": pairs * Hq, "max_abs_err": err[0],
                "normwise_err": err[1], "tolerance": f"normwise {tol}",
                "ms": device_ms(torch, lambda: sk.sink_fwd(
                    q, k, v, sinks, True, wn, sm), 5),
                "plain_ms": device_ms(torch, lambda: sk.sink_fwd_plain(
                    q, k, v, sinks, True, wn, sm), 2),
                **lib, **bound(4 * D * pairs * Hq, io_bytes, peak)}
            if window is None:
                entry["sdpa_without_sinks_ms"] = sdpa
                entry["sdpa_without_sinks"] = ("SDPA, is_causal, enable_gqa, "
                                               "no sinks (not the same "
                                               "function)")
            res[f"attention_sink_{case}_{name}"] = entry
        full = res[f"attention_sink_causal_{name}"]["ms"]
        windowed = res[f"attention_sink_window128_{name}"]["ms"]
        print(f"attention_sink {name}: full causal {full:.4f} ms, window "
              f"{W} {windowed:.4f} ms ({windowed / full:.3f} of it)",
              flush=True)
        check(windowed < full / 5, f"attention_sink {name}: the window-{W} "
              f"call takes {windowed:.4f} ms, not under a fifth of full "
              f"causal's {full:.4f}: tiles outside the window are visited")
        # two calls give the same bits (float32: sink_fwd; the 16-bit
        # types: sink_fwd_mma); no atomics
        with torch.no_grad():
            check(torch.equal(sk.attention_sink(q, k, v, sinks),
                              sk.attention_sink(q, k, v, sinks)),
                  f"attention_sink {name}: two calls differ")
        if dtype == torch.float16:      # the training step: f32 and bf16
            del q, k, v, g
            torch.cuda.empty_cache()
            continue

        # the training step: the GQA partial + the fold, dK/dV, dQ
        acc, m, l = gq.gqa_fwd_partial_plain(q, k, v, True, sm)
        o_plain, lse2 = sk.sink_stats(acc, m, l, sinks, dtype)
        del acc, m, l
        delta = (g.float() * o_plain.float()).sum(-1)
        want = [*gb.gqa_bwd_dkdv_plain(q, k, v, g, lse2, delta, True, sm)]
        want = [gb.gqa_bwd_dq_plain(q, k, v, g, lse2, delta, True, sm),
                *want, sk.sink_grad(lse2, delta, sinks)]
        del lse2, delta
        leaves = [t.detach().requires_grad_() for t in (q, k, v, sinks)]

        def step():
            out = sk.attention_sink(*leaves, backward="kernel")
            out.backward(g)
            return out

        train = {"gqa_fwd_partial": 1, "gqa_bwd_dkdv": 1, "gqa_bwd_dq": 1}
        out = drive(f"attention_sink training step {name}", step, train)
        errs = {"o": within(f"sink step output {name}", out.detach(),
                            o_plain, tol)[1]}
        for lbl, t, w in zip(("dq", "dk", "dv", "dsinks"), leaves, want):
            errs[lbl] = within(f"sink step {lbl} {name}", t.grad,
                               w.to(t.dtype), tol)[1]
        del o_plain, want
        # the same step by autograd through the dense reference, which
        # shares no code with the fold (sink_stats) or the closed-form
        # dSinks (sink_grad) that the plain side above reuses
        ref = [t.detach().requires_grad_() for t in (q, k, v, sinks)]
        ref_o = sk.attention_sink_reference(*ref)
        ref_o.backward(g)
        rtol = SINK_REF_TOL[name]
        ref_errs = {"o": within(f"sink step output {name} vs the reference",
                                out.detach(), ref_o.detach(), rtol)[1]}
        for lbl, t, r in zip(("dq", "dk", "dv", "dsinks"), leaves, ref):
            ref_errs[lbl] = within(f"sink step {lbl} {name} vs the reference",
                                   t.grad, r.grad, rtol)[1]
        del out, ref_o, ref
        for t in leaves:
            t.grad = None
        torch.cuda.empty_cache()

        def sdpa_step():
            lv = [t.detach().requires_grad_() for t in (q, k, v)]
            F.scaled_dot_product_attention(*lv, is_causal=True,
                                           enable_gqa=True).backward(g)

        bhsd, kvsd = Hq * S * D, Hkv * S * D
        res[f"sink_train_{name}"] = {
            "shape": [1, Hq, Hkv, S, D], "normwise_err": errs,
            "tolerance": f"normwise {tol}",
            "reference_normwise_err": ref_errs,
            "reference_tolerance": f"normwise {rtol}",
            "ms": device_ms(torch, step, 3),
            "sdpa_without_sinks_ms": device_ms(torch, sdpa_step, 3),
            "sdpa_without_sinks": "SDPA forward + backward, is_causal, "
                                  "enable_gqa, no sinks",
            # #9 + #3 + #4 at this shape: 4 + 8 + 6 flops per pair and dim
            **bound(18 * D * full_pairs * Hq,
                    (5 * bhsd + 4 * kvsd) * esize + 4 * (bhsd + 2 * kvsd)
                    + 8 * Hq * S + 8 * Hq, peak)}
        del leaves, q, k, v, g
        torch.cuda.empty_cache()

    # -- the row softmax ---------------------------------------------------
    gen = torch.Generator(device="cuda").manual_seed(9)
    for case, M, N, din in (
            ("vocab", c["vocab_rows"], c["vocab"], torch.float32),
            ("vocab_bf16", c["vocab_rows_bf16"], c["vocab"], torch.bfloat16),
            ("router", c["router_rows"], c["router_width"], torch.float32)):
        x = (4 * torch.randn((M, N), generator=gen, device="cuda")).to(din)
        path = smx.softmax_path(N, din, x.data_ptr() % 16 == 0)
        y = drive(f"softmax {case}", lambda: smx.softmax(
            x, out_dtype=torch.float32), {"softmax": 1})
        ran = [k for k, n in smx.kernel_launches.items() if n]
        check(ran == [path.kernel], f"softmax {case}: launched {ran}, the "
                                    f"path rule names {path.kernel}")
        kernel = (f"{path.kernel} (C {path.param})"
                  if path.kernel == "softmax_cluster" else
                  f"{path.kernel} (G {path.param})"
                  if path.kernel == "softmax_rows" else path.kernel)
        err = within(f"softmax {case}", y, smx.softmax_plain(
            x, torch.float32), 1e-5)
        rows = y.sum(1, dtype=torch.float64)
        check(bool(((rows - 1).abs() < 1e-4).all()),
              f"softmax {case}: a row sums to {float(rows.min())}..."
              f"{float(rows.max())}")
        del y, rows
        nbytes = M * N * (x.element_size() + 4)
        res[f"softmax_{case}"] = {
            "shape": [M, N], "in": tname(din), "out": "float32",
            "kernel": kernel, "max_abs_err": err[0], "normwise_err": err[1],
            "tolerance": "normwise 1e-5",
            "ms": device_ms(torch, lambda: smx.softmax(
                x, out_dtype=torch.float32), 5 if N > 8 else 50),
            "plain_ms": device_ms(torch, lambda: smx.softmax_plain(
                x, torch.float32), 2 if N > 8 else 20),
            "library_ms": device_ms(torch, lambda: torch.softmax(
                x, 1, dtype=torch.float32), 5 if N > 8 else 50),
            "library": "torch.softmax(x, 1, dtype=float32)",
            **bound(4 * M * N, nbytes, PEAK_F32_FLOPS)}
        if path.kernel == "softmax_cluster":
            res[f"softmax_{case}"]["cluster_fit"] = dict(zip(
                ("ctas_an_sm", "clusters"),
                smx.cluster_fit(N, din, torch.float32, path.param)))
        del x
        torch.cuda.empty_cache()

    # -- block-sparse and seer attention at LLaMA-2-7B's widths ------------
    c = SPARSE_ATTN
    H, D, S, blk = c["heads"], c["head_dim"], c["seq"], c["block"]
    sm = 1.0 / math.sqrt(D)
    n = S // blk
    rng = np.random.default_rng(8)
    base = [torch.from_numpy(rng.standard_normal((1, H, S, D),
                                                 dtype=np.float32))
            for _ in range(3)]
    rand_mask = torch.from_numpy(
        (np.random.default_rng(6).random((1, H, n, n)) < c["density"])
        .astype(np.int32)).cuda()
    gates = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (1, H, n, n)).astype(np.float32)).cuda()
    seer_mask = seer.seer_block_mask(gates, c["topk"], blk, blk)
    res["blocksparse_masks"] = {
        "random_density": float(rand_mask.float().mean()),
        "seer_density": float(seer_mask.float().mean())}
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        name = tname(dtype)
        tol = ATTN_TOL[name]
        esize = torch.empty((), dtype=dtype).element_size()
        peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
        q, k, v = (t.cuda().to(dtype) for t in base)
        for case, mask, causal, call in (
                ("random", rand_mask, False,
                 lambda: bsa.blocksparse_attention(q, k, v, rand_mask)),
                ("seer", seer_mask, True,
                 lambda: seer.seer_attention(q, k, v, gates,
                                             topk=c["topk"]))):
            # float32 on CUDA cores, 16-bit on the tensor cores at the
            # host's tile; the pairs of its live tiles at the peak beside
            # the bound
            tile = (None if dtype == torch.float32 else
                    bsa.blocksparse_tile(D, blk, blk, causal))
            with torch.no_grad():
                o = drive(f"{case} attention {name}", call,
                          {"blocksparse_mha": 1})
            want = bsa.blocksparse_mha_plain(q, k, v, mask, blk, blk, causal,
                                             sm)
            err = within(f"{case} attention {name}", o, want, tol)
            del o
            dense = bsa.dense_mask(mask, blk, blk, causal)
            pairs = int(dense.sum())
            lib = F.scaled_dot_product_attention(q, k, v, attn_mask=dense)
            lib_err = normwise_err(lib, want)[1]
            check(lib_err < 2e-2, f"the library yardstick (SDPA, bool mask) "
                                  f"disagrees with the plain version: "
                                  f"{lib_err:.3e}")
            del lib, want
            rec = res[f"blocksparse_mha_{case}_{name}"] = {
                "shape": [1, H, S, D], "block": blk, "causal": causal,
                "kernel": ("blocksparse_mha (CUDA cores)" if tile is None
                           else "blocksparse_mha_mma (mma.sync)"),
                "live_cells": int(mask.sum()), "visible_pairs": pairs,
                "max_abs_err": err[0], "normwise_err": err[1],
                "tolerance": f"normwise {tol}",
                "ms": device_ms(torch, lambda: bsa.blocksparse_mha(
                    q, k, v, mask, blk, blk, causal, sm), 5),
                "plain_ms": device_ms(torch, lambda: bsa.blocksparse_mha_plain(
                    q, k, v, mask, blk, blk, causal, sm), 2),
                "library_ms": device_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=dense), 3),
                "library": "SDPA with the dense bool mask (B, H, S, S)",
                "library_normwise_err": lib_err,
                **bound(4 * D * pairs, 4 * H * S * D * esize
                        + 4 * mask.numel(), peak)}
            if tile is not None:
                tp = tile_pairs(torch, mask, blk, blk, S, S, tile, causal)
                rec.update({"tile": list(tile), "tile_pairs": tp,
                            "tile_bound_ms": 4 * D * tp / peak * 1e3})
            del dense
        # a query block whose every cell is dead gives exactly 0; an
        # all-ones causal mask is plain causal attention
        r = n // 2
        dead = rand_mask.clone()
        dead[0, 0, r] = 0
        o = drive(f"blocksparse dead row {name}",
                  lambda: bsa.blocksparse_attention(q, k, v, dead),
                  {"blocksparse_mha": 1}, main=False)
        check(not o[0, 0, r * blk:(r + 1) * blk].any()
              and bool(o[0, 0, (r + 1) * blk:].abs().min(-1)[0].gt(0)
                       .all()),
              f"blocksparse {name}: a row of dead cells is not exactly 0, "
              f"or a live row is")
        ones = torch.ones_like(rand_mask)
        o = drive(f"blocksparse all ones causal {name}",
                  lambda: bsa.blocksparse_attention(q, k, v, ones,
                                                    causal=True),
                  {"blocksparse_mha": 1}, main=False)
        res.setdefault("blocksparse_zero_checks", {})[name] = {
            "dead_row_exactly_zero": f"head 0, query block {r}",
            "all_ones_causal_vs_mha_fwd_plain": within(
                f"blocksparse all ones causal {name}", o,
                fa.mha_fwd_plain(q, k, v, True, sm), tol)[1]}
        del o, dead, ones
        del q, k, v
        torch.cuda.empty_cache()

    res["launches"] = counted
    res["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    print(json.dumps({"attention_family": res}), flush=True)
    return res


# the attention_family phase's kernels: (name, source, replaced TPU kernel,
# headline case)
ATTN_FAMILY_KERNELS = (
    # sink_fwd (float32) and the tensor-core sink_fwd_mma (bfloat16,
    # float16): one counter, "attention_sink"; cases under "variants"
    ("attention_sink", "attention_sink.cu",
     "tilelang_mesh_tpu/ops/attention_sink.py:30", "causal_float32"),
    ("softmax", "softmax.cu", "tilelang_mesh_tpu/ops/softmax.py:29",
     "vocab"),
    ("blocksparse_mha", "blocksparse_attention.cu",
     "tilelang_mesh_tpu/ops/blocksparse_attention.py:21", "random_float32"))


def vs_estimate(torch, q, k, n_vertical, n_slash, last_q):
    """The vertical and slash indices of
    examples/minference/example_vertical_slash_sparse_attn.py:14-32, in
    torch: the last ``last_q`` queries' causal softmax; the columns of
    most mass and the diagonals (i - j) of most mass."""
    B, H, S, D = q.shape
    dev = q.device
    qk = torch.einsum("bhqd,bhkd->bhqk", q[:, :, -last_q:].float(),
                      k.float()) / math.sqrt(D)
    qi = torch.arange(S - last_q, S, device=dev)[:, None]
    kj = torch.arange(S, device=dev)[None, :]
    p = torch.softmax(qk.masked_fill(qi < kj, -math.inf), dim=-1)
    v_idx = torch.argsort(-p.sum(2), dim=-1, stable=True)[..., :n_vertical]
    offs = qi - kj
    slash = torch.zeros((B, H, S), device=dev)
    slash.index_add_(2, offs.clamp(0, S - 1).reshape(-1),
                     torch.where(offs >= 0, p, 0.0).reshape(B, H, -1))
    s_idx = torch.argsort(-slash, dim=-1, stable=True)[..., :n_slash]
    return v_idx.to(torch.int32), s_idx.to(torch.int32)


def nsa_selections(rng, pos, H, S, BS):
    """(len(pos), H, S) int32 block ids for tokens at the local positions
    ``pos``: block 0, the token's own block, the one before and S - 3
    more drawn from the blocks between; a token with at most S blocks
    behind it takes all of them, -1 padded (as
    tests/test_sparse_attention.py:65-76)."""
    import numpy as np
    own = np.asarray(pos) // BS
    nb = int(own.max()) + 1
    blocks = np.arange(nb)
    keys = rng.random((len(own), H, nb))
    between = (blocks >= 1) & (blocks[None, :] <= own[:, None] - 2)
    keys = np.where(between[:, None, :], keys, -1.0)
    extra = np.argsort(-keys, axis=-1, kind="stable")[..., :S - 3]
    ones = np.ones((len(own), H, 1), np.int64)
    sel = np.concatenate([0 * ones, (own - 1)[:, None, None] * ones,
                          own[:, None, None] * ones, extra], -1)
    few = own < S
    if few.any():
        first = np.arange(S)[None, :]
        sel[few] = np.where(first <= own[few, None], first, -1)[:, None, :]
    return sel.astype(np.int32)


def nsa_documents():
    """The lengths of NSA's packed documents: drawn from default_rng(13)
    in [min_doc, max_doc], none a multiple of the block, summing to the
    sequence length."""
    import numpy as np
    c = NSA
    T, BS = c["seq"], c["block"]
    lens = []
    drng = np.random.default_rng(13)
    while sum(lens) + c["max_doc"] < T:
        n = int(drng.integers(c["min_doc"], c["max_doc"] + 1))
        if n % BS:
            lens.append(n)
    rest = T - sum(lens)                 # the last document's length,
    shift = next(x for x in range(BS)    # moved by a few tokens off a
                 if (rest - x) % BS and (lens[-1] + x) % BS)   # multiple
    lens[-1] += shift
    lens.append(rest - shift)
    check(sum(lens) == T and all(n % BS for n in lens),
          f"varlen lengths {lens}")
    return lens


def selected_keys(torch, starts, bound, BS):
    """Keys each slot of ``starts`` (first keys, -1: none) contributes
    under the causal ``bound`` (broadcast against starts' leading dims),
    summed."""
    n = (bound - starts.long() + 1).clamp(0, BS)
    return int(torch.where(starts >= 0, n, 0).sum())


def sparse_inference_phase(torch, mi, nsa):
    """Sparse-attention inference: vertical_slash_sparse_attention at
    LLaMA-3-8B-Instruct-262k's attention widths (MINFERENCE), and
    nsa_attention, nsa_attention_varlen and nsa_decode at the NSA paper's
    (NSA); each main-path call through the public entry point with every
    counter zeroed before it and read right after (one launch of its
    kernel); each output against the plain version on the card; a row
    that sees nothing exactly 0; kernel, plain and library times (SDPA
    over the dense bool masks, built outside the timed calls; for decode
    over the gathered blocks, gathered outside the timed call and
    inside it) and the bound by the visible pairs or the bytes."""
    import numpy as np
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    mods = (mi, nsa)
    counted = {k: 0 for m in mods for k in m.launches}
    res = {}
    reset_peak(torch)

    def drive(label, call, want_launches, main=True):
        torch.cuda.synchronize()
        for m in mods:
            m.reset_launches()
        with torch.no_grad():
            out = call()
        torch.cuda.synchronize()
        got = {k: n for m in mods for k, n in m.launches.items()}
        want = {k: want_launches.get(k, 0) for k in got}
        check(got == want, f"{label}: launches {got}, want {want}")
        for k in counted:
            counted[k] += got[k] if main else 0
        return out

    def within(label, got, want, tol):
        check(tuple(got.shape) == tuple(want.shape)
              and got.dtype == want.dtype, f"{label}: {got.dtype} "
              f"{tuple(got.shape)}, want {want.dtype} {tuple(want.shape)}")
        check(bool(torch.isfinite(got.float()).all()),
              f"{label}: non-finite output")
        err, rel = normwise_err(got, want)
        check(rel <= tol, f"{label} disagrees with its plain version: "
                          f"{rel:.3e} of max |plain| > {tol}")
        return err, rel

    def bound(flops, nbytes, peak):
        t, by = mm_bound(flops, nbytes, peak)
        return {"bound_ms": t, "bound_by": by, "ops": flops,
                "bytes": nbytes}

    def library(label, call, want, name, rows=None, backends=None):
        """SDPA computing the kernel's function, timed: the first backend
        that takes the call of ``backends``, by default float32's
        memory-efficient kernel, or cuDNN then the memory-efficient
        kernel in 16-bit; held within 2e-2 normwise of the plain
        version's ``want`` (on ``rows`` where given: SDPA gives NaN on a
        row that sees nothing)."""
        if backends is None:
            backends = ([SDPBackend.EFFICIENT_ATTENTION]
                        if want.dtype == torch.float32 else
                        [SDPBackend.CUDNN_ATTENTION,
                         SDPBackend.EFFICIENT_ATTENTION])
        for backend in backends:
            try:
                with sdpa_kernel([backend]):
                    got = call()
            except RuntimeError:             # this backend refuses the call
                continue
            if rows is not None:
                got, want = got[rows], want[rows]
            rel = normwise_err(got, want)[1]
            del got
            check(rel < 2e-2, f"{label}: the library yardstick "
                              f"({backend.name}) disagrees with the plain "
                              f"version: {rel:.3e}")
            with sdpa_kernel([backend]):
                ms = device_ms(torch, call, 2)
            return {"library_ms": ms, "library_normwise_err": rel,
                    "library": f"{name} ({backend.name})"}
        check(False, f"{label}: no SDPA backend of {backends} takes the "
                     f"call")

    def tname(dtype):
        return str(dtype).replace("torch.", "")

    # -- vertical-slash attention at LLaMA-3-8B-Instruct-262k's widths -----
    c = MINFERENCE
    H, D, S, blk = c["heads"], c["head_dim"], c["seq"], c["block"]
    sm = 1.0 / math.sqrt(D)
    rng = np.random.default_rng(11)
    rep = H // c["kv_heads"]
    base = [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
            for shape in ((1, H, S, D), (1, c["kv_heads"], S, D),
                          (1, c["kv_heads"], S, D))]
    base[1:] = [t.repeat_interleave(rep, 1) for t in base[1:]]
    q, k = (t.cuda() for t in base[:2])
    v_idx, s_idx = vs_estimate(torch, q, k, c["vertical"], c["slash"],
                               c["last_q"])
    vm, bm = mi._build_masks(v_idx, s_idx, S, S, blk, blk)
    dm = mi.diagonal_mask(s_idx, S)
    dense = torch.empty((1, H, S, S), dtype=torch.bool, device="cuda")
    j = torch.arange(S, device="cuda")
    pairs = 0
    for i0 in range(0, S, 1024):
        i = j[i0:i0 + 1024]
        d = i[:, None] - j[None, :]
        rows = (((vm != 0)[:, :, None, :] | (dm != 0)[:, :, d.clamp_min(0)])
                & (d >= 0) & (bm != 0)[:, :, i // blk][..., j // blk])
        dense[:, :, i0:i0 + 1024] = rows
        pairs += int(torch.count_nonzero(rows))
    del rows, d
    seen = dense.any(-1)
    res["vs_sparse_masks"] = {
        "vertical": c["vertical"], "slash": c["slash"],
        "live_cells": int(bm.sum()), "cells": bm.numel(),
        "visible_pairs": pairs, "causal_pairs": causal_pairs(S, S) * H,
        "rows_seeing_nothing": int((~seen).sum())}
    del q, k
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        name = tname(dtype)
        tol = ATTN_TOL.get(name, 2e-2)
        esize = torch.empty((), dtype=dtype).element_size()
        peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
        q, k, v = (t.cuda().to(dtype) for t in base)
        o = drive(f"vertical_slash {name}",
                  lambda: mi.vertical_slash_sparse_attention(
                      q, k, v, v_idx, s_idx, block_M=blk, block_N=blk),
                  {"vs_sparse": 1})
        want = mi.vs_sparse_plain(q, k, v, vm, dm, bm, blk, blk, sm)
        err = within(f"vertical_slash {name}", o, want, tol)
        check(not o[~seen].any(), f"vertical_slash {name}: a row that "
                                  f"sees nothing is not exactly 0")
        del o
        lib = library(f"vertical_slash {name}",
                      lambda: F.scaled_dot_product_attention(
                          q, k, v, attn_mask=dense), want,
                      "SDPA over the dense bool mask (1, H, S, S)", seen)
        del want
        torch.cuda.empty_cache()
        rec = res[f"vs_sparse_{name}"] = {
            "shape": [1, H, S, D], "block": blk, "max_abs_err": err[0],
            "kernel": ("vs_sparse (CUDA cores)" if dtype == torch.float32
                       else "vs_sparse_mma (mma.sync)"),
            "normwise_err": err[1], "tolerance": f"normwise {tol}",
            "ms": device_ms(torch, lambda: mi.vs_sparse(
                q, k, v, vm, dm, bm, blk, blk, sm), 3),
            "entry_ms": device_ms(
                torch, lambda: mi.vertical_slash_sparse_attention(
                    q, k, v, v_idx, s_idx, block_M=blk, block_N=blk), 3),
            "plain_ms": device_ms(torch, lambda: mi.vs_sparse_plain(
                q, k, v, vm, dm, bm, blk, blk, sm), 1),
            **lib, **bound(4 * D * pairs, 4 * H * S * D * esize
                           + 4 * (vm.numel() + dm.numel() + bm.numel()),
                           peak)}
        if dtype != torch.float32:
            # the pairs of the kernel's live tiles (at these patterns the
            # causal triangle) at the peak, beside the bound
            tile = mi.vs_tile(D, blk, blk)
            tp = tile_pairs(torch, bm, blk, blk, S, S, tile, True)
            rec.update({"tile": list(tile), "tile_pairs": tp,
                        "tile_bound_ms": 4 * D * tp / peak * 1e3})
        if dtype == torch.float32:
            # rows 0-4 see nothing under one slash at 5 and one column at
            # S - 1: exactly 0
            one = torch.full((1, H, 1), S - 1, dtype=torch.int32,
                             device="cuda")
            o = drive("vertical_slash empty rows",
                      lambda: mi.vertical_slash_sparse_attention(
                          q, k, v, one, one * 0 + 5), {"vs_sparse": 1},
                      main=False)
            check(not o[:, :, :5].any() and bool(o[:, :, 5].abs().sum(-1)
                                                  .gt(0).all()),
                  "vertical_slash: a row that sees nothing is not exactly "
                  "0, or a row that sees a key is")
            res["vs_sparse_zero_check"] = "rows 0-4 of every head exactly 0"
            del o
        del q, k, v
        torch.cuda.empty_cache()
    del dense, seen, base
    torch.cuda.empty_cache()

    # -- NSA at the NSA paper's widths -------------------------------------
    c = NSA
    HQ, Hk, D, BS, S, W, T = (c["heads"], c["kv_heads"], c["head_dim"],
                              c["block"], c["selected"], c["window"],
                              c["seq"])
    G = HQ // Hk
    sm = 1.0 / math.sqrt(D)
    rng = np.random.default_rng(12)
    base = [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
            for shape in ((1, T, HQ, D), (1, T, Hk, D), (1, T, Hk, D))]
    gates = [torch.from_numpy(rng.uniform(0.2, 1.0, (1, T, HQ))
                              .astype(np.float32)).cuda() for _ in range(2)]
    bi = torch.from_numpy(nsa_selections(rng, np.arange(T), Hk, S, BS))[
        None].cuda()
    cnt = torch.full((1, T, Hk), S, dtype=torch.int32, device="cuda")
    t_idx = torch.arange(T, device="cuda")
    sel_keys = selected_keys(torch, bi.long() * BS,
                             t_idx[None, :, None, None], BS)
    win_keys = sum(min(t + 1, W) for t in range(T))
    # the dense selected mask (1, HQ, T, T) and the window's (1, 1, T, T)
    nb = T // BS
    blkm = torch.zeros((Hk, T, nb + 1), dtype=torch.bool, device="cuda")
    blkm.scatter_(2, torch.where(bi[0] >= 0, bi[0], nb).long()
                  .permute(1, 0, 2), True)
    causal = torch.ones((T, T), dtype=torch.bool, device="cuda").tril()
    sel_dense = (blkm[..., :nb].repeat_interleave(BS, -1)[..., :T]
                 & causal).repeat_interleave(G, 0)[None]
    d = t_idx[:, None] - t_idx[None, :]
    win_dense = ((d >= 0) & (d < W)).expand(1, HQ, T, T).contiguous()
    del blkm, causal, d
    check(int(torch.count_nonzero(sel_dense[0, ::G])) == sel_keys,
          "nsa: the dense selected mask and the slots' keys disagree")
    res["nsa_selection"] = {"selected_keys": sel_keys,
                            "window_keys": win_keys * Hk}

    for dtype in (torch.float32, torch.bfloat16):
        name = tname(dtype)
        tol = ATTN_TOL[name]
        esize = torch.empty((), dtype=dtype).element_size()
        peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
        q, k, v = (t.cuda().to(dtype) for t in base)
        q5 = q.reshape(1, T, Hk, G, D)
        kh, vh = k.transpose(1, 2), v.transpose(1, 2)
        gs, gw = (g.reshape(1, T, Hk, G) for g in gates)
        o = drive(f"nsa_attention {name}", lambda: nsa.nsa_attention(
            q, k, v, gates[0], gates[1], bi, block_size=BS, window_size=W),
            {"nsa_fwd": 1})
        want = nsa.nsa_fwd_plain(q5, kh, vh, bi, cnt, gs, gw, BS, W, sm)
        err = within(f"nsa_attention {name}", o, want.reshape(o.shape), tol)
        del o
        qh = q.transpose(1, 2)
        kx, vx = (t.transpose(1, 2).repeat_interleave(G, 1) for t in (k, v))
        gsh, gwh = (g.transpose(1, 2)[..., None].to(dtype) for g in gates)

        def two_sdpa():
            return (F.scaled_dot_product_attention(qh, kx, vx,
                                                   attn_mask=sel_dense) * gsh
                    + F.scaled_dot_product_attention(qh, kx, vx,
                                                     attn_mask=win_dense)
                    * gwh)

        lib = library(f"nsa_attention {name}", two_sdpa,
                      want.reshape(1, T, HQ, D).transpose(1, 2),
                      "two SDPA calls over the dense selected (1, HQ, T, T) "
                      "and window masks, each weighted by its gate")
        del want
        torch.cuda.empty_cache()
        io = (2 * T * HQ * D + 2 * T * Hk * D) * esize
        res[f"nsa_fwd_{name}"] = {
            "shape": [1, T, HQ, Hk, D], "block": BS, "selected": S,
            "window": W, "max_abs_err": err[0], "normwise_err": err[1],
            "tolerance": f"normwise {tol}",
            "ms": device_ms(torch, lambda: nsa.nsa_fwd(
                q5, kh, vh, bi, cnt, gs, gw, BS, W, sm), 3),
            "plain_ms": device_ms(torch, lambda: nsa.nsa_fwd_plain(
                q5, kh, vh, bi, cnt, gs, gw, BS, W, sm), 1),
            **lib, **bound(4 * D * G * (sel_keys + win_keys * Hk),
                           io + 4 * bi.numel() + 4 * cnt.numel()
                           + 8 * T * HQ, peak)}
        if dtype == torch.float32:
            # no slot and no window: exactly 0
            o = drive("nsa_attention empty rows", lambda: nsa.nsa_attention(
                q[:, :256], k[:, :256], v[:, :256], gates[0][:, :256],
                gates[1][:, :256], bi[:, :256], block_counts=0,
                block_size=BS), {"nsa_fwd": 1}, main=False)
            check(not o.any(), "nsa_attention: tokens that select nothing "
                               "are not exactly 0")
            res["nsa_zero_check"] = "256 tokens with block_counts 0 and no " \
                                    "window exactly 0"
            del o
        del q, k, v, q5, kh, vh, qh, kx, vx
        torch.cuda.empty_cache()
    del sel_dense, win_dense
    torch.cuda.empty_cache()

    # -- packed documents ----------------------------------------------------
    lens = nsa_documents()
    cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    pos = np.concatenate([np.arange(n) for n in lens])
    vbi = torch.from_numpy(nsa_selections(rng, pos, Hk, S, BS)).cuda()
    offs, vcnt = nsa.varlen_offsets(vbi, torch.full((T, Hk), S,
                                                    dtype=torch.int32,
                                                    device="cuda"), cu, BS)
    v_keys = selected_keys(torch, offs, t_idx[:, None, None], BS)
    diff = torch.zeros((Hk, T, T + 1), dtype=torch.int16, device="cuda")
    lo = offs.permute(1, 0, 2).long()
    one = torch.ones_like(lo, dtype=torch.int16)
    diff.scatter_add_(2, torch.where(lo >= 0, lo, T), one)
    diff.scatter_add_(2, torch.where(lo >= 0, (lo + BS).clamp_max(T), T),
                      -one)
    vdense = (diff.cumsum(-1, dtype=torch.int16)[..., :T] > 0) & torch.ones(
        (T, T), dtype=torch.bool, device="cuda").tril()
    del diff, lo, one
    check(int(torch.count_nonzero(vdense)) == v_keys,
          "nsa varlen: the dense mask and the slots' keys disagree")
    vdense = vdense.repeat_interleave(G, 0)[None]
    res["nsa_varlen_documents"] = {"lengths": lens, "selected_keys": v_keys}
    vg = gates[0][0]
    for dtype in (torch.float32, torch.bfloat16):
        name = tname(dtype)
        tol = ATTN_TOL[name]
        esize = torch.empty((), dtype=dtype).element_size()
        peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
        q, k, v = (t[0].cuda().to(dtype) for t in base)
        o = drive(f"nsa_attention_varlen {name}",
                  lambda: nsa.nsa_attention_varlen(q, k, v, vg, vbi, cu,
                                                   block_size=BS),
                  {"nsa_varlen_fwd": 1})
        q5 = q.reshape(1, T, Hk, G, D)
        kh, vh = (t.permute(1, 0, 2)[None] for t in (k, v))
        gs = vg.reshape(1, T, Hk, G)
        args = (q5, kh, vh, offs[None], vcnt[None], gs, BS, sm)
        want = nsa.nsa_varlen_fwd_plain(*args)
        err = within(f"nsa_attention_varlen {name}", o, want.reshape(
            o.shape), tol)
        del o
        qh = q.transpose(0, 1)[None]
        kx, vx = (t.transpose(0, 1)[None].repeat_interleave(G, 1)
                  for t in (k, v))
        gh = vg.transpose(0, 1)[None, ..., None].to(dtype)
        lib = library(
            f"nsa_attention_varlen {name}",
            lambda: F.scaled_dot_product_attention(
                qh, kx, vx, attn_mask=vdense) * gh,
            want.reshape(1, T, HQ, D).transpose(1, 2),
            "one SDPA call over the packed selected mask (1, HQ, T, T), "
            "weighted by g_slc")
        del want
        torch.cuda.empty_cache()
        res[f"nsa_varlen_fwd_{name}"] = {
            "shape": [T, HQ, Hk, D], "documents": len(lens),
            "max_abs_err": err[0], "normwise_err": err[1],
            "tolerance": f"normwise {tol}",
            "ms": device_ms(torch, lambda: nsa.nsa_varlen_fwd(*args), 3),
            "plain_ms": device_ms(torch, lambda: nsa.nsa_varlen_fwd_plain(
                *args), 1),
            **lib, **bound(4 * D * G * v_keys,
                           (2 * T * HQ * D + 2 * T * Hk * D) * esize
                           + 8 * T * Hk * S + 4 * T * HQ, peak)}
        if dtype == torch.float32:
            o = drive("nsa_attention_varlen empty rows",
                      lambda: nsa.nsa_attention_varlen(
                          q, k, v, vg, vbi, cu, block_counts=0,
                          block_size=BS), {"nsa_varlen_fwd": 1}, main=False)
            check(not o.any(), "nsa_attention_varlen: tokens that select "
                               "nothing are not exactly 0")
            del o
        del q, k, v, q5, kh, vh, qh, kx, vx
        torch.cuda.empty_cache()
    del vdense, base, gates
    torch.cuda.empty_cache()

    # -- decode over 65536 keys ----------------------------------------------
    Bd, Tk = c["decode_batch"], c["decode_context"]
    base = [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
            for shape in ((Bd, HQ, D), (Bd, Tk, Hk, D), (Bd, Tk, Hk, D))]
    dg = torch.from_numpy(rng.uniform(0.2, 1.0, (Bd, HQ)).astype(
        np.float32)).cuda()
    dbi = torch.from_numpy(nsa_selections(
        rng, np.full(Bd, Tk - 1), Hk, S, BS)).cuda()
    dcnt = torch.full((Bd, Hk), S, dtype=torch.int32, device="cuda")
    d_keys = selected_keys(torch, dbi.long() * BS, Tk - 1, BS)
    keys = (dbi.long() * BS)[..., None] + torch.arange(BS, device="cuda")
    keys = keys.reshape(Bd, Hk, S * BS)
    for dtype in (torch.float32, torch.bfloat16):
        name = tname(dtype)
        tol = ATTN_TOL[name]
        esize = torch.empty((), dtype=dtype).element_size()
        q, k, v = (t.cuda().to(dtype) for t in base)
        o = drive(f"nsa_decode {name}", lambda: nsa.nsa_decode(
            q, k, v, dg, dbi, block_size=BS),
            {"nsa_decode": 1, "nsa_decode_combine": 1})
        kh, vh = k.transpose(1, 2), v.transpose(1, 2)
        args = (q.reshape(Bd, Hk, G, D), kh, vh, dbi, dcnt,
                dg.reshape(Bd, Hk, G), BS, sm)
        want = nsa.nsa_decode_fwd_plain(*args)
        err = within(f"nsa_decode {name}", o, want.reshape(o.shape), tol)
        # the kernels' own split, emulated: the same runs of slots
        splits = nsa.decode_splits(Bd, Hk, S, nsa.resident_blocks(
            q.device, G, D, dtype))
        split_err = within(f"nsa_decode {name} vs its split's plain "
                           f"version", o, nsa.nsa_decode_split_plain(
                               *args, splits).reshape(o.shape), tol)
        del o
        at = (torch.arange(Bd, device="cuda")[:, None, None],
              torch.arange(Hk, device="cuda")[None, :, None], keys)
        kg, vgath = kh[at], vh[at]
        qd = q[:, :, None]
        gd = dg[..., None, None].to(dtype)
        backends = [SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH]
        lib = library(f"nsa_decode {name}",
                      lambda: F.scaled_dot_product_attention(
                          qd, kg, vgath, enable_gqa=True) * gd,
                      want.reshape(Bd, HQ, 1, D),
                      "SDPA with enable_gqa over the selected blocks, "
                      "gathered outside the timed call, weighted by g_slc",
                      backends=backends)
        del kg, vgath
        # the whole function: the gather inside the timed call
        lib_g = library(f"nsa_decode {name} with the gather",
                        lambda: F.scaled_dot_product_attention(
                            qd, kh[at], vh[at], enable_gqa=True) * gd,
                        want.reshape(Bd, HQ, 1, D),
                        "the gather of the selected blocks and SDPA with "
                        "enable_gqa over them, weighted by g_slc",
                        backends=backends)
        del want
        o = drive(f"nsa_decode empty rows {name}", lambda: nsa.nsa_decode(
            q, k, v, dg, dbi, block_counts=0, block_size=BS),
            {"nsa_decode": 1, "nsa_decode_combine": 1}, main=False)
        check(not o.any(), "nsa_decode: a step that selects nothing is not "
                           "exactly 0")
        del o
        res[f"nsa_decode_{name}"] = {
            "shape": [Bd, Tk, HQ, Hk, D], "splits": splits,
            "blocks": Bd * Hk * splits,
            "max_abs_err": err[0], "normwise_err": err[1],
            "split_plain_normwise_err": split_err[1],
            "tolerance": f"normwise {tol}",
            "ms": device_ms(torch, lambda: nsa.nsa_decode_fwd(*args), 20),
            "plain_ms": device_ms(torch, lambda: nsa.nsa_decode_fwd_plain(
                *args), 3),
            "zero_check": "block_counts 0: exactly 0",
            "library_gather_ms": lib_g["library_ms"],
            **lib, **bound(4 * D * G * d_keys,
                           2 * Bd * HQ * D * esize + 2 * d_keys * D * esize
                           + 4 * (dbi.numel() + dcnt.numel() + dg.numel()),
                           PEAK_F32_FLOPS if dtype == torch.float32
                           else PEAK_BF16_FLOPS)}
        del q, k, v, kh, vh
        torch.cuda.empty_cache()

    res["launches"] = counted
    res["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    print(json.dumps({"sparse_inference": res}), flush=True)
    return res


# the sparse_inference phase's kernels: (name, source, replaced TPU
# kernel, headline case)
SPARSE_INFERENCE_KERNELS = (
    ("vs_sparse", "minference.cu", "tilelang_mesh_tpu/ops/minference.py:31",
     "float32"),
    ("nsa_fwd", "nsa.cu", "tilelang_mesh_tpu/ops/nsa.py:79", "float32"),
    ("nsa_varlen_fwd", "nsa.cu", "tilelang_mesh_tpu/ops/nsa.py:245",
     "float32"),
    ("nsa_decode", "nsa.cu", "tilelang_mesh_tpu/ops/nsa.py:334", "float32"))


# the NSA training phase: the step's reduced length for the dense
# reference (autograd through nsa_dense holds B T HQ T scores), and the
# step against its plain version and against the dense reference
NSA_REF_T = 2048
NSA_REF_TOL = 3e-2


def nsa_training_phase(torch, nsa, nb):
    """NSA training at the NSA paper's widths (NSA, window 0): one
    nsa_attention(backward="kernel") forward and backward under autograd
    in f32 and bf16 with every counter zeroed before it and read right
    after (one nsa_fwd_partial, one nsa_bwd_dkdv and its fixed-order sum
    nsa_bwd_dkdv_sum, one nsa_bwd_dq); its output against the fused
    inference kernel; dQ, dK, dV, dG against the same step on the plain
    versions on the card, and against autograd through the dense graph
    (nsa_dense) at T NSA_REF_T; a second step's gradients bit-equal;
    each kernel against its plain version at the path's shapes (float16
    too for the backward pair: the tensor-core kernels of both 16-bit
    types); kernel, plain and library (SDPA over the dense selected bool
    mask: the forward for the partial, the backward for dK / dV and dQ,
    both for the step) times and the bound by the selected pairs; the
    backward pair's parts timed apart (dK / dV's plan, bounded by the
    selections' slots as the step's, kernel and sum; the exact plan with
    its host sync too) and its gathered bytes (Q and dO once a selected
    block for dK / dV, K and V once a visited key for dQ)."""
    import numpy as np
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    mods = (nsa, nb)
    counted = {k: 0 for m in mods for k in m.launches}
    res = {}
    reset_peak(torch)

    def drive(label, call, want_launches, main=True):
        torch.cuda.synchronize()
        for m in mods:
            m.reset_launches()
        out = call()
        torch.cuda.synchronize()
        got = {k: n for m in mods for k, n in m.launches.items()}
        want = {k: want_launches.get(k, 0) for k in got}
        check(got == want, f"{label}: launches {got}, want {want}")
        for k in counted:
            counted[k] += got[k] if main else 0
        return out

    def within(label, got, want, tol):
        check(tuple(got.shape) == tuple(want.shape)
              and got.dtype == want.dtype, f"{label}: {got.dtype} "
              f"{tuple(got.shape)}, want {want.dtype} {tuple(want.shape)}")
        check(bool(torch.isfinite(got.float()).all()),
              f"{label}: non-finite output")
        err, rel = normwise_err(got, want)
        check(rel <= tol, f"{label} disagrees with its reference: "
                          f"{rel:.3e} of max |reference| > {tol}")
        return err, rel

    def bound(flops, nbytes, peak):
        t, by = mm_bound(flops, nbytes, peak)
        return {"bound_ms": t, "bound_by": by, "ops": flops,
                "bytes": nbytes}

    def plain_residuals(q, k, v, go):
        """The backward's operands from the plain partial forward: the
        kernel-side views, the gated incoming gradient, lse2 and delta;
        and the partial's acc, m, l and its normalised output."""
        q5 = q.reshape(1, T, Hk, G, D)
        kh, vh = k.transpose(1, 2), v.transpose(1, 2)
        gs = gates.reshape(1, T, Hk, G)
        acc, m, l = nsa.nsa_fwd_partial_plain(q5, kh, vh, bi, cnt, BS, sm)
        o_slc = torch.where(l[..., None] > 0, acc / l[..., None],
                            0.0).to(q.dtype)
        g_ = (go.reshape(o_slc.shape).float() * gs[..., None]).to(q.dtype)
        delta = (g_.float() * o_slc.float()).sum(-1)
        return (q5, kh, vh, g_, m + torch.log2(l), delta), (acc, m, l,
                                                             o_slc)

    def bwd_alone(name, tol, args, dk_p, dv_p, dq_p):
        """nsa_bwd_dkdv (and its sum; on the plan bounded by the slots,
        as the step runs it) and nsa_bwd_dq on the path's operands against
        their plain versions, a second call of each bit-equal (dK / dV's
        on the exact plan): the (max abs, normwise) errors of dK / dV and
        of dQ."""
        d_got = nb.nsa_bwd_dkdv(*args, mask, BS, sm, max_pairs=bi.numel())
        e_dk = within(f"nsa_bwd_dkdv dk {name}", d_got[0], dk_p, tol)
        e_dv = within(f"nsa_bwd_dkdv dv {name}", d_got[1], dv_p, tol)
        again = nb.nsa_bwd_dkdv(*args, mask, BS, sm)
        check(all(torch.equal(a, b) for a, b in zip(d_got, again)),
              f"nsa_bwd_dkdv {name}: a second call (the exact plan) "
              f"differs in bits")
        del d_got, again
        q_got = nb.nsa_bwd_dq(*args, bi, cnt, BS, sm)
        e_dq = within(f"nsa_bwd_dq {name}", q_got, dq_p, tol)
        check(torch.equal(q_got, nb.nsa_bwd_dq(*args, bi, cnt, BS, sm)),
              f"nsa_bwd_dq {name}: a second call differs in bits")
        del q_got
        return (max(e_dk[0], e_dv[0]), max(e_dk[1], e_dv[1])), e_dq

    def bwd_records(name, dtype, tol, args, errs, lib, bwd_ms):
        """The backward pair's records: kernel, plain and library times,
        dK / dV's plan, kernel and sum apart, the ops bound and the bytes
        the gathers read, with their time at HBM's rate (a floor where
        they come from HBM, as dK / dV's mostly do; dQ's come mostly from
        L2)."""
        esize = torch.empty((), dtype=dtype).element_size()
        peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
        qb, kb = T * HQ * D * esize, T * Hk * D * esize
        ids = 4 * (bi.numel() + cnt.numel())
        stats = 4 * T * HQ                   # one float32 (T, HQ) vector
        # the kernels csrc/nsa_bwd.cu's run_dkdv / run_dq pick by type
        kn_dkdv, kn_dq = (("nsa_bwd_dkdv", "nsa_bwd_dq")
                          if dtype == torch.float32 else
                          ("nsa_bwd_dkdv_mma", "nsa_bwd_dq_mma"))
        slots = bi.numel()                  # the plan's bound, as the step's
        plan = nb.dkdv_plan(mask, G, slots)
        ws = nb.dkdv_partials(*args, plan, BS, sm)
        gather_dkdv = selections * G * D * esize * 2
        gather_dq = sel_keys * D * esize * 2
        res[f"nsa_bwd_dkdv_{name}"] = {
            "kernel": kn_dkdv, "shape": [1, T, HQ, Hk, D],
            "max_abs_err": errs[0][0], "normwise_err": errs[0][1],
            "tolerance": f"normwise {tol}", "bits_equal_twice": True,
            "ms": device_ms(torch, lambda: nb.nsa_bwd_dkdv(
                *args, mask, BS, sm, max_pairs=slots), 3),
            "plan_ms": device_ms(torch, lambda: nb.dkdv_plan(
                mask, G, slots), 3),
            "plan_synced_ms": device_ms(torch, lambda: nb.dkdv_plan(
                mask, G), 3),
            "padded_chunks": plan[2].shape[0] - int(plan[3][-1]),
            "kernel_ms": device_ms(torch, lambda: nb.dkdv_partials(
                *args, plan, BS, sm), 3),
            "sum_ms": device_ms(torch, lambda: nb.dkdv_sum(
                ws, plan[3], 1, Hk, T, D), 3),
            "plain_ms": device_ms(torch, lambda: nb.nsa_bwd_dkdv_plain(
                *args, mask, BS, sm), 1),
            "library_ms": bwd_ms, **lib,
            "library_call": "the SDPA backward (dq, dk, dv)",
            "gathered_bytes": gather_dkdv,
            "gathered_at_hbm_ms": gather_dkdv / PEAK_BYTES_S * 1e3,
            **bound(8 * D * pairs, 2 * qb + 2 * kb + 2 * stats
                    + 4 * mask.numel() + 2 * 4 * T * Hk * D, peak)}
        del ws, plan
        res[f"nsa_bwd_dq_{name}"] = {
            "kernel": kn_dq, "shape": [1, T, HQ, Hk, D],
            "max_abs_err": errs[1][0], "normwise_err": errs[1][1],
            "tolerance": f"normwise {tol}", "bits_equal_twice": True,
            "ms": device_ms(torch, lambda: nb.nsa_bwd_dq(
                *args, bi, cnt, BS, sm), 3),
            "plain_ms": device_ms(torch, lambda: nb.nsa_bwd_dq_plain(
                *args, bi, cnt, BS, sm), 1),
            "library_ms": bwd_ms, **lib,
            "library_call": "the SDPA backward (dq, dk, dv)",
            "gathered_bytes": gather_dq,
            "gathered_at_hbm_ms": gather_dq / PEAK_BYTES_S * 1e3,
            **bound(6 * D * pairs, 2 * qb + 2 * kb + 2 * stats + ids
                    + 4 * T * HQ * D, peak)}
        torch.cuda.empty_cache()

    def sdpa_yardstick(name, dtype, q, k, v, g_, want):
        """SDPA over the dense selected mask, KV expanded by the group:
        its output times the gate and its dQ / dK checked against `want`
        (the step's output, dQ and dK), then the forward, the backward
        and both timed: (record, forward, backward and step ms)."""
        o_want, dq_want, dk_want = want
        qh = q.transpose(1, 2).detach().requires_grad_()
        kx, vx = (t.transpose(1, 2).repeat_interleave(G, 1).detach()
                  .requires_grad_() for t in (k, v))
        gh = g_.reshape(1, T, HQ, D).transpose(1, 2)
        backends = ([SDPBackend.EFFICIENT_ATTENTION] if dtype ==
                    torch.float32 else [SDPBackend.CUDNN_ATTENTION,
                                        SDPBackend.EFFICIENT_ATTENTION])
        for backend in backends:
            try:
                with sdpa_kernel([backend]):
                    so = F.scaled_dot_product_attention(qh, kx, vx,
                                                        attn_mask=sel_dense)
                    sdq, sdk, _ = torch.autograd.grad(
                        so, (qh, kx, vx), gh, retain_graph=True)
            except RuntimeError:             # this backend refuses the call
                continue
            rel = {"o": normwise_err(so.detach().transpose(1, 2).reshape(
                o_want.shape) * gates[..., None].to(dtype), o_want)[1],
                   "dq": normwise_err(sdq.transpose(1, 2), dq_want)[1],
                   "dk": normwise_err(sdk.view(1, Hk, G, T, D).sum(2)
                                      .transpose(1, 2), dk_want)[1]}
            del sdq, sdk
            check(max(rel.values()) < 2e-2, f"nsa training {name}: the "
                  f"library yardstick ({backend.name}) disagrees with the "
                  f"step: {rel}")
            with sdpa_kernel([backend]):
                fwd_ms = device_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        qh, kx, vx, attn_mask=sel_dense), 1)
                bwd_ms = device_ms(torch, lambda: torch.autograd.grad(
                    so, (qh, kx, vx), gh, retain_graph=True), 1)

                def sdpa_step():
                    o_ = F.scaled_dot_product_attention(
                        qh, kx, vx, attn_mask=sel_dense)
                    torch.autograd.grad(o_, (qh, kx, vx), gh)

                step_ms = device_ms(torch, sdpa_step, 1)
            del so, qh, kx, vx, gh
            torch.cuda.empty_cache()
            return ({"library_normwise_err": rel,
                     "library": f"SDPA ({backend.name}) over the dense "
                                f"selected bool mask (1, HQ, T, T), K and "
                                f"V expanded by the group"},
                    fwd_ms, bwd_ms, step_ms)
        check(False, f"nsa training {name}: no SDPA backend of "
                     f"{backends} takes the call")

    c = NSA
    HQ, Hk, D, BS, S, T = (c["heads"], c["kv_heads"], c["head_dim"],
                           c["block"], c["selected"], c["seq"])
    G, NS = HQ // Hk, T // BS
    sm = 1.0 / math.sqrt(D)
    # q, k, v and the incoming gradient drawn on the card (a seeded
    # generator: 1.4e8 numpy draws took seconds), the gates and the
    # selections from default_rng(14)
    gen = torch.Generator(device="cuda").manual_seed(14)
    base = [torch.randn(shape, generator=gen, device="cuda")
            for shape in ((1, T, HQ, D), (1, T, Hk, D), (1, T, Hk, D),
                          (1, T, HQ, D))]
    rng = np.random.default_rng(14)
    gates = torch.from_numpy(rng.uniform(0.2, 1.0, (1, T, HQ)).astype(
        np.float32)).cuda()
    bi = torch.from_numpy(nsa_selections(rng, np.arange(T), Hk, S, BS))[
        None].cuda()
    cnt = torch.full((1, T, Hk), S, dtype=torch.int32, device="cuda")
    t_idx = torch.arange(T, device="cuda")
    sel_keys = selected_keys(torch, bi.long() * BS,
                             t_idx[None, :, None, None], BS)
    pairs = sel_keys * G                      # (query head, key) pairs
    mask = nb.nsa_block_mask(bi, cnt, T, NS, BS)
    selections = int(torch.count_nonzero(mask))   # (token, head, block)
    _, _, chunks, first = nb.dkdv_plan(mask, G)
    per_block = (first[1:] - first[:-1]).view(Hk, NS)
    res["nsa_training_selection"] = {
        "selected_keys": sel_keys, "pairs": pairs,
        "selected_blocks": selections, "dkdv_chunks": chunks.shape[0],
        "dkdv_chunk_tokens": nb.DKDV_CHUNK_ROWS // G,
        "block0_chunks": int(per_block[:, 0].max()),
        "other_blocks_chunks_max": int(per_block[:, 1:].max()),
        "block0_tokens": int((mask[0, :, :, 0] > 0).sum(0).max())}
    # the dense selected mask (1, HQ, T, T) for SDPA
    blkm = torch.zeros((Hk, T, NS + 1), dtype=torch.bool, device="cuda")
    blkm.scatter_(2, torch.where(bi[0] >= 0, bi[0], NS).long()
                  .permute(1, 0, 2), True)
    sel_dense = (blkm[..., :NS].repeat_interleave(BS, -1)
                 & torch.ones((T, T), dtype=torch.bool,
                              device="cuda").tril()).repeat_interleave(
        G, 0)[None]
    del blkm
    check(int(torch.count_nonzero(sel_dense[0, ::G])) == sel_keys,
          "nsa training: the dense selected mask and the slots' keys "
          "disagree")
    T_ref = NSA_REF_T
    print(f"nsa_training: autograd through the dense reference at T "
          f"{T_ref} of {T} (its first {T_ref} tokens)", flush=True)

    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        tol = ATTN_TOL[name]
        esize = torch.empty((), dtype=dtype).element_size()
        peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
        q, k, v, go = (t.to(dtype) for t in base)
        leaves = [t.detach().clone().requires_grad_()
                  for t in (q, k, v, gates)]
        marks = [("start", time.perf_counter())]

        def step(ls=leaves, bi=bi):
            for t in ls:
                t.grad = None
            out = nsa.nsa_attention(*ls, ls[3], bi, block_size=BS,
                                    backward="kernel")
            out.backward(go[:, :out.shape[1]])
            return out

        out = drive(f"nsa training step {name}", step,
                    {"nsa_fwd_partial": 1, "nsa_bwd_dkdv": 1,
                     "nsa_bwd_dkdv_sum": 1, "nsa_bwd_dq": 1}).detach()
        grads = [t.grad for t in leaves]
        with torch.no_grad():
            fused = drive(f"nsa fused forward {name}",
                          lambda: nsa.nsa_attention(q, k, v, gates, gates,
                                                    bi, block_size=BS),
                          {"nsa_fwd": 1}, main=False)
        errs = {"o_vs_fused": within(f"nsa step output {name} vs the "
                                     f"fused forward", out, fused,
                                     2e-2)[1]}
        del fused
        marks.append(("step", time.perf_counter()))
        # the same step on the plain versions
        args, (acc, m, l, o_slc) = plain_residuals(q, k, v, go)
        q5, kh, vh, g_ = args[:4]
        gs = gates.reshape(1, T, Hk, G)
        want_o = (o_slc * gs[..., None]).reshape(out.shape).to(dtype)
        want_dg = (go.reshape(o_slc.shape).float() * o_slc.float()).sum(
            -1).reshape(gates.shape)
        dk_p, dv_p = nb.nsa_bwd_dkdv_plain(*args, mask, BS, sm)
        dq_p = nb.nsa_bwd_dq_plain(*args, bi, cnt, BS, sm)
        want = [dq_p.reshape(q.shape).to(dtype),
                dk_p.transpose(1, 2).to(dtype),
                dv_p.transpose(1, 2).to(dtype), want_dg]
        errs["o"] = within(f"nsa step output {name}", out, want_o, tol)[1]
        for lbl, got, w in zip(("dq", "dk", "dv", "dg"), grads, want):
            errs[lbl] = within(f"nsa step {lbl} {name}", got, w, tol)[1]
        del want_o, want
        # no atomics: a second step gives the same bits
        first_grads = [t.clone() for t in grads]
        drive(f"nsa training step {name} again", step,
              {"nsa_fwd_partial": 1, "nsa_bwd_dkdv": 1,
               "nsa_bwd_dkdv_sum": 1, "nsa_bwd_dq": 1}, main=False)
        check(all(torch.equal(a, t.grad) for a, t in zip(first_grads,
                                                        leaves)),
              f"nsa training step {name}: a second step's gradients "
              f"differ in bits")
        del first_grads

        marks.append(("plain_step", time.perf_counter()))
        # against autograd through the dense graph at T_ref
        ref_leaves = [t.detach()[:, :T_ref].clone().requires_grad_()
                      for t in (q, k, v, gates)]
        r_out = drive(f"nsa training step {name} at T {T_ref}",
                      lambda: step(ref_leaves, bi[:, :T_ref]),
                      {"nsa_fwd_partial": 1, "nsa_bwd_dkdv": 1,
                       "nsa_bwd_dkdv_sum": 1, "nsa_bwd_dq": 1},
                      main=False).detach()
        r_grads = [t.grad for t in ref_leaves]
        dense_leaves = [t.detach().clone().requires_grad_()
                        for t in ref_leaves]
        d_out = nsa.nsa_dense(*dense_leaves, bi[:, :T_ref], block_size=BS)
        d_out.backward(go[:, :T_ref].float())
        ref_errs = {"o": within(f"nsa step output {name} vs the dense "
                                f"reference", r_out, d_out.detach().to(
                                    dtype), NSA_REF_TOL)[1]}
        for lbl, got, t in zip(("dq", "dk", "dv", "dg"), r_grads,
                               dense_leaves):
            ref_errs[lbl] = within(f"nsa step {lbl} {name} vs the dense "
                                   f"reference", got, t.grad,
                                   NSA_REF_TOL)[1]
        del ref_leaves, dense_leaves, d_out, r_out, r_grads
        torch.cuda.empty_cache()

        marks.append(("dense_reference", time.perf_counter()))
        # each kernel alone against its plain version
        got = nsa.nsa_fwd_partial(q5, kh, vh, bi, cnt, BS, sm)
        seen = l > 0
        e_acc = within(f"nsa_fwd_partial acc {name}", got[0], acc, tol)
        e_l = within(f"nsa_fwd_partial l {name}", got[2], l, tol)
        e_m = within(f"nsa_fwd_partial m {name}", got[1][seen], m[seen],
                     1e-5)
        check(bool((got[1][~seen] == -1e30).all()),
              f"nsa_fwd_partial {name}: m of a row that sees nothing")
        del got, acc, m
        e_bwd = bwd_alone(name, tol, args, dk_p, dv_p, dq_p)
        del dk_p, dv_p, dq_p
        torch.cuda.empty_cache()

        marks.append(("kernels_alone", time.perf_counter()))
        lib, fwd_ms, bwd_ms, step_ms = sdpa_yardstick(
            name, dtype, q, k, v, g_, (out, grads[0], grads[1]))
        marks.append(("library", time.perf_counter()))

        qb, kb = T * HQ * D * esize, T * Hk * D * esize
        ids = 4 * (bi.numel() + cnt.numel())
        stats = 4 * T * HQ                   # one float32 (T, HQ) vector
        res[f"nsa_fwd_partial_{name}"] = {
            "shape": [1, T, HQ, Hk, D], "block": BS, "selected": S,
            "max_abs_err": e_acc[0], "normwise_err": e_acc[1],
            "l_normwise_err": e_l[1], "m_normwise_err": e_m[1],
            "tolerance": f"normwise {tol} (m 1e-5 where l > 0)",
            "ms": device_ms(torch, lambda: nsa.nsa_fwd_partial(
                q5, kh, vh, bi, cnt, BS, sm), 3),
            "plain_ms": device_ms(torch, lambda: nsa.nsa_fwd_partial_plain(
                q5, kh, vh, bi, cnt, BS, sm), 1),
            "library_ms": fwd_ms, **lib,
            "library_call": "the SDPA forward",
            **bound(4 * D * pairs, qb + 2 * kb + ids + 4 * T * HQ * D
                    + 2 * stats, peak)}
        bwd_records(name, dtype, tol, args, e_bwd, lib, bwd_ms)
        res[f"nsa_train_{name}"] = {
            "shape": [1, T, HQ, Hk, D], "normwise_err": errs,
            "tolerance": f"normwise {tol} (the output against the fused "
                         f"forward 2e-2)",
            "reference_normwise_err": ref_errs,
            "reference": f"autograd through nsa_dense at T {T_ref}",
            "reference_tolerance": f"normwise {NSA_REF_TOL}",
            "bits_equal_twice": True,
            "ms": device_ms(torch, step, 3),
            "library_ms": step_ms,
            "library": "SDPA forward + backward over the dense selected "
                       "mask (no gate, no dG)",
            # #34 + #37 + #38: 4 + 8 + 6 flops per pair and dim; q, k, v,
            # the gates, the ids and the incoming gradient read, the output
            # and the four gradients written
            **bound(18 * D * pairs, 4 * qb + 4 * kb + 2 * stats + ids,
                    peak)}
        marks.append(("timed", time.perf_counter()))
        res[f"nsa_train_{name}"]["host_seconds"] = {
            b[0]: round(b[1] - a[1], 3) for a, b in zip(marks, marks[1:])}
        print(f"nsa training {name}: step {res[f'nsa_train_{name}']['ms']:.3f}"
              f" ms; partial {res[f'nsa_fwd_partial_{name}']['ms']:.3f}, "
              f"dkdv {res[f'nsa_bwd_dkdv_{name}']['ms']:.3f}, dq "
              f"{res[f'nsa_bwd_dq_{name}']['ms']:.3f}", flush=True)
        del leaves, grads, q, k, v, go, q5, kh, vh, g_, o_slc
        del l, seen, out, args
        torch.cuda.empty_cache()

    # float16: the tensor-core backward pair alone at the path's shapes,
    # against its plain versions; SDPA's float16 backward on the same
    # dense mask, held against the plain step
    q, k, v, go = (t.to(torch.float16) for t in base)
    args, (_, _, _, o_slc) = plain_residuals(q, k, v, go)
    dk_p, dv_p = nb.nsa_bwd_dkdv_plain(*args, mask, BS, sm)
    dq_p = nb.nsa_bwd_dq_plain(*args, bi, cnt, BS, sm)
    e_bwd = bwd_alone("float16", ATTN_TOL["float16"], args, dk_p, dv_p,
                      dq_p)
    o_p = (o_slc * gates.reshape(1, T, Hk, G)[..., None]).reshape(
        q.shape).to(torch.float16)
    lib, _, bwd_ms, _ = sdpa_yardstick(
        "float16", torch.float16, q, k, v, args[3],
        (o_p, dq_p.reshape(q.shape), dk_p.transpose(1, 2)))
    del dk_p, dv_p, dq_p, o_p, o_slc
    bwd_records("float16", torch.float16, ATTN_TOL["float16"], args, e_bwd,
                lib, bwd_ms)
    print(f"nsa training float16: dkdv "
          f"{res['nsa_bwd_dkdv_float16']['ms']:.3f}, dq "
          f"{res['nsa_bwd_dq_float16']['ms']:.3f}", flush=True)
    del q, k, v, go, args
    torch.cuda.empty_cache()

    del sel_dense
    torch.cuda.empty_cache()
    res["launches"] = counted
    res["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    print(json.dumps({"nsa_training": res}), flush=True)
    return res


# the nsa_training phase's kernels: (name, source, replaced TPU kernel,
# headline case); nsa_bwd_dkdv and nsa_bwd_dq count the CUDA-core
# kernels (float32) and the tensor-core nsa_bwd_dkdv_mma and
# nsa_bwd_dq_mma (bfloat16, float16) under one counter each, the cases
# of the other types under "variants"
NSA_TRAINING_KERNELS = (
    ("nsa_fwd_partial", "nsa.cu", "tilelang_mesh_tpu/ops/nsa.py:127",
     "float32"),
    ("nsa_bwd_dkdv", "nsa_bwd.cu", "tilelang_mesh_tpu/ops/nsa_bwd.py:28",
     "float32"),
    ("nsa_bwd_dq", "nsa_bwd.cu", "tilelang_mesh_tpu/ops/nsa_bwd.py:99",
     "float32"))


def dsa_phase(torch, dsa):
    """DSA at DeepSeek-V3.2-Exp's attention widths (DSA), f32 and bf16:
    the pipeline through the entry points (lightning_indexer,
    topk_selector, sparse_mla_fwd: one launch each, every counter zeroed
    before and read right after); each kernel against its plain version
    on the same inputs (the selector on the kernel's own logits); the
    kernel chain's O against the plain chain's; a row with no valid id
    and a ragged shape at small size; kernel, plain and library
    (none for the indexer; torch.topk; SDPA over the dense selected
    mask) times and the bound by this run's visible pairs and live
    slots; then the sparse fine-tuning step (make_sparse_mla) at S
    ft_seq over ft_cache: dq and dkv against autograd through the dense
    reference, three Adam steps whose loss falls, and the step's
    time."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    # the counters by kernel: the sparse MLA forward's by name
    # (kernel_launches["sparse_mla_fwd"], the float32 kernel, in place of
    # launches["sparse_mla_fwd"], every call)
    counted = dict.fromkeys({**dsa.launches, **dsa.kernel_launches}, 0)
    res = {}
    reset_peak(torch)

    def drive(label, call, want_launches, main=True, kernel=None):
        torch.cuda.synchronize()
        dsa.reset_launches()
        out = call()
        torch.cuda.synchronize()
        got = dict(dsa.launches)
        want = {k: want_launches.get(k, 0) for k in got}
        check(got == want, f"{label}: launches {got}, want {want}")
        ran = [k for k, n in dsa.kernel_launches.items() if n]
        check(kernel is None or ran == [kernel],
              f"{label}: launched {ran}, the path rule names {kernel}")
        got.update(dsa.kernel_launches)
        for k in counted:
            counted[k] += got[k] if main else 0
        return out

    def within(label, got, want, tol):
        check(tuple(got.shape) == tuple(want.shape)
              and got.dtype == want.dtype, f"{label}: {got.dtype} "
              f"{tuple(got.shape)}, want {want.dtype} {tuple(want.shape)}")
        check(bool(torch.isfinite(got.float()).all()),
              f"{label}: non-finite output")
        err, rel = normwise_err(got, want)
        check(rel <= tol, f"{label} disagrees with its reference: "
                          f"{rel:.3e} of max |reference| > {tol}")
        return err, rel

    def logits_within(label, got, want, tol):
        inf = torch.isinf(want)
        check(torch.equal(torch.isinf(got), inf)
              and bool((got[inf] == want[inf]).all()),
              f"{label}: -inf not where the plain version has it")
        return within(label, got[~inf], want[~inf], tol)

    def bound(flops, nbytes, peak):
        t, by = mm_bound(flops, nbytes, peak)
        return {"bound_ms": t, "bound_by": by, "ops": flops,
                "bytes": nbytes}

    c = DSA
    H, D, DT, HI, DI, topk = (c["heads"], c["latent"], c["rope"],
                              c["index_heads"], c["index_dim"], c["topk"])
    S, Skv = c["seq"], c["cache"]
    off = Skv - S
    sm = 1.0 / math.sqrt(D + DT)
    t_idx = torch.arange(S, device="cuda")
    visible = int(torch.clamp(off + t_idx + 1, max=Skv).sum())

    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        esize = torch.empty((), dtype=dtype).element_size()
        peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
        # activations from a seeded generator on the card (1.2 GB of q)
        gen = torch.Generator(device="cuda").manual_seed(21)
        qi, ki, q, kv = (torch.randn(shape, generator=gen, device="cuda")
                         .to(dtype) for shape in (
                             (1, S, HI, DI), (1, Skv, DI), (1, S, H, D + DT),
                             (1, Skv, D + DT)))
        w = torch.randn((1, S, HI), generator=gen, device="cuda")

        def pipeline():
            L = dsa.lightning_indexer(qi, ki, w)
            ind = dsa.topk_selector(L, topk)
            return (L, ind) + tuple(dsa.sparse_mla_fwd(q, kv, ind))

        kname = dsa.sparse_mla_path(D, DT, dtype)
        check(kname == ("sparse_mla_fwd" if dtype == torch.float32
                        else "sparse_mla_fwd_wgmma"),
              f"dsa {name}: sparse MLA path {kname}")
        L, ind, o, lse = drive(
            f"dsa pipeline {name}", pipeline,
            {"lightning_indexer": 1, "topk_selector": 1,
             "sparse_mla_fwd": 1}, kernel=kname)
        check(o.dtype == dtype and tuple(o.shape) == (1, S, H, D)
              and tuple(lse.shape) == (1, S, H)
              and bool(torch.isfinite(o.float()).all())
              and bool(torch.isfinite(lse).all()),
              f"dsa pipeline {name}: O {o.dtype} {tuple(o.shape)} or LSE "
              f"not finite")
        check(bool(((ind >= 0) & (ind <= (off + t_idx)[None, :, None]))
                   .all()), f"dsa pipeline {name}: a slot is not live")
        slots = int((ind >= 0).sum())
        # each kernel against its plain version on the same inputs
        Lp = dsa.lightning_indexer_plain(qi, ki, w, off)
        e_idx = logits_within(f"lightning_indexer {name}", L, Lp,
                              DSA_TOL["indexer"][name])
        ind_p = dsa.topk_selector_plain(L, topk)
        check(torch.equal(ind, ind_p),
              f"topk_selector {name}: ids differ from the plain version's")
        o_p, lse_p = dsa.sparse_mla_fwd_plain(q, kv, ind, D, sm, off)
        e_o = within(f"sparse_mla_fwd O {name}", o, o_p,
                     DSA_TOL["mla"][name])
        e_lse = within(f"sparse_mla_fwd LSE {name}", lse, lse_p,
                       DSA_TOL["lse"])
        del o_p, lse_p
        # the kernel chain against the plain chain: the logits differ in
        # the last bits, so near-ties swap places in a row's order (O
        # does not care) or, at the topk-th slot, pick another id; such a
        # row's O moves by that key's weight (up to ~5e-2 of max |O|, a
        # mean over topk random rows). Rows that select the same set are
        # held to the kernel-vs-plain bound; on the others the two
        # selections' plain logits must agree as sorted values (near-ties
        # only); the whole O's error is reported
        ind_pp = dsa.topk_selector_plain(Lp, topk)
        o_pp, _ = dsa.sparse_mla_fwd_plain(q, kv, ind_pp, D, sm, off)
        same = (ind.sort(-1)[0] == ind_pp.sort(-1)[0]).all(-1)
        flipped = int((ind != ind_pp).sum())
        reordered = int((ind != ind_pp).any(-1).sum())
        check(bool(same.any()), f"dsa chain {name}: no row selects the "
                                f"same set")
        e_chain = within(f"dsa chain {name} vs the plain chain, rows that "
                         f"select the same set", o[same], o_pp[same],
                         DSA_TOL["mla"][name])
        within(f"dsa chain {name}: the plain logits of the kernel's and "
               f"the plain selections",
               Lp.gather(-1, ind.long()).sort(-1, descending=True)[0],
               Lp.gather(-1, ind_pp.long()), DSA_TOL["indexer"][name])
        chain_all = normwise_err(o, o_pp)[1]
        del Lp, ind_pp, o_pp
        torch.cuda.empty_cache()

        # library yardsticks: torch.topk; SDPA over the dense selected
        # mask with the heads as query heads over the one latent head
        # expanded (Dqk 576, Dv 512), which attends all Skv keys
        topk_ms = device_ms(torch, lambda: torch.topk(L, topk, dim=-1,
                                                      sorted=True), 5)
        check(torch.equal(torch.topk(L, topk, dim=-1, sorted=True)[0],
                          L.gather(-1, ind.long())),
              f"torch.topk {name}: values differ from the selected ones")
        mask = torch.zeros((1, 1, S, Skv), dtype=torch.bool, device="cuda")
        mask[0, 0].scatter_(1, ind[0].long(), True)
        qh = q.transpose(1, 2)
        sdpa_ms, library = None, None
        for backend, kx, vx in (
                (SDPBackend.EFFICIENT_ATTENTION,
                 kv[:, None].expand(1, H, Skv, D + DT),
                 kv[:, None, :, :D].expand(1, H, Skv, D)),
                (SDPBackend.EFFICIENT_ATTENTION,
                 kv[:, None].expand(1, H, Skv, D + DT).contiguous(),
                 kv[:, None, :, :D].expand(1, H, Skv, D).contiguous()),
                (SDPBackend.CUDNN_ATTENTION,
                 kv[:, None].expand(1, H, Skv, D + DT).contiguous(),
                 kv[:, None, :, :D].expand(1, H, Skv, D).contiguous())):
            try:
                with sdpa_kernel([backend]):
                    so = F.scaled_dot_product_attention(qh, kx, vx,
                                                        attn_mask=mask)
            except RuntimeError:             # this backend refuses the call
                continue
            rel = normwise_err(so.transpose(1, 2), o)[1]
            check(rel < 2e-2, f"dsa {name}: the library yardstick "
                              f"({backend.name}) disagrees with the "
                              f"kernel: {rel:.3e}")
            del so
            with sdpa_kernel([backend]):
                sdpa_ms = device_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        qh, kx, vx, attn_mask=mask), 1)
            library = (f"SDPA ({backend.name}) over the dense selected "
                       f"bool mask (1, 1, S, Skv), the {H} heads over the "
                       f"one latent head expanded (Dqk {D + DT}, Dv {D}"
                       f"{', K and V copied' if kx.is_contiguous() else ''}"
                       f"); it scores all {Skv} keys, {Skv // topk}x the "
                       f"kernel's {topk}; normwise {rel:.2e} from the "
                       f"kernel")
            break
        check(library is not None, f"dsa {name}: no SDPA backend takes "
                                   f"Dqk {D + DT} / Dv {D}")
        del mask, kx, vx
        torch.cuda.empty_cache()

        triples = slots * H
        res[f"lightning_indexer_{name}"] = {
            "shape": [1, S, Skv, HI, DI], "q_offset": off,
            "visible_pairs": visible,
            "max_abs_err": e_idx[0], "normwise_err": e_idx[1],
            "tolerance": f"normwise {DSA_TOL['indexer'][name]}, -inf "
                         f"exactly",
            "ms": device_ms(torch, lambda: dsa.lightning_indexer(qi, ki, w),
                            3),
            "plain_ms": device_ms(torch, lambda: dsa.lightning_indexer_plain(
                qi, ki, w, off), 1),
            "library_ms": None,
            "library": "no library call: no single PyTorch call computes "
                       "the head-weighted relu sum",
            **bound(visible * HI * (2 * DI + 3),
                    (S * HI * DI + Skv * DI) * esize + 4 * S * HI
                    + 4 * S * Skv, peak)}
        res[f"topk_selector_{name}"] = {
            "shape": [1, S, Skv], "topk": topk, "max_abs_err": 0.0,
            "tolerance": "ids equal",
            "ms": device_ms(torch, lambda: dsa.topk_selector(L, topk), 5),
            "plain_ms": device_ms(torch, lambda: dsa.topk_selector_plain(
                L, topk), 1),
            "library_ms": topk_ms,
            "library": "torch.topk(L, topk, sorted=True) (its tie order "
                       "is unspecified: values compared, not ids)",
            **bound(0, 4 * S * Skv + 4 * S * topk, peak)}
        res[f"{kname}_{name}"] = {
            "shape": [1, S, Skv, H, D, DT], "topk": topk, "kernel": kname,
            "live_slots": slots, "max_abs_err": e_o[0],
            "normwise_err": e_o[1], "lse_normwise_err": e_lse[1],
            "tolerance": f"normwise {DSA_TOL['mla'][name]} (LSE "
                         f"{DSA_TOL['lse']})",
            "chain_normwise_err_agreeing_rows": e_chain[1],
            "chain_rows_another_set": int((~same).sum()),
            "chain_rows_another_order": reordered,
            "chain_slots_differing": flipped,
            "chain_normwise_err_all_rows": chain_all,
            "ms": device_ms(torch, lambda: dsa.sparse_mla_fwd(q, kv, ind),
                            2),
            "plain_ms": device_ms(torch, lambda: dsa.sparse_mla_fwd_plain(
                q, kv, ind, D, sm, off), 1),
            "library_ms": sdpa_ms, "library": library,
            **bound(triples * (2 * (D + DT) + 2 * D),
                    (S * H * (D + DT) + Skv * (D + DT) + S * H * D) * esize
                    + 4 * S * topk + 4 * S * H, peak)}
        print(f"dsa {name}: indexer "
              f"{res[f'lightning_indexer_{name}']['ms']:.3f} ms, selector "
              f"{res[f'topk_selector_{name}']['ms']:.3f} ms, sparse MLA "
              f"{res[f'{kname}_{name}']['ms']:.3f} ms ({kname}); chain: "
              f"{flipped} slots in {reordered} rows differ, "
              f"{int((~same).sum())} rows select another set, O "
              f"{chain_all:.3e} normwise", flush=True)
        del qi, ki, q, kv, w, L, ind, o, lse, same
        torch.cuda.empty_cache()

        # a ragged shape (S, Skv, H, topk no multiple of any tile) with a
        # row whose ids are all -1, ids past the bound and duplicates
        g2 = torch.Generator(device="cuda").manual_seed(22)
        s2, skv2, t2 = 77, 300, 100
        qi2, ki2, q2, kv2 = (torch.randn(shape, generator=g2, device="cuda")
                             .to(dtype) for shape in (
                                 (1, s2, 5, 40), (1, skv2, 40),
                                 (1, s2, 20, D + DT), (1, skv2, D + DT)))
        w2 = torch.randn((1, s2, 5), generator=g2, device="cuda")
        L2 = drive(f"lightning_indexer ragged {name}",
                   lambda: dsa.lightning_indexer(qi2, ki2, w2, q_offset=150),
                   {"lightning_indexer": 1}, main=False)
        logits_within(f"lightning_indexer ragged {name}", L2,
                      dsa.lightning_indexer_plain(qi2, ki2, w2, 150),
                      DSA_TOL["indexer"][name])
        ind2 = drive(f"topk_selector ragged {name}",
                     lambda: dsa.topk_selector(L2, t2),
                     {"topk_selector": 1}, main=False)
        check(torch.equal(ind2, dsa.topk_selector_plain(L2, t2)),
              f"topk_selector ragged {name}: ids differ")
        ind2 = torch.where(ind2 >= 0, ind2, 299)   # past the bound
        ind2[0, :, 1::5] = ind2[0, :, 0::5][..., :ind2[0, :, 1::5].shape[-1]]
        ind2[0, 40] = -1
        o2, lse2 = drive(f"sparse_mla_fwd ragged {name}",
                         lambda: dsa.sparse_mla_fwd(q2, kv2, ind2,
                                                    block_I=t2),
                         {"sparse_mla_fwd": 1}, main=False, kernel=kname)
        o2p, lse2p = dsa.sparse_mla_fwd_plain(q2, kv2, ind2, D, sm,
                                              skv2 - s2)
        within(f"sparse_mla_fwd ragged O {name}", o2, o2p,
               DSA_TOL["mla"][name])
        live = torch.ones_like(lse2, dtype=torch.bool)
        live[0, 40] = False
        within(f"sparse_mla_fwd ragged LSE {name}", lse2[live], lse2p[live],
               DSA_TOL["lse"])
        dead = torch.tensor(dsa.DEAD_ROW_LSE, dtype=torch.float32)
        check(bool((o2[0, 40] == 0).all())
              and bool((lse2[0, 40].cpu() == dead).all())
              and bool((lse2p[0, 40].cpu() == dead).all()),
              f"sparse_mla_fwd {name}: a row with no valid id is not O = 0, "
              f"LSE {float(dead)}")
        res[f"dsa_ragged_{name}"] = {
            "shape": [1, s2, skv2, 20, D, DT], "topk": t2,
            "dead_row": {"o_max_abs": 0.0, "lse": float(dead)}}
        if dtype != torch.float32:
            # the 16-bit mma.sync kernel, which D 192 keeps: the ragged
            # ids on q and kv cut to 192 + 64 features
            q3, kv3 = (t[..., -(192 + DT):].contiguous() for t in (q2, kv2))
            o3, lse3 = drive(f"sparse_mla_fwd D 192 {name}",
                             lambda: dsa.sparse_mla_fwd(
                                 q3, kv3, ind2, block_I=t2, tail_dim=DT),
                             {"sparse_mla_fwd": 1}, main=False,
                             kernel="sparse_mla_fwd_mma")
            o3p, lse3p = dsa.sparse_mla_fwd_plain(
                q3, kv3, ind2, 192, 1.0 / math.sqrt(192 + DT), skv2 - s2)
            e3 = within(f"sparse_mla_fwd D 192 O {name}", o3, o3p,
                        DSA_TOL["mla"][name])
            within(f"sparse_mla_fwd D 192 LSE {name}", lse3[live],
                   lse3p[live], DSA_TOL["lse"])
            res[f"sparse_mla_mma_d192_{name}"] = {
                "shape": [1, s2, skv2, 20, 192, DT], "topk": t2,
                "kernel": "sparse_mla_fwd_mma", "max_abs_err": e3[0],
                "normwise_err": e3[1]}
            del q3, kv3, o3, lse3, o3p, lse3p
        del qi2, ki2, q2, kv2, w2, L2, ind2, o2, lse2, o2p, lse2p

        # the sparse fine-tuning step (make_sparse_mla) at ft_seq over
        # ft_cache: ids from the indexer and selector, as the example
        S3, Skv3 = c["ft_seq"], c["ft_cache"]
        g3 = torch.Generator(device="cuda").manual_seed(23)
        qi3, ki3, q3, kv3 = (torch.randn(shape, generator=g3, device="cuda")
                             .to(dtype) for shape in (
                                 (1, S3, HI, DI), (1, Skv3, DI),
                                 (1, S3, H, D + DT), (1, Skv3, D + DT)))
        w3 = torch.randn((1, S3, HI), generator=g3, device="cuda")
        target = torch.randn((1, S3, H, D), generator=g3, device="cuda")
        sparse_mla = dsa.make_sparse_mla()
        ind3 = drive(f"dsa fine-tune ids {name}",
                     lambda: dsa.topk_selector(dsa.lightning_indexer(
                         qi3, ki3, w3), topk),
                     {"lightning_indexer": 1, "topk_selector": 1})

        def ft_step(qq, kk):
            loss = ((sparse_mla(qq, kk, ind3).float() - target) ** 2).mean()
            loss.backward()
            return loss.detach()

        leaves = [t.detach().clone().requires_grad_() for t in (q3, kv3)]
        loss0 = drive(f"dsa fine-tune step {name}",
                      lambda: ft_step(*leaves), {"sparse_mla_fwd": 1})
        ref = [t.detach().clone().requires_grad_() for t in (q3, kv3)]
        r_o, _ = dsa.sparse_mla_reference(*ref, ind3)
        ((r_o.float() - target) ** 2).mean().backward()
        del r_o
        e_dq = within(f"dsa fine-tune dq {name}", leaves[0].grad,
                      ref[0].grad, DSA_TOL["mla"][name])
        e_dkv = within(f"dsa fine-tune dkv {name}", leaves[1].grad,
                       ref[1].grad, DSA_TOL["mla"][name])
        del ref
        torch.cuda.empty_cache()
        # Adam, as a fine-tuning run would step (plain SGD at the
        # example's lr moves nothing at this size: the mean's gradient
        # is 1/N of an element's)
        losses = [float(loss0)]
        qq, kk = leaves
        opt = torch.optim.Adam([qq, kk], lr=1e-2)
        for step in range(2):
            opt.step()
            opt.zero_grad()
            losses.append(float(drive(
                f"dsa fine-tune step {name} {step + 2}",
                lambda: ft_step(qq, kk), {"sparse_mla_fwd": 1})))
        check(losses[-1] < losses[0], f"dsa fine-tune {name}: the loss "
                                      f"does not fall: {losses}")

        def timed_step():
            for t in (qq, kk):
                t.grad = None
            ft_step(qq, kk)

        res[f"dsa_finetune_{name}"] = {
            "shape": [1, S3, Skv3, H, D, DT], "topk": topk,
            "dq_normwise_err": e_dq[1], "dkv_normwise_err": e_dkv[1],
            "tolerance": f"normwise {DSA_TOL['mla'][name]} against "
                         f"autograd through sparse_mla_reference",
            "losses": losses, "ms": device_ms(torch, timed_step, 1)}
        print(f"dsa fine-tune {name}: losses {losses}, step "
              f"{res[f'dsa_finetune_{name}']['ms']:.1f} ms", flush=True)
        del qi3, ki3, q3, kv3, w3, target, ind3, leaves, qq, kk, opt
        torch.cuda.empty_cache()

    res["launches"] = counted
    res["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    print(json.dumps({"dsa": res}), flush=True)
    return res


# the dsa phase's kernels: (name, source, replaced TPU kernel, headline
# case)
DSA_KERNELS = (
    ("lightning_indexer", "dsa.cu", "tilelang_mesh_tpu/ops/dsa.py:39",
     "float32"),
    ("topk_selector", "dsa.cu", "tilelang_mesh_tpu/ops/dsa.py:101",
     "float32"),
    ("sparse_mla_fwd", "sparse_mla.cu", "tilelang_mesh_tpu/ops/dsa.py:147",
     "float32"),
    ("sparse_mla_fwd_wgmma", "sparse_mla.cu",
     "tilelang_mesh_tpu/ops/dsa.py:147", "bfloat16"))


# the headline phase's loop target (bench.py's is 0.6 s): thirteen configs,
# each side calibrated and sampled three times
HEADLINE_TARGET_S = 0.1
# the yardsticks against their plain versions, normwise by output type
YARDSTICK_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def headline_phase(torch, ys, gm, dqg, fa, mla, fd, gg, m2, gd):
    """The headline comparison (tilelang_mesh_tpu_torch.bench): the thirteen
    configs at full size through ``run_config`` (counters zeroed before,
    read right after; a CUDA graph's launches are counted where they are
    captured, its replays not; the flash configs launch ``mha_fwd``,
    ``mla_decode`` the MLA kernel, ``paged_decode`` both the page walk
    and the gather's contiguous kernel, each strategy with its time,
    ``moe_grouped`` the TMA grouped kernel, ``mamba2_chunk`` the SSD
    kernel, ``gdn_fwd`` the two GDN kernels, ``w4a8_gemm`` the TMA w4a8
    kernel),
    each record printed, then the headline geomean line, the geomean of
    the eight configs without the two decode ones (for comparison) and
    of the five GEMM configs alone; every GEMM of them on #15's TMA path
    (no launch of its tile loop). Then #42 (bf16 -> bf16 at 8192 x 8192
    x 4096, fp8 -> f32 at 4096^3) and #43 (4096^3, group 512), each at the
    carver's two top blocks as bench sweeps them, against their plain
    versions on the same inputs; kernel, plain and library (torch.matmul;
    torch._scaled_mm with unit scales; torch.matmul on the dequantised
    weight) times and the bound."""
    import numpy as np
    from tilelang_mesh_tpu_torch import bench as tb
    from tilelang_mesh_tpu_torch.carver import MatmulTemplate, auto_arch
    from tilelang_mesh_tpu_torch.quantize import quantize_int4_planar
    arch = auto_arch()
    peaks = tb._chip_peak_tflops(arch)
    kind = torch.cuda.get_device_name(0)
    reset_peak(torch)
    res = {}

    # -- the main path: bench's thirteen configs ------------------------
    torch.cuda.synchronize()
    for mod in (ys, gm, dqg, fa, mla, fd, gg, m2, gd):
        mod.reset_launches()
    t0 = time.perf_counter()
    records = []
    for name, build in tb._config_builders(False, arch=arch,
                                           target_s=HEADLINE_TARGET_S):
        rec = tb.run_config(name, build, peaks, rounds=3,
                            target_s=HEADLINE_TARGET_S)
        print(json.dumps(rec), flush=True)
        check(rec["device"] == kind and rec["latency_ms"] > 0
              and rec["baseline_ms"] > 0 and rec["vs_baseline"] > 0,
              f"headline {name}: record {rec}")
        records.append(rec)
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    res["launches"] = dict(ys.launches)
    res["library_launches"] = {**gm.launches, **dqg.launches,
                               "mha_fwd": fa.launches["mha_fwd"],
                               **mla.launches, **fd.launches,
                               **gg.launches, **m2.launches,
                               **gd.launches}
    res["records"] = records
    res["seconds"] = time.perf_counter() - t0
    check(all(n > 0 for n in res["launches"].values()),
          f"headline: a yardstick was not launched: {res['launches']}")
    check(fa.launches["mha_fwd"] > 0,
          "headline: the flash configs did not launch mha_fwd")
    # every GEMM shape of the headline took #15's TMA path
    check(gm.launches["matmul"] == 0 and gm.launches["matmul_tma"] > 0,
          f"headline: matmul launches by path {dict(gm.launches)}")
    check(dqg.launches["w4a8_gemm_tma"] > 0
          and dqg.launches["w4a8_gemm"] == 0,
          f"headline: the w4a8 config's launches {dict(dqg.launches)}")
    check(m2.launches["mamba2_chunk_scan"] > 0,
          "headline: the mamba2_chunk config did not launch "
          "mamba2_chunk_scan")
    check(gd.launches["gdn_chunk_wy"] > 0
          and gd.launches["gdn_chunk_state"] > 0,
          f"headline: the gdn_fwd config's launches {dict(gd.launches)}")
    check(mla.launches["mla_decode"] > 0,
          "headline: the mla_decode config did not launch mla_decode")
    check(gg.launches["grouped_gemm_tma"] > 0
          and gg.launches["grouped_gemm"] == 0,
          f"headline: moe_grouped's grouped launches {dict(gg.launches)}")
    paged = next(r for r in records if r["config"] == "paged_decode")
    check(fd.launches["paged_decode"] > 0 and fd.launches["decode"] > 0
          and paged["walk_ms"] > 0 and paged["gather_ms"] > 0,
          f"headline: paged_decode's strategies {fd.launches}, {paged}")
    head = tb.headline(records)
    print(json.dumps(head), flush=True)
    res["geomean_vs_baseline"] = head["geomean_vs_baseline"]
    # the earlier PRs' sets, for comparison: the twelve configs before
    # gdn_fwd, the eleven before mamba2_chunk, the ten before
    # moe_grouped, the eight without the decode ones
    def without(*names):
        return tb.headline([r for r in records if r["config"] not in names])[
            "geomean_vs_baseline"]
    res["geomean_vs_baseline_twelve"] = without("gdn_fwd")
    res["geomean_vs_baseline_eleven"] = without("mamba2_chunk", "gdn_fwd")
    res["geomean_vs_baseline_eight"] = without(
        "mla_decode", "paged_decode", "moe_grouped", "mamba2_chunk",
        "gdn_fwd")
    res["geomean_vs_baseline_ten"] = without("moe_grouped", "mamba2_chunk",
                                             "gdn_fwd")
    res["geomean_vs_baseline_gemm"] = tb.headline(
        [r for r in records if not r["config"].startswith(
            ("flash", "mla", "paged", "moe", "mamba2", "gdn"))])[
            "geomean_vs_baseline"]

    def hold(label, got, want):
        name = str(want.dtype).replace("torch.", "")
        check(tuple(got.shape) == tuple(want.shape)
              and got.dtype == want.dtype, f"{label}: {got.dtype} "
              f"{tuple(got.shape)}, plain {want.dtype} {tuple(want.shape)}")
        check(bool(torch.isfinite(got.float()).all()),
              f"{label}: non-finite output")
        err, rel = normwise_err(got, want)
        tol = YARDSTICK_TOL[name]
        check(rel <= tol, f"{label} disagrees with its plain version: "
                          f"{rel:.3e} of max |plain| > {tol}")
        return {"max_abs_err": err, "normwise_err": rel,
                "tolerance": f"normwise {tol}"}

    def timed(kern, plain, library, iters=5):
        return {"ms": device_ms(torch, kern, iters),
                "plain_ms": device_ms(torch, plain, 3),
                "library_ms": device_ms(torch, library, iters)}

    # -- #42 against its plain version -----------------------------------
    for label, seed, (M, N, K), dt, out in (
            ("bf16_8192x8192x4096", 0, (8192, 8192, 4096), torch.bfloat16,
             torch.bfloat16),
            ("fp8_f32_4096", 2, (4096,) * 3, torch.float8_e4m3fn,
             torch.float32)):
        a_np, b_np = draw_np(seed, (M, K), (K, N))
        a = torch.from_numpy(a_np).cuda().to(dt)
        b = torch.from_numpy(b_np).cuda().to(dt)
        del a_np, b_np
        want = ys.hand_matmul_plain(a, b, out)
        if dt == torch.float8_e4m3fn:      # cuBLASLt fp8, column-major B
            one = torch.ones((), device="cuda")
            bcol = b.T.contiguous().T

            def library():
                return torch._scaled_mm(a, bcol, scale_a=one, scale_b=one,
                                        out_dtype=torch.float32)
            lib_name = "torch._scaled_mm (unit scales)"
            peak = PEAK_8BIT_OPS
        else:
            def library():
                return torch.matmul(a, b)
            lib_name = f"torch.matmul in {dt}"
            peak = PEAK_BF16_FLOPS
        flops = 2 * M * N * K
        nbytes = (M * K + K * N) * a.element_size() + M * N * torch.empty(
            (), dtype=out).element_size()
        bound, by = mm_bound(flops, nbytes, peak)
        hints = MatmulTemplate(M, N, K, str(dt).replace("torch.", ""),
                               arch=arch).hints(2)
        for i, h in enumerate(hints):
            blk = (h.config["block_M"], h.config["block_N"],
                   h.config["block_K"])
            kern = ys.hand_matmul(M, N, K, *blk, dtype=dt, out_dtype=out)
            r = hold(f"hand_matmul {label} {blk}", kern(a, b), want)
            res[f"yardstick_gemm_{label}" + ("" if i == 0 else "_b2")] = {
                "shape": [M, N, K], "block": list(blk), **r,
                **timed(lambda: kern(a, b),
                        lambda: ys.hand_matmul_plain(a, b, out), library),
                "library": lib_name, "bound_ms": bound, "bound_by": by,
                "flops": flops, "bytes": nbytes}
        del a, b, want
        torch.cuda.empty_cache()

    # -- #43 against its plain version -----------------------------------
    M = N = K = 4096
    gs = 512
    rng = np.random.default_rng(3)          # as cfg_w4a16 draws them
    a = torch.from_numpy((rng.standard_normal((M, K)) * 0.1).astype(
        np.float32)).cuda().to(torch.bfloat16)
    w_np = rng.standard_normal((K, N)).astype(np.float32) * 0.1
    packed_np, scales_np = quantize_int4_planar(w_np, group_size=gs)
    del w_np
    K2 = K // 2
    packed = torch.from_numpy(packed_np).cuda()
    s3 = torch.from_numpy(scales_np).cuda().reshape(2, K2 // gs, N)
    alo, ahi = a[:, :K2], a[:, K2:]
    want = ys.hand_w4a16_plain(alo, ahi, packed, s3, gs)
    bd = dqg.dequant_int4_plain(packed, s3.reshape(2 * K2 // gs, N), gs,
                                torch.bfloat16)
    flops = 2 * M * N * K
    nbytes = M * K * 2 + K2 * N + s3.numel() * 4 + M * N * 2
    bound, by = mm_bound(flops, nbytes, PEAK_BF16_FLOPS)
    tiles = dict.fromkeys((h.config["block_M"], h.config["block_N"])
                          for h in MatmulTemplate(M, N, K, "bfloat16",
                                                  arch=arch).hints(2))
    for i, tile in enumerate(tiles):
        kern = ys.hand_w4a16(M, N, K, gs, *tile)
        r = hold(f"hand_w4a16 4096_gs512 {tile}",
                 kern(alo, ahi, packed, s3), want)
        res["yardstick_w4a16_4096_gs512" + ("" if i == 0 else "_b2")] = {
            "shape": [M, N, K], "group_size": gs, "tile": list(tile), **r,
            **timed(lambda: kern(alo, ahi, packed, s3),
                    lambda: ys.hand_w4a16_plain(alo, ahi, packed, s3, gs),
                    lambda: torch.matmul(a, bd)),
            "library": "torch.matmul on the dequantised bf16 weight "
                       "(excludes the dequant)",
            "bound_ms": bound, "bound_by": by, "flops": flops,
            "bytes": nbytes}
    del a, packed, s3, alo, ahi, want, bd
    torch.cuda.empty_cache()
    print(json.dumps({"headline": {k: v for k, v in res.items()
                                   if k != "records"}}), flush=True)
    reset_peak(torch)
    return res


# the headline phase's kernels: (name, source, replaced TPU kernel,
# headline case); the other cases are nested under "variants"
HEADLINE_KERNELS = (
    ("yardstick_gemm", "yardstick_gemm.cu", "bench.py:262",
     "bf16_8192x8192x4096"),
    ("yardstick_w4a16", "yardstick_w4a16.cu", "bench.py:1366",
     "4096_gs512"))


def kernel_registers(log):
    """{kernel: [registers, spill-store bytes]} from ``nvcc -Xptxas -v``
    output; a kernel is named by its function and its template
    arguments (``matmul_bf16<1,0>``)."""
    import re
    args = {"f": "f32", "13__nv_bfloat16": "bf16", "6__half": "f16",
            "h": "u8", "a": "s8"}
    out, name, spill = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"entry function '(?:_Z\w*?_cu_[0-9a-f]{8}|"
                      r"_ZN7tl_sm90|_ZN7tl_ffma)(\d+)(\w+)'", line)
        if m:
            n = int(m.group(1))
            name, rest = m.group(2)[:n], m.group(2)[n:]
            if rest.startswith("I"):
                targs, pos = [], 1
                while pos < len(rest) and rest[pos] != "E":
                    t = re.match(r"L[bi](\d+)E|13__nv_bfloat16|6__half"
                                 r"|[fha]", rest[pos:])
                    if not t:
                        break
                    targs.append(t.group(1) or args[t.group(0)])
                    pos += t.end()
                name += "<" + ",".join(targs) + ">"
            spill = 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = [int(m.group(1)), spill]
            name = None
    return out


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from tilelang_mesh_tpu_torch.ops import _build
    from tilelang_mesh_tpu_torch.ops import bitnet as bn
    from tilelang_mesh_tpu_torch.ops import dequant_gemm as dqg
    from tilelang_mesh_tpu_torch.ops import flash_decoding as fd
    from tilelang_mesh_tpu_torch.ops import gemm as gm
    from tilelang_mesh_tpu_torch.ops import gemm_variants as gv
    from tilelang_mesh_tpu_torch.ops import gqa_bwd as gb
    from tilelang_mesh_tpu_torch.ops import gdn as gd
    from tilelang_mesh_tpu_torch.ops import grouped_gemm as gg
    from tilelang_mesh_tpu_torch.ops import mamba2 as m2
    from tilelang_mesh_tpu_torch.ops import mla
    from tilelang_mesh_tpu_torch.ops import quantize_act as qa
    # ops/__init__ shadows these modules with their functions
    fa = importlib.import_module("tilelang_mesh_tpu_torch.ops.flash_attention")
    gq = importlib.import_module("tilelang_mesh_tpu_torch.ops.gqa")
    la = importlib.import_module(
        "tilelang_mesh_tpu_torch.ops.linear_attention")
    vl = importlib.import_module(
        "tilelang_mesh_tpu_torch.ops.flash_attention_varlen")
    sk = importlib.import_module("tilelang_mesh_tpu_torch.ops.attention_sink")
    smx = importlib.import_module("tilelang_mesh_tpu_torch.ops.softmax")
    bsa = importlib.import_module(
        "tilelang_mesh_tpu_torch.ops.blocksparse_attention")
    seer = importlib.import_module(
        "tilelang_mesh_tpu_torch.ops.seer_attention")
    mi = importlib.import_module("tilelang_mesh_tpu_torch.ops.minference")
    nsa = importlib.import_module("tilelang_mesh_tpu_torch.ops.nsa")
    from tilelang_mesh_tpu_torch.ops import nsa_bwd as nb
    dsa = importlib.import_module("tilelang_mesh_tpu_torch.ops.dsa")
    from tilelang_mesh_tpu_torch.ops import yardsticks as ys

    scratch = ROOT / "build" / "chip_smoke"
    shutil.rmtree(scratch, ignore_errors=True)
    scratch.mkdir(parents=True)
    os.environ["TL_TPU_TRACE_DIR"] = str(scratch / "trace")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"nvidia-smi: {smi_line}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind}", flush=True)

    phase("build")
    sources = ("paged_decode", "decode", "mla_decode", "flash_attention",
               "gqa_bwd", "grouped_gemm", "gemm", "dequant_gemm", "mamba2",
               "gdn", "linear_attention", "gemm_s8", "gemm_variants",
               "gemv", "quantize_act", "bitnet_gemm",
               "flash_attention_varlen", "varlen_bwd", "attention_sink",
               "softmax", "blocksparse_attention", "minference", "nsa",
               "nsa_bwd", "dsa", "sparse_mla", "yardstick_gemm",
               "yardstick_w4a16")
    t0 = time.perf_counter()
    _build.build_all(sources)
    for src in sources:
        _build.load(src)
    print(f"built {len(sources)} sources in "
          f"{time.perf_counter() - t0:.2f}s")
    for src in sources:
        nvcc_s, log = _build.build_log(src)
        regs = [int(w) for line in log.splitlines() if "registers" in line
                for w, nxt in zip(line.split(), line.split()[1:])
                if nxt == "registers,"]
        spills = [int(line.split()[4]) for line in log.splitlines()
                  if "spill stores" in line]
        print(f"{src}: nvcc {nvcc_s:.2f}s, {len(regs)} kernels, registers "
              f"{min(regs, default=0)}-{max(regs, default=0)}, spill "
              f"stores up to {max(spills, default=0)} bytes")
    print(json.dumps({"registers": {src: kernel_registers(
        _build.build_log(src)[1]) for src in sources}}), flush=True)

    phase("kernels")
    f32 = kernel_phase(torch, fd, torch.float32)
    bf16 = kernel_phase(torch, fd, torch.bfloat16)
    dec32 = decode_phase(torch, fd, torch.float32)
    dec16 = decode_phase(torch, fd, torch.bfloat16)
    dec16h = decode_phase(torch, fd, torch.float16)
    mla32 = mla_kernel_phase(torch, mla, torch.float32)
    mla16 = mla_kernel_phase(torch, mla, torch.bfloat16)
    attn32 = attention_phase(torch, fa, gb, torch.float32)
    attn16 = attention_phase(torch, fa, gb, torch.bfloat16)
    gemm32 = gemm_phase(torch, gg, torch.float32)
    gemm16 = gemm_phase(torch, gg, torch.bfloat16)
    gemmh = gemm_phase(torch, gg, torch.float16)

    phase("model")
    mdl = model_phase(torch, fa, gb)

    phase("serving")
    srv = serving_phase(torch, fd, scratch / "prefix")

    phase("mla")
    msrv = mla_serving_phase(torch, mla, scratch / "mla_prefix")
    shutil.rmtree(scratch, ignore_errors=True)

    phase("moe")
    moe_res = moe_phase(torch, gg)

    phase("ring")
    ring = ring_phase(torch, fa)

    phase("gemm")
    gops = gemm_ops_phase(torch, gm, dqg)

    phase("seqmix")
    seq = seqmix_phase(torch, m2, gd, la)

    phase("gemm_variants")
    var = gemm_variants_phase(torch, gv, gm)

    phase("bitnet_gqa")
    bg = bitnet_gqa_phase(torch, bn, qa, gq, gb)

    phase("varlen")
    vr = varlen_phase(torch, vl, fa, gq, gb)

    phase("attention_family")
    af = attention_family_phase(torch, sk, smx, bsa, seer, fa, gq, gb)

    phase("sparse_inference")
    si = sparse_inference_phase(torch, mi, nsa)

    phase("nsa_training")
    nt = nsa_training_phase(torch, nsa, nb)

    phase("dsa")
    ds = dsa_phase(torch, dsa)

    phase("headline")
    hl = headline_phase(torch, ys, gm, dqg, fa, mla, fd, gg, m2, gd)

    kernels = [{
        "name": "paged_decode", "route": "cuda",
        "source": "tilelang_mesh_tpu_torch/csrc/paged_decode.cu",
        "replaces": "tilelang_mesh_tpu/ops/flash_decoding.py:113",
        "launches": srv["launches"], "max_abs_err": f32["max_abs_err"],
        "ms": f32["ms"], "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"],
        "library_ms": f32["library_ms"],
        "bf16": {k: bf16[k] for k in ("max_abs_err", "ms", "plain_ms",
                                      "bound_ms", "library_ms")},
    }]
    csrc = "tilelang_mesh_tpu_torch/csrc/"
    kernels.append({
        "name": "decode", "route": "cuda", "source": csrc + "decode.cu",
        "replaces": "tilelang_mesh_tpu/ops/flash_decoding.py:25",
        "launches": dec32["launches"], "max_abs_err": dec32["max_abs_err"],
        "ms": dec32["ms"], "plain_ms": dec32["plain_ms"],
        "bound_ms": dec32["bound_ms"], "bound_by": dec32["bound_by"],
        "library_ms": dec32["library_ms"],
        "bf16": {k: dec16[k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "library_ms")},
        "f16": {k: dec16h[k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "library_ms")},
        # one counter for both kernels of the source, by type
        "kernels": {r["dtype"]: r["kernel"] for r in (dec32, dec16,
                                                       dec16h)}})
    # MLA at bench.py:1495's shape and 8 splits, mla_decode's default
    m32, m16 = ({c["n_split"]: c for c in r["cases"] if c["S"] == MLA_S}[8]
                for r in (mla32, mla16))
    kernels.append({
        "name": "mla_decode", "route": "cuda",
        "source": csrc + "mla_decode.cu",
        "replaces": "tilelang_mesh_tpu/ops/mla.py:22",
        "launches": msrv["launches"], "max_abs_err": m32["max_abs_err"],
        "ms": m32["ms"], "plain_ms": m32["plain_ms"],
        "bound_ms": m32["bound_ms"], "bound_by": m32["bound_by"],
        "library_ms": mla32[f"library_ms_S{MLA_S}"],
        "bf16": {**{k: m16[k] for k in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms")},
                 "library_ms": mla16[f"library_ms_S{MLA_S}"]}})
    for kname, source, replaces, launches in (
            ("mha_fwd", "flash_attention.cu",
             "tilelang_mesh_tpu/ops/flash_attention.py:71",
             mdl["forward_launches"]["mha_fwd"]),
            ("mha_fwd_partial", "flash_attention.cu",
             "tilelang_mesh_tpu/ops/flash_attention.py:124",
             mdl["train_launches"]["mha_fwd_partial"]),
            ("gqa_bwd_dkdv", "gqa_bwd.cu",
             "tilelang_mesh_tpu/ops/gqa_bwd.py:29",
             mdl["train_launches"]["gqa_bwd_dkdv"]),
            ("gqa_bwd_dq", "gqa_bwd.cu",
             "tilelang_mesh_tpu/ops/gqa_bwd.py:103",
             mdl["train_launches"]["gqa_bwd_dq"])):
        a, b = attn32[kname], attn16[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": csrc + source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": a["max_abs_err"], "ms": a["ms"],
            "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
            "bound_by": a["bound_by"], "library_ms": a["library_ms"],
            "bf16": {k: b[k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "library_ms")}})
    # the partial kernel is also ring attention's step (the ring phase)
    next(k for k in kernels if k["name"] == "mha_fwd_partial")[
        "ring_launches"] = ring["causal"]["launches"]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms")
    # #20 and #21 by path: the layer's first expert product (the second
    # in "w2"), the routed rows (B transposed in "varlen_trans", and in
    # "varlen_trans_loop" on the loop); the loop at K d - 1. The MoE layer
    # launches the TMA kernel in bfloat16 and the 3xTF32 one in float32;
    # the token-sorted entry point and the loop are on no main path: their
    # launches are those driven in the kernels phase (the MoE path's
    # count, 0, is added and kept apart).
    gemms = {"float32": gemm32, "bfloat16": gemm16, "float16": gemmh}
    entry = {k: sum(r["entry_launches"][k] for r in gemms.values())
             for k in gemm32["entry_launches"]}
    for kname, head, types, case, launches in (
            ("grouped_gemm_tma", "bfloat16", ("float16",), "w1",
             moe_res["bfloat16"]["launches"]["grouped_gemm_tma"]),
            ("grouped_gemm_tf32x3", "float32", (), "w1",
             moe_res["launches"]["grouped_gemm_tf32x3"]),
            ("grouped_gemm", "float32", ("bfloat16", "float16"), "w1_loop",
             entry["grouped_gemm"]),
            ("varlen_grouped_gemm_tma", "bfloat16", ("float16",), "varlen",
             entry["varlen_grouped_gemm_tma"]),
            ("varlen_grouped_gemm_tf32x3", "float32", (), "varlen",
             entry["varlen_grouped_gemm_tf32x3"]),
            ("varlen_grouped_gemm", "float32", ("bfloat16", "float16"),
             "varlen_loop", entry["varlen_grouped_gemm"])):
        top = gemms[head][case]
        e = {"name": kname, "route": "cuda",
             "source": csrc + "grouped_gemm.cu",
             "replaces": "tilelang_mesh_tpu/ops/grouped_gemm.py:" + (
                 "58" if kname.startswith("varlen") else "17"),
             "launches": launches, "dtype": head, "case": case,
             "path": top["path"], "block": top["block"],
             **{k: top[k] for k in keys + ("bound_by",)},
             **{t: {k: gemms[t][case][k] for k in keys} for t in types}}
        second = {"w1": "w2", "varlen": "varlen_trans",
                  "varlen_loop": "varlen_trans_loop"}.get(case)
        if second:
            e[second] = {t: {k: gemms[t][second][k] for k in keys}
                         for t in (head,) + types}
        if kname.startswith("varlen"):
            e["moe_path_launches"] = \
                moe_res["launches"]["varlen_grouped_gemm" + kname[19:]]
        if case == "varlen":
            e["bmm_padded_ms"] = top["bmm_padded_ms"]
        kernels.append(e)
    for entry in kernel_entries(gops, GEMM_OPS_KERNELS):
        if entry["name"] == "matmul_tma":     # its fp8 operands' pre-pass
            entry["prepass"] = {
                "name": "fp8_widen", "route": "cuda",
                "source": csrc + "gemm.cu",
                "launches": gops["launches"]["fp8_widen"],
                **{k: gops["fp8_widen_4096"][k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")}}
        kernels.append(entry)
    check(gops["launches"]["fp8_widen"] > 0,
          "gemm: the fp8 pre-pass fp8_widen was not launched")
    for entry in kernel_entries(seq, SEQMIX_KERNELS):
        entry["library"] = SEQMIX_LIBRARY
        if entry["name"] == "gdn_chunk_fwd":     # the call: two kernels
            entry["kernels"] = ["gdn_chunk_wy", "gdn_chunk_state"]
        if entry["name"] == "linear_attention":
            entry["backward"] = seq["linear_attention_backward"]
        kernels.append(entry)
    for entry in kernel_entries(var, VARIANT_KERNELS):
        fixup = VARIANT_FIXUPS.get(entry["name"])
        if fixup:
            entry["fixup"] = {"name": fixup,
                              "launches": var["launches"][fixup]}
        if entry["name"] == "blocksparse_gemm":
            # one counter for both kernels of the source; the case's
            # kernel and tile
            top = var["blocksparse_gemm_prefill_gate_up_bf16"]
            entry.update(kernel=top["kernel"], tile=top["tile"])
        kernels.append(entry)
    kernels += kernel_entries(bg, BITNET_GQA_KERNELS)
    for entry in kernel_entries(vr, VARLEN_KERNELS):
        # each wrapper counts both kernels of its source: the kernel of
        # each type, and the 16-bit kernel's tile in each case
        name = entry["name"]
        entry["kernels"] = {t: vr[f"{name}_{t}"]["kernel"]
                            for t in ("float32", "bfloat16", "float16")}
        entry["tiles"] = {
            c[len(name) + 1:]: v["tile"] for c, v in vr.items()
            if c.startswith(name + "_") and "tile" in v
            and (name == "varlen_fwd_partial"
                 or not c.startswith("varlen_fwd_partial_"))}
        kernels.append(entry)
    for entry in kernel_entries(af, ATTN_FAMILY_KERNELS):
        if entry["name"] == "attention_sink":
            entry["sdpa_without_sinks"] = {
                k: af[f"attention_sink_causal_{k}"]["sdpa_without_sinks_ms"]
                for k in ("float32", "bfloat16", "float16")}
            entry["tiles_per_block"] = af["sink_tiles_per_block"]
            # one counter for both kernels of the source, by type
            entry["kernels"] = {"float32": "sink_fwd (CUDA cores)",
                                "bfloat16": "sink_fwd_mma (mma.sync)",
                                "float16": "sink_fwd_mma (mma.sync)"}
            entry["training_step"] = {
                k: af[f"sink_train_{k}"] for k in ("float32", "bfloat16")}
            entry["training_launches"] = {
                k: af["launches"][k] for k in ("gqa_fwd_partial",
                                               "gqa_bwd_dkdv", "gqa_bwd_dq")}
        if entry["name"] == "softmax":
            # one counter for the three kernels of the source, by case
            entry["kernels"] = {c: af[f"softmax_{c}"]["kernel"]
                                for c in ("vocab", "vocab_bf16", "router")}
        if entry["name"] == "blocksparse_mha":
            # one counter for both kernels of the source, by type, and
            # the 16-bit kernel's tile in each case (the pairs of its live
            # tiles are in the phase's records)
            entry["kernels"] = {"float32": "blocksparse_mha (CUDA cores)",
                                "bfloat16": "blocksparse_mha_mma (mma.sync)",
                                "float16": "blocksparse_mha_mma (mma.sync)"}
            entry["tiles"] = {
                f"{c}_{t}": af[f"blocksparse_mha_{c}_{t}"]["tile"]
                for c in ("random", "seer") for t in ("bfloat16", "float16")}
        kernels.append(entry)
    for entry in kernel_entries(si, SPARSE_INFERENCE_KERNELS):
        if entry["name"] == "vs_sparse":
            entry["kernels"] = {"float32": "vs_sparse (CUDA cores)",
                                "bfloat16": "vs_sparse_mma (mma.sync)",
                                "float16": "vs_sparse_mma (mma.sync)"}
            entry["tiles"] = {t: si[f"vs_sparse_{t}"]["tile"]
                              for t in ("bfloat16", "float16")}
        if entry["name"] == "nsa_decode":      # the splits' combine
            entry["fixup"] = {
                "name": "nsa_decode_combine",
                "launches": si["launches"]["nsa_decode_combine"]}
            entry["library_gather_ms"] = {
                k: si[f"nsa_decode_{k}"]["library_gather_ms"]
                for k in ("float32", "bfloat16")}
        kernels.append(entry)
    check(si["launches"]["nsa_decode_combine"] > 0,
          "sparse_inference: nsa_decode_combine was not launched")
    for entry in kernel_entries(nt, NSA_TRAINING_KERNELS):
        if entry["name"] == "nsa_bwd_dkdv":     # the chunk partials' sum
            entry["fixup"] = {"name": "nsa_bwd_dkdv_sum",
                              "launches": nt["launches"]["nsa_bwd_dkdv_sum"]}
        if entry["name"].startswith("nsa_bwd_"):
            # the kernel of each type; dK / dV's plan, kernel and sum
            # apart (the gathered bytes stay in the phase's records)
            parts = ("kernel", "ms", "plan_ms", "kernel_ms", "sum_ms")
            entry["by_type"] = {
                t: {k: v for k, v in nt[f"{entry['name']}_{t}"].items()
                    if k in parts}
                for t in ("float32", "bfloat16", "float16")}
            top = entry["by_type"][entry["case"]]
            entry.update({k: top.get(k) for k in parts[2:]})
        if entry["name"] == "nsa_fwd_partial":
            entry["training_step"] = {
                k: nt[f"nsa_train_{k}"] for k in ("float32", "bfloat16")}
        kernels.append(entry)
    check(all(k["launches"] > 0 for k in kernels
              if k["name"] in [n for n, *_ in NSA_TRAINING_KERNELS])
          and nt["launches"]["nsa_bwd_dkdv_sum"] > 0,
          "nsa_training: a kernel of the path was not launched")
    for entry in kernel_entries(ds, DSA_KERNELS):
        if entry["name"] == "sparse_mla_fwd":
            entry["finetune_step"] = {
                k: ds[f"dsa_finetune_{k}"] for k in ("float32", "bfloat16")}
            # the 16-bit mma.sync kernel of the source, off the DSA
            # widths: held at D 192 on the ragged ids
            entry["mma_d192"] = ds["sparse_mla_mma_d192_bfloat16"]
        kernels.append(entry)
    kernels += kernel_entries(hl, HEADLINE_KERNELS)
    check(all(k["launches"] > 0 for k in kernels),
          f"kernels never launched on their paths: "
          f"{[k['name'] for k in kernels if not k['launches'] > 0]}")
    peak = max(SCRIPT_PEAK[0], torch.cuda.max_memory_allocated())
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f}s, peak "
          f"device memory {peak} bytes")
    print(smi_line)                      # the card, as nvidia-smi names it
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
