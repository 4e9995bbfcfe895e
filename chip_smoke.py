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
              routed per-expert counts, both layouts of B;
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
              (see MOE_FULL) on 4096 tokens: two grouped-GEMM launches a
              call, the output and the kept-token count against the same
              layer with the plain grouped GEMM, the forward's median
              time, peak memory, and one call under torch.profiler;
8. ring     — the fifth main path: ring attention (make_ring_attention,
              one rank) at the model's attention shapes (B=2, H=16,
              S=4096, D=128), causal and not: one partial-kernel launch a
              call, the output against the plain attention on the card;
9. gemm     — the sixth main path: the library's GEMM entry points at
              bench.py's shapes (see GEMM_OPS_TOL): matmul in bf16 at
              1024^3 and 8192 x 8192 x 4096, in f32 and bf16 at 4096^3
              in every transpose, once with ReLU, fp8 e4m3 -> f32, f16
              and int8 -> int32 (accum_dtype int32) at 4096^3;
              dequant_matmul and dequant_matmul_twopass (w4a16,
              bf16, group size 512) at 4096^3 and dequant_matmul at a
              LLaMA-2-7B MLP decode step (M 16, K 4096, N 11008, group
              128); w4a8_matmul at 4096^3. Each call one launch of its
              kernel (two-pass: one unpack, one matmul), read right
              after; its output against the plain version on the card;
              kernel, plain and library times and the bound;
10. seqmix  — the seventh main path: the sequence-mixing entry points at
              bench.py's widths (see MAMBA2, GDN, LINATTN):
              mamba2_chunk_scan (Mamba2-2.7B's SSD widths, chunks 128 and
              256 in bf16, 128 in f32) and gdn_chunk_fwd_tl (chunk 64 in
              bf16 and f32; chunk 128 refused, it does not fit a block's
              shared memory), each also against the sequential recurrence
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
              products, stream-K at a 512-token prefill chunk's gate/up
              with one program a block the card holds at once, GEMV at a
              single token's gate/up (bf16, f32) and LM head, block-sparse
              at a 4096-token prefill's gate/up under a random half-dense
              128 x 128 cell mask. Each call's launches (the split-K and
              stream-K sums named) read right after; its output against
              the plain version on the card; block-sparse dead cells
              exactly 0 and an all-ones mask against matmul; kernel,
              plain, library and matmul times and the bound.
12. bitnet_gqa — the ninth main path: BitNet b1.58-2B-4T's FFN block and
              grouped-query attention (see BITNET): the BitFFN on a
              4096-token prefill and a decode step (three bitnet_gemm
              launches a call, equal to the module's reference mode on
              the card, the forward's median time), quantize_act_int8 on
              the FFN's input and hidden activation (one launch each,
              the plain version's bytes, a zero row), gqa_attention at 20
              query over 5 KV heads, S 4096, causal, f32 and bf16 (one
              gqa_fwd launch without autograd; one partial, one dK/dV,
              one dQ with it; output and gradients against the plain
              versions); then bitnet_gemm at the FFN's three products,
              each kernel's time, its plain version's, a library call's
              and the bound.

The peak device memory printed at the end is the script's: each phase
that reads its own peak adds it to the script's before zeroing the
counter. Prints a ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``. Without a card it exits non-zero and
prints no result.
"""

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
ATTN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# the model path against the dense plain path on the same weights
# (float32 both; softmax in another form and order, 4 layers deep)
MODEL_TOL = {"logits": 1e-4, "loss": 1e-5, "grad": 1e-3}

# The repo's expert-parallel MoE layer (parallel/moe.py make_moe_layer,
# one rank: ep = 1 on one card) at the widths of Mixtral-8x7B's MoE layer
# (https://huggingface.co/mistralai/Mixtral-8x7B-v0.1/blob/main/config.json:
# hidden_size 4096, intermediate_size 14336, num_local_experts 8,
# num_experts_per_tok 2) on one 4096-token prefill chunk, capacity factor
# 1.25 (make_moe_layer's default: C = ceil(4096 * 2 * 1.25 / 8) = 1280),
# float32 as dryrun_multichip runs the layer. Departures, so this is not
# Mixtral: the repo's expert is silu(x W1) W2, not SwiGLU with W3; the
# router is a softmax over all 8 experts, then top-2 without
# renormalising; capacity drops tokens; one layer of 32, no attention.
# Weights from seeded torch.Generators on the card: x ~ N(0, 1), the
# router N(0, 1/d), W1 N(0, 1/d), W2 N(0, 1/f) (unit-scale activations).
MOE_FULL = dict(tokens=4096, d=4096, f=14336, experts=8, top_k=2,
                capacity_factor=1.25)
# grouped GEMM vs plain, normwise: float32 the same sums in another
# order; bfloat16 an output rounded to bf16 may flip one ulp (2**-8)
GEMM_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
MOE_TOL = 1e-5          # the layer on the kernel vs on the plain GEMM

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
# :1667) at B 8, H 16, T 4096, K = V = 128, chunk 64 in bf16 and f32
# (chunk 128 does not fit a block's shared memory: refused); bench's
# seeded numpy draws, nothing cut. Linear attention and retention have no
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
    res = {"dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
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


def device_breakdown(torch, fn):
    """Run ``fn`` once under torch.profiler: the wall time, the device's
    busy time (union of its activity intervals) and share, and device ms
    by kind: the port's attention and decode kernels, its grouped GEMM
    kernels, other GEMMs (cuBLAS), everything else."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kinds = {"attention_kernels_ms": 0.0, "grouped_gemm_ms": 0.0,
             "gemm_ms": 0.0, "other_ms": 0.0}
    spans = []
    for e in prof.events():
        if e.device_type.name != "CUDA":
            continue
        t0, t1 = e.time_range.start, e.time_range.end
        spans.append((t0, t1))
        kind = ("attention_kernels_ms" if any(
            k in e.name for k in ("mha_fwd", "gqa_bwd", "decode")) else
                "grouped_gemm_ms" if "grouped_gemm" in e.name else
                "gemm_ms" if "gemm" in e.name else "other_ms")
        kinds[kind] += (t1 - t0) / 1e3
    busy, end = 0.0, -math.inf
    for t0, t1 in sorted(spans):
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    check(busy > 0, "the profiler saw no device activity")
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / wall_us, **kinds}


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
    peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def gemm_phase(torch, gg, dtype):
    """The dense grouped GEMM at the MoE layer's two expert products, and
    the token-sorted one on the MOE_FULL batch's routed per-expert
    counts (K = d, N = f, B in both layouts), against their plain
    versions; times, bounds and a torch.bmm yardstick."""
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

    res = {"dtype": name, "tolerance": f"normwise {tol}", "sizes": sizes}
    for label, (M, K, N) in (("w1", (C, d, f)), ("w2", (C, f, d))):
        a, b = rnd(E, M, K), rnd(E, K, N, scale=K ** -0.5)
        err, rel = compare(f"grouped_gemm {label}",
                           lambda: gg.grouped_matmul(a, b),
                           lambda: gg.grouped_matmul_plain(a, b))
        flops = 2 * E * M * N * K
        nbytes = (E * M * K + E * K * N + E * M * N) * esize
        bound, by = gemm_bound(torch, dtype, flops, nbytes)
        res[label] = {
            "shape": [E, M, K, N], "max_abs_err": err, "normwise_err": rel,
            "ms": cuda_ms(torch, lambda: gg.grouped_matmul(a, b), 5),
            "plain_ms": cuda_ms(torch, lambda: gg.grouped_matmul_plain(a, b),
                                3),
            "library_ms": cuda_ms(torch, lambda: torch.bmm(a, b), 5),
            "bound_ms": bound, "bound_by": by, "flops": flops,
            "bytes": nbytes}
        del a, b
        torch.cuda.empty_cache()

    a = torch.cat([xe[e, :s] for e, s in enumerate(sizes)]).to(dtype)
    xpad = xe.to(dtype)                  # the capacity-padded layout
    del xe
    b = rnd(E, d, f, scale=d ** -0.5)
    rows = sum(sizes)
    live = sum(1 for s in sizes if s)
    flops = 2 * rows * d * f
    nbytes = (rows * d + live * d * f) * esize + rows * f * 4 \
        + 4 * (2 * len(gg._varlen_meta(sizes, gg.KERNEL_BLOCK_M)[0]) + E)
    bound, by = gemm_bound(torch, dtype, flops, nbytes)
    # cuBLAS on the padded layout does C·E rows against the routed rows
    padded_ms = cuda_ms(torch, lambda: torch.bmm(xpad, b), 5)
    starts = [sum(sizes[:e]) for e in range(E)]
    for trans_b in (False, True):
        bb = b.transpose(1, 2).contiguous() if trans_b else b

        def kern():
            return gg.varlen_grouped_matmul(a, bb, sizes, trans_b=trans_b)

        def plain():
            return gg.varlen_grouped_matmul_plain(a, bb, sizes, trans_b)

        def library():                   # the same work: the routed rows
            return [a[s0:s0 + n] @ (bb[e].t() if trans_b else bb[e])
                    for e, (s0, n) in enumerate(zip(starts, sizes)) if n]

        err, rel = compare(f"varlen_grouped_gemm trans_b={trans_b}", kern,
                           plain)
        res["varlen_trans" if trans_b else "varlen"] = {
            "rows": rows, "max_abs_err": err, "normwise_err": rel,
            "ms": cuda_ms(torch, kern, 5), "plain_ms": cuda_ms(torch, plain,
                                                               3),
            "library_ms": cuda_ms(torch, library, 5),
            "library": "torch.matmul per group on the routed rows",
            "bmm_padded_ms": padded_ms,
            "bound_ms": bound, "bound_by": by, "flops": flops,
            "bytes": nbytes}
        del bb
    del a, b, xpad
    torch.cuda.empty_cache()
    print(json.dumps({"grouped_gemm": name, **res}), flush=True)
    return res


def moe_phase(torch, gg):
    """The MoE layer at MOE_FULL on one card: the main path's call with
    its launch count, then the same layer on the plain grouped GEMM, the
    forward's median time, and one call under torch.profiler."""
    from tilelang_mesh_tpu_torch.parallel import moe
    c = MOE_FULL
    x, wr, w1, w2 = moe_inputs(torch)
    layer = moe.make_moe_layer(None, top_k=c["top_k"],
                               capacity_factor=c["capacity_factor"])
    torch.cuda.synchronize()
    reset_peak(torch)
    gg.reset_launches()                  # the main path starts here
    t0 = time.perf_counter()
    out = layer(x, wr, w1, w2)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(gg.launches)                   # read right after
    call_peak = torch.cuda.max_memory_allocated()
    check(launches["grouped_gemm"] == 2,
          f"grouped_gemm launched {launches['grouped_gemm']} times in one "
          f"layer call, want 2")
    check(tuple(out.shape) == (c["tokens"], c["d"])
          and bool(torch.isfinite(out).all()), "bad MoE output")

    kernel_gemm = moe.grouped_matmul     # the same layer, plain GEMMs
    moe.grouped_matmul = lambda a, b, **_: gg.grouped_matmul_plain(a, b)
    try:
        want = layer(x, wr, w1, w2)
    finally:
        moe.grouped_matmul = kernel_gemm
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

    layer(x, wr, w1, w2)                 # warm-up
    gg.reset_launches()
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        layer(x, wr, w1, w2)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    check(gg.launches["grouped_gemm"] == 10,
          f"{gg.launches['grouped_gemm']} grouped launches in 5 calls")
    profile = device_breakdown(torch, lambda: layer(x, wr, w1, w2))
    med = sorted(times)[len(times) // 2]
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
    print(json.dumps(res), flush=True)
    del x, wr, w1, w2
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
    import numpy as np
    from tilelang_mesh_tpu_torch.quantize import quantize_int4_planar
    counted = {"matmul": 0, "dequant_gemm": 0, "dequant_int4": 0,
               "w4a8_gemm": 0}
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
        got = drive(f"matmul {label}", lambda: kern(a, b), {"matmul": 1})
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
        res[f"matmul_{label}"] = {
            "shape": [M, N, K], "dtype": str(dt), "out": name,
            "trans": [ta, tb], "relu": relu, **r,
            **timed(lambda: kern(a, b),
                    lambda: gm.matmul_plain(a, b, ta, tb, out_dt, relu),
                    library),
            "library": lib_name, "bound_ms": bound, "bound_by": by,
            "flops": flops, "bytes": nbytes}
        del a, b, lhs, rhs
        torch.cuda.empty_cache()

    # -- #22, #23, two-pass: w4a16 ---------------------------------------
    for label, (M, K, N, gs), seed in (
            ("4096_gs512", (4096, 4096, 4096, 512), 3),
            ("decode_m16_k4096_n11008_gs128",
             tuple(LLAMA2_MLP[k] for k in ("M", "K", "N", "gs")), 14)):
        rng = np.random.default_rng(seed)      # as cfg_w4a16 draws them
        a_np = (rng.standard_normal((M, K)) * 0.1).astype(np.float32)
        w_np = rng.standard_normal((K, N)).astype(np.float32) * 0.1
        packed_np, scales_np = quantize_int4_planar(w_np, group_size=gs)
        del w_np
        a = torch.from_numpy(a_np).cuda().to(torch.bfloat16)
        packed = torch.from_numpy(packed_np).cuda()
        scales = torch.from_numpy(scales_np).cuda()
        K2 = K // 2
        got = drive(f"dequant_matmul {label}", lambda: dqg.dequant_matmul(
            a, packed, scales, group_size=gs, block_K2=gs),
            {"dequant_gemm": 1})
        want = dqg.dequant_matmul_plain(a, packed, scales, gs)
        r = hold(f"dequant_matmul {label}", got, want,
                 GEMM_OPS_TOL["bfloat16"])
        del got, want
        bd = dqg.dequant_int4_plain(packed, scales, gs, torch.bfloat16)
        flops = 2 * M * N * K
        nbytes = (M * K * 2 + K2 * N + scales.numel() * 4 + M * N * 2)
        bound, by = mm_bound(flops, nbytes, PEAK_BF16_FLOPS)
        res[f"dequant_gemm_{label}"] = {
            "shape": [M, N, K], "group_size": gs, **r,
            **timed(lambda: dqg.dequant_matmul(a, packed, scales,
                                               group_size=gs, block_K2=gs),
                    lambda: dqg.dequant_matmul_plain(a, packed, scales, gs),
                    lambda: torch.matmul(a, bd)),
            "library": "torch.matmul on the dequantised bf16 weight "
                       "(excludes the dequant)",
            "bound_ms": bound, "bound_by": by, "flops": flops,
            "bytes": nbytes}
        if label.startswith("4096"):     # bench's w4a16: the two-pass path
            two = drive(f"dequant_matmul_twopass {label}",
                        lambda: dqg.dequant_matmul_twopass(a, packed,
                                                           scales),
                        {"dequant_int4": 1, "matmul": 1})
            r2 = hold(f"dequant_matmul_twopass {label}", two,
                      gm.matmul_plain(a, bd), GEMM_OPS_TOL["bfloat16"])
            del two
            got = dqg.dequant_int4(packed, scales, gs, torch.bfloat16)
            r3 = hold(f"dequant_int4 {label}", got, bd,
                      GEMM_OPS_TOL["dequant_int4"])
            check(torch.equal(got.view(torch.int16), bd.view(torch.int16)),
                  "dequant_int4 is not bit-equal to its plain version")
            del got
            nb3 = K2 * N + scales.numel() * 4 + K * N * 2
            b3, by3 = mm_bound(0, nb3, PEAK_BF16_FLOPS)
            res[f"dequant_int4_{label}"] = {
                "shape": [K2, N], "group_size": gs, **r3,
                **timed(lambda: dqg.dequant_int4(packed, scales, gs,
                                                 torch.bfloat16),
                        lambda: dqg.dequant_int4_plain(packed, scales, gs,
                                                       torch.bfloat16),
                        None),
                "bound_ms": b3, "bound_by": by3, "bytes": nb3}
            res[f"twopass_{label}"] = {
                **r2, **timed(lambda: dqg.dequant_matmul_twopass(
                    a, packed, scales), lambda: gm.matmul_plain(
                        a, dqg.dequant_int4_plain(packed, scales, gs,
                                                  torch.bfloat16)), None)}
        del a, packed, scales, bd
        torch.cuda.empty_cache()

    # -- #24 w4a8 ----------------------------------------------------------
    M = N = K = 4096
    rng = np.random.default_rng(9)              # as cfg_w4a8 draws them
    x_np = rng.standard_normal((M, K)).astype(np.float32)
    w_np = rng.standard_normal((K, N)).astype(np.float32) * 0.1
    packed_np, sw_np = dqg.quantize_w4_per_channel(w_np)
    del w_np
    x = torch.from_numpy(x_np).cuda()
    packed = torch.from_numpy(packed_np).cuda()
    sw = torch.from_numpy(sw_np).cuda()
    got = drive("w4a8_matmul 4096", lambda: dqg.w4a8_matmul(x, packed, sw),
                {"w4a8_gemm": 1})
    q, s = dqg.quantize_activations(x)
    sa = (1.0 / s).float()
    want = dqg.w4a8_gemm_plain(q, packed, sw, sa)
    r = hold("w4a8_matmul 4096", got, want, GEMM_OPS_TOL["w4a8"])
    del got, want
    p32 = packed.to(torch.int32)
    # the unpacked weight, column-major as cuBLASLt's int8 path takes it
    wd8 = torch.cat([(p32 & 0xF) - 8, (p32 >> 4) - 8]).to(
        torch.int8).T.contiguous().T
    del p32
    flops = 2 * M * N * K
    nbytes = M * K + K * N // 2 + 4 * (N + M) + 4 * M * N
    bound, by = mm_bound(flops, nbytes, PEAK_8BIT_OPS)
    res["w4a8_gemm_4096"] = {
        "shape": [M, N, K], **r,
        **timed(lambda: dqg.w4a8_gemm(q, packed, sw, sa),
                lambda: dqg.w4a8_gemm_plain(q, packed, sw, sa),
                lambda: torch._int_mm(q, wd8)),
        "library": "torch._int_mm on the unpacked int8 weight (excludes "
                   "the epilogue)",
        "entry_ms": device_ms(torch, lambda: dqg.w4a8_matmul(x, packed, sw),
                              5),
        "bound_ms": bound, "bound_by": by, "flops": flops, "bytes": nbytes}
    del x, packed, sw, q, s, sa, wd8
    torch.cuda.empty_cache()
    res["launches"] = counted
    print(json.dumps({"gemm": res}), flush=True)
    return res


# the gemm phase's kernels: (name, source, replaced TPU kernel, headline
# case); the kernel's other cases are nested under "variants"
GEMM_OPS_KERNELS = (
    ("matmul", "gemm.cu", "tilelang_mesh_tpu/ops/gemm.py:18",
     "bf16_8192x8192x4096"),
    ("dequant_gemm", "dequant_gemm.cu",
     "tilelang_mesh_tpu/ops/dequant_gemm.py:62", "4096_gs512"),
    ("dequant_int4", "dequant_gemm.cu",
     "tilelang_mesh_tpu/ops/dequant_gemm.py:127", "4096_gs512"),
    ("w4a8_gemm", "dequant_gemm.cu",
     "tilelang_mesh_tpu/ops/dequant_gemm.py:204", "4096"))


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
    counted = dict.fromkeys(gv.launches, 0)
    res = {}
    reset_peak(torch)
    hid, inter = LLAMA2["hidden"], LLAMA2["inter"]

    def drive(label, call, want_launches, main=True):
        torch.cuda.synchronize()
        gv.reset_launches()
        gm.reset_launches()
        out = call()
        torch.cuda.synchronize()
        got = {**gv.launches, "matmul": gm.launches["matmul"]}
        want = {k: want_launches.get(k, 0) for k in got}
        check(got == want, f"{label}: launches {got}, want {want}")
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

    # -- #16 split-K: a 16-token decode step's MLP products ---------------
    M = LLAMA2["decode"]
    for label, (K, N), dt, seed in (
            ("decode_gate_up_bf16", (hid, inter), torch.bfloat16, 30),
            ("decode_down_bf16", (inter, hid), torch.bfloat16, 31),
            ("decode_gate_up_f32", (hid, inter), torch.float32, 30)):
        a, b = operands(seed, (M, K), (K, N), dtype=dt)
        n_ask = LLAMA2["n_split"]
        n_split, split_len, _ = gv.splitk_plan(K, n_ask)
        print(f"split-K {label}: {n_ask} splits asked, {n_split} taken "
              f"(chunks of {split_len})", flush=True)
        got = drive(f"matmul_splitk {label}", lambda: gv.matmul_splitk(
            a, b, n_split=n_ask), {"splitk_gemm": 1, "splitk_reduce": 1})
        r = hold(f"matmul_splitk {label}", got,
                 gv.matmul_splitk_plain(a, b, n_split=n_ask))
        del got
        res[f"splitk_gemm_{label}"] = {
            "shape": [M, N, K], "dtype": str(dt), "n_split_asked": n_ask,
            "n_split": n_split, "launches_a_call": 2, **r,
            **timed(lambda: gv.matmul_splitk(a, b, n_split=n_ask),
                    lambda: gv.matmul_splitk_plain(a, b, n_split=n_ask),
                    lambda: torch.matmul(a, b), lambda: gm.matmul(a, b)),
            "library": "torch.matmul in " + str(dt).replace("torch.", ""),
            "workspace_bytes": n_split * M * N * 4,
            **bound(dt, 2 * M * N * K,
                    (M * K + K * N + M * N) * a.element_size())}
        del a, b

    # -- #17 stream-K: a 512-token prefill chunk's gate/up ----------------
    M, K, N = LLAMA2["prefill_chunk"], hid, inter
    a, b = operands(32, (M, K), (K, N))
    n_prog = gv.streamk_programs()
    n_seg = len(gv._streamk_segments((M // 128) * (N // 128), K // 128,
                                     n_prog))
    print(f"stream-K: {n_prog} programs (SMs x blocks an SM), {n_seg} "
          f"segments over {(M // 128) * (N // 128)} tiles", flush=True)
    got = drive("matmul_streamk prefill", lambda: gv.matmul_streamk(
        a, b, n_programs=n_prog), {"streamk_gemm": 1, "streamk_fixup": 1})
    r = hold("matmul_streamk prefill", got,
             gv.matmul_streamk_plain(a, b, n_programs=n_prog))
    del got
    res["streamk_gemm_prefill_gate_up_bf16"] = {
        "shape": [M, N, K], "n_programs": n_prog, "n_segments": n_seg,
        "launches_a_call": 2, **r,
        **timed(lambda: gv.matmul_streamk(a, b, n_programs=n_prog),
                lambda: gv.matmul_streamk_plain(a, b, n_programs=n_prog),
                lambda: torch.matmul(a, b), lambda: gm.matmul(a, b)),
        "library": "torch.matmul in bf16",
        **bound(torch.bfloat16, 2 * M * N * K, (M * K + K * N + M * N) * 2)}
    del a, b

    # -- #18 GEMV: one token's gate/up and LM head ------------------------
    for label, N, dt, seed in (
            ("decode_gate_up_bf16", inter, torch.bfloat16, 33),
            ("decode_gate_up_f32", inter, torch.float32, 33),
            ("lm_head_bf16", LLAMA2["vocab"], torch.bfloat16, 34)):
        x, w = operands(seed, (hid,), (N, hid), dtype=dt)
        got = drive(f"gemv {label}", lambda: gv.gemv(x, w), {"gemv": 1})
        r = hold(f"gemv {label}", got, gv.gemv_plain(x, w))
        del got
        res[f"gemv_{label}"] = {
            "shape": [N, hid], "dtype": str(dt), **r,
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
    ("splitk_gemm", "gemm_variants.cu",
     "tilelang_mesh_tpu/ops/gemm_variants.py:36", "decode_gate_up_bf16"),
    ("streamk_gemm", "gemm_variants.cu",
     "tilelang_mesh_tpu/ops/gemm_variants.py:104", "prefill_gate_up_bf16"),
    ("gemv", "gemv.cu", "tilelang_mesh_tpu/ops/gemm_variants.py:169",
     "decode_gate_up_bf16"),
    ("blocksparse_gemm", "gemm_variants.cu",
     "tilelang_mesh_tpu/ops/gemm_variants.py:206", "prefill_gate_up_bf16"))
VARIANT_FIXUPS = {"splitk_gemm": "splitk_reduce",
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


def gdn_flops(B, H, T, K, V, c):
    """Operations the gated delta rule needs at chunk c, a token and a
    head: k k^T's strict lower triangle, the unit-lower triangular solve
    for w and u by substitution (the kernel's doubling inverse is more),
    the lower triangles of q k^T and of its product with the new values,
    and the three (K, V) state products."""
    return 2.0 * B * H * T * ((c - 1) / 2 * (2 * K + V)
                              + (c + 1) / 2 * (K + V) + 3 * K * V)


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
            "bytes": nbytes, "reference_s": ref_s}
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
    # chunk 128 does not fit a block's shared memory at these widths: the
    # wrapper must refuse it, naming the chunks it takes, with no launch
    try:
        drive("gdn_chunk_fwd_tl chunk 128", lambda: gd.gdn_chunk_fwd_tl(
            q, k, v, g, beta, chunk_size=128), {})
        refused = None
    except ValueError as e:
        refused = str(e)
    check(refused is not None and "takes chunks" in refused,
          "gdn_chunk_fwd_tl did not refuse chunk 128 on the card")
    res["gdn_chunk128"] = {"refused": refused}
    for label, chunk, dtype in (("bf16_chunk64", 64, torch.bfloat16),
                                ("f32_chunk64", 64, torch.float32)):
        qs, ks, vs = (t.to(dtype) for t in (q, k, v))
        got = drive(f"gdn_chunk_fwd_tl {label}", lambda: gd.gdn_chunk_fwd_tl(
            qs, ks, vs, g, beta, chunk_size=chunk), {"gdn_chunk_fwd": 1})
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
        res[f"gdn_chunk_fwd_{label}"] = {
            "shape": [B, H, T, K, V], "chunk": chunk, **r,
            **timed(lambda: gd.gdn_chunk_fwd_tl(qs, ks, vs, g, beta,
                                                chunk_size=chunk),
                    lambda: gd.gdn_chunk_fwd_tl_plain(qs, ks, vs, g, beta,
                                                      chunk, scale),
                    lambda: gd.gdn_chunk_fwd(qs, ks, vs, g, beta,
                                             chunk_size=chunk)),
            "bound_ms": bound, "bound_by": by, "flops": flops,
            "bytes": nbytes, "reference_s": ref_s}
        del qs, ks, vs
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
    ("linear_attention", "linear_attention.cu",
     "tilelang_mesh_tpu/ops/linear_attention.py:20", "float32_chunk128"),
    ("retention", "linear_attention.cu",
     "tilelang_mesh_tpu/ops/linear_attention.py:122", "float32_chunk64"))
SEQMIX_LIBRARY = ("none: no single PyTorch call computes the SSD scan, "
                  "the gated delta rule or chunked linear attention")


def bitnet_gqa_phase(torch, bn, qa, gq, gb):
    """BitNet b1.58-2B-4T's FFN block and grouped-query attention
    (BITNET): each main-path call with the counters zeroed before it and
    read right after (the FFN three bitnet_gemm launches a call, prefill
    and decode; quantize_act_int8 one; gqa_attention one gqa_fwd without
    autograd, one gqa_fwd_partial, one dK/dV and one dQ with it); the FFN
    equal to the same module's reference mode on the card (the plain
    path: the exact product in float64, the same epilogue), its forward's
    median time; each kernel against its plain version on the card at
    the path's shapes, with kernel, plain and library times and the
    bound."""
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
    for label, xx in (("prefill", x), ("decode", x1)):
        y = drive(f"BitFFN {label}", lambda: ffn(xx), {"bitnet_gemm": 3})
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
    for label, a, name in (("prefill_gate_up", q_in, "gate"),
                           ("prefill_down", q_h, "down"),
                           ("decode_gate_up", q_dec, "gate")):
        packed = getattr(ffn, f"packed_{name}")
        w8 = getattr(ffn, f"ternary_{name}")
        M, K = a.shape
        N = packed.shape[1]
        got = drive(f"bitnet_gemm {label}", lambda: bn.bitnet_gemm(
            a, packed), {"bitnet_gemm": 1}, main=False)
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
        res[f"bitnet_gemm_{label}"] = {
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
    del q_in, q_h, q_dec

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
        del out, leaves, o_plain, dq, dk, dv
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
                       "KV",
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
    ("bitnet_gemm", "bitnet_gemm.cu", "tilelang_mesh_tpu/ops/bitnet.py:51",
     "prefill_gate_up"))


def kernel_registers(log):
    """{kernel: [registers, spill-store bytes]} from ``nvcc -Xptxas -v``
    output; a kernel is named by its function and its template
    arguments (``matmul_bf16<1,0>``)."""
    import re
    args = {"f": "f32", "13__nv_bfloat16": "bf16", "6__half": "f16",
            "h": "u8", "a": "s8"}
    out, name, spill = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"entry function '_Z\w*?_cu_[0-9a-f]{8}(\d+)(\w+)'",
                      line)
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
    from tilelang_mesh_tpu_torch.ops import flash_attention as fa
    from tilelang_mesh_tpu_torch.ops import flash_decoding as fd
    from tilelang_mesh_tpu_torch.ops import gemm as gm
    from tilelang_mesh_tpu_torch.ops import gemm_variants as gv
    from tilelang_mesh_tpu_torch.ops import gqa_bwd as gb
    from tilelang_mesh_tpu_torch.ops import gdn as gd
    from tilelang_mesh_tpu_torch.ops import grouped_gemm as gg
    from tilelang_mesh_tpu_torch.ops import mamba2 as m2
    from tilelang_mesh_tpu_torch.ops import mla
    from tilelang_mesh_tpu_torch.ops import quantize_act as qa
    gq = importlib.import_module("tilelang_mesh_tpu_torch.ops.gqa")
    la = importlib.import_module(
        "tilelang_mesh_tpu_torch.ops.linear_attention")

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
               "gemv", "quantize_act", "bitnet_gemm")
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
    mla32 = mla_kernel_phase(torch, mla, torch.float32)
    mla16 = mla_kernel_phase(torch, mla, torch.bfloat16)
    attn32 = attention_phase(torch, fa, gb, torch.float32)
    attn16 = attention_phase(torch, fa, gb, torch.bfloat16)
    gemm32 = gemm_phase(torch, gg, torch.float32)
    gemm16 = gemm_phase(torch, gg, torch.bfloat16)

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
                                       "bound_ms", "library_ms")}})
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
    # the layer's first expert product; the second in "w2"
    kernels.append({
        "name": "grouped_gemm", "route": "cuda",
        "source": csrc + "grouped_gemm.cu",
        "replaces": "tilelang_mesh_tpu/ops/grouped_gemm.py:17",
        "launches": moe_res["launches"]["grouped_gemm"],
        **{k: gemm32["w1"][k] for k in keys + ("bound_by",)},
        "bf16": {k: gemm16["w1"][k] for k in keys},
        "w2": {"float32": {k: gemm32["w2"][k] for k in keys},
               "bfloat16": {k: gemm16["w2"][k] for k in keys}}})
    # not on the MoE path; held on its routed counts
    kernels.append({
        "name": "varlen_grouped_gemm", "route": "cuda",
        "source": csrc + "grouped_gemm.cu",
        "replaces": "tilelang_mesh_tpu/ops/grouped_gemm.py:58",
        "launches": moe_res["launches"]["varlen_grouped_gemm"],
        **{k: gemm32["varlen"][k] for k in keys + ("bound_by",)},
        "bmm_padded_ms": gemm32["varlen"]["bmm_padded_ms"],
        "bf16": {k: gemm16["varlen"][k] for k in keys},
        "trans_b": {"float32": {k: gemm32["varlen_trans"][k] for k in keys},
                    "bfloat16": {k: gemm16["varlen_trans"][k]
                                 for k in keys}}})
    kernels += kernel_entries(gops, GEMM_OPS_KERNELS)
    for entry in kernel_entries(seq, SEQMIX_KERNELS):
        entry["library"] = SEQMIX_LIBRARY
        if entry["name"] == "linear_attention":
            entry["backward"] = seq["linear_attention_backward"]
        kernels.append(entry)
    for entry in kernel_entries(var, VARIANT_KERNELS):
        fixup = VARIANT_FIXUPS.get(entry["name"])
        if fixup:
            entry["fixup"] = {"name": fixup,
                              "launches": var["launches"][fixup]}
        kernels.append(entry)
    kernels += kernel_entries(bg, BITNET_GQA_KERNELS)
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
