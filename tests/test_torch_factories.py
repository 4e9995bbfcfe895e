"""The port's kernel factories against the JAX package's.

Each JAX factory (``decode_kernel(B, H, S, D, ...)`` and the like)
returns a kernel bound to one shape and type; the port's factory of the
same name takes the same argument list and returns ``fn(*operands)`` on
its ops. Each test calls both factories with one argument list, the
bound kernels with the same numpy-seeded operands, and compares the
results at the op's reference tolerance: 2e-2 for attention, decode and
the sequence-mixing forwards (tests/test_flash_attention.py:30,
tests/test_decoding.py:25, tests/test_mamba2.py:23, tests/test_gdn.py),
rtol 2e-2 / atol 2e-1 for linear attention (tests/test_linear_attention)
and w4a16's GEMM (tests/test_quantize.py:48), 3e-2 / 3e-1 for the
attention backward (tests/test_flash_bwd.py:34), 1e-4 normwise for the
float32 grouped GEMMs and 1e-5 for w4a8 (tests/test_w4a8.py:40); the
int4 unpack is value for value. The JAX kernels run in Pallas interpret
mode on the CPU; the port's on CPU tensors (the plain versions).
"""

import importlib
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tilelang_mesh_tpu.ops import bitnet as ref_bitnet
from tilelang_mesh_tpu.ops import dequant_gemm as ref_dq
from tilelang_mesh_tpu.ops import dsa as ref_dsa
from tilelang_mesh_tpu.ops import flash_decoding as ref_fd
from tilelang_mesh_tpu.ops import gdn as ref_gdn
from tilelang_mesh_tpu.ops import grouped_gemm as ref_gg
from tilelang_mesh_tpu.ops import mamba2 as ref_m2
from tilelang_mesh_tpu.ops import mla as ref_mla
from tilelang_mesh_tpu.quantize import quantization as ref_q
from tilelang_mesh_tpu_torch import ops as port_ops
from tilelang_mesh_tpu_torch.ops import dequant_gemm as port_dq
from tilelang_mesh_tpu_torch.ops import dsa as port_dsa
from tilelang_mesh_tpu_torch.ops import flash_decoding as port_fd
from tilelang_mesh_tpu_torch.ops import gdn as port_gdn
from tilelang_mesh_tpu_torch.ops import grouped_gemm as port_gg
from tilelang_mesh_tpu_torch.ops import mamba2 as port_m2
from tilelang_mesh_tpu_torch.ops import mla as port_mla

# modules the packages' ops/__init__ shadow with functions
ref_la = importlib.import_module("tilelang_mesh_tpu.ops.linear_attention")
port_la = importlib.import_module(
    "tilelang_mesh_tpu_torch.ops.linear_attention")
ref_fab = importlib.import_module(
    "tilelang_mesh_tpu.ops.flash_attention_bwd")
ref_gb = importlib.import_module("tilelang_mesh_tpu.ops.gqa_bwd")
ref_gqa = importlib.import_module("tilelang_mesh_tpu.ops.gqa")
port_fab = importlib.import_module(
    "tilelang_mesh_tpu_torch.ops.flash_attention_bwd")
port_gb = importlib.import_module("tilelang_mesh_tpu_torch.ops.gqa_bwd")


def _rand(rng, *shapes, scale=1.0):
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in shapes]


def _run(ref_kernel, port_kernel, *operands):
    """Both bound kernels on the same operands (numpy arrays): the JAX
    results and the port's, each as a tuple of float64 numpy arrays."""
    want = ref_kernel(*(jnp.asarray(a) for a in operands))
    got = port_kernel(*(torch.from_numpy(np.array(a)) for a in operands))
    as_tuple = (lambda r: tuple(r) if isinstance(r, (tuple, list))
                else (r,))
    return ([np.asarray(w, np.float64) for w in as_tuple(want)],
            [g.double().numpy() for g in as_tuple(got)])


def _close(want, got, rtol=2e-2, atol=2e-2):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert w.shape == g.shape
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def _normwise(want, got, tol):
    for w, g in zip(want, got):
        assert w.shape == g.shape
        assert np.abs(g - w).max() <= tol * np.abs(w).max()


# ------------------------------------------------------------- GEMMs ----

def test_grouped_gemm_kernel():
    args = (2, 64, 64, 128, 64, 64, 128, "float32")
    x, w = _rand(np.random.default_rng(0), (2, 64, 128), (2, 128, 64))
    want, got = _run(ref_gg.grouped_gemm_kernel(*args),
                     port_gg.grouped_gemm_kernel(*args), x, w)
    _normwise(want, got, 1e-4)
    assert port_ops.grouped_gemm_kernel is port_gg.grouped_gemm_kernel
    with pytest.raises(ValueError):        # bound to its shape
        port_gg.grouped_gemm_kernel(*args)(torch.zeros(2, 64, 64),
                                          torch.zeros(2, 64, 64))


@pytest.mark.parametrize("trans_b", [False, True])
def test_varlen_grouped_gemm_kernel(trans_b):
    """The block-padded output, pad rows included (each block's rows past
    its group times the block's expert), from the JAX wrapper's own
    tables and padding."""
    sizes, bm, K, N = (130, 0, 64), 64, 128, 64
    exp_blk, row_blk, _ = ref_gg._varlen_meta(sizes, bm)
    rng = np.random.default_rng(1)
    a, b = _rand(rng, (sum(sizes), K), (3, N, K) if trans_b else (3, K, N))
    a_pad = np.concatenate([a, np.zeros((bm, K), np.float32)])
    args = (a_pad.shape[0], len(exp_blk), 3, K, N, bm, 64, 128, "float32",
            trans_b)
    want, got = _run(ref_gg.varlen_grouped_gemm_kernel(*args),
                     port_gg.varlen_grouped_gemm_kernel(*args), a_pad, b,
                     exp_blk, row_blk)
    _normwise(want, got, 1e-4)


def test_dequant_int4_kernel():
    w = np.random.default_rng(2).standard_normal((256, 128)).astype(
        np.float32)
    packed, scales = ref_q.quantize_int4_planar(w, 64)
    scales = np.asarray(scales).reshape(2, 2, 128)
    for dtype in ("float32", "bfloat16"):
        args = (128, 128, 64, 128, dtype)
        want, got = _run(ref_dq.dequant_int4_kernel(*args),
                         port_dq.dequant_int4_kernel(*args),
                         np.asarray(packed), scales)
        np.testing.assert_array_equal(got[0], want[0])


def test_w4a8_gemm_kernel():
    """bench.py:1483's call, on quantize_w4_per_channel's weights and
    quantize_activations' codes."""
    rng = np.random.default_rng(3)
    x, w = _rand(rng, (16, 256), (256, 128))
    packed, sw = ref_dq.quantize_w4_per_channel(jnp.asarray(w))
    q, a_scale = ref_bitnet.quantize_activations(jnp.asarray(x))
    operands = (np.asarray(q).reshape(16, 2, 128), np.asarray(packed),
                np.asarray(sw, np.float32).reshape(1, 128),
                np.asarray(1.0 / a_scale, np.float32))
    args = (16, 128, 256, 16, 128, 128, 2)
    want, got = _run(ref_dq.w4a8_gemm_kernel(*args),
                     port_dq.w4a8_gemm_kernel(*args), *operands)
    _normwise(want, got, 1e-5)


# ------------------------------------------------------------ decode ----

def test_decode_kernel():
    B, H, S, D = 2, 4, 256, 32
    q, k, v = _rand(np.random.default_rng(4), (B, H, 1, D), (B, H, S, D),
                    (B, H, S, D))
    args = (B, H, S, D, 2, 64, 1 / math.sqrt(D), "float32")
    want, got = _run(ref_fd.decode_kernel(*args),
                     port_fd.decode_kernel(*args), q, k, v)
    _close(want, got)


def test_paged_decode_kernel():
    B, H, PP, PS, D, n_pages = 2, 4, 4, 32, 32, 8
    rng = np.random.default_rng(5)
    q, kp, vp = _rand(rng, (B, H, 1, D), (H, n_pages * PS, D),
                      (H, n_pages * PS, D))
    tab = rng.permutation(n_pages).reshape(B, PP).astype(np.int32)
    args = (B, H, PP, PS, D, 2, n_pages * PS, 1 / math.sqrt(D), "float32")
    want, got = _run(ref_fd.paged_decode_kernel(*args),
                     port_fd.paged_decode_kernel(*args), q, kp, vp, tab)
    _close(want, got)


def test_mla_decode_kernel():
    B, H, S, dc, dr = 2, 4, 128, 64, 16
    operands = _rand(np.random.default_rng(6), (B, H, dc), (B, H, dr),
                     (B, S, dc), (B, S, dr))
    args = (B, H, S, dc, dr, 2, 32, 1 / math.sqrt(dc + dr), "float32")
    want, got = _run(ref_mla.mla_decode_kernel(*args),
                     port_mla.mla_decode_kernel(*args), *operands)
    _close(want, got)


# ---------------------------------------------------------- backward ----

@pytest.mark.parametrize("Hkv", [2, 1])
def test_attention_bwd_kernels(Hkv):
    """mha_bwd_* (Hkv = H) and gqa_bwd_*, on lse2 and delta from the JAX
    partial forward, as its backward feeds them."""
    B, H, S, D, causal = 1, 2, 128, 32, True
    sm = 1 / math.sqrt(D)
    rng = np.random.default_rng(7)
    q, k, v, do = _rand(rng, (B, H, S, D), (B, Hkv, S, D), (B, Hkv, S, D),
                        (B, H, S, D))
    acc, m, l = ref_gqa.gqa_fwd_partial_kernel(
        B, H, Hkv, S, S, D, 64, 64, causal, sm, "float32")(
            *map(jnp.asarray, (q, k, v)))
    o = np.asarray(acc / l[..., None])
    lse2 = np.asarray(m + jnp.log2(l), np.float32)
    delta = (do * o).sum(-1).astype(np.float32)
    operands = (q, k, v, do, lse2, delta)
    if Hkv == H:
        args = (B, H, S, S, D, 64, 64, causal, sm, "float32")
        pairs = [(ref_fab.mha_bwd_dkdv_kernel, port_fab.mha_bwd_dkdv_kernel),
                 (ref_fab.mha_bwd_dq_kernel, port_fab.mha_bwd_dq_kernel)]
    else:
        args = (B, H, Hkv, S, S, D, 64, 64, causal, sm, "float32")
        pairs = [(ref_gb.gqa_bwd_dkdv_kernel, port_gb.gqa_bwd_dkdv_kernel),
                 (ref_gb.gqa_bwd_dq_kernel, port_gb.gqa_bwd_dq_kernel)]
    for ref_f, port_f in pairs:
        want, got = _run(ref_f(*args), port_f(*args), *operands)
        _close(want, got, rtol=3e-2, atol=3e-1)


# ----------------------------------------------------- sequence mixing ----

def test_mamba2_chunk_scan_kernel():
    """The factory's head-major layout, and the eager baseline under its
    JAX name."""
    B, S, H, P, N, chunk = 1, 128, 2, 16, 16, 64
    rng = np.random.default_rng(8)
    x, bm, cm = _rand(rng, (B, H, S, P), (B, S, N), (B, S, N), scale=0.5)
    dt = rng.uniform(0.01, 0.1, (B, H, S)).astype(np.float32)
    a = (-rng.uniform(0.5, 1.5, (H,))).astype(np.float32)
    args = (B, S, H, P, N, chunk, "float32")
    want, got = _run(ref_m2.mamba2_chunk_scan_kernel(*args),
                     port_m2.mamba2_chunk_scan_kernel(*args), x, dt, a, bm,
                     cm)
    _close(want, got)
    xs, dts = x.transpose(0, 2, 1, 3), dt.transpose(0, 2, 1)
    want, got = _run(lambda *o: ref_m2.mamba2_chunk_scan_xla(*o, chunk=64),
                     lambda *o: port_m2.mamba2_chunk_scan_xla(*o, chunk=64),
                     xs, dts, a, bm, cm)
    _normwise(want, got, 1e-4)


def test_gdn_chunk_fwd_kernel():
    B, H, T, K, V, chunk = 1, 2, 128, 32, 32, 64
    rng = np.random.default_rng(9)
    q, k, v = _rand(rng, (B, H, T, K), (B, H, T, K), (B, H, T, V))
    k /= np.linalg.norm(k, axis=-1, keepdims=True)
    g = rng.uniform(-0.2, 0.0, (B, H, T)).astype(np.float32)
    beta = rng.uniform(0.0, 1.0, (B, H, T)).astype(np.float32)
    args = (B, H, T, K, V, chunk, 1 / math.sqrt(K), "float32")
    want, got = _run(ref_gdn.gdn_chunk_fwd_kernel(*args),
                     port_gdn.gdn_chunk_fwd_kernel(*args), q, k, v, g, beta)
    _close(want, got)


def test_linear_attention_and_retention_kernels():
    B, H, S, DK, DV, chunk = 1, 2, 128, 32, 32, 64
    rng = np.random.default_rng(10)
    q, k, v = _rand(rng, (B, H, S, DK), (B, H, S, DK), (B, H, S, DV),
                    scale=0.5)
    args = (B, H, S, DK, DV, chunk, "float32")
    want, got = _run(ref_la.linear_attention_kernel(*args),
                     port_la.linear_attention_kernel(*args), q, k, v)
    _close(want, got, atol=2e-1)
    gamma = np.array([0.9, 0.97], np.float32)
    want, got = _run(ref_la.retention_kernel(*args),
                     port_la.retention_kernel(*args), q, k, v, gamma)
    _close(want, got)


# ------------------------------------------------------------------ DSA ----

def test_dsa_kernels():
    """lightning_indexer_kernel, topk_selector_kernel and
    sparse_mla_fwd_kernel called as ops/dsa.py's wrappers call them, on
    the same operands: the logits at 1e-3 (tests/test_dsa.py:35), the ids
    equal, O 2e-2 and LSE 1e-3 (tests/test_dsa.py:57); each refuses
    operands of another shape or type."""
    B, S, Skv, HI, DI, H, D, DT, topk = 1, 32, 64, 2, 32, 4, 128, 64, 16
    rng = np.random.default_rng(11)
    qi, ki, w = _rand(rng, (B, S, HI, DI), (B, Skv, DI), (B, S, HI))
    args = (B, S, Skv, HI, DI, 32, Skv - S, "float32")
    want, got = _run(ref_dsa.lightning_indexer_kernel(*args),
                     port_dsa.lightning_indexer_kernel(*args), qi, ki, w)
    _close(want, got, rtol=1e-3, atol=1e-3)
    logits = np.asarray(want[0], np.float32)
    args = (B, S, Skv, topk, 32)
    want, got = _run(ref_dsa.topk_selector_kernel(*args),
                     port_dsa.topk_selector_kernel(*args), logits)
    np.testing.assert_array_equal(got[0], want[0])
    ind = want[0].astype(np.int32)
    q, kv = _rand(rng, (B, S, H, D + DT), (B, Skv, D + DT))
    args = (B, S, Skv, H, D, DT, topk, 16, Skv - S, 1 / math.sqrt(D + DT),
            "float32")
    want, got = _run(ref_dsa.sparse_mla_fwd_kernel(*args),
                     port_dsa.sparse_mla_fwd_kernel(*args), q, kv, ind)
    _close(want[:1], got[:1])
    _close(want[1:], got[1:], rtol=1e-3, atol=1e-3)
    for fn, ops in (
            (port_dsa.lightning_indexer_kernel(B, S, Skv, HI, DI, 32,
                                               Skv - S, "float32"),
             (torch.zeros(B, S, HI, DI), torch.zeros(B, Skv + 1, DI),
              torch.zeros(B, S, HI))),
            (port_dsa.topk_selector_kernel(B, S, Skv, topk, 32),
             (torch.zeros(B, S, Skv, dtype=torch.float64),)),
            (port_dsa.sparse_mla_fwd_kernel(*args),
             (torch.zeros(B, S, H, D + DT), torch.zeros(B, Skv, D + DT),
              torch.zeros(B, S, topk, dtype=torch.int64)))):
        with pytest.raises(ValueError):
            fn(*ops)
    for name in ("lightning_indexer_kernel", "topk_selector_kernel",
                 "sparse_mla_fwd_kernel"):
        assert getattr(port_ops, name) is getattr(port_dsa, name)
