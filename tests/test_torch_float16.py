"""float16 through the port's attention, decode and grouped / low-bit
GEMM ops, against the JAX package's float16 results on the same inputs.

The JAX package computes each of these ops in float16 (Pallas interpret
mode on the CPU); the port runs the same inputs through its plain
versions on CPU tensors, which round P and the outputs to float16 where
the kernels do. Inputs are ``np.random.default_rng(0)`` standard normal
values rounded to float16 once, so both sides see the same numbers.
Tolerances are each op's reference test's: 2e-2 for attention and decode
(tests/test_flash_attention.py:30, tests/test_decoding.py:25), rtol 2e-2
/ atol 2e-1 for the grouped GEMM (tests/test_parallel_ops.py:21) and
w4a16 (tests/test_quantize.py:48). The card kernels are held against
these plain versions in float16 by tests/test_torch_cuda.py.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tilelang_mesh_tpu.ops import dequant_gemm as ref_dq
from tilelang_mesh_tpu.ops import flash_decoding as ref_fd
from tilelang_mesh_tpu.ops import grouped_gemm as ref_gg
from tilelang_mesh_tpu.ops import mla as ref_mla
from tilelang_mesh_tpu.quantize import quantization as ref_q
from tilelang_mesh_tpu_torch.ops import dequant_gemm as port_dq
from tilelang_mesh_tpu_torch.ops import flash_decoding as port_fd
from tilelang_mesh_tpu_torch.ops import grouped_gemm as port_gg
from tilelang_mesh_tpu_torch.ops import mla as port_mla


def _mods(name):
    """(JAX module, port module) of ``ops/<name>.py`` (the packages'
    ``ops/__init__`` shadow some modules with their functions)."""
    return (importlib.import_module(f"tilelang_mesh_tpu.ops.{name}"),
            importlib.import_module(f"tilelang_mesh_tpu_torch.ops.{name}"))


def _f16(rng, *shapes):
    return [rng.standard_normal(s).astype(np.float16) for s in shapes]


def _both(*arrays):
    """Each float16 array as a JAX array and a torch tensor."""
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.array(a)) for a in arrays])


def _close(got, want, rtol=2e-2, atol=2e-2):
    assert got.dtype == torch.float16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


QKV = [(1, 2, 128, 32)] * 3


def test_flash_attention_float16():
    ref, port = _mods("flash_attention")
    (jq, jk, jv), (tq, tk, tv) = _both(*_f16(np.random.default_rng(0),
                                             *QKV))
    want = ref.flash_attention(jq, jk, jv, causal=True, block_M=64,
                               block_N=64)
    _close(port.flash_attention(tq, tk, tv, causal=True, block_M=64,
                                block_N=64), want)


def test_gqa_attention_float16():
    ref, port = _mods("gqa")
    (jq, jk, jv), (tq, tk, tv) = _both(*_f16(
        np.random.default_rng(0), (1, 2, 128, 32), (1, 1, 128, 32),
        (1, 1, 128, 32)))
    want = ref.gqa_attention(jq, jk, jv, causal=True, block_M=64,
                             block_N=64)
    _close(port.gqa_attention(tq, tk, tv, causal=True, block_M=64,
                              block_N=64), want)


def test_flash_attention_varlen_float16():
    ref, port = _mods("flash_attention_varlen")
    cu = np.array([0, 40, 128], np.int32)
    (jq, jk, jv), (tq, tk, tv) = _both(*_f16(np.random.default_rng(0),
                                             *[(128, 2, 32)] * 3))
    want = ref.flash_attention_varlen(jq, jk, jv, cu, cu, causal=True,
                                      block_M=64, block_N=64)
    _close(port.flash_attention_varlen(tq, tk, tv, cu, cu, causal=True,
                                       block_M=64, block_N=64), want)


def test_attention_sink_float16():
    ref, port = _mods("attention_sink")
    rng = np.random.default_rng(0)
    (jq, jk, jv), (tq, tk, tv) = _both(*_f16(rng, *QKV))
    sinks = rng.standard_normal(2).astype(np.float32)
    want = ref.attention_sink(jq, jk, jv, jnp.asarray(sinks), causal=True,
                              block_M=64, block_N=64)
    _close(port.attention_sink(tq, tk, tv, torch.from_numpy(sinks),
                               causal=True, block_M=64, block_N=64), want)


def test_blocksparse_attention_float16():
    ref, port = _mods("blocksparse_attention")
    (jq, jk, jv), (tq, tk, tv) = _both(*_f16(np.random.default_rng(0),
                                             *QKV))
    mask = np.array([[1, 0], [1, 1]], np.int32)[None, None].repeat(2, 1)
    want = ref.blocksparse_attention(jq, jk, jv, jnp.asarray(mask),
                                     block_M=64, block_N=64)
    _close(port.blocksparse_attention(tq, tk, tv, torch.from_numpy(mask),
                                      block_M=64, block_N=64), want)


def test_flash_decode_float16():
    (jq, jk, jv), (tq, tk, tv) = _both(*_f16(
        np.random.default_rng(0), (2, 4, 1, 32), (2, 4, 256, 32),
        (2, 4, 256, 32)))
    want = ref_fd.flash_decode(jq, jk, jv)
    _close(port_fd.flash_decode(tq, tk, tv), want)


def test_mla_decode_float16():
    (jqc, jqr, jc, jk), (tqc, tqr, tc, tk) = _both(*_f16(
        np.random.default_rng(0), (2, 4, 64), (2, 4, 16), (2, 128, 64),
        (2, 128, 16)))
    want = ref_mla.mla_decode(jqc, jqr, jc, jk)
    _close(port_mla.mla_decode(tqc, tqr, tc, tk), want)


def test_grouped_matmul_float16():
    (jx, jw), (tx, tw) = _both(*_f16(np.random.default_rng(0),
                                     (2, 64, 64), (2, 64, 64)))
    want = ref_gg.grouped_matmul(jx, jw)
    _close(port_gg.grouped_matmul(tx, tw), want, atol=2e-1)


@pytest.mark.parametrize("twopass", [False, True])
def test_dequant_matmul_float16(twopass):
    rng = np.random.default_rng(0)
    (ja,), (ta,) = _both(*_f16(rng, (64, 256)))
    w = rng.standard_normal((256, 128)).astype(np.float32)
    packed, scales = ref_q.quantize_int4_planar(w, 64)
    jw = (jnp.asarray(packed), jnp.asarray(scales))
    if twopass:
        want = ref_dq.dequant_matmul_twopass(ja, *jw, dq_block=64)
        got = port_dq.dequant_matmul_twopass(ta, packed, scales,
                                             dq_block=64)
    else:
        want = ref_dq.dequant_matmul(ja, *jw, group_size=64, block_K2=64)
        got = port_dq.dequant_matmul(ta, packed, scales, group_size=64,
                                     block_K2=64)
    _close(got, want, atol=2e-1)
