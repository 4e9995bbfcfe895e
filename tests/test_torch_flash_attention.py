"""The port's attention (tilelang_mesh_tpu_torch/ops/flash_attention.py,
gqa_bwd.py) against the JAX package's on the same numpy-seeded inputs.

The JAX side runs as tests/test_flash_bwd.py runs it (Pallas interpret
mode on the CPU); the port side runs on CPU tensors, i.e. each kernel's
plain PyTorch version. Tolerances: 2e-2 for forward values against the
interpret-mode kernels (tests/test_model.py:37, which absorbs the
interpreter's bf16-like MXU emulation of f32 products); rtol 3e-2 /
atol 3e-1 for gradients (tests/test_flash_bwd.py:34); 1e-5 where the
port's kernel path is held against torch autograd through its own dense
reference, both exact float32 on the CPU (the two differ only in the
order of the sums). The CUDA kernels themselves are held against the
plain versions by tests/test_torch_cuda.py on the card.
"""

import importlib
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tilelang_mesh_tpu.ops.gqa_bwd import gqa_attention_bwd as ref_gqa_bwd
from tilelang_mesh_tpu_torch.ops import gqa_bwd as port_bwd

# the modules, not the functions of the same name the packages re-export
ref = importlib.import_module("tilelang_mesh_tpu.ops.flash_attention")
port = importlib.import_module("tilelang_mesh_tpu_torch.ops.flash_attention")

TOL = 2e-2


def _arrays(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _t(*arrays, grad=False):
    return [torch.from_numpy(a.copy()).requires_grad_(grad) for a in arrays]


# the shapes of tests/test_flash_bwd.py:16 and :38
SQUARE = (1, 2, 256, 256, 64)
RECT = (1, 1, 128, 384, 64)


def _qkv(shape, seed=0):
    B, H, Sq, Sk, D = shape
    return _arrays([(B, H, Sq, D), (B, H, Sk, D), (B, H, Sk, D),
                    (B, H, Sq, D)], seed)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [SQUARE, RECT])
def test_forward_matches_reference(shape, causal):
    q, k, v, _ = _qkv(shape)
    want = np.asarray(ref.flash_attention(*map(jnp.asarray, (q, k, v)),
                                          causal=causal))
    got = port.flash_attention(*_t(q, k, v), causal=causal)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [SQUARE, RECT])
def test_partials_match_reference(shape, causal):
    """(acc, m, l) in the exp2 domain, the -1e30 floor included."""
    q, k, v, _ = _qkv(shape, seed=1)
    scale = 1.0 / math.sqrt(q.shape[-1])
    want = ref.flash_attention_partial(*map(jnp.asarray, (q, k, v)),
                                       causal, scale)
    got = port.flash_attention_partial(*_t(q, k, v), causal, scale)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)


def test_forward_kernel_and_partial_plain_agree():
    """Kernel #1's plain version is kernel #2's normalised with the
    clamped divide; the bound kernel checks its shape."""
    q, k, v, _ = _qkv(RECT, seed=2)
    qt, kt, vt = _t(q, k, v)
    acc, m, l = port.mha_fwd_partial_plain(qt, kt, vt, True, 0.125)
    o = port.mha_fwd_kernel(1, 1, 128, 384, 64, causal=True,
                            sm_scale=0.125, dtype=torch.float32)(qt, kt, vt)
    torch.testing.assert_close(o, acc / l[..., None], rtol=1e-6, atol=1e-6)
    assert bool((m > -1e30).all()) and bool((l >= 1).all())
    with pytest.raises(ValueError):
        port.mha_fwd_kernel(1, 1, 128, 128, 64)(qt, kt, vt)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [SQUARE, RECT])
def test_grads_match_jax_kernel_path(shape, causal):
    """dQ, dK, dV of the autograd Function against jax.grad through the
    JAX kernel path (partial forward + dK/dV and dQ kernels)."""
    q, k, v, g = _qkv(shape, seed=3)

    def loss(q, k, v):
        return jnp.vdot(ref.flash_attention(q, k, v, causal=causal), g)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    qt, kt, vt = _t(q, k, v, grad=True)
    port.flash_attention(qt, kt, vt, causal=causal).backward(
        torch.from_numpy(g))
    for t, w in zip((qt, kt, vt), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   rtol=3e-2, atol=3e-1)


@pytest.mark.parametrize("backward", ["kernel", "reference"])
@pytest.mark.parametrize("causal", [False, True])
def test_grads_match_dense_autograd(causal, backward):
    """Both backward modes against torch autograd through the dense
    reference, float32 on the CPU: the same function, sums in another
    order."""
    q, k, v, g = _qkv((2, 2, 96, 96, 32), seed=4)
    gt = torch.from_numpy(g)
    got = _t(q, k, v, grad=True)
    port.flash_attention(*got, causal=causal, backward=backward).backward(gt)
    want = _t(q, k, v, grad=True)
    port._reference_attention(*want, causal, 1.0 / math.sqrt(32)).backward(gt)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-5)


def test_no_grad_runs_the_forward_kernel_path():
    q, k, v, _ = _qkv((1, 2, 40, 40, 16), seed=5)
    qt, kt, vt = _t(q, k, v, grad=True)
    with torch.no_grad():
        o = port.flash_attention(qt, kt, vt, causal=True)
    assert o.grad_fn is None
    torch.testing.assert_close(o, port.mha_fwd_plain(qt, kt, vt, True, 0.25))
    with pytest.raises(ValueError):
        port.flash_attention(qt, kt, vt, backward="nope")


@pytest.mark.parametrize("causal", [False, True])
def test_gqa_attention_bwd_matches_reference(causal):
    """Hq = 4 query heads over Hkv = 2 KV heads, from the same o, lse2
    and incoming gradient."""
    B, Hq, Hkv, S, D = 1, 4, 2, 128, 32
    q, g = _arrays([(B, Hq, S, D)] * 2, seed=6)
    k, v = _arrays([(B, Hkv, S, D)] * 2, seed=7)
    scale = 1.0 / math.sqrt(D)
    # o and lse2 of the grouped forward, from the dense plain version
    kk, vv = (np.repeat(a, Hq // Hkv, axis=1) for a in (k, v))
    acc, m, l = port.mha_fwd_partial_plain(*_t(q, kk, vv), causal, scale)
    o = (acc / l[..., None]).numpy()
    lse2 = (m + torch.log2(l)).numpy()
    want = ref_gqa_bwd(*map(jnp.asarray, (q, k, v, o, lse2, g)), causal,
                       scale)
    got = port_bwd.gqa_attention_bwd(*_t(q, k, v, o, lse2, g), causal, scale)
    for a, w in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=3e-2,
                                   atol=3e-1)
    # and exactly what the MHA backward gives on the repeated KV heads,
    # with each KV head's gradient summed over its query heads
    dq, dk, dv = port_bwd.gqa_attention_bwd(*_t(q, kk, vv, o, lse2, g),
                                            causal, scale)
    torch.testing.assert_close(got[0], dq, rtol=1e-6, atol=1e-6)
    for a, b in ((got[1], dk), (got[2], dv)):
        torch.testing.assert_close(a, b.view(B, Hkv, 2, S, D).sum(2),
                                   rtol=1e-5, atol=1e-5)


def test_bf16_plain_rounds_where_the_kernel_rounds():
    """bfloat16 inputs: the output is bfloat16, within bf16 rounding of
    the float32 result; the backward outputs follow the input type."""
    q, k, v, g = _qkv((1, 2, 64, 64, 16), seed=8)
    f32 = port.mha_fwd_plain(*_t(q, k, v), True, 0.25)
    bf = [t.to(torch.bfloat16) for t in _t(q, k, v)]
    out = port.mha_fwd_plain(*bf, True, 0.25)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), f32, rtol=3e-2, atol=3e-2)
    leaves = [t.requires_grad_() for t in bf]
    port.flash_attention(*leaves, causal=True).backward(
        torch.from_numpy(g).to(torch.bfloat16))
    assert all(t.grad.dtype == torch.bfloat16 for t in leaves)


def test_wrappers_reject_what_the_kernels_do_not_take():
    q, k, v, _ = _qkv((1, 2, 16, 16, 16))
    qt, kt, vt = _t(q, k, v)
    with pytest.raises(TypeError):
        port.mha_fwd(qt.double(), kt.double(), vt.double(), True, 0.25)
    with pytest.raises(ValueError):
        port.mha_fwd(qt, kt[:, :1], vt[:, :1], True, 0.25)
    with pytest.raises(ValueError):
        port.mha_fwd(qt[:, :, :0], kt, vt, True, 0.25)
    lse2 = torch.zeros(1, 2, 16)
    with pytest.raises(ValueError):
        port_bwd.gqa_bwd_dq(qt, kt, vt, qt, lse2.double(), lse2, True, 0.25)
    with pytest.raises(ValueError):   # 2 query heads over 3 KV heads
        port_bwd.gqa_bwd_dq(qt, torch.zeros(1, 3, 16, 16),
                            torch.zeros(1, 3, 16, 16), qt, lse2, lse2, True,
                            0.25)


# the three calls of mha_fwd_kernel the JAX package's users make: the
# example's (examples/flash_attention/example_mha_fwd.py:22), the
# factory's positional order, and bench.py:1275's keywords. S is 128:
# the JAX factory does not clamp its default 128-row tiles, and gives
# NaN for a shorter sequence.
_MHA_CALLS = {
    "example": ((1, 2, 128, 128, 32), dict(causal=True, dtype="float32")),
    "positional": ((1, 2, 128, 128, 32, 64, 64, True, None, "float32", 2),
                   {}),
    "bench": ((1, 2, 128, 128, 32), dict(block_M=64, block_N=64,
                                         causal=True, sm_scale=0.2,
                                         dtype="bfloat16", num_stages=2)),
}


@pytest.mark.parametrize("form", sorted(_MHA_CALLS))
def test_mha_fwd_kernel_takes_the_jax_calls(form):
    """The bound kernel takes JAX's argument list (tile hints, a dtype
    by name) and returns O within 2e-2 of the JAX kernel's."""
    args, kw = _MHA_CALLS[form]
    dtype = kw.get("dtype", args[9] if len(args) > 9 else None)
    q, k, v = _arrays([(1, 2, 128, 32)] * 3, seed=31)
    jt = getattr(jnp, dtype)
    want = ref.mha_fwd_kernel(*args, **kw)(*(jnp.asarray(a, jt)
                                             for a in (q, k, v)))
    tt = getattr(torch, dtype)
    got = port.mha_fwd_kernel(*args, **kw)(*(t.to(tt)
                                             for t in _t(q, k, v)))
    assert got.dtype == tt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=TOL,
                               atol=TOL)


def test_mha_entry_points_take_the_jax_keywords():
    """flash_attention, flash_attention_partial, flash_attention_bwd and
    gqa_attention_bwd take the JAX package's tile hints, by keyword and
    in its positional order, and compute what they compute without."""
    from tilelang_mesh_tpu_torch import ops as port_ops
    from tilelang_mesh_tpu_torch.ops.flash_attention_bwd import \
        flash_attention_bwd
    q, k, v, g = _t(*_qkv((1, 2, 64, 64, 32), seed=32))
    base = port.flash_attention(q, k, v, True)
    torch.testing.assert_close(
        port.flash_attention(q, k, v, True, None, 64, 64, 2), base)
    torch.testing.assert_close(
        port.flash_attention(q, k, v, causal=True, block_M=32, block_N=16,
                             num_stages=3), base)
    acc, m, l = port.flash_attention_partial(q, k, v, True, 0.25, 32, 32, 2)
    want = port.flash_attention_partial(q, k, v, True, 0.25)
    for a, b in zip((acc, m, l), want):
        torch.testing.assert_close(a, b)
    lse2 = m + torch.log2(l)
    o = (acc / l[..., None]).to(q.dtype)
    grads = port_bwd.gqa_attention_bwd(q, k, v, o, lse2, g, True, 0.25)
    for got in (flash_attention_bwd(q, k, v, o, lse2, g, True, 0.25, 32,
                                    32),
                port_bwd.gqa_attention_bwd(q, k, v, o, lse2, g, True, 0.25,
                                           block_M=32, block_N=64)):
        for a, b in zip(got, grads):
            torch.testing.assert_close(a, b)
    # exported beside the function of the same name, as the JAX package
    # exports them
    assert port_ops.mha_fwd_kernel is port.mha_fwd_kernel
    assert port_ops.flash_attention_partial is port.flash_attention_partial
    assert port_ops.flash_attention_bwd is flash_attention_bwd
