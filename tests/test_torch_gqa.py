"""The port's grouped-query attention (tilelang_mesh_tpu_torch/ops/gqa.py)
against the JAX package's on the same numpy-seeded inputs.

The JAX side runs as tests/test_attention_variants.py runs it (Pallas
interpret mode on the CPU); the port side runs on CPU tensors, i.e. each
kernel's plain PyTorch version. Tolerances: 2e-2 for forward values and
the partials (tests/test_attention_variants.py:33, which absorbs the
interpreter's bf16-like emulation of float32 products); 3e-2 for the
gradients through both packages' kernel backward
(tests/test_attention_variants.py:83); 1e-5 where the port's kernel path
is held against torch autograd through its own dense reference, both
exact float32 on the CPU (the two differ only in the order of the sums);
equality where group 1 is held against ``flash_attention`` (the same
code). The CUDA kernels are held against the plain versions on the card
by tests/test_torch_cuda.py.
"""

import importlib
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

ref = importlib.import_module("tilelang_mesh_tpu.ops.gqa")
port = importlib.import_module("tilelang_mesh_tpu_torch.ops.gqa")
port_fa = importlib.import_module(
    "tilelang_mesh_tpu_torch.ops.flash_attention")

TOL = 2e-2
GRAD_TOL = 3e-2
_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _qkvg(B, Hq, Hkv, S, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D),
                      (B, Hq, S, D))]


def _both(arrays, dtype):
    """The same values on both sides: rounded to ``dtype`` by JAX, copied
    to torch as float32 and cast back (exact)."""
    jd, td = _DTYPES[dtype]
    js = [jnp.asarray(a, jd) for a in arrays]
    ts = [torch.from_numpy(np.array(j, np.float32)).to(td) for j in js]
    return js, ts


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("Hq,Hkv", [(8, 2), (20, 5)])
def test_forward_matches_jax(Hq, Hkv, causal, dtype):
    q, k, v, _ = _qkvg(1, Hq, Hkv, 128, 64)
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), dtype)
    want = np.asarray(ref.gqa_attention(jq, jk, jv, causal=causal)
                      .astype(jnp.float32))
    got = port.gqa_attention(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_partials_match_jax(causal):
    """(acc, m, l) in the exp2 domain against ``gqa_fwd_partial_kernel``,
    through both packages' factories."""
    B, Hq, Hkv, S, D = 1, 8, 2, 256, 64
    q, k, v, _ = _qkvg(B, Hq, Hkv, S, D, seed=1)
    sm = 1.0 / math.sqrt(D)
    want = ref.gqa_fwd_partial_kernel(B, Hq, Hkv, S, S, D, 128, 128,
                                      causal, sm, "float32")(q, k, v)
    got = port.gqa_fwd_partial_kernel(B, Hq, Hkv, S, S, D, 128, 128,
                                      causal, sm, "float32")(
        *map(torch.from_numpy, (q, k, v)))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)
    o = port.gqa_fwd_kernel(B, Hq, Hkv, S, S, D, 128, 128, causal, sm,
                            torch.float32)(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(
        o.numpy(), np.asarray(ref.gqa_fwd_kernel(
            B, Hq, Hkv, S, S, D, 128, 128, causal, sm, "float32")(q, k, v)),
        rtol=TOL, atol=TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_gradients_match_jax(causal):
    """Both packages' kernel backward (the partial forward, then dK/dV
    and dQ summed over each KV head's group)."""
    B, Hq, Hkv, S, D = 1, 8, 2, 128, 64
    q, k, v, g = _qkvg(B, Hq, Hkv, S, D, seed=2)

    def loss(q, k, v):
        return jnp.sum(ref.gqa_attention(q, k, v, causal=causal)
                       * jnp.asarray(g))

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    port.gqa_attention(*leaves, causal=causal).backward(torch.from_numpy(g))
    for name, t, w in zip(("dQ", "dK", "dV"), leaves, want):
        assert t.grad.shape == t.shape
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("Hq,Hkv", [(4, 2), (20, 5), (6, 1)])
def test_kernel_backward_matches_reference_autograd(Hq, Hkv, causal):
    """backward="kernel" against backward="reference" (autograd through
    the dense reference with KV repeated), exact float32 on the CPU."""
    q, k, v, g = _qkvg(2, Hq, Hkv, 77, 16, seed=3)
    grads = {}
    for mode in ("kernel", "reference"):
        leaves = [torch.from_numpy(a.copy()).requires_grad_()
                  for a in (q, k, v)]
        out = port.gqa_attention(*leaves, causal=causal, backward=mode)
        out.backward(torch.from_numpy(g))
        grads[mode] = (out.detach(), *(t.grad for t in leaves))
    for a, b in zip(grads["kernel"], grads["reference"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_group_one_equals_flash_attention(causal):
    q, k, v, g = _qkvg(1, 3, 3, 70, 32, seed=4)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    torch.testing.assert_close(port.gqa_attention(tq, tk, tv, causal),
                               port_fa.flash_attention(tq, tk, tv, causal),
                               rtol=0, atol=0)
    sm = 0.3
    for a, b in zip(port.gqa_fwd_partial(tq, tk, tv, causal, sm),
                    port_fa.mha_fwd_partial(tq, tk, tv, causal, sm)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    grads = []
    for fn in (port.gqa_attention, port_fa.flash_attention):
        leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
        fn(*leaves, causal=causal).backward(torch.from_numpy(g))
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_no_grad_runs_the_forward_alone(monkeypatch):
    calls = []
    monkeypatch.setattr(port, "gqa_fwd_partial", lambda *a: calls.append(
        "partial") or port.gqa_fwd_partial_plain(*a))
    q, k, v, _ = _qkvg(1, 4, 2, 16, 16)
    port.gqa_attention(*map(torch.from_numpy, (q, k, v)))
    assert calls == []


def test_refusals():
    q = torch.zeros((1, 6, 8, 16))
    kv = torch.zeros((1, 4, 8, 16))
    with pytest.raises(ValueError, match="do not fit"):
        port.gqa_attention(q, kv, kv)
    with pytest.raises(ValueError, match="do not fit"):
        port.gqa_fwd(q, kv, kv, False, 0.25)
    with pytest.raises(ValueError, match="do not fit"):
        port.gqa_fwd_kernel(1, 6, 4, 8, 8, 16, 128, 128, False, 0.25,
                            "float32")
    ok = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError, match="backward"):
        port.gqa_attention(q.requires_grad_(), ok, ok, backward="dense")
    with pytest.raises(ValueError, match="bound"):
        port.gqa_fwd_kernel(1, 6, 2, 8, 8, 16, 128, 128, False, 0.25,
                            "float32")(q, ok, torch.zeros((1, 2, 9, 16)))
