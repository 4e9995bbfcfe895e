"""The port's linear attention and retention
(tilelang_mesh_tpu_torch/ops/linear_attention.py) against the JAX
package's (ops/linear_attention.py) on the same numpy-seeded inputs.

The JAX kernels run in Pallas interpret mode on the CPU, as
tests/test_attention_variants.py runs them; the port's run on CPU
tensors, i.e. the kernels' plain versions. Tolerances are the JAX
test's own: the forward at rtol 2e-2 / atol 2e-1
(tests/test_attention_variants.py:54), the kernel backward's gradients
against ``jax.grad`` of the JAX function at 3e-2 (:81); retention at
2e-2 against both the JAX kernel and its dense reference, and bfloat16
at 2e-2 (both sides round attn and the output to bf16 at the same
points). The CUDA kernels are held against the plain versions on the
card by tests/test_torch_cuda.py.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

ref = importlib.import_module("tilelang_mesh_tpu.ops.linear_attention")
port = importlib.import_module(
    "tilelang_mesh_tpu_torch.ops.linear_attention")


def _qkv(B, H, S, DK, DV, seed, scale=0.2, dtype=jnp.float32):
    rng = np.random.default_rng(seed)
    arrs = [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in ((B, H, S, DK), (B, H, S, DK), (B, H, S, DV))]
    j = tuple(jnp.asarray(a, dtype) for a in arrs)
    t = tuple(torch.from_numpy(np.array(a, np.float32)) for a in j)
    if dtype == jnp.bfloat16:
        t = tuple(a.bfloat16() for a in t)
    return j, t


@pytest.mark.parametrize("chunk", [128, 64])
def test_forward_matches_jax(chunk):
    j, t = _qkv(1, 2, 512, 64, 64, 1)
    want = np.asarray(ref.linear_attention(*j, chunk=chunk))
    before = dict(port.launches)
    got = port.linear_attention(*t, chunk=chunk)
    assert port.launches == before          # CPU tensors launch nothing
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-1)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        ref.linear_attention_reference(*j)), rtol=2e-2, atol=2e-1)
    np.testing.assert_allclose(
        port.linear_attention_reference(*t).numpy(),
        np.asarray(ref.linear_attention_reference(*j)), rtol=1e-5,
        atol=1e-5)


def test_forward_bf16_matches_jax():
    j, t = _qkv(1, 2, 256, 32, 64, 2, dtype=jnp.bfloat16)
    want = np.asarray(ref.linear_attention(*j, chunk=64), np.float32)
    got = port.linear_attention(*t, chunk=64)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)


# tests/test_attention_variants.py:57-110: (B, H, S, DK, DV), seed, loss
GRAD_CASES = {"square": ((1, 2, 128, 64, 64), 41, "dot"),
              "rectangular": ((1, 1, 64, 64, 128), 43, "square")}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_kernel_backward_matches_jax_grad(case):
    """dQ, dK, dV from the port's autograd Function (three calls of the
    forward on flipped operands) against jax.grad of the JAX function
    with its kernel backward."""
    (B, H, S, DK, DV), seed, loss = GRAD_CASES[case]
    rng = np.random.default_rng(seed)
    arrs = [(rng.standard_normal(s) * 0.2).astype(np.float32)
            for s in ((B, H, S, DK), (B, H, S, DK), (B, H, S, DV))]
    go = rng.standard_normal((B, H, S, DV)).astype(np.float32)

    def jloss(q, k, v):
        out = ref.linear_attention(q, k, v, chunk=64, backward="kernel")
        return jnp.sum(out * go) if loss == "dot" else jnp.sum(out ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, arrs))
    t = [torch.from_numpy(a).requires_grad_() for a in arrs]
    out = port.linear_attention(*t, chunk=64, backward="kernel")
    assert out.grad_fn is not None
    val = (out * torch.from_numpy(go)).sum() if loss == "dot" \
        else (out ** 2).sum()
    val.backward()
    for name, a, w in zip(("dQ", "dK", "dV"), t, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), rtol=3e-2,
                                   atol=3e-2, err_msg=name)


def test_kernel_backward_is_three_forward_calls(monkeypatch):
    """The backward runs the forward computation three times, on the
    operands of the JAX package's rearrangement, and nothing else."""
    calls = []
    plain = port.linear_attention_plain

    def spy(q, k, v, chunk):
        calls.append((tuple(q.shape), tuple(v.shape), chunk))
        return plain(q, k, v, chunk)

    monkeypatch.setattr(port, "linear_attention_plain", spy)
    _, t = _qkv(1, 1, 64, 16, 32, 44)
    t = [a.requires_grad_() for a in t]
    port.linear_attention(*t, chunk=32, backward="kernel").sum().backward()
    assert calls == [((1, 1, 64, 16), (1, 1, 64, 32), 32),     # forward
                     ((1, 1, 64, 32), (1, 1, 64, 16), 32),     # dq
                     ((1, 1, 64, 32), (1, 1, 64, 16), 32),     # dk
                     ((1, 1, 64, 16), (1, 1, 64, 32), 32)]     # dv


@pytest.mark.parametrize("dk,dv", [(32, 32), (16, 48)])
def test_grads_plain_match_kernel_backward_and_dense_autograd(dk, dv):
    """``linear_attention_grads_plain`` (what the card's gradients are
    held against at full width) is the kernel backward's arithmetic, and
    agrees with autograd through the dense reference."""
    _, t = _qkv(1, 2, 128, dk, dv, 49)
    g = torch.from_numpy(np.random.default_rng(50).standard_normal(
        (1, 2, 128, dv)).astype(np.float32))
    want = port.linear_attention_grads_plain(*t, g, 32)
    x = [a.clone().requires_grad_() for a in t]
    (port.linear_attention(*x, chunk=32, backward="kernel") * g).sum() \
        .backward()
    d = [a.clone().requires_grad_() for a in t]
    (port.linear_attention_reference(*d) * g).sum().backward()
    for name, w, a, b in zip(("dq", "dk", "dv"), want, x, d):
        assert torch.equal(a.grad, w), name
        np.testing.assert_allclose(w.numpy(), b.grad.numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_backward_argument_checked():
    _, t = _qkv(1, 1, 32, 16, 16, 45)
    with pytest.raises(ValueError):
        port.linear_attention(*t, backward="autograd")
    assert port.linear_attention(*t).grad_fn is None


GAMMA = [0.9, 0.97]


@pytest.mark.parametrize("chunk", [64, 32])
def test_retention_matches_jax(chunk):
    j, t = _qkv(1, 2, 256, 32, 32, 46)
    want = np.asarray(ref.retention(*j, np.asarray(GAMMA, np.float32),
                                    chunk=chunk))
    dense = np.asarray(ref.retention_reference(*j, jnp.asarray(GAMMA)))
    before = dict(port.launches)
    got = port.retention(*t, GAMMA, chunk=chunk)
    assert port.launches == before
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got.numpy(), dense, rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(port.retention_reference(*t, GAMMA).numpy(),
                               dense, rtol=1e-5, atol=1e-5)


def test_retention_bf16_matches_jax():
    j, t = _qkv(1, 2, 128, 32, 32, 47, dtype=jnp.bfloat16)
    gam = np.asarray([0.95, 1.0], np.float32)
    want = np.asarray(ref.retention(*j, gam, chunk=64), np.float32)
    got = port.retention(*t, torch.from_numpy(gam), chunk=64)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("gamma", [[0.0, 0.5], [0.5, 1.5], [0.5]])
def test_retention_gamma_checked(gamma):
    _, t = _qkv(1, 2, 32, 16, 16, 48)
    with pytest.raises(ValueError):
        port.retention(*t, gamma)
