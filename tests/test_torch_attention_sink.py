"""The port's sink attention (tilelang_mesh_tpu_torch/ops/attention_sink.py)
against the JAX package's on the same numpy-seeded inputs.

The JAX side runs as tests/test_sparse_attention.py runs it (Pallas
interpret mode on the CPU); the port side runs on CPU tensors, i.e. each
kernel's plain PyTorch version. Tolerances: 2e-2 for the forward
(tests/test_sparse_attention.py:31, which absorbs the interpreter's
bf16-like emulation of float32 products); 3e-2 for the gradients of q,
k, v and the sinks against JAX's ``backward="kernel"`` gradients and
against JAX's autograd through its dense reference
(tests/test_sparse_attention.py:428); 1e-4 where the port's kernel path
is held against torch autograd through its own dense reference, both
exact float32 on the CPU (the two differ in the order of the sums and
exp2 against exp). The CUDA kernel is held against the plain version on
the card by tests/test_torch_cuda.py.
"""

import importlib
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

ref = importlib.import_module("tilelang_mesh_tpu.ops.attention_sink")
port = importlib.import_module("tilelang_mesh_tpu_torch.ops.attention_sink")
gqa = importlib.import_module("tilelang_mesh_tpu_torch.ops.gqa")
gb = importlib.import_module("tilelang_mesh_tpu_torch.ops.gqa_bwd")

TOL = 2e-2
GRAD_TOL = 3e-2
_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16),
           "float16": (jnp.float16, torch.float16)}


def _inputs(B, Hq, Hkv, Sq, Sk, D, seed=0):
    """q, k, v, the incoming gradient and the sinks (N(0, 1), as the
    reference's sinks are drawn)."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D),
                      (B, Hq, Sq, D), (Hq,))]


def _both(arrays, dtype):
    jd, td = _DTYPES[dtype]
    js = [jnp.asarray(a, jd) for a in arrays]
    ts = [torch.from_numpy(np.array(j, np.float32)).to(td) for j in js]
    return js, ts


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, 48, 128])
@pytest.mark.parametrize("Hq,Hkv", [(2, 2), (8, 1)])
def test_forward_matches_jax(Hq, Hkv, window, causal):
    """MHA and GQA 8 : 1, head_dim 64, S 256: the window's lower edge
    inside a block, a window as wide as a block, causal and not (the
    window then bounds keys from below only)."""
    q, k, v, _, sinks = _inputs(1, Hq, Hkv, 256, 256, 64, seed=Hq)
    (jq, jk, jv, js), (tq, tk, tv, ts) = _both((q, k, v, sinks), "float32")
    want = ref.attention_sink(jq, jk, jv, js, causal=causal,
                              window_size=window, block_M=64, block_N=64)
    got = port.attention_sink(tq, tk, tv, ts, causal=causal,
                              window_size=window, block_M=64, block_N=64)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, want, TOL)
    _close(got, ref.attention_sink_reference(jq, jk, jv, js, causal=causal,
                                             window_size=window), TOL)


@pytest.mark.parametrize("window", [None, 128])
def test_forward_bfloat16_matches_jax(window):
    q, k, v, _, sinks = _inputs(1, 8, 2, 256, 256, 64, seed=3)
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), "bfloat16")
    want = ref.attention_sink(jq, jk, jv, jnp.asarray(sinks),
                              window_size=window, block_M=64, block_N=64)
    got = port.attention_sink(tq, tk, tv, torch.from_numpy(sinks),
                              window_size=window, block_M=64, block_N=64)
    assert got.dtype == torch.bfloat16
    _close(got, want, TOL)


@pytest.mark.parametrize("window", [None, 128])
def test_forward_float16_matches_jax(window):
    """float16 (the card's tensor-core kernel's other type) through the
    JAX kernel in interpret mode and the port's plain version."""
    q, k, v, _, sinks = _inputs(1, 8, 2, 256, 256, 64, seed=3)
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), "float16")
    want = ref.attention_sink(jq, jk, jv, jnp.asarray(sinks),
                              window_size=window, block_M=64, block_N=64)
    got = port.attention_sink(tq, tk, tv, torch.from_numpy(sinks),
                              window_size=window, block_M=64, block_N=64)
    assert got.dtype == torch.float16
    _close(got, want, TOL)


@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("window", [0, 1, 128, 512, 513, 4096])
def test_sink_tile_rule(D, window):
    """The tensor-core kernel's tile: one of flash_attention.cu's tiles
    for the head_dim (carver.FLASH_KERNEL_TILES), the window's tile for
    0 < window <= 512, the full tile otherwise; no instance past the
    four head_dims."""
    from tilelang_mesh_tpu_torch.carver import FLASH_KERNEL_TILES
    tile = port.sink_tile(D, window)
    full, windowed = port.SINK_TILES[D]
    assert tile == (windowed if 0 < window <= 512 else full)
    assert tile in FLASH_KERNEL_TILES.get(D, ((64, 64),))
    if D == 64:         # gpt-oss: 128 x 64 at full causal, 64 x 64 under
        assert (full, windowed) == ((128, 64), (64, 64))  # its window
    assert port.sink_tile(96, window) is None


def test_bfloat16_sinks_are_taken_as_float32():
    """bf16 sinks give the output of their float32 values."""
    q, k, v, _, sinks = _inputs(1, 4, 2, 64, 64, 64, seed=4)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    sb = torch.from_numpy(sinks).to(torch.bfloat16)
    got = port.attention_sink(tq, tk, tv, sb)
    assert torch.equal(got, port.attention_sink(tq, tk, tv, sb.float()))
    _close(got, ref.attention_sink(*map(jnp.asarray, (q, k, v)),
                                   jnp.asarray(sb.float().numpy()),
                                   block_M=64, block_N=64), TOL)


def test_row_that_sees_no_key_is_zero():
    """Non-causal, window 32, Sq 128 over Sk 64: rows 96.. see no key
    (their window lies past Sk), and the sink alone gives 0 on both
    sides."""
    q, k, v, _, sinks = _inputs(1, 2, 2, 128, 64, 64, seed=5)
    js = [jnp.asarray(a) for a in (q, k, v, sinks)]
    want = np.asarray(ref.attention_sink(*js, causal=False, window_size=32,
                                         block_M=64, block_N=64))
    got = port.attention_sink(*map(torch.from_numpy, (q, k, v, sinks)),
                              causal=False, window_size=32, block_M=64,
                              block_N=64).numpy()
    assert not got[:, :, 96:].any() and not want[:, :, 96:].any()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_factory_matches_jax():
    B, Hq, Hkv, S, D = 1, 4, 2, 128, 64
    q, k, v, _, sinks = _inputs(B, Hq, Hkv, S, S, D, seed=6)
    sm = 1.0 / math.sqrt(D)
    want = ref.sink_fwd_kernel(B, Hq, Hkv, S, S, D, 64, 64, True, 48, sm,
                               "float32")(*map(jnp.asarray, (q, k, v, sinks)))
    fn = port.sink_fwd_kernel(B, Hq, Hkv, S, S, D, 64, 64, True, 48, sm,
                              "float32")
    _close(fn(*map(torch.from_numpy, (q, k, v, sinks))), want, TOL)
    with pytest.raises(ValueError, match="bound to"):
        fn(*map(torch.from_numpy, (k, k, v, sinks)))


def _port_grads(q, k, v, g, sinks, fn):
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v,
                                                             sinks)]
    o = fn(*leaves)
    o.backward(torch.from_numpy(g))
    return o.detach(), [t.grad for t in leaves]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Hq,Hkv", [(2, 2), (4, 2), (8, 1)])
def test_gradients_match_jax(Hq, Hkv, causal):
    """dQ, dK, dV, dSinks of ``backward="kernel"`` (the GQA partial, the
    sink fold, the dK/dV and dQ kernels' plain versions and the closed
    form) against JAX's ``backward="kernel"`` and JAX's autograd through
    its dense reference, and against torch autograd through the port's
    dense reference."""
    q, k, v, g, sinks = _inputs(1, Hq, Hkv, 128, 128, 64, seed=31 + Hq)
    jq, jk, jv, jg, js = map(jnp.asarray, (q, k, v, g, sinks))

    def loss_kernel(q, k, v, s):
        return jnp.sum(ref.attention_sink(q, k, v, s, causal=causal,
                                          block_M=64, block_N=64,
                                          backward="kernel") * jg)

    def loss_ref(q, k, v, s):
        return jnp.sum(ref.attention_sink_reference(q, k, v, s,
                                                    causal=causal) * jg)

    want = jax.grad(loss_kernel, argnums=(0, 1, 2, 3))(jq, jk, jv, js)
    want_ref = jax.grad(loss_ref, argnums=(0, 1, 2, 3))(jq, jk, jv, js)
    launched = (dict(gqa.launches), dict(gb.launches))
    o, got = _port_grads(q, k, v, g, sinks, lambda *t: port.attention_sink(
        *t, causal=causal, block_M=64, block_N=64, backward="kernel"))
    # CPU tensors ran the plain versions: no kernel launch was counted
    assert (dict(gqa.launches), dict(gb.launches)) == launched
    _, dense = _port_grads(q, k, v, g, sinks, lambda *t:
                           port.attention_sink_reference(*t, causal=causal))
    for name, a, b, c, d in zip(("dQ", "dK", "dV", "dSinks"), got, want,
                                want_ref, dense):
        assert a.dtype == torch.float32 and a.shape == d.shape, name
        _close(a, b, GRAD_TOL)
        _close(a, c, GRAD_TOL)
        torch.testing.assert_close(a, d, rtol=1e-4, atol=1e-4, msg=name)
    _close(o, ref.attention_sink(jq, jk, jv, js, causal=causal,
                                 block_M=64, block_N=64), TOL)


def test_bfloat16_sinks_get_a_bfloat16_gradient():
    """The cast to float32 is differentiated: a bf16 leaf gets its dSinks
    in bf16, the float32 one rounded."""
    q, k, v, g, sinks = _inputs(1, 4, 2, 64, 64, 64, seed=9)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    sb = torch.from_numpy(sinks).to(torch.bfloat16).requires_grad_()
    port.attention_sink(tq, tk, tv, sb, backward="kernel").backward(
        torch.from_numpy(g))
    _, want = _port_grads(q, k, v, g, sb.detach().float().numpy(),
                          lambda *t: port.attention_sink(
                              *t, backward="kernel"))
    assert sb.grad.dtype == torch.bfloat16
    assert torch.equal(sb.grad, want[3].to(torch.bfloat16))


def test_kernel_mode_without_autograd_runs_the_fused_kernel():
    """``backward="kernel"`` with nothing to differentiate is the fused
    forward, as JAX's primal; with autograd it is the partial + fold,
    equal within float32 rounding."""
    q, k, v, _, sinks = _inputs(1, 4, 2, 128, 128, 64, seed=10)
    t = list(map(torch.from_numpy, (q, k, v, sinks)))
    fused = port.attention_sink(*t, backward="kernel")
    assert fused.grad_fn is None
    torch.testing.assert_close(fused, port.sink_fwd_plain(
        *t, True, 0, 1.0 / 8.0), rtol=0, atol=0)
    leaves = [a.clone().requires_grad_() for a in t]
    part = port.attention_sink(*leaves, backward="kernel")
    assert part.grad_fn is not None
    torch.testing.assert_close(part.detach(), fused, rtol=1e-5, atol=1e-5)


def test_sink_grad_closed_form():
    """``dsink = -sum exp2(sink log2e - lse2) * delta`` against autograd
    of the fold on the plain partials."""
    q, k, v, g, sinks = _inputs(2, 4, 2, 96, 96, 32, seed=11)
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    acc, m, l = gqa.gqa_fwd_partial_plain(tq, tk, tv, True, 32 ** -0.5)
    s = torch.from_numpy(sinks).requires_grad_()
    o, lse2 = port.sink_stats(acc, m, l, s, torch.float32)
    (o * tg).sum().backward()
    delta = (tg * o.detach()).sum(-1)
    torch.testing.assert_close(port.sink_grad(lse2.detach(), delta,
                                              s.detach()), s.grad,
                               rtol=1e-5, atol=1e-5)


def test_value_errors_match_jax():
    q = np.zeros((1, 2, 64, 64), np.float32)
    sinks = np.zeros((2,), np.float32)
    jq, js = jnp.asarray(q), jnp.asarray(sinks)
    tq, ts = torch.from_numpy(q), torch.from_numpy(sinks)
    cases = [dict(window_size=32, backward="kernel"),     # a window
             dict(backward="reference"),                  # a mode
             dict(block_M=48),                            # 64 % 48
             dict(block_N=40)]
    for kw in cases:
        with pytest.raises(ValueError) as jerr:
            ref.attention_sink(jq, jq, jq, js, **kw)
        with pytest.raises(ValueError) as terr:
            port.attention_sink(tq, tq, tq, ts, **kw)
        assert str(jerr.value).split()[:2] == str(terr.value).split()[:2]
    with pytest.raises(ValueError, match="sinks must be"):
        port.attention_sink(tq, tq, tq, torch.zeros(3))
