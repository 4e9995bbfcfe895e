"""The port's flagship model (tilelang_mesh_tpu_torch/models/) against
the JAX package's (tilelang_mesh_tpu/models/transformer.py).

The JAX params tree from ``init_params(PRNGKey(0))`` is carried over
with ``params_from_jax``, so both sides hold the same weights; tokens are
numpy draws. The JAX side runs its attention as tests/test_model.py runs
it (Pallas interpret mode when ``use_flash``); the port runs on CPU
tensors, i.e. each kernel's plain PyTorch version. Tolerances: 2e-2 for
logits against the interpret-mode kernels (tests/test_model.py:37);
rtol = atol = 1e-4 against the dense JAX path, both exact float32 on the
CPU with logits of magnitude ~60 (sums in another order); the training
losses at rtol 1e-4 (the dp x tp dryrun's loss0 / loss1 on the same
params and tokens, MULTICHIP_r05); parameters after one AdamW step at
rtol 5e-2 / atol 5e-3 (tests/test_model.py:81: adam normalises by
sqrt(nu), which amplifies ordering differences near zero curvature).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tilelang_mesh_tpu.models import ModelConfig as RefConfig
from tilelang_mesh_tpu.models import forward as ref_forward
from tilelang_mesh_tpu.models import init_params as ref_init
from tilelang_mesh_tpu.models import loss_fn as ref_loss
from tilelang_mesh_tpu.models import make_train_step as ref_train_step
from tilelang_mesh_tpu_torch.entry import TINY, entry
from tilelang_mesh_tpu_torch.models import (ModelConfig, Transformer,
                                            forward, init_params, loss_fn,
                                            make_train_step, params_from_jax,
                                            params_to_numpy)

# __graft_entry__.py:38-42, the config of the dryrun's train step
REF_TINY = RefConfig(vocab=64, d_model=64, n_layers=2, n_heads=4, d_ff=128,
                     max_seq=64, dtype=jnp.float32, use_flash=True)


def _cfgs(use_flash):
    return (dataclasses.replace(TINY, use_flash=use_flash),
            dataclasses.replace(REF_TINY, use_flash=use_flash))


@pytest.fixture(scope="module")
def ref_tree():
    return jax.tree.map(np.asarray, ref_init(jax.random.PRNGKey(0),
                                             REF_TINY))


def _tokens(seed, b, s):
    return np.random.default_rng(seed).integers(0, TINY.vocab, (b, s))


def test_params_round_trip(ref_tree):
    model = params_from_jax(ref_tree, TINY, device="cpu")
    assert model.layers[1].w_down.shape == (TINY.d_ff, TINY.d_model)
    back = params_to_numpy(model)
    flat = jax.tree.leaves(back)
    assert len(flat) == len(jax.tree.leaves(ref_tree)) == 2 + 9 * 2
    for a, b in zip(flat, jax.tree.leaves(ref_tree)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        params_from_jax({**ref_tree, "layers": ref_tree["layers"][:1]},
                        TINY, device="cpu")


def test_init_params_distributions():
    cfg = ModelConfig(vocab=512, d_model=128, n_layers=1, n_heads=8,
                      d_ff=512, dtype="bfloat16")
    model = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    lp = model.layers[0]
    assert model.embed.dtype == torch.bfloat16 and cfg.head_dim == 16
    for p, std in ((model.embed, 1.0), (lp.wq, 128 ** -0.5),
                   (lp.w_up, 128 ** -0.5), (lp.w_down, 512 ** -0.5)):
        assert abs(float(p.detach().float().std()) / std - 1) < 0.05
    assert bool((lp.attn_norm == 1).all() and (model.final_norm == 1).all())
    again = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    assert torch.equal(again.layers[0].wq, lp.wq)
    with pytest.raises(TypeError):
        ModelConfig(dtype="int32")


@pytest.mark.parametrize("use_flash,tol", [(True, 2e-2), (False, 1e-4)])
def test_logits_match_reference(ref_tree, use_flash, tol):
    cfg, ref_cfg = _cfgs(use_flash)
    tok = _tokens(1, 2, 64)
    want = np.asarray(ref_forward(jax.tree.map(jnp.asarray, ref_tree),
                                  jnp.asarray(tok, jnp.int32), ref_cfg))
    model = params_from_jax(ref_tree, cfg, device="cpu")
    got = model(torch.from_numpy(tok))
    assert got.shape == (2, 64, TINY.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=tol,
                               atol=tol)


def test_loss_matches_reference(ref_tree):
    cfg, ref_cfg = _cfgs(False)
    tok = _tokens(2, 4, 33)
    want = float(ref_loss(jax.tree.map(jnp.asarray, ref_tree),
                          jnp.asarray(tok, jnp.int32), ref_cfg))
    model = params_from_jax(ref_tree, cfg, device="cpu")
    with torch.no_grad():
        got = float(loss_fn(model, torch.from_numpy(tok)))
        # the same weights through the kernel path, chosen by cfg
        kernel_path = float(loss_fn(model, torch.from_numpy(tok), TINY))
    assert got == pytest.approx(want, rel=1e-5)
    assert kernel_path == pytest.approx(want, rel=1e-4)


def test_train_steps_reproduce_reference_losses(ref_tree):
    """Two port steps on the kernel path from the JAX init give the
    reference's loss0 / loss1; the params after one step match a JAX
    step's."""
    tok = _tokens(1, 8, 65)
    model = params_from_jax(ref_tree, TINY, device="cpu")
    init, step = make_train_step(TINY, lr=1e-3)
    opt = init(model)
    p0 = model.layers[0].wq.detach().clone()
    model2, opt2, loss0 = step(model, opt, torch.from_numpy(tok))
    assert model2 is model and opt2 is opt and loss0.dim() == 0
    assert not torch.equal(model.layers[0].wq, p0)     # updated in place
    after_one = params_to_numpy(model)
    _, _, loss1 = step(model, opt, torch.from_numpy(tok))
    assert float(loss0) == pytest.approx(44.84370422363281, rel=1e-4)
    assert float(loss1) == pytest.approx(42.237667083740234, rel=1e-4)

    _, ref_cfg = _cfgs(False)
    rinit, rstep = ref_train_step(ref_cfg, lr=1e-3)
    params = jax.tree.map(jnp.asarray, ref_tree)
    params, _, rloss0 = rstep(params, rinit(params), jnp.asarray(tok,
                                                                 jnp.int32))
    assert float(loss0) == pytest.approx(float(rloss0), rel=1e-4)
    for a, b in zip(jax.tree.leaves(after_one), jax.tree.leaves(params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=5e-2, atol=5e-3)


def test_entry_on_cpu():
    fn, (model, tokens) = entry(device="cpu")
    assert isinstance(model, Transformer) and model.cfg == TINY
    assert tuple(tokens.shape) == (2, TINY.max_seq)
    np.testing.assert_array_equal(tokens.numpy(), _tokens(0, 2, 64))
    out = fn(model, tokens)
    assert out.shape == (2, TINY.max_seq, TINY.vocab)
    assert bool(torch.isfinite(out).all())
    # the same weights through the dense path
    dense = forward(model, tokens, dataclasses.replace(TINY,
                                                       use_flash=False))
    torch.testing.assert_close(out, dense, rtol=1e-4, atol=1e-4)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would work")
    g = torch.Generator().manual_seed(0)
    for call in (lambda: Transformer(TINY), lambda: init_params(TINY, g),
                 lambda: params_from_jax({"layers": [None] * 2}, TINY),
                 entry):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
