"""The port's DSA (tilelang_mesh_tpu_torch/ops/dsa.py) against the JAX
package's (ops/dsa.py) on the same numpy-seeded inputs.

The JAX kernels run in Pallas interpret mode on the CPU, as
tests/test_dsa.py runs them; the port's on CPU tensors, i.e. the
kernels' plain versions. Tolerances, no looser than tests/test_dsa.py's:
the indexer 1e-3 (rtol = atol) in float32 and in bfloat16 — both sides
take the same bf16-rounded inputs, whose products are exact in float32,
and sum them in float32, so they differ only in the order of the sums
(measured 1e-5 on logits of ~60); the selector's ids equal, ties
included; sparse MLA O 2e-2 and LSE 1e-3 (bfloat16 the same: both round
p to bf16 before p @ v, at running maxes that may differ, one bf16 ulp of
O); the sparse fine-tuning gradients rtol 5e-2 / atol 5e-3, the
example's own (examples/dsa_sparse_finetune/example_dsa_finetune.py:50).
The CUDA kernels are held against the plain versions on the card by
tests/test_torch_cuda.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tilelang_mesh_tpu.ops import dsa as ref
from tilelang_mesh_tpu_torch import ops as port_ops
from tilelang_mesh_tpu_torch.ops import dsa as port

_TYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(arrays, dtype="float32"):
    """numpy arrays rounded to ``dtype`` once: (JAX arrays, CPU tensors)."""
    jt, tt = _TYPES[dtype]
    j = [jnp.asarray(a, jt) for a in arrays]
    return j, [torch.from_numpy(np.array(a, np.float32)).to(tt) for a in j]


def _indexer_inputs(B, S, Skv, HI, DI, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, HI, DI), dtype=np.float32),
            rng.standard_normal((B, Skv, DI), dtype=np.float32),
            rng.standard_normal((B, S, HI)).astype(np.float32))


def _logits_close(got, want, tol=1e-3):
    got = got.numpy()
    want = np.asarray(want)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


# ---------------------------------------------------------------- indexer --

# tests/test_dsa.py's shapes (:15, :72, :88), B 2 with an explicit
# q_offset, and S 96 (no multiple of 64): (B, S, Skv, HI, DI), q_offset
INDEXER_CASES = {"pipeline": ((1, 64, 128, 4, 32), None),
                 "batch2_offset": ((2, 48, 80, 4, 32), 17),
                 "ragged_s96": ((1, 96, 96, 2, 32), None),
                 "cache_tail": ((1, 32, 64, 2, 32), None)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(INDEXER_CASES))
def test_indexer_matches_jax(case, dtype):
    shape, q_offset = INDEXER_CASES[case]
    qi, ki, w = _indexer_inputs(*shape, seed=len(case))
    (jq, jk), (tq, tk) = _both((qi, ki), dtype)
    want = ref.lightning_indexer(jq, jk, w, q_offset=q_offset)
    got = port.lightning_indexer(tq, tk, torch.from_numpy(w),
                                 q_offset=q_offset)
    assert got.dtype == torch.float32
    _logits_close(got, want)


def test_indexer_cache_offset_reaches_every_key():
    """tests/test_dsa.py:104: the last query of a cache tail sees every
    key, and the mask is exactly j <= (Skv - S) + t."""
    qi, ki, w = _indexer_inputs(1, 32, 64, 2, 32, seed=6)
    got = port.lightning_indexer(qi, ki, np.abs(w), device="cpu").numpy()
    mask = np.arange(64)[None, None, :] <= 32 + np.arange(32)[None, :, None]
    assert np.isfinite(got[0, -1]).all()
    assert (np.isfinite(got) == mask).all()


# --------------------------------------------------------------- selector --

def _selector_rows(B, S, Skv, seed):
    """Small integers (many ties), finite entries at and below -1e30,
    -inf, signed zeros, and a row with fewer candidates than topk."""
    rng = np.random.default_rng(seed)
    L = rng.integers(-3, 4, (B, S, Skv)).astype(np.float32)
    L[rng.random(L.shape) < 0.1] = -2e30
    L[rng.random(L.shape) < 0.05] = -1e30
    L[rng.random(L.shape) < 0.1] = -np.inf
    L[rng.random(L.shape) < 0.05] = -0.0
    L[0, 5, : Skv - 6] = -np.inf
    return L


@pytest.mark.parametrize("B,S,Skv,topk", [(2, 80, 96, 32), (1, 8, 24, 30)])
def test_selector_matches_jax(B, S, Skv, topk):
    L = _selector_rows(B, S, Skv, seed=Skv)
    want = np.asarray(ref.topk_selector(L, topk))
    got = port.topk_selector(torch.from_numpy(L), topk)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, S, topk)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == -1).any()              # some rows ran out of candidates


def test_selector_tie_and_invalid_rules():
    """Ties to the smaller id, an entry at or below -1e30 invalid even when
    finite, -1 once the candidates run out; -0.0 ties +0.0."""
    row = np.array([[[1, 2, 2, -2e30, 5, 2, -np.inf, 1]]], np.float32)
    zeros = np.array([[[0.0, -0.0, -0.0, 0.0, 1.0, -1e30]]], np.float32)
    for L, k in ((row, 8), (zeros, 6)):
        want = np.asarray(ref.topk_selector(L, k))
        got = port.topk_selector(L, k, device="cpu").numpy()
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        port.topk_selector(row, 8, device="cpu").numpy()[0, 0],
        [4, 1, 2, 5, 0, 7, -1, -1])


def test_selector_on_indexer_logits():
    """tests/test_dsa.py:38: the pipeline's causal logits; rows that see
    fewer keys than topk end in -1."""
    qi, ki, w = _indexer_inputs(1, 64, 128, 4, 32, seed=0)
    logits = np.asarray(ref.lightning_indexer(qi, ki, w, q_offset=0))
    want = np.asarray(ref.topk_selector(logits, 32))
    got = port.topk_selector(torch.from_numpy(logits.copy()), 32)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[0, :31] == -1).any()


# ------------------------------------------------------------ sparse MLA --

def _mla_inputs(B, S, Skv, H, D, DT, topk, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D + DT), dtype=np.float32)
    kv = rng.standard_normal((B, Skv, D + DT), dtype=np.float32)
    bound = (Skv - S) + np.arange(S)
    ind = np.stack([np.stack([rng.choice(bound[t] + 1, topk,
                                         replace=bound[t] + 1 < topk)
                              for t in range(S)]) for _ in range(B)])
    return q, kv, ind.astype(np.int32)


def _mla_close(got, want, o_tol=2e-2, lse_tol=1e-3):
    np.testing.assert_allclose(got[0].float().numpy(),
                               np.asarray(want[0], np.float32),
                               rtol=o_tol, atol=o_tol)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=lse_tol, atol=lse_tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sparse_mla_fwd_matches_jax(dtype):
    """tests/test_dsa.py:51's widths (H 8, D 128, DT 64, topk 32,
    block_I 16) over causal draws of the selected ids."""
    q, kv, ind = _mla_inputs(1, 64, 128, 8, 128, 64, 32, seed=1)
    (jq, jkv), (tq, tkv) = _both((q, kv), dtype)
    want = ref.sparse_mla_fwd(jq, jkv, ind, block_I=16)
    got = port.sparse_mla_fwd(tq, tkv, torch.from_numpy(ind), block_I=16)
    assert got[0].dtype == _TYPES[dtype][1] and got[1].dtype == torch.float32
    _mla_close(got, want)


def test_sparse_mla_invalid_ids_and_dead_rows():
    """Ids above the causal bound, duplicates and -1 slots, as the JAX
    kernel masks them; a row with no valid id gives O exactly 0 and LSE
    (-1e30 + log2 1e-30) / log2 e, the JAX kernel's values."""
    B, S, Skv, H, D, DT, topk = 2, 16, 40, 4, 128, 64, 16
    q, kv, ind = _mla_inputs(B, S, Skv, H, D, DT, topk, seed=2)
    rng = np.random.default_rng(3)
    ind[0, :8, :4] = rng.integers(Skv - S + 8, Skv, (8, 4))  # past t
    ind[0, :, 4:8] = ind[0, :, 8:12]                         # duplicates
    ind[1, :, ::3] = -1
    ind[1, 2] = -1                                           # dead rows
    ind[0, 0] = Skv - 1                                      # past t = 0
    want = ref.sparse_mla_fwd(q, kv, ind, block_I=16)
    got = port.sparse_mla_fwd(q, kv, ind, block_I=16, device="cpu")
    _mla_close(got, want)
    lse = np.float32(port.DEAD_ROW_LSE)
    for b, t in ((1, 2), (0, 0)):
        assert (got[0][b, t] == 0).all() and (got[1][b, t] == lse).all()
        np.testing.assert_array_equal(np.asarray(want[1])[b, t], lse)
    assert lse == np.float32(-6.931472e29)


def test_sparse_mla_refusals_word_for_word():
    """tests/test_dsa.py:65 and :117: the block_I and tail_dim
    ValueErrors carry the JAX package's words."""
    cases = [((1, 8, 4, 192), (1, 16, 192), (1, 8, 30), {"block_I": 16}),
             ((1, 8, 4, 256), (1, 16, 256), (1, 8, 16), {"block_I": 16}),
             ((1, 8, 4, 256), (1, 16, 256), (1, 8, 16), {"tail_dim": 256})]
    said = []
    for qs, kvs, ids, kw in cases:
        q, kv = np.zeros(qs, np.float32), np.zeros(kvs, np.float32)
        ind = np.zeros(ids, np.int32)
        with pytest.raises(ValueError) as want:
            ref.sparse_mla_fwd(q, kv, ind, **kw)
        with pytest.raises(ValueError) as got:
            port.sparse_mla_fwd(q, kv, ind, device="cpu", **kw)
        assert str(got.value) == str(want.value)
        said.append(str(got.value))
    assert "multiple of block_I" in said[0]
    assert "tail_dim" in said[1] and "out of range" in said[2]


def test_sparse_mla_explicit_tail_dim():
    """tests/test_dsa.py:117: a 256-wide q needs tail_dim; with 64 the
    latent is 192 wide."""
    q, kv, ind = _mla_inputs(1, 8, 16, 4, 192, 64, 16, seed=4)
    want = ref.sparse_mla_fwd(q, kv, ind, block_I=16, tail_dim=64)
    got = port.sparse_mla_fwd(q, kv, ind, block_I=16, tail_dim=64,
                              device="cpu")
    assert tuple(got[0].shape) == (1, 8, 4, 192)
    _mla_close(got, want)


def test_sparse_mla_reference_matches_jax_nan_included():
    """The dense reference, NaN in O and LSE on a row with no valid id,
    as the JAX reference gives."""
    q, kv, ind = _mla_inputs(1, 8, 24, 4, 128, 64, 16, seed=5)
    ind[0, 3] = -1
    want = ref.sparse_mla_reference(q, kv, ind)
    got = port.sparse_mla_reference(q, kv, ind, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, equal_nan=True)
    assert np.isnan(got[0][0, 3].numpy()).all()
    assert np.isnan(got[1][0, 3].numpy()).all()


# ------------------------------------------------------ sparse fine-tuning --

def _finetune_inputs():
    """examples/dsa_sparse_finetune/example_dsa_finetune.py:21's draws
    (B 1, S 32, Skv 64, H 4, D 128, DT 64, topk 16), ids from the JAX
    indexer and selector."""
    B, S, Skv, H, D, DT, topk = 1, 32, 64, 4, 128, 64, 16
    rng = np.random.default_rng(0)
    q_idx = rng.standard_normal((B, S, 4, 32), dtype=np.float32)
    k_idx = rng.standard_normal((B, Skv, 32), dtype=np.float32)
    w = rng.standard_normal((B, S, 4)).astype(np.float32)
    ind = np.array(ref.topk_selector(
        ref.lightning_indexer(q_idx, k_idx, w), topk))
    q = rng.standard_normal((B, S, H, D + DT), dtype=np.float32)
    kv = rng.standard_normal((B, Skv, D + DT), dtype=np.float32)
    target = rng.standard_normal((B, S, H, D), dtype=np.float32)
    return q, kv, ind, target


def test_make_sparse_mla_grads_match_jax():
    q, kv, ind, target = _finetune_inputs()
    j_mla = ref.make_sparse_mla(block_I=16)

    def j_loss(q, kv):
        return jnp.mean((j_mla(q, kv, ind).astype(jnp.float32) - target)
                        ** 2)

    want = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(q), jnp.asarray(kv))
    p_mla = port.make_sparse_mla(block_I=16)
    tq, tkv = (torch.from_numpy(a.copy()).requires_grad_() for a in (q, kv))
    loss = ((p_mla(tq, tkv, torch.from_numpy(ind)).float()
             - torch.from_numpy(target)) ** 2).mean()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(j_loss(q, kv)),
                               rtol=1e-5)
    for g, w in ((tq.grad, want[0]), (tkv.grad, want[1])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-2,
                                   atol=5e-3)


def test_make_sparse_mla_loss_falls():
    """The example's loop (lr 0.05, 8 steps) on the port."""
    q, kv, ind, target = _finetune_inputs()
    sparse_mla = port.make_sparse_mla(block_I=16)
    q, kv = torch.from_numpy(q), torch.from_numpy(kv)
    ind, target = torch.from_numpy(ind), torch.from_numpy(target)
    losses = []
    for _ in range(8):
        q, kv = q.detach().requires_grad_(), kv.detach().requires_grad_()
        loss = ((sparse_mla(q, kv, ind) - target) ** 2).mean()
        loss.backward()
        losses.append(float(loss.detach()))
        with torch.no_grad():
            q, kv = q - 0.05 * q.grad, kv - 0.05 * kv.grad
    assert losses[-1] < losses[0], losses
    assert port.launches == {"lightning_indexer": 0, "topk_selector": 0,
                             "sparse_mla_fwd": 0}


@pytest.mark.parametrize("D,DT", port.KERNEL_WIDTHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_sparse_mla_path_by_type_and_width(D, DT, dtype):
    """float32 runs the CUDA-core kernel; bfloat16 / float16 the wgmma
    kernel where D + DT and each consumer's D / 2 columns are whole
    64-column blocks of the 128-byte swizzle, the mma.sync kernel at D
    192."""
    want = ("sparse_mla_fwd" if dtype == "float32" else
            "sparse_mla_fwd_wgmma" if D % 128 == 0 else
            "sparse_mla_fwd_mma")
    for dt in (dtype, getattr(torch, dtype)):
        assert port.sparse_mla_path(D, DT, dt) == want


def test_wgmma_widths_are_the_whole_block_widths():
    assert port.WGMMA_WIDTHS == ((512, 64), (256, 64), (128, 64))
    assert all((d + dt) % 64 == 0 and (d // 2) % 64 == 0
               for d, dt in port.WGMMA_WIDTHS)
    assert (192, 64) in port.KERNEL_WIDTHS


def test_sparse_mla_kernel_counters_reset_together():
    """kernel_launches names the three kernels of sparse_mla.cu and
    reset_launches zeroes it; a CPU call counts nothing."""
    assert set(port.kernel_launches) == {
        "sparse_mla_fwd", "sparse_mla_fwd_mma", "sparse_mla_fwd_wgmma"}
    port.kernel_launches["sparse_mla_fwd_wgmma"] += 2
    port.reset_launches()
    assert set(port.kernel_launches.values()) == {0}
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 4, 2, 192), dtype=np.float32)
    kv = rng.standard_normal((1, 8, 192), dtype=np.float32)
    ind = rng.integers(-1, 8, (1, 4, 16)).astype(np.int32)
    port.sparse_mla_fwd(q, kv, ind, block_I=16, device="cpu")
    assert set(port.kernel_launches.values()) == {0}


# ----------------------------------------------------------- the pipeline --

def test_chain_matches_jax():
    """examples/deepseek_v32/example_dsa.py's shapes and draws: indexer,
    selector and sparse MLA, each stage against JAX's on JAX's input."""
    B, S, Skv, HI, DI, H, D, DT, topk = 1, 64, 128, 4, 32, 8, 128, 64, 32
    rng = np.random.default_rng(0)
    q_idx = rng.standard_normal((B, S, HI, DI), dtype=np.float32)
    k_idx = rng.standard_normal((B, Skv, DI), dtype=np.float32)
    w = rng.standard_normal((B, S, HI)).astype(np.float32)
    q = rng.standard_normal((B, S, H, D + DT), dtype=np.float32)
    kv = rng.standard_normal((B, Skv, D + DT), dtype=np.float32)
    j_logits = ref.lightning_indexer(q_idx, k_idx, w)
    j_ind = np.asarray(ref.topk_selector(j_logits, topk))
    want = ref.sparse_mla_fwd(q, kv, j_ind, block_I=16)

    logits = port.lightning_indexer(q_idx, k_idx, w, device="cpu")
    _logits_close(logits, j_logits)
    ind = port.topk_selector(logits, topk)
    np.testing.assert_array_equal(ind.numpy(), j_ind)
    got = port.sparse_mla_fwd(q, kv, ind, block_I=16, device="cpu")
    _mla_close(got, want)
    o_ref, _ = ref.sparse_mla_reference(q, kv, j_ind)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(o_ref),
                               rtol=2e-2, atol=2e-2)


def test_entry_points_default_to_the_card_and_exports():
    """Arrays go to ``cuda`` unless the caller asks for the CPU: without a
    card that raises instead of falling back; the package exports the
    three ops and factories as the JAX package's ops/__init__ does."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    qi, ki, w = _indexer_inputs(1, 8, 8, 2, 16, seed=7)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.lightning_indexer(qi, ki, w)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.topk_selector(np.zeros((1, 2, 4), np.float32), 2)
    for name in ("lightning_indexer", "topk_selector", "sparse_mla_fwd",
                 "lightning_indexer_kernel", "topk_selector_kernel",
                 "sparse_mla_fwd_kernel"):
        assert getattr(port_ops, name) is getattr(port, name)
    assert math.isclose(port.DEAD_ROW_LSE, -6.931472e29, rel_tol=1e-6)
