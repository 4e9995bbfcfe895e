"""The port's NSA inference (tilelang_mesh_tpu_torch/ops/nsa.py) against
the JAX package's (ops/nsa.py) on the same numpy-seeded inputs; its
training backward in tests/test_torch_nsa_bwd.py.

The JAX kernels run in Pallas interpret mode on the CPU, as
tests/test_sparse_attention.py runs them; the port's on CPU tensors, i.e.
the kernels' plain versions. Tolerance 2e-2, the JAX tests' own
(tests/test_sparse_attention.py:85-128, :357), and 1e-5 for the varlen
leak check (:397). On a ragged T (not a multiple of the block size) the
port is held against ``nsa_reference``, not the JAX kernel: the JAX
kernel's block copy runs past the last key there and reads other rows,
so it differs from its own reference; the port masks by position, as
the reference does. The CUDA kernels are held against the plain
versions on the card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tilelang_mesh_tpu.ops import nsa as ref
from tilelang_mesh_tpu_torch import ops as port_ops
from tilelang_mesh_tpu_torch.ops import nsa as port

TOL = 2e-2
_TYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}


def _selections(rng, B, T, H, S, BS):
    """tests/test_sparse_attention.py:65-76: each token picks up to S of
    the blocks at or before its own, its own always, -1 for the rest."""
    bi = np.zeros((B, T, H, S), np.int32)
    for b in range(B):
        for t in range(T):
            own = t // BS
            for h in range(H):
                picks = rng.choice(own + 1, size=min(S, own + 1),
                                   replace=False)
                row = np.full(S, -1)
                row[:len(picks)] = picks
                if own not in picks:
                    row[0] = own
                bi[b, t, h] = row
    return bi


def _inputs(B, T, HQ, H, D, S, BS, seed=0):
    """tests/test_sparse_attention.py:56's generator, as numpy."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, HQ, D)).astype(np.float32)
    k = rng.standard_normal((B, T, H, D)).astype(np.float32)
    v = rng.standard_normal((B, T, H, D)).astype(np.float32)
    g_slc = rng.uniform(0.2, 1.0, (B, T, HQ)).astype(np.float32)
    g_swa = rng.uniform(0.2, 1.0, (B, T, HQ)).astype(np.float32)
    return q, k, v, g_slc, g_swa, _selections(rng, B, T, H, S, BS)


def _both(q, k, v, dtype="float32"):
    """q, k, v rounded to ``dtype`` once, for JAX and for torch."""
    jt, tt = _TYPES[dtype]
    j = [jnp.asarray(a, jt) for a in (q, k, v)]
    return j, [torch.from_numpy(np.array(a, np.float32)).to(tt) for a in j]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# tests/test_sparse_attention.py:80-96: (B, T, HQ, H, D, S, BS), window,
# seed
CASES = {"selected_only": ((1, 64, 4, 2, 32, 3, 16), 0, 0),
         "with_window": ((1, 64, 2, 1, 32, 2, 16), 24, 1),
         "batch_group4": ((2, 48, 8, 2, 16, 3, 16), 20, 3)}


@pytest.mark.parametrize("dtype", sorted(_TYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_nsa_attention_matches_jax(case, dtype):
    shape, window, seed = CASES[case]
    BS = shape[-1]
    q, k, v, gs, gw, bi = _inputs(*shape, seed=seed)
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v, dtype)
    want = ref.nsa_attention(jq, jk, jv, jnp.asarray(gs), jnp.asarray(gw),
                             jnp.asarray(bi), block_size=BS,
                             window_size=window)
    before = dict(port.launches)
    got = port.nsa_attention(tq, tk, tv, torch.from_numpy(gs),
                             torch.from_numpy(gw), bi, block_size=BS,
                             window_size=window)
    assert port.launches == before          # CPU tensors launch nothing
    assert got.dtype == _TYPES[dtype][1] and got.shape == tq.shape
    _close(got, want)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_nsa_block_counts(as_tensor):
    """tests/test_sparse_attention.py:99: per-token counts below S, as
    an int and as an array."""
    B, T, HQ, H, D, S, BS = 1, 32, 2, 1, 16, 2, 8
    q, k, v, gs, gw, bi = _inputs(B, T, HQ, H, D, S, BS, seed=2)
    cnts = np.random.default_rng(3).integers(1, S + 1, (B, T, H)).astype(
        np.int32)
    counts = (torch.from_numpy(cnts), jnp.asarray(cnts)) if as_tensor \
        else (1, 1)
    want = ref.nsa_attention(*map(jnp.asarray, (q, k, v, gs, gw, bi)),
                             block_counts=counts[1], block_size=BS)
    got = port.nsa_attention(*map(torch.from_numpy, (q, k, v, gs, gw, bi)),
                             block_counts=counts[0], block_size=BS)
    _close(got, want)


@pytest.mark.parametrize("window", [0, 24])
def test_ragged_length_follows_the_reference(window):
    """T 40 with blocks of 16: the last block is partial. The JAX kernel
    differs from its reference there (its block copy reads rows past T);
    the port agrees with the reference."""
    B, T, HQ, H, D, S, BS = 1, 40, 4, 2, 32, 3, 16
    a = _inputs(B, T, HQ, H, D, S, BS)
    want = ref.nsa_reference(*map(jnp.asarray, a), block_size=BS,
                             window_size=window)
    got = port.nsa_attention(*map(torch.from_numpy, a), block_size=BS,
                             window_size=window)
    _close(got, want)
    mine = port.nsa_reference(*map(torch.from_numpy, a), block_size=BS,
                              window_size=window)
    np.testing.assert_allclose(mine.numpy(), np.asarray(want), atol=1e-5)


def test_nsa_decode_matches_jax():
    """tests/test_sparse_attention.py:111: decode equals the forward at
    the last token with the same selections."""
    B, Tk, HQ, H, D, S, BS = 1, 64, 4, 2, 32, 3, 16
    rng = np.random.default_rng(4)
    q = rng.standard_normal((B, HQ, D)).astype(np.float32)
    k = rng.standard_normal((B, Tk, H, D)).astype(np.float32)
    v = rng.standard_normal((B, Tk, H, D)).astype(np.float32)
    g = rng.uniform(0.2, 1.0, (B, HQ)).astype(np.float32)
    bi = np.stack([rng.choice(Tk // BS, S, replace=False)
                   for _ in range(B * H)]).reshape(B, H, S).astype(np.int32)
    want = ref.nsa_decode(*map(jnp.asarray, (q, k, v, g, bi)),
                          block_size=BS)
    got = port.nsa_decode(*map(torch.from_numpy, (q, k, v, g, bi)),
                          block_size=BS)
    _close(got, want)
    g_full = np.zeros((B, Tk, HQ), np.float32)
    g_full[:, -1] = g
    dense = port.nsa_reference(
        torch.from_numpy(np.broadcast_to(q[:, None], (B, Tk, HQ, D)).copy()),
        torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(g_full),
        torch.zeros(B, Tk, HQ), np.broadcast_to(bi[:, None], (B, Tk, H, S)),
        block_size=BS)[:, -1]
    _close(got, dense.numpy())


def _varlen_inputs(rng, lens, HQ, H, D, S, BS):
    cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    total = int(cu[-1])
    q = rng.standard_normal((total, HQ, D)).astype(np.float32)
    k = rng.standard_normal((total, H, D)).astype(np.float32)
    v = rng.standard_normal((total, H, D)).astype(np.float32)
    g = rng.uniform(0.2, 1.0, (total, HQ)).astype(np.float32)
    bi = np.concatenate([_selections(rng, 1, n, H, S, BS)[0]
                         for n in lens])
    return cu, q, k, v, g, bi


def test_nsa_varlen_matches_jax_and_each_sequence():
    """tests/test_sparse_attention.py:325: sequence-local block ids; each
    sequence equals the dense reference on it alone."""
    lens, HQ, H, D, S, BS = [24, 40, 9], 4, 2, 32, 3, 8
    cu, q, k, v, g, bi = _varlen_inputs(np.random.default_rng(21), lens,
                                        HQ, H, D, S, BS)
    want = ref.nsa_attention_varlen(*map(jnp.asarray, (q, k, v, g, bi)), cu,
                                    block_size=BS)
    got = port.nsa_attention_varlen(*map(torch.from_numpy, (q, k, v, g, bi)),
                                    cu, block_size=BS)
    _close(got, want)
    for b in range(len(lens)):
        lo, hi = int(cu[b]), int(cu[b + 1])
        dense = port.nsa_reference(
            *(torch.from_numpy(a[None, lo:hi]) for a in (q, k, v, g)),
            torch.zeros(1, hi - lo, HQ), bi[None, lo:hi], block_size=BS)
        _close(got[lo:hi], dense[0].numpy())
    # a tensor cu_seqlens, and pad rows past cu[-1] that give 0
    padded = [np.concatenate([a, np.ones((5,) + a.shape[1:], a.dtype)])
              for a in (q, k, v, g, bi)]
    out = port.nsa_attention_varlen(*map(torch.from_numpy, padded),
                                    torch.from_numpy(cu), block_size=BS)
    torch.testing.assert_close(out[:len(q)], got)
    assert bool((out[len(q):] == 0).all())


def test_nsa_varlen_no_cross_sequence_leak():
    """tests/test_sparse_attention.py:369: the last, partial block of a
    short sequence does not see the next sequence's keys."""
    rng = np.random.default_rng(22)
    lens, HQ, H, D, S, BS = [12, 20], 2, 1, 16, 2, 8
    cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    total = int(cu[-1])
    q = rng.standard_normal((total, HQ, D)).astype(np.float32)
    k1 = rng.standard_normal((total, H, D)).astype(np.float32)
    k2 = k1.copy()
    k2[12:] += 100.0          # only sequence 1's keys
    v = rng.standard_normal((total, H, D)).astype(np.float32)
    g = np.ones((total, HQ), np.float32)
    bi = np.full((total, H, S), -1, np.int32)
    for tl in range(12):
        bi[tl, 0, 0] = tl // BS
        if tl // BS == 1:
            bi[tl, 0, 1] = 0
    for tl in range(20):
        bi[12 + tl, 0, 0] = tl // BS
    o1, o2 = (port.nsa_attention_varlen(*map(torch.from_numpy,
                                             (q, kk, v, g, bi)), cu,
                                        block_size=BS) for kk in (k1, k2))
    np.testing.assert_allclose(o1[:12].numpy(), o2[:12].numpy(), rtol=1e-5,
                               atol=1e-5)


def test_plain_versions_gather_tokens_in_chunks(monkeypatch):
    """The plain versions gather keys a chunk of tokens at a time; the
    chunking changes nothing."""
    a = _inputs(2, 48, 4, 2, 16, 3, 8, seed=7)
    whole = port.nsa_attention(*map(torch.from_numpy, a), block_size=8,
                               window_size=12)
    monkeypatch.setattr(port, "PLAIN_TOKENS", 5)
    torch.testing.assert_close(
        port.nsa_attention(*map(torch.from_numpy, a), block_size=8,
                           window_size=12), whole)


def test_factories_match_jax():
    """nsa_fwd_kernel, nsa_varlen_fwd_kernel and nsa_decode_kernel on the
    kernel-side layouts, as the JAX wrappers call them."""
    B, T, HQ, H, D, S, BS, W = 1, 32, 4, 2, 16, 2, 8, 12
    G = HQ // H
    q, k, v, gs, gw, bi = _inputs(B, T, HQ, H, D, S, BS, seed=8)
    cnt = np.full((B, T, H), S, np.int32)
    ops = (q.reshape(B, T, H, G, D), k.transpose(0, 2, 1, 3).copy(),
           v.transpose(0, 2, 1, 3).copy(), bi, cnt,
           gs.reshape(B, T, H, G), gw.reshape(B, T, H, G))
    args = (B, T, H, G, T, D, S, BS, W, 0.25, "float32")
    want = ref.nsa_fwd_kernel(*args)(*map(jnp.asarray, ops))
    got = port.nsa_fwd_kernel(*args)(*map(torch.from_numpy, ops))
    _close(got, want)
    # varlen: raw row offsets (one sequence here, so block id * BS)
    offs = np.where(bi >= 0, bi * BS, -1).astype(np.int32)
    vops = ops[:3] + (offs, cnt, ops[5])
    args = (T, H, G, T, D, S, BS, 0.25, "float32")
    want = ref.nsa_varlen_fwd_kernel(*args)(*map(jnp.asarray, vops))
    got = port.nsa_varlen_fwd_kernel(*args)(*map(torch.from_numpy, vops))
    _close(got, want)
    # decode: the last token's selections over all T keys
    dops = (ops[0][:, -1], ops[1], ops[2], bi[:, -1], cnt[:, -1],
            ops[5][:, -1])
    args = (B, H, G, T, D, S, BS, 0.25, "float32")
    want = ref.nsa_decode_kernel(*args)(*map(jnp.asarray, dops))
    got = port.nsa_decode_kernel(*args)(*map(torch.from_numpy, dops))
    _close(got, want)
    with pytest.raises(ValueError):        # bound to its shape
        port.nsa_decode_kernel(*args)(*map(torch.from_numpy, ops[:6]))


def test_training_backward_is_a_later_slice():
    """The training backward came with a later slice: backward="kernel"
    now runs (tests/test_torch_nsa_bwd.py holds it against jax.grad)
    and gives the fused forward's value."""
    a = _inputs(1, 16, 2, 1, 16, 2, 8)
    got = port.nsa_attention(*map(torch.from_numpy, a), block_size=8,
                             backward="kernel")
    _close(got, port.nsa_attention(*map(torch.from_numpy, a),
                                   block_size=8).numpy())
    assert port_ops.nsa_attention is port.nsa_attention
