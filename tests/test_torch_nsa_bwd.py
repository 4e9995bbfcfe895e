"""The port's NSA training (``nsa_attention(backward="kernel")``,
tilelang_mesh_tpu_torch/ops/nsa.py and ops/nsa_bwd.py) against the JAX
package's on the same numpy-seeded inputs.

The JAX kernels (the partial forward and the dK/dV and dQ kernels) run
in Pallas interpret mode on the CPU, as tests/test_sparse_attention.py
runs them; the port's on CPU tensors, i.e. the kernels' plain versions.
Tolerances are the JAX tests' own: 3e-2 for the gradients against
``jax.grad`` and against the dense graph
(tests/test_sparse_attention.py:251-255), 2e-2 for the forward value
(:267), rtol 3e-2 / atol 3e-1 for the duplicate-index case and for
bfloat16 and float16 gradients (the attention backward's,
tests/test_flash_bwd.py:34); the factories' float32 outputs at 1e-5
(the same float32 arithmetic in another order), the multiplicity map
integer for integer. The CUDA kernels are held against the plain
versions on the card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tilelang_mesh_tpu.ops import nsa as ref
from tilelang_mesh_tpu.ops import nsa_bwd as ref_bwd
from tilelang_mesh_tpu_torch import ops as port_ops
from tilelang_mesh_tpu_torch.ops import nsa as port
from tilelang_mesh_tpu_torch.ops import nsa_bwd as port_bwd

GRAD_TOL = 3e-2
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


def _inputs(B, T, HQ, H, D, S, BS, seed):
    """tests/test_sparse_attention.py:56's generator, as numpy."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, HQ, D)).astype(np.float32)
    k = rng.standard_normal((B, T, H, D)).astype(np.float32)
    v = rng.standard_normal((B, T, H, D)).astype(np.float32)
    g_slc = rng.uniform(0.2, 1.0, (B, T, HQ)).astype(np.float32)
    g_swa = rng.uniform(0.2, 1.0, (B, T, HQ)).astype(np.float32)
    return q, k, v, g_slc, g_swa, _selections(rng, B, T, H, S, BS)


def _dense_jax(q, k, v, g_slc, bi, cnt, BS):
    """tests/test_sparse_attention.py:196's dense selected-branch graph."""
    B, Tq, HQ, D = q.shape
    H = k.shape[2]
    G = HQ // H
    S = bi.shape[-1]
    Tk = k.shape[1]
    t = jnp.arange(Tq)[None, :, None, None]
    kk = jnp.arange(Tk)[None, None, None, :]
    vis = jnp.zeros((B, Tq, H, Tk), bool)
    for s in range(S):
        b_s = bi[..., s]
        ok = (b_s >= 0) & (b_s * BS <= t[..., 0]) & (s < cnt)
        vis = vis | ((kk // BS == b_s[..., None]) & ok[..., None])
    vis = vis & (kk <= t)
    s_ = jnp.einsum("bthgd,bkhd->bthgk", q.reshape(B, Tq, H, G, D),
                    k) / np.sqrt(D)
    s_ = jnp.where(vis[:, :, :, None, :], s_, -jnp.inf)
    m = s_.max(-1, keepdims=True)
    p = jnp.exp(s_ - jnp.where(jnp.isfinite(m), m, 0.0))
    denom = p.sum(-1, keepdims=True)
    p = jnp.where(denom > 0, p / jnp.maximum(denom, 1e-30), 0.0)
    o = jnp.einsum("bthgk,bkhd->bthgd", p, v)
    return (o * g_slc.reshape(B, Tq, H, G)[..., None]).reshape(B, Tq, HQ, D)


def _jax_grads(fn, args):
    return jax.grad(fn, argnums=tuple(range(len(args))))(*args)


def _port_grads(call, arrays, go, dtype=torch.float32):
    leaves = [torch.from_numpy(np.array(a, np.float32)).to(dtype)
              .requires_grad_() for a in arrays[:3]]
    leaves.append(torch.from_numpy(np.array(arrays[3], np.float32))
                  .requires_grad_())
    out = call(*leaves)
    out.backward(torch.from_numpy(go).to(out.dtype))
    return out, [t.grad for t in leaves]


def _close(got, want, rtol=GRAD_TOL, atol=GRAD_TOL, what=""):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=what)


# tests/test_sparse_attention.py:236-239: B 1, T 32, HQ 4, H 2, D 32,
# S 3, BS 8, seed 5; the incoming gradient from default_rng(9)
SHAPE = (1, 32, 4, 2, 32, 3, 8)


def _grad_case():
    q, k, v, gs, _, bi = _inputs(*SHAPE, seed=5)
    go = np.random.default_rng(9).standard_normal(q.shape).astype(
        np.float32)
    return (q, k, v, gs), bi, go


def _port_call(bi, BS, **kw):
    return lambda q, k, v, g: port.nsa_attention(
        q, k, v, g, torch.zeros_like(g), bi, block_size=BS,
        backward="kernel", **kw)


def test_gradients_match_jax_grad():
    """dQ, dK, dV and dG against jax.grad through the JAX package's
    kernel path."""
    arrays, bi, go = _grad_case()
    BS = SHAPE[-1]

    def loss(q, k, v, g):
        return jnp.sum(ref.nsa_attention(q, k, v, g, jnp.zeros_like(g), bi,
                                         block_size=BS, backward="kernel")
                       * go)

    want = _jax_grads(loss, [jnp.asarray(a) for a in arrays])
    before = dict(port.launches), dict(port_bwd.launches)
    _, got = _port_grads(_port_call(bi, BS), arrays, go)
    assert (port.launches, port_bwd.launches) == before   # CPU: no kernel
    for name, a, w in zip(("dQ", "dK", "dV", "dG"), got, want):
        assert a.shape == w.shape
        _close(a, w, what=name)


def test_gradients_match_the_dense_graph():
    """The same gradients against jax AD of the dense selected-branch
    graph (tests/test_sparse_attention.py:231), and the port's own dense
    graph (``nsa_dense``) against it."""
    arrays, bi, go = _grad_case()
    BS = SHAPE[-1]
    cnt = jnp.full(SHAPE[:2] + (SHAPE[3],), SHAPE[5], jnp.int32)

    def loss(q, k, v, g):
        return jnp.sum(_dense_jax(q, k, v, g, jnp.asarray(bi), cnt, BS)
                       * go)

    want = _jax_grads(loss, [jnp.asarray(a) for a in arrays])
    _, got = _port_grads(_port_call(bi, BS), arrays, go)
    _, dense = _port_grads(lambda q, k, v, g: port.nsa_dense(
        q, k, v, g, bi, block_size=BS), arrays, go)
    for name, a, d, w in zip(("dQ", "dK", "dV", "dG"), got, dense, want):
        _close(a, w, what=name)
        _close(d, w, rtol=1e-5, atol=1e-5, what=f"nsa_dense {name}")


def test_forward_value_matches_fused():
    """tests/test_sparse_attention.py:258: backward='kernel' gives the
    fused kernel's value (window off, g_swa irrelevant), with and without
    a gradient to compute, and JAX's partial path's."""
    q, k, v, gs, gw, bi = _inputs(1, 32, 2, 1, 32, 2, 8, seed=6)
    a = port.nsa_attention(*map(torch.from_numpy, (q, k, v, gs, gw)), bi,
                           block_size=8)
    want = ref.nsa_attention(*map(jnp.asarray, (q, k, v, gs, gw)), bi,
                             block_size=8, backward="kernel")
    b = port.nsa_attention(*map(torch.from_numpy, (q, k, v, gs, gw)), bi,
                           block_size=8, backward="kernel")
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    c = port.nsa_attention(*leaves, *map(torch.from_numpy, (gs, gw)), bi,
                           block_size=8, backward="kernel")
    assert c.requires_grad and not b.requires_grad
    _close(b, a.numpy(), 2e-2, 2e-2)
    _close(b, want, 2e-2, 2e-2)
    torch.testing.assert_close(c.detach(), b, rtol=0, atol=0)


def test_duplicate_indices_multiplicity():
    """tests/test_sparse_attention.py:277: every token selects block 0
    twice and its own block; the gradients are those OF the computed
    primal (dK / dV scaled by the multiplicity), as jax.grad through the
    JAX kernels gives them and as the port's dense graph, which weighs a
    key by its multiplicity, gives them."""
    B, Tq, HQ, H, D, S, BS = 1, 16, 2, 1, 16, 3, 8
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, Tq, HQ, D), (B, Tq, H, D), (B, Tq, H, D)))
    g = np.ones((B, Tq, HQ), np.float32)
    bi = np.zeros((B, Tq, H, S), np.int32)
    for t in range(Tq):
        bi[0, t, 0] = [0, 0, t // BS]
    go = rng.standard_normal((B, Tq, HQ, D)).astype(np.float32)

    def loss(q, k, v):
        return jnp.sum(ref.nsa_attention(q, k, v, jnp.asarray(g),
                                         jnp.zeros_like(g), bi,
                                         block_size=BS, backward="kernel")
                       * go)

    want = _jax_grads(loss, [jnp.asarray(a) for a in (q, k, v)])
    _, got = _port_grads(_port_call(bi, BS), (q, k, v, g), go)
    _, dense = _port_grads(lambda q, k, v, g: port.nsa_dense(
        q, k, v, g, bi, block_size=BS), (q, k, v, g), go)
    for name, a, d, w in zip(("dQ", "dK", "dV"), got, dense, want):
        _close(a, w, rtol=3e-2, atol=3e-1, what=name)
        _close(a, d.numpy(), rtol=1e-4, atol=1e-4, what=f"{name} vs dense")


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_low_precision_gradients_match_jax(dtype):
    """bfloat16 and float16: q, k, v rounded once for both sides; the
    backward's tolerance."""
    arrays, bi, go = _grad_case()
    BS = SHAPE[-1]
    jt, tt = _TYPES[dtype]
    qkv = [np.asarray(jnp.asarray(a, jt).astype(jnp.float32))
           for a in arrays[:3]]

    def loss(q, k, v, g):
        o = ref.nsa_attention(q, k, v, g, jnp.zeros_like(g), bi,
                              block_size=BS, backward="kernel")
        return jnp.sum(o.astype(jnp.float32) * go)

    want = _jax_grads(loss, [jnp.asarray(a, jt) for a in qkv]
                      + [jnp.asarray(arrays[3])])
    out, got = _port_grads(_port_call(bi, BS), qkv + [arrays[3]], go, tt)
    assert out.dtype == tt
    for name, a, w in zip(("dQ", "dK", "dV", "dG"), got, want):
        assert a.dtype == (tt if name != "dG" else torch.float32)
        _close(a, np.asarray(w, np.float32), rtol=3e-2, atol=3e-1,
               what=f"{name} {dtype}")


@pytest.mark.parametrize("case,match", [
    (dict(window_size=8), "window_size == 0"),
    (dict(T=20), "multiple of block_size"),
    (dict(backward="reference"), "not available for this op"),
    (dict(backward="fused"), "backward must be 'kernel' or 'reference'")])
def test_refusals_are_jax_s(case, match):
    """The JAX package's ValueErrors, word for word, on both sides."""
    case = dict(case)
    T = case.pop("T", 16)
    kw = {"block_size": 8, "backward": "kernel", **case}
    arrays = _inputs(1, T, 2, 1, 16, 2, 8, seed=7)
    with pytest.raises(ValueError, match=match):
        ref.nsa_attention(*map(jnp.asarray, arrays), **kw)
    with pytest.raises(ValueError, match=match):
        port.nsa_attention(*map(torch.from_numpy, arrays), **kw)


@pytest.mark.parametrize("Tq,NS", [(32, 4), (40, 4)])
def test_block_mask_matches_jax(Tq, NS):
    """-1 slots, counts below S (0 included), duplicate ids, ids past the
    causal bound and (Tq 40 over 4 blocks) ids at or past NS."""
    B, H, S, BS = 2, 3, 5, 8
    rng = np.random.default_rng(Tq)
    bi = rng.integers(-1, NS + 2, (B, Tq, H, S)).astype(np.int32)
    bi[..., 1] = bi[..., 0]                            # a duplicate
    cnt = rng.integers(0, S + 1, (B, Tq, H)).astype(np.int32)
    want = np.asarray(ref_bwd.nsa_block_mask(jnp.asarray(bi),
                                             jnp.asarray(cnt), Tq, NS, BS))
    got = port_bwd.nsa_block_mask(torch.from_numpy(bi),
                                  torch.from_numpy(cnt), Tq, NS, BS)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.max() >= 2                             # duplicates count


def _factory_inputs():
    """Kernel-side operands as the JAX wrapper makes them: q5, kh, vh,
    the selections, the map, an incoming gradient and JAX's partial
    forward's lse2 and delta."""
    B, T, HQ, H, D, S, BS = 1, 32, 4, 2, 16, 3, 8
    G, NS, sm = HQ // H, T // BS, 0.3
    q, k, v, _, _, bi = _inputs(B, T, HQ, H, D, S, BS, seed=12)
    bi[0, 5, 1, 2] = bi[0, 5, 1, 0]                    # a duplicate
    cnt = np.random.default_rng(13).integers(0, S + 1, (B, T, H)).astype(
        np.int32)
    q5 = q.reshape(B, T, H, G, D)
    kh, vh = (a.transpose(0, 2, 1, 3).copy() for a in (k, v))
    do = np.random.default_rng(14).standard_normal(q5.shape).astype(
        np.float32)
    args = (B, T, H, G, T, D, S, BS, sm, "float32")
    acc, m, l = ref.nsa_fwd_partial_kernel(*args)(
        *map(jnp.asarray, (q5, kh, vh, bi, cnt)))
    l = np.asarray(l)
    o = np.where(l[..., None] > 0, np.asarray(acc) / np.maximum(
        l[..., None], 1e-30), 0.0)
    with np.errstate(divide="ignore"):           # l = 0: lse2 -inf
        lse2 = (np.asarray(m) + np.log2(l)).astype(np.float32)
    delta = (do * o).sum(-1).astype(np.float32)
    mask = np.asarray(ref_bwd.nsa_block_mask(jnp.asarray(bi),
                                             jnp.asarray(cnt), T, NS, BS))
    return args, (q5, kh, vh, bi, cnt), (acc, m, l), do, lse2, delta, mask


def test_factories_match_jax():
    """nsa_fwd_partial_kernel, nsa_bwd_dkdv_kernel and nsa_bwd_dq_kernel,
    called as the JAX package calls them (ops/nsa.py:219-229), against
    JAX's factories: (acc, m, l) (m where l > 0: a row that sees nothing
    has m -1e30 on the port's side), dK / dV and dQ."""
    args, fwd, want, do, lse2, delta, mask = _factory_inputs()
    B, T, H, G, Tk, D, S, BS, sm, dt = args
    got = port_ops.nsa_fwd_partial_kernel(*args)(*map(torch.from_numpy,
                                                      fwd))
    seen = np.asarray(want[2]) > 0
    assert (~seen).any() and seen.any()
    _close(got[0], want[0], 1e-5, 1e-5, "acc")
    _close(got[2], want[2], 1e-5, 1e-5, "l")
    np.testing.assert_allclose(got[1].numpy()[seen], np.asarray(want[1])[
        seen], rtol=1e-5, atol=1e-5)
    assert bool((got[1][torch.from_numpy(~seen)] == -1e30).all())
    q5, kh, vh, bi, cnt = fwd
    ops = (q5, kh, vh, do, lse2, delta)
    NS = Tk // BS
    dargs = (B, T, H, G, Tk, D, NS, BS, sm, dt)
    wk, wv = ref_bwd.nsa_bwd_dkdv_kernel(*dargs)(*map(jnp.asarray,
                                                      ops + (mask,)))
    gk, gv = port_bwd.nsa_bwd_dkdv_kernel(*dargs)(*map(torch.from_numpy,
                                                       ops + (mask,)))
    _close(gk, wk, 1e-5, 1e-5, "dK")
    _close(gv, wv, 1e-5, 1e-5, "dV")
    wq = ref_bwd.nsa_bwd_dq_kernel(*args)(*map(jnp.asarray,
                                               ops + (bi, cnt)))
    gq = port_bwd.nsa_bwd_dq_kernel(*args)(*map(torch.from_numpy,
                                                ops + (bi, cnt)))
    _close(gq, wq, 1e-5, 1e-5, "dQ")
    with pytest.raises(ValueError):                     # bound to its shape
        port_bwd.nsa_bwd_dq_kernel(*args)(*map(torch.from_numpy,
                                               ops + (bi,)))


def test_dkdv_plan_chunks_each_block_in_token_order(monkeypatch):
    """The card's dK / dV work list: every nonzero pair of the map once,
    by (batch, head, block) and then token; chunks of at most
    DKDV_CHUNK_ROWS // G tokens tiling each block's pairs in order; a block no
    token selects has no chunk."""
    *_, mask = _factory_inputs()
    mask = torch.from_numpy(mask)
    B, T, H, NS = mask.shape
    G = 2
    monkeypatch.setattr(port_bwd, "DKDV_CHUNK_ROWS", 10)
    tok, mult, chunks, first = port_bwd.dkdv_plan(mask, G)
    per = 10 // G
    seg = []
    for c, (s, e0, e1) in enumerate(chunks.tolist()):
        assert 0 < e1 - e0 <= per and first[s] <= c < first[s + 1]
        seg += [s] * (e1 - e0)
    assert chunks[:, 1].tolist() == [0] + chunks[:-1, 2].tolist()
    assert int(chunks[-1, 2]) == tok.numel() == int((mask > 0).sum())
    m = mask.permute(0, 2, 3, 1)
    for s, t, n in zip(seg, tok.tolist(), mult.tolist()):
        b, h, blk = s // (H * NS), (s // NS) % H, s % NS
        assert int(m[b, h, blk, t]) == n > 0
    counts = torch.bincount(torch.tensor(seg), minlength=B * H * NS)
    assert ((first[1:] - first[:-1]) == (counts + per - 1) // per).all()


def test_plain_versions_step_in_chunks(monkeypatch):
    """The plain versions gather a chunk of tokens (dQ) or pairs (dK /
    dV) at a time; the chunking changes nothing."""
    args, fwd, _, do, lse2, delta, mask = _factory_inputs()
    q5, kh, vh, bi, cnt = map(torch.from_numpy, fwd)
    ops = [q5, kh, vh] + [torch.from_numpy(a) for a in (do, lse2, delta)]
    mask = torch.from_numpy(mask)
    BS, sm = args[7], args[8]
    whole = (port_bwd.nsa_bwd_dkdv(*ops, mask, BS, sm),
             port_bwd.nsa_bwd_dq(*ops, bi, cnt, BS, sm),
             port.nsa_fwd_partial(q5, kh, vh, bi, cnt, BS, sm))
    monkeypatch.setattr(port_bwd, "PLAIN_PAIRS", 7)
    monkeypatch.setattr(port_bwd, "PLAIN_TOKENS", 5)
    monkeypatch.setattr(port, "PLAIN_TOKENS", 3)
    parts = (port_bwd.nsa_bwd_dkdv(*ops, mask, BS, sm),
             port_bwd.nsa_bwd_dq(*ops, bi, cnt, BS, sm),
             port.nsa_fwd_partial(q5, kh, vh, bi, cnt, BS, sm))
    for a, b in zip(whole, parts):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-6)


def _steps_inputs(T, HQ, H, D, S, BS, dtype, seed):
    """Kernel-side operands at Tk = T in ``dtype`` (both sides on the same
    rounded values): q5, kh, vh, dO, JAX's partial forward's lse2 and
    delta, the map with a duplicate id (multiplicity 2) in every token's
    last slot."""
    jt, tt = _TYPES[dtype]
    G, sm = HQ // H, D ** -0.5
    q, k, v, _, _, bi = _inputs(1, T, HQ, H, D, S, BS, seed)
    bi[..., -1] = bi[..., 0]
    cnt = np.full((1, T, H), S, np.int32)
    q5 = q.reshape(1, T, H, G, D)
    kh, vh = (a.transpose(0, 2, 1, 3).copy() for a in (k, v))
    do = np.random.default_rng(seed + 1).standard_normal(q5.shape).astype(
        np.float32)
    q5, kh, vh, do = (np.asarray(jnp.asarray(a, jt).astype(jnp.float32))
                      for a in (q5, kh, vh, do))
    args = (1, T, H, G, T, D, S, BS, sm, dtype)
    acc, m, l = ref.nsa_fwd_partial_kernel(*args)(
        *(jnp.asarray(a, jt) for a in (q5, kh, vh)), jnp.asarray(bi),
        jnp.asarray(cnt))
    l = np.asarray(l)
    o = np.asarray(acc) / l[..., None]
    lse2 = (np.asarray(m) + np.log2(l)).astype(np.float32)
    delta = (do * np.asarray(jnp.asarray(o, jt).astype(jnp.float32))).sum(
        -1).astype(np.float32)
    mask = np.asarray(ref_bwd.nsa_block_mask(jnp.asarray(bi),
                                             jnp.asarray(cnt), T, T // BS,
                                             BS))
    assert mask.max() >= 2
    ops = (q5, kh, vh, do, lse2, delta, mask)
    dargs = (1, T, H, G, T, D, T // BS, BS, sm, dtype)
    want = ref_bwd.nsa_bwd_dkdv_kernel(*dargs)(
        *(jnp.asarray(a, jt) for a in ops[:4]),
        *map(jnp.asarray, ops[4:]))
    port_ops_ = [torch.from_numpy(np.array(a)) for a in ops]
    port_ops_[:4] = [t.to(tt) for t in port_ops_[:4]]
    return port_ops_, BS, sm, want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D,chunk_rows", [(128, 2048), (128, 40),
                                          (32, 2048), (32, 40)])
def test_dkdv_steps_emulation_matches_jax(monkeypatch, dtype, D,
                                          chunk_rows):
    """The tensor-core dK / dV kernel's order (rows a step at a time: 32 at
    D 128, 64 at D 32; the causal mask only on a step holding one of the
    block's own tokens; chunks of 40 rows cut the own tokens of a block
    across chunks) against the JAX kernel in interpret mode: float32 at
    the factories' 1e-5, bfloat16 at the backward's tolerance; and
    against the plain version (same rounding points) at 1e-5 in float32,
    1e-2 normwise in bfloat16."""
    monkeypatch.setattr(port_bwd, "DKDV_CHUNK_ROWS", chunk_rows)
    ops, BS, sm, want = _steps_inputs(96, 4, 2, D, 3, 32, dtype, 21)
    got = port_bwd.nsa_bwd_dkdv_steps_plain(*ops, BS, sm)
    plain = port_bwd.nsa_bwd_dkdv_plain(*ops, BS, sm)
    tol = (1e-5, 1e-5) if dtype == "float32" else (3e-2, 3e-1)
    for name, a, w, p in zip(("dK", "dV"), got, want, plain):
        _close(a, w, *tol, what=name)
        if dtype == "float32":
            _close(a, p.numpy(), 1e-5, 1e-5, what=f"{name} vs plain")
        else:
            assert float((a - p).abs().max() / p.abs().max()) <= 1e-2


@pytest.mark.parametrize("shape,G,rows", [((1, 96, 2, 3), 2, 10),
                                          ((2, 300, 3, 7), 16, 2048),
                                          ((1, 64, 1, 4), 4, 40),
                                          ((2, 128, 2, 8), 64, 2048)])
def test_dkdv_plan_matches_a_nonzero_list(monkeypatch, shape, G, rows):
    """dkdv_plan (pairs and chunks found in running counts) equals the
    same list built the plain way: ``torch.nonzero`` of the map by
    segment, each segment cut every DKDV_CHUNK_ROWS // G tokens; a map
    with nothing selected gives no pair and no chunk. Bounded by
    ``max_pairs`` (no host sync), the same list leads arrays of the
    bound's size, the chunks past ``first[-1]`` all zero."""
    monkeypatch.setattr(port_bwd, "DKDV_CHUNK_ROWS", rows)
    rng = np.random.default_rng(sum(shape) + G)
    B, T, H, NS = shape
    mask = torch.from_numpy((rng.integers(1, 4, shape)
                             * (rng.random(shape) < 0.3)).astype(np.int32))
    mask[..., -1] = 0                          # a block nobody selects
    per = max(1, rows // G)
    m = mask.permute(0, 2, 3, 1)
    b, h, n, t = torch.nonzero(m).unbind(1)
    seg = (b * H + h) * NS + n
    want_chunks = []
    for s_ in range(B * H * NS):
        idx = torch.nonzero(seg == s_).flatten().tolist()
        want_chunks += [[s_, idx[i], idx[min(i + per, len(idx)) - 1] + 1]
                        for i in range(0, len(idx), per)]
    tok, mult, chunks, first = port_bwd.dkdv_plan(mask, G)
    assert tok.tolist() == t.tolist()
    assert mult.tolist() == m[b, h, n, t].tolist()
    assert chunks.tolist() == want_chunks
    assert all(x.dtype == torch.int32 for x in (tok, mult, chunks, first))
    assert first.tolist() == [0] + torch.bincount(
        chunks[:, 0].long(), minlength=B * H * NS).cumsum(0).tolist()
    n_pairs = t.numel()
    for bound in (n_pairs, n_pairs + 5, mask.numel() + 5):
        btok, bmult, bchunks, bfirst = port_bwd.dkdv_plan(mask, G, bound)
        held = min(bound, mask.numel())
        assert btok.numel() == bmult.numel() == held
        assert btok[:n_pairs].tolist() == tok.tolist()
        assert bmult[:n_pairs].tolist() == mult.tolist()
        assert bfirst.tolist() == first.tolist()
        assert bchunks.shape == (B * H * NS + -(-held // per), 3)
        assert bchunks[:len(want_chunks)].tolist() == want_chunks
        assert not bchunks[len(want_chunks):].any()
    empty = port_bwd.dkdv_plan(torch.zeros_like(mask), G)
    assert [tuple(x.shape) for x in empty] == [(0,), (0,), (0, 3),
                                               (B * H * NS + 1,)]
    assert not empty[3].any()


def test_exports():
    assert port_ops.nsa_fwd_partial_kernel is port.nsa_fwd_partial_kernel
    assert port_ops.nsa_attention is port.nsa_attention
    assert set(port_bwd.launches) == {"nsa_bwd_dkdv", "nsa_bwd_dkdv_sum",
                                      "nsa_bwd_dq"}
    assert "nsa_fwd_partial" in port.launches
