"""The port's packed varlen attention
(tilelang_mesh_tpu_torch/ops/flash_attention_varlen.py) against the JAX
package's on the same numpy-seeded inputs.

The JAX side runs as tests/test_flash_varlen.py runs it (Pallas interpret
mode on the CPU); the port side runs on CPU tensors, i.e. each kernel's
plain PyTorch version. Tolerances: the host helpers integer for integer;
2e-2 for forward values and the partials (tests/test_flash_varlen.py:67,
which absorbs the interpreter's bf16-like emulation of float32
products); 1e-5 where the port's kernel backward is held against torch
autograd through a dense per-document reference, both exact float32 on
the CPU (the two differ only in the order of the sums). The gradients
against ``jax.grad`` are in tests/test_torch_flash_varlen_grad.py; the
CUDA kernels against the plain versions on the card in
tests/test_torch_cuda.py.
"""

import importlib
import math
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

ref = importlib.import_module("tilelang_mesh_tpu.ops.flash_attention_varlen")
port = importlib.import_module(
    "tilelang_mesh_tpu_torch.ops.flash_attention_varlen")
port_fa = importlib.import_module(
    "tilelang_mesh_tpu_torch.ops.flash_attention")

TOL = 2e-2
_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cu(lens):
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)


def _packed(lens_q, lens_k, Hq, Hkv, D, seed, extra_q=0, extra_k=0):
    """Packed q (total_q, Hq, D), k, v (total_k, Hkv, D), float32 numpy;
    ``extra_*`` rows past cu_seqlens[-1] that belong to no sequence."""
    rng = np.random.default_rng(seed)
    tq, tk = sum(lens_q) + extra_q, sum(lens_k) + extra_k
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((tq, Hq, D), (tk, Hkv, D), (tk, Hkv, D))]


def _both(arrays, dtype):
    """The same values on both sides: rounded to ``dtype`` by JAX, copied
    to torch as float32 and cast back (exact)."""
    jd, td = _DTYPES[dtype]
    js = [jnp.asarray(a, jd) for a in arrays]
    ts = [torch.from_numpy(np.array(j, np.float32)).to(td) for j in js]
    return js, ts


# ---------------------------------------------------------------------------
# host helpers
# ---------------------------------------------------------------------------

SEQ_CASES = [  # (cu_seqlens, t_pad, t_real, fill)
    ([0, 5, 12, 12, 20], 24, 22, -1),     # an empty sequence, a pad tail
    ([0, 3, 9], 16, 9, -2),
    ([0, 7], 8, 8, -1),
    ([0, 0, 4], 8, 3, -2),                # t_real cuts the last sequence
    ([0, 40, 41, 100], 128, 100, -1),
]


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("cu,t_pad,t_real,fill", SEQ_CASES)
def test_seq_ids_match_jax(cu, t_pad, t_real, fill, as_tensor):
    want = ref._seq_ids(np.asarray(cu, np.int32), t_pad, t_real, fill)
    arg = torch.tensor(cu, dtype=torch.int64) if as_tensor else np.array(cu)
    got = port._seq_ids(arg, t_pad, t_real, fill)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)


def _jax_masks(cu_q, cu_k, Tqp, Tkp, tq, tk, causal, align):
    """The JAX package's masks in ``_block_live``'s order (seq_q,
    valid_q, pos_q, seq_k, valid_k, pos_k), with its bottom-right shift
    (flash_attention_varlen.py:431-439) written out."""
    seq_q, pos_q, valid_q = ref._seq_ids(cu_q, Tqp, tq, fill=-1)
    seq_k, pos_k, valid_k = ref._seq_ids(cu_k, Tkp, tk, fill=-2)
    if causal and align == "bottom-right":
        nb = cu_q.shape[0] - 1
        off = ((cu_k[1:] - cu_k[:-1]) - (cu_q[1:] - cu_q[:-1])).astype(
            jnp.int32)
        pos_q = pos_q + jnp.where(seq_q >= 0,
                                  off[jnp.clip(seq_q, 0, nb - 1)], 0)
    return seq_q, valid_q, pos_q, seq_k, valid_k, pos_k


@pytest.mark.parametrize("align", ["top-left", "bottom-right"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("block_M,block_N", [(8, 8), (16, 32), (32, 16),
                                             (24, 40)])
def test_block_live_matches_jax(block_M, block_N, causal, align):
    lens_q, lens_k = [9, 30, 1, 17, 40], [30, 12, 5, 17, 2]
    cu_q, cu_k = _cu(lens_q), _cu(lens_k)
    tq, tk = int(cu_q[-1]) + 2, int(cu_k[-1])
    Tqp, Tkp = -(-tq // block_M) * block_M, -(-tk // block_N) * block_N
    jm = _jax_masks(cu_q, cu_k, Tqp, Tkp, tq, tk, causal, align)
    want = np.asarray(ref._block_live(*jm, block_M, block_N, causal))
    seq_q, pos_q, valid_q = port._seq_ids(cu_q, Tqp, tq, -1)
    seq_k, pos_k, valid_k = port._seq_ids(cu_k, Tkp, tk, -2)
    if causal and align == "bottom-right":
        pos_q = port._bottom_right(pos_q, seq_q, torch.from_numpy(cu_q),
                                   torch.from_numpy(cu_k))
    np.testing.assert_array_equal(pos_q.numpy(), np.asarray(jm[2]))
    got = port._block_live(seq_q, valid_q, pos_q, seq_k, valid_k, pos_k,
                           block_M, block_N, causal)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the causal prune fires somewhere at these lengths, not only the
    # sequence-range test
    if causal and (block_M, block_N) == (8, 8):
        plain = port._block_live(seq_q, valid_q, pos_q, seq_k, valid_k,
                                 pos_k, block_M, block_N, False)
        assert int((plain - got).sum()) > 0


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------

MODES = [(False, "top-left"), (True, "top-left"), (True, "bottom-right")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,align", MODES)
@pytest.mark.parametrize("Hq,Hkv", [(2, 2), (8, 2)])
def test_forward_matches_jax(Hq, Hkv, causal, align, dtype):
    """Unequal q and k lengths (one sequence with more queries than keys,
    whose first bottom-right rows see no key), a pad tail past
    cu_seqlens[-1] on both sides, blocks of 32."""
    lens_q, lens_k = [20, 35, 11], [44, 17, 52]
    arrays = _packed(lens_q, lens_k, Hq, Hkv, 64, seed=Hq, extra_q=5,
                     extra_k=3)
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, dtype)
    cu_q, cu_k = _cu(lens_q), _cu(lens_k)
    want = np.asarray(ref.flash_attention_varlen(
        jq, jk, jv, cu_q, cu_k, causal=causal, block_M=32, block_N=32,
        causal_align=align).astype(jnp.float32))
    got = port.flash_attention_varlen(tq, tk, tv, cu_q, cu_k, causal=causal,
                                      block_M=32, block_N=32,
                                      causal_align=align)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL,
                               atol=TOL)
    assert not got[int(cu_q[-1]):].any()


@pytest.mark.parametrize("causal,align", MODES)
def test_partials_match_jax(causal, align):
    """(acc, m, l) and the normalised output through both packages'
    factories on the same packed operands. Dead rows (pad rows, and the
    bottom-right rows of the first sequence, 12 queries over 5 keys) have
    l == 0 on both sides; there JAX's M depends on its tiling (-1e30 in a
    q-block with a live k-block, -inf in one without), so M is compared
    only where l > 0, and where JAX's l == 0 the port must give l == 0,
    acc == 0 and M in {-inf, -1e30}."""
    Hq, Hkv, D, bM, bN = 4, 2, 64, 32, 32
    lens_q, lens_k = [12, 8], [5, 30]
    cu_q, cu_k = _cu(lens_q), _cu(lens_k)
    Tq, Tk = 64, 64                                 # two blocks each
    tq, tk = int(cu_q[-1]), int(cu_k[-1])
    jm = _jax_masks(cu_q, cu_k, Tq, Tk, tq, tk, causal, align)
    live = ref._block_live(*jm, bM, bN, causal)
    ops = [np.array(x) for x in (jm[0], jm[3], jm[2], jm[5], live)]
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((Hq, Tq, D), (Hkv, Tk, D), (Hkv, Tk, D)))
    sm = 1.0 / math.sqrt(D)
    args = (Hq, Hkv, Tq, Tk, D, bM, bN, causal, sm, "float32")
    want = [np.asarray(w) for w in ref.varlen_fwd_kernel(
        *args, return_partials=True)(q, k, v, *ops)]
    t_ops = [torch.from_numpy(x) for x in (q, k, v, *ops)]
    got = [g.numpy() for g in port.varlen_fwd_kernel(
        *args, return_partials=True)(*t_ops)]
    acc, m, l = got
    live_rows = want[2] > 0
    assert (~live_rows).any() and live_rows.any()
    np.testing.assert_allclose(acc, want[0], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(l, want[2], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(m[live_rows], want[1][live_rows], rtol=TOL,
                               atol=TOL)
    assert (l[~live_rows] == 0).all() and (acc[~live_rows] == 0).all()
    assert np.isin(m[~live_rows], [-np.inf, np.float32(-1e30)]).all()
    o = port.varlen_fwd_kernel(*args)(*t_ops)
    np.testing.assert_allclose(o.numpy(), np.asarray(
        ref.varlen_fwd_kernel(*args)(q, k, v, *ops)), rtol=TOL, atol=TOL)
    assert (o.numpy()[~live_rows] == 0).all()


def _mask_tile_instances(D):
    """The (block_M, block_N) pairs that csrc/attention_mma.cuh's
    mask_tiles builds at head_dim D, read from its source."""
    from tilelang_mesh_tpu_torch.ops._build import CSRC
    src = (CSRC / "attention_mma.cuh").read_text()
    body = src[src.index("int mask_tiles("):]
    body = body[:body.index("\n}\n")]
    by_d = {}
    for d, pairs in re.findall(
            r"(?:D == (\d+)\)|else)\s*return run_tile<([\d, ]+)>", body):
        n = [int(x) for x in pairs.split(",")]
        by_d[int(d) if d else None] = list(zip(n[::2], n[1::2]))
    return by_d.get(D, by_d[None])


@pytest.mark.parametrize("D", [16, 32, 48, 64, 128, 256])
def test_varlen_tile_rule(D):
    """The tensor-core forward's tile, VARLEN_TILES[D], is an instance
    the C source builds (mask_tiles, at the head_dims of
    KERNEL_HEAD_DIMS), the one with the most rows; None without an
    instance."""
    tile = port.varlen_tile(D)
    if D not in port_fa.KERNEL_HEAD_DIMS:
        assert tile is None and D not in port.VARLEN_TILES
        return
    assert tile == port.VARLEN_TILES[D]
    assert tile == max(_mask_tile_instances(D))


# the liveness cells, lengths and Tq != Tk the card tests give the
# tensor-core forward (tests/test_torch_cuda.py, VARLEN_MMA_CASES)
CARD_CASES = [([70, 1, 90], [30, 100, 20], 40, 24),
              ([20, 35, 11, 60], [44, 17, 52, 90], 16, 80),
              ([130, 5], [200, 77], 32, 32)]


@pytest.mark.parametrize("causal,align", MODES)
@pytest.mark.parametrize("case", CARD_CASES)
def test_card_cases_match_jax(case, causal, align):
    """The entry point's plain path against the JAX kernel's at the card
    tests' cells (40 x 24 and 16 x 80: no multiple of the kernel's tiles)
    and lengths, a pad tail of 3 query and 2 key rows, group 2."""
    lens_q, lens_k, bM, bN = case
    arrays = _packed(lens_q, lens_k, 4, 2, 32, seed=bM, extra_q=3,
                     extra_k=2)
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, "float32")
    cu_q, cu_k = _cu(lens_q), _cu(lens_k)
    want = np.asarray(ref.flash_attention_varlen(
        jq, jk, jv, cu_q, cu_k, causal=causal, block_M=bM, block_N=bN,
        causal_align=align))
    got = port.flash_attention_varlen(tq, tk, tv, cu_q, cu_k, causal=causal,
                                      block_M=bM, block_N=bN,
                                      causal_align=align)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    assert not got[int(cu_q[-1]):].any()


def _unsorted(order, T):
    """(seq, pos) int32 numpy ids of T tokens in no order, the card
    tests' three kinds: documents interleaved at random, document 1 in
    every 7th slot of document 0's run, a pack in reverse order."""
    if order == "interleaved":
        seq = np.random.default_rng(T).integers(0, 3, T)
    elif order == "straddling":
        seq = (np.arange(T) % 7 == 3).astype(np.int64)
    else:
        t = np.arange(T - 1, -1, -1)
        return (t // 40).astype(np.int32), (t % 40).astype(np.int32)
    pos = np.zeros(T, np.int64)
    for s_ in np.unique(seq):
        pos[seq == s_] = np.arange((seq == s_).sum())
    return seq.astype(np.int32), pos.astype(np.int32)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("order", ["interleaved", "straddling", "reversed"])
def test_unsorted_ids_match_jax(order, causal):
    """The contract holds for ids in any order: the factories' partials
    and output on unsorted ids (pad ids on the last rows, the liveness
    table from the JAX package's ``_block_live``), M where l > 0."""
    Hq, Hkv, D, Tq, Tk, bM, bN = 4, 2, 32, 96, 64, 32, 32
    sq, pq = _unsorted(order, Tq)
    sk, pk = _unsorted(order, Tk)
    sq[-5:], pq[-5:], sk[-3:], pk[-3:] = -1, 0, -2, 0
    live = np.array(ref._block_live(
        jnp.asarray(sq), jnp.asarray(sq >= 0), jnp.asarray(pq),
        jnp.asarray(sk), jnp.asarray(sk >= 0), jnp.asarray(pk), bM, bN,
        causal))
    rng = np.random.default_rng(21)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((Hq, Tq, D), (Hkv, Tk, D), (Hkv, Tk, D)))
    ops = (sq, sk, pq, pk, live)
    args = (Hq, Hkv, Tq, Tk, D, bM, bN, causal, 1.0 / math.sqrt(D),
            "float32")
    want = [np.asarray(w) for w in ref.varlen_fwd_kernel(
        *args, return_partials=True)(q, k, v, *ops)]
    t_ops = [torch.from_numpy(np.array(x)) for x in (q, k, v, *ops)]
    acc, m, l = (g.numpy() for g in port.varlen_fwd_kernel(
        *args, return_partials=True)(*t_ops))
    seen = want[2] > 0
    assert seen.any() and (~seen).any()
    np.testing.assert_allclose(acc, want[0], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(l, want[2], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(m[seen], want[1][seen], rtol=TOL, atol=TOL)
    assert (l[~seen] == 0).all() and (acc[~seen] == 0).all()
    o = port.varlen_fwd_kernel(*args)(*t_ops)
    np.testing.assert_allclose(o.numpy(), np.asarray(
        ref.varlen_fwd_kernel(*args)(q, k, v, *ops)), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("order", ["interleaved", "straddling", "reversed"])
def test_unsorted_ids_backward_match_jax(order, causal):
    """The backward's contract holds for ids in any order: the dK/dV and
    dQ factories on unsorted ids (pad ids on the last rows, the liveness
    table from the JAX package's ``_block_live``), lse2 and delta from
    the JAX partials: -inf lse2 on the rows that see no key, whose P the
    select keeps at 0."""
    Hq, Hkv, D, Tq, Tk, bM, bN = 4, 2, 32, 96, 64, 32, 32
    sq, pq = _unsorted(order, Tq)
    sk, pk = _unsorted(order, Tk)
    sq[-5:], pq[-5:], sk[-3:], pk[-3:] = -1, 0, -2, 0
    live = np.array(ref._block_live(
        jnp.asarray(sq), jnp.asarray(sq >= 0), jnp.asarray(pq),
        jnp.asarray(sk), jnp.asarray(sk >= 0), jnp.asarray(pk), bM, bN,
        causal))
    rng = np.random.default_rng(21)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32)
                   for s in ((Hq, Tq, D), (Hkv, Tk, D), (Hkv, Tk, D),
                             (Hq, Tq, D)))
    ops = (sq, sk, pq, pk, live)
    args = (Hq, Hkv, Tq, Tk, D, bM, bN, causal, 1.0 / math.sqrt(D),
            "float32")
    acc, m, l = (np.array(w) for w in ref.varlen_fwd_kernel(
        *args, return_partials=True)(q, k, v, *ops))
    seen = l > 0
    assert seen.any() and (~seen).any()
    with np.errstate(divide="ignore"):
        lse2 = (m + np.log2(l)).astype(np.float32)
    assert np.isneginf(lse2[~seen]).all()
    o = np.where(seen[..., None], acc / np.where(seen, l, 1)[..., None], 0)
    delta = (do * o).sum(-1).astype(np.float32)
    bwd = (q, k, v, do, lse2, delta, *ops)
    want = [np.asarray(w) for w in (
        *ref.varlen_bwd_dkdv_kernel(*args)(*bwd),
        ref.varlen_bwd_dq_kernel(*args)(*bwd))]
    t_bwd = [torch.from_numpy(np.array(x)) for x in bwd]
    got = [g.numpy() for g in (*port.varlen_bwd_dkdv_kernel(*args)(*t_bwd),
                               port.varlen_bwd_dq_kernel(*args)(*t_bwd))]
    for name, g, w in zip(("dK", "dV", "dQ"), got, want):
        assert np.isfinite(g).all() and g.any(), name
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL,
                                   err_msg=f"{name} ({order}, {causal})")


def test_padded_rows_zero():
    """Rows between cu_seqlens[-1] and the packed tensor's end come back
    zero (tests/test_flash_varlen.py::test_varlen_padded_rows_zero)."""
    q, k, v = map(torch.from_numpy, _packed([20, 10], [20, 10], 2, 2, 64,
                                            seed=9, extra_q=10, extra_k=10))
    cu = np.array([0, 20, 30], np.int32)
    out = port.flash_attention_varlen(q, k, v, cu, cu, block_M=32,
                                      block_N=32)
    assert out.shape == q.shape and not out[30:].any() and out[:30].any()


def _dense_reference(q, k, v, cu_q, cu_k, causal, align, sm_scale):
    """Per-sequence dense softmax attention in float32, torch autograd
    through it; rows outside every sequence and rows that see no key
    give 0."""
    group = q.shape[1] // k.shape[1]
    out = torch.zeros_like(q)
    rows = []
    for b in range(len(cu_q) - 1):
        qi = q[cu_q[b]:cu_q[b + 1]].transpose(0, 1)
        ki = k[cu_k[b]:cu_k[b + 1]].repeat_interleave(group, 1)
        vi = v[cu_k[b]:cu_k[b + 1]].repeat_interleave(group, 1)
        s = qi @ ki.permute(1, 2, 0) * sm_scale
        lq, lk = s.shape[1:]
        if causal:
            shift = lk - lq if align == "bottom-right" else 0
            see = (torch.arange(lq)[:, None] + shift
                   >= torch.arange(lk)[None, :])
            s = s.masked_fill(~see, -math.inf)
        p = torch.softmax(s, dim=-1).nan_to_num(0.0)
        rows.append((p @ vi.transpose(0, 1)).transpose(0, 1))
    return out.index_put((torch.arange(int(cu_q[-1])),),
                         torch.cat(rows)) if rows else out


@pytest.mark.parametrize("causal,align", MODES)
@pytest.mark.parametrize("Hq,Hkv", [(2, 2), (6, 2)])
def test_kernel_backward_matches_dense_autograd(Hq, Hkv, causal, align):
    """The entry's kernel path on CPU tensors (the partial forward, the
    plain dK/dV and dQ) against torch autograd through the dense
    per-sequence reference, exact float32."""
    lens_q, lens_k = [18, 30, 9], [41, 26, 9]
    q, k, v = _packed(lens_q, lens_k, Hq, Hkv, 16, seed=11, extra_q=3,
                      extra_k=2)
    g = np.random.default_rng(12).standard_normal(q.shape).astype(np.float32)
    cu_q, cu_k = _cu(lens_q), _cu(lens_k)
    grads = []
    for fn in (lambda *a: port.flash_attention_varlen(
                   *a, cu_q, cu_k, causal=causal, block_M=16, block_N=16,
                   causal_align=align),
               lambda *a: _dense_reference(*a, cu_q, cu_k, causal, align,
                                           0.25)):
        leaves = [torch.from_numpy(a.copy()).requires_grad_()
                  for a in (q, k, v)]
        out = fn(*leaves)
        out.backward(torch.from_numpy(g))
        grads.append((out.detach(), *(t.grad for t in leaves)))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_gradients_stay_in_their_document():
    """The gradient of one document's output reaches no q, k or v row of
    another document, nor the pad tail: exactly 0 there."""
    lens = [30, 17, 25]
    cu = _cu(lens)
    q, k, v = _packed(lens, lens, 4, 2, 16, seed=13, extra_q=4, extra_k=4)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = port.flash_attention_varlen(*leaves, cu, cu, causal=True,
                                      block_M=16, block_N=16)
    g = torch.zeros_like(out)
    g[cu[1]:cu[2]] = 1.0
    out.backward(g)
    for t in leaves:
        assert t.grad[cu[1]:cu[2]].any()
        assert not t.grad[:cu[1]].any() and not t.grad[cu[2]:].any()


def test_matches_flash_attention_on_one_sequence():
    """One full-length sequence is the port's dense flash_attention
    (tests/test_flash_varlen.py::test_varlen_matches_dense_when_full)."""
    q, k, v = map(torch.from_numpy, _packed([64], [64], 2, 2, 64, seed=14))
    cu = np.array([0, 64], np.int32)
    got = port.flash_attention_varlen(q, k, v, cu, cu, causal=True,
                                      block_M=32, block_N=32)
    dense = port_fa.flash_attention(*(t.transpose(0, 1)[None]
                                      for t in (q, k, v)), causal=True)
    torch.testing.assert_close(got, dense[0].transpose(0, 1), rtol=1e-5,
                               atol=1e-5)


def test_plain_versions_take_rows_in_chunks(monkeypatch):
    """A plain version scores PLAIN_ROWS query rows at a time: smaller
    chunks compute the same function."""
    lens = [50, 31, 19]
    cu = _cu(lens)
    q, k, v = _packed(lens, lens, 4, 2, 16, seed=15, extra_q=5, extra_k=5)
    g = torch.from_numpy(np.random.default_rng(16).standard_normal(
        q.shape).astype(np.float32))
    runs = []
    for rows in (port.PLAIN_ROWS, 7):
        monkeypatch.setattr(port, "PLAIN_ROWS", rows)
        leaves = [torch.from_numpy(a.copy()).requires_grad_()
                  for a in (q, k, v)]
        out = port.flash_attention_varlen(*leaves, cu, cu, causal=True,
                                          block_M=16, block_N=16)
        out.backward(g)
        runs.append((out.detach(), *(t.grad for t in leaves)))
    for a, b in zip(*runs):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_cu_seqlens_as_numpy_or_tensor():
    lens = [10, 22]
    q, k, v = map(torch.from_numpy, _packed(lens, lens, 2, 1, 32, seed=17))
    cu = _cu(lens)
    a = port.flash_attention_varlen(q, k, v, cu, cu, causal=True)
    b = port.flash_attention_varlen(q, k, v, torch.from_numpy(cu),
                                    torch.from_numpy(cu).long(), causal=True)
    assert torch.equal(a, b)


def test_no_grad_runs_the_forward_alone(monkeypatch):
    calls = []
    monkeypatch.setattr(port, "varlen_fwd_partial", lambda *a: calls.append(
        "partial") or port.varlen_fwd_partial_plain(*a))
    q, k, v = map(torch.from_numpy, _packed([9], [9], 2, 2, 16, seed=18))
    cu = np.array([0, 9], np.int32)
    port.flash_attention_varlen(q, k, v, cu, cu, causal=True)
    assert calls == []
    with torch.no_grad():
        port.flash_attention_varlen(q.requires_grad_(), k, v, cu, cu)
    assert calls == []


def test_refusals():
    q, k, v = map(torch.from_numpy, _packed([8], [8], 3, 2, 16, seed=19))
    cu = np.array([0, 8], np.int32)
    with pytest.raises(ValueError, match="causal_align"):
        port.flash_attention_varlen(q, q, q, cu, cu, causal=True,
                                    causal_align="center")
    with pytest.raises(ValueError, match="not a multiple"):
        port.flash_attention_varlen(q, k, v, cu, cu)
    # a dense reference cannot see the document masks: refused with and
    # without autograd, as the JAX package's vjp refuses it when made
    for t in (q, q.clone().requires_grad_()):
        with pytest.raises(ValueError, match="reference"):
            port.flash_attention_varlen(t, q, q, cu, cu,
                                        backward="reference")
    with pytest.raises(ValueError, match="backward"):
        port.flash_attention_varlen(q, q, q, cu, cu, backward="dense")
    with pytest.raises(ValueError, match="multiple"):
        port.varlen_fwd_kernel(4, 2, 60, 64, 16, 32, 32, True, 0.25,
                               "float32")
    fn = port.varlen_bwd_dq_kernel(2, 2, 32, 32, 16, 32, 32, True, 0.25,
                                   "float32")
    with pytest.raises(ValueError, match="bound"):
        fn(*[torch.zeros(1)] * 11)
