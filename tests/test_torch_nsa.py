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


# ---------------------------------------------------------------------------
# the 16-bit kernels' structure, emulated: decode's split over the slots
# and its fixed-order combine, and the per-warp key streams' merge
# ---------------------------------------------------------------------------

# float32 is held at 1e-5 (the emulation and the JAX kernel in interpret
# mode both compute in float32), bfloat16 at TOL
_SPLIT_TOL = {"float32": 1e-5, "bfloat16": TOL}

# (B, Tk, HQ, H, D, S, BS, splits): G 1, 4, 16, 64; splits below S, one
# a slot, and more than S (runs that hold no slot at all)
DECODE_SPLITS = {"g1": (2, 64, 2, 2, 16, 5, 16, 2),
                 "g4": (2, 96, 8, 2, 32, 6, 16, 3),
                 "g16": (1, 128, 16, 1, 32, 4, 32, 4),
                 "g64": (1, 64, 64, 1, 16, 6, 8, 9)}


def _decode_inputs(B, Tk, HQ, H, D, S, BS, seed):
    """Decode inputs as numpy: ids in [-1, blocks) (runs of -1 slots),
    counts in [0, S] with the first row's 0 (it selects nothing)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, HQ, D)).astype(np.float32)
    k = rng.standard_normal((B, Tk, H, D)).astype(np.float32)
    v = rng.standard_normal((B, Tk, H, D)).astype(np.float32)
    g = rng.uniform(0.2, 1.0, (B, HQ)).astype(np.float32)
    bi = rng.integers(-1, -(-Tk // BS), (B, H, S)).astype(np.int32)
    bi[..., 1:3] = -1
    cnt = rng.integers(1, S + 1, (B, H)).astype(np.int32)
    cnt[0, 0] = 0
    return q, k, v, g, bi, cnt


def _decode_split(case, dtype, seed=31, Tk=None):
    B, Tk0, HQ, H, D, S, BS, splits = DECODE_SPLITS[case]
    Tk = Tk0 if Tk is None else Tk
    q, k, v, g, bi, cnt = _decode_inputs(B, Tk, HQ, H, D, S, BS, seed)
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v, dtype)
    G = HQ // H
    args = (tq.reshape(B, H, G, D), tk.transpose(1, 2), tv.transpose(1, 2),
            torch.from_numpy(bi), torch.from_numpy(cnt),
            torch.from_numpy(g).reshape(B, H, G), BS, D ** -0.5)
    got = port.nsa_decode_split_plain(*args, splits).reshape(B, HQ, D)
    return (q, k, v, g, bi, cnt), (jq, jk, jv), args, got, splits


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(DECODE_SPLITS))
def test_decode_split_emulation_matches_jax(case, dtype):
    """Per-split partials, their fixed-order combine and the gate equal
    the JAX decode kernel; a row with block_counts 0 is exactly 0, and
    the split changes nothing beyond rounding (the unsplit plain
    version, every split count)."""
    (q, k, v, g, bi, cnt), (jq, jk, jv), args, got, splits = _decode_split(
        case, dtype)
    BS = args[6]
    want = ref.nsa_decode(jq, jk, jv, jnp.asarray(g), jnp.asarray(bi),
                          block_counts=jnp.asarray(cnt), block_size=BS)
    _close(got, want, _SPLIT_TOL[dtype])
    G = args[0].shape[2]
    assert not got[0, :G].any()                  # counts 0: exactly 0
    whole = port.nsa_decode_fwd_plain(*args)
    S = bi.shape[-1]
    for n in (1, splits, S, S + 3):
        _close(port.nsa_decode_split_plain(*args, n), whole.float().numpy(),
               _SPLIT_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_split_emulation_ragged_length(dtype):
    """Tk 77 with blocks of 16 (the last block partial): against the JAX
    package's dense reference at the last token (the JAX kernel's block
    copy reads past Tk there)."""
    (q, k, v, g, bi, cnt), (jq, jk, jv), args, got, _ = _decode_split(
        "g4", dtype, seed=32, Tk=77)
    B, HQ, D = q.shape
    Tk, H, S = k.shape[1], k.shape[2], bi.shape[-1]
    g_full = np.zeros((B, Tk, HQ), np.float32)
    g_full[:, -1] = g
    counts = np.broadcast_to(cnt[:, None], (B, Tk, H)).copy()
    want = ref.nsa_reference(
        jnp.broadcast_to(jq[:, None], (B, Tk, HQ, D)), jk, jv,
        jnp.asarray(g_full), jnp.zeros((B, Tk, HQ)),
        jnp.asarray(np.broadcast_to(bi[:, None], (B, Tk, H, S)).copy()),
        block_counts=jnp.asarray(counts), block_size=args[6])[:, -1]
    _close(got, want, _SPLIT_TOL[dtype])


def test_decode_splits_cover_the_card():
    """decode_splits: every run holds at least one slot, the blocks of
    all runs but one fit the resident count, and chip_smoke.py's widths
    (B 8, 4 KV heads, 16 slots) give more blocks than B H."""
    for B, H, S, resident in [(8, 4, 16, 264), (8, 4, 16, 660),
                              (1, 1, 16, 264), (64, 8, 16, 264),
                              (2, 3, 5, 1), (1, 2, 0, 264)]:
        n = port.decode_splits(B, H, S, resident)
        per = -(-S // n) if S else 1
        assert n >= 1 and (S == 0 or (n - 1) * per < S)
        assert n == 1 or B * H * (n - 1) < resident      # one wave
    assert port.decode_splits(8, 4, 16, 264) == 8
    assert 8 * 4 * port.decode_splits(8, 4, 16, 264) > 8 * 4


def test_decode_partials_and_combine_on_the_cpu():
    """The two launches' plain versions through the wrappers on CPU
    tensors: partials of shape (B, H, splits, G[, D]), m floored at
    -1e30 with l 0 in runs that select nothing, the combine launching
    nothing; the decode entry itself runs the unsplit plain version."""
    _, _, args, got, splits = _decode_split("g4", "float32")
    q4, kh, vh, bi, cnt, g, BS, sm = args
    before = dict(port.launches)
    acc, m, l = port.nsa_decode_partials(q4, kh, vh, bi, cnt, BS, sm, splits)
    B, H, G, D = q4.shape
    assert acc.shape == (B, H, splits, G, D) and m.shape == l.shape \
        == (B, H, splits, G)
    dead = l == 0
    assert bool(dead.any()) and bool((m[dead] == -1e30).all()) \
        and not acc[dead].any()
    o = port.nsa_decode_combine(acc, m, l, g, q4.dtype)
    torch.testing.assert_close(o.reshape(got.shape), got)
    assert port.launches == before
    assert torch.equal(port.nsa_decode_fwd(*args),
                       port.nsa_decode_fwd_plain(*args))
    assert port.launches == before
    with pytest.raises(ValueError, match="splits"):
        port.nsa_decode_partials(q4, kh, vh, bi, cnt, BS, sm, 0)


# (streams, chunk): four warps of 16 keys (a group of up to 16), chunks
# smaller than a block, one stream (groups of 17 to 64)
STREAMS = {"four_streams": (4, 16), "small_chunks": (4, 4),
           "one_stream": (1, 16)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("walk", sorted(STREAMS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_stream_merge_emulation_matches_jax(case, walk, dtype):
    """The 16-bit kernels' walk: each branch's keys in chunks dealt to
    key streams, an online softmax each, merged in stream order, equals
    the JAX fused forward."""
    shape, window, seed = CASES[case]
    B, T, HQ, H, D, S, BS = shape
    G = HQ // H
    q, k, v, gs, gw, bi = _inputs(*shape, seed=seed)
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v, dtype)
    want = ref.nsa_attention(jq, jk, jv, jnp.asarray(gs), jnp.asarray(gw),
                             jnp.asarray(bi), block_size=BS,
                             window_size=window)
    streams, chunk = STREAMS[walk]
    got = port.nsa_fwd_streams_plain(
        tq.reshape(B, T, H, G, D), tk.transpose(1, 2), tv.transpose(1, 2),
        torch.from_numpy(bi), torch.full((B, T, H), S, dtype=torch.int32),
        torch.from_numpy(gs).reshape(B, T, H, G),
        torch.from_numpy(gw).reshape(B, T, H, G), BS, window, D ** -0.5,
        streams, chunk)
    _close(got.reshape(B, T, HQ, D), want, _SPLIT_TOL[dtype])


def test_merge_partials_fixed_order():
    """merge_partials: a state that saw nothing (m -inf or -1e30, l 0)
    weighs nothing, all empty gives 0, and any cut of one softmax's keys
    merges back to it."""
    rng = np.random.default_rng(5)
    s = torch.from_numpy(rng.standard_normal((3, 12)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((12, 4)).astype(np.float32))
    m = s.amax(-1)
    p = torch.exp2(s - m[:, None])
    whole = (p @ v, m, p.sum(-1))
    cuts = [slice(0, 5), slice(5, 5), slice(5, 12)]
    parts = []
    for c in cuts:
        sc = s[:, c]
        mc = sc.amax(-1) if sc.shape[1] else torch.full((3,), -np.inf)
        pc = torch.exp2(sc - mc[:, None]) if sc.shape[1] else sc
        parts.append((pc @ v[c], mc, pc.sum(-1)))
    merged = port.merge_partials(*(torch.stack(x, 1) for x in zip(*parts)), 1)
    for a, b in zip(merged, whole):
        torch.testing.assert_close(a, b)
    empty = port.merge_partials(torch.zeros(2, 3, 4),
                                torch.full((2, 3), -1e30),
                                torch.zeros(2, 3), 1)
    assert not empty[0].any() and not empty[2].any()
