"""Temperature / top-p token sampling for the serving front-end.

The decode step produces an attention output; the workload projects it
onto a logit vector (``DecodeWorkload._logits``) and this module turns
logits into ONE token id. ``temperature=0`` is greedy argmax (the
deterministic default every existing test and soak relies on);
``temperature>0`` scales the logits and samples the softmax, optionally
truncated to the top-p nucleus — the smallest logit set whose
probability mass reaches ``top_p``, renormalized.

Everything is pure and seeded: the engine passes a
``numpy.random.Generator`` derived from ``(request seed, step)``, so a
sampled continuation is reproducible bit-for-bit — which is what makes
the prefix-cache equality tests (restored-prefix decode == cold-prefill
decode, sampled tokens included) possible at all.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["sample_token", "softmax", "top_p_filter"]


def softmax(logits: np.ndarray) -> np.ndarray:
    """Numerically-safe softmax (the online-softmax idiom: subtract the
    max, clamp the normalizer — a fully-underflowed row must yield a
    uniform distribution, never NaN)."""
    x = np.asarray(logits, np.float64)
    x = x - np.max(x)
    e = np.exp(x)
    z = float(e.sum())
    if not np.isfinite(z) or z <= 0.0:
        return np.full(x.shape, 1.0 / x.size)
    return e / z


def top_p_filter(probs: np.ndarray, top_p: float) -> np.ndarray:
    """Zero out everything outside the top-p nucleus and renormalize.
    The nucleus is the smallest probability-sorted set whose cumulative
    mass reaches ``top_p`` (the element crossing the threshold is kept,
    per the standard definition — ``top_p=0`` degenerates to argmax)."""
    if top_p >= 1.0:
        return probs
    order = np.argsort(-probs, kind="stable")
    csum = np.cumsum(probs[order])
    # keep every element up to AND INCLUDING the one crossing top_p
    cut = int(np.searchsorted(csum, max(top_p, 0.0)) + 1)
    keep = order[:max(cut, 1)]
    out = np.zeros_like(probs)
    out[keep] = probs[keep]
    z = float(out.sum())
    return out / z if z > 0 else np.full(probs.shape, 1.0 / probs.size)


def sample_token(logits: np.ndarray, *, temperature: float = 0.0,
                 top_p: float = 1.0,
                 rng: Optional[np.random.Generator] = None) -> int:
    """One token id from a logit vector. ``temperature<=0`` = greedy
    argmax (no rng consumed); otherwise softmax(logits/T) restricted to
    the top-p nucleus, sampled with ``rng``."""
    logits = np.asarray(logits, np.float64).ravel()
    if logits.size == 0:
        raise ValueError("cannot sample from an empty logit vector")
    if not (0.0 < top_p <= 1.0):
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if temperature <= 0.0:
        return int(np.argmax(logits))
    probs = top_p_filter(softmax(logits / temperature), top_p)
    if rng is None:
        rng = np.random.default_rng()
    return int(rng.choice(probs.size, p=probs))
