"""The port's entry point for the flagship model, mirroring
``__graft_entry__.entry``: ``entry()`` returns ``(fn, (model, tokens))``
where ``fn(model, tokens)`` is the forward step (logits). It runs on the
card unless the caller passes ``device="cpu"``."""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .models import ModelConfig, forward, init_params

__all__ = ["TINY", "entry"]

# the JAX package's tiny config (__graft_entry__.py:38-42)
TINY = ModelConfig(vocab=64, d_model=64, n_layers=2, n_heads=4, d_ff=128,
                   max_seq=64, dtype=torch.float32, use_flash=True)


def entry(device=None, cfg: ModelConfig = None):
    """Single-device forward step on ``cfg`` (default ``TINY``): weights
    drawn from a seed-0 generator on the device, tokens (2, max_seq) from
    ``np.random.default_rng(0)``."""
    dev = resolve_device(device)
    cfg = TINY if cfg is None else cfg
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, cfg.max_seq))).to(dev)

    def fn(model, tokens):
        return forward(model, tokens)

    return fn, (model, tokens)
