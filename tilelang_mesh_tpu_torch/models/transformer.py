"""Flagship model: a LLaMA-style decoder on the port's attention kernels.

Counterpart of ``tilelang_mesh_tpu/models/transformer.py`` (single
device): pre-RMSNorm blocks (eps 1e-6), half-split RoPE, multi-head
causal attention on ``ops/flash_attention.py`` (the CUDA kernels on the
card), a SwiGLU MLP and float32 logits tied to the embedding. The large
products are ``torch.matmul``, as the JAX package leaves them to XLA.

Parameters keep the JAX package's names and its ``x @ W`` layout, so a
JAX params tree converts by copying (``params_from_jax`` /
``params_to_numpy``). Entry points run on the card unless the caller
passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.flash_attention import _reference_attention, flash_attention

__all__ = ["ModelConfig", "Transformer", "init_params", "params_from_jax",
           "params_to_numpy", "forward", "loss_fn", "make_train_step"]

_LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate",
               "w_up", "w_down")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab: int = 256
    d_model: int = 128
    n_layers: int = 2
    n_heads: int = 8
    d_ff: int = 384
    max_seq: int = 128
    dtype: Any = torch.float32     # a torch dtype or its name
    rope_theta: float = 10000.0
    use_flash: bool = True   # attention kernels vs the dense reference

    def __post_init__(self):
        dt = self.dtype
        if isinstance(dt, str):
            dt = getattr(torch, dt.replace("torch.", ""), None)
        if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
            raise TypeError(f"dtype must be a floating torch dtype or its "
                            f"name, got {self.dtype!r}")
        object.__setattr__(self, "dtype", dt)
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} is not a multiple of "
                             f"n_heads {self.n_heads}")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


class _Layer(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        shapes = {"attn_norm": (d,), "wq": (d, d), "wk": (d, d),
                  "wv": (d, d), "wo": (d, d), "mlp_norm": (d,),
                  "w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}
        for name in _LAYER_KEYS:
            setattr(self, name, nn.Parameter(torch.empty(
                shapes[name], dtype=cfg.dtype, device=device)))


class Transformer(nn.Module):
    """The model's parameters under the JAX package's names: ``embed``
    (vocab, d), ``final_norm`` (d) and ``layers[i].{attn_norm, wq, wk,
    wv, wo, mlp_norm, w_gate, w_up, w_down}``. Weights are drawn as
    :func:`init_params` draws them, from ``generator`` (a seed-0 CPU
    generator when None)."""

    def __init__(self, cfg: ModelConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(
            (cfg.vocab, cfg.d_model), dtype=cfg.dtype, device=dev))
        self.final_norm = nn.Parameter(torch.empty(
            (cfg.d_model,), dtype=cfg.dtype, device=dev))
        self.layers = nn.ModuleList(_Layer(cfg, dev)
                                    for _ in range(cfg.n_layers))
        self._draw(torch.Generator().manual_seed(0) if generator is None
                   else generator)

    @torch.no_grad()
    def _draw(self, g: torch.Generator) -> None:
        d, f = self.cfg.d_model, self.cfg.d_ff

        def dense(p, scale):
            p.copy_(torch.randn(p.shape, generator=g, device=g.device,
                                dtype=torch.float32) * scale)

        dense(self.embed, 1.0)
        self.final_norm.fill_(1.0)
        for lp in self.layers:
            lp.attn_norm.fill_(1.0)
            lp.mlp_norm.fill_(1.0)
            for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up"):
                dense(getattr(lp, name), d ** -0.5)
            dense(lp.w_down, f ** -0.5)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self, tokens)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Transformer:
    """A model with the JAX ``init_params`` distributions: every
    projection but ``w_down`` ~ N(0, 1) * d**-0.5, ``w_down`` ~ N(0, 1) *
    d_ff**-0.5, ``embed`` ~ N(0, 1), norms 1; drawn in float32 from
    ``generator`` (on its own device) and cast to ``cfg.dtype``. The
    draws are not JAX's threefry: carry JAX weights over with
    :func:`params_from_jax`."""
    return Transformer(cfg, device=device, generator=generator)


def _from_numpy(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":    # ml_dtypes' bfloat16, as JAX hands it
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def params_from_jax(tree: Dict, cfg: ModelConfig, device=None) -> Transformer:
    """The port's model holding a JAX params tree of numpy arrays
    ``{"embed", "final_norm", "layers": [{attn_norm, wq, ...}]}``; the
    layouts agree, so each array is copied as it is."""
    if len(tree["layers"]) != cfg.n_layers:
        raise ValueError(f"tree has {len(tree['layers'])} layers, cfg "
                         f"{cfg.n_layers}")
    model = Transformer(cfg, device=device)
    with torch.no_grad():
        pairs = [(model.embed, tree["embed"]),
                 (model.final_norm, tree["final_norm"])]
        for lp, lt in zip(model.layers, tree["layers"]):
            pairs += [(getattr(lp, n), lt[n]) for n in _LAYER_KEYS]
        for p, a in pairs:
            t = _from_numpy(a)
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"shape {tuple(t.shape)} does not fit "
                                 f"{tuple(p.shape)}")
            p.copy_(t)
    return model


def params_to_numpy(model: Transformer) -> Dict:
    """The JAX-shaped params tree of numpy arrays (bfloat16 widened to
    float32, which numpy lacks)."""
    def arr(p):
        t = p.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()

    return {"embed": arr(model.embed), "final_norm": arr(model.final_norm),
            "layers": [{n: arr(getattr(lp, n)) for n in _LAYER_KEYS}
                       for lp in model.layers]}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _rms_norm(x, w, eps=1e-6):
    v = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(v + eps)).to(x.dtype) * w


def _rope(x, theta: float):
    # x: (B, H, S, hd); half-split rotation, not interleaved
    hd, S = x.shape[-1], x.shape[2]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = torch.outer(torch.arange(S, dtype=torch.float32, device=x.device),
                      freqs)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _attention(x, lp, cfg: ModelConfig):
    B, S, _ = x.shape
    hd = cfg.head_dim
    n_heads = lp.wq.shape[1] // hd
    h = _rms_norm(x, lp.attn_norm)

    def proj(w):
        return torch.matmul(h, w).reshape(B, S, n_heads, hd).transpose(1, 2)

    q, k, v = proj(lp.wq), proj(lp.wk), proj(lp.wv)
    q, k = _rope(q, cfg.rope_theta), _rope(k, cfg.rope_theta)
    if cfg.use_flash:
        o = flash_attention(q, k, v, causal=True)
    else:
        o = _reference_attention(q, k, v, True, 1.0 / math.sqrt(hd))
    o = torch.matmul(o.transpose(1, 2).reshape(B, S, n_heads * hd), lp.wo)
    return x + o.to(x.dtype)


def _mlp(x, lp):
    h = _rms_norm(x, lp.mlp_norm)
    g = F.silu(torch.matmul(h, lp.w_gate))
    y = torch.matmul(g * torch.matmul(h, lp.w_up), lp.w_down)
    return x + y.to(x.dtype)


def forward(model: Transformer, tokens: torch.Tensor,
            cfg: Optional[ModelConfig] = None) -> torch.Tensor:
    """tokens (B, S) int -> logits (B, S, vocab) float32. ``cfg``
    defaults to the model's own (pass one to run the same weights
    through the other attention path)."""
    cfg = model.cfg if cfg is None else cfg
    x = model.embed[tokens.long()].to(cfg.dtype)
    for lp in model.layers:
        x = _mlp(_attention(x, lp, cfg), lp)
    x = _rms_norm(x, model.final_norm)
    return torch.matmul(x.float(), model.embed.float().t())


def loss_fn(model: Transformer, tokens: torch.Tensor,
            cfg: Optional[ModelConfig] = None) -> torch.Tensor:
    """Next-token cross entropy, mean over the batch: logsumexp of the
    logits minus the gold logit."""
    logits = forward(model, tokens[:, :-1], cfg)
    gold = torch.gather(logits, -1, tokens[:, 1:, None].long())[..., 0]
    return (torch.logsumexp(logits, dim=-1) - gold).mean()


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def make_train_step(cfg: ModelConfig, lr: float = 3e-4):
    """Single-device training step: ``init(model) -> opt`` and
    ``step(model, opt, tokens) -> (model, opt, loss)``.

    The optimizer is AdamW with optax ``adamw``'s defaults, set
    explicitly (betas (0.9, 0.999), eps 1e-8, weight decay 1e-4, not
    torch's 1e-2). Unlike the JAX step, the update is in place: the
    model's parameters and the optimizer's state change, and the same
    objects are returned. ``loss`` is the step's loss before the update,
    a 0-d tensor on the model's device.
    """
    def init(model: Transformer) -> torch.optim.AdamW:
        return torch.optim.AdamW(model.parameters(), lr=lr,
                                 betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=1e-4)

    def step(model: Transformer, opt: torch.optim.Optimizer,
             tokens: torch.Tensor):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model, tokens, cfg)
        loss.backward()
        opt.step()
        return model, opt, loss.detach()

    return init, step
