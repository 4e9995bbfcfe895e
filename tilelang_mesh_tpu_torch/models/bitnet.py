"""BitNet b1.58's FFN block on the int8 x ternary kernel.

Counterpart of the JAX package's ``examples/bitnet-1.58b/example_bitnet.py``
(the JAX package has no BitNet transformer; its BitNet path is
``ops/bitnet.py``'s ``bitnet_linear`` and this block): ``BitFFN`` is
gate, up and down BitLinears with squared-ReLU gating,
``down(relu(gate(x))**2 * up(x))``, each BitLinear the kernels'
``bitnet_linear`` (per-token int8 activations, the int8 x ternary GEMM,
the scales out). ``reference=True`` runs ``bitnet_linear_reference`` on
the unpacked ternary weights instead, as the example's does.

``weight_quant_ternary`` is the example's weight quantiser (BitLinear's
absmean ternarisation), kept here so the port needs nothing of the JAX
package; ``bitffn_from_jax`` carries the example's ``BitFFN`` state
across. The module lives on the card unless ``device`` says otherwise;
there its forward launches ``bitnet_gemm`` three times and runs no plain
version.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..ops.bitnet import bitnet_linear, bitnet_linear_reference, pack_ternary

__all__ = ["weight_quant_ternary", "BitFFN", "bitffn_from_jax"]

_LINEARS = ("gate", "up", "down")


def weight_quant_ternary(w: np.ndarray):
    """BitLinear's ``weight_quant``: scale by 1 / mean |w|, round and
    clip to {-1, 0, 1}; returns ``(ternary int8, w_scale)``."""
    scale = 1.0 / max(np.abs(w).mean(), 1e-5)
    tern = np.clip(np.round(w * scale), -1, 1).astype(np.int8)
    return tern, scale


def _draw_state(d_model: int, d_ff: int, seed: int):
    """The example's weights: ``standard_normal(shape) / sqrt(fan_in)``
    from one ``default_rng(seed)`` in the order gate, up, down."""
    rng = np.random.default_rng(seed)
    packed, scales, ternary = {}, {}, {}
    for name, shape in (("gate", (d_model, d_ff)), ("up", (d_model, d_ff)),
                        ("down", (d_ff, d_model))):
        w = (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(
            np.float32)
        tern, scale = weight_quant_ternary(w)
        packed[name] = pack_ternary(tern)
        scales[name] = scale
        ternary[name] = tern
    return packed, scales, ternary


class BitFFN(nn.Module):
    """gate/up/down BitLinear FFN with squared ReLU (BitNet b1.58's block).

    ``BitFFN(d_model, d_ff, seed)`` draws its weights as the example
    does; ``state=(packed, scales, ternary)`` (three dicts keyed gate, up,
    down: packed (K/4, N) int8, Python or numpy float scales, ternary
    (K, N) int8) loads given ones instead. The packed and ternary weights
    are buffers on ``device`` (``None``: the card).
    """

    def __init__(self, d_model: int, d_ff: int, seed: int = 0,
                 device=None, state=None):
        super().__init__()
        dev = resolve_device(device)
        packed, scales, ternary = state if state is not None else \
            _draw_state(d_model, d_ff, seed)
        for name, (K, N) in zip(_LINEARS, ((d_model, d_ff), (d_model, d_ff),
                                           (d_ff, d_model))):
            if tuple(ternary[name].shape) != (K, N) \
                    or tuple(packed[name].shape) != (K // 4, N):
                raise ValueError(
                    f"{name}: ternary {tuple(ternary[name].shape)} and "
                    f"packed {tuple(packed[name].shape)} do not fit "
                    f"({K}, {N})")
            self.register_buffer(f"packed_{name}", torch.as_tensor(
                np.ascontiguousarray(packed[name])).to(dev))
            self.register_buffer(f"ternary_{name}", torch.as_tensor(
                np.ascontiguousarray(ternary[name])).to(dev))
        self.scales = {name: float(scales[name]) for name in _LINEARS}

    def _linear(self, x, name, reference):
        if reference:
            return bitnet_linear_reference(
                x, getattr(self, f"ternary_{name}"), self.scales[name])
        return bitnet_linear(x, getattr(self, f"packed_{name}"),
                             self.scales[name])

    def forward(self, x: torch.Tensor, reference: bool = False):
        g = self._linear(x, "gate", reference)
        u = self._linear(x, "up", reference)
        h = torch.square(torch.clamp_min(g, 0.0)) * u  # squared-ReLU gating
        return self._linear(h, "down", reference)


def bitffn_from_jax(packed, scales, ternary, device=None) -> BitFFN:
    """The JAX example's ``BitFFN`` state (its ``packed``, ``scales`` and
    ``ternary`` dicts) as the port's module on ``device`` (``None``: the
    card)."""
    d_model, d_ff = np.shape(ternary["gate"])
    return BitFFN(d_model, d_ff, device=device,
                  state=(packed, scales, ternary))
