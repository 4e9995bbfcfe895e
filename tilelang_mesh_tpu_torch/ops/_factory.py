"""The JAX package's kernel factories, on the port's ops.

A JAX factory (``decode_kernel(B, H, S, D, ...)`` and the like) compiles
one kernel for one shape and type and returns it; the caller then passes
the operands alone. The port's factories keep that contract on top of
its ops: :func:`bind` returns the op behind a check that each operand
has the shape and type the factory was given, so a call with other
operands raises as the JAX kernel refuses them. The TPU's tile hints
(``block_*``, ``num_stages``) are accepted by each factory and ignored:
the CUDA kernels pick their own tiles.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

__all__ = ["bind"]

Spec = Tuple[Tuple[int, ...], Optional[torch.dtype]]


def bind(name: str, specs: Sequence[Spec], op: Callable) -> Callable:
    """``fn(*operands) -> op(*operands)`` for operands of the shapes and
    types in ``specs`` (a type of None takes any); other operands raise
    ``ValueError``."""
    specs = [(tuple(int(n) for n in shape), dtype) for shape, dtype in specs]

    def fn(*operands):
        got = [(tuple(t.shape), t.dtype) for t in operands]
        if len(got) != len(specs) or any(
                shape != g[0] or (dtype is not None and dtype != g[1])
                for (shape, dtype), g in zip(specs, got)):
            raise ValueError(f"{name} is bound to {specs}, called with "
                             f"{got}")
        return op(*operands)

    fn.__name__ = name
    return fn
