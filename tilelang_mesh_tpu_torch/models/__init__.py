"""The port's model tier: the flagship transformer
(``models/transformer.py``) on the attention kernels, and BitNet b1.58's
FFN block (``models/bitnet.py``) on the int8 x ternary kernel."""

from .bitnet import BitFFN, bitffn_from_jax, weight_quant_ternary  # noqa: F401
from .transformer import (ModelConfig, Transformer, forward,  # noqa: F401
                          init_params, loss_fn, make_train_step,
                          params_from_jax, params_to_numpy)

__all__ = ["BitFFN", "bitffn_from_jax", "weight_quant_ternary",
           "ModelConfig", "Transformer", "forward", "init_params",
           "loss_fn", "make_train_step", "params_from_jax",
           "params_to_numpy"]
