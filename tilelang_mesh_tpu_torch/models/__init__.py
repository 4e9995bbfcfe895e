"""The port's model tier: the flagship transformer
(``models/transformer.py``) on the attention kernels."""

from .transformer import (ModelConfig, Transformer, forward,  # noqa: F401
                          init_params, loss_fn, make_train_step,
                          params_from_jax, params_to_numpy)

__all__ = ["ModelConfig", "Transformer", "forward", "init_params",
           "loss_fn", "make_train_step", "params_from_jax",
           "params_to_numpy"]
