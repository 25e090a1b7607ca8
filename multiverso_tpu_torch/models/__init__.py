"""Models of the PyTorch port: the Llama-style transformer trainer."""

from .transformer import (TransformerConfig, TransformerTrainer, init_params,
                          lm_loss, params_from_jax, stack_layer_params,
                          transformer_forward)

__all__ = ["TransformerConfig", "TransformerTrainer", "init_params",
           "lm_loss", "params_from_jax", "stack_layer_params",
           "transformer_forward"]
