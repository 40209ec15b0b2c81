"""Model zoo of the PyTorch port (flagship: Llama-family decoder LM)."""

from ray_tpu_torch.models.transformer import (
    PRESETS,
    TransformerConfig,
    config,
    forward,
    init_params,
    loss_fn,
)

__all__ = [
    "PRESETS",
    "TransformerConfig",
    "config",
    "forward",
    "init_params",
    "loss_fn",
]
