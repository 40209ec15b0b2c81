"""ray_tpu_torch.train — the train step on one device or over a mesh of
any of its seven axes, the pipeline's ``stage`` among them (PyTorch port
of ray_tpu.train.step). Trainer and checkpoint come in later slices
(ROADMAP.md Queue A)."""

from ray_tpu_torch.train.step import (
    AdamW,
    batch_sharding,
    default_optimizer,
    init_state,
    make_attn_fn,
    make_eval_step,
    make_train_step,
    state_shardings,
    value_and_grad,
)

__all__ = [
    "AdamW",
    "batch_sharding",
    "default_optimizer",
    "init_state",
    "make_attn_fn",
    "make_eval_step",
    "make_train_step",
    "state_shardings",
    "value_and_grad",
]
