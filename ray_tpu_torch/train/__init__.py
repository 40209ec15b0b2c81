"""ray_tpu_torch.train — the single-device train step (PyTorch port of
ray_tpu.train.step). Trainer, checkpoint and sharded steps come in later
slices (ROADMAP.md Queue A)."""

from ray_tpu_torch.train.step import (
    AdamW,
    default_optimizer,
    init_state,
    make_eval_step,
    make_train_step,
    value_and_grad,
)

__all__ = [
    "AdamW",
    "default_optimizer",
    "init_state",
    "make_eval_step",
    "make_train_step",
    "value_and_grad",
]
