"""ray_tpu_torch.train — the train step on one device or over a mesh of
the data and expert axes (PyTorch port of ray_tpu.train.step). Trainer,
checkpoint, FSDP/TP and pipelined steps come in later slices (ROADMAP.md
Queue A)."""

from ray_tpu_torch.train.step import (
    AdamW,
    batch_sharding,
    default_optimizer,
    init_state,
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
    "make_eval_step",
    "make_train_step",
    "state_shardings",
    "value_and_grad",
]
